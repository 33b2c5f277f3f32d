"""Port parity of the variational bound in bits per dim
(``diffusion/gaussian.py::_prior_bpd`` and ``calc_bpd_loop``) against the JAX
package, on the CPU in fp32, over 8 respaced steps of the linear 1000-step
schedule, with a fixed (``learn_sigma`` false) and a learned-range
(``learn_sigma`` true) variance.

The model is a seeded linear map of (x_t, x_cond, t), the same in both
packages, so the loop is compared without the UNet. The port takes JAX's
noise: ``jax.random.normal`` of each of ``jax.random.split(key, T)``, the
draws of the JAX loop. Tolerance: rtol 1e-5, atol 1e-6.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu_torch.diffusion.respace import create_diffusion

TOL = dict(rtol=1e-5, atol=1e-6)
B, S, C, T = 3, 6, 3, 8
KEYS = ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse")


def _pair(learn_sigma):
    kw = dict(steps=1000, learn_sigma=learn_sigma, timestep_respacing=str(T))
    jd = jax_create_diffusion(**kw)
    object.__setattr__(jd, "channel_axis", -1)
    return jd, create_diffusion(**kw)


def _models(c_out, seed=3):
    w = (np.random.default_rng(seed).normal(size=(2 * C, c_out)) * 0.3).astype(np.float32)

    def jax_fn(x, ts, x_cond, y=None):
        return jnp.concatenate([x, x_cond], -1) @ w + (ts / 1000.0)[:, None, None, None]

    wt = torch.from_numpy(w)

    def torch_fn(x, ts, x_cond, y=None):
        return torch.cat([x, x_cond], -1) @ wt + (ts / 1000.0)[:, None, None, None]

    return jax_fn, torch_fn


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, S, S, C)).astype(np.float32)
    x[0, 0, 0] = -1.0  # the decoder NLL's edge buckets
    x[0, 0, 1] = 1.0
    return x, rng.uniform(-1, 1, (B, S, S, C)).astype(np.float32)


def test_prior_bpd_matches():
    jd, td = _pair(False)
    x, _ = _data()
    got = td._prior_bpd(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jd._prior_bpd(jnp.asarray(x))), **TOL)
    assert (got >= 0).all()


@pytest.mark.parametrize("learn_sigma", [False, True])
def test_calc_bpd_loop_matches_with_jax_noise(learn_sigma):
    jd, td = _pair(learn_sigma)
    assert td.num_timesteps == T
    x, xc = _data()
    jax_fn, torch_fn = _models(2 * C if learn_sigma else C)
    key = jax.random.key(11)
    want = jd.calc_bpd_loop(jax_fn, jnp.asarray(x), key, x_cond=jnp.asarray(xc))
    noise = [torch.tensor(np.asarray(jax.random.normal(k, x.shape, jnp.float32)))
             for k in jax.random.split(key, T)]
    got = td.calc_bpd_loop(torch_fn, torch.from_numpy(x), x_cond=torch.from_numpy(xc),
                           step_noise=noise)
    assert set(got) == set(KEYS)
    for k in KEYS:
        assert got[k].shape == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), err_msg=k, **TOL)
    np.testing.assert_allclose(got["total_bpd"].numpy(),
                               (got["vb"].sum(1) + got["prior_bpd"]).numpy(), rtol=1e-6)


def test_calc_bpd_loop_draws_noise_from_the_generator():
    _, td = _pair(False)
    x, xc = _data()
    _, torch_fn = _models(C)

    def run(seed):
        return td.calc_bpd_loop(torch_fn, torch.from_numpy(x), torch.Generator().manual_seed(seed),
                                x_cond=torch.from_numpy(xc))["total_bpd"]

    assert torch.equal(run(5), run(5)) and not torch.equal(run(5), run(6))
