"""Port parity of the diffusion's training half (``diffusion/losses.py``, the
forward process and ``training_losses`` of ``diffusion/gaussian.py``, the loss
type of ``create_diffusion``) against the JAX package, on the CPU in fp32.

The model is a seeded linear map of (x_t, x_cond, t) in both packages, so the
losses and their gradients with respect to its weight are compared without
the UNet. The same numpy noise goes to both. Tolerance: rtol 1e-5, atol 1e-6
(fp32 elementwise arithmetic and means in another order).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu.diffusion import gaussian as jg
from humanliff_tpu.diffusion import losses as jl
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu.diffusion.respace import space_timesteps, spaced_diffusion as jax_spaced
from humanliff_tpu.diffusion.schedules import get_named_beta_schedule
from humanliff_tpu_torch.diffusion import gaussian as tg
from humanliff_tpu_torch.diffusion import losses as tl
from humanliff_tpu_torch.diffusion.respace import create_diffusion, spaced_diffusion

TOL = dict(rtol=1e-5, atol=1e-6)
B, S, C = 4, 6, 3
T_ORIG, RESPACE = 1000, "100"


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1, 1, (B, S, S, C)).astype(np.float32)
    x[0, 0, 0] = -1.0  # the decoder NLL's edge buckets
    x[0, 0, 1] = 1.0
    return {"x": x, "xc": rng.uniform(-1, 1, (B, S, S, C)).astype(np.float32),
            "noise": rng.standard_normal((B, S, S, C)).astype(np.float32),
            "t": np.asarray([0, 1, 57, 99], np.int64)}


def _pair(mean, var, loss):
    betas = get_named_beta_schedule("linear", T_ORIG)
    kw = dict(betas=betas, use_timesteps=space_timesteps(T_ORIG, RESPACE))
    jd = jax_spaced(model_mean_type=getattr(jg.ModelMeanType, mean),
                    model_var_type=getattr(jg.ModelVarType, var),
                    loss_type=getattr(jg.LossType, loss), **kw)
    object.__setattr__(jd, "channel_axis", -1)
    td = spaced_diffusion(model_mean_type=getattr(tg.ModelMeanType, mean),
                          model_var_type=getattr(tg.ModelVarType, var),
                          loss_type=getattr(tg.LossType, loss), **kw)
    return jd, td


def test_likelihood_helpers_match():
    rng = np.random.default_rng(1)
    a, b, c, d = (rng.normal(size=(3, 5, 7)).astype(np.float32) for _ in range(4))
    np.testing.assert_allclose(
        _np(tl.normal_kl(*map(torch.from_numpy, (a, b, c, d)))),
        np.asarray(jl.normal_kl(a, b, c, d)), **TOL)
    x = rng.uniform(-4, 4, 200).astype(np.float32)
    np.testing.assert_allclose(_np(tl.approx_standard_normal_cdf(torch.from_numpy(x))),
                               np.asarray(jl.approx_standard_normal_cdf(x)), **TOL)
    # Means near the pixels: far in a tail, cdf_plus - cdf_min cancels and
    # the two packages' tanh, a few ulps apart, differ in its log by up to 2.4 %.
    img = np.clip(rng.uniform(-1.1, 1.1, (2, 4, 4, 3)), -1, 1).astype(np.float32)
    means = (img + 0.05 * rng.standard_normal(img.shape)).astype(np.float32)
    log_scales = rng.uniform(-3, -1, img.shape).astype(np.float32)
    np.testing.assert_allclose(
        _np(tl.discretized_gaussian_log_likelihood(
            torch.from_numpy(img), means=torch.from_numpy(means),
            log_scales=torch.from_numpy(log_scales))),
        np.asarray(jl.discretized_gaussian_log_likelihood(img, means=means,
                                                          log_scales=log_scales)), **TOL)
    np.testing.assert_allclose(_np(tl.mean_flat(torch.from_numpy(a))),
                               np.asarray(jl.mean_flat(a)), **TOL)


def test_forward_process_and_predictors_match():
    jd, td = _pair("EPSILON", "FIXED_LARGE", "MSE")
    d = _inputs()
    x, noise, tt = (torch.from_numpy(d[k]) for k in ("x", "noise", "t"))
    t = jnp.asarray(d["t"])
    for ours, theirs in zip(td.q_mean_variance(x, tt), jd.q_mean_variance(d["x"], t)):
        np.testing.assert_allclose(_np(ours), np.asarray(theirs), **TOL)
    np.testing.assert_allclose(_np(td.q_sample(x, tt, noise)),
                               np.asarray(jd.q_sample(d["x"], t, d["noise"])), **TOL)
    # c1 * xprev - c2 * x_t cancels, and XLA contracts it into a fused
    # multiply-add: measured 1.8e-6 of the largest value (about 200).
    want = np.asarray(jd._predict_xstart_from_xprev(d["x"], t, d["noise"]))
    np.testing.assert_allclose(_np(td._predict_xstart_from_xprev(x, tt, noise)), want,
                               rtol=1e-5, atol=1e-5 * np.abs(want).max())
    x_t = d["noise"][1:]  # t > 0: at t = 0 the predictor divides by 0
    np.testing.assert_allclose(
        _np(td._predict_eps_from_xstart(torch.from_numpy(x_t), tt[1:], x[1:])),
        np.asarray(jd._predict_eps_from_xstart(x_t, t[1:], d["x"][1:])), **TOL)


@pytest.mark.parametrize("use_kl,rescale,want", [(True, True, "RESCALED_KL"),
                                                 (False, True, "RESCALED_MSE"),
                                                 (False, False, "MSE")])
def test_create_diffusion_loss_type(use_kl, rescale, want):
    kw = dict(steps=50, use_kl=use_kl, rescale_learned_sigmas=rescale)
    assert create_diffusion(**kw).loss_type.name == want
    assert jax_create_diffusion(**kw).loss_type.name == want


def _linear_model(w_out):
    """out = [x_t | x_cond] @ W + t_scaled / 1000, in both packages."""
    def jax_fn(w):
        def fn(x, ts, x_cond, y=None):
            h = jnp.concatenate([x, x_cond], -1) @ w
            return h + (ts / 1000.0)[:, None, None, None] + 0.1 * y[:, None, None, None]
        return fn

    def torch_fn(w):
        def fn(x, ts, x_cond, y=None):
            h = torch.cat([x, x_cond], -1) @ w
            return h + (ts / 1000.0)[:, None, None, None] + 0.1 * y[:, None, None, None]
        return fn

    return jax_fn, torch_fn


@pytest.mark.parametrize("loss", ["MSE", "RESCALED_MSE", "KL", "RESCALED_KL"])
@pytest.mark.parametrize("var", ["FIXED_LARGE", "LEARNED", "LEARNED_RANGE"])
@pytest.mark.parametrize("mean", ["EPSILON", "START_X", "PREVIOUS_X"])
def test_training_losses_and_gradients_match(mean, var, loss):
    jd, td = _pair(mean, var, loss)
    d = _inputs(2)
    c_out = 2 * C if var.startswith("LEARNED") else C
    w = (np.random.default_rng(3).normal(size=(2 * C, c_out)) * 0.3).astype(np.float32)
    y = np.asarray([0, 1, 2, 3], np.int32)
    jax_fn, torch_fn = _linear_model(c_out)

    def jax_terms(w):
        return jd.training_losses(jax_fn(w), d["x"], d["xc"], jnp.asarray(d["t"]),
                                  jax.random.key(0), {"y": jnp.asarray(y)},
                                  noise=jnp.asarray(d["noise"]))

    want = jax_terms(jnp.asarray(w))
    want_grad = jax.grad(lambda w: jax_terms(w)["loss"].sum())(jnp.asarray(w))

    wt = torch.from_numpy(w).requires_grad_(True)
    got = td.training_losses(torch_fn(wt), *(torch.from_numpy(d[k]) for k in ("x", "xc", "t")),
                             model_kwargs={"y": torch.from_numpy(y)},
                             noise=torch.from_numpy(d["noise"]))
    got["loss"].sum().backward()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_np(got[k]), np.asarray(want[k]), err_msg=k, **TOL)
    # Gradients to 2e-5 of the largest. Where the decoder NLL at t = 0 sits
    # far in a Gaussian tail (a START_X or PREVIOUS_X model under a fixed
    # variance) the port's fp32 gradient is 1.5e-3 of the largest from its own
    # fp64 one, JAX's 9e-5: torch differentiates tanh as 1 - tanh^2, JAX as
    # (1 - tanh)(1 + tanh), which keeps more bits near +-1. Measured gap
    # 1.6e-3 (START_X) and 1.3e-3 (PREVIOUS_X).
    tail = mean != "EPSILON" and var == "FIXED_LARGE" and loss.endswith("KL")
    want_grad = np.asarray(want_grad)
    np.testing.assert_allclose(wt.grad.numpy(), want_grad, rtol=0,
                               atol=(3e-3 if tail else 2e-5) * np.abs(want_grad).max())
    if var.startswith("LEARNED") and not loss.endswith("KL"):
        # The vb term trains the variance half only: its gradient leaves the
        # mean half's weights alone.
        wt.grad = None
        got = td.training_losses(torch_fn(wt), *(torch.from_numpy(d[k]) for k in ("x", "xc", "t")),
                                 model_kwargs={"y": torch.from_numpy(y)},
                                 noise=torch.from_numpy(d["noise"]))
        got["vb"].sum().backward()
        assert float(wt.grad[:, :C].abs().max()) == 0.0
        assert float(wt.grad[:, C:].abs().max()) > 0.0


def test_training_losses_draws_noise_from_the_generator():
    _, td = _pair("EPSILON", "FIXED_LARGE", "MSE")
    d = _inputs()
    x, xc, t = (torch.from_numpy(d[k]) for k in ("x", "xc", "t"))

    def fn(x_t, ts, x_cond):
        return x_t

    a = td.training_losses(fn, x, xc, t, generator=torch.Generator().manual_seed(5))["loss"]
    b = td.training_losses(fn, x, xc, t, generator=torch.Generator().manual_seed(5))["loss"]
    c = td.training_losses(fn, x, xc, t, generator=torch.Generator().manual_seed(6))["loss"]
    assert torch.equal(a, b) and not torch.equal(a, c)
