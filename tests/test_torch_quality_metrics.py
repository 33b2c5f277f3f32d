"""Port parity of the quality campaigns' metrics and planner against the JAX
package, on the CPU in fp32: ``eval/fidelity.py::decoded_fidelity`` and
``heldout_denoise_loss``, ``sampling/layered.py::plan_workload`` and
``generate_workload``.

Bars: ``decoded_fidelity`` within 1e-6 (numpy on both sides); the held-out
loss per layer within rtol 1e-4 (a tiny ControlNet UNet, weights carried by
``compat/from_jax.py``, the same noise per (item, timestep) handed to the
port as JAX draws it; tests/test_torch_unet.py's forward bar is 2e-5 of the
output); plans equal.
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu.eval import fidelity as jfid
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.sampling import layered as jlayered
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.diffusion.respace import create_diffusion
from humanliff_tpu_torch.eval.fidelity import decoded_fidelity, heldout_denoise_loss
from humanliff_tpu_torch.models.factory import channel_mult_for, create_model
from humanliff_tpu_torch.sampling.layered import (
    DEFAULT_CHAIN_COSTS,
    LAYER_NAMES,
    generate_all_layers,
    generate_workload,
    plan_workload,
)

CFG = dict(image_size=16, in_channels=27, num_channels=32, out_channels=27,
           num_res_blocks=1, learn_sigma=False, class_cond=True,
           attention_resolutions="8", num_heads=2, num_heads_upsample=-1,
           use_scale_shift_norm=True, cond_type="controlnet", dropout=0.0)
LAYOUT = dict(num_res_blocks=1, channel_mult=channel_mult_for(16), attention_ds=(2,))


def _maps(seed, n=4096):
    rng = np.random.default_rng(seed)
    rgb0 = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    rgb1 = np.where(rng.uniform(size=(n, 1)) < 0.3,
                    rng.uniform(0, 1, (n, 3)), rgb0 + rng.normal(0, 0.01, (n, 3)))
    acc0 = rng.uniform(0, 1, n).astype(np.float32)
    acc1 = np.clip(acc0 + rng.normal(0, 0.2, n), 0, 1).astype(np.float32)
    return rgb1.astype(np.float32), acc1, rgb0, acc0


@pytest.mark.parametrize("case", ["random", "random_thresholds", "erasure", "identical"])
def test_decoded_fidelity_matches_jax(case):
    kw = {}
    if case == "erasure":  # tests/test_fidelity.py: layer 1 erased the body
        rng = np.random.default_rng(2)
        rgb0 = rng.uniform(0, 1, (256, 3)).astype(np.float32)
        acc0 = np.ones((256,), np.float32)
        args = (rgb0.copy(), np.zeros((256,), np.float32), rgb0, acc0)
    elif case == "identical":
        rgb1, acc1, _, _ = _maps(1)
        args = (rgb1, acc1, rgb1.copy(), acc1.copy())
    else:
        args = _maps(0)
        if case == "random_thresholds":
            kw = dict(threshold=0.2, occ=0.3)
    ours = decoded_fidelity(*args, **kw)
    theirs = jfid.decoded_fidelity(*args, **kw)
    assert ours.keys() == theirs.keys()
    for k in ours:
        np.testing.assert_allclose(ours[k], theirs[k], atol=1e-6, err_msg=k)
    if case == "erasure":
        assert ours["occupancy_persistence"] == 0.0


@pytest.fixture(scope="module")
def tiny_unet():
    jmodel = jax_create_model(use_3d_aware=False, **CFG)
    x = jnp.zeros((1, 16, 16, 27))
    params = jax.jit(jmodel.init)(jax.random.key(0), x, jnp.zeros((1,)), x,
                                  jnp.zeros((1,), jnp.int32))
    params = randomize_tree(params, 0, scale=0.5)
    port = create_model(**CFG).eval()
    port.load_state_dict(unet_state_dict(params, **LAYOUT), strict=True)
    return jmodel, params, port


def _items(seed=4, n=6):
    rng = np.random.default_rng(seed)
    return [{"x": rng.normal(0, 0.3, (16, 16, 27)).astype(np.float32),
             "x_cond": (rng.normal(0, 0.3, (16, 16, 27)).astype(np.float32) if k % 4
                        else np.zeros((16, 16, 27), np.float32)),
             "y": np.int32(k % 4)} for k in range(n)]


def test_heldout_denoise_loss_matches_jax(tiny_unet):
    """The same stratified t-grid and, per (item, timestep), the noise JAX
    draws from its key: per-layer means within rtol 1e-4."""
    jmodel, params, port = tiny_unet
    items = _items()
    n_t = 4
    jd = jax_create_diffusion(steps=20)
    object.__setattr__(jd, "channel_axis", -1)
    key = jax.random.key(5)
    theirs = jfid.heldout_denoise_loss(jmodel, params, jd, items, key, n_timesteps=n_t)
    noise = [[np.asarray(jax.random.normal(k, (1, 16, 16, 27), jnp.float32))
              for k in jax.random.split(jax.random.fold_in(key, i), n_t)]
             for i in range(len(items))]
    ours = heldout_denoise_loss(port, create_diffusion(steps=20), items, n_timesteps=n_t,
                                noise=noise)
    assert sorted(ours) == sorted(theirs) == [0, 1, 2, 3]
    for layer in ours:
        np.testing.assert_allclose(ours[layer], theirs[layer], rtol=1e-4, err_msg=str(layer))
    assert len({round(v, 6) for v in ours.values()}) == 4


def test_heldout_denoise_loss_generator_is_deterministic(tiny_unet):
    _, _, port = tiny_unet
    d = create_diffusion(steps=20)
    items = _items(seed=7, n=3)

    def run(seed):
        return heldout_denoise_loss(port, d, items, torch.Generator().manual_seed(seed),
                                    n_timesteps=3)

    a, b, c = run(0), run(0), run(1)
    assert a == b and a != c and sorted(a) == [0, 1, 2]
    assert all(np.isfinite(v) for v in a.values())


COST_TABLES = [jlayered.DEFAULT_CHAIN_COSTS, {1: 1.0, 8: 6.5}, DEFAULT_CHAIN_COSTS,
               {1: 1.0, 2: 0.9}, {1: 1.0, 8: 1.5}]


@pytest.mark.parametrize("table", range(len(COST_TABLES)))
def test_plan_workload_matches_jax(table):
    costs = COST_TABLES[table]
    for n in range(0, 65):
        ours = plan_workload(n, costs)
        assert ours == jlayered.plan_workload(n, costs), (n, costs)
        assert sum(ours) >= n


def test_port_chain_costs_are_the_cards():
    """The default table is the H100's (seconds of a 4 x 250 chain at B 1 and
    B 8), not the JAX package's TPU table, and it plans the 25-sample
    workload in chains of 8 with a B 1 remainder."""
    assert set(DEFAULT_CHAIN_COSTS) == {1, 8}
    assert DEFAULT_CHAIN_COSTS != jlayered.DEFAULT_CHAIN_COSTS
    assert plan_workload(25) == [8, 8, 8, 1]
    assert plan_workload(0) == [] and plan_workload(8) == [8]


class _Toy(torch.nn.Module):
    """Deterministic epsilon predictor, NCHW in and out."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))

    def forward(self, x, ts, xc, y=None):
        return 0.1 * x + 0.01 * self.w + 0.0 * xc


def test_generate_workload_runs_the_plan_chain_major():
    """A [2, 2] plan for 3 samples: the padded lane of the second group is
    dropped, and each group is one whole chain drawn in turn from the
    generator."""
    model, d = _Toy(), create_diffusion(steps=8)
    costs = {1: 1.0, 2: 0.9}
    out = generate_workload(model, d, torch.Generator().manual_seed(0), 3, image_size=8,
                            channels=6, chain_costs=costs, device="cpu")
    assert list(out) == LAYER_NAMES
    gen = torch.Generator().manual_seed(0)
    groups = [generate_all_layers(model, d, gen, batch_size=2, image_size=8, channels=6,
                                  device="cpu") for _ in range(2)]
    for name, arr in out.items():
        assert arr.shape == (3, 8, 8, 6) and torch.isfinite(arr).all()
        torch.testing.assert_close(arr, torch.cat([groups[0][name], groups[1][name][:1]]),
                                   rtol=0, atol=0)
