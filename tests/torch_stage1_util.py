"""Shared set-up of the Stage-1 parity tests (``test_torch_stage1*.py``,
``test_torch_recon_cli.py``, ``test_torch_export_jax_weights.py``).

Both packages get the same numpy inputs: a small plane table (2 instances, 2
layers, D 16, 27 channels) with a soft central blob so rays meet density,
the JAX decoder's seeded variables carried to the port's flat buffer, and
item batches of the synthetic dataset (which the two packages build bit for
bit). Both run the deterministic path: no jitter, no density noise, and
linspace fine samples. The JAX ``stage1_loss`` always hands its renderer a
key, which draws the fine samples at random; :func:`jax_deterministic`
swaps in a renderer that drops the key, for the test that uses it, and jits
JAX's step afresh so that no compilation of the keyed renderer is reused.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import torch

from humanliff_tpu.data.synthetic import SyntheticLayeredDataset as JaxSynthetic
from humanliff_tpu.nerf import renderer as jrender
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.train import stage1 as jstage1
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
from humanliff_tpu_torch.nerf.renderer import RenderConfig
from humanliff_tpu_torch.train.stage1 import Stage1Config

N_INST, N_LAYERS, D, CH = 2, 2, 16, 27
N_RAYS, IMAGE = 48, 24
RENDER = dict(n_samples=8, n_importance=8, perturb=False, density_noise=False)


def configs(**over):
    """(JAX Stage1Config, port Stage1Config) of the small width."""
    kw = dict(num_instances=N_INST, num_layers=N_LAYERS, triplane_dim=D, triplane_ch=CH,
              tv_loss_coef=1e-3, l1_loss_coef=1e-3)
    kw.update(over)
    return (jstage1.Stage1Config(render=jrender.RenderConfig(**RENDER), **kw),
            Stage1Config(render=RenderConfig(**RENDER), **kw))


def plane_table(seed=0, n=N_INST, layers=N_LAYERS):
    """(n, layers, 3, 9, D, D): noise plus a blob that gives density in the
    box's middle."""
    rng = np.random.default_rng(seed)
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    blob = np.exp(-3.0 * (u ** 2 + v ** 2))
    planes = 0.3 * rng.normal(size=(n, layers, 3, CH // 3, D, D)) + 0.8 * blob
    return planes.astype(np.float32)


def decoder_vars(seed=0):
    """The JAX decoder's initial variables (numpy) and the port's flat buffer."""
    dec = JaxDecoder()
    params = jax.device_get(dec.init(jax.random.key(seed), jnp.zeros((1, CH)),
                                     jnp.zeros((1, 3))))
    return dec, params, flatten_state_dict(decoder_state_dict(params))


def dataset(num_layers=N_LAYERS, n_rays=N_RAYS, image_size=IMAGE, num_instances=N_INST):
    return JaxSynthetic(num_instances=num_instances, num_layers=num_layers, n_rays=n_rays,
                        image_size=image_size, tight_bounds=True)


def item_batch(ds, pairs, seed=0):
    """A stacked numpy batch of one item per (instance, layer) in ``pairs``."""
    per_inst = ds.num_layers * 64
    items = []
    for j, (inst, layer) in enumerate(pairs):
        idx = inst * per_inst + layer * 64 + (7 * j + seed) % 64
        items.append(ds.item(idx, np.random.default_rng(1000 * seed + j)))
    return {k: np.stack([it[k] for it in items]) for k in items[0]}


def to_torch(batch):
    return {k: torch.from_numpy(np.asarray(v)).long() if k in ("instance_idx", "layer_idx")
            else torch.from_numpy(np.ascontiguousarray(v)) for k, v in batch.items()}


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@contextlib.contextmanager
def jax_deterministic(monkeypatch):
    """JAX's ``stage1_loss`` renders without a key while the context is open
    (the port's ``generator=None``), and ``loss_and_grad`` / ``step`` are
    fresh jits of its loss and train step."""
    keyed = jrender.render_rays_batch

    def without_key(*args, key=None, **kwargs):
        return keyed(*args, key=None, **kwargs)

    monkeypatch.setattr(jstage1, "render_rays_batch", without_key)
    grad = jax.jit(jax.value_and_grad(jstage1.stage1_loss, has_aux=True),
                   static_argnames=("decoder", "cfg", "body_model"))
    step = jax.jit(jstage1.train_step.__wrapped__,
                   static_argnames=("decoder", "cfg", "body_model"))
    try:
        yield dataclasses.make_dataclass("JaxFns", ["loss_and_grad", "step"])(grad, step)
    finally:
        monkeypatch.setattr(jstage1, "render_rays_batch", keyed)


def decoder_flat(tree) -> np.ndarray:
    """A JAX decoder variable tree (or one shaped like it) as the port's flat buffer."""
    return flatten_state_dict(decoder_state_dict(jax.device_get(tree))).numpy()


# Adam's step lr x g / (|g| + eps) is lr x sign(g) to 1 % only where |g| >=
# 100 eps; below, its size reads the gradient's value, whose last bits are
# rounding where the loss's terms cancel.
NEAR_ZERO_GRAD = 1e-6
# How far apart an element whose gradient is near zero may step, per step in
# units of lr (the Stage-2 tests' bar).
NEAR_ZERO_STEP = 1e-2


def near_zero_rule(got: np.ndarray, want: np.ndarray, lr: float, steps: int, label: str,
                   near_zero: np.ndarray, atol: float = 1e-6) -> dict:
    """Parameters after Adam steps agree within ``atol``, and within
    NEAR_ZERO_STEP x lr x steps where ``near_zero`` (a gradient under
    NEAR_ZERO_GRAD at some step). At most 1e-4 of all the elements may break
    these bars, where a gradient near 0 takes the other sign: they sit up to
    2 x lr x steps apart (the rule of the Stage-2 tests)."""
    d = np.abs(np.asarray(got, np.float64) - np.asarray(want, np.float64))
    assert d.max() <= 2 * lr * steps + atol, (label, float(d.max()))
    bar = np.where(near_zero, NEAR_ZERO_STEP * lr * steps + atol, atol)
    off = d > bar
    assert off.sum() <= 1e-4 * d.size, (label, int(off.sum()), d.size)
    return {"max": float(d.max()), "near_zero": int(near_zero.sum()),
            "max_near_zero": float(d[near_zero].max(initial=0.0)),
            "max_other": float(d[~near_zero].max(initial=0.0)), "flipped": int(off.sum()),
            "of": d.size}
