"""The port's ``nerf/sharded.py::render_views_sharded`` on Gloo ranks of the
CPU against the JAX package's on its 8-device CPU mesh
(``tests/test_sharded_decode.py``) and against the port's own one-process
``render_image_masked``, view by view: the same decoder variables (seeded
flax init, carried by ``compat/from_jax.py``), planes and synthetic views.

Tolerance: atol 2e-5 on rgb and acc (JAX's bar, test_sharded_decode.py:52),
for world-space views at 2 and 4 ranks (the tile count padded to a multiple
of each) and for canonical-space views whose tiles carry their own view's
SMPL arrays. A mixed-box call raises before any collective.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from torch_dist_util import run_ranks
from humanliff_tpu.bodymodel import lbs_forward
from humanliff_tpu.bodymodel.canonical import make_eval_deform_fn
from humanliff_tpu.bodymodel.smpl import make_synthetic_body_model
from humanliff_tpu.data.synthetic import SyntheticLayeredDataset
from humanliff_tpu.nerf.decoder import NeRFDecoder
from humanliff_tpu.nerf.renderer import RenderConfig
from humanliff_tpu.nerf.sharded import render_views_sharded
from humanliff_tpu.parallel import make_mesh
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf import sharded as port_sharded
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder as PortDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig as PortRenderConfig
from humanliff_tpu_torch.parallel.mesh import make_mesh as port_make_mesh

ATOL = 2e-5
RENDER = dict(n_samples=12, n_importance=12, perturb=False, density_noise=False)
SMPL_KEYS = ("poses", "betas", "t_poses", "R", "Th", "smpl_verts")


@pytest.fixture(scope="module")
def scene():
    decoder = NeRFDecoder(d_in=27)
    params = decoder.init(jax.random.key(0), jnp.zeros((1, 27)), jnp.zeros((1, 3)))
    planes = 0.1 * jax.random.normal(jax.random.key(1), (3, 9, 32, 32))
    sd = {k: v.numpy() for k, v in decoder_state_dict(jax.device_get(params)).items()}
    return decoder, params, planes, sd


def _views(n=3, size=24):
    ds = SyntheticLayeredDataset(num_instances=1, image_size=size, tight_bounds=True)
    return [ds.test_item(0, 1, 145 + v) for v in range(n)]


def _check(got_ranks, want_jax, want_port, outputs):
    for got in got_ranks:  # every rank holds every view
        assert len(got) == len(want_jax)
        for out, ref, one in zip(got, want_jax, want_port):
            for k in outputs:
                np.testing.assert_allclose(out[k], np.asarray(ref[k]), atol=ATOL, err_msg=k)
                np.testing.assert_allclose(out[k], one[k], atol=ATOL, err_msg=k)
            assert np.abs(out["rgb"]).sum() > 0


@pytest.mark.parametrize("world", [2, 4])
def test_world_space_views_match_jax_and_one_process(scene, world, tmp_path):
    decoder, params, planes, sd = scene
    views = _views()
    outputs = ("rgb", "acc")
    want = render_views_sharded(decoder, params, planes, views, RenderConfig(**RENDER),
                                make_mesh(8), chunk=64, outputs=outputs)
    kw = dict(decoder_sd=sd, planes=np.asarray(planes), views=views, render=RENDER, chunk=64,
              outputs=outputs)
    got = run_ranks("torch_dist_cases:render_views", world, tmp_path, distributed=True, **kw)
    import torch_dist_cases

    one = torch_dist_cases.render_views(distributed=False, **kw)
    _check(got, want, one, outputs)


def test_canonical_views_match_jax_and_one_process(scene, tmp_path):
    decoder, params, planes, sd = scene
    body = make_synthetic_body_model(J=4, V=48)
    views = _views(n=2)
    rng = np.random.default_rng(3)
    for item in views:  # a pose of its own for each view
        poses = rng.normal(scale=0.1, size=(12,)).astype(np.float32)
        betas = rng.normal(scale=0.3, size=(5,)).astype(np.float32)
        verts, _ = lbs_forward(body, jnp.asarray(poses)[None], jnp.asarray(betas)[None])
        item.update({"poses": poses, "betas": betas, "t_poses": np.zeros((12,), np.float32),
                     "R": np.eye(3, dtype=np.float32), "Th": np.zeros((3,), np.float32),
                     "smpl_verts": np.asarray(verts[0])})
    want = render_views_sharded(decoder, params, planes, views, RenderConfig(**RENDER),
                                make_mesh(8), chunk=64, deform_fn=make_eval_deform_fn(body),
                                deform_args_fn=lambda it: {k: it[k] for k in SMPL_KEYS},
                                outputs=("rgb",))
    kw = dict(decoder_sd=sd, planes=np.asarray(planes), views=views, render=RENDER, chunk=64,
              canonical_body=(4, 48))
    got = run_ranks("torch_dist_cases:render_views", 2, tmp_path, distributed=True, **kw)
    import torch_dist_cases

    one = torch_dist_cases.render_views(distributed=False, **kw)
    _check(got, want, one, ("rgb",))


def test_mixed_boxes_raise(scene):
    """As in JAX: one call renders one box. The check precedes every
    collective, so the one-rank mesh of this process shows it."""
    import torch

    views = _views(n=2)
    views[1]["box_warp"] = np.asarray([[-2, -2, -2], [2, 2, 2]], np.float32)
    with pytest.raises(ValueError, match="shared box_warp"):
        port_sharded.render_views_sharded(
            PortDecoder(), torch.zeros(3, 9, 8, 8), views,
            PortRenderConfig(n_samples=4, n_importance=0), port_make_mesh(device="cpu"),
            chunk=64)
