"""The port's sampling artifacts and inputs against the JAX package, on the
CPU: PNG and video writers, ``cameras_json`` views, chain fidelity, the
samples / decoder npz contract and the UNet npz loader. Exact unless stated.
"""

import importlib.util
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from humanliff_tpu.data.view_datasets import NovelViewCameras as JaxCameras
from humanliff_tpu.eval import fidelity as jfidelity
from humanliff_tpu.train import checkpoint as jckpt
from humanliff_tpu.utils.video import read_mjpeg_avi
from humanliff_tpu_torch.compat.from_jax import load_unet_npz, unet_state_dict
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.eval import fidelity
from humanliff_tpu_torch.models.factory import create_model
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.utils import video

BOUNDS = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)


def _frames(n=3, h=20, w=28):
    yy, xx = np.mgrid[0:h, 0:w]
    return [np.stack([xx * 255 // w, yy * 255 // h, np.full_like(xx, 40 * i)], -1).astype(np.uint8)
            for i in range(n)]


@pytest.mark.parametrize("channels", [None, 1, 3, 4])
def test_png_reads_back(tmp_path, channels):
    imageio = pytest.importorskip("imageio.v2")
    rng = np.random.default_rng(channels or 0)
    shape = (13, 17) if channels is None else (13, 17, channels)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "a.png")
    video.write_png(path, img)
    back = imageio.imread(path)
    np.testing.assert_array_equal(back.reshape(img.shape), img)


def test_png_rejects_other_dtypes(tmp_path):
    with pytest.raises(TypeError):
        video.write_png(str(tmp_path / "a.png"), np.zeros((4, 4, 3), np.float32))


def test_video_falls_back_in_order(tmp_path, monkeypatch, capsys):
    frames = _frames()
    out = video.write_video(str(tmp_path / "clip.mp4"), frames, fps=10)
    assert out is not None and os.path.exists(out)
    assert f"wrote {out}" in capsys.readouterr().out
    if out.endswith(".avi"):  # no mp4 plugin here: the MJPEG AVI, as the JAX writer
        back = read_mjpeg_avi(out)
        assert len(back) == 3 and np.mean(np.abs(back[0].astype(int) - frames[0])) < 8

    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None)
    assert video.write_video(str(tmp_path / "none.mp4"), frames) is None
    assert "no video written" in capsys.readouterr().out
    assert not any(p.startswith("none") for p in os.listdir(tmp_path))


def test_video_writer_failure_removes_its_partial_file(tmp_path, monkeypatch):
    pytest.importorskip("PIL")
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name in ("imageio_ffmpeg", "av") else True)

    def broken(path, frames, fps):
        with open(path, "wb") as f:
            f.write(b"RIFF")
        raise OSError("disk full")

    monkeypatch.setattr(video, "write_mjpeg_avi", broken)
    with pytest.raises(OSError, match="disk full"):
        video.write_video(str(tmp_path / "clip.mp4"), _frames())
    assert os.listdir(tmp_path) == []


def _write_cameras(path, views, size):
    cams = {}
    for v in views:
        theta = 2 * np.pi * v / 40
        eye = 2.5 * np.asarray([np.cos(theta), 0.1, np.sin(theta)])
        fwd = -eye / np.linalg.norm(eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        R = np.stack([right, -np.cross(right, fwd), fwd], 0)
        cams[f"camera{v:04d}"] = {"K": [[size * 1.5, 0, size / 2], [0, size * 1.5, size / 2],
                                        [0, 0, 1]],
                                  "R": R.tolist(), "T": (-R @ eye).reshape(3, 1).tolist()}
    with open(path, "w") as f:
        json.dump(cams, f)


@pytest.mark.parametrize("source", ["orbit", "cameras_json"])
def test_novel_view_rays_match_jax(tmp_path, source):
    path = None
    if source == "cameras_json":
        path = str(tmp_path / "cameras.json")
        _write_cameras(path, range(145, 185), 64)
    ours = NovelViewCameras(image_size=32, cameras_json=path, image_scaling=0.5)
    theirs = JaxCameras(image_size=32, cameras_json=path, image_scaling=0.5)
    assert len(ours) == len(theirs) == 40
    for i in (0, 7, 39):
        for a, b in zip(ours.camera(i), theirs.camera(i)):
            np.testing.assert_array_equal(a, b)
        ro, rr = ours.rays(i, BOUNDS), theirs.rays(i, BOUNDS)
        assert sorted(ro) == sorted(rr)
        for k in rr:
            np.testing.assert_allclose(ro[k], rr[k], rtol=1e-6, atol=1e-6, err_msg=k)
        assert ro["ray_mask"].dtype == np.float32 and ro["ray_mask"].any()


def test_missing_cameras_json_raises(tmp_path):
    """The JAX class silently falls back to the orbit here."""
    with pytest.raises(FileNotFoundError):
        NovelViewCameras(cameras_json=str(tmp_path / "missing.json"))


def test_fidelity_matches_jax():
    rng = np.random.default_rng(0)
    base = rng.uniform(-1, 1, (2, 8, 8, 27)).astype(np.float32)
    layers = {"a": base, "b": base.copy(), "c": base.copy()}
    layers["b"][:, :3] += 0.5  # a change region
    layers["c"] = rng.uniform(-1, 1, base.shape).astype(np.float32)  # all changed
    ours = fidelity.chain_fidelity_report(layers, 0.1)
    theirs = jfidelity.chain_fidelity_report(layers, 0.1)
    assert list(ours) == list(theirs) == ["a->b", "b->c"]
    for pair in theirs:
        np.testing.assert_allclose([ours[pair][k] for k in theirs[pair]],
                                   list(theirs[pair].values()), rtol=1e-7)
    assert ours["b->c"]["change_fraction"] == 1.0
    same = fidelity.plane_fidelity(base[0], base[0])
    assert same == jfidelity.plane_fidelity(base[0], base[0])


def test_samples_and_decoder_npz_contract(tmp_path):
    arr = np.random.default_rng(0).normal(size=(2, 4, 4, 27)).astype(np.float32)
    ckpt.save_samples_npz(str(tmp_path / "a.npz"), arr)
    jckpt.save_samples_npz(str(tmp_path / "b.npz"), arr)
    for p in ("a.npz", "b.npz"):
        np.testing.assert_array_equal(ckpt.load_samples_npz(str(tmp_path / p)), arr)
        np.testing.assert_array_equal(jckpt.load_samples_npz(str(tmp_path / p)), arr)
    params = {"params": {"trunk_0": {"kernel": arr[0, 0], "bias": arr[0, 1, 0]}}}
    jckpt.save_decoder_npz(str(tmp_path / "d.npz"), params, step=7)
    ours, theirs = ckpt.load_decoder_npz(str(tmp_path / "d.npz")), jckpt.load_decoder_npz(
        str(tmp_path / "d.npz"))
    assert jax.tree.structure(ours) == jax.tree.structure(theirs)
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(theirs)):
        np.testing.assert_array_equal(a, b)


def test_load_unet_npz_reads_both_layouts(tmp_path):
    from torch_port_util import randomize_tree
    from humanliff_tpu.models.factory import create_model as jax_create_model

    cfg = dict(image_size=16, in_channels=9, num_channels=16, out_channels=9,
               num_res_blocks=1, learn_sigma=False, class_cond=True,
               attention_resolutions="8", num_heads=2, num_heads_upsample=-1,
               use_scale_shift_norm=True, cond_type="controlnet", dropout=0.0)
    jmodel = jax_create_model(use_3d_aware=False, **cfg)
    x0 = jnp.zeros((1, 16, 16, 9))
    params = randomize_tree(jmodel.init(jax.random.key(0), x0, jnp.zeros((1,)), x0,
                                        jnp.zeros((1,), jnp.int32)), 3)
    flat = {"/".join(str(k.key) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    np.savez(str(tmp_path / "flax.npz"), __global_step__=3, **flat)
    shape = dict(num_res_blocks=1, channel_mult=(1, 2), attention_ds=(2,))
    from_flax = load_unet_npz(str(tmp_path / "flax.npz"), **shape)
    want = unet_state_dict(params, **shape)
    port = create_model(**cfg)
    port.load_state_dict(from_flax, strict=True)
    np.savez(str(tmp_path / "port.npz"),
             **{k: v.detach().numpy() for k, v in port.state_dict().items()})
    from_port = load_unet_npz(str(tmp_path / "port.npz"))
    assert sorted(from_flax) == sorted(from_port) == sorted(want)
    for k in want:
        torch.testing.assert_close(from_flax[k], want[k], rtol=0, atol=0)
        torch.testing.assert_close(from_port[k], want[k], rtol=0, atol=0)
    np.savez(str(tmp_path / "mixed.npz"), **{"a/b": np.zeros(2), "c.d": np.zeros(2)})
    with pytest.raises(ValueError, match="mixes"):
        load_unet_npz(str(tmp_path / "mixed.npz"))
