"""The port's sampling CLI (``humanliff_tpu_torch.cli.diff_sample``) end to end
on the CPU at a tiny size (16^2 planes of 27 channels, the decoder's width; a
32-channel UNet with seeded random weights; 2 respaced steps), against the JAX
package.

- ``--all_layers --report_fidelity``: four ``samples_*.npz`` in [-1, 1];
  ``fidelity.json`` equals the JAX ``chain_fidelity_report`` of those samples
  (rtol 1e-6).
- ``--sample_npz`` chain with ``--use_ddim``, ``--dump_trajectory`` and
  ``--report_fidelity``: the trajectory file, and ``fidelity_{layer}.json``
  equal to the JAX ``plane_fidelity`` mean (rtol 1e-6); too few previous
  samples raise.
- ``--parallel_window`` / ``--parallel_tol`` (Picard): single layer and
  ``--all_layers`` samples, a window with DDIM raises, a window means no
  ``--auto_plan`` plan; ``image_sample`` and ``image_nll`` (which share the
  parser) refuse a window.
- ``--decode``, fast and exact tier: the CLI's own samples, decoded by the JAX
  package's ``render_image_fast`` / ``render_image_masked`` and
  ``extract_mesh`` (bf16 planes, fp32 decoder weights), give the CLI's PNGs
  within one level of 255 and its PLY's triangles, with vertices within 1e-5.
  The decoder is the fitted one with its alpha bias raised, so that these
  random samples have a surface; no ray's grid-estimated accumulated alpha
  lies within 1e-4 of ``--early_term_eps``, which the test asserts.
"""

import glob
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from torch_port_util import randomize_tree
from humanliff_tpu.eval.fidelity import chain_fidelity_report as jax_chain_report
from humanliff_tpu.eval.fidelity import plane_fidelity as jax_plane_fidelity
from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.nerf import fastpath as jfp
from humanliff_tpu.nerf import geometry as jgeometry
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.nerf.renderer import RenderConfig as JaxConfig
from humanliff_tpu.nerf.renderer import render_image_masked as jax_render_masked
from humanliff_tpu.sampling.layered import planes_image_to_triplane
from humanliff_tpu.train.checkpoint import load_decoder_npz as jax_load_decoder_npz
from humanliff_tpu_torch.cli import diff_sample
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.data.view_datasets import NovelViewCameras
from humanliff_tpu_torch.mesh.io import read_ply
from humanliff_tpu_torch.nerf import fastpath
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig
from humanliff_tpu_torch.sampling.layered import planes_image_to_triplane as port_planes_to_triplane
from humanliff_tpu_torch.train.checkpoint import load_decoder_npz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER_NPZ = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
UNET = dict(image_size=16, in_channels=27, num_channels=32, out_channels=27,
            num_res_blocks=1, learn_sigma=False, class_cond=True,
            attention_resolutions="8", num_heads=2, num_heads_upsample=-1,
            use_scale_shift_norm=True, cond_type="controlnet", dropout=0.0)
FLAGS = ["--device", "cpu", "--image_size", "16", "--num_channels", "32",
         "--num_res_blocks", "1", "--attention_resolutions", "8", "--num_heads", "2",
         "--timestep_respacing", "2"]
DECODE = ["--num_views", "2", "--render_size", "24", "--mesh_resolution", "12",
          "--grid_resolution", "8"]
EPS = 1e-2  # --early_term_eps's default


@pytest.fixture(scope="module")
def model_npz(tmp_path_factory):
    """A tiny JAX UNet's randomized params as a flat npz with '/'-joined keys
    (the layout scripts/export_jax_weights.py writes)."""
    jmodel = jax_create_model(use_3d_aware=False, **UNET)
    x0 = jnp.zeros((1, 16, 16, 27))
    params = jax.jit(jmodel.init)(jax.random.key(0), x0, jnp.zeros((1,)), x0,
                                  jnp.zeros((1,), jnp.int32))
    params = randomize_tree(params, 6)
    flat = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(params)[0]}
    path = str(tmp_path_factory.mktemp("weights") / "unet.npz")
    np.savez(path, **flat)
    return path


@pytest.fixture(scope="module")
def decoder_npz(tmp_path_factory):
    """The fitted Stage-1 decoder with its alpha bias raised by 140: its
    density on these random samples lies in [-261, -46] (no surface at all),
    and the shift puts a surface inside the box."""
    with np.load(DECODER_NPZ) as z:
        flat = dict(z)
    flat["params/alpha/bias"] = flat["params/alpha/bias"] + 140.0
    path = str(tmp_path_factory.mktemp("weights") / "decoder.npz")
    np.savez(path, **flat)
    return path


def _samples(out_dir, layer):
    with np.load(os.path.join(out_dir, f"samples_{layer}.npz")) as z:
        return z["arr_0"]


def test_all_layers_runs_as_a_module_and_reports_fidelity(model_npz, tmp_path):
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-m", "humanliff_tpu_torch.cli.diff_sample", "--model_npz", model_npz,
         "--out_dir", out, "--all_layers", "--num_samples", "2", "--report_fidelity", *FLAGS],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    layers = {n: _samples(out, n) for n in diff_sample.LAYER_NAMES}
    for name, arr in layers.items():
        assert arr.shape == (2, 16, 16, 27) and np.isfinite(arr).all(), name
        assert np.abs(arr).max() <= 1.0
    with open(os.path.join(out, "fidelity.json")) as f:
        report = json.load(f)
    ref = jax_chain_report(layers, 0.1)
    assert list(report) == list(ref) and len(ref) == 3
    for pair in ref:
        for k in ref[pair]:
            np.testing.assert_allclose(report[pair][k], ref[pair][k], rtol=1e-6)


def test_sample_npz_chain_with_ddim_and_trajectory(model_npz, tmp_path):
    out = str(tmp_path / "out")
    prev = np.random.default_rng(2).uniform(-1, 1, (3, 16, 16, 27)).astype(np.float32)
    np.savez(str(tmp_path / "prev.npz"), prev)
    args = ["--model_npz", model_npz, "--out_dir", out, "--layer_idx", "2",
            "--sample_npz", str(tmp_path / "prev.npz"), "--use_ddim", "true",
            "--report_fidelity", *FLAGS]
    diff_sample.main(args + ["--num_samples", "3", "--batch_size", "2",
                             "--timestep_respacing", "ddim3", "--dump_trajectory", "2"])
    arr = _samples(out, "person_pant_shirt")
    assert arr.shape == (3, 16, 16, 27) and np.isfinite(arr).all()
    for done in (0, 2):  # one trajectory per batch
        with np.load(os.path.join(out, f"trajectory_person_pant_shirt_b{done}.npz")) as z:
            assert list(z["t"]) == [2, 0]
            assert z["pred_xstart"].shape == (2, 2, 16, 16, 27)
    with open(os.path.join(out, "fidelity_person_pant_shirt.json")) as f:
        report = json.load(f)
    rows = [jax_plane_fidelity(arr[i], prev[i], 0.1) for i in range(3)]
    for k in rows[0]:
        np.testing.assert_allclose(report[k], np.mean([r[k] for r in rows]), rtol=1e-6)
    with pytest.raises(ValueError, match="1:1"):
        diff_sample.main(args + ["--num_samples", "4"])


@pytest.mark.parametrize("fast", ["true", "false"])
def test_decode_matches_jax(model_npz, decoder_npz, tmp_path, fast):
    out = str(tmp_path / "out")
    diff_sample.main(["--model_npz", model_npz, "--out_dir", out, "--layer_idx", "0",
                      "--num_samples", "1", "--fast_render", fast, "--decode",
                      "--decoder_npz", decoder_npz, *FLAGS, *DECODE])
    sample = _samples(out, "person")[0]
    planes = planes_image_to_triplane(jnp.asarray(sample, jnp.bfloat16))
    dec, params = JaxDecoder(), jax_load_decoder_npz(decoder_npz)
    bounds = diff_sample.ORBIT_BOUNDS
    cams = NovelViewCameras(24)
    rays = [cams.rays(v, bounds) for v in range(2)]
    cat = {k: np.concatenate([r[k] for r in rays])
           for k in ("rays_o", "rays_d", "near", "far", "ray_mask")}
    cfg = JaxConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)
    if fast == "true":  # no ray's grid-estimated alpha near the cut
        port_dec = NeRFDecoder()
        port_dec.load_state_dict(decoder_state_dict(load_decoder_npz(decoder_npz)))
        port_planes = port_planes_to_triplane(torch.from_numpy(sample).bfloat16()).contiguous()
        grid = fastpath.build_density_grid(port_dec, port_planes, bounds, resolution=8)
        m = cat["ray_mask"] > 0
        _, acc_est = fastpath.coarse_from_grid(
            grid, *(torch.from_numpy(cat[k][m]) for k in ("rays_o", "rays_d", "near", "far")),
            torch.from_numpy(bounds),
            RenderConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False))
        assert float((acc_est - EPS).abs().min()) >= 1e-4
    args = (cat["rays_o"], cat["rays_d"], cat["near"], cat["far"], cat["ray_mask"], bounds, cfg)
    if fast == "true":
        grid = jfp.build_density_grid(dec, params, planes, bounds, resolution=8)
        ref = jfp.render_image_fast(dec, params, planes, grid, *args, chunk=512,
                                    outputs=("rgb",))
    else:
        ref = jax_render_masked(dec, params, planes, *args, chunk=512, outputs=("rgb",))
    want = (np.clip(np.asarray(ref["rgb"]).reshape(2, 24, 24, 3), 0, 1) * 255).astype(np.uint8)
    import imageio.v2 as imageio

    for v in range(2):
        got = imageio.imread(os.path.join(out, f"person_s0_v{v:03d}.png"))
        assert got.shape == (24, 24, 3)
        assert np.abs(got.astype(int) - want[v].astype(int)).max() <= 1, v
    assert len(glob.glob(os.path.join(out, "person_s0.*"))) == 2  # the PLY and a video

    ref_v, ref_t = jgeometry.extract_mesh(dec, params, planes, bounds, resolution=12)
    v, t = read_ply(os.path.join(out, "person_s0.ply"))
    assert len(t) > 0
    np.testing.assert_array_equal(t, ref_t)
    np.testing.assert_allclose(v, ref_v, atol=1e-5)


def test_cuda_is_the_default_and_is_not_replaced_by_the_cpu(model_npz, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = ["--model_npz", model_npz, "--out_dir", str(tmp_path), *FLAGS]
    args.remove("--device")
    args.remove("cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        diff_sample.main(args)
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("flag", [["--model_dir", "x"], ["--stage1_ckpt", "x"]])
def test_unported_flags_are_refused(flag):
    with pytest.raises(SystemExit):
        diff_sample.build_parser().parse_args(["--model_npz", "m.npz", *flag])


@pytest.mark.parametrize("flags", [
    ["--layer_idx", "1", "--parallel_window", "2", "--parallel_tol", "0"],
    ["--all_layers", "--parallel_window", "4", "--parallel_tol", "5e-3"],
])
def test_parallel_window_samples(model_npz, tmp_path, flags):
    """Picard sampling through the CLI (the window's arithmetic is held to JAX
    and to the sequential chain in tests/test_torch_parallel_sampling.py)."""
    out = str(tmp_path / "out")
    diff_sample.main(["--model_npz", model_npz, "--out_dir", out, "--num_samples", "2",
                      "--batch_size", "2", *flags, *FLAGS])
    names = diff_sample.LAYER_NAMES if "--all_layers" in flags else ["person_pant"]
    for name in names:
        arr = _samples(out, name)
        assert arr.shape == (2, 16, 16, 27) and np.isfinite(arr).all()
        assert np.abs(arr).max() <= 1.0
    with pytest.raises(ValueError, match="use_ddim"):
        diff_sample.main(["--model_npz", model_npz, "--out_dir", out, "--num_samples", "1",
                          "--use_ddim", "true", "--parallel_window", "2", *FLAGS])


def test_a_window_means_no_auto_plan():
    """As in the JAX CLI: the plan's costs are the sequential chain's, so a
    window samples chains of --batch_size."""
    base = ["--model_npz", "m.npz", "--all_layers", "--auto_plan", "true", "--num_samples", "9",
            "--batch_size", "3"]
    parse = diff_sample.build_parser().parse_args
    assert diff_sample.chain_batches(parse(base)) == diff_sample.plan_workload(9) != [3, 3, 3]
    assert diff_sample.chain_batches(parse(base + ["--parallel_window", "4"])) == [3, 3, 3]


@pytest.mark.parametrize("cli", ["image_sample", "image_nll"])
def test_samplers_sharing_the_parser_refuse_a_window(cli, tmp_path):
    import importlib

    main = importlib.import_module(f"humanliff_tpu_torch.cli.{cli}").main
    with pytest.raises(SystemExit):
        main(["--model_npz", str(tmp_path / "missing.npz"), "--parallel_window", "4",
              "--out_dir", str(tmp_path), *FLAGS])
