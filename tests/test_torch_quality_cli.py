"""The port's quality-campaign CLIs on the CPU: ``recon_refit``,
``quality_eval`` and ``bench_decode``, against the JAX package's CLIs and
file contracts.

- ``recon_refit --refit_steps 0`` on the committed fitted pair: the planes
  and the decoder of the checkpoint are the files', bit for bit. With 3 steps
  at D 16 the planes stay bit-identical, the decoder moves, and the sidecar,
  stamp and ``{step:06d}_REFIT.txt`` follow the JAX CLI's contract; one refit
  step (plane lr 0) against JAX's on a fixed batch, under
  tests/torch_stage1_util.py's rules.
- ``quality_eval --skip_train`` on a tiny state carried from a JAX Stage-1
  state (``export_jax_weights.stage1_state_arrays`` -> ``compat.from_jax``):
  each (subject, layer) PSNR within 1e-3 dB and SSIM within 1e-4 of JAX's
  ``_evaluate`` on that state (both fp32, deterministic renders); ``_report``
  writes the same QUALITY.md text for the same results.
- ``bench_decode`` at a tiny size writes the JAX CLI's keys (those of the
  committed ``runs/quality/bench_decode.json``).
- Every CLI raises without CUDA unless given ``--device cpu``.

Named divergence: the port's CLIs default ``--out_dir`` / ``--out_json`` /
``--ckpt_dir`` to ``runs/quality_torch/...``, not the JAX campaign's
``runs/quality``.
"""

import argparse
import glob
import json
import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_stage1_util as U
from humanliff_tpu.cli import quality_eval as jquality_eval
from humanliff_tpu.train import checkpoint as jckpt
from humanliff_tpu.train import optim as joptim
from humanliff_tpu.train import stage1 as jstage1
from humanliff_tpu_torch.cli import bench_decode, quality_eval, quality_stage2, recon_refit
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict, stage1_state_from_arrays
from humanliff_tpu_torch.nerf.decoder import flatten_state_dict
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train import optim
from humanliff_tpu_torch.train.stage1 import create_train_state, train_step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import export_jax_weights  # noqa: E402

PLANES = [os.path.join(REPO, "runs", "quality", "stage2", "planes", f"campaign000{i}_060000.npz")
          for i in range(2)]
DECODER = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
TINY = ["--device", "cpu", "--data_set_type", "synthetic", "--num_instance", "2",
        "--synthetic_image_size", "24", "--synthetic_tight_bounds", "true", "--n_rand", "32",
        "--n_samples", "8", "--n_importance", "8"]


def test_refit_reassembles_the_committed_pair_bit_for_bit(tmp_path):
    recon_refit.main(TINY + ["--plane_files", ",".join(PLANES), "--decoder_from", DECODER,
                             "--refit_steps", "0", "--basedir", str(tmp_path),
                             "--expname", "train"])
    expdir = str(tmp_path / "train")
    restored, step = ckpt.restore_state(expdir)
    assert step == 60000 and restored["step"] == 60000
    for i, path in enumerate(PLANES):
        np.testing.assert_array_equal(restored["planes"][i].numpy(),
                                      ckpt.load_subject_planes(path))
    want = flatten_state_dict(decoder_state_dict(jckpt.load_decoder_npz(DECODER)))
    assert torch.equal(restored["decoder"], want)
    # The new sidecar is the committed one, value for value.
    with np.load(DECODER) as a, np.load(os.path.join(expdir, "decoder_060000.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])
    assert os.path.exists(os.path.join(expdir, "060000_REFIT.txt"))
    # The saved optimizer state is recon_train's layout, both groups.
    assert restored["opt_state"]["planes"]["count"] == 0
    assert restored["opt_state"]["decoder"]["count"] == 0


@pytest.fixture
def exports(tmp_path):
    planes = U.plane_table(3, layers=4)
    paths = []
    for i in range(2):
        path = str(tmp_path / "planes" / f"campaign{i:04d}_000042.npz")
        os.makedirs(os.path.dirname(path), exist_ok=True)
        ckpt.save_subject_planes(path, planes[i], 42)
        paths.append(path)
    return planes, paths


def test_refit_trains_the_decoder_on_frozen_planes(tmp_path, exports):
    """The JAX test's recovery case (tests/test_quality_stage2.py): a
    surviving earlier checkpoint warm-starts the decoder, 3 steps refit it,
    the planes stay the exports', the checkpoint carries the exports' step,
    and a zero-step reassembly from the new sidecar gives the same pair."""
    planes, paths = exports
    _, _, dflat = U.decoder_vars(3)
    warm = create_train_state({"planes": torch.from_numpy(planes.copy()), "decoder": dflat.clone()},
                              optim.make_stage1_optimizer())
    warm_dir = str(tmp_path / "warm")
    ckpt.save_state(warm_dir, 5, {"step": 5, "planes": warm.params["planes"],
                                  "decoder": warm.params["decoder"],
                                  "opt_state": warm.opt_state})
    argv = TINY + ["--plane_files", str(tmp_path / "planes" / "campaign*.npz"),
                   "--triplane_dim", "16", "--batch_size", "2", "--i_print", "3"]
    state = recon_refit.main(argv + ["--basedir", str(tmp_path / "refit"), "--expname", "train",
                                     "--refit_steps", "3", "--refit_lr", "1e-3",
                                     "--decoder_from", warm_dir])
    expdir = str(tmp_path / "refit" / "train")
    assert ckpt.latest_step(expdir) == 42 and state.step == 42
    restored, _ = ckpt.restore_state(expdir)
    for i, path in enumerate(paths):
        np.testing.assert_array_equal(restored["planes"][i].numpy(),
                                      ckpt.load_subject_planes(path))
    assert not torch.equal(restored["decoder"], dflat)
    assert restored["opt_state"]["decoder"]["count"] == 3
    assert restored["opt_state"]["planes"]["count"] == 3
    # The sidecar in the JAX layout, read by the JAX package; the stamp.
    sidecar = os.path.join(expdir, "decoder_000042.npz")
    with np.load(sidecar) as z:
        assert int(z["__global_step__"]) == 42
    np.testing.assert_array_equal(
        U.decoder_flat(jckpt.load_decoder_npz(sidecar)), restored["decoder"].numpy())
    text = open(os.path.join(expdir, "000042_REFIT.txt")).read().splitlines()
    assert text[0].startswith("Recovered checkpoint: planes are the UNMODIFIED exports below "
                              "(frozen, plane lr 0); the decoder was refit against them for "
                              "3 steps at lr 0.001 (warm-start: ")
    assert text[0].endswith("step 5)")
    assert text[1:] == [os.path.abspath(p) for p in paths]
    logs = [json.loads(line) for line in open(os.path.join(expdir, "progress.json"))]
    assert [m["step"] for m in logs] == [3]

    # Zero-step reassembly from the sidecar reproduces the refit pair.
    recon_refit.main(argv + ["--basedir", str(tmp_path / "again"), "--expname", "train",
                             "--refit_steps", "0", "--decoder_from", sidecar])
    again, _ = ckpt.restore_state(str(tmp_path / "again" / "train"))
    assert torch.equal(again["decoder"], restored["decoder"])
    assert torch.equal(again["planes"], restored["planes"])
    with pytest.raises(FileNotFoundError, match="pure reassembly"):
        recon_refit.main(argv + ["--basedir", str(tmp_path / "none"), "--expname", "train",
                                 "--refit_steps", "0"])
    with pytest.raises(ValueError, match="--num_instance"):
        recon_refit.main(argv + ["--basedir", str(tmp_path / "x"), "--num_instance", "3"])


def test_refit_step_matches_jax_with_plane_lr_0(monkeypatch):
    """One refit step (the refit's config: no TV, L1 or clamp; decoder lr
    1e-3, plane lr 0) on a fixed batch: the loss within rtol 1e-5, the
    decoder within tests/torch_stage1_util.py's near-zero rule, and the
    planes unmoved in both packages."""
    jcfg, cfg = U.configs(tv_loss_coef=0.0, l1_loss_coef=0.0, use_clamp=False)
    dec, dvars, dflat = U.decoder_vars(1)
    planes = U.plane_table(1)
    batch = U.item_batch(U.dataset(), [(0, 0), (1, 1)], seed=2)
    tx = joptim.make_stage1_optimizer(1e-3, 0.0, 500)
    jp = {"planes": jnp.asarray(planes), "decoder": dvars}
    jstate = jstage1.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                                tx=tx)
    state = create_train_state({"planes": torch.from_numpy(planes.copy()),
                                "decoder": dflat.clone()},
                               optim.make_stage1_optimizer(1e-3, 0.0, 500))
    with U.jax_deterministic(monkeypatch) as fns:
        _, g = fns.loss_and_grad(jstate.params, U.to_jax(batch), dec, jcfg, jax.random.key(0))
        jstate, jaux = fns.step(jstate, U.to_jax(batch), jax.random.key(0), dec, jcfg)
    aux = train_step(state, U.to_torch(batch), cfg)
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(jstate.params["planes"]), planes)
    np.testing.assert_array_equal(state.params["planes"].numpy(), planes)
    moved = np.abs(state.params["decoder"].numpy() - dflat.numpy()).max()
    assert moved > 5e-4  # lr 1e-3: the decoder stepped
    U.near_zero_rule(state.params["decoder"].numpy(), U.decoder_flat(jstate.params["decoder"]),
                     1e-3, 1, "decoder", np.abs(U.decoder_flat(g["decoder"])) < U.NEAR_ZERO_GRAD)


@pytest.fixture(scope="module")
def carried_state(tmp_path_factory):
    """A tiny JAX Stage-1 state (2 instances x 4 layers, D 16, blob planes),
    saved by the JAX package under ``jax/train`` and carried to the port's
    checkpoint under ``port/train``."""
    base = tmp_path_factory.mktemp("quality")
    planes = U.plane_table(5, layers=4)
    dec, dvars, _ = U.decoder_vars(5)
    tx = joptim.make_stage1_optimizer(5e-3, 1e-1, 500)
    jp = {"planes": jnp.asarray(planes), "decoder": dvars}
    jstate = jstage1.TrainState(step=jnp.asarray(7, jnp.int32), params=jp,
                                opt_state=tx.init(jp), tx=tx)
    jckpt.save_state(str(base / "jax" / "train"), 7, jstate)
    payload = stage1_state_from_arrays(export_jax_weights.stage1_state_arrays(jstate))
    ckpt.save_state(str(base / "port" / "train"), 7, payload)
    return base


EVAL_FLAGS = ["--num_instance", "2", "--image_size", "20", "--n_rand", "16", "--n_samples",
              "8", "--n_importance", "8", "--triplane_dim", "16", "--skip_train"]


def test_quality_eval_matches_jax_evaluate(carried_state):
    base = carried_state
    ours = quality_eval.main(["--device", "cpu", "--out_dir", str(base / "port")] + EVAL_FLAGS)
    jargs = jquality_eval.build_parser().parse_args(["--out_dir", str(base / "jax")]
                                                    + EVAL_FLAGS)
    step, _, theirs = jquality_eval._evaluate(jargs)
    assert step == 7 and sorted(ours) == sorted(theirs)
    assert len(ours) == 8 and all(k.endswith("_exact") for k in ours)
    for k in ours:
        assert abs(ours[k]["psnr"] - theirs[k]["psnr"]) <= 1e-3, (k, ours[k], theirs[k])
        assert abs(ours[k]["ssim"] - theirs[k]["ssim"]) <= 1e-4, (k, ours[k], theirs[k])
        assert "lpips" not in ours[k]
    # The scene is not trivial: the renders meet the subjects.
    assert 5.0 < min(v["psnr"] for v in ours.values()) < 60.0
    out = base / "port"
    assert os.path.exists(out / "QUALITY.md") and os.path.exists(out / "quality_metrics.json")
    rows = glob.glob(str(out / "eval_000007" / "metrics_s*_l*.json"))
    assert len(rows) == 8 and len(glob.glob(str(out / "eval_000007" / "metrics_*.npy"))) == 8


def test_report_text_matches_jax(tmp_path):
    """The same results (two evaluated checkpoints, a fast tier, a notes
    sidecar) give the same QUALITY.md and quality_metrics.json."""
    rng = np.random.default_rng(0)

    def results(step):
        out = {}
        for s in range(2):
            for layer in range(4):
                for tier in ("exact", "fast"):
                    out[f"subject{s}_layer{layer}_{tier}"] = {
                        "mse": float(rng.uniform(1e-4, 1e-2)),
                        "psnr": float(rng.uniform(18, 32)) - (step == 20 and layer == 3) * 3,
                        "ssim": float(rng.uniform(0.6, 0.9)),
                        "time_per_image_s": float(rng.uniform(0.01, 1))}
        return out

    texts = []
    for pkg, mod in (("port", quality_eval), ("jax", jquality_eval)):
        out = tmp_path / pkg
        out.mkdir()
        (out / "QUALITY_NOTES.md").write_text("NOTE: a campaign note\n")
        args = argparse.Namespace(out_dir=str(out), steps=18000, batch_size=2, n_rand=2048,
                                  n_samples=128, n_importance=128, num_instance=2,
                                  image_size=128, use_bf16=False, seed=0, fast_eval=True)
        rng = np.random.default_rng(0)
        for step in (10, 20):
            mod._report(args, step, "runs/x/eval", results(step))
        texts.append(((out / "QUALITY.md").read_text(),
                      json.loads((out / "quality_metrics.json").read_text())))
    assert texts[0] == texts[1]
    assert "Held-out PSNR by checkpoint" in texts[0][0] and "NOTE: a campaign note" in texts[0][0]


def test_report_only_rebuilds_without_a_device(carried_state, tmp_path):
    out = tmp_path / "r"
    out.mkdir()
    (out / "quality_metrics.json").write_text(
        (carried_state / "port" / "quality_metrics.json").read_text())
    results = quality_eval.main(["--out_dir", str(out), "--report_only"])
    assert len(results) == 8 and (out / "QUALITY.md").exists()


def test_bench_decode_writes_the_jax_keys(carried_state, tmp_path):
    out_json = str(tmp_path / "bench.json")
    result = bench_decode.main(["--device", "cpu", "--ckpt_dir",
                                str(carried_state / "port" / "train"), "--out_json", out_json,
                                "--num_views", "2", "--render_size", "16",
                                "--grid_resolution", "8", "--layer", "1"])
    with open(os.path.join(REPO, "runs", "quality", "bench_decode.json")) as f:
        jax_keys = set(json.load(f))
    with open(out_json) as f:
        assert set(json.load(f)) == jax_keys == set(result)
    assert result["checkpoint_step"] == 7 and result["num_views"] == 2
    assert result["dtype"] == "bf16" and np.isfinite(result["fast_vs_exact_psnr_db"])
    with pytest.raises(FileNotFoundError, match="no checkpoint"):
        bench_decode.main(["--device", "cpu", "--ckpt_dir", str(tmp_path / "empty")])


def test_defaults_and_missing_cuda(tmp_path):
    """The named divergence of the output paths, and --device cuda raising
    where CUDA is missing (no fallback to the CPU)."""
    assert quality_eval.build_parser().parse_args([]).out_dir == "runs/quality_torch"
    assert quality_stage2.build_parser().parse_args([]).out_dir == "runs/quality_torch"
    bd = bench_decode.build_parser().parse_args([])
    assert (bd.ckpt_dir, bd.out_json) == ("runs/quality_torch/train",
                                          "runs/quality_torch/bench_decode.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            recon_refit.main(["--plane_files", ",".join(PLANES), "--num_instance", "2",
                              "--refit_steps", "0", "--decoder_from", DECODER,
                              "--basedir", str(tmp_path)])
        with pytest.raises(RuntimeError, match="--device cpu"):
            quality_eval.main(["--out_dir", str(tmp_path / "q"), "--skip_train"])
        with pytest.raises(RuntimeError, match="--device cpu"):
            bench_decode.main(["--ckpt_dir", str(tmp_path / "b")])
        assert os.listdir(tmp_path) == []
