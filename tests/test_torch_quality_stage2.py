"""The port's Stage-2 generative-quality campaign (``cli/quality_stage2.py``)
end to end on the CPU at the JAX test's tiny dims
(tests/test_quality_stage2.py:58-80), from a tiny Stage-1 checkpoint of the
port's ``recon_train``: export, frozen-decoder fine-tune of one subject,
pack with one held out, diffusion training, chain sampling, scoring, report.

The one width that differs is the plane channels: 27, not the JAX test's 9,
since the port's decoder (and its fused kernel) is built for 27 -> 128.

Checks: a success report, ``stage2_metrics.json`` with the JAX CLI's key set
(read from the JAX CLI's source), finite scores, a second run that skips
every leg it can (export, fine-tune, training, sampling) and reproduces the
report, ``--report_only``, and a failure report on a failed leg, as
``test_failure_report_always_written``.

Named divergences: ``--out_dir`` defaults to ``runs/quality_torch``; one
process here, so ``--diff_batch_size`` need not divide a mesh (the campaign
under a 2-rank mesh: tests/test_torch_parallel.py).
"""

import ast
import json
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu_torch.cli import diff_train, quality_stage2, recon_ft, recon_train
from humanliff_tpu_torch.sampling import layered

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, CH, IMG = 16, 27, 24
ARGS = ["--device", "cpu", "--num_instance", "2", "--image_size", str(IMG),
        "--triplane_dim", str(D), "--triplane_ch", str(CH), "--n_samples", "8",
        "--n_importance", "8", "--ft_subjects", "1", "--ft_steps", "4", "--ft_n_rand", "64",
        "--num_channels", "16", "--num_res_blocks", "1", "--attention_resolutions", "8",
        "--diff_steps", "4", "--diff_batch_size", "8", "--save_interval", "4",
        "--num_samples", "2", "--respacing", "4", "--decode_size", "24",
        "--n_eval_timesteps", "2", "--seed", "0"]


def jax_metric_keys():
    """The keys of the ``metrics`` dict the JAX CLI writes to stage2_metrics.json."""
    path = os.path.join(REPO, "humanliff_tpu", "cli", "quality_stage2.py")
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and any(getattr(t, "id", None) == "metrics" for t in node.targets)):
            return {k.value for k in node.value.keys}
    raise AssertionError("no metrics dict in the JAX CLI")


@pytest.fixture(scope="module")
def campaign(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("quality"))
    recon_train.main(["--device", "cpu", "--data_set_type", "synthetic", "--num_instance", "2",
                      "--synthetic_image_size", str(IMG), "--synthetic_tight_bounds", "true",
                      "--n_rand", "64", "--n_samples", "8", "--n_importance", "8",
                      "--triplane_dim", str(D), "--basedir", out, "--expname", "train",
                      "--n_iteration", "10", "--i_print", "5", "--i_weights", "10"])
    metrics = quality_stage2.main(["--out_dir", out] + ARGS)
    return out, metrics


def test_campaign_end_to_end(campaign):
    out, metrics = campaign
    work = os.path.join(out, "stage2")
    planes = sorted(os.listdir(os.path.join(work, "planes")))
    assert planes == ["campaign0000_000010.npz", "campaign0001_000010.npz",
                      "subject0002_002000.npz"]
    tr = np.load(os.path.join(work, "planes_train.npy"), mmap_mode="r")
    he = np.load(os.path.join(work, "planes_heldout.npy"), mmap_mode="r")
    assert tr.shape == (2, 4, CH, D, D) and he.shape == (1, 4, CH, D, D)

    with open(os.path.join(work, "stage2_metrics.json")) as f:
        saved = json.load(f)
    assert set(saved) == jax_metric_keys()
    assert saved["heldout_subject"] == "subject0002_002000.npz"
    for split in ("denoise_loss_heldout", "denoise_loss_train"):
        assert sorted(int(k) for k in saved[split]) == [0, 1, 2, 3]
        assert all(np.isfinite(v) for v in saved[split].values())
    assert len(saved["plane_fidelity"]) == 3 and len(saved["decoded_fidelity"]) == 3
    for m in saved["decoded_fidelity"].values():
        assert 0.0 <= m["changed_pixel_fraction"] <= 1.0
        assert 0.0 <= m["occupancy_persistence"] <= 1.0
        assert np.isfinite(m["unchanged_psnr"])
    assert all(np.isfinite(v) for v in saved["nearest_gt_psnr"].values())
    assert metrics["diff_step"] == saved["diff_step"] == 4
    # The EMA burn-in guard fires at 4 steps (0.999^4 ~ 1): raw weights, labelled.
    assert saved["weights"].startswith("raw")
    report = open(os.path.join(work, "STAGE2.md")).read()
    assert "STATUS: FAILED" not in report
    assert "held-out" in report and "Chain fidelity" in report
    assert "Decoded renders" in report and "decoded_l0_person.png" in report
    assert "WARNING: scored RAW params" in report
    with open(os.path.join(work, "samples", "samples_meta.json")) as f:
        meta = json.load(f)
    assert meta["diff_step"] == 4 and len(meta["weights_fp"]) == 16
    for name in layered.LAYER_NAMES:
        with np.load(os.path.join(work, "samples", f"samples_{name}.npz")) as z:
            arr = z[z.files[0]]
        assert arr.shape == (2, D, D, CH) and np.abs(arr).max() <= 1.0


def test_second_run_skips_every_leg(campaign, monkeypatch):
    out, first = campaign
    work = os.path.join(out, "stage2")

    def must_not_run(*args, **kwargs):
        raise AssertionError("a leg whose artifact exists ran again")

    monkeypatch.setattr(recon_ft, "main", must_not_run)
    monkeypatch.setattr(diff_train, "main", must_not_run)
    monkeypatch.setattr(layered, "generate_workload", must_not_run)
    exports = os.path.join(work, "planes", "campaign0000_000010.npz")
    mtimes = {p: os.path.getmtime(os.path.join(work, p))
              for p in ("planes/campaign0000_000010.npz", "planes_train.npy",
                        "samples/samples_person.npz")}
    os.remove(os.path.join(work, "STAGE2.md"))
    os.remove(os.path.join(work, "samples", "fidelity.json"))  # recomputed from the samples
    second = quality_stage2.main(["--out_dir", out] + ARGS)
    assert os.path.exists(exports)
    assert {p: os.path.getmtime(os.path.join(work, p)) for p in mtimes} == mtimes
    assert second["diff_step"] == 4 and second["weights_fp"] == first["weights_fp"]
    for k in ("denoise_loss_heldout", "nearest_gt_psnr", "decoded_fidelity", "plane_fidelity"):
        assert json.dumps(second[k]) == json.dumps(first[k]), k
    assert "Chain fidelity" in open(os.path.join(work, "STAGE2.md")).read()

    # --report_only rebuilds STAGE2.md from stage2_metrics.json alone.
    os.remove(os.path.join(work, "STAGE2.md"))
    quality_stage2.main(["--out_dir", out, "--report_only"])
    rebuilt = open(os.path.join(work, "STAGE2.md")).read()
    assert "Chain fidelity" in rebuilt and "Decoded renders" in rebuilt


def test_failure_report_always_written(tmp_path):
    """A campaign that dies (no Stage-1 checkpoint at all) labels its work
    directory as failed, and writes no stage2_metrics.json."""
    out = str(tmp_path / "empty")
    with pytest.raises(FileNotFoundError):
        quality_stage2.main(["--out_dir", out, "--device", "cpu", "--num_instance", "2",
                             "--triplane_dim", "16"])
    report = open(os.path.join(out, "stage2", "STAGE2.md")).read()
    assert "STATUS: FAILED" in report and "stage-1 plane export" in report
    assert not os.path.exists(os.path.join(out, "stage2", "stage2_metrics.json"))


def test_missing_cuda_fails_with_a_report(tmp_path):
    if torch.cuda.is_available():
        return
    out = str(tmp_path / "q")
    with pytest.raises(RuntimeError, match="--device cpu"):
        quality_stage2.main(["--out_dir", out])
    assert "STATUS: FAILED" in open(os.path.join(out, "stage2", "STAGE2.md")).read()
