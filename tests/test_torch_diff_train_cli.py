"""The port's Stage-2 training CLI (``humanliff_tpu_torch.cli.diff_train``) on
the CPU at a tiny width: its log files and keys, the save policy, resuming a
full and a light checkpoint, ``DIFFUSION_TRAINING_TEST``, packed data on and
off the device, one divergence from the JAX CLI that is on purpose (the final
save), and sampling the result with ``diff_sample --model_dir``."""

import csv
import json
import os

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu_torch.cli import diff_sample, diff_train
from humanliff_tpu_torch.data.triplane_data import pack_subject_planes
from humanliff_tpu_torch.models.factory import create_model_and_diffusion
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.stage2 import Stage2Config, create_stage2_state, restore_into

MODEL = ["--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
         "--attention_resolutions", "8", "--num_heads", "2"]
TINY = MODEL + ["--device", "cpu", "--batch_size", "4", "--microbatch", "2"]


def _train(logdir, *flags):
    return diff_train.main(TINY + ["--logdir", str(logdir), *flags])


def _steps(logdir):
    return sorted(int(f) for f in os.listdir(logdir) if f.isdigit())


def test_logs_saves_and_resumes_at_the_next_step(tmp_path, capsys):
    state = _train(tmp_path, "--total_steps", "4", "--log_interval", "2", "--save_interval", "2")
    assert state.step == 4 and _steps(tmp_path) == [2, 4]
    with open(tmp_path / "progress.csv") as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["step", "loss", "grad_norm", "loss_q0", "loss_q1", "loss_q2", "loss_q3",
                       "steps_per_sec"]
    assert [r[0] for r in rows[1:]] == ["2", "4"]
    with open(tmp_path / "progress.json") as f:
        logs = [json.loads(line) for line in f]
    assert [m["step"] for m in logs] == [2, 4]
    assert all(np.isfinite(m["loss"]) and np.isfinite(m["grad_norm"]) for m in logs)

    saved, _ = ckpt.restore_state(str(tmp_path))
    assert saved["step"] == 4 and saved["opt_state"]["count"] == 4
    # A restore is bit for bit: params, moments, EMA.
    torch.manual_seed(1)
    model, diffusion = create_model_and_diffusion(**{"image_size": 16, "num_channels": 32,
                                                     "num_res_blocks": 1,
                                                     "attention_resolutions": "8",
                                                     "num_heads": 2})
    fresh = create_stage2_state(model, Stage2Config(), diffusion.num_timesteps)
    assert restore_into(fresh, saved)
    views = fresh.layout.views
    for got, want in [(views(fresh.params), saved["params"]),
                      (views(fresh.opt_state["mu"]), saved["opt_state"]["mu"]),
                      (views(fresh.opt_state["nu"]), saved["opt_state"]["nu"]),
                      (views(fresh.ema_params["0.9999"]), saved["ema_params"]["0.9999"])]:
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert all(torch.equal(p, saved["params"][n]) for n, p in model.named_parameters())

    capsys.readouterr()
    state = _train(tmp_path, "--total_steps", "5", "--log_interval", "2", "--save_interval", "2")
    assert "resumed from step 4" in capsys.readouterr().out
    assert state.step == 5 and state.opt_state["count"] == 5 and _steps(tmp_path) == [2, 4, 5]


def test_light_checkpoint_resumes_with_a_fresh_optimizer(tmp_path, capsys):
    _train(tmp_path, "--total_steps", "3", "--save_interval", "2", "--mid_save", "light",
           "--skip_final_save", "true")
    light, step = ckpt.restore_state(str(tmp_path))
    assert step == 2 and "opt_state" not in light and "sampler_state" not in light
    state = _train(tmp_path, "--total_steps", "4", "--save_interval", "100")
    assert "resumed from LIGHT checkpoint at step 2" in capsys.readouterr().out
    # Steps 3 and 4 ran; the optimizer (and its schedule) restarted at count 0.
    assert state.step == 4 and state.opt_state["count"] == 2
    final, step = ckpt.restore_state(str(tmp_path))
    assert step == 4 and final["opt_state"]["count"] == 2


def test_final_save_is_full_where_the_jax_cli_keeps_a_light_mid_save(tmp_path):
    """Divergence from the JAX CLI, on purpose: with --mid_save light and a
    periodic save on the final step, the JAX CLI writes the light save and its
    per-step idempotent save_state then keeps it, dropping the full final
    save. The port leaves that step to the final-save policy."""
    _train(tmp_path, "--total_steps", "3", "--save_interval", "3", "--mid_save", "light")
    final, step = ckpt.restore_state(str(tmp_path))
    assert step == 3 and final["opt_state"]["count"] == 3 and _steps(tmp_path) == [3]


def test_light_final_save_and_idempotent_saves(tmp_path, capsys):
    _train(tmp_path, "--total_steps", "2", "--light_final_save", "true")
    final, step = ckpt.restore_state(str(tmp_path))
    assert step == 2 and "opt_state" not in final
    _train(tmp_path, "--total_steps", "2")  # nothing left to train: the save is kept
    assert "step 2 already saved" in capsys.readouterr().out
    assert "opt_state" not in ckpt.restore_state(str(tmp_path))[0]


def test_partial_save_is_redone(tmp_path):
    os.makedirs(tmp_path / "000002")
    (tmp_path / "000002" / ckpt.STATE_FILE).write_bytes(b"truncated")
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.save_state(str(tmp_path), 2, {"step": 2, "x": torch.arange(3)})
    restored, step = ckpt.restore_state(str(tmp_path))
    assert step == 2 and torch.equal(restored["x"], torch.arange(3))


def test_diffusion_training_test_exits_after_the_first_save(tmp_path, monkeypatch):
    monkeypatch.setenv("DIFFUSION_TRAINING_TEST", "1")
    state = _train(tmp_path, "--total_steps", "10", "--save_interval", "2")
    assert state.step == 2 and _steps(tmp_path) == [2]


@pytest.mark.parametrize("device_data", ["true", "false"])
def test_packed_planes_on_and_off_the_device(tmp_path, device_data, capsys):
    rng = np.random.default_rng(0)
    paths = []
    for i in range(2):
        paths.append(str(tmp_path / f"s{i}.npz"))
        ckpt.save_subject_planes(paths[-1], rng.normal(scale=0.3, size=(4, 3, 9, 16, 16)), 1)
    pack_subject_planes(paths, str(tmp_path / "packed.npy"))
    state = _train(tmp_path / "run", "--data_dir", str(tmp_path / "packed.npy"),
                   "--device_data", device_data, "--total_steps", "2", "--log_interval", "1",
                   "--schedule_sampler", "loss-second-moment")
    out = capsys.readouterr().out
    assert ("device-resident dataset" in out) == (device_data == "true")
    assert state.step == 2 and int(state.sampler_state["counts"].sum()) == 8
    with open(tmp_path / "run" / "progress.json") as f:
        assert all(np.isfinite(json.loads(line)["loss"]) for line in f)


def test_refusals(tmp_path, monkeypatch):
    with pytest.raises(ValueError, match="image folder"):  # --data_dir is "synthetic"
        _train(tmp_path, "--data_name", "imagenet")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        diff_train.main(MODEL + ["--logdir", str(tmp_path)])


def test_sample_the_run_with_the_ema_burn_in_rule(tmp_path, capsys):
    """diff_sample --model_dir reads the port's checkpoints: EMA(0.5) after 4
    steps carries 0.5^4 = 6 % of the init and is used; EMA(0.9999) carries
    99.96 %, so the raw params are sampled instead."""
    run = tmp_path / "run"
    _train(run, "--total_steps", "4", "--ema_rate", "0.5,0.9999")
    saved, _ = ckpt.restore_state(str(run))
    ema = diff_sample.load_train_weights(str(run), None, "0.5")
    raw = diff_sample.load_train_weights(str(run), 4, "0.9999")
    assert "RAW params" in capsys.readouterr().out
    assert all(torch.equal(ema[k], saved["ema_params"]["0.5"][k]) for k in ema)
    assert all(torch.equal(raw[k], saved["params"][k]) for k in raw)
    assert not torch.equal(ema["out.2.weight"], raw["out.2.weight"])

    out = tmp_path / "samples"
    diff_sample.main(MODEL + ["--device", "cpu", "--model_dir", str(run), "--ema_rate", "0.5",
                              "--timestep_respacing", "ddim2", "--use_ddim", "true",
                              "--num_samples", "1", "--out_dir", str(out)])
    samples = ckpt.load_samples_npz(str(out / "samples_person.npz"))
    assert samples.shape == (1, 16, 16, 27)
    assert np.isfinite(samples).all() and np.abs(samples).max() <= 1.0
