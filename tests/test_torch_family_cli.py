"""The port's CLIs of the rest of the model family on the CPU at a tiny width:
``image_sample`` (both class modes), ``image_nll`` (its three data
branches, the printed bits/dim against ``calc_bpd_loop`` on the same
inputs and noise), ``sr_train`` -> ``sr_sample``, ``diff_train`` in every
new mode, ``diff_sample --auto_plan`` and the dispatcher ``cli.main``."""

import argparse
import os
import re

import numpy as np
import pytest
import torch

import torch_port_util  # noqa: F401  (one torch thread)
from humanliff_tpu.cli.main import COMMANDS as JAX_COMMANDS
from humanliff_tpu_torch.cli import (
    diff_sample,
    diff_train,
    image_nll,
    image_sample,
    main as dispatcher,
    sr_sample,
    sr_train,
)
from humanliff_tpu_torch.models.factory import create_model_and_diffusion
from humanliff_tpu_torch.sampling.layered import _model_fn, plan_workload
from humanliff_tpu_torch.utils.video import write_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
UNET = dict(image_size=16, num_channels=32, num_res_blocks=1, attention_resolutions="8",
            num_heads=2)
MODEL = [x for k, v in UNET.items() for x in (f"--{k}", str(v))]


def _model_npz(path, seed=0, **kw):
    """A seeded tiny port model's state dict, in the npz form diff_sample reads."""
    torch.manual_seed(seed)
    model, _ = create_model_and_diffusion(**UNET, **kw)
    with torch.no_grad():
        for p in model.parameters():  # zero-init layers carry signal too
            p.add_(0.05 * torch.randn_like(p))
    np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})
    return str(path)


def _rgb_npz(tmp_path):
    return _model_npz(tmp_path / "rgb.npz", in_channels=3, out_channels=3)


def _folder(tmp_path, n=4, size=24):
    rng = np.random.default_rng(0)
    d = tmp_path / "images"
    d.mkdir()
    for i in range(n):
        write_png(str(d / f"{'ab'[i % 2]}_{i}.png"), rng.integers(0, 255, (size, size, 3), np.uint8))
    return str(d)


@pytest.mark.parametrize("class_cond", ["true", "false"])
def test_image_sample_npz(tmp_path, class_cond):
    npz = _model_npz(tmp_path / "m.npz", class_cond=class_cond == "true")
    path = image_sample.main(["--model_npz", npz, "--device", "cpu", *MODEL, "--class_cond",
                              class_cond, "--timestep_respacing", "2", "--num_samples", "3",
                              "--batch_size", "2", "--out_dir", str(tmp_path / "out")])
    assert os.path.basename(path) == "samples_3x16x16x27.npz"
    with np.load(path) as z:
        assert z.files == (["arr_0", "arr_1"] if class_cond == "true" else ["arr_0"])
        x = z["arr_0"]
        assert x.shape == (3, 16, 16, 27) and np.isfinite(x).all() and np.abs(x).max() <= 1
        if class_cond == "true":
            assert z["arr_1"].shape == (3,) and set(z["arr_1"]) <= {0, 1, 2, 3}


@pytest.mark.parametrize("branch", ["npz", "dir", "random"])
def test_image_nll_prints_calc_bpd_loop(tmp_path, capsys, branch):
    npz = _rgb_npz(tmp_path)
    flags = ["--model_npz", npz, "--device", "cpu", *MODEL, "--in_channels", "3",
             "--out_channels", "3", "--timestep_respacing", "4", "--batch_size", "2",
             "--num_samples", "3", "--seed", "4"]
    if branch == "npz":
        data = np.random.default_rng(2).uniform(-1, 1, (3, 16, 16, 3)).astype(np.float32)
        np.savez(tmp_path / "data.npz", data)
        flags += ["--data_npz", str(tmp_path / "data.npz")]
    elif branch == "dir":
        flags += ["--data_dir", _folder(tmp_path)]
    result = image_nll.main(flags)
    out = capsys.readouterr().out
    printed = float(re.search(r"final bits/dim: ([-\d.]+)", out).group(1))
    assert len(re.findall(r"batch \d+: mean bpd so far", out)) == 2

    # The same images, model and noise, by hand.
    args = image_nll.build_parser()
    args.add_argument("--data_npz")
    args.add_argument("--data_dir")
    args = args.parse_args(flags)
    data = image_nll.load_data(args)
    assert data.shape == (3, 16, 16, 3)
    model, diffusion = diff_sample._load_model(args, torch.device("cpu"))
    base = _model_fn(model, False)

    def model_fn(x, ts, xc, y=None):
        return base(x, ts, torch.zeros_like(x), torch.zeros(x.shape[0], dtype=torch.int64))

    gen = torch.Generator().manual_seed(4)
    want = torch.cat([diffusion.calc_bpd_loop(model_fn, torch.from_numpy(data[i:i + 2]), gen)
                      ["total_bpd"] for i in (0, 2)]).numpy()
    np.testing.assert_array_equal(result["total_bpd"], want)
    assert printed == float(f"{want.mean():.4f}")
    assert result["vb"].shape == (3, 4) and (result["prior_bpd"] >= 0).all()


SR = ["--large_size", "16", "--small_size", "8", "--num_channels", "32", "--num_res_blocks",
      "1", "--attention_resolutions", "8", "--num_heads", "2", "--device", "cpu"]


@pytest.mark.parametrize("data", ["synthetic", "folder"])
def test_sr_train_then_sr_sample(tmp_path, data):
    data_dir = "synthetic" if data == "synthetic" else _folder(tmp_path, size=20)
    logdir = str(tmp_path / "sr")
    state = sr_train.main(SR + ["--data_dir", data_dir, "--logdir", logdir, "--batch_size", "2",
                                "--total_steps", "3", "--log_interval", "1",
                                "--save_interval", "2", "--ema_rate", "0.5"])
    assert state.step == 3
    assert sorted(int(f) for f in os.listdir(logdir) if f.isdigit()) == [2, 3]
    with open(os.path.join(logdir, "progress.json")) as f:
        assert sum(1 for _ in f) == 3
    low = np.random.default_rng(1).normal(scale=0.3, size=(3, 8, 8, 3)).astype(np.float32)
    np.savez(tmp_path / "low.npz", low)
    path = sr_sample.main(SR + ["--model_dir", logdir, "--ema_rate", "0.5",
                                "--low_res_npz", str(tmp_path / "low.npz"), "--num_samples", "2",
                                "--batch_size", "2", "--timestep_respacing", "2",
                                "--out_dir", str(tmp_path / "out")])
    assert os.path.basename(path) == "sr_samples_16.npz"
    with np.load(path) as z:
        x = z[z.files[0]]
    assert x.shape == (2, 16, 16, 3) and np.isfinite(x).all()
    with pytest.raises(ValueError, match="labels"):
        sr_train.main(SR + ["--class_cond", "true", "--logdir", logdir])


@pytest.mark.parametrize("flags", [
    ["--cond_type", ""], ["--cond_type", "concat"], ["--cond_type", "AdaGN"],
    ["--cond_type", "cross_attention"], ["--use_3d_aware", "true"],
    ["--cond_type", "cross_attention", "--use_3d_aware", "true", "--use_checkpoint", "true"],
], ids=["none", "concat", "AdaGN", "cross_attention", "controlnet_3d", "xattn_3d_remat"])
def test_diff_train_new_modes(tmp_path, flags):
    state = diff_train.main(MODEL + ["--device", "cpu", "--batch_size", "2", "--total_steps", "2",
                                     "--log_interval", "1", "--logdir", str(tmp_path), *flags])
    assert state.step == 2 and torch.isfinite(state.params).all()
    with open(tmp_path / "progress.json") as f:
        assert sum(1 for _ in f) == 2


def test_diff_train_use_checkpoint_gives_the_same_step(tmp_path):
    """The same seed, data and noise train to the same parameters bit for bit
    with and without activation checkpointing."""
    states = [diff_train.main(MODEL + ["--device", "cpu", "--batch_size", "2", "--microbatch", "1",
                                       "--total_steps", "2", "--log_interval", "2",
                                       "--skip_final_save", "true", "--use_checkpoint", flag,
                                       "--logdir", str(tmp_path / flag)])
              for flag in ("false", "true")]
    assert torch.equal(states[0].params, states[1].params)


def _args(**kw):
    base = dict(auto_plan=False, num_samples=9, batch_size=2, parallel_window=0)
    return argparse.Namespace(**{**base, **kw})


def test_chain_batches():
    assert diff_sample.chain_batches(_args()) == [2] * 5
    for n in (1, 9, 25):
        assert diff_sample.chain_batches(_args(auto_plan=True, num_samples=n)) == plan_workload(n)


def test_diff_sample_auto_plan_keeps_num_samples_rows(tmp_path, monkeypatch, capsys):
    npz = _model_npz(tmp_path / "m.npz")
    batches = []
    real = diff_sample.generate_all_layers

    def spy(*args, **kwargs):
        batches.append(kwargs["batch_size"])
        return real(*args, **kwargs)

    monkeypatch.setattr(diff_sample, "generate_all_layers", spy)
    out = tmp_path / "out"
    diff_sample.main(["--model_npz", npz, "--device", "cpu", *MODEL, "--timestep_respacing", "ddim2",
                      "--use_ddim", "true", "--all_layers", "--auto_plan", "true",
                      "--num_samples", "9", "--batch_size", "3", "--out_dir", str(out)])
    assert batches == plan_workload(9) == [8, 1]
    assert "[plan] mixed-batch plan for 9: [8, 1]" in capsys.readouterr().out
    for name in ("person", "person_pant", "person_pant_shirt", "person_pant_shirt_shoes"):
        with np.load(out / f"samples_{name}.npz") as z:
            assert z[z.files[0]].shape == (9, 16, 16, 27)


def test_dispatcher_commands_and_exit_codes(tmp_path, capsys):
    assert list(dispatcher.COMMANDS) == list(JAX_COMMANDS)
    for cmd, mod in dispatcher.COMMANDS.items():
        assert mod == JAX_COMMANDS[cmd].replace("humanliff_tpu.", "humanliff_tpu_torch.")
        assert os.path.exists(os.path.join(REPO, mod.replace(".", os.sep) + ".py")), mod
    assert dispatcher.main([]) == 1
    assert dispatcher.main(["no-such-command"]) == 1
    assert dispatcher.main(["--help"]) == 0
    assert "image-sample" in capsys.readouterr().out
    npz = _model_npz(tmp_path / "m.npz")
    assert dispatcher.main(["image-sample", "--model_npz", npz, "--device", "cpu", *MODEL,
                            "--timestep_respacing", "2", "--num_samples", "1",
                            "--out_dir", str(tmp_path / "out")]) == 0
    assert os.path.exists(tmp_path / "out" / "samples_1x16x16x27.npz")


def test_family_entry_points_need_cuda_by_default(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    npz = _model_npz(tmp_path / "m.npz")
    for fn, argv in [(image_sample.main, ["--model_npz", npz]),
                     (image_nll.main, ["--model_npz", npz]),
                     (sr_train.main, ["--logdir", str(tmp_path / "sr")]),
                     (sr_sample.main, ["--model_dir", str(tmp_path)])]:
        with pytest.raises(RuntimeError, match="CUDA"):
            fn(argv)
