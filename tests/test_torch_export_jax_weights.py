"""scripts/export_jax_weights.py: a JAX stage-2 checkpoint (written as
tests/test_cli_decode.py writes one) becomes an npz that the port's UNet
loads; the port's forward then equals the JAX forward of the weights the JAX
sampling CLI would use (atol 1e-4, fp32), EMA or raw per its burn-in guard."""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from humanliff_tpu.models.factory import create_model as jax_create_model
from humanliff_tpu.train import checkpoint as ckpt
from humanliff_tpu.train.stage2 import Stage2Config, create_stage2_state
from humanliff_tpu_torch.compat.from_jax import load_unet_npz
from humanliff_tpu_torch.models.factory import create_model

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                                "scripts"))
import export_jax_weights  # noqa: E402

CFG = dict(image_size=16, in_channels=9, num_channels=16, out_channels=9, num_res_blocks=1,
           learn_sigma=False, class_cond=True, attention_resolutions="8", num_heads=2,
           num_heads_upsample=-1, use_scale_shift_norm=True, cond_type="controlnet",
           dropout=0.0)


@pytest.mark.parametrize("rate,step,picks", [("0.9999", 1, "params"), ("0.5", 40, "ema")])
def test_export_picks_the_sampling_weights(tmp_path, rate, step, picks):
    jmodel = jax_create_model(use_3d_aware=False, **CFG)
    x0 = jnp.zeros((1, 16, 16, 9))
    params = jmodel.init(jax.random.key(0), x0, jnp.zeros((1,)), x0, jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(1)
    params = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * 0.1, jnp.float32),
                          params)
    ema = jax.tree.map(lambda p: p * 0.5, params)
    s2 = create_stage2_state(params, Stage2Config(ema_rates=(float(rate),)), 10)
    s2 = s2.replace(ema_params={rate: ema})
    ckpt.save_state(str(tmp_path / "model"), step, s2)

    out = export_jax_weights.main(["--model_dir", str(tmp_path / "model"), "--ema_rate", rate,
                                   "--out", str(tmp_path / "unet.npz")])
    want = params if picks == "params" else ema
    port = create_model(**CFG).eval()
    port.load_state_dict(load_unet_npz(out, num_res_blocks=1, channel_mult=(1, 2),
                                       attention_ds=(2,)), strict=True)
    x = rng.uniform(-1, 1, (2, 16, 16, 9)).astype(np.float32)
    xc = rng.uniform(-1, 1, (2, 16, 16, 9)).astype(np.float32)
    t = np.asarray([10.0, 500.0], np.float32)
    y = np.asarray([1, 3], np.int32)
    ref = jmodel.apply(want, jnp.asarray(x), jnp.asarray(t), jnp.asarray(xc), jnp.asarray(y))
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(t),
                   torch.from_numpy(xc).permute(0, 3, 1, 2), torch.from_numpy(y).long())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-4)


def test_full_state_export_resumes_in_the_port(tmp_path, capsys):
    """--full_state: a JAX stage-2 state with Adam moments, count, two EMAs and
    the loss-aware sampler's state comes across exactly, and the port's
    training CLI continues it (--resume_npz) for one more step."""
    from humanliff_tpu.train.optim import make_stage2_optimizer
    from humanliff_tpu_torch.cli import diff_train
    from humanliff_tpu_torch.compat.from_jax import load_stage2_npz, unet_state_dict

    jmodel = jax_create_model(use_3d_aware=False, **CFG)
    x0 = jnp.zeros((1, 16, 16, 9))
    params = jmodel.init(jax.random.key(0), x0, jnp.zeros((1,)), x0, jnp.zeros((1,), jnp.int32))
    rng = np.random.default_rng(2)
    cfg = Stage2Config(ema_rates=(0.5, 0.9999), schedule_sampler="loss-second-moment",
                       lr_anneal_steps=100)
    s2 = create_stage2_state(params, cfg, 1000)
    tx = make_stage2_optimizer(cfg.lr, cfg.weight_decay, cfg.lr_anneal_steps)
    opt = s2.opt_state
    for _ in range(2):
        grads = jax.tree.map(lambda p: jnp.asarray(rng.normal(size=p.shape) * 1e-3, jnp.float32),
                             params)
        _, opt = tx.update(grads, opt, params)
    ema = {r: jax.tree.map(lambda p: p * float(r), params) for r in ("0.5", "0.9999")}
    sampler = {"history": jnp.asarray(rng.uniform(size=(1000, 10)), jnp.float32),
               "counts": jnp.asarray(rng.integers(0, 11, 1000), jnp.int32)}
    s2 = s2.replace(step=jnp.asarray(2, jnp.int32), opt_state=opt, ema_params=ema,
                    sampler_state=sampler)
    ckpt.save_state(str(tmp_path / "model"), 2, s2)
    out = export_jax_weights.main(["--model_dir", str(tmp_path / "model"), "--full_state",
                                   "--out", str(tmp_path / "state.npz")])

    layout = dict(num_res_blocks=1, channel_mult=(1, 2), attention_ds=(2,))
    carried = load_stage2_npz(out, **layout)
    adam = opt[-1][0]
    assert carried["step"] == 2 and carried["opt_state"]["count"] == 2 == int(adam.count)
    for got, want in [(carried["params"], params), (carried["opt_state"]["mu"], adam.mu),
                      (carried["opt_state"]["nu"], adam.nu),
                      *[(carried["ema_params"][r], ema[r]) for r in ema]]:
        want = unet_state_dict(jax.device_get(want), **layout)
        assert set(got) == set(want)
        assert all(torch.equal(got[k], want[k]) for k in want)
    for k in ("history", "counts"):
        np.testing.assert_array_equal(carried["sampler_state"][k].numpy(), np.asarray(sampler[k]))

    flags = ["--image_size", "16", "--in_channels", "9", "--out_channels", "9",
             "--num_channels", "16", "--num_res_blocks", "1", "--attention_resolutions", "8",
             "--num_heads", "2", "--device", "cpu", "--batch_size", "2", "--ema_rate",
             "0.5,0.9999", "--schedule_sampler", "loss-second-moment",
             "--lr_anneal_steps", "100", "--total_steps", "3",
             "--logdir", str(tmp_path / "port"), "--resume_npz", out]
    state = diff_train.main(flags)
    assert f"resumed the JAX state of {out} at step 2" in capsys.readouterr().out
    assert state.step == 3 and state.opt_state["count"] == 3
    start = int(np.asarray(sampler["counts"]).sum())
    assert start < int(state.sampler_state["counts"].sum()) <= start + 2  # full rings stay at 10
