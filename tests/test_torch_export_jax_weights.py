"""scripts/export_jax_weights.py: a JAX stage-2 checkpoint (written as
tests/test_cli_decode.py writes one) becomes an npz that the port's UNet
loads; the port's forward then equals the JAX forward of the weights the JAX
sampling CLI would use (atol 1e-4, fp32), EMA or raw per its burn-in guard.
``--full_state`` and ``--stage1`` carry whole Stage-2 and Stage-1 train
states across, which the port's training CLIs continue."""

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


def test_stage1_state_export_takes_the_same_next_step(tmp_path, monkeypatch, capsys):
    """--stage1: a JAX Stage-1 state after two steps (orbax, as recon_train
    saves it) comes across exactly, the port's next step from it equals
    JAX's next step (tests/test_torch_stage1.py's bars), and
    ``recon_train --resume_npz`` continues it."""
    import torch_stage1_util as U
    from humanliff_tpu.train import stage1 as jstage1
    from humanliff_tpu.train.optim import make_stage1_optimizer as jax_make_stage1_optimizer
    from humanliff_tpu_torch.cli import recon_train
    from humanliff_tpu_torch.compat.from_jax import load_stage1_npz
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer
    from humanliff_tpu_torch.train.stage1 import create_train_state, restore_into, train_step

    jcfg, cfg = U.configs(num_layers=4)
    dec, dvars, dflat = U.decoder_vars(4)
    planes = U.plane_table(4, layers=4)
    ds = U.dataset(num_layers=4)
    batches = [U.item_batch(ds, pairs, seed=i) for i, pairs in
               enumerate([[(0, 0), (1, 3)], [(1, 2), (1, 2)], [(0, 3), (1, 0)]])]
    tx = jax_make_stage1_optimizer(5e-3, 1e-1, 500)
    jp = {"planes": jnp.asarray(planes), "decoder": dvars}
    jstate = jstage1.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=tx.init(jp),
                                tx=tx)
    with U.jax_deterministic(monkeypatch) as fns:
        for b in batches[:2]:
            jstate, _ = fns.step(jstate, U.to_jax(b), jax.random.key(0), dec, jcfg)
        ckpt.save_state(str(tmp_path / "jax"), 2, jstate)
        out = export_jax_weights.main(["--model_dir", str(tmp_path / "jax"), "--stage1",
                                       "--out", str(tmp_path / "s1.npz")])
        carried = load_stage1_npz(out)
        assert carried["step"] == 2
        np.testing.assert_array_equal(carried["planes"].numpy(), np.asarray(jstate.params["planes"]))
        np.testing.assert_array_equal(carried["decoder"].numpy(),
                                      U.decoder_flat(jstate.params["decoder"]))
        inner = jstate.opt_state.inner_states
        padam, dadam = inner["planes"].inner_state[0], inner["decoder"].inner_state[0]
        np.testing.assert_array_equal(carried["opt_state"]["planes"]["mu"].numpy(),
                                      np.asarray(padam.mu["planes"]))
        np.testing.assert_array_equal(carried["opt_state"]["decoder"]["nu"].numpy(),
                                      U.decoder_flat(dadam.nu["decoder"]))
        assert carried["opt_state"]["planes"]["count"] == carried["opt_state"]["decoder"]["count"] == 2

        state = create_train_state({"planes": torch.zeros(planes.shape),
                                    "decoder": torch.zeros_like(dflat)},
                                   make_stage1_optimizer(5e-3, 1e-1, 500))
        restore_into(state, carried)
        _, g = fns.loss_and_grad(jstate.params, U.to_jax(batches[2]), dec, jcfg,
                                 jax.random.key(0))
        jnext, jaux = fns.step(jstate, U.to_jax(batches[2]), jax.random.key(0), dec, jcfg)
    aux = train_step(state, U.to_torch(batches[2]), cfg)
    assert state.step == 3
    np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), rtol=1e-5)
    U.near_zero_rule(state.params["planes"].numpy(), np.asarray(jnext.params["planes"]), 0.1, 1,
                     "planes", np.abs(np.asarray(g["planes"])) < U.NEAR_ZERO_GRAD)
    U.near_zero_rule(state.params["decoder"].numpy(), U.decoder_flat(jnext.params["decoder"]),
                     5e-3, 1, "decoder", np.abs(U.decoder_flat(g["decoder"])) < U.NEAR_ZERO_GRAD)

    argv = ["--device", "cpu", "--data_set_type", "synthetic", "--num_instance", "2",
            "--synthetic_image_size", "24", "--synthetic_tight_bounds", "true", "--n_rand", "48",
            "--n_samples", "8", "--n_importance", "8", "--triplane_dim", "16",
            "--basedir", str(tmp_path), "--expname", "port", "--n_iteration", "3",
            "--i_print", "1", "--resume_npz", out]
    resumed = recon_train.main(argv)
    assert f"resumed the JAX state of {out} at step 2" in capsys.readouterr().out
    assert resumed.step == 3 and resumed.opt_state["planes"]["count"] == 3


def test_committed_stage1_state_exports(tmp_path):
    """The campaign's orbax Stage-1 state (runs/quality/train/005000: 2
    instances at D 256) restores in this environment and comes across."""
    from humanliff_tpu.train import checkpoint as jckpt
    from humanliff_tpu_torch.compat.from_jax import decoder_state_dict, load_stage1_npz
    from humanliff_tpu_torch.nerf.decoder import FlatDecoder

    model_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                             "runs", "quality", "train")
    out = export_jax_weights.main(["--model_dir", model_dir, "--model_step", "5000", "--stage1",
                                   "--out", str(tmp_path / "s1.npz")])
    carried = load_stage1_npz(out)
    assert carried["step"] == 5000
    assert tuple(carried["planes"].shape) == (2, 4, 3, 9, 256, 256)
    assert carried["opt_state"]["planes"]["count"] == carried["opt_state"]["decoder"]["count"] == 5000
    restored, _ = jckpt.restore_state(model_dir, step=5000)
    want = decoder_state_dict(jax.device_get(restored["params"]["decoder"]))
    got = FlatDecoder(carried["decoder"]).state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert float(carried["planes"].abs().max()) <= 1.0
