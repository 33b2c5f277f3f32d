"""The port's Stage-1 entry points on the CPU at tiny dims: ``recon_train`` ->
``recon_ft`` -> ``recon_test`` with ``--config configs/SynBody.txt``, the
decoder sidecar, resume, the fine-tune, ``eval/harness.py::evaluate_views``
and ``nerf/renderer.py::render_rays_batch`` against the JAX package.

Bars: the batched render against JAX's (deterministic, plain decoder) max
abs 2e-5 on rgb and acc and 1e-4 on depth in fp32 (measured 6.7e-5 on one
ray's depth: its weights put the fine samples a little apart), and PSNR >=
45 dB with fp32 and bf16 planes (the bar of tests/test_torch_renderer.py); ``evaluate_views`` per view PSNR within 0.01
dB and SSIM within 1e-4 of the JAX harness; the fine-tuned planes' image
loss within 2 % of JAX's (the bar JAX's own batched-vs-serial test sets);
resume and the frozen decoder bit for bit.
"""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_stage1_util as U
from torch_port_util import psnr
from humanliff_tpu.eval import harness as jharness
from humanliff_tpu.nerf import renderer as jrender
from humanliff_tpu.train import checkpoint as jckpt
from humanliff_tpu.train import stage1_ft as jstage1_ft
from humanliff_tpu_torch.cli import recon_ft, recon_test, recon_train
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.data.triplane_data import TriplaneDataset, pack_subject_planes
from humanliff_tpu_torch.eval.harness import evaluate_views
from humanliff_tpu_torch.nerf.decoder import FlatDecoder, NeRFDecoder
from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_rays_batch
from humanliff_tpu_torch.train import checkpoint as ckpt
from humanliff_tpu_torch.train.optim import make_stage1_optimizer
from humanliff_tpu_torch.train.stage1 import (
    create_train_state,
    init_params,
    restore_into,
    state_payload,
    train_step,
)
from humanliff_tpu_torch.train.stage1_ft import (
    FinetuneConfig,
    finetune_subject,
    finetune_subjects_batched,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--device", "cpu", "--config", os.path.join(REPO, "configs", "SynBody.txt"),
        "--data_set_type", "synthetic", "--num_instance", "2", "--synthetic_image_size", "16",
        "--synthetic_tight_bounds", "true", "--n_rand", "32", "--n_samples", "8",
        "--n_importance", "8", "--triplane_dim", "16"]


def _train_argv(base, steps):
    return TINY + ["--basedir", base, "--expname", "run", "--n_iteration", str(steps),
                   "--i_print", "1", "--i_weights", "2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    base = str(tmp_path_factory.mktemp("recon"))
    state = recon_train.main(_train_argv(base, 2))
    return base, state


def test_recon_train_with_the_synbody_config(trained):
    base, state = trained
    expdir = os.path.join(base, "run")
    assert state.step == 2
    # The config's widths, the command line's overrides.
    assert tuple(state.params["planes"].shape) == (2, 4, 3, 9, 16, 16)
    with open(os.path.join(expdir, "args.txt")) as f:
        args = dict(line.strip().split(" = ", 1) for line in f)
    assert args["views_num"] == "185" and args["num_instance"] == "2"
    assert ckpt.latest_step(expdir) == 2
    logs = [json.loads(line) for line in open(os.path.join(expdir, "progress.json"))]
    assert [m["step"] for m in logs] == [1, 2]
    assert all(np.isfinite(m[k]) for m in logs for k in ("loss", "psnr", "loader_wait_per_iter"))


def test_decoder_sidecar_reads_in_both_packages(trained):
    base, state = trained
    path = os.path.join(base, "run", "decoder_000002.npz")
    want = FlatDecoder(state.params["decoder"]).state_dict()
    ours = decoder_state_dict(ckpt.load_decoder_npz(path))
    theirs = decoder_state_dict(jckpt.load_decoder_npz(path))
    for name, v in want.items():
        assert torch.equal(ours[name], v) and torch.equal(theirs[name], v), name
    with np.load(path) as z:
        assert int(z["__global_step__"]) == 2
    # The JAX decoder with the sidecar's variables computes the port's decoder.
    jax_decoder = U.JaxDecoder()
    x = np.random.default_rng(0).normal(size=(64, 27)).astype(np.float32)
    d = np.random.default_rng(1).normal(size=(64, 3)).astype(np.float32)
    jrgb, jalpha = jax_decoder.apply(jckpt.load_decoder_npz(path), jnp.asarray(x), jnp.asarray(d))
    port = NeRFDecoder()
    port.load_state_dict(ours)
    with torch.no_grad():
        rgb, alpha = port(torch.from_numpy(x), torch.from_numpy(d))
    np.testing.assert_allclose(rgb.numpy(), np.asarray(jrgb), atol=1e-5)
    np.testing.assert_allclose(alpha.numpy(), np.asarray(jalpha), atol=1e-5)


def test_recon_ft_then_recon_test(trained, tmp_path):
    base, state = trained
    ft_argv = TINY + ["--basedir", base, "--expname", "run", "--ft_steps", "2"]
    recon_ft.main(ft_argv + ["--out_dir", str(tmp_path / "serial")])
    recon_ft.main(ft_argv + ["--out_dir", str(tmp_path / "batched"), "--subjects_per_batch", "2"])
    for out in ("serial", "batched"):
        paths = sorted(glob.glob(str(tmp_path / out / "subject*_002000.npz")))
        assert [os.path.basename(p) for p in paths] == ["subject0000_002000.npz",
                                                        "subject0001_002000.npz"]
        packed = pack_subject_planes(paths, str(tmp_path / f"{out}.npy"))
        assert packed.shape == (2, 4, 27, 16, 16) and np.isfinite(packed).all()
        item = TriplaneDataset(str(tmp_path / f"{out}.npy")).item(5)
        assert item["x"].shape == (16, 16, 27) and int(item["y"]) == 1
    # The fine-tune starts from instance 0 of the shared table: one layer fit
    # moved it, and every layer stays within the clamp.
    fitted = ckpt.load_subject_planes(paths[0])
    assert np.abs(fitted).max() <= 1.0
    assert np.abs(fitted[0] - state.params["planes"][0, 0].numpy()).max() > 1e-3

    savedir = str(tmp_path / "eval")
    metrics = recon_test.main(TINY + ["--basedir", base, "--expname", "run", "--triplane_dir",
                                      str(tmp_path / "serial"), "--savedir", savedir])
    assert sorted(metrics) == sorted(f"subject{s}_layer{l}" for s in range(2) for l in range(4))
    assert all(np.isfinite(m["psnr"]) and 0 <= m["ssim"] <= 1 for m in metrics.values())
    with open(os.path.join(savedir, "metrics.json")) as f:
        assert json.load(f) == metrics
    assert os.path.exists(os.path.join(savedir, "metrics.npy"))
    assert len(glob.glob(os.path.join(savedir, "*_pred.png"))) == 2 * 4 * 2


def test_resume_continues_bit_for_bit(tmp_path, monkeypatch):
    """The CLI restores exactly what it saved, and a restored state's next
    step equals the uninterrupted state's on the same batch and generator."""
    base = str(tmp_path)
    recon_train.main(_train_argv(base, 2))
    saved, _ = ckpt.restore_state(os.path.join(base, "run"), step=2)
    restored = []
    real = recon_train.restore_into

    def checked(state, payload):
        real(state, payload)
        same = all(torch.equal(state.params[n], saved[n]) for n in ("planes", "decoder"))
        for g in ("planes", "decoder"):
            for m in ("mu", "nu"):
                same &= torch.equal(state.opt_state[g][m], saved["opt_state"][g][m])
            same &= state.opt_state[g]["count"] == saved["opt_state"][g]["count"] == 2
        restored.append(same and state.step == 2)

    monkeypatch.setattr(recon_train, "restore_into", checked)
    assert recon_train.main(_train_argv(base, 3)).step == 3
    assert restored == [True]

    _, cfg = U.configs()
    ds = U.dataset()
    batches = [U.to_torch(U.item_batch(ds, [(0, 0), (1, 1)], seed=s)) for s in range(3)]
    tx = make_stage1_optimizer()
    a = create_train_state(init_params(cfg, seed=1), tx)
    gen = torch.Generator().manual_seed(9)
    for b in batches[:2]:
        train_step(a, b, cfg, gen)
    ckpt.save_state(str(tmp_path / "lib"), a.step, state_payload(a))
    b_state = create_train_state(init_params(cfg, seed=2), tx)
    restore_into(b_state, ckpt.restore_state(str(tmp_path / "lib"))[0])
    gen_b = torch.Generator().manual_seed(0)
    gen_b.set_state(gen.get_state())
    ma, mb = train_step(a, batches[2], cfg, gen), train_step(b_state, batches[2], cfg, gen_b)
    assert all(torch.equal(ma[k], mb[k]) for k in ma)
    for n in ("planes", "decoder"):
        assert torch.equal(a.params[n], b_state.params[n])
        assert torch.equal(a.opt_state[n]["mu"], b_state.opt_state[n]["mu"])


def test_finetune_matches_jax_and_keeps_the_decoder(monkeypatch, tmp_path):
    """The port's fine-tune and the JAX package's on the same fixed batches
    (deterministic render): each layer's fitted planes reach the same image
    loss on its batch within 2 %, both descend, the decoder does not move,
    and the batched fine-tune matches the serial one as closely."""
    jcfg, cfg = U.configs()
    dec, dvars, dflat = U.decoder_vars(3)
    shared = U.plane_table(3)
    ds = U.dataset()
    batches = {layer: U.item_batch(ds, [(0, layer), (0, layer)], seed=layer) for layer in (0, 1)}
    for b in batches.values():
        b["instance_idx"][:] = 0
    ft = FinetuneConfig(steps_per_layer=6)
    frozen = dflat.clone()
    with U.jax_deterministic(monkeypatch) as fns:
        monkeypatch.setattr(jstage1_ft, "train_step", fns.step)
        jplanes = jstage1_ft.finetune_subject(
            dec, {"planes": shared, "decoder": dvars}, lambda layer, k: U.to_jax(batches[layer]),
            jcfg, jstage1_ft.FinetuneConfig(steps_per_layer=6), str(tmp_path / "jax"), "s0",
            jax.random.key(0), log_every=0)

        def loss(planes_sl, batch):
            b = dict(batch)
            b["layer_idx"] = np.zeros_like(b["layer_idx"])
            one = dataclasses.replace(jcfg, num_instances=1, num_layers=1, tv_loss_coef=0.0,
                                      l1_loss_coef=0.0)
            (_, aux), _ = fns.loss_and_grad({"planes": jnp.asarray(planes_sl)[None, None],
                                              "decoder": dvars}, U.to_jax(b), dec, one,
                                             jax.random.key(0))
            return float(aux["img_loss"])

        params = {"planes": torch.from_numpy(shared), "decoder": dflat}
        ours = finetune_subject(params, lambda layer: U.to_torch(batches[layer]), cfg, ft,
                                str(tmp_path / "port"), "s0", log_every=0)
        both = finetune_subjects_batched(
            params, lambda pos, layer: U.to_torch(batches[layer]), cfg, ft,
            str(tmp_path / "port_b"), ["a", "b"], log_every=0)
        assert torch.equal(dflat, frozen)
        for layer in (0, 1):
            l_jax, l_port = loss(jplanes[layer], batches[layer]), loss(ours[layer], batches[layer])
            l_init = loss(shared[0, layer], batches[layer])
            assert l_port < 0.95 * l_init and l_jax < 0.95 * l_init, (layer, l_port, l_init)
            assert abs(l_port - l_jax) <= 0.02 * l_jax, (layer, l_port, l_jax)
            for i in range(2):
                l_b = loss(both[i, layer], batches[layer])
                assert abs(l_b - l_port) <= 0.02 * l_port, (layer, i, l_b, l_port)
    np.testing.assert_array_equal(
        ckpt.load_subject_planes(str(tmp_path / "port" / "s0_002000.npz")), ours)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_render_rays_batch_matches_jax(dtype):
    _, dvars, dflat = U.decoder_vars(1)
    planes = U.plane_table(1)[:, 0]  # (2, 3, 9, D, D)
    b = U.item_batch(U.dataset(), [(0, 0), (1, 0)], seed=4)
    cfg = jrender.RenderConfig(**U.RENDER)
    ref = jrender.render_rays_batch(
        U.JaxDecoder(), dvars, jnp.asarray(planes).astype(getattr(jnp, dtype)),
        *(jnp.asarray(b[k]) for k in ("rays_o", "rays_d", "near", "far", "box_warp")), cfg)
    with torch.no_grad():
        out = render_rays_batch(
            FlatDecoder(dflat), torch.from_numpy(planes).to(getattr(torch, dtype)),
            *(torch.from_numpy(b[k]) for k in ("rays_o", "rays_d", "near", "far", "box_warp")),
            RenderConfig(**U.RENDER))
    assert float(np.asarray(ref["rgb"]).std()) > 0.01 and float(np.asarray(ref["depth"]).std()) > 0.01
    for k in ("rgb", "acc", "depth"):
        assert out[k].shape == ref[k].shape, k
        if dtype == "float32":
            atol = 1e-4 if k == "depth" else 2e-5
            np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]), atol=atol, err_msg=k)
        assert psnr(out[k].float().numpy(), np.asarray(ref[k], np.float32)) >= 45.0, k


@pytest.mark.parametrize("fast", [False, True])
def test_evaluate_views_matches_jax_harness(fast, tmp_path):
    _, dvars, dflat = U.decoder_vars(2)
    planes = U.plane_table(2)[0, 1]
    jds = U.JaxSynthetic(num_instances=1, n_rays=16, image_size=20, tight_bounds=True)
    items = [jds.test_item(0, 1, v, n_gt_samples=32) for v in (150, 170)]
    cfg = dict(n_samples=8, n_importance=8, perturb=False, density_noise=False)
    theirs = jharness.evaluate_views(U.JaxDecoder(), dvars, jnp.asarray(planes), items,
                                     jrender.RenderConfig(**cfg), fast=fast, grid_resolution=16)
    port = NeRFDecoder()
    port.load_state_dict(FlatDecoder(dflat).state_dict())
    savedir = str(tmp_path / "eval")
    ours = evaluate_views(port, torch.from_numpy(planes), items, RenderConfig(**cfg),
                          savedir=savedir, tag="s0000_l1", fast=fast, grid_resolution=16)
    assert abs(ours["psnr"] - theirs["psnr"]) <= 0.01
    assert abs(ours["ssim"] - theirs["ssim"]) <= 1e-4
    assert "lpips" not in ours
    with open(os.path.join(savedir, "metrics_s0000_l1.json")) as f:
        rows = json.load(f)["per_view"]
    assert len(rows) == 2 and len(glob.glob(os.path.join(savedir, "*.png"))) == 4


def test_unported_datasets_and_missing_cuda_raise(tmp_path):
    """SynBody without its SMPL-X model files raises (they are not in the
    repository; tests/test_torch_datasets.py runs the loaders on toy models),
    as does --device cuda without CUDA."""
    argv = ["--basedir", str(tmp_path), "--n_iteration", "1"]
    with pytest.raises(FileNotFoundError, match="SMPLX_"):
        recon_train.main(argv + ["--device", "cpu", "--data_set_type", "SynBody",
                                 "--smplx_model_dir", str(tmp_path)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            recon_train.main(argv + ["--data_set_type", "synthetic"])

