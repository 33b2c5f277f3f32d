"""The port's multi-rank training and sampling (``parallel/``, ``train/stage2.py``,
``train/stage1.py``, ``train/stage1_ft.py``, ``sampling/layered.py``,
``sampling/parallel.py`` and the ``diff_train`` CLI under a mesh) on Gloo
ranks of the CPU (``tests/torch_dist_util.py``), against one process of the
port and, for the sampling, against the JAX package's mesh functions on its
8-device CPU mesh. Inputs come from numpy seeds.

Bars:
- Stage 2 step, replicated and ZeRO-1: loss rtol 1e-5, params atol 2e-6
  (JAX's, tests/test_parallel.py:132-200); the gathered moments and EMAs
  atol 1e-9 and 2e-8 (they move by (1 - rate) x params); the loss-aware
  sampler's state after 2 steps: atol 1e-7.
- A ZeRO checkpoint written at 2 ranks and resumed at 1 and at 2: params
  after the resumed step within 2e-6 of 3 uninterrupted steps.
- Stage 1 with the table sharded by instance: loss rtol 1e-5, planes atol
  1e-5 (JAX's), decoder atol 1e-6, at 2 and 4 ranks, with a repeated slice
  and instances outside a batch.
- The batched fine-tune with a mesh against the one-process batched
  fine-tune: atol 2e-5. Not against the serial fine-tune element by
  element: the batched loss is the serial one over N, and Adam's eps moves
  texels whose gradient is near 1e-8 (the L1 term's share of an unlit
  texel) by other amounts, up to 0.37 after 8 steps at lr 0.1 in this case;
  tests/test_torch_recon_cli.py holds batched against serial by the loss.
- ``generate_layer_sharded`` against JAX's with JAX's noise injected: atol
  2e-5 (one layer); ``generate_all_layers(mesh=)`` against one process:
  atol 1e-4 (four chained layers, each conditioned on the last, of a UNet
  run at batch 2 a rank against batch 4: 2.1e-5 measured).
- The Picard window split over 2 ranks at tol 0: one model call a step, and
  within atol 1e-5 of the one-process window and 1e-4 of JAX's window on
  its 8-device mesh (8 chained steps of a UNet whose single window step
  agrees to 1e-5, tests/test_torch_parallel_sampling.py).
"""

import os

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

import torch_dist_cases as cases
import torch_port_util  # noqa: F401  (one torch thread)
from torch_dist_util import run_ranks
from torch_port_util import random_variables
from humanliff_tpu.diffusion.respace import create_diffusion as jax_create_diffusion
from humanliff_tpu.models.unet import UNetModel as JaxUNet
from humanliff_tpu.parallel import make_mesh as jax_make_mesh
from humanliff_tpu.sampling import layered as jax_layered
from humanliff_tpu.sampling import parallel as jax_parallel
from humanliff_tpu_torch.cli import diff_train
from humanliff_tpu_torch.compat.from_jax import unet_state_dict
from humanliff_tpu_torch.parallel.mesh import DataMesh, instance_range, zero_ranges
from humanliff_tpu_torch.sampling.layered import generate_layer_sharded
from humanliff_tpu_torch.sampling.parallel import parallel_p_sample_loop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER_NPZ = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
JAX_UNET = dict(in_channels=6, model_channels=16, out_channels=6, num_res_blocks=1,
                attention_resolutions=(), channel_mult=(1, 2), num_classes=4, num_heads=2,
                cond_type="controlnet")


def _fake_mesh(size: int) -> DataMesh:
    """Rank 0 of a mesh of ``size`` with no process group: for the checks that
    raise before any collective."""
    return DataMesh(rank=0, size=size, device=torch.device("cpu"))


# ---------------- Stage 2 ----------------


@pytest.mark.parametrize("zero", [False, True], ids=["replicated", "zero"])
def test_stage2_steps_match_one_process(zero, tmp_path):
    want = cases.stage2_steps(distributed=False)
    got = run_ranks("torch_dist_cases:stage2_steps", 2, tmp_path, distributed=True, zero=zero)
    numel = want["numel"]
    for r, out in enumerate(got):
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"], want["grad_norm"], rtol=1e-5)
        np.testing.assert_allclose(out["loss_q"], want["loss_q"], rtol=1e-5)
        np.testing.assert_allclose(out["params"], want["params"], atol=2e-6)
        lo, hi = zero_ranges(numel, 2)[r] if zero else (0, numel)
        assert out["moments_local"] == hi - lo  # ZeRO: this rank's range only
    p, q = got[0]["payload"], want["payload"]
    assert "payload" not in got[1]  # rank 0 alone holds the gathered checkpoint
    np.testing.assert_allclose(p["mu"], q["mu"], atol=1e-9)
    np.testing.assert_allclose(p["nu"], q["nu"], atol=1e-9)
    for rate in q["ema"]:
        np.testing.assert_allclose(p["ema"][rate], q["ema"][rate], atol=2e-8)


def test_loss_second_moment_sampler_state_after_two_steps(tmp_path):
    """The sampler updates from the gathered (t, loss) of the whole batch, so
    each rank keeps the one-process state."""
    want = cases.stage2_steps(distributed=False, sampler="loss-second-moment", B=8)
    got = run_ranks("torch_dist_cases:stage2_steps", 2, tmp_path, distributed=True,
                    zero=True, sampler="loss-second-moment", B=8)
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-5)
    s, w = got[0]["payload"]["sampler"], want["payload"]["sampler"]
    assert set(s) == set(w)
    for k in w:
        np.testing.assert_allclose(s[k], w[k], atol=1e-7, err_msg=k)


def _train_argv(logdir, total, *extra):
    return cases.UNET_FLAGS + ["--device", "cpu", "--batch_size", "4", "--microbatch", "2",
                               "--logdir", str(logdir), "--total_steps", str(total),
                               "--log_interval", "1", "--save_interval", "1000", *extra]


def test_zero_checkpoint_resumes_at_any_world_size(tmp_path):
    """diff_train at 2 ranks with ZeRO writes one-process checkpoints; each
    resumes at 1 rank and at 2, and the step after equals one process's
    run saved and resumed at the same step (a resume restarts the data and
    noise streams; the synthetic batches are the global ones at any world
    size)."""
    diff_train.main(_train_argv(tmp_path / "one", 2))
    straight = diff_train.main(_train_argv(tmp_path / "one", 3, "--skip_final_save", "true"))
    for world in (1, 2):
        logdir = tmp_path / f"w{world}"
        run_ranks("torch_dist_cases:diff_train_cli", 2, tmp_path,
                  argv=_train_argv(logdir, 2, "--zero_shard", "true"))
        assert sorted(os.listdir(logdir / "000002")) == ["COMMITTED", "state.pt"]
        argv = _train_argv(logdir, 3, "--zero_shard", "true", "--skip_final_save", "true")
        if world == 1:
            outs = [cases.diff_train_cli(argv)]
        else:
            outs = run_ranks("torch_dist_cases:diff_train_cli", 2, tmp_path, argv=argv)
        for out in outs:
            assert out["step"] == 3
            np.testing.assert_allclose(out["params"], straight.params.numpy(), atol=2e-6)


def test_diff_train_mesh_capped_to_a_divisor_of_the_batch(tmp_path):
    """3 ranks and a batch of 4: the mesh is the first 2 ranks; rank 2 prints
    that it is outside and leaves, the others train alike."""
    outs = run_ranks("torch_dist_cases:diff_train_cli", 3, tmp_path,
                     argv=_train_argv(tmp_path / "run", 1, "--skip_final_save", "true"))
    assert [o["member"] for o in outs] == [True, True, False]
    np.testing.assert_array_equal(outs[0]["params"], outs[1]["params"])
    layout = run_ranks("torch_dist_cases:mesh_layout", 3, tmp_path, world_batch=4)
    assert [(o["member"], o["size"]) for o in layout] == [(True, 2), (True, 2), (False, 2)]
    assert [o.get("sum") for o in layout] == [2.0, 2.0, None]


# ---------------- Stage 1 ----------------

# Step 1 repeats (2, 1) and leaves instance 3 out; step 2 repeats (3, 0) and
# (0, 1) and leaves instances 1 and 2 out (dense Adam still moves them).
STAGE1_PAIRS = [[(0, 0), (2, 1), (2, 1), (1, 0)], [(3, 0), (3, 0), (0, 1), (0, 1)]]


@pytest.mark.parametrize("world", [2, 4])
def test_stage1_sharded_table_matches_one_process(world, tmp_path):
    want = cases.stage1_steps(distributed=False, steps_pairs=STAGE1_PAIRS)
    got = run_ranks("torch_dist_cases:stage1_steps", world, tmp_path, distributed=True,
                    steps_pairs=STAGE1_PAIRS)
    for out in got:
        assert out["shard"] == 4 // world  # each rank holds N/W instances
        np.testing.assert_allclose(out["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_allclose(out["psnr"], want["psnr"], rtol=1e-5)
    np.testing.assert_allclose(got[0]["planes"], want["planes"], atol=1e-5)
    np.testing.assert_allclose(got[0]["mu"], want["mu"], atol=1e-9)
    np.testing.assert_allclose(got[0]["decoder"], want["decoder"], atol=1e-6)


def test_stage1_table_must_divide_over_the_mesh():
    with pytest.raises(ValueError, match="5 instances do not divide over the 2-rank mesh"):
        instance_range(5, _fake_mesh(2))


def test_batched_finetune_with_mesh_matches_one_process(tmp_path):
    want = cases.finetune_case(distributed=False, out_dir=str(tmp_path / "one"))
    got = run_ranks("torch_dist_cases:finetune_case", 2, tmp_path, distributed=True,
                    out_dir=str(tmp_path / "mesh"))
    for out in got:  # every rank returns all the subjects
        np.testing.assert_allclose(out["planes"], want["planes"], atol=2e-5)
    # Each rank wrote its own subjects' files.
    assert got[0]["written"] == ["s0_000004.npz", "s1_000004.npz", "s2_000004.npz",
                                 "s3_000004.npz"]


def test_stage1_clis_on_two_ranks(tmp_path):
    """recon_train, recon_ft and recon_refit under a 2-rank mesh: the table
    shards (1 of 2 instances a rank), rank 0 writes the one-process
    checkpoint format, one process resumes it, the fine-tune writes each
    rank's subjects, and the refit keeps the exports bit for bit."""
    from humanliff_tpu_torch.cli import recon_train
    from humanliff_tpu_torch.train import checkpoint as ckpt

    base = ["--device", "cpu", "--config", os.path.join(REPO, "configs", "SynBody.txt"),
            "--data_set_type", "synthetic", "--num_instance", "2", "--synthetic_image_size",
            "16", "--synthetic_tight_bounds", "true", "--n_rand", "32", "--n_samples", "8",
            "--n_importance", "8", "--triplane_dim", "16", "--basedir", str(tmp_path),
            "--i_print", "1"]
    train = base + ["--expname", "run", "--n_iteration", "2"]
    outs = run_ranks("torch_dist_cases:cli_case", 2, tmp_path, cli="recon_train", argv=train)
    assert [o["shard"].shape[0] for o in outs] == [1, 1]
    np.testing.assert_array_equal(outs[0]["decoder"], outs[1]["decoder"])
    saved, step = ckpt.restore_state(str(tmp_path / "run"))
    assert step == 2 and tuple(saved["planes"].shape) == (2, 4, 3, 9, 16, 16)
    for r, o in enumerate(outs):  # the gathered table is the ranks' shards
        np.testing.assert_array_equal(saved["planes"][r:r + 1].numpy(), o["shard"])
        np.testing.assert_array_equal(saved["opt_state"]["planes"]["mu"].shape,
                                      (2, 4, 3, 9, 16, 16))
    resumed = recon_train.main(base + ["--expname", "run", "--n_iteration", "3"])
    assert resumed.step == 3 and np.isfinite(resumed.params["planes"].numpy()).all()

    ft = base + ["--expname", "run", "--ft_steps", "1", "--start_idx", "0", "--end_idx", "2",
                 "--subjects_per_batch", "2", "--out_dir", str(tmp_path / "planes")]
    run_ranks("torch_dist_cases:cli_case", 2, tmp_path, cli="recon_ft", argv=ft)
    files = sorted(os.listdir(tmp_path / "planes"))
    assert files == ["subject0000_002000.npz", "subject0001_002000.npz"]

    refit = base + ["--expname", "refit", "--refit_steps", "1", "--plane_files",
                    str(tmp_path / "planes" / "*.npz"), "--decoder_from",
                    str(tmp_path / "run")]
    run_ranks("torch_dist_cases:cli_case", 2, tmp_path, cli="recon_refit", argv=refit)
    saved, step = ckpt.restore_state(str(tmp_path / "refit"))
    assert step == 2000
    for i, f in enumerate(files):
        np.testing.assert_array_equal(saved["planes"][i].numpy(),
                                      ckpt.load_subject_planes(str(tmp_path / "planes" / f)))


def test_diff_sample_on_two_ranks(tmp_path):
    """diff_sample under a 2-rank mesh: one layer generated by rank 0 and
    broadcast (the samples are one process's, bit for bit) and decoded with
    the tiles split over the ranks (exact tier; the PNGs within 1 of one
    process's exact ones); then the 4-layer chain with a Picard window of 2
    split over the ranks (atol 1e-5 of one process's window)."""
    from humanliff_tpu_torch.cli import diff_sample
    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from PIL import Image

    torch.manual_seed(0)
    model, _ = create_model_and_diffusion(**cases.UNET)
    npz = tmp_path / "unet.npz"
    np.savez(npz, **{k: v.numpy() for k, v in model.state_dict().items()})
    flags = cases.UNET_FLAGS + [
        "--device", "cpu", "--model_npz", str(npz), "--num_samples", "2", "--batch_size", "2",
        "--timestep_respacing", "4"]
    decode = ["--layer_idx", "0", "--decode", "--decoder_npz", DECODER_NPZ, "--num_views", "2",
              "--render_size", "24", "--mesh_resolution", "12", "--fast_render", "false"]
    picard = ["--all_layers", "--parallel_window", "2", "--parallel_tol", "0"]
    for kind, extra in (("decode", decode), ("picard", picard)):
        one, two = tmp_path / f"{kind}_one", tmp_path / f"{kind}_two"
        diff_sample.main(flags + extra + ["--out_dir", str(one)])
        run_ranks("torch_dist_cases:cli_case", 2, tmp_path, cli="diff_sample",
                  argv=flags + extra + ["--out_dir", str(two)])
        assert sorted(os.listdir(one)) == sorted(os.listdir(two))
        for f in sorted(os.listdir(one)):
            if f.startswith("samples_"):
                a, b = (np.load(d / f)["arr_0"] for d in (one, two))
                if kind == "decode":
                    np.testing.assert_array_equal(a, b)
                else:
                    np.testing.assert_allclose(a, b, atol=1e-5)
            elif f.endswith(".png"):
                a, b = (np.asarray(Image.open(d / f), int) for d in (one, two))
                assert np.abs(a - b).max() <= 1, f


def test_quality_campaigns_on_two_ranks(tmp_path):
    """quality_eval and quality_stage2 under a 2-rank mesh at tiny dims: the
    training legs run on both ranks (recon_train, recon_ft over 2 subjects,
    diff_train), rank 0 alone evaluates, samples, scores and reports; the
    other rank returns nothing."""
    out = str(tmp_path / "q")
    common = ["--device", "cpu", "--num_instance", "2", "--triplane_dim", "16",
              "--n_samples", "8", "--n_importance", "8", "--out_dir", out]
    evals = run_ranks("torch_dist_cases:cli_case", 2, tmp_path, cli="quality_eval",
                      argv=common + ["--image_size", "20", "--n_rand", "16", "--steps", "2",
                                     "--i_print", "1", "--i_weights", "2"])
    assert evals == [{"returned": "dict"}, {}]
    assert os.path.exists(os.path.join(out, "QUALITY.md"))
    stage2 = run_ranks("torch_dist_cases:cli_case", 2, tmp_path, cli="quality_stage2",
                       argv=common + [
                           "--image_size", "20", "--ft_subjects", "2", "--ft_steps", "2",
                           "--ft_n_rand", "32", "--num_channels", "16", "--num_res_blocks", "1",
                           "--attention_resolutions", "8", "--diff_steps", "2",
                           "--diff_batch_size", "4", "--save_interval", "2", "--num_samples",
                           "1", "--respacing", "2", "--decode_size", "16",
                           "--n_eval_timesteps", "1"])
    assert stage2 == [{"returned": "dict"}, {}]
    work = os.path.join(out, "stage2")
    assert sorted(os.listdir(os.path.join(work, "planes"))) == [
        "campaign0000_000002.npz", "campaign0001_000002.npz", "subject0002_002000.npz",
        "subject0003_002000.npz"]
    report = open(os.path.join(work, "STAGE2.md")).read()
    assert "STATUS: FAILED" not in report and "held-out" in report


# ---------------- sampling ----------------


@pytest.fixture(scope="module")
def tiny_unet():
    """The JAX parallel-sampling tests' ControlNet UNet (6 channels, 8 x 8)
    with seeded variables, and the port's state dict of them."""
    model = JaxUNet(**JAX_UNET)
    x0 = jnp.zeros((1, 8, 8, 6))
    params = random_variables(model, 0, x0, jnp.zeros((1,)), x0, jnp.zeros((1,), jnp.int32))
    sd = unet_state_dict(params, num_res_blocks=1, channel_mult=(1, 2), attention_ds=())
    port_kw = dict(JAX_UNET, num_classes=4)
    return model, params, {k: v.numpy() for k, v in sd.items()}, port_kw


def test_generate_layer_sharded_matches_jax(tiny_unet, tmp_path):
    model, params, sd, kw = tiny_unet
    jdiff = jax_create_diffusion(steps=100, timestep_respacing="5")
    object.__setattr__(jdiff, "channel_axis", -1)
    key = jax.random.key(7)
    shape = (8, 8, 8, 6)
    want = jax_layered.generate_layer_sharded(model, params, jdiff, 1, None, key, 8, 8, 6,
                                              jax_make_mesh(8))
    # The noise JAX's p_sample_loop draws: x_T, then one key per step.
    k_init, k_loop = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, shape))
    steps = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(k_loop, 5)]
    got = run_ranks("torch_dist_cases:generate_layer_case", 2, tmp_path, distributed=True,
                    model_sd=sd, unet_kw=kw, respacing="5", layer=1, shape=shape, x_T=x_T,
                    steps=steps)
    for out in got:  # gathered to every rank
        np.testing.assert_allclose(out, np.asarray(want), atol=2e-5)


def test_generate_all_layers_with_mesh_matches_one_process(tiny_unet, tmp_path):
    _, _, sd, kw = tiny_unet
    args = dict(model_sd=sd, unet_kw=kw, respacing="ddim4", shape=(4, 8, 8, 6), seed=3)
    want = cases.generate_all_case(distributed=False, **args)
    got = run_ranks("torch_dist_cases:generate_all_case", 2, tmp_path, distributed=True,
                    **args)
    for out in got:
        assert list(out) == list(want)
        for name in want:
            np.testing.assert_allclose(out[name], want[name], atol=1e-4, err_msg=name)


def test_picard_window_with_mesh_matches_one_process_and_jax(tiny_unet, tmp_path):
    model, params, sd, kw = tiny_unet
    jdiff = jax_create_diffusion(steps=100, timestep_respacing="8")
    object.__setattr__(jdiff, "channel_axis", -1)
    key = jax.random.key(5)
    shape = (2, 8, 8, 6)
    xc = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    y = np.asarray([1, 2])
    want, calls = jax_parallel.parallel_p_sample_loop(
        jdiff, model, params, shape, key, x_cond=jnp.asarray(xc), y=jnp.asarray(y, jnp.int32),
        window=8, tol=0.0, mesh=jax_make_mesh(8))
    # JAX's draws: x_T from the first split, step t's noise from fold_in(second, t).
    k_init, k_noise = jax.random.split(key)
    x_T = np.asarray(jax.random.normal(k_init, shape))
    noise_at = {t: np.asarray(jax.random.normal(jax.random.fold_in(k_noise, t), shape))
                for t in range(8)}
    args = dict(model_sd=sd, unet_kw=kw, respacing="8", window=8, tol=0.0, x_T=x_T,
                noise_at=noise_at, x_cond=xc, y=y)
    one = cases.picard_case(distributed=False, **args)
    got = run_ranks("torch_dist_cases:picard_case", 2, tmp_path, distributed=True, **args)
    for out in got:
        assert out["calls"] == one["calls"] == 8  # tol 0: one step a model call
        np.testing.assert_allclose(out["samples"], one["samples"], atol=1e-5)
        np.testing.assert_allclose(out["samples"], np.asarray(want), atol=1e-4)


def test_window_and_batch_must_divide_over_the_ranks(tiny_unet):
    _, _, sd, kw = tiny_unet
    model, diffusion = cases._unet(sd, kw, "8")
    with pytest.raises(ValueError, match="window 8 must divide over 3 ranks"):
        parallel_p_sample_loop(diffusion, lambda *a, **k: None, (1, 8, 8, 6), window=8,
                               device="cpu", mesh=_fake_mesh(3))
    with pytest.raises(ValueError, match="batch_size 2 must divide over 3 ranks"):
        generate_layer_sharded(model, diffusion, 0, None, None, 2, 8, 6, _fake_mesh(3),
                               device="cpu")
