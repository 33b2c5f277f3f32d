"""The port's Stage-1 CLIs and the sampling CLI in canonical space (TightCap),
on the CPU, on a fabricated TightCap tree (181 views of 16^2, one pose) with a
toy SMPL model written as a latin1 pickle, and configs/TightCap.txt at one
instance:

- ``recon_train --config configs/TightCap.txt`` (``--use_canonical_space
  true``) for two steps, ``recon_ft`` for two steps a layer, ``recon_test``
  with the inverse-LBS eval;
- ``diff_sample --view_dataset tightcap --decode`` (fp32, fast tier), whose
  PNGs are the JAX package's fast-tier render of the same samples through
  its eval deform within one level of 255, and whose mesh lies in the big
  pose's bounds.
"""

import glob
import json
import os
import pickle

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from humanliff_tpu.bodymodel import canonical as jcan
from humanliff_tpu.bodymodel.smpl import load_body_model as jax_load_body_model
from humanliff_tpu.nerf import fastpath as jfp
from humanliff_tpu.nerf.decoder import NeRFDecoder as JaxDecoder
from humanliff_tpu.nerf.renderer import RenderConfig as JaxConfig
from humanliff_tpu.sampling.layered import planes_image_to_triplane
from humanliff_tpu.train.checkpoint import load_decoder_npz as jax_load_decoder_npz
from humanliff_tpu_torch.bodymodel import smpl
from humanliff_tpu_torch.cli import diff_sample, recon_ft, recon_test, recon_train
from humanliff_tpu_torch.data import view_datasets
from humanliff_tpu_torch.mesh.io import read_ply
from humanliff_tpu_torch.models.factory import create_model_and_diffusion
from humanliff_tpu_torch.train import checkpoint as ckpt

imageio = pytest.importorskip("imageio.v2")
pytest.importorskip("cv2")

from test_torch_datasets import write_tightcap_tree  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODER_NPZ = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
VIEWS = 181  # recon_test's default views reach 180


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("tightcap")
    body = smpl.make_synthetic_body_model(J=4, V=48, n_betas=10)
    model_path = str(root / "SMPL_TOY.pkl")
    with open(model_path, "wb") as f:
        pickle.dump({"v_template": body.v_template, "shapedirs": body.shapedirs,
                     "posedirs": body.posedirs, "J_regressor": body.J_regressor,
                     "weights": body.weights,
                     "kintree_table": np.stack([body.parents, np.arange(4)])}, f, protocol=2)
    subj = write_tightcap_tree(str(root / "data"), body, views=VIEWS, poses=1, size=16)
    # configs/TightCap.txt with one instance: a command-line value equal to
    # the flag's default (1) does not override the config file's 107.
    config = str(root / "TightCap_one.txt")
    with open(os.path.join(REPO, "configs", "TightCap.txt")) as f, open(config, "w") as g:
        g.write(f.read().replace("num_instance = 107", "num_instance = 1"))
    return config, subj, model_path


def _argv(tree, base):
    config, subj, model_path = tree
    return ["--device", "cpu", "--config", config,
            "--data_root", subj, "--smpl_model_path", model_path,
            "--views_num", str(VIEWS), "--n_rand", "32", "--n_samples", "8",
            "--n_importance", "8", "--triplane_dim", "16", "--basedir", base,
            "--expname", "run"]


def test_recon_cli_chain_in_canonical_space(tree, tmp_path):
    argv = _argv(tree, str(tmp_path))
    state = recon_train.main(argv + ["--n_iteration", "2", "--i_print", "1", "--i_weights",
                                     "2"])
    assert state.step == 2 and tuple(state.params["planes"].shape) == (1, 4, 3, 9, 16, 16)
    with open(os.path.join(str(tmp_path), "run", "args.txt")) as f:
        args = dict(line.strip().split(" = ", 1) for line in f)
    assert args["use_canonical_space"] == "True" and args["data_set_type"] == "TightCap"
    logs = [json.loads(line) for line in open(os.path.join(str(tmp_path), "run",
                                                           "progress.json"))]
    assert [m["step"] for m in logs] == [1, 2]
    assert all(np.isfinite(m["loss"]) and m["acc_loss"] >= 0 for m in logs)

    planes_dir = str(tmp_path / "planes")
    recon_ft.main(argv + ["--ft_steps", "2", "--start_idx", "0", "--end_idx", "1",
                          "--out_dir", planes_dir])
    fitted = ckpt.load_subject_planes(os.path.join(planes_dir, "subject0000_002000.npz"))
    assert fitted.shape == (4, 3, 9, 16, 16) and np.abs(fitted).max() <= 1.0

    savedir = str(tmp_path / "test")
    metrics = recon_test.main(argv + ["--triplane_dir", planes_dir, "--start_idx", "0",
                                      "--end_idx", "1", "--savedir", savedir])
    assert sorted(metrics) == [f"subject0_layer{layer}" for layer in range(4)]
    assert all(np.isfinite(m["psnr"]) and 0 <= m["ssim"] <= 1 for m in metrics.values())
    assert len(glob.glob(os.path.join(savedir, "*_pred.png"))) == 4 * 2


def test_recon_train_refuses_canonical_space_without_a_body_model(tmp_path):
    with pytest.raises(ValueError, match="needs a body model"):
        recon_train.main(["--device", "cpu", "--data_set_type", "synthetic",
                          "--use_canonical_space", "true", "--basedir", str(tmp_path),
                          "--n_iteration", "1"])


def test_diff_sample_decodes_tightcap_views(tree, tmp_path):
    _, subj, model_path = tree
    model, _ = create_model_and_diffusion(image_size=16, num_channels=32, num_res_blocks=1,
                                          attention_resolutions="8", num_heads=2)
    torch.manual_seed(0)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn_like(p) * 0.05)
    npz = str(tmp_path / "unet.npz")
    np.savez(npz, **{k: v.numpy() for k, v in model.state_dict().items()})
    out = str(tmp_path / "out")
    diff_sample.main(["--device", "cpu", "--image_size", "16", "--num_channels", "32",
                      "--num_res_blocks", "1", "--attention_resolutions", "8", "--num_heads",
                      "2", "--timestep_respacing", "2", "--model_npz", npz, "--num_samples",
                      "1", "--out_dir", out, "--decode", "--decoder_npz", DECODER_NPZ,
                      "--view_dataset", "tightcap", "--data_root", subj, "--smpl_model_path",
                      model_path, "--num_views", "2", "--render_bf16", "false",
                      "--grid_resolution", "8", "--mesh_resolution", "12"])
    sample = ckpt.load_samples_npz(os.path.join(out, "samples_person.npz"))[0]

    # The JAX package's fast tier on the same planes and views.
    ds = view_datasets.TightCapViewDataset(data_root=subj,
                                           body_model=smpl.load_body_model(model_path),
                                           layer_idx=0, output_views=[145, 146])
    jdeform = jcan.make_eval_deform_fn(jax_load_body_model(model_path))
    dec, params = JaxDecoder(), jax_load_decoder_npz(DECODER_NPZ)
    planes = planes_image_to_triplane(jnp.asarray(sample, jnp.float32))
    cfg = JaxConfig(n_samples=128, n_importance=128, perturb=False, density_noise=False)
    box = ds.t_world_bounds
    grid = jfp.build_density_grid(dec, params, planes, box, resolution=8)
    for v in range(2):
        item = ds.item(v)
        want = jfp.render_image_fast(
            dec, params, planes, grid, item["rays_o"], item["rays_d"], item["near"],
            item["far"], item["ray_mask"], box, cfg, chunk=64, coarse_chunk=64,
            deform_fn=jdeform, deform_args={k: item[k] for k in recon_test.DEFORM_KEYS},
            outputs=("rgb",))["rgb"]
        want = (np.clip(want, 0, 1) * 255).astype(np.uint8).reshape(16, 16, 3)
        got = imageio.imread(os.path.join(out, f"person_s0_v{v:03d}.png"))
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1, v
    verts, tris = read_ply(os.path.join(out, "person_s0.ply"))
    if len(tris):
        assert (verts >= box[0] - 1e-4).all() and (verts <= box[1] + 1e-4).all()


def test_diff_sample_synbody_views_are_the_view_dataset(tmp_path):
    """--view_dataset synbody: SMPL-X models found under --smplx_model_dir by
    gender, the capture's views 145 onward in world space (no deform)."""
    from test_datasets import _toy_body
    from test_torch_datasets import write_synbody_tree

    body = _toy_body(V=40, J=5, smplx=True)
    for g in ("MALE", "FEMALE", "NEUTRAL"):
        np.savez(tmp_path / f"SMPLX_{g}.npz", v_template=body.v_template,
                 shapedirs=np.concatenate([body.shapedirs, np.zeros((40, 3, 290), np.float32),
                                           body.expr_dirs], axis=-1),
                 posedirs=body.posedirs, J_regressor=body.J_regressor, weights=body.weights,
                 kintree_table=np.stack([body.parents, np.arange(5)]))
    subj = write_synbody_tree(str(tmp_path / "data"), body, views=148, poses=1, size=16)
    args = diff_sample.build_parser().parse_args(
        ["--model_npz", "m.npz", "--view_dataset", "synbody", "--data_root", subj,
         "--smplx_model_dir", str(tmp_path), "--num_views", "3", "--image_scaling", "0.5"])
    items, deform_fn = diff_sample._view_items(args, 1)
    assert deform_fn is None and len(items) == 3
    ds = view_datasets.SynBodyViewDataset(
        data_root=subj, layer_idx=1, output_views=[145, 146, 147],
        body_models={g: smpl.load_body_model(str(tmp_path / f"SMPLX_{g.upper()}.npz"))
                     for g in ("male", "female", "neutral")})
    for got, want in zip(items, (ds.item(i) for i in range(3))):
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    assert tuple(items[0]["hw"]) == (8, 8) and int(items[0]["y"]) == 1
