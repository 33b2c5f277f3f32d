"""The rank-side functions of the port's multi-rank tests
(``tests/torch_dist_util.py::run_ranks`` calls them on each Gloo rank; the
tests call them with ``distributed=False`` for the one-process reference).
Torch and the port only: no JAX in the rank processes. Inputs are made from
numpy seeds, so every rank and the reference see the same global data."""

from __future__ import annotations

import numpy as np
import torch

from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import make_mesh

UNET = dict(image_size=16, in_channels=27, num_channels=32, out_channels=27,
            num_res_blocks=1, attention_resolutions="8", num_heads=2)
UNET_FLAGS = ["--image_size", "16", "--num_channels", "32", "--num_res_blocks", "1",
              "--attention_resolutions", "8", "--num_heads", "2"]


def _mesh(distributed: bool):
    return make_mesh(device="cpu") if distributed else None


def _np(t):
    return t.detach().cpu().numpy().copy()


# ---- Stage 2 ----

def stage2_steps(distributed: bool, zero: bool = False, sampler: str = "uniform",
                 steps: int = 2, B: int = 4, microbatch: int = 2, seed: int = 0) -> dict:
    """``steps`` Stage-2 steps of a tiny UNet on a seeded global batch, with
    seeded global t and noise; returns the losses, the params and the full
    checkpoint payload (gathered under ZeRO; on rank 0 only)."""
    from humanliff_tpu_torch.models.factory import create_model_and_diffusion
    from humanliff_tpu_torch.train.stage2 import (
        Stage2Config,
        create_stage2_state,
        state_payload,
        train_step,
    )

    mesh = _mesh(distributed)
    torch.manual_seed(seed)
    model, diffusion = create_model_and_diffusion(**UNET, timestep_respacing="10")
    cfg = Stage2Config(lr=1e-4, ema_rates=(0.999, 0.9), microbatch=microbatch,
                       schedule_sampler=sampler)
    state = create_stage2_state(model, cfg, diffusion.num_timesteps, mesh, zero=zero)
    rng = np.random.default_rng(seed + 3)
    rows = slice(None) if mesh is None else mesh.rows(B)
    out = {"loss": [], "grad_norm": [], "loss_q": []}
    for _ in range(steps):
        x = rng.normal(size=(B, 16, 16, 27)).astype(np.float32)
        xc = rng.normal(size=(B, 16, 16, 27)).astype(np.float32)
        y = rng.integers(0, 4, B)
        batch = {"x": torch.from_numpy(x[rows]), "x_cond": torch.from_numpy(xc[rows]),
                 "y": torch.from_numpy(y[rows])}
        gen = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        m = train_step(state, model, diffusion, cfg, batch, generator=gen, mesh=mesh)
        out["loss"].append(float(m["loss"]))
        out["grad_norm"].append(float(m["grad_norm"]))
        out["loss_q"].append([float(m[f"loss_q{q}"]) for q in range(4)])
    out["params"] = _np(state.params)
    out["moments_local"] = int(state.opt_state["mu"].numel())
    out["numel"] = int(state.params.numel())
    payload = state_payload(state, mesh=mesh)
    if payload is not None:
        out["payload"] = {
            "mu": _np(state.layout.flatten(payload["opt_state"]["mu"], "cpu")),
            "nu": _np(state.layout.flatten(payload["opt_state"]["nu"], "cpu")),
            "ema": {r: _np(state.layout.flatten(e, "cpu"))
                    for r, e in payload["ema_params"].items()},
            "sampler": (None if payload["sampler_state"] is None else
                        {k: _np(v) for k, v in payload["sampler_state"].items()}),
        }
    return out


def diff_train_cli(argv: list) -> dict:
    """``diff_train.main(argv)`` on this rank: whether it stayed in the mesh,
    and its params."""
    from humanliff_tpu_torch.cli import diff_train

    state = diff_train.main(argv)
    if state is None:
        return {"member": False}
    return {"member": True, "params": _np(state.params), "step": state.step,
            "moments_local": int(state.opt_state["mu"].numel())}


def mesh_layout(world_batch: int) -> dict:
    """The capped mesh of ``diff_train`` for a global batch, seen by one rank."""
    from humanliff_tpu_torch.cli.diff_train import _mesh_size

    import torch.distributed as dist

    mesh = make_mesh(_mesh_size(world_batch)(dist.get_world_size()), "cpu")
    out = {"member": mesh.member, "size": mesh.size, "rank": mesh.rank}
    if mesh.member:
        out["sum"] = float(coll.all_reduce_(torch.ones(()), mesh))
    return out


# ---- Stage 1 ----

S1_RENDER = dict(n_samples=8, n_importance=8, perturb=False, density_noise=False)


def s1_table(n: int, layers: int, D: int, seed: int = 0) -> np.ndarray:
    """(n, layers, 3, 9, D, D): noise plus a blob that gives density in the
    box's middle (as tests/torch_stage1_util.py::plane_table)."""
    rng = np.random.default_rng(seed)
    g = (np.arange(D) + 0.5) / D * 2 - 1
    u, v = np.meshgrid(g, g, indexing="xy")
    blob = np.exp(-3.0 * (u ** 2 + v ** 2))
    return (0.3 * rng.normal(size=(n, layers, 3, 9, D, D)) + 0.8 * blob).astype(np.float32)


def s1_batch(ds, pairs, seed: int = 0) -> dict:
    """A stacked batch of one synthetic item per (instance, layer) of ``pairs``."""
    per_inst = ds.num_layers * 64
    items = []
    for j, (inst, layer) in enumerate(pairs):
        idx = inst * per_inst + layer * 64 + (7 * j + seed) % 64
        items.append(ds.item(idx, np.random.default_rng(1000 * seed + j)))
    return {k: torch.from_numpy(np.stack([it[k] for it in items])).long()
            if k in ("instance_idx", "layer_idx")
            else torch.from_numpy(np.ascontiguousarray(np.stack([it[k] for it in items])))
            for k in items[0]}


def stage1_steps(distributed: bool, steps_pairs, n_inst: int = 4, layers: int = 2,
                 D: int = 16, freeze_decoder: bool = False) -> dict:
    """Stage-1 steps with the table sharded by instance over the mesh (or in
    one process), one batch per entry of ``steps_pairs`` (a list of
    (instance, layer) pairs, the global batch); returns the losses, the
    gathered table and decoder, and the size of this rank's shard."""
    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.nerf.decoder import NeRFDecoder, flatten_state_dict
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.parallel.mesh import shard_batch, shard_stage1_params
    from humanliff_tpu_torch.train.optim import make_stage1_optimizer
    from humanliff_tpu_torch.train.stage1 import (
        Stage1Config,
        create_train_state,
        state_payload,
        train_step,
    )

    mesh = _mesh(distributed)
    cfg = Stage1Config(num_instances=n_inst, num_layers=layers, triplane_dim=D,
                       render=RenderConfig(**S1_RENDER), tv_loss_coef=1e-3, l1_loss_coef=1e-3)
    torch.manual_seed(0)
    params = {"planes": torch.from_numpy(s1_table(n_inst, layers, D)),
              "decoder": flatten_state_dict(NeRFDecoder().state_dict())}
    if mesh is not None:
        params = shard_stage1_params(params, mesh)
    tx = make_stage1_optimizer(5e-3, 1e-1, 500, freeze_decoder=freeze_decoder)
    state = create_train_state(params, tx)
    ds = SyntheticLayeredDataset(num_instances=n_inst, num_layers=layers, n_rays=48,
                                 image_size=24, tight_bounds=True)
    out = {"loss": [], "psnr": [], "shard": int(state.params["planes"].shape[0])}
    for i, pairs in enumerate(steps_pairs):
        batch = s1_batch(ds, pairs, seed=i)
        if mesh is not None:
            batch = shard_batch(batch, mesh)
        aux = train_step(state, batch, cfg, mesh=mesh)
        out["loss"].append(float(aux["loss"]))
        out["psnr"].append(float(aux["psnr"]))
    payload = state_payload(state, mesh)
    if payload is not None:
        out["planes"] = _np(payload["planes"])
        out["decoder"] = _np(payload["decoder"])
        out["mu"] = _np(payload["opt_state"]["planes"]["mu"])
    return out


# ---- Decode and sampling ----

def render_views(distributed: bool, decoder_sd: dict, planes: np.ndarray, views: list,
                 render: dict, chunk: int, outputs=("rgb",), canonical_body=None) -> list:
    """``render_views_sharded`` of ``views`` over the mesh, or with
    ``distributed`` False ``render_image_masked`` view by view; numpy outputs.
    ``canonical_body``: (J, V) of the seeded synthetic body, for the eval
    deform with each view's SMPL arrays."""
    from humanliff_tpu_torch.bodymodel.canonical import make_eval_deform_fn
    from humanliff_tpu_torch.bodymodel.smpl import make_synthetic_body_model
    from humanliff_tpu_torch.cli.recon_test import deform_args
    from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
    from humanliff_tpu_torch.nerf.renderer import RenderConfig, render_image_masked
    from humanliff_tpu_torch.nerf.sharded import render_views_sharded

    decoder = NeRFDecoder()
    decoder.load_state_dict({k: torch.from_numpy(v) for k, v in decoder_sd.items()})
    planes_t = torch.from_numpy(np.array(planes))
    cfg = RenderConfig(**render)
    deform_fn = dargs_fn = None
    if canonical_body is not None:
        deform_fn = make_eval_deform_fn(make_synthetic_body_model(*canonical_body))
        dargs_fn = deform_args
    if distributed:
        outs = render_views_sharded(decoder, planes_t, views, cfg, _mesh(True), chunk=chunk,
                                    deform_fn=deform_fn, deform_args_fn=dargs_fn,
                                    outputs=outputs)
    else:
        outs = [render_image_masked(decoder, planes_t, it["rays_o"], it["rays_d"], it["near"],
                                    it["far"], it["ray_mask"], it["box_warp"], cfg, chunk=chunk,
                                    outputs=outputs, deform_fn=deform_fn,
                                    deform_args=None if dargs_fn is None else dargs_fn(it))
                for it in views]
    return [{k: _np(v) for k, v in o.items()} for o in outs]


def _unet(model_sd: dict, unet_kw: dict, respacing: str):
    """A ``UNetModel(**unet_kw)`` holding ``model_sd`` and its diffusion (100
    steps, respaced)."""
    from humanliff_tpu_torch.diffusion.respace import create_diffusion
    from humanliff_tpu_torch.models.unet import UNetModel

    model = UNetModel(**unet_kw)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in model_sd.items()})
    return model.eval(), create_diffusion(steps=100, timestep_respacing=respacing)


def generate_layer_case(distributed: bool, model_sd: dict, unet_kw: dict, respacing: str,
                        layer: int, shape, x_T=None, steps=None, x_cond=None, seed: int = 0,
                        use_ddim: bool = False) -> np.ndarray:
    """One layer of ``shape`` (B, S, S, C) samples, split over the mesh
    (``generate_layer_sharded``) or in one process; the noise injected
    (``x_T``, ``steps``) or drawn from a generator seeded ``seed``."""
    from humanliff_tpu_torch.sampling.layered import generate_layer, generate_layer_sharded

    model, diffusion = _unet(model_sd, unet_kw, respacing)
    B, S, _, C = shape
    kw = dict(noise=None if x_T is None else torch.from_numpy(x_T),
              step_noise=None if steps is None else [torch.from_numpy(s) for s in steps],
              device="cpu", use_ddim=use_ddim)
    xc = None if x_cond is None else torch.from_numpy(x_cond)
    gen = torch.Generator().manual_seed(seed)
    if distributed:
        out = generate_layer_sharded(model, diffusion, layer, xc, gen, B, S, C, _mesh(True),
                                     **kw)
    else:
        out = generate_layer(model, diffusion, layer, xc, gen, B, S, C, **kw)
    return _np(out)


def generate_all_case(distributed: bool, model_sd: dict, unet_kw: dict, respacing: str,
                      shape, seed: int = 0) -> dict:
    """The 4-layer DDIM chain of ``shape`` samples from a generator seeded
    ``seed``, each layer's batch split over the mesh or in one process."""
    from humanliff_tpu_torch.sampling.layered import generate_all_layers

    model, diffusion = _unet(model_sd, unet_kw, respacing)
    B, S, _, C = shape
    out = generate_all_layers(model, diffusion, torch.Generator().manual_seed(seed), B, S, C,
                              device="cpu", use_ddim=True, mesh=_mesh(distributed))
    return {k: _np(v) for k, v in out.items()}


def picard_case(distributed: bool, model_sd: dict, unet_kw: dict, respacing: str,
                window: int, tol: float, x_T: np.ndarray, noise_at: dict, x_cond: np.ndarray,
                y: np.ndarray) -> dict:
    """``parallel_p_sample_loop`` with the window's slots split over the mesh
    (or in one process); ``noise_at[t]`` is timestep t's noise."""
    from humanliff_tpu_torch.sampling.layered import _model_fn
    from humanliff_tpu_torch.sampling.parallel import parallel_p_sample_loop

    model, diffusion = _unet(model_sd, unet_kw, respacing)
    T = diffusion.num_timesteps
    out, calls = parallel_p_sample_loop(
        diffusion, _model_fn(model, False), x_T.shape, x_cond=torch.from_numpy(x_cond),
        y=torch.from_numpy(y), window=window, tol=tol, noise=torch.from_numpy(x_T),
        step_noise=lambda i: torch.from_numpy(noise_at[T - 1 - i]), device="cpu",
        mesh=_mesh(distributed))
    return {"samples": _np(out), "calls": calls}


def finetune_case(distributed: bool, out_dir: str) -> dict:
    """The batched fine-tune of 4 subjects (2 layers, 4 steps a layer, a
    frozen decoder) with the table over the mesh or in one process. The
    batches are a function of (subject, layer)."""
    import os

    from humanliff_tpu_torch.data.synthetic import SyntheticLayeredDataset
    from humanliff_tpu_torch.nerf.decoder import NeRFDecoder, flatten_state_dict
    from humanliff_tpu_torch.nerf.renderer import RenderConfig
    from humanliff_tpu_torch.train.stage1 import Stage1Config
    from humanliff_tpu_torch.train.stage1_ft import FinetuneConfig, finetune_subjects_batched

    torch.manual_seed(0)
    cfg = Stage1Config(num_instances=1, num_layers=2, triplane_dim=16,
                       render=RenderConfig(**S1_RENDER), tv_loss_coef=1e-3, l1_loss_coef=1e-3)
    shared = {"planes": torch.from_numpy(s1_table(1, 2, 16)),
              "decoder": flatten_state_dict(NeRFDecoder().state_dict())}
    ds = SyntheticLayeredDataset(num_instances=4, num_layers=2, n_rays=48, image_size=24,
                                 tight_bounds=True)
    batches = {(i, layer): s1_batch(ds, [(i, layer), (i, layer)], seed=10 * i + layer)
               for i in range(4) for layer in range(2)}
    ft = FinetuneConfig(steps_per_layer=4, save_step=4)
    names = [f"s{i}" for i in range(4)]
    planes = finetune_subjects_batched(shared, lambda pos, layer: batches[pos, layer], cfg, ft,
                                       out_dir, names, log_every=0, mesh=_mesh(distributed))
    return {"planes": planes, "written": sorted(os.listdir(out_dir))}


# ---- CLIs ----

def cli_case(cli: str, argv: list) -> dict:
    """``humanliff_tpu_torch.cli.<cli>.main(argv)`` on this rank; what it
    returns, where a train state, as numpy."""
    import importlib

    out = importlib.import_module(f"humanliff_tpu_torch.cli.{cli}").main(argv)
    if out is None:
        return {}
    params = getattr(out, "params", None)
    if isinstance(params, dict):  # a Stage-1 state: this rank's shard
        return {"step": out.step, "shard": _np(params["planes"]),
                "decoder": _np(params["decoder"])}
    return {"returned": type(out).__name__}
