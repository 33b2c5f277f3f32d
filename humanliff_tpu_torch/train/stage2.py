"""Stage-2 diffusion training (port of ``humanliff_tpu/train/stage2.py``;
reference improved_diffusion/train_util.py).

One step draws timesteps (uniform or loss-aware), diffuses the batch, runs the
UNet forward and backward microbatch by microbatch, accumulating gradients,
then applies the clipped AdamW (``train/optim.py``), the EMA per rate and the
loss-aware sampler's update. Nothing comes to the host: the metrics are 0-d
tensors on the step's device.

Layout: the batch is NHWC, as in the JAX package and the port's sampling; the
UNet sees NCHW views of it, which are channels_last in memory, so no copy is
made. Parameters, gradients, Adam moments and each EMA are one flat fp32
buffer each (:class:`ParamLayout`); the model's parameters and their ``.grad``
are views into the first two, so the optimizer and the EMA are a few passes
over a buffer, and autograd accumulates microbatch gradients into it in place.
4-d conv weights are channels_last views.

Mixed precision: ``use_bf16`` runs the forward under bf16 autocast with fp32
master weights; GroupNorm and the diffusion arithmetic stay fp32.

Dropout: the JAX step runs the UNet with ``deterministic=True``, so dropout is
off in training whatever ``--dropout`` says; the port matches it by running
the UNet in eval mode (the reference trains with dropout on).

Several ranks (``mesh``, ``parallel/mesh.py``): each rank runs the step on
its B/W rows of the global batch of B. Timesteps and noise are drawn for the
global batch from a generator seeded alike on every rank, then sliced; each
microbatch's loss is divided by the global B, and the gradient buffer is
all-reduced after the last microbatch, so the gradient norm, the clip chain
and the metrics are the one-process ones. The loss-aware sampler updates
from the gathered (t, loss) of the whole batch: every rank keeps the same
sampler state. Without ZeRO every rank steps the whole state (DDP). With
ZeRO-1 (``zero``) each rank owns one offset range of the flat buffers
(``parallel/mesh.py::zero_ranges``), and Adam's moments and each EMA exist
only for that range: each rank clips the whole all-reduced gradient, steps
its range of the parameters and the EMA, and broadcasts its range. JAX splits
each leaf on its largest divisible axis instead; a checkpoint is the same
file either way (:func:`state_payload` gathers the ranges).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from humanliff_tpu_torch.diffusion.gaussian import GaussianDiffusion
from humanliff_tpu_torch.diffusion.resample import LossSecondMomentResampler, UniformSampler
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import DataMesh, replicate, zero_ranges
from humanliff_tpu_torch.train.optim import OptState, Stage2Optimizer

StateDict = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Stage2Config:
    lr: float = 5e-5
    weight_decay: float = 0.0
    lr_anneal_steps: int = 0
    ema_rates: Tuple[float, ...] = (0.9999,)
    microbatch: int = 0  # 0 = no accumulation
    grad_clip_value: float = 0.5
    grad_clip_norm: float = 1.0  # 0 disables
    use_bf16: bool = False
    schedule_sampler: str = "uniform"
    class_cond: bool = True

    def optimizer(self) -> Stage2Optimizer:
        return Stage2Optimizer(lr=self.lr, weight_decay=self.weight_decay,
                               anneal_steps=self.lr_anneal_steps,
                               grad_clip_value=self.grad_clip_value,
                               grad_clip_norm=self.grad_clip_norm)


class ParamLayout:
    """Where each parameter of a model lives in one flat fp32 buffer: in
    ``named_parameters`` order, each 4-d tensor stored (O, kh, kw, I), so its
    (O, I, kh, kw) view is channels_last."""

    def __init__(self, model: nn.Module):
        self.entries = []
        offset = 0
        for name, p in model.named_parameters():
            self.entries.append((name, tuple(p.shape), offset))
            offset += p.numel()
        self.numel = offset

    def views(self, flat: torch.Tensor) -> StateDict:
        out = {}
        for name, shape, off in self.entries:
            part = flat[off:off + math.prod(shape)]
            if len(shape) == 4:
                o, i, kh, kw = shape
                out[name] = part.view(o, kh, kw, i).permute(0, 3, 1, 2)
            else:
                out[name] = part.view(shape)
        return out

    def flatten(self, state_dict, device) -> torch.Tensor:
        """A new flat buffer on ``device`` holding ``state_dict``'s tensors."""
        flat = torch.empty(self.numel, device=device)
        views = self.views(flat)
        missing = set(views) ^ set(state_dict)
        if missing:
            raise KeyError(f"state dict does not match the model: {sorted(missing)[:5]}")
        for name, v in views.items():
            v.copy_(state_dict[name])
        return flat


@dataclasses.dataclass
class Stage2State:
    """The train state. ``params`` and ``grads`` are the storage of the
    model's parameters and gradients; ``ema_params`` is keyed by str(rate).
    ``opt_state["count"]`` counts optimizer updates: it restarts at 0 when a
    light checkpoint (no moments) is resumed, while ``step`` does not.
    ``ranges``: ZeRO-1's offset range of each rank, where the moments and the
    EMAs hold this rank's range only (None: they hold the whole buffer)."""

    step: int
    params: torch.Tensor
    grads: torch.Tensor
    opt_state: OptState
    ema_params: Dict[str, torch.Tensor]
    sampler_state: Optional[Dict[str, torch.Tensor]]
    layout: ParamLayout
    ranges: Optional[List[Tuple[int, int]]] = None
    rank: int = 0

    @property
    def part(self) -> slice:
        """This rank's range of the flat buffers (all of them without ZeRO)."""
        return slice(None) if self.ranges is None else slice(*self.ranges[self.rank])


def create_stage2_state(model: nn.Module, cfg: Stage2Config, num_timesteps: int,
                        mesh: Optional[DataMesh] = None, zero: bool = False) -> Stage2State:
    """A fresh state from the model's current weights, on the model's device;
    the model's parameters become views of ``state.params``. With ``mesh``
    the weights are rank 0's on every rank, and ``zero`` splits the moments
    and the EMAs by offset range of the flat buffer (ZeRO-1; a divergence
    from JAX, which splits each leaf on its largest divisible axis)."""
    device = next(model.parameters()).device
    layout = ParamLayout(model)
    params = layout.flatten({n: p.detach() for n, p in model.named_parameters()}, device)
    ranges = None
    if mesh is not None:
        replicate([params], mesh)
        if zero:
            ranges = zero_ranges(layout.numel, mesh.size)
    grads = torch.zeros_like(params)
    p_views, g_views = layout.views(params), layout.views(grads)
    for name, p in model.named_parameters():
        p.data, p.grad = p_views[name], g_views[name]
    sampler_state = None
    if cfg.schedule_sampler == "loss-second-moment":
        sampler_state = LossSecondMomentResampler(num_timesteps).init_state(device)
    elif cfg.schedule_sampler != "uniform":
        raise NotImplementedError(f"unknown schedule sampler: {cfg.schedule_sampler}")
    state = Stage2State(step=0, params=params, grads=grads, opt_state={}, ema_params={},
                        sampler_state=sampler_state, layout=layout, ranges=ranges,
                        rank=0 if mesh is None else mesh.rank)
    state.opt_state = cfg.optimizer().init(params[state.part])
    state.ema_params = {str(r): params[state.part].clone() for r in cfg.ema_rates}
    return state


def state_payload(state: Stage2State, light: bool = False,
                  mesh: Optional[DataMesh] = None) -> Optional[Dict]:
    """The checkpoint of ``state``: step, params and EMA as state dicts, and
    unless ``light`` the optimizer (moments as state dicts, count) and the
    sampler state. Values are views of the state's buffers, so a save writes
    each buffer once. Under ZeRO every rank calls it: the ranges are gathered
    into host memory on rank 0, which gets the payload; the others get None."""
    def full(buf):
        if state.ranges is None:
            return buf
        return coll.gather_to_root(buf, state.ranges, state.layout.numel, mesh)

    ema = {r: full(e) for r, e in state.ema_params.items()}
    mom = {} if light else {k: full(state.opt_state[k]) for k in ("mu", "nu")}
    if mesh is not None and mesh.rank != 0:
        return None
    views = state.layout.views
    payload = {"step": state.step, "params": views(state.params),
               "ema_params": {r: views(e) for r, e in ema.items()}}
    if not light:
        payload["opt_state"] = {"mu": views(mom["mu"]), "nu": views(mom["nu"]),
                                "count": int(state.opt_state["count"])}
        payload["sampler_state"] = state.sampler_state
    return payload


def restore_into(state: Stage2State, restored: Dict) -> bool:
    """Load a checkpoint (:func:`state_payload`'s dict) into ``state`` in
    place, the model's parameters with it; under ZeRO the moments and EMAs
    take this rank's range, so a checkpoint of any world size resumes. A
    light checkpoint leaves the optimizer and the sampler as they are
    (fresh). Returns whether it was a full one."""
    device = state.params.device
    state.step = int(restored["step"])
    for name, v in state.layout.views(state.params).items():
        v.copy_(restored["params"][name])

    def flat(state_dict):
        if state.ranges is None:
            return state.layout.flatten(state_dict, device)
        return state.layout.flatten(state_dict, "cpu")[state.part].to(device)

    state.ema_params = {r: flat(e) for r, e in restored["ema_params"].items()}
    if "opt_state" not in restored:
        return False
    opt = restored["opt_state"]
    for key in ("mu", "nu"):
        state.opt_state[key].copy_(flat(opt[key]))
    state.opt_state["count"] = int(opt["count"])
    sampler = restored.get("sampler_state")
    state.sampler_state = (None if sampler is None
                           else {k: v.to(device) for k, v in sampler.items()})
    return True


def gather_batch(planes: torch.Tensor, idx: torch.Tensor, y: torch.Tensor):
    """The device-resident batch: ``planes`` (N*L, H, W, C) of N subjects' L
    layers, ``idx`` flat (subject, layer) indices and ``y = idx % L``; x_cond
    is the previous layer of the same subject, zero at layer 0."""
    x = planes.index_select(0, idx)
    has_prev = y > 0
    prev = planes.index_select(0, idx - has_prev.to(idx.dtype))
    return x, prev * has_prev.to(prev.dtype)[:, None, None, None]


def model_fn_for(model: nn.Module):
    """NHWC in, fp32 NHWC out: the diffusion's view of the NCHW UNet. An
    unconditioned model (``cond_type=""``) gets no x_cond; a
    ``SuperResModel`` takes its NHWC ``low_res`` as a keyword."""
    use_cond = model.cond_type != ""

    def nchw(a):
        return None if a is None else a.permute(0, 3, 1, 2)

    def fn(x, ts, x_cond, y=None, low_res=None):
        args = (nchw(x), ts) if low_res is None else (nchw(x), ts, nchw(low_res))
        out = model(*args, x_cond=nchw(x_cond) if use_cond else None, y=y)
        return out.permute(0, 2, 3, 1).float()

    return fn


def train_step(
    state: Stage2State,
    model: nn.Module,
    diffusion: GaussianDiffusion,
    cfg: Stage2Config,
    batch: Dict[str, torch.Tensor],
    t: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    mesh: Optional[DataMesh] = None,
) -> Dict[str, torch.Tensor]:
    """One optimization step on ``state`` (updated in place); returns the metrics.

    ``batch`` is materialised, ``{"x", "x_cond", "y"}`` with x and x_cond
    (B, H, W, C), or device-resident, ``{"planes", "idx", "y"}``
    (:func:`gather_batch`). A super-resolution batch is ``{"x", "low_res"}``
    (no x_cond; y only with ``class_cond``). ``t`` (B,) and ``noise``
    (B, H, W, C) may be given; whatever is missing is drawn from ``generator``.
    With ``mesh``, ``batch`` is this rank's rows and ``t``, ``noise`` and the
    metrics are the global batch's (module docstring).
    """
    model.eval()  # dropout off, as the JAX step's deterministic=True
    if "planes" in batch:
        x, x_cond = gather_batch(batch["planes"], batch["idx"], batch["y"])
    else:
        x, x_cond = batch["x"], batch.get("x_cond")
    y, low_res = batch.get("y"), batch.get("low_res")
    device, T = x.device, diffusion.num_timesteps
    B = x.shape[0] * (1 if mesh is None else mesh.size)  # the global batch
    rows = slice(None) if mesh is None else mesh.rows(B)

    lsm = LossSecondMomentResampler(T) if cfg.schedule_sampler == "loss-second-moment" else None
    if t is None:
        if lsm is not None:
            t, weights = lsm.sample(state.sampler_state, B, generator)
        else:
            t, weights = UniformSampler(T).sample(B, device, generator)
    elif lsm is not None:
        weights = 1.0 / (T * lsm._weights(state.sampler_state)[t])
    else:
        weights = torch.ones(B, device=device)
    if noise is None:
        noise = torch.randn((B, *x.shape[1:]), generator=generator, device=device)
    t_all, t, weights, noise = t, t[rows], weights[rows], noise[rows]

    B_local = x.shape[0]
    mb = cfg.microbatch if 0 < cfg.microbatch < B_local else B_local
    if B_local % mb:
        raise ValueError(f"microbatch {mb} does not divide batch {B_local}")
    model_fn = model_fn_for(model)
    state.grads.zero_()
    loss = torch.zeros((), device=device)
    per_ex = []
    for s in range(0, B_local, mb):
        sl = slice(s, s + mb)
        kwargs = {"y": y[sl]} if cfg.class_cond else {}
        if low_res is not None:
            kwargs["low_res"] = low_res[sl]
        with torch.autocast(device.type, dtype=torch.bfloat16, enabled=cfg.use_bf16):
            losses = diffusion.training_losses(
                model_fn, x[sl], None if x_cond is None else x_cond[sl], t[sl],
                model_kwargs=kwargs, noise=noise[sl])["loss"]
        # Each microbatch's sum over B: the microbatches add up to the batch mean.
        micro = (losses * weights[sl]).sum() / B
        micro.backward()
        loss += micro.detach()
        per_ex.append(losses.detach())
    per_ex_losses = torch.cat(per_ex)
    if mesh is not None:
        coll.all_reduce_(state.grads, mesh)
        coll.all_reduce_(loss, mesh)
        per_ex_losses, t = coll.all_gather(per_ex_losses, mesh), t_all

    grad_norm = torch.linalg.vector_norm(state.grads)  # of the raw gradients
    part = state.part
    state.opt_state = cfg.optimizer().step_(state.params, state.grads, state.opt_state, part)
    for rate, ema in state.ema_params.items():
        ema.mul_(float(rate)).add_(state.params[part], alpha=1.0 - float(rate))
    if state.ranges is not None:
        coll.broadcast_ranges_(state.params, state.ranges, mesh)
    if lsm is not None:
        state.sampler_state = lsm.update(state.sampler_state, t, per_ex_losses)
    state.step += 1

    metrics = {"loss": loss, "mse": per_ex_losses.mean(), "grad_norm": grad_norm}
    for q in range(4):  # loss by quarter of diffusion time (train_util.py:391-397)
        in_q = (t >= q * T // 4) & (t < (q + 1) * T // 4)
        metrics[f"loss_q{q}"] = (torch.where(in_q, per_ex_losses, 0.0).sum()
                                 / in_q.sum().clamp(min=1))
    return metrics
