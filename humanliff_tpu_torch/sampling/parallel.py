"""Parallel-in-time (sliding-window Picard) ancestral sampling (port of
``humanliff_tpu/sampling/parallel.py``; ParaDiGMS, Shih et al. 2023).

The DDPM chain is sequential: each UNet call waits for the previous one. The
window trades that for batched work: guess the next ``window`` states,
evaluate all of their denoise steps as one (W * B)-batch model call, and
accept the prefix of guesses that were already accurate. Slot 0's input is
exact, so every iteration advances at least one step.

Noise: each step's noise is a pure function of its absolute timestep, so the
trajectory does not depend on how the window slides. It comes from the
port's ``StepNoise`` (``step_noise(i)`` is the noise of the i-th step taken,
t = T-1-i), by default :class:`TimestepNoise`, a generator seeded from
(seed, t) as JAX's ``fold_in(key, t)`` is. At ``tol=0`` the result is the
sequential chain (``GaussianDiffusion.p_sample_loop``) under the same
``step_noise``.

Opt-in, as in JAX: the default sampler stays the sequential chain. With
``mesh`` (``parallel/mesh.py``) the window's slots split over the ranks:
each rank runs the model on its window/ranks slots, the candidates are
gathered, and every rank takes the same acceptance decision and the same
slide (JAX shards the window axis over its devices the same way).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from humanliff_tpu_torch.diffusion.gaussian import GaussianDiffusion, StepNoise
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import DataMesh

_MIX = 0x9E3779B97F4A7C15  # odd 64-bit constant: distinct (seed, t) give distinct seeds


class TimestepNoise:
    """A ``StepNoise`` whose noise for timestep t is drawn from a generator
    seeded from (seed, t) alone: ``noise(i)`` for t = T-1-i."""

    def __init__(self, seed: int, shape: Sequence[int], num_timesteps: int, device="cuda"):
        self.seed, self.shape = int(seed), tuple(shape)
        self.num_timesteps, self.device = num_timesteps, torch.device(device)

    def at(self, t: int) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * _MIX + int(t)) % (1 << 63))
        return torch.randn(self.shape, generator=g, device=self.device)

    def __call__(self, i: int) -> torch.Tensor:
        return self.at(self.num_timesteps - 1 - i)


def _window_cand(
    diffusion: GaussianDiffusion,
    model_fn: Callable[..., torch.Tensor],
    X: torch.Tensor,
    t0: int,
    x_cond: torch.Tensor,
    y: Optional[torch.Tensor],
    noise_at: Callable[[int], torch.Tensor],
    clip_denoised: bool = True,
) -> torch.Tensor:
    """``cand[i] = f_{t0-i}(X[i])`` for every slot of ``X`` (W, B, ...),
    where ``X[i]`` estimates x_{t0-i}, in one (W * B)-batch model call;
    ``noise_at(t)`` is step t's (B, ...) noise."""
    W, B = X.shape[:2]
    ts = [max(t0 - i, 0) for i in range(W)]
    flat = X.reshape(W * B, *X.shape[2:])
    t_flat = torch.tensor(ts, dtype=torch.int64, device=X.device).repeat_interleave(B)
    xc_flat = x_cond.expand(W, *x_cond.shape).reshape(flat.shape)
    kwargs: Dict[str, Any] = {}
    if y is not None:
        kwargs["y"] = y.expand(W, B).reshape(-1)
    out = diffusion.p_mean_variance(model_fn, flat, t_flat, xc_flat, clip_denoised, kwargs)
    z = torch.stack([noise_at(t).to(device=X.device, dtype=flat.dtype) for t in ts])
    nonzero = (t_flat != 0).to(flat.dtype).reshape(-1, *([1] * (flat.dim() - 1)))
    return (out["mean"] + nonzero * torch.exp(0.5 * out["log_variance"])
            * z.reshape(flat.shape)).reshape(X.shape)


def _residuals(cand: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """(W-1,): ``resid[i]`` is the mean absolute change of ``cand[i]`` from
    the previous guess ``X[i+1]``, per sample, then the max over the batch
    (one bad trajectory is not accepted because its co-samples converged)."""
    per_sample = (cand[:-1] - X[1:]).abs().mean(dim=tuple(range(2, X.dim())))  # (W-1, B)
    return per_sample.amax(dim=-1)


def _window_step(
    diffusion: GaussianDiffusion,
    model_fn: Callable[..., torch.Tensor],
    X: torch.Tensor,
    t0: int,
    x_cond: torch.Tensor,
    y: Optional[torch.Tensor],
    noise_at: Callable[[int], torch.Tensor],
    clip_denoised: bool = True,
    mesh: Optional[DataMesh] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One Picard iteration over the window ``X`` (W, B, ...): returns
    (cand (W, B, ...), resid (W-1,)) of :func:`_window_cand` and
    :func:`_residuals`. With ``mesh`` each rank evaluates its W/ranks slots
    and the candidates are gathered to every rank."""
    if mesh is None:
        cand = _window_cand(diffusion, model_fn, X, t0, x_cond, y, noise_at, clip_denoised)
    else:
        rows = mesh.rows(X.shape[0])
        cand = coll.gather_rows(_window_cand(diffusion, model_fn, X[rows], t0 - rows.start,
                                             x_cond, y, noise_at, clip_denoised), mesh)
    return cand, _residuals(cand, X)


def _slide(cand: torch.Tensor, k: int) -> torch.Tensor:
    """The window's guesses after accepting ``k`` steps: ``X'[i] =
    cand[k-1+i]``, the tail past the last candidate repeating it."""
    W = cand.shape[0]
    idx = [min(max(k - 1 + i, 0), W - 1) for i in range(W)]
    return cand[idx]


@torch.no_grad()
def parallel_p_sample_loop(
    diffusion: GaussianDiffusion,
    model_fn: Callable[..., torch.Tensor],
    shape: Sequence[int],
    generator: Optional[torch.Generator] = None,
    x_cond: Optional[torch.Tensor] = None,
    y: Optional[torch.Tensor] = None,
    window: int = 8,
    tol: float = 5e-3,
    clip_denoised: bool = True,
    noise: Optional[torch.Tensor] = None,
    step_noise: Optional[StepNoise] = None,
    max_iters: Optional[int] = None,
    device="cuda",
    mesh: Optional[DataMesh] = None,
) -> Tuple[torch.Tensor, int]:
    """Ancestral sampling by sliding-window Picard iteration.

    ``model_fn`` as for ``GaussianDiffusion.p_sample_loop``; ``window`` is the
    number of timesteps in one batched model call, ``tol`` the residual at or
    below which a guessed step is accepted (0: the sequential result).
    ``noise`` is x_T and ``step_noise`` the per-step noise; missing, x_T is
    drawn from ``generator`` and the step noise is a :class:`TimestepNoise`
    seeded from it. ``y`` defaults to zeros. Returns ``(samples, model
    calls)``; the iteration budget is ``max_iters`` or 10 T. ``mesh``: the
    window's slots split over its ranks (the window must divide over them),
    which all return the same samples.
    """
    device = torch.device(device)
    T = diffusion.num_timesteps
    W = min(window, T)
    if mesh is not None and W % mesh.size:
        raise ValueError(f"window {W} must divide over {mesh.size} ranks")
    shape = tuple(shape)
    if noise is None:
        noise = torch.randn(shape, generator=generator, device=device)
    if step_noise is None:
        seed = int(torch.randint(0, 1 << 62, (1,), generator=generator, device=device))
        step_noise = TimestepNoise(seed, shape, T, device)
    noise_at = (lambda t: step_noise(T - 1 - t)) if callable(step_noise) else (
        lambda t: step_noise[T - 1 - t])
    x_cond = (torch.zeros(shape, device=device) if x_cond is None
              else x_cond.to(device=device, dtype=torch.float32))
    if y is None:
        y = torch.zeros(shape[0], dtype=torch.int64, device=device)

    X = noise.to(device=device, dtype=torch.float32).expand(W, *shape).clone()
    t0 = T - 1
    iters = 0
    budget = max_iters or 10 * T
    while t0 >= 0 and iters < budget:
        cand, resid = _window_step(diffusion, model_fn, X, t0, x_cond, y, noise_at,
                                   clip_denoised, mesh)
        iters += 1
        r = resid.tolist()  # the W-1 residuals: the one readback per iteration
        k = 1
        while k - 1 < len(r) and r[k - 1] <= tol and k < t0 + 1:
            k += 1
        k = min(k, t0 + 1)
        if t0 - k < 0:  # slot t0 applied f_0: its candidate is the sample
            return cand[t0], iters
        X = _slide(cand, k)
        t0 -= k
    raise RuntimeError("parallel sampler exceeded its iteration budget")
