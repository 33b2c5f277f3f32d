"""The fused NeRF decoder: CUDA kernel wrapper and its plain PyTorch version.

Port of ``humanliff_tpu/ops/pallas/decoder.py::fused_decoder``. The kernel is
``csrc/fused_decoder.cu`` (see the note there for its design); this module
checks arguments, packs the weights, launches it on the current stream and
counts the launch. :func:`decoder_plain` is the same function in plain
PyTorch: the wrapper takes it only for tensors that lie on the CPU (the tests)
and never as a fallback for a CUDA tensor, which launches the kernel or raises.

``weights`` is the flat 14-tuple ``(w0, b0, w1, b1, w2, b2, wa, ba, wf, bf, wv,
bv, wr, br)`` in ``torch.nn.Linear`` layout (weight ``(out, in)``), the order of
the JAX ``weights_from_decoder_vars``. Gradients go through a
``torch.autograd.Function`` whose backward recomputes with the plain version,
as the JAX custom VJP does (there is no backward kernel).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from humanliff_tpu_torch import kernels
from humanliff_tpu_torch.ops.posenc import positional_encoding

NAME = "fused_decoder"
N_PARAMS = 66884
D_IN = 27
_SHAPES = (
    (128, 27), (128,), (128, 128), (128,), (128, 155), (128,),
    (1, 128), (1,), (128, 128), (128,), (64, 155), (64,), (3, 64), (3,),
)
kernels.LAUNCHES.setdefault(NAME, 0)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``F.softplus``; it returns x itself above 20, where ``jax.nn.softplus``
    (logaddexp(x, 0)) adds log1p(exp(-x)) < 2.1e-9: below fp32 resolution there."""
    return F.softplus(x)


def decoder_plain(
    weights: Sequence[torch.Tensor],
    feats: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(rgb_raw (M, 3) or None, alpha_raw (M, 1)) in fp32, the decoder's math.

    bf16 inputs are promoted to fp32 against the fp32 weights, as flax does;
    PE4 of the directions is evaluated in their own dtype, as JAX does.
    """
    w0, b0, w1, b1, w2, b2, wa, ba, wf, bf, wv, bv, wr, br = weights
    x = feats.float()
    h = softplus(F.linear(x, w0, b0))
    h = softplus(F.linear(h, w1, b1))
    h = softplus(F.linear(torch.cat([x, h], dim=-1), w2, b2))
    alpha = F.linear(h, wa, ba)
    if dirs is None:
        return None, alpha
    feat = F.linear(h, wf, bf)
    venc = positional_encoding(dirs, num_freqs=4).float()
    h2 = softplus(F.linear(torch.cat([feat, venc], dim=-1), wv, bv))
    return F.linear(h2, wr, br), alpha


def pack_weights(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's flat fp32 weight buffer: each matrix as (in, out), then its bias."""
    parts = [w.detach().float().t().reshape(-1) if w.dim() == 2 else w.detach().float()
             for w in weights]
    return torch.cat(parts).contiguous()


def _check(weights, feats, dirs) -> None:
    if len(weights) != 14:
        raise ValueError(f"expected 14 decoder weights, got {len(weights)}")
    for w, shape in zip(weights, _SHAPES):
        if tuple(w.shape) != shape:
            raise ValueError(f"decoder weight shape {tuple(w.shape)} != {shape}")
        if w.device != feats.device:
            raise ValueError("decoder weights and features lie on different devices")
    if feats.dim() != 2 or feats.shape[1] != D_IN:
        raise ValueError(f"feats must be (M, {D_IN}), got {tuple(feats.shape)}")
    if feats.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"feats must be float32 or bfloat16, got {feats.dtype}")
    if dirs is not None:
        if tuple(dirs.shape) != (feats.shape[0], 3):
            raise ValueError(f"dirs must be ({feats.shape[0]}, 3), got {tuple(dirs.shape)}")
        if dirs.dtype != feats.dtype or dirs.device != feats.device:
            raise TypeError("dirs must match feats in dtype and device")


def _launch(packed: torch.Tensor, feats: torch.Tensor, dirs: Optional[torch.Tensor]):
    """One kernel launch on the current stream; outputs allocated here."""
    if not (feats.is_contiguous() and (dirs is None or dirs.is_contiguous())):
        raise ValueError("fused_decoder needs contiguous feats and dirs")
    if packed.numel() != N_PARAMS or packed.dtype != torch.float32 or not packed.is_contiguous():
        raise ValueError("packed decoder weights must be a contiguous fp32 buffer")
    M = feats.shape[0]
    alpha = torch.empty((M, 1), dtype=torch.float32, device=feats.device)
    rgb = (None if dirs is None
           else torch.empty((M, 3), dtype=torch.float32, device=feats.device))
    if M == 0:
        return rgb, alpha
    lib = _library()
    with torch.cuda.device(feats.device):
        stream = torch.cuda.current_stream(feats.device).cuda_stream
        err = lib.hl_fused_decoder(
            feats.data_ptr(), None if dirs is None else dirs.data_ptr(),
            packed.data_ptr(), None if rgb is None else rgb.data_ptr(),
            alpha.data_ptr(), M, int(feats.dtype == torch.bfloat16), stream,
        )
    if err != 0:
        raise RuntimeError(f"fused_decoder kernel launch failed: cudaError {err}")
    kernels.LAUNCHES[NAME] += 1
    return rgb, alpha


_LIB: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = kernels.load(NAME)
        lib.hl_fused_decoder.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]
        lib.hl_fused_decoder.restype = ctypes.c_int
        lib.hl_fused_decoder_n_params.argtypes = []
        lib.hl_fused_decoder_n_params.restype = ctypes.c_int
        if lib.hl_fused_decoder_n_params() != N_PARAMS:
            raise RuntimeError("fused_decoder library packs another weight layout")
        _LIB = lib
    return _LIB


def _forward(weights, feats, dirs):
    if feats.device.type == "cpu":
        return decoder_plain(weights, feats, dirs)
    if feats.device.type != "cuda":
        raise RuntimeError(f"fused_decoder runs on CUDA or CPU tensors, not {feats.device}")
    return _launch(pack_weights(weights), feats, dirs)


class _FusedDecoderFn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feats, dirs, *weights):
        ctx.save_for_backward(feats, dirs, *weights)
        rgb, alpha = _forward(weights, feats, dirs)
        return alpha if rgb is None else (rgb, alpha)

    @staticmethod
    def backward(ctx, *grads):
        feats, dirs, *weights = ctx.saved_tensors
        inputs = [feats, dirs, *weights]
        with torch.enable_grad():
            leaves = [None if t is None else t.detach().requires_grad_(need)
                      for t, need in zip(inputs, ctx.needs_input_grad)]
            rgb, alpha = decoder_plain(leaves[2:], leaves[0], leaves[1])
            outs = (alpha,) if rgb is None else (rgb, alpha)
            wanted = [t for t in leaves if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(outs, wanted, grads, allow_unused=True))
        return tuple(next(got) if t is not None and t.requires_grad else None
                     for t in leaves)


def fused_decoder(
    weights: Sequence[torch.Tensor],
    feats: torch.Tensor,
    dirs: Optional[torch.Tensor] = None,
) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """(rgb_raw (M, 3) fp32 or None, alpha_raw (M, 1) fp32) = decoder(feats, dirs).

    ``feats`` (M, 27) and ``dirs`` (M, 3) are fp32 or bf16. ``dirs=None`` runs
    the density-only variant (trunk and alpha head). CUDA tensors launch the
    kernel; CPU tensors take :func:`decoder_plain`.
    """
    weights = tuple(weights)
    _check(weights, feats, dirs)
    out = _FusedDecoderFn.apply(feats, dirs, *weights)
    if dirs is None:
        return None, out
    return out
