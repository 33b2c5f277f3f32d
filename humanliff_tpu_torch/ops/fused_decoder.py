"""The fused NeRF decoder: CUDA kernel wrapper and its plain PyTorch version.

Port of ``humanliff_tpu/ops/pallas/decoder.py::fused_decoder``. The kernel is
``csrc/fused_decoder.cu`` (see the note there for its design); this module
checks arguments, packs the weights into the kernel's layout (cached per
weight set), launches it on the current stream and counts the launch. :func:`decoder_plain` is the same function in plain
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
from collections import OrderedDict
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from humanliff_tpu_torch import kernels
from humanliff_tpu_torch.ops.posenc import positional_encoding

NAME = "fused_decoder"
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


# The kernel's packed weight layout (csrc/fused_decoder.cu, the note above its
# offsets): each matrix (in, out), zero-padded to whole 8 x 8 tiles, in mma
# B-fragment order; the order of the parts puts what the density-only variant
# reads first and Wf last.
LAYOUT = 2  # hl_fused_decoder_layout() of a library built for this packing
N_PACKED = 69712
# (name, padded K, padded N) in packed order, with "b" for the biases.
_PARTS = (("w0", 32, 128), ("w1", 128, 128), ("w2", 160, 128), ("wa", 128, 8), ("b", 0, 0),
          ("wv", 160, 64), ("wr", 64, 8), ("wf", 128, 128))
_BIAS_PAD = (("b0", 128), ("b1", 128), ("b2", 128), ("ba", 8), ("bf", 128), ("bv", 64),
             ("br", 8))
_NAMES = ("w0", "b0", "w1", "b1", "w2", "b2", "wa", "ba", "wf", "bf", "wv", "bv", "wr", "br")


def _padded_rows(name: str) -> torch.Tensor:
    """Padded K row of each input row of a matrix: W2's input [x (27), h (128)]
    puts h at row 32, after x padded to 32; every other matrix keeps its order."""
    rows = torch.arange(_SHAPES[_NAMES.index(name)][1])
    return torch.where(rows < D_IN, rows, rows + 5) if name == "w2" else rows


def _to_fragments(W: torch.Tensor) -> torch.Tensor:
    """(K, N) padded -> flat B fragments: [kt, j, lane = 4 g + t, r] holds
    W[8 kt + 2 t + r, 8 j + g], two n-tiles to a lane's 4 floats where N > 8."""
    K, N = W.shape
    KT, NT = K // 8, N // 8
    f = W.reshape(KT, 4, 2, NT, 8).permute(0, 3, 4, 1, 2)  # (kt, j, g, t, r)
    if NT > 1:
        f = f.reshape(KT, NT // 2, 2, 32, 2).permute(0, 1, 3, 2, 4)  # (kt, jp, lane, j%2, r)
    return f.reshape(-1)


def _from_fragments(flat: torch.Tensor, K: int, N: int) -> torch.Tensor:
    """The inverse of :func:`_to_fragments`: the padded (K, N) matrix."""
    KT, NT = K // 8, N // 8
    f = flat.reshape(KT, NT // 2, 32, 2, 2).permute(0, 1, 3, 2, 4) if NT > 1 else flat
    return f.reshape(KT, NT, 8, 4, 2).permute(0, 3, 4, 1, 2).reshape(K, N)


def pack_weights(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's flat fp32 buffer (layout ``LAYOUT``) from the 14 weights."""
    named = dict(zip(_NAMES, (w.detach().float() for w in weights)))
    parts = []
    for name, K, N in _PARTS:
        if name == "b":
            for b, n in _BIAS_PAD:
                parts.append(F.pad(named[b], (0, n - named[b].shape[0])))
            continue
        w = named[name]  # (out, in)
        W = w.new_zeros(K, N)
        W[_padded_rows(name), :w.shape[0]] = w.t()
        parts.append(_to_fragments(W))
    return torch.cat(parts).contiguous()


def padded_parts(packed: torch.Tensor) -> dict:
    """The padded parts of :func:`pack_weights`' buffer by name: each matrix
    as its padded (K, N) and each bias with its zero padding."""
    parts, at = {}, 0
    for name, K, N in _PARTS:
        if name == "b":
            for b, n in _BIAS_PAD:
                parts[b] = packed[at:at + n]
                at += n
            continue
        parts[name] = _from_fragments(packed[at:at + K * N], K, N)
        at += K * N
    if at != packed.numel():
        raise ValueError(f"packed decoder weights hold {packed.numel()} floats, not {at}")
    return parts


def unpack_weights(packed: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The 14 weights back from :func:`pack_weights`' buffer (its inverse)."""
    parts = padded_parts(packed)
    out = []
    for name, shape in zip(_NAMES, _SHAPES):
        p = parts[name]
        out.append(p[:shape[0]] if len(shape) == 1
                   else p[_padded_rows(name), :shape[0]].t().contiguous())
    return tuple(out)


# Packed buffers of the last few weight sets, keyed on each tensor's storage
# address and version counter, so an in-place update (an optimizer step, a
# copy_ under no_grad) repacks. An entry holds its tensors, so no key can name
# memory that was freed and handed to other weights. Writes through ``.data``
# bypass the version counter and are not seen.
_PACKED: "OrderedDict[tuple, Tuple[tuple, torch.Tensor]]" = OrderedDict()
_PACKED_MAX = 4


def packed_weights(weights: Sequence[torch.Tensor]) -> torch.Tensor:
    """:func:`pack_weights`, cached per weight set."""
    key = tuple((w.data_ptr(), w._version, w.device) for w in weights)
    hit = _PACKED.get(key)
    if hit is not None:
        _PACKED.move_to_end(key)
        return hit[1]
    packed = pack_weights(weights)
    _PACKED[key] = (tuple(weights), packed)
    while len(_PACKED) > _PACKED_MAX:
        _PACKED.popitem(last=False)
    return packed


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
    if packed.numel() != N_PACKED or packed.dtype != torch.float32 or not packed.is_contiguous():
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
        lib.hl_fused_decoder_layout.argtypes = []
        lib.hl_fused_decoder_layout.restype = ctypes.c_int
        if lib.hl_fused_decoder_layout() != LAYOUT:
            raise RuntimeError("fused_decoder library reads another packed weight layout")
        _LIB = lib
    return _LIB


def _forward(weights, feats, dirs):
    if feats.device.type == "cpu":
        return decoder_plain(weights, feats, dirs)
    if feats.device.type != "cuda":
        raise RuntimeError(f"fused_decoder runs on CUDA or CPU tensors, not {feats.device}")
    return _launch(packed_weights(weights), feats, dirs)


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
