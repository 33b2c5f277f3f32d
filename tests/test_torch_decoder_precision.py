"""The fused decoder kernel's arithmetic, emulated in plain PyTorch on the CPU.

The CUDA kernel (``humanliff_tpu_torch/csrc/fused_decoder.cu``) runs every
dense layer as split TF32 on the tensor cores, three products per product,
and one mma adds an 8-deep k-tile's products to an fp32 accumulator. The
tensor core reads the upper 19 bits of a TF32 operand (it truncates;
tests/test_torch_cuda_kernels.py checks this on the card). An activation a is split into
ah = a rounded to 10 mantissa bits (to nearest, ties away from zero) and
al = a - ah; a weight w into wh = w truncated and wl = w - wh; al and wl reach
the tensor core truncated. The products are added in the kernel's order,
al.wh, ah.wl, ah.wh. Softplus is max(x, 0) + log(1 + exp(-|x|)) in fp32, the
form the kernel evaluates on the special-function units. The weights go
through the wrapper's packing (padded, fragment-ordered) and are read back
from the packed buffer.

Held to the kernel's own tolerances against the plain fp32 decoder, with the
fitted Stage-1 decoder on points sampled from fitted planes in the render box,
as chip_smoke.py does: 1e-4 + 1e-5 max|ref| for fp32 inputs and
1e-2 + 1e-5 max|ref| for bf16 inputs (outputs reach about 600, so 6e-3 and
1.6e-2).
"""

import importlib.util
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import randomize_tree  # noqa: F401  (sets torch threads)
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.ops import fused_decoder as fd
from humanliff_tpu_torch.ops.posenc import positional_encoding
from humanliff_tpu_torch.ops.triplane import sample_triplane_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FITTED = os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")
PLANES = os.path.join(REPO, "runs", "quality", "stage2", "planes", "campaign0000_060000.npz")
BOX = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)
M = 16384


def _tf32_rna(v: torch.Tensor) -> torch.Tensor:
    return ((v.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(v: torch.Tensor) -> torch.Tensor:
    return (v.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split_activation(a: torch.Tensor):
    """(ah, al) as the tensor core reads them: ah rounded, al = a - ah truncated."""
    ah = _tf32_rna(a)
    return ah, _tf32_trunc(a - ah)


def _split_weight(w: torch.Tensor):
    """(wh, wl) as the tensor core reads them: wh truncated, wl = w - wh truncated."""
    wh = _tf32_trunc(w)
    return wh, _tf32_trunc(w - wh)


def _dense(acc: torch.Tensor, a: torch.Tensor, W: torch.Tensor, partials: int = 1):
    """acc (rows, N) += a (rows, K) W (K, N), one k-tile at a time, as mma does;
    a head spreads its k-tiles over ``partials`` accumulators."""
    accs = [acc] + [torch.zeros_like(acc) for _ in range(partials - 1)]
    for kt in range(W.shape[0] // 8):
        ah, al = _split_activation(a[:, 8 * kt:8 * kt + 8].contiguous())
        wh, wl = _split_weight(W[8 * kt:8 * kt + 8].contiguous())
        p = kt % partials
        for x, y in ((al, wh), (ah, wl), (ah, wh)):
            accs[p] = accs[p] + x @ y
    return accs[0] if partials == 1 else (accs[0] + accs[1]) + (accs[2] + accs[3])


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(x, min=0) + torch.log(1 + torch.exp(-x.abs()))


def emulated_kernel(packed, feats, dirs):
    """(rgb or None, alpha) as the kernel computes them, from its packed buffer."""
    P = fd.padded_parts(packed)
    rows = feats.shape[0]
    x = F.pad(feats.float(), (0, 5))  # 27 -> 32 columns

    def layer(a, name, bias, N):
        return _dense(P[bias][:N].expand(rows, N).clone(), a, P[name])

    h = _softplus(layer(x, "w0", "b0", 128))
    h = _softplus(layer(h, "w1", "b1", 128))
    h = _softplus(layer(torch.cat([x, h], -1), "w2", "b2", 128))
    alpha = _dense(P["ba"].expand(rows, 8).clone(), h, P["wa"], partials=4)[:, :1]
    if dirs is None:
        return None, alpha
    feat = layer(h, "wf", "bf", 128)
    pe = F.pad(positional_encoding(dirs, num_freqs=4).float(), (0, 5))
    v = _softplus(layer(torch.cat([feat, pe], -1), "wv", "bv", 64))
    rgb = _dense(P["br"].expand(rows, 8).clone(), v, P["wr"], partials=4)[:, :3]
    return rgb, alpha


@pytest.fixture(scope="module")
def weights():
    dec = NeRFDecoder()
    with np.load(FITTED) as f:
        dec.load_state_dict(decoder_state_dict(dict(f)))
    return tuple(t.detach() for t in dec.weights())


def _points(layer: int, seed: int = 0):
    """Features sampled from fitted planes (campaign0000, one clothing layer) in
    the render box, and unit view directions."""
    with np.load(PLANES) as f:
        planes = torch.from_numpy(np.ascontiguousarray(f["tri_planes"][layer]))
    rng = np.random.default_rng(seed)
    coords = torch.from_numpy(rng.uniform(BOX[0], BOX[1], (M, 3)).astype(np.float32))
    feats = sample_triplane_features(planes, coords, torch.from_numpy(BOX)).contiguous()
    dirs = F.normalize(torch.from_numpy(rng.standard_normal((M, 3)).astype(np.float32)), dim=-1)
    return feats, dirs


@pytest.mark.parametrize("layer", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [True, False])
def test_split_tf32_meets_kernel_tolerance(weights, layer, dtype, full):
    feats, dirs = _points(layer)
    feats = feats.to(getattr(torch, dtype))
    dirs = dirs.to(getattr(torch, dtype)) if full else None
    with torch.no_grad():
        ref_rgb, ref_alpha = fd.decoder_plain(weights, feats, dirs)
        rgb, alpha = emulated_kernel(fd.pack_weights(weights), feats, dirs)
    pairs = [(alpha, ref_alpha)] + ([(rgb, ref_rgb)] if full else [])
    scale = max(float(r.abs().max()) for _, r in pairs)
    assert scale > 100.0  # the fitted decoder's outputs reach the hundreds
    tol = (1e-4 if dtype == "float32" else 1e-2) + 1e-5 * scale
    for out, ref in pairs:
        assert float((out - ref).abs().max()) <= tol


def test_single_tf32_pass_misses_tolerance(weights):
    """The reason for three products: one TF32 pass is far outside the bar."""
    w = weights
    feats, _ = _points(3)
    P = fd.padded_parts(fd.pack_weights(w))
    x = F.pad(feats, (0, 5))
    with torch.no_grad():
        h = _softplus(_tf32_rna(x) @ _tf32_rna(P["w0"]) + P["b0"])
        h = _softplus(_tf32_rna(h) @ _tf32_rna(P["w1"]) + P["b1"])
        h = _softplus(_tf32_rna(torch.cat([x, h], -1)) @ _tf32_rna(P["w2"]) + P["b2"])
        alpha = (_tf32_rna(h) @ _tf32_rna(P["wa"]) + P["ba"])[:, :1]
        _, ref = fd.decoder_plain(w, feats, None)
    assert float((alpha - ref).abs().max()) > 10 * (1e-4 + 1e-5 * float(ref.abs().max()))


def test_pack_round_trip():
    torch.manual_seed(0)
    w = tuple(t.detach() for t in NeRFDecoder().weights())
    packed = fd.pack_weights(w)
    assert packed.dtype == torch.float32 and packed.numel() == fd.N_PACKED
    for a, b in zip(w, fd.unpack_weights(packed)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["w0", "w1", "w2", "wa", "wv", "wr", "wf"])
def test_padding_lies_where_the_kernel_expects_zeros(name):
    """Each padded matrix holds its weights at the kernel's rows and zeros
    elsewhere: W2's rows 27-31 (x padded to 32) and Wv's rows 155-159 (PE4
    padded to 32), the rows past 27 of W0 and the columns past 1 and 3 of
    the heads."""
    w = tuple(torch.full_like(t, 2.0) for t in NeRFDecoder().weights())
    P = fd.padded_parts(fd.pack_weights(w))[name]
    out, n_in = fd._SHAPES[fd._NAMES.index(name)]
    expected = torch.zeros_like(P)
    expected[fd._padded_rows(name), :out] = 2.0
    assert torch.equal(P, expected)
    if name in ("w2", "wv"):
        assert int((P.abs().sum(1) == 0).sum()) == 5


def test_pack_pads_with_zeros():
    """Every weight lands once; the padding rows and columns are zero."""
    w = tuple(torch.full_like(t, 2.0) for t in NeRFDecoder().weights())
    packed = fd.pack_weights(w)
    assert int((packed == 2.0).sum()) == sum(t.numel() for t in w) == 66884
    assert int((packed == 0.0).sum()) == fd.N_PACKED - 66884


@pytest.mark.parametrize("name", ["w0", "w1", "w2", "wa", "wv", "wr", "wf"])
def test_fragment_index_is_the_kernels(name):
    """The packed buffer holds W[8 kt + 2 t + r][8 j + g] where the kernel
    reads k-tile kt, n-tile j, lane 4 g + t, register r: at
    ((kt NT/2 + j/2) 32 + lane) 4 + (j % 2) 2 + r, or (kt 32 + lane) 2 + r
    for a one-n-tile head."""
    K, N = next((k, n) for p, k, n in fd._PARTS if p == name)
    W = torch.arange(K * N, dtype=torch.float32).reshape(K, N)
    flat = fd._to_fragments(W)
    kt, j, lane, r = torch.meshgrid(torch.arange(K // 8), torch.arange(N // 8),
                                    torch.arange(32), torch.arange(2), indexing="ij")
    g, t = lane // 4, lane % 4
    NT = N // 8
    idx = (((kt * (NT // 2) + j // 2) * 32 + lane) * 4 + (j % 2) * 2 + r if NT > 1
           else (kt * 32 + lane) * 2 + r)
    assert torch.equal(flat[idx], W[8 * kt + 2 * t + r, 8 * j + g])


def test_packed_cache_hits_and_repacks_after_update():
    dec = NeRFDecoder()
    w = dec.weights()
    first = fd.packed_weights(w)
    assert fd.packed_weights(w) is first
    assert fd.packed_weights(tuple(t.detach() for t in w)) is first  # same storage, version
    opt = torch.optim.SGD(dec.parameters(), lr=0.1)
    loss = dec(torch.randn(8, 27))[1].sum()
    loss.backward()
    opt.step()
    after_step = fd.packed_weights(dec.weights())
    assert after_step is not first
    assert torch.equal(after_step, fd.pack_weights(dec.weights()))
    with torch.no_grad():
        dec.rgb_linear.bias.add_(1.0)
    after_add = fd.packed_weights(dec.weights())
    assert after_add is not after_step
    assert torch.equal(fd.unpack_weights(after_add)[-1], dec.rgb_linear.bias.detach())


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("M,full,dtype,term", [
    (4_194_304, True, "bfloat16", "tf32 tensor"),
    (2_097_152, False, "bfloat16", "tf32 tensor"),
    (2_146_689, False, "bfloat16", "tf32 tensor"),
    (4_194_304, False, "float32", "tf32 tensor"),
    (1, False, "float32", "bytes"),
])
def test_decoder_bound_terms(M, full, dtype, term):
    """chip_smoke.decoder_bound_ms: the tensor-core term binds the main path's
    shapes (a render chunk's fine and coarse pass, the 129^3 density grid, a
    mesh tile of fp32 features); the weights' bytes bind a single point."""
    b = _chip_smoke().decoder_bound_ms(M, dtype, full)
    assert b["term"] == term
    assert b["by"] == ("bytes" if term == "bytes" else "operations")
