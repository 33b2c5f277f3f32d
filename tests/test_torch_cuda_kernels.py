"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no GPU (as on the CPU test
machine). On the card: ``python -m pytest --noconftest -m cuda
tests/test_torch_cuda_kernels.py``. M covers one point, the kernel's 128-point
tile -1, +0 and +1 (and 64, half a tile), a ragged M, and 33,869 points: more tiles
than a persistent grid of 132 blocks takes in one pass.
Tolerances as in chip_smoke.py: fp32 inputs 1e-4 + 1e-5 max|ref| (fp32 sums in
another order); bf16 inputs 1e-2 + 1e-5 max|ref| (PE4 values rounded to bf16
may land one bf16 ulp apart where sin/cos differ in the last bit). One more
case checks the tensor core's reading of a TF32 operand, which the kernel's
split relies on.
"""

import ctypes
import os
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_port_util import randomize_tree  # noqa: F401  (sets torch threads)
from humanliff_tpu_torch import kernels
from humanliff_tpu_torch.compat.from_jax import decoder_state_dict
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.ops.fused_decoder import decoder_plain, fused_decoder
from humanliff_tpu_torch.ops.triplane import sample_triplane_features

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 4099, 127, 128, 129, 33869])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [True, False])
def test_fused_decoder_matches_plain(device, M, dtype, full):
    torch.manual_seed(M)
    dec = NeRFDecoder().to(device)
    w = tuple(t.detach() for t in dec.weights())
    feats = torch.randn(M, 27, device=device).to(getattr(torch, dtype))
    dirs = torch.randn(M, 3, device=device).to(getattr(torch, dtype)) if full else None
    before = kernels.LAUNCHES["fused_decoder"]
    rgb, alpha = fused_decoder(w, feats, dirs)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fused_decoder"] == before + 1
    ref_rgb, ref_alpha = decoder_plain(w, feats, dirs)
    pairs = [(alpha, ref_alpha)] + ([(rgb, ref_rgb)] if full else [])
    for out, ref in pairs:
        tol = (1e-4 if dtype == "float32" else 1e-2) + 1e-5 * float(ref.abs().max())
        assert float((out - ref).abs().max()) <= tol


def _tol(dtype, ref):
    return (1e-4 if dtype == "float32" else 1e-2) + 1e-5 * float(ref.abs().max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("full", [True, False])
def test_fused_decoder_fitted(device, dtype, full):
    """The fitted Stage-1 decoder on features sampled from fitted planes, where
    outputs reach the hundreds (as in chip_smoke.py's kernel phase)."""
    dec = NeRFDecoder()
    with np.load(os.path.join(REPO, "runs", "quality", "train", "decoder_060000.npz")) as f:
        dec.load_state_dict(decoder_state_dict(dict(f)))
    w = tuple(t.detach().to(device) for t in dec.weights())
    with np.load(os.path.join(REPO, "runs", "quality", "stage2", "planes",
                              "campaign0000_060000.npz")) as f:
        planes = torch.from_numpy(np.ascontiguousarray(f["tri_planes"][3])).to(device)
    rng = np.random.default_rng(5)
    M = 50_000
    box = np.asarray([[-1.0, -1.2, -1.0], [1.0, 1.2, 1.0]], np.float32)
    coords = torch.from_numpy(rng.uniform(box[0], box[1], (M, 3)).astype(np.float32))
    feats = sample_triplane_features(planes, coords.to(device), torch.from_numpy(box))
    feats = feats.to(getattr(torch, dtype)).contiguous()
    dirs = F.normalize(torch.from_numpy(rng.standard_normal((M, 3)).astype(np.float32)), dim=-1)
    dirs = dirs.to(device, getattr(torch, dtype)).contiguous() if full else None
    rgb, alpha = fused_decoder(w, feats, dirs)
    ref_rgb, ref_alpha = decoder_plain(w, feats, dirs)
    assert float(ref_alpha.abs().max()) > 100.0
    for out, ref in [(alpha, ref_alpha)] + ([(rgb, ref_rgb)] if full else []):
        assert bool(torch.isfinite(out).all())
        assert float((out - ref).abs().max()) <= _tol(dtype, ref)


def test_fused_decoder_gradients(device):
    torch.manual_seed(0)
    dec = NeRFDecoder().to(device)
    feats = torch.randn(300, 27, device=device, requires_grad=True)
    dirs = torch.randn(300, 3, device=device)
    rgb, alpha = dec(feats, dirs)
    ((rgb**2).sum() + (alpha**2).sum()).backward()
    g_kernel = feats.grad.clone()
    feats.grad = None
    rgb, alpha = decoder_plain(dec.weights(), feats, dirs)
    ((rgb**2).sum() + (alpha**2).sum()).backward()
    np.testing.assert_allclose(g_kernel.cpu().numpy(), feats.grad.cpu().numpy(),
                               atol=1e-4, rtol=1e-4)


def test_kernel_follows_in_place_updates_of_a_flat_decoder(device):
    """Stage-1 training updates the decoder's flat buffer in place; the
    weights the kernel reads are views of it, so each update repacks: after
    every Adam step the kernel equals decoder_plain of the current weights."""
    from humanliff_tpu_torch.nerf.decoder import FlatDecoder, flatten_state_dict
    from humanliff_tpu_torch.train.optim import Stage1Optimizer, stage1_decoder_schedule

    torch.manual_seed(1)
    flat = flatten_state_dict(NeRFDecoder().state_dict(), device)
    tx = Stage1Optimizer(plane_schedule=lambda step: 0.0,
                         decoder_schedule=stage1_decoder_schedule(5e-3))
    params = {"planes": torch.zeros(1, device=device), "decoder": flat}
    state = tx.init(params)
    feats = torch.randn(4099, 27, device=device)
    dirs = F.normalize(torch.randn(4099, 3, device=device), dim=-1)
    prev = None
    for _ in range(3):
        w = FlatDecoder(flat).weights()
        rgb, alpha = fused_decoder(w, feats, dirs)
        ref_rgb, ref_alpha = decoder_plain(w, feats, dirs)
        for out, ref in ((rgb, ref_rgb), (alpha, ref_alpha)):
            assert float((out - ref).abs().max()) <= _tol("float32", ref)
        if prev is not None:
            assert float((rgb - prev).abs().max()) > 0.0
        prev = rgb
        grads = {"planes": torch.zeros(1, device=device), "decoder": torch.randn_like(flat)}
        state = tx.step_(params, grads, state)


def test_fused_decoder_rejects_non_contiguous(device):
    dec = NeRFDecoder().to(device)
    feats = torch.randn(27, 64, device=device).t()
    with pytest.raises(ValueError):
        fused_decoder(dec.weights(), feats, None)


# One mma.sync m16n8k8 in TF32: A has ones in column 0, B row 0 holds b, so
# D[0][0] is b as the tensor core reads it.
_TF32_OPERAND_CU = r"""
#include <cuda_runtime.h>
#include <cstdint>
__global__ void tf32_operand_kernel(float b, float* out) {
  const int t = threadIdx.x & 3;
  const uint32_t one = t == 0 ? __float_as_uint(1.f) : 0u;
  const uint32_t b0 = t == 0 ? __float_as_uint(b) : 0u;
  float d[4] = {0.f, 0.f, 0.f, 0.f};
  asm volatile("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(one), "r"(one), "r"(0u), "r"(0u), "r"(b0), "r"(0u));
  out[threadIdx.x] = d[0];
}
extern "C" int tf32_operand(float b, float* out) {
  tf32_operand_kernel<<<1, 32>>>(b, out);
  return cudaGetLastError();
}
"""


def test_tensor_core_truncates_tf32_operands(device, tmp_path):
    """The kernel passes lo = v - hi to the tensor core as an fp32 bit pattern
    and relies on the unit reading only its upper 19 bits (truncating), as
    tests/test_torch_decoder_precision.py emulates: 1 + 3 2^-12 reads as 1,
    where rounding to TF32 would give 1 + 2^-10."""
    src, lib_path = tmp_path / "tf32_operand.cu", tmp_path / "tf32_operand.so"
    src.write_text(_TF32_OPERAND_CU)
    subprocess.run([kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
                    "-Xcompiler", "-fPIC", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    lib.tf32_operand.argtypes = [ctypes.c_float, ctypes.c_void_p]
    out = torch.zeros(32, device=device)
    assert lib.tf32_operand(1.0 + 3.0 / 4096, out.data_ptr()) == 0
    torch.cuda.synchronize()
    assert float(out[0]) == 1.0
