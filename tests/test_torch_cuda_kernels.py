"""The port's CUDA kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where torch sees no GPU (as on the CPU test
machine). On the card: ``python -m pytest -m cuda tests/test_torch_cuda_kernels.py``.
Tolerances as in chip_smoke.py: fp32 inputs 1e-4 + 1e-5 max|ref| (fp32 sums in
another order); bf16 inputs 1e-2 + 1e-5 max|ref| (PE4 values rounded to bf16
may land one bf16 ulp apart where sin/cos differ in the last bit).
"""

import numpy as np
import pytest
import torch

from torch_port_util import randomize_tree  # noqa: F401  (sets torch threads)
from humanliff_tpu_torch import kernels
from humanliff_tpu_torch.nerf.decoder import NeRFDecoder
from humanliff_tpu_torch.ops.fused_decoder import decoder_plain, fused_decoder

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("M", [1, 63, 64, 65, 4099])
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


def test_fused_decoder_rejects_non_contiguous(device):
    dec = NeRFDecoder().to(device)
    feats = torch.randn(27, 64, device=device).t()
    with pytest.raises(ValueError):
        fused_decoder(dec.weights(), feats, None)
