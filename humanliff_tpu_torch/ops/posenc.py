"""NeRF positional encoding (port of ``humanliff_tpu/ops/posenc.py``).

Layout ``[x, sin(2^0 x), cos(2^0 x), sin(2^1 x), cos(2^1 x), ...]``, each block
the full ``d_in``-vector; with num_freqs=4 and d_in=3 the output is 27-wide.
Evaluated in ``x``'s dtype, as in JAX.
"""

from __future__ import annotations

import torch


def positional_encoding(
    x: torch.Tensor, num_freqs: int = 4, include_input: bool = True
) -> torch.Tensor:
    """Encode ``(..., d_in)`` to ``(..., d_in * (2 * num_freqs (+ 1)))``."""
    freqs = 2.0 ** torch.arange(num_freqs, dtype=x.dtype, device=x.device)
    xf = x[..., None, :] * freqs[:, None]  # (..., F, d_in)
    enc = torch.stack([torch.sin(xf), torch.cos(xf)], dim=-2)  # (..., F, 2, d_in)
    enc = enc.reshape(*x.shape[:-1], num_freqs * 2 * x.shape[-1])
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc
