"""Import the reference's own PyTorch checkpoints (port of
``humanliff_tpu/compat/torch_import.py``).

Stage-1 ``{step}.tar`` files carry ``network_fn_state_dict`` with the decoder
MLP and ``tri_planes`` (run_nerf_batch.py:321-330), and ``global_step``; the
fine-tune artifact ``{human}_002000.tar`` holds only ``tri_planes``
(run_nerf_batch_ft.py:323-333). Stage-2 ``model*.pt`` / ``ema_*.pt`` files are
the UNet's state dict. The port's module names are the reference's
(``nerf/decoder.py``, ``models/unet.py``), so the weights need no renaming:
``module.`` prefixes (DataParallel / DDP) are stripped, values become fp32
tensors, and the UNet loads with ``strict=True``, so a missing or unexpected
key raises and the message names it.

The attention qkv rows. The reference's ``AttentionBlock`` (improved-diffusion
``unet.py``) reshapes the qkv projection to (B * heads, 3 * head_dim, T)
before ``QKVAttention`` splits q, k and v, so its 3C output rows are
head-major: ``[h0: q k v | h1: q k v | ...]``. The port's block (and the JAX
package's) splits [q | k | v] first and cuts each part into heads. With
``qkv_layout="reference"`` (the default) every ``AttentionBlock``'s
``qkv.weight`` and ``qkv.bias`` are permuted to the port's order by that
block's own head count, read from the target model (the middle block, the
decoder's blocks at ``num_heads_upsample``, the ControlNet copy).
``qkv_layout="jax"`` copies the rows as they are, as the JAX importer does
(``_attn``): a reference checkpoint at more than one head then loads without
error and attends through the wrong rows. The spatial transformer's separate
``to_q``/``to_k``/``to_v`` need no permutation.

Values may be torch tensors or numpy arrays, as in the JAX importer (``_np``).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

import numpy as np
import torch

from humanliff_tpu_torch.models.attention import AttentionBlock
from humanliff_tpu_torch.nerf.decoder import PARAM_NAMES

StateDict = Dict[str, torch.Tensor]
QKV_LAYOUTS = ("reference", "jax")


def _load_torch(path: str) -> Dict[str, Any]:
    # The reference's checkpoints hold only tensors, numbers and containers.
    return torch.load(path, map_location="cpu", weights_only=True)


def _tensor(v) -> torch.Tensor:
    """Tensor or array -> a contiguous fp32 CPU tensor."""
    if isinstance(v, torch.Tensor):
        return v.detach().to(device="cpu", dtype=torch.float32).contiguous()
    return torch.from_numpy(np.ascontiguousarray(v, np.float32))


def _strip_module(sd: Mapping[str, Any]) -> Dict[str, Any]:
    return {(k[7:] if k.startswith("module.") else k): v for k, v in sd.items()}


def import_stage1_checkpoint(path: str) -> Tuple[Dict[str, Any], int]:
    """A reference Stage-1 ``.tar`` -> (:func:`stage1_params_from_state_dict`'s
    dict, ``global_step``). Reads the shared checkpoint and the fine-tune
    tri-plane-only file alike."""
    obj = _load_torch(path)
    step = int(obj.get("global_step", 0))
    sd = obj.get("network_fn_state_dict", obj)
    return stage1_params_from_state_dict(sd), step


def stage1_params_from_state_dict(sd: Mapping[str, Any]) -> Dict[str, Any]:
    """A reference Stage-1 state dict -> ``{"decoder": NeRFDecoder state dict,
    "planes": (N, 4, 3, C3, D, D) tensor}``, each key only where the state
    dict has it."""
    sd = _strip_module(sd)
    out: Dict[str, Any] = {}
    if "tri_planes" in sd:
        planes = _tensor(sd["tri_planes"])
        if planes.dim() != 6:
            raise ValueError(f"tri_planes {tuple(planes.shape)}: expected "
                             "(instances, layers, 3, C3, D, D)")
        out["planes"] = planes
    if "pts_linears.0.weight" in sd:
        out["decoder"] = {k: _tensor(sd[k]) for k in PARAM_NAMES}
    return out


def qkv_to_port(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Head-major qkv rows ``[h: q k v]`` (weight (3C, C, 1) or bias (3C,))
    -> the port's ``[q | k | v]``, each part head by head."""
    rows = t.shape[0]
    return (t.reshape(num_heads, 3, rows // (3 * num_heads), *t.shape[1:])
            .transpose(0, 1).reshape(t.shape).contiguous())


def qkv_to_reference(t: torch.Tensor, num_heads: int) -> torch.Tensor:
    """The inverse of :func:`qkv_to_port`."""
    rows = t.shape[0]
    return (t.reshape(3, num_heads, rows // (3 * num_heads), *t.shape[1:])
            .transpose(0, 1).reshape(t.shape).contiguous())


def unet_state_dict_from_reference(sd: Mapping[str, Any], model: torch.nn.Module,
                                   qkv_layout: str = "reference") -> StateDict:
    """A reference UNet state dict -> the state dict that ``model`` (a port
    ``UNetModel`` of the checkpoint's configuration) loads: prefixes
    stripped, fp32 tensors, the qkv rows of each ``AttentionBlock`` in the
    port's order (module docstring)."""
    if qkv_layout not in QKV_LAYOUTS:
        raise ValueError(f"qkv_layout {qkv_layout!r}: one of {QKV_LAYOUTS}")
    out = {k: _tensor(v) for k, v in _strip_module(sd).items()}
    if qkv_layout == "reference":
        for name, module in model.named_modules():
            if isinstance(module, AttentionBlock):
                for kind in ("weight", "bias"):
                    key = f"{name}.qkv.{kind}" if name else f"qkv.{kind}"
                    if key in out:  # a missing key is the strict load's to name
                        out[key] = qkv_to_port(out[key], module.num_heads)
    return out


def import_unet_checkpoint(path: str, model: torch.nn.Module,
                           qkv_layout: str = "reference") -> torch.nn.Module:
    """Load a reference UNet ``.pt`` into ``model`` (strict) and return it."""
    sd = unet_state_dict_from_reference(_load_torch(path), model, qkv_layout)
    model.load_state_dict(sd, strict=True)
    return model
