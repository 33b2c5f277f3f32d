"""Convert the JAX package's parameters and Stage-1 and Stage-2 train states
into this package's state dicts.

Inputs are nested dicts of numpy arrays, as flax ``params`` trees come out of
``jax.device_get``, or flat dicts with ``/``-joined keys, as in the
``decoder_*.npz`` files (``params/trunk_0/kernel``). No JAX is needed.

- Dense ``kernel (in, out)`` -> Linear ``weight (out, in)``.
- Conv ``kernel (kh, kw, in, out)`` (HWIO) -> Conv2d ``weight (out, in, kh, kw)``.
- Attention qkv / proj_out Dense -> Conv1d ``weight (out, in, 1)``.
- GroupNorm and LayerNorm ``scale`` -> ``weight``.

The walk mirrors ``humanliff_tpu/compat/torch_import.py::unet_params_from_state_dict``
in reverse, so a port state dict maps back through it to the same flax tree.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Sequence

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def unflatten(flat: Mapping[str, Any], sep: str = "/") -> Dict[str, Any]:
    """``{"params/a/kernel": x}`` -> ``{"params": {"a": {"kernel": x}}}``;
    keys starting with ``__`` (npz metadata) are dropped."""
    tree: Dict[str, Any] = {}
    for key, value in flat.items():
        if key.startswith("__"):
            continue
        node = tree
        *parents, leaf = key.split(sep)
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = np.asarray(value)
    return tree


def _params(tree: Mapping[str, Any]) -> Mapping[str, Any]:
    if any("/" in k for k in tree):
        tree = unflatten(tree)
    return tree["params"] if "params" in tree else tree


def _t(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _dense(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _conv1d(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T[:, :, None])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _groupnorm(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(p["GroupNorm_0"]["scale"])
    sd[f"{prefix}.bias"] = _t(p["GroupNorm_0"]["bias"])


_DECODER_NAMES = {
    "trunk_0": "pts_linears.0",
    "trunk_1": "pts_linears.1",
    "trunk_2": "pts_linears.2",
    "alpha": "alpha_linear",
    "feature": "feature_linear",
    "views": "views_linear",
    "rgb": "rgb_linear",
}


def decoder_state_dict(params: Mapping[str, Any]) -> StateDict:
    """JAX ``NeRFDecoder`` variables (nested or flat npz keys) -> port ``NeRFDecoder``."""
    p = _params(params)
    sd: StateDict = {}
    for ours, theirs in _DECODER_NAMES.items():
        _dense(sd, theirs, p[ours])
    return sd


def _resblock(sd: StateDict, prefix: str, p) -> None:
    _groupnorm(sd, f"{prefix}.in_layers.0", p["in_norm"])
    _conv(sd, f"{prefix}.in_layers.2", p["in_conv"])
    _dense(sd, f"{prefix}.emb_layers.1", p["emb_proj"])
    _groupnorm(sd, f"{prefix}.out_layers.0", p["out_norm"])
    _conv(sd, f"{prefix}.out_layers.3", p["out_conv"]["Conv_0"])
    if "skip_conv" in p:
        _conv(sd, f"{prefix}.skip_connection", p["skip_conv"])


def _layernorm(sd: StateDict, prefix: str, p) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _cross_attention(sd: StateDict, prefix: str, p) -> None:
    for name in ("to_q", "to_k", "to_v"):
        sd[f"{prefix}.{name}.weight"] = _t(np.asarray(p[name]["kernel"]).T)
    _dense(sd, f"{prefix}.to_out.0", p["to_out"])


def _transformer_block(sd: StateDict, prefix: str, p) -> None:
    _cross_attention(sd, f"{prefix}.attn1", p["attn1"])
    _cross_attention(sd, f"{prefix}.attn2", p["attn2"])
    for n in range(3):
        _layernorm(sd, f"{prefix}.norm{n + 1}", p[f"LayerNorm_{n}"])
    _dense(sd, f"{prefix}.ff.0.proj", p["GEGLU_0"]["Dense_0"])
    _dense(sd, f"{prefix}.ff.2", p["Dense_0"])


def _spatial_transformer(sd: StateDict, prefix: str, p) -> None:
    _groupnorm(sd, f"{prefix}.norm", p["GroupNorm32_0"])
    _dense(sd, f"{prefix}.proj_in", p["proj_in"])
    depth = sum(1 for k in p if k.startswith("block_"))
    for i in range(depth):
        _transformer_block(sd, f"{prefix}.transformer_blocks.{i}", p[f"block_{i}"])
    _dense(sd, f"{prefix}.proj_out", p["proj_out"]["Dense_0"])


def _attn(sd: StateDict, prefix: str, p) -> None:
    """A self-attention block, or a spatial transformer (cross_attention mode)."""
    if "proj_in" in p:
        _spatial_transformer(sd, prefix, p)
        return
    _groupnorm(sd, f"{prefix}.norm", p["GroupNorm32_0"])
    _conv1d(sd, f"{prefix}.qkv", p["qkv"])
    _conv1d(sd, f"{prefix}.proj_out", p["proj_out"]["Dense_0"])


def unet_state_dict(
    params: Mapping[str, Any],
    num_res_blocks: int = 3,
    channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
    attention_ds: Sequence[int] = (8, 16, 32),
) -> StateDict:
    """JAX ``UNetModel`` or ``SuperResModel`` variables -> the port model's
    state dict, in every conditioning mode; the mode is read off the tree.

    The ControlNet, self-attention and ResBlock names (3D-aware ones
    included: their output conv reads 3x channels) are the reference's, as
    the JAX importer ``compat/torch_import.py`` reads them. The AdaGN and
    cross-attention layers (``cond_conv1``, ``cond_conv2``, ``cond_linear``,
    ``...transformer_blocks.N.attn1.to_q``, ...) are named after the JAX
    module tree and LDM; they are not yet checked against a reference
    checkpoint (ROADMAP A14). A ``SuperResModel`` tree (its UNet under
    ``unet``) maps to the names of the port's subclass, without a prefix.
    """
    p = _params(params)
    if "unet" in p:
        p = p["unet"]
    sd: StateDict = {}
    _dense(sd, "time_embed.0", p["time_mlp_1"])
    _dense(sd, "time_embed.2", p["time_mlp_2"])
    if "label_emb" in p:
        sd["label_emb.weight"] = _t(p["label_emb"]["embedding"])

    def encoder(torch_prefix: str, ours: str) -> int:
        _conv(sd, f"{torch_prefix}.0.0", p[f"{ours}in_conv"])
        ds, idx = 1, 1
        for level in range(len(channel_mult)):
            for _ in range(num_res_blocks):
                _resblock(sd, f"{torch_prefix}.{idx}.0", p[f"{ours}res_{idx}"])
                if ds in attention_ds:
                    _attn(sd, f"{torch_prefix}.{idx}.1", p[f"{ours}attn_{idx}"])
                idx += 1
            if level != len(channel_mult) - 1:
                _conv(sd, f"{torch_prefix}.{idx}.0.op", p[f"{ours}down_{idx}"]["op"])
                ds *= 2
                idx += 1
        return idx

    n_enc = encoder("input_blocks", "enc_")
    _resblock(sd, "middle_block.0", p["mid_res1"])
    _attn(sd, "middle_block.1", p["mid_attn"])
    _resblock(sd, "middle_block.2", p["mid_res2"])

    ds = 2 ** (len(channel_mult) - 1)
    idx = 0
    for level in reversed(range(len(channel_mult))):
        for i in range(num_res_blocks + 1):
            _resblock(sd, f"output_blocks.{idx}.0", p[f"dec_res_{idx}"])
            pos = 1
            if ds in attention_ds:
                _attn(sd, f"output_blocks.{idx}.{pos}", p[f"dec_attn_{idx}"])
                pos += 1
            if level and i == num_res_blocks:
                _conv(sd, f"output_blocks.{idx}.{pos}.conv", p[f"dec_up_{idx}"]["conv"])
                ds //= 2
            idx += 1

    _groupnorm(sd, "out.0", p["out_norm"])
    _conv(sd, "out.2", p["out_conv"]["Conv_0"])

    if "cond_in_conv" in p:  # controlnet
        encoder("input_blocks_cond", "cond_")
        for i in range(n_enc):
            _conv(sd, f"input_blocks_proj_cond.{i}", p[f"cond_proj_{i}"]["Conv_0"])
    if "cond_conv1" in p:  # AdaGN, cross_attention
        _conv(sd, "cond_conv1", p["cond_conv1"])
        _conv(sd, "cond_conv2", p["cond_conv2"])
        _dense(sd, "cond_linear", p["cond_linear"])
    return sd


def load_unet_npz(
    path: str,
    num_res_blocks: int = 3,
    channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
    attention_ds: Sequence[int] = (8, 16, 32),
) -> StateDict:
    """The port ``UNetModel`` state dict held in one npz, in either key layout:

    - ``/``-joined keys of a flax params tree (``params/enc_in_conv/kernel``),
      the layout of ``decoder_*.npz`` and of ``scripts/export_jax_weights.py``:
      converted by :func:`unet_state_dict` (the model config's
      ``num_res_blocks``, ``channel_mult`` and attention downsampling rates
      name the blocks);
    - the port's own dotted state-dict names (``input_blocks.0.0.weight``), as
      ``np.savez(path, **{k: v.numpy() for k, v in model.state_dict().items()})``
      writes them.

    Keys starting with ``__`` are metadata and dropped. The reference's own
    ``.pt`` checkpoints are read by ``compat/torch_import.py::
    import_unet_checkpoint``, which also reorders their head-major attention
    qkv rows; save its model's state dict as above to sample from it here.
    """
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files if not k.startswith("__")}
    nested = [k for k in flat if "/" in k]
    if nested and len(nested) != len(flat):
        raise ValueError(f"{path} mixes '/'-joined flax keys and dotted state-dict keys")
    if nested:
        return unet_state_dict(flat, num_res_blocks, channel_mult, attention_ds)
    return {k: torch.from_numpy(np.ascontiguousarray(v, np.float32)) for k, v in flat.items()}


def stage2_state_from_arrays(
    arrays: Mapping[str, Any],
    num_res_blocks: int = 3,
    channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
    attention_ds: Sequence[int] = (8, 16, 32),
) -> Dict[str, Any]:
    """A JAX ``Stage2State`` as flat numpy arrays -> the port's checkpoint dict
    (``train/stage2.py::state_payload``'s layout, for ``restore_into``).

    Keys, as ``scripts/export_jax_weights.py --full_state`` writes them:
    ``step``; ``count`` (optax's AdamW update count); ``params/<flax path>``,
    ``mu/<flax path>`` and ``nu/<flax path>`` (the Adam moments, each a
    params-shaped tree); ``ema/<rate>/<flax path>``; and, with the
    loss-aware sampler, ``sampler/history`` and ``sampler/counts``.
    """
    groups: Dict[str, Dict[str, Any]] = {}
    for key, value in arrays.items():
        head, _, rest = key.partition("/")
        if rest:
            groups.setdefault(head, {})[rest] = value

    def sd(flat):
        return unet_state_dict(flat, num_res_blocks, channel_mult, attention_ds)

    ema: Dict[str, Dict[str, Any]] = {}
    for key, value in groups.get("ema", {}).items():
        rate, _, rest = key.partition("/")
        ema.setdefault(rate, {})[rest] = value
    sampler = groups.get("sampler")
    return {
        "step": int(arrays["step"]),
        "params": sd(groups["params"]),
        "ema_params": {rate: sd(flat) for rate, flat in ema.items()},
        "opt_state": {"mu": sd(groups["mu"]), "nu": sd(groups["nu"]),
                      "count": int(arrays["count"])},
        "sampler_state": None if sampler is None else {
            "history": torch.tensor(np.asarray(sampler["history"], np.float32)),
            "counts": torch.tensor(np.asarray(sampler["counts"], np.int32)),
        },
    }


def load_stage2_npz(path: str, num_res_blocks: int = 3,
                    channel_mult: Sequence[int] = (1, 1, 2, 2, 4, 4),
                    attention_ds: Sequence[int] = (8, 16, 32)) -> Dict[str, Any]:
    """:func:`stage2_state_from_arrays` of an npz file."""
    with np.load(path) as z:
        return stage2_state_from_arrays({k: z[k] for k in z.files}, num_res_blocks,
                                        channel_mult, attention_ds)


def stage1_state_from_arrays(arrays: Mapping[str, Any]) -> Dict[str, Any]:
    """A JAX Stage-1 ``TrainState`` as flat numpy arrays -> the port's
    checkpoint dict (``train/stage1.py::state_payload``'s layout, for
    ``restore_into``).

    Keys, as ``scripts/export_jax_weights.py --stage1`` writes them: ``step``;
    ``planes`` (N, L, 3, C3, D, D); the decoder under ``params/<layer>/<kernel
    or bias>`` (the ``save_decoder_npz`` names); ``planes_mu``, ``planes_nu``
    and ``planes_count``; and, unless the decoder was frozen,
    ``decoder_mu/params/...``, ``decoder_nu/params/...`` and
    ``decoder_count``.
    """
    from humanliff_tpu_torch.nerf.decoder import flatten_state_dict

    def decoder_flat(prefix: str) -> torch.Tensor:
        flat = {k[len(prefix):]: v for k, v in arrays.items() if k.startswith(prefix + "params/")}
        return flatten_state_dict(decoder_state_dict(flat))

    def planes(key: str) -> torch.Tensor:
        return torch.from_numpy(np.array(arrays[key], np.float32))

    opt: Dict[str, Any] = {"planes": {"mu": planes("planes_mu"), "nu": planes("planes_nu"),
                                      "count": int(arrays["planes_count"])},
                           "decoder": None}
    if "decoder_count" in arrays:
        opt["decoder"] = {"mu": decoder_flat("decoder_mu/"), "nu": decoder_flat("decoder_nu/"),
                          "count": int(arrays["decoder_count"])}
    return {"step": int(arrays["step"]), "planes": planes("planes"),
            "decoder": decoder_flat(""), "opt_state": opt}


def load_stage1_npz(path: str) -> Dict[str, Any]:
    """:func:`stage1_state_from_arrays` of an npz file."""
    with np.load(path) as z:
        return stage1_state_from_arrays({k: z[k] for k in z.files})
