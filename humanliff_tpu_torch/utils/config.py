"""Config/flag system (port of ``humanliff_tpu/utils/config.py``; reference
recon_NeRF/parser_config.py + configs/*.txt).

Same UX as configargparse: every flag settable on the CLI or in a ``--config`` file
of ``key = value`` lines (CLI wins). The canonical SynBody/TightCap defaults live in
``configs/`` at the repo root.

Differences from the JAX module: ``--device`` (``cuda`` or ``cpu``) is added,
and ``device_for`` turns it into a device for every CLI of the port;
``--dist_backend`` (``nccl`` or ``gloo``) picks the process group's backend
under ``torchrun`` (``parallel/mesh.py``);
``--triplane_ch`` refuses any width but 27 (``decoder_channels``);
``--dispatch_sync_every`` (a readback cadence for the JAX package's remote
TPU) is dropped, and like any unknown flag it is ignored
(``parse_known_args``).
"""

from __future__ import annotations

import argparse
from typing import Dict, List, Optional


def str2bool(v) -> bool:
    """argparse-safe bool: accepts true/false/1/0 (``type=str2bool`` would parse
    the literal string "false" as True)."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes"):
        return True
    if s in ("false", "0", "no", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected true/false, got {v!r}")


DECODER_CHANNELS = 27
_DECODER_CHANNELS_WHY = (
    "the port's NeRF decoder reads 27 plane channels only: the fused decoder kernel "
    "is built for 27 -> 128, PE(4) (nerf/decoder.py)")


def decoder_channels(value) -> int:
    """argparse type of ``--triplane_ch``: refuses any width but 27, with the
    reason (the JAX decoder takes any width)."""
    ch = int(value)
    if ch != DECODER_CHANNELS:
        raise argparse.ArgumentTypeError(f"got {ch}; {_DECODER_CHANNELS_WHY}")
    return ch


def _coerce(value: str):
    v = value.strip()
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


def read_config_file(path: str) -> Dict[str, object]:
    out: Dict[str, object] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            out[k.strip()] = _coerce(v)
    return out


def stage1_parser() -> argparse.ArgumentParser:
    """Stage-1 flags, names matching parser_config.py:3-107."""
    p = argparse.ArgumentParser("humanliff recon")
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--expname", type=str, default="exp")
    p.add_argument("--basedir", type=str, default="./logs")
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--data_set_type", type=str, default="SynBody",
                   choices=["SynBody", "TightCap", "synthetic"])
    p.add_argument("--train_split", type=str, default="train")
    p.add_argument("--multi_person", type=str2bool, default=True)
    p.add_argument("--num_instance", type=int, default=1)
    p.add_argument("--start", type=int, default=0)
    p.add_argument("--interval", type=int, default=1)
    p.add_argument("--poses_num", type=int, default=1)
    p.add_argument("--views_num", type=int, default=185)
    p.add_argument("--image_scaling", type=float, default=0.5)
    p.add_argument("--n_rand", type=int, default=2048)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--chunk", type=int, default=4096)
    p.add_argument("--n_samples", type=int, default=128)
    p.add_argument("--n_importance", type=int, default=128)
    p.add_argument("--perturb", type=float, default=1.0)
    p.add_argument("--white_bkgd", type=str2bool, default=False)
    p.add_argument("--lrate", type=float, default=5e-3)
    p.add_argument("--tri_plane_lrate", type=float, default=1e-1)
    p.add_argument("--lrate_decay", type=int, default=500)
    p.add_argument("--n_iteration", type=int, default=480000)
    p.add_argument("--triplane_dim", type=int, default=256)
    p.add_argument("--triplane_ch", type=decoder_channels, default=DECODER_CHANNELS)
    p.add_argument("--tv_loss", type=str2bool, default=True)
    p.add_argument("--tv_loss_coef", type=float, default=1e-4)
    p.add_argument("--l1_loss_coef", type=float, default=1e-4)
    p.add_argument("--use_clamp", type=str2bool, default=True)
    p.add_argument("--use_canonical_space", type=str2bool, default=False)
    p.add_argument("--smpl_type", type=str, default="smplx")
    p.add_argument("--synthetic_image_size", type=int, default=64,
                   help="synthetic benchmark: view resolution")
    p.add_argument("--synthetic_tight_bounds", type=str2bool, default=False,
                   help="synthetic benchmark: per-instance tight AABBs")
    p.add_argument("--smpl_model_path", type=str, default="assets/SMPL_NEUTRAL.pkl")
    p.add_argument("--smplx_model_dir", type=str, default="assets",
                   help="directory holding SMPLX_{GENDER}.npz/.pkl (SynBody)")
    p.add_argument("--ft_path", type=str, default=None)
    p.add_argument("--no_reload", type=str2bool, default=False)
    p.add_argument("--i_print", type=int, default=100)
    p.add_argument("--i_weights", type=int, default=10000)
    p.add_argument("--test", type=str2bool, default=False)
    p.add_argument("--test_layer_id", type=int, default=None)
    p.add_argument("--layer_idx", type=int, default=None)
    p.add_argument("--start_idx", type=int, default=0)
    p.add_argument("--end_idx", type=int, default=100)
    p.add_argument("--use_bf16", type=str2bool, default=False)
    p.add_argument("--device", type=str, default="cuda", choices=("cuda", "cpu"),
                   help="cuda raises where CUDA is missing; cpu runs on the CPU")
    p.add_argument("--dist_backend", type=str, default=None, choices=("nccl", "gloo"),
                   help="under torchrun: the process group's backend (default nccl on "
                        "cuda, gloo on the cpu); gloo lets ranks share a card")
    p.add_argument("--seed", type=int, default=0)
    return p


def parse_with_config(parser: argparse.ArgumentParser, argv: Optional[List[str]] = None):
    args, _ = parser.parse_known_args(argv)
    if getattr(args, "config", None):
        overrides = read_config_file(args.config)
        defaults = {a.dest: a.default for a in parser._actions}
        for k, v in overrides.items():
            if k in defaults and getattr(args, k) == defaults[k]:
                setattr(args, k, v)
        if getattr(args, "triplane_ch", DECODER_CHANNELS) != DECODER_CHANNELS:
            parser.error(f"triplane_ch = {args.triplane_ch} in {args.config}: "
                         f"{_DECODER_CHANNELS_WHY}")
    return args


def device_for(name: str):
    """The ``torch.device`` of a CLI's ``--device``: ``cuda`` raises where CUDA
    is missing (no fallback to the CPU)."""
    import torch

    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda, but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    return torch.device(name)


def print_args(args) -> None:
    for k in sorted(vars(args)):
        print(f"{k} = {getattr(args, k)}")
