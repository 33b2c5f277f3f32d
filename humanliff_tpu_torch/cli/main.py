"""Unified CLI dispatcher of the port (port of ``humanliff_tpu/cli/main.py``):

    humanliff-torch <command> [args]
    python -m humanliff_tpu_torch.cli.main <command> [args]

The JAX dispatcher's command names, each running the port's module. With no
command or an unknown one it prints the list and exits 1; with ``-h`` or
``--help``, 0. A command's own exit is 0 unless it raises.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "recon-train": "humanliff_tpu_torch.cli.recon_train",
    "recon-ft": "humanliff_tpu_torch.cli.recon_ft",
    "recon-test": "humanliff_tpu_torch.cli.recon_test",
    "diff-train": "humanliff_tpu_torch.cli.diff_train",
    "diff-sample": "humanliff_tpu_torch.cli.diff_sample",
    "image-nll": "humanliff_tpu_torch.cli.image_nll",
    "image-sample": "humanliff_tpu_torch.cli.image_sample",
    "sr-train": "humanliff_tpu_torch.cli.sr_train",
    "sr-sample": "humanliff_tpu_torch.cli.sr_sample",
    "quality-eval": "humanliff_tpu_torch.cli.quality_eval",
    "quality-stage2": "humanliff_tpu_torch.cli.quality_stage2",
    "bench-decode": "humanliff_tpu_torch.cli.bench_decode",
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help") or argv[0] not in COMMANDS:
        print("usage: humanliff-torch <command> [args]\ncommands:")
        for c in COMMANDS:
            print(f"  {c}")
        return 0 if argv and argv[0] in ("-h", "--help") else 1
    importlib.import_module(COMMANDS[argv[0]]).main(argv[1:])
    return 0


if __name__ == "__main__":
    sys.exit(main())
