"""One-time converter: torch ``lpips`` VGG weights -> the plain npz of ``eval/lpips.py``
(the port's copy of ``humanliff_tpu/compat/lpips_import.py``; both packages
read the file it writes).

Run wherever the torch ``lpips`` package (and its cached VGG16 weights) exists:

    python -m humanliff_tpu_torch.compat.lpips_import --out assets/lpips_vgg.npz

The npz schema: ``conv{i}_w`` (kh, kw, cin, cout: HWIO, transposed from
torch's OIHW), ``conv{i}_b`` (cout,), and ``lin{l}`` (C,) for the five learned
channel weightings. Reference usage of the torch package:
recon_NeRF/lib/all_test.py:14,37-40.
"""

from __future__ import annotations

import argparse

import numpy as np


def convert(out_path: str) -> None:
    import lpips  # type: ignore

    net = lpips.LPIPS(net="vgg")
    arrays = {}

    convs = [m for m in net.net.slice1 + net.net.slice2 + net.net.slice3
             + net.net.slice4 + net.net.slice5
             if m.__class__.__name__ == "Conv2d"]
    for i, conv in enumerate(convs):
        w = conv.weight.detach().numpy()  # (out, in, kh, kw)
        arrays[f"conv{i}_w"] = np.transpose(w, (2, 3, 1, 0)).astype(np.float32)
        arrays[f"conv{i}_b"] = conv.bias.detach().numpy().astype(np.float32)

    for li, lin in enumerate(net.lins):
        w = lin.model[-1].weight.detach().numpy()  # (1, C, 1, 1)
        arrays[f"lin{li}"] = w.reshape(-1).astype(np.float32)

    np.savez_compressed(out_path, **arrays)
    print(f"wrote {out_path}: {len(arrays)} arrays")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--out", default="assets/lpips_vgg.npz")
    args = p.parse_args(argv)
    convert(args.out)


if __name__ == "__main__":
    main()
