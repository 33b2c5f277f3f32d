"""Mesh writers (port of ``humanliff_tpu/mesh/io.py``): binary PLY, the
reference's export format (shape_utils.py), and OBJ (SynBody_dataset.py:19-36).
numpy only."""

from __future__ import annotations

import numpy as np

_FACE = np.dtype([("n", np.uint8), ("idx", np.int32, (3,))])


def write_ply(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    """Binary little-endian PLY with float32 vertices and int32 face indices."""
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tris, np.int32)
    header = (
        "ply\n"
        "format binary_little_endian 1.0\n"
        f"element vertex {len(verts)}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {len(tris)}\n"
        "property list uchar int vertex_indices\n"
        "end_header\n"
    )
    faces = np.empty(len(tris), dtype=_FACE)
    faces["n"] = 3
    faces["idx"] = tris
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(verts.tobytes())
        f.write(faces.tobytes())


def read_ply(path: str):
    """(verts, tris) of a file :func:`write_ply` wrote."""
    with open(path, "rb") as f:
        header = b""
        while not header.endswith(b"end_header\n"):
            line = f.readline()
            if not line:
                raise ValueError(f"{path}: no end_header")
            header += line
        lines = header.decode("ascii").splitlines()
        nv = int(next(l for l in lines if l.startswith("element vertex")).split()[-1])
        nt = int(next(l for l in lines if l.startswith("element face")).split()[-1])
        verts = np.frombuffer(f.read(nv * 12), np.float32).reshape(nv, 3)
        faces = np.frombuffer(f.read(nt * _FACE.itemsize), _FACE)
        return verts, faces["idx"].copy()


def write_obj(path: str, verts: np.ndarray, tris: np.ndarray) -> None:
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for t in tris:
            f.write(f"f {t[0] + 1} {t[1] + 1} {t[2] + 1}\n")
