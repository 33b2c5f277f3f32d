"""The port's collectives, over a :class:`~humanliff_tpu_torch.parallel.mesh.DataMesh`.

Only ``all_reduce``, ``broadcast`` and ``barrier`` are used: NCCL supports
them, and Gloo supports them on CPU and on CUDA tensors, where it has no
``all_gather`` or ``reduce_scatter``. So a gather is an ``all_reduce`` of a
zero-padded buffer (small tensors: ``x + 0`` is ``x``, so it is exact) or each
rank's part broadcast in turn (large ones). Every multi-rank module of the
port calls these and nothing else of ``torch.distributed``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from humanliff_tpu_torch.parallel.mesh import DataMesh


def all_reduce_(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Sum ``t`` over the mesh, in place."""
    dist.all_reduce(t, group=mesh.group)
    return t


def broadcast_(t: torch.Tensor, src: int, mesh: DataMesh) -> torch.Tensor:
    """``t`` made rank ``src``'s, in place."""
    if t.numel():
        dist.broadcast(t, src, group=mesh.group)
    return t


def barrier(mesh: Optional[DataMesh]) -> None:
    """Wait for every rank of the mesh (nothing for one process)."""
    if mesh is not None:
        dist.barrier(group=mesh.group)


def all_gather(t: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``t`` (the same shape on each) stacked along dim 0 in rank
    order, on every rank: an ``all_reduce`` of a zero buffer holding this
    rank's rows. For small tensors (indices, per-example losses, samples)."""
    n = t.shape[0]
    out = torch.zeros((mesh.size * n, *t.shape[1:]), dtype=t.dtype, device=t.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = t
    return all_reduce_(out, mesh)


def broadcast_ranges_(flat: torch.Tensor, ranges: Sequence[Tuple[int, int]],
                      mesh: DataMesh) -> torch.Tensor:
    """The all-gather of a flat buffer whose range ``ranges[r]`` rank r holds:
    each range broadcast in turn from its rank, in place."""
    for r, (lo, hi) in enumerate(ranges):
        broadcast_(flat[lo:hi], r, mesh)
    return flat


def gather_to_root(part: torch.Tensor, ranges: Sequence[Tuple[int, int]], numel: int,
                   mesh: DataMesh) -> Optional[torch.Tensor]:
    """The whole flat buffer, in host memory on rank 0 (None elsewhere), of
    which this rank holds ``part``, the range ``ranges[mesh.rank]``: each part
    broadcast in turn through a buffer of one part's size on the device, so
    no rank holds the whole buffer on its device."""
    size = max(hi - lo for lo, hi in ranges)
    scratch = torch.empty(size, dtype=part.dtype, device=part.device)
    out = torch.empty(numel, dtype=part.dtype) if mesh.rank == 0 else None
    for r, (lo, hi) in enumerate(ranges):
        buf = scratch[:hi - lo]
        if r == mesh.rank:
            buf.copy_(part.reshape(-1))
        broadcast_(buf, r, mesh)
        if out is not None:
            out[lo:hi] = buf.cpu()
    return out


def gather_rows_to_root(part: torch.Tensor, mesh: DataMesh) -> Optional[torch.Tensor]:
    """Every rank's ``part`` (the same shape on each) stacked along dim 0, in
    host memory on rank 0 (None elsewhere); the rows of a sharded table."""
    n = part.numel()
    flat = gather_to_root(part.contiguous(), [(r * n, (r + 1) * n) for r in range(mesh.size)],
                          n * mesh.size, mesh)
    return None if flat is None else flat.view(mesh.size * part.shape[0], *part.shape[1:])


def gather_rows(part: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """Every rank's ``part`` (the same shape on each) stacked along dim 0, on
    every rank's device: each rank's rows broadcast in turn (for tensors too
    large for :func:`all_gather`'s padded buffer)."""
    n, k = part.shape[0], part.numel()
    out = torch.empty((mesh.size * n, *part.shape[1:]), dtype=part.dtype, device=part.device)
    out[mesh.rank * n:(mesh.rank + 1) * n] = part
    broadcast_ranges_(out.view(-1), [(r * k, (r + 1) * k) for r in range(mesh.size)], mesh)
    return out


def sum_scalars(values: List[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    """Each 0-d tensor summed over the mesh (one ``all_reduce``)."""
    packed = all_reduce_(torch.stack([v.detach().float() for v in values]), mesh)
    return list(packed.unbind())
