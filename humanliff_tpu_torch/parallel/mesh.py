"""The data mesh over ``torch.distributed`` ranks (port of
``humanliff_tpu/parallel/mesh.py``; the reference's dist_util.py and its DDP
wraps, run_nerf_batch.py:114-118 and train_util.py:105-122).

JAX runs one process per host over all of the host's devices; PyTorch runs one
process per GPU under ``torchrun``
(``python -m torch.distributed.run --nproc_per_node N -m humanliff_tpu_torch.cli.<cli>``).
The counterpart of a ``jax.sharding.Mesh`` with one ``data`` axis is a
:class:`DataMesh`: this rank's index in the mesh, the mesh's size, the rank's
device and the mesh's process group.

- Batches shard on the mesh: rank r holds rows ``[r B/W, (r+1) B/W)`` of a
  global batch of B (:func:`shard_batch`).
- Stage 1's tri-plane table ``(N, L, 3, C3, D, D)`` shards by instance: rank r
  holds instances ``[r N/W, (r+1) N/W)`` and their Adam moments, the decoder
  replicates (:func:`shard_stage1_params`). A step gathers only the batch's
  slices and sends only their gradients back (``train/stage1.py``), where the
  reference all-reduces the whole table every step (SURVEY.md §2.3).
- Stage 2 replicates the parameters and all-reduces the gradients (DDP, the
  JAX package's ``data_parallel_jit``), or in addition splits the Adam moments
  and each EMA by offset range of the flat parameter buffer (ZeRO-1, JAX's
  ``stage2_zero_shardings`` / ``zero_parallel_jit``; :func:`zero_ranges`).
  JAX shards each leaf on its largest divisible axis; the port shards its one
  flat buffer by offset (``train/stage2.py``).

Collectives go through ``parallel/collectives.py``: ``all_reduce``,
``broadcast`` and ``barrier`` only, which NCCL and Gloo both support, Gloo on
CPU and on CUDA tensors.

Without ``WORLD_SIZE`` in the environment nothing here starts a process group
and every CLI runs as one process (``mesh`` None).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Callable, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The first ``size`` ranks of the process group. ``rank`` is this
    process's index in it (its global rank, since a mesh is always the first
    ranks); ``member`` is False for a rank outside a capped mesh, which then
    takes part in nothing and leaves. ``group`` None is the default group."""

    rank: int
    size: int
    device: torch.device
    group: Optional[object] = None
    member: bool = True

    def share(self, n: int) -> int:
        """Each rank's count of ``n`` rows split evenly; raises unless the mesh
        size divides ``n``."""
        if n % self.size:
            raise ValueError(f"{n} rows do not divide over the {self.size}-rank mesh")
        return n // self.size

    def rows(self, n: int) -> slice:
        """This rank's rows of ``n`` rows split evenly (:meth:`share`)."""
        per = self.share(n)
        return slice(self.rank * per, (self.rank + 1) * per)


def resolve_backend(device_type: str, backend: Optional[str], local_rank: int,
                    n_cuda: int) -> Tuple[str, torch.device]:
    """The backend and this rank's device. ``nccl`` for CUDA and ``gloo`` for
    the CPU unless ``backend`` says otherwise; ``gloo`` on CUDA lets ranks share
    a card (rank ``LOCAL_RANK % device_count``), while NCCL needs one card per
    rank and refuses a ``LOCAL_RANK`` past the cards."""
    if device_type == "cpu":
        if backend not in (None, "gloo"):
            raise ValueError(f"--dist_backend {backend} cannot run on the CPU; use gloo")
        return "gloo", torch.device("cpu")
    if device_type != "cuda":
        raise ValueError(f"unknown device {device_type!r}")
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown --dist_backend {backend!r} (nccl, gloo)")
    if n_cuda == 0:
        raise RuntimeError("--device cuda, but CUDA is not available; "
                           "pass --device cpu to run on the CPU")
    if local_rank >= n_cuda and backend == "nccl":
        raise RuntimeError(f"LOCAL_RANK {local_rank} has no card of its own ({n_cuda} "
                           "visible); NCCL needs one card per rank (--dist_backend gloo "
                           "lets ranks share a card)")
    return backend, torch.device("cuda", local_rank % n_cuda)


def initialize_multihost(device: str = "cuda", backend: Optional[str] = None,
                         timeout_s: Optional[float] = None) -> Optional[torch.device]:
    """Join the process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``: the
    reference's contract, run_nerf_batch.py:163-173) and return this rank's
    device. A no-op returning None when ``WORLD_SIZE`` is unset; at
    ``WORLD_SIZE=1`` the group is still made. A process that is in a group
    already keeps it. A failed init raises: no other backend is tried."""
    env = os.environ
    if "WORLD_SIZE" not in env:
        return None
    rank, world = int(env["RANK"]), int(env["WORLD_SIZE"])
    local_rank = int(env.get("LOCAL_RANK", rank))
    n_cuda = torch.cuda.device_count() if device == "cuda" else 0
    if dist.is_initialized():
        backend = dist.get_backend()
        if dist.get_world_size() != world or dist.get_rank() != rank:
            raise RuntimeError(f"process group of rank {dist.get_rank()}/"
                               f"{dist.get_world_size()}, environment says {rank}/{world}")
        return resolve_backend(device, backend, local_rank, n_cuda)[1]
    backend, dev = resolve_backend(device, backend, local_rank, n_cuda)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kwargs = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            **kwargs)
    return dev


def make_mesh(n_devices: Optional[int] = None,
              device: Optional[torch.device] = None) -> DataMesh:
    """A mesh over the first ``n_devices`` ranks (default: all). Every rank of
    the group must call it (``new_group`` is collective); a rank past
    ``n_devices`` gets a mesh with ``member`` False. Without a process group:
    the one-rank mesh of this process."""
    device = torch.device(device) if device is not None else (
        torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available()
        else torch.device("cpu"))
    if not dist.is_initialized():
        return DataMesh(rank=0, size=1, device=device)
    world, rank = dist.get_world_size(), dist.get_rank()
    n = world if n_devices is None else max(1, min(int(n_devices), world))
    group = None if n == world else dist.new_group(ranks=list(range(n)))
    return DataMesh(rank=rank if rank < n else -1, size=n, device=device, group=group,
                    member=rank < n)


def cli_mesh(device_name: str, backend: Optional[str],
             size: Optional[Callable[[int], int]] = None,
             capped: str = "") -> Tuple[torch.device, Optional[DataMesh]]:
    """The device and mesh of a CLI: ``(device, None)`` without ``WORLD_SIZE``
    (one process, as before), else this rank's device and a mesh of
    ``size(world size)`` ranks (default all). A capped
    mesh prints JAX's "mesh capped" message, ``capped`` giving the reason; a
    rank outside it gets a mesh with ``member`` False, and the CLI leaves (a
    divergence from JAX, whose one process leaves the devices past the cap
    idle)."""
    from humanliff_tpu_torch.utils.config import device_for

    dev = initialize_multihost(device_name, backend)
    if dev is None:
        return device_for(device_name), None
    world = dist.get_world_size()
    n = world if size is None else size(world)
    if n != world and dist.get_rank() == 0:
        print(f"mesh capped to {n}/{world} devices{': ' + capped if capped else ''}")
    mesh = make_mesh(n, dev)
    if not mesh.member:
        print(f"rank {dist.get_rank()} is outside the {n}-rank mesh: leaving")
    return dev, mesh


def is_root(mesh: Optional[DataMesh]) -> bool:
    """Whether this process writes the run's files: one process, or rank 0."""
    return mesh is None or mesh.rank == 0


def shard_batch(batch: Dict[str, torch.Tensor], mesh: DataMesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of a global batch (every leading axis split evenly)."""
    return {k: v[mesh.rows(v.shape[0])] for k, v in batch.items()}


def replicate(tensors: List[torch.Tensor], mesh: DataMesh) -> List[torch.Tensor]:
    """Every tensor made equal to rank 0's, in place."""
    from humanliff_tpu_torch.parallel import collectives as coll

    for t in tensors:
        coll.broadcast_(t, 0, mesh)
    return tensors


def instance_range(num_instances: int, mesh: DataMesh) -> Tuple[int, int]:
    """The instances ``[lo, hi)`` of the table this rank holds; raises unless
    the mesh size divides the instance count."""
    if num_instances % mesh.size:
        raise ValueError(f"{num_instances} instances do not divide over the {mesh.size}-rank "
                         f"mesh; choose a mesh size that divides {num_instances}")
    per = num_instances // mesh.size
    return mesh.rank * per, (mesh.rank + 1) * per


def shard_stage1_params(params: Dict[str, torch.Tensor], mesh: DataMesh
                        ) -> Dict[str, torch.Tensor]:
    """This rank's instance slice of the tri-plane table (a copy, so the full
    table can be freed) and the decoder, replicated."""
    lo, hi = instance_range(params["planes"].shape[0], mesh)
    return {"planes": params["planes"][lo:hi].clone(), "decoder": params["decoder"]}


def zero_ranges(numel: int, size: int) -> List[Tuple[int, int]]:
    """ZeRO-1's offset range of each rank in a flat buffer of ``numel``: the
    buffer padded to a multiple of ``size`` and cut evenly (the last range
    ends at ``numel``, and may be empty)."""
    per = -(-numel // size)
    return [(min(r * per, numel), min((r + 1) * per, numel)) for r in range(size)]
