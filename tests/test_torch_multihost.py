"""The port's ``parallel/mesh.py::initialize_multihost``, the counterpart of
``tests/test_multihost.py``: a no-op without ``WORLD_SIZE``; two real
processes joining one Gloo group through torchrun's environment contract
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``)
and summing across it, one of them then outside a capped mesh; the backend
and device rules; and no second try after a failed init."""

import os
import signal
import socket
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from humanliff_tpu_torch.parallel import mesh as pmesh

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import torch
from humanliff_tpu_torch.parallel import collectives as coll
from humanliff_tpu_torch.parallel.mesh import initialize_multihost, make_mesh

dev = initialize_multihost("cpu", timeout_s=60)
mesh = make_mesh(device=dev)
total = coll.all_reduce_(torch.tensor([mesh.rank + 1.0]), mesh)
capped = make_mesh(1, dev)
one = coll.all_reduce_(torch.ones(1), capped) if capped.member else None
print("RESULT", dev, mesh.rank, mesh.size, float(total), capped.member,
      None if one is None else float(one), flush=True)
coll.barrier(mesh)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_no_op_without_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert pmesh.initialize_multihost("cpu") is None
    assert not dist.is_initialized()
    mesh = pmesh.make_mesh(device="cpu")  # no process group: this process alone
    assert (mesh.rank, mesh.size, mesh.member, mesh.group) == (0, 1, True, None)


def test_two_ranks_through_the_env_contract():
    port = _free_port()
    procs = []
    for rank in (0, 1):
        env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
        env.update({"RANK": str(rank), "WORLD_SIZE": "2", "LOCAL_RANK": str(rank),
                    "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                    "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"})
        procs.append(subprocess.Popen([sys.executable, "-c", _WORKER], cwd=REPO, env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True, start_new_session=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120)[0])
    except subprocess.TimeoutExpired:
        pytest.fail(f"a rank did not finish within 120 s; output so far: {outs}")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, out
        line = [ln for ln in out.splitlines() if ln.startswith("RESULT")][0].split()
        # 1 + 2: the sum crossed the processes; rank 1 is outside the 1-rank mesh.
        assert line[1:] == ["cpu", str(rank), "2", "3.0", str(rank == 0),
                            "1.0" if rank == 0 else "None"], out


@pytest.mark.parametrize("device,backend,local_rank,n_cuda,want", [
    ("cpu", None, 0, 0, ("gloo", "cpu")),
    ("cpu", "nccl", 0, 0, "cannot run on the CPU"),
    ("cuda", None, 1, 2, ("nccl", "cuda:1")),
    ("cuda", None, 1, 1, "NCCL needs one card per rank"),
    ("cuda", "gloo", 3, 2, ("gloo", "cuda:1")),
    ("cuda", None, 0, 0, "CUDA is not available"),
])
def test_backend_and_device_rules(device, backend, local_rank, n_cuda, want):
    if isinstance(want, str):
        with pytest.raises((ValueError, RuntimeError), match=want):
            pmesh.resolve_backend(device, backend, local_rank, n_cuda)
    else:
        got = pmesh.resolve_backend(device, backend, local_rank, n_cuda)
        assert (got[0], str(got[1])) == want


def test_a_failed_init_raises_and_is_not_retried(monkeypatch):
    calls = []

    def refuse(backend, **kwargs):
        calls.append(backend)
        raise RuntimeError("the store refused the connection")

    monkeypatch.setattr(dist, "init_process_group", refuse)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    for k, v in {"RANK": "0", "WORLD_SIZE": "2", "LOCAL_RANK": "0",
                 "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    with pytest.raises(RuntimeError, match="refused"):
        pmesh.initialize_multihost("cpu")
    assert calls == ["gloo"]


def test_cli_mesh_without_world_size_is_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    device, mesh = pmesh.cli_mesh("cpu", None)
    assert device == torch.device("cpu") and mesh is None
