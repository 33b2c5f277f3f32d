"""Run a function on W Gloo ranks, each in a process of its own, for the
port's multi-rank tests on the CPU.

``run_ranks("module:function", W, tmp_path, **kwargs)`` starts W processes of
this file. Each joins a Gloo process group through a file store in
``tmp_path`` (so parallel test workers never share a port) with a 60 s
timeout on every collective, sets ``RANK``/``WORLD_SIZE``/``LOCAL_RANK`` as
torchrun does (a CLI's ``initialize_multihost`` then keeps that group), calls
``function(**kwargs)`` and pickles its result. The caller gets the results
in rank order. Every rank must finish by the deadline: past it the ranks'
process groups are killed and the test fails with their output, so a hung
collective fails its test and never stalls the suite.

The functions run in processes that import torch and the port only, not JAX
(``tests/torch_dist_cases.py``).
"""

from __future__ import annotations

import datetime
import os
import pickle
import signal
import subprocess
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
GROUP_TIMEOUT_S = 60


def run_ranks(target: str, world: int, tmp_path, timeout: float = 180.0,
              env_extra=None, **kwargs) -> list:
    """The results of ``target(**kwargs)`` on ranks 0..world-1."""
    import pytest

    tmp = str(tmp_path)
    store = os.path.join(tmp, f"store-{time.monotonic_ns()}")
    args_file = os.path.join(tmp, f"args-{os.path.basename(store)}.pkl")
    with open(args_file, "wb") as f:
        pickle.dump(kwargs, f)
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX_", "XLA_"))}
    env.update({"PYTHONPATH": os.pathsep.join([REPO, TESTS]), "OMP_NUM_THREADS": "1",
                "PYTHONUNBUFFERED": "1",
                "MKL_NUM_THREADS": "1", **(env_extra or {})})
    procs, outs, logs = [], [], []
    for r in range(world):
        outs.append(os.path.join(tmp, f"rank{r}-{os.path.basename(store)}.pkl"))
        logs.append(open(os.path.join(tmp, f"rank{r}-{os.path.basename(store)}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, __file__, target, str(r), str(world), store, args_file, outs[r]],
            stdout=logs[r], stderr=subprocess.STDOUT, cwd=REPO, env=env,
            start_new_session=True))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        for r, p in enumerate(procs):
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = f"rank {r} did not finish within {timeout} s"
                break
            if p.returncode != 0:
                failed = f"rank {r} exited with {p.returncode}"
                break
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
        text = []
        for r, f in enumerate(logs):
            f.seek(0)
            text.append(f"--- rank {r} ---\n{f.read()[-4000:]}")
            f.close()
    if failed:
        pytest.fail(failed + "\n" + "\n".join(text))
    results = []
    for path in outs:
        with open(path, "rb") as f:
            results.append(pickle.load(f))
    return results


def _worker(target: str, rank: int, world: int, store: str, args_file: str, out: str):
    import importlib

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    os.environ.update({"RANK": str(rank), "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank)})
    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    module, name = target.split(":")
    with open(args_file, "rb") as f:
        kwargs = pickle.load(f)
    result = getattr(importlib.import_module(module), name)(**kwargs)
    with open(out, "wb") as f:
        pickle.dump(result, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    _worker(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), *sys.argv[4:7])
