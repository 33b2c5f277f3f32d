"""Key-value training logger (port of ``humanliff_tpu/utils/logger.py``;
reference improved_diffusion/logger.py).

``logkv`` collects an interval's values and ``dumpkvs`` writes them to every
sink: a table on stdout, ``progress.csv`` and ``progress.json`` (one JSON
object per line) under the log directory. The TensorBoard sink,
``logkv_mean``, ``profile_kv`` and the module-level logging functions have
no caller in the port and are not ported.
"""

from __future__ import annotations

import csv
import json
import os
import sys
from typing import Dict, List, Optional, TextIO


class _HumanSink:
    def __init__(self, f: TextIO):
        self.f = f

    def write(self, kvs: Dict[str, float], step: int):
        items = sorted(kvs.items())
        width = max((len(k) for k, _ in items), default=1)
        lines = [f"| {k.ljust(width)} | {v:<12.6g} |" for k, v in items]
        sep = "-" * (width + 20)
        self.f.write(f"{sep}\nstep {step}\n" + "\n".join(lines) + f"\n{sep}\n")
        self.f.flush()


class _JsonSink:
    def __init__(self, path: str):
        self.path = path

    def write(self, kvs: Dict[str, float], step: int):
        with open(self.path, "a") as f:
            f.write(json.dumps({"step": step, **kvs}) + "\n")


class _CsvSink:
    """A header of every key seen so far; a new key rewrites the file with a
    wider header and empty cells in the older rows."""

    def __init__(self, path: str):
        self.path = path
        self.keys: List[str] = []

    def write(self, kvs: Dict[str, float], step: int):
        new_keys = [k for k in kvs if k not in self.keys]
        if new_keys:
            self.keys += new_keys
            rows = []
            if os.path.exists(self.path):
                with open(self.path) as f:
                    rows = list(csv.reader(f))[1:]
            with open(self.path, "w", newline="") as f:
                w = csv.writer(f)
                w.writerow(["step"] + self.keys)
                for r in rows:
                    w.writerow(r + [""] * (len(self.keys) + 1 - len(r)))
        with open(self.path, "a", newline="") as f:
            csv.writer(f).writerow([step] + [kvs.get(k, "") for k in self.keys])


class KVLogger:
    def __init__(self, logdir: Optional[str] = None, formats: Optional[List[str]] = None):
        if logdir:
            os.makedirs(logdir, exist_ok=True)
        self.sinks = []
        for fmt in formats if formats is not None else ["stdout", "csv", "json"]:
            if fmt == "stdout":
                self.sinks.append(_HumanSink(sys.stdout))
            elif fmt == "json" and logdir:
                self.sinks.append(_JsonSink(os.path.join(logdir, "progress.json")))
            elif fmt == "csv" and logdir:
                self.sinks.append(_CsvSink(os.path.join(logdir, "progress.csv")))
            elif fmt not in ("json", "csv"):
                raise ValueError(f"unknown log format {fmt!r} (stdout, csv, json)")
        self._vals: Dict[str, float] = {}

    def logkv(self, key: str, value: float):
        self._vals[key] = float(value)

    def dumpkvs(self, step: int = 0) -> Dict[str, float]:
        out = dict(self._vals)
        for s in self.sinks:
            s.write(out, step)
        self._vals.clear()
        return out


def configure(logdir: Optional[str] = None, formats: Optional[List[str]] = None) -> KVLogger:
    """A logger writing to ``formats`` (default stdout, csv and json) under ``logdir``."""
    return KVLogger(logdir, formats)
