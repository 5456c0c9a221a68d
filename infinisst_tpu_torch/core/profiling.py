"""Timing and tracing helpers; port of ``infinisst_tpu/core/profiling.py``.

- ``timed(name)``: a host wall timer that first waits for the CUDA work
  of the tensors in ``sync_on`` (RTF measurements);
- ``device_trace(logdir)``: a ``torch.profiler`` trace of the CPU and the
  CUDA activity, written into ``logdir`` as a Chrome trace;
- ``StepTimer``: per-phase totals, printed on demand.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def _devices(tree, out: set) -> set:
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            out.add(tree.device)
    elif isinstance(tree, dict):
        for v in tree.values():
            _devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _devices(v, out)
    return out


def block_until_ready(tree) -> None:
    """Wait for the CUDA devices of every tensor in ``tree`` (a tensor or
    a nested dict / list / tuple of them); a CPU tensor needs no wait."""
    for dev in _devices(tree, set()):
        torch.cuda.synchronize(dev)


@contextlib.contextmanager
def timed(name: str, sync_on=None, quiet: bool = False):
    t0 = time.perf_counter()
    yield
    if sync_on is not None:
        block_until_ready(sync_on)
    dt = time.perf_counter() - t0
    if not quiet:
        print(f"{name}: {dt:.4f} seconds")


@contextlib.contextmanager
def device_trace(logdir: str):
    """Profile the block with CPU and (where there is a card) CUDA
    activities; the Chrome trace lands in ``logdir/trace.json``."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class StepTimer:
    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def phase(self, name: str, sync_on=None):
        t0 = time.perf_counter()
        yield
        if sync_on is not None:
            block_until_ready(sync_on)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name, tot in sorted(self.totals.items()):
            n = self.counts[name]
            lines.append(
                f"{name}: total {tot*1e3:.1f} ms, n={n}, "
                f"mean {tot/n*1e3:.2f} ms"
            )
        return "\n".join(lines)
