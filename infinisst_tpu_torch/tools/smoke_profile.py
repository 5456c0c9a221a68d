"""Where ``chip_smoke.py``'s wall time goes: its ``main`` under a sampling
profiler of the main thread.

    python -m infinisst_tpu_torch.tools.smoke_profile [--out PATH] [--period S]

Runs ``chip_smoke.py`` (from the repository root) as it runs alone, and
every ``--period`` seconds records, for the phase running then (its
``phase`` label), each ``chip_smoke.py`` function on the main thread's
stack, the innermost ``chip_smoke.py`` line and the innermost line of the
repository.  The counts times the period are wall seconds, waits on the
card and on other processes included.  ``--out`` (JSON) is rewritten
every 30 s and at exit, so a run cut short keeps what it saw.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import importlib.util
import json
import os
import sys
import threading
import time

THIS = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


class Sampler:
    """Samples one thread's stack; counts by (phase, frame)."""

    def __init__(self, thread_id: int, period: float):
        self.thread_id, self.period = thread_id, period
        self.phase = "(before the first phase)"
        self.by_function = collections.Counter()
        self.by_line = collections.Counter()
        self.innermost = collections.Counter()
        self.stopped = threading.Event()

    def sample(self):
        frame = sys._current_frames().get(self.thread_id)
        phase, functions = self.phase, set()
        first_line = first_repo = None
        while frame is not None:
            path = os.path.abspath(frame.f_code.co_filename)
            if path.startswith(ROOT + os.sep) and path != THIS:
                rel = os.path.relpath(path, ROOT)
                where = f"{rel}:{frame.f_code.co_name}:{frame.f_lineno}"
                first_repo = first_repo or where
                if rel == "chip_smoke.py":
                    first_line = first_line or where
                    functions.add(frame.f_code.co_name)
            frame = frame.f_back
        for name in functions:
            self.by_function[(phase, name)] += 1
        if first_line:
            self.by_line[(phase, first_line)] += 1
        if first_repo:
            self.innermost[(phase, first_repo)] += 1

    def run(self):
        while not self.stopped.wait(self.period):
            self.sample()

    def report(self) -> dict:
        def table(counts):
            return [[phase, where, round(n * self.period, 2)]
                    for (phase, where), n in counts.most_common()]
        phases = collections.Counter()
        for (phase, name), n in self.by_function.items():
            if name == "main":
                phases[phase] += n
        return {"period_s": self.period,
                "phases": table(collections.Counter(
                    {(p, ""): n for p, n in phases.items()})),
                "by_function": table(self.by_function),
                "by_line": table(self.by_line),
                "innermost": table(self.innermost)}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=os.path.join(
        ROOT, "chiprun_out", "smoke_profile.json"))
    ap.add_argument("--period", type=float, default=0.2)
    args = ap.parse_args(argv)

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    sampler = Sampler(threading.get_ident(), args.period)
    phase = smoke.phase

    @contextlib.contextmanager
    def labelled(label):
        sampler.phase = label
        with phase(label):
            yield
        sampler.phase = f"(after {label})"

    def dump():
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(sampler.report(), f, indent=0)

    def every_30_s():
        while not sampler.stopped.wait(30):
            dump()

    smoke.phase = labelled
    threading.Thread(target=sampler.run, daemon=True).start()
    threading.Thread(target=every_30_s, daemon=True).start()
    t0 = time.perf_counter()
    try:
        smoke.main()
    finally:
        sampler.stopped.set()
        dump()
        print(f"[smoke_profile] {time.perf_counter() - t0:.1f} s sampled "
              f"into {args.out}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
