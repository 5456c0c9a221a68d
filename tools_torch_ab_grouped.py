#!/usr/bin/env python3
"""The grouped W8A8 pair of two checkouts of the port on one card, in turns.

    python3 tools_torch_ab_grouped.py A_DIR [B_DIR]    # B_DIR defaults to .

Times ``w8a8_grouped_gemm`` (groups of 128, bf16) at every main-path shape
of ``chip_smoke.py`` (TABLE_M x TABLE_DO) and ``group_quant_int8`` at
D = 4096 and 14336, from checkout A, then B, B, A, each in its own process
that builds that checkout's kernels into its own ``build/``.  A checkout
whose wrapper takes the weight as ``w_q`` gets it (D, O), one that takes
``w_t`` gets it K-major (O, D).  Every result is checked bitwise against
that checkout's plain version before it is timed.  Times are device ms
per call as ``chip_smoke.py`` measures them (median of five timed replays
of a CUDA graph, weights past the 50 MB L2).  Prints one line per kernel
and shape with the four times and B's mean over A's, then the card's name
and power limit.  Compare checkouts only within one such call: two calls
may land on different cards.  Needs one CUDA card.
"""

from __future__ import annotations

import os
import subprocess
import sys

RUN = r"""
import inspect, math, statistics, sys
import torch
sys.path.insert(0, '.')
import chip_smoke as C
from infinisst_tpu_torch.kernels import quant_matmul as K

dev = torch.device('cuda', 0)
kmajor = 'w_t' in inspect.signature(K.w8a8_grouped_gemm).parameters
gen = torch.Generator(device=dev).manual_seed(1)
GS = 128
for D, O in C.TABLE_DO:
    n_w = max(1, math.ceil(120e6 / (D * O)))
    ws = [torch.randint(-127, 128, (O, D) if kmajor else (D, O), generator=gen,
                        device=dev, dtype=torch.int8) for _ in range(n_w)]
    sg = torch.rand((D // GS, O), generator=gen, device=dev) * 1e-3 + 1e-4
    for M in C.TABLE_M:
        y = (torch.randn((M, D), generator=gen, device=dev) * 2.0).to(
            torch.bfloat16)
        gq, gs_ = K.group_quant_int8(y, GS)
        pq, ps = K.group_quant_int8_plain(y, GS)
        out = K.w8a8_grouped_gemm(gq, gs_, ws[0], sg, torch.bfloat16)
        ref = K.w8a8_grouped_gemm_plain(gq, gs_, ws[0], sg, torch.bfloat16)
        torch.cuda.synchronize()
        if not (torch.equal(gq, pq) and torch.equal(gs_, ps)
                and torch.equal(out, ref)):
            sys.exit(f'not bitwise at M={M} D={D} O={O}')
        t = statistics.median(C.cuda_time_ms(
            lambda i: K.w8a8_grouped_gemm(gq, gs_, ws[i % n_w], sg,
                                          torch.bfloat16), 20))
        print(f'RESULT w8a8_grouped_gemm M={M} D={D} O={O} {t}', flush=True)
        if O == C.TABLE_DO[0][1] or D == 14336:
            t = statistics.median(C.cuda_time_ms(
                lambda i: K.group_quant_int8(y, GS), 50))
            print(f'RESULT group_quant_int8 M={M} D={D} {t}', flush=True)
    del ws
    torch.cuda.empty_cache()
"""


def run(tag, path):
    out = subprocess.run([sys.executable, "-c", RUN], cwd=path,
                         capture_output=True, text=True, timeout=900)
    if out.returncode:
        print(out.stdout[-4000:] + out.stderr[-4000:], flush=True)
        sys.exit(f"[{tag}] {path} failed with exit code {out.returncode}")
    times = {}
    for ln in out.stdout.splitlines():
        if ln.startswith("RESULT "):
            *key, t = ln.split()[1:]
            times[" ".join(key)] = float(t)
    print(f"[{tag}] {path}: {len(times)} timings", flush=True)
    return times


def main():
    if len(sys.argv) not in (2, 3):
        sys.exit(__doc__)
    a = os.path.abspath(sys.argv[1])
    b = os.path.abspath(sys.argv[2] if len(sys.argv) == 3 else ".")
    a1, b1, b2, a2 = run("A1", a), run("B1", b), run("B2", b), run("A2", a)
    print(f"{'kernel and shape':44s} {'A1':>9s} {'B1':>9s} {'B2':>9s} "
          f"{'A2':>9s} {'B/A':>7s}")
    for key in a1:
        ta, tb = (a1[key] + a2[key]) / 2, (b1[key] + b2[key]) / 2
        print(f"{key:44s} {a1[key]:9.5f} {b1[key]:9.5f} {b2[key]:9.5f} "
              f"{a2[key]:9.5f} {tb / ta:7.3f}", flush=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)


if __name__ == "__main__":
    main()
