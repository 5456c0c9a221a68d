#!/usr/bin/env python3
"""Bring-up check of the PyTorch/CUDA port (``infinisst_tpu_torch``) on one
NVIDIA H100.

    python3 chip_smoke.py            # all phases, one card

Phases (any failure exits non-zero; no phase carries on past its own):
  1. device   -- require CUDA; print the card's name and power limit.
  2. build    -- build every kernel source (csrc/*.cu) for sm_90a, one
                 nvcc per source, all started together.
  3. kernels  -- each kernel against its plain PyTorch version on the card
                 at every main-path shape: row_quant_int8, w8a8_gemm (on
                 its K-major (O, D) weight, in bf16 and float32),
                 group_quant_int8 and w8a8_grouped_gemm bitwise,
                 w8_bf16_gemm (on the same K-major weight) within
                 W8_BF16_RTOL * max|plain| in bf16 and 1e-5 * max|plain|
                 in float32; kernel, plain and library times (median of 5
                 timed replays, with the kernel's min-max) and the bound;
                 the split-K plan both tensor-core GEMMs take beside their
                 times (one row tile at every M); row_quant_int8 beside an
                 empty kernel of its launch geometry (the launch floor).
                 The library yardsticks,
                 timed here and never called by the port: torch._int_mm
                 (the int32 product alone, M > 16 only, with the kernel /
                 _int_mm ratio) beside w8a8_gemm,
                 torch._weight_int8pack_mm (on the same (O, D) weight)
                 beside w8_bf16_gemm; none for the grouped pair (no single
                 PyTorch call computes it).
  4. attention -- decode_attention against its plain version at the beam
                 step's two blocks and at decode_attention_batched's pooled
                 shapes, within ATT_RTOL; times as in phase 3, with
                 F.scaled_dot_product_attention (enable_gqa) over keys
                 rotated beforehand as the library yardstick.
  5. tiny     -- a tiny speech-LLM on the card against the same model on
                 the CPU (plain versions): float32 and W8A8 prefill logits
                 within 1e-4 * max|logits|, and the W8A8 agent's tokens
                 equal in every chunk.
  6. flagship -- wav2vec2-large + Llama-3.1-8B, W8A8 projections and
                 lm_head, m=1, beam 4: streams until the encoder ring has
                 wrapped and the LLM cache was evicted; per-chunk wall
                 time, RTF and valid_len; launch counts checked per
                 forward pass (w8a8_gemm 7L + 1, row_quant_int8 4L + 1:
                 q/k/v and gate/up share one quantized input), printed
                 beside what the wrappers did besides launching (split-K
                 calls, fills of the kernels' tile counters); then one
                 chunk with a synchronise around each stage (wall ms per
                 stage) and one under torch.profiler (device time by
                 kernel and by stage, idle share).
  7. weight-only -- three chunks of the 8B model with {'q_kmajor','scale'}
                 projections through w8_bf16_gemm, then one chunk under
                 torch.profiler.
  8. group128 -- three chunks of the 8B model as ``bench.py --group128``
                 makes it: grouped (128-wide) W8A8 projections through
                 w8a8_grouped_gemm (group_quant_int8 4L per forward),
                 per-channel W8A8 lm_head.
  9. one JSON ``kernels`` line, then the card line, then the result line.

Weights are random, made on the card from seeded torch.Generators.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import importlib
import json
import math
import os
import statistics
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM
INT8_OPS_PER_S = 1979e12
BF16_FLOPS_PER_S = 989e12

# (D, O) of every W8A8 projection and the padded lm_head at the flagship
# geometry; M = 1, 4 beam rows, 61 / 79 prefill rows
TABLE_DO = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
            (4096, 128512)]
TABLE_M = [1, 4, 61, 79]
REPORT_SHAPE = (4, 4096, 14336)  # the kernels line: a beam-step gate/up
GROUP = 128  # bench.py --group128
W8_BF16_RTOL = 1e-2  # of max|plain|: f32 summation order, then bf16 rounding
# decode attention, of max|plain|: the kernel sums in f32 in another order
# (key splits merged by their lse, other cos/sin and FMA contractions), so
# a bf16 output may round one bf16 step (<= 2**-7 of its value) apart;
# float32 outputs and the f32 lse agree to 1e-5
ATT_RTOL = {"bf16": 2.0 ** -7, "f32": 1e-5}
SOURCES = ("quant_matmul", "decode_attention")
# tiny prefill logits, card against CPU, as a share of max|logits|: the
# card sums float32 in another order (readings on the H100: 2.6e-6 with
# float32 weights, 1.3e-6 with W8A8); TF32 is off (see main)
TINY_RTOL = 1e-4
TIMED_TRIALS = 5


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, warmup: int = 2) -> list:
    """Device milliseconds per call of ``fn(i)``, sorted, one per timed
    replay: ``reps`` calls are captured in one CUDA graph and each of
    ``TIMED_TRIALS`` replays is timed with CUDA events, so the host's cost
    of launching (Python, ctypes) is not in the time."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(warmup):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(reps):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TIMED_TRIALS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return sorted(times)


def _sync(dev):
    import torch

    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def bound_ms(nbytes: float, ops: float, rate: float):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def plan_line(K, M, D, O, sms):
    """Print and return the split-K plan both tensor-core GEMMs take."""
    plan = K.gemm_plan(M, D, O, sms)
    print(f"  {'':17s} plan: {plan.rows} rows a tile x {plan.n_mtiles} row "
          f"tile(s), {plan.n_split} split(s) of {plan.k_split} values of D, "
          f"{plan.n_mtiles * plan.n_otiles * plan.n_split} blocks",
          flush=True)
    return plan


def _kernel_modules():
    from infinisst_tpu_torch.kernels import decode_attention as A
    from infinisst_tpu_torch.kernels import quant_matmul as K

    return K, A


def reset_counts():
    for m in _kernel_modules():
        m.reset_launch_counts()


def launch_counts() -> dict:
    out = {}
    for m in _kernel_modules():
        out.update(m.launch_counts)
    return out


def internal_counts() -> dict:
    """What the wrappers did besides their one launch a call: split-K
    calls of w8a8_gemm and fills of the kernels' tile counters."""
    K, _ = _kernel_modules()
    return dict(K.internal_counts)


class Notes:
    """Per kernel: the largest error against the plain version, and the
    timings and bound of each shape."""

    def __init__(self):
        self.rows = {}

    def note(self, name, shape, err, ms, plain_ms, lib_ms, bms, by,
             label=None, floor_ms=None):
        """``ms``, ``plain_ms``, ``lib_ms`` and ``floor_ms`` (an empty
        kernel's launch, where given) are cuda_time_ms lists (or None for
        no library call); the medians are kept."""
        med = statistics.median
        lib = None if lib_ms is None else med(lib_ms)
        r = self.rows.setdefault(name, {"err": 0.0, "shapes": {}})
        r["err"] = max(r["err"], err)
        r["shapes"][shape] = dict(ms=med(ms), plain_ms=med(plain_ms),
                                  library_ms=lib, bound_ms=bms, bound_by=by)
        floor = ""
        if floor_ms is not None:
            r["shapes"][shape]["launch_floor_ms"] = med(floor_ms)
            floor = (f" launch_floor_ms={med(floor_ms):.5f} (kernel / floor "
                     f"{med(ms) / med(floor_ms):.3f})")
        lib = "null" if lib is None else f"{lib:.5f}"
        label = label or (f"M={shape[0]:3d} D={shape[1]:5d} "
                          f"O={shape[2]:6d}")
        print(f"  {name:17s} {label} max_abs_err={err:.3e} ms={med(ms):.5f} "
              f"[{ms[0]:.5f}-{ms[-1]:.5f}] plain_ms={med(plain_ms):.5f} "
              f"library_ms={lib} bound_ms={bms:.5f} ({by}){floor}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 3


def check_kernels(dev, notes):
    import torch

    from infinisst_tpu_torch.kernels import quant_matmul as K

    gen = torch.Generator(device=dev).manual_seed(1)
    note = notes.note
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    for D, O in TABLE_DO:
        wbytes = D * O
        # enough weight copies to exceed the 50 MB L2: the main path reads
        # each layer's weight cold
        n_w = max(1, math.ceil(120e6 / wbytes))
        ws = [torch.randint(-127, 128, (D, O), generator=gen, device=dev,
                            dtype=torch.int8) for _ in range(n_w)]
        # K-major (O, D) copies, packed once: w8a8_gemm's layout, and the
        # one the library's weight-only int8 matmul takes
        wts = [w.t().contiguous() for w in ws]
        s = torch.rand((O,), generator=gen, device=dev) * 1e-3 + 1e-4
        G = D // GROUP
        sg = torch.rand((G, O), generator=gen, device=dev) * 1e-3 + 1e-4
        for M in TABLE_M:
            y = (torch.randn((M, D), generator=gen, device=dev) * 2.0
                 ).to(torch.bfloat16)
            w = ws[0]
            # row_quant_int8 (one D per row count; time at O's first visit)
            yq, ys = K.row_quant_int8(y)
            pq, ps = K.row_quant_int8_plain(y)
            if not (torch.equal(yq, pq) and torch.equal(ys, ps)):
                fail(f"row_quant_int8 differs from its plain version at "
                     f"M={M} D={D}")
            if O == TABLE_DO[0][1] or D == 14336:
                ms = cuda_time_ms(lambda i: K.row_quant_int8(y), 50)
                pms = cuda_time_ms(lambda i: K.row_quant_int8_plain(y), 20)
                # the launch floor: an empty kernel of the same geometry
                rp = K.row_quant_plan(M, D, 2)
                fms = cuda_time_ms(
                    lambda i: K.launch_empty(dev, rp.vpt * M, rp.threads),
                    50)
                bms, by = bound_ms(M * D * 2 + M * D + M * 4, 0, 1.0)
                note("row_quant_int8", (M, D, 0), 0.0, ms, pms, None, bms, by,
                     floor_ms=fms)

            # w8a8_gemm on the K-major weight: bitwise against the plain
            # version
            out = K.w8a8_gemm(yq, ys, wts[0], s, torch.bfloat16)
            ref = K.w8a8_gemm_plain(yq, ys, wts[0], s, torch.bfloat16)
            out32 = K.w8a8_gemm(yq, ys, wts[0], s, torch.float32)
            ref32 = K.w8a8_gemm_plain(yq, ys, wts[0], s, torch.float32)
            torch.cuda.synchronize()
            if not (torch.equal(out, ref) and torch.equal(out32, ref32)):
                err = max((out.float() - ref.float()).abs().max().item(),
                          (out32 - ref32).abs().max().item())
                fail(f"w8a8_gemm differs from its plain version at "
                     f"M={M} D={D} O={O}: max_abs_err={err}")
            del out32, ref32
            ms = cuda_time_ms(
                lambda i: K.w8a8_gemm(yq, ys, wts[i % n_w], s,
                                      torch.bfloat16), 20,
            )
            pms = cuda_time_ms(
                lambda i: K.w8a8_gemm_plain(yq, ys, wts[i % n_w], s,
                                            torch.bfloat16), 3, warmup=1,
            )
            lib = None
            if M > 16:  # torch._int_mm's shape rule: the int product only
                lib = cuda_time_ms(
                    lambda i: torch._int_mm(yq, ws[i % n_w]), 20
                )
            bms, by = bound_ms(M * D + M * 4 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, INT8_OPS_PER_S)
            note("w8a8_gemm", (M, D, O), 0.0, ms, pms, lib, bms, by)
            plan = plan_line(K, M, D, O, sms)
            if lib is not None:
                print(f"  {'':17s} kernel / torch._int_mm "
                      f"{statistics.median(ms) / statistics.median(lib):.3f}",
                      flush=True)

            # w8_bf16_gemm on the K-major weight: within W8_BF16_RTOL of
            # the plain version in bf16, 1e-5 in float32 (f32 summation
            # order only)
            y32 = torch.randn((M, D), generator=gen, device=dev) * 2.0
            for yy, rtol in ((y, W8_BF16_RTOL), (y32, 1e-5)):
                out = K.w8_bf16_gemm(yy, wts[0], s)
                ref = K.w8_bf16_gemm_plain(yy, wts[0], s)
                e = (out.float() - ref.float()).abs().max().item()
                lim = rtol * ref.float().abs().max().item()
                if not (e <= lim and torch.isfinite(out).all()):
                    fail(f"w8_bf16_gemm {yy.dtype} at M={M} D={D} O={O}: "
                         f"max_abs_err {e} > {lim}")
                if yy is y:
                    err = e
            ms = cuda_time_ms(lambda i: K.w8_bf16_gemm(y, wts[i % n_w], s),
                              20)
            pms = cuda_time_ms(
                lambda i: K.w8_bf16_gemm_plain(y, wts[i % n_w], s), 3,
                warmup=1,
            )
            lib = cuda_time_ms(
                lambda i: torch._weight_int8pack_mm(y, wts[i % n_w], s), 20
            )
            bms, by = bound_ms(M * D * 2 + D * O + O * 4 + M * O * 2,
                               2.0 * M * D * O, BF16_FLOPS_PER_S)
            note("w8_bf16_gemm", (M, D, O), err, ms, pms, lib, bms, by)
            print(f"  {'':17s} the same plan as w8a8_gemm; kernel / "
                  f"_weight_int8pack_mm "
                  f"{statistics.median(ms) / statistics.median(lib):.3f}",
                  flush=True)
            if plan.n_mtiles != 1:
                fail(f"w8_bf16_gemm at M={M} takes {plan.n_mtiles} row "
                     "tiles: the weight would cross memory more than once")

            # the grouped pair (the lm_head only under --group-head)
            gq, gs_ = K.group_quant_int8(y, GROUP)
            pq, ps = K.group_quant_int8_plain(y, GROUP)
            if not (torch.equal(gq, pq) and torch.equal(gs_, ps)):
                fail(f"group_quant_int8 differs from its plain version at "
                     f"M={M} D={D}")
            out = K.w8a8_grouped_gemm(gq, gs_, w, sg, torch.bfloat16)
            ref = K.w8a8_grouped_gemm_plain(gq, gs_, w, sg, torch.bfloat16)
            torch.cuda.synchronize()
            if not torch.equal(out, ref):
                err = (out.float() - ref.float()).abs().max().item()
                fail(f"w8a8_grouped_gemm differs from its plain version at "
                     f"M={M} D={D} O={O} G={G}: max_abs_err={err}")
            if M not in (4, 61):
                continue
            if O == TABLE_DO[0][1] or D == 14336:
                ms = cuda_time_ms(lambda i: K.group_quant_int8(y, GROUP), 50)
                pms = cuda_time_ms(
                    lambda i: K.group_quant_int8_plain(y, GROUP), 20)
                bms, by = bound_ms(M * D * 2 + M * D + M * G * 4, 0, 1.0)
                note("group_quant_int8", (M, D, 0), 0.0, ms, pms, None, bms,
                     by)
            ms = cuda_time_ms(
                lambda i: K.w8a8_grouped_gemm(gq, gs_, ws[i % n_w], sg,
                                              torch.bfloat16), 20)
            pms = cuda_time_ms(
                lambda i: K.w8a8_grouped_gemm_plain(gq, gs_, ws[i % n_w], sg,
                                                    torch.bfloat16), 1,
                warmup=1,
            )
            bms, by = bound_ms(M * D + M * G * 4 + D * O + G * O * 4
                               + M * O * 2, 2.0 * M * D * O, INT8_OPS_PER_S)
            note("w8a8_grouped_gemm", (M, D, O), 0.0, ms, pms, None, bms, by)
        del ws, wts
        torch.cuda.empty_cache()

    # float32 inputs/outputs once per kernel (the tests' dtype)
    y = torch.randn((61, 4096), generator=gen, device=dev)
    w = torch.randint(-127, 128, (4096, 1024), generator=gen, device=dev,
                      dtype=torch.int8)
    s = torch.rand((1024,), generator=gen, device=dev) * 1e-3
    yq, ys = K.row_quant_int8(y)
    pq, ps = K.row_quant_int8_plain(y)
    if not (torch.equal(yq, pq) and torch.equal(ys, ps)):
        fail("row_quant_int8 differs from its plain version in float32")
    wt = w.t().contiguous()
    if not torch.equal(K.w8a8_gemm(yq, ys, wt, s, torch.float32),
                       K.w8a8_gemm_plain(yq, ys, wt, s, torch.float32)):
        fail("w8a8_gemm differs from its plain version in float32")
    sg = torch.rand((4096 // GROUP, 1024), generator=gen, device=dev) * 1e-3
    gq, gs_ = K.group_quant_int8(y, GROUP)
    pq, ps = K.group_quant_int8_plain(y, GROUP)
    if not (torch.equal(gq, pq) and torch.equal(gs_, ps)):
        fail("group_quant_int8 differs from its plain version in float32")
    if not torch.equal(K.w8a8_grouped_gemm(gq, gs_, w, sg, torch.float32),
                       K.w8a8_grouped_gemm_plain(gq, gs_, w, sg,
                                                 torch.float32)):
        fail("w8a8_grouped_gemm differs from its plain version in float32")
    print("  float32 inputs: all five matmul kernels agree with their plain "
          "versions (w8_bf16_gemm at every shape above)", flush=True)


# ---------------------------------------------------------------------------
# phase 4: decode attention

# (label, B, Bc, C, valid (Bc,), key offset (Bc,) or None, lse): the beam
# step's two blocks at the flagship geometry (a chunk's prefix of valid_len
# 1000 in a 1280-slot cache; the per-beam block of 10 slots at gen_len 3,
# keys at plen + j), then decode_attention_batched at the pooled shapes of
# tools_ab_attention.py (valid_len spread over [C/2, C)).
ATT_HEADS = (32, 8, 128)  # H, KV, Dh


def _att_cases():
    cases = [("beam prefix", 4, 1, 1280, [1000], None, True),
             ("beam per-beam block", 4, 4, 10, [4] * 4, [1000] * 4, True)]
    for B in (4, 16):
        for C in (1280, 4096):
            valid = [C // 2 + (C // 2) * i // B for i in range(B)]
            cases.append((f"batched B={B} C={C}", B, B, C, valid, None,
                          False))
    return cases


def check_attention(dev, notes):
    import torch
    import torch.nn.functional as F

    from infinisst_tpu_torch.core import rope as R
    from infinisst_tpu_torch.kernels import decode_attention as A

    gen = torch.Generator(device=dev).manual_seed(2)
    H, KV, Dh = ATT_HEADS
    inv = torch.tensor(R.llama_rope_freqs(Dh), dtype=torch.float32,
                       device=dev)
    i32 = dict(dtype=torch.int32, device=dev)

    def run(label, B, Bc, C, valid, off, lse, dtype, timed):
        q = torch.randn((B, H, Dh), generator=gen, device=dev).to(dtype)
        kv_bytes = 2 * Bc * C * KV * Dh * q.element_size()
        # enough cache copies to exceed the 50 MB L2: each layer's cache
        # is read cold on the main path
        n_c = max(1, math.ceil(120e6 / kv_bytes)) if timed else 1
        ks = [torch.randn((Bc, C, KV, Dh), generator=gen, device=dev
                          ).to(dtype) for _ in range(n_c)]
        vs = [torch.randn((Bc, C, KV, Dh), generator=gen, device=dev
                          ).to(dtype) for _ in range(n_c)]
        vl = torch.tensor(valid, **i32)
        base = 0 if off is None else off[0]
        qp = torch.tensor([base + max(valid) + 3] * B, **i32)
        ko = None if off is None else torch.tensor(off, **i32)

        def kernel(i):
            return A.decode_attention(q, ks[i % n_c], vs[i % n_c], vl, qp,
                                      inv, key_offset=ko, return_lse=lse)

        def plain(i):
            return A.decode_attention_plain(q, ks[i % n_c], vs[i % n_c], vl,
                                            qp, inv, ko, lse)

        got, ref = kernel(0), plain(0)
        torch.cuda.synchronize()
        pairs = list(zip(got, ref)) if lse else [(got, ref)]
        rtol = ATT_RTOL["bf16" if dtype == torch.bfloat16 else "f32"]
        err = 0.0
        for n, (g, r) in enumerate(pairs):
            e = (g.float() - r.float()).abs().max().item()
            lim = (rtol if n == 0 else ATT_RTOL["f32"]) * \
                r.float().abs().max().item()
            if not (e <= lim and torch.isfinite(g).all()):
                fail(f"decode_attention {label} {dtype}: "
                     f"{'lse' if n else 'out'} max_abs_err {e} > {lim}")
            err = max(err, e)
        if not timed:
            print(f"  decode_attention  {label} {dtype}: max_abs_err "
                  f"{err:.3e} (within {rtol} x max|plain|)", flush=True)
            return
        ms = cuda_time_ms(kernel, 20)
        pms = cuda_time_ms(plain, 3, warmup=1)
        # library yardstick: SDPA over keys rotated beforehand (not timed:
        # SDPA has no rotate-on-read), the valid_len mask as a boolean
        # mask; the shared prefix folds the beams into its query length
        kpos = torch.arange(C, device=dev)[None] + (
            0 if ko is None else ko[:, None])
        krs = [R.apply_llama_rope(k.transpose(1, 2), kpos[:, None], inv)
               for k in ks]
        vts = [v.transpose(1, 2).contiguous() for v in vs]
        qr = R.apply_llama_rope(q[:, :, None], qp[:, None, None], inv)
        if Bc == 1 and B > 1:
            qr = qr.permute(2, 1, 0, 3).contiguous()  # (1, H, B, Dh)
        mask = (torch.arange(C, device=dev)[None] < vl[:, None])[
            :, None, None, :]
        lib = cuda_time_ms(lambda i: F.scaled_dot_product_attention(
            qr, krs[i % n_c], vts[i % n_c], attn_mask=mask,
            enable_gqa=True), 20)
        c_eff = [min(v, C) if v > 0 else C for v in valid]
        nbytes = (sum(c_eff) * 2 * KV * Dh * q.element_size()
                  + 2 * q.numel() * q.element_size() + Bc * 8
                  + (B * H * 4 if lse else 0))
        rows_per_cache = B // Bc
        ops = sum(4.0 * rows_per_cache * H * c * Dh for c in c_eff)
        bms, by = bound_ms(nbytes, ops, BF16_FLOPS_PER_S)
        notes.note("decode_attention", (label, B, C), err, ms, pms, lib, bms,
                   by, label=f"{label:21s} B={B:2d} Bc={Bc:2d} C={C:5d}")

    for case in _att_cases():
        run(*case, dtype=torch.bfloat16, timed=True)
    # float32 (the tiny model's and the tests' dtype), beam step's blocks
    for case in _att_cases()[:2]:
        run(*case, dtype=torch.float32, timed=False)
    print("  library_ms: F.scaled_dot_product_attention(enable_gqa=True) over "
          "keys rotated beforehand -- it leaves out the rotation the kernel "
          "does", flush=True)


# ---------------------------------------------------------------------------
# phase 4: tiny W8A8 agent, card against CPU


def tiny_agent(device, params):
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import (
        SpecialTokens, StreamConfig, tiny_model_config,
    )
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    vocab = 512
    tokens = SpecialTokens(
        bos=500, eot=501, eos=501, start_header=502, end_header=503,
        pad=504, user=505, assistant=506, newline2=507, sp_patch=508,
        sp_start=509, sp_end=510, latency=(511, 511, 511, 511),
    )
    cfg = tiny_model_config(vocab_size=vocab).replace(tokens=tokens)
    stream = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=120,
                          llm_cache_capacity=256)
    builder = PromptBuilder(StubTokenizer(vocab_size=vocab, lo=10, hi=400),
                            cfg.tokens)
    opts = InfiniSSTOptions(beam=2, max_llm_cache_size=120,
                            no_repeat_ngram_lookback=32)
    p = None if params is None else _to(params, device)
    return InfiniSSTAgent(p, cfg, stream, builder, opts,
                          param_dtype=torch.float32, device=device), cfg


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to(v, device) for v in tree]
    return tree.to(device)


def check_tiny(dev):
    """Tiny speech-LLM: the prefill logits on the card against the CPU
    (plain versions), with float32 and with W8A8 weights, and the W8A8
    agent's tokens equal in every chunk."""
    import numpy as np
    import torch

    from infinisst_tpu_torch.core.config import CONV_LEFT_CONTEXT
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import speech_llm
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.models.quant import init_quantized_llama
    from infinisst_tpu_torch.streaming.state import (
        init_decoder_state, init_encoder_state,
    )

    g = torch.Generator().manual_seed(3)
    agent, cfg = tiny_agent("cpu", None)
    speech = {
        "w2v2": W.init_params(cfg.w2v2, g, "cpu"),
        "adapter": A.init_params(cfg.adapter, g, "cpu"),
    }
    f32_params = dict(speech, llama=L.init_params(cfg.llama, g, "cpu"))
    params = dict(speech, llama=init_quantized_llama(
        cfg.llama, g, "cpu", embed_dtype=torch.float32, act_int8=True,
        lm_head_int8=True,
    ))
    prompt = agent.builder.chunk_prompt(1, True)
    window = torch.from_numpy(
        np.random.RandomState(4).randn(1, CONV_LEFT_CONTEXT + 2 * 15360)
        .astype(np.float32) * 0.1
    )

    def prefill(p, device):
        w, ll = cfg.w2v2, cfg.llama
        state = speech_llm.StreamState(
            encoder=init_encoder_state(w.encoder_layers, 1, 96,
                                       w.encoder_attention_heads, w.head_dim,
                                       torch.float32, device),
            decoder=init_decoder_state(ll.num_layers, 1, 256,
                                       ll.num_kv_heads, ll.head_dim,
                                       torch.float32, device),
        )
        ids = torch.as_tensor(prompt.ids.astype(np.int64), device=device)
        lg, _ = speech_llm.prefill_chunk(
            _to(p, device), cfg, state, window.to(device), ids[None],
            prompt.patch_start, 48, 96,
        )
        return lg.cpu()

    for label, p in (("float32", f32_params), ("W8A8", params)):
        ref, got = prefill(p, "cpu"), prefill(p, dev)
        err = (got - ref).abs().max().item()
        lim = TINY_RTOL * ref.abs().max().item()
        print(f"  tiny {label} prefill logits {tuple(ref.shape)}: max_abs_err "
              f"{err:.3e} (limit {lim:.3e})", flush=True)
        if not (err <= lim and torch.isfinite(got).all()):
            fail(f"tiny {label} prefill logits on the card disagree with "
                 "the CPU")

    outs = {}
    for device in ("cpu", dev):
        agent, _ = tiny_agent(device, params)
        rng = np.random.RandomState(5)
        per_chunk = []
        for i in range(3):
            before = len(agent.states.target_ids)
            agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                       finished=(i == 2))
            per_chunk.append(list(agent.states.target_ids[before:]))
        outs[str(device)] = per_chunk
    a, b = outs["cpu"], outs[str(dev)]
    print(f"  tiny W8A8 agent tokens: cpu={a}", flush=True)
    print(f"                          {dev}={b}", flush=True)
    if a != b or not any(a):
        fail("tiny W8A8 agent's tokens on the card disagree with the CPU "
             "run")


# ---------------------------------------------------------------------------
# phases 5 / 6: the 8B streams


def flagship_params(dev, act_int8: bool, speech=None, group_size=0):
    import torch

    from infinisst_tpu_torch.core.presets import flagship_config
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.models.quant import init_quantized_llama

    cfg = flagship_config()
    gen = torch.Generator(device=dev).manual_seed(0)
    if speech is None:
        speech = {
            "w2v2": W.init_params(cfg.w2v2, gen, dev, torch.bfloat16),
            "adapter": A.init_params(cfg.adapter, gen, dev, torch.bfloat16),
        }
    llama = init_quantized_llama(
        cfg.llama, gen, dev, embed_dtype=torch.bfloat16,
        act_int8=act_int8, lm_head_int8=True, group_size=group_size,
    )
    return cfg, dict(speech, llama=llama)


def stream_8b(dev, cfg, params, min_chunks, max_chunks, need_evict, label):
    import numpy as np
    import torch

    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    stream = StreamConfig()
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    agent = InfiniSSTAgent(params, cfg, stream, builder,
                           InfiniSSTOptions(latency_multiplier=1, beam=4),
                           param_dtype=torch.bfloat16, device=dev)
    rng = np.random.RandomState(0)
    chunk_sec = agent.chunk_samples / 16000.0
    n_layers = cfg.llama.num_layers
    times, forwards = [], 0
    evicted_at = None
    i = 0
    reset_counts()
    while True:
        audio = rng.randn(agent.chunk_samples).astype(np.float32) * 0.1
        before = launch_counts()
        before_int = internal_counts()
        _sync(dev)
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        _sync(dev)
        dt = time.perf_counter() - t0
        res = agent.last_result
        n_fwd = res.steps  # 1 prefill + (steps - 1) beam forwards
        forwards += n_fwd
        after = launch_counts()
        delta = {k: after[k] - before[k] for k in before if after[k] > before[k]}
        after_int = internal_counts()
        delta_int = {k: after_int[k] - before_int[k] for k in after_int}
        times.append(dt)
        vlen = int(agent.dec_state.valid_len[0])
        print(f"  [{label}] chunk {i:2d}: {dt * 1e3:9.2f} ms  RTF "
              f"{dt / chunk_sec:.4f}  valid_len {vlen:4d}  enc_frames "
              f"{int(agent.enc_state.n_frames[0]):5d}  emitted "
              f"{agent.pend_n_host}  forwards {n_fwd}  evictions "
              f"{agent.evictions}  launches {delta}  besides the launches "
              f"{delta_int}", flush=True)
        if evicted_at is None and agent.evictions:
            evicted_at = i
        if not all(0 <= t < cfg.llama.vocab_size for t in res.tokens):
            fail(f"[{label}] token out of vocabulary: {res.tokens}")
        i += 1
        ring_wrapped = i * 48 > stream.max_cache_frames
        evict_applied = evicted_at is not None and i > evicted_at + 1
        if i >= max_chunks or (
            i >= min_chunks and ring_wrapped
            and (not need_evict or evict_applied)
        ):
            break
    counts = launch_counts()
    print(f"  [{label}] besides the launches, over the stream: "
          f"{internal_counts()} (split-K calls are one launch each)",
          flush=True)
    agent.flush_pending_evict()
    if agent.llm_cache_len != int(agent.dec_state.valid_len[0]) + \
            agent.pend_n_host:
        fail(f"[{label}] cache mirror {agent.llm_cache_len} != physical "
             f"{int(agent.dec_state.valid_len[0])} + pending "
             f"{agent.pend_n_host}")
    if int(agent.enc_state.n_frames[0]) != 48 * i:
        fail(f"[{label}] encoder consumed {int(agent.enc_state.n_frames[0])} "
             f"frames, expected {48 * i}")
    if need_evict and evicted_at is None:
        fail(f"[{label}] no LLM cache eviction in {i} chunks")
    return dict(chunks=i, times=times, forwards=forwards, counts=counts,
                evicted_at=evicted_at, n_layers=n_layers,
                chunk_sec=chunk_sec, agent=agent, rng=rng)


# (module, function) of each stage of the chunk step, in the order the
# step runs them; beam_token_step runs inside beam_search
STAGES = (
    ("infinisst_tpu_torch.models.llama", "evict_cache"),
    ("infinisst_tpu_torch.models.speech_llm", "encode_chunk"),
    ("infinisst_tpu_torch.models.speech_llm", "splice_speech"),
    ("infinisst_tpu_torch.models.llama", "decode_step"),
    ("infinisst_tpu_torch.decode.beam", "beam_search"),
    ("infinisst_tpu_torch.models.llama", "beam_token_step"),
)


@contextlib.contextmanager
def wrapped_stages(wrap):
    """Replace each stage function by ``wrap(name, fn)`` for the duration
    (the port calls them through their modules), then restore them."""
    saved = []
    for mod_name, name in STAGES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, name)
        saved.append((mod, name, fn))
        setattr(mod, name, wrap(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def _next_audio(r):
    import numpy as np

    return r["rng"].randn(r["agent"].chunk_samples).astype(np.float32) * 0.1


def stage_chunk(dev, r):
    """One more chunk with a synchronise before and after each stage: the
    wall time of each stage, host and device together."""
    spent = {}

    def wrap(name, fn):
        def timed(*args, **kw):
            _sync(dev)
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            _sync(dev)
            n, t = spent.get(name, (0, 0.0))
            spent[name] = (n + 1, t + time.perf_counter() - t0)
            return out
        return timed

    audio = _next_audio(r)
    with wrapped_stages(wrap):
        _sync(dev)
        t0 = time.perf_counter()
        r["agent"].push(audio, finished=False)
        _sync(dev)
        wall = time.perf_counter() - t0
    print(f"[stages] one chunk with a synchronise around each stage: wall "
          f"{wall * 1e3:.2f} ms", flush=True)
    for _, name in STAGES:
        n, t = spent.get(name, (0, 0.0))
        print(f"[stages]   {name:16s} calls {n:2d}  {t * 1e3:9.2f} ms",
              flush=True)
    beam = spent.get("beam_search", (0, 0.0))[1]
    steps = spent.get("beam_token_step", (0, 0.0))[1]
    top = sum(t for name, (n, t) in spent.items() if name != "beam_token_step")
    print(f"[stages]   beam_search outside beam_token_step (log-softmax, "
          f"processors, top-2B, bookkeeping): {(beam - steps) * 1e3:.2f} ms; "
          f"outside every stage: {(wall - top) * 1e3:.2f} ms", flush=True)


def profile_chunk(dev, r, label="profile"):
    """One more chunk under torch.profiler: wall time, device kernel time
    by kernel name and by stage, and the device's idle share, both against
    the profiled wall and against the median unprofiled chunk wall; each
    line starts with ``[label]``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    def wrap(name, fn):
        def ranged(*args, **kw):
            with record_function(f"stage::{name}"):
                return fn(*args, **kw)
        return ranged

    audio = _next_audio(r)
    _sync(dev)
    with wrapped_stages(wrap), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        r["agent"].push(audio, finished=False)
        _sync(dev)
        wall = time.perf_counter() - t0
    by_name = {}
    for e in prof.key_averages():
        # device-side kernel events only: a CPU op also reports the device
        # time of the kernels it launched, which would count them twice;
        # the device side of the stage ranges is read below
        if e.device_type != DeviceType.CUDA or e.key.startswith("stage::"):
            continue
        t = e.self_device_time_total
        if t > 0:
            by_name[e.key] = by_name.get(e.key, 0.0) + t / 1e3  # ms
    busy = sum(by_name.values())
    med = sorted(r["times"][1:])[(len(r["times"]) - 1) // 2] * 1e3
    print(f"[{label}] one chunk under the profiler: wall {wall * 1e3:.2f} ms,"
          f" device kernels {busy:.2f} ms, device idle share "
          f"{1.0 - busy / (wall * 1e3):.4f}; against the median unprofiled "
          f"chunk wall {med:.2f} ms: {1.0 - busy / med:.4f}", flush=True)
    # kernel time by stage: the device events that start inside the device
    # span of a stage's range.  A range's own device total would miss the
    # kernels launched through ctypes, which belong to no PyTorch op.
    spans, events = {}, []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name.startswith("stage::"):
            spans.setdefault(e.name[7:], []).append(
                (e.time_range.start, e.time_range.end))
        else:
            events.append((e.time_range.start, e.time_range.elapsed_us()))
    for _, name in STAGES:
        ss = spans.get(name, [])
        span_ms = sum(b - a for a, b in ss) / 1e3
        dev_ms = sum(d for s, d in events
                     if any(a <= s < b for a, b in ss)) / 1e3
        print(f"[{label}]   stage {name:16s} ranges {len(ss):2d}  device span "
              f"{span_ms:9.2f} ms  device kernels {dev_ms:9.2f} ms",
              flush=True)
    groups = {"w8a8_grouped_gemm": 0.0, "group_quant_int8": 0.0,
              "w8a8_gemm": 0.0, "row_quant_int8": 0.0, "w8_bf16_gemm": 0.0,
              "decode_attention": 0.0, "other": 0.0}
    for k, t in by_name.items():
        g = next((g for g in groups if g in k), "other")
        groups[g] += t
    print(f"[{label}] device ms by kernel group: "
          f"{ {k: round(v, 3) for k, v in groups.items()} }", flush=True)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for k, t in top:
        print(f"[{label}]   {t:9.3f} ms  {k[:90]}", flush=True)


def main():
    t_start = time.perf_counter()

    # 1. device
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device is available; this check needs one "
              "H100", file=sys.stderr, flush=True)
        sys.exit(2)
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"[device] {card}", flush=True)
    print(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
          f"count {torch.cuda.device_count()}", flush=True)
    # state the float32 semantics: no TF32 in matmuls or convolutions
    # (cuDNN's default would run the tiny model's float32 convolutions in
    # TF32, and the card would then disagree with the CPU)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from infinisst_tpu_torch.kernels import _build

    # 2. build: one nvcc per source, all started together
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(SOURCES)) as pool:
        for f in [pool.submit(_build.load_library, n) for n in SOURCES]:
            f.result()
    print(f"[build] {', '.join(SOURCES)} built for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s into {_build.BUILD_DIR}",
          flush=True)

    notes = Notes()
    print("[kernels] against their plain versions on the card", flush=True)
    check_kernels(dev, notes)
    print("[attention] decode_attention against its plain version on the "
          "card", flush=True)
    check_attention(dev, notes)
    print("[tiny] tiny speech-LLM: card against CPU", flush=True)
    check_tiny(dev)

    paths = {}
    print("[flagship] 8B W8A8, m=1, beam 4", flush=True)
    cfg, params = flagship_params(dev, act_int8=True)
    speech = {k: params[k] for k in ("w2v2", "adapter")}
    r = stream_8b(dev, cfg, params, min_chunks=13, max_chunks=60,
                  need_evict=True, label="w8a8")
    L = r["n_layers"]
    # one GEMM per projection and the head; one row quantization per
    # distinct input (q/k/v share one, gate/up another)
    per_fwd = {"w8a8_gemm": 7 * L + 1, "row_quant_int8": 4 * L + 1}
    for name, n in per_fwd.items():
        if r["counts"][name] != r["forwards"] * n:
            fail(f"[flagship] {name} launched {r['counts'][name]} times, "
                 f"expected {r['forwards']} forwards x {n}")
    # each beam forward launches decode_attention twice per layer: the
    # shared prefix block and the per-beam block, merged by their lse
    beam_fwd = r["forwards"] - r["chunks"]
    if r["counts"]["decode_attention"] != beam_fwd * L * 2:
        fail(f"[flagship] decode_attention launched "
             f"{r['counts']['decode_attention']} times, expected "
             f"{beam_fwd} beam forwards x {L} layers x 2 blocks")
    unused = ("w8_bf16_gemm", "group_quant_int8", "w8a8_grouped_gemm")
    if any(r["counts"][k] for k in unused):
        fail(f"[flagship] {unused} ran on the per-channel W8A8 path")
    # chunk 0 carries one-time set-up (cuBLAS handles, allocator)
    rtf = sorted(t / r["chunk_sec"] for t in r["times"][1:])
    n = len(rtf)
    print(f"[flagship] chunks {r['chunks']} (ring wrap after 12, first "
          f"eviction decided after chunk {r['evicted_at']}); forwards "
          f"{r['forwards']} ({beam_fwd} beam forwards); launches "
          f"{r['counts']} = forwards x {per_fwd['w8a8_gemm']} w8a8_gemm, "
          f"forwards x {per_fwd['row_quant_int8']} row_quant_int8 (one per "
          f"shared input) and beam forwards x {L} layers x 2 "
          f"decode_attention launches (the prefix block and the per-beam "
          f"block, two launches per layer)", flush=True)
    print(f"[flagship] RTF over chunks 1..{n} (bring-up reading, not a "
          f"benchmark): median {rtf[n // 2]:.4f}, "
          f"{100 * (n - 10) // n}th percentile {rtf[n - 11]:.4f} "
          f"(10 chunks above it), mean {sum(rtf) / n:.4f}, min "
          f"{rtf[0]:.4f}, max {rtf[-1]:.4f}; chunk 0 "
          f"{r['times'][0] / r['chunk_sec']:.4f}", flush=True)
    for name in ("w8a8_gemm", "row_quant_int8", "decode_attention"):
        paths[name] = ("flagship W8A8 stream", r["counts"])
    stage_chunk(dev, r)
    profile_chunk(dev, r)
    del params, r
    torch.cuda.empty_cache()

    print("[weight_only] 8B {'q_kmajor','scale'} projections", flush=True)
    cfg, params = flagship_params(dev, act_int8=False, speech=speech)
    r = stream_8b(dev, cfg, params, min_chunks=3, max_chunks=3,
                  need_evict=False, label="w8")
    want = r["forwards"] * 7 * r["n_layers"]
    c = r["counts"]
    if not (c["w8_bf16_gemm"] == want
            and c["w8a8_gemm"] == c["row_quant_int8"] == r["forwards"]):
        fail(f"[weight_only] launches {c}, expected w8_bf16_gemm {want} "
             f"and the W8A8 head {r['forwards']}")
    if internal_counts()["w8_bf16_gemm_f32_cast"]:
        fail("[weight_only] the bf16 stream rounded float32 activations")
    rtf = [t / r["chunk_sec"] for t in r["times"][1:]]
    print(f"[weight_only] chunks {r['chunks']}; forwards {r['forwards']};"
          f" launches {c}; RTF chunks 1..: "
          f"{[round(x, 4) for x in rtf]}", flush=True)
    paths["w8_bf16_gemm"] = ("weight-only stream", c)
    profile_chunk(dev, r, label="w8 profile")
    del params, r
    torch.cuda.empty_cache()

    print(f"[group128] 8B grouped W8A8 projections (groups of {GROUP}), "
          "per-channel W8A8 lm_head", flush=True)
    cfg, params = flagship_params(dev, act_int8=True, speech=speech,
                                  group_size=GROUP)
    r = stream_8b(dev, cfg, params, min_chunks=3, max_chunks=3,
                  need_evict=False, label="g128")
    L, c = r["n_layers"], r["counts"]
    if not (c["w8a8_grouped_gemm"] == r["forwards"] * 7 * L
            and c["group_quant_int8"] == r["forwards"] * 4 * L
            and c["w8a8_gemm"] == c["row_quant_int8"] == r["forwards"]
            and c["w8_bf16_gemm"] == 0):
        fail(f"[group128] launches {c}, expected w8a8_grouped_gemm "
             f"forwards x {7 * L}, group_quant_int8 forwards x {4 * L} (one "
             f"per shared input) and the per-channel head {r['forwards']}")
    rtf = [t / r["chunk_sec"] for t in r["times"][1:]]
    print(f"[group128] chunks {r['chunks']}; forwards {r['forwards']}; "
          f"launches {c}; RTF chunks 1..: {[round(x, 4) for x in rtf]} "
          "(bring-up reading)", flush=True)
    for name in ("w8a8_grouped_gemm", "group_quant_int8"):
        paths[name] = ("group128 stream", c)
    del params
    torch.cuda.empty_cache()

    # 9. the kernels line
    q_src = "infinisst_tpu_torch/csrc/quant_matmul.cu"
    kernels = {  # name -> (source, TPU kernel replaced, reported shape)
        "row_quant_int8": (q_src, "infinisst_tpu/kernels/quant_matmul.py:106",
                           (REPORT_SHAPE[0], REPORT_SHAPE[1], 0)),
        "w8a8_gemm": (q_src, "infinisst_tpu/kernels/quant_matmul.py:94",
                      REPORT_SHAPE),
        "w8_bf16_gemm": (q_src, "infinisst_tpu/kernels/quant_matmul.py:26",
                         REPORT_SHAPE),
        "group_quant_int8": (
            q_src, "infinisst_tpu/kernels/quant_matmul.py:226",
            (REPORT_SHAPE[0], REPORT_SHAPE[1], 0)),
        "w8a8_grouped_gemm": (
            q_src, "infinisst_tpu/kernels/quant_matmul.py:191", REPORT_SHAPE),
        "decode_attention": (
            "infinisst_tpu_torch/csrc/decode_attention.cu",
            "infinisst_tpu/kernels/decode_attention.py:57",
            ("beam prefix", 4, 1280)),
    }
    entries = []
    for name, (source, replaces, shape) in kernels.items():
        t = notes.rows[name]["shapes"][shape]
        path, counts = paths[name]
        launches = counts[name]
        if launches <= 0:
            fail(f"{name} was not launched on its path")
        entries.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": notes.rows[name]["err"], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "shape": [x for x in shape if x != 0], "path": path,
        })
        if "launch_floor_ms" in t:  # the yardstick of a latency-bound kernel
            entries[-1]["launch_floor_ms"] = t["launch_floor_ms"]
    print(json.dumps({"kernels": entries}), flush=True)
    print(f"[done] {time.perf_counter() - t_start:.1f} s", flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
