"""Where a ``w8a8_gemm`` (or grouped GEMM) block spends its time, phase
by phase, and the grouped GEMM against an older checkout's.

    python -m infinisst_tpu_torch.tools.gemm_phases [--out f.json]
        [--path-shapes | --grouped [--parent DIR] | --grouped-phases]

Run from the root of a checkout, on one CUDA card.  Builds an
instrumented copy of that checkout's ``csrc/quant_matmul.cu`` into
``build/gemm_phases/`` (nvcc, ``-DGQ_PHASES``): every block's thread 0
reads ``clock64`` at the source's ``GQ_PHASE(i)`` marks and adds the
cycles since the last mark to bin i; the block's ``globaltimer`` span
converts cycles to microseconds, and each SM adds up the weight bytes
its blocks streamed and the nanoseconds they ran; the source names its
phases on a ``// phases:`` line.  Then, at the decoder's shapes (M = 4 beam rows
against k or v, gate or up and down; M = 384, the pool's prefill,
against gate or up):

- the phase split of one launch (the median of five, each on a weight
  not yet in L2): the mean microseconds a block spends in each phase,
  the share of blocks that reached it, the span from the first block's
  start to the last one's end, the spread of the blocks' starts, and the
  SMs' busy spread (the largest SM's share of the weight bytes and of
  the busy time, against an even 1 / SMs);
- the device time of the uninstrumented kernel (the checkout's own
  build), the median of replays of a CUDA graph over enough weight
  copies to exceed the 50 MB L2; also q|k|v and gate|up in one launch
  beside the same weights one launch each.

With ``--grouped-phases``: the same phase split of the grouped GEMM
(``csrc/grouped_matmul.cu``, groups of 128) at the ``--group128``
stream's shapes (GROUPED_PHASE_SHAPES), beside its device time.

With ``--grouped [--parent DIR]``: the grouped GEMM's device time at every
``--group128`` path shape (M = 1, 4, 61, 79 against q|k|v, o, gate|up and
down, the grouped head at M <= 4), beside its bytes bound, from the
checkout in DIR (default ``build/parent``, unpacked with ``git archive``)
and from this one, in turns: parent, this, this, parent, each in a
process of its own that imports that checkout's package and builds its
kernels (a tree without ``w8a8_grouped_gemm_many`` runs q|k|v and gate|up
one launch a weight).  Prints each tree's reading, both trees' medians
and this tree over the parent.

With ``--path-shapes`` instead: the uninstrumented kernel's device time
at every shape the decoder's paths run it (M = 1, 4, 5, 8, 20, 32, 40,
61, 79, 384 and 448 rows against each flagship projection, the head up
to 40 rows, and q|k|v and gate|up in one launch), beside its bound (the weight,
activation, scale and output bytes at 3.35 TB/s, or the operations at
1979 int8 TOP/s) and ``torch._int_mm`` + the scale epilogue in PyTorch
ops over the same (concatenated) weight, on the activations zero-padded
to 17 rows at M <= 16, which ``_int_mm`` refuses.  Run it from two
checkouts in one call to compare them on one card.

Prints one line per reading, the JSON of them all (also to ``--out``),
then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import re
import statistics
import subprocess
import sys

import torch

PHASE_BINS = 16
MAX_SMS = 256
NVCC = "/usr/local/cuda/bin/nvcc"
L2_BYTES = 50e6
TRIALS = 5
# (M, D, O): a beam step's k or v, gate or up and down; the pool's prefill
# against gate or up
SHAPES = ((4, 4096, 1024), (4, 4096, 14336), (4, 14336, 4096),
          (384, 4096, 14336))
# the weights that share an input, at the flagship's widths
MANY = (("q|k|v", 4096, (4096, 1024, 1024)),
        ("gate|up", 4096, (14336, 14336)))
MANY_M = (4, 384)
# --path-shapes: the rows of the decoder's paths (beam steps 4, the pool's
# 32; drafts and samplers 1, verifies 5 and 40, the pool's draft 8, spec
# beam's tree 20; the stream's prefill 61 and 79; the pool's and
# AlignAtt's prefill 384, AlignAtt at its cap 448) and the weights (the
# head only where it runs on every row: up to 40 rows)
PATH_M = (1, 4, 5, 8, 20, 32, 40, 61, 79, 384, 448)
PATH_WEIGHTS = (("q or o", 4096, (4096,)), ("k or v", 4096, (1024,)),
                ("gate or up", 4096, (14336,)), ("down", 14336, (4096,)),
                ("head", 4096, (128512,))) + MANY
HEAD_MAX_M = 40
# --grouped: the --group128 stream's rows (beam steps 1 and 4, the
# prefill 61 and 79) against its projections, q|k|v and gate|up in one
# launch, and the grouped head (--group-head) at its beam-step rows
GROUP = 128
GROUPED_M = (1, 4, 61, 79)
GROUPED_WEIGHTS = (("q|k|v", 4096, (4096, 1024, 1024)), ("o", 4096, (4096,)),
                   ("gate|up", 4096, (14336, 14336)), ("down", 14336, (4096,)),
                   ("head", 4096, (128512,)))
# --grouped-phases: (M, D, Os) of a beam step's q|k|v, o, gate|up and
# down, and the prefill's gate|up and down
GROUPED_PHASE_SHAPES = ((4, 4096, (4096, 1024, 1024)), (4, 4096, (4096,)),
                        (4, 4096, (14336, 14336)), (4, 14336, (4096,)),
                        (61, 4096, (14336, 14336)), (61, 14336, (4096,)))
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

_PRELUDE = r"""
#include <cuda_runtime.h>
#define GQ_NPH %d
#define GQ_MAX_SMS %d
// bins: cycles by phase; blocks that reached each phase; blocks; the
// blocks' summed globaltimer spans; the first start; the last end; all
// cycles; the last start
__device__ unsigned long long gq_bins[2 * GQ_NPH + 6];
// per SM: weight bytes streamed, nanoseconds busy
__device__ unsigned long long gq_sm[2 * GQ_MAX_SMS];
__device__ __forceinline__ unsigned long long gq_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned gq_smid() {
  unsigned s;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(s));
  return s;
}
#define GQ_PHASE_INIT()                                       \
  unsigned long long gq_last = clock64(), gq_g0 = gq_gtime(); \
  unsigned long long gq_acc[GQ_NPH] = {};                     \
  unsigned long long gq_bytes = 0;                            \
  unsigned int gq_hit = 0;
#define GQ_PHASE(i)                                      \
  do {                                                   \
    const unsigned long long n_ = clock64();             \
    gq_acc[i] += n_ - gq_last;                           \
    gq_last = n_;                                        \
    gq_hit |= 1u << (i);                                 \
  } while (0)
#define GQ_BYTES(n) (gq_bytes += (unsigned long long)(n))
#define GQ_PHASE_END()                                                  \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const unsigned long long g_ = gq_gtime();                         \
      unsigned long long c_ = 0;                                        \
      for (int i_ = 0; i_ < GQ_NPH; ++i_) {                             \
        atomicAdd(&gq_bins[i_], gq_acc[i_]);                            \
        atomicAdd(&gq_bins[GQ_NPH + i_], (gq_hit >> i_) & 1u);          \
        c_ += gq_acc[i_];                                               \
      }                                                                 \
      atomicAdd(&gq_bins[2 * GQ_NPH], 1ull);                            \
      atomicAdd(&gq_bins[2 * GQ_NPH + 1], g_ - gq_g0);                  \
      atomicMin(&gq_bins[2 * GQ_NPH + 2], gq_g0);                       \
      atomicMax(&gq_bins[2 * GQ_NPH + 3], g_);                          \
      atomicAdd(&gq_bins[2 * GQ_NPH + 4], c_);                          \
      atomicMax(&gq_bins[2 * GQ_NPH + 5], gq_g0);                       \
      const unsigned s_ = gq_smid() %% GQ_MAX_SMS;                      \
      atomicAdd(&gq_sm[s_], gq_bytes);                                  \
      atomicAdd(&gq_sm[GQ_MAX_SMS + s_], g_ - gq_g0);                   \
    }                                                                   \
  } while (0)
""" % (PHASE_BINS, MAX_SMS)

_EPILOGUE = r"""
extern "C" int gq_phase_reset() {
  unsigned long long z[2 * GQ_NPH + 6] = {};
  z[2 * GQ_NPH + 2] = ~0ull;
  int err = (int)cudaMemcpyToSymbol(gq_bins, z, sizeof(z));
  unsigned long long s[2 * GQ_MAX_SMS] = {};
  return err ? err : (int)cudaMemcpyToSymbol(gq_sm, s, sizeof(s));
}
extern "C" int gq_phase_read(unsigned long long* out) {
  int err = (int)cudaMemcpyFromSymbol(
      out, gq_bins, sizeof(unsigned long long) * (2 * GQ_NPH + 6));
  return err ? err
             : (int)cudaMemcpyFromSymbol(
                   out + 2 * GQ_NPH + 6, gq_sm,
                   sizeof(unsigned long long) * 2 * GQ_MAX_SMS);
}
"""

def instrumented_source(src: str):
    """(the source with the phase macros defined ahead of it, the phase
    names of its ``// phases:`` line)."""
    m = re.search(r"^// phases: (.*)$", src, re.M)
    if m is None:
        raise RuntimeError("the source has no // phases: line")
    names = tuple(n.strip() for n in m.group(1).split(";"))
    if len(names) > PHASE_BINS:
        raise RuntimeError(f"{len(names)} phases, {PHASE_BINS} bins")
    return _PRELUDE + src + _EPILOGUE, names


def build(root: str, source: str = "quant_matmul"):
    src_path = os.path.join(root, "infinisst_tpu_torch", "csrc",
                            f"{source}.cu")
    with open(src_path) as f:
        src, names = instrumented_source(f.read())
    out_dir = os.path.join(root, "build", "gemm_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, f"{source}_phases.cu")
    so = os.path.join(out_dir, f"lib{source}_phases.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([NVCC, "-O3", "-gencode=arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-cudart", "shared", "-DGQ_PHASES",
                    "-I", os.path.dirname(src_path), "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.gq_phase_read.argtypes = [ctypes.c_void_p]
    return lib, names


def graph_ms(fn, reps=20):
    """Device ms per call of ``fn(i)``: the median of TRIALS replays of a
    CUDA graph of ``reps`` calls."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for i in range(2):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for i in range(reps):
            fn(i)
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(TRIALS):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return statistics.median(times)


class Case:
    """M activation rows against ``len(Os)`` weights of (D, O) each, in
    ``n_c`` copies, so that a timed run reads the weights cold."""

    def __init__(self, dev, gen, M, D, Os):
        self.M, self.D, self.Os = M, D, Os
        wbytes = D * sum(Os)
        self.n_c = max(2, math.ceil(2.4 * L2_BYTES / wbytes))
        y = torch.randn((M, D), generator=gen, device=dev).to(torch.bfloat16)
        from infinisst_tpu_torch.kernels import quant_matmul as K

        self.yq, self.ys = K.row_quant_int8(y)
        self.wts = [[torch.randint(-127, 128, (O, D), generator=gen,
                                   device=dev, dtype=torch.int8)
                     for O in Os] for _ in range(self.n_c)]
        self.s = [torch.rand((O,), generator=gen, device=dev) * 1e-3 + 1e-4
                  for O in Os]

    def one(self, K, i, j=0):
        """Weight j of copy i, alone."""
        return K.w8a8_gemm(self.yq, self.ys, self.wts[i % self.n_c][j],
                           self.s[j], torch.bfloat16)

    def many(self, K, i):
        return K.w8a8_gemm_many(self.yq, self.ys, self.wts[i % self.n_c],
                                self.s, torch.bfloat16)

    def separate(self, K, i):
        return [self.one(K, i, j) for j in range(len(self.Os))]


class GroupedCase:
    """M activation rows, quantized in groups of GROUP, against
    ``len(Os)`` grouped weights of (D, O) each, in ``n_c`` copies, so
    that a timed run reads the weights cold."""

    def __init__(self, K, dev, gen, M, D, Os):
        self.M, self.D, self.Os = M, D, Os
        self.n_c = max(2, math.ceil(2.4 * L2_BYTES / (D * sum(Os))))
        y = torch.randn((M, D), generator=gen, device=dev).to(torch.bfloat16)
        self.yq, self.ys = K.group_quant_int8(y, GROUP)
        self.wts = [[torch.randint(-127, 128, (O, D), generator=gen,
                                   device=dev, dtype=torch.int8)
                     for O in Os] for _ in range(self.n_c)]
        self.s = [torch.rand((D // GROUP, O), generator=gen, device=dev)
                  * 1e-3 + 1e-4 for O in Os]

    def run(self, K, i):
        """One launch for all weights where the tree has
        ``w8a8_grouped_gemm_many``, else one a weight."""
        ws = self.wts[i % self.n_c]
        many = getattr(K, "w8a8_grouped_gemm_many", None)
        if many is not None:
            return many(self.yq, self.ys, ws, self.s, torch.bfloat16)
        return [K.w8a8_grouped_gemm(self.yq, self.ys, w, s, torch.bfloat16)
                for w, s in zip(ws, self.s)]

    def bound_ms(self):
        M, D, O, G = self.M, self.D, sum(self.Os), self.D // GROUP
        return (M * D + M * G * 4 + D * O + G * O * 4 + M * O * 2) \
            / HBM_BYTES_PER_S * 1e3


def grouped_times(K, dev, gen):
    """{"label M": ms} at GROUPED_WEIGHTS x GROUPED_M (the head at
    M <= 4)."""
    out = {}
    for label, D, Os in GROUPED_WEIGHTS:
        for M in GROUPED_M:
            if label == "head" and M > 4:
                continue
            c = GroupedCase(K, dev, gen, M, D, Os)
            out[f"{label} M={M}"] = {"ms": graph_ms(lambda i: c.run(K, i)),
                                     "bound_ms": c.bound_ms()}
            del c
            torch.cuda.empty_cache()
    return out


def grouped_ab(parent: str, out_path):
    """Parent, this tree, this tree, parent: each a process running
    ``--grouped-times`` on its checkout; prints and returns the readings
    and the medians."""
    here = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    runs = []
    for name, tree in (("parent", parent), ("this", here), ("this", here),
                       ("parent", parent)):
        res = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--grouped-times",
             "--tree", os.path.abspath(tree)], cwd=os.path.abspath(tree),
            capture_output=True, text=True)
        if res.returncode:
            raise RuntimeError(f"--grouped-times on {tree} failed: "
                               f"{res.stderr[-4000:]}")
        reading = json.loads(res.stdout.strip().splitlines()[-1])
        runs.append((name, reading))
        print(f"[grouped] {name} ({tree}): " + ", ".join(
            f"{k} {v['ms']:.5f}" for k, v in reading.items()), flush=True)
    table = {}
    for key in runs[0][1]:
        p = statistics.median([r[key]["ms"] for n, r in runs
                               if n == "parent"])
        t = statistics.median([r[key]["ms"] for n, r in runs if n == "this"])
        b = runs[1][1][key]["bound_ms"]
        table[key] = {"parent_ms": p, "ms": t, "bound_ms": b}
        print(f"[grouped] {key:14s} parent {p:.5f} ms -> {t:.5f} ms "
              f"({t / p:.3f}); bound {b:.5f} ms ({b / t:.3f} of it)",
              flush=True)
    if out_path:
        with open(out_path, "w") as f:
            json.dump({"runs": runs, "table": table}, f)
    return table


def phase_split(lib, names, fn, n_c, sms):
    """The median of TRIALS single launches of ``fn(i)``, each on a copy
    not touched by the previous one: per phase the mean microseconds of a
    block that reached it and the share of blocks that did; the blocks;
    the span from the first block's start to the last one's end and the
    spread of the starts; the largest SM's share of the weight bytes and
    of the busy nanoseconds (an even split: 1 / sms)."""
    nb = 2 * PHASE_BINS + 6
    buf = (ctypes.c_ulonglong * (nb + 2 * MAX_SMS))()
    runs = []
    for t in range(TRIALS):
        torch.cuda.synchronize()
        if lib.gq_phase_reset():
            raise RuntimeError("gq_phase_reset failed")
        fn(t % n_c + 1)
        torch.cuda.synchronize()
        if lib.gq_phase_read(ctypes.addressof(buf)):
            raise RuntimeError("gq_phase_read failed")
        v = list(buf)
        blocks = v[2 * PHASE_BINS]
        ns_per_cycle = v[2 * PHASE_BINS + 1] / max(1, v[2 * PHASE_BINS + 4])
        ph = {}
        for i, name in enumerate(names):
            hits = v[PHASE_BINS + i]
            us = v[i] * ns_per_cycle / 1e3 / hits if hits else 0.0
            ph[name] = (us, hits / blocks)
        sm_bytes = v[nb:nb + MAX_SMS]
        sm_ns = v[nb + MAX_SMS:nb + 2 * MAX_SMS]
        used = sum(1 for b in sm_ns if b)
        runs.append({
            "blocks": blocks, "phases": ph,
            "span_us": (v[2 * PHASE_BINS + 3] - v[2 * PHASE_BINS + 2]) / 1e3,
            "start_spread_us": (v[2 * PHASE_BINS + 5]
                                - v[2 * PHASE_BINS + 2]) / 1e3,
            "block_us": v[2 * PHASE_BINS + 1] / 1e3 / blocks,
            "ghz": 1.0 / ns_per_cycle,
            "sms_used": used,
            "max_sm_byte_share": max(sm_bytes) / max(1, sum(sm_bytes)),
            "max_sm_busy_share": max(sm_ns) / max(1, sum(sm_ns)),
            "even_share": 1.0 / sms})
    runs.sort(key=lambda r: r["span_us"])
    return runs[len(runs) // 2]


def _print_split(label, v):
    split = ", ".join(f"{n} {us:.3f} us x{share:.2f}"
                      for n, (us, share) in v["phases"].items())
    print(f"[phases]   {label}: {v['blocks']} blocks on {v['sms_used']} SMs, "
          f"span {v['span_us']:.2f} us (starts spread "
          f"{v['start_spread_us']:.2f}), a block {v['block_us']:.2f} us at "
          f"{v['ghz']:.3f} GHz; the largest SM's share of the bytes "
          f"{v['max_sm_byte_share']:.4f} and of the busy time "
          f"{v['max_sm_busy_share']:.4f} (even {v['even_share']:.4f}): "
          f"{split}", flush=True)


def path_times(K, dev, gen):
    """{(label, M): {ms, int_mm_ms, bound_ms, bound_by}} at PATH_WEIGHTS x
    PATH_M (see the module's docstring)."""
    out = {}
    for label, D, Os in PATH_WEIGHTS:
        c = Case(dev, gen, 1, D, Os)
        O = sum(Os)
        # _int_mm's operand: the (D, sum O) weight, row-major
        cat = [torch.cat([w.t() for w in ws], 1).contiguous()
               for ws in c.wts]
        s = torch.cat(c.s)
        for M in PATH_M:
            if label == "head" and M > HEAD_MAX_M:
                continue
            y = torch.randn((M, D), generator=gen, device=dev).to(
                torch.bfloat16)
            c.yq, c.ys = K.row_quant_int8(y)
            ms = graph_ms(lambda i: c.many(K, i))
            yp = c.yq
            if M <= 16:
                yp = torch.nn.functional.pad(c.yq, (0, 0, 0, 17 - M))
            lib = graph_ms(lambda i: (torch._int_mm(yp, cat[i % c.n_c])[:M]
                                      .float() * c.ys * s)
                           .to(torch.bfloat16))
            t_b = (M * D + M * 4 + D * O + O * 4 + M * O * 2) / HBM_BYTES_PER_S
            t_o = 2.0 * M * D * O / INT8_OPS_PER_S
            out[(label, M)] = {"ms": ms, "int_mm_ms": lib,
                               "bound_ms": max(t_b, t_o) * 1e3,
                               "bound_by": "bytes" if t_b >= t_o
                               else "operations"}
            r = out[(label, M)]
            print(f"[path] {label:10s} M={M:3d} D={D:5d} O={O:6d}: "
                  f"{ms:.5f} ms, bound {r['bound_ms']:.5f} ({r['bound_by']}; "
                  f"{r['bound_ms'] / ms:.3f} of it), _int_mm + epilogue "
                  f"{lib:.5f}", flush=True)
        del c, cat
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--path-shapes", action="store_true")
    ap.add_argument("--grouped", action="store_true")
    ap.add_argument("--parent", default="build/parent")
    ap.add_argument("--grouped-phases", action="store_true")
    ap.add_argument("--grouped-times", action="store_true")
    ap.add_argument("--tree", default=None)
    args = ap.parse_args(argv)
    if args.grouped_times:
        # a child of --grouped: the package of --tree, nothing else
        sys.path.insert(0, args.tree)
        from infinisst_tpu_torch.kernels import quant_matmul as K

        dev = torch.device("cuda", 0)
        gen = torch.Generator(device=dev).manual_seed(0)
        print(json.dumps(grouped_times(K, dev, gen)))
        return
    if not torch.cuda.is_available():
        sys.exit("gemm_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    from infinisst_tpu_torch.kernels import quant_matmul as K

    gen = torch.Generator(device=dev).manual_seed(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    if args.grouped:
        grouped_ab(args.parent, args.out)
        print(smi)
        return
    if args.grouped_phases:
        lib, names = build(os.getcwd(), "grouped_matmul")
        own = K._grouped_library()
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        report = {}
        for M, D, Os in GROUPED_PHASE_SHAPES:
            c = GroupedCase(K, dev, gen, M, D, Os)
            K._glib = K._bind_grouped(lib)
            try:
                split = phase_split(lib, names, lambda i: c.run(K, i), c.n_c,
                                    sms)
            finally:
                K._glib = own
            ms = graph_ms(lambda i: c.run(K, i))
            label = f"M={M} D={D} Os={'|'.join(map(str, Os))}"
            report[label] = {"ms": ms, "bound_ms": c.bound_ms(),
                             "phases": split}
            print(f"[phases] grouped {label}: {ms:.5f} ms, bound "
                  f"{c.bound_ms():.5f}", flush=True)
            _print_split(f"grouped {label}", split)
            del c
            torch.cuda.empty_cache()
        report["device"] = smi
        text = json.dumps(report)
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        print(smi)
        return
    if args.path_shapes:
        K._library()
        times = path_times(K, dev, gen)
        text = json.dumps({"device": smi, "path_shapes": [
            dict(label=k[0], M=k[1], **v) for k, v in times.items()]})
        if args.out:
            with open(args.out, "w") as f:
                f.write(text)
        print(text)
        print(smi)
        return
    root = os.getcwd()
    lib, names = build(root)
    own = K._library()
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    report = {"shapes": {}, "many_shapes": {}}
    for M, D, O in SHAPES:
        c = Case(dev, gen, M, D, (O,))
        K._lib = K._bind(lib)
        try:
            split = phase_split(lib, names, lambda i: c.one(K, i), c.n_c, sms)
        finally:
            K._lib = own
        ms = graph_ms(lambda i: c.one(K, i))
        report["shapes"][f"M={M} D={D} O={O}"] = {"ms": ms, "phases": split}
        print(f"[phases] M={M} D={D} O={O}: {ms:.5f} ms", flush=True)
        _print_split(f"M={M} D={D} O={O}", split)
        del c
        torch.cuda.empty_cache()
    for label, D, Os in MANY:
        for M in MANY_M:
            c = Case(dev, gen, M, D, Os)
            K._lib = K._bind(lib)
            try:
                split = phase_split(lib, names, lambda i: c.many(K, i),
                                    c.n_c, sms)
            finally:
                K._lib = own
            ms = graph_ms(lambda i: c.many(K, i))
            sep = graph_ms(lambda i: c.separate(K, i))
            report["many_shapes"][f"{label} M={M}"] = {
                "ms": ms, "separate_ms": sep, "phases": split}
            print(f"[phases] {label} M={M}: one launch {ms:.5f} ms, "
                  f"{len(Os)} launches {sep:.5f} ms", flush=True)
            _print_split(f"{label} M={M}", split)
            del c
            torch.cuda.empty_cache()
    report["device"] = smi
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    print(smi)


if __name__ == "__main__":
    main()
