"""Where a decode-attention block spends its time, phase by phase.

    python -m infinisst_tpu_torch.tools.attention_phases [--out f.json]

Run from the root of a checkout, on one CUDA card.  Builds an
instrumented copy of that checkout's ``csrc/decode_attention.cu`` into
``build/attention_phases/`` (nvcc, ``-DDA_PHASES``): every block's
thread 0 reads ``clock64`` at the source's ``DA_PHASE(i)`` marks and
adds the cycles since the last mark to bin i, and the block's
``globaltimer`` span converts cycles to microseconds.  A source without
the marks (the split-K kernel before the beam step's blocks were fused)
gets them at fixed anchors.  Then, at the beam step's path shapes
(flagship heads, bf16):

- the phase split of one launch (the median of five, each on caches
  not yet in L2): the mean microseconds a block spends in each phase,
  the blocks that reached it, and the span from the first block's start
  to the last one's end;
- the device time of the uninstrumented kernels (the checkout's own
  build), the median of replays of a CUDA graph over enough cache
  copies to exceed the 50 MB L2: each block alone, and the beam step's
  attention as the checkout computes it (one ``beam_attention`` launch,
  or before it two ``decode_attention`` launches and ``merge_blocks``),
  beside SDPA over the concatenated, pre-rotated keys.

With ``--sweep-splits`` also each path shape's beam step at other split
counts than the plan's (``[splits]`` lines): what ``plan``'s constants
were chosen from.

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
NVCC = "/usr/local/cuda/bin/nvcc"
HEADS = (32, 8, 128)  # the flagship's H, KV, Dh
L2_BYTES = 50e6
TRIALS = 5

_PRELUDE = r"""
#include <cuda_runtime.h>
#define DA_NPH %d
__device__ unsigned long long da_bins[3 * DA_NPH + 4];
__device__ __forceinline__ unsigned long long da_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
#define DA_PHASE_INIT()                                  \
  unsigned long long da_last = clock64(), da_g0 = da_gtime(); \
  unsigned long long da_acc[DA_NPH] = {};               \
  unsigned int da_hit = 0;
#define DA_PHASE(i)                                      \
  do {                                                   \
    const unsigned long long n_ = clock64();             \
    da_acc[i] += n_ - da_last;                           \
    da_last = n_;                                        \
    da_hit |= 1u << (i);                                 \
  } while (0)
#define DA_PHASE_END()                                                  \
  do {                                                                  \
    if (threadIdx.x == 0) {                                             \
      const unsigned long long g_ = da_gtime();                         \
      for (int i_ = 0; i_ < DA_NPH; ++i_) {                             \
        atomicAdd(&da_bins[i_], da_acc[i_]);                            \
        atomicAdd(&da_bins[DA_NPH + i_], (da_hit >> i_) & 1u);          \
      }                                                                 \
      atomicAdd(&da_bins[2 * DA_NPH], 1ull);                            \
      atomicAdd(&da_bins[2 * DA_NPH + 1], g_ - da_g0);                  \
      atomicMin(&da_bins[2 * DA_NPH + 2], da_g0);                       \
      atomicMax(&da_bins[2 * DA_NPH + 3], g_);                          \
      unsigned long long c_ = 0;                                        \
      for (int i_ = 0; i_ < DA_NPH; ++i_) c_ += da_acc[i_];             \
      atomicAdd(&da_bins[2 * DA_NPH + 4], c_);                          \
    }                                                                   \
  } while (0)
""" % PHASE_BINS

_EPILOGUE = r"""
extern "C" int da_phase_reset() {
  unsigned long long z[3 * DA_NPH + 4] = {};
  z[2 * DA_NPH + 2] = ~0ull;
  return (int)cudaMemcpyToSymbol(da_bins, z, sizeof(z));
}
extern "C" int da_phase_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, da_bins,
                                   sizeof(unsigned long long) *
                                       (3 * DA_NPH + 4));
}
"""

# the split-K kernel's phases (before the beam step's fusion), by anchor:
# (text, replacement)
_SPLITK_NAMES = ("q rotate + first load issued", "wait for the tile",
                 "rotate keys", "score products", "online softmax",
                 "P.V products", "epilogue writes", "counter atomic",
                 "combine")
_SPLITK_ANCHORS = (
    ("  const int g = lane >> 2, t4 = lane & 3;\n",
     "  const int g = lane >> 2, t4 = lane & 3;\n  DA_PHASE_INIT();\n"),
    ("    row_l[tid] = 0.f;\n  }\n  __syncthreads();\n",
     "    row_l[tid] = 0.f;\n  }\n  __syncthreads();\n  DA_PHASE(0);\n"),
    ("    __syncthreads();  // tile ``it`` landed; tile it - 1 is fully "
     "used\n",
     "    __syncthreads();  // tile ``it`` landed; tile it - 1 is fully "
     "used\n    DA_PHASE(1);\n"),
    ("        kt[j * LD + p + half] = o2;\n      }\n    }\n"
     "    __syncthreads();\n",
     "        kt[j * LD + p + half] = o2;\n      }\n    }\n"
     "    __syncthreads();\n    DA_PHASE(2);\n"),
    ("        s_s[idx] = masked((d0 + d1) + (d2 + d3), j);\n      }\n"
     "    }\n    __syncthreads();\n",
     "        s_s[idx] = masked((d0 + d1) + (d2 + d3), j);\n      }\n"
     "    }\n    __syncthreads();\n    DA_PHASE(3);\n"),
    ("        row_m[i] = m_new;\n      }\n    }\n    __syncthreads();\n",
     "        row_m[i] = m_new;\n      }\n    }\n    __syncthreads();\n"
     "    DA_PHASE(4);\n"),
    ("    }\n  }\n  cp_async_wait_all();\n\n  // this block's result",
     "    }\n    DA_PHASE(5);\n  }\n  cp_async_wait_all();\n\n"
     "  // this block's result"),
    ("  if (n_split == 1) return;\n",
     "  DA_PHASE(6);\n  if (n_split == 1) { DA_PHASE_END(); return; }\n"),
    ("  if (!is_last) return;\n",
     "  DA_PHASE(7);\n  if (!is_last) { DA_PHASE_END(); return; }\n"),
    ("  if (tid == 0) counters[group] = 0;\n}",
     "  if (tid == 0) counters[group] = 0;\n  DA_PHASE(8);\n"
     "  DA_PHASE_END();\n}"),
)


def instrumented_source(src: str):
    """(source with the phase marks live, phase names)."""
    if "DA_PHASE(" in src:
        m = re.search(r"^// phases: (.*)$", src, re.M)
        names = tuple(n.strip() for n in m.group(1).split(";"))
    else:
        for old, new in _SPLITK_ANCHORS:
            if src.count(old) != 1:
                raise RuntimeError(f"anchor not found once: {old!r}")
            src = src.replace(old, new)
        names = _SPLITK_NAMES
    return _PRELUDE + src + _EPILOGUE, names


def build(root: str):
    src_path = os.path.join(root, "infinisst_tpu_torch", "csrc",
                            "decode_attention.cu")
    with open(src_path) as f:
        src, names = instrumented_source(f.read())
    out_dir = os.path.join(root, "build", "attention_phases")
    os.makedirs(out_dir, exist_ok=True)
    cu = os.path.join(out_dir, "decode_attention_phases.cu")
    so = os.path.join(out_dir, "libdecode_attention_phases.so")
    with open(cu, "w") as f:
        f.write(src)
    subprocess.run([NVCC, "-O3", "-gencode=arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
                    "-cudart", "shared", "-DDA_PHASES",
                    "-I", os.path.dirname(src_path), "-o", so, cu],
                   check=True)
    lib = ctypes.CDLL(so)
    lib.da_phase_read.argtypes = [ctypes.c_void_p]
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
    """The beam step's two blocks at one path shape: ``rows`` query rows,
    ``P`` prefix caches of C slots (valid ``plen``), each row's per-beam
    buffer of G slots (valid ``g_valid``, key j at its prefix length +
    j); ``n_c`` copies of everything, so that a timed run reads cold."""

    def __init__(self, dev, gen, label, rows, P, C, plen, G, g_valid):
        H, KV, Dh = HEADS
        bf = torch.bfloat16
        i32 = dict(dtype=torch.int32, device=dev)
        self.label, self.rows, self.P, self.C, self.G = label, rows, P, C, G
        per_copy = 2 * (P * C + rows * G) * KV * Dh * 2
        self.n_c = max(1, math.ceil(2.4 * L2_BYTES / per_copy))

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev).to(bf)

        self.q = [rnd(rows, H, Dh) for _ in range(self.n_c)]
        self.pk = [rnd(P, C, KV, Dh) for _ in range(self.n_c)]
        self.pv = [rnd(P, C, KV, Dh) for _ in range(self.n_c)]
        self.gk = [rnd(rows, G, KV, Dh) for _ in range(self.n_c)]
        self.gv = [rnd(rows, G, KV, Dh) for _ in range(self.n_c)]
        self.plen = torch.tensor(plen, **i32)
        self.g_valid = torch.tensor(g_valid, **i32)
        self.g_off = self.plen.repeat_interleave(rows // P).contiguous()
        self.q_pos = (self.g_off + self.g_valid - 1).contiguous()
        from infinisst_tpu_torch.core import rope as R

        self.inv = torch.tensor(R.llama_rope_freqs(Dh), dtype=torch.float32,
                                device=dev)
        # SDPA's inputs: every row's prefix and per-beam keys concatenated
        # and rotated beforehand, (rows, KV, C + G, Dh), and the query
        # rotated, (rows, H, 1, Dh)
        pos = torch.cat([torch.arange(C, device=dev)[None].expand(rows, C),
                         self.g_off[:, None].long()
                         + torch.arange(G, device=dev)[None]], 1)
        slot = torch.arange(rows, device=dev) // (rows // P)
        self.sk, self.sv = [], []
        for i in range(self.n_c):
            k = torch.cat([self.pk[i][slot], self.gk[i]], 1).transpose(1, 2)
            v = torch.cat([self.pv[i][slot], self.gv[i]], 1).transpose(1, 2)
            self.sk.append(R.apply_llama_rope(k, pos[:, None], self.inv)
                           .contiguous())
            self.sv.append(v.contiguous())
        self.sq = [R.apply_llama_rope(q[:, :, None],
                                      self.q_pos.long()[:, None, None],
                                      self.inv) for q in self.q]
        j = torch.arange(C + G, device=dev)[None]
        self.mask = torch.where(j < C, j < self.plen[slot][:, None],
                                j - C < self.g_valid[:, None])[
                                    :, None, None, :]

    def prefix(self, A, i):
        i %= self.n_c
        return A.decode_attention(self.q[i], self.pk[i], self.pv[i],
                                  self.plen, self.q_pos, self.inv,
                                  return_lse=True)

    def per_beam(self, A, i):
        i %= self.n_c
        return A.decode_attention(self.q[i], self.gk[i], self.gv[i],
                                  self.g_valid, self.q_pos, self.inv,
                                  key_offset=self.g_off, return_lse=True)

    def step(self, A, i):
        """The beam step's attention as the checkout computes it."""
        if hasattr(A, "beam_attention"):
            k = i % self.n_c
            return A.beam_attention(self.q[k], self.pk[k], self.pv[k],
                                    self.plen, self.gk[k], self.gv[k],
                                    self.g_valid, self.g_off, self.q_pos,
                                    self.inv)
        o_p, l_p = self.prefix(A, i)
        o_g, l_g = self.per_beam(A, i)
        return A.merge_blocks(o_p, l_p, o_g, l_g), torch.logaddexp(l_p, l_g)

    def sdpa(self, i):
        import torch.nn.functional as F

        i %= self.n_c
        return F.scaled_dot_product_attention(
            self.sq[i], self.sk[i], self.sv[i], attn_mask=self.mask,
            enable_gqa=True)


CASES = (  # label, rows, P, C, plen (P,), G, g_valid (rows,)
    ("stream", 4, 1, 1280, [1000], 10, [4] * 4),
    ("pool", 32, 8, 1280, [1000] * 8, 10, [4] * 32),
    ("alignatt", 4, 1, 512, [447], 64, [1, 22, 43, 64]),
    ("streamatt", 4, 1, 256, [183], 64, [1, 22, 43, 64]),
    ("beam 1", 1, 1, 1280, [1000], 10, [4]),
)


def phase_split(lib, names, fn, n_c):
    """The median of TRIALS single launches of ``fn(i)``, each on a copy
    not touched by the previous one: per phase the mean microseconds of a
    block that reached it and the share of blocks that did; the blocks;
    the span from the first block's start to the last one's end."""
    nb = 3 * PHASE_BINS + 4
    buf = (ctypes.c_ulonglong * nb)()
    runs = []
    for t in range(TRIALS):
        torch.cuda.synchronize()
        if lib.da_phase_reset():
            raise RuntimeError("da_phase_reset failed")
        fn(t % n_c + 1)
        torch.cuda.synchronize()
        if lib.da_phase_read(ctypes.addressof(buf)):
            raise RuntimeError("da_phase_read failed")
        v = list(buf)
        blocks = v[2 * PHASE_BINS]
        ns_per_cycle = v[2 * PHASE_BINS + 1] / max(1, v[2 * PHASE_BINS + 4])
        ph = {}
        for i, name in enumerate(names):
            hits = v[PHASE_BINS + i]
            us = v[i] * ns_per_cycle / 1e3 / hits if hits else 0.0
            ph[name] = (us, hits / blocks)
        runs.append({"blocks": blocks, "phases": ph,
                     "span_us": (v[2 * PHASE_BINS + 3]
                                 - v[2 * PHASE_BINS + 2]) / 1e3,
                     "block_us": v[2 * PHASE_BINS + 1] / 1e3 / blocks,
                     "ghz": 1.0 / ns_per_cycle})
    runs.sort(key=lambda r: r["span_us"])
    return runs[len(runs) // 2]


def sweep_splits(A, c):
    """[(n_split, the beam step's ms)] at the shape of ``c``, the plan's
    split count replaced (the plan is a module function the wrapper looks
    up at each call)."""
    plan = A.plan
    H, KV, _ = HEADS
    base = plan(c.rows, c.P, c.C, KV, H // KV,
                torch.cuda.get_device_properties(0).multi_processor_count,
                c.G)
    out = []
    try:
        for n in (1, 2, 3, 4, 6, 8, 12, 16):
            if n > A.MAX_SPLIT:
                continue
            A.plan = lambda *a, **k: base._replace(n_split=n)
            out.append((n, graph_ms(lambda i: c.step(A, i))))
    finally:
        A.plan = plan
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    ap.add_argument("--sweep-splits", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("attention_phases: needs a CUDA card")
    dev = torch.device("cuda", 0)
    from infinisst_tpu_torch.kernels import decode_attention as A

    root = os.getcwd()
    lib, names = build(root)
    A._library()
    own = A._lib
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [Case(dev, gen, *c) for c in CASES]
    report = {"fused": hasattr(A, "beam_attention"), "cases": {}}
    for c in cases:
        row = {}
        for what, fn in (("prefix", c.prefix), ("per_beam", c.per_beam),
                         ("step", c.step)):
            if what == "step" and not report["fused"]:
                continue
            A._lib = A._bind(lib)
            row[f"{what}_phases"] = phase_split(
                lib, names, lambda i, f=fn: f(A, i), c.n_c)
            A._lib = own
        for what, fn in (("prefix", c.prefix), ("per_beam", c.per_beam),
                         ("step", c.step)):
            row[f"{what}_ms"] = graph_ms(lambda i, f=fn: f(A, i))
        row["sdpa_ms"] = graph_ms(c.sdpa)
        report["cases"][c.label] = row
        print(f"[phases] {c.label}: step {row['step_ms']:.5f} ms (prefix "
              f"{row['prefix_ms']:.5f}, per-beam {row['per_beam_ms']:.5f}), "
              f"SDPA {row['sdpa_ms']:.5f}", flush=True)
        if args.sweep_splits and report["fused"]:
            row["step_ms_by_splits"] = sweep_splits(A, c)
            print(f"[splits] {c.label}: " + ", ".join(
                f"{n} {ms:.5f}" for n, ms in row["step_ms_by_splits"]),
                flush=True)
        for k, v in row.items():
            if k.endswith("_phases"):
                split = ", ".join(f"{n} {us:.3f} us x{share:.2f}"
                                  for n, (us, share) in v["phases"].items())
                print(f"[phases]   {k}: {v['blocks']} blocks, span "
                      f"{v['span_us']:.2f} us, a block {v['block_us']:.2f}"
                      f" us at {v['ghz']:.3f} GHz: {split}", flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    report["device"] = smi
    text = json.dumps(report)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    print(smi)


if __name__ == "__main__":
    main()
