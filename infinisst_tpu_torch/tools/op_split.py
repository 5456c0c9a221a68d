"""Where a replayed stream chunk's, pool tick's and AlignAtt call's device
time goes, kernel by kernel: the port's kernels by name and every other
device op by its op (``op_family``), with launches and the idle share.

    python infinisst_tpu_torch/tools/op_split.py [--tree DIR] [--out PATH]
        [--group128]

(run as a file, not with -m, so that --tree's package is the one imported)

Runs the flagship W8A8 (Llama-3.1-8B geometry, seeded random weights) with
the ``infinisst_tpu_torch`` package of checkout ``--tree`` (default: the
one this file is in), so that two checkouts can be read by the same code
in one call: a stream agent (m = 1, beam 4) for four chunks, then one
replayed chunk under torch.profiler; a ServingEngine of 8 slots at beam 4
for five ticks, then one under the profiler; the bench's AlignAtt agent
for three calls of one 960 ms unit, then one replayed under the profiler.
With ``--group128``: the stream chunk alone, on ``bench.py --group128``'s
weights (grouped W8A8 projections, groups of 128; the pool and the
offline agents run per-channel W8A8 under that flag).  Prints one JSON
line a program (``--out`` also gets them) and the card's
name and power limit.  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time

# the port's kernels: the wrappers' launch counters' names, each matched by
# the first of them a device kernel's name contains (the grouped names
# before their substrings)
PORT_KERNELS = ("w8a8_grouped_gemm", "group_quant_int8", "w8a8_gemm",
                "row_quant_int8", "w8_bf16_gemm", "decode_attention",
                "beam_attention", "rms_norm_quant_int8",
                "silu_mul_quant_int8")

# the op of a PyTorch or library kernel, from its name: the first of these
# it contains (the functors and ops of ATen's elementwise, reduce and
# indexing kernels, then the libraries' GEMMs and the copies)
OP_FAMILIES = (
    ("MeanOps", "mean reduce"), ("MaxOps", "max reduce"),
    ("ArgMaxOps", "argmax reduce"), ("MinOps", "min reduce"),
    ("sum_functor", "sum reduce"), ("func_wrapper", "sum reduce"),
    ("norm_kernel", "norm reduce"), ("softmax", "softmax"),
    ("SoftMax", "softmax"), ("logsumexp", "logsumexp"),
    ("rsqrt", "rsqrt"), ("silu", "silu"), ("exp_kernel", "exp"),
    ("log_kernel", "log"), ("direct_copy", "copy / cast"),
    ("CatArrayBatchedCopy", "cat"), ("index_elementwise", "index"),
    ("indexSelect", "index_select"), ("index_put", "index_put"),
    ("indexFuncLargeIndex", "index_add / index_copy"),
    ("indexFuncSmallIndex", "index_add / index_copy"),
    ("gather", "gather"), ("scatter", "scatter"), ("sort", "sort"),
    ("topk", "topk"), ("TopK", "topk"), ("where", "where"),
    ("CompareEqFunctor", "compare"), ("CompareFunctor", "compare"),
    ("compare_", "compare"), ("FillFunctor", "fill"), ("fill", "fill"),
    ("AddFunctor", "add"), ("CUDAFunctor_add", "add"), ("add_kernel", "add"),
    ("MulFunctor", "mul"), ("mul_kernel", "mul"), ("DivFunctor", "div"),
    ("div_true", "div"), ("sub_kernel", "sub"), ("clamp", "clamp"),
    ("neg_kernel", "neg"), ("abs_kernel", "abs"), ("pow", "pow"),
    ("bitwise", "bitwise"), ("arange", "arange"),
    ("gemm", "library GEMM"), ("Gemm", "library GEMM"),
    ("cutlass", "library GEMM"), ("xmma", "library GEMM"),
    ("gemv", "library GEMV"), ("conv", "convolution"),
    ("Memcpy", "memcpy"), ("Memset", "memset"))


# a functor or kernel of ATen named inside a generic kernel's template
_FUNCTOR = re.compile(r"(\w+Functor\w*|\w+_kernel_cuda|\w+_kernel_impl)")
_GENERIC = ("gpu_kernel_impl", "gpu_kernel_impl_nocast",
            "unrolled_elementwise_kernel", "vectorized_elementwise_kernel")


def op_family(name: str) -> str:
    """The op of a device kernel's name (OP_FAMILIES), else the first
    functor or ATen kernel its template names, else its first 48
    characters."""
    op = next((op for key, op in OP_FAMILIES if key in name), None)
    if op is None:
        op = next((f for f in _FUNCTOR.findall(name) if f not in _GENERIC),
                  name[:48])
    return op


def port_kernel(name: str):
    """The port's kernel (PORT_KERNELS) a device kernel's name is, or
    None."""
    return next((k for k in PORT_KERNELS if k in name), None)


def tally(averages):
    """A profile's ``key_averages()`` device kernels as (port, other):
    (ms, launches) by port kernel, and the rest by op (``op_family``).
    Profiler ranges (``stage::`` names) are left out."""
    from torch.autograd import DeviceType

    port, other = {}, {}
    for e in averages:
        if (e.device_type != DeviceType.CUDA
                or e.self_device_time_total <= 0
                or e.key.startswith("stage::")):
            continue
        ms = e.self_device_time_total / 1e3
        g = port_kernel(e.key)
        d, key = (port, g) if g else (other, op_family(e.key))
        t, n = d.get(key, (0.0, 0))
        d[key] = (t + ms, n + e.count)
    return port, other


def split(prof, wall_ms: float) -> dict:
    """A profile's device kernels: ms and launches by port kernel, the
    rest by op, and the idle share against ``wall_ms``."""
    port, other = tally(prof.key_averages())
    busy = sum(t for t, _ in port.values()) + sum(t for t, _ in
                                                  other.values())

    def rows(d):
        return {k: [round(t, 4), n] for k, (t, n) in
                sorted(d.items(), key=lambda kv: -kv[1][0])}

    return {"wall_ms": round(wall_ms, 3), "device_ms": round(busy, 3),
            "idle_share": round(1.0 - busy / wall_ms, 4),
            "port_ms": round(sum(t for t, _ in port.values()), 3),
            "other_ms": round(sum(t for t, _ in other.values()), 3),
            "port": rows(port), "other": rows(other)}


def profiled(dev, step) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)  # the device's first records land in the window
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize(dev)
        wall = (time.perf_counter() - t0) * 1e3
        time.sleep(0.05)
    return split(prof, wall)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__)))))
    ap.add_argument("--out", default=None)
    ap.add_argument("--group128", action="store_true")
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree)
    # the checkout's package first; not this file's directory, which a
    # script run puts first
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [tree] + [p for p in sys.path
                            if os.path.abspath(p or ".") != here]
    import numpy as np
    import torch

    import infinisst_tpu_torch
    from infinisst_tpu_torch import bench
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent, InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.kernels import _build
    from infinisst_tpu_torch.serve.engine import ServingEngine

    if not os.path.abspath(infinisst_tpu_torch.__file__).startswith(tree):
        raise SystemExit(f"imported {infinisst_tpu_torch.__file__}, not "
                         f"the package of {tree}")
    dev = torch.device("cuda")
    _build.load_all()
    cfg, params = bench.flagship_params(
        dev, act_int8=True, group_size=128 if args.group128 else 0)
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    out = []

    def emit(what, rec):
        rec = {"tree": tree, "what": what, **rec}
        out.append(rec)
        print(json.dumps(rec), flush=True)

    rng = np.random.RandomState(0)
    agent = InfiniSSTAgent(params, cfg, StreamConfig(), builder,
                           InfiniSSTOptions(latency_multiplier=1, beam=4),
                           param_dtype=torch.bfloat16, device=dev)

    def chunk():
        agent.push(rng.randn(agent.chunk_samples).astype(np.float32) * 0.1,
                   finished=False)

    for _ in range(4):
        chunk()
    rec = profiled(dev, chunk)
    emit("group128 stream chunk" if args.group128 else "stream chunk",
         {**rec, "beam_steps": agent.last_result.steps})
    del agent
    torch.cuda.empty_cache()
    # the pool and the offline agents run per-channel W8A8 (bench.py)
    if not args.group128:
        eng = ServingEngine(params, cfg, StreamConfig(),
                            {("English", "German"): builder}, pool_size=8,
                            beam=4, dtype=torch.bfloat16, device=dev)
        slots = [eng.open_stream(f"c{i}") for i in range(eng.pool)]

        def tick():
            for s in slots:
                eng.push_audio(s, rng.randn(eng.chunk_samples).astype(
                    np.float32) * 0.1)
            eng.tick()

        for _ in range(5):
            tick()
        fwd = eng.forwards["token"]
        rec = profiled(dev, tick)
        emit("pool tick",
             {**rec, "token_forwards": eng.forwards["token"] - fwd})
        del eng
        torch.cuda.empty_cache()

        agent = bench.offline_agent("alignatt", False, cfg, params, dev)

        def call():
            agent.push(rng.randn(15360).astype(np.float32) * 0.1,
                       finished=False)

        for _ in range(3):
            call()
        rec = profiled(dev, call)
        emit("alignatt call", {**rec, "beam_steps": agent.last_result.steps,
                               "graph": agent.last_graph})
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            for rec in out:
                f.write(json.dumps({**rec, "card": card}) + "\n")


if __name__ == "__main__":
    main()
