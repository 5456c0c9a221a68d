"""Streaming RTF bench of the port: the streaming modes of the JAX
package's ``bench.py``, on the card.

    python -m infinisst_tpu_torch.bench                 # flagship W8A8, m=1
    python -m infinisst_tpu_torch.bench --group128      # per-group scales
    python -m infinisst_tpu_torch.bench --schedule 1,1,1,2,2,4,4

Prints ONE JSON line on stdout, as ``bench.py`` does:
  {"metric": ..., "value": RTF, "unit": "rtf", "vs_baseline": ..., ...}

The headline is computation-only streaming RTF (wall time of a chunk's
``push`` / the chunk's audio seconds) at latency multiplier 1 with beam 4;
``vs_baseline`` is the reference's L40S RTF at the same multiplier over
ours (>1 = faster).  The first ``WARMUP`` chunks are not timed; there is
no synchronise per chunk (``push`` returns once the chunk's tokens are on
the host) and one after the loop.  At most one chunk above 3x the median
is dropped from the mean, and the drop is reported; two or more are kept.

``--model 8b`` (default) is the flagship geometry: wav2vec2-large +
Llama-3.1-8B with int8 W8A8 projections and lm_head (``--no-act-int8``:
weight-only projections; ``--bf16-head``: a bf16 head; ``--group128`` or
``--group-size N``: per-group scales, ``--group-head`` for the head too).
``--model bench`` is the ~1.5B decoder in bf16 (``--quantize``:
weight-only int8 projections through ``InfiniSSTOptions.quantize``).
Weights are random, made on the card from seeded ``torch.Generator``s; RTF
does not depend on their values.  The serving, training and offline-agent
modes and the speculative decoders are not ported yet.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

# En-De RTF per latency multiplier of the reference on an L40S
# (BASELINE.md, plots/plot.ipynb cell 9)
BASELINE_RTF = {1: 0.382, 2: 0.286, 3: 0.250, 4: 0.235}
WARMUP = 3
UNPORTED_MODES = ("serve", "train", "train-io", "streamatt", "alignatt")


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("8b", "bench"), default="8b")
    p.add_argument("--mode", default="stream",
                   choices=("stream",) + UNPORTED_MODES)
    p.add_argument("--chunks", type=int, default=12)
    p.add_argument("--multiplier", type=int, default=1, choices=(1, 2, 3, 4))
    p.add_argument("--no-act-int8", action="store_true")
    p.add_argument("--bf16-head", action="store_true")
    p.add_argument("--group128", action="store_true")
    p.add_argument("--group-size", type=int, default=None)
    p.add_argument("--group-head", action="store_true")
    p.add_argument("--quantize", action="store_true")
    p.add_argument("--schedule", type=str, default=None,
                   help="per-chunk latency multipliers, e.g. 1,1,2,4")
    p.add_argument("--multi-stream", type=int, nargs="?", const=3,
                   default=None, metavar="S",
                   help="S streams of >= 30 chunks through one agent")
    p.add_argument("--speculative", action="store_true")
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def group_size(args) -> int:
    if args.group_size is not None:
        return args.group_size
    return 128 if args.group128 else 0


def model_tag(args) -> str:
    """The configuration part of the metric name (``bench.py:148-160``)."""
    if args.model == "8b":
        gs = group_size(args)
        return ("8b_int8" + (f"_g{gs}" if gs else "")
                + ("h" if gs and args.group_head else ""))
    return "1chip" + ("_int8" if args.quantize else "")


def metric_name(args) -> str:
    tag = model_tag(args)
    if args.multi_stream is not None:
        return f"streaming_rtf_m{args.multiplier}_beam4_{tag}_multistream"
    if args.schedule is not None:
        return "streaming_rtf_mswitch_beam4_" + tag
    return f"streaming_rtf_m{args.multiplier}_beam4_{tag}"


def flagship_params(device, act_int8=True, speech=None, group_size=0,
                    lm_head_int8=True, head_group_size=0):
    """(config, parameters) of the flagship: wav2vec2-large and the
    adapter in bf16, Llama-3.1-8B with int8 projections (W8A8, or
    weight-only without ``act_int8``) and a W8A8 (or bf16) lm_head, drawn
    on ``device`` from one generator seeded 0.  ``speech`` reuses the
    encoder and adapter of an earlier call."""
    from infinisst_tpu_torch.core.presets import flagship_config
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.models.quant import init_quantized_llama

    cfg = flagship_config()
    gen = torch.Generator(device=device).manual_seed(0)
    if speech is None:
        speech = {
            "w2v2": W.init_params(cfg.w2v2, gen, device, torch.bfloat16),
            "adapter": A.init_params(cfg.adapter, gen, device,
                                     torch.bfloat16),
        }
    llama = init_quantized_llama(
        cfg.llama, gen, device, embed_dtype=torch.bfloat16,
        act_int8=act_int8, lm_head_int8=lm_head_int8, group_size=group_size,
        head_group_size=head_group_size,
    )
    return cfg, dict(speech, llama=llama)


def build_agent(args):
    """The bench's agent: its model, m, beam 4, the default stream."""
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent,
        InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import bench_1chip_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train.main import random_params

    dev = resolve_device(args.device)
    quantize = False
    if args.model == "8b":
        gs = group_size(args)
        cfg, params = flagship_params(
            dev, act_int8=not args.no_act_int8, group_size=gs,
            lm_head_int8=not args.bf16_head,
            head_group_size=gs if args.group_head else 0,
        )
    else:
        cfg = bench_1chip_config()
        params = random_params(cfg, dev, torch.bfloat16)
        quantize = args.quantize
    stream = StreamConfig()
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    opts = InfiniSSTOptions(
        latency_multiplier=args.multiplier, beam=4,
        max_llm_cache_size=stream.max_llm_cache_tokens, quantize=quantize,
    )
    return InfiniSSTAgent(params, cfg, stream, builder, opts,
                          param_dtype=torch.bfloat16, device=dev)


def _sync(agent):
    if agent.device.type == "cuda":
        torch.cuda.synchronize(agent.device)


def run_stream(agent, n_chunks: int, warmup: int = WARMUP, schedule=None,
               rng=None, log=None) -> dict:
    """Push ``n_chunks`` chunks of seeded noise (``randn * 0.1``) and time
    each ``push``; chunk i runs at ``schedule[i]`` when a schedule is
    given.  Returns the times and RTFs of the chunks after ``warmup``, the
    trim count after each of them, and the tokens emitted."""
    rng = np.random.RandomState(0) if rng is None else rng
    times, rtfs, evict_marks = [], [], []
    for i in range(n_chunks):
        if schedule is not None and \
                schedule[i] != agent.opts.latency_multiplier:
            agent.update_multiplier(schedule[i])
        chunk = agent.chunk_samples
        audio = rng.randn(chunk).astype(np.float32) * 0.1
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        dt = time.perf_counter() - t0
        if log is not None:
            print(f"chunk {i} (m={agent.opts.latency_multiplier}): "
                  f"{dt:.3f}s", file=log, flush=True)
        if i >= warmup:
            times.append(dt)
            rtfs.append(dt / (chunk / 16000.0))
            evict_marks.append(int(agent.evictions))
    _sync(agent)  # untimed straggler sync
    return dict(times=times, rtfs=rtfs, evict_marks=evict_marks,
                tokens=len(agent.states.target_ids))


def drop_outlier(times):
    """(kept, dropped, median): exactly one chunk above 3x the median is
    dropped; two or more are a recurring stall and are all kept."""
    med = float(np.median(times))
    outliers = sorted(t for t in times if t > 3 * med)
    kept = list(times)
    dropped = []
    if len(outliers) == 1:
        kept.remove(outliers[0])
        dropped = [outliers[0]]
    return kept, dropped, med


def summarize(run: dict, multiplier: int, metric: str,
              chunk_sec: float) -> dict:
    """The JSON line of a single stream (``bench.py:410-522``)."""
    times, rtfs, marks = run["times"], run["rtfs"], run["evict_marks"]
    kept, dropped, med = drop_outlier(times)
    rtf = float(np.mean(kept)) / chunk_sec
    result = {
        "metric": metric,
        "value": round(rtf, 4),
        "unit": "rtf",
        "vs_baseline": round(BASELINE_RTF[multiplier] / rtf, 3),
        "outliers_dropped": len(dropped),
        "dropped_s": [round(t, 3) for t in dropped],
        "rtf_untrimmed_mean": round(float(np.mean(times)) / chunk_sec, 4),
        "rtf_median": round(med / chunk_sec, 4),
        "rtf_p95": round(float(np.percentile(times, 95)) / chunk_sec, 4),
    }
    if marks and marks[-1] > 0:
        # RTF on both sides of the first trim
        first_ev = next(j for j, e in enumerate(marks) if e > 0)
        pre = [r for r, t in zip(rtfs[:first_ev], times[:first_ev])
               if t not in dropped]
        post = [r for r, t in zip(rtfs[first_ev:], times[first_ev:])
                if t not in dropped]
        result["evictions"] = marks[-1]
        result["first_evict_timed_chunk"] = first_ev
        if pre and post:
            result["rtf_pre_evict_mean"] = round(float(np.mean(pre)), 4)
            result["rtf_post_evict_mean"] = round(float(np.mean(post)), 4)
            result["evict_rtf_delta"] = round(
                float(np.mean(post)) - float(np.mean(pre)), 4
            )
    return result


def summarize_schedule(run: dict, metric: str) -> dict:
    """The ``--schedule`` line: the median of the per-chunk RTFs (the first
    chunk at a new multiplier is reported on stderr, not trimmed)."""
    rtf = float(np.median(run["rtfs"]))
    return {"metric": metric, "value": round(rtf, 4), "unit": "rtf",
            "vs_baseline": round(BASELINE_RTF[1] / rtf, 3)}


def summarize_multistream(pooled, stream_means, multiplier: int,
                          metric: str, per_stream: int) -> dict:
    rtf = float(np.mean(pooled))
    return {
        "metric": metric,
        "value": round(rtf, 4),
        "unit": "rtf",
        "vs_baseline": round(BASELINE_RTF[multiplier] / rtf, 3),
        "streams": len(stream_means),
        "chunks_per_stream": per_stream,
        "chunks_pooled": len(pooled),
        "rtf_median": round(float(np.median(pooled)), 4),
        "rtf_p95": round(float(np.percentile(pooled, 95)), 4),
        "rtf_p99": round(float(np.percentile(pooled, 99)), 4),
        "stream_means": [round(x, 4) for x in stream_means],
        "stream_mean_spread": round(max(stream_means) - min(stream_means), 4),
    }


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.mode != "stream" or args.speculative:
        what = (f"--mode {args.mode}" if args.mode != "stream"
                else "--speculative")
        print(f"{what} is not ported yet: the port's bench runs the "
              "plain streaming mode only", file=sys.stderr)
        sys.exit(2)
    metric = metric_name(args)
    from infinisst_tpu_torch.core.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        from infinisst_tpu_torch.kernels import _build

        _build.load_all()  # one nvcc per source, all at once
    agent = build_agent(args)
    print(f"agent ready on {agent.device}", file=sys.stderr, flush=True)
    log = sys.stderr
    schedule = None
    n_chunks = args.chunks
    if args.schedule is not None:
        schedule = [int(x) for x in args.schedule.split(",")]
        n_chunks = len(schedule)

    if args.multi_stream is not None:
        # S streams (seeds 100 + s) through one agent, reset in between;
        # only stream 0's first chunks are untimed
        per_stream = max(n_chunks, 30)
        pooled, stream_means = [], []
        for s in range(args.multi_stream):
            if s > 0:
                agent.reset()
            run = run_stream(agent, per_stream, warmup=WARMUP if s == 0
                             else 0, rng=np.random.RandomState(100 + s))
            pooled.extend(run["rtfs"])
            stream_means.append(float(np.mean(run["rtfs"])))
            print(f"stream {s}: chunks={len(run['rtfs'])} "
                  f"mean={np.mean(run['rtfs']):.4f} "
                  f"p95={np.percentile(run['rtfs'], 95):.4f}", file=log,
                  flush=True)
        result = summarize_multistream(pooled, stream_means, args.multiplier,
                                       metric, per_stream)
    else:
        chunk_sec = agent.chunk_samples / 16000.0
        run = run_stream(agent, n_chunks, schedule=schedule, log=log)
        if schedule is not None:
            result = summarize_schedule(run, metric)
            print(f"schedule={schedule} chunks={len(run['times'])} per-chunk "
                  f"RTFs={[round(r, 3) for r in run['rtfs']]}", file=log)
        else:
            result = summarize(run, args.multiplier, metric, chunk_sec)
            t = run["times"]
            print(f"chunks={len(t)} mean={np.mean(t) * 1e3:.1f}ms "
                  f"p50={np.percentile(t, 50) * 1e3:.1f}ms "
                  f"p90={np.percentile(t, 90) * 1e3:.1f}ms "
                  f"tokens={run['tokens']} device={agent.device}", file=log)
    from infinisst_tpu_torch.kernels import decode_attention, quant_matmul

    counts = dict(quant_matmul.launch_counts)
    counts.update(decode_attention.launch_counts)
    print("kernel launches " + json.dumps(counts), file=log, flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
