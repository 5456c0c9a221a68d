"""Streaming RTF, pooled serving, offline-agent and training bench of the
port: the streaming (plain, sampling and speculative), serve, AlignAtt,
StreamAtt and training modes of the JAX package's ``bench.py``, on the
card.

    python -m infinisst_tpu_torch.bench                 # flagship W8A8, m=1
    python -m infinisst_tpu_torch.bench --speculative [--spec-beam]
    python -m infinisst_tpu_torch.bench --do-sample [--speculative]
    python -m infinisst_tpu_torch.bench --mode serve --speculative
    python -m infinisst_tpu_torch.bench --group128      # per-group scales
    python -m infinisst_tpu_torch.bench --schedule 1,1,1,2,2,4,4
    python -m infinisst_tpu_torch.bench --mode serve    # pool 8, beam 4
    python -m infinisst_tpu_torch.bench --mode serve --multipliers 1,2
    python -m infinisst_tpu_torch.bench --mode alignatt [--early-stop]
    python -m infinisst_tpu_torch.bench --mode streamatt
    python -m infinisst_tpu_torch.bench --mode train [--batch 2]
    python -m infinisst_tpu_torch.bench --mode train-io

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
does not depend on their values.

``--mode serve`` (``bench.py:547-779``) drives ``serve/engine.py``'s
``ServingEngine``: ``--pool`` streams (8) at ``--beam`` (4), one untimed
tick, then ``--chunks`` ticks of one chunk of seeded noise per stream;
the value is decoded tokens per second of wall over the timed ticks, in
``tok/s/chip``, ``vs_baseline`` that over 30 tok/s, beside the p50 / p95 /
p99 of the tick wall each slot saw for its chunks; the per-stream RTF
goes to stderr.  ``--multipliers 1,2`` runs a mixed pool (slots
round-robin over the set, audio in 960 ms units, one untimed chunk per
slot, then ``--chunks`` x m_max ticks); ``--churn`` closes and reopens
two slots halfway.  Its ``--model 8b`` is the flagship W8A8 (per-channel
scales only), ``--model bench`` the bf16 ~1.5B decoder.  The tick is a
device program, captured as CUDA graphs in the untimed tick (the
greedy one in the tick the speculative guard trips); stderr has each
tick's host reads and ``pool programs {...}`` (captured, replays).

``--mode alignatt`` and ``--mode streamatt`` (``bench.py:782-931``) push
960 ms chunks of seeded noise through the baseline agents on the flagship
W8A8 model with the bf16 encoder (whatever ``--model`` says), beam 4,
``frame_num`` 2: AlignAtt recomputes the whole (28.8 s-capped) audio and
the target prefix every call, one audio bucket (every call at the 28.8 s
shape) and the last 64 target ids, max(``--chunks``, 12) chunks of which
the first 3 are untimed (``--early-stop``: the in-loop attention stop);
StreamAtt runs a Chinese target (every token a word, so the stub
tokenizer's text is pruned as a real stream's), 10-unit audio buckets and
the early stop over max(``--chunks``, 40) chunks, timed from chunk 32 on
(the 28.8 s steady state).  The value is the mean chunk wall over 0.96 s,
``vs_baseline`` the best reference StreamAtt RTF on an L40S (0.67) over
it, with the median and p95; each chunk's wall, beam steps and prompt
bucket go to stderr.

``--speculative`` (``bench.py:163-262``, ``:438-490``) runs the stream by
speculative greedy (``--spec-beam``: speculative beam 4; ``--do-sample``:
speculative sampling) with a draft of ``--spec-draft-layers`` (8) layers
and ``--spec-k`` (4) tokens a round, the acceptance guard on unless
``--spec-no-guard``; ``--spec-accept-all`` accepts every draft token (the
machinery's ceiling), ``--spec-head-vocab N`` gives the draft a shortlist
head, ``--spec-lowrank-rank r`` and ``--spec-adapter-rank r`` random
low-rank head factors and a random exit adapter (made on the card), and
``--spec-resid-scale a`` scales the output projections (``wo``,
``w_down``) of the layers above the draft by a (0 makes them identities,
so the draft agrees with the target through the real verify).  The JSON
line adds ``accept_rate``, ``rounds``, ``emitted``, ``guard_fallback``,
``fallback_warmed`` (always false: eager PyTorch has no fallback graph to
compile ahead) and ``breakeven_tokens_per_round``.  ``--do-sample`` alone
runs the plain sampler (``--temperature``, ``--top-k``).  In serve mode
``--speculative`` runs the pool by speculative greedy at beam 1
(``--do-sample``: speculative sampling).  Every mode also prints the
model's forward passes by function and depth (``model forwards``) beside
the kernel launches.

``--mode train`` and ``--mode train-io`` (``bench.py:939-1215``) run
stage 1 (the LLM frozen, the encoder and adapter trained; remat on,
encoder dropout 0) on the ~1.5B ``bench`` preset in bfloat16 with 28.8 s
windows (1440 frames, 360 speech tokens + 240 target tokens a row).
``train`` times 12 steps of ``train.step.TrainProgram`` (2 untimed; the
step captured as CUDA graphs at its first, replayed after) at
``--batch`` rows (2), each batch made in pinned host memory before its
step, copied into the program's static batch by the step (~3.7 MB at
B = 2), and the step synchronised: metric
train_stage1_speech_s_per_s_1chip_1.5b, speech seconds trained per
second.  ``train-io`` runs the real input pipeline
(TSV + wav files written under a temporary directory -> SpeechSampler ->
collator 4 at m = 1 -> ``Trainer._prefetch(depth=2)`` -> steps): 2 synced
warmup steps, 2 synced probe steps, then 12 steps dispatched back to back
with one final sync (``Trainer.fit``'s regime between log points):
metric train_stage1_speech_s_per_s_realio_1chip_1.5b.  Step times,
losses and the peak of ``torch.cuda.max_memory_allocated`` go to stderr.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from infinisst_tpu_torch.core import graphs

# En-De RTF per latency multiplier of the reference on an L40S
# (BASELINE.md, plots/plot.ipynb cell 9)
BASELINE_RTF = {1: 0.382, 2: 0.286, 3: 0.250, 4: 0.235}
WARMUP = 3
TRAIN_MODES = ("train", "train-io")
OFFLINE_MODES = ("alignatt", "streamatt")
SERVE_TARGET_TOK_S = 30.0  # bench.py's serving vs_baseline denominator
# the offline agents' vs_baseline numerator: the best reference StreamAtt+
# RTF on an L40S (BASELINE.md, plots cell 9)
OFFLINE_BASELINE_RTF = 0.67
ALIGNATT_MIN_CHUNKS, ALIGNATT_WARMUP = 12, 3
STREAMATT_MIN_CHUNKS, STREAMATT_TIMED_FROM = 40, 32


def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--model", choices=("8b", "bench"), default="8b")
    p.add_argument("--mode", default="stream",
                   choices=("stream", "serve") + OFFLINE_MODES
                   + TRAIN_MODES)
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
    # --mode serve
    p.add_argument("--pool", type=int, default=8)
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--multipliers", type=str, default=None,
                   help="a mixed serving pool, e.g. 1,2")
    p.add_argument("--churn", action="store_true")
    # --mode alignatt
    p.add_argument("--early-stop", action="store_true")
    # the speculative stack and sampling (stream and serve modes)
    p.add_argument("--speculative", action="store_true")
    p.add_argument("--spec-draft-layers", type=int, default=8)
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--spec-accept-all", action="store_true")
    p.add_argument("--spec-head-vocab", type=int, default=0)
    p.add_argument("--spec-beam", action="store_true")
    p.add_argument("--spec-no-guard", action="store_true")
    p.add_argument("--spec-lowrank-rank", type=int, default=0)
    p.add_argument("--spec-resid-scale", type=float, default=None)
    p.add_argument("--spec-adapter-rank", type=int, default=0)
    p.add_argument("--do-sample", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    # --mode train
    p.add_argument("--batch", type=int, default=2)
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


def serve_multipliers(args):
    if args.multipliers is None:
        return None
    return tuple(int(x) for x in args.multipliers.split(","))


def spec_tag(args) -> str:
    """The decode part of a speculative stream's metric
    (``bench.py:459-477``)."""
    return ("spec" + ("_beam4" if args.spec_beam else "")
            + ("_sample" if args.do_sample else "")
            + ("_acceptall" if args.spec_accept_all else "")
            + f"_d{args.spec_draft_layers}k{args.spec_k}"
            + (f"_hv{args.spec_head_vocab // 1000}k"
               if args.spec_head_vocab else "")
            + (f"_lr{args.spec_lowrank_rank}" if args.spec_lowrank_rank
               else "")
            + (f"_ada{args.spec_adapter_rank}" if args.spec_adapter_rank
               else "")
            + (f"_ra{args.spec_resid_scale:g}"
               if args.spec_resid_scale is not None else ""))


def serve_decode_tag(args, mixed: bool) -> str:
    """The decode part of a serve metric (``bench.py:662-670``,
    ``:732-738``)."""
    if not args.speculative:
        return f"beam{args.beam}"
    return (f"spec{'S' if args.do_sample else ''}"
            f"{'AA' if args.spec_accept_all else ''}"
            f"d{args.spec_draft_layers}k{args.spec_k}"
            + (f"hv{args.spec_head_vocab // 1000}k" if args.spec_head_vocab
               else "")
            + (f"ra{args.spec_resid_scale:g}"
               if mixed and args.spec_resid_scale is not None else ""))


def metric_name(args) -> str:
    if args.mode == "alignatt":  # bench.py:918-920
        return ("alignatt_rtf_beam4_"
                f"{'es' if args.early_stop else 'parity'}_8b_int8")
    if args.mode == "streamatt":  # bench.py:843
        return "streamatt_rtf_beam4_8b_int8"
    if args.mode == "serve":
        # bench.py:701-706 (mixed pool) and :761-763
        tag = "8b_int8" if args.model == "8b" else "1chip"
        mults = serve_multipliers(args)
        head = (f"serve_decode_tok_per_s_pool{args.pool}_"
                f"{serve_decode_tag(args, bool(mults))}_")
        if mults:
            return head + f"mixedm{'x'.join(map(str, mults))}_{tag}"
        return (head + f"m{args.multiplier}"
                + ("_churn" if args.churn else "") + f"_{tag}")
    tag = model_tag(args)
    if args.multi_stream is not None:
        return f"streaming_rtf_m{args.multiplier}_beam4_{tag}_multistream"
    if args.schedule is not None:
        return "streaming_rtf_mswitch_beam4_" + tag
    if args.speculative:
        return f"streaming_rtf_m{args.multiplier}_{spec_tag(args)}_{tag}"
    dec = "sample" if args.do_sample else "beam4"
    return f"streaming_rtf_m{args.multiplier}_{dec}_{tag}"


def flagship_params(device, act_int8=True, speech=None, group_size=0,
                    lm_head_int8=True, head_group_size=0, cfg=None):
    """(config, parameters) of the flagship: wav2vec2-large and the
    adapter in bf16, Llama-3.1-8B with int8 projections (W8A8, or
    weight-only without ``act_int8``) and a W8A8 (or bf16) lm_head, drawn
    on ``device`` from one generator seeded 0.  ``speech`` reuses the
    encoder and adapter of an earlier call; ``cfg`` draws the same recipe
    at another preset's widths."""
    from infinisst_tpu_torch.core.presets import flagship_config
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import wav2vec2 as W
    from infinisst_tpu_torch.models.quant import init_quantized_llama

    cfg = cfg or flagship_config()
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
    spec_kw = {}
    if args.speculative:
        spec_kw, params = spec_options(args, cfg, params, dev)
    if args.do_sample:
        spec_kw.update(do_sample=True, temperature=args.temperature,
                       top_k=args.top_k)
    opts = InfiniSSTOptions(
        latency_multiplier=args.multiplier, beam=4,
        max_llm_cache_size=stream.max_llm_cache_tokens, quantize=quantize,
        **spec_kw,
    )
    return InfiniSSTAgent(params, cfg, stream, builder, opts,
                          param_dtype=torch.bfloat16, device=dev)


def scale_residuals(params, d_cut: int, alpha: float):
    """``--spec-resid-scale``: the output projections (``wo``,
    ``w_down``) of every layer from ``d_cut`` on scaled by ``alpha`` (on
    the int8 leaves, their scales), so at 0 those layers add nothing."""
    lyr = dict(params["llama"]["layers"])
    for key in ("wo", "w_down"):
        w = lyr[key]
        if isinstance(w, dict):
            w = dict(w)
            skey = "scale_a8" if "scale_a8" in w else "scale"
            w[skey] = w[skey].clone()
            w[skey][d_cut:] *= alpha
        else:
            w = w.clone()
            w[d_cut:] *= alpha
        lyr[key] = w
    return dict(params, llama=dict(params["llama"], layers=lyr))


def spec_options(args, cfg, params, dev):
    """The stream's speculative options (``bench.py:170-262``) and its
    parameters (scaled by ``--spec-resid-scale``): random low-rank head
    factors and a random exit adapter, made on the card from seeded
    generators (their values move only the acceptance, near 0 with
    random weights either way)."""
    kw = dict(speculative=True, spec_draft_layers=args.spec_draft_layers,
              spec_k=args.spec_k, spec_accept_all=args.spec_accept_all,
              spec_head_vocab=args.spec_head_vocab, spec_beam=args.spec_beam,
              spec_guard=not args.spec_no_guard)
    D, V = cfg.llama.hidden_size, cfg.llama.vocab_size
    bf16 = torch.bfloat16
    if args.spec_lowrank_rank:
        r = args.spec_lowrank_rank
        g = torch.Generator(device=dev).manual_seed(11)
        kw["spec_lowrank_head"] = {
            "a": (torch.randn((D, r), generator=g, device=dev)
                  / D ** 0.5).to(bf16),
            "b": (torch.randn((r, V), generator=g, device=dev)
                  / r ** 0.5).to(bf16)}
    if args.spec_resid_scale is not None:
        params = scale_residuals(params, args.spec_draft_layers,
                                 args.spec_resid_scale)
    if args.spec_adapter_rank:
        r = args.spec_adapter_rank
        g = torch.Generator(device=dev).manual_seed(7)
        kw["spec_adapter"] = {
            "ln": torch.ones((D,), dtype=bf16, device=dev),
            "w1": (torch.randn((D, r), generator=g, device=dev)
                   * 0.02).to(bf16),
            "w2": (torch.randn((r, D), generator=g, device=dev)
                   * 0.02).to(bf16)}
    return kw, params


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


def spec_fields(agent) -> dict:
    """A speculative stream's fields of the JSON line
    (``bench.py:479-495``)."""
    acc = (agent.spec_accepted / agent.spec_drafted if agent.spec_drafted
           else 0.0)
    be = agent._spec_breakeven
    return {
        "accept_rate": round(acc, 4),
        "rounds": agent.spec_rounds,
        "emitted": agent.spec_emitted,
        "guard_fallback": bool(agent.spec_fallback_active),
        "fallback_warmed": False,  # eager PyTorch: nothing compiled ahead
        "breakeven_tokens_per_round": None if be is None else round(be, 3),
    }


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


def build_engine(args):
    """The serve mode's engine (``bench.py:572-628``): its model, the
    default stream, one English-German builder, bf16."""
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import bench_1chip_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.serve.engine import ServingEngine
    from infinisst_tpu_torch.train.main import random_params

    dev = resolve_device(args.device)
    if args.model == "8b":
        cfg, params = flagship_params(dev, act_int8=True)
    else:
        cfg = bench_1chip_config()
        params = random_params(cfg, dev, torch.bfloat16)
    builders = {("English", "German"): PromptBuilder(
        StubTokenizer(cfg.llama.vocab_size), cfg.tokens)}
    spec = dict(do_sample=args.do_sample)  # pooled sampling needs
    # --speculative: the engine refuses it alone, as the JAX engine does
    if args.speculative:
        if args.spec_resid_scale is not None:
            params = scale_residuals(params, args.spec_draft_layers,
                                     args.spec_resid_scale)
        spec = dict(speculative=True,
                    spec_draft_layers=args.spec_draft_layers,
                    spec_k=args.spec_k, spec_guard=not args.spec_no_guard,
                    spec_accept_all=args.spec_accept_all,
                    spec_head_vocab=args.spec_head_vocab,
                    do_sample=args.do_sample, temperature=args.temperature,
                    top_k=args.top_k)
    return ServingEngine(
        params, cfg, StreamConfig(), builders, pool_size=args.pool,
        multiplier=args.multiplier, dtype=torch.bfloat16,
        beam=1 if args.speculative else args.beam,
        multipliers=serve_multipliers(args), device=dev, **spec,
    )


def run_serve(eng, n_chunks: int, multipliers=None, churn=False, rng=None,
              log=None) -> dict:
    """Open every slot, warm up, then time ``n_chunks`` ticks of one chunk
    of seeded noise per slot (``bench.py:640-779``).  A mixed pool
    (``multipliers``) gets 960 ms units, one per slot a tick, m_max warm-up
    ticks and n_chunks x m_max timed ones; ``churn`` closes and reopens
    the first two slots halfway (uniform pool only).  Returns the wall,
    the tokens decoded over the timed ticks, each slot's chunk latency
    (the wall of the tick its chunk prefilled in), and the tick walls."""
    rng = np.random.RandomState(0) if rng is None else rng
    pool = eng.pool

    def noise(n):
        return rng.randn(n).astype(np.float32) * 0.1

    if multipliers:
        ms = [multipliers[i % len(multipliers)] for i in range(pool)]
        slots = [eng.open_stream(f"c{i}", multiplier=ms[i])
                 for i in range(pool)]
        push = eng.stream.chunk_samples(1)
        warm = max(multipliers)
        n_ticks = n_chunks * warm
    else:
        slots = [eng.open_stream(f"c{i}") for i in range(pool)]
        push, warm, n_ticks = eng.chunk_samples, 1, n_chunks
    for _ in range(warm):
        for s in slots:
            eng.push_audio(s, noise(push))
        eng.tick()
    base = {s: len(eng.slots[s].target_ids) for s in slots}
    churn_tick = n_ticks // 2 if churn and not multipliers else None
    tok_closed = 0
    slot_lat, tick_walls = [], []
    t0 = time.perf_counter()
    for i in range(n_ticks):
        if i == churn_tick:
            for s in slots[:2]:
                tok_closed += len(eng.slots[s].target_ids) - base[s]
                eng.close_stream(s)
                if eng.open_stream(f"c{s}_reopened") != s:
                    raise RuntimeError("a reopened stream took another slot")
                base[s] = 0
        for s in slots:
            eng.push_audio(s, noise(push))
        fwd, reads = eng.forwards["token"], graphs.host_reads
        tt = time.perf_counter()
        eng.tick()
        dt = time.perf_counter() - tt
        tick_walls.append(dt)
        slot_lat.extend(dt for s in slots if s in eng.last_ticked)
        if log is not None:
            print(f"tick {i}: {dt * 1e3:.1f} ms, {len(eng.last_ticked)} "
                  f"slots, {eng.forwards['token'] - fwd} token forwards, "
                  f"{graphs.host_reads - reads} host reads", file=log,
                  flush=True)
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    wall = time.perf_counter() - t0
    n_tok = tok_closed + sum(len(eng.slots[s].target_ids) - base[s]
                             for s in slots)
    return dict(wall=wall, tokens=n_tok, slot_lat=slot_lat,
                tick_walls=tick_walls, n_ticks=n_ticks,
                audio_s=n_ticks * push / 16000.0, churn_tick=churn_tick,
                evictions=eng.evictions)


def tail_fields(slot_lat) -> dict:
    """Per-slot per-chunk latency percentiles in ms (``bench.py:533-545``)."""
    if not slot_lat:
        return {}
    a = np.asarray(slot_lat) * 1e3
    return {
        "slot_chunk_p50_ms": round(float(np.percentile(a, 50)), 1),
        "slot_chunk_p95_ms": round(float(np.percentile(a, 95)), 1),
        "slot_chunk_p99_ms": round(float(np.percentile(a, 99)), 1),
        "slot_chunks_timed": len(slot_lat),
    }


def summarize_serve(run: dict, metric: str, mixed: bool,
                    eng=None) -> dict:
    """The serve mode's JSON line (``bench.py:707-724``, ``:760-787``),
    with a speculative ``eng``'s acceptance and guard fields."""
    rate = run["tokens"] / run["wall"]
    result = {
        "metric": metric,
        "value": round(rate, 2),
        "unit": "tok/s/chip",
        "vs_baseline": round(rate / SERVE_TARGET_TOK_S, 3),
    }
    if eng is not None and eng.speculative:
        st = eng.spec_stats
        result["accept_rate"] = round(
            st["accepted"] / max(st["drafted"], 1), 4)
        result["guard_fallback"] = bool(eng.spec_fallback_active)
        result["fallback_warmed"] = False
    if mixed:
        result["evictions"] = run["evictions"]
    elif run["churn_tick"] is not None:
        lat = run["slot_lat"]
        half = len(lat) // 2
        result["churn_tick"] = run["churn_tick"]
        result["evictions"] = run["evictions"]
        result["slot_chunk_p99_ms_first_half"] = round(
            float(np.percentile(np.asarray(lat[:half]) * 1e3, 99)), 1)
        result["slot_chunk_p99_ms_second_half"] = round(
            float(np.percentile(np.asarray(lat[half:]) * 1e3, 99)), 1)
    result.update(tail_fields(run["slot_lat"]))
    return result


def launch_report(log):
    """The kernel launches of the run so far, on ``log``, and the model's
    forward passes by function and depth."""
    from infinisst_tpu_torch.kernels import decode_attention, quant_matmul
    from infinisst_tpu_torch.models import llama

    print("model forwards " + json.dumps(llama.forward_counts), file=log,
          flush=True)
    counts = dict(quant_matmul.launch_counts)
    counts.update(decode_attention.launch_counts)
    print("kernel launches " + json.dumps(counts), file=log, flush=True)
    print("attention launches by shape "
          + json.dumps(decode_attention.launch_shapes), file=log, flush=True)


def main_serve(args) -> dict:
    metric = metric_name(args)
    eng = build_engine(args)
    mults = serve_multipliers(args)
    print(f"engine ready on {eng.device}: pool {eng.pool}, beam {eng.beam}, "
          f"multipliers {eng.multipliers}, prompt width {eng._S}",
          file=sys.stderr, flush=True)
    run = run_serve(eng, args.chunks, multipliers=mults, churn=args.churn,
                    log=sys.stderr)
    result = summarize_serve(run, metric, mixed=bool(mults), eng=eng)
    w = np.asarray(run["tick_walls"]) * 1e3
    print(f"{'MIXED ' if mults else ''}pool={eng.pool} ticks={run['n_ticks']} "
          f"wall={run['wall']:.2f}s tokens={run['tokens']} per-stream "
          f"RTF={run['wall'] / run['audio_s']:.3f} tick p50={np.median(w):.1f}"
          f"ms max={w.max():.1f}ms evictions={eng.evictions} "
          f"device={eng.device}", file=sys.stderr)
    print("engine forwards " + json.dumps(eng.forwards), file=sys.stderr)
    # the tick's device programs: captured as CUDA graphs, and replayed
    print("pool programs " + json.dumps(
        {k: {"captured": p.captured, "replays": p.replays}
         for k, p in eng._programs.items()}), file=sys.stderr)
    if eng.speculative:
        print(f"spec: {json.dumps(eng.spec_stats)}", file=sys.stderr)
    launch_report(sys.stderr)
    print(json.dumps(result), flush=True)
    return result


def offline_agent(mode: str, early_stop: bool, cfg, params, device):
    """The offline modes' agent (``bench.py:800-830``, ``:877-906``) on
    ``params``: the default stream, the stub tokenizer, beam 4,
    ``frame_num`` 2, bf16."""
    from infinisst_tpu_torch.agents.alignatt import (
        AlignAttAgent,
        AlignAttOptions,
    )
    from infinisst_tpu_torch.agents.streamatt import (
        StreamAttAgent,
        StreamAttOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    if mode == "alignatt":
        cls, opts = AlignAttAgent, AlignAttOptions(
            beam=4, frame_num=2, length_bucket_chunks=30, max_audio_chunks=30,
            max_prompt_target_tokens=64, attn_early_stop=early_stop,
        )
    else:
        cls, opts = StreamAttAgent, StreamAttOptions(
            beam=4, target_lang="Chinese", frame_num=2,
            length_bucket_chunks=10, max_audio_chunks=30,
            attn_early_stop=True,
        )
    return cls(params, cfg, StreamConfig(), builder, opts,
               param_dtype=torch.bfloat16, device=device)


def build_offline_agent(args):
    """``offline_agent`` on the flagship W8A8 with the bf16 encoder."""
    from infinisst_tpu_torch.core.device import resolve_device

    dev = resolve_device(args.device)
    cfg, params = flagship_params(dev, act_int8=True)
    return offline_agent(args.mode, args.early_stop, cfg, params, dev)


def run_offline(agent, n_chunks: int, timed_from: int, log=None,
                on_push=None) -> dict:
    """Push ``n_chunks`` 960 ms chunks of seeded noise (``randn * 0.1``)
    and time each ``push`` (it returns once the call's tokens are on the
    host); chunks from ``timed_from`` on are timed.  Each ``log`` line
    says whether the call captured its key's program (``graph=capture``,
    the key's first call: a warm-up pass and the capture), replayed it
    or ran it uncaptured (``eager``, the CPU).  ``on_push(agent,
    audio)``, where given, runs after each push, untimed.
    Returns the timed walls and, for every chunk, (wall, beam steps,
    max_steps, prompt bucket, target ids kept, source samples kept, prompt
    length, audio units)."""
    rng = np.random.RandomState(0)
    chunk = agent.unit_samples
    times, calls = [], []
    for i in range(n_chunks):
        audio = rng.randn(chunk).astype(np.float32) * 0.1
        t0 = time.perf_counter()
        agent.push(audio, finished=False)
        dt = time.perf_counter() - t0
        info = agent.last_call
        calls.append((dt, agent.last_result.steps, info["max_steps"],
                      info["prompt_bucket"], len(agent.states.target_ids),
                      len(agent.states.source), info["prompt_len"],
                      info["n_units"]))
        if on_push is not None:
            on_push(agent, audio)
        if log is not None:
            c = calls[-1]
            print(f"chunk {i}: {dt:.3f}s steps={c[1]} max_steps={c[2]} "
                  f"prompt_bucket={c[3]} tgt={c[4]} source={c[5]} "
                  f"prompt_len={c[6]} units={c[7]} graph={agent.last_graph}",
                  file=log, flush=True)
        if i >= timed_from:
            times.append(dt)
    return dict(times=times, calls=calls)


def summarize_offline(times, metric: str, chunk_sec: float = 0.96) -> dict:
    """The offline modes' JSON line (``bench.py:843-848``, ``:918-925``)
    with the port bench's median and p95."""
    rtf = float(np.mean(times)) / chunk_sec
    return {
        "metric": metric,
        "value": round(rtf, 4),
        "unit": "rtf",
        "vs_baseline": round(OFFLINE_BASELINE_RTF / rtf, 3),
        "rtf_median": round(float(np.median(times)) / chunk_sec, 4),
        "rtf_p95": round(float(np.percentile(times, 95)) / chunk_sec, 4),
    }


def main_offline(args) -> dict:
    metric = metric_name(args)
    agent = build_offline_agent(args)
    if args.mode == "alignatt":
        n_chunks = max(args.chunks, ALIGNATT_MIN_CHUNKS)
        timed_from = ALIGNATT_WARMUP
    else:
        n_chunks = max(args.chunks, STREAMATT_MIN_CHUNKS)
        timed_from = STREAMATT_TIMED_FROM
    print(f"{args.mode} agent ready on {agent.device}: {n_chunks} chunks, "
          f"timed from {timed_from}, early stop {agent.opts.attn_early_stop}",
          file=sys.stderr, flush=True)
    run = run_offline(agent, n_chunks, timed_from, log=sys.stderr)
    result = summarize_offline(run["times"], metric)
    t = run["times"]
    steps = [c[1] for c in run["calls"][timed_from:]]
    print(f"chunks={len(t)} mean={np.mean(t) * 1e3:.1f}ms "
          f"p90={np.percentile(t, 90) * 1e3:.1f}ms steps a timed call "
          f"{np.mean(steps):.1f} early_stop={agent.opts.attn_early_stop} "
          f"device={agent.device}", file=sys.stderr)
    launch_report(sys.stderr)
    print(json.dumps(result), flush=True)
    return result


# -- training (bench.py:939-1215) ---------------------------------------------

TRAIN_METRIC = "train_stage1_speech_s_per_s_1chip_1.5b"
TRAIN_IO_METRIC = "train_stage1_speech_s_per_s_realio_1chip_1.5b"
TRAIN_UNITS = 30  # 28.8 s windows: 30 x 960 ms, 1440 frames
TRAIN_TARGET_TOKENS = 240
TRAIN_STEPS, TRAIN_WARMUP, TRAIN_PROBE = 12, 2, 2


def _train_sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_line(dev) -> str:
    if dev.type != "cuda":
        return "peak memory: not measured (cpu)"
    return (f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} "
            "GiB (torch.cuda.max_memory_allocated)")


def train_params(cfg, dev):
    """Random bfloat16 parameters (``train.main.random_params``), stage
    1's freeze and its optimizer (lr 2e-4, warmup 1000)."""
    from infinisst_tpu_torch.train import step as tstep
    from infinisst_tpu_torch.train.main import random_params

    params = random_params(cfg, dev, torch.bfloat16)
    freeze = tstep.FreezeConfig.stage1()
    tx = tstep.make_optimizer(
        tstep.OptimConfig(learning_rate=2e-4, warmup_steps=1000,
                          total_steps=100_000), params, freeze)
    return params, freeze, tx


def train_batch(B, units, dev, rng):
    """bench.py's synthetic stage-1 batch: B rows of ``units`` x 960 ms of
    seeded noise, 12 patch tokens a unit (id 1008, as bench.py) and
    TRAIN_TARGET_TOKENS target tokens a row, on the host (pinned when
    ``dev`` is a card), as ``TrainProgram`` takes it."""
    from infinisst_tpu_torch.train import step as tstep

    n_frames = 48 * units
    sp = n_frames // 4
    S = sp + TRAIN_TARGET_TOKENS
    ids = np.full((B, S), 7, np.int64)
    ids[:, 2: 2 + sp] = 1008
    labels = np.where(np.arange(S)[None] >= sp + 4, ids, -100)
    speech = rng.randn(B, 399 + n_frames * 320).astype(np.float32) * 0.1
    batch = tstep.Batch(
        speech=torch.from_numpy(speech),
        frame_lengths=torch.full((B,), n_frames, dtype=torch.int64),
        input_ids=torch.from_numpy(ids),
        labels=torch.from_numpy(labels),
        attention_mask=torch.ones((B, S), dtype=torch.int64),
        patch_mask=torch.from_numpy(ids == 1008),
    )
    if torch.device(dev).type == "cuda":
        batch = tstep.Batch(*(x.pin_memory() for x in batch))
    return batch


def main_train(args, cfg=None, units=TRAIN_UNITS, n_steps=TRAIN_STEPS):
    """The stage-1 step on synthetic batches (bench.py's bench_train):
    ``--batch`` rows of ``units`` x 960 ms, 360 patch tokens (id 1008, as
    bench.py) and 240 target tokens a row at 28.8 s, through
    ``TrainProgram`` (captured on a card)."""
    from infinisst_tpu_torch.core import graphs
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import bench_1chip_config
    from infinisst_tpu_torch.train import step as tstep

    dev = resolve_device(args.device)
    cfg = cfg or bench_1chip_config()
    params, freeze, tx = train_params(cfg, dev)
    state = tstep.init_train_state(params, tx)
    B = args.batch
    n_frames = 48 * units
    rng = np.random.RandomState(0)
    prog = tstep.TrainProgram(cfg, tx, 48, StreamConfig().max_cache_frames,
                              dev, freeze=freeze, remat=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    times = []
    for i in range(n_steps):
        # the batch is made on the host before the timer starts; the step
        # copies it into the program's static batch
        batch = train_batch(B, units, dev, rng)
        _train_sync(dev)
        t0 = time.perf_counter()
        state, metrics = prog(state, batch, args.multiplier)
        _train_sync(dev)
        dt = time.perf_counter() - t0
        loss, gnorm = graphs.read(metrics["packed"])
        print(f"step {i}: {dt:.3f}s loss={loss:.3f} grad_norm={gnorm:.3e}",
              file=sys.stderr, flush=True)
        if i >= TRAIN_WARMUP:
            times.append(dt)
    speech_s = B * n_frames * 0.02  # 20 ms a frame
    sps = speech_s / float(np.mean(times))
    result = {
        "metric": TRAIN_METRIC,
        "value": round(sps, 2),
        "unit": "speech_s/s/chip",
        "vs_baseline": round(sps / 1.0, 2),  # x realtime per chip
    }
    print(f"B={B} window={units * 0.96:.1f}s steps={len(times)} "
          f"mean={np.mean(times) * 1e3:.0f}ms device={dev}", file=sys.stderr)
    print(_peak_line(dev), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return result


def write_train_tsv(d, n_rows, units, rng, split="tr", words_per_unit=8):
    """``n_rows`` rows of ``units`` x 960 ms of seeded noise as wav files
    under ``d`` and their TSV manifest ``d/<split>.tsv``, each 960 ms
    unit one trajectory segment of ``words_per_unit`` words."""
    import csv
    import os

    from infinisst_tpu_torch.data.audio import write_wav

    rows = []
    for i in range(n_rows):
        wav_path = os.path.join(d, f"r{i}.wav")
        n_samples = units * 15360
        write_wav(wav_path, (rng.randn(n_samples) * 0.1).astype(np.float32))
        steps = [" ".join(f"w{rng.randint(400)}"
                          for _ in range(words_per_unit))
                 for _ in range(units)]
        rows.append({"id": f"r{i}", "audio": wav_path,
                     "n_frames": str(n_samples), "src_text": " ".join(steps),
                     "tgt_text": " ".join(steps), "trajectory": repr(steps)})
    with open(os.path.join(d, f"{split}.tsv"), "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]), delimiter="\t",
                           quotechar=None, doublequote=False,
                           lineterminator="\n", quoting=csv.QUOTE_NONE)
        w.writeheader()
        w.writerows(rows)


def main_train_io(args, cfg=None, units=TRAIN_UNITS, n_steps=TRAIN_STEPS):
    """The stage-1 steps behind the real input pipeline (bench.py's
    bench_train_io), on data written under a temporary directory that is
    removed afterwards."""
    import os
    import shutil
    import tempfile

    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import bench_1chip_config
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.train.main import random_params
    from infinisst_tpu_torch.train.trainer import Trainer, TrainerArgs

    dev = resolve_device(args.device)
    cfg = cfg or bench_1chip_config()
    builder = PromptBuilder(StubTokenizer(cfg.llama.vocab_size), cfg.tokens)
    d = tempfile.mkdtemp(prefix="bench_train_io_")
    try:
        rng = np.random.RandomState(0)
        # n_steps timed + 2 warmup + 2 probe, and a spare batch
        write_train_tsv(d, 2 * (n_steps + TRAIN_WARMUP + TRAIN_PROBE + 1),
                        units, rng)
        targs = TrainerArgs(
            data_path=d, data_split_train="tr", data_split_eval="none",
            trajectory=4, trajectory_max_multiplier=1, stage=1,
            # the sampler's size of a row is 30 a unit + 39 (939 at
            # 28.8 s): a budget of 1900 there packs 2 rows a batch
            train_bsz=2 * (30 * units + 39) + 22, bsz_sent=2,
            warmup_steps=100, max_steps=n_steps, grad_acc_steps=1,
            log_step=10**9, eval_step=0, save_step=0,
            save_dir=os.path.join(d, "run"), block_size=48,
            max_cache_size=576, encoder_dropout=0.0,
        )
        params = random_params(cfg, dev, torch.bfloat16)
        t = Trainer(targs, cfg, builder, params, device=dev)
        ds, sampler, collator = t._make_loader("tr", targs.train_bsz, True)
        sampler.set_epoch(0)
        return _run_train_io(t, ds, sampler, collator, n_steps, dev)
    finally:
        shutil.rmtree(d, ignore_errors=True)


def _run_train_io(t, ds, sampler, collator, n_steps, dev):
    from infinisst_tpu_torch.core import graphs

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    state = t.state
    synced, synced_speech = [], []
    timed_frames = []  # of the host batches
    t_start = None
    n_timed = 0
    t_prev = time.perf_counter()
    for i, (m, batch) in enumerate(t._prefetch(sampler, ds, collator,
                                               depth=2)):
        state, metrics = t._get_step_fn(m)(state, batch)
        if i < TRAIN_WARMUP + TRAIN_PROBE:
            _train_sync(dev)
            now = time.perf_counter()
            dt, t_prev = now - t_prev, now
            sec = float(batch.frame_lengths.sum()) * 0.02
            print(f"step {i} (synced): {dt:.3f}s speech="
                  f"{tuple(batch.speech.shape)} S="
                  f"{tuple(batch.input_ids.shape)} audio_s={sec:.1f} "
                  f"loss={graphs.read(metrics['loss']):.3f}",
                  file=sys.stderr, flush=True)
            if i >= TRAIN_WARMUP:
                synced.append(dt)
                synced_speech.append(sec)
            if i == TRAIN_WARMUP + TRAIN_PROBE - 1:
                t_start = time.perf_counter()
        else:
            timed_frames.append(batch.frame_lengths.sum())
            n_timed += 1
            if n_timed >= n_steps:
                break
    _train_sync(dev)
    total = time.perf_counter() - t_start
    if n_timed < n_steps:
        raise RuntimeError(f"the data gave {n_timed} timed steps of "
                           f"{n_steps}")
    timed_speech = float(torch.stack(timed_frames).sum()) * 0.02
    final_loss = graphs.read(metrics["loss"])  # the last step's
    print(f"pipelined: {n_timed} steps in {total:.2f}s "
          f"({timed_speech:.1f} audio_s) final_loss={final_loss:.3f}",
          file=sys.stderr, flush=True)
    print(_peak_line(dev), file=sys.stderr, flush=True)
    sps = timed_speech / total
    sync_sps = float(np.sum(synced_speech)) / float(np.sum(synced))
    result = {
        "metric": TRAIN_IO_METRIC,
        "value": round(sps, 2),
        "unit": "speech_s/s/chip",
        "vs_baseline": round(sps / 1.0, 2),
        "pipeline": "disk TSV+wav -> sampler -> collator -> prefetch(2) "
                    "-> upload -> steps dispatched back-to-back, one "
                    "final sync (Trainer.fit's regime between log points)",
        "steps_pipelined": n_timed,
        "sec_per_step_pipelined": round(total / n_timed, 4),
        "sec_per_step_synced": round(float(np.mean(synced)), 4),
        "speech_s_per_s_synced": round(sync_sps, 2),
        "final_loss": round(final_loss, 3),
    }
    print(json.dumps(result), flush=True)
    return result



def main(argv=None) -> dict:
    args = parse_args(argv)
    from infinisst_tpu_torch.core.device import resolve_device

    if resolve_device(args.device).type == "cuda":
        from infinisst_tpu_torch.kernels import _build

        _build.load_all()  # one nvcc per source, all at once
    if args.mode == "serve":
        return main_serve(args)
    if args.mode == "train":
        return main_train(args)
    if args.mode == "train-io":
        return main_train_io(args)
    if args.mode in OFFLINE_MODES:
        return main_offline(args)
    metric = metric_name(args)
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
            if args.speculative:
                result.update(spec_fields(agent))
                print(f"spec: rounds={agent.spec_rounds} drafted="
                      f"{agent.spec_drafted} accepted={agent.spec_accepted} "
                      f"emitted={agent.spec_emitted}", file=log)
            t = run["times"]
            print(f"chunks={len(t)} mean={np.mean(t) * 1e3:.1f}ms "
                  f"p50={np.percentile(t, 50) * 1e3:.1f}ms "
                  f"p90={np.percentile(t, 90) * 1e3:.1f}ms "
                  f"tokens={run['tokens']} device={agent.device}", file=log)
    launch_report(log)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
