"""Drive the streaming agent through its public API on synthetic audio;
port of ``examples/stream_demo.py``.

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.examples.stream_demo [--chunks N]
      [--multiplier M] [--speculative ...] [--do-sample ...] [--device cpu]

With no checkpoint this uses a tiny random model and the stub tokenizer,
so the "translations" are nonsense tokens: the point is to run the whole
streaming loop (chunked encode, splice, prefill, beam search, commit,
eviction) as a SimulEval run would, with the kernels on a card.
"""

import argparse
import sys
from time import perf_counter

import numpy as np
import torch

VOCAB = 512


def tiny_model(seed: int = 0, device="cuda"):
    """Tiny random model + config for checkpoint-free demos (seeded
    generators on ``device``)."""
    from infinisst_tpu_torch.core.config import (
        SpecialTokens,
        tiny_model_config,
    )
    from infinisst_tpu_torch.models import adapter as A
    from infinisst_tpu_torch.models import llama as L
    from infinisst_tpu_torch.models import wav2vec2 as W

    cfg = tiny_model_config(vocab_size=VOCAB).replace(
        tokens=SpecialTokens(
            bos=500, eot=501, eos=501, start_header=502, end_header=503,
            pad=504, user=505, assistant=506, newline2=507, sp_patch=508,
            sp_start=509, sp_end=510, latency=(511, 511, 511, 511),
        )
    )

    def gen(i):
        return torch.Generator(device=device).manual_seed(3 * seed + i)

    params = {
        "w2v2": W.init_params(cfg.w2v2, gen(0), device),
        "adapter": A.init_params(cfg.adapter, gen(1), device),
        "llama": L.init_params(cfg.llama, gen(2), device),
    }
    return params, cfg


def main(argv=None):
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent,
        InfiniSSTOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer

    ap = argparse.ArgumentParser()
    ap.add_argument("--chunks", type=int, default=5)
    ap.add_argument("--multiplier", type=int, default=1)
    ap.add_argument("--max-llm-cache-size", type=int, default=120)
    ap.add_argument("--seed", type=int, default=0)
    # speculative greedy decode (beam is ignored when set); --spec-head-vocab
    # drives the shortlist draft head (exact either way)
    ap.add_argument("--speculative", action="store_true")
    ap.add_argument("--spec-draft-layers", type=int, default=1)
    ap.add_argument("--spec-k", type=int, default=4)
    ap.add_argument("--spec-head-vocab", type=int, default=0)
    # a truncated-SVD low-rank draft head from the demo model's own
    # lm_head (exact; acceptance-only cost)
    ap.add_argument("--spec-lowrank-rank", type=int, default=0)
    # speculative beam search (the beam_search winner exactly)
    ap.add_argument("--spec-beam", action="store_true")
    # sampling decode; with --speculative, speculative sampling (exact in
    # distribution)
    ap.add_argument("--do-sample", action="store_true")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    params, cfg = tiny_model(args.seed, dev)
    stream = StreamConfig(max_cache_frames=96,
                          max_llm_cache_tokens=args.max_llm_cache_size,
                          llm_cache_capacity=256)
    builder = PromptBuilder(StubTokenizer(VOCAB, lo=10, hi=400), cfg.tokens)
    opts = InfiniSSTOptions(
        latency_multiplier=args.multiplier, beam=2,
        max_llm_cache_size=args.max_llm_cache_size,
        no_repeat_ngram_lookback=32, rtf_timing=True,
        speculative=args.speculative,
        spec_draft_layers=args.spec_draft_layers, spec_k=args.spec_k,
        spec_head_vocab=args.spec_head_vocab,
        spec_lowrank_rank=args.spec_lowrank_rank, spec_beam=args.spec_beam,
        do_sample=args.do_sample, temperature=args.temperature,
        top_k=args.top_k,
    )
    agent = InfiniSSTAgent(params, cfg, stream, builder, opts,
                           param_dtype=torch.float32, device=dev)

    rng = np.random.RandomState(args.seed)
    chunk = agent.chunk_samples
    print(f"chunk = {chunk} samples ({chunk / 16000:.2f}s), "
          f"beam={opts.beam}, m={args.multiplier}, device={dev}")
    t_start = perf_counter()
    act = None
    for i in range(args.chunks):
        finished = i == args.chunks - 1
        audio = rng.randn(chunk).astype(np.float32) * 0.1
        t0 = perf_counter()
        act = agent.push(audio, finished=finished)
        dt = perf_counter() - t0
        kind = "READ " if act.is_read() else "WRITE"
        content = "" if act.is_read() else act.content
        print(f"[chunk {i}] {kind} ({dt:.2f}s) "
              f"llm_cache={agent.llm_cache_len} "
              f"enc_frames={int(agent.enc_state.n_frames[0])} :: "
              f"{content[:80]}")
    total_audio = args.chunks * chunk / 16000
    wall = perf_counter() - t_start
    print(f"done: {total_audio:.1f}s audio in {wall:.1f}s wall "
          f"(RTF={wall / total_audio:.2f})")
    print(f"final transcript ids: {len(agent.states.target_ids)} tokens")
    if act is None or act.is_read() or not act.finished:
        raise RuntimeError("the final action must finish the stream")
    return 0


if __name__ == "__main__":
    sys.exit(main())
