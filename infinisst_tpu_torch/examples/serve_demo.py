"""Multi-client serving demo without checkpoints; port of
``examples/serve_demo.py``: a tiny random model, the stub tokenizer, three
streams with two language pairs through the batched ``ServingEngine``
(beam search, per-slot KV caches, rolling eviction).  One stream joins
at tick 1 and leaves at tick 2.

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.examples.serve_demo [--ticks 4]
      [--device cpu]
"""

import argparse

import numpy as np
import torch


def main(argv=None):
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
    from infinisst_tpu_torch.examples.stream_demo import tiny_model
    from infinisst_tpu_torch.serve.engine import ServingEngine

    ap = argparse.ArgumentParser()
    ap.add_argument("--ticks", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    params, cfg = tiny_model(device=dev)
    stream = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=120,
                          llm_cache_capacity=256)
    tok = StubTokenizer(cfg.llama.vocab_size, lo=10, hi=400)
    builders = {
        pair: PromptBuilder(tok, cfg.tokens, *pair)
        for pair in (("English", "German"), ("English", "Chinese"))
    }
    eng = ServingEngine(params, cfg, stream, builders, pool_size=4,
                        multiplier=1, max_new_tokens=8, dtype=torch.float32,
                        beam=2, device=dev)
    rng = np.random.RandomState(0)
    chunk = eng.chunk_samples

    s0 = eng.open_stream("alice", ("English", "German"))
    s1 = eng.open_stream("bob", ("English", "Chinese"))
    late = None
    outs = []
    for t in range(args.ticks):
        if t == 1:
            late = eng.open_stream("carol", ("English", "German"))
            print(f"[tick {t}] carol joins (slot {late})")
        for s in [s0, s1] + ([late] if late is not None else []):
            if eng.slots[s].active:
                eng.push_audio(s, rng.randn(chunk).astype(np.float32) * 0.1,
                               finished=(t == args.ticks - 1))
        out = eng.tick()
        outs.append(out)
        for slot, text in out.items():
            cid = eng.slots[slot].client_id
            print(f"[tick {t}] {cid}: {text[:60]!r}"
                  f" (cache={eng.slots[slot].cache_len})")
        if t == 2 and late is not None:
            print(f"[tick {t}] carol leaves")
            eng.close_stream(late)
            late = None
    print("done; slots:",
          [(s.client_id, s.done) for s in eng.slots if s.active])
    return outs


if __name__ == "__main__":
    main()
