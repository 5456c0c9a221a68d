"""Multi-client streaming translation server (newline-delimited JSON over
TCP); port of ``infinisst_tpu/serve/server.py`` on the port's
``ServingEngine``.

Protocol (one JSON object per line):
  client -> server:
    {"type": "open", "source_lang": "English", "target_lang": "German",
     "multiplier": 1}   # optional; must be in the server's --multipliers set
    {"type": "audio", "pcm": [float...], "finished": false}
      (or "pcm_b64": base64 of 16-bit PCM)
    {"type": "close"}
  server -> client:
    {"type": "opened", "slot": N}
    {"type": "text", "content": "...", "final": false}
    {"type": "error", "message": "..."}

The engine's tick loop runs in a background task at the chunk cadence;
all clients share one batched step (serve/engine.py).  The ticks run in
one worker thread that owns the card (its device set once; the tick's
CUDA graphs are captured and replayed there, under the engine's lock),
and so do the slot calls that write device state (open, close): the
event loop makes no CUDA call.  Pushed audio stays on the host until a
tick takes it.

Run:  python -m infinisst_tpu_torch.serve.server --port 8765 \
          [--model-preset dryrun|bench|flagship] [--device cuda|cpu]
Test client: python -m infinisst_tpu_torch.serve.client --wav x.wav

``--speculative`` (with ``--spec-*``) serves the pool by speculative
greedy at beam 1, and with ``--do-sample`` (and its filters) by
speculative sampling, as the JAX server does; the shortlist ids, the
low-rank factors and the exit adapter go through the CLI's loaders.
"""

from __future__ import annotations

import argparse
import asyncio
import base64
import functools
import json
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

READLINE_LIMIT = 16 * 1024 * 1024


class StreamingServer:
    def __init__(self, engine, tick_interval: float = 0.1):
        self.engine = engine
        self.tick_interval = tick_interval
        self.slot_writers = {}
        # the one thread that makes the engine's CUDA calls, on the
        # engine's card
        init = None
        if engine.device.type == "cuda":
            import torch

            idx = engine.device.index
            init = functools.partial(
                torch.cuda.set_device,
                torch.cuda.current_device() if idx is None else idx)
        self._worker = ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="tick", initializer=init)

    async def _on_worker(self, fn, *args, **kw):
        """``fn`` in the engine's worker thread."""
        return await asyncio.get_running_loop().run_in_executor(
            self._worker, functools.partial(fn, *args, **kw))

    async def tick_loop(self):
        while True:
            out = await self._on_worker(self.engine.tick)
            for slot, text in out.items():
                writer = self.slot_writers.get(slot)
                s = self.engine.slots[slot]
                if writer is not None:
                    msg = {"type": "text", "content": text, "final": s.done}
                    writer.write((json.dumps(msg) + "\n").encode())
                    try:
                        await writer.drain()
                    except ConnectionError:
                        pass
                if s.done:
                    await self._on_worker(self.engine.close_stream, slot)
                    self.slot_writers.pop(slot, None)
            await asyncio.sleep(self.tick_interval)

    async def handle(self, reader, writer):
        slot = None
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                msg = json.loads(line)
                if msg["type"] == "open":
                    pair = (
                        msg.get("source_lang", "English"),
                        msg.get("target_lang", "German"),
                    )
                    try:
                        slot = await self._on_worker(
                            self.engine.open_stream,
                            str(writer.get_extra_info("peername")), pair,
                            multiplier=msg.get("multiplier"),
                        )
                    except ValueError as e:
                        writer.write((json.dumps(
                            {"type": "error", "message": str(e)}
                        ) + "\n").encode())
                        await writer.drain()
                        continue
                    self.slot_writers[slot] = writer
                    writer.write((json.dumps(
                        {"type": "opened", "slot": slot}) + "\n").encode())
                    await writer.drain()
                elif msg["type"] == "audio" and slot is not None:
                    if "pcm_b64" in msg:
                        pcm = np.frombuffer(
                            base64.b64decode(msg["pcm_b64"]), np.int16
                        ).astype(np.float32) / 32768.0
                    else:
                        pcm = np.asarray(msg["pcm"], np.float32)
                    self.engine.push_audio(
                        slot, pcm, finished=msg.get("finished", False)
                    )
                elif msg["type"] == "close":
                    break
        except (json.JSONDecodeError, KeyError) as e:
            writer.write((json.dumps(
                {"type": "error", "message": str(e)}) + "\n").encode())
        finally:
            if slot is not None and slot in self.slot_writers:
                await self._on_worker(self.engine.close_stream, slot)
                self.slot_writers.pop(slot, None)
            writer.close()

    async def run(self, host: str, port: int):
        server = await asyncio.start_server(
            self.handle, host, port, limit=READLINE_LIMIT
        )
        bound = server.sockets[0].getsockname()
        print(f"serving on {bound[0]}:{bound[1]}", file=sys.stderr,
              flush=True)
        async with server:
            # a tick loop that fails ends the server with its error
            await asyncio.gather(server.serve_forever(), self.tick_loop())


def add_args(p: argparse.ArgumentParser):
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--pool-size", type=int, default=8)
    p.add_argument("--multiplier", type=int, default=1,
                   help="default latency multiplier for clients that do "
                   "not request one")
    p.add_argument("--multipliers", type=str, default=None,
                   help="comma list of ALLOWED per-client multipliers "
                   "(e.g. 1,2,4); one pool serves all of them mixed")
    p.add_argument("--beam", type=int, default=4,
                   help="beam width per slot (the reference's quality "
                   "configuration is beam 4; 1 = batched greedy)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 decode weights and lm_head")
    p.add_argument("--suppress-non-language", action="store_true")
    # pooled speculative serving (greedy-exact, beam 1): a layer-skip
    # draft and a k-token verify shared by the pool; --spec-head-vocab
    # slices a shortlist draft head (--spec-head-ids: .npy of ranked ids)
    p.add_argument("--speculative", action="store_true")
    p.add_argument("--spec-draft-layers", type=int, default=8)
    p.add_argument("--spec-k", type=int, default=4)
    p.add_argument("--spec-head-vocab", type=int, default=0)
    p.add_argument("--spec-head-ids", type=str, default=None)
    p.add_argument("--spec-adapter", type=str, default=None)
    p.add_argument("--spec-lowrank-rank", type=int, default=0)
    p.add_argument("--spec-lowrank-head", type=str, default=None)
    p.add_argument("--spec-no-guard", action="store_true")
    p.add_argument("--spec-guard-patience", type=int, default=3)
    p.add_argument("--spec-no-warm-fallback", action="store_true")
    # pooled speculative sampling (needs --speculative)
    p.add_argument("--do-sample", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--epsilon-cutoff", type=float, default=0.0)
    p.add_argument("--sample-seed", type=int, default=0)
    p.add_argument("--model-preset", default="bench",
                   choices=("flagship", "bench", "dryrun"))
    p.add_argument("--state-dict-path", default=None)
    p.add_argument("--tokenizer-path", default=None)
    p.add_argument(
        "--lang-pairs",
        default="English-German,English-Spanish,English-Chinese",
    )
    # the port's own: where the model runs and its float type
    p.add_argument("--device", default="cuda")
    p.add_argument("--dtype", default="bfloat16",
                   choices=("bfloat16", "float32"))


def build_engine(args):
    """The engine ``main`` serves: the preset's model (loaded, or random
    from seeded generators), bf16 unless --dtype float32, W8A8 under
    --int8, one prompt builder per language pair."""
    import torch

    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import PRESETS
    from infinisst_tpu_torch.data.template import (
        HFTokenizerAdapter,
        PromptBuilder,
        StubTokenizer,
    )
    from infinisst_tpu_torch.serve.engine import ServingEngine
    from infinisst_tpu_torch.train.main import build_params

    from infinisst_tpu_torch.agents.cli import (
        _load_adapter,
        _load_head_ids,
        _load_lowrank_head,
    )

    device = resolve_device(args.device)
    if device.type == "cuda":
        from infinisst_tpu_torch.kernels import _build

        _build.load_all()  # one nvcc per source, all at once
    cfg = PRESETS[args.model_preset]()
    if args.tokenizer_path:
        from transformers import AutoTokenizer

        from infinisst_tpu_torch.data.template import register_special_tokens

        tok = AutoTokenizer.from_pretrained(args.tokenizer_path,
                                            use_fast=False)
        register_special_tokens(tok, cfg)
        tokenizer = HFTokenizerAdapter(tok)
    else:
        tokenizer = StubTokenizer(cfg.llama.vocab_size)
    builders = {}
    for pair in args.lang_pairs.split(","):
        src, tgt = pair.split("-")
        builders[(src, tgt)] = PromptBuilder(tokenizer, cfg.tokens, src, tgt)

    class _A:  # build_params' argument names
        llm_path = None
        w2v2_path = None
        sllm_weight_path = args.state_dict_path

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    params = build_params(_A, cfg, device=device, dtype=dtype)
    if args.int8:
        ll = cfg.llama
        dims = (ll.num_heads * ll.head_dim, ll.num_kv_heads * ll.head_dim,
                ll.hidden_size, ll.intermediate_size)
        if any(d % 128 for d in dims):
            raise SystemExit(
                f"--int8 requires all projection dims to be multiples of "
                f"128 (got {dims} for preset {args.model_preset!r}); use "
                "the flagship/bench presets or drop --int8"
            )
        from infinisst_tpu_torch.models.quant import quantize_llama_params

        params = dict(params)
        params["llama"] = quantize_llama_params(
            params["llama"], quantize_lm_head=True, act_int8=True
        )
    suppress = None
    if args.suppress_non_language:
        if not args.tokenizer_path:
            print("WARNING: --suppress-non-language needs --tokenizer-path "
                  "to scan the vocab; ban list DISABLED", file=sys.stderr,
                  flush=True)
        else:
            from infinisst_tpu_torch.agents.cli import build_suppress_list

            suppress = build_suppress_list(tokenizer)
    return ServingEngine(
        params, cfg, StreamConfig(), builders, pool_size=args.pool_size,
        multiplier=args.multiplier,
        beam=1 if args.speculative else args.beam, dtype=dtype,
        suppress_tokens=suppress,
        multipliers=(
            tuple(int(x) for x in args.multipliers.split(","))
            if args.multipliers else None
        ),
        device=device,
        speculative=args.speculative,
        spec_draft_layers=args.spec_draft_layers,
        spec_k=args.spec_k,
        spec_head_vocab=args.spec_head_vocab,
        spec_head_ids=_load_head_ids(args.spec_head_ids,
                                     args.spec_head_vocab),
        spec_adapter=_load_adapter(args),
        spec_lowrank_rank=args.spec_lowrank_rank,
        spec_lowrank_head=_load_lowrank_head(args),
        spec_guard=not args.spec_no_guard,
        spec_guard_patience=args.spec_guard_patience,
        spec_warm_fallback=not args.spec_no_warm_fallback,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        epsilon_cutoff=args.epsilon_cutoff,
        sample_seed=args.sample_seed,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    add_args(p)
    args = p.parse_args(argv)
    engine = build_engine(args)
    asyncio.run(StreamingServer(engine).run(args.host, args.port))


if __name__ == "__main__":
    main()
