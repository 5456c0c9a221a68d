"""Distill a speculative early-exit draft adapter from a checkpoint; port
of the root ``tools_distill_adapter.py``.

The target model decodes in-domain prompts itself
(``train/draft.rollout_corpus``), the adapter is distilled on those
rollouts (``train/draft.distill``; teacher-forced corpus text does not
transfer, the exposure bias of ``train/draft.py``), and an ``.npz`` in
the JAX package's format is saved for ``--spec-adapter`` on the agent
CLI and the serving server of either package.

Usage (``--device`` defaults to ``cuda``):
    python -m infinisst_tpu_torch.tools.distill_adapter \\
        --model-name .../llama-3.1-8b-instruct-hf \\
        --state-dict-path .../pytorch_model.bin \\
        --tokenizer-path .../llama-3.1-8b-instruct-hf \\
        --prompts indomain.txt --prompt-tokens 32 --gen-len 128 \\
        --draft-layers 8 --rank 2048 --steps 2000 --out adapter_d8.npz

``--prompts`` is a text file, one prompt per line; each line is tokenized
and cut to exactly ``--prompt-tokens`` tokens (shorter lines are dropped),
so rollouts batch without padding.  With no ``--tokenizer-path`` the lines
are space-separated token ids.  The Llama runs in float32 (the int8
rounding has zero gradient): ~32 GB on the card at 8B.
"""

from __future__ import annotations

import argparse
import sys


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-preset", default="flagship",
                    choices=["flagship", "bench", "dryrun"])
    ap.add_argument("--model-name", type=str, default=None,
                    help="HF Llama dir (config+weights); optional")
    ap.add_argument("--state-dict-path", type=str, default=None,
                    help="pruned stage-2 pytorch_model.bin (SpeechLlama)")
    ap.add_argument("--w2v2-path", type=str, default=None)
    ap.add_argument("--tokenizer-path", type=str, default=None)
    ap.add_argument("--prompts", type=str, required=True,
                    help="text file, one prompt per line (token ids if "
                         "no tokenizer)")
    ap.add_argument("--prompt-tokens", type=int, default=16)
    ap.add_argument("--gen-len", type=int, default=64)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--draft-layers", type=int, required=True)
    ap.add_argument("--rank", type=int, default=0,
                    help="adapter rank (0 = hidden_size / 2)")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import (
        bench_1chip_config,
        dryrun_config,
        flagship_config,
    )
    from infinisst_tpu_torch.train import draft as DR
    from infinisst_tpu_torch.train.main import build_params

    dev = resolve_device(args.device)
    cfg = {
        "flagship": flagship_config,
        "bench": bench_1chip_config,
        "dryrun": dryrun_config,
    }[args.model_preset]()

    tokenizer = None
    if args.tokenizer_path:
        from transformers import AutoTokenizer

        from infinisst_tpu_torch.data.template import register_special_tokens

        tok = AutoTokenizer.from_pretrained(
            args.tokenizer_path, use_fast=False
        )
        register_special_tokens(tok, cfg)
        tokenizer = tok

    P = args.prompt_tokens
    rows = []
    with open(args.prompts, encoding="utf-8") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ids = (
                tokenizer.encode(line) if tokenizer
                else [int(x) for x in line.split()]
            )
            if len(ids) >= P:
                rows.append(ids[:P])
    if not rows:
        raise SystemExit(
            f"no prompt line had >= --prompt-tokens={P} tokens"
        )
    prompts = np.asarray(rows, np.int64)
    print(f"{len(rows)} prompts x {P} tokens", file=sys.stderr)

    class _A:  # build_params' argument names
        llm_path = args.model_name
        w2v2_path = args.w2v2_path
        sllm_weight_path = args.state_dict_path

    params = build_params(_A, cfg, dev, torch.float32)["llama"]

    # self-generated distillation corpus: greedy continuations from the
    # target model over the in-domain prompts (the draft is only queried
    # at contexts the target itself produced -- train/draft.py)
    B = args.batch_size
    batches = []
    for i in range(0, len(rows), B):
        out = DR.rollout_corpus(params, cfg.llama, prompts[i : i + B],
                                args.gen_len)
        batches.append(out.cpu().numpy())
        print(f"rollout batch {i // B + 1}/{-(-len(rows) // B)}",
              file=sys.stderr)

    adapter, hist = DR.distill(
        params, cfg.llama, args.draft_layers, batches,
        steps=args.steps, lr=args.lr, rank=args.rank or None,
        key=torch.Generator(device=dev).manual_seed(args.seed),
        log_every=max(1, args.steps // 10),
    )
    for step, kl, agree in hist:
        print(f"step {step}: kl {kl:.4f} top1-agree {agree:.4f}",
              file=sys.stderr)
    DR.save_adapter(args.out, adapter, d=args.draft_layers)
    if dev.type == "cuda":
        print(f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
              " GiB", file=sys.stderr)
    final = f", final agree {hist[-1][2]:.4f}" if hist else ""
    print(
        f"saved {args.out} (d={args.draft_layers}, "
        f"rank={adapter['w1'].shape[1]}{final})"
    )


if __name__ == "__main__":
    main()
