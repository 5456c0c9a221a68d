"""Inference CLI of the port: build an agent from checkpoints and run the
streaming eval harness (a port of ``infinisst_tpu/agents/cli.py``).

Usage (mirrors scripts/infer/infinisst.sh):
  python -m infinisst_tpu_torch.agents.cli \
      --agent infinisst --source tst-COMMON_full.source \
      --target tst-COMMON_full.target --output out/ \
      --state-dict-path .../pytorch_model.bin \
      --tokenizer-path .../llama-3.1-8b-instruct-hf \
      --latency-multiplier 2 --beam 4 --max-llm-cache-size 1000 \
      --always-cache-system-prompt --target-lang German

The flags and their defaults are the JAX CLI's, plus ``--device`` (default
``cuda``; ``cpu`` runs every kernel's plain version).  ``--agent
infinisst`` (beam search, ``--do-sample`` and its filters,
``--speculative`` with ``--spec-*`` and ``--spec-beam``), ``alignatt``
and ``streamatt`` (the offline baselines, mirroring
scripts/infer/streamatt.sh).  As in the JAX CLI, ``--do-sample`` and
``--speculative`` exit with a message for the offline agents.
"""

from __future__ import annotations

import argparse
import json


def build_suppress_list(tokenizer):
    """Token ids containing parentheses (speaker/emotion annotations) —
    the --suppress-non-language ban list (ref: agents/infinisst.py:
    142-148).  The per-id decode scan over the full vocab is the
    reference's own load-time behaviour (same cost, ~1 min with a slow
    tokenizer); it runs once at startup."""
    import numpy as np

    # The reference scans range(len(tokenizer)) — the full vocab INCLUDING
    # added tokens (on Llama-3 HF tokenizers vocab_size excludes the 256
    # added specials) — and decodes with skip_special_tokens=True.
    try:
        n = len(tokenizer)
    except TypeError:
        n = tokenizer.vocab_size
    bad = []
    for idx in range(n):
        d = tokenizer.decode([idx], skip_special_tokens=True)
        if "(" in d or "（" in d:
            bad.append(idx)
    return np.asarray(bad, np.int64)


def add_args(p: argparse.ArgumentParser):
    # speech encoder args (ref: agents/options.py add_speech_encoder_args)
    p.add_argument("--w2v2-path", type=str, default=None)
    p.add_argument("--w2v2-type", type=str, default="w2v2")
    p.add_argument("--ctc-finetuned", type=str, default="True",
                   help="accepted for CLI parity; the converter auto-"
                   "detects CTC-finetuned (w2v_encoder.w2v_model.*) vs "
                   "bare-SSL key layouts (convert/from_torch.py "
                   "strip_ctc_prefix, ref: model/speech_encoder.py:157-171)")
    p.add_argument("--length-shrink-cfg", type=str, default=None,
                   help="accepted for CLI parity; the adapter geometry is "
                   "fixed to [(1024,2,2)]*2 in the model preset")
    p.add_argument("--block-size", type=int, default=48)
    p.add_argument("--max-cache-size", type=int, default=576)
    p.add_argument("--xpos", type=int, default=0)
    p.add_argument("--rope", type=int, default=1)
    # gen args (ref: add_gen_args)
    p.add_argument("--beam", type=int, default=4)
    p.add_argument("--max-len-a", type=int, default=5)
    p.add_argument("--max-len-b", type=int, default=20)
    p.add_argument("--no-repeat-ngram-lookback", type=int, default=100)
    p.add_argument("--no-repeat-ngram-size", type=int, default=5)
    p.add_argument("--repetition-penalty", type=float, default=1.2)
    p.add_argument("--suppress-non-language", action="store_true")
    p.add_argument("--max-new-tokens", type=int, default=None)
    # sampling decode (ref: agents/options.py --do-sample/--temperature/
    # --top-k/--top-p/--epsilon-cutoff — the DPO data-collection path)
    # speculative greedy decode (TPU-native extension, no reference
    # counterpart): layer-skip draft + k-token verify; implies greedy
    p.add_argument("--speculative", action="store_true")
    p.add_argument("--spec-draft-layers", type=int, default=8)
    p.add_argument("--spec-k", type=int, default=4)
    # shortlist draft head width (0 = full lm_head); exact either way.
    # --spec-head-ids: .npy file of corpus-frequency-ranked token ids
    # (first spec-head-vocab entries used); default is the id prefix
    p.add_argument("--spec-head-vocab", type=int, default=0)
    p.add_argument("--spec-head-ids", type=str, default=None)
    # --spec-adapter: npz from train.draft.save_adapter (distilled
    # early-exit adapter; depth-checked against --spec-draft-layers)
    p.add_argument("--spec-adapter", type=str, default=None)
    # low-rank draft head (exact; verify keeps the full head):
    # --spec-lowrank-rank builds truncated-SVD factors from the loaded
    # lm_head at startup; --spec-lowrank-head loads prebuilt factors
    # (npz with arrays 'a' (D, r) and 'b' (r, V))
    p.add_argument("--spec-lowrank-rank", type=int, default=0)
    p.add_argument("--spec-lowrank-head", type=str, default=None)
    # --spec-beam: speculative BEAM search (decode/spec_beam.py) — the
    # winner is exactly beam_search's; requires --speculative and
    # --beam > 1 (the reference's quality configuration, accelerated)
    p.add_argument("--spec-beam", action="store_true")
    # acceptance guard (ON by default): a stream whose tokens-per-verify-
    # round EMA sits below the weight-stream break-even for
    # --spec-guard-patience chunks drops to plain-cost decode with
    # identical output (agents/infinisst.py); --spec-no-guard opts out
    # (raw overhead envelope)
    p.add_argument("--spec-no-guard", action="store_true")
    p.add_argument("--spec-guard-patience", type=int, default=3)
    # opt out of the guard's background AOT warm of the fallback
    # graph (on by default: a trip then swaps without a compile stall)
    p.add_argument("--spec-no-warm-fallback", action="store_true")
    p.add_argument("--do-sample", action="store_true")
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--top-k", type=int, default=0)
    p.add_argument("--top-p", type=float, default=1.0)
    p.add_argument("--epsilon-cutoff", type=float, default=0.0)
    p.add_argument("--sample-seed", type=int, default=0)
    p.add_argument("--translation-output-file", type=str,
                   default="translations.json",
                   help="per-chunk sampled translations dump (the DPO "
                   "collection output, ref: agents/infinisst.py:369-381)")
    # simuleval args (ref: add_simuleval_args)
    p.add_argument("--source-lang", type=str, default="English")
    p.add_argument("--target-lang", type=str, default="German")
    p.add_argument("--min-start-sec", type=float, default=0.0)
    # agent/infinisst args (ref: agents/infinisst.py add_args)
    p.add_argument("--model-name", type=str, default=None,
                   help="HF Llama dir (config+tokenizer+weights)")
    p.add_argument("--tokenizer-path", type=str, default=None)
    p.add_argument("--state-dict-path", type=str, default=None)
    p.add_argument("--latency-multiplier", type=int, default=1)
    p.add_argument("--max-latency-multiplier", type=int, default=4)
    p.add_argument("--max-llm-cache-size", type=int, default=1000)
    p.add_argument("--always-cache-system-prompt", action="store_true")
    # alignatt/streamatt
    p.add_argument("--frame-num", type=int, default=1)
    p.add_argument("--attn-layer", type=int, default=14)
    p.add_argument("--text-preserve-num", type=int, default=40)
    p.add_argument("--min-speech-duration", type=float, default=10.0)
    p.add_argument("--max-speech-duration", type=float, default=28.8)
    # eval harness
    p.add_argument("--agent", type=str, default="infinisst",
                   choices=["infinisst", "alignatt", "streamatt"])
    p.add_argument("--source", type=str, required=True)
    p.add_argument("--target", type=str, required=True)
    p.add_argument("--timing", type=str, default=None,
                   help="per-segment start_ms:dur_ms file "
                   "(prepare_simuleval_inputs.py .timing output) for true "
                   "StreamLAAL segment timing")
    p.add_argument("--output", type=str, default="eval_out")
    p.add_argument("--source-segment-size", type=int, default=None)
    p.add_argument("--eval-latency-unit", type=str, default="word")
    p.add_argument("--sacrebleu-tokenizer", type=str, default="13a")
    p.add_argument("--max-instances", type=int, default=None)
    p.add_argument("--model-preset", type=str, default="flagship",
                   choices=["flagship", "bench", "dryrun"])
    p.add_argument("--dtype", type=str, default="bfloat16")
    # the port's own: where the model runs (cpu runs the plain versions)
    p.add_argument("--device", type=str, default="cuda")


def check_agent_options(args):
    """Exit with a message for sampling or speculation with an offline
    agent, as the JAX CLI does."""
    if args.do_sample and args.agent != "infinisst":
        raise SystemExit(
            "--do-sample is only implemented for --agent infinisst (the "
            "reference's DPO collection path); the alignatt/streamatt "
            "policies are beam-only"
        )
    if args.speculative and args.agent != "infinisst":
        raise SystemExit(
            "--speculative is only implemented for --agent infinisst"
        )


def _load_head_ids(path, head_vocab):
    """A --spec-head-ids ``.npy`` checked against --spec-head-vocab: its
    first head_vocab ids, or None."""
    import numpy as np

    if not path:
        return None
    if not head_vocab:
        raise SystemExit(
            "--spec-head-ids requires --spec-head-vocab N (the first N "
            "ids of the file form the shortlist); without it the file "
            "would be silently ignored"
        )
    ids = np.load(path)
    if ids.ndim != 1 or len(ids) < head_vocab:
        raise SystemExit(
            f"--spec-head-ids {path}: need a 1-D array with >= "
            f"{head_vocab} ids, got shape {ids.shape}"
        )
    return ids[:head_vocab]


def _load_lowrank_head(args):
    """--spec-lowrank-head ``.npz`` -> {'a', 'b'} factors (numpy), or
    None."""
    import numpy as np

    path = getattr(args, "spec_lowrank_head", None)
    if not path:
        return None
    if not args.speculative:
        raise SystemExit("--spec-lowrank-head requires --speculative")
    z = np.load(path)
    if "a" not in z or "b" not in z:
        raise SystemExit(
            f"{path} must contain arrays 'a' (D, r) and 'b' (r, V)"
        )
    return {"a": z["a"], "b": z["b"]}


def _load_adapter(args):
    """--spec-adapter ``.npz``, its depth checked against
    --spec-draft-layers, or None."""
    if not getattr(args, "spec_adapter", None):
        return None
    if not args.speculative:
        raise SystemExit("--spec-adapter requires --speculative")
    from infinisst_tpu_torch.train.draft import load_adapter

    return load_adapter(args.spec_adapter, expect_d=args.spec_draft_layers)


def spec_options(args) -> dict:
    """The sampling and speculative options of ``InfiniSSTOptions`` from
    the flags (the loaders validate their files)."""
    return dict(
        speculative=args.speculative,
        spec_draft_layers=args.spec_draft_layers,
        spec_k=args.spec_k,
        spec_head_vocab=args.spec_head_vocab,
        spec_head_ids=_load_head_ids(args.spec_head_ids,
                                     args.spec_head_vocab),
        spec_adapter=_load_adapter(args),
        spec_lowrank_rank=args.spec_lowrank_rank,
        spec_lowrank_head=_load_lowrank_head(args),
        spec_beam=args.spec_beam,
        spec_guard=not args.spec_no_guard,
        spec_guard_patience=args.spec_guard_patience,
        spec_warm_fallback=not args.spec_no_warm_fallback,
        do_sample=args.do_sample,
        temperature=args.temperature,
        top_k=args.top_k,
        top_p=args.top_p,
        epsilon_cutoff=args.epsilon_cutoff,
        sample_seed=args.sample_seed,
        dpo_sampling=args.do_sample,
    )


def build_agent(args):
    import dataclasses

    import torch

    from infinisst_tpu_torch.agents.alignatt import (
        AlignAttAgent,
        AlignAttOptions,
    )
    from infinisst_tpu_torch.agents.infinisst import (
        InfiniSSTAgent,
        InfiniSSTOptions,
    )
    from infinisst_tpu_torch.agents.streamatt import (
        StreamAttAgent,
        StreamAttOptions,
    )
    from infinisst_tpu_torch.core.config import StreamConfig
    from infinisst_tpu_torch.core.device import resolve_device
    from infinisst_tpu_torch.core.presets import PRESETS
    from infinisst_tpu_torch.data.template import (
        HFTokenizerAdapter,
        PromptBuilder,
        StubTokenizer,
    )
    from infinisst_tpu_torch.train.main import build_params

    check_agent_options(args)
    device = resolve_device(args.device)
    cfg = PRESETS[args.model_preset]()
    if args.w2v2_type == "hubert":
        # hubert encoder variant: GroupNorm 'default' extractor
        # (ref: model/patches/patch_speech_encoder.py:80-218)
        cfg = cfg.replace(
            w2v2=dataclasses.replace(cfg.w2v2, extractor_mode="default")
        )
    if not args.rope or args.xpos:
        cfg = cfg.replace(
            w2v2=dataclasses.replace(
                cfg.w2v2, use_rope=bool(args.rope), use_xpos=bool(args.xpos)
            )
        )

    tok_path = args.tokenizer_path or args.model_name
    if tok_path:
        from transformers import AutoTokenizer

        from infinisst_tpu_torch.data.template import register_special_tokens

        tok = AutoTokenizer.from_pretrained(tok_path, use_fast=False)
        register_special_tokens(tok, cfg)
        tokenizer = HFTokenizerAdapter(tok)
    else:
        tokenizer = StubTokenizer(cfg.llama.vocab_size)
    builder = PromptBuilder(
        tokenizer, cfg.tokens, args.source_lang, args.target_lang,
        llama31=(args.model_name is None or "3.1" in str(args.model_name)),
    )

    suppress = None
    if args.suppress_non_language and tok_path:
        suppress = build_suppress_list(tokenizer)

    stream = StreamConfig(
        max_cache_frames=args.max_cache_size,
        max_llm_cache_tokens=args.max_llm_cache_size,
        llm_cache_capacity=max(1280, args.max_llm_cache_size + 280),
        always_cache_system_prompt=args.always_cache_system_prompt,
    )

    class _A:  # build_params' argument names
        llm_path = args.model_name
        w2v2_path = args.w2v2_path
        sllm_weight_path = args.state_dict_path

    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    params = build_params(_A, cfg, device=device, dtype=dtype)
    common = dict(
        latency_multiplier=args.latency_multiplier,
        max_latency_multiplier=args.max_latency_multiplier,
        beam=args.beam,
        output_file=args.translation_output_file,
        no_repeat_ngram_size=args.no_repeat_ngram_size,
        no_repeat_ngram_lookback=args.no_repeat_ngram_lookback,
        repetition_penalty=args.repetition_penalty,
        max_llm_cache_size=args.max_llm_cache_size,
        always_cache_system_prompt=args.always_cache_system_prompt,
        min_start_sec=args.min_start_sec,
        source_lang=args.source_lang,
        target_lang=args.target_lang,
        suppress_tokens=suppress,
    )
    if args.agent == "infinisst":
        return InfiniSSTAgent(params, cfg, stream, builder,
                              InfiniSSTOptions(**common, **spec_options(args)),
                              param_dtype=dtype, device=device)
    aa = dict(
        common,
        frame_num=args.frame_num,
        attn_layer=args.attn_layer,
        max_len_a=args.max_len_a,
        max_len_b=args.max_len_b,
        min_start_sec=max(args.min_start_sec, 0.32),
    )
    if args.agent == "alignatt":
        return AlignAttAgent(params, cfg, stream, builder,
                             AlignAttOptions(**aa), param_dtype=dtype,
                             device=device)
    return StreamAttAgent(
        params, cfg, stream, builder,
        StreamAttOptions(
            **aa,
            text_preserve_num=args.text_preserve_num,
            min_speech_duration=args.min_speech_duration,
            max_speech_duration=args.max_speech_duration,
        ),
        param_dtype=dtype, device=device,
    )


def main(argv=None):
    p = argparse.ArgumentParser()
    add_args(p)
    args = p.parse_args(argv)

    from infinisst_tpu_torch.eval.runner import EvalArgs, run_streaming_eval

    agent = build_agent(args)
    seg = args.source_segment_size or 960 * args.latency_multiplier
    scores = run_streaming_eval(
        agent,
        EvalArgs(
            source=args.source,
            target=args.target,
            timing=args.timing,
            output=args.output,
            source_segment_size=seg,
            eval_latency_unit=args.eval_latency_unit,
            sacrebleu_tokenizer=args.sacrebleu_tokenizer,
            max_instances=args.max_instances,
        ),
    )
    print(json.dumps(scores, indent=2))
    return scores


if __name__ == "__main__":
    main()
