"""Trained-teacher speculative acceptance through the agent; port of the
root ``tools_spec_trained_teacher.py``.

On the single-word copy task the trained agent emits about one token and
EOS a chunk, and a speculative round's first token is the full model's
own, so draft acceptance is zero by construction.  This tool uses the
PHRASE task instead: each 960 ms signature maps to a fixed three-word
phrase, so chunks emit 3-4 tokens and the draft has room.

  1. The teacher: a ``trajectory=4`` streaming model trained here on the
     phrase task with ``Trainer`` (``tools/trained_e2e.train_trajectory``),
     or loaded from ``--params``.
  2. The distillation corpus: train-domain audio streamed through the
     plain trained agent, its emissions rebuilt into spliced sequences by
     the ``trajectory=4`` collator.
  3. An exit adapter (``train/draft.py``) distilled on (h_d, teacher) over
     those spliced embeddings (``speech_llm.offline_spliced_embeddings``
     + ``draft.collect_targets_x``), the loss masked to decode positions.
  4. ``InfiniSSTAgent`` speculative greedy on held-out streams, the
     counters summed over utterances: acceptance, tokens a round against
     the break-even, the guard's fallbacks, and exactness against the
     plain greedy agent; rows with the guard on and off, k = 2 and 4,
     with and without the adapter.

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.tools.spec_trained_teacher [--steps 1000]
      [--distill-steps 400] [--params P] [--json F] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from infinisst_tpu_torch.data.audio import write_wav
from infinisst_tpu_torch.data.collators import COLLATORS
from infinisst_tpu_torch.data.dataset import SpeechToTextDataset
from infinisst_tpu_torch.data.sampler import SpeechSampler
from infinisst_tpu_torch.data.template import IGNORE_INDEX
from infinisst_tpu_torch.models.speech_llm import offline_spliced_embeddings
from infinisst_tpu_torch.tools import alignatt_quality as aq
from infinisst_tpu_torch.tools.trained_e2e import (
    make_infinisst,
    train_trajectory,
)
from infinisst_tpu_torch.train import draft as draft_mod

BLOCK, CACHE = 48, 96  # the trained model's streaming geometry


def phrase(tok, w):
    """The fixed 3-word phrase of one signature word: multi-token
    emissions a chunk give the draft room to be accepted."""
    (tid,) = tok.encode(w)
    return f"{w} y{tid % 97} z{tid % 89}"


def make_phrase_utt(tok, words, rng, k):
    ws = [words[rng.randint(len(words))] for _ in range(k)]
    wav = np.concatenate([aq.signature(tok, w) for w in ws])
    wav = wav + rng.randn(len(wav)).astype(np.float32) * 0.005
    steps = [phrase(tok, w) for w in ws]
    return steps, wav


def write_phrase_split(path, split, utts):
    rows = []
    for i, (steps, wav) in enumerate(utts):
        wpath = os.path.join(path, f"{split}_{i}.wav")
        write_wav(wpath, wav)
        rows.append({
            "id": f"{split}_{i}",
            "audio": wpath,
            "n_frames": str(len(wav)),
            "src_text": " ".join(steps),
            "tgt_text": " ".join(steps),
            "trajectory": repr(steps),
        })
    aq.write_rows(path, split, rows)


def stream_utt(agent, wav, n_units):
    """Push one utterance chunk by chunk; the emitted text of each chunk
    (an empty string for a chunk that only read)."""
    agent.reset()
    per_chunk = []
    for j in range(n_units):
        act = agent.push(wav[j * aq.UNIT:(j + 1) * aq.UNIT],
                         finished=(j == n_units - 1))
        per_chunk.append(act.content if (act is not None and not act.is_read()
                                         and act.content) else "")
    return per_chunk


@torch.no_grad()
def collect_serving_features(params, cfg, builder, workdir, split, d):
    """The trajectory collator over the serving corpus -> spliced
    embeddings -> (h_d, teacher, decode-position mask) feature batches,
    on the parameters' device."""
    dev = params["llama"]["lm_head"].device
    ds = SpeechToTextDataset.from_tsv(workdir, split)
    sampler = SpeechSampler(
        ds, shuffle=False, batch_size=2400, batch_size_sent=8, min_ms=320,
        multiplier=1, tokenizer=builder.tokenizer.encode,
    )
    collator = COLLATORS[4](builder, cfg, block_size=BLOCK, max_multiplier=1,
                            seed=0)
    sampler.set_epoch(0)

    def t(raw, k):
        return torch.as_tensor(np.asarray(raw[k]), device=dev)

    feats = []
    for idx_batch in sampler:
        raw = collator([ds[i] for i in idx_batch])
        emb = offline_spliced_embeddings(
            params, cfg, t(raw, "speech"), t(raw, "input_ids").to(torch.int64),
            t(raw, "patch_mask"), BLOCK, CACHE,
            frame_lengths=t(raw, "frame_lengths"), dropout_rate=0.0,
        )
        h_d, teacher = draft_mod.collect_targets_x(
            params["llama"], cfg.llama, emb, d, t(raw, "attention_mask"))
        # the draft is queried at positions whose NEXT token is decoded
        # target text: labels are unshifted (logits[p] predicts
        # labels[p + 1], train/objective.shifted_ce)
        lab = np.asarray(raw["labels"])
        mask = np.zeros(lab.shape, np.float32)
        mask[:, :-1] = (lab[:, 1:] != IGNORE_INDEX).astype(np.float32)
        feats.append((h_d, teacher, torch.as_tensor(mask, device=dev)))
    return feats


def measure_agent(params, cfg, builder, eval_utts, *, adapter=None, k=4,
                  d=1, guard=True, plain_ref=None, device="cuda"):
    """Stream every held-out utterance through the speculative agent and
    sum the per-stream counters (``agent.reset()`` zeroes them)."""
    agent = make_infinisst(
        params, cfg, builder, beam=1, device=device, speculative=True,
        spec_draft_layers=d, spec_k=k, spec_guard=guard, spec_adapter=adapter,
    )
    hyps = []
    tot = dict(rounds=0, drafted=0, accepted=0, emitted=0, fallbacks=0)
    for ws, wav in eval_utts:
        hyps.append(" ".join(s for s in stream_utt(agent, wav, len(ws)) if s))
        tot["rounds"] += agent.spec_rounds
        tot["drafted"] += agent.spec_drafted
        tot["accepted"] += agent.spec_accepted
        tot["emitted"] += agent.spec_emitted
        tot["fallbacks"] += int(agent.spec_fallback_active)
    acc = tot["accepted"] / tot["drafted"] if tot["drafted"] else 0.0
    tpr = tot["emitted"] / tot["rounds"] if tot["rounds"] else 0.0
    be = agent._spec_breakeven
    row = {
        "tag": "trained-teacher agent-path",
        "d": d,
        "k": k,
        "adapter": adapter is not None,
        "guard": guard,
        "accept_rate": round(acc, 4),
        "tokens_per_round": round(tpr, 3),
        "breakeven_tokens_per_round": round(be, 3) if be is not None else None,
        "clears_breakeven": bool(tpr > be) if be is not None else None,
        "guard_fallback_streams": tot["fallbacks"],
        "streams": len(eval_utts),
        **tot,
    }
    if plain_ref is not None:
        row["exact_match_vs_plain_greedy"] = round(float(np.mean(
            [h == p for h, p in zip(hyps, plain_ref)])), 3)
    return row


def load_or_train(args, cfg, builder, words, tok, dev):
    """The phrase teacher from ``args.params`` if it exists, else trained
    here (``args.steps`` on ``args.train_utts``, seed 11) and pickled
    there.  Returns (params, train_info)."""
    if os.path.exists(args.params):
        print(f"loaded {args.params}", flush=True)
        return aq.load_params(args.params, dev), {"loaded": args.params}
    rng = np.random.RandomState(11)
    train_utts = [make_phrase_utt(tok, words, rng, k=int(rng.randint(1, 5)))
                  for _ in range(args.train_utts)]
    write_phrase_split(args.workdir, "tr", train_utts)
    write_phrase_split(args.workdir, "dv",
                       train_utts[: max(4, len(train_utts) // 10)])
    print(f"training phrase trajectory model {args.steps} steps ...",
          flush=True)
    t0 = time.perf_counter()
    params, losses, eval_curve = train_trajectory(
        args.workdir, cfg, builder, args.steps, args.lr, dev)
    aq.save_params(params, args.params)
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
    return params, {
        "steps": args.steps,
        "loss_first": round(losses[0], 4),
        "loss_final": round(losses[-1], 4),
        "eval_loss_curve": eval_curve,
        "wall_s": round(time.perf_counter() - t0, 1),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=1000,
                    help="trajectory-model training steps (phrase task)")
    ap.add_argument("--distill-steps", type=int, default=400)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-utts", type=int, default=400)
    ap.add_argument("--corpus-utts", type=int, default=48)
    ap.add_argument("--eval-utts", type=int, default=24)
    ap.add_argument("--workdir", default="/tmp/spec_teacher2")
    ap.add_argument("--params", default="/tmp/spec_phrase_params.pkl",
                    help="phrase-model pickle; trained here if absent")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = aq.setup_device(args.device)
    cfg, tok, builder, words, _, _ = aq.task(0, 0)
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.perf_counter()
    params, train_info = load_or_train(args, cfg, builder, words, tok, dev)

    crng = np.random.RandomState(21)
    corpus_utts = [make_phrase_utt(tok, words, crng, k=int(crng.randint(2, 5)))
                   for _ in range(args.corpus_utts)]
    erng = np.random.RandomState(4321)
    eval_utts = [make_phrase_utt(tok, words, erng, k=4)
                 for _ in range(args.eval_utts)]

    d = max(1, cfg.llama.num_layers // 2)  # d/L = 0.5, the studied ratio

    # 1. the serving-distribution corpus from the plain trained agent
    plain = make_infinisst(params, cfg, builder, beam=1, device=dev)
    sv_utts = [(stream_utt(plain, wav, len(steps)), wav)
               for steps, wav in corpus_utts]
    write_phrase_split(args.workdir, "sv", sv_utts)
    n_emit = sum(1 for steps, _ in sv_utts for s in steps if s)
    print(f"serving corpus: {len(sv_utts)} streams, {n_emit} emitted steps",
          flush=True)

    # plain greedy reference outputs on the held-out set + task accuracy
    plain_ref, n_exact = [], 0
    for steps, wav in eval_utts:
        hyp = " ".join(s for s in stream_utt(plain, wav, len(steps)) if s)
        plain_ref.append(hyp)
        n_exact += int(hyp == tok.decode(tok.encode(" ".join(steps))))
    plain_acc = n_exact / len(eval_utts)
    print(f"plain greedy held-out exact: {plain_acc:.3f}", flush=True)

    # 2. distill the exit adapter on spliced serving contexts
    feats = collect_serving_features(params, cfg, builder, args.workdir,
                                     "sv", d)
    print(f"collected {len(feats)} feature batches", flush=True)
    adapter, hist = draft_mod.distill_on_features(
        params["llama"], cfg.llama, feats, steps=args.distill_steps,
        lr=args.lr, log_every=50,
    )
    print(f"distill: agreement {hist[0][2]:.3f} -> {hist[-1][2]:.3f}",
          flush=True)

    # 3. the agent-path speculative measurement
    rows = []
    for use_adapter in (False, True):
        for k in (2, 4):
            for guard in (True, False):
                row = measure_agent(
                    params, cfg, builder, eval_utts,
                    adapter=adapter if use_adapter else None, k=k, d=d,
                    guard=guard, plain_ref=plain_ref, device=dev,
                )
                rows.append(row)
                print(json.dumps(row), flush=True)

    result = {
        "teacher": "phrase-task trajectory model trained with Trainer "
                   "(tools/trained_e2e.train_trajectory's recipe)",
        "task": "synthetic phrase copy: each 960 ms signature -> a fixed "
                "3-word phrase (multi-token per-chunk emissions = real "
                "draft headroom)",
        "recipe": "serving-distribution distillation: agent emissions -> "
                  "trajectory collator -> spliced embeddings -> "
                  "collect_targets_x -> distill_on_features (decode-"
                  "position mask)",
        "model": "dryrun tiny speech-LLM",
        "d_over_L": round(d / cfg.llama.num_layers, 3),
        "train": train_info,
        "plain_greedy_heldout_exact": round(plain_acc, 3),
        "distill_history": [
            {"step": s, "kl": round(kl, 4), "agree": round(a, 4)}
            for s, kl, a in hist
        ],
        "rows": rows,
        "caveat": "tiny synthetic-task teacher: grounds machinery + "
                  "recipe on a trained model, not 8B MuST-C acceptance",
        "run": aq.run_info(dev, t0),
    }
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
