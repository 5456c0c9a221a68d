"""Layer-skip speculative acceptance on a trained model; port of the root
``tools_spec_acceptance.py``.

Where between acceptance 0 (random weights) and 1 (``--spec-accept-all``)
a real checkpoint lands is set by the layer-skip draft's acceptance rate,
which random weights cannot show.  This tool trains the Llama of
``tools/quant_fidelity.py`` to convergence (peaked, correlated layerwise
representations), then measures through ``decode/speculative
.speculative_greedy`` and ``decode/spec_beam.spec_beam_search``:

  - acceptance per draft depth d/L in {1/4, 2/4, 3/4, 4/4}, k = 4 and 9,
    and tokens emitted a verify round;
  - shortlist draft heads (``make_draft_head``) at 1/4 and 1/8 of the
    vocabulary, the id prefix and the corpus-frequency-ranked ids;
  - low-rank draft heads (``make_lowrank_draft_head``) at ranks D/2, D/4;
  - speculative beam search (beam 4) at every depth, k = 2 and 4;
  - a distilled exit adapter (``train/draft.py``) at d = 1 and 2 in three
    regimes: adapter(corpus-TF) on the teacher-forced corpus (the
    exposure-bias control), adapter(rollout) on the model's own greedy
    continuations of the measured prompts, adapter(rollout-x) on those of
    disjoint prompts; adapter(rollout) also with the ranked shortlist,
    in beam search and with the low-rank head;
  - ``--only-beam``: the beam rows again and the beam-selection
    (listwise) adapter (``draft.beam_selection_distill``), merged into an
    existing ``--json``.

The greedy prefix match against a one-token-at-a-time rollout is shown as
JAX's tool shows it: the verify forward's batched positions sum in
another order, so near-ties may fork (the acceptance is read on the
speculative path's own rollouts).

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.tools.spec_acceptance [--steps 600]
      [--distill-steps 400] [--json F] [--only-beam] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from infinisst_tpu_torch.decode.beam import BeamSpec
from infinisst_tpu_torch.decode.spec_beam import spec_beam_search
from infinisst_tpu_torch.decode.speculative import (
    SpecSpec,
    make_draft_head,
    make_lowrank_draft_head,
    speculative_greedy,
)
from infinisst_tpu_torch.models import llama as L
from infinisst_tpu_torch.streaming.state import init_decoder_state
from infinisst_tpu_torch.tools import alignatt_quality as aq
from infinisst_tpu_torch.tools.quant_fidelity import (
    CFG,
    greedy_rollout,
    make_corpus,
    train,
)
from infinisst_tpu_torch.train import draft as DR

G = 32  # tokens a stream


def _prefill(params, prompt, k):
    P = prompt.shape[0]
    emb = params["embed"]
    st = init_decoder_state(CFG.num_layers, 1, P + G + k + 1,
                            CFG.num_kv_heads, CFG.head_dim, emb.dtype,
                            emb.device)
    logits, st = L.decode_step(params, CFG, st, L.embed(params, prompt[None]))
    return logits[0, -1, : CFG.vocab_size], st


@torch.no_grad()
def run_spec(params, prompt, d: int, k: int, head_vocab: int = 0,
             head_ids=None, adapter=None, lowrank: int = 0):
    """One ``speculative_greedy`` rollout of G tokens after ``prompt``
    (no EOS, no logits processors); returns (tokens, rounds, drafted,
    accepted)."""
    spec = SpecSpec(max_new_tokens=G, eos_id=-1, pad_id=0, draft_layers=d,
                    draft_k=k, no_repeat_ngram_size=0, repetition_penalty=1.0)
    if lowrank:
        dh = make_lowrank_draft_head(params["lm_head"], lowrank)
    else:
        dh = (make_draft_head(params["lm_head"], head_vocab, ids=head_ids)
              if head_vocab else None)
    first, st = _prefill(params, prompt, k)
    hist = torch.zeros((8,), dtype=torch.int64, device=prompt.device)
    res = speculative_greedy(params, CFG, st, first, prompt, prompt.shape[0],
                             hist, 0, spec, draft_head=dh,
                             exit_adapter=adapter)
    return (list(res.tokens[: res.n_tokens]), res.rounds, res.drafted,
            res.accepted)


@torch.no_grad()
def run_beam(params, d: int, k: int, prompt, adapter=None):
    """One ``spec_beam_search`` of G steps at beam 4; returns (steps,
    rounds, drafted, accepted)."""
    bs = BeamSpec(beam=4, max_new_tokens=G, eos_id=-1, pad_id=0,
                  no_repeat_ngram_size=0, repetition_penalty=1.0)
    first, st = _prefill(params, prompt, k)
    res = spec_beam_search(
        params, CFG, st, first, prompt, prompt.shape[0],
        torch.zeros((8,), dtype=torch.int64, device=prompt.device), 0, bs,
        draft_layers=d, draft_k=k, exit_adapter=adapter,
    )
    return res.steps, res.rounds, res.drafted, res.accepted


def _gen(dev, seed):
    return torch.Generator(device=dev).manual_seed(seed)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--distill-steps", type=int, default=400)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--only-beam", action="store_true",
                    help="run only the spec-beam sections (baseline beam "
                         "rows + the beam-aware listwise adapter regime) "
                         "and merge rows into an existing --json file")
    ap.add_argument("--beam-distill-steps", type=int, default=600)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = aq.setup_device(args.device)
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    corpus = make_corpus(rng, n_seq=8, S=64)
    params = L.init_params(CFG, _gen(dev, 0), dev, torch.float32)
    print("training tiny llama...", file=sys.stderr)
    params = train(params, corpus, args.steps)

    def prompts(base, n, S):
        return [torch.as_tensor(make_corpus(np.random.RandomState(base + i),
                                            1, S)[0], device=dev)
                for i in range(n)]

    # teacher-distribution prompts: prefixes of training-rule sequences
    # from fresh seeds; held-out prompts: unseen random-rule prefixes
    teach, held = prompts(200, 6, 12), prompts(100, 6, 8)

    refs = {}
    if not args.only_beam:
        for tag, ps in (("teach", teach), ("held", held)):
            refs[tag] = [greedy_rollout(params, p, 32) for p in ps]

    results = {
        "config": f"llama D=256 I=512 L=4 V=512 f32-trained "
                  f"({args.steps} steps); G={G} tokens/stream, 6 streams "
                  "per split",
        "caveat": "4-layer overfit model: depth-ratio analogue, "
                  "optimistic vs a real 8B checkpoint; the held rows are "
                  "the informative ones",
        "rows": [],
    }
    # corpus-frequency-ranked ids: the synthetic analogue of a real BPE
    # vocabulary's merge-ordered id prefix (a high-coverage shortlist)
    freq = np.bincount(corpus.ravel(), minlength=CFG.vocab_size)
    ranked = np.argsort(-freq).astype(np.int32)
    variants = [("full", 0)]
    for hv in (CFG.vocab_size // 4, CFG.vocab_size // 8):
        variants += [("prefix", hv), ("ranked", hv)]

    def measure(d, k, hv, mode, head_ids=None, adapter=None, lowrank=0):
        row = {"d_over_L": round(d / CFG.num_layers, 2), "draft_layers": d,
               "draft_k": k, "head_vocab": hv or CFG.vocab_size,
               "head_mode": mode}
        for tag, ps in (("teach", teach), ("held", held)):
            rounds = drafted = accepted = emitted = 0
            match = []
            for p, ref in zip(ps, refs[tag]):
                toks, r, dr, ac = run_spec(params, p, d, k, hv,
                                           head_ids=head_ids, adapter=adapter,
                                           lowrank=lowrank)
                if len(toks) != G:
                    raise RuntimeError(f"{(d, k, hv)}: {len(toks)} tokens")
                match.append(next((i for i, (a, b) in enumerate(zip(toks, ref))
                                   if a != b), G))
                rounds += r
                drafted += dr
                accepted += ac
                emitted += len(toks)
            row[f"{tag}_accept_rate"] = round(accepted / drafted, 4)
            row[f"{tag}_tok_per_round"] = round(emitted / rounds, 3)
            row[f"{tag}_greedy_prefix_match"] = match
        results["rows"].append(row)
        print(json.dumps(row), file=sys.stderr)

    def measure_beam(d, kk, mode, adapter=None):
        row = {"d_over_L": round(d / CFG.num_layers, 2), "draft_layers": d,
               "draft_k": kk, "head_vocab": CFG.vocab_size,
               "head_mode": mode}
        for tag, ps in (("teach", teach), ("held", held)):
            steps = rounds = drafted = accepted = 0
            for p in ps:
                s_, r_, dr_, ac_ = run_beam(params, d, kk, p, adapter=adapter)
                steps += s_
                rounds += r_
                drafted += dr_
                accepted += ac_
            row[f"{tag}_accept_rate"] = round(accepted / max(drafted, 1), 4)
            row[f"{tag}_steps_per_round"] = round(steps / max(rounds, 1), 3)
        results["rows"].append(row)
        print(json.dumps(row), file=sys.stderr)

    if not args.only_beam:
        for d in (1, 2, 3, 4):
            for k in (4, 9):
                for mode, hv in variants:
                    head_ids = ranked[:hv] if mode == "ranked" and hv else None
                    measure(d, k, hv, mode, head_ids=head_ids)
        # low-rank draft heads (truncated SVD of the trained head)
        for d in (1, 2, 4):
            for rank in (CFG.hidden_size // 2, CFG.hidden_size // 4):
                for k in (4, 9):
                    measure(d, k, 0, f"lowrank{rank}", lowrank=rank)

    # speculative beam search: acceptance counts whole B-beam selections
    if args.only_beam:
        for d in (1, 2):
            for kk in (2, 4):
                measure_beam(d, kk, "beam4(rebaseline)")
    else:
        for d in (1, 2, 3, 4):
            for kk in (2, 4):
                measure_beam(d, kk, "beam4")

    # the beam-aware listwise adapter: beam states rolled out with the
    # target, the adapter distilled on the selection spec_beam verifies
    rollouts = DR.Rollouts(params, CFG)  # a shape's programs replay
    roll_beam = []
    for p in list(teach) + list(held):
        roll_beam.extend(rollouts.beam(p, G, beam=4))
    S_max = max(s["buf"].shape[1] for s in roll_beam)
    for s in roll_beam:
        pad = S_max - s["buf"].shape[1]
        if pad:
            s["buf"] = np.pad(s["buf"], ((0, 0), (0, pad)))
    for d in (1, 2):
        print(f"beam-listwise distilling d={d}...", file=sys.stderr)
        adapter_b, hist_b = DR.beam_selection_distill(
            params, CFG, d, roll_beam, steps=args.beam_distill_steps,
            lr=2e-3, key=_gen(dev, 60 + d), log_every=100,
        )
        results[f"beam_distill_d{d}"] = [
            {"step": s_, "ce": round(l_, 4), "selection_agree": round(a_, 4)}
            for s_, l_, a_ in hist_b
        ]
        for kk in (2, 4):
            measure_beam(d, kk, "beam4+adapter(beamroll-listwise)",
                         adapter=adapter_b)

    if args.only_beam:
        results["run"] = aq.run_info(dev, t0)
        print(json.dumps(results, indent=2))
        if args.json:
            out = results
            if os.path.exists(args.json):
                with open(args.json) as f:
                    prev = json.load(f)
                prev["rows"].extend(results["rows"])
                for kk in results:
                    if kk.startswith("beam_distill") or kk == "run":
                        prev[kk] = results[kk]
                out = prev
            with open(args.json, "w") as f:
                json.dump(out, f, indent=2)
        return results

    # the distilled exit adapter in three regimes (draft only: exactness
    # untouched in all of them)
    roll_in = [rollouts.greedy(torch.stack(teach), G),
               rollouts.greedy(torch.stack(held), G)]
    xfer = torch.stack(prompts(300, 12, 8))
    roll_x = [rollouts.greedy(xfer, G)]
    del rollouts

    for d in (1, 2):
        hv = CFG.vocab_size // 4
        regimes = (("adapter(corpus-TF)", [corpus[:, :48]]),
                   ("adapter(rollout)", roll_in),
                   ("adapter(rollout-x)", roll_x))
        for mode, batches in regimes:
            print(f"distilling exit adapter d={d} {mode}...", file=sys.stderr)
            adapter, hist_log = DR.distill(
                params, CFG, d, batches, steps=args.distill_steps, lr=2e-3,
                key=_gen(dev, 40 + d), log_every=100,
            )
            results[f"distill_d{d}_{mode}"] = [
                {"step": s, "kl": round(lo, 4), "top1_agree": round(a, 4)}
                for s, lo, a in hist_log
            ]
            for k in (4, 9):
                measure(d, k, 0, mode, adapter=adapter)
            if mode == "adapter(rollout)":
                measure(d, 4, hv, "adapter(rollout)+ranked",
                        head_ids=ranked[:hv], adapter=adapter)
                for kk in (2, 4):
                    measure_beam(d, kk, "beam4+adapter(rollout)",
                                 adapter=adapter)
                r4 = CFG.hidden_size // 4
                measure(d, 4, 0, f"adapter(rollout)+lowrank{r4}",
                        adapter=adapter, lowrank=r4)

    results["run"] = aq.run_info(dev, t0)
    print(json.dumps(results, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results


if __name__ == "__main__":
    main()
