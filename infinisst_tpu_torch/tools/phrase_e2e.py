"""Phrase-task scores through the streaming agent, a non-identity
end-to-end run; port of the root ``tools_phrase_e2e.py``.

The copy task's target is its source words.  The phrase task
(``tools/spec_trained_teacher.py``) maps each 960 ms signature to a
fixed 3-word phrase, a source -> target mapping that is not the
identity; a model trained with the release streaming recipe streams
through ``InfiniSSTAgent`` and ``eval/runner.run_streaming_eval``
against its untrained twin (``tools/trained_e2e.score``: the runner's
scores, exact match and TER).

It reuses the teacher of ``tools.spec_trained_teacher`` (``--params``)
when the pickle exists, else trains it with the same recipe.

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.tools.phrase_e2e [--params P] [--json F]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from infinisst_tpu_torch.tools import alignatt_quality as aq
from infinisst_tpu_torch.tools.spec_trained_teacher import (
    load_or_train,
    make_phrase_utt,
)
from infinisst_tpu_torch.tools.trained_e2e import (
    make_infinisst,
    score,
    write_eval,
)


def write_phrase_eval_files(workdir, eval_utts, tok):
    return write_eval(os.path.join(workdir, "phrase_eval"), "p", [
        (tok.decode(tok.encode(" ".join(steps))), wav)
        for steps, wav in eval_utts])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", default="/tmp/spec_phrase_params.pkl",
                    help="phrase-model pickle (spec_trained_teacher); "
                         "trained here if absent")
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-utts", type=int, default=400)
    ap.add_argument("--eval-utts", type=int, default=24)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--workdir", default="/tmp/phrase_e2e")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = aq.setup_device(args.device)
    cfg, tok, builder, words, _, _ = aq.task(0, 0)
    os.makedirs(args.workdir, exist_ok=True)
    t0 = time.perf_counter()
    params, train_info = load_or_train(args, cfg, builder, words, tok, dev)

    # held-out streams (a seed apart from the training seed 11)
    erng = np.random.RandomState(4321)
    eval_utts = [make_phrase_utt(tok, words, erng, k=4)
                 for _ in range(args.eval_utts)]
    eval_dir = write_phrase_eval_files(args.workdir, eval_utts, tok)

    sec = {
        "task": "synthetic phrase mapping: each 960 ms signature -> a "
                "fixed 3-word phrase (NON-identity source->target mapping; "
                "the spec_trained_teacher tool's teacher)",
        "recipe": "trajectory=4 multi-latency collator at m=1, block 48 / "
                  "cache 96 (release streaming recipe)",
        "beam": args.beam,
        "train": train_info,
    }
    sec["trained"] = score(make_infinisst(params, cfg, builder, args.beam,
                                          dev),
                           eval_dir, "out_phrase_trained")
    print(json.dumps({"trained": sec["trained"]}), flush=True)
    sec["random"] = score(make_infinisst(aq.init_params(cfg, dev), cfg,
                                         builder, args.beam, dev),
                          eval_dir, "out_phrase_random")
    print(json.dumps({"random": sec["random"]}), flush=True)
    sec["run"] = aq.run_info(dev, t0)

    result = {}
    if args.json and os.path.exists(args.json):
        with open(args.json) as f:
            result = json.load(f)
    result["phrase_task"] = sec
    print(json.dumps({"phrase_task": sec}, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
