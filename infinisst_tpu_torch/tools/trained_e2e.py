"""Trained-model end-to-end run: train -> export -> agent -> eval; port of
the root ``tools_trained_e2e.py``.

Tiny speech-LLMs trained on the synthetic copy task of
``tools/alignatt_quality.py`` stream through the agents and are scored by
``eval/runner.run_streaming_eval`` (BLEU where sacrebleu is installed,
NaN where it is not; StreamLAAL with and without computation; RTF),
against their untrained twins.  Besides the runner's scores, ``score``
reads the hypotheses back from ``instances.log`` for the exact-match
share and the token error rate, which need no sacrebleu.

Two agent paths:

- ``alignatt``: the offline-recipe model (a ``--offline-params`` pickle
  from ``tools.alignatt_quality --save-params``) through ``AlignAttAgent``
  in reference parity and with ``attn_early_stop``;
- ``infinisst``: a model trained here (or loaded from ``--traj-params``)
  with the release streaming recipe (the ``trajectory=4`` multi-latency
  collator at m=1, block 48 / cache 96) through ``InfiniSSTAgent``.

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.tools.trained_e2e
      [--offline-params P] [--traj-params P] [--steps 3000] [--json F]
      [--skip-alignatt] [--skip-infinisst] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from infinisst_tpu_torch.agents.infinisst import (
    InfiniSSTAgent,
    InfiniSSTOptions,
)
from infinisst_tpu_torch.core.config import StreamConfig
from infinisst_tpu_torch.data.audio import write_wav
from infinisst_tpu_torch.eval.runner import EvalArgs, run_streaming_eval
from infinisst_tpu_torch.tools import alignatt_quality as aq
from infinisst_tpu_torch.tools.alignatt_quality import make_alignatt
from infinisst_tpu_torch.tools.preprocess.utils import word_error_rate


def train_trajectory(workdir, cfg, builder, steps, lr, device="cuda",
                     params=None):
    """Train with the release streaming recipe at m=1: the multi-latency
    trajectory collator, a block-causal encoder (48-frame blocks, a
    96-frame cache: the agent's streaming geometry).  ``params``: the
    initial weights (default ``alignatt_quality.init_params``)."""
    from infinisst_tpu_torch.train.trainer import TrainerArgs

    args = TrainerArgs(
        data_path=workdir, data_split_train="tr", data_split_eval="dv",
        trajectory=4,
        trajectory_max_multiplier=1,  # the copy task is one word / 960 ms
        stage=2, train_bsz=600, eval_bsz=600, bsz_sent=4, learning_rate=lr,
        warmup_steps=20, scheduler="cosine", max_epochs=10_000,
        max_steps=steps, grad_acc_steps=1, clip_norm=1.0, log_step=20,
        eval_step=200, save_step=0, save_dir=os.path.join(workdir, "run_traj"),
        block_size=48, max_cache_size=96, encoder_dropout=0.0,
    )
    if params is None:
        params = aq.init_params(cfg, device)
    return aq.fit_run(args, cfg, builder, params, device)


def write_eval(d, prefix, items):
    """``<prefix><i>.wav`` and SimulEval-style eval.source/eval.target
    under ``d`` for run_streaming_eval, from (reference, wav) items."""
    os.makedirs(d, exist_ok=True)
    src_lines, tgt_lines = [], []
    for i, (ref, wav) in enumerate(items):
        p = os.path.join(d, f"{prefix}{i}.wav")
        write_wav(p, wav)
        src_lines.append(p)
        tgt_lines.append(ref)
    with open(os.path.join(d, "eval.source"), "w") as f:
        f.write("\n".join(src_lines) + "\n")
    with open(os.path.join(d, "eval.target"), "w") as f:
        f.write("\n".join(tgt_lines) + "\n")
    return d


def write_eval_files(workdir, eval_utts, tok):
    """wavs + SimulEval-style .source/.target for run_streaming_eval."""
    return write_eval(os.path.join(workdir, "e2e_eval"), "e",
                      [(aq.ref_text(tok, ws), wav) for ws, wav in eval_utts])


def make_infinisst(params, cfg, builder, beam, device="cuda", **extra):
    """``extra`` forwards further InfiniSSTOptions fields (the speculative
    options of ``tools/spec_trained_teacher.py``)."""
    stream_cfg = StreamConfig(max_cache_frames=96, max_llm_cache_tokens=200,
                              llm_cache_capacity=320)
    opts = InfiniSSTOptions(latency_multiplier=1, beam=beam,
                            max_llm_cache_size=200,
                            no_repeat_ngram_lookback=16, **extra)
    return InfiniSSTAgent(params, cfg, stream_cfg, builder, opts,
                          param_dtype=torch.float32, device=device)


def score(agent, eval_dir, out_name):
    """The runner's scores, rounded as JAX's tool rounds them, plus the
    exact-match share and the mean token error rate of the hypotheses."""
    out = os.path.join(eval_dir, out_name)
    scores = run_streaming_eval(agent, EvalArgs(
        source=os.path.join(eval_dir, "eval.source"),
        target=os.path.join(eval_dir, "eval.target"),
        output=out,
    ))
    with open(os.path.join(out, "instances.log")) as f:
        inst = [json.loads(line) for line in f]
    scores["exact_match"] = float(np.mean(
        [r["prediction"] == r["reference"] for r in inst]))
    scores["ter"] = float(np.mean(
        [word_error_rate(r["prediction"], r["reference"]) for r in inst]))
    return {k: (round(v, 3) if isinstance(v, float) else v)
            for k, v in scores.items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--offline-params", default="/tmp/aaq_params.pkl",
                    help="pickle from alignatt_quality --save-params")
    ap.add_argument("--traj-params", default="/tmp/traj_params.pkl",
                    help="trajectory-recipe pickle; trained here if absent")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-utts", type=int, default=500)
    ap.add_argument("--eval-utts", type=int, default=24)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--workdir", default="/tmp/trained_e2e")
    ap.add_argument("--json", default="")
    ap.add_argument("--skip-alignatt", action="store_true")
    ap.add_argument("--skip-infinisst", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = aq.setup_device(args.device)
    cfg, tok, builder, _, train_utts, eval_utts = aq.task(args.train_utts,
                                                          args.eval_utts)
    os.makedirs(args.workdir, exist_ok=True)
    aq.write_split(args.workdir, "tr", train_utts)
    aq.write_split(args.workdir, "dv",
                   train_utts[: max(4, len(train_utts) // 10)])
    eval_dir = write_eval_files(args.workdir, eval_utts, tok)
    random_params = aq.init_params(cfg, dev)
    t0 = time.perf_counter()

    result = {
        "task": "synthetic monotonic copy (32 words x 960ms signatures)",
        "model": "dryrun tiny speech-LLM (2L w2v2 frozen, 2L llama trained)",
        "eval": "eval/runner.run_streaming_eval: BLEU (NaN without "
                "sacrebleu) + StreamLAAL(+CA) + RTF, exact match and TER, "
                f"over {args.eval_utts} held-out 4-word streams",
        "beam": args.beam,
        "caveat": (
            "tiny proxy on a synthetic task: proves the train->export->"
            "agent->eval loop produces a working system, not MuST-C parity"
        ),
    }

    if not args.skip_alignatt:
        offline = aq.load_params(args.offline_params, dev)
        sec = {"params": args.offline_params}
        sec["tf_content_acc_heldout"] = round(aq.teacher_forced_acc(
            offline, cfg, builder, eval_utts, args.workdir, dev), 4)
        for name, early in (("parity", False), ("early_stop", True)):
            sec[f"trained_{name}"] = score(
                make_alignatt(offline, cfg, builder, early, args.beam, dev),
                eval_dir, f"out_aa_trained_{name}")
        sec["random_parity"] = score(
            make_alignatt(random_params, cfg, builder, False, args.beam, dev),
            eval_dir, "out_aa_random")
        result["alignatt"] = sec
        print(json.dumps({"alignatt": sec}, indent=1), flush=True)

    if not args.skip_infinisst:
        if os.path.exists(args.traj_params):
            traj = aq.load_params(args.traj_params, dev)
            train_info = {"loaded": args.traj_params}
        else:
            print(f"training trajectory model {args.steps} steps ...",
                  flush=True)
            t1 = time.perf_counter()
            traj, losses, eval_curve = train_trajectory(
                args.workdir, cfg, builder, args.steps, args.lr, dev)
            aq.save_params(traj, args.traj_params)
            train_info = {
                "steps": args.steps,
                "loss_first": round(losses[0], 4),
                "loss_final": round(losses[-1], 4),
                "loss_curve": [round(x, 4) for x in losses[:: max(
                    1, len(losses) // 40)]],
                "eval_loss_curve": eval_curve,
                "wall_s": round(time.perf_counter() - t1, 1),
            }
        sec = {
            "recipe": "trajectory=4 multi-latency collator at m=1, "
                      "block 48 / cache 96 (release streaming recipe)",
            "train": train_info,
        }
        sec["trained"] = score(make_infinisst(traj, cfg, builder, args.beam,
                                              dev),
                               eval_dir, "out_is_trained")
        sec["random"] = score(make_infinisst(random_params, cfg, builder,
                                             args.beam, dev),
                              eval_dir, "out_is_random")
        result["infinisst"] = sec
        print(json.dumps({"infinisst": sec}, indent=1), flush=True)

    result["run"] = aq.run_info(dev, t0)
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
