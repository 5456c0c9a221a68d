"""AlignAtt early-stop quality delta on a trained model; port of the root
``tools_alignatt_quality.py``.

Random weights cannot measure what ``attn_early_stop`` costs: their
near-uniform attention fires the stop zone at once.  This tool makes the
regime the policy assumes, concentrated and monotonic speech-to-text
attention, without checkpoints:

  1. A synthetic copy task: each content word owns a fixed 960 ms
     waveform signature; an utterance is K in [1, 4] signatures (plus
     noise) and its target is the K words in order.
  2. The dryrun speech-LLM is trained on it with ``train/trainer.Trainer``
     (the offline stage-2 recipe: single-turn prompt, frozen wav2vec2,
     an effectively bidirectional encoder).
  3. Held-out utterances stream through ``AlignAttAgent`` in reference
     parity (generate to the cap, truncate afterwards) and with
     ``attn_early_stop``, with the kernels on a card: token error rate
     against the truth per mode, the disagreement between the modes, the
     monotonic share of the most-attended frames, the same rows for the
     untrained twin, and the teacher-forced held-out content accuracy.

Parameters are pickled as the JAX tool pickles them, a tree of dicts,
lists and numpy arrays (``--save-params`` / ``--load-params``), so a
model trained by either package runs in the other.

Usage (``--device`` defaults to ``cuda``):
  python -m infinisst_tpu_torch.tools.alignatt_quality [--steps 2000]
      [--json out.json] [--save-params P | --load-params P] [--device cpu]
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import pickle
import shutil
import time

import numpy as np
import torch

from infinisst_tpu_torch.agents.alignatt import AlignAttAgent, AlignAttOptions
from infinisst_tpu_torch.core.config import StreamConfig
from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.core.presets import dryrun_config
from infinisst_tpu_torch.data.audio import write_wav
from infinisst_tpu_torch.data.template import PromptBuilder, StubTokenizer
from infinisst_tpu_torch.tools.preprocess.utils import word_error_rate
from infinisst_tpu_torch.train.step import tree_map

UNIT = 15360  # 960 ms at 16 kHz: one trajectory step, one agent chunk


# ---------------------------------------------------------------------------
# parameters on disk: the JAX tools' pickle of numpy arrays

class _NumpyUnpickler(pickle.Unpickler):
    """Reads only numpy arrays inside builtin containers: anything else a
    pickle names (a JAX or other package's class) is refused."""

    _ALLOWED = {
        ("numpy", "ndarray"), ("numpy", "dtype"),
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy.core.multiarray", "scalar"),
        ("numpy._core.multiarray", "scalar"),
    }

    def find_class(self, module, name):
        if (module, name) not in self._ALLOWED:
            raise pickle.UnpicklingError(
                f"parameter pickle names {module}.{name}: only numpy arrays "
                "in dicts and lists are read")
        return super().find_class(module, name)


def _check_tree(tree, path="params"):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _check_tree(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _check_tree(v, f"{path}[{i}]")
    elif not isinstance(tree, np.ndarray):
        raise TypeError(f"{path} is a {type(tree).__name__}, not an array")


def load_params(path: str, device="cuda"):
    """The parameter tree pickled by either package's tool, as float32
    tensors on ``device`` (through ``convert/from_jax``)."""
    from infinisst_tpu_torch.convert.from_jax import from_jax

    with open(path, "rb") as f:
        tree = _NumpyUnpickler(f).load()
    _check_tree(tree)
    return from_jax(tree, device=device, dtype=torch.float32)


def save_params(params, path: str):
    """Pickle ``params`` as the JAX tools do: numpy arrays, same tree."""
    tree = tree_map(lambda t: t.detach().cpu().numpy(), params)
    with open(path, "wb") as f:
        pickle.dump(tree, f)


# ---------------------------------------------------------------------------
# the task

def content_words(tok, n=32):
    """n words with pairwise-distinct StubTokenizer ids (id -> signature
    must be injective or the task is unlearnable)."""
    words, seen = [], set()
    i = 0
    while len(words) < n:
        w = f"w{i}"
        i += 1
        (tid,) = tok.encode(w)
        if tid in seen:
            continue
        seen.add(tid)
        words.append(w)
    return words


def signature(tok, word):
    """The word's fixed waveform: deterministic in its token id."""
    (tid,) = tok.encode(word)
    rng = np.random.RandomState(100000 + tid)
    return (rng.randn(UNIT) * 0.1).astype(np.float32)


def make_utt(tok, words, rng, k):
    ws = [words[rng.randint(len(words))] for _ in range(k)]
    wav = np.concatenate([signature(tok, w) for w in ws])
    wav = wav + rng.randn(len(wav)).astype(np.float32) * 0.005
    return ws, wav


def write_rows(path, split, rows):
    """``<split>.tsv`` under ``path`` in the dataset's TSV dialect."""
    with open(os.path.join(path, f"{split}.tsv"), "w", newline="") as f:
        w = csv.DictWriter(
            f, fieldnames=list(rows[0].keys()), delimiter="\t",
            quotechar=None, doublequote=False, lineterminator="\n",
            quoting=csv.QUOTE_NONE,
        )
        w.writeheader()
        for r in rows:
            w.writerow(r)


def write_split(path, split, utts):
    rows = []
    for i, (ws, wav) in enumerate(utts):
        wpath = os.path.join(path, f"{split}_{i}.wav")
        write_wav(wpath, wav)
        rows.append({
            "id": f"{split}_{i}",
            "audio": wpath,
            "n_frames": str(len(wav)),
            "src_text": " ".join(ws),
            "tgt_text": " ".join(ws),
            "trajectory": repr(ws),
        })
    write_rows(path, split, rows)


def run_info(dev, t0):
    """The run's wall since ``t0`` and, on a card, its peak memory."""
    info = {"wall_s": round(time.perf_counter() - t0, 1),
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu")}
    if dev.type == "cuda":
        info["peak_mem_gib"] = round(
            torch.cuda.max_memory_allocated(dev) / 2**30, 3)
    return info


def setup_device(device):
    """The tools' device, with TF32 off on a card: float32 models."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.cuda.reset_peak_memory_stats(dev)
    return dev


def init_params(cfg, device="cuda"):
    """The untrained speech-LLM: seeded generators on ``device`` (JAX's
    tool draws from ``PRNGKey(0)``, so the two packages' draws differ)."""
    from infinisst_tpu_torch.train.main import random_params

    return random_params(cfg, device)


def fit_run(args, cfg, builder, params, device):
    """``Trainer(args).fit()`` from ``params``; returns (trained params,
    train losses, eval curve) from the run's metrics.jsonl."""
    from infinisst_tpu_torch.train.trainer import Trainer

    shutil.rmtree(args.save_dir, ignore_errors=True)  # no stale resume
    t = Trainer(args, cfg, builder, params, device=device)
    t.fit()
    with open(os.path.join(args.save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    losses = [m["train_loss"] for m in rows if "train_loss" in m]
    eval_curve = [{"step": m.get("step"),
                   "eval_loss": round(m["eval_loss"], 4)}
                  for m in rows if "eval_loss" in m]
    return t.state.params, losses, eval_curve


def train(workdir, cfg, builder, steps, lr, device="cuda", params=None):
    """The OFFLINE recipe AlignAtt drives (single-turn prompt,
    ``trajectory=1``; an effectively bidirectional encoder, block and
    cache 10**6), stage 2 (frozen wav2vec2: the random encoder already
    separates the signatures).  ``params``: the initial weights (default
    ``init_params``)."""
    from infinisst_tpu_torch.train.trainer import TrainerArgs

    args = TrainerArgs(
        data_path=workdir, data_split_train="tr", data_split_eval="dv",
        trajectory=1, stage=2, train_bsz=600, eval_bsz=600, bsz_sent=4,
        learning_rate=lr, warmup_steps=20, scheduler="cosine",
        max_epochs=10_000, max_steps=steps, grad_acc_steps=1, clip_norm=1.0,
        log_step=20, eval_step=200, save_step=0,
        save_dir=os.path.join(workdir, "run"),
        block_size=10**6, max_cache_size=10**6, encoder_dropout=0.0,
    )
    if params is None:
        params = init_params(cfg, device)
    return fit_run(args, cfg, builder, params, device)


# ---------------------------------------------------------------------------
# the agent

def stream(agent, wav, n_units):
    """Push one utterance chunk by chunk; return (text, most_attended)."""
    agent.reset()
    outs = []
    for j in range(n_units):
        act = agent.push(wav[j * UNIT:(j + 1) * UNIT],
                         finished=(j == n_units - 1))
        if act is not None and not act.is_read() and act.content:
            outs.append(act.content)
    return " ".join(outs), list(agent.states.most_attended_indices)


def monotonic_frac(indices):
    if len(indices) < 2:
        return 1.0
    d = np.diff(np.asarray(indices))
    return float((d >= 0).mean())


def make_alignatt(params, cfg, builder, early_stop, beam, device="cuda"):
    """The tools' AlignAtt agent: layer 1's probe, 2-unit audio buckets,
    a 16-token buffer, in reference parity or with ``attn_early_stop``."""
    stream_cfg = StreamConfig(max_cache_frames=96, llm_cache_capacity=256)
    opts = AlignAttOptions(
        latency_multiplier=1, beam=beam, attn_layer=1, frame_num=1,
        length_bucket_chunks=2, decode_buf_tokens=16,
        no_repeat_ngram_lookback=16, attn_early_stop=early_stop,
    )
    return AlignAttAgent(params, cfg, stream_cfg, builder, opts,
                         param_dtype=torch.float32, device=device)


def evaluate(params, cfg, builder, eval_utts, tok, beam, early_stop,
             device="cuda"):
    agent = make_alignatt(params, cfg, builder, early_stop, beam, device)
    hyps, monos, times = [], [], []
    for i, (ws, wav) in enumerate(eval_utts):
        t0 = time.perf_counter()
        text, attended = stream(agent, wav, len(ws))
        if i > 0:  # as JAX's tool: utterance 0 is left out of the time
            times.append((time.perf_counter() - t0) / len(ws))
        hyps.append(text)
        monos.append(monotonic_frac(attended))
    return hyps, float(np.mean(monos)), float(np.mean(times) if times
                                              else float("nan"))


def ref_text(tok, ws):
    return tok.decode(tok.encode(" ".join(ws)))


@torch.no_grad()
def teacher_forced_acc(params, cfg, builder, eval_utts, workdir,
                       device="cuda"):
    """Held-out content-token argmax accuracy through the training forward
    (teacher-forced): did the proxy learn the task, apart from the agent's
    decode policy."""
    from infinisst_tpu_torch.data.collators import OfflineInstructCollator
    from infinisst_tpu_torch.data.dataset import SpeechToTextDataset
    from infinisst_tpu_torch.models import speech_llm

    dev = resolve_device(device)
    write_split(workdir, "ev", eval_utts)
    ds = SpeechToTextDataset.from_tsv(workdir, "ev")
    coll = OfflineInstructCollator(builder, cfg, block_size=10**6)
    b = coll([ds[i] for i in range(len(ds))])

    def t(k):
        return torch.as_tensor(np.asarray(b[k]), device=dev)

    logits = speech_llm.offline_forward(
        params, cfg, t("speech"), t("input_ids").to(torch.int64),
        t("patch_mask"), 10**6, 10**6, frame_lengths=t("frame_lengths"),
        attention_mask=t("attention_mask"),
    )
    lab = np.asarray(b["labels"])
    pred = torch.argmax(logits, -1).cpu().numpy()
    content = (lab >= 10) & (lab < 900)  # StubTokenizer content id range
    hit = (pred[:, :-1] == lab[:, 1:])[content[:, 1:]]
    return float(hit.mean())


def mode_rows(params, cfg, builder, eval_utts, tok, beam, device="cuda"):
    refs = [ref_text(tok, ws) for ws, _ in eval_utts]
    out, hyp_by_mode = {}, {}
    for name, early in (("parity", False), ("early_stop", True)):
        hyps, mono, sec = evaluate(params, cfg, builder, eval_utts, tok,
                                   beam, early, device)
        hyp_by_mode[name] = hyps
        out[name] = {
            "ter_vs_ref": round(float(np.mean(
                [word_error_rate(h, r) for h, r in zip(hyps, refs)])), 4),
            "mean_tokens": round(float(np.mean(
                [len(h.split()) for h in hyps])), 2),
            "attn_monotonic_frac": round(mono, 4),
            # the host's wall a chunk after utterance 0, on this device
            "sec_per_chunk": round(sec, 4),
        }
    pa, es = hyp_by_mode["parity"], hyp_by_mode["early_stop"]
    out["samples"] = [{"ref": r, "parity": p, "early_stop": e}
                      for r, p, e in list(zip(refs, pa, es))[:3]]
    out["delta"] = {
        "ter_early_vs_parity": round(float(np.mean(
            [word_error_rate(e, p) for e, p in zip(es, pa)])), 4),
        "identical_utt_frac": round(float(np.mean(
            [e == p for e, p in zip(es, pa)])), 4),
        "ter_delta_vs_ref": round(
            out["early_stop"]["ter_vs_ref"] - out["parity"]["ter_vs_ref"], 4),
    }
    return out


def task(n_train, n_eval):
    """(cfg, tok, builder, words, train utterances, held-out utterances)
    of the copy task, from the JAX tool's seeds."""
    cfg = dryrun_config()
    tok = StubTokenizer(cfg.llama.vocab_size, lo=10, hi=900)
    builder = PromptBuilder(tok, cfg.tokens)
    words = content_words(tok)
    rng = np.random.RandomState(7)
    train_utts = [make_utt(tok, words, rng, k=int(rng.randint(1, 5)))
                  for _ in range(n_train)]
    # held-out sequences (word combinations unseen with p ~ 1 at 32^4)
    erng = np.random.RandomState(1234)
    eval_utts = [make_utt(tok, words, erng, k=4) for _ in range(n_eval)]
    return cfg, tok, builder, words, train_utts, eval_utts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--train-utts", type=int, default=500)
    ap.add_argument("--eval-utts", type=int, default=24)
    ap.add_argument("--beam", type=int, default=4)
    ap.add_argument("--workdir", default="/tmp/alignatt_quality")
    ap.add_argument("--json", default="")
    ap.add_argument("--save-params", default="",
                    help="pickle the trained params here after training")
    ap.add_argument("--load-params", default="",
                    help="skip training; unpickle params from this path")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = setup_device(args.device)
    cfg, tok, builder, _, train_utts, eval_utts = task(args.train_utts,
                                                       args.eval_utts)
    os.makedirs(args.workdir, exist_ok=True)
    write_split(args.workdir, "tr", train_utts)
    write_split(args.workdir, "dv",
                train_utts[: max(4, len(train_utts) // 10)])

    t0 = time.perf_counter()
    if args.load_params:
        trained = load_params(args.load_params, dev)
        losses, eval_curve = [float("nan"), float("nan")], []
        print(f"loaded params from {args.load_params}", flush=True)
    else:
        print(f"training {args.steps} steps on {args.train_utts} utts ...",
              flush=True)
        trained, losses, eval_curve = train(args.workdir, cfg, builder,
                                            args.steps, args.lr, dev)
        print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}", flush=True)
        if args.save_params:
            save_params(trained, args.save_params)
            print(f"saved params to {args.save_params}", flush=True)
    train_s = time.perf_counter() - t0

    result = {
        "task": "synthetic monotonic copy (32 words x 960ms signatures)",
        "model": "dryrun tiny speech-LLM (2L w2v2 frozen, 2L llama trained)",
        "train": (
            {"loaded": args.load_params} if args.load_params else {
                "steps": args.steps,
                "loss_first": round(losses[0], 4),
                "loss_final": round(losses[-1], 4),
                "loss_curve": [round(x, 4) for x in losses[:: max(
                    1, len(losses) // 40)]],
                "eval_loss_curve": eval_curve,
                "wall_s": round(train_s, 1),
            }
        ),
        "beam": args.beam,
        "eval_utts": args.eval_utts,
        "tf_content_acc_heldout": round(teacher_forced_acc(
            trained, cfg, builder, eval_utts, args.workdir, dev), 4),
        "trained": mode_rows(trained, cfg, builder, eval_utts, tok,
                             args.beam, dev),
        "random_control": mode_rows(init_params(cfg, dev), cfg, builder,
                                    eval_utts, tok, args.beam, dev),
        "caveat": (
            "tiny proxy on a synthetic copy task: bounds the early-stop "
            "winner-selection mechanism under concentrated monotonic "
            "attention, not MuST-C BLEU"
        ),
    }
    result["run"] = run_info(dev, t0)
    print(json.dumps(result, indent=1))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
        print(f"wrote {args.json}")
    return result


if __name__ == "__main__":
    main()
