"""Int8 fidelity probe on peaked logits: token-flip and beam-winner rates;
port of the root ``tools_quant_fidelity.py``.

A small Llama (D=256, I=512, L=4, V=512) is trained to convergence on a
fixed corpus, so its logits are peaked as a trained model's are; then
each quantization variant is held against the float32 reference, all
through the production decode path (``models/llama.decode_step`` ->
``models/quant.mm`` / ``mm_many`` -> the kernels on a card, their plain
versions on the CPU):

  - the teacher-forced argmax flip rate on the training corpus and on
    held-out (model-generated) text, with logit-error quantiles;
  - the first step where free-running greedy rollouts differ;
  - the beam-4 winner change rate (``decode/beam.beam_search``, whose
    steps run ``beam_attention``).

Variants: ``bf16`` (a cast), ``w8`` (weight-only int8, ``w8_bf16_gemm``),
``w8a8`` (``row_quant_int8`` + ``w8a8_gemm``, int8 lm_head), and the
grouped W8A8 variants (``group_quant_int8`` + ``w8a8_grouped_gemm``):
``w8a8_g128`` (groups of 128, grouped head), ``w8a8_g128_projonly``
(per-channel head), ``w8a8_8groups_like_g512`` (groups of 32) and the
two 32-group variants, groups of 8 (the grouped pair's simple route on a
card).  On the CPU every variant runs the kernels' plain versions.

Usage (``--device`` defaults to ``cuda``; ~1 min on an H100):
  python -m infinisst_tpu_torch.tools.quant_fidelity [--steps 600]
      [--json out.json] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.kernels import decode_attention as A
from infinisst_tpu_torch.kernels import quant_matmul as K
from infinisst_tpu_torch.models import llama as L
from infinisst_tpu_torch.models import quant as Q
from infinisst_tpu_torch.streaming.state import init_decoder_state
from infinisst_tpu_torch.train.step import adam, tree_leaves, tree_map

CFG = LlamaConfig(
    vocab_size=512, hidden_size=256, intermediate_size=512, num_layers=4,
    num_heads=4, num_kv_heads=4, head_dim=64, rope_scaling=False,
)
GREEDY_N = 32
BEAM_N = 24


def make_corpus(rng: np.random.RandomState, n_seq: int, S: int) -> np.ndarray:
    """Structured sequences (affine next-token rule + per-seq offset) —
    learnable, so the overfit model's logits become near-deterministic."""
    out = np.zeros((n_seq, S), np.int64)
    for b in range(n_seq):
        t = rng.randint(0, CFG.vocab_size)
        step = 3 + 2 * (b % 5)
        for s in range(S):
            out[b, s] = t
            t = (t * 1 + step + (7 if s % 4 == 0 else 0)) % CFG.vocab_size
    return out


def train(params, corpus: np.ndarray, steps: int):
    """Adam (optax.adam(3e-3)) on the next-token cross-entropy through
    ``llama.offline_forward``; every leaf trains.  Returns new float
    parameters on their device."""
    dev = params["embed"].device
    params = tree_map(lambda a: a.detach().clone().requires_grad_(True),
                      params)
    leaves = tree_leaves(params)
    ids = torch.as_tensor(corpus, device=dev)
    x, y = ids[:, :-1], ids[:, 1:]
    opt = adam(3e-3, len(leaves))
    state = opt.init(leaves)
    for i in range(steps):
        logits = L.offline_forward(params, CFG, L.embed(params, x))
        lp = torch.log_softmax(logits.to(torch.float32), dim=-1)
        loss = -lp.gather(-1, y[..., None])[..., 0].mean()
        state = opt.update(leaves, torch.autograd.grad(loss, leaves), state)
        if i % 100 == 0 or i == steps - 1:
            print(f"  train step {i}: loss {float(loss.detach()):.4f}",
                  file=sys.stderr)
    return tree_map(lambda a: a.detach(), params)


def _state(params, batch: int, capacity: int):
    emb = params["embed"]
    return init_decoder_state(CFG.num_layers, batch, capacity,
                              CFG.num_kv_heads, CFG.head_dim, emb.dtype,
                              emb.device)


@torch.no_grad()
def prefill_logits(params, ids: torch.Tensor) -> torch.Tensor:
    """Teacher-forced float32 logits over the whole (B, S) batch through
    ``decode_step`` (the production inference path, int8-aware through
    ``quant.mm``)."""
    B, S = ids.shape
    logits, _ = L.decode_step(params, CFG, _state(params, B, S),
                              L.embed(params, ids))
    return logits.to(torch.float32)


@torch.no_grad()
def greedy_rollout(params, prompt: torch.Tensor, n: int) -> list:
    """``n`` greedy tokens after ``prompt`` (P,): a prefill, then cached
    one-token steps."""
    st = _state(params, 1, prompt.shape[0] + n)
    lg, st = L.decode_step(params, CFG, st, L.embed(params, prompt[None]))
    toks = [torch.argmax(lg[0, -1, : CFG.vocab_size])]
    for _ in range(n - 1):
        lg, st = L.decode_step(params, CFG, st,
                               L.embed(params, toks[-1].reshape(1, 1)))
        toks.append(torch.argmax(lg[0, -1, : CFG.vocab_size]))
    return [int(t) for t in torch.stack(toks).tolist()]


@torch.no_grad()
def beam_winner(params, prompt: torch.Tensor, n: int) -> list:
    """The beam-4 winner of ``n`` new tokens after ``prompt`` (no EOS, no
    logits processors)."""
    spec = beam_mod.BeamSpec(
        beam=4, max_new_tokens=n, eos_id=-1, pad_id=0,
        no_repeat_ngram_size=0, repetition_penalty=1.0,
    )
    P = prompt.shape[0]
    st = _state(params, 1, P + n)
    lg, st = L.decode_step(params, CFG, st, L.embed(params, prompt[None]))
    res = beam_mod.beam_search(
        params, CFG, st, lg[0, -1, : CFG.vocab_size], prompt, P,
        torch.zeros((1,), dtype=torch.int64, device=prompt.device), 0, spec,
    )
    return list(res.tokens[: res.n_tokens])


def quant_variants(params):
    """name -> parameters of each variant."""
    n = CFG.hidden_size
    qlp = Q.quantize_llama_params
    out = {
        "bf16": tree_map(lambda a: a.to(torch.bfloat16)
                         if a.dtype == torch.float32 else a, params),
        "w8": qlp(params),
        "w8a8": qlp(params, quantize_lm_head=True, act_int8=True),
        "w8a8_g128": qlp(params, quantize_lm_head=True, act_int8=True,
                         group_size=128, head_group_size=128),
        # the deployed belt (bench --group128): grouped projections,
        # per-channel head
        "w8a8_g128_projonly": qlp(params, quantize_lm_head=True,
                                  act_int8=True, group_size=128),
        # group-COUNT analogues of the flagship belt modes (D=256 here):
        # 8 groups ~ --group-size 512, 32 groups ~ --group128
        "w8a8_8groups_like_g512": qlp(
            params, quantize_lm_head=True, act_int8=True, group_size=n // 8,
            head_group_size=n // 8),
        "w8a8_32groups_like_g128": qlp(
            params, quantize_lm_head=True, act_int8=True,
            group_size=n // 32, head_group_size=n // 32),
        "w8a8_32groups_projonly": qlp(
            params, quantize_lm_head=True, act_int8=True,
            group_size=n // 32),
    }
    return out


def _launches() -> dict:
    return {**K.launch_counts, **A.launch_counts}


def margin_stats(logits) -> dict:
    top2 = torch.topk(logits[..., : CFG.vocab_size], 2, dim=-1).values
    m = (top2[..., 0] - top2[..., 1]).cpu().numpy().ravel()
    return {"margin_p10": float(np.percentile(m, 10)),
            "margin_p50": float(np.percentile(m, 50))}


def probe(params, corpus: np.ndarray, steps: int) -> dict:
    """The variant table of float ``params`` trained ``steps`` steps on
    ``corpus`` (the JAX tool's results dict; on a card also each variant's
    kernel launches)."""
    dev = params["embed"].device
    V = CFG.vocab_size
    ids_train = torch.as_tensor(corpus, device=dev)
    ref_logits_train = prefill_logits(params, ids_train)
    # held-out on-distribution text: greedy rollouts from unseen prefixes
    held_prompts = [
        torch.as_tensor(make_corpus(np.random.RandomState(100 + i), 1, 8)[0],
                        device=dev)
        for i in range(6)
    ]
    ref_roll = [greedy_rollout(params, p, GREEDY_N) for p in held_prompts]
    ids_held = torch.stack([
        torch.cat([p, torch.as_tensor(r, device=dev)])
        for p, r in zip(held_prompts, ref_roll)
    ])
    ref_logits_held = prefill_logits(params, ids_held)
    ref_beam = [beam_winner(params, p, BEAM_N) for p in held_prompts]

    results = {
        "config": "llama D=256 I=512 L=4 V=512 f32-trained "
                  f"({steps} steps)",
        "train_margins": margin_stats(ref_logits_train),
        "held_margins": margin_stats(ref_logits_held),
        "variants": {},
    }
    on_card = dev.type == "cuda"
    if on_card:
        results["launches"] = {}
    for name, vp in quant_variants(params).items():
        before = _launches()
        row = {}
        for tag, ids, ref in (("train", ids_train, ref_logits_train),
                              ("held", ids_held, ref_logits_held)):
            ql = prefill_logits(vp, ids)
            ra = torch.argmax(ref[..., :V], -1)
            qa = torch.argmax(ql[..., :V], -1)
            flips = float((ra != qa).to(torch.float32).mean())
            err = (ql - ref)[..., :V].abs().cpu().numpy().ravel()
            row[f"{tag}_flip_rate"] = round(flips, 5)
            row[f"{tag}_dlogit_p50"] = round(float(np.percentile(err, 50)), 4)
            row[f"{tag}_dlogit_p99"] = round(float(np.percentile(err, 99)), 4)
        div = []
        for p, r in zip(held_prompts, ref_roll):
            qroll = greedy_rollout(vp, p, GREEDY_N)
            div.append(next((i for i, (a, b) in enumerate(zip(r, qroll))
                             if a != b), len(r)))
        row["greedy_first_divergence"] = div
        row["greedy_match_32"] = sum(d == GREEDY_N for d in div)
        bchange = sum(beam_winner(vp, p, BEAM_N) != r
                      for p, r in zip(held_prompts, ref_beam))
        row["beam4_winner_changed"] = f"{bchange}/{len(held_prompts)}"
        results["variants"][name] = row
        if on_card:
            after = _launches()
            results["launches"][name] = {k: after[k] - before[k]
                                         for k in after}
        print(f"{name}: {json.dumps(row)}", file=sys.stderr)
    return results


def main(argv=None):
    """Train, probe, print the results as JSON (and write them to
    ``--json``).  Returns (results, the trained float parameters)."""
    from infinisst_tpu_torch.core.device import resolve_device

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    if dev.type == "cuda":  # a float32 reference: no TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    corpus = make_corpus(np.random.RandomState(0), n_seq=8, S=64)
    params = L.init_params(CFG, torch.Generator(device=dev).manual_seed(0),
                           dev, torch.float32)
    print("training tiny llama to peak its logits...", file=sys.stderr)
    params = train(params, corpus, args.steps)
    results = probe(params, corpus, args.steps)
    print(json.dumps(results, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=2)
    return results, params


if __name__ == "__main__":
    main()
