"""Beam search for one chunk; port of the plain path of
``infinisst_tpu/decode/beam.py:beam_search``.

HF semantics, as in the JAX package:
- processors run on log-softmax scores in HF order (repetition penalty,
  no-repeat-ngram, encoder-no-repeat-ngram, suppress);
- each step takes the exact top 2*beam candidates (argmax + mask, so ties
  break toward the lower flat index) and EOS hypotheses do not consume
  live beam slots;
- finished hypotheses score sum_logprobs / generated_len**length_penalty;
- the loop stops early once the worst finished hypothesis cannot be
  beaten, and skips the forward of the final iteration.

The ``while_loop`` becomes a Python loop.  Scores stay float32 tensors;
the small per-step bookkeeping (2*beam candidates, the finished-hypothesis
slots) runs on the host with those float32 values, so comparisons match.
The attention probe and the ``return_kv`` variant are not ported.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.streaming.state import DecoderState

NEG_INF = -1e9


class BeamSpec(NamedTuple):
    beam: int
    max_new_tokens: int
    eos_id: int
    pad_id: int
    no_repeat_ngram_size: int = 0
    repetition_penalty: float = 1.0
    length_penalty: float = 1.0
    vocab_size: int = 0


class BeamResult(NamedTuple):
    tokens: List[int]  # (max_new,) winning generated tokens (pad-filled)
    n_tokens: int  # generated length (EOS excluded)
    score: float
    steps: int  # loop steps executed
    hit_eos: bool  # the winner ended with EOS
    attn_idx: List[int]  # (max_new,) -1: the attention probe is not ported


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _len_norm(length: int, length_penalty: float) -> torch.Tensor:
    return _f32(float(max(length, 1))) ** length_penalty


def select_candidates(step_scores: torch.Tensor, beam_scores: torch.Tensor):
    """Exact top-2B candidates over (B, V) processed log-probs by repeated
    argmax + mask (first index wins a tie, as ``jnp.argmax``).  Returns
    (total (B, V), top_vals (2B,), cand_beam (2B,), cand_tok (2B,))."""
    B, V = step_scores.shape
    total = step_scores + beam_scores[:, None]
    flat = total.reshape(-1).clone()
    vals, idxs = [], []
    for _ in range(2 * B):
        i = torch.argmax(flat)
        vals.append(flat[i].clone())
        idxs.append(i)
        flat[i] = NEG_INF
    top_vals = torch.stack(vals)
    top_idx = torch.stack(idxs)
    return total, top_vals, top_idx // V, top_idx % V


def finalize_winner(spec: BeamSpec, t: int, beam_scores: torch.Tensor,
                    fin_scores: List[float]):
    """HF finalize: the best live beam (normalised by generated length)
    against the best finished hypothesis.  Returns (best_live, best_fin,
    use_fin, live_score (B,) f32)."""
    live_score = beam_scores.cpu() / _len_norm(t, spec.length_penalty)
    ls = live_score.tolist()
    best_live = max(range(len(ls)), key=lambda i: (ls[i], -i))
    have_fin = sum(s > NEG_INF / 2 for s in fin_scores) > 0
    best_fin = max(range(len(fin_scores)), key=lambda i: (fin_scores[i], -i))
    use_fin = have_fin and fin_scores[best_fin] >= ls[best_live]
    return best_live, best_fin, use_fin, live_score


def beam_search(
    params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # batch 1: the cache after the chunk prefill
    first_logits: torch.Tensor,  # (V,) logits at the last prefill position
    prompt_buf: torch.Tensor,  # (Tp,) this call's prompt ids
    prompt_len: int,
    history: torch.Tensor,  # (Lh,) cross-chunk target ids
    history_len: int,
    spec: BeamSpec,
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,  # (V,) bool
    max_steps: Optional[int] = None,
) -> BeamResult:
    B, G = spec.beam, spec.max_new_tokens
    dev = first_logits.device
    V = first_logits.shape[-1]
    KV, Dh, L = cfg.num_kv_heads, cfg.head_dim, cfg.num_layers
    Tp = prompt_buf.shape[0]
    Tbuf = Tp + G
    max_steps = G if max_steps is None else int(max_steps)

    seq_buf = torch.cat([
        prompt_buf.to(torch.int64).to(dev),
        torch.full((G,), spec.pad_id, dtype=torch.int64, device=dev),
    ])[None].repeat(B, 1)
    seq_len = [int(prompt_len)] * B
    gen_tokens = [[spec.pad_id] * G for _ in range(B)]
    beam_scores = torch.full((B,), NEG_INF, dtype=torch.float32, device=dev)
    beam_scores[0] = 0.0
    gen_k = torch.zeros((L, B, G, KV, Dh), dtype=prefix.k.dtype, device=dev)
    gen_v = torch.zeros_like(gen_k)
    fin_tokens = [[spec.pad_id] * G for _ in range(B)]
    fin_len = [0] * B
    fin_scores = [float(_f32(NEG_INF))] * B
    hist = history.to(torch.int64).to(dev)[None].repeat(B, 1)
    hist_len = torch.full((B,), int(history_len), dtype=torch.int64,
                          device=dev)
    ar_buf = torch.arange(Tbuf, device=dev)[None]

    def process(scores, seq_len_t):
        scores = lp.repetition_penalty(
            scores, seq_buf, ar_buf < seq_len_t[:, None],
            spec.repetition_penalty,
        )
        scores = lp.no_repeat_ngram(
            scores, seq_buf, seq_len_t, spec.no_repeat_ngram_size
        )
        if encoder_ngram_size > 0:
            scores = lp.encoder_no_repeat_ngram(
                scores, hist, hist_len, seq_buf, seq_len_t,
                encoder_ngram_size,
            )
        if suppress_mask is not None:
            scores = lp.suppress_tokens(scores, suppress_mask)
        return scores

    t = 0
    done = False
    logits_cur = first_logits[None].expand(B, V)
    while not done and t < G:
        seq_len_t = torch.tensor(seq_len, dtype=torch.int64, device=dev)
        scores = torch.log_softmax(logits_cur.to(torch.float32), dim=-1)
        scores = process(scores, seq_len_t)
        _, cand_vals, cand_beam, cand_tok = select_candidates(
            scores, beam_scores
        )
        hyp_score = cand_vals / _len_norm(t + 1, spec.length_penalty).to(dev)
        vals = cand_vals.tolist()
        cb = cand_beam.tolist()
        ct = cand_tok.tolist()
        hs = hyp_score.tolist()
        is_eos = [tok == spec.eos_id for tok in ct]

        # finished hypotheses: EOS candidates among the top-B ranks only
        for i in range(2 * B):
            worst = min(range(B), key=lambda j: (fin_scores[j], j))
            if is_eos[i] and i < B and hs[i] > fin_scores[worst]:
                fin_tokens[worst] = list(gen_tokens[cb[i]])
                fin_len[worst] = t
                fin_scores[worst] = hs[i]

        # next live beams: the first B non-EOS candidates
        slots = [i for i in range(2 * B) if not is_eos[i]][:B]
        src = [cb[i] for i in slots]
        new_tok = [ct[i] for i in slots]
        beam_scores = cand_vals[torch.tensor(slots, device=dev)]
        src_t = torch.tensor(src, dtype=torch.int64, device=dev)
        seq_buf = seq_buf[src_t]
        seq_len = [seq_len[b] for b in src]
        gen_tokens = [list(gen_tokens[b]) for b in src]
        gen_k = gen_k[:, src_t]
        gen_v = gen_v[:, src_t]
        new_tok_t = torch.tensor(new_tok, dtype=torch.int64, device=dev)
        for b in range(B):
            gen_tokens[b][t] = new_tok[b]
        seq_buf[torch.arange(B, device=dev),
                torch.tensor(seq_len, device=dev)] = new_tok_t
        seq_len = [s + 1 for s in seq_len]

        t_next = t + 1
        n_fin = sum(s > NEG_INF / 2 for s in fin_scores)
        best_possible = float(
            _f32(max(vals[i] for i in slots))
            / _len_norm(t_next + 1, spec.length_penalty)
        )
        done_now = (
            t_next >= G or t_next >= max_steps
            or (n_fin >= B and min(fin_scores) >= best_possible)
        )
        if not done_now:
            x = llama_mod.embed(params, new_tok_t[:, None])
            logits_cur, gen_k, gen_v, _ = llama_mod.beam_token_step(
                params, cfg, prefix, gen_k, gen_v, t, x
            )
        t, done = t_next, done_now

    best_live, best_fin, use_fin, live_score = finalize_winner(
        spec, t, beam_scores, fin_scores
    )
    if use_fin:
        tokens, n_tokens, score = (fin_tokens[best_fin], fin_len[best_fin],
                                   fin_scores[best_fin])
    else:
        tokens, n_tokens, score = (gen_tokens[best_live], t,
                                   float(live_score[best_live]))
    return BeamResult(
        tokens=list(tokens), n_tokens=int(n_tokens), score=score, steps=t,
        hit_eos=bool(use_fin), attn_idx=[-1] * G,
    )
