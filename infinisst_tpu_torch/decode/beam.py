"""Beam search for one chunk; port of the plain path of
``infinisst_tpu/decode/beam.py``: ``beam_search`` (one stream) and
``batched_beam_search`` (a pool of streams, one prefix cache each).

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
One pooled loop serves both entry points: every step forwards all
P * beam rows through one ``beam_token_step`` (the weight stream shared by
every slot and beam, as JAX's vmap forwards every lane), while a slot that
is done keeps its state frozen.  The loop ends when every slot is done,
without the forward of that last step (its logits would be unused).

The AlignAtt attention probe (``attn_probe``, ``first_attn_idx``,
``attn_stop_idx``) keeps each beam's trace of probed indices, reordered
with the beams and snapshotted with a finished hypothesis; the winner's
trace is ``BeamResult.attn_idx``.  The early stop ("every live beam has
an in-zone token") is a host check on that trace.  Without a probe the
trace is not kept and ``attn_idx`` is -1.
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
    attn_idx: List[int]  # (max_new,) the winner's probe trace (-1: none)
    # return_kv: the winner's generated-token K/V (L, max_new, KV, Dh),
    # unrotated; the first n_emit slots are valid (n_emit = n_tokens with
    # EOS, else n_tokens - 1: the EOS and a cap-dropped final token are
    # never forwarded)
    kv_k: Optional[torch.Tensor] = None
    kv_v: Optional[torch.Tensor] = None


def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def _len_norm(length: int, length_penalty: float) -> torch.Tensor:
    return _f32(float(max(length, 1))) ** length_penalty


def select_candidates(step_scores: torch.Tensor, beam_scores: torch.Tensor):
    """Exact top-2B candidates over (..., B, V) processed log-probs, per
    leading index (one slot of a pool), by repeated argmax + mask (first
    index wins a tie, as ``jnp.argmax``).  Returns (total (..., B, V),
    top_vals (..., 2B), cand_beam (..., 2B), cand_tok (..., 2B))."""
    B, V = step_scores.shape[-2:]
    total = step_scores + beam_scores[..., None]
    flat = total.reshape(total.shape[:-2] + (B * V,)).clone()
    vals, idxs = [], []
    for _ in range(2 * B):
        i = torch.argmax(flat, dim=-1, keepdim=True)
        vals.append(flat.gather(-1, i))
        idxs.append(i)
        flat.scatter_(-1, i, NEG_INF)
    top_vals = torch.cat(vals, dim=-1)
    top_idx = torch.cat(idxs, dim=-1)
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
    return_kv: bool = False,
    attn_probe: Optional[tuple] = None,  # (layer, span_start, span_end)
    first_attn_idx: Optional[int] = None,  # the probe at the prefill
    attn_stop_idx: Optional[int] = None,  # the early-stop zone's start
) -> BeamResult:
    """Beam search for one stream: ``batched_beam_search`` over a pool of
    one."""
    def one(x):
        return None if x is None else [x]

    return batched_beam_search(
        params, cfg, prefix, first_logits[None], prompt_buf[None],
        [prompt_len], history[None], [history_len], spec,
        encoder_ngram_size=encoder_ngram_size, suppress_mask=suppress_mask,
        max_steps=one(max_steps), return_kv=return_kv,
        attn_probe=attn_probe, first_attn_idx=one(first_attn_idx),
        attn_stop_idx=one(attn_stop_idx),
    )[0]


def _ints(x) -> List[int]:
    return [int(v) for v in torch.as_tensor(x).tolist()]


def batched_beam_search(
    params,
    cfg: LlamaConfig,
    dec: DecoderState,  # P per-slot prefix caches after the prefill
    last_logits: torch.Tensor,  # (P, V)
    prompt_bufs: torch.Tensor,  # (P, Tp)
    prompt_lens,  # (P,) ints
    hists: torch.Tensor,  # (P, Lh)
    hist_lens,  # (P,) ints
    spec: BeamSpec,
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,  # (V,) bool
    max_steps=None,  # (P,) per-slot step caps <= max_new_tokens
    return_kv: bool = False,
    attn_probe: Optional[tuple] = None,  # (layer, span_start, span_end)
    first_attn_idx=None,  # (P,) the probe at each slot's prefill
    attn_stop_idx=None,  # (P,) each slot's early-stop zone (needs a probe)
) -> List[BeamResult]:
    """Beam search for a pool of independent streams (pooled serving):
    each slot keeps its own prefix cache and (beam, G) generation buffer,
    and the per-token forward runs at P * beam rows.  Inactive slots
    should pass max_steps 1 so that they cannot keep the loop alive.

    ``attn_probe`` records, for every generated token, the probed index
    that produced it (the first token's is ``first_attn_idx``, -1 if
    None); with ``attn_stop_idx`` a slot is done once every one of its
    live beams holds an index >= its stop index.  Returns one BeamResult
    per slot."""
    B, G = spec.beam, spec.max_new_tokens
    P, V = last_logits.shape
    rows = P * B
    dev = last_logits.device
    # the KV heads the cache holds (KV / n_model under tensor parallelism)
    KV, Dh, L = dec.k.shape[3], cfg.head_dim, cfg.num_layers
    caps = [G] * P if max_steps is None else _ints(max_steps)

    seq_buf = torch.cat([
        prompt_bufs.to(device=dev, dtype=torch.int64),
        torch.full((P, G), spec.pad_id, dtype=torch.int64, device=dev),
    ], dim=1).repeat_interleave(B, dim=0)  # (rows, Tbuf)
    seq_len = [n for n in _ints(prompt_lens) for _ in range(B)]
    gen_tokens = [[spec.pad_id] * G for _ in range(rows)]
    beam_scores = torch.full((P, B), NEG_INF, dtype=torch.float32,
                             device=dev)
    beam_scores[:, 0] = 0.0
    beam_scores = beam_scores.reshape(rows)
    gen_k = torch.zeros((L, rows, G, KV, Dh), dtype=dec.k.dtype, device=dev)
    gen_v = torch.zeros_like(gen_k)
    neg = float(_f32(NEG_INF))
    fin_tokens = [[[spec.pad_id] * G for _ in range(B)] for _ in range(P)]
    fin_len = [[0] * B for _ in range(P)]
    fin_scores = [[neg] * B for _ in range(P)]
    if return_kv:  # per-hypothesis snapshots of the source beam's K/V
        fin_k = torch.zeros((P, B) + gen_k.shape[:1] + gen_k.shape[2:],
                            dtype=gen_k.dtype, device=dev)
        fin_v = torch.zeros_like(fin_k)
    hist = hists.to(device=dev, dtype=torch.int64).repeat_interleave(B, 0)
    hist_len = torch.tensor(_ints(hist_lens), dtype=torch.int64,
                            device=dev).repeat_interleave(B)
    probing = attn_probe is not None
    if probing:  # each row's trace, and each finished hypothesis'
        first = [-1] * P if first_attn_idx is None else _ints(first_attn_idx)
        attn_cur = [first[r // B] for r in range(rows)]
        attn_hist = [[-1] * G for _ in range(rows)]
        fin_attn = [[[-1] * G for _ in range(B)] for _ in range(P)]
        stops = None if attn_stop_idx is None else _ints(attn_stop_idx)
    # every live slot has generated t tokens; a done slot keeps its own
    t = 0
    steps = [0] * P
    live = [True] * P
    logits_cur = last_logits.repeat_interleave(B, dim=0)  # (rows, V)
    while any(live):
        seq_len_t = torch.tensor(seq_len, dtype=torch.int64, device=dev)
        scores = torch.log_softmax(logits_cur.to(torch.float32), dim=-1)
        scores = lp.process_scores(
            scores, seq_buf, seq_len_t, spec.repetition_penalty,
            spec.no_repeat_ngram_size, hist, hist_len, encoder_ngram_size,
            suppress_mask,
        )
        # exact top-2B candidates of each slot, all slots at once
        _, cand_vals, cand_beam, cand_tok = select_candidates(
            scores.reshape(P, B, V), beam_scores.reshape(P, B))
        hyp_score = cand_vals / _len_norm(t + 1, spec.length_penalty).to(dev)
        vals_h = cand_vals.tolist()  # (P, 2B)
        cb_h, ct_h = cand_beam.tolist(), cand_tok.tolist()
        hs_h = hyp_score.tolist()
        if probing and torch.is_tensor(attn_cur):
            attn_cur = attn_cur.tolist()  # the last forward's probes

        perm = list(range(rows))  # source row of each row after the step
        new_tok = [spec.pad_id] * rows
        new_scores = []  # (row, candidate) of each live beam's new score
        for p in range(P):
            if not live[p]:
                continue
            cb, ct = cb_h[p], ct_h[p]
            is_eos = [tok == spec.eos_id for tok in ct]
            fs = fin_scores[p]
            # finished hypotheses: EOS candidates among the top-B ranks
            for i in range(2 * B):
                worst = min(range(B), key=lambda j: (fs[j], j))
                if is_eos[i] and i < B and hs_h[p][i] > fs[worst]:
                    src = p * B + cb[i]
                    fin_tokens[p][worst] = list(gen_tokens[src])
                    fin_len[p][worst] = t
                    fs[worst] = hs_h[p][i]
                    if probing:
                        fin_attn[p][worst] = list(attn_hist[src])
                    if return_kv:  # the pre-reorder source beam
                        fin_k[p, worst] = gen_k[:, src]
                        fin_v[p, worst] = gen_v[:, src]
            # next live beams: the first B non-EOS candidates
            slots = [i for i in range(2 * B) if not is_eos[i]][:B]
            for b, i in enumerate(slots):
                perm[p * B + b] = p * B + cb[i]
                new_tok[p * B + b] = ct[i]
                new_scores.append((p * B + b, p * 2 * B + i))
            t_next = t + 1
            n_fin = sum(s > NEG_INF / 2 for s in fs)
            best_possible = float(
                _f32(max(vals_h[p][i] for i in slots))
                / _len_norm(t_next + 1, spec.length_penalty)
            )
            steps[p] = t_next
            live[p] = not (
                t_next >= G or t_next >= caps[p]
                or (n_fin >= B and min(fs) >= best_possible)
            )

        # reorder the per-beam state (a done slot's rows map to themselves)
        dst = torch.tensor([r for r, _ in new_scores], device=dev)
        src_c = torch.tensor([c for _, c in new_scores], device=dev)
        beam_scores = beam_scores.clone()
        beam_scores[dst] = cand_vals.reshape(-1)[src_c]
        perm_t = torch.tensor(perm, dtype=torch.int64, device=dev)
        seq_buf = seq_buf[perm_t]
        gen_k = gen_k[:, perm_t]
        gen_v = gen_v[:, perm_t]
        new_seq_len = list(seq_len)
        new_gen = list(gen_tokens)
        for r, _ in new_scores:
            new_seq_len[r] = seq_len[perm[r]]
            new_gen[r] = list(gen_tokens[perm[r]])
            new_gen[r][t] = new_tok[r]
        seq_len, gen_tokens = new_seq_len, new_gen
        if probing:
            new_hist = list(attn_hist)
            for r, _ in new_scores:
                new_hist[r] = list(attn_hist[perm[r]])
                new_hist[r][t] = attn_cur[perm[r]]
            attn_hist = new_hist
            if stops is not None:
                # the early stop: every live beam has an in-zone token
                for p in {r // B for r, _ in new_scores}:
                    if all(any(a >= stops[p] for a in attn_hist[r])
                           for r in range(p * B, (p + 1) * B)):
                        live[p] = False
        moved = [r for r, _ in new_scores]
        moved_t = torch.tensor(moved, dtype=torch.int64, device=dev)
        seq_buf[moved_t, torch.tensor([seq_len[r] for r in moved],
                                      device=dev)] = torch.tensor(
            [new_tok[r] for r in moved], dtype=torch.int64, device=dev)
        for r in moved:
            seq_len[r] += 1

        if any(live):
            x = llama_mod.embed(params, torch.tensor(
                new_tok, dtype=torch.int64, device=dev)[:, None])
            logits_cur, gen_k, gen_v, attn_cur_t = llama_mod.beam_token_step(
                params, cfg, dec, gen_k, gen_v, t, x, attn_probe=attn_probe
            )
            if probing:
                attn_cur = attn_cur_t
        t += 1

    out = []
    for p in range(P):
        best_live, best_fin, use_fin, live_score = finalize_winner(
            spec, steps[p], beam_scores[p * B:(p + 1) * B], fin_scores[p]
        )
        if use_fin:
            tokens, n_tokens, score = (fin_tokens[p][best_fin],
                                       fin_len[p][best_fin],
                                       fin_scores[p][best_fin])
        else:
            tokens, n_tokens, score = (gen_tokens[p * B + best_live],
                                       steps[p], float(live_score[best_live]))
        attn_idx = [-1] * G
        if probing:
            attn_idx = list(fin_attn[p][best_fin] if use_fin
                            else attn_hist[p * B + best_live])
        kv_k = kv_v = None
        if return_kv:
            if use_fin:
                kv_k, kv_v = fin_k[p, best_fin], fin_v[p, best_fin]
            else:
                kv_k = gen_k[:, p * B + best_live]
                kv_v = gen_v[:, p * B + best_live]
        out.append(BeamResult(
            tokens=list(tokens), n_tokens=int(n_tokens), score=score,
            steps=steps[p], hit_eos=bool(use_fin), attn_idx=attn_idx,
            kv_k=kv_k, kv_v=kv_v,
        ))
    return out


# ---------------------------------------------------------------------------
# Sampling decode (the do_sample path)


class SampleSpec(NamedTuple):
    max_new_tokens: int
    eos_id: int
    pad_id: int
    temperature: float = 1.0
    top_p: float = 1.0
    top_k: int = 0
    epsilon_cutoff: float = 0.0
    no_repeat_ngram_size: int = 0
    repetition_penalty: float = 1.0


def sample_decode(
    params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # batch 1: the cache after the chunk prefill
    first_logits: torch.Tensor,  # (V,)
    prompt_buf: torch.Tensor,  # (Tp,)
    prompt_len: int,
    history: torch.Tensor,  # (Lh,)
    history_len: int,
    spec: SampleSpec,
    generator: torch.Generator,
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,
) -> BeamResult:
    """Single-sequence ancestral sampling (port of the JAX
    ``sample_decode``): each step draws from the processed scores
    (``logits.sample_scores``: temperature, the beam path's processors,
    top-k, top-p, epsilon) with ``generator``, and forwards the drawn
    token through ``beam_token_step`` at beam 1 over the shared prefix.
    Stops at EOS (not emitted) or after max_new_tokens draws; the last
    draw is not forwarded."""
    G = spec.max_new_tokens
    dev = first_logits.device
    KV, Dh, L = prefix.k.shape[3], cfg.head_dim, cfg.num_layers
    i64 = dict(dtype=torch.int64, device=dev)
    seq_buf = torch.cat([prompt_buf.to(**i64),
                         torch.full((G,), spec.pad_id, **i64)])[None]
    seq_len = int(prompt_len)
    hist = history.to(**i64)[None]
    hist_len = torch.tensor([int(history_len)], **i64)
    gen_k = torch.zeros((L, 1, G, KV, Dh), dtype=prefix.k.dtype, device=dev)
    gen_v = torch.zeros_like(gen_k)
    tokens = [spec.pad_id] * G
    n_tok, hit_eos, t = 0, False, 0
    logits_cur = first_logits[None]
    while t < G:
        scores = lp.sample_scores(
            logits_cur, seq_buf, torch.tensor([seq_len], **i64), spec, hist,
            hist_len, encoder_ngram_size, suppress_mask,
        )
        nxt = lp.categorical(scores, generator)  # (1,)
        tok = int(nxt[0])
        if tok == spec.eos_id:
            hit_eos = True
            t += 1
            break
        tokens[t] = tok
        seq_buf[0, seq_len] = tok
        seq_len += 1
        n_tok += 1
        if t + 1 < G:
            logits_cur, gen_k, gen_v, _ = llama_mod.beam_token_step(
                params, cfg, prefix, gen_k, gen_v, t,
                llama_mod.embed(params, nxt[:, None]),
            )
        t += 1
    return BeamResult(tokens=tokens, n_tokens=n_tok, score=0.0, steps=t,
                      hit_eos=hit_eos, attn_idx=[-1] * G)
