"""Speculative beam search: a layer-skip draft and one tree verify a
round; port of ``infinisst_tpu/decode/spec_beam.py``.

A round applies the anchor transition T0 from the carried target logits,
drafts transitions T1..Tk with the target's first d layers on a
throwaway copy of the beam state (``beam_token_step`` over gathered
copies of the committed K/V, so the real buffers are never written),
verifies every (level, beam) node of the drafted tree in ONE
``llama.beam_tree_step``, then replays T1..Tk from the target's logits,
applying a level while the target's selection equals the draft's.  The
applied nodes' K/V are committed by copy (keys are unrotated).  The
winner is ``beam.beam_search``'s for any draft, up to float
associativity between the tree verify and the beam step.

Transitions are the beam step's: HF BeamSearchScorer semantics with
``beam.select_candidates`` and ``beam.finalize_winner``; the small
per-transition bookkeeping (2 * beam candidates, the finished
hypotheses, the tree) runs on the host, as in ``beam.py``.  A replay
stops at the first level it does not apply (the JAX unroll computes the
rest and applies none of it).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.decode.beam import (
    NEG_INF,
    BeamSpec,
    _f32,
    _len_norm,
    finalize_winner,
    select_candidates,
)
from infinisst_tpu_torch.decode.speculative import (
    _draft_setup,
    _shortlist_reenter,
)
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.streaming.state import DecoderState


class SpecBeamResult(NamedTuple):
    tokens: List[int]  # (G,) winning generated tokens (pad-filled)
    n_tokens: int  # EOS excluded
    score: float
    steps: int  # beam steps executed
    hit_eos: bool
    rounds: int  # verify forwards
    drafted: int  # drafted levels proposed
    accepted: int  # drafted levels accepted


class _Beams(NamedTuple):
    """The beam state a transition reads and returns (never mutated)."""
    scores: torch.Tensor  # (B,) float32
    seq_buf: torch.Tensor  # (B, Tbuf) int64
    seq_len: List[int]
    gen: List[List[int]]  # (B, Gb) generated tokens
    fin_tokens: List[List[int]]
    fin_len: List[int]
    fin_scores: List[float]


def spec_beam_search(
    params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # batch 1: the cache after the chunk prefill
    first_logits: torch.Tensor,  # (V,)
    prompt_buf: torch.Tensor,  # (Tp,)
    prompt_len: int,
    history: torch.Tensor,  # (Lh,)
    history_len: int,
    spec: BeamSpec,
    draft_layers: int,
    draft_k: int,
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,
    max_steps: Optional[int] = None,
    draft_head: Optional[dict] = None,
    exit_adapter: Optional[dict] = None,
    accept_all: bool = False,  # bench only: force the drafted levels
) -> SpecBeamResult:
    B, G, k, d = spec.beam, spec.max_new_tokens, draft_k, draft_layers
    V = first_logits.shape[-1]
    dev = first_logits.device
    i64 = dict(dtype=torch.int64, device=dev)
    KV, Dh, L = prefix.k.shape[3], cfg.head_dim, cfg.num_layers
    Gb = G + k  # the draft stages up to k levels past the cap
    params_d, cfg_d, head_ids, head_prefix = _draft_setup(
        params, cfg, d, draft_head, exit_adapter)
    prefix_d = DecoderState(k=prefix.k[:d], v=prefix.v[:d],
                            valid_len=prefix.valid_len)
    cap = G if max_steps is None else int(max_steps)
    hist = history.to(**i64)[None].repeat(B, 1)
    hist_len = torch.full((B,), int(history_len), **i64)
    neg = float(_f32(NEG_INF))

    def transition(logits, t_step, st: _Beams, force=None):
        """One beam step from (B, V) logits (``force``: a given (source
        beams, tokens) selection, scored from these logits).  Returns
        (src, tok, new state, done)."""
        scores = torch.log_softmax(logits.to(torch.float32), dim=-1)
        scores = lp.process_scores(
            scores, st.seq_buf, torch.tensor(st.seq_len, **i64),
            spec.repetition_penalty, spec.no_repeat_ngram_size, hist,
            hist_len, encoder_ngram_size, suppress_mask,
        )
        total, cand_vals, cand_beam, cand_tok = select_candidates(
            scores, st.scores)
        hyp = (cand_vals / _len_norm(t_step + 1, spec.length_penalty)
               .to(dev)).tolist()
        cb, ct = cand_beam.tolist(), cand_tok.tolist()
        ft, fl, fs = list(st.fin_tokens), list(st.fin_len), \
            list(st.fin_scores)
        for i in range(2 * B):
            worst = min(range(B), key=lambda j: (fs[j], j))
            if ct[i] == spec.eos_id and i < B and hyp[i] > fs[worst]:
                ft[worst] = list(st.gen[cb[i]])
                fl[worst] = t_step
                fs[worst] = hyp[i]
        slots = [i for i in range(2 * B) if ct[i] != spec.eos_id][:B]
        src = [cb[i] for i in slots]
        tok = [ct[i] for i in slots]
        if force is not None:
            src, tok = force
        src_t = torch.tensor(src, **i64)
        tok_t = torch.tensor(tok, **i64)
        new_scores = total[src_t, tok_t]
        seq_buf = st.seq_buf[src_t]
        seq_len = [st.seq_len[s] for s in src]
        seq_buf[torch.arange(B, device=dev),
                torch.tensor(seq_len, **i64)] = tok_t
        gen = [list(st.gen[s]) for s in src]
        for b in range(B):
            gen[b][t_step] = tok[b]
        t_next = t_step + 1
        n_fin = sum(s > NEG_INF / 2 for s in fs)
        best = float(new_scores.max().cpu()
                     / _len_norm(t_next + 1, spec.length_penalty))
        done = (t_next >= G or t_next >= cap
                or (n_fin >= B and min(fs) >= best))
        return src, tok, _Beams(new_scores, seq_buf,
                                [n + 1 for n in seq_len], gen, ft, fl,
                                fs), done

    Tbuf = prompt_buf.shape[0] + Gb
    seq_buf0 = torch.full((B, Tbuf), spec.pad_id, **i64)
    seq_buf0[:, : prompt_buf.shape[0]] = prompt_buf.to(**i64)
    scores0 = torch.full((B,), NEG_INF, dtype=torch.float32, device=dev)
    scores0[0] = 0.0
    st = _Beams(scores0, seq_buf0, [int(prompt_len)] * B,
                [[spec.pad_id] * Gb for _ in range(B)],
                [[spec.pad_id] * Gb for _ in range(B)], [0] * B, [neg] * B)
    gen_k = torch.zeros((L, B, Gb, KV, Dh), dtype=prefix.k.dtype,
                        device=dev)
    gen_v = torch.zeros_like(gen_k)
    logits_cur = first_logits[None].expand(B, V).to(torch.float32)
    t, done, rounds, drafted, accepted = 0, False, 0, 0, 0
    arange_b = np.arange(B)

    while not done and t < G:
        src0, tok0, st1, done1 = transition(logits_cur, t, st)
        if done1:  # T0 ended the search: no draft, no verify
            st, t, done = st1, t + 1, True
            break
        # the draft: T1..Tk on a throwaway copy of the post-T0 state
        srcs, toks = [src0], [tok0]
        dst = st1
        dgk, dgv = gen_k[:d], gen_v[:d]
        cur_tok, cur_src = tok0, src0
        for s in range(1, k + 1):
            sel = torch.tensor(cur_src, **i64)
            dgk, dgv = dgk[:, sel], dgv[:, sel]  # copies
            raw, dgk, dgv, _ = llama_mod.beam_token_step(
                params_d, cfg_d, prefix_d, dgk, dgv, t + s - 1,
                llama_mod.embed(params_d, torch.tensor(cur_tok, **i64)[
                    :, None]),
            )
            dlg = _shortlist_reenter(raw, head_ids, head_prefix, V)
            src_s, tok_s, dst, _ = transition(dlg, t + s, dst)
            srcs.append(src_s)
            toks.append(tok_s)
            cur_tok, cur_src = tok_s, src_s

        # the tree: node n = s * B + b; anc[s][sp] is the level-sp slot
        # on node (b, s)'s path
        N = (k + 1) * B
        mask = np.zeros((N, N), bool)
        root = np.zeros((N,), np.int64)
        node_pos = np.zeros((N,), np.int64)
        srcs_np = [np.asarray(x) for x in srcs]
        for s in range(k + 1):
            chain = {s: arange_b}
            cur = arange_b
            for sp in range(s, 0, -1):
                cur = srcs_np[sp][cur]
                chain[sp - 1] = cur
            for sp in range(s + 1):
                mask[s * B + arange_b, sp * B + chain[sp]] = True
            root[s * B: (s + 1) * B] = srcs_np[0][chain[0]]
            node_pos[s * B: (s + 1) * B] = t + s
        bias = torch.from_numpy(np.where(mask, 0.0, NEG_INF).astype(
            np.float32)).to(dev)
        x = llama_mod.embed(params, torch.tensor(
            [tok for level in toks for tok in level], **i64))
        lg_tree, k_tree, v_tree = llama_mod.beam_tree_step(
            params, cfg, prefix, gen_k, gen_v, t, x,
            torch.from_numpy(node_pos).to(dev), bias,
            torch.from_numpy(root).to(dev),
        )
        lg_tree = lg_tree.reshape(k + 1, B, V).to(torch.float32)
        k_tree = k_tree.reshape(L, k + 1, B, KV, Dh)
        v_tree = v_tree.reshape(L, k + 1, B, KV, Dh)

        # the replay: T1..Tk from the target's logits while they match
        cur_st, done_c, n_r = st1, done1, 1
        anc = np.zeros((B, k + 1), np.int64)
        anc[:, 0] = arange_b
        root_fin = np.asarray(src0)
        lg_carry = lg_tree[0]
        for s in range(1, k + 1):
            if done_c:
                break
            force = (srcs[s], toks[s]) if accept_all else None
            src_s, tok_s, new_st, dn = transition(
                lg_tree[s - 1], t + s, cur_st, force=force)
            if not accept_all and (src_s != srcs[s] or tok_s != toks[s]):
                break
            cur_st, done_c = new_st, dn
            anc = anc[np.asarray(src_s)]
            anc[:, s] = arange_b
            root_fin = root_fin[np.asarray(src_s)]
            lg_carry = lg_tree[s]
            n_r += 1

        # the commit: the committed K/V reordered by the final roots, the
        # applied nodes' K/V copied along each final beam's path
        sel = torch.from_numpy(root_fin).to(dev)
        gen_k, gen_v = gen_k[:, sel], gen_v[:, sel]
        lev = torch.arange(n_r, device=dev)[None]
        path = torch.from_numpy(anc[:, :n_r]).to(dev)
        gen_k[:, :, t: t + n_r] = k_tree[:, lev, path].to(gen_k.dtype)
        gen_v[:, :, t: t + n_r] = v_tree[:, lev, path].to(gen_v.dtype)
        st, done, logits_cur = cur_st, done_c, lg_carry
        t += n_r
        rounds += 1
        drafted += k
        accepted += n_r - 1

    best_live, best_fin, use_fin, live_score = finalize_winner(
        spec, t, st.scores, st.fin_scores)
    if use_fin:
        tokens, n_tokens, score = (st.fin_tokens[best_fin],
                                   st.fin_len[best_fin],
                                   st.fin_scores[best_fin])
    else:
        tokens, n_tokens, score = (st.gen[best_live], t,
                                   float(live_score[best_live]))
    return SpecBeamResult(
        tokens=list(tokens[:G]), n_tokens=int(n_tokens), score=score,
        steps=t, hit_eos=bool(use_fin), rounds=rounds, drafted=drafted,
        accepted=accepted,
    )
