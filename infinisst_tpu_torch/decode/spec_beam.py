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

JAX's formulation on the device: the loop's carry is ``SpecBeamLoop``,
static tensors updated in place, never rebound.  Transitions are the
beam step's own (``beam.candidates``, ``add_hyps``, ``next_beams``,
``reorder_append``, ``step_done``: HF BeamSearchScorer semantics, one
implementation of a beam step); the tree's mask, roots and positions
are tensor ops on the levels' source beams; the replay computes all k
levels and applies each under JAX's match masks (``pick``), so nothing
in a round waits on the host.  JAX's ``lax.cond`` skips the draft and
the verify when T0 ends the search; a graph cannot branch, so a round is
two pieces: ``spec_beam_anchor`` (T0, applied in place) and
``spec_beam_round`` (the draft, the tree verify, the replay and the
commit), with a host read of ``go`` after each: at most two reads a
round.  ``spec_beam_finish`` is JAX's finalize (``beam.finalize_winner``
on the device).  ``spec_beam_search`` drives the pieces eagerly; the
agent captures them (``agents/infinisst.py``).
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.core.graphs import put, read
from infinisst_tpu_torch.decode import beam as beam_mod
from infinisst_tpu_torch.decode.beam import NEG_INF, BeamSpec
from infinisst_tpu_torch.decode.speculative import (
    Draft,
    _shortlist_reenter,
    draft_of,
    pack_spec,
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
    """The beam state a transition reads and returns (one stream, a
    leading axis of 1 as ``beam.py``'s pool of P rows)."""

    scores: torch.Tensor  # (1, B) float32
    seq_buf: torch.Tensor  # (1, B, Tp + Gb) int64
    seq_len: torch.Tensor  # (1, B) int64
    gen: torch.Tensor  # (1, B, Gb) int64: generated tokens
    fin_tokens: torch.Tensor  # (1, B, Gb) int64
    fin_len: torch.Tensor  # (1, B) int64
    fin_scores: torch.Tensor  # (1, B) float32


class SpecBeamLoop(NamedTuple):
    """Static device buffers of one stream's speculative beam loop (JAX's
    ``while_loop`` carry), updated in place.  Generated buffers are G + k
    wide: the draft stages up to k levels past the cap."""

    t: torch.Tensor  # () int64: beam steps applied
    go: torch.Tensor  # () bool: the search goes on
    max_steps: torch.Tensor  # () int64
    logits: torch.Tensor  # (1, B, V) float32: the carried target logits
    beams: _Beams
    gen_k: torch.Tensor  # (L, B, Gb, KV, Dh) committed per-beam keys
    gen_v: torch.Tensor
    src0: torch.Tensor  # (B,) int64: T0's source beams (T to R)
    tok0: torch.Tensor  # (B,) int64: T0's tokens
    rounds: torch.Tensor  # () int64: verify forwards
    drafted: torch.Tensor  # () int64: drafted levels proposed
    accepted: torch.Tensor  # () int64: drafted levels accepted


def alloc_spec_beam(spec: BeamSpec, cfg: LlamaConfig, draft_k: int, V: int,
                    Tp: int, kv_heads: int, kv_dtype,
                    device) -> SpecBeamLoop:
    """The loop's buffers for ``spec`` at k = ``draft_k``, prompts of Tp
    ids and a vocabulary of V (``kv_heads``: the heads the cache
    holds)."""
    B, Gb = spec.beam, spec.max_new_tokens + draft_k
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    kv = (cfg.num_layers, B, Gb, kv_heads, cfg.head_dim)
    return SpecBeamLoop(
        t=torch.zeros((), **i64),
        go=torch.zeros((), dtype=torch.bool, device=device),
        max_steps=torch.zeros((), **i64),
        logits=torch.zeros((1, B, V), **f32),
        beams=_Beams(
            scores=torch.zeros((1, B), **f32),
            seq_buf=torch.zeros((1, B, Tp + Gb), **i64),
            seq_len=torch.zeros((1, B), **i64),
            gen=torch.zeros((1, B, Gb), **i64),
            fin_tokens=torch.zeros((1, B, Gb), **i64),
            fin_len=torch.zeros((1, B), **i64),
            fin_scores=torch.zeros((1, B), **f32)),
        gen_k=torch.zeros(kv, dtype=kv_dtype, device=device),
        gen_v=torch.zeros(kv, dtype=kv_dtype, device=device),
        src0=torch.zeros((B,), **i64),
        tok0=torch.zeros((B,), **i64),
        rounds=torch.zeros((), **i64),
        drafted=torch.zeros((), **i64),
        accepted=torch.zeros((), **i64),
    )


def start_spec_beam(loop: SpecBeamLoop, spec: BeamSpec,
                    first_logits: torch.Tensor, prompt_buf: torch.Tensor,
                    prompt_len, max_steps=None):
    """JAX's ``state0``, written into ``loop``: every beam holds the
    prompt, beam 0 scores 0 and the others -1e9.  first_logits (V,),
    prompt_buf (Tp,) int64; ``prompt_len`` and ``max_steps`` (None: G)
    ints or () tensors on the loop's device."""
    Tp = prompt_buf.shape[0]
    b = loop.beams
    loop.t.zero_()
    loop.go.fill_(True)
    for dst, x, default in ((loop.max_steps, max_steps,
                             spec.max_new_tokens),
                            (b.seq_len, prompt_len, 0)):
        if torch.is_tensor(x):
            dst.copy_(x.reshape(()).expand_as(dst))
        else:
            dst.fill_(default if x is None else x)
    loop.logits.copy_(first_logits.reshape(1, 1, -1).expand_as(loop.logits))
    b.scores.fill_(NEG_INF)
    b.scores[:, :1].zero_()
    b.seq_buf[:, :, :Tp].copy_(prompt_buf.expand(b.seq_buf.shape[:2] + (Tp,)))
    b.seq_buf[:, :, Tp:].fill_(spec.pad_id)
    b.gen.fill_(spec.pad_id)
    b.fin_tokens.fill_(spec.pad_id)
    b.fin_len.zero_()
    b.fin_scores.fill_(NEG_INF)
    for x in (loop.gen_k, loop.gen_v, loop.src0, loop.tok0, loop.rounds,
              loop.drafted, loop.accepted):
        x.zero_()


class _Ctx(NamedTuple):
    """What every transition of a search reads besides the beams."""

    spec: BeamSpec
    history: torch.Tensor  # (1, Lh) int64
    history_len: torch.Tensor  # (1,) int64
    encoder_ngram_size: int
    suppress_mask: Optional[torch.Tensor]
    max_steps: torch.Tensor  # () int64


def _transition(cx: _Ctx, logits, t, st: _Beams, force=None):
    """One beam step from (1, B, V) logits at step t (a () tensor): the
    beam step's candidates, add_hyp, next beams, reorder and append and
    termination (``force``: a given (source beams, tokens) selection,
    scored from these logits).  Returns (src (B,), tok (B,), the new
    beams, done ())."""
    spec = cx.spec
    total, vals, beams, toks = beam_mod.candidates(
        spec, logits, st.seq_buf, st.seq_len, st.scores, cx.history,
        cx.history_len, cx.encoder_ngram_size, cx.suppress_mask)
    live = torch.ones((1,), dtype=torch.bool, device=logits.device)
    (ft,), fl, fs, _ = beam_mod.add_hyps(
        spec, t, vals, beams, toks, live, st.fin_len, st.fin_scores,
        [(st.gen, st.fin_tokens)])
    scores, src, tok = beam_mod.next_beams(spec, vals, beams, toks)
    if force is not None:
        src, tok = force[0][None], force[1][None]
        V = total.shape[-1]
        scores = total.reshape(1, -1).gather(1, src * V + tok)
    sb, sl, gt = beam_mod.reorder_append(st.seq_buf, st.seq_len, st.gen,
                                         src, tok, t)
    done = beam_mod.step_done(spec, t + 1, scores, fs, cx.max_steps)[0]
    return src[0], tok[0], _Beams(scores, sb, sl, gt, ft, fl, fs), done


def _ctx(loop, spec, history, history_len, encoder_ngram_size,
         suppress_mask) -> _Ctx:
    return _Ctx(spec, history, history_len, encoder_ngram_size,
                suppress_mask, loop.max_steps)


def spec_beam_anchor(loop: SpecBeamLoop, spec: BeamSpec,
                     history: torch.Tensor, history_len: torch.Tensor,
                     encoder_ngram_size: int = 0,
                     suppress_mask: Optional[torch.Tensor] = None):
    """Piece T: the round's anchor transition T0 from the carried target
    logits, applied to the beams in place (its selection is the tree's
    level 0, so applied beams and tree nodes correspond by
    construction); t + 1; ``go``: T0 did not end the search, so the
    round drafts and verifies.  history (1, Lh), history_len (1,)."""
    cx = _ctx(loop, spec, history, history_len, encoder_ngram_size,
              suppress_mask)
    src, tok, st, done = _transition(cx, loop.logits, loop.t, loop.beams)
    put(loop.beams, st)
    loop.src0.copy_(src)
    loop.tok0.copy_(tok)
    loop.t.add_(1)
    loop.go.copy_(~done)


def spec_beam_round(loop: SpecBeamLoop, spec: BeamSpec, params,
                    cfg: LlamaConfig, prefix: DecoderState, draft: Draft,
                    history: torch.Tensor, history_len: torch.Tensor,
                    encoder_ngram_size: int = 0,
                    suppress_mask: Optional[torch.Tensor] = None,
                    accept_all: bool = False):
    """Piece R, after a T that did not end the search: the draft's
    transitions T1..Tk from the post-T0 beams (``beam_token_step`` on the
    first d layers over gathered copies of the committed K/V), the tree
    of (k+1) x B nodes (mask, roots, positions) and its ONE
    ``beam_tree_step``, the replay of T1..Tk from the target's logits
    (each level applied while every earlier one matched the draft's
    selection exactly), the commit of the applied nodes' K/V along each
    final beam's path, the carry, the counters and ``go``."""
    B, V = loop.logits.shape[1:]
    Gb = loop.beams.gen.shape[-1]
    k = Gb - spec.max_new_tokens
    d = draft.cfg.num_layers
    L = cfg.num_layers
    dev = loop.logits.device
    cx = _ctx(loop, spec, history, history_len, encoder_ngram_size,
              suppress_mask)
    t = loop.t - 1  # the round's first step (T applied it)
    src0, tok0 = loop.src0, loop.tok0
    st1 = loop.beams
    ar = torch.arange(B, device=dev)

    # the draft: T1..Tk on a throwaway copy of the post-T0 state
    prefix_d = DecoderState(k=prefix.k[:d], v=prefix.v[:d],
                            valid_len=prefix.valid_len)
    srcs, toks = [src0], [tok0]
    dst = st1
    dgk, dgv = loop.gen_k[:d], loop.gen_v[:d]
    cur_tok, cur_src = tok0, src0
    for s in range(1, k + 1):
        dgk, dgv = dgk.index_select(1, cur_src), dgv.index_select(1, cur_src)
        raw, dgk, dgv, _ = llama_mod.beam_token_step(
            draft.params, draft.cfg, prefix_d, dgk, dgv, t + s - 1,
            llama_mod.embed(draft.params, cur_tok[:, None]))
        dlg = _shortlist_reenter(raw, draft.head_ids, draft.head_prefix, V)
        cur_src, cur_tok, dst, _ = _transition(cx, dlg[None], t + s, dst)
        srcs.append(cur_src)
        toks.append(cur_tok)
    srcs_a = torch.stack(srcs)  # (k+1, B)
    toks_a = torch.stack(toks)

    # the tree: node n = s * B + b; its level-sp ancestor slot is
    # chain[sp], its committed root T0's source of the level-0 one
    rows, roots = [], []
    zero = torch.zeros((B, B), dtype=torch.bool, device=dev)
    for s in range(k + 1):
        chain = [ar] * (s + 1)
        cur = ar
        for sp in range(s, 0, -1):
            cur = srcs_a[sp].index_select(0, cur)
            chain[sp - 1] = cur
        rows.append(torch.cat([chain[sp][:, None] == ar[None] if sp <= s
                               else zero for sp in range(k + 1)], dim=1))
        roots.append(src0.index_select(0, chain[0]))
    tree_bias = torch.where(torch.cat(rows, dim=0), 0.0, NEG_INF).to(
        torch.float32)
    node_pos = (t + torch.arange(k + 1, device=dev)).repeat_interleave(B)
    lg_tree, k_tree, v_tree = llama_mod.beam_tree_step(
        params, cfg, prefix, loop.gen_k, loop.gen_v, t,
        llama_mod.embed(params, toks_a.reshape(-1)), node_pos, tree_bias,
        torch.cat(roots))
    KV, Dh = loop.gen_k.shape[3:]
    lg_tree = lg_tree.reshape(k + 1, B, V).to(torch.float32)
    k_tree = k_tree.reshape(L, k + 1, B, KV, Dh).to(loop.gen_k.dtype)
    v_tree = v_tree.reshape(L, k + 1, B, KV, Dh).to(loop.gen_v.dtype)

    # the replay: T1..Tk from the target's logits, applied while matched
    cur = st1
    done_c = torch.zeros((), dtype=torch.bool, device=dev)
    matched = torch.ones((), dtype=torch.bool, device=dev)
    n_r = torch.ones((), dtype=torch.int64, device=dev)
    # anc_fin[b, s]: the level-s tree slot on final slot b's path
    anc_fin = torch.zeros((B, k + 1), dtype=torch.int64, device=dev)
    anc_fin[:, 0] = ar
    root_fin = src0
    lg_carry = lg_tree[0]
    for s in range(1, k + 1):
        force = (srcs_a[s], toks_a[s]) if accept_all else None
        src_s, tok_s, new, dn = _transition(cx, lg_tree[s - 1][None],
                                            t + s, cur, force=force)
        match = matched
        if not accept_all:
            match = match & torch.all(src_s == srcs_a[s]) & torch.all(
                tok_s == toks_a[s])
        apply = match & ~done_c
        matched = match

        def pick(n, o):
            return torch.where(apply, n, o)

        cur = _Beams(*map(pick, new, cur))
        done_c = pick(dn, done_c)
        anc_s = anc_fin.index_select(0, src_s)
        anc_s[:, s] = ar
        anc_fin = pick(anc_s, anc_fin)
        root_fin = pick(root_fin.index_select(0, src_s), root_fin)
        lg_carry = pick(lg_tree[s], lg_carry)
        n_r = n_r + apply.to(torch.int64)

    # the commit: the committed K/V reordered by the final roots, the
    # applied nodes' K/V copied along each final beam's path (slot t + s)
    for buf, tree in ((loop.gen_k, k_tree), (loop.gen_v, v_tree)):
        g = buf.index_select(1, root_fin)
        for s in range(k + 1):
            at = (t + s).reshape(1)
            node = tree[:, s].index_select(1, anc_fin[:, s])  # (L, B, ...)
            g.index_copy_(2, at, torch.where(
                s < n_r, node, g.index_select(2, at)[:, :, 0])[:, :, None])
        buf.copy_(g)
    put(loop.beams, cur)
    loop.logits.copy_(lg_carry[None])
    loop.t.copy_(t + n_r)
    loop.rounds.add_(1)
    loop.drafted.add_(k)
    loop.accepted.add_(n_r - 1)
    loop.go.copy_(~done_c & (loop.t < spec.max_new_tokens))


def spec_beam_finish(loop: SpecBeamLoop, spec: BeamSpec) -> torch.Tensor:
    """Piece F's decode part: JAX's finalize (``beam.finalize_winner``:
    the best live beam at t steps against the best finished hypothesis),
    packed by ``speculative.pack_spec`` with [steps, score's float32 bits]
    after the counters."""
    G, b = spec.max_new_tokens, loop.beams
    best_live, best_fin, use_fin, live_score = beam_mod.finalize_winner(
        spec, loop.t, b.scores[0], b.fin_scores[0])
    bl, bf = best_live.reshape(1), best_fin.reshape(1)
    tokens = torch.where(use_fin, b.fin_tokens[0].index_select(0, bf)[0],
                         b.gen[0].index_select(0, bl)[0])[:G]
    n_tokens = torch.where(use_fin, b.fin_len[0].index_select(0, bf)[0],
                           loop.t)
    score = torch.where(use_fin, b.fin_scores[0].index_select(0, bf)[0],
                        live_score.index_select(0, bl)[0])
    return pack_spec(tokens, n_tokens, use_fin, loop.rounds, loop.drafted,
                     loop.accepted,
                     extra=(loop.t, score.to(torch.float32).view(torch.int32)))


def unpack_spec_beam(packed: list, G: int, offset: int = 0
                     ) -> SpecBeamResult:
    """The SpecBeamResult of ``spec_beam_finish``'s vector read to the
    host (from ``offset`` on)."""
    p = packed[offset:]
    score = struct.unpack("<f", struct.pack("<i", p[G + 6]))[0]
    return SpecBeamResult(tokens=list(p[2:2 + G]), n_tokens=p[0],
                          score=score, steps=p[G + 5], hit_eos=bool(p[1]),
                          rounds=p[G + 2], drafted=p[G + 3],
                          accepted=p[G + 4])


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
    """The device loop driven eagerly: {T, read ``go``, R, read ``go``}
    until the search ends, then the finish and one read of its packed
    result."""
    dev = first_logits.device
    i64 = dict(dtype=torch.int64, device=dev)
    loop = alloc_spec_beam(spec, cfg, draft_k, first_logits.shape[-1],
                           prompt_buf.shape[0], prefix.k.shape[3],
                           prefix.k.dtype, dev)
    start_spec_beam(loop, spec, first_logits.to(torch.float32),
                    prompt_buf.to(**i64), prompt_len, max_steps)
    draft = draft_of(params, cfg, draft_layers, draft_head, exit_adapter)
    hist = history.to(**i64)[None]
    hist_len = torch.as_tensor(history_len).to(**i64).reshape(1)
    ctx = (hist, hist_len, encoder_ngram_size, suppress_mask)
    while True:
        spec_beam_anchor(loop, spec, *ctx)
        if not read(loop.go):
            break
        spec_beam_round(loop, spec, params, cfg, prefix, draft, *ctx,
                        accept_all=accept_all)
        if not read(loop.go):
            break
    return unpack_spec_beam(read(spec_beam_finish(loop, spec)),
                            spec.max_new_tokens)
