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

One loop serves every beam path: JAX's ``while_loop`` carry, vmapped
over a pool of P streams, as static device tensors updated in place
(``BeamLoop``), by three functions: ``beam_select`` (one step's
bookkeeping for every row: processors, the top-2B candidates,
``add_hyp`` over them in tensor ops, the slot-to-candidate ``argmax``,
the reorder and append, each row's early stop; a row that is done keeps
its state frozen, as a vmapped ``while_loop`` lane does),
``beam_forward`` (one ``beam_token_step`` of the P * beam new tokens,
the weight stream shared by every slot and beam) and ``beam_finish``
(each row's finalize by ``argmax``).  The host reads one bool a step,
the pool-wide ``done``, and skips the forward of the final step, as
JAX's ``lax.cond`` does; ``pack_result`` packs the pool's results for
one more read.  The agent and the serving engine capture the three as
CUDA graphs (``agents/infinisst.py``, ``serve/engine.py``);
``beam_search`` (one stream, P = 1) and ``batched_beam_search`` drive
them eagerly.

The sampling decode (``sample_decode``, the do_sample path) is the same
kind of loop at beam 1 (``SampleLoop``): ``sample_select`` (the
processed scores, one draw, the EOS stop and the cap, the append,
``go``) and ``sample_forward`` (one ``beam_token_step``), one host read
of ``go`` a draw; the agent captures them (``agents/infinisst.py``).

The AlignAtt attention probe (``attn_probe``, ``first_attn_idx``,
``attn_stop_idx``) keeps each beam's trace of probed indices on the
device, reordered with the beams and snapshotted with a finished
hypothesis; the winner's trace is ``BeamResult.attn_idx``.  The early
stop ("every live beam has an in-zone token") is a device predicate on
that trace.  Without a probe the trace is not kept and ``attn_idx`` is
-1.  ``return_kv`` keeps a device snapshot of the source beam's K/V for
each finished hypothesis.
"""

from __future__ import annotations

import struct
from typing import List, NamedTuple, Optional

import torch

from infinisst_tpu_torch.core.graphs import read

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.parallel import collectives as par
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


def finalize_winner(spec: BeamSpec, t, beam_scores: torch.Tensor,
                    fin_scores):
    """HF finalize, JAX's, on the device over leading rows: the best
    live beam (normalised by its row's generated length ``t``, an int or
    an int tensor of the leading shape) against the best finished
    hypothesis, by ``argmax`` (the first of equal ones).  beam_scores and
    fin_scores (..., B).  Returns (best_live (...), best_fin (...),
    use_fin (...), live_score (..., B) float32)."""
    fs = torch.as_tensor(fin_scores, dtype=torch.float32,
                         device=beam_scores.device)
    n = torch.as_tensor(t, device=beam_scores.device)
    live_score = beam_scores / _pow_len(n, spec.length_penalty)[..., None]
    best_live = torch.argmax(live_score, dim=-1)
    best_fin = torch.argmax(fs, dim=-1)
    have_fin = torch.sum(fs > NEG_INF / 2, dim=-1) > 0
    use_fin = have_fin & (
        fs.gather(-1, best_fin[..., None])[..., 0]
        >= live_score.gather(-1, best_live[..., None])[..., 0])
    return best_live, best_fin, use_fin, live_score


def beam_search(
    params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # batch 1: the cache after the chunk prefill
    first_logits: torch.Tensor,  # (V,) logits at the last prefill position
    prompt_buf: torch.Tensor,  # (Tp,) this call's prompt ids
    prompt_len: int,
    history: torch.Tensor,  # (Lh,) cross-chunk target ids
    history_len,  # int or () tensor
    spec: BeamSpec,
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,  # (V,) bool
    max_steps: Optional[int] = None,
    return_kv: bool = False,
    attn_probe: Optional[tuple] = None,  # (layer, span_start, span_end)
    first_attn_idx: Optional[int] = None,  # the probe at the prefill
    attn_stop_idx: Optional[int] = None,  # the early-stop zone's start
) -> BeamResult:
    """Beam search for one stream: the device loop at P = 1, one host
    read a step (``done``) and one of the result."""
    def one(x):
        return None if x is None else [x]

    return batched_beam_search(
        params, cfg, prefix, first_logits[None], prompt_buf[None],
        [prompt_len], history[None], torch.as_tensor(history_len).reshape(1),
        spec, encoder_ngram_size=encoder_ngram_size,
        suppress_mask=suppress_mask, max_steps=one(max_steps),
        return_kv=return_kv, attn_probe=attn_probe,
        first_attn_idx=one(first_attn_idx), attn_stop_idx=one(attn_stop_idx),
    )[0]


def batched_beam_search(
    params,
    cfg: LlamaConfig,
    dec: DecoderState,  # P per-slot prefix caches after the prefill
    last_logits: torch.Tensor,  # (P, V)
    prompt_bufs: torch.Tensor,  # (P, Tp)
    prompt_lens,  # (P,) ints or tensor
    hists: torch.Tensor,  # (P, Lh)
    hist_lens,  # (P,) ints or tensor
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
    It runs the device loop (``BeamLoop``) eagerly: one host read of
    the pool-wide ``done`` a step and one of the packed result.

    ``attn_probe`` records, for every generated token, the probed index
    that produced it (the first token's is ``first_attn_idx``, -1 if
    None); with ``attn_stop_idx`` a slot is done once every one of its
    live beams holds an index >= its stop index.  Returns one BeamResult
    per slot (``kv_k``/``kv_v`` device views with ``return_kv``)."""
    P, V = last_logits.shape
    dev = last_logits.device
    i64 = dict(dtype=torch.int64, device=dev)

    def rows(x):
        return None if x is None else torch.as_tensor(x).to(**i64)

    loop = alloc_loop(spec, cfg, V, prompt_bufs.shape[1], dec.k.shape[3],
                      dec.k.dtype, dev, pool=P,
                      probe=attn_probe is not None, return_kv=return_kv)
    start_loop(loop, spec, last_logits.to(torch.float32),
               prompt_bufs.to(**i64), rows(prompt_lens),
               max_steps=rows(max_steps), first_attn_idx=rows(first_attn_idx),
               attn_stop_idx=rows(attn_stop_idx))
    hist, hist_len = hists.to(**i64), rows(hist_lens)
    beam_select(loop, spec, hist, hist_len, encoder_ngram_size,
                suppress_mask)
    while not read_done(loop):
        beam_forward(loop, params, cfg, dec, attn_probe)
        beam_select(loop, spec, hist, hist_len, encoder_ngram_size,
                    suppress_mask)
    out = beam_finish(loop, spec)
    packed = read(pack_result(out))
    res = [unpack_result(r, spec.max_new_tokens) for r in packed]
    if return_kv:
        res = [r._replace(kv_k=out.kv_k[:, p], kv_v=out.kv_v[:, p])
               for p, r in enumerate(res)]
    return res


# ---------------------------------------------------------------------------
# The device-resident loop of a pool of P streams (JAX's vmapped
# while_loop carry; one stream is P = 1)


class BeamLoop(NamedTuple):
    """Static device buffers of a pool's beam loop, updated in place (a
    CUDA graph replays on their addresses).  Rows are slot-major: the
    (P * B) axis of ``gen_k`` holds slot p's beams at p * B + b."""

    t: torch.Tensor  # () int64: steps taken by the live rows
    done: torch.Tensor  # () bool: every row of the pool is done
    row_done: torch.Tensor  # (P,) bool: a done row keeps its state frozen
    steps: torch.Tensor  # (P,) int64: each row's steps
    max_steps: torch.Tensor  # (P,) int64: each row's step cap (<= G)
    logits: torch.Tensor  # (P, B, V) float32: the next-token logits
    beam_scores: torch.Tensor  # (P, B) float32
    seq_buf: torch.Tensor  # (P, B, Tp + G) int64: prompt + generated ids
    seq_len: torch.Tensor  # (P, B) int64
    gen_tokens: torch.Tensor  # (P, B, G) int64
    new_tok: torch.Tensor  # (P, B) int64: the tokens the next forward takes
    gen_k: torch.Tensor  # (L, P * B, G, KV, Dh) generated-token keys
    gen_v: torch.Tensor
    fin_tokens: torch.Tensor  # (P, B, G) int64: finished hypotheses
    fin_len: torch.Tensor  # (P, B) int64
    fin_scores: torch.Tensor  # (P, B) float32
    # the AlignAtt probe (None without one): each beam's trace of probed
    # indices, reordered with the beams, and each finished hypothesis's
    attn_cur: Optional[torch.Tensor] = None  # (P, B) the last forward's
    attn_hist: Optional[torch.Tensor] = None  # (P, B, G) int64
    fin_attn: Optional[torch.Tensor] = None  # (P, B, G) int64
    stop_idx: Optional[torch.Tensor] = None  # (P,) the stop zone's start
    # return_kv (None without): each finished hypothesis's snapshot of
    # its source beam's K/V, slot-major as gen_k
    fin_k: Optional[torch.Tensor] = None
    fin_v: Optional[torch.Tensor] = None


# a stop index no probed index reaches (the early stop is off)
_NO_STOP = 2 ** 62


def alloc_loop(spec: BeamSpec, cfg: LlamaConfig, V: int, Tp: int,
               kv_heads: int, kv_dtype, device, pool: int = 1,
               probe: bool = False, return_kv: bool = False) -> BeamLoop:
    """The loop's buffers for ``spec`` over ``pool`` streams, prompts of
    Tp ids and a vocabulary of V (``kv_heads``: the heads the cache
    holds); ``probe`` keeps the AlignAtt traces, ``return_kv`` the
    finished hypotheses' K/V."""
    P, B, G = pool, spec.beam, spec.max_new_tokens
    i64 = dict(dtype=torch.int64, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    kv = (cfg.num_layers, P * B, G, kv_heads, cfg.head_dim)

    def kv_buf():
        return torch.zeros(kv, dtype=kv_dtype, device=device)

    return BeamLoop(
        t=torch.zeros((), **i64),
        done=torch.zeros((), dtype=torch.bool, device=device),
        row_done=torch.zeros((P,), dtype=torch.bool, device=device),
        steps=torch.zeros((P,), **i64),
        max_steps=torch.zeros((P,), **i64),
        logits=torch.zeros((P, B, V), **f32),
        beam_scores=torch.zeros((P, B), **f32),
        seq_buf=torch.zeros((P, B, Tp + G), **i64),
        seq_len=torch.zeros((P, B), **i64),
        gen_tokens=torch.zeros((P, B, G), **i64),
        new_tok=torch.zeros((P, B), **i64),
        gen_k=kv_buf(),
        gen_v=kv_buf(),
        fin_tokens=torch.zeros((P, B, G), **i64),
        fin_len=torch.zeros((P, B), **i64),
        fin_scores=torch.zeros((P, B), **f32),
        attn_cur=torch.zeros((P, B), **i64) if probe else None,
        attn_hist=torch.zeros((P, B, G), **i64) if probe else None,
        fin_attn=torch.zeros((P, B, G), **i64) if probe else None,
        stop_idx=torch.zeros((P,), **i64) if probe else None,
        fin_k=kv_buf() if return_kv else None,
        fin_v=kv_buf() if return_kv else None,
    )


def _fill(dst: torch.Tensor, x, default):
    """``dst`` (P, ...) set to ``x``: None (``default``), an int, or a
    (P,) tensor on dst's device broadcast over the trailing dims."""
    if x is None:
        dst.fill_(default)
    elif torch.is_tensor(x):
        dst.copy_(x.reshape(x.shape[:1] + (1,) * (dst.dim() - 1))
                  .expand_as(dst))
    else:
        dst.fill_(x)


def start_loop(loop: BeamLoop, spec: BeamSpec, first_logits: torch.Tensor,
               prompt_bufs: torch.Tensor, prompt_lens, max_steps=None,
               first_attn_idx=None, attn_stop_idx=None):
    """JAX's ``init`` carry of every row, written into ``loop``: every
    beam holds its row's prompt, beam 0 scores 0 and the others -1e9.
    first_logits (P, V), prompt_bufs (P, Tp); ``prompt_lens``,
    ``max_steps`` (None: G), ``first_attn_idx`` (None: -1) and
    ``attn_stop_idx`` (None: no early stop) are ints or (P,) tensors on
    the loop's device."""
    P, B = loop.beam_scores.shape
    Tp = prompt_bufs.shape[1]
    loop.t.zero_()
    loop.done.zero_()
    loop.row_done.zero_()
    loop.steps.zero_()
    _fill(loop.max_steps, max_steps, spec.max_new_tokens)
    loop.logits.copy_(first_logits[:, None].expand_as(loop.logits))
    loop.beam_scores.fill_(NEG_INF)
    loop.beam_scores[:, :1].zero_()
    loop.seq_buf[:, :, :Tp].copy_(prompt_bufs[:, None].expand(P, B, Tp))
    loop.seq_buf[:, :, Tp:].fill_(spec.pad_id)
    _fill(loop.seq_len, prompt_lens, 0)
    loop.gen_tokens.fill_(spec.pad_id)
    loop.new_tok.fill_(spec.pad_id)
    loop.gen_k.zero_()
    loop.gen_v.zero_()
    loop.fin_tokens.fill_(spec.pad_id)
    loop.fin_len.zero_()
    loop.fin_scores.fill_(NEG_INF)
    if loop.attn_cur is not None:
        _fill(loop.attn_cur, first_attn_idx, -1)
        loop.attn_hist.fill_(-1)
        loop.fin_attn.fill_(-1)
        _fill(loop.stop_idx, attn_stop_idx, _NO_STOP)
    if loop.fin_k is not None:
        loop.fin_k.zero_()
        loop.fin_v.zero_()


def _pow_len(n: torch.Tensor, length_penalty: float) -> torch.Tensor:
    """max(n, 1) ** length_penalty in float32, n an int tensor."""
    return torch.clamp(n.to(torch.float32), min=1.0) ** length_penalty


def _rows_of(x: torch.Tensor, beam_idx: torch.Tensor) -> torch.Tensor:
    """x (P, B, ...) at each row's beam ``beam_idx`` (P, K): (P, K, ...)."""
    idx = beam_idx.reshape(beam_idx.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(beam_idx.shape + x.shape[2:]))


def _flat_rows(beam_idx: torch.Tensor, B: int) -> torch.Tensor:
    """(P, K) or (P,) beam indices as indices into the slot-major P * B
    axis, flattened."""
    P = beam_idx.shape[0]
    base = torch.arange(P, device=beam_idx.device)[:, None] * B
    return (base + beam_idx.reshape(P, -1)).reshape(-1)


def candidates(spec: BeamSpec, logits: torch.Tensor, seq_buf, seq_len,
               beam_scores, history, history_len, encoder_ngram_size=0,
               suppress_mask=None):
    """A beam step's candidates for P rows: the processors on the
    log-softmax of logits (P, B, V) in HF order over each beam's
    seq_buf (P, B, T) / seq_len (P, B) and its row's history (P, Lh) /
    history_len (P,), then the exact top 2B.  Returns (total (P, B, V),
    cand_vals, cand_beam, cand_tok (P, 2B))."""
    P, B, V = logits.shape
    T = seq_buf.shape[-1]
    scores = torch.log_softmax(
        logits.reshape(P * B, V).to(torch.float32), dim=-1)
    scores = lp.process_scores(
        scores, seq_buf.reshape(P * B, T), seq_len.reshape(P * B),
        spec.repetition_penalty, spec.no_repeat_ngram_size,
        history[:, None].expand(P, B, history.shape[-1]).reshape(P * B, -1),
        history_len[:, None].expand(P, B).reshape(P * B),
        encoder_ngram_size, suppress_mask,
    )
    return select_candidates(scores.reshape(P, B, V), beam_scores)


def add_hyps(spec: BeamSpec, t, cand_vals, cand_beam, cand_tok, live,
             fin_len, fin_scores, snap):
    """JAX's ``add_hyp`` over the 2B candidates, in its order, as tensor
    ops: each EOS candidate among the top B ranks of a live row (live
    (P,)) replaces the worst finished slot (the first of equal ones) when
    strictly better, scored sum_logprobs / (t + 1) ** length_penalty.
    ``snap`` lists (per-beam buffer (P, B, ...), finished buffer (P, B,
    ...)) pairs: the replaced slot takes the candidate's source beam's
    row.  Returns (the finished buffers of ``snap``, fin_len, fin_scores,
    fin_src (P, B): each slot's newest source beam this step, -1: none)."""
    P, B = fin_scores.shape
    dev = fin_scores.device
    is_eos = cand_tok == spec.eos_id
    rank = torch.arange(2 * B, device=dev)
    eos_ok = is_eos & (rank < B)[None] & live[:, None]
    hyp_score = cand_vals / _pow_len(t + 1, spec.length_penalty)
    fins = [f for _, f in snap]
    fl, fs = fin_len, fin_scores
    fin_src = torch.full((P, B), -1, dtype=torch.int64, device=dev)
    slots = torch.arange(B, device=dev)
    for i in range(2 * B):
        worst = torch.argmin(fs, dim=1, keepdim=True)  # (P, 1)
        use = eos_ok[:, i:i + 1] & (hyp_score[:, i:i + 1]
                                    > torch.gather(fs, 1, worst))
        at = (slots[None] == worst) & use  # (P, B)
        src = cand_beam[:, i:i + 1]  # (P, 1)
        fins = [torch.where(at[..., None], _rows_of(b, src), f)
                for (b, _), f in zip(snap, fins)]
        fl = torch.where(at, t, fl)
        fs = torch.where(at, hyp_score[:, i:i + 1], fs)
        fin_src = torch.where(at, src, fin_src)
    return fins, fl, fs, fin_src


def next_beams(spec: BeamSpec, cand_vals, cand_beam, cand_tok):
    """The next live beams: the first B non-EOS candidates, slot to
    candidate by ``argmax``.  Returns (scores, source beams, tokens), (P,
    B) each."""
    B = cand_vals.shape[1] // 2
    slots = torch.arange(B, device=cand_vals.device)
    is_eos = cand_tok == spec.eos_id
    live_rank = torch.cumsum((~is_eos).to(torch.int64), dim=1) - 1
    cand_order = torch.where(~is_eos, live_rank, 2 * B)  # (P, 2B)
    slot_to_cand = torch.argmax(
        (cand_order[:, None, :] == slots[None, :, None]).to(torch.int64),
        dim=2)  # (P, B)
    return (torch.gather(cand_vals, 1, slot_to_cand),
            torch.gather(cand_beam, 1, slot_to_cand),
            torch.gather(cand_tok, 1, slot_to_cand))


def reorder_append(seq_buf, seq_len, gen_tokens, src, tok, t):
    """The per-beam buffers reordered by ``src`` (P, B), then ``tok`` (P,
    B) appended at each beam's seq_len and at generated slot t: (seq_buf
    (P, B, T), seq_len + 1 (P, B), gen_tokens (P, B, G)), new tensors."""
    P, B, T = seq_buf.shape
    G = gen_tokens.shape[-1]
    srow = _flat_rows(src, B)
    sb = seq_buf.reshape(P * B, T).index_select(0, srow)
    sl = seq_len.reshape(P * B).index_select(0, srow)
    gt = gen_tokens.reshape(P * B, G).index_select(0, srow)
    tk = tok.reshape(P * B, 1)
    gt.scatter_(1, torch.as_tensor(t).reshape(1, 1).expand(P * B, 1), tk)
    sb.scatter_(1, sl[:, None], tk)
    return sb.reshape(P, B, T), (sl + 1).reshape(P, B), gt.reshape(P, B, G)


def step_done(spec: BeamSpec, t_next, new_scores, fin_scores, max_steps):
    """Each row's termination before the forward of its next token: the
    cap, its step cap, or B finished hypotheses that no live beam can
    beat.  (P,) bool."""
    B = fin_scores.shape[1]
    n_fin = torch.sum(fin_scores > NEG_INF / 2, dim=1)
    best_possible = torch.max(new_scores, dim=1).values / _pow_len(
        t_next + 1, spec.length_penalty)
    return ((t_next >= spec.max_new_tokens) | (t_next >= max_steps)
            | ((n_fin >= B) & (torch.min(fin_scores, dim=1).values
                               >= best_possible)))


def beam_select(loop: BeamLoop, spec: BeamSpec, history: torch.Tensor,
                history_len: torch.Tensor, encoder_ngram_size: int = 0,
                suppress_mask: Optional[torch.Tensor] = None,
                over_data: bool = False):
    """One step of JAX's ``step_fn`` up to its forward, for every live
    row, in place: ``candidates``, ``add_hyps`` (the finished hypotheses,
    with the probe's traces and the K/V snapshots), ``next_beams``, the
    reorder and append, t + 1 and each row's ``done`` (``step_done``, or
    the AlignAtt early stop).  A row that is done keeps its state frozen,
    as a vmapped ``while_loop`` lane does; ``done`` is the whole pool's
    (over 'data' with ``over_data``).  history (P, Lh), history_len (P,)
    int64."""
    P, B = loop.beam_scores.shape
    G = spec.max_new_tokens
    T = loop.seq_buf.shape[-1]
    dev = loop.logits.device
    t = loop.t
    live = ~loop.row_done  # (P,)
    _, cand_vals, cand_beam, cand_tok = candidates(
        spec, loop.logits, loop.seq_buf, loop.seq_len, loop.beam_scores,
        history, history_len, encoder_ngram_size, suppress_mask)
    probing = loop.attn_hist is not None
    snap = [(loop.gen_tokens, loop.fin_tokens)]
    if probing:
        snap.append((loop.attn_hist, loop.fin_attn))
    fins, fl, fs, fin_src = add_hyps(spec, t, cand_vals, cand_beam,
                                     cand_tok, live, loop.fin_len,
                                     loop.fin_scores, snap)
    if loop.fin_k is not None:  # the pre-reorder source beam's K/V
        took = (fin_src >= 0).reshape(-1)[None, :, None, None, None]
        srow = _flat_rows(fin_src.clamp(min=0), B)
        loop.fin_k.copy_(torch.where(took, loop.gen_k.index_select(1, srow),
                                     loop.fin_k))
        loop.fin_v.copy_(torch.where(took, loop.gen_v.index_select(1, srow),
                                     loop.fin_v))
    new_scores, src, new_tok = next_beams(spec, cand_vals, cand_beam,
                                          cand_tok)

    # reorder the per-beam state (a done row maps to itself), then append
    live_b = live[:, None].expand(P, B)
    slots = torch.arange(B, device=dev)
    src = torch.where(live_b, src, slots[None])
    seq_buf, seq_len, gen_tokens = reorder_append(
        loop.seq_buf, loop.seq_len, loop.gen_tokens, src, new_tok, t)
    keep = ~live_b[..., None]
    loop.seq_buf.copy_(torch.where(keep, loop.seq_buf, seq_buf))
    loop.gen_tokens.copy_(torch.where(keep, loop.gen_tokens, gen_tokens))
    loop.seq_len.copy_(torch.where(live_b, seq_len, loop.seq_len))
    srow = _flat_rows(src, B)  # (P * B,)
    loop.gen_k.copy_(loop.gen_k.index_select(1, srow))
    loop.gen_v.copy_(loop.gen_v.index_select(1, srow))
    stop = torch.zeros((P,), dtype=torch.bool, device=dev)
    if probing:
        hist = loop.attn_hist.reshape(P * B, G).index_select(0, srow)
        cur = loop.attn_cur.reshape(P * B, 1).index_select(0, srow)
        hist.scatter_(1, t.reshape(1, 1).expand(P * B, 1), cur)
        hist = torch.where(keep.reshape(P * B, 1),
                           loop.attn_hist.reshape(P * B, G),
                           hist).reshape(P, B, G)
        loop.attn_hist.copy_(hist)
        # the AlignAtt early stop: every live beam has an in-zone token
        # (slots > t hold -1 and never match a non-negative stop index)
        stop = torch.all(torch.any(hist >= loop.stop_idx[:, None, None],
                                   dim=2), dim=1)
        loop.fin_attn.copy_(fins[1])

    # termination of each live row (before the forward of the next token)
    t_next = t + 1
    done_now = step_done(spec, t_next, new_scores, fs, loop.max_steps) | stop
    row_done = loop.row_done | done_now

    loop.fin_tokens.copy_(fins[0])
    loop.fin_len.copy_(fl)
    loop.fin_scores.copy_(fs)
    loop.beam_scores.copy_(torch.where(live_b, new_scores, loop.beam_scores))
    loop.new_tok.copy_(torch.where(live_b, new_tok, loop.new_tok))
    loop.steps.copy_(torch.where(live, t_next, loop.steps))
    loop.row_done.copy_(row_done)
    go = ~torch.all(row_done)
    if over_data:
        go = par.any_over_data_tensor(go)
    loop.done.copy_(~go)
    loop.t.copy_(t_next)


def beam_forward(loop: BeamLoop, params, cfg: LlamaConfig,
                 prefix: DecoderState, attn_probe: Optional[tuple] = None):
    """The forward of the step ``beam_select`` just took, for all P * B
    rows: the new tokens through ``beam_token_step`` at gen_len t - 1,
    their K/V written into the loop's buffers, the logits (and with the
    probe each row's probed index) into the loop."""
    P, B, V = loop.logits.shape
    x = llama_mod.embed(params, loop.new_tok.reshape(P * B, 1))
    logits, _, _, attn = llama_mod.beam_token_step(
        params, cfg, prefix, loop.gen_k, loop.gen_v, loop.t - 1, x,
        attn_probe=attn_probe)
    loop.logits.copy_(logits.reshape(P, B, V))
    if loop.attn_cur is not None:
        loop.attn_cur.copy_(attn.reshape(P, B))


def read_done(loop: BeamLoop) -> bool:
    """The loop's one host read a step (XLA's while_loop reads its
    predicate too)."""
    return bool(read(loop.done))


class BeamOut(NamedTuple):
    """``beam_finish``'s device tensors, one row a slot."""

    tokens: torch.Tensor  # (P, G) int64
    n_tokens: torch.Tensor  # (P,) int64
    score: torch.Tensor  # (P,) float32
    steps: torch.Tensor  # (P,) int64
    hit_eos: torch.Tensor  # (P,) bool
    attn_idx: torch.Tensor  # (P, G) int64 (-1 without the probe)
    kv_k: Optional[torch.Tensor] = None  # (L, P, G, KV, Dh) (return_kv)
    kv_v: Optional[torch.Tensor] = None


def beam_finish(loop: BeamLoop, spec: BeamSpec) -> BeamOut:
    """JAX's finalize for every row: the best live beam (normalised by
    the row's steps) against the best finished hypothesis, by
    ``argmax``."""
    B = loop.beam_scores.shape[1]
    best_live, best_fin, use_fin, live_score = finalize_winner(
        spec, loop.steps, loop.beam_scores, loop.fin_scores)
    best_live, best_fin = best_live[:, None], best_fin[:, None]  # (P, 1)
    fin_best = torch.gather(loop.fin_scores, 1, best_fin)[:, 0]
    live_best = torch.gather(live_score, 1, best_live)[:, 0]
    uf = use_fin[:, None]
    tokens = torch.where(uf, _rows_of(loop.fin_tokens, best_fin)[:, 0],
                         _rows_of(loop.gen_tokens, best_live)[:, 0])
    n_tokens = torch.where(use_fin, _rows_of(loop.fin_len, best_fin)[:, 0],
                           loop.steps)
    score = torch.where(use_fin, fin_best, live_best)
    if loop.attn_hist is not None:
        attn_idx = torch.where(uf, _rows_of(loop.fin_attn, best_fin)[:, 0],
                               _rows_of(loop.attn_hist, best_live)[:, 0])
    else:
        attn_idx = torch.full_like(tokens, -1)
    kv_k = kv_v = None
    if loop.fin_k is not None:
        fin_row = _flat_rows(best_fin, B)
        live_row = _flat_rows(best_live, B)
        ufk = use_fin[None, :, None, None, None]
        kv_k = torch.where(ufk, loop.fin_k.index_select(1, fin_row),
                           loop.gen_k.index_select(1, live_row))
        kv_v = torch.where(ufk, loop.fin_v.index_select(1, fin_row),
                           loop.gen_v.index_select(1, live_row))
    return BeamOut(tokens=tokens, n_tokens=n_tokens, score=score,
                   steps=loop.steps, hit_eos=use_fin, attn_idx=attn_idx,
                   kv_k=kv_k, kv_v=kv_v)


def pack_result(out: BeamOut, trace: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """One int32 row a slot, for one host read of the pool: [n_tokens,
    hit_eos, steps, score's float32 bits, tokens (G), attn_idx (G)],
    then ``trace`` (P, N), where given (the AlignAtt prefill's probes),
    which ``unpack_trace`` reads back."""
    head = torch.stack([out.n_tokens.to(torch.int32),
                        out.hit_eos.to(torch.int32),
                        out.steps.to(torch.int32),
                        out.score.to(torch.float32).view(torch.int32)],
                       dim=1)
    tail = [] if trace is None else [trace.to(torch.int32)]
    return torch.cat([head, out.tokens.to(torch.int32),
                      out.attn_idx.to(torch.int32)] + tail, dim=1)


def unpack_trace(packed: list, G: int, offset: int = 0) -> List[int]:
    """The ``trace`` columns of one ``pack_result`` row read to the host
    (from ``offset`` on)."""
    return list(packed[offset + 4 + 2 * G:])


def unpack_result(packed: list, G: int, offset: int = 0) -> BeamResult:
    """The BeamResult of one ``pack_result`` row read to the host (from
    ``offset`` on)."""
    p = packed[offset:]
    score = struct.unpack("<f", struct.pack("<i", p[3]))[0]
    return BeamResult(tokens=list(p[4:4 + G]), n_tokens=p[0], score=score,
                      steps=p[2], hit_eos=bool(p[1]),
                      attn_idx=list(p[4 + G:4 + 2 * G]))


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


class SampleLoop(NamedTuple):
    """Static device buffers of one stream's sampling loop (JAX's
    ``while_loop`` carry in ``sample_decode``), updated in place."""

    t: torch.Tensor  # () int64: draws made
    go: torch.Tensor  # () bool: the last draw is forwarded and drawn on
    n_tok: torch.Tensor  # () int64: tokens emitted
    hit_eos: torch.Tensor  # () bool
    logits: torch.Tensor  # (1, V) float32: the next draw's logits
    seq_buf: torch.Tensor  # (1, Tp + G) int64: prompt + generated ids
    seq_len: torch.Tensor  # (1,) int64
    tokens: torch.Tensor  # (G,) int64: the emitted tokens (pad-filled)
    nxt: torch.Tensor  # (1,) int64: the last draw
    gen_k: torch.Tensor  # (L, 1, G, KV, Dh) generated-token keys
    gen_v: torch.Tensor


def alloc_sample_loop(spec: SampleSpec, cfg: LlamaConfig, V: int, Tp: int,
                      kv_heads: int, kv_dtype, device) -> SampleLoop:
    """The sampling loop's buffers for prompts of Tp ids and a vocabulary
    of V (``kv_heads``: the heads the cache holds)."""
    G = spec.max_new_tokens
    i64 = dict(dtype=torch.int64, device=device)
    kv = (cfg.num_layers, 1, G, kv_heads, cfg.head_dim)
    return SampleLoop(
        t=torch.zeros((), **i64),
        go=torch.zeros((), dtype=torch.bool, device=device),
        n_tok=torch.zeros((), **i64),
        hit_eos=torch.zeros((), dtype=torch.bool, device=device),
        logits=torch.zeros((1, V), dtype=torch.float32, device=device),
        seq_buf=torch.zeros((1, Tp + G), **i64),
        seq_len=torch.zeros((1,), **i64),
        tokens=torch.zeros((G,), **i64),
        nxt=torch.zeros((1,), **i64),
        gen_k=torch.zeros(kv, dtype=kv_dtype, device=device),
        gen_v=torch.zeros(kv, dtype=kv_dtype, device=device),
    )


def start_sample(loop: SampleLoop, spec: SampleSpec,
                 first_logits: torch.Tensor, prompt_buf: torch.Tensor,
                 prompt_len):
    """JAX's ``init`` carry, written into ``loop``: first_logits (V,),
    prompt_buf (Tp,) and ``prompt_len`` an int or a () tensor on the
    loop's device."""
    Tp = prompt_buf.shape[0]
    loop.t.zero_()
    loop.go.fill_(True)
    loop.n_tok.zero_()
    loop.hit_eos.zero_()
    loop.logits.copy_(first_logits.reshape(loop.logits.shape))
    loop.seq_buf[0, :Tp].copy_(prompt_buf)
    loop.seq_buf[0, Tp:].fill_(spec.pad_id)
    _fill(loop.seq_len, prompt_len.reshape(1) if torch.is_tensor(prompt_len)
          else prompt_len, 0)
    loop.tokens.fill_(spec.pad_id)
    loop.nxt.fill_(spec.pad_id)
    loop.gen_k.zero_()
    loop.gen_v.zero_()


def sample_select(loop: SampleLoop, spec: SampleSpec, history: torch.Tensor,
                  history_len: torch.Tensor, generator: torch.Generator,
                  encoder_ngram_size: int = 0,
                  suppress_mask: Optional[torch.Tensor] = None):
    """One step of JAX's ``step_fn`` up to its forward, in place (run
    only while ``go``): the processed scores (``logits.sample_scores``),
    one draw from ``generator``, the EOS stop, the append and t + 1;
    ``go``: the draw is no EOS and the cap is not reached, so it is
    forwarded and drawn on.  history (1, Lh), history_len (1,) int64."""
    G = spec.max_new_tokens
    scores = lp.sample_scores(loop.logits, loop.seq_buf, loop.seq_len, spec,
                              history, history_len, encoder_ngram_size,
                              suppress_mask)
    nxt = lp.categorical(scores, generator)  # (1,)
    is_eos = nxt == spec.eos_id
    emit = ~is_eos
    at = loop.t.reshape(1)
    loop.tokens.index_copy_(0, at, torch.where(
        emit, nxt, loop.tokens.index_select(0, at)))
    loop.seq_buf.scatter_(1, loop.seq_len[:, None], torch.where(
        emit, nxt, loop.seq_buf.gather(1, loop.seq_len[:, None])[:, 0]
    )[:, None])
    loop.seq_len.add_(emit)
    loop.n_tok.add_(emit[0])
    loop.hit_eos.copy_(is_eos[0])
    loop.t.add_(1)
    loop.nxt.copy_(nxt)
    loop.go.copy_(emit[0] & (loop.t < G))


def sample_forward(loop: SampleLoop, params, cfg: LlamaConfig,
                   prefix: DecoderState):
    """The forward of the draw ``sample_select`` just made: one
    ``beam_token_step`` at beam 1 over the shared prefix at gen_len
    t - 1, its K/V into the loop's buffers, its logits into the loop."""
    logits, _, _, _ = llama_mod.beam_token_step(
        params, cfg, prefix, loop.gen_k, loop.gen_v, loop.t - 1,
        llama_mod.embed(params, loop.nxt[:, None]))
    loop.logits.copy_(logits)


def sample_out(loop: SampleLoop) -> BeamOut:
    """The loop's result as ``beam_finish``'s one-row tensors (score 0,
    no probe), for ``pack_result``."""
    return BeamOut(tokens=loop.tokens[None], n_tokens=loop.n_tok.reshape(1),
                   score=torch.zeros((1,), dtype=torch.float32,
                                     device=loop.t.device),
                   steps=loop.t.reshape(1), hit_eos=loop.hit_eos.reshape(1),
                   attn_idx=torch.full_like(loop.tokens[None], -1))


def sample_decode(
    params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # batch 1: the cache after the chunk prefill
    first_logits: torch.Tensor,  # (V,)
    prompt_buf: torch.Tensor,  # (Tp,)
    prompt_len: int,
    history: torch.Tensor,  # (Lh,)
    history_len,  # int or () tensor
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
    draw is not forwarded.  It runs the device loop (``SampleLoop``)
    eagerly: one host read of ``go`` a step and one of the packed
    result."""
    dev = first_logits.device
    i64 = dict(dtype=torch.int64, device=dev)
    loop = alloc_sample_loop(spec, cfg, first_logits.shape[-1],
                             prompt_buf.shape[0], prefix.k.shape[3],
                             prefix.k.dtype, dev)
    start_sample(loop, spec, first_logits.to(torch.float32),
                 prompt_buf.to(**i64), prompt_len)
    hist = history.to(**i64)[None]
    hist_len = torch.as_tensor(history_len).to(**i64).reshape(1)
    while True:
        sample_select(loop, spec, hist, hist_len, generator,
                      encoder_ngram_size, suppress_mask)
        if not read(loop.go):
            break
        sample_forward(loop, params, cfg, prefix)
    return unpack_result(read(pack_result(sample_out(loop)))[0],
                         spec.max_new_tokens)
