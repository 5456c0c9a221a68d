"""Self-speculative greedy and sampling decode: a layer-skip draft and a
k-token verify; port of ``infinisst_tpu/decode/speculative.py``.

The draft is the target's own first ``draft_layers`` layers, its final
norm and an lm_head (the full one, a shortlist of vocabulary columns, or
low-rank factors), optionally with a distilled exit adapter
(``train/draft.py``).  A round drafts k tokens with k one-token
``decode_step`` calls on the first d layers, then verifies all k+1
(the anchor and the drafts) in ONE ``decode_step`` of the full model
with a ``valid_mask``, and emits the longest prefix the full model
agrees with.  Greedy is token-exact against sequential processed greedy
for any draft; sampling (the rejection scheme) is exact in distribution
against ``beam.sample_decode``.  Accepted tokens' K/V commit during the
verify.

JAX's ``while_loop`` is a device loop with static state: its carry is
``SpecLoop``, static tensors updated in place (never rebound), and a
round is ``spec_round``, one function with no host decision inside (k is
static), so the agent and the serving engine capture a whole round as
one CUDA graph and the host reads ``go`` (some row of the pool, or'ed
over 'data' on the device, is still live) once a round
(``agents/infinisst.py``, ``serve/engine.py``);
``batched_speculative_greedy`` and ``batched_speculative_sample`` drive
the same functions eagerly.  Every per-round rule (the emission, the EOS
and cap rules, the masked scatters) is the JAX one, on tensors.  The
caches are written in place: the verify appends the k+1 tokens' K/V at
valid_len and the round adds the emitted count to ``valid_len`` in
place; the draft's appends land in the main cache's first d layers at
valid_len onwards, where the verify overwrites them, except at a full
cache, where a clamped draft write could land on the committed slot
C - 1.  That slot of the first d layers is saved before the draft and
restored after it, so the committed K/V equal the JAX decoder's, whose
draft works on a copy.  Every random draw of the sampling decoders
comes from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.core.graphs import read
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models.quant import KMAJOR
from infinisst_tpu_torch.parallel import collectives as par
from infinisst_tpu_torch.streaming.state import DecoderState


class SpecSpec(NamedTuple):
    max_new_tokens: int
    eos_id: int
    pad_id: int
    draft_layers: int  # d: the draft is the first d layers + a head
    draft_k: int  # tokens drafted (and verified) a round
    no_repeat_ngram_size: int = 0
    repetition_penalty: float = 1.0
    accept_all: bool = False  # bench only: accept every draft token (the
    # output is then the draft's, not greedy's)


class SpecSampleSpec(NamedTuple):
    max_new_tokens: int
    eos_id: int
    pad_id: int
    draft_layers: int
    draft_k: int
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    epsilon_cutoff: float = 0.0
    no_repeat_ngram_size: int = 0
    repetition_penalty: float = 1.0


class SpecResult(NamedTuple):
    tokens: list  # (G,) emitted tokens (pad-filled)
    n_tokens: int  # EOS excluded
    hit_eos: bool
    rounds: int  # verify forwards
    drafted: int  # draft tokens proposed
    accepted: int  # draft tokens accepted
    dec: Optional[DecoderState]  # the cache with the emitted tokens
    # committed (None from a packed result)


def _nbytes(tree) -> float:
    """The bytes of the leaves, a 'data' shard counted whole."""
    if torch.is_tensor(tree):
        n = par.data_size() if par.data_dim(tree) is not None else 1
        return float(tree.numel() * tree.element_size() * n)
    if isinstance(tree, dict):
        return sum(_nbytes(v) for v in tree.values())
    return 0.0


def breakeven_tokens_per_round(llama_params, num_layers: int,
                               draft_layers: int, draft_k: int,
                               draft_head=None, exit_adapter=None) -> float:
    """Tokens a verify round must emit for speculation to beat plain
    decode, from the weight-stream byte model: a round streams k draft
    steps (the first d layers, the draft's head and adapter) and one full
    forward, plain decode the full model once a token, so speculation
    wins iff tokens_per_round > 1 + k * draft_step_bytes / full_bytes.
    Counts the bytes of the parameter leaves (the embedding, a gather,
    left out), which K-major packing does not change, so the value is
    the JAX package's for the same model."""
    layer_bytes = _nbytes(llama_params["layers"]) / num_layers
    head_bytes = _nbytes(draft_head if draft_head is not None
                         else llama_params["lm_head"])
    adapter_bytes = _nbytes(exit_adapter) if exit_adapter is not None \
        else 0.0
    draft_step = draft_layers * layer_bytes + head_bytes + adapter_bytes
    full = _nbytes({k: v for k, v in llama_params.items() if k != "embed"})
    return 1.0 + draft_k * draft_step / full


def make_draft_head(lm_head, head_vocab: int, ids=None):
    """A draft-only lm_head over ``head_vocab`` vocabulary columns (a
    shortlist): the ids 0..head_vocab-1 by default (BPE ids are roughly
    frequency-ordered), else ``ids``.  A float head (D, V) is sliced to
    (D, head_vocab); an int8 leaf (K-major (V, D), its scale (V,) or
    grouped (G, V)) keeps those out-channels with their scales, padded to
    a multiple of 512 with zero weights and scales, as the JAX package
    pads its columns.  Returns {'w': head, 'prefix': ids} for the default
    shortlist (its scores re-enter the vocabulary as a pad), or {'w':
    head, 'ids': ids} (re-entered by a scatter); ids are int32, as the
    JAX package keeps them, so the break-even counts the same bytes."""
    dev = (lm_head[KMAJOR] if isinstance(lm_head, dict) else lm_head).device
    prefix = ids is None
    if prefix:
        ids = torch.arange(head_vocab, dtype=torch.int32, device=dev)
    else:
        ids = torch.as_tensor(np.asarray(ids), device=dev).to(torch.int32)
        if tuple(ids.shape) != (head_vocab,):
            raise ValueError(
                f"shortlist ids have shape {tuple(ids.shape)}, need exactly "
                f"({head_vocab},): is the ids file shorter than the "
                "requested head_vocab?")
    sel = ids.to(torch.int64)
    if isinstance(lm_head, dict):
        pad = ((head_vocab + 511) // 512) * 512 - head_vocab
        skey = "scale_a8" if "scale_a8" in lm_head else "scale"
        q = lm_head[KMAJOR].index_select(-2, sel)
        s = lm_head[skey].index_select(-1, sel)
        w = {KMAJOR: torch.nn.functional.pad(q, (0, 0, 0, pad)).contiguous(),
             skey: torch.nn.functional.pad(s, (0, pad)).contiguous()}
    else:
        w = lm_head.index_select(-1, sel).contiguous()
    return {"w": w, ("prefix" if prefix else "ids"): ids}


class Draft(NamedTuple):
    """The draft's leaves and head (``draft_of``)."""

    params: dict  # the first d layers (views), the head, the adapter
    cfg: LlamaConfig  # num_layers d, the head's vocabulary
    head_ids: Optional[torch.Tensor]  # a shortlist's ids (None: full)
    head_prefix: bool  # the shortlist is the id prefix


def draft_of(params, cfg: LlamaConfig, d: int, draft_head=None,
             exit_adapter=None) -> Draft:
    """The draft of the first d layers (views of the stacked leaves), the
    exit adapter (None: none), and the full (``draft_head`` None),
    shortlist or low-rank head."""
    params_d = {
        "embed": params["embed"],
        "layers": {k: ({kk: vv[:d] for kk, vv in v.items()}
                       if isinstance(v, dict)
                       else par.layer_slice(v, slice(None, d)))
                   for k, v in params["layers"].items()},
        "final_ln": params["final_ln"],
        "lm_head": params["lm_head"],
    }
    if exit_adapter is not None:
        params_d["exit_adapter"] = exit_adapter
    head_ids, head_prefix = None, False
    vocab = cfg.vocab_size
    if draft_head is not None:
        # 'prefix': pad re-entry, 'ids': scatter re-entry, neither: a
        # full-vocabulary replacement head (low-rank factors)
        head_prefix = "prefix" in draft_head
        head_ids = draft_head.get("prefix", draft_head.get("ids"))
        if head_ids is not None:
            vocab = head_ids.shape[0]
        params_d["lm_head"] = draft_head["w"]
    cfg_d = dataclasses.replace(cfg, num_layers=d, vocab_size=vocab)
    return Draft(params_d, cfg_d, head_ids, head_prefix)


def _shortlist_reenter(lg_last, head_ids, head_prefix: bool, V: int):
    """The draft's (B, Vs) shortlist scores in vocabulary space (B, V):
    off-shortlist ids at -inf, below every processed score, so the draft
    never proposes one."""
    if head_ids is None:
        return lg_last[:, :V]
    B, Vs = lg_last.shape
    if head_prefix:
        return torch.nn.functional.pad(lg_last, (0, V - Vs),
                                       value=float("-inf"))
    out = torch.full((B, V), float("-inf"), dtype=lg_last.dtype,
                     device=lg_last.device)
    out[:, head_ids.to(torch.int64)] = lg_last
    return out


def dequant_head(lm_head) -> np.ndarray:
    """Any lm_head layout -> dense float32 numpy (D, V) on the host: a
    float tensor, or a K-major int8 leaf with a per-channel (V,) or
    grouped (G, V) scale (pad columns carry zero scales and come out
    zero)."""
    if not isinstance(lm_head, dict):
        return lm_head.detach().to("cpu", torch.float32).numpy()
    q = lm_head[KMAJOR].detach().cpu().numpy().T.astype(np.float32)
    s = lm_head.get("scale_a8", lm_head.get("scale"))
    s = s.detach().to("cpu", torch.float32).numpy()
    if s.ndim == 1:
        return q * s[None, :]
    G, V = s.shape
    D = q.shape[0]
    return (q.reshape(G, D // G, V) * s[:, None, :]).reshape(D, V)


def make_lowrank_draft_head(lm_head, rank: int, dtype=None):
    """A draft-only low-rank lm_head W ~= A @ B, A (D, r), B (r, V): the
    best rank-r factors (the top-r eigenvectors U of W W^T: A = U,
    B = U^T W), computed on the host in float32 numpy from
    ``dequant_head``, as the JAX package computes them.  Returns {'w':
    {'a', 'b'}} on the head's device, in ``dtype`` (default bf16 for an
    int8 head, else the head's)."""
    w = dequant_head(lm_head)
    D = w.shape[0]
    if not 0 < rank <= D:
        raise ValueError(f"rank must be in (0, {D}], got {rank}")
    _, evecs = np.linalg.eigh(w @ w.T)  # ascending eigenvalues
    u = evecs[:, -rank:]
    ref = lm_head[KMAJOR] if isinstance(lm_head, dict) else lm_head
    dt = dtype or (torch.bfloat16 if isinstance(lm_head, dict)
                   else lm_head.dtype)
    return {"w": {"a": torch.as_tensor(u, device=ref.device).to(dt),
                  "b": torch.as_tensor(u.T @ w, device=ref.device).to(dt)}}


# ---------------------------------------------------------------------------
# The decoders: JAX's while_loop carry of a pool of B rows as static device
# tensors updated in place (one stream is B = 1)


class SpecLoop(NamedTuple):
    """Static device buffers of a pool's speculative loop (JAX's
    ``while_loop`` carry), updated in place, never rebound (a CUDA graph
    replays on their addresses).  The cache is the caller's: the verify
    appends its K/V in place and each round adds the emitted count to
    its ``valid_len`` in place."""

    go: torch.Tensor  # () bool: some row of the pool (over 'data') is live
    rounds: torch.Tensor  # () int64: verify forwards
    logits: torch.Tensor  # (B, V) float32: the carried target logits
    seq_buf: torch.Tensor  # (B, Tp + G + k) int64: prompt + emitted ids
    seq_len: torch.Tensor  # (B,) int64
    tokens: torch.Tensor  # (B, G) int64: emitted tokens (pad-filled)
    n_out: torch.Tensor  # (B,) int64: EOS excluded
    done: torch.Tensor  # (B,) bool
    hit_eos: torch.Tensor  # (B,) bool
    act: torch.Tensor  # (B,) bool: inactive rows emit nothing
    row_max_new: torch.Tensor  # (B,) int64: each row's cap (<= G)
    drafted: torch.Tensor  # (B,) int64: draft tokens proposed
    accepted: torch.Tensor  # (B,) int64: draft tokens accepted
    # the sampler's carry (None for greedy): the rejected draft's q and
    # whether the last round rejected
    c_q: Optional[torch.Tensor] = None  # (B, V) float32
    c_rej: Optional[torch.Tensor] = None  # (B,) bool


def alloc_spec(spec, B: int, V: int, Tp: int, device) -> SpecLoop:
    """The loop's buffers for ``spec`` (a ``SpecSpec``, or a
    ``SpecSampleSpec``: the sampler's carry too) over B rows, prompts of
    Tp ids and a vocabulary of V."""
    G, k = spec.max_new_tokens, spec.draft_k
    i64 = dict(dtype=torch.int64, device=device)
    b = dict(dtype=torch.bool, device=device)
    sample = isinstance(spec, SpecSampleSpec)
    return SpecLoop(
        go=torch.zeros((), **b),
        rounds=torch.zeros((), **i64),
        logits=torch.zeros((B, V), dtype=torch.float32, device=device),
        # +k slack: near the cap a round stages k+1 tokens before the cap
        # truncates the commit
        seq_buf=torch.zeros((B, Tp + G + k), **i64),
        seq_len=torch.zeros((B,), **i64),
        tokens=torch.zeros((B, G), **i64),
        n_out=torch.zeros((B,), **i64),
        done=torch.zeros((B,), **b),
        hit_eos=torch.zeros((B,), **b),
        act=torch.zeros((B,), **b),
        row_max_new=torch.zeros((B,), **i64),
        drafted=torch.zeros((B,), **i64),
        accepted=torch.zeros((B,), **i64),
        c_q=(torch.zeros((B, V), dtype=torch.float32, device=device)
             if sample else None),
        c_rej=torch.zeros((B,), **b) if sample else None,
    )


def start_spec(loop: SpecLoop, spec, first_logits: torch.Tensor,
               ids: torch.Tensor, prompt_lens, row_active=None,
               row_max_new=None):
    """JAX's ``state0``, written into ``loop``: first_logits (B, V), ids
    (B, Tp) int64; ``prompt_lens`` an int or a (B,) int64 tensor,
    ``row_active`` a (B,) bool tensor (None: every row), ``row_max_new``
    a (B,) int64 tensor (None: G), bound to G; inactive rows start done.
    ``go``: some row of the pool (over 'data') is live."""
    Tp = ids.shape[1]
    loop.logits.copy_(first_logits)
    loop.seq_buf[:, :Tp].copy_(ids)
    loop.seq_buf[:, Tp:].fill_(spec.pad_id)
    if torch.is_tensor(prompt_lens):
        loop.seq_len.copy_(prompt_lens)
    else:
        loop.seq_len.fill_(prompt_lens)
    loop.tokens.fill_(spec.pad_id)
    loop.n_out.zero_()
    if row_active is None:
        loop.act.fill_(True)
    else:
        loop.act.copy_(row_active)
    if row_max_new is None:
        loop.row_max_new.fill_(spec.max_new_tokens)
    else:
        loop.row_max_new.copy_(row_max_new.clamp(max=spec.max_new_tokens))
    loop.done.copy_(~loop.act)
    loop.hit_eos.zero_()
    loop.rounds.zero_()
    loop.drafted.zero_()
    loop.accepted.zero_()
    if loop.c_q is not None:
        loop.c_q.zero_()
        loop.c_rej.zero_()
    loop.go.copy_(par.any_over_data_tensor(~torch.all(loop.done)))


def _set_at(buf, pos, val):
    """buf[b, pos[b]] = val[b] (a scratch buffer: a position past the end,
    which only a finished row reaches, lands on the last slot)."""
    idx = pos.clamp(max=buf.shape[1] - 1)[:, None]
    buf.scatter_(1, idx, val[:, None].to(buf.dtype))


def _first_false(ok):
    """(B, k) bool -> per row the index of the first False, k if none."""
    k = ok.shape[1]
    return torch.where(ok.all(dim=1), torch.full_like(ok[:, 0], k,
                                                      dtype=torch.int64),
                       (~ok).to(torch.int64).argmax(dim=1))


def spec_round(loop: SpecLoop, spec, params, cfg: LlamaConfig,
               dec: DecoderState, draft: Draft, history: torch.Tensor,
               history_len: torch.Tensor, generator=None,
               encoder_ngram_size: int = 0,
               suppress_mask: Optional[torch.Tensor] = None):
    """One round of JAX's ``round_fn``, in place, with no host decision:
    the anchor (greedy: the processed argmax of the carried logits;
    sampling: a draw from them, from the residual after a rejection), k
    draft ``decode_step``s over the first d layers, the verify of the
    k+1 tokens in one full ``decode_step``, the acceptance (greedy: the
    longest agreeing prefix; sampling: draft j with probability
    min(1, p_j / q_j)), the emission truncated at EOS and each row's cap,
    the masked scatters, the commit (``dec.valid_len`` += the emitted
    count), the carry, the counters and ``go`` over 'data'.

    The draft's appends land in the cache's first d layers at valid_len
    on, where the verify overwrites them, except at a full cache, where
    a clamped draft write could land on the committed slot C - 1: that
    slot of the first d layers is saved and restored around the draft.
    The sampler draws, in order, the anchor, the k drafts and the k x B
    uniforms, all from ``generator``.  history (B, Lh), history_len (B,)
    int64."""
    B, V = loop.logits.shape
    k, d = spec.draft_k, spec.draft_layers
    Tbuf = loop.seq_buf.shape[1]
    dev = loop.logits.device
    i64 = dict(dtype=torch.int64, device=dev)
    sample = loop.c_q is not None
    rows = torch.arange(B, device=dev)
    live = ~loop.done & loop.act

    def scores_of(raw, sbuf, slen):
        n = raw.shape[0] // B
        hist = history.repeat_interleave(n, 0)
        hlen = history_len.repeat_interleave(n, 0)
        if sample:
            return lp.sample_scores(raw, sbuf, slen, spec, hist, hlen,
                                    encoder_ngram_size, suppress_mask)
        return lp.process_scores(
            torch.log_softmax(raw.to(torch.float32), dim=-1), sbuf, slen,
            spec.repetition_penalty, spec.no_repeat_ngram_size, hist, hlen,
            encoder_ngram_size, suppress_mask)

    q_scores = []

    def pick(raw, sbuf, slen):
        s = scores_of(raw, sbuf, slen)
        if not sample:
            return torch.argmax(s, dim=-1)
        q_scores.append(s)
        return lp.categorical(s, generator)

    # the anchor: the target's own next token (sampling: a draw from the
    # correct conditional law)
    if sample:
        p0 = torch.softmax(scores_of(loop.logits, loop.seq_buf,
                                     loop.seq_len), dim=-1)
        res = (p0 - loop.c_q).clamp(min=0.0)
        rsum = res.sum(dim=-1, keepdim=True)
        use_res = (loop.c_rej & (rsum[:, 0] > 1e-12))[:, None]
        probs = torch.where(use_res, res / rsum.clamp(min=1e-12), p0)
        t1 = lp.categorical(torch.where(
            probs > 0, torch.log(probs),
            torch.full_like(probs, float("-inf"))), generator)
    else:
        t1 = torch.argmax(scores_of(loop.logits, loop.seq_buf,
                                    loop.seq_len), dim=-1)

    # the draft: k steps over the first d layers, in the cache in place
    C = dec.k.shape[2]
    saved = (dec.k[:d, :, C - 1].clone(), dec.v[:d, :, C - 1].clone())
    sbuf = loop.seq_buf.clone()
    _set_at(sbuf, loop.seq_len, t1)
    ddec = DecoderState(k=dec.k[:d], v=dec.v[:d], valid_len=dec.valid_len)
    tok, slen, drafts = t1, loop.seq_len, []
    for _ in range(k):
        lg, ddec = llama_mod.decode_step(
            draft.params, draft.cfg, ddec,
            llama_mod.embed(draft.params, tok[:, None]))
        raw = _shortlist_reenter(lg[:, -1], draft.head_ids,
                                 draft.head_prefix, V)
        nxt = pick(raw, sbuf, slen + 1)
        _set_at(sbuf, slen + 1, nxt)
        slen = slen + 1
        tok = nxt
        drafts.append(nxt)
    dec.k[:d, :, C - 1] = saved[0]
    dec.v[:d, :, C - 1] = saved[1]
    drafts = torch.stack(drafts, dim=1)  # (B, k)

    # the verify: one full forward over (B, k+1) tokens, valid where live
    toks_v = torch.cat([t1[:, None], drafts], dim=1)
    start = loop.seq_len.clamp(max=Tbuf - k - 1)
    rel = torch.arange(Tbuf, device=dev)[None] - start[:, None]
    sbuf_v = torch.where((rel >= 0) & (rel <= k),
                         toks_v.gather(1, rel.clamp(0, k)), loop.seq_buf)
    vmask = live[:, None].expand(B, k + 1).to(torch.int64)
    lg_v, _ = llama_mod.decode_step(
        params, cfg, dec, llama_mod.embed(params, toks_v), valid_mask=vmask)
    lg_v = lg_v[:, :, :V]
    # each row's staged buffer and seq length at every verified position
    # j (context: the prefix and toks_v[:j+1]), flattened to B * (k+1)
    n = k + 1
    sb = sbuf_v.repeat_interleave(n, 0)
    sl = (loop.seq_len[:, None] + torch.arange(n, device=dev)[None]
          + 1).reshape(-1)
    p_scores = scores_of(lg_v.reshape(B * n, V), sb, sl)

    # the acceptance
    if sample:
        # accept draft j with probability min(1, p_j(x) / q_j(x))
        p_scores = p_scores.reshape(B, n, V)
        q_probs = torch.softmax(torch.stack(q_scores), dim=-1)  # (k, B, V)
        p_probs = torch.softmax(p_scores[:, :k], dim=-1).transpose(0, 1)
        dt = drafts.t()[:, :, None]  # (k, B, 1)
        q_d = q_probs.gather(2, dt)[..., 0]
        p_d = p_probs.gather(2, dt)[..., 0]
        u = par.pool_rand((k, B), generator, dev, dim=1)
        a = _first_false((u * q_d < p_d).t())
    elif getattr(spec, "accept_all", False):
        a = torch.full((B,), k, **i64)
    else:
        true_next = torch.argmax(p_scores, dim=-1).reshape(B, n)
        a = _first_false(true_next[:, :-1] == toks_v[:, 1:])

    # the emission: toks_v[:, :a+1] truncated at EOS and the cap
    idx = torch.arange(n, device=dev)[None]
    eos_in = (toks_v == spec.eos_id) & (idx <= a[:, None])
    any_eos = eos_in.any(dim=1)
    first_eos = torch.where(any_eos, eos_in.to(torch.int64).argmax(1),
                            torch.full_like(a, n))
    room = loop.row_max_new - loop.n_out
    n_r = torch.minimum(torch.minimum(a + 1, first_eos), room)
    n_r = torch.where(live, n_r, torch.zeros_like(n_r))
    # EOS hits only strictly inside the remaining budget: at first_eos ==
    # room the cap ends the row first
    hit = any_eos & (first_eos < room) & live
    # masked scatters (a clamped slice would overwrite earlier tokens)
    G = loop.tokens.shape[1]
    relt = torch.arange(G, device=dev)[None] - loop.n_out[:, None]
    put = toks_v.gather(1, relt.clamp(0, k))
    loop.tokens.copy_(torch.where((relt >= 0) & (relt < n_r[:, None]), put,
                                  loop.tokens))
    rels = torch.arange(Tbuf, device=dev)[None] - loop.seq_len[:, None]
    puts = toks_v.gather(1, rels.clamp(0, k))
    loop.seq_buf.copy_(torch.where((rels >= 0) & (rels < n_r[:, None]),
                                   puts, loop.seq_buf))
    # the commit: exactly the emitted tokens' K/V (the verify's)
    dec.valid_len.add_(n_r)
    loop.seq_len.add_(n_r)
    loop.n_out.add_(n_r)
    done = loop.done | hit | (loop.n_out >= loop.row_max_new)
    loop.done.copy_(done)
    loop.hit_eos.copy_(loop.hit_eos | hit)
    loop.rounds.add_(1)
    loop.drafted.add_(torch.where(live, torch.full_like(n_r, k),
                                  torch.zeros_like(n_r)))
    loop.accepted.add_((n_r - 1).clamp(min=0))

    # the carry
    if sample:
        # raw verify logits at the last emitted position (all accepted) or
        # the rejected one, and the rejected draft's q
        loop.logits.copy_(torch.where(
            live[:, None], lg_v[rows, a].to(torch.float32), loop.logits))
        rej_now = (a < k) & live
        qa = q_probs[a.clamp(max=k - 1), rows]  # (B, V)
        loop.c_q.copy_(torch.where(rej_now[:, None], qa, loop.c_q))
        loop.c_rej.copy_(torch.where(live, a < k, loop.c_rej))
    else:
        nxt = lg_v[rows, (n_r - 1).clamp(min=0)].to(torch.float32)
        loop.logits.copy_(torch.where(live[:, None], nxt, loop.logits))
    loop.go.copy_(par.any_over_data_tensor(~torch.all(done)))


def _decode(params, cfg, dec0, first_logits, ids, prompt_lens, history,
            history_len, spec, row_active, row_max_new, encoder_ngram_size,
            suppress_mask, draft_head, exit_adapter, generator=None):
    """The loop driven eagerly: one host read of ``go`` a round."""
    dev = first_logits.device
    i64 = dict(dtype=torch.int64, device=dev)

    def rows(x):
        return None if x is None else torch.as_tensor(x).to(**i64)

    B, V = first_logits.shape
    loop = alloc_spec(spec, B, V, ids.shape[1], dev)
    start_spec(loop, spec, first_logits.to(torch.float32), ids.to(**i64),
               rows(prompt_lens), rows(row_active).to(torch.bool),
               rows(row_max_new))
    draft = draft_of(params, cfg, spec.draft_layers, draft_head,
                     exit_adapter)
    hist, hist_len = history.to(**i64), rows(history_len)
    while read(loop.go):
        spec_round(loop, spec, params, cfg, dec0, draft, hist, hist_len,
                   generator, encoder_ngram_size, suppress_mask)
    return (loop.tokens, loop.n_out, loop.hit_eos, dec0, loop.rounds,
            loop.drafted, loop.accepted)


def batched_speculative_greedy(
    params,
    cfg: LlamaConfig,
    dec0: DecoderState,  # B per-row caches after the prefill
    first_logits: torch.Tensor,  # (B, V)
    ids: torch.Tensor,  # (B, Tp) per-row prompt ids (padded)
    prompt_lens,  # (B,)
    history: torch.Tensor,  # (B, Lh)
    history_len,  # (B,)
    spec: SpecSpec,
    row_active,  # (B,) bool: inactive rows emit nothing
    row_max_new=None,  # (B,) per-row caps (bound to max_new_tokens)
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,
    draft_head: Optional[dict] = None,
    exit_adapter: Optional[dict] = None,
):
    """Pooled layer-skip speculation: every row drafts and verifies in
    lockstep, so one draft stream and one verify stream a round serve
    every row and every verified position.  Each row emits exactly the
    sequential processed-greedy output (EOS not emitted, per-row cap).
    The device loop (``SpecLoop``, ``spec_round``) driven eagerly; the
    cache ``dec0`` is updated in place.  Returns (tokens (B, G), n_tokens
    (B,), hit_eos (B,), dec0, rounds (), drafted (B,), accepted (B,)),
    tensors on the logits' device."""
    return _decode(params, cfg, dec0, first_logits, ids, prompt_lens,
                   history, history_len, spec, row_active, row_max_new,
                   encoder_ngram_size, suppress_mask, draft_head,
                   exit_adapter)


def batched_speculative_sample(
    params,
    cfg: LlamaConfig,
    dec0: DecoderState,
    first_logits: torch.Tensor,  # (B, V)
    ids: torch.Tensor,  # (B, Tp)
    prompt_lens,
    history: torch.Tensor,
    history_len,
    spec: SpecSampleSpec,
    generator: torch.Generator,
    row_active,
    row_max_new=None,
    encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,
    draft_head: Optional[dict] = None,
    exit_adapter: Optional[dict] = None,
):
    """Pooled speculative sampling (the Leviathan et al. / Chen et al.
    rejection scheme over the layer-skip draft): every emitted token's
    conditional law is that of one step of ``beam.sample_decode`` from
    the processed target distribution, per row, for any draft.  A round
    draws the anchor from the carried target scores (after a rejection,
    from the residual max(p - q, 0) / Z), k draft tokens from the
    draft's processed q, verifies them in one full forward and accepts
    draft j with probability min(1, p_j(x) / q_j(x)); the first rejected
    position's logits carry into the next round's anchor.  Draws, in
    order a round: the anchor, the k drafts, the k x B uniforms, all
    from ``generator``.  Returns what ``batched_speculative_greedy``
    returns."""
    return _decode(params, cfg, dec0, first_logits, ids, prompt_lens,
                   history, history_len, spec, row_active, row_max_new,
                   encoder_ngram_size, suppress_mask, draft_head,
                   exit_adapter, generator)


def pack_spec(tokens, n_tokens, hit_eos, rounds, drafted, accepted,
              extra=()) -> torch.Tensor:
    """One stream's result as one int32 vector, for one host read (JAX's
    packed chunk result): [n_tokens, hit_eos, tokens (G), rounds,
    drafted, accepted, *extra], from () tensors and tokens (G,)."""
    def one(x):
        return x.to(torch.int32).reshape(1)

    return torch.cat([one(n_tokens), one(hit_eos), tokens.to(torch.int32)]
                     + [one(x) for x in (rounds, drafted, accepted)]
                     + [one(x) for x in extra])


def unpack_spec(packed: list, G: int, offset: int = 0) -> SpecResult:
    """The SpecResult of a ``pack_spec`` vector read to the host (from
    ``offset`` on); ``dec`` is None."""
    p = packed[offset:]
    return SpecResult(tokens=list(p[2:2 + G]), n_tokens=p[0],
                      hit_eos=bool(p[1]), rounds=p[G + 2],
                      drafted=p[G + 3], accepted=p[G + 4], dec=None)


def _single(batched, params, cfg, prefix, first_logits, prompt_buf,
            prompt_len, history, history_len, spec, *extra, **kw):
    dev = first_logits.device
    tokens, n_out, hit_eos, dec, rounds, drafted, accepted = batched(
        params, cfg, prefix, first_logits[None], prompt_buf[None],
        [int(prompt_len)], history[None], [int(history_len)], spec, *extra,
        row_active=torch.ones((1,), dtype=torch.bool, device=dev), **kw,
    )
    return SpecResult(
        tokens=tokens[0].tolist(), n_tokens=int(n_out[0]),
        hit_eos=bool(hit_eos[0]), rounds=int(rounds),
        drafted=int(drafted[0]), accepted=int(accepted[0]), dec=dec,
    )


def speculative_greedy(
    params, cfg: LlamaConfig, prefix: DecoderState,
    first_logits: torch.Tensor,  # (V,)
    prompt_buf: torch.Tensor,  # (Tp,)
    prompt_len: int, history: torch.Tensor, history_len: int,
    spec: SpecSpec, encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,
    draft_head: Optional[dict] = None, exit_adapter: Optional[dict] = None,
) -> SpecResult:
    """``batched_speculative_greedy`` for one stream."""
    return _single(batched_speculative_greedy, params, cfg, prefix,
                   first_logits, prompt_buf, prompt_len, history,
                   history_len, spec, encoder_ngram_size=encoder_ngram_size,
                   suppress_mask=suppress_mask, draft_head=draft_head,
                   exit_adapter=exit_adapter)


def speculative_sample(
    params, cfg: LlamaConfig, prefix: DecoderState,
    first_logits: torch.Tensor, prompt_buf: torch.Tensor, prompt_len: int,
    history: torch.Tensor, history_len: int, spec: SpecSampleSpec,
    generator: torch.Generator, encoder_ngram_size: int = 0,
    suppress_mask: Optional[torch.Tensor] = None,
    draft_head: Optional[dict] = None, exit_adapter: Optional[dict] = None,
) -> SpecResult:
    """``batched_speculative_sample`` for one stream."""
    return _single(batched_speculative_sample, params, cfg, prefix,
                   first_logits, prompt_buf, prompt_len, history,
                   history_len, spec, generator,
                   encoder_ngram_size=encoder_ngram_size,
                   suppress_mask=suppress_mask, draft_head=draft_head,
                   exit_adapter=exit_adapter)


def with_draft_params(params, cfg, dtype, device, head_vocab: int = 0,
                      head_ids=None, lowrank_rank: int = 0,
                      lowrank_head=None, adapter=None):
    """``params`` (a model bundle with a ``llama`` tree) plus the draft's
    own leaves, as the JAX agent and engine set them up:
    ``spec_draft_head`` (a shortlist of ``head_vocab`` ids, or low-rank
    factors built by SVD with ``lowrank_rank`` or given as
    ``lowrank_head`` {'a', 'b'}) and ``spec_adapter`` (an exit adapter
    {'ln', 'w1', 'w2'}), cast to ``dtype`` on ``device``.  Raises on the
    JAX package's misconfigurations."""
    D, V = cfg.llama.hidden_size, cfg.llama.vocab_size
    params = dict(params)
    head = params["llama"]["lm_head"]
    if head_vocab or lowrank_rank:  # both read whole columns of the head
        with torch.no_grad():
            head = par.unshard(head)
    if par.model_size() > 1:
        if lowrank_rank or lowrank_head is not None:
            raise ValueError(
                "a low-rank draft head under tensor parallelism is not "
                "ported: its factors come from an SVD of the whole head "
                "(ROADMAP §3)")
        if not isinstance(head, dict) and head.shape[-1] < V:
            # split on the vocabulary: the shortlist selects whole columns
            head = par.gather_from_model(head, -1)

    def tensor(a):
        return torch.as_tensor(np.asarray(a) if not torch.is_tensor(a)
                               else a, device=device).to(dtype)

    if lowrank_rank or lowrank_head is not None:
        if head_vocab:
            raise ValueError("spec_lowrank_* and spec_head_vocab are "
                             "mutually exclusive draft-head choices")
        if lowrank_rank and lowrank_head is not None:
            raise ValueError("pass spec_lowrank_rank (build by SVD at init) "
                             "OR spec_lowrank_head (prebuilt factors), not "
                             "both")
        if lowrank_head is not None:
            a, b = lowrank_head["a"], lowrank_head["b"]
            if a.shape[0] != D or a.shape[1] != b.shape[0]:
                raise ValueError(
                    f"spec_lowrank_head factor shapes {tuple(a.shape)} x "
                    f"{tuple(b.shape)} do not chain from hidden size {D}")
            params["spec_draft_head"] = {"w": {"a": tensor(a),
                                               "b": tensor(b)}}
        else:
            params["spec_draft_head"] = make_lowrank_draft_head(
                head, lowrank_rank, dtype=dtype)
    if head_vocab:
        if not 0 < head_vocab < V:
            raise ValueError(f"spec_head_vocab={head_vocab} must be in "
                             f"(0, vocab_size={V})")
        params["spec_draft_head"] = make_draft_head(
            head, head_vocab, ids=head_ids)
    if adapter is not None:
        if tuple(adapter["ln"].shape) != (D,):
            raise ValueError(
                f"spec_adapter hidden size {tuple(adapter['ln'].shape)} "
                f"does not match the model ({D},)")
        params["spec_adapter"] = {k: tensor(adapter[k])
                                  for k in ("ln", "w1", "w2")}
    return params
