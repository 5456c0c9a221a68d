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

The JAX ``while_loop`` is a Python loop with one host read a round (its
condition); every other per-round rule (the emission, the EOS and cap
rules, the masked scatters) is the JAX one, on tensors.  The caches are
written in place: the draft's appends land in the main cache's first d
layers at valid_len onwards, where the verify overwrites them, except at
a full cache, where a clamped draft write could land on the committed
slot C - 1.  That slot of the first d layers is saved before the draft
and restored after it, so the committed K/V equal the JAX decoder's,
whose draft works on a copy.  Every random draw of the sampling decoders
comes from the caller's ``torch.Generator``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.decode import logits as lp
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models.quant import KMAJOR
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
    dec: DecoderState  # the cache with the emitted tokens committed


def _nbytes(tree) -> float:
    if torch.is_tensor(tree):
        return float(tree.numel() * tree.element_size())
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


def _draft_setup(params, cfg: LlamaConfig, d: int, draft_head, exit_adapter):
    """The draft's (params, cfg, shortlist ids, prefix?): the first d
    layers (views of the stacked leaves), the exit adapter, and the full,
    shortlist or low-rank head."""
    params_d = {
        "embed": params["embed"],
        "layers": {k: ({kk: vv[:d] for kk, vv in v.items()}
                       if isinstance(v, dict) else v[:d])
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
    return params_d, cfg_d, head_ids, head_prefix


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
# The decoders


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


class _Round:
    """The state and the per-round rules the greedy and sampling decoders
    share: seq buffers, the emission, the masked scatters, the commit."""

    def __init__(self, params, cfg, dec0, first_logits, ids, prompt_lens,
                 history, history_len, spec, row_active, row_max_new,
                 encoder_ngram_size, suppress_mask, draft_head,
                 exit_adapter):
        self.G, self.k, self.d = (spec.max_new_tokens, spec.draft_k,
                                  spec.draft_layers)
        self.B, self.V = first_logits.shape
        dev = self.dev = first_logits.device
        self.i64 = dict(dtype=torch.int64, device=dev)
        self.params, self.cfg, self.spec = params, cfg, spec
        Tp = ids.shape[1]
        # +k slack: near the cap a round stages k+1 tokens before the cap
        # truncates the commit
        self.Tbuf = Tp + self.G + self.k
        cap = torch.full((self.B,), self.G, **self.i64) if row_max_new \
            is None else torch.as_tensor(row_max_new).to(**self.i64)
        self.row_max_new = cap.clamp(max=self.G)  # the <= G contract
        self.params_d, self.cfg_d, self.head_ids, self.head_prefix = \
            _draft_setup(params, cfg, self.d, draft_head, exit_adapter)
        self.hist = history.to(**self.i64)
        self.hist_len = torch.as_tensor(history_len).to(**self.i64)
        self.enc_ng, self.suppress = encoder_ngram_size, suppress_mask
        self.seq_buf = torch.cat([
            ids.to(**self.i64),
            torch.full((self.B, self.G + self.k), spec.pad_id, **self.i64),
        ], dim=1)
        self.seq_len = torch.as_tensor(prompt_lens).to(**self.i64)
        self.act = torch.as_tensor(row_active).to(device=dev,
                                                  dtype=torch.bool)
        self.tokens = torch.full((self.B, self.G), spec.pad_id, **self.i64)
        self.n_out = torch.zeros((self.B,), **self.i64)
        self.done = ~self.act
        self.hit_eos = torch.zeros((self.B,), dtype=torch.bool, device=dev)
        self.rounds = 0
        self.drafted = torch.zeros((self.B,), **self.i64)
        self.accepted = torch.zeros((self.B,), **self.i64)
        self.dec = dec0
        self.rows = torch.arange(self.B, device=dev)

    def hist_rows(self, n):
        """The history repeated for n positions a row, (B * n, Lh)."""
        return (self.hist.repeat_interleave(n, 0),
                self.hist_len.repeat_interleave(n, 0))

    def draft(self, t1, pick):
        """k draft steps from the anchor t1 over the first d layers;
        ``pick(raw (B, V), sbuf, slen)`` chooses each next token (and may
        keep what it needs).  Returns the (B, k) drafts."""
        d, C = self.d, self.dec.k.shape[2]
        dec = self.dec
        saved = (dec.k[:d, :, C - 1].clone(), dec.v[:d, :, C - 1].clone())
        sbuf = self.seq_buf.clone()
        _set_at(sbuf, self.seq_len, t1)
        ddec = DecoderState(k=dec.k[:d], v=dec.v[:d],
                            valid_len=dec.valid_len)
        tok, slen, drafts = t1, self.seq_len, []
        for _ in range(self.k):
            lg, ddec = llama_mod.decode_step(
                self.params_d, self.cfg_d, ddec,
                llama_mod.embed(self.params_d, tok[:, None]),
            )
            raw = _shortlist_reenter(lg[:, -1], self.head_ids,
                                     self.head_prefix, self.V)
            nxt = pick(raw, sbuf, slen + 1)
            _set_at(sbuf, slen + 1, nxt)
            slen = slen + 1
            tok = nxt
            drafts.append(nxt)
        dec.k[:d, :, C - 1] = saved[0]
        dec.v[:d, :, C - 1] = saved[1]
        return torch.stack(drafts, dim=1)

    def verify(self, toks_v, live):
        """One full forward over (B, k+1) tokens (valid where ``live``).
        Returns (logits (B, k+1, V), the seq buffer with the tokens staged
        at seq_len (B, Tbuf), the new cache state)."""
        k = self.k
        start = self.seq_len.clamp(max=self.Tbuf - k - 1)
        rel = torch.arange(self.Tbuf, device=self.dev)[None] - start[:, None]
        sbuf_v = torch.where((rel >= 0) & (rel <= k),
                             toks_v.gather(1, rel.clamp(0, k)), self.seq_buf)
        vmask = live[:, None].expand(self.B, k + 1).to(torch.int64)
        lg_v, dec_v = llama_mod.decode_step(
            self.params, self.cfg, self.dec,
            llama_mod.embed(self.params, toks_v), valid_mask=vmask,
        )
        return lg_v[:, :, : self.V], sbuf_v, dec_v

    def positions(self, sbuf_v):
        """Each row's staged buffer and seq length at every verified
        position j (context: the prefix and toks_v[:j+1]), flattened to
        (B * (k+1), ...)."""
        n = self.k + 1
        off = torch.arange(n, device=self.dev)
        return (sbuf_v.repeat_interleave(n, 0),
                (self.seq_len[:, None] + off[None] + 1).reshape(-1))

    def emit(self, toks_v, a, live, dec_v):
        """Emit toks_v[:, :a+1] truncated at EOS and the cap, scatter it
        into tokens and seq_buf, commit the emitted K/V.  Returns n_r."""
        k, spec = self.k, self.spec
        idx = torch.arange(k + 1, device=self.dev)[None]
        eos_in = (toks_v == spec.eos_id) & (idx <= a[:, None])
        any_eos = eos_in.any(dim=1)
        first_eos = torch.where(any_eos, eos_in.to(torch.int64).argmax(1),
                                torch.full_like(a, k + 1))
        room = self.row_max_new - self.n_out
        n_r = torch.minimum(torch.minimum(a + 1, first_eos), room)
        n_r = torch.where(live, n_r, torch.zeros_like(n_r))
        # EOS hits only strictly inside the remaining budget: at
        # first_eos == room the cap ends the row first
        hit = any_eos & (first_eos < room) & live
        # masked scatters (a clamped slice would overwrite earlier tokens)
        relt = torch.arange(self.G, device=self.dev)[None] - \
            self.n_out[:, None]
        put = toks_v.gather(1, relt.clamp(0, k))
        self.tokens = torch.where((relt >= 0) & (relt < n_r[:, None]), put,
                                  self.tokens)
        rels = torch.arange(self.Tbuf, device=self.dev)[None] - \
            self.seq_len[:, None]
        puts = toks_v.gather(1, rels.clamp(0, k))
        self.seq_buf = torch.where((rels >= 0) & (rels < n_r[:, None]),
                                   puts, self.seq_buf)
        self.dec = DecoderState(k=dec_v.k, v=dec_v.v,
                                valid_len=self.dec.valid_len + n_r)
        self.seq_len = self.seq_len + n_r
        self.n_out = self.n_out + n_r
        self.done = self.done | hit | (self.n_out >= self.row_max_new)
        self.hit_eos = self.hit_eos | hit
        self.rounds += 1
        self.drafted = self.drafted + torch.where(
            live, torch.full_like(n_r, k), torch.zeros_like(n_r))
        self.accepted = self.accepted + (n_r - 1).clamp(min=0)
        return n_r

    def result(self):
        return (self.tokens, self.n_out, self.hit_eos, self.dec,
                self.rounds, self.drafted, self.accepted)


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
    Returns (tokens (B, G), n_tokens (B,), hit_eos (B,), dec, rounds,
    drafted (B,), accepted (B,)), tensors on the logits' device."""
    r = _Round(params, cfg, dec0, first_logits, ids, prompt_lens, history,
               history_len, spec, row_active, row_max_new,
               encoder_ngram_size, suppress_mask, draft_head, exit_adapter)
    k = r.k

    def argmax(raw, sbuf, slen):
        n = raw.shape[0] // r.B
        hist, hlen = r.hist_rows(n)
        scores = torch.log_softmax(raw.to(torch.float32), dim=-1)
        scores = lp.process_scores(
            scores, sbuf, slen, spec.repetition_penalty,
            spec.no_repeat_ngram_size, hist, hlen, encoder_ngram_size,
            suppress_mask,
        )
        return torch.argmax(scores, dim=-1)

    last = first_logits.to(torch.float32)
    while not bool(r.done.all()):
        t1 = argmax(last, r.seq_buf, r.seq_len)  # the round's anchor
        drafts = r.draft(t1, argmax)
        toks_v = torch.cat([t1[:, None], drafts], dim=1)  # (B, k+1)
        live = ~r.done & r.act
        lg_v, sbuf_v, dec_v = r.verify(toks_v, live)
        sb, sl = r.positions(sbuf_v)
        true_next = argmax(lg_v.reshape(r.B * (k + 1), r.V), sb,
                           sl).reshape(r.B, k + 1)
        if spec.accept_all:
            a = torch.full((r.B,), k, **r.i64)
        else:
            a = _first_false(true_next[:, :-1] == toks_v[:, 1:])
        n_r = r.emit(toks_v, a, live, dec_v)
        nxt = lg_v[r.rows, (n_r - 1).clamp(min=0)].to(torch.float32)
        last = torch.where(live[:, None], nxt, last)
    return r.result()


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
    r = _Round(params, cfg, dec0, first_logits, ids, prompt_lens, history,
               history_len, spec, row_active, row_max_new,
               encoder_ngram_size, suppress_mask, draft_head, exit_adapter)
    k, B, V = r.k, r.B, r.V

    def scores_of(raw, sbuf, slen):
        n = raw.shape[0] // B
        hist, hlen = r.hist_rows(n)
        return lp.sample_scores(raw, sbuf, slen, spec, hist, hlen,
                                encoder_ngram_size, suppress_mask)

    c_lg = first_logits.to(torch.float32)
    c_q = torch.zeros((B, V), dtype=torch.float32, device=r.dev)
    c_rej = torch.zeros((B,), dtype=torch.bool, device=r.dev)
    while not bool(r.done.all()):
        live = ~r.done & r.act
        # the anchor: a draw from the correct conditional law
        p0 = torch.softmax(scores_of(c_lg, r.seq_buf, r.seq_len), dim=-1)
        res = (p0 - c_q).clamp(min=0.0)
        rsum = res.sum(dim=-1, keepdim=True)
        use_res = (c_rej & (rsum[:, 0] > 1e-12))[:, None]
        probs = torch.where(use_res, res / rsum.clamp(min=1e-12), p0)
        t1 = lp.categorical(torch.where(
            probs > 0, torch.log(probs),
            torch.full_like(probs, float("-inf"))), generator)
        q_scores = []

        def draw(raw, sbuf, slen):
            qs = scores_of(raw, sbuf, slen)
            q_scores.append(qs)
            return lp.categorical(qs, generator)

        drafts = r.draft(t1, draw)  # (B, k)
        toks_v = torch.cat([t1[:, None], drafts], dim=1)
        lg_v, sbuf_v, dec_v = r.verify(toks_v, live)
        sb, sl = r.positions(sbuf_v)
        p_scores = scores_of(lg_v.reshape(B * (k + 1), V), sb,
                             sl).reshape(B, k + 1, V)
        # accept draft j with probability min(1, p_j(x) / q_j(x))
        q_probs = torch.softmax(torch.stack(q_scores), dim=-1)  # (k, B, V)
        p_probs = torch.softmax(p_scores[:, :k], dim=-1).transpose(0, 1)
        dt = drafts.t()[:, :, None]  # (k, B, 1)
        q_d = q_probs.gather(2, dt)[..., 0]
        p_d = p_probs.gather(2, dt)[..., 0]
        u = torch.rand((k, B), generator=generator, device=r.dev)
        a = _first_false((u * q_d < p_d).t())
        r.emit(toks_v, a, live, dec_v)
        # the carry: raw verify logits at the last emitted position (all
        # accepted) or the rejected one, and the rejected draft's q
        c_lg = torch.where(live[:, None], lg_v[r.rows, a].to(torch.float32),
                           c_lg)
        rej_now = (a < k) & live
        qa = q_probs[a.clamp(max=k - 1), r.rows]  # (B, V)
        c_q = torch.where(rej_now[:, None], qa, c_q)
        c_rej = torch.where(live, a < k, c_rej)
    return r.result()


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
    from infinisst_tpu_torch.parallel import collectives as par

    D, V = cfg.llama.hidden_size, cfg.llama.vocab_size
    params = dict(params)
    head = params["llama"]["lm_head"]
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
