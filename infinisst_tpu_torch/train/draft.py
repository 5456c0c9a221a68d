"""The early-exit draft adapter of the speculative decoders and its
distillation; port of ``infinisst_tpu/train/draft.py``.

The adapter h -> h + w2 silu(w1 rmsnorm(h)) runs on the draft's hidden
state before ``final_ln`` (``models/llama.apply_exit_adapter``), on the
draft path only: the verify forward never sees it, so any adapter leaves
the speculative decoders exact and moves only their acceptance.  The
``.npz`` format is the JAX package's (arrays ``ln``, ``w1``, ``w2`` and
the draft depth ``draft_layers``), so an adapter distilled in either
package loads in the other.

Distillation (adapter only, the backbone frozen), as in JAX:
``rollout_corpus`` decodes the target model's own greedy continuations
(the contexts the draft is queried at), ``collect_targets`` runs one
teacher pass that keeps the layer-d hidden and the full model's logits,
and ``distill`` fits the adapter by Adam on KL(teacher || draft) through
``final_ln`` and the lm_head; ``distill_on_features`` does the same over
features collected beforehand (``collect_targets_x`` over spliced
embeddings).  ``beam_rollout_states`` and ``beam_selection_distill`` fit
an adapter for speculative beam search to the target's whole top-B
selection.  The optimizer is optax's ``adam`` in optax's order
(``train/step.adam``).  The draws differ from
JAX's: ``init_exit_adapter`` takes a ``torch.Generator``.
"""

from __future__ import annotations

import math
from collections import OrderedDict
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models.quant import is_quantized
from infinisst_tpu_torch.streaming.state import init_decoder_state
from infinisst_tpu_torch.train.step import adam, tree_leaves

Adapter = dict


def init_exit_adapter(generator: torch.Generator, cfg: LlamaConfig,
                      rank: Optional[int] = None, dtype=torch.float32,
                      device="cpu") -> Adapter:
    """A fresh adapter: ``w2`` zero, so it is the identity; ``w1`` normal
    / sqrt(D) from ``generator`` (on ``device``).  ``rank`` defaults to
    hidden_size / 2."""
    D = cfg.hidden_size
    r = rank or D // 2
    w1 = torch.randn((D, r), generator=generator, device=device,
                     dtype=torch.float32) / math.sqrt(D)
    return {
        "ln": torch.ones((D,), dtype=dtype, device=device),
        "w1": w1.to(dtype),
        "w2": torch.zeros((r, D), dtype=dtype, device=device),
    }


def draft_logits(params, cfg: LlamaConfig, adapter: Optional[Adapter],
                 h_d: torch.Tensor) -> torch.Tensor:
    """The draft's head over a layer-d hidden: adapter, final_ln,
    lm_head (the tail of ``llama.decode_step`` on a draft)."""
    h = h_d
    if adapter is not None:
        h = llama_mod.apply_exit_adapter(adapter, h, cfg.rms_norm_eps)
    h = llama_mod._rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    return h @ params["lm_head"]


def collect_targets(params, cfg: LlamaConfig, ids: torch.Tensor, d: int,
                    attention_mask: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher pass over token ids (B, S): (h_d (B, S, D), teacher
    logits (B, S, V)), both detached."""
    x = llama_mod.embed(params, ids)
    return collect_targets_x(params, cfg, x, d, attention_mask)


@torch.no_grad()
def collect_targets_x(params, cfg: LlamaConfig, x: torch.Tensor, d: int,
                      attention_mask: Optional[torch.Tensor] = None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``collect_targets`` over input embeddings (B, S, D), e.g. the
    speech-spliced sequences of ``speech_llm.offline_spliced_embeddings``.
    The first d layers run once: the rest of the stack continues from
    their hidden state."""
    h_d = llama_mod.offline_hidden(params, cfg, x, attention_mask,
                                   num_layers=d)
    rest = {k: v[d:] for k, v in params["layers"].items()}
    h_L = llama_mod._offline_scan(rest, cfg, h_d, attention_mask,
                                  remat=False)
    h_L = llama_mod._rms_norm(h_L, params["final_ln"], cfg.rms_norm_eps)
    return h_d, h_L @ params["lm_head"]


def _refuse_quantized(params, what: str):
    if is_quantized(params["lm_head"]):
        raise ValueError(what)


@torch.no_grad()
def rollout_corpus(params, cfg: LlamaConfig, prompts, gen_len: int
                   ) -> torch.Tensor:
    """Greedy continuations from the TARGET model: (B, P) prompts ->
    (B, P + gen_len) int64 token ids on the parameters' device, the
    distillation corpus that matches the draft's deployment distribution.
    One prefill, then cached one-token steps (JAX's scan runs one more,
    whose token it drops)."""
    _refuse_quantized(params, "rollout_corpus needs unquantized params")
    head = params["lm_head"]
    dev = head.device
    prompts = torch.as_tensor(prompts, device=dev).to(torch.int64)
    B, P = prompts.shape
    V = cfg.vocab_size
    if gen_len <= 0:
        return prompts
    st = init_decoder_state(cfg.num_layers, B, P + gen_len + 1,
                            cfg.num_kv_heads, cfg.head_dim, head.dtype, dev)
    lg, st = llama_mod.decode_step(params, cfg, st,
                                   llama_mod.embed(params, prompts))
    toks = [torch.argmax(lg[:, -1, :V], -1)]
    for _ in range(gen_len - 1):
        lg, st = llama_mod.decode_step(
            params, cfg, st, llama_mod.embed(params, toks[-1][:, None]))
        toks.append(torch.argmax(lg[:, -1, :V], -1))
    return torch.cat([prompts, torch.stack(toks, 1)], dim=1)


def _loss(adapter, params, cfg, h_d, teacher, mask):
    lg = draft_logits(params, cfg, adapter, h_d).to(torch.float32)
    t = teacher.to(torch.float32)
    p_t = torch.softmax(t, dim=-1)
    kl = torch.sum(
        p_t * (torch.log_softmax(t, -1) - torch.log_softmax(lg, -1)), -1)
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (kl * mask).sum() / denom
    agree = ((torch.argmax(lg, -1) == torch.argmax(t, -1)) * mask).sum() \
        / denom
    return loss, agree


def _fit(adapter: Adapter, lr: float, steps: int, log_every: int,
         loss_at: Callable[[Adapter, int], tuple]) -> Tuple[Adapter, list]:
    """``steps`` Adam updates of ``adapter`` on ``loss_at(adapter, i)``
    -> (loss, agreement); history entries (step, loss, agreement) every
    ``log_every`` steps and at the last."""
    leaves = tree_leaves(adapter)  # ln, w1, w2
    for p in leaves:
        p.requires_grad_(True)
    opt = adam(lr, len(leaves))
    state = opt.init(leaves)
    history = []
    for i in range(steps):
        loss, agree = loss_at(adapter, i)
        grads = torch.autograd.grad(loss, leaves)
        state = opt.update(leaves, grads, state)
        if log_every and (i % log_every == 0 or i == steps - 1):
            history.append((i, float(loss.detach()), float(agree)))
    return {k: v.detach() for k, v in adapter.items()}, history


def _init(cfg, rank, key, dev) -> Adapter:
    key = torch.Generator(device=dev).manual_seed(0) if key is None else key
    return init_exit_adapter(key, cfg, rank, torch.float32, device=dev)


def distill(
    params,
    cfg: LlamaConfig,
    d: int,
    batches: Iterable,  # (B, S) token ids
    *,
    steps: int,
    lr: float = 1e-3,
    rank: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    pad_id: int = -1,
    log_every: int = 0,
    max_cached_batches: int = 4,
) -> Tuple[Adapter, list]:
    """Distill an exit adapter at draft depth ``d``: ``batches`` is cycled
    for ``steps`` Adam updates, positions equal to ``pad_id`` masked out
    of the loss.  The teacher features of each batch object are cached
    (one teacher pass each), least recently used first out beyond
    ``max_cached_batches``: an entry holds (B, S, V) float32 teacher
    logits.  ``key`` draws the initial adapter (default: seed 0 on the
    parameters' device).  Returns (adapter, history) with history entries
    (step, kl, top1_agreement)."""
    _refuse_quantized(
        params,
        "distill() needs unquantized (bf16/f32) params: the int8 "
        "activation rounding has zero gradient.  Distill on the "
        "float checkpoint; the adapter then rides the quantized "
        "draft path unchanged.")
    dev = params["lm_head"].device
    cache: OrderedDict = OrderedDict()
    batch_list = list(batches)

    def loss_at(adapter, i):
        ids = batch_list[i % len(batch_list)]
        bid = id(ids)
        if bid in cache:
            cache.move_to_end(bid)
        else:
            ids = torch.as_tensor(ids, device=dev).to(torch.int64)
            mask = (ids != pad_id).to(torch.float32)
            cache[bid] = (*collect_targets(params, cfg, ids, d, mask), mask)
            while len(cache) > max(1, max_cached_batches):
                cache.popitem(last=False)
        return _loss(adapter, params, cfg, *cache[bid])

    return _fit(_init(cfg, rank, key, dev), lr, steps, log_every, loss_at)


def distill_on_features(
    params,
    cfg: LlamaConfig,
    feats,  # list of (h_d (B,S,D), teacher (B,S,V), mask (B,S)) triples
    *,
    steps: int,
    lr: float = 1e-3,
    rank: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    log_every: int = 0,
) -> Tuple[Adapter, list]:
    """``distill`` over features collected beforehand (``collect_targets_x``
    over the serving context, ``mask`` restricted to the positions the
    draft is queried at); the draft depth is in ``h_d``.  Returns
    (adapter, history) as ``distill``."""
    dev = params["lm_head"].device
    return _fit(_init(cfg, rank, key, dev), lr, steps, log_every,
                lambda a, i: _loss(a, params, cfg, *feats[i % len(feats)]))


@torch.no_grad()
def beam_rollout_states(params, cfg: LlamaConfig, prompt, gen_len: int,
                        beam: int = 4) -> list:
    """Beam rollout from the TARGET model recording each step's selection
    state, the corpus of ``beam_selection_distill`` (no EOS, no logits
    processors).  Each step runs the whole (beam, P + gen_len) buffer
    through the training forward (causal: the padded tail never reaches
    position len - 1).  Returns per-step dicts of numpy arrays, as JAX's:
    ``buf`` (B, P + gen_len) int32, ``len``, ``beam_scores`` (B,) float32,
    ``sel_beam`` / ``sel_tok`` (B,) int32, the teacher's selection from
    that state."""
    from infinisst_tpu_torch.decode.beam import NEG_INF, select_candidates

    dev = params["lm_head"].device
    B = beam
    prompt = torch.as_tensor(prompt, device=dev).to(torch.int64)
    P = int(prompt.shape[0])
    V = cfg.vocab_size
    buf = torch.zeros((B, P + gen_len), dtype=torch.int64, device=dev)
    buf[:, :P] = prompt[None]
    beam_scores = torch.tensor([0.0] + [NEG_INF] * (B - 1),
                               dtype=torch.float32, device=dev)
    samples = []
    ln = P
    for _ in range(gen_len):
        h = llama_mod.offline_hidden(params, cfg,
                                     llama_mod.embed(params, buf), None)
        h_last = llama_mod._rms_norm(h[:, ln - 1], params["final_ln"],
                                     cfg.rms_norm_eps)
        logp = torch.log_softmax(
            (h_last @ params["lm_head"])[:, :V].to(torch.float32), -1)
        total, _vals, cbeam, ctok = select_candidates(logp, beam_scores)
        sel_beam, sel_tok = cbeam[:B], ctok[:B]  # no EOS: the first B live
        samples.append({
            "buf": buf.cpu().numpy().astype(np.int32),
            "len": ln,
            "beam_scores": beam_scores.cpu().numpy(),
            "sel_beam": sel_beam.cpu().numpy().astype(np.int32),
            "sel_tok": sel_tok.cpu().numpy().astype(np.int32),
        })
        buf = buf[sel_beam]
        buf[:, ln] = sel_tok
        beam_scores = total[sel_beam, sel_tok]
        ln += 1
    return samples


def beam_selection_distill(
    params,
    cfg: LlamaConfig,
    d: int,
    samples: list,  # beam_rollout_states output (equal-shape steps)
    *,
    steps: int,
    lr: float = 2e-3,
    rank: Optional[int] = None,
    key: Optional[torch.Generator] = None,
    batch: int = 32,
    log_every: int = 0,
) -> Tuple[Adapter, list]:
    """Listwise selection distillation for the speculative beam draft: the
    cross-entropy of the teacher's selected (beam, token) pairs under the
    softmax over B x V of (beam score + draft log-prob), on batches of
    ``batch`` recorded states drawn by ``np.random.RandomState(0)`` (as
    JAX, so both packages take the same batches).  The agreement is the
    exact whole-selection match, the draft's top B by a stable sort, so a
    tie goes to the lower index as in ``lax.top_k``.  Returns (adapter,
    history) with entries (step, ce, selection_agree)."""
    _refuse_quantized(params,
                      "beam_selection_distill needs unquantized params")
    dev = params["lm_head"].device
    i64 = dict(dtype=torch.int64, device=dev)
    bufs = torch.as_tensor(np.stack([s["buf"] for s in samples])).to(**i64)
    lens = torch.tensor([s["len"] for s in samples], **i64)
    scores = torch.as_tensor(
        np.stack([s["beam_scores"] for s in samples])).to(dev)
    selb = torch.as_tensor(np.stack([s["sel_beam"] for s in samples])
                           ).to(**i64)
    selt = torch.as_tensor(np.stack([s["sel_tok"] for s in samples])
                           ).to(**i64)
    N, B, S = bufs.shape
    V = cfg.vocab_size
    eps = cfg.rms_norm_eps
    with torch.no_grad():  # the teacher's layer-d hiddens at len - 1
        x = llama_mod.embed(params, bufs.reshape(N * B, S))
        h = llama_mod.offline_hidden(params, cfg, x, None, num_layers=d)
        h_d = h.reshape(N, B, S, -1)[
            torch.arange(N, device=dev)[:, None],
            torch.arange(B, device=dev)[None], (lens - 1)[:, None]]

    rng = np.random.RandomState(0)

    def loss_at(adapter, i):
        sel = rng.choice(N, size=min(batch, N), replace=False)
        sel = torch.as_tensor(np.sort(sel), device=dev)
        hh = llama_mod.apply_exit_adapter(adapter, h_d[sel], eps)
        hh = llama_mod._rms_norm(hh, params["final_ln"], eps)
        logp = torch.log_softmax(
            (hh @ params["lm_head"])[..., :V].to(torch.float32), -1)
        flat = (scores[sel][..., None] + logp).reshape(-1, B * V)
        idx = selb[sel] * V + selt[sel]  # (n, B)
        ce = -torch.log_softmax(flat, -1).gather(-1, idx).mean()
        top = torch.sort(flat.detach(), dim=-1, descending=True,
                         stable=True).indices[:, :B]
        match = (torch.sort(top, -1).values
                 == torch.sort(idx, -1).values).all(-1)
        return ce, match.to(torch.float32).mean()

    return _fit(_init(cfg, rank, key, dev), lr, steps, log_every, loss_at)


def save_adapter(path: str, adapter: Adapter, d: int) -> None:
    """An ``.npz`` with the draft depth in it (``load_adapter`` checks
    it)."""
    np.savez(
        path,
        **{k: adapter[k].detach().to("cpu", torch.float32).numpy()
           for k in ("ln", "w1", "w2")},
        draft_layers=np.int32(d),
    )


def load_adapter(path: str, expect_d: Optional[int] = None, dtype=None,
                 device="cpu") -> Adapter:
    """Load an adapter ``.npz``; refuse one distilled for another draft
    depth than ``expect_d``."""
    z = np.load(path)
    d = int(z["draft_layers"])
    if expect_d is not None and d != expect_d:
        raise ValueError(
            f"adapter {path} was distilled for draft_layers={d}, but the "
            f"decoder is configured with draft_layers={expect_d}"
        )
    out = {k: torch.as_tensor(np.asarray(z[k]), device=device)
           for k in ("ln", "w1", "w2")}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out
