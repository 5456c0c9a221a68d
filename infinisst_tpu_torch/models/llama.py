"""Llama-3/3.1 decoder with GQA and a streaming unrotated-key KV cache;
port of ``infinisst_tpu/models/llama.py``.

Keys are stored unrotated and rotated after retrieval with cache-relative
positions.  The layer stack is a Python loop over stacked parameters; the
KV cache is updated in place where the JAX package donates its buffers.

Prefill attention (``decode_step``) is written out as matmul, additive
mask and f32 softmax, as the JAX einsums are; the beam step's two-block
attention is one launch of the rotate-on-read ``beam_attention`` kernel.
Both take the AlignAtt attention probe ``attn_probe = (layer, a0, a1)``:
the argmax over keys a0..a1-1 of the head-averaged softmax weights at one
layer (``span_probe`` for the beam step, whose kernel keeps no weights).
Projections and the lm_head go through ``quant.mm``; q/k/v and gate/up,
which share their input, through ``quant.mm_many``, which quantizes that
input once.  Where those weights are W8A8 of one layout
(``quant.a8_group_size``), the residual add moves into the next norm and
the quantizer into the kernel that makes its input: the o and down
projections' outputs are the ``delta`` of the norm after them, which
``rms_norm_quant_int8`` adds, normalises and quantizes in one launch
(``_norm_mm``), and the SwiGLU product is ``silu_mul_quant_int8``'s
(``_silu_mm``); only the attention output keeps a quantizer of its own.
A W8A8 forward of L layers then launches ``rms_norm_quant_int8`` 2L + 1
times, ``silu_mul_quant_int8`` L times and ``row_quant_int8`` (or
``group_quant_int8``) L times.  Other layouts keep ``_rms_norm`` and
``mm_many`` with the same adds in the same order.

The training forward (``offline_forward``, ``offline_hidden``) is plain
causal attention over the whole sequence, no cache, with plain matrix
products on float leaves (no kernel, as in the JAX package), and
``remat`` checkpoints each layer.

For the speculative decoders: a draft's parameters may carry an
``exit_adapter`` (``apply_exit_adapter``, before ``final_ln``), and
``beam_tree_step`` verifies a drafted beam tree in one forward (its
prefix block through ``decode_attention``).

Under tensor parallelism (``parallel.collectives.tensor_parallel``) each
rank holds a block of the query and KV heads and of the FFN columns
(``parallel/mesh.py``): the functions read the local head counts from
the leaves' shapes, put f (``copy_to_model``) before the q/k/v and
gate/up products and g (``reduce_from_model``) after wo and w_down, and
keep the residual stream whole on every rank; the caches hold the
rank's KV heads.  The embedding, split on D, is gathered; the lm_head is
column- or row-parallel as its sanitised layout says
(``collectives.head_logits``).

Under FSDP (the 'data' axis with ``zero``) a leaf is a shard of its
'data' dim: each layer is gathered where the loop slices it
(``layer_params``; inside the checkpointed function under remat, so
that only the shards are kept for the backward and the replay gathers
again), the embedding, final norm and lm_head where they are used.

Parameters (dict of tensors, (in, out) matrices, layers stacked on dim 0):
  embed (V, D); layers: input_ln, post_ln (L, D), wq (L, D, H*Dh),
  wk/wv (L, D, KV*Dh), wo (L, H*Dh, D), w_gate/w_up (L, D, I),
  w_down (L, I, D); final_ln (D,); lm_head (D, V)
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from infinisst_tpu_torch.core import masks as M
from infinisst_tpu_torch.core import rope as R
from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.core.graphs import counter
from infinisst_tpu_torch.kernels.decode_attention import (
    beam_attention,
    decode_attention,
    merge_blocks,
)
from infinisst_tpu_torch.models import quant as Q
from infinisst_tpu_torch.models.quant import mm, mm_many, out_features
from infinisst_tpu_torch.parallel import collectives as par
from infinisst_tpu_torch.streaming.state import DecoderState

Params = Dict[str, Any]

# forward passes by function and depth, e.g. "decode_step L=32": the bench
# reports them, so that each kernel's launches can be held to the forwards
# that made them (registered with ``core.graphs``: replays count too)
forward_counts: Dict[str, int] = counter({})


def _count_forward(fn: str, num_layers: int):
    key = f"{fn} L={num_layers}"
    forward_counts[key] = forward_counts.get(key, 0) + 1


def _rms_norm(x, scale, eps):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def apply_exit_adapter(adapter: Params, h: torch.Tensor, eps: float):
    """The distilled early-exit adapter of the speculative draft (port of
    the JAX ``apply_exit_adapter``): h + w2 silu(w1 rmsnorm(h)), on the
    hidden state before ``final_ln``.  Its ``w2`` starts at zero, so an
    untrained adapter is the identity.  {'ln': (D,), 'w1': (D, r),
    'w2': (r, D)}."""
    y = _rms_norm(h, adapter["ln"], eps)
    y = Q.silu(mm(y, adapter["w1"]))
    return h + mm(y, adapter["w2"]).to(h.dtype)


def _norm_mm(h, delta, scale, eps, ws):
    """h' = h + delta (delta None: h), then y @ w for w in ``ws`` with
    y = rmsnorm(h') by ``scale``: in one ``rms_norm_quant_int8`` launch
    and the products on its quantized rows where every leaf is W8A8 of
    one layout, else ``_rms_norm`` and ``mm_many``.  Returns (h',
    outputs)."""
    D = h.shape[-1]
    gs = Q.a8_group_size(ws, D)
    if delta is not None and (gs is None or delta.dtype != h.dtype):
        h, delta = h + delta, None
    if gs is None:
        return h, mm_many(par.copy_to_model(_rms_norm(h, scale, eps)), ws)
    h2, y_q, y_s = Q.rms_norm_quant_int8(
        h.reshape(-1, D).contiguous(),
        None if delta is None else delta.reshape(-1, D).contiguous(),
        scale, eps, gs)
    return (h2.reshape(h.shape),
            Q.mm_many_quantized(y_q, y_s, ws, h.dtype, h.shape[:-1]))


def _silu_mm(gate, up, w):
    """silu(gate) * up @ w: one ``silu_mul_quant_int8`` launch and the
    product on its quantized rows where ``w`` is W8A8, else the product in
    torch and ``mm``."""
    D = gate.shape[-1]
    gs = Q.a8_group_size((w,), D)
    if gs is None or up.dtype != gate.dtype:
        return mm(Q.silu(gate) * up, w)
    y_q, y_s = Q.silu_mul_quant_int8(gate.reshape(-1, D).contiguous(),
                                     up.reshape(-1, D).contiguous(), gs)
    return Q.mm_many_quantized(y_q, y_s, (w,), gate.dtype,
                               gate.shape[:-1])[0]


def _final_logits(params: Params, cfg: LlamaConfig, h, delta=None):
    """The last residual add (``delta``), the exit adapter (only on a
    draft's parameters, which carry ``exit_adapter``), ``final_ln`` and
    the lm_head: ``final_ln`` and a W8A8 head in one
    ``rms_norm_quant_int8`` launch and the head's product."""
    eps = cfg.rms_norm_eps
    if "exit_adapter" in params:
        if delta is not None:
            h, delta = h + delta, None
        h = apply_exit_adapter(params["exit_adapter"], h, eps)
    head = par.unshard(params["lm_head"])
    ln = par.unshard(params["final_ln"])
    if Q.a8_group_size((head,), h.shape[-1]) is not None:
        return _norm_mm(h, delta, ln, eps, (head,))[1][0]
    if delta is not None:
        h = h + delta
    return par.head_logits(_rms_norm(h, ln, eps), head, cfg.vocab_size, mm)


def local_heads(layers: Params, cfg: LlamaConfig) -> Tuple[int, int]:
    """(query heads, KV heads) of the stacked ``layers`` as this rank
    holds them (all of them on one card; H/n and KV/n under tensor
    parallelism), read from the projections' shapes."""
    return (par.split_width(out_features(layers["wq"]) // cfg.head_dim,
                            cfg.num_heads, "llama query heads"),
            par.split_width(out_features(layers["wk"]) // cfg.head_dim,
                            cfg.num_kv_heads, "llama KV heads"))


def _head_mean(w: torch.Tensor, dims, n_local: int) -> torch.Tensor:
    """The mean of the attention weights over every head; under tensor
    parallelism the local heads' sum is summed over 'model'."""
    if par.model_size() == 1:
        return w.mean(dim=dims)
    n = n_local * par.model_size()
    return par.reduce_from_model(w.sum(dim=dims)) / n


@functools.lru_cache(maxsize=None)
def rope_inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    """The inverse frequencies on ``device``, uploaded once per (config,
    device): a blocking copy from host memory in every forward would make
    the host wait for the work queued before it."""
    f = R.llama_rope_freqs(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
        cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
        cfg.rope_high_freq_factor, cfg.rope_original_max_position,
    )
    return torch.tensor(f, dtype=torch.float32, device=device)


def layer_params(layers: Params, i: int, gather: bool = True) -> Params:
    """Layer ``i`` of the stacked parameters (quantized leaves included),
    its 'data' shards gathered (``gather``; else marked shards, for a
    checkpointed layer to gather)."""
    def one(v):
        s = par.layer_slice(v, i)
        return par.unshard(s) if gather else s

    return {
        k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
            else one(v))
        for k, v in layers.items()
    }


def _mlp(h, delta, lp, eps):
    """The attention's residual add (``delta``), ``post_ln`` and the
    SwiGLU MLP: returns (h + delta, the MLP's output), which the next
    norm adds."""
    h, (gate, up) = _norm_mm(h, delta, lp["post_ln"], eps,
                             (lp["w_gate"], lp["w_up"]))
    return h, par.reduce_from_model(_silu_mm(gate, up, lp["w_down"]))


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    state: DecoderState,
    x_embed: torch.Tensor,  # (B, S, D) input embeddings
    valid_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = real token
    attn_probe: Optional[Tuple[int, int, int]] = None,
):
    """Forward S new positions against the cache and append their K/V.

    Cached entry j has RoPE position j; new query i has valid_len + i.
    The S new K/V rows are written IN PLACE into ``state.k`` / ``state.v``
    at valid_len (where the JAX step donates the cache), so the returned
    state shares its buffers with ``state``.  Returns (logits (B, S, V),
    new state), and with ``attn_probe = (layer, a0, a1)`` also the (B, S)
    probe: at layer ``layer % L``, the argmax over the new block's keys
    a0..a1-1 of the softmax weights (in the cache dtype, as the JAX step
    casts them) averaged over the heads.

    The JAX step slices the weights at a0:a1 of [cache (C) | new (S)], so
    on a fresh cache it reads the masked cache block and returns 0 on
    every row; the port slices C + a0 : C + a1, the prompt's own span
    (ROADMAP §3)."""
    B, S, D = x_embed.shape
    C = state.k.shape[2]
    H, KV = local_heads(params["layers"], cfg)
    Dh = cfg.head_dim
    dev = x_embed.device
    inv_freq = rope_inv_freq(cfg, dev)
    vlen = state.valid_len.to(dev)  # (B,)

    qi = torch.arange(S, device=dev)[None, :, None]
    kj = torch.arange(C + S, device=dev)[None, None, :]
    mask = torch.where(kj < C, kj < vlen[:, None, None], (kj - C) <= qi)
    if valid_mask is not None:
        new_ok = torch.cat(
            [torch.ones((B, C), dtype=torch.bool, device=dev),
             valid_mask.to(torch.bool)], dim=1,
        )
        mask = mask & new_ok[:, None, :]
    bias = M.additive(mask)[:, None, None]  # (B, 1, 1, S, C+S)

    ar_s = torch.arange(S, device=dev)[None]
    k_pos = torch.cat(
        [torch.arange(C, device=dev)[None].expand(B, C), vlen[:, None] + ar_s],
        dim=1,
    )  # (B, C+S)
    q_pos = vlen[:, None] + ar_s  # (B, S)
    scale = 1.0 / math.sqrt(Dh)
    # dynamic_update_slice semantics: a negative start counts from the end,
    # then it is clamped to [0, C - S] so S rows fit; the rows are indexed
    # on the device (no host read)
    start = torch.where(vlen < 0, vlen + C, vlen)
    rows_at = (torch.clamp(start, min=0, max=C - S)[:, None] + ar_s,)
    rows_at = (torch.arange(B, device=dev)[:, None],) + rows_at
    probe_layer = None if attn_probe is None else \
        attn_probe[0] % cfg.num_layers
    _count_forward("decode_step", cfg.num_layers)

    h, delta = x_embed, None
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h, (q, k_new, v_new) = _norm_mm(h, delta, lp["input_ln"],
                                        cfg.rms_norm_eps,
                                        (lp["wq"], lp["wk"], lp["wv"]))
        q = q.reshape(B, S, H, Dh)
        k_new = k_new.reshape(B, S, KV, Dh)
        v_new = v_new.reshape(B, S, KV, Dh)
        ck, cv = state.k[li], state.v[li]
        k_all = torch.cat([ck, k_new.to(ck.dtype)], dim=1)  # (B, C+S, KV, Dh)
        v_all = torch.cat([cv, v_new.to(cv.dtype)], dim=1)

        qr = R.apply_llama_rope(q.transpose(1, 2), q_pos[:, None], inv_freq)
        kr = R.apply_llama_rope(k_all.transpose(1, 2), k_pos[:, None], inv_freq)
        vt = v_all.transpose(1, 2)  # (B, KV, C+S, Dh)
        qg = qr.reshape(B, KV, H // KV, S, Dh)
        logits = torch.einsum(
            "bkgsd,bktd->bkgst", qg.to(torch.float32), kr.to(torch.float32)
        )
        logits = logits * scale + bias
        w = torch.softmax(logits, dim=-1).to(vt.dtype)
        if li == probe_layer:
            span = _head_mean(w.to(torch.float32), (1, 2), H)[
                :, :, C + attn_probe[1]:C + attn_probe[2]]
            probe = torch.argmax(span, dim=-1)  # (B, S), first maximum
        attn = torch.einsum("bkgst,bktd->bkgsd", w, vt)
        attn = attn.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)
        h, delta = _mlp(h, par.reduce_from_model(mm(attn, lp["wo"])), lp,
                        cfg.rms_norm_eps)

        # in-place append of this layer's new K/V (the donated cache)
        state.k[li].index_put_(rows_at, k_new.to(state.k.dtype))
        state.v[li].index_put_(rows_at, v_new.to(state.v.dtype))

    logits = _final_logits(params, cfg, h, delta)[..., : cfg.vocab_size]
    n_append = (
        valid_mask.sum(-1).to(torch.int64) if valid_mask is not None
        else torch.full((B,), S, dtype=torch.int64, device=dev)
    )
    new_state = DecoderState(k=state.k, v=state.v, valid_len=vlen + n_append)
    if attn_probe is not None:
        return logits, new_state, probe
    return logits, new_state


def embed(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    # an id past the vocabulary takes the last row, as the JAX package's
    # gather clamps it (a stub tokenizer's ids over a small preset's vocab);
    # under tensor parallelism the table is split on D (n_model divides
    # the hidden size, mesh.check_tensor_parallel) and gathered
    table = par.unshard(params["embed"])
    return par.gather_from_model(
        table[token_ids.clamp(max=table.shape[0] - 1)], -1)


def offline_hidden(
    params: Params,
    cfg: LlamaConfig,
    x_embed: torch.Tensor,  # (B, S, D)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = real
    remat: bool = False,
    num_layers: Optional[int] = None,
) -> torch.Tensor:
    """The hidden state before ``final_ln`` after the first ``num_layers``
    layers (default: all), plain causal attention, no cache: the hidden
    the layer-skip draft sees at depth d.  Returns h (B, S, D)."""
    layers = params["layers"]
    if num_layers is not None:
        layers = {k: par.layer_slice(v, slice(None, num_layers))
                  for k, v in layers.items()}
    return _offline_scan(layers, cfg, x_embed, attention_mask, remat)


def offline_forward(
    params: Params,
    cfg: LlamaConfig,
    x_embed: torch.Tensor,  # (B, S, D)
    attention_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = real
    remat: bool = False,
) -> torch.Tensor:
    """Training forward: plain causal attention, no cache; ``remat``
    checkpoints each layer.  Returns logits (B, S, V)."""
    h = _offline_scan(params["layers"], cfg, x_embed, attention_mask, remat)
    h = _rms_norm(h, par.unshard(params["final_ln"]), cfg.rms_norm_eps)
    return par.head_logits(h, par.unshard(params["lm_head"]),
                           cfg.vocab_size, torch.matmul)


def _swiglu(y, w_gate, w_up):
    """The training forward's SwiGLU product on float leaves, as the JAX
    offline layer writes it: ``jax.nn.silu(y @ w_gate) * (y @ w_up)``."""
    return Q.silu(y @ w_gate) * (y @ w_up)


def _offline_layer(lp, cfg: LlamaConfig, h, bias, pos, inv_freq):
    lp = par.unshard_tree(lp)
    B, S, _ = h.shape
    H, KV = local_heads(lp, cfg)
    Dh = cfg.head_dim
    y = par.copy_to_model(_rms_norm(h, lp["input_ln"], cfg.rms_norm_eps))
    q = (y @ lp["wq"]).reshape(B, S, H, Dh)
    k = (y @ lp["wk"]).reshape(B, S, KV, Dh)
    v = (y @ lp["wv"]).reshape(B, S, KV, Dh)
    qr = R.apply_llama_rope(q.transpose(1, 2), pos[:, None], inv_freq)
    kr = R.apply_llama_rope(k.transpose(1, 2), pos[:, None], inv_freq)
    vt = v.transpose(1, 2)  # (B, KV, S, Dh)
    qg = qr.reshape(B, KV, H // KV, S, Dh)
    logits = torch.einsum(
        "bkgsd,bktd->bkgst", qg.to(torch.float32), kr.to(torch.float32)
    )
    logits = logits * (1.0 / math.sqrt(Dh)) + bias
    w = torch.softmax(logits, dim=-1).to(vt.dtype)
    attn = torch.einsum("bkgst,bktd->bkgsd", w, vt)
    attn = attn.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)
    h = h + par.reduce_from_model(attn @ lp["wo"])
    y = par.copy_to_model(_rms_norm(h, lp["post_ln"], cfg.rms_norm_eps))
    y = _swiglu(y, lp["w_gate"], lp["w_up"])
    return h + par.reduce_from_model(y @ lp["w_down"])


def _offline_scan(layers: Params, cfg: LlamaConfig, x_embed, attention_mask,
                  remat: bool):
    B, S, _ = x_embed.shape
    dev = x_embed.device
    i = torch.arange(S, device=dev)
    mask = (i[None, :] <= i[:, None])[None]  # (1, S, S) causal
    if attention_mask is not None:
        mask = mask & attention_mask.to(torch.bool)[:, None, :]
    # a row with no attended key (a padding row) stays finite: NEG_INF is
    # finite, so its softmax is uniform, never NaN
    bias = M.additive(mask)[:, None, None]  # (B, 1, 1, S, S)
    pos = i[None]
    inv_freq = rope_inv_freq(cfg, dev)
    h = x_embed
    for li in range(layers["wq"].shape[0]):
        lp = layer_params(layers, li, gather=False)
        args = (lp, cfg, h, bias, pos, inv_freq)
        h = (checkpoint(_offline_layer, *args, use_reentrant=False,
                        preserve_rng_state=False) if remat
             else _offline_layer(*args))
    return h


def span_probe(q, prefix_k, a0: int, a1: int, q_pos, inv_freq, lse):
    """The AlignAtt probe of one beam step, from the log-sum-exp of the
    whole softmax: rows' queries q (rows, H, Dh), unrotated, at q_pos
    (rows,); the prefix caches prefix_k (P, C, KV, Dh), unrotated, slot p
    read by rows p * rows / P onwards; lse (rows, H), float32.  Scores
    over the prefix keys a0..a1-1 (rotated at their positions, scaled by
    1/sqrt(Dh), in float32, as ``decode_attention_plain`` computes them),
    exponentiated less lse, averaged over the heads; returns the (rows,)
    argmax (the first maximum), an index into the span."""
    rows, H, Dh = q.shape
    P, _, KV, _ = prefix_k.shape
    dev = q.device
    qr = R.apply_llama_rope(
        q.to(torch.float32).reshape(rows, H, 1, Dh),
        q_pos.to(dev)[:, None, None], inv_freq,
    )[:, :, 0]
    pos = torch.arange(a0, a1, device=dev)
    kr = R.apply_llama_rope(
        prefix_k[:, a0:a1].transpose(1, 2).to(torch.float32),
        pos[None, None], inv_freq,
    )  # (P, KV, n, Dh)
    qg = qr.reshape(P, rows // P, KV, H // KV, Dh)
    s = (qg @ kr[:, None].transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    w = torch.exp(s.reshape(rows, H, a1 - a0) - lse[..., None])
    return torch.argmax(_head_mean(w, 1, H), dim=-1)


def beam_token_step(
    params: Params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # P prefix caches (L, P, C, KV, Dh), valid_len (P,)
    gen_k: torch.Tensor,  # (L, P * beam, G, KV, Dh) generated-token keys
    gen_v: torch.Tensor,
    gen_len,  # tokens generated so far (the same for every row): an int
    # or a () int tensor on the device (the captured beam loop's)
    x_embed: torch.Tensor,  # (P * beam, 1, D), the rows of slot p first
    attn_probe: Optional[Tuple[int, int, int]] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for all beams of P slots (the single stream is
    P = 1; pooled serving vmaps the JAX step over slots) over two
    attention blocks, the slot's prefix (one cache a slot, shared by its
    beams, never copied per beam) and the per-beam generation buffer, in
    the one softmax of the JAX step: one ``beam_attention`` launch a
    layer.  A row's query sits at its
    slot's prefix length + gen_len and its per-beam key j at that prefix
    length + j.  This step's K/V are written IN PLACE into ``gen_k`` /
    ``gen_v`` at slot ``gen_len`` (on the stream the kernel then reads
    them from).  Returns (logits (P * beam, V), gen_k, gen_v, attn_idx
    (P * beam,)): with ``attn_probe = (layer, a0, a1)`` (keys a0..a1-1 of
    the prefix) ``span_probe`` at that layer, from the launch's
    log-sum-exp, without a second pass over the keys; -1 without."""
    rows, S, D = x_embed.shape
    assert S == 1
    beam = rows // prefix.k.shape[1]
    H, KV = local_heads(params["layers"], cfg)
    Dh = cfg.head_dim
    dev = x_embed.device
    inv_freq = rope_inv_freq(cfg, dev)
    i32 = torch.int32
    plen = prefix.valid_len.to(device=dev, dtype=i32)  # (P,)
    # per-beam block: keys 0..gen_len valid, key j at position plen + j
    g_off = plen[:, None].expand(plen.shape[0], beam).reshape(rows) \
        .contiguous()
    at = gen_len.to(device=dev, dtype=torch.int64).reshape(1) \
        if torch.is_tensor(gen_len) else \
        torch.full((1,), gen_len, dtype=torch.int64, device=dev)
    g_valid = (at + 1).to(i32).repeat(rows)
    q_pos = g_off + at.to(i32)
    probe_layer = None if attn_probe is None else \
        attn_probe[0] % cfg.num_layers
    attn_idx = None
    _count_forward("beam_token_step", cfg.num_layers)

    h, delta = x_embed, None
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h, (q, k_new, v_new) = _norm_mm(h, delta, lp["input_ln"],
                                        cfg.rms_norm_eps,
                                        (lp["wq"], lp["wk"], lp["wv"]))
        q = q.reshape(rows, H, Dh)
        k_new = k_new.reshape(rows, KV, Dh)
        v_new = v_new.reshape(rows, KV, Dh)
        # in-place write of this step's K/V (the JAX step returns a copy)
        gen_k[li].index_copy_(1, at, k_new.to(gen_k.dtype)[:, None])
        gen_v[li].index_copy_(1, at, v_new.to(gen_v.dtype)[:, None])

        attn, lse = beam_attention(
            q, prefix.k[li], prefix.v[li], plen, gen_k[li], gen_v[li],
            g_valid, g_off, q_pos, inv_freq,
        )
        if li == probe_layer:
            attn_idx = span_probe(q, prefix.k[li], attn_probe[1],
                                  attn_probe[2], q_pos, inv_freq, lse)
        h, delta = _mlp(h, par.reduce_from_model(
            mm(attn.reshape(rows, 1, H * Dh), lp["wo"])), lp,
            cfg.rms_norm_eps)

    logits = _final_logits(params, cfg, h, delta)[:, 0, : cfg.vocab_size]
    if attn_idx is None:
        attn_idx = torch.full((rows,), -1, dtype=torch.int64, device=dev)
    return logits, gen_k, gen_v, attn_idx


def beam_tree_step(
    params: Params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # one cache (L, 1, C, KV, Dh), valid_len (1,)
    gen_k: torch.Tensor,  # (L, B, Gb, KV, Dh) committed per-beam keys
    gen_v: torch.Tensor,
    gen_len: int,  # committed tokens per beam
    x_embed: torch.Tensor,  # (N, D) tree-node embeddings
    node_pos: torch.Tensor,  # (N,) gen_len + level of each node
    tree_bias: torch.Tensor,  # (N, N) additive: 0 on a node's ancestors
    root: torch.Tensor,  # (N,) committed beam each node extends
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over a drafted beam tree of N (beam, level) nodes in
    one weight stream (the speculative beam decoder's verify; port of the
    JAX ``beam_tree_step``).  A node attends over three blocks, merged
    into one softmax: the shared prefix through ``decode_attention`` (N
    query rows against the one cache, with its log-sum-exp), and, as
    plain float32 with their own log-sum-exp, the committed per-beam
    buffer of the node's root (keys j < gen_len at prefix length + j)
    and the tree itself under ``tree_bias`` (each node's key at its own
    position).  Keys are unrotated, so a node's K/V can be committed by
    copy.  Returns (logits (N, V), k_tree (L, N, KV, Dh), v_tree)."""
    N, D = x_embed.shape
    H, KV = local_heads(params["layers"], cfg)
    Dh = cfg.head_dim
    Gq = H // KV
    dev = x_embed.device
    f32 = torch.float32
    inv_freq = rope_inv_freq(cfg, dev)
    plen = prefix.valid_len.to(device=dev, dtype=torch.int32)  # (1,)
    Gb = gen_k.shape[2]
    q_pos = (plen.to(torch.int64) + node_pos.to(dev)).to(torch.int32)
    root = root.to(device=dev, dtype=torch.int64)
    g_pos = plen.to(torch.int64) + torch.arange(Gb, device=dev)
    bias_g = torch.where(torch.arange(Gb, device=dev) < gen_len, 0.0,
                         M.NEG_INF).to(f32)
    bias_t = tree_bias.to(device=dev, dtype=f32)
    scale = 1.0 / math.sqrt(Dh)
    ks, vs = [], []
    _count_forward("beam_tree_step", cfg.num_layers)

    h, delta = x_embed[:, None], None
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        h, (q, k_new, v_new) = _norm_mm(h, delta, lp["input_ln"],
                                        cfg.rms_norm_eps,
                                        (lp["wq"], lp["wk"], lp["wv"]))
        q = q.reshape(N, H, Dh)
        k_new = k_new.reshape(N, KV, Dh)
        v_new = v_new.reshape(N, KV, Dh)
        ks.append(k_new)
        vs.append(v_new)
        o_p, lse_p = decode_attention(
            q, prefix.k[li], prefix.v[li], plen, q_pos, inv_freq,
            return_lse=True,
        )
        # the per-beam block by root and the tree block, in float32
        qr = R.apply_llama_rope(
            q.to(f32)[:, :, None], q_pos.to(torch.int64)[:, None, None],
            inv_freq,
        )[:, :, 0].reshape(N, KV, Gq, Dh)
        gk = gen_k[li][root].transpose(1, 2).to(f32)  # (N, KV, Gb, Dh)
        gv = gen_v[li][root].transpose(1, 2).to(f32)
        kr_g = R.apply_llama_rope(gk, g_pos[None, None], inv_freq)
        kr_t = R.apply_llama_rope(
            k_new.to(f32).transpose(0, 1),
            q_pos.to(torch.int64)[None], inv_freq,
        )  # (KV, N, Dh)
        s_g = torch.einsum("nkgd,nktd->nkgt", qr, kr_g) * scale + bias_g
        s_t = torch.einsum("nkgd,kmd->nkgm", qr, kr_t) * scale + \
            bias_t[:, None, None, :]
        s = torch.cat([s_g, s_t], dim=-1)
        lse = torch.logsumexp(s, dim=-1)
        w = torch.softmax(s, dim=-1)
        o = (torch.einsum("nkgt,nktd->nkgd", w[..., :Gb], gv)
             + torch.einsum("nkgm,kmd->nkgd", w[..., Gb:],
                            v_new.to(f32).transpose(0, 1)))
        attn = merge_blocks(o_p, lse_p, o.reshape(N, H, Dh),
                            lse.reshape(N, H))
        h, delta = _mlp(h, par.reduce_from_model(
            mm(attn.reshape(N, 1, H * Dh), lp["wo"])), lp, cfg.rms_norm_eps)

    logits = _final_logits(params, cfg, h, delta)[:, 0, : cfg.vocab_size]
    return logits, torch.stack(ks), torch.stack(vs)


def evict_cache(
    state: DecoderState,
    keep_len: torch.Tensor,  # (B,) tail length to keep
    sys_len,  # pinned prefix length (0 disables)
) -> DecoderState:
    """Chunk-granular eviction with a pinned system prompt: keeps
    cache[0:sys_len] ++ cache[valid-keep : valid], left-aligned, with
    valid_len = sys_len + keep_len.  One gather along the cache axis."""
    C = state.k.shape[2]
    dev = state.k.device
    vlen = state.valid_len.to(dev)
    keep_len = torch.as_tensor(keep_len, dtype=torch.int64, device=dev)
    sys_len = torch.as_tensor(sys_len, dtype=torch.int64, device=dev)
    sys_len = sys_len.expand(vlen.shape)
    j = torch.arange(C, device=dev)[None]
    idx = torch.where(
        j < sys_len[:, None],
        j,
        torch.clamp(j + (vlen - keep_len - sys_len)[:, None], 0, C - 1),
    )  # (B, C)
    bidx = torch.arange(vlen.shape[0], device=dev)[:, None]
    return DecoderState(
        k=state.k[:, bidx, idx],
        v=state.v[:, bidx, idx],
        valid_len=sys_len + keep_len,
    )


def init_params(
    cfg: LlamaConfig, generator: torch.Generator, device="cuda",
    dtype=torch.float32,
) -> Params:
    """Random float parameters (normal / sqrt(fan_in)), made on device."""
    D, I, L, V = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers, \
        cfg.vocab_size
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    def stacked(shape):
        return (normal((L,) + shape) / math.sqrt(shape[0])).to(dtype)

    layers = {
        "input_ln": torch.ones((L, D), dtype=dtype, device=device),
        "post_ln": torch.ones((L, D), dtype=dtype, device=device),
        "wq": stacked((D, H * Dh)),
        "wk": stacked((D, KV * Dh)),
        "wv": stacked((D, KV * Dh)),
        "wo": stacked((H * Dh, D)),
        "w_gate": stacked((D, I)),
        "w_up": stacked((D, I)),
        "w_down": stacked((I, D)),
    }
    return {
        "embed": (normal((V, D)) * 0.02).to(dtype),
        "layers": layers,
        "final_ln": torch.ones((D,), dtype=dtype, device=device),
        "lm_head": (normal((D, V)) / math.sqrt(D)).to(dtype),
    }
