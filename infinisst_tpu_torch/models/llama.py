"""Llama-3/3.1 decoder with GQA and a streaming unrotated-key KV cache;
port of ``infinisst_tpu/models/llama.py`` (decode path).

Keys are stored unrotated and rotated after retrieval with cache-relative
positions.  The layer stack is a Python loop over stacked parameters; the
KV cache is updated in place where the JAX package donates its buffers.

Prefill attention (``decode_step``) is written out as matmul, additive
mask and f32 softmax, as the JAX einsums are; the beam step's two-block
attention goes through the rotate-on-read ``decode_attention`` kernel.
Projections and the lm_head go through ``quant.mm``; q/k/v and gate/up,
which share their input, through ``quant.mm_many``, which quantizes that
input once (4 activation quantizations per layer, not 7).

Parameters (dict of tensors, (in, out) matrices, layers stacked on dim 0):
  embed (V, D); layers: input_ln, post_ln (L, D), wq (L, D, H*Dh),
  wk/wv (L, D, KV*Dh), wo (L, H*Dh, D), w_gate/w_up (L, D, I),
  w_down (L, I, D); final_ln (D,); lm_head (D, V)
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch

from infinisst_tpu_torch.core import masks as M
from infinisst_tpu_torch.core import rope as R
from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.kernels.decode_attention import (
    decode_attention,
    merge_blocks,
)
from infinisst_tpu_torch.models.quant import mm, mm_many
from infinisst_tpu_torch.streaming.state import DecoderState

Params = Dict[str, Any]


def _rms_norm(x, scale, eps):
    xf = x.to(torch.float32)
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(x.dtype)


def rope_inv_freq(cfg: LlamaConfig, device) -> torch.Tensor:
    f = R.llama_rope_freqs(
        cfg.head_dim, cfg.rope_theta, cfg.rope_scaling,
        cfg.rope_scaling_factor, cfg.rope_low_freq_factor,
        cfg.rope_high_freq_factor, cfg.rope_original_max_position,
    )
    return torch.tensor(f, dtype=torch.float32, device=device)


def layer_params(layers: Params, i: int) -> Params:
    """Layer ``i`` of the stacked parameters (quantized leaves included)."""
    return {
        k: ({kk: vv[i] for kk, vv in v.items()} if isinstance(v, dict)
            else v[i])
        for k, v in layers.items()
    }


def _mlp(h, lp, eps):
    y = _rms_norm(h, lp["post_ln"], eps)
    gate, up = mm_many(y, (lp["w_gate"], lp["w_up"]))
    return h + mm(torch.nn.functional.silu(gate) * up, lp["w_down"])


def decode_step(
    params: Params,
    cfg: LlamaConfig,
    state: DecoderState,
    x_embed: torch.Tensor,  # (B, S, D) input embeddings
    valid_mask: Optional[torch.Tensor] = None,  # (B, S) 1 = real token
) -> Tuple[torch.Tensor, DecoderState]:
    """Forward S new positions against the cache and append their K/V.

    Cached entry j has RoPE position j; new query i has valid_len + i.
    The S new K/V rows are written IN PLACE into ``state.k`` / ``state.v``
    at valid_len (where the JAX step donates the cache), so the returned
    state shares its buffers with ``state``.  Returns (logits (B, S, V),
    new state)."""
    B, S, D = x_embed.shape
    C = state.k.shape[2]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
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
    # dynamic_update_slice semantics: the start is clamped so S rows fit
    starts = torch.clamp(vlen, max=C - S).tolist()

    h = x_embed
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        y = _rms_norm(h, lp["input_ln"], cfg.rms_norm_eps)
        q, k_new, v_new = mm_many(y, (lp["wq"], lp["wk"], lp["wv"]))
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
        attn = torch.einsum("bkgst,bktd->bkgsd", w, vt)
        attn = attn.reshape(B, H, S, Dh).transpose(1, 2).reshape(B, S, H * Dh)
        h = h + mm(attn, lp["wo"])
        h = _mlp(h, lp, cfg.rms_norm_eps)

        # in-place append of this layer's new K/V (the donated cache)
        for b, st in enumerate(starts):
            state.k[li, b, st : st + S] = k_new[b].to(state.k.dtype)
            state.v[li, b, st : st + S] = v_new[b].to(state.v.dtype)

    h = _rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    logits = mm(h, params["lm_head"])[..., : cfg.vocab_size]
    n_append = (
        valid_mask.sum(-1).to(torch.int64) if valid_mask is not None
        else torch.full((B,), S, dtype=torch.int64, device=dev)
    )
    return logits, DecoderState(k=state.k, v=state.v, valid_len=vlen + n_append)


def embed(params: Params, token_ids: torch.Tensor) -> torch.Tensor:
    return params["embed"][token_ids]


def beam_token_step(
    params: Params,
    cfg: LlamaConfig,
    prefix: DecoderState,  # batch 1, valid_len (1,)
    gen_k: torch.Tensor,  # (L, beam, G, KV, Dh) generated-token keys
    gen_v: torch.Tensor,
    gen_len: int,  # tokens generated so far (same for all beams)
    x_embed: torch.Tensor,  # (beam, 1, D)
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step for all beams over two attention blocks: the shared
    prefix (batch 1, never copied per beam) and the per-beam generation
    buffer, each through ``decode_attention`` and merged by their
    log-sum-exp into the one softmax of the JAX step.  This step's K/V are
    written IN PLACE into ``gen_k`` / ``gen_v`` at slot ``gen_len`` (on the
    stream the kernel then reads them from).  Returns (logits (beam, V),
    gen_k, gen_v, attn_idx (beam,) = -1: the attention probe is not
    ported)."""
    beam, S, D = x_embed.shape
    assert S == 1
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = x_embed.device
    inv_freq = rope_inv_freq(cfg, dev)
    i32 = torch.int32
    plen = prefix.valid_len.to(device=dev, dtype=i32)  # (1,)
    # per-beam block: keys 0..gen_len valid, key j at position plen + j
    g_valid = torch.full((beam,), gen_len + 1, dtype=i32, device=dev)
    g_off = plen.expand(beam).contiguous()
    q_pos = (plen + gen_len).expand(beam).contiguous()

    h = x_embed
    for li in range(cfg.num_layers):
        lp = layer_params(params["layers"], li)
        y = _rms_norm(h, lp["input_ln"], cfg.rms_norm_eps)
        q, k_new, v_new = mm_many(y, (lp["wq"], lp["wk"], lp["wv"]))
        q = q.reshape(beam, H, Dh)
        k_new = k_new.reshape(beam, KV, Dh)
        v_new = v_new.reshape(beam, KV, Dh)
        # in-place write of this step's K/V (the JAX step returns a copy)
        gen_k[li, :, gen_len] = k_new.to(gen_k.dtype)
        gen_v[li, :, gen_len] = v_new.to(gen_v.dtype)

        o_p, lse_p = decode_attention(
            q, prefix.k[li], prefix.v[li], plen, q_pos, inv_freq,
            return_lse=True,
        )
        o_g, lse_g = decode_attention(
            q, gen_k[li], gen_v[li], g_valid, q_pos, inv_freq,
            key_offset=g_off, return_lse=True,
        )
        attn = merge_blocks(o_p, lse_p, o_g, lse_g)
        h = h + mm(attn.reshape(beam, 1, H * Dh), lp["wo"])
        h = _mlp(h, lp, cfg.rms_norm_eps)

    h = _rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    logits = mm(h, params["lm_head"])[:, 0, : cfg.vocab_size]
    attn_idx = torch.full((beam,), -1, dtype=torch.int64, device=dev)
    return logits, gen_k, gen_v, attn_idx


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
