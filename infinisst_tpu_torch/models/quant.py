"""Quantized weights and the dispatching matmul; port of
``infinisst_tpu/models/quant.py``.

Leaf layouts (told apart by key, as in the JAX package, plus one key of
the port's own):
  {'q', 'scale'}         weight-only int8 (in, out) -> ``w8_bf16_gemm``;
  {'q_kmajor', 'scale_a8'}
                         per-out-channel W8A8, the weight K-major
                         (..., out, in) -> row quant + ``w8a8_gemm``.  The
                         JAX package's {'q' (in, out), 'scale_a8' (out,)}
                         leaf is packed into it once, where leaves are made
                         (``pack_w8a8``: ``from_jax``,
                         ``quantize_llama_params``; ``init_quantized_llama``
                         makes it directly), never per call;
  {'q', 'scale_a8'}      with a per-(input group, out-channel) scale (the
                         ``--group128`` belt), (in, out) -> group quant +
                         ``w8a8_grouped_gemm``;
  {'a', 'b'}             low-rank factors, two chained ``mm`` calls.

``quantize_llama_params`` turns float parameters into any of the int8
layouts; ``init_quantized_llama`` makes random ones directly in int8.
"""

from __future__ import annotations

import math

import torch

from infinisst_tpu_torch.kernels.quant_matmul import (
    quantized_matmul_w8a8_grouped,
    quantized_matmul_w8a8_packed,
    w8_bf16_gemm,
)

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
KMAJOR = "q_kmajor"  # the packed per-channel W8A8 weight, (..., out, in)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or KMAJOR in w)


def is_unpacked_w8a8(w) -> bool:
    """A per-out-channel W8A8 leaf in the JAX layout: {'q' (..., in, out),
    'scale_a8' (..., out)} (a grouped scale has the rank of ``q``)."""
    return (isinstance(w, dict) and "q" in w and "scale_a8" in w
            and w["scale_a8"].ndim == w["q"].ndim - 1)


def pack_w8a8(w):
    """{'q' (..., in, out), 'scale_a8' (..., out)} -> {'q_kmajor' (..., out,
    in), 'scale_a8'}: the layout ``w8a8_gemm`` reads.  One copy, made where
    the leaf is made; the input leaf can be dropped afterwards."""
    if not is_unpacked_w8a8(w):
        raise ValueError("pack_w8a8: not a per-channel {'q','scale_a8'} leaf")
    return {KMAJOR: w["q"].transpose(-1, -2).contiguous(),
            "scale_a8": w["scale_a8"]}


def unpack_w8a8(w):
    """The inverse of ``pack_w8a8``: back to the JAX layout."""
    return {"q": w[KMAJOR].transpose(-1, -2).contiguous(),
            "scale_a8": w["scale_a8"]}


def mm(y: torch.Tensor, w) -> torch.Tensor:
    """y @ w for plain, low-rank or quantized weights; y (..., D)."""
    if isinstance(w, dict) and "a" in w:
        return mm(mm(y, w["a"]), w["b"])
    if not is_quantized(w):
        return y @ w
    shape = y.shape
    y2 = y.reshape(-1, shape[-1]).contiguous()
    if KMAJOR in w:
        out = quantized_matmul_w8a8_packed(y2, w[KMAJOR], w["scale_a8"])
    elif is_unpacked_w8a8(w):
        raise ValueError("mm: a per-channel W8A8 leaf in the (in, out) "
                         "layout; pack it once with pack_w8a8")
    elif "scale_a8" in w:
        out = quantized_matmul_w8a8_grouped(y2, w["q"], w["scale_a8"])
    else:
        out = w8_bf16_gemm(y2, w["q"], w["scale"])
    return out.reshape(*shape[:-1], out.shape[-1])


def init_quantized_llama(
    cfg, generator: torch.Generator, device="cuda", embed_dtype=torch.bfloat16,
    act_int8=False, lm_head_int8=False, group_size=0, head_group_size=None,
):
    """Random int8 Llama parameters made directly on ``device``: stacked
    int8 projections with constant scales 1 / (127 sqrt(in)) (as
    ``quant.py:150-230``), ones for the norms, a normal embedding, and
    either an int8 W8A8 lm_head padded to a multiple of 512 columns (pad
    scales zero) or a float one.  Per-channel W8A8 leaves are drawn in the
    JAX (in, out) layout and packed K-major at once (``pack_w8a8``), one
    leaf at a time (a transient copy of one leaf).  ``group_size`` gives
    the projections
    per-(input group, out-channel) scales (L, in // group_size, out), W8A8
    only; ``head_group_size`` (default 0: per-channel) groups the head.
    ``generator`` must live on ``device``."""
    if group_size and not act_int8:
        raise ValueError("group_size requires act_int8 (W8A8)")
    D, I = cfg.hidden_size, cfg.intermediate_size
    H, KV, Dh, L, V = (
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim, cfg.num_layers,
        cfg.vocab_size,
    )
    skey = "scale_a8" if act_int8 else "scale"

    def randint8(shape):
        return torch.randint(
            -127, 128, shape, generator=generator, device=device,
            dtype=torch.int8,
        )

    def qmat(shape):
        sval = 1.0 / (127 * math.sqrt(shape[0]))
        sshape = ((L, shape[0] // group_size, shape[-1]) if group_size
                  else (L, shape[-1]))
        scale = torch.full(sshape, sval, dtype=torch.float32, device=device)
        leaf = {"q": randint8((L,) + shape), skey: scale}
        if act_int8 and not group_size:  # per-channel W8A8: packed K-major
            return pack_w8a8(leaf)
        return leaf

    layers = {
        "input_ln": torch.ones((L, D), dtype=embed_dtype, device=device),
        "post_ln": torch.ones((L, D), dtype=embed_dtype, device=device),
        "wq": qmat((D, H * Dh)),
        "wk": qmat((D, KV * Dh)),
        "wv": qmat((D, KV * Dh)),
        "wo": qmat((H * Dh, D)),
        "w_gate": qmat((D, I)),
        "w_up": qmat((D, I)),
        "w_down": qmat((I, D)),
    }
    if lm_head_int8:
        Vp = ((V + 511) // 512) * 512
        sshape = (D // head_group_size, Vp) if head_group_size else (Vp,)
        scale = torch.full(sshape, 1.0 / (127 * math.sqrt(D)),
                           dtype=torch.float32, device=device)
        scale[..., V:] = 0.0
        lm_head = {"q": randint8((D, Vp)), "scale_a8": scale}
        if not head_group_size:  # per-channel: packed K-major, pad rows 0
            lm_head = pack_w8a8(lm_head)
            lm_head[KMAJOR][V:] = 0
    else:
        lm_head = torch.randn(
            (D, V), generator=generator, device=device, dtype=torch.float32
        ).to(embed_dtype) / math.sqrt(D)
    embed = torch.randn(
        (V, D), generator=generator, device=device, dtype=torch.float32
    ).mul_(0.02).to(embed_dtype)
    return {
        "embed": embed,
        "layers": layers,
        "final_ln": torch.ones((D,), dtype=embed_dtype, device=device),
        "lm_head": lm_head,
    }


def _div127(x):
    # a tensor divisor: on CUDA a Python scalar divisor is a multiply by its
    # reciprocal, not the IEEE quotient the JAX package computes
    return x / x.new_full((), 127.0)


def quantize_weight(w: torch.Tensor, axis: int = 0):
    """Symmetric per-out-channel int8 quantization of (..., in, out)
    weights (``kernels/quant_matmul.py:331``).  Returns (w_q int8, scale
    f32 over the out axis)."""
    wf = w.to(torch.float32)
    scale = torch.clamp(_div127(wf.abs().amax(dim=axis, keepdim=True)),
                        min=1e-8)
    w_q = torch.clamp(torch.round(wf / scale), -127, 127).to(torch.int8)
    return w_q, scale.squeeze(axis)


def _quantize_grouped(w2d: torch.Tensor, gs: int):
    """(D, O) -> int8 q (D, O) + per-(group, out-channel) scales
    (D // gs, O)."""
    D, O = w2d.shape
    wg = w2d.to(torch.float32).reshape(D // gs, gs, O)
    s = _div127(torch.clamp(wg.abs().amax(dim=1), min=1e-8))
    q = torch.clamp(torch.round(wg / s[:, None, :]), -127, 127)
    return q.to(torch.int8).reshape(D, O), s


def _quantize_stacked(w: torch.Tensor, a8=False, group_size=0):
    """(L, D, O) -> per (L, O) channel scales, or per (L, D // gs, O) group
    scales when ``group_size`` is set (W8A8 only)."""
    qs, ss = [], []
    for wi in w:
        q, s = (_quantize_grouped(wi, group_size) if group_size
                else quantize_weight(wi, axis=0))
        qs.append(q)
        ss.append(s.to(torch.float32))
    return {"q": torch.stack(qs),
            ("scale_a8" if a8 else "scale"): torch.stack(ss)}


def quantize_llama_params(params, quantize_lm_head=False, act_int8=False,
                          group_size=0, head_group_size=None):
    """Quantize the stacked projections (and optionally the lm_head) of
    float Llama parameters, as ``quant.py:233-276`` does: per-out-channel
    scales, or per-(input group, out-channel) scales with ``group_size``
    (W8A8 only); ``act_int8`` selects W8A8 for the projections, and the
    quantized head is always W8A8, padded to a multiple of 512 columns
    with zero scales on the pad (grouped by ``head_group_size``).
    Per-channel W8A8 leaves come out packed K-major (``pack_w8a8``).
    Projection output widths must be multiples of 128."""
    if group_size and not act_int8:
        raise ValueError("group_size requires act_int8 (W8A8)")
    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        w = layers[k]
        if w.shape[-1] % 128 or (group_size and w.shape[1] % group_size):
            raise ValueError(f"{k}: shape {tuple(w.shape)} does not tile "
                             f"by 128 columns and groups of {group_size}")
        layers[k] = _quantize_stacked(w, a8=act_int8, group_size=group_size)
        if act_int8 and not group_size:
            layers[k] = pack_w8a8(layers[k])
    out["layers"] = layers
    if quantize_lm_head:
        w = params["lm_head"]
        V = w.shape[-1]
        Vp = ((V + 511) // 512) * 512
        w = torch.nn.functional.pad(w, (0, Vp - V))
        if head_group_size:
            q, s = _quantize_grouped(w, head_group_size)
        else:
            q, s = quantize_weight(w, axis=0)
        s[..., V:] = 0.0
        head = {"q": q, "scale_a8": s.to(torch.float32)}
        out["lm_head"] = head if head_group_size else pack_w8a8(head)
    return out
