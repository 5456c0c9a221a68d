"""Quantized weights and the dispatching matmul; port of
``infinisst_tpu/models/quant.py``.

Leaf layouts (told apart by key and by the scale's rank, as in the JAX
package, plus one key of the port's own):
  {'q_kmajor', 'scale'}  weight-only int8, the weight K-major
                         (..., out, in) -> ``w8_bf16_gemm``;
  {'q_kmajor', 'scale_a8' (..., out)}
                         per-out-channel W8A8, the weight K-major
                         (..., out, in) -> row quant + ``w8a8_gemm``;
  {'q_kmajor', 'scale_a8' (..., G, out)}
                         W8A8 with a per-(input group, out-channel) scale
                         (the ``--group128`` belt), the weight K-major
                         (..., out, in) -> group quant +
                         ``w8a8_grouped_gemm``;
  {'a', 'b'}             low-rank factors, two chained ``mm`` calls.
The JAX package's {'q' (..., in, out), 'scale' or 'scale_a8'} leaves are
packed K-major once, where leaves are made (``pack_kmajor``: ``from_jax``,
``quantize_llama_params``, ``init_quantized_llama``), never per call; a
shape cannot tell a square weight from its transpose, hence the key.

``mm_many`` multiplies one activation by several weights and quantizes
it once per activation layout (q/k/v and gate/up share their input);
``mm`` is its one-weight case.  ``quantize_llama_params`` turns float
parameters into any of the int8 layouts; ``init_quantized_llama`` makes
random ones directly in int8.
"""

from __future__ import annotations

import math

import torch

from infinisst_tpu_torch.kernels.quant_matmul import (
    group_quant_int8,
    row_quant_int8,
    w8_bf16_gemm,
    w8a8_gemm,
    w8a8_grouped_gemm,
)

QUANT_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
KMAJOR = "q_kmajor"  # a packed int8 weight, (..., out, in)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or KMAJOR in w)


def is_unpacked(w) -> bool:
    """An int8 leaf in the JAX layout: weight-only {'q' (..., in, out),
    'scale'} or W8A8 {'q', 'scale_a8'}, per-channel or grouped."""
    return (isinstance(w, dict) and "q" in w
            and ("scale" in w or "scale_a8" in w))


def pack_kmajor(w):
    """{'q' (..., in, out), 'scale' or 'scale_a8'} -> {'q_kmajor' (...,
    out, in), same scale}: the layout ``w8_bf16_gemm``, ``w8a8_gemm`` and
    ``w8a8_grouped_gemm`` read.  One copy, made where the leaf is made;
    the input leaf can be dropped afterwards."""
    if not is_unpacked(w):
        raise ValueError("pack_kmajor: not an int8 {'q','scale'} or "
                         "{'q','scale_a8'} leaf")
    out = {KMAJOR: w["q"].transpose(-1, -2).contiguous()}
    out.update((k, v) for k, v in w.items() if k != "q")
    return out


def unpack_kmajor(w):
    """The inverse of ``pack_kmajor``: back to the JAX layout."""
    out = {"q": w[KMAJOR].transpose(-1, -2).contiguous()}
    out.update((k, v) for k, v in w.items() if k != KMAJOR)
    return out


def is_grouped(w) -> bool:
    """A packed W8A8 leaf with per-(input group, out-channel) scales: its
    ``scale_a8`` has the rank of ``q_kmajor`` ((G, out) against (out, in)
    per layer), a per-channel one a rank less."""
    return "scale_a8" in w and w["scale_a8"].ndim == w[KMAJOR].ndim


def out_features(w) -> int:
    """The output width of a weight in any layout: a float (..., in,
    out), a packed int8 {'q_kmajor' (..., out, in)}, a JAX-layout int8
    {'q' (..., in, out)} or low-rank factors {'a', 'b' (..., r, out)}."""
    if not isinstance(w, dict):
        return w.shape[-1]
    if KMAJOR in w:
        return w[KMAJOR].shape[-2]
    return (w["b"] if "b" in w else w["q"]).shape[-1]


def mm(y: torch.Tensor, w) -> torch.Tensor:
    """y @ w for plain, low-rank or quantized weights; y (..., D)."""
    return mm_many(y, (w,))[0]


def mm_many(y: torch.Tensor, ws) -> tuple:
    """(y @ w for w in ws), each as ``mm`` computes it, with y quantized
    once per activation layout: one ``row_quant_int8`` for all
    per-channel W8A8 leaves, one ``group_quant_int8`` per group size.  The
    quantization is a pure function of y, so the results are bitwise
    those of separate ``mm`` calls."""
    shape = y.shape
    y2, row_q, group_q, outs = None, None, {}, []
    for w in ws:
        if isinstance(w, dict) and "a" in w:
            outs.append(mm(mm(y, w["a"]), w["b"]))
            continue
        if not is_quantized(w):
            outs.append(y @ w)
            continue
        if is_unpacked(w):
            raise ValueError("mm: an int8 leaf in the (in, out) layout; "
                             "pack it once with pack_kmajor")
        if y2 is None:
            y2 = y.reshape(-1, shape[-1]).contiguous()
        if is_grouped(w):  # scale_a8 (G, out)
            gs = shape[-1] // w["scale_a8"].shape[0]
            if gs not in group_q:
                group_q[gs] = group_quant_int8(y2, gs)
            out = w8a8_grouped_gemm(*group_q[gs], w[KMAJOR], w["scale_a8"],
                                    y.dtype)
        elif "scale_a8" in w:
            if row_q is None:
                row_q = row_quant_int8(y2)
            out = w8a8_gemm(*row_q, w[KMAJOR], w["scale_a8"], y.dtype)
        else:
            out = w8_bf16_gemm(y2, w[KMAJOR], w["scale"])
        outs.append(out.reshape(*shape[:-1], out.shape[-1]))
    return tuple(outs)


def init_quantized_llama(
    cfg, generator: torch.Generator, device="cuda", embed_dtype=torch.bfloat16,
    act_int8=False, lm_head_int8=False, group_size=0, head_group_size=None,
):
    """Random int8 Llama parameters made directly on ``device``: stacked
    int8 projections with constant scales 1 / (127 sqrt(in)) (as
    ``quant.py:150-230``), ones for the norms, a normal embedding, and
    either an int8 W8A8 lm_head padded to a multiple of 512 columns (pad
    scales zero) or a float one.  Every int8 leaf is drawn in the JAX (in,
    out) layout and packed K-major at once (``pack_kmajor``), one leaf at
    a time (a transient copy of one leaf); the draw order is that of the
    unpacked layout.  ``group_size`` gives the projections per-(input
    group, out-channel) scales (L, in // group_size, out), W8A8 only;
    ``head_group_size`` (default 0: per-channel) groups the head.
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
        return pack_kmajor({"q": randint8((L,) + shape), skey: scale})

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
        lm_head = pack_kmajor({"q": randint8((D, Vp)), "scale_a8": scale})
        lm_head[KMAJOR][V:] = 0  # the pad rows
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
    with zero scales on the pad (grouped by ``head_group_size``).  Every
    int8 leaf comes out packed K-major (``pack_kmajor``).  Projection
    output widths must be multiples of 128."""
    if group_size and not act_int8:
        raise ValueError("group_size requires act_int8 (W8A8)")
    out = dict(params)
    layers = dict(params["layers"])
    for k in QUANT_KEYS:
        w = layers[k]
        if w.shape[-1] % 128 or (group_size and w.shape[1] % group_size):
            raise ValueError(f"{k}: shape {tuple(w.shape)} does not tile "
                             f"by 128 columns and groups of {group_size}")
        layers[k] = pack_kmajor(
            _quantize_stacked(w, a8=act_int8, group_size=group_size))
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
        out["lm_head"] = pack_kmajor({"q": q,
                                      "scale_a8": s.to(torch.float32)})
    return out
