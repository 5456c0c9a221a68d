"""Quantized weights and the dispatching matmul; port of
``infinisst_tpu/models/quant.py``.

Leaf layouts (told apart by key, as in the JAX package):
  {'q', 'scale'}     weight-only int8 -> ``w8_bf16_gemm``;
  {'q', 'scale_a8'}  W8A8 with a 1-D per-out-channel scale -> row quant +
                     ``w8a8_gemm``; a 2-D (grouped) scale is not ported
                     yet and raises;
  {'a', 'b'}         low-rank factors, two chained ``mm`` calls.
"""

from __future__ import annotations

import math

import torch

from infinisst_tpu_torch.kernels.quant_matmul import (
    quantized_matmul_w8a8,
    w8_bf16_gemm,
)


def is_quantized(w) -> bool:
    return isinstance(w, dict) and "q" in w


def mm(y: torch.Tensor, w) -> torch.Tensor:
    """y @ w for plain, low-rank or quantized weights; y (..., D)."""
    if isinstance(w, dict) and "a" in w:
        return mm(mm(y, w["a"]), w["b"])
    if not is_quantized(w):
        return y @ w
    shape = y.shape
    y2 = y.reshape(-1, shape[-1]).contiguous()
    if "scale_a8" in w:
        if w["scale_a8"].ndim == 2:
            raise NotImplementedError(
                "grouped W8A8 (2-D scale_a8) is not ported yet"
            )
        out = quantized_matmul_w8a8(y2, w["q"], w["scale_a8"])
    else:
        out = w8_bf16_gemm(y2, w["q"], w["scale"])
    return out.reshape(*shape[:-1], out.shape[-1])


def init_quantized_llama(
    cfg, generator: torch.Generator, device="cuda", embed_dtype=torch.bfloat16,
    act_int8=False, lm_head_int8=False,
):
    """Random int8 Llama parameters made directly on ``device``: stacked
    int8 projections with constant scales 1 / (127 sqrt(in)) (as
    ``quant.py:177-186``), ones for the norms, a normal embedding, and
    either an int8 W8A8 lm_head padded to a multiple of 512 columns (pad
    scales zero) or a float one.  ``generator`` must live on ``device``."""
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
        return {
            "q": randint8((L,) + shape),
            skey: torch.full((L, shape[-1]), sval, dtype=torch.float32,
                             device=device),
        }

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
        scale = torch.full((Vp,), 1.0 / (127 * math.sqrt(D)),
                           dtype=torch.float32, device=device)
        scale[V:] = 0.0
        lm_head = {"q": randint8((D, Vp)), "scale_a8": scale}
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
