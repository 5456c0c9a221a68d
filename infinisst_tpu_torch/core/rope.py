"""Rotary position embeddings applied at attention time over cache-relative
positions ("rotate on read"); port of ``infinisst_tpu/core/rope.py``.

- Encoder: interleaved pair convention (rotary_embedding_torch), theta
  10000, optional xPos decay.
- LLM: Llama half-split convention with Llama-3.1 frequency scaling; keys
  sit unrotated in the cache and are rotated after retrieval.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _interleaved_rotate(x: torch.Tensor) -> torch.Tensor:
    """(..., d) -> pairwise rotation partner: [-x1, x0, -x3, x2, ...]."""
    x2 = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    a, b = x2[..., 0], x2[..., 1]
    return torch.stack([-b, a], dim=-1).reshape(x.shape)


def encoder_rope_freqs(head_dim: int, theta: float = 10000.0) -> np.ndarray:
    """Per-pair inverse frequencies 1 / theta^(2i/d), i in [0, d/2)."""
    return 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )


def _broadcast_heads(t: torch.Tensor, ndim: int) -> torch.Tensor:
    # (..., seq, d) -> (..., 1, seq, d) until it has x's rank
    while t.ndim < ndim:
        t = t.unsqueeze(-3)
    return t


def apply_encoder_rope(
    x: torch.Tensor,
    positions: torch.Tensor,
    inv_freq: torch.Tensor,
    xpos_scale_base: float | None = None,
    xpos_downscale: bool = False,
) -> torch.Tensor:
    """Interleaved-convention RoPE.  x: (..., heads, seq, d); positions
    (..., seq); inv_freq (d/2,).  ``xpos_downscale`` is True for keys."""
    pos = positions.to(torch.float32)
    freqs = pos[..., None] * inv_freq.to(torch.float32)
    freqs = torch.repeat_interleave(freqs, 2, dim=-1)  # [f0, f0, f1, f1, ...]
    cos, sin = torch.cos(freqs), torch.sin(freqs)
    if xpos_scale_base is not None:
        d = inv_freq.shape[0] * 2
        r = (
            torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d
            + 0.4
        ) / 1.4
        scale = r ** (pos[..., None] / xpos_scale_base)
        scale = torch.repeat_interleave(scale, 2, dim=-1)
        if xpos_downscale:
            scale = 1.0 / scale
        cos = cos * scale
        sin = sin * scale
    cos = _broadcast_heads(cos, x.ndim)
    sin = _broadcast_heads(sin, x.ndim)
    xf = x.to(torch.float32)
    out = xf * cos + _interleaved_rotate(xf) * sin
    return out.to(x.dtype)


def llama_rope_freqs(
    head_dim: int,
    theta: float = 500000.0,
    scaling: bool = True,
    factor: float = 8.0,
    low_freq_factor: float = 1.0,
    high_freq_factor: float = 4.0,
    original_max_position: int = 8192,
) -> np.ndarray:
    """Inverse frequencies with optional Llama-3.1 NTK-by-parts scaling."""
    inv_freq = 1.0 / (
        theta ** (np.arange(0, head_dim, 2, dtype=np.float64) / head_dim)
    )
    if not scaling:
        return inv_freq
    low_freq_wavelen = original_max_position / low_freq_factor
    high_freq_wavelen = original_max_position / high_freq_factor
    wavelen = 2 * math.pi / inv_freq
    scaled = np.where(wavelen > low_freq_wavelen, inv_freq / factor, inv_freq)
    smooth = (original_max_position / wavelen - low_freq_factor) / (
        high_freq_factor - low_freq_factor
    )
    smoothed = (1 - smooth) * scaled / factor + smooth * scaled
    is_medium = (wavelen >= high_freq_wavelen) & (wavelen <= low_freq_wavelen)
    return np.where(is_medium, smoothed, scaled)


def _half_rotate(x: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_llama_rope(
    x: torch.Tensor, positions: torch.Tensor, inv_freq: torch.Tensor
) -> torch.Tensor:
    """Half-split-convention RoPE (HF Llama).  x: (..., seq, head_dim);
    positions broadcastable to (..., seq)."""
    pos = positions.to(torch.float32)
    freqs = pos[..., None] * inv_freq.to(torch.float32)
    emb = torch.cat([freqs, freqs], dim=-1)
    cos = _broadcast_heads(torch.cos(emb), x.ndim)
    sin = _broadcast_heads(torch.sin(emb), x.ndim)
    xf = x.to(torch.float32)
    out = xf * cos + _half_rotate(xf) * sin
    return out.to(x.dtype)
