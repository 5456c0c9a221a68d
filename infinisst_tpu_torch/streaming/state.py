"""Streaming state; port of ``infinisst_tpu/streaming/state.py``.

- ``EncoderState``: right-aligned sliding window of encoder K/V.  Appending
  a chunk of S frames drops the oldest S slots and writes the new S at the
  end; validity follows from ``n_frames``.
- ``DecoderState``: left-aligned LLM cache with an explicit ``valid_len``;
  appending writes at valid_len (in place, see ``llama.decode_step``).

Keys are stored unrotated in both caches; RoPE is applied at read time.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class EncoderState(NamedTuple):
    """k, v: (layers, batch, cache_frames, heads, head_dim), right-aligned:
    slot j holds absolute frame n_frames - (cache_frames - j).
    n_frames: (batch,) int64, frames consumed so far."""

    k: torch.Tensor
    v: torch.Tensor
    n_frames: torch.Tensor


def init_encoder_state(
    n_layers: int, batch: int, cache_frames: int, n_heads: int,
    head_dim: int, dtype=torch.bfloat16, device="cuda",
) -> EncoderState:
    shape = (n_layers, batch, cache_frames, n_heads, head_dim)
    return EncoderState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        n_frames=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


class DecoderState(NamedTuple):
    """k, v: (layers, batch, capacity, kv_heads, head_dim), left-aligned,
    unrotated keys.  valid_len: (batch,) int64 live entries."""

    k: torch.Tensor
    v: torch.Tensor
    valid_len: torch.Tensor


def init_decoder_state(
    n_layers: int, batch: int, capacity: int, n_kv_heads: int,
    head_dim: int, dtype=torch.bfloat16, device="cuda",
) -> DecoderState:
    shape = (n_layers, batch, capacity, n_kv_heads, head_dim)
    return DecoderState(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        valid_len=torch.zeros((batch,), dtype=torch.int64, device=device),
    )


class RawAudioWindow:
    """Host-side rolling raw-sample window feeding the conv frontend, of
    width CONV_LEFT_CONTEXT + 2 * chunk_samples.  Zero-initialised, so the
    first chunk needs no special case."""

    def __init__(self, window_samples: int, chunk_samples: int):
        self.window = np.zeros((window_samples,), np.float32)
        self.chunk_samples = chunk_samples

    def push(self, chunk: np.ndarray) -> np.ndarray:
        assert chunk.shape[0] == self.chunk_samples, (
            chunk.shape, self.chunk_samples,
        )
        self.window = np.concatenate(
            [self.window[self.chunk_samples :], chunk.astype(np.float32)]
        )
        return self.window

    def reset(self):
        self.window[:] = 0.0
