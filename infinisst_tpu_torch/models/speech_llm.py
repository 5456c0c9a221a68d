"""Combined speech-LLM: chunked speech encoder -> adapter -> Llama
decoder, with speech embeddings spliced into the chat transcript; port of
the streaming functions of ``infinisst_tpu/models/speech_llm.py``.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Tuple

import torch

from infinisst_tpu_torch.core.config import ModelConfig
from infinisst_tpu_torch.models import adapter as adapter_mod
from infinisst_tpu_torch.models import llama as llama_mod
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod
from infinisst_tpu_torch.streaming.state import DecoderState, EncoderState

Params = Dict[str, Any]  # {'w2v2': ..., 'adapter': ..., 'llama': ...}


class StreamState(NamedTuple):
    encoder: EncoderState
    decoder: DecoderState


def encode_chunk(
    params: Params, cfg: ModelConfig, enc_state: EncoderState,
    window: torch.Tensor, chunk_frames: int, max_cache_frames: int,
    row_frames=None,
) -> Tuple[torch.Tensor, EncoderState]:
    """Raw-sample window -> (B, chunk_frames / 4, llm_dim) speech tokens.

    With ``row_frames`` (B,), rows carry different real chunk sizes (see
    ``wav2vec2.chunk_step``); the adapter is chunk-local with valid
    padding, so a row's first row_frames / 4 tokens do not see the padded
    tail."""
    frames, enc_state = w2v2_mod.chunk_step(
        params["w2v2"], cfg.w2v2, enc_state, window, chunk_frames,
        max_cache_frames, row_frames=row_frames,
    )
    return adapter_mod.forward(params["adapter"], cfg.adapter, frames), enc_state


def splice_speech(params: Params, ids: torch.Tensor, speech: torch.Tensor,
                  patch_start: int) -> torch.Tensor:
    """Embed ids (B, S) and overwrite the contiguous <sp_patch> span with
    speech (B, P, D); the start is clamped so the span fits, as
    ``dynamic_update_slice`` does."""
    emb = llama_mod.embed(params["llama"], ids)  # a fresh gather
    P = speech.shape[1]
    start = min(int(patch_start), emb.shape[1] - P)
    emb[:, start : start + P] = speech.to(emb.dtype)
    return emb


def prefill_chunk(
    params: Params, cfg: ModelConfig, state: StreamState,
    window: torch.Tensor, ids: torch.Tensor, patch_start: int,
    chunk_frames: int, max_cache_frames: int,
) -> Tuple[torch.Tensor, StreamState]:
    """Encode one chunk, splice it into the chunk's prompt and run the
    decoder prefill.  Returns (logits (B, S, V), new state)."""
    speech, enc_state = encode_chunk(
        params, cfg, state.encoder, window, chunk_frames, max_cache_frames
    )
    emb = splice_speech(params, ids, speech, patch_start)
    logits, dec_state = llama_mod.decode_step(
        params["llama"], cfg.llama, state.decoder, emb
    )
    return logits, StreamState(encoder=enc_state, decoder=dec_state)


def commit_tokens(
    params: Params, cfg: ModelConfig, dec_state: DecoderState,
    token_buf: torch.Tensor,  # (B, T) winning tokens, right-padded
    n_valid: torch.Tensor,  # (B,) number of real tokens
) -> DecoderState:
    """Append the winning tokens to the persistent cache by replaying them
    in one masked prefill."""
    emb = llama_mod.embed(params["llama"], token_buf)
    T = token_buf.shape[1]
    valid = (
        torch.arange(T, device=token_buf.device)[None] < n_valid[:, None]
    ).to(torch.int64)
    _, dec_state = llama_mod.decode_step(
        params["llama"], cfg.llama, dec_state, emb, valid_mask=valid
    )
    return dec_state
