"""Combined speech-LLM: chunked speech encoder -> adapter -> Llama
decoder, with speech embeddings spliced into the chat transcript; port of
``infinisst_tpu/models/speech_llm.py`` (the streaming functions and the
training forward).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

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


def offline_forward(
    params: Params,
    cfg: ModelConfig,
    samples: torch.Tensor,  # (B, T) raw audio, the zero offset included
    ids: torch.Tensor,  # (B, S)
    patch_mask: torch.Tensor,  # (B, S) bool: True where ids == sp_patch
    block_frames: int,
    max_cache_frames: int,
    frame_lengths: Optional[torch.Tensor] = None,
    attention_mask: Optional[torch.Tensor] = None,
    remat: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
    dropout_rate: float = 0.1,
) -> torch.Tensor:
    """Training / offline forward: the whole-utterance encoder with the
    training block mask, the speech spliced at the patch positions (ragged
    per row), the causal LLM forward.  Returns logits (B, S, V)."""
    emb = offline_spliced_embeddings(
        params, cfg, samples, ids, patch_mask, block_frames,
        max_cache_frames, frame_lengths, remat=remat,
        dropout_gen=dropout_gen, dropout_rate=dropout_rate,
    )
    return llama_mod.offline_forward(
        params["llama"], cfg.llama, emb, attention_mask, remat=remat
    )


def offline_spliced_embeddings(
    params: Params,
    cfg: ModelConfig,
    samples: torch.Tensor,
    ids: torch.Tensor,
    patch_mask: torch.Tensor,
    block_frames: int,
    max_cache_frames: int,
    frame_lengths: Optional[torch.Tensor] = None,
    remat: bool = False,
    dropout_gen: Optional[torch.Generator] = None,
    dropout_rate: float = 0.1,
) -> torch.Tensor:
    """The embedding stage of :func:`offline_forward`: encoder frames ->
    adapter -> the token embeddings with the j-th patch position of row b
    replaced by speech[b, j] (j clipped to P - 1, as in JAX)."""
    frames = w2v2_mod.forward(
        params["w2v2"], cfg.w2v2, samples, block_frames, max_cache_frames,
        frame_lengths, remat=remat, dropout_gen=dropout_gen,
        dropout_rate=dropout_rate,
    )
    speech = adapter_mod.forward(params["adapter"], cfg.adapter, frames)
    emb = llama_mod.embed(params["llama"], ids)
    B, P, D = speech.shape
    patch_mask = patch_mask.to(torch.bool)
    rank = torch.cumsum(patch_mask.to(torch.int64), dim=1) - 1
    idx = torch.clamp(rank, 0, P - 1)
    at = torch.gather(speech, 1, idx[:, :, None].expand(B, idx.shape[1], D))
    return torch.where(patch_mask[:, :, None], at.to(emb.dtype), emb)
