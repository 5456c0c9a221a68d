"""WACO speech-encoder pretraining: word-level contrastive alignment; port
of ``infinisst_tpu/train/waco.py``.

Mirror of the reference's standalone speech-encoder Lightning path
(model/speech_encoder.py:238-323): encode speech, mean-pool word-level
speech embeddings over MFA word spans (80 ms per speech token, ref
:265-267), mean-pool the matching LLM text embeddings (frozen), and
minimise the InfoNCE loss over the cosine-similarity matrix.

Word spans arrive via the TSV 'speech_word' / 'text_word' columns
(train/dataset.py:191-194); span counts vary per batch, so spans are
padded to a fixed maximum and masked.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from infinisst_tpu_torch.core.config import ModelConfig
from infinisst_tpu_torch.models import adapter as adapter_mod
from infinisst_tpu_torch.models import wav2vec2 as w2v2_mod

SPEECH_TOKEN_SEC = 0.08


@dataclass
class WacoBatch:
    speech: torch.Tensor  # (B, T) raw samples incl. offset
    frame_lengths: torch.Tensor  # (B,)
    text_ids: torch.Tensor  # (B, S)
    # word spans, padded to W per batch:
    speech_spans: torch.Tensor  # (B, W, 2) speech-token [start, end]
    text_spans: torch.Tensor  # (B, W, 2) text-token [start, end]
    span_mask: torch.Tensor  # (B, W) bool


def collate_waco(samples, model_cfg: ModelConfig, max_spans: int = 64):
    """The (speech spans, text spans, span mask) numpy arrays of
    SpeechToTextItems carrying speech_word / text_word spans (seconds /
    token indices, ref :259-267)."""
    B = len(samples)
    sp = np.zeros((B, max_spans, 2), np.int32)
    tp = np.zeros((B, max_spans, 2), np.int32)
    mask = np.zeros((B, max_spans), bool)
    for b, x in enumerate(samples):
        if not x.speech_word:
            continue
        for w, (s_span, t_span) in enumerate(
            zip(x.speech_word[:max_spans], x.text_word[:max_spans])
        ):
            s_l = int(np.floor(s_span[0] / SPEECH_TOKEN_SEC))
            s_r = int(np.ceil(s_span[1] / SPEECH_TOKEN_SEC)) - 1
            sp[b, w] = (s_l, max(s_r, s_l))
            tp[b, w] = (int(t_span[0]), int(t_span[1]))
            mask[b, w] = True
    return sp, tp, mask


def _pool(seq: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    """Mean of seq (B, L, D) over each span [l, r] inclusive of spans
    (B, W, 2) -> (B, W, D)."""
    idx = torch.arange(seq.shape[1], device=seq.device)[None, None]
    sel = (idx >= spans[..., 0:1]) & (idx <= spans[..., 1:2])  # (B, W, L)
    s = sel.to(seq.dtype) @ seq
    return s / torch.clamp(sel.sum(-1, keepdim=True), min=1)


def waco_step_fn(
    model_cfg: ModelConfig,
    block_frames: int,
    max_cache_frames: int,
    temperature: float = 0.5,
):
    """Returns loss_fn(params, llm_embed_table, batch); the LLM embeddings
    are an input, not trained (ref :123-125)."""

    def loss_fn(params, llm_embed, batch: WacoBatch):
        frames = w2v2_mod.forward(
            params["w2v2"], model_cfg.w2v2, batch.speech, block_frames,
            max_cache_frames, batch.frame_lengths,
        )
        speech = adapter_mod.forward(
            params["adapter"], model_cfg.adapter, frames
        )  # (B, P, D)
        text = llm_embed[batch.text_ids]  # (B, S, D)
        D = speech.shape[-1]
        sp_flat = _pool(speech, batch.speech_spans).reshape(-1, D)
        tx_flat = _pool(text, batch.text_spans).reshape(-1, D)
        flat_mask = batch.span_mask.reshape(-1)
        # masked InfoNCE: rows and columns of padded spans take a finite
        # -1e9 off the diagonal
        s = sp_flat / (torch.linalg.vector_norm(sp_flat, dim=-1,
                                                keepdim=True) + 1e-8)
        t = tx_flat / (torch.linalg.vector_norm(tx_flat, dim=-1,
                                                keepdim=True) + 1e-8)
        sim = (s @ t.T) / temperature
        valid = flat_mask[:, None] & flat_mask[None, :]
        eye = torch.eye(sim.shape[0], dtype=torch.bool, device=sim.device)
        sim = torch.where(valid | eye, sim, -1e9)
        logp = torch.log_softmax(sim, dim=-1)
        diag = torch.diagonal(logp)
        n = torch.clamp(flat_mask.sum(), min=1)
        return -(torch.where(flat_mask, diag, 0.0).sum() / n)

    return loss_fn
