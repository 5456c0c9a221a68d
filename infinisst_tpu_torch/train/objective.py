"""Training losses; port of ``infinisst_tpu/train/objective.py``.

- Shifted cross-entropy with IGNORE_INDEX masking
  (ref: model/llm.py:240-258).
- Optional CPO preference loss over win/lose pairs stacked in the batch
  (ref: model/llm.py:248-256).
- WACO contrastive alignment loss for speech-encoder pretraining
  (ref: model/speech_encoder.py:254-284).
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

IGNORE_INDEX = -100


def shifted_ce(
    logits: torch.Tensor,  # (B, S, V)
    labels: torch.Tensor,  # (B, S) with IGNORE_INDEX outside targets
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-sequence summed NLL and per-sequence target-token counts.

    Tokens < n predict n: logits[..., :-1, :] vs labels[..., 1:].  A
    target id past the vocabulary reads NaN, as JAX's gather fills it."""
    lg = logits[:, :-1].to(torch.float32)
    lb = labels[:, 1:].to(torch.int64)
    mask = lb != IGNORE_INDEX
    lb_safe = torch.where(mask, lb, 0)
    V = lg.shape[-1]
    logp = torch.log_softmax(lg, dim=-1)
    picked = torch.gather(logp, -1, lb_safe.clamp(max=V - 1)[..., None])[..., 0]
    picked = torch.where(lb_safe < V, picked, float("nan"))
    nll = torch.where(mask, -picked, 0.0)
    return nll.sum(-1), mask.sum(-1)


def lm_loss(
    logits: torch.Tensor,
    labels: torch.Tensor,
    cpo_beta: float = 0.0,
    total_count=None,
    total_pairs=None,
) -> torch.Tensor:
    """Mean NLL over target tokens; with cpo_beta > 0 the batch is read as
    [winners; losers] halves and the CPO sigmoid loss is added to the
    winners' NLL (ref: model/llm.py:248-256).

    A data rank of the sharded step passes the whole batch's target-token
    count (of the winners, with CPO) as ``total_count`` and its number of
    pairs as ``total_pairs``: the rank's loss is then its share of the
    whole batch's, and the ranks' losses (and gradients) sum to the one
    card's."""
    seq_nll, seq_cnt = shifted_ce(logits, labels)
    if cpo_beta > 0:
        bsz = labels.shape[0] // 2
        logp_w = -seq_nll[:bsz]
        logp_l = -seq_nll[bsz:]
        terms = -F.logsigmoid(cpo_beta * (logp_w - logp_l))
        cpo = terms.mean() if total_pairs is None else \
            terms.sum() / total_pairs
        cnt = seq_cnt[:bsz].sum() if total_count is None else total_count
        nll = seq_nll[:bsz].sum() / torch.clamp(cnt, min=1)
        return nll + cpo
    cnt = seq_cnt.sum() if total_count is None else total_count
    return seq_nll.sum() / torch.clamp(cnt, min=1)


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-8)


def waco_loss(
    speech_word_emb: torch.Tensor,  # (N, D) mean speech embedding per word
    text_word_emb: torch.Tensor,  # (N, D)
    temperature: float = 0.5,
) -> torch.Tensor:
    """Contrastive (InfoNCE over cosine similarity) word-level alignment
    loss (ref: model/speech_encoder.py:276-284)."""
    sim = _unit(speech_word_emb) @ _unit(text_word_emb).T / temperature
    logp = torch.log_softmax(sim, dim=-1)
    return -torch.diagonal(logp).mean()
