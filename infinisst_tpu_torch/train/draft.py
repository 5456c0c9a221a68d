"""The early-exit draft adapter of the speculative decoders, inference
half; port of ``infinisst_tpu/train/draft.py`` (``init_exit_adapter``,
``draft_logits``, ``save_adapter``, ``load_adapter``).

The adapter h -> h + w2 silu(w1 rmsnorm(h)) runs on the draft's hidden
state before ``final_ln`` (``models/llama.apply_exit_adapter``), on the
draft path only: the verify forward never sees it, so any adapter leaves
the speculative decoders exact and moves only their acceptance.  The
``.npz`` format is the JAX package's (arrays ``ln``, ``w1``, ``w2`` and
the draft depth ``draft_layers``), so an adapter distilled there loads
here.  Distillation itself needs the training forwards and is not ported
(ROADMAP item 13).
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.models import llama as llama_mod

Adapter = dict


def init_exit_adapter(generator: torch.Generator, cfg: LlamaConfig,
                      rank: Optional[int] = None, dtype=torch.float32,
                      device="cpu") -> Adapter:
    """A fresh adapter: ``w2`` zero, so it is the identity; ``w1`` normal
    / sqrt(D) from ``generator`` (on ``device``).  ``rank`` defaults to
    hidden_size / 2."""
    D = cfg.hidden_size
    r = rank or D // 2
    w1 = torch.randn((D, r), generator=generator, device=device,
                     dtype=torch.float32) / math.sqrt(D)
    return {
        "ln": torch.ones((D,), dtype=dtype, device=device),
        "w1": w1.to(dtype),
        "w2": torch.zeros((r, D), dtype=dtype, device=device),
    }


def draft_logits(params, cfg: LlamaConfig, adapter: Optional[Adapter],
                 h_d: torch.Tensor) -> torch.Tensor:
    """The draft's head over a layer-d hidden: adapter, final_ln,
    lm_head (the tail of ``llama.decode_step`` on a draft)."""
    h = h_d
    if adapter is not None:
        h = llama_mod.apply_exit_adapter(adapter, h, cfg.rms_norm_eps)
    h = llama_mod._rms_norm(h, params["final_ln"], cfg.rms_norm_eps)
    return h @ params["lm_head"]


def save_adapter(path: str, adapter: Adapter, d: int) -> None:
    """An ``.npz`` with the draft depth in it (``load_adapter`` checks
    it)."""
    np.savez(
        path,
        **{k: adapter[k].detach().to("cpu", torch.float32).numpy()
           for k in ("ln", "w1", "w2")},
        draft_layers=np.int32(d),
    )


def load_adapter(path: str, expect_d: Optional[int] = None, dtype=None,
                 device="cpu") -> Adapter:
    """Load an adapter ``.npz``; refuse one distilled for another draft
    depth than ``expect_d``."""
    z = np.load(path)
    d = int(z["draft_layers"])
    if expect_d is not None and d != expect_d:
        raise ValueError(
            f"adapter {path} was distilled for draft_layers={d}, but the "
            f"decoder is configured with draft_layers={expect_d}"
        )
    out = {k: torch.as_tensor(np.asarray(z[k]), device=device)
           for k in ("ln", "w1", "w2")}
    if dtype is not None:
        out = {k: v.to(dtype) for k, v in out.items()}
    return out
