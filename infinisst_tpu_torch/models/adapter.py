"""Length adapter + projection into the LLM embedding space; port of
``infinisst_tpu/models/adapter.py``.

Two conv blocks (conv -> LayerNorm -> GELU), kernel = stride = 2, give a
4x temporal downsample (20 ms frames -> 80 ms speech tokens), then a
linear projection.  Because kernel == stride the adapter is chunk-local
and needs no streaming state.

Under tensor parallelism the projection's weight and bias are split on
their output (``parallel/mesh.py``): each rank adds its bias block to its
columns and the output is gathered over 'model'.  Under FSDP its
leaves are gathered over 'data' once a forward.
"""

from __future__ import annotations

import math
from typing import Any, Dict

import torch
import torch.nn.functional as F

from infinisst_tpu_torch.core.config import AdapterConfig
from infinisst_tpu_torch.models.wav2vec2 import _gelu, _layer_norm
from infinisst_tpu_torch.parallel import collectives as par

Params = Dict[str, Any]


def forward(params: Params, cfg: AdapterConfig, x: torch.Tensor):
    """(B, frames, in_dim) -> (B, frames // 4, out_dim)."""
    params = par.unshard_tree(params)
    h = x.transpose(1, 2)  # (B, C, T)
    for lc, p in zip(cfg.conv_layers, params["conv"]):
        h = F.conv1d(h.to(p["w"].dtype), p["w"].permute(2, 1, 0),
                     stride=lc.stride)
        h = _gelu(_layer_norm(h.transpose(1, 2), p["ln_scale"],
                              p["ln_bias"])).transpose(1, 2)
    h = h.transpose(1, 2)
    w, b = params["proj"]["w"], params["proj"]["b"]
    if w.shape[-1] < cfg.out_dim:  # split over 'model'
        par.split_width(w.shape[-1], cfg.out_dim, "adapter proj columns")
        return par.gather_from_model(par.copy_to_model(h) @ w + b, -1)
    return h @ w + b


def out_length(cfg: AdapterConfig, length):
    """Speech tokens the adapter makes of ``length`` frames."""
    for lc in cfg.conv_layers:
        length = (length - lc.kernel) // lc.stride + 1
    return length


def init_params(cfg: AdapterConfig, generator: torch.Generator,
                device="cuda", dtype=torch.float32) -> Params:
    def normal(shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    conv = []
    in_d = cfg.in_dim
    for lc in cfg.conv_layers:
        w = normal((lc.kernel, in_d, lc.dim)) * math.sqrt(
            2.0 / (lc.kernel * in_d)
        )
        conv.append({
            "w": w.to(dtype),
            "ln_scale": torch.ones((lc.dim,), dtype=dtype, device=device),
            "ln_bias": torch.zeros((lc.dim,), dtype=dtype, device=device),
        })
        in_d = lc.dim
    proj = {
        "w": (normal((in_d, cfg.out_dim)) / math.sqrt(in_d)).to(dtype),
        "b": torch.zeros((cfg.out_dim,), dtype=dtype, device=device),
    }
    return {"conv": conv, "proj": proj}
