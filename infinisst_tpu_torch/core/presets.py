"""Model-size presets.

``flagship_config``: Llama-3.1-8B + wav2vec2-large, the reference system's
scale (the defaults of :class:`ModelConfig`).
"""

from __future__ import annotations

from infinisst_tpu_torch.core.config import ModelConfig


def flagship_config() -> ModelConfig:
    return ModelConfig()
