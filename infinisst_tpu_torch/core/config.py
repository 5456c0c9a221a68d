"""Configuration dataclasses (a copy of ``infinisst_tpu/core/config.py``,
trimmed to what the ported modules read).

Plain frozen dataclasses: hashable, serialisable, and identical in value to
the JAX package's, so a test can build both packages from one config.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# Samples per second of input audio.
SAMPLE_RATE = 16000
# One wav2vec2 conv-extractor frame covers 20 ms = 320 samples.
SAMPLES_PER_FRAME = 320
# Receptive field 400 samples: the first frame needs 399 samples of left
# context (79 + 320 zeros ahead of the first chunk).
CONV_LEFT_CONTEXT = 79 + 320
# One speech token after the 4x length adapter covers 80 ms.
FRAMES_PER_SPEECH_TOKEN = 4
# 960 ms chunk = 48 encoder frames = 12 speech tokens.
FRAMES_PER_BLOCK = 48


@dataclass(frozen=True)
class ConvLayerConfig:
    dim: int
    kernel: int
    stride: int


def conv_cfg(layers) -> Tuple[ConvLayerConfig, ...]:
    return tuple(ConvLayerConfig(*l) for l in layers)


# wav2vec2 feature extractor: 7 conv layers, total stride 320.
W2V2_CONV_LAYERS = conv_cfg(
    [(512, 10, 5)] + [(512, 3, 2)] * 4 + [(512, 2, 2)] * 2
)
# Length adapter: 2 conv layers, 4x temporal downsample.
LENGTH_SHRINK_LAYERS = conv_cfg([(1024, 2, 2)] * 2)


@dataclass(frozen=True)
class W2V2Config:
    """wav2vec2-large ("vox") speech encoder."""

    conv_layers: Tuple[ConvLayerConfig, ...] = W2V2_CONV_LAYERS
    # the released LV-60 "vox" checkpoints are trained with conv biases
    conv_bias: bool = True
    # 'layer_norm' = per-conv-layer LayerNorm (vox / large models)
    extractor_mode: str = "layer_norm"
    encoder_embed_dim: int = 1024
    encoder_layers: int = 24
    encoder_attention_heads: int = 16
    encoder_ffn_embed_dim: int = 4096
    layer_norm_first: bool = True
    activation: str = "gelu"
    use_rope: bool = True
    use_xpos: bool = False
    xpos_scale_base: int = 512

    @property
    def head_dim(self) -> int:
        return self.encoder_embed_dim // self.encoder_attention_heads


@dataclass(frozen=True)
class AdapterConfig:
    """Length adapter + projection into the LLM embedding space."""

    conv_layers: Tuple[ConvLayerConfig, ...] = LENGTH_SHRINK_LAYERS
    in_dim: int = 1024
    out_dim: int = 4096


@dataclass(frozen=True)
class LlamaConfig:
    """Llama-3/3.1 decoder config; defaults are Llama-3.1-8B-Instruct with
    the 7 added speech/latency tokens."""

    vocab_size: int = 128263
    hidden_size: int = 4096
    intermediate_size: int = 14336
    num_layers: int = 32
    num_heads: int = 32
    num_kv_heads: int = 8
    head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 500000.0
    rope_scaling: bool = True
    rope_scaling_factor: float = 8.0
    rope_low_freq_factor: float = 1.0
    rope_high_freq_factor: float = 4.0
    rope_original_max_position: int = 8192
    tie_word_embeddings: bool = False

    @property
    def num_kv_groups(self) -> int:
        return self.num_heads // self.num_kv_heads


@dataclass(frozen=True)
class SpecialTokens:
    """Llama-3/3.1 token ids used to build prompts and splice speech."""

    bos: int = 128000
    end_of_text: int = 128001
    eot: int = 128009
    eos: int = 128009
    start_header: int = 128006
    end_header: int = 128007
    pad: int = 128004
    user: int = 882
    assistant: int = 78191
    newline2: int = 271
    sp_patch: int = 128256
    sp_start: int = 128257
    sp_end: int = 128258
    latency: Tuple[int, int, int, int] = (128259, 128260, 128261, 128262)


@dataclass(frozen=True)
class StreamConfig:
    """Streaming runtime geometry."""

    block_frames: int = FRAMES_PER_BLOCK
    max_cache_frames: int = 576
    max_llm_cache_tokens: int = 1000
    llm_cache_capacity: int = 1280
    always_cache_system_prompt: bool = True
    max_multiplier: int = 4
    beam: int = 4
    max_new_tokens_per_mult: int = 10
    no_repeat_ngram_size: int = 5
    no_repeat_ngram_lookback: int = 100
    repetition_penalty: float = 1.2
    max_src_samples: int = 1_600_000

    def chunk_frames(self, multiplier: int) -> int:
        return self.block_frames * multiplier

    def chunk_samples(self, multiplier: int) -> int:
        return self.block_frames * multiplier * SAMPLES_PER_FRAME

    def chunk_speech_tokens(self, multiplier: int) -> int:
        return self.block_frames * multiplier // FRAMES_PER_SPEECH_TOKEN

    def conv_window_samples(self, multiplier: int) -> int:
        return CONV_LEFT_CONTEXT + 2 * self.chunk_samples(multiplier)

    def max_new_tokens(self, multiplier: int) -> int:
        return self.max_new_tokens_per_mult * multiplier


@dataclass(frozen=True)
class MeshConfig:
    """Device mesh layout.  data: the data-parallel axis (FSDP under
    ``zero``); model: the tensor-parallel axis."""

    data: int = 1
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


@dataclass(frozen=True)
class ModelConfig:
    """Top-level bundle for the speech-LLM."""

    w2v2: W2V2Config = field(default_factory=W2V2Config)
    adapter: AdapterConfig = field(default_factory=AdapterConfig)
    llama: LlamaConfig = field(default_factory=LlamaConfig)
    tokens: SpecialTokens = field(default_factory=SpecialTokens)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def tiny_model_config(vocab_size: int = 128263) -> ModelConfig:
    """A miniature config with the same structure, for tests."""
    return ModelConfig(
        w2v2=W2V2Config(
            conv_layers=W2V2_CONV_LAYERS,
            encoder_embed_dim=64,
            encoder_layers=2,
            encoder_attention_heads=4,
            encoder_ffn_embed_dim=128,
        ),
        adapter=AdapterConfig(
            conv_layers=conv_cfg([(64, 2, 2)] * 2), in_dim=64, out_dim=64
        ),
        llama=LlamaConfig(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_layers=2,
            num_heads=4,
            num_kv_heads=2,
            head_dim=16,
            rope_scaling=False,
        ),
    )
