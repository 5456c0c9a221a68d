"""Model-size presets (a copy of ``infinisst_tpu/core/presets.py``).

- ``flagship_config``: Llama-3.1-8B + wav2vec2-large, the reference
  system's scale (the defaults of :class:`ModelConfig`).
- ``bench_1chip_config``: the same structure with a ~1.5B decoder
  (``bench --model bench``).
- ``dryrun_config``: a miniature whose head counts divide by 4 and whose
  special-token ids lie inside its 1024-entry vocabulary.
"""

from __future__ import annotations

from infinisst_tpu_torch.core.config import (
    AdapterConfig,
    LlamaConfig,
    ModelConfig,
    SpecialTokens,
    W2V2Config,
    conv_cfg,
)


def flagship_config() -> ModelConfig:
    return ModelConfig()


def bench_1chip_config() -> ModelConfig:
    return ModelConfig(
        adapter=AdapterConfig(out_dim=2048),
        llama=LlamaConfig(
            hidden_size=2048,
            intermediate_size=8192,
            num_layers=16,
            num_heads=16,
            num_kv_heads=8,
            head_dim=128,
        ),
    )


def dryrun_config() -> ModelConfig:
    return ModelConfig(
        w2v2=W2V2Config(
            encoder_embed_dim=128,
            encoder_layers=2,
            encoder_attention_heads=8,
            encoder_ffn_embed_dim=256,
        ),
        adapter=AdapterConfig(
            conv_layers=conv_cfg([(128, 2, 2)] * 2), in_dim=128, out_dim=128
        ),
        llama=LlamaConfig(
            vocab_size=1024,
            hidden_size=128,
            intermediate_size=256,
            num_layers=2,
            num_heads=8,
            num_kv_heads=4,
            head_dim=16,
            rope_scaling=False,
        ),
        # special-token ids inside the 1024 vocabulary (the Llama defaults
        # sit at 128000+)
        tokens=SpecialTokens(
            bos=1000, eot=1001, eos=1001, start_header=1002,
            end_header=1003, pad=1004, user=1005, assistant=1006,
            newline2=1007, sp_patch=1008, sp_start=1009, sp_end=1010,
            latency=(1011, 1012, 1013, 1014), end_of_text=999,
        ),
    )


PRESETS = {
    "flagship": flagship_config,
    "bench": bench_1chip_config,
    "dryrun": dryrun_config,
}
