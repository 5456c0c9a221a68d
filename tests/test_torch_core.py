"""The port's core pieces against the JAX package: both RoPE conventions,
the Llama-3.1 frequency table, the streaming masks, the configs, the
streaming state and the parameter converter."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core import config as JC
from infinisst_tpu.core import masks as JM
from infinisst_tpu.core import presets as JP
from infinisst_tpu.core import rope as JR
from infinisst_tpu.models import quant as JQ
from infinisst_tpu.streaming import state as JS
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.core import masks as TM
from infinisst_tpu_torch.core import presets as TP
from infinisst_tpu_torch.core import rope as TR
from infinisst_tpu_torch.streaming import state as TS

torch.set_num_threads(1)

# float32 on both sides; cos/sin and products may round one ulp apart
ROPE_TOL = dict(rtol=1e-5, atol=1e-5)


def test_configs_are_copies():
    assert dataclasses.asdict(TP.flagship_config()) == dataclasses.asdict(
        JP.flagship_config()
    )
    assert dataclasses.asdict(TC.tiny_model_config(512)) == dataclasses.asdict(
        JC.tiny_model_config(512)
    )
    s = TC.StreamConfig()
    assert dataclasses.asdict(s) == dataclasses.asdict(JC.StreamConfig())
    assert s.conv_window_samples(1) == JC.StreamConfig().conv_window_samples(1)


@pytest.mark.parametrize("xpos", [None, 512.0])
@pytest.mark.parametrize("downscale", [False, True])
def test_encoder_rope_matches_jax(xpos, downscale):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 4, 7, 16).astype(np.float32)
    pos = rng.randint(-5, 600, (2, 7)).astype(np.int32)
    inv = JR.encoder_rope_freqs(16)
    want = JR.apply_encoder_rope(jnp.asarray(x), jnp.asarray(pos),
                                 jnp.asarray(inv, jnp.float32), xpos, downscale)
    got = TR.apply_encoder_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                torch.tensor(TR.encoder_rope_freqs(16),
                                             dtype=torch.float32),
                                xpos, downscale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)


@pytest.mark.parametrize("scaling", [False, True])
def test_llama_rope_matches_jax(scaling):
    f_j = JR.llama_rope_freqs(128, scaling=scaling)
    f_t = TR.llama_rope_freqs(128, scaling=scaling)
    np.testing.assert_array_equal(f_t, f_j)
    rng = np.random.RandomState(1)
    x = rng.randn(3, 2, 5, 128).astype(np.float32)
    pos = rng.randint(0, 1300, (3, 1, 5)).astype(np.int32)
    want = JR.apply_llama_rope(jnp.asarray(x), jnp.asarray(pos),
                               jnp.asarray(f_j, jnp.float32))
    got = TR.apply_llama_rope(torch.from_numpy(x), torch.from_numpy(pos),
                              torch.tensor(f_t, dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ROPE_TOL)


@pytest.mark.parametrize("prefix", [0, 30, 96, 500, [0, 48, 700]])
def test_streaming_chunk_mask_matches_jax(prefix):
    S, cap, window, block = 48, 96, 96, 48
    want = JM.streaming_chunk_mask(S, jnp.asarray(prefix), window, block,
                                   cap + S)
    got = TM.streaming_chunk_mask(S, prefix, window, block, cap + S)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(
        TM.additive(got).numpy(), np.asarray(JM.additive(want))
    )


def test_state_initialisers():
    e = TS.init_encoder_state(2, 1, 96, 4, 16, torch.float32, "cpu")
    ej = JS.init_encoder_state(2, 1, 96, 4, 16, jnp.float32)
    assert tuple(e.k.shape) == ej.k.shape and e.n_frames.tolist() == [0]
    d = TS.init_decoder_state(2, 1, 256, 2, 16, torch.bfloat16, "cpu")
    assert tuple(d.v.shape) == (2, 1, 256, 2, 16)
    assert d.k.dtype == torch.bfloat16 and d.valid_len.tolist() == [0]
    w = TS.RawAudioWindow(10, 4)
    out = w.push(np.arange(4, dtype=np.float32))
    np.testing.assert_array_equal(out[-4:], np.arange(4))


def test_from_jax_layouts():
    cfg = JC.LlamaConfig(vocab_size=300, hidden_size=64, intermediate_size=96,
                         num_layers=2, num_heads=4, num_kv_heads=2,
                         head_dim=16, rope_scaling=False)
    p = JQ.init_quantized_llama(jax.random.PRNGKey(0), cfg, act_int8=True,
                                lm_head_int8=True)
    t = from_jax(jax.device_get(p), device="cpu")
    # per-channel W8A8 leaves are packed K-major: stacked, (out, in)
    wq = t["layers"]["wq"]
    assert set(wq) == {"q_kmajor", "scale_a8"}
    assert wq["q_kmajor"].dtype == torch.int8
    assert tuple(t["layers"]["w_down"]["q_kmajor"].shape) == (2, 64, 96)
    np.testing.assert_array_equal(
        wq["q_kmajor"].numpy(), np.swapaxes(np.asarray(p["layers"]["wq"]["q"]),
                                            -1, -2))
    assert t["layers"]["w_down"]["scale_a8"].dtype == torch.float32
    assert t["embed"].dtype == torch.bfloat16  # bf16 leaves survive
    np.testing.assert_array_equal(
        t["embed"].float().numpy(), np.asarray(p["embed"], np.float32)
    )
    head = t["lm_head"]
    # padded to a 512 multiple, then packed K-major (vocabulary rows)
    assert tuple(head["q_kmajor"].shape) == (512, 64)
    assert float(head["scale_a8"][300:].abs().sum()) == 0.0
    # an unpadded W8A8 head is padded with zero columns and zero scales
    raw = {"lm_head": {"q": np.ones((64, 300), np.int8),
                       "scale_a8": np.ones((300,), np.float32)}}
    pad = from_jax(raw, device="cpu")["lm_head"]
    assert tuple(pad["q_kmajor"].shape) == (512, 64)
    assert float(pad["q_kmajor"][300:].abs().sum()) == 0.0
    assert float(pad["q_kmajor"][:300].abs().sum()) == 300 * 64
    assert float(pad["scale_a8"][300:].abs().sum()) == 0.0
    assert raw["lm_head"]["q"].shape == (64, 300)  # the input is kept
    # weight-only leaves are packed K-major too, under their own scale key
    w8 = from_jax(jax.device_get(JQ.init_quantized_llama(
        jax.random.PRNGKey(1), cfg, act_int8=False)), device="cpu")
    wd = w8["layers"]["w_down"]
    assert set(wd) == {"q_kmajor", "scale"}
    assert tuple(wd["q_kmajor"].shape) == (2, 64, 96)
    assert tuple(wd["scale"].shape) == (2, 64)
    assert wd["scale"].dtype == torch.float32
    # float leaves may be cast on the way
    f = from_jax({"w": np.ones((2, 2), np.float32)}, device="cpu",
                 dtype=torch.bfloat16)
    assert f["w"].dtype == torch.bfloat16
