"""The port's speech side against the JAX package at ``tiny_model_config``
widths: the wav2vec2 streaming ``chunk_step`` over enough chunks that the
right-aligned encoder ring wraps, the length adapter, and the speech-LLM
glue (``encode_chunk``, ``splice_speech``, ``prefill_chunk``,
``commit_tokens``).

float32 on both sides; sums run in another order, so values agree to 1e-5
relative to the largest |reference| (1e-4 after the 2-layer encoder, the
adapter and a 2-layer decoder are chained: each LayerNorm divides by a
standard deviation and scales the relative error up).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core.config import CONV_LEFT_CONTEXT, tiny_model_config
from infinisst_tpu.models import adapter as JA
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import speech_llm as JSL
from infinisst_tpu.models import wav2vec2 as JW
from infinisst_tpu.streaming import state as JS
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core import config as TC
from infinisst_tpu_torch.models import adapter as TA
from infinisst_tpu_torch.models import speech_llm as TSL
from infinisst_tpu_torch.models import wav2vec2 as TW
from infinisst_tpu_torch.streaming import state as TS

torch.set_num_threads(1)

CFG = tiny_model_config(vocab_size=512)
TCFG = TC.tiny_model_config(vocab_size=512)
CHUNK = 15360  # one 960 ms chunk of samples
CACHE = 96  # encoder ring: wraps after two 48-frame chunks


def _close(got, want, tol):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


def _params():
    k = jax.random.PRNGKey(0)
    jp = {
        "w2v2": JW.init_params(jax.random.fold_in(k, 0), CFG.w2v2),
        "adapter": JA.init_params(jax.random.fold_in(k, 1), CFG.adapter),
        "llama": JL.init_params(jax.random.fold_in(k, 2), CFG.llama),
    }
    # non-zero biases and norm parameters, so every term is exercised
    rng = np.random.RandomState(9)
    jp = jax.tree.map(
        lambda a: a + jnp.asarray(rng.randn(*a.shape) * 0.05, a.dtype), jp
    )
    return jp, from_jax(jax.device_get(jp), device="cpu")


def _enc_states():
    w = CFG.w2v2
    js = JS.init_encoder_state(w.encoder_layers, 1, CACHE,
                               w.encoder_attention_heads, w.head_dim,
                               jnp.float32)
    ts = TS.init_encoder_state(w.encoder_layers, 1, CACHE,
                               w.encoder_attention_heads, w.head_dim,
                               torch.float32, "cpu")
    return js, ts


def _windows(n):
    rng = np.random.RandomState(3)
    audio = rng.randn(n * CHUNK).astype(np.float32) * 0.1
    win = np.zeros((CONV_LEFT_CONTEXT + 2 * CHUNK,), np.float32)
    for i in range(n):
        win = np.concatenate([win[CHUNK:], audio[i * CHUNK:(i + 1) * CHUNK]])
        yield win[None].copy()


def test_chunk_step_ring_wraps():
    jp, tp = _params()
    js, ts = _enc_states()
    for i, win in enumerate(_windows(4)):  # 4 * 48 frames > 96-frame ring
        fj, js = JW.chunk_step(jp["w2v2"], CFG.w2v2, js, jnp.asarray(win),
                               48, CACHE)
        ft, ts = TW.chunk_step(tp["w2v2"], TCFG.w2v2, ts,
                               torch.from_numpy(win), 48, CACHE)
        _close(ft.numpy(), fj, 1e-4)
        _close(ts.k.numpy(), js.k, 1e-4)
        _close(ts.v.numpy(), js.v, 1e-4)
        assert ts.n_frames.tolist() == [48 * (i + 1)]


@pytest.mark.parametrize("xpos", [False, True])
def test_encoder_attention_and_conv(xpos):
    jp, tp = _params()
    cfg = CFG.w2v2.__class__(**{**CFG.w2v2.__dict__, "use_xpos": xpos})
    tcfg = TCFG.w2v2.__class__(**{**TCFG.w2v2.__dict__, "use_xpos": xpos})
    rng = np.random.RandomState(4)
    B, S, K, H, Dh = 1, 5, 9, 4, 16
    q, k, v = (rng.randn(B, n, H, Dh).astype(np.float32) for n in (S, K, K))
    bias = np.where(rng.rand(B, 1, S, K) < 0.3, -1e9, 0.0).astype(np.float32)
    qp = np.arange(4, 4 + S)[None].astype(np.int32)
    kp = np.arange(K)[None].astype(np.int32)
    inv = JW.R.encoder_rope_freqs(Dh)
    want = JW._attention(*(jnp.asarray(a) for a in (q, k, v, bias, qp, kp)),
                         cfg, jnp.asarray(inv, jnp.float32))
    got = TW._attention(*(torch.from_numpy(a) for a in (q, k, v, bias)),
                        torch.from_numpy(qp).long(), torch.from_numpy(kp).long(),
                        tcfg, torch.tensor(inv, dtype=torch.float32))
    _close(got.numpy(), want, 1e-5)
    x = rng.randn(1, 4000).astype(np.float32)
    _close(TW.conv_extractor(tp["w2v2"], TCFG.w2v2, torch.from_numpy(x)).numpy(),
           JW.conv_extractor(jp["w2v2"], CFG.w2v2, jnp.asarray(x)), 1e-5)


def test_sinusoidal_positions_and_gelu():
    # angles up to ~750 rad: the float32 sin/cos of XLA and of PyTorch
    # reduce such arguments with different accuracy (1e-4 absolute)
    _close(TW.sinusoidal_positions(700, 48, 64).numpy(),
           JW.sinusoidal_positions(700, 48, 64), 1e-4)
    x = np.linspace(-6, 6, 101).astype(np.float32)
    _close(TW._gelu(torch.from_numpy(x)).numpy(), JW._gelu(jnp.asarray(x)),
           1e-6)


def test_adapter_forward():
    jp, tp = _params()
    x = np.random.RandomState(5).randn(2, 48, 64).astype(np.float32)
    want = JA.forward(jp["adapter"], CFG.adapter, jnp.asarray(x))
    got = TA.forward(tp["adapter"], TCFG.adapter, torch.from_numpy(x))
    assert tuple(got.shape) == (2, 12, 64)
    _close(got.numpy(), want, 1e-5)


def test_encode_splice_prefill_commit():
    jp, tp = _params()
    js, ts = _enc_states()
    win = next(_windows(1))
    rng = np.random.RandomState(6)
    ids = rng.randint(0, 500, (1, 21)).astype(np.int32)
    ids[0, 5:17] = 508
    sj, _ = JSL.encode_chunk(jp, CFG, js, jnp.asarray(win), 48, CACHE)
    st, _ = TSL.encode_chunk(tp, TCFG, ts, torch.from_numpy(win), 48, CACHE)
    _close(st.numpy(), sj, 1e-4)
    ej = JSL.splice_speech(jp, jnp.asarray(ids), sj, 5)
    et = TSL.splice_speech(tp, torch.from_numpy(ids).long(),
                           torch.from_numpy(np.array(sj)), 5)
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))

    # prefill: encoder -> adapter -> splice -> decoder
    L = CFG.llama
    djs = JS.init_decoder_state(L.num_layers, 1, 64, L.num_kv_heads,
                                L.head_dim, jnp.float32)
    dts = TS.init_decoder_state(L.num_layers, 1, 64, L.num_kv_heads,
                                L.head_dim, torch.float32, "cpu")
    js, ts = _enc_states()
    lj, sj2 = JSL.prefill_chunk(jp, CFG, JSL.StreamState(js, djs),
                                jnp.asarray(win), jnp.asarray(ids), 5, 48,
                                CACHE)
    lt, st2 = TSL.prefill_chunk(tp, TCFG, TSL.StreamState(ts, dts),
                                torch.from_numpy(win),
                                torch.from_numpy(ids).long(), 5, 48, CACHE)
    _close(lt.numpy(), lj, 1e-4)
    _close(st2.decoder.k.numpy(), sj2.decoder.k, 1e-4)
    assert st2.decoder.valid_len.tolist() == [21]

    # commit 3 of 5 winning tokens by a masked replay
    buf = np.asarray([[11, 12, 13, 504, 504]], np.int32)
    cj = JSL.commit_tokens(jp, CFG, sj2.decoder, jnp.asarray(buf),
                           jnp.asarray([3], jnp.int32))
    ct = TSL.commit_tokens(tp, TCFG, st2.decoder,
                           torch.from_numpy(buf).long(), torch.tensor([3]))
    assert ct.valid_len.tolist() == [24] == np.asarray(cj.valid_len).tolist()
    _close(ct.k.numpy(), cj.k, 1e-4)
