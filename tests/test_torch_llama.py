"""The port's Llama decode path against ``infinisst_tpu.models.llama`` at
``tiny_model_config`` widths: ``decode_step`` (with and without a
valid mask), ``beam_token_step`` and ``evict_cache``, with float32 weights
and with the W8A8 layout (int8 projections and int8 lm_head), plus the
weight-only layout through the Pallas kernel in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import infinisst_tpu.models.quant as JQ
from infinisst_tpu.core.config import tiny_model_config
from infinisst_tpu.kernels.quant_matmul import quantized_matmul
from infinisst_tpu.models import llama as JL
from infinisst_tpu.streaming.state import DecoderState as JDS
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import quant as TQ
from infinisst_tpu_torch.streaming.state import DecoderState as TDS

torch.set_num_threads(1)

CFG = tiny_model_config(vocab_size=512).llama
C = 32  # cache capacity

# Tolerances, relative to the largest |reference| value.  float32: the
# same arithmetic with sums taken in another order (1e-5).  W8A8: an
# activation whose float32 value lands within an ulp of a rounding
# boundary may quantize one int8 step apart between the two frameworks,
# and two layers carry that step on (2e-3); the kernels alone are
# bitwise equal (test_torch_kernels.py).  Weight-only: the bf16 rounding
# of activations ahead of the dequantized matmul turns the same ulp-level
# differences into bf16 steps (1e-2).
TOL = {"f32": 1e-5, "w8a8": 2e-3, "w8": 1e-2}


def _params(kind):
    key = jax.random.PRNGKey(0)
    if kind == "f32":
        return JL.init_params(key, CFG)
    if kind == "w8a8":
        return JQ.init_quantized_llama(key, CFG, act_int8=True,
                                       lm_head_int8=True,
                                       embed_dtype=jnp.float32)
    return JQ.init_quantized_llama(key, CFG, act_int8=False,
                                   embed_dtype=jnp.float32)


def _state(B, vlen, seed=0):
    rng = np.random.RandomState(seed)
    shape = (CFG.num_layers, B, C, CFG.num_kv_heads, CFG.head_dim)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    vl = np.asarray(vlen, np.int32)
    j = JDS(k=jnp.asarray(k), v=jnp.asarray(v), valid_len=jnp.asarray(vl))
    t = TDS(k=torch.from_numpy(k.copy()), v=torch.from_numpy(v.copy()),
            valid_len=torch.from_numpy(vl.astype(np.int64)))
    return j, t


def _close(got, want, tol):
    g = np.asarray(got, np.float32)
    w = np.asarray(want, np.float32)
    assert g.shape == w.shape, (g.shape, w.shape)
    err = np.abs(g - w).max()
    assert err <= tol * np.abs(w).max(), (err, np.abs(w).max())


@pytest.fixture
def interpret_pallas(monkeypatch):
    """Run the JAX weight-only path through its Pallas kernel in interpret
    mode on the CPU (as tests/test_quant.py does)."""
    monkeypatch.setattr(
        JQ, "quantized_matmul",
        lambda y, w, s, interpret=False: quantized_matmul(
            y, w, s, tile_o=16, interpret=True),
    )


@pytest.mark.parametrize("kind", ["f32", "w8a8"])
@pytest.mark.parametrize("masked", [False, True])
def test_decode_step(kind, masked):
    jp = _params(kind)
    tp = from_jax(jax.device_get(jp), device="cpu")
    B, S = 2, 6
    js, ts = _state(B, [7, 3])
    x = np.random.RandomState(1).randn(B, S, CFG.hidden_size).astype(np.float32)
    vm = np.asarray([[1, 1, 1, 1, 0, 0], [1, 1, 1, 1, 1, 1]], np.int32)
    lj, nj = JL.decode_step(jp, CFG, js, jnp.asarray(x),
                            valid_mask=jnp.asarray(vm) if masked else None)
    lt, nt = TL.decode_step(tp, CFG, ts, torch.from_numpy(x),
                            valid_mask=torch.from_numpy(vm) if masked else None)
    assert tuple(lt.shape) == (B, S, CFG.vocab_size)
    _close(lt.numpy(), lj, TOL[kind])
    _close(nt.k.numpy(), nj.k, TOL[kind])
    _close(nt.v.numpy(), nj.v, TOL[kind])
    np.testing.assert_array_equal(nt.valid_len.numpy(), np.asarray(nj.valid_len))
    assert nt.k is ts.k  # the cache was updated in place


def test_decode_step_weight_only(interpret_pallas):
    jp = _params("w8")
    tp = from_jax(jax.device_get(jp), device="cpu")
    js, ts = _state(1, [5])
    x = np.random.RandomState(2).randn(1, 4, CFG.hidden_size).astype(np.float32)
    lj, nj = JL.decode_step(jp, CFG, js, jnp.asarray(x))
    lt, nt = TL.decode_step(tp, CFG, ts, torch.from_numpy(x))
    _close(lt.numpy(), lj, TOL["w8"])
    _close(nt.k.numpy(), nj.k, TOL["w8"])


@pytest.mark.parametrize("kind", ["f32", "w8a8"])
@pytest.mark.parametrize("gen_len", [0, 3])
def test_beam_token_step(kind, gen_len):
    jp = _params(kind)
    tp = from_jax(jax.device_get(jp), device="cpu")
    beam, G = 3, 5
    js, ts = _state(1, [11], seed=3)
    rng = np.random.RandomState(4)
    gshape = (CFG.num_layers, beam, G, CFG.num_kv_heads, CFG.head_dim)
    gk = rng.randn(*gshape).astype(np.float32)
    gv = rng.randn(*gshape).astype(np.float32)
    x = rng.randn(beam, 1, CFG.hidden_size).astype(np.float32)
    lj, gkj, gvj, _ = JL.beam_token_step(
        jp, CFG, js, jnp.asarray(gk), jnp.asarray(gv),
        jnp.asarray(gen_len, jnp.int32), jnp.asarray(x),
    )
    lt, gkt, gvt, idx = TL.beam_token_step(
        tp, CFG, ts, torch.from_numpy(gk.copy()), torch.from_numpy(gv.copy()),
        gen_len, torch.from_numpy(x),
    )
    assert tuple(lt.shape) == (beam, CFG.vocab_size)
    _close(lt.numpy(), lj, TOL[kind])
    _close(gkt.numpy(), gkj, TOL[kind])
    _close(gvt.numpy(), gvj, TOL[kind])
    assert idx.tolist() == [-1] * beam


@pytest.mark.parametrize("group_size", [0, 32], ids=["w8a8", "grouped"])
def test_activation_quantized_once_per_shared_input(monkeypatch, group_size):
    """q/k/v and gate/up share their input, so a forward quantizes 4
    activations per layer and the lm_head's, each once, three of them in
    the kernel that makes them: ``rms_norm_quant_int8`` 2L + 1 times
    (q|k|v, gate|up and the head after their norms),
    ``silu_mul_quant_int8`` L times (down) and ``row_quant_int8`` L
    times (o) with per-channel W8A8 leaves, whose GEMMs run as 4L + 1
    ``w8a8_gemm_many`` calls (q|k|v and gate|up one launch each); with
    grouped projections ``group_quant_int8`` L times (o) and the norms
    and the SwiGLU product grouped (the per-channel head's norm per row),
    their GEMMs as 4L ``w8a8_grouped_gemm_many`` calls, q|k|v and gate|up
    one launch each as the per-channel ones."""
    calls = {"row_quant_int8": 0, "group_quant_int8": 0,
             "rms_norm_quant_int8": 0, "silu_mul_quant_int8": 0,
             "w8a8_gemm_many": 0, "w8a8_grouped_gemm_many": 0}
    for name in calls:
        fn = getattr(TQ, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(TQ, name, counted)
    p = TQ.init_quantized_llama(
        CFG, torch.Generator().manual_seed(0), device="cpu",
        embed_dtype=torch.float32, act_int8=True, lm_head_int8=True,
        group_size=group_size)
    L = CFG.num_layers
    fused = {"rms_norm_quant_int8": 2 * L + 1, "silu_mul_quant_int8": L}
    want = ({"row_quant_int8": 0, "group_quant_int8": L,
             "w8a8_gemm_many": 1, "w8a8_grouped_gemm_many": 4 * L, **fused}
            if group_size else
            {"row_quant_int8": L, "group_quant_int8": 0,
             "w8a8_gemm_many": 4 * L + 1, "w8a8_grouped_gemm_many": 0,
             **fused})
    rng = np.random.RandomState(8)
    _, ts = _state(2, [7, 3])
    TL.decode_step(p, CFG, ts, torch.from_numpy(
        rng.randn(2, 5, CFG.hidden_size).astype(np.float32)))
    assert calls == want
    calls.update((k, 0) for k in calls)
    _, ts = _state(1, [11], seed=3)
    gshape = (L, 3, 4, CFG.num_kv_heads, CFG.head_dim)
    TL.beam_token_step(
        p, CFG, ts, torch.zeros(gshape), torch.zeros(gshape), 2,
        torch.from_numpy(rng.randn(3, 1, CFG.hidden_size).astype(np.float32)))
    assert calls == want


@pytest.mark.parametrize("sys_len", [0, 4])
@pytest.mark.parametrize("keep", [[5, 2], [9, 6]])
def test_evict_cache(sys_len, keep):
    js, ts = _state(2, [20, 9], seed=5)
    want = JL.evict_cache(js, jnp.asarray(keep, jnp.int32), sys_len)
    got = TL.evict_cache(ts, torch.tensor(keep), sys_len)
    np.testing.assert_array_equal(got.k.numpy(), np.asarray(want.k))
    np.testing.assert_array_equal(got.v.numpy(), np.asarray(want.v))
    np.testing.assert_array_equal(got.valid_len.numpy(),
                                  np.asarray(want.valid_len))


def test_embed_rms_norm_and_init():
    jp = _params("f32")
    tp = from_jax(jax.device_get(jp), device="cpu")
    ids = np.asarray([[1, 5, 511], [0, 2, 3]])
    np.testing.assert_array_equal(
        TL.embed(tp, torch.from_numpy(ids)).numpy(),
        np.asarray(JL.embed(jp, jnp.asarray(ids))),
    )
    x = np.random.RandomState(6).randn(3, 64).astype(np.float32)
    sc = np.random.RandomState(7).rand(64).astype(np.float32)
    _close(TL._rms_norm(torch.from_numpy(x), torch.from_numpy(sc), 1e-5).numpy(),
           JL._rms_norm(jnp.asarray(x), jnp.asarray(sc), 1e-5), 1e-6)
    g = torch.Generator().manual_seed(0)
    p = TL.init_params(CFG, g, device="cpu")
    for k, v in jp["layers"].items():
        assert tuple(p["layers"][k].shape) == v.shape, k
    assert tuple(p["lm_head"].shape) == jp["lm_head"].shape
