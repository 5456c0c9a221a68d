"""The port's weight quantization and int8 layouts against
``infinisst_tpu.models.quant``: ``quantize_weight``, ``_quantize_grouped``
and ``quantize_llama_params`` bitwise (the same float32 divisions and
round-half-even), ``init_quantized_llama``'s grouped layouts, and
``from_jax`` padding a grouped W8A8 lm_head; every int8 leaf comes out
packed K-major."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core.config import LlamaConfig as JLlamaConfig
from infinisst_tpu.kernels import quant_matmul as JK
from infinisst_tpu.models import llama as JL
from infinisst_tpu.models import quant as JQ
from infinisst_tpu_torch.convert.from_jax import from_jax
from infinisst_tpu_torch.core.config import LlamaConfig
from infinisst_tpu_torch.models import quant as TQ

torch.set_num_threads(1)

# widths that tile by 128 columns, as quantize_llama_params requires
WIDE = dict(vocab_size=500, hidden_size=256, intermediate_size=384,
            num_layers=2, num_heads=2, num_kv_heads=1, head_dim=128,
            rope_scaling=False)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("gs", [0, 32, 128])
def test_quantize_weight_and_grouped_bitwise(gs):
    rng = np.random.RandomState(gs)
    w = (rng.randn(256, 384) * rng.uniform(0.1, 3.0, (1, 384))).astype(
        np.float32)
    w[:, 5] = 0.0  # an all-zero column takes the 1e-8 floor scale
    if gs:
        jq, js = JQ._quantize_grouped(jnp.asarray(w), gs)
        tq, ts = TQ._quantize_grouped(torch.from_numpy(w), gs)
    else:
        jq, js = JK.quantize_weight(jnp.asarray(w), axis=0)
        tq, ts = TQ.quantize_weight(torch.from_numpy(w), axis=0)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    _eq(tq, jq)
    _eq(ts, js)


@pytest.mark.parametrize("kw", [
    dict(act_int8=False),
    dict(act_int8=True, quantize_lm_head=True),
    dict(act_int8=True, quantize_lm_head=True, group_size=128),
    dict(act_int8=True, quantize_lm_head=True, group_size=128,
         head_group_size=128),
], ids=["w8", "w8a8", "grouped", "grouped_head"])
def test_quantize_llama_params_bitwise(kw):
    jp = JL.init_params(jax.random.PRNGKey(0), JLlamaConfig(**WIDE))
    tp = from_jax(jax.device_get(jp), device="cpu")
    want = JQ.quantize_llama_params(jp, **kw)
    got = TQ.quantize_llama_params(tp, **kw)
    # every int8 leaf (weight-only, W8A8, grouped) comes out packed
    # K-major; compared unpacked
    for k in TQ.QUANT_KEYS:
        g = got["layers"][k]
        scale = "scale_a8" if kw["act_int8"] else "scale"
        assert set(g) == {TQ.KMAJOR, scale}, k
        assert tuple(g[TQ.KMAJOR].shape) == tuple(
            np.swapaxes(want["layers"][k]["q"], -1, -2).shape)
        assert TQ.is_grouped(g) == bool(kw.get("group_size")), k
        g = TQ.unpack_kmajor(g)
        assert set(g) == set(want["layers"][k]), k
        for leaf, t in g.items():
            _eq(t, want["layers"][k][leaf])
    if kw.get("quantize_lm_head"):
        head = got["lm_head"]
        assert set(head) == {TQ.KMAJOR, "scale_a8"}
        assert not head[TQ.KMAJOR][500:].any()  # the padding is zero
        assert TQ.is_grouped(head) == bool(kw.get("head_group_size"))
        head = TQ.unpack_kmajor(head)
        for leaf in ("q", "scale_a8"):
            _eq(head[leaf], want["lm_head"][leaf])
        assert head["q"].shape[-1] == 512
    else:
        _eq(got["lm_head"], want["lm_head"])


def test_quantize_llama_params_rejects_what_jax_asserts():
    tp = from_jax(jax.device_get(
        JL.init_params(jax.random.PRNGKey(0), JLlamaConfig(**WIDE))),
        device="cpu")
    with pytest.raises(ValueError):
        TQ.quantize_llama_params(tp, act_int8=False, group_size=128)
    with pytest.raises(ValueError):
        TQ.quantize_llama_params(tp, act_int8=True, group_size=96)


@pytest.mark.parametrize("hgs", [None, 128])
def test_init_quantized_llama_grouped_layout_matches_jax(hgs):
    want = JQ.init_quantized_llama(
        jax.random.PRNGKey(0), JLlamaConfig(**WIDE), act_int8=True,
        lm_head_int8=True, group_size=128, head_group_size=hgs)
    got = TQ.init_quantized_llama(
        LlamaConfig(**WIDE), torch.Generator().manual_seed(0), device="cpu",
        act_int8=True, lm_head_int8=True, group_size=128,
        head_group_size=hgs)
    # packed K-major: the JAX (in, out) shapes transposed, drawn in (in,
    # out) first (the first draw, wq, is the transpose of the generator's
    # first (L, in, out) draw); the grouped head's pad rows are zero
    for k in TQ.QUANT_KEYS:
        g, w = got["layers"][k], want["layers"][k]
        assert set(g) == {TQ.KMAJOR, "scale_a8"} and TQ.is_grouped(g), k
        assert tuple(g[TQ.KMAJOR].shape) == np.swapaxes(w["q"], -1, -2).shape
        assert g[TQ.KMAJOR].dtype == torch.int8 and g[TQ.KMAJOR].is_contiguous()
        assert tuple(g["scale_a8"].shape) == w["scale_a8"].shape
        _eq(g["scale_a8"], w["scale_a8"])
    first = torch.randint(-127, 128, (2, 256, 256),
                          generator=torch.Generator().manual_seed(0),
                          dtype=torch.int8)
    _eq(got["layers"]["wq"][TQ.KMAJOR], first.transpose(-1, -2).numpy())
    head = got["lm_head"]
    assert set(head) == {TQ.KMAJOR, "scale_a8"}
    assert TQ.is_grouped(head) == bool(hgs)
    assert tuple(head[TQ.KMAJOR].shape) == np.swapaxes(
        want["lm_head"]["q"], -1, -2).shape
    assert not head[TQ.KMAJOR][WIDE["vocab_size"]:].any()
    _eq(head["scale_a8"], want["lm_head"]["scale_a8"])
    with pytest.raises(ValueError):
        TQ.init_quantized_llama(LlamaConfig(**WIDE), torch.Generator(),
                                device="cpu", group_size=128)


@pytest.mark.parametrize("act_int8", [False, True], ids=["w8", "w8a8"])
def test_init_quantized_llama_packs_per_channel_leaves_after_the_draw(
        act_int8):
    """Per-channel leaves come out K-major {'q_kmajor', scale}, the
    transpose of JAX's (in, out) shapes, drawn in the (in, out) layout
    first: wq, the first draw, is the transpose of the same generator's
    first (L, in, out) draw."""
    cfg = LlamaConfig(**WIDE)
    want = JQ.init_quantized_llama(jax.random.PRNGKey(0), cfg,
                                   act_int8=act_int8)
    got = TQ.init_quantized_llama(cfg, torch.Generator().manual_seed(5),
                                  device="cpu", act_int8=act_int8)
    scale = "scale_a8" if act_int8 else "scale"
    for k in TQ.QUANT_KEYS:
        g, w = got["layers"][k], want["layers"][k]
        assert set(g) == {TQ.KMAJOR, scale} and set(w) == {"q", scale}, k
        assert tuple(g[TQ.KMAJOR].shape) == np.swapaxes(w["q"], -1, -2).shape
        assert g[TQ.KMAJOR].dtype == torch.int8
        assert g[TQ.KMAJOR].is_contiguous()
        _eq(g[scale], w[scale])
    first = torch.randint(-127, 128, (2, 256, 256),
                          generator=torch.Generator().manual_seed(5),
                          dtype=torch.int8)
    _eq(got["layers"]["wq"][TQ.KMAJOR], first.transpose(-1, -2).numpy())


def test_from_jax_pads_a_grouped_w8a8_head():
    rng = np.random.RandomState(0)
    D, V, gs = 64, 300, 32
    head = {"q": rng.randint(-127, 128, (D, V)).astype(np.int8),
            "scale_a8": (rng.rand(D // gs, V) * 1e-2).astype(np.float32)}
    got = from_jax({"lm_head": head}, device="cpu")["lm_head"]
    assert set(got) == {TQ.KMAJOR, "scale_a8"}  # packed K-major
    assert tuple(got[TQ.KMAJOR].shape) == (512, D)
    assert tuple(got["scale_a8"].shape) == (D // gs, 512)
    _eq(got[TQ.KMAJOR][:V], head["q"].T)
    _eq(got["scale_a8"][:, :V], head["scale_a8"])
    assert not got[TQ.KMAJOR][V:].any() and not got["scale_a8"][:, V:].any()
    y = torch.from_numpy(rng.randn(3, D).astype(np.float32))
    out = TQ.mm(y, got)
    want = TQ.mm(y, TQ.pack_kmajor(
        {k: torch.from_numpy(a) for k, a in head.items()}))
    np.testing.assert_array_equal(out[:, :V].numpy(), want.numpy())
    assert not out[:, V:].any()
