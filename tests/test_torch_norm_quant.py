"""The fused quantizers' plain versions (``rms_norm_quant_int8_plain``,
``silu_mul_quant_int8_plain``) against the JAX functions they replace,
``_rms_norm`` or ``jax.nn.silu(g) * u`` followed by ``quantize_activation``
or ``quantize_activation_grouped``, at tiny widths; a row's bits at M = 1
and M = 61; the port's bf16 silu at every site, and its gradient,
against ``jax.nn.silu``'s; and the route in ``models/llama.py`` that
takes the fused kernels only where every leaf is W8A8 of one layout.

Tolerance against JAX: the norm's sum of squares runs in the kernel's
order, not XLA's, and on float32 rows torch's silu and XLA's differ by an
ulp, so y may differ by an ulp; a value within an ulp of a rounding
boundary then quantizes one int8 step apart.  On bf16 rows the port's
silu rounds where XLA's does, so the SwiGLU product is bitwise.  So y_s agrees within 2**-8
relative, the codes within 1, and equal on at least 99.9 % of entries."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.core.config import tiny_model_config
from infinisst_tpu.kernels.quant_matmul import (
    quantize_activation,
    quantize_activation_grouped,
)
from infinisst_tpu.models import llama as JL
from infinisst_tpu_torch.kernels import quant_matmul as TK
from infinisst_tpu_torch.models import llama as TL
from infinisst_tpu_torch.models import quant as TQ
from infinisst_tpu_torch.streaming.state import DecoderState as TDS

torch.set_num_threads(1)

D, I, GS, EPS = 256, 512, 32, 1e-5
DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16)}
YS_RTOL = 2.0 ** -8
MIN_EQUAL = 0.999


def _rows(M, width, seed, scale=2.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(M, width) * rng.uniform(0.5, scale, (M, 1))
            ).astype(np.float32)


def _pair(x, kind):
    """The same values as a torch and a JAX array of the dtype."""
    tdt, jdt = DTYPES[kind]
    t = torch.from_numpy(x).to(tdt)
    return t, jnp.asarray(t.to(torch.float32).numpy()).astype(jdt)


def _jax_quant(y, gs):
    return (quantize_activation(y) if gs == y.shape[-1]
            else quantize_activation_grouped(y, gs))


def _agree(got, want):
    q, s = (x.numpy() if torch.is_tensor(x) else x for x in got)
    wq, ws = (np.asarray(x) for x in want)
    assert q.shape == wq.shape and s.shape == ws.shape
    np.testing.assert_allclose(s, ws, rtol=YS_RTOL, atol=0)
    diff = np.abs(q.astype(np.int32) - wq.astype(np.int32))
    assert diff.max() <= 1, diff.max()
    assert (diff == 0).mean() >= MIN_EQUAL, (diff == 0).mean()


@pytest.mark.parametrize("M", [1, 4, 61])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("with_delta", [False, True],
                         ids=["no_delta", "delta"])
@pytest.mark.parametrize("gs", [D, GS], ids=["per_row", "grouped"])
def test_rms_norm_quant_matches_jax(M, kind, with_delta, gs):
    th, jh = _pair(_rows(M, D, 1, scale=4.0), kind)
    td, jd = _pair(_rows(M, D, 2), kind)
    tsc, jsc = _pair(np.random.RandomState(3).uniform(
        0.5, 1.5, D).astype(np.float32), kind)
    if not with_delta:
        td = jd = None
    h2, q, s = TK.rms_norm_quant_int8_plain(th, td, tsc, EPS, gs)
    jh2 = jh if jd is None else jh + jd
    assert h2.dtype == th.dtype
    np.testing.assert_array_equal(h2.to(torch.float32).numpy(),
                                  np.asarray(jh2.astype(jnp.float32)))
    _agree((q, s), _jax_quant(JL._rms_norm(jh2, jsc, EPS), gs))


@pytest.mark.parametrize("M", [1, 4, 61])
@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("gs", [I, GS], ids=["per_row", "grouped"])
def test_silu_mul_quant_matches_jax(M, kind, gs):
    """Against ``jax.nn.silu(g) * u`` itself, which XLA computes with every
    step of the sigmoid and the product rounded to the dtype, as the
    port's ``silu`` does on bf16 rows: there the product and its
    quantization are bitwise JAX's; on float32 rows (torch's silu, an ulp
    from XLA's) within the module's tolerance."""
    tg, jg = _pair(_rows(M, I, 4, scale=3.0), kind)
    tu, ju = _pair(_rows(M, I, 5), kind)
    got = TK.silu_mul_quant_int8_plain(tg, tu, gs)
    want = _jax_quant(jax.nn.silu(jg) * ju, gs)
    if kind == "bf16":
        np.testing.assert_array_equal(
            (TK.silu(tg) * tu).to(torch.float32).numpy(),
            np.asarray((jax.nn.silu(jg) * ju).astype(jnp.float32)))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _agree(got, want)


def _exact_weight(n, seed, scale):
    """A permutation matrix times a power of two: every product through it
    is exact, so torch and XLA give the same bits whatever their order."""
    w = np.zeros((n, n), np.float32)
    w[np.arange(n), np.random.RandomState(seed).permutation(n)] = scale
    return w


@pytest.mark.parametrize("site", ["exit_adapter", "silu_mm", "offline_mlp"])
def test_silu_sites_bitwise_jax_on_bf16(site):
    """Each port site that mirrors a ``jax.nn.silu`` gives JAX's bits on
    bf16 rows: the exit adapter (``apply_exit_adapter``), ``_silu_mm``'s
    route for float weights (JAX's ``jax.nn.silu(mm(y, w_gate)) * mm(y,
    w_up)`` before w_down) and the training forward's MLP
    (``_swiglu``).  The weights are exact (``_exact_weight``), so only
    the silu's rounding can tell the frameworks apart."""
    td, jd = torch.bfloat16, jnp.bfloat16
    x = _rows(6, D, 13, scale=3.0)
    tx, jx = _pair(x, "bf16")
    if site == "exit_adapter":
        ln = np.random.RandomState(14).uniform(0.5, 1.5, D).astype(np.float32)
        w1, w2 = _exact_weight(D, 15, 2.0), _exact_weight(D, 16, 0.25)
        ta = {"ln": torch.from_numpy(ln).to(td),
              "w1": torch.from_numpy(w1).to(td),
              "w2": torch.from_numpy(w2).to(td)}
        ja = {k: jnp.asarray(v).astype(jd)
              for k, v in (("ln", ln), ("w1", w1), ("w2", w2))}
        got = TL.apply_exit_adapter(ta, tx, EPS)
        want = JL.apply_exit_adapter(ja, jx, EPS)
    else:
        tu, ju = _pair(_rows(6, D, 17), "bf16")
        wg = _exact_weight(D, 18, 2.0)
        tw, jw = torch.from_numpy(wg).to(td), jnp.asarray(wg).astype(jd)
        if site == "silu_mm":
            eye = np.eye(D, dtype=np.float32)
            got = TL._silu_mm(tx, tu, torch.from_numpy(eye).to(td))
            want = (jax.nn.silu(jx) * ju) @ jnp.asarray(eye).astype(jd)
        else:
            got = TL._swiglu(tu, tw, torch.from_numpy(
                _exact_weight(D, 19, 0.5)).to(td))
            want = jax.nn.silu(ju @ jw) * (ju @ jnp.asarray(
                _exact_weight(D, 19, 0.5)).astype(jd))
    assert got.dtype == td
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("site", ["silu", "swiglu"])
def test_silu_grad_bitwise_jax_on_bf16(site):
    """The gradient the port's ``silu`` takes on bf16 rows is JAX's bit for
    bit: ``torch.autograd.grad`` of ``TK.silu`` against ``jax.vjp`` of
    ``jax.nn.silu``, and the input's gradient through the training MLP
    (``_swiglu``) against ``jax.vjp`` of ``jax.nn.silu(y @ wg) * (y @
    wu)``, the path a frozen LLM's layers pass the adapter's gradient
    back on.  The weights are exact (``_exact_weight``), so only the
    silu's rounding can tell the frameworks apart."""
    td, jd = torch.bfloat16, jnp.bfloat16
    tx, jx = _pair(_rows(6, D, 21, scale=3.0), "bf16")
    tc, jc = _pair(_rows(6, D, 22), "bf16")
    tx.requires_grad_()
    if site == "silu":
        out = TK.silu(tx)
        _, vjp = jax.vjp(jax.nn.silu, jx)
    else:
        wg, wu = _exact_weight(D, 23, 2.0), _exact_weight(D, 24, 0.5)
        tg, tu = (torch.from_numpy(w).to(td) for w in (wg, wu))
        jg, ju = (jnp.asarray(w).astype(jd) for w in (wg, wu))
        out = TL._swiglu(tx, tg, tu)
        _, vjp = jax.vjp(lambda y: jax.nn.silu(y @ jg) * (y @ ju), jx)
    got, = torch.autograd.grad(out, tx, tc)
    want, = vjp(jc)
    assert got.dtype == td
    np.testing.assert_array_equal(got.to(torch.float32).numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("kind", ["f32", "bf16"])
@pytest.mark.parametrize("gs", ["per_row", GS])
def test_a_rows_bits_do_not_depend_on_the_batch(kind, gs):
    """Row 0 of a batch of 61 quantizes to the bits it has alone: the sum
    of squares runs in an order fixed by D."""
    tdt = DTYPES[kind][0]
    h = torch.from_numpy(_rows(61, D, 6, scale=4.0)).to(tdt)
    d = torch.from_numpy(_rows(61, D, 7)).to(tdt)
    sc = torch.from_numpy(np.random.RandomState(8).uniform(
        0.5, 1.5, D).astype(np.float32)).to(tdt)
    g = D if gs == "per_row" else gs
    alone = TK.rms_norm_quant_int8(h[:1], d[:1], sc, EPS, g)
    batch = TK.rms_norm_quant_int8(h, d, sc, EPS, g)
    for a, b in zip(alone, batch):
        assert torch.equal(a, b[:1])
    g = I if gs == "per_row" else gs
    gate = torch.from_numpy(_rows(61, I, 9)).to(tdt)
    up = torch.from_numpy(_rows(61, I, 10)).to(tdt)
    alone = TK.silu_mul_quant_int8(gate[:1], up[:1], g)
    batch = TK.silu_mul_quant_int8(gate, up, g)
    for a, b in zip(alone, batch):
        assert torch.equal(a, b[:1])


def test_sum_squares_order():
    """The plain sum of squares adds in the kernel's order: each lane's
    chunks, a warp's xor butterfly, the warps in order; for one row of a
    single nonzero lane that is the lane's own sequential sum, and the
    whole is within float32 rounding of the float64 sum."""
    for width in (64, 256, 4096, 14336):
        J, lanes = TK.norm_lanes(width)
        assert lanes % 32 == 0 and J * lanes * TK.NQ_CHUNK >= width
        x = torch.from_numpy(_rows(3, width, 11))
        got = TK.sum_squares_plain(x)
        want = (x.double() ** 2).sum(-1, keepdim=True)
        torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=0)
        one = torch.zeros((1, width))
        one[0, :8] = torch.arange(1.0, 9.0) / 3
        seq = torch.zeros(())
        for v in one[0, :8]:
            seq = seq + v * v
        assert TK.sum_squares_plain(one)[0, 0].item() == seq.item()


@pytest.mark.parametrize("width,gs,ok", [
    (4096, 4096, True), (4096, 128, True), (14336, 128, True),
    (64, 32, True), (256, 8, True), (256, 512, False), (256, 24, False),
    (4096, 512, False), (100, 100, False), (96, 16, True)])
def test_fused_layouts(width, gs, ok):
    assert TK.fused_quant_ok(width, gs) is ok


CFG = tiny_model_config(vocab_size=512).llama


def _tiny(kind, group_size=0):
    gen = torch.Generator().manual_seed(0)
    if kind == "f32":
        return TL.init_params(CFG, gen, device="cpu")
    return TQ.init_quantized_llama(
        CFG, gen, device="cpu", embed_dtype=torch.float32,
        act_int8=kind != "w8", lm_head_int8=True, group_size=group_size)


def _lowrank(p, key):
    """``key`` of every layer as low-rank float factors {'a', 'b'}."""
    L, D, O = (CFG.num_layers, CFG.hidden_size,
               TQ.out_features(p["layers"][key]))
    D = CFG.intermediate_size if key == "w_down" else D
    g = torch.Generator().manual_seed(1)
    layers = dict(p["layers"])
    layers[key] = {"a": torch.randn((L, D, 8), generator=g) / 8,
                   "b": torch.randn((L, 8, O), generator=g) / 8}
    return dict(p, layers=layers)


def _route_counts(monkeypatch, p):
    calls = {"rms_norm_quant_int8": 0, "silu_mul_quant_int8": 0}
    for name in calls:
        fn = getattr(TQ, name)

        def counted(*args, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*args)

        monkeypatch.setattr(TQ, name, counted)
    rng = np.random.RandomState(12)
    shape = (CFG.num_layers, 2, 16, CFG.num_kv_heads, CFG.head_dim)
    st = TDS(k=torch.zeros(shape), v=torch.zeros(shape),
             valid_len=torch.tensor([3, 5]))
    logits, _ = TL.decode_step(p, CFG, st, torch.from_numpy(
        rng.randn(2, 3, CFG.hidden_size).astype(np.float32)))
    assert torch.isfinite(logits).all()
    return calls


@pytest.mark.parametrize("case", ["f32", "w8", "w8a8", "grouped",
                                  "w8a8_float_wq", "w8a8_lowrank_down",
                                  "w8a8_float_head"])
def test_route_takes_fused_kernels_only_for_w8a8(monkeypatch, case):
    """A forward runs ``rms_norm_quant_int8`` for each norm whose
    weights are all W8A8 of one layout (q|k|v, gate|up, the head) and
    ``silu_mul_quant_int8`` for a W8A8 down projection; float, weight-only,
    low-rank and mixed leaves keep the separate norm and product."""
    L = CFG.num_layers
    if case == "f32":
        p, want = _tiny(case), (0, 0)
    elif case == "w8":  # weight-only projections, a W8A8 head
        p, want = _tiny(case), (1, 0)
    elif case == "grouped":
        p, want = _tiny("w8a8", group_size=32), (2 * L + 1, L)
    else:
        p = _tiny("w8a8")
        want = (2 * L + 1, L)
        if case == "w8a8_float_wq":
            layers = dict(p["layers"])
            layers["wq"] = torch.randn((L, CFG.hidden_size, CFG.num_heads
                                        * CFG.head_dim)) / 8
            p, want = dict(p, layers=layers), (L + 1, L)
        elif case == "w8a8_lowrank_down":
            p, want = _lowrank(p, "w_down"), (2 * L + 1, 0)
        elif case == "w8a8_float_head":
            p = dict(p, lm_head=torch.randn((CFG.hidden_size,
                                             CFG.vocab_size)) / 8)
            want = (2 * L, L)
    got = _route_counts(monkeypatch, p)
    assert (got["rms_norm_quant_int8"], got["silu_mul_quant_int8"]) == want


@pytest.mark.parametrize("group_size", [0, 32], ids=["w8a8", "grouped"])
def test_fused_route_matches_the_separate_one(monkeypatch, group_size):
    """The fused route's logits against the same forward with the route
    off (``_rms_norm``, torch's SwiGLU product and the quantizers apart),
    within the W8A8 tolerance of tests/test_torch_llama.py (2e-3 of
    max|logits|): the two sum the norms' squares in other orders."""
    p = _tiny("w8a8", group_size=group_size)
    rng = np.random.RandomState(13)
    x = torch.from_numpy(rng.randn(2, 4, CFG.hidden_size).astype(np.float32))
    shape = (CFG.num_layers, 2, 16, CFG.num_kv_heads, CFG.head_dim)

    def run():
        st = TDS(k=torch.zeros(shape), v=torch.zeros(shape),
                 valid_len=torch.tensor([2, 6]))
        return TL.decode_step(p, CFG, st, x)[0]

    fused = run()
    monkeypatch.setattr(TQ, "a8_group_size", lambda ws, D: None)
    apart = run()
    err = (fused - apart).abs().max().item()
    assert err <= 2e-3 * apart.abs().max().item(), err
