"""The port's int8 matmul kernels (plain versions, on the CPU) against the
JAX package: ``mm`` on every quantized layout, the Pallas kernels in
interpret mode, ``quantize_activation`` and ``quantize_activation_grouped``.

W8A8 (per-channel and grouped) and the row and group quantizations must be
BITWISE equal: both sides compute exact integer products and the same
float32 epilogue in the same order.
"""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.kernels import quant_matmul as JK
from infinisst_tpu.models import quant as JQ
from infinisst_tpu_torch.kernels import quant_matmul as TK
from infinisst_tpu_torch.models import quant as TQ

torch.set_num_threads(1)

DTYPES = {
    "float32": (jnp.float32, torch.float32),
    "bfloat16": (jnp.bfloat16, torch.bfloat16),
}


def _inputs(M, D, O, seed):
    rng = np.random.RandomState(seed)
    y = (rng.randn(M, D) * rng.uniform(0.5, 3.0, (M, 1))).astype(np.float32)
    w = rng.randint(-127, 128, (D, O)).astype(np.int8)
    s = (rng.rand(O) * 1e-2 + 1e-4).astype(np.float32)
    return y, w, s


def _as_f32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _port(y, dtype):
    return torch.from_numpy(y).to(dtype)


def _packed(w, s, key="scale_a8"):
    """The port's int8 leaf, W8A8 (``scale_a8``: per-channel (O,) or
    grouped (G, O)) or weight-only (``scale``): the (D, O) weight packed
    K-major."""
    return TQ.pack_kmajor({"q": torch.from_numpy(w),
                           key: torch.from_numpy(s)})


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize(
    "M,D,O", [(1, 256, 512), (3, 128, 256), (61, 256, 384), (4, 512, 128),
              (79, 128, 256)]
)
def test_w8a8_mm_bitwise_vs_jax_and_pallas(dtype, M, D, O):
    """``mm`` on the packed K-major leaf, and the JAX-signature
    ``quantized_matmul_w8a8`` on the (D, O) weight, against JAX ``mm`` and
    the Pallas kernel in interpret mode."""
    jd, td = DTYPES[dtype]
    y, w, s = _inputs(M, D, O, seed=M * 7 + D)
    yj = jnp.asarray(y).astype(jd)
    want = JQ.mm(yj, {"q": jnp.asarray(w), "scale_a8": jnp.asarray(s)})
    pallas = JK.quantized_matmul_w8a8(
        yj, jnp.asarray(w), jnp.asarray(s), tile_o=128, interpret=True
    )
    got = TQ.mm(_port(y, td), _packed(w, s))
    assert got.dtype == td and tuple(got.shape) == (M, O)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))
    np.testing.assert_array_equal(_as_f32(got), _as_f32(pallas))
    sig = TK.quantized_matmul_w8a8(_port(y, td), torch.from_numpy(w),
                                   torch.from_numpy(s))
    np.testing.assert_array_equal(_as_f32(sig), _as_f32(pallas))


def test_pack_w8a8_round_trips_and_mm_refuses_the_unpacked_leaf():
    rng = np.random.RandomState(1)
    w = rng.randint(-127, 128, (3, 96, 40)).astype(np.int8)  # stacked
    s = rng.rand(3, 40).astype(np.float32)
    leaf = {"q": torch.from_numpy(w), "scale_a8": torch.from_numpy(s)}
    packed = TQ.pack_kmajor(leaf)
    assert set(packed) == {TQ.KMAJOR, "scale_a8"}
    assert tuple(packed[TQ.KMAJOR].shape) == (3, 40, 96)
    assert packed[TQ.KMAJOR].is_contiguous()
    back = TQ.unpack_kmajor(packed)
    np.testing.assert_array_equal(back["q"].numpy(), w)
    np.testing.assert_array_equal(back["scale_a8"].numpy(), s)
    # a grouped leaf packs and unpacks the same way, its (G, out) scale
    # kept as it is
    grouped = TQ.pack_kmajor({"q": leaf["q"][0],
                              "scale_a8": torch.ones((3, 40))})
    assert tuple(grouped[TQ.KMAJOR].shape) == (40, 96)
    assert TQ.is_grouped(grouped) and not TQ.is_grouped(
        {k: v[0] for k, v in packed.items()})
    back = TQ.unpack_kmajor(grouped)
    np.testing.assert_array_equal(back["q"].numpy(), w[0])
    assert tuple(back["scale_a8"].shape) == (3, 40)
    with pytest.raises(ValueError):
        TQ.pack_kmajor({"a": leaf["q"][0], "b": leaf["q"][0]})
    y = torch.from_numpy(rng.randn(2, 96).astype(np.float32))
    with pytest.raises(ValueError):
        TQ.mm(y, {"q": leaf["q"][0], "scale_a8": leaf["scale_a8"][0]})
    want = TK.quantized_matmul_w8a8(y, leaf["q"][0], leaf["scale_a8"][0])
    got = TQ.mm(y, {k: v[0] for k, v in packed.items()})
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# the flagship projections and padded head, and the tiny model's
FLAGSHIP_DO = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
               (4096, 128512)]
TINY_DO = [(64, 64), (64, 32), (64, 128), (128, 64), (64, 512)]


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_w8a8_plan_covers_every_row_of_d_once(sms):
    """The host plan of the split-K GEMM (``w8_bf16_gemm``; the grouped
    GEMM shares its tiles): every D byte in exactly one split, whole stages per
    split but the last, every row and channel in one tile; at M <= 16 the
    flagship shapes launch about two blocks per SM."""
    for D, O in FLAGSHIP_DO + TINY_DO:
        for M in (1, 4, 16, 61, 79, 200):
            p = TK.gemm_plan(M, D, O, sms)
            assert p.rows in TK.GEMM_ROW_TILES and p.rows >= min(M, 80)
            assert p.n_mtiles * p.rows >= M > (p.n_mtiles - 1) * p.rows
            assert p.n_otiles * TK.GEMM_TILE_O >= O
            assert p.k_split % TK.GEMM_TILE_K == 0
            cover = np.zeros(D, np.int64)
            for sp in range(p.n_split):
                cover[sp * p.k_split:min(D, (sp + 1) * p.k_split)] += 1
            assert (cover == 1).all(), (M, D, O, p)
            assert (p.n_split - 1) * p.k_split < D
            blocks = p.n_mtiles * p.n_otiles * p.n_split
            if M <= 16 and (D, O) in FLAGSHIP_DO:
                assert blocks >= 1.9 * sms, (M, D, O, p)


# weights that share an input (q|k|v, gate|up): the tiny model's (ragged:
# 32 channels, a quarter of a tile) and the flagship's at an eighth of
# its width
SHARED_WIDTHS = {"tiny q|k|v": (64, (64, 32, 32)),
                 "tiny gate|up": (64, (128, 128)),
                 "flagship/8 q|k|v": (512, (512, 128, 128)),
                 "flagship/8 gate|up": (512, (1792, 1792))}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M", [1, 4, 61, 200])
@pytest.mark.parametrize("widths", list(SHARED_WIDTHS))
def test_w8a8_gemm_many_plain_bitwise_vs_jax_mm(widths, M, dtype):
    """``w8a8_gemm_many_plain`` on the row-quantized activation and the
    packed weights equals JAX ``mm`` of each weight alone, bitwise, and
    ``mm_many`` on the packed leaves equals it too."""
    jd, td = DTYPES[dtype]
    D, Os = SHARED_WIDTHS[widths]
    rng = np.random.RandomState(M * 31 + D + len(Os))
    y = (rng.randn(M, D) * rng.uniform(0.5, 3.0, (M, 1))).astype(np.float32)
    ws = [rng.randint(-127, 128, (D, O)).astype(np.int8) for O in Os]
    ss = [(rng.rand(O) * 1e-2 + 1e-4).astype(np.float32) for O in Os]
    yj = jnp.asarray(y).astype(jd)
    want = [JQ.mm(yj, {"q": jnp.asarray(w), "scale_a8": jnp.asarray(s)})
            for w, s in zip(ws, ss)]
    y_q, y_s = TK.row_quant_int8(_port(y, td))
    leaves = [_packed(w, s) for w, s in zip(ws, ss)]
    got = TK.w8a8_gemm_many_plain(y_q, y_s, [lf[TQ.KMAJOR] for lf in leaves],
                                  [lf["scale_a8"] for lf in leaves], td)
    assert len(got) == len(Os)
    for g, wnt, O in zip(got, want, Os):
        assert g.dtype == td and tuple(g.shape) == (M, O)
        np.testing.assert_array_equal(_as_f32(g), _as_f32(wnt))
    for g, wnt in zip(TQ.mm_many(_port(y, td), leaves), want):
        np.testing.assert_array_equal(_as_f32(g), _as_f32(wnt))


# (M, D, Os) of the Hopper W8A8 kernel's launches: the flagship's q|k|v,
# o, gate|up, down and padded head at the decoder's and the prefills' rows,
# and the tiny model's ragged widths
W8A8_LAUNCHES = (
    [(M, 4096, (4096, 1024, 1024)) for M in (1, 4, 5, 20, 61, 79, 384, 448)]
    + [(M, 4096, (4096,)) for M in (4, 32, 40, 768)]
    + [(M, 4096, (14336, 14336)) for M in (1, 4, 8, 79, 320, 640)]
    + [(M, 14336, (4096,)) for M in (4, 61, 512)]
    + [(4, 4096, (128512,)), (1, 4096, (16384,))]
    + [(M, 64, (64, 32, 32)) for M in (1, 4, 61, 200)]
    + [(M, 128, (64,)) for M in (3, 257)] + [(7, 96, (40, 200))])


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_w8a8_plan_covers_every_channel_and_byte_once(sms):
    """``w8a8_plan`` and the runs its blocks walk (``w8a8_block_work``):
    every (output channel, K byte, row) of every weight in exactly one
    iteration of one block; each block's run within one stage of an even
    share; at most one block an SM; a row tile of every M up to 256 rows,
    of compiled rows; a ring of at least two stages that fits the SM; and
    for each tile split across blocks an owner (its first block, where the
    tile is the run's last) and later contributors (where it is the run's
    first), so that a block owns at most one tile and stores at most one
    partial."""
    for M, D, Os in W8A8_LAUNCHES:
        p = TK.w8a8_plan(M, D, Os, sms)
        assert p.rows in TK.W8A8_ROWS and p.n_mtiles * p.rows >= M
        assert (p.n_mtiles - 1) * p.rows < M
        if M <= TK.W8A8_ROWS[-1]:
            assert p.n_mtiles == 1
        assert 2 <= p.stages <= TK.W8A8_MAX_STAGES
        assert TK.w8a8_smem(p.rows, p.stages) <= TK.W8A8_SMEM
        assert p.blocks == min(sms, p.n_iters)
        n_k = -(-D // TK.W8A8_STAGE_K)
        cover = [np.zeros((-(-O // TK.W8A8_TILE_O), p.n_mtiles, n_k),
                          np.int64) for O in Os]
        owner = {}
        lengths = []
        for b in range(p.blocks):
            work = TK.w8a8_block_work(p, b)
            lengths.append(len(work))
            for w, ot, mt, k in work:
                cover[w][ot, mt, k] += 1
                owner.setdefault((w, ot, mt), []).append(b)
        assert all((c == 1).all() for c in cover), (M, D, Os, p)
        assert max(lengths) - min(lengths) <= 1 and min(lengths) >= 1
        assert sum(lengths) == p.n_iters
        split = [sorted(set(bs)) for bs in owner.values()
                 if bs[0] != bs[-1]]
        assert len(split) == p.split_tiles
        owners = [bs[0] for bs in split]
        later = [b for bs in split for b in bs[1:]]
        assert len(owners) == len(set(owners))
        assert len(later) == len(set(later))
        for bs in split:
            assert TK.w8a8_block_work(p, bs[0])[-1][:3] == \
                TK.w8a8_block_work(p, bs[1])[0][:3]
            assert all(TK.w8a8_block_work(p, b)[0][3] > 0 for b in bs[1:])
        # the channels and K bytes the tiles cover: every one, none twice
        for O, c in zip(Os, cover):
            assert c.shape[0] * TK.W8A8_TILE_O >= O
            assert (c.shape[0] - 1) * TK.W8A8_TILE_O < O
            assert c.shape[2] * TK.W8A8_STAGE_K >= D
            assert (c.shape[2] - 1) * TK.W8A8_STAGE_K < D


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(2, 3, 128, 100), (1, 61, 64, 36)])
def test_w8a8_mm_ragged_o_and_batched_rows(dtype, shape):
    """O not a multiple of 128 (the Pallas call asserts O % tile_o == 0,
    so only JAX ``mm`` is the reference) and a leading batch axis."""
    jd, td = DTYPES[dtype]
    B, S, D, O = shape
    y, w, s = _inputs(B * S, D, O, seed=O)
    y = y.reshape(B, S, D)
    want = JQ.mm(jnp.asarray(y).astype(jd),
                 {"q": jnp.asarray(w), "scale_a8": jnp.asarray(s)})
    got = TQ.mm(_port(y, td), _packed(w, s))
    assert tuple(got.shape) == (B, S, O)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,D", [(1, 64), (3, 4096), (61, 1024)])
def test_row_quant_int8_bitwise_vs_quantize_activation(dtype, M, D):
    jd, td = DTYPES[dtype]
    y, _, _ = _inputs(M, D, 4, seed=D + M)
    y[0, :3] = [0.5, -1.5, 2.5]  # exact .5 quotients need round-half-even
    y[-1] = 0.0  # an all-zero row takes the 1e-8 floor scale
    jq, js = JK.quantize_activation(jnp.asarray(y).astype(jd))
    tq, ts = TK.row_quant_int8(_port(y, td))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (M, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bfloat16", "float32"])
def test_row_quant_plan_covers_each_row_once(elem_bytes):
    """``row_quant_int8``'s launch: a row's 16-byte vectors held in one
    block's registers, whole warps of at most max(ROW_QUANT_THREADS)
    threads and no warp without a vector; one block per vector a thread
    holds, so each vector is quantized by exactly one block; the first
    thread target unless that exceeds ROW_QUANT_MAX_BLOCKS blocks."""
    for D in (64, 128, 1024, 4096, 14336, 65536 // elem_bytes):
        n_vec = D * elem_bytes // 16
        for M in (1, 4, 61, 79):
            p = TK.row_quant_plan(M, D, elem_bytes)
            assert p.vpt in TK.ROW_QUANT_VPT and p.threads % 32 == 0
            assert p.threads <= max(TK.ROW_QUANT_THREADS)
            assert p.vpt * p.threads >= n_vec > p.vpt * (p.threads - 32)
            if p.threads > TK.ROW_QUANT_THREADS[0]:
                first = next((v for v in TK.ROW_QUANT_VPT
                              if v * TK.ROW_QUANT_THREADS[0] >= n_vec), None)
                assert first is None or M * first > TK.ROW_QUANT_MAX_BLOCKS
    # the H100's best launches (blocks per row, threads) where timed
    for (M, D), want in {(4, 4096): (2, 256), (4, 14336): (8, 224),
                         (61, 4096): (2, 256), (61, 14336): (4, 448)}.items():
        assert tuple(TK.row_quant_plan(M, D, 2)) == want
    with pytest.raises(ValueError):  # longer than 16 vectors a thread
        TK.row_quant_plan(61, 16 * 512 * 8 + 8, 2)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,D,O", [(4, 256, 512), (61, 128, 256),
                                   (79, 256, 128), (1, 512, 384)])
def test_weight_only_mm_vs_pallas_interpret(dtype, M, D, O):
    """The weight-only leaf, packed K-major ``{'q_kmajor','scale'}``: bf16
    activation x dequantized int8 weight, f32 sums, against the Pallas
    kernel on the JAX (D, O) weight.  Each product is exact on both sides;
    only the f32 summation order differs, so float32 outputs agree to 1e-6
    relative to the largest output and bfloat16 outputs to one bf16
    rounding step (2**-8 relative)."""
    jd, td = DTYPES[dtype]
    y, w, s = _inputs(M, D, O, seed=3 * M + O)
    want = JK.quantized_matmul(jnp.asarray(y).astype(jd), jnp.asarray(w),
                               jnp.asarray(s), tile_o=128, interpret=True)
    got = TQ.mm(_port(y, td), _packed(w, s, "scale"))
    assert got.dtype == td
    g, r = _as_f32(got), _as_f32(want)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.abs(g - r).max() <= rel * np.abs(r).max(), np.abs(g - r).max()


def test_weight_only_leaf_packs_k_major_and_mm_refuses_it_unpacked():
    rng = np.random.RandomState(2)
    w = rng.randint(-127, 128, (2, 64, 48)).astype(np.int8)  # stacked
    s = rng.rand(2, 48).astype(np.float32)
    leaf = {"q": torch.from_numpy(w), "scale": torch.from_numpy(s)}
    packed = TQ.pack_kmajor(leaf)
    assert set(packed) == {TQ.KMAJOR, "scale"}
    assert tuple(packed[TQ.KMAJOR].shape) == (2, 48, 64)
    assert packed[TQ.KMAJOR].is_contiguous()
    back = TQ.unpack_kmajor(packed)
    assert set(back) == {"q", "scale"}
    np.testing.assert_array_equal(back["q"].numpy(), w)
    np.testing.assert_array_equal(back["scale"].numpy(), s)
    y = torch.from_numpy(rng.randn(3, 64).astype(np.float32))
    with pytest.raises(ValueError, match="pack_kmajor"):
        TQ.mm(y, {k: v[0] for k, v in leaf.items()})
    got = TQ.mm(y, {k: v[0] for k, v in packed.items()})
    want = TK.w8_bf16_gemm_plain(y, leaf["q"][0].T.contiguous(),
                                 leaf["scale"][0])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("sms", [132, 114, 8])
def test_gemm_plan_holds_a_weight_only_call_in_one_row_tile(sms):
    """``w8_bf16_gemm`` takes ``gemm_plan``'s grid: at the beam step's and
    the prefill's M (1, 4, 61, 79) one row tile holds every row, so the
    weight crosses memory once, and the splits cover D once."""
    for D, O in FLAGSHIP_DO[:4] + TINY_DO:
        for M in (1, 4, 61, 79):
            p = TK.gemm_plan(M, D, O, sms)
            assert p.n_mtiles == 1 and p.rows >= M, (M, D, O, p)
            bounds = [min(D, i * p.k_split) for i in range(p.n_split + 1)]
            assert bounds[0] == 0 and bounds[-1] == D
            assert all(a < b for a, b in zip(bounds, bounds[1:]))


def _mixed_leaves(D, O, seed, dtype=torch.float32):
    """One leaf of each layout ``mm`` takes, all (D, O)-shaped; the float
    leaves in ``dtype``."""
    rng = np.random.RandomState(seed)
    w = rng.randint(-127, 128, (D, O)).astype(np.int8)
    s = (rng.rand(O) * 1e-2 + 1e-4).astype(np.float32)
    sg = (rng.rand(D // 32, O) * 1e-2 + 1e-4).astype(np.float32)
    sg64 = (rng.rand(D // 64, O) * 1e-2 + 1e-4).astype(np.float32)
    f = (rng.randn(D, O) / np.sqrt(D)).astype(np.float32)
    a = rng.randn(D, 8).astype(np.float32)
    b = rng.randn(8, O).astype(np.float32)
    t = torch.from_numpy
    return {
        "w8a8": _packed(w, s),
        "w8a8_other": _packed(w[:, ::-1].copy(), s[::-1].copy()),
        "grouped32": _packed(w, sg),
        "grouped64": _packed(w, sg64),
        "weight_only": _packed(w, s, "scale"),
        "float": t(f).to(dtype),
        "lowrank": {"a": t(a).to(dtype), "b": t(b).to(dtype)},
    }


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kinds", [
    ("w8a8", "w8a8_other", "w8a8"),
    ("grouped32", "grouped32"),
    ("weight_only", "weight_only"),
    ("float", "float"),
    ("w8a8", "grouped32", "weight_only", "float", "lowrank", "grouped64",
     "w8a8_other", "grouped32"),
], ids=["per_channel", "grouped", "weight_only", "float", "mixed"])
def test_mm_many_bitwise_equals_separate_mm(dtype, kinds):
    _, td = DTYPES[dtype]
    leaves = _mixed_leaves(128, 96, seed=len(kinds), dtype=td)
    y = _port(np.random.RandomState(9).randn(2, 3, 128).astype(np.float32)
              * 2.0, td)
    ws = [leaves[k] for k in kinds]
    got = TQ.mm_many(y, ws)
    assert isinstance(got, tuple) and len(got) == len(ws)
    for g, w in zip(got, ws):
        want = TQ.mm(y, w)
        assert g.dtype == want.dtype and tuple(g.shape) == (2, 3, 96)
        np.testing.assert_array_equal(_as_f32(g), _as_f32(want))


def test_mm_many_quantizes_each_layout_once(monkeypatch):
    calls = {"row": 0, "group": []}

    def row(y):
        calls["row"] += 1
        return TK.row_quant_int8(y)

    def group(y, gs):
        calls["group"].append(gs)
        return TK.group_quant_int8(y, gs)

    monkeypatch.setattr(TQ, "row_quant_int8", row)
    monkeypatch.setattr(TQ, "group_quant_int8", group)
    leaves = _mixed_leaves(128, 96, seed=0)
    y = torch.from_numpy(np.random.RandomState(1).randn(4, 128).astype(
        np.float32))
    TQ.mm_many(y, [leaves[k] for k in ("w8a8", "grouped32", "w8a8_other",
                                       "weight_only", "grouped64",
                                       "grouped32")])
    assert calls == {"row": 1, "group": [32, 64]}


def test_lowrank_and_plain_leaves():
    rng = np.random.RandomState(0)
    y = rng.randn(2, 5, 16).astype(np.float32)
    a = rng.randn(16, 4).astype(np.float32)
    b = rng.randn(4, 24).astype(np.float32)
    want = JQ.mm(jnp.asarray(y), {"a": jnp.asarray(a), "b": jnp.asarray(b)})
    got = TQ.mm(torch.from_numpy(y), {"a": torch.from_numpy(a),
                                      "b": torch.from_numpy(b)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _grouped_inputs(M, D, O, gs, seed):
    y, w, _ = _inputs(M, D, O, seed)
    s = (np.random.RandomState(seed + 1).rand(D // gs, O) * 1e-2 + 1e-4
         ).astype(np.float32)
    return y, w, s


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,D,gs", [(1, 64, 32), (5, 256, 64), (4, 512, 128),
                                    (61, 1792, 128), (3, 64, 4), (6, 96, 8)])
def test_group_quant_int8_bitwise_vs_quantize_activation_grouped(dtype, M, D,
                                                                 gs):
    jd, td = DTYPES[dtype]
    y, _, _ = _inputs(M, D, 4, seed=D + 3 * M)
    # amax 127 makes the group's scale 1.0: exact .5 quotients need
    # round-half-even
    y[0, :4] = [127.0, 0.5, -1.5, 2.5]
    y[-1, -gs:] = 0.0  # an all-zero group takes the 1e-8 floor scale
    jq, js = JK.quantize_activation_grouped(jnp.asarray(y).astype(jd), gs)
    tq, ts = TK.group_quant_int8(_port(y, td), gs)
    assert tq.dtype == torch.int8 and tuple(ts.shape) == (M, D // gs)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,D,O,gs", [(5, 256, 384, 64), (4, 512, 256, 128),
                                      (61, 256, 128, 32)])
def test_grouped_mm_bitwise_vs_pallas_interpret(dtype, M, D, O, gs):
    """Grouped W8A8 (2-D scale_a8): the same int8 dots and the same f32
    rescale-accumulate, one fused multiply-add per group in group order,
    as XLA compiles the Pallas kernel body."""
    jd, td = DTYPES[dtype]
    y, w, s = _grouped_inputs(M, D, O, gs, seed=M + D + O)
    want = JK.quantized_matmul_w8a8_grouped(
        jnp.asarray(y).astype(jd), jnp.asarray(w), jnp.asarray(s),
        tile_o=128, interpret=True,
    )
    got = TQ.mm(_port(y, td), _packed(w, s))
    assert got.dtype == td and tuple(got.shape) == (M, O)
    np.testing.assert_array_equal(_as_f32(got), _as_f32(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(1, 5, 256, 384, 64), (2, 3, 128, 100, 32),
                                   (1, 61, 1792, 128, 128)])
def test_grouped_mm_vs_jax_xla_path(dtype, shape):
    """JAX ``mm`` sums the G rescaled group products in one reduction,
    without the fused multiply-add, so float32 outputs agree to 1e-6 of the
    largest output and bfloat16 outputs to one bf16 rounding step (2**-8
    relative).  Also covers O not a multiple of 128 and a batch axis."""
    jd, td = DTYPES[dtype]
    B, S, D, O, gs = shape
    y, w, s = _grouped_inputs(B * S, D, O, gs, seed=O + gs)
    y = y.reshape(B, S, D)
    want = _as_f32(JQ.mm(jnp.asarray(y).astype(jd),
                         {"q": jnp.asarray(w), "scale_a8": jnp.asarray(s)}))
    got = _as_f32(TQ.mm(_port(y, td), _packed(w, s)))
    assert got.shape == (B, S, O)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("M,D,O,gs", [(5, 256, 100, 8), (3, 256, 30, 8),
                                      (4, 512, 64, 16), (7, 96, 129, 16)])
def test_grouped_plain_at_small_groups_vs_jax_reference(dtype, M, D, O, gs):
    """Groups of 8 and 16, and O not a multiple of 4 (the shapes the
    grouped pair's simple route takes on a card): the plain quantizer and
    GEMM on the K-major weight against JAX's
    ``quantized_matmul_w8a8_grouped_reference``, which sums the G rescaled
    group products in one reduction, without the fused multiply-add:
    float32 to 1e-6 of the largest output, bfloat16 to one bf16 rounding
    step (2**-8 relative)."""
    jd, td = DTYPES[dtype]
    y, w, s = _grouped_inputs(M, D, O, gs, seed=D + O + gs)
    want = _as_f32(JK.quantized_matmul_w8a8_grouped_reference(
        jnp.asarray(y).astype(jd), jnp.asarray(w), jnp.asarray(s)))
    yq, ys = TK.group_quant_int8_plain(_port(y, td), gs)
    got = _as_f32(TK.w8a8_grouped_gemm_plain(
        yq, ys, torch.from_numpy(np.ascontiguousarray(w.T)),
        torch.from_numpy(s), td))
    assert got.shape == (M, O)
    rel = 1e-6 if dtype == "float32" else 2.0 ** -8
    assert np.abs(got - want).max() <= rel * np.abs(want).max()


def test_mm_refuses_the_unpacked_grouped_leaf():
    y, w, s = _grouped_inputs(3, 128, 64, 32, seed=4)
    leaf = {"q": torch.from_numpy(w), "scale_a8": torch.from_numpy(s)}
    with pytest.raises(ValueError, match="pack_kmajor"):
        TQ.mm(torch.from_numpy(y), leaf)
    got = TQ.mm(torch.from_numpy(y), TQ.pack_kmajor(leaf))
    want = TK.w8a8_grouped_gemm(*TK.group_quant_int8(torch.from_numpy(y), 32),
                                torch.from_numpy(w.T.copy()), leaf["scale_a8"],
                                torch.float32)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _grouped_segments(p, b):
    """Block b's run under the grouped plan p as the kernel walks it: a
    list of ((weight, output tile, row tile), [stages]) segments."""
    segs = []
    for w, ot, mt, k in TK.grouped_block_work(p, b):
        if segs and segs[-1][0] == (w, ot, mt):
            segs[-1][1].append(k)
        else:
            segs.append(((w, ot, mt), [k]))
    return segs


@pytest.mark.parametrize("gs", [32, 64, 128])
@pytest.mark.parametrize("sms", [132, 114, 8])
def test_grouped_plan_covers_every_group_once(sms, gs):
    """``grouped_plan`` and the runs its blocks walk
    (``grouped_block_work``): every (weight, channel tile, row tile,
    group) exactly once; each block's part of a tile a contiguous run of
    whole groups; a tile split across blocks has its first group with
    its owner, at the end of the owner's run, and its later groups with
    contributors, at the start of theirs; the contributors' parked
    products (the tile's rows, f32) are what the plan counts, fit the slots
    it sizes and stay within 1 / GROUPED_WS_CAP of the weight bytes; a
    plan that splits no tile gives each block whole tiles, narrower row
    tiles only for a launch short of half a wave; the ring fits."""
    cdiv, K = TK._cdiv, TK.W8A8_STAGE_K
    cases = [(D, (O,)) for D, O in FLAGSHIP_DO + TINY_DO + [(4032, 4096)]]
    cases += [(4096, (4096, 1024, 1024)), (4096, (14336, 14336)),
              (64, (64, 32, 32)), (3072, (512, 768))]
    for D, Os in cases:
        if D % gs:
            continue
        G = D // gs
        for M in (1, 4, 5, 8, 61, 79, 384):
            p = TK.grouped_plan(M, D, G, Os, sms)
            assert p.rows in TK.GROUPED_ROWS and p.gs == gs
            assert p.n_mtiles * p.rows >= M > (p.n_mtiles - 1) * p.rows
            assert 1 <= p.blocks <= sms and 2 <= p.stages
            assert TK.grouped_smem(p.rows, G, p.ends, p.stages) <= \
                TK.W8A8_SMEM
            assert p.unit * K % gs == 0 and p.cut in (1, p.upt)
            seen = collections.Counter()
            parked, park, split = 0, 0, set()
            for b in range(p.blocks):
                segs = _grouped_segments(p, b)
                assert segs
                for i, ((w, ot, mt), ks) in enumerate(segs):
                    assert ks == list(range(ks[0], ks[-1] + 1))
                    k0, k1 = ks[0] * K, min((ks[-1] + 1) * K, D)
                    assert k0 % gs == 0 and k1 % gs == 0, (M, D, p)
                    groups = range(k0 // gs, k1 // gs)
                    seen.update((w, ot, mt, g) for g in groups)
                    if ks[0] > 0:  # a contributor: its run's first part
                        assert i == 0 and p.cut == 1
                        split.add((w, ot, mt))
                        park = max(park, len(groups))
                        parked += len(groups) * p.rows * TK.W8A8_TILE_O * 4
                    elif k1 < D:  # the owner: its run's last part
                        assert i == len(segs) - 1 and p.cut == 1
                        assert ks[0] == 0
            want = {(w, ot, mt, g) for w, O in enumerate(Os)
                    for ot in range(cdiv(O, TK.W8A8_TILE_O))
                    for mt in range(p.n_mtiles) for g in range(G)}
            assert set(seen) == want and set(seen.values()) == {1}, (M, D, p)
            assert (parked, park, len(split)) == (
                p.parked_bytes, p.park, p.split_tiles), (M, D, p)
            if p.cut == 1:
                assert parked * TK.GROUPED_WS_CAP <= D * sum(Os), (M, D, p)
            else:
                assert not split and p.park == 0
                otiles = p.tile0[-1] // p.n_mtiles
                if p.n_mtiles > cdiv(M, TK.GROUPED_ROWS[-1]):
                    # narrower row tiles: the widest left half a wave
                    assert 2 * otiles * cdiv(M, TK.GROUPED_ROWS[-1]) < sms
                    assert p.rows >= TK.GROUPED_NARROW_ROWS, (M, D, p)
    # the --group128 beam step runs every projection stream-K, q|k|v and
    # gate|up in one launch each; its prefill splits none
    if sms > 100 and gs == 128:
        for D, Os in ((4096, (4096, 1024, 1024)), (4096, (4096,)),
                      (4096, (14336, 14336)), (14336, (4096,))):
            for M in (1, 4):
                p = TK.grouped_plan(M, D, D // gs, Os, sms)
                assert p.cut == 1 and p.blocks == sms and p.split_tiles
            assert TK.grouped_plan(61, D, D // gs, Os, sms).split_tiles == 0


def test_mm_many_quantized_grouped_is_one_gemm_a_weight(monkeypatch):
    """Grouped leaves of one activation go to ``w8a8_grouped_gemm_many``
    in one call of up to three (q|k|v: one, four leaves: two), and each
    output is bitwise ``w8a8_grouped_gemm`` of its weight alone."""
    calls = []
    many = TK.w8a8_grouped_gemm_many

    def counted(y_q, y_s, w_ts, scales, out_dtype):
        calls.append(len(w_ts))
        return many(y_q, y_s, w_ts, scales, out_dtype)

    monkeypatch.setattr(TQ, "w8a8_grouped_gemm_many", counted)
    y, _, _ = _grouped_inputs(5, 128, 96, 32, seed=21)
    yq, ys = TK.group_quant_int8(torch.from_numpy(y), 32)
    rng = np.random.RandomState(22)
    leaves = [_packed(rng.randint(-127, 128, (128, O)).astype(np.int8),
                      (rng.rand(4, O) * 1e-2 + 1e-4).astype(np.float32))
              for O in (96, 32, 32, 64)]
    for ws, want_calls in ((leaves[:3], [3]), (leaves, [3, 1])):
        calls.clear()
        got = TQ.mm_many_quantized(yq, ys, ws, torch.float32, (5,))
        assert calls == want_calls
        for g, w in zip(got, ws):
            want = TK.w8a8_grouped_gemm(yq, ys, w[TQ.KMAJOR], w["scale_a8"],
                                        torch.float32)
            assert torch.equal(g, want)


@pytest.mark.parametrize("elem_bytes", [2, 4], ids=["bfloat16", "float32"])
def test_group_quant_plan_covers_each_group_once(elem_bytes):
    """``group_quant_int8``'s launch: each of the M * G groups gets its own
    ``lanes`` lanes (a power of two up to a warp, whole groups a warp),
    and lane l takes the group's 16-byte vectors l, l + lanes, ...: every
    vector once, at most ``vpl`` a lane."""
    for gs in (32, 64, 96, 128, 256, 1024):
        n_vec = gs * elem_bytes // 16
        for M in (1, 4, 61, 79):
            for G in (1, 3, 32, 112):
                p = TK.group_quant_plan(M, G * gs, G, elem_bytes)
                assert p.lanes & (p.lanes - 1) == 0 and 32 % p.lanes == 0
                assert n_vec % p.lanes == 0 and p.vpl in TK.GROUP_QUANT_VPL
                assert p.vpl * p.lanes >= n_vec and p.threads % 32 == 0
                assert p.blocks * p.threads >= M * G * p.lanes
                assert (p.blocks - 1) * p.threads < M * G * p.lanes
                seen = np.zeros(n_vec, np.int64)
                for lane in range(p.lanes):
                    seen[lane::p.lanes] += 1
                assert (seen == 1).all()
                assert -(-n_vec // p.lanes) <= p.vpl
    # a 128-value bf16 group is one vector on each of 16 lanes
    assert TK.group_quant_plan(4, 4096, 32, 2)[:2] == (16, 1)
    assert TK.group_quant_plan(4, 4096, 32, 4)[:2] == (32, 1)
    with pytest.raises(ValueError):
        TK.group_quant_plan(1, 8192, 1, 2)  # 1024 vectors: 32 lanes x 32


def test_fma_f32_is_correctly_rounded():
    """The plain grouped GEMM's fused multiply-add against exact rational
    arithmetic, on products that nearly cancel the addend."""
    from fractions import Fraction

    rng = np.random.RandomState(0)
    n = 3000
    a = (rng.randn(n) * 2.0 ** rng.randint(-20, 20, n)).astype(np.float32)
    b = (rng.randn(n) * 2.0 ** rng.randint(-20, 20, n)).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.randn(n) * 1e-7)).astype(
        np.float32)
    got = TK.fma_f32(torch.from_numpy(a), torch.from_numpy(b),
                     torch.from_numpy(c)).numpy()
    for i in range(n):
        x = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        f = got[i]
        for nb in (np.nextafter(f, np.float32(-np.inf)),
                   np.nextafter(f, np.float32(np.inf))):
            d_f, d_n = abs(Fraction(float(f)) - x), abs(Fraction(float(nb)) - x)
            assert d_f < d_n or (d_f == d_n and not f.view(np.int32) & 1), i


def test_launch_counters_stay_zero_on_cpu():
    from infinisst_tpu_torch.kernels import decode_attention as TA

    TK.reset_launch_counts()
    TA.reset_launch_counts()
    y, w, s = _inputs(4, 64, 32, seed=0)
    TQ.mm(torch.from_numpy(y), _packed(w, s))
    TQ.mm(torch.from_numpy(y), _packed(w, s, "scale"))
    TQ.mm(torch.from_numpy(y), _packed(w, np.ones((2, 32), np.float32)))
    yt = torch.from_numpy(y)
    TK.rms_norm_quant_int8(yt, yt, torch.ones((64,)), 1e-5, 64)
    TK.silu_mul_quant_int8(yt, yt, 32)
    q = torch.ones((2, 4, 16))
    cache = torch.ones((1, 8, 2, 16))
    TA.decode_attention(q, cache, cache, torch.tensor([3]),
                        torch.tensor([3, 3]), torch.ones((8,)))
    gen = torch.ones((2, 4, 2, 16))
    TA.beam_attention(q, cache, cache, torch.tensor([3]), gen, gen,
                      torch.tensor([1, 1]), torch.tensor([3, 3]),
                      torch.tensor([3, 3]), torch.ones((8,)))
    assert TK.launch_counts == {
        "row_quant_int8": 0, "w8a8_gemm": 0, "w8_bf16_gemm": 0,
        "group_quant_int8": 0, "w8a8_grouped_gemm": 0,
        "rms_norm_quant_int8": 0, "silu_mul_quant_int8": 0,
    }
    assert TA.launch_counts == {"decode_attention": 0, "beam_attention": 0}
    assert TK.internal_counts == {"w8a8_gemm_split_k": 0,
                                  "w8_bf16_gemm_split_k": 0,
                                  "w8a8_grouped_gemm_split_k": 0,
                                  "group_quant_int8_simple": 0,
                                  "w8a8_grouped_gemm_simple": 0,
                                  "counter_zeroing": 0,
                                  "w8_bf16_gemm_f32_cast": 0}
