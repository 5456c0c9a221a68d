"""The port's rotate-on-read decode attention (plain version, on the CPU)
against ``infinisst_tpu.kernels.decode_attention``: the jnp reference, the
Pallas kernel in interpret mode, and a direct float64 softmax for the beam
step's generalisations (shared cache, key offset, log-sum-exp, the merge of
two blocks).

Tolerance: float32 throughout, the same rotations and softmax with sums
taken in another order, so 1e-5 of the largest |reference| value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from infinisst_tpu.kernels import decode_attention as JA
from infinisst_tpu_torch.core.rope import llama_rope_freqs
from infinisst_tpu_torch.kernels import decode_attention as TA

torch.set_num_threads(1)

RTOL = 1e-5


def _inputs(B, Bc, C, H, KV, Dh, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(B, H, Dh).astype(np.float32)
    k = rng.randn(Bc, C, KV, Dh).astype(np.float32)
    v = rng.randn(Bc, C, KV, Dh).astype(np.float32)
    inv = llama_rope_freqs(Dh, 500000.0, scaling=False).astype(np.float32)
    return q, k, v, inv


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max()
    assert err <= rtol * np.abs(want).max(), (err, np.abs(want).max())


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("fn", ["decode_attention", "decode_attention_batched"])
@pytest.mark.parametrize("B,H,KV,valid", [(1, 4, 4, [9]), (2, 8, 2, [5, 40]),
                                          (2, 4, 1, [0, 17])])
def test_plain_vs_jax_reference(fn, B, H, KV, valid):
    """GQA, ragged valid_len, a valid_len past C and a fully masked
    cache (valid_len 0: uniform weights, as the reference gives)."""
    C, Dh = 32, 16
    q, k, v, inv = _inputs(B, B, C, H, KV, Dh, seed=B * H + KV)
    vl = np.asarray(valid, np.int32)
    qp = vl + np.arange(B, dtype=np.int32) * 3
    want = JA.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl),
        jnp.asarray(qp), jnp.asarray(inv))
    got = getattr(TA, fn)(*_t(q, k, v, vl, qp, inv))
    _close(got.numpy(), want)


def test_plain_vs_pallas_interpret():
    B, C, H, KV, Dh = 2, 16, 4, 2, 16
    q, k, v, inv = _inputs(B, B, C, H, KV, Dh, seed=7)
    vl = np.asarray([11, 16], np.int32)
    qp = np.asarray([11, 20], np.int32)
    args = (jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(vl),
            jnp.asarray(qp), jnp.asarray(inv))
    got = TA.decode_attention(*_t(q, k, v, vl, qp, inv)).numpy()
    _close(got, JA.decode_attention(*args, tile=8, interpret=True))
    _close(got, JA.decode_attention_batched(*args, tile=8, interpret=True))


def _rope64(x, pos, inv):
    """Half-split RoPE in float64; x (..., Dh), pos broadcastable to x's
    leading axes."""
    f = np.asarray(pos, np.float64)[..., None] * inv.astype(np.float64)
    c, s = np.cos(f), np.sin(f)
    h = x.shape[-1] // 2
    x1, x2 = x[..., :h].astype(np.float64), x[..., h:].astype(np.float64)
    return np.concatenate([x1 * c - x2 * s, x2 * c + x1 * s], axis=-1)


def _direct(q, blocks, q_pos, inv):
    """Attention of q (B, H, Dh) over the concatenation of ``blocks``
    [(k (B or 1, C, KV, Dh), v, valid (B or 1,), offset (B or 1,))] in
    float64: one softmax over all scores, -1e9 on masked keys.  Returns
    (out (B, H, Dh), lse (B, H))."""
    B, H, Dh = q.shape
    KV = blocks[0][0].shape[2]
    qr = _rope64(q, q_pos[:, None], inv).reshape(B, KV, H // KV, Dh)
    scores, values = [], []
    for k, v, valid, off in blocks:
        C = k.shape[1]
        j = np.arange(C)
        kr = _rope64(k, (off[:, None] + j)[:, :, None], inv)  # (Bc, C, KV, Dh)
        kr = np.broadcast_to(kr, (B,) + kr.shape[1:])
        s = np.einsum("bkgd,bckd->bkgc", qr, kr) / np.sqrt(Dh)
        ok = np.broadcast_to(j[None] < valid[:, None], (B, C))
        scores.append(np.where(ok[:, None, None], s, -1e9))
        values.append(np.broadcast_to(v.astype(np.float64),
                                      (B,) + v.shape[1:]))
    s = np.concatenate(scores, -1)
    m = s.max(-1, keepdims=True)
    p = np.exp(s - m)
    lse = (m + np.log(p.sum(-1, keepdims=True)))[..., 0].reshape(B, H)
    out = np.einsum("bkgc,bckd->bkgd", p / p.sum(-1, keepdims=True),
                    np.concatenate(values, 1))
    return out.reshape(B, H, Dh), lse


@pytest.mark.parametrize("shared", [True, False])
def test_shared_cache_offset_and_lse_vs_direct_softmax(shared):
    B, C, H, KV, Dh = 3, 24, 8, 2, 16
    Bc = 1 if shared else B
    q, k, v, inv = _inputs(B, Bc, C, H, KV, Dh, seed=11)
    vl = np.asarray([19] if shared else [3, 24, 10], np.int32)
    off = np.asarray([40] if shared else [7, 0, 1000], np.int32)
    qp = np.asarray([70, 71, 1200], np.int32)
    want, want_lse = _direct(q, [(k, v, vl, off)], qp, inv)
    got, lse = TA.decode_attention(*_t(q, k, v, vl, qp, inv),
                                   key_offset=torch.from_numpy(off),
                                   return_lse=True)
    _close(got.numpy(), want)
    _close(lse.numpy(), want_lse)


@pytest.mark.parametrize("gen_valid", [1, 4, 0])
def test_merge_blocks_is_one_softmax(gen_valid):
    """The beam step's two blocks: a shared prefix and a per-beam block
    whose key j sits at plen + j, merged by their lse, against one softmax
    over the concatenated keys.  gen_valid 0 masks the whole second block,
    which then gets weight 0."""
    beam, C, G, H, KV, Dh = 4, 20, 6, 8, 2, 16
    q, pk, pv, inv = _inputs(beam, 1, C, H, KV, Dh, seed=12)
    _, gk, gv, _ = _inputs(beam, beam, G, H, KV, Dh, seed=13)
    plen = np.asarray([13], np.int32)
    g_valid = np.full((beam,), gen_valid, np.int32)
    g_off = np.full((beam,), 13, np.int32)
    qp = np.full((beam,), 13 + max(gen_valid - 1, 0), np.int32)
    want, _ = _direct(q, [(pk, pv, plen, np.zeros(1, np.int32)),
                          (gk, gv, g_valid, g_off)], qp, inv)
    o_p, lse_p = TA.decode_attention(*_t(q, pk, pv, plen, qp, inv),
                                     return_lse=True)
    o_g, lse_g = TA.decode_attention(*_t(q, gk, gv, g_valid, qp, inv),
                                     key_offset=torch.from_numpy(g_off),
                                     return_lse=True)
    _close(TA.merge_blocks(o_p, lse_p, o_g, lse_g).numpy(), want)


# (B, Bc, C, H, KV): the beam step's two blocks and the pooled shapes at
# the flagship geometry, the serving pool's prefix and per-beam block
# (8 slots x 4 beams), then the tiny model's (its cache capacity 256, the
# per-beam block of a beam-2 step, a pool of 2 slots)
PLAN_SHAPES = [(4, 1, 1280, 32, 8), (4, 4, 10, 32, 8), (4, 4, 1280, 32, 8),
               (4, 4, 4096, 32, 8), (16, 16, 1280, 32, 8),
               (16, 16, 4096, 32, 8), (32, 8, 1280, 32, 8),
               (32, 32, 10, 32, 8), (2, 1, 256, 4, 2), (2, 2, 10, 4, 2),
               (4, 2, 256, 4, 2), (9, 1, 300, 32, 8)]


@pytest.mark.parametrize("sms", [132, 8])
def test_plan_and_split_range_cover_every_key_once(sms):
    """The host plan and the work units the kernel cuts from the valid
    lengths: every unit of a (cache, KV head, row tile) -- the prefix's
    c_eff keys and each per-beam buffer's, UNIT keys a unit -- in exactly
    one split, so every key once; at most MAX_SPLIT splits (one cluster);
    and every query row that reads a (cache, KV head) -- B / Bc of the
    query batch times H / KV heads -- in one of the row tiles."""
    for B, Bc, C, H, KV in PLAN_SHAPES:
        Gq = H // KV
        for G in (0, 10, 64):
            p = TA.plan(B, Bc, C, KV, Gq, sms, G)
            r_total = (B // Bc) * Gq
            assert (p.n_rtiles - 1) * TA.ROWS < r_total <= \
                p.n_rtiles * TA.ROWS
            assert p.groups == Bc * KV * p.n_rtiles
            if B // Bc * Gq == 16:  # the beam prefix, and a pool slot's
                assert p.n_rtiles == 1
            assert 1 <= p.n_split <= TA.MAX_SPLIT
            if sms >= 2 * p.groups and C >= 2 * TA.MIN_UNITS * TA.UNIT:
                assert p.n_split > 1, (B, Bc, C, p)
            beams = min(B // Bc, -(-TA.ROWS // Gq))
            for c_eff in sorted({1, 10, 63, 64, 65, 1000, C // 2, C - 1, C}):
                if not 1 <= c_eff <= C:
                    continue
                g_eff = [min(G, 1 + 21 * i) for i in range(beams)] if G \
                    else []
                units = TA.units_of(c_eff, g_eff)
                assert units * TA.UNIT >= c_eff + sum(g_eff)
                cover = np.zeros(units, np.int64)
                for s in range(p.n_split):
                    b, e = TA.split_range(units, p.n_split, s)
                    assert e >= b
                    if s == 0:
                        assert e > 0
                    cover[b:e] += 1
                assert (cover == 1).all(), (B, Bc, C, c_eff, G, p)


def _two_blocks(B, P, C, G, H, KV, Dh, plen, g_valid, seed):
    """The beam step's two blocks: P prefix caches of C keys (valid
    ``plen``), each of the B rows' per-beam buffer of G keys (valid
    ``g_valid``, key j at the row's prefix length + j), queries at the
    row's prefix length + its newest per-beam key."""
    q, pk, pv, inv = _inputs(B, P, C, H, KV, Dh, seed)
    _, gk, gv, _ = _inputs(B, B, G, H, KV, Dh, seed + 1)
    plen = np.asarray(plen, np.int32)
    g_valid = np.asarray(g_valid, np.int32)
    g_off = np.repeat(plen, B // P).astype(np.int32)
    qp = (g_off + np.maximum(g_valid - 1, 0)).astype(np.int32)
    return q, pk, pv, plen, gk, gv, g_valid, g_off, qp, inv


# (B, P, C, G, H, KV, plen (P,), g_valid (B,)): beam 4 and beam 1, one
# cache and a pool of two, GQA and not, one per-beam key and the full
# buffer, an empty prefix
TWO_BLOCK_CASES = [
    (4, 1, 24, 6, 8, 2, [17], [1, 1, 1, 1]),
    (4, 1, 24, 6, 8, 2, [24], [6, 6, 6, 6]),
    (1, 1, 24, 6, 8, 2, [9], [3]),
    (8, 2, 20, 5, 8, 8, [11, 20], [1, 2, 3, 4, 5, 5, 1, 2]),
    (4, 1, 16, 6, 4, 1, [0], [1, 6, 2, 4]),
    (2, 2, 16, 4, 8, 2, [0, 7], [4, 1]),
]


@pytest.mark.parametrize("case", TWO_BLOCK_CASES,
                         ids=[f"B{c[0]}P{c[1]}KV{c[5]}plen{c[6][0]}"
                              f"gv{c[7][0]}" for c in TWO_BLOCK_CASES])
def test_beam_attention_plain_vs_jax_reference(case):
    """``beam_attention_plain`` against JAX's ``decode_attention_reference``
    run on the two blocks concatenated at their positions: row b's cache
    is its prefix's plen valid keys (positions 0..plen-1) then its own
    g_valid per-beam keys (plen..), the masked keys of both blocks left
    out (they weigh exactly 0 beside a valid key); the lse against the
    float64 softmax over both blocks with every key in place."""
    B, P, C, G, H, KV, plen, g_valid = case
    Dh = 16
    q, pk, pv, plen, gk, gv, g_valid, g_off, qp, inv = _two_blocks(
        B, P, C, G, H, KV, Dh, plen, g_valid, seed=len(plen) * 10 + B)
    slot = np.arange(B) // (B // P)
    n = plen[slot] + g_valid
    cat_k = np.zeros((B, C + G, KV, Dh), np.float32)
    cat_v = np.zeros((B, C + G, KV, Dh), np.float32)
    for b in range(B):
        pl = plen[slot[b]]
        cat_k[b, :pl], cat_v[b, :pl] = pk[slot[b], :pl], pv[slot[b], :pl]
        cat_k[b, pl:n[b]] = gk[b, :g_valid[b]]
        cat_v[b, pl:n[b]] = gv[b, :g_valid[b]]
    want = JA.decode_attention_reference(
        jnp.asarray(q), jnp.asarray(cat_k), jnp.asarray(cat_v),
        jnp.asarray(n.astype(np.int32)), jnp.asarray(qp), jnp.asarray(inv))
    got, lse = TA.beam_attention(*_t(q, pk, pv, plen, gk, gv, g_valid, g_off,
                                     qp, inv))
    _close(got.numpy(), want)
    blocks = [(pk[slot], pv[slot], plen[slot], np.zeros(B, np.int32)),
              (gk, gv, g_valid, g_off)]
    want_out, want_lse = _direct(q, blocks, qp, inv)
    _close(got.numpy(), want_out)
    _close(lse.numpy(), want_lse)


@pytest.mark.parametrize("gen_valid", [1, 4, 0])
def test_beam_attention_plain_is_the_merged_blocks(gen_valid):
    """The one softmax of ``beam_attention_plain`` equals the two blocks
    through ``decode_attention`` merged by their lse (the beam step before
    the two blocks shared a launch); gen_valid 0 masks the whole
    per-beam block, which then weighs 0."""
    beam, C, G, H, KV, Dh = 4, 20, 6, 8, 2, 16
    q, pk, pv, plen, gk, gv, g_valid, g_off, qp, inv = _two_blocks(
        beam, 1, C, G, H, KV, Dh, [13], [gen_valid] * beam, seed=14)
    got, lse = TA.beam_attention(*_t(q, pk, pv, plen, gk, gv, g_valid, g_off,
                                     qp, inv))
    o_p, lse_p = TA.decode_attention(*_t(q, pk, pv, plen, qp, inv),
                                     return_lse=True)
    o_g, lse_g = TA.decode_attention(*_t(q, gk, gv, g_valid, qp, inv),
                                     key_offset=torch.from_numpy(g_off),
                                     return_lse=True)
    _close(got.numpy(), TA.merge_blocks(o_p, lse_p, o_g, lse_g).numpy())
    _close(lse.numpy(), torch.logaddexp(lse_p, lse_g).numpy())


def test_rope_table_is_the_rotation_and_lives_with_its_tensor():
    """The kernel's cos/sin table: the rotation's float32 cos and sin of
    f32(pos) * inv_freq, interleaved by frequency, made once for an
    inv_freq tensor (grown, never shrunk), made again for a new tensor or
    after an in-place change."""
    inv = torch.from_numpy(llama_rope_freqs(16, 500000.0, scaling=False)
                           .astype(np.float32))
    t = TA.rope_table(inv, 100)
    assert t.shape == (TA.TABLE_MIN, 16) and t.dtype == torch.float32
    f = torch.arange(TA.TABLE_MIN, dtype=torch.float32)[:, None] * inv
    assert torch.equal(t[:, 0::2], torch.cos(f))
    assert torch.equal(t[:, 1::2], torch.sin(f))
    assert TA.rope_table(inv, TA.TABLE_MIN) is t
    big = TA.rope_table(inv, TA.TABLE_MIN + 1)
    assert big.shape[0] == TA.TABLE_MIN + 1024
    assert TA.rope_table(inv, 10) is big
    inv.mul_(1.0)
    assert TA.rope_table(inv, 10) is not big
