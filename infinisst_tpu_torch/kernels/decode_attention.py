"""Rotate-on-read decode attention for Hopper, with its plain PyTorch
versions: ``decode_attention`` (one block of keys) and ``beam_attention``
(the beam step's two blocks in one launch).

Port of the Pallas kernels in ``infinisst_tpu/kernels/decode_attention.py``
(``decode_attention`` :123 and ``decode_attention_batched`` :287, the same
function on two grids) and of the two-block attention of JAX's
``beam_token_step`` (``infinisst_tpu/models/llama.py:346-419``); the CUDA
source is ``infinisst_tpu_torch/csrc/decode_attention.cu``, whose note
gives the bound (the caches' K and V bytes) and the design.

One query position per row, unrotated cache (Bc, C, KV, Dh): half-split
Llama RoPE in float32 on q at ``q_pos`` and on key j at ``key_offset + j``,
keys ``j >= valid_len`` masked with -1e9, softmax, weighted sum of V.
Beyond the JAX signature, for the beam step (``models/llama.py``):

- a cache is shared by a group of query rows: Bc divides B and query
  row b reads cache b // (B / Bc) (the single-stream beam prefix is
  Bc == 1, read by every beam; the serving pool's prefix is one cache a
  slot, read by that slot's beams);
- ``key_offset`` (Bc,) shifts the key positions;
- ``return_lse`` also returns the per-row log-sum-exp of the scores;
- ``beam_attention`` adds the per-beam block: row b's own keys (B, G, KV,
  Dh), key j at ``g_off[b] + j``, masked at ``j >= g_valid[b]``, in the
  same softmax as the prefix, and returns the output and the
  log-sum-exp over both blocks.

The defaults of ``decode_attention`` (no offset, Bc == B, no lse) are the
JAX function.  The wrappers take the plain version for a tensor on the CPU
and launch the kernel for a CUDA tensor, or raise; each launch adds one
to ``launch_counts`` under its entry (and to ``launch_shapes`` under its
query rows and caches).  The grid comes from ``plan`` (a pure function of
the shapes); the kernel cuts the valid keys into its splits as
``split_range`` does.  The kernel reads the cos/sin of its positions from
``rope_table`` (float32, made once for an ``inv_freq`` tensor).
"""

from __future__ import annotations

import ctypes
import functools
import math
import weakref
from typing import NamedTuple

import torch

from infinisst_tpu_torch.core import rope as R
from infinisst_tpu_torch.core.graphs import counter
from infinisst_tpu_torch.kernels.quant_matmul import (
    _check,
    _raise_on,
    _stream,
    sm_count,
)

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head widths
# csrc/decode_attention.cu: query rows per block (one m16 tile), keys of a
# work unit (a consumer warp's step), splits at most (a cluster)
ROWS = 16
UNIT = 16
MAX_SPLIT = 16
# the fewest units of a split worth a block of the cluster
MIN_UNITS = 4
# the split target, blocks an SM: two of 5 warps (about 109 KB of shared
# memory at Dh 128) fit an SM, but the clusters' blocks then did not all
# fit one wave (the pool's beam step ran slower at 4 splits than at 3;
# ``tools/attention_phases.py --sweep-splits``, PERF.md)
BLOCKS_PER_SM = 1.5
# positions of the cos/sin table, at least (it grows in steps of 1024)
TABLE_MIN = 4096

# both registered with ``core.graphs`` (replays count what they hold)
launch_counts = counter({"decode_attention": 0, "beam_attention": 0})
# the same launches by entry, query rows and caches: "B=20 Bc=1" (the
# tree verify's prefix), "beam B=32 Bc=8" (the serving pool's beam step)
launch_shapes = counter({})


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0
    launch_shapes.clear()


_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signature of a built ``decode_attention`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.attention.argtypes = (
        [vp] * 12 + [ci, vp, vp] + [ci] * 9 + [ctypes.c_float, vp])
    for fn in (lib.attention, lib.decode_attention_rows_per_block,
               lib.decode_attention_unit, lib.decode_attention_max_split):
        fn.restype = ci
    if (lib.decode_attention_rows_per_block(), lib.decode_attention_unit(),
            lib.decode_attention_max_split()) != (ROWS, UNIT, MAX_SPLIT):
        raise RuntimeError("decode_attention: the plan's constants differ "
                           "from the kernel's")
    return lib


def _library():
    global _lib
    if _lib is None:
        from infinisst_tpu_torch.kernels._build import load_library

        _lib = _bind(load_library("decode_attention"))
    return _lib


def _shapes(q, cache_k):
    B, H, Dh = q.shape
    Bc, C, KV, _ = cache_k.shape
    return B, H, Dh, Bc, C, KV


def _rotated_keys(cache_k, k_pos, inv_freq):
    """(N, KV, L, Dh) float32 keys rotated at k_pos (N, L)."""
    return R.apply_llama_rope(cache_k.transpose(1, 2).to(torch.float32),
                              k_pos[:, None], inv_freq)


def _rotated_queries(q, q_pos, inv_freq):
    B, H, Dh = q.shape
    return R.apply_llama_rope(
        q.to(torch.float32).reshape(B, H, 1, Dh),
        q_pos.to(q.device)[:, None, None], inv_freq,
    )[:, :, 0]


def decode_attention_plain(q, cache_k, cache_v, valid_len, q_pos, inv_freq,
                           key_offset=None, return_lse=False):
    """``decode_attention_reference`` (:192) with the rotations in float32,
    as the kernel computes them, and the beam step's generalisations."""
    B, H, Dh, Bc, C, KV = _shapes(q, cache_k)
    dev = q.device
    j = torch.arange(C, device=dev)
    k_pos = j[None].expand(Bc, C)
    if key_offset is not None:
        k_pos = k_pos + key_offset.to(dev)[:, None]
    kr = _rotated_keys(cache_k, k_pos, inv_freq)  # (Bc, KV, C, Dh)
    qr = _rotated_queries(q, q_pos, inv_freq)
    # query rows grouped by the cache they read, (Bc, B / Bc, KV, G, Dh):
    # a cache broadcasts over its group's rows
    qg = qr.reshape(Bc, B // Bc, KV, H // KV, Dh)
    s = (qg @ kr[:, None].transpose(-1, -2)) * (1.0 / math.sqrt(Dh))
    mask = j[None] < valid_len.to(dev)[:, None]  # (Bc, C)
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full((), NEG_INF, dtype=s.dtype, device=dev))
    w = torch.softmax(s, dim=-1)  # (Bc, B / Bc, KV, G, C)
    out = w @ cache_v.transpose(1, 2).to(torch.float32)[:, None]
    out = out.reshape(B, H, Dh).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, H)
    return out


def beam_attention_plain(q, prefix_k, prefix_v, plen, gen_k, gen_v, g_valid,
                         g_off, q_pos, inv_freq):
    """The two-block attention of JAX's ``beam_token_step`` as JAX computes
    it: one float32 softmax over the scores of the prefix (P caches, key j
    at j, masked at j >= plen) and of each row's per-beam keys (key j at
    g_off + j, masked at j >= g_valid), concatenated.  Returns (out (B, H,
    Dh) in q's dtype, lse (B, H) float32)."""
    B, H, Dh, P, C, KV = _shapes(q, prefix_k)
    G = gen_k.shape[1]
    dev = q.device
    scale = 1.0 / math.sqrt(Dh)
    neg = torch.full((), NEG_INF, dtype=torch.float32, device=dev)
    jp, jg = torch.arange(C, device=dev), torch.arange(G, device=dev)
    qr = _rotated_queries(q, q_pos, inv_freq)
    kr_p = _rotated_keys(prefix_k, jp[None].expand(P, C), inv_freq)
    kr_g = _rotated_keys(gen_k, g_off.to(dev)[:, None] + jg[None], inv_freq)
    # the prefix broadcast over its cache's rows, (P, B / P, KV, Gq, C)
    qg = qr.reshape(P, B // P, KV, H // KV, Dh)
    s_p = (qg @ kr_p[:, None].transpose(-1, -2)) * scale
    s_p = torch.where((jp[None] < plen.to(dev)[:, None])[
        :, None, None, None, :], s_p, neg).reshape(B, KV, H // KV, C)
    s_g = (qr.reshape(B, KV, H // KV, Dh) @ kr_g.transpose(-1, -2)) * scale
    s_g = torch.where((jg[None] < g_valid.to(dev)[:, None])[
        :, None, None, :], s_g, neg)
    s = torch.cat([s_p, s_g], dim=-1)  # (B, KV, Gq, C + G)
    w = torch.softmax(s, dim=-1)
    vp = prefix_v.transpose(1, 2).to(torch.float32)[:, None]  # (P,1,KV,C,Dh)
    out = (w[..., :C].reshape(P, B // P, KV, H // KV, C) @ vp).reshape(
        B, KV, H // KV, Dh)
    out = out + w[..., C:] @ gen_v.transpose(1, 2).to(torch.float32)
    return (out.reshape(B, H, Dh).to(q.dtype),
            torch.logsumexp(s, dim=-1).reshape(B, H))


def _cdiv(a, b):
    return -(-a // b)


class AttentionPlan(NamedTuple):
    n_split: int  # splits per (cache, KV head, row tile): a cluster
    n_rtiles: int  # row tiles of ROWS query rows per (cache, KV head)
    groups: int  # (cache, KV head, row tile) triples


@functools.lru_cache(maxsize=None)
def plan(B, Bc, C, KV, Gq, sms, G=0) -> AttentionPlan:
    """The grid of the kernel on a card with ``sms`` SMs: the B / Bc * Gq
    query rows that read one (cache, KV head) in row tiles of ROWS, and
    at most BLOCKS_PER_SM blocks per SM over (cache, KV head, row tile,
    split), so that they run in one wave; no more splits than the
    capacity holds MIN_UNITS units (the prefix's C keys and, with a
    per-beam block of G keys, the buffers of the beams a row tile reads),
    and at most MAX_SPLIT."""
    rpc = B // Bc
    r_total = rpc * Gq
    n_rtiles = _cdiv(r_total, ROWS)
    groups = Bc * KV * n_rtiles
    beams = min(rpc, _cdiv(ROWS, Gq) + 1) if G else 0
    units = _cdiv(C, UNIT) + beams * _cdiv(G, UNIT)
    n_split = max(1, min(int(BLOCKS_PER_SM * sms) // groups,
                         _cdiv(units, MIN_UNITS), MAX_SPLIT))
    return AttentionPlan(n_split, n_rtiles, groups)


def units_of(c_eff, g_eff=()):
    """The work units of a (cache, KV head, row tile): the prefix's
    c_eff keys and each per-beam buffer's g_eff keys in UNIT-key units
    (the kernel reads the effective lengths from the valid lengths on the
    card: min(valid, capacity), or the whole capacity at valid 0)."""
    return _cdiv(c_eff, UNIT) + sum(_cdiv(g, UNIT) for g in g_eff)


def split_range(units, n_split, s):
    """Units [begin, end) of split ``s`` over a group's ``units`` (the
    kernel cuts them the same way on the card): runs of equal length,
    the last ones short or empty."""
    per = _cdiv(units, n_split)
    begin = min(s * per, units)
    return begin, min(begin + per, units)


_tables = {}


def rope_table(inv_freq: torch.Tensor, positions: int) -> torch.Tensor:
    """(T, Dh) float32 [cos, sin] of f32(pos) * inv_freq by position
    (interleaved by frequency), T >= ``positions`` and TABLE_MIN, made once
    for the ``inv_freq`` tensor and kept while it lives (positions past T
    the kernel computes itself).  A table of a size this tensor has not
    had is made eagerly: inside a CUDA graph capture it raises."""
    key = id(inv_freq)
    hit = _tables.get(key)
    if hit is not None and (hit[0]() is not inv_freq
                            or hit[1] != inv_freq._version):
        hit = None
    if hit is not None and hit[2][-1].shape[0] >= positions:
        return hit[2][-1]
    if inv_freq.is_cuda and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(
            "decode_attention: the RoPE table for these positions is made "
            "eagerly: run the call once before capturing it")
    for k in [k for k, v in _tables.items() if v[0]() is None]:
        del _tables[k]
    T = max(TABLE_MIN, _cdiv(positions, 1024) * 1024)
    f = torch.arange(T, dtype=torch.float32, device=inv_freq.device)[
        :, None] * inv_freq[None].to(torch.float32)
    table = torch.stack([torch.cos(f), torch.sin(f)], -1).reshape(T, -1) \
        .contiguous()
    # a smaller table of the same tensor stays alive: a captured graph may
    # hold its address
    older = [] if hit is None else hit[2]
    _tables[key] = (weakref.ref(inv_freq), inv_freq._version, older + [table])
    return table


def _aligned(name, t):
    if t.data_ptr() % 16 or (t.shape[-1] * t.element_size()) % 16:
        raise ValueError(f"decode_attention: {name} must be 16-byte aligned "
                         f"with rows of a multiple of 16 bytes (TMA)")


def _launch(entry, q, pk, pv, plen, poff, gk, gv, g_valid, g_off, q_pos,
            inv_freq, return_lse):
    dev = q.device
    B, H, Dh, P, C, KV = _shapes(q, pk)
    G = 0 if gk is None else gk.shape[1]
    lib = _library()
    table = rope_table(inv_freq, C + G)
    for name, t in (("cache_k", pk), ("cache_v", pv), ("gen_k", gk),
                    ("gen_v", gv), ("table", table)):
        if t is not None:
            _aligned(name, t)
    n_split = plan(B, P, C, KV, H // KV, sm_count(dev), G).n_split
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.attention(
        q.data_ptr(), pk.data_ptr(), pv.data_ptr(), plen.data_ptr(),
        ptr(poff), ptr(gk), ptr(gv), ptr(g_valid), ptr(g_off),
        q_pos.data_ptr(), inv_freq.data_ptr(), table.data_ptr(),
        table.shape[0], out.data_ptr(), ptr(lse),
        int(q.dtype == torch.bfloat16), B, H, KV, Dh, P, C, G, n_split,
        1.0 / math.sqrt(Dh), _stream(q),
    )
    _raise_on(err, entry)
    launch_counts[entry] += 1
    key = f"{'beam ' if G else ''}B={B} Bc={P}"
    launch_shapes[key] = launch_shapes.get(key, 0) + 1
    return out, lse


def _check_common(q, cache_k, cache_v, valid_len, q_pos, inv_freq,
                  key_offset=None):
    dev = q.device
    _check("q", q, (torch.bfloat16, torch.float32), 3, dev)
    _check("cache_k", cache_k, (q.dtype,), 4, dev)
    _check("cache_v", cache_v, (q.dtype,), 4, dev)
    _check("valid_len", valid_len, (torch.int32,), 1, dev)
    _check("q_pos", q_pos, (torch.int32,), 1, dev)
    _check("inv_freq", inv_freq, (torch.float32,), 1, dev)
    if key_offset is not None:
        _check("key_offset", key_offset, (torch.int32,), 1, dev)
    B, H, Dh, Bc, C, KV = _shapes(q, cache_k)
    if (cache_v.shape != cache_k.shape or cache_k.shape[3] != Dh
            or Bc < 1 or B % Bc or H % KV or Dh not in HEAD_DIMS
            or B < 1 or C < 1
            or valid_len.shape[0] != Bc or q_pos.shape[0] != B
            or inv_freq.shape[0] != Dh // 2
            or (key_offset is not None and key_offset.shape[0] != Bc)):
        raise ValueError(
            f"decode_attention: shapes q {tuple(q.shape)} cache "
            f"{tuple(cache_k.shape)}/{tuple(cache_v.shape)} valid_len "
            f"{tuple(valid_len.shape)} q_pos {tuple(q_pos.shape)} inv_freq "
            f"{tuple(inv_freq.shape)} (Dh one of {HEAD_DIMS})"
        )


def decode_attention(q, cache_k, cache_v, valid_len, q_pos, inv_freq,
                     key_offset=None, return_lse=False):
    """Fused rotate-on-read decode attention.  q (B, H, Dh) unrotated;
    cache_k / cache_v (Bc, C, KV, Dh) unrotated, Bc dividing B (query row
    b reads cache b // (B / Bc)); valid_len (Bc,); q_pos (B,); inv_freq
    (Dh/2,) float32; key_offset (Bc,) or None.  Returns (B, H, Dh) in q's
    dtype, and the (B, H) float32 log-sum-exp when ``return_lse``."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, cache_k, cache_v, valid_len, q_pos,
                                      inv_freq, key_offset, return_lse)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    _check_common(q, cache_k, cache_v, valid_len, q_pos, inv_freq,
                  key_offset)
    out, lse = _launch("decode_attention", q, cache_k, cache_v, valid_len,
                       key_offset, None, None, None, None, q_pos, inv_freq,
                       return_lse)
    return (out, lse) if return_lse else out


def decode_attention_batched(q, cache_k, cache_v, valid_len, q_pos,
                             inv_freq):
    """Port of ``decode_attention_batched`` (:287): the same function as
    ``decode_attention``, and the same kernel, whose one launch already
    covers every batch element and KV head."""
    return decode_attention(q, cache_k, cache_v, valid_len, q_pos, inv_freq)


def beam_attention(q, prefix_k, prefix_v, plen, gen_k, gen_v, g_valid, g_off,
                   q_pos, inv_freq):
    """The beam step's attention in one launch: q (B, H, Dh) unrotated at
    q_pos (B,); the prefix caches prefix_k / prefix_v (P, C, KV, Dh), P
    dividing B (row b reads cache b // (B / P)), key j at j, valid plen
    (P,); each row's per-beam keys gen_k / gen_v (B, G, KV, Dh), key j at
    g_off[b] + j, valid g_valid (B,); inv_freq (Dh/2,) float32.  Returns
    (out (B, H, Dh) in q's dtype, lse (B, H) float32): one softmax over
    both blocks, as ``beam_attention_plain``."""
    if q.device.type == "cpu":
        return beam_attention_plain(q, prefix_k, prefix_v, plen, gen_k,
                                    gen_v, g_valid, g_off, q_pos, inv_freq)
    if q.device.type != "cuda":
        raise ValueError(f"beam_attention: unsupported device {q.device}")
    _check_common(q, prefix_k, prefix_v, plen, q_pos, inv_freq)
    dev = q.device
    _check("gen_k", gen_k, (q.dtype,), 4, dev)
    _check("gen_v", gen_v, (q.dtype,), 4, dev)
    _check("g_valid", g_valid, (torch.int32,), 1, dev)
    _check("g_off", g_off, (torch.int32,), 1, dev)
    B, H, Dh = q.shape
    if (gen_v.shape != gen_k.shape or gen_k.shape[0] != B
            or gen_k.shape[2:] != prefix_k.shape[2:] or gen_k.shape[1] < 1
            or g_valid.shape[0] != B or g_off.shape[0] != B):
        raise ValueError(
            f"beam_attention: shapes q {tuple(q.shape)} prefix "
            f"{tuple(prefix_k.shape)} per-beam {tuple(gen_k.shape)}/"
            f"{tuple(gen_v.shape)} g_valid {tuple(g_valid.shape)} g_off "
            f"{tuple(g_off.shape)}")
    return _launch("beam_attention", q, prefix_k, prefix_v, plen, None,
                   gen_k, gen_v, g_valid, g_off, q_pos, inv_freq, True)


def merge_blocks(out_a, lse_a, out_b, lse_b):
    """One softmax over two key blocks from each block's normalised output
    (B, H, Dh) and log-sum-exp (B, H): equal to attending over the
    concatenated keys, up to float32 rounding.  A block whose keys are all
    masked (-1e9) gets weight 0 next to any real key.  The speculative
    tree verify (``llama.beam_tree_step``) joins its prefix to a block it
    computes in torch this way."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    out = (out_a.to(torch.float32) * wa + out_b.to(torch.float32) * wb) / (
        wa + wb)
    return out.to(out_a.dtype)
