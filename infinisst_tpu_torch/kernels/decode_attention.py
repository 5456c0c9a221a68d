"""Rotate-on-read decode attention for Hopper, with its plain PyTorch
version.

Port of the Pallas kernels in ``infinisst_tpu/kernels/decode_attention.py``
(``decode_attention`` :123 and ``decode_attention_batched`` :287, the same
function on two grids); the CUDA source is
``infinisst_tpu_torch/csrc/decode_attention.cu``, whose note gives the
bound (the cache's K and V bytes) and the design.

One query position per row, unrotated cache (Bc, C, KV, Dh): half-split
Llama RoPE in float32 on q at ``q_pos`` and on key j at ``key_offset + j``,
keys ``j >= valid_len`` masked with -1e9, softmax, weighted sum of V.
Beyond the JAX signature, for the beam step (``models/llama.py``):

- a cache is shared by a group of query rows: Bc divides B and query
  row b reads cache b // (B / Bc) (the single-stream beam prefix is
  Bc == 1, read by every beam; the serving pool's prefix is one cache a
  slot, read by that slot's beams);
- ``key_offset`` (Bc,) shifts the key positions;
- ``return_lse`` also returns the per-row log-sum-exp of the scores, so
  that ``merge_blocks`` can join two blocks into one softmax.

The defaults (no offset, Bc == B, no lse) are the JAX function.  The
wrapper takes the plain version for a tensor on the CPU and launches the
kernel for a CUDA tensor, or raises; each launch adds one to
``launch_counts['decode_attention']`` (and to ``launch_shapes`` under its
query and cache batch).  The grid comes from ``plan`` (a
pure function of the shapes); the kernel cuts a cache's valid keys into
its splits as ``split_range`` does.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from infinisst_tpu_torch.core import rope as R
from infinisst_tpu_torch.core.graphs import counter
from infinisst_tpu_torch.kernels.quant_matmul import (
    _check,
    _raise_on,
    _stream,
    sm_count,
    zeroed_counters,
)

NEG_INF = -1e9
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head widths
# csrc/decode_attention.cu: query rows per block (one m16 tile), the
# fewest keys of a split, and the granule of a split's length
ROWS = 16
MIN_SPLIT = 64
SPLIT_ALIGN = 16
MAX_SPLIT = 64
# the split target: blocks of 8 warps whose steps depend on each other;
# two per SM ran the beam prefix faster than one (measured on the H100)
BLOCKS_PER_SM = 2

# both registered with ``core.graphs`` (replays count what they hold)
launch_counts = counter({"decode_attention": 0})
# the same launches by query rows and caches, "B=32 Bc=8": the serving
# pool's prefix (a batch of caches, each read by its slot's beams) apart
# from the beam step's other blocks
launch_shapes = counter({})


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0
    launch_shapes.clear()


_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``decode_attention`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.decode_attention.argtypes = (
        [vp, vp, vp, ci, vp, vp, vp, vp, vp, vp, vp, vp, vp, vp]
        + [ci] * 7 + [ctypes.c_float, vp]
    )
    for fn in (lib.decode_attention, lib.decode_attention_rows_per_block,
               lib.decode_attention_min_split,
               lib.decode_attention_split_align,
               lib.decode_attention_max_split):
        fn.restype = ci
    if (lib.decode_attention_rows_per_block(),
            lib.decode_attention_min_split(),
            lib.decode_attention_split_align(),
            lib.decode_attention_max_split()) != (
                ROWS, MIN_SPLIT, SPLIT_ALIGN, MAX_SPLIT):
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
    kr = R.apply_llama_rope(
        cache_k.transpose(1, 2).to(torch.float32), k_pos[:, None], inv_freq
    )  # (Bc, KV, C, Dh)
    qr = R.apply_llama_rope(
        q.to(torch.float32).reshape(B, H, 1, Dh), q_pos.to(dev)[:, None, None],
        inv_freq,
    )[:, :, 0]
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


def _cdiv(a, b):
    return -(-a // b)


class AttentionPlan(NamedTuple):
    n_split: int  # key splits per (cache batch, KV head, row tile)
    n_rtiles: int  # row tiles of ROWS query rows per (cache, KV head)
    groups: int  # (cache batch, KV head, row tile) triples


@functools.lru_cache(maxsize=None)
def plan(B, Bc, C, KV, Gq, sms) -> AttentionPlan:
    """The grid of ``decode_attention`` on a card with ``sms`` SMs: the
    B / Bc * Gq query rows that read one (cache, KV head) in one row tile
    of ROWS (more rows take more tiles), and at most BLOCKS_PER_SM blocks
    per SM over (cache batch, KV head, split), so that they run in one
    wave; no more splits than the capacity C holds MIN_SPLIT-key splits,
    and at most MAX_SPLIT.  The kernel folds only the splits that hold a
    key."""
    r_total = (B // Bc) * Gq
    n_rtiles = _cdiv(r_total, ROWS)
    groups = Bc * KV * n_rtiles
    n_split = max(1, min(BLOCKS_PER_SM * sms // groups,
                         _cdiv(C, MIN_SPLIT), MAX_SPLIT))
    return AttentionPlan(n_split, n_rtiles, groups)


def split_range(c_eff, n_split, s):
    """Keys [begin, end) of split ``s`` over a cache's c_eff keys (the
    kernel reads valid_len on the card and cuts the same way): splits of
    equal length, at least MIN_SPLIT keys, a multiple of SPLIT_ALIGN; the
    last ones may be short or empty."""
    per = max(MIN_SPLIT, _cdiv(_cdiv(c_eff, n_split), SPLIT_ALIGN)
              * SPLIT_ALIGN)
    begin = s * per
    return begin, max(begin, min(begin + per, c_eff))


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
    dev = q.device
    floats = (torch.bfloat16, torch.float32)
    _check("q", q, floats, 3, dev)
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
    for name, t in (("cache_k", cache_k), ("cache_v", cache_v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} must be 16-byte "
                             "aligned")
    lib = _library()
    n_split, _, groups = plan(B, Bc, C, KV, H // KV, sm_count(dev))
    out = torch.empty((B, H, Dh), dtype=q.dtype, device=dev)
    lse = (torch.empty((B, H), dtype=torch.float32, device=dev)
           if return_lse else None)
    ws_m = ws_l = ws_acc = counters = None
    if n_split > 1:
        ws = torch.empty((B * H * n_split * (Dh + 2),), dtype=torch.float32,
                         device=dev)
        n = B * H * n_split
        ws_m, ws_l, ws_acc = ws[:n], ws[n:2 * n], ws[2 * n:]
        counters = zeroed_counters("decode_attention", dev, groups)

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = lib.decode_attention(
        q.data_ptr(), cache_k.data_ptr(), cache_v.data_ptr(),
        int(q.dtype == torch.bfloat16), valid_len.data_ptr(),
        q_pos.data_ptr(), ptr(key_offset), inv_freq.data_ptr(),
        out.data_ptr(), ptr(lse), ptr(ws_m), ptr(ws_l), ptr(ws_acc),
        ptr(counters), B, H, KV, Dh, Bc, C, n_split, 1.0 / math.sqrt(Dh),
        _stream(q),
    )
    _raise_on(err, "decode_attention")
    launch_counts["decode_attention"] += 1
    key = f"B={B} Bc={Bc}"
    launch_shapes[key] = launch_shapes.get(key, 0) + 1
    return (out, lse) if return_lse else out


def decode_attention_batched(q, cache_k, cache_v, valid_len, q_pos,
                             inv_freq):
    """Port of ``decode_attention_batched`` (:287): the same function as
    ``decode_attention``, and the same kernel, whose one launch already
    covers every batch element and KV head."""
    return decode_attention(q, cache_k, cache_v, valid_len, q_pos, inv_freq)


def merge_blocks(out_a, lse_a, out_b, lse_b):
    """One softmax over two key blocks from each block's normalised output
    (B, H, Dh) and log-sum-exp (B, H): equal to attending over the
    concatenated keys, up to float32 rounding.  A block whose keys are all
    masked (-1e9) gets weight 0 next to any real key."""
    m = torch.maximum(lse_a, lse_b)
    wa = torch.exp(lse_a - m)[..., None]
    wb = torch.exp(lse_b - m)[..., None]
    out = (out_a.to(torch.float32) * wa + out_b.to(torch.float32) * wb) / (
        wa + wb)
    return out.to(out_a.dtype)
