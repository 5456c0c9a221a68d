"""Streaming attention masks; port of ``infinisst_tpu/core/masks.py``.

Masks are boolean with True = "may attend"; ``additive`` turns one into a
0 / NEG_INF bias for the softmax.
"""

from __future__ import annotations

import torch

NEG_INF = -1e9  # finite -inf stand-in; avoids NaNs for fully-masked rows


def additive(mask: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Boolean mask -> additive bias (0 where allowed, NEG_INF where not)."""
    zero = torch.zeros((), dtype=dtype, device=mask.device)
    neg = torch.full((), NEG_INF, dtype=dtype, device=mask.device)
    return torch.where(mask, zero, neg)


def block_causal_mask(seq_len: int, max_cache_size=None, blocksize: int = 1,
                      device=None) -> torch.Tensor:
    """Offline block-causal mask with a sliding window, bool[seq_len,
    seq_len]: query i may attend key j iff j lies before the end of i's
    block of ``blocksize`` and, with ``max_cache_size``, j >= i -
    max_cache_size."""
    q = torch.arange(seq_len, device=device)[:, None]
    k = torch.arange(seq_len, device=device)[None, :]
    allowed = k < (torch.div(q, blocksize, rounding_mode="floor") + 1) \
        * blocksize
    if max_cache_size is not None:
        allowed = allowed & (k >= q - max_cache_size)
    return allowed


def streaming_chunk_mask(
    seq_len: int,
    prefix_len,
    max_cache_size: int,
    blocksize,
    kv_len: int,
    device=None,
) -> torch.Tensor:
    """Mask for a chunk of ``seq_len`` queries over a right-aligned KV
    buffer of width ``kv_len`` (the cached prefix in the rightmost
    min(prefix_len, max_cache_size) of the first kv_len - seq_len slots,
    then the chunk's own keys).

    Query i (absolute position prefix_len + i) may attend key position p
    iff p < block_end(prefix_len + i), p > prefix_len + i - max_cache_size
    - 1, and the key slot holds a real frame.

    ``prefix_len`` is an int or a (B,) int tensor, and so is ``blocksize``
    (one block size per row: the mixed-multiplier serving pool, where a
    row's chunk of 48 * m frames is one block; a size below 1 counts as
    1); the result is bool[seq_len, kv_len] or bool[B, seq_len, kv_len]."""
    prefix = torch.as_tensor(prefix_len, dtype=torch.int64, device=device)
    if prefix.ndim:
        prefix = prefix.reshape(prefix.shape + (1, 1))
    dev = prefix.device
    if not isinstance(blocksize, int):  # an int stays a kernel argument
        blocksize = torch.as_tensor(blocksize, dtype=torch.int64, device=dev)
    if torch.is_tensor(blocksize) and blocksize.ndim:
        blocksize = torch.clamp(blocksize, min=1).reshape(
            blocksize.shape + (1, 1))
    cache_cap = kv_len - seq_len
    valid_cached = torch.clamp(prefix, max=max_cache_size)
    qi = torch.arange(seq_len, device=dev)[:, None]
    kj = torch.arange(kv_len, device=dev)[None, :]
    q_abs = prefix + qi
    k_abs = torch.where(
        kj < cache_cap, prefix - (cache_cap - kj), prefix + (kj - cache_cap)
    )
    slot_valid = (kj >= cache_cap) | (kj >= cache_cap - valid_cached)
    q_block_end = (torch.div(q_abs, blocksize, rounding_mode="floor") + 1) * blocksize
    allowed = (k_abs < q_block_end) & (k_abs > q_abs - max_cache_size - 1)
    return allowed & slot_valid


def left_aligned_decode_mask(q_len: int, cache_len: int, valid_len,
                             device=None) -> torch.Tensor:
    """Mask for the LLM's incremental decode over a left-aligned KV cache:
    ``valid_len`` real entries in slots [0, valid_len), the ``q_len`` new
    queries stored at [valid_len, valid_len + q_len).  Query i may attend
    every valid cached slot and the new slots up to its own (causal
    within the new block).  ``valid_len`` is an int (bool[q_len,
    cache_len]) or a (B,) tensor (bool[B, q_len, cache_len])."""
    valid = torch.as_tensor(valid_len, dtype=torch.int64, device=device)
    if valid.ndim:
        valid = valid.reshape(valid.shape + (1, 1))
    qi = torch.arange(q_len, device=valid.device)[:, None]
    kj = torch.arange(cache_len, device=valid.device)[None, :]
    return kj < valid + qi + 1
