"""Turn a JAX parameter tree, given as numpy arrays (the caller runs
``jax.device_get``), into the port's tensors.

The layout is kept: (in, out) matrices stay (in, out), layer stacks stay
stacked, grouped ``{'q','scale_a8'}`` leaves become int8 plus float32
scales, ``{'a','b'}`` low-rank leaves stay factor pairs.  One exception:
a per-out-channel leaf, weight-only ``{'q' (..., in, out), 'scale' (...,
out)}`` or W8A8 ``{'q', 'scale_a8' (..., out)}``, is packed K-major into
``{'q_kmajor' (..., out, in), same scale}`` (as ``models/quant.
pack_kmajor`` packs it), on the host, before it reaches the device.  A
W8A8 lm_head (per-channel or grouped scales) narrower than a multiple of
512 columns is first padded with zero weights and zero scales, as
``quant.py`` pads it.
"""

from __future__ import annotations

import numpy as np
import torch

from infinisst_tpu_torch.core.device import resolve_device
from infinisst_tpu_torch.models.quant import KMAJOR, is_unpacked


def _tensor(a, device, dtype):
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes bfloat16 from jax.device_get
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    if dtype is not None and t.is_floating_point():
        t = t.to(dtype)
    return t.to(device).contiguous()


def _convert(tree, device, dtype):
    if is_unpacked(tree):
        q = np.asarray(tree["q"]).astype(np.int8)
        out = {KMAJOR: _tensor(np.ascontiguousarray(np.swapaxes(q, -1, -2)),
                               device, None)}
        for k in ("scale", "scale_a8"):
            if k in tree:
                out[k] = _tensor(np.asarray(tree[k], np.float32), device,
                                 None)
        return out
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "q":
                out[k] = _tensor(np.asarray(v).astype(np.int8), device, None)
            elif k in ("scale", "scale_a8"):
                out[k] = _tensor(np.asarray(v, np.float32), device, None)
            else:
                out[k] = _convert(v, device, dtype)
        return out
    if isinstance(tree, (list, tuple)):
        return [_convert(v, device, dtype) for v in tree]
    return _tensor(tree, device, dtype)


def _pad_head(head):
    """Pad a W8A8 head's vocabulary axis (the last one, for the (V,) and
    grouped (G, V) scales too) to a multiple of 512 with zeros."""
    q = np.asarray(head["q"])
    s = np.asarray(head["scale_a8"], np.float32)
    V = q.shape[-1]
    Vp = ((V + 511) // 512) * 512
    if Vp == V:
        return head

    def pad(a):
        return np.pad(a, [(0, 0)] * (a.ndim - 1) + [(0, Vp - V)])

    return {"q": pad(q), "scale_a8": pad(s)}


def _padded_heads(tree):
    """The tree with its W8A8 lm_head padded (new dicts on the way down;
    the caller's tree is left as it is)."""
    if not isinstance(tree, dict):
        return tree
    out = dict(tree)
    if isinstance(out.get("llama"), dict):
        out["llama"] = _padded_heads(out["llama"])
    head = out.get("lm_head")
    if isinstance(head, dict) and "scale_a8" in head:
        out["lm_head"] = _pad_head(head)
    return out


def from_jax(tree, device="cuda", dtype=None):
    """Numpy parameter tree -> tensors on ``device``; float leaves are cast
    to ``dtype`` when it is given.  Works on a whole speech-LLM tree
    ({'w2v2', 'adapter', 'llama'}) or on any subtree."""
    return _convert(_padded_heads(tree), resolve_device(device), dtype)
