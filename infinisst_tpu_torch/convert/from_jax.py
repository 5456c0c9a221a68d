"""Turn a JAX parameter tree, given as numpy arrays (the caller runs
``jax.device_get``), into the port's tensors.

The layout is kept: (in, out) matrices stay (in, out), layer stacks stay
stacked, ``{'q','scale'}`` / ``{'q','scale_a8'}`` leaves become int8 plus
float32 scales, ``{'a','b'}`` low-rank leaves stay factor pairs.  A W8A8
lm_head (per-channel or grouped scales) narrower than a multiple of 512
columns is padded with zero weights and zero scales, as ``quant.py`` pads
it.
"""

from __future__ import annotations

import numpy as np
import torch

from infinisst_tpu_torch.core.device import resolve_device


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
    q, s = head["q"], head["scale_a8"]
    V = q.shape[-1]
    Vp = ((V + 511) // 512) * 512
    if Vp == V:
        return head
    # the last axis is the vocabulary for (V,) and grouped (G, V) scales
    q = torch.nn.functional.pad(q, (0, Vp - V))
    s = torch.nn.functional.pad(s, (0, Vp - V))
    return {"q": q, "scale_a8": s}


def from_jax(tree, device="cuda", dtype=None):
    """Numpy parameter tree -> tensors on ``device``; float leaves are cast
    to ``dtype`` when it is given.  Works on a whole speech-LLM tree
    ({'w2v2', 'adapter', 'llama'}) or on any subtree."""
    out = _convert(tree, resolve_device(device), dtype)
    for llama in (out.get("llama"), out) if isinstance(out, dict) else ():
        if isinstance(llama, dict):
            head = llama.get("lm_head")
            if isinstance(head, dict) and "scale_a8" in head:
                llama["lm_head"] = _pad_head(head)
    return out
