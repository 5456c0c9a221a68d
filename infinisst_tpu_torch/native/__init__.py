"""Native (C++) host-side components, loaded with ctypes (a copy of
``infinisst_tpu/native/__init__.py``).

``mwer.cpp`` is built with g++ at first use into ``build/native/`` at the
repository root.  Without a compiler the loader returns None and callers
keep their pure-Python paths.  This is host-side scoring, not a device
path.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "native")
_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False


def _build(src: str, out: str) -> bool:
    # build under a private name, then rename: concurrent processes never
    # load a half-written library
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        os.makedirs(os.path.dirname(out), exist_ok=True)
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-o", tmp, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        os.replace(tmp, out)
        return True
    except Exception:
        return False


def load_mwer() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the mwer segmentation library."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = os.path.join(BUILD_DIR, "libmwer.so")
        src = os.path.join(_DIR, "mwer.cpp")
        if not os.path.isfile(so) or (
            os.path.getmtime(src) > os.path.getmtime(so)
        ):
            if not _build(src, so):
                return None
        try:
            lib = ctypes.CDLL(so)
            lib.mwer_segment.restype = ctypes.c_int64
            lib.mwer_segment.argtypes = [
                ctypes.POINTER(ctypes.c_int32),  # hyp
                ctypes.c_int,  # H
                ctypes.POINTER(ctypes.c_int32),  # refs
                ctypes.POINTER(ctypes.c_int32),  # ref_offsets
                ctypes.c_int,  # R
                ctypes.c_int,  # band
                ctypes.POINTER(ctypes.c_int32),  # out_bounds
            ]
            _LIB = lib
        except OSError:
            _LIB = None
        return _LIB


def mwer_segment_native(hyp_tokens, ref_token_lists, band: int = 0):
    """Segment a hypothesis token-id list against reference token-id
    lists.  Returns exclusive end indices per reference segment, or None
    if the native library is unavailable."""
    import numpy as np

    lib = load_mwer()
    if lib is None:
        return None
    hyp = np.asarray(hyp_tokens, np.int32)
    offsets = np.zeros(len(ref_token_lists) + 1, np.int32)
    for i, r in enumerate(ref_token_lists):
        offsets[i + 1] = offsets[i] + len(r)
    refs = np.concatenate(
        [np.asarray(r, np.int32) for r in ref_token_lists]
    ) if offsets[-1] else np.zeros(1, np.int32)
    out = np.zeros(len(ref_token_lists), np.int32)

    def ptr(a):
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    rc = lib.mwer_segment(
        ptr(hyp), len(hyp), ptr(refs), ptr(offsets),
        len(ref_token_lists), band, ptr(out),
    )
    if rc < 0:
        return None
    return out.tolist()
