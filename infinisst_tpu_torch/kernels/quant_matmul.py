"""Int8 matmul kernels for Hopper, with their plain PyTorch versions.

Ports of the Pallas kernels in ``infinisst_tpu/kernels/quant_matmul.py``;
the CUDA sources are in ``infinisst_tpu_torch/csrc/quant_matmul.cu``:

- ``row_quant_int8`` replaces ``quantize_activation`` (:106): per-row
  symmetric int8 quantization.  Bound by bytes (M*D read, M*D written).
- ``w8a8_gemm`` replaces ``_qmm_i8_kernel`` (:94) in
  ``quantized_matmul_w8a8`` (:117): int8 x int8 -> int32, epilogue
  ``(f32(acc) * y_s) * s``.  At the main path's M it is bound by reading
  the int8 weight once (D*O bytes).  It takes the weight K-major, (O, D)
  (``models/quant.pack_w8a8`` packs it once, where leaves are made), and
  runs on the tensor cores with split-K across blocks planned by
  ``w8a8_plan``.
- ``w8_bf16_gemm`` replaces ``_qmm_kernel`` (:26) in ``quantized_matmul``
  (:34): bf16 activation times the int8 weight dequantized in registers,
  f32 accumulation, per-out-channel scale.  Bound by the weight bytes too.
- ``group_quant_int8`` replaces ``quantize_activation_grouped`` (:226):
  per-(row, group) symmetric int8 quantization.  Bound by bytes.
- ``w8a8_grouped_gemm`` replaces ``_qmm_i8_grouped_kernel`` (:191) in
  ``quantized_matmul_w8a8_grouped`` (:239): one int8 dot per input group,
  rescaled by the (row, group) and (group, out) scales and accumulated in
  f32 in group order (one fused multiply-add per group).  Bound by the int8 weight and its (G, O) scales.

``w8a8_gemm`` is the Hopper redesign; the other kernels are the simple
first version (see the note in the .cu file).

Every wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; nothing falls back.  Each launch
adds one to ``launch_counts[name]``.  ``internal_counts`` counts what a
wrapper does besides its one kernel launch: ``w8a8_gemm_split_k``, the
calls that split D across blocks (still one launch each), and
``counter_zeroing``, the fills of the split-K tile counters (one per
device and size; the kernel leaves them zero).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

launch_counts = {"row_quant_int8": 0, "w8a8_gemm": 0, "w8_bf16_gemm": 0,
                 "group_quant_int8": 0, "w8a8_grouped_gemm": 0}
internal_counts = {"w8a8_gemm_split_k": 0, "counter_zeroing": 0}


def reset_launch_counts():
    for counts in (launch_counts, internal_counts):
        for k in counts:
            counts[k] = 0


_lib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``quant_matmul`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.row_quant_int8.argtypes = [vp, ci, vp, vp, ci, ci, vp]
    lib.w8a8_gemm.argtypes = [vp] * 5 + [ci] * 7 + [vp] * 3
    lib.w8_bf16_gemm.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, vp]
    lib.group_quant_int8.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp]
    lib.w8a8_grouped_gemm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, ci,
                                      vp]
    for fn in (lib.row_quant_int8, lib.w8a8_gemm, lib.w8_bf16_gemm,
               lib.group_quant_int8, lib.w8a8_grouped_gemm,
               lib.w8a8_gemm_tile_o, lib.w8a8_gemm_tile_k):
        fn.restype = ci
    if (lib.w8a8_gemm_tile_o(), lib.w8a8_gemm_tile_k()) != (
            W8A8_TILE_O, W8A8_TILE_K):
        raise RuntimeError("w8a8_gemm: the plan's tiles differ from the "
                           "kernel's")
    return lib


def _library():
    global _lib
    if _lib is None:
        from infinisst_tpu_torch.kernels._build import load_library

        _lib = _bind(load_library("quant_matmul"))
    return _lib


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def _check(name, t, dtypes, ndim, device):
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype}, expected one of {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {ndim}-D")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _raise_on(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


_sms = {}


def sm_count(device) -> int:
    """The device's SM count, read once per device (the plans take it)."""
    n = _sms.get(device)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device] = n
    return n


_counters = {}


def zeroed_counters(owner: str, device, n: int) -> torch.Tensor:
    """At least ``n`` int32 counters on ``device``, zero between launches:
    the kernel that uses them resets each one it counts on, so the buffer
    is filled with zeros only when it is made or grown, not per call."""
    key = (owner, device)
    buf = _counters.get(key)
    if buf is None or buf.numel() < n:
        buf = torch.zeros((max(n, 1024),), dtype=torch.int32, device=device)
        _counters[key] = buf
        internal_counts["counter_zeroing"] += 1
    return buf


_FLOATS = (torch.bfloat16, torch.float32)


# ---------------------------------------------------------------------------
# row_quant_int8


def row_quant_int8_plain(y: torch.Tensor):
    """(M, D) -> (y_q int8 (M, D), y_s f32 (M, 1)); same arithmetic as
    ``quantize_activation``."""
    yf = y.to(torch.float32)
    amax = yf.abs().amax(dim=-1, keepdim=True)
    # a tensor divisor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which is not the IEEE quotient the kernel computes
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    y_q = torch.clamp(torch.round(yf / scale), -127, 127).to(torch.int8)
    return y_q, scale


def row_quant_int8(y: torch.Tensor):
    if y.device.type == "cpu":
        return row_quant_int8_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"row_quant_int8: unsupported device {y.device}")
    _check("y", y, _FLOATS, 2, y.device)
    M, D = y.shape
    y_q = torch.empty((M, D), dtype=torch.int8, device=y.device)
    y_s = torch.empty((M, 1), dtype=torch.float32, device=y.device)
    err = _library().row_quant_int8(
        y.data_ptr(), int(y.dtype == torch.bfloat16), y_q.data_ptr(),
        y_s.data_ptr(), M, D, _stream(y),
    )
    _raise_on(err, "row_quant_int8")
    launch_counts["row_quant_int8"] += 1
    return y_q, y_s


# ---------------------------------------------------------------------------
# w8a8_gemm


# Tiles of the tensor-core kernel (csrc/quant_matmul.cu, namespace tc):
# output channels per block, bytes of D per pipeline stage, and the
# activation row tiles it is compiled for (NT n8 tiles of 8 rows)
W8A8_TILE_O = 128
W8A8_TILE_K = 128
W8A8_ROW_TILES = (8, 16, 32, 64, 80)
W8A8_BLOCKS_PER_SM = 2  # split-K target: about two blocks per SM


class W8A8Plan(NamedTuple):
    rows: int  # activation rows per block (one of W8A8_ROW_TILES)
    n_mtiles: int
    n_otiles: int
    k_split: int  # bytes of D per split, a multiple of W8A8_TILE_K
    n_split: int  # ceil(D / k_split); split s takes [s*k_split, ...) of D


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def w8a8_plan(M: int, D: int, O: int, sms: int) -> W8A8Plan:
    """The grid of ``w8a8_gemm`` for an (M, D) x (D, O) product on a card
    with ``sms`` SMs (a pure function of the shapes).  One row tile holds
    all M <= 80 rows, so the weight is read once; D is split across blocks
    until there are about W8A8_BLOCKS_PER_SM blocks per SM, no finer than
    one stage per split and, so that the partial sums (rows x 4 bytes per
    channel and split) stay well below the weight bytes they save, at most
    D / (8 * rows) splits."""
    rows = next(r for r in W8A8_ROW_TILES if r >= min(M, W8A8_ROW_TILES[-1]))
    n_mtiles = _cdiv(M, rows)
    n_otiles = _cdiv(O, W8A8_TILE_O)
    n_k = _cdiv(D, W8A8_TILE_K)
    want = _cdiv(W8A8_BLOCKS_PER_SM * sms, n_otiles * n_mtiles)
    split = max(1, min(want, n_k, D // (8 * rows)))
    # whole stages per split: of rounding the stages up or down, the one
    # whose split count comes closer to the target
    per = min((_cdiv(n_k, split), max(1, n_k // split)),
              key=lambda p: (abs(_cdiv(n_k, p) - split), -p))
    k_split = per * W8A8_TILE_K
    return W8A8Plan(rows, n_mtiles, n_otiles, k_split, _cdiv(D, k_split))


def w8a8_gemm_plain(y_q, y_s, w_t, scale, out_dtype):
    """Exact int8 product against the K-major weight w_t (O, D) (float64
    holds |acc| < 2**53 exactly, on the CPU and on CUDA, where no integer
    matmul exists), then the epilogue of ``_qmm_i8_kernel``:
    ``(f32(acc) * y_s) * s`` -> out_dtype."""
    acc = (y_q.to(torch.float64) @ w_t.to(torch.float64).T).to(torch.float32)
    return (acc * y_s * scale[None, :]).to(out_dtype)


def w8a8_gemm(y_q, y_s, w_t, scale, out_dtype):
    """y_q (M, D) int8, y_s (M, 1) f32, w_t (O, D) int8 K-major, scale (O,)
    f32 -> (M, O) out_dtype."""
    if y_q.device.type == "cpu":
        return w8a8_gemm_plain(y_q, y_s, w_t, scale, out_dtype)
    if y_q.device.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {y_q.device}")
    dev = y_q.device
    _check("y_q", y_q, (torch.int8,), 2, dev)
    _check("y_s", y_s, (torch.float32,), 2, dev)
    _check("w_t", w_t, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 1, dev)
    if out_dtype not in _FLOATS:
        raise TypeError(f"w8a8_gemm: out_dtype {out_dtype}")
    M, D = y_q.shape
    O, D2 = w_t.shape
    if D2 != D or scale.shape[0] != O or y_s.shape != (M, 1):
        raise ValueError(
            f"w8a8_gemm: shapes y_q {tuple(y_q.shape)} y_s "
            f"{tuple(y_s.shape)} w_t {tuple(w_t.shape)} s {tuple(scale.shape)}"
        )
    if D % 16 or y_q.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError(f"w8a8_gemm: D={D} must be a multiple of 16 and the "
                         "int8 operands 16-byte aligned")
    out = torch.empty((M, O), dtype=out_dtype, device=dev)
    if M == 0 or O == 0:
        return out
    plan = w8a8_plan(M, D, O, sm_count(dev))
    ws = counters = None
    if plan.n_split > 1:
        n_tiles = plan.n_mtiles * plan.n_otiles
        # one int32 per (tile, split, output): the block's accumulators
        ws = torch.empty((n_tiles * plan.n_split * plan.rows, W8A8_TILE_O),
                         dtype=torch.int32, device=dev)
        counters = zeroed_counters("w8a8_gemm", dev, n_tiles)
        internal_counts["w8a8_gemm_split_k"] += 1
    err = _library().w8a8_gemm(
        y_q.data_ptr(), y_s.data_ptr(), w_t.data_ptr(), scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, D, O, plan.rows,
        plan.k_split, plan.n_split, None if ws is None else ws.data_ptr(),
        None if counters is None else counters.data_ptr(), _stream(y_q),
    )
    _raise_on(err, "w8a8_gemm")
    launch_counts["w8a8_gemm"] += 1
    return out


def quantized_matmul_w8a8_packed(y, w_t, scale, out_dtype=None):
    """W8A8 matmul on a K-major weight w_t (O, D): per-row activation
    quant + per-out-channel weight quant, int32 accumulation, rescale to
    ``out_dtype`` (default y's).  The main path's form."""
    y_q, y_s = row_quant_int8(y)
    return w8a8_gemm(y_q, y_s, w_t, scale, out_dtype or y.dtype)


def quantized_matmul_w8a8(y, w_q, scale, out_dtype=None):
    """The JAX signature, w_q (D, O): transposes the weight on every call,
    so it serves parity checks; the model packs its weights once
    (``models/quant.pack_w8a8``) and calls the packed form."""
    return quantized_matmul_w8a8_packed(
        y, w_q.transpose(0, 1).contiguous(), scale, out_dtype)


# ---------------------------------------------------------------------------
# w8_bf16_gemm


def w8_bf16_gemm_plain(y, w_q, scale):
    """bf16(y) @ float(w_q) in f32, times the per-out-channel scale, cast
    to y's dtype -- the arithmetic of ``_qmm_kernel`` (which, unlike
    ``quantized_matmul_reference``, rounds y to bf16 first)."""
    yb = y.to(torch.bfloat16).to(torch.float32)
    acc = yb @ w_q.to(torch.float32)
    return (acc * scale[None, :].to(torch.float32)).to(y.dtype)


def w8_bf16_gemm(y, w_q, scale):
    if y.device.type == "cpu":
        return w8_bf16_gemm_plain(y, w_q, scale)
    if y.device.type != "cuda":
        raise ValueError(f"w8_bf16_gemm: unsupported device {y.device}")
    dev = y.device
    _check("y", y, _FLOATS, 2, dev)
    _check("w_q", w_q, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 1, dev)
    M, D = y.shape
    D2, O = w_q.shape
    if D2 != D or scale.shape[0] != O:
        raise ValueError(
            f"w8_bf16_gemm: shapes y {tuple(y.shape)} w_q {tuple(w_q.shape)} "
            f"s {tuple(scale.shape)}"
        )
    if O % 4:
        raise ValueError(f"w8_bf16_gemm: O={O} must be a multiple of 4")
    out = torch.empty((M, O), dtype=y.dtype, device=dev)
    err = _library().w8_bf16_gemm(
        y.data_ptr(), int(y.dtype == torch.bfloat16), w_q.data_ptr(),
        scale.data_ptr(), out.data_ptr(), M, D, O, _stream(y),
    )
    _raise_on(err, "w8_bf16_gemm")
    launch_counts["w8_bf16_gemm"] += 1
    return out


# ---------------------------------------------------------------------------
# group_quant_int8


def group_quant_int8_plain(y: torch.Tensor, gs: int):
    """(M, D) -> (y_q int8 (M, D), y_s f32 (M, D // gs)); same arithmetic as
    ``quantize_activation_grouped``."""
    M, D = y.shape
    yg = y.to(torch.float32).reshape(M, D // gs, gs)
    amax = yg.abs().amax(dim=-1)
    scale = torch.clamp(amax / amax.new_full((), 127.0), min=1e-8)
    y_q = torch.clamp(torch.round(yg / scale[..., None]), -127, 127)
    return y_q.to(torch.int8).reshape(M, D), scale


def group_quant_int8(y: torch.Tensor, gs: int):
    if y.device.type == "cpu":
        return group_quant_int8_plain(y, gs)
    if y.device.type != "cuda":
        raise ValueError(f"group_quant_int8: unsupported device {y.device}")
    _check("y", y, _FLOATS, 2, y.device)
    M, D = y.shape
    if gs < 1 or D % gs:
        raise ValueError(f"group_quant_int8: D={D} is not a multiple of {gs}")
    G = D // gs
    y_q = torch.empty((M, D), dtype=torch.int8, device=y.device)
    y_s = torch.empty((M, G), dtype=torch.float32, device=y.device)
    err = _library().group_quant_int8(
        y.data_ptr(), int(y.dtype == torch.bfloat16), y_q.data_ptr(),
        y_s.data_ptr(), M, D, G, _stream(y),
    )
    _raise_on(err, "group_quant_int8")
    launch_counts["group_quant_int8"] += 1
    return y_q, y_s


# ---------------------------------------------------------------------------
# w8a8_grouped_gemm


def fma_f32(a, b, c):
    """Correctly rounded float32 ``a * b + c`` (one rounding, as a fused
    multiply-add): the product of two float32 values is exact in float64,
    the float64 sum is rounded to odd (TwoSum gives its exact error), and
    rounding that to float32 is then correct."""
    p = a.to(torch.float64) * b.to(torch.float64)
    c = c.to(torch.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    to_odd = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    inf = torch.full_like(s, float("inf"))
    s = torch.where(to_odd, torch.nextafter(s, torch.where(err > 0, inf, -inf)),
                    s)
    return s.to(torch.float32)


def w8a8_grouped_gemm_plain(y_q, y_s, w_q, scale, out_dtype):
    """The arithmetic of ``_qmm_i8_grouped_kernel``: for each group g in
    order, the exact int8 dot of the group (in float64, exact for
    |acc| < 2**53, on the CPU and on CUDA), then
    ``o = fma(f32(acc_g) * ys_g, s_g, o)`` in float32 from 0; cast last.
    XLA compiles the kernel's ``o += acc * ys * s`` into that fused
    multiply-add (interpret mode on the CPU), so the port does too."""
    M, D = y_q.shape
    G, O = scale.shape
    gs = D // G
    out = torch.zeros((M, O), dtype=torch.float32, device=y_q.device)
    for g in range(G):
        k = slice(g * gs, (g + 1) * gs)
        acc = (y_q[:, k].to(torch.float64) @ w_q[k].to(torch.float64)).to(
            torch.float32)
        out = fma_f32(acc * y_s[:, g : g + 1], scale[g][None, :], out)
    return out.to(out_dtype)


def w8a8_grouped_gemm(y_q, y_s, w_q, scale, out_dtype):
    if y_q.device.type == "cpu":
        return w8a8_grouped_gemm_plain(y_q, y_s, w_q, scale, out_dtype)
    if y_q.device.type != "cuda":
        raise ValueError(f"w8a8_grouped_gemm: unsupported device {y_q.device}")
    dev = y_q.device
    _check("y_q", y_q, (torch.int8,), 2, dev)
    _check("y_s", y_s, (torch.float32,), 2, dev)
    _check("w_q", w_q, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 2, dev)
    if out_dtype not in _FLOATS:
        raise TypeError(f"w8a8_grouped_gemm: out_dtype {out_dtype}")
    M, D = y_q.shape
    D2, O = w_q.shape
    G = scale.shape[0]
    if (D2 != D or scale.shape[1] != O or G < 1 or D % G
            or y_s.shape != (M, G)):
        raise ValueError(
            f"w8a8_grouped_gemm: shapes y_q {tuple(y_q.shape)} y_s "
            f"{tuple(y_s.shape)} w_q {tuple(w_q.shape)} s {tuple(scale.shape)}"
        )
    if (D // G) % 4 or O % 4:
        raise ValueError(f"w8a8_grouped_gemm: group size {D // G} and O={O} "
                         "must be multiples of 4")
    out = torch.empty((M, O), dtype=out_dtype, device=dev)
    err = _library().w8a8_grouped_gemm(
        y_q.data_ptr(), y_s.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, D, O, G,
        _stream(y_q),
    )
    _raise_on(err, "w8a8_grouped_gemm")
    launch_counts["w8a8_grouped_gemm"] += 1
    return out


def quantized_matmul_w8a8_grouped(y, w_q, scale, out_dtype=None):
    """Grouped W8A8 matmul: per-(row, group) activation quant, (G, O)
    weight scales (G = scale.shape[0], group size D // G), int32 dot per
    group, f32 rescale-accumulate in group order, cast to ``out_dtype``
    (default y's)."""
    y_q, y_s = group_quant_int8(y, y.shape[1] // scale.shape[0])
    return w8a8_grouped_gemm(y_q, y_s, w_q, scale, out_dtype or y.dtype)
