"""Int8 matmul kernels for Hopper, with their plain PyTorch versions.

Ports of the Pallas kernels in ``infinisst_tpu/kernels/quant_matmul.py``;
the CUDA sources are in ``infinisst_tpu_torch/csrc/quant_matmul.cu``:

- ``row_quant_int8`` replaces ``quantize_activation`` (:106): per-row
  symmetric int8 quantization.  Bound by bytes (M*D read, M*D written).
- ``w8a8_gemm`` replaces ``_qmm_i8_kernel`` (:94) in
  ``quantized_matmul_w8a8`` (:117): int8 x int8 -> int32, epilogue
  ``(f32(acc) * y_s) * s``.  At the main path's M it is bound by reading
  the int8 weight once (D*O bytes).
- ``w8_bf16_gemm`` replaces ``_qmm_kernel`` (:26) in ``quantized_matmul``
  (:34): bf16 activation times the int8 weight dequantized in registers,
  f32 accumulation, per-out-channel scale.  Bound by the weight bytes too.
- ``group_quant_int8`` replaces ``quantize_activation_grouped`` (:226):
  per-(row, group) symmetric int8 quantization.  Bound by bytes.
- ``w8a8_grouped_gemm`` replaces ``_qmm_i8_grouped_kernel`` (:191) in
  ``quantized_matmul_w8a8_grouped`` (:239): one int8 dot per input group,
  rescaled by the (row, group) and (group, out) scales and accumulated in
  f32 in group order (one fused multiply-add per group).  Bound by the int8 weight and its (G, O) scales.

The kernels are the simple first version (see the note in the .cu file).

Every wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; nothing falls back.  Each launch
adds one to ``launch_counts[name]``.
"""

from __future__ import annotations

import ctypes

import torch

launch_counts = {"row_quant_int8": 0, "w8a8_gemm": 0, "w8_bf16_gemm": 0,
                 "group_quant_int8": 0, "w8a8_grouped_gemm": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


_lib = None


def _library():
    global _lib
    if _lib is None:
        from infinisst_tpu_torch.kernels._build import load_library

        lib = load_library("quant_matmul")
        vp, ci = ctypes.c_void_p, ctypes.c_int
        lib.row_quant_int8.argtypes = [vp, ci, vp, vp, ci, ci, vp]
        lib.w8a8_gemm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci, vp]
        lib.w8_bf16_gemm.argtypes = [vp, ci, vp, vp, vp, ci, ci, ci, vp]
        lib.group_quant_int8.argtypes = [vp, ci, vp, vp, ci, ci, ci, vp]
        lib.w8a8_grouped_gemm.argtypes = [vp, vp, vp, vp, vp, ci, ci, ci, ci,
                                          ci, vp]
        for fn in (lib.row_quant_int8, lib.w8a8_gemm, lib.w8_bf16_gemm,
                   lib.group_quant_int8, lib.w8a8_grouped_gemm):
            fn.restype = ci
        _lib = lib
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


def w8a8_gemm_plain(y_q, y_s, w_q, scale, out_dtype):
    """Exact int8 product (float64 holds |acc| < 2**53 exactly, on the CPU
    and on CUDA, where no integer matmul exists), then the epilogue of
    ``_qmm_i8_kernel``: ``(f32(acc) * y_s) * s`` -> out_dtype."""
    acc = (y_q.to(torch.float64) @ w_q.to(torch.float64)).to(torch.float32)
    return (acc * y_s * scale[None, :]).to(out_dtype)


def w8a8_gemm(y_q, y_s, w_q, scale, out_dtype):
    if y_q.device.type == "cpu":
        return w8a8_gemm_plain(y_q, y_s, w_q, scale, out_dtype)
    if y_q.device.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {y_q.device}")
    dev = y_q.device
    _check("y_q", y_q, (torch.int8,), 2, dev)
    _check("y_s", y_s, (torch.float32,), 2, dev)
    _check("w_q", w_q, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 1, dev)
    if out_dtype not in _FLOATS:
        raise TypeError(f"w8a8_gemm: out_dtype {out_dtype}")
    M, D = y_q.shape
    D2, O = w_q.shape
    if D2 != D or scale.shape[0] != O or y_s.shape != (M, 1):
        raise ValueError(
            f"w8a8_gemm: shapes y_q {tuple(y_q.shape)} y_s "
            f"{tuple(y_s.shape)} w_q {tuple(w_q.shape)} s {tuple(scale.shape)}"
        )
    if D % 4 or O % 4:
        raise ValueError(f"w8a8_gemm: D={D} and O={O} must be multiples of 4")
    out = torch.empty((M, O), dtype=out_dtype, device=dev)
    err = _library().w8a8_gemm(
        y_q.data_ptr(), y_s.data_ptr(), w_q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, D, O,
        _stream(y_q),
    )
    _raise_on(err, "w8a8_gemm")
    launch_counts["w8a8_gemm"] += 1
    return out


def quantized_matmul_w8a8(y, w_q, scale, out_dtype=None):
    """W8A8 matmul: per-row activation quant + per-out-channel weight
    quant, int32 accumulation, rescale to ``out_dtype`` (default y's)."""
    y_q, y_s = row_quant_int8(y)
    return w8a8_gemm(y_q, y_s, w_q, scale, out_dtype or y.dtype)


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
