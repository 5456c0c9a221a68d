"""Int8 matmul kernels for Hopper, with their plain PyTorch versions.

Ports of the Pallas kernels in ``infinisst_tpu/kernels/quant_matmul.py``;
the CUDA sources are ``infinisst_tpu_torch/csrc/quant_matmul.cu`` and,
for the grouped pair, ``csrc/grouped_matmul.cu`` (built apart, in
parallel), with ``csrc/quant_common.cuh`` between them:

- ``row_quant_int8`` replaces ``quantize_activation`` (:106): per-row
  symmetric int8 quantization in one pass, the row held in registers
  and its divisions shared by several blocks (``row_quant_plan``).  M*D
  bytes read and written: at the beam step's M it is bound by the launch
  and one round trip to memory.
- ``w8a8_gemm`` replaces ``_qmm_i8_kernel`` (:94) in
  ``quantized_matmul_w8a8`` (:117): int8 x int8 -> int32, epilogue
  ``(f32(acc) * y_s) * s``.  At the main path's M it is bound by reading
  the int8 weight once (D*O bytes).
- ``w8_bf16_gemm`` replaces ``_qmm_kernel`` (:26) in ``quantized_matmul``
  (:34): bf16 activation times the int8 weight widened to bf16 in
  registers, f32 accumulation, per-out-channel scale.  Bound by the
  weight bytes too.
- ``group_quant_int8`` replaces ``quantize_activation_grouped`` (:226):
  per-(row, group) symmetric int8 quantization in one pass, each group
  held in the registers of a few lanes (``group_quant_plan``).  Bound,
  like ``row_quant_int8``, by the launch and one round trip to memory.
- ``w8a8_grouped_gemm`` replaces ``_qmm_i8_grouped_kernel`` (:191) in
  ``quantized_matmul_w8a8_grouped`` (:239): one int8 dot per input group,
  rescaled by the (row, group) and (group, out) scales and accumulated in
  f32 in group order (one fused multiply-add per group).  Bound by the
  int8 weight and its (G, O) scales.

All five are Hopper redesigns.  The three GEMMs take their weight K-major,
(O, D) (``models/quant.pack_kmajor`` packs it once, where leaves are
made), and run on the int8 or bf16 tensor cores with split-K across
blocks, planned by ``gemm_plan`` and, for the grouped GEMM, whose splits
must keep the one fused multiply-add chain over the groups,
``grouped_gemm_plan``.

Every wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; nothing falls back.  Each launch
adds one to ``launch_counts[name]``.  ``internal_counts`` counts what a
wrapper does besides its one kernel launch: ``w8a8_gemm_split_k``,
``w8_bf16_gemm_split_k`` and ``w8a8_grouped_gemm_split_k``, the calls
that split D across blocks (still one launch each), ``counter_zeroing``,
the fills of the split-K tile counters (one per kernel, device and size;
the kernels leave them zero), and
``w8_bf16_gemm_f32_cast``, the float32 activations rounded to bf16 by
PyTorch before the launch (the bf16 main path has none).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

launch_counts = {"row_quant_int8": 0, "w8a8_gemm": 0, "w8_bf16_gemm": 0,
                 "group_quant_int8": 0, "w8a8_grouped_gemm": 0}
internal_counts = {"w8a8_gemm_split_k": 0, "w8_bf16_gemm_split_k": 0,
                   "w8a8_grouped_gemm_split_k": 0, "counter_zeroing": 0,
                   "w8_bf16_gemm_f32_cast": 0}


def reset_launch_counts():
    for counts in (launch_counts, internal_counts):
        for k in counts:
            counts[k] = 0


_lib = None
_glib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``quant_matmul`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.row_quant_int8.argtypes = [vp, ci, vp, vp] + [ci] * 4 + [vp]
    lib.empty_kernel_launch.argtypes = [ci, ci, vp]
    lib.w8a8_gemm.argtypes = [vp] * 5 + [ci] * 7 + [vp] * 3
    lib.w8_bf16_gemm.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 3
    for fn in (lib.row_quant_int8, lib.empty_kernel_launch, lib.w8a8_gemm,
               lib.w8_bf16_gemm, lib.gemm_tile_o, lib.gemm_tile_k):
        fn.restype = ci
    if (lib.gemm_tile_o(), lib.gemm_tile_k()) != (GEMM_TILE_O, GEMM_TILE_K):
        raise RuntimeError("gemm_plan's tiles differ from the kernels'")
    return lib


def _bind_grouped(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``grouped_matmul`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.group_quant_int8.argtypes = [vp, ci, vp, vp] + [ci] * 7 + [vp]
    lib.w8a8_grouped_gemm.argtypes = [vp] * 5 + [ci] * 9 + [vp] * 3
    for fn in (lib.group_quant_int8, lib.w8a8_grouped_gemm):
        fn.restype = ci
    return lib


def _library():
    global _lib
    if _lib is None:
        from infinisst_tpu_torch.kernels._build import load_library

        _lib = _bind(load_library("quant_matmul"))
    return _lib


def _grouped_library():
    global _glib
    if _glib is None:
        from infinisst_tpu_torch.kernels._build import load_library

        _glib = _bind_grouped(load_library("grouped_matmul"))
    return _glib


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


def launch_empty(device, blocks: int, threads: int):
    """Launch an empty kernel (not counted): the launch floor that
    ``chip_smoke.py`` times beside the small kernels."""
    _raise_on(_library().empty_kernel_launch(
        blocks, threads, torch.cuda.current_stream(device).cuda_stream),
        "empty_kernel")


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


# threads a block aims for, the first unless the launch would then exceed
# ROW_QUANT_MAX_BLOCKS blocks (the best of the launches timed on the H100
# at M = 4, 61 and D = 4096, 14336: PERF.md, row_quant_int8)
ROW_QUANT_THREADS = (256, 512)
ROW_QUANT_MAX_BLOCKS = 256
ROW_QUANT_VPT = (1, 2, 4, 8, 16)  # vectors a thread holds, compiled for


class RowQuantPlan(NamedTuple):
    """Each of a row's ``vpt`` blocks loads the whole row, ``vpt``
    16-byte vectors a thread, and block c quantizes vector c of each
    thread."""
    vpt: int  # one of ROW_QUANT_VPT; also the blocks per row
    threads: int


@functools.lru_cache(maxsize=None)
def row_quant_plan(M: int, D: int, elem_bytes: int) -> RowQuantPlan:
    """The launch of ``row_quant_int8`` for M rows of D values of
    ``elem_bytes`` each: the fewest 16-byte vectors per thread that cover
    a row with at most the threads a block aims for, then as few whole
    warps as cover it, and one block per row for each vector a thread
    holds."""
    n_vec = _cdiv(D * elem_bytes, 16)
    for threads in ROW_QUANT_THREADS:
        vpt = next((v for v in ROW_QUANT_VPT if v * threads >= n_vec), None)
        if vpt is not None and M * vpt <= ROW_QUANT_MAX_BLOCKS:
            break
    if vpt is None:
        raise ValueError(f"row_quant_int8: D={D} is too long")
    return RowQuantPlan(vpt, 32 * _cdiv(_cdiv(n_vec, vpt), 32))


def row_quant_int8(y: torch.Tensor):
    """y (M, D) bf16 or f32 -> (y_q int8 (M, D), y_s f32 (M, 1))."""
    if y.device.type == "cpu":
        return row_quant_int8_plain(y)
    if y.device.type != "cuda":
        raise ValueError(f"row_quant_int8: unsupported device {y.device}")
    _check("y", y, _FLOATS, 2, y.device)
    M, D = y.shape
    if (D * y.element_size()) % 16 or y.data_ptr() % 16:
        raise ValueError(f"row_quant_int8: rows of D={D} {y.dtype} values "
                         "must be whole 16-byte vectors, 16-byte aligned")
    plan = row_quant_plan(M, D, y.element_size())
    y_q = torch.empty((M, D), dtype=torch.int8, device=y.device)
    y_s = torch.empty((M, 1), dtype=torch.float32, device=y.device)
    err = _library().row_quant_int8(
        y.data_ptr(), int(y.dtype == torch.bfloat16), y_q.data_ptr(),
        y_s.data_ptr(), M, D, plan.vpt, plan.threads, _stream(y),
    )
    _raise_on(err, "row_quant_int8")
    launch_counts["row_quant_int8"] += 1
    return y_q, y_s


# ---------------------------------------------------------------------------
# the tensor-core GEMMs' plan


# Tiles of the tensor-core kernels (csrc/quant_matmul.cu, namespace tc):
# output channels per block, weight bytes (values of D) per pipeline
# stage, and the activation row tiles they are compiled for (NT n8 tiles
# of 8 rows)
GEMM_TILE_O = 128
GEMM_TILE_K = 128
GEMM_ROW_TILES = (8, 16, 32, 64, 80)
GEMM_BLOCKS_PER_SM = 2  # split-K target: about two blocks per SM


class GemmPlan(NamedTuple):
    rows: int  # activation rows per block (one of GEMM_ROW_TILES)
    n_mtiles: int
    n_otiles: int
    k_split: int  # values of D per split, a multiple of GEMM_TILE_K
    n_split: int  # ceil(D / k_split); split s takes [s*k_split, ...) of D


def _cdiv(a, b):
    return -(-a // b)


@functools.lru_cache(maxsize=None)
def gemm_plan(M: int, D: int, O: int, sms: int) -> GemmPlan:
    """The grid of ``w8a8_gemm`` and ``w8_bf16_gemm`` for an (M, D) x
    (D, O) product on a card with ``sms`` SMs (a pure function of the
    shapes).  One row tile holds all M <= 80 rows, so the weight is read
    once; D is split across blocks until there are about
    GEMM_BLOCKS_PER_SM blocks per SM, no finer than one stage per split
    and, so that the partial sums (rows x 4 bytes per channel and split)
    stay well below the weight bytes they save, at most D / (8 * rows)
    splits."""
    rows = next(r for r in GEMM_ROW_TILES if r >= min(M, GEMM_ROW_TILES[-1]))
    n_mtiles = _cdiv(M, rows)
    n_otiles = _cdiv(O, GEMM_TILE_O)
    n_k = _cdiv(D, GEMM_TILE_K)
    want = _cdiv(GEMM_BLOCKS_PER_SM * sms, n_otiles * n_mtiles)
    split = max(1, min(want, n_k, D // (8 * rows)))
    # whole stages per split: of rounding the stages up or down, the one
    # whose split count comes closer to the target
    per = min((_cdiv(n_k, split), max(1, n_k // split)),
              key=lambda p: (abs(_cdiv(n_k, p) - split), -p))
    k_split = per * GEMM_TILE_K
    return GemmPlan(rows, n_mtiles, n_otiles, k_split, _cdiv(D, k_split))


def _split_k_buffers(name, plan, dtype, dev, slabs=None,
                     tile_o=GEMM_TILE_O):
    """The workspace (one (rows, tile_o) slab per tile and split, or per
    tile and each of ``slabs``) and the tile counters of a split-K
    launch; (None, None) without a split."""
    if plan.n_split == 1:
        return None, None
    n_tiles = plan.n_mtiles * plan.n_otiles
    ws = torch.empty((n_tiles * (slabs or plan.n_split) * plan.rows,
                      tile_o), dtype=dtype, device=dev)
    internal_counts[f"{name}_split_k"] += 1
    return ws, zeroed_counters(name, dev, n_tiles)


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# w8a8_gemm


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
    plan = gemm_plan(M, D, O, sm_count(dev))
    ws, counters = _split_k_buffers("w8a8_gemm", plan, torch.int32, dev)
    err = _library().w8a8_gemm(
        y_q.data_ptr(), y_s.data_ptr(), w_t.data_ptr(), scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, D, O, plan.rows,
        plan.k_split, plan.n_split, _ptr(ws), _ptr(counters), _stream(y_q),
    )
    _raise_on(err, "w8a8_gemm")
    launch_counts["w8a8_gemm"] += 1
    return out


def quantized_matmul_w8a8(y, w_q, scale, out_dtype=None):
    """The JAX signature, w_q (D, O): per-row activation quant +
    per-out-channel weight quant, int32 accumulation, rescale to
    ``out_dtype`` (default y's).  Transposes the weight on every call, so
    it serves parity checks; the model packs its weights once
    (``models/quant.pack_kmajor``) and calls the kernels on them."""
    y_q, y_s = row_quant_int8(y)
    return w8a8_gemm(y_q, y_s, w_q.transpose(0, 1).contiguous(), scale,
                     out_dtype or y.dtype)


# ---------------------------------------------------------------------------
# w8_bf16_gemm


def w8_bf16_gemm_plain(y, w_t, scale):
    """bf16(y) @ float(w_t).T in f32, times the per-out-channel scale, cast
    to y's dtype -- the arithmetic of ``_qmm_kernel`` (which, unlike
    ``quantized_matmul_reference``, rounds y to bf16 first), on the
    K-major weight w_t (O, D)."""
    yb = y.to(torch.bfloat16).to(torch.float32)
    acc = yb @ w_t.to(torch.float32).T
    return (acc * scale[None, :].to(torch.float32)).to(y.dtype)


def w8_bf16_gemm(y, w_t, scale):
    """y (M, D) bf16 or f32, w_t (O, D) int8 K-major, scale (O,) f32 ->
    (M, O) in y's dtype.  A float32 y is rounded to bf16 by PyTorch before
    the launch (what the kernel would do first; the bf16 main path skips
    it)."""
    if y.device.type == "cpu":
        return w8_bf16_gemm_plain(y, w_t, scale)
    if y.device.type != "cuda":
        raise ValueError(f"w8_bf16_gemm: unsupported device {y.device}")
    dev = y.device
    _check("y", y, _FLOATS, 2, dev)
    _check("w_t", w_t, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 1, dev)
    M, D = y.shape
    O, D2 = w_t.shape
    if D2 != D or scale.shape[0] != O:
        raise ValueError(
            f"w8_bf16_gemm: shapes y {tuple(y.shape)} w_t {tuple(w_t.shape)} "
            f"s {tuple(scale.shape)}"
        )
    yb = y
    if y.dtype != torch.bfloat16:
        yb = y.to(torch.bfloat16)
        internal_counts["w8_bf16_gemm_f32_cast"] += 1
    if D % 16 or yb.data_ptr() % 16 or w_t.data_ptr() % 16:
        raise ValueError(f"w8_bf16_gemm: D={D} must be a multiple of 16 and "
                         "the operands 16-byte aligned")
    out = torch.empty((M, O), dtype=y.dtype, device=dev)
    if M == 0 or O == 0:
        return out
    plan = gemm_plan(M, D, O, sm_count(dev))
    ws, counters = _split_k_buffers("w8_bf16_gemm", plan, torch.float32, dev)
    err = _library().w8_bf16_gemm(
        yb.data_ptr(), w_t.data_ptr(), scale.data_ptr(), out.data_ptr(),
        int(y.dtype == torch.bfloat16), M, D, O, plan.rows, plan.k_split,
        plan.n_split, _ptr(ws), _ptr(counters), _stream(y),
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


# threads a block (whole warps; each group takes ``lanes`` of them) and
# the vectors a lane may hold, compiled for
GROUP_QUANT_THREADS = 128
GROUP_QUANT_VPL = (1, 2, 4, 8)


class GroupQuantPlan(NamedTuple):
    """Group i of the M * G is held by lanes [i * lanes, (i + 1) * lanes)
    of the launch, lane l taking the group's 16-byte vectors l, l + lanes,
    ..."""
    lanes: int  # a power of two <= 32 that divides the group's vectors
    vpl: int  # one of GROUP_QUANT_VPL, at least the vectors a lane holds
    threads: int
    blocks: int


@functools.lru_cache(maxsize=None)
def group_quant_plan(M: int, D: int, G: int, elem_bytes: int
                     ) -> GroupQuantPlan:
    """The launch of ``group_quant_int8`` for M rows of G groups of D / G
    values of ``elem_bytes`` each: as many lanes a group as divide its
    16-byte vectors, up to a warp (a 128-value bf16 group: 16 lanes, one
    vector each), and GROUP_QUANT_THREADS threads a block."""
    n_vec = (D // G) * elem_bytes // 16
    lanes = min(32, n_vec & -n_vec)
    vpl = next((v for v in GROUP_QUANT_VPL if v * lanes >= n_vec), None)
    if vpl is None:
        raise ValueError(f"group_quant_int8: groups of {D // G} are too long")
    threads = GROUP_QUANT_THREADS
    return GroupQuantPlan(lanes, vpl, threads,
                          _cdiv(M * G * lanes, threads))


def group_quant_int8(y: torch.Tensor, gs: int):
    """y (M, D) bf16 or f32 -> (y_q int8 (M, D), y_s f32 (M, D // gs))."""
    if y.device.type == "cpu":
        return group_quant_int8_plain(y, gs)
    if y.device.type != "cuda":
        raise ValueError(f"group_quant_int8: unsupported device {y.device}")
    _check("y", y, _FLOATS, 2, y.device)
    M, D = y.shape
    if gs < 1 or D % gs:
        raise ValueError(f"group_quant_int8: D={D} is not a multiple of {gs}")
    if (gs * y.element_size()) % 16 or y.data_ptr() % 16:
        raise ValueError(f"group_quant_int8: groups of {gs} {y.dtype} values "
                         "must be whole 16-byte vectors, 16-byte aligned")
    G = D // gs
    y_q = torch.empty((M, D), dtype=torch.int8, device=y.device)
    y_s = torch.empty((M, G), dtype=torch.float32, device=y.device)
    if M == 0:
        return y_q, y_s
    plan = group_quant_plan(M, D, G, y.element_size())
    err = _grouped_library().group_quant_int8(
        y.data_ptr(), int(y.dtype == torch.bfloat16), y_q.data_ptr(),
        y_s.data_ptr(), M, D, G, plan.lanes, plan.vpl, plan.threads,
        plan.blocks, _stream(y),
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


def w8a8_grouped_gemm_plain(y_q, y_s, w_t, scale, out_dtype):
    """The arithmetic of ``_qmm_i8_grouped_kernel`` on the K-major weight
    w_t (O, D): for each group g in order, the exact int8 dot of the group
    (in float64, exact for |acc| < 2**53, on the CPU and on CUDA), then
    ``o = fma(f32(acc_g) * ys_g, s_g, o)`` in float32 from 0; cast last.
    XLA compiles the kernel's ``o += acc * ys * s`` into that fused
    multiply-add (interpret mode on the CPU), so the port does too."""
    M, D = y_q.shape
    G, O = scale.shape
    gs = D // G
    out = torch.zeros((M, O), dtype=torch.float32, device=y_q.device)
    for g in range(G):
        k = slice(g * gs, (g + 1) * gs)
        acc = (y_q[:, k].to(torch.float64) @ w_t[:, k].to(torch.float64).T
               ).to(torch.float32)
        out = fma_f32(acc * y_s[:, g : g + 1], scale[g][None, :], out)
    return out.to(out_dtype)


# output channels a block (csrc/grouped_matmul.cu: four warps of one or
# two m16 tiles): the narrow tile, but for weights wide enough that the wide
# one alone gives GROUPED_WIDE_WAVES blocks per SM (the lm_head shape)
GROUPED_TILE_OS = (64, 128)
GROUPED_WIDE_WAVES = 4
# split-K's workspace (one f32 product per valid row, group and channel)
# at most the weight bytes over this
GROUPED_WS_CAP = 8
# without a split, a grid of less than half a wave takes narrower row
# tiles (the weight then crosses L2, not device memory, once more per row
# tile), down to GROUPED_MIN_ROWS rows
GROUPED_MIN_ROWS = 16


class GroupedGemmPlan(NamedTuple):
    rows: int  # activation rows per block (one of GEMM_ROW_TILES)
    tile_o: int  # output channels per block (one of GROUPED_TILE_OS)
    n_mtiles: int
    n_otiles: int
    k_split: int  # values of D per split: whole groups
    n_split: int  # ceil(D / k_split)


@functools.lru_cache(maxsize=None)
def grouped_gemm_plan(M: int, D: int, O: int, G: int, sms: int
                      ) -> GroupedGemmPlan:
    """The grid of ``w8a8_grouped_gemm`` for an (M, D) x (D, O) product in
    G groups on a card with ``sms`` SMs (a pure function of the shapes;
    the rules and constants are the best of the launches timed on the H100
    at the main path's shapes, PERF.md).  One row tile holds all M <= 80
    rows, so the weight is read once.  A grid short of one wave (a block
    per SM) splits D, in whole groups, toward GEMM_BLOCKS_PER_SM blocks
    per SM as ``gemm_plan`` does, but only where the products the splits
    hand to the last block of each tile (M x G x O f32) stay within
    1 / GROUPED_WS_CAP of the weight bytes (at gs = 128: M <= 4); without
    a split, a grid short of half a wave takes narrower row tiles."""
    gs = D // G
    rows = next(r for r in GEMM_ROW_TILES if r >= min(M, GEMM_ROW_TILES[-1]))
    tile_o, wide = GROUPED_TILE_OS
    if _cdiv(O, wide) * _cdiv(M, rows) >= GROUPED_WIDE_WAVES * sms:
        tile_o = wide
    n_otiles = _cdiv(O, tile_o)
    tiles = n_otiles * _cdiv(M, rows)
    per = G
    if tiles < sms and GROUPED_WS_CAP * 4 * M * G <= D:
        split = max(1, min(_cdiv(GEMM_BLOCKS_PER_SM * sms, tiles), G))
        per = min((_cdiv(G, split), max(1, G // split)),
                  key=lambda p: (abs(_cdiv(G, p) - split), -p))
    if per == G:
        while 2 * n_otiles * _cdiv(M, rows) < sms and rows > GROUPED_MIN_ROWS:
            rows = GEMM_ROW_TILES[GEMM_ROW_TILES.index(rows) - 1]
    return GroupedGemmPlan(rows, tile_o, _cdiv(M, rows), n_otiles, per * gs,
                           _cdiv(G, per))


def grouped_gemm_refusal(D: int, G: int, O: int):
    """Why ``w8a8_grouped_gemm`` refuses a (D, O) weight in G groups (its
    MMA takes whole runs of 32 int8 values a group), or None."""
    if (D // G) % 32 or O % 4:
        return (f"w8a8_grouped_gemm: group size {D // G} must be a "
                f"multiple of 32 and O={O} of 4")
    return None


def w8a8_grouped_gemm(y_q, y_s, w_t, scale, out_dtype):
    """y_q (M, D) int8, y_s (M, G) f32, w_t (O, D) int8 K-major, scale
    (G, O) f32 -> (M, O) out_dtype."""
    if y_q.device.type == "cpu":
        return w8a8_grouped_gemm_plain(y_q, y_s, w_t, scale, out_dtype)
    if y_q.device.type != "cuda":
        raise ValueError(f"w8a8_grouped_gemm: unsupported device {y_q.device}")
    dev = y_q.device
    _check("y_q", y_q, (torch.int8,), 2, dev)
    _check("y_s", y_s, (torch.float32,), 2, dev)
    _check("w_t", w_t, (torch.int8,), 2, dev)
    _check("scale", scale, (torch.float32,), 2, dev)
    if out_dtype not in _FLOATS:
        raise TypeError(f"w8a8_grouped_gemm: out_dtype {out_dtype}")
    M, D = y_q.shape
    O, D2 = w_t.shape
    G = scale.shape[0]
    if (D2 != D or scale.shape[1] != O or G < 1 or D % G
            or y_s.shape != (M, G)):
        raise ValueError(
            f"w8a8_grouped_gemm: shapes y_q {tuple(y_q.shape)} y_s "
            f"{tuple(y_s.shape)} w_t {tuple(w_t.shape)} s {tuple(scale.shape)}"
        )
    why = grouped_gemm_refusal(D, G, O)
    if why:
        raise ValueError(why)
    if y_q.data_ptr() % 16 or w_t.data_ptr() % 16 or scale.data_ptr() % 16:
        raise ValueError("w8a8_grouped_gemm: y_q, w_t and scale must be "
                         "16-byte aligned")
    out = torch.empty((M, O), dtype=out_dtype, device=dev)
    if M == 0 or O == 0:
        return out
    plan = grouped_gemm_plan(M, D, O, G, sm_count(dev))
    # one slab of products per group
    ws, counters = _split_k_buffers("w8a8_grouped_gemm", plan, torch.float32,
                                    dev, slabs=G, tile_o=plan.tile_o)
    err = _grouped_library().w8a8_grouped_gemm(
        y_q.data_ptr(), y_s.data_ptr(), w_t.data_ptr(), scale.data_ptr(),
        out.data_ptr(), int(out_dtype == torch.bfloat16), M, D, O, G,
        plan.rows, plan.tile_o, plan.k_split, plan.n_split, _ptr(ws),
        _ptr(counters), _stream(y_q),
    )
    _raise_on(err, "w8a8_grouped_gemm")
    launch_counts["w8a8_grouped_gemm"] += 1
    return out
