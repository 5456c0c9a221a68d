"""Int8 matmul kernels for Hopper, with their plain PyTorch versions.

Ports of the Pallas kernels in ``infinisst_tpu/kernels/quant_matmul.py``;
the CUDA sources are ``infinisst_tpu_torch/csrc/quant_matmul.cu``,
for the grouped pair ``csrc/grouped_matmul.cu`` and for the fused
quantizers ``csrc/norm_quant.cu`` (built apart, in parallel), with
``csrc/quant_common.cuh`` between them:

- ``row_quant_int8`` replaces ``quantize_activation`` (:106): per-row
  symmetric int8 quantization in one pass, the row held in registers
  and its divisions shared by several blocks (``row_quant_plan``).  M*D
  bytes read and written: at the beam step's M it is bound by the launch
  and one round trip to memory.
- ``w8a8_gemm`` replaces ``_qmm_i8_kernel`` (:94) in
  ``quantized_matmul_w8a8`` (:117): int8 x int8 -> int32, epilogue
  ``(f32(acc) * y_s) * s``; ``w8a8_gemm_many`` runs up to three weights
  that share their activation (q|k|v, gate|up) in one launch.  Below
  about 300 rows it is bound by reading the int8 weight once (D*O
  bytes), above by the int8 tensor cores.
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
  f32 in group order (one fused multiply-add per group);
  ``w8a8_grouped_gemm_many`` runs up to three weights that share their
  activation in one launch.  Bound by the int8 weight and its (G, O)
  scales.

- ``rms_norm_quant_int8`` and ``silu_mul_quant_int8``
  (``csrc/norm_quant.cu``): the quantizer as the last step of the
  kernel that makes its input, ``llama._rms_norm`` (:47 of the JAX
  model) after the residual add, or ``jax.nn.silu(gate) * up``, then
  ``quantize_activation`` or ``quantize_activation_grouped``; the row
  is held in registers, a long one over a thread-block cluster that
  exchanges its partials through distributed shared memory.  The sum
  of squares runs in an order fixed by D (``norm_lanes``), which the
  plain version computes with elementwise adds
  (``sum_squares_plain``), so both are bitwise their plain versions
  at any M.  Bound by the launch and one round trip to memory.

The grouped pair takes every group size that divides D, as JAX's grouped
path does: groups that the vector and wgmma routes cannot hold (not
whole 16-byte vectors, not a multiple of ``GROUPED_MMA_GROUP``, or O not
a multiple of 4; ``grouped_on_wgmma``) take a simple route in the same
source, bitwise the same arithmetic.

All seven are Hopper redesigns.  The three GEMMs take their weight K-major,
(O, D) (``models/quant.pack_kmajor`` packs it once, where leaves are
made).  ``w8a8_gemm`` and the grouped GEMM run on ``wgmma`` with a TMA
ring on mbarriers and persistent blocks that share the (tile, stage)
iterations evenly (``w8a8_plan``; ``grouped_plan``, whose splits keep the
one fused multiply-add chain over the groups in g order);
``w8_bf16_gemm`` runs on ``mma.sync`` with split-K across blocks, planned
by ``gemm_plan``.

Every wrapper takes its plain version for a tensor on the CPU and launches
its kernel for a CUDA tensor, or raises; nothing falls back.  Each launch
adds one to ``launch_counts[name]``.  ``internal_counts`` counts what a
wrapper does besides its one kernel launch: ``w8a8_gemm_split_k``, the
launches whose plan splits a tile across blocks, ``w8_bf16_gemm_split_k``,
the calls that split D across blocks, and ``w8a8_grouped_gemm_split_k``,
the launches whose contributors park products for a split tile's owner
(still one launch each), ``group_quant_int8_simple`` and
``w8a8_grouped_gemm_simple``, the calls that took the grouped pair's
simple route (still one launch each), ``counter_zeroing``, the fills of
the tile counters (one per kernel, device and size; the kernels leave
them zero), and
``w8_bf16_gemm_f32_cast``, the float32 activations rounded to bf16 by
PyTorch before the launch (the bf16 main path has none).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from infinisst_tpu_torch.core.graphs import counter

# registered with ``core.graphs``: a captured program's replays add to
# them what its capture recorded
launch_counts = counter({"row_quant_int8": 0, "w8a8_gemm": 0,
                         "w8_bf16_gemm": 0, "group_quant_int8": 0,
                         "w8a8_grouped_gemm": 0, "rms_norm_quant_int8": 0,
                         "silu_mul_quant_int8": 0})
internal_counts = counter({"w8a8_gemm_split_k": 0, "w8_bf16_gemm_split_k": 0,
                           "w8a8_grouped_gemm_split_k": 0,
                           "group_quant_int8_simple": 0,
                           "w8a8_grouped_gemm_simple": 0,
                           "counter_zeroing": 0,
                           "w8_bf16_gemm_f32_cast": 0})


def reset_launch_counts():
    for counts in (launch_counts, internal_counts):
        for k in counts:
            counts[k] = 0


_lib = None
_glib = None
_nlib = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``quant_matmul`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.row_quant_int8.argtypes = [vp, ci, vp, vp] + [ci] * 4 + [vp]
    lib.empty_kernel_launch.argtypes = [ci, ci, vp]
    lib.w8a8_gemm.argtypes = ([vp, vp, ci, ci, ci] + [vp] * 9 + [ci] * 8
                              + [vp] * 3)
    lib.w8_bf16_gemm.argtypes = [vp] * 4 + [ci] * 7 + [vp] * 3
    lib.w8a8_gemm_smem.argtypes = [ci, ci]
    for fn in (lib.row_quant_int8, lib.empty_kernel_launch, lib.w8a8_gemm,
               lib.w8_bf16_gemm, lib.gemm_tile_o, lib.gemm_tile_k,
               lib.w8a8_gemm_smem):
        fn.restype = ci
    if (lib.gemm_tile_o(), lib.gemm_tile_k()) != (GEMM_TILE_O, GEMM_TILE_K):
        raise RuntimeError("gemm_plan's tiles differ from the kernels'")
    if any(lib.w8a8_gemm_smem(r, st) != w8a8_smem(r, st)
           for r in (W8A8_ROWS[0], W8A8_ROWS[-1]) for st in (2, 5)):
        raise RuntimeError("w8a8_plan's ring differs from the kernel's")
    return lib


def _bind_grouped(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``grouped_matmul`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.group_quant_int8.argtypes = [vp, ci, vp, vp] + [ci] * 7 + [vp]
    lib.w8a8_grouped_gemm.argtypes = ([vp, vp] + [ci] * 4 + [vp] * 9
                                      + [ci] * 11 + [vp] * 3)
    lib.w8a8_grouped_gemm_smem.argtypes = [ci] * 4
    lib.group_quant_int8_simple.argtypes = [vp, ci, vp, vp] + [ci] * 3 + [vp]
    lib.w8a8_grouped_gemm_simple.argtypes = [vp] * 5 + [ci] * 5 + [vp]
    for fn in (lib.group_quant_int8, lib.w8a8_grouped_gemm,
               lib.w8a8_grouped_gemm_smem, lib.group_quant_int8_simple,
               lib.w8a8_grouped_gemm_simple):
        fn.restype = ci
    if any(lib.w8a8_grouped_gemm_smem(r, G, e, st) != grouped_smem(r, G, e, st)
           for r in (GROUPED_ROWS[0], GROUPED_ROWS[-1]) for G, e in
           ((32, 1), (448, 4)) for st in (2, 5)):
        raise RuntimeError("grouped_plan's ring differs from the kernel's")
    return lib


def _bind_norm(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of a built ``norm_quant`` library."""
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.rms_norm_quant_int8.argtypes = ([vp] * 6 + [ci] * 4
                                        + [ctypes.c_float] + [ci] * 4 + [vp])
    lib.silu_mul_quant_int8.argtypes = [vp] * 4 + [ci] * 7 + [vp]
    lib.empty_cluster_launch.argtypes = [ci] * 3 + [vp]
    for fn in (lib.rms_norm_quant_int8, lib.silu_mul_quant_int8,
               lib.empty_cluster_launch):
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


def _norm_library():
    global _nlib
    if _nlib is None:
        from infinisst_tpu_torch.kernels._build import load_library

        _nlib = _bind_norm(load_library("norm_quant"))
    return _nlib


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
# rms_norm_quant_int8 and silu_mul_quant_int8 (csrc/norm_quant.cu): the
# quantizer as the last step of the kernel that makes its input


NQ_CHUNK = 8  # values a lane's chunk (16 bytes of bf16, 32 of float32)
NQ_MAX_LANES = 2048  # lanes a row: 64 warps over at most 8 blocks
NQ_JS = (1, 2, 4)  # chunks a lane holds, compiled for
NQ_CLUSTERS = (1, 2, 4, 8)  # blocks a row (a thread-block cluster)


@functools.lru_cache(maxsize=None)
def norm_lanes(D: int):
    """(J, lanes) of a row of D values: lane t holds chunks t, t + lanes,
    ... (J of them).  A function of D only: it fixes the order of the
    sum of squares, so a row's bits do not depend on M or on the launch.
    Up to 8 warps a row, as many as cover it; above that a multiple of 8
    warps (so that 2, 4 or 8 blocks can share them), with the fewest J
    that keeps the lanes within NQ_MAX_LANES."""
    n_c = _cdiv(D, NQ_CHUNK)
    for J in NQ_JS:
        w = _cdiv(n_c, 32 * J)
        if w > 8:
            w = 8 * _cdiv(w, 8)
        if 32 * w <= NQ_MAX_LANES:
            return J, 32 * w
    raise ValueError(f"norm_quant: rows of {D} values are too long")


def fused_quant_ok(D: int, gs: int) -> bool:
    """Whether the fused kernels take rows of D values quantized in groups
    of gs (gs == D: one scale a row): whole chunks of 8 values, rows the
    kernels can hold, and a group a power of two of chunks within a warp.
    A layout they refuse keeps the separate norm or product and
    quantizer."""
    if D < NQ_CHUNK or D % NQ_CHUNK or gs < 1 or D % gs:
        return False
    if D > NQ_MAX_LANES * NQ_JS[-1] * NQ_CHUNK:
        return False
    if gs == D:
        return True
    lanes = gs // NQ_CHUNK
    return gs % NQ_CHUNK == 0 and lanes <= 32 and lanes & (lanes - 1) == 0


class NormQuantPlan(NamedTuple):
    """Lane t of a row holds chunks t, t + lanes, ... (J of them); the
    row's lanes are cut into ``blocks`` blocks of one cluster."""
    J: int
    lanes: int
    blocks: int  # one of NQ_CLUSTERS, dividing the row's warps

    @property
    def threads(self) -> int:
        return self.lanes // self.blocks


@functools.lru_cache(maxsize=None)
def norm_quant_plan(D: int) -> NormQuantPlan:
    """The launch of the fused kernels for rows of D values: a row of up
    to 512 lanes (``norm_lanes``) in one block, a longer one over the
    fewest blocks of at most 256 threads that divide its warps (the best
    of the plans timed on the H100 at the path shapes, PERF.md)."""
    J, lanes = norm_lanes(D)
    return _plan_for_test(D, next(
        K for K in NQ_CLUSTERS
        if (lanes // 32) % K == 0 and lanes // K <= (
            512 if lanes <= 512 else 256)))


def _plan_for_test(D: int, blocks: int) -> NormQuantPlan:
    """The fused kernels' launch for rows of D values over ``blocks``
    blocks a row: the hook with which a test holds another plan's bits to
    the plain version's (the kernels' results do not depend on it)."""
    J, lanes = norm_lanes(D)
    if (blocks not in NQ_CLUSTERS or (lanes // 32) % blocks
            or lanes // blocks > 1024):
        raise ValueError(f"norm_quant: {lanes} lanes do not split over "
                         f"{blocks} blocks")
    return NormQuantPlan(J, lanes, blocks)


def sum_squares_plain(x: torch.Tensor) -> torch.Tensor:
    """The sum of squares of each row of the float32 (M, D) x, as the
    fused kernel adds them (csrc/norm_quant.cu): each lane's squares in
    chunk order, then value order, from 0; each warp's 32 lanes by an xor
    butterfly over lane bits 16, 8, 4, 2, 1; the warps' sums in order.
    Every add is an elementwise tensor add, so the CPU and the card give
    the same bits.  Returns (M, 1)."""
    M, D = x.shape
    J, lanes = norm_lanes(D)
    sq = x * x
    sq = torch.nn.functional.pad(sq, (0, J * lanes * NQ_CHUNK - D))
    sq = sq.reshape(M, J, lanes, NQ_CHUNK)
    acc = torch.zeros((M, lanes), dtype=torch.float32, device=x.device)
    for j in range(J):
        for e in range(NQ_CHUNK):
            acc = acc + sq[:, j, :, e]
    acc = acc.reshape(M, lanes // 32, 32)
    lane = torch.arange(32, device=x.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc[..., lane ^ off]
    tot = acc[:, 0, 0]
    for w in range(1, lanes // 32):
        tot = tot + acc[:, w, 0]
    return tot[:, None]


def _quantize_plain(y: torch.Tensor, gs: int):
    return (row_quant_int8_plain(y) if gs == y.shape[-1]
            else group_quant_int8_plain(y, gs))


def rms_norm_quant_int8_plain(h, delta, scale, eps: float, gs: int):
    """h' = h + delta (in h's dtype; h itself without delta), then
    ``y = dtype(f32(h') * rsqrt(mean(f32(h')**2) + eps) * f32(scale))``
    with the sum of squares in the kernel's order (``sum_squares_plain``)
    and an IEEE division by D, then ``row_quant_int8_plain`` (gs == D) or
    ``group_quant_int8_plain`` on y.  Returns (h', y_q, y_s)."""
    if delta is not None:
        h = h + delta
    x = h.to(torch.float32)
    ss = sum_squares_plain(x)
    # a tensor divisor: the IEEE quotient, as the kernel divides
    var = ss / ss.new_full((), float(h.shape[-1]))
    y = (x * torch.rsqrt(var + eps) * scale.to(torch.float32)).to(h.dtype)
    return (h,) + _quantize_plain(y, gs)


def _check_rows(name, t, shape, dtype, device):
    _check(name, t, (dtype,), 2, device)
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: must be 16-byte aligned")


def _fused_outputs(name, M, D, gs, dev):
    if not fused_quant_ok(D, gs):
        raise ValueError(f"{name}: rows of D={D} in groups of {gs} are not "
                         "a layout the kernel takes (fused_quant_ok)")
    y_q = torch.empty((M, D), dtype=torch.int8, device=dev)
    y_s = torch.empty((M, 1 if gs == D else D // gs), dtype=torch.float32,
                      device=dev)
    return y_q, y_s


def rms_norm_quant_int8(h, delta, scale, eps: float, gs: int, *,
                        _plan: NormQuantPlan = None):
    """h (M, D) bf16 or f32, delta (M, D) of h's dtype or None, scale
    (D,) bf16 or f32 -> (h', y_q int8 (M, D), y_s f32 (M, 1) or (M, D //
    gs)): the residual add, RMSNorm and the quantizer in one launch; y
    itself is never written.  h' is h without delta.  ``_plan`` (a test's,
    from ``_plan_for_test``; default ``norm_quant_plan(D)``) sets only the
    blocks a row."""
    if h.device.type == "cpu":
        return rms_norm_quant_int8_plain(h, delta, scale, eps, gs)
    if h.device.type != "cuda":
        raise ValueError(f"rms_norm_quant_int8: unsupported device "
                         f"{h.device}")
    dev = h.device
    _check("h", h, _FLOATS, 2, dev)
    M, D = h.shape
    _check_rows("h", h, (M, D), h.dtype, dev)
    if delta is not None:
        _check_rows("delta", delta, (M, D), h.dtype, dev)
    _check("scale", scale, _FLOATS, 1, dev)
    if scale.shape[0] != D or scale.data_ptr() % 16:
        raise ValueError(f"rms_norm_quant_int8: scale {tuple(scale.shape)} "
                         f"for D={D}, 16-byte aligned")
    y_q, y_s = _fused_outputs("rms_norm_quant_int8", M, D, gs, dev)
    h_out = h if delta is None else torch.empty_like(h)
    if M == 0:
        return h_out, y_q, y_s
    plan = _plan or norm_quant_plan(D)
    err = _norm_library().rms_norm_quant_int8(
        h.data_ptr(), _ptr(delta), scale.data_ptr(),
        None if delta is None else h_out.data_ptr(), y_q.data_ptr(),
        y_s.data_ptr(), int(h.dtype == torch.bfloat16),
        int(scale.dtype == torch.bfloat16), M, D, eps, gs, plan.lanes,
        plan.J, plan.blocks, _stream(h))
    _raise_on(err, "rms_norm_quant_int8")
    launch_counts["rms_norm_quant_int8"] += 1
    return h_out, y_q, y_s


def _rounded(x: torch.Tensor, dt) -> torch.Tensor:
    """float32 x rounded to dt and back: one elementwise step of XLA's
    bf16 arithmetic."""
    return x.to(dt).to(torch.float32)


class _Silu(torch.autograd.Function):
    """``jax.nn.silu`` on bf16 (or f16) rows as XLA computes it, ``x *
    (1 / (1 + exp(-x)))`` with every step rounded to x's dtype, and the
    gradient ``jax.grad`` takes of it: the product rule over ``x *
    logistic(x)`` with ``lax.logistic``'s JVP ``s * (1 - s)``, ``ct * s +
    (x * ct) * (s * (1 - s))``, each step rounded to the dtype."""

    @staticmethod
    def forward(ctx, x):
        dt = x.dtype
        xf = x.to(torch.float32)
        e = _rounded(torch.exp(-xf), dt)
        # a tensor reciprocal: the IEEE quotient 1 / d on the CPU and CUDA
        s = _rounded(torch.reciprocal(_rounded(e + 1.0, dt)), dt)
        ctx.save_for_backward(x, s.to(dt))
        return (xf * s).to(dt)

    @staticmethod
    def backward(ctx, ct):
        x, s = ctx.saved_tensors
        dt = x.dtype
        xf, sf, cf = (t.to(torch.float32) for t in (x, s, ct))
        ds = _rounded(sf * _rounded(1.0 - sf, dt), dt)
        through_s = _rounded(_rounded(xf * cf, dt) * ds, dt)
        return (_rounded(cf * sf, dt) + through_s).to(dt)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu`` as the port mirrors it.  On bf16 rows XLA rounds
    every step of ``x * (1 / (1 + exp(-x)))`` to bf16 (exp of the bf16
    value in float32, then the sum, the reciprocal and the product), where
    torch's silu computes ``x / (1 + exp(-x))`` in float32 and rounds
    once: up to two bf16 steps apart, so reduced-precision rows take
    ``_Silu``, which rounds where XLA does and differentiates as
    ``jax.grad`` does.  Float32 rows keep torch's silu: there the two
    agree to an ulp, and XLA's exp (its own approximation) keeps even the
    expanded form an ulp off JAX on some values, while its gradient moved
    the 5-step float32 training that ``tests/test_torch_tools.py`` holds
    to JAX within 1e-5 past that tolerance.  Every port site that mirrors
    a ``jax.nn.silu`` calls it; ``silu_mul_quant_int8``'s kernel computes
    the same per dtype."""
    if x.dtype == torch.float32:
        return torch.nn.functional.silu(x)
    return _Silu.apply(x)


def silu_mul_quant_int8_plain(gate, up, gs: int):
    """``silu(gate) * up`` as the port mirrors JAX's (``silu``, then the
    product rounded to the dtype), then ``row_quant_int8_plain`` (gs ==
    D) or ``group_quant_int8_plain``.  Returns (y_q, y_s)."""
    return _quantize_plain(silu(gate) * up, gs)


def silu_mul_quant_int8(gate, up, gs: int, *,
                        _plan: NormQuantPlan = None):
    """gate, up (M, D) bf16 or f32 -> (y_q int8 (M, D), y_s f32 (M, 1) or
    (M, D // gs)): the SwiGLU product and the quantizer in one launch;
    the product is never written.  ``_plan`` as for
    ``rms_norm_quant_int8``."""
    if gate.device.type == "cpu":
        return silu_mul_quant_int8_plain(gate, up, gs)
    if gate.device.type != "cuda":
        raise ValueError(f"silu_mul_quant_int8: unsupported device "
                         f"{gate.device}")
    dev = gate.device
    _check("gate", gate, _FLOATS, 2, dev)
    M, D = gate.shape
    _check_rows("gate", gate, (M, D), gate.dtype, dev)
    _check_rows("up", up, (M, D), gate.dtype, dev)
    y_q, y_s = _fused_outputs("silu_mul_quant_int8", M, D, gs, dev)
    if M == 0:
        return y_q, y_s
    plan = _plan or norm_quant_plan(D)
    err = _norm_library().silu_mul_quant_int8(
        gate.data_ptr(), up.data_ptr(), y_q.data_ptr(), y_s.data_ptr(),
        int(gate.dtype == torch.bfloat16), M, D, gs, plan.lanes, plan.J,
        plan.blocks, _stream(gate))
    _raise_on(err, "silu_mul_quant_int8")
    launch_counts["silu_mul_quant_int8"] += 1
    return y_q, y_s


def launch_empty_rows(device, plan: NormQuantPlan, M: int):
    """Launch an empty kernel (not counted) of the fused kernels' geometry
    for M rows under ``plan`` (clusters of ``plan.blocks``): their launch
    floor."""
    _raise_on(_norm_library().empty_cluster_launch(
        plan.blocks, M, plan.threads,
        torch.cuda.current_stream(device).cuda_stream), "empty_cluster")


# ---------------------------------------------------------------------------
# the mma.sync GEMM's plan (w8_bf16_gemm)


# Tiles of the mma.sync kernel (csrc/quant_common.cuh, namespace tc):
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
    """The grid of ``w8_bf16_gemm`` for an (M, D) x
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


def _split_k_buffers(name, plan, dtype, dev):
    """The workspace (one (rows, GEMM_TILE_O) slab per tile and split) and
    the tile counters of a split-K launch; (None, None) without a
    split."""
    if plan.n_split == 1:
        return None, None
    n_tiles = plan.n_mtiles * plan.n_otiles
    ws = torch.empty((n_tiles * plan.n_split * plan.rows, GEMM_TILE_O),
                     dtype=dtype, device=dev)
    internal_counts[f"{name}_split_k"] += 1
    return ws, zeroed_counters(name, dev, n_tiles)


def _ptr(t):
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# w8a8_gemm and w8a8_gemm_many


def w8a8_gemm_plain(y_q, y_s, w_t, scale, out_dtype):
    """Exact int8 product against the K-major weight w_t (O, D) (float64
    holds |acc| < 2**53 exactly, on the CPU and on CUDA, where no integer
    matmul exists), then the epilogue of ``_qmm_i8_kernel``:
    ``(f32(acc) * y_s) * s`` -> out_dtype."""
    acc = (y_q.to(torch.float64) @ w_t.to(torch.float64).T).to(torch.float32)
    return (acc * y_s * scale[None, :]).to(out_dtype)


def w8a8_gemm_many_plain(y_q, y_s, w_ts, scales, out_dtype):
    """``w8a8_gemm_plain`` of each weight of one activation."""
    return tuple(w8a8_gemm_plain(y_q, y_s, w_t, s, out_dtype)
                 for w_t, s in zip(w_ts, scales))


# The Hopper kernel's tiles (csrc/quant_matmul.cu): output channels a tile,
# bytes of D a stage, the activation rows a tile is compiled for (the
# wgmma N sides), weights a launch, and its ring: at most
# W8A8_MAX_STAGES stages of W8A8_TILE_O weight rows and `rows`
# activation rows, in the SM's W8A8_SMEM bytes of shared memory
W8A8_TILE_O = 128
W8A8_STAGE_K = 128
W8A8_ROWS = (8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 224, 256)
W8A8_MAX_WEIGHTS = 3
W8A8_MAX_STAGES = 12
W8A8_SMEM = 232448


def w8a8_smem(rows: int, stages: int) -> int:
    """Dynamic shared memory of a block: the ring, its full and empty
    mbarriers, and 1024 bytes to align the ring for TMA's swizzle."""
    return 1024 + stages * (W8A8_TILE_O + rows) * W8A8_STAGE_K + 16 * stages


class W8A8Plan(NamedTuple):
    """One launch: tiles of (weight, W8A8_TILE_O channels, ``rows``
    activation rows), weight by weight, output tile by output tile, row
    tiles innermost; iteration ``t * n_k + k`` is stage k of D of tile t,
    and block b runs iterations [b * n_iters // blocks, (b + 1) * n_iters
    // blocks)."""
    rows: int  # activation rows a tile, one of W8A8_ROWS
    n_mtiles: int
    n_k: int  # stages of D a tile
    tile0: tuple  # each weight's first tile, then the number of tiles
    n_iters: int
    blocks: int  # persistent blocks, at most one an SM
    stages: int  # depth of the TMA ring
    split_tiles: int  # tiles whose iterations fall to more than one block


def _block_start(b, n_iters, blocks):
    return b * n_iters // blocks


@functools.lru_cache(maxsize=None)
def w8a8_plan(M: int, D: int, Os: tuple, sms: int) -> W8A8Plan:
    """The launch of ``w8a8_gemm_many`` for an (M, D) activation against
    K-major weights of (O, D) for O in ``Os`` on a card with ``sms`` SMs
    (a pure function of the shapes).  Up to 256 rows one row tile holds
    them all, so each weight crosses memory once; above, as few tiles as
    hold 256 rows each, of the fewest compiled rows that cover an even
    share.  The (tile, stage) iterations are cut into one equal run an SM
    (lengths differ by at most one stage)."""
    n_mtiles = _cdiv(M, W8A8_ROWS[-1])
    rows = next(r for r in W8A8_ROWS if r >= _cdiv(M, n_mtiles))
    n_k = _cdiv(D, W8A8_STAGE_K)
    tile0 = [0]
    for O in Os:
        tile0.append(tile0[-1] + _cdiv(O, W8A8_TILE_O) * n_mtiles)
    n_iters = tile0[-1] * n_k
    blocks = max(1, min(sms, n_iters))
    stages = W8A8_MAX_STAGES
    while w8a8_smem(rows, stages) > W8A8_SMEM:
        stages -= 1
    split = len({_block_start(b, n_iters, blocks) // n_k
                 for b in range(1, blocks)
                 if _block_start(b, n_iters, blocks) % n_k})
    return W8A8Plan(rows, n_mtiles, n_k, tuple(tile0), n_iters, blocks,
                    stages, split)


def w8a8_block_work(plan: W8A8Plan, b: int):
    """Block b's iterations as the kernel walks them: (weight, output
    tile, row tile, stage of D), in order."""
    out = []
    for it in range(_block_start(b, plan.n_iters, plan.blocks),
                    _block_start(b + 1, plan.n_iters, plan.blocks)):
        t, k = divmod(it, plan.n_k)
        w = max(i for i in range(len(plan.tile0) - 1) if plan.tile0[i] <= t)
        ot, mt = divmod(t - plan.tile0[w], plan.n_mtiles)
        out.append((w, ot, mt, k))
    return out


_w8a8_ws = {}


def _w8a8_buffers(dev, sms):
    """The split tiles' int32 workspace (a partial of 128 * rows a block,
    sized for the widest row tile; every slot read is written in the same
    launch, so it is never filled) and the owners' counters, zero between
    launches (the kernel resets each one it counts on)."""
    ws = _w8a8_ws.get(dev)
    if ws is None:
        ws = torch.empty((sms * W8A8_TILE_O * W8A8_ROWS[-1],),
                         dtype=torch.int32, device=dev)
        _w8a8_ws[dev] = ws
    return ws, zeroed_counters("w8a8_gemm", dev, sms)


def w8a8_gemm_many(y_q, y_s, w_ts, scales, out_dtype):
    """y_q (M, D) int8, y_s (M, 1) f32, up to W8A8_MAX_WEIGHTS K-major
    weights w_ts [(O_i, D) int8] with scales [(O_i,) f32] -> a tuple of
    (M, O_i) out_dtype, each bitwise what ``w8a8_gemm`` gives for its
    weight alone, in one launch of the kernel."""
    if y_q.device.type == "cpu":
        return w8a8_gemm_many_plain(y_q, y_s, w_ts, scales, out_dtype)
    if y_q.device.type != "cuda":
        raise ValueError(f"w8a8_gemm: unsupported device {y_q.device}")
    dev = y_q.device
    _check("y_q", y_q, (torch.int8,), 2, dev)
    _check("y_s", y_s, (torch.float32,), 2, dev)
    if out_dtype not in _FLOATS:
        raise TypeError(f"w8a8_gemm: out_dtype {out_dtype}")
    if len(w_ts) != len(scales) or not 1 <= len(w_ts) <= W8A8_MAX_WEIGHTS:
        raise ValueError(f"w8a8_gemm: 1 to {W8A8_MAX_WEIGHTS} weights, one "
                         "scale a weight")
    M, D = y_q.shape
    if y_s.shape != (M, 1):
        raise ValueError(f"w8a8_gemm: y_s {tuple(y_s.shape)} for M={M}")
    for w_t, s in zip(w_ts, scales):
        _check("w_t", w_t, (torch.int8,), 2, dev)
        _check("scale", s, (torch.float32,), 1, dev)
        if w_t.shape[1] != D or s.shape[0] != w_t.shape[0]:
            raise ValueError(
                f"w8a8_gemm: shapes y_q {tuple(y_q.shape)} w_t "
                f"{tuple(w_t.shape)} s {tuple(s.shape)}")
        if w_t.data_ptr() % 16:
            raise ValueError("w8a8_gemm: the weights must be 16-byte aligned")
    if D % 16 or y_q.data_ptr() % 16:
        raise ValueError(f"w8a8_gemm: D={D} must be a multiple of 16 and the "
                         "int8 operands 16-byte aligned")
    Os = tuple(w_t.shape[0] for w_t in w_ts)
    outs = tuple(torch.empty((M, O), dtype=out_dtype, device=dev)
                 for O in Os)
    if M == 0 or not any(Os):
        return outs
    if not all(Os):
        raise ValueError(f"w8a8_gemm: a zero-width weight among {Os}")
    sms = sm_count(dev)
    ws, counters = _w8a8_buffers(dev, sms)
    plan = w8a8_plan(M, D, Os, sms)
    pad = [None] * (W8A8_MAX_WEIGHTS - len(Os))
    err = _library().w8a8_gemm(
        y_q.data_ptr(), y_s.data_ptr(), M, D, len(Os),
        *[w_t.data_ptr() for w_t in w_ts], *pad,
        *[s.data_ptr() for s in scales], *pad,
        *[o.data_ptr() for o in outs], *pad,
        *Os, *[0] * len(pad), int(out_dtype == torch.bfloat16), plan.rows,
        plan.n_mtiles, plan.blocks, plan.stages, ws.data_ptr(),
        counters.data_ptr(), _stream(y_q))
    _raise_on(err, "w8a8_gemm")
    if plan.split_tiles:
        internal_counts["w8a8_gemm_split_k"] += 1
    launch_counts["w8a8_gemm"] += 1
    return outs


def w8a8_gemm(y_q, y_s, w_t, scale, out_dtype):
    """y_q (M, D) int8, y_s (M, 1) f32, w_t (O, D) int8 K-major, scale (O,)
    f32 -> (M, O) out_dtype: ``w8a8_gemm_many`` with one weight."""
    return w8a8_gemm_many(y_q, y_s, (w_t,), (scale,), out_dtype)[0]


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
    G = D // gs
    y_q = torch.empty((M, D), dtype=torch.int8, device=y.device)
    y_s = torch.empty((M, G), dtype=torch.float32, device=y.device)
    if M == 0:
        return y_q, y_s
    bf16 = int(y.dtype == torch.bfloat16)
    if (gs * y.element_size()) % 16 or y.data_ptr() % 16:
        # groups that are not whole 16-byte vectors: one thread a group
        err = _grouped_library().group_quant_int8_simple(
            y.data_ptr(), bf16, y_q.data_ptr(), y_s.data_ptr(), M, D, G,
            _stream(y))
        internal_counts["group_quant_int8_simple"] += 1
    else:
        plan = group_quant_plan(M, D, G, y.element_size())
        err = _grouped_library().group_quant_int8(
            y.data_ptr(), bf16, y_q.data_ptr(), y_s.data_ptr(), M, D, G,
            plan.lanes, plan.vpl, plan.threads, plan.blocks, _stream(y),
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


# The wgmma route's row tiles (csrc/grouped_matmul.cu: two int32 sets and
# the f32 results of N / 2 registers each a thread), its ring's depth,
# and its output tiles, stages and weights a launch are w8a8_gemm's
GROUPED_ROWS = (8, 16, 32, 48, 64, 80)
GROUPED_MAX_STAGES = 12
# a plan splits tiles across blocks only while the products its
# contributors park (rows x 128 channels of f32 a group, which stay in L2
# until the owner reads them) stay within the weight bytes over this
GROUPED_WS_CAP = 4
# without a split, a launch of fewer than half a wave of tiles takes
# narrower row tiles (the weight then crosses L2, not device memory, once
# more per row tile), down to this many rows
GROUPED_NARROW_ROWS = 16
# the wgmma route takes groups of whole k32 products
GROUPED_MMA_GROUP = 32


def _lcm(a, b):
    return a * b // math.gcd(a, b)


def grouped_ends(D: int, G: int) -> int:
    """Scale rows a stage of the ring carries: the most groups that can
    end in one 128-byte stage, at most G."""
    return min(G, _cdiv(W8A8_STAGE_K, D // G))


def grouped_smem(rows: int, G: int, ends: int, stages: int) -> int:
    """Dynamic shared memory of a block: the ring (each stage's weight,
    activation and scale boxes, rounded up to 1024 bytes), its
    mbarriers, a tile's rows x G activation scales, and 1024 bytes to
    align the ring."""
    stage = W8A8_TILE_O * W8A8_STAGE_K + rows * W8A8_STAGE_K \
        + ends * W8A8_TILE_O * 4
    stage = _cdiv(stage, 1024) * 1024
    return 1024 + stages * stage + 16 * stages + 4 * rows * G


def grouped_on_wgmma(D: int, G: int, O: int) -> bool:
    """Whether ``w8a8_grouped_gemm`` runs a (D, O) weight in G groups on
    its wgmma route (else on its simple route): groups of whole k32
    products, 16-byte rows of scales, and a ring of two stages at the
    narrowest row tile beside the tile's activation scales."""
    if G < 1 or D % G or (D // G) % GROUPED_MMA_GROUP or O % 4:
        return False
    return grouped_smem(GROUPED_ROWS[0], G, grouped_ends(D, G), 2) \
        <= W8A8_SMEM


class GroupedPlan(NamedTuple):
    """One launch of the wgmma route: tiles of (weight, W8A8_TILE_O
    channels, ``rows`` activation rows), weight by weight, output tile by
    output tile, row tiles innermost; a tile's ``n_k`` stages of D in
    units of ``unit`` stages (whole groups; ``upt`` units a tile), unit
    ``t * upt + j`` the tile's j-th; block b runs units [start(b),
    start(b + 1)), start(b) = (n_units // cut) * b // blocks * cut."""
    rows: int  # activation rows a tile, one of GROUPED_ROWS
    n_mtiles: int
    gs: int
    n_k: int
    unit: int  # stages a unit: lcm(gs, 128) / 128
    upt: int  # units a tile
    tile0: tuple  # each weight's first tile, then the number of tiles
    n_units: int
    cut: int  # units a piece: 1 (stream-K) or upt (whole tiles a block)
    blocks: int  # persistent blocks, at most one an SM
    stages: int  # depth of the TMA ring
    ends: int  # scale rows a stage carries
    park: int  # groups a block's workspace slot holds (0: no split)
    parked_bytes: int  # the f32 products contributors park
    split_tiles: int  # tiles whose units fall to more than one block


def grouped_start(plan: GroupedPlan, b: int) -> int:
    """The first unit of block b's run (b = blocks: the end of the
    last)."""
    return plan.n_units // plan.cut * b // plan.blocks * plan.cut


def _grouped_split(M, D, Os, rows, cut_whole, blocks, gs):
    """(n_mtiles, unit, upt, tile0, n_units, cut, blocks, park,
    parked_bytes, split_tiles) of a launch with ``rows`` rows a tile over
    ``blocks`` blocks (at most the pieces), whole tiles a block or not."""
    n_mtiles = _cdiv(M, rows)
    n_k = _cdiv(D, W8A8_STAGE_K)
    unit = _lcm(gs, W8A8_STAGE_K) // W8A8_STAGE_K
    upt = _cdiv(n_k, unit)
    tile0 = [0]
    for O in Os:
        tile0.append(tile0[-1] + _cdiv(O, W8A8_TILE_O) * n_mtiles)
    n_units = tile0[-1] * upt
    cut = upt if cut_whole else 1
    blocks = max(1, min(blocks, n_units // cut))
    starts = [n_units // cut * b // blocks * cut for b in range(blocks + 1)]
    park = parked = 0
    split = set()
    for b in range(blocks):
        u0, u1 = starts[b], starts[b + 1]
        if u0 % upt:  # a contributor: the tile began in an earlier run
            t = u0 // upt
            split.add(t)
            k0 = (u0 - t * upt) * unit
            k1 = min((min(u1, (t + 1) * upt) - t * upt) * unit, n_k)
            groups = (min(k1 * W8A8_STAGE_K, D) - k0 * W8A8_STAGE_K) // gs
            park = max(park, groups)
            parked += groups * rows * W8A8_TILE_O * 4
    return (n_mtiles, unit, upt, tuple(tile0), n_units, cut, blocks, park,
            parked, len(split))


@functools.lru_cache(maxsize=None)
def grouped_plan(M: int, D: int, G: int, Os: tuple, sms: int) -> GroupedPlan:
    """The launch of the wgmma route of ``w8a8_grouped_gemm_many`` for an
    (M, D) activation in G groups against K-major weights of (O, D) for O
    in ``Os`` on a card with ``sms`` SMs (a pure function of the shapes).
    Up to 80 rows one row tile holds them all (each weight crosses memory
    once); above, as few tiles as hold 80 rows each.  The units are cut
    into one equal run an SM (stream-K), where the products the split
    tiles' contributors park stay within 1 / GROUPED_WS_CAP of the weight
    bytes (at gs = 128: one row tile of 8 rows).  Above that cap each
    block takes whole tiles, and a launch of fewer than half a wave of
    tiles takes narrower row tiles, down to GROUPED_NARROW_ROWS."""
    gs = D // G

    def rows_of(n):  # the fewest compiled rows that cut M into n tiles
        return next(r for r in GROUPED_ROWS if r >= _cdiv(M, n))

    n = _cdiv(M, GROUPED_ROWS[-1])
    rows = rows_of(n)
    wbytes = D * sum(Os)
    sp = _grouped_split(M, D, Os, rows, False, sms, gs)
    if sp[8] * GROUPED_WS_CAP > wbytes:
        otiles = sum(_cdiv(O, W8A8_TILE_O) for O in Os)
        while 2 * otiles * _cdiv(M, rows) < sms and rows > GROUPED_NARROW_ROWS:
            n += 1
            rows = rows_of(n)
        sp = _grouped_split(M, D, Os, rows, True, sms, gs)
    n_mtiles, unit, upt, tile0, n_units, cut, blocks, park, parked, nsplit \
        = sp
    ends = grouped_ends(D, G)
    stages = GROUPED_MAX_STAGES
    while stages > 2 and grouped_smem(rows, G, ends, stages) > W8A8_SMEM:
        stages -= 1
    return GroupedPlan(rows, n_mtiles, gs, _cdiv(D, W8A8_STAGE_K), unit, upt,
                       tile0, n_units, cut, blocks, stages, ends, park,
                       parked, nsplit)


def grouped_block_work(plan: GroupedPlan, b: int):
    """Block b's stages as the kernel walks them: (weight, output tile, row
    tile, stage of D), in order."""
    out = []
    for u in range(grouped_start(plan, b), grouped_start(plan, b + 1)):
        t, j = divmod(u, plan.upt)
        w = max(i for i in range(len(plan.tile0) - 1) if plan.tile0[i] <= t)
        ot, mt = divmod(t - plan.tile0[w], plan.n_mtiles)
        for k in range(j * plan.unit, min((j + 1) * plan.unit, plan.n_k)):
            out.append((w, ot, mt, k))
    return out


def w8a8_grouped_gemm_many_plain(y_q, y_s, w_ts, scales, out_dtype):
    """``w8a8_grouped_gemm_plain`` of each weight of one activation."""
    return tuple(w8a8_grouped_gemm_plain(y_q, y_s, w_t, s, out_dtype)
                 for w_t, s in zip(w_ts, scales))


def w8a8_grouped_gemm_many(y_q, y_s, w_ts, scales, out_dtype):
    """y_q (M, D) int8, y_s (M, G) f32, up to W8A8_MAX_WEIGHTS K-major
    weights w_ts [(O_i, D) int8] with scales [(G, O_i) f32] -> a tuple of
    (M, O_i) out_dtype, each bitwise ``w8a8_grouped_gemm_plain`` of its
    weight: one launch of the wgmma route, or, for shapes it does not take
    (``grouped_on_wgmma``), one launch of the simple route a weight."""
    if y_q.device.type == "cpu":
        return w8a8_grouped_gemm_many_plain(y_q, y_s, w_ts, scales,
                                            out_dtype)
    if y_q.device.type != "cuda":
        raise ValueError(f"w8a8_grouped_gemm: unsupported device {y_q.device}")
    dev = y_q.device
    _check("y_q", y_q, (torch.int8,), 2, dev)
    _check("y_s", y_s, (torch.float32,), 2, dev)
    if out_dtype not in _FLOATS:
        raise TypeError(f"w8a8_grouped_gemm: out_dtype {out_dtype}")
    if len(w_ts) != len(scales) or not 1 <= len(w_ts) <= W8A8_MAX_WEIGHTS:
        raise ValueError(f"w8a8_grouped_gemm: 1 to {W8A8_MAX_WEIGHTS} "
                         "weights, one scale a weight")
    M, D = y_q.shape
    G = scales[0].shape[0] if scales[0].ndim == 2 else 0
    for w_t, s in zip(w_ts, scales):
        _check("w_t", w_t, (torch.int8,), 2, dev)
        _check("scale", s, (torch.float32,), 2, dev)
        if (w_t.shape[1] != D or s.shape != (G, w_t.shape[0]) or G < 1
                or D % G or y_s.shape != (M, G)):
            raise ValueError(
                f"w8a8_grouped_gemm: shapes y_q {tuple(y_q.shape)} y_s "
                f"{tuple(y_s.shape)} w_t {tuple(w_t.shape)} s "
                f"{tuple(s.shape)}")
        if w_t.data_ptr() % 16 or s.data_ptr() % 16:
            raise ValueError("w8a8_grouped_gemm: w_t and scale must be "
                             "16-byte aligned")
    if y_q.data_ptr() % 16:
        raise ValueError("w8a8_grouped_gemm: y_q must be 16-byte aligned")
    Os = tuple(w_t.shape[0] for w_t in w_ts)
    outs = tuple(torch.empty((M, O), dtype=out_dtype, device=dev)
                 for O in Os)
    if M == 0:
        return outs
    bf16 = int(out_dtype == torch.bfloat16)
    if not all(grouped_on_wgmma(D, G, O) for O in Os):
        for w_t, s, out in zip(w_ts, scales, outs):
            if out.shape[1] == 0:
                continue
            err = _grouped_library().w8a8_grouped_gemm_simple(
                y_q.data_ptr(), y_s.data_ptr(), w_t.data_ptr(), s.data_ptr(),
                out.data_ptr(), bf16, M, D, out.shape[1], G, _stream(y_q))
            _raise_on(err, "w8a8_grouped_gemm")
            internal_counts["w8a8_grouped_gemm_simple"] += 1
            launch_counts["w8a8_grouped_gemm"] += 1
        return outs
    plan = grouped_plan(M, D, G, Os, sm_count(dev))
    ws = None
    if plan.park:
        # each block's slot of parked products: every slot read is written
        # in the same launch, so it is never filled
        ws = torch.empty((plan.blocks * plan.park * plan.rows * W8A8_TILE_O,),
                         dtype=torch.float32, device=dev)
        internal_counts["w8a8_grouped_gemm_split_k"] += 1
    counters = zeroed_counters("w8a8_grouped_gemm", dev, plan.blocks)
    pad = [None] * (W8A8_MAX_WEIGHTS - len(Os))
    err = _grouped_library().w8a8_grouped_gemm(
        y_q.data_ptr(), y_s.data_ptr(), M, D, G, len(Os),
        *[w_t.data_ptr() for w_t in w_ts], *pad,
        *[s.data_ptr() for s in scales], *pad,
        *[o.data_ptr() for o in outs], *pad,
        *Os, *[0] * len(pad), bf16, plan.rows, plan.n_mtiles, plan.unit,
        plan.cut, plan.blocks, plan.stages, plan.park, _ptr(ws),
        counters.data_ptr(), _stream(y_q))
    _raise_on(err, "w8a8_grouped_gemm")
    launch_counts["w8a8_grouped_gemm"] += 1
    return outs


def w8a8_grouped_gemm(y_q, y_s, w_t, scale, out_dtype):
    """y_q (M, D) int8, y_s (M, G) f32, w_t (O, D) int8 K-major, scale
    (G, O) f32 -> (M, O) out_dtype: ``w8a8_grouped_gemm_many`` with one
    weight."""
    return w8a8_grouped_gemm_many(y_q, y_s, (w_t,), (scale,), out_dtype)[0]
