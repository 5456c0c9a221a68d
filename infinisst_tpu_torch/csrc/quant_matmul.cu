// Hand-written Hopper (sm_90a) ports of the int8 matmul Pallas kernels in
// infinisst_tpu/kernels/quant_matmul.py.  Plain C interface, bound with
// ctypes from infinisst_tpu_torch/kernels/quant_matmul.py; no PyTorch
// headers, so the file builds in seconds.
//
//   row_quant_int8  <- quantize_activation (quant_matmul.py:106)
//   w8a8_gemm       <- _qmm_i8_kernel (quant_matmul.py:94), the body of
//                      quantized_matmul_w8a8 (:117)
//   w8_bf16_gemm    <- _qmm_kernel (quant_matmul.py:26), the body of
//                      quantized_matmul (:34)
//   group_quant_int8   <- quantize_activation_grouped (quant_matmul.py:226)
//   w8a8_grouped_gemm  <- _qmm_i8_grouped_kernel (quant_matmul.py:191), the
//                         body of quantized_matmul_w8a8_grouped (:239)
//
// What bounds them on the H100: at the main path's M (4 beam rows, 61/79
// prefill rows) both GEMMs are bound by streaming the int8 weight from
// device memory (D*O bytes against 2*M*D*O operations, far below the
// ~590 int8 operations per byte where the tensor cores would bind).
// row_quant_int8 reads M*D activations and writes M*D bytes.  The grouped
// pair is bound the same way; its weight scales are (G, O) float32, G =
// D / 128, 3 % of the int8 weight bytes.
//
// w8a8_gemm (redesigned for Hopper) reads its weight K-major, (O, D) int8,
// packed once where the leaves are made (models/quant.py:pack_w8a8), so
// that each output channel's D bytes are contiguous: int8 tensor-core
// operands are K-major only.  Swap AB: the weight is the 16-row A operand
// of mma.sync m16n8k32 (s8 x s8 -> s32) and the activation rows are its
// 8-wide N side, so one block tile holds all M <= 80 rows of a call and
// the weight crosses device memory once per call at M in {1, 4, 61, 79}.
// A block owns 128 output channels (4 warps x two m16 tiles) and one
// contiguous K range; a 4-stage cp.async ring (16 bytes a thread) streams
// 128-byte-deep weight and activation tiles (whole L2 lines) through
// shared memory.  In each 64 bytes of a stage each thread reads 16
// contiguous bytes of a row and feeds them to two MMAs; A and B take the
// same byte-to-k assignment, and an integer sum does not depend on the
// order of its terms.  Narrow O gets
// split-K across blocks (host plan: about two blocks per SM at M <= 16);
// each block stores its int32 partial (plain stores, no zeroed workspace)
// and the last block of an output tile, found with an atomic counter that
// it resets, sums the partials in split order and applies the unchanged
// epilogue (f32(acc) * ys[m]) * s[o].  The result is bitwise that of the
// plain version.
//
// The other GEMMs keep the simple first design: each block computes a
// TM x 128 output tile; lane l of every warp owns 4 consecutive output
// columns, so a warp's weight load is 128 contiguous bytes of one weight
// row (coalesced, JAX (D, O) layout read as is); the block's warps split
// the reduction axis and meet in shared memory; the TM activation rows are
// staged in shared memory.  The ragged M and O edges are masked in the
// kernel.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTM = 4;          // output rows per block
constexpr int kCols = 4;        // output columns per lane
constexpr int kWarps = 8;       // warps per block, split along D
constexpr int kThreads = 32 * kWarps;
constexpr int kTO = 32 * kCols;  // output columns per block

__device__ __forceinline__ float load_f32(const void* p, int is_bf16,
                                          int64_t i) {
  if (is_bf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  }
  return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_out(void* p, int is_bf16, int64_t i,
                                          float v) {
  if (is_bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

// ---------------------------------------------------------------------------
// row_quant_int8: one block per row.  s = max(amax / 127, 1e-8);
// q = clamp(rint(y / s), -127, 127).  Divides (no reciprocal) and rounds
// half to even, as jnp.round does.

__global__ void row_quant_int8_kernel(const void* __restrict__ y, int y_bf16,
                                      int8_t* __restrict__ yq,
                                      float* __restrict__ ys, int D) {
  const int64_t row = blockIdx.x;
  const int64_t base = row * D;
  float amax = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    amax = fmaxf(amax, fabsf(load_f32(y, y_bf16, base + i)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  __shared__ float warp_max[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_max[warp] = amax;
  __syncthreads();
  if (warp == 0) {
    const int nw = (blockDim.x + 31) >> 5;
    amax = lane < nw ? warp_max[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) {
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    }
    if (lane == 0) warp_max[0] = fmaxf(amax / 127.0f, 1e-8f);
  }
  __syncthreads();
  const float s = warp_max[0];
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    float q = rintf(load_f32(y, y_bf16, base + i) / s);
    q = fminf(fmaxf(q, -127.f), 127.f);
    yq[base + i] = static_cast<int8_t>(q);
  }
  if (threadIdx.x == 0) ys[row] = s;
}

// Gather byte j of each of r0..r3 into one word: the 4 consecutive-k int8
// weights of output column j, in the byte order __dp4a pairs with y.
__device__ __forceinline__ void transpose4(int r0, int r1, int r2, int r3,
                                           int c[4]) {
  const int lo01 = __byte_perm(r0, r1, 0x5140);
  const int hi01 = __byte_perm(r0, r1, 0x7362);
  const int lo23 = __byte_perm(r2, r3, 0x5140);
  const int hi23 = __byte_perm(r2, r3, 0x7362);
  c[0] = __byte_perm(lo01, lo23, 0x5410);
  c[1] = __byte_perm(lo01, lo23, 0x7632);
  c[2] = __byte_perm(hi01, hi23, 0x5410);
  c[3] = __byte_perm(hi01, hi23, 0x7632);
}

// ---------------------------------------------------------------------------
// w8a8_gemm: out[m, o] = (f32(sum_k yq[m,k] * wt[o,k]) * ys[m]) * s[o], with
// the weight K-major (O, D).  int8 x int8 products accumulate exactly in
// int32 on the tensor cores (mma.sync m16n8k32).  Requires D % 16 == 0
// (checked by the wrapper); ragged M and O edges are zero-filled and masked.

namespace tc {

constexpr int kTK = 128;       // bytes of D per pipeline stage
constexpr int kStages = 4;     // depth of the cp.async ring
constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMTiles = 2;     // m16 tiles of output channels per warp
constexpr int kWarpO = 16 * kMTiles;
constexpr int kTO = kWarps * kWarpO;  // output channels per block

}  // namespace tc

// ``prefetch``: also bring the rest of the source's 256-byte L2 block in
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid, bool prefetch = false) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  if (prefetch) {
    asm volatile(
        "cp.async.cg.shared.global.L2::256B [%0], [%1], 16, %2;\n" ::"r"(d),
        "l"(src), "r"(n)
        : "memory");
  } else {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void mma_s8(int (&c)[4], int a0, int a1, int a2,
                                       int a3, int b0, int b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk c of row r in a stage of 128-byte rows.
// Odd rows swap their 64-byte halves, so the 8 lanes of a quarter warp
// (rows g, g + 1, chunks t) read 8 distinct bank groups.
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * tc::kTK + ((c ^ ((r & 1) << 2)) << 4);
}

// Grid: x = output tile of kTO channels, y = split of D (k_split bytes
// each, the last one short), z = tile of NT * 8 activation rows.
// ws (split-K only): one int32 partial per (tile, split, register, thread);
// counters: one per (row tile, output tile), zero on entry and on exit.
template <int NT>
__global__ void __launch_bounds__(tc::kThreads)
w8a8_gemm_tc_kernel(const int8_t* __restrict__ yq,
                    const float* __restrict__ ys,
                    const int8_t* __restrict__ wt,
                    const float* __restrict__ s, void* __restrict__ out,
                    int out_bf16, int M, int D, int O, int k_split,
                    int prefetch, int* __restrict__ ws,
                    int* __restrict__ counters) {
  constexpr int kRows = NT * 8;
  constexpr int kWBytes = tc::kTO * tc::kTK;
  constexpr int kStageBytes = kWBytes + kRows * tc::kTK;
  constexpr int kRegs = tc::kMTiles * NT * 4;  // accumulators per thread
  constexpr int kChunks = tc::kTK / 16;          // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ot = blockIdx.x, split = blockIdx.y;
  const int n_split = gridDim.y;
  const int o0 = ot * tc::kTO, m0 = blockIdx.z * kRows;
  const int k0 = split * k_split;
  const int k1 = min(D, k0 + k_split);
  const int n_k = (k1 - k0 + tc::kTK - 1) / tc::kTK;

  // one stage: kTO weight rows and kRows activation rows of kTK bytes
  // (whole L2 lines), chunks of 16 bytes; chunks past O, M or the
  // split's end are zero-filled
  auto load_stage = [&](int slot, int kt) {
    unsigned char* st = smem + slot * kStageBytes;
    const int kb = k0 + kt * tc::kTK;
#pragma unroll
    for (int i = tid; i < tc::kTO * kChunks; i += tc::kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int o = o0 + r, k = kb + c * 16;
      const bool ok = o < O && k < k1;
      cp_async16(st + chunk_at(r, c), ok ? wt + (int64_t)o * D + k : wt, ok,
                 prefetch);
    }
    unsigned char* at = st + kWBytes;
    for (int i = tid; i < kRows * kChunks; i += tc::kThreads) {
      const int r = i / kChunks, c = i % kChunks;
      const int m = m0 + r, k = kb + c * 16;
      const bool ok = m < M && k < k1;
      cp_async16(at + chunk_at(r, c), ok ? yq + (int64_t)m * D + k : yq, ok);
    }
  };

  int acc[tc::kMTiles][NT][4];
#pragma unroll
  for (int i = 0; i < tc::kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int p = 0; p < tc::kStages - 1; ++p) {
    if (p < n_k) load_stage(p, p);
    cp_async_commit();
  }
  for (int kt = 0; kt < n_k; ++kt) {
    cp_async_wait<tc::kStages - 2>();
    __syncthreads();  // stage kt landed; slot (kt - 1) % kStages is free
    if (kt + tc::kStages - 1 < n_k) {
      load_stage((kt + tc::kStages - 1) % tc::kStages, kt + tc::kStages - 1);
    }
    cp_async_commit();
    const unsigned char* st = smem + (kt % tc::kStages) * kStageBytes;
    const unsigned char* at = st + kWBytes;
    // in each 64-byte half, thread (g, t) takes bytes [16t, 16t + 16) of
    // its rows: words x, y feed one MMA (k slots t*4.. and 16 + t*4..),
    // words z, w the next
#pragma unroll
    for (int h = 0; h < tc::kTK / 64; ++h) {
      const int c = h * 4 + t;
      int4 a[tc::kMTiles][2];
#pragma unroll
      for (int i = 0; i < tc::kMTiles; ++i) {
        const int r = warp * tc::kWarpO + i * 16 + g;
        a[i][0] = *reinterpret_cast<const int4*>(st + chunk_at(r, c));
        a[i][1] = *reinterpret_cast<const int4*>(st + chunk_at(r + 8, c));
      }
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int4 b =
            *reinterpret_cast<const int4*>(at + chunk_at(j * 8 + g, c));
#pragma unroll
        for (int i = 0; i < tc::kMTiles; ++i) {
          mma_s8(acc[i][j], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b.x,
                 b.y);
          mma_s8(acc[i][j], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w, b.z,
                 b.w);
        }
      }
    }
  }
  cp_async_wait<0>();

  if (n_split > 1) {
    const int tile = blockIdx.z * gridDim.x + ot;
    int* part = ws + ((int64_t)tile * n_split + split) * kRegs * tc::kThreads;
#pragma unroll
    for (int i = 0; i < tc::kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          part[((i * NT + j) * 4 + e) * tc::kThreads + tid] = acc[i][j][e];
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    // the last block sums every split's partial of the registers this
    // thread owns, in split order (int32: the same bits in any order)
    const int* base = ws + (int64_t)tile * n_split * kRegs * tc::kThreads;
#pragma unroll
    for (int i = 0; i < tc::kMTiles; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
    for (int sp = 0; sp < n_split; ++sp) {
      const int* p = base + (int64_t)sp * kRegs * tc::kThreads;
#pragma unroll
      for (int i = 0; i < tc::kMTiles; ++i)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][j][e] +=
                __ldcg(p + ((i * NT + j) * 4 + e) * tc::kThreads + tid);
    }
    if (tid == 0) counters[tile] = 0;
  }

  // epilogue: c0, c1 -> channel g, rows 2t, 2t + 1; c2, c3 -> channel g + 8
#pragma unroll
  for (int i = 0; i < tc::kMTiles; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + warp * tc::kWarpO + i * 16 + g + (e >> 1) * 8;
        const int m = m0 + j * 8 + 2 * t + (e & 1);
        if (o < O && m < M) {
          const float v = __fmul_rn(
              __fmul_rn(static_cast<float>(acc[i][j][e]), ys[m]), s[o]);
          store_out(out, out_bf16, (int64_t)m * O + o, v);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// w8_bf16_gemm: out[m, o] = (sum_k bf16(y[m,k]) * float(w[k,o])) * s[o],
// f32 accumulation, cast to y's dtype.  The activation is rounded to bf16
// first, as _qmm_kernel does; int8 -> float is exact, and so is each
// bf16 x int8 product, so only the f32 summation order differs from the
// plain version.  Requires O % 4 == 0.

__global__ void __launch_bounds__(kThreads)
w8_bf16_gemm_kernel(const void* __restrict__ y, int y_bf16,
                    const int8_t* __restrict__ w, const float* __restrict__ s,
                    void* __restrict__ out, int M, int D, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ysh = reinterpret_cast<__nv_bfloat16*>(smem);  // (kTM, D)
  float* red = reinterpret_cast<float*>(
      smem + ((kTM * D * 2 + 15) / 16) * 16);

  const int m0 = blockIdx.y * kTM;
  const int o0 = blockIdx.x * kTO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kTM * D; i += kThreads) {
    const int m = i / D, k = i % D;
    float v = 0.f;
    if (m0 + m < M) v = load_f32(y, y_bf16, (int64_t)(m0 + m) * D + k);
    ysh[i] = __float2bfloat16_rn(v);
  }
  __syncthreads();

  const int o = o0 + lane * kCols;
  const bool col_ok = o < O;
  float acc[kTM][kCols];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0.f;

  if (col_ok) {
    const int8_t* wp = w + o;
    for (int k = warp; k < D; k += kWarps) {
      const char4 r = *reinterpret_cast<const char4*>(wp + (int64_t)k * O);
      const float wf[4] = {static_cast<float>(r.x), static_cast<float>(r.y),
                           static_cast<float>(r.z), static_cast<float>(r.w)};
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        const float a = __bfloat162float(ysh[m * D + k]);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = fmaf(a, wf[j], acc[m][j]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      red[(warp * kTM + m) * kTO + lane * kCols + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kTM * kTO; i += kThreads) {
    const int m = i / kTO, col = i % kTO;
    if (m0 + m >= M || o0 + col >= O) continue;
    float sum = 0.f;
    for (int wi = 0; wi < kWarps; ++wi) sum += red[(wi * kTM + m) * kTO + col];
    store_out(out, y_bf16, (int64_t)(m0 + m) * O + o0 + col, sum * s[o0 + col]);
  }
}

// ---------------------------------------------------------------------------
// group_quant_int8: one warp per (row, group) of gs = D / G elements.
// s = max(amax / 127, 1e-8); q = clamp(rint(y / s), -127, 127), as
// quantize_activation_grouped computes it (IEEE division, half to even).

__global__ void group_quant_int8_kernel(const void* __restrict__ y, int y_bf16,
                                        int8_t* __restrict__ yq,
                                        float* __restrict__ ys, int M, int D,
                                        int G) {
  const int64_t gw = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (gw >= (int64_t)M * G) return;  // whole warps leave together
  const int gs = D / G;
  const int64_t m = gw / G, g = gw % G;
  const int64_t base = m * D + g * gs;
  float amax = 0.f;
  for (int i = lane; i < gs; i += 32) {
    amax = fmaxf(amax, fabsf(load_f32(y, y_bf16, base + i)));
  }
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = fmaxf(amax / 127.0f, 1e-8f);
  for (int i = lane; i < gs; i += 32) {
    float q = rintf(load_f32(y, y_bf16, base + i) / s);
    q = fminf(fmaxf(q, -127.f), 127.f);
    yq[base + i] = static_cast<int8_t>(q);
  }
  if (lane == 0) ys[gw] = s;
}

// ---------------------------------------------------------------------------
// w8a8_grouped_gemm: for g in order, o = fma(f32(acc_g[m, o]) * ys[m, g],
// s[g, o], o) in f32 from 0, then cast, with acc_g the exact int32 dot of
// group g (|acc_g| <= 128 * 127^2 < 2^24 at gs = 128, so f32(acc_g) is
// exact): the arithmetic of _qmm_i8_grouped_kernel's o += acc * ys * s as
// XLA compiles it (one fused multiply-add).  The tile and weight reads are
// those of w8a8_gemm; the warps take whole groups, kWarps groups at a
// time, and park f32(acc_g) * ys_g in shared memory, where each output's
// owner thread folds them in g order.  __fmul_rn / __fmaf_rn pin the
// roundings.  Requires gs % 4 == 0 and O % 4 == 0 (checked by the
// wrapper).

constexpr int kOutPerThread = kTM * kTO / kThreads;

__global__ void __launch_bounds__(kThreads)
w8a8_grouped_gemm_kernel(const int8_t* __restrict__ yq,
                         const float* __restrict__ ys,
                         const int8_t* __restrict__ w,
                         const float* __restrict__ s, void* __restrict__ out,
                         int out_bf16, int M, int D, int O, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ysh = reinterpret_cast<int8_t*>(smem);  // (kTM, D)
  float* part = reinterpret_cast<float*>(
      smem + ((kTM * D + 15) / 16) * 16);  // (kWarps, kTM, kTO)

  const int gs = D / G;
  const int m0 = blockIdx.y * kTM;
  const int o0 = blockIdx.x * kTO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  for (int i = threadIdx.x; i < kTM * D / 4; i += kThreads) {
    const int m = (i * 4) / D, k = (i * 4) % D;
    int v = 0;
    if (m0 + m < M) {
      v = *reinterpret_cast<const int*>(yq + (int64_t)(m0 + m) * D + k);
    }
    *reinterpret_cast<int*>(ysh + m * D + k) = v;
  }
  __syncthreads();

  const int o = o0 + lane * kCols;
  const bool col_ok = o < O;
  float res[kOutPerThread];
#pragma unroll
  for (int t = 0; t < kOutPerThread; ++t) res[t] = 0.f;

  for (int gb = 0; gb < G; gb += kWarps) {
    const int g = gb + warp;
    if (g < G) {
      int acc[kTM][kCols];
#pragma unroll
      for (int m = 0; m < kTM; ++m)
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = 0;
      if (col_ok) {
        const int8_t* wp = w + o;
        for (int k = g * gs; k < (g + 1) * gs; k += 4) {
          const int r0 = *reinterpret_cast<const int*>(wp + (int64_t)k * O);
          const int r1 =
              *reinterpret_cast<const int*>(wp + (int64_t)(k + 1) * O);
          const int r2 =
              *reinterpret_cast<const int*>(wp + (int64_t)(k + 2) * O);
          const int r3 =
              *reinterpret_cast<const int*>(wp + (int64_t)(k + 3) * O);
          int c[4];
          transpose4(r0, r1, r2, r3, c);
#pragma unroll
          for (int m = 0; m < kTM; ++m) {
            const int a = *reinterpret_cast<const int*>(ysh + m * D + k);
#pragma unroll
            for (int j = 0; j < kCols; ++j)
              acc[m][j] = __dp4a(c[j], a, acc[m][j]);
          }
        }
      }
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        const float ysv = m0 + m < M ? ys[(int64_t)(m0 + m) * G + g] : 0.f;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          part[(warp * kTM + m) * kTO + lane * kCols + j] =
              __fmul_rn(static_cast<float>(acc[m][j]), ysv);
        }
      }
    }
    __syncthreads();
    const int nb = min(kWarps, G - gb);
#pragma unroll
    for (int t = 0; t < kOutPerThread; ++t) {
      const int i = threadIdx.x + t * kThreads;
      const int col = o0 + i % kTO;
      if (col < O) {
        for (int wi = 0; wi < nb; ++wi) {
          res[t] = __fmaf_rn(part[wi * kTM * kTO + i],
                             s[(int64_t)(gb + wi) * O + col], res[t]);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int t = 0; t < kOutPerThread; ++t) {
    const int i = threadIdx.x + t * kThreads;
    const int m = i / kTO, col = i % kTO;
    if (m0 + m < M && o0 + col < O) {
      store_out(out, out_bf16, (int64_t)(m0 + m) * O + o0 + col, res[t]);
    }
  }
}

int set_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes)));
}

template <int NT>
int launch_w8a8(const void* yq, const void* ys, const void* wt,
                const void* s, void* out, int out_bf16, int M, int D, int O,
                int k_split, int n_split, void* ws, void* counters,
                cudaStream_t stream) {
  const size_t smem = (size_t)tc::kStages * (tc::kTO + NT * 8) * tc::kTK;
  // set once per instance, whatever the size: the kernel's static shared
  // memory counts against the 48 KB default too
  static bool smem_set = false;
  if (!smem_set) {
    int err = static_cast<int>(cudaFuncSetAttribute(
        w8a8_gemm_tc_kernel<NT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (err) return err;
    smem_set = true;
  }
  dim3 grid((O + tc::kTO - 1) / tc::kTO, n_split, (M + NT * 8 - 1) / (NT * 8));
  // a block that streams long weight rows past few activation rows gains
  // from fetching the next 128 bytes of each row into L2 early; with more
  // rows, or short splits, the extra traffic cost more than it gave
  // (measured on the H100)
  const int prefetch = NT <= 2 && k_split >= 1024;
  w8a8_gemm_tc_kernel<NT><<<grid, tc::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(yq), static_cast<const float*>(ys),
      static_cast<const int8_t*>(wt), static_cast<const float*>(s), out,
      out_bf16, M, D, O, k_split, prefetch, static_cast<int*>(ws),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launch (0 = success).

int row_quant_int8(const void* y, int y_bf16, void* yq, void* ys, int M,
                   int D, void* stream) {
  if (M == 0) return 0;
  row_quant_int8_kernel<<<M, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      y, y_bf16, static_cast<int8_t*>(yq), static_cast<float*>(ys), D);
  return static_cast<int>(cudaGetLastError());
}

int w8a8_gemm_tile_o() { return tc::kTO; }

int w8a8_gemm_tile_k() { return tc::kTK; }

// wt is K-major (O, D).  rows (activation rows per block: 8, 16, 32, 64 or
// 80), k_split and n_split come from the wrapper's plan
// (kernels/quant_matmul.py:w8a8_plan); ws and counters are used only when
// n_split > 1.
int w8a8_gemm(const void* yq, const void* ys, const void* wt, const void* s,
              void* out, int out_bf16, int M, int D, int O, int rows,
              int k_split, int n_split, void* ws, void* counters,
              void* stream) {
  if (M == 0 || O == 0) return 0;
  if (k_split <= 0 || k_split % tc::kTK ||
      n_split != (D + k_split - 1) / k_split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define W8A8_LAUNCH(NT_)                                                   \
  return launch_w8a8<NT_>(yq, ys, wt, s, out, out_bf16, M, D, O, k_split,  \
                          n_split, ws, counters, st)
  switch (rows) {
    case 8: W8A8_LAUNCH(1);
    case 16: W8A8_LAUNCH(2);
    case 32: W8A8_LAUNCH(4);
    case 64: W8A8_LAUNCH(8);
    case 80: W8A8_LAUNCH(10);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef W8A8_LAUNCH
}

size_t w8_bf16_gemm_smem(int D) {
  return ((kTM * (size_t)D * 2 + 15) / 16) * 16 +
         sizeof(float) * kWarps * kTM * kTO;
}

int w8_bf16_gemm(const void* y, int y_bf16, const void* w, const void* s,
                 void* out, int M, int D, int O, void* stream) {
  if (M == 0 || O == 0) return 0;
  const size_t smem = w8_bf16_gemm_smem(D);
  int err = set_smem(reinterpret_cast<const void*>(w8_bf16_gemm_kernel), smem);
  if (err) return err;
  dim3 grid((O + kTO - 1) / kTO, (M + kTM - 1) / kTM);
  w8_bf16_gemm_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      y, y_bf16, static_cast<const int8_t*>(w), static_cast<const float*>(s),
      out, M, D, O);
  return static_cast<int>(cudaGetLastError());
}

int group_quant_int8(const void* y, int y_bf16, void* yq, void* ys, int M,
                     int D, int G, void* stream) {
  if (M == 0) return 0;
  const int64_t warps = (int64_t)M * G;
  const int blocks = static_cast<int>((warps + kWarps - 1) / kWarps);
  group_quant_int8_kernel<<<blocks, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      y, y_bf16, static_cast<int8_t*>(yq), static_cast<float*>(ys), M, D, G);
  return static_cast<int>(cudaGetLastError());
}

size_t w8a8_grouped_gemm_smem(int D) {
  return ((kTM * (size_t)D + 15) / 16) * 16 +
         sizeof(float) * kWarps * kTM * kTO;
}

int w8a8_grouped_gemm(const void* yq, const void* ys, const void* w,
                      const void* s, void* out, int out_bf16, int M, int D,
                      int O, int G, void* stream) {
  if (M == 0 || O == 0) return 0;
  const size_t smem = w8a8_grouped_gemm_smem(D);
  int err = set_smem(reinterpret_cast<const void*>(w8a8_grouped_gemm_kernel),
                     smem);
  if (err) return err;
  dim3 grid((O + kTO - 1) / kTO, (M + kTM - 1) / kTM);
  w8a8_grouped_gemm_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(yq), static_cast<const float*>(ys),
      static_cast<const int8_t*>(w), static_cast<const float*>(s), out,
      out_bf16, M, D, O, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
