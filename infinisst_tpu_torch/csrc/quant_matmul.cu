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
// Design (the simple first version): each block computes a TM x 128 output
// tile; lane l of every warp owns 4 consecutive output columns, so a warp's
// weight load is 128 contiguous bytes of one weight row (coalesced, JAX
// (D, O) layout read as is); the block's warps split the reduction axis and
// meet in shared memory; the TM activation rows are staged in shared
// memory.  The ragged M and O edges are masked in the kernel.  wgmma, TMA,
// a K-major weight layout and split-K across blocks are later work.

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
// w8a8_gemm: out[m, o] = ((float)sum_k yq[m,k] * w[k,o]) * ys[m]) * s[o].
// int8 x int8 products accumulate exactly in int32 (__dp4a over k-quads).
// Requires D % 4 == 0 and O % 4 == 0 (checked by the wrapper).

__global__ void __launch_bounds__(kThreads)
w8a8_gemm_kernel(const int8_t* __restrict__ yq, const float* __restrict__ ys,
                 const int8_t* __restrict__ w, const float* __restrict__ s,
                 void* __restrict__ out, int out_bf16, int M, int D, int O) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* ysh = reinterpret_cast<int8_t*>(smem);  // (kTM, D)
  int* red = reinterpret_cast<int*>(smem + ((kTM * D + 15) / 16) * 16);

  const int m0 = blockIdx.y * kTM;
  const int o0 = blockIdx.x * kTO;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // stage the tile's activation rows; rows past M are zero
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
  int acc[kTM][kCols];
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[m][j] = 0;

  if (col_ok) {
    const int8_t* wp = w + o;
    for (int k = warp * 4; k < D; k += kWarps * 4) {
      const int r0 = *reinterpret_cast<const int*>(wp + (int64_t)k * O);
      const int r1 = *reinterpret_cast<const int*>(wp + (int64_t)(k + 1) * O);
      const int r2 = *reinterpret_cast<const int*>(wp + (int64_t)(k + 2) * O);
      const int r3 = *reinterpret_cast<const int*>(wp + (int64_t)(k + 3) * O);
      int c[4];
      transpose4(r0, r1, r2, r3, c);
#pragma unroll
      for (int m = 0; m < kTM; ++m) {
        const int a = *reinterpret_cast<const int*>(ysh + m * D + k);
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[m][j] = __dp4a(c[j], a, acc[m][j]);
      }
    }
  }
  // cross-warp reduction: red[warp][m][col]
#pragma unroll
  for (int m = 0; m < kTM; ++m)
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      red[(warp * kTM + m) * kTO + lane * kCols + j] = acc[m][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kTM * kTO; i += kThreads) {
    const int m = i / kTO, col = i % kTO;
    if (m0 + m >= M || o0 + col >= O) continue;
    int sum = 0;
    for (int wi = 0; wi < kWarps; ++wi) sum += red[(wi * kTM + m) * kTO + col];
    const float v = (static_cast<float>(sum) * ys[m0 + m]) * s[o0 + col];
    store_out(out, out_bf16, (int64_t)(m0 + m) * O + o0 + col, v);
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

size_t w8a8_gemm_smem(int D) {
  return ((kTM * (size_t)D + 15) / 16) * 16 + sizeof(int) * kWarps * kTM * kTO;
}

int w8a8_gemm(const void* yq, const void* ys, const void* w, const void* s,
              void* out, int out_bf16, int M, int D, int O, void* stream) {
  if (M == 0 || O == 0) return 0;
  const size_t smem = w8a8_gemm_smem(D);
  int err = set_smem(reinterpret_cast<const void*>(w8a8_gemm_kernel), smem);
  if (err) return err;
  dim3 grid((O + kTO - 1) / kTO, (M + kTM - 1) / kTM);
  w8a8_gemm_kernel<<<grid, kThreads, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(yq), static_cast<const float*>(ys),
      static_cast<const int8_t*>(w), static_cast<const float*>(s), out,
      out_bf16, M, D, O);
  return static_cast<int>(cudaGetLastError());
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
