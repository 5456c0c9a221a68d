// Hand-written Hopper (sm_90a) kernels that end in the int8 activation
// quantizer: the quantization becomes the last step of the kernel that
// produces its input, which already holds the row in registers.  Plain C
// interface, bound with ctypes from
// infinisst_tpu_torch/kernels/quant_matmul.py; no PyTorch headers.
//
//   rms_norm_quant_int8  <- llama._rms_norm (infinisst_tpu/models/
//                           llama.py:47), with the residual add before it,
//                           then quantize_activation (kernels/
//                           quant_matmul.py:106) or quantize_activation_
//                           grouped (:226)
//   silu_mul_quant_int8  <- jax.nn.silu(gate) * up (models/llama.py:174),
//                           then the same quantizers
//
// What bounds them on the H100: M rows of D values read (two inputs) and
// M * D bytes written, a few microseconds of work at the beam step's four
// rows: the launch and one round trip to memory, as for row_quant_int8.
// XLA fuses the norm, the product and the quantizer on the TPU; here each
// of them had been one or more eager launches near the same floor.
//
// Design.  A row is cut into chunks of 8 values (16 bytes of bf16, 32 of
// float32), held by `lanes` lanes: lane t holds chunks t, t + lanes, ...
// (J of them, loaded with 16-byte loads, all in flight at once).  The
// lanes of a row may span a thread-block cluster of K blocks (grid x),
// which exchange their warps' partial sums of squares and maxima through
// distributed shared memory; a block's warps' partials are read by every
// block in a fixed order, so the result does not depend on K.
//
// Summation order of the sum of squares (bitwise that of
// rms_norm_quant_int8_plain, which computes the same adds as elementwise
// tensor ops): each lane adds its squares in chunk order, then value
// order, from 0; a warp adds its lanes by an xor butterfly over lane bits
// 16, 8, 4, 2, 1 (IEEE addition commutes, so every lane holds the same
// bits); the row's total is warp 0's sum plus warp 1's, ..., in warp
// order.  The lanes and J are a function of D only (norm_lanes in the
// wrapper), so a row's result does not depend on M, on K or on the other
// rows of the batch.  Every add and multiply is __fadd_rn / __fmul_rn (no
// FMA contraction), the mean an IEEE division by D, the scale an IEEE
// division by 127, each value an IEEE division by the scale, rounded half
// to even, as the plain versions compute them.

#include <cooperative_groups.h>

#include "quant_common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 8;      // values a chunk
constexpr int kMaxWarps = 64;  // warps a row (lanes <= 2048)

template <bool BF16>
__device__ __forceinline__ void load_chunk(const void* base, int64_t c,
                                           float (&v)[kChunk]) {
  const int4* p = reinterpret_cast<const int4*>(base);
  if constexpr (BF16) {
    const int4 r = __ldg(p + c);
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = vec_value<true>(r, e);
  } else {
    const int4 a = __ldg(p + 2 * c);
    const int4 b = __ldg(p + 2 * c + 1);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      v[e] = vec_value<false>(a, e);
      v[4 + e] = vec_value<false>(b, e);
    }
  }
}

// Values already of the dtype (a bf16 is the upper half of its f32).
template <bool BF16>
__device__ __forceinline__ void store_chunk(void* base, int64_t c,
                                            const float (&v)[kChunk]) {
  int4* p = reinterpret_cast<int4*>(base);
  unsigned w[kChunk];
#pragma unroll
  for (int e = 0; e < kChunk; ++e) w[e] = __float_as_uint(v[e]);
  if constexpr (BF16) {
    p[c] = make_int4(static_cast<int>((w[0] >> 16) | (w[1] & 0xffff0000u)),
                     static_cast<int>((w[2] >> 16) | (w[3] & 0xffff0000u)),
                     static_cast<int>((w[4] >> 16) | (w[5] & 0xffff0000u)),
                     static_cast<int>((w[6] >> 16) | (w[7] & 0xffff0000u)));
  } else {
    p[2 * c] = make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]),
                         static_cast<int>(w[2]), static_cast<int>(w[3]));
    p[2 * c + 1] = make_int4(static_cast<int>(w[4]), static_cast<int>(w[5]),
                             static_cast<int>(w[6]), static_cast<int>(w[7]));
  }
}

// x rounded to the dtype, to nearest even, as torch casts
template <bool BF16>
__device__ __forceinline__ float to_dtype(float x) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(x));
  } else {
    return x;
  }
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;\n" ::: "memory");
}

// Every block of the row's cluster (or the block, at K = 1) past this
// point sees the shared memory the others wrote before it.
__device__ __forceinline__ void row_sync(int K) {
  if (K > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
}

// Shared memory of a block's per-warp partials: a slot a warp, then
// zeros up to a multiple of 4 (read as float4).
constexpr int kSlots = 32 + 4;

// Once every warp of the block has stored its partial in `own` (its
// slots past the block's warps zero), the row's partials in warp order,
// zero-padded to a multiple of 4, as float4s: `own` itself at K = 1;
// else gathered into `all` from the row's blocks (warp w's in the block
// of rank w / warps a block, through distributed shared memory).
__device__ __forceinline__ const float4* row_partials(float* own, float* all,
                                                      int lanes, int K) {
  row_sync(K);
  if (K == 1) return reinterpret_cast<const float4*>(own);
  const int W = lanes >> 5, nwb = blockDim.x >> 5;
  const int w = threadIdx.x;
  if (w < ((W + 3) & ~3)) {
    all[w] = w < W ? cg::this_cluster().map_shared_rank(own, w / nwb)[w % nwb]
                   : 0.f;
  }
  __syncthreads();
  return reinterpret_cast<const float4*>(all);
}

// The quantizer on y, held by this lane as J chunks (chunk j is c0 + j *
// lanes; chunks past the row are zeros): per row (exchanging the warps'
// maxima over the row's blocks) or per group of gl lanes (a group lies in
// aligned gl consecutive lanes of one warp).  Stores y_q and y_s.
template <int J, bool GROUPED>
__device__ __forceinline__ void quantize_lanes(
    const float (&y)[J][kChunk], int64_t row, int c0, int lanes, int n_c,
    int D, int gl, int K, int8_t* __restrict__ yq, float* __restrict__ ys,
    float* wmax, float* gmax) {
  float s[J];
  if constexpr (GROUPED) {
#pragma unroll
    for (int j = 0; j < J; ++j) {
      float m = 0.f;
#pragma unroll
      for (int e = 0; e < kChunk; ++e) m = fmaxf(m, fabsf(y[j][e]));
      for (int off = 1; off < gl; off <<= 1) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      s[j] = fmaxf(m / 127.0f, 1e-8f);
      const int c = c0 + j * lanes;
      if (c < n_c && c % gl == 0) {
        ys[row * (n_c / gl) + c / gl] = s[j];
      }
    }
  } else {
    float m = 0.f;
#pragma unroll
    for (int j = 0; j < J; ++j) {
#pragma unroll
      for (int e = 0; e < kChunk; ++e) m = fmaxf(m, fabsf(y[j][e]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
    }
    if ((threadIdx.x & 31) == 0) wmax[threadIdx.x >> 5] = m;
    const float4* all = row_partials(wmax, gmax, lanes, K);
    m = 0.f;
    for (int q = 0; q < ((lanes >> 5) + 3) / 4; ++q) {
      const float4 v = all[q];
      m = fmaxf(fmaxf(m, v.x), fmaxf(fmaxf(v.y, v.z), v.w));
    }
    const float sr = fmaxf(m / 127.0f, 1e-8f);
#pragma unroll
    for (int j = 0; j < J; ++j) s[j] = sr;
    if (c0 == 0) ys[row] = sr;
  }
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = c0 + j * lanes;
    if (c >= n_c) continue;
    float v[kChunk];
#pragma unroll
    for (int e = 0; e < kChunk; ++e) v[e] = y[j][e] / s[j];
    *reinterpret_cast<int2*>(yq + row * D + static_cast<int64_t>(c) * kChunk) =
        make_int2(pack_int8x4(v[0], v[1], v[2], v[3]),
                  pack_int8x4(v[4], v[5], v[6], v[7]));
  }
}

struct NormArgs {
  const void* h;      // (M, D)
  const void* delta;  // (M, D) or null
  const void* scale;  // (D,)
  void* hout;         // (M, D): h + delta (unused without delta)
  int8_t* yq;         // (M, D)
  float* ys;          // (M, 1) or (M, D / gs)
  int D, lanes, K, gl;
  float eps;
};

// Grid (K, M): row blockIdx.y, its lanes over the K blocks of a cluster.
template <bool BF16, bool BF16S, int J, bool GROUPED>
__global__ void __launch_bounds__(1024)
    rms_norm_quant_int8_kernel(const __grid_constant__ NormArgs a) {
  __shared__ __align__(16) float wsum[kSlots];
  __shared__ __align__(16) float wmax[kSlots];
  __shared__ __align__(16) float gsum[kMaxWarps];
  __shared__ __align__(16) float gmax[kMaxWarps];
  if (threadIdx.x < 4) wsum[(blockDim.x >> 5) + threadIdx.x] = 0.f;
  if (threadIdx.x < 4) wmax[(blockDim.x >> 5) + threadIdx.x] = 0.f;
  const int64_t row = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;  // the lane
  const int n_c = a.D / kChunk;
  const int64_t off = row * a.D * (BF16 ? 2 : 4);
  const char* hrow = static_cast<const char*>(a.h) + off;
  const char* drow =
      a.delta ? static_cast<const char*>(a.delta) + off : nullptr;
  float x[J][kChunk], sc[J][kChunk];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = t + j * a.lanes;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) x[j][e] = sc[j][e] = 0.f;
    if (c >= n_c) continue;
    load_chunk<BF16>(hrow, c, x[j]);
    load_chunk<BF16S>(a.scale, c, sc[j]);
    if (drow) {
      float d[kChunk];
      load_chunk<BF16>(drow, c, d);
#pragma unroll
      for (int e = 0; e < kChunk; ++e) {
        x[j][e] = to_dtype<BF16>(__fadd_rn(x[j][e], d[e]));
      }
      store_chunk<BF16>(static_cast<char*>(a.hout) + off, c, x[j]);
    }
  }
  float acc = 0.f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      acc = __fadd_rn(acc, __fmul_rn(x[j][e], x[j][e]));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  }
  if ((threadIdx.x & 31) == 0) wsum[threadIdx.x >> 5] = acc;
  // the warps' sums in warp order, from 0 (+0 leaves a sum unchanged, so
  // neither the start nor the zero padding changes its bits)
  const float4* all = row_partials(wsum, gsum, a.lanes, a.K);
  float tot = 0.f;
  for (int q = 0; q < ((a.lanes >> 5) + 3) / 4; ++q) {
    const float4 v = all[q];
    tot = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(tot, v.x), v.y), v.z),
                    v.w);
  }
  const float r =
      rsqrtf(__fadd_rn(__fdiv_rn(tot, static_cast<float>(a.D)), a.eps));
  float y[J][kChunk];
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      y[j][e] = to_dtype<BF16>(__fmul_rn(__fmul_rn(x[j][e], r), sc[j][e]));
    }
  }
  quantize_lanes<J, GROUPED>(y, row, t, a.lanes, n_c, a.D, a.gl, a.K, a.yq,
                             a.ys, wmax, gmax);
  // no block leaves while another may still read its shared memory
  if (a.K > 1) row_sync(a.K);
}

struct SiluArgs {
  const void* gate;  // (M, D)
  const void* up;    // (M, D)
  int8_t* yq;
  float* ys;
  int D, lanes, K, gl;
};

template <bool BF16, int J, bool GROUPED>
__global__ void __launch_bounds__(1024)
    silu_mul_quant_int8_kernel(const __grid_constant__ SiluArgs a) {
  __shared__ __align__(16) float wmax[kSlots];
  __shared__ __align__(16) float gmax[kMaxWarps];
  if (threadIdx.x < 4) wmax[(blockDim.x >> 5) + threadIdx.x] = 0.f;
  const int64_t row = blockIdx.y;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_c = a.D / kChunk;
  const int64_t off = row * a.D * (BF16 ? 2 : 4);
  const char* grow = static_cast<const char*>(a.gate) + off;
  const char* urow = static_cast<const char*>(a.up) + off;
  float g[J][kChunk], u[J][kChunk];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const int c = t + j * a.lanes;
#pragma unroll
    for (int e = 0; e < kChunk; ++e) g[j][e] = u[j][e] = 0.f;
    if (c >= n_c) continue;
    load_chunk<BF16>(grow, c, g[j]);
    load_chunk<BF16>(urow, c, u[j]);
  }
  // silu as the plain version computes it (quant_matmul.py:silu): on
  // bf16 rows jax.nn.silu as XLA computes it, x * (1 / (1 + exp(-x)))
  // with every step rounded to bf16 (the negation is exact; exp is expf,
  // which torch.exp in the plain version runs on the card, never
  // __expf); on float32 rows torch's x / (1 + exp(-x)); then the product
  // with up rounded to the dtype
#pragma unroll
  for (int j = 0; j < J; ++j) {
#pragma unroll
    for (int e = 0; e < kChunk; ++e) {
      float sg;
      if constexpr (BF16) {
        const float ex = to_dtype<BF16>(expf(-g[j][e]));
        const float den = to_dtype<BF16>(__fadd_rn(1.0f, ex));
        const float sig = to_dtype<BF16>(__fdiv_rn(1.0f, den));
        sg = to_dtype<BF16>(__fmul_rn(g[j][e], sig));
      } else {
        sg = __fdiv_rn(g[j][e], __fadd_rn(1.0f, expf(-g[j][e])));
      }
      g[j][e] = to_dtype<BF16>(__fmul_rn(sg, u[j][e]));
    }
  }
  quantize_lanes<J, GROUPED>(g, row, t, a.lanes, a.D / kChunk, a.D, a.gl,
                             a.K, a.yq, a.ys, wmax, gmax);
  if (a.K > 1) row_sync(a.K);
}

__global__ void empty_cluster_kernel(char) {}

template <typename Kernel, typename Args>
int launch_rows(Kernel kernel, const Args& a, int M, int K, int threads,
                cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(K, M);
  cfg.blockDim = dim3(threads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = K;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = K > 1 ? 1 : 0;
  int err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, a));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// lanes (a multiple of 32, at most 32 * kMaxWarps) over K blocks of at
// most 1024 threads, K in 1..8 dividing the row's warps; J in 1, 2, 4;
// gl a power of two up to 32 (grouped) or 0 (per row)
bool valid_plan(int D, int lanes, int J, int K, int gl) {
  const int W = lanes / 32;
  return D % kChunk == 0 && lanes % 32 == 0 && W >= 1 && W <= kMaxWarps &&
         K >= 1 && K <= 8 && W % K == 0 && lanes / K <= 1024 &&
         (J == 1 || J == 2 || J == 4) &&
         static_cast<int64_t>(lanes) * J * kChunk >= D &&
         (gl == 0 || (gl <= 32 && (gl & (gl - 1)) == 0 &&
                      (D / kChunk) % gl == 0));
}

}  // namespace

extern "C" {

// gs == D: one scale a row; else a group of gs values (gs / 8 lanes).
// lanes and J come from the wrapper's norm_lanes(D), K from its plan
// (kernels/quant_matmul.py:norm_quant_plan).  Returns the cudaError_t of
// the launch (0 = success).
int rms_norm_quant_int8(const void* h, const void* delta, const void* scale,
                        void* hout, void* yq, void* ys, int x_bf16,
                        int s_bf16, int M, int D, float eps, int gs,
                        int lanes, int J, int K, void* stream) {
  if (M == 0) return 0;
  const int gl = gs == D ? 0 : gs / kChunk;
  if (gs < kChunk || gs % kChunk || D % gs ||
      !valid_plan(D, lanes, J, K, gl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  NormArgs a{h,  delta, scale, hout, static_cast<int8_t*>(yq),
             static_cast<float*>(ys), D, lanes, K, gl, eps};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = lanes / K;
#define NQ_LAUNCH(XB, SB, J_, G_)                                          \
  return launch_rows(rms_norm_quant_int8_kernel<XB, SB, J_, G_>, a, M, K,     \
                     threads, st)
#define NQ_J(XB, SB, G_)                    \
  switch (J) {                              \
    case 1: NQ_LAUNCH(XB, SB, 1, G_);       \
    case 2: NQ_LAUNCH(XB, SB, 2, G_);       \
    default: NQ_LAUNCH(XB, SB, 4, G_);      \
  }
#define NQ_G(XB, SB)          \
  if (gl) {                   \
    NQ_J(XB, SB, true)        \
  } else {                    \
    NQ_J(XB, SB, false)       \
  }
  if (x_bf16) {
    if (s_bf16) {
      NQ_G(true, true)
    } else {
      NQ_G(true, false)
    }
  } else {
    if (s_bf16) {
      NQ_G(false, true)
    } else {
      NQ_G(false, false)
    }
  }
#undef NQ_G
#undef NQ_J
#undef NQ_LAUNCH
}

int silu_mul_quant_int8(const void* gate, const void* up, void* yq, void* ys,
                        int bf16, int M, int D, int gs, int lanes, int J,
                        int K, void* stream) {
  if (M == 0) return 0;
  const int gl = gs == D ? 0 : gs / kChunk;
  if (gs < kChunk || gs % kChunk || D % gs ||
      !valid_plan(D, lanes, J, K, gl)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SiluArgs a{gate, up, static_cast<int8_t*>(yq), static_cast<float*>(ys),
             D, lanes, K, gl};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = lanes / K;
#define SQ_LAUNCH(B_, J_, G_) \
  return launch_rows(silu_mul_quant_int8_kernel<B_, J_, G_>, a, M, K, threads, st)
#define SQ_J(B_, G_)                 \
  switch (J) {                       \
    case 1: SQ_LAUNCH(B_, 1, G_);    \
    case 2: SQ_LAUNCH(B_, 2, G_);    \
    default: SQ_LAUNCH(B_, 4, G_);   \
  }
#define SQ_G(B_)         \
  if (gl) {              \
    SQ_J(B_, true)       \
  } else {               \
    SQ_J(B_, false)      \
  }
  if (bf16) {
    SQ_G(true)
  } else {
    SQ_G(false)
  }
#undef SQ_G
#undef SQ_J
#undef SQ_LAUNCH
}

// An empty kernel of the fused kernels' geometry (K-block clusters over M
// rows): the launch floor their times are read against.
int empty_cluster_launch(int K, int M, int threads, void* stream) {
  char unused = 0;
  return launch_rows(empty_cluster_kernel, unused, M, K, threads,
                     static_cast<cudaStream_t>(stream));
}

}  // extern "C"
