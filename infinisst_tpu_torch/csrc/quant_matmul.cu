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
//
// The grouped pair (group_quant_int8, w8a8_grouped_gemm) is in
// grouped_matmul.cu; the helpers both files use, in quant_common.cuh.
//
// What bounds them on the H100: at the main path's M (4 beam rows, 61/79
// prefill rows) the GEMMs are bound by streaming the int8 weight from
// device memory (D*O bytes against 2*M*D*O operations, far below the
// ~590 int8 or ~295 bf16 operations per byte where the tensor cores would
// bind).  row_quant_int8 reads M*D activations and writes M*D bytes, a
// few microseconds of work: at M = 4 a launch costs more than the bytes,
// so it is bound by latency (the launch, one round trip to memory, one
// reduction).
//
// w8a8_gemm and w8_bf16_gemm (both redesigned for Hopper) read their
// weight K-major, (O, D) int8, packed once where the leaves are made
// (models/quant.py:pack_kmajor), so that each output channel's D bytes
// are contiguous: tensor-core A operands are K-major.  Swap AB: the
// weight is the 16-row A operand of mma.sync (m16n8k32 s8 x s8 -> s32,
// or m16n8k16 bf16 x bf16 -> f32 on weight bytes widened to bf16 in
// registers, which is exact) and the activation rows are its 8-wide N
// side, so one block tile holds all M <= 80 rows of a call and the
// weight crosses device memory once per call at M in {1, 4, 61, 79}.
// A block owns 128 output channels (4 warps x two m16 tiles) and one
// contiguous K range; a 4-stage cp.async ring (16 bytes a thread) streams
// 128-byte-deep weight tiles (whole L2 lines) and the matching activation
// tiles through shared memory.  In each 64 bytes of a weight stage each
// thread reads 16 contiguous bytes of a row and feeds them to two int8
// MMAs or four bf16 MMAs; A and B take the same byte-to-k assignment (a
// permutation of k inside each MMA, which an integer sum does not see
// and an f32 sum sees only as another order).  Narrow O gets split-K
// across blocks (host plans: about two blocks per SM at M <= 16); each
// block stores its partial (plain stores, no zeroed workspace) and the
// last block of an output tile, found with an atomic counter that it
// resets, sums the partials in split order and applies the epilogue:
// (f32(acc) * ys[m]) * s[o], bitwise that of the plain version, or
// acc * s[o], which differs from the plain version only by the order of
// the f32 sums (and is the same from run to run).

#include "quant_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// row_quant_int8 (one pass): s = max(amax / 127, 1e-8);
// q = clamp(rint(y / s), -127, 127).  Divides (no reciprocal) and rounds
// half to even, as jnp.round does, so the result is bitwise that of the
// plain version.  Each thread loads VPT 16-byte vectors of the row (8 bf16
// or 4 f32 values each; vector i of thread t is i * blockDim + t) into
// registers, all loads in flight at once, and the row never crosses memory
// again.  The row's max: |y| as bit patterns, whose unsigned order is that
// of non-negative floats (one AND and one integer max per word), a warp
// shuffle, then one exchange through shared memory after which every
// thread folds the warps' maxima itself (one barrier).  The quantization,
// one IEEE division per value, is the kernel's largest cost after the
// latency, so a row is shared by VPT blocks at every M: each loads the
// whole row for the max (from L2 but for the first), and block c
// quantizes vector c of each thread.  No block waits for another.  Each
// thread stores 8 (bf16) or 4 (f32) int8 values at a time.  Requires
// D % (16 / sizeof(elem)) == 0 and 16-byte aligned rows (checked by the
// wrapper).

// Grid (VPT, M): block (c, row).
template <int VPT, bool BF16>
__global__ void row_quant_int8_kernel(const void* __restrict__ y,
                                      int8_t* __restrict__ yq,
                                      float* __restrict__ ys, int D) {
  constexpr int kElems = BF16 ? 8 : 4;  // values per 16-byte vector
  const int n_vec = D / kElems;
  const int c = blockIdx.x;
  const int64_t row = blockIdx.y;
  const int4* src = reinterpret_cast<const int4*>(
      static_cast<const char*>(y) + row * D * (BF16 ? 2 : 4));
  int4 raw[VPT];
  unsigned m = 0;  // max |y| as a bit pattern (bf16: one per half word)
#pragma unroll
  for (int i = 0; i < VPT; ++i) {
    const int idx = i * blockDim.x + threadIdx.x;
    raw[i] = idx < n_vec ? __ldg(src + idx) : make_int4(0, 0, 0, 0);
    const unsigned w[4] = {
        static_cast<unsigned>(raw[i].x), static_cast<unsigned>(raw[i].y),
        static_cast<unsigned>(raw[i].z), static_cast<unsigned>(raw[i].w)};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      m = BF16 ? __vmaxu2(m, w[j] & 0x7fff7fffu)
               : max(m, w[j] & 0x7fffffffu);
    }
  }
  if (BF16) m = max(m & 0xffffu, m >> 16) << 16;  // as the f32's pattern
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  __shared__ unsigned warp_max[32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  for (int w = 0; w < (blockDim.x + 31) >> 5; ++w) m = max(m, warp_max[w]);
  const float s = fmaxf(__uint_as_float(m) / 127.0f, 1e-8f);
#pragma unroll
  for (int i = 0; i < VPT; ++i) {  // unrolled: raw[] stays in registers
    const int idx = i * blockDim.x + threadIdx.x;
    if (i != c || idx >= n_vec) continue;
    int8_t* dst = yq + row * D + (int64_t)idx * kElems;
    float v[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) v[e] = vec_value<BF16>(raw[i], e) / s;
    if constexpr (BF16) {
      *reinterpret_cast<int2*>(dst) =
          make_int2(pack_int8x4(v[0], v[1], v[2], v[3]),
                    pack_int8x4(v[4], v[5], v[6], v[7]));
    } else {
      *reinterpret_cast<int*>(dst) = pack_int8x4(v[0], v[1], v[2], v[3]);
    }
  }
  if (c == 0 && threadIdx.x == 0) ys[row] = s;
}

// The launch floor: a kernel that does nothing, timed with the same
// launch geometry as the kernel it is held against.
__global__ void empty_kernel() {}

// ---------------------------------------------------------------------------
// w8a8_gemm: out[m, o] = (f32(sum_k yq[m,k] * wt[o,k]) * ys[m]) * s[o], with
// the weight K-major (O, D).  int8 x int8 products accumulate exactly in
// int32 on the tensor cores (mma.sync m16n8k32).  Requires D % 16 == 0
// (checked by the wrapper); ragged M and O edges are zero-filled and masked.

// Split-K across blocks.  Every block stores its partial sums (plain
// stores into ws: one T per (tile, split, register, thread)); the last
// block of an output tile, found with an atomic counter that it resets to
// zero, loads every split's partial of the registers each thread owns and
// sums them in split order, so the result does not depend on which block
// finished last.  Returns true in that block (acc then holds the sums),
// false in the others, which are done.
template <typename T, int MT, int NT>
__device__ __forceinline__ bool reduce_splits(T (&acc)[MT][NT][4],
                                              T* __restrict__ ws,
                                              int* __restrict__ counters,
                                              int tile, int split,
                                              int n_split) {
  constexpr int kRegs = MT * NT * 4;
  __shared__ int is_last;
  const int tid = threadIdx.x;
  T* part = ws + ((int64_t)tile * n_split + split) * kRegs * tc::kThreads;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        part[((i * NT + j) * 4 + e) * tc::kThreads + tid] = acc[i][j][e];
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == n_split - 1;
  __syncthreads();
  if (!is_last) return false;
  __threadfence();
  const T* base = ws + (int64_t)tile * n_split * kRegs * tc::kThreads;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;
  for (int sp = 0; sp < n_split; ++sp) {
    const T* p = base + (int64_t)sp * kRegs * tc::kThreads;
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] += __ldcg(p + ((i * NT + j) * 4 + e) * tc::kThreads +
                                 tid);
  }
  if (tid == 0) counters[tile] = 0;
  return true;
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
  constexpr int kChunks = tc::kTK / 16;          // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem[];

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

  // int32 partials: the same bits in any order
  if (n_split > 1 && !reduce_splits(acc, ws, counters,
                                    blockIdx.z * gridDim.x + ot, split,
                                    n_split)) {
    return;
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
// w8_bf16_gemm: out[m, o] = (sum_k bf16(y[m,k]) * bf16(wt[o,k])) * s[o],
// f32 accumulation, cast to the output dtype, with the weight K-major
// (O, D).  The activation comes in rounded to bf16, as _qmm_kernel rounds
// it; an int8 weight is exact in bf16 (|w| <= 128 < 2^8), and each
// bf16 x bf16 product is exact in the tensor cores' f32 sums, so only the
// order of the f32 sums differs from the plain version.  Tensor cores:
// mma.sync m16n8k16 (bf16 x bf16 -> f32), the weight as the 16-row A side
// (widened in registers), the activation rows as the 8-wide N side.  The
// tiles, the ring and split-K are w8a8_gemm's; a stage holds 128 bytes of
// each weight row and the matching 128 bf16 (256 bytes) of each
// activation row.  Requires D % 16 == 0 (checked by the wrapper).

// Byte offset of 16-byte chunk c of activation row r in a stage of
// 256-byte rows.  Odd rows swap neighbouring chunks, so the 8 lanes of a
// quarter warp (rows g, g + 1, chunks 2t or 2t + 1) read 8 distinct bank
// groups.
__device__ __forceinline__ int ychunk_at(int r, int c) {
  return r * 2 * tc::kTK + ((c ^ (r & 1)) << 4);
}

// The 4 int8 of w (bytes 0..3) as two bf16 pairs, exactly: lo = (b0, b1),
// hi = (b2, b3), the first of each pair in the low half.  Each byte,
// biased by 128, becomes the low mantissa byte of 2^23 + u; subtracting
// 2^23 + 128 leaves the integer in f32, whose upper half is its bf16.
__device__ __forceinline__ void int8x4_to_bf16x2(int w, unsigned& lo,
                                                 unsigned& hi) {
  const unsigned u = static_cast<unsigned>(w) ^ 0x80808080u;
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 | i)) -
           8388736.f;
  }
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Grid and workspace as w8a8_gemm_tc_kernel's (ws holds f32 partials).
template <int NT>
__global__ void __launch_bounds__(tc::kThreads)
w8_bf16_gemm_tc_kernel(const __nv_bfloat16* __restrict__ y,
                       const int8_t* __restrict__ wt,
                       const float* __restrict__ s, void* __restrict__ out,
                       int out_bf16, int M, int D, int O, int k_split,
                       int prefetch, float* __restrict__ ws,
                       int* __restrict__ counters) {
  constexpr int kRows = NT * 8;
  constexpr int kWBytes = tc::kTO * tc::kTK;
  constexpr int kYRow = 2 * tc::kTK;  // activation bytes per row and stage
  constexpr int kStageBytes = kWBytes + kRows * kYRow;
  constexpr int kChunks = tc::kTK / 16;
  constexpr int kYChunks = kYRow / 16;
  extern __shared__ __align__(16) unsigned char smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ot = blockIdx.x, split = blockIdx.y;
  const int n_split = gridDim.y;
  const int o0 = ot * tc::kTO, m0 = blockIdx.z * kRows;
  const int k0 = split * k_split;
  const int k1 = min(D, k0 + k_split);
  const int n_k = (k1 - k0 + tc::kTK - 1) / tc::kTK;

  // one stage: kTO weight rows of kTK bytes and kRows activation rows of
  // kTK bf16, in 16-byte chunks; chunks past O, M or the split's end are
  // zero-filled
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
    for (int i = tid; i < kRows * kYChunks; i += tc::kThreads) {
      const int r = i / kYChunks, c = i % kYChunks;
      const int m = m0 + r, k = kb + c * 8;
      const bool ok = m < M && k < k1;
      cp_async16(at + ychunk_at(r, c), ok ? y + (int64_t)m * D + k : y, ok);
    }
  };

  float acc[tc::kMTiles][NT][4];
#pragma unroll
  for (int i = 0; i < tc::kMTiles; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

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
    // in each 64-byte half of the weight rows, thread (g, t) takes bytes
    // [16t, 16t + 16) of its rows and elements [16t, 16t + 16) of its
    // activation row: word j of each (4 k values) feeds MMA j, its k
    // slots 2t, 2t + 1, 2t + 8, 2t + 9 in byte order
#pragma unroll
    for (int h = 0; h < tc::kTK / 64; ++h) {
      unsigned a[tc::kMTiles][4][4];  // [m16 tile][MMA][register]
#pragma unroll
      for (int i = 0; i < tc::kMTiles; ++i) {
        const int r = warp * tc::kWarpO + i * 16 + g;
        const int4 lo = *reinterpret_cast<const int4*>(
            st + chunk_at(r, h * 4 + t));
        const int4 hi = *reinterpret_cast<const int4*>(
            st + chunk_at(r + 8, h * 4 + t));
        const int wl[4] = {lo.x, lo.y, lo.z, lo.w};
        const int wh[4] = {hi.x, hi.y, hi.z, hi.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int8x4_to_bf16x2(wl[j], a[i][j][0], a[i][j][2]);
          int8x4_to_bf16x2(wh[j], a[i][j][1], a[i][j][3]);
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int r = n * 8 + g;
        const uint4 b0 = *reinterpret_cast<const uint4*>(
            at + ychunk_at(r, h * 8 + 2 * t));
        const uint4 b1 = *reinterpret_cast<const uint4*>(
            at + ychunk_at(r, h * 8 + 2 * t + 1));
        const unsigned bw[8] = {b0.x, b0.y, b0.z, b0.w,
                                b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int i = 0; i < tc::kMTiles; ++i)
            mma_bf16(acc[i][n], a[i][j], bw[2 * j], bw[2 * j + 1]);
      }
    }
  }
  cp_async_wait<0>();

  if (n_split > 1 && !reduce_splits(acc, ws, counters,
                                    blockIdx.z * gridDim.x + ot, split,
                                    n_split)) {
    return;
  }

  // epilogue: c0, c1 -> channel g, rows 2t, 2t + 1; c2, c3 -> channel g + 8
#pragma unroll
  for (int i = 0; i < tc::kMTiles; ++i) {
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + warp * tc::kWarpO + i * 16 + g + (e >> 1) * 8;
        const int m = m0 + n * 8 + 2 * t + (e & 1);
        if (o < O && m < M) {
          store_out(out, out_bf16, (int64_t)m * O + o,
                    __fmul_rn(acc[i][n][e], s[o]));
        }
      }
    }
  }
}

template <int NT>
int launch_w8a8(const void* yq, const void* ys, const void* wt,
                const void* s, void* out, int out_bf16, int M, int D, int O,
                int k_split, int n_split, void* ws, void* counters,
                cudaStream_t stream) {
  const size_t smem = (size_t)tc::kStages * (tc::kTO + NT * 8) * tc::kTK;
  static bool smem_set = false;
  int err = set_smem_once(w8a8_gemm_tc_kernel<NT>, smem, smem_set);
  if (err) return err;
  const TcGrid g(NT, M, O, k_split, n_split);
  w8a8_gemm_tc_kernel<NT><<<g.grid, tc::kThreads, smem, stream>>>(
      static_cast<const int8_t*>(yq), static_cast<const float*>(ys),
      static_cast<const int8_t*>(wt), static_cast<const float*>(s), out,
      out_bf16, M, D, O, k_split, g.prefetch, static_cast<int*>(ws),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <int NT>
int launch_w8_bf16(const void* y, const void* wt, const void* s, void* out,
                   int out_bf16, int M, int D, int O, int k_split,
                   int n_split, void* ws, void* counters,
                   cudaStream_t stream) {
  const size_t smem =
      (size_t)tc::kStages * (tc::kTO + NT * 8 * 2) * tc::kTK;
  static bool smem_set = false;
  int err = set_smem_once(w8_bf16_gemm_tc_kernel<NT>, smem, smem_set);
  if (err) return err;
  const TcGrid g(NT, M, O, k_split, n_split);
  w8_bf16_gemm_tc_kernel<NT><<<g.grid, tc::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(y), static_cast<const int8_t*>(wt),
      static_cast<const float*>(s), out, out_bf16, M, D, O, k_split,
      g.prefetch, static_cast<float*>(ws), static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

// A split-K plan the kernels take: whole stages per split, n_split of
// them covering D.
bool bad_plan(int D, int k_split, int n_split) {
  return k_split <= 0 || k_split % tc::kTK ||
         n_split != (D + k_split - 1) / k_split;
}

template <int VPT>
int launch_row_quant(const void* y, int y_bf16, void* yq, void* ys, int M,
                     int D, int threads, cudaStream_t stream) {
  const dim3 grid(VPT, M);
  if (y_bf16) {
    row_quant_int8_kernel<VPT, true><<<grid, threads, 0, stream>>>(
        y, static_cast<int8_t*>(yq), static_cast<float*>(ys), D);
  } else {
    row_quant_int8_kernel<VPT, false><<<grid, threads, 0, stream>>>(
        y, static_cast<int8_t*>(yq), static_cast<float*>(ys), D);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launch (0 = success).

// vpt (16-byte vectors a thread holds, and blocks per row: 1, 2, 4, 8 or
// 16) and threads come from the wrapper's plan
// (kernels/quant_matmul.py:row_quant_plan); threads * vpt vectors must
// cover the row.
int row_quant_int8(const void* y, int y_bf16, void* yq, void* ys, int M,
                   int D, int vpt, int threads, void* stream) {
  if (M == 0) return 0;
  const int64_t n_vec = D / (y_bf16 ? 8 : 4);
  if (threads < 1 || threads > 1024 || (int64_t)threads * vpt < n_vec) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define ROW_QUANT_LAUNCH(VPT_)                                              \
  launch_row_quant<VPT_>(y, y_bf16, yq, ys, M, D, threads, st)
  switch (vpt) {
    case 1: return ROW_QUANT_LAUNCH(1);
    case 2: return ROW_QUANT_LAUNCH(2);
    case 4: return ROW_QUANT_LAUNCH(4);
    case 8: return ROW_QUANT_LAUNCH(8);
    case 16: return ROW_QUANT_LAUNCH(16);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef ROW_QUANT_LAUNCH
}

// An empty kernel with the given geometry: the launch floor that the
// small kernels' times are read against.
int empty_kernel_launch(int blocks, int threads, void* stream) {
  empty_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int gemm_tile_o() { return tc::kTO; }

int gemm_tile_k() { return tc::kTK; }

// wt is K-major (O, D).  rows (activation rows per block: 8, 16, 32, 64 or
// 80), k_split and n_split come from the wrapper's plan
// (kernels/quant_matmul.py:gemm_plan); ws and counters are used only when
// n_split > 1.
#define TC_GEMM_DISPATCH(LAUNCH)                                            \
  switch (rows) {                                                           \
    case 8: return LAUNCH(1);                                               \
    case 16: return LAUNCH(2);                                              \
    case 32: return LAUNCH(4);                                              \
    case 64: return LAUNCH(8);                                              \
    case 80: return LAUNCH(10);                                             \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }

int w8a8_gemm(const void* yq, const void* ys, const void* wt, const void* s,
              void* out, int out_bf16, int M, int D, int O, int rows,
              int k_split, int n_split, void* ws, void* counters,
              void* stream) {
  if (M == 0 || O == 0) return 0;
  if (bad_plan(D, k_split, n_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define W8A8_LAUNCH(NT_)                                                   \
  launch_w8a8<NT_>(yq, ys, wt, s, out, out_bf16, M, D, O, k_split,         \
                   n_split, ws, counters, st)
  TC_GEMM_DISPATCH(W8A8_LAUNCH)
#undef W8A8_LAUNCH
}

// y is bf16 (M, D); the output is bf16 or float32.  The rest as w8a8_gemm
// (ws holds float32 partials).
int w8_bf16_gemm(const void* y, const void* wt, const void* s, void* out,
                 int out_bf16, int M, int D, int O, int rows, int k_split,
                 int n_split, void* ws, void* counters, void* stream) {
  if (M == 0 || O == 0) return 0;
  if (bad_plan(D, k_split, n_split)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define W8_BF16_LAUNCH(NT_)                                                \
  launch_w8_bf16<NT_>(y, wt, s, out, out_bf16, M, D, O, k_split, n_split,  \
                      ws, counters, st)
  TC_GEMM_DISPATCH(W8_BF16_LAUNCH)
#undef W8_BF16_LAUNCH
}

#undef TC_GEMM_DISPATCH

}  // extern "C"
