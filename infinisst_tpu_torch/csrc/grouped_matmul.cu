// Hand-written Hopper (sm_90a) ports of the grouped int8 Pallas kernels in
// infinisst_tpu/kernels/quant_matmul.py, the --group128 layout.  Plain C
// interface, bound with ctypes from infinisst_tpu_torch/kernels/
// quant_matmul.py; no PyTorch headers.  Built apart from quant_matmul.cu
// (the two build in parallel); shared helpers in quant_common.cuh.
//
//   group_quant_int8   <- quantize_activation_grouped (quant_matmul.py:226)
//   w8a8_grouped_gemm  <- _qmm_i8_grouped_kernel (quant_matmul.py:191), the
//                         body of quantized_matmul_w8a8_grouped (:239)
//
// What bounds them on the H100: the GEMM, like w8a8_gemm, by streaming
// the int8 weight (and its (G, O) float32 scales, 3 % more bytes at
// gs = 128) from device memory at the main path's M; group_quant_int8,
// like row_quant_int8, by the launch and one round trip to memory.
//
// w8a8_grouped_gemm (redesigned for Hopper) reads the same K-major (O, D)
// weight on the int8 mma.sync tiles, cp.async ring and split-K counters
// of quant_common.cuh (the design w8a8_gemm had before its wgmma
// redesign), in blocks of 64 or 128 channels.  The fold is one chain per
// output over the groups, o = fma(f32(acc_g) * ys[m, g], s[g, o], o) in
// g order, so the int32 sums are folded (in registers) and reset after
// the MMAs of each group; the scales of the groups that end in a stage
// ride with it through the ring.  Groups of whole stages (gs = 128) take that design's reads and k
// order, and, where registers allow, a second accumulator set: group g's
// fold runs while group g + 1's MMAs do.  Other group sizes (multiples of
// 32) take one contiguous 32-byte run of D per k32 MMA (8-byte reads) so
// that no MMA mixes two groups, and fold where a group ends.  Split-K
// keeps the one chain: each split parks its groups' products f32(acc) *
// ys in a workspace, and the last block of a tile stages them through
// shared memory and folds all G in g order; the host plan splits only
// grids short of a wave and only where that workspace stays within an
// eighth of the weight bytes.  Each thread's copy addresses are computed
// once, and the groups are counted forward, not divided out, per stage.
// group_quant_int8 (redesigned) is row_quant_int8's design at group
// granularity: a group is held in the registers of a few lanes (a
// 128-value bf16 group is 16 lanes x 16 bytes), its max is shuffled
// among them, and it is read once.
// Both take a simple route (one thread a group, or a (row, channel)
// output) for the shapes those designs do not: groups that are not whole
// 16-byte vectors, group sizes not a multiple of 32, O not a multiple of
// 4.  The wrapper picks the route from the shapes.

#include "quant_common.cuh"

namespace {

// ---------------------------------------------------------------------------
// group_quant_int8 (one pass): per (row, group) of gs values,
// s = max(amax / 127, 1e-8); q = clamp(rint(y / s), -127, 127), as
// quantize_activation_grouped computes it (IEEE division, half to even),
// so the result is bitwise that of the plain version.  Groups are laid
// end to end (D = G * gs), so group i = m * G + g starts at value i * gs
// and its scale is ys[i].  Each group is held by `lanes` lanes of a warp
// (a power of two up to 32), each with `per` <= VPL 16-byte vectors of it
// (vector v * lanes + l of the group in lane l: the lanes' loads are
// contiguous), all loads in flight at once; |y|'s max as an integer max of
// bit patterns, shuffled among the group's lanes; each lane stores 8
// (bf16) or 4 (f32) int8 values a vector and the group's first lane its
// scale.  Requires gs * sizeof(elem) % 16 == 0 and 16-byte aligned rows
// (checked by the wrapper).

template <int VPL, bool BF16>
__global__ void group_quant_int8_kernel(const void* __restrict__ y,
                                        int8_t* __restrict__ yq,
                                        float* __restrict__ ys,
                                        int64_t n_groups, int gs,
                                        int lanes_log2) {
  constexpr int kElems = BF16 ? 8 : 4;  // values per 16-byte vector
  const int lanes = 1 << lanes_log2;
  const int64_t gid =
      ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> lanes_log2;
  const int l = threadIdx.x & (lanes - 1);
  const int per = (gs / kElems) >> lanes_log2;
  const bool ok = gid < n_groups;  // no early exit: every lane shuffles
  const int4* src = reinterpret_cast<const int4*>(
      static_cast<const char*>(y) + gid * gs * (BF16 ? 2 : 4));
  int4 raw[VPL];
  unsigned m = 0;  // max |y| as a bit pattern (bf16: one per half word)
#pragma unroll
  for (int i = 0; i < VPL; ++i) {
    raw[i] = ok && i < per ? __ldg(src + i * lanes + l)
                           : make_int4(0, 0, 0, 0);
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
  for (int off = lanes >> 1; off > 0; off >>= 1) {
    m = max(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  if (!ok) return;
  const float s = fmaxf(__uint_as_float(m) / 127.0f, 1e-8f);
  int8_t* dst = yq + gid * gs;
#pragma unroll
  for (int i = 0; i < VPL; ++i) {  // unrolled: raw[] stays in registers
    if (i >= per) continue;
    const int idx = i * lanes + l;
    float v[kElems];
#pragma unroll
    for (int e = 0; e < kElems; ++e) v[e] = vec_value<BF16>(raw[i], e) / s;
    if constexpr (BF16) {
      *reinterpret_cast<int2*>(dst + idx * kElems) =
          make_int2(pack_int8x4(v[0], v[1], v[2], v[3]),
                    pack_int8x4(v[4], v[5], v[6], v[7]));
    } else {
      *reinterpret_cast<int*>(dst + idx * kElems) =
          pack_int8x4(v[0], v[1], v[2], v[3]);
    }
  }
  if (l == 0) ys[gid] = s;
}

// ---------------------------------------------------------------------------
// w8a8_grouped_gemm: for g in order, o = fma(f32(acc_g[m, o]) * ys[m, g],
// s[g, o], o) in f32 from 0, then cast, with acc_g the exact int32 dot of
// group g (f32(acc_g) is exact for |acc_g| < 2^24, which gs = 128 keeps:
// 128 * 127^2; beyond, the conversion rounds to nearest as the plain
// version's does): the arithmetic of _qmm_i8_grouped_kernel's
// o += acc * ys * s as XLA compiles it (one fused multiply-add).
// __fmul_rn / __fmaf_rn pin the roundings.  The weight is K-major (O, D);
// the MMAs and the ring are quant_common.cuh's, with MT m16 tiles of
// channels per warp (a block owns 64 MT channels).  Requires gs % 32 == 0,
// O % 4 == 0 (checked by the wrapper and the launcher).

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// A stage row of 128 bytes as four 32-byte segments, one k32 MMA each;
// row r keeps segment j at j ^ (r & 3), so the 16 lanes of a half warp
// (rows g..g+3 of a tile, 8 bytes t of segment j) read 16 distinct bank
// pairs.  Byte offset of 16-byte chunk c (segment c / 2) of row r, and of
// 8-byte piece t of segment j of row r:
__device__ __forceinline__ int gchunk_at(int r, int c) {
  return r * tc::kTK + ((((c >> 1) ^ (r & 3)) << 5) | ((c & 1) << 4));
}

__device__ __forceinline__ int gpiece_at(int r, int j, int t) {
  return r * tc::kTK + (((j ^ (r & 3)) << 5) | (t << 3));
}

namespace grp {

constexpr int kMaxEnds = tc::kTK / 32;  // group ends a stage may hold
constexpr int kStages = 4;              // depth of the cp.async ring

// A block's tile: tc::kWarps warps, each with MT m16 tiles of channels
// and NT n8 tiles of rows
template <int MT, int NT>
struct Tile {
  static constexpr int kWarpO = 16 * MT;
  static constexpr int kTO = tc::kWarps * kWarpO;  // channels per block
  static constexpr int kRows = NT * 8;
  static constexpr int kWBytes = kTO * tc::kTK;
  static constexpr int kYBytes = kRows * tc::kTK;
  // room for a second accumulator set, to fold one group while the next
  // one's MMAs run
  static constexpr bool kPipe = MT * NT <= 4;
  // a stage: the weight and activation tiles, then the scales of the (at
  // most `ends` = ceil(kTK / gs)) groups that end inside it: s[g, o0:o0 +
  // kTO] and ys[m0:m0 + kRows, g]
  static __host__ __device__ int stage_bytes(int ends) {
    return kWBytes + kYBytes + ends * (kTO + kRows) * 4;
  }
};

}  // namespace grp

// The k32 MMA of 32-byte segment j of a stage (gchunk_at layout): thread
// (g, t) takes the 8 bytes at 8t of its rows, words x, y in k slots t*4..
// and 16 + t*4..
template <int MT, int NT>
__device__ __forceinline__ void grouped_seg(int (&acc)[MT][NT][4],
                                            const unsigned char* st,
                                            const unsigned char* at, int j,
                                            int warp, int g, int t) {
  int2 a[MT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
    const int r = warp * 16 * MT + i * 16 + g;
    a[i][0] = *reinterpret_cast<const int2*>(st + gpiece_at(r, j, t));
    a[i][1] = *reinterpret_cast<const int2*>(st + gpiece_at(r + 8, j, t));
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const int2 b =
        *reinterpret_cast<const int2*>(at + gpiece_at(n * 8 + g, j, t));
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      mma_s8(acc[i][n], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b.x, b.y);
    }
  }
}

// The MMAs of a whole stage that lies inside one group (chunk_at layout):
// the mma.sync design's 16-byte reads and k order (chunk_at).
template <int MT, int NT>
__device__ __forceinline__ void grouped_stage16(int (&acc)[MT][NT][4],
                                                const unsigned char* st,
                                                const unsigned char* at,
                                                int warp, int g, int t) {
#pragma unroll
  for (int h = 0; h < tc::kTK / 64; ++h) {
    const int c = h * 4 + t;
    int4 a[MT][2];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      const int r = warp * 16 * MT + i * 16 + g;
      a[i][0] = *reinterpret_cast<const int4*>(st + chunk_at(r, c));
      a[i][1] = *reinterpret_cast<const int4*>(st + chunk_at(r + 8, c));
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int4 b =
          *reinterpret_cast<const int4*>(at + chunk_at(n * 8 + g, c));
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        mma_s8(acc[i][n], a[i][0].x, a[i][1].x, a[i][0].y, a[i][1].y, b.x,
               b.y);
        mma_s8(acc[i][n], a[i][0].z, a[i][1].z, a[i][0].w, a[i][1].w, b.z,
               b.w);
      }
    }
  }
}

// A group's scales as the thread needs them: ys of its rows 2t, 2t + 1 of
// each n8 tile, s of its channels g, g + 8 of each m16 tile.
template <int MT, int NT>
__device__ __forceinline__ void grouped_scales(float (&yv)[NT][2],
                                               float (&sv)[MT][2],
                                               const float* ss,
                                               const float* yss, int warp,
                                               int g, int t) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) yv[n][e] = yss[n * 8 + 2 * t + e];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      sv[i][h] = ss[warp * 16 * MT + i * 16 + g + h * 8];
    }
}

// Group gi has ended: p = f32(acc) * ys[m, gi] for each of the thread's
// registers (c0, c1 -> channel g, rows 2t, 2t + 1; c2, c3 -> channel
// g + 8), folded as res = fma(p, s[gi, o], res) or, split, parked in the
// group's (kRows, kTO) slab of the workspace (valid rows only); then the
// accumulators restart.
template <int MT, int NT>
__device__ __forceinline__ void grouped_fold(int (&acc)[MT][NT][4],
                                             float (&res)[MT][NT][4],
                                             const float (&yv)[NT][2],
                                             const float (&sv)[MT][2],
                                             float* __restrict__ ws_g,
                                             int valid, int warp, int g,
                                             int t) {
  using T = grp::Tile<MT, NT>;
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p =
            __fmul_rn(static_cast<float>(acc[i][n][e]), yv[n][e & 1]);
        const int ml = n * 8 + 2 * t + (e & 1);
        if (ws_g == nullptr) {
          res[i][n][e] = __fmaf_rn(p, sv[i][e >> 1], res[i][n][e]);
        } else if (ml < valid) {
          ws_g[ml * T::kTO + warp * T::kWarpO + i * 16 + g + (e >> 1) * 8] =
              p;
        }
        acc[i][n][e] = 0;
      }
}

// Grid: x = output tile of kTO channels, y = split of D (k_split values,
// whole groups), z = tile of NT * 8 activation rows.  ws (split-K only):
// one f32 product per (tile, group, row, channel), written for valid rows
// only; counters: one per tile, zero on entry and on exit.
template <int MT, int NT>
__global__ void __launch_bounds__(tc::kThreads)
w8a8_grouped_gemm_tc_kernel(const int8_t* __restrict__ yq,
                            const float* __restrict__ ys,
                            const int8_t* __restrict__ wt,
                            const float* __restrict__ s,
                            void* __restrict__ out, int out_bf16, int M,
                            int D, int O, int G, int k_split, int prefetch,
                            float* __restrict__ ws,
                            int* __restrict__ counters) {
  using T = grp::Tile<MT, NT>;
  constexpr int kChunks = tc::kTK / 16;
  constexpr int kSegs = tc::kTK / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ot = blockIdx.x, split = blockIdx.y;
  const int n_split = gridDim.y;
  const int o0 = ot * T::kTO, m0 = blockIdx.z * T::kRows;
  const int tile = blockIdx.z * gridDim.x + ot;
  const int valid = min(T::kRows, M - m0);  // rows of the tile within M
  const int gs = D / G;
  const int ends = (tc::kTK + gs - 1) / gs;
  const int stage_bytes = T::stage_bytes(ends);
  // groups of whole stages: each stage ends at most one group, at its end
  const bool whole = gs % tc::kTK == 0;
  const int k0 = split * k_split;
  const int k1 = min(D, k0 + k_split);
  const int n_k = (k1 - k0 + tc::kTK - 1) / tc::kTK;
  float* ws_t = n_split > 1 ? ws + (int64_t)tile * G * T::kRows * T::kTO
                            : nullptr;

  // one stage: kTO weight rows and kRows activation rows of kTK bytes in
  // 16-byte chunks (past O, M or the split's end: zero-filled), then the
  // scales of the groups g_lo + q (q < n_ends) that end inside it.  Thread
  // tid copies chunk tid % kChunks of rows tid / kChunks + q * kStep: its
  // addresses move by a constant from one q to the next (both layouts
  // keep a row's pattern over 4 rows) and from one stage to the next.
  constexpr int kStep = tc::kThreads / kChunks;
  constexpr int kWQ = T::kTO / kStep;  // weight chunks a thread
  constexpr int kAQ = (T::kRows + kStep - 1) / kStep;  // activation chunks
  const int lc = tid % kChunks, lr = tid / kChunks;
  const int dst0 = whole ? chunk_at(lr, lc) : gchunk_at(lr, lc);
  const int8_t* wsrc = wt + (int64_t)(o0 + lr) * D + lc * 16;
  const int8_t* asrc = yq + (int64_t)(m0 + lr) * D + lc * 16;
  const int w_rows = min(kWQ, (O - o0 - lr + kStep - 1) / kStep);
  const int a_rows = min(kAQ, (M - m0 - lr + kStep - 1) / kStep);
  int ld_g = k0 / gs;  // the next group whose scales the loader stages
  auto load_stage = [&](int slot, int kt) {
    unsigned char* st = smem + slot * stage_bytes;
    const int kb = k0 + kt * tc::kTK;
    const bool k_ok = kb + lc * 16 < k1;
#pragma unroll
    for (int q = 0; q < kWQ; ++q) {
      const bool ok = k_ok && q < w_rows;
      cp_async16(st + dst0 + q * kStep * tc::kTK,
                 ok ? wsrc + (int64_t)q * kStep * D + kb : wt, ok, prefetch);
    }
    unsigned char* at = st + T::kWBytes;
#pragma unroll
    for (int q = 0; q < kAQ; ++q) {
      if (lr + q * kStep >= T::kRows) break;
      const bool ok = k_ok && q < a_rows;
      cp_async16(at + dst0 + q * kStep * tc::kTK,
                 ok ? asrc + (int64_t)q * kStep * D + kb : yq, ok);
    }
    float* ss = reinterpret_cast<float*>(at + T::kYBytes);
    if (gs == tc::kTK) {  // group kb / kTK ends in this stage, alone
      const int gi = kb / tc::kTK;
      for (int c = tid; c < T::kTO / 4; c += tc::kThreads) {
        const bool ok = o0 + c * 4 < O;
        cp_async16(ss + c * 4, ok ? s + (int64_t)gi * O + o0 + c * 4 : s, ok);
      }
      for (int r = tid; r < T::kRows; r += tc::kThreads) {
        const bool ok = m0 + r < M;
        cp_async4(ss + T::kTO + r, ok ? ys + (int64_t)(m0 + r) * G + gi : ys,
                  ok);
      }
      return;
    }
    // the groups g_lo.. that end inside the stage (counted forward: the
    // stages are loaded in order, so no division a stage)
    const int g_lo = ld_g, k_end = min(kb + tc::kTK, k1);
    while ((ld_g + 1) * gs <= k_end) ++ld_g;
    const int n_ends = ld_g - g_lo;
    for (int i = tid; i < n_ends * (T::kTO / 4); i += tc::kThreads) {
      const int q = i / (T::kTO / 4), c = i % (T::kTO / 4);
      const int o = o0 + c * 4;
      const bool ok = o < O;
      cp_async16(ss + q * T::kTO + c * 4,
                 ok ? s + (int64_t)(g_lo + q) * O + o : s, ok);
    }
    float* yss = ss + ends * T::kTO;
    for (int i = tid; i < n_ends * T::kRows; i += tc::kThreads) {
      const int q = i / T::kRows, r = i % T::kRows;
      const int m = m0 + r;
      const bool ok = m < M;
      cp_async4(yss + q * T::kRows + r,
                ok ? ys + (int64_t)m * G + g_lo + q : ys, ok);
    }
  };

  int acc[MT][NT][4], acc2[MT][NT][4];
  float res[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[i][j][e] = acc2[i][j][e] = 0;
        res[i][j][e] = 0.f;
      }
  float yv[NT][2], sv[MT][2];  // the scales of the group being folded
  auto ws_of = [&](int gi) {
    return ws_t ? ws_t + (int64_t)gi * T::kRows * T::kTO : nullptr;
  };

#pragma unroll
  for (int p = 0; p < grp::kStages - 1; ++p) {
    if (p < n_k) load_stage(p, p);
    cp_async_commit();
  }
  // stage kt: wait for it, refill the slot freed by stage kt - 1, and
  // return its tiles and staged scales
  auto next_stage = [&](int kt, const unsigned char*& st,
                        const unsigned char*& at, const float*& ss,
                        const float*& yss) {
    cp_async_wait<grp::kStages - 2>();
    __syncthreads();  // stage kt landed; slot (kt - 1) % kStages is free
    if (kt + grp::kStages - 1 < n_k) {
      load_stage((kt + grp::kStages - 1) % grp::kStages,
                 kt + grp::kStages - 1);
    }
    cp_async_commit();
    st = smem + (kt % grp::kStages) * stage_bytes;
    at = st + T::kWBytes;
    ss = reinterpret_cast<const float*>(at + T::kYBytes);
    yss = ss + ends * T::kTO;
  };
  const unsigned char *st, *at;
  const float *ss, *yss;
  if (whole && gs == tc::kTK && T::kPipe) {
    // one group a stage: group kt0 + kt's MMAs run on one accumulator set
    // while the other set, group kt0 + kt - 1's, is folded (its scales
    // read into registers before its slot was refilled)
    const int kt0 = k0 / tc::kTK;
    auto step = [&](int kt, int (&cur)[MT][NT][4], int (&prev)[MT][NT][4]) {
      next_stage(kt, st, at, ss, yss);
      grouped_stage16(cur, st, at, warp, g, t);
      if (kt > 0) {
        grouped_fold(prev, res, yv, sv, ws_of(kt0 + kt - 1), valid, warp, g,
                     t);
      }
      grouped_scales(yv, sv, ss, yss, warp, g, t);
    };
    for (int kt = 0; kt < n_k; kt += 2) {
      step(kt, acc, acc2);
      if (kt + 1 < n_k) step(kt + 1, acc2, acc);
    }
    if (n_k & 1) {
      grouped_fold(acc, res, yv, sv, ws_of(kt0 + n_k - 1), valid, warp, g,
                   t);
    } else {
      grouped_fold(acc2, res, yv, sv, ws_of(kt0 + n_k - 1), valid, warp, g,
                   t);
    }
  } else {
    int c_g = k0 / gs;  // the next group to fold
    for (int kt = 0; kt < n_k; ++kt) {
      next_stage(kt, st, at, ss, yss);
      const int kb = k0 + kt * tc::kTK;
      if (whole) {  // one group's bytes: no branch between the MMAs
        grouped_stage16(acc, st, at, warp, g, t);
        if (kb + tc::kTK == (c_g + 1) * gs) {
          grouped_scales(yv, sv, ss, yss, warp, g, t);
          grouped_fold(acc, res, yv, sv, ws_of(c_g++), valid, warp, g, t);
        }
        continue;
      }
      int q = 0;  // the groups ended so far in this stage
#pragma unroll
      for (int j = 0; j < kSegs; ++j) {
        const int kk = kb + 32 * j;
        if (kk >= k1) break;
        grouped_seg(acc, st, at, j, warp, g, t);
        if (kk + 32 != (c_g + 1) * gs) continue;
        grouped_scales(yv, sv, ss + q * T::kTO, yss + q * T::kRows, warp, g,
                       t);
        grouped_fold(acc, res, yv, sv, ws_of(c_g++), valid, warp, g, t);
        ++q;
      }
    }
  }
  cp_async_wait<0>();

  if (n_split > 1) {
    // the last block of the tile folds every group's products in g order,
    // staging as many groups at a time as the ring holds: the products'
    // valid rows (padded by 4 floats a row: conflict-free reads) and s
    __threadfence();
    __syncthreads();
    if (tid == 0) is_last = atomicAdd(&counters[tile], 1) == n_split - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    constexpr int kRowF = T::kTO + 4;
    constexpr int kC = T::kTO / 4;  // 16-byte chunks a row
    const int grp_f = valid * kRowF + T::kTO;
    const int per = max(1, grp::kStages * stage_bytes / (4 * grp_f));
    float* sm = reinterpret_cast<float*>(smem);
    for (int g0 = 0; g0 < G; g0 += per) {
      const int n = min(per, G - g0);
      for (int i = tid; i < n * valid * kC; i += tc::kThreads) {
        const int c = i % kC, r = (i / kC) % valid, q = i / (kC * valid);
        cp_async16(sm + q * grp_f + r * kRowF + c * 4,
                   ws_t + ((int64_t)(g0 + q) * T::kRows + r) * T::kTO + c * 4,
                   true);
      }
      for (int i = tid; i < n * kC; i += tc::kThreads) {
        const int c = i % kC, q = i / kC;
        const int o = o0 + c * 4;
        cp_async16(sm + q * grp_f + valid * kRowF + c * 4,
                   o < O ? s + (int64_t)(g0 + q) * O + o : s, o < O);
      }
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      for (int q = 0; q < n; ++q) {
        const float* pq = sm + q * grp_f;
        const float* sq = pq + valid * kRowF;
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int nn = 0; nn < NT; ++nn)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int ol = warp * T::kWarpO + i * 16 + g + (e >> 1) * 8;
              const int ml = nn * 8 + 2 * t + (e & 1);
              if (ml < valid) {
                res[i][nn][e] =
                    __fmaf_rn(pq[ml * kRowF + ol], sq[ol], res[i][nn][e]);
              }
            }
      }
      __syncthreads();
    }
    if (tid == 0) counters[tile] = 0;
  }

  // epilogue: c0, c1 -> channel g, rows 2t, 2t + 1; c2, c3 -> channel g + 8
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int o = o0 + warp * T::kWarpO + i * 16 + g + (e >> 1) * 8;
        const int m = m0 + n * 8 + 2 * t + (e & 1);
        if (o < O && m < M) {
          store_out(out, out_bf16, (int64_t)m * O + o, res[i][n][e]);
        }
      }
}

template <int MT, int NT>
int launch_w8a8_grouped(const void* yq, const void* ys, const void* wt,
                        const void* s, void* out, int out_bf16, int M, int D,
                        int O, int G, int k_split, int n_split, void* ws,
                        void* counters, cudaStream_t stream) {
  using T = grp::Tile<MT, NT>;
  static bool smem_set = false;  // the limit: room for kMaxEnds groups
  int err = set_smem_once(w8a8_grouped_gemm_tc_kernel<MT, NT>,
                          grp::kStages * T::stage_bytes(grp::kMaxEnds),
                          smem_set);
  if (err) return err;
  const int gs = D / G;
  const size_t smem = (size_t)grp::kStages *
                      T::stage_bytes((tc::kTK + gs - 1) / gs);
  const TcGrid g(NT, M, O, k_split, n_split, T::kTO);
  w8a8_grouped_gemm_tc_kernel<MT, NT><<<g.grid, tc::kThreads, smem,
                                            stream>>>(
      static_cast<const int8_t*>(yq), static_cast<const float*>(ys),
      static_cast<const int8_t*>(wt), static_cast<const float*>(s), out,
      out_bf16, M, D, O, G, k_split, g.prefetch, static_cast<float*>(ws),
      static_cast<int*>(counters));
  return static_cast<int>(cudaGetLastError());
}

template <int VPL>
int launch_group_quant(const void* y, int y_bf16, void* yq, void* ys,
                       int64_t n_groups, int gs, int lanes_log2, int threads,
                       int blocks, cudaStream_t stream) {
  if (y_bf16) {
    group_quant_int8_kernel<VPL, true><<<blocks, threads, 0, stream>>>(
        y, static_cast<int8_t*>(yq), static_cast<float*>(ys), n_groups, gs,
        lanes_log2);
  } else {
    group_quant_int8_kernel<VPL, false><<<blocks, threads, 0, stream>>>(
        y, static_cast<int8_t*>(yq), static_cast<float*>(ys), n_groups, gs,
        lanes_log2);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// The simple route, for the shapes the routes above do not take: groups
// that are not whole 16-byte vectors (group_quant_int8: bf16 groups of 4,
// say) and group sizes that are not a multiple of 32 or an O that is not
// a multiple of 4 (w8a8_grouped_gemm).  JAX's grouped path needs only
// D % G == 0.  The arithmetic is the plain versions', step for step, so
// both are bitwise those; speed is not the point (no deployed mode uses
// groups under 128).

// One thread a (row, group): the max of |y| as an integer max of bit
// patterns, as group_quant_int8_kernel takes it, then the same scale and
// IEEE division.
template <bool BF16>
__global__ void group_quant_int8_simple_kernel(const void* __restrict__ y,
                                               int8_t* __restrict__ yq,
                                               float* __restrict__ ys,
                                               int64_t n_groups, int gs) {
  const int64_t gid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= n_groups) return;
  const int64_t base = gid * gs;
  auto value = [&](int i) {
    if constexpr (BF16) {
      const unsigned short h =
          reinterpret_cast<const unsigned short*>(y)[base + i];
      return __uint_as_float(static_cast<unsigned>(h) << 16);
    } else {
      return reinterpret_cast<const float*>(y)[base + i];
    }
  };
  unsigned m = 0;
  for (int i = 0; i < gs; ++i) {
    m = max(m, __float_as_uint(value(i)) & 0x7fffffffu);
  }
  const float s = fmaxf(__uint_as_float(m) / 127.0f, 1e-8f);
  for (int i = 0; i < gs; ++i) {
    yq[base + i] = static_cast<int8_t>(
        __float2int_rn(fminf(fmaxf(rintf(value(i) / s), -127.f), 127.f)));
  }
  ys[gid] = s;
}

// One thread a (row, output channel): for g in order the exact int32 dot
// of group g (__dp4a on 4-byte words where gs % 4 == 0, which keeps every
// group's start 4-byte aligned in 16-byte aligned rows; scalar otherwise),
// then o = fma(f32(acc) * ys[m, g], s[g, o], o), as the plain version and
// w8a8_grouped_gemm_tc_kernel fold it.
template <bool DP4A>
__global__ void w8a8_grouped_gemm_simple_kernel(
    const int8_t* __restrict__ yq, const float* __restrict__ ys,
    const int8_t* __restrict__ wt, const float* __restrict__ s, void* out,
    int out_bf16, int M, int D, int O, int G) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= O) return;
  const int gs = D / G;
  const int8_t* w = wt + (int64_t)o * D;
  for (int m = blockIdx.y; m < M; m += gridDim.y) {
    const int8_t* x = yq + (int64_t)m * D;
    float res = 0.f;
    for (int g = 0; g < G; ++g) {
      const int k0 = g * gs;
      int acc = 0;
      if constexpr (DP4A) {
        const int* x4 = reinterpret_cast<const int*>(x + k0);
        const int* w4 = reinterpret_cast<const int*>(w + k0);
        for (int i = 0; i < gs / 4; ++i) acc = __dp4a(x4[i], w4[i], acc);
      } else {
        for (int i = 0; i < gs; ++i) {
          acc += static_cast<int>(x[k0 + i]) * static_cast<int>(w[k0 + i]);
        }
      }
      res = __fmaf_rn(__fmul_rn(__int2float_rn(acc), ys[(int64_t)m * G + g]),
                      s[(int64_t)g * O + o], res);
    }
    store_out(out, out_bf16, (int64_t)m * O + o, res);
  }
}

constexpr int kSimpleThreads = 128;

}  // namespace

extern "C" {

// Each launcher returns the cudaError_t of its launch (0 = success).

// lanes (a power of two <= 32, dividing the group's 16-byte vectors),
// vpl (1, 2, 4 or 8: at least the vectors a lane holds), threads (whole
// warps) and blocks come from the wrapper's plan
// (kernels/quant_matmul.py:group_quant_plan); blocks * threads lanes must
// cover the M * G groups.
int group_quant_int8(const void* y, int y_bf16, void* yq, void* ys, int M,
                     int D, int G, int lanes, int vpl, int threads,
                     int blocks, void* stream) {
  if (M == 0) return 0;
  const int elems = y_bf16 ? 8 : 4;  // values per 16-byte vector
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < lanes) ++lanes_log2;
  const int64_t n_groups = (int64_t)M * G;
  if (G < 1 || D % G || (D / G) % elems || lanes != 1 << lanes_log2 ||
      lanes > 32 || ((D / G) / elems) % lanes ||
      (D / G) / elems / lanes > vpl || threads < 32 || threads > 1024 ||
      threads % 32 || (int64_t)blocks * threads < n_groups * lanes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GROUP_QUANT_LAUNCH(VPL_)                                            \
  launch_group_quant<VPL_>(y, y_bf16, yq, ys, n_groups, D / G, lanes_log2,  \
                           threads, blocks, st)
  switch (vpl) {
    case 1: return GROUP_QUANT_LAUNCH(1);
    case 2: return GROUP_QUANT_LAUNCH(2);
    case 4: return GROUP_QUANT_LAUNCH(4);
    case 8: return GROUP_QUANT_LAUNCH(8);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GROUP_QUANT_LAUNCH
}

// wt is K-major (O, D), s (G, O), ys (M, G).  rows (8, 16, 32, 64 or 80),
// tile_o (output channels per block: 64 or 128), k_split (whole groups)
// and n_split come from the wrapper's plan
// (kernels/quant_matmul.py:grouped_gemm_plan); ws and counters are used
// only when n_split > 1.
int w8a8_grouped_gemm(const void* yq, const void* ys, const void* wt,
                      const void* s, void* out, int out_bf16, int M, int D,
                      int O, int G, int rows, int tile_o, int k_split,
                      int n_split, void* ws, void* counters, void* stream) {
  if (M == 0 || O == 0) return 0;
  if (G < 1 || D % G || (D / G) % 32 || O % 4 || k_split <= 0 ||
      k_split % (D / G) || n_split != (D + k_split - 1) / k_split) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define GROUPED_LAUNCH(MT_, NT_)                                            \
  launch_w8a8_grouped<MT_, NT_>(yq, ys, wt, s, out, out_bf16, M, D, O, G,   \
                                k_split, n_split, ws, counters, st)
#define GROUPED_ROWS(MT_)                                                   \
  switch (rows) {                                                           \
    case 8: return GROUPED_LAUNCH(MT_, 1);                                  \
    case 16: return GROUPED_LAUNCH(MT_, 2);                                 \
    case 32: return GROUPED_LAUNCH(MT_, 4);                                 \
    case 64: return GROUPED_LAUNCH(MT_, 8);                                 \
    case 80: return GROUPED_LAUNCH(MT_, 10);                                \
    default: return static_cast<int>(cudaErrorInvalidValue);                \
  }
  switch (tile_o) {
    case 64: GROUPED_ROWS(1)
    case 128: GROUPED_ROWS(2)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef GROUPED_ROWS
#undef GROUPED_LAUNCH
}

// The simple route of group_quant_int8: any gs that divides D.
int group_quant_int8_simple(const void* y, int y_bf16, void* yq, void* ys,
                            int M, int D, int G, void* stream) {
  if (M == 0) return 0;
  if (G < 1 || D % G) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n_groups = (int64_t)M * G;
  const int blocks =
      static_cast<int>((n_groups + kSimpleThreads - 1) / kSimpleThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (y_bf16) {
    group_quant_int8_simple_kernel<true><<<blocks, kSimpleThreads, 0, st>>>(
        y, static_cast<int8_t*>(yq), static_cast<float*>(ys), n_groups, D / G);
  } else {
    group_quant_int8_simple_kernel<false><<<blocks, kSimpleThreads, 0, st>>>(
        y, static_cast<int8_t*>(yq), static_cast<float*>(ys), n_groups, D / G);
  }
  return static_cast<int>(cudaGetLastError());
}

// The simple route of w8a8_grouped_gemm: any G that divides D, any O.
// yq, wt and s 16-byte aligned (checked by the wrapper).
int w8a8_grouped_gemm_simple(const void* yq, const void* ys, const void* wt,
                             const void* s, void* out, int out_bf16, int M,
                             int D, int O, int G, void* stream) {
  if (M == 0 || O == 0) return 0;
  if (G < 1 || D % G) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((O + kSimpleThreads - 1) / kSimpleThreads,
                  M < 65535 ? M : 65535);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const int8_t*>(yq);
  const auto* w = static_cast<const int8_t*>(wt);
  const auto* xs = static_cast<const float*>(ys);
  const auto* ws = static_cast<const float*>(s);
  if ((D / G) % 4 == 0) {
    w8a8_grouped_gemm_simple_kernel<true><<<grid, kSimpleThreads, 0, st>>>(
        q, xs, w, ws, out, out_bf16, M, D, O, G);
  } else {
    w8a8_grouped_gemm_simple_kernel<false><<<grid, kSimpleThreads, 0, st>>>(
        q, xs, w, ws, out, out_bf16, M, D, O, G);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
