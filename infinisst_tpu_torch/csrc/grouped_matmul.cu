// Hand-written Hopper (sm_90a) ports of the grouped int8 Pallas kernels in
// infinisst_tpu/kernels/quant_matmul.py, the --group128 layout.  Plain C
// interface, bound with ctypes from infinisst_tpu_torch/kernels/
// quant_matmul.py; no PyTorch headers.  Built apart from quant_matmul.cu
// (the two build in parallel); shared helpers in quant_common.cuh,
// tma_common.cuh and (the wgmma instances, descriptors and counters)
// wgmma_common.cuh.
//
//   group_quant_int8   <- quantize_activation_grouped (quant_matmul.py:226)
//   w8a8_grouped_gemm  <- _qmm_i8_grouped_kernel (quant_matmul.py:191), the
//                         body of quantized_matmul_w8a8_grouped (:239, its
//                         pallas_call :278), for one weight or for up to
//                         three that share their input (q|k|v, gate|up)
//                         in one launch
//
// What bounds them on the H100: the GEMM, like w8a8_gemm, by streaming
// the int8 weight (and its (G, O) float32 scales, 3 % more bytes at
// gs = 128) from device memory at the main path's M; group_quant_int8,
// like row_quant_int8, by the launch and one round trip to memory.
//
// w8a8_grouped_gemm is w8a8_gemm's Hopper design (wgmma on a TMA ring of
// full/empty mbarriers, one producer warp and two consumer warpgroups,
// persistent blocks that share the work evenly, up to three weights a
// launch) with the per-group fold in the consumers' registers and a
// stream-K split that keeps the fold's one chain in g order; its note is
// above the kernel.  It replaced an mma.sync split-K kernel on a cp.async
// ring whose copy and fragment instructions bound its loop at few rows.
// group_quant_int8 (redesigned) is row_quant_int8's design at group
// granularity: a group is held in the registers of a few lanes (a
// 128-value bf16 group is 16 lanes x 16 bytes), its max is shuffled
// among them, and it is read once.
// Both take a simple route (one thread a group, or a (row, channel)
// output) for the shapes those designs do not: groups that are not whole
// 16-byte vectors, group sizes not a multiple of 32, O not a multiple of
// 4.  The wrapper picks the route from the shapes.

#include "quant_common.cuh"
#include "wgmma_common.cuh"

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
// w8a8_grouped_gemm: for up to gw::kMaxW K-major (O_w, D) weights w of one
// activation (q|k|v and gate|up share theirs), for g in order,
// o = fma(f32(acc_g[m, o]) * ys[m, g], s_w[g, o], o) in f32 from 0, then
// cast, with acc_g the exact int32 dot of group g (f32(acc_g) is exact for
// |acc_g| < 2^24, which gs = 128 keeps: 128 * 127^2; beyond, the
// conversion rounds to nearest as the plain version's does): the
// arithmetic of _qmm_i8_grouped_kernel's o += acc * ys * s as XLA compiles
// it (one fused multiply-add).  __fmul_rn / __fmaf_rn pin the roundings,
// so the result is bitwise the plain version's at every shape.  Requires
// gs % 32 == 0 and O % 4 == 0 (checked by the wrapper and the launcher).
//
// Work (w8a8_gemm's, in whole groups).  A tile is (weight, 128 output
// channels, N activation rows), listed weight by weight, output tile by
// output tile, row tiles innermost.  A unit is lcm(gs, 128) / 128 stages
// of one tile (one stage at gs = 32, 64 or 128), so a unit starts where a
// group does; the tiles' units are cut into gridDim.x contiguous runs of
// equal length within a piece (`cut` units: 1, or a whole tile when the
// plan splits no tile), one persistent block an SM.
//
// The fold.  The consumers fold each group as it ends.  At gs a multiple
// of 128 (the --group128 path) a stage lies in one group, and the stage
// body is w8a8_gemm's, straight-line (fence, four k32 products, commit,
// wait for all but the newest commit, free the stage before; ptxas
// serialises wgmma around a commit or fence in a branch): a group's
// products run on one of two int32 register sets while the group before,
// on the other set, is folded (f32(acc) * ys, then the FMA into the f32
// result registers); the first product of a group does not read its set
// (scale-d 0), so no set is ever cleared.  Other multiples of 32 (a group
// ending inside a stage or spanning two) take a kernel instance that
// commits and waits for each k32 product and folds a group where it
// ends.  The weight scales s_w[g, tile] of the groups that end in a
// stage ride the ring with it (a TMA box of `ends` group rows x 128
// channels), read into registers before the stage is freed; the
// activation scales ys of a tile's groups are read into shared memory,
// coalesced, at the start of each tile a block runs (a TMA box's inner
// side must be 16 bytes, one group's column of ys is 4).
//
// Stream-K with the fold in g order.  A tile split across blocks cannot
// be summed like w8a8_gemm's int32 partials: the fold is a chain of
// rounded FMAs from group 0.  Its owner, the first block, holds the
// tile's first groups at the end of its run and folds them; the later
// contributors ran the tile's later groups at the start of theirs and
// parked each group's products p_g = f32(acc_g) * ys[m, g] in their own
// workspace slot, thread-major (each thread's registers as float4s, as
// w8a8_gemm parks its partials), then counted themselves at the owner's
// counter.  The owner waits for the count (in practice it is complete),
// stages the parked products and their scale rows through its ring, idle
// once its run is done (every thread's copies in flight at once, one
// wait), and folds them in g order from shared memory: the same chain, so
// the same bits.  Parking costs N x 512 bytes a group against the
// group's 16 KB of weight, so the plan (kernels/quant_matmul.py:
// grouped_plan) splits only while the parked bytes stay within
// GROUPED_WS_CAP of the weight's (one row tile of 8 rows at gs = 128),
// and otherwise gives each block whole tiles.  The owner waits for
// blocks of higher index, so the launch is cooperative, as w8a8_gemm's
// is.
//
// Block: w8a8_gemm's.  One producer warp keeps the TMA ring full (weight,
// activation and scale boxes of a stage on one full mbarrier) and two
// consumer warpgroups run wgmma.mma_async m64nNk32 s8 x s8 -> s32 (the
// weight's 64 rows of each as A, the activation rows as N, both K-major
// under the 128-byte swizzle); a stage is freed on its empty mbarrier
// (one arrival a consumer warp) once a later wait shows its products
// done.  A consumer thread holds channels o = 16 * (warp % 4) + g (+8) of
// its warpgroup's 64 and rows m = 8j + 2t (+1): N / 2 registers a set.
// kernels/quant_matmul.py:grouped_block_work lists a block's run on the
// host.
//
// phases: setup: barriers and the run; first stage's arrival; later stages' waits; products (issue, commit and wait); fold of a group into the result; a tile's scales into shared memory; parked products of a group (a contributor); the count (a contributor); the owner's wait; the owner's fold of the parked products; the tile's store

#ifndef GQ_PHASES
#define GQ_PHASE_INIT()
#define GQ_PHASE(i)
#define GQ_BYTES(n)
#define GQ_PHASE_END()
#endif

namespace gw {

constexpr int kMaxW = 3;                  // weights a launch
constexpr int kTileO = 128;               // output channels a tile
constexpr int kStageK = kWgmmaStageK;     // bytes of D a stage
constexpr int kWStage = kTileO * kStageK;  // a stage's weight bytes
constexpr int kCWarps = 8;                // two consumer warpgroups
constexpr int kConsumers = 32 * kCWarps;
constexpr int kThreads = kConsumers + 32;
constexpr int kMaxStages = 12;
constexpr int kMaxSmem = 232448;          // the opt-in limit of a block

}  // namespace gw

struct GroupedMaps {
  CUtensorMap act;             // (M, D) int8, boxes (N, 128)
  CUtensorMap w[gw::kMaxW];    // (O_w, D) int8, boxes (128, 128)
  CUtensorMap s[gw::kMaxW];    // (G, O_w) f32, boxes (ends, 128)
};

struct GroupedParams {
  const float* ys;             // (M, G)
  const float* s[gw::kMaxW];   // (G, O_w): the owner's parked folds
  void* out[gw::kMaxW];        // (M, O_w)
  float* ws;                   // parked products: `park` groups a block
  int* counters;               // one a block, zero between launches
  int O[gw::kMaxW];
  int tile0[gw::kMaxW + 1];    // each weight's first tile, then all tiles
  int M, D, G, gs, n_k, unit, upt, cut, n_mtiles, stages, stage_bytes;
  int ends, park, out_bf16;
  long long n_units;
};

// the first unit of block b's run (b = gridDim.x: the end of the last)
__device__ __forceinline__ long long grouped_start(const GroupedParams& p,
                                                   int b) {
  return p.n_units / p.cut * b / gridDim.x * p.cut;
}

// the block whose run holds unit i
__device__ __forceinline__ int grouped_block_of(const GroupedParams& p,
                                                long long i) {
  const long long pieces = p.n_units / p.cut;
  return static_cast<int>(((i / p.cut + 1) * gridDim.x - 1) / pieces);
}

__device__ __forceinline__ void grouped_tile(const GroupedParams& p, int t,
                                             int& w, int& ot, int& mt) {
  w = 0;
  while (w + 1 < gw::kMaxW && t >= p.tile0[w + 1]) ++w;
  const int local = t - p.tile0[w];
  ot = local / p.n_mtiles;
  mt = local - ot * p.n_mtiles;
}

template <int N, bool WHOLE>
__global__ void __launch_bounds__(gw::kThreads, 1)
    w8a8_grouped_gemm_kernel(const __grid_constant__ GroupedMaps maps,
                             const __grid_constant__ GroupedParams p) {
  using namespace gw;
  constexpr int R = N / 2;  // accumulator registers a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full =
      reinterpret_cast<uint64_t*>(ring + p.stages * p.stage_bytes);
  uint64_t* empty = full + p.stages;
  // a tile's activation scales, group-major: [g - g_lo][row]
  float* ys_s = reinterpret_cast<float*>(empty + p.stages);

  GQ_PHASE_INIT();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long u0 = grouped_start(p, blockIdx.x);
  const long long u1 = grouped_start(p, blockIdx.x + 1);
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kCWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  GQ_PHASE(0);

  if (warp == kCWarps) {  // the producer
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" ::"l"(&maps.act) : "memory");
      // a weight read once (one row tile) goes first out of L2, so the
      // activation, the parked products and the next kernel's inputs stay
      uint64_t policy;
      if (p.n_mtiles == 1) {
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                     : "=l"(policy));
      } else {
        asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                     : "=l"(policy));
      }
      const unsigned tx = kWStage + N * kStageK + p.ends * kTileO * 4;
      int stage = 0;
      unsigned phase = 0;
      for (long long u = u0; u < u1;) {
        const int t = static_cast<int>(u / p.upt);
        const long long tu0 = static_cast<long long>(t) * p.upt;
        const long long seg_end = min(tu0 + p.upt, u1);
        const int ka = static_cast<int>(u - tu0) * p.unit;
        const int kb = min(static_cast<int>(seg_end - tu0) * p.unit, p.n_k);
        int w, ot, mt;
        grouped_tile(p, t, w, ot, mt);
        // the group holding the stage's first byte, and that byte's offset
        // in it: counted forward, no division a stage
        int g0 = ka * kStageK / p.gs;
        int gb = ka * kStageK - g0 * p.gs;
        for (int k = ka; k < kb; ++k) {
          mbar_wait(&empty[stage], phase ^ 1);
          unsigned char* st = ring + stage * p.stage_bytes;
          mbar_expect_tx(&full[stage], tx);
          load_weight(st, &maps.w[w], &full[stage], k * kStageK, ot * kTileO,
                      policy);
          tma_load_2d(st + kWStage, &maps.act, &full[stage], k * kStageK,
                      mt * N);
          tma_load_2d(st + kWStage + N * kStageK, &maps.s[w], &full[stage],
                      ot * kTileO, g0);
          for (gb += kStageK; gb >= p.gs; gb -= p.gs) ++g0;
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
        u = seg_end;
      }
    }
    return;
  }

  // the consumers
  const int wg = warp >> 2, gq = lane >> 2, t4 = lane & 3;
  // the channel of registers 4j + e, e < 2, within the tile (e >= 2: + 8)
  const int o_lo = wg * 64 + (warp & 3) * 16 + gq;
  int acc_a[R], acc_b[R];
  float res[R];
  float s_a[2] = {0.f, 0.f}, s_b[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < R; ++i) acc_a[i] = acc_b[i] = 0;
  int stage = 0;
  unsigned phase = 0;
  int held = -1;  // a stage whose products the last commit may still read
  bool first_wait = true;
  auto wait_full = [&]() {
    mbar_wait(&full[stage], phase);
    if (first_wait) {
      GQ_PHASE(1);
      first_wait = false;
    } else {
      GQ_PHASE(2);
    }
    GQ_BYTES(kWStage);
  };
  auto next_stage = [&]() {
    if (++stage == p.stages) {
      stage = 0;
      phase ^= 1;
    }
  };
  for (long long u = u0; u < u1;) {
    const int t = static_cast<int>(u / p.upt);
    const long long tu0 = static_cast<long long>(t) * p.upt;
    const long long te = tu0 + p.upt;
    const long long seg_end = min(te, u1);
    const int ka = static_cast<int>(u - tu0) * p.unit;
    const int kb = min(static_cast<int>(seg_end - tu0) * p.unit, p.n_k);
    int w, ot, mt;
    grouped_tile(p, t, w, ot, mt);
    const int g_lo = ka * kStageK / p.gs;
    const int g_hi = min(kb * kStageK, p.D) / p.gs;
    const bool contributor = u != tu0;  // the tile began in an earlier run
    const bool whole = !contributor && seg_end == te;
    const int valid = min(N, p.M - mt * N);  // rows of the tile within M
    // a contributor's slot: group j's products thread-major, R floats a
    // thread as R / 4 float4s, vector v of thread tid at v * kConsumers +
    // tid (coalesced 16-byte stores, read back by the owner's same thread)
    float* park = contributor
                      ? p.ws + static_cast<int64_t>(blockIdx.x) * p.park * N *
                                   kTileO
                      : nullptr;
    named_sync<kConsumers>();  // the last tile's folds are done with ys_s
    const int ng = g_hi - g_lo;
    for (int i = tid; i < ng * N; i += kConsumers) {
      const int r = i / ng, q = i - r * ng;  // a row's groups coalesced
      ys_s[q * N + r] = r < valid ? __ldg(p.ys + static_cast<int64_t>(
                                                      mt * N + r) * p.G +
                                          g_lo + q)
                                  : 0.f;
    }
    named_sync<kConsumers>();
#pragma unroll
    for (int i = 0; i < R; ++i) res[i] = 0.f;
    GQ_PHASE(5);

    // group g's products p = f32(acc) * ys: folded, or (a contributor)
    // parked at the group's place in the block's slot
    auto fold = [&](int (&acc)[R], const float (&sv)[2], int g) {
      fence_regs(acc);
      const float* yq = ys_s + (g - g_lo) * N;
      if (park == nullptr) {
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const int r = 8 * (i >> 2) + 2 * t4 + (i & 1);
          res[i] = __fmaf_rn(__fmul_rn(static_cast<float>(acc[i]), yq[r]),
                             sv[(i & 3) >> 1], res[i]);
        }
        GQ_PHASE(4);
      } else {
        float4* dst = reinterpret_cast<float4*>(
                          park + static_cast<int64_t>(g - g_lo) * R *
                                     kConsumers) +
                      tid;
#pragma unroll
        for (int v = 0; v < R / 4; ++v) {
          float x[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            x[e] = __fmul_rn(static_cast<float>(acc[4 * v + e]),
                             yq[8 * v + 2 * t4 + (e & 1)]);
          }
          dst[v * kConsumers] = make_float4(x[0], x[1], x[2], x[3]);
        }
        GQ_PHASE(6);
      }
    };

    if constexpr (WHOLE) {
      // gs a multiple of 128: a stage lies in one group.  w8a8_gemm's
      // stage body, straight-line (so ptxas keeps the products
      // asynchronous): the group's products on one register set, then the
      // group before, on the other set, folded while they run
      const int stages_a_group = p.gs / kStageK;
      auto run_group = [&](int (&cur)[R], float (&s_cur)[2], int (&oth)[R],
                           const float (&s_oth)[2], int g) {
        for (int k = 0; k < stages_a_group; ++k) {
          wait_full();
          const uint32_t base = smem_u32(ring + stage * p.stage_bytes);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < kStageK / 32; ++kk) {
            wgmma_s8<N>(cur,
                        sw128_desc(base + wg * 64 * kStageK + kk * 32),
                        sw128_desc(base + kWStage + kk * 32), k > 0 || kk > 0);
          }
          wgmma_commit();
          wgmma_wait<1>();  // every commit but this one is done
          if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
          held = stage;
          next_stage();
          GQ_PHASE(3);
        }
        // the group's scales (row 0 of its last stage's box) before that
        // stage is freed, then the group before
        const float* ss = reinterpret_cast<const float*>(
            ring + held * p.stage_bytes + kWStage + N * kStageK);
        s_cur[0] = ss[o_lo];
        s_cur[1] = ss[o_lo + 8];
        if (g > g_lo) fold(oth, s_oth, g - 1);
      };
      for (int g = g_lo; g < g_hi; g += 2) {
        run_group(acc_a, s_a, acc_b, s_b, g);
        if (g + 1 < g_hi) run_group(acc_b, s_b, acc_a, s_a, g + 1);
      }
      wgmma_wait<0>();
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = -1;
      GQ_PHASE(3);
      if (ng & 1) {
        fold(acc_a, s_a, g_hi - 1);
      } else {
        fold(acc_b, s_b, g_hi - 1);
      }
    } else {
      // groups of 32, 64, 96, ... bytes: a group may end inside a stage
      // or span two, so each k32 product is committed and waited for, and
      // a group is folded where it ends (s from row q of the stage's box:
      // the q-th group to end in it)
      const int spg = p.gs >> 5;  // k32 products a group
      int pos = 0, g = g_lo;
      for (int k = ka; k < kb; ++k) {
        wait_full();
        unsigned char* st_p = ring + stage * p.stage_bytes;
        const uint32_t base = smem_u32(st_p);
        const int nst = min(kStageK / 32, (p.D - k * kStageK) >> 5);
        int q = 0;
        for (int kk = 0; kk < nst; ++kk) {
          wgmma_fence();
          wgmma_s8<N>(acc_a, sw128_desc(base + wg * 64 * kStageK + kk * 32),
                      sw128_desc(base + kWStage + kk * 32), pos > 0);
          wgmma_commit();
          wgmma_wait<0>();
          GQ_PHASE(3);
          if (++pos == spg) {
            const float* ss = reinterpret_cast<const float*>(
                                  st_p + kWStage + N * kStageK) +
                              q * kTileO;
            const float sv[2] = {ss[o_lo], ss[o_lo + 8]};
            fold(acc_a, sv, g);
            ++g;
            ++q;
            pos = 0;
          }
        }
        if (lane == 0) mbar_arrive(&empty[stage]);
        next_stage();
      }
    }
    u = seg_end;

    if (contributor) {
      // parked: counted at the owner's counter (all threads stored, one
      // barrier, one thread's release)
      named_sync<kConsumers>();
      if (tid == 0) red_release(&p.counters[grouped_block_of(p, tu0)], 1);
      GQ_PHASE(7);
      continue;
    }
    const int O = p.O[w];
    if (!whole) {
      // the owner: the later contributors' parked products, in g order
      const int b_last = grouped_block_of(p, te - 1);
      if (tid == 0) {
        int* cnt = &p.counters[blockIdx.x];
        while (ld_acquire(cnt) != b_last - static_cast<int>(blockIdx.x)) {
        }
        *cnt = 0;
      }
      named_sync<kConsumers>();
      GQ_PHASE(8);
      // staged through the idle ring (the owner's tile ends its run),
      // as many groups at a time as fit: each thread copies its own
      // parked vectors and 32 threads the groups' scale rows, every copy
      // in flight at once, one wait; then the folds from shared memory
      const int per_g = R * kConsumers + kTileO;  // floats a staged group
      const int cap = p.stages * p.stage_bytes / (4 * per_g);
      float* stg = reinterpret_cast<float*>(ring);
      const float* __restrict__ sw = p.s[w];
      int b = blockIdx.x + 1;  // the contributor holding the next group
      int ga = g_hi;           // its first group
      int gz = min(static_cast<int>(min(grouped_start(p, b + 1), te) - tu0) *
                       p.unit * kStageK,
                   p.D) /
               p.gs;
      for (int g0 = g_hi; g0 < p.G; g0 += cap) {
        const int n = min(cap, p.G - g0);
        named_sync<kConsumers>();  // the last chunk's folds are done
        for (int c = 0; c < n; ++c) {
          const int g = g0 + c;
          while (g >= gz) {
            ++b;
            ga = gz;
            gz = min(static_cast<int>(min(grouped_start(p, b + 1), te) - tu0) *
                         p.unit * kStageK,
                     p.D) /
                 p.gs;
          }
          const float* src =
              p.ws + (static_cast<int64_t>(b) * p.park + (g - ga)) * R *
                         kConsumers;
          float* dst = stg + c * per_g;
#pragma unroll
          for (int v = 0; v < R / 4; ++v) {
            cp_async16(dst + (v * kConsumers + tid) * 4,
                       src + (v * kConsumers + tid) * 4, true);
          }
          if (tid < kTileO / 4) {
            const int o = ot * kTileO + tid * 4;
            cp_async16(dst + R * kConsumers + tid * 4,
                       o < O ? sw + static_cast<int64_t>(g) * O + o : sw,
                       o < O);
          }
        }
        cp_async_commit();
        cp_async_wait<0>();
        named_sync<kConsumers>();
        for (int c = 0; c < n; ++c) {
          const float* pg = stg + c * per_g;
          const float s_lo = pg[R * kConsumers + o_lo];
          const float s_hi = pg[R * kConsumers + o_lo + 8];
#pragma unroll
          for (int v = 0; v < R / 4; ++v) {
            const float4 x =
                reinterpret_cast<const float4*>(pg)[v * kConsumers + tid];
            res[4 * v] = __fmaf_rn(x.x, s_lo, res[4 * v]);
            res[4 * v + 1] = __fmaf_rn(x.y, s_lo, res[4 * v + 1]);
            res[4 * v + 2] = __fmaf_rn(x.z, s_hi, res[4 * v + 2]);
            res[4 * v + 3] = __fmaf_rn(x.w, s_hi, res[4 * v + 3]);
          }
        }
      }
      GQ_PHASE(9);
    }
    // the tile's valid rows and channels
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 8 * j + 2 * t4 + (e & 1);
        const int o = ot * kTileO + o_lo + 8 * (e >> 1);
        if (r < valid && o < O) {
          store_out(p.out[w], p.out_bf16,
                    static_cast<int64_t>(mt * N + r) * O + o, res[4 * j + e]);
        }
      }
    }
    GQ_PHASE(10);
  }
  GQ_PHASE_END();
}

// The tensor map of the (G, O) float32 weight scales, boxes (ends, 128):
// group rows past G and channels past O arrive as zeros.
int scale_map(CUtensorMap* map, const void* base, int G, int O, int ends) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(O),
                              static_cast<cuuint64_t>(G)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(O) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(gw::kTileO),
                             static_cast<cuuint32_t>(ends)};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encoder()(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

// A stage of the ring: the weight, N activation rows and `ends` scale
// rows, rounded up to 1024 bytes (the 128-byte swizzle's alignment).
int grouped_stage_bytes(int N, int ends) {
  const int b = gw::kWStage + N * gw::kStageK + ends * gw::kTileO * 4;
  return (b + 1023) & ~1023;
}

// The dynamic shared memory of a block: the ring, its mbarriers, a
// tile's N x G activation scales, and 1024 bytes to align the ring.
size_t grouped_smem(int N, int G, int ends, int stages) {
  return 1024 + static_cast<size_t>(stages) * grouped_stage_bytes(N, ends) +
         16 * static_cast<size_t>(stages) +
         4 * static_cast<size_t>(N) * G;
}

template <int N, bool WHOLE>
int launch_grouped(const GroupedMaps& maps, const GroupedParams& p,
                   int blocks, cudaStream_t stream) {
  static bool smem_set = false;
  int err = set_smem_once(w8a8_grouped_gemm_kernel<N, WHOLE>, gw::kMaxSmem,
                          smem_set);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(gw::kThreads);
  cfg.dynamicSmemBytes = grouped_smem(N, p.G, p.ends, p.stages);
  cfg.stream = stream;
  // cooperative: all blocks resident at once, as the owners' waits need
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(
      cudaLaunchKernelEx(&cfg, w8a8_grouped_gemm_kernel<N, WHOLE>, maps, p));
  if (err) return err;
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
// w8a8_grouped_gemm_kernel fold it.
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

// The dynamic shared memory of a w8a8_grouped_gemm block of `rows`
// activation rows, G groups, `ends` scale rows a stage and `stages`
// stages (the wrapper's plan sizes its ring with the same sum).
int w8a8_grouped_gemm_smem(int rows, int G, int ends, int stages) {
  return static_cast<int>(grouped_smem(rows, G, ends, stages));
}

// n_w (1 to 3) K-major (O_w, D) int8 weights wt_w with their (G, O_w) f32
// scales s_w and (M, O_w) outputs out_w, all against one (M, D) int8
// activation yq and its (M, G) f32 group scales ys.  rows (activation
// rows a tile: 8, 16, 32, 48, 64 or 80), n_mtiles, unit (stages a unit:
// lcm(D / G, 128) / 128), cut (units a piece: 1, or the units of a tile),
// blocks, stages and park (groups a block's workspace slot holds) come
// from the wrapper's plan (kernels/quant_matmul.py:grouped_plan); ws holds
// `blocks` slots of park * rows * 128 floats (unused when park is 0) and
// counters `blocks` ints, all zero, and the launch leaves them zero.
// Returns the cudaError_t of the launch, or 10000 + the CUresult of a
// failed tensor-map encode.
int w8a8_grouped_gemm(const void* yq, const void* ys, int M, int D, int G,
                      int n_w, const void* wt0, const void* wt1,
                      const void* wt2, const void* s0, const void* s1,
                      const void* s2, void* out0, void* out1, void* out2,
                      int O0, int O1, int O2, int out_bf16, int rows,
                      int n_mtiles, int unit, int cut, int blocks,
                      int stages, int park, void* ws, void* counters,
                      void* stream) {
  if (M == 0) return 0;
  const int gs = G > 0 && D % G == 0 ? D / G : 0;
  if (n_w < 1 || n_w > gw::kMaxW || gs < 32 || gs % 32 || rows < 8 ||
      rows > 80 || rows % 8 || n_mtiles != (M + rows - 1) / rows ||
      stages < 2 || stages > gw::kMaxStages || blocks < 1 || unit < 1 ||
      cut < 1 || park < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int ends = (gw::kStageK + gs - 1) / gs;
  if (ends > G) ends = G;
  if (grouped_smem(rows, G, ends, stages) >
      static_cast<size_t>(gw::kMaxSmem)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!encoder()) return static_cast<int>(cudaErrorNotSupported);
  const void* wts[gw::kMaxW] = {wt0, wt1, wt2};
  const void* ss[gw::kMaxW] = {s0, s1, s2};
  void* outs[gw::kMaxW] = {out0, out1, out2};
  const int Os[gw::kMaxW] = {O0, O1, O2};
  GroupedMaps maps = {};
  GroupedParams p = {};
  int err = kmajor_map(&maps.act, yq, M, D, rows);
  for (int w = 0; w < n_w && !err; ++w) {
    if (Os[w] < 1 || Os[w] % 4) return static_cast<int>(cudaErrorInvalidValue);
    err = kmajor_map(&maps.w[w], wts[w], Os[w], D, gw::kTileO);
    if (!err) err = scale_map(&maps.s[w], ss[w], G, Os[w], ends);
    p.s[w] = static_cast<const float*>(ss[w]);
    p.out[w] = outs[w];
    p.O[w] = Os[w];
    p.tile0[w + 1] =
        p.tile0[w] + (Os[w] + gw::kTileO - 1) / gw::kTileO * n_mtiles;
  }
  if (err) return err;
  for (int w = n_w; w < gw::kMaxW; ++w) p.tile0[w + 1] = p.tile0[n_w];
  p.ys = static_cast<const float*>(ys);
  p.ws = static_cast<float*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.D = D;
  p.G = G;
  p.gs = gs;
  p.n_k = (D + gw::kStageK - 1) / gw::kStageK;
  p.unit = unit;
  p.upt = (p.n_k + unit - 1) / unit;
  p.cut = cut;
  p.n_mtiles = n_mtiles;
  p.stages = stages;
  p.stage_bytes = grouped_stage_bytes(rows, ends);
  p.ends = ends;
  p.park = park;
  p.out_bf16 = out_bf16;
  p.n_units = static_cast<long long>(p.tile0[gw::kMaxW]) * p.upt;
  // a unit starts where a group does; pieces of whole units, one a block
  // at least; slots wherever the plan parks
  if ((static_cast<long long>(unit) * gw::kStageK) % gs ||
      (cut != 1 && cut != p.upt) || blocks > p.n_units / cut ||
      (park > 0 && ws == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool whole = gs % gw::kStageK == 0;
  switch (rows) {
#define GROUPED_CASE(N_)                                     \
  case N_:                                                   \
    return whole ? launch_grouped<N_, true>(maps, p, blocks, st) \
                 : launch_grouped<N_, false>(maps, p, blocks, st);
    GROUPED_CASE(8)
    GROUPED_CASE(16)
    GROUPED_CASE(32)
    GROUPED_CASE(48)
    GROUPED_CASE(64)
    GROUPED_CASE(80)
#undef GROUPED_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
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
