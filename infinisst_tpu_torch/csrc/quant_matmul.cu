// Hand-written Hopper (sm_90a) ports of the int8 matmul Pallas kernels in
// infinisst_tpu/kernels/quant_matmul.py.  Plain C interface, bound with
// ctypes from infinisst_tpu_torch/kernels/quant_matmul.py; no PyTorch
// headers, so the file builds in seconds.
//
//   row_quant_int8  <- quantize_activation (quant_matmul.py:106)
//   w8a8_gemm       <- _qmm_i8_kernel (quant_matmul.py:94), the body of
//                      quantized_matmul_w8a8 (:117, its pallas_call :165),
//                      for one weight or for up to three that share their
//                      input (q|k|v, gate|up) in one launch
//   w8_bf16_gemm    <- _qmm_kernel (quant_matmul.py:26), the body of
//                      quantized_matmul (:34)
//
// The grouped pair (group_quant_int8, w8a8_grouped_gemm) is in
// grouped_matmul.cu; the helpers the files share, in quant_common.cuh and
// (TMA, mbarriers, the tensor-map encoder) tma_common.cuh.
//
// What bounds them on the H100.  w8a8_gemm streams D*O weight bytes for
// 2*M*D*O operations: below about 300 activation rows the bytes bind
// (3.35 TB/s against 1979 int8 TOP/s: ~590 operations a byte), above them
// the tensor cores.  The decoder's rows are 1-80 (beam steps, drafts,
// verifies, the stream's prefill), the pool's and the offline prefills'
// 192-768.  w8_bf16_gemm is bound by its weight bytes too.
// row_quant_int8 reads M*D activations and writes M*D bytes, a few
// microseconds of work: at M = 4 a launch costs more than the bytes, so
// it is bound by latency (the launch, one round trip to memory, one
// reduction).
//
// w8a8_gemm's design.  The phase split of the mma.sync split-K kernel it
// replaced (tools/gemm_phases.py, PERF.md) showed, at four beam rows, a
// block's loop bound by the instructions of its copies and products (the
// cp.async ring and the MMA fragments, 13.7 of 23.4 us a block against
// gate or up), 1.09-1.27 waves of blocks, and at k or v a 32-way serial
// combine (8.6 us); at 384 rows each wave streamed the weight again.
// - wgmma.mma_async s8 x s8 -> s32 with the weight as the 64-row A
//   operand (swap AB) and up to 256 activation rows as the N side, both
//   K-major in shared memory: one tile holds every row of a call up to
//   256, so the weight crosses memory once; above 256 the row tiles of an
//   output tile run next to each other and its second read hits L2.
// - TMA into a ring of stages on full/empty mbarriers, one producer warp
//   and two consumer warpgroups: no instruction a thread spends on the
//   copies.  TMA's zero fill replaces the masks of the ragged D, O and M
//   edges.  A weight read once (one row tile) is loaded evict-first, so
//   it does not push the activation and the partials out of L2.
// - Persistent blocks, one an SM, each an equal contiguous run of the
//   (tile, stage) iterations (stream-K): no partial wave; a tile split
//   across blocks is summed exactly in int32 by its owner from at most a
//   few partials that its contributors stored at the start of their runs
//   (below), no serial combine.  The owner waits for blocks of higher
//   index, so the launch is cooperative: every block is resident at once,
//   or the launch fails (a card whose SMs are partly taken, say by MPS)
//   instead of hanging.
// - Up to three weights of one activation in one launch (one work list):
//   a Llama layer launches 4 GEMMs, not 7.
// The parameters are __grid_constant__: indexed by weight at run time,
// a by-value copy would live in local memory.  The epilogue
// (f32(acc) * ys[m]) * s[o] is applied once per output, so the result is
// bitwise that of the plain version at every shape.
//
// w8_bf16_gemm keeps its mma.sync design: m16n8k16 on weight bytes
// widened to bf16 in registers (exact), swap AB with the activation rows
// as the 8-wide N side, a 4-stage cp.async ring of 128-byte-deep weight
// tiles, split-K across blocks (gemm_plan: about two blocks per SM) whose
// last block sums the partials in split order; acc * s[o] differs from
// the plain version only by the order of the f32 sums.

#include "quant_common.cuh"
#include "wgmma_common.cuh"

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
// w8a8_gemm: out_w[m, o] = (f32(sum_k yq[m,k] * wt_w[o,k]) * ys[m]) * s_w[o]
// for up to kMaxW K-major (O_w, D) weights w of one activation (q|k|v and
// gate|up share theirs), each output channel computed exactly as alone.
//
// Work.  A tile is (weight, 128 output channels, N activation rows); the
// tiles are listed weight by weight, output tile by output tile, with the
// row tiles of an output tile next to each other (above 256 rows they run
// together, so a weight tile's second read comes from L2).  An iteration
// is one tile's 128-byte stage of D; the n_tiles * n_k iterations are cut
// into gridDim.x contiguous runs of equal length within one (block b:
// [b * I / B, (b + 1) * I / B)), one persistent block an SM.  A tile whose
// iterations fall to one block is written by it.  A tile split across
// blocks b_first < ... < b_last is summed exactly in int32 (the same bits
// in any order): its owner b_first runs the tile's first iterations at the
// end of its run, while the later contributors ran theirs at the start of
// their runs, each storing its partial into its own workspace slot and
// counting itself at the owner's counter (all threads store, one barrier,
// one thread's release).  The owner finds the count complete (it spins on
// an acquire load, in practice not at all), adds the partials to its
// registers, resets the counter for the next launch and writes the tile.
// Each block owns at most one split tile and stores at most one partial,
// so the slots and counters are one a block.
// kernels/quant_matmul.py:w8a8_block_work lists the same runs on the host.
//
// Block.  kCWarps consumer warps (two warpgroups: output channels 0-63 and
// 64-127 of the tile) and one producer warp.  The producer's lane 0 keeps
// a ring of `stages` stages full with TMA (cp.async.bulk.tensor, 128-byte
// swizzle): each stage holds the tile's 128 weight rows and its N
// activation rows of one 128-byte depth of D, completing on the stage's
// full mbarrier; rows and bytes past O, M and D arrive as zeros, which
// add nothing.  Each consumer warpgroup runs four wgmma.mma_async
// m64nNk32 s8 x s8 -> s32 a stage (swap AB: its 64 weight rows are the A
// operand, the activation rows the N side, both K-major from shared
// memory), keeps one group in flight and frees the stage before on its
// empty mbarrier (one arrival a consumer warp).  A consumer thread holds
// channels o = 16 * warp + g (+8) and rows m = 8j + 2t (+1) of its 64 x N
// accumulator, N / 2 registers.
//
// phases: setup: barriers and the run; first stage's arrival; later stages' waits; products (issue and wait); epilogue of a whole tile; partial store + count (a later contributor); the owner's wait; the owner's combine + epilogue

#ifndef GQ_PHASES
#define GQ_PHASE_INIT()
#define GQ_PHASE(i)
#define GQ_BYTES(n)
#define GQ_PHASE_END()
#endif

constexpr int kMaxW = 3;        // weights a launch
constexpr int kTileO = 128;     // output channels a tile
constexpr int kStageK = kWgmmaStageK;  // bytes of D a stage
constexpr int kWStage = kTileO * kStageK;  // a stage's weight bytes
constexpr int kCWarps = 8;      // two consumer warpgroups
constexpr int kGemmThreads = 32 * (kCWarps + 1);
constexpr int kMaxStages = 12;
constexpr int kMaxSmem = 232448;  // the opt-in limit of a block

struct GemmMaps {
  CUtensorMap act;           // (M, D) int8, boxes (N, 128)
  CUtensorMap w[kMaxW];      // (O_w, D) int8, boxes (128, 128)
};

struct GemmParams {
  const float* ys;           // (M,)
  const float* s[kMaxW];     // (O_w,)
  void* out[kMaxW];          // (M, O_w)
  int* ws;                   // int32 partials: slots of 128 * N
  int* counters;             // one a slot, zero between launches
  int O[kMaxW];
  int tile0[kMaxW + 1];      // each weight's first tile, then all tiles
  int M, n_k, n_mtiles, stages, out_bf16;
  long long n_iters;
};

constexpr int kConsumers = 32 * kCWarps;

// the block holding iteration i of I cut into B runs
__device__ __forceinline__ int block_of(long long i, long long I, int B) {
  return static_cast<int>(((i + 1) * B - 1) / I);
}

__device__ __forceinline__ void tile_of(const GemmParams& p, int t, int& w,
                                        int& ot, int& mt) {
  w = 0;
  while (w + 1 < kMaxW && t >= p.tile0[w + 1]) ++w;
  const int local = t - p.tile0[w];
  ot = local / p.n_mtiles;
  mt = local - ot * p.n_mtiles;
}

// c (64 x N, s32) += a (64 x 32 s8, K-major) * b (N x 32 s8, K-major),
// both from shared memory through their descriptors; c is not read when
// accumulate is 0.  One specialisation per N the kernel is compiled for.
// The epilogue of a tile from consumer thread tid's registers: register
// 4j + e -> channel 128 ot + 64 wg + 16 (warp % 4) + g + 8 (e >> 1), row
// N mt + 8j + 2t + (e & 1).  The row scales are loaded before any store.
template <int N, typename T>
__device__ __forceinline__ void write_rows(const int (&acc)[N / 2],
                                           const GemmParams& p, int w,
                                           int ot, int mt, int tid) {
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int O = p.O[w];
  const int o0 = ot * kTileO + (warp >> 2) * 64 + (warp & 3) * 16 + g;
  const float* __restrict__ sc = p.s[w];
  const float s_lo = o0 < O ? __ldg(sc + o0) : 0.f;
  const float s_hi = o0 + 8 < O ? __ldg(sc + o0 + 8) : 0.f;
  const int m0 = mt * N + 2 * t4;
  float ys[N / 4];  // rows m0 + 8j + h at 2j + h
#pragma unroll
  for (int i = 0; i < N / 4; ++i) {
    const int m = m0 + (i >> 1) * 8 + (i & 1);
    ys[i] = m < p.M ? __ldg(p.ys + m) : 0.f;
  }
  T* out = static_cast<T*>(p.out[w]);
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int o = o0 + (e >> 1) * 8;
      const int m = m0 + j * 8 + (e & 1);
      if (o < O && m < p.M) {
        const float v = __fmul_rn(
            __fmul_rn(static_cast<float>(acc[4 * j + e]), ys[2 * j + (e & 1)]),
            e >> 1 ? s_hi : s_lo);
        if constexpr (sizeof(T) == 2) {
          out[static_cast<int64_t>(m) * O + o] = __float2bfloat16_rn(v);
        } else {
          out[static_cast<int64_t>(m) * O + o] = v;
        }
      }
    }
  }
}

template <int N>
__device__ __forceinline__ void write_tile(const int (&acc)[N / 2],
                                           const GemmParams& p, int w,
                                           int ot, int mt, int tid) {
  if (p.out_bf16) {
    write_rows<N, __nv_bfloat16>(acc, p, w, ot, mt, tid);
  } else {
    write_rows<N, float>(acc, p, w, ot, mt, tid);
  }
}

template <int N>
__global__ void __launch_bounds__(kGemmThreads, 1)
    w8a8_gemm_kernel(const __grid_constant__ GemmMaps maps,
                     const __grid_constant__ GemmParams p) {
  constexpr int kRegs = N / 2;
  constexpr int kPart = kRegs * kConsumers;  // ints of a block's partial
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  // a stage: the tile's 128 weight rows and its N activation rows
  constexpr int kStage = kWStage + N * kStageK;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + p.stages * kStage);
  uint64_t* empty = full + p.stages;

  GQ_PHASE_INIT();
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int B = gridDim.x;
  const long long it0 = p.n_iters * blockIdx.x / B;
  const long long it1 = p.n_iters * (blockIdx.x + 1) / B;
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
      // activation, the partials and the next kernel's inputs stay
      uint64_t policy;
      if (p.n_mtiles == 1) {
        asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
                     : "=l"(policy));
      } else {
        asm volatile("createpolicy.fractional.L2::evict_normal.b64 %0, 1.0;\n"
                     : "=l"(policy));
      }
      int stage = 0;
      unsigned phase = 0;
      for (long long it = it0; it < it1; ++it) {
        const int t = static_cast<int>(it / p.n_k);
        const int k = static_cast<int>(it - static_cast<long long>(t) * p.n_k);
        int w, ot, mt;
        tile_of(p, t, w, ot, mt);
        mbar_wait(&empty[stage], phase ^ 1);
        unsigned char* st = ring + stage * kStage;
        mbar_expect_tx(&full[stage], kStage);
        load_weight(st, &maps.w[w], &full[stage], k * kStageK, ot * kTileO,
                    policy);
        tma_load_2d(st + kWStage, &maps.act, &full[stage], k * kStageK,
                    mt * N);
        if (++stage == p.stages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // the consumers
  const int wg = warp >> 2;
  int acc[kRegs];
#pragma unroll
  for (int i = 0; i < kRegs; ++i) acc[i] = 0;
  int stage = 0;
  unsigned phase = 0;
  bool first_wait = true;
  long long it = it0;
  while (it < it1) {
    const int t = static_cast<int>(it / p.n_k);
    const long long ts = static_cast<long long>(t) * p.n_k;
    const long long te = ts + p.n_k;
    const long long seg_end = te < it1 ? te : it1;
    const bool whole = ts >= it0 && te <= it1;
    int held = -1;  // the stage the last wgmma group may still read
    for (long long i = it; i < seg_end; ++i) {
      mbar_wait(&full[stage], phase);
      if (first_wait) {
        GQ_PHASE(1);
        first_wait = false;
      } else {
        GQ_PHASE(2);
      }
      GQ_BYTES(kWStage);
      const uint32_t sw = smem_u32(ring + stage * kStage) + wg * 64 * kStageK;
      const uint32_t sa = smem_u32(ring + stage * kStage) + kWStage;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kStageK / 32; ++kk) {
        wgmma_s8<N>(acc, sw128_desc(sw + kk * 32), sw128_desc(sa + kk * 32),
                    i != it || kk > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      if (held >= 0 && lane == 0) mbar_arrive(&empty[held]);
      held = stage;
      if (++stage == p.stages) {
        stage = 0;
        phase ^= 1;
      }
      GQ_PHASE(3);
    }
    wgmma_wait<0>();
    if (lane == 0) mbar_arrive(&empty[held]);
    fence_regs(acc);
    it = seg_end;

    int w, ot, mt;
    tile_of(p, t, w, ot, mt);
    if (whole) {
      write_tile<N>(acc, p, w, ot, mt, tid);
      GQ_PHASE(4);
    } else if (ts < it0) {
      // a later contributor (the tile began in an earlier run): its
      // partial into its block's slot, counted at the owner's counter
      int4* part = reinterpret_cast<int4*>(p.ws + blockIdx.x * kPart) + tid;
#pragma unroll
      for (int i = 0; i < kRegs / 4; ++i) {
        part[i * kConsumers] = make_int4(acc[4 * i], acc[4 * i + 1],
                                         acc[4 * i + 2], acc[4 * i + 3]);
      }
      named_sync<kConsumers>();
      if (tid == 0) red_release(&p.counters[block_of(ts, p.n_iters, B)], 1);
      GQ_PHASE(5);
    } else {
      // the owner: its run holds the tile's first iteration, at its end;
      // the later contributors ran the tile's rest at the start of theirs
      const int b_last = block_of(te - 1, p.n_iters, B);
      if (tid == 0) {
        int* cnt = &p.counters[blockIdx.x];
        while (ld_acquire(cnt) != b_last - static_cast<int>(blockIdx.x)) {
        }
        *cnt = 0;
      }
      named_sync<kConsumers>();
      GQ_PHASE(6);
      for (int b = blockIdx.x + 1; b <= b_last; ++b) {
        const int4* part =
            reinterpret_cast<const int4*>(p.ws + b * kPart) + tid;
#pragma unroll
        for (int i = 0; i < kRegs / 4; ++i) {
          const int4 v = __ldcg(part + i * kConsumers);
          acc[4 * i] += v.x;
          acc[4 * i + 1] += v.y;
          acc[4 * i + 2] += v.z;
          acc[4 * i + 3] += v.w;
        }
      }
      write_tile<N>(acc, p, w, ot, mt, tid);
      GQ_PHASE(7);
    }
  }
  GQ_PHASE_END();
}

size_t gemm_smem(int N, int stages) {
  return 1024 + static_cast<size_t>(stages) * (kWStage + N * kStageK) +
         16 * static_cast<size_t>(stages);
}

template <int N>
int launch_w8a8(const GemmMaps& maps, const GemmParams& p, int blocks,
                cudaStream_t stream) {
  static bool smem_set = false;
  int err = set_smem_once(w8a8_gemm_kernel<N>, kMaxSmem, smem_set);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kGemmThreads);
  cfg.dynamicSmemBytes = gemm_smem(N, p.stages);
  cfg.stream = stream;
  // cooperative: all blocks resident at once, as the owners' waits need
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(
      cudaLaunchKernelEx(&cfg, w8a8_gemm_kernel<N>, maps, p));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// w8_bf16_gemm: out[m, o] = (sum_k bf16(y[m,k]) * bf16(wt[o,k])) * s[o],
// f32 accumulation, cast to the output dtype, with the weight K-major
// (O, D).  The activation comes in rounded to bf16, as _qmm_kernel rounds
// it; an int8 weight is exact in bf16 (|w| <= 128 < 2^8), and each
// bf16 x bf16 product is exact in the tensor cores' f32 sums, so only the
// order of the f32 sums differs from the plain version.  Tensor cores:
// mma.sync m16n8k16 (bf16 x bf16 -> f32), the weight as the 16-row A side
// (widened in registers), the activation rows as the 8-wide N side.  Its
// tiles (quant_common.cuh, namespace tc), 4-stage cp.async ring and
// split-K are the mma.sync design w8a8_gemm had before its Hopper
// redesign; a stage holds 128 bytes of each weight row and the matching
// 128 bf16 (256 bytes) of each activation row.  Requires D % 16 == 0
// (checked by the wrapper).

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

// w8_bf16_gemm's split-K across blocks.  Every block stores its partial
// sums (plain stores into ws: one T per (tile, split, register, thread));
// the last
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

// Grid: x = output tile of kTO channels, y = split of D (k_split values
// each, the last one short), z = tile of NT * 8 activation rows.
// ws (split-K only): one f32 partial per (tile, split, register, thread);
// counters: one per (row tile, output tile), zero on entry and on exit.
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

// The dynamic shared memory of a w8a8_gemm block of `rows` activation rows
// and `stages` stages (the wrapper's plan sizes its ring with the same
// sum).
int w8a8_gemm_smem(int rows, int stages) {
  return static_cast<int>(gemm_smem(rows, stages));
}

// n_w (1 to 3) K-major (O_w, D) int8 weights wt_w with their (O_w,) f32
// scales s_w and (M, O_w) outputs out_w, all against one (M, D) int8
// activation yq and its (M,) f32 row scales ys.  rows (activation rows a
// tile: 8, 16, 32, 48, 64, 80, 96, 128, 160, 192, 224 or 256), n_mtiles,
// blocks and stages come from the wrapper's plan
// (kernels/quant_matmul.py:w8a8_plan); ws holds `blocks` slots of
// 128 * rows int32 and counters `blocks` ints, all zero, and the launch
// leaves them zero.  Returns the cudaError_t of the launch, or 10000 +
// the CUresult of a failed tensor-map encode.
int w8a8_gemm(const void* yq, const void* ys, int M, int D, int n_w,
              const void* wt0, const void* wt1, const void* wt2,
              const void* s0, const void* s1, const void* s2, void* out0,
              void* out1, void* out2, int O0, int O1, int O2, int out_bf16,
              int rows, int n_mtiles, int blocks, int stages,
              void* ws, void* counters, void* stream) {
  if (M == 0) return 0;
  if (n_w < 1 || n_w > kMaxW || D < 16 || D % 16 || stages < 2 ||
      stages > kMaxStages || rows < 8 || rows > 256 ||
      gemm_smem(rows, stages) > static_cast<size_t>(kMaxSmem) ||
      n_mtiles != (M + rows - 1) / rows || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!encoder()) return static_cast<int>(cudaErrorNotSupported);
  const void* wts[kMaxW] = {wt0, wt1, wt2};
  const void* ss[kMaxW] = {s0, s1, s2};
  void* outs[kMaxW] = {out0, out1, out2};
  const int Os[kMaxW] = {O0, O1, O2};
  GemmMaps maps = {};
  GemmParams p = {};
  int err = kmajor_map(&maps.act, yq, M, D, rows);
  for (int w = 0; w < n_w && !err; ++w) {
    if (Os[w] < 1) return static_cast<int>(cudaErrorInvalidValue);
    err = kmajor_map(&maps.w[w], wts[w], Os[w], D, kTileO);
    p.s[w] = static_cast<const float*>(ss[w]);
    p.out[w] = outs[w];
    p.O[w] = Os[w];
    p.tile0[w + 1] = p.tile0[w] + (Os[w] + kTileO - 1) / kTileO * n_mtiles;
  }
  if (err) return err;
  for (int w = n_w; w < kMaxW; ++w) p.tile0[w + 1] = p.tile0[n_w];
  p.ys = static_cast<const float*>(ys);
  p.ws = static_cast<int*>(ws);
  p.counters = static_cast<int*>(counters);
  p.M = M;
  p.n_k = (D + kStageK - 1) / kStageK;
  p.n_mtiles = n_mtiles;
  p.stages = stages;
  p.out_bf16 = out_bf16;
  p.n_iters = static_cast<long long>(p.tile0[kMaxW]) * p.n_k;
  if (blocks > p.n_iters) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
#define W8A8_CASE(N_) \
  case N_:            \
    return launch_w8a8<N_>(maps, p, blocks, st);
    W8A8_CASE(8)
    W8A8_CASE(16)
    W8A8_CASE(32)
    W8A8_CASE(48)
    W8A8_CASE(64)
    W8A8_CASE(80)
    W8A8_CASE(96)
    W8A8_CASE(128)
    W8A8_CASE(160)
    W8A8_CASE(192)
    W8A8_CASE(224)
    W8A8_CASE(256)
#undef W8A8_CASE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// y is bf16 (M, D), wt K-major (O, D); the output is bf16 or float32.
// rows (activation rows per block: 8, 16, 32, 64 or 80), k_split and
// n_split come from the wrapper's plan (kernels/quant_matmul.py:gemm_plan);
// ws (float32 partials) and counters are used only when n_split > 1.
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
  switch (rows) {
    case 8: return W8_BF16_LAUNCH(1);
    case 16: return W8_BF16_LAUNCH(2);
    case 32: return W8_BF16_LAUNCH(4);
    case 64: return W8_BF16_LAUNCH(8);
    case 80: return W8_BF16_LAUNCH(10);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef W8_BF16_LAUNCH
}

}  // extern "C"
