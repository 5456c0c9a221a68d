// Hand-written Hopper (sm_90a) decode attention: the rotate-on-read Pallas
// kernels in infinisst_tpu/kernels/decode_attention.py and the beam step's
// two-block attention of JAX's beam_token_step
// (infinisst_tpu/models/llama.py:346-419).  Plain C interface, bound with
// ctypes from infinisst_tpu_torch/kernels/decode_attention.py; no PyTorch
// headers.
//
//   decode_attention_kernel <- _decode_attn_kernel (decode_attention.py:57),
//                              the body of decode_attention (:123, its
//                              pallas_call :152), and
//                              _decode_attn_batched_kernel (:228), the body
//                              of decode_attention_batched (:287, :317): the
//                              same function, so one kernel serves both.
//   beam_attention_kernel   <- the two einsums and the one softmax of
//                              beam_token_step over [prefix | per-beam]
//                              (llama.py:386-416), which the port ran before
//                              as two decode_attention launches and a merge
//                              of their log-sum-exps in torch.
//
// Both are one device function, attend<DH, TC, SECOND>: decode_attention is
// the same kernel with no second block.
//
// Function: one query position per row; half-split Llama RoPE in f32 on q at
// q_pos and on key j at its position (prefix key j at key_offset + j, per-beam
// key j of row b at g_off[b] + j); cos/sin of f32(pos) * inv_freq; scores
// scaled by 1/sqrt(Dh); keys j >= valid masked with -1e9 (not -inf: a fully
// masked row averages V uniformly, as the JAX reference does); one softmax
// over every key the row reads; weighted sum of V; per-row log-sum-exp.  GQA:
// the H/KV query heads of a KV head are rows of one block.  A cache of the
// first block is shared by B / P query rows (row b reads cache b / (B / P));
// the second block is per row.
//
// Bound on the H100: bytes.  Each (cache, KV head) is read once for its
// 16-row tile: 2 * keys * Dh * bytes per KV head, ~4 * rows * keys * Dh
// operations.  Keys past valid get weight exactly 0 once one key is valid
// (exp(-1e9 - m) == 0 in f32), so only min(valid, C) keys are read (all C
// when valid is 0), and the bound counts those bytes.
//
// Design.  The phase split of the split-K kernel it replaced at the flagship beam prefix (B 4,
// 1000 of 1280, H100; tools/attention_phases.py) set this design: a block
// spent 12.7 us on its one 64-key tile (4.2 rotating q and issuing the
// load, 1.6 waiting for it, 3.5 of accurate cosf/sinf on the keys, 1.0 of
// products, 2.5 writing its partial and bumping the counter) and the last
// block of each group 10.9 us more on the combine, against 1.2 us of
// bytes; the beam step then merged its two launches in ~10 torch kernels.
//
// - Work units of 16 keys of one (cache or per-beam buffer, KV head), the
//   prefix's then each row tile's per-beam buffers', in one list, cut into
//   n_split contiguous runs on the card from the valid lengths.  A block is
//   (split, KV head x row tile, cache); its units go through a ring of
//   kStages stages.  One producer warp issues each unit's TMA loads
//   (cp.async.bulk.tensor, K and V boxes of 16 keys and the unit's cos/sin
//   table rows) completing on the stage's full mbarrier; kCWarps consumer
//   warps take units in turn, each warp a unit end to end, and free the
//   stage on its empty mbarrier.  No block barrier inside the key loop (the
//   split-K kernel had four a tile).  A warp takes a stage only after the
//   producer has issued that stage's round (stage_round): with warps taking
//   units in turn, a parity wait alone could pass on the round before.
// - Rotation: the cos/sin of a (position, frequency) comes from a float32
//   table (positions x Dh: cos, sin interleaved) made once by the wrapper
//   from the same f32(pos) * inv_freq: read from L2 by TMA beside the keys,
//   where the split-K kernel spent 3.5 us a tile on accurate cosf/sinf.  A
//   position outside the table is computed with sincosf.  The queries are
//   rotated once a block into bf16 hi and lo tiles in shared memory, which
//   every unit reads with ldmatrix (kept in registers, they spilled at the
//   register budget of two blocks an SM).
// - Tensor cores (bf16 caches): the rotated keys never leave registers.  A
//   warp loads its unit's K with ldmatrix from the 128-byte-swizzled TMA
//   tile (conflict-free), rotates the fragments in f32 (a thread holds both
//   halves of its RoPE pairs), splits them into bf16 hi + lo and runs
//   q.k as hi.hi + hi.lo + lo.hi (mma.sync m16n8k16, ~16 bits kept where one
//   bf16 operand keeps 8); the score fragments become P's A fragments in
//   registers (hi + lo) for P.V, with V by ldmatrix.trans.  mma.sync stays
//   (not wgmma): the products took 1.0 of the 12.7 us of a block, and a
//   unit is 16 query rows by 16 keys, a quarter of wgmma's 64-row tile.  A
//   float32 cache (the tiny model, the tests) runs the same units on the
//   CUDA cores.
// - Splits: the plan aims at 1.5 blocks an SM (two fit, but the clusters'
//   blocks then did not all fit one wave).  One split writes the output
//   from the block, with no workspace.  More splits (up to 16) form a
//   thread block cluster along x: each block keeps its (max, denominator,
//   unnormalised sum) in shared memory and each reduces a slice of the
//   outputs over the cluster's shared memory (DSMEM), in split order, so
//   the result does not depend on the blocks' timing.  No workspace,
//   counter or atomic.
// - The beam step's per-beam block rides in the same launch: its units are
//   masked to the rows of their beam and fold into the same online softmax;
//   one normalised write.
//
// phases: setup: loads and the unit plan; setup: the block barrier; setup: q rotation; wait for a unit's tiles; rotate keys + score products; online softmax; P.V products; warps' partials; block combine (and the write at one split); cluster barrier; cluster combine and write

#include <cooperative_groups.h>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "tma_common.cuh"

#ifndef DA_PHASES
#define DA_PHASE_INIT()
#define DA_PHASE(i)
#define DA_PHASE_END()
#endif

namespace {

namespace cg = cooperative_groups;

constexpr int kCWarps = 4;  // consumer warps; one more warp produces
constexpr int kThreads = 32 * (kCWarps + 1);
constexpr int kRows = 16;    // query rows per block: one m16 tile
constexpr int kUnit = 16;    // keys of a unit (a consumer warp's step)
constexpr int kStages = 6;   // ring depth, in units
constexpr int kMaxSplit = 16;  // splits: a cluster (above 8 non-portable)
constexpr int kMaxBeams = kRows;  // per-beam buffers a row tile reads
constexpr float kMaskedScore = -1e9f;

constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// Shared memory of one block (byte offsets from a 1024-aligned base).  TC:
// bf16 caches, tensor cores; otherwise float32, CUDA cores.  A unit's K (and
// V) tile is DH / kSw sub-tiles of 16 rows of kRowB bytes, swizzled by TMA
// (kRowB 128, 64 or 32: the 128B, 64B or 32B pattern); its cos/sin rows the
// same with float32 rows of kTSw values.
template <int DH, bool TC>
struct Geo {
  using T = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static constexpr int kEs = sizeof(T);
  static constexpr int kSw = DH * kEs > 128 ? 128 / kEs : DH;
  static constexpr int kRowB = kSw * kEs;
  static constexpr int kSub = kUnit * kRowB;
  static constexpr int kNSub = DH / kSw;
  static constexpr int kKV = kUnit * DH * kEs;  // a unit's K, or V
  static constexpr int kTSw = DH > 32 ? 32 : DH;
  static constexpr int kTRowB = kTSw * 4;
  static constexpr int kTSub = kUnit * kTRowB;
  static constexpr int kTNSub = DH / kTSw;
  static constexpr int kTab = kUnit * DH * 4;  // a unit's cos/sin rows
  static constexpr int kStage = round_up(2 * kKV + kTab, 1024);
  static constexpr int kTx = 2 * kKV + kTab;  // bytes TMA brings a unit
  // after the key loop the ring holds the warps' partials: per warp the
  // rows' max and denominator, then (kRows, kWpLd) sums
  static constexpr int kWpLd = DH + 4;
  static constexpr int kWp = (2 * kRows + kRows * kWpLd) * 4;
  // the rotated queries: TC their bf16 hi and lo tiles, (kRows, kQLd)
  // each (rows padded by 16 bytes: conflict-free ldmatrix), read by every
  // unit; CUDA cores f32 (kRows, DH).  After the key loop the block's
  // partial for the cluster (max, denominator, sums) takes their place.
  static constexpr int kQ = kStages * kStage;
  static constexpr int kQLd = DH + 8;
  static constexpr int kQTile = kRows * kQLd * 2;
  static constexpr int kQIn = TC ? 2 * kQTile : kRows * DH * 4;
  static constexpr int kQFin = (2 * kRows + kRows * DH) * 4;
  static constexpr int kQBytes = kQIn > kQFin ? kQIn : kQFin;
  // CUDA cores: per warp P (kRows, kUnit + 1) and the rows' rescale
  static constexpr int kPLd = kUnit + 1;
  static constexpr int kP = kQ + kQBytes;
  static constexpr int kPBytes = TC ? 0 : kCWarps * (kRows * kPLd + kRows) * 4;
  static constexpr int kMeta = kP + kPBytes;  // ints, Meta below
  static constexpr int kMetaBytes = 1024 * 4;
  static constexpr int kBar = kMeta + kMetaBytes;  // full, empty mbarriers
  static constexpr int kBytes = kBar + 2 * kStages * 8 + 1024;  // + align
  static_assert(kCWarps * kWp <= kStages * kStage, "partials fit the ring");
  static_assert(kNSub * kSw == DH && kTNSub * kTSw == DH, "whole sub-tiles");
};

// The block's unit plan, written by warp 0 in the setup (ints in shared
// memory): row tile, the prefix's units, each per-beam buffer's.
struct Meta {
  int u_begin, u_end;  // this split's units
  int n_pc;            // prefix units
  int c_eff;           // prefix keys read
  int p_valid;         // prefix keys at or past it masked (-1e9)
  int p_off;           // position of prefix key 0
  int b_first;         // the tile's first query batch row
  int stage_round[kStages];  // the ring round each stage was last issued
  int row_beam[kRows];         // query batch row of each tile row, -1 past nr
  int gc_start[kMaxBeams + 1];  // cumulative per-beam units
  int g_eff[kMaxBeams];         // per-beam keys read
  int g_valid[kMaxBeams];       // per-beam keys at or past it masked
  int g_off[kMaxBeams];         // position of per-beam key 0
  float row_m[kRows], row_l[kRows];  // the block's rows
  // the partials' maxima, denominators, then weights, by (partial, row)
  float part_m[kMaxSplit][kRows], part_l[kMaxSplit][kRows];
  float wgt[kMaxSplit][kRows];
};

static_assert(sizeof(Meta) <= 1024 * 4, "the plan fits its shared memory");
static_assert(kMaxSplit >= kCWarps, "the warps' weights fit the plan's");

struct Maps {
  CUtensorMap pk, pv;  // (P, C, KV, DH) boxes (1, 16, 1, kSw)
  CUtensorMap gk, gv;  // (B, G, KV, DH), the second block
  CUtensorMap tab;     // (T, DH) float32 cos/sin, boxes (16, kTSw)
};

struct Params {
  const void* q;
  const int* plen;   // (P,) valid prefix keys
  const int* poff;   // (P,) prefix key offsets, or null
  const int* gval;   // (B,) valid per-beam keys
  const int* goff;   // (B,) per-beam key offsets
  const int* qpos;   // (B,)
  const float* inv;  // (DH / 2,)
  const float* table;  // (T, DH)
  void* out;         // (B, H, DH)
  float* lse;        // (B, H) or null
  int B, H, KV, P, C, G, T, n_split;
  float scale;
};

struct Unit {
  int key0;   // first key of the unit in its buffer
  int beam;   // local per-beam buffer, -1 for the prefix
  int limit;  // keys at or past it are not read (-inf)
  int valid;  // keys at or past it are masked (-1e9)
  int pos0;   // position of key0
  int src;    // cache (prefix) or query batch row (per-beam)
};

__device__ __forceinline__ Unit resolve(const Meta& m, int u, int p) {
  if (u < m.n_pc) {
    const int k0 = u * kUnit;
    return {k0, -1, m.c_eff, m.p_valid, m.p_off + k0, p};
  }
  const int v = u - m.n_pc;
  int lb = 0;
  while (v >= m.gc_start[lb + 1]) ++lb;
  const int k0 = (v - m.gc_start[lb]) * kUnit;
  return {k0, lb, m.g_eff[lb], m.g_valid[lb], m.g_off[lb] + k0,
          m.b_first + lb};
}

// byte offset o within a TMA-swizzled sub-tile of ROWB-byte rows
template <int ROWB>
__device__ __forceinline__ int swz(int o) {
  constexpr int kMask = ROWB == 128 ? 7 : (ROWB == 64 ? 3 : 1);
  return o ^ (((o >> 7) & kMask) << 4);
}

// --- tensor-core helpers --------------------------------------------------

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void unpack2(uint32_t v, float* a, float* b) {
  *a = __uint_as_float(v << 16);
  *b = __uint_as_float(v & 0xffff0000u);
}

// two f32 values as (hi pair, lo pair) of packed bf16, a in the low half:
// split_bf16 of each, two packed conversions (cvt.rn.bf16x2.f32 puts its
// first source in the high half)
__device__ __forceinline__ void split_pack(float a, float b, uint32_t* hi,
                                           uint32_t* lo) {
  uint32_t h, l;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(h) : "f"(b), "f"(a));
  const float ra = a - __uint_as_float(h << 16);
  const float rb = b - __uint_as_float(h & 0xffff0000u);
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(l) : "f"(rb), "f"(ra));
  *hi = h;
  *lo = l;
}

__device__ __forceinline__ float load_f32(const void* p, bool bf16,
                                          int64_t i) {
  if (bf16) {
    return __bfloat162float(reinterpret_cast<const __nv_bfloat16*>(p)[i]);
  }
  return reinterpret_cast<const float*>(p)[i];
}

__device__ __forceinline__ void store_out(void* p, bool bf16, int64_t i,
                                          float v) {
  if (bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

// cos, sin of f32(pos) * inv_freq[f] (the table's values, computed)
__device__ __forceinline__ float2 cos_sin(int pos, const float* inv, int f) {
  float s, c;
  sincosf(static_cast<float>(pos) * inv[f], &s, &c);
  return make_float2(c, s);
}

// --- the kernel -------------------------------------------------------------

// Grid: x = split (a cluster along x), y = KV head + KV * row tile, z =
// cache of the first block.
template <int DH, bool TC, bool SECOND>
__device__ __forceinline__ void attend(const Maps& maps, const Params& a) {
  using G = Geo<DH, TC>;
  constexpr int half = DH / 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  Meta& m = *reinterpret_cast<Meta*>(smem + G::kMeta);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + G::kBar);
  uint64_t* empty = full + kStages;
  float* q_s = reinterpret_cast<float*>(smem + G::kQ);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int KV = a.KV, H = a.H, Gq = H / KV;
  const int rpc = a.B / a.P;  // query batch rows of a cache
  const int r_total = rpc * Gq;
  const int p = blockIdx.z;
  const int kvh = blockIdx.y % KV;
  const int r0 = (blockIdx.y / KV) * kRows;
  const int split = blockIdx.x;
  const bool bf16 = TC;
  DA_PHASE_INIT();

  // setup.  Every load it needs is issued before its first wait: warp
  // 0's plan inputs and the consumers' query elements and positions.
  const int nr = min(kRows, r_total - r0);
  const int b_first = p * rpc + r0 / Gq;
  const int nb = SECOND ? p * rpc + (r0 + nr - 1) / Gq - b_first + 1 : 0;
  int pv = 0, p_off = 0, gv = 0, go = 0;
  if (warp == 0) {
    pv = a.plen[p];
    p_off = a.poff ? a.poff[p] : 0;
    if (lane < nb) {
      gv = a.gval[b_first + lane];
      go = a.goff[b_first + lane];
    }
  }
  constexpr int kQItems = (kRows * half + kCWarps * 32 - 1) / (kCWarps * 32);
  float qx1[kQItems], qx2[kQItems];
  int qp[kQItems];
  if (warp < kCWarps) {
#pragma unroll
    for (int it = 0; it < kQItems; ++it) {
      const int idx = tid + it * kCWarps * 32;
      const int i = idx / half, pd = idx % half;
      qx1[it] = qx2[it] = 0.f;
      qp[it] = 0;
      if (idx < kRows * half && i < nr) {
        const int b = p * rpc + (r0 + i) / Gq;
        const int64_t row =
            static_cast<int64_t>(b) * H + kvh * Gq + (r0 + i) % Gq;
        qx1[it] = load_f32(a.q, bf16, row * DH + pd);
        qx2[it] = load_f32(a.q, bf16, row * DH + pd + half);
        qp[it] = a.qpos[b];
      }
    }
  }
  if (warp == 0) {
    if (lane < kRows) {
      m.row_beam[lane] = lane < nr ? p * rpc + (r0 + lane) / Gq : -1;
    }
    int n_gc = 0;
    if (lane < nb) {
      const int ge = gv > 0 ? min(gv, a.G) : a.G;
      m.g_eff[lane] = ge;
      m.g_valid[lane] = gv;
      m.g_off[lane] = go;
      n_gc = (ge + kUnit - 1) / kUnit;
    }
    // inclusive scan of the per-beam units over the lanes
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, n_gc, o);
      if (lane >= o) n_gc += y;
    }
    if (lane < kMaxBeams) m.gc_start[lane + 1] = n_gc;
    const int total_gc = __shfl_sync(0xffffffffu, n_gc, 31);
    if (lane == 0) {
      const int c_eff = pv > 0 ? min(pv, a.C) : a.C;
      const int n_pc = (c_eff + kUnit - 1) / kUnit;
      const int U = n_pc + total_gc;
      const int per = (U + a.n_split - 1) / a.n_split;
      m.gc_start[0] = 0;
      m.n_pc = n_pc;
      m.c_eff = c_eff;
      m.p_valid = pv;
      m.p_off = p_off;
      m.b_first = b_first;
      m.u_begin = min(split * per, U);
      m.u_end = min(split * per + per, U);
      for (int s = 0; s < kStages; ++s) {
        mbar_init(&full[s], 1);
        mbar_init(&empty[s], 1);
        m.stage_round[s] = -1;
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
  }
  DA_PHASE(0);
  __syncthreads();
  DA_PHASE(1);
  const int u_begin = m.u_begin, n_units = m.u_end - m.u_begin;

  // the query row (b * H + head) of tile row i
  auto out_row = [&](int i) -> int64_t {
    return static_cast<int64_t>(m.row_beam[i]) * H + kvh * Gq + (r0 + i) % Gq;
  };

  if (warp == kCWarps) {
    // producer: one thread issues every unit's loads, kStages ahead
    if (lane == 0) {
      for (int k = 0; k < n_units; ++k) {
        const int s = k % kStages;
        if (k >= kStages) mbar_wait(&empty[s], ((k / kStages) - 1) & 1);
        // the stage's previous round is consumed, so loaded: a consumer
        // that reads this round here may wait on the full barrier's parity
        *reinterpret_cast<volatile int*>(&m.stage_round[s]) = k / kStages;
        const Unit u = resolve(m, u_begin + k, p);
        const CUtensorMap* mk = u.beam < 0 ? &maps.pk : &maps.gk;
        const CUtensorMap* mv = u.beam < 0 ? &maps.pv : &maps.gv;
        unsigned char* st = smem + s * G::kStage;
        mbar_expect_tx(&full[s], G::kTx);
#pragma unroll
        for (int j = 0; j < G::kNSub; ++j) {
          tma_load_4d(st + j * G::kSub, mk, &full[s], j * G::kSw, kvh,
                      u.key0, u.src);
          tma_load_4d(st + G::kKV + j * G::kSub, mv, &full[s], j * G::kSw,
                      kvh, u.key0, u.src);
        }
#pragma unroll
        for (int j = 0; j < G::kTNSub; ++j) {
          tma_load_2d(st + 2 * G::kKV + j * G::kTSub, &maps.tab, &full[s],
                      j * G::kTSw, u.pos0);
        }
      }
    }
    __syncwarp();
  } else {
    // the tile's queries rotated into shared memory: TC bf16 hi and lo
    // tiles, CUDA cores f32
#pragma unroll
    for (int it = 0; it < kQItems; ++it) {
      const int idx = tid + it * kCWarps * 32;
      if (idx < kRows * half) {
        const int i = idx / half, pd = idx % half;
        float o1 = 0.f, o2 = 0.f;
        if (i < nr) {
          // the position's table row (L2), or computed past the table
          const float2 cs =
              qp[it] >= 0 && qp[it] < a.T
                  ? *reinterpret_cast<const float2*>(
                        a.table + static_cast<int64_t>(qp[it]) * DH + 2 * pd)
                  : cos_sin(qp[it], a.inv, pd);
          o1 = qx1[it] * cs.x - qx2[it] * cs.y;
          o2 = qx2[it] * cs.x + qx1[it] * cs.y;
        }
        if constexpr (TC) {
          // bf16 hi and lo, as split_pack splits
          __nv_bfloat16* qh = reinterpret_cast<__nv_bfloat16*>(q_s);
          __nv_bfloat16* ql = qh + kRows * G::kQLd;
          const __nv_bfloat16 h1 = __float2bfloat16_rn(o1);
          const __nv_bfloat16 h2 = __float2bfloat16_rn(o2);
          qh[i * G::kQLd + pd] = h1;
          qh[i * G::kQLd + pd + half] = h2;
          ql[i * G::kQLd + pd] =
              __float2bfloat16_rn(o1 - __bfloat162float(h1));
          ql[i * G::kQLd + pd + half] =
              __float2bfloat16_rn(o2 - __bfloat162float(h2));
        } else {
          q_s[i * DH + pd] = o1;
          q_s[i * DH + pd + half] = o2;
        }
      }
    }
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCWarps * 32) : "memory");

    // rows of this thread: TC g and g + 8; CUDA cores (lane >> 4) + 2 e
    constexpr int kMy = TC ? 2 : kRows / 2;
    float row_m[kMy], row_l[kMy];
    int my_beam[kMy];
#pragma unroll
    for (int e = 0; e < kMy; ++e) {
      row_m[e] = -INFINITY;
      row_l[e] = 0.f;
      my_beam[e] = m.row_beam[TC ? g + 8 * e : (lane >> 4) + 2 * e];
    }
    // P.V accumulators: TC the (16, DH) m16n8 fragments; CUDA cores
    // (row, dim) pairs lane + 32 e
    constexpr int kAcc = TC ? DH / 8 : kRows * DH / 32;
    float acc[kAcc][TC ? 4 : 1];
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int e = 0; e < (TC ? 4 : 1); ++e) acc[i][e] = 0.f;
    DA_PHASE(2);

    for (int k = warp; k < n_units; k += kCWarps) {
      const int s = k % kStages;
      // a parity wait tells round r from r - 2 only: the warps take units
      // in turn, so a warp can reach a stage before the warp of its
      // previous round has; wait until the producer has issued this round
      // (it issues round r after round r - 1 was consumed)
      while (*reinterpret_cast<volatile const int*>(&m.stage_round[s]) !=
             k / kStages) {
      }
      mbar_wait(&full[s], (k / kStages) & 1);
      DA_PHASE(3);
      const Unit u = resolve(m, u_begin + k, p);
      unsigned char* st = smem + s * G::kStage;
      const uint32_t kb = smem_u32(st), vb = kb + G::kKV;
      const float* tb = reinterpret_cast<const float*>(st + 2 * G::kKV);
      const bool tab = u.pos0 >= 0 && u.pos0 + kUnit <= a.T;
      const int nval = min(kUnit, u.limit - u.key0);
      // keys past the buffer's limit weigh 0: zero their V rows, so that
      // whatever the cache holds there cannot reach the sums
      if (nval < kUnit) {
        constexpr int kChunks = DH * G::kEs / 16;
        for (int idx = lane; idx < (kUnit - nval) * kChunks; idx += 32) {
          const int j = nval + idx / kChunks, d = (idx % kChunks) * 16 /
                                                  G::kEs;
          *reinterpret_cast<uint4*>(
              st + G::kKV + (d / G::kSw) * G::kSub +
              swz<G::kRowB>(j * G::kRowB + (d % G::kSw) * G::kEs)) =
              make_uint4(0, 0, 0, 0);
        }
        __syncwarp();
      }
      // the (position, frequency) pair's cos, sin at float index 2 f
      auto cs_at = [&](int j, int f) -> float4 {
        if (tab) {
          const int fl = 2 * f;
          return *reinterpret_cast<const float4*>(
              reinterpret_cast<const unsigned char*>(tb) +
              (fl / G::kTSw) * G::kTSub +
              swz<G::kTRowB>(j * G::kTRowB + (fl % G::kTSw) * 4));
        }
        const float2 c0 = cos_sin(u.pos0 + j, a.inv, f);
        const float2 c1 = cos_sin(u.pos0 + j, a.inv, f + 1);
        return make_float4(c0.x, c0.y, c1.x, c1.y);
      };
      // score of key j (of the unit) for a row of query batch row rb
      auto masked = [&](float dot, int j, int rb) {
        const int key = u.key0 + j;
        if (key >= u.limit || (u.beam >= 0 && rb != u.src)) return -INFINITY;
        return key < u.valid ? dot * a.scale : kMaskedScore;
      };

      if constexpr (TC) {
        // K fragments (ldmatrix.x4: keys 0-7 and 8-15, dims lo and hi 8 of
        // a 16-dim step), rotated in f32, split hi + lo, then q.k
        float c[2][4] = {};
        auto k_addr = [&](int ks) {
          const int mi = lane >> 3;
          const int key = ((mi >> 1) << 3) + (lane & 7);
          const int d = (2 * ks + (mi & 1)) * 8;
          return kb + (d / G::kSw) * G::kSub +
                 swz<G::kRowB>(key * G::kRowB + (d % G::kSw) * 2);
        };
        auto rope = [&](uint32_t x1, uint32_t x2, float4 cs, uint32_t* h1,
                        uint32_t* l1, uint32_t* h2, uint32_t* l2) {
          float x1a, x1b, x2a, x2b;
          unpack2(x1, &x1a, &x1b);
          unpack2(x2, &x2a, &x2b);
          split_pack(x1a * cs.x - x2a * cs.y, x1b * cs.z - x2b * cs.w, h1,
                     l1);
          split_pack(x2a * cs.x + x1a * cs.y, x2b * cs.z + x1b * cs.w, h2,
                     l2);
        };
        // the query tile's A fragments of a 16-dim step (hi, lo) by
        // ldmatrix: matrices rows 0-7 / 8-15 by dims 0-7 / 8-15
        const uint32_t qb = smem_u32(q_s) +
                            ((lane & 7) + ((lane >> 3) & 1) * 8) * G::kQLd * 2 +
                            (lane >> 4) * 16;
        auto qk = [&](int ks, const uint32_t (&hi)[4], const uint32_t (&lo)[4]) {
          uint32_t qh[4], ql[4];
          ldsm_x4(qb + ks * 32, qh);
          ldsm_x4(qb + G::kQTile + ks * 32, ql);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            mma_bf16(c[n], qh, lo[2 * n], lo[2 * n + 1]);
            mma_bf16(c[n], ql, hi[2 * n], hi[2 * n + 1]);
            mma_bf16(c[n], qh, hi[2 * n], hi[2 * n + 1]);
          }
        };
        if constexpr (DH >= 32) {
          // a RoPE pair (d, d + DH/2): steps kp and kp + DH/32
#pragma unroll
          for (int kp = 0; kp < DH / 32; ++kp) {
            uint32_t r1[4], r2[4], h1[4], l1[4], h2[4], l2[4];
            ldsm_x4(k_addr(kp), r1);
            ldsm_x4(k_addr(kp + DH / 32), r2);
#pragma unroll
            for (int i = 0; i < 4; ++i) {  // i = 2 n + h: key n*8+g, dims +8h
              const float4 cs =
                  cs_at((i >> 1) * 8 + g, 16 * kp + 8 * (i & 1) + 2 * t4);
              rope(r1[i], r2[i], cs, &h1[i], &l1[i], &h2[i], &l2[i]);
            }
            qk(kp, h1, l1);
            qk(kp + DH / 32, h2, l2);
          }
        } else {
          // DH 16: a pair (d, d + 8) is b0 and b1 of one step
          uint32_t r[4], hi[4], lo[4];
          ldsm_x4(k_addr(0), r);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            const float4 cs = cs_at(n * 8 + g, 2 * t4);
            rope(r[2 * n], r[2 * n + 1], cs, &hi[2 * n], &lo[2 * n],
                 &hi[2 * n + 1], &lo[2 * n + 1]);
          }
          qk(0, hi, lo);
        }
        DA_PHASE(4);

        // online softmax of rows g (rh 0) and g + 8 (rh 1)
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          float v[4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              v[2 * n + e] =
                  masked(c[n][2 * rh + e], n * 8 + 2 * t4 + e, my_beam[rh]);
            }
          float mx = fmaxf(fmaxf(v[0], v[1]), fmaxf(v[2], v[3]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(row_m[rh], mx);
          const float ms = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = expf(row_m[rh] - ms);
          float pr[4], psum = 0.f;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            pr[i] = expf(v[i] - ms);
            psum += pr[i];
          }
          row_l[rh] = row_l[rh] * alpha + psum;
          row_m[rh] = m_new;
#pragma unroll
          for (int nt = 0; nt < kAcc; ++nt) {
            acc[nt][2 * rh] *= alpha;
            acc[nt][2 * rh + 1] *= alpha;
          }
          // A fragments of P: a0 / a1 rows g / g + 8 keys 0-7, a2 / a3
          // keys 8-15
          split_pack(pr[0], pr[1], &ph[rh], &pl[rh]);
          split_pack(pr[2], pr[3], &ph[2 + rh], &pl[2 + rh]);
        }
        DA_PHASE(5);

        // P.V, V fragments by ldmatrix.trans, two n8 dims tiles at a time
#pragma unroll
        for (int nt2 = 0; nt2 < DH / 16; ++nt2) {
          const int key = ((lane >> 3) & 1) * 8 + (lane & 7);
          const int d = (2 * nt2 + (lane >> 4)) * 8;
          uint32_t r[4];
          ldsm_x4_trans(vb + (d / G::kSw) * G::kSub +
                            swz<G::kRowB>(key * G::kRowB + (d % G::kSw) * 2),
                        r);
          mma_bf16(acc[2 * nt2], pl, r[0], r[1]);
          mma_bf16(acc[2 * nt2], ph, r[0], r[1]);
          mma_bf16(acc[2 * nt2 + 1], pl, r[2], r[3]);
          mma_bf16(acc[2 * nt2 + 1], ph, r[2], r[3]);
        }
        DA_PHASE(6);
      } else {
        // CUDA cores, float32: rotate the unit's keys in place (the stage
        // is this warp's), then scores, softmax and P.V by lanes
        auto kptr = [&](int j, int d) {
          return reinterpret_cast<float*>(
              st + (d / G::kSw) * G::kSub +
              swz<G::kRowB>(j * G::kRowB + (d % G::kSw) * 4));
        };
        auto vval = [&](int j, int d) {
          return *reinterpret_cast<const float*>(
              st + G::kKV + (d / G::kSw) * G::kSub +
              swz<G::kRowB>(j * G::kRowB + (d % G::kSw) * 4));
        };
        for (int idx = lane; idx < kUnit * half; idx += 32) {
          const int j = idx / half, pd = idx % half;
          float2 cs;
          if (tab) {
            const int fl = 2 * pd;
            cs = *reinterpret_cast<const float2*>(
                reinterpret_cast<const unsigned char*>(tb) +
                (fl / G::kTSw) * G::kTSub +
                swz<G::kTRowB>(j * G::kTRowB + (fl % G::kTSw) * 4));
          } else {
            cs = cos_sin(u.pos0 + j, a.inv, pd);
          }
          float* p1 = kptr(j, pd);
          float* p2 = kptr(j, pd + half);
          const float x1 = *p1, x2 = *p2;
          *p1 = x1 * cs.x - x2 * cs.y;
          *p2 = x2 * cs.x + x1 * cs.y;
        }
        __syncwarp();
        const int j = lane & 15;
        float sc[kMy];
#pragma unroll
        for (int e = 0; e < kMy; ++e) {
          const float* qi = q_s + ((lane >> 4) + 2 * e) * DH;
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
#pragma unroll
          for (int d = 0; d < DH; d += 4) {
            d0 += qi[d] * *kptr(j, d);
            d1 += qi[d + 1] * *kptr(j, d + 1);
            d2 += qi[d + 2] * *kptr(j, d + 2);
            d3 += qi[d + 3] * *kptr(j, d + 3);
          }
          sc[e] = masked((d0 + d1) + (d2 + d3), j, my_beam[e]);
        }
        DA_PHASE(4);
        float* p_s = reinterpret_cast<float*>(smem + G::kP) +
                     warp * (kRows * G::kPLd + kRows);
        float* alpha_s = p_s + kRows * G::kPLd;
#pragma unroll
        for (int e = 0; e < kMy; ++e) {
          float mx = sc[e];
#pragma unroll
          for (int o = 8; o > 0; o >>= 1) {
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
          }
          const float m_new = fmaxf(row_m[e], mx);
          const float ms = m_new == -INFINITY ? 0.f : m_new;
          const float alpha = expf(row_m[e] - ms);
          const float pr = expf(sc[e] - ms);
          row_l[e] = row_l[e] * alpha + pr;
          row_m[e] = m_new;
          const int r = (lane >> 4) + 2 * e;
          p_s[r * G::kPLd + j] = pr;
          if (j == 0) alpha_s[r] = alpha;
        }
        __syncwarp();
        DA_PHASE(5);
#pragma unroll
        for (int e = 0; e < kAcc; ++e) {
          const int idx = lane + 32 * e;
          const int r = idx / DH, d = idx % DH;
          float o = acc[e][0] * alpha_s[r];
#pragma unroll
          for (int jj = 0; jj < kUnit; ++jj) {
            o += p_s[r * G::kPLd + jj] * vval(jj, d);
          }
          acc[e][0] = o;
        }
        __syncwarp();
        DA_PHASE(6);
      }
      // this thread's writes to the stage (the zeroed rows, the float32
      // rotation) ordered before the next TMA write into it
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // this warp's denominators: the sum over the lanes that share a row
#pragma unroll
    for (int e = 0; e < kMy; ++e) {
      if constexpr (TC) {
        row_l[e] += __shfl_xor_sync(0xffffffffu, row_l[e], 1);
        row_l[e] += __shfl_xor_sync(0xffffffffu, row_l[e], 2);
      } else {
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) {
          row_l[e] += __shfl_xor_sync(0xffffffffu, row_l[e], o);
        }
      }
    }
    // every consumer is past its last unit before the ring is overwritten
    asm volatile("bar.sync 1, %0;\n" ::"n"(kCWarps * 32) : "memory");
    float* wp = reinterpret_cast<float*>(smem + warp * G::kWp);
    float* wo = wp + 2 * kRows;
    if constexpr (TC) {
      if (t4 == 0) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          wp[g + 8 * rh] = row_m[rh];
          wp[kRows + g + 8 * rh] = row_l[rh];
        }
      }
#pragma unroll
      for (int nt = 0; nt < kAcc; ++nt) {
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          *reinterpret_cast<float2*>(
              wo + (g + 8 * rh) * G::kWpLd + nt * 8 + 2 * t4) =
              make_float2(acc[nt][2 * rh], acc[nt][2 * rh + 1]);
        }
      }
    } else {
      if ((lane & 15) == 0) {
#pragma unroll
        for (int e = 0; e < kMy; ++e) {
          wp[(lane >> 4) + 2 * e] = row_m[e];
          wp[kRows + (lane >> 4) + 2 * e] = row_l[e];
        }
      }
#pragma unroll
      for (int e = 0; e < kAcc; ++e) {
        const int idx = lane + 32 * e;
        wo[(idx / DH) * G::kWpLd + idx % DH] = acc[e][0];
      }
    }
  }
  __syncthreads();
  DA_PHASE(7);

  // n partials of the tile's rows into one: per (partial, row) the max and
  // denominator gathered into the plan's arrays (get(s, i) -> (m, l)),
  // then per row the weights exp(m_s - M), in partial order; a partial
  // that saw no key of a row weighs 0
  auto row_weights = [&](int n, auto get) {
    for (int t = tid; t < n * kRows; t += kThreads) {
      const float2 ml = get(t / kRows, t % kRows);
      m.part_m[t / kRows][t % kRows] = ml.x;
      m.part_l[t / kRows][t % kRows] = ml.y;
    }
    __syncthreads();
    if (tid < kRows) {
      float M = -INFINITY;
      for (int s = 0; s < n; ++s) M = fmaxf(M, m.part_m[s][tid]);
      float L = 0.f;
      for (int s = 0; s < n; ++s) {
        const float wt =
            M == -INFINITY ? 0.f : expf(m.part_m[s][tid] - M);
        m.wgt[s][tid] = wt;
        L += m.part_l[s][tid] * wt;
      }
      m.row_m[tid] = M;
      m.row_l[tid] = L;
    }
    __syncthreads();
  };

  // the warps' partials (in the ring) into the block's
  row_weights(kCWarps, [&](int w, int i) {
    const float* wp = reinterpret_cast<const float*>(smem + w * G::kWp);
    return make_float2(wp[i], wp[kRows + i]);
  });
  const int n_split = a.n_split;
  float* fin = q_s;  // the block's partial: max, denominator, sums
  // four outputs (i, d..d+3) a step
  auto store4 = [&](int i, int d, float4 o) {
    const float l = fmaxf(m.row_l[i], 1e-30f);
    const int64_t at = out_row(i) * DH + d;
    store_out(a.out, bf16, at, o.x / l);
    store_out(a.out, bf16, at + 1, o.y / l);
    store_out(a.out, bf16, at + 2, o.z / l);
    store_out(a.out, bf16, at + 3, o.w / l);
  };
  auto fma4 = [](float4& o, float4 v, float w) {
    o.x += v.x * w;
    o.y += v.y * w;
    o.z += v.z * w;
    o.w += v.w * w;
  };
  for (int idx = 4 * tid; idx < nr * DH; idx += 4 * kThreads) {
    const int i = idx / DH, d = idx % DH;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int w = 0; w < kCWarps; ++w) {
      fma4(o, *reinterpret_cast<const float4*>(
                  smem + w * G::kWp + (2 * kRows + i * G::kWpLd + d) * 4),
           m.wgt[w][i]);
    }
    if (n_split == 1) {
      store4(i, d, o);
    } else {
      *reinterpret_cast<float4*>(fin + 2 * kRows + idx) = o;
    }
  }
  if (tid < nr) {
    if (n_split == 1) {
      if (a.lse) a.lse[out_row(tid)] = m.row_m[tid] + logf(m.row_l[tid]);
    } else {
      fin[tid] = m.row_m[tid];
      fin[kRows + tid] = m.row_l[tid];
    }
  }
  if (n_split == 1) {
    DA_PHASE(8);
    DA_PHASE_END();
    return;
  }

  // the cluster's combine: block r of the cluster writes outputs
  // [r E / n, (r + 1) E / n) of the E = nr * DH, from every block's partial
  // in split order, read from its shared memory (DSMEM)
  DA_PHASE(8);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  DA_PHASE(9);
  const int rank = static_cast<int>(cluster.block_rank());
  row_weights(n_split, [&](int s, int i) {
    const float* f = cluster.map_shared_rank(fin, s);
    return make_float2(f[i], f[kRows + i]);
  });
  if (rank == 0 && a.lse && tid < nr) {
    a.lse[out_row(tid)] = m.row_m[tid] + logf(m.row_l[tid]);
  }
  const int E4 = nr * DH / 4;  // in fours
  const int e0 = rank * E4 / n_split, e1 = (rank + 1) * E4 / n_split;
  for (int q4 = e0 + tid; q4 < e1; q4 += kThreads) {
    const int idx = 4 * q4, i = idx / DH, d = idx % DH;
    float4 v[kMaxSplit];
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      if (s < n_split) {
        v[s] = *reinterpret_cast<const float4*>(
            cluster.map_shared_rank(fin, s) + 2 * kRows + idx);
      }
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s = 0; s < kMaxSplit; ++s) {
      if (s < n_split) fma4(o, v[s], m.wgt[s][i]);
    }
    store4(i, d, o);
  }
  DA_PHASE(10);
  // no block leaves while another may still read its shared memory
  cluster.sync();
  DA_PHASE_END();
}

template <int DH, bool TC>
__global__ void __launch_bounds__(kThreads, TC ? 2 : 1)
    decode_attention_kernel(const __grid_constant__ Maps maps, const Params a) {
  attend<DH, TC, false>(maps, a);
}

template <int DH, bool TC>
__global__ void __launch_bounds__(kThreads, TC ? 2 : 1)
    beam_attention_kernel(const __grid_constant__ Maps maps, const Params a) {
  attend<DH, TC, true>(maps, a);
}

// --- host: tensor maps and the launch ---------------------------------------

// a (N, L, KV, DH) cache: boxes of 16 keys of one KV head, kSw wide
template <int DH, bool TC>
int cache_map(CUtensorMap* map, const void* base, int N, int L, int KV) {
  using G = Geo<DH, TC>;
  const cuuint64_t es = G::kEs;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(KV),
                              static_cast<cuuint64_t>(L),
                              static_cast<cuuint64_t>(N)};
  const cuuint64_t strides[3] = {DH * es, KV * DH * es,
                                 static_cast<cuuint64_t>(L) * KV * DH * es};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(G::kSw), 1, kUnit, 1};
  const cuuint32_t estr[4] = {1, 1, 1, 1};
  const CUresult r = encoder()(
      map,
      TC ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
      4, const_cast<void*>(base), dims, strides, box, estr,
      CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle_of(G::kRowB),
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int DH, bool TC>
int table_map(CUtensorMap* map, const void* base, int T) {
  using G = Geo<DH, TC>;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(DH),
                              static_cast<cuuint64_t>(T)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(DH) * 4};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(G::kTSw), kUnit};
  const cuuint32_t estr[2] = {1, 1};
  const CUresult r = encoder()(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims,
      strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
      swizzle_of(G::kTRowB), CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kErrEncode + static_cast<int>(r);
}

template <int DH, bool TC>
int launch(const void* pk, const void* pv, const void* gk, const void* gv,
           const Params& a, cudaStream_t stream) {
  using G = Geo<DH, TC>;
  if (!encoder()) return static_cast<int>(cudaErrorNotSupported);
  Maps maps = {};
  int err = cache_map<DH, TC>(&maps.pk, pk, a.P, a.C, a.KV);
  if (!err) err = cache_map<DH, TC>(&maps.pv, pv, a.P, a.C, a.KV);
  if (!err && a.G > 0) err = cache_map<DH, TC>(&maps.gk, gk, a.B, a.G, a.KV);
  if (!err && a.G > 0) err = cache_map<DH, TC>(&maps.gv, gv, a.B, a.G, a.KV);
  if (!err) err = table_map<DH, TC>(&maps.tab, a.table, a.T);
  if (err) return err;
  const bool second = a.G > 0;
  void (*kernel)(const Maps, const Params) =
      second ? beam_attention_kernel<DH, TC> : decode_attention_kernel<DH, TC>;
  // set once per kernel, whatever the size: the opt-in above 48 KB
  static bool attrs_set[2] = {false, false};
  if (!attrs_set[second]) {
    err = static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::kBytes));
    if (!err) {
      err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1));
    }
    if (!err) {  // the most shared memory: two blocks an SM
      err = static_cast<int>(cudaFuncSetAttribute(
          kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared));
    }
    if (err) return err;
    attrs_set[second] = true;
  }
  const int r_total = (a.B / a.P) * (a.H / a.KV);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.n_split, a.KV * ((r_total + kRows - 1) / kRows), a.P);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = G::kBytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, maps, a));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int decode_attention_rows_per_block() { return kRows; }

int decode_attention_unit() { return kUnit; }

int decode_attention_max_split() { return kMaxSplit; }

// One launch of either kernel: the first block (pk, pv: (P, C, KV, Dh),
// valid plen (P,), key offsets poff (P,) or null) and, with G > 0, the
// per-beam block (gk, gv: (B, G, KV, Dh), valid gval (B,), key offsets
// goff (B,)); q (B, H, Dh) at qpos (B,); table (T, Dh) float32 cos/sin by
// position.  Returns the cudaError_t of the launch (0 = success), or
// 10000 + the CUresult of a failed tensor-map encode.  The wrapper checks
// shapes, dtypes, alignment and Dh (16, 32, 64 or 128) before calling;
// n_split comes from its plan (kernels/decode_attention.py:plan).
int attention(const void* q, const void* pk, const void* pv, const void* plen,
              const void* poff, const void* gk, const void* gv,
              const void* gval, const void* goff, const void* qpos,
              const void* inv, const void* table, int T, void* out, void* lse,
              int is_bf16, int B, int H, int KV, int Dh, int P, int C, int G,
              int n_split, float scale, void* stream) {
  if (B == 0 || C == 0) return 0;
  if (P < 1 || B % P || KV < 1 || H % KV || T < kUnit || G < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_split < 1 || n_split > kMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params a = {q,
              static_cast<const int*>(plen),
              static_cast<const int*>(poff),
              static_cast<const int*>(gval),
              static_cast<const int*>(goff),
              static_cast<const int*>(qpos),
              static_cast<const float*>(inv),
              static_cast<const float*>(table),
              out,
              static_cast<float*>(lse),
              B, H, KV, P, C, G, T, n_split, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_LAUNCH(DH_, TC_) return launch<DH_, TC_>(pk, pv, gk, gv, a, st)
#define DA_CASE(DH_)        \
  case DH_:                 \
    if (is_bf16) {          \
      DA_LAUNCH(DH_, true); \
    }                       \
    DA_LAUNCH(DH_, false)
  switch (Dh) {
    DA_CASE(16);
    DA_CASE(32);
    DA_CASE(64);
    DA_CASE(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_CASE
#undef DA_LAUNCH
}

}  // extern "C"
