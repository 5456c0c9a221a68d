// Hand-written Hopper (sm_90a) port of the rotate-on-read decode attention
// Pallas kernels in infinisst_tpu/kernels/decode_attention.py.  Plain C
// interface, bound with ctypes from
// infinisst_tpu_torch/kernels/decode_attention.py; no PyTorch headers.
//
//   decode_attention  <- _decode_attn_kernel (decode_attention.py:57), the
//                        body of decode_attention (:123), and
//                        _decode_attn_batched_kernel (:228), the body of
//                        decode_attention_batched (:287): the same function,
//                        so one kernel serves both.
//
// Function: one query position per row; half-split Llama RoPE applied in
// f32 registers to q at q_pos and to key j at position key_offset + j
// (freqs = f32(pos) * inv_freq, accurate cosf/sinf); scores scaled by
// 1/sqrt(Dh); keys j >= valid_len masked with -1e9 (not -inf: a fully
// masked cache averages V uniformly, as the JAX reference does); softmax;
// weighted sum of V.  GQA: the H/KV query heads of a KV head are rows of
// one block.  Generalisations the beam step needs: a cache shared by a
// group of B / Bc query batch rows, row b reading cache b / (B / Bc) (the
// single-stream beam prefix, Bc = 1, read once for all beams; the serving
// pool's prefix, one cache a slot, read once for that slot's beams), a
// per-cache key-position offset (the per-beam block's key j sits at
// plen + j), and a per-row log-sum-exp output so that two blocks can be
// merged.
//
// Bound on the H100: the K and V bytes of the cache it reads
// (2 * C * KV * Dh * bytes per cache batch) against ~4 * R * C * Dh flops
// for R = B / Bc * H / KV query rows per (cache, KV head).  Keys past
// valid_len get weight exactly 0 once one key is valid (exp(-1e9 - m) == 0
// in f32), so the kernel reads only min(valid_len, C) keys (all C when
// valid_len is 0), and the bound counts those bytes.
//
// Design (the Hopper redesign).  The TPU kernel walks key tiles in order
// with its running max/denominator in VMEM scratch; here blocks run in
// parallel.  One block per (cache batch, KV head, split) holds every query
// row that reads that cache and KV head, 16 rows, one m16 tensor-core tile
// (the beam prefix's 4 beams x 4 heads exactly, and so a pool slot's;
// fewer rows are padded, more take further row tiles), so each key is read
// and rotated once per call and KV head.  The keys [0, c_eff) of a cache are cut on the card into
// n_split contiguous splits of at least 64 keys (the host asks for about
// one block per SM); a block walks its split in tiles of 64 keys (32 in
// float32) that cp.async fetches 16 bytes a thread, double buffered.  Each
// key tile is rotated once in shared memory, computing each (position,
// frequency) pair's cosf/sinf once.  For bf16 caches the scores and P.V
// run on the tensor cores (mma.sync m16n8k16, f32 accumulators); the
// rotated q and k and the probabilities are each split into bf16 hi + lo
// and the products hi.hi + hi.lo + lo.hi (scores) and (hi + lo).V keep
// about 16 bits, where one bf16 operand would keep 8 (the output and the
// f32 log-sum-exp are held to 2^-7 and 1e-5 of the plain version).  A
// float32 cache (the tiny model, the tests) keeps CUDA-core f32 arithmetic
// with the same tiles.  A block writes its partial (max, denominator,
// unnormalised sum) to a workspace; the last block of a (cache batch, KV
// head, row tile) to finish -- counted with an atomic counter that it
// resets, so the counters need no zeroing per call -- combines the splits
// in a fixed order, so the result does not depend on which block finished
// last.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;       // query rows per block: one m16 tile
constexpr int kMinSplit = 64;   // keys per split, at least
constexpr int kSplitAlign = 16; // split lengths are multiples of this
constexpr int kMaxSplit = 64;   // splits per cache and KV head, at most
constexpr float kMaskedScore = -1e9f;

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

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) {
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  return v;
}

// Half-split RoPE of the pair (x1 = x[p], x2 = x[p + Dh/2]) at ``pos``.
__device__ __forceinline__ void rope_pair(float x1, float x2, int pos,
                                          float inv_freq, float* o1,
                                          float* o2) {
  const float f = static_cast<float>(pos) * inv_freq;
  const float c = cosf(f), s = sinf(f);
  *o1 = x1 * c - x2 * s;
  *o2 = x2 * c + x1 * s;
}

// Keys [begin, end) of split ``s`` when a cache's c_eff keys are cut into
// n_split splits (kernels/decode_attention.py:split_range mirrors it).
__device__ __forceinline__ int split_len(int c_eff, int n_split) {
  const int per = (c_eff + n_split - 1) / n_split;
  return max(kMinSplit, (per + kSplitAlign - 1) / kSplitAlign * kSplitAlign);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// c += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// B fragment of m16n8k16 from a row-major (k x n) bf16 tile: rows
// k0..k0+15 at ``row`` (lanes 0-15 give the row addresses), 8 columns
__device__ __forceinline__ void ldmatrix_x2_trans(const void* row,
                                                  uint32_t* b0,
                                                  uint32_t* b1) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(*b0), "=r"(*b1)
               : "r"(a));
}

// x = hi + lo in two bf16 (hi rounded to nearest, lo the rounded rest):
// products of such pairs keep about 16 bits, where one bf16 keeps 8
__device__ __forceinline__ void split_bf16(float x, __nv_bfloat16* hi,
                                           __nv_bfloat16* lo) {
  *hi = __float2bfloat16_rn(x);
  *lo = __float2bfloat16_rn(x - __bfloat162float(*hi));
}

__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 a, __nv_bfloat16 b) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(a)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(b)) << 16);
}

// Shared memory of one block (byte offsets).  TC: bf16 cache, tensor
// cores; otherwise float32 cache, CUDA cores.  Rows of the K/V tiles are
// padded by 16 bytes so that a warp's fragment loads hit distinct banks.
template <int DH, bool TC>
struct Layout {
  using T = typename std::conditional<TC, __nv_bfloat16, float>::type;
  static constexpr int kTK = TC ? 64 : 32;        // keys per tile
  static constexpr int kLd = DH + 16 / sizeof(T);  // tile row, elements
  static constexpr int kPLd = kTK + 8;            // P row (TC), elements
  static constexpr size_t q = 0;                  // f32 (kRows, DH)
  static constexpr size_t k = q + sizeof(float) * kRows * DH;  // 2 tiles
  static constexpr size_t v = k + sizeof(T) * 2 * kTK * kLd;   // 2 tiles
  static constexpr size_t klo = v + sizeof(T) * 2 * kTK * kLd;  // TC
  static constexpr size_t s = klo + (TC ? 2 * kTK * kLd : 0);  // f32 scores
  static constexpr size_t p = s + sizeof(float) * kRows * kTK;  // TC hi, lo
  static constexpr size_t stats = p + (TC ? 2 * 2 * kRows * kPLd : 0);
  static constexpr size_t bytes = stats + sizeof(float) * 3 * kRows;
  // the combine's split weights reuse the K tiles
  static_assert(sizeof(T) * 2 * kTK * kLd >= sizeof(float) * kRows * kMaxSplit,
                "the K tiles hold the combine's weights");
};

// Grid: x = split, y = KV head * n_rtiles + row tile, z = cache batch.
// q (B, H, DH); k, v (Bc, C, KV, DH) with Bc dividing B: query row b
// reads cache b / (B / Bc);
// valid, koff (Bc,) int32 (koff may be null); qpos (B,) int32;
// out (B, H, DH); lse (B, H) f32 or null.  Workspace (n_split > 1 only):
// ws_m, ws_l (B*H*n_split), ws_acc (B*H*n_split*DH); counters, one per
// (cache batch, KV head, row tile), zero on entry and left zero.
template <int DH, bool TC>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v,
                        const int* __restrict__ valid,
                        const int* __restrict__ qpos,
                        const int* __restrict__ koff,
                        const float* __restrict__ inv_freq,
                        void* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ ws_m, float* __restrict__ ws_l,
                        float* __restrict__ ws_acc, int* __restrict__ counters,
                        int B, int H, int KV, int Bc, int C, int n_split,
                        float scale) {
  using L = Layout<DH, TC>;
  using T = typename L::T;
  constexpr int TK = L::kTK, LD = L::kLd, PLD = L::kPLd;
  constexpr int half = DH / 2;
  constexpr int is_bf16 = TC ? 1 : 0;
  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem + L::q);
  T* k_s = reinterpret_cast<T*>(smem + L::k);
  T* v_s = reinterpret_cast<T*>(smem + L::v);
  __nv_bfloat16* klo_s = reinterpret_cast<__nv_bfloat16*>(smem + L::klo);
  float* s_s = reinterpret_cast<float*>(smem + L::s);
  __nv_bfloat16* phi_s = reinterpret_cast<__nv_bfloat16*>(smem + L::p);
  __nv_bfloat16* plo_s = phi_s + kRows * PLD;
  float* row_m = reinterpret_cast<float*>(smem + L::stats);
  float* row_l = row_m + kRows;
  float* row_alpha = row_l + kRows;
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int Gq = H / KV;
  const int rows_per_cache = B / Bc;  // query batch rows of one cache
  const int R_total = rows_per_cache * Gq;
  const int bc = blockIdx.z;
  const int kvh = blockIdx.y % KV;
  const int r0 = (blockIdx.y / KV) * kRows;
  const int split = blockIdx.x;
  const int nr = min(kRows, R_total - r0);

  // query row (b * H + head) and batch of local row i
  auto row_of = [&](int i, int* b_out) {
    const int rr = r0 + i;
    const int b = bc * rows_per_cache + rr / Gq;
    *b_out = b;
    return b * H + kvh * Gq + rr % Gq;
  };

  const int vr = valid[bc];
  const int c_eff = vr > 0 ? min(vr, C) : C;
  const int len = split_len(c_eff, n_split);
  const int k_begin = split * len;
  const int k_end = min(k_begin + len, c_eff);
  const int off = koff ? koff[bc] : 0;
  const int64_t kv_stride = (int64_t)KV * DH;  // between keys
  const int64_t cache_base = ((int64_t)bc * C * KV + kvh) * DH;
  const T* kg = reinterpret_cast<const T*>(k);
  const T* vg = reinterpret_cast<const T*>(v);

  // K and V rows of keys [t0, t0 + TK) into tile slot ``slot``, 16 bytes
  // a thread at a time; keys at or past k_end are zero-filled
  auto load_tile = [&](int slot, int t0) {
    constexpr int kEl = 16 / sizeof(T);
    constexpr int kChunks = DH / kEl;
    T* dk = k_s + slot * TK * LD;
    T* dv = v_s + slot * TK * LD;
    for (int i = tid; i < TK * kChunks; i += kThreads) {
      const int j = i / kChunks, c = i % kChunks;
      const int key = t0 + j;
      const bool ok = key < k_end;
      const int64_t src =
          cache_base + (int64_t)(ok ? key : k_begin) * kv_stride + c * kEl;
      cp_async16(dk + j * LD + c * kEl, kg + src, ok);
      cp_async16(dv + j * LD + c * kEl, vg + src, ok);
    }
  };
  if (k_begin < k_end) load_tile(0, k_begin);
  cp_async_commit();

  // rotated, unscaled query rows; padding rows are zero
  for (int idx = tid; idx < kRows * half; idx += kThreads) {
    const int i = idx / half, p = idx % half;
    float o1 = 0.f, o2 = 0.f;
    if (i < nr) {
      int b;
      const int64_t row = row_of(i, &b);
      rope_pair(load_f32(q, is_bf16, row * DH + p),
                load_f32(q, is_bf16, row * DH + p + half), qpos[b],
                inv_freq[p], &o1, &o2);
    }
    q_s[i * DH + p] = o1;
    q_s[i * DH + p + half] = o2;
  }
  if (tid < kRows) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  __syncthreads();

  // TC: the query tile's A fragments, hi and lo, held for the whole call
  constexpr int kKs = TC ? DH / 16 : 1;
  uint32_t qf[kKs][2][4];
  if constexpr (TC) {
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = g + (e & 1) * 8;
        const int col = ks * 16 + 2 * t4 + (e >> 1) * 8;
        __nv_bfloat16 h0, l0, h1, l1;
        split_bf16(q_s[row * DH + col], &h0, &l0);
        split_bf16(q_s[row * DH + col + 1], &h1, &l1);
        qf[ks][0][e] = pack2(h0, h1);
        qf[ks][1][e] = pack2(l0, l1);
      }
    }
  }
  // P.V accumulators.  TC: warp w owns the head-dimension n8 tiles w,
  // w + kWarps, ...; CUDA cores: thread tid owns dimension tid % DH of
  // rows tid / DH + i * (kThreads / DH).
  constexpr int kPvTiles = TC ? (DH / 8 + kWarps - 1) / kWarps : 1;
  constexpr int kRowsPer = TC ? 1 : kRows * DH / kThreads;
  float acc_tc[kPvTiles][4];
  float acc_cc[kRowsPer];
#pragma unroll
  for (int i = 0; i < kPvTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_tc[i][e] = 0.f;
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) acc_cc[i] = 0.f;

  int it = 0;
  for (int t0 = k_begin; t0 < k_end; t0 += TK, ++it) {
    const int slot = it & 1;
    cp_async_wait_all();
    __syncthreads();  // tile ``it`` landed; tile it - 1 is fully used
    if (t0 + TK < k_end) load_tile(slot ^ 1, t0 + TK);
    cp_async_commit();
    T* kt = k_s + slot * TK * LD;
    const T* vt = v_s + slot * TK * LD;
    const int nk = min(TK, k_end - t0);

    // rotate the tile's keys in place: each (position, frequency) pair
    // once per call per KV head (TC: the rotated key as bf16 hi + lo)
#pragma unroll 4
    for (int idx = tid; idx < TK * half; idx += kThreads) {
      const int j = idx / half, p = idx % half;
      float o1 = 0.f, o2 = 0.f;
      if (j < nk) {
        rope_pair(to_f32(kt[j * LD + p]), to_f32(kt[j * LD + p + half]),
                  off + t0 + j, inv_freq[p], &o1, &o2);
      }
      if constexpr (TC) {
        split_bf16(o1, &kt[j * LD + p], &klo_s[j * LD + p]);
        split_bf16(o2, &kt[j * LD + p + half], &klo_s[j * LD + p + half]);
      } else {
        kt[j * LD + p] = o1;
        kt[j * LD + p + half] = o2;
      }
    }
    __syncthreads();

    // scores of the 16 rows against the tile's keys, scaled and masked
    auto masked = [&](float dot, int j) {
      const int key = t0 + j;
      return key < k_end ? (key < vr ? dot * scale : kMaskedScore)
                         : -INFINITY;
    };
    if constexpr (TC) {
      // warp w: keys [w * kKeysW, (w + 1) * kKeysW), in n8 tiles; q.k as
      // hi.hi + hi.lo + lo.hi
      constexpr int kKeysW = TK / kWarps;
      static_assert(kKeysW % 8 == 0, "whole n8 key tiles per warp");
#pragma unroll
      for (int nt = 0; nt < kKeysW / 8; ++nt) {
        const int kb = warp * kKeysW + nt * 8;
        float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int ks = 0; ks < kKs; ++ks) {
          const int e0 = (kb + g) * LD + ks * 16 + 2 * t4;
          const uint32_t bh0 = *reinterpret_cast<const uint32_t*>(kt + e0);
          const uint32_t bh1 =
              *reinterpret_cast<const uint32_t*>(kt + e0 + 8);
          const uint32_t bl0 =
              *reinterpret_cast<const uint32_t*>(klo_s + e0);
          const uint32_t bl1 =
              *reinterpret_cast<const uint32_t*>(klo_s + e0 + 8);
          mma_bf16(c, qf[ks][0], bl0, bl1);
          mma_bf16(c, qf[ks][1], bh0, bh1);
          mma_bf16(c, qf[ks][0], bh0, bh1);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = g + (e >> 1) * 8, j = kb + 2 * t4 + (e & 1);
          s_s[row * TK + j] = masked(c[e], j);
        }
      }
    } else {
      for (int idx = tid; idx < kRows * TK; idx += kThreads) {
        const int i = idx / TK, j = idx % TK;
        const float* qi = q_s + i * DH;
        const T* kj = kt + j * LD;
        float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // four FMA chains
#pragma unroll
        for (int d = 0; d < DH; d += 4) {
          d0 += qi[d] * to_f32(kj[d]);
          d1 += qi[d + 1] * to_f32(kj[d + 1]);
          d2 += qi[d + 2] * to_f32(kj[d + 2]);
          d3 += qi[d + 3] * to_f32(kj[d + 3]);
        }
        s_s[idx] = masked((d0 + d1) + (d2 + d3), j);
      }
    }
    __syncthreads();

    // online softmax, one warp per row; every tile holds a real key, so
    // the new max is finite and exp(-inf) gives the padding weight 0
    for (int i = warp; i < kRows; i += kThreads / 32) {
      float mx = -INFINITY;
      for (int j = lane; j < TK; j += 32) mx = fmaxf(mx, s_s[i * TK + j]);
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float psum = 0.f;
      for (int j = lane; j < TK; j += 32) {
        const float p = expf(s_s[i * TK + j] - m_new);
        psum += p;
        if constexpr (TC) {
          split_bf16(p, &phi_s[i * PLD + j], &plo_s[i * PLD + j]);
        } else {
          s_s[i * TK + j] = p;
        }
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[i] = alpha;
        row_l[i] = row_l[i] * alpha + psum;
        row_m[i] = m_new;
      }
    }
    __syncthreads();

    // P.V
    if constexpr (TC) {
      const float a_lo = row_alpha[g], a_hi = row_alpha[g + 8];
#pragma unroll
      for (int i = 0; i < kPvTiles; ++i) {
        acc_tc[i][0] *= a_lo;
        acc_tc[i][1] *= a_lo;
        acc_tc[i][2] *= a_hi;
        acc_tc[i][3] *= a_hi;
      }
      const int n_ks = (nk + 15) / 16;  // key steps holding a real key
      for (int ks = 0; ks < n_ks; ++ks) {
        uint32_t ph[4], pl[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int e0 = (g + (e & 1) * 8) * PLD + ks * 16 + 2 * t4 +
                         (e >> 1) * 8;
          ph[e] = *reinterpret_cast<const uint32_t*>(phi_s + e0);
          pl[e] = *reinterpret_cast<const uint32_t*>(plo_s + e0);
        }
#pragma unroll
        for (int i = 0; i < kPvTiles; ++i) {
          const int nt = warp + kWarps * i;
          if (nt < DH / 8) {
            uint32_t b0, b1;
            ldmatrix_x2_trans(vt + (ks * 16 + (lane & 15)) * LD + nt * 8,
                              &b0, &b1);
            mma_bf16(acc_tc[i], pl, b0, b1);
            mma_bf16(acc_tc[i], ph, b0, b1);
          }
        }
      }
    } else {
      const int d = tid % DH;
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i) {
        acc_cc[i] *= row_alpha[tid / DH + i * (kThreads / DH)];
      }
      for (int j = 0; j < nk; ++j) {
        const float vj = to_f32(vt[j * LD + d]);
#pragma unroll
        for (int i = 0; i < kRowsPer; ++i) {
          acc_cc[i] += s_s[(tid / DH + i * (kThreads / DH)) * TK + j] * vj;
        }
      }
    }
  }
  cp_async_wait_all();

  // this block's result: the output itself (one split), or its partial
  // (max, denominator, unnormalised sum); an empty split (past valid_len)
  // has max -inf, denominator 0 and sum 0, and so weight 0 in the combine
  auto emit = [&](int i, int d, float a) {
    if (i >= nr) return;
    int b;
    const int64_t row = row_of(i, &b);
    if (n_split == 1) {
      store_out(out, is_bf16, row * DH + d, a / fmaxf(row_l[i], 1e-30f));
    } else {
      ws_acc[(row * n_split + split) * DH + d] = a;
    }
  };
  if constexpr (TC) {
#pragma unroll
    for (int i = 0; i < kPvTiles; ++i) {
      const int nt = warp + kWarps * i;
      if (nt < DH / 8) {
        const int d0 = nt * 8 + 2 * t4;
        emit(g, d0, acc_tc[i][0]);
        emit(g, d0 + 1, acc_tc[i][1]);
        emit(g + 8, d0, acc_tc[i][2]);
        emit(g + 8, d0 + 1, acc_tc[i][3]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      emit(tid / DH + i * (kThreads / DH), tid % DH, acc_cc[i]);
    }
  }
  if (tid < nr) {
    int b;
    const int64_t row = row_of(tid, &b);
    if (n_split == 1) {
      if (lse) lse[row] = row_m[tid] + logf(row_l[tid]);
    } else {
      ws_m[row * n_split + split] = row_m[tid];
      ws_l[row * n_split + split] = row_l[tid];
    }
  }
  if (n_split == 1) return;

  __threadfence();
  __syncthreads();
  const int group = blockIdx.z * gridDim.y + blockIdx.y;
  if (tid == 0) {
    is_last = atomicAdd(&counters[group], 1) == n_split - 1;
  }
  __syncthreads();
  if (!is_last) return;
  __threadfence();
  // combine the splits.  A warp per row reduces the splits' maxima and
  // denominators (lanes over splits, a fixed shuffle order, so the result
  // does not depend on which block finished last); split 0 always holds
  // key 0, so the overall max is finite.  The splits' weights
  // exp(m_s - M) go to shared memory (the K tiles are free now); then each
  // thread folds the splits, in split order, into its kPer (row, head
  // dimension) outputs, several splits' loads in flight at once.
  // splits past c_eff are empty (weight 0): fold only the n_used others
  const int n_used = min(n_split, (c_eff + len - 1) / len);
  float* wgt = reinterpret_cast<float*>(smem + L::k);  // (kRows, n_used)
  for (int i = warp; i < nr; i += kThreads / 32) {
    int b;
    const int64_t s0 = row_of(i, &b) * n_split;
    float M = -INFINITY;
    for (int s = lane; s < n_used; s += 32) {
      M = fmaxf(M, __ldcg(ws_m + s0 + s));
    }
    M = warp_max(M);
    float Lsum = 0.f;
    for (int s = lane; s < n_used; s += 32) {
      Lsum += __ldcg(ws_l + s0 + s) * expf(__ldcg(ws_m + s0 + s) - M);
    }
    Lsum = warp_sum(Lsum);
    if (lane == 0) {
      row_m[i] = M;
      row_l[i] = Lsum;
    }
    for (int s = lane; s < n_used; s += 32) {
      wgt[i * n_used + s] = expf(__ldcg(ws_m + s0 + s) - M);
    }
  }
  __syncthreads();
  constexpr int kPer = (kRows * DH + kThreads - 1) / kThreads;
  int64_t row_e[kPer];  // query row of output e, -1 past the tile
  float o[kPer];
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    const int idx = tid + e * kThreads;
    int b;
    row_e[e] = idx < nr * DH ? row_of(idx / DH, &b) : -1;
    o[e] = 0.f;
  }
#pragma unroll 4
  for (int s = 0; s < n_used; ++s) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (row_e[e] < 0) continue;
      const int idx = tid + e * kThreads;
      const int64_t slot = row_e[e] * n_split + s;
      o[e] += __ldcg(ws_acc + slot * DH + idx % DH) *
              wgt[(idx / DH) * n_used + s];
    }
  }
#pragma unroll
  for (int e = 0; e < kPer; ++e) {
    if (row_e[e] < 0) continue;
    const int idx = tid + e * kThreads;
    store_out(out, is_bf16, row_e[e] * DH + idx % DH,
              o[e] / fmaxf(row_l[idx / DH], 1e-30f));
  }
  if (lse && tid < nr) {
    int b;
    const int64_t row = row_of(tid, &b);
    lse[row] = row_m[tid] + logf(row_l[tid]);
  }
  if (tid == 0) counters[group] = 0;
}

template <int DH, bool TC>
int launch(const void* q, const void* k, const void* v, const void* valid,
           const void* qpos, const void* koff, const void* inv_freq,
           void* out, void* lse, void* ws_m, void* ws_l, void* ws_acc,
           void* counters, int B, int H, int KV, int Bc, int C, int n_split,
           float scale, cudaStream_t stream) {
  const size_t smem = Layout<DH, TC>::bytes;
  // set once per instance, whatever the size: the kernel's static shared
  // memory counts against the 48 KB default too
  static bool smem_set = false;
  if (!smem_set) {
    int err = static_cast<int>(cudaFuncSetAttribute(
        decode_attention_kernel<DH, TC>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
    if (err) return err;
    smem_set = true;
  }
  const int R_total = (B / Bc) * (H / KV);
  dim3 grid(n_split, KV * ((R_total + kRows - 1) / kRows), Bc);
  decode_attention_kernel<DH, TC><<<grid, kThreads, smem, stream>>>(
      q, k, v, static_cast<const int*>(valid), static_cast<const int*>(qpos),
      static_cast<const int*>(koff), static_cast<const float*>(inv_freq), out,
      static_cast<float*>(lse), static_cast<float*>(ws_m),
      static_cast<float*>(ws_l), static_cast<float*>(ws_acc),
      static_cast<int*>(counters), B, H, KV, Bc, C, n_split, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int decode_attention_rows_per_block() { return kRows; }

int decode_attention_min_split() { return kMinSplit; }

int decode_attention_split_align() { return kSplitAlign; }

int decode_attention_max_split() { return kMaxSplit; }

// Returns the cudaError_t of the launch (0 = success).  The wrapper checks
// shapes, dtypes, alignment and Dh (16, 32, 64 or 128) before calling;
// n_split comes from its plan (kernels/decode_attention.py:plan).
int decode_attention(const void* q, const void* k, const void* v, int is_bf16,
                     const void* valid, const void* qpos, const void* koff,
                     const void* inv_freq, void* out, void* lse, void* ws_m,
                     void* ws_l, void* ws_acc, void* counters, int B, int H,
                     int KV, int Dh, int Bc, int C, int n_split, float scale,
                     void* stream) {
  if (B == 0 || C == 0) return 0;
  if (Bc < 1 || B % Bc) return static_cast<int>(cudaErrorInvalidValue);
  if (n_split < 1 || n_split > kMaxSplit) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_LAUNCH(DH_, TC_)                                               \
  return launch<DH_, TC_>(q, k, v, valid, qpos, koff, inv_freq, out, lse, \
                          ws_m, ws_l, ws_acc, counters, B, H, KV, Bc, C,  \
                          n_split, scale, st)
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
