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
// one block.  Generalisations the beam step needs: a cache batch of 1
// shared by every query batch row (the beam prefix, read once for all
// beams), a per-cache key-position offset (the per-beam block's key j sits
// at plen + j), and a per-row log-sum-exp output so that two blocks can be
// merged.
//
// Bound on the H100: the K and V bytes of the cache it reads
// (2 * C * KV * Dh * bytes per cache batch) against ~4 * R * C * Dh flops
// for R query rows per KV head -- a few flops per byte, far below the ~20
// f32 flops per byte where the CUDA cores would bind.  Keys past valid_len
// get weight exactly 0 once one key is valid (exp(-1e9 - m) == 0 in f32),
// so the kernel reads only min(valid_len, C) keys (all C when valid_len is
// 0), and the bound counts those bytes.
//
// Design (a first version): the TPU kernel walks key tiles in order with
// its running max/denominator in VMEM scratch; here blocks run in
// parallel, so the keys of one (cache batch, KV head) are cut into n_split
// contiguous splits, one block each, sized for ~16 blocks per SM.  A block
// stages a tile of 32 keys (rotated) and their V rows in shared memory
// with all of the tile's loads in flight at once, forms the scores of its
// (at most 4) query rows, runs the online softmax over its tiles and
// accumulates P.V with one thread per head dimension.  The shared
// prefix's 16 rows (4 beams x 4 heads of a KV head) are 4 row tiles whose
// blocks run together, so its keys cross device memory once and are
// re-read from L2; small blocks, many per SM, hide the latency of each
// block's dependent steps (one 16-row block per SM ran 2-3x slower on the
// H100).  A block writes its partial (max, denominator, unnormalised sum)
// to a workspace; the last block of a (cache batch, KV head, row tile) to
// finish -- counted with an atomic -- combines the splits in a fixed order
// (so the result does not depend on which block finished last) and resets
// the counter.  Recomputing cos/sin per key and block, CUDA-core dot
// products and the combine's serial walk over splits are what a faster
// version replaces (tensor-core MMAs, a shared cos/sin table, fewer and
// larger splits, cp.async/TMA tiles).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // one thread per head dimension in P.V
constexpr int kTK = 32;        // keys per tile (one per lane in the softmax)
constexpr int kRows = 4;       // query rows per block
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

// Grid: x = split, y = KV head * n_rtiles + row tile, z = cache batch.
// q (B, H, DH); k, v (Bc, C, KV, DH) with Bc == B or Bc == 1 (shared);
// valid, koff (Bc,) int32 (koff may be null); qpos (B,) int32;
// out (B, H, DH); lse (B, H) f32 or null.  Workspace (n_split > 1 only):
// ws_m, ws_l (B*H*n_split), ws_acc (B*H*n_split*DH), counters zeroed,
// one per (cache batch, KV head, row tile).  DH is compile-time, so that
// index arithmetic is shifts.
template <int DH>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const void* __restrict__ q,
                        const void* __restrict__ k,
                        const void* __restrict__ v, int is_bf16,
                        const int* __restrict__ valid,
                        const int* __restrict__ qpos,
                        const int* __restrict__ koff,
                        const float* __restrict__ inv_freq,
                        void* __restrict__ out, float* __restrict__ lse,
                        float* __restrict__ ws_m, float* __restrict__ ws_l,
                        float* __restrict__ ws_acc, int* __restrict__ counters,
                        int B, int H, int KV, int Bc, int C, int n_split,
                        int split_len, float scale) {
  constexpr int half = DH / 2;
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                  // (kRows, DH)
  float* k_s = q_s + kRows * DH;       // (kTK, DH + 1), padded
  float* v_s = k_s + kTK * (DH + 1);  // (kTK, DH)
  float* p_s = v_s + kTK * DH;        // (kRows, kTK)
  float* row_m = p_s + kRows * kTK;    // (kRows)
  float* row_l = row_m + kRows;
  float* row_alpha = row_l + kRows;
  __shared__ int is_last;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int Gq = H / KV;
  const int shared_cache = (Bc == 1 && B > 1);
  const int R_total = (shared_cache ? B : 1) * Gq;
  const int bc = blockIdx.z;
  const int kvh = blockIdx.y % KV;
  const int rt = blockIdx.y / KV;
  const int split = blockIdx.x;
  const int r0 = rt * kRows;
  const int nr = min(kRows, R_total - r0);

  // query row (b * H + head) and batch of local row i
  auto row_of = [&](int i, int* b_out) {
    const int rr = r0 + i;
    const int b = shared_cache ? rr / Gq : bc;
    *b_out = b;
    return b * H + kvh * Gq + rr % Gq;
  };

  const int vr = valid[bc];
  const int c_eff = vr > 0 ? min(vr, C) : C;
  const int k_begin = split * split_len;
  const int k_end = min(k_begin + split_len, c_eff);
  const int off = koff ? koff[bc] : 0;
  const int64_t kv_stride = (int64_t)KV * DH;  // between keys
  const int64_t cache_base = ((int64_t)bc * C * KV + kvh) * DH;

  // rotated, unscaled query rows
  for (int idx = tid; idx < nr * half; idx += kThreads) {
    const int i = idx / half, p = idx % half;
    int b;
    const int64_t row = row_of(i, &b);
    float o1, o2;
    rope_pair(load_f32(q, is_bf16, row * DH + p),
              load_f32(q, is_bf16, row * DH + p + half), qpos[b],
              inv_freq[p], &o1, &o2);
    q_s[i * DH + p] = o1;
    q_s[i * DH + p + half] = o2;
  }
  if (tid < kRows) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }
  float acc[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int t0 = k_begin; t0 < k_end; t0 += kTK) {
    // stage the tile: V rows as they are, keys rotated; all of the tile's
    // loads are independent, so they are in flight together
    for (int idx = tid; idx < kTK * DH; idx += kThreads) {
      const int j = idx / DH, d = idx % DH;
      v_s[idx] = t0 + j < k_end
                     ? load_f32(v, is_bf16, cache_base + (t0 + j) * kv_stride + d)
                     : 0.f;
    }
    for (int idx = tid; idx < kTK * half; idx += kThreads) {
      const int j = idx / half, p = idx % half;
      const int key = t0 + j;
      float o1 = 0.f, o2 = 0.f;
      if (key < k_end) {
        const int64_t base = cache_base + key * kv_stride;
        rope_pair(load_f32(k, is_bf16, base + p),
                  load_f32(k, is_bf16, base + p + half), off + key,
                  inv_freq[p], &o1, &o2);
      }
      k_s[j * (DH + 1) + p] = o1;
      k_s[j * (DH + 1) + p + half] = o2;
    }
    __syncthreads();
    // scores: a warp takes one row and the tile's 32 keys (lane = key)
    for (int idx = tid; idx < nr * kTK; idx += kThreads) {
      const int i = idx / kTK, j = idx % kTK;
      const int key = t0 + j;
      const float* qi = q_s + i * DH;
      const float* kj = k_s + j * (DH + 1);
      float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;  // four FMA chains
#pragma unroll
      for (int d = 0; d < DH; d += 4) {
        d0 += qi[d] * kj[d];
        d1 += qi[d + 1] * kj[d + 1];
        d2 += qi[d + 2] * kj[d + 2];
        d3 += qi[d + 3] * kj[d + 3];
      }
      const float dot = (d0 + d1) + (d2 + d3);
      p_s[i * kTK + j] = key < k_end ? (key < vr ? dot * scale : kMaskedScore)
                                     : -INFINITY;
    }
    __syncthreads();
    // online softmax, one warp per row; every tile holds a real key, so
    // the new max is finite and exp(-inf) gives the padding weight 0
    for (int i = warp; i < nr; i += kThreads / 32) {
      const float sc = p_s[i * kTK + lane];
      const float m_old = row_m[i];
      const float m_new = fmaxf(m_old, warp_max(sc));
      const float p = expf(sc - m_new);
      const float psum = warp_sum(p);
      p_s[i * kTK + lane] = p;
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        row_alpha[i] = alpha;
        row_l[i] = row_l[i] * alpha + psum;
        row_m[i] = m_new;
      }
    }
    __syncthreads();
    // P.V: thread tid owns head dimension tid
    if (tid < DH) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < nr) acc[i] *= row_alpha[i];
      }
      const int nk = min(kTK, k_end - t0);
      for (int j = 0; j < nk; ++j) {
        const float vj = v_s[j * DH + tid];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i < nr) acc[i] += p_s[i * kTK + j] * vj;
        }
      }
    }
    __syncthreads();
  }

  if (n_split == 1) {
    for (int i = 0; i < nr; ++i) {
      int b;
      const int64_t row = row_of(i, &b);
      if (tid < DH) {
        store_out(out, is_bf16, row * DH + tid,
                  acc[i] / fmaxf(row_l[i], 1e-30f));
      }
      if (lse && tid == 0) lse[row] = row_m[i] + logf(row_l[i]);
    }
    return;
  }

  // write this split's partial; an empty split (past valid_len) has max
  // -inf, denominator 0 and sum 0, and so weight 0 in the combine
  for (int i = 0; i < nr; ++i) {
    int b;
    const int64_t slot = row_of(i, &b) * n_split + split;
    if (tid < DH) ws_acc[slot * DH + tid] = acc[i];
    if (tid == 0) {
      ws_m[slot] = row_m[i];
      ws_l[slot] = row_l[i];
    }
  }
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
  // key 0, so the overall max is finite.  Then each thread folds the
  // splits, in split order, into its kPer (row, head dimension) outputs at
  // once, so that kPer independent loads are in flight per split.
  for (int i = warp; i < nr; i += kThreads / 32) {
    int b;
    const int64_t s0 = row_of(i, &b) * n_split;
    float M = -INFINITY;
    for (int s = lane; s < n_split; s += 32) M = fmaxf(M, __ldcg(ws_m + s0 + s));
    M = warp_max(M);
    float L = 0.f;
    for (int s = lane; s < n_split; s += 32) {
      L += __ldcg(ws_l + s0 + s) * expf(__ldcg(ws_m + s0 + s) - M);
    }
    L = warp_sum(L);
    if (lane == 0) {
      row_m[i] = M;
      row_l[i] = L;
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
  for (int s = 0; s < n_split; ++s) {
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (row_e[e] < 0) continue;
      const int idx = tid + e * kThreads;
      const int64_t slot = row_e[e] * n_split + s;
      const float w = expf(__ldcg(ws_m + slot) - row_m[idx / DH]);
      o[e] += __ldcg(ws_acc + slot * DH + idx % DH) * w;
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

template <int DH>
size_t smem_bytes() {
  return sizeof(float) *
         (kRows * DH + kTK * (DH + 1) + kTK * DH + kRows * kTK + 3 * kRows);
}

template <int DH>
int launch(const void* q, const void* k, const void* v, int is_bf16,
           const void* valid, const void* qpos, const void* koff,
           const void* inv_freq, void* out, void* lse, void* ws_m, void* ws_l,
           void* ws_acc, void* counters, int B, int H, int KV, int Bc, int C,
           int n_split, int split_len, float scale, cudaStream_t stream) {
  const int R_total = ((Bc == 1 && B > 1) ? B : 1) * (H / KV);
  dim3 grid(n_split, KV * ((R_total + kRows - 1) / kRows), Bc);
  decode_attention_kernel<DH><<<grid, kThreads, smem_bytes<DH>(), stream>>>(
      q, k, v, is_bf16, static_cast<const int*>(valid),
      static_cast<const int*>(qpos), static_cast<const int*>(koff),
      static_cast<const float*>(inv_freq), out, static_cast<float*>(lse),
      static_cast<float*>(ws_m), static_cast<float*>(ws_l),
      static_cast<float*>(ws_acc), static_cast<int*>(counters), B, H, KV, Bc,
      C, n_split, split_len, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int decode_attention_rows_per_block() { return kRows; }

int decode_attention_keys_per_tile() { return kTK; }

// Returns the cudaError_t of the launch (0 = success).  The wrapper checks
// shapes, dtypes and Dh (16, 32, 64 or 128) before calling.
int decode_attention(const void* q, const void* k, const void* v, int is_bf16,
                     const void* valid, const void* qpos, const void* koff,
                     const void* inv_freq, void* out, void* lse, void* ws_m,
                     void* ws_l, void* ws_acc, void* counters, int B, int H,
                     int KV, int Dh, int Bc, int C, int n_split,
                     int split_len, float scale, void* stream) {
  if (B == 0 || C == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DA_LAUNCH(DH_)                                                     \
  return launch<DH_>(q, k, v, is_bf16, valid, qpos, koff, inv_freq, out,   \
                     lse, ws_m, ws_l, ws_acc, counters, B, H, KV, Bc, C,   \
                     n_split, split_len, scale, st)
  switch (Dh) {
    case 16: DA_LAUNCH(16);
    case 32: DA_LAUNCH(32);
    case 64: DA_LAUNCH(64);
    case 128: DA_LAUNCH(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef DA_LAUNCH
}

}  // extern "C"
