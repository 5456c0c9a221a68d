// Device helpers shared by quant_matmul.cu, grouped_matmul.cu and
// norm_quant.cu (each includes this header in its own translation unit,
// so they build in parallel): output stores, int8 packing, 16-byte vector
// values, cp.async and the shared-memory opt-in; and for w8_bf16_gemm's
// mma.sync design (quant_matmul.cu), its tile constants, the stage layout
// and the launch geometry.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void store_out(void* p, int is_bf16, int64_t i,
                                          float v) {
  if (is_bf16) {
    reinterpret_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    reinterpret_cast<float*>(p)[i] = v;
  }
}

__device__ __forceinline__ int pack_int8x4(float a, float b, float c,
                                           float d) {
  auto q = [](float v) {
    return static_cast<unsigned>(
               __float2int_rn(fminf(fmaxf(rintf(v), -127.f), 127.f))) &
           0xffu;
  };
  return static_cast<int>(q(a) | (q(b) << 8) | (q(c) << 16) | (q(d) << 24));
}

// value e of a 16-byte vector held as 4 words: a bf16 is the upper half of
// the f32 with the same value
template <bool BF16>
__device__ __forceinline__ float vec_value(const int4& r, int e) {
  const unsigned w[4] = {static_cast<unsigned>(r.x), static_cast<unsigned>(r.y),
                         static_cast<unsigned>(r.z), static_cast<unsigned>(r.w)};
  if constexpr (BF16) {
    return __uint_as_float(e & 1 ? w[e >> 1] & 0xffff0000u : w[e >> 1] << 16);
  } else {
    return __uint_as_float(w[e]);
  }
}

// w8_bf16_gemm's tiles (the mma.sync design w8a8_gemm had before its
// wgmma redesign)
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

// Byte offset of 16-byte chunk c of row r in a stage of 128-byte rows.
// Odd rows swap their 64-byte halves, so the 8 lanes of a quarter warp
// (rows g, g + 1, chunks t) read 8 distinct bank groups.
__device__ __forceinline__ int chunk_at(int r, int c) {
  return r * tc::kTK + ((c ^ ((r & 1) << 2)) << 4);
}

// Set a tensor-core GEMM instance's dynamic shared memory limit, once per
// instance whatever the size: the kernel's static shared memory counts
// against the 48 KB default too.
template <typename Kernel>
int set_smem_once(Kernel kernel, size_t smem, bool& done) {
  if (done) return 0;
  int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
  done = err == 0;
  return err;
}

// The launch geometry of w8_bf16_gemm.  A block that streams
// long weight rows past few activation rows gains from fetching the next
// 128 bytes of each row into L2 early; with more rows, or short splits,
// the extra traffic cost more than it gave (measured on the H100 with
// w8a8_gemm).
struct TcGrid {
  dim3 grid;
  int prefetch;
  TcGrid(int NT, int M, int O, int k_split, int n_split,
         int tile_o = tc::kTO)
      : grid((O + tile_o - 1) / tile_o, n_split,
             (M + NT * 8 - 1) / (NT * 8)),
        prefetch(NT <= 2 && k_split >= 1024) {}
};

}  // namespace
