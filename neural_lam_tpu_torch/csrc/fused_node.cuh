// The frame shared by the node-MLP route's two row kernels
// (NEURAL_LAM_TPU_FUSED_AGGR=on): the node update (fused_node.cu) and its
// backward (fused_node_bwd.cu). Both walk (rows, 64) arrays with no graph
// structure in tiles of 64 rows, a warpgroup a tile, in persistent blocks
// that hold the node MLP's three 64 x 64 weights in shared memory for all
// of their tiles:
//
//   War = wa1[:, :D], Wag = wa1[:, D:] (the first layer on [rec, aggr]),
//   Wa2 (the second layer), in nn.Linear's (out, in) layout.
//
// float32: each weight split once into its 3xTF32 hi and lo halves in the
// layout wgmma reads (tc::load_weight_wg: 32 KB a weight, 96 KB the three);
// the row products x . W^T run as wgmma m64n64k8 with A in registers
// (tc::gemm_wg), and the transposed products x . W of the backward as
// mma.sync m16n8k8 on the same halves (gemm_t_wg below: TF32 wgmma has no
// transpose bit, and a second, transposed split copy would take another
// 96 KB). bf16 operands (BF): one bf16 copy a weight in tc_bf16.cuh's core
// layout (8 KB, 24 KB the three), which wgmma m64n64k16 reads in both
// orientations (tcb::gemm_wg<0> and <1>).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fused_edge_common.cuh"
#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

namespace fused_node {

using fused_edge::D;
using fused_edge::kLnEps;
using fused_edge::kTileRows;
using tc::kWld;

constexpr int kGroupThreads = 128;  // a warpgroup
constexpr int kMat = D * D;          // floats of a weight gradient

// floats of shared memory that one weight takes
__host__ __device__ constexpr int weight_floats(bool bf) {
  return bf ? tcb::kMatFloats : 2 * tc::kWgHalf;
}

// War | Wag | Wa2 into sw (3 weight_floats(BF) floats) by `threads` threads;
// the caller syncs before the first product
template <bool BF>
__device__ __forceinline__ void load_weights(float* sw, const float* wa1, const float* wa2,
                                             int threads) {
  constexpr int kW = weight_floats(BF);
  if constexpr (BF) {
    tcb::bf16* w = reinterpret_cast<tcb::bf16*>(sw);
    tcb::load_weight<false>(w, wa1, 2 * D, 0, threads);
    tcb::load_weight<false>(w + 2 * kW, wa1, 2 * D, D, threads);
    tcb::load_weight<false>(w + 4 * kW, wa2, D, 0, threads);
  } else {
    tc::load_weight_wg(sw, wa1, 2 * D, 0, threads);
    tc::load_weight_wg(sw + kW, wa1, 2 * D, D, threads);
    tc::load_weight_wg(sw + 2 * kW, wa2, D, 0, threads);
  }
  tcb::fence_async();  // the tensor cores read what the threads wrote
}

// acc += x . W^T over the warpgroup's 64 rows (every warp of the group
// calls it), W the weight at sw: 3xTF32 wgmma, or with BF one bf16 wgmma a
// k-step on x rounded to bf16 (KB: tc::gemm_wg's k-steps a batch)
template <bool BF, int KB = 4>
__device__ __forceinline__ void row_product(float (&acc)[8][4], const float (&x)[8][4],
                                            const float* sw) {
  if constexpr (BF) {
    uint32_t a[4][4];
    tcb::pack_frag(a, x);
    tcb::gemm_wg<0>(acc, a, reinterpret_cast<const tcb::bf16*>(sw));
  } else {
    tc::gemm_wg<KB>(acc, x, sw);
  }
}

// acc += x . W for W[o][p] held split by tc::load_weight_wg (hi at w, lo at
// w + kWgHalf), a warp's 16 rows: mma.sync m16n8k8 in 3xTF32, k-step kk
// over o = 8 kk + 2t (+1), n-tile j over p = 8 j + g. The layout puts W[o][p]
// at ((p >> 3) * 2 + (p & 1)) * 256 + (o >> 3) * 32 + (o & 7) * 4 + ((p & 7) >> 1),
// so a lane's four operands of an n-tile are single loads of the halves,
// with no split on the way (2-way bank conflicts between lanes g and g ^ 1).
__device__ __forceinline__ void gemm_t_wg(float (&acc)[8][4], const float (&x)[8][4],
                                          const float* w) {
  const tc::Lane l;
  const float* wl = w + (l.g & 1) * 256 + 8 * l.t + (l.g >> 1);
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    tc::a_operand<false>(x, kk, ah, al);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t bh[4][2], bl[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float* b = wl + (4 * h + q) * 512 + kk * 32;
        bh[q][0] = __float_as_uint(b[0]);
        bh[q][1] = __float_as_uint(b[4]);
        bl[q][0] = __float_as_uint(b[tc::kWgHalf]);
        bl[q][1] = __float_as_uint(b[tc::kWgHalf + 4]);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) tc::mma(acc[4 * h + q], al, bh[q][0], bh[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) tc::mma(acc[4 * h + q], ah, bl[q][0], bl[q][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) tc::mma(acc[4 * h + q], ah, bh[q][0], bh[q][1]);
    }
  }
}

// acc += x . W (the transposed product) over the warpgroup's 64 rows (every
// warp calls it): gemm_t_wg, or with BF one bf16 wgmma a k-step through the
// transpose bit. With BF, a holds x's packed fragment on entry.
template <bool BF>
__device__ __forceinline__ void t_product(float (&acc)[8][4], const float (&x)[8][4],
                                          uint32_t (&a)[4][4], const float* sw) {
  if constexpr (BF)
    tcb::gemm_wg<1>(acc, a, reinterpret_cast<const tcb::bf16*>(sw));
  else
    gemm_t_wg(acc, x, sw);
}

// 16 bytes from device memory into shared memory, asynchronously; with
// live false the 16 bytes are zeros and nothing is read
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool live) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Rows row0 .. row0 + 63 of a (rows, 64) array of T in device memory into a
// tile of shared memory with row stride kWld elements (rows at and past
// `valid` zero), by the `threads` threads numbered from tid, as cp.async
// 16-byte copies; the caller commits
template <typename T>
__device__ __forceinline__ void tile_async(T* dst, const T* src, long long row0, int valid,
                                           int tid, int threads) {
  constexpr int kChunks = 64 * static_cast<int>(sizeof(T)) / 16;  // 16-byte chunks a row
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));           // values a chunk
  for (int i = tid; i < kTileRows * kChunks; i += threads) {
    const int r = i / kChunks, c = i - r * kChunks;
    const bool live = r < valid;
    cp_async16(dst + r * kWld + c * kPer, src + (row0 + (live ? r : 0)) * 64 + c * kPer, live);
  }
}

// A row fragment (rows r0 + g, r0 + g + 8) from a tile of shared memory
// with row stride kWld, of floats or of bf16 values (4-byte loads of a pair:
// the 32 lanes on 32 banks)
__device__ __forceinline__ void load_tile_rows(float (&x)[8][4], const float* s, int r0) {
  tc::load_rows<false>(x, s, kWld, r0, kTileRows);
}

__device__ __forceinline__ void load_tile_rows(float (&x)[8][4], const __nv_bfloat16* s,
                                               int r0) {
  const tc::Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint32_t* row =
        reinterpret_cast<const uint32_t*>(s + (r0 + l.g + 8 * h) * kWld + 2 * l.t);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const uint32_t u = row[4 * n];
      x[n][2 * h] = __uint_as_float(u << 16);
      x[n][2 * h + 1] = __uint_as_float(u & 0xffff0000u);
    }
  }
}

// the rows of a fragment below `valid` out to device memory as float or,
// with out_bf16, rounded to bf16
__device__ __forceinline__ void store_out(void* dst, int out_bf16, long long offset,
                                          const float (&x)[8][4], int r0, int valid) {
  if (out_bf16)
    tc::store_rows(static_cast<__nv_bfloat16*>(dst) + offset, D, x, r0, valid);
  else
    tc::store_rows(static_cast<float*>(dst) + offset, D, x, r0, valid);
}

// named barriers between warpgroups: wait for `threads` arrivals, or arrive
// without waiting
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

}  // namespace fused_node
