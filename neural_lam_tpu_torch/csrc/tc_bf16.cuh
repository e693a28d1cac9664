// Tensor-core helpers of the bf16-operand (BF) instantiations of K3
// (fused_edge_fwd.cuh), K7 (fused_edge_v2.cu), of K4's and K8's main
// kernels (fused_edge_bwd_main.cuh, fused_edge_v2_bwd.cu), of K4's and K8's
// edge pass (fused_edge_bwd_common.cuh) and of the node update and node
// backward (fused_node.cuh): 64-wide row products on Hopper's bf16 tensor
// cores, with float32 accumulation.
//
// The BF instantiations multiply bf16 operands (each rounded to nearest
// even, as astype(bfloat16)) with float32 sums, as the JAX package's
// kernels do under mixed precision. The product of two bf16 values is exact
// in float32, so the result is the JAX kernel's up to summation order. The
// float32 kernels, and the BF form of K4's and K8's rows pass, keep
// tc_tf32.cuh (3xTF32, or one TF32 pass on bf16-rounded values); this
// header runs the same products on bf16 fragments at k = 16: half the
// instructions of k = 8, each at twice the rate, and half the registers.
//
// Products run as mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (a
// warp's 16 rows) or as wgmma.mma_async m64n64k16 .bf16 (a warpgroup's 64
// rows). A row fragment keeps tc_tf32.cuh's float layout (float v[8][4]:
// lane 4 g + t holds rows g, g + 8, columns 8 n + 2 t, 8 n + 2 t + 1), which
// is the accumulator layout of both instructions. Its bf16 form (a "packed
// fragment", uint32_t a[4][4]) is the A operand of the four k-steps of a
// 64-deep product:
//   a[j][0] = (g,     16 j + 2 t .. +1)   = v[2 j][0..1]
//   a[j][1] = (g + 8, 16 j + 2 t .. +1)   = v[2 j][2..3]
//   a[j][2] = (g,     16 j + 8 + 2 t ..)  = v[2 j + 1][0..1]
//   a[j][3] = (g + 8, 16 j + 8 + 2 t ..)  = v[2 j + 1][2..3]
// so the float32 accumulators of n-tiles 2 j and 2 j + 1, rounded and
// packed in pairs, are exactly the A operand of k-step j of the next
// product: a row's layers chain in registers, as in tc_tf32.cuh.
//
// Rows read from device memory for a product alone (send, a batched edge
// row, a receiver row) skip the float fragment: lane t takes columns 16 t ..
// 16 t + 15 of its two rows as 16-byte loads (load_rows_k), so column c
// sits at k position k_slot(c), and the weight's inputs are placed there too
// (load_weight<true>, gemm_g<true>). A sum over k does not depend on which
// slot takes which column, as long as both operands agree.
//
// Weights and operand tiles live in shared memory as bf16 in the "core
// layout": the 8 x 8 block (r / 8, c / 8) of a 64 x 64 matrix is one
// 128-byte core matrix (8 rows of 16 bytes, 8 consecutive columns each),
// blocks of a row of blocks 128 bytes apart, rows of blocks 1024 bytes
// apart: 8 KB a matrix (a float32 weight split for 3xTF32 takes 32). wgmma
// reads it without swizzle in either orientation: a weight W[o][p] is the
// K-major B of x . W^T (N = o, K = p: leading byte offset 128 between k
// blocks, stride byte offset 1024 between n blocks) and, with the transpose
// bit, the MN-major B of x . W (K = o, N = p: 1024 between k blocks, 128
// between n blocks), so one copy serves both products. A tile T[m][f] of 64
// rows is the MN-major A (M = f, K = m) and B (K = m, N = f) of a weight
// gradient T1^T . T2 the same way. The 32 lanes of a row fragment's 4-byte
// store or load touch 128 consecutive bytes: no bank conflict.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "tc_tf32.cuh"

namespace tcb {

using bf16 = __nv_bfloat16;
using tc::Lane;

constexpr int kMatFloats = 64 * 64 / 2;  // a 64 x 64 bf16 matrix, in floats of shared memory

// element index of (row r, column c) of a 64 x 64 matrix in the core layout
__host__ __device__ constexpr int core_idx(int r, int c) {
  return ((r >> 3) * 8 + (c >> 3)) * 64 + (r & 7) * 8 + (c & 7);
}

// the k position of column c of a row read by load_rows_k: c = 16 t + 4 j +
// u sits in k-step j at slot 2 t + (u & 1) + 8 (u >> 1)
__host__ __device__ constexpr int k_slot(int c) {
  return 16 * ((c >> 2) & 3) + 2 * (c >> 4) + (c & 1) + 8 * ((c >> 1) & 1);
}

// two floats as bf16x2 (lo in the low half), each rounded to nearest even
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the packed fragment of a row fragment
__device__ __forceinline__ void pack_frag(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    a[j][0] = pack(x[2 * j][0], x[2 * j][1]);
    a[j][1] = pack(x[2 * j][2], x[2 * j][3]);
    a[j][2] = pack(x[2 * j + 1][0], x[2 * j + 1][1]);
    a[j][3] = pack(x[2 * j + 1][2], x[2 * j + 1][3]);
  }
}

// x as two packed fragments, hi = bf16(x) and lo = bf16(x - hi): x = hi + lo
// to about 16 significant bits, for a float32 operand that enters a bf16
// product as it is (two products, hi and lo, with the same other operand)
__device__ __forceinline__ void pack_split(uint32_t (&hi)[4][4], uint32_t (&lo)[4][4],
                                           const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float u = x[2 * j + q][2 * h], v = x[2 * j + q][2 * h + 1];
        hi[j][2 * q + h] = pack(u, v);
        lo[j][2 * q + h] = pack(u - tc::bf16r(u), v - tc::bf16r(v));
      }
}

// c += a . b for one k-step and one n-tile (not volatile: the compiler may
// interleave independent products)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// make this thread's generic-proxy writes to shared memory visible to the
// tensor cores' asynchronous reads (wgmma); then a barrier
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// W[o][p] (the 64 x 64 slice of a float32 weight with row stride ld, from
// column off; ld and off multiples of 4, 16-byte aligned) into dst in the
// core layout, rounded to bf16, by `threads` threads with 16-byte loads;
// with PERM_K input p goes to k slot k_slot(p) (a product whose A operand
// comes from load_rows_k), with PERM_O output o to row k_slot(o) (a
// product whose output stays in k-slot order: load_row_k). The caller
// fences (fence_async) and syncs.
template <bool PERM_K = false, bool PERM_O = false>
__device__ __forceinline__ void load_weight(bf16* dst, const float* __restrict__ w, int ld,
                                            int off, int threads) {
  for (int i = threadIdx.x; i < 64 * 16; i += threads) {
    const int o = i >> 4, p = 4 * (i & 15);
    const int r = PERM_O ? k_slot(o) : o;
    const float4 v = __ldg(reinterpret_cast<const float4*>(w + o * ld + off + p));
    if (PERM_K) {  // p .. p + 3 = 16 t + 4 j + 0..3: slots s, s + 1 and s + 8, s + 9
      const int s = k_slot(p);
      *reinterpret_cast<uint32_t*>(dst + core_idx(r, s)) = pack(v.x, v.y);
      *reinterpret_cast<uint32_t*>(dst + core_idx(r, s + 8)) = pack(v.z, v.w);
    } else {
      *reinterpret_cast<uint2*>(dst + core_idx(r, p)) =
          make_uint2(pack(v.x, v.y), pack(v.z, v.w));
    }
  }
}

// ---- row fragments in k-slot order --------------------------------------
//
// A float row fragment may hold its columns in k-slot order: v[n][2 h + j]
// is row g + 8 h, column 16 t + 2 n + j, whose slot 8 n + 2 t + j is
// k_slot of the column. Lane t then holds 16 consecutive columns of each of
// its two rows, which move to and from memory as 16-byte accesses
// (load_row_k, store_row_k); the product that fills such a fragment takes
// its weight with PERM_O, and pack_frag of it is the A operand of a product
// whose weight has PERM_K. LayerNorm-free epilogues (biases, SiLU) do not
// depend on the order, given vectors in k-slot order too.

// half h (row g + 8 h) of a k-slot fragment from a row of 64 floats in
// device memory (16-byte aligned): four 16-byte loads
__device__ __forceinline__ void load_row_k(float (&x)[8][4], int h, const float* row) {
  const Lane l;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + 16 * l.t + 4 * q));
    x[2 * q][2 * h] = v.x;
    x[2 * q][2 * h + 1] = v.y;
    x[2 * q + 1][2 * h] = v.z;
    x[2 * q + 1][2 * h + 1] = v.w;
  }
}

// the same from a row of 64 bf16 values (16-byte aligned): two 16-byte loads
__device__ __forceinline__ void load_row_k(float (&x)[8][4], int h, const bf16* row) {
  const Lane l;
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(row + 16 * l.t + 8 * q));
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[4 * q + i][2 * h] = __uint_as_float(w[i] << 16);
      x[4 * q + i][2 * h + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
}

// half h of a k-slot fragment into a row of 64 floats: four 16-byte stores
__device__ __forceinline__ void store_row_k(float* row, const float (&x)[8][4], int h) {
  const Lane l;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(row + 16 * l.t + 4 * q) =
        make_float4(x[2 * q][2 * h], x[2 * q][2 * h + 1], x[2 * q + 1][2 * h],
                    x[2 * q + 1][2 * h + 1]);
}

// The packed fragment of rows r0 + g, r0 + g + 8 of a (rows, 64) array in
// device memory (zero at and past row `valid`), in k-slot order: lane t
// reads columns 16 t .. 16 t + 15 of each row, two 16-byte loads of bf16
// rows or four of float32 ones (then rounded).
__device__ __forceinline__ void load_rows_k(uint32_t (&a)[4][4], const bf16* src, int r0,
                                            int valid) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + l.g + 8 * h;
    uint4 v0 = make_uint4(0u, 0u, 0u, 0u), v1 = v0;
    if (r < valid) {
      const uint4* p = reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * 64 +
                                                      16 * l.t);
      v0 = __ldg(p);
      v1 = __ldg(p + 1);
    }
    // columns 16 t + {0, 2, 4, 6} (+ 8 in v1): k-steps 0, 1 (2, 3), low
    // slots then high slots
    a[0][h] = v0.x;
    a[0][2 + h] = v0.y;
    a[1][h] = v0.z;
    a[1][2 + h] = v0.w;
    a[2][h] = v1.x;
    a[2][2 + h] = v1.y;
    a[3][h] = v1.z;
    a[3][2 + h] = v1.w;
  }
}

__device__ __forceinline__ void load_rows_k(uint32_t (&a)[4][4], const float* src, int r0,
                                            int valid) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + l.g + 8 * h;
    const float* row = src + static_cast<long long>(r) * 64 + 16 * l.t;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (r < valid) v = __ldg(reinterpret_cast<const float4*>(row + 4 * j));
      a[j][h] = pack(v.x, v.y);
      a[j][2 + h] = pack(v.z, v.w);
    }
  }
}

// acc += x . W^T, x the packed fragment, W (64 out, 64 in) in shared
// memory in the core layout (natural k order), as mma.sync: one 4-byte
// load per operand register
__device__ __forceinline__ void gemm(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                     const bf16* w) {
  const Lane l;
  const bf16* wl = w + l.g * 8 + 2 * l.t;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* b = wl + (8 * n + 2 * j) * 64;  // core matrices (n, 2 j), (n, 2 j + 1)
      mma(acc[n], a[j], *reinterpret_cast<const uint32_t*>(b),
          *reinterpret_cast<const uint32_t*>(b + 64));
    }
}

// acc[q] += (x . W^T)[., n-tiles n0 + q], q < 2: two of gemm's eight output
// n-tiles (16 of the 64 columns)
__device__ __forceinline__ void gemm_cols2(float (&acc)[2][4], const uint32_t (&a)[4][4],
                                           const bf16* w, int n0) {
  const Lane l;
  const bf16* wl = w + l.g * 8 + 2 * l.t;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const bf16* b = wl + (8 * (n0 + q) + 2 * j) * 64;
      mma(acc[q], a[j], *reinterpret_cast<const uint32_t*>(b),
          *reinterpret_cast<const uint32_t*>(b + 64));
    }
}

// acc += x . W^T for a float32 (64 out, 64 in) weight in device memory, row
// stride ld (through L1), each entry rounded to bf16 as it is read: for a
// product that runs once per chunk. With PERM_K the packed fragment is in
// k-slot order (load_rows_k) and one 16-byte load gives both operand
// registers of a k-step; else two 8-byte loads.
template <bool PERM_K = false>
__device__ __forceinline__ void gemm_g(float (&acc)[8][4], const uint32_t (&a)[4][4],
                                       const float* w, int ld) {
  const Lane l;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const float* row = w + static_cast<long long>(8 * n + l.g) * ld;
      uint32_t b0, b1;
      if (PERM_K) {  // slots 16 j + 2 t (+1) and (+8, +9): columns 16 t + 4 j + 0..3
        const float4 v = __ldg(reinterpret_cast<const float4*>(row + 16 * l.t + 4 * j));
        b0 = pack(v.x, v.y);
        b1 = pack(v.z, v.w);
      } else {
        const float2 u = __ldg(reinterpret_cast<const float2*>(row + 16 * j + 2 * l.t));
        const float2 v = __ldg(reinterpret_cast<const float2*>(row + 16 * j + 8 + 2 * l.t));
        b0 = pack(u.x, u.y);
        b1 = pack(v.x, v.y);
      }
      mma(acc[n], a[j], b0, b1);
    }
}

// ---- tiles of 64 rows in the core layout --------------------------------

// the warp's rows r0 + g, r0 + g + 8 of a packed fragment into a tile
__device__ __forceinline__ void store_tile(bf16* tile, const uint32_t (&a)[4][4], int r0) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bf16* row = tile + core_idx(r0 + l.g + 8 * h, 2 * l.t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      *reinterpret_cast<uint32_t*>(row + 2 * j * 64) = a[j][h];            // 16 j + 2 t
      *reinterpret_cast<uint32_t*>(row + (2 * j + 1) * 64) = a[j][2 + h];  // 16 j + 8 + 2 t
    }
  }
}

// the packed fragment of the tile's rows r0 + g, r0 + g + 8
__device__ __forceinline__ void load_tile(uint32_t (&a)[4][4], const bf16* tile, int r0) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bf16* row = tile + core_idx(r0 + l.g + 8 * h, 2 * l.t);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[j][h] = *reinterpret_cast<const uint32_t*>(row + 2 * j * 64);
      a[j][2 + h] = *reinterpret_cast<const uint32_t*>(row + (2 * j + 1) * 64);
    }
  }
}

// A warp's 16 rows r0 .. r0 + 15 of a (rows, 64) array in device memory
// (bf16 or float32; zero at and past row `valid`) on their way into a tile:
// load_staged issues the loads, 16 bytes of a row a lane, and store_staged
// (any time later) writes them into the tile, rounded to bf16, the 8 lanes
// of each store phase on 8 rows of one core matrix
__device__ __forceinline__ void load_staged(uint4 (&v)[4], const bf16* src, int r0, int valid) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cb = 2 * k + (lane >> 4);
    v[k] = make_uint4(0u, 0u, 0u, 0u);
    if (r < valid)
      v[k] = __ldg(reinterpret_cast<const uint4*>(src + static_cast<long long>(r) * 64 + 8 * cb));
  }
}

__device__ __forceinline__ void load_staged(float4 (&v)[8], const float* src, int r0, int valid) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int cb = 2 * k + (lane >> 4);
    v[2 * k] = v[2 * k + 1] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (r < valid) {
      const float4* p = reinterpret_cast<const float4*>(src + static_cast<long long>(r) * 64 +
                                                        8 * cb);
      v[2 * k] = __ldg(p);
      v[2 * k + 1] = __ldg(p + 1);
    }
  }
}

__device__ __forceinline__ void store_staged(bf16* tile, const uint4 (&v)[4], int r0) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint4*>(tile + core_idx(r, 8 * (2 * k + (lane >> 4)))) = v[k];
}

__device__ __forceinline__ void store_staged(bf16* tile, const float4 (&v)[8], int r0) {
  const int lane = threadIdx.x & 31;
  const int r = r0 + (lane & 15);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 u = v[2 * k], w = v[2 * k + 1];
    *reinterpret_cast<uint4*>(tile + core_idx(r, 8 * (2 * k + (lane >> 4)))) =
        make_uint4(pack(u.x, u.y), pack(u.z, u.w), pack(w.x, w.y), pack(w.z, w.w));
  }
}

// ---- warpgroup products (wgmma m64n64k16 bf16) ----------------------------

// the descriptor of a core-layout matrix without swizzle: leading and
// stride byte offsets
__device__ __forceinline__ uint64_t desc(const void* base, int lbo, int sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(base));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

// d += a . B, A in registers (the warpgroup's 64 rows, 16 a warp), B from
// a descriptor, TRANS_B = 1 for an MN-major B
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(TRANS_B));
}

// d += A . B with both from descriptors, both MN-major (the transpose bits)
__device__ __forceinline__ void wgmma_ss_tt(float (&d)[8][4], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(a), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait for the warpgroup's products, then keep the compiler from moving
// the accumulator across the wait
__device__ __forceinline__ void wg_wait(float (&d)[8][4]) {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  tc::fence_operands(d);
}

// keep the compiler from reusing an operand's registers before the wait
__device__ __forceinline__ void fence_packed(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[j][i])::"memory");
}

// acc += x . W^T (TRANS = 0) or x . W (TRANS = 1) over the warpgroup's 64
// rows, x the packed fragment, W (64 x 64) in shared memory in the core
// layout: four wgmma k-steps, one wait. Every warp of the group calls it.
template <int TRANS = 0>
__device__ __forceinline__ void gemm_wg(float (&acc)[8][4], uint32_t (&a)[4][4], const bf16* w) {
  // k-step j: core columns 2 j, 2 j + 1 (256 bytes on) of x . W^T, or core
  // rows 2 j, 2 j + 1 (2048 bytes on) of x . W; in 16-byte units
  const uint64_t d0 = TRANS ? desc(w, 1024, 128) : desc(w, 128, 1024);
  constexpr int kStep = TRANS ? 2048 / 16 : 256 / 16;
  tc::fence_operands(acc);
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<TRANS>(acc, a[j], d0 + kStep * j);
  wg_commit();
  wg_wait(acc);
  fence_packed(a);
}

// acc += (a + c) . W^T (TRANS = 0) or (a + c) . W (TRANS = 1): gemm_wg
// for an operand held as two packed fragments (pack_split), eight k-steps
// and one wait
template <int TRANS = 0>
__device__ __forceinline__ void gemm_wg2(float (&acc)[8][4], uint32_t (&a)[4][4],
                                         uint32_t (&c)[4][4], const bf16* w) {
  const uint64_t d0 = TRANS ? desc(w, 1024, 128) : desc(w, 128, 1024);
  constexpr int kStep = TRANS ? 2048 / 16 : 256 / 16;
  tc::fence_operands(acc);
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<TRANS>(acc, a[j], d0 + kStep * j);
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_rs<TRANS>(acc, c[j], d0 + kStep * j);
  wg_commit();
  wg_wait(acc);
  fence_packed(a);
  fence_packed(c);
}

// acc += A^T . G over the 64 rows of two tiles in the core layout (A[m][o],
// G[m][i]; acc in the row-fragment layout, output rows o = 16 w + g (+8) of
// warp w): a weight gradient's share of one tile, added in the tensor core
// (float32 accumulation), issued as four wgmma k-steps without waiting
// (wg_wait(acc) before reading acc or rewriting either tile). Every warp of
// the group calls it.
__device__ __forceinline__ void gemm_tn_issue(float (&acc)[8][4], const bf16* a, const bf16* g) {
  const uint64_t da = desc(a, 1024, 128), dg = desc(g, 1024, 128);
  tc::fence_operands(acc);
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_ss_tt(acc, da + 128 * j, dg + 128 * j);  // 2048 bytes a k-step
  wg_commit();
}

// acc += (A1 + A2)^T . G: gemm_tn_issue for an A held as two tiles (the hi
// and lo terms of pack_split), eight k-steps in one commit
__device__ __forceinline__ void gemm_tn_issue2(float (&acc)[8][4], const bf16* a1,
                                               const bf16* a2, const bf16* g) {
  const uint64_t d1 = desc(a1, 1024, 128), d2 = desc(a2, 1024, 128), dg = desc(g, 1024, 128);
  tc::fence_operands(acc);
  wg_fence();
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_ss_tt(acc, d1 + 128 * j, dg + 128 * j);
#pragma unroll
  for (int j = 0; j < 4; ++j) wgmma_ss_tt(acc, d2 + 128 * j, dg + 128 * j);
  wg_commit();
}

// a kernel's launch resources after allowing it `bytes` of shared memory:
// blocks per SM, registers per thread, local memory per thread (the spill
// stack)
template <typename K>
cudaError_t occupancy(K kernel, int threads, int bytes, int* blocks, int* regs, int* local) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  *local = static_cast<int>(attr.localSizeBytes);
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, bytes);
}

}  // namespace tcb
