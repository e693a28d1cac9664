// Tensor-core helpers of the fused edge-phase kernels K3 (fused_edge.cu),
// K4 (fused_edge_bwd.cu), K7 (fused_edge_v2.cu) and K8
// (fused_edge_v2_bwd.cu): 64-wide row products on Hopper's tensor cores at
// float32 accuracy, and the row epilogues on their fragments.
//
// Products run as mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 (a
// warp's rows) or as wgmma.mma_async m64n64k8 TF32 (a warpgroup's 64 rows
// against a weight in shared memory, further below), with the 3xTF32 split: each float32 operand x becomes hi = tf32(x) (round to
// nearest) and lo = x - hi (truncated to TF32 by the tensor core), and a
// product accumulates lo.hi + hi.lo + hi.hi in float32. The dropped lo.lo
// term and lo's truncation are below 2^-21 of the product, the rounding of
// another summation order, so the result holds the plain float32
// version's tolerances; 1xTF32 (hi.hi alone) keeps about 3 decimal digits.
//
// One warp owns 16 rows by 64 columns ("a row fragment", float v[8][4]).
// Lane = 4 g + t; the lane holds rows g and g + 8, columns 8 n + 2 t and
// 8 n + 2 t + 1 of each n < 8:
//   v[n][0] = (g, 8n + 2t)      v[n][1] = (g, 8n + 2t + 1)
//   v[n][2] = (g + 8, 8n + 2t)  v[n][3] = (g + 8, 8n + 2t + 1)
// That is the m16n8k8 accumulator layout of the eight n-tiles, and also
// its A-operand layout of the eight k-steps when the MMA's k slots t and
// t + 4 of step n stand for columns 8n + 2t and 8n + 2t + 1: a sum over k
// does not care in which order the slots take the columns, as long as B
// takes them in the same order. So one product's output feeds the next
// product's input in registers, with no shuffle and no shared memory, and
// a row's 64 columns sit in one quad of lanes (the LayerNorm moments are
// two __shfl_xor). B of step n, n-tile j is then the pair (k = 8n + 2t,
// 8n + 2t + 1) of output column 8j + g: one 8-byte load from a weight held
// output-major with row stride kWld = 72 floats, which puts the 32 lanes
// of each half-warp phase on 32 distinct banks.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace tc {

constexpr int kWld = 72;  // row stride (floats) of weights and row tiles in shared memory

struct Lane {
  int g, t;  // row group 0..7 and column pair 0..3 of the lane
  __device__ __forceinline__ Lane() : g((threadIdx.x & 31) >> 2), t(threadIdx.x & 3) {}
};

// hi = x rounded to TF32 (to nearest on the 13 dropped mantissa bits, by
// integer add and mask: full-rate ALU work, where cvt.rna.tf32.f32 is not)
// and lo = x - hi, exact in float32 and below 2^-11 |x|. lo goes to the
// MMA as it is: the tensor core reads its top 19 bits, which truncates it
// by less than 2^-10 |lo| < 2^-21 |x|, a bias that does not grow with the
// length of a sum. (Rounding lo as well cost 3-13 % more time in K3 and K4
// on an H100, for an error already below float32 summation order.)
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a . b (not volatile: the compiler may interleave independent
// products)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[n0 + q] += a . b[q] in 3xTF32 for NQ (at most four) n-tiles, b[q] =
// the pair (b0, b1) of n-tile n0 + q: the small terms first, and each round
// over the independent accumulators, so that no product waits on the one
// issued just before it. The tensor core adds into acc by truncation, so a
// running sum kept in it drifts toward zero by up to an ulp per product: a
// 64-wide row product (24 products) stays near float32 rounding, but a sum
// over many tiles must leave the tensor core between tiles (gemm_tn).
// (Adding every k-step's terms to acc on the float32 units cost 45 % more
// time on an H100, profile_forecast.py --probe, for no gain in a row.)
template <int N0, int NQ = 4, int NA>
__device__ __forceinline__ void mma3x4(float (&acc)[NA][4], const uint32_t (&ah)[4],
                                       const uint32_t (&al)[4], const float (&b)[4][2]) {
  uint32_t bh[4][2], bl[4][2];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    split(b[q][0], bh[q][0], bl[q][0]);
    split(b[q][1], bh[q][1], bl[q][1]);
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) mma(acc[N0 + q], al, bh[q][0], bh[q][1]);
#pragma unroll
  for (int q = 0; q < NQ; ++q) mma(acc[N0 + q], ah, bl[q][0], bl[q][1]);
#pragma unroll
  for (int q = 0; q < NQ; ++q) mma(acc[N0 + q], ah, bh[q][0], bh[q][1]);
}

// the A operand of k-step n, split, from a row fragment
__device__ __forceinline__ void a_operand(const float (&x)[8][4], int n, uint32_t (&ah)[4],
                                          uint32_t (&al)[4]) {
  split(x[n][0], ah[0], al[0]);  // (g, slot t)
  split(x[n][2], ah[1], al[1]);  // (g + 8, slot t)
  split(x[n][1], ah[2], al[2]);  // (g, slot t + 4)
  split(x[n][3], ah[3], al[3]);  // (g + 8, slot t + 4)
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) x[n][j] = 0.0f;
}

// acc += x . W^T for a (64 out, 64 in) weight W held output-major: W[o][k]
// at w[o * ld + k] (nn.Linear's own layout), in shared memory or, with
// GLOBAL, in device memory (through L1), for a product that runs once per
// chunk
template <bool GLOBAL = false>
__device__ __forceinline__ void gemm(float (&acc)[8][4], const float (&x)[8][4],
                                     const float* w, int ld = kWld) {
  const Lane l;
  const float* wl = w + l.g * ld + 2 * l.t;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    a_operand(x, kk, ah, al);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float b[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float2* src =
            reinterpret_cast<const float2*>(wl + 8 * (4 * h + q) * ld + 8 * kk);
        const float2 v = GLOBAL ? __ldg(src) : *src;
        b[q][0] = v.x;
        b[q][1] = v.y;
      }
      if (h == 0)
        mma3x4<0>(acc, ah, al, b);
      else
        mma3x4<4>(acc, ah, al, b);
    }
  }
}

// acc[q] += (x . W^T)[., n-tiles n0 + q], q < 2: two of gemm's eight output
// n-tiles (16 of the 64 columns), W in shared memory
__device__ __forceinline__ void gemm_cols2(float (&acc)[2][4], const float (&x)[8][4],
                                           const float* w, int n0, int ld = kWld) {
  const Lane l;
  const float* wl = w + (8 * n0 + l.g) * ld + 2 * l.t;
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    uint32_t ah[4], al[4];
    a_operand(x, kk, ah, al);
    float b[4][2];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float2 v = *reinterpret_cast<const float2*>(wl + 8 * q * ld + 8 * kk);
      b[q][0] = v.x;
      b[q][1] = v.y;
    }
    mma3x4<0, 2>(acc, ah, al, b);
  }
}

// the 16 rows of n-tiles n0, n0 + 1 of a fragment (gemm_cols2's) into dst
__device__ __forceinline__ void store_cols2(float* dst, int ld, const float (&x)[2][4],
                                            int n0) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < 2; ++q)
      *reinterpret_cast<float2*>(dst + (l.g + 8 * h) * ld + 8 * (n0 + q) + 2 * l.t) =
          make_float2(x[q][2 * h], x[q][2 * h + 1]);
}

// ---- layout Q: four consecutive columns a lane ------------------------------
//
// A fragment may also hold its columns in layout Q: v[n][2h + j] is row
// g + 8h, column q_col(n, t) + j, q_col(n, t) = 16 (n / 2) + 4 t + 2 (n % 2),
// so that lane t holds columns 16 k + 4 t .. 16 k + 4 t + 3 of each k < 4 and
// a row moves between the fragment and memory as four 16-byte accesses a
// lane (load_row_q, store_row_q) where the plain layout needs eight 8-byte
// ones. Fragment slot 8 n + 2 t + j then holds column c with q_slot(c) =
// 8 n + 2 t + j. A product whose output is in layout Q takes its weight
// with the output rows placed at q_slot (load_weight_wg's PERM_O,
// load_weight_rows' PERM); a product whose A operand is in layout Q takes
// it with the inputs placed at q_slot (PERM_P). Sums over a row's columns
// (the LayerNorm's moments) and elementwise functions do not depend on
// the order.
__device__ __forceinline__ int q_col(int n, int t) { return 16 * (n >> 1) + 4 * t + 2 * (n & 1); }

__host__ __device__ constexpr int q_slot(int c) {
  return (c & ~15) | ((c & 2) << 2) | ((c >> 1) & 6) | (c & 1);
}

// half h (row g + 8h) of a layout-Q fragment from a row of 64 floats in
// device memory (16-byte aligned), through the read-only path
__device__ __forceinline__ void load_row_q(float (&x)[8][4], int h, const float* row) {
  const Lane l;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row + 16 * k + 4 * l.t));
    x[2 * k][2 * h] = v.x;
    x[2 * k][2 * h + 1] = v.y;
    x[2 * k + 1][2 * h] = v.z;
    x[2 * k + 1][2 * h + 1] = v.w;
  }
}

// half h of a layout-Q fragment into a row of 64 floats
__device__ __forceinline__ void store_row_q(float* row, const float (&x)[8][4], int h) {
  const Lane l;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<float4*>(row + 16 * k + 4 * l.t) =
        make_float4(x[2 * k][2 * h], x[2 * k][2 * h + 1], x[2 * k + 1][2 * h],
                    x[2 * k + 1][2 * h + 1]);
}

// A (64 out, 64 in) slice of a weight (row stride ld_src, from column off)
// into dst with row stride kWld, for gemm and gemm_cols2, by `threads`
// threads with 16-byte loads; with PERM, row o goes to row q_slot(o), so
// that the product's output is in layout Q.
template <bool PERM = false>
__device__ __forceinline__ void load_weight_rows(float* dst, const float* __restrict__ w,
                                                 int ld_src, int off, int threads) {
  for (int i = threadIdx.x; i < 64 * 16; i += threads) {
    const int r = i >> 4, c4 = i & 15;
    *reinterpret_cast<float4*>(dst + (PERM ? q_slot(r) : r) * kWld + 4 * c4) =
        __ldg(reinterpret_cast<const float4*>(w + r * ld_src + off) + c4);
  }
}

// Rows of a row fragment from a (rows, 64) array with row stride ld
// (device or shared memory): rows r0 + g and r0 + g + 8, zero at and past
// row `valid`.
template <bool GLOBAL>
__device__ __forceinline__ void load_rows(float (&x)[8][4], const float* src, int ld,
                                          int r0, int valid) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + l.g + 8 * h;
    const float* row = src + static_cast<long long>(r) * ld + 2 * l.t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float2 v = make_float2(0.0f, 0.0f);
      if (r < valid)
        v = GLOBAL ? __ldg(reinterpret_cast<const float2*>(row + 8 * n))
                   : *reinterpret_cast<const float2*>(row + 8 * n);
      x[n][2 * h] = v.x;
      x[n][2 * h + 1] = v.y;
    }
  }
}

// the rows r0 + g, r0 + g + 8 of a row fragment into dst (row stride ld),
// those below `valid` only
__device__ __forceinline__ void store_rows(float* dst, int ld, const float (&x)[8][4],
                                           int r0, int valid) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + l.g + 8 * h;
    if (r >= valid) continue;
    float* row = dst + static_cast<long long>(r) * ld + 2 * l.t;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      *reinterpret_cast<float2*>(row + 8 * n) = make_float2(x[n][2 * h], x[n][2 * h + 1]);
  }
}

// A warp's 16 staged rows r0 .. r0 + 15 (shared memory, row stride kWld)
// to dst (row stride 64), those below `valid`, as 16-byte stores that
// write whole rows: the row fragment's own 8-byte stores touch 8 rows
// each. The caller stages the rows with store_rows first.
__device__ __forceinline__ void copy_out_rows(float* dst, const float* stage, int r0,
                                              int valid) {
  __syncwarp();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = r0 + 2 * i + (lane >> 4), c4 = lane & 15;
    if (r < valid)
      *reinterpret_cast<float4*>(dst + static_cast<long long>(r) * 64 + 4 * c4) =
          *reinterpret_cast<const float4*>(stage + r * kWld + 4 * c4);
  }
  __syncwarp();
}

// x[., c] += v[c] for a (64,) vector in shared memory
__device__ __forceinline__ void add_cols(float (&x)[8][4], const float* v) {
  const Lane l;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const float2 b = *reinterpret_cast<const float2*>(v + 8 * n + 2 * l.t);
    x[n][0] += b.x;
    x[n][1] += b.y;
    x[n][2] += b.x;
    x[n][3] += b.y;
  }
}

// sum over the quad of lanes that holds one row
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  return v;
}

// LayerNorm of each row over its 64 columns (biased variance, eps), in
// place. With gamma and beta (shared memory) the output is x_hat * gamma +
// beta; without, x_hat, and rstd[h] returns 1/sqrt(var + eps) of row g + 8h
// for the backward. Every lane of the warp must take part.
__device__ __forceinline__ void layer_norm(float (&x)[8][4], const float* gamma,
                                           const float* beta, float eps,
                                           float* rstd = nullptr) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n) s += x[n][2 * h] + x[n][2 * h + 1];
    const float mean = quad_sum(s) * (1.0f / 64.0f);
    float sq = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        x[n][2 * h + j] -= mean;
        sq = fmaf(x[n][2 * h + j], x[n][2 * h + j], sq);
      }
    const float r = rsqrtf(quad_sum(sq) * (1.0f / 64.0f) + eps);
    if (rstd != nullptr) rstd[h] = r;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float v = x[n][2 * h + j] * r;
        if (gamma != nullptr) {
          const int c = 8 * n + 2 * l.t + j;
          v = fmaf(v, gamma[c], beta[c]);
        }
        x[n][2 * h + j] = v;
      }
  }
}

// LayerNorm backward: dy is the gradient of the output on entry and of the
// input on return; xhat and rstd come from layer_norm without gamma, and
// gamma (shared memory) scales dy first. The scale and shift gradients are
// column sums of dy * xhat and dy on entry (add_col_sums).
__device__ __forceinline__ void layer_norm_bwd(float (&dy)[8][4], const float (&xhat)[8][4],
                                               const float (&rstd)[2], const float* gamma) {
  const Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& d = dy[n][2 * h + j];
        d *= gamma[8 * n + 2 * l.t + j];
        s1 += d;
        s2 = fmaf(d, xhat[n][2 * h + j], s2);
      }
    const float m1 = quad_sum(s1) * (1.0f / 64.0f), m2 = quad_sum(s2) * (1.0f / 64.0f);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        dy[n][2 * h + j] = rstd[h] * (dy[n][2 * h + j] - m1 - xhat[n][2 * h + j] * m2);
  }
}

// slot[c] += the sum over the fragment's 16 rows of x[., c] (times y[., c]
// when y is given), for the 64 columns: a fixed shuffle tree over the row
// groups, then lanes g = 0 add into the warp's own slot in shared memory
__device__ __forceinline__ void add_col_sums(float* slot, const float (&x)[8][4],
                                             const float (*y)[4] = nullptr) {
  const Lane l;
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float v = y == nullptr ? x[n][j] + x[n][2 + j]
                             : x[n][j] * y[n][j] + x[n][2 + j] * y[n][2 + j];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (l.g == 0) slot[8 * n + 2 * l.t + j] += v;
    }
}

// acc += A^T . G over `rows` rows of two (rows, 64) tiles in shared memory
// (row stride ld): the lane's part of output rows o0 + g, o0 + g + 8 (a
// column of A each) by the 64 columns of G, in the row-fragment layout. The
// k slots t, t + 4 of step kk stand for tile rows 8 kk + t, 8 kk + t + 4.
// This is a weight gradient's share over a tile: dW[o][i] += sum_m
// A[m][o] G[m][i], with rows past the live ones zero in either tile.
__device__ __forceinline__ void gemm_tn(float (&acc)[8][4], const float* a, int o0,
                                        const float* gm, int ld = kWld, int rows = 64) {
  const Lane l;
  // the tile's share starts from zero and joins acc on the float32 units:
  // acc runs over all of a group's tiles, and kept in the tensor core it
  // would drift toward zero with every product (see mma3x4)
  float t[8][4];
  zero(t);
#pragma unroll 2
  for (int kk = 0; kk < rows / 8; ++kk) {
    const float* ra = a + (8 * kk + l.t) * ld + o0 + l.g;
    uint32_t ah[4], al[4];
    split(ra[0], ah[0], al[0]);
    split(ra[8], ah[1], al[1]);
    split(ra[4 * ld], ah[2], al[2]);
    split(ra[4 * ld + 8], ah[3], al[3]);
    const float* rg = gm + (8 * kk + l.t) * ld + l.g;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float b[4][2];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        b[q][0] = rg[8 * (4 * h + q)];
        b[q][1] = rg[4 * ld + 8 * (4 * h + q)];
      }
      if (h == 0)
        mma3x4<0>(t, ah, al, b);
      else
        mma3x4<4>(t, ah, al, b);
    }
  }
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] += t[n][j];
}

// ---- warpgroup products (wgmma) -------------------------------------------
//
// A group of 4 aligned warps (a warpgroup) owns a 64-row tile, 16 rows a
// warp in the row-fragment layout, which is wgmma's register layout for A
// and for the accumulator. x . W^T then runs as wgmma.mma_async
// m64n64k8 TF32 with A in registers and W in shared memory, 3xTF32 as
// three products a k-step: lo.hi, hi.lo, hi.hi. The tensor core reads W
// from shared memory as it is, so W is held split: its hi and lo halves
// (kWgHalf floats each), each in the canonical K-major layout without
// swizzle: core matrices of 8 outputs x 4 inputs (128 bytes), the 8 of a
// k-chunk 128 bytes apart (SBO), the 2 k-chunks of a k-step 1024 bytes
// apart (LBO), k-steps 2048 bytes apart. A k-step's inputs are taken in
// the row fragment's order: chunk 0 holds columns 8 kk + 2t, chunk 1
// columns 8 kk + 2t + 1.
constexpr int kWgHalf = 64 * 64;

// W[o][k] (64 x 64 of a weight with row stride ld, from column off) into
// dst as the two halves, by `threads` threads; with TRANSPOSE, W^T (for
// x . W, where W[k][o] is at w[k * ld + off + o]). PERM_O puts output o at
// q_slot(o) (the product's output in layout Q), PERM_P input p at
// q_slot(p) (its A operand in layout Q).
template <bool TRANSPOSE = false, bool PERM_O = false, bool PERM_P = false>
__device__ __forceinline__ void load_weight_wg(float* dst, const float* __restrict__ w,
                                               int ld, int off, int threads) {
  for (int i = threadIdx.x; i < 64 * 64; i += threads) {
    const int a = i >> 6, b = i & 63;  // reads along b, the contiguous index
    int o = TRANSPOSE ? b : a, p = TRANSPOSE ? a : b;
    if (PERM_O) o = q_slot(o);
    if (PERM_P) p = q_slot(p);
    const float x = __ldg(w + a * ld + off + b);
    const int kk = p >> 3, t = (p & 7) >> 1, j = p & 1;
    const int idx = ((kk * 2 + j) * 8 + (o >> 3)) * 32 + (o & 7) * 4 + t;
    const uint32_t hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
    dst[idx] = __uint_as_float(hi);
    dst[kWgHalf + idx] = x - __uint_as_float(hi);
  }
}

// the wgmma descriptor of one half at its first k-step
__device__ __forceinline__ uint64_t wg_desc(const float* half) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(half));
  return static_cast<uint64_t>((a >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>(1024 >> 4) << 16) | (static_cast<uint64_t>(128 >> 4) << 32);
}

__device__ __forceinline__ void wgmma_k8(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1));
}

// keep the compiler from moving a register across the asynchronous product
__device__ __forceinline__ void fence_operands(float (&x)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(x[n][j])::"memory");
}

// acc += x . W^T over the warpgroup's 64 rows, W held by load_weight_wg.
// Every warp of the group calls it together (wgmma is warpgroup-wide). The
// k-steps go in batches of KB, each waited for before the next one's A
// operand is split: KB = 8 holds 64 registers of A at once, KB = 4 half.
template <int KB = 8>
__device__ __forceinline__ void gemm_wg(float (&acc)[8][4], const float (&x)[8][4],
                                        const float* w) {
  const uint64_t dh = wg_desc(w), dl = wg_desc(w + kWgHalf);
#pragma unroll
  for (int k0 = 0; k0 < 8; k0 += KB) {
    uint32_t ah[KB][4], al[KB][4];
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) a_operand(x, k0 + kk, ah[kk], al[kk]);
    fence_operands(acc);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < KB; ++kk) {  // 2048 bytes a k-step: 128 in the address field
      const uint64_t step = 128 * (k0 + kk);
      wgmma_k8(acc, al[kk], dh + step);
      wgmma_k8(acc, ah[kk], dl + step);
      wgmma_k8(acc, ah[kk], dh + step);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_operands(acc);
#pragma unroll
    for (int kk = 0; kk < KB; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        asm volatile("" : "+r"(ah[kk][i]), "+r"(al[kk][i])::"memory");
  }
}

// bar.sync on a named barrier for the `threads` threads of one group
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a kernel's blocks per SM, registers per thread, dynamic shared memory per
// block, after allowing it that much shared memory
template <typename K>
cudaError_t occupancy(K kernel, int threads, int bytes, int* blocks, int* regs, int* smem) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return err;
  *regs = a.numRegs;
  *smem = bytes;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, bytes);
}

// the current device's SM count, read once per device
inline int sm_count() {
  static int cached[16] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 16) return 132;
  if (cached[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    cached[dev] = n > 0 ? n : 132;
  }
  return cached[dev];
}

}  // namespace tc
