// Shared pieces of the fused edge-phase kernels: the sizes, edge modes and
// SiLU of K3, K4, K7 and K8 (fused_edge.cu, fused_edge_bwd*.cu,
// fused_edge_v2.cu, fused_edge_v2_bwd.cu), the in-kernel edge embedder on
// tensor-core row fragments (tc_tf32.cuh; on bf16 fragments, tc_bf16.cuh,
// for the bf16-operand K3 and K4) that K3, K7 and K4's recompute of
// pre run, and the SIMT tile helpers of the edge pass that K4 and K8 share
// (fused_edge_bwd_common.cuh).
//
// The SIMT helpers work on tiles of 64 rows by D = 64 features held in
// shared memory with a padded row stride, with 256 threads laid out as 16
// row groups x 16 column groups: thread (rg, cg) owns rows rg + 16 i and
// columns 4 cg + j of a tile, i, j < 4. Every product of a tile with a
// 64x64 weight is register-tiled 4x4 per thread in exact float32.

#pragma once

#include <cuda_runtime.h>

#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

namespace fused_edge {

constexpr int D = 64;            // hidden width the kernels are compiled for
constexpr int kThreads = 256;    // 16 row groups x 16 column groups of 4
constexpr int kTileRows = 64;    // (edge, batch) rows per tile
constexpr int kRecRows = 32;     // (receiver, batch) rows per receiver chunk
constexpr int kLd = 68;          // padded row stride of the row tiles
constexpr int kMaxFeat = 8;      // raw edge feature width limit
constexpr float kLnEps = 1e-5f;

enum EdgeMode { EDGE_RAW = 0, EDGE_SHARED = 1, EDGE_BATCHED = 2 };

__device__ __forceinline__ float silu(float x) { return x / (1.0f + expf(-x)); }

// d SiLU(x) / dx = s (1 + x (1 - s)), s = sigmoid(x)
__device__ __forceinline__ float silu_grad(float x) {
  const float s = 1.0f / (1.0f + expf(-x));
  return s * (1.0f + x * (1.0f - s));
}

// The edge embedder's hidden layer SiLU(f . We1 + be1) of edges t0 + el0 + g
// and t0 + el0 + g + 8 (zero features at el >= ne) as a row fragment
// (tc_tf32.cuh): F <= kMaxFeat multiply-adds a value on the SIMT units.
// feats is the (E, F) raw feature array (float or bf16); sEW1 (F, D) and
// sEB1 (D,) are in shared memory. With BF the features are rounded to bf16
// and sEW1 must hold bf16 values: each product is exact, the sum float32.
template <bool BF = false, typename T = float>
__device__ __forceinline__ void embed_hidden(float (&a1)[8][4], const T* feats, int F,
                                             int t0, const float* sEW1, const float* sEB1,
                                             int el0, int ne) {
  const tc::Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int el = el0 + l.g + 8 * h;
    float f[kMaxFeat];
#pragma unroll
    for (int k = 0; k < kMaxFeat; ++k) {
      f[k] = (k < F && el < ne)
                 ? tc::ldg_val(feats + static_cast<long long>(t0 + el) * F + k)
                 : 0.0f;
      if (BF) f[k] = tc::bf16r(f[k]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * n + 2 * l.t + j;
        float v = sEB1[c];
#pragma unroll
        for (int k = 0; k < kMaxFeat; ++k)
          if (k < F) v = fmaf(f[k], sEW1[k * D + c], v);
        a1[n][2 * h + j] = silu(v);
      }
  }
}

// edge_val of edges t0 + el0 + g, t0 + el0 + g + 8 (zero at el >= ne) as a
// row fragment: the shared (E, D) edge rows (EDGE_SHARED), or the embedder
// on the raw (E, F) features, with its second layer We2 in shared memory
// as tc::load_weight_rows leaves it (or, with GW, the (D, D) weight in
// device memory, read through L1) and sEV = eb1 | eb2 | eg | ebt.
template <int MODE, bool BF = false, bool GW = false, typename T = float>
__device__ __forceinline__ void edge_value(float (&ev)[8][4], const T* edge, int F,
                                           int t0, const float* sEW1, const float* sEW2,
                                           const float* sEV, int el0, int ne) {
  if (MODE == EDGE_SHARED) {
    tc::load_rows<true>(ev, edge + static_cast<long long>(t0) * D, D, el0, ne);
    return;
  }
  embed_hidden<BF>(ev, edge, F, t0, sEW1, sEV, el0, ne);
  float z[8][4];
  tc::zero(z);
  tc::gemm<GW, BF>(z, ev, sEW2, GW ? D : tc::kWld);
  tc::add_cols(z, sEV + D);
  tc::layer_norm(z, sEV + 2 * D, sEV + 3 * D, kLnEps);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) ev[n][j] = z[n][j];
}

// edge_value for the bf16-operand kernels on bf16 fragments (tc_bf16.cuh:
// K3's BF instantiations and K4's BF recompute): the embedder's second
// layer as mma.sync m16n8k16 on We2 in shared memory in the core layout
// (tcb::load_weight) or, with GW, the float32 (D, D) weight in device
// memory; everything else as edge_value<MODE, true>.
template <int MODE, bool GW = false, typename T = float>
__device__ __forceinline__ void edge_value_bf(float (&ev)[8][4], const T* edge, int F, int t0,
                                              const float* sEW1, const void* ew2,
                                              const float* sEV, int el0, int ne) {
  if (MODE == EDGE_SHARED) {
    tc::load_rows<true>(ev, edge + static_cast<long long>(t0) * D, D, el0, ne);
    return;
  }
  embed_hidden<true>(ev, edge, F, t0, sEW1, sEV, el0, ne);
  uint32_t a[4][4];
  tcb::pack_frag(a, ev);
  float z[8][4];
  tc::zero(z);
  if (GW)
    tcb::gemm_g(z, a, static_cast<const float*>(ew2), D);
  else
    tcb::gemm(z, a, static_cast<const tcb::bf16*>(ew2));
  tc::add_cols(z, sEV + D);
  tc::layer_norm(z, sEV + 2 * D, sEV + 3 * D, kLnEps);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) ev[n][j] = z[n][j];
}

__device__ __forceinline__ float sum16(float v) {
  // the 16 lanes of one row group are one half of a warp
  v += __shfl_xor_sync(0xffffffffu, v, 8);
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// dst[k*ldd + c] = w[c*ld + off + k] for k < D, c < D: a 64x64 slice of
// an nn.Linear (out, in) weight, transposed into (in, out). Thread i reads
// inputs 8*(i/D) .. +7 of output row c = i%D as two 16-byte loads (one
// whole 32-byte sector; ld and off are multiples of 4, the weight is
// 16-byte aligned) and writes them down column c, so the 32 threads of a
// warp write 32 consecutive floats of each row.
// With BF the values are rounded to bf16 (a SIMT product's operand).
template <bool BF = false>
__device__ __forceinline__ void load_weight_t(float* dst, int ldd,
                                              const float* __restrict__ w,
                                              int ld, int off) {
  for (int i = threadIdx.x; i < D * D / 8; i += kThreads) {
    const int c = i % D, k0 = 8 * (i / D);
    const float4* src = reinterpret_cast<const float4*>(w + c * ld + off + k0);
    float4 lo = __ldg(src), hi = __ldg(src + 1);
    if (BF) {
      lo = make_float4(tc::bf16r(lo.x), tc::bf16r(lo.y), tc::bf16r(lo.z), tc::bf16r(lo.w));
      hi = make_float4(tc::bf16r(hi.x), tc::bf16r(hi.y), tc::bf16r(hi.z), tc::bf16r(hi.w));
    }
    float* d = dst + k0 * ldd + c;
    d[0] = lo.x;
    d[ldd] = lo.y;
    d[2 * ldd] = lo.z;
    d[3 * ldd] = lo.w;
    d[4 * ldd] = hi.x;
    d[5 * ldd] = hi.y;
    d[6 * ldd] = hi.z;
    d[7 * ldd] = hi.w;
  }
}

// dst[c*D + k] = w[c*ld + off + k]: the same 64x64 slice kept in its
// (out, in) layout, which is the (in, out) layout of the transposed
// product x . W^T that the backward needs. BF as for load_weight_t.
template <bool BF = false>
__device__ __forceinline__ void load_weight_raw(float* dst,
                                                const float* __restrict__ w,
                                                int ld, int off) {
  for (int i = threadIdx.x; i < D * D / 4; i += kThreads) {
    const int c = i / (D / 4), k4 = i - c * (D / 4);
    float4 v = __ldg(reinterpret_cast<const float4*>(w + c * ld + off) + k4);
    if (BF) v = make_float4(tc::bf16r(v.x), tc::bf16r(v.y), tc::bf16r(v.z), tc::bf16r(v.w));
    *reinterpret_cast<float4*>(dst + c * D + 4 * k4) = v;
  }
}

// acc[i][j] += sum_k A[(rg + 16 i) * kLd + k] * W[k * LDW + 4 cg + j] for
// i < NI, k ascending (the same order for every NI)
template <int NI, int LDW = D>
__device__ __forceinline__ void mm_acc(float (&acc)[4][4], const float* A,
                                       const float* W, int rg, int cg) {
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 a[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i)
      a[i] = *reinterpret_cast<const float4*>(A + (rg + 16 * i) * kLd + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const float4 w = *reinterpret_cast<const float4*>(W + (k + kk) * LDW + 4 * cg);
#pragma unroll
      for (int i = 0; i < NI; ++i) {
        const float v = kk == 0 ? a[i].x : kk == 1 ? a[i].y : kk == 2 ? a[i].z : a[i].w;
        acc[i][0] = fmaf(v, w.x, acc[i][0]);
        acc[i][1] = fmaf(v, w.y, acc[i][1]);
        acc[i][2] = fmaf(v, w.z, acc[i][2]);
        acc[i][3] = fmaf(v, w.w, acc[i][3]);
      }
    }
  }
}

// w[i][j] += sum_m A[m * kLd + 4 rg + i] * G[m * kLd + 4 cg + j] over the
// tile's 64 rows, m ascending: the thread's 4x4 share of the 64x64 weight
// gradient A^T . G, row = input feature, column = output feature.
__device__ __forceinline__ void wgrad_acc(float (&w)[4][4], const float* A,
                                          const float* G, int rg, int cg) {
#pragma unroll 4
  for (int m = 0; m < kTileRows; ++m) {
    const float4 a = *reinterpret_cast<const float4*>(A + m * kLd + 4 * rg);
    const float4 g = *reinterpret_cast<const float4*>(G + m * kLd + 4 * cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float v = i == 0 ? a.x : i == 1 ? a.y : i == 2 ? a.z : a.w;
      w[i][0] = fmaf(v, g.x, w[i][0]);
      w[i][1] = fmaf(v, g.y, w[i][1]);
      w[i][2] = fmaf(v, g.z, w[i][2]);
      w[i][3] = fmaf(v, g.w, w[i][3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
}

// LayerNorm of the thread's first ni rows over the D features held by the
// 16 threads of its row group; biased variance, eps 1e-5. ni is uniform
// across the block, so every lane takes part in the shuffles. With
// rstd_out, acc is left as the normalised value x_hat (no scale and shift)
// and the row's 1/sqrt(var + eps) is returned for the backward.
__device__ __forceinline__ void row_layer_norm(float (&acc)[4][4], const float* g,
                                               const float* bt, int cg, int ni = 4,
                                               float* rstd_out = nullptr) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= ni) break;
    const float mean =
        sum16(acc[i][0] + acc[i][1] + acc[i][2] + acc[i][3]) * (1.0f / D);
    float sq = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc[i][j] -= mean;
      sq = fmaf(acc[i][j], acc[i][j], sq);
    }
    const float rstd = rsqrtf(sum16(sq) * (1.0f / D) + kLnEps);
    if (rstd_out != nullptr) {
      rstd_out[i] = rstd;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] *= rstd;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        acc[i][j] = acc[i][j] * rstd * g[c] + bt[c];
      }
    }
  }
}

// LayerNorm backward for the thread's first ni rows: dy is the gradient of
// the LayerNorm output on entry and of its input on return; xhat and rstd
// come from row_layer_norm. dgam[j] += dy * xhat and dbet[j] += dy are the
// thread's share of the scale and shift gradients for its 4 columns.
__device__ __forceinline__ void row_layer_norm_bwd(
    float (&dy)[4][4], const float (&xhat)[4][4], const float (&rstd)[4],
    const float* g, int cg, float (&dgam)[4], float (&dbet)[4], int ni = 4) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (i >= ni) break;
    float s1 = 0.0f, s2 = 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dgam[j] = fmaf(dy[i][j], xhat[i][j], dgam[j]);
      dbet[j] += dy[i][j];
      dy[i][j] *= g[4 * cg + j];  // d x_hat
      s1 += dy[i][j];
      s2 = fmaf(dy[i][j], xhat[i][j], s2);
    }
    const float m1 = sum16(s1) * (1.0f / D), m2 = sum16(s2) * (1.0f / D);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dy[i][j] = rstd[i] * (dy[i][j] - m1 - xhat[i][j] * m2);
  }
}

// With BF the staged values are rounded to bf16 (a SIMT product's operand).
template <bool BF = false>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[4][4],
                                           int rg, int cg, int ni = 4) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (i < ni) {
      float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      if (BF) v = make_float4(tc::bf16r(v.x), tc::bf16r(v.y), tc::bf16r(v.z), tc::bf16r(v.w));
      *reinterpret_cast<float4*>(dst + (rg + 16 * i) * kLd + 4 * cg) = v;
    }
}

// four consecutive values of a row in device memory (float or bf16), as floats
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

// rows [0, rows) of dst <- rows [0, n) of the contiguous (., D) block
// at src (float or bf16), zero beyond n; BF as for store_rows
template <bool BF = false, typename T = float>
__device__ __forceinline__ void load_rows(float* dst, const T* __restrict__ src,
                                          int n, int rows) {
  for (int i = threadIdx.x; i < rows * (D / 4); i += kThreads) {
    const int m = i / (D / 4), c4 = i - m * (D / 4);
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < n) v = ldg4(src + m * D + 4 * c4);
    if (BF) v = make_float4(tc::bf16r(v.x), tc::bf16r(v.y), tc::bf16r(v.z), tc::bf16r(v.w));
    *reinterpret_cast<float4*>(dst + m * kLd + 4 * c4) = v;
  }
}

}  // namespace fused_edge
