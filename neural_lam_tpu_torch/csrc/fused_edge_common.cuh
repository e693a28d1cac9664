// Shared pieces of the fused edge-phase kernels: the sizes, edge modes and
// SiLU of K3, K4, K7 and K8 (fused_edge.cu, fused_edge_bwd*.cu,
// fused_edge_v2.cu, fused_edge_v2_bwd.cu), the in-kernel edge embedder on
// tensor-core row fragments (tc_tf32.cuh; on bf16 fragments, tc_bf16.cuh,
// for the bf16-operand K3, K4 and K7) that K3, K7, K4's recompute of pre and
// K4's and K8's edge pass (fused_edge_bwd_common.cuh) run.

#pragma once

#include <cuda_runtime.h>

#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

namespace fused_edge {

constexpr int D = 64;            // hidden width the kernels are compiled for
constexpr int kTileRows = 64;    // (edge, batch) rows per tile
constexpr int kRecRows = 32;     // (receiver, batch) rows per receiver chunk
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
// Without ACT the pre-activation f . We1 + be1 itself (the edge pass's
// SiLU').
template <bool BF = false, typename T = float, bool ACT = true>
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
        a1[n][2 * h + j] = ACT ? silu(v) : v;
      }
  }
}

// edge_val of edges t0 + el0 + g, t0 + el0 + g + 8 (zero at el >= ne) as a
// row fragment, in float32 (3xTF32): the shared (E, D) edge rows
// (EDGE_SHARED), or the embedder on the raw (E, F) features, with its
// second layer We2 in shared memory as tc::load_weight_rows leaves it (or,
// with GW, the (D, D) weight in device memory, read through L1) and sEV =
// eb1 | eb2 | eg | ebt.
template <int MODE, bool GW = false, typename T = float>
__device__ __forceinline__ void edge_value(float (&ev)[8][4], const T* edge, int F,
                                           int t0, const float* sEW1, const float* sEW2,
                                           const float* sEV, int el0, int ne) {
  if (MODE == EDGE_SHARED) {
    tc::load_rows<true>(ev, edge + static_cast<long long>(t0) * D, D, el0, ne);
    return;
  }
  embed_hidden(ev, edge, F, t0, sEW1, sEV, el0, ne);
  float z[8][4];
  tc::zero(z);
  tc::gemm<GW>(z, ev, sEW2, GW ? D : tc::kWld);
  tc::add_cols(z, sEV + D);
  tc::layer_norm(z, sEV + 2 * D, sEV + 3 * D, kLnEps);
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) ev[n][j] = z[n][j];
}

// edge_value for the bf16-operand kernels on bf16 fragments (tc_bf16.cuh:
// K3's and K7's BF instantiations and K4's BF recompute): the features
// rounded to bf16 for the SIMT layer, the embedder's second layer as
// mma.sync m16n8k16 on We2 in shared memory in the core layout
// (tcb::load_weight) or, with GW, the float32 (D, D) weight in device
// memory; everything else as edge_value.
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

// four consecutive values of a row in device memory (float or bf16), as floats
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 ldg4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}

}  // namespace fused_edge
