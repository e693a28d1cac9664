// Shared pieces of the fused edge-phase backward kernels K4
// (fused_edge_bwd.cu) and K8 (fused_edge_v2_bwd.cu): the edge input's
// share after their main kernels, K4's receiver slice, and the reduce of
// every backward kernel's workspace.
//
// The main kernels write d_pre[e, b] (a batched edge input) or s[e] =
// sum_b d_pre[e, b] (the per-edge edge inputs, EDGE_RAW and EDGE_SHARED).
// From d_pre, fused_edge_bwd_rows forms d_edge[e, b] = d_pre . W1e (+
// d_new_edge[e, b]) and dW1e += d_pre^T . edge per (edge, b) row. From s,
// the edge pass fused_edge_bwd_edge forms
//
//   dW1e += s^T . edge_val
//   d_edge_val = s[e] . W1e (+ sum_b d_new_edge[e, b])
//   EDGE_SHARED  d_edge[e] = d_edge_val
//   EDGE_RAW     the embedder is recomputed per edge and d_edge_val goes
//                through its LayerNorm, second and first layer into its six
//                weight gradients (the raw features are constants)
//
// over tiles of 64 edges, B times fewer rows than the main kernel's streams.
// K4's receiver slice, fused_edge_bwd_receiver, is the rows pass on other
// operands: d_rec[n, b] = d_recproj[n, b] . W1r and dW1r += d_recproj^T .
// rec, the node-sized products that the JAX package forms outside its
// kernel (pallas_fused.py:1624-1631), in float32 whatever the precision.
// Every block (or group of warps) keeps its share of each weight gradient
// in registers and writes it once to a (groups, stride) workspace;
// reduce_workspace sums each workspace over the groups in group order, so
// the gradients are deterministic without float atomics.
//
// The edge pass on the tensor cores. A group of 4 warps (one warpgroup)
// owns a tile, 16 edges a warp, as row fragments (tc_tf32.cuh), and the
// tile's chain stays in registers: d_edge_val = s . W1e (+ the d_new_edge
// sums), for EDGE_RAW the embedder again (f . We1 on the SIMT units, F <=
// 8; a1 . We2^T; LayerNorm), its backward (LayerNorm, d_a1 = dx . We2,
// SiLU') and the weight gradients dW1e += s^T . edge_val and dEW2 += dx^T .
// a1, whose operands go through two tiles in shared memory. dEW1 (F x 64)
// stays on the SIMT units. A block holds the weights once and runs
// kEdgeGroups groups; group i of the grid takes the tiles i, i + groups,
// ... (a fixed assignment: the partial sums are the same on every run).
//   * float32: 3xTF32. The row products are wgmma with the rows in
//     registers (tc::gemm_wg; W1e^T, We2 and We2^T split for it), the
//     weight gradients mma.sync from the two tiles (tc::gemm_tn), each
//     tile's share added on the float32 units. The tiles hold s and
//     edge_val, then dx and a1, then d_p1; d_edge_val waits in a tile
//     across the embedder's forward and the embedder's pre-activation is
//     formed again where SiLU' needs it, so that no more than two row
//     fragments and the two 16 x 64 gradient shares are live at once.
//   * BF (the bf16-operand instantiations, K4's and K8's bf16 variants):
//     bf16 fragments (tc_bf16.cuh): wgmma m64n64k16 with one bf16 copy of
//     W1e and We2, read in both orientations through the transpose bit, and
//     the weight gradients wgmma from bf16 tiles, accumulated in the tensor
//     core; p1 waits in a float32 tile, so the embedder's first layer runs
//     once a tile. The operands are rounded to bf16 where the float32 pass
//     rounds them (the weights, edge_val, a1, dx, d_p1 and the features),
//     with float32 sums. s[e] is the sum over the batch of d_pre rounded to bf16
//     (the main kernel's) and enters the products as it is: as two bf16
//     terms, hi = bf16(s) and lo = bf16(s - hi), which hold it to about 16
//     bits (the JAX kernel's d_pre . W1e over a column-tiled weight sums the
//     same bf16 products).
// Bound on the H100: operations at 3xTF32 (or at the bf16 rate), or the
// bytes of s, the raw features and d_new_edge.

#pragma once

#include <type_traits>

#include "fused_edge_common.cuh"
#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

namespace fused_edge {

constexpr int kMat = D * D;
// floats per group in the edge pass's workspace (the wrappers size it the
// same): dW1e dEW2 as (out, in) | dEW1 as (D, kMaxFeat) | deb1 deb2 deg debt
constexpr int kEdgeStride = 2 * kMat + kMaxFeat * D + 4 * D;
constexpr int kEdgeGroupThreads = 128;  // a group is one warpgroup
constexpr int kEdgeGroups = 3;          // per block; the wrappers size the grid by it
constexpr int kEdgeThreads = kEdgeGroups * kEdgeGroupThreads;

template <typename TI>
struct EdgeParamsT {
  const TI* edge;        // (E, feat) raw features or (E, D)
  const float* presum;   // (E, D): s
  const TI* d_new_edge;  // (E, B, D) or null
  const float* w1;
  const float* ew1;
  const float* eb1;
  const float* ew2;
  const float* eb2;
  const float* eg;
  const float* ebt;
  TI* d_edge;  // (E, D), EDGE_SHARED only
  float* ws;   // (gridDim.x * kEdgeGroups, kEdgeStride)
  int n_edges;
  int batch;
  int feat;
};

// The edge pass's shared memory, in floats: the weights (W1e, and for
// EDGE_RAW We2 in both orientations: split for wgmma, or one bf16 copy
// each with BF), the embedder's vectors eb1 eb2 eg ebt and We1 as (F, D),
// then per group two float32 tiles (or three bf16 ones with BF: s as hi and
// lo, and edge_val, and for EDGE_RAW a float32 one that holds the
// embedder's pre-activation p1 for SiLU'), the tile's raw features and the
// warps' column-sum slots.
struct EdgePlan {
  int w1e, ew2, ew2t, vec, ew1, groups, group_floats, total;
  int t1, t2, t3, t4, feats, slots;  // offsets inside a group
};

__host__ __device__ constexpr EdgePlan edge_plan(bool raw, bool bf) {
  EdgePlan s{};
  const int mat = bf ? tcb::kMatFloats : 2 * tc::kWgHalf;
  const int tile = bf ? tcb::kMatFloats : kTileRows * tc::kWld;
  int o = 0;
  s.w1e = o; o += mat;
  s.ew2 = o; o += raw ? mat : 0;
  s.ew2t = o; o += raw && !bf ? mat : 0;
  s.vec = o; o += raw ? 4 * D : 0;
  s.ew1 = o; o += raw ? kMaxFeat * D : 0;
  s.groups = o;
  int g = 0;
  s.t1 = g; g += tile;
  s.t2 = g; g += tile;
  s.t3 = g; g += bf ? tile : 0;
  s.t4 = g; g += bf && raw ? kTileRows * tc::kWld : 0;  // the embedder's p1, float32
  s.feats = g; g += raw ? kTileRows * kMaxFeat : 0;
  s.slots = g; g += raw ? 4 * 4 * D : 0;  // per warp: deb1 deb2 deg debt
  s.group_floats = g;
  s.total = o + kEdgeGroups * g;
  return s;
}

constexpr int edge_smem_bytes(bool raw, bool bf) {
  return edge_plan(raw, bf).total * static_cast<int>(sizeof(float));
}

// x[., c] += sum_b src[e, b, c] for the warp's edges e = e0 + r0 + g (+8)
// below `valid` (src (E, B, D), float or bf16)
template <typename TI>
__device__ __forceinline__ void add_batch_sum(float (&x)[8][4], const TI* src, int B,
                                              long long e0, int r0, int valid) {
  const tc::Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + l.g + 8 * h;
    if (r >= valid) continue;
    const TI* row = src + (e0 + r) * B * D + 2 * l.t;
    for (int b = 0; b < B; ++b)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const float2 v = tc::ldg_pair(row + b * D + 8 * n);
        x[n][2 * h] += v.x;
        x[n][2 * h + 1] += v.y;
      }
  }
}

// x * gamma + beta (per column, vectors in shared memory) of the warp's
// rows r0 + g (+8) into a float32 tile (row stride kWld)
__device__ __forceinline__ void store_rows_affine(float* dst, const float (&x)[8][4],
                                                  const float* gamma, const float* beta,
                                                  int r0) {
  const tc::Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 8 * n + 2 * l.t;
      *reinterpret_cast<float2*>(dst + (r0 + l.g + 8 * h) * tc::kWld + c) =
          make_float2(fmaf(x[n][2 * h], gamma[c], beta[c]),
                      fmaf(x[n][2 * h + 1], gamma[c + 1], beta[c + 1]));
    }
}

// the packed fragment (tc_bf16.cuh) of x * gamma + beta, or of SiLU(x)
__device__ __forceinline__ void pack_affine(uint32_t (&a)[4][4], const float (&x)[8][4],
                                            const float* gamma, const float* beta) {
  const tc::Lane l;
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int n = 2 * j + q, c = 8 * n + 2 * l.t;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[j][2 * q + h] = tcb::pack(fmaf(x[n][2 * h], gamma[c], beta[c]),
                                    fmaf(x[n][2 * h + 1], gamma[c + 1], beta[c + 1]));
    }
}

__device__ __forceinline__ void pack_silu(uint32_t (&a)[4][4], const float (&x)[8][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[j][2 * q + h] = tcb::pack(silu(x[2 * j + q][2 * h]), silu(x[2 * j + q][2 * h + 1]));
}

// The dEW1 share of a tile on the SIMT units: thread tg of the group owns
// column c = tg % D of We1's output and the features f = tg / D + 2 u, u <
// 4; g(e, c) is d_p1 in a float32 tile (row stride kWld) or, with BF, in a
// row-major bf16 tile; sF the tile's features as (64, F)
template <bool BF>
__device__ __forceinline__ void dew1_acc(float (&acc)[4], const void* g, const float* sF,
                                         int F, int tg) {
  const int c = tg & (D - 1), f0 = tg / D;
  for (int e = 0; e < kTileRows; ++e) {
    const float v = BF ? __bfloat162float(static_cast<const tcb::bf16*>(g)[e * D + c])
                       : static_cast<const float*>(g)[e * tc::kWld + c];
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (f0 + 2 * u < F) acc[u] = fmaf(sF[e * F + f0 + 2 * u], v, acc[u]);
  }
}

template <bool RAW, bool BF = false, typename TI = float>
__global__ void __launch_bounds__(kEdgeThreads, 1)
fused_edge_bwd_edge(const EdgeParamsT<TI> p) {
  static_assert(BF || std::is_same<TI, float>::value, "float32 products take float32 streams");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr EdgePlan L = edge_plan(RAW, BF);
  const float* sEV = sm + L.vec;  // eb1 eb2 eg ebt
  const float* sEW1 = sm + L.ew1;
  const int F = p.feat, B = p.batch;

  if constexpr (BF) {
    tcb::load_weight<false>(reinterpret_cast<tcb::bf16*>(sm + L.w1e), p.w1, 3 * D, 0,
                            kEdgeThreads);
    if (RAW)
      tcb::load_weight<false>(reinterpret_cast<tcb::bf16*>(sm + L.ew2), p.ew2, D, 0,
                              kEdgeThreads);
  } else {
    tc::load_weight_wg<true>(sm + L.w1e, p.w1, 3 * D, 0, kEdgeThreads);  // W1e^T
    if (RAW) {
      tc::load_weight_wg<false>(sm + L.ew2, p.ew2, D, 0, kEdgeThreads);
      tc::load_weight_wg<true>(sm + L.ew2t, p.ew2, D, 0, kEdgeThreads);
    }
  }
  if (RAW) {
    if (threadIdx.x < D) {
      const int c = threadIdx.x;
      float* v = sm + L.vec;
      v[c] = p.eb1[c];
      v[D + c] = p.eb2[c];
      v[2 * D + c] = p.eg[c];
      v[3 * D + c] = p.ebt[c];
    }
    for (int i = threadIdx.x; i < F * D; i += kEdgeThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      const float w = __ldg(p.ew1 + c * F + k);
      sm[L.ew1 + i] = BF ? tc::bf16r(w) : w;
    }
  }

  const int group = threadIdx.x / kEdgeGroupThreads;
  const int tg = threadIdx.x - group * kEdgeGroupThreads;
  const int warp = tg >> 5;
  const int bar = 1 + group;  // named barrier of the group (0 is __syncthreads)
  const int r_base = 16 * warp;
  float* gs = sm + L.groups + group * L.group_floats;
  float* sT1 = gs + L.t1;
  float* sT2 = gs + L.t2;
  float* sT3 = gs + L.t3;
  float* sF = gs + L.feats;
  float* sSlots = gs + L.slots;
  float* slot = sSlots + warp * 4 * D;  // this warp's deb1 | deb2 | deg | debt
  if (RAW)
    for (int i = tg; i < 4 * 4 * D; i += kEdgeGroupThreads) sSlots[i] = 0.0f;
  tcb::fence_async();
  __syncthreads();

  float dW1e[8][4], dEW2[8][4];
  tc::zero(dW1e);
  tc::zero(dEW2);
  float dEW1[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const int gi = blockIdx.x * kEdgeGroups + group;
  const int n_tiles = (p.n_edges + kTileRows - 1) / kTileRows;

  for (int tile = gi; tile < n_tiles; tile += gridDim.x * kEdgeGroups) {
    const int t0 = tile * kTileRows;
    const int ne = min(kTileRows, p.n_edges - t0);
    tc::group_sync(bar, kEdgeGroupThreads);  // the last tile is done with the tiles
    if (RAW)
      for (int i = tg; i < kTileRows * F; i += kEdgeGroupThreads) {
        const float f = i < ne * F ? tc::ldg_val(p.edge + static_cast<long long>(t0) * F + i)
                                   : 0.0f;
        sF[i] = BF ? tc::bf16r(f) : f;
      }
    float x[8][4], y[8][4], rstd[2];
    tc::load_rows<true>(x, p.presum + static_cast<long long>(t0) * D, D, r_base, ne);  // s

    if constexpr (!BF) {
      // ---- float32: d_edge_val = s . W1e, s into T1 ----------------------
      tc::store_rows(sT1, tc::kWld, x, r_base, kTileRows);
      tc::zero(y);
      tc::gemm_wg<4>(y, x, sm + L.w1e);
      if (p.d_new_edge != nullptr) add_batch_sum(y, p.d_new_edge, B, t0, r_base, ne);
      if (!RAW) {
        tc::store_rows(p.d_edge + static_cast<long long>(t0) * D, D, y, r_base, ne);
        tc::load_rows<true>(x, p.edge + static_cast<long long>(t0) * D, D, r_base, ne);
        tc::store_rows(sT2, tc::kWld, x, r_base, kTileRows);
        tc::group_sync(bar, kEdgeGroupThreads);  // T1 = s, T2 = edge
        tc::gemm_tn(dW1e, sT1, r_base, sT2);
        continue;
      }
      tc::store_rows(sT2, tc::kWld, y, r_base, kTileRows);  // d_edge_val waits in T2
      // ---- the embedder again: edge_val = LN(SiLU(f . We1 + eb1) . We2^T + eb2)
      embed_hidden<false>(x, p.edge, F, t0, sEW1, sEV, r_base, ne);
      tc::zero(y);
      tc::gemm_wg<4>(y, x, sm + L.ew2);
      tc::add_cols(y, sEV + D);
      tc::layer_norm(y, nullptr, nullptr, kLnEps, rstd);       // x_hat
      tc::load_rows<false>(x, sT2, tc::kWld, r_base, kTileRows);  // the warp's d_edge_val
      store_rows_affine(sT2, y, sEV + 2 * D, sEV + 3 * D, r_base);  // edge_val
      // ---- through the LayerNorm ----------------------------------------
      tc::add_col_sums(slot + 2 * D, x, y);  // deg
      tc::add_col_sums(slot + 3 * D, x);     // debt
      tc::layer_norm_bwd(x, y, rstd, sEV + 2 * D);
      tc::add_col_sums(slot + D, x);  // deb2
      tc::group_sync(bar, kEdgeGroupThreads);  // T1 = s, T2 = edge_val
      tc::gemm_tn(dW1e, sT1, r_base, sT2);
      tc::group_sync(bar, kEdgeGroupThreads);  // done with s and edge_val
      // ---- the second layer: dEW2 += dx^T . a1, d_a1 = dx . We2 -----------
      tc::store_rows(sT1, tc::kWld, x, r_base, kTileRows);  // dx
      embed_hidden<false>(y, p.edge, F, t0, sEW1, sEV, r_base, ne);
      tc::store_rows(sT2, tc::kWld, y, r_base, kTileRows);  // a1
      tc::group_sync(bar, kEdgeGroupThreads);  // T1 = dx, T2 = a1
      tc::gemm_tn(dEW2, sT1, r_base, sT2);
      tc::zero(y);
      tc::gemm_wg<4>(y, x, sm + L.ew2t);
      // ---- d_p1 = d_a1 * SiLU'(p1), the first layer ----------------------
      embed_hidden<false, TI, false>(x, p.edge, F, t0, sEW1, sEV, r_base, ne);  // p1
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) y[n][j] *= silu_grad(x[n][j]);
      tc::add_col_sums(slot, y);  // deb1
      tc::group_sync(bar, kEdgeGroupThreads);  // done with dx and a1
      tc::store_rows(sT1, tc::kWld, y, r_base, kTileRows);
      tc::group_sync(bar, kEdgeGroupThreads);  // T1 = d_p1
      dew1_acc<false>(dEW1, sT1, sF, F, tg);
    } else {
      // ---- bf16 fragments: s as hi + lo into two tiles, d_edge_val --------
      using tcb::bf16;
      bf16* sShi = reinterpret_cast<bf16*>(sT1);
      bf16* sSlo = reinterpret_cast<bf16*>(sT2);
      bf16* sEv = reinterpret_cast<bf16*>(sT3);
      const bf16* sW1e = reinterpret_cast<const bf16*>(sm + L.w1e);
      const bf16* sEW2 = reinterpret_cast<const bf16*>(sm + L.ew2);
      uint32_t a[4][4], c[4][4];
      tcb::pack_split(a, c, x);
      tcb::store_tile(sShi, a, r_base);
      tcb::store_tile(sSlo, c, r_base);
      tc::zero(y);
      tcb::gemm_wg2<1>(y, a, c, sW1e);  // d_edge_val = s . W1e
      if (p.d_new_edge != nullptr) add_batch_sum(y, p.d_new_edge, B, t0, r_base, ne);
      if (!RAW) {
        tc::store_rows(p.d_edge + static_cast<long long>(t0) * D, D, y, r_base, ne);
        std::conditional_t<sizeof(TI) == 2, uint4[4], float4[8]> rows;
        tcb::load_staged(rows, p.edge + static_cast<long long>(t0) * D, r_base, ne);
        tcb::store_staged(sEv, rows, r_base);
        tcb::fence_async();
        tc::group_sync(bar, kEdgeGroupThreads);  // the s tiles and edge
        tcb::gemm_tn_issue2(dW1e, sShi, sSlo, sEv);
        tcb::wg_wait(dW1e);
        continue;
      }
      // ---- the embedder again: p1 waits in T4 for SiLU' -------------------
      float* sT4 = gs + L.t4;
      embed_hidden<true, TI, false>(x, p.edge, F, t0, sEW1, sEV, r_base, ne);  // p1
      tc::store_rows(sT4, tc::kWld, x, r_base, kTileRows);
      pack_silu(a, x);  // a1
      tc::zero(x);
      tcb::gemm_wg<0>(x, a, sEW2);
      tc::add_cols(x, sEV + D);
      tc::layer_norm(x, nullptr, nullptr, kLnEps, rstd);  // x_hat
      pack_affine(a, x, sEV + 2 * D, sEV + 3 * D);        // edge_val
      tcb::store_tile(sEv, a, r_base);
      // ---- through the LayerNorm ----------------------------------------
      tc::add_col_sums(slot + 2 * D, y, x);  // deg
      tc::add_col_sums(slot + 3 * D, y);     // debt
      tc::layer_norm_bwd(y, x, rstd, sEV + 2 * D);
      tc::add_col_sums(slot + D, y);  // deb2
      tcb::pack_frag(a, y);           // dx
      tcb::fence_async();
      tc::group_sync(bar, kEdgeGroupThreads);  // the s tiles and edge_val
      tcb::gemm_tn_issue2(dW1e, sShi, sSlo, sEv);
      tc::zero(x);
      tcb::gemm_wg<1>(x, a, sEW2);  // d_a1 = dx . We2 (its wait covers dW1e's products)
      tcb::wg_wait(dW1e);
      tc::group_sync(bar, kEdgeGroupThreads);  // done with the s tiles and edge_val
      // ---- dEW2 += dx^T . a1 under d_p1 = d_a1 * SiLU'(p1) -----------------
      tcb::store_tile(sShi, a, r_base);  // dx
      tc::load_rows<false>(y, sT4, tc::kWld, r_base, kTileRows);  // the warp's p1
      pack_silu(c, y);
      tcb::store_tile(sEv, c, r_base);  // a1
      tcb::fence_async();
      tc::group_sync(bar, kEdgeGroupThreads);  // dx and a1
      tcb::gemm_tn_issue(dEW2, sShi, sEv);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[n][j] *= silu_grad(y[n][j]);
      tc::add_col_sums(slot, x);  // deb1
      tc::store_rows(sSlo, D, x, r_base, kTileRows);  // d_p1, row-major bf16
      tcb::wg_wait(dEW2);
      tc::group_sync(bar, kEdgeGroupThreads);  // d_p1
      dew1_acc<true>(dEW1, sSlo, sF, F, tg);
    }
  }

  // ---- the group's partials, once ------------------------------------------
  float* ws = p.ws + static_cast<long long>(gi) * kEdgeStride;
  tc::store_rows(ws, D, dW1e, r_base, D);
  if (!RAW) return;
  tc::store_rows(ws + kMat, D, dEW2, r_base, D);
  {
    const int c = tg & (D - 1), f0 = tg / D;
#pragma unroll
    for (int u = 0; u < 4; ++u) ws[2 * kMat + c * kMaxFeat + f0 + 2 * u] = dEW1[u];
  }
  tc::group_sync(bar, kEdgeGroupThreads);  // every warp's slots are final
  for (int i = tg; i < 4 * D; i += kEdgeGroupThreads) {
    float s = 0.0f;
    for (int w = 0; w < 4; ++w) s += sSlots[w * 4 * D + i];
    ws[2 * kMat + kMaxFeat * D + i] = s;
  }
}

// ---- the workspace reduce -------------------------------------------------
//
// out[i] = the sum of ws[part][i] over the parts in part order, from zero,
// for up to kReduceJobs workspaces in one launch: the plain loop's sum, bit
// for bit. The parallelism is the outputs' (21,504 for a K4 call) and each
// output's sum is a chain over its parts, so the rate at which the
// workspaces are read is set by the loads in flight: a block of
// kReduceThreads threads (one output each, a job's outputs per block) copies
// the next kReduceBatch parts of its outputs into shared memory with
// cp.async while it sums the last batch, so a batch's loads are in flight
// at once without a register each (plain loads, even issued ahead, were
// serialized behind the sums).
constexpr int kReduceJobs = 3;
constexpr int kReduceThreads = 64;
constexpr int kReduceBatch = 64;

struct ReduceJob {
  const float* ws;  // (parts, stride)
  float* out;       // (count,): the first count floats of each part, summed
  int parts;
  int stride;
  int count;
};

struct ReduceJobs {
  ReduceJob job[kReduceJobs];
  int n;
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__global__ void __launch_bounds__(kReduceThreads)
reduce_workspace(const ReduceJobs jobs) {
  __shared__ float buf[2][kReduceBatch][kReduceThreads];
  // the job of this block, and its first output
  int block = blockIdx.x, k = 0;
#pragma unroll
  for (int j = 0; j < kReduceJobs; ++j) {
    const int blocks = (jobs.job[j].count + kReduceThreads - 1) / kReduceThreads;
    if (j == k && j < jobs.n - 1 && block >= blocks) {
      block -= blocks;
      ++k;
    }
  }
  const ReduceJob job = jobs.job[k];
  const int i = block * kReduceThreads + threadIdx.x;
  if (i >= job.count) return;
  const float* src = job.ws + i;
  const int t = threadIdx.x;

  auto copy = [&](int b0, int stage) {  // parts b0 .. b0 + kReduceBatch - 1
    for (int u = 0; u < kReduceBatch && b0 + u < job.parts; ++u)
      cp_async4(&buf[stage][u][t], src + static_cast<long long>(b0 + u) * job.stride);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  float s = 0.0f;
  copy(0, 0);
  for (int b0 = 0, stage = 0; b0 < job.parts; b0 += kReduceBatch, stage ^= 1) {
    if (b0 + kReduceBatch < job.parts) {
      copy(b0 + kReduceBatch, stage ^ 1);
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");  // this batch has landed
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    }
    const int n = min(kReduceBatch, job.parts - b0);
    for (int u = 0; u < n; ++u) s += buf[stage][u][t];
  }
  job.out[i] = s;
}

inline cudaError_t launch_reduces(const ReduceJobs& jobs, cudaStream_t stream) {
  int blocks = 0;
  for (int k = 0; k < jobs.n; ++k)
    blocks += (jobs.job[k].count + kReduceThreads - 1) / kReduceThreads;
  reduce_workspace<<<blocks, kReduceThreads, 0, stream>>>(jobs);
  return cudaGetLastError();
}

inline cudaError_t launch_reduce(const float* ws, int parts, int stride, float* out,
                                 cudaStream_t stream) {
  ReduceJobs jobs{};
  jobs.job[0] = ReduceJob{ws, out, parts, stride, stride};
  jobs.n = 1;
  return launch_reduces(jobs, stream);
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The edge pass for EDGE_RAW or EDGE_SHARED on at most max_blocks blocks of
// kEdgeGroups groups; job = its workspace (gridDim.x * kEdgeGroups,
// kEdgeStride) for reduce_workspace into out (kEdgeStride,) = dW1e, dEW2 as
// (out, in) | dEW1 as (D, 8) | deb1 deb2 deg debt. Static: the flag below
// must belong to this library's own kernel (the function-local static of
// an inline function is one object across every library loaded into the
// process).
template <bool BF = false, typename TI = float>
static inline cudaError_t launch_edge_pass(int edge_mode, const EdgeParamsT<TI>& e,
                                           int max_blocks, float* out, ReduceJob* job,
                                           cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attributes are set
  const int n_tiles = (e.n_edges + kTileRows - 1) / kTileRows;
  const int need = (n_tiles + kEdgeGroups - 1) / kEdgeGroups;
  const int blocks = need < max_blocks ? need : max_blocks;
  const bool raw = edge_mode == EDGE_RAW;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = allow_smem(fused_edge_bwd_edge<true, BF, TI>, edge_smem_bytes(true, BF));
    if (err == cudaSuccess)
      err = allow_smem(fused_edge_bwd_edge<false, BF, TI>, edge_smem_bytes(false, BF));
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  if (raw)
    fused_edge_bwd_edge<true, BF, TI>
        <<<blocks, kEdgeThreads, edge_smem_bytes(true, BF), stream>>>(e);
  else
    fused_edge_bwd_edge<false, BF, TI>
        <<<blocks, kEdgeThreads, edge_smem_bytes(false, BF), stream>>>(e);
  *job = ReduceJob{e.ws, out, blocks * kEdgeGroups, kEdgeStride, raw ? kEdgeStride : kMat};
  return cudaGetLastError();
}

// the edge pass's launch resources (out as main_occupancy_of's)
template <bool RAW, bool BF, typename TI>
cudaError_t edge_occupancy_of(int* out) {
  out[1] = kEdgeThreads;
  out[3] = edge_smem_bytes(RAW, BF);
  return tcb::occupancy(fused_edge_bwd_edge<RAW, BF, TI>, out[1], out[3], out, out + 2,
                        out + 4);
}

// ---- the rows pass and the receiver slice ----------------------------------
//
// The batched edge input's share, over 64-row tiles of (edge, b) rows:
// d_edge = d_pre . W1e (+ d_new_edge) and dW1e += d_pre^T . edge, on the
// tensor cores (the main kernels' d_pre rows); and K4's receiver slice on
// the same pattern over (receiver, b) rows: d_rec = d_recproj . W1r and
// dW1r += d_recproj^T . rec, 3xTF32 whatever the precision (the JAX
// package forms these einsums in float32, pallas_fused.py:1626-1631),
// reading rec in its own dtype and writing d_rec in float32. A block of 16
// warps holds the W1 slice's transpose once and runs four groups of 4
// warps; group i takes the tiles i, i + groups, ... (a fixed assignment:
// deterministic partial sums) and keeps a 16 x 64 share of the weight
// gradient per warp in registers.
constexpr int kRowGroupThreads = 128;  // a group is one warpgroup
constexpr int kRowGroups = 4;
constexpr int kRowThreads = kRowGroups * kRowGroupThreads;

struct RowsPlan {
  int w1t, groups, group_floats, total;
};

__host__ __device__ constexpr RowsPlan rows_plan() {
  RowsPlan s{};
  s.w1t = 0;
  s.groups = 2 * tc::kWgHalf;  // the slice's transpose, split for wgmma
  s.group_floats = 2 * kTileRows * tc::kWld;  // x rows, g rows
  s.total = s.groups + kRowGroups * s.group_floats;
  return s;
}

constexpr int rows_smem_bytes() { return rows_plan().total * static_cast<int>(sizeof(float)); }

template <typename TI, typename TO = TI>
struct RowsParamsT {
  const TI* x;        // (rows, D): the edge rows, or the receiver rows
  const float* g;     // (rows, D): d_pre, or d_recproj
  const TI* add;      // (rows, D) or null: d_new_edge
  const float* w1;
  int w_off;          // the slice's first column of W1: 0 (W1e) or 2 D (W1r)
  TO* out;            // (rows, D): d_edge, or d_rec
  float* ws;          // (gridDim.x * kRowGroups, kMat)
  int rows;
};

template <bool BF, typename TI, typename TO>
__device__ __forceinline__ void rows_pass(const RowsParamsT<TI, TO>& p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr RowsPlan L = rows_plan();
  tc::load_weight_wg<true, false, false, BF>(sm + L.w1t, p.w1, 3 * D, p.w_off,
                                             kRowThreads);  // the slice's transpose
  __syncthreads();
  const int group = threadIdx.x / kRowGroupThreads;
  const int tg = threadIdx.x - group * kRowGroupThreads;
  const int warp = tg >> 5;
  const int bar = 1 + group;
  float* sE = sm + L.groups + group * L.group_floats;
  float* sG = sE + kTileRows * tc::kWld;
  const int r_base = 16 * warp;
  const int gi = blockIdx.x * kRowGroups + group;
  const int n_tiles = (p.rows + kTileRows - 1) / kTileRows;

  float dW[8][4];
  tc::zero(dW);
  for (int tile = gi; tile < n_tiles; tile += gridDim.x * kRowGroups) {
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    const int nrows = min(kTileRows, static_cast<int>(p.rows - row0));
    float g[8][4], x[8][4];
    tc::load_rows<true>(g, p.g + row0 * D, D, r_base, nrows);
    tc::load_rows<true>(x, p.x + row0 * D, D, r_base, nrows);
    tc::store_rows(sG, tc::kWld, g, r_base, kTileRows);
    tc::store_rows(sE, tc::kWld, x, r_base, kTileRows);
    tc::group_sync(bar, kRowGroupThreads);  // the tile's rows are staged
    tc::gemm_tn<BF>(dW, sG, r_base, sE);
    tc::group_sync(bar, kRowGroupThreads);  // done with them
    tc::load_rows<false>(g, sG, tc::kWld, r_base, kTileRows);  // the warp's own g rows
    if (p.add != nullptr)
      tc::load_rows<true>(x, p.add + row0 * D, D, r_base, nrows);
    else
      tc::zero(x);
    tc::gemm_wg<4, BF>(x, g, sm + L.w1t);  // d_edge, or d_rec
    tc::store_rows(sE, tc::kWld, x, r_base, kTileRows);
    tc::copy_out_rows(p.out + row0 * D, sE, r_base, nrows);
  }
  tc::store_rows(p.ws + static_cast<long long>(gi) * kMat, D, dW, r_base, D);
}

template <bool BF = false, typename TI = float>
__global__ void __launch_bounds__(kRowThreads, 1)
fused_edge_bwd_rows(const RowsParamsT<TI> p) {
  rows_pass<BF>(p);
}

template <typename TI>
__global__ void __launch_bounds__(kRowThreads, 1)
fused_edge_bwd_receiver(const RowsParamsT<TI, float> p) {
  rows_pass<false>(p);
}

// The rows pass (or, with RECEIVER, the receiver slice) on `blocks`
// blocks; job = its workspace (blocks * kRowGroups, kMat) for
// reduce_workspace into out (kMat,) = dW1e or dW1r as (out, in). Static
// as launch_edge_pass.
template <bool RECEIVER, bool BF, typename TI, typename TO>
static inline cudaError_t launch_rows(const RowsParamsT<TI, TO>& r, int blocks, float* out,
                                      ReduceJob* job, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    if constexpr (RECEIVER)
      err = allow_smem(fused_edge_bwd_receiver<TI>, rows_smem_bytes());
    else
      err = allow_smem(fused_edge_bwd_rows<BF, TI>, rows_smem_bytes());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  if constexpr (RECEIVER)
    fused_edge_bwd_receiver<TI><<<blocks, kRowThreads, rows_smem_bytes(), stream>>>(r);
  else
    fused_edge_bwd_rows<BF, TI><<<blocks, kRowThreads, rows_smem_bytes(), stream>>>(r);
  *job = ReduceJob{r.ws, out, blocks * kRowGroups, kMat, kMat};
  return cudaGetLastError();
}

}  // namespace fused_edge
