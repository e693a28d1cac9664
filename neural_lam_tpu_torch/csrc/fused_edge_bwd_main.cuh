// K4's main kernel and its launch sequence (fused_edge_bwd.cu describes the
// design), shared by the two libraries that instantiate it:
// fused_edge_bwd.cu starts from the pre-activation pre[e, b] that K3 saved
// (float32, or bf16 under NEURAL_LAM_TPU_CACHE_PRE=bf16), and
// fused_edge_bwd_recompute.cu recomputes it in the tile loop
// (NEURAL_LAM_TPU_CACHE_PRE=off). Two libraries, so that nvcc builds the
// two sets of instantiations at once.
//
// Recomputing pre (PRE == kPreRecompute). The JAX kernel does the same when
// no pre was saved (pallas_fused.py:1087, :1153, :1203, and saved_pre=False
// in _fused_bwd_kernel, :420, :441). At the top of each tile the group forms
//
//   pre = edge_val . W1e + send . W1s + (rec[r] . W1r) + b1
//
// with K3's arithmetic in K3's order (fused_edge.cu), so that each entry
// is K3's up to the tensor core's summation inside a product: the embedder
// (its We1 layer on the SIMT units, We2 and the LayerNorm) and edge_val .
// W1e once per edge for the per-edge inputs (warp w takes the tile's edges
// 16 w .. 16 w + 15), rec . W1r once per (receiver, b) of a chunk, and the
// row products send . W1s (and edge . W1e, batched) per row; 3xTF32 (the
// bf16-operand kernel, fused_edge_bwd_main_bf below, runs K3's BF products:
// mma.sync m16n8k16 in K3's k order). Shared memory is full with the saved-pre
// kernel's weights and tiles (218 of 227 KB; the recompute adds b1, the
// embedder's vectors and its We1, 221 KB), so these products read their
// weights from device memory through L1 (mma.sync, tc::gemm<true>) where K3
// keeps them in shared memory for wgmma: the same operands and the same
// order of the three TF32 passes through a different tensor-core
// instruction, which gave K3's bits on an H100 (every gradient entry at the
// six MEPS sites equal to those from K3's saved pre, chip_smoke.py's cache
// pre lines). The chunk's receiver products
// and each tile's pre go to a small per-group workspace in device memory
// (64 + 32 rows), which the group reads back after a barrier (the receiver
// rows) or each lane reads its own entries from (pre); nothing of the size
// of the edge set is written. Cost: three more 64x64 products per row than
// the saved-pre kernel (the embedder's per edge), and no pre stream to read.

#pragma once

#include <type_traits>

#include "fused_edge_bwd_common.cuh"
#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

namespace {

using fused_edge::D;
using fused_edge::EDGE_BATCHED;
using fused_edge::EDGE_RAW;
using fused_edge::EDGE_SHARED;
using fused_edge::kLnEps;
using fused_edge::kMat;
using fused_edge::kMaxFeat;
using fused_edge::kRecRows;
using fused_edge::kTileRows;
using fused_edge::silu;
using fused_edge::silu_grad;
using tc::kWld;

constexpr int kGroupWarps = 4;
constexpr int kGroups = 3;  // per block; the wrapper sizes the workspace by it
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kBlockThreads = kGroups * kGroupThreads;
constexpr int kAgg = kRecRows * D / kGroupThreads;  // d_recproj entries per thread
constexpr int kWgMat = 2 * tc::kWgHalf;  // a weight for wgmma: its hi and lo halves

// floats per group in the main kernel's workspace (the wrapper sizes it the
// same); the edge kernel's is kEdgeStride (fused_edge_bwd_common.cuh)
constexpr int kMainStride = 2 * kMat + 4 * D;  // dW2 dW1s as (out, in) | db2 dgamma dbeta db1
// floats per group of the recompute's workspace: a tile's pre | a chunk's
// rec . W1r (the wrapper sizes it the same)
constexpr int kPreStride = kTileRows * D + kRecRows * D;

// where pre comes from: saved in float32, saved in bf16, or recomputed
enum PreMode { kPreF32 = 0, kPreBf16 = 1, kPreRecompute = 2 };


template <typename TI>
struct MainParams {
  const TI* send;        // (E, B, D)
  const void* pre;       // (E, B, D) float32 or bf16; null when recomputed
  const TI* d_aggr;      // (num_rec, B, D)
  const TI* d_new_edge;  // (E, B, D) or null
  const int* rowptr;
  const float* w1;
  const float* w2;
  const float* b2;
  const float* gamma;
  TI* d_send;        // (E, B, D)
  float* d_pre;      // (E, B, D) d_pre [EDGE_BATCHED], else (E, D) s; K8: d_pre always
  float* presum;     // K8's (E, D) s, the per-edge modes only
  float* d_recproj;  // (num_rec, B, D)
  float* ws;         // (gridDim.x * kGroups, kMainStride)
  // the recompute's inputs: K3's edge input and receiver rows, b1 and the
  // embedder, and the (gridDim.x * kGroups, kPreStride) workspace
  const TI* edge;
  const TI* rec;
  const float* b1;
  const float* ew1;
  const float* eb1;
  const float* ew2;
  const float* eb2;
  const float* eg;
  const float* ebt;
  float* pre_ws;
  int feat;
  int num_rec;
  int num_chunks;
  int batch;
  int recv_per_chunk;
  int edges_per_tile;
  int propagation;
  int layer_norm;
};

// Shared-memory plan, in floats: the block's weights (split for wgmma) and
// vectors (and, to recompute pre, b1, the embedder's vectors and its We1),
// then per group two 64-row tiles, the warps' column-sum slots and the
// integers.
struct MainSmem {
  int w2, w2t, w1st, vec, ew1, groups, group_floats, total;
  int t1, t2, slots, ints;  // offsets inside a group
};

__host__ __device__ constexpr MainSmem main_plan(bool recompute) {
  MainSmem s{};
  int o = 0;
  s.w2 = o; o += kWgMat;    // W2 as it is: z = h1 . W2^T
  s.w2t = o; o += kWgMat;   // W2^T: d_h1 = dz . W2
  s.w1st = o; o += kWgMat;  // W1s^T: d_send = d_pre . W1s
  s.vec = o; o += (recompute ? 8 : 2) * D;  // b2 gamma | b1 - | eb1 eb2 eg ebt
  s.ew1 = o; o += recompute ? kMaxFeat * D : 0;
  s.groups = o;
  int g = 0;
  s.t1 = g; g += kTileRows * kWld;
  s.t2 = g; g += kTileRows * kWld;
  s.slots = g; g += kGroupWarps * 4 * D;  // per warp: db2 dgamma dbeta db1
  s.ints = g; g += 100;                   // rowptr (<= 33), receiver of each tile edge (64)
  s.group_floats = g;
  s.total = o + kGroups * g;
  return s;
}

constexpr int main_smem_bytes(bool recompute) {
  return main_plan(recompute).total * static_cast<int>(sizeof(float));
}

// The bf16-operand kernel's plan, in floats: W2 and W1s, one bf16 copy each
// in the core layout (tc_bf16.cuh), read by wgmma in both orientations (no
// transposed copies), the vectors (and the recompute's), then per group two
// bf16 operand tiles in the core layout (h1 and dz, then send and d_pre:
// the weight gradients' operands), a float32 tile (SiLU'(pre) of a saved
// pre, then d_pre for the receiver sums, s and the d_pre stream; the
// recompute's per-edge products; d_send on its way out), the chunk's
// d_recproj sums, the group's float32 dW1s, the warps' column-sum slots and
// the integers. K8's (v2: no sender half) has no W1s and no dW1s, and
// `groups` groups.
struct MainSmemBf {
  int w2, w1s, vec, ew1, groups, group_floats, total;
  int t1, t2, tp, rp, dw, slots, ints;  // offsets inside a group
};

__host__ __device__ constexpr MainSmemBf main_plan_bf(bool recompute, bool v2 = false,
                                                      int groups = kGroups) {
  MainSmemBf s{};
  int o = 0;
  s.w2 = o; o += tcb::kMatFloats;   // z = h1 . W2^T; d_h1 = dz . W2 (transpose bit)
  s.w1s = o; o += v2 ? 0 : tcb::kMatFloats;  // d_send = d_pre . W1s (transpose bit)
  s.vec = o; o += (recompute ? 8 : 2) * D;  // b2 gamma | b1 - | eb1 eb2 eg ebt
  s.ew1 = o; o += recompute ? kMaxFeat * D : 0;
  s.groups = o;
  int g = 0;
  s.t1 = g; g += tcb::kMatFloats;
  s.t2 = g; g += tcb::kMatFloats;
  s.tp = g; g += kTileRows * kWld;
  s.rp = g; g += kRecRows * D;
  s.dw = g; g += v2 ? 0 : D * kWld;  // dW1s as (out, in), row stride kWld
  s.slots = g; g += kGroupWarps * 4 * D;  // per warp: db2 dgamma dbeta db1
  s.ints = g; g += 100;                   // rowptr (<= 33), receiver of each tile edge (64)
  s.group_floats = g;
  s.total = o + groups * g;
  return s;
}

constexpr int main_smem_bytes_bf(bool recompute, bool v2 = false, int groups = kGroups) {
  return main_plan_bf(recompute, v2, groups).total * static_cast<int>(sizeof(float));
}

// d_msg = d_aggr[r, b] (+ d_new_edge[e, b]) of the warp's rows of a tile
// (zero past its nrows rows), in the row-fragment layout
template <typename TI>
__device__ __forceinline__ void load_d_msg(float (&x)[8][4], const MainParams<TI>& p,
                                           const int* sRloc, int r0, long long row0,
                                           int r_base, int nrows) {
  const int B = p.batch;
  const tc::Lane l;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = r_base + l.g + 8 * h;
    const bool live = m < nrows;
    const int el = m / B, b = m - el * B;
    const TI* da =
        p.d_aggr + ((static_cast<long long>(r0) + (live ? sRloc[el] : 0)) * B + b) * D +
        2 * l.t;
    const TI* dn = p.d_new_edge + (row0 + m) * D + 2 * l.t;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      float2 v = make_float2(0.0f, 0.0f);
      if (live) {
        v = tc::ldg_pair(da + 8 * n);
        if (p.d_new_edge != nullptr) {
          const float2 w = tc::ldg_pair(dn + 8 * n);
          v.x += w.x;
          v.y += w.y;
        }
      }
      x[n][2 * h] = v.x;
      x[n][2 * h + 1] = v.y;
    }
  }
}

// the warp's pre rows of a tile: saved (float32 or bf16, zero past nrows),
// or from the group's recompute workspace (every lane reads what it wrote)
template <int PRE, typename TI>
__device__ __forceinline__ void load_pre(float (&x)[8][4], const MainParams<TI>& p,
                                         const float* pre_tile, long long row0, int r_base,
                                         int nrows) {
  if (PRE == kPreRecompute)
    tc::load_rows<false>(x, pre_tile, D, r_base, kTileRows);
  else if (PRE == kPreBf16)
    tc::load_rows<true>(x, static_cast<const __nv_bfloat16*>(p.pre) + row0 * D, D, r_base,
                        nrows);
  else
    tc::load_rows<true>(x, static_cast<const float*>(p.pre) + row0 * D, D, r_base, nrows);
}

// MODE: the edge input (the saved-pre instantiations take EDGE_SHARED for
// both per-edge modes); PRE: where pre comes from; TI: the stream type
// (float; bf16 operands run fused_edge_bwd_main_bf below)
template <int MODE, int PRE, typename TI>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_edge_bwd_main(const MainParams<TI> p) {
  constexpr bool BATCHED = MODE == EDGE_BATCHED;
  constexpr bool RECOMPUTE = PRE == kPreRecompute;
  constexpr bool BF_STREAMS = sizeof(TI) == 2;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr MainSmem L = main_plan(RECOMPUTE);
  const float* sW2 = sm + L.w2;
  const float* sW2t = sm + L.w2t;
  const float* sW1st = sm + L.w1st;
  const float* sB2 = sm + L.vec;
  const float* sGam = sB2 + D;
  const float* sB1 = sB2 + 2 * D;      // RECOMPUTE
  const float* sEV = sB2 + 4 * D;      // RECOMPUTE: eb1 eb2 eg ebt
  const float* sEW1 = sm + L.ew1;      // RECOMPUTE, EDGE_RAW: We1 as (F, D)

  tc::load_weight_wg<false>(sm + L.w2, p.w2, D, 0, kBlockThreads);
  tc::load_weight_wg<true>(sm + L.w2t, p.w2, D, 0, kBlockThreads);
  tc::load_weight_wg<true>(sm + L.w1st, p.w1, 3 * D, D, kBlockThreads);
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L.vec;
    v[c] = p.b2[c];
    v[D + c] = p.layer_norm ? p.gamma[c] : 1.0f;
    if (RECOMPUTE) v[2 * D + c] = p.b1[c];
    if (RECOMPUTE && MODE == EDGE_RAW) {
      v[4 * D + c] = p.eb1[c];
      v[5 * D + c] = p.eb2[c];
      v[6 * D + c] = p.eg[c];
      v[7 * D + c] = p.ebt[c];
    }
  }
  if (RECOMPUTE && MODE == EDGE_RAW) {
    for (int i = threadIdx.x; i < p.feat * D; i += kBlockThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      sm[L.ew1 + i] = __ldg(p.ew1 + c * p.feat + k);  // the SIMT layer's operand
    }
  }

  const int group = threadIdx.x / kGroupThreads;
  const int tg = threadIdx.x - group * kGroupThreads;
  const int warp = tg >> 5;
  const int bar = 1 + group;  // named barrier of the group (0 is __syncthreads)
  float* gs = sm + L.groups + group * L.group_floats;
  float* sT1 = gs + L.t1;
  float* sT2 = gs + L.t2;
  float* sSlots = gs + L.slots;
  int* sRowptr = reinterpret_cast<int*>(gs + L.ints);
  int* sRloc = sRowptr + 36;
  for (int i = tg; i < kGroupWarps * 4 * D; i += kGroupThreads) sSlots[i] = 0.0f;
  __syncthreads();

  float* slot = sSlots + warp * 4 * D;  // this warp's db2 | dgamma | dbeta | db1
  const int B = p.batch, R = p.recv_per_chunk, TE = p.edges_per_tile;
  const int BD = B * D;
  const int r_base = 16 * warp;  // the warp's first row of a tile, and of dW
  const int gi = blockIdx.x * kGroups + group;
  const int inv_b = (65536 + B - 1) / B;  // q / B = (q * inv_b) >> 16 for q < 64
  const int ni_e = (TE + 15) / 16;        // 16-edge groups that hold a tile's edges
  // RECOMPUTE: the group's workspace, a tile's pre then a chunk's rec . W1r
  float* pre_tile = RECOMPUTE ? p.pre_ws + static_cast<long long>(gi) * kPreStride : nullptr;
  float* rp_tile = RECOMPUTE ? pre_tile + kTileRows * D : nullptr;

  float dW2[8][4], dW1s[8][4];
  tc::zero(dW2);
  tc::zero(dW1s);

  for (int chunk = gi; chunk < p.num_chunks; chunk += gridDim.x * kGroups) {
    const int r0 = chunk * R;
    const int nr = min(R, p.num_rec - r0);
    tc::group_sync(bar, kGroupThreads);  // the last chunk is done with gs
    if (tg <= nr) sRowptr[tg] = p.rowptr[r0 + tg];
    // the chunk's d_recproj rows are summed in place, each entry by one
    // thread in edge order (registers would spill)
    float* recproj = p.d_recproj + static_cast<long long>(r0) * BD;
#pragma unroll
    for (int j = 0; j < kAgg; ++j)
      if ((tg >> 6) + 2 * j < nr * B) recproj[tg + j * kGroupThreads] = 0.0f;
    if (RECOMPUTE && warp < 2) {
      // rec . W1r once per (receiver, b) of the chunk: warp w takes rows
      // 16 w .. (K3's product), into the workspace
      float x[8][4], acc[8][4];
      tc::load_rows<true>(x, p.rec + static_cast<long long>(r0) * BD, D, r_base, nr * B);
      tc::zero(acc);
      tc::gemm<true>(acc, x, p.w1 + 2 * D, 3 * D);
      tc::store_rows(rp_tile, D, acc, r_base, kRecRows);
    }
    tc::group_sync(bar, kGroupThreads);

    const int e_begin = sRowptr[0], e_end = sRowptr[nr];
    for (int t0 = e_begin; t0 < e_end; t0 += TE) {
      const int ne = min(TE, e_end - t0);
      const int nrows = ne * B;
      const long long row0 = static_cast<long long>(t0) * B;
      // bf16 residuals read sRloc again at the end of the last tile
      if (BF_STREAMS && p.propagation) tc::group_sync(bar, kGroupThreads);
      if (tg < nr) {
        const int a = max(sRowptr[tg], t0), z = min(sRowptr[tg + 1], t0 + ne);
        for (int e = a; e < z; ++e) sRloc[e - t0] = tg;
      }

      float x[8][4], z[8][4], rstd[2];
      if (RECOMPUTE) {
        // ---- pre again, as K3 forms it -----------------------------------
        if (MODE != EDGE_BATCHED && B > 1 && warp < ni_e) {
          // edge_val . W1e once per edge, shared by the batch, into the
          // warp's own rows of T2 (every warp's last reads of T2 were its
          // own rows)
          fused_edge::edge_value<MODE, true>(x, p.edge, p.feat, t0, sEW1, p.ew2, sEV,
                                             r_base, ne);
          tc::zero(z);
          tc::gemm<true>(z, x, p.w1, 3 * D);
          tc::store_rows(sT2, kWld, z, r_base, 32);
        }
        tc::zero(x);
        if (MODE == EDGE_BATCHED) {
          tc::load_rows<true>(z, p.edge + row0 * D, D, r_base, nrows);
          tc::gemm<true>(x, z, p.w1, 3 * D);
        } else if (B == 1) {
          // edge and row coincide: edge_val . W1e for the warp's own rows
          fused_edge::edge_value<MODE, true>(z, p.edge, p.feat, t0, sEW1, p.ew2, sEV,
                                             r_base, ne);
          tc::gemm<true>(x, z, p.w1, 3 * D);
        }
        tc::load_rows<true>(z, p.send + row0 * D, D, r_base, nrows);
        tc::gemm<true>(x, z, p.w1 + D, 3 * D);
        tc::group_sync(bar, kGroupThreads);  // sRloc and the per-edge products are written
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          const int el = m / B, b = m - el * B;
          const int rl = m < nrows ? sRloc[el] : 0;
          const float* rp = rp_tile + (rl * B + b) * D + 2 * l.t;
          const float* pj = sT2 + el * kWld + 2 * l.t;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 r2 = *reinterpret_cast<const float2*>(rp + 8 * n);
            const float2 b2 = *reinterpret_cast<const float2*>(sB1 + 8 * n + 2 * l.t);
            x[n][2 * h] += b2.x + r2.x;
            x[n][2 * h + 1] += b2.y + r2.y;
            if (MODE != EDGE_BATCHED && B > 1) {
              const float2 q = *reinterpret_cast<const float2*>(pj + 8 * n);
              x[n][2 * h] += q.x;
              x[n][2 * h + 1] += q.y;
            }
            if (m >= nrows) x[n][2 * h] = x[n][2 * h + 1] = 0.0f;  // as a saved tile reads
          }
        }
        tc::store_rows(pre_tile, D, x, r_base, kTileRows);
      } else {
        load_pre<PRE>(x, p, pre_tile, row0, r_base, nrows);
      }

      // ---- the forward again from pre: h1 into T1, z and its x_hat -------
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) x[n][j] = silu(x[n][j]);
      tc::zero(z);
      tc::gemm_wg<4>(z, x, sW2);
      tc::add_cols(z, sB2);
      if (p.layer_norm) tc::layer_norm(z, nullptr, nullptr, kLnEps, rstd);
      tc::store_rows(sT1, kWld, x, r_base, kTileRows);
      tc::group_sync(bar, kGroupThreads);  // sRloc is written

      // ---- d_msg, then dz through the LayerNorm into T2 ------------------
      load_d_msg(x, p, sRloc, r0, row0, r_base, nrows);
      // d_send's residual term, added below: kept in d_send for float32
      // rows, loaded again for bf16 ones (a bf16 d_send would round it)
      if (!BF_STREAMS && p.propagation)
        tc::store_rows(reinterpret_cast<float*>(p.d_send) + row0 * D, D, x, r_base, nrows);
      if (p.layer_norm) {
        tc::add_col_sums(slot + D, x, z);   // dgamma
        tc::add_col_sums(slot + 2 * D, x);  // dbeta
        tc::layer_norm_bwd(x, z, rstd, sGam);
      }
      tc::add_col_sums(slot, x);  // db2
      tc::store_rows(sT2, kWld, x, r_base, kTileRows);
      tc::group_sync(bar, kGroupThreads);  // T1 = h1, T2 = dz
      tc::gemm_tn(dW2, sT2, r_base, sT1);

      // ---- d_h1 = dz . W2, d_pre = d_h1 * SiLU'(pre) ----------------------
      // (dz again from the warp's own rows of T2: registers are scarce
      // across the weight-gradient product)
      tc::load_rows<false>(x, sT2, kWld, r_base, kTileRows);
      tc::zero(z);
      tc::gemm_wg<4>(z, x, sW2t);
      load_pre<PRE>(x, p, pre_tile, row0, r_base, nrows);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[n][j] *= silu_grad(x[n][j]);
      tc::add_col_sums(slot + 3 * D, z);  // db1
      tc::group_sync(bar, kGroupThreads);  // done with h1 and dz

      // ---- d_pre into T2, send into T1 ------------------------------------
      tc::store_rows(sT2, kWld, z, r_base, kTileRows);
      if (BATCHED) tc::copy_out_rows(p.d_pre + row0 * D, sT2, r_base, nrows);
      tc::load_rows<true>(x, p.send + row0 * D, D, r_base, nrows);
      tc::store_rows(sT1, kWld, x, r_base, kTileRows);
      tc::group_sync(bar, kGroupThreads);  // T1 = send, T2 = d_pre
      tc::gemm_tn(dW1s, sT2, r_base, sT1);

      // ---- d_recproj in edge order; s[e] = sum_b d_pre[e, b] ---------------
#pragma unroll 4
      for (int j = 0; j < kAgg; ++j) {
        // (receiver, b) row q of the chunk and feature d of this thread
        const int q = (tg >> 6) + 2 * j, d = tg & (D - 1);
        if (q < nr * B) {
          const int rl = (q * inv_b) >> 16, b = q - rl * B;
          const int a = max(sRowptr[rl], t0), zz = min(sRowptr[rl + 1], t0 + ne);
          if (a < zz) {
            float s = recproj[tg + j * kGroupThreads];  // this thread's own entry
            for (int e = a; e < zz; ++e) s += sT2[((e - t0) * B + b) * kWld + d];
            recproj[tg + j * kGroupThreads] = s;
          }
        }
      }
      if (!BATCHED) {
        for (int i = tg; i < ne * D; i += kGroupThreads) {
          const int el = i / D, c = i - el * D;
          float s = 0.0f;
          for (int b = 0; b < B; ++b)
            s += sT2[(el * B + b) * kWld + c];
          p.d_pre[static_cast<long long>(t0) * D + i] = s;
        }
      }
      tc::group_sync(bar, kGroupThreads);  // done with send in T1

      // ---- d_send = d_pre . W1s (+ d_msg), through T1 ----------------------
      tc::load_rows<false>(z, sT2, kWld, r_base, kTileRows);  // the warp's d_pre rows
      tc::zero(x);
      tc::gemm_wg<4>(x, z, sW1st);
      if (p.propagation) {
        if (BF_STREAMS) {
          load_d_msg(z, p, sRloc, r0, row0, r_base, nrows);
        } else {
          // the residual this thread wrote above: a plain (coherent) load
          tc::load_rows<false>(z, reinterpret_cast<const float*>(p.d_send) + row0 * D, D,
                               r_base, nrows);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) x[n][j] += z[n][j];
      }
      tc::store_rows(sT1, kWld, x, r_base, kTileRows);
      tc::copy_out_rows(p.d_send + row0 * D, sT1, r_base, nrows);
    }
  }

  // ---- the group's partials, once -----------------------------------------
  float* ws = p.ws + static_cast<long long>(gi) * kMainStride;
  tc::store_rows(ws, D, dW2, r_base, D);
  tc::store_rows(ws + kMat, D, dW1s, r_base, D);
  tc::group_sync(bar, kGroupThreads);  // every warp's slots are final
  for (int i = tg; i < 4 * D; i += kGroupThreads) {
    float s = 0.0f;
    for (int w = 0; w < kGroupWarps; ++w) s += sSlots[w * 4 * D + i];
    ws[2 * kMat + i] = s;
  }
}

// The main kernel with bf16 operands (the BF instantiations), on Hopper's
// bf16 tensor cores (tc_bf16.cuh): per tile the float32 kernel's function,
// each product's operands rounded to bf16 (the JAX kernel's cdt = bf16),
// the receiver sums, s and the column sums in the same order.
//   * z = h1 . W2^T, d_h1 = dz . W2 and d_send = d_pre . W1s are wgmma
//     m64n64k16 with the rows as packed bf16 fragments in registers, and
//     W2 and W1s one bf16 copy each: the transpose bit reads W2 and W1s as
//     the MN-major B of the last two, where the TF32 design kept transposed
//     copies (TF32 wgmma takes K-major operands only).
//   * dW2 += h1^T . dz and dW1s += send^T . d_pre are wgmma with both
//     operands in shared memory (bf16 tiles in the core layout, both
//     transposed). dW2 accumulates in the tensor core into the warp's
//     16 x 64 share, which stays in registers across the group's tiles; the
//     dW2 product is issued without waiting, and the receiver sums, s and
//     the d_pre stream run on the SIMT units under it. Each tile's dW1s
//     share starts from zero and joins a float32 copy in shared memory on
//     the float32 units: both shares in registers spilled up to 156 bytes
//     a thread and ran 3 % slower per training step on an H100.
//   * d_pre also goes through a float32 tile: the receiver sums add it in
//     float32 and edge order, s adds its bf16 roundings, as before. The
//     chunk's receiver sums stay in shared memory until its last tile (one
//     store of each row), and a saved pre is read once: SiLU'(pre) waits in
//     the float32 tile for d_h1.
//   * 8 + 8 KB of weights and 65 KB per group, kGroups groups a block (12
//     warps) at up to 168 registers a thread: four groups (at 128, dW1s in
//     registers) spilled 0.6-1.2 KB a thread and ran 9 % slower per
//     training step on an H100.
//   * The recompute of pre (PRE == kPreRecompute) runs K3's BF products in
//     K3's k order: mma.sync m16n8k16 on weights read through L1, the
//     sender and batched edge rows read straight into k-slot order.
// The body is bwd_main_bf, which K8's main kernel (fused_edge_v2_bwd.cu)
// runs too with V2: the same chain without the sender half (no W1s, no
// d_send, no dW1s), the d_pre stream written in every mode and s into
// presum, GROUPS groups a block and K8's workspace stride.
template <int MODE, int PRE, typename TI, bool V2 = false, int GROUPS = kGroups>
__device__ __forceinline__ void bwd_main_bf(const MainParams<TI>& p) {
  using tcb::bf16;
  constexpr bool BATCHED = MODE == EDGE_BATCHED;
  constexpr bool RECOMPUTE = PRE == kPreRecompute;
  constexpr bool BF_STREAMS = sizeof(TI) == 2;
  constexpr int kThreads = GROUPS * kGroupThreads;
  static_assert(!(V2 && RECOMPUTE), "K8 starts from a saved pre");
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr MainSmemBf L = main_plan_bf(RECOMPUTE, V2, GROUPS);
  bf16* sW2 = reinterpret_cast<bf16*>(sm + L.w2);
  bf16* sW1s = reinterpret_cast<bf16*>(sm + L.w1s);
  const float* sB2 = sm + L.vec;
  const float* sGam = sB2 + D;
  const float* sB1 = sB2 + 2 * D;      // RECOMPUTE
  const float* sEV = sB2 + 4 * D;      // RECOMPUTE: eb1 eb2 eg ebt
  const float* sEW1 = sm + L.ew1;      // RECOMPUTE, EDGE_RAW: We1 as (F, D)

  tcb::load_weight<false>(sW2, p.w2, D, 0, kThreads);
  if (!V2) tcb::load_weight<false>(sW1s, p.w1, 3 * D, D, kThreads);
  tcb::fence_async();
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L.vec;
    v[c] = p.b2[c];
    v[D + c] = p.layer_norm ? p.gamma[c] : 1.0f;
    if (RECOMPUTE) v[2 * D + c] = p.b1[c];
    if (RECOMPUTE && MODE == EDGE_RAW) {
      v[4 * D + c] = p.eb1[c];
      v[5 * D + c] = p.eb2[c];
      v[6 * D + c] = p.eg[c];
      v[7 * D + c] = p.ebt[c];
    }
  }
  if (RECOMPUTE && MODE == EDGE_RAW) {
    for (int i = threadIdx.x; i < p.feat * D; i += kThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      sm[L.ew1 + i] = tc::bf16r(__ldg(p.ew1 + c * p.feat + k));  // the SIMT layer's operand
    }
  }

  const int group = threadIdx.x / kGroupThreads;
  const int tg = threadIdx.x - group * kGroupThreads;
  const int warp = tg >> 5;
  const int bar = 1 + group;  // named barrier of the group (0 is __syncthreads)
  float* gs = sm + L.groups + group * L.group_floats;
  bf16* sT1 = reinterpret_cast<bf16*>(gs + L.t1);
  bf16* sT2 = reinterpret_cast<bf16*>(gs + L.t2);
  float* sTP = gs + L.tp;
  float* sRP = gs + L.rp;  // this thread's d_recproj entries: tg + kGroupThreads j
  float* sDW = gs + L.dw;
  float* sSlots = gs + L.slots;
  int* sRowptr = reinterpret_cast<int*>(gs + L.ints);
  int* sRloc = sRowptr + 36;
  for (int i = tg; i < kGroupWarps * 4 * D; i += kGroupThreads) sSlots[i] = 0.0f;
  if (!V2)
    for (int i = tg; i < D * kWld; i += kGroupThreads) sDW[i] = 0.0f;
  __syncthreads();

  float* slot = sSlots + warp * 4 * D;  // this warp's db2 | dgamma | dbeta | db1
  const int B = p.batch, R = p.recv_per_chunk, TE = p.edges_per_tile;
  const int BD = B * D;
  const int r_base = 16 * warp;  // the warp's first row of a tile, and of dW
  const int gi = blockIdx.x * GROUPS + group;
  const tc::Lane lane;
  const int inv_b = (65536 + B - 1) / B;  // q / B = (q * inv_b) >> 16 for q < 64
  const int ni_e = (TE + 15) / 16;        // 16-edge groups that hold a tile's edges
  // RECOMPUTE: the group's workspace, a tile's pre then a chunk's rec . W1r
  float* pre_tile = RECOMPUTE ? p.pre_ws + static_cast<long long>(gi) * kPreStride : nullptr;
  float* rp_tile = RECOMPUTE ? pre_tile + kTileRows * D : nullptr;

  float dW2[8][4];
  tc::zero(dW2);

  for (int chunk = gi; chunk < p.num_chunks; chunk += gridDim.x * GROUPS) {
    const int r0 = chunk * R;
    const int nr = min(R, p.num_rec - r0);
    tc::group_sync(bar, kGroupThreads);  // the last chunk is done with gs
    if (tg <= nr) sRowptr[tg] = p.rowptr[r0 + tg];
    // the chunk's d_recproj rows are summed in shared memory, each entry by
    // one thread in edge order
#pragma unroll
    for (int j = 0; j < kAgg; ++j) sRP[tg + j * kGroupThreads] = 0.0f;
    if (RECOMPUTE && warp < 2) {
      // rec . W1r once per (receiver, b) of the chunk (K3's product)
      float acc[8][4];
      uint32_t a[4][4];
      tcb::load_rows_k(a, p.rec + static_cast<long long>(r0) * BD, r_base, nr * B);
      tc::zero(acc);
      tcb::gemm_g<true>(acc, a, p.w1 + 2 * D, 3 * D);
      tc::store_rows(rp_tile, D, acc, r_base, kRecRows);
    }
    tc::group_sync(bar, kGroupThreads);

    const int e_begin = sRowptr[0], e_end = sRowptr[nr];
    for (int t0 = e_begin; t0 < e_end; t0 += TE) {
      const int ne = min(TE, e_end - t0);
      const int nrows = ne * B;
      const long long row0 = static_cast<long long>(t0) * B;
      // bf16 residuals read sRloc again at the end of the last tile
      if (BF_STREAMS && p.propagation) tc::group_sync(bar, kGroupThreads);
      if (tg < nr) {
        const int a = max(sRowptr[tg], t0), z = min(sRowptr[tg + 1], t0 + ne);
        for (int e = a; e < z; ++e) sRloc[e - t0] = tg;
      }

      float x[8][4], z[8][4], rstd[2];
      uint32_t a[4][4];
      if (RECOMPUTE) {
        // ---- pre again, as K3 forms it -----------------------------------
        if (MODE != EDGE_BATCHED && B > 1 && warp < ni_e) {
          // edge_val . W1e once per edge, shared by the batch, into the
          // warp's own rows of TP
          fused_edge::edge_value_bf<MODE, true>(x, p.edge, p.feat, t0, sEW1, p.ew2, sEV,
                                                r_base, ne);
          tcb::pack_frag(a, x);
          tc::zero(z);
          tcb::gemm_g(z, a, p.w1, 3 * D);
          tc::store_rows(sTP, kWld, z, r_base, 32);
        }
        tc::zero(x);
        if (MODE == EDGE_BATCHED) {
          tcb::load_rows_k(a, p.edge + row0 * D, r_base, nrows);
          tcb::gemm_g<true>(x, a, p.w1, 3 * D);
        } else if (B == 1) {
          // edge and row coincide: edge_val . W1e for the warp's own rows
          fused_edge::edge_value_bf<MODE, true>(z, p.edge, p.feat, t0, sEW1, p.ew2, sEV,
                                                r_base, ne);
          tcb::pack_frag(a, z);
          tcb::gemm_g(x, a, p.w1, 3 * D);
        }
        tcb::load_rows_k(a, p.send + row0 * D, r_base, nrows);
        tcb::gemm_g<true>(x, a, p.w1 + D, 3 * D);
        tc::group_sync(bar, kGroupThreads);  // sRloc and the per-edge products are written
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          const int el = m / B, b = m - el * B;
          const int rl = m < nrows ? sRloc[el] : 0;
          const float* rp = rp_tile + (rl * B + b) * D + 2 * l.t;
          const float* pj = sTP + el * kWld + 2 * l.t;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 r2 = *reinterpret_cast<const float2*>(rp + 8 * n);
            const float2 b2 = *reinterpret_cast<const float2*>(sB1 + 8 * n + 2 * l.t);
            x[n][2 * h] += b2.x + r2.x;
            x[n][2 * h + 1] += b2.y + r2.y;
            if (MODE != EDGE_BATCHED && B > 1) {
              const float2 q = *reinterpret_cast<const float2*>(pj + 8 * n);
              x[n][2 * h] += q.x;
              x[n][2 * h + 1] += q.y;
            }
            if (m >= nrows) x[n][2 * h] = x[n][2 * h + 1] = 0.0f;  // as a saved tile reads
          }
        }
        tc::store_rows(pre_tile, D, x, r_base, kTileRows);
      } else {
        load_pre<PRE>(x, p, pre_tile, row0, r_base, nrows);
        // SiLU'(pre) into the warp's own rows of TP, for d_pre below (every
        // warp's last reads of TP were before the last tile's final
        // barrier), and h1 = SiLU(pre), both from one exp
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float sg[2];
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              float& v = x[n][2 * h + j];
              const float den = 1.0f + expf(-v);  // silu and silu_grad's own expressions
              const float sig = 1.0f / den;
              sg[j] = sig * (1.0f + v * (1.0f - sig));
              v = v / den;
            }
            *reinterpret_cast<float2*>(sTP + (r_base + lane.g + 8 * h) * kWld + 8 * n +
                                       2 * lane.t) = make_float2(sg[0], sg[1]);
          }
      }

      // ---- the forward again from pre: h1 into T1, z and its x_hat -------
      if (RECOMPUTE) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) x[n][j] = silu(x[n][j]);
      }
      tcb::pack_frag(a, x);  // h1
      tc::zero(z);
      tcb::gemm_wg(z, a, sW2);
      tc::add_cols(z, sB2);
      if (p.layer_norm) tc::layer_norm(z, nullptr, nullptr, kLnEps, rstd);
      tcb::store_tile(sT1, a, r_base);
      tc::group_sync(bar, kGroupThreads);  // sRloc is written

      // ---- d_msg, then dz through the LayerNorm into T2 ------------------
      load_d_msg(x, p, sRloc, r0, row0, r_base, nrows);
      // d_send's residual term, added below: kept in d_send for float32
      // rows, loaded again for bf16 ones (a bf16 d_send would round it)
      if (!BF_STREAMS && p.propagation)
        tc::store_rows(reinterpret_cast<float*>(p.d_send) + row0 * D, D, x, r_base, nrows);
      if (p.layer_norm) {
        tc::add_col_sums(slot + D, x, z);   // dgamma
        tc::add_col_sums(slot + 2 * D, x);  // dbeta
        tc::layer_norm_bwd(x, z, rstd, sGam);
      }
      tc::add_col_sums(slot, x);  // db2
      tcb::pack_frag(a, x);       // dz
      tcb::store_tile(sT2, a, r_base);
      tcb::fence_async();

      // ---- d_h1 = dz . W2, d_pre = d_h1 * SiLU'(pre) into TP --------------
      tc::zero(z);
      tcb::gemm_wg<1>(z, a, sW2);
      if (RECOMPUTE) {
        load_pre<PRE>(x, p, pre_tile, row0, r_base, nrows);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) z[n][j] *= silu_grad(x[n][j]);
      } else {
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 sg = *reinterpret_cast<const float2*>(
                sTP + (r_base + lane.g + 8 * h) * kWld + 8 * n + 2 * lane.t);
            z[n][2 * h] *= sg.x;
            z[n][2 * h + 1] *= sg.y;
          }
      }
      tc::add_col_sums(slot + 3 * D, z);  // db1
      tc::store_rows(sTP, kWld, z, r_base, kTileRows);
      tc::group_sync(bar, kGroupThreads);  // T1 = h1, T2 = dz, TP = d_pre

      // ---- dW2 += h1^T . dz on the tensor cores, and meanwhile the d_pre
      // stream, d_recproj in edge order and s[e] = sum_b d_pre[e, b] -------
      tcb::gemm_tn_issue(dW2, sT2, sT1);
      {
        if (BATCHED || V2) tc::copy_out_rows(p.d_pre + row0 * D, sTP, r_base, nrows);
#pragma unroll 4
        for (int j = 0; j < kAgg; ++j) {
          // (receiver, b) row q of the chunk and feature d of this thread
          const int q = (tg >> 6) + 2 * j, d = tg & (D - 1);
          if (q < nr * B) {
            const int rl = (q * inv_b) >> 16, b = q - rl * B;
            const int ea = max(sRowptr[rl], t0), ez = min(sRowptr[rl + 1], t0 + ne);
            if (ea < ez) {
              float s = sRP[tg + j * kGroupThreads];  // this thread's own entry
              for (int e = ea; e < ez; ++e) s += sTP[((e - t0) * B + b) * kWld + d];
              sRP[tg + j * kGroupThreads] = s;
            }
          }
        }
        if (!BATCHED) {
          float* s_out = (V2 ? p.presum : p.d_pre) + static_cast<long long>(t0) * D;
          for (int i = tg; i < ne * D; i += kGroupThreads) {
            const int el = i / D, c = i - el * D;
            float s = 0.0f;
            for (int b = 0; b < B; ++b) s += tc::bf16r(sTP[(el * B + b) * kWld + c]);
            s_out[i] = s;
          }
        }
        tcb::wg_wait(dW2);
      }
      tc::group_sync(bar, kGroupThreads);  // done with h1, dz and d_pre in TP
      if constexpr (V2) continue;  // K8: no sender half

      // ---- d_pre and send as bf16 tiles: dW1s += send^T . d_pre ----------
      tc::load_rows<false>(x, sTP, kWld, r_base, kTileRows);  // the warp's d_pre rows
      tcb::pack_frag(a, x);
      tcb::store_tile(sT2, a, r_base);
      {
        std::conditional_t<BF_STREAMS, uint4[4], float4[8]> send_rows;
        tcb::load_staged(send_rows, p.send + row0 * D, r_base, nrows);
        tcb::store_staged(sT1, send_rows, r_base);
      }
      tcb::fence_async();
      tc::group_sync(bar, kGroupThreads);  // T1 = send, T2 = d_pre
      {
        float t[8][4];
        tc::zero(t);
        tcb::gemm_tn_issue(t, sT2, sT1);
        tcb::wg_wait(t);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float2* w = reinterpret_cast<float2*>(sDW + (r_base + lane.g + 8 * h) * kWld +
                                                  8 * n + 2 * lane.t);
            const float2 v = *w;
            *w = make_float2(v.x + t[n][2 * h], v.y + t[n][2 * h + 1]);
          }
      }
      tc::group_sync(bar, kGroupThreads);  // every warp is done with T1 and T2

      // ---- d_send = d_pre . W1s (+ d_msg), out through TP ------------------
      tcb::load_tile(a, sT2, r_base);
      tc::zero(x);
      tcb::gemm_wg<1>(x, a, sW1s);
      if (p.propagation) {
        if (BF_STREAMS) {
          load_d_msg(z, p, sRloc, r0, row0, r_base, nrows);
        } else {
          // the residual this thread wrote above: a plain (coherent) load
          tc::load_rows<false>(z, reinterpret_cast<const float*>(p.d_send) + row0 * D, D,
                               r_base, nrows);
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) x[n][j] += z[n][j];
      }
      tc::store_rows(sTP, kWld, x, r_base, kTileRows);
      tc::copy_out_rows(p.d_send + row0 * D, sTP, r_base, nrows);
    }
    // the chunk's d_recproj rows out, each entry once (this thread's own)
    float* recproj = p.d_recproj + static_cast<long long>(r0) * BD;
#pragma unroll
    for (int j = 0; j < kAgg; ++j)
      if ((tg >> 6) + 2 * j < nr * B)
        recproj[tg + j * kGroupThreads] = sRP[tg + j * kGroupThreads];
  }

  // ---- the group's partials, once: K4's dW2 | dW1s | column sums, K8's
  // dW2 | column sums ---------------------------------------------------------
  constexpr int kMats = V2 ? 1 : 2;
  float* ws = p.ws + static_cast<long long>(gi) * (kMats * kMat + 4 * D);
  tc::store_rows(ws, D, dW2, r_base, D);
  if (!V2) {
    float dW1s[8][4];
    tc::load_rows<false>(dW1s, sDW, kWld, r_base, D);
    tc::store_rows(ws + kMat, D, dW1s, r_base, D);
  }
  tc::group_sync(bar, kGroupThreads);  // every warp's slots are final
  for (int i = tg; i < 4 * D; i += kGroupThreads) {
    float s = 0.0f;
    for (int w = 0; w < kGroupWarps; ++w) s += sSlots[w * 4 * D + i];
    ws[kMats * kMat + i] = s;
  }
}

template <int MODE, int PRE, typename TI>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_edge_bwd_main_bf(const MainParams<TI> p) {
  bwd_main_bf<MODE, PRE, TI>(p);
}

template <int MODE, int PRE, bool BF, typename TI>
cudaError_t launch_main(const MainParams<TI>& p, int blocks, cudaStream_t stream) {
  constexpr bool recompute = PRE == kPreRecompute;
  constexpr int bytes = BF ? main_smem_bytes_bf(recompute) : main_smem_bytes(recompute);
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    if constexpr (BF)
      err = fused_edge::allow_smem(fused_edge_bwd_main_bf<MODE, PRE, TI>, bytes);
    else
      err = fused_edge::allow_smem(fused_edge_bwd_main<MODE, PRE, TI>, bytes);
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  if constexpr (BF)
    fused_edge_bwd_main_bf<MODE, PRE, TI><<<blocks, kBlockThreads, bytes, stream>>>(p);
  else
    fused_edge_bwd_main<MODE, PRE, TI><<<blocks, kBlockThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

// the launch resources of the main kernel's instantiation: out = blocks per
// SM, threads per block, registers per thread, shared memory per block,
// local memory per thread (bytes)
template <int MODE, int PRE, bool BF, typename TI>
cudaError_t main_occupancy_of(int* out) {
  constexpr bool recompute = PRE == kPreRecompute;
  out[1] = kBlockThreads;
  out[3] = BF ? main_smem_bytes_bf(recompute) : main_smem_bytes(recompute);
  if constexpr (BF)
    return tcb::occupancy(fused_edge_bwd_main_bf<MODE, PRE, TI>, out[1], out[3], out, out + 2,
                          out + 4);
  else
    return tcb::occupancy(fused_edge_bwd_main<MODE, PRE, TI>, out[1], out[3], out,
                          out + 2, out + 4);
}

// main_occupancy_of for edge_mode (the saved-pre kernels serve both
// per-edge modes with one), bf16_ops and io_bf16
template <int PRE>
cudaError_t main_occupancy_mode(int bf16_ops, int io_bf16, int edge_mode, int* out) {
  constexpr int kRaw = PRE == kPreRecompute ? EDGE_RAW : EDGE_SHARED;
#define NL_OCC(M)                                                           \
  (!bf16_ops ? main_occupancy_of<M, PRE, false, float>(out)                \
   : io_bf16 ? main_occupancy_of<M, PRE, true, __nv_bfloat16>(out)         \
             : main_occupancy_of<M, PRE, true, float>(out))
  switch (edge_mode) {
    case EDGE_RAW: return NL_OCC(kRaw);
    case EDGE_SHARED: return NL_OCC(EDGE_SHARED);
    case EDGE_BATCHED: return NL_OCC(EDGE_BATCHED);
    default: return cudaErrorInvalidValue;
  }
#undef NL_OCC
}

// the main kernel's instantiation for edge_mode: the saved-pre kernels
// serve both per-edge modes with one
template <int PRE, bool BF, typename TI>
cudaError_t launch_main_mode(int edge_mode, const MainParams<TI>& p, int blocks,
                             cudaStream_t s) {
  if (edge_mode == EDGE_BATCHED) return launch_main<EDGE_BATCHED, PRE, BF, TI>(p, blocks, s);
  if (edge_mode == EDGE_SHARED) return launch_main<EDGE_SHARED, PRE, BF, TI>(p, blocks, s);
  constexpr int kRaw = PRE == kPreRecompute ? EDGE_RAW : EDGE_SHARED;
  return launch_main<kRaw, PRE, BF, TI>(p, blocks, s);
}

// Fill the parameters and launch the main kernel, the edge input's share
// (the edge pass or the rows pass), the receiver slice and the reduce of
// the three workspaces, for the instantiation PRE, BF, TI
template <int PRE, bool BF, typename TI>
cudaError_t run(int edge_mode, int num_rec, int n_edges, int batch, int feat,
                int propagation, int layer_norm, int main_blocks, int edge_blocks,
                int rec_blocks, const void* edge, const void* send, const void* pre,
                const void* rec, const void* d_aggr, const void* d_new_edge,
                const void* rowptr, const void* w1, const void* b1, const void* w2,
                const void* b2, const void* gamma, const void* ew1, const void* eb1,
                const void* ew2, const void* eb2, const void* eg, const void* ebt,
                void* d_send, void* d_edge, void* d_recproj, void* d_pre, void* ws_main,
                void* out_main, void* ws_edge, void* out_edge, void* d_rec, void* ws_rec,
                void* out_rec, void* pre_ws, void* stream) {
  if (num_rec <= 0 || n_edges <= 0 || batch < 1 || batch > kRecRows ||
      feat > kMaxFeat || main_blocks <= 0 || edge_blocks <= 0 || rec_blocks <= 0 ||
      edge_mode < 0 || edge_mode > 2 || rec == nullptr)
    return cudaErrorInvalidValue;
  if (PRE == kPreRecompute ? pre_ws == nullptr : pre == nullptr) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool batched = edge_mode == EDGE_BATCHED;

  MainParams<TI> m;
  m.send = static_cast<const TI*>(send);
  m.pre = pre;
  m.d_aggr = static_cast<const TI*>(d_aggr);
  m.d_new_edge = static_cast<const TI*>(d_new_edge);
  m.rowptr = static_cast<const int*>(rowptr);
  m.w1 = static_cast<const float*>(w1);
  m.w2 = static_cast<const float*>(w2);
  m.b2 = static_cast<const float*>(b2);
  m.gamma = static_cast<const float*>(gamma);
  m.d_send = static_cast<TI*>(d_send);
  m.d_pre = static_cast<float*>(d_pre);
  m.d_recproj = static_cast<float*>(d_recproj);
  m.ws = static_cast<float*>(ws_main);
  m.edge = static_cast<const TI*>(edge);
  m.rec = static_cast<const TI*>(rec);
  m.b1 = static_cast<const float*>(b1);
  m.ew1 = static_cast<const float*>(ew1);
  m.eb1 = static_cast<const float*>(eb1);
  m.ew2 = static_cast<const float*>(ew2);
  m.eb2 = static_cast<const float*>(eb2);
  m.eg = static_cast<const float*>(eg);
  m.ebt = static_cast<const float*>(ebt);
  m.pre_ws = static_cast<float*>(pre_ws);
  m.feat = feat;
  m.num_rec = num_rec;
  m.batch = batch;
  m.recv_per_chunk = kRecRows / batch;
  m.edges_per_tile = kTileRows / batch;
  m.num_chunks = (num_rec + m.recv_per_chunk - 1) / m.recv_per_chunk;
  m.propagation = propagation;
  m.layer_norm = layer_norm;
  cudaError_t err = launch_main_mode<PRE, BF, TI>(edge_mode, m, main_blocks, s);
  if (err != cudaSuccess) return err;
  fused_edge::ReduceJobs jobs{};
  jobs.n = 3;
  jobs.job[0] = fused_edge::ReduceJob{m.ws, static_cast<float*>(out_main),
                                      main_blocks * kGroups, kMainStride, kMainStride};

  if (batched) {  // the edge input's share per (edge, b) row
    fused_edge::RowsParamsT<TI> r;
    r.x = m.edge;
    r.g = m.d_pre;
    r.add = m.d_new_edge;
    r.w1 = m.w1;
    r.w_off = 0;
    r.out = static_cast<TI*>(d_edge);
    r.ws = static_cast<float*>(ws_edge);
    r.rows = n_edges * batch;
    err = fused_edge::launch_rows<false, BF>(r, edge_blocks, static_cast<float*>(out_edge),
                                             &jobs.job[1], s);
  } else {  // the per-edge modes: the edge pass over s
    fused_edge::EdgeParamsT<TI> e;
    e.edge = m.edge;
    e.presum = m.d_pre;
    e.d_new_edge = m.d_new_edge;
    e.w1 = m.w1;
    e.ew1 = m.ew1;
    e.eb1 = m.eb1;
    e.ew2 = m.ew2;
    e.eb2 = m.eb2;
    e.eg = m.eg;
    e.ebt = m.ebt;
    e.d_edge = static_cast<TI*>(d_edge);
    e.ws = static_cast<float*>(ws_edge);
    e.n_edges = n_edges;
    e.batch = batch;
    e.feat = feat;
    err = fused_edge::launch_edge_pass<BF>(edge_mode, e, edge_blocks,
                                           static_cast<float*>(out_edge), &jobs.job[1], s);
  }
  if (err != cudaSuccess) return err;

  // the receiver slice, in float32 whatever the precision
  fused_edge::RowsParamsT<TI, float> q;
  q.x = m.rec;
  q.g = m.d_recproj;
  q.add = nullptr;
  q.w1 = m.w1;
  q.w_off = 2 * D;
  q.out = static_cast<float*>(d_rec);
  q.ws = static_cast<float*>(ws_rec);
  q.rows = num_rec * batch;
  err = fused_edge::launch_rows<true, false>(q, rec_blocks, static_cast<float*>(out_rec),
                                             &jobs.job[2], s);
  if (err != cudaSuccess) return err;
  return fused_edge::launch_reduces(jobs, s);
}

}  // namespace
