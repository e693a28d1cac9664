// K3: fused edge-phase forward of one InteractionNet / PropagationNet step:
// the kernel and its launch sequence, which fused_edge.cu instantiates
// (18 instantiations).
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_fwd_impl (the
// _fused_fwd_kernel + _embed_forward pallas_call), which the JAX package
// builds through make_fused_interaction. For every edge e (receiver r,
// sender gathered by K1 into send[e]) and batch member b:
//
//   edge_val = LN(We2 . SiLU(We1 . f[e] + be1) + be2)   (EDGE_RAW: in-kernel
//              embedder on the raw static features, shared across the batch)
//            | edge[e]                                   (EDGE_SHARED)
//            | edge[e, b]                                (EDGE_BATCHED)
//   pre      = edge_val . W1e + send[e, b] . W1s + (rec[r, b] . W1r) + b1
//              (written out as pre[e, b] when the caller will differentiate:
//              the backward kernel, fused_edge_bwd.cu, starts from it; in
//              float32, or rounded to bf16 under NEURAL_LAM_TPU_CACHE_PRE=bf16)
//   msg      = LN(SiLU(pre) . W2 + b2)         (LN optional: layer_norm)
//   msg     += send[e, b]                      (propagation only)
//   new_edge[e, b] = edge_val + msg            (update_edges only)
//   aggr[r, b]     = sum of msg over the edges into r (receivers without
//                    edges get 0)
//
// The weights arrive in PyTorch's nn.Linear layout (out, in): w1 is the
// (D, 3D) first edge-MLP layer [W1e | W1s | W1r], w2 is (D, D). LayerNorm
// uses the biased variance and eps 1e-5, as torch.nn.LayerNorm does.
//
// Design (what the TPU kernel computed, not how): the TPU version gathers
// receiver rows and aggregates with one-hot MXU matmuls over 256x512
// blocked-CSR tiles and folds the batch into lanes with kron(I, W) weights.
// Here the edges are a receiver-sorted CSR (rowptr) without dead slots.
//   * Products run on the tensor cores with the 3xTF32 split (tc_tf32.cuh),
//     at float32 accuracy. A group of 4 warps (one warpgroup) owns a tile
//     of 64 (edge, b) rows, 16 rows by all 64 features a warp, so the first
//     layer's output, its SiLU, the second layer and the LayerNorm (quad
//     shuffles) chain in registers. The tile's row products (send . W1s,
//     SiLU(pre) . W2, and edge . W1e for a batched edge input) are wgmma
//     m64n64k8 with the rows as the A operand in registers and the weight,
//     split into TF32 hi and lo halves once per block, in shared memory;
//     sender and edge rows are loaded from device memory straight into the
//     fragment layout (8-byte loads, whole sectors).
//   * A block of 12 warps holds the weights once and runs three
//     independent groups (what 227 KB of shared memory allows beside the
//     weights). A group takes chunks of R = 32/B consecutive receivers from
//     a work counter (an integer atomic; a chunk's result does not depend
//     on which group computes it) and walks their contiguous edge range in
//     tiles of 64 rows, TE = 64/B edges.
//   * The projection rec . W1r is computed once per (receiver, b) of the
//     chunk (the projection-first order of pallas_fused.py:264-278), with
//     mma.sync and W1r read through L1.
//   * The embedder runs once per edge and edge_val . W1e once per edge,
//     shared by the batch (the shared-edge path of pallas_fused.py:209-216),
//     with mma.sync on weights kept in float32 in shared memory, into shared
//     memory: at B >= 4 a tile's edges fill one 16-row fragment and the
//     group's four warps each take 16 of its output columns; at B = 2, 3
//     warps 0 and 1 take 16 edges each; at B = 1, where edge and row
//     coincide, each warp computes its own rows in registers. The
//     embedder's F <= 8 wide first layer runs on the SIMT units.
//   * Messages go through a shared tile once: the group's threads own the
//     chunk's (receiver, b, feature) sums in registers and add the tile's
//     messages in edge order, so the sum is deterministic and needs no
//     atomics; each aggregate row is written once, at the chunk's end.
//     pre and the updated edges go out through the same tile as whole
//     rows (16-byte stores).
//   * Load latency is hidden by the other two groups of the SM: a group
//     issues a tile's sender (and edge) row loads before its products.
//
// Bound on the H100: operations at hidden 64 (about 2*D FLOP per byte
// moved), against the tensor cores' 495 TFLOP/s of TF32, which 3xTF32
// divides by three; the bytes moved bound the smaller sets.
//
// Reduced precision (the JAX kernel's cdt = bf16 and io_dt, pallas_fused.py
// :1414-1453): the instantiations with BF multiply bf16 operands (every
// product's two operands rounded to bf16, float32 accumulation), with SiLU,
// LayerNorm, the residuals and the receiver sums in float32. They run on
// Hopper's bf16 tensor cores (tc_bf16.cuh): the row products as wgmma
// m64n64k16 on packed bf16 fragments, the per-edge, embedder and receiver
// products as mma.sync m16n8k16; every weight is one bf16 copy in
// shared memory (8 KB where the split float32 one takes 32), W1r too, and
// sender, batched edge and receiver rows load
// straight into k-slot order with 16-byte loads. That leaves room for four
// groups a block (16 warps per SM, up to 128 registers a thread; three and
// five ran 8 % and 17 % slower per AR step on an H100). Their streams edge,
// send and rec are of type TI:
// bf16 under mixed precision and NEURAL_LAM_TPU_MATMUL_PRECISION=high,
// float32 under high-kernels. aggr and new_edge are written in float32 or,
// with out_bf16, rounded to bf16 on the way out. The TPU
// kernel's one-hot selection matmuls also round the receiver projection and
// each message to bf16 before they are gathered and summed; those are
// Mosaic's way to gather, and here the gather and the sums are exact.
// Bound: bytes at the stream dtype, or the products at the dense bf16 rate
// (989 TFLOP/s).
//
// The saved pre-activation (the JAX kernel's pre_dt, pallas_fused.py:897,
// :1490-1492, stored at :292-295): the instantiations with PRE_BF16 round
// pre to bf16 (to nearest even, as astype(bfloat16)) as they store it,
// halving the largest per-edge stream the backward keeps; the second layer,
// aggr and new_edge are computed from the unrounded value, in every
// precision. Under NEURAL_LAM_TPU_CACHE_PRE=off no pre is written (a null
// pointer) and K4 recomputes it.
//
// The node-MLP route (NEURAL_LAM_TPU_FUSED_AGGR=on; the JAX kernel's
// node_epilogue, pallas_fused.py:335-391): K3 writes the aggregate in
// float32 (aggr_f32, in every precision, beside bf16 updated edges under
// out_bf16) and the node update runs as a row kernel of its own right after
// it (fused_node.cu), which describes its design.
//

#pragma once

#include <type_traits>

#include "fused_edge_common.cuh"
#include "tc_bf16.cuh"
#include "tc_tf32.cuh"

namespace {

using fused_edge::D;
using fused_edge::EDGE_BATCHED;
using fused_edge::EDGE_RAW;
using fused_edge::EDGE_SHARED;
using fused_edge::kLnEps;
using fused_edge::kMaxFeat;
using fused_edge::kRecRows;
using fused_edge::kTileRows;
using fused_edge::silu;
using tc::kWld;

constexpr int kGroupWarps = 4;  // a group is one warpgroup
constexpr int kGroupThreads = 32 * kGroupWarps;
constexpr int kAgg = kRecRows * D / kGroupThreads;  // sums per thread
constexpr int kMat = D * kWld;           // a weight for mma.sync in shared memory
constexpr int kWgMat = 2 * tc::kWgHalf;  // a weight for wgmma: its hi and lo halves
constexpr int kBfMat = tcb::kMatFloats;  // a bf16 weight in the core layout (BF)

// groups per block: what fits in 227 KB of shared memory beside the
// weights in the raw mode (12 warps per SM, up to 168 registers a thread);
// the batched mode would fit four, and ran 4 % slower with them on an H100
// (128 registers a thread spill)
constexpr int kGroups = 3;
constexpr int kBlockThreads = kGroups * kGroupThreads;
// and of the BF instantiations: their bf16 weights take a quarter of the
// float32 ones' shared memory and their products half the registers, so
// more groups fit: four (at 128 registers a thread) ran 8 % faster than
// three and 17 % faster than five on an H100
constexpr int kGroupsBf = 4;

__host__ __device__ constexpr int groups_of(bool bf) { return bf ? kGroupsBf : kGroups; }
__host__ __device__ constexpr int block_threads(bool bf) {
  return groups_of(bf) * kGroupThreads;
}

template <typename TI>
struct Params {
  const TI* edge;
  const TI* send;
  const TI* rec;
  const int* rowptr;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* gamma;
  const float* beta;
  const float* ew1;
  const float* eb1;
  const float* ew2;
  const float* eb2;
  const float* eg;
  const float* ebt;
  void* aggr;      // float, or bf16 with out_bf16 unless aggr_f32
  void* new_edge;  // float, or bf16 with out_bf16
  void* pre;       // float, or bf16 with PRE_BF16; null: not saved
  int* counter;  // zero on entry: the next chunk to take
  int out_bf16;
  int aggr_f32;
  int num_rec;
  int num_chunks;
  int batch;
  int feat;
  int recv_per_chunk;
  int edges_per_tile;
  int update_edges;
  int propagation;
  int layer_norm;
};

// Shared-memory plan, in floats: the block's weights (W1s and W2, and W1e
// of a batched edge input, split for wgmma; W1e of a per-edge input and the
// embedder's We2 for mma.sync; with bf, each one bf16 copy in the core
// layout, and W1r too) and vectors, then per group a tile of 64
// rows (messages; edge values before them), the per-edge products of a
// tile (32 rows), the chunk's receiver projections (32 rows) and its
// integers.
struct Smem {
  int w1s, w2, w1e, ew2, ew1, vec, w1r, groups, group_floats, total;
  int stage, proj, rp, ints;  // offsets inside a group
};

__host__ __device__ constexpr Smem smem_plan(int mode, bool bf = false) {
  Smem s{};
  int o = 0;
  s.w1s = o; o += bf ? kBfMat : kWgMat;
  s.w2 = o; o += bf ? kBfMat : kWgMat;
  s.w1e = o; o += bf ? kBfMat : (mode == EDGE_BATCHED) ? kWgMat : kMat;
  s.ew2 = o; o += (mode == EDGE_RAW) ? (bf ? kBfMat : kMat) : 0;
  s.ew1 = o; o += (mode == EDGE_RAW) ? kMaxFeat * D : 0;
  s.vec = o; o += 8 * D;  // b1 b2 gamma beta | eb1 eb2 eg ebt
  s.w1r = o; o += bf ? kBfMat : 0;  // W1r, k-slot order
  s.groups = o;
  int g = 0;
  s.stage = g; g += kTileRows * kWld;
  s.proj = g; g += (mode == EDGE_BATCHED) ? 0 : 32 * kWld;
  s.rp = g; g += kRecRows * kWld;
  s.ints = g; g += 100;  // rowptr (<= 33), chunk index, receiver of each tile edge (64)
  s.group_floats = g;
  s.total = o + groups_of(bf) * g;
  return s;
}

template <int MODE, bool BF = false>
constexpr int smem_bytes() {
  return smem_plan(MODE, BF).total * static_cast<int>(sizeof(float));
}

// edge_val of the tile's edges el0 + g, el0 + g + 8 (zero at el >= ne) as
// a row fragment: the embedder on the raw features, or the shared edge rows
template <int MODE, bool BF, typename TI>
__device__ __forceinline__ void edge_value(float (&ev)[8][4], const Params<TI>& p,
                                           const float* sm, int t0, int el0, int ne) {
  constexpr Smem L = smem_plan(MODE, BF);
  if constexpr (BF)
    fused_edge::edge_value_bf<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, sm + L.ew2,
                                    sm + L.vec + 4 * D, el0, ne);
  else
    fused_edge::edge_value<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, sm + L.ew2,
                                 sm + L.vec + 4 * D, el0, ne);
}


// rows r0 .. of the staged tile out to dst (float or bf16 by out_bf16)
__device__ __forceinline__ void copy_out(void* dst, int out_bf16, long long offset,
                                         const float* stage, int r0, int valid) {
  if (out_bf16)
    tc::copy_out_rows(static_cast<__nv_bfloat16*>(dst) + offset, stage, r0, valid);
  else
    tc::copy_out_rows(static_cast<float*>(dst) + offset, stage, r0, valid);
}

// BF: bf16 operands (bf16 fragments, tc_bf16.cuh); PRE_BF16: pre stored in
// bf16; TI: the stream type (float or bf16)
template <int MODE, bool BF, bool PRE_BF16, typename TI>
__global__ void __launch_bounds__(block_threads(BF), 1)
fused_edge_fwd(const Params<TI> p) {
  using TP = std::conditional_t<PRE_BF16, __nv_bfloat16, float>;
  constexpr int kThreads = block_threads(BF);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr Smem L = smem_plan(MODE, BF);
  // BF: the weights' bf16 copies
  const tcb::bf16* bW1r = reinterpret_cast<const tcb::bf16*>(sm + L.w1r);
  const tcb::bf16* bW1e = reinterpret_cast<const tcb::bf16*>(sm + L.w1e);
  const tcb::bf16* bW1s = reinterpret_cast<const tcb::bf16*>(sm + L.w1s);
  const tcb::bf16* bW2 = reinterpret_cast<const tcb::bf16*>(sm + L.w2);
  const tcb::bf16* bEW2 = reinterpret_cast<const tcb::bf16*>(sm + L.ew2);
  const float* sW1e = sm + L.w1e;
  const float* sW1s = sm + L.w1s;
  const float* sW2 = sm + L.w2;
  const float* sB1 = sm + L.vec;
  const float* sB2 = sB1 + D;
  const float* sG = sB2 + D;
  const float* sBt = sG + D;

  // ---- the block's weights and vectors ------------------------------------
  if constexpr (BF) {
    // W1s (and a batched W1e) meet rows read by load_rows_k: k-slot order
    tcb::bf16* w = reinterpret_cast<tcb::bf16*>(sm);
    tcb::load_weight<true>(w + 2 * L.w1s, p.w1, 3 * D, D, kThreads);
    tcb::load_weight<false>(w + 2 * L.w2, p.w2, D, 0, kThreads);
    if (MODE == EDGE_BATCHED)
      tcb::load_weight<true>(w + 2 * L.w1e, p.w1, 3 * D, 0, kThreads);
    else
      tcb::load_weight<false>(w + 2 * L.w1e, p.w1, 3 * D, 0, kThreads);
    if (MODE == EDGE_RAW) tcb::load_weight<false>(w + 2 * L.ew2, p.ew2, D, 0, kThreads);
    tcb::load_weight<true>(w + 2 * L.w1r, p.w1, 3 * D, 2 * D, kThreads);
    tcb::fence_async();
  } else {
    tc::load_weight_wg(sm + L.w1s, p.w1, 3 * D, D, kBlockThreads);
    tc::load_weight_wg(sm + L.w2, p.w2, D, 0, kBlockThreads);
    if (MODE == EDGE_BATCHED)
      tc::load_weight_wg(sm + L.w1e, p.w1, 3 * D, 0, kBlockThreads);
    else
      tc::load_weight_rows(sm + L.w1e, p.w1, 3 * D, 0, kBlockThreads);
    if (MODE == EDGE_RAW) tc::load_weight_rows(sm + L.ew2, p.ew2, D, 0, kBlockThreads);
  }
  if (MODE == EDGE_RAW) {
    for (int i = threadIdx.x; i < p.feat * D; i += kThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      const float w = __ldg(p.ew1 + c * p.feat + k);
      sm[L.ew1 + i] = BF ? tc::bf16r(w) : w;  // the SIMT layer's operand
    }
  }
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L.vec;
    v[c] = p.b1[c];
    v[D + c] = p.b2[c];
    v[2 * D + c] = p.layer_norm ? p.gamma[c] : 1.0f;
    v[3 * D + c] = p.layer_norm ? p.beta[c] : 0.0f;
    if (MODE == EDGE_RAW) {
      v[4 * D + c] = p.eb1[c];
      v[5 * D + c] = p.eb2[c];
      v[6 * D + c] = p.eg[c];
      v[7 * D + c] = p.ebt[c];
    }
  }
  __syncthreads();

  // ---- one group of 4 warps from here on -----------------------------------
  const int group = threadIdx.x / kGroupThreads;
  const int tg = threadIdx.x - group * kGroupThreads;
  const int warp = tg >> 5;
  const int bar = 1 + group;  // named barrier of the group (0 is __syncthreads)
  float* gs = sm + L.groups + group * L.group_floats;
  float* sStage = gs + L.stage;
  float* sProj = gs + L.proj;
  float* sRP = gs + L.rp;
  int* sRowptr = reinterpret_cast<int*>(gs + L.ints);
  int* sChunk = sRowptr + 33;
  int* sRloc = sRowptr + 36;

  const int B = p.batch, R = p.recv_per_chunk, TE = p.edges_per_tile;
  const int BD = B * D;
  const int ni_e = (TE + 15) / 16;  // 16-edge groups that hold a tile's edges
  const int inv_b = (65536 + B - 1) / B;  // q / B = (q * inv_b) >> 16 for q < 64
  const int r_base = 16 * warp;     // the warp's first row of a tile

  for (;;) {
    if (tg == 0) *sChunk = atomicAdd(p.counter, 1);
    tc::group_sync(bar, kGroupThreads);  // also: the last chunk is done with gs
    const int chunk = *sChunk;
    if (chunk >= p.num_chunks) break;
    const int r0 = chunk * R;
    const int nr = min(R, p.num_rec - r0);
    if (tg <= nr) sRowptr[tg] = p.rowptr[r0 + tg];

    // ---- rec . W1r once per (receiver, b): warp w takes rows 16 w .. ------
    if (warp < 2) {
      float acc[8][4];
      tc::zero(acc);
      if constexpr (BF) {
        uint32_t a[4][4];
        tcb::load_rows_k(a, p.rec + static_cast<long long>(r0) * BD, r_base, nr * B);
        tcb::gemm(acc, a, bW1r);
      } else {
        float x[8][4];
        tc::load_rows<true>(x, p.rec + static_cast<long long>(r0) * BD, D, r_base, nr * B);
        tc::gemm<true>(acc, x, p.w1 + 2 * D, 3 * D);
      }
      tc::store_rows(sRP, kWld, acc, r_base, kRecRows);
    }
    float agg[kAgg];
#pragma unroll
    for (int j = 0; j < kAgg; ++j) agg[j] = 0.0f;
    tc::group_sync(bar, kGroupThreads);

    const int e_begin = sRowptr[0], e_end = sRowptr[nr];
    for (int t0 = e_begin; t0 < e_end; t0 += TE) {
      const int ne = min(TE, e_end - t0);
      const int nrows = ne * B;
      const long long row0 = static_cast<long long>(t0) * B;
      if (tg < nr) {
        const int a = max(sRowptr[tg], t0), z = min(sRowptr[tg + 1], t0 + ne);
        for (int e = a; e < z; ++e) sRloc[e - t0] = tg;
      }

      // ---- first layer: the row products --------------------------------
      float acc[8][4];
      tc::zero(acc);
      if constexpr (BF) {
        // the sender rows' loads go out first; the edge input's product
        // waits on its own
        uint32_t a[4][4], s[4][4];
        tcb::load_rows_k(s, p.send + row0 * D, r_base, nrows);
        if (MODE == EDGE_BATCHED) {
          tcb::load_rows_k(a, p.edge + row0 * D, r_base, nrows);
          tcb::gemm_wg(acc, a, bW1e);
        } else if (B == 1) {
          // edge and row coincide: edge_val . W1e for the warp's own rows
          float x[8][4];
          edge_value<MODE, BF>(x, p, sm, t0, r_base, ne);
          if (p.update_edges) tc::store_rows(sStage, kWld, x, r_base, kTileRows);
          tcb::pack_frag(a, x);
          tcb::gemm(acc, a, bW1e);
        }
        tcb::gemm_wg(acc, s, bW1s);
      } else {
        float x[8][4];
        if (MODE == EDGE_BATCHED) {
          tc::load_rows<true>(x, p.edge + row0 * D, D, r_base, nrows);
          tc::gemm_wg<8>(acc, x, sW1e);
        } else if (B == 1) {
          // edge and row coincide: edge_val . W1e for the warp's own rows
          edge_value<MODE, BF>(x, p, sm, t0, r_base, ne);
          if (p.update_edges) tc::store_rows(sStage, kWld, x, r_base, kTileRows);
          tc::gemm(acc, x, sW1e);
        }
        tc::load_rows<true>(x, p.send + row0 * D, D, r_base, nrows);
        tc::gemm_wg<8>(acc, x, sW1s);
      }
      // ---- per-edge products, shared by the batch (B > 1) ----------------
      if (MODE != EDGE_BATCHED && B > 1 && ni_e > 1 && warp < ni_e) {
        // B = 2, 3: 32 edge rows, warps 0 and 1 take 16 each
        float ev[8][4], proj[8][4];
        edge_value<MODE, BF>(ev, p, sm, t0, r_base, ne);
        if (p.update_edges) tc::store_rows(sStage, kWld, ev, r_base, kTileRows);
        tc::zero(proj);
        if constexpr (BF) {
          uint32_t a[4][4];
          tcb::pack_frag(a, ev);
          tcb::gemm(proj, a, bW1e);
        } else {
          tc::gemm(proj, ev, sW1e);
        }
        tc::store_rows(sProj, kWld, proj, r_base, 32);
      } else if (MODE != EDGE_BATCHED && B > 1 && ni_e == 1) {
        // B >= 4: the tile's 16 or fewer edges fill one fragment; each warp
        // takes 16 of the 64 output columns of the embedder's second layer
        // and of edge_val . W1e (the hidden layer and the LayerNorm run on
        // whole rows, in every warp)
        float ev[8][4], part[2][4];
        if (MODE == EDGE_RAW) {
          float* sZ = sStage + 32 * kWld;  // free: edge values use rows < 16
          fused_edge::embed_hidden<BF>(ev, p.edge, p.feat, t0, sm + L.ew1, sm + L.vec + 4 * D,
                                       0, ne);
          tc::zero(part);
          if constexpr (BF) {
            uint32_t a[4][4];
            tcb::pack_frag(a, ev);
            tcb::gemm_cols2(part, a, bEW2, 2 * warp);
          } else {
            tc::gemm_cols2(part, ev, sm + L.ew2, 2 * warp);
          }
          tc::store_cols2(sZ, kWld, part, 2 * warp);
          tc::group_sync(bar, kGroupThreads);
          tc::load_rows<false>(ev, sZ, kWld, 0, 16);
          tc::add_cols(ev, sm + L.vec + 5 * D);
          tc::layer_norm(ev, sm + L.vec + 6 * D, sm + L.vec + 7 * D, kLnEps);
        } else {
          edge_value<MODE, BF>(ev, p, sm, t0, 0, ne);
        }
        if (p.update_edges && warp == 0) tc::store_rows(sStage, kWld, ev, 0, kTileRows);
        tc::zero(part);
        if constexpr (BF) {
          uint32_t a[4][4];
          tcb::pack_frag(a, ev);
          tcb::gemm_cols2(part, a, bW1e, 2 * warp);
        } else {
          tc::gemm_cols2(part, ev, sW1e, 2 * warp);
        }
        tc::store_cols2(sProj, kWld, part, 2 * warp);
      }
      tc::group_sync(bar, kGroupThreads);

      // ---- the first layer's epilogue: biases, receiver projection, pre,
      // SiLU; the fragment is then the second layer's A operand ------------
      {
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          const int el = m / B, b = m - el * B;
          const int rl = m < nrows ? sRloc[el] : 0;
          const float* rp = sRP + (rl * B + b) * kWld + 2 * l.t;
          const float* pj = sProj + el * kWld + 2 * l.t;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const float2 r2 = *reinterpret_cast<const float2*>(rp + 8 * n);
            const float2 b2 = *reinterpret_cast<const float2*>(sB1 + 8 * n + 2 * l.t);
            acc[n][2 * h] += b2.x + r2.x;
            acc[n][2 * h + 1] += b2.y + r2.y;
            if (MODE != EDGE_BATCHED && B > 1) {
              const float2 q = *reinterpret_cast<const float2*>(pj + 8 * n);
              acc[n][2 * h] += q.x;
              acc[n][2 * h + 1] += q.y;
            }
          }
        }
      }
      if (p.pre != nullptr) {  // saved for the backward (K4)
        TP* pre = static_cast<TP*>(p.pre) + row0 * D;
        if (p.update_edges && MODE != EDGE_BATCHED) {
          // the tile of shared memory holds the edge values: direct stores
          tc::store_rows(pre, D, acc, r_base, nrows);
        } else {
          tc::store_rows(sStage, kWld, acc, r_base, kTileRows);
          tc::copy_out_rows(pre, sStage, r_base, nrows);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = silu(acc[n][j]);

      // ---- second layer, LayerNorm, residuals ------------------------------
      float msg[8][4];
      tc::zero(msg);
      if constexpr (BF) {
        uint32_t a[4][4];
        tcb::pack_frag(a, acc);
        tcb::gemm_wg(msg, a, bW2);
      } else {
        tc::gemm_wg<8>(msg, acc, sW2);
      }
      tc::add_cols(msg, sB2);
      if (p.layer_norm) tc::layer_norm(msg, sG, sBt, kLnEps);
      if (p.propagation) {
        float x[8][4];
        tc::load_rows<true>(x, p.send + row0 * D, D, r_base, nrows);
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) msg[n][j] += x[n][j];
      }
      if (p.update_edges) {
        const tc::Lane l;
        float base[8][4];
        if (MODE == EDGE_BATCHED) {
          tc::load_rows<true>(base, p.edge + row0 * D, D, r_base, nrows);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int el = (r_base + l.g + 8 * h) / B;
            const float* ev = sStage + el * kWld + 2 * l.t;
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              const float2 v = *reinterpret_cast<const float2*>(ev + 8 * n);
              base[n][2 * h] = v.x;
              base[n][2 * h + 1] = v.y;
            }
          }
        }
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) base[n][j] += msg[n][j];
        // every warp has read the edge values before the tile is reused
        if (MODE != EDGE_BATCHED && B > 1) tc::group_sync(bar, kGroupThreads);
        tc::store_rows(sStage, kWld, base, r_base, kTileRows);
        copy_out(p.new_edge, p.out_bf16, row0 * D, sStage, r_base, nrows);
      }

      // ---- the tile's messages into the chunk's sums, in edge order --------
      tc::store_rows(sStage, kWld, msg, r_base, kTileRows);
      tc::group_sync(bar, kGroupThreads);
#pragma unroll
      for (int j = 0; j < kAgg; ++j) {
        // (receiver, b) row q of the chunk and feature d of this thread
        const int q = (tg >> 6) + 2 * j, d = tg & (D - 1);
        if (q < nr * B) {
          const int rl = (q * inv_b) >> 16, b = q - rl * B;
          const int a = max(sRowptr[rl], t0), z = min(sRowptr[rl + 1], t0 + ne);
          float s = agg[j];
          for (int e = a; e < z; ++e) s += sStage[((e - t0) * B + b) * kWld + d];
          agg[j] = s;
        }
      }
      tc::group_sync(bar, kGroupThreads);  // the tile is done with gs
    }
#pragma unroll
    for (int j = 0; j < kAgg; ++j) {
      const int idx = tg + j * kGroupThreads;
      if (idx >= nr * BD) continue;
      const long long o = static_cast<long long>(r0) * BD + idx;
      if (p.out_bf16 && !p.aggr_f32)
        tc::store_val(static_cast<__nv_bfloat16*>(p.aggr) + o, agg[j]);
      else
        tc::store_val(static_cast<float*>(p.aggr) + o, agg[j]);
    }
  }
}

template <int MODE, bool BF, bool PRE_BF16, typename TI>
cudaError_t launch(const Params<TI>& p, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(fused_edge_fwd<MODE, BF, PRE_BF16, TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<MODE, BF>());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  constexpr int groups = groups_of(BF);
  const int groups_needed = (p.num_chunks + groups - 1) / groups;
  const int blocks = min(groups_needed, tc::sm_count());
  fused_edge_fwd<MODE, BF, PRE_BF16, TI>
      <<<blocks, block_threads(BF), smem_bytes<MODE, BF>(), stream>>>(p);
  return cudaGetLastError();
}

// the launch resources of one instantiation: out = blocks per SM, threads
// per block, registers per thread, shared memory per block, local memory
// per thread (bytes)
template <int MODE, bool BF, bool PRE_BF16, typename TI>
cudaError_t occupancy_of(int* out) {
  out[1] = block_threads(BF);
  out[3] = smem_bytes<MODE, BF>();
  return tcb::occupancy(fused_edge_fwd<MODE, BF, PRE_BF16, TI>, out[1], out[3], out,
                        out + 2, out + 4);
}

// occupancy_of for edge_mode, bf16_ops (then io_bf16) and pre_bf16
inline cudaError_t occupancy_mode(int bf16_ops, int io_bf16, int pre_bf16, int edge_mode, int* out) {
#define NL_OCC(M)                                                                           \
  (!bf16_ops ? (pre_bf16 ? occupancy_of<M, false, true, float>(out)                  \
                         : occupancy_of<M, false, false, float>(out))                \
   : io_bf16 ? (pre_bf16 ? occupancy_of<M, true, true, __nv_bfloat16>(out)           \
                         : occupancy_of<M, true, false, __nv_bfloat16>(out))         \
             : (pre_bf16 ? occupancy_of<M, true, true, float>(out)                   \
                         : occupancy_of<M, true, false, float>(out)))
  switch (edge_mode) {
    case EDGE_RAW: return NL_OCC(EDGE_RAW);
    case EDGE_SHARED: return NL_OCC(EDGE_SHARED);
    case EDGE_BATCHED: return NL_OCC(EDGE_BATCHED);
    default: return cudaErrorInvalidValue;
  }
#undef NL_OCC
}

// the instantiation for edge_mode and the type of pre
template <int MODE, bool BF, typename TI>
cudaError_t launch_pre(const Params<TI>& p, int pre_bf16, cudaStream_t s) {
  return pre_bf16 ? launch<MODE, BF, true, TI>(p, s) : launch<MODE, BF, false, TI>(p, s);
}

// Fill the parameters and launch the instantiation for edge_mode; out_bf16
// bit 0 writes new_edge (and aggr) in bf16, bit 1 aggr in float32 all the
// same (the node-MLP route's)
template <bool BF, typename TI>
cudaError_t run(int pre_bf16, int edge_mode, int num_rec, int batch, int feat, int update_edges,
                int propagation, int layer_norm, int out_bf16, const void* edge,
                const void* send, const void* rec, const void* rowptr, const void* w1,
                const void* b1, const void* w2, const void* b2, const void* gamma,
                const void* beta, const void* ew1, const void* eb1, const void* ew2,
                const void* eb2, const void* eg, const void* ebt, void* aggr, void* new_edge,
                void* pre, void* counter, void* stream) {
  if (num_rec <= 0) return cudaSuccess;
  if (batch < 1 || batch > kRecRows || feat > kMaxFeat) return cudaErrorInvalidValue;
  Params<TI> p;
  p.edge = static_cast<const TI*>(edge);
  p.send = static_cast<const TI*>(send);
  p.rec = static_cast<const TI*>(rec);
  p.rowptr = static_cast<const int*>(rowptr);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.ew1 = static_cast<const float*>(ew1);
  p.eb1 = static_cast<const float*>(eb1);
  p.ew2 = static_cast<const float*>(ew2);
  p.eb2 = static_cast<const float*>(eb2);
  p.eg = static_cast<const float*>(eg);
  p.ebt = static_cast<const float*>(ebt);
  p.aggr = aggr;
  p.new_edge = new_edge;
  p.pre = pre;
  p.counter = static_cast<int*>(counter);
  p.out_bf16 = out_bf16 & 1;
  p.aggr_f32 = (out_bf16 >> 1) & 1;
  p.num_rec = num_rec;
  p.batch = batch;
  p.feat = feat;
  p.recv_per_chunk = kRecRows / batch;
  p.num_chunks = (num_rec + p.recv_per_chunk - 1) / p.recv_per_chunk;
  p.edges_per_tile = kTileRows / batch;
  p.update_edges = update_edges;
  p.propagation = propagation;
  p.layer_norm = layer_norm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (edge_mode) {
    case EDGE_RAW: return launch_pre<EDGE_RAW, BF, TI>(p, pre_bf16, s);
    case EDGE_SHARED: return launch_pre<EDGE_SHARED, BF, TI>(p, pre_bf16, s);
    case EDGE_BATCHED: return launch_pre<EDGE_BATCHED, BF, TI>(p, pre_bf16, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
