// K7: the v2 fused edge-phase forward of one InteractionNet step, with the
// sender gather merged into the kernel.
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_v2_fwd_impl (the
// _fused_v2_fwd_kernel + _embed_forward pallas_call), which the JAX package
// builds through make_fused_interaction_v2. The first layer's sender and
// receiver products are formed outside the kernel, once per node:
// sp = send_rep . W1s and rp = rec_rep . W1r. For every edge e (sender s,
// receiver r) and batch member b:
//
//   edge_val = LN(We2 . SiLU(We1 . f[e] + be1) + be2)   (EDGE_RAW: in-kernel
//              embedder on the raw static features, shared across the batch)
//            | edge[e]                                   (EDGE_SHARED)
//            | edge[e, b]                                (EDGE_BATCHED)
//   pre      = edge_val . W1e + sp[s, b] + rp[r, b] + b1
//              (written out as pre[e, b] when the caller will differentiate:
//              the backward kernel, fused_edge_v2_bwd.cu, starts from it)
//   msg      = LN(SiLU(pre) . W2 + b2)         (LN optional: layer_norm)
//   new_edge[e, b] = edge_val + msg            (update_edges only)
//   aggr[r, b]     = sum of msg over the edges into r (receivers without
//                    edges get 0)
//
// There is no propagation variant: a PropagationNet needs the raw sender
// rows for its residual and stays on K1 + K3, as in the JAX package.
//
// Design. The TPU kernel walks a visit-major grid over banded sender
// windows and gathers the sender projections with one-hot matmuls, because
// Mosaic has no dynamic row gather. Hopper has indexed loads. The layout is
// K3's (fused_edge.cu), on the tensor cores with the 3xTF32 split
// (tc_tf32.cuh) at float32 accuracy:
//   * A block of 12 warps holds the weights once and runs three independent
//     groups of 4 warps (one warpgroup each). A group takes chunks of R =
//     16/B consecutive receivers (one at B > 16; K3 takes 32/B) from a
//     work counter (an integer atomic; a chunk's result does not depend on
//     which group computes it) and walks their contiguous range of the
//     receiver-sorted CSR in tiles of 64 (edge, b) rows, TE = 64/B edges;
//     a warp owns 16 rows by all 64 features, so the first layer's
//     epilogue, SiLU, the second layer and the LayerNorm chain in
//     registers.
//   * The row products are wgmma m64n64k8: SiLU(pre) . W2, and edge . W1e
//     for a batched edge input. The per-edge products (the embedder, and
//     edge_val . W1e for a shared or raw edge input) run once per edge on
//     mma.sync, shared by the batch: at B >= 4 the group's four warps each
//     take 16 output columns of the tile's edges, at B = 2, 3 warps 0 and 1
//     take 16 edges each, at B = 1 each warp its own rows.
//   * No sender tile and no W1s exist. The first layer's accumulator holds
//     its 64 columns in layout Q (tc_tf32.cuh: four consecutive columns a
//     lane), so each (edge, b) row's sender term sp[sender[e], b] is loaded
//     by index straight into the accumulator, four 16-byte loads a lane,
//     before the edge product accumulates on top of it; the sender index
//     comes from device memory (one 4-byte load a row, shared by the quad),
//     so the gather starts at the top of the tile, beside the edge rows'
//     loads, and the other two groups of the SM cover its latency. W1e's
//     output rows and W2's inputs are placed for layout Q once per block,
//     and pre goes out as 16-byte stores from the same fragment.
//   * rp[r, b] is read once per (receiver, b) of a chunk into shared
//     memory (K3 computed rec . W1r there).
//   * Messages go through a shared tile once: the group's threads own the
//     chunk's (receiver, b, feature) sums in registers and add the tile's
//     messages in edge order, so the sum is deterministic and needs no
//     atomics; each aggregate row is written once, at the chunk's end.
//
// Bound on the H100: what is left per (edge, b) row is the second layer
// (and, batched, edge . W1e), at 3xTF32 on the tensor cores (495 TFLOP/s
// of TF32 over three), beside the row's sp gather, edge rows, pre and
// outputs at 3.35 TB/s. At MEPS size the two are close: the raw-feature
// sites (g2m, m2g, with the embedder per edge) are bound by operations,
// the m2m layers by bytes. At g2m sp is 65 MB of grid-sender rows, above
// the 50 MB L2, and each row is read about 1.6 times (once per edge out of
// its node, in receiver order); at m2m and m2g sp is 6.7 MB of mesh rows
// and stays in L2.
//
// Reduced precision (the JAX kernel's cdt = bf16 and io_dt,
// make_fused_interaction_v2, pallas_fused.py:2518-2525): the instantiations
// with BF multiply bf16 operands (every product's two operands rounded to
// bf16, float32 accumulation), with SiLU, LayerNorm, the residual, the
// receiver sums and pre in float32. They run K3's BF design (fused_edge_fwd
// .cuh) on Hopper's bf16 tensor cores (tc_bf16.cuh, fwd_bf below):
//   * The row products (SiLU(pre) . W2, and edge . W1e for a batched edge
//     input) are wgmma m64n64k16 on packed bf16 fragments, the per-edge
//     products (the embedder's second layer, edge_val . W1e) mma.sync
//     m16n8k16; every weight is one bf16 copy in shared memory in the core
//     layout (8 KB where the split float32 one takes 32).
//   * The sender term: the first layer's accumulator holds its columns in
//     k-slot order (lane t: columns 16 t .. 16 t + 15 of its two rows, the
//     order in which load_rows_k reads a row), so sp[sender[e], b] loads by
//     index straight into it, as two (bf16) or four (float32) 16-byte loads
//     a lane at the top of the tile, and pre leaves as four 16-byte stores.
//     W1e's output rows, b1 and the staged rp rows are placed in that order
//     once, and W2 takes its inputs in it (a sum over k does not depend on
//     the order of the slots), so the messages and everything after them
//     are in natural column order.
//   * The shared memory this frees (130-178 KB a block) leaves room for
//     four groups a block at up to 128 registers a thread, as K3's BF
//     instantiations: 16 warps per SM, each group chained as above. Three
//     groups ran 14 % slower per AR step on an H100; chunks of 32 rows 4 %
//     slower, and taking a group's next chunk one chunk ahead 15 % slower.
// The streams edge, sp and rp are of type TI: bf16 under mixed precision
// and NEURAL_LAM_TPU_MATMUL_PRECISION=high, float32 under high-kernels;
// aggr and new_edge are written in float32 or, with out_bf16 (bf16
// inputs), rounded to bf16 on the way out, as the JAX wrapper casts the
// float32 outputs to the input dtype (:2730-2740). The TPU kernel's one-hot
// selections also round sp, rp and each message to bf16 before they are
// gathered and summed; here the gathers and the sums are exact. Bound:
// bytes at the stream dtype, or the products at the dense bf16 rate (989
// TFLOP/s).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

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
constexpr int kGroups = 3;               // K3's: 12 warps per SM, up to 168 registers
// and of the BF instantiations, as K3's: their bf16 weights take a quarter
// of the float32 ones' shared memory and their products half the registers
constexpr int kGroupsBf = 4;
constexpr int kBlockThreads = kGroups * kGroupThreads;  // the float32 instantiations'

__host__ __device__ constexpr int groups_of(bool bf) { return bf ? kGroupsBf : kGroups; }
__host__ __device__ constexpr int block_threads(bool bf) {
  return groups_of(bf) * kGroupThreads;
}
// (receiver, b) rows a chunk takes at B <= 16 (a larger B takes one
// receiver): half of K3's 32, so that the 821 chunks of a MEPS mesh set
// become 1,641 and the last wave of the 396 groups idles less; 4-14 %
// faster at g2m and m2m on an H100, the same at m2g
constexpr int kChunkRows = 16;

template <typename TI>
struct Params {
  const TI* edge;
  const TI* sp;
  const TI* rp;
  const int* rowptr;
  const int* senders;
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
  void* aggr;      // float, or bf16 with out_bf16
  void* new_edge;  // as aggr
  float* pre;
  int* counter;  // zero on entry: the next chunk to take
  int out_bf16;
  int num_rec;
  int num_chunks;
  int batch;
  int feat;
  int recv_per_chunk;
  int edges_per_tile;
  int update_edges;
  int layer_norm;
};

// Shared-memory plan, in floats: the block's weights (W2, and W1e of a
// batched edge input, split for wgmma; W1e of a per-edge input and the
// embedder's We2 for mma.sync; with bf, each one bf16 copy in the core
// layout) and vectors, then per group a tile of 64 rows (messages; edge
// values before them), the per-edge products of a tile (32 rows), the
// chunk's rp rows (32) and its integers.
struct Smem {
  int w2, w1e, ew2, ew1, vec, groups, group_floats, total;
  int stage, proj, rp, ints;  // offsets inside a group
};

__host__ __device__ constexpr Smem smem_plan(int mode, bool bf = false) {
  Smem s{};
  int o = 0;
  s.w2 = o; o += bf ? kBfMat : kWgMat;
  s.w1e = o; o += bf ? kBfMat : (mode == EDGE_BATCHED) ? kWgMat : kMat;
  s.ew2 = o; o += (mode == EDGE_RAW) ? (bf ? kBfMat : kMat) : 0;
  s.ew1 = o; o += (mode == EDGE_RAW) ? kMaxFeat * D : 0;
  s.vec = o; o += 8 * D;  // b1 b2 gamma beta | eb1 eb2 eg ebt
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

// rows r0 .. of the staged tile out to dst (float or bf16 by out_bf16)
__device__ __forceinline__ void copy_out(void* dst, int out_bf16, long long offset,
                                         const float* stage, int r0, int valid) {
  if (out_bf16)
    tc::copy_out_rows(static_cast<__nv_bfloat16*>(dst) + offset, stage, r0, valid);
  else
    tc::copy_out_rows(static_cast<float*>(dst) + offset, stage, r0, valid);
}

// The BF instantiations' body, on Hopper's bf16 tensor cores (tc_bf16.cuh):
// K7's function with every product's operands in bf16, each weight one
// bf16 copy in the core layout. The first layer's accumulator holds its
// columns in k-slot order (lane t: columns 16 t .. 16 t + 15 of its two
// rows), so that sp[sender] loads straight into it as 16-byte loads and pre
// leaves as 16-byte stores; W1e's outputs, b1, the staged rp rows and W2's
// inputs are placed in the same order once, and the second layer's output
// (and everything after it) is in natural order.
template <int MODE, typename TI>
__device__ __forceinline__ void fwd_bf(const Params<TI>& p) {
  using tcb::bf16;
  constexpr int kThreads = block_threads(true);
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr Smem L = smem_plan(MODE, true);
  bf16* wb = reinterpret_cast<bf16*>(sm);
  const bf16* bW2 = wb + 2 * L.w2;
  const bf16* bW1e = wb + 2 * L.w1e;
  const bf16* bEW2 = wb + 2 * L.ew2;
  const float* sB1 = sm + L.vec;  // k-slot order
  const float* sB2 = sB1 + D;
  const float* sG = sB2 + D;
  const float* sBt = sG + D;
  const float* sEV = sm + L.vec + 4 * D;  // eb1 eb2 eg ebt

  // ---- the block's weights and vectors ------------------------------------
  // W2's inputs and W1e's outputs in k-slot order; a batched W1e meets rows
  // read by load_rows_k, so its inputs too
  tcb::load_weight<true>(wb + 2 * L.w2, p.w2, D, 0, kThreads);
  tcb::load_weight<MODE == EDGE_BATCHED, true>(wb + 2 * L.w1e, p.w1, 3 * D, 0, kThreads);
  if (MODE == EDGE_RAW) {
    tcb::load_weight<false>(wb + 2 * L.ew2, p.ew2, D, 0, kThreads);
    for (int i = threadIdx.x; i < p.feat * D; i += kThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      sm[L.ew1 + i] = tc::bf16r(__ldg(p.ew1 + c * p.feat + k));  // the SIMT layer's operand
    }
  }
  tcb::fence_async();
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L.vec;
    v[tcb::k_slot(c)] = p.b1[c];
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
  float* sProj = gs + L.proj;  // k-slot order
  float* sRP = gs + L.rp;      // k-slot order
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
    {  // the chunk's rp rows, once per (receiver, b), in k-slot order
      const TI* src = p.rp + static_cast<long long>(r0) * BD;
      for (int i = tg; i < nr * B * (D / 4); i += kGroupThreads) {
        const float4 v = fused_edge::ldg4(src + 4 * i);
        float* row = sRP + (i >> 4) * kWld + tcb::k_slot(4 * (i & 15));
        *reinterpret_cast<float2*>(row) = make_float2(v.x, v.y);
        *reinterpret_cast<float2*>(row + 8) = make_float2(v.z, v.w);
      }
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

      // ---- first layer: sp[sender] into the accumulator (k-slot order),
      // then the row product of a batched edge input on top of it ----------
      float acc[8][4];
      uint32_t a[4][4];
      {
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          if (m < nrows) {
            const int el = (m * inv_b) >> 16, b = m - el * B;
            const int s = __ldg(p.senders + t0 + el);
            tcb::load_row_k(acc, h, p.sp + (static_cast<long long>(s) * B + b) * D);
          } else {
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[n][2 * h] = acc[n][2 * h + 1] = 0.0f;
          }
        }
      }
      if (MODE == EDGE_BATCHED) {
        tcb::load_rows_k(a, p.edge + row0 * D, r_base, nrows);
        tcb::gemm_wg(acc, a, bW1e);
      } else if (B == 1) {
        // edge and row coincide: edge_val . W1e for the warp's own rows
        float x[8][4];
        fused_edge::edge_value_bf<MODE>(x, p.edge, p.feat, t0, sm + L.ew1, bEW2, sEV, r_base,
                                        ne);
        if (p.update_edges) tc::store_rows(sStage, kWld, x, r_base, kTileRows);
        tcb::pack_frag(a, x);
        tcb::gemm(acc, a, bW1e);
      }
      // ---- per-edge products, shared by the batch (B > 1) ------------------
      if (MODE != EDGE_BATCHED && B > 1 && ni_e > 1 && warp < ni_e) {
        // B = 2, 3: 32 edge rows, warps 0 and 1 take 16 each
        float ev[8][4], proj[8][4];
        fused_edge::edge_value_bf<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, bEW2, sEV, r_base,
                                        ne);
        if (p.update_edges) tc::store_rows(sStage, kWld, ev, r_base, kTileRows);
        tc::zero(proj);
        tcb::pack_frag(a, ev);
        tcb::gemm(proj, a, bW1e);
        tc::store_rows(sProj, kWld, proj, r_base, 32);
      } else if (MODE != EDGE_BATCHED && B > 1 && ni_e == 1) {
        // B >= 4: the tile's 16 or fewer edges fill one fragment; each warp
        // takes 16 of the 64 output columns of the embedder's second layer
        // and of edge_val . W1e (the hidden layer and the LayerNorm run on
        // whole rows, in every warp)
        float ev[8][4], part[2][4];
        if (MODE == EDGE_RAW) {
          float* sZ = sStage + 32 * kWld;  // free: edge values use rows < 16
          fused_edge::embed_hidden<true>(ev, p.edge, p.feat, t0, sm + L.ew1, sEV, 0, ne);
          tc::zero(part);
          tcb::pack_frag(a, ev);
          tcb::gemm_cols2(part, a, bEW2, 2 * warp);
          tc::store_cols2(sZ, kWld, part, 2 * warp);
          tc::group_sync(bar, kGroupThreads);
          tc::load_rows<false>(ev, sZ, kWld, 0, 16);
          tc::add_cols(ev, sEV + D);
          tc::layer_norm(ev, sEV + 2 * D, sEV + 3 * D, kLnEps);
        } else {
          fused_edge::edge_value_bf<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, bEW2, sEV, 0,
                                          ne);
        }
        if (p.update_edges && warp == 0) tc::store_rows(sStage, kWld, ev, 0, kTileRows);
        tc::zero(part);
        tcb::pack_frag(a, ev);
        tcb::gemm_cols2(part, a, bW1e, 2 * warp);
        tc::store_cols2(sProj, kWld, part, 2 * warp);
      }
      tc::group_sync(bar, kGroupThreads);

      // ---- the first layer's epilogue (k-slot order): b1, rp, the per-edge
      // product; pre out; SiLU. The fragment is the second layer's A --------
      {
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          const int el = (m * inv_b) >> 16, b = m - el * B;
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
          if (p.pre != nullptr && m < nrows)  // saved for the backward (K8)
            tcb::store_row_k(p.pre + (row0 + m) * D, acc, h);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = silu(acc[n][j]);

      // ---- second layer, LayerNorm, edge residual ----------------------------
      float msg[8][4];
      tc::zero(msg);
      tcb::pack_frag(a, acc);
      tcb::gemm_wg(msg, a, bW2);
      tc::add_cols(msg, sB2);
      if (p.layer_norm) tc::layer_norm(msg, sG, sBt, kLnEps);
      if (p.update_edges) {
        const tc::Lane l;
        float base[8][4];
        if (MODE == EDGE_BATCHED) {
          tc::load_rows<true>(base, p.edge + row0 * D, D, r_base, nrows);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int el = ((r_base + l.g + 8 * h) * inv_b) >> 16;
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
          const int ea = max(sRowptr[rl], t0), ez = min(sRowptr[rl + 1], t0 + ne);
          float s = agg[j];
          for (int e = ea; e < ez; ++e) s += sStage[((e - t0) * B + b) * kWld + d];
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
      if (p.out_bf16)
        tc::store_val(static_cast<__nv_bfloat16*>(p.aggr) + o, agg[j]);
      else
        tc::store_val(static_cast<float*>(p.aggr) + o, agg[j]);
    }
  }
}

// The float32 instantiations' body (3xTF32, tc_tf32.cuh)
template <int MODE, typename TI>
__device__ __forceinline__ void fwd_f32(const Params<TI>& p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr Smem L = smem_plan(MODE);
  const float* sW1e = sm + L.w1e;
  const float* sW2 = sm + L.w2;
  const float* sB1 = sm + L.vec;
  const float* sB2 = sB1 + D;
  const float* sG = sB2 + D;
  const float* sBt = sG + D;

  // ---- the block's weights and vectors: W1e's outputs and W2's inputs
  // placed for the first layer's layout Q ------------------------------------
  tc::load_weight_wg<false, false, true>(sm + L.w2, p.w2, D, 0, kBlockThreads);
  if (MODE == EDGE_BATCHED)
    tc::load_weight_wg<false, true, false>(sm + L.w1e, p.w1, 3 * D, 0, kBlockThreads);
  else
    tc::load_weight_rows<true>(sm + L.w1e, p.w1, 3 * D, 0, kBlockThreads);
  if (MODE == EDGE_RAW) {
    tc::load_weight_rows(sm + L.ew2, p.ew2, D, 0, kBlockThreads);
    for (int i = threadIdx.x; i < p.feat * D; i += kBlockThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      const float w = __ldg(p.ew1 + c * p.feat + k);
      sm[L.ew1 + i] = w;  // the SIMT layer's operand
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
  const float* sEV = sm + L.vec + 4 * D;  // eb1 eb2 eg ebt

  for (;;) {
    if (tg == 0) *sChunk = atomicAdd(p.counter, 1);
    tc::group_sync(bar, kGroupThreads);  // also: the last chunk is done with gs
    const int chunk = *sChunk;
    if (chunk >= p.num_chunks) break;
    const int r0 = chunk * R;
    const int nr = min(R, p.num_rec - r0);
    if (tg <= nr) sRowptr[tg] = p.rowptr[r0 + tg];
    {  // the chunk's rp rows, once per (receiver, b)
      const TI* src = p.rp + static_cast<long long>(r0) * BD;
      for (int i = tg; i < nr * B * (D / 4); i += kGroupThreads)
        *reinterpret_cast<float4*>(sRP + (i >> 4) * kWld + 4 * (i & 15)) =
            fused_edge::ldg4(src + 4 * i);
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

      // ---- first layer: sp[sender] into the accumulator (layout Q), then
      // the row product of a batched edge input on top of it -------------
      float acc[8][4];
      {
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          if (m < nrows) {
            const int el = (m * inv_b) >> 16, b = m - el * B;
            const int s = __ldg(p.senders + t0 + el);
            tc::load_row_q(acc, h, p.sp + (static_cast<long long>(s) * B + b) * D);
          } else {
#pragma unroll
            for (int n = 0; n < 8; ++n) acc[n][2 * h] = acc[n][2 * h + 1] = 0.0f;
          }
        }
      }
      if (MODE == EDGE_BATCHED) {
        float x[8][4];
        tc::load_rows<true>(x, p.edge + row0 * D, D, r_base, nrows);
        tc::gemm_wg<8>(acc, x, sW1e);
      } else if (B == 1) {
        // edge and row coincide: edge_val . W1e for the warp's own rows
        float x[8][4];
        fused_edge::edge_value<MODE>(x, p.edge, p.feat, t0, sm + L.ew1, sm + L.ew2, sEV,
                                         r_base, ne);
        if (p.update_edges) tc::store_rows(sStage, kWld, x, r_base, kTileRows);
        tc::gemm(acc, x, sW1e);
      }
      // ---- per-edge products, shared by the batch (B > 1) ------------------
      if (MODE != EDGE_BATCHED && B > 1 && ni_e > 1 && warp < ni_e) {
        // B = 2, 3: 32 edge rows, warps 0 and 1 take 16 each
        float ev[8][4], proj[8][4];
        fused_edge::edge_value<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, sm + L.ew2, sEV,
                                         r_base, ne);
        if (p.update_edges) tc::store_rows(sStage, kWld, ev, r_base, kTileRows);
        tc::zero(proj);
        tc::gemm(proj, ev, sW1e);
        tc::store_rows(sProj, kWld, proj, r_base, 32);
      } else if (MODE != EDGE_BATCHED && B > 1 && ni_e == 1) {
        // B >= 4: the tile's 16 or fewer edges fill one fragment; each warp
        // takes 16 of the 64 output columns of the embedder's second layer
        // and of edge_val . W1e (the hidden layer and the LayerNorm run on
        // whole rows, in every warp)
        float ev[8][4], part[2][4];
        if (MODE == EDGE_RAW) {
          float* sZ = sStage + 32 * kWld;  // free: edge values use rows < 16
          fused_edge::embed_hidden(ev, p.edge, p.feat, t0, sm + L.ew1, sEV, 0, ne);
          tc::zero(part);
          tc::gemm_cols2(part, ev, sm + L.ew2, 2 * warp);
          tc::store_cols2(sZ, kWld, part, 2 * warp);
          tc::group_sync(bar, kGroupThreads);
          tc::load_rows<false>(ev, sZ, kWld, 0, 16);
          tc::add_cols(ev, sEV + D);
          tc::layer_norm(ev, sEV + 2 * D, sEV + 3 * D, kLnEps);
        } else {
          fused_edge::edge_value<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, sm + L.ew2,
                                           sEV, 0, ne);
        }
        if (p.update_edges && warp == 0) tc::store_rows(sStage, kWld, ev, 0, kTileRows);
        tc::zero(part);
        tc::gemm_cols2(part, ev, sW1e, 2 * warp);
        tc::store_cols2(sProj, kWld, part, 2 * warp);
      }
      tc::group_sync(bar, kGroupThreads);

      // ---- the first layer's epilogue (layout Q): b1, rp, the per-edge
      // product; pre out; SiLU. The fragment is the second layer's A --------
      {
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          const int el = (m * inv_b) >> 16, b = m - el * B;
          const int rl = m < nrows ? sRloc[el] : 0;
          const float* rp = sRP + (rl * B + b) * kWld;
          const float* pj = sProj + el * kWld + 2 * l.t;  // slot order: layout Q
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = tc::q_col(n, l.t);
            const float2 r2 = *reinterpret_cast<const float2*>(rp + c);
            const float2 b2 = *reinterpret_cast<const float2*>(sB1 + c);
            acc[n][2 * h] += b2.x + r2.x;
            acc[n][2 * h + 1] += b2.y + r2.y;
            if (MODE != EDGE_BATCHED && B > 1) {
              const float2 q = *reinterpret_cast<const float2*>(pj + 8 * n);
              acc[n][2 * h] += q.x;
              acc[n][2 * h + 1] += q.y;
            }
          }
          if (p.pre != nullptr && m < nrows)  // saved for the backward (K8)
            tc::store_row_q(p.pre + (row0 + m) * D, acc, h);
        }
      }
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[n][j] = silu(acc[n][j]);

      // ---- second layer, LayerNorm, edge residual ----------------------------
      float msg[8][4];
      tc::zero(msg);
      tc::gemm_wg<8>(msg, acc, sW2);
      tc::add_cols(msg, sB2);
      if (p.layer_norm) tc::layer_norm(msg, sG, sBt, kLnEps);
      if (p.update_edges) {
        const tc::Lane l;
        float base[8][4];
        if (MODE == EDGE_BATCHED) {
          tc::load_rows<true>(base, p.edge + row0 * D, D, r_base, nrows);
        } else {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int el = ((r_base + l.g + 8 * h) * inv_b) >> 16;
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
      if (p.out_bf16)
        tc::store_val(static_cast<__nv_bfloat16*>(p.aggr) + o, agg[j]);
      else
        tc::store_val(static_cast<float*>(p.aggr) + o, agg[j]);
    }
  }
}

// BF: bf16 operands (bf16 fragments, fwd_bf); TI: the stream type (float
// or bf16)
template <int MODE, bool BF, typename TI>
__global__ void __launch_bounds__(block_threads(BF), 1)
fused_edge_v2_fwd(const Params<TI> p) {
  if constexpr (BF)
    fwd_bf<MODE>(p);
  else
    fwd_f32<MODE>(p);
}

template <int MODE, bool BF, typename TI>
cudaError_t launch(const Params<TI>& p, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(fused_edge_v2_fwd<MODE, BF, TI>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<MODE, BF>());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  constexpr int groups = groups_of(BF);
  const int groups_needed = (p.num_chunks + groups - 1) / groups;
  const int blocks = min(groups_needed, tc::sm_count());
  fused_edge_v2_fwd<MODE, BF, TI>
      <<<blocks, block_threads(BF), smem_bytes<MODE, BF>(), stream>>>(p);
  return cudaGetLastError();
}

// the launch resources of one instantiation: out = blocks per SM, threads
// per block, registers per thread, shared memory per block, local memory
// per thread (bytes)
template <int MODE, bool BF, typename TI>
cudaError_t occupancy_of(int* out) {
  out[1] = block_threads(BF);
  out[3] = smem_bytes<MODE, BF>();
  return tcb::occupancy(fused_edge_v2_fwd<MODE, BF, TI>, out[1], out[3], out, out + 2,
                        out + 4);
}

// occupancy_of for edge_mode, bf16_ops and (then) io_bf16
template <int MODE>
cudaError_t occupancy_mode(int bf16_ops, int io_bf16, int* out) {
  if (!bf16_ops) return occupancy_of<MODE, false, float>(out);
  return io_bf16 ? occupancy_of<MODE, true, __nv_bfloat16>(out)
                 : occupancy_of<MODE, true, float>(out);
}

// Fill the parameters and launch the instantiation for edge_mode
template <bool BF, typename TI>
cudaError_t run(int edge_mode, int num_rec, int batch, int feat, int update_edges,
                int layer_norm, int out_bf16, const void* edge, const void* sp,
                const void* rp, const void* rowptr, const void* senders, const void* w1,
                const void* b1, const void* w2, const void* b2, const void* gamma,
                const void* beta, const void* ew1, const void* eb1, const void* ew2,
                const void* eb2, const void* eg, const void* ebt, void* aggr, void* new_edge,
                void* pre, void* counter, void* stream) {
  if (num_rec <= 0) return cudaSuccess;
  if (batch < 1 || batch > kRecRows || feat > kMaxFeat) return cudaErrorInvalidValue;
  Params<TI> p;
  p.edge = static_cast<const TI*>(edge);
  p.sp = static_cast<const TI*>(sp);
  p.rp = static_cast<const TI*>(rp);
  p.rowptr = static_cast<const int*>(rowptr);
  p.senders = static_cast<const int*>(senders);
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
  p.pre = static_cast<float*>(pre);
  p.counter = static_cast<int*>(counter);
  p.out_bf16 = out_bf16;
  p.num_rec = num_rec;
  p.batch = batch;
  p.feat = feat;
  p.recv_per_chunk = batch <= kChunkRows ? kChunkRows / batch : 1;
  p.num_chunks = (num_rec + p.recv_per_chunk - 1) / p.recv_per_chunk;
  p.edges_per_tile = kTileRows / batch;
  p.update_edges = update_edges;
  p.layer_norm = layer_norm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (edge_mode) {
    case EDGE_RAW: return launch<EDGE_RAW, BF, TI>(p, s);
    case EDGE_SHARED: return launch<EDGE_SHARED, BF, TI>(p, s);
    case EDGE_BATCHED: return launch<EDGE_BATCHED, BF, TI>(p, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// The launch resources of one instantiation: bf16_ops (then io_bf16, the
// stream type) and edge_mode pick it; out = blocks per SM, threads per
// block, registers per thread, dynamic shared memory per block and local
// memory per thread (bytes).
extern "C" int nl_fused_edge_v2_fwd_occupancy(int bf16_ops, int io_bf16, int edge_mode,
                                              int* out) {
  switch (edge_mode) {
    case EDGE_RAW: return static_cast<int>(occupancy_mode<EDGE_RAW>(bf16_ops, io_bf16, out));
    case EDGE_SHARED:
      return static_cast<int>(occupancy_mode<EDGE_SHARED>(bf16_ops, io_bf16, out));
    case EDGE_BATCHED:
      return static_cast<int>(occupancy_mode<EDGE_BATCHED>(bf16_ops, io_bf16, out));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   sp: (N_send, B, D) sender projections, N_send > every sender index
//   rp: (num_rec, B, D) receiver projections
//   rowptr: (num_rec + 1,) int32; senders: (E,) int32, receiver-sorted order
//   w1: (D, 3D) (only its W1e slice, columns 0..D-1, is read), b1: (D,),
//   w2: (D, D), b2, gamma, beta: (D,)
//   ew1: (D, feat), eb1, eb2, eg, ebt: (D,), ew2: (D, D)   [edge_mode 0]
//   aggr: (num_rec, B, D) out; new_edge: (E, B, D) out [update_edges];
//   pre: (E, B, D) out, the first layer's pre-activation, or null
//   counter: one int32, zero on entry (the work counter; left nonzero)
// 1 <= batch <= 32 and feat <= 8 are checked by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int nl_fused_edge_v2_fwd(
    int edge_mode, int num_rec, int batch, int feat, int update_edges,
    int layer_norm, const void* edge, const void* sp, const void* rp,
    const void* rowptr, const void* senders, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* aggr, void* new_edge, void* pre,
    void* counter, void* stream) {
  return static_cast<int>(run<false, float>(
      edge_mode, num_rec, batch, feat, update_edges, layer_norm, 0, edge, sp, rp, rowptr,
      senders, w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt, aggr, new_edge, pre,
      counter, stream));
}

// The bf16-operand instantiations: the arguments of nl_fused_edge_v2_fwd, the
// streams edge, sp and rp in bf16 (io_bf16) or float32, and aggr and
// new_edge written in bf16 (out_bf16) or float32; pre stays float32. The
// weights stay float32 arrays; the kernel rounds the matrices to bf16 as it
// stages them.
extern "C" int nl_fused_edge_v2_fwd_bf16ops(
    int io_bf16, int out_bf16, int edge_mode, int num_rec, int batch, int feat,
    int update_edges, int layer_norm, const void* edge, const void* sp, const void* rp,
    const void* rowptr, const void* senders, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* aggr, void* new_edge, void* pre,
    void* counter, void* stream) {
  auto go = io_bf16 ? &run<true, __nv_bfloat16> : &run<true, float>;
  return static_cast<int>(go(
      edge_mode, num_rec, batch, feat, update_edges, layer_norm, out_bf16, edge, sp, rp,
      rowptr, senders, w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt, aggr,
      new_edge, pre, counter, stream));
}
