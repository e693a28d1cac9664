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
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_common.cuh"
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
constexpr int kGroups = 3;               // K3's: 12 warps per SM, up to 168 registers
constexpr int kBlockThreads = kGroups * kGroupThreads;
// (receiver, b) rows a chunk takes at B <= 16 (a larger B takes one
// receiver): half of K3's 32, so that the 821 chunks of a MEPS mesh set
// become 1,641 and the last wave of the 396 groups idles less; 4-14 %
// faster at g2m and m2m on an H100, the same at m2g
constexpr int kChunkRows = 16;

struct Params {
  const float* edge;
  const float* sp;
  const float* rp;
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
  float* aggr;
  float* new_edge;
  float* pre;
  int* counter;  // zero on entry: the next chunk to take
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
// embedder's We2 for mma.sync) and vectors, then per group a tile of 64
// rows (messages; edge values before them), the per-edge products of a
// tile (32 rows), the chunk's rp rows (32) and its integers.
struct Smem {
  int w2, w1e, ew2, ew1, vec, groups, group_floats, total;
  int stage, proj, rp, ints;  // offsets inside a group
};

__host__ __device__ constexpr Smem smem_plan(int mode) {
  Smem s{};
  int o = 0;
  s.w2 = o; o += kWgMat;
  s.w1e = o; o += (mode == EDGE_BATCHED) ? kWgMat : kMat;
  s.ew2 = o; o += (mode == EDGE_RAW) ? kMat : 0;
  s.ew1 = o; o += (mode == EDGE_RAW) ? kMaxFeat * D : 0;
  s.vec = o; o += 8 * D;  // b1 b2 gamma beta | eb1 eb2 eg ebt
  s.groups = o;
  int g = 0;
  s.stage = g; g += kTileRows * kWld;
  s.proj = g; g += (mode == EDGE_BATCHED) ? 0 : 32 * kWld;
  s.rp = g; g += kRecRows * kWld;
  s.ints = g; g += 100;  // rowptr (<= 33), chunk index, receiver of each tile edge (64)
  s.group_floats = g;
  s.total = o + kGroups * g;
  return s;
}

template <int MODE>
constexpr int smem_bytes() {
  return smem_plan(MODE).total * static_cast<int>(sizeof(float));
}

template <int MODE>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_edge_v2_fwd(const Params p) {
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
      sm[L.ew1 + i] = __ldg(p.ew1 + c * p.feat + k);
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
      const float4* src = reinterpret_cast<const float4*>(p.rp + static_cast<long long>(r0) * BD);
      for (int i = tg; i < nr * B * (D / 4); i += kGroupThreads)
        *reinterpret_cast<float4*>(sRP + (i >> 4) * kWld + 4 * (i & 15)) = __ldg(src + i);
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
        tc::gemm_wg(acc, x, sW1e);
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
          fused_edge::edge_value<MODE>(ev, p.edge, p.feat, t0, sm + L.ew1, sm + L.ew2, sEV,
                                       0, ne);
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
      tc::gemm_wg(msg, acc, sW2);
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
        tc::copy_out_rows(p.new_edge + row0 * D, sStage, r_base, nrows);
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
      if (idx < nr * BD) p.aggr[static_cast<long long>(r0) * BD + idx] = agg[j];
    }
  }
}

template <int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = cudaFuncSetAttribute(fused_edge_v2_fwd<MODE>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes<MODE>());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  const int groups_needed = (p.num_chunks + kGroups - 1) / kGroups;
  const int blocks = min(groups_needed, tc::sm_count());
  fused_edge_v2_fwd<MODE><<<blocks, kBlockThreads, smem_bytes<MODE>(), stream>>>(p);
  return cudaGetLastError();
}

template <int MODE>
cudaError_t occupancy(int* blocks, int* regs, int* smem) {
  return tc::occupancy(fused_edge_v2_fwd<MODE>, kBlockThreads, smem_bytes<MODE>(), blocks,
                       regs, smem);
}

}  // namespace

// Blocks of the kernel for edge_mode that fit on one SM, its threads per
// block, registers per thread and dynamic shared memory per block.
extern "C" int nl_fused_edge_v2_fwd_occupancy(int edge_mode, int* blocks, int* threads,
                                              int* regs, int* smem) {
  *threads = kBlockThreads;
  switch (edge_mode) {
    case EDGE_RAW: return static_cast<int>(occupancy<EDGE_RAW>(blocks, regs, smem));
    case EDGE_SHARED: return static_cast<int>(occupancy<EDGE_SHARED>(blocks, regs, smem));
    case EDGE_BATCHED: return static_cast<int>(occupancy<EDGE_BATCHED>(blocks, regs, smem));
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
  if (num_rec <= 0) return static_cast<int>(cudaSuccess);
  if (batch < 1 || batch > kRecRows || feat > kMaxFeat)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.edge = static_cast<const float*>(edge);
  p.sp = static_cast<const float*>(sp);
  p.rp = static_cast<const float*>(rp);
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
  p.aggr = static_cast<float*>(aggr);
  p.new_edge = static_cast<float*>(new_edge);
  p.pre = static_cast<float*>(pre);
  p.counter = static_cast<int*>(counter);
  p.num_rec = num_rec;
  p.batch = batch;
  p.feat = feat;
  p.recv_per_chunk = batch <= kChunkRows ? kChunkRows / batch : 1;
  p.num_chunks = (num_rec + p.recv_per_chunk - 1) / p.recv_per_chunk;
  p.edges_per_tile = kTileRows / batch;
  p.update_edges = update_edges;
  p.layer_norm = layer_norm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (edge_mode) {
    case EDGE_RAW: err = launch<EDGE_RAW>(p, s); break;
    case EDGE_SHARED: err = launch<EDGE_SHARED>(p, s); break;
    case EDGE_BATCHED: err = launch<EDGE_BATCHED>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
