// K4: backward of the fused edge phase (K3, fused_edge.cu).
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_bwd_impl (the
// _fused_bwd_kernel + _embed_backward pallas_call). Given the gradients
// d_aggr (num_rec, B, D) of the receiver sums and, optionally, d_new_edge
// (E, B, D) of the updated edges, and the first layer's pre-activation
// pre[e, b] that K3 saved, it computes per edge e (receiver r) and batch
// member b:
//
//   d_msg  = d_aggr[r, b] (+ d_new_edge[e, b])
//   h1     = SiLU(pre),  z = h1 . W2 + b2
//   dz     = LayerNorm backward of d_msg at z   (dz = d_msg without LN)
//            dgamma += d_msg * x_hat, dbeta += d_msg
//   d_h1   = dz . W2^T,  dW2 += h1^T . dz,  db2 += dz
//   d_pre  = d_h1 * SiLU'(pre),  db1 += d_pre
//   d_send[e, b] = d_pre . W1s^T (+ d_msg under propagation)
//   dW1s  += send^T . d_pre
//   d_recproj[r, b] = sum of d_pre over the edges into r
//   edge input, by mode:
//     EDGE_BATCHED  d_edge[e, b] = d_pre . W1e^T (+ d_new_edge[e, b]),
//                   dW1e += edge^T . d_pre
//     EDGE_SHARED   with s[e] = sum_b d_pre[e, b]:
//                   d_edge[e] = s[e] . W1e^T (+ sum_b d_new_edge[e, b]),
//                   dW1e += edge^T . s
//     EDGE_RAW      the embedder is recomputed per edge, dW1e += edge_val^T . s,
//                   and d_edge[e] goes through the embedder's LayerNorm,
//                   second and first layer into its six weight gradients
//                   (the raw features are constants).
//
// The gradient of the receiver rows and of W1r are node-sized products of
// d_recproj that the caller forms, as the JAX package does outside its
// kernel. Weight gradients come out in nn.Linear's (out, in) layout.
//
// Design. The TPU kernel zeroes its weight-gradient blocks on the first
// step of a sequential grid and adds into them step by step; CUDA blocks
// run in no order. Here each group of warps keeps its partial weight
// gradients in registers, writes them once to a (groups, stride) workspace,
// and a last small kernel sums the workspace over the groups in group
// order: with a fixed grid and a fixed assignment of work to groups the
// result is deterministic, with no float atomics anywhere.
//
// Four launches:
//   1. fused_edge_bwd_main, on the tensor cores with the 3xTF32 split
//      (tc_tf32.cuh), at float32 accuracy. A block of 12 warps holds W2
//      (both orientations) and W1s^T, split for wgmma, in shared memory and
//      runs three independent groups of 4 warps (one warpgroup each); group
//      i of the grid takes the chunks i, i + groups, ... of R = 32/B
//      consecutive receivers (the grid is sized to the chunks: a small edge
//      set runs few groups and reduces few partials). A chunk's d_recproj
//      rows are summed in place in device memory, each entry by one thread
//      in edge order (in registers they would spill). A warp owns 16
//      (edge, b) rows of a 64-row tile: z again from pre, the LayerNorm
//      backward (quad shuffles), d_h1, d_pre and d_send chain in registers,
//      the row products (z, d_h1, d_send) as wgmma with the rows in
//      registers. The weight gradients are A^T . B products over the tile's
//      rows, so their operands go through two shared tiles (h1 and dz, then
//      send and d_pre) into mma.sync; each warp keeps a 16 x 64 share of dW2
//      and dW1s in registers across the group's tiles, each tile's share
//      added on the float32 units. The column sums (db2, dgamma, dbeta,
//      db1) are shuffle trees into per-warp slots. It writes d_pre
//      (EDGE_BATCHED) or s[e] = sum_b d_pre[e, b] (the per-edge modes) for
//      the edge pass.
//   2. The edge input's share (fused_edge_bwd_common.cuh, shared with K8).
//      EDGE_BATCHED: fused_edge_bwd_rows, d_edge (wgmma) and dW1e
//      (mma.sync) per (edge, b) row over d_pre. The per-edge modes:
//      fused_edge_bwd_edge, dW1e and d_edge, and for EDGE_RAW the embedder's
//      backward, over tiles of 64 rows of s (B times fewer rows than the
//      edge stream) on the SIMT units.
//   3. reduce_workspace after each: sums the partials in group (block) order.
//
// Bound on the H100: operations. Per (edge, b) row the main kernel does
// five 64x64 products (z, d_h1, dW2, d_send, dW1s) and the batched edge
// pass two more (d_edge, dW1e), on the tensor cores (495 TFLOP/s of TF32,
// divided by three for 3xTF32).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_common.cuh"
#include "tc_tf32.cuh"

namespace {

using fused_edge::D;
using fused_edge::EDGE_BATCHED;
using fused_edge::EDGE_RAW;
using fused_edge::EDGE_SHARED;
using fused_edge::EdgeParams;
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

struct MainParams {
  const float* send;        // (E, B, D)
  const float* pre;         // (E, B, D)
  const float* d_aggr;      // (num_rec, B, D)
  const float* d_new_edge;  // (E, B, D) or null
  const int* rowptr;
  const float* w1;
  const float* w2;
  const float* b2;
  const float* gamma;
  float* d_send;     // (E, B, D)
  float* d_pre;      // (E, B, D) d_pre [EDGE_BATCHED], else (E, D) s
  float* d_recproj;  // (num_rec, B, D)
  float* ws;         // (gridDim.x * kGroups, kMainStride)
  int num_rec;
  int num_chunks;
  int batch;
  int recv_per_chunk;
  int edges_per_tile;
  int propagation;
  int layer_norm;
};

// Shared-memory plan, in floats: the block's weights (split for wgmma) and
// vectors, then per group two 64-row tiles, the warps' column-sum slots and
// the integers.
struct MainSmem {
  int w2, w2t, w1st, vec, groups, group_floats, total;
  int t1, t2, slots, ints;  // offsets inside a group
};

__host__ __device__ constexpr MainSmem main_plan() {
  MainSmem s{};
  int o = 0;
  s.w2 = o; o += kWgMat;    // W2 as it is: z = h1 . W2^T
  s.w2t = o; o += kWgMat;   // W2^T: d_h1 = dz . W2
  s.w1st = o; o += kWgMat;  // W1s^T: d_send = d_pre . W1s
  s.vec = o; o += 2 * D;    // b2, gamma
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

constexpr int main_smem_bytes() { return main_plan().total * static_cast<int>(sizeof(float)); }

template <bool BATCHED>
__global__ void __launch_bounds__(kBlockThreads, 1)
fused_edge_bwd_main(const MainParams p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr MainSmem L = main_plan();
  const float* sW2 = sm + L.w2;
  const float* sW2t = sm + L.w2t;
  const float* sW1st = sm + L.w1st;
  const float* sB2 = sm + L.vec;
  const float* sGam = sB2 + D;

  tc::load_weight_wg<false>(sm + L.w2, p.w2, D, 0, kBlockThreads);
  tc::load_weight_wg<true>(sm + L.w2t, p.w2, D, 0, kBlockThreads);
  tc::load_weight_wg<true>(sm + L.w1st, p.w1, 3 * D, D, kBlockThreads);
  if (threadIdx.x < D) {
    sm[L.vec + threadIdx.x] = p.b2[threadIdx.x];
    sm[L.vec + D + threadIdx.x] = p.layer_norm ? p.gamma[threadIdx.x] : 1.0f;
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

      // ---- the forward again from pre: h1 into T1, z and its x_hat -------
      float x[8][4], z[8][4], rstd[2];
      tc::load_rows<true>(x, p.pre + row0 * D, D, r_base, nrows);
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
      {
        const tc::Lane l;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = r_base + l.g + 8 * h;
          const bool live = m < nrows;
          const int el = m / B, b = m - el * B;
          const float* da =
              p.d_aggr + ((static_cast<long long>(r0) + (live ? sRloc[el] : 0)) * B + b) * D +
              2 * l.t;
          const float* dn = p.d_new_edge + (row0 + m) * D + 2 * l.t;
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            float2 v = make_float2(0.0f, 0.0f);
            if (live) {
              v = __ldg(reinterpret_cast<const float2*>(da + 8 * n));
              if (p.d_new_edge != nullptr) {
                const float2 w = __ldg(reinterpret_cast<const float2*>(dn + 8 * n));
                v.x += w.x;
                v.y += w.y;
              }
            }
            x[n][2 * h] = v.x;
            x[n][2 * h + 1] = v.y;
          }
        }
      }
      if (p.propagation)  // d_send's residual term, added below
        tc::store_rows(p.d_send + row0 * D, D, x, r_base, nrows);
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
      tc::load_rows<true>(x, p.pre + row0 * D, D, r_base, nrows);
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
          for (int b = 0; b < B; ++b) s += sT2[(el * B + b) * kWld + c];
          p.d_pre[static_cast<long long>(t0) * D + i] = s;
        }
      }
      tc::group_sync(bar, kGroupThreads);  // done with send in T1

      // ---- d_send = d_pre . W1s (+ d_msg), through T1 ----------------------
      tc::load_rows<false>(z, sT2, kWld, r_base, kTileRows);  // the warp's d_pre rows
      tc::zero(x);
      tc::gemm_wg<4>(x, z, sW1st);
      if (p.propagation) {
        // the residual this thread wrote above: a plain (coherent) load
        tc::load_rows<false>(z, p.d_send + row0 * D, D, r_base, nrows);
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

template <bool BATCHED>
cudaError_t launch_main(const MainParams& p, int blocks, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = fused_edge::allow_smem(fused_edge_bwd_main<BATCHED>, main_smem_bytes());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  fused_edge_bwd_main<BATCHED><<<blocks, kBlockThreads, main_smem_bytes(), stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Blocks of the main kernel for edge_mode that fit on one SM, its threads
// per block, registers per thread and dynamic shared memory per block.
extern "C" int nl_fused_edge_bwd_occupancy(int edge_mode, int* blocks, int* threads,
                                           int* regs, int* smem) {
  *threads = kBlockThreads;
  return static_cast<int>(
      edge_mode == EDGE_BATCHED
          ? tc::occupancy(fused_edge_bwd_main<true>, kBlockThreads, main_smem_bytes(),
                          blocks, regs, smem)
          : tc::occupancy(fused_edge_bwd_main<false>, kBlockThreads, main_smem_bytes(),
                          blocks, regs, smem));
}

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   send, pre: (E, B, D); d_aggr: (num_rec, B, D); d_new_edge: (E, B, D) or
//   null; rowptr: (num_rec + 1,) int32; weights as for nl_fused_edge_fwd
//   d_send: (E, B, D) out; d_recproj: (num_rec, B, D) out
//   d_edge: (E, B, D) out [edge_mode 2], (E, D) out [1], unused [0]
//   d_pre: (E, B, D) scratch [edge_mode 2], (E, D) [0, 1]
//   ws_main: (main_blocks * 3, 8448) scratch; out_main: (8448,) out =
//     dW2, dW1s as (out, in) | db2 dgamma dbeta db1
//   ws_edge: (edge_blocks, 8960) scratch [edge_mode 0, 1], (edge_blocks * 4,
//     4096) [2]; out_edge: (8960,) out = dW1e, dEW2 as (out, in) | dEW1 as
//     (D, 8) | deb1 deb2 deg debt (dW1e alone [2])
//   main_blocks = min(SMs, ceil(chunks / 3)) with chunks = ceil(num_rec /
//   (32 / batch)); edge_blocks = min(SMs, ceil(tiles / 4)) with tiles =
//   ceil(E * B / 64) [edge_mode 2], else min(SMs, ceil(E / 64))
// num_rec > 0, n_edges > 0, 1 <= batch <= 32, feat <= 8 and both block
// counts > 0 are checked by the caller. Returns the first CUDA error of the
// launches.
extern "C" int nl_fused_edge_bwd(
    int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int propagation, int layer_norm, int main_blocks, int edge_blocks,
    const void* edge, const void* send, const void* pre, const void* d_aggr,
    const void* d_new_edge, const void* rowptr, const void* w1, const void* w2,
    const void* b2, const void* gamma, const void* ew1, const void* eb1,
    const void* ew2, const void* eb2, const void* eg, const void* ebt,
    void* d_send, void* d_edge, void* d_recproj, void* d_pre, void* ws_main,
    void* out_main, void* ws_edge, void* out_edge, void* stream) {
  if (num_rec <= 0 || n_edges <= 0 || batch < 1 || batch > kRecRows ||
      feat > kMaxFeat || main_blocks <= 0 || edge_blocks <= 0 || edge_mode < 0 ||
      edge_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool batched = edge_mode == EDGE_BATCHED;

  MainParams m;
  m.send = static_cast<const float*>(send);
  m.pre = static_cast<const float*>(pre);
  m.d_aggr = static_cast<const float*>(d_aggr);
  m.d_new_edge = static_cast<const float*>(d_new_edge);
  m.rowptr = static_cast<const int*>(rowptr);
  m.w1 = static_cast<const float*>(w1);
  m.w2 = static_cast<const float*>(w2);
  m.b2 = static_cast<const float*>(b2);
  m.gamma = static_cast<const float*>(gamma);
  m.d_send = static_cast<float*>(d_send);
  m.d_pre = static_cast<float*>(d_pre);
  m.d_recproj = static_cast<float*>(d_recproj);
  m.ws = static_cast<float*>(ws_main);
  m.num_rec = num_rec;
  m.batch = batch;
  m.recv_per_chunk = kRecRows / batch;
  m.edges_per_tile = kTileRows / batch;
  m.num_chunks = (num_rec + m.recv_per_chunk - 1) / m.recv_per_chunk;
  m.propagation = propagation;
  m.layer_norm = layer_norm;
  cudaError_t err = batched ? launch_main<true>(m, main_blocks, s)
                            : launch_main<false>(m, main_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = fused_edge::launch_reduce(m.ws, main_blocks * kGroups, kMainStride, 0,
                                  static_cast<float*>(out_main), s);
  if (err != cudaSuccess) return static_cast<int>(err);

  if (batched) {  // the edge input's share per (edge, b) row
    fused_edge::RowsParams r;
    r.edge = static_cast<const float*>(edge);
    r.d_pre = m.d_pre;
    r.d_new_edge = m.d_new_edge;
    r.w1 = m.w1;
    r.d_edge = static_cast<float*>(d_edge);
    r.ws = static_cast<float*>(ws_edge);
    r.rows = n_edges * batch;
    return static_cast<int>(
        fused_edge::launch_rows(r, edge_blocks, static_cast<float*>(out_edge), s));
  }

  // the per-edge modes: the edge pass over s
  EdgeParams e;
  e.edge = static_cast<const float*>(edge);
  e.presum = m.d_pre;
  e.d_new_edge = m.d_new_edge;
  e.w1 = m.w1;
  e.ew1 = static_cast<const float*>(ew1);
  e.eb1 = static_cast<const float*>(eb1);
  e.ew2 = static_cast<const float*>(ew2);
  e.eb2 = static_cast<const float*>(eb2);
  e.eg = static_cast<const float*>(eg);
  e.ebt = static_cast<const float*>(ebt);
  e.d_edge = static_cast<float*>(d_edge);
  e.ws = static_cast<float*>(ws_edge);
  e.n_edges = n_edges;
  e.batch = batch;
  e.feat = feat;
  return static_cast<int>(fused_edge::launch_edge_phase(
      edge_mode, e, edge_blocks, static_cast<float*>(out_edge), s));
}
