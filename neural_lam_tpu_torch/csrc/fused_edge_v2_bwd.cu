// K8: backward of the v2 fused edge phase (K7, fused_edge_v2.cu).
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_v2_bwd_impl (the
// _fused_v2_bwd_kernel + _embed_backward pallas_call). Given the gradients
// d_aggr (num_rec, B, D) of the receiver sums and, optionally, d_new_edge
// (E, B, D) of the updated edges, and the first layer's pre-activation
// pre[e, b] that K7 saved, it computes per edge e (receiver r) and batch
// member b:
//
//   d_msg  = d_aggr[r, b] (+ d_new_edge[e, b])
//   h1     = SiLU(pre),  z = h1 . W2 + b2
//   dz     = LayerNorm backward of d_msg at z   (dz = d_msg without LN)
//            dgamma += d_msg * x_hat, dbeta += d_msg
//   d_h1   = dz . W2^T,  dW2 += h1^T . dz,  db2 += dz
//   d_pre[e, b] = d_h1 * SiLU'(pre),  db1 += d_pre          (written out)
//   d_recproj[r, b] = sum of d_pre over the edges into r
//   edge input, by mode:
//     EDGE_BATCHED  d_edge[e, b] = d_pre . W1e^T (+ d_new_edge[e, b]),
//                   dW1e += edge^T . d_pre
//     EDGE_SHARED,  through s[e] = sum_b d_pre[e, b] and the edge kernel of
//     EDGE_RAW      fused_edge_bwd_common.cuh: d_edge[e] and dW1e, or the
//                   embedder's six weight gradients
//
// Unlike K4 it emits no d_send and no dW1s and never reads sender rows: the
// first layer's sender product was formed outside K7 as sp = send . W1s, so
// the caller scatters d_pre into d_sp with K2 (the sender scatter), and the
// gradients of W1s, W1r and the node rows come from autograd of the two
// node-sized projections (d_rp = d_recproj), as the JAX package forms them
// outside its kernel (pallas_fused.py:2655-2674). Weight gradients come out
// in nn.Linear's (out, in) layout.
//
// Design: K4's (fused_edge_bwd.cu), without its sender half and its
// receiver slice. Three launches, with no float atomics anywhere:
//   1. fused_edge_v2_bwd_main, on the tensor cores with the 3xTF32 split
//      (tc_tf32.cuh), at float32 accuracy (the BF form below). A block of 12 warps holds W2 in
//      both orientations, split for wgmma, in shared memory and runs three
//      independent groups of 4 warps (one warpgroup each); group i of the
//      grid takes the chunks i, i + groups, ... of R = 16/B consecutive
//      receivers (one at B > 16; K4 takes 32/B) (a static assignment, so
//      each group's partial sums are
//      the same on every run; the grid is sized to the chunks). A warp owns
//      16 (edge, b) rows of a 64-row tile: z again from pre, the LayerNorm
//      backward (quad shuffles), d_h1 and d_pre chain in registers, the row
//      products (z, d_h1) as wgmma with the rows in registers. dW2 is an
//      A^T . B product over the tile's rows: h1 and dz go through two
//      shared tiles into mma.sync, each tile's share starts from zero and
//      is added on the float32 units to the warp's 16 x 64 share, which the
//      warp keeps in registers across the group's tiles (kept in the tensor
//      core, a running sum over a million rows drifts, tc::mma3x4). The
//      column sums (db2, dgamma, dbeta, db1) are shuffle trees into
//      per-warp slots. d_pre goes out through a shared tile as whole rows;
//      from the same tile the group sums each chunk's d_recproj rows in
//      place in device memory, in edge order, and, for the per-edge
//      inputs, s[e] = sum_b d_pre[e, b].
//   2. The edge input's share (fused_edge_bwd_common.cuh, shared with K4):
//      fused_edge_bwd_rows over d_pre for a batched input (d_edge by wgmma,
//      dW1e by mma.sync), fused_edge_bwd_edge over s for the others (its
//      chain on the tensor cores).
//   3. reduce_workspace: sums both workspaces over their groups in group
//      order, in one launch.
//   Without K4's d_send and dW1s the main kernel has three products a row
//   where K4 has five, one 16 x 64 gradient share a warp where K4 has two,
//   and one weight fewer in shared memory.
//
// Bound on the H100: operations at the tensor cores' rate, or the bytes
// of the larger sets. Per (edge, b) row the main kernel does three 64x64
// products (z, d_h1, dW2) and the batched edge pass two more (d_edge,
// dW1e), at 3xTF32 (495 TFLOP/s of TF32 over three); it reads pre, d_aggr
// and d_new_edge and writes d_pre, 768-1,024 bytes a row.
//
// Reduced precision (the JAX kernel's cdt = bf16 and io_dt, pallas_fused.py
// :1934, :2293): the instantiations with BF take every product's operands
// in bf16 (float32 sums), with the LayerNorm backward, SiLU' and the column
// sums in float32; s[e] sums d_pre rounded to bf16, as K4's does. Their
// main kernel is K4's BF chain (bwd_main_bf, fused_edge_bwd_main.cuh) with
// its sender half compiled out, on Hopper's bf16 tensor cores (tc_bf16.cuh):
// z = h1 . W2^T and d_h1 = dz . W2 are wgmma m64n64k16 on packed
// fragments, with one bf16 copy of W2 that the transpose bit reads as the
// MN-major B of d_h1 (no transposed copy); dW2 += h1^T . dz is wgmma on two
// bf16 tiles in the core layout, issued without waiting into the warp's
// 16 x 64 share, which stays in registers across the group's tiles, while
// the d_pre stream, the d_recproj sums and s run on the SIMT units. With
// one gradient share a warp (K4 keeps two) and 8 KB of weights, four groups
// a block fit (16 warps per SM, 198,720 bytes, 128 registers a thread,
// 176-220 bytes of spill stores); three groups (up to 168 registers) ran
// 1 % slower per training step on an H100. The edge pass, the rows pass
// (its BF form one TF32 pass on bf16 values, tc_tf32.cuh) and the reduce
// are as in float32. The streams d_aggr, d_new_edge and the
// edge input, and the output d_edge, are of type TI (bf16 under mixed
// precision and NEURAL_LAM_TPU_MATMUL_PRECISION=high, float32 under
// high-kernels), as the JAX wrapper casts them to io_dt (:2322, :2389); pre,
// d_pre, d_recproj and the weight gradients stay float32, and the caller
// casts d_pre to the streams' dtype for K2 (:2651-2657). Bound: bytes at the
// stream dtype, or the products at the dense bf16 rate (989 TFLOP/s).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_main.cuh"

namespace {

// groups of 4 warps a block: the float32 instantiations K4's kGroups (12
// warps per SM, up to 168 registers); the BF instantiations 4 (16 warps,
// up to 128 registers), which their one gradient share a warp leaves room
// for where K4's two spilled. The wrapper sizes the grid and the workspace
// by the same counts.
constexpr int kGroupsBf = 4;

__host__ __device__ constexpr int v2_groups(bool bf) { return bf ? kGroupsBf : kGroups; }
__host__ __device__ constexpr int v2_threads(bool bf) { return v2_groups(bf) * kGroupThreads; }

// (receiver, b) rows a chunk takes at B <= 16 (a larger B takes one
// receiver), as in K7: more, smaller chunks than K4's 32 rows balance the
// static assignment better (4-13 % faster at the MEPS sites on an H100);
// the wrapper sizes the grid by the same rule
constexpr int kChunkRows = 16;

// floats per group in the main kernel's workspace (the wrapper sizes it the
// same): dW2 as (out, in) | db2 dgamma dbeta db1
constexpr int kV2Stride = kMat + 4 * D;

// The float32 kernel's shared-memory plan, in floats: W2 in both
// orientations (split for wgmma) and two vectors, then per group two 64-row
// tiles, the warps' column-sum slots and the integers. (The BF kernel's is
// K4's main_plan_bf without the sender half.)
struct V2Smem {
  int w2, w2t, vec, groups, group_floats, total;
  int t1, t2, slots, ints;  // offsets inside a group
};

__host__ __device__ constexpr V2Smem v2_plan() {
  V2Smem s{};
  int o = 0;
  s.w2 = o; o += kWgMat;   // W2 as it is: z = h1 . W2^T
  s.w2t = o; o += kWgMat;  // W2^T: d_h1 = dz . W2
  s.vec = o; o += 2 * D;   // b2, gamma
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

template <bool BF>
constexpr int v2_smem_bytes() {
  return BF ? main_smem_bytes_bf(false, true, kGroupsBf)
            : v2_plan().total * static_cast<int>(sizeof(float));
}

// The float32 instantiations' body (3xTF32, tc_tf32.cuh)
template <bool BATCHED, typename TI>
__device__ __forceinline__ void v2_bwd_f32(const MainParams<TI>& p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr V2Smem L = v2_plan();
  const float* sW2 = sm + L.w2;
  const float* sW2t = sm + L.w2t;
  const float* sB2 = sm + L.vec;
  const float* sGam = sB2 + D;
  const float* pre = static_cast<const float*>(p.pre);

  tc::load_weight_wg<false>(sm + L.w2, p.w2, D, 0, kBlockThreads);
  tc::load_weight_wg<true>(sm + L.w2t, p.w2, D, 0, kBlockThreads);
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
  const int r_base = 16 * warp;  // the warp's first row of a tile, and of dW2
  const int gi = blockIdx.x * kGroups + group;
  const int inv_b = (65536 + B - 1) / B;  // q / B = (q * inv_b) >> 16 for q < 64

  float dW2[8][4];
  tc::zero(dW2);

  for (int chunk = gi; chunk < p.num_chunks; chunk += gridDim.x * kGroups) {
    const int r0 = chunk * R;
    const int nr = min(R, p.num_rec - r0);
    tc::group_sync(bar, kGroupThreads);  // the last chunk is done with gs
    if (tg <= nr) sRowptr[tg] = p.rowptr[r0 + tg];
    // the chunk's d_recproj rows are summed in place, each entry by one
    // thread in edge order
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
      tc::load_rows<true>(x, pre + row0 * D, D, r_base, nrows);
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
          const int el = (m * inv_b) >> 16, b = m - el * B;
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
      // (dz again from the warp's own rows of T2: kept live across the
      // weight-gradient product, it spills)
      tc::load_rows<false>(x, sT2, kWld, r_base, kTileRows);
      tc::zero(z);
      tc::gemm_wg<4>(z, x, sW2t);
      tc::load_rows<true>(x, pre + row0 * D, D, r_base, nrows);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[n][j] *= silu_grad(x[n][j]);
      tc::add_col_sums(slot + 3 * D, z);  // db1
      tc::group_sync(bar, kGroupThreads);  // every warp is done with h1 and dz

      // ---- d_pre out through T2; d_recproj in edge order; s[e] -------------
      tc::store_rows(sT2, kWld, z, r_base, kTileRows);
      tc::copy_out_rows(p.d_pre + row0 * D, sT2, r_base, nrows);
      tc::group_sync(bar, kGroupThreads);  // T2 = d_pre
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
          p.presum[static_cast<long long>(t0) * D + i] = s;
        }
      }
    }
  }

  // ---- the group's partials, once -----------------------------------------
  float* ws = p.ws + static_cast<long long>(gi) * kV2Stride;
  tc::store_rows(ws, D, dW2, r_base, D);
  tc::group_sync(bar, kGroupThreads);  // every warp's slots are final
  for (int i = tg; i < 4 * D; i += kGroupThreads) {
    float s = 0.0f;
    for (int w = 0; w < kGroupWarps; ++w) s += sSlots[w * 4 * D + i];
    ws[kMat + i] = s;
  }
}

// BF: bf16 operands, K4's BF chain without its sender half (bwd_main_bf,
// fused_edge_bwd_main.cuh); TI: the stream type (float or bf16)
template <bool BATCHED, bool BF, typename TI>
__global__ void __launch_bounds__(v2_threads(BF), 1)
fused_edge_v2_bwd_main(const MainParams<TI> p) {
  if constexpr (BF)
    bwd_main_bf<BATCHED ? EDGE_BATCHED : EDGE_SHARED, kPreF32, TI, true, kGroupsBf>(p);
  else
    v2_bwd_f32<BATCHED>(p);
}

template <bool BATCHED, bool BF, typename TI>
cudaError_t launch_v2_main(const MainParams<TI>& p, int blocks, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = fused_edge::allow_smem(fused_edge_v2_bwd_main<BATCHED, BF, TI>, v2_smem_bytes<BF>());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  fused_edge_v2_bwd_main<BATCHED, BF, TI>
      <<<blocks, v2_threads(BF), v2_smem_bytes<BF>(), stream>>>(p);
  return cudaGetLastError();
}

// the launch resources of the main kernel's instantiation: out = blocks per
// SM, threads per block, registers per thread, shared memory per block,
// local memory per thread (bytes)
template <bool BATCHED, bool BF, typename TI>
cudaError_t v2_occupancy_of(int* out) {
  out[1] = v2_threads(BF);
  out[3] = v2_smem_bytes<BF>();
  return tcb::occupancy(fused_edge_v2_bwd_main<BATCHED, BF, TI>, out[1], out[3], out,
                        out + 2, out + 4);
}

template <bool BATCHED>
cudaError_t v2_occupancy_mode(int bf16_ops, int io_bf16, int* out) {
  if (!bf16_ops) return v2_occupancy_of<BATCHED, false, float>(out);
  return io_bf16 ? v2_occupancy_of<BATCHED, true, __nv_bfloat16>(out)
                 : v2_occupancy_of<BATCHED, true, float>(out);
}

// Fill the parameters and launch the main kernel, the edge input's share
// and the two reduces, for the instantiation BF, TI
template <bool BF, typename TI>
cudaError_t run_v2(int edge_mode, int num_rec, int n_edges, int batch, int feat, int layer_norm,
                int main_blocks, int edge_blocks, const void* edge, const void* pre,
                const void* d_aggr, const void* d_new_edge, const void* rowptr, const void* w1,
                const void* w2, const void* b2, const void* gamma, const void* ew1,
                const void* eb1, const void* ew2, const void* eb2, const void* eg,
                const void* ebt, void* d_pre, void* d_edge, void* d_recproj, void* presum,
                void* ws_main, void* out_main, void* ws_edge, void* out_edge, void* stream) {
  if (num_rec <= 0 || n_edges <= 0 || batch < 1 || batch > kRecRows ||
      feat > kMaxFeat || main_blocks <= 0 || edge_blocks <= 0 || edge_mode < 0 ||
      edge_mode > 2)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool batched = edge_mode == EDGE_BATCHED;

  MainParams<TI> m{};
  m.pre = pre;
  m.d_aggr = static_cast<const TI*>(d_aggr);
  m.d_new_edge = static_cast<const TI*>(d_new_edge);
  m.rowptr = static_cast<const int*>(rowptr);
  m.w2 = static_cast<const float*>(w2);
  m.b2 = static_cast<const float*>(b2);
  m.gamma = static_cast<const float*>(gamma);
  m.d_pre = static_cast<float*>(d_pre);
  m.presum = static_cast<float*>(presum);
  m.d_recproj = static_cast<float*>(d_recproj);
  m.ws = static_cast<float*>(ws_main);
  m.num_rec = num_rec;
  m.batch = batch;
  m.recv_per_chunk = batch <= kChunkRows ? kChunkRows / batch : 1;
  m.edges_per_tile = kTileRows / batch;
  m.num_chunks = (num_rec + m.recv_per_chunk - 1) / m.recv_per_chunk;
  m.layer_norm = layer_norm;
  cudaError_t err = batched ? launch_v2_main<true, BF, TI>(m, main_blocks, s)
                            : launch_v2_main<false, BF, TI>(m, main_blocks, s);
  if (err != cudaSuccess) return err;
  fused_edge::ReduceJobs jobs{};
  jobs.n = 2;
  jobs.job[0] = fused_edge::ReduceJob{m.ws, static_cast<float*>(out_main),
                                      main_blocks * v2_groups(BF), kV2Stride, kV2Stride};

  if (batched) {  // the edge input's share per (edge, b) row, over d_pre
    fused_edge::RowsParamsT<TI> r;
    r.x = static_cast<const TI*>(edge);
    r.g = m.d_pre;
    r.add = m.d_new_edge;
    r.w1 = static_cast<const float*>(w1);
    r.w_off = 0;
    r.out = static_cast<TI*>(d_edge);
    r.ws = static_cast<float*>(ws_edge);
    r.rows = n_edges * batch;
    err = fused_edge::launch_rows<false, BF>(r, edge_blocks, static_cast<float*>(out_edge),
                                             &jobs.job[1], s);
  } else {  // the per-edge modes: the edge pass over s
    fused_edge::EdgeParamsT<TI> e;
    e.edge = static_cast<const TI*>(edge);
    e.presum = m.presum;
    e.d_new_edge = m.d_new_edge;
    e.w1 = static_cast<const float*>(w1);
    e.ew1 = static_cast<const float*>(ew1);
    e.eb1 = static_cast<const float*>(eb1);
    e.ew2 = static_cast<const float*>(ew2);
    e.eb2 = static_cast<const float*>(eb2);
    e.eg = static_cast<const float*>(eg);
    e.ebt = static_cast<const float*>(ebt);
    e.d_edge = static_cast<TI*>(d_edge);
    e.ws = static_cast<float*>(ws_edge);
    e.n_edges = n_edges;
    e.batch = batch;
    e.feat = feat;
    err = fused_edge::launch_edge_pass<BF>(edge_mode, e, edge_blocks,
                                           static_cast<float*>(out_edge), &jobs.job[1], s);
  }
  if (err != cudaSuccess) return err;
  return fused_edge::launch_reduces(jobs, s);
}

}  // namespace

// The launch resources of the main kernel's instantiation: bf16_ops (then
// io_bf16, the stream type) and edge_mode pick it (one kernel serves both
// per-edge modes); out = blocks per SM, threads per block, registers per
// thread, dynamic shared memory per block and local memory per thread
// (bytes).
extern "C" int nl_fused_edge_v2_bwd_occupancy(int bf16_ops, int io_bf16, int edge_mode,
                                              int* out) {
  if (edge_mode < 0 || edge_mode > 2) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(edge_mode == EDGE_BATCHED
                              ? v2_occupancy_mode<true>(bf16_ops, io_bf16, out)
                              : v2_occupancy_mode<false>(bf16_ops, io_bf16, out));
}

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   pre: (E, B, D); d_aggr: (num_rec, B, D); d_new_edge: (E, B, D) or null;
//   rowptr: (num_rec + 1,) int32; weights as for nl_fused_edge_v2_fwd
//   d_pre: (E, B, D) out; d_recproj: (num_rec, B, D) out
//   d_edge: (E, B, D) out [edge_mode 2], (E, D) out [1], unused [0]
//   presum: (E, D) scratch [edge_mode 0, 1]
//   ws_main: (main_blocks * groups, 4352) scratch, groups 3 (float32) or 4
//     (the bf16-operand instantiations); out_main: (4352,) out =
//     dW2 as (out, in) | db2 dgamma dbeta db1
//   ws_edge: (edge_blocks * 3, 8960) scratch [edge_mode 0, 1], (edge_blocks * 4,
//     4096) [2]; out_edge: (8960,) out = dW1e, dEW2 as (out, in) | dEW1 as
//     (D, 8) | deb1 deb2 deg debt (dW1e alone [2])
//   main_blocks = min(SMs, ceil(chunks / groups)) with chunks = ceil(num_rec /
//   max(1, 16 / batch)); edge_blocks = min(SMs, ceil(tiles / 4)) with tiles =
//   ceil(E * B / 64) [edge_mode 2], else min(SMs, ceil(ceil(E / 64) / 3))
// num_rec > 0, n_edges > 0, 1 <= batch <= 32, feat <= 8 and both block
// counts > 0 are checked by the caller. Returns the first CUDA error of the
// launches.
extern "C" int nl_fused_edge_v2_bwd(
    int edge_mode, int num_rec, int n_edges, int batch, int feat, int layer_norm,
    int main_blocks, int edge_blocks, const void* edge, const void* pre,
    const void* d_aggr, const void* d_new_edge, const void* rowptr, const void* w1,
    const void* w2, const void* b2, const void* gamma, const void* ew1,
    const void* eb1, const void* ew2, const void* eb2, const void* eg,
    const void* ebt, void* d_pre, void* d_edge, void* d_recproj, void* presum,
    void* ws_main, void* out_main, void* ws_edge, void* out_edge, void* stream) {
  return static_cast<int>(run_v2<false, float>(
      edge_mode, num_rec, n_edges, batch, feat, layer_norm, main_blocks, edge_blocks, edge,
      pre, d_aggr, d_new_edge, rowptr, w1, w2, b2, gamma, ew1, eb1, ew2, eb2, eg, ebt, d_pre,
      d_edge, d_recproj, presum, ws_main, out_main, ws_edge, out_edge, stream));
}

// The bf16-operand instantiations: the arguments of nl_fused_edge_v2_bwd, with
// edge, d_aggr, d_new_edge and d_edge in bf16 (io_bf16) or float32; pre,
// d_pre, d_recproj, presum and the workspaces float32 as there.
extern "C" int nl_fused_edge_v2_bwd_bf16ops(
    int io_bf16, int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int layer_norm, int main_blocks, int edge_blocks, const void* edge, const void* pre,
    const void* d_aggr, const void* d_new_edge, const void* rowptr, const void* w1,
    const void* w2, const void* b2, const void* gamma, const void* ew1,
    const void* eb1, const void* ew2, const void* eb2, const void* eg,
    const void* ebt, void* d_pre, void* d_edge, void* d_recproj, void* presum,
    void* ws_main, void* out_main, void* ws_edge, void* out_edge, void* stream) {
  auto go = io_bf16 ? &run_v2<true, __nv_bfloat16> : &run_v2<true, float>;
  return static_cast<int>(go(
      edge_mode, num_rec, n_edges, batch, feat, layer_norm, main_blocks, edge_blocks, edge,
      pre, d_aggr, d_new_edge, rowptr, w1, w2, b2, gamma, ew1, eb1, ew2, eb2, eg, ebt, d_pre,
      d_edge, d_recproj, presum, ws_main, out_main, ws_edge, out_edge, stream));
}
