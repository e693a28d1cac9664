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
// run in no order. Here a fixed number of persistent blocks (one per SM)
// each walk a strided share of the work, keep their partial weight
// gradients in registers (a 4x4 share of each 64x64 matrix per thread),
// write them once to a (blocks, stride) workspace, and a last small kernel
// sums the workspace over the blocks in block order. With a fixed grid the
// result is deterministic: no float atomics anywhere.
//
// Three launches:
//   1. fused_edge_bwd_main: a block owns chunks of R consecutive receivers
//      (R*B <= 32) and their contiguous CSR edge range, as K3 does, so
//      d_aggr[receiver] is a read of the chunk's rows in shared memory and
//      d_recproj is summed in registers in edge order. It walks the edges
//      in tiles of 64 (edge, b) rows. W2 (both orientations), W1s and, for
//      EDGE_BATCHED, W1e stay in shared memory: the transposed products
//      x . W^T read nn.Linear's (out, in) layout as it is. For the per-edge
//      modes it writes s[e] = sum_b d_pre[e, b] to an (E, D) scratch.
//   2. fused_edge_bwd_edge (EDGE_RAW, EDGE_SHARED): tiles of 64 edges over
//      s, B times smaller than the other streams; keeps the embedder's
//      weights in shared memory instead of crowding the main kernel's.
//   3. reduce_workspace: sums the partials over the blocks and transposes
//      the matrices into (out, in).
//
// Bound on the H100: operations, as K3. Per (edge, b) row the main kernel
// does five 64x64 products (z, d_h1, dW2, d_send, dW1s) and two more for a
// batched edge input (d_edge, dW1e), in exact float32 on the SIMT units.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_common.cuh"

namespace {

using namespace fused_edge;

constexpr int kMat = D * D;
// floats per block in the two workspaces (the wrapper sizes them the same)
constexpr int kMainStride = 3 * kMat + 4 * D;  // dW2 dW1s dW1e | db2 dgamma dbeta db1
constexpr int kEdgeStride = 2 * kMat + kMaxFeat * D + 4 * D;
// dW1e dEW2 | dEW1 as (D, kMaxFeat) | deb1 deb2 deg debt

struct MainParams {
  const float* edge;        // (E, B, D), EDGE_BATCHED only
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
  float* d_edge;     // (E, B, D), EDGE_BATCHED only
  float* presum;     // (E, D), the per-edge modes only
  float* d_recproj;  // (num_rec, B, D)
  float* ws;         // (gridDim.x, kMainStride)
  int num_rec;
  int num_chunks;
  int batch;
  int recv_per_block;
  int edges_per_tile;
  int propagation;
  int layer_norm;
};

struct EdgeParams {
  const float* edge;        // (E, feat) raw features or (E, D)
  const float* presum;      // (E, D)
  const float* d_new_edge;  // (E, B, D) or null
  const float* w1;
  const float* ew1;
  const float* eb1;
  const float* ew2;
  const float* eb2;
  const float* eg;
  const float* ebt;
  float* d_edge;  // (E, D), EDGE_SHARED only
  float* ws;      // (gridDim.x, kEdgeStride)
  int n_edges;
  int batch;
  int feat;
};

// the thread's 4x4 share of a weight gradient, row = input feature
__device__ __forceinline__ void store_wgrad(float* dst, const float (&w)[4][4],
                                            int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<float4*>(dst + (4 * rg + i) * D + 4 * cg) =
        make_float4(w[i][0], w[i][1], w[i][2], w[i][3]);
}

// Sum NV per-column vectors, held as 4 columns per thread in each of the
// 16 row groups, over the row groups in order; scratch holds NV*16*D floats.
template <int NV>
__device__ __forceinline__ void store_vec_sums(float* dst, float* scratch,
                                               const float (&v)[NV][4],
                                               int rg, int cg) {
  __syncthreads();
#pragma unroll
  for (int n = 0; n < NV; ++n)
    *reinterpret_cast<float4*>(scratch + (n * 16 + rg) * D + 4 * cg) =
        make_float4(v[n][0], v[n][1], v[n][2], v[n][3]);
  __syncthreads();
  for (int i = threadIdx.x; i < NV * D; i += kThreads) {
    const int n = i / D, c = i - n * D;
    float s = 0.0f;
    for (int g = 0; g < 16; ++g) s += scratch[(n * 16 + g) * D + c];
    dst[i] = s;
  }
}

constexpr int main_smem_floats(bool batched) {
  return (batched ? 4 : 3) * kMat + 2 * D + (batched ? 4 : 3) * kTileRows * kLd +
         kRecRows * D + 100;
}

template <bool BATCHED>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_bwd_main(const MainParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW2t = smem;            // (in, out): z = h1 . W2
  float* sW2r = sW2t + kMat;     // (out, in): d_h1 = dz . W2^T
  float* sW1s = sW2r + kMat;     // (out, in) slice: d_send = d_pre . W1s^T
  float* sW1e = sW1s + kMat;     // (out, in) slice, BATCHED only
  float* sB2 = sW1e + (BATCHED ? kMat : 0);
  float* sGam = sB2 + D;
  float* sH = sGam + D;                 // h1 tile
  float* sG = sH + kTileRows * kLd;     // dz, then d_pre
  float* sXs = sG + kTileRows * kLd;    // sender rows
  float* sXe = sXs + kTileRows * kLd;   // edge rows, BATCHED only
  float* sDA = sXe + (BATCHED ? kTileRows * kLd : 0);  // the chunk's d_aggr rows
  int* sRowptr = reinterpret_cast<int*>(sDA + kRecRows * D);
  int* sRloc = sRowptr + 33;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int B = p.batch, R = p.recv_per_block, TE = p.edges_per_tile;
  const int BD = B * D;

  load_weight_t(sW2t, D, p.w2, D, 0);
  load_weight_raw(sW2r, p.w2, D, 0);
  load_weight_raw(sW1s, p.w1, 3 * D, D);
  if (BATCHED) load_weight_raw(sW1e, p.w1, 3 * D, 0);
  if (tid < D) {
    sB2[tid] = p.b2[tid];
    sGam[tid] = p.layer_norm ? p.gamma[tid] : 1.0f;
  }

  float dW2[4][4], dW1s[4][4], dW1e[4][4];
  zero(dW2);
  zero(dW1s);
  zero(dW1e);
  float vec[4][4];  // db2, dgamma, dbeta, db1 for the thread's 4 columns
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) vec[n][j] = 0.0f;

  for (int chunk = blockIdx.x; chunk < p.num_chunks; chunk += gridDim.x) {
    const int r0 = chunk * R;
    const int nr = min(R, p.num_rec - r0);
    __syncthreads();  // the previous chunk is done with sRowptr and sDA
    if (tid <= nr) sRowptr[tid] = p.rowptr[r0 + tid];
    for (int i = tid; i < kRecRows * (D / 4); i += kThreads) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < nr * B * (D / 4))
        v = __ldg(reinterpret_cast<const float4*>(
                      p.d_aggr + static_cast<long long>(r0) * BD) + i);
      reinterpret_cast<float4*>(sDA)[i] = v;
    }
    float agg[kAggPerThread];
#pragma unroll
    for (int j = 0; j < kAggPerThread; ++j) agg[j] = 0.0f;
    __syncthreads();

    const int e_begin = sRowptr[0], e_end = sRowptr[nr];
    for (int t0 = e_begin; t0 < e_end; t0 += TE) {
      const int ne = min(TE, e_end - t0);
      const int nrows = ne * B;
      const long long row0 = static_cast<long long>(t0) * B;

      // ---- tile loads ----------------------------------------------------
      load_rows(sXs, p.send + row0 * D, nrows, kTileRows);
      if (BATCHED) load_rows(sXe, p.edge + row0 * D, nrows, kTileRows);
      if (tid < nr) {
        const int a = max(sRowptr[tid], t0), z = min(sRowptr[tid + 1], t0 + ne);
        for (int e = a; e < z; ++e) sRloc[e - t0] = tid;
      }
      float pr[4][4], acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = rg + 16 * i;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < nrows)
          v = __ldg(reinterpret_cast<const float4*>(p.pre + (row0 + m) * D) + cg);
        pr[i][0] = v.x; pr[i][1] = v.y; pr[i][2] = v.z; pr[i][3] = v.w;
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = silu(pr[i][j]);
      }
      store_rows(sH, acc, rg, cg);
      __syncthreads();

      // ---- z and its LayerNorm statistics --------------------------------
      zero(acc);
      mm_acc<4>(acc, sH, sW2t, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sB2[4 * cg + j];
      float rstd[4];
      if (p.layer_norm) row_layer_norm(acc, nullptr, nullptr, cg, 4, rstd);

      // ---- d_msg, then dz through the LayerNorm --------------------------
      float dm[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = rg + 16 * i;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (m < nrows) {
          const int el = m / B, b = m - el * B;
          v = *reinterpret_cast<const float4*>(sDA + (sRloc[el] * B + b) * D + 4 * cg);
          if (p.d_new_edge != nullptr) {
            const float4 n = __ldg(
                reinterpret_cast<const float4*>(p.d_new_edge + (row0 + m) * D) + cg);
            v.x += n.x; v.y += n.y; v.z += n.z; v.w += n.w;
          }
        }
        dm[i][0] = v.x; dm[i][1] = v.y; dm[i][2] = v.z; dm[i][3] = v.w;
      }
      if (p.propagation) {
        // d_send's residual term: the message gradient itself
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = rg + 16 * i;
          if (m < nrows)
            *reinterpret_cast<float4*>(p.d_send + (row0 + m) * D + 4 * cg) =
                make_float4(dm[i][0], dm[i][1], dm[i][2], dm[i][3]);
        }
      }
      if (p.layer_norm)
        row_layer_norm_bwd(dm, acc, rstd, sGam, cg, vec[1], vec[2]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) vec[0][j] += dm[i][j];
      store_rows(sG, dm, rg, cg);
      __syncthreads();

      // ---- second layer ---------------------------------------------------
      wgrad_acc(dW2, sH, sG, rg, cg);
      zero(acc);
      mm_acc<4>(acc, sG, sW2r, rg, cg);  // d_h1
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[i][j] *= silu_grad(pr[i][j]);  // d_pre
          vec[3][j] += acc[i][j];
        }
      __syncthreads();  // every thread is done with dz in sG
      store_rows(sG, acc, rg, cg);
      __syncthreads();

      // ---- first layer ----------------------------------------------------
      wgrad_acc(dW1s, sXs, sG, rg, cg);
      zero(acc);
      mm_acc<4>(acc, sG, sW1s, rg, cg);  // d_send
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = rg + 16 * i;
        if (m < nrows) {
          float4* dst = reinterpret_cast<float4*>(p.d_send + (row0 + m) * D + 4 * cg);
          float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          if (p.propagation) {
            const float4 r = *dst;  // written by this thread above
            v.x += r.x; v.y += r.y; v.z += r.z; v.w += r.w;
          }
          *dst = v;
        }
      }
      if (BATCHED) {
        wgrad_acc(dW1e, sXe, sG, rg, cg);
        zero(acc);
        mm_acc<4>(acc, sG, sW1e, rg, cg);  // d_edge
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int m = rg + 16 * i;
          if (m < nrows) {
            float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            if (p.d_new_edge != nullptr) {
              const float4 n = __ldg(
                  reinterpret_cast<const float4*>(p.d_new_edge + (row0 + m) * D) + cg);
              v.x += n.x; v.y += n.y; v.z += n.z; v.w += n.w;
            }
            *reinterpret_cast<float4*>(p.d_edge + (row0 + m) * D + 4 * cg) = v;
          }
        }
      } else {
        // s[e] = sum_b d_pre[e, b], b ascending
        for (int i = tid; i < ne * D; i += kThreads) {
          const int el = i / D, c = i - el * D;
          float s = 0.0f;
          for (int b = 0; b < B; ++b) s += sG[(el * B + b) * kLd + c];
          p.presum[static_cast<long long>(t0) * D + i] = s;
        }
      }

      // ---- d_recproj: sums of d_pre per receiver, edge order -------------
#pragma unroll
      for (int j = 0; j < kAggPerThread; ++j) {
        const int idx = tid + j * kThreads;
        if (idx < nr * BD) {
          const int rl = idx / BD, rem = idx - rl * BD;
          const int b = rem / D, d = rem - b * D;
          const int a = max(sRowptr[rl], t0), z = min(sRowptr[rl + 1], t0 + ne);
          float s = agg[j];
          for (int e = a; e < z; ++e) s += sG[((e - t0) * B + b) * kLd + d];
          agg[j] = s;
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < kAggPerThread; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < nr * BD) p.d_recproj[static_cast<long long>(r0) * BD + idx] = agg[j];
    }
  }

  float* ws = p.ws + static_cast<long long>(blockIdx.x) * kMainStride;
  store_wgrad(ws, dW2, rg, cg);
  store_wgrad(ws + kMat, dW1s, rg, cg);
  store_wgrad(ws + 2 * kMat, dW1e, rg, cg);
  store_vec_sums<4>(ws + 3 * kMat, sH, vec, rg, cg);
}

constexpr int edge_smem_floats(bool raw) {
  return kMat + (raw ? 2 * kMat + kMaxFeat * D + 4 * D : 0) +
         (raw ? 3 : 2) * kTileRows * kLd + (raw ? kTileRows * kMaxFeat : 0);
}

template <bool RAW>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_bwd_edge(const EdgeParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW1e = smem;  // (out, in) slice: d_edge = s . W1e^T
  float* sS = sW1e + kMat;             // s, then dz and d_p1 of the embedder
  float* sXe = sS + kTileRows * kLd;   // edge_val
  float* sEW2t = sXe + kTileRows * kLd;  // RAW only from here
  float* sEW2r = sEW2t + kMat;
  float* sEW1 = sEW2r + kMat;
  float* sEB1 = sEW1 + kMaxFeat * D;
  float* sEB2 = sEB1 + D;
  float* sEG = sEB2 + D;
  float* sEBt = sEG + D;
  float* sA1 = sEBt + D;
  float* sF = sA1 + kTileRows * kLd;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int B = p.batch, F = p.feat;

  load_weight_raw(sW1e, p.w1, 3 * D, 0);
  if (RAW) {
    load_weight_t(sEW2t, D, p.ew2, D, 0);
    load_weight_raw(sEW2r, p.ew2, D, 0);
    for (int i = tid; i < F * D; i += kThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      sEW1[i] = __ldg(p.ew1 + c * F + k);
    }
    if (tid < D) {
      sEB1[tid] = p.eb1[tid];
      sEB2[tid] = p.eb2[tid];
      sEG[tid] = p.eg[tid];
      sEBt[tid] = p.ebt[tid];
    }
  }

  float dW1e[4][4], dEW2[4][4];
  zero(dW1e);
  zero(dEW2);
  float vec[4][4];  // deb1, deb2, deg, debt
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) vec[n][j] = 0.0f;
  // dEW1[c][f] for c = tid % D and f = tid / D, tid / D + 4
  float dEW1[2] = {0.0f, 0.0f};

  const int n_tiles = (p.n_edges + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int t0 = tile * kTileRows;
    const int ne = min(kTileRows, p.n_edges - t0);
    __syncthreads();  // the previous tile is done with the row tiles
    load_rows(sS, p.presum + static_cast<long long>(t0) * D, ne, kTileRows);
    if (RAW) {
      for (int i = tid; i < kTileRows * F; i += kThreads)
        sF[i] = i < ne * F ? p.edge[static_cast<long long>(t0) * F + i] : 0.0f;
    } else {
      load_rows(sXe, p.edge + static_cast<long long>(t0) * D, ne, kTileRows);
    }
    __syncthreads();

    float acc[4][4], p1[4][4], xh[4][4], rstd[4];
    if (RAW) {
      // the embedder again: edge_val = LN(SiLU(f . We1 + be1) . We2 + be2)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int el = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * cg + j;
          float v = sEB1[c];
          for (int f = 0; f < F; ++f) v = fmaf(sF[el * F + f], sEW1[f * D + c], v);
          p1[i][j] = v;
          acc[i][j] = silu(v);
        }
      }
      store_rows(sA1, acc, rg, cg);
      __syncthreads();
      zero(xh);
      mm_acc<4>(xh, sA1, sEW2t, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) xh[i][j] += sEB2[4 * cg + j];
      row_layer_norm(xh, nullptr, nullptr, cg, 4, rstd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = xh[i][j] * sEG[4 * cg + j] + sEBt[4 * cg + j];
      store_rows(sXe, acc, rg, cg);
      __syncthreads();
    }

    wgrad_acc(dW1e, sXe, sS, rg, cg);
    zero(acc);
    mm_acc<4>(acc, sS, sW1e, rg, cg);  // d_edge_val
    if (p.d_new_edge != nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int el = rg + 16 * i;
        if (el < ne) {
          const float4* src = reinterpret_cast<const float4*>(
              p.d_new_edge + static_cast<long long>(t0 + el) * B * D) + cg;
          for (int b = 0; b < B; ++b) {
            const float4 n = __ldg(src + b * (D / 4));
            acc[i][0] += n.x; acc[i][1] += n.y; acc[i][2] += n.z; acc[i][3] += n.w;
          }
        }
      }
    }
    if (!RAW) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int el = rg + 16 * i;
        if (el < ne)
          *reinterpret_cast<float4*>(
              p.d_edge + static_cast<long long>(t0 + el) * D + 4 * cg) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      continue;
    }

    // ---- through the embedder: LayerNorm, second layer, first layer -----
    row_layer_norm_bwd(acc, xh, rstd, sEG, cg, vec[2], vec[3]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) vec[1][j] += acc[i][j];
    __syncthreads();  // every thread is done with s in sS
    store_rows(sS, acc, rg, cg);
    __syncthreads();
    wgrad_acc(dEW2, sA1, sS, rg, cg);
    zero(acc);
    mm_acc<4>(acc, sS, sEW2r, rg, cg);  // d_a1
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] *= silu_grad(p1[i][j]);  // d_p1
        vec[0][j] += acc[i][j];
      }
    __syncthreads();
    store_rows(sS, acc, rg, cg);
    __syncthreads();
    {
      const int c = tid % D, f0 = tid / D;
      for (int e = 0; e < kTileRows; ++e) {
        const float g = sS[e * kLd + c];
        if (f0 < F) dEW1[0] = fmaf(sF[e * F + f0], g, dEW1[0]);
        if (f0 + 4 < F) dEW1[1] = fmaf(sF[e * F + f0 + 4], g, dEW1[1]);
      }
    }
  }

  float* ws = p.ws + static_cast<long long>(blockIdx.x) * kEdgeStride;
  store_wgrad(ws, dW1e, rg, cg);
  store_wgrad(ws + kMat, dEW2, rg, cg);
  {
    const int c = tid % D, f0 = tid / D;
    ws[2 * kMat + c * kMaxFeat + f0] = dEW1[0];
    ws[2 * kMat + c * kMaxFeat + f0 + 4] = dEW1[1];
  }
  store_vec_sums<4>(ws + 2 * kMat + kMaxFeat * D, sS, vec, rg, cg);
}

// out[i] = sum over the blocks, in block order, of ws[block][src(i)]: the
// first n_mat 64x64 matrices are transposed from (in, out) to (out, in).
__global__ void __launch_bounds__(kThreads)
reduce_workspace(const float* __restrict__ ws, int n_blocks, int stride,
                 int n_mat, float* __restrict__ out) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= stride) return;
  int src = i;
  if (i < n_mat * kMat) {
    const int mat = i / kMat, r = i - mat * kMat;
    src = mat * kMat + (r % D) * D + r / D;
  }
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += ws[static_cast<long long>(b) * stride + src];
  out[i] = s;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

template <bool BATCHED>
cudaError_t launch_main(const MainParams& p, int blocks, cudaStream_t stream) {
  constexpr int bytes = main_smem_floats(BATCHED) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(fused_edge_bwd_main<BATCHED>, bytes);
  if (err != cudaSuccess) return err;
  fused_edge_bwd_main<BATCHED><<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool RAW>
cudaError_t launch_edge(const EdgeParams& p, int blocks, cudaStream_t stream) {
  constexpr int bytes = edge_smem_floats(RAW) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(fused_edge_bwd_edge<RAW>, bytes);
  if (err != cudaSuccess) return err;
  fused_edge_bwd_edge<RAW><<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

cudaError_t launch_reduce(const float* ws, int n_blocks, int stride, int n_mat,
                          float* out, cudaStream_t stream) {
  reduce_workspace<<<(stride + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ws, n_blocks, stride, n_mat, out);
  return cudaGetLastError();
}

}  // namespace

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   send, pre: (E, B, D); d_aggr: (num_rec, B, D); d_new_edge: (E, B, D) or
//   null; rowptr: (num_rec + 1,) int32; weights as for nl_fused_edge_fwd
//   d_send: (E, B, D) out; d_recproj: (num_rec, B, D) out
//   d_edge: (E, B, D) out [edge_mode 2], (E, D) out [1], unused [0]
//   presum: (E, D) scratch [edge_mode 0, 1]
//   ws_main: (max_blocks, 12544) scratch; out_main: (12544,) out =
//     dW2, dW1s, dW1e [edge_mode 2, else 0] as (out, in) | db2 dgamma dbeta db1
//   ws_edge: (max_blocks, 8960) scratch; out_edge: (8960,) out [edge_mode 0, 1]
//     = dW1e, dEW2 as (out, in) | dEW1 as (D, 8) | deb1 deb2 deg debt
// num_rec > 0, n_edges > 0, 1 <= batch <= 32, feat <= 8 and max_blocks > 0
// are checked by the caller. Returns the first CUDA error of the launches.
extern "C" int nl_fused_edge_bwd(
    int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int propagation, int layer_norm, int max_blocks, const void* edge,
    const void* send, const void* pre, const void* d_aggr,
    const void* d_new_edge, const void* rowptr, const void* w1, const void* w2,
    const void* b2, const void* gamma, const void* ew1, const void* eb1,
    const void* ew2, const void* eb2, const void* eg, const void* ebt,
    void* d_send, void* d_edge, void* d_recproj, void* presum, void* ws_main,
    void* out_main, void* ws_edge, void* out_edge, void* stream) {
  if (num_rec <= 0 || n_edges <= 0 || batch < 1 || batch > kRecRows ||
      feat > kMaxFeat || max_blocks <= 0 || edge_mode < 0 || edge_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool batched = edge_mode == EDGE_BATCHED;

  MainParams m;
  m.edge = static_cast<const float*>(edge);
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
  m.d_edge = static_cast<float*>(d_edge);
  m.presum = static_cast<float*>(presum);
  m.d_recproj = static_cast<float*>(d_recproj);
  m.ws = static_cast<float*>(ws_main);
  m.num_rec = num_rec;
  m.batch = batch;
  m.recv_per_block = kRecRows / batch;
  m.edges_per_tile = kTileRows / batch;
  m.num_chunks = (num_rec + m.recv_per_block - 1) / m.recv_per_block;
  m.propagation = propagation;
  m.layer_norm = layer_norm;
  const int main_blocks = m.num_chunks < max_blocks ? m.num_chunks : max_blocks;
  cudaError_t err = batched ? launch_main<true>(m, main_blocks, s)
                            : launch_main<false>(m, main_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_reduce(m.ws, main_blocks, kMainStride, 3,
                      static_cast<float*>(out_main), s);
  if (err != cudaSuccess || batched) return static_cast<int>(err);

  EdgeParams e;
  e.edge = m.edge;
  e.presum = m.presum;
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
  const int n_tiles = (n_edges + kTileRows - 1) / kTileRows;
  const int edge_blocks = n_tiles < max_blocks ? n_tiles : max_blocks;
  err = edge_mode == EDGE_RAW ? launch_edge<true>(e, edge_blocks, s)
                              : launch_edge<false>(e, edge_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_reduce(e.ws, edge_blocks, kEdgeStride, 2,
                                        static_cast<float*>(out_edge), s));
}
