// Shared pieces of the fused edge-phase backward kernels: K8
// (fused_edge_v2_bwd.cu), and the edge pass and the reduce that K4
// (fused_edge_bwd.cu) shares with it.
//
// K8 runs a main kernel over receiver chunks whose tile walk starts with
// the three steps below; K8 and K4 leave, for the per-edge edge inputs
// (EDGE_RAW, EDGE_SHARED), s[e] = sum_b d_pre[e, b] in an (E, D) scratch.
// The edge kernel here then forms, from s,
//
//   dW1e += edge_val^T . s
//   EDGE_SHARED  d_edge[e] = s[e] . W1e^T (+ sum_b d_new_edge[e, b])
//   EDGE_RAW     the embedder is recomputed per edge and d_edge_val goes
//                through its LayerNorm, second and first layer into its six
//                weight gradients (the raw features are constants)
//
// in tiles of 64 edges, B times smaller than the main kernel's streams.
// Every block keeps its share of each weight gradient in registers and
// writes it once to a (blocks, stride) workspace; reduce_workspace sums the
// workspace over the blocks in block order, so the gradients are
// deterministic without float atomics.

#pragma once

#include "fused_edge_common.cuh"

namespace fused_edge {

constexpr int kMat = D * D;
// floats per block in the edge kernel's workspace (the wrappers size it the
// same): dW1e dEW2 | dEW1 as (D, kMaxFeat) | deb1 deb2 deg debt
constexpr int kEdgeStride = 2 * kMat + kMaxFeat * D + 4 * D;

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

// The main kernels' walk over a tile of 64 (edge, b) rows, the first
// nrows of them live, starting at row row0 of the (E, B, D) arrays, in
// three steps that K4 and K8 share:
//
// 1. the forward again from the saved pre: pr = pre, h1 = SiLU(pre) into
//    sH, z = h1 . W2 + b2 and, with layer_norm, its x_hat in xh and
//    1/sqrt(var + eps) in rstd. Ends with h1 visible to every thread.
__device__ __forceinline__ void forward_from_pre(float (&pr)[4][4], float (&xh)[4][4],
                                                 float (&rstd)[4], const float* pre,
                                                 long long row0, int nrows, float* sH,
                                                 const float* sW2t, const float* sB2,
                                                 int layer_norm, int rg, int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = rg + 16 * i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < nrows) v = __ldg(reinterpret_cast<const float4*>(pre + (row0 + m) * D) + cg);
    pr[i][0] = v.x; pr[i][1] = v.y; pr[i][2] = v.z; pr[i][3] = v.w;
#pragma unroll
    for (int j = 0; j < 4; ++j) xh[i][j] = silu(pr[i][j]);
  }
  store_rows(sH, xh, rg, cg);
  __syncthreads();
  zero(xh);
  mm_acc<4>(xh, sH, sW2t, rg, cg);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) xh[i][j] += sB2[4 * cg + j];
  if (layer_norm) row_layer_norm(xh, nullptr, nullptr, cg, 4, rstd);
}

// 2. d_msg of each row: d_aggr of its receiver (sDA holds the chunk's
//    receiver rows, sRloc the chunk-local receiver of each tile edge) plus
//    d_new_edge where it is given; zero on the rows past nrows.
__device__ __forceinline__ void message_grad(float (&dm)[4][4], const float* sDA,
                                             const int* sRloc, const float* d_new_edge,
                                             long long row0, int nrows, int B, int rg,
                                             int cg) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = rg + 16 * i;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m < nrows) {
      const int el = m / B, b = m - el * B;
      v = *reinterpret_cast<const float4*>(sDA + (sRloc[el] * B + b) * D + 4 * cg);
      if (d_new_edge != nullptr) {
        const float4 n =
            __ldg(reinterpret_cast<const float4*>(d_new_edge + (row0 + m) * D) + cg);
        v.x += n.x; v.y += n.y; v.z += n.z; v.w += n.w;
      }
    }
    dm[i][0] = v.x; dm[i][1] = v.y; dm[i][2] = v.z; dm[i][3] = v.w;
  }
}

// 3. from d_msg to d_pre: dz through the LayerNorm at z (dgamma, dbeta into
//    vec[1], vec[2]), db2 += dz into vec[0], dW2 += h1^T . dz, d_h1 = dz .
//    W2^T and d_pre = d_h1 * SiLU'(pre) into dpre, db1 into vec[3]. Leaves
//    dz in sG, which the caller may overwrite after a barrier.
__device__ __forceinline__ void d_pre_from_message(
    float (&dpre)[4][4], float (&dm)[4][4], const float (&xh)[4][4],
    const float (&rstd)[4], const float (&pr)[4][4], int layer_norm, const float* sGam,
    const float* sH, float* sG, const float* sW2r, float (&dW2)[4][4],
    float (&vec)[4][4], int rg, int cg) {
  if (layer_norm) row_layer_norm_bwd(dm, xh, rstd, sGam, cg, vec[1], vec[2]);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) vec[0][j] += dm[i][j];
  store_rows(sG, dm, rg, cg);
  __syncthreads();
  wgrad_acc(dW2, sH, sG, rg, cg);
  zero(dpre);
  mm_acc<4>(dpre, sG, sW2r, rg, cg);  // d_h1
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dpre[i][j] *= silu_grad(pr[i][j]);
      vec[3][j] += dpre[i][j];
    }
}

// 4. the edge input's share, with d_pre in sG: for a batched edge input
//    (its tile rows in sXe) dW1e += edge^T . d_pre and d_edge[e, b] =
//    d_pre . W1e^T (+ d_new_edge[e, b]); for the per-edge inputs s[e] =
//    sum_b d_pre[e, b] into presum, in b order, for the edge kernel below.
template <bool BATCHED>
__device__ __forceinline__ void edge_input_grad(float (&dW1e)[4][4], const float* sXe,
                                                const float* sG, const float* sW1e,
                                                const float* d_new_edge, float* d_edge,
                                                float* presum, long long row0, int t0,
                                                int ne, int nrows, int B, int rg, int cg) {
  if (!BATCHED) {
    for (int i = threadIdx.x; i < ne * D; i += kThreads) {
      const int el = i / D, c = i - el * D;
      float s = 0.0f;
      for (int b = 0; b < B; ++b) s += sG[(el * B + b) * kLd + c];
      presum[static_cast<long long>(t0) * D + i] = s;
    }
    return;
  }
  wgrad_acc(dW1e, sXe, sG, rg, cg);
  float acc[4][4];
  zero(acc);
  mm_acc<4>(acc, sG, sW1e, rg, cg);  // d_edge
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = rg + 16 * i;
    if (m >= nrows) continue;
    float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    if (d_new_edge != nullptr) {
      const float4 n =
          __ldg(reinterpret_cast<const float4*>(d_new_edge + (row0 + m) * D) + cg);
      v.x += n.x; v.y += n.y; v.z += n.z; v.w += n.w;
    }
    *reinterpret_cast<float4*>(d_edge + (row0 + m) * D + 4 * cg) = v;
  }
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

inline cudaError_t launch_reduce(const float* ws, int n_blocks, int stride, int n_mat,
                          float* out, cudaStream_t stream) {
  reduce_workspace<<<(stride + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      ws, n_blocks, stride, n_mat, out);
  return cudaGetLastError();
}

// The edge kernel and its reduce for EDGE_RAW or EDGE_SHARED, on at most
// max_blocks persistent blocks; out (kEdgeStride,) = dW1e, dEW2 as (out, in)
// | dEW1 as (D, 8) | deb1 deb2 deg debt.
inline cudaError_t launch_edge_phase(int edge_mode, const EdgeParams& e, int max_blocks,
                              float* out, cudaStream_t stream) {
  const int n_tiles = (e.n_edges + kTileRows - 1) / kTileRows;
  const int blocks = n_tiles < max_blocks ? n_tiles : max_blocks;
  const bool raw = edge_mode == EDGE_RAW;
  const int bytes =
      edge_smem_floats(raw) * static_cast<int>(sizeof(float));
  cudaError_t err = raw ? allow_smem(fused_edge_bwd_edge<true>, bytes)
                        : allow_smem(fused_edge_bwd_edge<false>, bytes);
  if (err != cudaSuccess) return err;
  if (raw)
    fused_edge_bwd_edge<true><<<blocks, kThreads, bytes, stream>>>(e);
  else
    fused_edge_bwd_edge<false><<<blocks, kThreads, bytes, stream>>>(e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(e.ws, blocks, kEdgeStride, 2, out, stream);
}

}  // namespace fused_edge
