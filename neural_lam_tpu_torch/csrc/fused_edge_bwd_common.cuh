// Shared pieces of the fused edge-phase backward kernels K4
// (fused_edge_bwd.cu) and K8 (fused_edge_v2_bwd.cu): the edge input's
// share after their main kernels, and the reduce of their workspaces.
//
// The main kernels write d_pre[e, b] (a batched edge input) or s[e] =
// sum_b d_pre[e, b] (the per-edge edge inputs, EDGE_RAW and EDGE_SHARED).
// From d_pre, fused_edge_bwd_rows forms d_edge[e, b] = d_pre . W1e^T (+
// d_new_edge[e, b]) and dW1e += edge^T . d_pre per (edge, b) row on the
// tensor cores (tc_tf32.cuh). From s, the edge kernel forms
//
//   dW1e += edge_val^T . s
//   EDGE_SHARED  d_edge[e] = s[e] . W1e^T (+ sum_b d_new_edge[e, b])
//   EDGE_RAW     the embedder is recomputed per edge and d_edge_val goes
//                through its LayerNorm, second and first layer into its six
//                weight gradients (the raw features are constants)
//
// in tiles of 64 edges, B times smaller than the main kernel's streams, on
// the SIMT units. Every block (or group of warps) keeps its share of each
// weight gradient in registers and writes it once to a (blocks, stride)
// workspace; reduce_workspace sums the workspace over the blocks in block
// order, so the gradients are deterministic without float atomics.
//
// The reduced-precision instantiations (BF, K4's bf16 variants): the edge
// stream, d_new_edge and d_edge are of type TI (bf16 or float32), and every
// product takes bf16 operands with float32 sums: the tensor-core products
// round in tc_tf32.cuh, the SIMT products round their operands as they are
// staged in shared memory (weights, edge values, the embedder's a1, dz and
// d_p1). s[e] is then the sum over the batch of d_pre rounded to bf16 (the
// main kernel's), and enters the products as it is: the JAX kernel's
// d_pre . W1e over a column-tiled weight sums the same bf16 products.

#pragma once

#include "fused_edge_common.cuh"
#include "tc_tf32.cuh"

namespace fused_edge {

constexpr int kMat = D * D;
// floats per block in the edge kernel's workspace (the wrappers size it the
// same): dW1e dEW2 | dEW1 as (D, kMaxFeat) | deb1 deb2 deg debt
constexpr int kEdgeStride = 2 * kMat + kMaxFeat * D + 4 * D;

template <typename TI>
struct EdgeParamsT {
  const TI* edge;        // (E, feat) raw features or (E, D)
  const float* presum;   // (E, D)
  const TI* d_new_edge;  // (E, B, D) or null
  const float* w1;
  const float* ew1;
  const float* eb1;
  const float* ew2;
  const float* eb2;
  const float* eg;
  const float* ebt;
  TI* d_edge;  // (E, D), EDGE_SHARED only
  float* ws;   // (gridDim.x, kEdgeStride)
  int n_edges;
  int batch;
  int feat;
};
using EdgeParams = EdgeParamsT<float>;

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

constexpr int edge_smem_floats(bool raw) {
  return kMat + (raw ? 2 * kMat + kMaxFeat * D + 4 * D : 0) +
         (raw ? 3 : 2) * kTileRows * kLd + (raw ? kTileRows * kMaxFeat : 0);
}

template <bool RAW, bool BF = false, typename TI = float>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_bwd_edge(const EdgeParamsT<TI> p) {
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

  load_weight_raw<BF>(sW1e, p.w1, 3 * D, 0);
  if (RAW) {
    load_weight_t<BF>(sEW2t, D, p.ew2, D, 0);
    load_weight_raw<BF>(sEW2r, p.ew2, D, 0);
    for (int i = tid; i < F * D; i += kThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      const float w = __ldg(p.ew1 + c * F + k);
      sEW1[i] = BF ? tc::bf16r(w) : w;
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
      for (int i = tid; i < kTileRows * F; i += kThreads) {
        const float f = i < ne * F ? tc::ldg_val(p.edge + static_cast<long long>(t0) * F + i)
                                   : 0.0f;
        sF[i] = BF ? tc::bf16r(f) : f;
      }
    } else {
      load_rows<BF>(sXe, p.edge + static_cast<long long>(t0) * D, ne, kTileRows);
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
      store_rows<BF>(sA1, acc, rg, cg);
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
      store_rows<BF>(sXe, acc, rg, cg);
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
          const TI* src = p.d_new_edge + static_cast<long long>(t0 + el) * B * D + 4 * cg;
          for (int b = 0; b < B; ++b) {
            const float4 n = ldg4(src + b * D);
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
          tc::store4(p.d_edge + static_cast<long long>(t0 + el) * D + 4 * cg,
                     make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]));
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
    store_rows<BF>(sS, acc, rg, cg);
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
    store_rows<BF>(sS, acc, rg, cg);
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
template <bool BF = false, typename TI = float>
inline cudaError_t launch_edge_phase(int edge_mode, const EdgeParamsT<TI>& e,
                                     int max_blocks, float* out, cudaStream_t stream) {
  const int n_tiles = (e.n_edges + kTileRows - 1) / kTileRows;
  const int blocks = n_tiles < max_blocks ? n_tiles : max_blocks;
  const bool raw = edge_mode == EDGE_RAW;
  const int bytes =
      edge_smem_floats(raw) * static_cast<int>(sizeof(float));
  cudaError_t err = raw ? allow_smem(fused_edge_bwd_edge<true, BF, TI>, bytes)
                        : allow_smem(fused_edge_bwd_edge<false, BF, TI>, bytes);
  if (err != cudaSuccess) return err;
  if (raw)
    fused_edge_bwd_edge<true, BF, TI><<<blocks, kThreads, bytes, stream>>>(e);
  else
    fused_edge_bwd_edge<false, BF, TI><<<blocks, kThreads, bytes, stream>>>(e);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(e.ws, blocks, kEdgeStride, 2, out, stream);
}

// The batched edge input's share, over 64-row tiles of (edge, b) rows:
// d_edge = d_pre . W1e (+ d_new_edge) and dW1e += edge^T . d_pre, on the
// tensor cores (the main kernels' d_pre rows). A block of 16 warps holds
// W1e^T once and runs four groups of 4 warps; group i takes the tiles i,
// i + groups, ... (a fixed assignment: deterministic partial sums) and
// keeps a 16 x 64 share of dW1e per warp in registers.
constexpr int kRowGroupThreads = 128;  // a group is one warpgroup
constexpr int kRowGroups = 4;
constexpr int kRowThreads = kRowGroups * kRowGroupThreads;

struct RowsPlan {
  int w1et, groups, group_floats, total;
};

__host__ __device__ constexpr RowsPlan rows_plan() {
  RowsPlan s{};
  s.w1et = 0;
  s.groups = 2 * tc::kWgHalf;  // W1e^T, split for wgmma
  s.group_floats = 2 * kTileRows * tc::kWld;  // edge rows, d_pre rows
  s.total = s.groups + kRowGroups * s.group_floats;
  return s;
}

constexpr int rows_smem_bytes() { return rows_plan().total * static_cast<int>(sizeof(float)); }

template <typename TI>
struct RowsParamsT {
  const TI* edge;        // (rows, D)
  const float* d_pre;    // (rows, D)
  const TI* d_new_edge;  // (rows, D) or null
  const float* w1;
  TI* d_edge;  // (rows, D)
  float* ws;   // (gridDim.x * kRowGroups, kMat)
  int rows;
};
using RowsParams = RowsParamsT<float>;

template <bool BF = false, typename TI = float>
__global__ void __launch_bounds__(kRowThreads, 1)
fused_edge_bwd_rows(const RowsParamsT<TI> p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr RowsPlan L = rows_plan();
  tc::load_weight_wg<true, false, false, BF>(sm + L.w1et, p.w1, 3 * D, 0,
                                             kRowThreads);  // W1e^T
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

  float dW1e[8][4];
  tc::zero(dW1e);
  for (int tile = gi; tile < n_tiles; tile += gridDim.x * kRowGroups) {
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    const int nrows = min(kTileRows, static_cast<int>(p.rows - row0));
    float g[8][4], x[8][4];
    tc::load_rows<true>(g, p.d_pre + row0 * D, D, r_base, nrows);
    tc::load_rows<true>(x, p.edge + row0 * D, D, r_base, nrows);
    tc::store_rows(sG, tc::kWld, g, r_base, kTileRows);
    tc::store_rows(sE, tc::kWld, x, r_base, kTileRows);
    tc::group_sync(bar, kRowGroupThreads);  // the tile's rows are staged
    tc::gemm_tn<BF>(dW1e, sG, r_base, sE);
    tc::group_sync(bar, kRowGroupThreads);  // done with them
    tc::load_rows<false>(g, sG, tc::kWld, r_base, kTileRows);  // the warp's own d_pre rows
    if (p.d_new_edge != nullptr)
      tc::load_rows<true>(x, p.d_new_edge + row0 * D, D, r_base, nrows);
    else
      tc::zero(x);
    tc::gemm_wg<4, BF>(x, g, sm + L.w1et);  // d_edge
    tc::store_rows(sE, tc::kWld, x, r_base, kTileRows);
    tc::copy_out_rows(p.d_edge + row0 * D, sE, r_base, nrows);
  }
  tc::store_rows(p.ws + static_cast<long long>(gi) * kMat, D, dW1e, r_base, D);
}


// The rows kernel on `blocks` blocks and its reduce (ws is (blocks *
// kRowGroups, kMat)); out (kMat,) = dW1e as (out, in). Static: the flag
// below must belong to this library's own kernel (the function-local
// static of an inline function is one object across every library
// loaded into the process).
template <bool BF = false, typename TI = float>
static inline cudaError_t launch_rows(const RowsParamsT<TI>& r, int blocks, float* out,
                                      cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = allow_smem(fused_edge_bwd_rows<BF, TI>, rows_smem_bytes());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  fused_edge_bwd_rows<BF, TI><<<blocks, kRowThreads, rows_smem_bytes(), stream>>>(r);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return launch_reduce(r.ws, blocks * kRowGroups, kMat, 0, out, stream);
}

}  // namespace fused_edge
