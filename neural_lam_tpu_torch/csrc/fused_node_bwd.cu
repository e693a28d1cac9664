// The node-MLP backward of the fused edge phase's epilogue
// (NEURAL_LAM_TPU_FUSED_AGGR=on), launched before K4.
//
// Replaces the node_epilogue part of
// neural_lam_tpu/ops/pallas_fused.py::_fused_bwd_impl (its pallas_call at
// :1298): the block of _fused_bwd_kernel at :509-599, whose operands and
// outputs _fused_bwd_impl adds at :1206-1212 and :1258-1283 and
// make_fused_interaction folds at :1567-1600. K3 with the epilogue
// (fused_edge.cu) returned, per (receiver, b) row,
//
//   pre    = rec . War + aggr . Wag + ba1,   h = SiLU(pre)
//   z      = h . Wa2 + ba2,                  x_hat = LN(z) without its affine
//   node   = rec + x_hat * gn + bn            (LN optional)
//
// and saved the float32 aggregate aggr. From d_node, the gradient of node,
// this kernel recomputes pre, h and x_hat from rec and aggr and forms
//
//   dz     = LayerNorm backward of d_node at z (d_node without LN);
//            dgn += d_node * x_hat, dbn += d_node
//   d_h    = dz . Wa2^T,  dWa2 += h^T . dz,  dba2 += dz
//   d_pre  = d_h * SiLU'(pre),  dba1 += d_pre
//   d_aggr = d_pre . Wag^T                    (K4's d_aggr, in the streams' type)
//   d_rec  = d_node + d_pre . War^T           (added to K4's receiver gradient)
//   dWar  += rec^T . d_pre,  dWag += aggr^T . d_pre
//
// with the weight gradients in nn.Linear's (out, in) layout, dWa1 = [dWar |
// dWag]. The JAX kernel runs this as the prologue of each output block of K4;
// here it is a launch of its own, before K4, because K4's main kernel uses
// 218 of 227 KB of shared memory and reads d_aggr once per edge (so each row
// must exist before any of its edges is reached), and K4 then keeps its 21
// instantiations. The function is the JAX kernel's; the
// layout is the card's: the rows are a plain (rows, 64) array with no graph
// structure, so a block is one group of 4 warps over tiles of 64 rows, 16
// rows a warp in the row-fragment layout of tc_tf32.cuh.
//
// Design.
//   * The row products (the forward again, d_h, d_aggr and d_rec) run on the
//     tensor cores with mma.sync, their weights read from device memory
//     through L1 (tc::gemm<true>, tc::gemm_t<true> for the transposed
//     products), so that shared memory holds two tiles and the block's
//     weight-gradient sums and two blocks fit on an SM.
//   * The weight gradients are products over a tile's rows (tc::gemm_tn) of
//     two staged tiles: h and dz, then d_pre and rec, then d_pre and aggr.
//     Each warp adds its 16 output rows of each into the block's sums in
//     shared memory, and the bias and LayerNorm gradients into its own column
//     slots; a block takes the tiles blockIdx.x, blockIdx.x + gridDim.x, ...,
//     writes its sums once to a (blocks, kStride) workspace, and K4's reduce
//     kernel sums the workspace in block order: deterministic, no float
//     atomics.
//   * 3xTF32 at float32 accuracy, or with BF bf16 operands in one TF32 pass
//     (the JAX kernel's cdt: every product's operands rounded to bf16, the
//     sums float32); SiLU, the LayerNorm, the bias sums and the residual are
//     float32. rec, d_node and d_aggr are of the streams' type TI (bf16 under
//     mixed precision and high, float32 otherwise), as the JAX kernel takes
//     d_node in io_dt; aggr and d_rec are float32.
//
// Bound on the H100: operations (nine 64x64 products a row, 3xTF32) or the
// bytes of rec, aggr, d_node, d_aggr and d_rec (five rows a row), about the
// same at batch 4 in float32.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_common.cuh"
#include "tc_tf32.cuh"

namespace {

using fused_edge::D;
using fused_edge::kLnEps;
using fused_edge::kMat;
using fused_edge::kTileRows;
using fused_edge::silu;
using fused_edge::silu_grad;
using tc::kWld;

constexpr int kWarps = 4;  // a block is one group of 4 warps over 64-row tiles
constexpr int kBlockThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 2;
// floats per block in the workspace (the wrapper sizes it the same):
// dWar dWag dWa2 as (out, in) | dba1 dba2 dgn dbn
constexpr int kStride = 3 * kMat + 4 * D;

template <typename TI>
struct Params {
  const TI* rec;       // (rows, D)
  const float* aggr;   // (rows, D), saved by K3
  const TI* d_node;    // (rows, D)
  const float* wa1;    // (D, 2D) [War | Wag]
  const float* ba1;
  const float* wa2;    // (D, D)
  const float* ba2;
  const float* gn;     // null without the LayerNorm
  TI* d_aggr;          // (rows, D)
  float* d_rec;        // (rows, D)
  float* ws;           // (gridDim.x, kStride)
  int rows;
  int layer_norm;
};

// Shared-memory plan, in floats: the block's three weight-gradient sums and
// two 64-row tiles (row stride kWld), the warps' column slots (dba1 dba2
// dgn dbn each) and ba1 ba2 gn.
struct Smem {
  int acc, t1, t2, slots, vec, total;
};

__host__ __device__ constexpr Smem smem_plan() {
  Smem s{};
  int o = 0;
  s.acc = o; o += 3 * D * kWld;
  s.t1 = o; o += kTileRows * kWld;
  s.t2 = o; o += kTileRows * kWld;
  s.slots = o; o += kWarps * 4 * D;
  s.vec = o; o += 3 * D;
  s.total = o;
  return s;
}

constexpr int smem_bytes() { return smem_plan().total * static_cast<int>(sizeof(float)); }

// acc_m += a^T . g over the staged tiles for the warp's 16 output rows of
// weight-gradient sum m (held in shared memory; read, added, written back
// by this warp alone)
template <bool BF>
__device__ __forceinline__ void add_weight_grad(float* acc_m, const float* a, const float* g,
                                                int r_base) {
  float acc[8][4];
  tc::load_rows<false>(acc, acc_m, kWld, r_base, D);
  tc::gemm_tn<BF>(acc, a, r_base, g);
  tc::store_rows(acc_m, kWld, acc, r_base, D);
}

template <bool BF, typename TI>
__global__ void __launch_bounds__(kBlockThreads, kBlocksPerSm)
fused_node_bwd(const Params<TI> p) {
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr Smem L = smem_plan();
  float* sAcc = sm + L.acc;  // dWar | dWag | dWa2, 64 rows each
  float* sT1 = sm + L.t1;
  float* sT2 = sm + L.t2;
  const float* sBa1 = sm + L.vec;
  const float* sBa2 = sBa1 + D;
  const float* sGn = sBa1 + 2 * D;
  for (int i = threadIdx.x; i < 3 * D * kWld; i += kBlockThreads) sAcc[i] = 0.0f;
  for (int i = threadIdx.x; i < kWarps * 4 * D; i += kBlockThreads) sm[L.slots + i] = 0.0f;
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L.vec;
    v[c] = p.ba1[c];
    v[D + c] = p.ba2[c];
    v[2 * D + c] = p.layer_norm ? p.gn[c] : 1.0f;
  }

  const int warp = threadIdx.x >> 5;
  const int r_base = 16 * warp;  // the warp's first row of a tile, and of each dW
  float* slot = sm + L.slots + warp * 4 * D;  // this warp's dba1 | dba2 | dgn | dbn
  const int n_tiles = (p.rows + kTileRows - 1) / kTileRows;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    const int nrows = min(kTileRows, static_cast<int>(p.rows - row0));
    __syncthreads();  // the last tile is done with T1 and T2 (and the set-up)
    float x[8][4], y[8][4], z[8][4], rstd[2];

    // ---- the node MLP again: y = pre, x = h, z = x_hat -----------------------
    tc::load_rows<true>(x, p.rec + row0 * D, D, r_base, nrows);
    tc::zero(y);
    tc::gemm<true, BF>(y, x, p.wa1, 2 * D);
    tc::load_rows<true>(x, p.aggr + row0 * D, D, r_base, nrows);
    tc::gemm<true, BF>(y, x, p.wa1 + D, 2 * D);
    tc::add_cols(y, sBa1);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[n][j] = silu(y[n][j]);
    tc::zero(z);
    tc::gemm<true, BF>(z, x, p.wa2, D);
    tc::add_cols(z, sBa2);
    if (p.layer_norm) tc::layer_norm(z, nullptr, nullptr, kLnEps, rstd);
    tc::store_rows(sT1, kWld, x, r_base, kTileRows);  // T1 = h

    // ---- dz through the LayerNorm into T2 (rows past nrows: d_node 0) ------
    tc::load_rows<true>(x, p.d_node + row0 * D, D, r_base, nrows);
    if (p.layer_norm) {
      tc::add_col_sums(slot + 2 * D, x, z);  // dgn
      tc::add_col_sums(slot + 3 * D, x);     // dbn
      tc::layer_norm_bwd(x, z, rstd, sGn);
    }
    tc::add_col_sums(slot + D, x);  // dba2
    tc::store_rows(sT2, kWld, x, r_base, kTileRows);
    __syncthreads();  // T1 = h, T2 = dz
    add_weight_grad<BF>(sAcc + 2 * D * kWld, sT2, sT1, r_base);  // dWa2

    // ---- d_h = dz . Wa2^T, d_pre = d_h * SiLU'(pre) into z -------------------
    tc::zero(z);
    tc::gemm_t<true, BF>(z, x, p.wa2, D);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[n][j] *= silu_grad(y[n][j]);
    tc::add_col_sums(slot, z);  // dba1
    __syncthreads();  // done with h and dz

    // ---- dWar += rec^T . d_pre, dWag += aggr^T . d_pre ------------------------
    tc::store_rows(sT2, kWld, z, r_base, kTileRows);
    tc::load_rows<true>(x, p.rec + row0 * D, D, r_base, nrows);
    tc::store_rows(sT1, kWld, x, r_base, kTileRows);
    __syncthreads();  // T1 = rec, T2 = d_pre
    add_weight_grad<BF>(sAcc, sT2, sT1, r_base);
    __syncthreads();  // done with rec
    tc::load_rows<true>(x, p.aggr + row0 * D, D, r_base, nrows);
    tc::store_rows(sT1, kWld, x, r_base, kTileRows);
    __syncthreads();  // T1 = aggr
    add_weight_grad<BF>(sAcc + D * kWld, sT2, sT1, r_base);

    // ---- d_aggr = d_pre . Wag^T, d_rec = d_node + d_pre . War^T -------------
    tc::zero(x);
    tc::gemm_t<true, BF>(x, z, p.wa1 + D, 2 * D);
    tc::store_rows(p.d_aggr + row0 * D, D, x, r_base, nrows);
    tc::load_rows<true>(x, p.d_node + row0 * D, D, r_base, nrows);
    tc::gemm_t<true, BF>(x, z, p.wa1, 2 * D);
    tc::store_rows(p.d_rec + row0 * D, D, x, r_base, nrows);
  }

  // ---- the block's sums, once ------------------------------------------------
  __syncthreads();  // every warp's rows and slots are final
  float* ws = p.ws + static_cast<long long>(blockIdx.x) * kStride;
  for (int i = threadIdx.x; i < 3 * kMat; i += kBlockThreads) {
    const int m = i / kMat, r = (i - m * kMat) / D, c = i & (D - 1);
    ws[i] = sAcc[(m * D + r) * kWld + c];
  }
  for (int i = threadIdx.x; i < 4 * D; i += kBlockThreads) {
    float s = 0.0f;
    for (int w = 0; w < kWarps; ++w) s += sm[L.slots + w * 4 * D + i];
    ws[3 * kMat + i] = s;
  }
}

template <bool BF, typename TI>
cudaError_t launch(const Params<TI>& p, int blocks, float* out, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = fused_edge::allow_smem(fused_node_bwd<BF, TI>, smem_bytes());
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  fused_node_bwd<BF, TI><<<blocks, kBlockThreads, smem_bytes(), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return fused_edge::launch_reduce(p.ws, blocks, kStride, out, stream);
}

template <bool BF, typename TI>
cudaError_t run(int rows, int layer_norm, int blocks, const void* rec, const void* aggr,
                const void* d_node, const void* wa1, const void* ba1, const void* wa2,
                const void* ba2, const void* gn, void* d_aggr, void* d_rec, void* ws,
                void* out, void* stream) {
  if (rows <= 0 || blocks <= 0 || (layer_norm && gn == nullptr)) return cudaErrorInvalidValue;
  Params<TI> p;
  p.rec = static_cast<const TI*>(rec);
  p.aggr = static_cast<const float*>(aggr);
  p.d_node = static_cast<const TI*>(d_node);
  p.wa1 = static_cast<const float*>(wa1);
  p.ba1 = static_cast<const float*>(ba1);
  p.wa2 = static_cast<const float*>(wa2);
  p.ba2 = static_cast<const float*>(ba2);
  p.gn = static_cast<const float*>(gn);
  p.d_aggr = static_cast<TI*>(d_aggr);
  p.d_rec = static_cast<float*>(d_rec);
  p.ws = static_cast<float*>(ws);
  p.rows = rows;
  p.layer_norm = layer_norm;
  return launch<BF, TI>(p, blocks, static_cast<float*>(out), static_cast<cudaStream_t>(stream));
}

}  // namespace

// Shapes (contiguous and 16-byte aligned on the device; D = 64):
//   rec, d_node, d_aggr: (rows, D) in float32, or bf16 with io_bf16 (which
//     needs bf16_ops); aggr, d_rec: (rows, D) float32; rows = num_rec * B
//   wa1: (D, 2D), ba1: (D,), wa2: (D, D), ba2, gn: (D,), float32; gn null
//     without the LayerNorm
//   ws: (blocks, 3 D^2 + 4 D) float32 scratch; out (3 D^2 + 4 D,): dWar,
//     dWag, dWa2 as (out, in), then dba1, dba2, dgn, dbn (summed in block
//     order)
// Returns the CUDA error of the launches (0 on success).
extern "C" int nl_fused_node_bwd(int bf16_ops, int io_bf16, int rows, int layer_norm,
                                 int blocks, const void* rec, const void* aggr,
                                 const void* d_node, const void* wa1, const void* ba1,
                                 const void* wa2, const void* ba2, const void* gn, void* d_aggr,
                                 void* d_rec, void* ws, void* out, void* stream) {
#define NL_NODE_BWD_ARGS \
  rows, layer_norm, blocks, rec, aggr, d_node, wa1, ba1, wa2, ba2, gn, d_aggr, d_rec, ws, out, stream
  cudaError_t err;
  if (!bf16_ops)
    err = io_bf16 ? cudaErrorInvalidValue : run<false, float>(NL_NODE_BWD_ARGS);
  else if (io_bf16)
    err = run<true, __nv_bfloat16>(NL_NODE_BWD_ARGS);
  else
    err = run<true, float>(NL_NODE_BWD_ARGS);
#undef NL_NODE_BWD_ARGS
  return static_cast<int>(err);
}
