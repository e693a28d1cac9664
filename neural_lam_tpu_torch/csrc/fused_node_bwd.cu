// The node-MLP backward of the node-MLP route (NEURAL_LAM_TPU_FUSED_AGGR=on),
// launched before K4.
//
// Replaces the node_epilogue part of
// neural_lam_tpu/ops/pallas_fused.py::_fused_bwd_impl (its pallas_call at
// :1298): the block of _fused_bwd_kernel at :509-599, whose operands and
// outputs _fused_bwd_impl adds at :1206-1212 and :1258-1283 and
// make_fused_interaction folds at :1567-1600. The node update
// (fused_node.cu) returned, per (receiver, b) row,
//
//   pre    = rec . War + aggr . Wag + ba1,   h = SiLU(pre)
//   z      = h . Wa2 + ba2,                  x_hat = LN(z) without its affine
//   node   = rec + x_hat * gn + bn            (LN optional)
//
// from the float32 aggregate aggr that K3 wrote. From d_node, the gradient
// of node, this kernel recomputes pre, h and x_hat from rec and aggr and
// forms
//
//   dz     = LayerNorm backward of d_node at z (d_node without LN);
//            dgn += d_node * x_hat, dbn += d_node
//   d_h    = dz . Wa2^T,  dWa2 += dz^T . h,  dba2 += dz
//   d_pre  = d_h * SiLU'(pre),  dba1 += d_pre
//   d_aggr = d_pre . Wag^T                    (K4's d_aggr, in the streams' type)
//   d_rec  = d_node + d_pre . War^T           (added to K4's receiver gradient)
//   dWar  += d_pre^T . rec,  dWag += d_pre^T . aggr
//
// with the weight gradients in nn.Linear's (out, in) layout, dWa1 = [dWar |
// dWag]. The JAX kernel runs this as the prologue of each output block of
// K4; here it is a launch of its own, before K4, because K4 reads d_aggr
// once per edge (so each row must exist before any of its edges is
// reached).
//
// Design: the frame of csrc/fused_node.cuh (persistent blocks, one an SM,
// walking 64-row tiles with War, Wag and Wa2 resident in shared memory), and
// the chain split in two:
//   * kRowGroups "row" warpgroups run the chain of a tile in registers: the
//     forward again and the x . W^T products on wgmma (tc::gemm_wg, 3xTF32
//     on the split weights; BF: bf16 m64n64k16), the LayerNorm's backward,
//     and the transposed products d_h, d_aggr and d_rec as mma.sync on the
//     same split weights (gemm_t_wg), or with BF on wgmma through the
//     transpose bit. Each row group stages rec, aggr, h, dz and d_pre of its
//     tile in a set of shared-memory tiles of its own (float32 rows, or bf16
//     tiles in the core layout with BF), adds the bias and LayerNorm
//     gradients into its warps' column slots, and writes d_aggr and d_rec.
//   * One "gradient" warpgroup forms the three weight-gradient products
//     over each staged tile, dz^T . h as soon as h and dz are staged, then
//     d_pre^T . rec and d_pre^T . aggr: mma.sync 3xTF32 (tc::gemm_tn, each
//     tile's share joining the sum on the float32 units), or with BF wgmma
//     on the bf16 tiles (tcb::gemm_tn_issue). It keeps the three 64 x 64
//     sums in registers, warp w the output rows 16 w .. 16 w + 15 of each,
//     across all of the block's tiles and writes them once at the end.
//     (Moving d_aggr and d_rec to this group as well was 4 % faster on an
//     H100 and spilled 48 bytes a thread in the BF kernels: the float32
//     kernel is bound by the SM's mma.sync and shared-memory throughput,
//     which both groups share, not by the row chain's latency.)
//   * Named barriers hand a set over: the row group waits until the
//     gradient group is done with its set (bar_free), stages, and arrives on
//     bar_staged1 (h, dz, rec, aggr) and bar_staged2 (d_pre) without
//     waiting; the gradient group waits on those and arrives on bar_free
//     when its products have read the set. The row group meanwhile forms
//     d_aggr and d_rec and starts the next tile.
//   * Block b takes tiles b, b + gridDim.x, ...; the k-th of them goes to
//     row group k % kRowGroups, and the gradient group takes them in that
//     order, so every sum is in a fixed order. The block writes its sums
//     once to a (blocks, kStride) workspace and the reduce kernel
//     (fused_edge_bwd_common.cuh) sums them in block order: no float
//     atomics, and the bits repeat from launch to launch.
//   * float32 at 3xTF32 accuracy; with BF every product's operands rounded
//     to bf16 (the JAX kernel's cdt), the sums float32. SiLU, the
//     LayerNorm, the bias sums and the residual are float32 in every
//     precision. rec, d_node and d_aggr are of the streams' type TI (bf16
//     under mixed precision and high, float32 otherwise), as the JAX kernel
//     takes d_node in io_dt; aggr and d_rec are float32.
//
// Bound on the H100: operations (nine 64 x 64 products a row, 3xTF32, or at
// the bf16 rate) or the bytes of rec, aggr, d_node, d_aggr and d_rec (five
// rows a row), the operations about 1.5x the bytes at batch 4 in float32.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_common.cuh"
#include "fused_node.cuh"

namespace {

using fused_edge::silu;
using fused_edge::silu_grad;
using namespace fused_node;

// row warpgroups a block (one gradient warpgroup beside them): float32
// 96 KB of weights and 90 KB a set of staged tiles leave room for one;
// BF, 24 KB and 40 KB, for two (384 threads, up to 168 registers a thread)
constexpr int kRowGroups = 1;
constexpr int kRowGroupsBf = 2;

__host__ __device__ constexpr int row_groups(bool bf) { return bf ? kRowGroupsBf : kRowGroups; }
__host__ __device__ constexpr int block_threads(bool bf) {
  return (row_groups(bf) + 1) * kGroupThreads;
}

// floats per block in the workspace (the wrapper sizes it the same):
// dWar dWag dWa2 as (out, in) | dba1 dba2 dgn dbn
constexpr int kStride = 3 * kMat + 4 * D;

// the named barriers of row group r (0 is __syncthreads): its set is free,
// h, dz, rec and aggr are staged, d_pre is staged
__device__ __forceinline__ int bar_free(int r) { return 1 + 3 * r; }
__device__ __forceinline__ int bar_staged1(int r) { return 2 + 3 * r; }
__device__ __forceinline__ int bar_staged2(int r) { return 3 + 3 * r; }
constexpr int kPair = 2 * kGroupThreads;  // a row group and the gradient group

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

// Shared-memory plan, in floats: the three weights, ba1 ba2 gn, the row
// warps' column slots (dba1 dba2 dgn dbn each), then per row group its set
// of five staged tiles: rec, aggr, h, dz, d_pre (float32 rows of stride
// kWld, or with BF bf16 tiles in the core layout)
template <bool BF>
struct Plan {
  static constexpr int vec = 3 * weight_floats(BF);
  static constexpr int slots = vec + 3 * D;
  static constexpr int sets = slots + row_groups(BF) * 4 * 4 * D;
  static constexpr int tile = BF ? tcb::kMatFloats : kTileRows * kWld;
  static constexpr int set_floats = 5 * tile;
  static constexpr int total = sets + row_groups(BF) * set_floats;
  static constexpr int bytes = total * 4;
};
enum Staged { kRec = 0, kAggr = 1, kH = 2, kDz = 3, kDpre = 4 };

// a fragment into staged tile `which` of a set: float32 rows, or with BF
// its packed fragment into a bf16 tile (a: the packed fragment, formed here)
template <bool BF>
__device__ __forceinline__ void stage(float* set, int which, const float (&x)[8][4],
                                      uint32_t (&a)[4][4], int r_base) {
  float* t = set + which * Plan<BF>::tile;
  if constexpr (BF) {
    tcb::pack_frag(a, x);
    tcb::store_tile(reinterpret_cast<tcb::bf16*>(t), a, r_base);
  } else {
    tc::store_rows(t, kWld, x, r_base, kTileRows);
  }
}

template <bool BF, typename TI>
__device__ __forceinline__ void row_group(const Params<TI>& p, float* sm, int r, int tg) {
  using L = Plan<BF>;
  constexpr int kW = weight_floats(BF);
  const float* sWar = sm;
  const float* sWag = sm + kW;
  const float* sWa2 = sm + 2 * kW;
  const float* sBa1 = sm + L::vec;
  const float* sBa2 = sBa1 + D;
  const float* sGn = sBa1 + 2 * D;
  const int warp = tg >> 5;
  const int r_base = 16 * warp;
  float* slot = sm + L::slots + (r * 4 + warp) * 4 * D;  // dba1 | dba2 | dgn | dbn
  float* set = sm + L::sets + r * L::set_floats;
  const int n_tiles = (p.rows + kTileRows - 1) / kTileRows;
  for (int k = r;; k += row_groups(BF)) {
    const int tile = blockIdx.x + k * gridDim.x;
    if (tile >= n_tiles) break;
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    float x[8][4], y[8][4], z[8][4], dn[8][4], rstd[2];
    uint32_t a[4][4];
    const int nrows = min(kTileRows, static_cast<int>(p.rows - row0));

    // ---- pre = rec . War^T + aggr . Wag^T + ba1 into y ----------------------
    tc::load_rows<true>(x, p.rec + row0 * D, D, r_base, nrows);
    tc::load_rows<true>(z, p.aggr + row0 * D, D, r_base, nrows);
    tc::load_rows<true>(dn, p.d_node + row0 * D, D, r_base, nrows);
    tc::zero(y);
    row_product<BF>(y, x, sWar);
    row_product<BF>(y, z, sWag);
    tc::add_cols(y, sBa1);
    bar_sync(bar_free(r), kPair);  // the gradient group is done with the set
    stage<BF>(set, kRec, x, a, r_base);
    stage<BF>(set, kAggr, z, a, r_base);

    // ---- h = SiLU(pre), z = h . Wa2^T + ba2, x_hat --------------------------
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[n][j] = silu(y[n][j]);
    stage<BF>(set, kH, x, a, r_base);
    tc::zero(z);
    row_product<BF>(z, x, sWa2);
    tc::add_cols(z, sBa2);
    if (p.layer_norm) tc::layer_norm(z, nullptr, nullptr, kLnEps, rstd);

    // ---- dz through the LayerNorm (rows past nrows: d_node 0, so dz 0) -------
    if (p.layer_norm) {
      tc::add_col_sums(slot + 2 * D, dn, z);  // dgn
      tc::add_col_sums(slot + 3 * D, dn);     // dbn
      tc::layer_norm_bwd(dn, z, rstd, sGn);
    }
    tc::add_col_sums(slot + D, dn);  // dba2
    stage<BF>(set, kDz, dn, a, r_base);
    if (BF) tcb::fence_async();
    bar_arrive(bar_staged1(r), kPair);

    // ---- d_h = dz . Wa2, d_pre = d_h * SiLU'(pre) into z ---------------------
    tc::zero(z);
    t_product<BF>(z, dn, a, sWa2);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[n][j] *= silu_grad(y[n][j]);
    tc::add_col_sums(slot, z);  // dba1
    stage<BF>(set, kDpre, z, a, r_base);
    if (BF) tcb::fence_async();
    bar_arrive(bar_staged2(r), kPair);

    // ---- d_aggr = d_pre . Wag, d_rec = d_node + d_pre . War ------------------
    tc::zero(y);
    t_product<BF>(y, z, a, sWag);
    tc::store_rows(p.d_aggr + row0 * D, D, y, r_base, nrows);
    tc::load_rows<true>(x, p.d_node + row0 * D, D, r_base, nrows);
    t_product<BF>(x, z, a, sWar);
    tc::store_rows(p.d_rec + row0 * D, D, x, r_base, nrows);
  }
  bar_sync(bar_free(r), kPair);  // the gradient group's last arrival
}

// the gradient group: the three sums over the block's tiles, written once
// to the block's part of the workspace
template <bool BF, typename TI>
__device__ __forceinline__ void gradient_group(const Params<TI>& p, float* sm, int tg) {
  using L = Plan<BF>;
  const int o0 = 16 * (tg >> 5);  // the warp's output rows of each sum
  const int n_tiles = (p.rows + kTileRows - 1) / kTileRows;
  float acc[3][8][4];  // dWar, dWag, dWa2
#pragma unroll
  for (int m = 0; m < 3; ++m) tc::zero(acc[m]);
  for (int r = 0; r < row_groups(BF); ++r) bar_arrive(bar_free(r), kPair);
  for (int k = 0;; ++k) {
    if (blockIdx.x + k * gridDim.x >= n_tiles) break;
    const int r = k % row_groups(BF);
    const float* set = sm + L::sets + r * L::set_floats;
    const float* t[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) t[i] = set + i * L::tile;
    bar_sync(bar_staged1(r), kPair);
    if constexpr (BF) {
      const tcb::bf16* b[5];
#pragma unroll
      for (int i = 0; i < 5; ++i) b[i] = reinterpret_cast<const tcb::bf16*>(t[i]);
      tcb::gemm_tn_issue(acc[2], b[kDz], b[kH]);  // dWa2 += dz^T . h
      bar_sync(bar_staged2(r), kPair);
      tcb::gemm_tn_issue(acc[0], b[kDpre], b[kRec]);   // dWar += d_pre^T . rec
      tcb::gemm_tn_issue(acc[1], b[kDpre], b[kAggr]);  // dWag += d_pre^T . aggr
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int m = 0; m < 3; ++m) tc::fence_operands(acc[m]);
    } else {
      tc::gemm_tn<false>(acc[2], t[kDz], o0, t[kH]);
      bar_sync(bar_staged2(r), kPair);
      tc::gemm_tn<false>(acc[0], t[kDpre], o0, t[kRec]);
      tc::gemm_tn<false>(acc[1], t[kDpre], o0, t[kAggr]);
    }
    bar_arrive(bar_free(r), kPair);
  }
  float* ws = p.ws + static_cast<long long>(blockIdx.x) * kStride;
#pragma unroll
  for (int m = 0; m < 3; ++m) tc::store_rows(ws + m * kMat, D, acc[m], o0, D);
}

template <bool BF, typename TI>
__global__ void __launch_bounds__(block_threads(BF), 1)
fused_node_bwd(const Params<TI> p) {
  using L = Plan<BF>;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  load_weights<BF>(sm, p.wa1, p.wa2, block_threads(BF));
  for (int i = threadIdx.x; i < row_groups(BF) * 4 * 4 * D; i += block_threads(BF))
    sm[L::slots + i] = 0.0f;
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L::vec;
    v[c] = p.ba1[c];
    v[D + c] = p.ba2[c];
    v[2 * D + c] = p.layer_norm ? p.gn[c] : 1.0f;
  }
  __syncthreads();

  const int group = threadIdx.x / kGroupThreads;
  const int tg = threadIdx.x - group * kGroupThreads;
  if (group < row_groups(BF))
    row_group<BF>(p, sm, group, tg);
  else
    gradient_group<BF>(p, sm, tg);

  // ---- the bias and LayerNorm sums, once ------------------------------------
  __syncthreads();  // every row warp's slots are final
  float* ws = p.ws + static_cast<long long>(blockIdx.x) * kStride;
  for (int i = threadIdx.x; i < 4 * D; i += block_threads(BF)) {
    float s = 0.0f;
    for (int w = 0; w < row_groups(BF) * 4; ++w) s += sm[L::slots + w * 4 * D + i];
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
    err = fused_node::allow_smem(fused_node_bwd<BF, TI>, Plan<BF>::bytes);
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  fused_node_bwd<BF, TI><<<blocks, block_threads(BF), Plan<BF>::bytes, stream>>>(p);
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

template <bool BF, typename TI>
cudaError_t occupancy_of(int* out) {
  out[1] = block_threads(BF);
  out[3] = Plan<BF>::bytes;
  return tcb::occupancy(fused_node_bwd<BF, TI>, out[1], out[3], out, out + 2, out + 4);
}

}  // namespace

// The launch resources of one instantiation (bf16_ops, then io_bf16 the
// stream type): out = blocks per SM, threads per block, registers per
// thread, dynamic shared memory per block and local memory per thread
// (bytes).
extern "C" int nl_fused_node_bwd_occupancy(int bf16_ops, int io_bf16, int* out) {
  cudaError_t err;
  if (!bf16_ops)
    err = io_bf16 ? cudaErrorInvalidValue : occupancy_of<false, float>(out);
  else if (io_bf16)
    err = occupancy_of<true, __nv_bfloat16>(out);
  else
    err = occupancy_of<true, float>(out);
  return static_cast<int>(err);
}

// Shapes (contiguous and 16-byte aligned on the device; D = 64):
//   rec, d_node, d_aggr: (rows, D) in float32, or bf16 with io_bf16 (which
//     needs bf16_ops); aggr, d_rec: (rows, D) float32; rows = num_rec * B
//   wa1: (D, 2D), ba1: (D,), wa2: (D, D), ba2, gn: (D,), float32; gn null
//     without the LayerNorm
//   blocks: the grid (at most one block an SM and a tile a block: the
//     wrapper's sizing)
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
