// The node update of the node-MLP route (NEURAL_LAM_TPU_FUSED_AGGR=on),
// launched right after K3 on the same stream.
//
// Replaces the node_epilogue block of
// neural_lam_tpu/ops/pallas_fused.py::_fused_fwd_impl (its pallas_call at
// :1033; the block at :335-391, returned at :1042-1049). Per (receiver, b)
// row, from the receiver row rec (the streams' type) and K3's float32
// aggregate aggr:
//
//   node = rec + LN(SiLU(rec . War^T + aggr . Wag^T + ba1) . Wa2^T + ba2)
//
// (LN optional, with its affine gn, bn; eps 1e-5, the biased variance).
// node goes out in float32 or, with out_bf16, rounded once to bf16.
//
// Design. The JAX kernel runs this at the end of each output block of K3,
// on the sums before they leave VMEM. Here K3 writes its float32 aggregate
// (which the backward keeps anyway) and this kernel runs the node MLP on
// the (rows, 64) arrays, in the frame of csrc/fused_node.cuh:
//   * persistent blocks, one an SM, of kGroups warpgroups; a group takes
//     the 64-row tiles blockIdx.x * kGroups + group, then every
//     gridDim.x * kGroups-th one;
//   * War, Wag and Wa2 in shared memory for all of the block's tiles, split
//     once (3xTF32 hi and lo, 96 KB) or as bf16 copies (BF, 24 KB);
//   * a tile's three products on wgmma: m64n64k8 TF32, three a k-step
//     (lo.hi, hi.lo, hi.hi), A from registers; with BF m64n64k16 bf16 on
//     packed fragments. The bias, SiLU, the LayerNorm (quad shuffles) and
//     the residual stay float32 in registers;
//   * each group's rec and aggr tile comes into shared memory by cp.async;
//     as soon as the group has read it into registers, the next tile's
//     copies are issued, so they are in flight during this tile's products.
//
// Bound on the H100: bytes (rec, aggr and node, 768 bytes a row in
// float32), about 1.5x the 3xTF32 operations (three 64 x 64 products a row).
//
// bf16 operands (BF; the JAX kernel's cdt = bf16): every product's operands
// rounded to bf16 (the float32 aggregate only as an operand), float32 sums.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_node.cuh"

namespace {

using fused_edge::silu;
using namespace fused_node;

// warpgroups a block: what fits beside the weights (float32: 3 x 36 KB of
// tiles and 96 KB of weights; BF: 4 x 27 KB and 24 KB)
constexpr int kGroups = 3;
constexpr int kGroupsBf = 4;

__host__ __device__ constexpr int groups_of(bool bf) { return bf ? kGroupsBf : kGroups; }

template <typename TI>
struct Params {
  const TI* rec;       // (rows, D)
  const float* aggr;   // (rows, D)
  const float* wa1;    // (D, 2D) [War | Wag]
  const float* ba1;
  const float* wa2;    // (D, D)
  const float* ba2;
  const float* gn;     // null without the LayerNorm
  const float* bn;
  void* out;           // (rows, D): float, or bf16 with out_bf16
  int out_bf16;
  int rows;
  int layer_norm;
};

// Shared-memory plan, in floats: the three weights, ba1 ba2 gn bn, then a
// tile of rec (TI) and one of aggr per group, row stride kWld
template <bool BF, typename TI>
struct Plan {
  static constexpr int vec = 3 * weight_floats(BF);
  static constexpr int groups = vec + 4 * D;
  static constexpr int rec = kTileRows * kWld * static_cast<int>(sizeof(TI)) / 4;
  static constexpr int group_floats = rec + kTileRows * kWld;
  static constexpr int total = groups + groups_of(BF) * group_floats;
  static constexpr int bytes = total * 4;
};

template <bool BF, typename TI>
__global__ void __launch_bounds__(groups_of(BF) * kGroupThreads, 1)
fused_node_fwd(const Params<TI> p) {
  using L = Plan<BF, TI>;
  constexpr int kThreads = groups_of(BF) * kGroupThreads;
  extern __shared__ float4 smem4[];
  float* sm = reinterpret_cast<float*>(smem4);
  constexpr int kW = weight_floats(BF);
  const float* sWar = sm;
  const float* sWag = sm + kW;
  const float* sWa2 = sm + 2 * kW;
  load_weights<BF>(sm, p.wa1, p.wa2, kThreads);
  if (threadIdx.x < D) {
    const int c = threadIdx.x;
    float* v = sm + L::vec;
    v[c] = p.ba1[c];
    v[D + c] = p.ba2[c];
    v[2 * D + c] = p.layer_norm ? p.gn[c] : 1.0f;
    v[3 * D + c] = p.layer_norm ? p.bn[c] : 0.0f;
  }
  __syncthreads();
  const float* sV = sm + L::vec;

  const int group = threadIdx.x / kGroupThreads;
  const int tg = threadIdx.x - group * kGroupThreads;
  const int bar = 1 + group;  // the group's named barrier
  const int r_base = 16 * (tg >> 5);
  float* gs = sm + L::groups + group * L::group_floats;
  TI* sRec = reinterpret_cast<TI*>(gs);
  float* sAggr = gs + L::rec;

  const int n_tiles = (p.rows + kTileRows - 1) / kTileRows;
  const int step = gridDim.x * groups_of(BF);
  int tile = blockIdx.x * groups_of(BF) + group;
  auto issue = [&](int t) {
    const long long row0 = static_cast<long long>(t) * kTileRows;
    const int valid = min(kTileRows, static_cast<int>(p.rows - row0));
    tile_async(sRec, p.rec, row0, valid, tg, kGroupThreads);
    tile_async(sAggr, p.aggr, row0, valid, tg, kGroupThreads);
    cp_async_commit();
  };
  if (tile < n_tiles) issue(tile);
  for (; tile < n_tiles; tile += step) {
    const long long row0 = static_cast<long long>(tile) * kTileRows;
    const int nrows = min(kTileRows, static_cast<int>(p.rows - row0));
    float x[8][4], a[8][4], h[8][4];
    cp_async_wait_all();
    tc::group_sync(bar, kGroupThreads);  // the tile has landed, every thread's part
    load_tile_rows(x, sRec, r_base);
    load_tile_rows(a, sAggr, r_base);
    tc::group_sync(bar, kGroupThreads);  // every warp has read it
    if (tile + step < n_tiles) issue(tile + step);

    tc::zero(h);
    row_product<BF>(h, x, sWar);
    row_product<BF>(h, a, sWag);
    tc::add_cols(h, sV);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) h[n][j] = silu(h[n][j]);
    tc::zero(a);
    row_product<BF>(a, h, sWa2);
    tc::add_cols(a, sV + D);
    if (p.layer_norm) tc::layer_norm(a, sV + 2 * D, sV + 3 * D, kLnEps);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) x[n][j] += a[n][j];
    store_out(p.out, p.out_bf16, row0 * D, x, r_base, nrows);
  }
}

template <bool BF, typename TI>
cudaError_t launch(const Params<TI>& p, int blocks, cudaStream_t stream) {
  static unsigned allowed = 0;  // devices whose attribute is set
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (!(allowed & (1u << (dev & 31)))) {
    err = allow_smem(fused_node_fwd<BF, TI>, Plan<BF, TI>::bytes);
    if (err != cudaSuccess) return err;
    allowed |= 1u << (dev & 31);
  }
  fused_node_fwd<BF, TI>
      <<<blocks, groups_of(BF) * kGroupThreads, Plan<BF, TI>::bytes, stream>>>(p);
  return cudaGetLastError();
}

template <bool BF, typename TI>
cudaError_t run(int out_bf16, int rows, int layer_norm, int blocks, const void* rec,
                const void* aggr, const void* wa1, const void* ba1, const void* wa2,
                const void* ba2, const void* gn, const void* bn, void* out, void* stream) {
  if (rows <= 0 || blocks <= 0 || (layer_norm && (gn == nullptr || bn == nullptr)))
    return cudaErrorInvalidValue;
  Params<TI> p;
  p.rec = static_cast<const TI*>(rec);
  p.aggr = static_cast<const float*>(aggr);
  p.wa1 = static_cast<const float*>(wa1);
  p.ba1 = static_cast<const float*>(ba1);
  p.wa2 = static_cast<const float*>(wa2);
  p.ba2 = static_cast<const float*>(ba2);
  p.gn = static_cast<const float*>(gn);
  p.bn = static_cast<const float*>(bn);
  p.out = out;
  p.out_bf16 = out_bf16;
  p.rows = rows;
  p.layer_norm = layer_norm;
  return launch<BF, TI>(p, blocks, static_cast<cudaStream_t>(stream));
}

template <bool BF, typename TI>
cudaError_t occupancy_of(int* out) {
  out[1] = groups_of(BF) * kGroupThreads;
  out[3] = Plan<BF, TI>::bytes;
  return tcb::occupancy(fused_node_fwd<BF, TI>, out[1], out[3], out, out + 2, out + 4);
}

}  // namespace

// The launch resources of one instantiation (bf16_ops, then io_bf16 the
// stream type): out = blocks per SM, threads per block, registers per
// thread, dynamic shared memory per block and local memory per thread
// (bytes).
extern "C" int nl_fused_node_fwd_occupancy(int bf16_ops, int io_bf16, int* out) {
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
//   rec: (rows, D) in float32, or bf16 with io_bf16 (which needs bf16_ops);
//     aggr: (rows, D) float32; rows = num_rec * B
//   wa1: (D, 2D), ba1: (D,), wa2: (D, D), ba2, gn, bn: (D,), float32; gn
//     and bn null without the LayerNorm
//   out: (rows, D), float32 or, with out_bf16, bf16
//   blocks: the grid (at most one block an SM: the wrapper's sizing)
// Returns the CUDA error of the launch (0 on success).
extern "C" int nl_fused_node_fwd(int bf16_ops, int io_bf16, int out_bf16, int rows,
                                 int layer_norm, int blocks, const void* rec, const void* aggr,
                                 const void* wa1, const void* ba1, const void* wa2,
                                 const void* ba2, const void* gn, const void* bn, void* out,
                                 void* stream) {
#define NL_NODE_FWD_ARGS \
  out_bf16, rows, layer_norm, blocks, rec, aggr, wa1, ba1, wa2, ba2, gn, bn, out, stream
  cudaError_t err;
  if (!bf16_ops)
    err = (io_bf16 || out_bf16) ? cudaErrorInvalidValue : run<false, float>(NL_NODE_FWD_ARGS);
  else if (io_bf16)
    err = run<true, __nv_bfloat16>(NL_NODE_FWD_ARGS);
  else
    err = run<true, float>(NL_NODE_FWD_ARGS);
#undef NL_NODE_FWD_ARGS
  return static_cast<int>(err);
}
