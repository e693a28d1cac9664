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
// and a last small kernel sums the workspaces over the groups in group
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
//      the edge input's share.
//   2. The edge input's share (fused_edge_bwd_common.cuh, shared with K8).
//      EDGE_BATCHED: fused_edge_bwd_rows, d_edge (wgmma) and dW1e
//      (mma.sync) per (edge, b) row over d_pre. The per-edge modes:
//      fused_edge_bwd_edge, dW1e and d_edge, and for EDGE_RAW the embedder's
//      backward, over tiles of 64 rows of s (B times fewer rows than the
//      edge stream), its chain in registers on the tensor cores.
//   3. fused_edge_bwd_receiver, the receiver slice (the rows pass's
//      pattern, fused_edge_bwd_common.cuh): d_rec = d_recproj . W1r and
//      dW1r += d_recproj^T . rec per (receiver, b) row, 3xTF32 in every
//      precision, as the JAX package forms them outside its kernel
//      (pallas_fused.py:1624-1631); it reads rec in the streams' dtype.
//   4. reduce_workspace: sums the three workspaces (main, edge input,
//      receiver slice) over their groups in group order.
//
// Bound on the H100: operations. Per (edge, b) row the main kernel does
// five 64x64 products (z, d_h1, dW2, d_send, dW1s) and the batched edge
// pass two more (d_edge, dW1e), per (receiver, b) row the receiver slice
// two (d_rec, dW1r), and per edge the edge pass two (d_edge_val, dW1e) and
// for raw features three more (the embedder's second layer, dEW2, d_a1),
// on the tensor cores (495 TFLOP/s of TF32, divided by three for 3xTF32).
//
// The main kernel, its recompute of pre and the launch sequence are in
// fused_edge_bwd_main.cuh; this library holds the instantiations that start
// from a saved pre, float32 or, under NEURAL_LAM_TPU_CACHE_PRE=bf16, bf16
// (the JAX kernel's pre_dt, pallas_fused.py:897): a bf16 pre is widened to
// float32 as it is loaded, and SiLU, z, the LayerNorm and SiLU' are
// recomputed from the rounded value in every precision, as in the JAX
// kernel. fused_edge_bwd_recompute.cu holds the ones that recompute pre
// (NEURAL_LAM_TPU_CACHE_PRE=off).
//
// Reduced precision (the JAX kernel's cdt = bf16 and io_dt, pallas_fused.py
// :397, :1052): the instantiations with BF take every product's operands in
// bf16 (float32 sums), with the LayerNorm backward, SiLU' and the column
// sums in float32. Their main kernel is fused_edge_bwd_main_bf
// (fused_edge_bwd_main.cuh), on Hopper's bf16 tensor cores (tc_bf16.cuh):
// wgmma m64n64k16 on bf16 fragments and bf16 tiles, one bf16 copy of W2 and
// W1s read in both orientations through wgmma's transpose bit; so is the
// edge pass's (fused_edge_bwd_common.cuh, shared with K8's bf16 variants);
// the rows pass takes bf16-rounded operands in one TF32 pass (tc_tf32.cuh),
// the receiver slice stays 3xTF32. The streams send, d_aggr, d_new_edge and the
// edge input, and the outputs d_send and d_edge, are of type TI (bf16 under
// mixed precision and NEURAL_LAM_TPU_MATMUL_PRECISION=high, float32 under
// high-kernels), as the JAX wrapper casts them to io_dt; d_recproj and the
// weight gradients stay float32. Bound: bytes at the stream dtype, or
// the products at the dense bf16 rate (989 TFLOP/s).
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_main.cuh"

// The launch resources of the main kernel's instantiation: bf16_ops (then
// io_bf16), pre_bf16 and edge_mode pick it; out = blocks per SM, threads
// per block, registers per thread, dynamic shared memory per block and
// local memory per thread (bytes).
extern "C" int nl_fused_edge_bwd_occupancy(int bf16_ops, int io_bf16, int pre_bf16,
                                           int edge_mode, int* out) {
  return static_cast<int>(
      pre_bf16 ? main_occupancy_mode<kPreBf16>(bf16_ops, io_bf16, edge_mode, out)
               : main_occupancy_mode<kPreF32>(bf16_ops, io_bf16, edge_mode, out));
}

namespace {

// the instantiation for the type of the saved pre
template <bool BF, typename TI>
cudaError_t run_saved(int pre_bf16, int edge_mode, int num_rec, int n_edges, int batch,
                      int feat, int propagation, int layer_norm, int main_blocks,
                      int edge_blocks, int rec_blocks, const void* edge, const void* send,
                      const void* pre, const void* d_aggr, const void* d_new_edge,
                      const void* rowptr, const void* w1, const void* w2, const void* b2,
                      const void* gamma, const void* ew1, const void* eb1, const void* ew2,
                      const void* eb2, const void* eg, const void* ebt, void* d_send,
                      void* d_edge, void* d_recproj, void* d_pre, void* ws_main,
                      void* out_main, void* ws_edge, void* out_edge, const void* rec,
                      void* d_rec, void* ws_rec, void* out_rec, void* stream) {
  auto go = pre_bf16 ? &run<kPreBf16, BF, TI> : &run<kPreF32, BF, TI>;
  return go(edge_mode, num_rec, n_edges, batch, feat, propagation, layer_norm, main_blocks,
            edge_blocks, rec_blocks, edge, send, pre, rec, d_aggr, d_new_edge, rowptr, w1,
            nullptr, w2, b2, gamma, ew1, eb1, ew2, eb2, eg, ebt, d_send, d_edge, d_recproj,
            d_pre, ws_main, out_main, ws_edge, out_edge, d_rec, ws_rec, out_rec, nullptr,
            stream);
}

// the launch resources of a piece of K4's tail (out as
// nl_fused_edge_bwd_occupancy's): the edge pass (pieces 0 and 1) and the
// rows pass (2) in the instantiation BF, TI
template <bool BF, typename TI>
cudaError_t tail_occupancy_of(int piece, int* out) {
  using namespace fused_edge;
  switch (piece) {
    case 0: return edge_occupancy_of<true, BF, TI>(out);
    case 1: return edge_occupancy_of<false, BF, TI>(out);
    case 2:
      out[1] = kRowThreads;
      out[3] = rows_smem_bytes();
      return tcb::occupancy(fused_edge_bwd_rows<BF, TI>, out[1], out[3], out, out + 2,
                            out + 4);
    default: return cudaErrorInvalidValue;
  }
}

// and of the receiver slice (piece 3) on rows of type TI
template <typename TI>
cudaError_t receiver_occupancy_of(int* out) {
  using namespace fused_edge;
  out[1] = kRowThreads;
  out[3] = rows_smem_bytes();
  return tcb::occupancy(fused_edge_bwd_receiver<TI>, out[1], out[3], out, out + 2, out + 4);
}

// the edge pass alone and its reduce
template <bool BF, typename TI>
cudaError_t edge_pass(int edge_mode, int n_edges, int batch, int feat, int edge_blocks,
                      const void* edge, const void* presum, const void* d_new_edge,
                      const void* w1, const void* ew1, const void* eb1, const void* ew2,
                      const void* eb2, const void* eg, const void* ebt, void* d_edge,
                      void* ws_edge, void* out_edge, void* stream) {
  fused_edge::EdgeParamsT<TI> e;
  e.edge = static_cast<const TI*>(edge);
  e.presum = static_cast<const float*>(presum);
  e.d_new_edge = static_cast<const TI*>(d_new_edge);
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_edge::ReduceJobs jobs{};
  jobs.n = 1;
  cudaError_t err = fused_edge::launch_edge_pass<BF>(edge_mode, e, edge_blocks,
                                                     static_cast<float*>(out_edge),
                                                     &jobs.job[0], s);
  if (err != cudaSuccess) return err;
  return fused_edge::launch_reduces(jobs, s);
}

// the receiver slice alone and its reduce
template <typename TI>
cudaError_t receiver_slice(int rows, int blocks, const void* rec, const void* d_recproj,
                           const void* w1, void* d_rec, void* ws, void* out, void* stream) {
  fused_edge::RowsParamsT<TI, float> q;
  q.x = static_cast<const TI*>(rec);
  q.g = static_cast<const float*>(d_recproj);
  q.add = nullptr;
  q.w1 = static_cast<const float*>(w1);
  q.w_off = 2 * fused_edge::D;
  q.out = static_cast<float*>(d_rec);
  q.ws = static_cast<float*>(ws);
  q.rows = rows;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_edge::ReduceJobs jobs{};
  jobs.n = 1;
  cudaError_t err = fused_edge::launch_rows<true, false>(q, blocks, static_cast<float*>(out),
                                                         &jobs.job[0], s);
  if (err != cudaSuccess) return err;
  return fused_edge::launch_reduces(jobs, s);
}

}  // namespace

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   send: (E, B, D); pre: (E, B, D), float32 or, with pre_bf16, bf16;
//   d_aggr: (num_rec, B, D); d_new_edge: (E, B, D) or null;
//   rowptr: (num_rec + 1,) int32; weights as for nl_fused_edge_fwd
//   d_send: (E, B, D) out; d_recproj: (num_rec, B, D) out
//   d_edge: (E, B, D) out [edge_mode 2], (E, D) out [1], unused [0]
//   d_pre: (E, B, D) scratch [edge_mode 2], (E, D) [0, 1]
//   ws_main: (main_blocks * 3, 8448) scratch; out_main: (8448,) out =
//     dW2, dW1s as (out, in) | db2 dgamma dbeta db1
//   ws_edge: (edge_blocks * 3, 8960) scratch [edge_mode 0, 1],
//     (edge_blocks * 4, 4096) [2]; out_edge: (8960,) out = dW1e, dEW2 as
//     (out, in) | dEW1 as (D, 8) | deb1 deb2 deg debt (dW1e alone [1, 2])
//   rec: (num_rec, B, D) in the streams' dtype; d_rec: (num_rec, B, D)
//     float32 out; ws_rec: (rec_blocks * 4, 4096) scratch; out_rec: (4096,)
//     out = dW1r as (out, in)
//   main_blocks = min(SMs, ceil(chunks / 3)) with chunks = ceil(num_rec /
//   (32 / batch)); edge_blocks = min(SMs, ceil(tiles / 4)) with tiles =
//   ceil(E * B / 64) [edge_mode 2], else min(SMs, ceil(ceil(E / 64) / 3));
//   rec_blocks = min(SMs, ceil(ceil(num_rec * B / 64) / 4))
// num_rec > 0, n_edges > 0, 1 <= batch <= 32, feat <= 8 and the block
// counts > 0 are checked by the caller. Returns the first CUDA error of the
// launches.
extern "C" int nl_fused_edge_bwd(
    int pre_bf16, int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int propagation, int layer_norm, int main_blocks, int edge_blocks, int rec_blocks,
    const void* edge, const void* send, const void* pre, const void* d_aggr,
    const void* d_new_edge, const void* rowptr, const void* w1, const void* w2,
    const void* b2, const void* gamma, const void* ew1, const void* eb1,
    const void* ew2, const void* eb2, const void* eg, const void* ebt,
    void* d_send, void* d_edge, void* d_recproj, void* d_pre, void* ws_main,
    void* out_main, void* ws_edge, void* out_edge, const void* rec, void* d_rec,
    void* ws_rec, void* out_rec, void* stream) {
  return static_cast<int>(run_saved<false, float>(
      pre_bf16, edge_mode, num_rec, n_edges, batch, feat, propagation, layer_norm,
      main_blocks, edge_blocks, rec_blocks, edge, send, pre, d_aggr, d_new_edge, rowptr, w1,
      w2, b2, gamma, ew1, eb1, ew2, eb2, eg, ebt, d_send, d_edge, d_recproj, d_pre, ws_main,
      out_main, ws_edge, out_edge, rec, d_rec, ws_rec, out_rec, stream));
}

// The bf16-operand instantiations: the arguments of nl_fused_edge_bwd (pre_bf16
// first), with edge, send, rec, d_aggr, d_new_edge, d_send and d_edge in bf16
// (io_bf16) or float32; everything else as there.
extern "C" int nl_fused_edge_bwd_bf16ops(
    int pre_bf16, int io_bf16, int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int propagation, int layer_norm, int main_blocks, int edge_blocks, int rec_blocks,
    const void* edge, const void* send, const void* pre, const void* d_aggr,
    const void* d_new_edge, const void* rowptr, const void* w1, const void* w2,
    const void* b2, const void* gamma, const void* ew1, const void* eb1,
    const void* ew2, const void* eb2, const void* eg, const void* ebt,
    void* d_send, void* d_edge, void* d_recproj, void* d_pre, void* ws_main,
    void* out_main, void* ws_edge, void* out_edge, const void* rec, void* d_rec,
    void* ws_rec, void* out_rec, void* stream) {
  auto go = io_bf16 ? &run_saved<true, __nv_bfloat16> : &run_saved<true, float>;
  return static_cast<int>(go(
      pre_bf16, edge_mode, num_rec, n_edges, batch, feat, propagation, layer_norm,
      main_blocks, edge_blocks, rec_blocks, edge, send, pre, d_aggr, d_new_edge, rowptr, w1,
      w2, b2, gamma, ew1, eb1, ew2, eb2, eg, ebt, d_send, d_edge, d_recproj, d_pre, ws_main,
      out_main, ws_edge, out_edge, rec, d_rec, ws_rec, out_rec, stream));
}

// The launch resources of a piece of K4's tail: piece 0 the edge pass on
// raw features, 1 on a shared edge input, 2 the rows pass, 3 the receiver
// slice (bf16_ops picks no other instantiation of it: it runs 3xTF32); in
// the instantiation of bf16_ops and io_bf16; out as for
// nl_fused_edge_bwd_occupancy.
extern "C" int nl_fused_edge_bwd_tail_occupancy(int piece, int bf16_ops, int io_bf16,
                                                int* out) {
  if (piece == 3)
    return static_cast<int>(io_bf16 ? receiver_occupancy_of<__nv_bfloat16>(out)
                                    : receiver_occupancy_of<float>(out));
  if (!bf16_ops && io_bf16) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(!bf16_ops ? tail_occupancy_of<false, float>(piece, out)
                          : io_bf16 ? tail_occupancy_of<true, __nv_bfloat16>(piece, out)
                                    : tail_occupancy_of<true, float>(piece, out));
}

// The edge pass alone (edge_mode 0 or 1) and its reduce, as nl_fused_edge_bwd
// launches them after its main kernel: presum is s (E, D) float32; edge,
// d_new_edge and d_edge in the streams' dtype (bf16 with io_bf16, which
// needs bf16_ops); ws_edge, out_edge and edge_blocks as there.
extern "C" int nl_fused_edge_bwd_edge_pass(
    int bf16_ops, int io_bf16, int edge_mode, int n_edges, int batch, int feat,
    int edge_blocks, const void* edge, const void* presum, const void* d_new_edge,
    const void* w1, const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* d_edge, void* ws_edge, void* out_edge,
    void* stream) {
  if (n_edges <= 0 || batch < 1 || feat > fused_edge::kMaxFeat || edge_blocks <= 0 ||
      (edge_mode != EDGE_RAW && edge_mode != EDGE_SHARED) || (!bf16_ops && io_bf16))
    return static_cast<int>(cudaErrorInvalidValue);
  auto go = !bf16_ops ? &edge_pass<false, float>
            : io_bf16 ? &edge_pass<true, __nv_bfloat16>
                      : &edge_pass<true, float>;
  return static_cast<int>(go(edge_mode, n_edges, batch, feat, edge_blocks, edge, presum,
                             d_new_edge, w1, ew1, eb1, ew2, eb2, eg, ebt, d_edge, ws_edge,
                             out_edge, stream));
}

// The receiver slice alone and its reduce: rec (rows / B, B, D) in bf16
// (io_bf16) or float32, d_recproj and d_rec (rows / B, B, D) float32, ws
// (blocks * 4, 4096), out (4096,) = dW1r as (out, in).
extern "C" int nl_fused_edge_bwd_receiver_slice(int io_bf16, int rows, int blocks,
                                                const void* rec, const void* d_recproj,
                                                const void* w1, void* d_rec, void* ws,
                                                void* out, void* stream) {
  if (rows <= 0 || blocks <= 0) return static_cast<int>(cudaErrorInvalidValue);
  auto go = io_bf16 ? &receiver_slice<__nv_bfloat16> : &receiver_slice<float>;
  return static_cast<int>(go(rows, blocks, rec, d_recproj, w1, d_rec, ws, out, stream));
}

// The workspace reduce alone: out (stride,) = ws (parts, stride) summed over
// its parts in part order.
extern "C" int nl_reduce_workspace(int parts, int stride, const void* ws, void* out,
                                   void* stream) {
  if (parts <= 0 || stride <= 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(fused_edge::launch_reduce(static_cast<const float*>(ws), parts,
                                                    stride, static_cast<float*>(out),
                                                    static_cast<cudaStream_t>(stream)));
}
