// K4 under NEURAL_LAM_TPU_CACHE_PRE=off: the backward of the fused edge
// phase (fused_edge_bwd.cu) when K3 saved no pre-activation, which its main
// kernel recomputes in the tile loop (fused_edge_bwd_main.cuh), as the JAX
// kernel does without a saved pre (pallas_fused.py::_fused_bwd_impl, the
// pre2d is None branch at :1087, :1153, :1203; _fused_bwd_kernel with
// saved_pre=False, :420, :441). The option exists to save memory: the
// per-edge pre of every edge set of every step, which a training step
// otherwise holds from K3 to K4, is never written.
//
// Instantiations: the three edge modes (the recompute runs the raw-feature
// embedder or reads the edge rows), each in float32 (3xTF32) and with bf16
// operands on bf16 or float32 streams, as for the saved-pre kernels.
//
// Bound on the H100: operations, as for K4, with the recompute's products
// added: per (edge, b) row send . W1s (and edge . W1e, batched), per
// (receiver, b) rec . W1r, and per edge the embedder and edge_val . W1e.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_main.cuh"

// nl_fused_edge_bwd_occupancy (fused_edge_bwd.cu) for the recomputing main
// kernel
extern "C" int nl_fused_edge_bwd_recompute_occupancy(int bf16_ops, int io_bf16, int edge_mode,
                                                     int* out) {
  return static_cast<int>(
      main_occupancy_mode<kPreRecompute>(bf16_ops, io_bf16, edge_mode, out));
}

// The arguments of nl_fused_edge_bwd_bf16ops (fused_edge_bwd.cu) without
// pre_bf16 and pre, with bf16_ops (0: the float32 kernel, whose streams must
// be float32), rec (num_rec, B, D) in the streams' type among the inputs,
// b1 (D,), and pre_ws, a (main_blocks * 3, 6144) float32 scratch, after
// out_rec.
extern "C" int nl_fused_edge_bwd_recompute(
    int bf16_ops, int io_bf16, int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int propagation, int layer_norm, int main_blocks, int edge_blocks, int rec_blocks,
    const void* edge, const void* send, const void* rec, const void* d_aggr,
    const void* d_new_edge, const void* rowptr, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* ew1, const void* eb1,
    const void* ew2, const void* eb2, const void* eg, const void* ebt,
    void* d_send, void* d_edge, void* d_recproj, void* d_pre, void* ws_main,
    void* out_main, void* ws_edge, void* out_edge, void* d_rec, void* ws_rec,
    void* out_rec, void* pre_ws, void* stream) {
  if (!bf16_ops && io_bf16) return static_cast<int>(cudaErrorInvalidValue);
  auto go = !bf16_ops ? &run<kPreRecompute, false, float>
            : io_bf16 ? &run<kPreRecompute, true, __nv_bfloat16>
                      : &run<kPreRecompute, true, float>;
  return static_cast<int>(go(
      edge_mode, num_rec, n_edges, batch, feat, propagation, layer_norm, main_blocks,
      edge_blocks, rec_blocks, edge, send, nullptr, rec, d_aggr, d_new_edge, rowptr, w1, b1,
      w2, b2, gamma, ew1, eb1, ew2, eb2, eg, ebt, d_send, d_edge, d_recproj, d_pre, ws_main,
      out_main, ws_edge, out_edge, d_rec, ws_rec, out_rec, pre_ws, stream));
}
