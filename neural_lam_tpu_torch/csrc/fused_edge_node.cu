// K3 with the node-MLP epilogue (NEURAL_LAM_TPU_FUSED_AGGR=on; the JAX
// kernel's node_epilogue, neural_lam_tpu/ops/pallas_fused.py:335-391): the
// NODE instantiations of the kernel in csrc/fused_edge_fwd.cuh, which
// describes the epilogue's design, in every precision and pre type.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_fwd.cuh"

// nl_fused_edge_fwd_occupancy (fused_edge.cu) for the instantiations with
// the epilogue
extern "C" int nl_fused_edge_fwd_node_occupancy(int bf16_ops, int io_bf16, int pre_bf16,
                                                int edge_mode, int* out) {
  return static_cast<int>(occupancy_mode<true>(bf16_ops, io_bf16, pre_bf16, edge_mode, out));
}

// K3 with the node-MLP epilogue, in every precision: bf16_ops picks the
// bf16-operand instantiations (then io_bf16 the stream type), pre_bf16 and
// out_bf16 as above, node_layer_norm the node MLP's LayerNorm; then the
// arguments of nl_fused_edge_fwd up to pre, the node MLP's weights (float32:
// wa1 (D, 2D), ba1, wa2 (D, D), ba2, and gn, bn or null without the
// LayerNorm) and node_out (num_rec, B, D), in float32 or bf16 by out_bf16.
// aggr is float32, or null when the backward does not start from it.
extern "C" int nl_fused_edge_fwd_node(
    int bf16_ops, int pre_bf16, int io_bf16, int out_bf16, int node_layer_norm, int edge_mode,
    int num_rec, int batch, int feat, int update_edges, int propagation, int layer_norm,
    const void* edge, const void* send, const void* rec, const void* rowptr, const void* w1,
    const void* b1, const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2, const void* eg,
    const void* ebt, void* aggr, void* new_edge, void* pre, const void* wa1, const void* ba1,
    const void* wa2, const void* ba2, const void* gn, const void* bn, void* node_out,
    void* counter, void* stream) {
  if (!bf16_ops && (io_bf16 || out_bf16)) return static_cast<int>(cudaErrorInvalidValue);
#define NL_NODE_ARGS                                                                         \
  pre_bf16, edge_mode, num_rec, batch, feat, update_edges, propagation, layer_norm, out_bf16, \
      edge, send, rec, rowptr, w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt,     \
      aggr, new_edge, pre, counter, stream, node_layer_norm, wa1, ba1, wa2, ba2, gn, bn,     \
      node_out
  cudaError_t err;
  if (!bf16_ops)
    err = run<false, float, true>(NL_NODE_ARGS);
  else if (io_bf16)
    err = run<true, __nv_bfloat16, true>(NL_NODE_ARGS);
  else
    err = run<true, float, true>(NL_NODE_ARGS);
#undef NL_NODE_ARGS
  return static_cast<int>(err);
}
