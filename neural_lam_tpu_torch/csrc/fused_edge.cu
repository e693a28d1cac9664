// K3: the fused edge phase's forward (csrc/fused_edge_fwd.cuh holds the
// kernel and describes its design), in float32 and the bf16-operand
// instantiations, with a float32 or a bf16 pre.
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_fwd_impl.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_fwd.cuh"

// The launch resources of one instantiation: bf16_ops (then io_bf16, the
// stream type), pre_bf16 and edge_mode pick it; out = blocks per SM,
// threads per block, registers per thread, dynamic shared memory per block
// and local memory per thread (bytes).
extern "C" int nl_fused_edge_fwd_occupancy(int bf16_ops, int io_bf16, int pre_bf16,
                                           int edge_mode, int* out) {
  return static_cast<int>(occupancy_mode(bf16_ops, io_bf16, pre_bf16, edge_mode, out));
}

// Shapes (all f32 contiguous and 16-byte aligned on the device unless
// noted; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   send: (E, B, D) sender rows in receiver-sorted edge order (from K1)
//   rec: (num_rec, B, D); rowptr: (num_rec + 1,) int32
//   w1: (D, 3D), b1: (D,), w2: (D, D), b2, gamma, beta: (D,)
//   ew1: (D, feat), eb1, eb2, eg, ebt: (D,), ew2: (D, D)   [edge_mode 0]
//   aggr: (num_rec, B, D) out; new_edge: (E, B, D) out [update_edges];
//   pre: (E, B, D) out, the first layer's pre-activation (float32, or bf16
//     with pre_bf16), or null
//   counter: one int32, zero on entry (the work counter; left nonzero)
// 1 <= batch <= 32 and feat <= 8 are checked by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int nl_fused_edge_fwd(
    int pre_bf16, int edge_mode, int num_rec, int batch, int feat, int update_edges,
    int propagation, int layer_norm, const void* edge, const void* send,
    const void* rec, const void* rowptr, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* aggr, void* new_edge, void* pre,
    void* counter, void* stream) {
  return static_cast<int>(run<false, float>(
      pre_bf16, edge_mode, num_rec, batch, feat, update_edges, propagation, layer_norm, 0,
      edge, send, rec, rowptr, w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt, aggr,
      new_edge, pre, counter, stream));
}

// The bf16-operand instantiations: the arguments of nl_fused_edge_fwd (pre_bf16
// first), the streams edge, send and rec in bf16 (io_bf16) or float32, and aggr and
// new_edge written in bf16 (out_bf16 1) or float32 (0); out_bf16 3 writes
// new_edge in bf16 and aggr in float32 (the node-MLP route's aggregate, which
// the node update, fused_node.cu, reads). The weights stay float32
// arrays; the kernel rounds the matrices to bf16 as it stages them.
extern "C" int nl_fused_edge_fwd_bf16ops(
    int pre_bf16, int io_bf16, int out_bf16, int edge_mode, int num_rec, int batch, int feat,
    int update_edges, int propagation, int layer_norm, const void* edge, const void* send,
    const void* rec, const void* rowptr, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* aggr, void* new_edge, void* pre,
    void* counter, void* stream) {
  if (io_bf16)
    return static_cast<int>(run<true, __nv_bfloat16>(
        pre_bf16, edge_mode, num_rec, batch, feat, update_edges, propagation, layer_norm, out_bf16,
        edge, send, rec, rowptr, w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt,
        aggr, new_edge, pre, counter, stream));
  return static_cast<int>(run<true, float>(
      pre_bf16, edge_mode, num_rec, batch, feat, update_edges, propagation, layer_norm, out_bf16,
      edge, send, rec, rowptr, w1, b1, w2, b2, gamma, beta, ew1, eb1, ew2, eb2, eg, ebt, aggr,
      new_edge, pre, counter, stream));
}
