// K8: backward of the v2 fused edge phase (K7, fused_edge_v2.cu).
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_v2_bwd_impl (the
// _fused_v2_bwd_kernel + _embed_backward pallas_call). Given the gradients
// d_aggr (num_rec, B, D) of the receiver sums and, optionally, d_new_edge
// (E, B, D) of the updated edges, and the first layer's pre-activation
// pre[e, b] that K7 saved, it computes per edge e (receiver r) and batch
// member b:
//
//   d_msg  = d_aggr[r, b] (+ d_new_edge[e, b])
//   h1     = SiLU(pre),  z = h1 . W2 + b2
//   dz     = LayerNorm backward of d_msg at z   (dz = d_msg without LN)
//            dgamma += d_msg * x_hat, dbeta += d_msg
//   d_h1   = dz . W2^T,  dW2 += h1^T . dz,  db2 += dz
//   d_pre[e, b] = d_h1 * SiLU'(pre),  db1 += d_pre          (written out)
//   d_recproj[r, b] = sum of d_pre over the edges into r
//   edge input, by mode:
//     EDGE_BATCHED  d_edge[e, b] = d_pre . W1e^T (+ d_new_edge[e, b]),
//                   dW1e += edge^T . d_pre
//     EDGE_SHARED,  through s[e] = sum_b d_pre[e, b] and the edge kernel of
//     EDGE_RAW      fused_edge_bwd_common.cuh: d_edge[e] and dW1e, or the
//                   embedder's six weight gradients
//
// Unlike K4 it emits no d_send and no dW1s and never reads sender rows: the
// first layer's sender product was formed outside K7 as sp = send . W1s, so
// the caller scatters d_pre into d_sp with K2 (the sender scatter), and the
// gradients of W1s, W1r and the node rows come from autograd of the two
// node-sized projections (d_rp = d_recproj), as the JAX package forms them
// outside its kernel (pallas_fused.py:2655-2674).
//
// Design: K4's. A fixed number of persistent blocks (one per SM) own chunks
// of R consecutive receivers (R*B <= 32) and their contiguous CSR edge range,
// keep their partial weight gradients in registers (a 4x4 share of each
// 64x64 matrix per thread), write them once to a (blocks, stride) workspace,
// and a last small kernel sums the workspace in block order: deterministic,
// no float atomics. Without W1s, the sender tile and the dW1s share, the main
// kernel's workspace is one 64x64 matrix smaller than K4's and its shared
// memory two tiles smaller.
//
// Bound on the H100: operations. Per (edge, b) row the main kernel does three
// 64x64 products (z, d_h1, dW2) and two more for a batched edge input
// (d_edge, dW1e), in exact float32 on the SIMT units.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_bwd_common.cuh"

namespace {

using namespace fused_edge;

// floats per block in the main kernel's workspace (the wrapper sizes it the
// same): dW2 dW1e | db2 dgamma dbeta db1
constexpr int kMainStride = 2 * kMat + 4 * D;

struct MainParams {
  const float* edge;        // (E, B, D), EDGE_BATCHED only
  const float* pre;         // (E, B, D)
  const float* d_aggr;      // (num_rec, B, D)
  const float* d_new_edge;  // (E, B, D) or null
  const int* rowptr;
  const float* w1;
  const float* w2;
  const float* b2;
  const float* gamma;
  float* d_pre;      // (E, B, D)
  float* d_edge;     // (E, B, D), EDGE_BATCHED only
  float* presum;     // (E, D), the per-edge modes only
  float* d_recproj;  // (num_rec, B, D)
  float* ws;         // (gridDim.x, kMainStride)
  int num_rec;
  int num_chunks;
  int batch;
  int recv_per_block;
  int edges_per_tile;
  int layer_norm;
};

constexpr int main_smem_floats(bool batched) {
  return (batched ? 3 : 2) * kMat + 2 * D + (batched ? 3 : 2) * kTileRows * kLd +
         kRecRows * D + 33 + kTileRows;
}

template <bool BATCHED>
__global__ void __launch_bounds__(kThreads, 1)
fused_edge_v2_bwd_main(const MainParams p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* sW2t = smem;            // (in, out): z = h1 . W2
  float* sW2r = sW2t + kMat;     // (out, in): d_h1 = dz . W2^T
  float* sW1e = sW2r + kMat;     // (out, in) slice, BATCHED only
  float* sB2 = sW1e + (BATCHED ? kMat : 0);
  float* sGam = sB2 + D;
  float* sH = sGam + D;                 // h1 tile
  float* sG = sH + kTileRows * kLd;     // dz, then d_pre
  float* sXe = sG + kTileRows * kLd;    // edge rows, BATCHED only
  float* sDA = sXe + (BATCHED ? kTileRows * kLd : 0);  // the chunk's d_aggr rows
  int* sRowptr = reinterpret_cast<int*>(sDA + kRecRows * D);
  int* sRloc = sRowptr + 33;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int B = p.batch, R = p.recv_per_block, TE = p.edges_per_tile;
  const int BD = B * D;

  load_weight_t(sW2t, D, p.w2, D, 0);
  load_weight_raw(sW2r, p.w2, D, 0);
  if (BATCHED) load_weight_raw(sW1e, p.w1, 3 * D, 0);
  if (tid < D) {
    sB2[tid] = p.b2[tid];
    sGam[tid] = p.layer_norm ? p.gamma[tid] : 1.0f;
  }

  float dW2[4][4], dW1e[4][4];
  zero(dW2);
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
      if (BATCHED) load_rows(sXe, p.edge + row0 * D, nrows, kTileRows);
      if (tid < nr) {
        const int a = max(sRowptr[tid], t0), z = min(sRowptr[tid + 1], t0 + ne);
        for (int e = a; e < z; ++e) sRloc[e - t0] = tid;
      }
      // ---- z again, d_msg, then d_pre (written out) -----------------------
      float pr[4][4], xh[4][4], rstd[4], dm[4][4], acc[4][4];
      forward_from_pre(pr, xh, rstd, p.pre, row0, nrows, sH, sW2t, sB2, p.layer_norm,
                       rg, cg);
      message_grad(dm, sDA, sRloc, p.d_new_edge, row0, nrows, B, rg, cg);
      d_pre_from_message(acc, dm, xh, rstd, pr, p.layer_norm, sGam, sH, sG, sW2r, dW2,
                         vec, rg, cg);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = rg + 16 * i;
        if (m < nrows)
          *reinterpret_cast<float4*>(p.d_pre + (row0 + m) * D + 4 * cg) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      }
      __syncthreads();  // every thread is done with dz in sG
      store_rows(sG, acc, rg, cg);
      __syncthreads();

      // ---- the edge input ------------------------------------------------
      edge_input_grad<BATCHED>(dW1e, sXe, sG, sW1e, p.d_new_edge, p.d_edge, p.presum,
                               row0, t0, ne, nrows, B, rg, cg);

      sum_into_receivers(agg, sG, sRowptr, nr, t0, ne, B);  // d_recproj
      __syncthreads();
    }
    store_receiver_sums(p.d_recproj, agg, r0, nr, B);
  }

  float* ws = p.ws + static_cast<long long>(blockIdx.x) * kMainStride;
  store_wgrad(ws, dW2, rg, cg);
  store_wgrad(ws + kMat, dW1e, rg, cg);
  store_vec_sums<4>(ws + 2 * kMat, sH, vec, rg, cg);
}

template <bool BATCHED>
cudaError_t launch_main(const MainParams& p, int blocks, cudaStream_t stream) {
  constexpr int bytes = main_smem_floats(BATCHED) * static_cast<int>(sizeof(float));
  cudaError_t err = allow_smem(fused_edge_v2_bwd_main<BATCHED>, bytes);
  if (err != cudaSuccess) return err;
  fused_edge_v2_bwd_main<BATCHED><<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   pre: (E, B, D); d_aggr: (num_rec, B, D); d_new_edge: (E, B, D) or null;
//   rowptr: (num_rec + 1,) int32; weights as for nl_fused_edge_v2_fwd
//   d_pre: (E, B, D) out; d_recproj: (num_rec, B, D) out
//   d_edge: (E, B, D) out [edge_mode 2], (E, D) out [1], unused [0]
//   presum: (E, D) scratch [edge_mode 0, 1]
//   ws_main: (max_blocks, 8448) scratch; out_main: (8448,) out =
//     dW2, dW1e [edge_mode 2, else 0] as (out, in) | db2 dgamma dbeta db1
//   ws_edge: (max_blocks, 8960) scratch; out_edge: (8960,) out [edge_mode 0, 1]
//     = dW1e, dEW2 as (out, in) | dEW1 as (D, 8) | deb1 deb2 deg debt
// num_rec > 0, n_edges > 0, 1 <= batch <= 32, feat <= 8 and max_blocks > 0
// are checked by the caller. Returns the first CUDA error of the launches.
extern "C" int nl_fused_edge_v2_bwd(
    int edge_mode, int num_rec, int n_edges, int batch, int feat,
    int layer_norm, int max_blocks, const void* edge, const void* pre,
    const void* d_aggr, const void* d_new_edge, const void* rowptr,
    const void* w1, const void* w2, const void* b2, const void* gamma,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* d_pre, void* d_edge,
    void* d_recproj, void* presum, void* ws_main, void* out_main,
    void* ws_edge, void* out_edge, void* stream) {
  if (num_rec <= 0 || n_edges <= 0 || batch < 1 || batch > kRecRows ||
      feat > kMaxFeat || max_blocks <= 0 || edge_mode < 0 || edge_mode > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool batched = edge_mode == EDGE_BATCHED;

  MainParams m;
  m.edge = static_cast<const float*>(edge);
  m.pre = static_cast<const float*>(pre);
  m.d_aggr = static_cast<const float*>(d_aggr);
  m.d_new_edge = static_cast<const float*>(d_new_edge);
  m.rowptr = static_cast<const int*>(rowptr);
  m.w1 = static_cast<const float*>(w1);
  m.w2 = static_cast<const float*>(w2);
  m.b2 = static_cast<const float*>(b2);
  m.gamma = static_cast<const float*>(gamma);
  m.d_pre = static_cast<float*>(d_pre);
  m.d_edge = static_cast<float*>(d_edge);
  m.presum = static_cast<float*>(presum);
  m.d_recproj = static_cast<float*>(d_recproj);
  m.ws = static_cast<float*>(ws_main);
  m.num_rec = num_rec;
  m.batch = batch;
  m.recv_per_block = kRecRows / batch;
  m.edges_per_tile = kTileRows / batch;
  m.num_chunks = (num_rec + m.recv_per_block - 1) / m.recv_per_block;
  m.layer_norm = layer_norm;
  const int main_blocks = m.num_chunks < max_blocks ? m.num_chunks : max_blocks;
  cudaError_t err = batched ? launch_main<true>(m, main_blocks, s)
                            : launch_main<false>(m, main_blocks, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_reduce(m.ws, main_blocks, kMainStride, 2,
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
  return static_cast<int>(launch_edge_phase(edge_mode, e, max_blocks,
                                            static_cast<float*>(out_edge), s));
}
