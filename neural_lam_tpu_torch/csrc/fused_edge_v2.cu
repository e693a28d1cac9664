// K7: the v2 fused edge-phase forward of one InteractionNet step, with the
// sender gather merged into the kernel.
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_v2_fwd_impl (the
// _fused_v2_fwd_kernel + _embed_forward pallas_call), which the JAX package
// builds through make_fused_interaction_v2. The first layer's sender and
// receiver products are formed outside the kernel, once per node:
// sp = send_rep . W1s and rp = rec_rep . W1r. For every edge e (sender s,
// receiver r) and batch member b:
//
//   edge_val = LN(We2 . SiLU(We1 . f[e] + be1) + be2)   (EDGE_RAW: in-kernel
//              embedder on the raw static features, shared across the batch)
//            | edge[e]                                   (EDGE_SHARED)
//            | edge[e, b]                                (EDGE_BATCHED)
//   pre      = edge_val . W1e + sp[s, b] + rp[r, b] + b1
//              (written out as pre[e, b] when the caller will differentiate:
//              the backward kernel, fused_edge_v2_bwd.cu, starts from it)
//   msg      = LN(SiLU(pre) . W2 + b2)         (LN optional: layer_norm)
//   new_edge[e, b] = edge_val + msg            (update_edges only)
//   aggr[r, b]     = sum of msg over the edges into r (receivers without
//                    edges get 0)
//
// There is no propagation variant: a PropagationNet needs the raw sender
// rows for its residual and stays on K1 + K3, as in the JAX package.
//
// Design. The TPU kernel walks a visit-major grid over banded sender
// windows and gathers the sender projections with one-hot matmuls, because
// Mosaic has no dynamic row gather. Hopper has indexed loads. The layout is
// K3's (fused_edge.cu): one block owns R consecutive receivers (R*B <= 32)
// and their contiguous range of the receiver-sorted CSR, walks it in tiles
// of TE = 64/B edges (64 rows of (edge, b)), keeps the edge MLP's weights in
// shared memory and sums each receiver's messages in registers in edge
// order, without atomics, writing every aggregate row once. What differs:
//   * no x_send array exists: each (edge, b) row loads its sender's row
//     sp[sender[e], b] by index, one 16-byte load per thread and row
//     (16 threads cover one 256-byte row). At MEPS size sp is 6.7 MB where
//     the senders are mesh nodes (m2m, m2g) and stays in the 50 MB L2; g2m's
//     grid senders make it 65 MB;
//   * rp[r, b] is read once per (receiver, b) into shared memory, where K3
//     computed rec . W1r;
//   * the per-(edge, b) product x_send . W1s is gone, and with it W1s and
//     the sender tile in shared memory. What is left per (edge, b) row is
//     the second layer and, for a batched edge input, edge . W1e.
//
// Bound on the H100: operations, as K3: the products run in exact float32
// on the SIMT units (67 TFLOP/s), at about 2*D FLOP per byte moved, above
// that rate's ridge point of ~20 FLOP/byte.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_common.cuh"

namespace {

using namespace fused_edge;

struct Params {
  const float* edge;
  const float* sp;
  const float* rp;
  const int* rowptr;
  const int* senders;
  const float* w1;
  const float* b1;
  const float* w2;
  const float* b2;
  const float* gamma;
  const float* beta;
  const float* ew1;
  const float* eb1;
  const float* ew2;
  const float* eb2;
  const float* eg;
  const float* ebt;
  float* aggr;
  float* new_edge;
  float* pre;
  int num_rec;
  int batch;
  int feat;
  int recv_per_block;
  int edges_per_tile;
  int update_edges;
  int layer_norm;
};

// Shared-memory plan, in floats. The same function sizes the launch.
struct Smem {
  int w1e, w2, ew2, ew1, vec, xe, h, rp, f, ints, total;
};

__host__ __device__ constexpr Smem smem_plan(int mode) {
  Smem s{};
  int o = 0;
  s.w1e = o; o += D * D;
  s.w2 = o; o += D * D;
  s.ew2 = o; o += (mode == EDGE_RAW) ? D * D : 0;
  s.ew1 = o; o += (mode == EDGE_RAW) ? kMaxFeat * D : 0;
  s.vec = o; o += 8 * D;
  s.xe = o; o += kTileRows * kLd;
  s.h = o; o += kTileRows * kLd;
  s.rp = o; o += kRecRows * D;
  s.f = o; o += (mode == EDGE_RAW) ? kTileRows * kMaxFeat : 0;
  // rowptr (<= 33), receiver and sender of each tile edge (64 each)
  s.ints = o; o += 33 + 2 * kTileRows;
  s.total = o;
  return s;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
fused_edge_v2_fwd(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr Smem L = smem_plan(MODE);
  float* sW1e = smem + L.w1e;
  float* sW2 = smem + L.w2;
  float* sEW2 = smem + L.ew2;
  float* sEW1 = smem + L.ew1;
  float* sB1 = smem + L.vec;
  float* sB2 = sB1 + D;
  float* sG = sB2 + D;
  float* sBt = sG + D;
  float* sEB1 = sBt + D;
  float* sEB2 = sEB1 + D;
  float* sEG = sEB2 + D;
  float* sEBt = sEG + D;
  float* sXe = smem + L.xe;
  float* sH = smem + L.h;
  float* sRP = smem + L.rp;
  float* sF = smem + L.f;
  int* sRowptr = reinterpret_cast<int*>(smem + L.ints);
  int* sRloc = sRowptr + 33;
  int* sSend = sRloc + kTileRows;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int B = p.batch, R = p.recv_per_block, TE = p.edges_per_tile;
  const int ni_e = (TE + 15) / 16;  // 16-row groups that hold the tile's edges
  const int F = p.feat;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, p.num_rec - r0);
  const int BD = B * D;
  const float4* sp4 = reinterpret_cast<const float4*>(p.sp);

  // ---- weights, biases, the block's rowptr and rp rows --------------------
  load_weight_t(sW1e, D, p.w1, 3 * D, 0);
  load_weight_t(sW2, D, p.w2, D, 0);
  if (MODE == EDGE_RAW) {
    load_weight_t(sEW2, D, p.ew2, D, 0);
    for (int i = tid; i < F * D; i += kThreads) {  // (D, F) -> (F, D)
      const int k = i / D, c = i - k * D;
      sEW1[i] = __ldg(p.ew1 + c * F + k);
    }
  }
  if (tid < D) {
    sB1[tid] = p.b1[tid];
    sB2[tid] = p.b2[tid];
    sG[tid] = p.layer_norm ? p.gamma[tid] : 1.0f;
    sBt[tid] = p.layer_norm ? p.beta[tid] : 0.0f;
    if (MODE == EDGE_RAW) {
      sEB1[tid] = p.eb1[tid];
      sEB2[tid] = p.eb2[tid];
      sEG[tid] = p.eg[tid];
      sEBt[tid] = p.ebt[tid];
    }
  }
  if (tid <= nr) sRowptr[tid] = p.rowptr[r0 + tid];
  {
    const float4* src =
        reinterpret_cast<const float4*>(p.rp + static_cast<long long>(r0) * BD);
    for (int i = tid; i < kRecRows * (D / 4); i += kThreads)
      reinterpret_cast<float4*>(sRP)[i] =
          i < nr * B * (D / 4) ? __ldg(src + i) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float agg[kAggPerThread];
#pragma unroll
  for (int j = 0; j < kAggPerThread; ++j) agg[j] = 0.0f;
  __syncthreads();

  const int e_begin = sRowptr[0], e_end = sRowptr[nr];
  for (int t0 = e_begin; t0 < e_end; t0 += TE) {
    const int ne = min(TE, e_end - t0);
    const int nrows = ne * B;

    // ---- tile loads: edge input, senders, receivers ------------------------
    if (MODE == EDGE_BATCHED) {
      load_rows(sXe, p.edge + static_cast<long long>(t0) * BD, nrows, kTileRows);
    } else if (MODE == EDGE_SHARED) {
      load_rows(sXe, p.edge + static_cast<long long>(t0) * D, ne, 16 * ni_e);
    } else {
      for (int i = tid; i < 16 * ni_e * F; i += kThreads) {
        const int el = i / F;
        sF[i] = el < ne ? p.edge[static_cast<long long>(t0) * F + i] : 0.0f;
      }
    }
    if (tid < ne) sSend[tid] = p.senders[t0 + tid];
    if (tid < nr) {
      const int a = max(sRowptr[tid], t0), z = min(sRowptr[tid + 1], t0 + ne);
      for (int e = a; e < z; ++e) sRloc[e - t0] = tid;
    }
    __syncthreads();

    if (MODE == EDGE_RAW)
      embed_tile(sXe, sH, sF, F, sEW1, sEB1, sEW2, sEB2, sEG, sEBt, rg, cg, ni_e);
    float acc[4][4];
    if (MODE != EDGE_BATCHED) {
      // edge_val . W1e once per edge, shared by the batch
      zero(acc);
      mm_rows(acc, sXe, sW1e, rg, cg, ni_e);
      store_rows(sH, acc, rg, cg, ni_e);
      __syncthreads();
    }

    // ---- first layer: edge product + sp[sender] + rp[receiver] + b1 ------
    zero(acc);
    if (MODE == EDGE_BATCHED) mm_acc<4>(acc, sXe, sW1e, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rg + 16 * i;
      const int el = m / B, b = m - el * B;
      int rl = 0;
      float4 s4 = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < nrows) {
        rl = sRloc[el];
        s4 = __ldg(sp4 + (static_cast<long long>(sSend[el]) * B + b) * (D / 4) + cg);
      }
      const float sv[4] = {s4.x, s4.y, s4.z, s4.w};
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        v[j] = acc[i][j] + sv[j] + sRP[(rl * B + b) * D + c] + sB1[c];
        if (MODE != EDGE_BATCHED) v[j] += sH[el * kLd + c];
        acc[i][j] = silu(v[j]);
      }
      if (p.pre != nullptr && m < nrows)  // saved for the backward (K8)
        *reinterpret_cast<float4*>(
            p.pre + (static_cast<long long>(t0) * B + m) * D + 4 * cg) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    store_rows(sH, acc, rg, cg);
    __syncthreads();

    // ---- second layer, LayerNorm, edge residual ----------------------------
    zero(acc);
    mm_acc<4>(acc, sH, sW2, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += sB2[4 * cg + j];
    if (p.layer_norm) row_layer_norm(acc, sG, sBt, cg);
    if (p.update_edges) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int m = rg + 16 * i;
        if (m >= nrows) continue;
        const float* base =
            (MODE == EDGE_BATCHED) ? sXe + m * kLd : sXe + (m / B) * kLd;
        *reinterpret_cast<float4*>(p.new_edge +
                                   (static_cast<long long>(t0) * B + m) * D +
                                   4 * cg) =
            make_float4(base[4 * cg] + acc[i][0], base[4 * cg + 1] + acc[i][1],
                        base[4 * cg + 2] + acc[i][2], base[4 * cg + 3] + acc[i][3]);
      }
    }
    __syncthreads();
    store_rows(sH, acc, rg, cg);
    __syncthreads();

    sum_into_receivers(agg, sH, sRowptr, nr, t0, ne, B);  // edge order, no atomics
    __syncthreads();
  }
  store_receiver_sums(p.aggr, agg, r0, nr, B);
}

template <int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_plan(MODE).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fused_edge_v2_fwd<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.num_rec + p.recv_per_block - 1) / p.recv_per_block;
  fused_edge_v2_fwd<MODE><<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shapes (all f32 contiguous and 16-byte aligned on the device; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   sp: (N_send, B, D) sender projections, N_send > every sender index
//   rp: (num_rec, B, D) receiver projections
//   rowptr: (num_rec + 1,) int32; senders: (E,) int32, receiver-sorted order
//   w1: (D, 3D) (only its W1e slice, columns 0..D-1, is read), b1: (D,),
//   w2: (D, D), b2, gamma, beta: (D,)
//   ew1: (D, feat), eb1, eb2, eg, ebt: (D,), ew2: (D, D)   [edge_mode 0]
//   aggr: (num_rec, B, D) out; new_edge: (E, B, D) out [update_edges];
//   pre: (E, B, D) out, the first layer's pre-activation, or null
// 1 <= batch <= 32 and feat <= 8 are checked by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int nl_fused_edge_v2_fwd(
    int edge_mode, int num_rec, int batch, int feat, int update_edges,
    int layer_norm, const void* edge, const void* sp, const void* rp,
    const void* rowptr, const void* senders, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* aggr, void* new_edge, void* pre,
    void* stream) {
  if (num_rec <= 0) return static_cast<int>(cudaSuccess);
  if (batch < 1 || batch > kRecRows || feat > kMaxFeat)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.edge = static_cast<const float*>(edge);
  p.sp = static_cast<const float*>(sp);
  p.rp = static_cast<const float*>(rp);
  p.rowptr = static_cast<const int*>(rowptr);
  p.senders = static_cast<const int*>(senders);
  p.w1 = static_cast<const float*>(w1);
  p.b1 = static_cast<const float*>(b1);
  p.w2 = static_cast<const float*>(w2);
  p.b2 = static_cast<const float*>(b2);
  p.gamma = static_cast<const float*>(gamma);
  p.beta = static_cast<const float*>(beta);
  p.ew1 = static_cast<const float*>(ew1);
  p.eb1 = static_cast<const float*>(eb1);
  p.ew2 = static_cast<const float*>(ew2);
  p.eb2 = static_cast<const float*>(eb2);
  p.eg = static_cast<const float*>(eg);
  p.ebt = static_cast<const float*>(ebt);
  p.aggr = static_cast<float*>(aggr);
  p.new_edge = static_cast<float*>(new_edge);
  p.pre = static_cast<float*>(pre);
  p.num_rec = num_rec;
  p.batch = batch;
  p.feat = feat;
  p.recv_per_block = kRecRows / batch;
  p.edges_per_tile = kTileRows / batch;
  p.update_edges = update_edges;
  p.layer_norm = layer_norm;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (edge_mode) {
    case EDGE_RAW: err = launch<EDGE_RAW>(p, s); break;
    case EDGE_SHARED: err = launch<EDGE_SHARED>(p, s); break;
    case EDGE_BATCHED: err = launch<EDGE_BATCHED>(p, s); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
