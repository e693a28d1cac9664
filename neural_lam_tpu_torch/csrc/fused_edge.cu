// K3: fused edge-phase forward of one InteractionNet / PropagationNet step.
//
// Replaces neural_lam_tpu/ops/pallas_fused.py::_fused_fwd_impl (the
// _fused_fwd_kernel + _embed_forward pallas_call), which the JAX package
// builds through make_fused_interaction. For every edge e (receiver r,
// sender gathered by K1 into send[e]) and batch member b:
//
//   edge_val = LN(We2 . SiLU(We1 . f[e] + be1) + be2)   (EDGE_RAW: in-kernel
//              embedder on the raw static features, shared across the batch)
//            | edge[e]                                   (EDGE_SHARED)
//            | edge[e, b]                                (EDGE_BATCHED)
//   pre      = edge_val . W1e + send[e, b] . W1s + (rec[r, b] . W1r) + b1
//              (written out as pre[e, b] when the caller will differentiate:
//              the backward kernel, fused_edge_bwd.cu, starts from it)
//   msg      = LN(SiLU(pre) . W2 + b2)         (LN optional: layer_norm)
//   msg     += send[e, b]                      (propagation only)
//   new_edge[e, b] = edge_val + msg            (update_edges only)
//   aggr[r, b]     = sum of msg over the edges into r (receivers without
//                    edges get 0)
//
// The weights arrive in PyTorch's nn.Linear layout (out, in): w1 is the
// (D, 3D) first edge-MLP layer [W1e | W1s | W1r], w2 is (D, D). LayerNorm
// uses the biased variance and eps 1e-5, as torch.nn.LayerNorm does.
//
// Design (what the TPU kernel computed, not how): the TPU version gathers
// receiver rows and aggregates with one-hot MXU matmuls over 256x512
// blocked-CSR tiles and folds the batch into lanes with kron(I, W) weights.
// Here the edges are a receiver-sorted CSR (rowptr) without dead slots. One
// block owns R consecutive receivers (R*B <= 32), so it owns the contiguous
// edge range of those receivers:
//   * the projection rec . W1r is computed once per (receiver, b) at block
//     start (the projection-first order of pallas_fused.py:264-278) and
//     kept in shared memory;
//   * the block walks its edges in tiles of TE = 64/B edges (64 rows of
//     (edge, b)), each row of D = 64 features; the sender rows and edge
//     rows of a tile are contiguous in device memory and are copied with
//     16-byte loads;
//   * the embedder runs once per edge and its output is reused across the
//     batch (the shared-edge path of pallas_fused.py:209-216), and so is
//     edge_val . W1e for EDGE_RAW and EDGE_SHARED; these per-edge products
//     run on the tile's TE edge rows only (rounded up to 16), not on all
//     64 (edge, b) rows;
//   * all weights of the edge MLP and the embedder stay in shared memory,
//     transposed to (in, out) on the way in: each thread reads 8
//     consecutive inputs of one output row (one 32-byte sector) and
//     neighbouring threads take neighbouring outputs, so the reads use
//     whole sectors and the shared-memory writes hit distinct banks;
//   * each product of up to 64 rows by a 64x64 weight is register-tiled,
//     4x4 outputs per thread, with 16-byte shared-memory loads of both
//     the activations (4 inputs of a row) and the weights (4 outputs);
//   * each thread keeps its share of the block's (receiver, b, feature)
//     sums in registers and adds the tile's messages in edge order, so the
//     sum is deterministic and needs no atomics; each aggregate row is
//     written once at the end.
//
// Bound on the H100: operations. The products must run in exact float32
// (parity with the JAX reference), so the peak is the 67 TFLOP/s of the
// float32 SIMT units, and at hidden 64 the kernel does about 2*D FLOP per
// byte it moves, above that rate's ridge point of ~20 FLOP/byte.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include "fused_edge_common.cuh"

namespace {

using namespace fused_edge;

struct Params {
  const float* edge;
  const float* send;
  const float* rec;
  const int* rowptr;
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
  int propagation;
  int layer_norm;
};

// Shared-memory plan, in floats. The same function sizes the launch.
struct Smem {
  int w1e, w1s, w2, ew2, ew1, vec, xs, xe, h, rp, f, ints, total;
};

__host__ __device__ constexpr Smem smem_plan(int mode) {
  Smem s{};
  int o = 0;
  s.w1e = o; o += D * D;
  s.w1s = o; o += D * D;
  s.w2 = o; o += D * D;
  s.ew2 = o; o += (mode == EDGE_RAW) ? D * D : 0;
  s.ew1 = o; o += (mode == EDGE_RAW) ? kMaxFeat * D : 0;
  s.vec = o; o += 8 * D;
  s.xs = o; o += kTileRows * kLd;
  s.xe = o; o += kTileRows * kLd;
  s.h = o; o += kTileRows * kLd;
  s.rp = o; o += kRecRows * D;
  s.f = o; o += (mode == EDGE_RAW) ? kTileRows * kMaxFeat : 0;
  s.ints = o; o += 100;  // rowptr (<= 33) + receiver of each tile edge (64)
  s.total = o;
  return s;
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 2)
fused_edge_fwd(const Params p) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  constexpr Smem L = smem_plan(MODE);
  float* sW1e = smem + L.w1e;
  float* sW1s = smem + L.w1s;
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
  float* sXs = smem + L.xs;
  float* sXe = smem + L.xe;
  float* sH = smem + L.h;
  float* sRP = smem + L.rp;
  float* sF = smem + L.f;
  int* sRowptr = reinterpret_cast<int*>(smem + L.ints);
  int* sRloc = sRowptr + 33;

  const int tid = threadIdx.x;
  const int rg = tid >> 4, cg = tid & 15;
  const int B = p.batch, R = p.recv_per_block, TE = p.edges_per_tile;
  const int ni_e = (TE + 15) / 16;  // 16-row groups that hold the tile's edges
  const int F = p.feat;
  const int r0 = blockIdx.x * R;
  const int nr = min(R, p.num_rec - r0);
  const int BD = B * D;

  // ---- weights, biases, the block's rowptr and receiver rows ------------
  load_weight_t(sW1e, D, p.w1, 3 * D, 0);
  load_weight_t(sW1s, D, p.w1, 3 * D, D);
  load_weight_t(sW2, D, p.w2, D, 0);
  // W1r lives in the (not yet used) sH tile for the receiver projection
  load_weight_t(sH, kLd, p.w1, 3 * D, 2 * D);
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
  load_rows(sXs, p.rec + static_cast<long long>(r0) * BD, nr * B, kRecRows);
  __syncthreads();

  // ---- rec . W1r once per (receiver, b): rows rg and rg + 16 ------------
  {
    float acc[4][4];
    zero(acc);
    mm_acc<2, kLd>(acc, sXs, sH, rg, cg);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      *reinterpret_cast<float4*>(sRP + (rg + 16 * i) * D + 4 * cg) =
          make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
  }
  float agg[kAggPerThread];
#pragma unroll
  for (int j = 0; j < kAggPerThread; ++j) agg[j] = 0.0f;
  __syncthreads();

  const int e_begin = sRowptr[0], e_end = sRowptr[nr];
  for (int t0 = e_begin; t0 < e_end; t0 += TE) {
    const int ne = min(TE, e_end - t0);
    const int nrows = ne * B;

    // ---- tile loads ------------------------------------------------------
    load_rows(sXs, p.send + static_cast<long long>(t0) * BD, nrows, kTileRows);
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
    if (tid < nr) {
      const int a = max(sRowptr[tid], t0), z = min(sRowptr[tid + 1], t0 + ne);
      for (int e = a; e < z; ++e) sRloc[e - t0] = tid;
    }
    __syncthreads();

    float acc[4][4];
    if (MODE == EDGE_RAW) {
      // embedder hidden layer: SiLU(f . We1 + be1), one row per edge
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (i >= ni_e) break;
        const int el = rg + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 4 * cg + j;
          float v = sEB1[c];
          for (int f = 0; f < F; ++f) v = fmaf(sF[el * F + f], sEW1[f * D + c], v);
          acc[i][j] = silu(v);
        }
      }
      store_rows(sH, acc, rg, cg, ni_e);
      __syncthreads();
      zero(acc);
      mm_rows(acc, sH, sEW2, rg, cg, ni_e);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sEB2[4 * cg + j];
      row_layer_norm(acc, sEG, sEBt, cg, ni_e);
      store_rows(sXe, acc, rg, cg, ni_e);
      __syncthreads();
    }
    if (MODE != EDGE_BATCHED) {
      // edge_val . W1e once per edge, shared by the batch
      zero(acc);
      mm_rows(acc, sXe, sW1e, rg, cg, ni_e);
      store_rows(sH, acc, rg, cg, ni_e);
      __syncthreads();
    }

    // ---- first layer -----------------------------------------------------
    zero(acc);
    if (MODE == EDGE_BATCHED) mm_acc<4>(acc, sXe, sW1e, rg, cg);
    mm_acc<4>(acc, sXs, sW1s, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rg + 16 * i;
      const int el = m / B, b = m - el * B;
      const int rl = m < nrows ? sRloc[el] : 0;
      float v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * cg + j;
        v[j] = acc[i][j] + sB1[c] + sRP[(rl * B + b) * D + c];
        if (MODE != EDGE_BATCHED) v[j] += sH[el * kLd + c];
        acc[i][j] = silu(v[j]);
      }
      if (p.pre != nullptr && m < nrows)  // saved for the backward (K4)
        *reinterpret_cast<float4*>(
            p.pre + (static_cast<long long>(t0) * B + m) * D + 4 * cg) =
            make_float4(v[0], v[1], v[2], v[3]);
    }
    __syncthreads();
    store_rows(sH, acc, rg, cg);
    __syncthreads();

    // ---- second layer, LayerNorm, residuals ------------------------------
    zero(acc);
    mm_acc<4>(acc, sH, sW2, rg, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] += sB2[4 * cg + j];
    if (p.layer_norm) row_layer_norm(acc, sG, sBt, cg);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = rg + 16 * i;
      const int el = m / B;
      if (p.propagation) {
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += sXs[m * kLd + 4 * cg + j];
      }
      if (p.update_edges && m < nrows) {
        const float* base =
            (MODE == EDGE_BATCHED) ? sXe + m * kLd : sXe + el * kLd;
        const float4 out = make_float4(
            base[4 * cg] + acc[i][0], base[4 * cg + 1] + acc[i][1],
            base[4 * cg + 2] + acc[i][2], base[4 * cg + 3] + acc[i][3]);
        *reinterpret_cast<float4*>(p.new_edge +
                                   (static_cast<long long>(t0) * B + m) * D +
                                   4 * cg) = out;
      }
    }
    __syncthreads();
    store_rows(sH, acc, rg, cg);
    __syncthreads();

    // ---- receiver sums: edge order, no atomics ---------------------------
#pragma unroll
    for (int j = 0; j < kAggPerThread; ++j) {
      const int idx = tid + j * kThreads;
      if (idx < nr * BD) {
        const int rl = idx / BD, rem = idx - rl * BD;
        const int b = rem / D, d = rem - b * D;
        const int a = max(sRowptr[rl], t0), z = min(sRowptr[rl + 1], t0 + ne);
        float s = agg[j];
        for (int e = a; e < z; ++e) s += sH[((e - t0) * B + b) * kLd + d];
        agg[j] = s;
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int j = 0; j < kAggPerThread; ++j) {
    const int idx = tid + j * kThreads;
    if (idx < nr * BD) p.aggr[static_cast<long long>(r0) * BD + idx] = agg[j];
  }
}

template <int MODE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_plan(MODE).total * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fused_edge_fwd<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (p.num_rec + p.recv_per_block - 1) / p.recv_per_block;
  fused_edge_fwd<MODE><<<blocks, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// Shapes (all f32 contiguous on the device unless noted; D = 64):
//   edge: (E, feat) raw features [edge_mode 0], (E, D) [1], (E, B, D) [2]
//   send: (E, B, D) sender rows in receiver-sorted edge order (from K1)
//   rec: (num_rec, B, D); rowptr: (num_rec + 1,) int32
//   w1: (D, 3D), b1: (D,), w2: (D, D), b2, gamma, beta: (D,)
//   ew1: (D, feat), eb1, eb2, eg, ebt: (D,), ew2: (D, D)   [edge_mode 0]
//   aggr: (num_rec, B, D) out; new_edge: (E, B, D) out [update_edges];
//   pre: (E, B, D) out, the first layer's pre-activation, or null
// 1 <= batch <= 32 and feat <= 8 are checked by the caller. Returns
// cudaGetLastError() after the launch.
extern "C" int nl_fused_edge_fwd(
    int edge_mode, int num_rec, int batch, int feat, int update_edges,
    int propagation, int layer_norm, const void* edge, const void* send,
    const void* rec, const void* rowptr, const void* w1, const void* b1,
    const void* w2, const void* b2, const void* gamma, const void* beta,
    const void* ew1, const void* eb1, const void* ew2, const void* eb2,
    const void* eg, const void* ebt, void* aggr, void* new_edge, void* pre,
    void* stream) {
  if (num_rec <= 0) return static_cast<int>(cudaSuccess);
  if (batch < 1 || batch > kRecRows || feat > kMaxFeat)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.edge = static_cast<const float*>(edge);
  p.send = static_cast<const float*>(send);
  p.rec = static_cast<const float*>(rec);
  p.rowptr = static_cast<const int*>(rowptr);
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
  p.propagation = propagation;
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
