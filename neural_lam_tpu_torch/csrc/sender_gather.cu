// K1: sender gather, out[e, :] = x[senders[e], :].
//
// Replaces neural_lam_tpu/ops/pallas_segment.py::banded_expand_nondiff
// (the _banded_kernel(transpose=True) pallas_call), which the JAX package
// reaches through ops/segment.py::gather_senders. The TPU kernel gathers
// with one-hot MXU matmuls over banded sender windows because Mosaic has no
// dynamic row gather; Hopper has indexed loads, so this is a plain row copy
// in receiver-sorted edge order with no dead slots.
//
// Bound on the H100: bytes. Each output row (B*D floats, 1 KB at batch 4
// and hidden 64) is written once and its sender row read once; there are
// no operations to speak of. Design: one thread per float4 of the output,
// consecutive threads on consecutive 16-byte words of a row, so both the
// read of the sender row and the write of the edge row are coalesced; the
// sender index is read once per row per warp (a broadcast) and the sender
// rows, far fewer than the edges, stay in L2.
//
// Measured on an H100 by device time (chip_smoke.py's bf16 lines, PERF.md
// section 6), summed over GraphLAM's six MEPS sites at batch 4: the bf16
// copy runs at about 85 % of this bound, the float32 one at about 79 %.
// A warp-per-row bf16 form (the senders of 32 rows in one load, shuffled
// across the warp; four rows' loads in flight before their stores; no
// division per word) came within 4 % of it and was not kept.
//
// Rows of bf16 (the JAX package gathers bf16 rows under mixed precision and
// NEURAL_LAM_TPU_MATMUL_PRECISION=high, ops/segment.py:205-216) are the
// same copy at half the bytes: the kernels are templates on the word they
// move, a 16-byte word (4 floats or 8 bf16 values) when a row is a whole
// number of them, else one element (float or bf16). The copy is exact.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// 16-byte words of rows of T (float or __nv_bfloat16): 4 floats or 8 bf16
// values a word, the same copy for either; T names the instantiation
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_vec4(const float4* __restrict__ x, const int* __restrict__ idx,
                 float4* __restrict__ out, long long n_vec, int row_vec) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_vec; i += stride) {
    const long long e = i / row_vec;
    const int c = static_cast<int>(i - e * row_vec);
    out[i] = __ldg(x + static_cast<long long>(__ldg(idx + e)) * row_vec + c);
  }
}

// T: the element, float or __nv_bfloat16
template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_scalar(const T* __restrict__ x, const int* __restrict__ idx,
                   T* __restrict__ out, long long n, int row) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += stride) {
    const long long e = i / row;
    const int c = static_cast<int>(i - e * row);
    out[i] = __ldg(x + static_cast<long long>(__ldg(idx + e)) * row + c);
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // a few waves of resident blocks
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename T>
int gather(const void* x, const void* idx, void* out, long long n_rows, int row_width,
           int vec4, void* stream) {
  if (n_rows <= 0 || row_width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int row_vec = row_width * static_cast<int>(sizeof(T)) / 16;
    const long long n_vec = n_rows * row_vec;
    gather_rows_vec4<T><<<grid_for(n_vec), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(idx),
        static_cast<float4*>(out), n_vec, row_vec);
  } else {
    const long long n = n_rows * row_width;
    gather_rows_scalar<T><<<grid_for(n), kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const int*>(idx), static_cast<T*>(out), n,
        row_width);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x: (num_send, row_width) f32, idx: (n_rows,) int32, out: (n_rows, row_width)
// f32, all contiguous on the device. ``vec4`` != 0 selects 16-byte accesses
// (row_width % 4 == 0 and 16-byte aligned pointers, checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int nl_sender_gather(const void* x, const void* idx, void* out,
                                long long n_rows, int row_width, int vec4,
                                void* stream) {
  return gather<float>(x, idx, out, n_rows, row_width, vec4, stream);
}

// The same for bf16 rows: ``vec4`` != 0 selects 16-byte accesses (row_width
// % 8 == 0 and 16-byte aligned pointers, checked by the caller).
extern "C" int nl_sender_gather_bf16(const void* x, const void* idx, void* out,
                                     long long n_rows, int row_width, int vec4,
                                     void* stream) {
  return gather<__nv_bfloat16>(x, idx, out, n_rows, row_width, vec4, stream);
}
