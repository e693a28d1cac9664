// K6: receiver expand, out[slot, :] = x[receiver[slot], :].
//
// Replaces neural_lam_tpu/ops/pallas_segment.py::_blocked_segment_sum_bwd_impl
// (its pallas_call over _expand_kernel), which the JAX package
// reaches through blocked_expand_nondiff as the forward of
// ops/segment.py::gather_receivers and as the VJP of aggregate_sum. The TPU
// kernel expands with one-hot MXU matmuls over the blocks of a blocked-CSR
// layout. The port's edge sets are receiver-sorted CSR, so the slots of
// receiver r are the contiguous rows rowptr[r] .. rowptr[r + 1] of out and
// the expand is a row copy driven by rowptr: the thread that owns a 16-byte
// word of receiver row r reads it once and writes it to each slot of the
// run.
//
// The sender gather (sender_gather.cu) given the per-slot receiver indices
// would compute the same function. This kernel is kept apart from it because
// the receiver order makes the index vector redundant: it reads (n_rec + 1)
// offsets instead of E indices, reads each receiver row exactly once where
// the gather re-reads it per slot, and needs no int32 copy of the edge set's
// int64 receiver vector. It has its own entry point and its own launch
// count, so a run can tell the receiver side of the unfused route from the
// sender side.
//
// Bound on the H100: bytes. Each receiver row is read once and each slot row
// written once; there are no operations. Work split: one thread per word of
// x, consecutive threads on consecutive words, so the read and every write
// of a warp cover 512 contiguous bytes; neighbouring receivers write
// adjacent runs, so the grid writes out front to back once. A receiver
// without slots reads its two offsets and does nothing; a degree of 1 is a
// row copy.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// T is float4 (row_words = row_width / 4) or float (row_words = row_width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
expand_rows(const T* __restrict__ x, const int* __restrict__ rowptr,
            T* __restrict__ out, long long n_words, int row_words) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_words; i += stride) {
    const long long r = i / row_words;
    const int c = static_cast<int>(i - r * row_words);
    const int a = __ldg(rowptr + r), z = __ldg(rowptr + r + 1);
    if (a >= z) continue;
    const T v = __ldg(x + i);
    T* p = out + static_cast<long long>(a) * row_words + c;
    for (int k = a; k < z; ++k, p += row_words) *p = v;
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // a few waves of resident blocks
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// x: (n_rec, row_width) f32, rowptr: (n_rec + 1,) int32 with
// rowptr[n_rec] == E, out: (E, row_width) f32 in receiver-sorted slot order,
// all contiguous on the device. Every slot belongs to one receiver, so the
// whole of out is written. ``vec4`` != 0 selects 16-byte accesses
// (row_width % 4 == 0 and 16-byte aligned pointers, checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int nl_receiver_expand(const void* x, const void* rowptr, void* out,
                                  long long n_rec, int row_width, int vec4,
                                  void* stream) {
  if (n_rec <= 0 || row_width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int row_words = row_width / 4;
    const long long n_words = n_rec * row_words;
    expand_rows<float4><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const float4*>(x), static_cast<const int*>(rowptr),
        static_cast<float4*>(out), n_words, row_words);
  } else {
    const long long n_words = n_rec * row_width;
    expand_rows<float><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const int*>(rowptr),
        static_cast<float*>(out), n_words, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}
