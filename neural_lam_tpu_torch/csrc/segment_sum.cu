// K5: segment sum, out[r, :] = sum of msg[slot, :] over the slots whose
// receiver is r; receivers without a slot get 0.
//
// Replaces neural_lam_tpu/ops/pallas_segment.py::_blocked_segment_sum_fwd_impl
// (its pallas_call over _segsum_kernel), which the JAX package reaches
// through blocked_segment_sum_nondiff / make_blocked_segment_sum as the
// forward of ops/segment.py::aggregate_sum and as the VJP of
// gather_receivers. The TPU kernel sums with one-hot MXU matmuls over
// (block_rows x tile) blocks of a blocked-CSR layout with dead slots. The
// port's edge sets are receiver-sorted CSR without padding, so the slots of
// receiver r are the contiguous rows rowptr[r] .. rowptr[r + 1] of msg and
// the sum is a segmented reduction over contiguous rows: the thread that
// owns a 16-byte word of output row r walks that run in slot order, adds
// the matching words of msg in float32 and writes the word once. It is the
// sender scatter (sender_scatter.cu) without its slot indirection. The
// order of the sum is fixed and there are no float atomics, so the result
// is deterministic, as the JAX sum is.
//
// Bound on the H100: bytes. Each row of msg is read once and each output
// row written once, with one add per word read.
//
// Work split: one thread per output word, consecutive threads on
// consecutive words, so a warp reads 512 contiguous bytes of a slot's row
// per step and the write is coalesced; the two rowptr entries are read once
// per row per warp (a broadcast). Four loads are in flight per thread.
// - Degree 1 (the down edges of a hierarchy): the loop runs once and the
//   kernel is a row copy, msg and out each touched once, fully coalesced.
// - 6,561 receivers of degree 9 at 1 KB rows (a mesh level at batch 4):
//   419,904 threads in 1,641 blocks, twelve or so per SM, each thread
//   issuing 9 independent 16-byte loads in three rounds; neighbouring
//   receivers' runs are adjacent in memory, so the grid as a whole streams
//   msg front to back once.
// - A skewed degree only lengthens the threads of that row; the edge sets
//   of this system have degrees of 1 to about 40.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ void add(float4& a, const float4 b) {
  a.x += b.x; a.y += b.y; a.z += b.z; a.w += b.w;
}
__device__ __forceinline__ void add(float& a, const float b) { a += b; }

template <typename T>
__device__ __forceinline__ T zero_of();
template <>
__device__ __forceinline__ float4 zero_of<float4>() {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
template <>
__device__ __forceinline__ float zero_of<float>() { return 0.0f; }

// T is float4 (row_words = row_width / 4) or float (row_words = row_width)
template <typename T>
__global__ void __launch_bounds__(kThreads)
segment_sum_rows(const T* __restrict__ msg, const int* __restrict__ rowptr,
                 T* __restrict__ out, long long n_words, int row_words) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_words; i += stride) {
    const long long r = i / row_words;
    const int c = static_cast<int>(i - r * row_words);
    const int a = __ldg(rowptr + r), z = __ldg(rowptr + r + 1);
    const T* p = msg + static_cast<long long>(a) * row_words + c;
    T sum = zero_of<T>();
    int k = a;
    // four loads in flight, added in slot order
    for (; k + 3 < z; k += 4, p += 4LL * row_words) {
      const T v0 = __ldg(p);
      const T v1 = __ldg(p + row_words);
      const T v2 = __ldg(p + 2LL * row_words);
      const T v3 = __ldg(p + 3LL * row_words);
      add(sum, v0);
      add(sum, v1);
      add(sum, v2);
      add(sum, v3);
    }
    for (; k < z; ++k, p += row_words) add(sum, __ldg(p));
    out[i] = sum;
  }
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // a few waves of resident blocks
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// msg: (E, row_width) f32 in receiver-sorted slot order, rowptr:
// (n_rec + 1,) int32 with rowptr[n_rec] == E, out: (n_rec, row_width) f32,
// all contiguous on the device. ``vec4`` != 0 selects 16-byte accesses
// (row_width % 4 == 0 and 16-byte aligned pointers, checked by the caller).
// Returns cudaGetLastError() after the launch.
extern "C" int nl_segment_sum(const void* msg, const void* rowptr, void* out,
                              long long n_rec, int row_width, int vec4,
                              void* stream) {
  if (n_rec <= 0 || row_width <= 0) return static_cast<int>(cudaSuccess);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int row_words = row_width / 4;
    const long long n_words = n_rec * row_words;
    segment_sum_rows<float4><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const float4*>(msg), static_cast<const int*>(rowptr),
        static_cast<float4*>(out), n_words, row_words);
  } else {
    const long long n_words = n_rec * row_width;
    segment_sum_rows<float><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const float*>(msg), static_cast<const int*>(rowptr),
        static_cast<float*>(out), n_words, row_width);
  }
  return static_cast<int>(cudaGetLastError());
}
