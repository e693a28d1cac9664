// K2: sender scatter, dx[s, :] = sum of g[slot, :] over the slots whose
// sender is s; rows without a slot get 0. The backward of K1.
//
// Replaces neural_lam_tpu/ops/pallas_segment.py::banded_scatter_nondiff
// (the _banded_kernel(transpose=False) pallas_call), which the JAX package
// reaches as the VJP of ops/segment.py::gather_senders. The TPU kernel
// scatters with one-hot MXU matmuls over banded sender windows. Here the
// edge set carries, beside its receiver-sorted order, the sender-sorted
// view of the same slots, built once on the host: perm (E,) lists the slot
// indices ordered by sender (stable, so ascending within a sender) and
// rowptr (n_tab + 1,) delimits each sender's run. The scatter is then a
// gather-reduce: the thread that owns a 16-byte word of an output row walks
// that sender's slots in perm order, adds the matching words of g in
// float32 and writes the word once. The order of the sum is fixed, so the
// result is deterministic, and there are no float atomics.
//
// Bound on the H100: bytes. Each row of g is read once and each output row
// written once; one add per word read. Consecutive threads take consecutive
// words of a row, so the reads of a slot's row and the write are coalesced;
// the slot indices are read once per row per warp (a broadcast).
//
// bf16 rows in (the JAX package's scatter under mixed precision and
// NEURAL_LAM_TPU_MATMUL_PRECISION=high: bf16 gradient rows, float32 sums
// out, ops/segment.py:250, :298): the kernel is a template on the word it
// reads, and each word is widened to float32 before it is added; the sums
// and the output stay float32. A bf16 row moves half the bytes.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes (neural_lam_tpu_torch/ops/kernel_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

int grid_for(long long n);

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

// a word of g, widened to the float32 word of the sum
__device__ __forceinline__ float4 load_word(const float4* p) { return __ldg(p); }
__device__ __forceinline__ float load_word(const float* p) { return __ldg(p); }
struct Bf16x4 {  // four bf16 values, 8 bytes
  uint2 bits;
};
__device__ __forceinline__ float4 load_word(const Bf16x4* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float load_word(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// In is the word read, Acc the float32 word summed and written: float4 and
// float4 or float and float (float32 rows; row_words = row_width / 4 or
// row_width), Bf16x4 and float4 or __nv_bfloat16 and float (bf16 rows)
template <typename In, typename Acc>
__global__ void __launch_bounds__(kThreads)
scatter_rows(const In* __restrict__ g, const int* __restrict__ perm,
             const int* __restrict__ rowptr, Acc* __restrict__ out,
             long long n_words, int row_words, int n_tab) {
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < n_words; i += stride) {
    const long long s = i / row_words;
    const int c = static_cast<int>(i - s * row_words);
    Acc sum = zero_of<Acc>();
    if (s < n_tab) {
      const int a = __ldg(rowptr + s), z = __ldg(rowptr + s + 1);
      int k = a;
      // two loads in flight, added in slot order
      for (; k + 1 < z; k += 2) {
        const Acc v0 =
            load_word(g + static_cast<long long>(__ldg(perm + k)) * row_words + c);
        const Acc v1 =
            load_word(g + static_cast<long long>(__ldg(perm + k + 1)) * row_words + c);
        add(sum, v0);
        add(sum, v1);
      }
      if (k < z)
        add(sum, load_word(g + static_cast<long long>(__ldg(perm + k)) * row_words + c));
    }
    out[i] = sum;
  }
}

template <typename In4, typename In1>
int scatter(const void* g, const void* perm, const void* rowptr, void* out,
            long long n_rows, int n_tab, int row_width, int vec4, void* stream) {
  if (n_rows <= 0 || row_width <= 0) return static_cast<int>(cudaSuccess);
  if (n_tab < 0 || n_tab > n_rows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec4) {
    const int row_words = row_width / 4;
    const long long n_words = n_rows * row_words;
    scatter_rows<In4, float4><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const In4*>(g), static_cast<const int*>(perm),
        static_cast<const int*>(rowptr), static_cast<float4*>(out), n_words,
        row_words, n_tab);
  } else {
    const long long n_words = n_rows * row_width;
    scatter_rows<In1, float><<<grid_for(n_words), kThreads, 0, s>>>(
        static_cast<const In1*>(g), static_cast<const int*>(perm),
        static_cast<const int*>(rowptr), static_cast<float*>(out), n_words,
        row_width, n_tab);
  }
  return static_cast<int>(cudaGetLastError());
}

int grid_for(long long n) {
  long long blocks = (n + kThreads - 1) / kThreads;
  const long long cap = 132LL * 32;  // a few waves of resident blocks
  if (blocks > cap) blocks = cap;
  return static_cast<int>(blocks < 1 ? 1 : blocks);
}

}  // namespace

// g: (E, row_width) f32, perm: (E,) int32 slot indices ordered by sender,
// rowptr: (n_tab + 1,) int32, out: (n_rows, row_width) f32 with
// n_rows >= n_tab (rows from n_tab on get 0), all contiguous on the device.
// ``vec4`` != 0 selects 16-byte accesses (row_width % 4 == 0 and 16-byte
// aligned pointers, checked by the caller). Returns cudaGetLastError()
// after the launch.
extern "C" int nl_sender_scatter(const void* g, const void* perm,
                                 const void* rowptr, void* out,
                                 long long n_rows, int n_tab, int row_width,
                                 int vec4, void* stream) {
  return scatter<float4, float>(g, perm, rowptr, out, n_rows, n_tab, row_width, vec4,
                                stream);
}

// The same with g in bf16 (``vec4`` != 0: row_width % 4 == 0, g 8-byte and
// out 16-byte aligned); out stays float32.
extern "C" int nl_sender_scatter_bf16(const void* g, const void* perm,
                                      const void* rowptr, void* out,
                                      long long n_rows, int n_tab, int row_width,
                                      int vec4, void* stream) {
  return scatter<Bf16x4, __nv_bfloat16>(g, perm, rowptr, out, n_rows, n_tab, row_width,
                                        vec4, stream);
}
