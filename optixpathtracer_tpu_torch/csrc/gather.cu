// Random row gather for Hopper (sm_90a), kernel K6: out[i] = table[idx[i]].
//
// It replaces the inline `kernel` of `sparsecore_gather_gbs` in
// experiments/sparsecore_probe.py (a SparseCore `load_gather` under
// `pl.pallas_call`). Its plain PyTorch version is `table.index_select(0,
// idx)` (`gather_rows_torch` in optixpathtracer_tpu_torch/ops/gather.py).
// A gather moves bits, so the two agree bit for bit.
//
// What bounds it on the H100: device-memory bandwidth. Each output row is
// one random row of the table (512 bytes at the probe's width of 128 f32),
// read once and written once, with no reuse a cache could exploit when the
// table (512 MiB in the probe) exceeds the 50 MB L2. The design answers that
// with one warp per output row: lane j moves 16-byte words j, j + 32, ...
// of the row, so a 128-wide row is one fully coalesced 512-byte read and
// write per warp, and many rows are in flight per SM to cover the latency
// of the random reads. Row offsets are 64-bit (1M rows x 512 B overflows 32
// bits). Rows whose width is not a multiple of 4 floats, or tables not
// 16-byte aligned, take the same walk in 4-byte words. Indices must lie in
// [0, rows): one outside reads nothing and yields a row of NaN, where the
// plain version raises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // 8 rows per block

template <typename T>
__device__ __forceinline__ T nan_word();

template <>
__device__ __forceinline__ float nan_word<float>() {
  return __int_as_float(0x7fc00000);
}

template <>
__device__ __forceinline__ float4 nan_word<float4>() {
  const float q = __int_as_float(0x7fc00000);
  return make_float4(q, q, q, q);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_rows_kernel(const T* __restrict__ table, const int* __restrict__ idx, long long n,
                   int rows, int words, T* __restrict__ out) {
  const long long i = ((long long)blockIdx.x * kThreads + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (i >= n) return;
  const int r = idx[i];
  T* dst = out + (size_t)i * words;
  if (r < 0 || r >= rows) {
    for (int j = lane; j < words; j += 32) dst[j] = nan_word<T>();
    return;
  }
  const T* src = table + (size_t)r * words;
  for (int j = lane; j < words; j += 32) dst[j] = __ldg(src + j);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry point (loaded with ctypes). table (rows, w) f32 and idx (n,) int32
// are contiguous device tensors checked by the Python wrapper; out is
// (n, w) f32. vec4 != 0 moves 16-byte words (w % 4 == 0 and 16-byte aligned
// table and out). Returns cudaGetLastError() after the launch.
// ---------------------------------------------------------------------------
extern "C" int gather_launch(int device, const void* table, const void* idx, long long n, int rows,
                             int w, int vec4, void* out, void* stream) {
  cudaSetDevice(device);
  const long long blocks = (n * 32 + kThreads - 1) / kThreads;
  const cudaStream_t s = (cudaStream_t)stream;
  if (vec4) {
    gather_rows_kernel<float4><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float4*)table, (const int*)idx, n, rows, w / 4, (float4*)out);
  } else {
    gather_rows_kernel<float><<<(unsigned)blocks, kThreads, 0, s>>>(
        (const float*)table, (const int*)idx, n, rows, w, (float*)out);
  }
  return (int)cudaGetLastError();
}
