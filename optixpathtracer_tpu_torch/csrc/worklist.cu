// Worklist kernels for Hopper (sm_90a): order-preserving stream compaction
// (K5a) and the cluster-major (row, column) pair worklist (K5b).
//
// They replace the SparseCore path of optixpathtracer_tpu/ops/sc_worklist.py:
// `_sc_compact_kernel_body`, run by `pl.core_map` in `sc_compact_indices`
// (K5a), and `pair_worklist_sc_plan` / `sc_pair_worklist` (K5b). They compute
// the reference's XLA contracts `compact_indices_xla` and `pair_worklist_xla`
// exactly, as do the plain PyTorch versions beside the Python wrappers
// (`compact_indices_torch`, `pair_worklist_torch` in
// optixpathtracer_tpu_torch/ops/sc_worklist.py):
//
//   K5a: idx[p] = index of the p-th set flag for p < min(count, capacity),
//        -1 elsewhere; count = number of set flags (even above capacity).
//   K5b: the pairs (r, c) with bit c of bits[r] set, ordered by c then r, go
//        to position base[c] + rank_c(r), where base[c] is the number of set
//        bits in columns < c and rank_c(r) the number of rows before r with
//        bit c set; positions >= capacity are dropped, the rest of the
//        capacity is -1; count = total set bits.
//
// What bounds them on the H100: memory traffic and launch latency, not
// arithmetic. Each runs three launches: (1) per-block counts, from a warp
// `__ballot_sync` + `__popc` per warp and a sum over the block's 32 warps;
// (2) one block's exclusive scan of those counts into device-wide offsets
// (for K5b over (column, block) in column-major order, so the scan itself
// lays the columns end to end); (3) the scatter, which recomputes the
// ballots, adds the warp's exclusive prefix within its block and the lane's
// `__popc(ballot & lanes_below)`, and writes. The inputs are read twice
// (1.92M flags are 1.9 MB, L2-resident after the first pass); the writes go
// to consecutive positions for consecutive set lanes. No atomics, so the
// order and the result are deterministic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;  // flags (K5a) or rows (K5b) per block
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the warp-level scans assume 32 warps per block");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 32;  // bits per K5b word

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Exclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ int warp_exclusive_scan(int v) {
  const int lane = threadIdx.x & 31;
  int x = v;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x - v;
}

// Sum over the 32 lanes of a warp; every lane gets the result.
__device__ __forceinline__ int warp_sum(int v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

// ---------------------------------------------------------------------------
// Pass 2 of both: one block scans m counts (exclusive) into offsets, in
// chunks of kThreads with a running carry; the grand total goes to *total.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
scan_kernel(const int* __restrict__ counts, int m, int* __restrict__ offsets,
            int* __restrict__ total) {
  __shared__ int s_warp[kWarps];
  __shared__ int s_chunk;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int carry = 0;
  for (int base = 0; base < m; base += kThreads) {
    const int j = base + threadIdx.x;
    const int v = j < m ? counts[j] : 0;
    const int ex = warp_exclusive_scan(v);
    if (lane == 31) s_warp[warp] = ex + v;  // the warp's sum
    __syncthreads();
    if (warp == 0) {
      const int ws = s_warp[lane];
      const int wex = warp_exclusive_scan(ws);
      s_warp[lane] = wex;
      if (lane == 31) s_chunk = wex + ws;
    }
    __syncthreads();
    if (j < m) offsets[j] = carry + s_warp[warp] + ex;
    carry += s_chunk;
    __syncthreads();  // s_warp and s_chunk are rewritten by the next chunk
  }
  if (threadIdx.x == 0) *total = carry;
}

// ---------------------------------------------------------------------------
// K5a pass 1: per block of kThreads flags, the number of set flags.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
compact_count_kernel(const uint8_t* __restrict__ flags, long long n, int* __restrict__ counts) {
  __shared__ int s_warp[kWarps];
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool f = i < n && flags[i] != 0;
  const unsigned ballot = __ballot_sync(kFull, f);
  if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = __popc(ballot);
  __syncthreads();
  if (threadIdx.x < 32) {
    const int v = warp_sum(s_warp[threadIdx.x]);
    if (threadIdx.x == 0) counts[blockIdx.x] = v;
  }
}

// ---------------------------------------------------------------------------
// K5a pass 3: write each set flag's index at its packed position, then pad
// [total, capacity) with -1 (grid-stride, since capacity may exceed n).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
compact_scatter_kernel(const uint8_t* __restrict__ flags, long long n,
                       const int* __restrict__ offsets, const int* __restrict__ total,
                       int capacity, int* __restrict__ idx_out) {
  __shared__ int s_warp[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const bool f = i < n && flags[i] != 0;
  const unsigned ballot = __ballot_sync(kFull, f);
  if (lane == 0) s_warp[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    const int w = s_warp[lane];
    s_warp[lane] = warp_exclusive_scan(w);
  }
  __syncthreads();
  if (f) {
    const long long pos = (long long)offsets[blockIdx.x] + s_warp[warp] + __popc(ballot & lanes_below());
    if (pos < capacity) idx_out[pos] = (int)i;
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)*total + i; p < capacity; p += stride) idx_out[p] = -1;
}

// ---------------------------------------------------------------------------
// K5b pass 1: per block of kThreads rows, the number of set bits in each
// column, written column-major: counts[c * nb + block].
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
pair_count_kernel(const uint32_t* __restrict__ bits, int r, int nb, int* __restrict__ counts) {
  __shared__ int s_cnt[kCols][kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint32_t w = row < r ? bits[row] : 0u;
  for (int c = 0; c < kCols; ++c) {
    const unsigned ballot = __ballot_sync(kFull, (w >> c) & 1u);
    if (lane == 0) s_cnt[c][warp] = __popc(ballot);
  }
  __syncthreads();
  // warp c sums column c over the block's 32 warps
  const int v = warp_sum(s_cnt[warp][lane]);
  if (lane == 0) counts[(long long)warp * nb + blockIdx.x] = v;
}

// ---------------------------------------------------------------------------
// K5b pass 3: each set bit (row, c) goes to offsets[c * nb + block] + the
// set bits of column c in earlier warps of the block + those of earlier
// lanes of its warp; then [total, capacity) is padded with -1.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads)
pair_scatter_kernel(const uint32_t* __restrict__ bits, int r, int nb,
                    const int* __restrict__ offsets, const int* __restrict__ total,
                    int capacity, int* __restrict__ row_out, int* __restrict__ col_out) {
  __shared__ int s_off[kCols][kWarps];
  __shared__ int s_base[kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long row = (long long)blockIdx.x * kThreads + threadIdx.x;
  const uint32_t w = row < r ? bits[row] : 0u;
  for (int c = 0; c < kCols; ++c) {
    const unsigned ballot = __ballot_sync(kFull, (w >> c) & 1u);
    if (lane == 0) s_off[c][warp] = __popc(ballot);
  }
  if (threadIdx.x < kCols) s_base[threadIdx.x] = offsets[(long long)threadIdx.x * nb + blockIdx.x];
  __syncthreads();
  // warp c turns column c's per-warp counts into exclusive offsets
  const int cnt = s_off[warp][lane];
  s_off[warp][lane] = warp_exclusive_scan(cnt);
  __syncthreads();
  for (int c = 0; c < kCols; ++c) {
    const bool set = (w >> c) & 1u;
    const unsigned ballot = __ballot_sync(kFull, set);
    if (set) {
      const long long pos = (long long)s_base[c] + s_off[c][warp] + __popc(ballot & lanes_below());
      if (pos < capacity) {
        row_out[pos] = (int)row;
        col_out[pos] = c;
      }
    }
  }
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)*total + row; p < capacity; p += stride) {
    row_out[p] = -1;
    col_out[p] = -1;
  }
}

int blocks_for(long long n) {
  return n > 0 ? (int)((n + kThreads - 1) / kThreads) : 1;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Pointers are device pointers of
// contiguous tensors checked by the Python wrappers; `scratch` holds
// 2 * nb ints (K5a) or 2 * 32 * nb ints (K5b), nb = blocks_for(n or r);
// `stream` is the caller's cudaStream_t. Each returns cudaGetLastError()
// after its launches.
// ---------------------------------------------------------------------------
extern "C" int worklist_blocks(long long n) { return blocks_for(n); }

extern "C" int compact_launch(int device, const void* flags, long long n, int capacity,
                              void* idx_out, void* cnt_out, void* scratch, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for(n);
  int* counts = (int*)scratch;
  int* offsets = counts + nb;
  compact_count_kernel<<<nb, kThreads, 0, s>>>((const uint8_t*)flags, n, counts);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_kernel<<<1, kThreads, 0, s>>>(counts, nb, offsets, (int*)cnt_out);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  compact_scatter_kernel<<<nb, kThreads, 0, s>>>((const uint8_t*)flags, n, offsets,
                                                 (const int*)cnt_out, capacity, (int*)idx_out);
  return (int)cudaGetLastError();
}

extern "C" int pair_launch(int device, const void* bits, int r, int capacity, void* row_out,
                           void* col_out, void* cnt_out, void* scratch, void* stream) {
  cudaSetDevice(device);
  const cudaStream_t s = (cudaStream_t)stream;
  const int nb = blocks_for(r);
  int* counts = (int*)scratch;
  int* offsets = counts + kCols * nb;
  pair_count_kernel<<<nb, kThreads, 0, s>>>((const uint32_t*)bits, r, nb, counts);
  int rc = (int)cudaGetLastError();
  if (rc) return rc;
  scan_kernel<<<1, kThreads, 0, s>>>(counts, kCols * nb, offsets, (int*)cnt_out);
  rc = (int)cudaGetLastError();
  if (rc) return rc;
  pair_scatter_kernel<<<nb, kThreads, 0, s>>>((const uint32_t*)bits, r, nb, offsets,
                                              (const int*)cnt_out, capacity, (int*)row_out,
                                              (int*)col_out);
  return (int)cudaGetLastError();
}
