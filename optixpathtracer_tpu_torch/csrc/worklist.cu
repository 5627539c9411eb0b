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
// What bounds them on the H100: memory traffic (a few MB, L2-resident) and,
// at the sizes the renderer gives them, launch latency and the instructions
// per element. So each is ONE cooperative launch of at most one wave of
// co-resident blocks (the wrapper sizes the grid from the occupancy query,
// `worklist_blocks_per_sm`, and splits the input's 16-byte vector steps
// evenly over the blocks in order):
//   1. each thread reads its share of the input once, 16 bytes at a time (16
//      flags or 4 words per vector), keeps the first kRegVec vectors in
//      registers (K5b with its warp's column counts) and counts: the block's
//      count (K5a, `__popc` of the flags' bits) or its 32 column counts (K5b:
//      each lane packs its 4 words' per-column counts into bytes, 32 columns
//      in 8 words, and the warp sums them 8 words at a time) go to a counts
//      table;
//   2. one grid barrier (`this_grid().sync()`);
//   3. every block reduces the counts table itself: the counts of the blocks
//      before it and the total (K5b: per column, and the column bases, which
//      need every column's total over all blocks, hence the grid barrier
//      rather than a single-pass look-back);
//   4. the block walks its vectors in order: a scan of the warps' counts
//      (one barrier a vector for K5a, two or three for K5b; shared buffers
//      alternate), then the writes. K5a rebuilds each warp's 512 flags as 16
//      rows of 32 (two lanes' 16 bits each) and writes row by row, so that
//      consecutive lanes write consecutive positions (a lane's rank is
//      `__popc(row & lanes_below)`). K5b's bits are sparse (2 % of the
//      city's cull bits are set) and cluster in the few words of a ray
//      block's live entries, so a warp ranks its set bits 32 a round in row
//      order, bit i on lane i % 32 whichever lane holds it (a binary search
//      over the lanes' first bits), a bit of column c after the column's
//      bits in earlier rows (`__match_any_sync` finds the lanes of one
//      column in a round); the ranked bits go to a shared buffer that holds
//      the block's vector column by column, and the block copies it out in
//      order, consecutive threads to consecutive positions (a vector with
//      more bits than the buffer holds is written in place). The
//      block pads its share of [total, capacity) with -1, and block 0
//      writes the count.
// No atomics, so the order and the result are deterministic. The wrapper
// allocates one int32 buffer per call: the outputs, the count and the counts
// table (see `compact_launch` / `pair_launch`).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;  // threads per block
constexpr int kWarps = kThreads / 32;
static_assert(kWarps == 32, "the warp-level scans assume 32 warps per block");
constexpr unsigned kFull = 0xffffffffu;
constexpr int kCols = 32;        // bits per K5b word
constexpr int kFlagsPerVec = 16; // K5a: flags per 16-byte vector
constexpr int kWordsPerVec = 4;  // K5b: words per 16-byte vector
constexpr int kRegVec = 4;       // vectors a thread keeps in registers across the grid barrier (K5a)
constexpr int kRegVecPair = 2;   // the same for K5b, whose vectors take 5 registers each
constexpr int kStage = 8192;     // K5b: rows of one block's vector step staged in shared memory
constexpr int kPairSmem = kStage * 4;  // K5b's dynamic shared memory: the staging buffer

__device__ __forceinline__ unsigned lanes_below() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Inclusive prefix sum over the 32 lanes of a warp.
__device__ __forceinline__ int warp_inclusive_scan(int x) {
  const int lane = threadIdx.x & 31;
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  return x;
}

// Bit k = (flag k of the 16 at flags[i..i+16) != 0); flags past n read as 0.
// Whole vectors are one 16-byte load (the wrapper checks the alignment).
__device__ __forceinline__ unsigned load_flags(const uint8_t* __restrict__ flags, long long n, long long i) {
  if (i + kFlagsPerVec <= n) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(flags + i));
    const uint32_t w[4] = {v.x, v.y, v.z, v.w};
    unsigned m = 0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      // high bit of every nonzero byte, then bits 7, 15, 23, 31 down to 0-3
      const uint32_t hi = (((w[q] & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w[q]) & 0x80808080u;
      m |= (((hi >> 7) & 1u) | ((hi >> 14) & 2u) | ((hi >> 21) & 4u) | ((hi >> 28) & 8u)) << (4 * q);
    }
    return m;
  }
  unsigned m = 0;
  for (int k = 0; k < kFlagsPerVec && i + k < n; ++k) m |= (unsigned)(flags[i + k] != 0) << k;
  return m;
}

// The 4 words bits[i..i+4); words past r read as 0.
__device__ __forceinline__ uint4 load_words(const uint32_t* __restrict__ bits, long long r, long long i) {
  if (i + kWordsPerVec <= r) return __ldg(reinterpret_cast<const uint4*>(bits + i));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
  for (int j = 0; j < kWordsPerVec && i + j < r; ++j) w[j] = bits[i + j];
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Sum of v over the block; every thread gets it. s holds kWarps ints and is
// free again after the caller's next barrier.
__device__ __forceinline__ int block_sum(int v, int* __restrict__ s) {
  v = __reduce_add_sync(kFull, v);
  if ((threadIdx.x & 31) == 0) s[threadIdx.x >> 5] = v;
  __syncthreads();
  return __reduce_add_sync(kFull, s[threadIdx.x & 31]);
}

// The vector steps [s0, s1) block b owns of `steps` (span items each):
// contiguous, in block order, as even as whole steps allow, so that every
// block of the wave works.
__device__ __forceinline__ void block_steps(long long steps, long long* s0, int* nv) {
  const long long b = blockIdx.x, g = gridDim.x;
  *s0 = b * steps / g;
  *nv = (int)((b + 1) * steps / g - *s0);
}

// ---------------------------------------------------------------------------
// K5a. Vector step s of the grid holds flags [s * span, (s + 1) * span),
// span = kThreads * 16; in it thread t holds flags s * span + 16 t + 0..15,
// so warp w holds a chunk of 512 consecutive flags. counts: gridDim.x ints.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
compact_kernel(const uint8_t* __restrict__ flags, long long n, long long steps, int capacity,
               int* __restrict__ idx_out, int* __restrict__ cnt_out, int* __restrict__ counts) {
  __shared__ int s_sum[2][kWarps];
  __shared__ int s_warp[2][kWarps];  // per vector: each warp's count, alternating buffers
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long span = (long long)kThreads * kFlagsPerVec;
  long long s0;
  int nv;
  block_steps(steps, &s0, &nv);
  const long long base = s0 * span + (long long)threadIdx.x * kFlagsPerVec;

  unsigned held[kRegVec];
  int mine = 0;
#pragma unroll
  for (int v = 0; v < kRegVec; ++v) {
    held[v] = v < nv ? load_flags(flags, n, base + v * span) : 0u;
    mine += __popc(held[v]);
  }
  for (int v = kRegVec; v < nv; ++v) mine += __popc(load_flags(flags, n, base + v * span));
  const int block_count = block_sum(mine, s_sum[0]);
  if (threadIdx.x == 0) counts[blockIdx.x] = block_count;

  cg::this_grid().sync();

  // the counts of the blocks before this one, and the total
  int before = 0, total = 0;
  for (int j = threadIdx.x; j < (int)gridDim.x; j += kThreads) {
    const int c = __ldcg(counts + j);  // written by other blocks: past L1
    total += c;
    before += j < (int)blockIdx.x ? c : 0;
  }
  before = block_sum(before, s_sum[0]);
  total = block_sum(total, s_sum[1]);

  long long carry = before;
  const auto step = [&](unsigned m, int v) {
    int* const sw = s_warp[v & 1];
    const int wcount = __reduce_add_sync(kFull, __popc(m));
    if (lane == 0) sw[warp] = wcount;
    __syncthreads();
    // every warp scans the warp counts itself: no second barrier
    const int wc = sw[lane];
    const int wincl = warp_inclusive_scan(wc);
    const long long warp_pos = carry + __shfl_sync(kFull, wincl - wc, warp);
    carry += __shfl_sync(kFull, wincl, 31);
    // Row k of the warp's chunk is flags 32 k + 0..31: lane 2k's 16 bits,
    // then lane 2k+1's. Lane k (and k + 16) builds row k and its offset;
    // then row by row, lane L writes flag 32 k + L, so consecutive lanes
    // write consecutive positions.
    const int k2 = 2 * (lane & 15);
    const unsigned row = __shfl_sync(kFull, m, k2) | (__shfl_sync(kFull, m, k2 + 1) << 16);
    const int row_cnt = __popc(row);
    const int row_before = warp_inclusive_scan(lane < 16 ? row_cnt : 0) - row_cnt;
    const long long chunk = s0 * span + v * span + (long long)warp * 32 * kFlagsPerVec;
#pragma unroll 4
    for (int k = 0; k < kFlagsPerVec; ++k) {
      const unsigned rk = __shfl_sync(kFull, row, k);
      const int rb = __shfl_sync(kFull, row_before, k);
      if ((rk >> lane) & 1u) {
        const long long pos = warp_pos + rb + __popc(rk & lanes_below());
        if (pos < capacity) idx_out[pos] = (int)(chunk + 32 * k + lane);
      }
    }
  };
#pragma unroll
  for (int v = 0; v < kRegVec; ++v)
    if (v < nv) step(held[v], v);
  for (int v = kRegVec; v < nv; ++v) step(load_flags(flags, n, base + v * span), v);

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)total + (long long)blockIdx.x * kThreads + threadIdx.x; p < capacity; p += stride)
    idx_out[p] = -1;
  if (blockIdx.x == 0 && threadIdx.x == 0) *cnt_out = total;
}

// ---------------------------------------------------------------------------
// K5b. Vector step s of the grid holds rows [s * span, (s + 1) * span),
// span = kThreads * 4; in it thread t holds rows s * span + 4 t + 0..3. Work
// goes by packed column counts and by set bits, not by column. Warp c scans
// column c over the warps. counts: kCols * gridDim.x ints, column-major
// (counts[c * gridDim.x + b]).
// ---------------------------------------------------------------------------

// A lane's 4 words as 32 per-column counts (0-4), one byte each: byte c & 3
// of p[c >> 2] counts the words with bit c set. Sums over a warp's 32 lanes
// stay below 256, so warp sums and scans run on the packed words.
__device__ __forceinline__ void column_bytes(const uint4& w, unsigned (&p)[8]) {
  const uint32_t word[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int g = 0; g < 8; ++g) {
    unsigned acc = 0u;
#pragma unroll
    for (int j = 0; j < 4; ++j)  // nibble b3..b0 -> bytes 3..0 (the shifted copies do not overlap)
      acc += (((word[j] >> (4 * g)) & 0xfu) * 0x00204081u) & 0x01010101u;
    p[g] = acc;
  }
}

// Byte c of the 32 packed bytes in v.
__device__ __forceinline__ int byte_at(const unsigned (&v)[8], int c) {
  unsigned x = v[0];
#pragma unroll
  for (int g = 1; g < 8; ++g) x = (c >> 2) == g ? v[g] : x;
  return (int)((x >> (8 * (c & 3))) & 0xffu);
}

// Lane c of the warp gets the warp's count of column c in w.
__device__ __forceinline__ int column_counts(const uint4& w) {
  unsigned p[8];
  column_bytes(w, p);
#pragma unroll
  for (int g = 0; g < 8; ++g) p[g] = __reduce_add_sync(kFull, p[g]);
  return byte_at(p, threadIdx.x & 31);
}

__global__ void __launch_bounds__(kThreads, 1)
pair_kernel(const uint32_t* __restrict__ bits, long long r, long long steps, int capacity,
            int* __restrict__ row_out, int* __restrict__ col_out, int* __restrict__ cnt_out,
            int* __restrict__ counts) {
  __shared__ int s_cnt[2][kCols][kWarps + 1];  // per vector: [column][warp] counts, then positions
  __shared__ int s_tot[kCols];
  __shared__ int s_col_cnt[kCols];        // per vector: the block's count of each column
  __shared__ long long s_col_out[kCols];  //   and the output position of its first bit
  __shared__ int s_col_stage[kWarps][kCols];  // each warp's copy of the columns' staged offsets
  __shared__ int s_run[kWarps][kCols];        // per warp: its bits of each column ranked so far
  extern __shared__ int s_dyn[];
  int* const s_stage = s_dyn;  // [kStage]: the vector's rows, column by column
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long span = (long long)kThreads * kWordsPerVec;
  long long s0;
  int nv;
  block_steps(steps, &s0, &nv);
  const long long base = s0 * span + (long long)threadIdx.x * kWordsPerVec;

  // the words of the first kRegVecPair vectors, and lane c's count of column c
  // in each, kept across the grid barrier
  uint4 held[kRegVecPair];
  int held_cnt[kRegVecPair];
  int mine = 0;
#pragma unroll
  for (int v = 0; v < kRegVecPair; ++v) {
    held[v] = v < nv ? load_words(bits, r, base + v * span) : make_uint4(0u, 0u, 0u, 0u);
    held_cnt[v] = column_counts(held[v]);
    mine += held_cnt[v];
  }
  for (int v = kRegVecPair; v < nv; ++v) mine += column_counts(load_words(bits, r, base + v * span));
  s_cnt[0][lane][warp] = mine;
  __syncthreads();
  const int nb = gridDim.x;
  const int col_block = __reduce_add_sync(kFull, s_cnt[0][warp][lane]);  // warp c: column c
  if (lane == 0) counts[(long long)warp * nb + blockIdx.x] = col_block;

  cg::this_grid().sync();

  // warp c: column c's count in the blocks before this one, and its total
  int before = 0, col_total = 0;
  for (int j = lane; j < nb; j += 32) {
    const int c = __ldcg(counts + (long long)warp * nb + j);  // written by other blocks: past L1
    col_total += c;
    before += j < (int)blockIdx.x ? c : 0;
  }
  before = __reduce_add_sync(kFull, before);
  col_total = __reduce_add_sync(kFull, col_total);
  if (lane == 0) s_tot[warp] = col_total;
  __syncthreads();
  // the column's base: the totals of the columns before it
  const int t = s_tot[lane];
  long long carry = (long long)__reduce_add_sync(kFull, lane < warp ? t : 0) + before;
  const int total = __reduce_add_sync(kFull, t);

  const auto step = [&](const uint4& w, int col_cnt, int v) {
    int(*const sc)[kWarps + 1] = s_cnt[v & 1];
    sc[lane][warp] = col_cnt;
    s_run[warp][lane] = 0;
    // the warp's set bits in row order (this lane's rows are 4 lane + 0..3
    // of the warp's 128): where this lane's begin
    const int own = __popc(w.x) + __popc(w.y) + __popc(w.z) + __popc(w.w);
    const int own_incl = warp_inclusive_scan(own);
    const int own_first = own_incl - own;
    const int warp_bits = __shfl_sync(kFull, own_incl, 31);
    __syncthreads();
    // warp c turns column c's warp counts into offsets within the column's
    // bits of this vector, and places the column in the output
    const int x = sc[warp][lane];
    const int incl = warp_inclusive_scan(x);
    sc[warp][lane] = incl - x;
    const int col_n = __shfl_sync(kFull, incl, 31);
    if (lane == 0) {
      s_col_cnt[warp] = col_n;
      s_col_out[warp] = carry;
    }
    carry += col_n;
    __syncthreads();
    // the columns laid end to end in the staging buffer; every warp scans
    // the 32 counts itself into its own copy
    const int cn = s_col_cnt[lane];
    const int cincl = warp_inclusive_scan(cn);
    const int staged = __shfl_sync(kFull, cincl, 31);  // the vector's set bits
    s_col_stage[warp][lane] = cincl - cn;
    __syncwarp();
    const bool stage = staged <= kStage;  // the same in every thread of the block
    // bit (row, c) goes after column c's bits in earlier warps and, within
    // the warp, in earlier rows
    const auto put = [&](long long row, int c, int in_col) {
      if (stage) {
        s_stage[s_col_stage[warp][c] + in_col] = (int)row;
      } else {  // more bits than the buffer holds: write them where they go
        const long long pos = s_col_out[c] + in_col;
        if (pos < capacity) {
          row_out[pos] = (int)row;
          col_out[pos] = c;
        }
      }
    };
    const long long row0 = s0 * span + v * span + (long long)warp * 32 * kWordsPerVec;
    // 32 bits a round, bit i of the warp's row order on lane i % 32, so a
    // lane that holds many bits does not hold up its warp
    for (int i0 = 0; i0 < warp_bits; i0 += 32) {
      const int i = i0 + lane;
      int src = 0;  // the lane holding bit i: the last whose bits start at or before it
#pragma unroll
      for (int half = 16; half > 0; half >>= 1)
        if (__shfl_sync(kFull, own_first, src + half) <= i) src += half;
      int k = i - __shfl_sync(kFull, own_first, src);  // bit k of that lane's, in row order
      const uint32_t sw[4] = {__shfl_sync(kFull, w.x, src), __shfl_sync(kFull, w.y, src),
                              __shfl_sync(kFull, w.z, src), __shfl_sync(kFull, w.w, src)};
      int j = 0;
#pragma unroll
      for (int q = 0; q < kWordsPerVec - 1; ++q) {
        const int n = __popc(sw[q]);
        if (j == q && k >= n) {
          k -= n;
          j = q + 1;
        }
      }
      const uint32_t wj = j == 0 ? sw[0] : j == 1 ? sw[1] : j == 2 ? sw[2] : sw[3];
      const bool valid = i < warp_bits;
      const int c = valid ? (int)__fns(wj, 0, k + 1) : 0;
      // the lanes holding bits of the same column in this round
      const unsigned peers = __match_any_sync(kFull, valid ? c : kCols + lane);
      const unsigned earlier = peers & lanes_below();
      if (valid) put(row0 + 4 * src + j, c, sc[c][warp] + s_run[warp][c] + __popc(earlier));
      __syncwarp();
      if (valid && earlier == 0) s_run[warp][c] += __popc(peers);
      __syncwarp();
    }
    if (!stage) return;
    __syncthreads();
    // the staged bits out in order: consecutive threads, consecutive positions
    const int* const first = s_col_stage[0];
    for (int i = threadIdx.x; i < staged; i += kThreads) {
      int c = 0;  // the last column whose bits start at or before i: i's column
#pragma unroll
      for (int half = kCols / 2; half > 0; half >>= 1)
        if (first[c + half] <= i) c += half;
      const long long pos = s_col_out[c] + (i - first[c]);
      if (pos < capacity) {
        row_out[pos] = s_stage[i];
        col_out[pos] = c;
      }
    }
  };
#pragma unroll
  for (int v = 0; v < kRegVecPair; ++v)
    if (v < nv) step(held[v], held_cnt[v], v);
  for (int v = kRegVecPair; v < nv; ++v) {
    const uint4 w = load_words(bits, r, base + v * span);
    step(w, column_counts(w), v);
  }

  const long long stride = (long long)gridDim.x * kThreads;
  for (long long p = (long long)total + (long long)blockIdx.x * kThreads + threadIdx.x; p < capacity; p += stride) {
    row_out[p] = -1;
    col_out[p] = -1;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *cnt_out = total;
}

// An empty kernel, the launch floor the worklist kernels are timed beside:
// with `cooperative`, launched as they are and passing one grid barrier.
__global__ void __launch_bounds__(kThreads, 1) floor_kernel(int cooperative) {
  if (cooperative) cg::this_grid().sync();
}

int launch_cooperative(const void* kernel, int grid, void** args, size_t smem, void* stream) {
  const int rc = (int)cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args, smem,
                                                  (cudaStream_t)stream);
  return rc ? rc : (int)cudaGetLastError();
}

// K5b takes more than the 48 KiB of shared memory a kernel gets unasked: the
// occupancy query opts in, once per device, before any launch there.
int pair_smem_opt_in() {
  return (int)cudaFuncSetAttribute(pair_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kPairSmem);
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Pointers are device pointers checked
// by the Python wrappers (contiguous, inputs on a 16-byte boundary), which
// also size the grid (at most `worklist_blocks_per_sm` x SMs blocks of
// `worklist_threads()` threads, at most `steps`): `steps` is the input's
// vector steps (kThreads x 16 flags or 4 words each, the last one ragged),
// block b takes steps [b steps / grid, (b + 1) steps / grid). `out` is the call's one int32
// buffer: K5a [idx (capacity) | count | counts (grid)], K5b [row (capacity) |
// col (capacity) | count | counts (32 x grid)]. `stream` is the caller's
// cudaStream_t. Each returns the launch's cudaError_t: a cooperative launch
// the device refuses is an error, never a fallback.
// ---------------------------------------------------------------------------
extern "C" int worklist_threads() { return kThreads; }

// Co-resident blocks per SM of kernel 0 (compact) or 1 (pair); a negative
// cudaError_t if the query fails. The wrappers ask it once per device before
// their first launch there, which gives K5b its shared memory (`pair_launch`
// does not ask again).
extern "C" int worklist_blocks_per_sm(int device, int which) {
  cudaSetDevice(device);
  int blocks = 0, rc = 0;
  if (which == 0) {
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, compact_kernel, kThreads, 0);
  } else if (!(rc = pair_smem_opt_in())) {
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pair_kernel, kThreads, kPairSmem);
  }
  return rc ? -rc : blocks;
}

extern "C" int compact_launch(int device, const void* flags, long long n, int grid, long long steps,
                              int capacity, void* out, void* stream) {
  cudaSetDevice(device);
  int* idx = (int*)out;
  int* cnt = idx + capacity;
  int* counts = cnt + 1;
  void* args[] = {(void*)&flags, &n, &steps, &capacity, &idx, &cnt, &counts};
  return launch_cooperative((const void*)compact_kernel, grid, args, 0, stream);
}

extern "C" int pair_launch(int device, const void* bits, long long r, int grid, long long steps,
                           int capacity, void* out, void* stream) {
  cudaSetDevice(device);
  int* row = (int*)out;
  int* col = row + capacity;
  int* cnt = col + capacity;
  int* counts = cnt + 1;
  void* args[] = {(void*)&bits, &r, &steps, &capacity, &row, &col, &cnt, &counts};
  return launch_cooperative((const void*)pair_kernel, grid, args, kPairSmem, stream);
}

extern "C" int floor_launch(int device, int grid, int cooperative, void* stream) {
  cudaSetDevice(device);
  if (cooperative) {
    void* args[] = {&cooperative};
    return launch_cooperative((const void*)floor_kernel, grid, args, 0, stream);
  }
  floor_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(0);
  return (int)cudaGetLastError();
}
