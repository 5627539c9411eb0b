// Cluster traversal kernels for Hopper (sm_90a): the block cull (K1), the
// closest-hit sweep (K2), the any-hit sweep (K3) and the hierarchical node
// sweeps (K4a closest, K4b any-hit).
//
// They replace the Pallas TPU kernels of optixpathtracer_tpu/ops/
// traverse_cluster.py: `_cull_kernel`/`_cull_math` (K1), `_closest_kernel`
// with `_xform_ray`/`_mt_block`/`_mt_epilogue_lean` (K2), `_any_kernel`
// (K3), and `_closest_kernel_hier`/`_any_kernel_hier` on `_hier_kernel_body`
// (K4a/K4b). The plain PyTorch versions beside the Python wrappers
// (`_cull_torch`, `_closest_torch`, `_any_torch`, `_closest_hier_torch`,
// `_any_hier_torch` in optixpathtracer_tpu_torch/ops/traverse_cluster.py)
// compute the same values op for op.
//
// Exactness. Built with --fmad=false and without fast math: every product,
// sum, `1.0f / x` and `sqrtf` rounds once, as in the PyTorch versions, so
// the outputs are bit-equal to them. Constants are the JAX package's Python
// doubles rounded to f32 (e.g. 0.9999996f == float32(1.0 - 4e-7)).
// min/max propagate NaN like torch.minimum/maximum.
//
// What bounds them on the H100. The sweeps are bound by the FP32 issue rate
// of Moller-Trumbore (45 un-fused FP32 mul/add/sub before the edge tests,
// one IEEE divide for the ~0.4 % of pairs that pass them); the city's
// triangle rows (74 supers x 16 x 2048 f32, 9.7 MB) sit in the 50 MB L2, so
// device-memory bandwidth is not the limit. The design answers that by
// evaluating only what a ray needs: a ray walks its block's near-to-far
// entries, evaluates only the member clusters its own 16-ray sub-block was
// culled into, skips a member once its own best hit is nearer than the
// entry's distance bound, and divides only for pairs that pass the sign
// tests. A ray loops over a cluster's triangles in column order with a
// strict `<`, which reproduces both tie-breaks of the reference: the lowest
// column wins within a cluster, the first cluster visited wins across them.
//
// K2/K3 stage each member a block visits (9 x C f32, 9 KiB at C = 256) into
// shared memory with 16-byte cp.async copies and read it four columns at a
// time: each of the 9 rows as one broadcast float4 (9 LDS.128 per 4
// triangles instead of 36 LDS.32), the columns still tested one by one in
// order against the updated best (so C % 4 == 0). A block-wide OR vote per
// entry (one barrier) finds the next member to stage and carries the early
// exit: no running ray of the block passes the entry's key gate, and keys
// ascend. With 8-10 blocks resident per SM, the other blocks' M-T hides one
// block's copy. Beyond that the two kernels differ, each where the card
// measured it faster (PERF.md):
//  K2: two rays per thread (64 threads per 128-ray block), each staged read
//      serving both, each ray in its own visit order; one staging slot; a
//      member is staged when a sub-block's cull bit names it.
//  K3: one ray per thread, since shadow rays stop at different first hits.
//      A member is staged only when some ray whose sub-block's bit names it
//      is not yet occluded and passes its key gate (each thread votes its
//      sub-block's bits; a ray only ever leaves the vote, so a vote taken
//      early can only add a member). The rays that run a member are packed
//      onto the first threads (a ballot per warp, one barrier; rays and
//      occlusion flags in shared memory), so no lane idles for a ray that
//      is occluded or fails its gate while its warp's others run. A
//      two-slot ring copies the next member while the block evaluates the
//      current one.
// K4a/K4b, the node walk, stage and read a member the same way (cp.async,
// float4 rows) but pack every member's running rays onto the block's
// threads and share the member's columns among the threads a ray gets; see
// their header below.
// K1, the cull, tests rays against boxes in two levels: every 16-ray
// sub-block first against each group's own box, then against the eight
// members of the groups it may reach; see its header below.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 128;       // rays per block: the lo/hi layout is 8 sub-blocks of 16
constexpr int kSuper = 8;         // clusters per supercluster (entry)
constexpr int kStoreRows = 16;    // storage rows of the (S, 16, SUPER*C) triangle table
constexpr int kSub = kBlock / 8;  // rays per sub-block
constexpr int kCullThreads = 256; // 8 warps: warp w owns sub-block w
constexpr int kCullChunk = 1024;  // groups per pass over the tables (the shared lists' length)
constexpr float kBig = 3.0e37f;
constexpr int kThreadsK2 = kBlock / 2;  // two rays per thread
constexpr int kThreadsK3 = kBlock;
constexpr int kSlotsK2 = 1;  // staging slots of 9 x C f32
constexpr int kSlotsK3 = 2;

// NaN-propagating max / min (torch.maximum / torch.minimum), one FMNMX.NAN
// each. Which NaN comes out reaches no output but a key that is NaN anyway.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// ---------------------------------------------------------------------------
// K1: per 128-ray block, slab test of every live ray's [0, t_max] against
// every member box; per group of 8 members the near-to-far key and the
// per-(sub-block, member) hit bits. sph_t is the (8, M) member-major table:
// member k of group g at column k*S + g, rows [cx cy cz r hx hy hz .]; grp_t
// the (8, S) table of the groups' own boxes in the same rows, each holding
// its eight member boxes (`group_boxes`).
//
// Bound by the FP32 instruction rate: a slab test is 24 operations on 6 box
// and 7 ray values, and the tables sit in L1/L2. The design spends
// instructions on little else and skips most tests:
//  - a thread keeps one box in registers and reads each ray of its warp's
//    sub-block as two broadcast float4s (o.xyz t_max | 1/d.xyz) from shared
//    memory, 2 LDS.128 for the 8 LDS.32 of a scalar layout (more boxes per
//    thread cut no instruction further and cost occupancy: PERF.md);
//  - the live rays of a sub-block are packed at load, so the ray loop has
//    the same trip count on every lane and dead rays cost nothing; a block
//    without a live ray writes its sentinels and returns;
//  - warp w owns sub-block w through both levels, so the levels need no
//    block barrier between them. Level 1, lanes over groups: the sub-block's
//    rays against each group's box with `slab_may_hit`, which passes
//    whenever a member test could (see there); the groups that pass are
//    compacted into the warp's list by ballot. Level 2, 8 neighbouring lanes
//    over the members of a listed group: the exact `slab_hits`; a ballot
//    gives the group's 8 member bits of this sub-block in one byte;
//  - after one barrier a thread per group assembles lo / hi from the eight
//    sub-blocks' bytes, computes the key from the members that have a bit,
//    and writes rows of key / lo / hi coalesced.
// A coherent block reaches few groups, so level 2 runs for a small share of
// them (PERF.md has the counts).
// ---------------------------------------------------------------------------

// The exact member test of `_cull_math`: does the ray's [0, t_max] meet the
// box (q, h)? A = (o.xyz, t_max), B = (1/d.xyz, .).
__device__ __forceinline__ bool slab_hits(const float q[3], const float h[3], const float4& A,
                                          const float4& B) {
  const float o[3] = {A.x, A.y, A.z}, iv[3] = {B.x, B.y, B.z};
  float t0[3], t1[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float mid = (q[a] - o[a]) * iv[a];
    const float rad = h[a] * fabsf(iv[a]);
    t0[a] = mid - rad;
    t1[a] = mid + rad;
  }
  const float tn = max_nan(max_nan(t0[0], t0[1]), max_nan(t0[2], 0.0f));
  const float tf = min_nan(min_nan(t1[0], t1[1]), min_nan(t1[2], A.w));
  return tn <= tf + fabsf(tf) * 4e-7f + 1e-30f;
}

// The group pre-test: false only if no box inside (q, h) can pass
// `slab_hits` for this ray. Why it is conservative. Let a member box lie
// inside the group box in real arithmetic (`group_boxes` guarantees it).
// Per axis the member's exact interval [t0m, t1m] then lies inside the
// group's [t0, t1], and |mid_m| <= |mid| + rad, rad_m <= rad. Each computed
// t0 / t1 is off its exact value by at most 3 ulp-halves of |mid| + rad
// (three roundings: the difference, the product, the sum), so with
// mag = sum over the axes of |mid| + rad of the GROUP box, and u = 2^-24:
//   tn <= tn_m + 9u*mag,  tf >= tf_m - 9u*mag.
// A member hit has tn_m <= tf_m + |tf_m| * (4e-7 + 2u) + 1e-30 with
// 0 <= tf_m <= 2*mag (or |tf_m| <= 1e-30), hence
//   tn <= tf + (18u + 2 * 5.2e-7) * mag + 1e-30 < tf + 2.2e-6 * mag + 1e-30.
// The test allows 1e-5 * mag + 1e-29, over four times that, which also
// covers the roundings of mag and of the right-hand side themselves (and
// what a denormal result loses, some 1e-45 each). It is
// written as !(tn > ...) so that a NaN or an overflow to infinity anywhere in
// it passes the group; mag is infinite or NaN whenever a group value is.
__device__ __forceinline__ bool slab_may_hit(const float q[3], const float h[3], const float4& A,
                                             const float4& B) {
  const float o[3] = {A.x, A.y, A.z}, iv[3] = {B.x, B.y, B.z};
  float t0[3], t1[3], mg[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float mid = (q[a] - o[a]) * iv[a];
    const float rad = h[a] * fabsf(iv[a]);
    t0[a] = mid - rad;
    t1[a] = mid + rad;
    mg[a] = fabsf(mid) + rad;
  }
  const float tn = max_nan(max_nan(t0[0], t0[1]), max_nan(t0[2], 0.0f));
  const float tf = min_nan(min_nan(t1[0], t1[1]), min_nan(t1[2], A.w));
  const float mag = (mg[0] + mg[1]) + mg[2];
  return !(tn > tf + (mag * 1e-5f + 1e-29f));
}

// Level 1 for one row of 32 groups, lane over groups: returns the list's new
// length. Every group of the row gets its byte of `bits` zeroed; level 2
// overwrites those of the groups listed.
__device__ __forceinline__ int pretest_row(const float* __restrict__ grp_t, int s, int g0, int ng,
                                           int row, const float4 (*__restrict__ rays)[2], int n,
                                           unsigned short* __restrict__ list, int len,
                                           unsigned char* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int g = row * 32 + lane;
  const int col = g0 + (g < ng ? g : 0);
  float q[3], h[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q[a] = __ldg(grp_t + a * s + col);
    h[a] = __ldg(grp_t + (4 + a) * s + col);
  }
  bool may = false;
  for (int r = 0; r < n; ++r) may |= slab_may_hit(q, h, rays[r][0], rays[r][1]);
  const bool pass = may && g < ng;
  const unsigned bal = __ballot_sync(0xffffffffu, pass);
  if (pass) list[len + __popc(bal & ((1u << lane) - 1u))] = (unsigned short)g;
  if (g < ng) bits[g] = 0;
  return len + __popc(bal);
}

// Level 2 for one row of 4 listed groups, 8 neighbouring lanes over a group's
// members: writes each group's byte of member bits.
__device__ __forceinline__ void member_row(const float* __restrict__ sph_t, int m, int s, int g0,
                                           int i0, int len, const float4 (*__restrict__ rays)[2],
                                           int n, const unsigned short* __restrict__ list,
                                           unsigned char* __restrict__ bits) {
  const int lane = threadIdx.x & 31;
  const int k = lane & (kSuper - 1);
  const int i = i0 + (lane >> 3);
  const int g = i < len ? list[i] : -1;
  const int col = k * s + g0 + (g < 0 ? 0 : g);
  float q[3], h[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    q[a] = __ldg(sph_t + a * m + col);
    h[a] = __ldg(sph_t + (4 + a) * m + col);
  }
  bool hit = false;
  for (int r = 0; r < n; ++r) hit |= slab_hits(q, h, rays[r][0], rays[r][1]);
  const unsigned bal = __ballot_sync(0xffffffffu, hit && g >= 0);
  if (k == 0 && g >= 0) bits[g] = (unsigned char)(bal >> (lane & 24));
}

__global__ void __launch_bounds__(kCullThreads)
cull_kernel(const float* __restrict__ rays8, const float* __restrict__ sph_t,
            const float* __restrict__ grp_t, int m, int s, float* __restrict__ key_out,
            uint32_t* __restrict__ lo_out, uint32_t* __restrict__ hi_out,
            int* __restrict__ count_out) {
  __shared__ float4 s_ray[kBlock][2];  // a sub-block's live rays packed to its front
  __shared__ int s_live[kBlock / kSub];
  __shared__ float s_box[6][kCullThreads / 32];
  __shared__ float s_ob[3], s_hb[3];   // the live origins' box: centre, half extent
  __shared__ unsigned short s_list[kBlock / kSub][kCullChunk];
  __shared__ unsigned char s_bits[kBlock / kSub][kCullChunk];
  __shared__ int s_count[kCullThreads / 32];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  float blo[3] = {kBig, kBig, kBig};
  float bhi[3] = {-kBig, -kBig, -kBig};
  int alive = 0;
  if (tid < kBlock) {  // whole warps: the ballot below is among them
    const float4* r4 = reinterpret_cast<const float4*>(rays8) + ((size_t)b * kBlock + tid) * 2;
    const float4 r0 = r4[0], r1 = r4[1];  // o.xyz d.x | d.yz t_min t_max
    alive = r1.w > r1.z;
    const float o[3] = {r0.x, r0.y, r0.z}, d[3] = {r0.w, r1.x, r1.y};
    float iv[3];
    for (int a = 0; a < 3; ++a) {
      iv[a] = 1.0f / (fabsf(d[a]) > 1e-30f ? d[a] : 1e-30f);
      blo[a] = alive ? o[a] : kBig;
      bhi[a] = alive ? o[a] : -kBig;
    }
    const unsigned half = (__ballot_sync(0xffffffffu, alive) >> (lane & kSub)) & 0xffffu;
    if (alive) {
      float4* dst = s_ray[(tid & ~(kSub - 1)) + __popc(half & ((1u << (lane & (kSub - 1))) - 1u))];
      dst[0] = make_float4(o[0], o[1], o[2], r1.w);
      dst[1] = make_float4(iv[0], iv[1], iv[2], 0.0f);
    }
    if ((lane & (kSub - 1)) == 0) s_live[tid / kSub] = __popc(half);
  }
  for (int a = 0; a < 3; ++a) {
    for (int off = 16; off > 0; off >>= 1) {
      blo[a] = min_nan(blo[a], __shfl_xor_sync(0xffffffffu, blo[a], off));
      bhi[a] = max_nan(bhi[a], __shfl_xor_sync(0xffffffffu, bhi[a], off));
    }
    if (lane == 0) {
      s_box[a][warp] = blo[a];
      s_box[3 + a][warp] = bhi[a];
    }
  }
  if (!__syncthreads_or(alive)) {  // no live ray: no bit, every key a miss
    for (int g = tid; g < s; g += kCullThreads) {
      const size_t o = (size_t)b * s + g;
      key_out[o] = kBig;
      lo_out[o] = 0;
      hi_out[o] = 0;
    }
    if (tid == 0) count_out[b] = 0;
    return;
  }
  if (tid < 3) {
    float lo = s_box[tid][0], hi = s_box[3 + tid][0];
    for (int w = 1; w < kCullThreads / 32; ++w) {
      lo = min_nan(lo, s_box[tid][w]);
      hi = max_nan(hi, s_box[3 + tid][w]);
    }
    s_ob[tid] = 0.5f * (lo + hi);
    s_hb[tid] = 0.5f * (hi - lo);
  }

  const float4 (*rays)[2] = s_ray + warp * kSub;
  const int n = s_live[warp];
  unsigned short* const list = s_list[warp];
  unsigned char* const bits = s_bits[warp];
  int count = 0;
  for (int g0 = 0; g0 < s; g0 += kCullChunk) {
    const int ng = min(kCullChunk, s - g0);
    // level 1: the groups this sub-block may reach
    int len = 0;
    for (int row = 0; row * 32 < ng; ++row)
      len = pretest_row(grp_t, s, g0, ng, row, rays, n, list, len, bits);
    __syncwarp();
    // level 2: their members
    for (int i0 = 0; i0 < len; i0 += 4) member_row(sph_t, m, s, g0, i0, len, rays, n, list, bits);
    __syncthreads();  // every sub-block's bytes of this chunk (and s_ob / s_hb)
    for (int g = tid; g < ng; g += kCullThreads) {
      uint32_t lo = 0, hi = 0;
#pragma unroll
      for (int s8 = 0; s8 < 4; ++s8) {
        lo |= (uint32_t)s_bits[s8][g] << (8 * s8);
        hi |= (uint32_t)s_bits[4 + s8][g] << (8 * s8);
      }
      uint32_t mem = lo | hi;  // members some sub-block hits
      mem |= mem >> 16;
      mem = (mem | (mem >> 8)) & 0xffu;
      // the min over all 8 members of (hit ? dist : BIG)
      float key = mem == 0xffu ? __int_as_float(0x7f800000) : kBig;
      while (mem) {
        const int col = (__ffs(mem) - 1) * s + g0 + g;
        mem &= mem - 1;
        float sep[3];
        for (int a = 0; a < 3; ++a)
          sep[a] = max_nan(fabsf(sph_t[a * m + col] - s_ob[a]) - (sph_t[(4 + a) * m + col] + s_hb[a]), 0.0f);
        key = min_nan(key, sqrtf(sep[0] * sep[0] + sep[1] * sep[1] + sep[2] * sep[2]) * 0.9999996f);
      }
      const bool any = (lo | hi) != 0;
      const size_t o = (size_t)b * s + g0 + g;
      key_out[o] = any ? key : kBig;
      lo_out[o] = lo;
      hi_out[o] = hi;
      count += any;
    }
    if (g0 + kCullChunk < s) __syncthreads();  // the bytes are read before the next chunk's are written
  }
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(0xffffffffu, count, off);
  if (lane == 0) s_count[warp] = count;
  __syncthreads();
  if (tid == 0) {
    int total = 0;
    for (int w = 0; w < kCullThreads / 32; ++w) total += s_count[w];
    count_out[b] = total;
  }
}

// ---------------------------------------------------------------------------
// Shared walk of K2 / K3: ray setup and the affine world->instance map.
// ---------------------------------------------------------------------------
struct Ray {
  float o[3], d[3], tmin, tmax, dlen;
};

__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays8, size_t ray) {
  const float* r = rays8 + ray * 8;
  Ray R;
  for (int a = 0; a < 3; ++a) {
    R.o[a] = r[a];
    R.d[a] = r[3 + a];
  }
  R.tmin = r[6];
  R.tmax = r[7];
  R.dlen = sqrtf(R.d[0] * R.d[0] + R.d[1] * R.d[1] + R.d[2] * R.d[2]);
  return R;
}

// xf: [A row-major 9 | b 3 | pad]; t is invariant under the map.
__device__ __forceinline__ void xform(const Ray& R, const float* __restrict__ a, float lo[3], float ld[3]) {
  lo[0] = a[0] * R.o[0] + a[1] * R.o[1] + a[2] * R.o[2] + a[9];
  lo[1] = a[3] * R.o[0] + a[4] * R.o[1] + a[5] * R.o[2] + a[10];
  lo[2] = a[6] * R.o[0] + a[7] * R.o[1] + a[8] * R.o[2] + a[11];
  ld[0] = a[0] * R.d[0] + a[1] * R.d[1] + a[2] * R.d[2];
  ld[1] = a[3] * R.d[0] + a[4] * R.d[1] + a[5] * R.d[2];
  ld[2] = a[6] * R.d[0] + a[7] * R.d[1] + a[8] * R.d[2];
}

// Moller-Trumbore for one ray and one triangle [v0 | e1 | e2]. Returns true
// and sets t when the pair passes the edge tests; t is then ts * (1/ad)
// exactly as `_mt_epilogue_lean` computes it.
__device__ __forceinline__ bool mt9(float v0x, float v0y, float v0z, float e1x, float e1y, float e1z,
                                    float e2x, float e2y, float e2z, const float lo[3],
                                    const float ld[3], float& t) {
  const float px = ld[1] * e2z - ld[2] * e2y;
  const float py = ld[2] * e2x - ld[0] * e2z;
  const float pz = ld[0] * e2y - ld[1] * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const float tx = lo[0] - v0x, ty = lo[1] - v0y, tz = lo[2] - v0z;
  const float up = tx * px + ty * py + tz * pz;
  const float qx = ty * e1z - tz * e1y;
  const float qy = tz * e1x - tx * e1z;
  const float qz = tx * e1y - ty * e1x;
  const float vp = ld[0] * qx + ld[1] * qy + ld[2] * qz;
  const float tp = e2x * qx + e2y * qy + e2z * qz;
  const float sg = det >= 0.0f ? 1.0f : -1.0f;
  const float ad = det * sg;
  const float us = up * sg;
  const float vs = vp * sg;
  if (!(ad > 0.0f && us >= 0.0f && vs >= 0.0f && us + vs <= ad)) return false;
  t = (tp * sg) * (1.0f / ad);
  return true;
}

// ---------------------------------------------------------------------------
// The staging of the sweeps (K2 / K3 and K4a / K4b).
// ---------------------------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

// Request member k's 9 x C rows of one super into a staging slot [9][c]:
// 16-byte copies (C % 4 == 0, so every row is 16-byte aligned), committed
// by every thread as one group.
template <int kThreads>
__device__ __forceinline__ void request_member(float* __restrict__ slot, const float* __restrict__ super_rows,
                                               int k, int c) {
  const int c4 = c >> 2;
  int row = 0, col = threadIdx.x;  // col in float4 units
  while (col >= c4) col -= c4, ++row;
  while (row < 9) {
    cp_async16(slot + row * c + 4 * col, super_rows + (size_t)row * kSuper * c + k * c + 4 * col);
    col += kThreads;
    while (col >= c4) col -= c4, ++row;
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait for this thread's copies but the `pending` latest groups (0 or 1).
__device__ __forceinline__ void wait_copies(int pending) {
  if (pending) asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// OR of the block's 3-word votes; every thread gets it. One barrier: calls
// alternate between the two rows of s_or, and a call's write can only
// follow the barrier of the call between it and the last reader of its row.
template <int kThreads>
__device__ __forceinline__ void block_or(unsigned (&v)[3], unsigned (*s_or)[3][kThreads / 32], int& row) {
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = __reduce_or_sync(0xffffffffu, v[q]);
    if ((threadIdx.x & 31) == 0) s_or[row][q][threadIdx.x >> 5] = v[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < 3; ++q) {
    v[q] = 0;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) v[q] |= s_or[row][q][w];
  }
  row ^= 1;
}

// The next member after member k of entry i (k = -1: from the start of the
// entry) that the block stages, as (entry, member, sub-blocks): the first
// one the block's vote names; bit s of `sub-blocks` when the vote names the
// member for sub-block s. vote(key, lo, hi, v) sets this thread's words:
// v[0] / v[1] the (sub-block, member) bits it stages the entry for, in the
// layout of lo / hi, and v[2] when one of its rays still runs and passes
// the key gate. Returns entry n_entries when the walk is over: no ray of
// the block can reach an entry whose key exceeds every running ray's gate,
// nor any later one (keys ascend). Every call votes at least once, so its
// barrier also orders the previous member's reads of a slot before the
// next copy into it.
template <int kThreads, class Vote>
__device__ __forceinline__ int3 next_member(int i, int k, int n_entries, size_t row0,
                                            const float* __restrict__ keys,
                                            const uint32_t* __restrict__ bits_lo,
                                            const uint32_t* __restrict__ bits_hi, Vote vote,
                                            unsigned (*s_or)[3][kThreads / 32], int& vote_row) {
  for (; i < n_entries; ++i, k = -1) {
    unsigned v[3];
    vote(keys[row0 + i], bits_lo[row0 + i], bits_hi[row0 + i], v);
    block_or<kThreads>(v, s_or, vote_row);
    if (!v[2]) break;
    const uint32_t lw = v[0], hw = v[1];
    const uint32_t w = lw | hw;
    const uint32_t members = (w | (w >> 8) | (w >> 16) | (w >> 24)) & (0xffu << (k + 1)) & 0xffu;
    if (members) {
      const int m = __ffs(members) - 1;
      unsigned subs = 0;
#pragma unroll
      for (int sb = 0; sb < 4; ++sb)
        subs |= (((lw >> (sb * 8 + m)) & 1u) << sb) | (((hw >> (sb * 8 + m)) & 1u) << (sb + 4));
      return make_int3(i, m, (int)subs);
    }
  }
  return make_int3(n_entries, 0, 0);
}

__device__ __forceinline__ float lane4(const float4& v, int q) {
  return q == 0 ? v.x : q == 1 ? v.y : q == 2 ? v.z : v.w;
}

// Whether one ray hits a triangle of the staged member in (t_min, t_max),
// columns in order, stopping at the first hit.
__device__ __forceinline__ bool member_occludes(const float* __restrict__ s_tri, int c, int j4_begin, int j4_end,
                                                const Ray& R, const float lo[3], const float ld[3]) {
  const float4* s4 = reinterpret_cast<const float4*>(s_tri);
  for (int j4 = j4_begin; j4 < j4_end; ++j4) {
    float4 v[9];
#pragma unroll
    for (int row = 0; row < 9; ++row) v[row] = s4[row * (c >> 2) + j4];
    bool hit = false;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float t;
      hit |= mt9(lane4(v[0], q), lane4(v[1], q), lane4(v[2], q), lane4(v[3], q), lane4(v[4], q),
                 lane4(v[5], q), lane4(v[6], q), lane4(v[7], q), lane4(v[8], q), lo, ld, t) &&
             t > R.tmin && t < R.tmax;
    }
    if (hit) return true;
  }
  return false;
}

// One staged member against kRays rays of a thread: columns in order, four per
// step (each of the 9 rows as one broadcast float4), each tested against the
// ray's updated best with a strict <.
template <int kRays>
__device__ __forceinline__ void member_closest(const float* __restrict__ s_tri, int c, int j4_begin, int j4_end, int base,
                                               const bool (&go)[kRays], const Ray (&R)[kRays],
                                               const float (&lo)[kRays][3], const float (&ld)[kRays][3],
                                               float (&best)[kRays], int (&btri)[kRays]) {
  const float4* s4 = reinterpret_cast<const float4*>(s_tri);
  const int c4 = c >> 2;
  for (int j4 = j4_begin; j4 < j4_end; ++j4) {
    float4 v[9];
#pragma unroll
    for (int row = 0; row < 9; ++row) v[row] = s4[row * c4 + j4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < kRays; ++r) {
        float t;
        if (go[r] &&
            mt9(lane4(v[0], q), lane4(v[1], q), lane4(v[2], q), lane4(v[3], q), lane4(v[4], q),
                lane4(v[5], q), lane4(v[6], q), lane4(v[7], q), lane4(v[8], q), lo[r], ld[r], t) &&
            t > R[r].tmin && t < best[r]) {
          best[r] = t;
          btri[r] = base + 4 * j4 + q;
        }
      }
    }
  }
}

// The walk shared by K2 and K3: the block visits the members its votes
// name, near to far, through kSlots staging slots, and calls eval(slot, i,
// k, sub-blocks) for each.
template <int kThreads, int kSlots, class Vote, class Eval>
__device__ __forceinline__ void sweep_walk(float* __restrict__ s_tri, int c, int n_entries, size_t row0,
                                           const float* __restrict__ keys,
                                           const uint32_t* __restrict__ bits_lo,
                                           const uint32_t* __restrict__ bits_hi,
                                           const int* __restrict__ rowix, const float* __restrict__ rows,
                                           Vote vote, Eval eval) {
  __shared__ unsigned s_or[2][3][kThreads / 32];
  int vote_row = 0;
  const size_t super_stride = (size_t)kStoreRows * kSuper * c;
  const auto next = [&](int i, int k) {
    return next_member<kThreads>(i, k, n_entries, row0, keys, bits_lo, bits_hi, vote, s_or, vote_row);
  };
  const auto request = [&](float* slot, int3 m) {
    request_member<kThreads>(slot, rows + rowix[row0 + m.x] * super_stride, m.y, c);
  };
  int3 cur = next(0, -1);
  if (cur.x < n_entries) request(s_tri, cur);
  int slot = 0;
  while (cur.x < n_entries) {
    int3 nxt = make_int3(n_entries, 0, 0);
    if (kSlots == 2) {  // the ring: request the next member before evaluating this one
      nxt = next(cur.x, cur.y);
      if (nxt.x < n_entries) request(s_tri + (slot ^ 1) * 9 * c, nxt);
    }
    wait_copies(nxt.x < n_entries);
    __syncthreads();
    eval(s_tri + slot * 9 * c, cur.x, cur.y, (unsigned)cur.z);
    if (kSlots == 1) {
      nxt = next(cur.x, cur.y);
      if (nxt.x < n_entries) request(s_tri, nxt);
    } else {
      slot ^= 1;
    }
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// K2: closest hit. One block of 64 threads per 128-ray block: ray r of
// thread tid is ray tid + 64 r, so ray 0 lies in sub-blocks 0-3 (the lo
// word of the cull bits) and ray 1 in sub-blocks 4-7 (the hi word), both at
// bit (tid / 16) * 8 + member.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreadsK2)
closest_kernel(const float* __restrict__ rays8, const int* __restrict__ ids,
               const float* __restrict__ keys, const uint32_t* __restrict__ bits_lo,
               const uint32_t* __restrict__ bits_hi, const int* __restrict__ rowix,
               const int* __restrict__ xfix, const int* __restrict__ count,
               const float* __restrict__ xf_inv, const float* __restrict__ rows, int e, int c,
               float* __restrict__ t_out, int* __restrict__ tri_out, int* __restrict__ vis_out) {
  extern __shared__ float4 s_slots[];  // [9][c]
  __shared__ int s_vis;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const int bit0 = (threadIdx.x >> 4) * 8;
  Ray R[2];
  float best[2], lo[2][3], ld[2][3];
  int btri[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    R[r] = load_ray(rays8, (size_t)b * kBlock + threadIdx.x + r * kThreadsK2);
    best[r] = R[r].tmax;
    btri[r] = -1;
  }
  int vis = 0;
  int xf_entry = -1;  // the entry lo/ld belong to
  if (threadIdx.x == 0) s_vis = 0;
  __syncthreads();

  const auto gate = [&](int r, float key) { return key <= min_nan(best[r] * R[r].dlen, kBig); };
  const size_t row0 = (size_t)b * e;
  sweep_walk<kThreadsK2, kSlotsK2>(
      reinterpret_cast<float*>(s_slots), c, count[b], row0, keys, bits_lo, bits_hi, rowix, rows,
      // stage the members some sub-block's cull bit names while a ray runs
      [&](float key, uint32_t lw, uint32_t hw, unsigned(&v)[3]) {
        const bool run = gate(0, key) || gate(1, key);
        v[0] = run ? lw : 0u;
        v[1] = run ? hw : 0u;
        v[2] = run;
      },
      [&](const float* __restrict__ s_tri, int i, int k, unsigned) {
        const size_t ei = row0 + i;
        const float key = keys[ei];
        const uint32_t word[2] = {bits_lo[ei], bits_hi[ei]};
        bool go[2], any = false;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          go[r] = ((word[r] >> (bit0 + k)) & 1u) && gate(r, key);
          const unsigned bal = __ballot_sync(0xffffffffu, go[r]);
          if (lane == 0) vis += ((bal & 0xffffu) != 0) + ((bal >> 16) != 0);
          any |= go[r];
        }
        if (!any) return;
        if (i != xf_entry) {
#pragma unroll
          for (int r = 0; r < 2; ++r) xform(R[r], xf_inv + (size_t)xfix[ei] * 16, lo[r], ld[r]);
          xf_entry = i;
        }
        member_closest<2>(s_tri, c, 0, c >> 2, (ids[ei] * kSuper + k) * c, go, R, lo, ld, best, btri);
      });
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t ray = (size_t)b * kBlock + threadIdx.x + r * kThreadsK2;
    t_out[ray] = best[r];
    tri_out[ray] = btri[r];
  }
  if (lane == 0 && vis) atomicAdd(&s_vis, vis);
  __syncthreads();
  if (threadIdx.x == 0) vis_out[b] = s_vis;
}

// Pack the block's rays for which `runs` holds onto its threads; one barrier.
// With kSplit and n such rays each gets a power of two of threads, as many
// as fit the block and divide the member's c4 groups of four columns; thread
// t of part t / g (g = kBlock / parts) takes the (t % g)-th ray and the
// part's share of the columns, so a warp reads one part's columns (broadcast
// reads). Without kSplit (K3) thread t takes the t-th ray and all columns.
// Returns (that ray or -1, first group, end group). `bal` is the warp's
// ballot of `runs`, `rank` the rank of this thread's own ray among the
// running ones (-1 if it does not run; kSplit only), `parts` the split.
// s_run is free again after the block's next barrier.
template <bool kSplit = true>
__device__ __forceinline__ int3 pack_rays(bool runs, int c4, unsigned* __restrict__ s_run, unsigned& bal,
                                          int& rank, int& parts) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  bal = __ballot_sync(0xffffffffu, runs);
  if (lane == 0) s_run[warp] = bal;
  __syncthreads();
  int shift = 0;
  rank = -1;
  if (kSplit) {
    int n = 0, before = 0;
#pragma unroll
    for (int w = 0; w < kBlock / 32; ++w) {
      const int cnt = __popc(s_run[w]);
      before += w < warp ? cnt : 0;
      n += cnt;
    }
    rank = runs ? before + __popc(bal & ((1u << lane) - 1u)) : -1;
    while ((n << (shift + 1)) <= kBlock && (c4 & ((2 << shift) - 1)) == 0) ++shift;
  }
  parts = 1 << shift;
  const int g = kBlock >> shift;
  int r = threadIdx.x & (g - 1), w = 0;
  while (w < kBlock / 32 - 1 && r >= __popc(s_run[w])) r -= __popc(s_run[w++]);
  if (r >= __popc(s_run[w])) return make_int3(-1, 0, 0);
  const int ray = w * 32 + (int)__fns(s_run[w], 0, r + 1);
  if (!kSplit) return make_int3(ray, 0, c4);
  const int part = threadIdx.x / g;
  const int share = c4 >> shift;
  return make_int3(ray, part * share, (part + 1) * share);
}

// ---------------------------------------------------------------------------
// K3: any hit (occlusion), terminating each ray on its first hit. One block
// of 128 threads per 128-ray block; a member's running rays are packed onto
// its first threads.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(kThreadsK3)
any_kernel(const float* __restrict__ rays8, const float* __restrict__ keys,
           const uint32_t* __restrict__ bits_lo, const uint32_t* __restrict__ bits_hi,
           const int* __restrict__ rowix, const int* __restrict__ xfix, const int* __restrict__ count,
           const float* __restrict__ xf_inv, const float* __restrict__ rows, int e, int c,
           int* __restrict__ occ_out) {
  extern __shared__ float4 s_slots[];  // 2 x [9][c]
  // the block's rays and occlusion flags, for the thread a member's packed
  // ray lands on, and which rays run the member
  __shared__ Ray s_ray[kBlock];
  __shared__ int s_occ[kBlock];
  __shared__ unsigned s_run[kBlock / 32];

  const int b = blockIdx.x;
  const int sub = threadIdx.x >> 4;
  const Ray R = load_ray(rays8, (size_t)b * kBlock + threadIdx.x);
  const float reach = min_nan(R.tmax * R.dlen, kBig);
  s_ray[threadIdx.x] = R;  // the first vote's barrier publishes these before any M-T
  s_occ[threadIdx.x] = 0;

  const size_t row0 = (size_t)b * e;
  // A ray's flag is set by whichever thread ran it; a vote that reads it
  // before the barrier that follows can only see a ray still running, which
  // adds a member at most, and every M-T reads the flags after that barrier.
  sweep_walk<kThreadsK3, kSlotsK3>(
      reinterpret_cast<float*>(s_slots), c, count[b], row0, keys, bits_lo, bits_hi, rowix, rows,
      // occluded rays leave the vote and the early exit
      [&](float key, uint32_t lw, uint32_t hw, unsigned(&v)[3]) {
        const bool run = !s_occ[threadIdx.x] && key <= reach;
        const uint32_t mine = run ? (sub < 4 ? lw : hw) & (0xffu << ((sub & 3) * 8)) : 0u;
        v[0] = sub < 4 ? mine : 0u;
        v[1] = sub < 4 ? 0u : mine;
        v[2] = run;
      },
      [&](const float* __restrict__ s_tri, int i, int k, unsigned subs) {
        const size_t ei = row0 + i;
        // thread t takes the t-th ray of the block that runs member k, all its columns
        unsigned bal;
        int rank, parts;
        const int3 pk = pack_rays<false>(!s_occ[threadIdx.x] && ((subs >> sub) & 1u) && keys[ei] <= reach,
                                         c >> 2, s_run, bal, rank, parts);
        if (pk.x < 0) return;
        const Ray Rp = s_ray[pk.x];
        float lp[3], dp[3];
        xform(Rp, xf_inv + (size_t)xfix[ei] * 16, lp, dp);
        if (member_occludes(s_tri, c, 0, c >> 2, Rp, lp, dp)) s_occ[pk.x] = 1;
      });
  __syncthreads();
  occ_out[(size_t)b * kBlock + threadIdx.x] = s_occ[threadIdx.x];
}

// ---------------------------------------------------------------------------
// K4a / K4b: the hierarchical (node) walk. Replaces `_hier_kernel_body` with
// `_closest_kernel_hier` / `_any_kernel_hier` and `_node_recull` of the
// reference. A node is kNode entries of kSuper clusters (64 cluster boxes,
// csph (N2, 8, 64)). One block of 128 threads per 128-ray block walks its
// sorted nodes near to far; thread t owns ray t for the node's re-cull.
//
// Per node: the six box rows the slab test reads (1.5 KiB) arrive by 16-byte
// cp.async, requested while the previous node's members ran. After the
// barrier that publishes them every warp reduces the rays' bounds from shared
// memory itself (the early exit needs no barrier of its own), then each
// thread re-culls its ray on its current [t_min, t] against the 64 boxes,
// four columns per float4 read, into a 64-bit mask, and one block-wide OR
// (one barrier) gives the node's member list.
//
// Per member (entry k2 = 0..7, member k = 0..7: the reference's visit
// order): its 9 x C rows come by 16-byte cp.async into one staging slot (a
// second slot holding the next member's copy measured no faster, with 5
// blocks resident per SM to hide the copy). At 8.7M triangles the rows table
// is 556 MB, beyond the 50 MB L2, and on incoherent rays a member is run by
// few of the block's rays (16 of 128 on average on the big scene's second
// bounce), so one ray per thread left three warps of four waiting at every
// barrier for half a warp walking 256 columns. Instead the rays that run the
// member are packed onto the block's threads (`pack_rays`: a ballot per
// warp, one barrier), and each ray gets as many threads as fit the block and
// divide the member's columns, a power of two: thread t of part t / g takes
// the (t % g)-th running ray and the part's share of the columns, a warp
// reading one part's columns as broadcast float4s. A ray's state lives in
// shared memory for the thread it lands on.
//  K4a: every part keeps the nearest hit of its columns (lowest column on a
//      tie); after the next barrier the ray's own thread folds the parts in
//      column order with a strict <, which is what a ray walking all C
//      columns itself would keep. best / tri stay in that thread's registers,
//      with a copy of best in shared memory for the parts' pruning.
//  K4b: a part that hits sets the ray's occlusion flag and zeroes its bound.
//      Before each member a block-wide vote ORs the masks of the rays not
//      yet occluded, so members named only by rays occluded earlier in the
//      node are neither staged nor run; a flag read before the vote's
//      barrier can only be that of a ray still running, which adds a member
//      at most, and every M-T reads the flags after a barrier.
// The TPU's whole-node DMA ring (2 x 8 x 16 x 8C f32, 2 MiB at C = 256) and
// its per-group packed gate bits are gone: the per-ray mask is finer than
// any group gate and changes no result, since the slab test is conservative.
// Bound by the FP32 instruction rate of M-T at the first bounce, as K2/K3
// (the bytes a block stages come to a tenth of that time); what the design
// buys on the deeper bounces is latency, not operations (PERF.md).
// ---------------------------------------------------------------------------
constexpr int kNode = 8;                   // entries per node
constexpr int kNodeCols = kNode * kSuper;  // cluster boxes per node
constexpr int kBoxRows = 6;                // staged rows of a node's box table: [cx cy cz hx hy hz]
constexpr int kSlotsK4 = 1;                // staging slots of 9 x C f32

// Request the six rows of csph[nid] (8 rows x 64 cluster columns) that the
// re-cull reads, as one group of 16-byte copies.
template <int kThreads>
__device__ __forceinline__ void request_boxes(float* __restrict__ s_box, const float* __restrict__ csph,
                                              int nid) {
  const float* src = csph + (size_t)nid * 8 * kNodeCols;
  for (int idx = threadIdx.x; idx < kBoxRows * (kNodeCols / 4); idx += kThreads) {
    const int row = idx / (kNodeCols / 4), col = 4 * (idx % (kNodeCols / 4));
    cp_async16(s_box + row * kNodeCols + col, src + (row < 3 ? row : row + 1) * kNodeCols + col);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Slab test of the ray's [0, tcur] against the node's 64 cluster boxes
// (`_node_recull`), four columns per float4 read: bit col of the result =
// the ray may hit cluster col.
__device__ __forceinline__ unsigned long long node_recull(const Ray& R, const float iv[3], float tcur,
                                                          const float* __restrict__ s_box) {
  if (!(tcur > R.tmin)) return 0ull;
  const float av[3] = {fabsf(iv[0]), fabsf(iv[1]), fabsf(iv[2])};
  const float4* b4 = reinterpret_cast<const float4*>(s_box);
  unsigned word[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    unsigned m = 0;
    for (int j4 = 0; j4 < kNodeCols / 8; ++j4) {
      float4 q[3], h[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        q[a] = b4[a * (kNodeCols / 4) + half * (kNodeCols / 8) + j4];
        h[a] = b4[(3 + a) * (kNodeCols / 4) + half * (kNodeCols / 8) + j4];
      }
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        float t0[3], t1[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float mid = (lane4(q[a], l) - R.o[a]) * iv[a];
          const float rad = lane4(h[a], l) * av[a];
          t0[a] = mid - rad;
          t1[a] = mid + rad;
        }
        const float tn = max_nan(max_nan(t0[0], t0[1]), max_nan(t0[2], 0.0f));
        const float tf = min_nan(min_nan(t1[0], t1[1]), min_nan(t1[2], tcur));
        if (tn <= tf + fabsf(tf) * 4e-7f + 1e-30f) m |= 1u << (4 * j4 + l);
      }
    }
    word[half] = m;
  }
  return ((unsigned long long)word[1] << 32) | word[0];
}

// Max of the block's kBlock per-ray bounds in shared memory. Every warp
// reduces all of them itself, so the call needs no barrier of its own: the
// caller's last barrier made the bounds visible.
__device__ __forceinline__ float reach_max(const float* __restrict__ s_reach) {
  const int lane = threadIdx.x & 31;
  float v = max_nan(max_nan(s_reach[lane], s_reach[lane + 32]), max_nan(s_reach[lane + 64], s_reach[lane + 96]));
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// OR of the block's 64-bit masks through block_or; one barrier.
template <int kThreads>
__device__ __forceinline__ unsigned long long block_or64(unsigned long long m, unsigned (*s_or)[3][kThreads / 32],
                                                         int& row) {
  unsigned v[3] = {(unsigned)m, (unsigned)(m >> 32), 0u};
  block_or<kThreads>(v, s_or, row);
  return ((unsigned long long)v[1] << 32) | v[0];
}

__device__ __forceinline__ void load_iv(const Ray& R, float iv[3]) {
  for (int a = 0; a < 3; ++a) iv[a] = 1.0f / (fabsf(R.d[a]) > 1e-30f ? R.d[a] : 1e-30f);
}

// (kBlock, 1): without the second argument ptxas holds these two kernels to
// 80 registers and spills; with it they take 96 and spill nothing.
__global__ void __launch_bounds__(kBlock, 1)
closest_hier_kernel(const float* __restrict__ rays8, const int* __restrict__ ids,
                    const float* __restrict__ keys, const int* __restrict__ count,
                    const int* __restrict__ erow2, const int* __restrict__ exf2,
                    const float* __restrict__ csph, const float* __restrict__ xf_inv,
                    const float* __restrict__ rows, int n2, int c, float* __restrict__ t_out,
                    int* __restrict__ tri_out, int* __restrict__ vis_out) {
  extern __shared__ float4 s_slots[];  // [9][c]
  __shared__ __align__(16) float s_box[2][kBoxRows * kNodeCols];
  __shared__ unsigned s_or[2][3][kBlock / 32];
  __shared__ Ray s_ray[kBlock];
  __shared__ float s_best[kBlock];   // per ray: its best hit, as its own thread last combined it
  __shared__ float s_reach[kBlock];  // per ray: min(best * |d|, BIG), the early exit's operand
  __shared__ float s_pt[kBlock];     // per thread: the nearest hit of its packed ray in its share
  __shared__ int s_ptri[kBlock];     //   of the member's columns, and its triangle (-1: none)
  __shared__ unsigned s_run[kBlock / 32];
  __shared__ int s_vis;

  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31;
  const size_t ray = (size_t)b * kBlock + threadIdx.x;
  s_ray[threadIdx.x] = load_ray(rays8, ray);  // the first node's barrier publishes these before any M-T
  float best = s_ray[threadIdx.x].tmax;
  int btri = -1;
  s_best[threadIdx.x] = best;
  int vis = 0;
  if (threadIdx.x == 0) s_vis = 0;

  // This thread's ray ran the last member as the rank-th of the packed rays,
  // on `parts` threads: fold their results into best in column order, with
  // the strict < of a ray that walks the columns itself.
  int rank = -1, parts = 1;
  const auto combine = [&]() {
    if (rank < 0) return;
    for (int p = 0; p < parts; ++p) {
      const int t = p * (kBlock / parts) + rank;
      if (s_ptri[t] >= 0 && s_pt[t] < best) {
        best = s_pt[t];
        btri = s_ptri[t];
      }
    }
    s_best[threadIdx.x] = best;
    rank = -1;
  };

  float* const s_tri = reinterpret_cast<float*>(s_slots);
  const size_t super_stride = (size_t)kStoreRows * kSuper * c;
  const int n_nodes = count[b];
  const size_t row0 = (size_t)b * n2;
  int orow = 0, bslot = 0;
  if (n_nodes > 0) request_boxes<kBlock>(s_box[0], csph, ids[row0]);
  for (int i = 0; i < n_nodes; ++i) {
    const int nid = ids[row0 + i];
    wait_copies(0);
    __syncthreads();  // the node's boxes; the last member's results
    if (i + 1 < n_nodes) request_boxes<kBlock>(s_box[bslot ^ 1], csph, ids[row0 + i + 1]);
    combine();
    // the thread's own ray, reloaded: it was not kept in registers through
    // the members, where the thread ran other rays
    const Ray R = s_ray[threadIdx.x];
    float iv[3];
    load_iv(R, iv);
    s_reach[threadIdx.x] = min_nan(best * R.dlen, kBig);
    __syncthreads();
    // early exit: every ray's best hit is nearer than the node's provable
    // distance lower bound (keys ascend)
    if (!(keys[row0 + i] <= reach_max(s_reach))) break;
    const unsigned long long mine = node_recull(R, iv, best, s_box[bslot]);
    unsigned long long rest = block_or64<kBlock>(mine, s_or, orow);
    bslot ^= 1;

    while (rest) {
      const int j = __ffsll((long long)rest) - 1;
      rest &= rest - 1;
      __syncthreads();  // the previous member's readers are done with the slot, its results written
      request_member<kBlock>(s_tri, rows + (size_t)erow2[nid * kNode + (j >> 3)] * super_stride, j & 7, c);
      combine();  // while the copy is in flight
      wait_copies(0);
      __syncthreads();  // member j is staged
      unsigned bal;
      const int3 pk = pack_rays((mine >> j) & 1ull, c >> 2, s_run, bal, rank, parts);
      if (lane == 0) vis += ((bal & 0xffffu) != 0) + ((bal >> 16) != 0);
      if (pk.x >= 0) {
        const int e = nid * kNode + (j >> 3);
        const Ray Rp[1] = {s_ray[pk.x]};
        const bool gp[1] = {true};
        float lp[1][3], dp[1][3], bp[1] = {s_best[pk.x]};
        int tp[1] = {-1};
        xform(Rp[0], xf_inv + (size_t)exf2[e] * 16, lp[0], dp[0]);
        member_closest<1>(s_tri, c, pk.y, pk.z, (e * kSuper + (j & 7)) * c, gp, Rp, lp, dp, bp, tp);
        s_pt[threadIdx.x] = bp[0];
        s_ptri[threadIdx.x] = tp[0];
      }
    }
  }
  wait_copies(0);  // the boxes requested ahead of an early exit
  __syncthreads();
  combine();
  t_out[ray] = best;
  tri_out[ray] = btri;
  if (lane == 0 && vis) atomicAdd(&s_vis, vis);
  __syncthreads();
  if (threadIdx.x == 0) vis_out[b] = s_vis;
}

__global__ void __launch_bounds__(kBlock, 1)
any_hier_kernel(const float* __restrict__ rays8, const int* __restrict__ ids,
                const float* __restrict__ keys, const int* __restrict__ count,
                const int* __restrict__ erow2, const int* __restrict__ exf2,
                const float* __restrict__ csph, const float* __restrict__ xf_inv,
                const float* __restrict__ rows, int n2, int c, int* __restrict__ occ_out) {
  extern __shared__ float4 s_slots[];  // [9][c]
  __shared__ __align__(16) float s_box[2][kBoxRows * kNodeCols];
  __shared__ unsigned s_or[2][3][kBlock / 32];
  __shared__ Ray s_ray[kBlock];
  __shared__ int s_occ[kBlock];
  __shared__ float s_reach[kBlock];  // per ray: its reach while it runs, 0 once occluded
  __shared__ unsigned s_run[kBlock / 32];

  const int b = blockIdx.x;
  const size_t ray = (size_t)b * kBlock + threadIdx.x;
  const Ray R = load_ray(rays8, ray);
  float iv[3];
  load_iv(R, iv);
  s_ray[threadIdx.x] = R;  // the first node's barrier publishes these before any M-T
  s_occ[threadIdx.x] = 0;
  s_reach[threadIdx.x] = min_nan(R.tmax * R.dlen, kBig);

  float* const s_tri = reinterpret_cast<float*>(s_slots);
  const size_t super_stride = (size_t)kStoreRows * kSuper * c;
  const int n_nodes = count[b];
  const size_t row0 = (size_t)b * n2;
  int orow = 0, bslot = 0;
  if (n_nodes > 0) request_boxes<kBlock>(s_box[0], csph, ids[row0]);
  for (int i = 0; i < n_nodes; ++i) {
    const int nid = ids[row0 + i];
    wait_copies(0);
    __syncthreads();  // the node's boxes; the flags and bounds the last members set
    if (i + 1 < n_nodes) request_boxes<kBlock>(s_box[bslot ^ 1], csph, ids[row0 + i + 1]);
    // occluded rays have left the bound
    if (!(keys[row0 + i] <= reach_max(s_reach))) break;
    // an occluded ray's interval is closed (tcur = t_min): it drops out
    const unsigned long long mine = node_recull(R, iv, s_occ[threadIdx.x] ? R.tmin : R.tmax, s_box[bslot]);
    const unsigned long long any = block_or64<kBlock>(mine, s_or, orow);
    bslot ^= 1;

    const auto request = [&](int j) {
      request_member<kBlock>(s_tri, rows + (size_t)erow2[nid * kNode + (j >> 3)] * super_stride, j & 7, c);
    };
    // The next member after member j that a ray not yet occluded names, or
    // -1. A flag read before the vote's barrier can only be that of a ray
    // still running, which adds a member at most.
    const auto next = [&](int j) {
      const unsigned long long m =
          (s_occ[threadIdx.x] || j >= kNodeCols - 1) ? 0ull : (mine & (~0ull << (j + 1)));
      const unsigned long long all = block_or64<kBlock>(m, s_or, orow);
      return all ? __ffsll((long long)all) - 1 : -1;
    };
    int cur = any ? __ffsll((long long)any) - 1 : -1;
    if (cur >= 0) request(cur);
    while (cur >= 0) {
      wait_copies(0);
      __syncthreads();  // member cur is staged
      unsigned bal;
      int rank, parts;
      const int3 pk = pack_rays(!s_occ[threadIdx.x] && ((mine >> cur) & 1ull), c >> 2, s_run, bal, rank, parts);
      if (pk.x >= 0) {
        const Ray Rp = s_ray[pk.x];
        float lp[3], dp[3];
        xform(Rp, xf_inv + (size_t)exf2[nid * kNode + (cur >> 3)] * 16, lp, dp);
        if (member_occludes(s_tri, c, pk.y, pk.z, Rp, lp, dp)) {
          s_occ[pk.x] = 1;
          s_reach[pk.x] = 0.0f;
        }
      }
      cur = next(cur);  // its barrier: the member's readers are done with the slot
      if (cur >= 0) request(cur);
    }
  }
  wait_copies(0);  // the boxes requested ahead of an early exit
  __syncthreads();
  occ_out[ray] = s_occ[threadIdx.x];
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Pointers are device pointers of
// contiguous tensors checked by the Python wrappers; `stream` is the
// caller's cudaStream_t. Each returns cudaGetLastError() after its launch.
// ---------------------------------------------------------------------------
extern "C" int cull_launch(int device, const void* rays8, const void* sph_t, const void* grp_t,
                           int nr, int m, void* key, void* lo, void* hi, void* count,
                           void* stream) {
  cudaSetDevice(device);
  cull_kernel<<<nr, kCullThreads, 0, (cudaStream_t)stream>>>(
      (const float*)rays8, (const float*)sph_t, (const float*)grp_t, m, m / kSuper, (float*)key,
      (uint32_t*)lo, (uint32_t*)hi, (int*)count);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the sweeps (the staging slots), opted in to, since
// with two slots it passes the default 48 KiB from C = 683 on (72 KiB at
// C = 1024). C must be a multiple of 4.
template <class Kernel>
static int sweep_smem(Kernel kernel, int slots, int c, size_t* bytes) {
  if (c <= 0 || c % 4) return (int)cudaErrorInvalidValue;
  *bytes = (size_t)slots * 9 * c * sizeof(float);
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

extern "C" int closest_launch(int device, const void* rays8, const void* ids, const void* keys,
                              const void* lo, const void* hi, const void* rowix, const void* xfix,
                              const void* count, const void* xf_inv, const void* rows, int nr, int e,
                              int c, void* t_out, void* tri_out, void* vis_out, void* stream) {
  cudaSetDevice(device);
  size_t smem;
  if (const int rc = sweep_smem(closest_kernel, kSlotsK2, c, &smem)) return rc;
  closest_kernel<<<nr, kThreadsK2, smem, (cudaStream_t)stream>>>(
      (const float*)rays8, (const int*)ids, (const float*)keys, (const uint32_t*)lo,
      (const uint32_t*)hi, (const int*)rowix, (const int*)xfix, (const int*)count,
      (const float*)xf_inv, (const float*)rows, e, c, (float*)t_out, (int*)tri_out, (int*)vis_out);
  return (int)cudaGetLastError();
}

extern "C" int any_launch(int device, const void* rays8, const void* keys, const void* lo,
                          const void* hi, const void* rowix, const void* xfix, const void* count,
                          const void* xf_inv, const void* rows, int nr, int e, int c, void* occ_out,
                          void* stream) {
  cudaSetDevice(device);
  size_t smem;
  if (const int rc = sweep_smem(any_kernel, kSlotsK3, c, &smem)) return rc;
  any_kernel<<<nr, kThreadsK3, smem, (cudaStream_t)stream>>>(
      (const float*)rays8, (const float*)keys, (const uint32_t*)lo, (const uint32_t*)hi,
      (const int*)rowix, (const int*)xfix, (const int*)count, (const float*)xf_inv,
      (const float*)rows, e, c, (int*)occ_out);
  return (int)cudaGetLastError();
}

extern "C" int closest_hier_launch(int device, const void* rays8, const void* ids, const void* keys,
                                   const void* count, const void* erow2, const void* exf2,
                                   const void* csph, const void* xf_inv, const void* rows, int nr,
                                   int n2, int c, void* t_out, void* tri_out, void* vis_out,
                                   void* stream) {
  cudaSetDevice(device);
  size_t smem;
  if (const int rc = sweep_smem(closest_hier_kernel, kSlotsK4, c, &smem)) return rc;
  closest_hier_kernel<<<nr, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)rays8, (const int*)ids, (const float*)keys, (const int*)count,
      (const int*)erow2, (const int*)exf2, (const float*)csph, (const float*)xf_inv,
      (const float*)rows, n2, c, (float*)t_out, (int*)tri_out, (int*)vis_out);
  return (int)cudaGetLastError();
}

extern "C" int any_hier_launch(int device, const void* rays8, const void* ids, const void* keys,
                               const void* count, const void* erow2, const void* exf2,
                               const void* csph, const void* xf_inv, const void* rows, int nr,
                               int n2, int c, void* occ_out, void* stream) {
  cudaSetDevice(device);
  size_t smem;
  if (const int rc = sweep_smem(any_hier_kernel, kSlotsK4, c, &smem)) return rc;
  any_hier_kernel<<<nr, kBlock, smem, (cudaStream_t)stream>>>(
      (const float*)rays8, (const int*)ids, (const float*)keys, (const int*)count,
      (const int*)erow2, (const int*)exf2, (const float*)csph, (const float*)xf_inv,
      (const float*)rows, n2, c, (int*)occ_out);
  return (int)cudaGetLastError();
}
