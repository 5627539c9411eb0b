// Native acceleration-structure compiler — the C++ runtime path for scene
// builds (the reference delegates this to optixAccelBuild + hardware,
// HelloPathtracing_original/SimplePathtracer.cpp:457-601; sutil/Scene.cpp:
// 776-1150). The Python/numpy builders (bvh/lbvh.py, bvh/wide.py,
// bvh/clusters.py) stay as the reference semantics and the fallback; this
// library replaces their host compute 1:1:
//
//   accel_build_binary   = bvh/lbvh.build_bvh host stage (morton codes ->
//                          stable sort -> Karras 2012 emit -> BFS levels ->
//                          exact f32 refit), BIT-EXACT vs the numpy code.
//   accel_wide_collapse  = bvh/wide.collapse (greedy largest-count slot
//                          expansion), BIT-EXACT including slot order.
//   accel_treelet_order  = bvh/clusters.treelet_order (recursive aligned
//                          median partition). Contract-equivalent, not
//                          bit-equal: numpy argpartition's intra-partition
//                          order is unspecified, so only the cluster
//                          tightness contract is shared.
//   accel_cluster_tables = bvh/clusters._cluster_tables (f64 bounds ->
//                          f32 spheres/rows in supercluster layout),
//                          BIT-EXACT vs the numpy code.
//
// Build: g++ -O2 -shared -fPIC -o libaccel.so accel.cpp
#include <algorithm>
#include <limits>
#include <cfenv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kSuper = 8;        // clusters per supercluster (clusters.SUPER)
constexpr int kStoreRows = 16;   // padded row count (clusters.STORE_ROWS)

inline uint32_t spread10(uint32_t v) {
    v = (v * 0x00010001u) & 0xFF0000FFu;
    v = (v * 0x00000101u) & 0x0F00F00Fu;
    v = (v * 0x00000011u) & 0xC30C30C3u;
    v = (v * 0x00000005u) & 0x49249249u;
    return v;
}

inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }

// Karras common-prefix metric with index tie-break (lbvh._np_delta).
inline int64_t delta(const uint32_t* codes, int64_t i, int64_t j, int64_t n) {
    if (j < 0 || j >= n) return -1;
    uint32_t x = codes[i] ^ codes[j];
    if (x == 0) return 32 + clz32(static_cast<uint32_t>(i ^ j));
    return clz32(x);
}

}  // namespace

extern "C" {

// ---------------------------------------------------------------------------
// Binary LBVH build: morton + stable argsort + Karras emit + levels + refit.
//
// Inputs: v0/v1/v2 (t, 3) float32 triangle vertices, leaf_size K.
// Outputs (caller-allocated; pad_to = max(K, ceil(t/K)*K), L = pad_to/K,
// M = max(1, L-1)):
//   order  (pad_to,) int64   sorted position -> original triangle
//   left/right (M,) int32    Karras children; leaves encoded -(leaf+1)
//   lmin/lmax/rmin/rmax (M,3) float32 child boxes stored at the parent
//   level  (M,) int32        node depth from the root
// Returns the tree depth in levels (incl. the leaf level), or -1 on error.
int32_t accel_build_binary(const float* v0, const float* v1, const float* v2,
                           int64_t t, int32_t leaf_size, int64_t* order,
                           int32_t* left, int32_t* right, float* lmin,
                           float* lmax, float* rmin, float* rmax,
                           int32_t* level) {
    if (t < 1 || leaf_size < 1) return -1;
    const int64_t k = leaf_size;
    const int64_t pad_to = std::max<int64_t>(k, ((t + k - 1) / k) * k);
    const int64_t n_leaves = pad_to / k;
    const int64_t m = std::max<int64_t>(1, n_leaves - 1);

    // --- morton codes of f64 centroids, quantized against the centroid AABB
    // (exactly np_morton_codes on (v0.astype(f64)+v1+v2)/3)
    std::vector<double> cx(t), cy(t), cz(t);
    double lo[3] = {1e300, 1e300, 1e300}, hi[3] = {-1e300, -1e300, -1e300};
    for (int64_t i = 0; i < t; ++i) {
        const double c3[3] = {
            (static_cast<double>(v0[3 * i + 0]) + v1[3 * i + 0] + v2[3 * i + 0]) / 3.0,
            (static_cast<double>(v0[3 * i + 1]) + v1[3 * i + 1] + v2[3 * i + 1]) / 3.0,
            (static_cast<double>(v0[3 * i + 2]) + v1[3 * i + 2] + v2[3 * i + 2]) / 3.0,
        };
        cx[i] = c3[0]; cy[i] = c3[1]; cz[i] = c3[2];
        for (int a = 0; a < 3; ++a) {
            lo[a] = std::min(lo[a], c3[a]);
            hi[a] = std::max(hi[a], c3[a]);
        }
    }
    double ext[3];
    for (int a = 0; a < 3; ++a) ext[a] = std::max(hi[a] - lo[a], 1e-9);
    std::vector<uint32_t> codes(t);
    for (int64_t i = 0; i < t; ++i) {
        const double c3[3] = {cx[i], cy[i], cz[i]};
        uint32_t q[3];
        for (int a = 0; a < 3; ++a) {
            double f = (c3[a] - lo[a]) / ext[a] * 1024.0;
            f = std::min(std::max(f, 0.0), 1023.0);
            q[a] = static_cast<uint32_t>(f);  // trunc toward zero == np astype
        }
        codes[i] = (spread10(q[0]) << 2) | (spread10(q[1]) << 1) | spread10(q[2]);
    }

    // --- stable argsort by code (matches np.argsort(kind="stable"))
    for (int64_t i = 0; i < t; ++i) order[i] = i;
    std::stable_sort(order, order + t, [&](int64_t a, int64_t b) {
        return codes[a] < codes[b];
    });
    for (int64_t i = t; i < pad_to; ++i) order[i] = order[t - 1];

    // --- leaf boxes over f32 per-tri AABBs (exact min/max) + leaf codes
    std::vector<float> lf_min(n_leaves * 3), lf_max(n_leaves * 3);
    std::vector<uint32_t> leaf_codes(n_leaves);
    for (int64_t lf = 0; lf < n_leaves; ++lf) {
        float bmin[3] = {3e38f, 3e38f, 3e38f}, bmax[3] = {-3e38f, -3e38f, -3e38f};
        for (int64_t s = 0; s < k; ++s) {
            const int64_t tri = order[lf * k + s];
            for (int a = 0; a < 3; ++a) {
                const float x0 = v0[3 * tri + a], x1 = v1[3 * tri + a],
                            x2 = v2[3 * tri + a];
                bmin[a] = std::min(bmin[a], std::min(x0, std::min(x1, x2)));
                bmax[a] = std::max(bmax[a], std::max(x0, std::max(x1, x2)));
            }
        }
        for (int a = 0; a < 3; ++a) {
            lf_min[3 * lf + a] = bmin[a];
            lf_max[3 * lf + a] = bmax[a];
        }
        leaf_codes[lf] = codes[order[lf * k]];
    }

    // --- Karras internal-node emission (serial per node; unique result)
    if (n_leaves == 1) {
        left[0] = -1;
        right[0] = -1;
        level[0] = 0;
        const float finf = std::numeric_limits<float>::infinity();
        for (int a = 0; a < 3; ++a) {
            lmin[a] = lf_min[a];
            lmax[a] = lf_max[a];
            rmin[a] = finf;
            rmax[a] = -finf;
        }
        return 1;
    }
    const uint32_t* lc = leaf_codes.data();
    const int64_t n = n_leaves;
    for (int64_t i = 0; i < n - 1; ++i) {
        int64_t d = 0;
        const int64_t dn = delta(lc, i, i + 1, n) - delta(lc, i, i - 1, n);
        d = dn > 0 ? 1 : (dn < 0 ? -1 : 1);
        const int64_t delta_min = delta(lc, i, i - d, n);
        int64_t l_max = 2;
        while (delta(lc, i, i + l_max * d, n) > delta_min) l_max *= 2;
        int64_t l = 0;
        for (int64_t step = l_max >> 1; step >= 1; step >>= 1)
            if (delta(lc, i, i + (l + step) * d, n) > delta_min) l += step;
        const int64_t j = i + l * d;
        const int64_t delta_node = delta(lc, i, j, n);
        // split search with the numpy loop's exact ceil-halving schedule
        int64_t s = 0, prev = l;
        for (int kk = 0;; ++kk) {
            const int64_t step = (prev + 1) >> 1;
            const bool active = (prev > 1) || (kk == 0);
            if (active && delta(lc, i, i + (s + step) * d, n) > delta_node)
                s += step;
            if (!(prev > 1)) break;
            prev = step;
        }
        const int64_t gamma = i + s * d + std::min<int64_t>(d, 0);
        const int64_t rlo = std::min(i, j), rhi = std::max(i, j);
        left[i] = static_cast<int32_t>(rlo == gamma ? -(gamma + 1) : gamma);
        right[i] = static_cast<int32_t>(rhi == gamma + 1 ? -(gamma + 2) : gamma + 1);
    }

    // --- BFS levels from the root
    std::vector<int64_t> frontier{0}, next;
    for (int64_t i = 0; i < m; ++i) level[i] = -1;
    level[0] = 0;
    int32_t depth = 0;
    while (!frontier.empty()) {
        next.clear();
        for (const int64_t s : frontier)
            for (const int32_t ch : {left[s], right[s]})
                if (ch >= 0) next.push_back(ch);
        if (next.empty()) break;
        ++depth;
        for (const int64_t s : next) level[s] = depth;
        frontier.swap(next);
    }

    // --- exact bottom-up refit via post-order DFS (f32 min/max is exact, so
    // any traversal order matches the numpy level sweeps bit-for-bit)
    std::vector<float> node_min(m * 3), node_max(m * 3);
    {
        std::vector<int64_t> stack{0};
        std::vector<int64_t> post;
        post.reserve(m);
        std::vector<uint8_t> seen(m, 0);
        seen[0] = 1;
        while (!stack.empty()) {
            const int64_t s = stack.back();
            stack.pop_back();
            post.push_back(s);
            for (const int32_t ch : {left[s], right[s]})
                if (ch >= 0 && !seen[ch]) {
                    seen[ch] = 1;
                    stack.push_back(ch);
                }
        }
        auto child_box = [&](int32_t ch, float* bmin, float* bmax) {
            if (ch < 0) {
                const int64_t lf = -(static_cast<int64_t>(ch) + 1);
                std::memcpy(bmin, &lf_min[3 * lf], 3 * sizeof(float));
                std::memcpy(bmax, &lf_max[3 * lf], 3 * sizeof(float));
            } else {
                std::memcpy(bmin, &node_min[3 * ch], 3 * sizeof(float));
                std::memcpy(bmax, &node_max[3 * ch], 3 * sizeof(float));
            }
        };
        for (auto it = post.rbegin(); it != post.rend(); ++it) {
            const int64_t s = *it;
            float a0[3], a1[3], b0[3], b1[3];
            child_box(left[s], a0, a1);
            child_box(right[s], b0, b1);
            for (int a = 0; a < 3; ++a) {
                node_min[3 * s + a] = std::min(a0[a], b0[a]);
                node_max[3 * s + a] = std::max(a1[a], b1[a]);
            }
        }
        for (int64_t s = 0; s < m; ++s) {
            child_box(left[s], &lmin[3 * s], &lmax[3 * s]);
            child_box(right[s], &rmin[3 * s], &rmax[3 * s]);
        }
    }
    return depth + 1;
}

// ---------------------------------------------------------------------------
// Wide-BVH collapse (bvh/wide.collapse): greedy expansion of the
// largest-leaf-count slot, BFS over wide nodes. Outputs are caller-allocated
// at the worst case Wn <= M: bbox (M, width, 6) f32, refs (M, width) i32.
// Writes the wide-node count to *wn_out; returns depth (levels) or -1.
int32_t accel_wide_collapse(const int32_t* left, const int32_t* right,
                            const float* lmin, const float* lmax,
                            const float* rmin, const float* rmax, int64_t m,
                            int64_t num_leaves, int32_t width, float* bbox,
                            int32_t* refs, int64_t* wn_out) {
    if (m < 1 || width < 2) return -1;
    constexpr int32_t kEmpty = 0x7FFFFFFF;

    // leaf boxes live at their (unique) parent entry
    std::vector<float> leaf_bmin(num_leaves * 3), leaf_bmax(num_leaves * 3);
    for (int64_t i = 0; i < m; ++i) {
        if (left[i] < 0) {
            const int64_t lf = -(static_cast<int64_t>(left[i]) + 1);
            std::memcpy(&leaf_bmin[3 * lf], &lmin[3 * i], 3 * sizeof(float));
            std::memcpy(&leaf_bmax[3 * lf], &lmax[3 * i], 3 * sizeof(float));
        }
        if (right[i] < 0) {
            const int64_t lf = -(static_cast<int64_t>(right[i]) + 1);
            std::memcpy(&leaf_bmin[3 * lf], &rmin[3 * i], 3 * sizeof(float));
            std::memcpy(&leaf_bmax[3 * lf], &rmax[3 * i], 3 * sizeof(float));
        }
    }
    auto box_of = [&](int64_t ref, float* bmin, float* bmax) {
        if (ref >= 0) {
            for (int a = 0; a < 3; ++a) {
                bmin[a] = std::min(lmin[3 * ref + a], rmin[3 * ref + a]);
                bmax[a] = std::max(lmax[3 * ref + a], rmax[3 * ref + a]);
            }
        } else {
            const int64_t lf = -(ref + 1);
            std::memcpy(bmin, &leaf_bmin[3 * lf], 3 * sizeof(float));
            std::memcpy(bmax, &leaf_bmax[3 * lf], 3 * sizeof(float));
        }
    };

    // subtree leaf counts over a DFS topological order
    std::vector<int64_t> counts(m, 0), post;
    post.reserve(m);
    {
        std::vector<int64_t> stack{0};
        std::vector<uint8_t> seen(m, 0);
        seen[0] = 1;
        while (!stack.empty()) {
            const int64_t s = stack.back();
            stack.pop_back();
            post.push_back(s);
            for (const int32_t ch : {left[s], right[s]})
                if (ch >= 0 && !seen[ch]) {
                    seen[ch] = 1;
                    stack.push_back(ch);
                }
        }
        for (auto it = post.rbegin(); it != post.rend(); ++it) {
            const int64_t s = *it;
            int64_t total = 0;
            for (const int32_t ch : {left[s], right[s]})
                total += ch >= 0 ? counts[ch] : 1;
            counts[s] = total;
        }
    }
    auto count_of = [&](int64_t ref) { return ref >= 0 ? counts[ref] : 1; };

    std::vector<int64_t> queue{0};
    std::vector<int32_t> depth_of{1};
    std::vector<int64_t> wide_id(m, -1);
    wide_id[0] = 0;
    int32_t max_depth = 1;
    std::vector<int64_t> slots;
    const float inf = std::numeric_limits<float>::infinity();

    for (size_t qi = 0; qi < queue.size(); ++qi) {
        const int64_t broot = queue[qi];
        const int32_t my_depth = depth_of[qi];
        slots.assign(1, broot);
        while (static_cast<int32_t>(slots.size()) < width) {
            // first slot holding the max-leaf-count internal subtree (the
            // Python `max(...)` picks the FIRST maximum in list order)
            int64_t best = -1, best_count = -1;
            for (size_t si = 0; si < slots.size(); ++si)
                if (slots[si] >= 0 && count_of(slots[si]) > best_count) {
                    best = static_cast<int64_t>(si);
                    best_count = count_of(slots[si]);
                }
            if (best < 0) break;
            const int64_t s = slots[best];
            slots.erase(slots.begin() + best);
            slots.push_back(left[s]);
            slots.push_back(right[s]);
        }
        float* nb = bbox + qi * width * 6;
        int32_t* nr = refs + qi * width;
        for (int32_t kk = 0; kk < width; ++kk) {
            nr[kk] = kEmpty;
            nb[6 * kk + 0] = nb[6 * kk + 1] = nb[6 * kk + 2] = inf;
            nb[6 * kk + 3] = nb[6 * kk + 4] = nb[6 * kk + 5] = -inf;
        }
        const int32_t n_slots =
            std::min<int32_t>(width, static_cast<int32_t>(slots.size()));
        for (int32_t kk = 0; kk < n_slots; ++kk) {
            const int64_t s = slots[kk];
            if (s >= 0) {
                if (wide_id[s] < 0) {
                    wide_id[s] = static_cast<int64_t>(queue.size());
                    queue.push_back(s);
                    depth_of.push_back(my_depth + 1);
                    max_depth = std::max(max_depth, my_depth + 1);
                }
                nr[kk] = static_cast<int32_t>(wide_id[s]);
            } else {
                nr[kk] = static_cast<int32_t>(s);
            }
            box_of(s, &nb[6 * kk], &nb[6 * kk + 3]);
        }
    }
    *wn_out = static_cast<int64_t>(queue.size());
    return max_depth + 1;
}

// ---------------------------------------------------------------------------
// Treelet repacking order (bvh/clusters.treelet_order): recursive
// longest-axis median partition with cluster-aligned splits. ctr is (n, 3)
// float64 centroids; writes the permutation to out. Returns 0, or -1.
int32_t accel_treelet_order(const double* ctr, int64_t n, int64_t c,
                            int64_t group, int64_t* out) {
    if (n < 1 || c < 1 || group < 1) return -1;
    for (int64_t i = 0; i < n; ++i) out[i] = i;
    const int64_t big = c * group;
    std::vector<std::pair<int64_t, int64_t>> stack{{0, n}};
    const int save_round = std::fegetround();
    std::fesetround(FE_TONEAREST);  // Python round() == banker's rounding
    while (!stack.empty()) {
        const auto [b, e] = stack.back();
        stack.pop_back();
        const int64_t k = e - b;
        if (k <= c) continue;  // emitted in place
        double blo[3] = {1e300, 1e300, 1e300}, bhi[3] = {-1e300, -1e300, -1e300};
        for (int64_t i = b; i < e; ++i)
            for (int a = 0; a < 3; ++a) {
                const double v = ctr[3 * out[i] + a];
                blo[a] = std::min(blo[a], v);
                bhi[a] = std::max(bhi[a], v);
            }
        int ax = 0;
        double best = bhi[0] - blo[0];
        for (int a = 1; a < 3; ++a)
            if (bhi[a] - blo[a] > best) {
                best = bhi[a] - blo[a];
                ax = a;
            }
        const int64_t align = k > big ? big : c;
        int64_t split = static_cast<int64_t>(std::nearbyint(
                            (static_cast<double>(k) / 2.0) / align)) * align;
        split = std::max(align, std::min(split, ((k - 1) / align) * align));
        std::nth_element(out + b, out + b + split, out + e,
                         [&](int64_t x, int64_t y) {
                             return ctr[3 * x + ax] < ctr[3 * y + ax];
                         });
        stack.emplace_back(b + split, e);
        stack.emplace_back(b, b + split);
    }
    std::fesetround(save_round);
    return 0;
}

// ---------------------------------------------------------------------------
// Cluster tables (bvh/clusters._cluster_tables): f64 bounds -> f32 sphere /
// rows tables in supercluster-grouped layout. Inputs are the TREELET-ORDERED
// f32 vertex arrays of length t_in; triangles at index >= num_real (or
// >= t_in) are degenerate padding. Caller allocates (m_pad = s*kSuper
// clusters, s = ceil(ceil(num_real/c)/kSuper) supers):
//   rows          (s, 16, kSuper*c) f32
//   spheres       (m_pad, 8) f32
//   super_spheres (s, 8) f32
//   scene_aabb    (8,) f32
// Returns 0, or -1 on bad arguments.
int32_t accel_cluster_tables(const float* v0, const float* v1, const float* v2,
                             int64_t t_in, int64_t num_real, int64_t c,
                             float* rows, float* spheres, float* super_spheres,
                             float* scene_aabb) {
    if (c < 1 || num_real < 0) return -1;
    const int64_t t_real = num_real;
    const int64_t m = std::max<int64_t>(1, (t_real + c - 1) / c);
    const int64_t s = (m + kSuper - 1) / kSuper;
    const int64_t m_pad = s * kSuper;

    auto fetch = [&](const float* v, int64_t tri, int a) -> double {
        // pad(v): rows [0, min(t_real, t_in)) copy through; beyond is zero
        if (tri >= t_real || tri >= t_in) return 0.0;
        return static_cast<double>(v[3 * tri + a]);
    };

    // zero the rows table once; only rows 0..8 of real columns get data
    std::memset(rows, 0, sizeof(float) * s * kStoreRows * kSuper * c);

    double sc_lo[3] = {1e300, 1e300, 1e300}, sc_hi[3] = {-1e300, -1e300, -1e300};
    bool any_scene = false;

    std::vector<double> su_lo(s * 3), su_hi(s * 3);
    std::vector<uint8_t> su_any(s, 0);
    for (int64_t i = 0; i < s * 3; ++i) {
        su_lo[i] = 1e300;
        su_hi[i] = -1e300;
    }

    for (int64_t cm = 0; cm < m_pad; ++cm) {
        const int64_t sup = cm / kSuper, member = cm % kSuper;
        double lo3[3] = {1e300, 1e300, 1e300}, hi3[3] = {-1e300, -1e300, -1e300};
        bool any = false;
        float* rbase = rows + (sup * kStoreRows) * (kSuper * c);
        const int64_t col0 = member * c;
        for (int64_t tr = 0; tr < c; ++tr) {
            const int64_t tri = cm * c + tr;
            const bool real = tri < t_real;
            double a0[3], a1[3], a2[3];
            for (int a = 0; a < 3; ++a) {
                a0[a] = real ? fetch(v0, tri, a) : 0.0;
                a1[a] = real ? fetch(v1, tri, a) : 0.0;
                a2[a] = real ? fetch(v2, tri, a) : 0.0;
            }
            const int64_t col = col0 + tr;
            const int64_t stride = kSuper * c;
            for (int a = 0; a < 3; ++a) {
                rbase[(0 + a) * stride + col] = static_cast<float>(a0[a]);
                rbase[(3 + a) * stride + col] = static_cast<float>(a1[a] - a0[a]);
                rbase[(6 + a) * stride + col] = static_cast<float>(a2[a] - a0[a]);
            }
            if (real) {
                any = true;
                for (int a = 0; a < 3; ++a) {
                    const double mn = std::min(a0[a], std::min(a1[a], a2[a]));
                    const double mx = std::max(a0[a], std::max(a1[a], a2[a]));
                    lo3[a] = std::min(lo3[a], mn);
                    hi3[a] = std::max(hi3[a], mx);
                }
            }
        }
        double ctr3[3], half3[3];
        for (int a = 0; a < 3; ++a) {
            const double lo_v = any ? lo3[a] : 0.0, hi_v = any ? hi3[a] : 0.0;
            ctr3[a] = 0.5 * (lo_v + hi_v);
            half3[a] = 0.5 * (hi_v - lo_v);
        }
        double rad = std::sqrt(half3[0] * half3[0] + half3[1] * half3[1] +
                               half3[2] * half3[2]);
        rad = any ? rad * (1.0 + 1e-5) + 1e-30 : 0.0;
        float* sp = spheres + 8 * cm;
        for (int a = 0; a < 3; ++a) sp[a] = static_cast<float>(ctr3[a]);
        sp[3] = static_cast<float>(rad);
        for (int a = 0; a < 3; ++a)
            sp[4 + a] = static_cast<float>(half3[a] * (1.0 + 1e-5));
        sp[7] = 0.0f;
        if (any) {
            su_any[sup] = 1;
            for (int a = 0; a < 3; ++a) {
                su_lo[3 * sup + a] = std::min(su_lo[3 * sup + a], lo3[a]);
                su_hi[3 * sup + a] = std::max(su_hi[3 * sup + a], hi3[a]);
                sc_lo[a] = std::min(sc_lo[a], lo3[a]);
                sc_hi[a] = std::max(sc_hi[a], hi3[a]);
            }
            any_scene = true;
        }
    }

    for (int64_t sup = 0; sup < s; ++sup) {
        double ctr3[3], half3[3];
        for (int a = 0; a < 3; ++a) {
            const double lo_v = su_any[sup] ? su_lo[3 * sup + a] : 0.0;
            const double hi_v = su_any[sup] ? su_hi[3 * sup + a] : 0.0;
            ctr3[a] = 0.5 * (lo_v + hi_v);
            half3[a] = 0.5 * (hi_v - lo_v);
        }
        double rad = std::sqrt(half3[0] * half3[0] + half3[1] * half3[1] +
                               half3[2] * half3[2]);
        rad = su_any[sup] ? rad * (1.0 + 1e-5) + 1e-30 : 0.0;
        float* sp = super_spheres + 8 * sup;
        for (int a = 0; a < 3; ++a) sp[a] = static_cast<float>(ctr3[a]);
        sp[3] = static_cast<float>(rad);
        for (int a = 0; a < 3; ++a)
            sp[4 + a] = static_cast<float>(half3[a] * (1.0 + 1e-5));
        sp[7] = 0.0f;
    }

    double slo[3], shi[3];
    for (int a = 0; a < 3; ++a) {
        slo[a] = any_scene ? sc_lo[a] : 0.0;
        shi[a] = any_scene ? sc_hi[a] : 0.0;
    }
    double amax = 1.0;
    for (int a = 0; a < 3; ++a)
        amax = std::max(amax, std::max(std::abs(slo[a]), std::abs(shi[a])));
    const double pad_abs = 1e-5 * amax;
    for (int a = 0; a < 3; ++a) {
        scene_aabb[a] = static_cast<float>(slo[a] - pad_abs);
        scene_aabb[3 + a] = static_cast<float>(shi[a] + pad_abs);
    }
    scene_aabb[6] = scene_aabb[7] = 0.0f;
    return 0;
}

}  // extern "C"
