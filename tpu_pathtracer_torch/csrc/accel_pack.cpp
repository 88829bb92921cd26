// Native host-side acceleration-structure packer of the PyTorch port.
//
// A copy of the JAX package's packer: Morton ordering, the chunk-aligned
// sweep-SAH order, per-triangle Woop inverse transforms and leaf AABBs in
// one multi-pass over the triangle soup.  The numpy implementations in
// scene/accel.py and scene/gltf.py are the reference and the fallback; this
// library lets large scenes pack at native speed.  Bound with ctypes by
// tpu_pathtracer_torch/scene/native.py, which builds it with g++ at first
// use into build/tpu_pathtracer_torch/libaccel_pack.so.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <numeric>
#include <vector>

namespace {

inline std::uint64_t spread_bits(std::uint64_t x) {
    x = (x | (x << 16)) & 0x030000FFull;
    x = (x | (x << 8)) & 0x0300F00Full;
    x = (x | (x << 4)) & 0x030C30C3ull;
    x = (x | (x << 2)) & 0x09249249ull;
    return x;
}

}  // namespace

// Each entry point is templated on the vertex element type and exported for
// float32 and float64: the scene pipeline keeps verts in f32, and the former
// f32 -> f64 conversion the fixed-f64 ABI forced cost more host time than
// the packing itself at Sponza-class counts.  All internal math stays f64.

// Morton-order permutation of valid triangles (invalid rows last, stable).
// verts: [n, 3, 3]; valid: [n] uint8; perm_out: [n] int64.
template <typename V>
static void morton_argsort_t(const V* verts, const std::uint8_t* valid,
                             std::int64_t n, std::int64_t* perm_out) {
    std::vector<double> cx(n), cy(n), cz(n);
    double lo[3] = {std::numeric_limits<double>::infinity(),
                    std::numeric_limits<double>::infinity(),
                    std::numeric_limits<double>::infinity()};
    double hi[3] = {-lo[0], -lo[1], -lo[2]};
    for (std::int64_t i = 0; i < n; ++i) {
        const V* v = verts + i * 9;
        // Promote per element: the f32 entry point must agree bit-for-bit
        // with "convert to f64, then pack" (the old ABI and the numpy twin).
        cx[i] = ((double)v[0] + (double)v[3] + (double)v[6]) / 3.0;
        cy[i] = ((double)v[1] + (double)v[4] + (double)v[7]) / 3.0;
        cz[i] = ((double)v[2] + (double)v[5] + (double)v[8]) / 3.0;
        if (valid[i]) {
            lo[0] = std::min(lo[0], cx[i]); hi[0] = std::max(hi[0], cx[i]);
            lo[1] = std::min(lo[1], cy[i]); hi[1] = std::max(hi[1], cy[i]);
            lo[2] = std::min(lo[2], cz[i]); hi[2] = std::max(hi[2], cz[i]);
        }
    }
    double ext[3];
    for (int a = 0; a < 3; ++a)
        ext[a] = std::max(hi[a] - lo[a], 1e-30);

    std::vector<std::uint64_t> code(n);
    for (std::int64_t i = 0; i < n; ++i) {
        if (!valid[i]) {
            code[i] = ~0ull;  // invalid rows sort last
            continue;
        }
        auto q = [&](double c, int a) -> std::uint64_t {
            double t = (c - lo[a]) / ext[a] * 1023.0;
            std::int64_t qi = static_cast<std::int64_t>(t);
            return static_cast<std::uint64_t>(std::clamp<std::int64_t>(qi, 0, 1023));
        };
        code[i] = (spread_bits(q(cx[i], 0)) << 2) |
                  (spread_bits(q(cy[i], 1)) << 1) |
                  spread_bits(q(cz[i], 2));
    }
    std::iota(perm_out, perm_out + n, 0);
    std::stable_sort(perm_out, perm_out + n, [&](std::int64_t a, std::int64_t b) {
        return code[a] < code[b];
    });
}

// Per-triangle Woop inverse transforms, [4, 3n] float32 column-grouped
// layout (see ops/intersect.py:build_woop).  NaN rows for degenerate or
// invalid triangles.
template <typename V>
static void build_woop_t(const V* verts, const std::uint8_t* valid,
                         std::int64_t n, float* out /* [4 * 3n] */) {
    const double nan = std::numeric_limits<double>::quiet_NaN();
    for (std::int64_t i = 0; i < n; ++i) {
        const V* v = verts + i * 9;
        double a[3] = {(double)v[0], (double)v[1], (double)v[2]};
        double e1[3] = {(double)v[3] - a[0], (double)v[4] - a[1],
                        (double)v[5] - a[2]};
        double e2[3] = {(double)v[6] - a[0], (double)v[7] - a[1],
                        (double)v[8] - a[2]};
        double n0[3] = {e1[1] * e2[2] - e1[2] * e2[1],
                        e1[2] * e2[0] - e1[0] * e2[2],
                        e1[0] * e2[1] - e1[1] * e2[0]};
        // Column matrix M = [e1 e2 n0]; det and inverse (adjugate / det).
        double m[3][3] = {{e1[0], e2[0], n0[0]},
                          {e1[1], e2[1], n0[1]},
                          {e1[2], e2[2], n0[2]}};
        double det = m[0][0] * (m[1][1] * m[2][2] - m[1][2] * m[2][1]) -
                     m[0][1] * (m[1][0] * m[2][2] - m[1][2] * m[2][0]) +
                     m[0][2] * (m[1][0] * m[2][1] - m[1][1] * m[2][0]);
        bool ok = valid[i] && std::isfinite(det) && det != 0.0;
        double inv[3][3];
        if (ok) {
            double id = 1.0 / det;
            inv[0][0] = (m[1][1] * m[2][2] - m[1][2] * m[2][1]) * id;
            inv[0][1] = (m[0][2] * m[2][1] - m[0][1] * m[2][2]) * id;
            inv[0][2] = (m[0][1] * m[1][2] - m[0][2] * m[1][1]) * id;
            inv[1][0] = (m[1][2] * m[2][0] - m[1][0] * m[2][2]) * id;
            inv[1][1] = (m[0][0] * m[2][2] - m[0][2] * m[2][0]) * id;
            inv[1][2] = (m[0][2] * m[1][0] - m[0][0] * m[1][2]) * id;
            inv[2][0] = (m[1][0] * m[2][1] - m[1][1] * m[2][0]) * id;
            inv[2][1] = (m[0][1] * m[2][0] - m[0][0] * m[2][1]) * id;
            inv[2][2] = (m[0][0] * m[1][1] - m[0][1] * m[1][0]) * id;
        }
        // Rows k = 0..2: inv; row 3: -inv @ a.  Column layout: col = 3i + c.
        for (int c = 0; c < 3; ++c) {
            double trans = 0.0;
            for (int k = 0; k < 3; ++k) {
                double val = ok ? inv[c][k] : nan;
                out[(std::size_t)k * 3 * n + 3 * i + c] = (float)val;
                if (ok) trans -= inv[c][k] * a[k];
            }
            out[(std::size_t)3 * 3 * n + 3 * i + c] = (float)(ok ? trans : nan);
        }
    }
}

// Leaf AABBs over consecutive runs of leaf_size triangles.
// verts: [n, 3, 3] (spatially ordered), valid: [n] u8;
// out_min/out_max: [n/leaf_size, 3] float32.
template <typename V>
static void build_leaf_aabbs_t(const V* verts, const std::uint8_t* valid,
                               std::int64_t n, std::int64_t leaf_size,
                               float* out_min, float* out_max) {
    const double inf = std::numeric_limits<double>::infinity();
    std::int64_t l = n / leaf_size;
    for (std::int64_t leaf = 0; leaf < l; ++leaf) {
        double mn[3] = {inf, inf, inf}, mx[3] = {-inf, -inf, -inf};
        for (std::int64_t t = leaf * leaf_size; t < (leaf + 1) * leaf_size; ++t) {
            if (!valid[t]) continue;
            const V* v = verts + t * 9;
            for (int vert = 0; vert < 3; ++vert)
                for (int a = 0; a < 3; ++a) {
                    mn[a] = std::min(mn[a], (double)v[vert * 3 + a]);
                    mx[a] = std::max(mx[a], (double)v[vert * 3 + a]);
                }
        }
        for (int a = 0; a < 3; ++a) {
            out_min[leaf * 3 + a] = (float)mn[a];
            out_max[leaf * 3 + a] = (float)mx[a];
        }
    }
}

// Chunk-aligned sweep-SAH treelet ordering (native twin of
// scene/accel.py:sah_chunk_order): recursively sort the id range along the
// longest centroid axis and cut at the chunk-aligned position minimizing
// SA_left*n_left + SA_right*n_right over triangle AABBs, emitting leaves in
// DFS order.  Same f32 key/bounds precision as the numpy build (the build
// only steers work placement; kernels recompute everything exactly).  Tie
// order inside a sort may differ from numpy's introsort — any permutation
// is a valid build (renders are estimator-identical under triangle order).
template <typename V>
static void sah_chunk_order_t(const V* verts, const std::uint8_t* valid,
                              std::int64_t n, std::int64_t chunk,
                              std::int64_t* perm_out) {
    std::vector<std::int64_t> idx_valid;
    idx_valid.reserve(n);
    for (std::int64_t i = 0; i < n; ++i)
        if (valid[i]) idx_valid.push_back(i);
    const std::int64_t m = (std::int64_t)idx_valid.size();
    if (m == 0) {
        std::iota(perm_out, perm_out + n, 0);
        return;
    }
    // Per-valid-triangle f32 centroids and (min, -max) boxes: one running
    // minimum yields both prefix bounds.
    std::vector<float> cent(m * 3), tbox(m * 6);
    for (std::int64_t j = 0; j < m; ++j) {
        const V* v = verts + idx_valid[j] * 9;
        for (int a = 0; a < 3; ++a) {
            float x0 = (float)v[a], x1 = (float)v[3 + a], x2 = (float)v[6 + a];
            cent[j * 3 + a] = (x0 + x1 + x2) / 3.0f;
            tbox[j * 6 + a] = std::min(x0, std::min(x1, x2));
            tbox[j * 6 + 3 + a] = -std::max(x0, std::max(x1, x2));
        }
    }
    std::vector<std::int64_t> ids(m);
    std::iota(ids.begin(), ids.end(), 0);
    std::vector<float> pre, suf;  // reused per node
    std::vector<std::pair<std::int64_t, std::int64_t>> stack{{0, m}};
    std::int64_t pos = 0;
    auto area = [](const float* b) {
        float dx = std::max(-b[3] - b[0], 0.0f);
        float dy = std::max(-b[4] - b[1], 0.0f);
        float dz = std::max(-b[5] - b[2], 0.0f);
        return dx * dy + dy * dz + dz * dx;
    };
    while (!stack.empty()) {
        auto [lo, hi] = stack.back();
        stack.pop_back();
        const std::int64_t k = hi - lo;
        if (k <= chunk) {
            // Leaf: emit in current order (matches numpy's out[pos:pos+k]).
            for (std::int64_t j = lo; j < hi; ++j)
                perm_out[pos++] = idx_valid[ids[j]];
            continue;
        }
        float clo[3] = {cent[ids[lo] * 3], cent[ids[lo] * 3 + 1],
                        cent[ids[lo] * 3 + 2]};
        float chi[3] = {clo[0], clo[1], clo[2]};
        for (std::int64_t j = lo + 1; j < hi; ++j)
            for (int a = 0; a < 3; ++a) {
                float c = cent[ids[j] * 3 + a];
                clo[a] = std::min(clo[a], c);
                chi[a] = std::max(chi[a], c);
            }
        int axis = 0;
        for (int a = 1; a < 3; ++a)
            if (chi[a] - clo[a] > chi[axis] - clo[axis]) axis = a;
        std::sort(ids.begin() + lo, ids.begin() + hi,
                  [&](std::int64_t a, std::int64_t b) {
                      return cent[a * 3 + axis] < cent[b * 3 + axis];
                  });
        const std::int64_t n_cuts = (k - 1) / chunk;
        std::int64_t best = chunk;
        if (n_cuts > 1) {
            pre.assign(k * 6, 0.0f);
            suf.assign(k * 6, 0.0f);
            for (int c = 0; c < 6; ++c) {
                pre[c] = tbox[ids[lo] * 6 + c];
                suf[(k - 1) * 6 + c] = tbox[ids[hi - 1] * 6 + c];
            }
            for (std::int64_t j = 1; j < k; ++j)
                for (int c = 0; c < 6; ++c)
                    pre[j * 6 + c] = std::min(pre[(j - 1) * 6 + c],
                                              tbox[ids[lo + j] * 6 + c]);
            for (std::int64_t j = k - 2; j >= 0; --j)
                for (int c = 0; c < 6; ++c)
                    suf[j * 6 + c] = std::min(suf[(j + 1) * 6 + c],
                                              tbox[ids[lo + j] * 6 + c]);
            float best_cost = std::numeric_limits<float>::infinity();
            for (std::int64_t ci = 1; ci <= n_cuts; ++ci) {
                std::int64_t cut = ci * chunk;
                float cost = area(&pre[(cut - 1) * 6]) * (float)cut +
                             area(&suf[cut * 6]) * (float)(k - cut);
                if (cost < best_cost) {  // strict <: first minimum, as argmin
                    best_cost = cost;
                    best = cut;
                }
            }
        }
        // Right pushed first so the left child is emitted first (DFS).
        stack.emplace_back(lo + best, hi);
        stack.emplace_back(lo, lo + best);
    }
    // Invalid rows last, in index order.
    for (std::int64_t i = 0; i < n; ++i)
        if (!valid[i]) perm_out[pos++] = i;
}

extern "C" {

void sah_chunk_order(const double* verts, const std::uint8_t* valid,
                     std::int64_t n, std::int64_t chunk,
                     std::int64_t* perm_out) {
    sah_chunk_order_t(verts, valid, n, chunk, perm_out);
}
void sah_chunk_order_f32(const float* verts, const std::uint8_t* valid,
                         std::int64_t n, std::int64_t chunk,
                         std::int64_t* perm_out) {
    sah_chunk_order_t(verts, valid, n, chunk, perm_out);
}

void morton_argsort(const double* verts, const std::uint8_t* valid,
                    std::int64_t n, std::int64_t* perm_out) {
    morton_argsort_t(verts, valid, n, perm_out);
}
void morton_argsort_f32(const float* verts, const std::uint8_t* valid,
                        std::int64_t n, std::int64_t* perm_out) {
    morton_argsort_t(verts, valid, n, perm_out);
}
void build_woop(const double* verts, const std::uint8_t* valid,
                std::int64_t n, float* out) {
    build_woop_t(verts, valid, n, out);
}
void build_woop_f32(const float* verts, const std::uint8_t* valid,
                    std::int64_t n, float* out) {
    build_woop_t(verts, valid, n, out);
}
void build_leaf_aabbs(const double* verts, const std::uint8_t* valid,
                      std::int64_t n, std::int64_t leaf_size,
                      float* out_min, float* out_max) {
    build_leaf_aabbs_t(verts, valid, n, leaf_size, out_min, out_max);
}
void build_leaf_aabbs_f32(const float* verts, const std::uint8_t* valid,
                          std::int64_t n, std::int64_t leaf_size,
                          float* out_min, float* out_max) {
    build_leaf_aabbs_t(verts, valid, n, leaf_size, out_min, out_max);
}

}  // extern "C"
