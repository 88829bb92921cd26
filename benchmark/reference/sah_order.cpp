// The benchmark reference's scene order: a frozen copy of the program's
// chunk-aligned sweep-SAH treelet order (tpu_pathtracer_torch/csrc/
// accel_pack.cpp), compiled by g++ with the program's flags.  The order fixes
// the order of a scene's lights, and so which light a draw picks; std::sort
// breaks ties in its own way, which numpy cannot repeat.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <numeric>
#include <vector>

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

void sah_chunk_order_f32(const float* verts, const std::uint8_t* valid,
                         std::int64_t n, std::int64_t chunk,
                         std::int64_t* perm_out) {
    sah_chunk_order_t(verts, valid, n, chunk, perm_out);
}

}  // extern "C"
