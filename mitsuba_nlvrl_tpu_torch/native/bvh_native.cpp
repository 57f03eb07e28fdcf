// Native BVH builder: binned-SAH over triangles.
//
// The port's copy of mitsuba_nlvrl_tpu/native/bvh_native.cpp, unchanged
// in what it computes, so both packages build the same tree (and so the
// same triangle order) from the same triangles with the same flags.
// Counterpart of the reference's C++ accel-structure builder (include/mitsuba/render/kdtree.h: TShapeKDTree::build with
// MinMaxBins :676-1908). The reference builds a SAH kd-tree with TBB
// tasks; here a binned-SAH *BVH* (16 bins, surface-area heuristic with
// median-split fallback) is built natively and flattened straight into
// the SoA node arrays the device traversal consumes (ops/bvh.py).
// Exposed with a plain C ABI for ctypes — no pybind11 dependency.
//
// Output layout (must match ops/bvh.py BVHArrays):
//   nodes are stored in PREORDER; inner node: a = left child index,
//   b = right child index; leaf: a = triangle offset into the reordered
//   arrays, b = triangle count. `order` maps reordered -> original ids.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct V3 {
    float x, y, z;
};

static inline V3 vmin(const V3 &a, const V3 &b) {
    return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
static inline V3 vmax(const V3 &a, const V3 &b) {
    return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

struct AABB {
    V3 lo{1e30f, 1e30f, 1e30f};
    V3 hi{-1e30f, -1e30f, -1e30f};
    void grow(const AABB &o) {
        lo = vmin(lo, o.lo);
        hi = vmax(hi, o.hi);
    }
    void grow(const V3 &p) {
        lo = vmin(lo, p);
        hi = vmax(hi, p);
    }
    float half_area() const {
        float dx = std::max(hi.x - lo.x, 0.0f);
        float dy = std::max(hi.y - lo.y, 0.0f);
        float dz = std::max(hi.z - lo.z, 0.0f);
        return dx * dy + dy * dz + dz * dx;
    }
};

constexpr int N_BINS = 16;

struct Builder {
    const AABB *boxes;       // per (original) triangle
    const V3 *cents;
    int leaf_size;
    std::vector<int32_t> order;  // permuted original ids
    // flat output
    std::vector<float> node_lo, node_hi;
    std::vector<int32_t> node_a, node_b;
    std::vector<uint8_t> node_leaf;

    int32_t emit() {
        node_lo.insert(node_lo.end(), {0, 0, 0});
        node_hi.insert(node_hi.end(), {0, 0, 0});
        node_a.push_back(0);
        node_b.push_back(0);
        node_leaf.push_back(0);
        return (int32_t)node_leaf.size() - 1;
    }

    void set_bounds(int32_t idx, const AABB &bb) {
        std::memcpy(&node_lo[idx * 3], &bb.lo, 12);
        std::memcpy(&node_hi[idx * 3], &bb.hi, 12);
    }

    // Iterative build with an explicit stack (the reference recurses via
    // TBB tasks; deep meshes must not blow the C stack here).
    void build(int64_t T) {
        struct Job {
            int64_t start, end;
            int32_t node;
        };
        std::vector<Job> stack;
        int32_t root = emit();
        stack.push_back({0, T, root});

        while (!stack.empty()) {
            Job jb = stack.back();
            stack.pop_back();
            int64_t start = jb.start, end = jb.end, n = end - start;

            AABB bb, cb;  // geometry bounds + centroid bounds
            for (int64_t i = start; i < end; ++i) {
                bb.grow(boxes[order[i]]);
                cb.grow(cents[order[i]]);
            }
            set_bounds(jb.node, bb);

            if (n <= leaf_size) {
                node_leaf[jb.node] = 1;
                node_a[jb.node] = (int32_t)start;
                node_b[jb.node] = (int32_t)n;
                continue;
            }

            // --- binned SAH over the widest centroid axis ---------------
            float ext[3] = {cb.hi.x - cb.lo.x, cb.hi.y - cb.lo.y,
                            cb.hi.z - cb.lo.z};
            int axis = 0;
            if (ext[1] > ext[0]) axis = 1;
            if (ext[2] > ext[axis]) axis = 2;
            const float clo = (&cb.lo.x)[axis];
            const float cext = std::max(ext[axis], 1e-20f);
            const float scale = N_BINS / cext;

            AABB bin_bb[N_BINS];
            int64_t bin_n[N_BINS] = {0};
            for (int64_t i = start; i < end; ++i) {
                const int32_t t = order[i];
                int b = (int)(((&cents[t].x)[axis] - clo) * scale);
                b = std::min(std::max(b, 0), N_BINS - 1);
                bin_bb[b].grow(boxes[t]);
                bin_n[b]++;
            }

            // sweep: cost(i) = A_left*n_left + A_right*n_right
            AABB acc;
            float left_area[N_BINS - 1];
            int64_t left_cnt[N_BINS - 1];
            int64_t cnt = 0;
            for (int i = 0; i < N_BINS - 1; ++i) {
                acc.grow(bin_bb[i]);
                cnt += bin_n[i];
                left_area[i] = acc.half_area();
                left_cnt[i] = cnt;
            }
            acc = AABB();
            cnt = 0;
            float best_cost = 1e30f;
            int best_split = -1;
            for (int i = N_BINS - 1; i >= 1; --i) {
                acc.grow(bin_bb[i]);
                cnt += bin_n[i];
                if (left_cnt[i - 1] == 0 || cnt == 0)
                    continue;
                float c = left_area[i - 1] * left_cnt[i - 1]
                          + acc.half_area() * cnt;
                if (c < best_cost) {
                    best_cost = c;
                    best_split = i;
                }
            }

            int64_t mid;
            if (best_split < 0) {
                // degenerate centroids: median split keeps the tree bounded
                mid = start + n / 2;
                std::nth_element(
                    order.begin() + start, order.begin() + mid,
                    order.begin() + end, [&](int32_t a, int32_t b) {
                        return (&cents[a].x)[axis] < (&cents[b].x)[axis];
                    });
            } else {
                const float cut = clo + best_split / scale;
                auto it = std::partition(
                    order.begin() + start, order.begin() + end,
                    [&](int32_t t) { return (&cents[t].x)[axis] < cut; });
                mid = it - order.begin();
                if (mid == start || mid == end)
                    mid = start + n / 2;  // numerical edge: fall back
            }

            int32_t lnode = emit();
            int32_t rnode = emit();
            node_a[jb.node] = lnode;
            node_b[jb.node] = rnode;
            // preorder: left subtree fully precedes right. Push right
            // first so left pops first — BUT child node ids must also be
            // preorder-contiguous; emitting both up-front and building
            // depth-first keeps ids valid regardless of emission order.
            stack.push_back({mid, end, rnode});
            stack.push_back({start, mid, lnode});
        }
    }
};

}  // namespace

extern "C" {

// Returns the node count (<= 2*ceil(T/1)+1); caller buffers must hold
// 2*T (+1) nodes and T order entries.
int64_t mnt_build_bvh(const float *v0, const float *e1, const float *e2,
                      int64_t T, int leaf_size, float *out_lo,
                      float *out_hi, int32_t *out_a, int32_t *out_b,
                      uint8_t *out_leaf, int32_t *out_order) {
    std::vector<AABB> boxes((size_t)T);
    std::vector<V3> cents((size_t)T);
    for (int64_t i = 0; i < T; ++i) {
        V3 a{v0[i * 3], v0[i * 3 + 1], v0[i * 3 + 2]};
        V3 b{a.x + e1[i * 3], a.y + e1[i * 3 + 1], a.z + e1[i * 3 + 2]};
        V3 c{a.x + e2[i * 3], a.y + e2[i * 3 + 1], a.z + e2[i * 3 + 2]};
        AABB bb;
        bb.grow(a);
        bb.grow(b);
        bb.grow(c);
        boxes[i] = bb;
        cents[i] = {0.5f * (bb.lo.x + bb.hi.x), 0.5f * (bb.lo.y + bb.hi.y),
                    0.5f * (bb.lo.z + bb.hi.z)};
    }

    Builder bd;
    bd.boxes = boxes.data();
    bd.cents = cents.data();
    bd.leaf_size = leaf_size;
    bd.order.resize((size_t)T);
    for (int64_t i = 0; i < T; ++i)
        bd.order[i] = (int32_t)i;
    size_t reserve = (size_t)(2 * T + 1);
    bd.node_lo.reserve(reserve * 3);
    bd.node_hi.reserve(reserve * 3);
    bd.node_a.reserve(reserve);
    bd.node_b.reserve(reserve);
    bd.node_leaf.reserve(reserve);

    bd.build(T);

    int64_t M = (int64_t)bd.node_leaf.size();
    std::memcpy(out_lo, bd.node_lo.data(), (size_t)M * 12);
    std::memcpy(out_hi, bd.node_hi.data(), (size_t)M * 12);
    std::memcpy(out_a, bd.node_a.data(), (size_t)M * 4);
    std::memcpy(out_b, bd.node_b.data(), (size_t)M * 4);
    std::memcpy(out_leaf, bd.node_leaf.data(), (size_t)M);
    std::memcpy(out_order, bd.order.data(), (size_t)T * 4);
    return M;
}

}  // extern "C"
