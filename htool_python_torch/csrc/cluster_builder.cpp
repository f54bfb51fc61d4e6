// Native cluster-tree builder (host C++, not a kernel).
//
// Copy of htool_python_tpu/native/cluster_builder.cpp, the reference's
// production cluster builder (the Htool core's ClusterTreeBuilder; binding
// surface at src/htool/clustering/cluster_tree_builder.hpp:13-68).  The
// numpy path in clustering/cluster.py keeps the same algorithm as the plain
// version, and the only one for user partitioning policies.
//
// Semantics mirror clustering/partitioning.py exactly:
//   direction  : weighted PCA largest eigenvector | bbox largest extent
//   split      : regular  = equal cumulative weight quantiles
//                geometric = equal projection-extent intervals
//   recursion  : BFS, children contiguous, leaf when size <= mls (unless
//                depth < minimal_depth forces a split) or size < nb_children
//   geometry   : weighted center; radius = max(dist to center + point radius)
//
// Built by g++ at first use (ops/cuda_build.py) and bound with ctypes
// (native/__init__.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <deque>
#include <numeric>
#include <vector>

namespace {

struct Tree {
    std::vector<int64_t> offsets, sizes, depths, parents;
    std::vector<int64_t> children_start, children_count;
    std::vector<double> centers;  // (nb_nodes, dim) row-major
    std::vector<double> radii;
    std::vector<int64_t> partition;
    std::vector<int64_t> permutation;
    int dim = 0;
};

struct Params {
    const double* coords;  // (dim, n) row-major: coords[d*n + i]
    const double* point_radii;
    const double* weights;
    int dim;
    int64_t n;
    int nb_children;
    int64_t mls;
    int minimal_depth;
    int direction_kind;  // 0 = PCA, 1 = bbox
    int split_kind;      // 0 = regular, 1 = geometric
};

// Largest eigenvector of a small (dim x dim) symmetric matrix by cyclic
// Jacobi (dim is 2 or 3 in practice; supports up to 8).
void largest_eigvec(int dim, double* a /*dim*dim*/, double* v_out) {
    std::vector<double> v(static_cast<size_t>(dim) * dim, 0.0);
    for (int i = 0; i < dim; ++i) v[static_cast<size_t>(i) * dim + i] = 1.0;
    for (int sweep = 0; sweep < 32; ++sweep) {
        double off = 0.0;
        for (int p = 0; p < dim; ++p)
            for (int q = p + 1; q < dim; ++q)
                off += a[p * dim + q] * a[p * dim + q];
        if (off < 1e-30) break;
        for (int p = 0; p < dim; ++p) {
            for (int q = p + 1; q < dim; ++q) {
                double apq = a[p * dim + q];
                if (std::fabs(apq) < 1e-300) continue;
                double app = a[p * dim + p], aqq = a[q * dim + q];
                double theta = 0.5 * (aqq - app) / apq;
                double t = (theta >= 0 ? 1.0 : -1.0) /
                           (std::fabs(theta) + std::sqrt(theta * theta + 1.0));
                double c = 1.0 / std::sqrt(t * t + 1.0), s = t * c;
                for (int k = 0; k < dim; ++k) {
                    double akp = a[k * dim + p], akq = a[k * dim + q];
                    a[k * dim + p] = c * akp - s * akq;
                    a[k * dim + q] = s * akp + c * akq;
                }
                for (int k = 0; k < dim; ++k) {
                    double apk = a[p * dim + k], aqk = a[q * dim + k];
                    a[p * dim + k] = c * apk - s * aqk;
                    a[q * dim + k] = s * apk + c * aqk;
                }
                for (int k = 0; k < dim; ++k) {
                    double vkp = v[static_cast<size_t>(k) * dim + p];
                    double vkq = v[static_cast<size_t>(k) * dim + q];
                    v[static_cast<size_t>(k) * dim + p] = c * vkp - s * vkq;
                    v[static_cast<size_t>(k) * dim + q] = s * vkp + c * vkq;
                }
            }
        }
    }
    int best = 0;
    for (int i = 1; i < dim; ++i)
        if (a[i * dim + i] > a[best * dim + best]) best = i;
    for (int k = 0; k < dim; ++k) v_out[k] = v[static_cast<size_t>(k) * dim + best];
    // sign convention (must match clustering/partitioning.py _pca_direction):
    // flip so the largest-magnitude component is positive — eigenvectors are
    // only defined up to sign and a flip reverses the projection sort, so a
    // fixed convention keeps the native and numpy paths producing the same
    // tree on the same inputs.
    int big = 0;
    for (int k = 1; k < dim; ++k)
        if (std::fabs(v_out[k]) > std::fabs(v_out[big])) big = k;
    if (v_out[big] < 0)
        for (int k = 0; k < dim; ++k) v_out[k] = -v_out[k];
}

void compute_direction(const Params& P, const int64_t* idx, int64_t m,
                       double* dir) {
    const int dim = P.dim;
    if (P.direction_kind == 1) {  // bbox
        int best = 0;
        double best_ext = -1.0;
        for (int d = 0; d < dim; ++d) {
            double lo = 1e300, hi = -1e300;
            const double* row = P.coords + static_cast<size_t>(d) * P.n;
            for (int64_t k = 0; k < m; ++k) {
                double x = row[idx[k]];
                lo = std::min(lo, x);
                hi = std::max(hi, x);
            }
            if (hi - lo > best_ext) { best_ext = hi - lo; best = d; }
        }
        std::fill(dir, dir + dim, 0.0);
        dir[best] = 1.0;
        return;
    }
    // weighted PCA
    std::vector<double> center(dim, 0.0);
    double wsum = 0.0;
    for (int64_t k = 0; k < m; ++k) wsum += P.weights[idx[k]];
    wsum = std::max(wsum, 2.2250738585072014e-308);
    for (int d = 0; d < dim; ++d) {
        const double* row = P.coords + static_cast<size_t>(d) * P.n;
        double acc = 0.0;
        for (int64_t k = 0; k < m; ++k)
            acc += row[idx[k]] * (P.weights[idx[k]] / wsum);
        center[d] = acc;
    }
    std::vector<double> cov(static_cast<size_t>(dim) * dim, 0.0);
    for (int64_t k = 0; k < m; ++k) {
        double w = P.weights[idx[k]] / wsum;
        for (int d = 0; d < dim; ++d) {
            double cd = P.coords[static_cast<size_t>(d) * P.n + idx[k]] - center[d];
            for (int e = d; e < dim; ++e) {
                double ce = P.coords[static_cast<size_t>(e) * P.n + idx[k]] - center[e];
                cov[static_cast<size_t>(d) * dim + e] += w * cd * ce;
            }
        }
    }
    for (int d = 0; d < dim; ++d)
        for (int e = 0; e < d; ++e)
            cov[static_cast<size_t>(d) * dim + e] = cov[static_cast<size_t>(e) * dim + d];
    largest_eigvec(dim, cov.data(), dir);
}

// Split idx (length m) into <= nb_children contiguous parts after a stable
// sort by projection.  Returns part boundaries into the REORDERED idx.
void split_node(const Params& P, int64_t* idx, int64_t m,
                std::vector<int64_t>& bounds /*out: part end positions*/) {
    const int dim = P.dim;
    double dir[16];
    compute_direction(P, idx, m, dir);
    std::vector<double> proj(m);
    for (int64_t k = 0; k < m; ++k) {
        double s = 0.0;
        for (int d = 0; d < dim; ++d)
            s += dir[d] * P.coords[static_cast<size_t>(d) * P.n + idx[k]];
        proj[k] = s;
    }
    std::vector<int64_t> order(m);
    std::iota(order.begin(), order.end(), 0);
    std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
        return proj[a] < proj[b];
    });
    std::vector<int64_t> idx_sorted(m);
    std::vector<double> proj_sorted(m), w_sorted(m);
    for (int64_t k = 0; k < m; ++k) {
        idx_sorted[k] = idx[order[k]];
        proj_sorted[k] = proj[order[k]];
        w_sorted[k] = P.weights[idx[order[k]]];
    }
    std::memcpy(idx, idx_sorted.data(), sizeof(int64_t) * m);

    bounds.clear();
    const int K = P.nb_children;
    bool geometric = P.split_kind == 1 &&
                     proj_sorted[m - 1] > proj_sorted[0];
    if (geometric) {
        double lo = proj_sorted[0], hi = proj_sorted[m - 1];
        int64_t start = 0;
        for (int c = 1; c < K; ++c) {
            double edge = lo + (hi - lo) * c / K;
            // searchsorted 'left'
            int64_t cut = std::lower_bound(proj_sorted.begin(),
                                           proj_sorted.end(), edge) -
                          proj_sorted.begin();
            if (cut > start) { bounds.push_back(cut); start = cut; }
        }
        if (m > start) bounds.push_back(m);
    } else {
        std::vector<double> cum(m);
        double acc = 0.0;
        for (int64_t k = 0; k < m; ++k) { acc += w_sorted[k]; cum[k] = acc; }
        double total = acc;
        int64_t start = 0;
        for (int c = 0; c < K; ++c) {
            int64_t stop;
            if (c == K - 1) {
                stop = m;
            } else {
                double q = total * (c + 1) / K;
                // numpy: searchsorted(cum, q, 'left') + 1, clamped
                int64_t pos = std::lower_bound(cum.begin(), cum.end(), q) -
                              cum.begin();
                stop = std::min(std::max(pos + 1, start), m);
            }
            if (stop > start) { bounds.push_back(stop); start = stop; }
        }
    }
}

void node_geometry(const Params& P, const int64_t* idx, int64_t m,
                   double* center_out, double* radius_out) {
    const int dim = P.dim;
    double wsum = 0.0;
    for (int64_t k = 0; k < m; ++k) wsum += P.weights[idx[k]];
    wsum = std::max(wsum, 2.2250738585072014e-308);
    for (int d = 0; d < dim; ++d) {
        const double* row = P.coords + static_cast<size_t>(d) * P.n;
        double acc = 0.0;
        for (int64_t k = 0; k < m; ++k)
            acc += row[idx[k]] * (P.weights[idx[k]] / wsum);
        center_out[d] = acc;
    }
    double rmax = 0.0;
    for (int64_t k = 0; k < m; ++k) {
        double d2 = 0.0;
        for (int d = 0; d < dim; ++d) {
            double diff = P.coords[static_cast<size_t>(d) * P.n + idx[k]] -
                          center_out[d];
            d2 += diff * diff;
        }
        rmax = std::max(rmax, std::sqrt(d2) + P.point_radii[idx[k]]);
    }
    *radius_out = m > 0 ? rmax : 0.0;
}

}  // namespace

extern "C" {

// Build a cluster tree.  top_part_sizes (length n_top_parts, or
// n_top_parts == 0 for no partition level) describes a pre-made top split of
// `perm_buffer` (which enters holding the initial index layout — identity,
// or the user's partition order — and leaves holding the final permutation).
void* ct_build(const double* coords, const double* point_radii,
               const double* weights, int dim, int64_t n, int nb_children,
               int64_t mls, int minimal_depth, int direction_kind,
               int split_kind, const int64_t* top_part_sizes,
               int64_t n_top_parts, int64_t* perm_buffer) {
    Params P{coords, point_radii, weights, dim, n, nb_children, mls,
             minimal_depth, direction_kind, split_kind};
    Tree* T = new Tree();
    T->dim = dim;
    T->permutation.assign(perm_buffer, perm_buffer + n);
    int64_t* perm = T->permutation.data();

    auto add_node = [&](int64_t offset, int64_t size, int64_t depth,
                        int64_t parent) -> int64_t {
        int64_t node = static_cast<int64_t>(T->sizes.size());
        T->offsets.push_back(offset);
        T->sizes.push_back(size);
        T->depths.push_back(depth);
        T->parents.push_back(parent);
        T->children_start.push_back(0);
        T->children_count.push_back(0);
        double c[16], r;
        node_geometry(P, perm + offset, size, c, &r);
        T->centers.insert(T->centers.end(), c, c + dim);
        T->radii.push_back(r);
        return node;
    };

    int64_t root = add_node(0, n, 0, -1);
    std::deque<int64_t> queue;  // node ids; segment = (offset, size)
    std::vector<int64_t> bounds;

    // top partition level (pre-split segments already laid out in perm)
    if (n_top_parts > 1) {
        T->children_start[root] = 1;
        T->children_count[root] = n_top_parts;
        int64_t off = 0;
        for (int64_t p = 0; p < n_top_parts; ++p) {
            int64_t child = add_node(off, top_part_sizes[p], 1, root);
            T->partition.push_back(child);
            queue.push_back(child);
            off += top_part_sizes[p];
        }
    } else {
        T->partition.push_back(root);
        queue.push_back(root);
    }

    while (!queue.empty()) {
        int64_t node = queue.front();
        queue.pop_front();
        int64_t offset = T->offsets[node], size = T->sizes[node];
        int64_t depth = T->depths[node];
        bool force = depth < minimal_depth;
        if ((size <= mls && !force) || size < nb_children) continue;
        split_node(P, perm + offset, size, bounds);
        if (bounds.size() <= 1) continue;
        T->children_start[node] = static_cast<int64_t>(T->sizes.size());
        T->children_count[node] = static_cast<int64_t>(bounds.size());
        int64_t start = 0;
        std::vector<int64_t> kids;
        for (int64_t stop : bounds) {
            kids.push_back(add_node(offset + start, stop - start, depth + 1,
                                    node));
            start = stop;
        }
        for (int64_t k : kids) queue.push_back(k);
    }
    std::memcpy(perm_buffer, perm, sizeof(int64_t) * n);
    return T;
}

int64_t ct_nb_nodes(void* h) { return static_cast<Tree*>(h)->sizes.size(); }
int64_t ct_nb_partitions(void* h) {
    return static_cast<Tree*>(h)->partition.size();
}

void ct_copy(void* h, int64_t* offsets, int64_t* sizes, int64_t* depths,
             int64_t* parents, int64_t* children_start,
             int64_t* children_count, double* centers, double* radii,
             int64_t* partition) {
    Tree* T = static_cast<Tree*>(h);
    size_t nn = T->sizes.size();
    std::memcpy(offsets, T->offsets.data(), nn * sizeof(int64_t));
    std::memcpy(sizes, T->sizes.data(), nn * sizeof(int64_t));
    std::memcpy(depths, T->depths.data(), nn * sizeof(int64_t));
    std::memcpy(parents, T->parents.data(), nn * sizeof(int64_t));
    std::memcpy(children_start, T->children_start.data(), nn * sizeof(int64_t));
    std::memcpy(children_count, T->children_count.data(), nn * sizeof(int64_t));
    std::memcpy(centers, T->centers.data(), nn * T->dim * sizeof(double));
    std::memcpy(radii, T->radii.data(), nn * sizeof(double));
    std::memcpy(partition, T->partition.data(),
                T->partition.size() * sizeof(int64_t));
}

void ct_free(void* h) { delete static_cast<Tree*>(h); }

}  // extern "C"
