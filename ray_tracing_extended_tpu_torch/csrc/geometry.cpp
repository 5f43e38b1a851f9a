// Host geometry of the PyTorch port: Morton codes, a u64 radix argsort and
// the recursive LBVH build over Morton-sorted primitives, and the top-down
// binned-SAH build.
//
// The first three are the port's own copy of the JAX package's
// native/geometry.cpp, the same code under the same C ABI. accel/bvh.py
// builds the same arrays with this library as with its NumPy builds, bit
// for bit, 50-100x faster on the 70k-triangle mesh. Loaded with ctypes by
// utils/native.py.
//
// Build (kernels/build.py, at first use): g++ -O3 -shared -fPIC
// -ffp-contract=off. No -march=native and no -ffast-math: the quantisation
// (v - lo) * inv_extent must round as NumPy's float32 arithmetic does, and
// the SAH's float64 costs as NumPy's, each operation rounded in the order
// written (no fused multiply-adds, no reassociation).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

inline uint64_t expand_bits(uint64_t v) {
  v = (v | (v << 16)) & 0x030000FFull;
  v = (v | (v << 8)) & 0x0300F00Full;
  v = (v | (v << 4)) & 0x030C30C3ull;
  v = (v | (v << 2)) & 0x09249249ull;
  return v;
}

inline uint64_t morton3(uint32_t x, uint32_t y, uint32_t z) {
  return (expand_bits(x) << 2) | (expand_bits(y) << 1) | expand_bits(z);
}

struct BuildCtx {
  const float* bmin;  // (n, 3)
  const float* bmax;
  const int32_t* order;  // Morton-sorted primitive ids
  const uint64_t* codes;  // sorted codes
  int leaf_width;
  int sentinel;
  // outputs
  float* node_bmin;
  float* node_bmax;
  int32_t* left;
  int32_t* right;
  int32_t* leaf_row;
  int32_t* leaf_prims;
  int n_nodes = 0;
  int n_leaves = 0;

  int new_node() {
    int id = n_nodes++;
    left[id] = -1;
    right[id] = -1;
    leaf_row[id] = -1;
    return id;
  }

  void node_bounds(int node, int s, int e) {
    float mn[3] = {3.4e38f, 3.4e38f, 3.4e38f};
    float mx[3] = {-3.4e38f, -3.4e38f, -3.4e38f};
    for (int i = s; i < e; ++i) {
      const int p = order[i];
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], bmin[3 * p + k]);
        mx[k] = std::max(mx[k], bmax[3 * p + k]);
      }
    }
    std::memcpy(node_bmin + 3 * node, mn, sizeof mn);
    std::memcpy(node_bmax + 3 * node, mx, sizeof mx);
  }

  int split_pos(int s, int e) const {
    const uint64_t first = codes[s], last = codes[e - 1];
    if (first == last) return (s + e) / 2;
    const int top_bit = 63 - __builtin_clzll(first ^ last);
    const uint64_t mask = 1ull << top_bit;
    // first index in [s, e) with the bit set (codes sorted ascending)
    int lo = s, hi = e;
    while (lo < hi) {
      const int mid = (lo + hi) / 2;
      if (codes[mid] & mask)
        hi = mid;
      else
        lo = mid + 1;
    }
    return lo;
  }

  void build(int node, int s, int e) {
    node_bounds(node, s, e);
    if (e - s <= leaf_width) {
      const int row = n_leaves++;
      leaf_row[node] = row;
      for (int j = 0; j < leaf_width; ++j)
        leaf_prims[row * leaf_width + j] =
            (s + j < e) ? order[s + j] : sentinel;
      return;
    }
    const int m = split_pos(s, e);
    const int l = new_node();
    const int r = new_node();
    left[node] = l;
    right[node] = r;
    build(l, s, m);
    build(r, m, e);
  }
};

constexpr int kSahBins = 32;
constexpr float kInf = std::numeric_limits<float>::infinity();

// 2 (ex ey + ey ez + ez ex) in float64, accel/bvh.py's _box_area.
inline double box_area(const float* lo, const float* hi) {
  const double e0 = (double)hi[0] - (double)lo[0];
  const double e1 = (double)hi[1] - (double)lo[1];
  const double e2 = (double)hi[2] - (double)lo[2];
  return 2.0 * (e0 * e1 + e1 * e2 + e2 * e0);
}

inline int sah_bin(double c, double lo, double extent) {
  const int64_t b = (int64_t)((c - lo) / extent * kSahBins);
  return (int)std::min<int64_t>(b, kSahBins - 1);
}

// accel/bvh.py's _sah_build_numpy over a permutation of the primitives: a
// node holds perm[s, e); its split partitions that range stably.
struct SahCtx {
  const float* bmin;  // (n, 3)
  const float* bmax;
  std::vector<double> cent;  // (n, 3) centroids
  std::vector<int32_t> perm, scratch;
  int leaf_width;
  int sentinel;
  // outputs
  float* node_bmin;
  float* node_bmax;
  int32_t* left;
  int32_t* right;
  int32_t* leaf_row;
  int32_t* leaf_prims;
  int n_nodes = 0;
  int n_leaves = 0;

  int new_node() {
    int id = n_nodes++;
    left[id] = -1;
    right[id] = -1;
    leaf_row[id] = -1;
    return id;
  }

  void node_bounds(int node, int s, int e) {
    float mn[3] = {kInf, kInf, kInf};
    float mx[3] = {-kInf, -kInf, -kInf};
    for (int i = s; i < e; ++i) {
      const int p = perm[i];
      for (int k = 0; k < 3; ++k) {
        mn[k] = std::min(mn[k], bmin[3 * p + k]);
        mx[k] = std::max(mx[k], bmax[3 * p + k]);
      }
    }
    std::memcpy(node_bmin + 3 * node, mn, sizeof mn);
    std::memcpy(node_bmax + 3 * node, mx, sizeof mx);
  }

  // The split of least cost over the three axes (the first axis, then
  // the first bin, on a tie): its axis, its last left bin and the axis's
  // binning, or axis -1 where every centroid falls in one bin.
  struct Split {
    int axis = -1, bin = -1;
    double lo = 0.0, extent = 0.0;
  };

  Split best_split(int s, int e) const {
    double c_lo[3], c_hi[3];
    for (int k = 0; k < 3; ++k) c_lo[k] = c_hi[k] = cent[3 * perm[s] + k];
    for (int i = s + 1; i < e; ++i)
      for (int k = 0; k < 3; ++k) {
        c_lo[k] = std::min(c_lo[k], cent[3 * perm[i] + k]);
        c_hi[k] = std::max(c_hi[k], cent[3 * perm[i] + k]);
      }
    const int64_t n = e - s;
    double best = std::numeric_limits<double>::infinity();
    Split split;
    for (int axis = 0; axis < 3; ++axis) {
      const double extent = c_hi[axis] - c_lo[axis];
      if (!(extent > 0.0)) continue;
      int64_t count[kSahBins] = {0};
      float lo[kSahBins][3], hi[kSahBins][3];
      for (int b = 0; b < kSahBins; ++b)
        for (int k = 0; k < 3; ++k) lo[b][k] = kInf, hi[b][k] = -kInf;
      for (int i = s; i < e; ++i) {
        const int p = perm[i];
        const int b = sah_bin(cent[3 * p + axis], c_lo[axis], extent);
        ++count[b];
        for (int k = 0; k < 3; ++k) {
          lo[b][k] = std::min(lo[b][k], bmin[3 * p + k]);
          hi[b][k] = std::max(hi[b][k], bmax[3 * p + k]);
        }
      }
      // r_lo[b], r_hi[b]: the box of bins b..kSahBins-1
      float r_lo[kSahBins][3], r_hi[kSahBins][3];
      for (int k = 0; k < 3; ++k) {
        r_lo[kSahBins - 1][k] = lo[kSahBins - 1][k];
        r_hi[kSahBins - 1][k] = hi[kSahBins - 1][k];
      }
      for (int b = kSahBins - 2; b >= 0; --b)
        for (int k = 0; k < 3; ++k) {
          r_lo[b][k] = std::min(r_lo[b + 1][k], lo[b][k]);
          r_hi[b][k] = std::max(r_hi[b + 1][k], hi[b][k]);
        }
      float l_lo[3] = {kInf, kInf, kInf};
      float l_hi[3] = {-kInf, -kInf, -kInf};
      int64_t n_left = 0;
      // the split after bin b: bins 0..b on the left
      for (int b = 0; b < kSahBins - 1; ++b) {
        for (int k = 0; k < 3; ++k) {
          l_lo[k] = std::min(l_lo[k], lo[b][k]);
          l_hi[k] = std::max(l_hi[k], hi[b][k]);
        }
        n_left += count[b];
        const int64_t n_right = n - n_left;
        if (n_left == 0 || n_right == 0) continue;
        const double cost = box_area(l_lo, l_hi) * (double)n_left +
                            box_area(r_lo[b + 1], r_hi[b + 1]) * (double)n_right;
        if (cost < best) {
          best = cost;
          split = {axis, b, c_lo[axis], extent};
        }
      }
    }
    return split;
  }

  // Partitions perm[s, e) by the split, keeping each side's order -> the
  // first index of the right side.
  int partition(int s, int e) {
    const Split split = best_split(s, e);
    if (split.axis < 0) return s + (e - s) / 2;  // halves by index
    int m = s, r = 0;
    for (int i = s; i < e; ++i) {
      const int p = perm[i];
      if (sah_bin(cent[3 * p + split.axis], split.lo, split.extent) <=
          split.bin)
        perm[m++] = p;
      else
        scratch[r++] = p;
    }
    std::memcpy(perm.data() + m, scratch.data(), r * sizeof(int32_t));
    return m;
  }

  void build(int n) {
    struct Work {
      int node, s, e;
    };
    std::vector<Work> work{{new_node(), 0, n}};
    while (!work.empty()) {
      const Work w = work.back();
      work.pop_back();
      node_bounds(w.node, w.s, w.e);
      if (w.e - w.s <= leaf_width) {
        const int row = n_leaves++;
        leaf_row[w.node] = row;
        for (int j = 0; j < leaf_width; ++j)
          leaf_prims[row * leaf_width + j] =
              (w.s + j < w.e) ? perm[w.s + j] : sentinel;
        continue;
      }
      const int m = partition(w.s, w.e);
      const int l = new_node();
      const int r = new_node();
      left[w.node] = l;
      right[w.node] = r;
      // the left subtree is numbered first
      work.push_back({r, m, w.e});
      work.push_back({l, w.s, m});
    }
  }
};

}  // namespace

extern "C" {

// Morton codes for quantized centroids; returns via codes_out (u64).
void rtx_morton3(const float* centroids, int n, const float* lo,
                 const float* inv_extent, uint64_t* codes_out) {
  for (int i = 0; i < n; ++i) {
    uint32_t q[3];
    for (int k = 0; k < 3; ++k) {
      float v = (centroids[3 * i + k] - lo[k]) * inv_extent[k];
      v = v < 0.f ? 0.f : (v > 1023.f ? 1023.f : v);
      q[k] = (uint32_t)v;
    }
    codes_out[i] = morton3(q[0], q[1], q[2]);
  }
}

// Stable argsort of u64 codes -> order_out (int32). LSB radix sort, 4x16bit.
void rtx_argsort_u64(const uint64_t* codes, int n, int32_t* order_out) {
  std::vector<int32_t> a(n), b(n);
  for (int i = 0; i < n; ++i) a[i] = i;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = pass * 16;
    int count[65536] = {0};
    for (int i = 0; i < n; ++i)
      count[(codes[a[i]] >> shift) & 0xFFFF]++;
    int sum = 0;
    for (int v = 0; v < 65536; ++v) {
      const int c = count[v];
      count[v] = sum;
      sum += c;
    }
    for (int i = 0; i < n; ++i)
      b[count[(codes[a[i]] >> shift) & 0xFFFF]++] = a[i];
    a.swap(b);
  }
  std::memcpy(order_out, a.data(), n * sizeof(int32_t));
}

// LBVH build over Morton-SORTED primitives. Outputs must be sized:
//   node_bmin/node_bmax: (2n, 3); left/right/leaf_row: (2n,)
//   leaf_prims: (n_leaves_max = ceil(n / 1), leaf_width) -> n * leaf_width
// Returns n_nodes; writes n_leaves via out_n_leaves.
int rtx_lbvh_build(const float* bmin, const float* bmax, int n,
                   const int32_t* order, const uint64_t* sorted_codes,
                   int leaf_width, int sentinel, float* node_bmin,
                   float* node_bmax, int32_t* left, int32_t* right,
                   int32_t* leaf_row, int32_t* leaf_prims,
                   int* out_n_leaves) {
  BuildCtx ctx;
  ctx.bmin = bmin;
  ctx.bmax = bmax;
  ctx.order = order;
  ctx.codes = sorted_codes;
  ctx.leaf_width = leaf_width;
  ctx.sentinel = sentinel;
  ctx.node_bmin = node_bmin;
  ctx.node_bmax = node_bmax;
  ctx.left = left;
  ctx.right = right;
  ctx.leaf_row = leaf_row;
  ctx.leaf_prims = leaf_prims;
  const int root = ctx.new_node();
  ctx.build(root, 0, n);
  *out_n_leaves = ctx.n_leaves;
  return ctx.n_nodes;
}

// Binned-SAH build over primitive boxes, accel/bvh.py's build_sah_bvh.
// Outputs sized as rtx_lbvh_build's. Returns n_nodes; writes n_leaves via
// out_n_leaves.
int rtx_sah_build(const float* bmin, const float* bmax, int n, int leaf_width,
                  int sentinel, float* node_bmin, float* node_bmax,
                  int32_t* left, int32_t* right, int32_t* leaf_row,
                  int32_t* leaf_prims, int* out_n_leaves) {
  SahCtx ctx;
  ctx.bmin = bmin;
  ctx.bmax = bmax;
  ctx.cent.resize(3 * (size_t)n);
  for (size_t i = 0; i < 3 * (size_t)n; ++i)
    ctx.cent[i] = ((double)bmin[i] + (double)bmax[i]) * 0.5;
  ctx.perm.resize(n);
  ctx.scratch.resize(n);
  for (int i = 0; i < n; ++i) ctx.perm[i] = i;
  ctx.leaf_width = leaf_width;
  ctx.sentinel = sentinel;
  ctx.node_bmin = node_bmin;
  ctx.node_bmax = node_bmax;
  ctx.left = left;
  ctx.right = right;
  ctx.leaf_row = leaf_row;
  ctx.leaf_prims = leaf_prims;
  ctx.build(n);
  *out_n_leaves = ctx.n_leaves;
  return ctx.n_nodes;
}

}  // extern "C"
