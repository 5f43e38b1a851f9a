// Host geometry of the PyTorch port: Morton codes, a u64 radix argsort and
// the recursive LBVH build over Morton-sorted primitives.
//
// The port's own copy of the JAX package's native/geometry.cpp, the same
// code under the same C ABI: accel/bvh.py builds the same arrays with it
// as with its NumPy build, bit for bit, about 100x faster on the 70k-
// triangle mesh. Loaded with ctypes by utils/native.py.
//
// Build (kernels/build.py, at first use): g++ -O3 -shared -fPIC, the JAX
// package's flags. No -march=native and no -ffast-math: the quantisation
// (v - lo) * inv_extent must round as NumPy's float32 arithmetic does.

#include <algorithm>
#include <cstdint>
#include <cstring>
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

}  // extern "C"
