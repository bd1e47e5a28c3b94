// Native BVH builder: C ABI shared library, loaded via ctypes.
//
// The host-runtime half of the framework's ingest path (the analog of the
// reference engine's native asset pipeline — its entire runtime is C++;
// SURVEY.md section 2 asks for the framework's runtime components to be
// native too).  Produces EXACTLY the layout of accel/bvh.py::build_bvh
// (Morton-presorted largest-axis median splits, contiguous multi-triangle
// leaves over a reordered triangle array) so the Python and C++ builders
// are interchangeable; accel/native.py verifies this equivalence in tests.
//
// Build: make -C native   (g++ -O3 -march=native -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

struct Vec3 {
  float x, y, z;
};

inline Vec3 vmin(const Vec3& a, const Vec3& b) {
  return {std::min(a.x, b.x), std::min(a.y, b.y), std::min(a.z, b.z)};
}
inline Vec3 vmax(const Vec3& a, const Vec3& b) {
  return {std::max(a.x, b.x), std::max(a.y, b.y), std::max(a.z, b.z)};
}

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

struct Range {
  int32_t node;
  int64_t start, end;
};

}  // namespace

extern "C" {

// Returns the number of nodes written, or -1 on invalid input.
// Output arrays must have capacity for 2*ceil(n_tris/1)+1 nodes
// (node_min/node_max: 3 floats per node).
int64_t pbr_build_bvh(const float* positions, int64_t n_verts,
                      const int32_t* indices, int64_t n_tris, int leaf_size,
                      float* node_min, float* node_max, int32_t* node_left,
                      int32_t* node_right, int32_t* tri_order) {
  if (n_tris <= 0 || leaf_size < 1) return -1;
  const Vec3* pos = reinterpret_cast<const Vec3*>(positions);

  std::vector<Vec3> centroid(n_tris), tmin(n_tris), tmax(n_tris);
  Vec3 clo = {1e30f, 1e30f, 1e30f}, chi = {-1e30f, -1e30f, -1e30f};
  for (int64_t t = 0; t < n_tris; ++t) {
    const int32_t* tri = indices + 3 * t;
    if (tri[0] >= n_verts || tri[1] >= n_verts || tri[2] >= n_verts)
      return -1;
    Vec3 a = pos[tri[0]], b = pos[tri[1]], c = pos[tri[2]];
    centroid[t] = {(a.x + b.x + c.x) / 3.0f, (a.y + b.y + c.y) / 3.0f,
                   (a.z + b.z + c.z) / 3.0f};
    tmin[t] = vmin(vmin(a, b), c);
    tmax[t] = vmax(vmax(a, b), c);
    clo = vmin(clo, centroid[t]);
    chi = vmax(chi, centroid[t]);
  }

  // Morton presort of triangle ids by quantized centroid.
  Vec3 ext = {std::max(chi.x - clo.x, 1e-12f),
              std::max(chi.y - clo.y, 1e-12f),
              std::max(chi.z - clo.z, 1e-12f)};
  std::vector<std::pair<uint64_t, int32_t>> keyed(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) {
    uint32_t qx = (uint32_t)((centroid[t].x - clo.x) / ext.x * 1023.0f);
    uint32_t qy = (uint32_t)((centroid[t].y - clo.y) / ext.y * 1023.0f);
    uint32_t qz = (uint32_t)((centroid[t].z - clo.z) / ext.z * 1023.0f);
    keyed[t] = {morton3(qx, qy, qz), (int32_t)t};
  }
  std::stable_sort(keyed.begin(), keyed.end(),
                   [](const auto& a, const auto& b) {
                     return a.first < b.first;
                   });
  std::vector<int32_t> order(n_tris);
  for (int64_t t = 0; t < n_tris; ++t) order[t] = keyed[t].second;

  // Iterative top-down median split (matches accel/bvh.py: LIFO stack with
  // the right child pushed first, then left — children popped left-first).
  int64_t n_nodes = 0;
  int64_t out_pos = 0;
  auto new_node = [&]() -> int32_t { return (int32_t)n_nodes++; };

  std::vector<Range> stack;
  stack.reserve(128);
  stack.push_back({new_node(), 0, n_tris});
  while (!stack.empty()) {
    Range r = stack.back();
    stack.pop_back();
    Vec3 blo = {1e30f, 1e30f, 1e30f}, bhi = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = r.start; i < r.end; ++i) {
      blo = vmin(blo, tmin[order[i]]);
      bhi = vmax(bhi, tmax[order[i]]);
    }
    std::memcpy(node_min + 3 * r.node, &blo, 12);
    std::memcpy(node_max + 3 * r.node, &bhi, 12);
    int64_t count = r.end - r.start;
    if (count <= leaf_size) {
      node_left[r.node] = (int32_t)(-(out_pos + 1));
      node_right[r.node] = (int32_t)count;
      std::memcpy(tri_order + out_pos, order.data() + r.start,
                  count * sizeof(int32_t));
      out_pos += count;
      continue;
    }
    // split at median of the largest centroid axis
    Vec3 cmin = {1e30f, 1e30f, 1e30f}, cmax = {-1e30f, -1e30f, -1e30f};
    for (int64_t i = r.start; i < r.end; ++i) {
      cmin = vmin(cmin, centroid[order[i]]);
      cmax = vmax(cmax, centroid[order[i]]);
    }
    float dx = cmax.x - cmin.x, dy = cmax.y - cmin.y, dz = cmax.z - cmin.z;
    int axis = (dx >= dy && dx >= dz) ? 0 : (dy >= dz ? 1 : 2);
    int64_t mid = r.start + count / 2;
    // stable full sort (matches numpy argsort(kind="stable") bit-exactly)
    std::stable_sort(order.begin() + r.start, order.begin() + r.end,
                     [&](int32_t a, int32_t b) {
                       const float* ca = &centroid[a].x;
                       const float* cb = &centroid[b].x;
                       return ca[axis] < cb[axis];
                     });
    int32_t left = new_node();
    int32_t right = new_node();
    node_left[r.node] = left;
    node_right[r.node] = right;
    stack.push_back({right, mid, r.end});
    stack.push_back({left, r.start, mid});
  }
  return n_nodes;
}

// Cluster build on top of the BVH leaves (accel/clusters.py layout):
// writes per-cluster AABBs and padded tri-id blocks. Returns cluster count.
int64_t pbr_build_clusters(const float* positions, int64_t n_verts,
                           const int32_t* indices, int64_t n_tris, int k,
                           float* aabb_min, float* aabb_max,
                           int32_t* tri_id /* capacity ceil? * k */) {
  int64_t cap_nodes = 2 * n_tris + 1;
  std::vector<float> nmin(cap_nodes * 3), nmax(cap_nodes * 3);
  std::vector<int32_t> nl(cap_nodes), nr(cap_nodes), order(n_tris);
  int64_t n_nodes =
      pbr_build_bvh(positions, n_verts, indices, n_tris, k, nmin.data(),
                    nmax.data(), nl.data(), nr.data(), order.data());
  if (n_nodes < 0) return -1;
  int64_t c = 0;
  for (int64_t nid = 0; nid < n_nodes; ++nid) {
    if (nl[nid] >= 0) continue;
    int64_t start = -(int64_t)nl[nid] - 1;
    int32_t count = nr[nid];
    std::memcpy(aabb_min + 3 * c, nmin.data() + 3 * nid, 12);
    std::memcpy(aabb_max + 3 * c, nmax.data() + 3 * nid, 12);
    for (int i = 0; i < k; ++i)
      tri_id[c * k + i] = (i < count) ? order[start + i] : -1;
    ++c;
  }
  return c;
}

// Walker/Vose alias table over a discrete distribution p[n] (sums to ~1).
// Writes prob[n] (acceptance thresholds) and alias[n].  O(n) with two
// index stacks — the ingest-time path for multi-megatexel HDR environment
// maps, where the Python fallback's per-texel loop is a multi-second
// stall (scene/types.py::_build_alias_table).  Returns 0, or -1 on bad n.
int64_t pbr_build_alias(const double* p, int64_t n, float* prob,
                        int32_t* alias) {
  if (n <= 0) return -1;
  std::vector<double> scaled(n);
  for (int64_t i = 0; i < n; ++i) scaled[i] = p[i] * (double)n;
  std::vector<int32_t> small, large;
  small.reserve(n);
  large.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    prob[i] = 1.0f;
    alias[i] = (int32_t)i;
    (scaled[i] < 1.0 ? small : large).push_back((int32_t)i);
  }
  while (!small.empty() && !large.empty()) {
    int32_t s = small.back();
    small.pop_back();
    int32_t l = large.back();
    large.pop_back();
    prob[s] = (float)scaled[s];
    alias[s] = l;
    scaled[l] -= 1.0 - scaled[s];
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  // Leftovers (float slop) keep prob = 1 (self-alias).
  return 0;
}

}  // extern "C"
