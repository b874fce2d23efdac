// Fast multi-view track building from dense pairwise matches.
//
// Host-side component of patch2pix_tpu_torch (the card computes matches;
// the host merges millions of match endpoints into tracks). Same
// semantics as patch2pix_tpu_torch/sfm/tracks.py::build_tracks —
// quantize endpoints to per-image grid cells, union-find nodes
// connected by matches, emit per-(track, image) mean coordinates.
// Conflict policy is observation-level: an image observed in two
// different cells of one component has ONLY that image's observations
// dropped (an outlier edge merging two real tracks, or a point
// straddling a cell boundary); the track survives if min_track_len
// distinct images remain. Dropping the whole track made outlier
// contamination collapse scene-scale reconstruction (every large
// component carries some outlier edge). The Python implementation is
// the reference; this one is the default path.
//
// C ABI only (loaded via ctypes, built by native/__init__.py with g++).

#include <cstdint>
#include <cstdlib>
#include <cmath>
#include <unordered_map>
#include <vector>

namespace {

struct NodeData {
  double sx = 0.0, sy = 0.0;
  int64_t cnt = 0;
  int32_t im = 0;
};

struct UnionFind {
  // image-conflict-aware union-find (mirrors sfm/tracks.py): a union
  // that would give a component two different cells in one image is
  // rejected — the edge is treated as an outlier. `images[root]` maps
  // image id -> node id for the component, merged small-to-large.
  std::vector<int32_t> parent;
  std::vector<std::unordered_map<int32_t, int32_t>> images;

  int32_t make(int32_t im) {
    const int32_t id = (int32_t)parent.size();
    parent.push_back(id);
    images.emplace_back();
    images.back().emplace(im, id);
    return id;
  }
  int32_t find(int32_t x) {
    int32_t root = x;
    while (parent[root] != root) root = parent[root];
    while (parent[x] != root) {
      int32_t next = parent[x];
      parent[x] = root;
      x = next;
    }
    return root;
  }
  bool unite(int32_t a, int32_t b) {
    a = find(a);
    b = find(b);
    if (a == b) return true;
    auto* ia = &images[(size_t)a];
    auto* ib = &images[(size_t)b];
    if (ib->size() > ia->size()) {  // small-to-large
      std::swap(a, b);
      std::swap(ia, ib);
    }
    for (auto& kv : *ib) {
      auto it = ia->find(kv.first);
      if (it != ia->end() && it->second != kv.second) return false;
    }
    for (auto& kv : *ib) ia->emplace(kv.first, kv.second);
    parent[b] = a;
    ib->clear();
    return true;
  }
};

inline int64_t cell_key(int32_t im, double x, double y, double cell) {
  const int64_t cx = (int64_t)std::floor(x / cell);
  const int64_t cy = (int64_t)std::floor(y / cell);
  // images < 2^20, cells in [-2^21, 2^21)
  return ((int64_t)im << 44) ^ ((cx & 0x3FFFFF) << 22) ^ (cy & 0x3FFFFF);
}

}  // namespace

extern "C" {

// Inputs: per-match image ids and (x1, y1, x2, y2) coordinates.
// Outputs (malloc'd; caller frees via p2p_free): one row per
// (track, image) observation: track id, image id, mean x, mean y.
// Returns the number of rows, or -1 on allocation failure.
int64_t p2p_build_tracks(const int32_t* im1, const int32_t* im2,
                         const double* matches, int64_t n_matches,
                         double cell, int32_t min_track_len,
                         int64_t** out_track, int32_t** out_im,
                         double** out_xy) {
  std::unordered_map<int64_t, int32_t> node_of;
  node_of.reserve((size_t)(2 * n_matches));
  UnionFind uf;
  std::vector<NodeData> data;

  auto get_node = [&](int32_t im, double x, double y) -> int32_t {
    const int64_t key = cell_key(im, x, y, cell);
    auto it = node_of.find(key);
    if (it != node_of.end()) return it->second;
    const int32_t id = uf.make(im);
    node_of.emplace(key, id);
    data.push_back(NodeData{});
    data.back().im = im;
    return id;
  };

  for (int64_t i = 0; i < n_matches; ++i) {
    const double x1 = matches[4 * i], y1 = matches[4 * i + 1];
    const double x2 = matches[4 * i + 2], y2 = matches[4 * i + 3];
    const int32_t n1 = get_node(im1[i], x1, y1);
    const int32_t n2 = get_node(im2[i], x2, y2);
    if (!uf.unite(n1, n2)) continue;  // rejected outlier edge
    data[n1].sx += x1;
    data[n1].sy += y1;
    data[n1].cnt += 1;
    data[n2].sx += x2;
    data[n2].sy += y2;
    data[n2].cnt += 1;
  }

  const int32_t n_nodes = (int32_t)data.size();
  // group nodes by root
  std::unordered_map<int32_t, std::vector<int32_t>> groups;
  groups.reserve((size_t)n_nodes);
  for (int32_t v = 0; v < n_nodes; ++v) groups[uf.find(v)].push_back(v);

  std::vector<int64_t> t_out;
  std::vector<int32_t> im_out;
  std::vector<double> xy_out;
  int64_t track_id = 0;
  std::unordered_map<int32_t, int32_t> ims_seen;
  for (auto& kv : groups) {
    auto& nodes = kv.second;
    ims_seen.clear();
    for (int32_t v : nodes)
      if (data[v].cnt > 0) ++ims_seen[data[v].im];
    // belt-and-braces observation-level conflict resolution (the
    // conflict-aware union keeps components image-consistent already)
    int32_t n_ok = 0;
    for (auto& ic : ims_seen)
      if (ic.second == 1) ++n_ok;
    if (n_ok < min_track_len) continue;
    for (int32_t v : nodes) {
      if (data[v].cnt == 0 || ims_seen[data[v].im] != 1) continue;
      t_out.push_back(track_id);
      im_out.push_back(data[v].im);
      xy_out.push_back(data[v].sx / (double)data[v].cnt);
      xy_out.push_back(data[v].sy / (double)data[v].cnt);
    }
    ++track_id;
  }

  const int64_t rows = (int64_t)t_out.size();
  *out_track = (int64_t*)std::malloc(sizeof(int64_t) * (size_t)rows);
  *out_im = (int32_t*)std::malloc(sizeof(int32_t) * (size_t)rows);
  *out_xy = (double*)std::malloc(sizeof(double) * (size_t)(2 * rows));
  if (rows && (!*out_track || !*out_im || !*out_xy)) return -1;
  for (int64_t i = 0; i < rows; ++i) {
    (*out_track)[i] = t_out[(size_t)i];
    (*out_im)[i] = im_out[(size_t)i];
    (*out_xy)[2 * i] = xy_out[(size_t)(2 * i)];
    (*out_xy)[2 * i + 1] = xy_out[(size_t)(2 * i + 1)];
  }
  return rows;
}

void p2p_free(void* p) { std::free(p); }

}  // extern "C"
