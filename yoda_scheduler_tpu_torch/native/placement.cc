// Native placement engine: ICI-torus sub-block search over bitmasks.
//
// C++ twin of topology/torus.py's placement search —
// the scheduler's per-cycle hot spot. Python memoises repeated queries; this
// library makes the cache-miss path ~100x cheaper by representing chip sets
// as 64-bit word bitmasks (subset test = AND+compare per word) instead of
// Python frozensets. Exposed through a C ABI for ctypes
// (topology/native.py); results are bit-identical to the
// Python implementation (same tie-break keys: fragmentation, compactness,
// low-corner origin), which the parity tests in tests/test_native.py verify.
//
// Build: utils/nativeloader.py, at first use (g++ -O2 -std=c++17 -shared -fPIC)

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxWords = 64;  // up to 4096 chips per slice

struct Mask {
  uint64_t w[kMaxWords];
  int words;
  void clear(int n_words) {
    words = n_words;
    std::memset(w, 0, sizeof(uint64_t) * words);
  }
  void set(int bit) { w[bit >> 6] |= (uint64_t{1} << (bit & 63)); }
  bool subset_of(const Mask& o) const {
    for (int i = 0; i < words; ++i)
      if (w[i] & ~o.w[i]) return false;
    return true;
  }
  int count() const {
    int c = 0;
    for (int i = 0; i < words; ++i) c += __builtin_popcountll(w[i]);
    return c;
  }
};

struct Shape {
  int x, y, z;
  int volume() const { return x * y * z; }
};

inline int bit_index(const Shape& grid, int x, int y, int z) {
  return x + grid.x * (y + grid.y * z);
}

void block_mask(const Shape& grid, int ox, int oy, int oz, const Shape& b,
                Mask* out) {
  out->clear((grid.volume() + 63) / 64);
  for (int dz = 0; dz < b.z; ++dz)
    for (int dy = 0; dy < b.y; ++dy)
      for (int dx = 0; dx < b.x; ++dx)
        out->set(bit_index(grid, ox + dx, oy + dy, oz + dz));
}

// all (x,y,z) with x*y*z == n, x ascending then y (torus._factor_shapes order)
void factor_shapes(int n, std::vector<Shape>* out) {
  out->clear();
  for (int x = 1; x <= n; ++x) {
    if (n % x) continue;
    int rem = n / x;
    for (int y = 1; y <= rem; ++y) {
      if (rem % y) continue;
      out->push_back({x, y, rem / y});
    }
  }
}

int largest_free_block(const Shape& grid, const Mask& free) {
  int max_n = free.count();
  if (max_n == 0) return 0;
  // all in-grid block shapes with volume <= |free|, sorted by volume
  // descending — first placeable shape IS the largest block (equivalent to
  // the per-n factor-shape scan, without re-deriving factors per n)
  std::vector<Shape> shapes;
  for (int bx = 1; bx <= grid.x; ++bx)
    for (int by = 1; by <= grid.y; ++by)
      for (int bz = 1; bz <= grid.z; ++bz)
        if (bx * by * bz <= max_n) shapes.push_back({bx, by, bz});
  std::sort(shapes.begin(), shapes.end(), [](const Shape& a, const Shape& b) {
    return a.volume() > b.volume();
  });
  Mask bm;
  for (const Shape& b : shapes) {
    for (int ox = 0; ox + b.x <= grid.x; ++ox)
      for (int oy = 0; oy + b.y <= grid.y; ++oy)
        for (int oz = 0; oz + b.z <= grid.z; ++oz) {
          block_mask(grid, ox, oy, oz, b, &bm);
          if (bm.subset_of(free)) return b.volume();
        }
  }
  return 1;
}

double fragmentation_after(const Shape& grid, const Mask& remaining) {
  int n = remaining.count();
  if (n == 0) return 0.0;
  return 1.0 - double(largest_free_block(grid, remaining)) / double(n);
}

struct Key {
  double frag;
  int compactness;
  int oz, oy, ox;
  bool operator<(const Key& o) const {
    if (frag != o.frag) return frag < o.frag;
    if (compactness != o.compactness) return compactness < o.compactness;
    if (oz != o.oz) return oz < o.oz;
    if (oy != o.oy) return oy < o.oy;
    return ox < o.ox;
  }
};

// shared search core; candidates supplied by caller (factor shapes or
// explicit permutations)
bool best_placement(const Shape& grid, const Mask& free,
                    const std::vector<Shape>& candidates, int32_t* out_origin,
                    int32_t* out_shape, double* out_frag) {
  bool found = false;
  Key best{};
  Shape best_b{};
  int best_o[3] = {0, 0, 0};
  Mask bm, rem;
  for (const Shape& b : candidates) {
    if (b.x > grid.x || b.y > grid.y || b.z > grid.z) continue;
    for (int ox = 0; ox + b.x <= grid.x; ++ox)
      for (int oy = 0; oy + b.y <= grid.y; ++oy)
        for (int oz = 0; oz + b.z <= grid.z; ++oz) {
          block_mask(grid, ox, oy, oz, b, &bm);
          if (!bm.subset_of(free)) continue;
          rem.words = free.words;
          for (int i = 0; i < free.words; ++i) rem.w[i] = free.w[i] & ~bm.w[i];
          Key k{fragmentation_after(grid, rem), b.x + b.y + b.z, oz, oy, ox};
          if (!found || k < best) {
            found = true;
            best = k;
            best_b = b;
            best_o[0] = ox;
            best_o[1] = oy;
            best_o[2] = oz;
          }
        }
  }
  if (!found) return false;
  out_origin[0] = best_o[0];
  out_origin[1] = best_o[1];
  out_origin[2] = best_o[2];
  out_shape[0] = best_b.x;
  out_shape[1] = best_b.y;
  out_shape[2] = best_b.z;
  if (out_frag) *out_frag = best.frag;
  return true;
}

bool load_free(const Shape& grid, const int32_t* coords, int n_free,
               Mask* out) {
  if (grid.volume() > kMaxWords * 64) return false;
  out->clear((grid.volume() + 63) / 64);
  for (int i = 0; i < n_free; ++i) {
    int x = coords[i * 3], y = coords[i * 3 + 1], z = coords[i * 3 + 2];
    if (x < 0 || y < 0 || z < 0 || x >= grid.x || y >= grid.y || z >= grid.z)
      return false;
    out->set(bit_index(grid, x, y, z));
  }
  return true;
}

}  // namespace

extern "C" {

// returns 1 on fit, 0 no fit, -1 bad input
int yoda_best_fit(const int32_t grid_shape[3], const int32_t* free_coords,
                  int32_t n_free, int32_t n_chips, int32_t out_origin[3],
                  int32_t out_shape[3]) {
  Shape grid{grid_shape[0], grid_shape[1], grid_shape[2]};
  Mask free;
  if (!load_free(grid, free_coords, n_free, &free)) return -1;
  std::vector<Shape> candidates;
  factor_shapes(n_chips, &candidates);
  return best_placement(grid, free, candidates, out_origin, out_shape, nullptr)
             ? 1
             : 0;
}

int yoda_fits_shape(const int32_t grid_shape[3], const int32_t* free_coords,
                    int32_t n_free, const int32_t req_shape[3],
                    int32_t out_origin[3], int32_t out_shape[3]) {
  Shape grid{grid_shape[0], grid_shape[1], grid_shape[2]};
  Mask free;
  if (!load_free(grid, free_coords, n_free, &free)) return -1;
  // unique permutations in sorted order (matches torus.fits_shape)
  int d[3] = {req_shape[0], req_shape[1], req_shape[2]};
  std::vector<Shape> perms;
  int idx[6][3] = {{0, 1, 2}, {0, 2, 1}, {1, 0, 2},
                   {1, 2, 0}, {2, 0, 1}, {2, 1, 0}};
  for (auto& p : idx) {
    Shape s{d[p[0]], d[p[1]], d[p[2]]};
    bool dup = false;
    for (const Shape& q : perms)
      if (q.x == s.x && q.y == s.y && q.z == s.z) dup = true;
    if (!dup) perms.push_back(s);
  }
  // sorted order
  for (size_t i = 0; i < perms.size(); ++i)
    for (size_t j = i + 1; j < perms.size(); ++j) {
      auto less = [](const Shape& a, const Shape& b) {
        if (a.x != b.x) return a.x < b.x;
        if (a.y != b.y) return a.y < b.y;
        return a.z < b.z;
      };
      if (less(perms[j], perms[i])) std::swap(perms[i], perms[j]);
    }
  return best_placement(grid, free, perms, out_origin, out_shape, nullptr) ? 1
                                                                           : 0;
}

int yoda_largest_free_block(const int32_t grid_shape[3],
                            const int32_t* free_coords, int32_t n_free) {
  Shape grid{grid_shape[0], grid_shape[1], grid_shape[2]};
  Mask free;
  if (!load_free(grid, free_coords, n_free, &free)) return -1;
  return largest_free_block(grid, free);
}

// contiguity score 0..100 (torus.contiguity_score); -1 on bad input
double yoda_contiguity(const int32_t grid_shape[3], const int32_t* free_coords,
                       int32_t n_free, int32_t n_chips) {
  Shape grid{grid_shape[0], grid_shape[1], grid_shape[2]};
  Mask free;
  if (!load_free(grid, free_coords, n_free, &free)) return -1.0;
  std::vector<Shape> candidates;
  factor_shapes(n_chips, &candidates);
  int32_t origin[3], shape_out[3];
  double frag;
  if (!best_placement(grid, free, candidates, origin, shape_out, &frag))
    return 0.0;
  return 100.0 * (1.0 - frag);
}

}  // extern "C"
