// Native carve plane: wrapped-torus host-block carving for gang placement.
//
// C++ twin of topology/carve.py's carve search — the
// per-gang hot spot once torus placement is on (every pending gang scans
// every eligible slice's free-host grid). Same Mask/bitmask discipline as
// placement.cc, extended with per-axis wraparound: blocks may cross the
// torus seam, a full-ring carve doubles its bisection cut, and the
// exposed-free-surface corner heuristic is wrap-aware. Results are
// bit-identical to the Python reference — identical all-integer candidate
// key (-bisection_links, exposure, compactness, bz, by, bx, oz, oy, ox),
// which tests/test_torus_carve.py's three-way parity fuzz verifies.
// Exposed through a C ABI for ctypes (topology/carvenative.py) behind a
// yoda_carve_abi() handshake so a stale library degrades this kernel only.
//
// Build: utils/nativeloader.py, at first use (g++ -O2 -std=c++17 -shared -fPIC)

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int kMaxWords = 64;  // up to 4096 hosts per slice grid
constexpr int64_t kCarveAbi = 1;

struct Mask {
  uint64_t w[kMaxWords];
  int words;
  void clear(int n_words) {
    words = n_words;
    std::memset(w, 0, sizeof(uint64_t) * words);
  }
  void set(int bit) { w[bit >> 6] |= (uint64_t{1} << (bit & 63)); }
  bool test(int bit) const {
    return (w[bit >> 6] >> (bit & 63)) & 1;
  }
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

// block cells with per-axis modular wrap (carve._block_coords)
void block_mask(const Shape& grid, int ox, int oy, int oz, const Shape& b,
                Mask* out) {
  out->clear((grid.volume() + 63) / 64);
  for (int dz = 0; dz < b.z; ++dz)
    for (int dy = 0; dy < b.y; ++dy)
      for (int dx = 0; dx < b.x; ++dx)
        out->set(bit_index(grid, (ox + dx) % grid.x, (oy + dy) % grid.y,
                           (oz + dz) % grid.z));
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

// carve.bisection_links: narrowest cut through the block, wrap-doubled
// when the block spans a wrapped axis's full ring
int bisection_links(const Shape& b, const Shape& grid, const bool wrap[3]) {
  int vol = b.volume();
  int dims[3] = {b.x, b.y, b.z};
  int gdims[3] = {grid.x, grid.y, grid.z};
  int best = 0;
  for (int a = 0; a < 3; ++a) {
    if (dims[a] <= 1) continue;
    int cross = vol / dims[a];
    if (wrap[a] && dims[a] == gdims[a]) cross *= 2;
    if (best == 0 || cross < best) best = cross;
  }
  return best;
}

// carve._exposure: free cells adjacent to block faces, outside the block —
// wrap-aware; flat axes expose nothing past the grid boundary
int exposure(const Shape& grid, const Mask& free, const Mask& bm,
             const bool wrap[3]) {
  int gdims[3] = {grid.x, grid.y, grid.z};
  int exp = 0;
  for (int z = 0; z < grid.z; ++z)
    for (int y = 0; y < grid.y; ++y)
      for (int x = 0; x < grid.x; ++x) {
        if (!bm.test(bit_index(grid, x, y, z))) continue;
        for (int a = 0; a < 3; ++a)
          for (int d = -1; d <= 1; d += 2) {
            int n[3] = {x, y, z};
            n[a] += d;
            if (wrap[a]) {
              n[a] = ((n[a] % gdims[a]) + gdims[a]) % gdims[a];
            } else if (n[a] < 0 || n[a] >= gdims[a]) {
              continue;
            }
            int nb = bit_index(grid, n[0], n[1], n[2]);
            if (bm.test(nb)) continue;
            if (free.test(nb)) ++exp;
          }
      }
  return exp;
}

// carve._key: all-integer total order — neg bisection links, exposure,
// compactness, then shape dims and origin for uniqueness
struct Key {
  int neg_links, exposure, compactness;
  int bz, by, bx, oz, oy, ox;
  bool operator<(const Key& o) const {
    if (neg_links != o.neg_links) return neg_links < o.neg_links;
    if (exposure != o.exposure) return exposure < o.exposure;
    if (compactness != o.compactness) return compactness < o.compactness;
    if (bz != o.bz) return bz < o.bz;
    if (by != o.by) return by < o.by;
    if (bx != o.bx) return bx < o.bx;
    if (oz != o.oz) return oz < o.oz;
    if (oy != o.oy) return oy < o.oy;
    return ox < o.ox;
  }
};

// carve._origins: full-span block = one placement; wrapped axis admits
// seam-crossing origins; flat axis only in-bounds origins
inline int origin_limit(int dim, int b, bool wrapped) {
  if (b == dim) return 1;
  if (wrapped) return dim;
  return dim - b + 1;
}

bool load_free(const Shape& grid, const int32_t* coords, int n_free,
               Mask* out) {
  if (grid.x <= 0 || grid.y <= 0 || grid.z <= 0) return false;
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

int64_t yoda_carve_abi() { return kCarveAbi; }

// best carve of n_hosts free hosts: 1 found, 0 none, -1 bad input
int yoda_carve(const int32_t grid_shape[3], const int32_t wrap_in[3],
               const int32_t* free_coords, int32_t n_free, int32_t n_hosts,
               int32_t out_origin[3], int32_t out_shape[3],
               int32_t* out_links) {
  Shape grid{grid_shape[0], grid_shape[1], grid_shape[2]};
  Mask free;
  if (!load_free(grid, free_coords, n_free, &free)) return -1;
  if (n_hosts <= 0 || n_hosts > grid.volume()) return -1;
  bool wrap[3] = {wrap_in[0] != 0, wrap_in[1] != 0, wrap_in[2] != 0};
  std::vector<Shape> shapes;
  factor_shapes(n_hosts, &shapes);
  bool found = false;
  Key best{};
  Shape best_b{};
  int best_o[3] = {0, 0, 0};
  Mask bm;
  for (const Shape& b : shapes) {
    if (b.x > grid.x || b.y > grid.y || b.z > grid.z) continue;
    int lz = origin_limit(grid.z, b.z, wrap[2]);
    int ly = origin_limit(grid.y, b.y, wrap[1]);
    int lx = origin_limit(grid.x, b.x, wrap[0]);
    for (int oz = 0; oz < lz; ++oz)
      for (int oy = 0; oy < ly; ++oy)
        for (int ox = 0; ox < lx; ++ox) {
          block_mask(grid, ox, oy, oz, b, &bm);
          if (!bm.subset_of(free)) continue;
          Key k{-bisection_links(b, grid, wrap),
                exposure(grid, free, bm, wrap),
                b.x + b.y + b.z,
                b.z, b.y, b.x, oz, oy, ox};
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
  if (!found) return 0;
  out_origin[0] = best_o[0];
  out_origin[1] = best_o[1];
  out_origin[2] = best_o[2];
  out_shape[0] = best_b.x;
  out_shape[1] = best_b.y;
  out_shape[2] = best_b.z;
  if (out_links) *out_links = -best.neg_links;
  return 1;
}

// carve.largest_carvable: volume of the largest feasible whole block;
// -1 on bad input
int yoda_largest_carvable(const int32_t grid_shape[3],
                          const int32_t wrap_in[3],
                          const int32_t* free_coords, int32_t n_free) {
  Shape grid{grid_shape[0], grid_shape[1], grid_shape[2]};
  Mask free;
  if (!load_free(grid, free_coords, n_free, &free)) return -1;
  bool wrap[3] = {wrap_in[0] != 0, wrap_in[1] != 0, wrap_in[2] != 0};
  int max_n = free.count();
  Mask bm;
  std::vector<Shape> shapes;
  for (int n = max_n; n >= 1; --n) {
    factor_shapes(n, &shapes);
    for (const Shape& b : shapes) {
      if (b.x > grid.x || b.y > grid.y || b.z > grid.z) continue;
      int lz = origin_limit(grid.z, b.z, wrap[2]);
      int ly = origin_limit(grid.y, b.y, wrap[1]);
      int lx = origin_limit(grid.x, b.x, wrap[0]);
      for (int oz = 0; oz < lz; ++oz)
        for (int oy = 0; oy < ly; ++oy)
          for (int ox = 0; ox < lx; ++ox) {
            block_mask(grid, ox, oy, oz, b, &bm);
            if (bm.subset_of(free)) return n;
          }
    }
  }
  return 0;
}

}  // extern "C"
