// Host-side map export for tpu3drec_torch: Morton-order octree construction
// with an octomap `.bt` serializer, and an ASCII PLY writer, each working on
// one flat buffer handed over from Python (ctypes; utils/native.py), with no
// per-point Python and no per-node allocation. A copy of the JAX package's
// library source, built by the port on its own (utils/native.py), never
// from or into the JAX package's directory.
//
// Format notes (mirrors tpu3drec_torch/mapping/btio.py, the Python path,
// whose bytes these must equal):
//   .bt payload = preorder node stream, 2 bytes/node, 2 bits/child:
//   00 none, 01 occupied leaf, 10 free leaf, 11 inner. Keys are
//   floor(coord/res) + 2^15 (depth-16 tree). Full 8^b subtrees prune to
//   one occupied leaf.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <iterator>
#include <string>
#include <vector>

namespace {

constexpr int kTreeDepth = 16;
constexpr int64_t kKeyOffset = 1 << 15;

inline uint64_t part1by2(uint64_t v) {
  v &= 0x1FFFFF;
  v = (v | (v << 32)) & 0x1F00000000FFFFULL;
  v = (v | (v << 16)) & 0x1F0000FF0000FFULL;
  v = (v | (v << 8)) & 0x100F00F00F00F00FULL;
  v = (v | (v << 4)) & 0x10C30C30C30C30C3ULL;
  v = (v | (v << 2)) & 0x1249249249249249ULL;
  return v;
}

inline uint64_t morton3(uint64_t x, uint64_t y, uint64_t z) {
  return part1by2(x) | (part1by2(y) << 1) | (part1by2(z) << 2);
}

struct Frame {
  size_t lo, hi;      // occupied-morton range
  size_t lo_f, hi_f;  // free-morton range
  int bit;            // child bit level
};

// Preorder DFS over sorted unique morton codes (occupied + optional free
// set) -> .bt payload + node count. A child subtree holding its full 8^b
// voxel complement of ONE label prunes to a single leaf of that label
// (octomap prune() semantics); mixed subtrees recurse as inner (0b11).
// Mirrors tpu3drec_torch/mapping/btio.py::_build_nodes.
int64_t build_nodes(const std::vector<uint64_t>& m,
                    const std::vector<uint64_t>& mf,
                    std::vector<uint8_t>* out) {
  if (m.empty() && mf.empty()) return 0;
  int64_t n_nodes = 1;  // root
  std::vector<Frame> stack;
  stack.push_back({0, m.size(), 0, mf.size(), kTreeDepth - 1});
  std::vector<Frame> children;
  children.reserve(8);
  while (!stack.empty()) {
    Frame f = stack.back();
    stack.pop_back();
    const uint64_t node_size = 1ULL << (3 * (f.bit + 1));
    const uint64_t child_size = 1ULL << (3 * f.bit);
    const uint64_t any_code = f.hi > f.lo ? m[f.lo] : mf[f.lo_f];
    const uint64_t start = any_code & ~(node_size - 1);
    uint8_t byte0 = 0, byte1 = 0;
    children.clear();
    size_t lo = f.lo, lo_f = f.lo_f;
    for (int i = 0; i < 8; ++i) {
      const uint64_t hi_code = start + child_size * (uint64_t)(i + 1);
      size_t hi = std::lower_bound(m.begin() + lo, m.begin() + f.hi, hi_code) -
                  m.begin();
      size_t hi_f = std::lower_bound(mf.begin() + lo_f, mf.begin() + f.hi_f,
                                     hi_code) -
                    mf.begin();
      const size_t co = hi - lo;
      const size_t cf = hi_f - lo_f;
      if (co || cf) {
        ++n_nodes;
        uint8_t bits;
        if (cf == 0 && co == child_size) {
          bits = 0b01;  // full occupied subtree -> occupied leaf
        } else if (co == 0 && cf == child_size) {
          bits = 0b10;  // full free subtree -> free leaf
        } else {
          bits = 0b11;
          children.push_back({lo, hi, lo_f, hi_f, f.bit - 1});
        }
        if (i < 4)
          byte0 |= bits << (2 * i);
        else
          byte1 |= bits << (2 * (i - 4));
      }
      lo = hi;
      lo_f = hi_f;
    }
    out->push_back(byte0);
    out->push_back(byte1);
    for (auto it = children.rbegin(); it != children.rend(); ++it)
      stack.push_back(*it);
  }
  return n_nodes;
}


// Python's repr of a finite double, so native and Python .bt headers are
// byte-identical: the shortest digits that round-trip, in fixed notation
// with at least one digit after the point when the decimal exponent is in
// [-4, 16), else as d[.ddd]e+XX.
static void shortest_double(double v, char* buf, size_t n) {
  char sci[40];
  for (int prec = 0; prec <= 16; ++prec) {
    std::snprintf(sci, sizeof(sci), "%.*e", prec, v);
    if (std::strtod(sci, nullptr) == v) break;
  }
  // sci: [-]d[.ddd]e[+-]XX
  const char* p = sci;
  std::string sign;
  if (*p == '-') {
    sign = "-";
    ++p;
  }
  std::string digits;
  for (; *p && *p != 'e'; ++p)
    if (*p != '.') digits.push_back(*p);
  int exp = std::atoi(p + 1);
  std::string out = sign;
  if (exp >= -4 && exp < 16) {
    if (exp < 0) {
      out += "0." + std::string((size_t)(-exp - 1), '0') + digits;
    } else if ((int)digits.size() <= exp + 1) {
      out += digits + std::string((size_t)(exp + 1 - (int)digits.size()), '0') + ".0";
    } else {
      out += digits.substr(0, (size_t)exp + 1) + "." + digits.substr((size_t)exp + 1);
    }
  } else {
    out += digits.substr(0, 1);
    if (digits.size() > 1) out += "." + digits.substr(1);
    char e[8];
    std::snprintf(e, sizeof(e), "e%c%02d", exp < 0 ? '-' : '+', exp < 0 ? -exp : exp);
    out += e;
  }
  std::snprintf(buf, n, "%s", out.c_str());
}

// Sorted unique morton codes from signed int32 voxel keys; returns false if
// any key leaves the depth-16 range.
bool keys_to_morton(const int32_t* keys, int64_t n, std::vector<uint64_t>* m) {
  m->reserve((size_t)n);
  for (int64_t i = 0; i < n; ++i) {
    int64_t kx = (int64_t)keys[3 * i + 0] + kKeyOffset;
    int64_t ky = (int64_t)keys[3 * i + 1] + kKeyOffset;
    int64_t kz = (int64_t)keys[3 * i + 2] + kKeyOffset;
    if ((uint64_t)kx > 0xFFFF || (uint64_t)ky > 0xFFFF || (uint64_t)kz > 0xFFFF)
      return false;
    m->push_back(morton3((uint64_t)kx, (uint64_t)ky, (uint64_t)kz));
  }
  std::sort(m->begin(), m->end());
  m->erase(std::unique(m->begin(), m->end()), m->end());
  return true;
}

int64_t write_bt_file(const char* path, const std::vector<uint8_t>& payload,
                      int64_t n_nodes, double res) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  char res_str[32];
  shortest_double(res, res_str, sizeof(res_str));
  std::fprintf(f,
               "# Octomap OcTree binary file\n"
               "# (feel free to add / change comments, but leave the first "
               "line as it is!)\n#\n"
               "id OcTree\nsize %lld\nres %s\ndata\n",
               (long long)n_nodes, res_str);
  if (!payload.empty())
    std::fwrite(payload.data(), 1, payload.size(), f);
  std::fclose(f);
  return n_nodes;
}

}  // namespace

extern "C" {

// Voxelize + dedup + build + write in one call.
// points: (n, 3) float32 world coordinates. Returns node count, or -1 on
// IO error, -2 if any key leaves the depth-16 range.
int64_t tpu3drec_bt_write_points(const char* path, const float* points,
                                 int64_t n, double res) {
  std::vector<uint64_t> m;
  m.reserve((size_t)n);
  const double inv = 1.0 / res;
  for (int64_t i = 0; i < n; ++i) {
    int64_t kx = (int64_t)std::floor(points[3 * i + 0] * inv) + kKeyOffset;
    int64_t ky = (int64_t)std::floor(points[3 * i + 1] * inv) + kKeyOffset;
    int64_t kz = (int64_t)std::floor(points[3 * i + 2] * inv) + kKeyOffset;
    if ((uint64_t)kx > 0xFFFF || (uint64_t)ky > 0xFFFF || (uint64_t)kz > 0xFFFF)
      return -2;
    m.push_back(morton3((uint64_t)kx, (uint64_t)ky, (uint64_t)kz));
  }
  std::sort(m.begin(), m.end());
  m.erase(std::unique(m.begin(), m.end()), m.end());

  std::vector<uint8_t> payload;
  payload.reserve(m.size() * 4);
  const std::vector<uint64_t> no_free;
  const int64_t n_nodes = build_nodes(m, no_free, &payload);
  return write_bt_file(path, payload, n_nodes, res);
}

// Signed int32 voxel keys (floor(p/res) convention) variant.
int64_t tpu3drec_bt_write_keys(const char* path, const int32_t* keys,
                               int64_t n, double res) {
  std::vector<uint64_t> m;
  if (!keys_to_morton(keys, n, &m)) return -2;
  std::vector<uint8_t> payload;
  payload.reserve(m.size() * 4);
  const std::vector<uint64_t> no_free;
  const int64_t n_nodes = build_nodes(m, no_free, &payload);
  return write_bt_file(path, payload, n_nodes, res);
}

// Occupied + carved-free variant (occupancy pipeline): free leaves encode
// 0b10 child codes (octomap writeBinaryNode). A key present in both sets is
// written occupied (callers dedup; occupied wins, matching log-odds fusion
// saturated at the clamp).
int64_t tpu3drec_bt_write_keys_free(const char* path, const int32_t* keys,
                                    int64_t n, const int32_t* free_keys,
                                    int64_t n_free, double res) {
  std::vector<uint64_t> m, mf;
  if (!keys_to_morton(keys, n, &m)) return -2;
  if (!keys_to_morton(free_keys, n_free, &mf)) return -2;
  if (!m.empty() && !mf.empty()) {
    // occupied wins: remove any free code that is also occupied
    std::vector<uint64_t> mf2;
    mf2.reserve(mf.size());
    std::set_difference(mf.begin(), mf.end(), m.begin(), m.end(),
                        std::back_inserter(mf2));
    mf.swap(mf2);
  }
  std::vector<uint8_t> payload;
  payload.reserve((m.size() + mf.size()) * 4);
  const int64_t n_nodes = build_nodes(m, mf, &payload);
  return write_bt_file(path, payload, n_nodes, res);
}

// Fast ASCII PLY writer: %.4f coordinates (reference float_formatter,
// `ref/transfer/camera_to_world.py:116`), optional uint8 RGB. Returns 0 ok.
int tpu3drec_ply_write_ascii(const char* path, const float* pts, int64_t n,
                             const uint8_t* rgb /* nullable */) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  // setvbuf must precede any other operation on the stream (C standard);
  // calling it after the first fprintf is UB even if glibc tolerates it.
  std::vector<char> buf(1 << 20);
  std::setvbuf(f, buf.data(), _IOFBF, buf.size());
  std::fprintf(f,
               "ply\nformat ascii 1.0\ncomment generated by tpu3drec\n"
               "element vertex %lld\n"
               "property float x\nproperty float y\nproperty float z\n",
               (long long)n);
  if (rgb)
    std::fprintf(f,
                 "property uchar red\nproperty uchar green\nproperty uchar "
                 "blue\n");
  std::fprintf(f, "end_header\n");
  for (int64_t i = 0; i < n; ++i) {
    if (rgb)
      std::fprintf(f, "%.4f %.4f %.4f %d %d %d\n", pts[3 * i], pts[3 * i + 1],
                   pts[3 * i + 2], rgb[3 * i], rgb[3 * i + 1], rgb[3 * i + 2]);
    else
      std::fprintf(f, "%.4f %.4f %.4f\n", pts[3 * i], pts[3 * i + 1],
                   pts[3 * i + 2]);
  }
  std::fclose(f);
  return 0;
}

}  // extern "C"
