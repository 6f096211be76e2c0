// The PyTorch port's copy of matrix_eyes_tpu/native/meshwriter.cpp, built by
// matrix_eyes_tpu_torch/native/__init__.py.
//
// Native OBJ mesh serializer.
//
// The OBJ ASCII path is the one output stage where Python is slow: a full
// 1536x1536 depth grid yields ~2.4M vertices and ~4.7M faces, and every
// float must be formatted as Rust's Display would (shortest round-trip
// decimal, positional notation, no trailing ".0"), which rules out printf.
// C++17 std::to_chars produces the same shortest-round-trip digits as
// Rust's Ryu; render_positional() converts its occasional scientific form
// to positional digits.
//
// Mirrors the reference's ObjWriter (output.rs:484-630): "v x y z [r g b]"
// (the caller already applied the (x,-y,-z) flip), optional "vt u v" block
// first, faces "f i j k" or "f i/i j/j k/k", 1-based.
//
// Exposed as a C ABI for ctypes; see meshwriter.py.

#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Format a double exactly like Rust's `{}` Display: shortest round-trip,
// always positional, "1" not "1.0", "-0" for negative zero.
size_t format_f64(double v, char* out) {
  // Non-finite values: match Rust Display ("NaN", "inf", "-inf") exactly,
  // like rust_format.format_f64 -- std::to_chars would emit "nan"/"inf"
  // with a lowercase n, diverging from the Python writer path.
  if (std::isnan(v)) { std::memcpy(out, "NaN", 3); return 3; }
  if (std::isinf(v)) {
    if (v < 0) { std::memcpy(out, "-inf", 4); return 4; }
    std::memcpy(out, "inf", 3); return 3;
  }
  char buf[64];
  auto res = std::to_chars(buf, buf + sizeof(buf), v);
  size_t n = res.ptr - buf;
  buf[n] = '\0';

  // find exponent part, if any
  char* e = nullptr;
  for (char* p = buf; *p; ++p) {
    if (*p == 'e' || *p == 'E') { e = p; break; }
  }
  if (!e) {
    // positional already; ensure no trailing ".0"? to_chars never emits
    // trailing ".0" for integral values (it prints "1" as "1"), so copy.
    std::memcpy(out, buf, n);
    return n;
  }
  int exp = std::atoi(e + 1);
  *e = '\0';
  char* mant = buf;
  bool neg = false;
  if (*mant == '-') { neg = true; ++mant; }
  std::string digits;
  int int_len = 0;
  for (char* p = mant; *p; ++p) {
    if (*p == '.') { int_len = (int)(p - mant); }
    else digits.push_back(*p);
  }
  if (int_len == 0) int_len = (int)std::strlen(mant);  // no dot
  int point = int_len + exp;

  std::string s;
  if (neg) s.push_back('-');
  if (point <= 0) {
    s += "0.";
    s.append(-point, '0');
    s += digits;
  } else if (point >= (int)digits.size()) {
    s += digits;
    s.append(point - digits.size(), '0');
  } else {
    s.append(digits, 0, point);
    s.push_back('.');
    s.append(digits, point, std::string::npos);
  }
  std::memcpy(out, s.data(), s.size());
  return s.size();
}

class BufWriter {
 public:
  explicit BufWriter(std::FILE* f) : f_(f) { buf_.reserve(kCap + 256); }
  ~BufWriter() { flush(); }
  void append(const char* data, size_t n) {
    buf_.append(data, n);
    if (buf_.size() >= kCap) flush();
  }
  void append(const char* s) { append(s, std::strlen(s)); }
  void append_f64(double v) {
    char tmp[512];
    size_t n = format_f64(v, tmp);
    append(tmp, n);
  }
  void append_int(long long v) {
    char tmp[32];
    auto res = std::to_chars(tmp, tmp + sizeof(tmp), v);
    append(tmp, res.ptr - tmp);
  }
  bool ok() const { return ok_; }
  void flush() {
    if (!buf_.empty()) {
      if (std::fwrite(buf_.data(), 1, buf_.size(), f_) != buf_.size()) ok_ = false;
      buf_.clear();
    }
  }

 private:
  static constexpr size_t kCap = 1 << 20;  // 1 MiB, like output.rs:383
  std::FILE* f_;
  std::string buf_;
  bool ok_ = true;
};

}  // namespace

extern "C" {

// Returns 0 on success, nonzero on failure.
int me_write_obj(const char* path,
                 const double* x, const double* y, const double* z,
                 int64_t nvertices,
                 const uint8_t* rgb,          // nullable, (nv, 3)
                 const float* us, const float* vs,  // nullable, texture uvs
                 const int32_t* faces, int64_t nfaces,  // (nf, 3), 0-based
                 int texture, const char* mtl_stem) {
  std::FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  {
    BufWriter w(f);
    if (texture) {
      w.append("mtllib ");
      w.append(mtl_stem);
      w.append(".mtl\nusemtl Textured\n");
      for (int64_t i = 0; i < nvertices; ++i) {
        w.append("vt ");
        w.append_f64((double)us[i]);
        w.append(" ", 1);
        w.append_f64(1.0 - (double)vs[i]);
        w.append("\n", 1);
      }
    }
    for (int64_t i = 0; i < nvertices; ++i) {
      w.append("v ");
      w.append_f64(x[i]);
      w.append(" ", 1);
      w.append_f64(y[i]);
      w.append(" ", 1);
      w.append_f64(z[i]);
      if (rgb) {
        const uint8_t* c = rgb + 3 * i;
        w.append(" ", 1);
        w.append_f64(c[0] / 255.0);
        w.append(" ", 1);
        w.append_f64(c[1] / 255.0);
        w.append(" ", 1);
        w.append_f64(c[2] / 255.0);
      }
      w.append("\n", 1);
    }
    for (int64_t i = 0; i < nfaces; ++i) {
      const int32_t* t = faces + 3 * i;
      w.append("f", 1);
      for (int j = 0; j < 3; ++j) {
        long long idx = (long long)t[j] + 1;
        w.append(" ", 1);
        w.append_int(idx);
        if (texture) {
          w.append("/", 1);
          w.append_int(idx);
        }
      }
      w.append("\n", 1);
    }
    w.flush();
    if (!w.ok()) { std::fclose(f); return 2; }
  }
  return std::fclose(f) == 0 ? 0 : 3;
}

// Self-test hook: format one double into out (cap 512), return length.
int me_format_f64(double v, char* out) {
  return (int)format_f64(v, out);
}

// First-use vertex indexing over the kept-face stream (the reference's
// IndexedMesh::new, output.rs:272-294): assign each grid vertex its index
// in order of first appearance and remap faces. O(n) single pass -- the
// numpy route (np.unique + argsort over 3*nfaces elements) is ~100x
// slower at full 1536^2 meshes.
//
// faces: (nfaces, 3) int64 linear grid indices in traversal order.
// out_faces: (nfaces, 3) int32 remapped; out_vertex_orig: (>= nv) int64.
// Returns the number of unique vertices.
int64_t me_index_mesh(const int64_t* faces, int64_t nfaces, int64_t grid_size,
                      int32_t* out_faces, int64_t* out_vertex_orig) {
  std::vector<int32_t> remap(grid_size, -1);
  int64_t nv = 0;
  const int64_t n = nfaces * 3;
  for (int64_t i = 0; i < n; ++i) {
    int64_t v = faces[i];
    if (v < 0 || v >= grid_size) return -1;
    int32_t r = remap[v];
    if (r < 0) {
      r = (int32_t)nv;
      remap[v] = r;
      out_vertex_orig[nv++] = v;
    }
    out_faces[i] = r;
  }
  return nv;
}

}  // extern "C"
