// Native Wavefront OBJ parser of tpu_raytracer_torch (plain C ABI, bound
// with ctypes in scene/native_obj.py; built with g++ at first use by
// kernels/build.py build_obj_parser). The port's own copy of the JAX
// package's native obj_loader.cpp (reference: CudaRaytracer/OBJLoader.hpp).
//
// Bit-identical results to the numpy parser (scene/objloader.py
// _parse_obj_py), tested:
//   * v/vt records collected and f records fan-triangulated (0, i, i+1)
//     in one walk (OBJLoader.hpp:139-169);
//   * a face attaches UVs only when EVERY face token carries a vt index
//     (mixed tokens degrade to untextured);
//   * vertex/texcoord indices are 1-based; negative indices wrap like
//     numpy negative indexing, after the same subtraction of 1;
//   * floats parsed with strtod then cast to float, matching Python's
//     float() -> np.float32 double rounding; hex floats and empty index
//     tokens are rejected as Python rejects them. Known differences
//     (both reject-vs-accept, never wrong geometry): PEP 515 underscored
//     literals ("1_0") parse in Python only; unicode line terminators
//     (\v, \f, U+2028...) split in Python's splitlines only (\n, \r\n and
//     \r are handled).
//
// ABI, through an opaque handle:
//   trt_obj_parse(text, len) -> handle (NULL on malformed input)
//   trt_obj_counts(handle, &num_tris)
//   trt_obj_fill(handle, v0, v1, v2, uv0, uv1, uv2, has_uv)
//   trt_obj_free(handle)
//
// The numpy parser's cost is per-token str.split and float() work; this
// walk allocates little.

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Tri {
  int32_t v[3];
  int32_t t[3];
  bool tex;  // explicit flag: a wrapped vt index can legally be -1
};

struct ObjData {
  std::vector<float> verts;   // xyz triples
  std::vector<float> uvs;     // uv pairs
  std::vector<Tri> tris;
};

// Whitespace-delimited token scan within [p, end); returns token start
// or nullptr, advances *p past the token.
const char* next_token(const char** p, const char* end, size_t* n) {
  const char* s = *p;
  while (s < end && (*s == ' ' || *s == '\t' || *s == '\r')) ++s;
  if (s >= end || *s == '\n') { *p = s; return nullptr; }
  const char* t = s;
  while (t < end && !isspace((unsigned char)*t)) ++t;
  *n = size_t(t - s);
  *p = t;
  return s;
}

bool parse_float(const char* s, size_t n, float* out) {
  char buf[64];
  if (n == 0 || n >= sizeof(buf)) return false;
  memcpy(buf, s, n);
  buf[n] = 0;
  // reject C hex floats ("0x1p3") — Python float() errors on them
  const char* b = buf + (buf[0] == '+' || buf[0] == '-' ? 1 : 0);
  if (b[0] == '0' && (b[1] == 'x' || b[1] == 'X')) return false;
  char* endp = nullptr;
  double d = strtod(buf, &endp);  // double first: match Python float()
  if (endp != buf + n) return false;
  *out = (float)d;
  return true;
}

bool parse_int(const char* s, size_t n, long* out) {
  char buf[64];
  if (n == 0 || n >= sizeof(buf)) return false;  // int("") raises in Python
  memcpy(buf, s, n);
  buf[n] = 0;
  char* endp = nullptr;
  long v = strtol(buf, &endp, 10);
  if (endp != buf + n) return false;
  *out = v;
  return true;
}

}  // namespace

extern "C" {

void* trt_obj_parse(const char* text, int64_t len) {
  ObjData* d = new ObjData();
  const char* p = text;
  const char* end = text + len;
  std::vector<long> v_idx, t_idx;

  while (p < end) {
    // line terminators: \n, \r\n, or bare \r (str.splitlines parity)
    const char* line_end = p;
    while (line_end < end && *line_end != '\n' && *line_end != '\r')
      ++line_end;
    const char* q = p;
    size_t n;
    const char* tag = next_token(&q, line_end, &n);
    if (tag) {
      if (n == 1 && tag[0] == 'v') {
        float xyz[3];
        for (int i = 0; i < 3; ++i) {
          const char* tok = next_token(&q, line_end, &n);
          if (!tok || !parse_float(tok, n, &xyz[i])) { delete d; return nullptr; }
        }
        d->verts.insert(d->verts.end(), xyz, xyz + 3);
      } else if (n == 2 && tag[0] == 'v' && tag[1] == 't') {
        float uv[2];
        for (int i = 0; i < 2; ++i) {
          const char* tok = next_token(&q, line_end, &n);
          if (!tok || !parse_float(tok, n, &uv[i])) { delete d; return nullptr; }
        }
        d->uvs.insert(d->uvs.end(), uv, uv + 2);
      } else if (n == 1 && tag[0] == 'f') {
        v_idx.clear();
        t_idx.clear();
        for (;;) {
          const char* tok = next_token(&q, line_end, &n);
          if (!tok) break;
          // split on '/': parts[0] = vertex, parts[1] = texcoord
          const char* slash = (const char*)memchr(tok, '/', n);
          size_t vn = slash ? size_t(slash - tok) : n;
          long vi;
          if (!parse_int(tok, vn, &vi)) { delete d; return nullptr; }
          v_idx.push_back(vi - 1);
          if (slash) {
            const char* ts = slash + 1;
            const char* te = (const char*)memchr(ts, '/', size_t(tok + n - ts));
            if (!te) te = tok + n;
            if (te > ts) {  // parts[1] non-empty
              long ti;
              if (!parse_int(ts, size_t(te - ts), &ti)) { delete d; return nullptr; }
              t_idx.push_back(ti - 1);
            }
          }
        }
        bool textured = !v_idx.empty() && t_idx.size() == v_idx.size();
        for (size_t i = 1; i + 1 < v_idx.size(); ++i) {
          Tri t;
          t.v[0] = (int32_t)v_idx[0];
          t.v[1] = (int32_t)v_idx[i];
          t.v[2] = (int32_t)v_idx[i + 1];
          t.tex = textured;
          if (textured) {
            t.t[0] = (int32_t)t_idx[0];
            t.t[1] = (int32_t)t_idx[i];
            t.t[2] = (int32_t)t_idx[i + 1];
          } else {
            t.t[0] = t.t[1] = t.t[2] = -1;
          }
          d->tris.push_back(t);
        }
      }
    }
    p = line_end;
    if (p < end && *p == '\r') ++p;
    if (p < end && *p == '\n') ++p;
  }
  return d;
}

void trt_obj_counts(void* handle, int64_t* num_tris) {
  *num_tris = (int64_t)((ObjData*)handle)->tris.size();
}

// Gather triangle vertex/uv arrays. Returns 0 on success, -1 on an
// out-of-range index (Python would raise IndexError).
int32_t trt_obj_fill(void* handle, float* v0, float* v1, float* v2,
                     float* uv0, float* uv1, float* uv2,
                     uint8_t* has_uv) {
  ObjData* d = (ObjData*)handle;
  int64_t nv = (int64_t)(d->verts.size() / 3);
  int64_t nt = (int64_t)(d->uvs.size() / 2);
  float* vout[3] = {v0, v1, v2};
  float* tout[3] = {uv0, uv1, uv2};
  for (size_t k = 0; k < d->tris.size(); ++k) {
    const Tri& t = d->tris[k];
    for (int c = 0; c < 3; ++c) {
      int64_t vi = t.v[c];
      if (vi < 0) vi += nv;  // numpy negative-index wrap
      if (vi < 0 || vi >= nv) return -1;
      memcpy(vout[c] + 3 * k, &d->verts[3 * vi], 3 * sizeof(float));
    }
    has_uv[k] = t.tex ? 1 : 0;
    for (int c = 0; c < 3; ++c) {
      if (!t.tex) {
        tout[c][2 * k] = 0.0f;
        tout[c][2 * k + 1] = 0.0f;
        continue;
      }
      int64_t ti = t.t[c];
      if (ti < 0) ti += nt;
      if (ti < 0 || ti >= nt) return -1;
      memcpy(tout[c] + 2 * k, &d->uvs[2 * ti], 2 * sizeof(float));
    }
  }
  return 0;
}

void trt_obj_free(void* handle) { delete (ObjData*)handle; }

}  // extern "C"
