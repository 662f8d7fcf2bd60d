// OBJ parser -> flat triangle soup (fan triangulation), in C++.
//
// The native twin of radish_pt_tpu_torch/scene/obj_loader.py::load_obj_py,
// equal to it array for array on well-formed files: indices expanded to a
// non-indexed per-corner soup, missing normals filled with the face normal
// (e1 x e2 over max(|e1 x e2|, 1e-12), numpy's f32 arithmetic), missing
// texcoords zeroed.  Numbers go through strtod and then to float, as Python's
// float() and numpy's float32 cast round them.  Lines end at '\n' or '\r'
// (Python's universal newlines).  A malformed line is an error, not a guess.
// Build with -ffp-contract=off.
//
// C ABI for ctypes: parse -> handle, count, copy, free.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Mesh {
  std::vector<float> v;   // [3T * 3]
  std::vector<float> n;   // [3T * 3]
  std::vector<float> uv;  // [3T * 2]
};

struct Corner {
  int64_t vi, ti, ni;
};

inline bool is_ws(char c) {
  return c == ' ' || c == '\t' || c == '\v' || c == '\f';
}

// Python's _parse_index: 1-based, or negative from the end
inline int64_t fix_index(long long i, size_t count) {
  return i > 0 ? (int64_t)(i - 1) : (int64_t)count + i;
}

struct Parser {
  std::string err;

  bool number(const std::string &tok, float *out) {
    char *end;
    double d = std::strtod(tok.c_str(), &end);
    if (tok.empty() || *end != '\0') return fail("not a number: '" + tok + "'");
    *out = (float)d;
    return true;
  }

  bool integer(const char *s, size_t len, long long *out) {
    std::string tok(s, len);
    char *end;
    *out = std::strtoll(tok.c_str(), &end, 10);
    if (tok.empty() || *end != '\0') return fail("not an index: '" + tok + "'");
    return true;
  }

  bool fail(const std::string &msg) {
    if (err.empty()) err = msg;
    return false;
  }

  Mesh *parse(const char *path) {
    FILE *f = std::fopen(path, "rb");
    if (!f) {
      fail(std::string("cannot open ") + path);
      return nullptr;
    }
    std::string text;
    char buf[1 << 16];
    size_t got;
    while ((got = std::fread(buf, 1, sizeof(buf), f)) > 0) text.append(buf, got);
    std::fclose(f);

    std::vector<float> pos, nrm, tex;
    std::vector<Corner> corners, face;
    std::vector<std::string> parts;
    size_t at = 0;
    while (at < text.size()) {
      size_t stop = text.find_first_of("\r\n", at);
      if (stop == std::string::npos) stop = text.size();
      parts.clear();
      for (size_t i = at; i < stop;) {
        while (i < stop && is_ws(text[i])) ++i;
        size_t j = i;
        while (j < stop && !is_ws(text[j])) ++j;
        if (j > i) parts.emplace_back(text, i, j - i);
        i = j;
      }
      at = stop + 1;
      if (parts.empty()) continue;
      const std::string &tag = parts[0];  // a comment's '#...' matches no tag
      if (tag == "v" || tag == "vn") {
        if (parts.size() < 4) return fail(tag + " line with fewer than 3 numbers"), nullptr;
        std::vector<float> &dst = tag == "v" ? pos : nrm;
        for (int k = 1; k <= 3; ++k) {
          float x;
          if (!number(parts[k], &x)) return nullptr;
          dst.push_back(x);
        }
      } else if (tag == "vt") {
        if (parts.size() < 3) return fail("vt line with fewer than 2 numbers"), nullptr;
        for (int k = 1; k <= 2; ++k) {
          float x;
          if (!number(parts[k], &x)) return nullptr;
          tex.push_back(x);
        }
      } else if (tag == "f") {
        face.clear();
        for (size_t k = 1; k < parts.size(); ++k) {
          const std::string &tok = parts[k];
          // comps = tok.split("/"): index, texcoord, normal
          size_t s1 = tok.find('/');
          size_t s2 = s1 == std::string::npos ? std::string::npos : tok.find('/', s1 + 1);
          long long i;
          Corner c{0, -1, -1};
          if (!integer(tok.c_str(), std::min(s1, tok.size()), &i)) return nullptr;
          c.vi = fix_index(i, pos.size() / 3);
          if (s1 != std::string::npos) {
            size_t e1 = s2 == std::string::npos ? tok.size() : s2;
            if (e1 > s1 + 1) {
              if (!integer(tok.c_str() + s1 + 1, e1 - s1 - 1, &i)) return nullptr;
              c.ti = fix_index(i, tex.size() / 2);
            }
          }
          if (s2 != std::string::npos) {
            size_t e2 = tok.find('/', s2 + 1);
            if (e2 == std::string::npos) e2 = tok.size();
            if (e2 > s2 + 1) {
              if (!integer(tok.c_str() + s2 + 1, e2 - s2 - 1, &i)) return nullptr;
              c.ni = fix_index(i, nrm.size() / 3);
            }
          }
          face.push_back(c);
        }
        for (size_t k = 1; k + 1 < face.size(); ++k) {
          corners.push_back(face[0]);
          corners.push_back(face[k]);
          corners.push_back(face[k + 1]);
        }
      }
    }
    if (corners.empty()) return fail("contains no faces"), nullptr;

    Mesh *m = new Mesh;
    const size_t nc = corners.size();
    m->v.resize(nc * 3);
    m->n.resize(nc * 3, 0.f);
    m->uv.resize(nc * 2, 0.f);
    std::vector<char> have_n(nc, 0);
    const size_t n_pos = pos.size() / 3, n_tex = tex.size() / 2, n_nrm = nrm.size() / 3;
    for (size_t i = 0; i < nc; ++i) {
      const Corner &c = corners[i];
      if (c.vi < 0 || (size_t)c.vi >= n_pos) {
        delete m;
        return fail("vertex index out of range"), nullptr;
      }
      std::memcpy(&m->v[i * 3], &pos[(size_t)c.vi * 3], 3 * sizeof(float));
      if (c.ti >= 0 && n_tex > 0) {
        if ((size_t)c.ti >= n_tex) {
          delete m;
          return fail("texcoord index out of range"), nullptr;
        }
        m->uv[i * 2] = tex[(size_t)c.ti * 2];
        m->uv[i * 2 + 1] = tex[(size_t)c.ti * 2 + 1];
      }
      if (c.ni >= 0 && n_nrm > 0) {
        if ((size_t)c.ni >= n_nrm) {
          delete m;
          return fail("normal index out of range"), nullptr;
        }
        std::memcpy(&m->n[i * 3], &nrm[(size_t)c.ni * 3], 3 * sizeof(float));
        have_n[i] = 1;
      }
    }
    // missing normals: the face normal, as numpy's cross / norm / maximum
    for (size_t t = 0; t < nc / 3; ++t) {
      if (have_n[t * 3] && have_n[t * 3 + 1] && have_n[t * 3 + 2]) continue;
      const float *a = &m->v[t * 9], *b = a + 3, *c = a + 6;
      float e1[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
      float e2[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
      float fn[3] = {e1[1] * e2[2] - e1[2] * e2[1], e1[2] * e2[0] - e1[0] * e2[2],
                     e1[0] * e2[1] - e1[1] * e2[0]};
      float len = std::sqrt(fn[0] * fn[0] + fn[1] * fn[1] + fn[2] * fn[2]);
      len = len < 1e-12f ? 1e-12f : len;  // np.maximum: a NaN stays NaN
      for (int k = 0; k < 3; ++k) fn[k] /= len;
      for (int k = 0; k < 3; ++k) {
        if (!have_n[t * 3 + k]) std::memcpy(&m->n[(t * 3 + k) * 3], fn, 3 * sizeof(float));
      }
    }
    return m;
  }
};

thread_local std::string g_error;

}  // namespace

extern "C" {

// A handle to the parsed soup, or NULL: then radish_obj_error says why.
void *radish_obj_parse(const char *path) {
  Parser p;
  Mesh *m = p.parse(path);
  g_error = m ? std::string() : p.err;
  return m;
}

const char *radish_obj_error() { return g_error.c_str(); }

int64_t radish_obj_num_corners(void *h) {
  return h ? (int64_t)(((Mesh *)h)->v.size() / 3) : 0;
}

void radish_obj_copy(void *h, float *v, float *n, float *uv) {
  Mesh *m = (Mesh *)h;
  std::memcpy(v, m->v.data(), m->v.size() * sizeof(float));
  std::memcpy(n, m->n.data(), m->n.size() * sizeof(float));
  std::memcpy(uv, m->uv.data(), m->uv.size() * sizeof(float));
}

void radish_obj_free(void *h) { delete (Mesh *)h; }
}
