// Fast Wavefront OBJ parser (this package's copy of
// solr_tpu/native/src/objparse.cc; reference analog:
// solr/io/OBJReader.cpp, the reference's C++ asset ingest).
//
// Two-pass ctypes interface (caller allocates from pass-1 counts):
//   obj_count(path, out[4])            -> nv, nvt, nvn, ntris
//   obj_parse(path, v, vt, vn, f_v, f_vt, f_vn, f_slot, names, cap,
//             caps[4])
// caps = the pass-1 counts the caller sized its buffers from; pass 2
// fails with rc 3 the moment any write index would exceed them (a file
// mutated between the passes must produce a clean error, not native
// heap corruption).
//
// Semantics matched to solr_tpu_torch.io.obj.parse_obj:
//   * faces fan-triangulate (n-gon -> n-2 tris);
//   * indices resolve 1-based; negative indices resolve against the
//     count of elements seen SO FAR (the OBJ spec rule);
//   * missing vt/vn slots emit -1;
//   * f_slot[i] = usemtl slot of the face, slots numbered by first
//     appearance of each distinct material name (-1 before any usemtl
//     -> the caller's default material);
//   * names: mtllib names '\n'-joined, then '\x01', then distinct
//     usemtl names '\n'-joined (Python maps slots -> material ids).
//
// Build: g++ -O3 -march=native -std=c++17 -shared -fPIC (see
// solr_tpu_torch/native/__init__.py; one library with lbvh.cc).

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Lines {
  FILE* f = nullptr;
  char* buf = nullptr;
  size_t cap = 0;
  explicit Lines(const char* path) { f = fopen(path, "rb"); }
  ~Lines() {
    if (f) fclose(f);
    free(buf);
  }
  bool ok() const { return f != nullptr; }
  char* next() {
    ssize_t n = getline(&buf, &cap, f);
    if (n < 0) return nullptr;
    return buf;
  }
};

inline const char* skip_ws(const char* p) {
  while (*p == ' ' || *p == '\t' || *p == '\r') ++p;
  return p;
}

inline const char* skip_token(const char* p) {
  while (*p && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  return p;
}

// Count vertex refs on an f line (tokens after "f").
inline int face_arity(const char* p) {
  int n = 0;
  p = skip_ws(p);
  while (*p && *p != '\n') {
    ++n;
    p = skip_token(p);
    p = skip_ws(p);
  }
  return n;
}

struct Ref {
  long v = 0, t = 0, n = 0;
};

// Parse one "a/b/c" | "a//c" | "a/b" | "a" token.
inline const char* parse_ref(const char* p, Ref* r) {
  char* end;
  r->v = strtol(p, &end, 10);
  p = end;
  r->t = 0;
  r->n = 0;
  if (*p == '/') {
    ++p;
    if (*p != '/') {
      r->t = strtol(p, &end, 10);
      p = end;
    }
    if (*p == '/') {
      ++p;
      r->n = strtol(p, &end, 10);
      p = end;
    }
  }
  return p;
}

inline int resolve(long idx, long count) {
  if (idx > 0) return (int)(idx - 1);
  if (idx < 0) return (int)(count + idx);
  return -1;
}

}  // namespace

extern "C" int obj_count(const char* path, long long out[4]) {
  Lines lines(path);
  if (!lines.ok()) return 1;
  long long nv = 0, nvt = 0, nvn = 0, ntris = 0;
  while (char* line = lines.next()) {
    const char* p = skip_ws(line);
    if (p[0] == 'v') {
      if (p[1] == ' ' || p[1] == '\t') ++nv;
      else if (p[1] == 't' && (p[2] == ' ' || p[2] == '\t')) ++nvt;
      else if (p[1] == 'n' && (p[2] == ' ' || p[2] == '\t')) ++nvn;
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      int a = face_arity(p + 1);
      if (a >= 3) ntris += a - 2;
    }
  }
  out[0] = nv;
  out[1] = nvt;
  out[2] = nvn;
  out[3] = ntris;
  return 0;
}

extern "C" int obj_parse(const char* path, float* v, float* vt, float* vn,
                         int* f_v, int* f_vt, int* f_vn, int* f_slot,
                         char* names, long long names_cap,
                         const long long caps[4]) {
  Lines lines(path);
  if (!lines.ok()) return 1;
  const long long cap_v = caps[0], cap_vt = caps[1], cap_vn = caps[2],
                  cap_f = caps[3];
  long long nv = 0, nvt = 0, nvn = 0, nf = 0;
  int cur_slot = -1;  // no usemtl yet -> caller's default material
  std::vector<std::string> slots;   // distinct usemtl names, in order
  std::string mtllibs;
  std::vector<Ref> refs;
  refs.reserve(8);

  while (char* line = lines.next()) {
    const char* p = skip_ws(line);
    if (p[0] == 'v' && (p[1] == ' ' || p[1] == '\t')) {
      char* end;
      p += 2;
      if (nv >= cap_v) return 3;
      v[nv * 3 + 0] = strtof(p, &end);
      v[nv * 3 + 1] = strtof(end, &end);
      v[nv * 3 + 2] = strtof(end, &end);
      ++nv;
    } else if (p[0] == 'v' && p[1] == 't' &&
               (p[2] == ' ' || p[2] == '\t')) {
      char* end;
      p += 3;
      if (nvt >= cap_vt) return 3;
      vt[nvt * 2 + 0] = strtof(p, &end);
      vt[nvt * 2 + 1] = strtof(end, &end);
      ++nvt;
    } else if (p[0] == 'v' && p[1] == 'n' &&
               (p[2] == ' ' || p[2] == '\t')) {
      char* end;
      p += 3;
      if (nvn >= cap_vn) return 3;
      vn[nvn * 3 + 0] = strtof(p, &end);
      vn[nvn * 3 + 1] = strtof(end, &end);
      vn[nvn * 3 + 2] = strtof(end, &end);
      ++nvn;
    } else if (p[0] == 'f' && (p[1] == ' ' || p[1] == '\t')) {
      refs.clear();
      p = skip_ws(p + 1);
      while (*p && *p != '\n' && *p != '\r') {
        Ref r;
        p = parse_ref(p, &r);
        refs.push_back(r);
        p = skip_ws(skip_token(p));
      }
      for (size_t a = 1; a + 1 < refs.size(); ++a) {
        if (nf >= cap_f) return 3;
        const Ref tri[3] = {refs[0], refs[a], refs[a + 1]};
        for (int k = 0; k < 3; ++k) {
          f_v[nf * 3 + k] = resolve(tri[k].v, nv);
          f_vt[nf * 3 + k] = resolve(tri[k].t, nvt);
          f_vn[nf * 3 + k] = resolve(tri[k].n, nvn);
        }
        f_slot[nf] = cur_slot;
        ++nf;
      }
    } else if (!strncmp(p, "usemtl", 6) &&
               (p[6] == ' ' || p[6] == '\t')) {
      const char* s = skip_ws(p + 6);
      const char* e = skip_token(s);
      std::string name(s, e - s);
      int found = -1;
      for (size_t i = 0; i < slots.size(); ++i)
        if (slots[i] == name) { found = (int)i; break; }
      if (found < 0) {
        slots.push_back(name);
        found = (int)slots.size() - 1;
      }
      cur_slot = found;
    } else if (!strncmp(p, "mtllib", 6) &&
               (p[6] == ' ' || p[6] == '\t')) {
      const char* s = skip_ws(p + 6);
      const char* e = skip_token(s);
      if (!mtllibs.empty()) mtllibs += '\n';
      mtllibs.append(s, e - s);
    }
  }

  std::string packed = mtllibs;
  packed += '\x01';
  for (size_t i = 0; i < slots.size(); ++i) {
    if (i) packed += '\n';
    packed += slots[i];
  }
  if ((long long)packed.size() + 1 > names_cap) return 2;
  memcpy(names, packed.c_str(), packed.size() + 1);
  return 0;
}
