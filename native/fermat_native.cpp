// fermat_tpu native runtime: fast scene IO + host BVH build.
//
// The reference implements all host-side systems code in C++ (mesh loading:
// src/mesh/MeshBase.cpp/glm.cpp ~4 KLoC; SAH build: cugar/bvh/bvh_sah_builder.h).
// This library is this build's native runtime for the same pieces: the
// compute path stays JAX/XLA/Pallas, but scene ingestion and acceleration-
// structure construction are CPU-bound host work where C++ is 10-100x python.
//
// Exposed via a plain C ABI consumed with ctypes (fermat_tpu/utils/native.py).
//
// Built on first use by fermat_tpu/utils/native.py:
//   g++ -O3 -shared -fPIC fermat_native.cpp -o build/libfermat_native.so

#include <algorithm>
#include <cctype>
#include <cfloat>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// OBJ loader (geometry subset: v/vn/vt/f with negative indices, fan
// triangulation, usemtl material ranges). Materials themselves (MTL) stay in
// python — tiny files, string-heavy.
// ---------------------------------------------------------------------------

struct ObjResult {
  float*   vertices;        // (nv, 3)
  float*   normals;         // (nn, 3)
  float*   uvs;             // (nt, 2)
  int32_t* tri_v;           // (ntri, 3)
  int32_t* tri_n;           // (ntri, 3) -1 = none
  int32_t* tri_uv;          // (ntri, 3) -1 = none
  int32_t* tri_mat;         // (ntri,)   index into material-name table
  char*    mat_names;       // '\n'-joined usemtl names, in first-use order
  int64_t  nv, nn, nt, ntri, n_mats, mat_names_len;
};

static inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

static inline const char* parse_float(const char* p, const char* end, float* out) {
  char* q;
  *out = strtof(p, &q);
  (void)end;
  return q;
}

static inline const char* parse_int(const char* p, char* endc, long* out) {
  char* q;
  *out = strtol(p, &q, 10);
  if (endc) *endc = *q;
  return q;
}

ObjResult* obj_load(const char* path) {
  FILE* f = fopen(path, "rb");
  if (!f) return nullptr;
  fseek(f, 0, SEEK_END);
  long size = ftell(f);
  fseek(f, 0, SEEK_SET);
  std::string buf;
  buf.resize(size);
  if (fread(&buf[0], 1, size, f) != (size_t)size) { fclose(f); return nullptr; }
  fclose(f);

  std::vector<float> verts, norms, uvs;
  std::vector<int32_t> tv, tn, tuv, tmat;
  std::vector<std::string> mat_names;
  int cur_mat = -1;

  const char* p = buf.data();
  const char* end = p + buf.size();
  while (p < end) {
    const char* line_end = (const char*)memchr(p, '\n', end - p);
    if (!line_end) line_end = end;
    const char* q = skip_ws(p, line_end);
    if (q + 1 < line_end) {
      if (q[0] == 'v' && (q[1] == ' ' || q[1] == '\t')) {
        float x = 0, y = 0, z = 0;
        q = parse_float(q + 2, line_end, &x);
        q = parse_float(q, line_end, &y);
        q = parse_float(q, line_end, &z);
        verts.push_back(x); verts.push_back(y); verts.push_back(z);
      } else if (q[0] == 'v' && q[1] == 'n') {
        float x = 0, y = 0, z = 0;
        q = parse_float(q + 3, line_end, &x);
        q = parse_float(q, line_end, &y);
        q = parse_float(q, line_end, &z);
        norms.push_back(x); norms.push_back(y); norms.push_back(z);
      } else if (q[0] == 'v' && q[1] == 't') {
        float u = 0, v = 0;
        q = parse_float(q + 3, line_end, &u);
        q = parse_float(q, line_end, &v);
        uvs.push_back(u); uvs.push_back(v);
      } else if (q[0] == 'f' && (q[1] == ' ' || q[1] == '\t')) {
        long vi[64], ti[64], ni[64];
        int nc = 0;
        const char* c = q + 2;
        while (c < line_end && nc < 64) {
          c = skip_ws(c, line_end);
          if (c >= line_end || !(*c == '-' || isdigit((unsigned char)*c))) break;
          long v = 0, t = 0, n = 0;
          char sep = 0;
          c = parse_int(c, &sep, &v);
          bool has_t = false, has_n = false;
          if (c < line_end && *c == '/') {
            ++c;
            if (c < line_end && *c != '/') { c = parse_int(c, &sep, &t); has_t = true; }
            if (c < line_end && *c == '/') { ++c; c = parse_int(c, &sep, &n); has_n = true; }
          }
          long NV = (long)verts.size() / 3, NT = (long)uvs.size() / 2,
               NN = (long)norms.size() / 3;
          vi[nc] = v > 0 ? v - 1 : NV + v;
          ti[nc] = has_t ? (t > 0 ? t - 1 : NT + t) : -1;
          ni[nc] = has_n ? (n > 0 ? n - 1 : NN + n) : -1;
          ++nc;
        }
        for (int k = 1; k + 1 < nc; ++k) {
          tv.push_back((int32_t)vi[0]); tv.push_back((int32_t)vi[k]); tv.push_back((int32_t)vi[k + 1]);
          tuv.push_back((int32_t)ti[0]); tuv.push_back((int32_t)ti[k]); tuv.push_back((int32_t)ti[k + 1]);
          tn.push_back((int32_t)ni[0]); tn.push_back((int32_t)ni[k]); tn.push_back((int32_t)ni[k + 1]);
          tmat.push_back(cur_mat < 0 ? 0 : cur_mat);
        }
      } else if (!strncmp(q, "usemtl", 6)) {
        const char* c = skip_ws(q + 6, line_end);
        std::string name(c, line_end - c);
        while (!name.empty() && (name.back() == '\r' || name.back() == ' '))
          name.pop_back();
        int found = -1;
        for (size_t m = 0; m < mat_names.size(); ++m)
          if (mat_names[m] == name) { found = (int)m; break; }
        if (found < 0) { mat_names.push_back(name); found = (int)mat_names.size() - 1; }
        cur_mat = found;
      }
    }
    p = line_end + 1;
  }

  ObjResult* r = (ObjResult*)calloc(1, sizeof(ObjResult));
  auto dup = [](const void* src, size_t bytes) {
    void* d = malloc(bytes ? bytes : 1);
    memcpy(d, src, bytes);
    return d;
  };
  r->nv = (int64_t)verts.size() / 3;
  r->nn = (int64_t)norms.size() / 3;
  r->nt = (int64_t)uvs.size() / 2;
  r->ntri = (int64_t)tv.size() / 3;
  r->vertices = (float*)dup(verts.data(), verts.size() * 4);
  r->normals = (float*)dup(norms.data(), norms.size() * 4);
  r->uvs = (float*)dup(uvs.data(), uvs.size() * 4);
  r->tri_v = (int32_t*)dup(tv.data(), tv.size() * 4);
  r->tri_n = (int32_t*)dup(tn.data(), tn.size() * 4);
  r->tri_uv = (int32_t*)dup(tuv.data(), tuv.size() * 4);
  r->tri_mat = (int32_t*)dup(tmat.data(), tmat.size() * 4);
  std::string joined;
  for (auto& m : mat_names) { joined += m; joined += '\n'; }
  r->n_mats = (int64_t)mat_names.size();
  r->mat_names_len = (int64_t)joined.size();
  r->mat_names = (char*)dup(joined.data(), joined.size());
  return r;
}

void obj_free(ObjResult* r) {
  if (!r) return;
  free(r->vertices); free(r->normals); free(r->uvs);
  free(r->tri_v); free(r->tri_n); free(r->tri_uv); free(r->tri_mat);
  free(r->mat_names);
  free(r);
}

// ---------------------------------------------------------------------------
// Binned-SAH BVH builder -> flattened skip-link layout (matches
// fermat_tpu.accel.bvh.BvhView: DFS order, child = i+1, padded leaves).
// ---------------------------------------------------------------------------

struct BvhResult {
  float*   lo;        // (n_nodes, 3)
  float*   hi;        // (n_nodes, 3)
  int32_t* skip;      // (n_nodes,)
  int32_t* prim_start;// (n_nodes,)
  uint8_t* is_leaf;   // (n_nodes,)
  int32_t* prims;     // (n_prim_slots,)
  int64_t  n_nodes, n_prim_slots;
};

namespace {

struct Builder {
  const float* cen;
  const float* blo;
  const float* bhi;
  int leaf_size;
  std::vector<float> lo, hi;
  std::vector<int32_t> skip, prim_start, prims;
  std::vector<uint8_t> leaf;

  static float area(const float l[3], const float h[3]) {
    float d0 = std::max(h[0] - l[0], 0.f), d1 = std::max(h[1] - l[1], 0.f),
          d2 = std::max(h[2] - l[2], 0.f);
    return d0 * d1 + d1 * d2 + d2 * d0;
  }

  // emits the subtree over ids[begin,end), returns via append; skip_to
  // patched by caller convention identical to the python builder
  void build(std::vector<int32_t>& ids, int begin, int end, int32_t skip_to) {
    float nlo[3] = {FLT_MAX, FLT_MAX, FLT_MAX},
          nhi[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int k = begin; k < end; ++k) {
      const int t = ids[k];
      for (int a = 0; a < 3; ++a) {
        nlo[a] = std::min(nlo[a], blo[t * 3 + a]);
        nhi[a] = std::max(nhi[a], bhi[t * 3 + a]);
      }
    }
    const int my = (int)skip.size();
    for (int a = 0; a < 3; ++a) { lo.push_back(nlo[a]); hi.push_back(nhi[a]); }
    skip.push_back(skip_to);
    const int count = end - begin;
    if (count <= leaf_size) {
      prim_start.push_back((int32_t)prims.size());
      leaf.push_back(1);
      for (int k = begin; k < end; ++k) prims.push_back(ids[k]);
      for (int k = count; k < leaf_size; ++k) prims.push_back(-1);
      return;
    }
    prim_start.push_back(0);
    leaf.push_back(0);

    // centroid bounds
    float cl[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, ch[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
    for (int k = begin; k < end; ++k) {
      const int t = ids[k];
      for (int a = 0; a < 3; ++a) {
        cl[a] = std::min(cl[a], cen[t * 3 + a]);
        ch[a] = std::max(ch[a], cen[t * 3 + a]);
      }
    }
    int axis = 0;
    float ext = ch[0] - cl[0];
    for (int a = 1; a < 3; ++a)
      if (ch[a] - cl[a] > ext) { ext = ch[a] - cl[a]; axis = a; }

    int mid;
    if (ext <= 1e-12f) {
      mid = begin + count / 2;
    } else {
      constexpr int NB = 16;
      float binlo[NB][3], binhi[NB][3];
      int binn[NB] = {0};
      for (int b = 0; b < NB; ++b)
        for (int a = 0; a < 3; ++a) { binlo[b][a] = FLT_MAX; binhi[b][a] = -FLT_MAX; }
      const float inv = NB / ext;
      for (int k = begin; k < end; ++k) {
        const int t = ids[k];
        int b = (int)((cen[t * 3 + axis] - cl[axis]) * inv);
        b = std::min(std::max(b, 0), NB - 1);
        ++binn[b];
        for (int a = 0; a < 3; ++a) {
          binlo[b][a] = std::min(binlo[b][a], blo[t * 3 + a]);
          binhi[b][a] = std::max(binhi[b][a], bhi[t * 3 + a]);
        }
      }
      float la[NB - 1];
      int ln[NB - 1];
      {
        float acl[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, ach[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        int an = 0;
        for (int b = 0; b < NB - 1; ++b) {
          for (int a = 0; a < 3; ++a) {
            acl[a] = std::min(acl[a], binlo[b][a]);
            ach[a] = std::max(ach[a], binhi[b][a]);
          }
          an += binn[b];
          la[b] = an ? area(acl, ach) : 0.f;
          ln[b] = an;
        }
      }
      int best = -1;
      float best_cost = FLT_MAX;
      {
        float acl[3] = {FLT_MAX, FLT_MAX, FLT_MAX}, ach[3] = {-FLT_MAX, -FLT_MAX, -FLT_MAX};
        int an = 0;
        for (int b = NB - 1; b >= 1; --b) {
          for (int a = 0; a < 3; ++a) {
            acl[a] = std::min(acl[a], binlo[b][a]);
            ach[a] = std::max(ach[a], binhi[b][a]);
          }
          an += binn[b];
          if (ln[b - 1] > 0 && an > 0) {
            const float cost = la[b - 1] * ln[b - 1] + area(acl, ach) * an;
            if (cost < best_cost) { best_cost = cost; best = b - 1; }
          }
        }
      }
      if (best < 0) {
        mid = begin + count / 2;
        std::nth_element(ids.begin() + begin, ids.begin() + mid, ids.begin() + end,
                         [&](int x, int y) { return cen[x * 3 + axis] < cen[y * 3 + axis]; });
      } else {
        auto it = std::partition(ids.begin() + begin, ids.begin() + end,
                                 [&](int x) {
                                   int bb = (int)((cen[x * 3 + axis] - cl[axis]) * inv);
                                   bb = std::min(std::max(bb, 0), NB - 1);
                                   return bb <= best;
                                 });
        mid = (int)(it - ids.begin());
        if (mid == begin || mid == end) {
          mid = begin + count / 2;
          std::nth_element(ids.begin() + begin, ids.begin() + mid, ids.begin() + end,
                           [&](int x, int y) { return cen[x * 3 + axis] < cen[y * 3 + axis]; });
        }
      }
    }

    // left subtree exits to the right child; patch -2 placeholders
    const int left_pos = (int)skip.size();
    build(ids, begin, mid, -2);
    const int right_pos = (int)skip.size();
    for (int k = left_pos; k < right_pos; ++k)
      if (skip[k] == -2) skip[k] = right_pos;
    build(ids, mid, end, skip_to);
    (void)my;
  }
};

}  // namespace

BvhResult* bvh_build(const float* centroids, const float* lo, const float* hi,
                     int64_t n, int32_t leaf_size) {
  if (n <= 0) return nullptr;
  Builder b;
  b.cen = centroids;
  b.blo = lo;
  b.bhi = hi;
  b.leaf_size = leaf_size;
  b.lo.reserve((size_t)n * 6);
  b.skip.reserve((size_t)n * 2);
  std::vector<int32_t> ids((size_t)n);
  for (int64_t k = 0; k < n; ++k) ids[(size_t)k] = (int32_t)k;
  b.build(ids, 0, (int)n, -1);

  BvhResult* r = (BvhResult*)calloc(1, sizeof(BvhResult));
  auto dup = [](const void* src, size_t bytes) {
    void* d = malloc(bytes ? bytes : 1);
    memcpy(d, src, bytes);
    return d;
  };
  r->n_nodes = (int64_t)b.skip.size();
  r->n_prim_slots = (int64_t)b.prims.size();
  r->lo = (float*)dup(b.lo.data(), b.lo.size() * 4);
  r->hi = (float*)dup(b.hi.data(), b.hi.size() * 4);
  r->skip = (int32_t*)dup(b.skip.data(), b.skip.size() * 4);
  r->prim_start = (int32_t*)dup(b.prim_start.data(), b.prim_start.size() * 4);
  r->is_leaf = (uint8_t*)dup(b.leaf.data(), b.leaf.size());
  r->prims = (int32_t*)dup(b.prims.data(), b.prims.size() * 4);
  return r;
}

void bvh_free(BvhResult* r) {
  if (!r) return;
  free(r->lo); free(r->hi); free(r->skip); free(r->prim_start);
  free(r->is_leaf); free(r->prims);
  free(r);
}

}  // extern "C"
