// meshops: native mesh processing for nerf2mesh-tpu.
//
// Replaces the reference's pymeshlab dependency (reference meshutils.py)
// with a small self-contained C++ library exposed through a C ABI (ctypes):
//   - quadric edge-collapse decimation (Garland-Heckbert), with optional
//     per-face protection mask (used by adaptive refinement, meshutils.py:191)
//     and face-provenance output (surviving faces keep identity, so per-face
//     attributes can be carried through collapses like pymeshlab's fq)
//   - isotropic explicit remeshing (Botsch-Kobbelt split/collapse/flip/relax),
//     selected-only, carrying an int attribute per face
//     (meshutils.py:196-230 isotropic_explicit_remeshing semantics)
//   - duplicate-vertex merge (epsilon grid hashing)
//   - small-connected-component removal by face count / bbox diameter
//     (meshutils.py:146-188 clean_mesh semantics)
//
// These run host-side a handful of times per job (SURVEY.md §7), but on a
// single-core host a Python implementation of decimation would take minutes;
// this runs ~1e6 collapses in seconds.
//
// Build: make -C nerf2mesh_tpu/native   (produces libmeshops.so)

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cmath>
#include <vector>
#include <queue>
#include <unordered_map>
#include <algorithm>
#include <functional>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
  Vec3() = default;
  Vec3(double a, double b, double c) : x(a), y(b), z(c) {}
  Vec3 operator+(const Vec3& o) const { return {x + o.x, y + o.y, z + o.z}; }
  Vec3 operator-(const Vec3& o) const { return {x - o.x, y - o.y, z - o.z}; }
  Vec3 operator*(double s) const { return {x * s, y * s, z * s}; }
  double dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  Vec3 cross(const Vec3& o) const {
    return {y * o.z - z * o.y, z * o.x - x * o.z, x * o.y - y * o.x};
  }
  double norm() const { return std::sqrt(dot(*this)); }
};

// symmetric 4x4 quadric, 10 coefficients
struct Quadric {
  double q[10] = {0};
  void addPlane(double a, double b, double c, double d, double w) {
    q[0] += w * a * a; q[1] += w * a * b; q[2] += w * a * c; q[3] += w * a * d;
    q[4] += w * b * b; q[5] += w * b * c; q[6] += w * b * d;
    q[7] += w * c * c; q[8] += w * c * d; q[9] += w * d * d;
  }
  void add(const Quadric& o) { for (int i = 0; i < 10; i++) q[i] += o.q[i]; }
  double eval(const Vec3& v) const {
    return q[0]*v.x*v.x + 2*q[1]*v.x*v.y + 2*q[2]*v.x*v.z + 2*q[3]*v.x
         + q[4]*v.y*v.y + 2*q[5]*v.y*v.z + 2*q[6]*v.y
         + q[7]*v.z*v.z + 2*q[8]*v.z + q[9];
  }
};

struct EdgeKey {
  uint64_t k;
  EdgeKey(int a, int b) {
    if (a > b) std::swap(a, b);
    k = (uint64_t(uint32_t(a)) << 32) | uint32_t(b);
  }
  bool operator==(const EdgeKey& o) const { return k == o.k; }
};
struct EdgeKeyHash {
  size_t operator()(const EdgeKey& e) const {
    uint64_t x = e.k; x ^= x >> 33; x *= 0xff51afd7ed558ccdULL; x ^= x >> 33;
    return size_t(x);
  }
};

struct HeapItem {
  double cost;
  int a, b;
  uint32_t stamp_a, stamp_b;
  bool operator<(const HeapItem& o) const { return cost > o.cost; }  // min-heap
};

void write_out(const std::vector<Vec3>& V, const std::vector<int>& F,
               float** out_v, int* out_nv, int** out_f, int* out_nf) {
  *out_nv = (int)V.size();
  *out_nf = (int)(F.size() / 3);
  *out_v = (float*)std::malloc(sizeof(float) * 3 * V.size());
  *out_f = (int*)std::malloc(sizeof(int) * F.size());
  for (size_t i = 0; i < V.size(); i++) {
    (*out_v)[3 * i + 0] = (float)V[i].x;
    (*out_v)[3 * i + 1] = (float)V[i].y;
    (*out_v)[3 * i + 2] = (float)V[i].z;
  }
  std::memcpy(*out_f, F.data(), sizeof(int) * F.size());
}

// compact: drop unreferenced vertices, renumber
void compact(std::vector<Vec3>& V, std::vector<int>& F) {
  std::vector<int> remap(V.size(), -1);
  std::vector<Vec3> NV;
  NV.reserve(V.size());
  for (size_t i = 0; i < F.size(); i++) {
    int v = F[i];
    if (remap[v] < 0) {
      remap[v] = (int)NV.size();
      NV.push_back(V[v]);
    }
    F[i] = remap[v];
  }
  V.swap(NV);
}

}  // namespace

extern "C" {

void meshops_free(void* p) { std::free(p); }

// Quadric edge-collapse to `target_faces`. protect: optional [nf] mask, faces
// with protect!=0 are never touched (their vertices are pinned).
// out_fsrc (optional, may be NULL): per output face, the index of the input
// face it descends from (collapses never create faces, so this is exact) —
// lets callers carry per-face attributes through, like pymeshlab's fq.
int meshops_decimate(const float* verts, int nv, const int* tris, int nf,
                     int target_faces, const uint8_t* protect,
                     float** out_v, int* out_nv, int** out_f, int* out_nf,
                     int** out_fsrc) {
  std::vector<Vec3> V(nv);
  for (int i = 0; i < nv; i++)
    V[i] = Vec3(verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
  std::vector<int> F(tris, tris + 3 * (size_t)nf);

  std::vector<Quadric> Q(nv);
  std::vector<char> pinned(nv, 0);
  std::vector<std::vector<int>> vfaces(nv);
  std::vector<char> dead_face(nf, 0);

  for (int f = 0; f < nf; f++) {
    int a = F[3 * f], b = F[3 * f + 1], c = F[3 * f + 2];
    Vec3 n = (V[b] - V[a]).cross(V[c] - V[a]);
    double area2 = n.norm();
    if (area2 < 1e-30) { dead_face[f] = 1; continue; }
    Vec3 un = n * (1.0 / area2);
    double d = -un.dot(V[a]);
    double w = 0.5 * area2;  // area weight
    Q[a].addPlane(un.x, un.y, un.z, d, w);
    Q[b].addPlane(un.x, un.y, un.z, d, w);
    Q[c].addPlane(un.x, un.y, un.z, d, w);
    vfaces[a].push_back(f); vfaces[b].push_back(f); vfaces[c].push_back(f);
    if (protect && protect[f]) { pinned[a] = pinned[b] = pinned[c] = 1; }
  }

  // boundary edges get a constraint quadric so borders don't shrink
  {
    std::unordered_map<EdgeKey, int, EdgeKeyHash> ecount;
    ecount.reserve(nf * 3);
    for (int f = 0; f < nf; f++) {
      if (dead_face[f]) continue;
      for (int e = 0; e < 3; e++) {
        ecount[EdgeKey(F[3 * f + e], F[3 * f + (e + 1) % 3])]++;
      }
    }
    for (int f = 0; f < nf; f++) {
      if (dead_face[f]) continue;
      int vv[3] = {F[3 * f], F[3 * f + 1], F[3 * f + 2]};
      for (int e = 0; e < 3; e++) {
        int a = vv[e], b = vv[(e + 1) % 3];
        if (ecount[EdgeKey(a, b)] == 1) {
          // plane through edge, perpendicular to the face
          int c = vv[(e + 2) % 3];
          Vec3 fn = (V[b] - V[a]).cross(V[c] - V[a]);
          Vec3 en = (V[b] - V[a]).cross(fn);
          double nn = en.norm();
          if (nn > 1e-30) {
            en = en * (1.0 / nn);
            double d = -en.dot(V[a]);
            double w = (V[b] - V[a]).dot(V[b] - V[a]) * 10.0;
            Q[a].addPlane(en.x, en.y, en.z, d, w);
            Q[b].addPlane(en.x, en.y, en.z, d, w);
          }
        }
      }
    }
  }

  std::vector<uint32_t> stamp(nv, 0);
  std::vector<int> parent(nv);
  for (int i = 0; i < nv; i++) parent[i] = i;
  std::function<int(int)> find = [&](int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };

  auto best_point = [&](int a, int b, double* cost) {
    Quadric q = Q[a]; q.add(Q[b]);
    Vec3 cands[3] = {V[a], V[b], (V[a] + V[b]) * 0.5};
    int bi = 0; double bc = 1e300;
    for (int i = 0; i < 3; i++) {
      double c = q.eval(cands[i]);
      if (c < bc) { bc = c; bi = i; }
    }
    *cost = bc;
    return cands[bi];
  };

  std::priority_queue<HeapItem> heap;
  std::unordered_map<EdgeKey, char, EdgeKeyHash> in_heap;
  auto push_edge = [&](int a, int b) {
    a = find(a); b = find(b);
    if (a == b || pinned[a] || pinned[b]) return;
    double cost;
    best_point(a, b, &cost);
    heap.push({cost, a, b, stamp[a], stamp[b]});
  };

  for (int f = 0; f < nf; f++) {
    if (dead_face[f]) continue;
    for (int e = 0; e < 3; e++) {
      int a = F[3 * f + e], b = F[3 * f + (e + 1) % 3];
      EdgeKey k(a, b);
      if (!in_heap.count(k)) { in_heap[k] = 1; push_edge(a, b); }
    }
  }

  int live_faces = 0;
  for (int f = 0; f < nf; f++) if (!dead_face[f]) live_faces++;

  auto face_alive = [&](int f) {
    if (dead_face[f]) return false;
    int a = find(F[3 * f]), b = find(F[3 * f + 1]), c = find(F[3 * f + 2]);
    return a != b && b != c && a != c;
  };

  while (live_faces > target_faces && !heap.empty()) {
    HeapItem it = heap.top(); heap.pop();
    int a = find(it.a), b = find(it.b);
    if (a == b) continue;
    if (stamp[a] != it.stamp_a || stamp[b] != it.stamp_b) continue;  // stale
    if (pinned[a] || pinned[b]) continue;

    double cost;
    Vec3 np = best_point(a, b, &cost);

    // link condition: the common neighbor vertices of a and b must be exactly
    // the opposite vertices of the faces sharing edge (a,b); any extra common
    // neighbor means the collapse pinches the surface into a non-manifold fin.
    {
      auto neigh = [&](int v, std::vector<int>& out) {
        for (int f : vfaces[v]) {
          if (dead_face[f]) continue;
          int x = find(F[3 * f]), y = find(F[3 * f + 1]), z = find(F[3 * f + 2]);
          if (x == y || y == z || x == z) continue;
          if (x != v) out.push_back(x);
          if (y != v) out.push_back(y);
          if (z != v) out.push_back(z);
        }
        std::sort(out.begin(), out.end());
        out.erase(std::unique(out.begin(), out.end()), out.end());
      };
      std::vector<int> na, nb, common, opp;
      neigh(a, na); neigh(b, nb);
      std::set_intersection(na.begin(), na.end(), nb.begin(), nb.end(),
                            std::back_inserter(common));
      for (int f : vfaces[a]) {
        if (dead_face[f]) continue;
        int vv[3] = {find(F[3 * f]), find(F[3 * f + 1]), find(F[3 * f + 2])};
        bool ha = false, hb = false; int other = -1;
        for (int k = 0; k < 3; k++) {
          if (vv[k] == a) ha = true;
          else if (vv[k] == b) hb = true;
          else other = vv[k];
        }
        if (ha && hb && other >= 0) opp.push_back(other);
      }
      std::sort(opp.begin(), opp.end());
      opp.erase(std::unique(opp.begin(), opp.end()), opp.end());
      if (common != opp) continue;  // reject: would create non-manifold edge
    }

    // collapse b into a
    parent[b] = a;
    V[a] = np;
    Q[a].add(Q[b]);
    stamp[a]++;

    // merge face lists, count killed faces, re-push neighbor edges
    std::vector<int>& fa = vfaces[a];
    std::vector<int>& fb = vfaces[b];
    fa.insert(fa.end(), fb.begin(), fb.end());
    fb.clear();
    std::sort(fa.begin(), fa.end());
    fa.erase(std::unique(fa.begin(), fa.end()), fa.end());
    std::vector<int> keep;
    keep.reserve(fa.size());
    for (int f : fa) {
      if (dead_face[f]) continue;
      int x = find(F[3 * f]), y = find(F[3 * f + 1]), z = find(F[3 * f + 2]);
      if (x == y || y == z || x == z) {
        dead_face[f] = 1;
        live_faces--;
      } else {
        keep.push_back(f);
      }
    }
    fa.swap(keep);
    for (int f : fa) {
      for (int e = 0; e < 3; e++) {
        int u = find(F[3 * f + e]), v = find(F[3 * f + (e + 1) % 3]);
        if (u == a || v == a) push_edge(u, v);
      }
    }
  }

  // emit
  std::vector<int> OF;
  std::vector<int> FSRC;
  OF.reserve(3 * (size_t)live_faces);
  FSRC.reserve(live_faces);
  for (int f = 0; f < nf; f++) {
    if (dead_face[f]) continue;
    int a = find(F[3 * f]), b = find(F[3 * f + 1]), c = find(F[3 * f + 2]);
    if (a == b || b == c || a == c) continue;
    OF.push_back(a); OF.push_back(b); OF.push_back(c);
    FSRC.push_back(f);
  }
  std::vector<Vec3> OV = V;
  compact(OV, OF);
  write_out(OV, OF, out_v, out_nv, out_f, out_nf);
  if (out_fsrc) {
    *out_fsrc = (int*)std::malloc(sizeof(int) * FSRC.size());
    std::memcpy(*out_fsrc, FSRC.data(), sizeof(int) * FSRC.size());
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Isotropic explicit remeshing (Botsch-Kobbelt 2004, the algorithm behind
// pymeshlab's meshing_isotropic_explicit_remeshing, meshutils.py:196-230):
// per iteration, (1) split edges longer than 4/3*L, (2) collapse edges
// shorter than 4/5*L when that creates no edge over 4/3*L, (3) flip edges to
// equalize vertex valences toward 6, (4) tangential relaxation.  Selected-only
// semantics: an edge is operated on only when every incident face carries
// attr == sel_attr, and only vertices whose full face ring is selected are
// relaxed — the selection border stays fixed so the join remains watertight.
// face_attr is carried through (split children inherit the parent; flips keep
// their faces' attrs).  NULL face_attr/sel ignored => whole mesh remeshed.

namespace {

struct RMesh {
  std::vector<Vec3> V;
  std::vector<int> F;          // 3 per face, -1 marks dead
  std::vector<int> A;          // per-face attr
  std::vector<Vec3> orig_n;    // per-vertex normal of the input (for relax)

  int nf() const { return (int)(F.size() / 3); }
  bool face_alive(int f) const { return F[3 * f] >= 0; }
  void kill(int f) { F[3 * f] = F[3 * f + 1] = F[3 * f + 2] = -1; }
};

// edge -> incident faces map, rebuilt per pass (meshes here are <1e6 faces and
// remeshing runs a handful of times per job; simplicity over pointers)
void build_edge_faces(const RMesh& m,
                      std::unordered_map<EdgeKey, std::vector<int>,
                                         EdgeKeyHash>& ef) {
  ef.clear();
  for (int f = 0; f < m.nf(); f++) {
    if (!m.face_alive(f)) continue;
    for (int e = 0; e < 3; e++) {
      ef[EdgeKey(m.F[3 * f + e], m.F[3 * f + (e + 1) % 3])].push_back(f);
    }
  }
}

inline bool edge_selected(const RMesh& m, const std::vector<int>& faces,
                          int sel_attr) {
  if (sel_attr < 0) return true;
  for (int f : faces) if (m.A[f] != sel_attr) return false;
  return true;
}

void vertex_normals(RMesh& m) {
  m.orig_n.assign(m.V.size(), Vec3());
  for (int f = 0; f < m.nf(); f++) {
    if (!m.face_alive(f)) continue;
    int a = m.F[3 * f], b = m.F[3 * f + 1], c = m.F[3 * f + 2];
    Vec3 n = (m.V[b] - m.V[a]).cross(m.V[c] - m.V[a]);
    m.orig_n[a] = m.orig_n[a] + n;
    m.orig_n[b] = m.orig_n[b] + n;
    m.orig_n[c] = m.orig_n[c] + n;
  }
  for (auto& n : m.orig_n) {
    double l = n.norm();
    if (l > 1e-30) n = n * (1.0 / l);
  }
}

}  // namespace

int meshops_remesh(const float* verts, int nv, const int* tris, int nf,
                   float target_len, int iterations,
                   const int* face_attr, int sel_attr,
                   float** out_v, int* out_nv, int** out_f, int* out_nf,
                   int** out_attr) {
  RMesh m;
  m.V.resize(nv);
  for (int i = 0; i < nv; i++)
    m.V[i] = Vec3(verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
  m.F.assign(tris, tris + 3 * (size_t)nf);
  m.A.resize(nf);
  for (int f = 0; f < nf; f++) m.A[f] = face_attr ? face_attr[f] : 0;
  if (!face_attr) sel_attr = -1;

  const double L = target_len;
  const double hi = 4.0 / 3.0 * L, lo = 4.0 / 5.0 * L;
  std::unordered_map<EdgeKey, std::vector<int>, EdgeKeyHash> ef;

  for (int it = 0; it < iterations; it++) {
    // ---- 1. split long edges
    build_edge_faces(m, ef);
    // collect first (splitting mutates the face list)
    std::vector<std::pair<int, int>> to_split;
    for (auto& kv : ef) {
      int a = (int)(kv.first.k >> 32), b = (int)(kv.first.k & 0xffffffffu);
      if ((m.V[a] - m.V[b]).norm() <= hi) continue;
      if (!edge_selected(m, kv.second, sel_attr)) continue;
      to_split.push_back({a, b});
    }
    for (auto& e : to_split) {
      int a = e.first, b = e.second;
      auto itf = ef.find(EdgeKey(a, b));
      if (itf == ef.end()) continue;
      std::vector<int> faces;
      for (int f : itf->second)
        if (m.face_alive(f)) faces.push_back(f);
      if (faces.empty()) continue;
      int mid = (int)m.V.size();
      m.V.push_back((m.V[a] + m.V[b]) * 0.5);
      ef.erase(itf);
      // incremental edge->faces maintenance: replace the dead parent in the
      // wing edges' lists with the right child, register the new mid edges
      auto rep = [&](int x, int y, int oldf, int newf) {
        auto it = ef.find(EdgeKey(x, y));
        if (it == ef.end()) return;
        for (auto& q : it->second)
          if (q == oldf) q = newf;
      };
      for (int f : faces) {
        int fv[3] = {m.F[3 * f], m.F[3 * f + 1], m.F[3 * f + 2]};
        int attr = m.A[f];
        for (int k = 0; k < 3; k++) {
          int u = fv[k], v = fv[(k + 1) % 3], w = fv[(k + 2) % 3];
          if ((u == a && v == b) || (u == b && v == a)) {
            m.kill(f);
            int c1 = m.nf();
            m.F.push_back(u); m.F.push_back(mid); m.F.push_back(w);
            m.A.push_back(attr);
            int c2 = m.nf();
            m.F.push_back(mid); m.F.push_back(v); m.F.push_back(w);
            m.A.push_back(attr);
            rep(u, w, f, c1);
            rep(v, w, f, c2);
            ef[EdgeKey(u, mid)].push_back(c1);
            ef[EdgeKey(mid, v)].push_back(c2);
            auto& mw = ef[EdgeKey(mid, w)];
            mw.push_back(c1); mw.push_back(c2);
            break;
          }
        }
      }
    }
    // children longer than hi (possible on anisotropic input) are handled by
    // the next iteration's split pass.

    // ---- 2. collapse short edges
    build_edge_faces(m, ef);
    std::vector<char> vert_dead(m.V.size(), 0);
    std::vector<std::vector<int>> vf(m.V.size());
    for (int f = 0; f < m.nf(); f++) {
      if (!m.face_alive(f)) continue;
      for (int e = 0; e < 3; e++) vf[m.F[3 * f + e]].push_back(f);
    }
    // selection-border / boundary verts are immovable
    std::vector<char> fixed(m.V.size(), 0);
    for (auto& kv : ef) {
      int a = (int)(kv.first.k >> 32), b = (int)(kv.first.k & 0xffffffffu);
      bool border = kv.second.size() != 2 ||
                    !edge_selected(m, kv.second, sel_attr);
      if (border) { fixed[a] = 1; fixed[b] = 1; }
    }
    for (auto& kv : ef) {
      int a = (int)(kv.first.k >> 32), b = (int)(kv.first.k & 0xffffffffu);
      if (vert_dead[a] || vert_dead[b]) continue;
      if (fixed[a] && fixed[b]) continue;
      if (kv.second.size() != 2) continue;
      if (!edge_selected(m, kv.second, sel_attr)) continue;
      double len = (m.V[a] - m.V[b]).norm();
      if (len >= lo) continue;
      // collapse target: midpoint, or the fixed endpoint
      Vec3 np = fixed[a] ? m.V[a] : (fixed[b] ? m.V[b] : (m.V[a] + m.V[b]) * 0.5);
      // link condition + no new long edges
      std::vector<int> na, nb;
      auto ring = [&](int v, std::vector<int>& out) {
        for (int f : vf[v]) {
          if (!m.face_alive(f)) continue;
          for (int e = 0; e < 3; e++) {
            int u = m.F[3 * f + e];
            if (u != v) out.push_back(u);
          }
        }
        std::sort(out.begin(), out.end());
        out.erase(std::unique(out.begin(), out.end()), out.end());
      };
      ring(a, na); ring(b, nb);
      std::vector<int> common;
      std::set_intersection(na.begin(), na.end(), nb.begin(), nb.end(),
                            std::back_inserter(common));
      if (common.size() != 2) continue;  // manifold interior edge: exactly 2
      bool ok = true;
      for (int u : na) if (u != b && (m.V[u] - np).norm() > hi) { ok = false; break; }
      if (ok) for (int u : nb) if (u != a && (m.V[u] - np).norm() > hi) { ok = false; break; }
      if (!ok) continue;
      // collapse b into a
      m.V[a] = np;
      vert_dead[b] = 1;
      for (int f : vf[b]) {
        if (!m.face_alive(f)) continue;
        int* fv = &m.F[3 * f];
        bool hasA = fv[0] == a || fv[1] == a || fv[2] == a;
        for (int e = 0; e < 3; e++) if (fv[e] == b) fv[e] = a;
        if (hasA || fv[0] == fv[1] || fv[1] == fv[2] || fv[0] == fv[2]) {
          m.kill(f);
        } else {
          vf[a].push_back(f);
        }
      }
      fixed[a] = 1;  // conservatively freeze around fresh collapses this pass
    }

    // ---- 3. valence-equalizing flips
    build_edge_faces(m, ef);
    std::vector<int> val(m.V.size(), 0);
    for (auto& kv : ef) {
      val[(int)(kv.first.k >> 32)]++;
      val[(int)(kv.first.k & 0xffffffffu)]++;
    }
    std::vector<char> boundary_v(m.V.size(), 0);
    for (auto& kv : ef)
      if (kv.second.size() != 2) {
        boundary_v[(int)(kv.first.k >> 32)] = 1;
        boundary_v[(int)(kv.first.k & 0xffffffffu)] = 1;
      }
    auto tgt = [&](int v) { return boundary_v[v] ? 4 : 6; };
    // snapshot candidates: mutating ef while range-iterating it invalidates
    // the iterator (rehash on insert)
    std::vector<std::pair<EdgeKey, std::pair<int, int>>> flip_cands;
    for (auto& kv : ef) {
      if (kv.second.size() != 2) continue;
      if (!edge_selected(m, kv.second, sel_attr)) continue;
      flip_cands.push_back({kv.first, {kv.second[0], kv.second[1]}});
    }
    for (auto& cand : flip_cands) {
      int f1 = cand.second.first, f2 = cand.second.second;
      if (!m.face_alive(f1) || !m.face_alive(f2)) continue;
      int a = (int)(cand.first.k >> 32), b = (int)(cand.first.k & 0xffffffffu);
      // earlier flips this pass can leave stale entries: require both faces
      // to still contain the edge
      auto has_edge = [&](int f) {
        int cnt = 0;
        for (int e = 0; e < 3; e++) {
          int u = m.F[3 * f + e];
          if (u == a || u == b) cnt++;
        }
        return cnt == 2;
      };
      if (!has_edge(f1) || !has_edge(f2)) continue;
      auto opposite = [&](int f) {
        for (int e = 0; e < 3; e++) {
          int u = m.F[3 * f + e];
          if (u != a && u != b) return u;
        }
        return -1;
      };
      int c = opposite(f1), d = opposite(f2);
      if (c < 0 || d < 0 || c == d) continue;
      if (ef.count(EdgeKey(c, d))) continue;  // flipped edge already exists
      int dev_now = std::abs(val[a] - tgt(a)) + std::abs(val[b] - tgt(b)) +
                    std::abs(val[c] - tgt(c)) + std::abs(val[d] - tgt(d));
      int dev_new = std::abs(val[a] - 1 - tgt(a)) + std::abs(val[b] - 1 - tgt(b)) +
                    std::abs(val[c] + 1 - tgt(c)) + std::abs(val[d] + 1 - tgt(d));
      if (dev_new >= dev_now) continue;
      // geometric guard: keep flipped triangles non-degenerate
      Vec3 n1 = (m.V[d] - m.V[a]).cross(m.V[c] - m.V[a]);
      Vec3 n2 = (m.V[c] - m.V[b]).cross(m.V[d] - m.V[b]);
      if (n1.norm() < 1e-24 || n2.norm() < 1e-24 || n1.dot(n2) <= 0) continue;
      // orient children consistently with f1's winding (a->b->c)
      m.F[3 * f1] = a; m.F[3 * f1 + 1] = d; m.F[3 * f1 + 2] = c;
      m.F[3 * f2] = d; m.F[3 * f2 + 1] = b; m.F[3 * f2 + 2] = c;
      val[a]--; val[b]--; val[c]++; val[d]++;
      ef.erase(EdgeKey(a, b));
      std::vector<int> nfcd = {f1, f2};
      ef[EdgeKey(c, d)] = nfcd;  // approximate update; rebuilt next pass
    }

    // ---- 4. tangential relaxation
    build_edge_faces(m, ef);
    vertex_normals(m);
    std::vector<Vec3> centroid(m.V.size(), Vec3());
    std::vector<int> cnt(m.V.size(), 0);
    std::vector<char> movable(m.V.size(), 1);
    for (auto& kv : ef) {
      int a = (int)(kv.first.k >> 32), b = (int)(kv.first.k & 0xffffffffu);
      centroid[a] = centroid[a] + m.V[b]; cnt[a]++;
      centroid[b] = centroid[b] + m.V[a]; cnt[b]++;
      bool border = kv.second.size() != 2 ||
                    !edge_selected(m, kv.second, sel_attr);
      if (border) { movable[a] = 0; movable[b] = 0; }
    }
    for (size_t v = 0; v < m.V.size(); v++) {
      if (!movable[v] || cnt[v] == 0) continue;
      Vec3 g = centroid[v] * (1.0 / cnt[v]);
      Vec3 d = g - m.V[v];
      const Vec3& n = m.orig_n[v];
      d = d - n * d.dot(n);  // tangent-plane projection keeps the surface
      m.V[v] = m.V[v] + d * 0.5;
    }
  }

  // emit (drop dead faces, compact verts)
  std::vector<int> OF;
  std::vector<int> OA;
  for (int f = 0; f < m.nf(); f++) {
    if (!m.face_alive(f)) continue;
    OF.push_back(m.F[3 * f]); OF.push_back(m.F[3 * f + 1]);
    OF.push_back(m.F[3 * f + 2]);
    OA.push_back(m.A[f]);
  }
  compact(m.V, OF);
  write_out(m.V, OF, out_v, out_nv, out_f, out_nf);
  if (out_attr) {
    *out_attr = (int*)std::malloc(sizeof(int) * OA.size());
    std::memcpy(*out_attr, OA.data(), sizeof(int) * OA.size());
  }
  return 0;
}

// Merge vertices within eps, drop degenerate/duplicate faces, remove
// connected components with fewer than min_faces faces or bbox diagonal
// below min_diameter (fraction of total bbox diagonal if <= 1).
int meshops_clean(const float* verts, int nv, const int* tris, int nf,
                  float merge_eps, int min_faces, float min_diameter,
                  float** out_v, int* out_nv, int** out_f, int* out_nf) {
  std::vector<Vec3> V(nv);
  for (int i = 0; i < nv; i++)
    V[i] = Vec3(verts[3 * i], verts[3 * i + 1], verts[3 * i + 2]);
  std::vector<int> F(tris, tris + 3 * (size_t)nf);

  // 1. merge close vertices via eps-grid
  std::vector<int> remap(nv);
  if (merge_eps > 0) {
    std::unordered_map<uint64_t, int> grid;
    grid.reserve(nv);
    double inv = 1.0 / merge_eps;
    // exact cell identity: pack the three cell coords into 21 bits each
    // (an xor-of-products hash used as identity merges far-apart vertices on
    // systematic collisions — observed corrupting subdivided meshes)
    auto cell = [](double x) {
      int64_t g = (int64_t)std::llround(x);
      const int64_t lim = (1LL << 20) - 1;
      if (g > lim) g = lim;
      if (g < -lim) g = -lim;
      return (uint64_t)(g + (1LL << 20));
    };
    for (int i = 0; i < nv; i++) {
      uint64_t key = (cell(V[i].x * inv) << 42) | (cell(V[i].y * inv) << 21) |
                     cell(V[i].z * inv);
      auto itr = grid.find(key);
      if (itr == grid.end()) { grid[key] = i; remap[i] = i; }
      else remap[i] = itr->second;
    }
  } else {
    for (int i = 0; i < nv; i++) remap[i] = i;
  }
  for (auto& idx : F) idx = remap[idx];

  // 2. drop degenerate and duplicate faces
  std::vector<int> F2;
  F2.reserve(F.size());
  std::unordered_map<uint64_t, char> seen;
  seen.reserve(nf);
  for (int f = 0; f < nf; f++) {
    int a = F[3 * f], b = F[3 * f + 1], c = F[3 * f + 2];
    if (a == b || b == c || a == c) continue;
    int s[3] = {a, b, c};
    std::sort(s, s + 3);
    uint64_t key = ((uint64_t)s[0] * 73856093ULL) ^ ((uint64_t)s[1] * 19349663ULL)
                   ^ ((uint64_t)s[2] * 83492791ULL);
    if (seen.count(key)) continue;
    seen[key] = 1;
    F2.push_back(a); F2.push_back(b); F2.push_back(c);
  }

  // 3. connected components over shared vertices (union-find)
  int nf2 = (int)(F2.size() / 3);
  std::vector<int> parent(nv);
  for (int i = 0; i < nv; i++) parent[i] = i;
  std::function<int(int)> find = [&](int x) {
    while (parent[x] != x) { parent[x] = parent[parent[x]]; x = parent[x]; }
    return x;
  };
  for (int f = 0; f < nf2; f++) {
    int a = find(F2[3 * f]), b = find(F2[3 * f + 1]), c = find(F2[3 * f + 2]);
    parent[b] = a; parent[c] = find(a);
  }
  // component stats
  std::unordered_map<int, int> comp_faces;
  std::unordered_map<int, Vec3> cmin, cmax;
  for (int f = 0; f < nf2; f++) {
    int r = find(F2[3 * f]);
    comp_faces[r]++;
    for (int e = 0; e < 3; e++) {
      const Vec3& p = V[F2[3 * f + e]];
      auto it = cmin.find(r);
      if (it == cmin.end()) { cmin[r] = p; cmax[r] = p; }
      else {
        Vec3& lo = cmin[r]; Vec3& hi = cmax[r];
        lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
        hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
      }
    }
  }
  // global diagonal for relative min_diameter
  double gdiag = 0;
  {
    Vec3 lo = V.empty() ? Vec3() : V[0], hi = lo;
    for (auto& p : V) {
      lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
      hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
    }
    gdiag = (hi - lo).norm();
  }
  double min_diag = min_diameter <= 1.0 ? min_diameter * 0.01 * gdiag : min_diameter;

  std::vector<int> F3;
  F3.reserve(F2.size());
  for (int f = 0; f < nf2; f++) {
    int r = find(F2[3 * f]);
    double diag = (cmax[r] - cmin[r]).norm();
    if (comp_faces[r] < min_faces && diag < min_diag) continue;
    F3.push_back(F2[3 * f]); F3.push_back(F2[3 * f + 1]); F3.push_back(F2[3 * f + 2]);
  }

  compact(V, F3);
  write_out(V, F3, out_v, out_nv, out_f, out_nf);
  return 0;
}

}  // extern "C"
