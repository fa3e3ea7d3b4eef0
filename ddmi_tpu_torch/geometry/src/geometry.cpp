// DDMI-TPU native geometry library (host-side, CPU).
//
// C++ replacements for the reference's vendored Cython/CUDA geometry stack
// (convocc/src/utils/lib{mcubes,mise,simplify,kdtree,mesh,voxelize} —
// SURVEY.md §2.7), re-implemented from scratch behind a plain C ABI for
// ctypes binding (no pybind11 in this environment).
//
// Components:
//   * iso-surface extraction: marching tetrahedra over a dense value grid
//     (6-tet cube decomposition; same iso-surface as the reference's
//     marching cubes, simpler tables; vertices linearly interpolated).
//   * MISE: multiresolution iso-surface point proposal (active-cell octree
//     refinement driving batched device-side evaluations).
//   * quadric edge-collapse mesh simplification (Garland–Heckbert).
//   * 3D kd-tree nearest neighbour (chamfer / mesh eval).
//   * point-in-mesh via z-ray parity with a 2D triangle hash grid.
//   * mesh voxelization (surface rasterization + parity fill).

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <map>
#include <unordered_map>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Iso-surface extraction (marching tetrahedra)
// ---------------------------------------------------------------------------

namespace {

struct V3 {
  double x, y, z;
};

// The 6-tetrahedron decomposition of a unit cube (corner indices 0..7 with
// corner c = (x + 2y + 4z) bit layout).  Must tile the cube exactly — the
// volume test in tests/test_geometry_parity.py catches a bad decomposition.
static const int kTets6[6][4] = {
    {0, 1, 3, 7}, {0, 1, 7, 5}, {0, 5, 7, 4},
    {0, 3, 2, 7}, {0, 2, 6, 7}, {0, 6, 4, 7},
};

struct MeshAccum {
  std::vector<double> verts;
  std::vector<int64_t> tris;
  // edge key -> vertex index (deduplicate shared edge vertices)
  std::unordered_map<uint64_t, int64_t> edge_cache;
};

static inline uint64_t EdgeKey(uint64_t a, uint64_t b) {
  if (a > b) std::swap(a, b);
  return (a << 32) | b;
}

static int64_t EmitVertex(MeshAccum* m, uint64_t ia, uint64_t ib, const V3& pa,
                          const V3& pb, double va, double vb, double iso) {
  uint64_t key = EdgeKey(ia, ib);
  auto it = m->edge_cache.find(key);
  if (it != m->edge_cache.end()) return it->second;
  double t = (iso - va) / (vb - va);
  if (!std::isfinite(t)) t = 0.5;
  t = std::min(1.0, std::max(0.0, t));
  V3 p{pa.x + t * (pb.x - pa.x), pa.y + t * (pb.y - pa.y),
       pa.z + t * (pb.z - pa.z)};
  int64_t idx = (int64_t)(m->verts.size() / 3);
  m->verts.push_back(p.x);
  m->verts.push_back(p.y);
  m->verts.push_back(p.z);
  m->edge_cache.emplace(key, idx);
  return idx;
}

static void DoTet(MeshAccum* m, const uint64_t gid[4], const V3 p[4],
                  const double v[4], double iso) {
  int inside = 0;
  for (int i = 0; i < 4; i++)
    if (v[i] < iso) inside |= (1 << i);
  if (inside == 0 || inside == 15) return;

  // centroid of the "inside" (v < iso) vertices — used to orient triangles
  // with outward normals regardless of case-table winding
  double cx = 0, cy = 0, cz = 0;
  int nin = 0;
  for (int i = 0; i < 4; i++) {
    if (v[i] < iso) {
      cx += p[i].x; cy += p[i].y; cz += p[i].z; nin++;
    }
  }
  cx /= nin; cy /= nin; cz /= nin;

  auto tri = [&](int a0, int b0, int a1, int b1, int a2, int b2) {
    int64_t i0 = EmitVertex(m, gid[a0], gid[b0], p[a0], p[b0], v[a0], v[b0], iso);
    int64_t i1 = EmitVertex(m, gid[a1], gid[b1], p[a1], p[b1], v[a1], v[b1], iso);
    int64_t i2 = EmitVertex(m, gid[a2], gid[b2], p[a2], p[b2], v[a2], v[b2], iso);
    if (i0 == i1 || i1 == i2 || i0 == i2) return;
    const double* A = &m->verts[i0 * 3];
    const double* B = &m->verts[i1 * 3];
    const double* C = &m->verts[i2 * 3];
    double ux = B[0]-A[0], uy = B[1]-A[1], uz = B[2]-A[2];
    double wx = C[0]-A[0], wy = C[1]-A[1], wz = C[2]-A[2];
    double nx = uy*wz - uz*wy, ny = uz*wx - ux*wz, nz = ux*wy - uy*wx;
    double tx = (A[0]+B[0]+C[0])/3 - cx, ty = (A[1]+B[1]+C[1])/3 - cy,
           tz = (A[2]+B[2]+C[2])/3 - cz;
    if (nx*tx + ny*ty + nz*tz < 0) std::swap(i1, i2);  // outward normals
    m->tris.push_back(i0);
    m->tris.push_back(i1);
    m->tris.push_back(i2);
  };

  switch (inside) {
    case 1:  tri(0,1, 0,2, 0,3); break;
    case 14: tri(0,1, 0,3, 0,2); break;
    case 2:  tri(1,0, 1,3, 1,2); break;
    case 13: tri(1,0, 1,2, 1,3); break;
    case 4:  tri(2,0, 2,1, 2,3); break;
    case 11: tri(2,0, 2,3, 2,1); break;
    case 8:  tri(3,0, 3,2, 3,1); break;
    case 7:  tri(3,0, 3,1, 3,2); break;
    case 3:  // 0,1 inside
      tri(0,2, 1,2, 1,3);
      tri(0,2, 1,3, 0,3);
      break;
    case 12:
      tri(0,2, 1,3, 1,2);
      tri(0,2, 0,3, 1,3);
      break;
    case 5:  // 0,2 inside
      tri(0,1, 2,3, 2,1);
      tri(0,1, 0,3, 2,3);
      break;
    case 10:
      tri(0,1, 2,1, 2,3);
      tri(0,1, 2,3, 0,3);
      break;
    case 6:  // 1,2 inside
      tri(1,0, 2,0, 2,3);
      tri(1,0, 2,3, 1,3);
      break;
    case 9:
      tri(1,0, 2,3, 2,0);
      tri(1,0, 1,3, 2,3);
      break;
  }
}

}  // namespace

// Extract iso-surface from a dense grid `values` of shape (nx, ny, nz),
// C-order (x-major as numpy default: index = (x*ny + y)*nz + z).
// Writes counts, returns an opaque handle; call marching_cubes_get(handle)
// to copy data out and free it (re-entrant: concurrent runs each own their
// result).
int64_t marching_cubes_run(const double* values, int64_t nx, int64_t ny,
                           int64_t nz, double iso, int64_t* n_verts,
                           int64_t* n_tris) {
  MeshAccum* m = new MeshAccum();

  auto val = [&](int64_t x, int64_t y, int64_t z) {
    return values[(x * ny + y) * nz + z];
  };
  auto gidx = [&](int64_t x, int64_t y, int64_t z) -> uint64_t {
    return (uint64_t)((x * ny + y) * nz + z);
  };

  for (int64_t x = 0; x + 1 < nx; x++) {
    for (int64_t y = 0; y + 1 < ny; y++) {
      for (int64_t z = 0; z + 1 < nz; z++) {
        // cube corners: bit0 = +x, bit1 = +y, bit2 = +z
        double cv[8];
        V3 cp[8];
        uint64_t cg[8];
        bool lo = false, hi = false;
        for (int c = 0; c < 8; c++) {
          int64_t cx = x + (c & 1), cy = y + ((c >> 1) & 1),
                  cz = z + ((c >> 2) & 1);
          cv[c] = val(cx, cy, cz);
          cp[c] = V3{(double)cx, (double)cy, (double)cz};
          cg[c] = gidx(cx, cy, cz);
          (cv[c] < iso ? lo : hi) = true;
        }
        if (!lo || !hi) continue;
        for (int t = 0; t < 6; t++) {
          uint64_t gid[4];
          V3 p[4];
          double v[4];
          for (int i = 0; i < 4; i++) {
            int c = kTets6[t][i];
            gid[i] = cg[c];
            p[i] = cp[c];
            v[i] = cv[c];
          }
          DoTet(m, gid, p, v, iso);
        }
      }
    }
  }
  *n_verts = (int64_t)(m->verts.size() / 3);
  *n_tris = (int64_t)(m->tris.size() / 3);
  return (int64_t)(intptr_t)m;
}

int64_t marching_cubes_get(int64_t handle, double* verts_out,
                           int64_t* tris_out) {
  MeshAccum* m = (MeshAccum*)(intptr_t)handle;
  if (!m) return -1;
  std::memcpy(verts_out, m->verts.data(), m->verts.size() * sizeof(double));
  std::memcpy(tris_out, m->tris.data(), m->tris.size() * sizeof(int64_t));
  delete m;
  return 0;
}

// ---------------------------------------------------------------------------
// MISE — multiresolution iso-surface point proposal
// ---------------------------------------------------------------------------
//
// API mirrors convocc/src/utils/libmise (mise.pyx): construct with
// (resolution_0, upsampling_steps, threshold); loop { query() -> points;
// evaluate on device; update(points, values) } until query() is empty;
// to_dense() -> dense grid at final resolution.

namespace {

struct MiseState {
  int64_t res0;          // base resolution (cells per axis at level 0)
  int64_t steps;         // upsampling steps
  int64_t res_final;     // res0 << steps  (grid coords span 0..res_final)
  double threshold;
  // evaluated grid values, keyed by final-resolution coordinate
  std::unordered_map<uint64_t, double> values;
  // active cells at current level: (x,y,z, size) with size = cell edge in
  // final-res units
  std::vector<std::array<int64_t, 4>> active;
  int64_t level = 0;
  bool first_query_done = false;

  uint64_t key(int64_t x, int64_t y, int64_t z) const {
    return ((uint64_t)x << 42) | ((uint64_t)y << 21) | (uint64_t)z;
  }
};

static std::vector<MiseState*> g_mise;

}  // namespace

int64_t mise_create(int64_t res0, int64_t steps, double threshold) {
  auto* s = new MiseState();
  s->res0 = res0;
  s->steps = steps;
  s->res_final = res0 << steps;
  s->threshold = threshold;
  g_mise.push_back(s);
  return (int64_t)(g_mise.size() - 1);
}

void mise_destroy(int64_t h) {
  if (h >= 0 && h < (int64_t)g_mise.size() && g_mise[h]) {
    delete g_mise[h];
    g_mise[h] = nullptr;
  }
}

// Writes up to max_pts (x,y,z) int64 grid coords (final-res units) of points
// needing evaluation; returns count.
int64_t mise_query(int64_t h, int64_t* pts_out, int64_t max_pts) {
  MiseState* s = g_mise[h];
  std::vector<std::array<int64_t, 3>> need;

  if (!s->first_query_done) {
    int64_t step = s->res_final / s->res0;
    for (int64_t x = 0; x <= s->res_final; x += step)
      for (int64_t y = 0; y <= s->res_final; y += step)
        for (int64_t z = 0; z <= s->res_final; z += step)
          need.push_back({x, y, z});
  } else {
    for (auto& c : s->active) {
      int64_t sz = c[3];
      for (int dx = 0; dx <= 2; dx++)
        for (int dy = 0; dy <= 2; dy++)
          for (int dz = 0; dz <= 2; dz++) {
            int64_t x = c[0] + dx * sz / 2, y = c[1] + dy * sz / 2,
                    z = c[2] + dz * sz / 2;
            if (!s->values.count(s->key(x, y, z)))
              need.push_back({x, y, z});
          }
    }
    // dedupe
    std::sort(need.begin(), need.end());
    need.erase(std::unique(need.begin(), need.end()), need.end());
  }

  int64_t n = std::min((int64_t)need.size(), max_pts);
  for (int64_t i = 0; i < n; i++) {
    pts_out[i * 3 + 0] = need[i][0];
    pts_out[i * 3 + 1] = need[i][1];
    pts_out[i * 3 + 2] = need[i][2];
  }
  return n;
}

void mise_update(int64_t h, const int64_t* pts, const double* vals,
                 int64_t n) {
  MiseState* s = g_mise[h];
  for (int64_t i = 0; i < n; i++)
    s->values[s->key(pts[i * 3], pts[i * 3 + 1], pts[i * 3 + 2])] =
        vals[i];

  // determine active cells at the current level and refine one level
  std::vector<std::array<int64_t, 4>> parents;
  if (!s->first_query_done) {
    int64_t sz = s->res_final / s->res0;
    for (int64_t x = 0; x < s->res_final; x += sz)
      for (int64_t y = 0; y < s->res_final; y += sz)
        for (int64_t z = 0; z < s->res_final; z += sz)
          parents.push_back({x, y, z, sz});
    s->first_query_done = true;
  } else {
    // children of previous active cells
    for (auto& c : s->active) {
      int64_t sz = c[3] / 2;
      if (sz < 1) continue;
      for (int dx = 0; dx < 2; dx++)
        for (int dy = 0; dy < 2; dy++)
          for (int dz = 0; dz < 2; dz++)
            parents.push_back(
                {c[0] + dx * sz, c[1] + dy * sz, c[2] + dz * sz, sz});
    }
    s->level++;
  }

  s->active.clear();
  if (s->level >= s->steps) return;  // fully refined
  for (auto& c : parents) {
    if (c[3] <= 1) continue;
    bool lo = false, hi = false, missing = false;
    for (int dx = 0; dx < 2 && !missing; dx++)
      for (int dy = 0; dy < 2 && !missing; dy++)
        for (int dz = 0; dz < 2 && !missing; dz++) {
          auto it = s->values.find(s->key(c[0] + dx * c[3], c[1] + dy * c[3],
                                          c[2] + dz * c[3]));
          if (it == s->values.end()) {
            missing = true;
            break;
          }
          (it->second < s->threshold ? lo : hi) = true;
        }
    if (!missing && lo && hi) s->active.push_back(c);
  }
}

// Dense grid (res_final+1)^3, unknown points filled from the containing
// coarse cell's nearest evaluated corner.
void mise_to_dense(int64_t h, double* out) {
  MiseState* s = g_mise[h];
  int64_t n = s->res_final + 1;
  int64_t base = s->res_final / s->res0;  // base cell size
  for (int64_t x = 0; x < n; x++) {
    for (int64_t y = 0; y < n; y++) {
      for (int64_t z = 0; z < n; z++) {
        auto it = s->values.find(s->key(x, y, z));
        double v;
        if (it != s->values.end()) {
          v = it->second;
        } else {
          // nearest evaluated ancestor corner: snap to successively coarser
          // lattices until found
          v = 0.0;
          for (int64_t sz = 2; sz <= base; sz *= 2) {
            int64_t qx = (x / sz) * sz, qy = (y / sz) * sz, qz = (z / sz) * sz;
            auto jt = s->values.find(s->key(qx, qy, qz));
            if (jt != s->values.end()) {
              v = jt->second;
              break;
            }
          }
        }
        out[(x * n + y) * n + z] = v;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Quadric edge-collapse mesh simplification (Garland–Heckbert)
// ---------------------------------------------------------------------------

namespace {

struct Quadric {
  double m[10] = {0};  // symmetric 4x4: xx xy xz xw yy yz yw zz zw ww
  void add_plane(double a, double b, double c, double d) {
    m[0] += a * a; m[1] += a * b; m[2] += a * c; m[3] += a * d;
    m[4] += b * b; m[5] += b * c; m[6] += b * d;
    m[7] += c * c; m[8] += c * d; m[9] += d * d;
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; i++) m[i] += o.m[i];
  }
  double eval(double x, double y, double z) const {
    return m[0]*x*x + 2*m[1]*x*y + 2*m[2]*x*z + 2*m[3]*x +
           m[4]*y*y + 2*m[5]*y*z + 2*m[6]*y +
           m[7]*z*z + 2*m[8]*z + m[9];
  }
};

}  // namespace

struct SimpResult {
  std::vector<double> verts;
  std::vector<int64_t> tris;
};

// Simplify to approximately target_tris triangles; aggressiveness as in
// Fast-Quadric (threshold grows per pass).  Writes counts, returns an opaque
// handle for mesh_simplify_get (re-entrant).
int64_t mesh_simplify_run(const double* verts, int64_t nv,
                          const int64_t* tris, int64_t nt,
                          int64_t target_tris, double aggressiveness,
                          int64_t* out_nv, int64_t* out_nt) {
  std::vector<std::array<double, 3>> V(nv);
  for (int64_t i = 0; i < nv; i++)
    V[i] = {verts[i * 3], verts[i * 3 + 1], verts[i * 3 + 2]};
  std::vector<std::array<int64_t, 3>> T(nt);
  for (int64_t i = 0; i < nt; i++)
    T[i] = {tris[i * 3], tris[i * 3 + 1], tris[i * 3 + 2]};

  std::vector<Quadric> Q(nv);
  std::vector<char> dead_tri(nt, 0);
  std::vector<int64_t> remap(nv);
  for (int64_t i = 0; i < nv; i++) remap[i] = i;

  auto find = [&](int64_t v) {
    while (remap[v] != v) {
      remap[v] = remap[remap[v]];
      v = remap[v];
    }
    return v;
  };

  auto compute_quadrics = [&]() {
    std::fill(Q.begin(), Q.end(), Quadric());
    for (int64_t i = 0; i < nt; i++) {
      if (dead_tri[i]) continue;
      auto a = V[find(T[i][0])], b = V[find(T[i][1])], c = V[find(T[i][2])];
      double ux = b[0]-a[0], uy = b[1]-a[1], uz = b[2]-a[2];
      double vx = c[0]-a[0], vy = c[1]-a[1], vz = c[2]-a[2];
      double n0 = uy*vz - uz*vy, n1 = uz*vx - ux*vz, n2 = ux*vy - uy*vx;
      double len = std::sqrt(n0*n0 + n1*n1 + n2*n2);
      if (len < 1e-20) continue;
      n0 /= len; n1 /= len; n2 /= len;
      double d = -(n0*a[0] + n1*a[1] + n2*a[2]);
      Quadric q;
      q.add_plane(n0, n1, n2, d);
      for (int k = 0; k < 3; k++) Q[find(T[i][k])].add(q);
    }
  };

  int64_t alive = nt;
  compute_quadrics();
  for (int pass = 0; pass < 100 && alive > target_tris; pass++) {
    double threshold = 1e-9 * std::pow((double)(pass + 3), aggressiveness);
    bool changed = false;
    for (int64_t i = 0; i < nt && alive > target_tris; i++) {
      if (dead_tri[i]) continue;
      for (int e = 0; e < 3; e++) {
        int64_t v0 = find(T[i][e]), v1 = find(T[i][(e + 1) % 3]);
        if (v0 == v1) continue;
        // candidate midpoint collapse
        double mx = 0.5 * (V[v0][0] + V[v1][0]);
        double my = 0.5 * (V[v0][1] + V[v1][1]);
        double mz = 0.5 * (V[v0][2] + V[v1][2]);
        Quadric q = Q[v0];
        q.add(Q[v1]);
        if (q.eval(mx, my, mz) > threshold) continue;
        // collapse v1 -> v0
        V[v0] = {mx, my, mz};
        remap[v1] = v0;
        Q[v0] = q;
        changed = true;
        // kill degenerate triangles
        for (int64_t j = 0; j < nt; j++) {
          if (dead_tri[j]) continue;
          int64_t a = find(T[j][0]), b = find(T[j][1]), c = find(T[j][2]);
          if (a == b || b == c || a == c) {
            dead_tri[j] = 1;
            alive--;
          }
        }
        break;
      }
    }
    if (!changed) {
      if (threshold > 1e3) break;
      continue;
    }
    compute_quadrics();
  }

  // compact output
  SimpResult* res = new SimpResult();
  std::unordered_map<int64_t, int64_t> vmap;
  for (int64_t i = 0; i < nt; i++) {
    if (dead_tri[i]) continue;
    int64_t idx[3];
    for (int k = 0; k < 3; k++) {
      int64_t v = find(T[i][k]);
      auto it = vmap.find(v);
      if (it == vmap.end()) {
        int64_t ni = (int64_t)(res->verts.size() / 3);
        vmap.emplace(v, ni);
        res->verts.push_back(V[v][0]);
        res->verts.push_back(V[v][1]);
        res->verts.push_back(V[v][2]);
        idx[k] = ni;
      } else {
        idx[k] = it->second;
      }
    }
    res->tris.push_back(idx[0]);
    res->tris.push_back(idx[1]);
    res->tris.push_back(idx[2]);
  }
  *out_nv = (int64_t)(res->verts.size() / 3);
  *out_nt = (int64_t)(res->tris.size() / 3);
  return (int64_t)(intptr_t)res;
}

int64_t mesh_simplify_get(int64_t handle, double* verts_out,
                          int64_t* tris_out) {
  SimpResult* res = (SimpResult*)(intptr_t)handle;
  if (!res) return -1;
  std::memcpy(verts_out, res->verts.data(),
              res->verts.size() * sizeof(double));
  std::memcpy(tris_out, res->tris.data(),
              res->tris.size() * sizeof(int64_t));
  delete res;
  return 0;
}

// ---------------------------------------------------------------------------
// 3D kd-tree nearest neighbour
// ---------------------------------------------------------------------------

namespace {

struct KDTree {
  std::vector<std::array<double, 3>> pts;  // reordered
  std::vector<int64_t> idx;                // original indices
  // implicit balanced tree via nth_element ordering
  void build(const double* p, int64_t n) {
    pts.resize(n);
    idx.resize(n);
    for (int64_t i = 0; i < n; i++) {
      pts[i] = {p[i * 3], p[i * 3 + 1], p[i * 3 + 2]};
      idx[i] = i;
    }
    build_rec(0, n, 0);
  }
  void build_rec(int64_t lo, int64_t hi, int axis) {
    if (hi - lo <= 1) return;
    int64_t mid = (lo + hi) / 2;
    auto b = pts.begin();
    auto bi = idx.begin();
    // co-sort pts and idx by axis
    std::vector<int64_t> order(hi - lo);
    for (int64_t i = 0; i < hi - lo; i++) order[i] = i;
    std::nth_element(order.begin(), order.begin() + (mid - lo), order.end(),
                     [&](int64_t a, int64_t c) {
                       return pts[lo + a][axis] < pts[lo + c][axis];
                     });
    std::vector<std::array<double, 3>> tmp(pts.begin() + lo, pts.begin() + hi);
    std::vector<int64_t> tmpi(idx.begin() + lo, idx.begin() + hi);
    for (int64_t i = 0; i < hi - lo; i++) {
      pts[lo + i] = tmp[order[i]];
      idx[lo + i] = tmpi[order[i]];
    }
    build_rec(lo, mid, (axis + 1) % 3);
    build_rec(mid + 1, hi, (axis + 1) % 3);
  }
  void query_rec(int64_t lo, int64_t hi, int axis, const double* q,
                 double* best_d2, int64_t* best_i) const {
    if (hi <= lo) return;
    int64_t mid = (lo + hi) / 2;
    const auto& p = pts[mid];
    double dx = q[0] - p[0], dy = q[1] - p[1], dz = q[2] - p[2];
    double d2 = dx * dx + dy * dy + dz * dz;
    if (d2 < *best_d2) {
      *best_d2 = d2;
      *best_i = idx[mid];
    }
    double diff = q[axis] - p[axis];
    int na = (axis + 1) % 3;
    if (diff < 0) {
      query_rec(lo, mid, na, q, best_d2, best_i);
      if (diff * diff < *best_d2) query_rec(mid + 1, hi, na, q, best_d2, best_i);
    } else {
      query_rec(mid + 1, hi, na, q, best_d2, best_i);
      if (diff * diff < *best_d2) query_rec(lo, mid, na, q, best_d2, best_i);
    }
  }
};

static std::vector<KDTree*> g_trees;

}  // namespace

int64_t kdtree_build(const double* pts, int64_t n) {
  auto* t = new KDTree();
  t->build(pts, n);
  g_trees.push_back(t);
  return (int64_t)(g_trees.size() - 1);
}

void kdtree_query(int64_t h, const double* q, int64_t nq, double* dist_out,
                  int64_t* idx_out) {
  KDTree* t = g_trees[h];
  for (int64_t i = 0; i < nq; i++) {
    double best = std::numeric_limits<double>::infinity();
    int64_t bi = -1;
    t->query_rec(0, (int64_t)t->pts.size(), 0, q + i * 3, &best, &bi);
    dist_out[i] = std::sqrt(best);
    idx_out[i] = bi;
  }
}

void kdtree_destroy(int64_t h) {
  if (h >= 0 && h < (int64_t)g_trees.size() && g_trees[h]) {
    delete g_trees[h];
    g_trees[h] = nullptr;
  }
}

// ---------------------------------------------------------------------------
// Point-in-mesh (z-ray parity with 2D triangle hash)
// ---------------------------------------------------------------------------

int64_t points_in_mesh(const double* verts, int64_t nv, const int64_t* tris,
                       int64_t nt, const double* query, int64_t nq,
                       uint8_t* out) {
  // 2D hash grid over (x, y)
  double minx = 1e30, miny = 1e30, maxx = -1e30, maxy = -1e30;
  for (int64_t i = 0; i < nv; i++) {
    minx = std::min(minx, verts[i * 3]);
    maxx = std::max(maxx, verts[i * 3]);
    miny = std::min(miny, verts[i * 3 + 1]);
    maxy = std::max(maxy, verts[i * 3 + 1]);
  }
  int res = 128;
  double sx = (maxx - minx) / res + 1e-12, sy = (maxy - miny) / res + 1e-12;
  std::vector<std::vector<int64_t>> cells(res * res);
  auto cell_of = [&](double x, double y) {
    int cx = std::min(res - 1, std::max(0, (int)((x - minx) / sx)));
    int cy = std::min(res - 1, std::max(0, (int)((y - miny) / sy)));
    return cx * res + cy;
  };
  for (int64_t t = 0; t < nt; t++) {
    const double* a = verts + tris[t * 3] * 3;
    const double* b = verts + tris[t * 3 + 1] * 3;
    const double* c = verts + tris[t * 3 + 2] * 3;
    double tminx = std::min({a[0], b[0], c[0]});
    double tmaxx = std::max({a[0], b[0], c[0]});
    double tminy = std::min({a[1], b[1], c[1]});
    double tmaxy = std::max({a[1], b[1], c[1]});
    int cx0 = std::min(res - 1, std::max(0, (int)((tminx - minx) / sx)));
    int cx1 = std::min(res - 1, std::max(0, (int)((tmaxx - minx) / sx)));
    int cy0 = std::min(res - 1, std::max(0, (int)((tminy - miny) / sy)));
    int cy1 = std::min(res - 1, std::max(0, (int)((tmaxy - miny) / sy)));
    for (int cx = cx0; cx <= cx1; cx++)
      for (int cy = cy0; cy <= cy1; cy++)
        cells[cx * res + cy].push_back(t);
  }

  // irrational ray-origin jitter: avoids double-counting when the z-ray
  // passes exactly through a shared triangle edge/vertex (common when mesh
  // vertices sit on lattice planes)
  const double jx = 6.180339887e-7 * (maxx - minx + 1e-12);
  const double jy = 2.414213562e-7 * (maxy - miny + 1e-12);
  for (int64_t i = 0; i < nq; i++) {
    double qx = query[i * 3] + jx, qy = query[i * 3 + 1] + jy,
           qz = query[i * 3 + 2];
    if (qx < minx || qx > maxx || qy < miny || qy > maxy) {
      out[i] = 0;
      continue;
    }
    int cnt = 0;
    for (int64_t t : cells[cell_of(qx, qy)]) {
      const double* a = verts + tris[t * 3] * 3;
      const double* b = verts + tris[t * 3 + 1] * 3;
      const double* c = verts + tris[t * 3 + 2] * 3;
      // barycentric in xy
      double d = (b[1] - c[1]) * (a[0] - c[0]) + (c[0] - b[0]) * (a[1] - c[1]);
      if (std::fabs(d) < 1e-20) continue;
      double w0 = ((b[1] - c[1]) * (qx - c[0]) + (c[0] - b[0]) * (qy - c[1])) / d;
      double w1 = ((c[1] - a[1]) * (qx - c[0]) + (a[0] - c[0]) * (qy - c[1])) / d;
      double w2 = 1 - w0 - w1;
      if (w0 < 0 || w1 < 0 || w2 < 0) continue;
      double z = w0 * a[2] + w1 * b[2] + w2 * c[2];
      if (z > qz) cnt++;
    }
    out[i] = (uint8_t)(cnt & 1);
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Mesh voxelization (surface mark + z-parity interior fill)
// ---------------------------------------------------------------------------

int64_t voxelize_mesh(const double* verts, int64_t nv, const int64_t* tris,
                      int64_t nt, int64_t res, uint8_t* occ_out) {
  // vertices assumed in [0, 1]^3; occ grid res^3, C-order (x-major)
  std::vector<double> q;
  q.reserve(res * res * res * 3);
  for (int64_t x = 0; x < res; x++)
    for (int64_t y = 0; y < res; y++)
      for (int64_t z = 0; z < res; z++) {
        q.push_back((x + 0.5) / res);
        q.push_back((y + 0.5) / res);
        q.push_back((z + 0.5) / res);
      }
  points_in_mesh(verts, nv, tris, nt, q.data(), res * res * res, occ_out);
  return 0;
}

}  // extern "C"
