// meshdist — triangle-mesh minimum-distance / intersection queries.
//
// Counterpart of the reference's python-fcl (C++ FCL) BVH
// narrowphase (reference identification/collision.py:19-267 and the
// optimizer geometry modes box/convex/full with per-link fullMeshLinks,
// reference excitation/optimizer.py:571-634): an AABB-tree over the raw
// triangle soup with branch-and-bound closest-pair traversal, plus a
// Moller triangle-overlap test so penetrating pairs report distance 0
// (the reference confirms 0-distance BVH results with collide()).
//
// Role in the pipeline: the differentiable capsule tier and the vmapped
// convex-hull tier run on device (collision.py / collision_mesh.py);
// this library is the exact host-side narrowphase that re-checks the
// near-contact candidates of non-convex links ("full" mode), mirroring
// the reference's sparse-then-dense verification split.
//
// C API (ctypes-friendly, see flobaroid_tpu/native_meshdist.py):
//   void*  md_build(const double* verts, int nv, const int* tris, int nt);
//   void   md_free(void* handle);
//   double md_distance(const void* a, const double* Ta16,
//                      const void* b, const double* Tb16);
//   double md_distance_brute(...)   // O(na*nt) reference for tests
//
// Transforms are rigid 4x4 row-major world_T_mesh matrices.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <limits>
#include <vector>

namespace {

struct Vec3 {
  double x = 0, y = 0, z = 0;
};

static inline Vec3 operator+(Vec3 a, Vec3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
static inline Vec3 operator-(Vec3 a, Vec3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline Vec3 operator*(double s, Vec3 a) { return {s * a.x, s * a.y, s * a.z}; }
static inline double dot(Vec3 a, Vec3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline Vec3 cross(Vec3 a, Vec3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline double norm2(Vec3 a) { return dot(a, a); }

struct Tri {
  Vec3 a, b, c;
};

// ---------------------------------------------------------------- primitives

// Closest point on triangle to point p (Ericson, Real-Time Collision
// Detection §5.1.5 — the same construction the repo's capsule tier
// cites for segments).
static Vec3 closestPtTriangle(const Tri& t, Vec3 p) {
  Vec3 ab = t.b - t.a, ac = t.c - t.a, ap = p - t.a;
  double d1 = dot(ab, ap), d2 = dot(ac, ap);
  if (d1 <= 0 && d2 <= 0) return t.a;
  Vec3 bp = p - t.b;
  double d3 = dot(ab, bp), d4 = dot(ac, bp);
  if (d3 >= 0 && d4 <= d3) return t.b;
  double vc = d1 * d4 - d3 * d2;
  if (vc <= 0 && d1 >= 0 && d3 <= 0) {
    double v = d1 / (d1 - d3);
    return t.a + v * ab;
  }
  Vec3 cp = p - t.c;
  double d5 = dot(ab, cp), d6 = dot(ac, cp);
  if (d6 >= 0 && d5 <= d6) return t.c;
  double vb = d5 * d2 - d1 * d6;
  if (vb <= 0 && d2 >= 0 && d6 <= 0) {
    double w = d2 / (d2 - d6);
    return t.a + w * ac;
  }
  double va = d3 * d6 - d5 * d4;
  if (va <= 0 && (d4 - d3) >= 0 && (d5 - d6) >= 0) {
    double w = (d4 - d3) / ((d4 - d3) + (d5 - d6));
    return t.b + w * (t.c - t.b);
  }
  double denom = 1.0 / (va + vb + vc);
  double v = vb * denom, w = vc * denom;
  return t.a + v * ab + w * ac;
}

// Squared distance between segments p1->q1 and p2->q2 (Ericson §5.1.9).
static double segSegDist2(Vec3 p1, Vec3 q1, Vec3 p2, Vec3 q2) {
  Vec3 d1 = q1 - p1, d2 = q2 - p2, r = p1 - p2;
  double a = norm2(d1), e = norm2(d2), f = dot(d2, r);
  double s = 0, t = 0;
  const double EPS = 1e-30;
  if (a <= EPS && e <= EPS) {
    return norm2(r);
  }
  if (a <= EPS) {
    t = std::clamp(f / e, 0.0, 1.0);
  } else {
    double c = dot(d1, r);
    if (e <= EPS) {
      s = std::clamp(-c / a, 0.0, 1.0);
    } else {
      double b = dot(d1, d2);
      double denom = a * e - b * b;
      if (denom > EPS)
        s = std::clamp((b * f - c * e) / denom, 0.0, 1.0);
      t = (b * s + f) / e;
      if (t < 0) {
        t = 0;
        s = std::clamp(-c / a, 0.0, 1.0);
      } else if (t > 1) {
        t = 1;
        s = std::clamp((b - c) / a, 0.0, 1.0);
      }
    }
  }
  Vec3 c1 = p1 + s * d1, c2 = p2 + t * d2;
  return norm2(c1 - c2);
}

// Moller 1997 triangle-triangle overlap test (with coplanar handling).
static bool pointInTri2D(double px, double py, double ax, double ay, double bx,
                         double by, double cx, double cy) {
  double v0x = cx - ax, v0y = cy - ay;
  double v1x = bx - ax, v1y = by - ay;
  double v2x = px - ax, v2y = py - ay;
  double d00 = v0x * v0x + v0y * v0y;
  double d01 = v0x * v1x + v0y * v1y;
  double d11 = v1x * v1x + v1y * v1y;
  double d20 = v2x * v0x + v2y * v0y;
  double d21 = v2x * v1x + v2y * v1y;
  double denom = d00 * d11 - d01 * d01;
  if (std::abs(denom) < 1e-30) return false;
  double v = (d11 * d20 - d01 * d21) / denom;
  double w = (d00 * d21 - d01 * d20) / denom;
  return v >= -1e-12 && w >= -1e-12 && (v + w) <= 1 + 1e-12;
}

static bool seg2DIntersect(double p0x, double p0y, double p1x, double p1y,
                           double q0x, double q0y, double q1x, double q1y) {
  auto orient = [](double ax, double ay, double bx, double by, double cx,
                   double cy) {
    return (bx - ax) * (cy - ay) - (by - ay) * (cx - ax);
  };
  double o1 = orient(p0x, p0y, p1x, p1y, q0x, q0y);
  double o2 = orient(p0x, p0y, p1x, p1y, q1x, q1y);
  double o3 = orient(q0x, q0y, q1x, q1y, p0x, p0y);
  double o4 = orient(q0x, q0y, q1x, q1y, p1x, p1y);
  return ((o1 > 0) != (o2 > 0)) && ((o3 > 0) != (o4 > 0));
}

static bool coplanarTriTri(const Tri& t1, const Tri& t2, Vec3 n) {
  // project onto the dominant axis plane
  double ax = std::abs(n.x), ay = std::abs(n.y), az = std::abs(n.z);
  int i0 = 0, i1 = 1;
  if (ax >= ay && ax >= az) {
    i0 = 1;
    i1 = 2;
  } else if (ay >= az) {
    i0 = 0;
    i1 = 2;
  }
  auto comp = [&](Vec3 v, int i) { return i == 0 ? v.x : (i == 1 ? v.y : v.z); };
  double u[3][2], v[3][2];
  const Vec3 tv1[3] = {t1.a, t1.b, t1.c};
  const Vec3 tv2[3] = {t2.a, t2.b, t2.c};
  for (int i = 0; i < 3; i++) {
    u[i][0] = comp(tv1[i], i0);
    u[i][1] = comp(tv1[i], i1);
    v[i][0] = comp(tv2[i], i0);
    v[i][1] = comp(tv2[i], i1);
  }
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++)
      if (seg2DIntersect(u[i][0], u[i][1], u[(i + 1) % 3][0], u[(i + 1) % 3][1],
                         v[j][0], v[j][1], v[(j + 1) % 3][0], v[(j + 1) % 3][1]))
        return true;
  if (pointInTri2D(u[0][0], u[0][1], v[0][0], v[0][1], v[1][0], v[1][1],
                   v[2][0], v[2][1]))
    return true;
  if (pointInTri2D(v[0][0], v[0][1], u[0][0], u[0][1], u[1][0], u[1][1],
                   u[2][0], u[2][1]))
    return true;
  return false;
}

// Segment p->q against triangle interior (proper plane crossing +
// barycentric containment of the crossing point).
static bool segTriCross(Vec3 p, Vec3 q, const Tri& t) {
  Vec3 n = cross(t.b - t.a, t.c - t.a);
  double dp = dot(n, p - t.a), dq = dot(n, q - t.a);
  if (dp * dq > 0) return false;  // same side (or coplanar handled elsewhere)
  double denom = dp - dq;
  if (std::abs(denom) < 1e-30) return false;  // coplanar segment
  double s = dp / denom;
  Vec3 x = p + s * (q - p);
  // barycentric containment
  Vec3 v0 = t.b - t.a, v1 = t.c - t.a, v2 = x - t.a;
  double d00 = dot(v0, v0), d01 = dot(v0, v1), d11 = dot(v1, v1);
  double d20 = dot(v2, v0), d21 = dot(v2, v1);
  double det = d00 * d11 - d01 * d01;
  if (std::abs(det) < 1e-30) return false;
  double v = (d11 * d20 - d01 * d21) / det;
  double w = (d00 * d21 - d01 * d20) / det;
  return v >= -1e-12 && w >= -1e-12 && v + w <= 1 + 1e-12;
}

static bool triTriOverlap(const Tri& t1, const Tri& t2) {
  Vec3 n1 = cross(t1.b - t1.a, t1.c - t1.a);
  double dv0 = dot(n1, t2.a - t1.a);
  double dv1 = dot(n1, t2.b - t1.a);
  double dv2 = dot(n1, t2.c - t1.a);
  double scale = std::sqrt(norm2(n1)) + 1e-300;
  const double EPS = 1e-12;
  if (std::abs(dv0) / scale < EPS && std::abs(dv1) / scale < EPS &&
      std::abs(dv2) / scale < EPS)
    return coplanarTriTri(t1, t2, n1);
  // non-coplanar: intersect iff an edge of one crosses the other's interior
  const Vec3 e1[3][2] = {{t1.a, t1.b}, {t1.b, t1.c}, {t1.c, t1.a}};
  const Vec3 e2[3][2] = {{t2.a, t2.b}, {t2.b, t2.c}, {t2.c, t2.a}};
  for (auto& e : e1)
    if (segTriCross(e[0], e[1], t2)) return true;
  for (auto& e : e2)
    if (segTriCross(e[0], e[1], t1)) return true;
  return false;
}

// Exact distance between triangles: 0 if overlapping, else min over the
// 9 edge-edge and 6 vertex-face distances.
static double triTriDist2(const Tri& t1, const Tri& t2) {
  const Vec3 e1[3][2] = {{t1.a, t1.b}, {t1.b, t1.c}, {t1.c, t1.a}};
  const Vec3 e2[3][2] = {{t2.a, t2.b}, {t2.b, t2.c}, {t2.c, t2.a}};
  double best = std::numeric_limits<double>::infinity();
  for (auto& ea : e1)
    for (auto& eb : e2)
      best = std::min(best, segSegDist2(ea[0], ea[1], eb[0], eb[1]));
  const Vec3 v1[3] = {t1.a, t1.b, t1.c};
  const Vec3 v2[3] = {t2.a, t2.b, t2.c};
  for (auto& p : v1) best = std::min(best, norm2(p - closestPtTriangle(t2, p)));
  for (auto& p : v2) best = std::min(best, norm2(p - closestPtTriangle(t1, p)));
  if (best > 0 && triTriOverlap(t1, t2)) return 0.0;
  return best;
}

// ---------------------------------------------------------------- BVH

struct AABB {
  Vec3 lo{1e300, 1e300, 1e300}, hi{-1e300, -1e300, -1e300};
  void grow(Vec3 p) {
    lo.x = std::min(lo.x, p.x);
    lo.y = std::min(lo.y, p.y);
    lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x);
    hi.y = std::max(hi.y, p.y);
    hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB& o) {
    grow(o.lo);
    grow(o.hi);
  }
};

static double aabbDist2(const AABB& a, const AABB& b) {
  double d = 0;
  double dx = std::max({0.0, b.lo.x - a.hi.x, a.lo.x - b.hi.x});
  double dy = std::max({0.0, b.lo.y - a.hi.y, a.lo.y - b.hi.y});
  double dz = std::max({0.0, b.lo.z - a.hi.z, a.lo.z - b.hi.z});
  d = dx * dx + dy * dy + dz * dz;
  return d;
}

struct Node {
  AABB box;
  int left = -1, right = -1;  // children; leaf when left < 0
  int start = 0, count = 0;   // triangle range for leaves
};

struct Mesh {
  std::vector<Tri> tris;
  std::vector<Node> nodes;
  int root = 0;

  int build(std::vector<int>& idx, int start, int count,
            std::vector<Tri>& scratch) {
    Node node;
    for (int i = 0; i < count; i++) {
      const Tri& t = tris[idx[start + i]];
      node.box.grow(t.a);
      node.box.grow(t.b);
      node.box.grow(t.c);
    }
    int me = (int)nodes.size();
    nodes.push_back(node);
    if (count <= 2) {
      nodes[me].start = start;
      nodes[me].count = count;
      return me;
    }
    // split on the longest centroid axis at the median
    AABB cb;
    for (int i = 0; i < count; i++) {
      const Tri& t = tris[idx[start + i]];
      cb.grow(Vec3{(t.a.x + t.b.x + t.c.x) / 3, (t.a.y + t.b.y + t.c.y) / 3,
                   (t.a.z + t.b.z + t.c.z) / 3});
    }
    double ex = cb.hi.x - cb.lo.x, ey = cb.hi.y - cb.lo.y,
           ez = cb.hi.z - cb.lo.z;
    int axis = (ex >= ey && ex >= ez) ? 0 : (ey >= ez ? 1 : 2);
    auto cen = [&](int ti) {
      const Tri& t = tris[ti];
      Vec3 c = {(t.a.x + t.b.x + t.c.x) / 3, (t.a.y + t.b.y + t.c.y) / 3,
                (t.a.z + t.b.z + t.c.z) / 3};
      return axis == 0 ? c.x : (axis == 1 ? c.y : c.z);
    };
    std::nth_element(idx.begin() + start, idx.begin() + start + count / 2,
                     idx.begin() + start + count,
                     [&](int a, int b) { return cen(a) < cen(b); });
    int mid = count / 2;
    int l = build(idx, start, mid, scratch);
    int r = build(idx, start + mid, count - mid, scratch);
    nodes[me].left = l;
    nodes[me].right = r;
    return me;
  }

  void finish(std::vector<int>& idx) {
    // reorder triangles so leaves reference contiguous ranges
    std::vector<Tri> reord(tris.size());
    for (size_t i = 0; i < idx.size(); i++) reord[i] = tris[idx[i]];
    tris.swap(reord);
  }
};

struct Xform {
  double R[3][3];
  Vec3 t;
  Vec3 apply(Vec3 p) const {
    return {R[0][0] * p.x + R[0][1] * p.y + R[0][2] * p.z + t.x,
            R[1][0] * p.x + R[1][1] * p.y + R[1][2] * p.z + t.y,
            R[2][0] * p.x + R[2][1] * p.y + R[2][2] * p.z + t.z};
  }
};

// relative transform rel = inv(Tb) * Ta for row-major rigid 4x4 inputs
static Xform relative(const double* Ta, const double* Tb) {
  Xform out;
  // Rb^T
  double RbT[3][3];
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) RbT[i][j] = Tb[j * 4 + i];
  // out.R = Rb^T * Ra
  for (int i = 0; i < 3; i++)
    for (int j = 0; j < 3; j++) {
      double s = 0;
      for (int k = 0; k < 3; k++) s += RbT[i][k] * Ta[k * 4 + j];
      out.R[i][j] = s;
    }
  // out.t = Rb^T * (ta - tb)
  Vec3 dt = {Ta[3] - Tb[3], Ta[7] - Tb[7], Ta[11] - Tb[11]};
  out.t = {RbT[0][0] * dt.x + RbT[0][1] * dt.y + RbT[0][2] * dt.z,
           RbT[1][0] * dt.x + RbT[1][1] * dt.y + RbT[1][2] * dt.z,
           RbT[2][0] * dt.x + RbT[2][1] * dt.y + RbT[2][2] * dt.z};
  return out;
}

static AABB xformAABB(const AABB& b, const Xform& x) {
  AABB out;
  for (int i = 0; i < 8; i++) {
    Vec3 c = {(i & 1) ? b.hi.x : b.lo.x, (i & 2) ? b.hi.y : b.lo.y,
              (i & 4) ? b.hi.z : b.lo.z};
    out.grow(x.apply(c));
  }
  return out;
}

struct Query {
  const Mesh* A;
  const Mesh* B;
  Xform rel;  // maps A-frame to B-frame
  double best2 = std::numeric_limits<double>::infinity();

  double leafDist2(const Node& na, const Node& nb) {
    double b = best2;
    for (int i = 0; i < na.count; i++) {
      Tri ta = A->tris[na.start + i];
      ta.a = rel.apply(ta.a);
      ta.b = rel.apply(ta.b);
      ta.c = rel.apply(ta.c);
      for (int j = 0; j < nb.count; j++) {
        double d = triTriDist2(ta, B->tris[nb.start + j]);
        b = std::min(b, d);
        if (b <= 0) return 0;
      }
    }
    return b;
  }

  void recurse(int ia, int ib) {
    if (best2 <= 0) return;
    const Node& na = A->nodes[ia];
    const Node& nb = B->nodes[ib];
    AABB wa = xformAABB(na.box, rel);
    if (aabbDist2(wa, nb.box) >= best2) return;
    bool leafA = na.left < 0, leafB = nb.left < 0;
    if (leafA && leafB) {
      best2 = std::min(best2, leafDist2(na, nb));
      return;
    }
    // descend the larger box first, nearest child first
    auto visitPair = [&](int ca, int cb) { recurse(ca, cb); };
    if (!leafA && (leafB || volume(na.box) >= volume(nb.box))) {
      int c1 = na.left, c2 = na.right;
      double d1 = aabbDist2(xformAABB(A->nodes[c1].box, rel), nb.box);
      double d2 = aabbDist2(xformAABB(A->nodes[c2].box, rel), nb.box);
      if (d2 < d1) std::swap(c1, c2);
      visitPair(c1, ib);
      visitPair(c2, ib);
    } else {
      int c1 = nb.left, c2 = nb.right;
      double d1 = aabbDist2(wa, B->nodes[c1].box);
      double d2 = aabbDist2(wa, B->nodes[c2].box);
      if (d2 < d1) std::swap(c1, c2);
      visitPair(ia, c1);
      visitPair(ia, c2);
    }
  }

  static double volume(const AABB& b) {
    return std::max(0.0, b.hi.x - b.lo.x) * std::max(0.0, b.hi.y - b.lo.y) *
           std::max(0.0, b.hi.z - b.lo.z);
  }
};

}  // namespace

extern "C" {

void* md_build(const double* verts, int nv, const int* tris, int nt) {
  if (nv <= 0 || nt <= 0 || !verts || !tris) return nullptr;
  Mesh* m = new Mesh();
  m->tris.reserve(nt);
  for (int i = 0; i < nt; i++) {
    int i0 = tris[3 * i], i1 = tris[3 * i + 1], i2 = tris[3 * i + 2];
    if (i0 < 0 || i0 >= nv || i1 < 0 || i1 >= nv || i2 < 0 || i2 >= nv)
      continue;
    Tri t;
    t.a = {verts[3 * i0], verts[3 * i0 + 1], verts[3 * i0 + 2]};
    t.b = {verts[3 * i1], verts[3 * i1 + 1], verts[3 * i1 + 2]};
    t.c = {verts[3 * i2], verts[3 * i2 + 1], verts[3 * i2 + 2]};
    m->tris.push_back(t);
  }
  if (m->tris.empty()) {
    delete m;
    return nullptr;
  }
  std::vector<int> idx(m->tris.size());
  for (size_t i = 0; i < idx.size(); i++) idx[i] = (int)i;
  std::vector<Tri> scratch;
  m->root = m->build(idx, 0, (int)m->tris.size(), scratch);
  m->finish(idx);
  return m;
}

void md_free(void* handle) { delete static_cast<Mesh*>(handle); }

int md_num_tris(const void* handle) {
  return handle ? (int)static_cast<const Mesh*>(handle)->tris.size() : 0;
}

double md_distance(const void* a, const double* Ta, const void* b,
                   const double* Tb) {
  const Mesh* A = static_cast<const Mesh*>(a);
  const Mesh* B = static_cast<const Mesh*>(b);
  if (!A || !B) return -1.0;
  Query q;
  q.A = A;
  q.B = B;
  q.rel = relative(Ta, Tb);
  q.recurse(A->root, B->root);
  return std::sqrt(std::max(0.0, q.best2));
}

// Moller-Trumbore ray/triangle intersection with t > eps.
static bool rayTri(Vec3 o, Vec3 d, const Tri& t) {
  const double EPS = 1e-12;
  Vec3 e1 = t.b - t.a, e2 = t.c - t.a;
  Vec3 p = cross(d, e2);
  double det = dot(e1, p);
  if (std::abs(det) < EPS) return false;
  double inv = 1.0 / det;
  Vec3 s = o - t.a;
  double u = dot(s, p) * inv;
  if (u < 0 || u > 1) return false;
  Vec3 q = cross(s, e1);
  double v = dot(d, q) * inv;
  if (v < 0 || u + v > 1) return false;
  double tt = dot(e2, q) * inv;
  return tt > EPS;
}

int md_inside(const void* handle, const double* point3) {
  // Ray-crossing parity along three axes with a majority vote (soup
  // meshes can carry coincident internal faces; an identical duplicated
  // pair flips parity twice and cancels, near-degenerate hits are
  // outvoted). Meaningful for (approximately) closed meshes — exactly
  // the case that matters: surfaces that can contain another body.
  const Mesh* M = static_cast<const Mesh*>(handle);
  if (!M || !point3) return 0;
  Vec3 p{point3[0], point3[1], point3[2]};
  // generic (irrational-ish) directions + a tiny per-ray origin jitter:
  // axis-aligned rays from symmetric points hit shared triangle edges
  // and double-count crossings
  const Vec3 dirs[3] = {{0.4120338, 0.5370861, 0.7364747},
                        {0.8612910, -0.2901285, 0.4170294},
                        {-0.1330587, 0.6280424, -0.7667344}};
  int votes = 0;
  for (const Vec3& d : dirs) {
    Vec3 o = p + 1e-7 * Vec3{d.y, d.z, d.x};
    int c = 0;
    for (const Tri& t : M->tris)
      if (rayTri(o, d, t)) c++;
    votes += (c & 1);
  }
  return votes >= 2 ? 1 : 0;
}

double md_distance_brute(const void* a, const double* Ta, const void* b,
                         const double* Tb) {
  const Mesh* A = static_cast<const Mesh*>(a);
  const Mesh* B = static_cast<const Mesh*>(b);
  if (!A || !B) return -1.0;
  Xform rel = relative(Ta, Tb);
  double best = std::numeric_limits<double>::infinity();
  for (const Tri& t0 : A->tris) {
    Tri ta = t0;
    ta.a = rel.apply(ta.a);
    ta.b = rel.apply(ta.b);
    ta.c = rel.apply(ta.c);
    for (const Tri& tb : B->tris) {
      best = std::min(best, triTriDist2(ta, tb));
      if (best <= 0) return 0.0;
    }
  }
  return std::sqrt(std::max(0.0, best));
}

}  // extern "C"
