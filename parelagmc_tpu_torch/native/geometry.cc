// Native geometry kernels for the mortar transfer subsystem.
//
// TPU-native equivalent of the reference's from-scratch distributed
// communication/geometry stack (ParELAGMC src/transfer/: Box,
// HashGrid, Intersect2D/3D polygon-polyhedron clipping, MortarAssembler) -
// redesigned for the precompute-at-setup model (SURVEY.md 2.3/5.8): mesh
// intersection is mesh-only, sample-independent work, so it runs once on
// the host in native code and ships a static coupling operator to the
// device; there is no runtime dynamic communication.
//
// Pipeline (mortar_p0_couple_{2d,3d}):
//   1. Broad phase: uniform spatial hash grid over the master mesh's
//      element AABBs (reference HashGrid, src/transfer/HashGrid.cpp);
//      a brute-force O(n^2) variant is exported for oracle testing, like
//      the reference keeps DetectIntersections "for test purposes"
//      (src/transfer/HashGrid.hpp:46-47).
//   2. Narrow phase: both cells are convex polytopes given by face
//      half-spaces; the intersection is the joint half-space set. Vertices
//      are enumerated as all plane-triple (2D: plane-pair) intersections
//      satisfying every constraint, then the volume (area) comes from a
//      fan decomposition around the interior point. Exact for
//      planar-faced convex cells (axis-aligned and affine hexes, tets,
//      quads, triangles) - the P0 mortar integral int_{T1 cap T2} 1 that
//      the reference computes with moonolith clipping + composite
//      quadrature (src/transfer/MortarAssemble.hpp:27-76).
//
// Build: plain C ABI (ctypes), g++ -O3 -shared; no external dependencies.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <algorithm>
#include <vector>

namespace {

constexpr int kMaxPlanes = 64;

struct Plane3 {
  double n[3];
  double d;  // n . x <= d inside
};

struct Plane2 {
  double n[2];
  double d;
};

// ---------------------------------------------------------------------------
// Half-space construction from elements.
// ---------------------------------------------------------------------------

// MFEM-convention local faces.
static const int kHexFaces[6][4] = {{3, 2, 1, 0}, {0, 1, 5, 4}, {1, 2, 6, 5},
                                    {2, 3, 7, 6}, {3, 0, 4, 7}, {4, 5, 6, 7}};
static const int kTetFaces[4][3] = {{1, 2, 3}, {0, 3, 2}, {0, 1, 3}, {0, 2, 1}};
static const int kQuadEdges[4][2] = {{0, 1}, {1, 2}, {2, 3}, {3, 0}};
static const int kTriEdges[3][2] = {{0, 1}, {1, 2}, {2, 0}};

inline void cross(const double a[3], const double b[3], double out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// Planes of one element, normals oriented outward (away from the centroid).
int element_planes_3d(const double* verts, const int64_t* conn, int nv,
                      int64_t e, Plane3* planes) {
  const int64_t* el = conn + e * nv;
  double cx = 0, cy = 0, cz = 0;
  for (int i = 0; i < nv; ++i) {
    cx += verts[3 * el[i]];
    cy += verts[3 * el[i] + 1];
    cz += verts[3 * el[i] + 2];
  }
  cx /= nv; cy /= nv; cz /= nv;
  int nfaces = (nv == 8) ? 6 : 4;
  for (int f = 0; f < nfaces; ++f) {
    const int* lf = (nv == 8) ? kHexFaces[f] : nullptr;
    int i0, i1, i2;
    if (nv == 8) {
      i0 = lf[0]; i1 = lf[1]; i2 = lf[2];
    } else {
      i0 = kTetFaces[f][0]; i1 = kTetFaces[f][1]; i2 = kTetFaces[f][2];
    }
    const double* p0 = verts + 3 * el[i0];
    const double* p1 = verts + 3 * el[i1];
    const double* p2 = verts + 3 * el[i2];
    double u[3] = {p1[0] - p0[0], p1[1] - p0[1], p1[2] - p0[2]};
    double v[3] = {p2[0] - p0[0], p2[1] - p0[1], p2[2] - p0[2]};
    double n[3];
    cross(u, v, n);
    double len = std::sqrt(n[0] * n[0] + n[1] * n[1] + n[2] * n[2]);
    if (len < 1e-300) continue;
    n[0] /= len; n[1] /= len; n[2] /= len;
    double d = n[0] * p0[0] + n[1] * p0[1] + n[2] * p0[2];
    // Orient outward: the centroid must be inside (n.c <= d).
    if (n[0] * cx + n[1] * cy + n[2] * cz > d) {
      n[0] = -n[0]; n[1] = -n[1]; n[2] = -n[2]; d = -d;
    }
    planes[f].n[0] = n[0]; planes[f].n[1] = n[1]; planes[f].n[2] = n[2];
    planes[f].d = d;
  }
  return nfaces;
}

int element_planes_2d(const double* verts, const int64_t* conn, int nv,
                      int64_t e, Plane2* planes) {
  const int64_t* el = conn + e * nv;
  double cx = 0, cy = 0;
  for (int i = 0; i < nv; ++i) {
    cx += verts[2 * el[i]];
    cy += verts[2 * el[i] + 1];
  }
  cx /= nv; cy /= nv;
  int nedges = nv;  // quad: 4, tri: 3
  for (int f = 0; f < nedges; ++f) {
    int i0 = (nv == 4) ? kQuadEdges[f][0] : kTriEdges[f][0];
    int i1 = (nv == 4) ? kQuadEdges[f][1] : kTriEdges[f][1];
    const double* p0 = verts + 2 * el[i0];
    const double* p1 = verts + 2 * el[i1];
    double nx = p1[1] - p0[1];
    double ny = -(p1[0] - p0[0]);
    double len = std::sqrt(nx * nx + ny * ny);
    if (len < 1e-300) continue;
    nx /= len; ny /= len;
    double d = nx * p0[0] + ny * p0[1];
    if (nx * cx + ny * cy > d) { nx = -nx; ny = -ny; d = -d; }
    planes[f].n[0] = nx; planes[f].n[1] = ny; planes[f].d = d;
  }
  return nedges;
}

// ---------------------------------------------------------------------------
// Convex polytope intersection volume by vertex enumeration.
// ---------------------------------------------------------------------------

int dedup_planes_3d(const Plane3* in, int np, Plane3* out, double tol) {
  // Drop same-orientation duplicate planes (conforming meshes share face
  // planes; counting one twice double-counts its face in the volume sum).
  int m = 0;
  for (int i = 0; i < np; ++i) {
    bool dup = false;
    for (int j = 0; j < m; ++j) {
      if (std::fabs(in[i].n[0] - out[j].n[0]) < 1e-10 &&
          std::fabs(in[i].n[1] - out[j].n[1]) < 1e-10 &&
          std::fabs(in[i].n[2] - out[j].n[2]) < 1e-10 &&
          std::fabs(in[i].d - out[j].d) < 10 * tol) {
        // Keep the tighter constraint.
        if (in[i].d < out[j].d) out[j].d = in[i].d;
        dup = true;
        break;
      }
    }
    if (!dup) out[m++] = in[i];
  }
  return m;
}

int dedup_planes_2d(const Plane2* in, int np, Plane2* out, double tol) {
  int m = 0;
  for (int i = 0; i < np; ++i) {
    bool dup = false;
    for (int j = 0; j < m; ++j) {
      if (std::fabs(in[i].n[0] - out[j].n[0]) < 1e-10 &&
          std::fabs(in[i].n[1] - out[j].n[1]) < 1e-10 &&
          std::fabs(in[i].d - out[j].d) < 10 * tol) {
        if (in[i].d < out[j].d) out[j].d = in[i].d;
        dup = true;
        break;
      }
    }
    if (!dup) out[m++] = in[i];
  }
  return m;
}

double intersect_volume_3d(const Plane3* planes_in, int np_in, double tol) {
  Plane3 planes[2 * kMaxPlanes];
  int np = dedup_planes_3d(planes_in, np_in, planes, tol);
  // Enumerate vertices: all plane triples.
  double vx[512], vy[512], vz[512];
  int nvert = 0;
  for (int a = 0; a < np && nvert < 512; ++a)
    for (int b = a + 1; b < np && nvert < 512; ++b)
      for (int c = b + 1; c < np && nvert < 512; ++c) {
        const double* n1 = planes[a].n;
        const double* n2 = planes[b].n;
        const double* n3 = planes[c].n;
        double det = n1[0] * (n2[1] * n3[2] - n2[2] * n3[1]) -
                     n1[1] * (n2[0] * n3[2] - n2[2] * n3[0]) +
                     n1[2] * (n2[0] * n3[1] - n2[1] * n3[0]);
        if (std::fabs(det) < 1e-12) continue;
        double d1 = planes[a].d, d2 = planes[b].d, d3 = planes[c].d;
        // Cramer's rule.
        double x = (d1 * (n2[1] * n3[2] - n2[2] * n3[1]) -
                    n1[1] * (d2 * n3[2] - n2[2] * d3) +
                    n1[2] * (d2 * n3[1] - n2[1] * d3)) / det;
        double y = (n1[0] * (d2 * n3[2] - n2[2] * d3) -
                    d1 * (n2[0] * n3[2] - n2[2] * n3[0]) +
                    n1[2] * (n2[0] * d3 - d2 * n3[0])) / det;
        double z = (n1[0] * (n2[1] * d3 - d2 * n3[1]) -
                    n1[1] * (n2[0] * d3 - d2 * n3[0]) +
                    d1 * (n2[0] * n3[1] - n2[1] * n3[0])) / det;
        bool inside = true;
        for (int k = 0; k < np; ++k) {
          if (planes[k].n[0] * x + planes[k].n[1] * y + planes[k].n[2] * z >
              planes[k].d + tol) {
            inside = false;
            break;
          }
        }
        if (inside) { vx[nvert] = x; vy[nvert] = y; vz[nvert] = z; ++nvert; }
      }
  if (nvert < 4) return 0.0;
  // Interior point.
  double cx = 0, cy = 0, cz = 0;
  for (int i = 0; i < nvert; ++i) { cx += vx[i]; cy += vy[i]; cz += vz[i]; }
  cx /= nvert; cy /= nvert; cz /= nvert;
  // Volume = sum over faces of (1/3) * faceArea * distance(center, plane),
  // with each face polygon fanned around its angular ordering.
  double vol = 0.0;
  for (int k = 0; k < np; ++k) {
    const double* n = planes[k].n;
    double d = planes[k].d;
    // Vertices on this plane.
    int idx[128];
    int m = 0;
    for (int i = 0; i < nvert && m < 128; ++i) {
      if (std::fabs(n[0] * vx[i] + n[1] * vy[i] + n[2] * vz[i] - d) <= 10 * tol)
        idx[m++] = i;
    }
    if (m < 3) continue;
    // In-plane basis.
    double t1[3];
    double ref[3] = {1.0, 0.0, 0.0};
    if (std::fabs(n[0]) > 0.9) { ref[0] = 0.0; ref[1] = 1.0; }
    cross(n, ref, t1);
    double l1 = std::sqrt(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]);
    t1[0] /= l1; t1[1] /= l1; t1[2] /= l1;
    double t2[3];
    cross(n, t1, t2);
    // Face centroid.
    double fx = 0, fy = 0, fz = 0;
    for (int j = 0; j < m; ++j) { fx += vx[idx[j]]; fy += vy[idx[j]]; fz += vz[idx[j]]; }
    fx /= m; fy /= m; fz /= m;
    // Sort by angle around the centroid.
    double ang[128];
    for (int j = 0; j < m; ++j) {
      double rx = vx[idx[j]] - fx, ry = vy[idx[j]] - fy, rz = vz[idx[j]] - fz;
      double a1 = rx * t1[0] + ry * t1[1] + rz * t1[2];
      double a2 = rx * t2[0] + ry * t2[1] + rz * t2[2];
      ang[j] = std::atan2(a2, a1);
    }
    int order[128];
    for (int j = 0; j < m; ++j) order[j] = j;
    std::sort(order, order + m, [&](int a, int b) { return ang[a] < ang[b]; });
    // Face area by shoelace in the plane basis.
    double area2 = 0.0;
    for (int j = 0; j < m; ++j) {
      int ja = idx[order[j]];
      int jb = idx[order[(j + 1) % m]];
      double ax = (vx[ja] - fx) * t1[0] + (vy[ja] - fy) * t1[1] + (vz[ja] - fz) * t1[2];
      double ay = (vx[ja] - fx) * t2[0] + (vy[ja] - fy) * t2[1] + (vz[ja] - fz) * t2[2];
      double bx = (vx[jb] - fx) * t1[0] + (vy[jb] - fy) * t1[1] + (vz[jb] - fz) * t1[2];
      double by = (vx[jb] - fx) * t2[0] + (vy[jb] - fy) * t2[1] + (vz[jb] - fz) * t2[2];
      area2 += ax * by - ay * bx;
    }
    double area = 0.5 * std::fabs(area2);
    double h = d - (n[0] * cx + n[1] * cy + n[2] * cz);  // >= 0 inside
    vol += area * h / 3.0;
  }
  return vol;
}

// Moments of the intersection polytope: volume, first moments int x dV
// (3 values), second moments int x x^T dV (xx, yy, zz, xy, xz, yz).
// Simplex closed forms (vertices p_0..p_d, measure V):
//   int x     = V * mean(p_i)
//   int x x^T = V / ((d+1)(d+2)) * (sum_i p_i p_i^T + (sum_i p_i)(sum_i p_i)^T)
// Needed for the higher-order / vector mortar integrators (reference:
// L2MortarIntegrator / VectorL2MortarIntegrator on composite quadratures,
// src/transfer/MortarIntegrator.hpp:19-111).
struct Moments3 {
  double v = 0, m1[3] = {0, 0, 0}, m2[6] = {0, 0, 0, 0, 0, 0};
};

inline void add_tet_moments(const double* a, const double* b, const double* c,
                            const double* p, Moments3* out) {
  double u[3] = {b[0] - a[0], b[1] - a[1], b[2] - a[2]};
  double v[3] = {c[0] - a[0], c[1] - a[1], c[2] - a[2]};
  double w[3] = {p[0] - a[0], p[1] - a[1], p[2] - a[2]};
  double cr[3];
  cross(u, v, cr);
  double vol = std::fabs(cr[0] * w[0] + cr[1] * w[1] + cr[2] * w[2]) / 6.0;
  if (vol <= 0) return;
  out->v += vol;
  double s[3];
  const double* q[4] = {a, b, c, p};
  for (int d = 0; d < 3; ++d) {
    s[d] = a[d] + b[d] + c[d] + p[d];
    out->m1[d] += vol * s[d] / 4.0;
  }
  const double f = vol / 20.0;  // 1/((d+1)(d+2)) = 1/20 for d = 3
  const int pairs[6][2] = {{0, 0}, {1, 1}, {2, 2}, {0, 1}, {0, 2}, {1, 2}};
  for (int k = 0; k < 6; ++k) {
    int da = pairs[k][0], db = pairs[k][1];
    double pp = 0;
    for (int i = 0; i < 4; ++i) pp += q[i][da] * q[i][db];
    out->m2[k] += f * (pp + s[da] * s[db]);
  }
}

Moments3 intersect_moments_3d(const Plane3* planes_in, int np_in, double tol) {
  Moments3 out;
  Plane3 planes[2 * kMaxPlanes];
  int np = dedup_planes_3d(planes_in, np_in, planes, tol);
  double vx[512], vy[512], vz[512];
  int nvert = 0;
  for (int a = 0; a < np && nvert < 512; ++a)
    for (int b = a + 1; b < np && nvert < 512; ++b)
      for (int c = b + 1; c < np && nvert < 512; ++c) {
        const double* n1 = planes[a].n;
        const double* n2 = planes[b].n;
        const double* n3 = planes[c].n;
        double det = n1[0] * (n2[1] * n3[2] - n2[2] * n3[1]) -
                     n1[1] * (n2[0] * n3[2] - n2[2] * n3[0]) +
                     n1[2] * (n2[0] * n3[1] - n2[1] * n3[0]);
        if (std::fabs(det) < 1e-12) continue;
        double d1 = planes[a].d, d2 = planes[b].d, d3 = planes[c].d;
        double x = (d1 * (n2[1] * n3[2] - n2[2] * n3[1]) -
                    n1[1] * (d2 * n3[2] - n2[2] * d3) +
                    n1[2] * (d2 * n3[1] - n2[1] * d3)) / det;
        double y = (n1[0] * (d2 * n3[2] - n2[2] * d3) -
                    d1 * (n2[0] * n3[2] - n2[2] * n3[0]) +
                    n1[2] * (n2[0] * d3 - d2 * n3[0])) / det;
        double z = (n1[0] * (n2[1] * d3 - d2 * n3[1]) -
                    n1[1] * (n2[0] * d3 - d2 * n3[0]) +
                    d1 * (n2[0] * n3[1] - n2[1] * n3[0])) / det;
        bool inside = true;
        for (int k = 0; k < np; ++k) {
          if (planes[k].n[0] * x + planes[k].n[1] * y + planes[k].n[2] * z >
              planes[k].d + tol) {
            inside = false;
            break;
          }
        }
        if (inside) { vx[nvert] = x; vy[nvert] = y; vz[nvert] = z; ++nvert; }
      }
  if (nvert < 4) return out;
  double cx = 0, cy = 0, cz = 0;
  for (int i = 0; i < nvert; ++i) { cx += vx[i]; cy += vy[i]; cz += vz[i]; }
  cx /= nvert; cy /= nvert; cz /= nvert;
  double cen[3] = {cx, cy, cz};
  for (int k = 0; k < np; ++k) {
    const double* n = planes[k].n;
    double d = planes[k].d;
    int idx[128];
    int m = 0;
    for (int i = 0; i < nvert && m < 128; ++i) {
      if (std::fabs(n[0] * vx[i] + n[1] * vy[i] + n[2] * vz[i] - d) <= 10 * tol)
        idx[m++] = i;
    }
    if (m < 3) continue;
    double t1[3];
    double ref[3] = {1.0, 0.0, 0.0};
    if (std::fabs(n[0]) > 0.9) { ref[0] = 0.0; ref[1] = 1.0; }
    cross(n, ref, t1);
    double l1 = std::sqrt(t1[0] * t1[0] + t1[1] * t1[1] + t1[2] * t1[2]);
    t1[0] /= l1; t1[1] /= l1; t1[2] /= l1;
    double t2[3];
    cross(n, t1, t2);
    double fx = 0, fy = 0, fz = 0;
    for (int j = 0; j < m; ++j) { fx += vx[idx[j]]; fy += vy[idx[j]]; fz += vz[idx[j]]; }
    fx /= m; fy /= m; fz /= m;
    double fcen[3] = {fx, fy, fz};
    double ang[128];
    for (int j = 0; j < m; ++j) {
      double rx = vx[idx[j]] - fx, ry = vy[idx[j]] - fy, rz = vz[idx[j]] - fz;
      ang[j] = std::atan2(rx * t2[0] + ry * t2[1] + rz * t2[2],
                          rx * t1[0] + ry * t1[1] + rz * t1[2]);
    }
    int order[128];
    for (int j = 0; j < m; ++j) order[j] = j;
    std::sort(order, order + m, [&](int a, int b) { return ang[a] < ang[b]; });
    for (int j = 0; j < m; ++j) {
      int ja = idx[order[j]];
      int jb = idx[order[(j + 1) % m]];
      double pa[3] = {vx[ja], vy[ja], vz[ja]};
      double pb[3] = {vx[jb], vy[jb], vz[jb]};
      add_tet_moments(fcen, pa, pb, cen, &out);
    }
  }
  return out;
}

struct Moments2 {
  double v = 0, m1[2] = {0, 0}, m2[3] = {0, 0, 0};  // xx, yy, xy
};

inline void add_tri_moments(const double* a, const double* b, const double* c,
                            Moments2* out) {
  double area = 0.5 * std::fabs((b[0] - a[0]) * (c[1] - a[1]) -
                                (c[0] - a[0]) * (b[1] - a[1]));
  if (area <= 0) return;
  out->v += area;
  double s0 = a[0] + b[0] + c[0];
  double s1 = a[1] + b[1] + c[1];
  out->m1[0] += area * s0 / 3.0;
  out->m1[1] += area * s1 / 3.0;
  const double f = area / 12.0;  // 1/((d+1)(d+2)) = 1/12 for d = 2
  double pxx = a[0] * a[0] + b[0] * b[0] + c[0] * c[0];
  double pyy = a[1] * a[1] + b[1] * b[1] + c[1] * c[1];
  double pxy = a[0] * a[1] + b[0] * b[1] + c[0] * c[1];
  out->m2[0] += f * (pxx + s0 * s0);
  out->m2[1] += f * (pyy + s1 * s1);
  out->m2[2] += f * (pxy + s0 * s1);
}

Moments2 intersect_moments_2d(const Plane2* planes_in, int np_in, double tol) {
  Moments2 out;
  Plane2 planes[2 * kMaxPlanes];
  int np = dedup_planes_2d(planes_in, np_in, planes, tol);
  double vx[128], vy[128];
  int nvert = 0;
  for (int a = 0; a < np && nvert < 128; ++a)
    for (int b = a + 1; b < np && nvert < 128; ++b) {
      double det = planes[a].n[0] * planes[b].n[1] - planes[a].n[1] * planes[b].n[0];
      if (std::fabs(det) < 1e-12) continue;
      double x = (planes[a].d * planes[b].n[1] - planes[a].n[1] * planes[b].d) / det;
      double y = (planes[a].n[0] * planes[b].d - planes[a].d * planes[b].n[0]) / det;
      bool inside = true;
      for (int k = 0; k < np; ++k)
        if (planes[k].n[0] * x + planes[k].n[1] * y > planes[k].d + tol) {
          inside = false;
          break;
        }
      if (inside) { vx[nvert] = x; vy[nvert] = y; ++nvert; }
    }
  if (nvert < 3) return out;
  double cx = 0, cy = 0;
  for (int i = 0; i < nvert; ++i) { cx += vx[i]; cy += vy[i]; }
  cx /= nvert; cy /= nvert;
  double ang[128];
  int order[128];
  for (int i = 0; i < nvert; ++i) {
    ang[i] = std::atan2(vy[i] - cy, vx[i] - cx);
    order[i] = i;
  }
  std::sort(order, order + nvert, [&](int a, int b) { return ang[a] < ang[b]; });
  double cen[2] = {cx, cy};
  for (int i = 0; i < nvert; ++i) {
    int a = order[i], b = order[(i + 1) % nvert];
    double pa[2] = {vx[a], vy[a]};
    double pb[2] = {vx[b], vy[b]};
    add_tri_moments(cen, pa, pb, &out);
  }
  return out;
}

double intersect_area_2d(const Plane2* planes_in, int np_in, double tol) {
  Plane2 planes[2 * kMaxPlanes];
  int np = dedup_planes_2d(planes_in, np_in, planes, tol);
  double vx[128], vy[128];
  int nvert = 0;
  for (int a = 0; a < np && nvert < 128; ++a)
    for (int b = a + 1; b < np && nvert < 128; ++b) {
      double det = planes[a].n[0] * planes[b].n[1] - planes[a].n[1] * planes[b].n[0];
      if (std::fabs(det) < 1e-12) continue;
      double x = (planes[a].d * planes[b].n[1] - planes[a].n[1] * planes[b].d) / det;
      double y = (planes[a].n[0] * planes[b].d - planes[a].d * planes[b].n[0]) / det;
      bool inside = true;
      for (int k = 0; k < np; ++k)
        if (planes[k].n[0] * x + planes[k].n[1] * y > planes[k].d + tol) {
          inside = false;
          break;
        }
      if (inside) { vx[nvert] = x; vy[nvert] = y; ++nvert; }
    }
  if (nvert < 3) return 0.0;
  double cx = 0, cy = 0;
  for (int i = 0; i < nvert; ++i) { cx += vx[i]; cy += vy[i]; }
  cx /= nvert; cy /= nvert;
  double ang[128];
  int order[128];
  for (int i = 0; i < nvert; ++i) {
    ang[i] = std::atan2(vy[i] - cy, vx[i] - cx);
    order[i] = i;
  }
  std::sort(order, order + nvert, [&](int a, int b) { return ang[a] < ang[b]; });
  double area2 = 0.0;
  for (int i = 0; i < nvert; ++i) {
    int a = order[i], b = order[(i + 1) % nvert];
    area2 += vx[a] * vy[b] - vx[b] * vy[a];
  }
  return 0.5 * std::fabs(area2);
}

// ---------------------------------------------------------------------------
// AABBs and the hash-grid broad phase.
// ---------------------------------------------------------------------------

void element_aabb(const double* verts, const int64_t* conn, int nv, int dim,
                  int64_t e, double* lo, double* hi) {
  const int64_t* el = conn + e * nv;
  for (int d = 0; d < dim; ++d) { lo[d] = 1e300; hi[d] = -1e300; }
  for (int i = 0; i < nv; ++i)
    for (int d = 0; d < dim; ++d) {
      double x = verts[dim * el[i] + d];
      lo[d] = std::min(lo[d], x);
      hi[d] = std::max(hi[d], x);
    }
}

struct HashGrid {
  double lo[3], inv_h[3];
  int dims[3];
  int dim;
  std::vector<std::vector<int64_t>> cells;

  void build(const double* verts, const int64_t* conn, int nv, int dim_,
             int64_t ne) {
    dim = dim_;
    double glo[3] = {1e300, 1e300, 1e300}, ghi[3] = {-1e300, -1e300, -1e300};
    std::vector<double> boxes(ne * 2 * dim);
    for (int64_t e = 0; e < ne; ++e) {
      element_aabb(verts, conn, nv, dim, e, &boxes[e * 2 * dim],
                   &boxes[e * 2 * dim + dim]);
      for (int d = 0; d < dim; ++d) {
        glo[d] = std::min(glo[d], boxes[e * 2 * dim + d]);
        ghi[d] = std::max(ghi[d], boxes[e * 2 * dim + dim + d]);
      }
    }
    // Grid resolution ~ cube-root of element count per axis.
    double target = std::pow(static_cast<double>(ne), 1.0 / dim);
    int64_t ncell = 1;
    for (int d = 0; d < dim; ++d) {
      dims[d] = std::max(1, static_cast<int>(target));
      lo[d] = glo[d];
      double ext = std::max(ghi[d] - glo[d], 1e-300);
      inv_h[d] = dims[d] / ext;
      ncell *= dims[d];
    }
    cells.assign(ncell, {});
    for (int64_t e = 0; e < ne; ++e) {
      int c0[3] = {0, 0, 0}, c1[3] = {0, 0, 0};
      for (int d = 0; d < dim; ++d) {
        c0[d] = clampi(static_cast<int>((boxes[e * 2 * dim + d] - lo[d]) * inv_h[d]), dims[d]);
        c1[d] = clampi(static_cast<int>((boxes[e * 2 * dim + dim + d] - lo[d]) * inv_h[d]), dims[d]);
      }
      for (int i = c0[0]; i <= c1[0]; ++i)
        for (int j = (dim > 1 ? c0[1] : 0); j <= (dim > 1 ? c1[1] : 0); ++j)
          for (int k = (dim > 2 ? c0[2] : 0); k <= (dim > 2 ? c1[2] : 0); ++k)
            cells[flat(i, j, k)].push_back(e);
    }
  }

  static int clampi(int x, int n) { return x < 0 ? 0 : (x >= n ? n - 1 : x); }
  int64_t flat(int i, int j, int k) const {
    return (static_cast<int64_t>(k) * (dim > 1 ? dims[1] : 1) + j) * dims[0] + i;
  }

  void query(const double* blo, const double* bhi, std::vector<int64_t>* out) const {
    int c0[3] = {0, 0, 0}, c1[3] = {0, 0, 0};
    for (int d = 0; d < dim; ++d) {
      c0[d] = clampi(static_cast<int>((blo[d] - lo[d]) * inv_h[d]), dims[d]);
      c1[d] = clampi(static_cast<int>((bhi[d] - lo[d]) * inv_h[d]), dims[d]);
    }
    out->clear();
    for (int i = c0[0]; i <= c1[0]; ++i)
      for (int j = (dim > 1 ? c0[1] : 0); j <= (dim > 1 ? c1[1] : 0); ++j)
        for (int k = (dim > 2 ? c0[2] : 0); k <= (dim > 2 ? c1[2] : 0); ++k)
          for (int64_t e : cells[flat(i, j, k)]) out->push_back(e);
    std::sort(out->begin(), out->end());
    out->erase(std::unique(out->begin(), out->end()), out->end());
  }
};

bool aabb_overlap(const double* lo1, const double* hi1, const double* lo2,
                  const double* hi2, int dim, double tol) {
  for (int d = 0; d < dim; ++d)
    if (hi1[d] < lo2[d] - tol || hi2[d] < lo1[d] - tol) return false;
  return true;
}

}  // namespace

extern "C" {

// P0 mortar coupling of two convex-cell meshes: emits COO triplets
// (slave element i, master element j, |T_i cap T_j|). Returns the triplet
// count, or -(needed) if max_out was too small.
int64_t mortar_p0_couple(const double* verts1, const int64_t* conn1,
                         int64_t ne1, const double* verts2,
                         const int64_t* conn2, int64_t ne2, int32_t nv1,
                         int32_t nv2, int32_t dim, double tol, int64_t* out_i,
                         int64_t* out_j, double* out_v, int64_t max_out) {
  HashGrid grid;
  grid.build(verts2, conn2, nv2, dim, ne2);
  int64_t count = 0;
  std::vector<int64_t> cands;
  double lo1[3], hi1[3], lo2[3], hi2[3];
  std::vector<Plane3> p3(2 * kMaxPlanes);
  std::vector<Plane2> p2(2 * kMaxPlanes);
  for (int64_t e1 = 0; e1 < ne1; ++e1) {
    element_aabb(verts1, conn1, nv1, dim, e1, lo1, hi1);
    grid.query(lo1, hi1, &cands);
    int np1 = 0;
    if (dim == 3) np1 = element_planes_3d(verts1, conn1, nv1, e1, p3.data());
    else np1 = element_planes_2d(verts1, conn1, nv1, e1, p2.data());
    for (int64_t e2 : cands) {
      element_aabb(verts2, conn2, nv2, dim, e2, lo2, hi2);
      if (!aabb_overlap(lo1, hi1, lo2, hi2, dim, tol)) continue;
      double vol = 0.0;
      if (dim == 3) {
        int np2 = element_planes_3d(verts2, conn2, nv2, e2, p3.data() + np1);
        vol = intersect_volume_3d(p3.data(), np1 + np2, tol);
      } else {
        int np2 = element_planes_2d(verts2, conn2, nv2, e2, p2.data() + np1);
        vol = intersect_area_2d(p2.data(), np1 + np2, tol);
      }
      if (vol > tol) {
        if (count < max_out) {
          out_i[count] = e1;
          out_j[count] = e2;
          out_v[count] = vol;
        }
        ++count;
      }
    }
  }
  return (count <= max_out) ? count : -count;
}

// Mortar coupling with full intersection moments: per pair emits volume,
// first moments (dim values) and second moments (dim*(dim+1)/2 values:
// 3D xx,yy,zz,xy,xz,yz; 2D xx,yy,xy). These are exactly the integrals
// needed to assemble ANY product of affine factors over the intersection -
// the composite-quadrature replacement powering the P1 (higher-order L2)
// and RT0 (VectorL2) mortar integrators.
int64_t mortar_moments_couple(const double* verts1, const int64_t* conn1,
                              int64_t ne1, const double* verts2,
                              const int64_t* conn2, int64_t ne2, int32_t nv1,
                              int32_t nv2, int32_t dim, double tol,
                              int64_t* out_i, int64_t* out_j, double* out_v,
                              double* out_m1, double* out_m2,
                              int64_t max_out) {
  HashGrid grid;
  grid.build(verts2, conn2, nv2, dim, ne2);
  int64_t count = 0;
  std::vector<int64_t> cands;
  double lo1[3], hi1[3], lo2[3], hi2[3];
  std::vector<Plane3> p3(2 * kMaxPlanes);
  std::vector<Plane2> p2(2 * kMaxPlanes);
  const int nm2 = (dim == 3) ? 6 : 3;
  for (int64_t e1 = 0; e1 < ne1; ++e1) {
    element_aabb(verts1, conn1, nv1, dim, e1, lo1, hi1);
    grid.query(lo1, hi1, &cands);
    int np1 = 0;
    if (dim == 3) np1 = element_planes_3d(verts1, conn1, nv1, e1, p3.data());
    else np1 = element_planes_2d(verts1, conn1, nv1, e1, p2.data());
    for (int64_t e2 : cands) {
      element_aabb(verts2, conn2, nv2, dim, e2, lo2, hi2);
      if (!aabb_overlap(lo1, hi1, lo2, hi2, dim, tol)) continue;
      double vol = 0.0;
      double m1[3] = {0, 0, 0}, m2[6] = {0, 0, 0, 0, 0, 0};
      if (dim == 3) {
        int np2 = element_planes_3d(verts2, conn2, nv2, e2, p3.data() + np1);
        Moments3 mm = intersect_moments_3d(p3.data(), np1 + np2, tol);
        vol = mm.v;
        std::memcpy(m1, mm.m1, sizeof(mm.m1));
        std::memcpy(m2, mm.m2, sizeof(mm.m2));
      } else {
        int np2 = element_planes_2d(verts2, conn2, nv2, e2, p2.data() + np1);
        Moments2 mm = intersect_moments_2d(p2.data(), np1 + np2, tol);
        vol = mm.v;
        std::memcpy(m1, mm.m1, sizeof(mm.m1));
        std::memcpy(m2, mm.m2, sizeof(mm.m2));
      }
      if (vol > tol) {
        if (count < max_out) {
          out_i[count] = e1;
          out_j[count] = e2;
          out_v[count] = vol;
          for (int d = 0; d < dim; ++d) out_m1[count * dim + d] = m1[d];
          for (int k = 0; k < nm2; ++k) out_m2[count * nm2 + k] = m2[k];
        }
        ++count;
      }
    }
  }
  return (count <= max_out) ? count : -count;
}

// Brute-force O(n^2) AABB intersection detection - the testing oracle for
// the hash-grid broad phase (reference keeps the same oracle,
// src/transfer/HashGrid.hpp:46-47). Returns pair count (or -needed).
int64_t detect_intersections_bruteforce(const double* verts1,
                                        const int64_t* conn1, int64_t ne1,
                                        const double* verts2,
                                        const int64_t* conn2, int64_t ne2,
                                        int32_t nv, int32_t dim, double tol,
                                        int64_t* out_i, int64_t* out_j,
                                        int64_t max_out) {
  int64_t count = 0;
  double lo1[3], hi1[3], lo2[3], hi2[3];
  for (int64_t e1 = 0; e1 < ne1; ++e1) {
    element_aabb(verts1, conn1, nv, dim, e1, lo1, hi1);
    for (int64_t e2 = 0; e2 < ne2; ++e2) {
      element_aabb(verts2, conn2, nv, dim, e2, lo2, hi2);
      if (aabb_overlap(lo1, hi1, lo2, hi2, dim, tol)) {
        if (count < max_out) { out_i[count] = e1; out_j[count] = e2; }
        ++count;
      }
    }
  }
  return (count <= max_out) ? count : -count;
}

// Volume (3D) / area (2D) of one convex element - unit-test helper.
double element_measure(const double* verts, const int64_t* conn, int32_t nv,
                       int32_t dim, int64_t e, double tol) {
  if (dim == 3) {
    Plane3 p[kMaxPlanes];
    int np = element_planes_3d(verts, conn, nv, e, p);
    return intersect_volume_3d(p, np, tol);
  }
  Plane2 p[kMaxPlanes];
  int np = element_planes_2d(verts, conn, nv, e, p);
  return intersect_area_2d(p, np, tol);
}

}  // extern "C"
