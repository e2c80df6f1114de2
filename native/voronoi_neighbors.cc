// Periodic Voronoi neighbour finder for the radiative-transfer build.
//
// Native-preprocessing equivalent of the reference's voro++ driver
// (rt_preprocessing/output_sites.cc): container periodic in x and y,
// walled in z (bottom wall id -5, top wall id -6), emitting per-site
// Delaunay neighbour id lists.  Written from scratch: incremental convex
// cell clipping against perpendicular bisectors of block-sorted candidate
// sites with a security-radius termination, multithreaded over sites.
//
// Also provides BFS wavefront layering (the plan-build step of
// src/voronoi_utils.jl:93-174) so the host-side Python plan builder never
// loops over millions of sites.
//
// C API (see voronoirt_tpu/grid/neighbors.py for the ctypes binding):
//   vrt_build_neighbors(...)  -> CSR neighbour lists
//   vrt_bfs_layers(...)       -> per-site layer index from a wall
//
// A CLI with the reference-compatible signature
//   output_sites sites_file neighbours_file x_min x_max y_min y_max z_min z_max
// is built from cli_main.cc.

#include <algorithm>
#include <limits>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

// Convex polyhedron with face bookkeeping for neighbour ids.
// Faces: id >= 0 is a site (bisector) face, negative ids are walls:
//   -1,-2: x box sides, -3,-4: y box sides, -5: bottom z wall, -6: top z wall
struct Face {
  int id;
  std::vector<int> verts;  // ordered polygon (indices into verts array)
};

struct Cell {
  std::vector<V3> verts;
  std::vector<Face> faces;

  // max squared distance of any vertex from the cell's site
  double max_r2(const V3& c) const {
    double m = 0;
    for (const auto& v : verts) {
      double dx = v.x - c.x, dy = v.y - c.y, dz = v.z - c.z;
      m = std::max(m, dx * dx + dy * dy + dz * dz);
    }
    return m;
  }
};

// Initialise the cell as the box [cx-hx, cx+hx] x [cy-hy, cy+hy] x [z0, z1].
void init_box(Cell& c, double cx, double cy, double hx, double hy, double z0,
              double z1) {
  c.verts.clear();
  c.faces.clear();
  double x0 = cx - hx, x1 = cx + hx, y0 = cy - hy, y1 = cy + hy;
  c.verts = {{x0, y0, z0}, {x1, y0, z0}, {x1, y1, z0}, {x0, y1, z0},
             {x0, y0, z1}, {x1, y0, z1}, {x1, y1, z1}, {x0, y1, z1}};
  // CCW as seen from outside
  c.faces = {
      {-5, {0, 3, 2, 1}},  // bottom (z = z0)
      {-6, {4, 5, 6, 7}},  // top (z = z1)
      {-1, {0, 4, 7, 3}},  // x = x0
      {-2, {1, 2, 6, 5}},  // x = x1
      {-3, {0, 1, 5, 4}},  // y = y0
      {-4, {3, 7, 6, 2}},  // y = y1
  };
}

// Clip the cell by half-space n.(v - m) <= 0 where m is the bisector
// midpoint; record the new face with `id`.  Returns false if no cut.
bool clip(Cell& c, const V3& n, const V3& m, int id, double eps) {
  const size_t nv = c.verts.size();  // rollback point for failed cuts
  std::vector<double> d(nv);
  int npos = 0;
  for (size_t i = 0; i < nv; ++i) {
    const V3& v = c.verts[i];
    d[i] = n.x * (v.x - m.x) + n.y * (v.y - m.y) + n.z * (v.z - m.z);
    if (d[i] > eps) ++npos;
  }
  if (npos == 0) return false;  // plane misses the cell

  // Edge-keyed cache of intersection vertices (edge = sorted vert pair).
  struct EdgeCut {
    int a, b, vid;
  };
  std::vector<EdgeCut> cuts;
  auto cut_vertex = [&](int a, int b) -> int {
    if (a > b) std::swap(a, b);
    for (const auto& e : cuts)
      if (e.a == a && e.b == b) return e.vid;
    double t = d[a] / (d[a] - d[b]);
    const V3& va = c.verts[a];
    const V3& vb = c.verts[b];
    V3 p{va.x + t * (vb.x - va.x), va.y + t * (vb.y - va.y),
         va.z + t * (vb.z - va.z)};
    int vid = static_cast<int>(c.verts.size());
    c.verts.push_back(p);
    d.push_back(0.0);
    cuts.push_back({a, b, vid});
    return vid;
  };

  // Clip every face polygon; collect the boundary edges of the new face.
  std::vector<std::pair<int, int>> new_edges;  // directed (entry, exit)
  std::vector<Face> out_faces;
  out_faces.reserve(c.faces.size() + 1);
  for (auto& f : c.faces) {
    std::vector<int> poly;
    int entry = -1, exit = -1;
    const size_t np = f.verts.size();
    for (size_t i = 0; i < np; ++i) {
      int a = f.verts[i];
      int b = f.verts[(i + 1) % np];
      bool ina = d[a] <= eps;
      bool inb = d[b] <= eps;
      if (ina) poly.push_back(a);
      if (ina != inb && std::abs(d[a] - d[b]) > 0) {
        int vc = cut_vertex(a, b);
        poly.push_back(vc);
        if (ina)
          exit = vc;  // leaving the kept side
        else
          entry = vc;  // entering the kept side
      }
    }
    if (poly.size() >= 3) {
      out_faces.push_back({f.id, std::move(poly)});
      // The clipped face traverses its cut edge as (exit -> entry); the
      // cap face must traverse it reversed, (entry -> exit), to keep the
      // polyhedron consistently outward-oriented -- orientation drives
      // the entry/exit classification of later cuts.
      if (entry >= 0 && exit >= 0) new_edges.push_back({entry, exit});
    }
  }
  if (new_edges.size() < 3) {
    // Grazing/degenerate contact (sliver thinner than eps, or the plane
    // passes exactly through vertices of a symmetric configuration):
    // treat as no cut and leave the cell EXACTLY as it was -- committing
    // a partial cut without its closing face corrupts the cell.
    c.verts.resize(nv);
    return false;
  }

  // Chain the boundary edges into the new face polygon.
  Face nf;
  nf.id = id;
  nf.verts.push_back(new_edges[0].first);
  nf.verts.push_back(new_edges[0].second);
  new_edges.erase(new_edges.begin());
  while (!new_edges.empty()) {
    int tail = nf.verts.back();
    bool found = false;
    for (size_t i = 0; i < new_edges.size(); ++i) {
      if (new_edges[i].first == tail) {
        nf.verts.push_back(new_edges[i].second);
        new_edges.erase(new_edges.begin() + i);
        found = true;
        break;
      }
    }
    if (!found) break;  // open chain (numerical); accept what we have
  }
  if (nf.verts.size() >= 2 && nf.verts.front() == nf.verts.back())
    nf.verts.pop_back();
  out_faces.push_back(std::move(nf));
  c.faces = std::move(out_faces);

  // Compact: drop vertices no longer referenced.
  std::vector<int> remap(c.verts.size(), -1);
  std::vector<V3> nverts;
  for (auto& f : c.faces)
    for (int& vi : f.verts) {
      if (remap[vi] < 0) {
        remap[vi] = static_cast<int>(nverts.size());
        nverts.push_back(c.verts[vi]);
      }
      vi = remap[vi];
    }
  c.verts = std::move(nverts);
  return true;
}

struct Grid {
  double x0, y0, z0, lx, ly, lz;
  int nx, ny, nz;
  std::vector<std::vector<int>> blocks;

  int bidx(int ix, int iy, int iz) const { return (iz * ny + iy) * nx + ix; }
};

void build_grid(Grid& g, const double* xs, const double* ys, const double* zs,
                int64_t n, double x0, double x1, double y0, double y1,
                double z0, double z1) {
  double vol = (x1 - x0) * (y1 - y0) * (z1 - z0);
  double target = std::cbrt(vol / std::max<int64_t>(n, 1) * 4.0);
  g.x0 = x0;
  g.y0 = y0;
  g.z0 = z0;
  g.nx = std::max(1, (int)((x1 - x0) / target));
  g.ny = std::max(1, (int)((y1 - y0) / target));
  g.nz = std::max(1, (int)((z1 - z0) / target));
  g.lx = (x1 - x0) / g.nx;
  g.ly = (y1 - y0) / g.ny;
  g.lz = (z1 - z0) / g.nz;
  g.blocks.assign((size_t)g.nx * g.ny * g.nz, {});
  for (int64_t i = 0; i < n; ++i) {
    int ix = std::min(g.nx - 1, std::max(0, (int)((xs[i] - x0) / g.lx)));
    int iy = std::min(g.ny - 1, std::max(0, (int)((ys[i] - y0) / g.ly)));
    int iz = std::min(g.nz - 1, std::max(0, (int)((zs[i] - z0) / g.lz)));
    g.blocks[g.bidx(ix, iy, iz)].push_back((int)i);
  }
}

struct Cand {
  double r2;
  int id;
  V3 pos;
};

}  // namespace

extern "C" {

// Build Voronoi neighbour lists.
//   xs, ys, zs: site coordinates, length n
//   box: x_min x_max y_min y_max z_min z_max; periodic in x, y; z walled
//   out_counts: length n (neighbours per site, walls included)
//   out_neighbors: length n*max_nb, 0-based site ids; walls: -5 bottom,
//                  -6 top (other negative wall ids cannot survive with a
//                  valid periodic configuration but are passed through)
// Returns max neighbour count seen, or -1-overflow_count if max_nb was
// too small (lists are truncated).
int vrt_build_neighbors(const double* xs, const double* ys, const double* zs,
                        int64_t n, double x_min, double x_max, double y_min,
                        double y_max, double z_min, double z_max, int max_nb,
                        int32_t* out_counts, int32_t* out_neighbors,
                        int n_threads) {
  Grid grid;
  build_grid(grid, xs, ys, zs, n, x_min, x_max, y_min, y_max, z_min, z_max);
  const double Lx = x_max - x_min, Ly = y_max - y_min;
  const double eps = 1e-11 * std::max({Lx, Ly, z_max - z_min});
  std::atomic<int> max_count{0};
  std::atomic<int> overflow{0};

  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());

  auto worker = [&](int64_t lo, int64_t hi) {
    Cell cell;
    std::vector<Cand> cands;
    for (int64_t i = lo; i < hi; ++i) {
      const V3 p{xs[i], ys[i], zs[i]};
      // candidate gathering: expand rings of blocks around the site until
      // the security radius is covered; periodic wrap in x and y.
      init_box(cell, p.x, p.y, 0.5 * Lx, 0.5 * Ly, z_min, z_max);

      int cx = std::min(grid.nx - 1,
                        std::max(0, (int)((p.x - grid.x0) / grid.lx)));
      int cy = std::min(grid.ny - 1,
                        std::max(0, (int)((p.y - grid.y0) / grid.ly)));
      int cz = std::min(grid.nz - 1,
                        std::max(0, (int)((p.z - grid.z0) / grid.lz)));

      double sec_r2 = cell.max_r2(p);  // shrinks as we clip
      int ring = 0;
      size_t next_cand = 0;
      bool done = false;
      while (!done) {
        // collect candidates in the current ring of blocks
        size_t before = cands.size();
        int zlo = cz - ring, zhi = cz + ring;
        for (int dz = -ring; dz <= ring; ++dz) {
          int iz = cz + dz;
          if (iz < 0 || iz >= grid.nz) continue;
          for (int dy = -ring; dy <= ring; ++dy) {
            for (int dx = -ring; dx <= ring; ++dx) {
              if (std::max({std::abs(dx), std::abs(dy), std::abs(dz)}) !=
                  ring)
                continue;  // ring shell only
              int ix = cx + dx, iy = cy + dy;
              double ox = 0, oy = 0;
              // periodic wrap in x, y
              if (ix < 0) {
                ix += grid.nx;
                ox = -Lx;
              } else if (ix >= grid.nx) {
                ix -= grid.nx;
                ox = Lx;
              }
              if (iy < 0) {
                iy += grid.ny;
                oy = -Ly;
              } else if (iy >= grid.ny) {
                iy -= grid.ny;
                oy = Ly;
              }
              if (ix < 0 || ix >= grid.nx || iy < 0 || iy >= grid.ny)
                continue;  // box thinner than the ring; wrapped twice
              for (int id : grid.blocks[grid.bidx(ix, iy, iz)]) {
                if (id == (int)i && ox == 0 && oy == 0) continue;
                V3 q{xs[id] + ox, ys[id] + oy, zs[id]};
                double ddx = q.x - p.x, ddy = q.y - p.y, ddz = q.z - p.z;
                cands.push_back({ddx * ddx + ddy * ddy + ddz * ddz, id, q});
              }
            }
          }
        }
        (void)zlo;
        (void)zhi;
        std::sort(cands.begin() + before, cands.end(),
                  [](const Cand& a, const Cand& b) { return a.r2 < b.r2; });
        // merge-in-order processing: candidates within this ring are
        // sorted; rings are processed in order of min possible distance.
        for (; next_cand < cands.size(); ++next_cand) {
          const Cand& cd = cands[next_cand];
          if (cd.r2 > 4.0 * sec_r2) continue;  // cannot cut
          V3 mid{0.5 * (p.x + cd.pos.x), 0.5 * (p.y + cd.pos.y),
                 0.5 * (p.z + cd.pos.z)};
          V3 nrm{cd.pos.x - p.x, cd.pos.y - p.y, cd.pos.z - p.z};
          if (clip(cell, nrm, mid, cd.id, eps)) sec_r2 = cell.max_r2(p);
        }
        // termination: the next unexplored ring's nearest possible point
        // is farther than the security radius
        double ring_dist = ring * std::min({grid.lx, grid.ly, grid.lz});
        if (ring_dist * ring_dist > 4.0 * sec_r2 ||
            ring > std::max({grid.nx, grid.ny, grid.nz})) {
          done = true;
        }
        ++ring;
      }
      cands.clear();

      // gather surviving face ids (dedup; periodic images of the same id
      // appear once per face like voro++ %n output)
      int cnt = 0;
      bool over = false;
      for (const auto& f : cell.faces) {
        if (f.id == -1 || f.id == -2 || f.id == -3 || f.id == -4)
          continue;  // half-period box sides: not physical neighbours
        if (cnt < max_nb)
          out_neighbors[(size_t)i * max_nb + cnt] = f.id;
        else
          over = true;
        ++cnt;
      }
      out_counts[i] = std::min(cnt, max_nb);
      int prev = max_count.load();
      while (cnt > prev && !max_count.compare_exchange_weak(prev, cnt)) {
      }
      if (over) overflow.fetch_add(1);
    }
  };

  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min<int64_t>(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();

  if (overflow.load() > 0) return -1 - overflow.load();
  return max_count.load();
}

// Topological levelling of the per-direction 2-upwind dependency DAG.
//
// Every active dependency edge (upwind -> site) strictly increases the
// projection s = pos . k in UNWRAPPED coordinates, so the graph is a DAG
// except for chains that wrap the periodic x/y seam.  Kahn-peel exact
// levels: level 0 = boundary sites (intensity fixed), level(i) =
// 1 + max(level(deps)).  Sites caught in seam cycles keep level -1 and
// are ordered separately by the caller (s-binned relaxation).
//
//   upwind: n*2 upwind site ids; active: n*2 flags (blend weight > 0);
//   is_bc: boundary mask; out_levels: -1 = stuck in a seam cycle.
void vrt_topo_levels(const int32_t* upwind, const uint8_t* active,
                     const uint8_t* is_bc, int64_t n, int32_t* out_levels) {
  std::vector<int32_t> pending(n, 0);
  std::vector<int64_t> rev_cnt(n + 1, 0);
  for (int64_t i = 0; i < n; ++i) {
    out_levels[i] = -1;
    if (is_bc[i]) continue;
    for (int j = 0; j < 2; ++j) {
      int32_t d = upwind[i * 2 + j];
      if (active[i * 2 + j] && d != (int32_t)i && d >= 0 && d < n) {
        ++pending[i];
        ++rev_cnt[d + 1];
      }
    }
  }
  // CSR reverse adjacency: nodes depending on d
  for (int64_t i = 0; i < n; ++i) rev_cnt[i + 1] += rev_cnt[i];
  std::vector<int32_t> rev(rev_cnt[n]);
  {
    std::vector<int64_t> fill(rev_cnt.begin(), rev_cnt.end() - 1);
    for (int64_t i = 0; i < n; ++i) {
      if (is_bc[i]) continue;
      for (int j = 0; j < 2; ++j) {
        int32_t d = upwind[i * 2 + j];
        if (active[i * 2 + j] && d != (int32_t)i && d >= 0 && d < n)
          rev[fill[d]++] = (int32_t)i;
      }
    }
  }
  std::vector<int32_t> queue;
  std::vector<int32_t> maxlev(n, -1);  // max level among resolved deps
  queue.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    if (is_bc[i]) {
      out_levels[i] = 0;
      queue.push_back((int32_t)i);
    } else if (pending[i] == 0) {
      out_levels[i] = 1;  // no active upwind: constant (zero-weight) site
      queue.push_back((int32_t)i);
    }
  }
  for (size_t qi = 0; qi < queue.size(); ++qi) {
    int32_t i = queue[qi];
    int32_t li = out_levels[i];
    for (int64_t e = rev_cnt[i]; e < rev_cnt[i + 1]; ++e) {
      int32_t j = rev[e];
      if (out_levels[j] >= 0) continue;  // already resolved
      if (maxlev[j] < li) maxlev[j] = li;
      // level = 1 + max over ALL deps (queue order does not follow
      // levels -- the init segment mixes levels 0 and 1)
      if (--pending[j] == 0) {
        out_levels[j] = maxlev[j] + 1;
        queue.push_back(j);
      }
    }
  }
}

// Per-direction upwind selection + path lengths -- the hot half of the
// host plan build (src/voronoi_utils.jl:282-396 smallest_angle;
// grid/voronoi.py build_voronoi_plan).  Arithmetic follows the numpy
// reference path (dots as (l0*k0 + l1*k1) + l2*k2, norms as
// sqrt((dz^2 + dx^2) + dy^2), half-even rounding for the minimum
// image; the Makefile sets -ffp-contract=off): upwind choices and
// path lengths are bit-identical to the numpy build; raw dots may
// sit 1 ulp from the BLAS matvec (tests/test_native_plan.py).
//
//   lines: n*W*3 unit vectors (z,x,y); neighbours: n*(W+1), col 0 count;
//   pos: n*3 (z,x,y); compat_reference: 1 = the reference's STREAMING
//   top-2 (a new maximum overwrites slot 1 without demoting), 0 = true
//   top-2.  Outputs: upwind n*2 (cleaned ids), d12 n*2 (cleaned dots,
//   ready for the blend-weight pow), r_raw n*2 (unwrapped euclidean),
//   r_mi n*2 (x/y minimum image).
void vrt_upwind_select(const double* lines, const int32_t* neighbours,
                       const double* pos, int64_t n, int W,
                       const double* kvec, int compat_reference,
                       double Lx, double Ly,
                       int32_t* upwind, double* d12,
                       double* r_raw, double* r_mi, int n_threads) {
  const double k0 = kvec[0], k1 = kvec[1], k2 = kvec[2];
  if (n_threads <= 0)
    n_threads = std::max(1u, std::thread::hardware_concurrency());

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      const int32_t* nb = neighbours + i * (int64_t)(W + 1);
      const int count = std::min(nb[0], (int32_t)W);
      const double* li = lines + i * (int64_t)W * 3;
      double d1, d2;
      int32_t u1 = 0, u2 = 0;
      if (compat_reference) {
        d1 = -1.0; d2 = -1.0;
        for (int w = 0; w < count; ++w) {
          int32_t id = nb[1 + w];
          if (id < 0) continue;               // wall: dot = -inf
          const double* l = li + (int64_t)w * 3;
          double m0 = l[0] * k0, m1 = l[1] * k1, m2 = l[2] * k2;
          double d = (m0 + m1) + m2;
          if (d > d2) {
            if (d > d1) { d1 = d; u1 = id; }  // no demotion (reference)
            else        { d2 = d; u2 = id; }
          }
        }
        u1 = (d1 > -1.0) ? u1 : 0;
      } else {
        d1 = -std::numeric_limits<double>::infinity();
        d2 = d1;
        for (int w = 0; w < count; ++w) {
          int32_t id = nb[1 + w];
          if (id < 0) continue;
          const double* l = li + (int64_t)w * 3;
          double m0 = l[0] * k0, m1 = l[1] * k1, m2 = l[2] * k2;
          double d = (m0 + m1) + m2;
          if (d > d1) { d2 = d1; u2 = u1; d1 = d; u1 = id; }
          else if (d > d2) { d2 = d; u2 = id; }
        }
        if (W == 1) { d2 = d1; u2 = u1; }
        u1 = std::isfinite(d1) ? u1 : 0;
      }
      const bool bad2 = !(d2 > 0.0);          // <=0 and -inf/nan
      u2 = bad2 ? u1 : u2;
      d2 = bad2 ? 0.0 : d2;
      d1 = std::isfinite(d1) ? std::max(d1, 0.0) : 0.0;
      upwind[i * 2] = u1;
      upwind[i * 2 + 1] = u2;
      d12[i * 2] = d1;
      d12[i * 2 + 1] = d2;
      const double* pi = pos + i * 3;
      const int32_t us[2] = {u1, u2};
      for (int s = 0; s < 2; ++s) {
        const double* pu = pos + (int64_t)us[s] * 3;
        double dz = pu[0] - pi[0];
        double dx = pu[1] - pi[1];
        double dy = pu[2] - pi[2];
        double z2 = dz * dz, x2 = dx * dx, y2 = dy * dy;
        r_raw[i * 2 + s] = std::sqrt((z2 + x2) + y2);
        double dxm = dx - Lx * std::nearbyint(dx / Lx);
        double dym = dy - Ly * std::nearbyint(dy / Ly);
        double xm2 = dxm * dxm, ym2 = dym * dym;
        r_mi[i * 2 + s] = std::sqrt((z2 + xm2) + ym2);
      }
    }
  };
  std::vector<std::thread> threads;
  int64_t chunk = (n + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk, hi = std::min(n, lo + chunk);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
}

// BFS wavefront layering (src/voronoi_utils.jl:93-174): layer 1 = sites
// adjacent to `wall_id` (-5 bottom / -6 top); layer k+1 = sites adjacent
// to layer k.  counts/neighbors: CSR-ish fixed-stride lists from
// vrt_build_neighbors.  out_layers: per-site layer (1-based).
void vrt_bfs_layers(const int32_t* counts, const int32_t* neighbors,
                    int64_t n, int max_nb, int wall_id, int32_t* out_layers) {
  std::vector<int32_t> frontier, next;
  for (int64_t i = 0; i < n; ++i) {
    out_layers[i] = 0;
    const int32_t* nb = neighbors + i * max_nb;
    for (int j = 0; j < counts[i]; ++j)
      if (nb[j] == wall_id) {
        out_layers[i] = 1;
        frontier.push_back((int32_t)i);
        break;
      }
  }
  // reverse adjacency is symmetric (Delaunay), so forward BFS works
  int layer = 1;
  int64_t assigned = frontier.size();
  while (assigned < n && !frontier.empty()) {
    next.clear();
    for (int32_t i : frontier) {
      const int32_t* nb = neighbors + (int64_t)i * max_nb;
      for (int j = 0; j < counts[i]; ++j) {
        int32_t v = nb[j];
        if (v >= 0 && out_layers[v] == 0) {
          out_layers[v] = layer + 1;
          next.push_back(v);
        }
      }
    }
    frontier.swap(next);
    assigned += frontier.size();
    ++layer;
  }
  // isolated sites (shouldn't happen): dump into the last layer
  for (int64_t i = 0; i < n; ++i)
    if (out_layers[i] == 0) out_layers[i] = layer + 1;
}

}  // extern "C"
