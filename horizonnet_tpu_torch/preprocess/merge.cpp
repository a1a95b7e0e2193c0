// Sequential great-circle segment merging for combine_edges.
//
// Exact C++ twin of the Python merge rounds in preprocess/lines.py
// (combine_edges, itself re-engineered from the reference's combineEdgesN,
// misc/pano_lsd_align.py:348-436): per round, a 5-degree candidate
// prefilter on round-start normals, then an in-order scan where line i
// absorbs every still-valid candidate j whose current normal is within
// 1 degree and whose azimuth range overlaps; the merged normal is
// arclength-weighted and the merged range re-measured on the sphere.
//
// The scan is inherently sequential (line i's row mutates as it absorbs
// neighbours, and absorbed rows drop out of later scans), which is why it
// lives here rather than in numpy/JAX: the Python loop over ~3k segments
// was the single largest cost of the whole VP-alignment stage.
//
// Layout: rows of 8 doubles [nx ny nz planeID umin umax arclen score],
// ranges in turns (0..1). Compiled with plain -O2 (no -ffast-math) so the
// float64 results track the numpy implementation to rounding error.

#include <cmath>
#include <cstring>
#include <vector>

namespace {

const double kCos5 = std::cos(5.0 * M_PI / 180.0);
const double kCos1 = std::cos(M_PI / 180.0);

inline bool inside_range(double pt, double r0, double r1) {
  if (r1 > r0) return r0 <= pt && pt <= r1;
  return (r0 <= pt && pt <= 1.0) || (0.0 <= pt && pt <= r1);
}

// Open overlap of two possibly seam-wrapping turn ranges
// (preprocess/lines.py:_range_intersects).
inline bool range_intersects(double a0, double a1, double b0, double b1) {
  double au[2][2], bu[2][2];
  int na = 1, nb = 1;
  if (a1 < a0) { au[0][0] = a0; au[0][1] = 1.0; au[1][0] = 0.0; au[1][1] = a1; na = 2; }
  else         { au[0][0] = a0; au[0][1] = a1; }
  if (b1 < b0) { bu[0][0] = b0; bu[0][1] = 1.0; bu[1][0] = 0.0; bu[1][1] = b1; nb = 2; }
  else         { bu[0][0] = b0; bu[0][1] = b1; }
  for (int x = 0; x < na; ++x)
    for (int y = 0; y < nb; ++y)
      if (std::fmax(au[x][0], bu[y][0]) < std::fmin(au[x][1], bu[y][1]))
        return true;
  return false;
}

// v of the great circle with normal n at azimuth u (sphere.py:computeUVN).
inline double compute_v(const double n[3], double u, int plane_id) {
  double a = n[0], b = n[1], c = n[2];
  if (plane_id == 2)      { a = n[1]; b = n[2]; c = n[0]; }
  else if (plane_id == 3) { a = n[2]; b = n[0]; c = n[1]; }
  return std::atan(-(a * std::sin(u) + b * std::cos(u)) / (c + 1e-9));
}

// (u, v) -> unit vector in the planeID convention (sphere.py:uv2xyzN).
inline void uv_to_xyz(double u, double v, int plane_id, double out[3]) {
  int id1 = (plane_id - 1) % 3;
  int id2 = plane_id % 3;
  int id3 = (plane_id + 1) % 3;
  out[id1] = std::cos(v) * std::sin(u);
  out[id2] = std::cos(v) * std::cos(u);
  out[id3] = std::sin(v);
}

}  // namespace

extern "C" {

// lines: n rows of 8 doubles, modified in place and compacted after each
// round. Returns the surviving row count. ev_buf (optional, test-only):
// records merge events as (round, i, j) int triples, up to ev_cap
// triples; *ev_n receives the event count.
int combine_edges_merge_ev(double* lines, int n, int rounds,
                           int* ev_buf, int ev_cap, int* ev_n) {
  if (ev_n) *ev_n = 0;
  std::vector<double> sx, sy, sz;  // round-start normals, SoA
  std::vector<double> pre;
  std::vector<unsigned char> valid;
  std::vector<int> cand;

  for (int round = 0; round < rounds; ++round) {
    sx.resize(n);
    sy.resize(n);
    sz.resize(n);
    for (int i = 0; i < n; ++i) {
      sx[i] = lines[8 * i];
      sy[i] = lines[8 * i + 1];
      sz[i] = lines[8 * i + 2];
    }
    valid.assign(n, 1);
    pre.resize(n);

    for (int i = 0; i < n; ++i) {
      if (!valid[i]) continue;
      double* li = lines + 8 * i;
      // Entry-time normal of i gates the 1-degree test for every j in
      // this scan, even as row i mutates below (numpy evaluates `dots`
      // once per i).
      const double ni0 = li[0], ni1 = li[1], ni2 = li[2];
      // 5-degree prefilter on round-start normals, branch-free over all
      // j so the compiler vectorizes it (the branchy scalar form was
      // ~80% of the merge cost); validity/identity filtering and the
      // exact 1-degree test on current normals follow on the survivors.
      const double a = sx[i], b = sy[i], c = sz[i];
      for (int j = 0; j < n; ++j)
        pre[j] = std::fabs(a * sx[j] + b * sy[j] + c * sz[j]);
      cand.clear();
      for (int j = 0; j < n; ++j) {
        if (pre[j] <= kCos5 || j == i || !valid[j]) continue;
        const double* lj = lines + 8 * j;
        if (std::fabs(ni0 * lj[0] + ni1 * lj[1] + ni2 * lj[2]) > kCos1)
          cand.push_back(j);
      }
      for (int j : cand) {
        double* lj = lines + 8 * j;
        if (!range_intersects(li[4], li[5], lj[4], lj[5])) continue;
        if (ev_buf && *ev_n < ev_cap) {
          ev_buf[3 * *ev_n] = round; ev_buf[3 * *ev_n + 1] = i;
          ev_buf[3 * *ev_n + 2] = j; ++*ev_n;
        }

        // Arclength-weighted merged normal, sign-aligned on i's
        // dominant axis (current row values, as in numpy).
        int axis = 0;
        if (std::fabs(li[1]) > std::fabs(li[axis])) axis = 1;
        if (std::fabs(li[2]) > std::fabs(li[axis])) axis = 2;
        double sign = (li[axis] * lj[axis] > 0) ? 1.0 : -1.0;
        double nc[3];
        for (int k = 0; k < 3; ++k)
          nc[k] = li[k] * li[6] + sign * lj[k] * lj[6];
        double nn = std::sqrt(nc[0] * nc[0] + nc[1] * nc[1] + nc[2] * nc[2]);
        for (int k = 0; k < 3; ++k) nc[k] /= nn;

        double nrmin = inside_range(li[4], lj[4], lj[5]) ? lj[4] : li[4];
        double nrmax = inside_range(li[5], lj[4], lj[5]) ? lj[5] : li[5];

        int plane_id = (int)li[3];
        double u0 = nrmin * 2.0 * M_PI - M_PI;
        double u1 = nrmax * 2.0 * M_PI - M_PI;
        double p0[3], p1[3];
        uv_to_xyz(u0, compute_v(nc, u0, plane_id), plane_id, p0);
        uv_to_xyz(u1, compute_v(nc, u1, plane_id), plane_id, p1);
        double d = p0[0] * p1[0] + p0[1] * p1[1] + p0[2] * p1[2];
        if (d > 1.0) d = 1.0;
        if (d < -1.0) d = -1.0;
        double arclen = std::acos(d);
        double score = (li[6] * li[7] + lj[6] * lj[7]) / (li[6] + lj[6]);

        li[0] = nc[0]; li[1] = nc[1]; li[2] = nc[2];
        li[4] = nrmin; li[5] = nrmax; li[6] = arclen; li[7] = score;
        valid[j] = 0;
      }
    }

    int m = 0;
    for (int i = 0; i < n; ++i) {
      if (!valid[i]) continue;
      if (m != i) std::memcpy(lines + 8 * m, lines + 8 * i, 8 * sizeof(double));
      ++m;
    }
    n = m;
  }
  return n;
}

int combine_edges_merge(double* lines, int n, int rounds) {
  int ev_n = 0;
  return combine_edges_merge_ev(lines, n, rounds, nullptr, 0, &ev_n);
}

}  // extern "C"
