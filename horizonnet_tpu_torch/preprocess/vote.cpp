// Orthogonal-triple search of the icosahedral sphere Hough vote — the
// C++ twin of preprocess/vanishing.py _search_triples (reference
// behavior: misc/pano_lsd_align.py:547-607 sphereHoughVote inner loops).
//
// The numpy form spends its time in per-outer-bin small-array overhead
// (~180 iterations of [N, K] products over a few hundred bins); the
// total arithmetic is only a few Mflop, so a direct scalar loop is an
// order of magnitude faster. Semantics are kept exactly:
//   - iteration order: b1 in the given check1 order, b2 ascending,
//     third-bin argmax = first maximum (ties -> smallest index),
//   - candidate tests: |bins[b1].bins[b2]| < orth_cos;
//     |bins[i].cross| / |cross| > third_cos with nonzero[i],
//   - strict-> acceptance of a better total, replicating _accept's
//     last_cost / last_angle bookkeeping (angle vs the PREVIOUS best).
//
// Exposed via a flat C ABI consumed by preprocess/native.py.

#include <cmath>
#include <cstddef>

namespace {

inline double dot3(const double *a, const double *b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

}  // namespace

extern "C" {

// bins [n,3] row-major unit vectors; votes [n]; check1 [n_check] outer
// bin indices in scan order; nonzero [n] 0/1. Outputs: best_out[3]
// (bin indices, zeros if nothing accepted), vote_max_out,
// last_cost_out, last_angle_out[3].
void vote_search_triples(const double *bins, const double *votes, int n,
                         const int *check1, int n_check,
                         const unsigned char *nonzero, double orth_cos,
                         double third_cos, int force_unempty,
                         int *best_out, double *vote_max_out,
                         double *last_cost_out, double *last_angle_out) {
  int best[3] = {0, 0, 0};
  double vote_max = 0.0;
  double last_cost = 0.0;
  double last_angle[3] = {0.0, 0.0, 0.0};

  for (int c = 0; c < n_check; ++c) {
    int b1 = check1[c];
    if (force_unempty && !nonzero[b1]) continue;
    const double *u1 = bins + (size_t)b1 * 3;
    double v1 = votes[b1];

    // best (b2, b3) for this b1: replicate "total argmax over cand2
    // (first maximum), third argmax first-maximum per cand2"
    double best_total = -HUGE_VAL;
    int best_b2 = -1, best_b3 = -1;
    for (int j = 0; j < n; ++j) {
      if (std::fabs(dot3(u1, bins + (size_t)j * 3)) >= orth_cos) continue;
      if (force_unempty && !nonzero[j]) continue;
      const double *u2 = bins + (size_t)j * 3;
      double cx = u1[1] * u2[2] - u1[2] * u2[1];
      double cy = u1[2] * u2[0] - u1[0] * u2[2];
      double cz = u1[0] * u2[1] - u1[1] * u2[0];
      double cn = std::sqrt(cx * cx + cy * cy + cz * cz);
      double b3v = -HUGE_VAL;
      int b3i = 0;  // numpy argmax of an all-(-inf) column is 0
      for (int i = 0; i < n; ++i) {
        if (!nonzero[i]) continue;
        const double *u3 = bins + (size_t)i * 3;
        double d = std::fabs(cx * u3[0] + cy * u3[1] + cz * u3[2]) / cn;
        if (d > third_cos && votes[i] > b3v) {
          b3v = votes[i];
          b3i = i;
        }
      }
      double total = v1 + votes[j] + b3v;  // -inf when no valid third
      if (std::isfinite(total) && total > best_total) {
        best_total = total;
        best_b2 = j;
        best_b3 = b3i;
      }
    }
    if (best_b2 < 0) continue;

    if (best_total > vote_max) {
      // _accept: cost/angle deltas vs the PREVIOUS best
      last_cost = best_total - vote_max;
      if (vote_max != 0.0) {
        int nb[3] = {b1, best_b2, best_b3};
        for (int k = 0; k < 3; ++k) {
          double t = dot3(bins + (size_t)best[k] * 3,
                          bins + (size_t)nb[k] * 3);
          if (t > 1.0) t = 1.0;
          if (t < -1.0) t = -1.0;
          last_angle[k] = std::acos(t);
        }
      } else {
        last_angle[0] = last_angle[1] = last_angle[2] = 0.0;
      }
      best[0] = b1;
      best[1] = best_b2;
      best[2] = best_b3;
      vote_max = best_total;
    }
  }

  best_out[0] = best[0];
  best_out[1] = best[1];
  best_out[2] = best[2];
  *vote_max_out = vote_max;
  *last_cost_out = last_cost;
  last_angle_out[0] = last_angle[0];
  last_angle_out[1] = last_angle[1];
  last_angle_out[2] = last_angle[2];
}

}  // extern "C"
