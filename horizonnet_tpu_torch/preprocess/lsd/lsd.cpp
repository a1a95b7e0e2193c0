// LSD: Line Segment Detector (von Gioi, Jakubowicz, Morel, Randall,
// IPOL 2012) — in-house C++ implementation of the published algorithm.
//
// Replaces the reference's pylsd C extension (misc/pano_lsd_align.py:16,
// 260). Exposed through a flat C ABI (lsd_detect / lsd_free) consumed via
// ctypes; also provides a batched entry that runs several images through
// the detector in one call.
//
// Pipeline: Gaussian downscale -> 2x2 gradient + level-line field ->
// greedy region growing on aligned pixels -> rectangle approximation ->
// NFA (number of false alarms) validation with rectangle refinement.

#include <atomic>
#include <cfloat>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>
#include <algorithm>

namespace {

constexpr double kNoAngle = -1024.0;
constexpr double kRelativeEps = 100.0;  // double comparison tolerance factor

struct Pt { int x, y; };

struct Rect {
  double x1, y1, x2, y2;  // endpoints
  double width;
  double cx, cy;          // center
  double theta;           // main axis angle
  double dx, dy;          // (cos theta, sin theta)
  double prec;            // angle tolerance (rad)
  double p;               // aligned-point probability
};

struct Grad {
  std::vector<double> mod;      // gradient magnitude
  std::vector<unsigned char> has;  // level-line defined (mod > threshold)
  std::vector<double> cang;     // cos(level-line angle) where has
  std::vector<double> sang;     // sin(level-line angle)
  int w = 0, h = 0;
  double at_mod(int x, int y) const { return mod[y * w + x]; }
  // angle reconstructed on demand — the eager atan2 over every
  // above-threshold pixel was ~17% of the detector; only refine_region's
  // tau estimate needs actual angles, for a few points per region
  double at_ang(int x, int y) const {
    return std::atan2(sang[(size_t)y * w + x], cang[(size_t)y * w + x]);
  }
};

inline bool double_eq(double a, double b) {
  if (a == b) return true;
  double diff = std::fabs(a - b);
  double a1 = std::fabs(a), b1 = std::fabs(b);
  double big = a1 > b1 ? a1 : b1;
  if (big < DBL_MIN) big = DBL_MIN;
  return diff / big <= kRelativeEps * DBL_EPSILON;
}

inline double angle_diff(double a, double b) {
  a -= b;
  while (a <= -M_PI) a += 2 * M_PI;
  while (a > M_PI) a -= 2 * M_PI;
  return std::fabs(a);
}

inline double angle_diff_signed(double a, double b) {
  a -= b;
  while (a <= -M_PI) a += 2 * M_PI;
  while (a > M_PI) a -= 2 * M_PI;
  return a;
}

// ---------------------------------------------------------------- gaussian

std::vector<double> gaussian_kernel(int n, double sigma, double mean) {
  std::vector<double> k(n);
  double sum = 0;
  for (int i = 0; i < n; ++i) {
    double v = (i - mean) / sigma;
    k[i] = std::exp(-0.5 * v * v);
    sum += k[i];
  }
  if (sum > 0)
    for (double &v : k) v /= sum;
  return k;
}

// Downscale by `scale` (<1) with Gaussian anti-alias filtering, as in the
// published algorithm: sigma = sigma_scale / scale.
//
// Per-output-pixel work is the hot path of the whole detector on small
// views, so: (a) kernels are cached per sub-pixel phase (xx - xc repeats
// with a short period for rational scales — e.g. 4 phases at scale 0.8 —
// so identical kernels were being rebuilt per column), and (b) the
// symmetric-boundary index wrapping is hoisted out of the interior
// columns, which need none.
void gaussian_downscale(const double *img, int w, int h, double scale,
                        double sigma_scale, std::vector<double> &out,
                        int &nw, int &nh) {
  double sigma = scale < 1.0 ? sigma_scale / scale : sigma_scale;
  const double prec = 3.0;
  int rad = (int)std::ceil(sigma * std::sqrt(2.0 * prec * std::log(10.0)));
  int n = 1 + 2 * rad;

  nw = (int)std::ceil(w * scale);
  nh = (int)std::ceil(h * scale);
  std::vector<double> aux((size_t)nw * h);
  out.assign((size_t)nw * nh, 0.0);

  // kernel cache keyed on the sub-pixel offset (exact double compare is
  // safe: equal phases come from identical floating-point expressions)
  std::vector<double> offs;
  std::vector<std::vector<double>> kers;
  auto ker_for = [&](double off) -> const std::vector<double> & {
    for (size_t i = 0; i < offs.size(); ++i)
      if (offs[i] == off) return kers[i];
    offs.push_back(off);
    kers.push_back(gaussian_kernel(n, sigma, (double)rad + off));
    return kers.back();
  };
  auto sym = [](int j, int dim) {
    while (j < 0) j += 2 * dim;
    while (j >= 2 * dim) j -= 2 * dim;
    if (j >= dim) j = 2 * dim - 1 - j;
    return j;
  };

  // x pass
  for (int x = 0; x < nw; ++x) {
    double xx = x / scale;
    int xc = (int)std::floor(xx + 0.5);
    const auto &ker = ker_for(xx - xc);
    int j0 = xc - rad;
    if (j0 >= 0 && j0 + n <= w) {  // interior: no boundary handling
      for (int y = 0; y < h; ++y) {
        const double *row = img + (size_t)y * w + j0;
        double sum = 0;
        for (int i = 0; i < n; ++i) sum += row[i] * ker[i];
        aux[(size_t)y * nw + x] = sum;
      }
    } else {
      std::vector<int> js(n);
      for (int i = 0; i < n; ++i) js[i] = sym(j0 + i, w);
      for (int y = 0; y < h; ++y) {
        const double *row = img + (size_t)y * w;
        double sum = 0;
        for (int i = 0; i < n; ++i) sum += row[js[i]] * ker[i];
        aux[(size_t)y * nw + x] = sum;
      }
    }
  }
  // y pass
  for (int y = 0; y < nh; ++y) {
    double yy = y / scale;
    int yc = (int)std::floor(yy + 0.5);
    const auto &ker = ker_for(yy - yc);
    int j0 = yc - rad;
    double *dst = out.data() + (size_t)y * nw;
    if (j0 >= 0 && j0 + n <= h) {
      std::memset(dst, 0, sizeof(double) * nw);
      for (int i = 0; i < n; ++i) {
        const double *row = aux.data() + (size_t)(j0 + i) * nw;
        double kv = ker[i];
        for (int x = 0; x < nw; ++x) dst[x] += row[x] * kv;
      }
    } else {
      std::memset(dst, 0, sizeof(double) * nw);
      for (int i = 0; i < n; ++i) {
        const double *row = aux.data() + (size_t)sym(j0 + i, h) * nw;
        double kv = ker[i];
        for (int x = 0; x < nw; ++x) dst[x] += row[x] * kv;
      }
    }
  }
}

// ---------------------------------------------------------------- gradient

// 2x2 scheme; also produces a list of pixels pseudo-sorted by decreasing
// gradient magnitude (bin sort).
void compute_gradient(const std::vector<double> &img, int w, int h,
                      double threshold, int n_bins, Grad &g,
                      std::vector<Pt> &ordered) {
  g.w = w;
  g.h = h;
  g.mod.assign((size_t)w * h, 0.0);
  g.has.assign((size_t)w * h, 0);
  g.cang.assign((size_t)w * h, 0.0);
  g.sang.assign((size_t)w * h, 0.0);

  double max_grad = 0.0;
  for (int y = 0; y < h - 1; ++y) {
    for (int x = 0; x < w - 1; ++x) {
      size_t a = (size_t)y * w + x;
      double com1 = img[a + w + 1] - img[a];
      double com2 = img[a + 1] - img[a + w];
      double gx = 0.5 * (com1 + com2);
      double gy = 0.5 * (com1 - com2);
      double norm = std::sqrt(gx * gx + gy * gy);
      g.mod[a] = norm;
      if (norm > threshold) {
        g.has[a] = 1;
        // the level-line unit vector comes free from the gradient:
        // angle = atan2(gx, -gy) => (cos, sin) = (-gy, gx) / norm —
        // saves a cos+sin (and later an atan2) per region-grow accept
        g.cang[a] = -gy / norm;
        g.sang[a] = gx / norm;
        if (norm > max_grad) max_grad = norm;
      }
    }
  }

  // bin sort, highest magnitude first
  std::vector<std::vector<Pt>> bins(n_bins);
  double inv = max_grad > 0 ? (double)(n_bins - 1) / max_grad : 0.0;
  for (int y = 0; y < h - 1; ++y)
    for (int x = 0; x < w - 1; ++x) {
      size_t a = (size_t)y * w + x;
      if (!g.has[a]) continue;
      int b = (int)(g.mod[a] * inv);
      if (b >= n_bins) b = n_bins - 1;
      bins[b].push_back({x, y});
    }
  ordered.clear();
  ordered.reserve((size_t)w * h);
  for (int b = n_bins - 1; b >= 0; --b)
    for (const Pt &p : bins[b]) ordered.push_back(p);
}

// ---------------------------------------------------------------- regions

void region_grow(const Grad &g, std::vector<char> &used, Pt seed,
                 double prec, std::vector<Pt> &region, double &reg_angle) {
  region.clear();
  region.push_back(seed);
  size_t sa = (size_t)seed.y * g.w + seed.x;
  double sumdx = g.cang[sa], sumdy = g.sang[sa];
  used[sa] = 1;

  // The acceptance test |wrap(reg_angle - ang)| <= prec is evaluated as
  // cos(reg_angle - ang) >= cos(prec), i.e. dot(sum, u_ang) >= cos(prec)
  // * |sum| with the precomputed unit level-line vectors — one sqrt per
  // accepted pixel instead of cos+sin+atan2 (the detector's hottest
  // loop). cos is monotonic on [0, pi] only, so prec >= pi (possible for
  // the tau retry in refine_region) accepts everything, exactly like
  // angle_diff's [0, pi] range would.
  double cos_prec = prec >= M_PI ? -2.0 : std::cos(prec);
  double r = 1.0;  // |(sumdx, sumdy)|; the seed vector is unit

  for (size_t i = 0; i < region.size(); ++i) {
    Pt p = region[i];
    for (int yy = p.y - 1; yy <= p.y + 1; ++yy) {
      for (int xx = p.x - 1; xx <= p.x + 1; ++xx) {
        if (xx < 0 || yy < 0 || xx >= g.w || yy >= g.h) continue;
        size_t a = (size_t)yy * g.w + xx;
        if (used[a]) continue;
        if (!g.has[a]) continue;
        if (sumdx * g.cang[a] + sumdy * g.sang[a] < cos_prec * r) continue;
        used[a] = 1;
        region.push_back({xx, yy});
        sumdx += g.cang[a];
        sumdy += g.sang[a];
        r = std::sqrt(sumdx * sumdx + sumdy * sumdy);
      }
    }
  }
  reg_angle = std::atan2(sumdy, sumdx);
}

double region_theta(const std::vector<Pt> &region, const Grad &g, double cx,
                    double cy, double reg_angle, double prec) {
  double Ixx = 0, Iyy = 0, Ixy = 0;
  for (const Pt &p : region) {
    double wgt = g.at_mod(p.x, p.y);
    Ixx += wgt * (p.y - cy) * (p.y - cy);
    Iyy += wgt * (p.x - cx) * (p.x - cx);
    Ixy -= wgt * (p.x - cx) * (p.y - cy);
  }
  double lambda = 0.5 * (Ixx + Iyy -
      std::sqrt((Ixx - Iyy) * (Ixx - Iyy) + 4.0 * Ixy * Ixy));
  double theta = std::fabs(Ixx) > std::fabs(Iyy)
      ? std::atan2(lambda - Ixx, Ixy)
      : std::atan2(Ixy, lambda - Iyy);
  if (angle_diff(theta, reg_angle) > prec) theta += M_PI;
  return theta;
}

void region_to_rect(const std::vector<Pt> &region, const Grad &g,
                    double reg_angle, double prec, double p, Rect &rect) {
  double cx = 0, cy = 0, total = 0;
  for (const Pt &pt : region) {
    double wgt = g.at_mod(pt.x, pt.y);
    cx += wgt * pt.x;
    cy += wgt * pt.y;
    total += wgt;
  }
  cx /= total;
  cy /= total;
  double theta = region_theta(region, g, cx, cy, reg_angle, prec);
  double dx = std::cos(theta), dy = std::sin(theta);

  double lmin = 0, lmax = 0, wmin = 0, wmax = 0;
  for (const Pt &pt : region) {
    double l = (pt.x - cx) * dx + (pt.y - cy) * dy;
    double wd = -(pt.x - cx) * dy + (pt.y - cy) * dx;
    lmin = std::min(lmin, l);
    lmax = std::max(lmax, l);
    wmin = std::min(wmin, wd);
    wmax = std::max(wmax, wd);
  }
  rect.x1 = cx + lmin * dx;
  rect.y1 = cy + lmin * dy;
  rect.x2 = cx + lmax * dx;
  rect.y2 = cy + lmax * dy;
  rect.width = std::max(wmax - wmin, 1.0);
  rect.cx = cx;
  rect.cy = cy;
  rect.theta = theta;
  rect.dx = dx;
  rect.dy = dy;
  rect.prec = prec;
  rect.p = p;
}

// ---------------------------------------------------------------- NFA

// log10(Gamma) via Lanczos / Stirling approximations.
double log_gamma(double x) {
  if (x >= 15.0) {
    // Windschitl
    return 0.918938533204673 + (x - 0.5) * std::log(x) - x +
           0.5 * x * std::log(x * std::sinh(1 / x) +
                              1 / (810.0 * std::pow(x, 6.0)));
  }
  static const double q[7] = {75122.6331530, 80916.6278952, 36308.2951477,
                              8687.24529705, 1168.92649479, 83.8676043424,
                              2.50662827511};
  double a = (x + 0.5) * std::log(x + 5.5) - (x + 5.5);
  double b = 0;
  for (int n = 0; n < 7; ++n) {
    a -= std::log(x + n);
    b += q[n] * std::pow(x, n);
  }
  return a + std::log(b);
}

// -log10(NFA) of k aligned points among n with probability p.
double nfa(int n, int k, double p, double logNT) {
  if (n == 0 || k == 0) return -logNT;
  if (n == k) return -logNT - (double)n * std::log10(p);
  double p_term = p / (1.0 - p);
  double log1term = log_gamma(n + 1.0) - log_gamma(k + 1.0) -
                    log_gamma(n - k + 1.0) + (double)k * std::log(p) +
                    (double)(n - k) * std::log(1.0 - p);
  double term = std::exp(log1term);
  if (double_eq(term, 0.0)) {
    if ((double)k > (double)n * p)
      return -log1term / std::log(10.0) - logNT;
    return -logNT;
  }
  double bin_tail = term;
  double tolerance = 0.1;
  for (int i = k + 1; i <= n; ++i) {
    double bin_term = (double)(n - i + 1) / (double)i;
    double mult = bin_term * p_term;
    term *= mult;
    bin_tail += term;
    if (bin_term < 1.0) {
      double err = term * ((1.0 - std::pow(mult, (double)(n - i + 1))) /
                               (1.0 - mult) - 1.0);
      if (err < tolerance * std::fabs(-std::log10(bin_tail) - logNT) *
                    bin_tail)
        break;
    }
  }
  return -std::log10(bin_tail) - logNT;
}

inline bool in_rect(const Rect &r, double x, double y) {
  double l = (x - r.cx) * r.dx + (y - r.cy) * r.dy;
  double wd = -(x - r.cx) * r.dy + (y - r.cy) * r.dx;
  double half_len1 = (r.x1 - r.cx) * r.dx + (r.y1 - r.cy) * r.dy;
  double half_len2 = (r.x2 - r.cx) * r.dx + (r.y2 - r.cy) * r.dy;
  return l >= std::min(half_len1, half_len2) - 0.5 &&
         l <= std::max(half_len1, half_len2) + 0.5 &&
         std::fabs(wd) <= r.width / 2.0 + 0.5;
}

// NFA of the rect at its own precision AND nprec-1 successive halvings
// of p, all from ONE bbox scan (the pixel-in-rect test is independent of
// the precision, so rect_improve's finer-precision trials were rescanning
// an identical pixel set). out_lognfa[k] = NFA at p / 2^k.
void rect_nfa_multi(const Rect &r, const Grad &g, double logNT, int nprec,
                    double *out_lognfa) {
  int pts = 0;
  int alg[8] = {0};
  int x0 = (int)std::floor(std::min(std::min(r.x1, r.x2),
                                    r.cx - r.width) - 1);
  int x1 = (int)std::ceil(std::max(std::max(r.x1, r.x2),
                                   r.cx + r.width) + 1);
  int y0 = (int)std::floor(std::min(std::min(r.y1, r.y2),
                                    r.cy - r.width) - 1);
  int y1 = (int)std::ceil(std::max(std::max(r.y1, r.y2),
                                   r.cy + r.width) + 1);
  x0 = std::max(x0, 0);
  y0 = std::max(y0, 0);
  x1 = std::min(x1, g.w - 1);
  y1 = std::min(y1, g.h - 1);
  // per-rect invariants of in_rect, hoisted out of the bbox scan (they
  // were recomputed per pixel); the aligned-angle test likewise becomes
  // a dot product against the rect axis using the stored unit vectors
  double hl1 = (r.x1 - r.cx) * r.dx + (r.y1 - r.cy) * r.dy;
  double hl2 = (r.x2 - r.cx) * r.dx + (r.y2 - r.cy) * r.dy;
  double lmin = std::min(hl1, hl2) - 0.5, lmax = std::max(hl1, hl2) + 0.5;
  double wlim = r.width / 2.0 + 0.5;
  // |wrap(theta - ang)| < prec  <=>  cos(theta - ang) > cos(prec) for
  // prec in [0, pi] (rect precisions only shrink from ang_th); strict
  // inequality matches angle_diff's `< r.prec`. Thresholds tighten with
  // k, so a pixel failing level k fails all finer levels.
  double cth = std::cos(r.theta), sth = std::sin(r.theta);
  double cos_prec[8];
  double pk = r.p;
  for (int k = 0; k < nprec; ++k, pk /= 2.0) {
    double prec_k = pk * M_PI;
    cos_prec[k] = prec_k >= M_PI ? -2.0 : std::cos(prec_k);
  }
  for (int y = y0; y <= y1; ++y) {
    size_t row = (size_t)y * g.w;
    for (int x = x0; x <= x1; ++x) {
      double ex = x - r.cx, ey = y - r.cy;
      double l = ex * r.dx + ey * r.dy;
      if (l < lmin || l > lmax) continue;
      double wd = -ex * r.dy + ey * r.dx;
      if (std::fabs(wd) > wlim) continue;
      ++pts;
      size_t a = row + x;
      if (!g.has[a]) continue;
      double dot = cth * g.cang[a] + sth * g.sang[a];
      for (int k = 0; k < nprec && dot > cos_prec[k]; ++k) ++alg[k];
    }
  }
  pk = r.p;
  for (int k = 0; k < nprec; ++k, pk /= 2.0)
    out_lognfa[k] = nfa(pts, alg[k], pk, logNT);
}

double rect_nfa(const Rect &r, const Grad &g, double logNT) {
  double ln;
  rect_nfa_multi(r, g, logNT, 1, &ln);
  return ln;
}

// Try shrinking/regrowing the region when its density is too low.
bool refine_region(std::vector<Pt> &region, const Grad &g,
                   std::vector<char> &used, double &reg_angle, double prec,
                   double p, Rect &rect, double density_th) {
  auto density = [&](const Rect &r) {
    double len = std::hypot(r.x2 - r.x1, r.y2 - r.y1);
    return (double)region.size() / (len * r.width);
  };
  if (density(rect) >= density_th) return true;

  // Estimate a tighter angle tolerance from points near the seed
  Pt seed = region[0];
  double xc = seed.x, yc = seed.y;
  double ang_c = g.at_ang(seed.x, seed.y);
  double sum = 0, s_sum = 0;
  int n = 0;
  for (const Pt &pt : region) {
    used[(size_t)pt.y * g.w + pt.x] = 0;
    if (std::hypot(pt.x - xc, pt.y - yc) <
        rect.width) {
      double a = angle_diff_signed(g.at_ang(pt.x, pt.y), ang_c);
      sum += a;
      s_sum += a * a;
      ++n;
    }
  }
  if (n == 0) return false;
  double mean = sum / n;
  double tau = 2.0 * std::sqrt((s_sum - 2.0 * mean * sum) / n + mean * mean);

  region_grow(g, used, seed, tau, region, reg_angle);
  if (region.size() < 2) return false;
  region_to_rect(region, g, reg_angle, prec, p, rect);

  if (density(rect) < density_th) {
    // Radius reduction: drop the farthest points until dense enough
    while (density(rect) < density_th) {
      double rad = 0.75 * std::max(
          std::hypot(xc - rect.x1, yc - rect.y1),
          std::hypot(xc - rect.x2, yc - rect.y2));
      size_t j = 0;
      for (size_t i = 0; i < region.size(); ++i) {
        if (std::hypot(xc - region[i].x, yc - region[i].y) <= rad)
          region[j++] = region[i];
        else
          used[(size_t)region[i].y * g.w + region[i].x] = 0;
      }
      region.resize(j);
      if (region.size() < 2) return false;
      region_to_rect(region, g, reg_angle, prec, p, rect);
    }
  }
  return true;
}

double rect_improve(Rect &rect, const Grad &g, double logNT,
                    double log_eps) {
  // base NFA first at full speed (most rects pass here and return);
  // only a failing rect pays the 6-level scan, which still replaces the
  // original's 5 separate finer-precision rescans with ONE. The
  // sequential update rule "strictly greater wins, earliest trial on
  // ties" is preserved.
  double log_nfa = rect_nfa(rect, g, logNT);
  if (log_nfa > log_eps) return log_nfa;
  const double delta = 0.5;

  double ln6[6];
  rect_nfa_multi(rect, g, logNT, 6, ln6);
  const Rect orig = rect;
  for (int k = 1; k < 6; ++k) {
    if (ln6[k] > log_nfa) {
      log_nfa = ln6[k];
      Rect r = orig;
      for (int i = 0; i < k; ++i) r.p /= 2.0;
      r.prec = r.p * M_PI;
      rect = r;
    }
  }
  if (log_nfa > log_eps) return log_nfa;

  auto try_shrink = [&](auto mutate) {
    Rect rr = rect;
    for (int i = 0; i < 5; ++i) {
      if (rr.width - delta < 0.5) break;
      mutate(rr);
      double ln = rect_nfa(rr, g, logNT);
      if (ln > log_nfa) {
        log_nfa = ln;
        rect = rr;
      }
    }
  };
  // reduce width
  try_shrink([&](Rect &rr) { rr.width -= delta; });
  if (log_nfa > log_eps) return log_nfa;
  // reduce one side
  try_shrink([&](Rect &rr) {
    rr.x1 += -rr.dy * delta / 2.0;
    rr.y1 += rr.dx * delta / 2.0;
    rr.x2 += -rr.dy * delta / 2.0;
    rr.y2 += rr.dx * delta / 2.0;
    rr.width -= delta;
  });
  if (log_nfa > log_eps) return log_nfa;
  // reduce the other side
  try_shrink([&](Rect &rr) {
    rr.x1 -= -rr.dy * delta / 2.0;
    rr.y1 -= rr.dx * delta / 2.0;
    rr.x2 -= -rr.dy * delta / 2.0;
    rr.y2 -= rr.dx * delta / 2.0;
    rr.width -= delta;
  });
  if (log_nfa > log_eps) return log_nfa;
  // final: even finer precision, again one scan for all 5 trials
  const Rect fin = rect;
  rect_nfa_multi(fin, g, logNT, 6, ln6);
  for (int k = 1; k < 6; ++k) {
    if (ln6[k] > log_nfa) {
      log_nfa = ln6[k];
      Rect r = fin;
      for (int i = 0; i < k; ++i) r.p /= 2.0;
      r.prec = r.p * M_PI;
      rect = r;
    }
  }
  return log_nfa;
}

}  // namespace

extern "C" {

// Detect segments in a grayscale image (row-major double, range 0..255).
// Returns number of segments; *out receives a malloc'd array of
// [x1 y1 x2 y2 width nfa] per segment (caller frees via lsd_free).
int lsd_detect(const double *img, int w, int h, double scale,
               double sigma_scale, double quant, double ang_th,
               double log_eps, double density_th, int n_bins,
               double **out) {
  std::vector<double> scaled;
  int sw = w, sh = h;
  const double *data = img;
  if (scale != 1.0) {
    gaussian_downscale(img, w, h, scale, sigma_scale, scaled, sw, sh);
    data = scaled.data();
  } else {
    scaled.assign(img, img + (size_t)w * h);
    data = scaled.data();
  }

  double prec = M_PI * ang_th / 180.0;
  double p = ang_th / 180.0;
  double grad_threshold = quant / std::sin(prec);

  Grad g;
  std::vector<Pt> ordered;
  {
    std::vector<double> tmp(data, data + (size_t)sw * sh);
    compute_gradient(tmp, sw, sh, grad_threshold, n_bins, g, ordered);
  }

  double logNT = 5.0 * (std::log10((double)sw) + std::log10((double)sh)) /
                     2.0 +
                 std::log10(11.0);
  int min_region = (int)(-logNT / std::log10(p));

  std::vector<char> used((size_t)sw * sh, 0);
  std::vector<Pt> region;
  std::vector<double> results;

  for (const Pt &seed : ordered) {
    if (used[(size_t)seed.y * g.w + seed.x]) continue;
    if (!g.has[(size_t)seed.y * g.w + seed.x]) continue;

    double reg_angle;
    region_grow(g, used, seed, prec, region, reg_angle);
    if ((int)region.size() < min_region) continue;

    Rect rect;
    region_to_rect(region, g, reg_angle, prec, p, rect);
    if (!refine_region(region, g, used, reg_angle, prec, p, rect,
                       density_th))
      continue;
    if ((int)region.size() < min_region) continue;

    double log_nfa = rect_improve(rect, g, logNT, log_eps);
    if (log_nfa <= log_eps) continue;

    // sub-pixel offset + scale back to the original resolution
    double x1 = (rect.x1 + 0.5) / scale;
    double y1 = (rect.y1 + 0.5) / scale;
    double x2 = (rect.x2 + 0.5) / scale;
    double y2 = (rect.y2 + 0.5) / scale;
    double width = rect.width / scale;
    results.insert(results.end(), {x1, y1, x2, y2, width, log_nfa});
  }

  int n = (int)(results.size() / 6);
  *out = (double *)std::malloc(results.size() * sizeof(double));
  std::memcpy(*out, results.data(), results.size() * sizeof(double));
  return n;
}

void lsd_free(double *ptr) { std::free(ptr); }

// Detect segments in n same-sized images with a native thread pool (one
// ctypes call for the whole 26-view batch instead of a Python thread per
// view). imgs = n contiguous row-major [h*w] planes; outs[i]/counts[i]
// receive each image's malloc'd result (free each via lsd_free).
// n_threads <= 0 uses the hardware concurrency.
void lsd_detect_batch(const double *imgs, int n, int w, int h, double scale,
                      double sigma_scale, double quant, double ang_th,
                      double log_eps, double density_th, int n_bins,
                      int n_threads, double **outs, int *counts) {
  if (n_threads <= 0) n_threads = (int)std::thread::hardware_concurrency();
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n) n_threads = n;

  std::atomic<int> next(0);
  auto worker = [&]() {
    for (int i = next.fetch_add(1); i < n; i = next.fetch_add(1)) {
      counts[i] = lsd_detect(imgs + (size_t)i * w * h, w, h, scale,
                             sigma_scale, quant, ang_th, log_eps,
                             density_th, n_bins, &outs[i]);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  pool.reserve(n_threads);
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto &th : pool) th.join();
}

}  // extern "C"
