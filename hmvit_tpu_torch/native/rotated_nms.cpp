// Native host-side rotated-box IoU + greedy NMS.
//
// TPU-native equivalent of the reference's shapely(GEOS)/Cython host
// geometry (reference: opencood/utils/box_utils.py:575-620 nms_rotated,
// opencood/utils/common_utils.py:120-160 polygon IoU): convex-quad
// Sutherland–Hodgman clipping in double precision, same greedy
// descending-score suppression.  Used by hmvit_tpu.utils.nms via ctypes
// for the host eval loops (late-fusion sweeps decode thousands of boxes
// per frame); numerically cross-checked against the numpy oracle in
// tests/test_native_nms.py.
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <numeric>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

double polygon_area(const std::vector<Pt>& p) {
  double a = 0.0;
  const size_t n = p.size();
  if (n < 3) return 0.0;
  for (size_t i = 0; i < n; ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % n];
    a += u.x * v.y - v.x * u.y;
  }
  return 0.5 * std::fabs(a);
}

// Ensure counter-clockwise orientation (signed shoelace >= 0).
void make_ccw(std::vector<Pt>& p) {
  double a = 0.0;
  for (size_t i = 0; i < p.size(); ++i) {
    const Pt& u = p[i];
    const Pt& v = p[(i + 1) % p.size()];
    a += u.x * v.y - v.x * u.y;
  }
  if (a < 0.0) std::reverse(p.begin(), p.end());
}

// Clip polygon `subject` by the half-plane left of edge (a -> b).
std::vector<Pt> clip_edge(const std::vector<Pt>& subject, Pt a, Pt b) {
  std::vector<Pt> out;
  const size_t n = subject.size();
  if (n == 0) return out;
  auto side = [&](const Pt& p) {
    return (b.x - a.x) * (p.y - a.y) - (b.y - a.y) * (p.x - a.x);
  };
  for (size_t i = 0; i < n; ++i) {
    const Pt& cur = subject[i];
    const Pt& nxt = subject[(i + 1) % n];
    const double sc = side(cur), sn = side(nxt);
    if (sc >= 0.0) out.push_back(cur);
    if ((sc >= 0.0) != (sn >= 0.0)) {
      const double denom = sc - sn;
      if (std::fabs(denom) > 1e-300) {
        const double t = sc / denom;
        out.push_back({cur.x + t * (nxt.x - cur.x),
                       cur.y + t * (nxt.y - cur.y)});
      }
    }
  }
  return out;
}

double quad_intersection_area(const Pt* qa, const Pt* qb) {
  std::vector<Pt> a(qa, qa + 4), b(qb, qb + 4);
  make_ccw(a);
  make_ccw(b);
  std::vector<Pt> poly = a;
  for (int i = 0; i < 4 && !poly.empty(); ++i) {
    poly = clip_edge(poly, b[i], b[(i + 1) % 4]);
  }
  return polygon_area(poly);
}

double quad_iou(const Pt* qa, const Pt* qb) {
  const double inter = quad_intersection_area(qa, qb);
  std::vector<Pt> a(qa, qa + 4), b(qb, qb + 4);
  const double ua = polygon_area(a), ub = polygon_area(b);
  const double uni = ua + ub - inter;
  if (uni <= 1e-12) return 0.0;
  return inter / uni;
}

void load_quad(const float* corners, int64_t i, Pt* out) {
  for (int k = 0; k < 4; ++k) {
    out[k].x = static_cast<double>(corners[i * 8 + 2 * k]);
    out[k].y = static_cast<double>(corners[i * 8 + 2 * k + 1]);
  }
}

}  // namespace

extern "C" {

// Pairwise IoU matrix: corners (n, 4, 2) float32 row-major, out (n, m).
void rotated_iou_matrix(const float* corners_a, int64_t n,
                        const float* corners_b, int64_t m, float* out) {
  std::vector<Pt> qa(4), qb(4);
  for (int64_t i = 0; i < n; ++i) {
    load_quad(corners_a, i, qa.data());
    for (int64_t j = 0; j < m; ++j) {
      load_quad(corners_b, j, qb.data());
      out[i * m + j] = static_cast<float>(quad_iou(qa.data(), qb.data()));
    }
  }
}

// Greedy rotated NMS mirroring the reference ordering: descending score
// (ties broken by ascending index), top-`top` candidates, suppress any
// remaining box with IoU > threshold against the picked box.  Returns
// the number of kept boxes; their indices (in pick order) in keep_out.
int64_t nms_rotated(const float* corners, const float* scores, int64_t n,
                    float threshold, int64_t top, int32_t* keep_out) {
  if (n <= 0) return 0;
  std::vector<int64_t> order(n);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int64_t a, int64_t b) {
                     return scores[a] > scores[b];
                   });
  if (top > 0 && top < n) order.resize(top);

  std::vector<char> alive(order.size(), 1);
  std::vector<Pt> qi(4), qj(4);
  int64_t n_keep = 0;
  for (size_t a = 0; a < order.size(); ++a) {
    if (!alive[a]) continue;
    const int64_t i = order[a];
    keep_out[n_keep++] = static_cast<int32_t>(i);
    load_quad(corners, i, qi.data());
    for (size_t b = a + 1; b < order.size(); ++b) {
      if (!alive[b]) continue;
      load_quad(corners, order[b], qj.data());
      if (quad_iou(qi.data(), qj.data()) > threshold) alive[b] = 0;
    }
  }
  return n_keep;
}

}  // extern "C"
