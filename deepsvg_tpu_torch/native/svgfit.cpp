// Native polyline simplification: Ramer-Douglas-Peucker + Schneider cubic
// fitting (Graphics Gems "An Algorithm for Automatically Fitting Digitized
// Curves" / paper.js PathFitter family — same algorithm as
// deepsvg_tpu_torch/svglib/path_fitting.py, reference deepsvg svg_path.py:391-613).
//
// This is the hot CPU path of dataset preprocessing (SURVEY.md §3.4): the
// recursive fitting runs per path over thousands of SVG files. The C++
// implementation is exposed through a minimal C ABI (ctypes-friendly):
// pieces are emitted as 9-double records [kind, x0,y0, x1,y1, x2,y2, x3,y3]
// with kind 0 = line (x1.. unused), 1 = cubic.
//
// Build: g++ -O3 -shared -fPIC -o libsvgfit.so svgfit.cpp

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kMachineEpsilon = 1.12e-16;

struct Vec {
  double x = 0.0, y = 0.0;
  Vec() = default;
  Vec(double x_, double y_) : x(x_), y(y_) {}
  Vec operator+(const Vec& o) const { return {x + o.x, y + o.y}; }
  Vec operator-(const Vec& o) const { return {x - o.x, y - o.y}; }
  Vec operator*(double k) const { return {x * k, y * k}; }
  double dot(const Vec& o) const { return x * o.x + y * o.y; }
  double cross(const Vec& o) const { return x * o.y - y * o.x; }
  double norm() const { return std::sqrt(x * x + y * y); }
  Vec normalized() const {
    double n = norm();
    return n > 0 ? Vec{x / n, y / n} : *this;
  }
};

struct Piece {
  double kind;  // 0 = line, 1 = cubic
  Vec p[4];
};

using Pieces = std::vector<Piece>;

Vec bezier_eval(const Vec c[4], double t) {
  double s = 1 - t;
  return c[0] * (s * s * s) + c[1] * (3 * s * s * t) + c[2] * (3 * s * t * t) +
         c[3] * (t * t * t);
}

Vec bezier_d1(const Vec c[4], double t) {
  double s = 1 - t;
  return (c[1] - c[0]) * (3 * s * s) + (c[2] - c[1]) * (6 * s * t) +
         (c[3] - c[2]) * (3 * t * t);
}

Vec bezier_d2(const Vec c[4], double t) {
  double s = 1 - t;
  return (c[2] - c[1] * 2.0 + c[0]) * (6 * s) + (c[3] - c[2] * 2.0 + c[1]) * (6 * t);
}

// --- Schneider fitting ------------------------------------------------------

void chord_length_parametrize(const Vec* pts, int n, std::vector<double>& u) {
  u.resize(n);
  u[0] = 0.0;
  for (int i = 1; i < n; i++) u[i] = u[i - 1] + (pts[i] - pts[i - 1]).norm();
  if (u[n - 1] > 0)
    for (int i = 1; i < n; i++) u[i] /= u[n - 1];
}

void generate_bezier(const Vec* pts, int n, const std::vector<double>& u,
                     const Vec& tan1, const Vec& tan2, Vec out[4]) {
  constexpr double epsilon = 1e-12;
  const Vec p1 = pts[0], p2 = pts[n - 1];

  double c00 = 0, c01 = 0, c11 = 0, x0 = 0, x1 = 0;
  for (int i = 0; i < n; i++) {
    double ui = u[i], t = 1 - ui;
    double b = 3 * ui * t;
    double b0 = t * t * t, b1 = b * t, b2 = b * ui, b3 = ui * ui * ui;
    Vec a1 = tan1 * b1, a2 = tan2 * b2;
    Vec tmp = pts[i] - p1 * (b0 + b1) - p2 * (b2 + b3);
    c00 += a1.dot(a1);
    c01 += a1.dot(a2);
    c11 += a2.dot(a2);
    x0 += a1.dot(tmp);
    x1 += a2.dot(tmp);
  }

  double det = c00 * c11 - c01 * c01;
  double alpha1, alpha2;
  if (std::abs(det) > epsilon) {
    alpha1 = (x0 * c11 - x1 * c01) / det;
    alpha2 = (c00 * x1 - c01 * x0) / det;
  } else {
    double c0 = c00 + c01, c1 = c01 + c11;
    alpha1 = alpha2 = std::abs(c0) > epsilon
                          ? x0 / c0
                          : (std::abs(c1) > epsilon ? x1 / c1 : 0.0);
  }

  double seg_length = (p2 - p1).norm();
  double eps = epsilon * seg_length;
  bool fallback = false;
  if (alpha1 < eps || alpha2 < eps) {
    alpha1 = alpha2 = seg_length / 3;
    fallback = true;
  } else {
    Vec line = p2 - p1;
    Vec h1 = tan1 * alpha1, h2 = tan2 * alpha2;
    if (h1.dot(line) - h2.dot(line) > seg_length * seg_length) {
      alpha1 = alpha2 = seg_length / 3;
      fallback = true;
    }
  }
  (void)fallback;
  out[0] = p1;
  out[1] = p1 + tan1 * alpha1;
  out[2] = p2 + tan2 * alpha2;
  out[3] = p2;
}

double max_error(const Vec* pts, int n, const Vec curve[4],
                 const std::vector<double>& u, int* split_index) {
  double max_dist = 0.0;
  *split_index = n / 2;
  for (int i = 1; i < n - 1; i++) {
    Vec d = bezier_eval(curve, u[i]) - pts[i];
    double dist = d.dot(d);
    if (dist >= max_dist) {  // >=: keep the LAST max, like the reference
      max_dist = dist;
      *split_index = i;
    }
  }
  return max_dist;
}

bool reparametrize(const Vec* pts, int n, std::vector<double>& u,
                   const Vec curve[4]) {
  for (int i = 0; i < n; i++) {
    Vec diff = bezier_eval(curve, u[i]) - pts[i];
    Vec d1 = bezier_d1(curve, u[i]), d2 = bezier_d2(curve, u[i]);
    double num = diff.dot(d1);
    double den = d1.dot(d1) + diff.dot(d2);
    if (std::abs(den) > kMachineEpsilon) u[i] -= num / den;
  }
  for (int i = 1; i < n; i++)
    if (u[i] <= u[i - 1]) return false;
  return true;
}

void fit_cubic_rec(const Vec* pts, int n, double error, Vec tan1, Vec tan2,
                   Pieces& out) {
  if (n == 2) {
    double dist = (pts[1] - pts[0]).norm() / 3;
    Piece p{1.0, {pts[0], pts[0] + tan1 * dist, pts[1] + tan2 * dist, pts[1]}};
    out.push_back(p);
    return;
  }

  std::vector<double> u;
  chord_length_parametrize(pts, n, u);
  double max_err = std::max(error, error * error);
  bool in_order = true;
  int split_index = n / 2;

  for (int iter = 0; iter < 5; iter++) {
    Vec curve[4];
    generate_bezier(pts, n, u, tan1, tan2, curve);
    double err = max_error(pts, n, curve, u, &split_index);
    if (err < error && in_order) {
      out.push_back(Piece{1.0, {curve[0], curve[1], curve[2], curve[3]}});
      return;
    }
    if (err >= max_err) break;
    in_order = reparametrize(pts, n, u, curve);
    max_err = err;
  }

  Vec tan_center = (pts[split_index - 1] - pts[split_index + 1]).normalized();
  fit_cubic_rec(pts, split_index + 1, error, tan1, tan_center, out);
  fit_cubic_rec(pts + split_index, n - split_index, error,
                tan_center * -1.0, tan2, out);
}

void rdp_rec(const Vec* pts, int n, double epsilon, Pieces& out) {
  if (n < 2) return;
  if (n == 2) {
    out.push_back(Piece{0.0, {pts[0], {}, {}, pts[1]}});
    return;
  }
  const Vec p1 = pts[0], p2 = pts[n - 1];
  Vec chord = p2 - p1;
  double chord_norm = chord.norm();
  double max_val = 0.0;
  int split = n / 2;
  for (int i = 1; i < n - 1; i++) {
    double dist = chord_norm == 0
                      ? (pts[i] - p1).norm()
                      : std::abs(chord.cross(p1 - pts[i])) / chord_norm;
    if (dist >= max_val) {  // keep last max
      max_val = dist;
      split = i;
    }
  }
  if (max_val > epsilon) {
    rdp_rec(pts, split + 1, epsilon, out);
    rdp_rec(pts + split, n - split, epsilon, out);
  } else {
    out.push_back(Piece{0.0, {p1, {}, {}, p2}});
  }
}

int emit(const Pieces& pieces, double* out, int max_pieces) {
  int n = static_cast<int>(pieces.size());
  if (n > max_pieces) return -n;  // caller should retry with a bigger buffer
  for (int i = 0; i < n; i++) {
    double* row = out + i * 9;
    row[0] = pieces[i].kind;
    for (int j = 0; j < 4; j++) {
      row[1 + 2 * j] = pieces[i].p[j].x;
      row[2 + 2 * j] = pieces[i].p[j].y;
    }
  }
  return n;
}

}  // namespace

extern "C" {

// points: [n, 2] doubles. Returns number of pieces written (>=0) or -needed.
int svgfit_fit_cubics(const double* points, int n, double tolerance,
                      const double* tan1_or_null, const double* tan2_or_null,
                      double* out, int max_pieces) {
  if (n < 2) return 0;
  std::vector<Vec> pts(n);
  for (int i = 0; i < n; i++) pts[i] = Vec{points[2 * i], points[2 * i + 1]};
  Vec tan1 = tan1_or_null ? Vec{tan1_or_null[0], tan1_or_null[1]}
                          : (pts[1] - pts[0]).normalized();
  Vec tan2 = tan2_or_null ? Vec{tan2_or_null[0], tan2_or_null[1]}
                          : (pts[n - 2] - pts[n - 1]).normalized();
  Pieces pieces;
  fit_cubic_rec(pts.data(), n, tolerance, tan1, tan2, pieces);
  return emit(pieces, out, max_pieces);
}

int svgfit_rdp(const double* points, int n, double epsilon, double* out,
               int max_pieces) {
  if (n < 2) return 0;
  std::vector<Vec> pts(n);
  for (int i = 0; i < n; i++) pts[i] = Vec{points[2 * i], points[2 * i + 1]};
  Pieces pieces;
  rdp_rec(pts.data(), n, epsilon, pieces);
  return emit(pieces, out, max_pieces);
}

// Batched cubic point sampling: curves [m, 8] (p1 c1 c2 p2), k samples each,
// out [m, k, 2]. Used by the CPU geometry path (lengths, polygon sampling).
void svgfit_sample_cubics(const double* curves, int m, int k, double* out) {
  for (int c = 0; c < m; c++) {
    const double* q = curves + 8 * c;
    Vec ctrl[4] = {{q[0], q[1]}, {q[2], q[3]}, {q[4], q[5]}, {q[6], q[7]}};
    for (int i = 0; i < k; i++) {
      double t = k > 1 ? static_cast<double>(i) / (k - 1) : 0.0;
      Vec p = bezier_eval(ctrl, t);
      out[(c * k + i) * 2] = p.x;
      out[(c * k + i) * 2 + 1] = p.y;
    }
  }
}

}  // extern "C"
