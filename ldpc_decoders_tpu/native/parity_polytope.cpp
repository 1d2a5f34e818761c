// Exact Euclidean projection onto the parity polytope PP_d — native host
// reference implementation.
//
// Role: capability parity with the reference's native projection kernel
// (reference src/parity_polytope/projection.cpp:30-275, a C++ shared
// library driven through ctypes). On the device the production kernel is the
// batched fixed-shape JAX implementation in ops/projection.py; this C++
// build is the independent double-precision oracle used by the test suite
// and by host-side tools, exposed through the same kind of C ABI
// (vector / rows / CSR entry points).
//
// Algorithm (same mathematics, different structure from the reference's
// merged-breakpoint walk): sort descending, cube-clip, even parity
// residual r, facet normal f = +1 on the top r+1 coordinates and -1
// below; if f.clip(v) <= r the cube projection is the answer, otherwise
// solve T(beta) = f.clip(u - beta*f) = r by evaluating the piecewise
// linear non-increasing T at every candidate breakpoint
// {u_i - 1, u_i} (top) / {-u_i, 1 - u_i} (bottom) clamped to beta >= 0,
// bracketing r and interpolating exactly on the final linear segment.

#include <algorithm>
#include <cmath>
#include <limits>
#include <numeric>
#include <vector>

namespace {

inline double clip01(double x) {
  return x < 0.0 ? 0.0 : (x > 1.0 ? 1.0 : x);
}

void project_one(int d, const double* v, double* out) {
  std::vector<int> order(d);
  std::iota(order.begin(), order.end(), 0);
  std::stable_sort(order.begin(), order.end(),
                   [&](int a, int b) { return v[a] > v[b]; });

  std::vector<double> u(d);
  for (int i = 0; i < d; ++i) u[i] = v[order[i]];

  double s = 0.0;
  for (int i = 0; i < d; ++i) s += clip01(u[i]);
  int r = static_cast<int>(std::floor(s));
  r -= (r & 1);

  double fz = 0.0;
  for (int i = 0; i < d; ++i)
    fz += (i <= r) ? clip01(u[i]) : -clip01(u[i]);

  if (fz <= static_cast<double>(r)) {
    for (int i = 0; i < d; ++i) out[i] = clip01(v[i]);
    return;
  }

  // T(beta) = sum_{i<=r} clip01(u_i - beta) - sum_{i>r} clip01(u_i + beta)
  auto T = [&](double beta) {
    double t = 0.0;
    for (int i = 0; i < d; ++i)
      t += (i <= r) ? clip01(u[i] - beta) : -clip01(u[i] + beta);
    return t;
  };

  std::vector<double> cand;
  cand.reserve(2 * d + 1);
  cand.push_back(0.0);
  for (int i = 0; i < d; ++i) {
    if (i <= r) {
      cand.push_back(std::max(0.0, u[i] - 1.0));
      cand.push_back(std::max(0.0, u[i]));
    } else {
      cand.push_back(std::max(0.0, -u[i]));
      cand.push_back(std::max(0.0, 1.0 - u[i]));
    }
  }

  const double rd = static_cast<double>(r);
  double lo = 0.0, t_lo = fz;
  double hi = std::numeric_limits<double>::infinity(), t_hi = 0.0;
  for (double c : cand) {
    const double t = T(c);
    if (t >= rd && c > lo) { lo = c; t_lo = t; }
    if (t <= rd && c < hi) { hi = c; t_hi = t; }
  }

  double beta = lo;
  if (t_lo - t_hi > 0.0) beta = lo + (t_lo - rd) * (hi - lo) / (t_lo - t_hi);

  for (int i = 0; i < d; ++i)
    out[order[i]] = clip01(u[i] - ((i <= r) ? beta : -beta));
}

}  // namespace

extern "C" {

// Single vector (reference ABI shape: projection.cpp:252-262).
void pp_project_vec(int d, const double* v, double* out) {
  project_one(d, v, out);
}

// Dense batch of equal-degree rows.
void pp_project_rows(int n_rows, int d, const double* v, double* out) {
  for (int i = 0; i < n_rows; ++i)
    project_one(d, v + static_cast<long>(i) * d, out + static_cast<long>(i) * d);
}

// CSR row slices, mixed degrees (reference ABI shape: projection.cpp:266-275).
void pp_project_csr(int n_rows, const int* indptr, const double* v,
                    double* out) {
  for (int i = 0; i < n_rows; ++i)
    project_one(indptr[i + 1] - indptr[i], v + indptr[i], out + indptr[i]);
}

}  // extern "C"
