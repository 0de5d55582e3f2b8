// Minimum-snap polynomial trajectory generator.
//
// Native replacement for the reference's Cython binding around
// ethz-asl mav_trajectory_generation (reference
// planning/trajectory_generation/mav_trajectory_generation.pyx:5-42,
// .pxd:4-7: TrajectoryPlanner(max_v, max_a).planTrajectory(waypoints,
// sampling_time) -> sampled xyz array).  Instead of nlopt nonlinear time
// allocation + rpoly root finding, this implements the closed-form
// unconstrained min-snap QP (Bry & Richter style):
//
//   * degree-7 polynomial per segment per axis, derivatives 0..3
//     continuous at interior waypoints, rest-to-rest boundary
//     conditions;
//   * endpoint-derivative parameterization d = [fixed; free]; snap cost
//     J = d^T A^{-T} Q A^{-1} d; free derivatives solved in closed form
//     by Gaussian elimination (one small dense solve per axis);
//   * segment times from the trapezoidal velocity profile (the same
//     cost model as planning/common/actions.py:32-41), then a global
//     time-scaling loop enforcing max_v / max_a on the sampled
//     trajectory (velocity scales 1/k, acceleration 1/k^2).
//
// Exposed as a minimal C ABI for ctypes (no pybind11 dependency).

#include <algorithm>
#include <cmath>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

constexpr int kDeg = 7;          // polynomial degree
constexpr int kCoef = kDeg + 1;  // coefficients per segment
constexpr int kDer = 4;          // continuous derivatives: pos..jerk

// Solve M x = b in-place via Gaussian elimination with partial pivoting.
// M is n x n row-major. Returns false on (near-)singular systems.
bool SolveDense(std::vector<double>& M, std::vector<double>& b, int n) {
  for (int col = 0; col < n; ++col) {
    int piv = col;
    double best = std::fabs(M[col * n + col]);
    for (int r = col + 1; r < n; ++r) {
      double v = std::fabs(M[r * n + col]);
      if (v > best) {
        best = v;
        piv = r;
      }
    }
    if (best < 1e-12) return false;
    if (piv != col) {
      for (int c = 0; c < n; ++c) std::swap(M[col * n + c], M[piv * n + c]);
      std::swap(b[col], b[piv]);
    }
    double d = M[col * n + col];
    for (int r = col + 1; r < n; ++r) {
      double f = M[r * n + col] / d;
      if (f == 0.0) continue;
      for (int c = col; c < n; ++c) M[r * n + c] -= f * M[col * n + c];
      b[r] -= f * b[col];
    }
  }
  for (int r = n - 1; r >= 0; --r) {
    double acc = b[r];
    for (int c = r + 1; c < n; ++c) acc -= M[r * n + c] * b[c];
    b[r] = acc / M[r * n + r];
  }
  return true;
}

// Endpoint-derivative mapping A (8x8): rows are derivatives 0..3 at t=0
// then 0..3 at t=T of a degree-7 polynomial; A c = d.
void BuildA(double T, double A[kCoef][kCoef]) {
  std::memset(A, 0, sizeof(double) * kCoef * kCoef);
  for (int k = 0; k < kDer; ++k) {
    // at t = 0: only coefficient k survives with factor k!
    double f = 1.0;
    for (int i = 2; i <= k; ++i) f *= i;
    A[k][k] = f;
    // at t = T
    for (int i = k; i < kCoef; ++i) {
      double c = 1.0;
      for (int j = 0; j < k; ++j) c *= (i - j);
      A[kDer + k][i] = c * std::pow(T, i - k);
    }
  }
}

// Snap cost Q (8x8): Q[i][j] = (i!/(i-4)!)(j!/(j-4)!) T^{i+j-7}/(i+j-7).
void BuildQ(double T, double Q[kCoef][kCoef]) {
  std::memset(Q, 0, sizeof(double) * kCoef * kCoef);
  for (int i = 4; i < kCoef; ++i) {
    for (int j = 4; j < kCoef; ++j) {
      double fi = 1.0, fj = 1.0;
      for (int k = 0; k < 4; ++k) {
        fi *= (i - k);
        fj *= (j - k);
      }
      int p = i + j - 7;
      Q[i][j] = fi * fj * std::pow(T, p) / p;
    }
  }
}

// Invert 8x8 via Gaussian elimination.
bool Invert8(const double A[kCoef][kCoef], double Ainv[kCoef][kCoef]) {
  std::vector<double> M(kCoef * kCoef);
  for (int r = 0; r < kCoef; ++r)
    for (int c = 0; c < kCoef; ++c) M[r * kCoef + c] = A[r][c];
  // augmented solves, one unit vector at a time
  for (int col = 0; col < kCoef; ++col) {
    std::vector<double> Mc = M;
    std::vector<double> e(kCoef, 0.0);
    e[col] = 1.0;
    if (!SolveDense(Mc, e, kCoef)) return false;
    for (int r = 0; r < kCoef; ++r) Ainv[r][col] = e[r];
  }
  return true;
}

struct Trajectory {
  int num_segments = 0;
  std::vector<double> times;                // (S,)
  std::vector<double> coefs;                // (S, 3, 8) row-major
  double total_time() const {
    double t = 0;
    for (double s : times) t += s;
    return t;
  }
};

class TrajectoryPlanner {
 public:
  TrajectoryPlanner(double max_v, double max_a) : max_v_(max_v), max_a_(max_a) {}

  // waypoints: (n, 3) row-major. Returns false on failure.
  bool Plan(const double* wps, int n, Trajectory* out) {
    if (n < 2) return false;
    const int S = n - 1;
    std::vector<double> times(S);
    for (int s = 0; s < S; ++s) {
      double d = 0;
      for (int a = 0; a < 3; ++a) {
        double dd = wps[(s + 1) * 3 + a] - wps[s * 3 + a];
        d += dd * dd;
      }
      d = std::sqrt(d);
      // trapezoidal velocity profile time (reference actions.py:32-41)
      double d_acc = std::min(0.5 * d, max_v_ * max_v_ / (2.0 * max_a_));
      double t = (d - 2 * d_acc) / max_v_ + 2.0 * std::sqrt(2.0 * d_acc / max_a_);
      times[s] = std::max(t, 0.05);
    }

    for (int iter = 0; iter < 8; ++iter) {
      if (!SolveFixedTimes(wps, n, times, out)) return false;
      double k = FeasibilityScale(*out);
      if (k <= 1.0) return true;
      for (double& t : times) t *= k * 1.05;
    }
    return true;  // best effort after scaling iterations
  }

  // Sample the planned trajectory every dt seconds (inclusive of both
  // endpoints).  Returns number of samples written; out must hold
  // 3 * (floor(total/dt) + 2) doubles.
  int Sample(const Trajectory& tr, double dt, double* out) const {
    double total = tr.total_time();
    int count = 0;
    for (double t = 0.0; t <= total + 1e-9; t += dt) {
      double p[3];
      Eval(tr, std::min(t, total), 0, p);
      out[count * 3 + 0] = p[0];
      out[count * 3 + 1] = p[1];
      out[count * 3 + 2] = p[2];
      ++count;
    }
    return count;
  }

  static void Eval(const Trajectory& tr, double t, int deriv, double out[3]) {
    int s = 0;
    double local = t;
    while (s < tr.num_segments - 1 && local > tr.times[s]) {
      local -= tr.times[s];
      ++s;
    }
    for (int a = 0; a < 3; ++a) {
      const double* c = &tr.coefs[(s * 3 + a) * kCoef];
      double acc = 0.0;
      for (int i = deriv; i <= kDeg; ++i) {
        double f = 1.0;
        for (int j = 0; j < deriv; ++j) f *= (i - j);
        acc += f * c[i] * std::pow(local, i - deriv);
      }
      out[a] = acc;
    }
  }

 private:
  // Closed-form min-snap with fixed segment times.
  bool SolveFixedTimes(const double* wps, int n, const std::vector<double>& times,
                       Trajectory* out) {
    const int S = n - 1;
    // global derivative variables per axis:
    //   fixed: waypoint positions (n) + start/end derivatives 1..3 (= 0)
    //   free : interior waypoint derivatives 1..3 → 3 (n-2) unknowns
    const int n_free = 3 * (n - 2);

    // cost matrices per segment: K_s = A^{-T} Q A^{-1} (8x8)
    std::vector<std::vector<double>> K(S, std::vector<double>(kCoef * kCoef));
    std::vector<std::vector<double>> Ainv_store(S, std::vector<double>(kCoef * kCoef));
    for (int s = 0; s < S; ++s) {
      double A[kCoef][kCoef], Q[kCoef][kCoef], Ainv[kCoef][kCoef];
      BuildA(times[s], A);
      BuildQ(times[s], Q);
      if (!Invert8(A, Ainv)) return false;
      for (int r = 0; r < kCoef; ++r)
        for (int c = 0; c < kCoef; ++c) Ainv_store[s][r * kCoef + c] = Ainv[r][c];
      // K = Ainv^T Q Ainv
      double QA[kCoef][kCoef];
      for (int r = 0; r < kCoef; ++r)
        for (int c = 0; c < kCoef; ++c) {
          double acc = 0;
          for (int k2 = 0; k2 < kCoef; ++k2) acc += Q[r][k2] * Ainv[k2][c];
          QA[r][c] = acc;
        }
      for (int r = 0; r < kCoef; ++r)
        for (int c = 0; c < kCoef; ++c) {
          double acc = 0;
          for (int k2 = 0; k2 < kCoef; ++k2) acc += Ainv[k2][r] * QA[k2][c];
          K[s][r * kCoef + c] = acc;
        }
    }

    // Index map: segment endpoint derivative (s, end, k) -> global var.
    // Global vars: [0..n-1] positions (fixed), then per interior waypoint
    // w (1..n-2): derivatives k=1..3 (free), start/end derivs fixed 0.
    // Encode: var id for derivative k at waypoint w:
    //   k == 0          -> fixed, value wps[w]
    //   w == 0 || w==n-1 -> fixed, value 0
    //   else free index 3*(w-1) + (k-1)
    auto var_of = [&](int w, int k, bool* fixed, double* value, int axis) {
      if (k == 0) {
        *fixed = true;
        *value = wps[w * 3 + axis];
        return -1;
      }
      if (w == 0 || w == n - 1) {
        *fixed = true;
        *value = 0.0;
        return -1;
      }
      *fixed = false;
      *value = 0.0;
      return 3 * (w - 1) + (k - 1);
    };

    out->num_segments = S;
    out->times = times;
    out->coefs.assign(S * 3 * kCoef, 0.0);

    for (int axis = 0; axis < 3; ++axis) {
      // Build H (n_free x n_free) and g (n_free): J = dF^T H dF + 2 g^T dF + const
      std::vector<double> Hm(std::max(1, n_free * n_free), 0.0);
      std::vector<double> g(std::max(1, n_free), 0.0);

      // segment-local d vector layout: [d0(0..3), dT(0..3)] ↔ waypoints s, s+1
      for (int s = 0; s < S; ++s) {
        int gidx[kCoef];
        bool gfix[kCoef];
        double gval[kCoef];
        for (int e = 0; e < 2; ++e)
          for (int k = 0; k < kDer; ++k) {
            int li = e * kDer + k;
            gidx[li] = var_of(s + e, k, &gfix[li], &gval[li], axis);
          }
        for (int r = 0; r < kCoef; ++r) {
          for (int c = 0; c < kCoef; ++c) {
            double kv = K[s][r * kCoef + c];
            if (kv == 0.0) continue;
            if (!gfix[r] && !gfix[c]) {
              Hm[gidx[r] * n_free + gidx[c]] += kv;
            } else if (!gfix[r] && gfix[c]) {
              g[gidx[r]] += kv * gval[c];
            } else if (gfix[r] && !gfix[c]) {
              g[gidx[c]] += kv * gval[r];  // symmetric contribution
            }
          }
        }
      }

      std::vector<double> dF(std::max(1, n_free), 0.0);
      if (n_free > 0) {
        // J = dF^T H dF + g^T dF + const (both mixed triangles were
        // accumulated into g, so g = 2 K_FP P) → dF* = -(1/2) H^{-1} g
        std::vector<double> Hcopy = Hm;
        std::vector<double> rhs = g;
        for (double& v : rhs) v = -0.5 * v;
        if (!SolveDense(Hcopy, rhs, n_free)) return false;
        dF = rhs;
      }

      // recover coefficients: c = A^{-1} d per segment
      for (int s = 0; s < S; ++s) {
        double d[kCoef];
        for (int e = 0; e < 2; ++e)
          for (int k = 0; k < kDer; ++k) {
            int li = e * kDer + k;
            bool fx;
            double val;
            int idx = var_of(s + e, k, &fx, &val, axis);
            d[li] = fx ? val : dF[idx];
          }
        for (int r = 0; r < kCoef; ++r) {
          double acc = 0;
          for (int c = 0; c < kCoef; ++c) acc += Ainv_store[s][r * kCoef + c] * d[c];
          out->coefs[(s * 3 + axis) * kCoef + r] = acc;
        }
      }
    }
    return true;
  }

  // Max over sampled velocity/acceleration vs limits; returns the time
  // scaling factor needed (<= 1 means feasible).
  double FeasibilityScale(const Trajectory& tr) const {
    double total = tr.total_time();
    double vmax = 0, amax = 0;
    const int kSamples = 200;
    for (int i = 0; i <= kSamples; ++i) {
      double t = total * i / kSamples;
      double v[3], a[3];
      Eval(tr, t, 1, v);
      Eval(tr, t, 2, a);
      vmax = std::max(vmax, std::sqrt(v[0] * v[0] + v[1] * v[1] + v[2] * v[2]));
      amax = std::max(amax, std::sqrt(a[0] * a[0] + a[1] * a[1] + a[2] * a[2]));
    }
    double k = 1.0;
    if (vmax > max_v_) k = std::max(k, vmax / max_v_);
    if (amax > max_a_) k = std::max(k, std::sqrt(amax / max_a_));
    return k;
  }

  double max_v_;
  double max_a_;
};

}  // namespace

// ----------------------------------------------------------------- C ABI

extern "C" {

void* trajgen_create(double max_v, double max_a) {
  return new TrajectoryPlanner(max_v, max_a);
}

void trajgen_destroy(void* planner) {
  delete static_cast<TrajectoryPlanner*>(planner);
}

// Plans through n waypoints (n x 3 row-major) and samples every dt
// seconds.  out must hold out_capacity doubles (multiples of 3).
// Returns the number of samples (rows) written, or -1 on failure /
// insufficient capacity.
int trajgen_plan(void* planner, const double* waypoints, int n, double dt,
                 double* out, int out_capacity) {
  auto* p = static_cast<TrajectoryPlanner*>(planner);
  Trajectory tr;
  if (!p->Plan(waypoints, n, &tr)) return -1;
  int needed = static_cast<int>(tr.total_time() / dt) + 2;
  if (needed * 3 > out_capacity) return -1;
  return p->Sample(tr, dt, out);
}

// Total planned flight time for capacity sizing.
double trajgen_total_time(void* planner, const double* waypoints, int n) {
  auto* p = static_cast<TrajectoryPlanner*>(planner);
  Trajectory tr;
  if (!p->Plan(waypoints, n, &tr)) return -1.0;
  return tr.total_time();
}

}  // extern "C"
