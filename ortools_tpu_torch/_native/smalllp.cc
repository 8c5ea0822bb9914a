// smalllp.cc — dense bounded-variable dual simplex for B&B node re-solves.
//
// Capability parity: the role glop's RevisedSimplex plays inside the
// reference's search (ortools/sat/linear_programming_constraint.h:442 holds
// a glop::RevisedSimplex; node re-solves enter DualMinimize,
// glop/revised_simplex.cc:3058).  The Python host simplex
// (ortools_tpu/glop/simplex.py) is the featureful oracle; this native core
// is its hot-path sibling for SMALL dense node LPs where per-iteration
// interpreter overhead dominates (measured 6.5 ms/resolve in Python on an
// 18x118 LP — microseconds here).
//
// Contract with the Python side (ortools_tpu/glop/native_simplex.py):
//   - status 0 OPTIMAL:  x/y/d/objective available; the solver refactorized
//     freshly and re-verified primal feasibility + reduced-cost signs
//     before claiming.  Python re-verifies independently.
//   - status 1 INFEASIBLE: a Farkas row multiplier rho is exported; Python
//     verifies  0 outside [min, max] of rho.(tab z) over the box.
//   - status 2 ABNORMAL / 3 ITER_LIMIT: no claim; Python falls back to its
//     own simplex / PDHG path.
//
// Formulation mirrors the Python class: columns z = (x, s), tab = [A | -I],
// tab.z = 0, bounds on all of z.  Dual simplex only — the basis stays dual
// feasible under bound changes, which is exactly the node re-solve pattern.

#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr double kPivTol = 1e-9;
// entry/exit dual-sign tolerance: the seeding (Python devex) solve only
// guarantees ~1e-6-relative reduced-cost signs, and the Python side
// re-verifies every OPTIMAL claim with an independent weak-duality gap
// check, so this tolerance gates convergence, not soundness
constexpr double kDualTol = 4e-6;
constexpr double kFeasTol = 1e-7;
constexpr int kRefactorPeriod = 64;

enum Status { OPTIMAL = 0, INFEASIBLE = 1, ABNORMAL = 2, ITER_LIMIT = 3 };
enum NbStat { AT_LOWER = 0, AT_UPPER = 1, FREE = 2 };

struct Slp {
  int m = 0, n = 0, total = 0;
  // column-major: col j is tab[j * m .. j * m + m)
  std::vector<double> tab;
  std::vector<double> lb, ub, cost;
  std::vector<int> basis;        // length m
  std::vector<uint8_t> in_basis; // length total
  std::vector<int8_t> nbstat;    // length total
  // dense LU of the basis (column-major m x m) with partial pivoting
  std::vector<double> lu;
  std::vector<int> piv;
  struct Eta {
    int r;
    std::vector<double> w;
  };
  std::vector<Eta> etas;
  std::vector<double> xb, y, d;
  std::vector<double> farkas;
  long iters = 0;
  bool have_fact = false;
  int last_error = 0;  // debug: where the last run bailed

  // ---- factorization ----------------------------------------------------
  bool factorize() {
    etas.clear();
    lu.assign((size_t)m * m, 0.0);
    piv.resize(m);
    for (int k = 0; k < m; ++k) {
      const double* col = &tab[(size_t)basis[k] * m];
      std::memcpy(&lu[(size_t)k * m], col, sizeof(double) * m);
    }
    // right-looking LU with partial pivoting
    for (int k = 0; k < m; ++k) {
      int p = k;
      double best = std::fabs(lu[(size_t)k * m + k]);
      for (int i = k + 1; i < m; ++i) {
        double v = std::fabs(lu[(size_t)k * m + i]);
        if (v > best) {
          best = v;
          p = i;
        }
      }
      if (best < 1e-12) return false;  // singular
      piv[k] = p;
      if (p != k)
        for (int j = 0; j < m; ++j)
          std::swap(lu[(size_t)j * m + k], lu[(size_t)j * m + p]);
      const double inv = 1.0 / lu[(size_t)k * m + k];
      for (int i = k + 1; i < m; ++i) lu[(size_t)k * m + i] *= inv;
      for (int j = k + 1; j < m; ++j) {
        const double f = lu[(size_t)j * m + k];
        if (f == 0.0) continue;
        double* cj = &lu[(size_t)j * m];
        const double* ck = &lu[(size_t)k * m];
        for (int i = k + 1; i < m; ++i) cj[i] -= f * ck[i];
      }
    }
    have_fact = true;
    return true;
  }

  // solve B v = b (in place).  factorize() permutes FULL rows (including
  // the already-built L part, LAPACK getrf convention), so the stored
  // factors satisfy P B = L U with P applied wholesale: apply every swap
  // first, then the L and U solves.
  void base_ftran(double* v) const {
    for (int k = 0; k < m; ++k)
      if (piv[k] != k) std::swap(v[k], v[piv[k]]);
    for (int k = 0; k < m; ++k) {
      const double vk = v[k];
      if (vk != 0.0) {
        const double* ck = &lu[(size_t)k * m];
        for (int i = k + 1; i < m; ++i) v[i] -= vk * ck[i];
      }
    }
    for (int k = m - 1; k >= 0; --k) {
      double s = v[k];
      for (int j = k + 1; j < m; ++j) s -= lu[(size_t)j * m + k] * v[j];
      v[k] = s / lu[(size_t)k * m + k];
    }
  }

  // solve B^T v = b (in place).  B = P^T L U (ftran applies P, L, U), so
  // B^T v = b is U^T z = b (forward), L^T q = z (backward, unit diag),
  // v = P^T q (pivot swaps in reverse order).
  void base_btran(double* v) const {
    for (int k = 0; k < m; ++k) {
      double s = v[k];
      const double* ck = &lu[(size_t)k * m];
      for (int j = 0; j < k; ++j) s -= ck[j] * v[j];
      v[k] = s / ck[k];
    }
    for (int k = m - 1; k >= 0; --k) {
      double s = v[k];
      const double* ck = &lu[(size_t)k * m];
      for (int i = k + 1; i < m; ++i) s -= ck[i] * v[i];
      v[k] = s;
    }
    // v = P^T q: undo the wholesale row permutation (reverse order)
    for (int k = m - 1; k >= 0; --k)
      if (piv[k] != k) std::swap(v[k], v[piv[k]]);
  }

  void ftran(double* v) const {
    base_ftran(v);
    for (const Eta& e : etas) {
      const double vr = v[e.r] / e.w[e.r];
      for (int i = 0; i < m; ++i) v[i] -= e.w[i] * vr;
      v[e.r] = vr;
    }
  }

  void btran(double* v) const {
    for (auto it = etas.rbegin(); it != etas.rend(); ++it) {
      const Eta& e = *it;
      double s = v[e.r];
      v[e.r] = 0.0;
      for (int i = 0; i < m; ++i) s -= e.w[i] * v[i];
      v[e.r] = s / e.w[e.r];
    }
    base_btran(v);
  }

  double nb_value(int j) const {
    if (in_basis[j]) return 0.0;
    if (nbstat[j] == AT_LOWER && std::isfinite(lb[j])) return lb[j];
    if (nbstat[j] == AT_UPPER && std::isfinite(ub[j])) return ub[j];
    if (nbstat[j] == AT_LOWER && std::isfinite(ub[j])) return ub[j];
    return 0.0;
  }

  void compute_xb() {
    xb.assign(m, 0.0);
    for (int j = 0; j < total; ++j) {
      if (in_basis[j]) continue;
      const double v = nb_value(j);
      if (v == 0.0) continue;
      const double* col = &tab[(size_t)j * m];
      for (int i = 0; i < m; ++i) xb[i] -= col[i] * v;
    }
    ftran(xb.data());
  }

  void compute_duals() {
    y.assign(m, 0.0);
    for (int k = 0; k < m; ++k) y[k] = cost[basis[k]];
    btran(y.data());
    d.assign(total, 0.0);
    for (int j = 0; j < total; ++j) {
      if (in_basis[j]) {
        d[j] = 0.0;
        continue;
      }
      const double* col = &tab[(size_t)j * m];
      double s = 0.0;
      for (int i = 0; i < m; ++i) s += y[i] * col[i];
      d[j] = cost[j] - s;
    }
  }

  // re-derive nonbasic statuses after bound changes (finite-bound rule,
  // mirrors Python set_variable_bounds)
  void repair_statuses() {
    for (int j = 0; j < total; ++j) {
      if (in_basis[j]) continue;
      const bool lo = std::isfinite(lb[j]);
      const bool hi = std::isfinite(ub[j]);
      if (nbstat[j] == AT_LOWER && !lo) nbstat[j] = hi ? AT_UPPER : FREE;
      if (nbstat[j] == AT_UPPER && !hi) nbstat[j] = lo ? AT_LOWER : FREE;
      if (nbstat[j] == FREE && (lo || hi))
        nbstat[j] = lo ? AT_LOWER : AT_UPPER;
    }
  }

  bool dual_feasible() const {
    for (int j = 0; j < total; ++j) {
      if (in_basis[j]) continue;
      const double dj = d[j];
      const double cs = 1.0 + std::fabs(cost[j]);
      if (nbstat[j] == AT_LOWER && dj < -kDualTol * cs) return false;
      if (nbstat[j] == AT_UPPER && dj > kDualTol * cs) return false;
      if (nbstat[j] == FREE && std::fabs(dj) > kDualTol * cs) return false;
    }
    return true;
  }

  int run_dual(int max_iters) {
    last_error = 0;
    if (!factorize()) { last_error = 10; return ABNORMAL; }
    repair_statuses();
    compute_xb();
    compute_duals();
    if (!dual_feasible()) { last_error = 11; return ABNORMAL; }
    std::vector<double> rho(m), alpha(total), w(m);
    int degenerate = 0;
    for (int it = 0; it < max_iters; ++it) {
      // leaving: most violated basic bound
      int r = -1;
      bool above = false;
      double worst = kFeasTol;
      for (int k = 0; k < m; ++k) {
        const int bj = basis[k];
        const double scale = 1.0 + std::fabs(xb[k]);
        if (std::isfinite(lb[bj]) && lb[bj] - xb[k] > worst * scale) {
          worst = (lb[bj] - xb[k]) / scale;
          r = k;
          above = false;
        }
        if (std::isfinite(ub[bj]) && xb[k] - ub[bj] > worst * scale) {
          worst = (xb[k] - ub[bj]) / scale;
          r = k;
          above = true;
        }
      }
      if (r < 0) {
        // primal feasible.  Claim only from FRESH state: with pending
        // etas, refactorize + recompute and re-scan (incremental drift
        // may hide a violation); with none, xb is exactly the fresh
        // recompute, so certify the duals and return.
        if (!etas.empty()) {
          if (!factorize()) return ABNORMAL;
          compute_xb();
          compute_duals();
          continue;
        }
        compute_duals();
        if (!dual_feasible()) { last_error = 12; return ABNORMAL; }
        return OPTIMAL;
      }
      // rho = B^-T e_r ; alpha_j = rho . a_j
      std::fill(rho.begin(), rho.end(), 0.0);
      rho[r] = 1.0;
      btran(rho.data());
      for (int j = 0; j < total; ++j) {
        if (in_basis[j]) {
          alpha[j] = 0.0;
          continue;
        }
        const double* col = &tab[(size_t)j * m];
        double s = 0.0;
        for (int i = 0; i < m; ++i) s += rho[i] * col[i];
        alpha[j] = s;
      }
      // entering: dual ratio test among sign-eligible columns
      int entering = -1;
      double best_ratio = 0.0;
      for (int j = 0; j < total; ++j) {
        if (in_basis[j]) continue;
        double move;  // alpha_j * direction of j's feasible increase
        if (nbstat[j] == AT_LOWER)
          move = alpha[j];
        else if (nbstat[j] == AT_UPPER)
          move = -alpha[j];
        else
          move = std::fabs(alpha[j]);  // free moves either way
        const bool elig = above ? (move > kPivTol) : (move < -kPivTol);
        const bool elig_free =
            nbstat[j] == FREE && std::fabs(alpha[j]) > kPivTol;
        if (!elig && !elig_free) continue;
        const double ratio =
            std::fabs(d[j]) / std::max(std::fabs(alpha[j]), 1e-30);
        if (entering < 0 || ratio < best_ratio) {
          best_ratio = ratio;
          entering = j;
        }
      }
      if (entering < 0) {
        // dual unbounded == primal infeasible; only claim from a fresh
        // factorization, and export the Farkas row
        if (!etas.empty()) {
          if (!factorize()) return ABNORMAL;
          compute_xb();
          compute_duals();
          continue;  // re-derive the leaving row cleanly
        }
        farkas = rho;
        return INFEASIBLE;
      }
      // w = B^-1 a_e
      {
        const double* col = &tab[(size_t)entering * m];
        std::memcpy(w.data(), col, sizeof(double) * m);
        ftran(w.data());
      }
      if (std::fabs(w[r]) < kPivTol) {
        if (!etas.empty()) {
          if (!factorize()) return ABNORMAL;
          compute_xb();
          compute_duals();
          continue;
        }
        return ABNORMAL;
      }
      ++iters;
      const int out = basis[r];
      const double tgt = above ? ub[out] : lb[out];
      const double t = (xb[r] - tgt) / w[r];
      if (std::fabs(best_ratio) <= 1e-12) {
        if (++degenerate > 2000) { last_error = 13; return ABNORMAL; }
      } else {
        degenerate = 0;
      }
      const double nbv_e = nb_value(entering);
      for (int i = 0; i < m; ++i) xb[i] -= t * w[i];
      xb[r] = nbv_e + t;
      // reduced-cost update along the alpha row; the leaving column has
      // alpha_out = rho . a_out = e_r . (B^-1 a_out) = 1, so its new
      // reduced cost is exactly -ratio
      {
        const double ratio = d[entering] / alpha[entering];
        for (int j = 0; j < total; ++j)
          if (!in_basis[j]) d[j] -= ratio * alpha[j];
        d[entering] = 0.0;
        d[out] = -ratio;
      }
      // pivot bookkeeping
      in_basis[out] = 0;
      nbstat[out] = above ? AT_UPPER : AT_LOWER;
      basis[r] = entering;
      in_basis[entering] = 1;
      if ((int)etas.size() >= kRefactorPeriod) {
        if (!factorize()) return ABNORMAL;
        compute_xb();
        compute_duals();
      } else {
        etas.push_back(Eta{r, w});
      }
    }
    last_error = 14;
    return ITER_LIMIT;
  }
};

}  // namespace

extern "C" {

void* slp_new(int m, int n, const double* a_rowmajor, const double* cost_n) {
  Slp* s = new Slp();
  s->m = m;
  s->n = n;
  s->total = n + m;
  s->tab.assign((size_t)s->total * m, 0.0);
  for (int j = 0; j < n; ++j)
    for (int i = 0; i < m; ++i)
      s->tab[(size_t)j * m + i] = a_rowmajor[(size_t)i * n + j];
  for (int k = 0; k < m; ++k) s->tab[(size_t)(n + k) * m + k] = -1.0;
  s->cost.assign(s->total, 0.0);
  for (int j = 0; j < n; ++j) s->cost[j] = cost_n[j];
  s->lb.assign(s->total, 0.0);
  s->ub.assign(s->total, 0.0);
  s->basis.resize(m);
  for (int k = 0; k < m; ++k) s->basis[k] = n + k;
  s->in_basis.assign(s->total, 0);
  for (int k = 0; k < m; ++k) s->in_basis[n + k] = 1;
  s->nbstat.assign(s->total, AT_LOWER);
  return s;
}

void slp_free(void* p) { delete static_cast<Slp*>(p); }

// Set all bounds: variable bounds (length n) + slack/constraint bounds
// (length m), then re-derive nonbasic statuses.
void slp_set_bounds(void* p, const double* vlb, const double* vub,
                    const double* clb, const double* cub) {
  Slp* s = static_cast<Slp*>(p);
  for (int j = 0; j < s->n; ++j) {
    s->lb[j] = vlb[j];
    s->ub[j] = vub[j];
  }
  for (int k = 0; k < s->m; ++k) {
    s->lb[s->n + k] = clb[k];
    s->ub[s->n + k] = cub[k];
  }
}

// Load an externally-known basis + statuses (warm start from the Python
// simplex).  basis: length m column ids; nbstat: length total.
void slp_set_basis(void* p, const int32_t* basis, const int8_t* nbstat) {
  Slp* s = static_cast<Slp*>(p);
  std::fill(s->in_basis.begin(), s->in_basis.end(), 0);
  for (int k = 0; k < s->m; ++k) {
    s->basis[k] = basis[k];
    s->in_basis[basis[k]] = 1;
  }
  for (int j = 0; j < s->total; ++j) s->nbstat[j] = nbstat[j];
}

int slp_resolve(void* p, int max_iters) {
  Slp* s = static_cast<Slp*>(p);
  return s->run_dual(max_iters);
}

double slp_objective(void* p) {
  Slp* s = static_cast<Slp*>(p);
  double obj = 0.0;
  for (int j = 0; j < s->total; ++j) {
    if (s->in_basis[j]) continue;
    obj += s->cost[j] * s->nb_value(j);
  }
  for (int k = 0; k < s->m; ++k) obj += s->cost[s->basis[k]] * s->xb[k];
  return obj;
}

void slp_solution(void* p, double* x_out) {
  Slp* s = static_cast<Slp*>(p);
  for (int j = 0; j < s->n; ++j) x_out[j] = s->in_basis[j] ? 0.0 : s->nb_value(j);
  for (int k = 0; k < s->m; ++k)
    if (s->basis[k] < s->n) x_out[s->basis[k]] = s->xb[k];
}

void slp_duals(void* p, double* y_out) {
  Slp* s = static_cast<Slp*>(p);
  for (int i = 0; i < s->m; ++i) y_out[i] = s->y[i];
}

void slp_redcosts(void* p, double* d_out) {
  Slp* s = static_cast<Slp*>(p);
  for (int j = 0; j < s->n; ++j) d_out[j] = s->d[j];
}

void slp_farkas(void* p, double* rho_out) {
  Slp* s = static_cast<Slp*>(p);
  for (int i = 0; i < s->m; ++i)
    rho_out[i] = i < (int)s->farkas.size() ? s->farkas[i] : 0.0;
}

long slp_iters(void* p) { return static_cast<Slp*>(p)->iters; }

int slp_last_error(void* p) { return static_cast<Slp*>(p)->last_error; }

// debug: factorize the current basis and solve B f = rhs and B^T b = rhs
int slp_debug_lin(void* p, const double* rhs, double* ftran_out,
                  double* btran_out) {
  Slp* s = static_cast<Slp*>(p);
  if (!s->factorize()) return 1;
  for (int i = 0; i < s->m; ++i) ftran_out[i] = rhs[i];
  s->ftran(ftran_out);
  for (int i = 0; i < s->m; ++i) btran_out[i] = rhs[i];
  s->btran(btran_out);
  return 0;
}

}  // extern "C"
