// Native pseudo-Boolean solver with cutting-planes conflict analysis.
//
// Capability parity: the PB-resolution machinery of the reference
// (ortools/sat/pb_constraint.h:526, UpperBoundedLinearConstraint::
// ResolvePBConflict) — conflicts over pseudo-Boolean constraints learn
// PSEUDO-BOOLEAN constraints, not clauses.  On counting-heavy families
// (pigeonhole-style OPB) clause learning is exponentially weaker;
// cutting-planes resolution refutes them in polynomially many steps.
//
// The design here follows the division-based calculus popularized by
// RoundingSat (Elffers & Nordstrom 2018), NOT the reference's
// implementation: counter-based propagation over saturated >=-form
// constraints, conflict analysis by weaken / ceil-divide ("round to
// one") of the reason at the resolved pivot, saturating addition, and a
// clause-analysis fallback when coefficient growth threatens overflow.
//
// Soundness notes
// ---------------
// * Every learned constraint is derived from the input by weakening,
//   ceil-division, non-negative linear combination and saturation — all
//   sound PB inference rules.
// * The Python wrapper re-verifies every SAT assignment against the
//   ORIGINAL constraints (A.9 contract), and the optimization loop only
//   trusts models, never internal bounds, for incumbents.
//
// C ABI (ctypes): pb_new / pb_add / pb_solve / pb_free / stats.
// Literal encoding at the ABI: lit = 2*v for x_v, 2*v+1 for ~x_v.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using ll = long long;
constexpr ll kDefaultOverflowGuard = 2e15;

inline int neg(int l) { return l ^ 1; }
inline int var_of(int l) { return l >> 1; }

enum Status { SAT = 10, UNSAT = 20, UNKNOWN = 30 };

struct Term {
  ll coef;
  int lit;
};

struct Constr {
  std::vector<Term> t;  // sorted by coef desc, one literal per var
  ll degree = 0;
  ll slack = 0;        // sum over non-false terms of coef, minus degree
  double activity = 0.0;
  bool learned = false;
};

struct OccEntry {
  int ci;
  ll coef;  // coefficient of this literal in cs[ci] (immutable)
};

struct Pb {
  int n = 0;  // variables
  std::vector<Constr> cs;
  // occurrence lists: occ[l] = constraints containing literal l, with
  // the literal's coefficient denormalized in (no per-event scan)
  std::vector<std::vector<OccEntry>> occ;
  std::vector<int8_t> val;     // per var: -1 unassigned, 0 false, 1 true
  std::vector<int> level_of;   // per var
  std::vector<int> reason_of;  // per var: constraint id or -1 (decision)
  std::vector<int> trail;      // literals set true, in order
  std::vector<int> trail_lim;  // decision markers
  std::vector<double> act;     // VSIDS per var
  std::vector<int8_t> phase;   // saved phase per var
  double var_inc = 1.0;
  ll overflow_guard = kDefaultOverflowGuard;  // lowered in tests to
                                              // exercise the fallback
  ll conflicts = 0, propagations = 0, pb_learned = 0, clause_fallbacks = 0;
  bool root_unsat = false;

  int level() const { return (int)trail_lim.size(); }
  bool lit_true(int l) const { return val[var_of(l)] == ((l & 1) ? 0 : 1); }
  bool lit_false(int l) const { return val[var_of(l)] == ((l & 1) ? 1 : 0); }
  bool unassigned(int l) const { return val[var_of(l)] < 0; }

  // ---- construction ---------------------------------------------------

  // Add sum coef_i * lit_i >= degree after normalization; returns false
  // on detected root infeasibility.
  bool add_constraint(std::vector<Term> terms, ll degree, bool learned) {
    // merge per-var, make coefs positive
    std::sort(terms.begin(), terms.end(),
              [](const Term& a, const Term& b) {
                return var_of(a.lit) < var_of(b.lit);
              });
    std::vector<Term> merged;
    for (size_t i = 0; i < terms.size();) {
      int v = var_of(terms[i].lit);
      ll cpos = 0;  // coefficient on literal 2v
      size_t j = i;
      for (; j < terms.size() && var_of(terms[j].lit) == v; ++j) {
        cpos += (terms[j].lit & 1) ? -terms[j].coef : terms[j].coef;
      }
      // cpos * x_v  ==  cpos * lit(2v); negative flips to ~x with offset
      if (cpos > 0) {
        merged.push_back({cpos, 2 * v});
      } else if (cpos < 0) {
        merged.push_back({-cpos, 2 * v + 1});
        degree += -cpos;  // c*x = c - c*~x
      }
      // accumulate offsets of the ~x inputs we folded into cpos
      for (size_t k = i; k < j; ++k)
        if (terms[k].lit & 1) degree -= terms[k].coef;
      i = j;
    }
    if (degree <= 0) return true;  // trivially satisfied
    ll total = 0;
    for (auto& tm : merged) {
      tm.coef = std::min(tm.coef, degree);  // saturation
      total += tm.coef;
    }
    if (total < degree) {  // unsatisfiable row
      root_unsat = true;
      return false;
    }
    std::sort(merged.begin(), merged.end(),
              [](const Term& a, const Term& b) { return a.coef > b.coef; });
    Constr c;
    c.t = std::move(merged);
    c.degree = degree;
    c.learned = learned;
    int id = (int)cs.size();
    cs.push_back(std::move(c));
    for (auto& tm : cs[id].t) occ[tm.lit].push_back({id, tm.coef});
    init_slack(id);
    return true;
  }

  void init_slack(int ci) {
    Constr& c = cs[ci];
    ll s = -c.degree;
    for (auto& tm : c.t)
      if (!lit_false(tm.lit)) s += tm.coef;
    c.slack = s;
  }

  // ---- trail ----------------------------------------------------------

  void enqueue(int l, int reason) {
    int v = var_of(l);
    val[v] = (l & 1) ? 0 : 1;
    level_of[v] = level();
    reason_of[v] = reason;
    trail.push_back(l);
    // literal l just became true; constraints holding ~l lose slack
    for (const auto& oe : occ[neg(l)]) cs[oe.ci].slack -= oe.coef;
  }

  ll coef_of(int ci, int l) const {
    for (auto& tm : cs[ci].t)
      if (tm.lit == l) return tm.coef;
    return 0;
  }

  void undo_one() {
    int l = trail.back();
    trail.pop_back();
    int v = var_of(l);
    phase[v] = val[v];
    val[v] = -1;
    reason_of[v] = -1;
    for (const auto& oe : occ[neg(l)]) cs[oe.ci].slack += oe.coef;
  }

  void backjump_to(int lvl) {
    while (level() > lvl) {
      int mark = trail_lim.back();
      trail_lim.pop_back();
      while ((int)trail.size() > mark) undo_one();
    }
  }

  // ---- propagation ----------------------------------------------------

  // returns conflicting constraint id or -1
  int propagate(size_t& qhead) {
    while (qhead < trail.size()) {
      int l = trail[qhead++];
      // constraints containing ~l had slack reduced at enqueue time
      for (const auto& oe : occ[neg(l)]) {
        const int ci = oe.ci;
        Constr& c = cs[ci];
        if (c.slack < 0) return ci;
        // propagate all unassigned lits with coef > slack (terms are
        // coef-desc so the eligible ones form a prefix)
        for (auto& tm : c.t) {
          if (tm.coef <= c.slack) break;
          if (unassigned(tm.lit)) {
            enqueue(tm.lit, ci);
            ++propagations;
          }
        }
      }
    }
    return -1;
  }

  // full initial propagation pass at the root (all constraints)
  int propagate_all_root(size_t& qhead) {
    for (int ci = 0; ci < (int)cs.size(); ++ci) {
      Constr& c = cs[ci];
      if (c.slack < 0) return ci;
      for (auto& tm : c.t) {
        if (tm.coef <= c.slack) break;
        if (unassigned(tm.lit)) {
          enqueue(tm.lit, ci);
          ++propagations;
        }
      }
    }
    return propagate(qhead);
  }

  // ---- cutting-planes analysis ----------------------------------------

  // working constraint: coefficient per literal + degree
  std::vector<ll> wcoef;      // size 2n
  std::vector<int> wlits;     // literals ever touched (deduped)
  std::vector<int8_t> winlist;  // membership flag for wlits

  void w_clear() {
    for (int l : wlits) {
      wcoef[l] = 0;
      winlist[l] = 0;
    }
    wlits.clear();
  }

  void w_addmul(const std::vector<Term>& t, ll degree, ll mult,
                ll* wdegree) {
    for (auto& tm : t) {
      int l = tm.lit;
      ll add = tm.coef * mult;
      if (wcoef[neg(l)] > 0) {
        // cancellation with the opposite literal
        ll m = std::min(add, wcoef[neg(l)]);
        wcoef[neg(l)] -= m;
        *wdegree -= m;
        add -= m;
      }
      if (add > 0) {
        if (!winlist[l]) {
          winlist[l] = 1;
          wlits.push_back(l);
        }
        wcoef[l] += add;
      }
    }
    *wdegree += degree * mult;
  }

  void w_saturate(ll wdegree) {
    if (wdegree <= 0) return;
    for (int l : wlits)
      if (wcoef[l] > wdegree) wcoef[l] = wdegree;
  }

  ll w_slack_now(ll wdegree) {
    ll s = -wdegree;
    for (int l : wlits)
      if (wcoef[l] > 0 && !lit_false(l)) s += wcoef[l];
    return s;
  }

  void bump_var(int v) {
    act[v] += var_inc;
    if (act[v] > 1e100) {
      for (auto& a : act) a *= 1e-100;
      var_inc *= 1e-100;
    }
  }

  // Round reason constraint R (which propagated lit p) "to one" at p:
  // weaken non-falsified literals (other than p) whose coefficient is
  // not divisible by coef(p), then ceil-divide everything by coef(p).
  // Returns terms + degree of the rounded reason.
  void round_to_one(const Constr& r, int p, std::vector<Term>* out,
                    ll* out_degree) {
    ll cp = 0;
    for (auto& tm : r.t)
      if (tm.lit == p) { cp = tm.coef; break; }
    ll deg = r.degree;
    out->clear();
    for (auto& tm : r.t) {
      if (tm.lit == p) { out->push_back({1, p}); continue; }
      if (!lit_false(tm.lit) && (tm.coef % cp) != 0) {
        deg -= tm.coef;  // weaken away
        continue;
      }
      out->push_back({(tm.coef + cp - 1) / cp, tm.lit});
    }
    *out_degree = deg <= 0 ? 0 : (deg + cp - 1) / cp;
  }

  // Cutting-planes conflict analysis.  On success: learned constraint
  // in (learnt, learnt_degree), and the trail is already backjumped to
  // where the learned constraint is no longer conflicting.  Returns
  // false when the conflict proves root infeasibility.
  bool analyze(int confl_ci) {
    ++conflicts;
    var_inc *= 1.0 / 0.95;
    w_clear();
    ll wdegree = 0;
    w_addmul(cs[confl_ci].t, cs[confl_ci].degree, 1, &wdegree);
    w_saturate(wdegree);
    std::vector<Term> rr;
    ll rr_deg;
    while (true) {
      if (w_slack_now(wdegree) >= 0) break;  // no longer conflicting
      if (level() == 0) return false;        // conflict at root: UNSAT
      int l = trail.back();
      ll cneg = wcoef[neg(l)];
      int rci = (cneg > 0) ? reason_of[var_of(l)] : -1;
      if (cneg > 0 && rci >= 0) {
        bump_var(var_of(l));
        cs[rci].activity += 1.0;
        round_to_one(cs[rci], l, &rr, &rr_deg);
        // overflow guard: degree growth bound deg_W + cneg * rr_deg.
        // When it trips, reduce the REASON to its support clause
        // { l } + falsified literals of R — implied by R alone (if all
        // of them were false the remaining coefficient mass is below
        // the degree), with slack exactly 0 at this state, so the
        // conflict invariant survives resolution (the classical
        // clause-reduction of PB analysis, cf. Sat4j / reference
        // pb_constraint.cc overflow handling).
        if (wdegree > overflow_guard ||
            rr_deg > overflow_guard / std::max<ll>(cneg, 1)) {
          ++clause_fallbacks;
          rr.clear();
          rr.push_back({1, l});
          for (auto& tm : cs[rci].t)
            if (tm.lit != l && lit_false(tm.lit)) rr.push_back({1, tm.lit});
          rr_deg = 1;
          // resolve with multiplier = the working coefficient of ~l so
          // the pivot cancels exactly
        }
        w_addmul(rr, rr_deg, cneg, &wdegree);
        w_saturate(wdegree);
        // pivot must be canceled now
        // (wcoef[neg(l)] == 0 by construction)
      }
      // pop l — decision or resolved-away propagation alike
      if (!trail_lim.empty() &&
          (int)trail.size() - 1 == trail_lim.back()) {
        trail_lim.pop_back();  // popping the decision literal itself
      }
      undo_one();
    }
    // materialize learned constraint
    std::vector<Term> lt;
    for (int l : wlits)
      if (wcoef[l] > 0) lt.push_back({wcoef[l], l});
    if (lt.empty() || wdegree <= 0) {
      // degenerate (e.g. everything weakened away): nothing to learn;
      // restart from the root so the search cannot spin in place
      backjump_to(0);
      return true;
    }
    ++pb_learned;
    add_constraint(lt, wdegree, /*learned=*/true);
    return true;
  }

  // ---- learned-constraint DB reduction --------------------------------

  // Call ONLY at level 0 (root reasons are never dereferenced, so ids
  // may be rebuilt).  Keeps every original constraint and the
  // higher-activity half of the learned ones.
  ll reduce_threshold = 4000;

  void reduce_db() {
    std::vector<double> acts;
    for (auto& c : cs)
      if (c.learned) acts.push_back(c.activity);
    if ((ll)acts.size() < reduce_threshold) return;
    std::nth_element(acts.begin(), acts.begin() + acts.size() / 2,
                     acts.end());
    double med = acts[acts.size() / 2];
    std::vector<Constr> keep;
    keep.reserve(cs.size());
    for (auto& c : cs) {
      if (!c.learned || c.activity >= med) {
        c.activity *= 0.5;  // decay so old winners fade
        keep.push_back(std::move(c));
      }
    }
    cs = std::move(keep);
    for (auto& o : occ) o.clear();
    for (int ci = 0; ci < (int)cs.size(); ++ci) {
      for (auto& tm : cs[ci].t) occ[tm.lit].push_back({ci, tm.coef});
      init_slack(ci);
    }
    for (int v = 0; v < n; ++v)
      if (val[v] >= 0) reason_of[v] = -1;  // root facts need no reason
    reduce_threshold = (ll)(reduce_threshold * 1.2);
  }

  // ---- search ---------------------------------------------------------

  int pick_branch() {
    int best = -1;
    double best_a = -1.0;
    for (int v = 0; v < n; ++v)
      if (val[v] < 0 && act[v] > best_a) {
        best_a = act[v];
        best = v;
      }
    if (best < 0) return -1;
    return phase[best] == 1 ? 2 * best : 2 * best + 1;
  }

  int solve(ll conflict_budget) {
    if (root_unsat) return UNSAT;
    size_t qhead = 0;
    int confl = propagate_all_root(qhead);
    if (confl >= 0) return UNSAT;
    ll luby_base = 64, restart_at = luby_base, since_restart = 0;
    int luby_k = 1;
    while (true) {
      confl = propagate(qhead);
      if (confl >= 0) {
        ++since_restart;
        if (conflicts >= conflict_budget) return UNKNOWN;
        if (!analyze(confl)) return UNSAT;
        // after analyze the trail is wherever the working constraint
        // stopped conflicting; re-propagate everything pending
        qhead = std::min(qhead, trail.size());
        // new constraint may immediately propagate
        int ci = (int)cs.size() - 1;
        if (ci >= 0 && !cs.empty()) {
          Constr& c = cs[ci];
          if (c.slack < 0) {
            // still conflicting here (can happen after clause fallback
            // backjump): analyze again next loop via propagate
          } else {
            for (auto& tm : c.t) {
              if (tm.coef <= c.slack) break;
              if (unassigned(tm.lit)) {
                enqueue(tm.lit, ci);
                ++propagations;
              }
            }
          }
        }
        if (since_restart >= restart_at) {
          since_restart = 0;
          restart_at = luby_base * luby(++luby_k);
          backjump_to(0);
          reduce_db();
          qhead = std::min(qhead, trail.size());
        }
        continue;
      }
      int l = pick_branch();
      if (l < 0) return SAT;  // full assignment, no conflict
      trail_lim.push_back((int)trail.size());
      enqueue(l, -1);
    }
  }

  static ll luby(int i) {
    // Knuth's Luby sequence
    for (ll k = 1; k < 64; ++k) {
      if (i == (1LL << k) - 1) return 1LL << (k - 1);
    }
    ll k = 1;
    while (i >= (1LL << k) - 1) ++k;
    --k;
    return luby(i - (int)(1LL << k) + 1);
  }
};

}  // namespace

extern "C" {

void* pb_new(int n_vars) {
  Pb* s = new Pb();
  s->n = n_vars;
  s->occ.assign(2 * (size_t)n_vars, {});
  s->val.assign(n_vars, -1);
  s->level_of.assign(n_vars, 0);
  s->reason_of.assign(n_vars, -1);
  s->act.assign(n_vars, 0.0);
  s->phase.assign(n_vars, 0);
  s->wcoef.assign(2 * (size_t)n_vars, 0);
  s->winlist.assign(2 * (size_t)n_vars, 0);
  return s;
}

void pb_free(void* p) { delete static_cast<Pb*>(p); }

// terms: coefs[i] * lit(lits[i]) summed >= degree.  Returns 0 on
// success, 1 when the constraint is infeasible at the root.
int pb_add(void* p, int n_terms, const long long* coefs,
           const int32_t* lits, long long degree) {
  Pb* s = static_cast<Pb*>(p);
  std::vector<Term> t(n_terms);
  for (int i = 0; i < n_terms; ++i) t[i] = {coefs[i], lits[i]};
  return s->add_constraint(std::move(t), degree, false) ? 0 : 1;
}

// Solve with a conflict budget.  Returns 10 SAT / 20 UNSAT / 30 UNKNOWN.
// On SAT, out_model[v] in {0,1}.
int pb_solve(void* p, long long conflict_budget, int8_t* out_model) {
  Pb* s = static_cast<Pb*>(p);
  s->backjump_to(0);
  int st = s->solve(conflict_budget);
  if (st == SAT && out_model) {
    for (int v = 0; v < s->n; ++v) out_model[v] = s->val[v] == 1 ? 1 : 0;
  }
  if (st != SAT) s->backjump_to(0);
  return st;
}

long long pb_conflicts(void* p) { return static_cast<Pb*>(p)->conflicts; }
long long pb_propagations(void* p) {
  return static_cast<Pb*>(p)->propagations;
}
long long pb_learned(void* p) { return static_cast<Pb*>(p)->pb_learned; }
long long pb_clause_fallbacks(void* p) {
  return static_cast<Pb*>(p)->clause_fallbacks;
}

// test hook: lower the coefficient-overflow guard so the clause-analysis
// fallback path can be exercised on small instances
void pb_set_overflow_guard(void* p, long long g) {
  static_cast<Pb*>(p)->overflow_guard = g;
}

}  // extern "C"
