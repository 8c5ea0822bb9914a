// Native lazy-clause-generation (LCG) core: CDCL over booleans PLUS
// lazily-created integer bound literals, with explained bound propagation
// for linear (and thus precedence) constraints.
//
// Capability parity: the reference's defining CP-SAT architecture —
// IntegerEncoder lazy literal creation (ortools/sat/integer.h:453),
// IntegerTrail with explained bound propagation (integer.h:722),
// LinearPropagator explanations (sat/linear_propagation.h:176) and
// precedence propagation (sat/precedences.h:111) — so general-integer
// models get clause LEARNING over bound literals instead of either the
// eager order-encoding ladder (sat/integer_encoding.py) or the
// no-learning DFS engine (sat/engine.py).
//
// Original design (not a translation): single boolean trail in the
// chuffed style — every integer bound change is materialized as a lazily
// created boolean literal [x >= v], kept mutually consistent by on-demand
// binary "channel" clauses to its neighboring bound literals; propagator
// explanations are stored in a per-level arena and referenced as tagged
// reasons, so 1UIP conflict analysis, clause minimization, LBD deletion,
// VSIDS, phase saving and Luby restarts all run unchanged over one trail.
//
// Conventions: external bool literals are DIMACS-style +-(idx+1) over a
// unified variable space; integer variables have their own index space.
// The C ABI (bottom) is consumed via ctypes from ortools_tpu.sat.lcg.

#include <algorithm>
#include <chrono>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

using u32 = uint32_t;
using i32 = int32_t;
using i64 = int64_t;

constexpr u32 kNoReason = 0xffffffffu;
constexpr u32 kNoLit = 0xffffffffu;
// Sentinels returned by GeLit for bounds outside the root domain.
constexpr u32 kLitTrue = 0xfffffffeu;
constexpr u32 kLitFalse = 0xfffffffdu;
// Reasons with the top bit set index the explanation arena; reasons with
// the kChanBit encode a bound-literal channel implication whose 2-literal
// clause is reconstructed on demand (the "lazy reason" idea of the
// reference IntegerTrail, integer.h:722): the payload is the clause
// literal of the (currently false) antecedent.
constexpr u32 kExplBit = 0x80000000u;
constexpr u32 kChanBit = 0x40000000u;

constexpr i64 kInf = INT64_MAX / 4;  // saturation cap for activities

inline int Var(u32 lit) { return (int)(lit >> 1); }
inline u32 Neg(u32 lit) { return lit ^ 1u; }
inline u32 MkLit(int var, bool neg) { return ((u32)var << 1) | (u32)neg; }
inline u32 NegSent(u32 lit) {
  if (lit == kLitTrue) return kLitFalse;
  if (lit == kLitFalse) return kLitTrue;
  return Neg(lit);
}

constexpr uint8_t kTrue = 0, kFalse = 1, kUnassigned = 2;

inline i64 CapAdd(i64 a, i64 b) {
  if (a > 0 && b > kInf - a) return kInf;
  if (a < 0 && b < -kInf - a) return -kInf;
  return a + b;
}
inline i64 CapProd(i64 a, i64 b) {
  __int128 p = (__int128)a * b;
  if (p > kInf) return kInf;
  if (p < -kInf) return -kInf;
  return (i64)p;
}
inline i64 FloorDiv(i64 a, i64 b) {  // b != 0
  i64 q = a / b, r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? q - 1 : q;
}
inline i64 CeilDiv(i64 a, i64 b) { return -FloorDiv(-a, b); }

struct Watch {
  u32 cref;
  u32 blocker;
};

// A two-sided linear constraint: (AND enf) -> lo <= sum cs[i]*xs[i] <= hi.
struct LinCon {
  std::vector<u32> enf;  // internal bool literals, all must hold
  std::vector<i32> xs;   // integer variable indices
  std::vector<i64> cs;   // nonzero coefficients
  i64 lo, hi;
};

class Solver {
 public:
  Solver() = default;

  // ---- model building ----------------------------------------------------
  int NewBoolVar() {
    EnsureVars((int)assign_.size() + 1);
    return (int)assign_.size() - 1;
  }

  int NewIntVar(i64 lb, i64 ub) {
    int x = (int)ilb_.size();
    ilb_.push_back(lb);
    iub_.push_back(ub);
    root_lb_.push_back(lb);
    root_ub_.push_back(ub);
    bound_lits_.emplace_back();
    iwatch_lb_.emplace_back();
    iwatch_ub_.emplace_back();
    imodel_.push_back(lb);
    ihint_.push_back(INT64_MIN);  // no hint
    lb_setter_.push_back(-1);
    ub_setter_.push_back(-1);
    if (lb > ub) ok_ = false;
    return x;
  }

  // Value hint: lazily created bound literals [x >= v] get their saved
  // phase initialized to agree with the hint (reference
  // sat_decision.h SetAssignmentPreference, applied lazily).
  void SetIntHint(int x, i64 value) {
    if (x >= 0 && x < NumIntVars()) ihint_[x] = value;
  }

  int NumBoolVars() const { return (int)assign_.size(); }
  int NumIntVars() const { return (int)ilb_.size(); }

  bool AddClauseExt(const i32* ext, int n) {
    if (!ok_) return false;
    tmp_clause_.clear();
    for (int i = 0; i < n; ++i) {
      int v = std::abs(ext[i]) - 1;
      if (v >= NumBoolVars()) EnsureVars(v + 1);
      tmp_clause_.push_back(MkLit(v, ext[i] < 0));
    }
    return AddClauseInternal();
  }

  // lo <= sum cs*xs <= hi, enforced by the conjunction of ext bool lits.
  // Returns false on root infeasibility.
  bool AddLinear(const i32* enf_ext, int n_enf, const i32* xs,
                 const i64* cs, int n, i64 lo, i64 hi) {
    if (!ok_) return false;
    LinCon con;
    for (int i = 0; i < n_enf; ++i) {
      int v = std::abs(enf_ext[i]) - 1;
      if (v >= NumBoolVars()) EnsureVars(v + 1);
      con.enf.push_back(MkLit(v, enf_ext[i] < 0));
    }
    i64 fixed = 0;
    for (int i = 0; i < n; ++i) {
      if (cs[i] == 0) continue;
      if (xs[i] < 0 || xs[i] >= NumIntVars()) return false;
      if (root_lb_[xs[i]] == root_ub_[xs[i]]) {
        fixed = CapAdd(fixed, CapProd(cs[i], root_lb_[xs[i]]));
        continue;
      }
      con.xs.push_back(xs[i]);
      con.cs.push_back(cs[i]);
    }
    con.lo = lo <= -kInf ? -kInf : CapAdd(lo, -fixed);
    con.hi = hi >= kInf ? kInf : CapAdd(hi, -fixed);
    if (con.xs.empty()) {
      if (0 >= con.lo && 0 <= con.hi) return true;  // trivially satisfied
      if (con.enf.empty()) return ok_ = false;
      // infeasible body: at least one enforcement literal must be false
      tmp_clause_.clear();
      for (u32 e : con.enf) tmp_clause_.push_back(Neg(e));
      return AddClauseInternal();
    }
    int idx = (int)lincons_.size();
    lincons_.push_back(std::move(con));
    in_queue_.push_back(false);
    const LinCon& c = lincons_[idx];
    bool has_hi = c.hi < kInf, has_lo = c.lo > -kInf;
    for (size_t i = 0; i < c.xs.size(); ++i) {
      i32 x = c.xs[i];
      bool pos = c.cs[i] > 0;
      // hi side reads min_act (lb for +, ub for -); lo side reads max_act
      if ((pos && has_hi) || (!pos && has_lo)) iwatch_lb_[x].push_back(idx);
      if ((pos && has_lo) || (!pos && has_hi)) iwatch_ub_[x].push_back(idx);
    }
    for (u32 e : c.enf) {
      int v = Var(e);
      if ((int)ewatch_.size() <= v) ewatch_.resize(NumBoolVars());
      ewatch_[v].push_back(idx);
    }
    MarkDirty(idx);
    return true;
  }

  // External handle for the literal [x >= v]: returns a DIMACS-style
  // literal, or +-kTrueExt sentinels. Only safe at decision level 0.
  // (1 = trivially true, -1 is never returned; we reserve ext 0x7fffffff.)
  i32 GeLiteralExt(int x, i64 v) {
    u32 l = GeLit(x, v);
    if (l == kLitTrue) return INT32_MAX;
    if (l == kLitFalse) return -INT32_MAX;
    return (l & 1u) ? -(i32)((l >> 1) + 1) : (i32)((l >> 1) + 1);
  }

  // ---- solving -------------------------------------------------------------
  // 1 = SAT, 0 = UNSAT (core_ holds failed assumptions), -1 = budget.
  int Solve(const i32* assump, int n_assump, i64 conflict_budget,
            double time_budget_s) {
    core_.clear();
    if (!ok_) return 0;
    assumptions_.clear();
    for (int i = 0; i < n_assump; ++i) {
      int v = std::abs(assump[i]) - 1;
      if (assump[i] == INT32_MAX) continue;           // trivially true
      if (assump[i] == -INT32_MAX) return 0;          // trivially false
      if (v >= NumBoolVars()) EnsureVars(v + 1);
      assumptions_.push_back(MkLit(v, assump[i] < 0));
    }
    i64 budget =
        conflict_budget <= 0 ? INT64_MAX : conflicts_ + conflict_budget;
    auto t0 = std::chrono::steady_clock::now();
    auto out_of_time = [&]() {
      if (time_budget_s <= 0) return false;
      double dt = std::chrono::duration<double>(
                      std::chrono::steady_clock::now() - t0)
                      .count();
      return dt > time_budget_s;
    };
    int restart_seq = 1;
    i64 restart_limit = conflicts_ + 64 * Luby(restart_seq);
    size_t placed = 0;
    int assump_level = 0;
    BacktrackTo(0);

    for (;;) {
      u32 confl = PropagateAll();
      if (confl != kNoReason) {
        ++conflicts_;
        if (Level() == 0) return ok_ = false, 0;
        int bt_level;
        u32 asserting;
        u32 learnt_ref = AnalyzeConflict(confl, &bt_level, &asserting);
        // Glucose-style restart signal (restart.h EMA variant): fast
        // vs slow exponential averages of learnt-clause LBD
        lbd_fast_ += (last_lbd_ - lbd_fast_) / 32.0;
        lbd_slow_ += (last_lbd_ - lbd_slow_) / 4096.0;
        BacktrackTo(bt_level);
        if (bt_level < assump_level)
          placed = CountPlacedAssumptions(&assump_level);
        Enqueue(asserting, learnt_ref);
        DecayActivities();
        if (conflicts_ >= budget ||
            ((conflicts_ & 255) == 0 && out_of_time())) {
          BacktrackTo(0);
          return -1;
        }
        if (learnts_since_reduce_ > reduce_threshold_) ReduceDB();
        continue;
      }
      bool want_restart = conflicts_ >= restart_limit;
      if (restart_mode_ == 1 && !want_restart &&
          conflicts_ >= restart_limit - 64 * Luby(restart_seq) + 50 &&
          lbd_fast_ > 1.25 * lbd_slow_) {
        // glucose trigger: recent learnt quality degraded — restart
        // early (the Luby limit stays as a fallback ceiling)
        want_restart = true;
      }
      if (want_restart && Level() > assump_level) {
        restart_limit = conflicts_ + 64 * Luby(++restart_seq);
        lbd_fast_ = lbd_slow_;  // re-arm the trigger
        BacktrackTo(assump_level);
        placed = CountPlacedAssumptions(&assump_level);
        // vivification at root restarts, budgeted (mirrors cdcl.cc;
        // reference sat_inprocessing.h:160-210) — integer propagation
        // participates in the probes, so bound-literal chains shorten
        // scheduling clauses too
        if (assump_level == 0 &&
            conflicts_ - last_vivify_conflicts_ >= 4000) {
          last_vivify_conflicts_ = conflicts_;
          VivifyClauses(64, 20000);
          if (!ok_) return 0;
        }
        continue;
      }
      if (placed < assumptions_.size()) {
        u32 a = assumptions_[placed];
        MaterializeDerived(Var(a));  // bound literals: derive value first
        if (qhead_ < trail_.size()) continue;  // re-propagate it
        uint8_t val = Value(a);
        if (val == kTrue) {
          ++placed;
          assump_level = Level();
          continue;
        }
        if (val == kFalse) {
          AnalyzeFinalLit(a);
          BacktrackTo(0);
          return 0;
        }
        NewDecisionLevel();
        Enqueue(a, kNoReason);
        ++placed;
        assump_level = Level();
        continue;
      }
      u32 next = PickBranch();
      if (next == kNoLit) {
        // PickBranch may have materialized a derived literal:
        // re-propagate before integer branching / declaring SAT
        if (qhead_ < trail_.size() || !dirty_.empty() ||
            pending_confl_ != kNoReason)
          continue;
        next = PickIntBranch();
      }
      if (next == kNoLit) {
        if (qhead_ < trail_.size() || !dirty_.empty() ||
            pending_confl_ != kNoReason)
          continue;
        BuildModel();
        BacktrackTo(0);
        return 1;
      }
      NewDecisionLevel();
      Enqueue(next, kNoReason);
    }
  }

  // ---- shared clauses (reference synchronization.h:538) -----------------
  // Export descriptors are model-level: 4 i64 per literal
  // (type 0 = plain bool var / 1 = bound literal [x >= v]; var; value;
  // sign), 8 per clause (second literal type = -1 for unit facts).
  // Only literals over the SHARED model prefix (plain bools below
  // export_bool_limit_, int vars below export_int_limit_) are exported —
  // worker-private auxiliaries (e.g. a shaving worker's objective var)
  // must not leak across instances.

  void SetExportLimits(int nbools, int nints) {
    export_bool_limit_ = nbools;
    export_int_limit_ = nints;
  }

  bool DescribeLit(u32 l, i64* d) {
    int v = Var(l);
    d[3] = (l & 1u) ? 1 : 0;
    int x = v < (int)bvar_int_.size() ? bvar_int_[v] : -1;
    if (x >= 0) {
      if (x >= export_int_limit_) return false;
      d[0] = 1;
      d[1] = x;
      d[2] = bvar_bound_[v];
    } else {
      if (v >= export_bool_limit_) return false;
      d[0] = 0;
      d[1] = v;
      d[2] = 0;
    }
    return true;
  }

  void RecordShared(const std::vector<u32>& lits) {
    if (lits.empty() || lits.size() > 2) return;
    if (shared_out_.size() >= 8 * 4096) return;  // bounded buffer
    i64 d[8] = {0, 0, 0, 0, -1, 0, 0, 0};
    if (!DescribeLit(lits[0], d)) return;
    if (lits.size() == 2 && !DescribeLit(lits[1], d + 4)) return;
    shared_out_.insert(shared_out_.end(), d, d + 8);
  }

  int ExportShared(i64* out, int max_clauses) {
    int n = std::min<int>(max_clauses, (int)(shared_out_.size() / 8));
    std::memcpy(out, shared_out_.data(), (size_t)n * 8 * sizeof(i64));
    shared_out_.erase(shared_out_.begin(), shared_out_.begin() + n * 8);
    return n;
  }

  // Import clauses previously exported by a sibling built from the SAME
  // model prefix.  Must be called at level 0 (between solves).
  bool ImportShared(const i64* descs, int n_clauses) {
    if (Level() != 0) return ok_;
    for (int i = 0; i < n_clauses && ok_; ++i) {
      const i64* c = descs + 8 * i;
      tmp_clause_.clear();
      bool skip = false;
      for (int k = 0; k < 2; ++k) {
        const i64* d = c + 4 * k;
        if (d[0] < 0) break;  // unit fact
        u32 l;
        if (d[0] == 1) {
          if (d[1] < 0 || d[1] >= NumIntVars()) {
            skip = true;
            break;
          }
          l = GeLit((int)d[1], d[2]);
          if (d[3]) l = NegSent(l);
        } else {
          if (d[1] < 0 || d[1] >= NumBoolVars()) {
            skip = true;
            break;
          }
          l = MkLit((int)d[1], d[3] != 0);
        }
        if (l == kLitTrue) {
          skip = true;  // clause already satisfied by root domains
          break;
        }
        if (l == kLitFalse) continue;  // literal false at root: drop
        tmp_clause_.push_back(l);
      }
      if (skip) continue;
      ++shared_imported_;
      AddClauseInternal();
      if (PropagateAll() != kNoReason) ok_ = false;
    }
    return ok_;
  }

  i64 NumSharedImported() const { return shared_imported_; }

  void SetPhase(int v, bool positive) {
    if (v >= 0 && v < (int)phase_.size()) phase_[v] = positive ? 0 : 1;
  }
  void SetRestartMode(int m) { restart_mode_ = m; }
  uint8_t ModelValue(int v) const { return model_[v]; }
  i64 IntModelValue(int x) const { return imodel_[x]; }
  const std::vector<u32>& Core() const { return core_; }
  i64 NumConflicts() const { return conflicts_; }
  i64 NumPropagations() const { return propagations_; }
  i64 NumBoundLits() const { return num_bound_lits_; }
  bool Ok() const { return ok_; }

 private:
  // ---- boolean state ------------------------------------------------------
  std::vector<uint8_t> assign_, model_, phase_;
  std::vector<i32> level_;
  std::vector<u32> reason_;
  std::vector<double> activity_;
  std::vector<u32> trail_;
  std::vector<i32> trail_lim_;
  size_t qhead_ = 0;
  std::vector<std::vector<Watch>> watches_;
  std::vector<i32> arena_;
  std::vector<u32> clauses_, learnts_;
  std::vector<u32> assumptions_, core_;
  bool ok_ = true;
  // restart policy: 0 = Luby only, 1 = Luby ceiling + glucose LBD-EMA
  int restart_mode_ = 1;
  double lbd_fast_ = 0.0, lbd_slow_ = 0.0, last_lbd_ = 0.0;
  i64 conflicts_ = 0, propagations_ = 0;
  double var_inc_ = 1.0, cla_inc_ = 1.0;
  i64 learnts_since_reduce_ = 0, reduce_threshold_ = 2000;
  std::vector<i32> heap_, heap_pos_;
  std::vector<u32> tmp_clause_, learnt_buf_;
  std::vector<uint8_t> seen_, occurs_;
  // shared-clause machinery (see SetExportLimits/ExportShared above)
  std::vector<i64> shared_out_;
  int export_bool_limit_ = INT32_MAX;
  int export_int_limit_ = INT32_MAX;
  i64 shared_imported_ = 0;
  std::vector<i32> seen_vars_, lbd_levels_;
  u32 pending_confl_ = kNoReason;

  // ---- integer state ------------------------------------------------------
  std::vector<i64> ilb_, iub_;          // current bounds
  std::vector<i64> root_lb_, root_ub_;  // level-0 bounds at creation
  std::vector<i64> imodel_;             // last SAT values
  std::vector<i64> ihint_;              // value hints (INT64_MIN = none)
  // per int var: sorted (bound value -> bool var of [x >= v]) map as
  // parallel vectors — contiguous binary search beats a red-black tree on
  // the multi-million-lookup hot path (insertions are rare: one per
  // distinct bound value ever touched)
  struct BoundMap {
    std::vector<i64> keys;
    std::vector<i32> vars;
    int LowerBound(i64 v) const {
      return (int)(std::lower_bound(keys.begin(), keys.end(), v) -
                   keys.begin());
    }
    int Find(i64 v) const {  // -1 if absent
      int i = LowerBound(v);
      return (i < (int)keys.size() && keys[i] == v) ? i : -1;
    }
    void Insert(int pos, i64 v, i32 var) {
      keys.insert(keys.begin() + pos, v);
      vars.insert(vars.begin() + pos, var);
    }
  };
  std::vector<BoundMap> bound_lits_;
  // per bool var: which (int var, bound) it encodes; -1 if plain boolean
  std::vector<i32> bvar_int_;
  std::vector<i64> bvar_bound_;
  i64 num_bound_lits_ = 0;
  // integer-bound undo trail: (var, old bound, old setter var, is_lb)
  struct IUndo {
    i32 x;
    i64 old_bound;
    i32 old_setter;
    uint8_t is_lb;
  };
  // per int var: bool var of the literal that set the current lb/ub
  // (-1 = root bound) — O(1) explanation antecedents
  std::vector<i32> lb_setter_, ub_setter_;
  std::vector<IUndo> istack_;
  std::vector<i32> istack_lim_;
  // explanation arena: [len, lits...] blocks; truncated on backtrack
  std::vector<u32> expl_arena_;
  std::vector<i32> expl_lim_;
  // linear constraints and wake lists
  std::vector<LinCon> lincons_;
  std::vector<std::vector<i32>> iwatch_lb_, iwatch_ub_;  // per int var
  std::vector<std::vector<i32>> ewatch_;  // per bool var (enforcement)
  std::vector<i32> dirty_;
  std::vector<uint8_t> in_queue_;
  int next_int_branch_ = 0;
  std::vector<u32> tmp_expl_;

  // ---- basics --------------------------------------------------------------
  void EnsureVars(int n) {
    while ((int)assign_.size() < n) {
      assign_.push_back(kUnassigned);
      model_.push_back(kUnassigned);
      phase_.push_back(1);
      level_.push_back(0);
      reason_.push_back(kNoReason);
      activity_.push_back(0.0);
      seen_.push_back(0);
      occurs_.push_back(0);
      watches_.emplace_back();
      watches_.emplace_back();
      bvar_int_.push_back(-1);
      bvar_bound_.push_back(0);
      heap_pos_.push_back(-1);
      HeapInsert((int)assign_.size() - 1);
    }
    if ((int)ewatch_.size() < NumBoolVars()) ewatch_.resize(NumBoolVars());
  }

  uint8_t Value(u32 lit) const {
    if (lit == kLitTrue) return kTrue;
    if (lit == kLitFalse) return kFalse;
    uint8_t a = assign_[Var(lit)];
    return a == kUnassigned ? kUnassigned : (uint8_t)(a ^ (lit & 1u));
  }
  int Level() const { return (int)trail_lim_.size(); }
  void NewDecisionLevel() {
    trail_lim_.push_back((i32)trail_.size());
    istack_lim_.push_back((i32)istack_.size());
    expl_lim_.push_back((i32)expl_arena_.size());
  }

  int ClauseSize(u32 cref) const { return arena_[cref] >> 2; }
  bool ClauseLearnt(u32 cref) const { return arena_[cref] & 1; }
  bool ClauseDead(u32 cref) const { return arena_[cref] & 2; }
  float& ClauseAct(u32 cref) {
    return *reinterpret_cast<float*>(&arena_[cref + 2]);
  }
  i32& ClauseLbd(u32 cref) { return arena_[cref + 1]; }

  // Reason/conflict literal access across all storage kinds. ``pvar`` is
  // the variable the reason propagated (used to reconstruct channel
  // reasons; ignored for stored clauses/explanations).
  // ---- recursive clause minimization helpers --------------------------
  std::vector<uint8_t> min_memo_;  // 0 unknown, 1 redundant, 2 needed
  std::vector<int> min_touched_;
  std::vector<i32> min_scratch_;

  // Is var v's assignment implied by clause literals + level-0 facts?
  int RedundCheck(int v, int depth, int* budget) {
    if (level_[v] == 0) return 1;
    if (seen_[v]) return 1;  // in the learnt clause (or proven redundant)
    if (v < (int)min_memo_.size()) {
      if (min_memo_[v] == 1) return 1;
      if (min_memo_[v] == 2) return 0;
    }
    u32 r = reason_[v];
    if (r == kNoReason || depth > 96 || --(*budget) < 0) {
      if (v < (int)min_memo_.size()) {
        min_memo_[v] = 2;
        min_touched_.push_back(v);
      }
      return 0;
    }
    int size;
    const i32* lp = ReasonLits(r, v, &size);
    // copy: ReasonLits may hand out a shared scratch (channel reasons)
    std::vector<i32> local(lp, lp + size);
    for (i32 raw : local) {
      u32 l = (u32)raw;
      if (Var(l) == v) continue;
      if (!RedundCheck(Var(l), depth + 1, budget)) {
        if (v < (int)min_memo_.size()) {
          min_memo_[v] = 2;
          min_touched_.push_back(v);
        }
        return 0;
      }
    }
    if (v < (int)min_memo_.size()) {
      min_memo_[v] = 1;
      min_touched_.push_back(v);
    }
    return 1;
  }

  const i32* ReasonLits(u32 ref, int pvar, int* size) {
    if (ref & kExplBit) {
      u32 off = ref & ~kExplBit;
      *size = (int)expl_arena_[off];
      return reinterpret_cast<const i32*>(&expl_arena_[off + 1]);
    }
    if (ref & kChanBit) {
      // clause = (p ∨ antecedent_clause_lit)
      chan_scratch_[0] = (i32)MkLit(pvar, assign_[pvar]);
      chan_scratch_[1] = (i32)(ref & ~kChanBit);
      *size = 2;
      return chan_scratch_;
    }
    *size = ClauseSize(ref);
    return &arena_[ref + 3];
  }
  i32 chan_scratch_[2];

  u32 AttachNew(const std::vector<u32>& lits, bool learnt) {
    u32 cref = (u32)arena_.size();
    arena_.push_back(((i32)lits.size() << 2) | (learnt ? 1 : 0));
    arena_.push_back((i32)lits.size());
    arena_.push_back(0);
    for (u32 l : lits) {
      arena_.push_back((i32)l);
      occurs_[Var(l)] = 1;
    }
    (learnt ? learnts_ : clauses_).push_back(cref);
    watches_[Neg(lits[0])].push_back({cref, lits[1]});
    watches_[Neg(lits[1])].push_back({cref, lits[0]});
    return cref;
  }

  bool AddClauseInternal() {
    // level-0 simplification over tmp_clause_ (internal lits)
    std::sort(tmp_clause_.begin(), tmp_clause_.end());
    u32 prev = kNoLit;
    size_t out = 0;
    for (u32 l : tmp_clause_) {
      if (l == prev) continue;
      if (prev != kNoLit && l == Neg(prev)) return true;  // tautology
      uint8_t val = Value(l);
      if (val == kTrue && level_[Var(l)] == 0) return true;
      if (val == kFalse && level_[Var(l)] == 0) continue;
      tmp_clause_[out++] = l;
      prev = l;
    }
    tmp_clause_.resize(out);
    if (out == 0) return ok_ = false;
    if (out == 1) {
      Enqueue(tmp_clause_[0], kNoReason);
      if (PropagateAll() != kNoReason) return ok_ = false;
      return true;
    }
    AttachNew(tmp_clause_, /*learnt=*/false);
    return true;
  }

  void EnqueueRaw(u32 lit, u32 reason) {
    int v = Var(lit);
    assign_[v] = (uint8_t)(lit & 1u);
    level_[v] = Level();
    reason_[v] = reason;
    trail_.push_back(lit);
    if (v < (int)ewatch_.size() && !ewatch_[v].empty()) {
      for (i32 ci : ewatch_[v]) MarkDirty(ci);
    }
  }

  // Assign a literal and apply its integer-bound semantics.  The per-var
  // literal chain is maintained ONLY for literals that occur in clauses
  // (occurs_in_clause_) — clause propagation needs their formal values;
  // explanation-only literals stay unassigned until a clause learns them
  // or a decision touches them (the lazy-materialization analogue of the
  // reference IntegerTrail).  If the bound update empties the domain
  // (possible when a derived-determined literal is assigned against its
  // derived value), a conflict is recorded in pending_confl_.
  void Enqueue(u32 lit, u32 reason) {
    EnqueueRaw(lit, reason);
    int v = Var(lit);
    int x = bvar_int_[v];
    if (x < 0) return;
    i64 b = bvar_bound_[v];
    auto& m = bound_lits_[x];
    if ((lit & 1u) == 0) {  // [x >= b] true
      if (b > ilb_[x]) {
        u32 chan = kChanBit | Neg(lit);  // antecedent: this literal
        // existing clause-occurring unassigned [x >= v'] in (lb, b): true
        int i = m.LowerBound(ilb_[x] + 1);
        for (; i < (int)m.keys.size() && m.keys[i] < b; ++i) {
          int bv = m.vars[i];
          if (assign_[bv] == kUnassigned && occurs_[bv])
            EnqueueRaw(MkLit(bv, false), chan);
        }
        istack_.push_back({x, ilb_[x], lb_setter_[x], 1});
        ilb_[x] = b;
        lb_setter_[x] = v;
        if (ilb_[x] > iub_[x]) {
          RecordCrossingConflict(x);
          return;
        }
        WakeInt(x, /*lb_changed=*/true);
      }
    } else {  // [x >= b] false -> x <= b - 1
      if (b - 1 < iub_[x]) {
        u32 chan = kChanBit | Neg(lit);
        // existing clause-occurring unassigned [x >= v'] in (b, ub]: false
        int i = m.LowerBound(b + 1);
        for (; i < (int)m.keys.size() && m.keys[i] <= iub_[x]; ++i) {
          int bv = m.vars[i];
          if (assign_[bv] == kUnassigned && occurs_[bv])
            EnqueueRaw(MkLit(bv, true), chan);
        }
        istack_.push_back({x, iub_[x], ub_setter_[x], 0});
        iub_[x] = b - 1;
        ub_setter_[x] = v;
        if (ilb_[x] > iub_[x]) {
          RecordCrossingConflict(x);
          return;
        }
        WakeInt(x, /*lb_changed=*/false);
      }
    }
  }

  void RecordCrossingConflict(int x) {
    // lb > ub: the two setter literals contradict
    tmp_expl_.clear();
    u32 a = LbAntecedent(x), b = UbAntecedent(x);
    if (a != kLitTrue) tmp_expl_.push_back(Neg(a));
    if (b != kLitTrue) tmp_expl_.push_back(Neg(b));
    pending_confl_ = StoreExpl();
  }

  // A bound literal whose value is already determined by the current
  // bounds but never formally assigned (chain maintenance skips
  // explanation-only literals): assign it now so decisions/assumptions
  // see a consistent value.
  void MaterializeDerived(int v) {
    int x = bvar_int_[v];
    if (x < 0 || assign_[v] != kUnassigned) return;
    i64 b = bvar_bound_[v];
    if (b <= ilb_[x]) {
      u32 chan = kChanBit | MkLit(lb_setter_[x], true);
      EnqueueRaw(MkLit(v, false),
                 lb_setter_[x] < 0 ? kNoReason : chan);
    } else if (b > iub_[x]) {
      u32 chan = kChanBit | MkLit(ub_setter_[x], false);
      EnqueueRaw(MkLit(v, true),
                 ub_setter_[x] < 0 ? kNoReason : chan);
    }
  }

  void BacktrackTo(int lvl) {
    if (Level() <= lvl) return;
    for (size_t i = trail_.size(); i > (size_t)trail_lim_[lvl];) {
      --i;
      int v = Var(trail_[i]);
      phase_[v] = (uint8_t)(trail_[i] & 1u);
      assign_[v] = kUnassigned;
      if (heap_pos_[v] < 0) HeapInsert(v);
    }
    trail_.resize(trail_lim_[lvl]);
    trail_lim_.resize(lvl);
    for (size_t i = istack_.size(); i > (size_t)istack_lim_[lvl];) {
      --i;
      const IUndo& u = istack_[i];
      if (u.is_lb) {
        ilb_[u.x] = u.old_bound;
        lb_setter_[u.x] = u.old_setter;
      } else {
        iub_[u.x] = u.old_bound;
        ub_setter_[u.x] = u.old_setter;
      }
    }
    istack_.resize(istack_lim_[lvl]);
    istack_lim_.resize(lvl);
    expl_arena_.resize(expl_lim_[lvl]);
    expl_lim_.resize(lvl);
    qhead_ = trail_.size();
    // constraints queued above the backjump may hold stale bounds; the
    // dirty queue is conservative (re-propagation is sound), keep it.
  }

  size_t CountPlacedAssumptions(int* assump_level) {
    size_t placed = 0;
    int lvl = 0;
    for (u32 a : assumptions_) {
      if (Value(a) != kTrue) break;
      ++placed;
      lvl = std::max(lvl, level_[Var(a)]);
    }
    *assump_level = std::min(lvl, Level());
    return placed;
  }

  void BuildModel() {
    for (int v = 0; v < NumBoolVars(); ++v)
      model_[v] = assign_[v] == kUnassigned ? phase_[v] : assign_[v];
    for (int x = 0; x < NumIntVars(); ++x) imodel_[x] = ilb_[x];
  }

  // ---- lazy bound literals --------------------------------------------------
  // Literal for [x >= v], created on demand.  A literal created mid-search
  // whose value is already determined by the current bounds is assigned
  // immediately with a channel reason to the bound's setter literal.
  u32 GeLit(int x, i64 v) {
    if (v <= root_lb_[x]) return kLitTrue;
    if (v > root_ub_[x]) return kLitFalse;
    auto& m = bound_lits_[x];
    int pos = m.LowerBound(v);
    if (pos < (int)m.keys.size() && m.keys[pos] == v)
      return MkLit(m.vars[pos], false);
    int bv = NewBoolVar();
    ++num_bound_lits_;
    bvar_int_[bv] = x;
    bvar_bound_[bv] = v;
    if (ihint_[x] != INT64_MIN) phase_[bv] = ihint_[x] >= v ? 0 : 1;
    m.Insert(pos, v, bv);
    u32 L = MkLit(bv, false);
    if (v <= ilb_[x]) {
      // already implied true by the current lower bound
      u32 chan = kChanBit | MkLit(lb_setter_[x], true);
      EnqueueRaw(L, lb_setter_[x] < 0 ? kNoReason : chan);
    } else if (v > iub_[x]) {
      u32 chan = kChanBit | MkLit(ub_setter_[x], false);
      EnqueueRaw(Neg(L), ub_setter_[x] < 0 ? kNoReason : chan);
    }
    return L;
  }

  // Current-bound antecedent literals (for explanations), O(1) via the
  // setter vars: the fact "x >= ilb_[x]" as a TRUE literal (or kLitTrue).
  u32 LbAntecedent(int x) {
    return lb_setter_[x] < 0 ? kLitTrue : MkLit(lb_setter_[x], false);
  }
  // the fact "x <= iub_[x]": the (negated-ge) setter literal, TRUE now.
  u32 UbAntecedent(int x) {
    return ub_setter_[x] < 0 ? kLitTrue : MkLit(ub_setter_[x], true);
  }

  // ---- integer propagation ---------------------------------------------------
  // Direction-aware wake: a constraint is only re-propagated when a bound
  // move can actually tighten one of its sides (iwatch_lb_ = wake on lb
  // raises, iwatch_ub_ = wake on ub drops).
  void WakeInt(int x, bool lb_changed) {
    const auto& lst = lb_changed ? iwatch_lb_[x] : iwatch_ub_[x];
    for (i32 ci : lst) MarkDirty(ci);
  }
  void MarkDirty(i32 ci) {
    if (!in_queue_[ci]) {
      in_queue_[ci] = true;
      dirty_.push_back(ci);
    }
  }

  u32 TakePendingConflict() {
    u32 c = pending_confl_;
    pending_confl_ = kNoReason;
    if (c != kNoReason) {
      for (i32 ci : dirty_) in_queue_[ci] = false;
      dirty_.clear();
      qhead_ = trail_.size();
    }
    return c;
  }

  u32 PropagateAll() {
    for (;;) {
      if (pending_confl_ != kNoReason) return TakePendingConflict();
      u32 confl = Propagate();
      if (confl != kNoReason) {
        for (i32 ci : dirty_) in_queue_[ci] = false;
        dirty_.clear();
        return confl;
      }
      if (dirty_.empty()) return kNoReason;
      i32 ci = dirty_.back();
      dirty_.pop_back();
      in_queue_[ci] = false;
      confl = PropagateLinear(ci);
      if (confl != kNoReason) {
        for (i32 c2 : dirty_) in_queue_[c2] = false;
        dirty_.clear();
        return confl;
      }
    }
  }

  // Store tmp_expl_ (lits[0] = asserted literal or all-false for conflicts)
  // in the explanation arena; returns the tagged reason/conflict ref.
  u32 StoreExpl() {
    u32 off = (u32)expl_arena_.size();
    expl_arena_.push_back((u32)tmp_expl_.size());
    for (u32 l : tmp_expl_) expl_arena_.push_back(l);
    return kExplBit | off;
  }

  // Push literal L (an integer bound consequence) with the explanation in
  // tmp_expl_ (tmp_expl_[0] must be L). Returns a conflict ref or kNoReason.
  u32 PushBound(u32 L) {
    uint8_t val = Value(L);
    if (val == kTrue) return kNoReason;  // already holds
    u32 ref = StoreExpl();
    if (val == kFalse) return ref;  // explanation clause is all-false
    Enqueue(L, ref);
    ++propagations_;
    if (pending_confl_ != kNoReason) return TakePendingConflict();
    return kNoReason;
  }

  // Explanation antecedents for the minimum (or maximum) activity side of
  // constraint c, skipping variable index `skip` (-1 = none).
  void CollectActAntecedents(const LinCon& c, bool min_side, int skip) {
    for (size_t j = 0; j < c.xs.size(); ++j) {
      if ((int)j == skip) continue;
      int x = c.xs[j];
      bool use_lb = (c.cs[j] > 0) == min_side;
      u32 a = use_lb ? LbAntecedent(x) : UbAntecedent(x);
      if (a != kLitTrue) tmp_expl_.push_back(NegSent(a));
    }
  }

  u32 PropagateLinear(int ci) {
    const LinCon& c = lincons_[ci];
    // enforcement status
    int n_unassigned_enf = 0;
    u32 unassigned_enf = kNoLit;
    for (u32 e : c.enf) {
      uint8_t v = Value(e);
      if (v == kFalse) return kNoReason;  // inactive
      if (v == kUnassigned) {
        ++n_unassigned_enf;
        unassigned_enf = e;
      }
    }
    // activity bounds
    i64 min_act = 0, max_act = 0;
    for (size_t j = 0; j < c.xs.size(); ++j) {
      int x = c.xs[j];
      i64 cc = c.cs[j];
      if (cc > 0) {
        min_act = CapAdd(min_act, CapProd(cc, ilb_[x]));
        max_act = CapAdd(max_act, CapProd(cc, iub_[x]));
      } else {
        min_act = CapAdd(min_act, CapProd(cc, iub_[x]));
        max_act = CapAdd(max_act, CapProd(cc, ilb_[x]));
      }
    }
    // body infeasible from bounds -> falsify an enforcement literal /
    // conflict
    if (min_act > c.hi || max_act < c.lo) {
      bool over = min_act > c.hi;
      if (n_unassigned_enf == 0) {
        // enforced: conflict
        tmp_expl_.clear();
        for (u32 e : c.enf) tmp_expl_.push_back(Neg(e));
        CollectActAntecedents(c, /*min_side=*/over, -1);
        return StoreExpl();
      }
      if (n_unassigned_enf == 1) {
        tmp_expl_.clear();
        tmp_expl_.push_back(Neg(unassigned_enf));
        for (u32 e : c.enf)
          if (e != unassigned_enf) tmp_expl_.push_back(Neg(e));
        CollectActAntecedents(c, /*min_side=*/over, -1);
        return PushBound(Neg(unassigned_enf));
      }
      return kNoReason;  // >1 free enforcement literal: nothing unit
    }
    if (n_unassigned_enf > 0) return kNoReason;  // not (yet) enforced

    // enforced and feasible on bounds: tighten variable bounds
    if (c.hi < kInf && min_act > -kInf) {
      for (size_t j = 0; j < c.xs.size(); ++j) {
        int x = c.xs[j];
        i64 cc = c.cs[j];
        i64 contrib = cc > 0 ? CapProd(cc, ilb_[x]) : CapProd(cc, iub_[x]);
        i64 rest = CapAdd(min_act, -contrib);
        if (rest <= -kInf) continue;
        i64 room = CapAdd(c.hi, -rest);
        if (cc > 0) {
          i64 nub = FloorDiv(room, cc);
          if (nub < iub_[x]) {
            u32 L = NegSent(GeLit(x, nub + 1));  // [x <= nub]
            tmp_expl_.clear();
            tmp_expl_.push_back(L);
            for (u32 e : c.enf) tmp_expl_.push_back(Neg(e));
            CollectActAntecedents(c, /*min_side=*/true, (int)j);
            u32 confl = PushBound(L);
            if (confl != kNoReason) return confl;
          }
        } else {
          i64 nlb = CeilDiv(room, cc);
          if (nlb > ilb_[x]) {
            u32 L = GeLit(x, nlb);
            tmp_expl_.clear();
            tmp_expl_.push_back(L);
            for (u32 e : c.enf) tmp_expl_.push_back(Neg(e));
            CollectActAntecedents(c, /*min_side=*/true, (int)j);
            u32 confl = PushBound(L);
            if (confl != kNoReason) return confl;
          }
        }
      }
    }
    if (c.lo > -kInf && max_act < kInf) {
      for (size_t j = 0; j < c.xs.size(); ++j) {
        int x = c.xs[j];
        i64 cc = c.cs[j];
        i64 contrib = cc > 0 ? CapProd(cc, iub_[x]) : CapProd(cc, ilb_[x]);
        i64 rest = CapAdd(max_act, -contrib);
        if (rest >= kInf) continue;
        i64 need = CapAdd(c.lo, -rest);
        if (cc > 0) {
          i64 nlb = CeilDiv(need, cc);
          if (nlb > ilb_[x]) {
            u32 L = GeLit(x, nlb);
            tmp_expl_.clear();
            tmp_expl_.push_back(L);
            for (u32 e : c.enf) tmp_expl_.push_back(Neg(e));
            CollectActAntecedents(c, /*min_side=*/false, (int)j);
            u32 confl = PushBound(L);
            if (confl != kNoReason) return confl;
          }
        } else {
          i64 nub = FloorDiv(need, cc);
          if (nub < iub_[x]) {
            u32 L = NegSent(GeLit(x, nub + 1));
            tmp_expl_.clear();
            tmp_expl_.push_back(L);
            for (u32 e : c.enf) tmp_expl_.push_back(Neg(e));
            CollectActAntecedents(c, /*min_side=*/false, (int)j);
            u32 confl = PushBound(L);
            if (confl != kNoReason) return confl;
          }
        }
      }
    }
    return kNoReason;
  }

  // ---- boolean propagation (watched literals) --------------------------------
  u32 Propagate() {
    while (qhead_ < trail_.size()) {
      u32 p = trail_[qhead_++];
      ++propagations_;
      auto& ws = watches_[p];
      size_t keep = 0;
      for (size_t i = 0; i < ws.size(); ++i) {
        Watch w = ws[i];
        if (Value(w.blocker) == kTrue) {
          ws[keep++] = w;
          continue;
        }
        u32 cref = w.cref;
        i32* lits = &arena_[cref + 3];
        int size = ClauseSize(cref);
        u32 false_lit = Neg(p);
        if ((u32)lits[0] == false_lit) std::swap(lits[0], lits[1]);
        u32 first = (u32)lits[0];
        if (first != w.blocker && Value(first) == kTrue) {
          ws[keep++] = {cref, first};
          continue;
        }
        bool moved = false;
        for (int k = 2; k < size; ++k) {
          if (Value((u32)lits[k]) != kFalse) {
            std::swap(lits[1], lits[k]);
            watches_[Neg((u32)lits[1])].push_back({cref, first});
            moved = true;
            break;
          }
        }
        if (moved) continue;
        ws[keep++] = {cref, first};
        if (Value(first) == kFalse) {
          for (size_t j = i + 1; j < ws.size(); ++j) ws[keep++] = ws[j];
          ws.resize(keep);
          qhead_ = trail_.size();
          return cref;
        }
        Enqueue(first, cref);
        if (pending_confl_ != kNoReason) {  // bound crossing
          for (size_t j = i + 1; j < ws.size(); ++j) ws[keep++] = ws[j];
          ws.resize(keep);
          return TakePendingConflict();
        }
      }
      ws.resize(keep);
    }
    return kNoReason;
  }

  void BumpVar(int v) {
    activity_[v] += var_inc_;
    if (activity_[v] > 1e100) {
      for (auto& a : activity_) a *= 1e-100;
      var_inc_ *= 1e-100;
    }
    if (heap_pos_[v] >= 0) HeapUp(heap_pos_[v]);
  }
  void BumpClause(u32 cref) {
    float& a = ClauseAct(cref);
    a += (float)cla_inc_;
    if (a > 1e20f) {
      for (u32 c : learnts_)
        if (!ClauseDead(c)) ClauseAct(c) *= 1e-20f;
      cla_inc_ *= 1e-20;
    }
  }
  void DecayActivities() {
    var_inc_ /= 0.95;
    cla_inc_ /= 0.999;
  }

  void MarkSeen(int v) {
    if (!seen_[v]) {
      seen_[v] = 1;
      seen_vars_.push_back(v);
    }
  }
  void ClearSeen() {
    for (i32 v : seen_vars_) seen_[v] = 0;
    seen_vars_.clear();
  }

  // 1UIP learning over the unified trail; reasons may live in the clause
  // arena or the explanation arena (ReasonLits dispatches).
  u32 AnalyzeConflict(u32 confl, int* bt_level, u32* asserting) {
    learnt_buf_.clear();
    learnt_buf_.push_back(0);
    int counter = 0;
    u32 p = kNoLit;
    size_t idx = trail_.size();
    int cur_level = Level();
    do {
      int size;
      const i32* lits =
          ReasonLits(confl, p == kNoLit ? -1 : (int)Var(p), &size);
      if (!(confl & (kExplBit | kChanBit)) && ClauseLearnt(confl))
        BumpClause(confl);
      int start = (p == kNoLit) ? 0 : 1;
      for (int k = start; k < size; ++k) {
        u32 q = (u32)lits[k];
        int v = Var(q);
        if (!seen_[v] && level_[v] > 0) {
          MarkSeen(v);
          BumpVar(v);
          if (level_[v] >= cur_level) {
            ++counter;
          } else {
            learnt_buf_.push_back(q);
          }
        }
      }
      while (!seen_[Var(trail_[--idx])]) {
      }
      p = trail_[idx];
      confl = reason_[Var(p)];
      --counter;
    } while (counter > 0);
    learnt_buf_[0] = Neg(p);

    // recursive minimization (ccmin-2; reference sat_solver.h:658-663
    // minimization variants): a literal is redundant when every
    // antecedent in its reason DAG is in the clause or at level 0 —
    // the DAG walk memoizes per variable and carries a budget.  The
    // shallow one-step rule this replaces left ~10-30% removable
    // literals in jobshop conflicts.
    for (int v : min_touched_) min_memo_[v] = 0;
    min_touched_.clear();
    if (min_memo_.size() < (size_t)NumBoolVars())
      min_memo_.resize(NumBoolVars(), 0);
    int min_budget = 2000;
    size_t out = 1;
    for (size_t i = 1; i < learnt_buf_.size(); ++i) {
      u32 q = learnt_buf_[i];
      u32 r = reason_[Var(q)];
      bool redundant = false;
      if (r != kNoReason) {
        redundant = true;
        int size;
        const i32* lits = ReasonLits(r, (int)Var(q), &size);
        min_scratch_.assign(lits, lits + size);
        for (i32 raw : min_scratch_) {
          u32 l = (u32)raw;
          if (Var(l) == (int)Var(q)) continue;
          if (!RedundCheck(Var(l), 0, &min_budget)) {
            redundant = false;
            break;
          }
        }
      }
      if (!redundant) learnt_buf_[out++] = q;
    }
    learnt_buf_.resize(out);
    ClearSeen();

    *asserting = learnt_buf_[0];
    // short learnt clauses are worth exporting to sibling workers
    // (reference SharedClausesManager, synchronization.h:538 — binary
    // clauses + unit facts cross workers at synchronization points)
    if (learnt_buf_.size() <= 2) RecordShared(learnt_buf_);
    if (learnt_buf_.size() == 1) {
      *bt_level = 0;
      return kNoReason;
    }
    size_t max_i = 1;
    for (size_t i = 2; i < learnt_buf_.size(); ++i)
      if (level_[Var(learnt_buf_[i])] > level_[Var(learnt_buf_[max_i])])
        max_i = i;
    std::swap(learnt_buf_[1], learnt_buf_[max_i]);
    *bt_level = level_[Var(learnt_buf_[1])];

    u32 cref = AttachNew(learnt_buf_, /*learnt=*/true);
    lbd_levels_.clear();
    for (u32 l : learnt_buf_) lbd_levels_.push_back(level_[Var(l)]);
    std::sort(lbd_levels_.begin(), lbd_levels_.end());
    last_lbd_ = (double)(int)(std::unique(lbd_levels_.begin(),
                                          lbd_levels_.end()) -
                              lbd_levels_.begin());
    ClauseLbd(cref) =
        (i32)(std::unique(lbd_levels_.begin(), lbd_levels_.end()) -
              lbd_levels_.begin());
    BumpClause(cref);
    ++learnts_since_reduce_;
    return cref;
  }

  void AnalyzeFinalLit(u32 a) {
    core_.clear();
    core_.push_back(a);
    int v0 = Var(a);
    if (level_[v0] == 0) return;
    MarkSeen(v0);
    for (size_t i = trail_.size(); i > 0;) {
      --i;
      int v = Var(trail_[i]);
      if (!seen_[v]) continue;
      if (reason_[v] == kNoReason) {
        if (level_[v] > 0 && trail_[i] != a) core_.push_back(trail_[i]);
      } else {
        int rs;
        const i32* rl = ReasonLits(reason_[v], v, &rs);
        for (int k = 0; k < rs; ++k) {
          int rv = Var((u32)rl[k]);
          if (rv != v && level_[rv] > 0) MarkSeen(rv);
        }
      }
    }
    ClearSeen();
  }

  // Clause vivification (scan-then-apply; see _native/cdcl.cc for the
  // derivation notes — rewriting mid-scan corrupts the very propagation
  // the pass relies on).  No proof log here (the LCG core has none);
  // soundness rests on propagation soundness plus the shorter-implies-
  // longer replacement argument.
  size_t vivify_cursor_ = 0;
  i64 vivified_ = 0;
  i64 last_vivify_conflicts_ = 0;

  void VivifyClauses(int max_clauses, i64 prop_budget) {
    if (Level() != 0 || !ok_) return;
    i64 props0 = propagations_;
    int done = 0;
    size_t scanned = 0;
    const size_t n0 = learnts_.size();
    std::vector<u32> lits, kept;
    struct Pending {
      u32 cref;
      std::vector<u32> kept;
    };
    std::vector<Pending> pending;
    std::vector<u32> seen_crefs;
    while (scanned < n0 && done < max_clauses &&
           propagations_ - props0 < prop_budget) {
      ++scanned;
      if (learnts_.empty()) break;
      if (vivify_cursor_ >= learnts_.size()) vivify_cursor_ = 0;
      u32 cref = learnts_[vivify_cursor_++];
      if (ClauseDead(cref) || IsReason(cref)) continue;
      bool dup = false;
      for (u32 c0 : seen_crefs)
        if (c0 == cref) dup = true;
      if (dup) continue;
      int sz = ClauseSize(cref);
      if (sz < 3 || sz > 64) continue;
      if (ClauseLbd(cref) < 3 || ClauseLbd(cref) > 20) continue;
      lits.assign((u32*)&arena_[cref + 3], (u32*)&arena_[cref + 3] + sz);
      bool rooted = false;
      for (u32 l : lits)
        if (Value(l) != kUnassigned) rooted = true;
      if (rooted) continue;
      ++done;
      seen_crefs.push_back(cref);
      kept.clear();
      NewDecisionLevel();
      bool aborted = false;
      for (u32 l : lits) {
        uint8_t v = Value(l);
        if (v == kTrue) {
          kept.push_back(l);
          break;
        }
        if (v == kFalse) continue;
        kept.push_back(l);
        Enqueue(Neg(l), kNoReason);
        u32 c2 = PropagateAll();
        if (c2 != kNoReason) break;
        if (pending_confl_ != kNoReason) {  // integer-side conflict
          aborted = true;
          break;
        }
      }
      BacktrackTo(0);
      pending_confl_ = kNoReason;
      for (i32 ci : dirty_) in_queue_[ci] = false;
      dirty_.clear();
      if (aborted || kept.empty() || kept.size() >= lits.size())
        continue;
      pending.push_back({cref, kept});
    }
    if (pending.empty()) return;
    std::vector<u32> new_units;
    for (auto& pd : pending) {
      u32 cref = pd.cref;
      if (ClauseDead(cref) || IsReason(cref)) continue;
      i32* dst = &arena_[cref + 3];
      for (size_t k = 0; k < pd.kept.size(); ++k)
        dst[k] = (i32)pd.kept[k];
      arena_[cref] = ((i32)pd.kept.size() << 2) | (arena_[cref] & 3);
      ++vivified_;
      if (pd.kept.size() == 1) {
        new_units.push_back(pd.kept[0]);
        arena_[cref] |= 2;
      }
    }
    RebuildWatchesAndLists();
    for (u32 u : new_units) {
      if (Value(u) == kFalse) {
        ok_ = false;
        return;
      }
      if (Value(u) == kUnassigned) Enqueue(u, kNoReason);
    }
    if (PropagateAll() != kNoReason || pending_confl_ != kNoReason) {
      ok_ = false;
      return;
    }
  }

  void ReduceDB() {
    learnts_since_reduce_ = 0;
    reduce_threshold_ += 500;
    std::vector<u32> sorted = learnts_;
    std::sort(sorted.begin(), sorted.end(), [this](u32 a, u32 b) {
      if (ClauseLbd(a) != ClauseLbd(b)) return ClauseLbd(a) < ClauseLbd(b);
      return ClauseAct(a) > ClauseAct(b);
    });
    for (size_t i = sorted.size() / 2; i < sorted.size(); ++i) {
      u32 cref = sorted[i];
      if (ClauseLbd(cref) <= 2) continue;
      if (IsReason(cref)) continue;
      arena_[cref] |= 2;
    }
    RebuildWatchesAndLists();
  }

  bool IsReason(u32 cref) const {
    u32 first = (u32)arena_[cref + 3];
    int v = Var(first);
    return assign_[v] != kUnassigned && reason_[v] == cref;
  }

  void RebuildWatchesAndLists() {
    for (auto& ws : watches_) ws.clear();
    auto relink = [this](std::vector<u32>& list) {
      size_t out = 0;
      for (u32 cref : list) {
        if (ClauseDead(cref)) continue;
        list[out++] = cref;
        i32* lits = &arena_[cref + 3];
        watches_[Neg((u32)lits[0])].push_back({cref, (u32)lits[1]});
        watches_[Neg((u32)lits[1])].push_back({cref, (u32)lits[0]});
      }
      list.resize(out);
    };
    relink(clauses_);
    relink(learnts_);
  }

  // ---- decisions ---------------------------------------------------------
  void HeapInsert(int v) {
    heap_pos_[v] = (i32)heap_.size();
    heap_.push_back(v);
    HeapUp(heap_pos_[v]);
  }
  void HeapUp(int i) {
    int v = heap_[i];
    while (i > 0) {
      int p = (i - 1) >> 1;
      if (activity_[heap_[p]] >= activity_[v]) break;
      heap_[i] = heap_[p];
      heap_pos_[heap_[i]] = i;
      i = p;
    }
    heap_[i] = v;
    heap_pos_[v] = i;
  }
  void HeapDown(int i) {
    int v = heap_[i];
    int n = (int)heap_.size();
    for (;;) {
      int c = 2 * i + 1;
      if (c >= n) break;
      if (c + 1 < n && activity_[heap_[c + 1]] > activity_[heap_[c]]) ++c;
      if (activity_[heap_[c]] <= activity_[v]) break;
      heap_[i] = heap_[c];
      heap_pos_[heap_[i]] = i;
      i = c;
    }
    heap_[i] = v;
    heap_pos_[v] = i;
  }
  int HeapPopMax() {
    int v = heap_[0];
    heap_pos_[v] = -1;
    heap_[0] = heap_.back();
    heap_.pop_back();
    if (!heap_.empty()) {
      heap_pos_[heap_[0]] = 0;
      HeapDown(0);
    }
    return v;
  }
  u32 PickBranch() {
    while (!heap_.empty()) {
      int v = HeapPopMax();
      if (assign_[v] != kUnassigned) continue;
      int x = bvar_int_[v];
      if (x >= 0) {
        i64 b = bvar_bound_[v];
        if (b <= ilb_[x] || b > iub_[x]) {
          // derived-determined: assign instead of deciding, re-propagate
          MaterializeDerived(v);
          return kNoLit;
        }
      }
      return MkLit(v, phase_[v]);
    }
    return kNoLit;
  }
  // Integer fallback branching: fix the first unfixed integer variable to
  // its lower bound (decision literal ¬[x >= lb+1], i.e. x <= lb).
  u32 PickIntBranch() {
    int n = NumIntVars();
    for (int k = 0; k < n; ++k) {
      int x = (next_int_branch_ + k) % n;
      if (ilb_[x] < iub_[x]) {
        next_int_branch_ = x;
        u32 L = NegSent(GeLit(x, ilb_[x] + 1));
        if (L == kLitTrue || L == kLitFalse) continue;  // degenerate
        if (Value(L) == kUnassigned) return L;
        // creation force-enqueued this literal: let the caller re-propagate
        return kNoLit;
      }
    }
    return kNoLit;
  }

  static i64 Luby(int x) {
    int size = 1, seq = 0;
    while (size < x + 1) {
      ++seq;
      size = 2 * size + 1;
    }
    while (size - 1 != x) {
      size = (size - 1) >> 1;
      --seq;
      x = x % size;
    }
    return (i64)1 << seq;
  }
};

}  // namespace

extern "C" {

void* lcg_new() { return new Solver(); }
void lcg_free(void* s) { delete static_cast<Solver*>(s); }
i32 lcg_new_bool(void* s) { return static_cast<Solver*>(s)->NewBoolVar(); }
i32 lcg_new_int(void* s, i64 lb, i64 ub) {
  return static_cast<Solver*>(s)->NewIntVar(lb, ub);
}
i32 lcg_num_bools(void* s) {
  return static_cast<Solver*>(s)->NumBoolVars();
}
i32 lcg_add_clause(void* s, const i32* lits, i32 n) {
  return static_cast<Solver*>(s)->AddClauseExt(lits, n) ? 0 : -1;
}
i32 lcg_add_linear(void* s, const i32* enf, i32 n_enf, const i32* xs,
                   const i64* cs, i32 n, i64 lo, i64 hi) {
  return static_cast<Solver*>(s)->AddLinear(enf, n_enf, xs, cs, n, lo, hi)
             ? 0
             : -1;
}
i32 lcg_ge_literal(void* s, i32 x, i64 v) {
  return static_cast<Solver*>(s)->GeLiteralExt(x, v);
}
i32 lcg_solve(void* s, const i32* assumptions, i32 n, i64 conflict_budget,
              double time_budget_s) {
  return static_cast<Solver*>(s)->Solve(assumptions, n, conflict_budget,
                                        time_budget_s);
}
i64 lcg_int_value(void* s, i32 x) {
  return static_cast<Solver*>(s)->IntModelValue(x);
}
i32 lcg_bool_value(void* s, i32 v) {
  return static_cast<Solver*>(s)->ModelValue(v) == 0 ? 1 : 0;
}
i32 lcg_get_core(void* s, i32* out) {
  const auto& core = static_cast<Solver*>(s)->Core();
  for (size_t i = 0; i < core.size(); ++i) {
    u32 l = core[i];
    out[i] = (l & 1u) ? -(i32)((l >> 1) + 1) : (i32)((l >> 1) + 1);
  }
  return (i32)core.size();
}
void lcg_set_int_hint(void* s, i32 x, i64 value) {
  static_cast<Solver*>(s)->SetIntHint(x, value);
}
void lcg_set_phases(void* s, const int8_t* vals, i32 n) {
  Solver* sol = static_cast<Solver*>(s);
  i32 cap = sol->NumBoolVars() < n ? sol->NumBoolVars() : n;
  for (i32 v = 0; v < cap; ++v)
    if (vals[v] >= 0) sol->SetPhase(v, vals[v] != 0);
}
i64 lcg_num_conflicts(void* s) {
  return static_cast<Solver*>(s)->NumConflicts();
}
i64 lcg_num_propagations(void* s) {
  return static_cast<Solver*>(s)->NumPropagations();
}
i64 lcg_num_bound_literals(void* s) {
  return static_cast<Solver*>(s)->NumBoundLits();
}

void lcg_set_restart_mode(void* s, i32 m) {
  static_cast<Solver*>(s)->SetRestartMode(m);
}
i32 lcg_num_ints(void* s) {
  return static_cast<Solver*>(s)->NumIntVars();
}

// ---- shared clauses (reference SharedClausesManager) ----
void lcg_set_export_limits(void* s, i32 nbools, i32 nints) {
  static_cast<Solver*>(s)->SetExportLimits(nbools, nints);
}
i32 lcg_export_shared(void* s, i64* out, i32 max_clauses) {
  return static_cast<Solver*>(s)->ExportShared(out, max_clauses);
}
i32 lcg_import_shared(void* s, const i64* descs, i32 n_clauses) {
  return static_cast<Solver*>(s)->ImportShared(descs, n_clauses) ? 0 : 1;
}
i64 lcg_num_shared_imported(void* s) {
  return static_cast<Solver*>(s)->NumSharedImported();
}

}  // extern "C"
