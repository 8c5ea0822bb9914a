// Native CDCL SAT core.
//
// Capability parity: ortools/sat CDCL engine — SatSolver
// (sat/sat_solver.h:63, SolveInternal sat_solver.cc:1240), watched-literal
// propagation (sat/clause.h:164), 1UIP conflict analysis with minimization
// (sat/sat_solver.h:631-663), VSIDS + phase saving (sat/sat_decision.h:37),
// Luby restarts (sat/restart.h:32), LBD-based clause deletion.  Original
// implementation on the classic CDCL design (arena clause storage,
// blocker-augmented watch lists); exposed through a C ABI consumed via
// ctypes from ortools_tpu.sat.cdcl.
//
// Conventions: external literals are DIMACS-style +-(var+1); internal
// literals are 2*var + (1 if negative).  Assumptions and conflict budgets
// make the solver usable incrementally (clauses may be added between
// solve() calls; the solver is always at level zero between calls).

#include <algorithm>
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

inline int Var(u32 lit) { return (int)(lit >> 1); }
inline u32 Neg(u32 lit) { return lit ^ 1u; }
inline u32 MkLit(int var, bool neg) { return ((u32)var << 1) | (u32)neg; }

// value encoding: 0 = true, 1 = false, 2 = unassigned; Value(lit) flips
// with the literal sign so Value(l)==kTrue means l holds.
constexpr uint8_t kTrue = 0, kFalse = 1, kUnassigned = 2;

struct Watch {
  u32 cref;
  u32 blocker;
};

class Solver {
 public:
  explicit Solver(int nvars) { EnsureVars(nvars); }

  int NewVar() {
    EnsureVars((int)assign_.size() + 1);
    return (int)assign_.size() - 1;
  }

  int NumVars() const { return (int)assign_.size(); }

  // Returns false if the solver is UNSAT at level zero after the add.
  bool AddClause(const i32* ext, int n) {
    if (!ok_) return false;
    tmp_clause_.clear();
    for (int i = 0; i < n; ++i) {
      int v = std::abs(ext[i]) - 1;
      if (v >= NumVars()) EnsureVars(v + 1);
      tmp_clause_.push_back(MkLit(v, ext[i] < 0));
    }
    // level-0 simplification: duplicates, tautologies, fixed literals
    std::sort(tmp_clause_.begin(), tmp_clause_.end());
    u32 prev = kNoLit;
    size_t out = 0;
    for (u32 l : tmp_clause_) {
      if (l == prev) continue;
      if (prev != kNoLit && l == Neg(prev)) return true;  // tautology
      uint8_t val = Value(l);
      if (val == kTrue) return true;      // satisfied at level 0
      if (val == kFalse) continue;        // false at level 0: drop
      tmp_clause_[out++] = l;
      prev = l;
    }
    tmp_clause_.resize(out);
    if (out == 0) return ok_ = false;
    if (out == 1) {
      Enqueue(tmp_clause_[0], kNoReason);
      if (Propagate() != kNoReason) return ok_ = false;
      return true;
    }
    AttachNew(tmp_clause_, /*learnt=*/false);
    return true;
  }

  // 1 = SAT, 0 = UNSAT (core_ = failed assumptions), -1 = budget.
  int Solve(const i32* assump, int n_assump, i64 conflict_budget) {
    core_.clear();
    if (!ok_) return 0;
    assumptions_.clear();
    for (int i = 0; i < n_assump; ++i) {
      int v = std::abs(assump[i]) - 1;
      if (v >= NumVars()) EnsureVars(v + 1);
      assumptions_.push_back(MkLit(v, assump[i] < 0));
    }
    i64 budget = conflict_budget <= 0 ? INT64_MAX
                                      : conflicts_ + conflict_budget;
    int restart_seq = 1;
    i64 restart_limit = conflicts_ + 64 * Luby(restart_seq);
    size_t placed = 0;  // assumptions placed so far
    int assump_level = 0;  // level after the last placed assumption
    BacktrackTo(0);

    for (;;) {
      u32 confl = Propagate();
      if (confl != kNoReason) {
        ++conflicts_;
        if (Level() == 0) {
          ok_ = false;
          if (proof_enabled_) proof_.push_back(0);  // empty clause
          return 0;
        }
        int bt_level;
        u32 asserting;
        u32 learnt_ref = AnalyzeConflict(confl, &bt_level, &asserting);
        BacktrackTo(bt_level);
        if (bt_level < assump_level) {
          placed = CountPlacedAssumptions(&assump_level);
        }
        Enqueue(asserting, learnt_ref);
        DecayActivities();
        if (conflicts_ >= budget) {
          BacktrackTo(0);
          return -1;
        }
        if (learnts_since_reduce_ > reduce_threshold_) ReduceDB();
        continue;
      }
      if (conflicts_ >= restart_limit && Level() > assump_level) {
        restart_limit = conflicts_ + 64 * Luby(++restart_seq);
        BacktrackTo(assump_level);
        placed = CountPlacedAssumptions(&assump_level);
        // inprocessing: new root facts since the last pass let clauses
        // shrink mid-search (reference sat_inprocessing.cc role)
        if (assump_level == 0 &&
            (i32)trail_.size() > root_simplified_trail_) {
          InprocessRootSimplify();
          if (!ok_) return 0;
        }
        // vivification + deferred on-the-fly-subsumption deletions:
        // budgeted batch each root restart (sat_inprocessing.h:160-210)
        if (assump_level == 0 && inprocess_enabled_ &&
            conflicts_ - last_vivify_conflicts_ >= 4000) {
          last_vivify_conflicts_ = conflicts_;
          FlushOtfSubsumed();
          VivifyClauses(/*max_clauses=*/64, /*prop_budget=*/20000);
          if (!ok_) return 0;
        }
        continue;
      }
      if (placed < assumptions_.size()) {
        u32 a = assumptions_[placed];
        uint8_t val = Value(a);
        if (val == kTrue) {
          ++placed;
          assump_level = Level();
          continue;
        }
        if (val == kFalse) {
          // assumption contradicted by the others / level-0 facts
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
        BuildModel();
        BacktrackTo(0);
        return 1;
      }
      NewDecisionLevel();
      Enqueue(next, kNoReason);
    }
  }

  void EnableProof() { proof_enabled_ = true; }
  void SetInprocessing(bool on) { inprocess_enabled_ = on; }
  i64 NumVivified() const { return vivified_; }
  i64 NumOtfSubsumed() const { return otf_subsumed_; }

  // Seed the saved phase of a variable (hint-guided value ordering;
  // reference sat/sat_decision.h SetAssignmentPreference).  phase_
  // stores 1 = pick the negative literal at a decision.
  void SetPhase(int v, bool positive) {
    if (v >= 0 && v < (int)phase_.size()) phase_[v] = positive ? 0 : 1;
  }
  const std::vector<i32>& Proof() const { return proof_; }

  uint8_t ModelValue(int v) const { return model_[v]; }
  const std::vector<u32>& Core() const { return core_; }
  i64 NumConflicts() const { return conflicts_; }
  i64 NumPropagations() const { return propagations_; }
  bool Ok() const { return ok_; }

 private:
  // ---- state -------------------------------------------------------------
  std::vector<uint8_t> assign_;   // per var
  std::vector<uint8_t> model_;    // last SAT assignment
  std::vector<uint8_t> phase_;    // saved phase (1 = negative)
  std::vector<i32> level_;
  std::vector<u32> reason_;
  std::vector<double> activity_;
  std::vector<u32> trail_;
  std::vector<i32> trail_lim_;
  size_t qhead_ = 0;
  std::vector<std::vector<Watch>> watches_;  // per literal
  std::vector<i32> arena_;  // [size<<2|flags, lbd, act(bits), lits...]
  std::vector<u32> clauses_;
  std::vector<u32> learnts_;
  std::vector<u32> assumptions_;
  std::vector<u32> core_;
  bool ok_ = true;
  bool inprocess_enabled_ = true;
  i64 conflicts_ = 0;
  i64 propagations_ = 0;
  double var_inc_ = 1.0;
  double cla_inc_ = 1.0;
  i64 learnts_since_reduce_ = 0;
  i32 root_simplified_trail_ = 0;  // trail size at the last inprocessing
  i64 reduce_threshold_ = 2000;
  // binary max-heap on activity
  std::vector<i32> heap_;
  std::vector<i32> heap_pos_;
  // scratch
  std::vector<u32> tmp_clause_;
  std::vector<u32> learnt_buf_;
  std::vector<uint8_t> seen_;
  std::vector<i32> seen_vars_;
  std::vector<i32> lbd_levels_;

  // ---- basics ------------------------------------------------------------
  void EnsureVars(int n) {
    while ((int)assign_.size() < n) {
      assign_.push_back(kUnassigned);
      model_.push_back(kUnassigned);
      phase_.push_back(1);
      level_.push_back(0);
      reason_.push_back(kNoReason);
      activity_.push_back(0.0);
      seen_.push_back(0);
      watches_.emplace_back();
      watches_.emplace_back();
      heap_pos_.push_back(-1);
      HeapInsert((int)assign_.size() - 1);
    }
  }

  uint8_t Value(u32 lit) const {
    uint8_t a = assign_[Var(lit)];
    return a == kUnassigned ? kUnassigned : (uint8_t)(a ^ (lit & 1u));
  }
  int Level() const { return (int)trail_lim_.size(); }
  void NewDecisionLevel() { trail_lim_.push_back((i32)trail_.size()); }

  int ClauseSize(u32 cref) const { return arena_[cref] >> 2; }
  bool ClauseLearnt(u32 cref) const { return arena_[cref] & 1; }
  bool ClauseDead(u32 cref) const { return arena_[cref] & 2; }
  float& ClauseAct(u32 cref) {
    return *reinterpret_cast<float*>(&arena_[cref + 2]);
  }
  i32& ClauseLbd(u32 cref) { return arena_[cref + 1]; }

  u32 AttachNew(const std::vector<u32>& lits, bool learnt) {
    u32 cref = (u32)arena_.size();
    arena_.push_back(((i32)lits.size() << 2) | (learnt ? 1 : 0));
    arena_.push_back((i32)lits.size());  // lbd init
    arena_.push_back(0);                 // activity bits (0.0f)
    for (u32 l : lits) arena_.push_back((i32)l);
    (learnt ? learnts_ : clauses_).push_back(cref);
    watches_[Neg(lits[0])].push_back({cref, lits[1]});
    watches_[Neg(lits[1])].push_back({cref, lits[0]});
    return cref;
  }

  void Enqueue(u32 lit, u32 reason) {
    int v = Var(lit);
    assign_[v] = (uint8_t)(lit & 1u);
    level_[v] = Level();
    reason_[v] = reason;
    trail_.push_back(lit);
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
    qhead_ = trail_.size();
  }

  // After a backjump below the assumption levels: how many assumptions are
  // still in force (true), and the level of the last one.
  size_t CountPlacedAssumptions(int* assump_level) {
    size_t placed = 0;
    int lvl = 0;
    for (u32 a : assumptions_) {
      if (Value(a) != kTrue) break;
      ++placed;
      lvl = std::max(lvl, level_[Var(a)]);
    }
    // only levels at-or-below the current level count
    *assump_level = std::min(lvl, Level());
    return placed;
  }

  void BuildModel() {
    for (int v = 0; v < NumVars(); ++v) {
      model_[v] = assign_[v] == kUnassigned ? phase_[v] : assign_[v];
    }
  }

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
        if (Value(first) == kFalse) {  // conflict
          for (size_t j = i + 1; j < ws.size(); ++j) ws[keep++] = ws[j];
          ws.resize(keep);
          qhead_ = trail_.size();
          return cref;
        }
        Enqueue(first, cref);
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

  // 1UIP learning.  Returns the cref of the learnt clause (kNoReason for a
  // unit learnt) and the asserting literal; caller backtracks to *bt_level
  // and enqueues the asserting literal with the returned reason.
  u32 AnalyzeConflict(u32 confl, int* bt_level, u32* asserting) {
    const u32 confl0 = confl;
    learnt_buf_.clear();
    learnt_buf_.push_back(0);  // slot 0: asserting literal
    int counter = 0;
    u32 p = kNoLit;
    size_t idx = trail_.size();
    int cur_level = Level();
    do {
      i32* lits = &arena_[confl + 3];
      int size = ClauseSize(confl);
      if (ClauseLearnt(confl)) BumpClause(confl);
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

    // local minimization: drop a literal whose reason is subsumed by the
    // remaining clause (reference: minimization variants
    // sat/sat_solver.h:658-663; this is the "simple" one)
    size_t out = 1;
    for (size_t i = 1; i < learnt_buf_.size(); ++i) {
      u32 q = learnt_buf_[i];
      u32 r = reason_[Var(q)];
      bool redundant = false;
      if (r != kNoReason) {
        redundant = true;
        i32* lits = &arena_[r + 3];
        int size = ClauseSize(r);
        for (int k = 0; k < size; ++k) {
          u32 l = (u32)lits[k];
          if (Var(l) == Var(q)) continue;
          if (!seen_[Var(l)] && level_[Var(l)] > 0) {
            redundant = false;
            break;
          }
        }
      }
      if (!redundant) learnt_buf_[out++] = q;
    }
    learnt_buf_.resize(out);
    ClearSeen();
    if (proof_enabled_) RecordProof(learnt_buf_, /*deletion=*/false);

    *asserting = learnt_buf_[0];
    if (learnt_buf_.size() == 1) {
      *bt_level = 0;
      return kNoReason;
    }
    // backtrack level = second-highest level in the clause
    size_t max_i = 1;
    for (size_t i = 2; i < learnt_buf_.size(); ++i)
      if (level_[Var(learnt_buf_[i])] > level_[Var(learnt_buf_[max_i])])
        max_i = i;
    std::swap(learnt_buf_[1], learnt_buf_[max_i]);
    *bt_level = level_[Var(learnt_buf_[1])];

    // on-the-fly subsumption (reference sat_inprocessing.cc role): when
    // the fresh learnt clause's literals are a subset of the clause it
    // refuted, the longer original is redundant.  Deletion is DEFERRED
    // to the next root-restart rebuild (a clause may not vanish while
    // watches/reasons can still reference it mid-search).
    if (ClauseLearnt(confl0) && !ClauseDead(confl0) &&
        (int)learnt_buf_.size() < ClauseSize(confl0) &&
        learnt_buf_.size() >= 2) {
      bool subsumed = true;
      const i32* cl0 = &arena_[confl0 + 3];
      const int cs0 = ClauseSize(confl0);
      for (u32 l : learnt_buf_) {
        bool found = false;
        for (int k = 0; k < cs0; ++k)
          if ((u32)cl0[k] == l) {
            found = true;
            break;
          }
        if (!found) {
          subsumed = false;
          break;
        }
      }
      if (subsumed) otf_pending_.push_back(confl0);
    }

    u32 cref = AttachNew(learnt_buf_, /*learnt=*/true);
    lbd_levels_.clear();
    for (u32 l : learnt_buf_) lbd_levels_.push_back(level_[Var(l)]);
    std::sort(lbd_levels_.begin(), lbd_levels_.end());
    ClauseLbd(cref) = (i32)(std::unique(lbd_levels_.begin(),
                                        lbd_levels_.end()) -
                            lbd_levels_.begin());
    BumpClause(cref);
    ++learnts_since_reduce_;
    return cref;
  }

  // The failed-assumption core when assumption `a` is found false: walk
  // the implication graph from ~a back to assumption decisions.
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
        // a decision here is an assumption (conflicts during search
        // proper never reach this routine); ~a itself can be one when
        // the assumption list contains both polarities of a variable
        if (level_[v] > 0 && trail_[i] != a) core_.push_back(trail_[i]);
      } else {
        i32* rl = &arena_[reason_[v] + 3];
        int rs = ClauseSize(reason_[v]);
        for (int k = 0; k < rs; ++k) {
          int rv = Var((u32)rl[k]);
          if (rv != v && level_[rv] > 0) MarkSeen(rv);
        }
      }
    }
    ClearSeen();
  }

  // ---- clause DB reduction ----------------------------------------------
  // Mid-search inprocessing (reference sat/sat_inprocessing.cc role,
  // scoped to level-0 fact simplification): at a restart that lands on
  // the root level, delete clauses satisfied by a root fact and strip
  // root-falsified literals in place (DRAT: add the strengthened clause,
  // then delete the original).  Shrinking to a unit enqueues a new root
  // fact, which the next Propagate() extends to fixpoint.
  void InprocessRootSimplify() {
    if (Level() != 0 || !ok_) return;
    auto clean = [this](std::vector<u32>& list) {
      for (u32 cref : list) {
        if (ClauseDead(cref) || IsReason(cref)) continue;
        i32* lits = &arena_[cref + 3];
        int sz = ClauseSize(cref);
        bool sat = false;
        int n_false = 0;
        for (int k = 0; k < sz; ++k) {
          uint8_t v = Value((u32)lits[k]);
          if (v == kTrue) {
            sat = true;
            break;
          }
          if (v == kFalse) ++n_false;
        }
        if (sat) {
          arena_[cref] |= 2;  // dead: satisfied forever by a root fact
          if (proof_enabled_) {
            proof_buf_.clear();
            for (int k = 0; k < sz; ++k) proof_buf_.push_back((u32)lits[k]);
            RecordProof(proof_buf_, /*deletion=*/true);
          }
          continue;
        }
        if (n_false == 0) continue;
        std::vector<u32> old_lits(lits, lits + sz);
        int out = 0;
        for (int k = 0; k < sz; ++k)
          if (Value((u32)lits[k]) != kFalse) lits[out++] = lits[k];
        if (out == 0) {  // fully falsified at root: UNSAT
          ok_ = false;
          if (proof_enabled_) proof_.push_back(0);
          return;
        }
        // shrink header size, keep learnt/activity bits
        arena_[cref] = (out << 2) | (arena_[cref] & 3);
        if (proof_enabled_) {
          proof_buf_.assign(lits, lits + out);
          RecordProof(proof_buf_, /*deletion=*/false);
          RecordProof(old_lits, /*deletion=*/true);
        }
        if (out == 1) {
          if (Value((u32)lits[0]) == kUnassigned)
            Enqueue((u32)lits[0], kNoReason);
          arena_[cref] |= 2;  // dead: the fact lives on the trail now
        }
      }
    };
    clean(clauses_);
    if (ok_) clean(learnts_);
    if (ok_) RebuildWatchesAndLists();
    root_simplified_trail_ = (i32)trail_.size();
  }

  // Clause vivification (reference sat/sat_inprocessing.h:160-210): at a
  // root restart, re-derive a budgeted batch of long learnt clauses by
  // assuming the negations of their literals in order under full unit
  // propagation:
  //   - literal already TRUE under the prefix -> clause closes at the
  //     kept prefix + this literal (RUP: assuming all of them false is
  //     contradictory);
  //   - literal already FALSE -> redundant, dropped (under the full
  //     negated-kept assumption it still propagates false, so the
  //     original clause itself conflicts: RUP);
  //   - propagation conflict -> clause closes at the kept prefix.
  // A strictly shorter result replaces the original (DRAT: add the
  // strengthened clause, then delete the original).  Deriving THROUGH
  // the clause itself is sound: the shorter clause implies the longer
  // one, so the rewritten formula is equivalent.
  size_t vivify_cursor_ = 0;
  i64 vivified_ = 0;
  i64 last_vivify_conflicts_ = 0;
  std::vector<u32> otf_pending_;  // subsumed clauses awaiting deletion
  i64 otf_subsumed_ = 0;

  void FlushOtfSubsumed() {
    if (otf_pending_.empty() || Level() != 0) return;
    bool any = false;
    for (u32 cref : otf_pending_) {
      if (ClauseDead(cref) || IsReason(cref)) continue;
      arena_[cref] |= 2;
      ++otf_subsumed_;
      any = true;
      if (proof_enabled_) {
        proof_buf_.clear();
        const i32* lits = &arena_[cref + 3];
        for (int k = 0; k < ClauseSize(cref); ++k)
          proof_buf_.push_back((u32)lits[k]);
        RecordProof(proof_buf_, /*deletion=*/true);
      }
    }
    otf_pending_.clear();
    if (any) RebuildWatchesAndLists();
  }

  void VivifyClauses(int max_clauses, i64 prop_budget) {
    if (Level() != 0 || !ok_) return;
    i64 props0 = propagations_;
    int done = 0;
    size_t scanned = 0;
    const size_t n0 = learnts_.size();
    std::vector<u32> lits, kept;
    // SCAN with the database untouched (rewriting mid-scan would leave
    // stale watches/blockers driving the very propagation the pass
    // relies on), then APPLY: all strengthened-clause additions first
    // (RUP is monotone in the database), then all deletions.
    struct Pending {
      u32 cref;
      std::vector<u32> old_lits;
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
      // target the mid-quality tier (CaDiCaL-style): glue clauses are
      // already short and precious; very high-LBD ones die in ReduceDB
      // anyway
      if (ClauseLbd(cref) < 3 || ClauseLbd(cref) > 20) continue;
      lits.assign((u32*)&arena_[cref + 3], (u32*)&arena_[cref + 3] + sz);
      bool rooted = false;
      for (u32 l : lits)
        if (Value(l) != kUnassigned) rooted = true;
      if (rooted) continue;  // the root cleaner owns those
      ++done;
      seen_crefs.push_back(cref);
      kept.clear();
      NewDecisionLevel();
      for (u32 l : lits) {
        uint8_t v = Value(l);
        if (v == kTrue) {
          kept.push_back(l);
          break;
        }
        if (v == kFalse) continue;  // redundant under the kept prefix
        kept.push_back(l);
        Enqueue(Neg(l), kNoReason);
        if (Propagate() != kNoReason) break;
      }
      BacktrackTo(0);
      if (kept.empty() || kept.size() >= lits.size()) continue;
      pending.push_back({cref, lits, kept});
    }
    if (pending.empty()) return;
    if (proof_enabled_) {
      for (auto& pd : pending) RecordProof(pd.kept, /*deletion=*/false);
    }
    std::vector<u32> new_units;
    for (auto& pd : pending) {
      u32 cref = pd.cref;
      if (ClauseDead(cref) || IsReason(cref)) continue;
      i32* dst = &arena_[cref + 3];
      for (size_t k = 0; k < pd.kept.size(); ++k) dst[k] = (i32)pd.kept[k];
      arena_[cref] = ((i32)pd.kept.size() << 2) | (arena_[cref] & 3);
      ++vivified_;
      if (proof_enabled_) RecordProof(pd.old_lits, /*deletion=*/true);
      if (pd.kept.size() == 1) {
        new_units.push_back(pd.kept[0]);
        arena_[cref] |= 2;  // dead: the unit fact moves to the trail
      }
    }
    RebuildWatchesAndLists();
    for (u32 u : new_units) {
      if (Value(u) == kFalse) {
        ok_ = false;
        if (proof_enabled_) proof_.push_back(0);
        return;
      }
      if (Value(u) == kUnassigned) Enqueue(u, kNoReason);
    }
    if (Propagate() != kNoReason) {
      ok_ = false;
      if (proof_enabled_) proof_.push_back(0);
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
      arena_[cref] |= 2;  // dead
      if (proof_enabled_) {
        proof_buf_.clear();
        i32* lits = &arena_[cref + 3];
        for (int k = 0; k < ClauseSize(cref); ++k)
          proof_buf_.push_back((u32)lits[k]);
        RecordProof(proof_buf_, /*deletion=*/true);
      }
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

  // ---- DRAT proof log (reference sat/drat_writer.h) ----------------------
  // Records: [n, ext_lits...] for additions, [-n, ext_lits...] for
  // deletions, and a bare 0 for the final empty clause.
  void RecordProof(const std::vector<u32>& lits, bool deletion) {
    i32 n = (i32)lits.size();
    proof_.push_back(deletion ? -n : n);
    for (u32 l : lits)
      proof_.push_back((l & 1u) ? -(i32)((l >> 1) + 1) : (i32)((l >> 1) + 1));
  }
  bool proof_enabled_ = false;
  std::vector<i32> proof_;
  std::vector<u32> proof_buf_;

  // ---- decision heuristic -----------------------------------------------
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
      if (assign_[v] == kUnassigned) return MkLit(v, phase_[v]);
    }
    return kNoLit;
  }

  // minisat-style Luby sequence (base step count multiplies the result)
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

void* cdcl_new(i32 nvars) { return new Solver(nvars); }
void cdcl_set_inprocessing(void* s, i32 on) {
  static_cast<Solver*>(s)->SetInprocessing(on != 0);
}
i64 cdcl_num_vivified(void* s) {
  return static_cast<Solver*>(s)->NumVivified();
}
i64 cdcl_num_otf_subsumed(void* s) {
  return static_cast<Solver*>(s)->NumOtfSubsumed();
}
void cdcl_free(void* s) { delete static_cast<Solver*>(s); }
i32 cdcl_new_var(void* s) { return static_cast<Solver*>(s)->NewVar(); }
i32 cdcl_num_vars(void* s) { return static_cast<Solver*>(s)->NumVars(); }

i32 cdcl_add_clause(void* s, const i32* lits, i32 n) {
  return static_cast<Solver*>(s)->AddClause(lits, n) ? 0 : -1;
}

// Bulk add: clauses concatenated with 0 terminators (DIMACS body layout).
i32 cdcl_add_clauses(void* s, const i32* lits, i64 n) {
  Solver* sol = static_cast<Solver*>(s);
  i64 start = 0;
  bool ok = true;
  for (i64 i = 0; i < n; ++i) {
    if (lits[i] == 0) {
      ok = sol->AddClause(lits + start, (int)(i - start)) && ok;
      start = i + 1;
    }
  }
  if (start < n) ok = sol->AddClause(lits + start, (int)(n - start)) && ok;
  return ok ? 0 : -1;
}

i32 cdcl_solve(void* s, const i32* assumptions, i32 n_assump,
               i64 conflict_budget) {
  return static_cast<Solver*>(s)->Solve(assumptions, n_assump,
                                        conflict_budget);
}

void cdcl_get_model(void* s, int8_t* out) {
  Solver* sol = static_cast<Solver*>(s);
  for (int v = 0; v < sol->NumVars(); ++v)
    out[v] = sol->ModelValue(v) == 0 ? 1 : 0;
}

i32 cdcl_get_core(void* s, i32* out) {
  const auto& core = static_cast<Solver*>(s)->Core();
  for (size_t i = 0; i < core.size(); ++i) {
    u32 l = core[i];
    out[i] = (l & 1u) ? -(i32)((l >> 1) + 1) : (i32)((l >> 1) + 1);
  }
  return (i32)core.size();
}

// vals[v] in {-1 = keep default, 0 = prefer false, 1 = prefer true}.
void cdcl_set_phases(void* s, const int8_t* vals, i32 n) {
  Solver* sol = static_cast<Solver*>(s);
  i32 cap = sol->NumVars() < n ? sol->NumVars() : n;
  for (i32 v = 0; v < cap; ++v)
    if (vals[v] >= 0) sol->SetPhase(v, vals[v] != 0);
}

void cdcl_enable_proof(void* s) { static_cast<Solver*>(s)->EnableProof(); }
i64 cdcl_proof_size(void* s) {
  return (i64)static_cast<Solver*>(s)->Proof().size();
}
void cdcl_get_proof(void* s, i32* out) {
  const auto& p = static_cast<Solver*>(s)->Proof();
  for (size_t i = 0; i < p.size(); ++i) out[i] = p[i];
}

i64 cdcl_num_conflicts(void* s) {
  return static_cast<Solver*>(s)->NumConflicts();
}
i64 cdcl_num_propagations(void* s) {
  return static_cast<Solver*>(s)->NumPropagations();
}

}  // extern "C"
