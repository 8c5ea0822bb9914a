// Native graph-algorithm core.
//
// Capability parity: ortools/graph — GenericMaxFlow push-relabel
// (max_flow.h:145), GenericMinCostFlow (min_cost_flow.h:378),
// shortest paths (shortest_paths.h), Hungarian assignment
// (algorithms/hungarian.h:48).  Like the reference these are C++ (the
// control-flow-heavy graph kernels stay native; see SURVEY §2.15), exposed
// through a C ABI consumed via ctypes from ortools_tpu.graph.
//
// Build: g++ -O2 -shared -fPIC graph.cc -o libortools_tpu_graph.so
// (driven by ortools_tpu/_native/build.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <queue>
#include <vector>

namespace {

using i64 = int64_t;
using i32 = int32_t;

constexpr i64 kInf = std::numeric_limits<i64>::max() / 4;

// ---------------------------------------------------------------------------
// Highest-label push-relabel max flow with gap relabeling.
// ---------------------------------------------------------------------------
struct MaxFlowGraph {
  i32 n;
  std::vector<i32> head, next_arc, first, rev;
  std::vector<i64> cap;

  explicit MaxFlowGraph(i32 num_nodes) : n(num_nodes), first(num_nodes, -1) {}

  void AddEdge(i32 u, i32 v, i64 c) {
    head.push_back(v); cap.push_back(c);
    next_arc.push_back(first[u]); first[u] = (i32)head.size() - 1;
    head.push_back(u); cap.push_back(0);
    next_arc.push_back(first[v]); first[v] = (i32)head.size() - 1;
  }
};

i64 MaxFlow(MaxFlowGraph& g, i32 s, i32 t, std::vector<i64>* flow_out) {
  const i32 n = g.n;
  std::vector<i64> excess(n, 0);
  std::vector<i32> height(n, 0), count(2 * n + 1, 0);
  std::vector<i32> cur(g.first);
  std::vector<i64> orig_cap(g.cap);

  height[s] = n;
  count[0] = n - 1;
  count[n] = 1;
  // saturate source arcs
  for (i32 a = g.first[s]; a != -1; a = g.next_arc[a]) {
    i64 c = g.cap[a];
    if (c > 0) {
      g.cap[a] -= c;
      g.cap[a ^ 1] += c;
      excess[g.head[a]] += c;
      excess[s] -= c;
    }
  }
  // highest-label selection via buckets
  std::vector<std::vector<i32>> bucket(2 * n + 1);
  i32 highest = 0;
  auto enqueue = [&](i32 u) {
    bucket[height[u]].push_back(u);
    highest = std::max(highest, height[u]);
  };
  for (i32 v = 0; v < n; ++v)
    if (v != s && v != t && excess[v] > 0) enqueue(v);

  auto push = [&](i32 v, i32 a) {
    i32 w = g.head[a];
    i64 d = std::min(excess[v], g.cap[a]);
    g.cap[a] -= d;
    g.cap[a ^ 1] += d;
    excess[v] -= d;
    if (excess[w] == 0 && w != s && w != t && d > 0) enqueue(w);
    excess[w] += d;
  };

  while (true) {
    while (highest >= 0 && bucket[highest].empty()) --highest;
    if (highest < 0) break;
    i32 v = bucket[highest].back();
    bucket[highest].pop_back();
    if (v == s || v == t || excess[v] == 0 || height[v] != highest) continue;
    while (excess[v] > 0) {
      if (cur[v] == -1) {
        // relabel
        i32 old_h = height[v];
        i32 new_h = 2 * n;
        for (i32 a = g.first[v]; a != -1; a = g.next_arc[a])
          if (g.cap[a] > 0) new_h = std::min(new_h, height[g.head[a]] + 1);
        --count[old_h];
        if (new_h >= 2 * n) { height[v] = 2 * n; break; }  // stuck: drop
        height[v] = new_h;
        ++count[new_h];
        if (old_h < n && count[old_h] == 0) {
          // gap heuristic: lift everything above the gap; re-queue any
          // lifted node still carrying excess
          for (i32 u = 0; u < n; ++u)
            if (u != s && height[u] > old_h && height[u] < n) {
              --count[height[u]];
              height[u] = n + 1;
              ++count[n + 1];
              if (excess[u] > 0 && u != t) enqueue(u);
            }
        }
        cur[v] = g.first[v];
        if (height[v] >= 2 * n) break;
      }
      i32 a = cur[v];
      if (g.cap[a] > 0 && height[v] == height[g.head[a]] + 1)
        push(v, a);
      else
        cur[v] = g.next_arc[a];
      if (cur[v] == -1 && excess[v] > 0) cur[v] = -1;  // trigger relabel
      if (excess[v] == 0) break;
      if (cur[v] == -1) continue;  // relabel on next loop
    }
    if (excess[v] > 0 && height[v] < 2 * n) enqueue(v);
  }
  if (flow_out) {
    flow_out->resize(g.head.size() / 2);
    for (size_t e = 0; e < flow_out->size(); ++e)
      (*flow_out)[e] = orig_cap[2 * e] - g.cap[2 * e];
  }
  return excess[t];
}

// ---------------------------------------------------------------------------
// Min-cost flow: successive shortest paths with potentials (Dijkstra;
// one Bellman-Ford pass first when negative costs are present).
// Flat edge arrays: edge 2k is arc k, edge 2k+1 its residual twin.
// ---------------------------------------------------------------------------
struct Mcf {
  i32 n;
  std::vector<i32> to, first, next_edge;
  std::vector<i64> cap, cost;
  explicit Mcf(i32 nn) : n(nn), first(nn, -1) {}
  void AddEdge(i32 u, i32 v, i64 c, i64 w) {
    to.push_back(v); cap.push_back(c); cost.push_back(w);
    next_edge.push_back(first[u]); first[u] = (i32)to.size() - 1;
    to.push_back(u); cap.push_back(0); cost.push_back(-w);
    next_edge.push_back(first[v]); first[v] = (i32)to.size() - 1;
  }
};

// returns 0 = optimal, 1 = infeasible (cannot route all supply)
int MinCostFlow(Mcf& g, i32 S, i32 T, i64 total_supply, bool has_negative,
                i64* total_cost) {
  const i32 n = g.n;
  std::vector<i64> pot(n, 0), dist(n);
  std::vector<i32> pe(n);
  if (has_negative) {
    // Bellman-Ford over forward arcs to initialize potentials
    std::fill(pot.begin(), pot.end(), kInf);
    pot[S] = 0;
    for (i32 it = 0; it < n; ++it) {
      bool changed = false;
      for (i32 u = 0; u < n; ++u) {
        if (pot[u] >= kInf) continue;
        for (i32 e = g.first[u]; e != -1; e = g.next_edge[e])
          if (g.cap[e] > 0 && pot[u] + g.cost[e] < pot[g.to[e]]) {
            pot[g.to[e]] = pot[u] + g.cost[e];
            changed = true;
          }
      }
      if (!changed) break;
    }
    for (i32 v = 0; v < n; ++v)
      if (pot[v] >= kInf) pot[v] = 0;
  }
  i64 flow = 0, cost = 0;
  while (flow < total_supply) {
    std::fill(dist.begin(), dist.end(), kInf);
    dist[S] = 0;
    using QE = std::pair<i64, i32>;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    pq.push({0, S});
    while (!pq.empty()) {
      auto [d, u] = pq.top(); pq.pop();
      if (d > dist[u]) continue;
      for (i32 e = g.first[u]; e != -1; e = g.next_edge[e]) {
        if (g.cap[e] <= 0) continue;
        i32 v = g.to[e];
        i64 nd = d + g.cost[e] + pot[u] - pot[v];
        if (nd < dist[v]) {
          dist[v] = nd;
          pe[v] = e;
          pq.push({nd, v});
        }
      }
    }
    if (dist[T] >= kInf) return 1;  // infeasible
    for (i32 v = 0; v < n; ++v)
      if (dist[v] < kInf) pot[v] += dist[v];
    i64 push = total_supply - flow;
    for (i32 v = T; v != S; v = g.to[pe[v] ^ 1])
      push = std::min(push, g.cap[pe[v]]);
    for (i32 v = T; v != S; v = g.to[pe[v] ^ 1]) {
      g.cap[pe[v]] -= push;
      g.cap[pe[v] ^ 1] += push;
      cost += push * g.cost[pe[v]];
    }
    flow += push;
  }
  *total_cost = cost;
  return 0;
}

}  // namespace

extern "C" {

// ---- max flow -------------------------------------------------------------
// arcs: tails[i] -> heads[i] with capacities[i]; returns max flow value;
// flows_out[i] receives per-arc flow.
i64 otpu_max_flow(i32 num_nodes, i64 num_arcs, const i32* tails,
                  const i32* heads, const i64* capacities, i32 source,
                  i32 sink, i64* flows_out) {
  MaxFlowGraph g(num_nodes);
  for (i64 i = 0; i < num_arcs; ++i)
    g.AddEdge(tails[i], heads[i], capacities[i]);
  std::vector<i64> flows;
  i64 f = MaxFlow(g, source, sink, &flows);
  if (flows_out)
    std::memcpy(flows_out, flows.data(), sizeof(i64) * flows.size());
  return f;
}

// ---- min cost flow --------------------------------------------------------
// returns 0 = optimal, 1 = infeasible.  flows_out per arc; cost_out total.
i32 otpu_min_cost_flow(i32 num_nodes, i64 num_arcs, const i32* tails,
                       const i32* heads, const i64* capacities,
                       const i64* unit_costs, const i64* supplies,
                       i64* flows_out, i64* cost_out) {
  Mcf g(num_nodes + 2);
  bool has_negative = false;
  for (i64 i = 0; i < num_arcs; ++i) {
    g.AddEdge(tails[i], heads[i], capacities[i], unit_costs[i]);
    has_negative |= unit_costs[i] < 0;
  }
  const i32 S = num_nodes, T = num_nodes + 1;
  i64 total_supply = 0;
  for (i32 v = 0; v < num_nodes; ++v) {
    if (supplies[v] > 0) {
      g.AddEdge(S, v, supplies[v], 0);
      total_supply += supplies[v];
    } else if (supplies[v] < 0) {
      g.AddEdge(v, T, -supplies[v], 0);
    }
  }
  i64 cost = 0;
  int status = MinCostFlow(g, S, T, total_supply, has_negative, &cost);
  if (status == 0 && flows_out)
    for (i64 i = 0; i < num_arcs; ++i)
      flows_out[i] = g.cap[2 * i + 1];  // residual twin's cap == flow
  if (cost_out) *cost_out = cost;
  return status;
}

// ---- Dijkstra -------------------------------------------------------------
void otpu_dijkstra(i32 num_nodes, i64 num_arcs, const i32* tails,
                   const i32* heads, const double* lengths, i32 source,
                   double* dist_out, i32* parent_out) {
  std::vector<std::vector<std::pair<i32, double>>> adj(num_nodes);
  for (i64 i = 0; i < num_arcs; ++i)
    adj[tails[i]].push_back({heads[i], lengths[i]});
  const double inf = std::numeric_limits<double>::infinity();
  std::fill(dist_out, dist_out + num_nodes, inf);
  std::fill(parent_out, parent_out + num_nodes, -1);
  dist_out[source] = 0.0;
  using QE = std::pair<double, i32>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
  pq.push({0.0, source});
  while (!pq.empty()) {
    auto [d, u] = pq.top(); pq.pop();
    if (d > dist_out[u]) continue;
    for (auto& [v, w] : adj[u]) {
      double nd = d + w;
      if (nd < dist_out[v]) {
        dist_out[v] = nd;
        parent_out[v] = u;
        pq.push({nd, v});
      }
    }
  }
}

// ---- Hungarian (dense, O(n^3)) -------------------------------------------
// cost: row-major num_rows x num_cols (num_rows <= num_cols).
// assignment_out[r] = assigned column.  Returns total cost.
double otpu_hungarian(i32 num_rows, i32 num_cols, const double* cost,
                      i32* assignment_out) {
  // classic JV-style potentials algorithm on a padded square matrix
  const i32 n = num_rows, m = num_cols;
  std::vector<double> u(n + 1, 0.0), v(m + 1, 0.0);
  std::vector<i32> p(m + 1, 0), way(m + 1, 0);  // p[col] = row (1-based)
  const double inf = std::numeric_limits<double>::infinity();
  for (i32 i = 1; i <= n; ++i) {
    p[0] = i;
    i32 j0 = 0;
    std::vector<double> minv(m + 1, inf);
    std::vector<char> used(m + 1, false);
    do {
      used[j0] = true;
      i32 i0 = p[j0], j1 = -1;
      double delta = inf;
      for (i32 j = 1; j <= m; ++j) {
        if (used[j]) continue;
        double cur = cost[(i0 - 1) * m + (j - 1)] - u[i0] - v[j];
        if (cur < minv[j]) { minv[j] = cur; way[j] = j0; }
        if (minv[j] < delta) { delta = minv[j]; j1 = j; }
      }
      for (i32 j = 0; j <= m; ++j) {
        if (used[j]) { u[p[j]] += delta; v[j] -= delta; }
        else minv[j] -= delta;
      }
      j0 = j1;
    } while (p[j0] != 0);
    do {
      i32 j1 = way[j0];
      p[j0] = p[j1];
      j0 = j1;
    } while (j0);
  }
  double total = 0.0;
  for (i32 j = 1; j <= m; ++j)
    if (p[j] > 0 && p[j] <= n) {
      assignment_out[p[j] - 1] = j - 1;
      total += cost[(p[j] - 1) * m + (j - 1)];
    }
  return total;
}

}  // extern "C"
