// Native cluster resource scheduler.
//
// The PyTorch port's copy of ray_tpu's native scheduler, an equivalent of
// the reference's C++ scheduler stack
// (src/ray/raylet/scheduling/cluster_resource_scheduler.cc:121 +
// policy/hybrid_scheduling_policy.cc:48-170 +
// policy/bundle_scheduling_policy.cc), redesigned around a flat C ABI so
// the Python raylet binds it with ctypes (no pybind11 in the image).
//
// Semantics intentionally match ray_tpu_torch/core/scheduler.py exactly —
// the Python implementation is the spec (and the fallback when no
// toolchain is available); parity with it and with ray_tpu's copy is
// fuzz-tested in tests/test_torch_runtime_scheduler.py. The one change
// from ray_tpu's copy: STRICT_PACK/PACK group hosts by their
// nvlink_domain label where ray_tpu groups them by tpu_slice.
//
// Resource quantities use fixed-point int64 at 1e-4 granularity, like the
// reference's FixedPoint (src/ray/common/scheduling/fixed_point.h), so
// accounting is exact under repeated add/subtract.
//
// Wire format (keeps the ABI trivial): resource maps are
// "name=value;name=value", bundle lists are maps joined by '|',
// label maps are "key=value;key=value" with string values.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <map>
#include <mutex>
#include <string>
#include <vector>

namespace {

constexpr int64_t kFixedScale = 10000;  // 1e-4 resource granularity
// EPSILON = 1e-9 in the Python spec rounds to 0 in fixed point; >= compares
// are exact here, which matches because Python only uses epsilon to absorb
// float noise.

typedef std::map<std::string, int64_t> ResourceMap;
typedef std::map<std::string, std::string> LabelMap;

int64_t to_fixed(double v) {
  return static_cast<int64_t>(v * kFixedScale + (v >= 0 ? 0.5 : -0.5));
}

// Parse "a=1;b=2.5" into a ResourceMap.
ResourceMap parse_resources(const char* s) {
  ResourceMap out;
  if (!s) return out;
  const char* p = s;
  while (*p) {
    const char* eq = strchr(p, '=');
    if (!eq) break;
    std::string key(p, eq - p);
    char* end = nullptr;
    double val = strtod(eq + 1, &end);
    out[key] = to_fixed(val);
    p = (*end == ';') ? end + 1 : end;
    if (p == end && *p && *p != ';') break;  // malformed; stop
  }
  return out;
}

LabelMap parse_labels(const char* s) {
  LabelMap out;
  if (!s) return out;
  const char* p = s;
  while (*p) {
    const char* eq = strchr(p, '=');
    if (!eq) break;
    const char* sep = strchr(eq + 1, ';');
    if (!sep) sep = eq + 1 + strlen(eq + 1);
    out[std::string(p, eq - p)] = std::string(eq + 1, sep - (eq + 1));
    p = (*sep == ';') ? sep + 1 : sep;
  }
  return out;
}

std::vector<ResourceMap> parse_bundles(const char* s) {
  std::vector<ResourceMap> out;
  if (!s || !*s) return out;
  std::string str(s);
  size_t start = 0;
  while (start <= str.size()) {
    size_t bar = str.find('|', start);
    std::string part = str.substr(
        start, bar == std::string::npos ? std::string::npos : bar - start);
    out.push_back(parse_resources(part.c_str()));
    if (bar == std::string::npos) break;
    start = bar + 1;
  }
  return out;
}

struct Node {
  std::string id;
  ResourceMap total;
  ResourceMap available;
  LabelMap labels;

  bool feasible(const ResourceMap& demand) const {
    for (const auto& kv : demand) {
      auto it = total.find(kv.first);
      int64_t have = (it == total.end()) ? 0 : it->second;
      if (have < kv.second) return false;
    }
    return true;
  }

  static bool fits(const ResourceMap& avail, const ResourceMap& demand) {
    for (const auto& kv : demand) {
      auto it = avail.find(kv.first);
      int64_t have = (it == avail.end()) ? 0 : it->second;
      if (have < kv.second) return false;
    }
    return true;
  }

  bool available_for(const ResourceMap& demand) const {
    return fits(available, demand);
  }

  // Critical-resource utilization: max over resources of 1 - avail/total.
  double utilization() const {
    double util = 0.0;
    for (const auto& kv : total) {
      if (kv.second > 0) {
        auto it = available.find(kv.first);
        int64_t avail = (it == available.end()) ? 0 : it->second;
        double u = 1.0 - static_cast<double>(avail) / kv.second;
        util = std::max(util, u);
      }
    }
    return util;
  }
};

struct Scheduler {
  std::mutex mu;
  double spread_threshold = 0.5;
  std::vector<Node> nodes;  // insertion-ordered; ids unique

  Node* find(const std::string& id) {
    for (auto& n : nodes)
      if (n.id == id) return &n;
    return nullptr;
  }
};

int write_out(const std::string& s, char* out, int outcap) {
  if (static_cast<int>(s.size()) + 1 > outcap) return -1;
  memcpy(out, s.c_str(), s.size() + 1);
  return static_cast<int>(s.size());
}

// Hybrid pack-then-spread score; mirrors scheduler.py::_hybrid.
// Key = (unavailable, truncated_util, not_preferred, node_id); min wins.
struct HybridKey {
  int unavailable;
  double truncated;
  int not_preferred;
  const std::string* id;
  bool operator<(const HybridKey& o) const {
    if (unavailable != o.unavailable) return unavailable < o.unavailable;
    if (truncated != o.truncated) return truncated < o.truncated;
    if (not_preferred != o.not_preferred) return not_preferred < o.not_preferred;
    return *id < *o.id;
  }
};

const Node* hybrid_select(const Scheduler& sch,
                          const std::vector<const Node*>& feasible,
                          const ResourceMap& demand,
                          const std::string& prefer) {
  const Node* best = nullptr;
  HybridKey best_key{0, 0, 0, nullptr};
  for (const Node* n : feasible) {
    double util = n->utilization();
    HybridKey key{n->available_for(demand) ? 0 : 1,
                  util < sch.spread_threshold ? 0.0 : util,
                  (!prefer.empty() && n->id == prefer) ? 0 : 1, &n->id};
    if (!best || key < best_key) {
      best = n;
      best_key = key;
    }
  }
  return best;
}

// First-fit over a node group with running availability; mirrors
// scheduler.py::_first_fit.
bool first_fit(const std::vector<const Node*>& group,
               const std::vector<ResourceMap>& bundles,
               std::vector<std::string>* placement) {
  std::map<std::string, ResourceMap> remaining;
  for (const Node* n : group) remaining[n->id] = n->available;
  std::vector<std::string> result;
  for (const auto& b : bundles) {
    const Node* chosen = nullptr;
    for (const Node* n : group) {
      if (Node::fits(remaining[n->id], b)) {
        chosen = n;
        break;
      }
    }
    if (!chosen) return false;
    for (const auto& kv : b) remaining[chosen->id][kv.first] -= kv.second;
    result.push_back(chosen->id);
  }
  *placement = result;
  return true;
}

double min_remaining_frac(const Node& n,
                          const std::map<std::string, ResourceMap>& remaining) {
  // Mirrors the Python spread re-sort key: 1 - min over total resources of
  // remaining/total (or 1.0 when total is zero-capacity).
  const ResourceMap& rem = remaining.at(n.id);
  double min_frac = 1.0;
  bool any = false;
  for (const auto& kv : n.total) {
    any = true;
    double frac;
    if (kv.second == 0) {
      frac = 1.0;
    } else {
      auto it = rem.find(kv.first);
      int64_t r = (it == rem.end()) ? 0 : it->second;
      frac = static_cast<double>(r) / kv.second;
    }
    min_frac = std::min(min_frac, frac);
  }
  if (!any) min_frac = 1.0;  // Python falls back to CPU=1.0 → frac of 0/1? —
  // spec: nodes with empty totals use [("CPU", 1.0)] whose remaining lookup
  // yields 0 ⇒ frac 0. Match that:
  if (!any) {
    auto it = rem.find("CPU");
    int64_t r = (it == rem.end()) ? 0 : it->second;
    min_frac = static_cast<double>(r) / kFixedScale;
  }
  return 1.0 - min_frac;
}

}  // namespace

extern "C" {

void* sched_create(double spread_threshold) {
  Scheduler* s = new Scheduler();
  s->spread_threshold = spread_threshold;
  return s;
}

void sched_destroy(void* handle) { delete static_cast<Scheduler*>(handle); }

void sched_set_threshold(void* handle, double threshold) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->spread_threshold = threshold;
}

void sched_clear(void* handle) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  s->nodes.clear();
}

// Insert or fully replace a node's view.
void sched_upsert_node(void* handle, const char* node_id, const char* total,
                       const char* available, const char* labels) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  Node* n = s->find(node_id);
  if (!n) {
    s->nodes.push_back(Node());
    n = &s->nodes.back();
    n->id = node_id;
  }
  n->total = parse_resources(total);
  n->available = parse_resources(available);
  n->labels = parse_labels(labels);
}

void sched_remove_node(void* handle, const char* node_id) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  for (size_t i = 0; i < s->nodes.size(); ++i) {
    if (s->nodes[i].id == node_id) {
      s->nodes.erase(s->nodes.begin() + i);
      return;
    }
  }
}

// strategy: "HYBRID" | "SPREAD". prefer_node may be "" (none).
// Returns chosen id length (written into out), 0 if no feasible node,
// -1 on buffer overflow.
int sched_select(void* handle, const char* demand_s, const char* strategy,
                 const char* prefer_node, char* out, int outcap) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  ResourceMap demand = parse_resources(demand_s);
  std::vector<const Node*> feasible;
  for (const auto& n : s->nodes)
    if (n.feasible(demand)) feasible.push_back(&n);
  if (feasible.empty()) {
    if (outcap > 0) out[0] = '\0';
    return 0;
  }
  const Node* chosen = nullptr;
  if (strcmp(strategy, "SPREAD") == 0) {
    // Among available nodes (fallback: all feasible), least (util, id).
    std::vector<const Node*> avail;
    for (const Node* n : feasible)
      if (n->available_for(demand)) avail.push_back(n);
    const std::vector<const Node*>& pool = avail.empty() ? feasible : avail;
    for (const Node* n : pool) {
      if (!chosen) {
        chosen = n;
        continue;
      }
      double u1 = n->utilization(), u2 = chosen->utilization();
      if (u1 < u2 || (u1 == u2 && n->id < chosen->id)) chosen = n;
    }
  } else {
    chosen = hybrid_select(*s, feasible, demand,
                           prefer_node ? prefer_node : "");
  }
  if (!chosen) {
    if (outcap > 0) out[0] = '\0';
    return 0;
  }
  return write_out(chosen->id, out, outcap);
}

// strategy: STRICT_PACK | PACK | SPREAD | STRICT_SPREAD.
// Writes ';'-joined node ids (one per bundle). Returns byte length,
// 0 if infeasible, -1 on overflow.
int sched_place_bundles(void* handle, const char* bundles_s,
                        const char* strategy, char* out, int outcap) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  std::vector<ResourceMap> bundles = parse_bundles(bundles_s);
  std::vector<std::string> placement;
  std::string strat(strategy);

  std::vector<const Node*> all;
  for (const auto& n : s->nodes) all.push_back(&n);

  bool ok = false;
  if (strat == "STRICT_PACK" || strat == "PACK") {
    bool strict = (strat == "STRICT_PACK");
    // Domain groups: nodes sharing an nvlink_domain label, in first-seen
    // order.
    std::vector<std::string> slice_order;
    std::map<std::string, std::vector<const Node*>> slices;
    for (const Node* n : all) {
      auto it = n->labels.find("nvlink_domain");
      if (it != n->labels.end() && !it->second.empty()) {
        if (slices.find(it->second) == slices.end())
          slice_order.push_back(it->second);
        slices[it->second].push_back(n);
      }
    }
    std::vector<std::vector<const Node*>> groups;
    if (strict) {
      for (const Node* n : all) groups.push_back({n});
      for (const auto& key : slice_order) groups.push_back(slices[key]);
    } else {
      for (const auto& key : slice_order) groups.push_back(slices[key]);
      groups.push_back(all);
    }
    for (const auto& g : groups) {
      if (first_fit(g, bundles, &placement)) {
        ok = true;
        break;
      }
    }
    if (!ok && !strict) ok = first_fit(all, bundles, &placement);
  } else if (strat == "STRICT_SPREAD" || strat == "SPREAD") {
    bool strict = (strat == "STRICT_SPREAD");
    std::map<std::string, ResourceMap> remaining;
    for (const Node* n : all) remaining[n->id] = n->available;
    // initial order: (utilization, id)
    std::vector<const Node*> order(all);
    std::stable_sort(order.begin(), order.end(),
                     [](const Node* a, const Node* b) {
                       double ua = a->utilization(), ub = b->utilization();
                       if (ua != ub) return ua < ub;
                       return a->id < b->id;
                     });
    std::vector<std::string> used;
    ok = true;
    for (const auto& b : bundles) {
      const Node* chosen = nullptr;
      for (const Node* n : order) {
        if (strict && std::find(used.begin(), used.end(), n->id) != used.end())
          continue;
        if (Node::fits(remaining[n->id], b)) {
          chosen = n;
          break;
        }
      }
      if (!chosen) {
        if (strict) {
          ok = false;
          break;
        }
        for (const Node* n : order) {
          if (Node::fits(remaining[n->id], b)) {
            chosen = n;
            break;
          }
        }
        if (!chosen) {
          ok = false;
          break;
        }
      }
      for (const auto& kv : b) remaining[chosen->id][kv.first] -= kv.second;
      used.push_back(chosen->id);
      placement.push_back(chosen->id);
      // re-sort by min remaining fraction (spec: keeps spreading balanced)
      std::stable_sort(order.begin(), order.end(),
                       [&remaining](const Node* a, const Node* b) {
                         double ka = min_remaining_frac(*a, remaining);
                         double kb = min_remaining_frac(*b, remaining);
                         if (ka != kb) return ka < kb;
                         return a->id < b->id;
                       });
    }
  } else {
    if (outcap > 0) out[0] = '\0';
    return 0;
  }

  if (!ok) {
    if (outcap > 0) out[0] = '\0';
    return 0;
  }
  std::string joined;
  for (size_t i = 0; i < placement.size(); ++i) {
    if (i) joined += ';';
    joined += placement[i];
  }
  return write_out(joined, out, outcap);
}

int sched_num_nodes(void* handle) {
  Scheduler* s = static_cast<Scheduler*>(handle);
  std::lock_guard<std::mutex> lock(s->mu);
  return static_cast<int>(s->nodes.size());
}

}  // extern "C"
