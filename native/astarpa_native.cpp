// astarpa_native — C++ runtime for the A*PA search path.
//
// The A* loop is data-dependent pointer chasing (hash maps, bucket queues,
// contour probes) — the part of the aligner that does not map to the batched
// device DP and the part the reference keeps hottest in native code.  This library is the
// production implementation of the same semantics as the Python runtime in
// astarpa_tpu/astar (which stays as the readable reference / oracle):
//
//   - seeds & potentials                 (pa-heuristic/src/seeds.rs)
//   - r=1 / r=2 q-gram match finding     (matches/exact.rs, inexact.rs)
//   - match pruning w/ consistency       (prune.rs:109-366)
//   - GCSH/CSH layered contours          (contour/hint_contours.rs; the
//     faithful incremental structure: hint window probes, prune ripple,
//     whole-layer removal driving O(1) priority-queue shifts)
//   - bucket queue                       (bucket_queue.rs)
//   - A* over Pos states and DT states   (astar.rs:35-301, astar_dt.rs)
//
// Exposed via a C ABI (astarpa.h) for ctypes/cffi and C/C++ consumers —
// the astarpa-c parity layer.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <string>
#include <vector>
#include <unordered_map>
#include <algorithm>
#include <cassert>
#include <atomic>
#include <thread>

#if defined(__AVX512BW__)
#include <immintrin.h>
#endif

namespace {

using i32 = int32_t;
using i64 = int64_t;
using u32 = uint32_t;
using u64 = uint64_t;

constexpr i32 INF = INT32_MAX / 4;

struct Pos {
  i32 i = 0, j = 0;
  bool operator==(const Pos& o) const { return i == o.i && j == o.j; }
  bool operator!=(const Pos& o) const { return !(*this == o); }
};
struct PosHash {
  size_t operator()(const Pos& p) const {
    return std::hash<u64>()((u64(u32(p.i)) << 32) | u32(p.j));
  }
};
static inline bool lex_less(const Pos& a, const Pos& b) {
  return a.i != b.i ? a.i < b.i : a.j < b.j;
}

static inline i32 code(uint8_t c) { return (c >> 1) & 3; }

// ---------------------------------------------------------------- seeds

struct Seeds {
  i32 n = 0, k = 0, r = 0;
  std::vector<i32> potential;   // potential[i], size n+1
  std::vector<i32> seed_at;     // seed index covering column i, or -1
  std::vector<i32> seed_start;  // start of each seed

  void build(i32 n_, i32 k_, i32 r_) {
    n = n_; k = k_; r = r_;
    i32 num_seeds = (n >= k) ? n / k : 0;  // disjoint k-mers of a
    potential.assign(n + 1, 0);
    seed_at.assign(n + 1, -1);
    seed_start.resize(num_seeds);
    for (i32 s = 0; s < num_seeds; s++) seed_start[s] = s * k;
    for (i32 i = 0; i <= n; i++) {
      if (i < num_seeds * k) seed_at[i] = i / k;
      // potential[i] = r * (#seeds starting at >= i)
      i32 first = std::min((i + k - 1) / k, num_seeds);
      potential[i] = r * (num_seeds - first);
    }
  }
  i32 pot(Pos p) const { return potential[p.i]; }
  bool is_seed_start(Pos p) const {
    i32 s = seed_at[p.i];
    return s >= 0 && p.i == seed_start[s];
  }
  bool is_seed_end(Pos p) const {
    if (p.i == 0) return false;
    i32 s = seed_at[p.i - 1];
    return s >= 0 && p.i == seed_start[s] + k;
  }
  bool is_seed_start_or_end(Pos p) const {
    return is_seed_start(p) || is_seed_end(p);
  }
  // GCSH domain transform (`seeds.rs:140-143`).
  Pos transform(Pos p) const {
    i32 pp = potential[p.i];
    return Pos{p.i - p.j - pp, p.j - p.i - pp};
  }
  // Cost to cross the seeds strictly between from and to with no matches.
  i32 potential_distance(Pos from, Pos to) const {
    i32 end_i = to.i;
    i32 s = seed_at[to.i];
    if (s >= 0) end_i = seed_start[s];
    return potential[from.i] - potential[end_i];
  }
};

// ------------------------------------------------------------- matches

struct Match {
  Pos start, end;
  i32 cost = 0, pot = 1;
  bool pruned = false;
  i32 score() const { return pot - cost; }
};

static u64 qgram_of(const uint8_t* s, i32 k) {
  u64 q = 0;
  for (i32 t = 0; t < k; t++) q = (q << 2) | u64(code(s[t]));
  return q;
}

// All single-edit variants of a 2-bit packed q-gram (`inexact.rs:18-58`).
static void mutations(i32 k, u64 qgram, std::vector<u64>& dels,
                      std::vector<u64>& subs, std::vector<u64>& ins) {
  dels.clear(); subs.clear(); ins.clear();
  for (i32 i = 0; i < k; i++) {
    u64 mask = ~(u64(3) << (2 * i));
    for (u64 s = 0; s < 4; s++) {
      u64 q = (qgram & mask) | (s << (2 * i));
      if (q != qgram) subs.push_back(q);
    }
  }
  for (i32 i = 0; i <= k; i++) {
    u64 mask = (u64(1) << (2 * i)) - 1;
    for (u64 s = 0; s < 4; s++)
      ins.push_back((qgram & mask) | (s << (2 * i)) | ((qgram & ~mask) << 2));
  }
  for (i32 i = 0; i < k; i++) {
    u64 mask = (u64(1) << (2 * i)) - 1;
    dels.push_back((qgram & mask) | ((qgram & (~mask << 2)) >> 2));
  }
}

// Open-addressing q-gram hash multimap: three linear passes over the
// text (count, prefix-sum, place), O(1) probes — the role of the
// reference's FxHashMap tables (`exact.rs:40-69`).  Replaces the round-2
// sort-merge (3 sorts of ~10^6 queries + tables dominated the gcsh
// domain build at 500kbp; direct probes cut it ~5-10x).
struct QgramHash {
  static constexpr u64 EMPTY = ~u64(0);
  // Byte tags make the common MISS probe resolve in a cap-byte array
  // (L2-resident at 10^6 grams) without touching the 8-byte keys: the
  // r=2 mutation queries miss ~99% of the time.
  std::vector<uint8_t> tags;   // slot -> 0 free, else (hash>>56)|1
  std::vector<u64> keys;       // slot -> qgram
  std::vector<i32> offs;       // slot -> start into positions
  std::vector<i32> cnts;       // slot -> occurrence count
  std::vector<i32> positions;  // grouped j positions
  u64 mask = 0;

  static inline u64 mix(u64 x) {  // splitmix64 finalizer
    x += 0x9E3779B97F4A7C15ull;
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9ull;
    x = (x ^ (x >> 27)) * 0x94D049BB133111EBull;
    return x ^ (x >> 31);
  }

  inline u64 find_slot(u64 key, u64 hx) const {  // existing or first free
    u64 s = hx & mask;
    uint8_t tag = (uint8_t)(hx >> 56) | 1;
    while (true) {
      uint8_t t = tags[s];
      if (t == 0 || (t == tag && keys[s] == key)) return s;
      s = (s + 1) & mask;
    }
  }

  void build_sliding(const uint8_t* s, i32 len, i32 k) {
    positions.clear();
    i32 ngrams = (len >= k) ? len - k + 1 : 0;
    u64 cap = 16;
    while (cap < u64(2 * ngrams + 2)) cap <<= 1;
    mask = cap - 1;
    tags.assign(cap, 0);
    keys.assign(cap, EMPTY);
    offs.assign(cap, 0);
    cnts.assign(cap, 0);
    if (!ngrams) return;
    u64 kmask = (k < 32) ? ((u64(1) << (2 * k)) - 1) : ~u64(0);
    // Gram + hash streams once (sequential); the two random-access passes
    // then prefetch PF slots ahead — the table is L3-sized at long reads
    // and memory-level parallelism is the whole game.
    std::vector<u64> grams(ngrams), hxs(ngrams);
    u64 q = 0;
    for (i32 t = 0; t < k - 1; t++) q = (q << 2) | u64(code(s[t]));
    for (i32 j = 0; j < ngrams; j++) {
      q = ((q << 2) | u64(code(s[j + k - 1]))) & kmask;
      grams[j] = q;
      hxs[j] = mix(q);
    }
    constexpr i32 PF = 16;
    for (i32 j = 0; j < ngrams; j++) {  // pass 1: count per key
      if (j + PF < ngrams) __builtin_prefetch(&tags[hxs[j + PF] & mask]);
      u64 slot = find_slot(grams[j], hxs[j]);
      tags[slot] = (uint8_t)(hxs[j] >> 56) | 1;
      keys[slot] = grams[j];
      cnts[slot]++;
    }
    i32 acc = 0;  // pass 2: prefix-sum group offsets
    for (u64 t = 0; t < cap; t++) {
      offs[t] = acc;
      acc += cnts[t];
      cnts[t] = 0;  // reused as fill cursor in pass 3
    }
    positions.resize(acc);
    for (i32 j = 0; j < ngrams; j++) {  // pass 3: place positions
      if (j + PF < ngrams) __builtin_prefetch(&tags[hxs[j + PF] & mask]);
      u64 slot = find_slot(grams[j], hxs[j]);
      positions[offs[slot] + cnts[slot]++] = j;
    }
  }

  template <typename F>
  void lookup(u64 key, F f) const {
    if (keys.empty()) return;
    u64 slot = find_slot(key, mix(key));
    if (tags[slot] == 0) return;
    const i32* p = positions.data() + offs[slot];
    for (i32 t = 0; t < cnts[slot]; t++) f(p[t]);
  }
};

// Find matches; transform-filtered for GCSH (`matches.rs:17-39,205-210`).
static std::vector<Match> find_matches(const uint8_t* a, i32 n,
                                       const uint8_t* b, i32 m,
                                       const Seeds& seeds, i32 k, i32 r,
                                       bool transform_filter) {
  std::vector<Match> out;
  Pos t_target = seeds.transform(Pos{n, m});
  auto keep = [&](const Match& mt) {
    if (!transform_filter) return true;
    Pos t = seeds.transform(mt.start);
    return t.i <= t_target.i && t.j <= t_target.j;
  };
  QgramHash tab[3];
  if (r == 1) {
    tab[1].build_sliding(b, m, k);
    i32 num_seeds = (n >= k) ? n / k : 0;
    for (i32 s = 0; s < num_seeds; s++) {
      i32 start = s * k;
      u64 q = qgram_of(a + start, k);
      tab[1].lookup(q, [&](i32 j) {
        Match mt{{start, j}, {start + k, j + k}, 0, 1};
        if (keep(mt)) out.push_back(mt);
      });
    }
  } else {  // r == 2
    for (i32 d = -1; d <= 1; d++) tab[d + 1].build_sliding(b, m, k + d);
    std::vector<u64> dels, subs, ins;
    i32 num_seeds = (n >= k) ? (n - k) / k + 1 : 0;
    // ~100 mutated q-grams per seed, each an O(1) probe into the
    // length-matched table (the r=2 hot path at long reads).
    for (i32 s = 0; s < num_seeds; s++) {
      i32 start = s * k;
      u64 q = qgram_of(a + start, k);
      auto probe = [&](i32 t, u64 w, i32 cost) {
        i32 dj = k + (t - 1);
        tab[t].lookup(w, [&](i32 j) {
          Match mt{{start, j}, {start + k, j + dj}, cost, 2};
          if (keep(mt)) out.push_back(mt);
        });
      };
      auto pf = [&](i32 t, u64 w) {
        __builtin_prefetch(&tab[t].tags[QgramHash::mix(w) & tab[t].mask]);
      };
      mutations(k, q, dels, subs, ins);
      // Prefetch every mutation's tag slot first: ~100 independent L3
      // loads per seed overlap instead of serializing.
      pf(1, q);
      for (u64 w : dels) pf(0, w);
      for (u64 w : subs) pf(1, w);
      for (u64 w : ins) pf(2, w);
      probe(1, q, 0);
      for (u64 w : dels) probe(0, w, 1);
      for (u64 w : subs) probe(1, w, 1);
      for (u64 w : ins) probe(2, w, 1);
    }
  }
  // Sort + dedup keeping lowest cost (`matches.rs:300-332`).
  std::sort(out.begin(), out.end(), [](const Match& x, const Match& y) {
    if (x.start.i != y.start.i) return x.start.i < y.start.i;
    if (x.start.j != y.start.j) return x.start.j < y.start.j;
    if (x.end.i != y.end.i) return x.end.i < y.end.i;
    if (x.end.j != y.end.j) return x.end.j < y.end.j;
    return x.cost < y.cost;
  });
  std::vector<Match> dedup;
  for (auto& mt : out) {
    if (!dedup.empty() && dedup.back().start == mt.start &&
        dedup.back().end == mt.end)
      continue;
    dedup.push_back(mt);
  }
  return dedup;
}

// --------------------------------------------------------- match pruner

struct MatchPruner {
  // Matches sorted by (LexPos(start), cost); shared objects with by_end.
  std::vector<Match> by_start;
  std::unordered_map<Pos, std::pair<i32, i32>, PosHash> start_index;
  std::vector<i32> by_end;  // indices into by_start, sorted by end
  std::unordered_map<Pos, std::pair<i32, i32>, PosHash> end_index;
  bool prune_start = false, prune_end = false, check_consistency = false;
  i32 num_pruned = 0;

  void build(std::vector<Match> ms, bool ps, bool pe, bool cc) {
    prune_start = ps; prune_end = pe; check_consistency = cc;
    std::sort(ms.begin(), ms.end(), [](const Match& x, const Match& y) {
      if (x.start.i != y.start.i) return x.start.i < y.start.i;
      if (x.start.j != y.start.j) return x.start.j < y.start.j;
      return x.cost < y.cost;
    });
    by_start = std::move(ms);
    for (i32 i = 0; i < (i32)by_start.size();) {
      i32 j = i;
      while (j < (i32)by_start.size() && by_start[j].start == by_start[i].start) j++;
      start_index[by_start[i].start] = {i, j};
      i = j;
    }
    if (prune_end) {
      by_end.resize(by_start.size());
      for (i32 i = 0; i < (i32)by_end.size(); i++) by_end[i] = i;
      std::sort(by_end.begin(), by_end.end(), [&](i32 x, i32 y) {
        const Match &mx = by_start[x], &my = by_start[y];
        if (mx.end.i != my.end.i) return mx.end.i < my.end.i;
        if (mx.end.j != my.end.j) return mx.end.j < my.end.j;
        return mx.cost < my.cost;
      });
      for (i32 i = 0; i < (i32)by_end.size();) {
        i32 j = i;
        while (j < (i32)by_end.size() &&
               by_start[by_end[j]].end == by_start[by_end[i]].end)
          j++;
        end_index[by_start[by_end[i]].end] = {i, j};
        i = j;
      }
    }
  }

  i32 max_score_for(Pos start, Pos end) const {
    auto it = start_index.find(start);
    if (it == start_index.end()) return 0;
    i32 best = 0;
    for (i32 i = it->second.first; i < it->second.second; i++) {
      const Match& mt = by_start[i];
      if (!mt.pruned && mt.end == end) best = std::max(best, mt.score());
    }
    return best;
  }

  // `prune.rs:328-349`
  bool consistent(const Match& mt) const {
    if (!check_consistency || mt.cost == 0) return true;
    i32 sc = mt.score();
    Pos s = mt.start, e = mt.end;
    if (max_score_for({s.i, s.j + 1}, e) > sc) return false;
    if (max_score_for({s.i, s.j - 1}, e) > sc) return false;
    if (max_score_for(s, {e.i, e.j + 1}) > sc) return false;
    if (max_score_for(s, {e.i, e.j - 1}) > sc) return false;
    return true;
  }

  // Per-position prune (`prune.rs:213-240`); returns #pruned.
  i32 prune(const Seeds& seeds, Pos pos) {
    i32 cnt = 0;
    if (prune_start && seeds.is_seed_start(pos)) {
      auto it = start_index.find(pos);
      if (it != start_index.end())
        for (i32 i = it->second.first; i < it->second.second; i++) {
          Match& mt = by_start[i];
          if (!mt.pruned && consistent(mt)) { mt.pruned = true; cnt++; }
        }
    }
    if (prune_end && seeds.is_seed_end(pos)) {
      auto it = end_index.find(pos);
      if (it != end_index.end())
        for (i32 i = it->second.first; i < it->second.second; i++) {
          Match& mt = by_start[by_end[i]];
          if (!mt.pruned && consistent(mt)) { mt.pruned = true; cnt++; }
        }
    }
    num_pruned += cnt;
    return cnt;
  }
};

// ------------------------------------------------------------- contours

// One contour layer: the point set with a given chain value.  Linear scans
// with move-to-front (layers average ~1.5 points; semantics of the
// reference's RotateToFrontContour, `rotate_to_front.rs:10-97`).
struct Layer {
  std::vector<Pos> points;

  bool contains(Pos q) {
    for (size_t t = 0; t < points.size(); t++) {
      const Pos p = points[t];
      if (q.i <= p.i && q.j <= p.j) {
        if (t > 0) {  // move to front
          points.erase(points.begin() + t);
          points.insert(points.begin(), p);
        }
        return true;
      }
    }
    return false;
  }
  bool contains_equal(Pos q) const {
    for (const Pos& p : points)
      if (p == q) return true;
    return false;
  }
  bool prune(Pos p) {
    for (size_t t = 0; t < points.size(); t++)
      if (points[t] == p) {
        points.erase(points.begin() + t);
        return true;
      }
    return false;
  }
  size_t len() const { return points.size(); }
};

// Layered contours with hint queries and incremental ripple pruning —
// the faithful re-implementation of `hint_contours.rs:12-637`:
//
// - layer v holds the start points whose chain value is exactly v; layer 0
//   holds a sentinel "match at the end".
// - queries probe the max_len-window above v (`is_score_at_least`,
//   `hint_contours.rs:125-133`) since consecutive chain values can differ
//   by up to the max arrow score.
// - `prune_with_hint` moves the pruned point down to its recomputed value
//   and ripples updates upward layer by layer, stopping after
//   max_len + shift - 1 unchanged layers; layers that empty out while every
//   point above depended on the pruned region are removed entirely, which
//   raises h globally below the search tip — the O(1) priority-queue shift
//   (`hint_contours.rs:348-457,459-637`).
struct HintContours {
  std::vector<Layer> contours;  // contours[v] = layer v; [0] = sentinel
  i32 max_len = 1;
  i32 layers_removed = 0;

  static constexpr u32 HINT_NONE = 0x7FFFFFFF;

  void init(i32 max_len_) {
    max_len = max_len_;
    layers_removed = 0;
    contours.assign(1, Layer{});
    contours[0].points.push_back(Pos{INF, INF});
  }

  i32 num_layers() const { return (i32)contours.size(); }

  // First layer in [v, v+max_len) containing q, or -1.
  i32 is_score_at_least(Pos q, i32 v) {
    for (i32 w = v; w < std::min(v + max_len, num_layers()); w++)
      if (contours[w].contains(q)) return w;
    return -1;
  }

  i32 score(Pos q) {
    i32 low = 0, high = num_layers();
    while (high - low > 1) {
      i32 mid = (low + high) / 2;
      i32 w = is_score_at_least(q, mid);
      if (w >= 0) low = w; else high = mid;
    }
    return low;
  }

  // Hint = layer + layers_removed at query time (`hint_contours.rs:285-344`).
  i32 score_with_hint(Pos q, u32& hint) {
    i32 v = std::min<i32>(
        (i32)std::max<i64>(0, (i64)hint - layers_removed), num_layers() - 1);
    constexpr i32 SEARCH_RANGE = 5;
    i32 w0 = is_score_at_least(q, v);
    if (w0 >= 0) {
      i32 best = w0;
      i32 upper = std::min(w0 + SEARCH_RANGE + 2, num_layers());
      for (i32 w = w0 + 1; w <= upper; w++) {
        if (w < num_layers() && contours[w].contains(q)) best = w;
        if (w == num_layers() || w >= best + max_len) {
          hint = u32(best + layers_removed);
          return best;
        }
      }
    } else {
      for (i32 w = v - 1; w >= std::max(0, v - SEARCH_RANGE); w--) {
        if (contours[w].contains(q)) {
          hint = u32(w + layers_removed);
          return w;
        }
      }
    }
    i32 w = score(q);
    hint = u32(w + layers_removed);
    return w;
  }

  // Max over arrows from pos of (end-layer + score), searching each end's
  // layer linearly downward from v-1 (`hint_contours.rs:162-208`).
  template <typename ArrowsFn>
  i32 chain_score(const ArrowsFn& arrows, Pos pos, i32 v) {
    i32 max_score = 0;
    bool any = false;
    arrows(pos, [&](Pos end, i32 score) {
      any = true;
      i32 end_layer = v - 1;
      while (!contours[end_layer].contains(end)) {
        end_layer--;
        if (end_layer + score <= max_score) return;
      }
      max_score = std::max(max_score, end_layer + score);
    });
    return any ? max_score : -1;  // -1: no active arrows here
  }

  // Build from arrow groups in decreasing LexPos(start) order
  // (`hint_contours.rs:213-254`).
  void push_start(Pos start, i32 v) {
    if (v <= 0) return;
    while (num_layers() <= v) contours.emplace_back();
    contours[v].points.push_back(start);
  }

  // Prune point p (its arrows already removed from the arrow set).
  // Returns (changed, layers removed globally) (`hint_contours.rs:348-457`).
  template <typename ArrowsFn>
  std::pair<bool, i32> prune_with_hint(Pos p, u32 hint, const ArrowsFn& arrows) {
    i32 v = score_with_hint(p, hint);
    // The point's own layer can be anywhere in (v - max_len, v].
    i32 found = -1;
    for (i32 w = v; w >= std::max(0, v - max_len); w--)
      if (contours[w].contains_equal(p)) { found = w; break; }
    if (found < 0) return {false, 0};  // already gone
    v = found;
    assert(v > 0);

    i32 new_score = chain_score(arrows, p, v);
    i32 first_to_check = (new_score >= 0 ? new_score : v) + 1;
    if (new_score == v) return {false, 0};

    bool ok = contours[v].prune(p);
    assert(ok);
    (void)ok;
    if (new_score > 0) push_start(p, new_score);

    // If p's layer emptied and every point in the next max_len layers
    // depended on p, whole layers below become removable.
    i32 initial_shift = 0;
    if (contours[v].len() == 0) {
      bool all_depend = true;
      for (i32 w = v + 1; w < std::min(v + max_len, num_layers()) && all_depend;
           w++) {
        for (const Pos& pos : contours[w].points) {
          arrows(pos, [&](Pos end, i32) {
            if (!(end.i <= p.i && end.j <= p.j)) all_depend = false;
          });
          if (!all_depend) break;
        }
      }
      if (all_depend) {
        for (i32 w = v; w >= 0; w--) {
          if (contours[w].len() > 0) break;
          contours.erase(contours.begin() + w);
          layers_removed++;
          first_to_check = std::min(first_to_check, w);
          initial_shift++;
        }
      }
    }

    update_layers(first_to_check, v, arrows);
    return {true, initial_shift};
  }

  // Ripple updates from layer `v` upward (`hint_contours.rs:459-637`).
  template <typename ArrowsFn>
  void update_layers(i32 v, i32 last_change, const ArrowsFn& arrows) {
    v = std::max(v, 1);
    last_change = std::max(last_change, v);
    // Rolling shift state: -1 = none, -2 = inconsistent, else the shift.
    i32 rolling_shift = -1;
    i32 fully_shifted_layers = 0;

    for (v = v; v < num_layers(); v++) {
      bool changes = false;
      i32 current_shift = -1;  // -1 none, -2 inconsistent
      // Re-place every point whose value dropped below v.
      auto& pts = contours[v].points;
      for (size_t t = 0; t < pts.size();) {
        Pos pos = pts[t];
        i32 nl = chain_score(arrows, pos, v);
        if (nl < 0) {
          // No arrows left: drop the point.
          pts.erase(pts.begin() + t);
          changes = true;
          current_shift = -2;
          continue;
        }
        assert(nl <= v);
        if (nl == v) {
          current_shift = -2;
          t++;
          continue;
        }
        // merge Shift::Layers(v - nl)
        i32 s = v - nl;
        if (current_shift == -1) current_shift = s;
        else if (current_shift != s) current_shift = -2;
        pts.erase(pts.begin() + t);
        push_start(pos, nl);
        changes = true;
      }

      if (changes) last_change = std::max(last_change, v);
      if (v >= last_change + max_len) break;  // no further changes possible

      if (contours[v].len() == 0 && current_shift != -2) {
        if (rolling_shift == -1 || current_shift == -1 ||
            rolling_shift == current_shift) {
          fully_shifted_layers++;
          if (rolling_shift == -1) rolling_shift = current_shift;
        }
      } else {
        fully_shifted_layers = 0;
        rolling_shift = -1;
      }

      if (rolling_shift > 0 && v >= last_change &&
          fully_shifted_layers >= max_len + rolling_shift - 1) {
        // All remaining layers shift down together: remove the empties.
        for (i32 s = 0; s < rolling_shift; s++) {
          assert(contours[v].len() == 0);
          contours.erase(contours.begin() + v);
          layers_removed++;
          v--;
        }
        break;
      }
    }
  }
};

// ------------------------------------------------------------ heuristic

struct GCSHInstance {
  Seeds seeds;
  MatchPruner pruner;
  HintContours contours;
  // Transformed start -> original start (the transform is injective per i).
  std::unordered_map<Pos, Pos, PosHash> t2orig;
  bool use_gap_cost = true;
  bool prune_enabled = true;
  Pos target, t_target;
  Pos max_transformed_pos{INT32_MIN / 4, INT32_MIN / 4};
  i64 h_calls = 0, prune_calls = 0;
  i32 num_matches = 0;

  // Active arrows from a *transformed* start position; cb(t_end, score).
  template <typename Cb>
  void arrows_at(Pos t_start, Cb cb) const {
    auto it = t2orig.find(t_start);
    if (it == t2orig.end()) return;
    auto rng = pruner.start_index.find(it->second);
    if (rng == pruner.start_index.end()) return;
    for (i32 t = rng->second.first; t < rng->second.second; t++) {
      const Match& mt = pruner.by_start[t];
      if (mt.pruned) continue;
      Pos te = use_gap_cost ? seeds.transform(mt.end) : mt.end;
      if (te.i <= t_target.i && te.j <= t_target.j) cb(te, mt.score());
    }
  }

  void build(const uint8_t* a, i32 n, const uint8_t* b, i32 m, i32 k, i32 r,
             i32 prune_mode, bool gap) {
    use_gap_cost = gap;
    const char* prof = getenv("ASTARPA_NATIVE_PROFILE");
    auto now = [] {
      timespec ts;
      clock_gettime(CLOCK_MONOTONIC, &ts);
      return ts.tv_sec + 1e-9 * ts.tv_nsec;
    };
    double t0 = prof ? now() : 0;
    seeds.build(n, k, r);
    target = Pos{n, m};
    t_target = gap ? seeds.transform(target) : target;
    auto ms = find_matches(a, n, b, m, seeds, k, r, gap);
    double t1 = prof ? now() : 0;
    num_matches = (i32)ms.size();
    bool ps = prune_mode == 1 || prune_mode == 3;
    bool pe = prune_mode == 2 || prune_mode == 3;
    prune_enabled = prune_mode != 0;
    pruner.build(std::move(ms), ps, pe, gap);
    double t2 = prof ? now() : 0;
    if (prof)
      fprintf(stderr, "  [gcsh.build] matches=%.3fs (m=%d) pruner=%.3fs\n",
              t1 - t0, num_matches, t2 - t1);

    // Build contours from arrow groups in decreasing LexPos(start) order
    // (`hint_contours.rs:213-254`).
    contours.init(r);
    const auto& msv = pruner.by_start;
    i32 idx = (i32)msv.size() - 1;
    while (idx >= 0) {
      i32 lo = idx;
      while (lo >= 0 && msv[lo].start == msv[idx].start) lo--;
      Pos start = msv[idx].start;
      Pos tstart = use_gap_cost ? seeds.transform(start) : start;
      t2orig[tstart] = start;
      i32 v = 0;
      for (i32 t = idx; t > lo; t--) {
        const Match& mt = msv[t];
        Pos te = use_gap_cost ? seeds.transform(mt.end) : mt.end;
        if (!(te.i <= t_target.i && te.j <= t_target.j)) continue;
        v = std::max(v, contours.score(te) + mt.score());
      }
      contours.push_start(tstart, v);
      idx = lo;
    }
    if (prof)
      fprintf(stderr, "  [gcsh.build] contours=%.3fs\n", now() - t2);
  }

  Pos transform(Pos p) const { return use_gap_cost ? seeds.transform(p) : p; }

  i32 distance(Pos from, Pos to) const {
    i32 pd = seeds.potential_distance(from, to);
    if (use_gap_cost) {
      i32 gap = std::abs((to.i - from.i) - (to.j - from.j));
      return std::max(gap, pd);
    }
    return pd;
  }

  i32 h_with_hint(Pos pos, u32& hint) {
    h_calls++;
    i32 p = seeds.pot(pos);
    i32 val = contours.score_with_hint(transform(pos), hint);
    if (val == 0) return distance(pos, target);
    return p - val;
  }

  i32 root_potential() const { return seeds.potential[0]; }

  void explore(Pos pos) {
    Pos t = transform(pos);
    max_transformed_pos.i = std::max(max_transformed_pos.i, t.i);
    max_transformed_pos.j = std::max(max_transformed_pos.j, t.j);
  }

  // Prune matches at pos; returns the sound queue-shift amount
  // (`csh.rs:393-468`).
  i32 prune(Pos pos, u32 hint) {
    if (!prune_enabled) return 0;
    prune_calls++;
    std::vector<Pos> starts;
    i32 cnt = 0;
    {
      // Collect distinct start positions of matches pruned here.
      auto collect = [&](Pos s) {
        for (Pos q : starts)
          if (q == s) return;
        starts.push_back(s);
      };
      // Re-implement pruner.prune with a callback on each pruned match.
      if (pruner.prune_start && seeds.is_seed_start(pos)) {
        auto it = pruner.start_index.find(pos);
        if (it != pruner.start_index.end())
          for (i32 t = it->second.first; t < it->second.second; t++) {
            Match& mt = pruner.by_start[t];
            if (!mt.pruned && pruner.consistent(mt)) {
              mt.pruned = true;
              cnt++;
              collect(mt.start);
            }
          }
      }
      if (pruner.prune_end && seeds.is_seed_end(pos)) {
        auto it = pruner.end_index.find(pos);
        if (it != pruner.end_index.end())
          for (i32 t = it->second.first; t < it->second.second; t++) {
            Match& mt = pruner.by_start[pruner.by_end[t]];
            if (!mt.pruned && pruner.consistent(mt)) {
              mt.pruned = true;
              cnt++;
              collect(mt.start);
            }
          }
      }
    }
    pruner.num_pruned += cnt;
    if (cnt == 0) return 0;

    // Remove from the contours left to right (`csh.rs:436-440`).
    std::sort(starts.begin(), starts.end(), lex_less);
    Pos tpos = transform(pos);
    i32 change = 0;
    auto arrows = [this](Pos ts, auto cb) { this->arrows_at(ts, cb); };
    for (Pos s : starts) {
      Pos ts = transform(s);
      auto [changed, c] = contours.prune_with_hint(ts, hint, arrows);
      (void)changed;
      if (s == pos) {
        // For GCSH the shift only propagates when the pruned position
        // dominates everything explored (`csh.rs:452-459`).
        if (!use_gap_cost || (max_transformed_pos.i <= tpos.i &&
                              max_transformed_pos.j <= tpos.j))
          change = c;
      }
    }
    return change;
  }
};

// ----------------------------------------------------------- bucket queue

struct QueueElem { Pos pos; i32 g; };

struct BucketQueue {
  std::vector<std::vector<QueueElem>> layers;
  size_t next = 0, size = 0;

  void push(i32 f, QueueElem e) {
    if ((size_t)f >= layers.size()) layers.resize(f + 1);
    if ((size_t)f < next) next = f;
    layers[f].push_back(e);
    size++;
  }
  bool pop(i32& f, QueueElem& e) {
    if (size == 0) return false;
    while (layers[next].empty()) next++;
    f = (i32)next;
    e = layers[next].back();
    layers[next].pop_back();
    size--;
    if (size == 0) next = 0;
    return true;
  }
};

// ----------------------------------------------------------------- A*

struct Stats {
  i64 expanded = 0, explored = 0, extended = 0, reordered = 0, pruned = 0;
  i64 pq_shifts = 0;
};

struct CigarBuilder {
  std::string s;
  char last = 0;
  i64 cnt = 0;
  void push(char op, i64 c = 1) {
    if (op == last) { cnt += c; return; }
    flush();
    last = op; cnt = c;
  }
  void flush() {
    if (cnt > 0) { s += std::to_string(cnt); s += last; }
    last = 0; cnt = 0;
  }
};

// Plain A* over Pos states (`astar.rs:35-261`).
static i32 astar_pos(const uint8_t* a, i32 n, const uint8_t* b, i32 m,
                     GCSHInstance& h, Stats& st, std::string& cigar_out) {
  struct State { i32 g = INF; u32 hint = HintContours::HINT_NONE; };
  std::unordered_map<Pos, State, PosHash> states;
  BucketQueue queue;
  // ShiftQueue semantics (`bucket_queue.rs:111-229`): stored keys carry
  // down_shift; pruning below the tip decreases it, raising all stored
  // elements in O(1).
  i32 down_shift = h.root_potential();
  Pos tip{0, 0};  // max pushed position, component-wise

  Pos start{0, 0}, target{n, m};
  u32 hint0 = HintContours::HINT_NONE;
  i32 hroot = h.h_with_hint(start, hint0);
  states[start] = {0, hint0};
  queue.push(hroot + down_shift, {start, 0});
  st.explored++;

  while (true) {
    i32 qf = 0; QueueElem qe{};
    bool ok = queue.pop(qf, qe);
    assert(ok && "queue empty before target");
    (void)ok;
    qf -= down_shift;
    Pos pos = qe.pos;
    i32 qg = qe.g;
    auto& state = states[pos];
    if (qg > state.g) continue;

    i32 ch = h.h_with_hint(pos, state.hint);
    i32 cf = state.g + ch;
    assert(cf >= qf);
    if (cf > qf) {
      st.reordered++;
      queue.push(cf + down_shift, {pos, qg});
      continue;
    }
    st.expanded++;
    if (pos == target) break;

    i32 g = state.g;
    u32 hint = state.hint;

    if (h.seeds.is_seed_start_or_end(pos)) {
      i32 sh = h.prune(pos, hint);
      if (sh > 0 && tip.i <= pos.i && tip.j <= pos.j) {
        assert(sh <= down_shift);
        down_shift -= sh;
        st.pq_shifts++;
      }
    }

    // Outgoing edges; greedy matching shadows indels on a match
    // (`alignment_graph.rs:155-183`).
    bool is_match = pos.i < n && pos.j < m && a[pos.i] == b[pos.j];
    Pos nexts[3]; i32 costs[3]; i32 cnt = 0;
    if (is_match) {
      nexts[cnt] = {pos.i + 1, pos.j + 1}; costs[cnt++] = 0;
    } else {
      if (pos.i + 1 <= n) { nexts[cnt] = {pos.i + 1, pos.j}; costs[cnt++] = 1; }
      if (pos.j + 1 <= m) { nexts[cnt] = {pos.i, pos.j + 1}; costs[cnt++] = 1; }
      if (pos.i + 1 <= n && pos.j + 1 <= m) {
        nexts[cnt] = {pos.i + 1, pos.j + 1}; costs[cnt++] = 1;
      }
    }
    for (i32 e = 0; e < cnt; e++) {
      Pos next = nexts[e];
      i32 next_g = g + costs[e];
      // Greedy diagonal extension within the seed (`astar.rs:181-204`).
      while (next.i < n && next.j < m && a[next.i] == b[next.j] &&
             !h.seeds.is_seed_start_or_end(next)) {
        st.extended++;
        next = {next.i + 1, next.j + 1};
      }
      auto [it, inserted] = states.try_emplace(next);
      if (!inserted && it->second.g <= next_g) continue;
      u32 nh_hint = hint;
      i32 nh = h.h_with_hint(next, nh_hint);
      it->second.g = next_g;
      it->second.hint = nh_hint;
      queue.push(next_g + nh + down_shift, {next, next_g});
      tip.i = std::max(tip.i, next.i);
      tip.j = std::max(tip.j, next.j);
      h.explore(next);
      st.explored++;
    }
  }

  // Traceback by g-differences (`astar.rs:263-301`).
  i32 dist = states[target].g;
  Pos cur = target;
  i32 costleft = dist;
  std::string rev;
  while (!(cur == start)) {
    auto gval = [&](Pos p) -> i32 {
      auto it = states.find(p);
      return it == states.end() ? INF : it->second.g;
    };
    char op = 0;
    Pos par;
    if (cur.i > 0 && cur.j > 0 && gval({cur.i - 1, cur.j - 1}) + 1 == costleft &&
        a[cur.i - 1] != b[cur.j - 1]) {
      op = 'X'; par = {cur.i - 1, cur.j - 1}; costleft -= 1;
    } else if (cur.i > 0 && gval({cur.i - 1, cur.j}) + 1 == costleft) {
      op = 'D'; par = {cur.i - 1, cur.j}; costleft -= 1;
    } else if (cur.j > 0 && gval({cur.i, cur.j - 1}) + 1 == costleft) {
      op = 'I'; par = {cur.i, cur.j - 1}; costleft -= 1;
    } else {
      op = '='; par = {cur.i - 1, cur.j - 1};
      assert(cur.i > 0 && cur.j > 0 && a[cur.i - 1] == b[cur.j - 1]);
    }
    rev += op;
    cur = par;
  }
  assert(costleft == 0);
  CigarBuilder cb;
  for (auto it = rev.rbegin(); it != rev.rend(); ++it) cb.push(*it);
  cb.flush();
  cigar_out = std::move(cb.s);
  st.pruned = h.pruner.num_pruned;
  return dist;
}

// A* over DT states (`astar_dt.rs:34-338`).
static i32 astar_dt(const uint8_t* a, i32 n, const uint8_t* b, i32 m,
                    GCSHInstance& h, Stats& st, std::string& cigar_out) {
  struct DtKey {
    i32 d, g;
    bool operator==(const DtKey& o) const { return d == o.d && g == o.g; }
  };
  struct DtHash {
    size_t operator()(const DtKey& k) const {
      return std::hash<u64>()((u64(u32(k.d)) << 32) | u32(k.g));
    }
  };
  struct State { i32 fr = -1; u32 hint = HintContours::HINT_NONE; };
  std::unordered_map<DtKey, State, DtHash> states;
  BucketQueue queue;
  i32 down_shift = h.root_potential();
  Pos tip{0, 0};

  Pos start{0, 0}, target{n, m};
  u32 hint0 = HintContours::HINT_NONE;
  i32 hroot = h.h_with_hint(start, hint0);
  states[{0, 0}] = {0, hint0};
  queue.push(hroot + down_shift, {start, 0});
  st.explored++;
  i32 dist = -1;

  while (true) {
    i32 qf = 0; QueueElem qe{};
    bool ok = queue.pop(qf, qe);
    assert(ok && "queue empty before target");
    (void)ok;
    qf -= down_shift;
    Pos pos = qe.pos;
    i32 qg = qe.g;
    DtKey key{pos.i - pos.j, qg};
    i32 qfr = pos.i + pos.j;
    auto& state = states[key];
    if (qfr < state.fr) continue;
    assert(qfr == state.fr);

    i32 ch = h.h_with_hint(pos, state.hint);
    i32 cf = qg + ch;
    assert(cf >= qf);
    if (cf > qf) {
      st.reordered++;
      queue.push(cf + down_shift, {pos, qg});
      continue;
    }
    st.expanded++;
    if (pos == target) { dist = qg; break; }

    u32 hint = state.hint;
    if (h.seeds.is_seed_start_or_end(pos)) {
      i32 sh = h.prune(pos, hint);
      if (sh > 0 && tip.i <= pos.i && tip.j <= pos.j) {
        assert(sh <= down_shift);
        down_shift -= sh;
        st.pq_shifts++;
      }
    }

    bool is_match = pos.i < n && pos.j < m && a[pos.i] == b[pos.j];
    Pos nexts[3]; i32 costs[3]; i32 cnt = 0;
    if (is_match) {
      nexts[cnt] = {pos.i + 1, pos.j + 1}; costs[cnt++] = 0;
    } else {
      if (pos.i + 1 <= n) { nexts[cnt] = {pos.i + 1, pos.j}; costs[cnt++] = 1; }
      if (pos.j + 1 <= m) { nexts[cnt] = {pos.i, pos.j + 1}; costs[cnt++] = 1; }
      if (pos.i + 1 <= n && pos.j + 1 <= m) {
        nexts[cnt] = {pos.i + 1, pos.j + 1}; costs[cnt++] = 1;
      }
    }
    for (i32 e = 0; e < cnt; e++) {
      Pos next = nexts[e];
      i32 next_g = qg + costs[e];
      DtKey nkey{next.i - next.j, next_g};
      auto [it, inserted] = states.try_emplace(nkey);
      if (!inserted && it->second.fr >= next.i + next.j) continue;
      while (next.i < n && next.j < m && a[next.i] == b[next.j] &&
             !h.seeds.is_seed_start_or_end(next)) {
        st.extended++;
        next = {next.i + 1, next.j + 1};
      }
      u32 nh_hint = hint;
      i32 nh = h.h_with_hint(next, nh_hint);
      it->second.fr = next.i + next.j;
      it->second.hint = nh_hint;
      queue.push(next_g + nh + down_shift, {next, next_g});
      tip.i = std::max(tip.i, next.i);
      tip.j = std::max(tip.j, next.j);
      h.explore(next);
      st.explored++;
    }
  }

  // Ukkonen-style DT traceback (`astar_dt.rs:266-338`).
  auto fr_of = [&](DtKey k) -> i32 {
    auto it = states.find(k);
    return it == states.end() ? -1 : it->second.fr;
  };
  std::string rev;
  Pos cur = target;
  DtKey cd{n - m, dist};
  i32 costchk = 0;
  while (!(cd.d == 0 && cd.g == 0)) {
    // Farthest-reaching parent among Right(D), Down(I), Sub(X)
    // with edge to_f preferences as in `astar_dt.rs:267-281`.
    struct Cand { DtKey k; char op; i32 tof; };
    Cand cands[3] = {
        {{cd.d - 1, cd.g - 1}, 'D', 1},
        {{cd.d + 1, cd.g - 1}, 'I', 0},
        {{cd.d, cd.g - 1}, 'X', 1},
    };
    i32 best = -1; char bop = 0; DtKey bk{0, 0}; i32 btof = 0;
    for (auto& c : cands) {
      if (c.k.g < 0) continue;
      i32 fr = fr_of(c.k);
      if (fr < 0) continue;
      if (fr + c.tof >= best + btof) { best = fr; bop = c.op; bk = c.k; btof = c.tof; }
    }
    assert(bop != 0);
    Pos next_pos{(best + bk.d) / 2, (best - bk.d) / 2};
    // Matches until the edge lands exactly on next_pos.
    auto back = [&](Pos p, char op) -> Pos {
      if (op == 'X') return {p.i - 1, p.j - 1};
      if (op == 'D') return {p.i - 1, p.j};
      return {p.i, p.j - 1};
    };
    while (true) {
      Pos bp = back(cur, bop);
      if (bp.i >= next_pos.i && bp.j >= next_pos.j &&
          (bp.i > next_pos.i || bp.j > next_pos.j)) {
        rev += '=';
        cur = {cur.i - 1, cur.j - 1};
      } else break;
    }
    cur = back(cur, bop);
    rev += bop;
    costchk++;
    cd = bk;
  }
  while (!(cur == start)) {
    rev += '=';
    cur = {cur.i - 1, cur.j - 1};
  }
  assert(costchk == dist);
  CigarBuilder cb;
  for (auto it = rev.rbegin(); it != rev.rend(); ++it) cb.push(*it);
  cb.flush();
  cigar_out = std::move(cb.s);
  st.pruned = h.pruner.num_pruned;
  return dist;
}

}  // namespace

// ----------------------------------------------------------------- C ABI

extern "C" {

// Align with GCSH (use_gap_cost=1) or CSH (0); prune: 0 none, 1 start,
// 2 end, 3 both; dt: diagonal-transition state space.  Returns the exact
// edit distance; *cigar_out is malloc'd (free with astarpa_free).
// stats_out (optional, len>=5): expanded, explored, extended, reordered,
// pruned.
int astarpa_align(const uint8_t* a, int n, const uint8_t* b, int m, int r,
                  int k, int prune, int dt, int use_gap_cost,
                  char** cigar_out, int64_t* stats_out) {
  GCSHInstance h;
  h.build(a, n, b, m, k, r, prune, use_gap_cost != 0);
  Stats st;
  std::string cig;
  int dist = dt ? astar_dt(a, n, b, m, h, st, cig)
                : astar_pos(a, n, b, m, h, st, cig);
  if (cigar_out) {
    *cigar_out = (char*)malloc(cig.size() + 1);
    memcpy(*cigar_out, cig.c_str(), cig.size() + 1);
  }
  if (stats_out) {
    stats_out[0] = st.expanded;
    stats_out[1] = st.explored;
    stats_out[2] = st.extended;
    stats_out[3] = st.reordered;
    stats_out[4] = st.pruned;
  }
  return dist;
}

// Default parameters of the reference's `astarpa()` (r=2, k=15,
// prune-start, DT).
int astarpa(const uint8_t* a, int n, const uint8_t* b, int m,
            char** cigar_out) {
  return astarpa_align(a, n, b, m, 2, 15, 1, 1, 1, cigar_out, nullptr);
}

// `astarpa_gcsh` parity (astarpa-c/src/lib.rs:69-95).
int astarpa_gcsh(const uint8_t* a, int n, const uint8_t* b, int m, int r,
                 int k, int prune_end, char** cigar_out) {
  return astarpa_align(a, n, b, m, r, k, prune_end ? 3 : 1, 1, 1, cigar_out,
                       nullptr);
}

void astarpa_free(char* p) { free(p); }

// Static forward+reverse GCSH domain (the heuristic-restricted computation
// of the reference — `astarpa2/src/domain.rs:117-235` — re-shaped for a
// device band: instead of using DP values g(u) (which would need a
// device round-trip per block), g is lower-bounded by a *reverse* GCSH
// built on the reversed sequences, so the whole domain
//   D(f_max) = { (i,j) : h_rev(i,j) + h_fwd(i,j) <= f_max }
// is computable up front.  Every cell of any path with cost <= f_max lies
// in D (both heuristics are admissible), so a banded DP covering D is
// exact whenever its result is <= f_max.
//
// Sampled every `step` columns with target f_max + 2*step: consistency
// (|f| changes <= 2 per unit step in i or j) makes the sample intervals
// cover all columns within +-step, and jumps of ceil((f-target)/2) rows
// can never skip an in-target cell, so out_lo/out_hi are the exact
// interval hull per sampled column.
//
// out_lo/out_hi: n_samples = n/step + 2 entries for columns
// (0, step, 2*step, ..., n).  h0_out: h_fwd(0,0), the f-ladder start.
// Returns 0, or -1 if a sampled column's domain is empty (f_max too
// small; retry with a larger f_max).
// Block DP backend for the astarpa2 host driver (`blocks.rs:686-748`,
// `simd.rs:326-437` roles): one Myers uint32 column chain per column with
// top h inputs and bottom h outputs.  Bit-identical to
// astarpa_tpu/ops/myers.py::step_word / block_kernel's jnp scans; the
// native path removes the per-block host<->device round trip that capped
// the parity tests at ~3kbp.
extern "C" void block_compute(const uint32_t* a0, const uint32_t* a1,
                              int ncols, const uint32_t* pb0,
                              const uint32_t* pb1, int nwords, uint32_t* vp,
                              uint32_t* vm, uint32_t* hp_io,
                              uint32_t* hm_io) {
  for (i32 c = 0; c < ncols; c++) {
    u32 ca0 = a0[c], ca1 = a1[c];
    u32 hp = hp_io[c], hm = hm_io[c];
    for (i32 w = 0; w < nwords; w++) {
      u32 eq = (ca0 ^ pb0[w]) & (ca1 ^ pb1[w]);
      u32 vpw = vp[w], vmw = vm[w];
      u32 vx = eq | vmw;
      u32 eq2 = eq | hm;
      u32 hx = (((eq2 & vpw) + vpw) ^ vpw) | eq2;
      u32 hpo = vmw | ~(hx | vpw);
      u32 hmo = vpw & hx;
      u32 hp_next = hpo >> 31, hm_next = hmo >> 31;
      hpo = (hpo << 1) | hp;
      hmo = (hmo << 1) | hm;
      vp[w] = hmo | ~(vx | hpo);
      vm[w] = hpo & vx;
      hp = hp_next;
      hm = hm_next;
    }
    hp_io[c] = hp;
    hm_io[c] = hm;
  }
}

// Fill variant: stores the v planes after every column (row-major
// (ncols, nwords)).
extern "C" void block_fill(const uint32_t* a0, const uint32_t* a1, int ncols,
                           const uint32_t* pb0, const uint32_t* pb1,
                           int nwords, uint32_t* vp, uint32_t* vm,
                           const uint32_t* hp_in, const uint32_t* hm_in,
                           uint32_t* vp_cols, uint32_t* vm_cols) {
  for (i32 c = 0; c < ncols; c++) {
    u32 ca0 = a0[c], ca1 = a1[c];
    u32 hp = hp_in[c], hm = hm_in[c];
    for (i32 w = 0; w < nwords; w++) {
      u32 eq = (ca0 ^ pb0[w]) & (ca1 ^ pb1[w]);
      u32 vpw = vp[w], vmw = vm[w];
      u32 vx = eq | vmw;
      u32 eq2 = eq | hm;
      u32 hx = (((eq2 & vpw) + vpw) ^ vpw) | eq2;
      u32 hpo = vmw | ~(hx | vpw);
      u32 hmo = vpw & hx;
      u32 hp_next = hpo >> 31, hm_next = hmo >> 31;
      hpo = (hpo << 1) | hp;
      hmo = (hmo << 1) | hm;
      vp[w] = hmo | ~(vx | hpo);
      vm[w] = hpo & vx;
      hp = hp_next;
      hm = hm_next;
    }
    memcpy(vp_cols + (size_t)c * nwords, vp, (size_t)nwords * 4);
    memcpy(vm_cols + (size_t)c * nwords, vm, (size_t)nwords * 4);
  }
}

namespace {

struct DomainHandle {
  GCSHInstance hf, hr;
  i32 n, m, h0;
};

}  // namespace

// Build the fwd+rev instances once per pair; sampling at successive f_max
// values (the f ladder) reuses them.  Returns an opaque handle.
extern "C" void* gcsh_domain_new(const uint8_t* a, int n, const uint8_t* b,
                                 int m, int k, int r, int32_t* h0_out) {
  auto* h = new DomainHandle();
  h->n = n;
  h->m = m;
  const char* prof = getenv("ASTARPA_NATIVE_PROFILE");
  auto now = [] {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return ts.tv_sec + 1e-9 * ts.tv_nsec;
  };
  double t0 = prof ? now() : 0;
  h->hf.build(a, n, b, m, k, r, /*prune_mode=*/0, /*gap=*/true);
  double t1 = prof ? now() : 0;
  std::vector<uint8_t> ra(a, a + n), rb(b, b + m);
  std::reverse(ra.begin(), ra.end());
  std::reverse(rb.begin(), rb.end());
  h->hr.build(ra.data(), n, rb.data(), m, k, r, /*prune_mode=*/0, /*gap=*/true);
  if (prof)
    fprintf(stderr, "[gcsh_domain_new] fwd=%.3fs rev=%.3fs matches=%d\n",
            t1 - t0, now() - t1, h->hf.num_matches);
  u32 hint = HintContours::HINT_NONE;
  h->h0 = h->hf.h_with_hint(Pos{0, 0}, hint);
  if (h0_out) *h0_out = h->h0;
  return h;
}

extern "C" void gcsh_domain_del(void* hp) {
  delete static_cast<DomainHandle*>(hp);
}

// Sample the interval hull of D(f_max) at columns (0, step, ..., n):
// n/step + 2 entries.  Returns 0, or -1 if a sampled column is empty
// (f_max certainly below the true distance; retry larger).
extern "C" int gcsh_domain_sample(void* hp, int f_max, int step,
                                  int32_t* out_lo, int32_t* out_hi) {
  auto* h = static_cast<DomainHandle*>(hp);
  i32 n = h->n, m = h->m;
  u32 hint_f = HintContours::HINT_NONE, hint_r = HintContours::HINT_NONE;
  auto f = [&](i32 i, i32 j) -> i64 {
    i64 vf = h->hf.h_with_hint(Pos{i, j}, hint_f);
    i64 vr = h->hr.h_with_hint(Pos{n - i, m - j}, hint_r);
    return vf + vr;
  };
  i64 target = (i64)f_max + 2 * step;
  i32 ns = n / step + 2;
  for (i32 s = 0; s < ns; s++) {
    i32 i = std::min(s * step, n);
    // Lowest j with f <= target: jump down from 0; a jump of
    // ceil((f - target)/2) rows cannot skip an in-target cell
    // (consistency: |f| changes <= 2 per unit j).
    i64 jmin = 0;
    while (jmin <= m) {
      i64 fv = f(i, (i32)jmin);
      if (fv <= target) break;
      jmin += (fv - target + 1) / 2;
    }
    if (jmin > m) return -1;
    // Highest j with f <= target: jump up from m.
    i64 jmax = m;
    while (jmax >= jmin) {
      i64 fv = f(i, (i32)jmax);
      if (fv <= target) break;
      jmax -= (fv - target + 1) / 2;
    }
    if (jmax < jmin) return -1;
    out_lo[s] = (i32)jmin;
    out_hi[s] = (i32)jmax;
  }
  return 0;
}

extern "C" int gcsh_domain(const uint8_t* a, int n, const uint8_t* b, int m,
                           int k, int r, int f_max, int step,
                           int32_t* out_lo, int32_t* out_hi,
                           int32_t* h0_out) {
  void* h = gcsh_domain_new(a, n, b, m, k, r, h0_out);
  int rc = gcsh_domain_sample(h, f_max, step, out_lo, out_hi);
  gcsh_domain_del(h);
  return rc;
}

namespace {

// Shared banded-DP helpers for the checkpointed traceback: an exact C++
// twin of one column of `astarpa_tpu/ops/banded.py::banded_cost_block`
// (shift-before-column, h=+1 entering the window top, fresh +1/row words
// entering at the bottom).
struct BandedRecompute {
  const uint8_t* a;
  i32 n, m, S, SW;
  const i32* shift_at;  // (n,)
  std::vector<u32> pb0, pb1;  // negated packed b planes, padded code 3

  void init(const uint8_t* a_, i32 n_, const uint8_t* b, i32 m_, i32 S_,
            i32 SW_, const i32* shift_at_) {
    a = a_; n = n_; m = m_; SW = SW_; shift_at = shift_at_;
    // S is the *bucket's* padded profile width (rows >= m read as code 3,
    // matching ops.bitpack.pack_b).
    S = std::max(S_, std::max(1, (m + 31) / 32));
    pb0.assign(S, 0);
    pb1.assign(S, 0);
    for (i32 j = 0; j < S * 32; j++) {
      u32 c = j < m ? u32(code(b[j])) : 3;
      pb0[j / 32] |= u32(((c & 1) ^ 1)) << (j % 32);
      pb1[j / 32] |= u32((((c >> 1) & 1) ^ 1)) << (j % 32);
    }
  }

  // One column over the window; vp/vm have SW words; lo = window top word.
  void column(i32 col /*1-based*/, i32 lo, u32* vp, u32* vm) const {
    u32 ca = u32(code(a[col - 1]));
    u32 a0 = ca & 1 ? 0xFFFFFFFFu : 0;
    u32 a1 = (ca >> 1) & 1 ? 0xFFFFFFFFu : 0;
    u32 hp = 1, hm = 0;
    for (i32 w = 0; w < SW; w++) {
      i32 word = std::min(lo + w, S - 1);
      u32 eq = (a0 ^ pb0[word]) & (a1 ^ pb1[word]);
      u32 vpw = vp[w], vmw = vm[w];
      u32 vx = eq | vmw;
      u32 eq2 = eq | hm;
      u32 hx = (((eq2 & vpw) + vpw) ^ vpw) | eq2;
      u32 hpo = vmw | ~(hx | vpw);
      u32 hmo = vpw & hx;
      u32 hp_next = hpo >> 31, hm_next = hmo >> 31;
      hpo = (hpo << 1) | hp;
      hmo = (hmo << 1) | hm;
      vp[w] = hmo | ~(vx | hpo);
      vm[w] = hpo & vx;
      hp = hp_next;
      hm = hm_next;
    }
  }

  // Apply the pre-column shift for column `col` (1-based); returns the
  // absorbed word value (top_val delta) or 0.
  i32 maybe_shift(i32 col, i32& lo, u32* vp, u32* vm) const {
    if (!shift_at[col - 1]) return 0;
    i32 delta = __builtin_popcount(vp[0]) - __builtin_popcount(vm[0]);
    for (i32 w = 0; w + 1 < SW; w++) {
      vp[w] = vp[w + 1];
      vm[w] = vm[w + 1];
    }
    vp[SW - 1] = 0xFFFFFFFFu;
    vm[SW - 1] = 0;
    lo++;
    return delta;
  }
};

}  // namespace

// Traceback from per-block checkpoints of the banded DP: checkpoint k holds
// the window planes + top_val after column k*CB (checkpoint 0 = all-ones
// init; top_val now comes from the device, so no forward prefix DP runs on
// the host).  Between checkpoints the path is recovered by *backward
// greedy diagonal-transition bursts* (the re-expression of the reference's
// `dt_trace_block`, `astarpa2/src/blocks/trace.rs:231-416`): from the
// current position, farthest-back-reaching DT layers are grown until some
// state crosses the previous checkpoint column with a banded value that
// matches the checkpoint exactly; only when a burst exceeds its g budget
// does the O(CB*SW) stripe recompute fallback run (`trace.rs:71-125` role).
// Returns the banded cost and a malloc'd CIGAR, or -1.
extern "C" int trace_banded_ck_rows(const uint8_t* a, int n, const uint8_t* b,
                                    int m, int S, const uint32_t* ck_vp,
                                    const uint32_t* ck_vm,
                                    const int32_t* ck_tv, int n_ck_dev,
                                    const int32_t* shift_at, int SW, int CB,
                                    int use_dt, int ck_rows, int known_cost,
                                    char** cigar_out) {
  // Phase profile (ASTARPA_TRACE_PROF=1): one stderr line per call.
  static const bool kProf = getenv("ASTARPA_TRACE_PROF") != nullptr;
  auto now_ns = [] {
    timespec ts;
    clock_gettime(CLOCK_MONOTONIC, &ts);
    return double(ts.tv_sec) * 1e9 + double(ts.tv_nsec);
  };
  double prof_t0 = kProf ? now_ns() : 0, prof_init = 0, prof_burst = 0,
         prof_step = 0, prof_cig = 0;
  i32 prof_bursts = 0, prof_fails = 0;
  i64 prof_w = 0, prof_layers = 0;

  BandedRecompute rc;
  rc.init(a, n, b, m, S, SW, shift_at);

  // Checkpoint metadata: lo from the schedule prefix sum, top_val from the
  // device readback.
  i32 n_ck = n / CB + 1;  // checkpoints at columns 0, CB, 2CB, ...
  if (n_ck > n_ck_dev) n_ck = n_ck_dev;
  std::vector<i32> lo_ck(n_ck), tv_ck(n_ck);
  {
    i32 lo = 0;
    lo_ck[0] = 0;
    tv_ck[0] = ck_tv ? ck_tv[0] : 0;
    for (i32 k = 1; k < n_ck; k++) {
      for (i32 col = (k - 1) * CB; col < k * CB; col++)
        if (shift_at[col]) lo++;
      lo_ck[k] = lo;
      tv_ck[k] = ck_tv[k];
    }
  }

  // Checkpoint plane layout: ck_rows rows per checkpoint.  ck_rows == SW is
  // the classic contract (row 0 = the window top lo_ck[k]); ck_rows > SW is
  // the striped kernel's 8-ALIGNED-TOP contract — plane rows cover words
  // [lo&~7, lo&~7 + ck_rows), so the true SW-word window starts at row lo&7
  // (the <=7 pad rows above/below hold garbage and are never read).
  auto ck_off = [&](i32 k) -> size_t {
    size_t pad = ck_rows > SW ? (size_t)(lo_ck[k] & 7) : 0;
    return (size_t)k * ck_rows + pad;
  };

  // Stripe cache: planes, lo, top_val for columns (k*CB, (k+1)*CB].
  // Two slots: at a block-boundary column the traceback's dval calls
  // alternate between stripes k-1 and k, so a single-slot cache would
  // recompute the O(CB*SW) stripe up to twice per step there.
  struct Stripe {
    i32 k = -1;
    std::vector<u32> svp, svm;  // (cols+1, SW): index 0 = checkpoint state
    std::vector<i32> slo, stv;
  };
  Stripe stripes[2];
  i32 lru = 0;

  auto load_stripe = [&](i32 k) -> Stripe& {
    for (auto& s : stripes)
      if (s.k == k) return s;
    Stripe& s = stripes[lru];
    lru ^= 1;
    s.k = k;
    i32 cols = std::min(CB, n - k * CB);
    s.svp.assign((size_t)(cols + 1) * SW, 0);
    s.svm.assign((size_t)(cols + 1) * SW, 0);
    s.slo.assign(cols + 1, 0);
    s.stv.assign(cols + 1, 0);
    if (k == 0) {
      for (i32 w = 0; w < SW; w++) s.svp[w] = 0xFFFFFFFFu;
    } else {
      memcpy(s.svp.data(), ck_vp + ck_off(k), SW * 4);
      memcpy(s.svm.data(), ck_vm + ck_off(k), SW * 4);
    }
    s.slo[0] = lo_ck[k];
    s.stv[0] = tv_ck[k];
    std::vector<u32> vp(s.svp.begin(), s.svp.begin() + SW);
    std::vector<u32> vm(s.svm.begin(), s.svm.begin() + SW);
    i32 lo = s.slo[0], tv = s.stv[0];
    for (i32 t = 1; t <= cols; t++) {
      i32 col = k * CB + t;
      tv += rc.maybe_shift(col, lo, vp.data(), vm.data());
      rc.column(col, lo, vp.data(), vm.data());
      tv += 1;
      memcpy(&s.svp[(size_t)t * SW], vp.data(), SW * 4);
      memcpy(&s.svm[(size_t)t * SW], vm.data(), SW * 4);
      s.slo[t] = lo;
      s.stv[t] = tv;
    }
    return s;
  };

  auto state_at = [&](i32 col, const u32** vp, const u32** vm, i32* lo,
                      i32* tv) {
    i32 k = col / CB;
    // Checkpoint columns read the device planes directly — no recompute.
    if (col % CB == 0 && k < n_ck) {
      *vp = ck_vp + ck_off(k);
      *vm = ck_vm + ck_off(k);
      *lo = lo_ck[k];
      *tv = tv_ck[k];
      return;
    }
    i32 t = col - k * CB;
    if (t == 0 && k > 0) {
      k -= 1;
      t = CB;
    }
    Stripe& s = load_stripe(k);
    *vp = &s.svp[(size_t)t * SW];
    *vm = &s.svm[(size_t)t * SW];
    *lo = s.slo[t];
    *tv = s.stv[t];
  };

  auto dval = [&](i32 col, i32 j) -> i32 {
    const u32 *vp, *vm;
    i32 lo, tv;
    state_at(col, &vp, &vm, &lo, &tv);
    i32 top = lo * 32;
    i32 rel = j - top;
    if (rel < 0) return INF;
    i32 v = 0;
    i32 full = std::min(rel, SW * 32);
    for (i32 w = 0; w * 32 < full; w++) {
      i32 bits = std::min(32, full - w * 32);
      u32 mask = bits >= 32 ? 0xFFFFFFFFu : ((u32(1) << bits) - 1);
      v += __builtin_popcount(vp[w] & mask) - __builtin_popcount(vm[w] & mask);
    }
    if (rel > SW * 32) v += rel - SW * 32;
    return tv + v;
  };
  auto top_rows_at = [&](i32 col) -> i32 {
    const u32 *vp, *vm;
    i32 lo, tv;
    state_at(col, &vp, &vm, &lo, &tv);
    return lo * 32;
  };

  i32 i = n, j = m;
  // Final-column window top from the schedule prefix alone; computing it
  // (or the target value below) through state_at(n) would recompute the
  // whole final stripe — O(CB*SW) Myers columns of pure overhead when the
  // caller already knows the certified cost.
  i32 lo_n = lo_ck[n_ck - 1];
  for (i32 col = (n_ck - 1) * CB; col < n; col++)
    if (shift_at[col]) lo_n++;
  if (j < lo_n * 32) return -3;
  i32 g = known_cost >= 0 ? known_cost : dval(n, m);
  i32 total = g;
  std::string rev;
  // DT layer arena shared across bursts, COMPACT layout: layer gl stores
  // only its written window [cand_lo[gl], cand_hi[gl]] at offset off[gl]
  // (prefix sum of window widths).  With the x-drop keeping live windows
  // ~10 diagonals wide, a whole burst stays O(g * width) ints — the old
  // gl*gl full-width layout touched O(g^2) fresh pages, which (page
  // faults + zeroing, not the DP math) dominated long bursts: a d=834
  // whole-pair burst cost 11ms laid out full-width vs ~0.3ms compact.
  // Stale entries are never read: every prev-layer probe is bounds-
  // checked against that layer's written cand range.
  std::vector<i32> raw_fl, ext_fl, pe_pad, cand_lo, cand_hi, off;

  // Backward DT burst from (iu, ju) (banded value Du) to checkpoint column
  // c0: grow farthest-back-reaching layers X[g][D] (D = j - i diagonal,
  // raw = position after the edit, ext = after backward greedy match
  // extension) until a state crosses column c0 with dval(c0, c0+D) ==
  // Du - g; then reconstruct the segment's ops.  Appends ops (u-side
  // first) to rev and updates (i, j, g); returns false to use the
  // stepwise fallback instead.
  const i32 kNoI = INT32_MAX;
  // Backward-reach x-drop budget (see the pruning comment below); env
  // override for bench sweeps.
  static const i32 kXDrop = [] {
    const char* e = getenv("ASTARPA_XDROP");
    return e ? atoi(e) : 32;
  }();
  auto try_burst = [&](i32& iu, i32& ju, i32& Du, i32 c0) -> bool {
    i32 D0 = ju - iu;
    // Budget: local edits within this stripe.  The compact arena stores
    // O(g * window) ints, so the cap is about bounding worst-case retry
    // time, not memory; 1<<14 lets a whole 100kbp e=10% pair (d ~ 8500)
    // trace as ONE direct burst.
    i32 hard_cap = std::min({Du, 2 * (iu - c0) + 256, 1 << 14});
    // Word-level prefix values along the landing column: O(SW) to build,
    // one masked popcount per candidate check (candidate landings are
    // rare, so a full 32*SW bit-level prefix would be wasted work).
    const u32 *cvp, *cvm;
    i32 clo, ctv;
    state_at(c0, &cvp, &cvm, &clo, &ctv);
    std::vector<i32> cumw(SW + 1);
    cumw[0] = ctv;
    for (i32 w = 0; w < SW; w++)
      cumw[w + 1] = cumw[w] + __builtin_popcount(cvp[w]) -
                    __builtin_popcount(cvm[w]);
    i32 ctop = clo * 32;
    auto col_val = [&](i32 j) -> i32 {
      i32 rel = j - ctop;
      if (rel < 0) return INF;
      if (rel >= SW * 32) return cumw[SW] + rel - SW * 32;
      i32 w = rel / 32, bits = rel % 32;
      u32 mask = (u32(1) << bits) - 1;
      return cumw[w] + __builtin_popcount(cvp[w] & mask) -
             __builtin_popcount(cvm[w] & mask);
    };
    // Greedy backward match extension (the reference's extend_left_simd,
    // `astarpa2/src/blocks/trace.rs:453-500`): 64 chars per step where
    // AVX-512BW is available, 8-char u64 steps otherwise / for the tail.
    auto extend_back = [&](i32 x, i32 D) -> i32 {
      if (x == kNoI) return kNoI;
#if defined(__AVX512BW__)
      while (x >= 64 && x + D >= 64) {
        __m512i va = _mm512_loadu_si512((const void*)(a + x - 64));
        __m512i vb = _mm512_loadu_si512((const void*)(b + x + D - 64));
        u64 ne = _mm512_cmpneq_epu8_mask(va, vb);
        if (ne) return x - i32(__builtin_clzll(ne));
        x -= 64;
      }
#endif
      while (x >= 8 && x + D >= 8) {
        u64 va, vb;
        memcpy(&va, a + x - 8, 8);
        memcpy(&vb, b + x + D - 8, 8);
        u64 xo = va ^ vb;
        if (xo) return x - i32(__builtin_clzll(xo) / 8);
        x -= 8;
      }
      while (x > 0 && x + D > 0 && a[x - 1] == b[x + D - 1]) x--;
      return x;
    };
    // X-drop pruning (the reference's fr_drop, `astarpa2/src/blocks/
    // trace.rs:231-416`): diagonals whose backward reach lags the layer's
    // farthest-back state by more than `drop` are dead weight — pruning
    // them bounds the live layer width, so burst cost grows ~linearly in
    // g instead of quadratically (which in turn makes LARGE checkpoint
    // intervals cheap: readback shrinks 1/CB while the burst stays flat).
    // Exactness is preserved: a landing is accepted only when the
    // checkpoint column's value matches, and a pruned burst that misses
    // the optimal path retries with a geometrically wider drop before
    // going unpruned (the middle rung keeps a miss at large g from
    // costing a full O(g^2) layer sweep) and finally the stepwise
    // fallback.
    for (i32 drop : {kXDrop, 8 * kXDrop, kNoI}) {
    i32 found_g = -1, found_D = 0;
    // Live diagonal window [plo, phi] (D-space) of the previous layer;
    // cand_lo/hi record each layer's WRITTEN range so reconstruction
    // probes outside it read kNoI, not stale arena entries.  Iterating
    // only the live window (not all 2g+1 diagonals) is what converts the
    // x-drop into an actual O(g * window) burst — the full-width scans
    // were the dominant cost, not the extensions.
    cand_lo.assign(1, D0);
    cand_hi.assign(1, D0);
    off.assign(1, 0);
    i32 plo = D0, phi = D0;
    for (i32 gl = 0; gl <= hard_cap && found_g < 0; gl++) {
      i32 clo = std::max(D0 - gl, plo - 1), chi = std::min(D0 + gl, phi + 1);
      if (kProf) { prof_w += chi - clo + 1; prof_layers++; }
      if (gl >= i32(cand_lo.size())) {
        off.push_back(off.back() + (cand_hi.back() - cand_lo.back() + 1));
        cand_lo.push_back(clo);
        cand_hi.push_back(chi);
      }
      size_t need = size_t(off[gl]) + size_t(chi - clo + 1);
      if (raw_fl.size() < need) {
        size_t cap = std::max(need, raw_fl.size() * 2);
        raw_fl.resize(cap);
        ext_fl.resize(cap);
      }
      i32* rawg = raw_fl.data() + off[gl];
      i32* extg = ext_fl.data() + off[gl];
      // Pass 1 — raw positions for the live window, as a branch-free
      // min-chain over a kNoI-padded copy of the previous layer's window
      // (the compiler vectorizes this; kNoI saturates through the -1).
      if (gl == 0) {
        rawg[0] = iu;
      } else {
        const i32* prev = ext_fl.data() + off[gl - 1];
        i32 width = chi - clo + 1;
        pe_pad.assign(width + 2, kNoI);
        // pe_pad[t] = prev ext at D = clo - 1 + t (kNoI outside prev's
        // written range).
        for (i32 D = std::max(plo, clo - 1); D <= std::min(phi, chi + 1);
             D++)
          pe_pad[D - (clo - 1)] = prev[D - cand_lo[gl - 1]];
        const i32* pp = pe_pad.data();
        for (i32 t = 0; t < width; t++) {
          // sub/del sources sit one column back (-1); ins keeps x.
          i32 r = std::min(std::min(pp[t + 1], pp[t]) - 1, pp[t + 2]);
          i32 D = clo + t;
          if (r >= kNoI - 1 || r < 0 || r + D < 0) r = kNoI;
          rawg[t] = r;
        }
      }
      // Pass 2 — greedy extension + landing check per live state.
      i32 best = kNoI;
      for (i32 D = clo; D <= chi; D++) {
        i32 r = rawg[D - clo];
        i32 e = extend_back(r, D);
        extg[D - clo] = e;
        if (e < best) best = e;
        if (e != kNoI && e <= c0 && c0 <= r) {
          i32 jv = c0 + D;
          if (jv >= 0 && jv <= m && col_val(jv) == Du - gl) {
            found_g = gl;
            found_D = D;
            break;
          }
        }
      }
      if (found_g >= 0) break;
      if (best == kNoI) break;  // no live state: no path at this budget
      // X-drop prune + live-window shrink for the next layer.
      i32 lim = drop == kNoI ? kNoI : best + drop;
      i32 nlo = kNoI, nhi = -1;
      for (i32 D = clo; D <= chi; D++) {
        i32& e = extg[D - clo];
        if (e != kNoI && e > lim) e = kNoI;
        if (e != kNoI) {
          if (nlo == kNoI) nlo = D;
          nhi = D;
        }
      }
      if (nlo == kNoI) break;  // everything pruned: no path at this drop
      plo = nlo;
      phi = nhi;
    }
    if (found_g < 0) {
      if (drop == kNoI) return false;
      continue;  // optimal path pruned: retry without the x-drop
    }

    // Reconstruct forward from the landing (c0, c0 + D) to (iu, ju).
    std::string fwd;
    i32 x = c0, D = found_D;
    bool ok = true;
    for (i32 gl = found_g; ok && gl > 0; gl--) {
      if (D < cand_lo[gl] || D > cand_hi[gl]) {
        ok = false;
        break;
      }
      i32 r = raw_fl[size_t(off[gl]) + (D - cand_lo[gl])];
      fwd.append(r - x, '=');
      x = r;
      auto pe = [&](i32 Dp) -> i32 {
        if (Dp < cand_lo[gl - 1] || Dp > cand_hi[gl - 1]) return kNoI;
        return ext_fl[size_t(off[gl - 1]) + (Dp - cand_lo[gl - 1])];
      };
      if (pe(D) != kNoI && pe(D) - 1 == x) {
        fwd += 'X';
        x += 1;
      } else if (pe(D - 1) != kNoI && pe(D - 1) - 1 == x) {
        fwd += 'D';
        x += 1;
        D -= 1;
      } else if (pe(D + 1) != kNoI && pe(D + 1) == x) {
        fwd += 'I';
        D += 1;
      } else {
        ok = false;  // inconsistent layers
      }
    }
    if (!ok || D != D0 || x > iu) {
      if (drop == kNoI) return false;  // stepwise fallback
      continue;
    }
    fwd.append(iu - x, '=');
    rev.append(fwd.rbegin(), fwd.rend());
    ju = c0 + found_D;
    iu = c0;
    Du -= found_g;
    return true;
    }  // drop escalation
    return false;
  };

  if (kProf) prof_init = now_ns() - prof_t0;
  while (i > 0 || j > 0) {
    if (i == 0) {
      rev.append(j, 'I');
      break;
    }
    if (j == 0) {
      rev.append(i, 'D');
      break;
    }
    i32 c0 = (i - 1) / CB * CB;
    if (use_dt) {
      double t = kProf ? now_ns() : 0;
      bool okb = try_burst(i, j, g, c0);
      if (kProf) {
        prof_bursts++;
        prof_burst += now_ns() - t;
        if (!okb) prof_fails++;
      }
      if (okb) continue;
    }
    double t_step = kProf ? now_ns() : 0;
    // Stepwise fallback through the recomputed stripe, until the previous
    // checkpoint column (then bursts take over again).
    while (i > c0 && j > 0) {
      if (j <= top_rows_at(i)) {
        rev += 'D';
        i--;
        g--;
        continue;
      }
      bool eq = a[i - 1] == b[j - 1];
      i32 d_left = dval(i, j - 1);
      i32 d_diag = dval(i - 1, j - 1);
      i32 d_up = dval(i - 1, j);
      if (eq && d_diag == g) {
        rev += '=';
        i--; j--;
      } else if (d_up != INF && d_up + 1 == g) {
        rev += 'D';
        i--; g--;
      } else if (d_left != INF && d_left + 1 == g) {
        rev += 'I';
        j--; g--;
      } else if (d_diag != INF && d_diag + 1 == g) {
        rev += 'X';
        i--; j--; g--;
      } else {
        return -4;
      }
    }
    if (kProf) prof_step += now_ns() - t_step;
  }
  if (kProf) prof_t0 = now_ns();
  if (cigar_out) {
    CigarBuilder cb;
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) cb.push(*it);
    cb.flush();
    *cigar_out = (char*)malloc(cb.s.size() + 1);
    memcpy(*cigar_out, cb.s.c_str(), cb.s.size() + 1);
  }
  if (kProf) {
    prof_cig = now_ns() - prof_t0;
    fprintf(stderr,
            "[trace prof] n=%d init=%.0fus burst=%.0fus (%d calls, %d fail, "
            "%lld layers, avg width %.1f) step=%.0fus cig=%.0fus\n",
            n, prof_init / 1e3, prof_burst / 1e3, prof_bursts, prof_fails,
            (long long)prof_layers,
            prof_layers ? double(prof_w) / prof_layers : 0.0,
            prof_step / 1e3, prof_cig / 1e3);
  }
  return total;
}

// Classic-contract entry (ck_rows == SW; kept for ABI stability).
extern "C" int trace_banded_ck(const uint8_t* a, int n, const uint8_t* b,
                               int m, int S, const uint32_t* ck_vp,
                               const uint32_t* ck_vm, const int32_t* ck_tv,
                               int n_ck_dev, const int32_t* shift_at, int SW,
                               int CB, int use_dt, char** cigar_out) {
  return trace_banded_ck_rows(a, n, b, m, S, ck_vp, ck_vm, ck_tv, n_ck_dev,
                              shift_at, SW, CB, use_dt, SW, -1, cigar_out);
}

// Batched direct whole-pair traces: one call traces n_pairs independent
// pairs from their certified costs alone (no device checkpoints — each
// worker synthesizes the all-ones column-0 plane and spans the pair with
// one checkpoint interval).  Pairs live concatenated in a_buf/b_buf with
// exclusive prefix offsets (a_off/b_off of length n_pairs + 1); shift_at
// is the rung's shared bucket schedule.  Work is spread over n_threads
// std::threads (pairs are independent; the Python caller holds no GIL for
// the whole batch).  Per-pair CIGARs are malloc'd into cigars_out (free
// each with astarpa_free); rc_out[p] gets the traced cost, or a negative
// trace_banded_ck_rows error code.  Returns 0 when every pair succeeded.
extern "C" int trace_direct_batch(const uint8_t* a_buf, const int32_t* a_off,
                                  const uint8_t* b_buf, const int32_t* b_off,
                                  int n_pairs, int S,
                                  const int32_t* shift_at, int SW,
                                  const int32_t* costs, int n_threads,
                                  char** cigars_out, int32_t* rc_out) {
  if (n_threads < 1) n_threads = 1;
  if (n_threads > n_pairs) n_threads = n_pairs;
  std::atomic<int> next(0);
  std::atomic<int> bad(0);
  auto worker = [&] {
    std::vector<u32> vp(SW, 0xFFFFFFFFu), vm(SW, 0);
    i32 tv0 = 0;
    for (;;) {
      int p = next.fetch_add(1);
      if (p >= n_pairs) return;
      int n = a_off[p + 1] - a_off[p];
      int m = b_off[p + 1] - b_off[p];
      int rc = trace_banded_ck_rows(
          a_buf + a_off[p], n, b_buf + b_off[p], m, S, vp.data(), vm.data(),
          &tv0, 1, shift_at, SW, n > 0 ? n : 1, 1, SW, costs[p],
          &cigars_out[p]);
      rc_out[p] = rc;
      if (rc < 0) bad.fetch_add(1);
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(n_threads);
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
  return bad.load() ? -1 : 0;
}

// Traceback through stored banded-DP window planes (one pair).
//
// Inputs are the per-column window bit-planes produced by the banded batch
// kernel (`astarpa_tpu/ops/banded.py::banded_fill`): vp/vm[(i-1)*SW + w]
// holds word w of the window after DP column i; lo[i-1] is the window's top
// word index for column i (after its shift).  Walks Match > Del > Ins > Sub
// parents from (n, m) using the banded DP's own boundary assumptions (h=+1
// entering the window top, +1/row below the window bottom), which makes any
// parent chain a valid alignment of exactly the banded cost.
//
// Returns the cost and writes a malloc'd CIGAR, or -1 on inconsistency.
int trace_banded(const uint8_t* a, int n, const uint8_t* b, int m,
                 const uint32_t* vp_cols, const uint32_t* vm_cols,
                 const int32_t* lo, int SW, char** cigar_out) {
  const i32 WW = 32;
  std::vector<u32> init_vp(SW, 0xFFFFFFFFu), init_vm(SW, 0);

  auto planes = [&](i32 i, const u32** vp, const u32** vm) {
    // Column i in 1..n; i == 0 is the initial all-ones state.
    if (i == 0) {
      *vp = init_vp.data();
      *vm = init_vm.data();
    } else {
      *vp = vp_cols + (size_t)(i - 1) * SW;
      *vm = vm_cols + (size_t)(i - 1) * SW;
    }
  };
  auto top_words = [&](i32 i) -> i32 { return i == 0 ? 0 : lo[i - 1]; };

  // top_val[i] = banded D at (i, top_words(i)*32).
  std::vector<i32> top_val(n + 1, 0);
  for (i32 i = 1; i <= n; i++) {
    i32 tv = top_val[i - 1];
    if (top_words(i) > top_words(i - 1)) {
      const u32 *pvp, *pvm;
      planes(i - 1, &pvp, &pvm);
      tv += __builtin_popcount(pvp[0]) - __builtin_popcount(pvm[0]);
    }
    tv += 1;  // active column
    top_val[i] = tv;
  }

  auto dval = [&](i32 i, i32 j) -> i32 {
    // Banded D'(i, j); requires j >= top_words(i)*32.
    i32 top = top_words(i) * WW;
    i32 rel = j - top;
    assert(rel >= 0);
    const u32 *pvp, *pvm;
    planes(i, &pvp, &pvm);
    i32 v = 0;
    i32 full = std::min(rel, SW * WW);
    for (i32 w = 0; w * WW < full; w++) {
      i32 bits = std::min(WW, full - w * WW);
      u32 mask = bits >= WW ? 0xFFFFFFFFu : ((u32(1) << bits) - 1);
      v += __builtin_popcount(pvp[w] & mask) - __builtin_popcount(pvm[w] & mask);
    }
    if (rel > SW * WW) v += rel - SW * WW;  // below-window +1/row extension
    return top_val[i] + v;
  };

  i32 i = n, j = m;
  if (j < top_words(n) * WW) return -1;  // window does not cover the corner
  i32 g = dval(n, m);
  i32 total = g;
  std::string rev;
  while (i > 0 || j > 0) {
    if (i == 0) {
      rev.append(j, 'I');
      j = 0;
      break;
    }
    if (j == 0) {
      rev.append(i, 'D');
      i = 0;
      break;
    }
    i32 top = top_words(i) * WW;
    if (j <= top) {
      // h = +1 boundary at the window top: a deletion.
      rev += 'D';
      i--;
      g--;
      continue;
    }
    bool eq = a[i - 1] == b[j - 1];
    i32 d_diag = (j - 1 >= top_words(i - 1) * WW) ? dval(i - 1, j - 1) : INF;
    i32 d_up = (j >= top_words(i - 1) * WW) ? dval(i - 1, j) : INF;
    i32 d_left = dval(i, j - 1);
    if (eq && d_diag == g) {
      rev += '=';
      i--; j--;
    } else if (d_up + 1 == g) {
      rev += 'D';
      i--; g--;
    } else if (d_left + 1 == g) {
      rev += 'I';
      j--; g--;
    } else if (d_diag + 1 == g) {
      rev += 'X';
      i--; j--; g--;
    } else {
      return -1;  // inconsistent planes
    }
  }
  if (g != 0 && i != 0) return -1;
  if (cigar_out) {
    CigarBuilder cb;
    for (auto it = rev.rbegin(); it != rev.rend(); ++it) cb.push(*it);
    cb.flush();
    *cigar_out = (char*)malloc(cb.s.size() + 1);
    memcpy(*cigar_out, cb.s.c_str(), cb.s.size() + 1);
  }
  return total;
}

// Batch input pack: 2-bit codes + negated b-side bit planes, built
// directly from the pair byte buffers into UPLOAD-READY arrays (the
// re-expression of the reference's O(n) profile build,
// `pa-bitpacking/src/profile.rs:96-157`, for a batch + a ~90MB/s
// host->device link: ship 2 bits/char instead of 8).
//
// Layout is pair-major (each pair writes contiguous rows; the device
// transposes for free):
//   a4  (B, ceil(n_max/4)) u8  — a codes ((c>>1)&3) packed 4/byte,
//                                little-endian in the byte; pad code 0
//                                (matches the numpy pack's zeroed rows).
//   pb0/pb1 (B, S) u32         — b planes: bit w of word s is
//                                ((code>>plane)&1)^1 for char s*32+w;
//                                pad char 0xFF -> code 3 -> both bits 0.
// a_ptrs/b_ptrs: B pointers (NULL allowed when the length is 0).  Work
// splits across n_threads std::threads; the ctypes caller drops the GIL.
extern "C" void pack_batch_planes(const uint8_t* const* a_ptrs,
                                  const int32_t* a_lens,
                                  const uint8_t* const* b_ptrs,
                                  const int32_t* b_lens, int B, int n_max,
                                  int S, uint8_t* a4, uint32_t* pb0,
                                  uint32_t* pb1, int n_threads) {
  const int n4 = (n_max + 3) / 4;
  if (n_threads < 1) n_threads = 1;
  if (n_threads > B) n_threads = B;
  std::atomic<int> next(0);
  auto worker = [&] {
    for (;;) {
      int p = next.fetch_add(1);
      if (p >= B) return;
      const uint8_t* a = a_ptrs[p];
      const int na = a_lens[p];
      uint8_t* row4 = a4 + size_t(p) * n4;
      memset(row4, 0, n4);
      int i = 0;
      for (; i + 4 <= na; i += 4) {
        row4[i >> 2] = uint8_t(((a[i] >> 1) & 3) | (((a[i + 1] >> 1) & 3) << 2) |
                               (((a[i + 2] >> 1) & 3) << 4) |
                               (((a[i + 3] >> 1) & 3) << 6));
      }
      for (; i < na; i++) row4[i >> 2] |= uint8_t(((a[i] >> 1) & 3) << ((i & 3) * 2));

      const uint8_t* bseq = b_ptrs[p];
      const int nb = b_lens[p];
      uint32_t* r0 = pb0 + size_t(p) * S;
      uint32_t* r1 = pb1 + size_t(p) * S;
      const int full = nb / 32;
      for (int s = 0; s < full; s++) {
        u32 w0 = 0, w1 = 0;
        const uint8_t* c = bseq + s * 32;
        for (int w = 0; w < 32; w++) {
          u32 code = (c[w] >> 1) & 3;
          w0 |= ((code & 1) ^ 1) << w;
          w1 |= (((code >> 1) & 1) ^ 1) << w;
        }
        r0[s] = w0;
        r1[s] = w1;
      }
      for (int s = full; s < S; s++) {
        u32 w0 = 0, w1 = 0;
        for (int w = 0; w < 32; w++) {
          int idx = s * 32 + w;
          u32 code = idx < nb ? (bseq[idx] >> 1) & 3 : 3;  // pad 0xFF
          w0 |= ((code & 1) ^ 1) << w;
          w1 |= (((code >> 1) & 1) ^ 1) << w;
        }
        r0[s] = w0;
        r1[s] = w1;
      }
    }
  };
  if (n_threads == 1) {
    worker();
  } else {
    std::vector<std::thread> ts;
    ts.reserve(n_threads);
    for (int t = 0; t < n_threads; t++) ts.emplace_back(worker);
    for (auto& t : ts) t.join();
  }
}

}  // extern "C"
