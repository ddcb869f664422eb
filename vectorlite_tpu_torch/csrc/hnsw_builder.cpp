// Native HNSW graph builder + host search.
//
// The port's copy of vectorlite_tpu/native/hnsw_builder.cpp, the
// equivalent of the reference's Rust `hnsw` crate usage
// (reference: src/index/hnsw.rs:176-195 wraps hnsw 0.11): graph
// construction and single-query host search are inherently sequential
// pointer-chasing, so they run as native code on the host CPU, while the
// batched level-0 beam search runs on the index's device (kernels/beam.py).
//
// Memory contract: Python owns the level-0 adjacency [cap, M0], vector
// matrix [cap, D], per-node levels, and squared-norm/norm arrays; this
// library mutates them in place (so the device copy can sync straight
// from the same buffers). Upper-level adjacency and all search scratch are
// C++-owned. Rows whose level-0 adjacency changed are reported through a
// dirty list that Python drains for incremental device sync.
//
// Concurrency (hnswlib-style, reference has no analogue — the Rust crate
// builds single-threaded under the collection RwLock):
//   - insert_batch_parallel: N worker threads claim nodes off an atomic
//     cursor. Adjacency rows are guarded by a fixed pool of row mutexes
//     (node & kLockMask); entry-point/top-level reads+updates and
//     upper-level allocation take a single global mutex, held across the
//     whole insert only for the rare level > top_level case.
//   - searches/descends take NO global lock: each acquires a visited
//     scratch from a free-list pool, so concurrent readers (Python's
//     per-collection RW lock admits many) proceed in parallel.
//   - Levels are pre-drawn sequentially from the builder rng, so level
//     assignment is deterministic regardless of thread count.
//
// Distances (smaller = closer) mirror index/hnsw.py::_dist_to_many —
// the reference's formulas without the u64 x1000 fixed-point quantization
// (reference: src/index/hnsw.rs:113-174):
//   euclidean = L2, manhattan = L1, cosine = 1 - cos (zero-norm -> 1.0),
//   dotproduct = 1000 - clamp(dot, -1000, 1000).
// Hot loops are hand-vectorized (AVX-512 / AVX2 / scalar fallback): the
// builder spends nearly all its time in dim-length reductions.
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -march=native -pthread, keyed by
// the host's vector ISA (kernels/_build.py).

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <memory>
#include <mutex>
#include <queue>
#include <random>
#include <thread>
#include <utility>
#include <vector>

#if defined(__x86_64__) || defined(_M_X64)
#include <immintrin.h>
#define VL_X86 1
#endif

namespace {

// ------------------------------------------------------------------ SIMD

#if defined(__AVX512F__)

static inline float vl_dot(const float* a, const float* b, int n) {
  __m512 s0 = _mm512_setzero_ps(), s1 = _mm512_setzero_ps();
  int i = 0;
  for (; i + 32 <= n; i += 32) {
    s0 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i), s0);
    s1 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i + 16),
                         _mm512_loadu_ps(b + i + 16), s1);
  }
  for (; i + 16 <= n; i += 16) {
    s0 = _mm512_fmadd_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i), s0);
  }
  float acc = _mm512_reduce_add_ps(_mm512_add_ps(s0, s1));
  for (; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

static inline float vl_l2sq(const float* a, const float* b, int n) {
  __m512 s0 = _mm512_setzero_ps(), s1 = _mm512_setzero_ps();
  int i = 0;
  for (; i + 32 <= n; i += 32) {
    __m512 d0 = _mm512_sub_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i));
    __m512 d1 = _mm512_sub_ps(_mm512_loadu_ps(a + i + 16),
                              _mm512_loadu_ps(b + i + 16));
    s0 = _mm512_fmadd_ps(d0, d0, s0);
    s1 = _mm512_fmadd_ps(d1, d1, s1);
  }
  for (; i + 16 <= n; i += 16) {
    __m512 d = _mm512_sub_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i));
    s0 = _mm512_fmadd_ps(d, d, s0);
  }
  float acc = _mm512_reduce_add_ps(_mm512_add_ps(s0, s1));
  for (; i < n; ++i) {
    float d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

static inline float vl_l1(const float* a, const float* b, int n) {
  __m512 s = _mm512_setzero_ps();
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    __m512 d = _mm512_sub_ps(_mm512_loadu_ps(a + i), _mm512_loadu_ps(b + i));
    s = _mm512_add_ps(s, _mm512_abs_ps(d));
  }
  float acc = _mm512_reduce_add_ps(s);
  for (; i < n; ++i) acc += std::fabs(a[i] - b[i]);
  return acc;
}

#elif defined(__AVX2__)

static inline float vl_hsum256(__m256 v) {
  __m128 lo = _mm256_castps256_ps128(v);
  __m128 hi = _mm256_extractf128_ps(v, 1);
  lo = _mm_add_ps(lo, hi);
  lo = _mm_hadd_ps(lo, lo);
  lo = _mm_hadd_ps(lo, lo);
  return _mm_cvtss_f32(lo);
}

static inline float vl_dot(const float* a, const float* b, int n) {
  __m256 s0 = _mm256_setzero_ps(), s1 = _mm256_setzero_ps();
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    s0 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i), s0);
    s1 = _mm256_fmadd_ps(_mm256_loadu_ps(a + i + 8),
                         _mm256_loadu_ps(b + i + 8), s1);
  }
  float acc = vl_hsum256(_mm256_add_ps(s0, s1));
  for (; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

static inline float vl_l2sq(const float* a, const float* b, int n) {
  __m256 s0 = _mm256_setzero_ps(), s1 = _mm256_setzero_ps();
  int i = 0;
  for (; i + 16 <= n; i += 16) {
    __m256 d0 = _mm256_sub_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i));
    __m256 d1 = _mm256_sub_ps(_mm256_loadu_ps(a + i + 8),
                              _mm256_loadu_ps(b + i + 8));
    s0 = _mm256_fmadd_ps(d0, d0, s0);
    s1 = _mm256_fmadd_ps(d1, d1, s1);
  }
  float acc = vl_hsum256(_mm256_add_ps(s0, s1));
  for (; i < n; ++i) {
    float d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

static inline float vl_l1(const float* a, const float* b, int n) {
  const __m256 absmask =
      _mm256_castsi256_ps(_mm256_set1_epi32(0x7FFFFFFF));
  __m256 s = _mm256_setzero_ps();
  int i = 0;
  for (; i + 8 <= n; i += 8) {
    __m256 d = _mm256_sub_ps(_mm256_loadu_ps(a + i), _mm256_loadu_ps(b + i));
    s = _mm256_add_ps(s, _mm256_and_ps(d, absmask));
  }
  float acc = vl_hsum256(s);
  for (; i < n; ++i) acc += std::fabs(a[i] - b[i]);
  return acc;
}

#else

static inline float vl_dot(const float* a, const float* b, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    s0 += a[i] * b[i];
    s1 += a[i + 1] * b[i + 1];
    s2 += a[i + 2] * b[i + 2];
    s3 += a[i + 3] * b[i + 3];
  }
  float acc = (s0 + s1) + (s2 + s3);
  for (; i < n; ++i) acc += a[i] * b[i];
  return acc;
}

static inline float vl_l2sq(const float* a, const float* b, int n) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
  int i = 0;
  for (; i + 4 <= n; i += 4) {
    float d0 = a[i] - b[i], d1 = a[i + 1] - b[i + 1];
    float d2 = a[i + 2] - b[i + 2], d3 = a[i + 3] - b[i + 3];
    s0 += d0 * d0;
    s1 += d1 * d1;
    s2 += d2 * d2;
    s3 += d3 * d3;
  }
  float acc = (s0 + s1) + (s2 + s3);
  for (; i < n; ++i) {
    float d = a[i] - b[i];
    acc += d * d;
  }
  return acc;
}

static inline float vl_l1(const float* a, const float* b, int n) {
  float s0 = 0.f, s1 = 0.f;
  int i = 0;
  for (; i + 2 <= n; i += 2) {
    s0 += std::fabs(a[i] - b[i]);
    s1 += std::fabs(a[i + 1] - b[i + 1]);
  }
  float acc = s0 + s1;
  for (; i < n; ++i) acc += std::fabs(a[i] - b[i]);
  return acc;
}

#endif

static inline void vl_prefetch(const void* p) {
#ifdef VL_X86
  _mm_prefetch(reinterpret_cast<const char*>(p), _MM_HINT_T0);
#else
  (void)p;
#endif
}

enum Metric : int32_t {
  METRIC_COSINE = 0,
  METRIC_EUCLIDEAN = 1,
  METRIC_MANHATTAN = 2,
  METRIC_DOT = 3,
};

// Geometric level draws top out around log(N)/log(M); 32 slots covers any
// feasible corpus (P(level >= 32) < 1e-38 at M=16). Fixed slot count keeps
// the outer structure immutable so readers never race a reallocation.
constexpr int kMaxUpperLevels = 32;
constexpr int kLockPoolSize = 1 << 16;  // row-mutex pool, indexed node & mask
constexpr int kLockMask = kLockPoolSize - 1;

// Per-search scratch: visited-epoch array (no clearing between searches)
// plus a row copy buffer for lock-free reads of in-flux adjacency rows.
struct Scratch {
  std::vector<uint32_t> visited;
  uint32_t epoch = 0;
  std::vector<int32_t> row_buf;
};

struct Builder {
  int32_t dim = 0;
  int32_t metric = 0;
  int32_t m = 16;
  int32_t m0 = 32;
  int32_t efc = 100;
  double ml = 0.0;

  // Python-owned buffers (rebound on capacity growth)
  float* vecs = nullptr;       // [cap, dim]
  float* sqnorms = nullptr;    // [cap]
  float* norms = nullptr;      // [cap]
  int32_t* levels = nullptr;   // [cap]
  int32_t* adj0 = nullptr;     // [cap, m0]
  int64_t cap = 0;

  // C++-owned upper levels: adj_upper[l][node*m + j] is level l+1.
  // Fixed-size outer array; inner storage allocated lazily under
  // global_mu when a draw first reaches that level.
  std::vector<int32_t> adj_upper[kMaxUpperLevels];
  int32_t upper_count = 0;

  std::atomic<int64_t> num_nodes{0};
  int64_t entry = -1;
  int32_t top_level = -1;

  std::mt19937_64 rng;
  std::uniform_real_distribution<double> unif{0.0, 1.0};

  // entry/top_level + upper-level allocation + rng
  std::mutex global_mu;
  // adjacency row locks (only honored on the concurrent-build path);
  // allocated lazily on the first parallel build — ~2.6 MB of mutexes
  // that single-threaded builders never need
  std::unique_ptr<std::mutex[]> row_locks;
  void ensure_row_locks() {
    if (!row_locks) row_locks.reset(new std::mutex[kLockPoolSize]);
  }

  // scratch pool: searches run concurrently, each with its own visited[]
  std::mutex pool_mu;
  std::vector<std::unique_ptr<Scratch>> scratch_pool;

  std::mutex dirty_mu;
  std::vector<int32_t> dirty;  // level-0 rows touched since last drain

  Scratch* acquire_scratch() {
    std::lock_guard<std::mutex> g(pool_mu);
    if (!scratch_pool.empty()) {
      Scratch* s = scratch_pool.back().release();
      scratch_pool.pop_back();
      if (static_cast<int64_t>(s->visited.size()) < cap) {
        s->visited.assign(cap, 0);
        s->epoch = 0;
      }
      return s;
    }
    Scratch* s = new Scratch();
    s->visited.assign(cap, 0);
    s->row_buf.resize(std::max(m0, m));
    return s;
  }
  void release_scratch(Scratch* s) {
    std::lock_guard<std::mutex> g(pool_mu);
    scratch_pool.emplace_back(s);
  }

  void mark_dirty(int64_t node) {
    std::lock_guard<std::mutex> g(dirty_mu);
    dirty.push_back(static_cast<int32_t>(node));
  }

  float dist(const float* q, float q_norm, int64_t node) const {
    const float* v = vecs + node * dim;
    switch (metric) {
      case METRIC_EUCLIDEAN:
        return std::sqrt(vl_l2sq(q, v, dim));
      case METRIC_MANHATTAN:
        return vl_l1(q, v, dim);
      case METRIC_DOT: {
        float s = vl_dot(q, v, dim);
        s = std::min(std::max(s, -1000.f), 1000.f);
        return 1000.f - s;
      }
      default: {  // cosine; clamp: f32 cos can exceed 1 by an ulp
        float s = vl_dot(q, v, dim);
        float denom = q_norm * norms[node];
        if (denom <= 0.f) return 1.f;
        return std::max(0.f, 1.f - s / denom);
      }
    }
  }

  const int32_t* row(int level, int64_t node) const {
    if (level == 0) return adj0 + node * m0;
    return adj_upper[level - 1].data() + node * m;
  }
  int32_t* row_ptr_mut(int level, int64_t node) {
    if (level == 0) return adj0 + node * m0;
    return adj_upper[level - 1].data() + node * m;
  }
  int degree_cap(int level) const { return level == 0 ? m0 : m; }

  // only call with global_mu held (or single-threaded)
  void ensure_level(int level) {
    while (upper_count < level && upper_count < kMaxUpperLevels) {
      adj_upper[upper_count].assign(cap * m, -1);
      ++upper_count;
    }
  }

  using DistNode = std::pair<float, int64_t>;

  // classic ef-search on one layer; result ascending by distance.
  // `locked` guards adjacency-row reads against concurrent writers
  // (needed only during parallel construction).
  template <bool locked>
  void search_layer(const float* q, float q_norm,
                    const std::vector<int64_t>& eps, int ef, int level,
                    Scratch& scr, std::vector<DistNode>& out) {
    auto& visited = scr.visited;
    uint32_t epoch = ++scr.epoch;
    if (epoch == 0) {  // wrapped: reset
      std::fill(visited.begin(), visited.end(), 0);
      epoch = scr.epoch = 1;
    }
    // min-heap candidates, max-heap results
    std::priority_queue<DistNode, std::vector<DistNode>,
                        std::greater<DistNode>> cand;
    std::priority_queue<DistNode> result;
    for (int64_t ep : eps) {
      if (visited[ep] == epoch) continue;
      visited[ep] = epoch;
      float d = dist(q, q_norm, ep);
      cand.emplace(d, ep);
      result.emplace(d, ep);
      while (static_cast<int>(result.size()) > ef) result.pop();
    }
    int deg = degree_cap(level);
    while (!cand.empty()) {
      DistNode c = cand.top();
      if (static_cast<int>(result.size()) >= ef &&
          c.first > result.top().first) {
        break;
      }
      cand.pop();
      const int32_t* nbrs;
      if (locked) {
        std::lock_guard<std::mutex> g(row_locks[c.second & kLockMask]);
        std::memcpy(scr.row_buf.data(), row(level, c.second),
                    sizeof(int32_t) * deg);
        nbrs = scr.row_buf.data();
      } else {
        nbrs = row(level, c.second);
      }
      for (int j = 0; j < deg; ++j) {
        int32_t nb = nbrs[j];
        if (nb >= 0) vl_prefetch(vecs + static_cast<int64_t>(nb) * dim);
      }
      for (int j = 0; j < deg; ++j) {
        int32_t nb = nbrs[j];
        if (nb < 0) continue;
        if (visited[nb] == epoch) continue;
        visited[nb] = epoch;
        float d = dist(q, q_norm, nb);
        if (static_cast<int>(result.size()) < ef ||
            d < result.top().first) {
          cand.emplace(d, nb);
          result.emplace(d, nb);
          while (static_cast<int>(result.size()) > ef) result.pop();
        }
      }
    }
    out.clear();
    out.reserve(result.size());
    while (!result.empty()) {
      out.push_back(result.top());
      result.pop();
    }
    std::reverse(out.begin(), out.end());
  }

  // keepPrunedConnections (Malkov Alg. 4): after diversity selection,
  // backfill still-empty slots with the closest rejected candidates.
  // Measured HARMFUL on clustered embeddings at 200K x 384 (recall@10
  // 0.974 -> 0.966 at ef=64, builds 21% slower: denser rows add
  // distance evals per hop without adding navigability), so OFF by
  // default; hnsw_set_keep_pruned exposes it for other workloads.
  bool keep_pruned = false;

  // Malkov diversity heuristic: a candidate is kept only if it is closer
  // to the query than to every already-kept neighbor. This preserves the
  // long-range inter-cluster edges that plain closest-M pruning severs —
  // closest-M was measured to fragment clustered corpora into per-cluster
  // components (entry BFS reached 109 of 30000 nodes). With `backfill`,
  // remaining slots are topped up with the closest pruned candidates
  // (denser graphs navigate better at equal ef; measured on the recall
  // sweep before enabling by default).
  void select_heuristic(const std::vector<DistNode>& cands, int mmax,
                        std::vector<int64_t>& out, bool backfill = false) {
    out.clear();
    if (static_cast<int>(cands.size()) <= mmax) {
      for (auto& dn : cands) out.push_back(dn.second);
      return;
    }
    std::vector<int64_t> rejected;
    for (auto& dn : cands) {
      if (static_cast<int>(out.size()) >= mmax) break;
      bool keep = true;
      const float* cv = vecs + dn.second * dim;
      float cn = norms[dn.second];
      for (int64_t s : out) {
        if (dist(cv, cn, s) < dn.first) {
          keep = false;
          break;
        }
      }
      if (keep) {
        out.push_back(dn.second);
      } else if (backfill) {
        rejected.push_back(dn.second);
      }
    }
    if (backfill) {
      for (int64_t r : rejected) {
        if (static_cast<int>(out.size()) >= mmax) break;
        out.push_back(r);  // rejected kept in ascending-distance order
      }
    }
  }

  // write `node`'s row and back-link into each neighbor's row, pruning
  // overflowing rows with the diversity heuristic. Row mutations take the
  // row lock on the concurrent path; dirty marks are always recorded.
  template <bool locked>
  void link(int64_t node, const std::vector<int64_t>& neighbors, int level,
            std::vector<DistNode>& all_scratch) {
    int mmax = degree_cap(level);
    {
      std::unique_lock<std::mutex> g(row_locks[node & kLockMask],
                                     std::defer_lock);
      if (locked) g.lock();
      int32_t* r = row_ptr_mut(level, node);
      int n = std::min<int>(neighbors.size(), mmax);
      for (int j = 0; j < n; ++j) r[j] = static_cast<int32_t>(neighbors[j]);
    }
    if (level == 0) mark_dirty(node);
    for (int64_t nb : neighbors) {
      bool touched = false;
      {
        std::unique_lock<std::mutex> g(row_locks[nb & kLockMask],
                                       std::defer_lock);
        if (locked) g.lock();
        int32_t* nr = row_ptr_mut(level, nb);
        int free_slot = -1;
        for (int j = 0; j < mmax; ++j) {
          if (nr[j] < 0) {
            free_slot = j;
            break;
          }
        }
        if (free_slot >= 0) {
          nr[free_slot] = static_cast<int32_t>(node);
          touched = true;
        } else {
          // prune the overflowing row with the diversity heuristic — plain
          // closest-M here disconnects clusters (see select_heuristic note)
          const float* nv = vecs + nb * dim;
          float nn = norms[nb];
          auto& all = all_scratch;
          all.clear();
          all.reserve(mmax + 1);
          for (int j = 0; j < mmax; ++j) {
            all.emplace_back(dist(nv, nn, nr[j]), nr[j]);
          }
          all.emplace_back(dist(nv, nn, node), node);
          std::stable_sort(all.begin(), all.end(),
                           [](const DistNode& a, const DistNode& b) {
                             return a.first < b.first;
                           });
          std::vector<int64_t> kept;
          select_heuristic(all, mmax, kept);
          for (int j = 0; j < mmax; ++j) {
            nr[j] = j < static_cast<int>(kept.size())
                        ? static_cast<int32_t>(kept[j])
                        : -1;
          }
          touched = true;
        }
      }
      if (touched && level == 0) mark_dirty(nb);
    }
  }

  // only call with global_mu held (or single-threaded): uses the rng.
  // Clamped to the fixed upper-level slot count (P(level >= 32) < 1e-38
  // at M=16, but an unclamped draw would index past adj_upper[]).
  int draw_level() {
    int level = static_cast<int>(-std::log(std::max(unif(rng), 1e-300)) * ml);
    return std::min(level, kMaxUpperLevels);
  }

  void register_node(int64_t node) {
    const float* v = vecs + node * dim;
    float sq = vl_dot(v, v, dim);
    sqnorms[node] = sq;
    norms[node] = std::sqrt(sq);
    int64_t cur = num_nodes.load(std::memory_order_relaxed);
    while (cur < node + 1 &&
           !num_nodes.compare_exchange_weak(cur, node + 1,
                                            std::memory_order_relaxed)) {
    }
  }

  // insert node `node` whose vector Python already wrote into vecs[node],
  // at pre-drawn `level`. With `locked=true` this is the hnswlib-style
  // concurrent insert: row mutations take row locks, and entry/top_level
  // are read under global_mu (held across the whole insert only when this
  // node's level exceeds the current top).
  template <bool locked>
  void insert_at_level(int64_t node, int level, Scratch& scr) {
    register_node(node);
    levels[node] = level;
    // mark the (still-empty) level-0 row dirty so the device picks it up
    mark_dirty(node);

    std::unique_lock<std::mutex> toplock(global_mu, std::defer_lock);
    int64_t cur_entry;
    int cur_top;
    if (locked) {
      toplock.lock();
      cur_entry = entry;
      cur_top = top_level;
      ensure_level(level);
      if (level <= cur_top) toplock.unlock();  // common case: no global lock
    } else {
      cur_entry = entry;
      cur_top = top_level;
      ensure_level(level);
    }

    if (cur_entry < 0) {
      entry = node;
      top_level = level;
      return;
    }

    const float* v = vecs + node * dim;
    float q_norm = norms[node];
    std::vector<int64_t> eps{cur_entry};
    std::vector<DistNode> cands;
    std::vector<DistNode> prune_scratch;
    for (int l = cur_top; l > level; --l) {
      search_layer<locked>(v, q_norm, eps, 1, l, scr, cands);
      if (!cands.empty()) {
        eps.assign(1, cands[0].second);
      }
    }
    std::vector<int64_t> selected;
    for (int l = std::min(level, cur_top); l >= 0; --l) {
      search_layer<locked>(v, q_norm, eps, efc, l, scr, cands);
      select_heuristic(cands, degree_cap(l), selected, keep_pruned);
      link<locked>(node, selected, l, prune_scratch);
      eps.clear();
      for (auto& dn : cands) eps.push_back(dn.second);
      if (eps.empty()) eps.push_back(cur_entry);
    }
    if (level > cur_top) {
      // toplock is still held on the locked path
      entry = node;
      top_level = level;
    }
  }

  void insert(int64_t node, int forced_level = -1) {
    int level;
    {
      std::lock_guard<std::mutex> g(global_mu);
      level = forced_level >= 0 ? std::min(forced_level, kMaxUpperLevels)
                                : draw_level();
    }
    Scratch* scr = acquire_scratch();
    insert_at_level<false>(node, level, *scr);
    release_scratch(scr);
  }

  // Parallel batch insert: pre-draw all levels (deterministic), then
  // worker threads claim nodes off an atomic cursor.
  void insert_batch_parallel(int64_t start, int64_t count, int threads) {
    if (count <= 0) return;
    std::vector<int32_t> drawn(count);
    {
      std::lock_guard<std::mutex> g(global_mu);
      for (int64_t i = 0; i < count; ++i) {
        drawn[i] = static_cast<int32_t>(draw_level());
      }
    }
    int64_t i0 = 0;
    if (entry < 0) {
      // seed the graph on the calling thread so workers always have an entry
      Scratch* scr = acquire_scratch();
      insert_at_level<false>(start, drawn[0], *scr);
      release_scratch(scr);
      i0 = 1;
    }
    threads =
        static_cast<int>(std::max<int64_t>(1, std::min<int64_t>(threads, count - i0)));
    if (threads <= 1) {
      Scratch* scr = acquire_scratch();
      for (int64_t i = i0; i < count; ++i) {
        insert_at_level<false>(start + i, drawn[i], *scr);
      }
      release_scratch(scr);
      return;
    }
    ensure_row_locks();  // single-threaded here, before workers spawn
    std::atomic<int64_t> cursor{i0};
    auto worker = [&]() {
      Scratch* scr = acquire_scratch();
      for (;;) {
        int64_t i = cursor.fetch_add(1, std::memory_order_relaxed);
        if (i >= count) break;
        insert_at_level<true>(start + i, drawn[i], *scr);
      }
      release_scratch(scr);
    };
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }

  int64_t descend(const float* q, Scratch& scr) {
    if (entry < 0) return -1;
    float q_norm = std::sqrt(vl_dot(q, q, dim));
    std::vector<int64_t> eps{entry};
    std::vector<DistNode> cands;
    for (int l = top_level; l > 0; --l) {
      search_layer<false>(q, q_norm, eps, 1, l, scr, cands);
      if (!cands.empty()) eps.assign(1, cands[0].second);
    }
    return eps[0];
  }

  // full search: descend + level-0 ef-search; returns count written
  int search(const float* q, int ef, int32_t* out_ids, float* out_dists,
             Scratch& scr) {
    if (entry < 0) return 0;
    float q_norm = std::sqrt(vl_dot(q, q, dim));
    std::vector<int64_t> eps{entry};
    std::vector<DistNode> cands;
    for (int l = top_level; l > 0; --l) {
      search_layer<false>(q, q_norm, eps, 1, l, scr, cands);
      if (!cands.empty()) eps.assign(1, cands[0].second);
    }
    search_layer<false>(q, q_norm, eps, ef, 0, scr, cands);
    int n = static_cast<int>(cands.size());
    for (int i = 0; i < n; ++i) {
      out_ids[i] = static_cast<int32_t>(cands[i].second);
      out_dists[i] = cands[i].first;
    }
    return n;
  }
};

}  // namespace

namespace {
// one node's forward-row diversity selection + link; `locked` selects
// the row-lock template so the same body serves the single-threaded
// and worker paths
template <bool locked>
void bulk_link_one(Builder* b, const int64_t* node_ids, int32_t c,
                   const int32_t* cand_idx, const float* cand_dist,
                   int64_t i, std::vector<int64_t>& kept,
                   std::vector<Builder::DistNode>& prune_scratch) {
  int64_t node = node_ids[i];
  const int32_t* ci = cand_idx + i * c;
  const float* cd = cand_dist + i * c;
  kept.clear();
  for (int32_t j = 0; j < c; ++j) {
    if (ci[j] < 0) continue;
    if (static_cast<int>(kept.size()) >= b->m0) break;
    const float* cv = b->vecs + static_cast<int64_t>(ci[j]) * b->dim;
    float cn = b->norms[ci[j]];
    bool keep = true;
    for (int64_t s : kept) {
      if (b->dist(cv, cn, s) < cd[j]) {
        keep = false;
        break;
      }
    }
    if (keep) kept.push_back(ci[j]);
  }
  b->link<locked>(node, kept, 0, prune_scratch);
}
}  // namespace

namespace {
struct RefineScratch {
  std::vector<Builder::DistNode> cands;
  std::vector<int64_t> kept;
  std::vector<int32_t> row_buf;
  std::vector<uint32_t> seen;
  uint32_t epoch = 0;
};

template <bool locked>
void refine_one(Builder* b, int64_t v, int64_t n, RefineScratch& s) {
  ++s.epoch;
  if (s.epoch == 0) {
    std::fill(s.seen.begin(), s.seen.end(), 0);
    s.epoch = 1;
  }
  s.seen[v] = s.epoch;
  const float* qv = b->vecs + v * b->dim;
  float qn = b->norms[v];
  s.cands.clear();
  auto copy_row = [&](int64_t node) {
    if (locked) {
      std::lock_guard<std::mutex> g(b->row_locks[node & kLockMask]);
      std::memcpy(s.row_buf.data(), b->row(0, node),
                  sizeof(int32_t) * b->m0);
    } else {
      std::memcpy(s.row_buf.data(), b->row(0, node),
                  sizeof(int32_t) * b->m0);
    }
  };
  copy_row(v);
  std::vector<int32_t> direct_rows(s.row_buf.begin(),
                                   s.row_buf.begin() + b->m0);
  for (int j = 0; j < b->m0; ++j) {
    int32_t u = direct_rows[j];
    if (u < 0 || s.seen[u] == s.epoch) continue;
    s.seen[u] = s.epoch;
    s.cands.emplace_back(b->dist(qv, qn, u), u);
  }
  int direct = static_cast<int>(s.cands.size());
  for (int i = 0; i < direct; ++i) {
    copy_row(s.cands[i].second);
    for (int j = 0; j < b->m0; ++j) {
      int32_t w = s.row_buf[j];
      if (w < 0 || w >= n || s.seen[w] == s.epoch) continue;
      s.seen[w] = s.epoch;
      s.cands.emplace_back(b->dist(qv, qn, w), w);
    }
  }
  std::stable_sort(
      s.cands.begin(), s.cands.end(),
      [](const Builder::DistNode& a, const Builder::DistNode& x) {
        return a.first < x.first;
      });
  b->select_heuristic(s.cands, b->m0, s.kept);
  {
    std::unique_lock<std::mutex> g(b->row_locks[v & kLockMask],
                                   std::defer_lock);
    if (locked) g.lock();
    int32_t* out_row = b->row_ptr_mut(0, v);
    for (int j = 0; j < b->m0; ++j) {
      out_row[j] = j < static_cast<int>(s.kept.size())
                       ? static_cast<int32_t>(s.kept[j])
                       : -1;
    }
  }
  b->mark_dirty(v);
}
}  // namespace

extern "C" {

Builder* hnsw_new(int32_t dim, int32_t metric, int32_t m, int32_t m0,
                  int32_t efc, uint64_t seed) {
  Builder* b = new Builder();
  b->dim = dim;
  b->metric = metric;
  b->m = m;
  b->m0 = m0;
  b->efc = efc;
  b->ml = 1.0 / std::log(static_cast<double>(m));
  b->rng.seed(seed);
  return b;
}

void hnsw_free(Builder* b) { delete b; }

// (Re)bind the Python-owned buffers; called at init and on capacity growth.
// Single-threaded by contract (Python holds the collection write lock and
// no batch insert is in flight).
void hnsw_bind(Builder* b, float* vecs, float* sqnorms, float* norms,
               int32_t* levels, int32_t* adj0, int64_t cap) {
  b->vecs = vecs;
  b->sqnorms = sqnorms;
  b->norms = norms;
  b->levels = levels;
  b->adj0 = adj0;
  int64_t old_cap = b->cap;
  b->cap = cap;
  if (cap > old_cap) {
    for (int l = 0; l < b->upper_count; ++l) {
      b->adj_upper[l].resize(cap * b->m, -1);
    }
    // grown scratches are refreshed lazily in acquire_scratch
  }
}

void hnsw_insert_batch(Builder* b, int64_t start, int64_t count) {
  for (int64_t i = 0; i < count; ++i) b->insert(start + i);
}

// hnswlib-recipe multi-threaded build: per-row lock pool + per-thread
// visited scratch + global entry lock. Deterministic level draws.
void hnsw_insert_batch_parallel(Builder* b, int64_t start, int64_t count,
                                int32_t threads) {
  b->insert_batch_parallel(start, count, threads);
}

void hnsw_insert_leveled(Builder* b, int64_t node, int32_t level) {
  b->insert(node, level);
}

// toggle keepPrunedConnections (insert-time closest-backfill); default
// OFF (measured harmful on clustered embeddings — see the Builder field)
void hnsw_set_keep_pruned(Builder* b, int32_t on) {
  b->keep_pruned = on != 0;
}

void hnsw_draw_levels(Builder* b, int64_t count, int32_t* out) {
  std::lock_guard<std::mutex> g(b->global_mu);
  for (int64_t i = 0; i < count; ++i) {
    out[i] = static_cast<int32_t>(b->draw_level());
  }
}

// Bulk-link level-0 nodes from device-computed candidate lists
// (ascending by distance). The diversity heuristic runs here with
// on-demand distance evaluation and early termination — C++ owns the
// vector buffers, so random row reads are cheap, unlike device gathers.

// `threads > 1` runs the link pass hnswlib-style: workers claim nodes
// off an atomic cursor and all row mutations go through the row-lock
// pool (the same template path insert_batch_parallel uses). Forward
// rows stay deterministic per node (they depend only on the candidate
// arrays); only back-link slot order varies with interleaving, and the
// refine pass re-canonicalizes rows anyway.
void hnsw_bulk_link_heuristic_l0(Builder* b, const int64_t* node_ids,
                                 int64_t count, int32_t c,
                                 const int32_t* cand_idx,
                                 const float* cand_dist, int32_t threads) {
  if (count <= 0) return;
  // phase A: register every node (norms + watermark) BEFORE any
  // linking. Candidate lists span the whole batch, so the diversity
  // heuristic reads candidates' norms regardless of processing order —
  // registering lazily left intra-batch forward candidates with zero
  // norms (cosine dist clamps to 1.0: pruning silently skipped) and,
  // threaded, raced the link workers' norm reads.
  for (int64_t i = 0; i < count; ++i) {
    int64_t node = node_ids[i];
    b->register_node(node);
    b->levels[node] = 0;
    b->mark_dirty(node);
  }
  int64_t i0 = 0;
  std::vector<int64_t> kept;
  std::vector<Builder::DistNode> prune_scratch;
  if (b->entry < 0) {
    // seed on the calling thread so workers always see an entry point
    bulk_link_one<false>(b, node_ids, c, cand_idx, cand_dist, 0, kept,
                         prune_scratch);
    b->entry = node_ids[0];
    b->top_level = 0;
    i0 = 1;
  }
  threads = static_cast<int32_t>(
      std::max<int64_t>(1, std::min<int64_t>(threads, count - i0)));
  if (threads <= 1) {
    for (int64_t i = i0; i < count; ++i) {
      bulk_link_one<false>(b, node_ids, c, cand_idx, cand_dist, i, kept,
                           prune_scratch);
    }
    return;
  }
  b->ensure_row_locks();  // single-threaded here, before workers spawn
  std::atomic<int64_t> cursor{i0};
  auto worker = [&]() {
    std::vector<int64_t> w_kept;
    std::vector<Builder::DistNode> w_scratch;
    for (;;) {
      int64_t i = cursor.fetch_add(1, std::memory_order_relaxed);
      if (i >= count) break;
      bulk_link_one<true>(b, node_ids, c, cand_idx, cand_dist, i, w_kept,
                          w_scratch);
    }
  };
  std::vector<std::thread> pool;
  pool.reserve(threads);
  for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

// NN-descent-style level-0 refinement for bulk-built graphs: re-run the
// diversity heuristic over {current neighbors} U {neighbors of
// neighbors} per node, in place. A bulk graph's candidates come from a
// batched top-K scan; one NoN round lets each node see the best rows its
// *neighbors* found (the NN-descent convergence argument), and the
// diversity selection keeps the shortcut edges navigability needs.
// Symmetric coverage comes from running over all nodes (v appears as a
// NoN candidate of its own neighbors). `threads > 1` parallelizes each
// round over nodes (atomic cursor + row-lock-copied reads/writes, the
// NN-descent convention: concurrent in-place updates only change which
// intermediate rows a node happens to see — every candidate is still a
// real row and the diversity selection is per-node); rounds stay
// barrier-separated.

void hnsw_refine_l0(Builder* b, int32_t rounds, int32_t threads) {
  int64_t n = b->num_nodes.load(std::memory_order_relaxed);
  if (n <= 0 || rounds <= 0) return;
  threads = static_cast<int32_t>(
      std::max<int64_t>(1, std::min<int64_t>(threads, n)));
  if (threads <= 1) {
    RefineScratch s;
    s.seen.assign(b->cap, 0);
    s.row_buf.resize(b->m0);
    for (int32_t r = 0; r < rounds; ++r) {
      for (int64_t v = 0; v < n; ++v) {
        if (b->levels[v] < 0) continue;
        refine_one<false>(b, v, n, s);
      }
    }
    return;
  }
  b->ensure_row_locks();
  for (int32_t r = 0; r < rounds; ++r) {
    std::atomic<int64_t> cursor{0};
    auto worker = [&]() {
      RefineScratch s;
      s.seen.assign(b->cap, 0);
      s.row_buf.resize(b->m0);
      for (;;) {
        int64_t v = cursor.fetch_add(1, std::memory_order_relaxed);
        if (v >= n) break;
        if (b->levels[v] < 0) continue;
        refine_one<true>(b, v, n, s);
      }
    };
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int32_t t = 0; t < threads; ++t) pool.emplace_back(worker);
    for (auto& th : pool) th.join();
  }
}

int64_t hnsw_entry(Builder* b) { return b->entry; }
int32_t hnsw_top_level(Builder* b) { return b->top_level; }
int64_t hnsw_num_nodes(Builder* b) {
  return b->num_nodes.load(std::memory_order_relaxed);
}
int32_t hnsw_num_upper_levels(Builder* b) { return b->upper_count; }

// copy upper-level adjacency (level >= 1) into caller buffer [n, m]
void hnsw_get_upper(Builder* b, int32_t level, int32_t* out, int64_t n) {
  const auto& src = b->adj_upper[level - 1];
  std::memcpy(out, src.data(), sizeof(int32_t) * n * b->m);
}

int64_t hnsw_descend(Builder* b, const float* q) {
  Scratch* scr = b->acquire_scratch();
  int64_t r = b->descend(q, *scr);
  b->release_scratch(scr);
  return r;
}

void hnsw_descend_batch(Builder* b, const float* qs, int64_t count,
                        int64_t* out) {
  Scratch* scr = b->acquire_scratch();
  for (int64_t i = 0; i < count; ++i) {
    out[i] = b->descend(qs + i * b->dim, *scr);
  }
  b->release_scratch(scr);
}

int32_t hnsw_search(Builder* b, const float* q, int32_t ef,
                    int32_t* out_ids, float* out_dists) {
  Scratch* scr = b->acquire_scratch();
  int32_t n = b->search(q, ef, out_ids, out_dists, *scr);
  b->release_scratch(scr);
  return n;
}

// Batched host search: one FFI crossing for the whole query block.
// out_ids/out_dists are [count, ef]; out_counts is [count]; unused tail
// slots are left untouched.
//
// Fan-out runs on a PERSISTENT process-wide worker pool (ADVICE round
// 2): per-call std::thread spawn/join paid creation latency on every
// batch, and N concurrent server streams each spawning cpu_count
// workers oversubscribed the host N-fold. The pool holds a fixed
// (threads-1) workers created once; callers always participate in their
// own job, so pool size 0 degrades to the old sequential path and total
// runnable threads stay bounded by workers + active callers.
//
// A job's lifetime is the caller's call: the caller takes its job off the
// queue when its queries are done and returns only once no worker is
// still inside the job (`active`). (The JAX package's copy returns as
// soon as the queries are done and leaves the job queued, so a worker
// that wakes late reads the job's Builder after Python may have freed it;
// a use after free that corrupts the heap when an index dies right after
// a batched search.)
namespace {

struct SearchJob {
  Builder* b;
  const float* qs;
  int64_t count;
  int32_t ef;
  int32_t* out_ids;
  float* out_dists;
  int32_t* out_counts;
  std::atomic<int64_t> cursor{0};
  std::atomic<int64_t> done{0};
  std::atomic<int32_t> active{0};  // pool workers inside the job
  std::mutex done_mu;
  std::condition_variable done_cv;

  // claim-and-run one query; returns false when the job is exhausted
  bool run_one(Scratch& scr) {
    int64_t i = cursor.fetch_add(1, std::memory_order_relaxed);
    if (i >= count) return false;
    out_counts[i] = b->search(qs + i * b->dim, ef, out_ids + i * ef,
                              out_dists + i * ef, scr);
    if (done.fetch_add(1, std::memory_order_acq_rel) + 1 == count) {
      std::lock_guard<std::mutex> g(done_mu);
      done_cv.notify_all();
    }
    return true;
  }
};

struct SearchPool {
  std::mutex mu;
  std::condition_variable cv;
  std::deque<std::shared_ptr<SearchJob>> jobs;
  std::vector<std::thread> workers;
  bool shutdown = false;

  void start(int n) {
    for (int t = 0; t < n; ++t) {
      workers.emplace_back([this]() { worker_loop(); });
    }
  }

  void worker_loop() {
    for (;;) {
      std::shared_ptr<SearchJob> job;
      {
        std::unique_lock<std::mutex> g(mu);
        cv.wait(g, [&] { return shutdown || !jobs.empty(); });
        if (shutdown) return;
        job = jobs.front();  // shared: many workers drain one job
        // joined under `mu`: once its caller has dequeued the job, no
        // worker joins it any more
        job->active.fetch_add(1, std::memory_order_acq_rel);
      }
      if (job->cursor.load(std::memory_order_relaxed) < job->count) {
        Scratch* scr = job->b->acquire_scratch();
        while (job->run_one(*scr)) {
        }
        job->b->release_scratch(scr);
      }
      {
        std::lock_guard<std::mutex> g(mu);
        if (!jobs.empty() && jobs.front() == job) jobs.pop_front();
      }
      job->active.fetch_sub(1, std::memory_order_acq_rel);
      {
        std::lock_guard<std::mutex> g(job->done_mu);
      }
      job->done_cv.notify_all();
    }
  }

  void retire(const std::shared_ptr<SearchJob>& job) {
    std::lock_guard<std::mutex> g(mu);
    auto it = std::find(jobs.begin(), jobs.end(), job);
    if (it != jobs.end()) jobs.erase(it);
  }

  void submit(const std::shared_ptr<SearchJob>& job) {
    {
      std::lock_guard<std::mutex> g(mu);
      jobs.push_back(job);
    }
    cv.notify_all();
  }

  ~SearchPool() {
    {
      std::lock_guard<std::mutex> g(mu);
      shutdown = true;
    }
    cv.notify_all();
    for (auto& w : workers) w.join();
  }
};

SearchPool* search_pool(int32_t requested_threads) {
  // sized once from the first caller's request; nullptr when fan-out
  // is pointless (single-threaded request or single-core host)
  static SearchPool* pool = [&]() -> SearchPool* {
    int n = requested_threads - 1;
    if (n <= 0) return nullptr;
    auto* p = new SearchPool();
    p->start(n);
    return p;
  }();
  return pool;
}

}  // namespace

void hnsw_search_batch(Builder* b, const float* qs, int64_t count,
                       int32_t ef, int32_t* out_ids, float* out_dists,
                       int32_t* out_counts, int32_t threads) {
  SearchPool* pool =
      (threads > 1 && count > 1) ? search_pool(threads) : nullptr;
  if (pool == nullptr) {
    Scratch* scr = b->acquire_scratch();
    for (int64_t i = 0; i < count; ++i) {
      out_counts[i] = b->search(qs + i * b->dim, ef, out_ids + i * ef,
                                out_dists + i * ef, *scr);
    }
    b->release_scratch(scr);
    return;
  }
  auto job = std::make_shared<SearchJob>();
  job->b = b;
  job->qs = qs;
  job->count = count;
  job->ef = ef;
  job->out_ids = out_ids;
  job->out_dists = out_dists;
  job->out_counts = out_counts;
  pool->submit(job);
  // the caller works its own job too (no idle wait, no deadlock at
  // pool size 0, bounded total threads under concurrent streams)
  Scratch* scr = b->acquire_scratch();
  while (job->run_one(*scr)) {
  }
  b->release_scratch(scr);
  {
    std::unique_lock<std::mutex> g(job->done_mu);
    job->done_cv.wait(g, [&] {
      return job->done.load(std::memory_order_acquire) == job->count;
    });
  }
  // off the queue, then wait out the workers still inside the job: the
  // Builder and the caller's buffers may go once this returns
  pool->retire(job);
  std::unique_lock<std::mutex> g(job->done_mu);
  job->done_cv.wait(g, [&] {
    return job->active.load(std::memory_order_acquire) == 0;
  });
}

// Restore a previously exported graph (the .vlc "graph" extension —
// avoids the reference's O(N·insert) rebuild-on-load). Level-0 adjacency
// and levels are already in the Python-owned buffers; upper levels are
// loaded here.
void hnsw_restore(Builder* b, int64_t num_nodes, int64_t entry,
                  int32_t top_level, int32_t num_upper,
                  const int32_t* upper /* [num_upper, num_nodes, m] */) {
  b->num_nodes.store(num_nodes, std::memory_order_relaxed);
  b->entry = entry;
  // clamp: a dump claiming more levels than the fixed slot count would
  // otherwise index past adj_upper[] on the first descend (Python-side
  // validation rejects such dumps and rebuilds; this is the backstop)
  b->top_level = std::min(top_level, kMaxUpperLevels);
  for (int l = 0; l < b->upper_count; ++l) b->adj_upper[l].clear();
  b->upper_count = std::min<int32_t>(num_upper, kMaxUpperLevels);
  if (b->top_level > b->upper_count) b->top_level = b->upper_count;
  for (int32_t l = 0; l < b->upper_count; ++l) {
    b->adj_upper[l].assign(b->cap * b->m, -1);
    std::memcpy(b->adj_upper[l].data(),
                upper + static_cast<int64_t>(l) * num_nodes * b->m,
                sizeof(int32_t) * num_nodes * b->m);
  }
  // recompute norms for the restored vectors
  for (int64_t i = 0; i < num_nodes; ++i) {
    const float* v = b->vecs + i * b->dim;
    float sq = vl_dot(v, v, b->dim);
    b->sqnorms[i] = sq;
    b->norms[i] = std::sqrt(sq);
  }
}

// drain the level-0 dirty row list; returns count copied (deduped by caller)
int64_t hnsw_drain_dirty(Builder* b, int32_t* out, int64_t max_out) {
  std::lock_guard<std::mutex> g(b->dirty_mu);
  int64_t n = std::min<int64_t>(b->dirty.size(), max_out);
  std::memcpy(out, b->dirty.data(), sizeof(int32_t) * n);
  if (n == static_cast<int64_t>(b->dirty.size())) {
    b->dirty.clear();
  } else {
    b->dirty.erase(b->dirty.begin(), b->dirty.begin() + n);
  }
  return n;
}

int64_t hnsw_dirty_count(Builder* b) {
  std::lock_guard<std::mutex> g(b->dirty_mu);
  return static_cast<int64_t>(b->dirty.size());
}

}  // extern "C"
