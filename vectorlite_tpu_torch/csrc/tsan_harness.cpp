// ThreadSanitizer harness for the parallel HNSW builder.
//
// Exercises the concurrent paths under TSan (works on a single core —
// TSan detects races from the happens-before graph, not from timing):
//   1. multi-threaded insert_batch_parallel (row locks, global entry
//      lock, dirty list, scratch pool, atomic num_nodes)
//   2. concurrent searches + descends against the finished graph
//      (lock-free row reads + pooled scratches)
//   3. multi-threaded hnsw_bulk_link_heuristic_l0 + hnsw_refine_l0 on
//      a second builder (the bulk path's worker pools)
//   4. drain_dirty racing further inserts is NOT exercised — Python's
//      collection write lock forbids it by contract.
//   5. batched searches on the persistent search pool, each builder
//      freed as soon as its search returns (no pool worker may still be
//      inside the job).
//
// Build & run (kernels/_build.py is not involved; tests/test_torch_hnsw.py
// invokes this via g++ -fsanitize=thread when the toolchain supports it):
//   g++ -fsanitize=thread -O1 -g -std=c++17 -pthread \
//       -DVL_TSAN_HARNESS tsan_harness.cpp -o /tmp/vl_tsan && /tmp/vl_tsan
// Exit code 0 + no TSan report = clean.

#include "hnsw_builder.cpp"  // same TU: extern "C" defs + Builder visible

#include <cstdio>
#include <cstdlib>
#include <thread>
#include <vector>

int main() {
  const int64_t n = 4000;
  const int32_t dim = 24, m = 8, m0 = 16, efc = 48;
  std::vector<float> vecs(n * dim), sqn(n), nrm(n);
  std::vector<int32_t> levels(n, -1), adj0(n * m0, -1);
  // deterministic pseudo-random corpus
  uint64_t s = 0x9E3779B97F4A7C15ull;
  for (auto& x : vecs) {
    s ^= s << 13;
    s ^= s >> 7;
    s ^= s << 17;
    x = static_cast<float>(static_cast<int64_t>(s % 2001) - 1000) / 500.f;
  }

  Builder* b = hnsw_new(dim, METRIC_COSINE, m, m0, efc, 42);
  hnsw_bind(b, vecs.data(), sqn.data(), nrm.data(), levels.data(),
            adj0.data(), n);

  // phase 1: concurrent build
  hnsw_insert_batch_parallel(b, 0, n, 8);

  // drain dirty rows (single-threaded by contract)
  std::vector<int32_t> dirty(n * 4);
  while (hnsw_dirty_count(b) > 0) {
    hnsw_drain_dirty(b, dirty.data(), dirty.size());
  }

  // phase 2: concurrent searches + descends
  std::vector<std::thread> pool;
  std::atomic<int> errors{0};
  for (int t = 0; t < 8; ++t) {
    pool.emplace_back([&, t]() {
      std::vector<int32_t> ids(64);
      std::vector<float> ds(64);
      for (int i = 0; i < 200; ++i) {
        const float* q = vecs.data() + ((t * 199 + i * 37) % n) * dim;
        int got = hnsw_search(b, q, 32, ids.data(), ds.data());
        if (got <= 0) errors.fetch_add(1, std::memory_order_relaxed);
        hnsw_descend(b, q);
      }
    });
  }
  for (auto& th : pool) th.join();

  if (errors.load() > 0) {
    std::fprintf(stderr, "FAIL: %d empty searches\n", errors.load());
    return 1;
  }
  // self-query should find itself at distance ~0
  std::vector<int32_t> ids(16);
  std::vector<float> ds(16);
  int got = hnsw_search(b, vecs.data() + 123 * dim, 8, ids.data(), ds.data());
  if (got < 1 || ids[0] != 123) {
    std::fprintf(stderr, "FAIL: self-search got n=%d top=%d\n", got,
                 got > 0 ? ids[0] : -1);
    return 1;
  }
  hnsw_free(b);

  // phase 3: threaded bulk link + refine on a fresh builder. Candidate
  // lists are the nearest rows by brute force over a small prefix —
  // quality is irrelevant here, only the locking discipline is.
  {
    std::vector<int32_t> levels2(n, -1), adj2(n * m0, -1);
    Builder* b2 = hnsw_new(dim, METRIC_COSINE, m, m0, efc, 7);
    hnsw_bind(b2, vecs.data(), sqn.data(), nrm.data(), levels2.data(),
              adj2.data(), n);
    const int32_t c = 12;
    std::vector<int64_t> nodes(n);
    std::vector<int32_t> cand(n * c);
    std::vector<float> cdist(n * c);
    for (int64_t i = 0; i < n; ++i) {
      nodes[i] = i;
      for (int32_t j = 0; j < c; ++j) {
        int64_t other = (i + 1 + j * 131) % n;
        cand[i * c + j] = static_cast<int32_t>(other);
        // any positive pseudo-distance keeps the heuristic branchy
        cdist[i * c + j] = 0.1f + static_cast<float>((i * 7 + j) % 97);
      }
    }
    hnsw_bulk_link_heuristic_l0(b2, nodes.data(), n, c, cand.data(),
                                cdist.data(), 8);
    hnsw_refine_l0(b2, 2, 8);
    while (hnsw_dirty_count(b2) > 0) {
      hnsw_drain_dirty(b2, dirty.data(), dirty.size());
    }
    std::vector<int32_t> ids2(16);
    std::vector<float> ds2(16);
    int got2 =
        hnsw_search(b2, vecs.data() + 55 * dim, 8, ids2.data(), ds2.data());
    if (got2 < 1) {
      std::fprintf(stderr, "FAIL: bulk-built graph empty search\n");
      return 1;
    }
    hnsw_free(b2);
  }

  // phase 5: batched searches on the persistent pool, the builder freed
  // right after each returns
  for (int round = 0; round < 20; ++round) {
    const int64_t rn = 300;
    std::vector<int32_t> lv(rn, -1), a0(rn * m0, -1);
    Builder* b3 = hnsw_new(dim, METRIC_COSINE, m, m0, efc, 100 + round);
    hnsw_bind(b3, vecs.data(), sqn.data(), nrm.data(), lv.data(), a0.data(),
              rn);
    hnsw_insert_batch(b3, 0, rn);
    const int64_t nq = 3;
    const int32_t ef = 8;
    std::vector<int32_t> oid(nq * ef), cnt(nq);
    std::vector<float> od(nq * ef);
    hnsw_search_batch(b3, vecs.data(), nq, ef, oid.data(), od.data(),
                      cnt.data(), 8);
    hnsw_free(b3);
    if (cnt[0] < 1) {
      std::fprintf(stderr, "FAIL: pooled search empty\n");
      return 1;
    }
  }

  std::puts("tsan harness OK");
  return 0;
}
