"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py [--rows N] [--ivf-rows N] [--seed S] [--batches N]

Phases (any failure raises and the exit code is not 0):

1. Card: name and power limit (nvidia-smi), torch/CUDA versions, and the
   build of every native source under vectorlite_tpu_torch/csrc (scan.cu,
   lanes.cu, exact.cu, wide.cu, select.cu, l1.cu, pq.cu, ivf.cu with nvcc,
   host_rescore.cpp, vlc_emit.cpp and hnsw_builder.cpp with g++; one
   compiler per source, all started together); the wide mode's
   shared-memory plans.
2. Kernels against their plain-torch versions on the card: K1 and K2 on
   the route scan.exact_route names (k <= 32: the tensor-core body's
   per-query top-k, scan_topk_exact_tf32 over f32 rows, _bf16 over bf16
   rows, scan_topk_exact_s8 over int8 rows; k 1, 16, 32; 32 < k <= 256:
   its wide mode, scan_topk_wide_tf32 / _bf16 / _s8, k 33, 100, 256; k >
   256 and tiles past 32,768 rows: its scores into the radix select,
   scan_topk_select_tf32 / _bf16 / _s8, k 257, 300, 512, 1,024, 2,048,
   2,100 and 4,096 on the tiles scan.exact_tile grows, and tile by tile at
   k = tile_n = 2,048 and 4,096, k 300 and 2,100 over 32,768-row tiles and
   k 300 over 65,536), K3 on its four routes (int8 rows: scan_block_topw_s8, the
   tensor-core body's int8 form; bf16 rows: scan_block_topw_bf16; f32 rows:
   scan_block_topw_tf32, its 3xTF32 form, at W 1, 2 and 3; W 4 over f32
   rows: scan_block_topw, the CUDA-core body; three metrics), K4 on the route
   exact_route names (k <= 32: the FADD stream's lists, scan_topk_l1_fadd
   over f32 rows, _bf16 over bf16 rows; k 1, 16, 32; k > 32: its scores
   into the radix select, scan_topk_l1_select / _bf16, k 33, 100, 300 and
   1,024 on the tiles exact_tile grows), at N=65,536 x 384, B=64, and at
   an odd shape (8,192 x 100, B=5: 200-byte bf16 rows, which TMA refuses,
   take the plain-load staging).
   Then each kernel at the main-path shape (2^20 x 384, B=256, four query
   blocks; K1 over f32 rows at k 16 and bf16 rows at k 32, K2 at k 32, and
   the wide mode at k 100's lists: K1 over f32 rows at 128, over bf16 rows
   at 256, K2 at 256; K3 on each route at W 2, the CUDA-core body at W 4;
   K4 over f32 rows at k 16, over bf16 rows at the memory-optimized pool of
   32 and at k 16, and its select entries at the paths' lists on the tiles
   exact_tile grows: over f32 rows at k 100's k_pad of 128 and at k 300 and
   1,000's k_pad of 1,024, over bf16 rows at k 100's pool of 256): timed
   beside its plain version and the PyTorch library path (K3's: one torch.mm, bf16 over the int8 or bf16
   values cast outside the timing, TF32-off f32 over f32 rows, then
   torch.topk of each lane group; K4's: 1 / (1 + torch.cdist(p=1)) and
   torch.topk), and its output held against the plain
   version's; K3 over f32 rows (either body) priced, as K1 over f32 rows
   is, at the three tf32 passes of an exact f32 dot, K4 at two FADDs a (query, row,
   dimension). The radix select's entries at the paths' shapes, on the
   tiles exact_tile grows (K1 over f32 rows at k 300 and at k_pad 1,024,
   4,096 and 8,192, over bf16 rows at the pools of 512 and 4,096, K2 at k
   300 and the pools of 1,024 and 4,096; the bound counts the function's
   bytes and operations, a second bound the scratch's device-memory
   traffic too where a group of its scores outgrows L2) and at 65,536 x
   384, B 64, k 2,100 over 4,096-row tiles (the old CUDA-core entries'
   shape), the same way, merge_topk's sort apart. Everywhere: ids
   equal except among scores within 1e-5 of each other, scores within
   rtol/atol 1e-5.
   K5 against pq_rank_plain, both entries: the tensor-core entry
   (pq_rank_mma) on 4-bit codes, packed and unpacked, and the look-up
   entry (pq_rank) on kc = 256 and on 4-bit codes, 4 metrics each, at
   65,536 x 384, B = 64, and at an odd shape (8,192 rows, M = 33, B = 5);
   then at the main-path shape (2^20 rows, M = 192 packed, B = 256, every
   2^18-row chunk the 4-bit PQ path hands it, all 256 queries) the
   tensor-core entry held against the plain rank and timed beside the
   look-up entry, the plain rank, a bf16 torch.mm with a prebuilt one-hot
   (the library yardstick) and the chunk selection, with the L2 bytes the
   design reads; then the look-up entry at the 8-bit path's shape (the
   chunk the index hands it, 2^16 rows, M 96, kc 256, B 256), held and
   timed beside its plain version and the same one-hot torch.mm and its
   shared-memory bound (the look-ups' bytes at the SMs' shared-memory
   rate).
   Tolerance: the same -inf pattern, finite ranks within rtol/atol 2e-5
   (f32 sums of the same exact bf16 values taken in another order).
   K6 (gather_score) against gather_score_plain: bf16 and int8 blocks,
   D = 384 and 100, P = 128 and 640, B = 5, 64 and 320, L = 3 and 16, with ids
   random (one query probing one cell again and again, one in descending
   order), shared (every query probes the same L cells) and all on one
   cell; then at the IVF shape (C = 4,096, P = 640, D = 384, B = 64,
   L = 16) on both layouts and every id pattern, the random ids timed
   beside the plain version and a torch.bmm of the blocks gathered
   outside the timing (the library yardstick), the shared and single-cell
   ids beside their bound. Tolerance: |diff| <= 1e-5
   * max(1, max |out|) (f32 sums of the same products taken in another
   order).
   K7 (scan_merge_topw) against merge_topw_plain: f32 rows (3xTF32) and
   bf16 rows, both on the tensor-core body, three metrics, W 1-3, 5%
   invalid rows and a lane group with one live row, at 65,536 x 384, B 64
   (tile 16,384), 8,192 x 100, B 5 (tile 2,048: 200-byte rows, which TMA
   refuses, take the plain-load staging) and 8,192 x 768, B 70 (tile
   2,048: the query terms too wide to stay in shared memory ride each
   stage; two query blocks); K8 (scan_fold_probe, the tensor-core body)
   against fold_probe_plain in every mode at tiles 8,192 and 16,384
   (65,536 x 384, B 64; 16,384 x 100, B 5; 16,384 x 768, B 70). Then both at
   the headline shape (2^20 x 384 bf16 rows, B 256): K7 at W 2 and 3,
   tile 16,384 (cosine), beside a bf16 torch.mm + per-lane-group
   torch.topk, and over the f32 rows at W 2 beside a TF32-off f32 torch.mm
   + the same top-k (priced at three tf32 passes); K8 in every mode at both tiles beside a bf16 torch.mm +
   row max; each line with the bound (one bf16 pass, the table's) and the
   tensor work of the design's three bf16 passes. Tolerance: the same -inf
   pattern, scores within rtol/atol 1e-5 (K7's dot lists over f32 rows,
   which reach dots near 0 in the lane group with one live row, against
   float64: no farther from it than the plain version's, in rms and near
   0), ids equal per lane group except among scores within 1e-5 (K8
   maxonly: a list may differ where it holds two scores within 1e-5); K8
   none's raw dots as K6's.
3. Main path through the SDK at 2^20 x 384 (random rows from the seed),
   batches of 256, k=10: the default call with the precision guard on
   (whichever kernel it picks on this corpus), then with the guard off
   the speed path (K3 over the int8 scan copy: scan_block_topw_s8, +
   exact re-score), approx=False (K1), a where filter (K1), manhattan
   (K4's FADD stream over f32 rows), a `high-accuracy`-profile collection's
   default call (f32 rows without a scan copy: K3 over the rows on its
   3xTF32 form, scan_block_topw_tf32, + exact re-score; it must launch that
   and no other K1-K4 entry; its build seconds printed, its device stage
   taken apart, the collection dropped after), a `quantized`-profile
   collection (K3 on int8 rows, and K2), a `memory-optimized` collection's exact path (K1
   over bf16 rows) and its manhattan path (K4 over bf16 rows), and
   approx=False at k 100 on all three (K1 over f32 and bf16 rows and K2 on
   the wide mode); those three and the high-accuracy call again, taken
   apart into the device stage, merge_topk's sorts in it and the host
   remainder. Launch
   counts are zeroed just before and read just after; every kernel must
   have launched, each exact path on the route exact_route names. Recall@10 of each
   speed path (the high-accuracy call's too) against its exact path must
   be >= 0.99, and of the
   memory-optimized manhattan path against the manhattan path; the cosine and
   manhattan exact paths must agree with float64 truth on 32 queries
   taken across all four query blocks. The quantized speed path runs
   twice: with the native f64 re-score and with VECTORLITE_NO_NATIVE=1.
   Then lists past 256 on the radix select: approx=False at k 1,000 over
   the f32 rows (K1, k_pad 1,024), the memory-optimized collection's exact
   path at k 200 (K1 over bf16 rows, pool 512) and the quantized one's at
   k 500 (K2, pool 1,024): one search_batch call each whose launches must
   be the select entry's alone, then batches through search_batch_arrays
   (p50 / p99, the device stage apart), every query's ids against float64
   truth beyond 1e-5 near-ties. Then lists past 2,048, batches of 64:
   approx=False at k 3,000 (K1, k_pad 4,096), the memory-optimized exact
   path at k 2,000 and the quantized one at k 2,000 (pools of 4,096), the
   same way, with the host remainder and the launches printed. Then
   manhattan past k 32 on K4's radix select: the f32 collection at k 100
   (k_pad 128) and k 1,000 (k_pad 1,024), and the memory-optimized one at
   k 100 (K4 over bf16 rows at the pool of 256, then the f64 re-score): the
   same way (one search_batch call whose K4 launches must be the select
   entry's alone, then p50 / p99 and the device stage), each query of the
   32 the cosine check takes held to float64 truth beyond 1e-5 near-ties
   (one f64 manhattan scan at k 1,000 serves these paths and the k 10
   check).
3b. The device mesh (dist/), after the phase-3 collections are freed, on
   phase 3's rows and queries: cuda:0 repeated 4 times (2^18 rows a shard).
   (a) FlatIndex(mesh=...) beside a one-card FlatIndex of the same rows,
   batches of 256 at k 10 and k 100: the default call with the precision
   guard on (K1 per shard where the guard refuses the speed path), approx=
   False, a where filter, manhattan (K4); with the guard off, on the rows
   below the boundary of shards 2 and 3, the speed path (K3 over the bf16
   scan copy per shard + exact re-score; recall@10 against f64 truth >=
   0.99, beside one card's), then a burst of 4,096 rows across that
   boundary (written in place) and a delete either side, each followed by
   an exact search; the int8 profile (K2). Exact paths hold ids equal
   beyond 1e-5 near-ties and scores within 1e-5 against one card; every
   mesh path launches its kernel 4 times a search. (f) search_batch_stream,
   32 batches of 256 at k 10, depth 2, groups 1 and 4 on one card and group
   1 on the mesh: every batch equal to its search_batch_arrays, batches/s
   beside a sequential loop. (e) A one-rank NCCL process group
   (dist/multihost.py): sharded_search_topk equal to one card's search,
   then the group destroyed. (b) The pq profile on 4 shards of 2^16 rows
   (the first 2^18): K5 launches, recall@10 within 0.01 of one card's. (c)
   sharded_search_ivf on a layout of the rows built by kernels/ivf.py (C
   2,048, 4 cells probed a shard, 64 queries): K6 launches, ids against
   the same call on gather_score_plain. (d) A 2^16-row HNSW index on the
   mesh: the device beam of 256 queries equal to the same graph's
   one-card beam. p50 of every path; the phase's seconds.
4. The `pq` profile through the SDK, after the phase-3 collections are
   freed: the same rows and queries in a `pq`-profile collection (training
   and encoding on the card), batches of 256, k=10: the default call
   (cosine), euclidean, manhattan (the euclidean proxy under rotation)
   and a where filter; then the 8-bit layout (kc 256) on the first 2^18
   rows. Launch counts are zeroed just before the four 4-bit paths and
   read just after them, then zeroed again just before the 8-bit path and
   read just after it; K5's tensor-core entry must serve every 4-bit path
   and its look-up entry the 8-bit one, and the native re-score must have
   served. Each path's ids
   must equal, beyond 1e-5 near-ties, those of the same pipeline with the
   plain rank; self-hit (256 stored rows + N(0, 0.01^2) noise return
   their row first) >= 0.99; recall@10 of the cosine path against phase
   3's exact K1 results >= 0.90.
5. The IVF rung through the SDK, after the phase-4 collection is freed:
   --ivf-rows (2,000,000) x 384 clustered rows (bench/probe_scale8m.py's
   make_clustered geometry, 2,048 clusters, --seed), queries fresh draws
   from the same mixture, k=10. The first search builds the layout (timed;
   C, P, the nprobe floor, extras, layout dtype and the precision guard's
   verdict reported); the phase fails unless IVF activates. Batches of 64
   (halved while B * nprobe * P exceeds half the live rows): cosine (the
   default call), euclidean and dot through IVF, with the counts zeroed
   just before each and read just after (K6 must launch, K1 and K3 must
   not); then the brute engines on the same collection and batches:
   approx=False (K1), and the default call with the layout set aside (the
   speed path K3, or K1 where the precision guard refuses it).
   Recall@10 of the cosine path against K1 >= 0.99 (256 queries); each
   IVF path's ids equal, beyond 1e-5 near-ties, those of the same pipeline
   with gather_score_plain. One batch of 256 falls through to the brute
   engine (no K6). 4,096 appended rows ride the tail (the layout's
   watermark stays) and each comes back first for itself + N(0, 0.01^2)
   noise; 1,000 deleted rows never come back. Then a `quantized`-profile
   collection of the same rows: an int8 layout, K6 on its int8 branch,
   the native f64 re-score, recall@10 >= 0.99 against its exact K2.
   Every path: p50/p99/QPS, device stage (dispatch to synchronize) and
   host time; the phase's time and the peak host RSS.
6. bench/probe_headline_r5.py's merge-engine probe, after the phase-5
   collections are freed: 2^20 x 384 N(0, 1) rows (f32, and a bf16 copy)
   and 256 queries from --seed, k = 16, k_sel 128, cosine. The tournament
   merge (K7) + exact f32 re-score as merge_w2_t16k, merge_w3_t16k and
   merge_w2_t32k, beside the K3 engine (bf16 copy, tile 4096, W 2:
   scan_block_topw_bf16), the K3 engine over the f32 rows themselves (W 2:
   its 3xTF32 form, scan_block_topw_tf32; W 4: the CUDA-core
   scan_block_topw) and exact K1: p50 ms and QPS from CUDA events, recall@10 against float64
   truth (>= 0.99 each); each merge configuration's ids equal, beyond
   1e-5 near-ties, those of the same pipeline with the plain K7; a
   tombstoned pass (5% of rows invalid) returns none of them; then K8's
   decomposition of the tensor-core body (none: its contraction; maxonly
   and full: the lane-group selection on the accumulators on top of it;
   tiles 8192 and 16384) beside K3 on the same body at the same shape.
   Launch counts are zeroed just before and read just after; K7, K8 and
   K3's bf16, 3xTF32 and CUDA-core routes must have launched.
7. The collection surface and persistence through the SDK, after the
   phase-6 arrays are freed, on phase 3's rows, each with a text and
   {"bucket": i % 16, "tag": ...} (MockEmbeddingFunction(384)):
   (a) 64 threads issue 1,024 single search_text_in_collection calls, k
   10, on a collection built with the precision guard on (whichever kernel
   it picks) and on one built with VECTORLITE_SPEED_GUARD=0 (K3 over the
   int8 scan copy), coalesced and then with VECTORLITE_COALESCE=0:
   requests/s, p50/p99 a request, the coalescer's batch-size histogram and
   the launches; every result held against a direct search_batch of the
   same queries (ids equal beyond 1e-5 near-ties, scores within 1e-5).
   (b) delete_where on one bucket, compact, list_vectors pages with and
   without a where, update_metadata on 1,000 ids, get_vectors on 1,000 ids,
   update_text, each timed; then a filtered batch of 256 (K1 with the mask)
   against an f64 numpy scan over the matching rows. (c) The BM25 sidecar
   (built on 2^17 rows when a 2^16-text build projects past 60 s) and 256
   search_hybrid calls. (d) save_to_file through the native emitter (its
   count must move) and load_from_file into a fresh card client (run on
   2^17 rows when a 2^16-row save and load project past 80% of the free
   disk or 60 s): the batch of 256, the default call and a where filter,
   bit-identical before and after, the f64 truth exactly. (e) A WAL
   manager and an autosave directory: 10,000 rows in batches, deletes and
   metadata updates, one snapshot, more writes, the client dropped without
   close; a fresh card client restores and replays to the live state.
   Launch counts are zeroed just before each counted run and read just
   after; the kernels line adds them to phases 3-6's.
8. HTTP on the card, after phase 7, on its guard-on collection (kept) and
   a guard-off one of the same rows: the port's server (standard library,
   bound to 127.0.0.1:0, served from a thread over that card client).
   (a) 64 connections, from a process of their own, send 1,024 single
   POST /search/text, k 10, to each
   (K1, K3 over the int8 scan copy): requests/s, p50/p99 a request beside
   phase 7 (a)'s SDK figures, the coalescer's histogram; every result
   held against a direct search_batch. (b) POST /search/vectors, batches
   of 256: k 10, k 100 (K1 wide), a where (K1 with the mask), manhattan
   (K4); p50 each, held against the SDK's answer to the same call. (c)
   32,768 fresh rows over POST /vectors in bodies of 4,096: rows/s and
   request MB/s; each comes back first for itself. (d) GET /snapshot of
   a 2^15-row collection streamed to disk and POSTed back under a new
   name: bytes and seconds each way; a batch of 256 bit-identical on both.
   (e) /stats and /metrics count (a)'s requests; POST /debug/trace while 8
   connections search: the trace names a port kernel; a second server with
   an API key: 401 without it, 200 with it, CORS headers on both. (f)
   python -m vectorlite_tpu_torch.cli --mock-embeddings on the card with a
   WAL and an autosave directory: 10,000 add_texts rows, deletes, metadata
   updates, kill -9, restart to /health: every acknowledged write back, the
   searches equal. Launch counts are zeroed just before each counted run
   and read just after; K1, K3 and K4 must launch from HTTP requests.
9. The MiniLM embedder and HNSW on the card, after phase 8's arrays are
   freed. (a) MiniLM at its full published width (384 hidden, 6 layers,
   12 heads, 1,536 intermediate, 30,522 vocab) from random_init(seed=0):
   texts/s and p50 a batch of embed_batch_arrays at batches 1, 32 and 256
   of texts of 8, 40 and 100 words (the 16-, 64- and 128-token buckets),
   every embedding within 1e-4 of the same parameters' CPU forward; a
   synthetic model directory (config.json, a pytorch_model.bin of those
   parameters, a WordPiece tokenizer.json giving the texts' words the
   random-init tokenizer's ids) loaded by from_pretrained embeds within
   1e-5 of random_init. (b) VectorLiteClient(MiniLMEmbedder): add_texts in
   batches of 256, 2^17 texts into each of two Flat collections (the
   kernels' 2^17-row floor; one searched with the precision guard on, K1
   on these embeddings, one built with it off, K3 over the int8 scan copy)
   and 2^16 into an HNSW one (cosine, M 16): texts/s; 512 single
   search_text calls (p50/p99) and search_texts in batches of 256 (p50) on
   each, every result held against a search_batch of the embeddings
   computed apart (Flat: ids beyond 1e-5 near-ties, scores within 1e-5;
   HNSW: the same native search); K1 and K3 must launch. (c) HNSW at a deployment's size: 1,000,000 x 384 rows of
   bench/bulk_1m.py:41 make_embeddings's geometry (256 clusters, spread
   0.35, unit norm, seed 0); a 2^18-row bulk build (VECTORLITE_BULK_BUILD=
   always) projects the 1M build, which then engages the bulk build by
   itself through add_batch_arrays (auto, past VECTORLITE_BULK_AUTO_ROWS
   on the card) unless it projects past 300 s, when (c) keeps the 2^18
   rows (logged); build seconds, inserts/s, the scan / link / upper /
   refine split (VECTORLITE_BULK_PROFILE) and K1 wide launches (> 0);
   recall@10 against f64 truth on 1,000 queries (bench/bulk_1m.py's
   recall_at recipe) at ef 64 and 128 (>= 0.95 at 128); the native search
   at batches 1 and 256, p50 and QPS; the device beam (use_device=True)
   on a batch of 256, p50 and overlap with the native search >= 0.9; a
   classic threaded build of the first 65,536 rows, inserts/s. (d) A
   2^16-row HNSW collection saved to .vlc and loaded into a fresh card
   client (same ids and scores); WAL + autosave over an HNSW collection
   (one build thread), dropped without close, restored and replayed into
   a fresh card client (state and searches equal); over HTTP, POST
   /collections with index_type "hnsw", POST /text and POST /search/text
   with ef, held against the SDK. Launch counts are zeroed just before
   each counted run and read just after; the kernels line adds them.
10. Each phase's seconds and the total, a `kernels` JSON line, the card
   line, and last {"ok": true, "device": {...}}.

The native sources build into vectorlite_tpu_torch/csrc/build/
(git-ignored).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import subprocess
import sys
import time

import numpy as np
import torch

D = 384
B = 256
K = 10
K_WIDE = 100  # phase 3's wide exact searches: lists past the TOPK mode's 32
#: phase 3's deep exact searches by row type: k_pad 1,024 over f32 rows, the
#: 2x pools of 512 (bf16) and 1,024 (int8): lists past the wide mode's 256,
#: on the radix select
K_DEEP = {"f32": 1000, "bf16": 200, "int8": 500}
#: phase 3's exact searches past 2,048 by row type (k_pad 4,096 over f32
#: rows, the 2x pools of 4,096 over bf16 and int8 rows), in batches of
#: SELECT_BATCH: the radix select's lists
K_SELECT = {"f32": 3000, "bf16": 2000, "int8": 2000}
SELECT_BATCH = 64
#: H100's L2: a group of the radix select's scores larger than this goes
#: through device memory (its design bound then counts the scratch written
#: and read once)
L2_BYTES = 50e6

#: NVIDIA H100 SXM data sheet (dense, 700 W): device-memory bandwidth and
#: the peak rate of each operand type the functions need. The reference
#: contracts f32 rows in full f32 (Precision.HIGHEST); on the tensor cores
#: that is three tf32 passes (3xTF32, the rate K1, K3 and K7 over f32 rows
#: are priced at, whichever body computes them; CUDA-core f32 FMAs would
#: take 3.08 ms at the headline shape), int8
#: or bf16 rows at DEFAULT precision (one pass). Manhattan has no matmul
#: form: |q - v| + acc is two FADD instructions (a subtract, then an add
#: with |.| as a source modifier; sm_90 has no packed f32 add), and an FADD
#: issues at the FMA rate, 132 SMs x 128 lanes x 1.98 GHz = 33.5e12 a second
#: ("f32_add", counted in instructions: the "f32" rate of 67e12 counts an
#: FMA as two operations).
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "f32_add": 33.5e12, "tf32": 494.7e12, "bf16": 989e12,
                  "int8": 1979e12}

REPLACES = {
    "scan_topk_exact_tf32": "vectorlite_tpu/kernels/pallas_scan.py:46",
    "scan_topk_exact_bf16": "vectorlite_tpu/kernels/pallas_scan.py:46",
    "scan_topk_wide_tf32": "vectorlite_tpu/kernels/pallas_scan.py:46",
    "scan_topk_wide_bf16": "vectorlite_tpu/kernels/pallas_scan.py:46",
    "scan_topk_select_tf32": "vectorlite_tpu/kernels/pallas_scan.py:46",
    "scan_topk_select_bf16": "vectorlite_tpu/kernels/pallas_scan.py:46",
    "scan_topk_exact_s8": "vectorlite_tpu/kernels/pallas_scan.py:471",
    "scan_topk_wide_s8": "vectorlite_tpu/kernels/pallas_scan.py:471",
    "scan_topk_select_s8": "vectorlite_tpu/kernels/pallas_scan.py:471",
    "scan_block_topw": "vectorlite_tpu/kernels/pallas_scan.py:159",
    "scan_block_topw_s8": "vectorlite_tpu/kernels/pallas_scan.py:159",
    "scan_block_topw_bf16": "vectorlite_tpu/kernels/pallas_scan.py:159",
    "scan_block_topw_tf32": "vectorlite_tpu/kernels/pallas_scan.py:159",
    "scan_topk_l1_fadd": "vectorlite_tpu/kernels/pallas_l1.py:44",
    "scan_topk_l1_fadd_bf16": "vectorlite_tpu/kernels/pallas_l1.py:44",
    "scan_topk_l1_select": "vectorlite_tpu/kernels/pallas_l1.py:44",
    "scan_topk_l1_select_bf16": "vectorlite_tpu/kernels/pallas_l1.py:44",
    "pq_rank_mma": "vectorlite_tpu/kernels/pq.py:291",
    "pq_rank": "vectorlite_tpu/kernels/pq.py:291",
    "gather_score": "vectorlite_tpu/kernels/ivf.py:290",
    "scan_merge_topw": "vectorlite_tpu/kernels/pallas_merge.py:66",
    "scan_fold_probe": "bench/decompose.py:68",
}


#: K3's four routes (kernels/scan.py block_route): int8 rows, the main
#: path's scan copy, on the tensor-core body's int8 form; bf16 rows on its
#: bf16 form; f32 rows (the high-accuracy profile) on its 3xTF32 form; W
#: above 3, over any rows, on the CUDA-core body
K3_INT8, K3_BF16, K3_TF32 = "scan_block_topw_s8", "scan_block_topw_bf16", "scan_block_topw_tf32"
K3_CORE = "scan_block_topw"
K3_SYMBOLS = (K3_INT8, K3_BF16, K3_TF32, K3_CORE)
#: K1's and K2's routes (kernels/scan.py exact_route): k <= 32 on the
#: tensor-core body's per-query top-k mode (f32 rows: 3xTF32; bf16 rows;
#: int8 rows), 32 < k <= 256 on its wide mode (tiles up to 32,768 rows),
#: beyond (or past those tiles) on its scores into the radix select
#: (csrc/select.cu)
K1_TF32, K1_BF16 = "scan_topk_exact_tf32", "scan_topk_exact_bf16"
K1_WIDE, K1_WIDE_BF16 = "scan_topk_wide_tf32", "scan_topk_wide_bf16"
K1_SELECT, K1_SELECT_BF16 = "scan_topk_select_tf32", "scan_topk_select_bf16"
K1_SYMBOLS = (K1_TF32, K1_BF16, K1_WIDE, K1_WIDE_BF16, K1_SELECT, K1_SELECT_BF16)
K2_S8, K2_WIDE, K2_SELECT = "scan_topk_exact_s8", "scan_topk_wide_s8", "scan_topk_select_s8"
K2_SYMBOLS = (K2_S8, K2_WIDE, K2_SELECT)
#: phase 2's lists past 2,048 and the tile of the CUDA-core entries the
#: radix select replaced (324.93 / 338.54 ms at 65,536 x 384, B 64;
#: PERF.md): the radix select's checks and its timing at that shape
OLD_K, OLD_TILE = 2100, 4096
#: K4's routes (exact_route, manhattan): k <= 32 on the FADD stream's lists
#: (f32 and bf16 rows), k > 32 on its scores into the radix select
K4_F32, K4_BF16 = "scan_topk_l1_fadd", "scan_topk_l1_fadd_bf16"
K4_SELECT, K4_SELECT_BF16 = "scan_topk_l1_select", "scan_topk_l1_select_bf16"
K4_SYMBOLS = (K4_F32, K4_BF16, K4_SELECT, K4_SELECT_BF16)
#: phase 3's manhattan searches past k 32: k 100 (k_pad 128) and 1,000
#: (k_pad 1,024) over f32 rows, k 100 over bf16 rows (the 2x pool of 256)
K_L1 = (100, 1000)

#: the SMs' shared-memory rate: 128 bytes a clock an SM, 132 SMs at 1.755
#: GHz (H100 SXM); what K5's look-up entry reads its LUT entries at
SMEM_BYTES_PER_S = 128 * 132 * 1.755e9


def log(*args):
    print(*args, flush=True)


def wide_plans(build, widths=(100, 384, 768)) -> dict:
    """The wide mode's shared-memory plan by row dtype, width and list
    length (csrc/wide.cu scan_topk_wide_plan): the ring's stages and the
    bytes of the ring, the score tiles, the lists and all."""
    import ctypes

    fn = build.load("wide").scan_topk_wide_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = None
    plans = {}
    for code, dtype in enumerate(("f32", "bf16", "int8")):
        for d in widths:
            for k in (128, 256):
                plan = (ctypes.c_int * 5)()
                fn(code, d, k, plan)
                plans[f"{dtype} D{d} k{k}"] = dict(zip(
                    ("stages", "ring_bytes", "score_bytes", "list_bytes", "smem_bytes"), plan))
    return plans


def peak_rss_gb() -> float:
    """This process's peak resident host memory so far, in GB."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def interleaved_ms(kernel_fn, plain_fn, reps: int, plain_reps: int):
    """plain, kernel, kernel, plain on one card; means of each pair."""
    p1 = cuda_time_ms(plain_fn, plain_reps)
    k1 = cuda_time_ms(kernel_fn, reps)
    k2 = cuda_time_ms(kernel_fn, reps)
    p2 = cuda_time_ms(plain_fn, plain_reps)
    return (k1 + k2) / 2, (p1 + p2) / 2


def bound(nbytes: float, ops: float, op_type: str) -> dict:
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak of their type."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[op_type] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes > t_ops else "operations"}


def ids_match(ps, pi, ks, ki, tol=1e-5) -> int:
    """Count id mismatches not explained by a near-tie: plain results
    carry one extra column so a swap at the k-th place is covered."""
    k = ks.shape[1]
    bad = 0
    for b in range(ks.shape[0]):
        for p in np.flatnonzero(pi[b, :k] != ki[b]):
            near = np.abs(ps[b] - ps[b, p]) <= tol * max(1.0, abs(ps[b, p]))
            near[p] = False
            bad += not near.any()
    return bad


def compare(label, kern_out, plain_out) -> float:
    """Kernel top-k against the plain top-(k+1); raises on disagreement,
    returns the largest score difference."""
    ks, ki = (t.cpu().numpy() for t in kern_out)
    ps, pi = (t.cpu().numpy() for t in plain_out)
    k = ks.shape[1]
    fin = np.isfinite(ps[:, :k])  # -inf slots (invalid rows) compare by pattern and row
    with np.errstate(invalid="ignore"):
        err = float(np.max(np.abs(ks - ps[:, :k]), where=fin, initial=0.0))
    close = np.allclose(ks, ps[:, :k], rtol=1e-5, atol=1e-5)
    bad = ids_match(ps, pi, ks, ki)
    log(f"  {label:48s} max_abs_err {err:.3g} id mismatches beyond ties {bad}")
    if not close or bad:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def merged(scan, tiles, b, k):
    s, i = tiles
    return scan.merge_topk(s.reshape(b, -1), i.reshape(b, -1), k)


def variants(scan, SM):
    """(kernel, rows label, metrics, kernel top-k, plain top-k, k) for every
    kernel variant; the callables take (values, scales, sqnorms, valid,
    queries, metric, k). K1's and K2's kernel is None: the one
    ``scan.exact_route`` names for the rows' dtype and k."""

    def exact(tile_n):
        def kern(v, sc, sq, valid, q, metric, k):
            if metric is SM.MANHATTAN:
                return scan.pallas_search_topk_l1(v, valid, q, k=k, tile_n=tile_n)
            if sc is not None:
                return scan.pallas_search_topk_int8(
                    v, sc, sq, valid, q, metric=metric, k=k, tile_n=tile_n)
            return scan.pallas_search_topk(v, sq, valid, q, metric=metric, k=k, tile_n=tile_n)

        def plain(v, sc, sq, valid, q, metric, k):
            return merged(scan, scan.tile_topk_plain(
                v, sc, sq, valid, q, metric=metric, k_tile=min(k, tile_n),
                tile_n=tile_n), q.shape[0], k)
        return kern, plain

    def block(winners):
        def kern(v, sc, sq, valid, q, metric, k):
            if sc is not None:
                return scan.pallas_search_block_topk_int8(
                    v, sc, sq, valid, q, metric=metric, k=k, tile_n=4096, winners=winners)
            return scan.pallas_search_block_topk(
                v, sq, valid, q, metric=metric, k=k, tile_n=4096, winners=winners)

        def plain(v, sc, sq, valid, q, metric, k):
            return merged(scan, scan.block_topw_plain(
                v, sc, sq, valid, q, metric=metric, tile_n=4096, winners=winners),
                q.shape[0], k)
        return kern, plain

    dots = (SM.COSINE, SM.EUCLIDEAN, SM.DOT_PRODUCT)
    return [
        (None, "f32", dots, *exact(2048), 16),
        (None, "f32 k1", dots, *exact(2048), 1),
        (None, "f32 k32", dots, *exact(2048), 32),
        (None, "f32 k100", dots, *exact(2048), 100),
        (None, "f32 k256", (SM.COSINE,), *exact(2048), 256),
        (None, "f32 k257", dots, *exact(2048), 257),
        (None, "f32 k300", (SM.COSINE,), *exact(2048), 300),
        (None, "f32 k512", (SM.COSINE,), *exact(2048), 512),
        (None, "f32 k1024", dots, *exact(2048), 1024),
        (None, "f32 k2048", (SM.COSINE,), *exact(2048), 2048),
        (None, f"f32 k{OLD_K}", (SM.COSINE,), *exact(OLD_TILE), OLD_K),
        (None, "f32 k4096", (SM.COSINE,), *exact(2048), 4096),
        (None, "bf16", dots, *exact(4096), 16),
        (None, "bf16 k33", (SM.COSINE,), *exact(4096), 33),
        (None, "bf16 k256", dots, *exact(4096), 256),
        (None, "bf16 k300", (SM.COSINE,), *exact(4096), 300),
        (None, "bf16 k512", dots, *exact(4096), 512),
        (None, "bf16 k2048", (SM.COSINE,), *exact(4096), 2048),
        (None, f"bf16 k{OLD_K}", dots, *exact(OLD_TILE), OLD_K),
        (None, "int8", dots, *exact(2048), 16),
        (None, "int8 k32", dots, *exact(2048), 32),
        (None, "int8 k100", (SM.COSINE,), *exact(2048), 100),
        (None, "int8 k256", dots, *exact(2048), 256),
        (None, "int8 k300", (SM.COSINE,), *exact(2048), 300),
        (None, "int8 k1024", dots, *exact(2048), 1024),
        (None, "int8 k2048", (SM.COSINE,), *exact(2048), 2048),
        (None, f"int8 k{OLD_K}", (SM.COSINE,), *exact(OLD_TILE), OLD_K),
        (None, "int8 k4096", (SM.COSINE,), *exact(2048), 4096),
        (K3_TF32, "f32", dots, *block(2), 16),
        (K3_TF32, "f32 w1", dots, *block(1), 16),
        (K3_TF32, "f32 w3", dots, *block(3), 16),
        (K3_BF16, "bf16", dots, *block(2), 16),
        (K3_INT8, "int8", dots, *block(2), 16),
        (K3_CORE, "f32 w4", dots, *block(4), 16),
        (None, "f32", (SM.MANHATTAN,), *exact(2048), 16),
        (None, "f32 k1", (SM.MANHATTAN,), *exact(2048), 1),
        (None, "f32 k32", (SM.MANHATTAN,), *exact(2048), 32),
        *((None, f"{dt} k{k}", (SM.MANHATTAN,), *exact(2048), k)
          for dt in ("f32", "bf16") for k in (33, 100, 300, 1024)),
        (None, "bf16", (SM.MANHATTAN,), *exact(2048), 16),
        (None, "bf16 k32", (SM.MANHATTAN,), *exact(2048), 32),
    ]


def check_kernels(scan, metrics_mod, dev, rng) -> dict:
    """Phase 2a: every kernel variant against its plain version."""
    SM = metrics_mod.SimilarityMetric
    shapes = []
    for n, d, b in ((65536, D, 64), (8192, 100, 5)):
        # 8,192 x 100, B=5: rows load one element at a time (D * itemsize
        # is not a multiple of 16 bytes for bf16/int8), a partial block
        v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        v *= torch.from_numpy(rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
        vq, sc = metrics_mod.quantize_rows_int8(v)
        rows = {"f32": (v, None), "bf16": (v.to(torch.bfloat16), None), "int8": (vq, sc)}
        shapes.append((f"{n}x{d} B{b}", rows, (v * v).sum(-1), valid, q))
    errs = {}
    for name, label, metrics, kern, plain, k in variants(scan, SM):
        for shape, rows, sq, valid, q in shapes:
            v, sc = rows[label.split()[0]]
            for metric in metrics:
                tile = scan.exact_tile(v.shape[0], OLD_TILE if k == OLD_K else 2048, k,
                                       metric)
                sym = name or scan.exact_route(v.dtype, min(k, tile), metric, tile).symbol
                out = kern(v, sc, sq, valid, q, metric, k)
                torch.cuda.synchronize()
                ref = plain(v, sc, sq, valid, q, metric, k + 1)
                err = compare(f"{sym} {label} {shape} {metric.name}", out, ref)
                errs[sym] = max(errs.get(sym, 0.0), err)
    check_select_tiles(scan, SM, shapes, errs)
    return errs


def check_select_tiles(scan, SM, shapes, errs: dict) -> None:
    """Phase 2a, the radix select's tile by tile: tile_topk_cuda at k =
    tile_n = 2,048 and 4,096, at k 300 and 2,100 over 32,768-row tiles and
    at k 300 over 65,536 (past the wide mode's tiles: 65,536 x 384) or one
    tile of 8,192 rows at k 300, 2,100 and k = tile_n (8,192 x 100), every
    tile's list against tile_topk_plain's, -inf slots naming the same rows;
    the dot product where the list is under half the tile."""
    for shape, rows, sq, valid, q in shapes:
        n = valid.shape[0]
        cases = ((2048, 2048), (4096, 4096), (300, 32768), (OLD_K, 32768),
                 (300, 65536)) if n >= 65536 else ((300, n), (OLD_K, n), (n, n))
        for label, (v, sc) in rows.items():
            for k, tile_n in cases:
                sym = scan.exact_route(v.dtype, k, SM.COSINE, tile_n).symbol
                for metric in (SM.COSINE, SM.DOT_PRODUCT):
                    if metric is SM.DOT_PRODUCT and 2 * k >= tile_n:
                        continue  # dots near 0 (tests/test_torch_scan.py holds them to f64)
                    got = scan.tile_topk_cuda(v, sc, sq, valid, q, metric=metric, k_tile=k,
                                              tile_n=tile_n)
                    torch.cuda.synchronize()
                    kw = min(k + 1, tile_n)
                    want = scan.tile_topk_plain(v, sc, sq, valid, q, metric=metric,
                                                k_tile=kw, tile_n=tile_n)
                    err = compare(f"{sym} {label} k{k} tiles of {tile_n} {shape} {metric.name}",
                                  [x.reshape(-1, k) for x in got],
                                  [x.reshape(-1, kw) for x in want])
                    errs[sym] = max(errs.get(sym, 0.0), err)


def time_kernels(scan, metrics_mod, dev, rng, n: int, errs: dict) -> dict:
    """Phase 2b: each kernel at the main-path shape, beside its plain
    version and the library path; outputs held against the plain
    version's; bounds from this run's shapes."""
    SM = metrics_mod.SimilarityMetric
    v = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)).to(dev)
    sq = (v * v).sum(-1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).to(dev)
    qsq = (q * q).sum(-1, keepdim=True)
    vq, sc = metrics_mod.quantize_rows_int8(v)
    vq_f32 = vq.to(torch.float32)  # library paths' operands, cast outside timing
    vq_bf16, qb = vq.to(torch.bfloat16), q.to(torch.bfloat16)
    vb = v.to(torch.bfloat16)
    vb_f32 = vb.to(torch.float32)
    metrics_mod.disable_tf32()
    dot_ops = 2.0 * B * n * D
    side = n * 4 + n * 1 + B * D * 4  # sqnorms, validity, queries

    def library(rows, scales, k, metric, qq=q, qqsq=qsq, rsq=sq):
        def fn():
            if metric is SM.MANHATTAN:
                score = 1.0 / (1.0 + torch.cdist(qq, rows, p=1.0))
            else:
                dot = torch.mm(qq, rows.T)
                if scales is not None:
                    dot = dot * scales[None, :]
                score = metrics_mod.metric_from_dot(dot, qqsq, rsq[None, :], metric)
            return torch.topk(score, k)
        return fn

    # the shapes the main path hands each kernel: K1 over f32 rows with
    # k_pad 16 (tile 2048), over bf16 rows (the memory-optimized profile)
    # with the 2x pool (32, and 256 at k 100) and tile 4096, and at k 100
    # (k_pad 128) on the wide mode; K2 over int8 rows with the 2x pool (32,
    # and 256 at k 100 on the wide mode); K3 over the int8 scan copy,
    # 4096-row tiles, W = 2, pool 128 (and its other routes: a bf16 scan
    # copy, f32 rows without a copy on 3xTF32, and the CUDA-core body at W
    # 4, which the index never asks for (its W is 2) and phase 6 drives;
    # scripts/probe_k3_f32.py times both bodies at W 1-4); K4 over f32
    # rows at k_pad 16, over
    # bf16 rows (the memory-optimized profile) at the 2x pool of 32 (and at
    # k 16, logged only), and past k 32 on its scores into the radix select
    # at the tiles exact_tile grows (k 100's k_pad of 128 and k 1,000's of
    # 1,024 over f32 rows, k 300 beside the CUDA-core lists' 230 ms there
    # (PERF.md), k 100's pool of 256 over bf16 rows). K1 and K3 over f32
    # rows are priced at three tf32 passes (the reference's HIGHEST on the
    # tensor cores, whichever body computes it), K2 at one int8 pass, K1
    # over bf16 rows at one bf16 pass, K4 at two FADD instructions a
    # (query, row, dimension).
    def k3_out(winners):
        return B * (n // 4096) * winners * 128 * 8
    l1_ops = 2.0 * B * n * D  # FADD instructions
    l1_side = n * 1 + B * D * 4  # validity, queries

    def tiles_out(tile_n, k):
        return B * (n // tile_n) * k * 8

    def l1_tile(k):  # K4's tile past k 32, as the path's caller tile grows
        return scan.exact_tile(n, 2048, k, SM.MANHATTAN)

    specs = [
        (K1_TF32, SM.COSINE, v, None, 16, 2048, None, "tf32",
         3 * dot_ops, n * D * 4 + side + tiles_out(2048, 16)),
        (K1_BF16, SM.COSINE, vb, None, 32, 4096, None, "bf16",
         dot_ops, n * D * 2 + side + tiles_out(4096, 32)),
        (K1_WIDE, SM.COSINE, v, None, 128, 2048, None, "tf32",
         3 * dot_ops, n * D * 4 + side + tiles_out(2048, 128)),
        (K1_WIDE_BF16, SM.COSINE, vb, None, 256, 4096, None, "bf16",
         dot_ops, n * D * 2 + side + tiles_out(4096, 256)),
        (K2_S8, SM.COSINE, vq, sc, 32, 2048, None, "int8",
         dot_ops, n * D + n * 4 + side + tiles_out(2048, 32)),
        (K2_WIDE, SM.COSINE, vq, sc, 256, 2048, None, "int8",
         dot_ops, n * D + n * 4 + side + tiles_out(2048, 256)),
        (K3_INT8, SM.COSINE, vq, sc, 128, 4096, 2, "int8",
         dot_ops, n * D + n * 4 + side + k3_out(2)),
        (K3_BF16, SM.COSINE, vb, None, 128, 4096, 2, "bf16",
         dot_ops, n * D * 2 + side + k3_out(2)),
        (K3_TF32, SM.COSINE, v, None, 128, 4096, 2, "tf32",
         3 * dot_ops, n * D * 4 + side + k3_out(2)),
        (K3_CORE, SM.COSINE, v, None, 128, 4096, 4, "tf32",
         3 * dot_ops, n * D * 4 + side + k3_out(4)),
        (K4_F32, SM.MANHATTAN, v, None, 16, 2048, None, "f32_add",
         l1_ops, n * D * 4 + l1_side + tiles_out(2048, 16)),
        (K4_BF16, SM.MANHATTAN, vb, None, 32, 2048, None, "f32_add",
         l1_ops, n * D * 2 + l1_side + tiles_out(2048, 32)),
        (K4_BF16 + " k16", SM.MANHATTAN, vb, None, 16, 2048, None, "f32_add",
         l1_ops, n * D * 2 + l1_side + tiles_out(2048, 16)),
        *((K4_SELECT + suffix, SM.MANHATTAN, v, None, k, l1_tile(k), None, "f32_add",
           l1_ops, n * D * 4 + l1_side + tiles_out(l1_tile(k), k))
          for suffix, k in (("", 128), (" k300", 300), (" k1024", 1024))),
        (K4_SELECT_BF16, SM.MANHATTAN, vb, None, 256, l1_tile(256), None, "f32_add",
         l1_ops, n * D * 2 + l1_side + tiles_out(l1_tile(256), 256)),
    ]
    out = {}
    for key, metric, rows, scales, k, tile_n, winners, op_type, ops, nbytes in specs:
        name = key.split()[0]
        if winners is None:
            def kern(rows=rows, scales=scales, metric=metric, k=k, tile_n=tile_n):
                return scan.tile_topk_cuda(rows, scales, sq, valid, q, metric=metric,
                                           k_tile=k, tile_n=tile_n)

            def plain(rows=rows, scales=scales, metric=metric, k=k, tile_n=tile_n):
                return scan.tile_topk_plain(rows, scales, sq, valid, q, metric=metric,
                                            k_tile=k + 1, tile_n=tile_n)
            lib = library({torch.int8: vq_f32, torch.bfloat16: vb_f32}.get(rows.dtype, rows),
                          scales, k, metric)
        else:
            def kern(rows=rows, scales=scales, metric=metric, tile_n=tile_n, winners=winners):
                return scan.block_topw_cuda(rows, scales, sq, valid, q, metric=metric,
                                            tile_n=tile_n, winners=winners)

            def plain(rows=rows, scales=scales, metric=metric, tile_n=tile_n, winners=winners):
                return scan.block_topw_plain(rows, scales, sq, valid, q, metric=metric,
                                             tile_n=tile_n, winners=winners)
            # one GEMM (bf16 over int8 or bf16 rows, TF32-off f32 over f32
            # rows), then each lane group's top W
            lq, lrows = {K3_INT8: (qb, vq_bf16), K3_BF16: (qb, vb), K3_TF32: (q, v),
                         K3_CORE: (q, v)}[name]

            def lib(tile_n=tile_n, winners=winners, lq=lq, lrows=lrows):
                return torch.topk(torch.mm(lq, lrows.T).view(
                    B, n // tile_n, tile_n // 128, 128), winners, dim=2)
        l1 = metric is SM.MANHATTAN  # its plain version and library call ~0.45-0.9 s each
        ms, plain_ms = interleaved_ms(kern, plain, reps=20, plain_reps=2 if l1 else 5)
        lib_ms = cuda_time_ms(lib, 3 if l1 else 10)
        err = compare(f"{key} at the main-path shape (top {k})",
                      merged(scan, kern(), B, k), merged(scan, plain(), B, k + 1))
        errs[name] = max(errs.get(name, 0.0), err)
        t = out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **bound(nbytes, ops, op_type)}
        int8_work = (f"; tensor work {3 * dot_ops / PEAK_OPS_PER_S['int8'] * 1e3:.4f} "
                     f"ms (3 int8 passes)")
        work = {K3_INT8: int8_work, K2_S8: int8_work, K2_WIDE: int8_work,
                K3_BF16: f"; {design_work(n)}", K1_BF16: f"; {design_work(n)}",
                K1_WIDE_BF16: f"; {design_work(n)}",
                K3_CORE: f"; W {winners}, f32 FMAs {dot_ops / PEAK_OPS_PER_S['f32'] * 1e3:.4f} "
                         f"ms (the CUDA-core body's own least time)"}.get(name, "")
        if name in (K4_SELECT, K4_SELECT_BF16):
            group = scan.select_group_rows(n, B, tile_n)
            work = (f"; tiles of {tile_n}, groups of {group // tile_n}, scratch "
                    f"{4 * B * group / 2**20:.0f} MiB written and read once: "
                    f"{2 * 4 * B * n / PEAK_BYTES_PER_S * 1e3:.4f} ms of device memory")
        log(f"  {key:22s} kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {lib_ms:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{op_type} rate){work}")
    # merge_topk's sort at the caller's 2,048-row tiles (k 1,000's k_pad of
    # 1,024 a tile), beside the grown tiles' above: what exact_tile saves
    s_ = torch.randn((B, (n // 2048) * 1024), device=dev)
    i_ = torch.arange(s_.shape[1], dtype=torch.int32, device=dev).expand(B, -1).contiguous()
    log(f"  merge_topk sort at 2,048-row tiles, k 1,024: "
        f"{cuda_time_ms(lambda: scan.merge_topk(s_, i_, 1024), 3):.4f} ms of {B} x "
        f"{s_.shape[1]} candidates")
    del s_, i_
    out.update(time_select_kernels(scan, metrics_mod, v, vb, vq, sc, sq, valid, q, library,
                                   errs))
    return out


def time_select_kernels(scan, metrics_mod, v, vb, vq, sc, sq, valid, q, library,
                        errs: dict) -> dict:
    """Phase 2b, the radix select's entries: at the paths' shapes (the
    main-path rows, B 256, on the tiles exact_tile grows: K1 over f32 rows
    at k_pad 4,096, approx=False at k 2,049-4,096, at 8,192, the next rung,
    and at k 300 and 1,000's k_pad of 1,024; over bf16 rows and K2 at the
    pool of 4,096, the memory-optimized and quantized exact paths at k
    1,025-2,048, and at k 200's pool of 512 (bf16) and k 300 and k 500's
    pool of 1,024 (K2)), then at 65,536 x 384, B 64, k 2,100 over
    4,096-row tiles (the retired CUDA-core entries' 324.93 / 338.54 ms
    there, PERF.md), each beside its plain version and the library path,
    outputs held, merge_topk's sort of the paths' lists apart. The bound
    counts what the function must move and compute: the rows, their side
    arrays, the queries and the [B, T, k] lists. The scratch is this
    design's, so a second bound, design_bound_ms, adds its scores written
    and read once where a group of them outgrows L2."""
    SM = metrics_mod.SimilarityMetric
    n = v.shape[0]
    out = {}
    small = 65536
    specs = [(K1_SELECT, v, None, "tf32", 3, 4096, 2048, B),
             (K1_SELECT + " k8192", v, None, "tf32", 3, 8192, 2048, B),
             (K1_SELECT + " k1024", v, None, "tf32", 3, 1024, 2048, B),
             (K1_SELECT + " k300", v, None, "tf32", 3, 300, 2048, B),
             (K1_SELECT_BF16, vb, None, "bf16", 1, 4096, 4096, B),
             (K1_SELECT_BF16 + " k512", vb, None, "bf16", 1, 512, 4096, B),
             (K2_SELECT, vq, sc, "int8", 1, 4096, 2048, B),
             (K2_SELECT + " k1024", vq, sc, "int8", 1, 1024, 2048, B),
             (K2_SELECT + " k300", vq, sc, "int8", 1, 300, 2048, B),
             (K1_SELECT + " old shape", v[:small], None, "tf32", 3, OLD_K, OLD_TILE, 64),
             (K1_SELECT_BF16 + " old shape", vb[:small], None, "bf16", 1, OLD_K, OLD_TILE, 64),
             (K2_SELECT + " old shape", vq[:small], sc[:small], "int8", 1, OLD_K, OLD_TILE, 64)]
    for key, rows, scales, op_type, passes, k, caller_tile, b in specs:
        name = key.split()[0]
        m = rows.shape[0]
        tile_n = OLD_TILE if key.endswith("old shape") else scan.exact_tile(m, caller_tile, k)
        qs, sqs, vs = q[:b].contiguous(), sq[:m], valid[:m]
        qsq = (qs * qs).sum(-1, keepdim=True)

        def kern(rows=rows, scales=scales, k=k, tile_n=tile_n, qs=qs, sqs=sqs, vs=vs):
            return scan.tile_topk_cuda(rows, scales, sqs, vs, qs, metric=SM.COSINE, k_tile=k,
                                       tile_n=tile_n)

        def plain(rows=rows, scales=scales, k=k, tile_n=tile_n, qs=qs, sqs=sqs, vs=vs):
            return scan.tile_topk_plain(rows, scales, sqs, vs, qs, metric=SM.COSINE,
                                        k_tile=k + 1, tile_n=tile_n)
        ms, plain_ms = interleaved_ms(kern, plain, reps=10, plain_reps=2)
        lib = library(rows.to(torch.float32), scales, k, SM.COSINE, qs, qsq, sqs)
        lib_ms = cuda_time_ms(lib, 5)
        err = compare(f"{key} at {m} x {D}, B {b} (top {k}, tiles of {tile_n})",
                      merged(scan, kern(), b, k), merged(scan, plain(), b, k + 1))
        errs[name] = max(errs.get(name, 0.0), err)
        row_bytes = m * D * rows.element_size() + (m * 4 if scales is not None else 0)
        nbytes = row_bytes + m * 4 + m + b * D * 4 + b * (m // tile_n) * k * 8
        ops = passes * 2.0 * b * m * D
        group = scan.select_group_rows(m, b, tile_n)
        spills = 4 * b * group > L2_BYTES
        scratch_bytes = 2 * 4 * b * m if spills else 0  # the scores written and read once
        t = out[key] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                        **bound(nbytes, ops, op_type),
                        "design_bound_ms": bound(nbytes + scratch_bytes, ops, op_type)["bound_ms"]}
        s_, i_ = kern()
        merge_ms = cuda_time_ms(lambda: scan.merge_topk(s_.reshape(b, -1), i_.reshape(b, -1),
                                                        k), 3)
        del s_, i_
        log(f"  {key:34s} {m} x {D}, B {b}, k {k}, tiles of {tile_n} (groups of "
            f"{group // tile_n}, scratch {4 * b * group / 2**20:.0f} MiB"
            f"{', past L2' if spills else ''}): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
            f"library {lib_ms:.4f} ms  bound {t['bound_ms']:.4f} ms ({t['bound_by']}, "
            f"{op_type} rate; with the scratch {t['design_bound_ms']:.4f} ms); merge_topk "
            f"sort {merge_ms:.4f} ms")
    return out


PQ8_ROWS = 1 << 18  # rows of phase 4's 8-bit collection


def compare_rank(label, got, want) -> float:
    """K5 rank against the plain rank: the same -inf pattern and finite
    ranks within rtol/atol 2e-5; returns the largest difference."""
    inf_k, inf_p = got == float("-inf"), want == float("-inf")
    fin = ~inf_p
    err = float((got[fin] - want[fin]).abs().max()) if bool(fin.any()) else 0.0
    close = torch.allclose(got[fin], want[fin], rtol=2e-5, atol=2e-5)
    same_inf = torch.equal(inf_k, inf_p)
    log(f"  {label:48s} max_abs_err {err:.3g} -inf pattern equal {same_inf}")
    if not (close and same_inf):
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def pq_inputs(pq, dev, rng, n, d, m, kc, b, packed, metric):
    """Random codes, a LUT from random queries and codebooks, squared
    norms and a validity mask (5% invalid) for one K5 call."""
    ms = m // 2 if packed else m
    codes = torch.from_numpy(
        rng.integers(0, 256 if packed else kc, (n, ms), dtype=np.uint8)).to(dev)
    cb = torch.from_numpy(rng.standard_normal((m, kc, d // m), dtype=np.float32)).to(dev)
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    lut = pq.selection_lut(pq._adc_lut(q, cb, metric), metric)
    sq = torch.from_numpy(rng.uniform(0.5, 2.0, n).astype(np.float32) * d).to(dev)
    valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
    return lut, codes, sq, valid


def check_pq_kernel(pq, SM, dev, rng, errs: dict) -> None:
    """Phase 2c: both K5 entries against pq_rank_plain on every layout and
    metric: the tensor-core entry on 4-bit codes (packed and unpacked); the
    look-up entry on kc = 256 and, as the design it replaces, on 4-bit
    codes."""
    shapes = [(65536, D, 64, (192, 16, True), (192, 16, False), (96, 256, False)),
              (8192, 99, 5, (33, 16, False), (33, 256, False))]
    for n, d, b, *layouts in shapes:
        for m, kc, packed in layouts:
            for metric in SM:
                lut, codes, sq, valid = pq_inputs(pq, dev, rng, n, d, m, kc, b, packed, metric)
                want = pq.pq_rank_plain(lut, codes, sq, valid, metric=metric, packed=packed)
                runs = [("pq_rank", lambda: pq.launch_rank_lookup(
                    lut, codes, sq, valid, metric=metric, packed=packed))]
                if kc == pq.MMA_KC:
                    runs.append(("pq_rank_mma", lambda: pq.launch_rank_mma(
                        lut, codes, sq, valid, metric=metric, packed=packed)))
                else:  # the dispatching wrapper sends kc = 256 to the look-ups
                    runs[0] = ("pq_rank", lambda: pq.pq_rank(
                        lut, codes, sq, valid, metric=metric, packed=packed))
                for name, fn in runs:
                    got = fn()
                    torch.cuda.synchronize()
                    label = f"{name} {n}x{m}x{kc}{' packed' if packed else ''} B{b} {metric.name}"
                    errs[name] = max(errs.get(name, 0.0), compare_rank(label, got, want))


def onehot_yardstick(pq, lut, codes, packed):
    """The library yardstick of K5: the [B, M * kc] bf16 LUT and the rows'
    [N, M * kc] bf16 one-hot, built outside the timing, so that one
    torch.mm(lut, onehot.T) computes the rank's ADC sums."""
    b, m, kc = lut.shape
    u = (pq.unpack_nibbles(codes) if packed else codes).to(torch.int16)
    onehot = u[:, :, None] == torch.arange(kc, device=codes.device, dtype=torch.int16)
    return lut.reshape(b, m * kc), onehot.to(torch.bfloat16).reshape(len(codes), m * kc)


def time_pq_kernel(pq, SM, dev, rng, n: int, errs: dict) -> tuple[dict, dict]:
    """Phase 2d: K5 at the main-path shape (2^18-row chunks, M 192 packed,
    B 256): the tensor-core entry held against the plain rank on every
    chunk for all 256 queries, then on one chunk timed beside the look-up
    entry it replaces, the plain rank, a bf16 torch.mm with a prebuilt
    one-hot (the library yardstick) and the chunk selection; the L2 bytes
    the design reads. Then the look-up entry at its own serving shape (the
    8-bit path's 2^16-row chunk: kc 256, M 96), held and timed beside its
    plain version and the same yardstick. Returns the two kernel lines'
    timings."""
    from vectorlite_tpu_torch.index.flat import _pq_scan_chunk  # the path's chunks

    chunk4, chunk8 = _pq_scan_chunk(4), _pq_scan_chunk(8)
    m, kc = D // 2, 16
    lut, codes, sq, valid = pq_inputs(pq, dev, rng, n, D, m, kc, B, True, SM.COSINE)
    valid[:] = True
    chunks = [slice(lo, lo + chunk4) for lo in range(0, n, chunk4)]
    for i, c in enumerate(chunks):
        got = pq.pq_rank_cuda(lut, codes[c], sq[c], valid[c], metric=SM.COSINE, packed=True)
        want = pq.pq_rank_plain(lut, codes[c], sq[c], valid[c], metric=SM.COSINE, packed=True)
        err = compare_rank(f"pq_rank_mma at the main-path shape, chunk {i}", got, want)
        errs["pq_rank_mma"] = max(errs.get("pq_rank_mma", 0.0), err)
        del got, want
    c = chunks[0]
    rows = min(chunk4, n)
    args = (lut, codes[c], sq[c], valid[c])

    def kern():
        return pq.pq_rank_cuda(*args, metric=SM.COSINE, packed=True)

    def plain():
        return pq.pq_rank_plain(*args, metric=SM.COSINE, packed=True)

    def lookup():
        return pq.launch_rank_lookup(*args, metric=SM.COSINE, packed=True)

    err = compare_rank("pq_rank (look-ups) at the main-path shape", lookup(), plain())
    errs["pq_rank"] = max(errs.get("pq_rank", 0.0), err)
    lut2, onehot = onehot_yardstick(pq, lut, codes[c], True)
    ms, plain_ms = interleaved_ms(kern, plain, reps=20, plain_reps=3)
    lookup_ms = cuda_time_ms(lookup, 20)
    relayout_ms = cuda_time_ms(lambda: pq.mma_lut_operand(lut, pq.mma_query_tile(B)), 20)
    lib_ms = cuda_time_ms(lambda: torch.mm(lut2, onehot.T), 10)
    del lut2, onehot
    rank = kern()
    sel_ms = cuda_time_ms(lambda: pq.select_topk(rank, 256 + 32), 10)
    del rank
    ops = 2.0 * B * rows * m * kc  # the one-hot bf16 contraction
    nbytes = rows * (m // 2) + B * m * kc * 2 + B * rows * 4  # pq.py:385-389
    mma = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
           **bound(nbytes, ops, "bf16")}
    l2 = -(-rows // 128) * B * m * kc * 2  # every 128-row tile streams the LUT
    log(f"  pq_rank_mma (chunk {rows} x M {m}, B {B}) kernel {ms:.4f} ms (the LUT "
        f"relayout alone {relayout_ms:.4f})  look-up entry on the same chunk {lookup_ms:.4f} ms  "
        f"plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound {mma['bound_ms']:.4f} ms "
        f"({mma['bound_by']}, bf16 rate); LUT bytes from L2 a chunk {l2 / 1e9:.2f} GB; "
        f"chunk selection (top 288) {sel_ms:.4f} ms")

    # the look-up entry where it serves: the 8-bit path's chunk
    rows8, m8, kc8 = min(chunk8, n), D // 4, 256
    lut, codes, sq, valid = pq_inputs(pq, dev, rng, rows8, D, m8, kc8, B, False, SM.COSINE)
    err = compare_rank("pq_rank (look-ups) at the 8-bit path's shape",
                       pq.pq_rank_cuda(lut, codes, sq, valid, metric=SM.COSINE, packed=False),
                       pq.pq_rank_plain(lut, codes, sq, valid, metric=SM.COSINE, packed=False))
    errs["pq_rank"] = max(errs.get("pq_rank", 0.0), err)
    ms8, plain8 = interleaved_ms(
        lambda: pq.pq_rank_cuda(lut, codes, sq, valid, metric=SM.COSINE, packed=False),
        lambda: pq.pq_rank_plain(lut, codes, sq, valid, metric=SM.COSINE, packed=False),
        reps=20, plain_reps=2)
    lut2, onehot = onehot_yardstick(pq, lut, codes, False)
    lib8 = cuda_time_ms(lambda: torch.mm(lut2, onehot.T), 10)
    del lut2, onehot
    # the LUT relayout the wrapper does before each launch
    q_tile = pq.lookup_query_tile()
    relayout8 = cuda_time_ms(lambda: pq.lookup_lut_operand(lut, False, q_tile), 20)
    # the look-up form's work: one f32 add a (query, row, subspace)
    lookups = 1.0 * B * rows8 * m8
    lookup_line = {"ms": ms8, "plain_ms": plain8, "library_ms": lib8,
                   **bound(rows8 * m8 + B * m8 * kc8 * 2 + B * rows8 * 4, lookups, "f32")}
    log(f"  pq_rank (chunk {rows8} x M {m8}, kc {kc8}, B {B}) kernel {ms8:.4f} ms (the LUT "
        f"relayout alone {relayout8:.4f})  plain {plain8:.4f} ms  library {lib8:.4f} ms  bound "
        f"{lookup_line['bound_ms']:.4f} ms ({lookup_line['bound_by']}, f32 rate); its "
        f"{lookups / 1e9:.2f} G look-ups of 2 bytes from shared memory "
        f"{2 * lookups / SMEM_BYTES_PER_S * 1e3:.4f} ms")
    return mma, lookup_line


# the IVF shape: 2,000,000 rows at 512 a cell -> C = 4,096 cells of
# P = ceil(1.25 * 2e6 / 4096) = 611 -> 640 rows; nprobe 16; batches of 64
IVF_C, IVF_P, IVF_B, IVF_L = 4096, 640, 64, 16


#: K6's id patterns: random cells (query 0 probing one cell again and
#: again, query 1 in descending order); every query probing the same L
#: cells, each in its own order; every pair probing one cell
PROBE_IDS = ("random", "shared", "one")


def probe_operands(dev, rng, c, p, d, b, l_probe, dtype, ids_mode="random"):
    """Random [C * P, D] blocks (bf16 or int8), [B, L] int32 cell ids in
    one of PROBE_IDS' patterns, and [B, D] f32 queries, on the card."""
    if dtype == "int8":
        rows = torch.from_numpy(rng.integers(-127, 128, (c * p, d), dtype=np.int8)).to(dev)
    else:
        rows = torch.from_numpy(rng.standard_normal((c * p, d), dtype=np.float32)).to(
            dev).to(torch.bfloat16)
    ids = rng.integers(0, c, (b, l_probe)).astype(np.int32)
    ids[0] = ids[0, 0]
    if b > 1:
        ids[1] = np.sort(ids[1])[::-1]
    if ids_mode == "shared":
        ids = np.stack([rng.permutation(ids[-1]) for _ in range(b)]).astype(np.int32)
    elif ids_mode == "one":
        ids[:] = ids[-1, 0]
    q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
    return rows, torch.from_numpy(np.ascontiguousarray(ids)).to(dev), q


def compare_probe(label, got, want) -> float:
    """K6 against the plain probe: |diff| <= 1e-5 * max(1, max |out|)."""
    err = float((got - want).abs().max())
    tol = 1e-5 * max(1.0, float(want.abs().max()))
    log(f"  {label:48s} max_abs_err {err:.3g} (tolerance {tol:.3g})")
    if not err <= tol:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def check_ivf_kernel(ivf, dev, rng) -> float:
    """Phase 2e: K6 against gather_score_plain at small shapes, in every
    id pattern (cells repeated within a query, shared across queries)."""
    err = 0.0
    for dtype in ("bf16", "int8"):
        for d in (384, 100):
            for c, p, b, l_probe in ((16, 128, 5, 3), (16, 640, 64, 16), (16, 128, 320, 16)):
                for mode in PROBE_IDS:
                    rows, ids, q = probe_operands(dev, rng, c, p, d, b, l_probe, dtype, mode)
                    got = ivf.gather_score_pallas(rows, ids, q, p_width=p)
                    torch.cuda.synchronize()
                    want = ivf.gather_score_plain(rows, ids, q, p_width=p)
                    label = f"gather_score {dtype} C{c} P{p} D{d} B{b} L{l_probe} {mode}"
                    err = max(err, compare_probe(label, got, want))
    return err


def probe_bound(ids, dtype: str) -> dict:
    """K6's bound at the IVF shape: each distinct probed cell read once,
    the [B, L, P] scores written once, 2 B L P D operations at the rate of
    the layout's contraction."""
    itemsize = 1 if dtype == "int8" else 2
    distinct = int(torch.unique(ids).numel())
    nbytes = (distinct * IVF_P * D * itemsize + IVF_B * IVF_L * IVF_P * 4
              + IVF_B * IVF_L * 4 + IVF_B * D * 4)
    return bound(nbytes, 2.0 * IVF_B * IVF_L * IVF_P * D, "f32" if dtype == "int8" else "bf16")


def time_ivf_kernel(ivf, dev, rng, errs: dict) -> dict:
    """Phase 2f: K6 at the IVF shape on both layouts, held against the
    plain probe and timed beside it and a torch.bmm of the same blocks
    gathered outside the timing; the bound counts each distinct probed
    block read once. The bf16 layout (the default profile's) is the
    kernel line's."""
    out = {}
    for dtype in ("bf16", "int8"):
        for mode in PROBE_IDS[::-1]:  # the random ids last: those are timed
            rows, ids, q = probe_operands(dev, rng, IVF_C, IVF_P, D, IVF_B, IVF_L, dtype, mode)
            got = ivf.gather_score_cuda(rows, ids, q, p_width=IVF_P)
            want = ivf.gather_score_plain(rows, ids, q, p_width=IVF_P)
            err = compare_probe(f"gather_score {dtype} at the IVF shape, {mode} ids", got, want)
            errs["gather_score"] = max(errs.get("gather_score", 0.0), err)
            if mode != "random":
                q_op = ivf._query_operand(rows, q).contiguous()
                shared_ms = cuda_time_ms(
                    lambda: ivf.launch_gather_score(rows, ids, q_op, p_width=IVF_P), 50)
                log(f"  gather_score {dtype}, {mode} ids ({int(torch.unique(ids).numel())} "
                    f"distinct cells): kernel {shared_ms:.4f} ms  bound "
                    f"{probe_bound(ids, dtype)['bound_ms']:.4f} ms")
            del got, want
        q_op = ivf._query_operand(rows, q).contiguous()

        def kern():
            return ivf.launch_gather_score(rows, ids, q_op, p_width=IVF_P)

        def plain():
            return ivf.gather_score_plain(rows, ids, q, p_width=IVF_P)

        # library yardstick: one batched product of the pre-gathered
        # [B, L * P, D] blocks with the query (bf16, or f32 over the int8
        # values cast to f32), built outside the timing
        blocks = rows.reshape(IVF_C, IVF_P, D)[ids.long()].reshape(IVF_B, IVF_L * IVF_P, D)
        if dtype == "int8":
            blocks, q_lib = blocks.to(torch.float32), q_op[:, :, None]
        else:
            q_lib = q_op.to(torch.bfloat16)[:, :, None]
        ms, plain_ms = interleaved_ms(kern, plain, reps=50, plain_reps=5)
        lib_ms = cuda_time_ms(lambda: torch.bmm(blocks, q_lib), 20)
        checked_ms = cuda_time_ms(
            lambda: ivf.gather_score_cuda(rows, ids, q, p_width=IVF_P), 20)
        wrapper_ms = cuda_time_ms(
            lambda: ivf.gather_score_pallas(rows, ids, q, p_width=IVF_P), 20)
        del blocks
        distinct = int(torch.unique(ids).numel())
        pair_bytes = IVF_B * IVF_L * IVF_P * D * (1 if dtype == "int8" else 2)
        op_type = "f32" if dtype == "int8" else "bf16"
        out[dtype] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                      **probe_bound(ids, dtype)}
        log(f"  gather_score {dtype} (C {IVF_C} P {IVF_P} D {D} B {IVF_B} L {IVF_L}, "
            f"{distinct} distinct cells) kernel {ms:.4f} ms  search wrapper "
            f"{wrapper_ms:.4f} ms  with the id check {checked_ms:.4f} ms  plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms  "
            f"bound {out[dtype]['bound_ms']:.4f} ms ({out[dtype]['bound_by']}, {op_type} "
            f"rate; each (query, probe) block read once: "
            f"{pair_bytes / PEAK_BYTES_PER_S * 1e3:.4f} ms)")
        del rows
        torch.cuda.empty_cache()
    return out


def lane_lists(s, i, winners: int):
    """K7's [W, B, 128] or K8's [T, B, W*128] as numpy ([M, W] scores,
    [M, W] ids), one row per (tile, query, lane group)."""
    if s.shape[0] == winners and s.shape[-1] == 128:  # K7
        s, i = s.permute(1, 2, 0), i.permute(1, 2, 0)
    else:
        t, b = s.shape[:2]
        s = s.reshape(t, b, winners, 128).transpose(2, 3)
        i = i.reshape(t, b, winners, 128).transpose(2, 3)
    return (s.reshape(-1, winners).cpu().numpy(),
            i.reshape(-1, winners).cpu().numpy())


def compare_lanes(label, kern, plain, winners: int, distinct=False, exact=None) -> float:
    """Lane-group lists of a kernel against the plain version's lists of
    W + 1: the same -inf pattern, finite scores within rtol/atol 1e-5, ids
    equal except among scores within 1e-5 of each other. ``distinct``
    (K8 maxonly, ids 0): a list whose scores differ beyond that is excused
    where either list holds two scores within 1e-5 (one side may hold
    them as one value). ``exact`` (K7's [W, B, 128] lists over f32 rows
    under the dot metric: [B, N] float64 dots, -inf where invalid): a lane
    group with few live rows lists dots near 0, where two f32 orders of the
    same sum differ by more than 1e-5 at D 768 (3xTF32 against the plain
    product), so the scores are held to float64 instead: each within
    rtol/atol 1e-5 of its row's float64 dot plus the plain version's own
    largest distance from float64 in the same lists
    (tests/test_torch_merge.py card_lanes). Returns the largest score
    difference."""
    ks, ki = lane_lists(*kern, winners)
    ps, pi = lane_lists(*plain, winners + 1)
    pw = ps[:, :winners]
    same_inf = np.array_equal(np.isneginf(ks), np.isneginf(pw))
    fin = ~np.isneginf(pw) & ~np.isneginf(ks)
    diff = np.where(fin, np.abs(ks - np.where(fin, pw, 0.0)), 0.0)
    err = float(diff.max()) if fin.any() else 0.0
    off = (diff > 1e-5 + 1e-5 * np.abs(np.where(fin, pw, 0.0))).any(axis=1)
    if exact is not None:
        # the [M, W] lists are query-major (lane_lists): M = B x 128
        ex = exact.cpu().numpy()
        b = ex.shape[0]

        def f64_of(i_):
            return np.take_along_axis(ex, i_.reshape(b, -1).astype(np.int64),
                                      axis=1).reshape(i_.shape)
        dk, dp = f64_of(ki), f64_of(pi[:, :winners])
        kf = ~np.isneginf(ks)
        ek = np.abs(ks.astype(np.float64) - dk)[kf]
        slack = float(np.abs(pw.astype(np.float64) - dp)[~np.isneginf(pw)].max(initial=0.0))
        over = ek > 1e-5 + 1e-5 * np.abs(dk[kf]) + slack
        log(f"  {label:48s} against float64: largest {ek.max(initial=0.0):.3g} (rms "
            f"{np.sqrt(np.mean(ek ** 2)) if ek.size else 0.0:.3g}), the plain version's "
            f"largest {slack:.3g}; beyond the rule {int(over.sum())}")
        off[:] = False
        if over.any():
            raise AssertionError(f"{label} lies farther from float64 than the rule allows")
    excused = 0
    if distinct and off.any():
        def near(a):
            a = np.where(np.isneginf(a), np.nan, a)
            gap = np.abs(np.diff(a, axis=1))
            return (gap <= 1e-5 * np.maximum(1.0, np.abs(a[:, 1:]))).any(axis=1)
        ok = near(ks[off]) | near(ps[off])
        excused = int(ok.sum())
        off[np.flatnonzero(off)[ok]] = False
    bad = 0
    for m in np.flatnonzero((pi[:, :winners] != ki).any(axis=1)):
        for p in np.flatnonzero(pi[m, :winners] != ki[m]):
            close = np.abs(ps[m] - ps[m, p]) <= 1e-5 * max(1.0, abs(ps[m, p]))
            close[p] = False
            bad += not close.any()
    log(f"  {label:48s} max_abs_err {err:.3g} -inf pattern equal {same_inf} "
        f"scores off {int(off.sum())} (near-ties excused {excused}) id mismatches "
        f"beyond ties {bad}")
    if not same_inf or off.any() or bad:
        raise AssertionError(f"{label} disagrees with its plain version")
    return err


def check_merge_kernel(merge, SM, dev, rng) -> float:
    """Phase 2g: K7 against merge_topw_plain: f32 and bf16 rows, three
    metrics, W 1-3, 5% invalid rows and one lane group with one live row;
    the dot lists over f32 rows against float64 (compare_lanes' exact)."""
    err = 0.0
    for n, d, b, tile_n in ((65536, D, 64, 16384), (8192, 100, 5, 2048),
                            (8192, 768, 70, 2048)):
        v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(dev)
        valid = torch.from_numpy(rng.random(n) > 0.05).to(dev)
        valid[3::128] = False
        valid[3 + 128 * 5] = True
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
        sq = (v * v).sum(-1)
        exact = torch.where(valid[None, :], q.double() @ v.double().T, float("-inf"))
        for label, rows in (("f32", v), ("bf16", v.to(torch.bfloat16))):
            for metric in (SM.COSINE, SM.EUCLIDEAN, SM.DOT_PRODUCT):
                for w in (1, 2, 3):
                    got = merge.merge_topw_cuda(rows, sq, valid, q, metric=metric,
                                                winners=w, tile_n=tile_n)
                    torch.cuda.synchronize()
                    want = merge.merge_topw_plain(rows, sq, valid, q, metric=metric,
                                                  winners=w + 1)
                    f64 = label == "f32" and metric is SM.DOT_PRODUCT
                    err = max(err, compare_lanes(
                        f"scan_merge_topw {label} {n}x{d} B{b} {metric.name} W{w}",
                        got, want, w, exact=exact if f64 else None))
    return err


def check_fold_kernel(decompose, dev, rng) -> float:
    """Phase 2h: K8 against fold_probe_plain, every mode, tiles 8192 and
    16384, at 65,536 x 384, B 64, at 16,384 x 100, B 5, and at 16,384 x
    768, B 70."""
    err = 0.0
    for n, d, b in ((65536, D, 64), (16384, 100, 5), (16384, 768, 70)):
        v = torch.from_numpy(rng.standard_normal((n, d), dtype=np.float32)).to(
            dev).to(torch.bfloat16)
        q = torch.from_numpy(rng.standard_normal((b, d), dtype=np.float32)).to(dev)
        for tile_n in (8192, 16384):
            for mode in decompose.MODES:
                label = f"scan_fold_probe {mode} tile {tile_n} {n}x{d} B{b}"
                got = decompose.fold_probe_cuda(v, q, mode=mode, tile_n=tile_n, winners=2)
                torch.cuda.synchronize()
                if mode == "none":
                    want = decompose.fold_probe_plain(v, q, mode=mode, tile_n=tile_n)
                    err = max(err, compare_first_cols(label, got, want))
                else:  # the plain lists of 3 cover a near-tie at the 2nd place
                    want = decompose.fold_probe_plain(v, q, mode=mode, tile_n=tile_n,
                                                      winners=3)
                    err = max(err, compare_lanes(label, got, want, 2,
                                                 distinct=mode == "maxonly"))
    return err


def compare_first_cols(label, got, want) -> float:
    """K8 `none`: raw dots of every magnitude, so K6's rule: |diff| <=
    1e-5 * max(1, max |out|) (f32 sums taken in another order); ids all 0."""
    if got[1].any():
        raise AssertionError(f"{label}: ids are not 0")
    return compare_probe(label, got[0], want[0])


def design_work(n: int) -> str:
    """The tensor work of the tensor-core body at n rows, B queries: three
    bf16 passes (the f32 queries' terms) of 2 B n D at the bf16 peak."""
    ms = 3 * 2.0 * B * n * D / PEAK_OPS_PER_S["bf16"] * 1e3
    return f"tensor work {ms:.4f} ms (3 bf16 passes)"


def time_merge_kernel(merge, SM, dev, rng, n: int, errs: dict) -> dict:
    """Phase 2i: K7 at the headline shape (2^20 x 384 bf16 rows, B 256,
    cosine, tile 16384) for W 2 and 3, held against the plain version and
    timed beside it and a bf16 torch.mm + per-lane-group torch.topk; the
    W 2 line is the kernel line's. Then over f32 rows (3xTF32 on the same
    body) at W 2, beside a TF32-off f32 torch.mm + the same top-k, priced
    at three tf32 passes as K1 and K3 over f32 rows are."""
    v = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)).to(dev)
    sq = (v * v).sum(-1)
    vb = v.to(torch.bfloat16)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).to(dev)
    qb = q.to(torch.bfloat16)
    out = {}
    for w in (2, 3):
        def kern(w=w):
            return merge.merge_topw_cuda(vb, sq, valid, q, metric=SM.COSINE,
                                         winners=w, tile_n=merge.DEFAULT_TILE_N)

        def plain(w=w):
            return merge.merge_topw_plain(vb, sq, valid, q, metric=SM.COSINE, winners=w)

        err = compare_lanes(f"scan_merge_topw at the headline shape, W {w}",
                            kern(), merge.merge_topw_plain(
                                vb, sq, valid, q, metric=SM.COSINE, winners=w + 1), w)
        errs["scan_merge_topw"] = max(errs.get("scan_merge_topw", 0.0), err)
        ms, plain_ms = interleaved_ms(kern, plain, reps=10, plain_reps=2)
        lib_ms = cuda_time_ms(
            lambda w=w: torch.topk(torch.mm(qb, vb.T).view(B, n // 128, 128), w, dim=1),
            10)
        nbytes = n * D * 2 + n * 4 + n + B * D * 4 + w * B * 128 * 8
        out[w] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                  **bound(nbytes, 2.0 * B * n * D, "bf16")}
        log(f"  scan_merge_topw (W {w}, tile {merge.DEFAULT_TILE_N}) kernel {ms:.4f} ms  "
            f"plain {plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound "
            f"{out[w]['bound_ms']:.4f} ms ({out[w]['bound_by']}, bf16 rate)  "
            f"{design_work(n)}")
    del vb

    def kern32():
        return merge.merge_topw_cuda(v, sq, valid, q, metric=SM.COSINE, winners=2,
                                     tile_n=merge.DEFAULT_TILE_N)

    def plain32():
        return merge.merge_topw_plain(v, sq, valid, q, metric=SM.COSINE, winners=2)

    err = compare_lanes("scan_merge_topw over f32 rows at the headline shape, W 2", kern32(),
                        merge.merge_topw_plain(v, sq, valid, q, metric=SM.COSINE, winners=3), 2)
    errs["scan_merge_topw"] = max(errs["scan_merge_topw"], err)
    ms, plain_ms = interleaved_ms(kern32, plain32, reps=20, plain_reps=2)
    lib_ms = cuda_time_ms(
        lambda: torch.topk(torch.mm(q, v.T).view(B, n // 128, 128), 2, dim=1), 5)
    t = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
         **bound(n * D * 4 + n * 4 + n + B * D * 4 + 2 * B * 128 * 8, 3 * 2.0 * B * n * D,
                 "tf32")}
    log(f"  scan_merge_topw over f32 rows (W 2, tile {merge.DEFAULT_TILE_N}, 3xTF32 on the "
        f"tensor-core body) kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  library (TF32 off: "
        f"{not torch.backends.cuda.matmul.allow_tf32}) {lib_ms:.4f} ms  bound "
        f"{t['bound_ms']:.4f} ms ({t['bound_by']}, tf32 rate: three passes)")
    del v
    torch.cuda.empty_cache()
    return out[2]


def time_fold_kernel(decompose, dev, rng, n: int, errs: dict) -> dict:
    """Phase 2j: K8 at its shape (2^20 x 384 bf16 rows, B 256, W 2) in
    every mode at tiles 8192 and 16384, held against the plain version and
    timed beside it and a bf16 torch.mm + row max; `full` at 16384 is the
    kernel line's."""
    v = torch.from_numpy(rng.standard_normal((n, D), dtype=np.float32)).to(dev).to(
        torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((B, D), dtype=np.float32)).to(dev)
    lib_ms = cuda_time_ms(lambda: decompose.dot_rowmax_library(v, q), 10)
    out = {}
    for tile_n in (8192, 16384):
        for mode in decompose.MODES:
            def kern(mode=mode, tile_n=tile_n):
                return decompose.fold_probe_cuda(v, q, mode=mode, tile_n=tile_n, winners=2)

            def plain(mode=mode, tile_n=tile_n):
                return decompose.fold_probe_plain(v, q, mode=mode, tile_n=tile_n, winners=2)

            label = f"scan_fold_probe {mode} at its shape, tile {tile_n}"
            if mode == "none":
                err = compare_first_cols(label, kern(), plain())
            else:
                err = compare_lanes(label, kern(), decompose.fold_probe_plain(
                    v, q, mode=mode, tile_n=tile_n, winners=3), 2,
                    distinct=mode == "maxonly")
            errs["scan_fold_probe"] = max(errs.get("scan_fold_probe", 0.0), err)
            ms, plain_ms = interleaved_ms(kern, plain, reps=10, plain_reps=2)
            n_out = 128 if mode == "none" else 256
            nbytes = n * D * 2 + B * D * 4 + (n // tile_n) * B * n_out * 8
            out[(mode, tile_n)] = {"ms": ms, "plain_ms": plain_ms, "library_ms": lib_ms,
                                   **bound(nbytes, 2.0 * B * n * D, "bf16")}
            t = out[(mode, tile_n)]
            log(f"  scan_fold_probe {mode:7s} tile {tile_n:5d} kernel {ms:.4f} ms  plain "
                f"{plain_ms:.4f} ms  library {lib_ms:.4f} ms  bound {t['bound_ms']:.4f} "
                f"ms ({t['bound_by']}, bf16 rate)  {design_work(n)}")
    del v
    torch.cuda.empty_cache()
    return out[("full", 16384)]


def timed(spent: dict, key: str, fn, sync: bool):
    """``fn`` with each call's host-clock ms appended to spent[key]; with
    ``sync`` the time runs to torch.cuda.synchronize()."""
    def run(*args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        if sync:
            torch.cuda.synchronize()
        spent[key].append((time.perf_counter() - t) * 1e3)
        return out
    return run


def run_batches(fn, queries, n_batches: int):
    """Warm call, then n_batches timed calls; (results of the last call,
    per-batch wall-clock ms). Results come back to the host, so each
    call's time covers the device work."""
    fn(queries)
    times = []
    res = None
    for _ in range(n_batches):
        t0 = time.perf_counter()
        res = fn(queries)
        times.append((time.perf_counter() - t0) * 1e3)
    return res, np.asarray(times)


def ids_of(rows) -> np.ndarray:
    return np.asarray([[h.id for h in r] for r in rows])


def scores_of(rows) -> np.ndarray:
    return np.asarray([[h.score for h in r] for r in rows])


def recall(got: np.ndarray, truth: np.ndarray) -> float:
    hits = sum(len(set(a) & set(b)) for a, b in zip(got, truth))
    return hits / truth.size


def truth_topk(rows32: np.ndarray, q64: np.ndarray, metric_name: str, dev, k: int = K):
    """float64 top-(k+1) on the card: (scores, slots), ties to the lowest
    slot. Rows are the f32 values the collection stored as f64."""
    q = torch.from_numpy(q64).to(dev)
    out = []
    for lo in range(0, len(rows32), 1 << 18):
        v = torch.from_numpy(rows32[lo:lo + (1 << 18)]).to(dev).double()
        if metric_name == "cosine":
            s = (q @ v.T) / (q.norm(dim=1)[:, None] * v.norm(dim=1)[None, :])
        else:
            s = 1.0 / (1.0 + torch.cdist(q, v, p=1.0))
        out.append(s)
    s = torch.cat(out, dim=1)
    s, i = torch.sort(s, dim=1, descending=True, stable=True)
    return s[:, : k + 1].cpu().numpy(), i[:, : k + 1].cpu().numpy()


def with_env(fn, name: str, value: str):
    """``fn`` run with one environment variable set, restored after."""
    def run(qs):
        old = os.environ.get(name)
        os.environ[name] = value
        try:
            return fn(qs)
        finally:
            if old is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = old
    return run


def drive(paths, queries, n_batches, build, card, native=None):
    """Run each (name, fn) path; returns its results, launch deltas and
    per-batch ms."""
    results, moved_all, times = {}, {}, {}
    for name, fn in paths:
        before = {kk.symbol: kk.launches for kk in build.KERNELS}
        calls = native.calls if native is not None else 0
        gc2 = gc.get_stats()[2]["collections"]
        t0 = time.perf_counter()
        res, ms = run_batches(fn, queries, n_batches)
        wall = time.perf_counter() - t0
        gc2 = gc.get_stats()[2]["collections"] - gc2
        moved = {kk.symbol: kk.launches - before[kk.symbol]
                 for kk in build.KERNELS if kk.launches != before[kk.symbol]}
        extra = f"; native re-scores {native.calls - calls}" if native is not None else ""
        results[name] = res
        moved_all[name] = moved
        times[name] = ms
        log(f"  {name:42s} QPS {len(queries) * n_batches / (ms.sum() / 1e3):.1f}  "
            f"batch p50 {np.percentile(ms, 50):.3f} ms p99 {np.percentile(ms, 99):.3f} ms  "
            f"slowest #{int(ms.argmax())} of {n_batches}, full GC passes {gc2}  "
            f"(first call + {n_batches} batches {wall:.2f} s; launches {moved}{extra}) [{card}]")
    return results, moved_all, times


def breakdown(paths, queries, times, n_batches, build, card) -> None:
    """Phase 3's paths (name, client, fn) taken apart on n_batches more
    batches: the device stage (the index's _device_topk to
    torch.cuda.synchronize()), within it merge_topk's stable sorts (each
    from a synchronize to the next, summed over the stage) and the rest
    (the kernel, its operands, a re-score on the card), and the host
    remainder (the main run's batch p50 less the device stage's p50),
    within it the index's _finalize_device (the f64 re-score of
    reduced-precision rows, else the cosine clamp) and the rest (the
    fetch, the ids, one result object a hit)."""
    from vectorlite_tpu_torch.kernels import scan

    saved = scan.merge_topk
    for name, client, fn in paths:
        spent = {"device": [], "merge": [], "finalize": []}
        sorts = []

        def merge_topk(s, i, k, sorts=sorts):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = saved(s, i, k)
            torch.cuda.synchronize()
            sorts.append((time.perf_counter() - t) * 1e3)
            return out
        with client.get_collection("main").index_read() as index:
            pass
        device_topk = timed(spent, "device", index._device_topk, True)

        def staged(*args, spent=spent, sorts=sorts, device_topk=device_topk, **kw):
            sorts.clear()
            out = device_topk(*args, **kw)
            spent["merge"].append(sum(sorts))
            return out
        index._device_topk = staged
        index._finalize_device = timed(spent, "finalize", index._finalize_device, False)
        scan.merge_topk = merge_topk
        try:
            drive([(f"{name}, taken apart", fn)], queries, n_batches, build, card)
        finally:
            scan.merge_topk = saved
            del index._device_topk, index._finalize_device
        dev_p50, merge_p50, fin_p50 = (float(np.percentile(spent[key], 50))
                                       for key in ("device", "merge", "finalize"))
        host = float(np.percentile(times[name], 50)) - dev_p50
        log(f"    {name}: device stage p50 {dev_p50:.3f} ms (kernel, operands and the "
            f"rest {dev_p50 - merge_p50:.3f}, merge_topk sorts {merge_p50:.3f}); host "
            f"remainder (batch p50 {np.percentile(times[name], 50):.3f} - device p50) "
            f"{host:.3f} ms (_finalize_device p50 {fin_p50:.3f}, the rest "
            f"{host - fin_p50:.3f}) [{card}]")


def main_path(vl, build, native, dev, rows, queries, card: str, n_batches: int):
    """Phase 3: the SDK main path; returns (per-kernel launch counts, the
    exact path's ids for the 256 queries)."""
    SM = vl.SimilarityMetric
    n = len(rows)
    metas = [{"shard": i % 8} for i in range(n)]

    # The default call, precision guard on: the guard decides at the
    # device build whether reduced-precision selection may serve.
    os.environ.pop("VECTORLITE_SPEED_GUARD", None)
    dclient = vl.VectorLiteClient(vl.MockEmbeddingFunction(D), device=dev)
    dclient.create_collection("default", vl.IndexType.FLAT)
    dclient.add_vectors_to_collection("default", rows)
    dclient.search_vectors_in_collection("default", queries, K)  # device build
    # The guard's sampled statistic scales with the row count and refuses
    # the speed path on random corpora at this size; VECTORLITE_SPEED_GUARD=0
    # is the documented switch that keeps it on for the collections built
    # below, and the recall checks vouch for the result.
    os.environ["VECTORLITE_SPEED_GUARD"] = "0"

    client = vl.VectorLiteClient(vl.MockEmbeddingFunction(D), device=dev)
    client.create_collection("main", vl.IndexType.FLAT)
    t0 = time.perf_counter()
    client.add_vectors_to_collection("main", rows, metadatas=metas)
    log(f"  add_vectors: {time.perf_counter() - t0:.2f} s")
    qclient = vl.VectorLiteClient(
        vl.MockEmbeddingFunction(D),
        config=vl.VectorLiteConfig.profile("quantized"), device=dev,
    )
    qclient.create_collection("main", vl.IndexType.FLAT)
    qclient.add_vectors_to_collection("main", rows)
    # bf16 rows on the card (the host re-scores the 2x pool in f64): K1's
    # bf16 route
    mclient = vl.VectorLiteClient(
        vl.MockEmbeddingFunction(D),
        config=vl.VectorLiteConfig.profile("memory-optimized"), device=dev,
    )
    mclient.create_collection("main", vl.IndexType.FLAT)
    mclient.add_vectors_to_collection("main", rows)
    del metas
    # the high-accuracy profile: f32 rows and no scan copy (that needs the
    # auto profile), so its default call's speed path runs K3 over the rows
    # themselves, on the 3xTF32 form
    t0 = time.perf_counter()
    hclient = vl.VectorLiteClient(
        vl.MockEmbeddingFunction(D),
        config=vl.VectorLiteConfig.profile("high-accuracy"), device=dev,
    )
    hclient.create_collection("main", vl.IndexType.FLAT)
    hclient.add_vectors_to_collection("main", rows)
    added = time.perf_counter() - t0
    hclient.search_vectors_in_collection("main", queries, K)  # device build
    torch.cuda.synchronize()
    log(f"  high-accuracy collection built in {time.perf_counter() - t0:.2f} s (add_vectors "
        f"{added:.2f} s, the first search's device build the rest)")
    high = "high-accuracy default call (K3 over f32 rows, 3xTF32, + f32 re-score)"

    def high_accuracy(qs):
        return hclient.search_vectors_in_collection("main", qs, K)

    def exact(coll, k=K):
        def fn(qs):
            with coll.index_read() as index:
                return index.search_batch(qs, k, SM.COSINE, approx=False)
        return fn

    def quantized_speed(qs):
        return qclient.search_vectors_in_collection("main", qs, K)

    paths = [
        ("default call, guard on",
         lambda qs: dclient.search_vectors_in_collection("default", qs, K)),
        ("speed, guard off (K3 + f32 re-score)",
         lambda qs: client.search_vectors_in_collection("main", qs, K)),
        ("exact approx=False (K1)", exact(client.get_collection("main"))),
        ("where-filtered (K1)",
         lambda qs: client.search_vectors_in_collection("main", qs, K, where={"shard": 3})),
        ("manhattan (K4)",
         lambda qs: client.search_vectors_in_collection("main", qs, K, SM.MANHATTAN)),
        ("memory-optimized manhattan (K4 over bf16 rows + f64 re-score)",
         lambda qs: mclient.search_vectors_in_collection("main", qs, K, SM.MANHATTAN)),
        (high, high_accuracy),
        ("quantized speed (K3 int8 + f64 re-score)", quantized_speed),
        ("quantized speed, numpy re-score (VECTORLITE_NO_NATIVE=1)",
         with_env(quantized_speed, "VECTORLITE_NO_NATIVE", "1")),
        ("quantized exact (K2 + f64 re-score)", exact(qclient.get_collection("main"))),
        ("memory-optimized exact (K1 over bf16 rows + f64 re-score)",
         exact(mclient.get_collection("main"))),
    ]
    # k = 100: lists past the TOPK mode's 32 (k_pad 128, the 2x pools of 256
    # over int8 and bf16 rows) run on the tensor-core body's wide mode
    wide = [(f"exact approx=False, k {K_WIDE} (K1, wide lists)", client, K1_WIDE),
            (f"quantized exact, k {K_WIDE} (K2, wide lists)", qclient, K2_WIDE),
            (f"memory-optimized exact, k {K_WIDE} (K1 over bf16 rows, wide lists)", mclient,
             K1_WIDE_BF16)]
    paths += [(name, exact(cl.get_collection("main"), K_WIDE)) for name, cl, _ in wide]
    build.reset_launch_counts()
    calls = native.calls
    results, moved, times = drive(paths, queries, n_batches, build, card, native)
    launches = {kk.symbol: kk.launches for kk in build.KERNELS}
    for sym in (K1_TF32, K1_BF16, K1_WIDE, K1_WIDE_BF16, K2_S8, K2_WIDE, K3_INT8, K3_TF32,
                K4_F32, K4_BF16):
        if not launches[sym]:
            raise AssertionError(f"{sym} was never launched on the main path")
    # the high-accuracy default call on K3's 3xTF32 route alone: not the
    # CUDA-core body, not K1
    if set(moved[high]) & {*K1_SYMBOLS, *K2_SYMBOLS, *K3_SYMBOLS, *K4_SYMBOLS} != {K3_TF32}:
        raise AssertionError(f"{high}: launched {moved[high]}, not {K3_TF32}")
    # each exact path on the route exact_route names: k_pad 16 (K1) and the
    # 2x pool of 32 (K2) on the tensor-core body's TOPK mode, k 100 on its
    # wide mode; manhattan at k_pad 16 and the bf16 rows' pool of 32 on K4's
    # FADD stream
    for path, want in (("exact approx=False (K1)", K1_TF32),
                       ("where-filtered (K1)", K1_TF32),
                       ("quantized exact (K2 + f64 re-score)", K2_S8),
                       ("memory-optimized exact (K1 over bf16 rows + f64 re-score)", K1_BF16),
                       ("manhattan (K4)", K4_F32),
                       ("memory-optimized manhattan (K4 over bf16 rows + f64 re-score)",
                        K4_BF16),
                       *((name, sym) for name, _, sym in wide)):
        if set(moved[path]) & {*K1_SYMBOLS, *K2_SYMBOLS, *K4_SYMBOLS} != {want}:
            raise AssertionError(f"{path}: launched {moved[path]}, not {want}")
    if native.calls == calls:
        raise AssertionError("the native f64 re-score never served the quantized paths")
    breakdown([(name, cl, exact(cl.get_collection("main"), K_WIDE)) for name, cl, _ in wide]
              + [(high, hclient, high_accuracy)],
              queries, times, n_batches // 2, build, card)
    dclient.delete_collection("default")
    hclient.delete_collection("main")  # the later paths and phases see its rows no more
    # lists past 256 (k_pad 1,024; the 2x pools of 512 over bf16 rows and
    # 1,024 over int8 rows) run on the radix select, on the tiles
    # exact_tile grows
    deep = [(f"exact approx=False, k {K_DEEP['f32']} (K1, deep lists)", client, K1_SELECT,
             K_DEEP["f32"]),
            (f"memory-optimized exact, k {K_DEEP['bf16']} (K1 over bf16 rows, deep lists)",
             mclient, K1_SELECT_BF16, K_DEEP["bf16"]),
            (f"quantized exact, k {K_DEEP['int8']} (K2, deep lists)", qclient, K2_SELECT,
             K_DEEP["int8"])]
    deep_paths(build, SM, deep, rows, queries, dev, card, n_batches)
    # lists past 2,048 (k_pad 4,096; the 2x pools of 4,096 over bf16 and
    # int8 rows), in batches of 64
    select = [(f"exact approx=False, k {K_SELECT['f32']} (K1, radix select)", client,
               K1_SELECT, K_SELECT["f32"]),
              (f"memory-optimized exact, k {K_SELECT['bf16']} (K1 over bf16 rows, radix "
               f"select)", mclient, K1_SELECT_BF16, K_SELECT["bf16"]),
              (f"quantized exact, k {K_SELECT['int8']} (K2, radix select)", qclient, K2_SELECT,
               K_SELECT["int8"])]
    deep_paths(build, SM, select, rows, queries[:SELECT_BATCH], dev, card, n_batches)
    # manhattan past k 32 (k_pad 128 and 1,024; the bf16 rows' 2x pool of
    # 256) on K4's scores into the radix select, held on the 32 queries
    # below to one f64 manhattan scan at the larger k, which the k 10 check
    # reads too
    pick = slice(0, B, B // 32)
    l1_truth = truth_topk(rows, queries[pick], "manhattan", dev, max(K_L1))
    l1 = [(f"manhattan, k {k} (K4, radix select)", client, K4_SELECT, k) for k in K_L1]
    l1.append((f"memory-optimized manhattan, k {K_L1[0]} (K4 over bf16 rows, radix select, "
               f"+ f64 re-score)", mclient, K4_SELECT_BF16, K_L1[0]))
    deep_paths(build, SM, l1, rows, queries, dev, card, n_batches, SM.MANHATTAN,
               (pick, *l1_truth))
    launches = {kk.symbol: kk.launches for kk in build.KERNELS}
    for sym in (K1_SELECT, K1_SELECT_BF16, K2_SELECT, K4_SELECT, K4_SELECT_BF16):
        if not launches[sym]:
            raise AssertionError(f"{sym} was never launched on the main path")

    # correctness by the repo's own means
    speed = ids_of(results["speed, guard off (K3 + f32 re-score)"])
    exact_ids = ids_of(results["exact approx=False (K1)"])
    checks = [
        ("speed vs exact", speed, exact_ids),
        ("default call vs exact", ids_of(results["default call, guard on"]), exact_ids),
        ("high-accuracy default call vs exact", ids_of(results[high]), exact_ids),
        ("quantized speed vs quantized exact",
         ids_of(results["quantized speed (K3 int8 + f64 re-score)"]),
         ids_of(results["quantized exact (K2 + f64 re-score)"])),
    ]
    checks += [
        (f"exact k {K_WIDE} (its first {K}) vs exact",
         ids_of(results[wide[0][0]])[:, :K], exact_ids),
        (f"quantized exact k {K_WIDE} (its first {K}) vs quantized exact",
         ids_of(results[wide[1][0]])[:, :K],
         ids_of(results["quantized exact (K2 + f64 re-score)"])),
        ("memory-optimized exact vs exact",
         ids_of(results["memory-optimized exact (K1 over bf16 rows + f64 re-score)"]),
         exact_ids),
        (f"memory-optimized exact k {K_WIDE} (its first {K}) vs exact",
         ids_of(results[wide[2][0]])[:, :K], exact_ids),
        ("memory-optimized manhattan vs manhattan",
         ids_of(results["memory-optimized manhattan (K4 over bf16 rows + f64 re-score)"]),
         ids_of(results["manhattan (K4)"])),
    ]
    for label, got, ref in checks:
        r = recall(got, ref)
        log(f"  recall@10 {label} ({B} queries): {r:.5f}")
        if r < 0.99:
            raise AssertionError(f"{label}: recall {r} < 0.99")
    filt = results["where-filtered (K1)"]
    if any(h.metadata["shard"] != 3 for row in filt for h in row):
        raise AssertionError("the where filter let another shard through")
    mclient.delete_collection("main")

    # exact paths against float64 truth on 32 queries from all 4 blocks
    for metric_name, path in (("cosine", "exact approx=False (K1)"),
                              ("manhattan", "manhattan (K4)")):
        t_s, t_ids = (truth_topk(rows, queries[pick], metric_name, dev)
                      if metric_name == "cosine" else l1_truth)
        got = results[path][pick]
        bad = ids_match(t_s, t_ids, scores_of(got), ids_of(got))  # ids are slots here
        err = float(np.max(np.abs(scores_of(got) - t_s[:, :K])))
        log(f"  {path} vs f64 truth (32 queries, every 8th): "
            f"id mismatches beyond ties {bad}, max score err {err:.3g}")
        if bad or err > 1e-5:
            raise AssertionError(f"{path} disagrees with float64 truth")
    t_s, t_ids = truth_topk(rows, queries[pick], "cosine", dev)
    q_ok = recall(ids_of(results["quantized exact (K2 + f64 re-score)"][pick]), t_ids[:, :K])
    log(f"  quantized exact recall@10 vs f64 truth (32 queries): {q_ok:.5f}")
    if q_ok < 0.99:
        raise AssertionError(f"quantized exact recall {q_ok} < 0.99")
    return launches, exact_ids


def deep_paths(build, SM, clients, rows, queries, dev, card: str, n_batches: int,
               metric=None, truth=None) -> None:
    """Phase 3's lists past 256 (cosine) or past 32 (manhattan), each
    (name, client, kernel, k) on its collection: one object-returning call
    (search_batch, approx=False) whose K1 / K2 / K4 launches must be the
    named kernel's alone, then n_batches timed calls of search_batch_arrays
    (B x k result objects a call would time the host), the device stage
    (the index's _device_topk to torch.cuda.synchronize()) timed apart and
    the host remainder (the batch p50 less the device stage's), the same
    route, and the ids held against float64 truth beyond 1e-5 near-ties:
    every query's (64 at a time), or, with ``truth`` (the queries picked,
    their f64 top scores and rows at k or more), the picked ones'."""
    metric = metric or SM.COSINE
    listed = {*K1_SYMBOLS, *K2_SYMBOLS, *K4_SYMBOLS}
    for name, client, sym, k in clients:
        with client.get_collection("main").index_read() as index:
            pass
        before = {kk.symbol: kk.launches for kk in build.KERNELS}
        index.search_batch(queries, k, metric, approx=False)
        moved = {kk.symbol for kk in build.KERNELS if kk.launches != before[kk.symbol]}
        if moved & listed != {sym}:
            raise AssertionError(f"{name}: launched {moved}, not {sym}")
        spent = {"device": []}
        index._device_topk = timed(spent, "device", index._device_topk, True)
        try:
            _, moved_all, times = drive(
                [(name, lambda qs, index=index, k=k: index.search_batch_arrays(
                    qs, k, metric, approx=False))], queries, n_batches, build, card)
            ids, scores = index.search_batch_arrays(queries, k, metric, approx=False)
        finally:
            del index._device_topk
        if set(moved_all[name]) & listed != {sym}:
            raise AssertionError(f"{name}: launched {moved_all[name]}, not {sym}")
        dev_ms = np.asarray(spent["device"][1:])  # past the warm call
        p50, dev50 = np.percentile(times[name], 50), np.percentile(dev_ms, 50)
        log(f"    {name}: device stage p50 {dev50:.3f} ms p99 "
            f"{np.percentile(dev_ms, 99):.3f} ms; batch p50 {p50:.3f} "
            f"ms p99 {np.percentile(times[name], 99):.3f} ms; host remainder {p50 - dev50:.3f} "
            f"ms; launches {moved_all[name]} [{card}]")
        bad, err = 0, 0.0
        if truth is not None:
            pick, t_s, t_ids = truth
            bad = ids_match(t_s, t_ids, scores[pick], ids[pick])
            err = float(np.max(np.abs(scores[pick] - t_s[:, :k])))
            held = len(scores[pick])
        else:
            for lo in range(0, len(queries), 64):  # float64 truth, 64 queries at a time
                t_s, t_ids = truth_topk(rows, queries[lo:lo + 64], "cosine", dev, k)
                bad += ids_match(t_s, t_ids, scores[lo:lo + 64], ids[lo:lo + 64])
                err = max(err, float(np.max(np.abs(scores[lo:lo + 64] - t_s[:, :k]))))
            held = len(queries)
        log(f"    {name} vs f64 truth ({held} queries, top {k}): id mismatches beyond ties "
            f"{bad}, max score err {err:.3g}")
        if bad or err > 1e-5:
            raise AssertionError(f"{name} disagrees with float64 truth")


# ---------------------------------------------------------------- phase 3b

P3B_SHARDS = 4  # cuda:0 repeated: 2^18 rows a shard at 2^20
P3B_BATCHES = 3  # timed batches a path, after a warm call
P3B_BURST = 4096  # rows of the insert burst across a shard boundary
P3B_PQ_ROWS = 1 << 18
P3B_IVF_CELLS = 2048  # C, divisible by P3B_SHARDS (~512 rows a cell, P 640)
P3B_IVF_NPROBE = 4  # cells a shard probes
P3B_IVF_QUERIES = 64
P3B_HNSW_ROWS = 1 << 16
P3B_STREAM_BATCHES = 32


def hold_arrays(label, got, want, tol=1e-5) -> None:
    """(ids, scores) of one path against another's: scores within tol,
    ids equal except among scores within tol of each other."""
    gi, gs = got
    wi, ws = want
    fin = np.isfinite(ws)
    close = np.array_equal(np.isfinite(gs), fin) and np.allclose(
        gs[fin], ws[fin], rtol=tol, atol=tol)
    bad = ids_match(ws, wi, gs, gi, tol)
    if not close or bad:
        raise AssertionError(f"{label}: {bad} id mismatches beyond ties, scores close {close}")


def counted(build, fn, calls: int):
    """Run ``fn`` ``calls`` times (host-clock ms each, to the fetched
    result); returns (last result, ms, launches per call by kernel)."""
    before = {kk.symbol: kk.launches for kk in build.KERNELS}
    times, out = [], None
    for _ in range(calls):
        t0 = time.perf_counter()
        out = fn()
        times.append((time.perf_counter() - t0) * 1e3)
    moved = {kk.symbol: (kk.launches - before[kk.symbol]) / calls
             for kk in build.KERNELS if kk.launches != before[kk.symbol]}
    return out, np.asarray(times), moved


def mesh_path(vl, build, ivf, dev, rows, queries, card: str, seed: int) -> dict:
    """Phase 3b: the device mesh (cuda:0 repeated P3B_SHARDS times) on
    phase 3's rows and queries; returns the launches of its counted runs."""
    import torch.distributed as tdist
    from vectorlite_tpu_torch.dist import multihost
    from vectorlite_tpu_torch.dist.sharding import (
        make_mesh, shard_rows, sharded_search_ivf, sharded_search_topk)

    SM = vl.SimilarityMetric
    n = len(rows)
    mesh = make_mesh([dev] * P3B_SHARDS)
    rng = np.random.default_rng([seed, 3])
    totals: dict = {}

    def run(label, fn, calls, shards=None):
        """Warm call, then ``calls`` counted ones; on the mesh every kernel
        of the path launches once a shard a call."""
        fn()
        out, ms, moved = counted(build, fn, calls)
        for sym, c in moved.items():
            totals[sym] = totals.get(sym, 0) + int(c * calls)
        if shards is not None and (not moved or any(c != shards for c in moved.values())):
            raise AssertionError(f"{label}: launches a call {moved}, not {shards} each")
        log(f"  {label:58s} p50 {np.percentile(ms, 50):8.3f} ms  launches a call {moved} [{card}]")
        return out, ms

    def flat(n_rows, on_mesh, profile="auto", metas=None):
        idx = vl.FlatIndex(D, device=dev, device_dtype=profile, mesh=mesh if on_mesh else None)
        idx.add_batch_arrays(np.arange(n_rows), rows[:n_rows], metadatas=metas)
        return idx

    # (a) the guard-on pair on every row: default call, approx=False, a
    # where filter, manhattan, at k 10 and k 100
    t0 = time.perf_counter()
    metas = [{"shard": i % 8} for i in range(n)]
    os.environ.pop("VECTORLITE_SPEED_GUARD", None)
    one, sh = flat(n, False, metas=metas), flat(n, True, metas=metas)
    for idx in (one, sh):
        idx.search_batch_arrays(queries[:8], K, SM.COSINE)  # device build; the guard decides
    os.environ["VECTORLITE_SPEED_GUARD"] = "0"
    del metas
    log(f"  (a) one card and {P3B_SHARDS} shards of {sh._capacity // P3B_SHARDS} rows built in "
        f"{time.perf_counter() - t0:.2f} s; guard refuses reduced-precision selection: one card "
        f"{one._precision_risky}, mesh {sh._precision_risky}")
    if one._precision_risky != sh._precision_risky:
        raise AssertionError("the mesh's precision guard disagrees with one card's")
    paths = (("default call, guard on", {}), ("approx=False", {"approx": False}),
             ("where-filtered", {"where": {"shard": 3}}),
             ("manhattan", {"metric": SM.MANHATTAN}))
    exact10 = None
    for k in (K, K_WIDE):
        for name, kw in paths:
            kw = dict(kw)
            metric = kw.pop("metric", SM.COSINE)
            res = {}
            for tag, idx, shards in (("one card", one, None), ("mesh", sh, P3B_SHARDS)):
                res[tag], ms = run(f"{name}, k {k}, {tag}",
                                   lambda idx=idx: idx.search_batch_arrays(queries, k, metric, **kw),
                                   P3B_BATCHES, shards)
            hold_arrays(f"{name}, k {k}", res["mesh"], res["one card"])
            if name == "where-filtered":
                live = res["mesh"][0][res["mesh"][0] >= 0]
                if np.any(live % 8 != 3):
                    raise AssertionError("the mesh's where filter let another shard through")
            if k == K and name == "approx=False":
                exact10 = res["one card"]

    # (f) the stream on both
    qs = [rng.standard_normal((B, D)) for _ in range(P3B_STREAM_BATCHES)]
    for tag, idx, groups in (("one card", one, (1, 4)), ("mesh", sh, (1,))):
        t0 = time.perf_counter()
        ref = [idx.search_batch_arrays(q, K, SM.COSINE) for q in qs]
        seq = time.perf_counter() - t0
        for group in groups:
            t0 = time.perf_counter()
            got = list(idx.search_batch_stream(iter(qs), K, SM.COSINE, depth=2, group=group))
            wall = time.perf_counter() - t0
            for g, r in zip(got, ref):
                hold_arrays(f"stream {tag} group {group}", g, r)
            log(f"  (f) stream, {tag}, depth 2, group {group}: {len(qs) / wall:.1f} batches/s, "
                f"sequential search_batch_arrays {len(qs) / seq:.1f} batches/s "
                f"({len(qs)} batches of {B}, k {K}) [{card}]")

    # (e) a one-rank NCCL group through dist/multihost.py
    t0 = time.perf_counter()
    multihost.init_process_group(dev, rank=0, world_size=1,
                                 init_method=f"tcp://localhost:{free_port()}")
    try:
        gmesh = make_mesh([dev] * P3B_SHARDS, group=tdist.group.WORLD)
        v = multihost.place_global(gmesh, rows)
        sq = multihost.place_global(gmesh, np.einsum("nd,nd->n", rows, rows))
        valid = multihost.place_global(gmesh, np.ones(n, bool))
        (s, i), _ = run(f"(e) NCCL world 1, sharded_search_topk, k {K}",
                        lambda: sharded_search_topk(v, sq, valid, queries, metric=SM.COSINE,
                                                    k=K, mesh=gmesh), 2, P3B_SHARDS)
        hold_arrays("(e) one-rank NCCL mesh vs one card", (multihost.fetch_replicated(i),
                    multihost.fetch_replicated(s).astype(np.float64)), exact10)
        multihost.barrier(gmesh)
        del v, sq, valid
    finally:
        tdist.destroy_process_group()
    log(f"  (e) process group up, searched and destroyed in {time.perf_counter() - t0:.2f} s")
    del one, sh
    gc.collect()
    torch.cuda.empty_cache()

    # the guard-off pair: the speed path, then a burst across the boundary
    # of shards 2 and 3 and a delete; the pair holds the rows below it
    a = (P3B_SHARDS - 1) * (n // P3B_SHARDS) - P3B_BURST // 2
    one, sh = flat(a, False), flat(a, True)
    t_s, t_ids = truth_topk(rows[:a], queries, "cosine", dev)
    for k in (K, K_WIDE):
        res = {}
        for tag, idx, shards in (("one card (K3 int8 copy)", one, None),
                                 ("mesh (K3 bf16 copy)", sh, P3B_SHARDS)):
            res[tag], _ = run(f"speed path, guard off, k {k}, {tag}",
                              lambda idx=idx: idx.search_batch_arrays(queries, k, SM.COSINE),
                              P3B_BATCHES, shards)
        r1, rm = (recall(res[tag][0][:, :K], t_ids[:, :K]) for tag in res)
        log(f"    recall@10 against f64 truth ({B} queries): one card {r1:.5f}, mesh {rm:.5f}")
        if rm < 0.99:
            raise AssertionError(f"mesh speed path recall {rm} < 0.99")
    placed = list(sh._dev_values)
    for idx in (one, sh):
        idx.add_batch_arrays(np.arange(a, a + P3B_BURST), rows[a : a + P3B_BURST])
    mid = a + P3B_BURST // 2
    head = len(queries) // 2
    q_b = np.concatenate([queries[:head], rows[mid - 64 : mid + 64].astype(np.float64)])
    for label, approx in (("exact", False), ("speed", None)):
        got = sh.search_batch_arrays(q_b, K, SM.COSINE, approx=approx)
        if label == "exact":
            hold_arrays("burst, exact", got, one.search_batch_arrays(q_b, K, SM.COSINE, approx=False))
        if list(got[0][head:, 0]) != list(range(mid - 64, mid + 64)):
            raise AssertionError(f"burst, {label}: the burst rows do not come back first")
    if sh._capacity != n or any(x is not y for x, y in zip(sh._dev_values, placed)):
        raise AssertionError("the burst re-placed the mesh's shards")
    for idx in (one, sh):
        idx.delete(mid - 1)
        idx.delete(mid)
    got = sh.search_batch_arrays(q_b, K, SM.COSINE, approx=False)
    hold_arrays("delete, exact", got, one.search_batch_arrays(q_b, K, SM.COSINE, approx=False))
    if np.isin(got[0], [mid - 1, mid]).any():
        raise AssertionError("a deleted row came back from the mesh")
    log(f"  burst of {P3B_BURST} rows over the shard boundary at {mid} written in place, a delete "
        f"either side: searches equal to one card's")
    del one, sh
    gc.collect()
    torch.cuda.empty_cache()

    # the int8 profile: K2 per shard, winners re-scored in f64
    one, sh = flat(n, False, "int8"), flat(n, True, "int8")
    for k in (K, K_WIDE):
        res = {}
        for tag, idx, shards in (("one card", one, None), ("mesh", sh, P3B_SHARDS)):
            res[tag], _ = run(f"int8 profile approx=False (K2), k {k}, {tag}",
                              lambda idx=idx: idx.search_batch_arrays(
                                  queries, k, SM.COSINE, approx=False),
                              P3B_BATCHES, shards)
        hold_arrays(f"int8 profile, k {k}", res["mesh"], res["one card"])
    del one, sh
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the pq profile on 4 shards
    t_s, t_ids = truth_topk(rows[:P3B_PQ_ROWS], queries, "cosine", dev)
    one, sh = flat(P3B_PQ_ROWS, False, "pq"), flat(P3B_PQ_ROWS, True, "pq")
    rec = {}
    for tag, idx, shards in (("one card", one, None), ("mesh", sh, P3B_SHARDS)):
        out, _ = run(f"(b) pq profile, {P3B_PQ_ROWS} rows, k {K}, {tag}",
                     lambda idx=idx: idx.search_batch_arrays(queries, K, SM.COSINE),
                     P3B_BATCHES, shards)
        if not idx._pq_active:
            raise AssertionError(f"(b) the pq rung is not serving on {tag}")
        rec[tag] = recall(out[0], t_ids[:, :K])
    log(f"    pq recall@10 against f64 truth: one card {rec['one card']:.5f}, "
        f"mesh {rec['mesh']:.5f}")
    if abs(rec["mesh"] - rec["one card"]) > 0.01:
        raise AssertionError("(b) the mesh's pq recall is not within 0.01 of one card's")
    del one, sh
    gc.collect()
    torch.cuda.empty_cache()

    # (c) sharded_search_ivf on a layout of these rows
    t0 = time.perf_counter()
    c = P3B_IVF_CELLS
    cents = ivf.train_centroids(rows[rng.choice(n, 1 << 16, replace=False)], c, iters=4,
                                device=dev)
    live = np.arange(n)
    part_slots, extra = ivf.build_layout(ivf.assign_rows(rows, live, cents), live, c)
    p_width = part_slots.shape[1]
    ps = part_slots.reshape(-1).astype(np.int32)
    prows = np.zeros((c * p_width, D), np.float32)
    prows[ps >= 0] = rows[ps[ps >= 0]]
    cents_np = cents.cpu().numpy()
    layout = [shard_rows(mesh, prows, torch.bfloat16), shard_rows(mesh, ps),
              shard_rows(mesh, np.einsum("nd,nd->n", prows, prows)), shard_rows(mesh, ps >= 0),
              shard_rows(mesh, cents_np), shard_rows(mesh, np.einsum("cd,cd->c", cents_np, cents_np)),
              shard_rows(mesh, rows), shard_rows(mesh, np.ones(n, bool))]
    del prows
    log(f"  (c) layout: C {c}, P {p_width}, {len(extra)} extras (the caller's), built in "
        f"{time.perf_counter() - t0:.2f} s")
    q_ivf = queries[:P3B_IVF_QUERIES]

    def probe():
        return sharded_search_ivf(*layout, q_ivf, n, metric=SM.COSINE, k=K, k_sel=128,
                                  nprobe_per_shard=P3B_IVF_NPROBE, p_width=p_width, mesh=mesh)

    (s_k, i_k), _ = run(f"(c) sharded_search_ivf, B {P3B_IVF_QUERIES}, "
                        f"{P3B_IVF_NPROBE} cells a shard", probe, P3B_BATCHES, P3B_SHARDS)
    saved = ivf.gather_score_pallas
    ivf.gather_score_pallas = ivf.gather_score_plain
    try:
        s_p, i_p = probe()
    finally:
        ivf.gather_score_pallas = saved
    hold_arrays("(c) sharded IVF vs its plain twins", (i_k.cpu().numpy(), s_k.cpu().numpy()),
                (i_p.cpu().numpy(), s_p.cpu().numpy()))
    del layout
    gc.collect()
    torch.cuda.empty_cache()

    # (d) HNSW on 4 shards: the device beam against one card's on one graph
    t0 = time.perf_counter()
    h = vl.HNSWIndex(D, SM.COSINE, mesh=mesh)
    h.add_batch_arrays(np.arange(P3B_HNSW_ROWS), rows[:P3B_HNSW_ROWS])
    log(f"  (d) HNSW of {P3B_HNSW_ROWS} rows built in {time.perf_counter() - t0:.2f} s")
    beam = {}
    for tag in ("mesh", "one card"):
        if tag == "one card":
            h._mesh = None  # the same graph's single-device beam
        beam[tag], _ = run(f"(d) HNSW device beam, B {B}, ef 64, {tag}",
                           lambda: h.search_batch(queries, K, SM.COSINE, ef=64, use_device=True),
                           2)
    as_arrays = {tag: (ids_of(res), scores_of(res)) for tag, res in beam.items()}
    hold_arrays("(d) mesh beams vs one card's", as_arrays["mesh"], as_arrays["one card"])
    log(f"    beams equal: {np.array_equal(as_arrays['mesh'][0], as_arrays['one card'][0])} "
        f"(ids), max score difference "
        f"{np.max(np.abs(as_arrays['mesh'][1] - as_arrays['one card'][1])):.3g}")
    del h
    gc.collect()
    torch.cuda.empty_cache()
    return totals


def pq_path(vl, build, pq, native, dev, rows, queries, exact_ids, card: str,
            n_batches: int, rng) -> dict:
    """Phase 4: the `pq` profile through the SDK, then its 8-bit layout on
    one chunk of the rows; returns the launches of K5's two entries."""
    SM = vl.SimilarityMetric
    n = len(rows)
    metas = [{"shard": i % 8} for i in range(n)]
    client = vl.VectorLiteClient(
        vl.MockEmbeddingFunction(D), config=vl.VectorLiteConfig.profile("pq"),
        device=dev,
    )
    client.create_collection("pq", vl.IndexType.FLAT)
    t0 = time.perf_counter()
    client.add_vectors_to_collection("pq", rows, metadatas=metas)
    del metas
    log(f"  add_vectors: {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    client.search_vectors_in_collection("pq", queries, K)  # trains and encodes
    torch.cuda.synchronize()
    with client.get_collection("pq").index_read() as index:
        pass
    if not index._pq_active:
        raise AssertionError("the pq rung did not engage")
    log(f"  first search (training {tuple(index._dev_codebooks.shape)} codebooks on "
        f"the card, encoding {tuple(index._dev_codes.shape)} codes): "
        f"{time.perf_counter() - t0:.2f} s")

    # the device stage (dispatch to synchronize) and the host re-score,
    # each timed apart on the host clock
    spent = {"device": [], "rescore": []}
    index._device_topk = timed(spent, "device", index._device_topk, True)
    index._exact_rescore = timed(spent, "rescore", index._exact_rescore, False)

    def search(metric, where=None, k=K):
        return lambda qs: client.search_vectors_in_collection(
            "pq", qs, k, metric, where=where)

    paths = [
        ("pq default call (cosine)", SM.COSINE, None),
        ("pq euclidean", SM.EUCLIDEAN, None),
        ("pq manhattan (euclidean proxy)", SM.MANHATTAN, None),
        ("pq where-filtered (cosine)", SM.COSINE, {"shard": 3}),
    ]
    build.reset_launch_counts()
    calls = native.calls
    results = {}
    for name, metric, where in paths:
        spent["device"].clear()
        spent["rescore"].clear()
        res, moved, _ = drive([(name, search(metric, where))], queries, n_batches,
                              build, card, native)
        results[name] = res[name]
        log(f"    device stage p50 {np.percentile(spent['device'], 50):.3f} ms, "
            f"host re-score p50 {np.percentile(spent['rescore'], 50):.3f} ms "
            f"({len(spent['rescore'])} calls)")
        if not moved[name].get("pq_rank_mma") or moved[name].get("pq_rank"):
            raise AssertionError(f"{name}: the tensor-core K5 entry did not serve the 4-bit path")
    launches = {"pq_rank_mma": pq.PQ_RANK_MMA.launches}
    if native.calls == calls:
        raise AssertionError("the native f64 re-score never served the pq paths")

    # the same pipeline with the plain rank over the index's own codes
    for name, metric, where in paths:
        saved = pq.pq_rank
        pq.pq_rank = pq.pq_rank_plain
        try:
            ref = search(metric, where, K + 1)(queries)
        finally:
            pq.pq_rank = saved
        got = results[name]
        bad = ids_match(scores_of(ref), ids_of(ref), scores_of(got), ids_of(got))
        log(f"  {name} vs the plain-rank pipeline: id mismatches beyond ties {bad}")
        if bad:
            raise AssertionError(f"{name} disagrees with the plain-rank pipeline")
    filt = results["pq where-filtered (cosine)"]
    if any(h.metadata["shard"] != 3 for row in filt for h in row):
        raise AssertionError("the where filter let another shard through")

    pick = rng.choice(n, B, replace=False)
    noisy = rows[pick].astype(np.float64) + rng.normal(0.0, 0.01, (B, D))
    top1 = ids_of(client.search_vectors_in_collection("pq", noisy, K))[:, 0]
    self_hit = float(np.mean(top1 == pick))
    r = recall(ids_of(results["pq default call (cosine)"]), exact_ids)
    log(f"  pq self-hit ({B} stored rows + N(0, 0.01^2) noise): {self_hit:.5f}; "
        f"recall@10 of the cosine path vs exact K1 ({B} queries): {r:.5f}")
    if self_hit < 0.99:
        raise AssertionError(f"pq self-hit {self_hit} < 0.99")
    if r < 0.90:
        raise AssertionError(f"pq recall@10 {r} < 0.90")
    client.delete_collection("pq")
    del client, index
    gc.collect()

    # the 8-bit profile (kc 256) on the look-up entry: one chunk of the rows
    n8 = min(n, PQ8_ROWS)
    os.environ["VECTORLITE_PQ_BITS"] = "8"
    try:
        client8 = vl.VectorLiteClient(
            vl.MockEmbeddingFunction(D), config=vl.VectorLiteConfig.profile("pq"),
            device=dev,
        )
        client8.create_collection("pq8", vl.IndexType.FLAT)
        client8.add_vectors_to_collection("pq8", rows[:n8])
        t0 = time.perf_counter()
        client8.search_vectors_in_collection("pq8", queries, K)  # trains and encodes
        torch.cuda.synchronize()
        with client8.get_collection("pq8").index_read() as index8:
            pass
        if not index8._pq_active or index8._pq_bits_active != 8:
            raise AssertionError("the 8-bit pq rung did not engage")
        log(f"  8-bit profile on {n8} rows: first search (training "
            f"{tuple(index8._dev_codebooks.shape)} codebooks) {time.perf_counter() - t0:.2f} s")
        name8 = "pq 8-bit (kc 256, look-ups; cosine)"

        def search8(qs, k=K):
            return client8.search_vectors_in_collection("pq8", qs, k)

        build.reset_launch_counts()
        res, moved, _ = drive([(name8, search8)], queries, n_batches, build, card, native)
        if not moved[name8].get("pq_rank") or moved[name8].get("pq_rank_mma"):
            raise AssertionError(f"{name8}: the look-up K5 entry did not serve kc 256")
        launches["pq_rank"] = pq.PQ_RANK.launches
        saved = pq.pq_rank
        pq.pq_rank = pq.pq_rank_plain
        try:
            ref = search8(queries, K + 1)
        finally:
            pq.pq_rank = saved
        got = res[name8]
        bad = ids_match(scores_of(ref), ids_of(ref), scores_of(got), ids_of(got))
        pick = rng.choice(n8, B, replace=False)
        noisy = rows[pick].astype(np.float64) + rng.normal(0.0, 0.01, (B, D))
        self8 = float(np.mean(ids_of(search8(noisy))[:, 0] == pick))
        log(f"  {name8} vs the plain-rank pipeline: id mismatches beyond ties {bad}; "
            f"self-hit {self8:.5f}")
        if bad or self8 < 0.99:
            raise AssertionError(f"{name8} disagrees with the plain-rank pipeline or "
                                 f"misses its own rows")
        client8.delete_collection("pq8")
    finally:
        os.environ.pop("VECTORLITE_PQ_BITS", None)
    return launches


IVF_CLUSTERS = 2048
IVF_TAIL = 4096
IVF_DELETES = 1000


def clustered_mixture(d: int, n_clusters: int, seed: int):
    """bench/probe_scale8m.py:50 make_clustered's mixture: unit centres,
    eigen-decaying noise 0.2 / sqrt(1 + i). Returns (rng, centres, noise
    scale); clustered_rows draws rows from it."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((n_clusters, d), dtype=np.float32)
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    scale = 0.2 / np.sqrt(1.0 + np.arange(d, dtype=np.float32))
    return rng, centers, scale


def clustered_rows(rng, centers, scale, n: int) -> np.ndarray:
    """n unit-norm f32 rows of the mixture, drawn as make_clustered draws
    them (a cluster id, its centre plus the scaled noise, normalised)."""
    d = centers.shape[1]
    out = np.empty((n, d), dtype=np.float32)
    step = 1 << 20
    for lo in range(0, n, step):
        m = min(step, n - lo)
        cid = rng.integers(0, len(centers), m)
        rows = centers[cid] + rng.standard_normal((m, d), dtype=np.float32) * scale[None, :]
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        out[lo : lo + m] = rows
    return out


def device_breakdown(label, fn, queries, reps: int = 5, top: int = 10) -> None:
    """torch.profiler over ``reps`` calls of fn(queries): the device time a
    batch by kernel, the top ``top`` printed, and the kernels' busy share
    of the wall time of the same calls without the profiler (the rest is
    the device's idle share). A first, discarded profiled run warms the
    profiler up."""
    from torch.profiler import ProfilerActivity, profile

    fn(queries)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(queries)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / reps
    for _ in range(2):
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn(queries)
            torch.cuda.synchronize()
        wall_on = (time.perf_counter() - t0) * 1e3 / reps
    # kernel rows only: the operator rows and the spans' device-side ranges
    # (vectorlite.* from observability.profile_span) repeat their kernels' time
    rows = [(getattr(e, "self_device_time_total", 0.0) / 1e3 / reps, e.count // reps, e.key)
            for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("vectorlite.")]
    rows = sorted((r for r in rows if r[0] > 0), reverse=True)
    busy = sum(r[0] for r in rows)
    if not rows:
        log(f"  {label}: the profiler recorded no device time (not measured)")
        return
    log(f"  {label}: kernels {busy:.3f} ms a batch, {100 * busy / wall:.1f}% of the "
        f"{wall:.3f} ms wall a batch without the profiler (device idle "
        f"{100 - 100 * busy / wall:.1f}%; {wall_on:.3f} ms with it); by kernel, "
        f"ms a batch:")
    for ms, calls, name in rows[:top]:
        log(f"    {ms:8.4f}  x{calls:<3d} {name[:90]}")


def in_batches(fn, queries, batch: int):
    """fn over ``queries`` in batches of ``batch``; the rows concatenated."""
    out = []
    for lo in range(0, len(queries), batch):
        out += fn(queries[lo : lo + batch])
    return out


def ivf_path(vl, build, ivf, native, dev, args, card: str) -> int:
    """Phase 5: the IVF rung through the SDK; returns K6's launches on the
    IVF paths of the default profile."""
    SM = vl.SimilarityMetric
    started = time.perf_counter()
    rng, centers, scale = clustered_mixture(D, IVF_CLUSTERS, args.seed)
    rows = clustered_rows(rng, centers, scale, args.ivf_rows)
    queries = clustered_rows(rng, centers, scale, B).astype(np.float64)
    log(f"  data {args.ivf_rows} x {D} ({IVF_CLUSTERS} clusters) made in "
        f"{time.perf_counter() - started:.2f} s")
    client = vl.VectorLiteClient(vl.MockEmbeddingFunction(D), device=dev)
    client.create_collection("ivf", vl.IndexType.FLAT)
    t0 = time.perf_counter()
    client.add_vectors_to_collection("ivf", rows)
    log(f"  add_vectors: {time.perf_counter() - t0:.2f} s")
    coll = client.get_collection("ivf")
    with coll.index_read() as index:
        pass
    spent = {"device": [], "rescore": [], "ivf_build": []}
    index._ivf_build = timed(spent, "ivf_build", index._ivf_build, True)
    t0 = time.perf_counter()
    client.search_vectors_in_collection("ivf", queries[:IVF_B], K)  # builds
    torch.cuda.synchronize()
    first = time.perf_counter() - t0
    if not index._ivf_active:
        raise AssertionError("IVF did not activate on the clustered corpus")
    c, p_width, floor = int(index._ivf_cent_sq.shape[0]), index._ivf_p, index._ivf_nprobe_floor
    nprobe = int(np.clip(max(ivf.NPROBE, floor), 1, c))
    batch = IVF_B
    while batch > 1 and batch * nprobe * p_width > index._count // 2:
        batch //= 2
    log(f"  first search {first:.2f} s (device build, then the IVF build "
        f"{spent['ivf_build'][0] / 1e3:.2f} s: training, top-2 assignment, layout, "
        f"guards, upload): C {c}, P {p_width}, nprobe floor {floor} (serving nprobe "
        f"{nprobe}), extras {len(index._ivf_extra_slots_np)}, layout "
        f"{index._ivf_rows.dtype}, precision guard risky {index._precision_risky}; "
        f"batch {batch}")
    qb = queries[:batch]
    index._device_topk = timed(spent, "device", index._device_topk, True)

    def search(metric, k=K):
        return lambda qs: client.search_vectors_in_collection("ivf", qs, k, metric)

    def exact(qs):
        with coll.index_read() as idx:
            return idx.search_batch(qs, K, SM.COSINE, approx=False)

    def run_path(name, fn, qs, must, must_not):
        """One path, counts zeroed just before and read just after."""
        spent["device"].clear()
        build.reset_launch_counts()
        res, _, ms = drive([(name, fn)], qs, args.batches, build, card)
        counts = {kk.symbol: kk.launches for kk in build.KERNELS}
        dev_p50 = float(np.percentile(spent["device"], 50))
        log(f"    device stage p50 {dev_p50:.3f} ms ({len(spent['device'])} calls), "
            f"host (batch p50 - device p50) {np.percentile(ms[name], 50) - dev_p50:.3f} ms; "
            f"launches {dict((s, n) for s, n in counts.items() if n)}")
        for sym in must:
            if not counts[sym]:
                raise AssertionError(f"{name}: {sym} did not launch")
        for sym in must_not:
            if counts[sym]:
                raise AssertionError(f"{name}: {sym} launched")
        return res[name], counts

    ivf_paths = [("ivf cosine (default call)", SM.COSINE),
                 ("ivf euclidean", SM.EUCLIDEAN),
                 ("ivf dot", SM.DOT_PRODUCT)]
    results, k6 = {}, 0
    for name, metric in ivf_paths:
        results[name], counts = run_path(
            name, search(metric), qb, ["gather_score"], [*K1_SYMBOLS, *K3_SYMBOLS])
        k6 += counts["gather_score"]
    run_path("exact approx=False (K1, brute)", exact, qb, [K1_TF32],
             ["gather_score", K1_SELECT])
    # what the default call runs on this collection without the layout:
    # the speed path (K3), or K1 where the precision guard refuses it.
    # The layout stays built (VECTORLITE_IVF=0 would drop it)
    aside = "default call with IVF set aside (brute)"
    index._ivf_active = False
    try:
        run_path(aside, search(SM.COSINE), qb,
                 [K1_TF32 if index._precision_risky else K3_INT8],
                 ["gather_score"])
        device_breakdown(aside, search(SM.COSINE), qb)
    finally:
        index._ivf_active = True
    device_breakdown("ivf cosine (default call)", search(SM.COSINE), qb)
    device_breakdown("exact approx=False (K1, brute)", exact, qb)

    # agreement: recall against K1 on 256 queries; ids against the same
    # pipeline with the plain probe
    exact_ids = ids_of(in_batches(exact, queries, batch))
    cos_ids = ids_of(in_batches(search(SM.COSINE), queries, batch))
    r = recall(cos_ids, exact_ids)
    log(f"  recall@10 ivf cosine vs exact K1 ({B} queries): {r:.5f}")
    if r < 0.99:
        raise AssertionError(f"ivf recall@10 {r} < 0.99")
    for name, metric in ivf_paths:
        saved = ivf.gather_score_pallas
        ivf.gather_score_pallas = ivf.gather_score_plain
        try:
            ref = search(metric, K + 1)(qb)
        finally:
            ivf.gather_score_pallas = saved
        got = results[name]
        bad = ids_match(scores_of(ref), ids_of(ref), scores_of(got), ids_of(got))
        log(f"  {name} vs the plain-probe pipeline: id mismatches beyond ties {bad}")
        if bad:
            raise AssertionError(f"{name} disagrees with the plain-probe pipeline")

    # a batch of 256 probes more than half the corpus: the brute engines
    build.reset_launch_counts()
    big = ids_of(search(SM.COSINE)(queries))
    counts = {kk.symbol: kk.launches for kk in build.KERNELS}
    if counts["gather_score"]:
        raise AssertionError("a batch of 256 launched K6")
    if index._precision_risky:
        ok = counts[K1_TF32] and np.array_equal(big, exact_ids)
    else:
        ok = counts[K3_INT8] and recall(big, exact_ids) >= 0.99
    log(f"  batch of {B}: fell through, launches "
        f"{dict((s, n) for s, n in counts.items() if n)}, ids "
        f"{'equal to K1' if index._precision_risky else 'recall vs K1'} {bool(ok)}")
    if not ok:
        raise AssertionError("the batch of 256 did not fall through to the brute engine")

    # the tail: appended rows are found at once, the layout stays
    hi = index._ivf_hi
    tail = clustered_rows(rng, centers, scale, IVF_TAIL)
    tail_ids = np.asarray(client.add_vectors_to_collection("ivf", tail))
    noisy = tail.astype(np.float64) + rng.normal(0.0, 0.01, tail.shape)
    build.reset_launch_counts()
    top1 = ids_of(in_batches(search(SM.COSINE, 1), noisy, batch))[:, 0]
    found = float(np.mean(top1 == tail_ids))
    log(f"  tail: {IVF_TAIL} rows appended, layout watermark {hi} -> {index._ivf_hi}, "
        f"self-hit {found:.5f}, K6 launches {ivf.GATHER_SCORE.launches}")
    if index._ivf_hi != hi or found < 1.0 or not ivf.GATHER_SCORE.launches:
        raise AssertionError("tail rows were not served from the tail")

    # deletes: the 1,000 rows nearest the queries never come back
    gone = list(dict.fromkeys(exact_ids.ravel().tolist()))[:IVF_DELETES]
    for vid in gone:
        client.delete_from_collection("ivf", int(vid))
    build.reset_launch_counts()
    after = ids_of(in_batches(search(SM.COSINE), queries, batch))
    back = len(set(gone) & set(after.ravel().tolist()))
    log(f"  deletes: {len(gone)} rows deleted, {back} came back; K6 launches "
        f"{ivf.GATHER_SCORE.launches}")
    if back or not ivf.GATHER_SCORE.launches:
        raise AssertionError("deleted rows came back")
    client.delete_collection("ivf")
    del index, coll, client
    gc.collect()
    torch.cuda.empty_cache()

    # the quantized profile: an int8 layout and the host f64 re-score
    qclient = vl.VectorLiteClient(
        vl.MockEmbeddingFunction(D),
        config=vl.VectorLiteConfig.profile("quantized"), device=dev,
    )
    qclient.create_collection("ivf", vl.IndexType.FLAT)
    qclient.add_vectors_to_collection("ivf", rows)
    del rows
    coll = qclient.get_collection("ivf")
    with coll.index_read() as index:
        pass
    t0 = time.perf_counter()
    qclient.search_vectors_in_collection("ivf", qb, K)  # builds
    torch.cuda.synchronize()
    log(f"  quantized: first search {time.perf_counter() - t0:.2f} s; IVF active "
        f"{index._ivf_active}, layout {index._ivf_rows.dtype if index._ivf_active else None}")
    if not index._ivf_active or index._ivf_rows.dtype != torch.int8:
        raise AssertionError("the quantized collection did not build an int8 layout")
    index._device_topk = timed(spent, "device", index._device_topk, True)
    index._exact_rescore = timed(spent, "rescore", index._exact_rescore, False)
    calls = native.calls
    spent["rescore"].clear()

    def qsearch(qs):
        return qclient.search_vectors_in_collection("ivf", qs, K)

    def qexact(qs):
        with coll.index_read() as idx:
            return idx.search_batch(qs, K, SM.COSINE, approx=False)

    run_path("ivf quantized cosine (int8 layout + f64 re-score)", qsearch, qb,
             ["gather_score"], [*K2_SYMBOLS, *K3_SYMBOLS])
    log(f"    host re-score p50 {np.percentile(spent['rescore'], 50):.3f} ms "
        f"({len(spent['rescore'])} calls); native re-scores {native.calls - calls}")
    if native.calls == calls:
        raise AssertionError("the native f64 re-score never served the quantized IVF path")
    run_path("quantized exact approx=False (K2)", qexact, qb,
             [K2_S8], ["gather_score", K2_SELECT])
    r = recall(ids_of(in_batches(qsearch, queries, batch)),
               ids_of(in_batches(qexact, queries, batch)))
    log(f"  recall@10 quantized ivf vs its exact K2 ({B} queries): {r:.5f}")
    if r < 0.99:
        raise AssertionError(f"quantized ivf recall@10 {r} < 0.99")
    qclient.delete_collection("ivf")
    log(f"  phase 5: {time.perf_counter() - started:.1f} s; host peak RSS "
        f"{peak_rss_gb():.2f} GB")
    return k6


HEADLINE_K = 16  # bench/probe_headline_r5.py: k 16, k_sel 128, cosine
HEADLINE_CONFIGS = (("merge_w2_t16k", 2, 16384), ("merge_w3_t16k", 3, 16384),
                    ("merge_w2_t32k", 2, 32768))


def event_ms(fn, reps: int) -> np.ndarray:
    """Each of ``reps`` calls of fn timed with CUDA events, after a warm call."""
    fn()
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end))
    return np.asarray(out)


def headline_path(merge, decompose, scan, build, SM, dev, args, card) -> dict:
    """Phase 6: bench/probe_headline_r5.py's merge-engine probe in torch:
    the tournament merge (K7) + exact f32 re-score over a bf16 copy of
    N(0, 1) rows, beside the K3 engine and exact K1; recall@10 against
    float64 truth; the merge engine's ids against the same pipeline with
    the plain K7; a tombstoned pass; then K8's decomposition beside K3.
    Counts zeroed just before, read just after; returns them."""
    started = time.perf_counter()
    n = args.rows
    rng = np.random.default_rng([args.seed, 7])
    rows = rng.standard_normal((n, D), dtype=np.float32)
    queries = rng.standard_normal((B, D), dtype=np.float32)
    values = torch.from_numpy(rows).to(dev)
    scan_bf16 = values.to(torch.bfloat16)
    sq = (values * values).sum(-1)
    valid = torch.ones(n, dtype=torch.bool, device=dev)
    q = torch.from_numpy(queries).to(dev)
    live_hi = torch.tensor(n, device=dev)
    truth = truth_topk(rows, queries.astype(np.float64), "cosine", dev)[1][:, :10]
    del rows
    log(f"  data {n} x {D} (bf16 copy on the card) and f64 truth in "
        f"{time.perf_counter() - started:.2f} s")

    def merge_engine(winners, tile_n, k=HEADLINE_K, ok=valid, tombstones=False):
        return lambda: merge.pallas_search_merge_topk_rescored(
            scan_bf16, values, sq, ok, q, metric=SM.COSINE, k=k, k_sel=128,
            tile_n=tile_n, winners=winners, tombstones=tombstones,
            live_hi=None if tombstones else live_hi)

    engines = [(name, merge_engine(w, t)) for name, w, t in HEADLINE_CONFIGS]
    engines += [
        ("k3_w2_t4k (K3 + re-score)", lambda: scan.pallas_search_block_topk_rescored(
            scan_bf16, values, sq, valid, q, metric=SM.COSINE, k=HEADLINE_K,
            k_sel=128, tile_n=4096, winners=2)),
        ("k3_f32_w2_t4k (K3 + re-score)", lambda: scan.pallas_search_block_topk_rescored(
            values, values, sq, valid, q, metric=SM.COSINE, k=HEADLINE_K,
            k_sel=128, tile_n=4096, winners=2)),
        ("k3_f32_w4_t4k (K3 + re-score)", lambda: scan.pallas_search_block_topk_rescored(
            values, values, sq, valid, q, metric=SM.COSINE, k=HEADLINE_K,
            k_sel=128, tile_n=4096, winners=4)),
        ("exact (K1)", lambda: scan.pallas_search_topk(
            values, sq, valid, q, metric=SM.COSINE, k=HEADLINE_K, tile_n=2048)),
    ]
    build.reset_launch_counts()
    out = {}
    for name, fn in engines:
        before = {kk.symbol: kk.launches for kk in build.KERNELS}
        s, i = fn()
        ms = event_ms(fn, 10)
        r = recall(i[:, :10].cpu().numpy(), truth)
        moved = {kk.symbol: kk.launches - before[kk.symbol]
                 for kk in build.KERNELS if kk.launches != before[kk.symbol]}
        out[name] = (s, i)
        want = {"k3_f32_w2_t4k (K3 + re-score)": K3_TF32,
                "k3_f32_w4_t4k (K3 + re-score)": K3_CORE}.get(name)
        if want is not None and set(moved) & set(K3_SYMBOLS) != {want}:
            raise AssertionError(f"{name}: launched {moved}, not {want}")
        log(f"  {name:28s} p50 {np.percentile(ms, 50):.4f} ms  QPS "
            f"{B / np.percentile(ms, 50) * 1e3:.1f}  recall@10 vs f64 truth "
            f"{r:.5f}  (launches {moved}) [{card}]")
        if r < 0.99:
            raise AssertionError(f"{name}: recall@10 {r} < 0.99")

    # the same pipeline with the plain K7
    saved = merge.merge_topw_cuda
    merge.merge_topw_cuda = lambda tile_n, **kw: merge.merge_topw_plain(**kw)
    try:
        refs = {name: merge_engine(w, t, HEADLINE_K + 1)() for name, w, t in HEADLINE_CONFIGS}
    finally:
        merge.merge_topw_cuda = saved
    for name, ref in refs.items():
        ks, ki = (t.cpu().numpy() for t in out[name])
        bad = ids_match(*(t.cpu().numpy() for t in ref), ks, ki)
        log(f"  {name} vs the plain-K7 pipeline: id mismatches beyond ties {bad}")
        if bad:
            raise AssertionError(f"{name} disagrees with the plain-K7 pipeline")
    del refs

    dead = torch.from_numpy(rng.random(n) < 0.05).to(dev)
    _, i = merge_engine(2, 16384, ok=~dead, tombstones=True)()
    back = int(dead[i.long()].sum())
    log(f"  tombstoned pass ({int(dead.sum())} rows invalid): {back} came back")
    if back:
        raise AssertionError("the merge engine returned a tombstoned row")

    # K8's decomposition of the scan at the same shape, beside K3 (over the
    # same bf16 rows: the tensor-core body's K3 form)
    k3_ms = cuda_time_ms(lambda: scan.block_topw_cuda(
        scan_bf16, None, sq, valid, q, metric=SM.COSINE, tile_n=4096, winners=2), 10)
    for tile_n in (8192, 16384):
        t = {(mode, w): cuda_time_ms(lambda mode=mode, w=w: decompose.fold_probe(
            scan_bf16, q, mode=mode, tile_n=tile_n, winners=w), 10)
            for mode, w in (("none", 2), ("maxonly", 2), ("full", 2), ("full", 1))}
        none = t[("none", 2)]
        log(f"  decomposition of the tensor-core body, tile {tile_n}: contraction "
            f"(none) {none:.4f} ms, maxonly {t[('maxonly', 2)]:.4f} "
            f"(+{t[('maxonly', 2)] - none:.4f}), full {t[('full', 2)]:.4f} "
            f"(+{t[('full', 2)] - none:.4f}), full at W 1 {t[('full', 1)]:.4f} "
            f"(+{t[('full', 1)] - none:.4f}); K3 (the same body's K3 form: cosine, "
            f"tile 4096, W 2) {k3_ms:.4f} [{card}]")
    launches = {kk.symbol: kk.launches for kk in build.KERNELS}
    for sym in ("scan_merge_topw", "scan_fold_probe", K3_BF16, K3_TF32, K3_CORE):
        if not launches[sym]:
            raise AssertionError(f"{sym} did not launch in phase 6")
    log(f"  phase 6: {time.perf_counter() - started:.1f} s; launches "
        f"{dict((s, c) for s, c in launches.items() if c)}")
    return launches


P7_THREADS = 64  # concurrent SDK callers in phase 7 (a)
P7_REQUESTS = 1024  # single-text searches a serving run
P7_PROBE_ROWS = 1 << 16  # the sizing runs of (c) and (d)
P7_CUT_ROWS = 1 << 17  # (c) and (d) when the projection passes the budget
P7_BUDGET_S = 60.0
P7_DURABLE_ROWS = 10_000
P7_WORDS = ("amber", "birch", "cobalt", "delta", "ember", "fjord", "granite", "harbor",
            "indigo", "juniper", "kelp", "lumen", "marble", "nectar", "onyx", "pepper",
            "quartz")
P7_TAGS = ("news", "docs", "code", "chat", "mail")


def p7_texts(n: int) -> list:
    return [f"record {i} {P7_WORDS[i % 17]} {P7_WORDS[(i // 17) % 17]}" for i in range(n)]


def p7_metas(n: int) -> list:
    return [{"bucket": i % 16, "tag": P7_TAGS[i % 5]} for i in range(n)]


def p7_collection(vl, dev, name, rows, texts, metas, profile=None):
    """A client holding one collection of ``rows`` with texts and metadata;
    returns (client, seconds the add took)."""
    config = vl.VectorLiteConfig.profile(profile) if profile else None
    client = vl.VectorLiteClient(vl.MockEmbeddingFunction(D), config=config, device=dev)
    client.create_collection(name, vl.IndexType.FLAT)
    t0 = time.perf_counter()
    client.add_vectors_to_collection(name, rows, texts, metas)
    return client, time.perf_counter() - t0


def launch_counts(build) -> dict:
    return {kk.symbol: kk.launches for kk in build.KERNELS if kk.launches}


def hold_against_direct(label, got, index, q64, metric) -> None:
    """Rows of SearchResults against a direct search_batch of the same
    queries (k + 1 columns, batches of B): ids equal except among scores
    within 1e-5 of each other, scores within rtol/atol 1e-5."""
    want = []
    for lo in range(0, len(q64), B):
        want += index.search_batch(q64[lo:lo + B], K + 1, metric)
    ps, pi = scores_of(want), ids_of(want)
    ks, ki = scores_of(got), ids_of(got)
    bad = ids_match(ps, pi, ks, ki)
    err = float(np.max(np.abs(ks - ps[:, :K])))
    log(f"    {label}: vs direct search_batch ({len(q64)} queries): id mismatches beyond "
        f"ties {bad}, max score diff {err:.3g}")
    if bad or not np.allclose(ks, ps[:, :K], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label} disagrees with the direct path")


def serve(client, name, q_texts, build, coalesce_stats, label, card) -> tuple:
    """P7_THREADS threads issue single search_text_in_collection calls, k
    K, over q_texts; returns (rows in q_texts order, launches, figures).
    Counts are zeroed just before and read just after."""
    n = len(q_texts)
    out, lat = [None] * n, np.zeros(n)

    def worker(w):
        for i in range(w, n, P7_THREADS):
            t0 = time.perf_counter()
            out[i] = client.search_text_in_collection(name, q_texts[i], K)
            lat[i] = time.perf_counter() - t0

    from concurrent.futures import ThreadPoolExecutor

    before = coalesce_stats.snapshot()
    build.reset_launch_counts()
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=P7_THREADS) as pool:
        for f in [pool.submit(worker, w) for w in range(P7_THREADS)]:
            f.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    moved = launch_counts(build)
    after = coalesce_stats.snapshot()
    hist = {key: after.get("hist", {}).get(key, 0) - before.get("hist", {}).get(key, 0)
            for key in after.get("hist", {})}
    batches = after.get("batches", 0) - before.get("batches", 0)
    figures = {"rps": n / wall, "p50_ms": np.percentile(lat, 50) * 1e3,
               "p99_ms": np.percentile(lat, 99) * 1e3}
    log(f"    {label}: {figures['rps']:.1f} requests/s, per request p50 "
        f"{figures['p50_ms']:.3f} ms p99 {figures['p99_ms']:.3f} ms "
        f"({n} requests, {P7_THREADS} threads, {wall:.2f} s); dispatches {batches}, "
        f"batch-size histogram {dict((k, v) for k, v in hist.items() if v)}; launches "
        f"{moved} [{card}]")
    return out, moved, figures


def collection_path(vl, build, dev, rows, card: str, seed: int) -> tuple:
    """Phase 7: the collection surface and persistence through the SDK on
    phase 3's rows; returns the launches of its counted runs, the client
    of (a)'s guard-on collection ("main", kept for phase 8) and (a)'s
    coalesced figures by guard."""
    import shutil
    import tempfile

    from vectorlite_tpu_torch.native import VLC
    from vectorlite_tpu_torch.observability import coalesce_stats
    from vectorlite_tpu_torch.persist.vlc import load_collection_from_file
    from vectorlite_tpu_torch.store.autosave import AutosaveDaemon, restore_into
    from vectorlite_tpu_torch.store.wal import WalManager, recover_into
    from vectorlite_tpu_torch.text.bm25 import BM25Index

    SM = vl.SimilarityMetric
    started = time.perf_counter()
    n = len(rows)
    rng = np.random.default_rng([seed, 11])
    texts, metas = p7_texts(n), p7_metas(n)
    emb = vl.MockEmbeddingFunction(D)
    q_texts = [f"request {i}" for i in range(P7_REQUESTS)]
    q64 = emb.embed_batch_arrays(q_texts)
    total = {}

    def count(moved):
        for sym, c in moved.items():
            total[sym] = total.get(sym, 0) + c

    # (a) coalesced serving, guard on, then with VECTORLITE_SPEED_GUARD=0
    log(f"  (a) coalesced serving: {P7_THREADS} threads, {P7_REQUESTS} single-text "
        f"searches, k {K}")
    clients = {}
    for guard in ("1", "0"):
        os.environ["VECTORLITE_SPEED_GUARD"] = guard
        client, add_s = p7_collection(vl, dev, "main", rows, texts, metas)
        t0 = time.perf_counter()
        client.search_vectors_in_collection("main", q64[:1], K)  # device build
        torch.cuda.synchronize()
        log(f"    guard {guard}: add_vectors with texts and metadata {add_s:.2f} s, "
            f"device build {time.perf_counter() - t0:.2f} s")
        clients[guard] = client
    os.environ["VECTORLITE_SPEED_GUARD"] = "0"
    sdk = {}
    for mode in ("coalesced", "VECTORLITE_COALESCE=0"):
        if mode != "coalesced":
            os.environ["VECTORLITE_COALESCE"] = "0"
        try:
            for guard, client in clients.items():
                label = f"{mode}, guard {'on' if guard == '1' else 'off'}"
                got, moved, figures = serve(client, "main", q_texts, build, coalesce_stats,
                                            label, card)
                if mode == "coalesced":
                    sdk[guard] = figures
                count(moved)
                want = K3_INT8 if guard == "0" else None
                if want and not moved.get(want):
                    raise AssertionError(f"{label}: {want} never launched ({moved})")
                if not set(moved) & {K1_TF32, K3_INT8}:
                    raise AssertionError(f"{label}: neither K1 nor K3 launched ({moved})")
                with client.get_collection("main").index_read() as index:
                    hold_against_direct(label, got, index, q64, SM.COSINE)
        finally:
            os.environ.pop("VECTORLITE_COALESCE", None)
    kept = clients.pop("1")
    client = clients.pop("0")
    coll = client.get_collection("main")

    # (b) bulk mutations, then a filtered batch held against f64 numpy
    log("  (b) bulk mutations")
    ids = np.arange(n)
    alive = np.ones(n, bool)

    def step(label, fn):
        t0 = time.perf_counter()
        out = fn()
        log(f"    {label}: {(time.perf_counter() - t0) * 1e3:.1f} ms [{card}]")
        return out

    removed = step("delete_where bucket 5",
                   lambda: client.delete_where_in_collection("main", {"bucket": 5}))
    alive[ids % 16 == 5] = False
    if removed != n // 16:
        raise AssertionError(f"delete_where removed {removed}, not {n // 16}")
    step("compact", lambda: client.compact_collection("main"))
    step("first search after the compaction (the device copy rebuilt)",
         lambda: client.search_vectors_in_collection("main", q64[:1], K))
    page, total_live = step("list_vectors offset 1000 limit 100",
                            lambda: client.list_vectors_in_collection("main", 1000, 100))
    if [v.id for v in page] != list(ids[alive][1000:1100]) or total_live != alive.sum():
        raise AssertionError("list_vectors page differs from the surviving ids")
    page, total_b3 = step("list_vectors where bucket 3, offset 500 limit 100",
                          lambda: client.list_vectors_in_collection(
                              "main", 500, 100, {"bucket": 3}))
    if [v.id for v in page] != list(ids[ids % 16 == 3][500:600]) or total_b3 != n // 16:
        raise AssertionError("list_vectors where page differs")
    moved_ids = [int(i) for i in ids[ids % 16 == 7][:1000]]

    def update_all():
        for vid in moved_ids:
            client.update_metadata_in_collection("main", vid, {"bucket": 3, "tag": "moved"})
    step("update_metadata x 1000", update_all)
    pick = [int(i) for i in rng.choice(n, 1000, replace=False)]
    got = step("get_vectors x 1000", lambda: client.get_vectors_from_collection("main", pick))
    if [v.id for v in got] != [i for i in pick if alive[i]]:
        raise AssertionError("get_vectors returned other ids")
    for v in got[:50]:
        if not np.array_equal(np.asarray(v.values), rows[v.id].astype(np.float64)):
            raise AssertionError(f"get_vectors values of {v.id} differ")
    step("update_text", lambda: client.update_text_in_collection(
        "main", 12, "rewritten record amber", {"bucket": 3, "tag": "rewritten"}))
    where = {"bucket": 3}
    build.reset_launch_counts()
    filt = step(f"filtered batch of {B} (K1 with the mask; the mask built anew after "
                "the metadata updates)",
                lambda: client.search_vectors_in_collection("main", q64[:B], K, where=where))
    moved = launch_counts(build)
    count(moved)
    if not moved.get(K1_TF32):
        raise AssertionError(f"the filtered batch did not launch {K1_TF32} ({moved})")
    sel = ids[(ids % 16 == 3) & (ids != 12)]
    truth_ids = np.concatenate([sel, moved_ids, [12]])
    mat = np.concatenate([rows[sel], rows[moved_ids]]).astype(np.float64)
    mat = np.concatenate([mat, np.asarray([emb.generate_embedding("rewritten record amber")])])
    q = q64[:B]
    s = (q @ mat.T) / (np.linalg.norm(q, axis=1)[:, None] * np.linalg.norm(mat, axis=1)[None])
    order = np.argsort(-s, axis=1, kind="stable")[:, :K + 1]
    ps, pi = np.take_along_axis(s, order, 1), truth_ids[order]
    bad = ids_match(ps, pi, scores_of(filt), ids_of(filt))
    err = float(np.max(np.abs(scores_of(filt) - ps[:, :K])))
    log(f"    filtered batch vs f64 numpy over the {len(truth_ids)} matching rows: "
        f"id mismatches beyond ties {bad}, max score err {err:.3g} (launches {moved}) [{card}]")
    if bad or err > 1e-5:
        raise AssertionError("the filtered batch disagrees with float64 truth")

    # (c) hybrid search; the sidecar's build projected from 2^16 texts
    t0 = time.perf_counter()
    probe = BM25Index()
    for i, text in enumerate(texts[:P7_PROBE_ROWS]):
        probe.add(i, text)
    projected = (time.perf_counter() - t0) * n / P7_PROBE_ROWS
    del probe
    h_client, h_name = client, "main"
    if projected > P7_BUDGET_S:
        m = P7_CUT_ROWS
        h_client, _ = p7_collection(vl, dev, "hybrid", rows[:m], texts[:m], metas[:m])
        h_name = "hybrid"
    h_rows = h_client.get_collection_info(h_name).count
    log(f"  (c) hybrid search on {h_rows} rows (sidecar build projected from "
        f"{P7_PROBE_ROWS} texts: {projected:.1f} s at {n} rows; cut to {P7_CUT_ROWS} rows "
        f"past {P7_BUDGET_S:.0f} s)")
    h_texts = [f"{P7_WORDS[i % 17]} {P7_WORDS[(i * 5 + 3) % 17]}" for i in range(B)]
    build.reset_launch_counts()
    t0 = time.perf_counter()
    first = h_client.search_hybrid_in_collection(h_name, h_texts[0], K)
    build_s = time.perf_counter() - t0
    lat = []
    hybrid = []
    for text in h_texts:
        t0 = time.perf_counter()
        hybrid.append(h_client.search_hybrid_in_collection(h_name, text, K))
        lat.append(time.perf_counter() - t0)
    moved = launch_counts(build)
    count(moved)
    log(f"    sidecar build (the first call, one search included) {build_s:.2f} s; "
        f"{B} search_hybrid calls p50 {np.percentile(lat, 50) * 1e3:.3f} ms p99 "
        f"{np.percentile(lat, 99) * 1e3:.3f} ms; launches {moved} [{card}]")
    for text, row in zip([h_texts[0], *h_texts], [first, *hybrid]):
        sc = [h.score for h in row]
        if len(row) != K or sc != sorted(sc, reverse=True) or max(sc) > 2 / 61:
            raise AssertionError(f"hybrid results for {text!r} are malformed: {sc}")
    lexical = h_client.search_hybrid_in_collection(h_name, h_texts[1], K, alpha=0.0)
    words = set(h_texts[1].split())
    if not lexical or any(not words & set(h.text.split()) for h in lexical):
        raise AssertionError("a BM25-only hybrid hit holds none of the query's words")
    if h_client is not client:
        h_client.delete_collection(h_name)

    # (d) save and load through the native codec; sized from a 2^16-row save
    tmp = tempfile.mkdtemp(prefix="vl_phase7_")
    try:
        free = shutil.disk_usage(tmp).free
        p_client, _ = p7_collection(vl, dev, "probe", rows[:P7_PROBE_ROWS],
                                    texts[:P7_PROBE_ROWS], metas[:P7_PROBE_ROWS])
        path = os.path.join(tmp, "probe.vlc")
        t0 = time.perf_counter()
        p_client.get_collection("probe").save_to_file(path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        load_collection_from_file(path, **p_client.flat_index_kwargs())
        t_load = time.perf_counter() - t0
        p_size = os.path.getsize(path)
        os.remove(path)
        p_client.delete_collection("probe")
        scale = coll.get_info().count / P7_PROBE_ROWS
        proj_bytes, proj_s = p_size * scale, (t_save + t_load) * scale
        s_client, s_name = client, "main"
        if proj_bytes > 0.8 * free or proj_s > P7_BUDGET_S:
            m = P7_CUT_ROWS
            s_client, _ = p7_collection(vl, dev, "saved", rows[:m], texts[:m], metas[:m])
            s_name = "saved"
        else:
            client.compact_collection("main")  # the loaded file has no tombstones
        s_coll = s_client.get_collection(s_name)
        log(f"  (d) save and load of {s_coll.get_info().count} rows; free disk {free / 1e9:.1f} "
            f"GB; a {P7_PROBE_ROWS}-row save {p_size / 1e6:.1f} MB in {t_save:.2f} s, load "
            f"{t_load:.2f} s, projected {proj_bytes / 1e9:.2f} GB and {proj_s:.1f} s at "
            f"{coll.get_info().count} rows (cut to {P7_CUT_ROWS} rows past 80% of the free "
            f"disk or {P7_BUDGET_S:.0f} s)")
        q = q64[:B]
        before = [s_client.search_vectors_in_collection(s_name, q, K),
                  s_client.search_vectors_in_collection(s_name, q, K, where={"tag": "docs"})]
        path = os.path.join(tmp, "saved.vlc")
        calls = VLC.calls
        t0 = time.perf_counter()
        s_coll.save_to_file(path)
        save_s = time.perf_counter() - t0
        if VLC.calls == calls:
            raise AssertionError("the native .vlc emitter did not serve the save")
        size = os.path.getsize(path)
        fresh = vl.VectorLiteClient(emb, device=dev)
        t0 = time.perf_counter()
        fresh.add_collection(vl.Collection.load_from_file(path, **fresh.flat_index_kwargs()))
        load_s = time.perf_counter() - t0
        build.reset_launch_counts()
        t0 = time.perf_counter()
        after = [fresh.search_vectors_in_collection(s_name, q, K)]
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        after.append(fresh.search_vectors_in_collection(s_name, q, K, where={"tag": "docs"}))
        moved = launch_counts(build)
        count(moved)
        log(f"    save {save_s:.2f} s ({size / 1e9:.3f} GB, {VLC.calls - calls} native emitter "
            f"calls); load {load_s:.2f} s; first search after the load (the upload "
            f"included) {first_s:.2f} s; launches {moved} [{card}]")
        for label, x, y in zip(("default call", "where tag docs"), before, after):
            if [[(h.id, h.score) for h in r] for r in x] != [[(h.id, h.score) for h in r]
                                                             for r in y]:
                raise AssertionError(f"{label}: results after the load are not bit-identical")
        with s_coll.index_read() as a, fresh.get_collection(s_name).index_read() as b:
            ja, jb = a.index_to_json()["data"], b.index_to_json()["data"]
            same = (np.array_equal(ja.ids, jb.ids) and ja.texts == jb.texts
                    and ja.metas == jb.metas
                    and np.array_equal(ja.values[ja.slots], jb.values[jb.slots]))
        if not same:
            raise AssertionError("the loaded collection's rows differ from the saved ones")
        log(f"    {B} queries (default call and where) bit-identical after the load; the f64 "
            f"truth, ids, texts and metadata round-trip exactly")
        fresh.delete_collection(s_name)
        if s_client is not client:
            s_client.delete_collection(s_name)
        os.remove(path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    client.delete_collection("main")
    del coll, client

    # (e) durability: WAL + autosave, a crash without close, restore + replay
    tmp = tempfile.mkdtemp(prefix="vl_phase7_")
    try:
        wal_dir, snap_dir = os.path.join(tmp, "wal"), os.path.join(tmp, "snapshots")
        d_client = vl.VectorLiteClient(emb, device=dev)
        d_client.set_collection_observer(WalManager(wal_dir, snapshot_dir=snap_dir))
        daemon = AutosaveDaemon(d_client, snap_dir, interval_s=3600.0)  # ticks by flush()
        d_client.create_collection("durable", vl.IndexType.FLAT)
        d_rows = rng.standard_normal((P7_DURABLE_ROWS + 2000, D)).astype(np.float32)
        d_texts = p7_texts(len(d_rows))
        d_metas = p7_metas(len(d_rows))
        t0 = time.perf_counter()
        for lo in range(0, P7_DURABLE_ROWS, 1000):
            d_client.add_vectors_to_collection("durable", d_rows[lo:lo + 1000],
                                               d_texts[lo:lo + 1000], d_metas[lo:lo + 1000])
        add_s = time.perf_counter() - t0
        for vid in range(0, 2000, 10):
            d_client.delete_from_collection("durable", vid)
        for vid in range(1, 1000, 10):
            d_client.update_metadata_in_collection("durable", vid, {"bucket": 99})
        t0 = time.perf_counter()
        daemon.flush()
        snap_s = time.perf_counter() - t0
        for lo in range(P7_DURABLE_ROWS, len(d_rows), 1000):
            d_client.add_vectors_to_collection("durable", d_rows[lo:lo + 1000],
                                               d_texts[lo:lo + 1000], d_metas[lo:lo + 1000])
        d_client.delete_where_in_collection("durable", {"bucket": 7})
        for vid in [v for v in range(2001, 2200) if v % 16 != 7][:50]:
            d_client.update_text_in_collection("durable", vid, f"rewritten {vid}", {"v": vid})
        d_client.delete_from_collection("durable", 10_500)
        want = d_client.search_vectors_in_collection("durable", q64[:B], K)
        want_state = d_client.list_vectors_in_collection("durable", 0, 1 << 20, None, True)
        del d_client, daemon  # the crash: no close, no final flush
        fresh = vl.VectorLiteClient(emb, device=dev)
        t0 = time.perf_counter()
        restored = restore_into(fresh, snap_dir, **fresh.flat_index_kwargs())
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replayed = recover_into(fresh, wal_dir)
        replay_s = time.perf_counter() - t0
        got = fresh.search_vectors_in_collection("durable", q64[:B], K)
        got_state = fresh.list_vectors_in_collection("durable", 0, 1 << 20, None, True)
        key = lambda v: v.id  # noqa: E731
        same = [(v.id, v.text, v.metadata, v.values) for v in sorted(want_state[0], key=key)] \
            == [(v.id, v.text, v.metadata, v.values) for v in sorted(got_state[0], key=key)]
        bad = ids_match(scores_of(want), ids_of(want), scores_of(got), ids_of(got))
        err = float(np.max(np.abs(scores_of(got) - scores_of(want))))
        log(f"  (e) durability: {P7_DURABLE_ROWS} rows added in batches of 1000 "
            f"({add_s:.2f} s), deletes and metadata updates, one autosave snapshot "
            f"({snap_s:.2f} s), 2000 more rows, a delete_where, 50 update_text, a delete; "
            f"dropped without close; restore {restored} {restore_s:.2f} s, replay of "
            f"{replayed} ops {replay_s:.3f} s; {got_state[1]} rows, state equal {same}, "
            f"{B} queries: id mismatches beyond ties {bad}, max score diff {err:.3g} [{card}]")
        if not same or got_state[1] != want_state[1] or bad or err > 1e-5:
            raise AssertionError("the restored and replayed collection differs from the live one")
        fresh.delete_collection("durable")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 7: {time.perf_counter() - started:.1f} s; launches {total}; host peak "
        f"RSS {peak_rss_gb():.2f} GB")
    return total, kept, sdk


P8_THREADS = 64  # concurrent HTTP callers in phase 8 (a)
P8_REQUESTS = 1024  # single-text searches a collection in (a)
P8_BATCH_REPS = 5  # timed batch searches a kind in (b)
P8_BULK_ROWS = 1 << 15  # fresh rows added over HTTP in (c)
P8_BULK_BODY = 4096  # rows a request in (c)
P8_SNAPSHOT_ROWS = 1 << 15  # the collection (d) downloads and uploads
P8_TRACE_THREADS = 8  # searching threads while (e) traces
P8_TRACE_S = 2.0
P8_DURABLE_ROWS = 10_000  # rows (f) writes before the kill -9
P8_START_TIMEOUT_S = 300.0


class Http:
    """One keep-alive connection to the phase-8 server."""

    def __init__(self, port: int, headers=None):
        import http.client

        self.conn = http.client.HTTPConnection("127.0.0.1", port, timeout=600)
        self.headers = {"Content-Type": "application/json", **(headers or {})}

    def call(self, method: str, path: str, body=None, want=200):
        """(status, headers, parsed JSON or text); raises unless ``want``."""
        if body is not None and not isinstance(body, (bytes, str)):
            body = json.dumps(body)
        self.conn.request(method, path, body=body, headers=self.headers)
        resp = self.conn.getresponse()
        raw = resp.read()
        ctype = resp.getheader("Content-Type", "")
        data = json.loads(raw) if ctype.startswith("application/json") else raw.decode()
        if want is not None and resp.status != want:
            raise AssertionError(f"{method} {path}: {resp.status} {raw[:300]!r}")
        return resp.status, resp, data

    def close(self):
        self.conn.close()


def results_of(vl, rows) -> list:
    return [[vl.SearchResult(**h) for h in row] for row in rows]


#: the callers of phase 8 (a), a process of their own as a user's clients
#: are (in the server's process they would share its interpreter lock):
#: threads on keep-alive connections; reads {"port", "path", "queries",
#: "k", "threads"} on stdin and prints one JSON line: each request's
#: seconds and results in query order, the errors, and the wall time from
#: the first request to the last answer
HTTP_CALLERS = r"""
import http.client, json, sys, threading, time
job = json.loads(sys.stdin.read())
n, step = len(job["queries"]), job["threads"]
lat, out, errors = [0.0] * n, [None] * n, []
start = threading.Barrier(step + 1)

def worker(w):
    conn = http.client.HTTPConnection("127.0.0.1", job["port"], timeout=600)
    start.wait()
    try:
        for i in range(w, n, step):
            body = json.dumps({"query": job["queries"][i], "k": job["k"]})
            t0 = time.perf_counter()
            conn.request("POST", job["path"], body, {"Content-Type": "application/json"})
            resp = conn.getresponse()
            raw = resp.read()
            lat[i] = time.perf_counter() - t0
            if resp.status != 200:
                errors.append(f"{resp.status} {raw[:200]!r}")
            else:
                out[i] = json.loads(raw)["results"]
    finally:
        conn.close()

threads = [threading.Thread(target=worker, args=(w,)) for w in range(step)]
for t in threads:
    t.start()
start.wait()
t0 = time.perf_counter()
for t in threads:
    t.join()
print(json.dumps({"wall": time.perf_counter() - t0, "lat": lat, "out": out, "errors": errors}))
"""


def http_serve(vl, port, name, q_texts, build, coalesce_stats, label, card) -> tuple:
    """P8_THREADS callers in a process of their own (HTTP_CALLERS), each
    on its own keep-alive connection, send single POST
    /collections/{name}/search/text requests, k K; returns (rows in
    q_texts order, launches, figures). Counts are zeroed just before and
    read just after."""
    n = len(q_texts)
    job = {"port": port, "path": f"/collections/{name}/search/text", "queries": q_texts,
           "k": K, "threads": P8_THREADS}
    before = coalesce_stats.snapshot()
    build.reset_launch_counts()
    done = subprocess.run([sys.executable, "-c", HTTP_CALLERS], input=json.dumps(job),
                          capture_output=True, text=True, timeout=900)
    torch.cuda.synchronize()
    moved = launch_counts(build)
    after = coalesce_stats.snapshot()
    if done.returncode:
        raise AssertionError(f"{label}: the callers failed:\n{done.stderr[-3000:]}")
    got = json.loads(done.stdout.strip().splitlines()[-1])
    if got["errors"]:
        raise AssertionError(f"{label}: {len(got['errors'])} requests failed: {got['errors'][:3]}")
    wall, lat = got["wall"], np.asarray(got["lat"])
    hist = {key: after.get("hist", {}).get(key, 0) - before.get("hist", {}).get(key, 0)
            for key in after.get("hist", {})}
    batches = after.get("batches", 0) - before.get("batches", 0)
    figures = {"rps": n / wall, "p50_ms": np.percentile(lat, 50) * 1e3,
               "p99_ms": np.percentile(lat, 99) * 1e3}
    log(f"    {label}: {figures['rps']:.1f} requests/s, per request p50 "
        f"{figures['p50_ms']:.3f} ms p99 {figures['p99_ms']:.3f} ms ({n} requests, "
        f"{P8_THREADS} connections from another process, {wall:.2f} s); dispatches "
        f"{batches}, batch-size histogram {dict((k, v) for k, v in hist.items() if v)}; "
        f"launches {moved} [{card}]")
    return results_of(vl, got["out"]), moved, figures


def hold_rows(label, got, want) -> None:
    """HTTP rows against the SDK's rows of the same call: ids equal beyond
    1e-5 near-ties (the SDK's k + 1 columns cover a swap at the k-th
    place), scores within rtol/atol 1e-5."""
    k = len(got[0])
    ps, pi = scores_of(want), ids_of(want)
    ks, ki = scores_of(got), ids_of(got)
    bad = ids_match(ps, pi, ks, ki)
    err = float(np.max(np.abs(ks - ps[:, :k])))
    log(f"    {label}: vs the SDK ({len(got)} queries, k {k}): id mismatches beyond ties "
        f"{bad}, max score diff {err:.3g}")
    if bad or not np.allclose(ks, ps[:, :k], rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label}: the HTTP answer disagrees with the SDK's")


def start_cli(args, log_path, env) -> tuple:
    """``python -m vectorlite_tpu_torch.cli`` from the checkout, on the
    card, until GET /health answers; returns (process, seconds)."""
    import urllib.request

    t0 = time.perf_counter()
    logf = open(log_path, "ab")
    proc = subprocess.Popen(
        [sys.executable, "-m", "vectorlite_tpu_torch.cli", "--mock-embeddings", *args],
        cwd=os.path.dirname(os.path.abspath(__file__)), stdout=logf, stderr=subprocess.STDOUT,
        env=env)
    logf.close()
    port = args[args.index("--port") + 1]
    while True:
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/health", timeout=5) as r:
                if r.status == 200:
                    return proc, time.perf_counter() - t0
        except OSError:
            pass
        if proc.poll() is not None or time.perf_counter() - t0 > P8_START_TIMEOUT_S:
            proc.kill()
            proc.wait()
            with open(log_path, "rb") as f:
                tail = f.read()[-4000:].decode("utf-8", "replace")
            raise AssertionError(f"the CLI did not come up (exit {proc.returncode}):\n{tail}")
        time.sleep(0.2)


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def http_path(vl, build, dev, client, rows, card: str, seed: int, sdk: dict) -> dict:
    """Phase 8: the HTTP serving surface on the card. The port's server,
    bound to 127.0.0.1:0 in a thread over ``client`` (phase 7's guard-on
    collection "main", K1) and a guard-off collection "speed" (K3) of
    the same rows, is driven over real HTTP; then the CLI, as a
    subprocess on the card, is killed and restarted. Returns the launches
    of its counted runs."""
    import shutil
    import signal
    import tempfile

    from vectorlite_tpu_torch.api.server import bind, create_app
    from vectorlite_tpu_torch.observability import coalesce_stats
    from vectorlite_tpu_torch.remote import RemoteClient

    SM = vl.SimilarityMetric
    started = time.perf_counter()
    n = len(rows)
    rng = np.random.default_rng([seed, 12])
    emb = vl.MockEmbeddingFunction(D)
    total = {}

    def count(moved):
        for sym, c in moved.items():
            total[sym] = total.get(sym, 0) + c

    t0 = time.perf_counter()
    os.environ["VECTORLITE_SPEED_GUARD"] = "0"
    client.create_collection("speed", vl.IndexType.FLAT)
    client.add_vectors_to_collection("speed", rows, p7_texts(n), p7_metas(n))
    client.search_vectors_in_collection("speed", emb.embed_batch_arrays(["warm"]), K)
    os.environ["VECTORLITE_SPEED_GUARD"] = "1"  # "main" keeps K1 through any rebuild
    torch.cuda.synchronize()
    server = bind(create_app(client), "127.0.0.1", 0).start()
    port = server.port
    log(f"  server on 127.0.0.1:{port} (standard library, one thread a connection) over "
        f"\"main\" (guard on) and \"speed\" (guard off, built in {time.perf_counter() - t0:.2f} "
        f"s), {n} rows each")
    tmp = tempfile.mkdtemp(prefix="vl_phase8_")
    http = Http(port)
    try:
        # (a) single-text searches over HTTP, beside phase 7 (a)'s SDK figures
        log(f"  (a) {P8_THREADS} connections, {P8_REQUESTS} single POST /search/text, k {K}")
        q_texts = [f"http request {i}" for i in range(P8_REQUESTS)]
        q64 = emb.embed_batch_arrays(q_texts)
        # guard on: whichever kernel the guard picked at the build (K1 on a
        # random corpus of 2^20 rows); guard off: K3 over the int8 copy
        for name, guard, want_sym in (("main", "1", None), ("speed", "0", K3_INT8)):
            label = f"HTTP, guard {'on' if guard == '1' else 'off'}"
            got, moved, fig = http_serve(vl, port, name, q_texts, build, coalesce_stats,
                                         label, card)
            count(moved)
            ref = sdk.get(guard)
            if ref:
                log(f"    beside phase 7 (a)'s SDK, same guard, same run: {ref['rps']:.1f} "
                    f"requests/s, p50 {ref['p50_ms']:.3f} ms, p99 {ref['p99_ms']:.3f} ms")
            if want_sym and not moved.get(want_sym):
                raise AssertionError(f"{label}: {want_sym} never launched ({moved})")
            if not set(moved) & {K1_TF32, K3_INT8}:
                raise AssertionError(f"{label}: neither K1 nor K3 launched ({moved})")
            with client.get_collection(name).index_read() as index:
                hold_against_direct(label, got, index, q64, SM.COSINE)

        # (b) batches of B over POST /search/vectors, each against the SDK
        log(f"  (b) POST /collections/main/search/vectors, batches of {B}")
        q = rng.standard_normal((B, D)).round(7)
        body_q = q.tolist()
        build.reset_launch_counts()
        for label, k, extra, metric in (
                ("k 10", K, {}, None),
                (f"k {K_WIDE}", K_WIDE, {}, None),
                ("k 10, where tag docs", K, {"where": {"tag": "docs"}}, None),
                ("k 10, manhattan", K, {"similarity_metric": "manhattan"}, SM.MANHATTAN)):
            lat = []
            body = json.dumps({"vectors": body_q, "k": k, **extra})  # the caller's encoding
            for _ in range(P8_BATCH_REPS):
                t0 = time.perf_counter()
                _, _, out = http.call("POST", "/collections/main/search/vectors", body)
                lat.append(time.perf_counter() - t0)
            got = results_of(vl, out["results"])
            t0 = time.perf_counter()
            want = client.search_vectors_in_collection(
                "main", q, k + 1, metric, where=extra.get("where"))
            sdk_ms = (time.perf_counter() - t0) * 1e3
            log(f"    {label}: p50 {np.percentile(lat, 50) * 1e3:.3f} ms over "
                f"{P8_BATCH_REPS} requests, {len(body) / 1e6:.2f} MB in, the answer's parse "
                f"included (the SDK call at k + 1: {sdk_ms:.3f} ms) [{card}]")
            hold_rows(f"HTTP batch, {label}", got, want)
        moved = launch_counts(build)
        count(moved)
        log(f"    launches {moved}")
        for sym in (K1_TF32, K1_WIDE, K4_F32):
            if not moved.get(sym):
                raise AssertionError(f"(b): {sym} never launched ({moved})")

        # (c) bulk add of fresh rows over POST /collections/main/vectors
        fresh = rng.standard_normal((P8_BULK_ROWS, D)).astype(np.float32)
        bodies = [json.dumps({"vectors": [
            {"values": row, "text": f"bulk {lo + i}", "metadata": {"bulk": True}}
            for i, row in enumerate(fresh[lo:lo + P8_BULK_BODY].tolist())]})
            for lo in range(0, P8_BULK_ROWS, P8_BULK_BODY)]
        nbytes = sum(len(b) for b in bodies)
        build.reset_launch_counts()
        t0 = time.perf_counter()
        new_ids = []
        for body in bodies:
            new_ids += http.call("POST", "/collections/main/vectors", body)[2]["ids"]
        add_s = time.perf_counter() - t0
        if new_ids != list(range(n, n + P8_BULK_ROWS)):
            raise AssertionError("the bulk add returned other ids")
        t0 = time.perf_counter()
        first = []
        for lo in range(0, P8_BULK_ROWS, P8_BULK_BODY):
            first += [r[0].id for r in client.search_vectors_in_collection(
                "main", fresh[lo:lo + P8_BULK_BODY].astype(np.float64), 1)]
        check_s = time.perf_counter() - t0
        moved = launch_counts(build)
        count(moved)
        missed = int(np.sum(np.asarray(first) != np.asarray(new_ids)))
        log(f"  (c) {P8_BULK_ROWS} rows in {len(bodies)} bodies of {P8_BULK_BODY} "
            f"({nbytes / len(bodies) / 1e6:.1f} MB each, cap 256 MiB): {add_s:.2f} s, "
            f"{P8_BULK_ROWS / add_s:.0f} rows/s, {nbytes / add_s / 1e6:.1f} request MB/s; each "
            f"row searched for itself through the SDK ({check_s:.2f} s): {missed} not first; "
            f"launches {moved} [{card}]")
        if missed:
            raise AssertionError(f"{missed} bulk-added rows do not come back first for themselves")

        # (d) the snapshot round trip of a 2^16-row collection
        m = P8_SNAPSHOT_ROWS
        client.create_collection("snap", vl.IndexType.FLAT)
        client.add_vectors_to_collection("snap", rows[:m], p7_texts(m), p7_metas(m))
        rc = RemoteClient(f"http://127.0.0.1:{port}", timeout=600)
        path = os.path.join(tmp, "snap.vlc")
        t0 = time.perf_counter()
        size = rc.download_snapshot("snap", path)
        down_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        restored = rc.restore_snapshot("snap2", path)
        up_s = time.perf_counter() - t0
        os.remove(path)
        answers = [http.call("POST", f"/collections/{name}/search/vectors",
                             {"vectors": body_q, "k": K})[2] for name in ("snap", "snap2")]
        log(f"  (d) GET /collections/snap/snapshot of {m} rows: {size / 1e6:.1f} MB streamed to "
            f"disk in {down_s:.2f} s; POST /collections/snap2/snapshot of it in {up_s:.2f} s "
            f"({restored} rows, the load included); batch of {B}, k {K}, bit-identical on both: "
            f"{answers[0] == answers[1]} [{card}]")
        if restored != m or answers[0] != answers[1]:
            raise AssertionError("the restored snapshot does not answer as the original")
        client.delete_collection("snap")
        client.delete_collection("snap2")

        # (e) /stats, /metrics, a device trace under load, an API key
        stats = http.call("GET", "/stats")[2]
        route = "POST /collections/{name}/search/text"
        metrics = http.call("GET", "/metrics")[2]
        line = f'vectorlite_requests_total{{route="{route}"}} {2 * P8_REQUESTS}'
        log(f"  (e) /stats {route}: {stats[route]['count']} requests, {stats[route]['errors']} "
            f"errors, p50 {stats[route]['p50_ms']} ms; /metrics carries {line!r}: "
            f"{line in metrics.splitlines()}")
        if stats[route]["count"] != 2 * P8_REQUESTS or line not in metrics.splitlines():
            raise AssertionError("/stats or /metrics miscounts (a)'s requests")
        os.environ["VECTORLITE_JAX_PROFILE_DIR"] = os.path.join(tmp, "trace")
        stop = False

        def searching():
            conn = Http(port)
            try:
                while not stop:
                    conn.call("POST", "/collections/main/search/vectors",
                              {"vectors": body_q[:16], "k": K})
            finally:
                conn.close()

        from concurrent.futures import ThreadPoolExecutor

        build.reset_launch_counts()
        with ThreadPoolExecutor(max_workers=P8_TRACE_THREADS) as pool:
            futures = [pool.submit(searching) for _ in range(P8_TRACE_THREADS)]
            time.sleep(0.5)
            t0 = time.perf_counter()
            try:
                trace_dir = http.call("POST", f"/debug/trace?seconds={P8_TRACE_S}")[2]["trace_dir"]
            finally:
                stop = True
            trace_s = time.perf_counter() - t0
            for f in futures:
                f.result()
        del os.environ["VECTORLITE_JAX_PROFILE_DIR"]
        moved = launch_counts(build)
        count(moved)
        (trace,) = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)]
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        ours = build.device_kernel_names()
        named = {}
        for ev in events:
            for kern in ours:
                if kern in ev.get("name", "") and ev.get("ph") == "X":
                    named[kern] = named.get(kern, 0) + 1
        log(f"    POST /debug/trace?seconds={P8_TRACE_S} under {P8_TRACE_THREADS} searching "
            f"connections: {trace_s:.2f} s, {os.path.getsize(trace) / 1e6:.1f} MB, "
            f"{len(events)} events; the port's kernels in it {named}; launches in the window "
            f"{moved} [{card}]")
        if not named or not moved.get(K1_TF32):
            raise AssertionError("the device trace names none of the port's kernels")
        keyed = bind(create_app(client, api_key="phase-8-key"), "127.0.0.1", 0).start()
        try:
            bare = Http(keyed.port)
            status, resp, _ = bare.call("GET", "/collections", want=401)
            cors = resp.getheader("Access-Control-Allow-Origin")
            bare.close()
            keyed_conn = Http(keyed.port, {"Authorization": "Bearer phase-8-key"})
            status2, resp2, names = keyed_conn.call("GET", "/collections")
            keyed_conn.close()
            log(f"    a server with an API key: {status} without it (CORS {cors!r}), "
                f"{status2} with it (CORS {resp2.getheader('Access-Control-Allow-Origin')!r}), "
                f"{names}")
            if cors != "*" or resp2.getheader("Access-Control-Allow-Origin") != "*":
                raise AssertionError("an answer of the keyed server lacks the CORS headers")
        finally:
            keyed.close()
    finally:
        http.close()
        server.close()
    client.delete_collection("speed")

    # (f) the CLI on the card: writes, kill -9, restart, every write back
    try:
        wal, snaps = os.path.join(tmp, "wal"), os.path.join(tmp, "snaps")
        cli_port = free_port()
        args = ["--port", str(cli_port), "--wal-dir", wal, "--autosave-dir", snaps,
                "--autosave-interval", "3600"]
        if dev.type != "cuda":  # a rehearsal on the CPU; on the card the default is the card
            args += ["--device", str(dev)]
        env = dict(os.environ)
        env.pop("VECTORLITE_SPEED_GUARD", None)
        log_path = os.path.join(tmp, "cli.log")
        proc, start_s = start_cli(args, log_path, env)
        try:
            rc = RemoteClient(f"http://127.0.0.1:{cli_port}", timeout=600)
            rc.create_collection("durable", "flat")
            d_texts, d_metas = p7_texts(P8_DURABLE_ROWS), p7_metas(P8_DURABLE_ROWS)
            t0 = time.perf_counter()
            for lo in range(0, P8_DURABLE_ROWS, 1000):
                rc.add_texts("durable", d_texts[lo:lo + 1000], d_metas[lo:lo + 1000])
            add_s = time.perf_counter() - t0
            for vid in range(0, 2000, 10):
                rc.delete_vector("durable", vid)
            for vid in range(1, 1000, 10):
                rc.update_metadata("durable", vid, {"bucket": 99})
            deleted = rc.delete_where("durable", {"bucket": 7})
            probes = [f"record {i} amber" for i in range(64)]

            def state():
                out, total_rows, off = [], None, 0
                while total_rows is None or off < total_rows:
                    page, total_rows = rc.list_vectors("durable", off, 1000, include_values=True)
                    out += page
                    off += 1000
                return sorted(((v.id, v.text, v.metadata, v.values) for v in out),
                              key=lambda t: t[0])

            want_state, want = state(), rc.search_texts("durable", probes, k=K)
        finally:
            proc.send_signal(signal.SIGKILL)
            proc.wait()
        proc, restart_s = start_cli(args, log_path, env)
        try:
            rc = RemoteClient(f"http://127.0.0.1:{cli_port}", timeout=600)
            got_state, got = state(), rc.search_texts("durable", probes, k=K)
        finally:
            proc.send_signal(signal.SIGTERM)
            try:
                code = proc.wait(timeout=120)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
                raise
        bad = ids_match(scores_of(want), ids_of(want), scores_of(got), ids_of(got))
        err = float(np.max(np.abs(scores_of(got) - scores_of(want))))
        same_results = not bad and err <= 1e-5
        log(f"  (f) the CLI on the card (first start {start_s:.2f} s to /health): "
            f"{P8_DURABLE_ROWS} rows by add_texts in batches of 1000 ({add_s:.2f} s), 200 "
            f"deletes, 100 metadata updates, a delete_where ({deleted}); kill -9; restart to "
            f"/health {restart_s:.2f} s (restore + WAL replay included); {len(got_state)} rows, "
            f"state equal {got_state == want_state}, {len(probes)} searches: id mismatches "
            f"beyond ties {bad}, max score diff {err:.3g}; SIGTERM exit {code} [{card}]")
        if got_state != want_state or not same_results or code != 0:
            raise AssertionError("the restarted CLI lost or changed acknowledged writes")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  phase 8: {time.perf_counter() - started:.1f} s; launches {total}; host peak "
        f"RSS {peak_rss_gb():.2f} GB")
    return total


P9_LENGTHS = (8, 40, 100)  # words a text: MiniLM's 16-, 64- and 128-token buckets
P9_BATCHES = (1, 32, 256)  # texts an embed_batch_arrays call
P9_EMBED_REPS = 10
P9_VOCAB = 4096  # distinct words of the phase's texts
P9_FLAT_TEXTS = 1 << 17  # the Flat text collection: at the kernels' 2^17-row floor
P9_HNSW_TEXTS = 1 << 16
P9_SINGLE = 512  # single search_text calls a collection in (b)
P9_HNSW_ROWS = 1_000_000  # (c): bench/bulk_1m.py's N
P9_HNSW_PROBE = 1 << 18  # (c)'s sizing build, and its size when the 1M build projects too long
P9_HNSW_BUDGET_S = 300.0
#: the 1M build's non-scan parts (link, upper, refine) grew x5.6-8.0 over
#: the 2^18 probe's for x3.81 the rows (PERF.md, PR 13): up to rows^1.56
P9_REST_GROWTH = 1.6
#: the bulk scan's horizons (batch_end) at which (c) holds K1's wide mode
#: against its plain version: the first insert batch, a middle one and the
#: last, all below the 2^20-row capacity
P9_SCAN_HORIZONS = (4096, 409_600, 1_000_000)
P9_BEAM_REPS = 10
#: (c)'s second time rule: the smoke must end within 1,200 s, so the 1M
#: build runs only if the smoke's clock at the choice, plus its
#: projection, plus P9_AFTER_BUILD_S for the rest of phase 9 stays within
#: P9_SMOKE_DEADLINE_S (a slow host then keeps (c) at the probe's rows)
P9_SMOKE_DEADLINE_S = 1150.0
P9_AFTER_BUILD_S = 100.0
#: the smoke's start (perf_counter), set by main; None when a phase runs alone
SMOKE_STARTED = None
P9_QUERIES = 1000
P9_SINGLE_QUERIES = 200  # batch-1 native searches an ef
P9_CLASSIC_ROWS = 1 << 16
P9_SNAPSHOT_ROWS = 1 << 16
P9_DURABLE_ROWS = 10_000
P9_HTTP_TEXTS = 256


def p9_words() -> list:
    return [f"{P7_WORDS[i % 17]}{i}" for i in range(P9_VOCAB)]


def p9_texts(rng, words, n: int, n_words: int) -> list:
    picks = rng.integers(0, len(words), (n, n_words))
    return [" ".join(words[j] for j in row) for row in picks]


def p9_embeddings(n: int, d: int, n_clusters: int = 256, spread: float = 0.35,
                  seed: int = 0) -> np.ndarray:
    """bench/bulk_1m.py:41 make_embeddings: unit rows around 256 unit
    centers, spread 0.35 (a copy: the smoke imports nothing of bench/)."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    assign = rng.integers(0, n_clusters, n)
    data = centers[assign] + spread * rng.normal(size=(n, d)) / np.sqrt(d)
    data /= np.linalg.norm(data, axis=1, keepdims=True)
    return data.astype(np.float32)


def p9_queries(data: np.ndarray, nq: int, seed: int = 11) -> np.ndarray:
    """bench/bulk_1m.py's recall_at queries: stored rows plus N(0, 0.05^2 / D)."""
    rng = np.random.default_rng(seed)
    qidx = rng.integers(0, len(data), nq)
    return data[qidx] + 0.05 * rng.normal(size=(nq, data.shape[1])).astype(np.float32) / np.sqrt(
        data.shape[1])


def cosine_truth(data: np.ndarray, q: np.ndarray, dev, k: int = K) -> np.ndarray:
    """f64 cosine top-k ids on the card, ties to the lowest row."""
    qd = torch.from_numpy(q.astype(np.float64)).to(dev)
    qd = qd / qd.norm(dim=1, keepdim=True)
    best_s, best_i = None, None
    for lo in range(0, len(data), 1 << 18):
        v = torch.from_numpy(data[lo:lo + (1 << 18)]).to(dev).double()
        s = (qd @ v.T) / v.norm(dim=1)[None, :]
        s, i = torch.sort(s, dim=1, descending=True, stable=True)
        s, i = s[:, :k], i[:, :k] + lo
        if best_s is not None:
            s, pos = torch.sort(torch.cat([best_s, s], 1), dim=1, descending=True, stable=True)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
            s, i = s[:, :k], i[:, :k]
        best_s, best_i = s, i
    return best_i.cpu().numpy()


def hold_same(label, got, want) -> None:
    """Rows of SearchResults from two routes to the same search: ids equal
    beyond 1e-5 near-ties, scores within rtol/atol 1e-5."""
    bad = ids_match(scores_of(want), ids_of(want), scores_of(got), ids_of(got))
    err = float(np.max(np.abs(scores_of(got) - scores_of(want))))
    log(f"    {label}: {len(got)} queries, id mismatches beyond ties {bad}, max score diff "
        f"{err:.3g}")
    if bad or not np.allclose(scores_of(got), scores_of(want), rtol=1e-5, atol=1e-5):
        raise AssertionError(f"{label}: the two routes disagree")


def native_search_times(index, q, ef, metric) -> tuple:
    """The native search at batch 1 (P9_SINGLE_QUERIES queries, one at a
    time) and batch 256 (every query): (batch-1 ms list, batch-256 ms
    list, rows of the batched calls)."""
    singles = []
    for qi in q[:P9_SINGLE_QUERIES]:
        t0 = time.perf_counter()
        index.search(qi, K, metric, ef=ef, use_device=False)
        singles.append((time.perf_counter() - t0) * 1e3)
    batched, rows = [], []
    for lo in range(0, len(q), B):
        t0 = time.perf_counter()
        rows += index.search_batch(q[lo:lo + B], K, metric, ef=ef, use_device=False)
        batched.append((time.perf_counter() - t0) * 1e3)
    return np.asarray(singles), np.asarray(batched[:len(q) // B]), rows


def check_bulk_scan(scan, bulk_build, SM, dev, data, card: str) -> float:
    """K1's wide mode at the bulk build's scan shape (k SCAN_K, tiles of
    _scan_tile(cap), QUERY_CHUNK queries over the capacity-sized buffer,
    rows at and past the horizon invalid) against its plain version, at
    each of P9_SCAN_HORIZONS; raises on disagreement, returns the largest
    score difference. The queries are the rows just below the horizon, as
    in the build."""
    n, d = data.shape
    cap = 1 << (n - 1).bit_length()
    tile, k, b = bulk_build._scan_tile(cap), bulk_build.SCAN_K, bulk_build.QUERY_CHUNK
    sym = scan.exact_route(torch.float32, k, SM.COSINE, tile).symbol
    if sym != K1_WIDE:
        raise AssertionError(f"the bulk scan routes to {sym}, not {K1_WIDE}")
    values = torch.zeros(cap, d, device=dev)
    values[:n] = torch.from_numpy(data).to(dev)
    sq = (values * values).sum(-1)
    worst = 0.0
    for end in P9_SCAN_HORIZONS:
        valid = torch.arange(cap, device=dev) < end
        q = values[end - b:end].clone()

        def kern():
            return scan.pallas_search_topk(values, sq, valid, q, metric=SM.COSINE, k=k,
                                           tile_n=tile)

        def plain():
            return merged(scan, scan.tile_topk_plain(
                values, None, sq, valid, q, metric=SM.COSINE, k_tile=k + 1, tile_n=tile),
                b, k + 1)
        out = kern()
        torch.cuda.synchronize()
        label = f"{sym} bulk scan k {k} tile {tile} B {b} {cap}x{d} horizon {end}"
        worst = max(worst, compare(label, out, plain()))
        k_ms, p_ms = interleaved_ms(kern, plain, 5, 2)
        log(f"    {label}: {k_ms:.4f} ms, plain {p_ms:.4f} ms [{card}]")
    del values, sq
    torch.cuda.empty_cache()
    return worst


def text_hnsw_path(vl, build, dev, card: str, seed: int) -> dict:
    """Phase 9: the MiniLM embedder at full width and HNSW on the card.
    (a) the encoder's texts/s and its embeddings against its CPU forward
    and a reloaded model directory; (b) text collections (Flat and HNSW)
    end to end; (c) HNSW at a deployment's size (the bulk build on K1's
    wide mode, recall, the native search and the device beam, a classic
    build); (d) HNSW's .vlc, WAL + autosave and HTTP round trips. Returns
    the launches of its counted runs and K1 wide's largest difference
    from its plain version at the bulk scan's shape."""
    import shutil
    import tempfile

    from vectorlite_tpu_torch.api.server import bind, create_app
    from vectorlite_tpu_torch.embed import minilm
    from vectorlite_tpu_torch.index import bulk_build
    from vectorlite_tpu_torch.kernels import scan
    from vectorlite_tpu_torch.native import VLC
    from vectorlite_tpu_torch.store.autosave import AutosaveDaemon, restore_into
    from vectorlite_tpu_torch.store.wal import WalManager, recover_into

    # writers of synthetic model directories, kept with the tests
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests"))
    from _minilm_fixtures import hash_vocab, save_model_dir

    SM = vl.SimilarityMetric
    started = time.perf_counter()
    rng = np.random.default_rng([seed, 13])
    total = {}

    def count(moved):
        for sym, c in moved.items():
            total[sym] = total.get(sym, 0) + c

    # (a) MiniLM at full width, random_init(seed=0) on the card
    config = dict(minilm._MINILM_CONFIG)
    enc = vl.MiniLMEmbedder.random_init(seed=0, device=dev)
    cpu = vl.MiniLMEmbedder.random_init(seed=0, device="cpu")
    words = p9_words()
    log(f"  (a) MiniLM {config} on {enc.device}, random_init(seed=0); texts of "
        f"{P9_LENGTHS} words, batches {P9_BATCHES}")
    worst = 0.0
    by_len = {}
    for n_words in P9_LENGTHS:
        texts = p9_texts(rng, words, max(P9_BATCHES), n_words)
        by_len[n_words] = texts
        ids, _ = minilm.tokenize_batch(enc._tokenizer, texts, 512)
        want = cpu.embed_batch_arrays(texts)
        for b in P9_BATCHES:
            enc.embed_batch_arrays(texts[:b])  # warm
            times = []
            for _ in range(P9_EMBED_REPS):
                t0 = time.perf_counter()
                got = enc.embed_batch_arrays(texts[:b])
                times.append((time.perf_counter() - t0) * 1e3)
            err = float(np.max(np.abs(got - want[:b])))
            worst = max(worst, err)
            p50 = float(np.percentile(times, 50))
            log(f"    {n_words} words ({ids.shape[1]}-token bucket), batch {b}: p50 "
                f"{p50:.3f} ms a batch, {b / p50 * 1e3:.1f} texts/s; max abs diff vs the CPU "
                f"forward {err:.3g} [{card}]")
    if worst > 1e-4:
        raise AssertionError(f"MiniLM on the card is {worst:.3g} from its CPU forward")
    tmp = tempfile.mkdtemp(prefix="vl_phase9_")
    try:
        vocab = hash_vocab(enc._tokenizer, words)
        model_dir = save_model_dir(os.path.join(tmp, "model"), minilm._random_params(config, 0),
                                   config, vocab)
        t0 = time.perf_counter()
        loaded = vl.MiniLMEmbedder.from_pretrained(str(model_dir), device=dev)
        load_s = time.perf_counter() - t0
        texts = by_len[P9_LENGTHS[0]]
        err = float(np.max(np.abs(loaded.embed_batch_arrays(texts) - enc.embed_batch_arrays(texts))))
        log(f"    from_pretrained of a synthetic directory (config.json, pytorch_model.bin of "
            f"random_init's parameters, a WordPiece tokenizer.json of {len(vocab)} tokens) in "
            f"{load_s:.2f} s: max abs diff vs random_init {err:.3g} ({len(texts)} texts)")
        if err > 1e-5:
            raise AssertionError("the reloaded model directory embeds differently")
        del loaded
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # (b) text collections end to end through VectorLiteClient(MiniLMEmbedder)
    client = vl.VectorLiteClient(enc, device=dev)
    client.create_collection("flat", vl.IndexType.FLAT)
    client.create_collection("flat_speed", vl.IndexType.FLAT)
    client.create_collection("hnsw", vl.IndexType.HNSW, SM.COSINE)
    texts = p9_texts(rng, words, P9_FLAT_TEXTS, P9_LENGTHS[0])
    log(f"  (b) add_texts in batches of {B}: {P9_FLAT_TEXTS} texts into two Flat collections "
        f"(searched with the precision guard on, and off: K3), the first {P9_HNSW_TEXTS} into "
        f"an HNSW one (cosine, M 16), {P9_LENGTHS[0]} words a text")
    for name, n in (("flat", P9_FLAT_TEXTS), ("flat_speed", P9_FLAT_TEXTS),
                    ("hnsw", P9_HNSW_TEXTS)):
        t0 = time.perf_counter()
        for lo in range(0, n, B):
            client.add_texts_to_collection(name, texts[lo:lo + B])
        add_s = time.perf_counter() - t0
        log(f"    {name}: {n} texts in {add_s:.2f} s, {n / add_s:.1f} texts/s [{card}]")
    q_texts = p9_texts(rng, words, P9_SINGLE, P9_LENGTHS[0])
    q_single = np.concatenate([enc.embed_batch_arrays([t]) for t in q_texts]).astype(np.float64)
    guard = os.environ.get("VECTORLITE_SPEED_GUARD")
    for name in ("flat", "flat_speed", "hnsw"):
        index = client.get_collection(name)._index
        # the guard decides at the device copy's build: the first search
        os.environ["VECTORLITE_SPEED_GUARD"] = "0" if name == "flat_speed" else "1"
        client.search_text_in_collection(name, q_texts[0], K)
        build.reset_launch_counts()
        got, lat = [], []
        for t in q_texts:
            t0 = time.perf_counter()
            got.append(client.search_text_in_collection(name, t, K))
            lat.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        moved = launch_counts(build)
        count(moved)
        log(f"    {name}: {P9_SINGLE} single search_text, k {K}: p50 "
            f"{np.percentile(lat, 50):.3f} ms p99 {np.percentile(lat, 99):.3f} ms; launches "
            f"{moved} [{card}]")
        if name != "hnsw":
            hold_against_direct(f"single, {name}", got, index, q_single, SM.COSINE)
        else:
            hold_same("single, hnsw, vs search_batch of the embeddings computed apart", got,
                      index.search_batch(q_single, K, SM.COSINE))
        build.reset_launch_counts()
        lat, got = [], []
        for lo in range(0, P9_SINGLE, B):
            t0 = time.perf_counter()
            got.append(client.search_texts_in_collection(name, q_texts[lo:lo + B], K))
            lat.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        moved = launch_counts(build)
        count(moved)
        log(f"    {name}: search_texts, batches of {B}, k {K}: p50 {np.percentile(lat, 50):.3f} "
            f"ms ({len(lat)} batches); launches {moved} [{card}]")
        for lo, rows in zip(range(0, P9_SINGLE, B), got):
            q = enc.embed_batch_arrays(q_texts[lo:lo + B]).astype(np.float64)
            if name != "hnsw":
                hold_against_direct(f"batch at {lo}, {name}", rows, index, q, SM.COSINE)
            else:
                hold_same(f"batch at {lo}, hnsw", rows, index.search_batch(q, K, SM.COSINE))
    if guard is None:
        os.environ.pop("VECTORLITE_SPEED_GUARD")
    else:
        os.environ["VECTORLITE_SPEED_GUARD"] = guard
    if not any(total.get(sym) for sym in K1_SYMBOLS) or not total.get(K3_INT8):
        raise AssertionError(f"text search over the Flat collections launched {total}: "
                             f"K1 and K3 must both serve")
    del client, texts
    gc.collect()
    torch.cuda.empty_cache()

    # (c) HNSW at a deployment's size
    t0 = time.perf_counter()
    data = p9_embeddings(P9_HNSW_ROWS, D, seed=0)
    log(f"  (c) {P9_HNSW_ROWS} x {D} rows of bench/bulk_1m.py's geometry (256 clusters, spread "
        f"0.35, unit norm, seed 0) made in {time.perf_counter() - t0:.2f} s")
    scan_err = check_bulk_scan(scan, bulk_build, SM, dev, data, card)
    os.environ["VECTORLITE_BULK_PROFILE"] = "1"

    def bulk(n: int, force: bool):
        if force:
            os.environ["VECTORLITE_BULK_BUILD"] = "always"
        index = vl.HNSWIndex(D, SM.COSINE, store_f64=False, device=dev)
        if index._nb is None:
            raise AssertionError("the native HNSW builder did not serve")
        build.reset_launch_counts()
        t0 = time.perf_counter()
        index.add_batch_arrays(np.arange(n, dtype=np.uint64), data[:n])
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        moved = launch_counts(build)
        os.environ.pop("VECTORLITE_BULK_BUILD", None)
        split = getattr(index, "_bulk_split", None)
        log(f"    bulk build of {n} rows ({'VECTORLITE_BULK_BUILD=always' if force else 'auto'}"
            f"): {secs:.2f} s, {n / secs:.1f} inserts/s; split "
            f"{ {k: round(v, 2) for k, v in (split or {}).items()} }; launches {moved} [{card}]")
        if split is None or not moved.get(K1_WIDE):
            raise AssertionError(f"the {n}-row build did not take the bulk path on K1's wide mode")
        return index, secs, split, moved

    index, secs, split, moved = bulk(P9_HNSW_PROBE, True)
    grow = P9_HNSW_ROWS / P9_HNSW_PROBE
    # the scan covers every capacity row for every query; the rest (link,
    # upper, refine) grows faster than the rows: x grow ** P9_REST_GROWTH
    cap = 1 << (P9_HNSW_ROWS - 1).bit_length()
    rest = grow ** P9_REST_GROWTH
    projected = split["scan"] * grow * cap / P9_HNSW_PROBE + (secs - split["scan"]) * rest
    clock = 0.0 if SMOKE_STARTED is None else time.perf_counter() - SMOKE_STARTED
    ends = clock + projected + P9_AFTER_BUILD_S
    log(f"    the {P9_HNSW_ROWS}-row build projects to {projected:.1f} s (scan x "
        f"{grow * cap / P9_HNSW_PROBE:.2f}, the rest x {rest:.2f}; budget {P9_HNSW_BUDGET_S} s); "
        f"with it the smoke would end near {ends:.1f} s (clock {clock:.1f} s, "
        f"{P9_AFTER_BUILD_S} s for the rest of phase 9; deadline {P9_SMOKE_DEADLINE_S} s)")
    if projected <= P9_HNSW_BUDGET_S and ends <= P9_SMOKE_DEADLINE_S:
        log(f"    (c) runs at {P9_HNSW_ROWS} rows, the build engaging by itself (auto, past "
            f"VECTORLITE_BULK_AUTO_ROWS on the card)")
        del index
        gc.collect()
        index, secs, split, moved = bulk(P9_HNSW_ROWS, False)
        n = P9_HNSW_ROWS
    else:
        log(f"    past the budget or the deadline: (c) runs at {P9_HNSW_PROBE} rows, on the "
            f"sizing build")
        n = P9_HNSW_PROBE
    count(moved)
    os.environ.pop("VECTORLITE_BULK_PROFILE", None)
    rows = data[:n]
    q = p9_queries(rows, P9_QUERIES)
    truth = cosine_truth(rows, q, dev)
    native = {}
    for ef in (64, 128):
        singles, batched, res = native_search_times(index, q, ef, SM.COSINE)
        rec = recall(ids_of(res), truth)
        native[ef] = res
        log(f"    native search, k {K}, ef {ef}: recall@{K} {rec:.4f} vs f64 truth "
            f"({P9_QUERIES} queries); batch 1 p50 {np.percentile(singles, 50):.4f} ms "
            f"({1e3 / np.percentile(singles, 50):.1f} QPS, one thread); batch {B} p50 "
            f"{np.percentile(batched, 50):.3f} ms ({B * 1e3 / np.percentile(batched, 50):.1f} "
            f"QPS) [{card}]")
        if ef == 128 and rec < 0.95:
            raise AssertionError(f"recall@{K} {rec:.4f} < 0.95 at ef 128")
    t0 = time.perf_counter()
    index.search_batch(q[:B], K, SM.COSINE, ef=128, use_device=True)
    first = time.perf_counter() - t0
    beam_t = []
    for _ in range(P9_BEAM_REPS):
        t0 = time.perf_counter()
        beam = index.search_batch(q[:B], K, SM.COSINE, ef=128, use_device=True)
        beam_t.append((time.perf_counter() - t0) * 1e3)
    overlap = float(np.mean([len({h.id for h in a} & {h.id for h in b}) / K
                             for a, b in zip(beam, native[128][:B])]))
    log(f"    device beam (use_device=True), batch {B}, ef 128: first call {first:.2f} s (the "
        f"device copy's upload), then p50 {np.percentile(beam_t, 50):.3f} ms over "
        f"{P9_BEAM_REPS} calls (min {min(beam_t):.3f}, max {max(beam_t):.3f}); overlap with the "
        f"native search {overlap:.4f}; recall@{K} {recall(ids_of(beam), truth[:B]):.4f} [{card}]")
    if overlap < 0.9:
        raise AssertionError(f"device beam overlap {overlap:.4f} < 0.9")
    del index
    gc.collect()
    torch.cuda.empty_cache()
    os.environ["VECTORLITE_BULK_BUILD"] = "never"
    classic = vl.HNSWIndex(D, SM.COSINE, store_f64=False, device=dev)
    t0 = time.perf_counter()
    classic.add_batch_arrays(np.arange(P9_CLASSIC_ROWS, dtype=np.uint64), data[:P9_CLASSIC_ROWS])
    secs = time.perf_counter() - t0
    os.environ.pop("VECTORLITE_BULK_BUILD")
    log(f"    classic threaded build of the first {P9_CLASSIC_ROWS} rows "
        f"({os.cpu_count()} host threads): {secs:.2f} s, {P9_CLASSIC_ROWS / secs:.1f} inserts/s "
        f"[{card}]")
    del classic

    # (d) HNSW through the rest of the surface
    emb = vl.MockEmbeddingFunction(D)
    tmp = tempfile.mkdtemp(prefix="vl_phase9_")
    try:
        s_client = vl.VectorLiteClient(emb, device=dev)
        s_client.create_collection("snap", vl.IndexType.HNSW, SM.COSINE)
        s_rows = data[:P9_SNAPSHOT_ROWS]
        s_client.add_vectors_to_collection("snap", s_rows, p7_texts(len(s_rows)),
                                           p7_metas(len(s_rows)))
        q64 = q[:B].astype(np.float64)
        want = s_client.search_vectors_in_collection("snap", q64, K)
        path = os.path.join(tmp, "snap.vlc")
        calls = VLC.calls
        t0 = time.perf_counter()
        s_client.get_collection("snap").save_to_file(path)
        save_s = time.perf_counter() - t0
        fresh = vl.VectorLiteClient(emb, device=dev)
        t0 = time.perf_counter()
        fresh.add_collection(vl.Collection.load_from_file(path, **fresh.flat_index_kwargs()))
        load_s = time.perf_counter() - t0
        got = fresh.search_vectors_in_collection("snap", q64, K)
        same = ids_of(got).tolist() == ids_of(want).tolist() and (
            scores_of(got).tolist() == scores_of(want).tolist())
        log(f"  (d) .vlc: a {len(s_rows)}-row HNSW collection saved in {save_s:.2f} s "
            f"({os.path.getsize(path)} bytes, native emitter calls {VLC.calls - calls}), loaded "
            f"into a fresh card client in {load_s:.2f} s: {B} searches, same ids and scores "
            f"{same} [{card}]")
        if not same or VLC.calls == calls:
            raise AssertionError("the HNSW .vlc round trip changed the results")
        del s_client, fresh

        # WAL + autosave: one build thread, so replay rebuilds the live graph
        os.environ["VECTORLITE_BUILD_THREADS"] = "1"
        wal_dir, snap_dir = os.path.join(tmp, "wal"), os.path.join(tmp, "snapshots")
        d_client = vl.VectorLiteClient(emb, device=dev)
        d_client.set_collection_observer(WalManager(wal_dir, snapshot_dir=snap_dir))
        daemon = AutosaveDaemon(d_client, snap_dir, interval_s=3600.0)  # ticks by flush()
        d_client.create_collection("durable", vl.IndexType.HNSW, SM.COSINE)
        d_rows = data[P9_SNAPSHOT_ROWS:P9_SNAPSHOT_ROWS + P9_DURABLE_ROWS + 2000]
        d_texts, d_metas = p7_texts(len(d_rows)), p7_metas(len(d_rows))
        t0 = time.perf_counter()
        for lo in range(0, P9_DURABLE_ROWS, 1000):
            d_client.add_vectors_to_collection("durable", d_rows[lo:lo + 1000],
                                               d_texts[lo:lo + 1000], d_metas[lo:lo + 1000])
        add_s = time.perf_counter() - t0
        for vid in range(1, 1000, 10):
            d_client.update_metadata_in_collection("durable", vid, {"bucket": 99})
        t0 = time.perf_counter()
        daemon.flush()  # no tombstones yet: the snapshot carries the graph
        snap_s = time.perf_counter() - t0
        for lo in range(P9_DURABLE_ROWS, len(d_rows), 1000):
            d_client.add_vectors_to_collection("durable", d_rows[lo:lo + 1000],
                                               d_texts[lo:lo + 1000], d_metas[lo:lo + 1000])
        for vid in range(0, 2000, 10):
            d_client.delete_from_collection("durable", vid)
        d_client.delete_where_in_collection("durable", {"bucket": 7})
        for vid in [v for v in range(2001, 2200) if v % 16 != 7][:50]:
            d_client.update_text_in_collection("durable", vid, f"rewritten {vid}", {"v": vid})
        want = d_client.search_vectors_in_collection("durable", q64, K, ef=64)
        want_state = d_client.list_vectors_in_collection("durable", 0, 1 << 20, None, True)
        del d_client, daemon  # the crash: no close, no final flush
        fresh = vl.VectorLiteClient(emb, device=dev)
        t0 = time.perf_counter()
        restored = restore_into(fresh, snap_dir, **fresh.flat_index_kwargs())
        restore_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        replayed = recover_into(fresh, wal_dir)
        replay_s = time.perf_counter() - t0
        got = fresh.search_vectors_in_collection("durable", q64, K, ef=64)
        got_state = fresh.list_vectors_in_collection("durable", 0, 1 << 20, None, True)
        key = lambda v: v.id  # noqa: E731
        same = [(v.id, v.text, v.metadata, v.values) for v in sorted(want_state[0], key=key)] \
            == [(v.id, v.text, v.metadata, v.values) for v in sorted(got_state[0], key=key)]
        log(f"    WAL + autosave over HNSW: {P9_DURABLE_ROWS} rows in batches of 1000 "
            f"({add_s:.2f} s), 100 metadata updates, one snapshot ({snap_s:.2f} s), 2000 more "
            f"rows, 200 deletes, a delete_where, 50 update_text; dropped without close; restore "
            f"{restored} {restore_s:.2f} s, replay of {replayed} ops {replay_s:.2f} s; "
            f"{got_state[1]} rows, state equal {same} [{card}]")
        if not same or got_state[1] != want_state[1]:
            raise AssertionError("the restored and replayed HNSW collection differs")
        hold_same("replayed HNSW vs live, ef 64", got, want)
        os.environ.pop("VECTORLITE_BUILD_THREADS")
        del fresh

        # HTTP: an HNSW collection over the port's server, MiniLM embedding
        h_client = vl.VectorLiteClient(enc, device=dev)
        server = bind(create_app(h_client), "127.0.0.1", 0).start()
        http = Http(server.port)
        try:
            http.call("POST", "/collections", {"name": "h", "index_type": "hnsw"}, want=400)
            http.call("POST", "/collections",
                      {"name": "h", "index_type": "hnsw", "metric": "cosine"})
            h_texts = p9_texts(rng, words, P9_HTTP_TEXTS, P9_LENGTHS[1])
            t0 = time.perf_counter()
            for t in h_texts:
                http.call("POST", "/collections/h/text", {"text": t})
            add_s = time.perf_counter() - t0
            got, lat = [], []
            for t in h_texts[:64]:
                t0 = time.perf_counter()
                _, _, body = http.call("POST", "/collections/h/search/text",
                                       {"query": t, "k": K, "ef": 64})
                lat.append((time.perf_counter() - t0) * 1e3)
                got.append(body["results"])
            want = [h_client.search_text_in_collection("h", t, K, ef=64) for t in h_texts[:64]]
            log(f"    HTTP: POST /collections (hnsw, cosine; without a metric 400), "
                f"{P9_HTTP_TEXTS} POST /text of {P9_LENGTHS[1]} words "
                f"({P9_HTTP_TEXTS / add_s:.1f} texts/s), 64 POST /search/text with ef 64: p50 "
                f"{np.percentile(lat, 50):.3f} ms [{card}]")
            hold_same("HTTP /search/text vs the SDK", results_of(vl, got), want)
            if [row[0].id for row in want] != list(range(64)):
                raise AssertionError("an HNSW text did not find itself first over HTTP")
        finally:
            http.close()
            server.close()
        del h_client
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del data, enc, cpu
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  phase 9: {time.perf_counter() - started:.1f} s; launches {total}; host peak RSS "
        f"{peak_rss_gb():.2f} GB")
    return total, scan_err


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--ivf-rows", type=int, default=2_000_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=12)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    global SMOKE_STARTED
    started = SMOKE_STARTED = time.perf_counter()
    import vectorlite_tpu_torch as vl
    from vectorlite_tpu_torch import native
    from vectorlite_tpu_torch.core import metrics as metrics_mod
    from vectorlite_tpu_torch.kernels import _build, decompose, ivf, merge, pq, scan

    dev = torch.device("cuda", 0)
    card = card_line()
    log(f"[1] card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")
    t0 = time.perf_counter()
    sources = _build.sources()
    _build.build_all(sources)
    for name in sources:
        _build.load(name)
    log(f"    built {sources} in {time.perf_counter() - t0:.2f} s")
    for key, plan in wide_plans(_build).items():
        log(f"    wide mode plan, {key}: {plan}")
    for name, text in _build.build_logs.items():
        for line in _build.ptxas_report(name):
            log(f"    {name} ptxas:", line)
        fences = text.count("warpgroup.arrive is injected")
        if fences:
            log(f"    {name} ptxas: warpgroup.arrive injected {fences} times")

    phase_s = {"1": time.perf_counter() - started}  # each phase's seconds

    def phase_done(name, t0):
        phase_s[name] = time.perf_counter() - t0
        log(f"  phase {name} done: {phase_s[name]:.1f} s")

    rng = np.random.default_rng(args.seed)
    log("[2] kernels against their plain versions")
    t0 = time.perf_counter()
    errs = check_kernels(scan, metrics_mod, dev, rng)
    check_pq_kernel(pq, vl.SimilarityMetric, dev, rng, errs)
    # K6's operands come from a stream of their own: the corpus of phases
    # 3-4 depends only on --seed and the K1-K5 checks
    ivf_rng = np.random.default_rng([args.seed, 6])
    errs["gather_score"] = check_ivf_kernel(ivf, dev, ivf_rng)
    merge_rng = np.random.default_rng([args.seed, 7])  # K7/K8: a stream of their own
    errs["scan_merge_topw"] = check_merge_kernel(merge, vl.SimilarityMetric, dev, merge_rng)
    errs["scan_fold_probe"] = check_fold_kernel(decompose, dev, merge_rng)
    log(f"    at the main-path shape (N={args.rows}, D={D}, B={B}) [{card}]")
    timing = time_kernels(scan, metrics_mod, dev, rng, args.rows, errs)
    timing["pq_rank_mma"], timing["pq_rank"] = time_pq_kernel(
        pq, vl.SimilarityMetric, dev, rng, args.rows, errs)
    log(f"    K6 at the IVF shape [{card}]")
    timing["gather_score"] = time_ivf_kernel(ivf, dev, ivf_rng, errs)["bf16"]
    log(f"    K7 and K8 at the headline shape (N={args.rows}, D={D}, B={B}) [{card}]")
    timing["scan_merge_topw"] = time_merge_kernel(
        merge, vl.SimilarityMetric, dev, merge_rng, args.rows, errs)
    timing["scan_fold_probe"] = time_fold_kernel(decompose, dev, merge_rng, args.rows, errs)
    torch.cuda.empty_cache()
    phase_done("2", t0)

    log(f"[3] main path through the SDK (N={args.rows}, D={D}, B={B}, k={K})")
    t0 = time.perf_counter()
    rows = rng.standard_normal((args.rows, D), dtype=np.float32)
    queries = rng.standard_normal((B, D), dtype=np.float32).astype(np.float64)
    log(f"  data {args.rows} x {D} made in {time.perf_counter() - t0:.2f} s")
    launches, exact_ids = main_path(
        vl, _build, native.RESCORE, dev, rows, queries, card, args.batches)
    log(f"  host peak RSS after phase 3: {peak_rss_gb():.2f} GB")
    gc.collect()  # the phase-3 collections go before the pq collection comes
    torch.cuda.empty_cache()
    phase_done("3", t0)

    log(f"[3b] the device mesh: cuda:0 x {P3B_SHARDS} (N={args.rows}, D={D}, B={B}) [{card}]")
    t0 = time.perf_counter()
    for sym, c in mesh_path(vl, _build, ivf, dev, rows, queries, card, args.seed).items():
        launches[sym] = launches.get(sym, 0) + c
    log(f"  host peak RSS after phase 3b {peak_rss_gb():.2f} GB")
    phase_done("3b", t0)

    log(f"[4] the pq profile through the SDK (N={args.rows}, D={D}, B={B}, k={K})")
    t0 = time.perf_counter()
    for sym, c in pq_path(vl, _build, pq, native.RESCORE, dev, rows, queries, exact_ids,
                          card, args.batches, rng).items():
        launches[sym] = launches.get(sym, 0) + c
    log(f"  host peak RSS after phase 4: {peak_rss_gb():.2f} GB")
    del queries, exact_ids  # phase 7 serves the rows again
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("4", t0)

    log(f"[5] the IVF rung through the SDK (N={args.ivf_rows}, D={D}, k={K})")
    t0 = time.perf_counter()
    launches["gather_score"] = launches.get("gather_score", 0) + ivf_path(
        vl, _build, ivf, native.RESCORE, dev, args, card)
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("5", t0)

    log(f"[6] the merge-engine probe (N={args.rows}, D={D}, B={B}, k={HEADLINE_K})")
    t0 = time.perf_counter()
    six = headline_path(merge, decompose, scan, _build, vl.SimilarityMetric, dev, args, card)
    for sym in ("scan_merge_topw", "scan_fold_probe", K3_BF16, K3_TF32, K3_CORE):
        launches[sym] = launches.get(sym, 0) + six[sym]
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("6", t0)

    log(f"[7] the collection surface and persistence through the SDK (N={args.rows}, D={D}, "
        f"k={K}) [{card}]")
    t0 = time.perf_counter()
    seven, client, sdk = collection_path(vl, _build, dev, rows, card, args.seed)
    for sym, c in seven.items():
        launches[sym] = launches.get(sym, 0) + c
    gc.collect()
    phase_done("7", t0)

    log(f"[8] HTTP on the card (N={args.rows}, D={D}, k={K}) [{card}]")
    t0 = time.perf_counter()
    for sym, c in http_path(vl, _build, dev, client, rows, card, args.seed, sdk).items():
        launches[sym] = launches.get(sym, 0) + c
    del rows, client
    gc.collect()
    torch.cuda.empty_cache()
    phase_done("8", t0)

    log(f"[9] the MiniLM embedder and HNSW on the card [{card}]")
    t0 = time.perf_counter()
    p9_launches, scan_err = text_hnsw_path(vl, _build, dev, card, args.seed)
    for sym, c in p9_launches.items():
        launches[sym] = launches.get(sym, 0) + c
    errs[K1_WIDE] = max(errs[K1_WIDE], scan_err)
    phase_done("9", t0)
    log(f"  phase seconds {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}; smoke "
        f"run {time.perf_counter() - started:.1f} s, builds included; host peak RSS "
        f"{peak_rss_gb():.2f} GB")

    by_symbol = {kern.symbol: kern for kern in _build.KERNELS}
    if set(by_symbol) != set(REPLACES):
        raise AssertionError(f"kernels {sorted(by_symbol)} vs REPLACES {sorted(REPLACES)}")
    kernels = []
    for kern in (by_symbol[symbol] for symbol in REPLACES):
        t = timing[kern.symbol]
        kernels.append({
            "name": kern.symbol,
            "route": "cuda",
            "source": kern.source,
            "replaces": REPLACES[kern.symbol],
            "launches": launches[kern.symbol],
            "max_abs_err": errs[kern.symbol],
            **t,
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
