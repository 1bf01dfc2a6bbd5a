#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py     # the whole check, one card
    python3 chip_smoke.py --baseline DIR   # also hold DIR's kernels
    python3 chip_smoke.py --stream-ab DIR  # only the ingests (streaming,
                                           # sharded D = 4, join) and the
                                           # merge, DIR's package against
                                           # this one's
    python3 chip_smoke.py --sharded-only   # only phases 1, 2, 23 and 24
    python3 chip_smoke.py --table1-only    # only phases 1, 2, 4, 5, 25-28
    python3 chip_smoke.py --wide-only      # only phases 1, 2, 29 and 30

DIR is a checkout of an earlier commit. Its weighted_moments.cu,
stratified_moments.cu, sample_extremes.cu, segment_reduce.cu,
route_multid.cu, query_eval.cu and join_moments.cu (seven sources) are
built beside the current sources, held against the current kernels and
timed beside them:
rows 1 (query_eval) and 7 (route_multid) must give the baseline's bits at
every shape they are checked at (row 7 on non-finite rows too, where it
differs from its plain version), row 2 (stratified_moments) the first
version's bits for s <= 2048 slots a stratum (one slot chunk: phase 3's
single-chunk cases, the 1-D and 3-D serving shapes, Table 1's ST, PASS and
BSS2x arms); above one chunk its partials are folded in chunk order, so
the values that differ from the baseline's are counted and, like every
value, held within tolerance of plain. Row 5 (segment_reduce) must give
the baseline's bits too but for ties of +0.0 and -0.0 in its MIN/MAX
columns, which a baseline from before the signed-zero rule breaks the
other way (counted), rows 3 and 4 (the weighted moments) at every shape
with s <= 2048 slots a stratum (one slot chunk: the bootstrap's shapes,
the edge and class cases up to 300 slots, the chunk case at 2048; above
it, up to the baseline's 32,768, their differing values counted), row 9
(join_cell_moments: its eight planes, exact3 and touched) at every edge
case and at the join 1-D and 3-D shapes, where it is also timed in turns
with the baseline's and the join answer is served with either (the same
bits), and row 6 (weighted_segment_reduce) must meet it within
rtol=3e-5, atol=1e-3. Row 8 (sample_extremes) is bit-equal to its plain
version at every shape, the baseline's too. A baseline with wide kernels
(d > 16) must give rows 2, 3, 4, 8 and 9's bits at every d > 16 and s
(phase 29's cases, phase 30's shapes and its chunk path), where each is
also timed in turns with it (row 9 and its join answer at phase 30's join).
Rows 1 and 7 with such a baseline give its bits at every d > 16 and are
timed in turns with it at phase 30. Rows 1-9 of the kernels line
then carry the baseline's times (baseline_ms, and for rows 1, 2 and 5-8
baseline_device_ms; rows 2 and 8 timed in turns with the baseline's at the
serving shapes, row 9 baseline_row9_ms / baseline_row9_device_ms; null
without --baseline).

Phases, each of which fails the run:

1. Device: the card's name and power limit (nvidia-smi); TF32 off.
2. Build: the hand-written CUDA kernels from src/repro_torch/kernels/csrc
   (and, with --baseline, DIR's seven sources); the wrappers' launch
   plans, rows 2 and 8's slot chunk and scratch, rows 3 and 4's slot
   chunk, plan and scratch, and row 9's tiles and scratch against the
   sources'.
3. Kernel against plain on the card at edge shapes (ragged Q and k, d up
   to 16, inverted empty leaves, ragged validity, s = 1, several tiles);
   stratified_moments also where covered, empty and mixed pairs all
   appear (k = 53 and 64, s up to 2500, d up to 16, strata without a valid
   slot), each case printing its counts, and with NaN coordinates on valid
   slots; bit-equal across two launches and (s <= 2048) to the baseline.
   Above one slot chunk of 2048 (s = 2049, 2500, 4096, 4103, 6151 and
   38,500; k = 1, 3, 17, 53 and 64; d = 1, 3 and 16) rows 2 and 8 on
   inputs whose chunks fall into bands of each stratum's cell, so that
   covered, empty and mixed (query, stratum, chunk) triples all occur in
   some chunk, with NaN coordinates on valid slots of a chunk: the classes
   of every chunk printed, row 2 within tolerance and row 8 bit-equal to
   plain, each bit-equal across two launches and its rows at Q = 1 and a
   slice bit-equal to the same rows of the batch. query_eval at
   Q = 1 and k = 1, k off every multiple of 32 and of its 1024-leaf tile,
   A from 1 to 8, every leaf covered and none, inverted leaves, NaN in
   leaf boxes and query bounds: rel equal to plain, exact within
   tolerance of plain and bit-equal to the baseline. sample_extremes
   bit-equal to plain (NaN as NaN) and across two launches at every edge
   shape above and at sets where covered, empty and mixed pairs all appear
   (counts printed), with NaN coordinates on valid slots, NaN, +-inf and
   values beyond +-3.4e38 on valid and invalid slots, and strata of +0.0
   and -0.0 in either order. Row 10 (threefry, csrc/threefry.cu) bit-equal
   to its plain version (the int64 torch code of repro_torch.random and
   poisson_weights_plain), each call one launch: split and uniform of
   n = 1, 2, 31, 32, 33 and 65,537 counters, uniform of 2-D shapes and of
   key batches (a row view at an offset too), uniform_scalar, fold_in of
   negative, -2**31, >= 2**31 and >= 2**32 data (int32, int64 and Python
   ints), under keys whose words are 0 or >= 2**31; the Poisson weights W
   and K* at R = 1 and 200, ragged k x s, strata with no valid slot and
   replicate indices that wrap past 2**32.
4. 1-D main path: nyc_taxi(scale=1.0) (7.7 M trips) -> build_synopsis(k=1024,
   sample_rate=0.01) -> random_queries(2048) -> PassEngine(all five kinds,
   ci=0.95).answer(), through the entry points a user calls. The three
   serving kernels' launch counts (query_eval, stratified_moments,
   sample_extremes) must rise in that window. Then: kernel = plain at these
   shapes (sample_extremes bit for bit, also on a slice_sample_slots view),
   the answer = the port's CPU answer (first 512 queries), the truth
   inside [lower, upper] for 64 queries and every kind, median relative
   error of SUM.
5. 3-D path: nyc_taxi(scale=1.0, dims=3) with method="kd", the same checks.
6. Times (CUDA events, medians after warm-up) of answer() (also by host
   clock, and its peak memory) and of each serving kernel and its plain
   version at the main-path shapes, with the kernels' device times and
   host issue and, with a baseline, its query_eval's in turns; and a
   torch.profiler window over answer() for the device-busy share (its
   table goes to chiprun_out/).
7. The streaming kernels against plain at edge shapes: segment_reduce
   (N up to 65537, k up to 1024, -1 ids, one segment, empty segments)
   within tolerance, bit-equal across two launches and to the baseline,
   and on +0.0 / -0.0 values its MIN/MAX bit-equal to plain (ties against
   the baseline counted); route_multid (B up to 65536, k up to 2049, d in
   {2, 3, 16}, ties, +-inf empty boxes, rows on shared faces, +-0.0 faces and rows, equal
   boxes across leaf groups, k around multiples of the group count and
   of the group size, B off the row tile) bit-equal to plain, across two
   launches and to the baseline; rows with NaN and +-inf coordinates
   (d = 2, 3, 16 and 24, the last through the wide kernel) bit-equal to
   the baseline (their differences from plain counted).
8. 1-D streaming: StreamingIngestor(phase 4's synopsis, seed=11) ingests
   nyc_taxi(scale=0.1, seed=7) in arrival order, 4096-row batches
   (770,000 trips, 188 batches). segment_reduce launches once a batch,
   row 10 twice (the key's split, the batch's uniforms) and route_multid
   never. PassEngine(ingestor).answer() of phase 4's
   queries holds the truth over base plus stream; the port on the CPU
   ingests the first 8 batches to the same state; then reoptimize +
   replace_source and the truth checks again.
9. 3-D streaming: the same stream at dims=3 into phase 5's synopsis;
   route_multid launches once a batch too.
10. Streaming times: each streaming kernel and its plain version at
   B = 4096 and 65536 (and kernel = plain there; both kernels bit-equal to
   the baseline's and timed beside it, in turns), by events, on the
   device (one device operation a call) and by host issue; segment_reduce
   at B = 4096 with half and with all of its values +0.0 / -0.0 (the
   signed-zero rule's worst case: every chunk looks again for the zero it
   prefers), kernel = plain, its device time beside the baseline's; ingest
   per batch, the merge, answer right after an ingest, and a profiler
   window over 10 batches with each kernel's share of it.
11. The bootstrap's kernels against plain at edge shapes:
   stratified_weighted_moments and bootstrap_moments (Q up to 129, k up to
   53, s up to 300, d up to 16, R in {1, 7, 8, 9, 33}; zero, Poisson and
   non-integer weights, weights on invalid slots, strata without samples)
   within tolerance, bit-equal across two launches and to the baseline,
   and every bootstrap_moments slice r torch.equal to
   stratified_weighted_moments with W[r]; inputs where covered, empty and
   mixed (query, stratum) pairs all appear (a box over every sample, boxes
   that miss everything, box edges on sample coordinates; k = 64 and 53,
   s up to 2500), each printing its counts, and three of them again with
   NaN coordinates on valid slots (one slot of a stratum, every slot of
   another): those strata mixed or empty under every query, never their
   totals; weighted_segment_reduce (N up to 65537, k up to 3000). Then
   rows 3 and 4 around slot chunks of 2048 (s = 2048, 2049, 32,768,
   32,769, 40,000 and 65,537; k = 1, 3 and 17; d = 1, 3 and 16; R up to
   9) on
   banded inputs where covered, empty and mixed (query, stratum, chunk)
   triples occur, NaN coordinates on valid slots in every other case,
   each chunk's classes printed: within tolerance of plain (over query
   chunks), bit-equal across two launches, the fused block bit-equal to R
   scan launches, rows of query 0 and of a slice alone bit-equal to the
   batch's, and bit-equal to the baseline at every s when it folds the
   same chunks (else at s = 2048). Then the walks of the mixed pairs
   (WALK_CASES): R = 1, 31, 33 and 200 (both lane layouts of the staged
   walk and the direct one), Q off multiples of 32, ragged last chunks,
   mask bits only in a chunk's last word, every pair mixed, NaN
   coordinates on valid slots, +-inf and NaN weights on invalid slots;
   the same checks.
12. 1-D bootstrap serving on phase 4's synopsis and queries:
   PassEngine(kinds=sum/count/avg, CIConfig(method="bootstrap",
   n_boot=200, key=5)).answer(). Fused launches bootstrap_moments and
   row 10 (the weights of all 200 replicates) once, scan (boot_fused=False)
   stratified_weighted_moments and row 10 200 times each, and the
   two answers are torch.equal in both normalize modes; the truth of 64
   queries inside [lower, upper]; the AVG interval overlaps the CLT one on
   at least 0.9 of the queries; the port on the CPU gives the same answer
   for the first 32 queries.
13. 3-D bootstrap on phase 5's synopsis, fused only, the same checks but
   the CPU one.
14. Planner: plan_queries over phase 4's queries, answer(plan=) with
   ci=0.95 and with the bootstrap: query_eval never launches, and both
   answers equal the port's CPU answer(plan=). The bootstrap (phases 12
   and 13, no MIN/MAX) launches no sample_extremes; the planner's ci=0.95
   answer, all five kinds, launches it once.
15. Bootstrap times: the answer fused and scan, its split (draw, kernel,
   epilogue), its peak memory and a profiler window; each new kernel and
   its plain version at the main path's shapes, with their bounds and the
   nearest library call (torch.bmm of a prebuilt predicate, index_add_)
   by events and on the device; the pair classes there; the launch
   overhead of the weighted kernels and stratified_moments;
   weighted_segment_reduce at leaf-major and at uniformly random ids, one
   device operation a call, with its host enqueue time;
   bootstrap_moments at the 3-D shapes; with a baseline, rows 3 and 4 at
   the 1-D and 3-D shapes in turns with its kernels (kernel, baseline,
   baseline, kernel; events and device time), bit-equal to them.
   Row 10 at the main path's shapes: the fused draw (R = 200 over the
   1-D synopsis's 1024 x 75 slots), the ingest's uniforms of a 4096- and
   a 65,536-row batch, split(key, 2) and split(key, 5): bit-equal to plain,
   by events and on the device against its bound (bytes over 3.35 TB/s or
   int32 operations over 16.7 T/s), the plain version's time and
   torch.rand's of the same size (a yardstick only: Philox, not these
   bits).
16. The degradation ladder on phase 4's and 5's synopses and queries (all
   five kinds, ci=0.95): answer(deadline_ms=0) serves tier 0 with no
   launch and holds the truth, and on covered queries has the exact
   path's bits (COUNT/MIN/MAX against answer(), SUM against
   answer(plan=); AVG within rtol=3e-5); answer_progressive().final() runs
   the tiers [9, 18, 37, None], each one launch of each serving kernel,
   the intervals tighten at every tier, and the last tier's own answer
   has answer()'s bits; CIConfig(max_ci_width=) stops the ladder early.
   Tier 0 timed by host clock, each tier by events and host clock.
17. Rows against their padded class (1-D and 3-D): Q = 1, 3, 8, 240 and
   2048 bit-equal to the same rows padded with empty rows to 128, 512 and
   4096. The coalescer on the 1-D synopsis: 16 tenants of 16-240 rows
   from a seed, CoalescerConfig(shape_classes=(128, 512, 2048)), all five
   kinds, ci=0.95: fewer dispatches than requests, each serving kernel
   once a dispatch, every tenant's demuxed result the bits of its own
   answer(); 4 tenants under the fused bootstrap (R = 200),
   bootstrap_moments and row 10 once a dispatch, bit-equal; the 16 tenants under
   TickDriver with queries written on a side stream, every future
   resolved and bit-equal, no failure. The coalesced round against the
   per-tenant sequential round, host clock.
18. Checkpoints and faults on the 1-D stream: 32 of phase 8's batches, a
   checkpoint, a restore into a fresh engine, 32 more batches into both:
   states torch.equal, answers bit-equal, segment_reduce (32) and row 10
   (64) launched by the restored ingestor; the 3-D synopsis round-trips bit-equal; a FaultPlan
   poisoning every 5th of 32 batches: the quarantine counter equals the
   poisoned rows and the state equals a clean run with those batches
   quarantined. File sizes, save and restore seconds.
19. Joins, rows 9 and 11 and 1-D: join_cell_moments
   (csrc/join_moments.cu; the JAX package's join stage is plain jnp)
   against its plain version at edge shapes (Q = 1, k = 1, Q, k and k * P
   off the kernel's tiles, P = 1 and 16, su = 1, leaves with no valid
   slot, groups of one slot, every key missing from the dimension side,
   NaN coordinates on valid slots, +-0.0 values, D = 2, 4, 6 and 16,
   boxes that hold whole cells, non-finite values), each printing its
   (query, cell) classes: within tolerance (bit for bit on +-0.0),
   bit-equal across two launches and to the baseline, rows at Q = 1, 3,
   16, 240 bit-equal to the same rows of the batch. Row 11
   (join_epilogue, csrc/join_epilogue.cu; the JAX package's epilogue is
   plain jnp) against join_epilogue_plain at edge shapes (Q = 1, Q and
   k * P off its 256-thread block and 4-cell chunks, P = 1 and 16, strata
   whose universe buffer overflowed, a row with no sampled cell and one
   with only covered cells, empty cells with +-inf MIN / MAX, an AVG count
   below 1, +-0.0 values, an int64 u_overflow), each with kinds sum,
   count, avg and all three, under no interval (lam), 0.95 "stratum",
   0.95 "union" at small_n_threshold 30 and 0.9 "union" at 12: within
   tolerance (ci_half as its square: rtol 2 x 3e-5, atol 1e-6 max|est|^2,
   against plain or, where AVG's C - h_c cancels, the plain composition
   with float64 row sums; the count printed), bit for bit on rows without
   a sampled cell and on the +-0.0 case's SUM
   and AVG, bit-equal across two launches, rows at Q = 1, 3, 16, 240
   bit-equal to the same rows of the batch. Then
   benchmarks/bench_joins.py's distributions at the main table's size:
   7.7 M fact rows over 30,800 dimension keys, build_dim_table(P=16) ->
   build_join_synopsis(k=1024, p_u=0.05, "adp"), row 10's key_uniforms
   over the 7.7 M fact keys bit-equal to plain and timed (1-D), ->
   PassEngine(sum/count/avg, ci=0.95).answer_join of 2048 join
   rectangles: query_eval twice, join_cell_moments once and join_epilogue
   once in that window; the (query, cell) class split (empty, covered,
   mixed); row 9 against plain at that shape (and rows against the batch,
   and bit-equal to the baseline); row 11 against plain there under 0.95,
   no
   interval and "union" (rows against the batch under 0.95); the port on
   the CPU on the first 256 queries; ground_truth_join of 64 queries
   inside [lower, upper], the median SUM error at most bench_joins' 0.15,
   CI95 coverage printed; times (answer_join by events and host clock,
   device busy and kernels per answer, row 9 by events and device time
   against its bound and its plain version's, row 11 by events and device
   time against its bound and the plain epilogue's device time on the
   same artifacts, the join answer's stage with row 11 and with the plain
   epilogue in turns; with a baseline, row 9 and answer_join (events, host
   clock, device busy) with the baseline's row 9 and this one in turns,
   the answers bit-equal; peak memory above resident, which must stay
   under 16 GB); 16 tenants' join requests and one copy through the
   coalescer,
   bit-equal to their own answer_join, query_eval twice and rows 9 and 11
   once a dispatch; 770,000 newer fact rows (1 % of their keys outside
   the dimension table) streamed in 188 batches of 4096 (segment_reduce
   twice a batch, row 10 four times a batch and twice a regrow; the
   buffers start full, so overflow and regrow run), a profiler window of
   10 batches (device kernels a batch, row 10's share), the stream served
   against the truth; a checkpoint after 32 batches whose restore takes
   32 more beside the original, states torch.equal and answers
   bit-equal.
20. Joins, 3-D: the same at d_fact = 3 (method="kd", one sorted pair a
   fact column); route_multid launches once a stream batch and once a
   regrow.
21. The partition catalog tier, 1-D. Edge cases: query_eval and
   stratified_moments against plain on stacked partition synopses with 1,
   2 and 3 pad blocks (+-inf boxes, +inf / -inf MIN / MAX aggregates) and
   an all-empty partition inside (1-D eq, 3-D kd): rel equal, pad strata
   never covered and their moments +0.0, exact's MIN / MAX columns against
   the product over the finite leaves (the plain product is NaN there,
   counted); partition_stats (d + 2 segment_reduce launches) against its
   CPU pass with masked rows, empty partitions, +-0.0 values, coordinates
   past the edges, d = 1 and 3: counts, histograms, boxes and MIN / MAX
   bit-equal, bit-stable across two launches. Then the lake:
   nyc_taxi(scale=1.0) in 1024 time buckets (partition_rows), served by
   PassEngine.from_catalog(CatalogConfig(k=16, s_per_leaf=75,
   max_partitions=64, seed=0), sum/count/avg, ci=0.95) on
   random_queries(c, 2048, seed=3): query_eval and stratified_moments once
   in the answer's window; the partitions built are the picker's picks;
   the same selection on the card and on the CPU (first 256 queries); rows
   1 and 2 against plain at the stacked shape; the truth of 64 queries
   inside [lower, upper]; the median SUM error at most 0.15
   (bench_partitions' bar); CI95 coverage printed. Times: time to first
   answer cold against phase 4's build_synopsis plus first answer, a
   warm answer by events and host clock, its stage alone and the picker
   alone (host clock), device busy and kernels an answer, builds and LRU
   hits a batch, peak memory above resident, rows 1 and 2 at the stacked
   shape against their bounds and plain versions; partition_stats over
   all 7.7 M rows (counts, MIN / MAX, boxes and histogram row sums equal
   to build_catalog's, sums within tolerance, two launches bit-equal),
   timed. bench_partitions.run()'s defaults (64 x 80,000 rows, budget
   10, Q = 8, the short-batch path): catalog against flat time to first
   answer, both within 0.15 of the truth, the dense twin bit-equal to the
   flat engine. A partition of the first selection failing every build:
   degraded, the queries overlapping it (and only they) enveloped, the
   others as the clean answer; a checkpoint and restore, the next two
   draws bit-equal.
22. The catalog tier, 3-D: the lake at dims=3 with method="kd" and 3-D
   random queries, the same checks but bench, faults and checkpoint, with
   a median SUM error bar of 0.6 (CAT_ERR). The lake's partition_stats
   sums meet build_catalog's and the CPU pass's within LAKE_SUM_RTOL,
   twice the JAX package's own envelope on these buckets.
23. The sharded state on one card, D = 1, 2 and 4 logical shards
   (data_mesh(D)): the main cells' 7.7 M trips through
   build_synopsis_sharded(k=1024, sample_budget=77,824, so 76 slots a
   stratum at every D; 65,536-row batches; 1-D "adp", 3-D the kd
   skeleton): segment_reduce (and in 3-D route_multid) once a shard a
   batch, row 10 D + 1 times a batch (split(key, D + 1), one uniform a
   shard), and nothing else; counts, n_rows, MIN / MAX and boxes equal to
   the skeleton's exact per-leaf statistics and across D, the tree's
   structure across D, SUM / SUMSQ within f32_sum_rtol of their float64
   sums, the reservoirs filled as the rows were dealt. The 770,000 newer
   trips streamed in 188 batches (D launches of each streaming kernel a
   batch, D + 1 of row 10); at D = 1 the merged synopsis byte-equal to StreamingIngestor's
   on the same base and key; PassEngine(all five kinds, ci=0.95) on the
   merged synopsis: query_eval, stratified_moments and sample_extremes
   once, the truth of 64 queries inside [lower, upper], median SUM error
   at most 0.05 (1-D) / 0.15 (3-D), the port's CPU answer on the first
   256 queries; in 1-D at D = 2 reoptimize_sharded and the truth again.
   Times at each D: build (skeleton, fill, rows/s), ingest a batch against
   StreamingIngestor's, kernels and device busy a batch, the merge,
   answer, peak memory. The reference's invariance configuration (n =
   16,384, k = 8, integer values) gives equal BUILD / STREAM / SERVE /
   GLOBAL (/ REOPT in 1-D) digests at D = 1, 2 and 4, d = 1 and 2. A
   transient injected dispatch failure recovers bit-equal to a clean run;
   a persistent one drops one batch and counts it. Shards on one card run
   in turn: the times are the cost of the shard axis, not a scaling curve.
24. core/distributed.py on a (4, 2) "data" x "model" mesh:
   build_leaf_aggregates over the 7.7 M rows (8 segment_reduce launches)
   against host numpy; serve_queries_sharded at Q = 2048 and 13 (8 query
   blocks) against answer(); serve_samples_sharded, sum and count (2
   stratified_moments launches, 1 query_eval), against answer(); then
   catalog_delta_sharded at D = 4 over the lake's 1024 buckets (12
   segment_reduce launches) against build_catalog: counts, boxes, MIN /
   MAX and histogram row sums exact, sums within LAKE_SUM_RTOL; the
   histograms bit-equal to one partition_stats pass over the same rows
   (build_catalog bins in float64, so a row on a bin edge may land one
   bin apart). Times of each.
   With --sharded-only the script runs phases 1, 2, 23 and 24 alone.
25. Table 1 at paper size (benchmarks/table1_accuracy.py's budgets on
   phase 4's 7.7 M trips: K = 0.5 % of the rows, B = 64,
   random_queries(c, 2048, seed=11)). Seven arms: US
   (uniform_synopsis, k = 1), ST (stratified_synopsis, 64 eq strata),
   AQP++ (aqppp_synopsis, 64 hill-climbed intervals), PASS at equal
   budget (64 adp, K), PASS-ESS (64 * K / 2), PASS-BSS2x (2K) and
   PASS-BSS10x (10K). Each synopsis arm serves all five kinds
   (use_aggregates=False for US and ST) through the deprecated
   core.query.answer shim and through PassEngine, each in its own window:
   query_eval, stratified_moments and sample_extremes launch in both, the
   two answers have the same bits, and the port's CPU answer on the first
   128 queries meets the card's. AQPPP.estimate (float64 on the card)
   meets the same structure on the CPU within rtol=1e-6. The median
   relative COUNT / SUM / AVG error of each arm (the grid), and the
   paper's ordering on SUM: PASS < US, PASS < 1.5 x ST, ST < US, AQP++
   below 0.1. Rows 1, 2 and 8 against their plain versions (over chunks of
   queries: a (Q, k, s) plane at ESS is 10 GB) at the US shape (k = 1,
   s = 38,500, every pair mixed) and the ESS shape (k = 64, s = 19,250),
   timed by events and on the device against their bounds, the plain
   versions and, for row 2, torch.bmm of a prebuilt predicate (checked
   against the kernel first); there, rows 2 and 8 of the queries 0, 0-15,
   0-299 and 700-1023 alone bit-equal to the same rows of the whole batch
   (a pair's bits do not depend on its batch). With --baseline, row 2 of
   every arm against the baseline's: bit-equal where s <= 2048 (ST, PASS,
   BSS2x), the differing values counted above (US, ESS, BSS10x; held
   within tolerance of plain). The US arm under the bootstrap
   (CIConfig(method="bootstrap", n_boot=200), use_aggregates=False):
   fused (one bootstrap_moments launch) and scan (200
   stratified_weighted_moments launches) bit-equal, the truth of 64
   queries inside [lower, upper], the CPU answer on 16 queries; row 4
   there against plain on 64 queries, timed by events and on the device
   against its bound and torch.bmm of a prebuilt predicate; row 3 there
   (R = 1) against the R = 1 product, timed the same way; each kernel's
   device time in both launches; the scan answer's time; with a baseline, rows 3 and 4 in turns with its
   kernels. Row 4 at the ESS shape (k = 64, s = 19,250, R = 200) against
   plain on 8 queries, timed against its bound and torch.bmm of a
   predicate built over chunks of queries, and with a baseline in turns
   with its kernels. Every serving
   shim once on the card on the PASS and the US synopses, the same bits
   as PassEngine (poisson_bootstrap: one bootstrap_moments launch); the
   flat ops on the ESS and the US synopses' samples, shuffled with pad
   rows (one stratified_moments and one stratified_weighted_moments
   launch), against the kernel on the slots and the weighted plain
   version. Times of each arm's answer, AQPPP.estimate and the builds.
26. fig 8's 3-D cell at paper size (benchmarks/fig8_multidim.py's
   config: 2 % samples, k = 64 kd with proportional allocation, 512
   queries of 30-80 % a column, seed 19): KD-PASS through PassEngine
   (query_eval and stratified_moments once) holds the truth, the 3-D bar
   and the CPU answer; its kernels against plain, and rows 1, 2 and 8
   timed at its shape as in phase 25; KD-US (aqppp_synopsis(method="kd"))
   beside it; ess and skip_rate on the card share one query_eval launch.
27. The legacy update path: phase 4's synopsis in UpdatableSynopsis, the
   first 20,000 rows of nyc_taxi(scale=0.1, seed=7) inserted one by one
   (rows/s), snapshot() on the card served against the truth over base
   plus those rows, then to_streaming() ingests the remaining 750,000
   rows in 4096-row batches (segment_reduce once a batch, row 10 twice,
   and nothing else) and its answer holds the truth over base plus every
   row; the same in 3-D on phase 5's synopsis with 2,000 rows and 16 batches
   (route_multid once a batch too). delta_encode / delta_decode of phase
   4's synopsis: card = CPU bit for bit, each value back within one
   rounding a step (float32 does not round-trip every value bit for bit;
   the count is printed).
28. The four examples/torch_*.py main()s at their own scales on the card:
   each launches rows 1 and 2, prints its numbers beside the card's name
   and power limit, and its summary holds what it shows.

29. Any d: rows 1-4, 7, 8 and 9 at d = 16, 17, 31, 32, 33, 64 and 300
   (WIDE_DS; above 16 columns their wide instantiations, the columns in
   blocks of 16) against their plain versions as phases 3, 7, 11 and 19
   hold them: query_eval at k off its leaf tile and Q past a block,
   inverted and NaN boxes, a NaN bound; rows 2 and 8 at one slot chunk
   (s = 75; s = 33, a window and a slot) and above it (s = 2500, 2049),
   NaN coordinates on valid slots, row 8's special values, in two cases
   queries bounding 5-8 columns (pairs past CUT_MAX cut columns), rows
   alone bit-equal to the batch's and, with a --baseline that has wide
   kernels, bit-equal to its at every d > 16 (rows 1 and 7 too); rows 3
   and 4
   (weighted_chunk_check: fused = scan, rows alone, plain and, with such
   a baseline, its bits) at s = 75 (R = 8, 9 and 33), 300 (R = 1) and
   2049 (R = 3 and 9) with NaN coordinates on valid slots, in three cases
   queries bounding 5-8 columns (cut words past CUT_MAX); route_multid with
   ties and an inverted box, ties on both sides of every warp sub-range
   and cluster rank of the wide plan, B and k off their tiles, bit-equal;
   row 9 at D = d (WIDE_JOIN_CASES:
   NaN coordinates, non-finite values, covered cells, queries bounding 1
   and 9-12 columns, past the wide walk's 8 cut columns, runs longer
   than a 32-slot window, k * P off multiples of 4 and of the 64-cell
   tile), with a --baseline that has wide kernels bit-equal to its, and
   at the widest d the cut columns printed. At each d > 16 the bit
   identity: on a 16-column input (the
   d <= 16 code) and on the same input with d - 16 more columns (the
   wide code), whose query bounds are -+3.4e38 and data finite, rows 1-4,
   8 and 9 give the same bits; row 7, its rows inside every box there,
   the same leaf ids and distances.
30. The 24-column table at paper size: nyc_taxi(scale=1.0, dims=5)'s
   five columns and 19 generated ones (wide_table: uniform, lognormal,
   integer codes; value trip distance), 2048 queries each bounding 2-4
   columns by random_queries' rule on them (wide_queries) and every other
   column at its [min, max]. build_synopsis(k=1024, sample_rate=0.01,
   "kd") -> PassEngine(all five kinds, ci=0.95).answer() with phase 4's
   checks (rows 1, 2, 8 against plain at these shapes, the CPU answer,
   the truth of 64 queries inside [lower, upper], median SUM error at
   most WIDE_ERR, set by tools/reference_wide_error.py); the fused and
   the scan bootstrap at R = 200 (rows 10, 4 and 3; bit-equal, phase 12's
   checks); nyc_taxi(scale=0.1, seed=7)'s 770,000 trips with the same 19
   columns streamed in 4096-row batches (rows 10, 5 and 7; phase 8's
   checks, no reoptimize: 1-D only); one answer_join on join_workload's
   distributions with 24 fact columns at 7.7 M fact rows, each rectangle
   bounding 2-4 fact columns and the dimension pair (rows 1, 9 and 11;
   row 9 against plain, the truth of 64 queries, the cut columns of its
   mixed pairs and of each (query, 64-cell tile)). Each window's launches
   are read right after it. Times: rows 1-4, 7 and 8 by events and on the
   device, their plain versions and bounds at d = 24, rows 2-4's
   torch.bmm yardstick (a prebuilt predicate, as in Table 1), row 9 and
   the answers; the pair classes; row 1's cut columns a (query, leaf
   tile); with a --baseline that has wide kernels, rows 1 and 7 in turns
   with its (bit-equal first; row 7 at the stream's first batch), rows 2
   and 8 the same, rows 3 and 4 the same (weighted_turns), the mixed
   pairs each walk of rows 3 and 4 took, and the answer, the fused and
   the scan bootstrap answer with its rows 1, 2, 3, 4 and 8 and with this
   checkout's, in turns (the same bits); the stream again with its rows 1
   and 7 and with this checkout's, in turns (every state field the same
   bits, ingest ms a batch); row 9 bit-equal to its at the
   join shape, then row 9 and answer_join with its row 9 and with this
   checkout's, in turns (the same answer bits), and answer_join with its
   row 1 (the same bits).
   The chunk path: rows
   2 and 8 at k = 1, s = 38,500 (a uniform sample of the table: Table 1's
   US size), Q = 2048, against plain, in turns with the baseline's, beside
   torch.bmm and the bound. With --wide-only the script runs phases 1, 2,
   29 and 30 alone.

The line before the last is the kernels JSON line; the last line is
{"ok": true, "device": {...}}. Any failure raises, so nothing is printed
after it and the exit code is not 0.
"""
from __future__ import annotations

import ctypes
import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"
sys.path.insert(0, str(ROOT / "src"))

KINDS = ("sum", "count", "avg", "min", "max")
# H100 SXM published peaks (NVIDIA data sheet): HBM3 bytes/s and fp32
# (non-tensor) operations/s.
PEAK_BYTES_S = 3.35e12
PEAK_F32_OPS_S = 67e12
# Profiler windows a device-time reading of the wide path takes at most
# while a window keeps no device record (profiled); the windows taken again.
PROFILE_TRIES = 3
PROFILE_RETRIES = {"windows": 0}
# Kernel vs plain: the bar tests/test_kernels.py sets for Pallas (fp32 sums
# taken in another order).
K_RTOL, K_ATOL = 3e-5, 1e-3
SOURCES = {
    "query_eval": ("src/repro_torch/kernels/csrc/query_eval.cu",
                   "src/repro/kernels/query_eval.py:64"),
    "stratified_moments": (
        "src/repro_torch/kernels/csrc/stratified_moments.cu",
        "src/repro/kernels/stratified_estimate.py:102"),
    "segment_reduce": ("src/repro_torch/kernels/csrc/segment_reduce.cu",
                       "src/repro/kernels/segment_reduce.py:84"),
    "route_multid": ("src/repro_torch/kernels/csrc/route_multid.cu",
                     "src/repro/kernels/route.py:152"),
    "stratified_weighted_moments": (
        "src/repro_torch/kernels/csrc/weighted_moments.cu",
        "src/repro/kernels/stratified_estimate.py:135"),
    "bootstrap_moments": ("src/repro_torch/kernels/csrc/weighted_moments.cu",
                          "src/repro/kernels/bootstrap.py:115"),
    "weighted_segment_reduce": (
        "src/repro_torch/kernels/csrc/segment_reduce.cu",
        "src/repro/kernels/segment_reduce.py:138"),
    # No Pallas kernel: the jnp broadcast every JAX backend shares.
    "sample_extremes": ("src/repro_torch/kernels/csrc/sample_extremes.cu",
                        "src/repro/kernels/backends.py:257"),
}


def emit(**fields) -> None:
    print(json.dumps(fields), flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn()`` in ms over ``reps`` runs, each
    bracketed by CUDA events, after ``warmup`` runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(torch, fn, reps: int = 20) -> float:
    """Median host wall time of ``fn()`` ending in a synchronize, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def enqueue_ms(torch, fn, reps: int = 20) -> float:
    """Median host time to enqueue ``fn()`` (no synchronize inside), in ms;
    the card is drained after each call."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


def device_busy_us(prof) -> tuple[float, int]:
    """(summed device time in us, count) of the CUDA-side events (kernels
    and memory operations) a torch.profiler window recorded."""
    events = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    return (sum(e.device_time if hasattr(e, "device_time") else e.cuda_time
                for e in events), len(events))


def profiled(torch, fn, reps: int, tries: int = 1):
    """A torch.profiler window (CPU and CUDA) around ``reps`` calls of
    ``fn()`` and a synchronize. On an H100 a window has kept no device
    record at all, where the same call in the next window was recorded;
    with ``tries`` > 1 such a window is taken again (counted in
    PROFILE_RETRIES), up to ``tries`` windows in all, and the last one is
    returned whatever it kept."""
    from torch.profiler import ProfilerActivity, profile
    for attempt in range(tries):
        PROFILE_RETRIES["windows"] += attempt > 0
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        if device_busy_us(prof)[1]:
            break
    return prof


def device_profile(torch, fn, reps: int = 20, warmup: int = 3,
                   one_op: bool = False, tries: int = 1) -> dict:
    """What ``fn()`` ran on the card over ``reps`` calls, from
    torch.profiler: the names of the device operations, their count per
    call, and the device ms per call, their summed time over ``reps``. On
    an H100 the profiler sometimes records fewer operations than were
    launched (ctypes launches included), so for ``fn`` that is one device
    operation (``one_op``, held: the recorded ones share one name and are
    no more than the calls) the ms per call is their mean; and a window
    has recorded none (ms None; ``tries`` as in profiled)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    prof = profiled(torch, fn, reps, tries)
    events = [e for e in prof.events()
              if str(getattr(e, "device_type", "")).endswith("CUDA")]
    busy_us, n = device_busy_us(prof)
    names = sorted({e.name for e in events})
    if one_op and (len(names) > 1 or n > reps):
        raise AssertionError(f"not one device operation a call: {n} "
                             f"operations over {reps} calls, {names}")
    # A window that recorded nothing measured nothing (null in the lines).
    ms = (None if n == 0
          else (busy_us / n if one_op else busy_us / reps) / 1e3)
    return {"ms": ms, "ops_per_call": n / reps, "names": names}


def device_ms(torch, fn, reps: int = 20, warmup: int = 3,
              one_op: bool = False, tries: int = 1) -> float:
    """Device time per call of ``fn()`` in ms (``device_profile``). An
    event bracket around one call of a microsecond kernel measures the
    host's issue time instead, because the card waits for the launch."""
    return device_profile(torch, fn, reps, warmup, one_op, tries)["ms"]


def call_device_ms(torch, fn, reps: int = 10, warmup: int = 1,
                   tries: int = 1) -> dict:
    """Device ms of one call of ``fn()``, a library call of one or more
    device operations, from a torch.profiler window of ``reps`` calls. A
    window has kept the records of only some calls (torch.bmm at the ESS
    shape read 1/3 and 2/3 of its event time over 3 calls), and a window
    around one call has kept none, so the ms is each operation's mean
    record times its records a call (rounded, at least 1), summed over
    the operations; the records are beside it."""
    kby = device_by_name(torch, fn, reps=reps, warmup=warmup, tries=tries)
    ms = sum(v["ms_per_record"] * max(1, round(v["records"] / reps))
             for v in kby.values())
    return {"ms": ms if kby else None,
            "records": {name: v["records"] for name, v in kby.items()},
            "reps": reps}


def device_by_name(torch, fn, reps: int = 10, warmup: int = 2,
                   tries: int = 1) -> dict:
    """Device ms per call of ``fn()`` by device-operation name, from a
    torch.profiler window (a window that dropped records under-counts;
    the count of records each name got is beside it; ``tries`` as in
    profiled)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    prof = profiled(torch, fn, reps, tries)
    out = {}
    for e in prof.events():
        if not str(getattr(e, "device_type", "")).endswith("CUDA"):
            continue
        t = e.device_time if hasattr(e, "device_time") else e.cuda_time
        ms, n = out.get(e.name, (0.0, 0))
        out[e.name] = (ms + t / 1e3, n + 1)
    return {name: {"ms_per_record": ms / n, "records": n}
            for name, (ms, n) in out.items()}


def records_ms(kby, keep=lambda name: True):
    """The summed mean record of the kept names of a device_by_name
    reading: the device ms a call of a launch of several kernels; None when
    the window kept no record of any of them (it measured nothing)."""
    got = [v["ms_per_record"] for name, v in kby.items() if keep(name)]
    return sum(got) if got else None


def mean_of(readings):
    """Mean of the readings a profiler window gave (None: it recorded
    nothing), or None."""
    got = [x for x in readings if x is not None]
    return statistics.mean(got) if got else None


def close(name, got, want, rtol, atol) -> float:
    """Raise unless |got - want| <= atol + rtol |want| everywhere; return
    the max absolute error."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {got.shape} != {want.shape}")
    both_inf = np.isinf(got) & np.isinf(want) & (np.sign(got) ==
                                                 np.sign(want))
    err = np.where(both_inf, 0.0, np.abs(got - want))
    bad = ~(err <= atol + rtol * np.abs(np.where(both_inf, 0.0, want)))
    if bad.any():
        i = np.argwhere(bad)[0]
        raise AssertionError(f"{name}: {int(bad.sum())} entries off, first "
                             f"at {tuple(i)}: {got[tuple(i)]} vs "
                             f"{want[tuple(i)]}")
    return float(err.max()) if err.size else 0.0


# ---------------------------------------------------------------------------
# Kernels against their plain versions
# ---------------------------------------------------------------------------

def bits_equal(torch, x, y) -> bool:
    """torch.equal of the float32 tensors' bits (int32 views): +0.0 and
    -0.0 differ, a NaN equals the same NaN."""
    return x.shape == y.shape and torch.equal(x.view(torch.int32),
                                              y.view(torch.int32))


def same_bits(torch, x, y) -> bool:
    """bits_equal with every NaN as one code (NaN compared as NaN)."""
    def canon(t):
        return torch.where(torch.isnan(t), 0x7FC00000, t.view(torch.int32))
    return x.shape == y.shape and torch.equal(canon(x), canon(y))


def extremes_vs_plain(torch, tag, c, a, valid, q_lo, q_hi) -> None:
    """sample_extremes kernel against plain on the same CUDA inputs: both
    outputs bit-equal (NaN as NaN) to plain and across two launches."""
    from repro_torch.kernels.sample_extremes import (sample_extremes_cuda,
                                                     sample_extremes_plain)
    got = sample_extremes_cuda(c, a, valid, q_lo, q_hi)
    again = sample_extremes_cuda(c, a, valid, q_lo, q_hi)
    want = sample_extremes_plain(c, a, valid, q_lo, q_hi)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("min", "max"), got, again, want):
        if not same_bits(torch, g, g2):
            raise AssertionError(f"{tag}: sample_extremes {name} differs "
                                 "between two launches")
        if not same_bits(torch, g, w):
            n = int((g.view(torch.int32) != w.view(torch.int32)).sum())
            raise AssertionError(f"{tag}: sample_extremes {name} differs "
                                 f"from plain in {n} values")


def qe_vs_plain(torch, tag, leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi,
                base=None) -> float:
    """query_eval kernel against plain on the same CUDA inputs: rel equal,
    exact within rtol=3e-5, atol=1e-3 in the columns where the plain
    product is finite for every query (an empty leaf's +-inf times 0 is
    NaN there, and the first three columns always), a second launch
    bit-equal to the first and, with a baseline, to the baseline's kernel
    (NaN as NaN). Returns (the max absolute error of exact, the covered
    pairs)."""
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    rel, exact = query_eval_cuda(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi)
    rel2, exact2 = query_eval_cuda(leaf_lo, leaf_hi, leaf_agg, q_lo, q_hi)
    rel_p, exact_p = query_eval_plain(leaf_lo, leaf_hi, leaf_agg, q_lo,
                                      q_hi)
    torch.cuda.synchronize()
    if not (torch.equal(rel, rel2) and same_bits(torch, exact, exact2)):
        raise AssertionError(f"{tag}: query_eval differs between two "
                             "launches")
    if not torch.equal(rel, rel_p):
        n = int((rel != rel_p).sum())
        raise AssertionError(f"{tag}: query_eval rel differs in {n} pairs")
    if base is not None:
        rel_b, exact_b = baseline_query_eval(torch, base, leaf_lo, leaf_hi,
                                             leaf_agg, q_lo, q_hi)
        torch.cuda.synchronize()
        if not (torch.equal(rel, rel_b) and same_bits(torch, exact,
                                                      exact_b)):
            raise AssertionError(f"{tag}: query_eval differs from the "
                                 "baseline kernel")
    cols = [j for j in range(exact.shape[1])
            if j < 3 or bool(torch.isfinite(leaf_agg[:, j]).all())]
    return (close(f"{tag} query_eval exact", exact[:, cols].cpu(),
                  exact_p[:, cols].cpu(), K_RTOL, K_ATOL),
            int((rel == 2).sum()))


def moments_vs_plain(torch, tag, c, a, valid, q_lo, q_hi, base) -> float:
    """stratified_moments kernel against plain on the same CUDA inputs:
    counts equal, sums within rtol=3e-5, atol=1e-3; a second launch
    bit-equal to the first; with a baseline, baseline_moments_check (the
    first version's bits for s <= PAIR_CHUNK). Returns the max absolute
    error of the sums."""
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain)
    got = stratified_moments_cuda(c, a, valid, q_lo, q_hi)
    again = stratified_moments_cuda(c, a, valid, q_lo, q_hi)
    want = stratified_moments_plain(c, a, valid, q_lo, q_hi)
    torch.cuda.synchronize()
    if not bits_equal(torch, got, again):
        raise AssertionError(f"{tag}: stratified_moments differs between "
                             "two launches")
    if not torch.equal(got[..., 0], want[..., 0]):
        raise AssertionError(f"{tag}: stratified_moments counts differ")
    err = max(close(f"{tag} stratified_moments[{i}]", got[..., i].cpu(),
                    want[..., i].cpu(), K_RTOL, K_ATOL) for i in (1, 2))
    if base is not None:
        baseline_moments_check(torch, tag, got, base, c, a, valid, q_lo,
                               q_hi)
    return err


def baseline_moments_check(torch, tag, got, base, c, a, valid, q_lo, q_hi):
    """Row 2's result ``got`` (already held within tolerance of plain)
    against the baseline kernel's on the same inputs: bit-equal for
    s <= PAIR_CHUNK (one slot chunk: the first version's bits); above it
    the values that differ are counted (the chunk order's new bits).
    Returns that count."""
    from repro_torch.kernels.stratified_estimate import PAIR_CHUNK
    ref = baseline_pair(torch, base, "stratified_moments", c, a, valid, q_lo,
                        q_hi)
    torch.cuda.synchronize()
    differ = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
    s = int(a.shape[1])
    if s <= PAIR_CHUNK and differ:
        raise AssertionError(f"{tag}: stratified_moments differs from the "
                             f"baseline kernel in {differ} values")
    if s > PAIR_CHUNK:
        emit(check="row 2 against the baseline above one slot chunk",
             shape=tag, s=s, values=int(got.numel()), differing=differ)
    return differ


def kernel_vs_plain(torch, tag, leaf_lo, leaf_hi, leaf_agg, sample_c,
                    sample_a, sample_valid, q_lo, q_hi, base=None) -> dict:
    """The three serving kernels against their plain versions on the same
    CUDA inputs: query_eval as qe_vs_plain holds it, stratified_moments as
    moments_vs_plain, sample_extremes as extremes_vs_plain (bit-equal, so
    its error is 0). Returns the max absolute errors."""
    qe_err, covered = qe_vs_plain(torch, tag, leaf_lo, leaf_hi, leaf_agg,
                                  q_lo, q_hi, base)
    errs = {
        "query_eval": qe_err,
        "stratified_moments": moments_vs_plain(
            torch, tag, sample_c, sample_a, sample_valid, q_lo, q_hi, base),
        "sample_extremes": 0.0,
    }
    extremes_vs_plain(torch, tag, sample_c, sample_a, sample_valid, q_lo,
                      q_hi)
    emit(check="kernel_vs_plain", shape=tag, covered_pairs=covered,
         max_abs_err=errs,
         sample_extremes_bit_equal=True,
         baseline_bit_equal=None if base is None else True)
    return errs


def edge_cases(torch, dev, base) -> float:
    """Kernel = plain at shapes no block size divides, with inverted empty
    leaves, ragged validity, s = 1, several leaf tiles and slot chunks.
    Returns stratified_moments' max absolute error."""
    shapes = [(1, 1, 1, 1), (17, 5, 1, 3), (130, 53, 7, 3),
              (129, 257, 75, 1), (300, 600, 300, 2), (5, 9, 3, 16)]
    err = 0.0
    for Q, k, s, d in shapes:
        rng = np.random.default_rng(Q * 7919 + k)
        lo = rng.uniform(-1, 0.5, (k, d)).astype(np.float32)
        hi = lo + rng.uniform(0, 1, (k, d)).astype(np.float32)
        agg = rng.normal(0, 1, (k, 5)).astype(np.float32)
        agg[:, 2] = rng.integers(1, 50, k)
        if k > 2:
            lo[k // 2], hi[k // 2] = np.inf, -np.inf
            agg[k // 2] = [0, 0, 0, np.inf, -np.inf]
            hi[1] = lo[1] - 0.5
        c = rng.uniform(-1, 1, (k, s, d)).astype(np.float32)
        a = rng.normal(0, 3, (k, s)).astype(np.float32)
        valid = rng.random((k, s)) < 0.7
        valid[0] = False
        q_lo = rng.uniform(-1, 0, (Q, d)).astype(np.float32)
        q_hi = q_lo + rng.uniform(0, 1.5, (Q, d)).astype(np.float32)
        t = [torch.from_numpy(x).to(dev)
             for x in (lo, hi, agg, c, a, valid, q_lo, q_hi)]
        err = max(err, kernel_vs_plain(
            torch, f"edge Q={Q} k={k} s={s} d={d}", *t,
            base=base)["stratified_moments"])
    return err


# (Q, k, s, d) of stratified_moments' class cases: k = 64 writes 16-byte
# rows, k = 53 4-byte ones; s = 300 and 2500 stage the slots in several
# chunks; d = 16; Q ragged.
MOMENT_CLASS_CASES = ((129, 64, 75, 1), (129, 53, 75, 3), (33, 64, 300, 2),
                      (33, 53, 2500, 3), (40, 64, 75, 16))


def edge_cases_moments(torch, dev, base) -> float:
    """stratified_moments where covered, empty and mixed pairs all appear
    (weighted_class_inputs, the weights ignored; strata 0 and k // 2 without
    a valid slot), each case printing its counts; then the first two cases
    again with NaN coordinates on valid slots: one slot of a stratum all
    of whose other samples query 0 holds, and column 0 of every slot of
    another stratum. The slot test rejects NaN, so neither stratum is
    covered by any query: the kernel must walk the first and skip the
    second. Returns the max absolute error of the sums."""
    err = 0.0
    cases = [(shape, False) for shape in MOMENT_CLASS_CASES] + \
        [(shape, True) for shape in MOMENT_CLASS_CASES[:2]]
    for (Q, k, s, d), nan in cases:
        rng = np.random.default_rng(Q * 131 + k * 17 + s + d)
        c, a, valid, _, q_lo, q_hi = weighted_class_inputs(rng, Q, k, s, d,
                                                           1)
        nan_strata = []
        if nan:
            full = [i for i in range(k) if valid[i].sum() >= 2]
            l1, l2 = full[0], full[1]
            c[l1, np.flatnonzero(valid[l1])[0], 0] = np.nan
            c[l2, :, 0] = np.nan
            nan_strata = [l1, l2]
        t = [torch.from_numpy(x).to(dev) for x in (c, a, valid, q_lo, q_hi)]
        tag = f"edge moment classes Q={Q} k={k} s={s} d={d} nan={nan}"
        classes = pair_classes(torch, t[0], t[2], t[3], t[4])
        if min(classes.values()) == 0:
            raise AssertionError(f"{tag}: a pair class is missing: {classes}")
        if nan:
            n0 = samples_in(torch, t, 0)
            if not (0 < n0[l1] < int(valid[l1].sum()) and n0[l2] == 0):
                raise AssertionError(f"{tag}: the NaN strata are not mixed "
                                     "and empty under query 0")
        e = moments_vs_plain(torch, tag, *t, base)
        err = max(err, e)
        emit(check="edge_moment_classes", case=tag, **classes,
             nan_strata=nan_strata, max_abs_err=e,
             baseline_bit_equal=None if base is None else s <= 2048)
    return err


def chunk_case(rng, Q, k, s, d, nan=False, special=False, chunk=None):
    """Inputs above one slot chunk of ``chunk`` slots (rows 2 and 8's
    PAIR_CHUNK by default; as tests/test_torch_pair_chunks.py builds them):
    each stratum's samples in its own cell of a grid over
    [0, 1)^d, chunk j of its slots in the j-th band of the cell in column 0,
    so that query edges cover some chunks of a stratum, miss others and cut
    the rest; ragged validity, stratum k // 2 without a valid slot (k > 2).
    Query 0 covers everything, 1 misses everything, 2 is inverted, 3 spans
    the first band of stratum 0's cell. ``nan``: a NaN coordinate on a
    valid slot of the last chunk of the last stratum, NaN in column 0 of
    stratum 1's first chunk. ``special``: NaN, +-inf, +-F32_MAX and +-0.0
    values (row 8 only)."""
    from repro_torch.kernels.stratified_estimate import PAIR_CHUNK
    C = chunk or PAIR_CHUNK
    n_ch = -(-s // C)
    cells = max(2, int(np.ceil(k ** (1 / d))))
    cell = np.stack(np.unravel_index(np.arange(k) % cells ** d,
                                     (cells,) * d), -1).astype(np.float32)
    u = rng.uniform(0.05, 0.95, (k, s, d))
    band = (np.arange(s) // C)[None, :]
    u[..., 0] = (band + rng.uniform(0.05, 0.95, (k, s))) / n_ch
    c = ((cell[:, None, :] + u) / cells).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    if k > 2:
        valid[k // 2] = False
    if special:
        w = rng.random((k, s))
        for lo, hi, x in ((0.0, 0.04, np.nan), (0.04, 0.07, np.inf),
                          (0.07, 0.10, -np.inf), (0.10, 0.13, F32_MAX),
                          (0.13, 0.16, -F32_MAX), (0.16, 0.22, -0.0),
                          (0.22, 0.28, 0.0)):
            a[(w >= lo) & (w < hi)] = x
    starts = rng.integers(0, cells, (Q, d)).astype(np.float32)
    spans = rng.integers(1, 3, (Q, d)).astype(np.float32)
    edge_lo = rng.integers(0, n_ch + 1, (Q, d)) / n_ch
    edge_hi = rng.integers(0, n_ch + 1, (Q, d)) / n_ch
    q_lo = ((starts + edge_lo * 0.9) / cells).astype(np.float32)
    q_hi = ((starts + spans - 1 + 0.05 + edge_hi * 0.9) / cells
            ).astype(np.float32)
    q_lo[0], q_hi[0] = -1.0, 2.0
    q_lo[1], q_hi[1] = 5.0, 6.0
    q_lo[2], q_hi[2] = 0.6, 0.4
    q_lo[3], q_hi[3] = 0.0, 1.0 / cells
    q_hi[3, 0] = (1.0 / n_ch) / cells
    if nan:
        on = np.flatnonzero(valid[k - 1, (n_ch - 1) * C:]) + (n_ch - 1) * C
        if on.size:
            c[k - 1, on[0], d - 1] = np.nan
        if k > 1:
            c[1, :C, 0] = np.nan
    return c, a, valid, q_lo, q_hi


def chunk_classes(torch, c, valid, q_lo, q_hi, chunk=None) -> list:
    """pair_classes of each slot chunk of ``chunk`` slots (PAIR_CHUNK by
    default) on its own: the (query, stratum, chunk) triples' classes, one
    dict a chunk."""
    from repro_torch.kernels.stratified_estimate import PAIR_CHUNK
    C = chunk or PAIR_CHUNK
    s = c.shape[1]
    return [pair_classes(torch, c[:, s0:s0 + C].contiguous(),
                         valid[:, s0:s0 + C].contiguous(), q_lo, q_hi)
            for s0 in range(0, s, C)]


def rows_vs_batch(torch, tag, fn, sm, q_lo, q_hi, subsets) -> None:
    """``fn(*sm, lo, hi)`` of each query subset (a slice) bit-equal (NaN as
    NaN) to the same rows of the whole batch's: a pair's bits do not
    depend on its batch."""
    full = fn(*sm, q_lo, q_hi)
    full = full if isinstance(full, tuple) else (full,)
    for sl in subsets:
        part = fn(*sm, q_lo[sl].contiguous(), q_hi[sl].contiguous())
        part = part if isinstance(part, tuple) else (part,)
        for x, y in zip(part, full):
            if not same_bits(torch, x, y[sl]):
                raise AssertionError(f"{tag}: rows {sl.start}-{sl.stop - 1} "
                                     "alone differ from the same rows of the "
                                     "batch")


# (Q, k, s, d) of the cases above one slot chunk: s off and on its
# multiples, k = 1 (every pair one stratum), 3, 17, 53 and 64, d = 1, 3, 16.
CHUNK_CASES = ((200, 1, 2049, 1), (37, 3, 4103, 3), (130, 17, 2500, 16),
               (129, 64, 6151, 1), (33, 53, 4096, 3), (300, 1, 38_500, 1))


def edge_cases_chunks(torch, dev, base) -> dict:
    """Rows 2 and 8 above one slot chunk (CHUNK_CASES; row 2 on finite
    values, row 8 on special ones too; NaN coordinates on every other
    case): each chunk's classes printed (all three in some chunk of every
    case with queries and strata to make them), row 2 within tolerance of
    plain and row 8 bit-equal (moments_vs_plain, extremes_vs_plain, each
    also across two launches), rows of query 0 and of a slice alone
    bit-equal to the batch's. Returns the max absolute error of row 2."""
    from repro_torch.kernels.sample_extremes import sample_extremes_cuda
    from repro_torch.kernels.stratified_estimate import stratified_moments_cuda
    err = 0.0
    for i, (Q, k, s, d) in enumerate(CHUNK_CASES):
        for row in (2, 8):
            rng = np.random.default_rng(Q * 31 + k * 7 + s + d + row)
            t = [torch.from_numpy(x).to(dev) for x in chunk_case(
                rng, Q, k, s, d, nan=i % 2 == 0, special=row == 8)]
            tag = f"edge chunks row {row} Q={Q} k={k} s={s} d={d}"
            per_chunk = chunk_classes(torch, t[0], t[2], t[3], t[4])
            if k > 1 and not any(min(x.values()) > 0 for x in per_chunk):
                raise AssertionError(f"{tag}: no chunk holds all three "
                                     f"classes: {per_chunk}")
            subsets = (slice(0, 1), slice(Q // 3, Q - 1))
            if row == 2:
                e = moments_vs_plain(torch, tag, *t, base)
                err = max(err, e)
                rows_vs_batch(torch, tag, stratified_moments_cuda, t[:3],
                              t[3], t[4], subsets)
            else:
                e = 0.0
                extremes_vs_plain(torch, tag, *t)
                rows_vs_batch(torch, tag, sample_extremes_cuda, t[:3], t[3],
                              t[4], subsets)
            emit(check="edge_chunk_classes", case=tag,
                 chunk_classes=per_chunk, max_abs_err=e)
    return {"err": err, "cases": 2 * len(CHUNK_CASES)}


F32_MAX = np.float32(3.4028235e38)


def extremes_case(rng, Q, k, s, d, nan=False, special=False):
    """sample_extremes inputs where covered, empty and mixed pairs all
    appear: each stratum's samples in its own cell of a grid over [0, 1)^d,
    ragged validity, strata 0 and k // 2 without a valid slot; query 0
    covers every sample, 1 misses everything, 2 is inverted, 3's edges are
    stratum 1's extremes, the rest span a few cells. ``special`` puts NaN,
    +-inf, values beyond +-BIG and +-0.0 on valid and invalid slots, and
    two full strata of +0.0 and -0.0 in either order; ``nan`` a NaN
    coordinate on a valid slot of stratum 1 and column 0 of every slot of
    stratum 2 NaN (as tests/test_torch_extremes.py builds them)."""
    cells = max(2, int(np.ceil(k ** (1 / d))))
    cell = np.stack(np.unravel_index(np.arange(k) % cells ** d,
                                     (cells,) * d), -1).astype(np.float32)
    c = ((cell[:, None, :] + rng.uniform(0.1, 0.9, (k, s, d))) / cells
         ).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    valid[0] = False
    valid[k // 2] = False
    if special:
        u = rng.random((k, s))
        for lo, hi, x in ((0.0, 0.04, np.nan), (0.04, 0.07, np.inf),
                          (0.07, 0.10, -np.inf), (0.10, 0.13, F32_MAX),
                          (0.13, 0.16, -F32_MAX), (0.16, 0.22, -0.0),
                          (0.22, 0.28, 0.0)):
            a[(u >= lo) & (u < hi)] = x
        for leaf, vals in ((k - 1, (0.0, -0.0)), (k - 2, (-0.0, 0.0))):
            if leaf > k // 2:
                valid[leaf] = True
                a[leaf] = np.resize(np.float32(vals), s)
    if nan:
        valid[1, :2] = True
    starts = rng.integers(0, cells, (Q, d))
    spans = rng.integers(1, 3, (Q, d))
    q_lo = (starts / cells + rng.uniform(-0.05, 0.05, (Q, d))
            ).astype(np.float32)
    q_hi = ((starts + spans) / cells + rng.uniform(-0.05, 0.05, (Q, d))
            ).astype(np.float32)
    q_lo[0], q_hi[0] = -1.0, 2.0
    if Q > 1:
        q_lo[1], q_hi[1] = 5.0, 6.0
    if Q > 2:
        q_lo[2], q_hi[2] = 0.6, 0.4
    if Q > 3 and valid[1].any():
        q_lo[3] = c[1][valid[1]].min(0)
        q_hi[3] = c[1][valid[1]].max(0)
    if nan:
        c[1, 0, 0] = np.nan
        c[2, :, 0] = np.nan
    return c, a, valid, q_lo, q_hi


# (Q, k, s, d, nan, special) of sample_extremes' edge cases: ragged Q and
# k, s = 1, s up to 2500 (several staged chunks), d up to 16, k = 64 (16-byte
# rows) and 53 (4-byte ones).
EXTREMES_CASES = ((1, 1, 1, 1, False, False), (17, 5, 1, 3, False, True),
                  (130, 53, 7, 3, False, True),
                  (129, 257, 75, 1, False, True),
                  (300, 600, 300, 2, True, True),
                  (5, 9, 3, 16, True, False), (129, 64, 75, 1, True, True),
                  (33, 53, 2500, 3, False, True),
                  (40, 64, 75, 16, True, True), (2049, 1024, 75, 3, False,
                                                 True))


def edge_cases_extremes(torch, dev) -> int:
    """sample_extremes kernel = plain bit for bit (NaN as NaN), and across
    two launches, at EXTREMES_CASES, each printing its pair classes (all
    three must appear where there are queries, strata and slots to make
    them). Returns the number of cases."""
    for Q, k, s, d, nan, special in EXTREMES_CASES:
        rng = np.random.default_rng(Q * 13 + k * 7 + s + d)
        t = [torch.from_numpy(x).to(dev)
             for x in extremes_case(rng, Q, k, s, d, nan, special)]
        tag = (f"edge extremes Q={Q} k={k} s={s} d={d} nan={nan} "
               f"special={special}")
        classes = pair_classes(torch, t[0], t[2], t[3], t[4])
        if Q > 3 and k > 3 and s > 1 and min(classes.values()) == 0:
            raise AssertionError(f"{tag}: a pair class is missing: {classes}")
        extremes_vs_plain(torch, tag, *t)
        emit(check="edge_extremes", case=tag, **classes, bit_equal=True)
    return len(EXTREMES_CASES)


def qe_case(rng, Q, k, d, A, mode):
    """query_eval inputs: leaf boxes on [-1, 1.5), an inverted +-inf empty
    leaf with +-inf MIN/MAX aggregates and a finite inverted box; ``mode``
    "mixed" (random query boxes), "all" (every leaf covered but the
    inverted ones), "none" (boxes that cover no leaf) or "nan" (NaN in a
    leaf box and in some query bounds)."""
    lo = rng.uniform(-1, 0.5, (k, d)).astype(np.float32)
    hi = lo + rng.uniform(0.01, 1, (k, d)).astype(np.float32)
    agg = rng.normal(0, 1, (k, A)).astype(np.float32)
    if k > 2:
        lo[k // 2], hi[k // 2] = np.inf, -np.inf
        agg[k // 2, 3:] = np.inf
        hi[1] = lo[1] - 0.5
    q_lo = rng.uniform(-1.2, 0, (Q, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0, 2.5, (Q, d)).astype(np.float32)
    if mode == "all":
        q_lo[:], q_hi[:] = -9.0, 9.0
    elif mode == "none":
        q_hi = q_lo + np.float32(1e-3)
    elif mode == "nan":
        q_lo[::2], q_hi[::2] = -9.0, 9.0
        lo[0, 0] = np.nan
        hi[min(2, k - 1), d - 1] = np.nan
        q_lo[::3, 0] = np.nan
        q_hi[1::3, d - 1] = np.nan
    return lo, hi, agg, q_lo, q_hi


# (Q, k, d, A, mode) of query_eval's edge cases: one query and one leaf; k
# off every multiple of 32 and of the 1024-leaf tile; A from 1 to 8; every
# leaf covered and none; NaN boxes and bounds; Q past one query a block.
QE_CASES = ((1, 1, 1, 1, "mixed"), (7, 31, 1, 2, "mixed"),
            (130, 33, 3, 3, "mixed"), (65, 1023, 2, 4, "mixed"),
            (65, 1025, 1, 5, "all"), (300, 2049, 3, 6, "mixed"),
            (9, 100, 16, 7, "nan"), (2048, 1024, 1, 8, "none"),
            (4097, 1000, 3, 5, "all"), (129, 1024, 16, 8, "nan"),
            (2048, 1024, 3, 5, "mixed"))


def edge_cases_query_eval(torch, dev, base) -> float:
    """query_eval at QE_CASES as qe_vs_plain holds it: rel equal to plain,
    exact within tolerance of plain and bit-equal to the baseline's. Each
    case prints its covered pairs. Returns the max absolute error."""
    err = 0.0
    for Q, k, d, A, mode in QE_CASES:
        rng = np.random.default_rng(Q * 17 + k * 3 + d + A)
        t = [torch.from_numpy(x).to(dev)
             for x in qe_case(rng, Q, k, d, A, mode)]
        tag = f"edge query_eval Q={Q} k={k} d={d} A={A} {mode}"
        e, covered = qe_vs_plain(torch, tag, *t, base)
        err = max(err, e)
        if (mode == "none" and covered) or (mode == "all" and not covered):
            raise AssertionError(f"{tag}: {covered} covered pairs")
        emit(check="edge_query_eval", case=tag, covered_pairs=covered,
             pairs=Q * k,
             max_abs_err=e, baseline_bit_equal=None if base is None
             else True)
    return err


def samples_in(torch, t, q) -> list:
    """Per stratum, the valid samples that query q's box holds."""
    from repro_torch.kernels.stratified_estimate import samples_inside
    c, _, valid, q_lo, q_hi = t
    return samples_inside(c, valid, q_lo[q:q + 1], q_hi[q:q + 1])[0].sum(
        -1).tolist()


def seg_vs_plain(torch, tag, v, ids, k, base=None) -> tuple:
    """segment_reduce kernel against plain on the same CUDA inputs: counts,
    min and max bit-equal (the MIN/MAX under the reference's signed-zero
    rule), sums within rtol=3e-5, atol=1e-3; a second launch bit-equal to
    the first and, with a baseline, to the baseline's kernel but for ties
    of +0.0 and -0.0 in the MIN/MAX columns, which a baseline from before
    the rule may break the other way. Returns (the max absolute error of
    the sums, the MIN/MAX entries that differ from the baseline's by the
    sign of a zero alone)."""
    from repro_torch.kernels.segment_reduce import (segment_reduce_cuda,
                                                    segment_reduce_plain)
    got = segment_reduce_cuda(v, ids, k)
    again = segment_reduce_cuda(v, ids, k)
    want = segment_reduce_plain(v, ids, k)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{tag}: segment_reduce differs between two "
                             "launches")
    if not bits_equal(torch, got[:, 2:], want[:, 2:]):
        n = int((got[:, 2:].view(torch.int32)
                 != want[:, 2:].view(torch.int32)).sum())
        raise AssertionError(f"{tag}: segment_reduce count/min/max differ "
                             f"in {n} entries")
    ties = 0
    if base is not None:
        ref = baseline_segment(torch, base, v, ids, k)
        differ = got.view(torch.int32) != ref.view(torch.int32)
        zero_tie = (got == 0) & (ref == 0)
        zero_tie[:, :3] = False
        if bool((differ & ~zero_tie).any()):
            raise AssertionError(f"{tag}: segment_reduce differs from the "
                                 "baseline kernel beyond +-0.0 ties")
        ties = int(differ.sum())
    err = max(close(f"{tag} segment_reduce[{i}]", got[:, i].cpu(),
                    want[:, i].cpu(), K_RTOL, K_ATOL) for i in (0, 1))
    return err, ties


def route_vs_plain(torch, tag, lo, hi, c, base=None) -> None:
    """route_multid kernel against plain: leaf equal and dist bit-equal, a
    second launch bit-equal to the first and, with a baseline, both
    bit-equal to the baseline's kernel."""
    from repro_torch.kernels.route import (route_multid_cuda,
                                           route_multid_plain)
    leaf, dist = route_multid_cuda(lo, hi, c)
    leaf2, dist2 = route_multid_cuda(lo, hi, c)
    leaf_p, dist_p = route_multid_plain(lo, hi, c)
    torch.cuda.synchronize()
    if not (torch.equal(leaf, leaf2) and bits_equal(torch, dist, dist2)):
        raise AssertionError(f"{tag}: route_multid differs between two "
                             "launches")
    if not (torch.equal(leaf, leaf_p) and bits_equal(torch, dist, dist_p)):
        n = int((leaf != leaf_p).sum())
        m = int((dist.view(torch.int32) != dist_p.view(torch.int32)).sum())
        raise AssertionError(f"{tag}: route_multid differs from plain in "
                             f"{n} leaves and {m} distances")
    if base is not None:
        leaf_b, dist_b = baseline_route(torch, base, lo, hi, c)
        if not (torch.equal(leaf, leaf_b) and bits_equal(torch, dist,
                                                         dist_b)):
            raise AssertionError(f"{tag}: route_multid differs from the "
                                 "baseline kernel")


def route_case(rng, B, k, d, case="grid"):
    """Route inputs: boxes on a coarse grid (touching, rows on shared
    faces), a copy of box 0 at the last leaf (ties), an inverted +-inf box;
    ``signed-zero`` adds +-0.0 faces and rows (box 0 = [-0.0, 1]^d and a
    quarter of the rows at +0.0); ``group-ties`` copies box 0 onto the
    first leaf of every leaf group of the wrapper's plan
    (route_launch_plan) and, above 16 columns, box k // 3 onto both sides
    of every warp sub-range's edge (route_warp_ranges), with a quarter of
    the rows inside it: their least distance in several sub-ranges and
    cluster ranks."""
    from repro_torch.kernels.route import (route_groups, route_launch_plan,
                                           route_warp_ranges)
    lo = rng.integers(0, 8, (k, d)).astype(np.float32)
    hi = lo + rng.integers(0, 3, (k, d)).astype(np.float32)
    if k > 2:
        lo[k - 1], hi[k - 1] = lo[0], hi[0]
        lo[k // 2], hi[k // 2] = np.inf, -np.inf
    c = np.where(rng.random((B, d)) < 0.5,
                 rng.integers(-2, 12, (B, d)),
                 rng.uniform(-2, 12, (B, d))).astype(np.float32)
    if case == "signed-zero":
        lo[rng.random((k, d)) < 0.3] = -0.0
        hi[rng.random((k, d)) < 0.1] = 0.0
        hi = np.maximum(hi, lo)
        lo[0], hi[0] = -0.0, 1.0
        c[rng.random((B, d)) < 0.3] = -0.0
        c[rng.random((B, d)) < 0.3] = 0.0
        c[:B // 4] = 0.0
        if k > 2:
            lo[k // 2], hi[k // 2] = np.inf, -np.inf
    elif case == "group-ties":
        _, g, lg = route_launch_plan(B, k, d)
        for rg in route_groups(k, g, lg)[1:]:
            if len(rg):
                lo[rg.start], hi[rg.start] = lo[0], hi[0]
        if d > 16 and k > 3:
            x = k // 3
            for ranges in route_warp_ranges(k, g, lg):
                for rg in ranges:
                    for at in (rg.start - 1, rg.start):
                        if 0 < at < k and at not in (x, k // 2):
                            lo[at], hi[at] = lo[x], hi[x]
            c[:B // 4] = lo[x] + 0.5 * (hi[x] - lo[x])
    return lo, hi, c


def edge_cases_streaming(torch, dev, base=None) -> dict:
    """The streaming kernels against plain at edge shapes: segment_reduce
    over N in {1, 17, 4096, 65537} x k in {1, 53, 1024} with -1 ids, empty
    segments and all rows in one segment; route_multid over B in {1, 255,
    4096} x k in {1, 129, 1024} x d in {2, 3, 16} with duplicate boxes,
    +-inf empty boxes and rows inside several touching boxes, then +-0.0
    faces and rows, equal boxes across leaf groups, k below, at and above
    multiples of the group count (8 at B = 4096) and of the group size,
    and B off the row tile; then rows with NaN and +-inf coordinates (d in
    {2, 3, 16, 24}: 24 through the wide kernel), where kernel and plain
    differ (counted) and the kernel must give the baseline's bits (at 24
    a baseline with wide kernels)."""
    from repro_torch.kernels.route import (route_multid_cuda,
                                           route_multid_plain)
    seg_err = 0.0
    cases = zero_ties = 0
    for n in (1, 17, 4096, 65537):
        for k in (1, 53, 1024):
            rng = np.random.default_rng(n * 31 + k)
            # positive values like the stream's trip distances: a
            # mean-zero column cancels, and its fp32 sum then differs
            # between summation orders by more than any relative bar
            v = rng.lognormal(0.9, 0.8, n).astype(np.float32)
            # ids in [-1, k + 2): -1 and out-of-range rows are dropped;
            # with k = 1024 most segments stay empty at small n
            ids = rng.integers(-1, k + 2, n).astype(np.int32)
            one = np.full(n, min(k - 1, 7), np.int32)
            for label, idv in (("mixed", ids), ("one segment", one)):
                e, t = seg_vs_plain(torch, f"edge N={n} k={k} {label}",
                                    torch.from_numpy(v).to(dev),
                                    torch.from_numpy(idv).to(dev), k, base)
                seg_err, zero_ties = max(seg_err, e), zero_ties + t
                cases += 1
    # Signed zeros: values +0.0 and -0.0 (and a few others) in segments
    # that meet both, in either order; MIN/MAX bit-equal to the repaired
    # plain version, their ties counted against the baseline.
    zero_cases = 0
    for n, k in ((4, 2), (4096, 53), (4096, 1024), (65537, 1024)):
        rng = np.random.default_rng(n + 3 * k)
        v = rng.choice(np.float32([0.0, -0.0, 1.5, -2.0]), n,
                       p=[0.45, 0.45, 0.05, 0.05])
        if n == 4:
            v = np.float32([0.0, -0.0, -0.0, 0.0])
        ids = (np.int32([0, 0, 1, 1]) if n == 4
               else rng.integers(-1, k, n).astype(np.int32))
        e, t = seg_vs_plain(torch, f"edge signed zeros N={n} k={k}",
                            torch.from_numpy(v).to(dev),
                            torch.from_numpy(ids).to(dev), k, base)
        seg_err, zero_ties = max(seg_err, e), zero_ties + t
        zero_cases += 1
    route = [(B, k, d, "grid") for B in (1, 255, 4096) for k in (1, 129, 1024)
             for d in (2, 3, 16)]
    route += [(4096, 1024, 3, "signed-zero"), (257, 53, 16, "signed-zero"),
              (4096, 1024, 2, "signed-zero"), (4096, 1024, 3, "group-ties"),
              (65536, 1025, 3, "group-ties"), (300, 41, 16, "group-ties")]
    # group count 8 at B = 4096: k < 8, = 8, = 9; group sizes of 128 and
    # 256 leaves (the staging tile) and one off
    route += [(4096, k, 3, "group-ties")
              for k in (1, 7, 8, 9, 1023, 1025, 2047, 2048, 2049)]
    # B off the row tile (64 rows a thread-row, 2 or 4 rows a thread)
    route += [(B, 1024, 3, "grid") for B in (127, 129, 4097, 65535)]
    for B, k, d, case in route:
        rng = np.random.default_rng(B * 7 + k * 3 + d)
        route_vs_plain(torch, f"edge B={B} k={k} d={d} {case}",
                       *(torch.from_numpy(x).to(dev)
                         for x in route_case(rng, B, k, d, case)), base)
    nonfinite = {}
    for d in (2, 3, 16, 24):
        rng = np.random.default_rng(97 + d)
        B, k = 4096, 1024
        lo, hi, c = route_case(rng, B, k, d)
        u = rng.random((B, d))
        c[u < 0.05] = np.nan
        c[(u >= 0.05) & (u < 0.1)] = np.inf
        c[(u >= 0.1) & (u < 0.15)] = -np.inf
        t = [torch.from_numpy(x).to(dev) for x in (lo, hi, c)]
        leaf, dist = route_multid_cuda(*t)
        leaf2, dist2 = route_multid_cuda(*t)
        leaf_p, dist_p = route_multid_plain(*t)
        torch.cuda.synchronize()
        if not (torch.equal(leaf, leaf2) and bits_equal(torch, dist,
                                                        dist2)):
            raise AssertionError(f"non-finite rows d={d}: route_multid "
                                 "differs between two launches")
        finite = torch.isfinite(t[2]).all(1)
        if not (torch.equal(leaf[finite], leaf_p[finite]) and bits_equal(
                torch, dist[finite], dist_p[finite])):
            raise AssertionError(f"non-finite rows d={d}: route_multid "
                                 "differs from plain on the finite rows")
        held = base is not None and (d <= 16 or has_wide(base))
        if held:
            leaf_b, dist_b = baseline_route(torch, base, *t)
            if not (torch.equal(leaf, leaf_b) and bits_equal(torch, dist,
                                                             dist_b)):
                raise AssertionError(f"non-finite rows d={d}: route_multid "
                                     "differs from the baseline kernel")
        nonfinite[d] = {
            "rows": int((~finite).sum()),
            "leaf_differs_from_plain": int((leaf != leaf_p).sum()),
            "dist_differs_from_plain": int(
                (dist.view(torch.int32) != dist_p.view(torch.int32)).sum()),
            "baseline_bit_equal": True if held else None}
    emit(check="edge_streaming_kernels", segment_reduce_cases=cases,
         segment_reduce_signed_zero_cases=zero_cases,
         segment_reduce_baseline_zero_ties=None if base is None
         else zero_ties,
         route_multid_cases=len(route), segment_reduce_max_abs_err=seg_err,
         route_multid_nonfinite=nonfinite,
         baseline_bit_equal=None if base is None else True)
    return {"seg_err": seg_err, "route_cases": len(route),
            "nonfinite": nonfinite, "seg_zero_cases": zero_cases,
            "seg_zero_ties": None if base is None else zero_ties}


# ---------------------------------------------------------------------------
# Truth and the answer checks
# ---------------------------------------------------------------------------

def truth_1d(c, a, q_lo, q_hi) -> dict:
    """Exact answers of 1-D queries over the sorted column: float64 prefix
    sums for SUM/COUNT, slices for MIN/MAX. Membership is decided on the
    float32 coordinates against the float32 bounds, as the card stores
    them."""
    c32 = c.astype(np.float32)
    prefix = np.concatenate([[0.0], np.cumsum(a, dtype=np.float64)])
    lo_i = np.searchsorted(c32, q_lo[:, 0], side="left")
    hi_i = np.searchsorted(c32, q_hi[:, 0], side="right")
    hi_i = np.maximum(hi_i, lo_i)
    s = prefix[hi_i] - prefix[lo_i]
    cnt = (hi_i - lo_i).astype(np.float64)
    mn = np.array([a[i:j].min() if j > i else np.inf
                   for i, j in zip(lo_i, hi_i)])
    mx = np.array([a[i:j].max() if j > i else -np.inf
                   for i, j in zip(lo_i, hi_i)])
    return {"sum": s, "count": cnt, "avg": s / np.maximum(cnt, 1),
            "min": mn, "max": mx}


def truth_scan(torch, c, a, q_lo, q_hi, chunk: int = 1 << 20) -> dict:
    """Exact answers by a chunked float64 scan of every row on the card,
    independent of the engine; membership on float32 coordinates."""
    dev = torch.device("cuda")
    lo = torch.from_numpy(q_lo).to(dev)[:, None, :]
    hi = torch.from_numpy(q_hi).to(dev)[:, None, :]
    Q = q_lo.shape[0]
    s = torch.zeros(Q, dtype=torch.float64, device=dev)
    cnt = torch.zeros(Q, dtype=torch.float64, device=dev)
    mn = torch.full((Q,), float("inf"), dtype=torch.float64, device=dev)
    mx = torch.full((Q,), float("-inf"), dtype=torch.float64, device=dev)
    for start in range(0, c.shape[0], chunk):
        cc = torch.from_numpy(c[start:start + chunk].astype(np.float32)
                              ).to(dev)[None]
        aa = torch.from_numpy(a[start:start + chunk]).to(dev)[None]
        pred = ((lo <= cc) & (cc <= hi)).all(-1)              # (Q, chunk)
        s += torch.where(pred, aa, 0.0).sum(1)
        cnt += pred.sum(1)
        mn = torch.minimum(mn, torch.where(pred, aa, float("inf")).amin(1))
        mx = torch.maximum(mx, torch.where(pred, aa, float("-inf")).amax(1))
    s, cnt, mn, mx = (x.cpu().numpy() for x in (s, cnt, mn, mx))
    return {"sum": s, "count": cnt, "avg": s / np.maximum(cnt, 1),
            "min": mn, "max": mx}


def host(x) -> np.ndarray:
    """A tensor (on any device) or a host array as numpy."""
    return x.cpu().numpy() if hasattr(x, "cpu") else np.asarray(x)


def truth_inside(tag, res, truth, n, kinds=KINDS) -> None:
    """Every defined truth inside [lower, upper]: SUM/COUNT always, AVG/
    MIN/MAX on non-empty queries (undefined on an empty set). Slack for
    the float32 storage of aggregates: 1e-4 relative for the fp32 sums over
    up to 1024 strata (SUM/COUNT/AVG), 1e-6 for MIN/MAX (one rounding).
    ``res`` holds tensors or host arrays."""
    nonempty = truth["count"] > 0
    for kind in kinds:
        t = truth[kind]
        lo = host(res[kind].lower[:n]).astype(np.float64)
        hi = host(res[kind].upper[:n]).astype(np.float64)
        slack = (1e-4 if kind in ("sum", "count", "avg") else 1e-6) \
            * np.abs(t) + 1e-6
        defined = np.ones(n, bool) if kind in ("sum", "count") else nonempty
        inside = (lo - slack <= t) & (t <= hi + slack)
        if not inside[defined].all():
            i = int(np.argwhere(defined & ~inside)[0, 0])
            raise AssertionError(f"{tag} {kind}: truth {t[i]} outside "
                                 f"[{lo[i]}, {hi[i]}] at query {i}")


def check_truth(tag, res, truth, n, max_median_err, kinds=KINDS) -> dict:
    """The truth inside [lower, upper] (``truth_inside``), the median SUM
    relative error at most ``max_median_err``, and the CI coverage."""
    nonempty = truth["count"] > 0
    out = {"queries": n, "nonempty": int(nonempty.sum())}
    truth_inside(tag, res, truth, n, kinds)
    est = res["sum"].estimate[:n].cpu().numpy().astype(np.float64)
    t = truth["sum"]
    err = np.abs(est - t)[nonempty] / np.abs(t[nonempty])
    med = float(np.median(err)) if err.size else 0.0
    out["sum_median_rel_err"] = med
    if med > max_median_err:
        raise AssertionError(f"{tag}: median SUM relative error {med} > "
                             f"{max_median_err}")
    ci_in = [float(np.mean(((res[k].ci_lo[:n].cpu().numpy() <= t * 1.00001)
                            & (t * 0.99999 <= res[k].ci_hi[:n].cpu().numpy())
                            )[nonempty]))
             for k, t in ((k, truth[k]) for k in ("sum", "count", "avg"))]
    out["ci95_coverage_sum_count_avg"] = ci_in
    return out


def check_cpu_parity(torch, tag, syn, q, res, n: int = 512, kinds=KINDS,
                     ci=0.95, plan: bool = False, **serving_kw) -> None:
    """The same answer computed by the port on the CPU, for the first n
    queries (from a plan of those queries when ``plan``). estimate/lower/
    upper/frac_rows_touched at rtol=3e-5 with atol 3e-5 * max|estimate|
    (fp32 sums in another order); ci_half/ci_lo/ci_hi at rtol=1e-4 with
    atol 1e-4 * max|estimate| (differences of two fp32 sums lose relative
    precision). A bootstrap ``ci`` draws the same weights on both devices,
    so its replicates too differ only in summation order. ``serving_kw``
    goes to ServingConfig; an interval field absent (None) on both sides
    is skipped."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.types import QueryBatch
    from repro_torch.engine.planner import plan_queries
    qc = QueryBatch(q.lo[:n].cpu(), q.hi[:n].cpu())
    syn_c = syn.to("cpu")
    eng = PassEngine(syn_c, ServingConfig(kinds=kinds, **serving_kw), ci=ci,
                     device="cpu")
    cpu = eng.answer(qc, plan=plan_queries(syn_c.tree, qc.lo, qc.hi,
                                           syn_c.num_leaves)
                     if plan else None)
    for kind in kinds:
        # Scale of the batch: empty queries' MIN/MAX estimates sit at the
        # +-3.4e38 sentinel and must not set it.
        want_est = np.abs(cpu[kind].estimate.numpy().astype(np.float64))
        want_est = want_est[want_est < 1e30]
        scale = float(want_est.max()) if want_est.size else 1.0
        for field, rtol, atol in (
                ("estimate", 3e-5, 3e-5 * scale),
                ("lower", 3e-5, 3e-5 * scale), ("upper", 3e-5, 3e-5 * scale),
                ("frac_rows_touched", 3e-5, 3e-5),
                ("ci_half", 1e-4, 1e-4 * scale),
                ("ci_lo", 1e-4, 1e-4 * scale), ("ci_hi", 1e-4, 1e-4 * scale)):
            got, want = getattr(res[kind], field), getattr(cpu[kind], field)
            if got is None and want is None:
                continue
            close(f"{tag} cpu parity {kind}.{field}", got[:n].cpu(), want,
                  rtol, atol)
    emit(check="cpu_parity", path=tag, queries=n, kinds=list(kinds),
         ok=True)


# ---------------------------------------------------------------------------
# The main path
# ---------------------------------------------------------------------------

def main_path(torch, tag, c, a, method, truth_fn, max_median_err,
              base=None, queries=None, cpu_queries=512) -> dict:
    """build_synopsis(k=1024, sample_rate=0.01) -> PassEngine(all five
    kinds, ci=0.95).answer() of ``queries`` (random_queries(c, 2048,
    seed=3) by default), then the checks of phases 4 and 5 (the CPU answer
    on the first ``cpu_queries``)."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.query import random_queries
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.engine import executor
    from repro_torch.engine.executor import slice_sample_slots
    from repro_torch.kernels import native

    native.reset_launches()
    executor.reset_op_counts()
    t0 = time.perf_counter()
    syn, report = build_synopsis(c, a, k=1024, sample_rate=0.01,
                                 method=method)
    q = random_queries(c, 2048, seed=3) if queries is None else queries
    eng = PassEngine(syn, ServingConfig(kinds=KINDS), ci=0.95)
    res = eng.answer(q)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    emit(path=tag, rows=int(a.shape[0]), sample_c=list(syn.sample_c.shape),
         samples=report.total_samples, build_s=report.seconds_total,
         build_and_first_answer_s=seconds, launches=launches,
         artifact_passes=dict(executor.OP_COUNTS))
    for name in ("query_eval", "stratified_moments", "sample_extremes"):
        if launches[name] < 1:
            raise AssertionError(f"{tag}: kernel {name} was not launched by "
                                 "PassEngine.answer")
    check_result_shapes(torch, tag, res, int(q.lo.shape[0]))

    errs = kernel_vs_plain(torch, f"{tag} main Q=2048 k=1024",
                           syn.leaf_lo, syn.leaf_hi, syn.leaf_agg,
                           syn.sample_c, syn.sample_a, syn.sample_valid,
                           q.lo, q.hi, base=base)
    # The refinement ladder's view of the first 20 slots a stratum.
    view = slice_sample_slots(syn, 20)
    extremes_vs_plain(torch, f"{tag} main slice_sample_slots(20)",
                      view.sample_c, view.sample_a, view.sample_valid, q.lo,
                      q.hi)
    torch.cuda.empty_cache()
    check_cpu_parity(torch, tag, syn, q, res, n=cpu_queries)
    n = 64
    q_lo = q.lo[:n].cpu().numpy()
    q_hi = q.hi[:n].cpu().numpy()
    truth = truth_fn(c, a, q_lo, q_hi)
    emit(check="truth", path=tag,
         **check_truth(tag, res, truth, n, max_median_err))
    return {"syn": syn, "q": q, "eng": eng, "launches": launches,
            "errs": errs, "truth": truth, "first_answer_s": seconds}


# ---------------------------------------------------------------------------
# Times and bounds
# ---------------------------------------------------------------------------

def qe_cut_columns(torch, leaf_lo, leaf_hi, q_lo, q_hi):
    """Row 1's cut columns: for each (query, leaf tile of QE_LEAF_TILE
    leaves) the columns where the query does not hold the tile's box, the
    fminf / fmaxf of its leaves' boxes (a NaN drops out; a column of NaN
    alone gives NaN, which no bound holds; a NaN bound holds nothing).
    Returns (Q, tiles) int64 counts and the tiles' leaf counts (tiles,)."""
    from repro_torch.kernels.query_eval import QE_LEAF_TILE
    k, d = leaf_lo.shape
    n_t = -(-k // QE_LEAF_TILE)
    pad = n_t * QE_LEAF_TILE - k
    inf = float("inf")

    def tile_ext(x, fill, fold):
        nan = torch.isnan(x)
        x = torch.nn.functional.pad(torch.where(nan, fill, x),
                                    (0, 0, 0, pad), value=fill)
        nan = torch.nn.functional.pad(nan, (0, 0, 0, pad), value=True)
        ext = fold(x.reshape(n_t, QE_LEAF_TILE, d), 1)
        return torch.where(nan.reshape(n_t, QE_LEAF_TILE, d).all(1),
                           float("nan"), ext)
    tlo = tile_ext(leaf_lo, inf, torch.amin)
    thi = tile_ext(leaf_hi, -inf, torch.amax)
    cuts = []
    for s in range(0, q_lo.shape[0], 256):
        ql, qh = q_lo[s:s + 256, None], q_hi[s:s + 256, None]
        cuts.append((~((ql <= tlo[None]) & (thi[None] <= qh))).sum(-1))
    sizes = torch.full((n_t,), QE_LEAF_TILE, dtype=torch.int64)
    sizes[-1] = k - (n_t - 1) * QE_LEAF_TILE
    return torch.cat(cuts), sizes


def qe_cut_histogram(torch, leaf_lo, leaf_hi, q_lo, q_hi) -> dict:
    """{cut columns: (query, leaf tile) count} of qe_cut_columns."""
    cut, _ = qe_cut_columns(torch, leaf_lo, leaf_hi, q_lo, q_hi)
    v, n = torch.unique(cut, return_counts=True)
    return {int(a): int(b) for a, b in zip(v, n)}


def bounds(syn, q, rel, classes) -> dict:
    """Least time the card could take for each kernel's work on these
    inputs: max(bytes / HBM rate, operations / fp32 rate), each input read
    once and each output written once; data-dependent work counted as this
    run's data needs it (covered pairs, the pair classes)."""
    Q, d = q.lo.shape
    k, s = syn.sample_a.shape
    A = syn.leaf_agg.shape[1]
    covered = int((rel == 2).sum())
    valid = int(syn.sample_valid.sum())
    qe_bytes = 4 * (2 * k * d + k * A + 2 * Q * d) + 4 * Q * k + 4 * Q * A
    # Row 1 needs each leaf's non-empty bit (a compare a column), four
    # compares a pair in each column where its query does not hold the
    # leaf tile's box (qe_cut_columns; in every other column a non-empty
    # leaf is covered and not apart), a code a pair and the covered
    # leaves' adds. (A shim without leaf boxes: every column.)
    if hasattr(syn, "leaf_lo"):
        import torch
        qcut, sizes = qe_cut_columns(torch, syn.leaf_lo, syn.leaf_hi, q.lo,
                                     q.hi)
        pair_cols = int((qcut.cpu() * sizes[None]).sum())
    else:
        pair_cols = Q * k * d
    qe_ops = k * d + 4 * pair_cols + Q * k + covered * A
    # stratified_moments and sample_extremes need, from the same inputs,
    # each leaf's box (a min and a max a column of every valid slot), each
    # pair's class from the boxes (two compares a column for covered, two
    # for apart), each leaf's reduction over its slots (4 operations a slot
    # for the moments, a min and a max for the extremes), and the mixed
    # pairs' walks (the slot test, 2 compares a slot in each column that
    # cuts the pair, pair_classes' mixed_cut_columns, and the update); a
    # covered or empty pair costs a copy. Outputs: (Q, k, 3) and two (Q,
    # k).
    in_bytes = 4 * k * s * d + 4 * k * s + k * s + 8 * Q * d
    shared_ops = 2 * d * valid + 4 * d * Q * k
    mixed, cut = classes["mixed"], classes["mixed_cut_columns"]
    sm_bytes = in_bytes + 12 * Q * k
    sm_ops = shared_ops + 4 * k * s + s * (2 * cut + 4 * mixed)
    se_bytes = in_bytes + 8 * Q * k
    se_ops = shared_ops + 2 * k * s + s * (2 * cut + 2 * mixed)
    out = {}
    for name, nbytes, ops in (("query_eval", qe_bytes, qe_ops),
                              ("stratified_moments", sm_bytes, sm_ops),
                              ("sample_extremes", se_bytes, se_ops)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "bytes": nbytes, "operations": ops}
    return out


def timings(torch, tag, run, card, base=None) -> dict:
    """CUDA-event medians at the main-path shapes, the serving kernels'
    device times (one device operation a call) and host issue, and the
    plain versions' (sample_extremes_plain, the broadcast the port ran
    before its kernel, is the yardstick); with a baseline, its
    stratified_moments and query_eval kernels' too."""
    from repro_torch.engine.executor import compute_artifacts
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    from repro_torch.kernels.sample_extremes import (sample_extremes_cuda,
                                                     sample_extremes_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain)
    syn, q, eng = run["syn"], run["q"], run["eng"]
    qe_args = (syn.leaf_lo, syn.leaf_hi, syn.leaf_agg, q.lo, q.hi)
    sm_args = (syn.sample_c, syn.sample_a, syn.sample_valid, q.lo, q.hi)
    rel, _ = query_eval_cuda(*qe_args)
    classes = pair_classes(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi)
    bnd = bounds(syn, q, rel, classes)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    eng.answer(q)
    torch.cuda.synchronize()
    answer_peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mb
    times = {
        "answer": cuda_ms(torch, lambda: eng.answer(q)),
        "answer_host": host_ms(torch, lambda: eng.answer(q)),
        "artifacts": cuda_ms(torch, lambda: compute_artifacts(
            syn, q, KINDS)),
        "query_eval": cuda_ms(torch, lambda: query_eval_cuda(*qe_args)),
        "query_eval_plain": cuda_ms(torch, lambda: query_eval_plain(
            *qe_args)),
        "stratified_moments": cuda_ms(torch, lambda: stratified_moments_cuda(
            *sm_args)),
        "stratified_moments_plain": cuda_ms(
            torch, lambda: stratified_moments_plain(*sm_args)),
    }
    times["sample_extremes"] = cuda_ms(
        torch, lambda: sample_extremes_cuda(*sm_args))
    times["sample_extremes_plain"] = cuda_ms(
        torch, lambda: sample_extremes_plain(*sm_args), reps=10)
    for name, kernel, plain, args in (
            ("query_eval", query_eval_cuda, query_eval_plain, qe_args),
            ("stratified_moments", stratified_moments_cuda,
             stratified_moments_plain, sm_args),
            ("sample_extremes", sample_extremes_cuda, sample_extremes_plain,
             sm_args)):
        times[f"{name}_device"] = device_ms(torch, lambda: kernel(*args),
                                           one_op=True)
        times[f"{name}_plain_device"] = device_ms(torch,
                                                  lambda: plain(*args),
                                                  reps=5)
        times[f"{name}_enqueue_host"] = enqueue_ms(torch,
                                                   lambda: kernel(*args))
    torch.cuda.empty_cache()
    if base is not None:
        def old_qe():
            return baseline_query_eval(torch, base, *qe_args)
        # Rows 2 and 8: kernel, baseline, baseline, kernel, by events and
        # on the device (the baseline's sample_extremes bit-equal first).
        old_se = baseline_pair(torch, base, "sample_extremes", *sm_args)
        for name, g in zip(("min", "max"), sample_extremes_cuda(*sm_args)):
            if not same_bits(torch, g, old_se[0 if name == "min" else 1]):
                raise AssertionError(f"{tag}: sample_extremes {name} differs "
                                     "from the baseline kernel")
        for name, new_fn in (("stratified_moments", stratified_moments_cuda),
                             ("sample_extremes", sample_extremes_cuda)):
            def new(fn=new_fn):
                return fn(*sm_args)

            def old(name=name):
                return baseline_pair(torch, base, name, *sm_args)
            ev = [cuda_ms(torch, new)]
            dev_ms = [device_ms(torch, new, one_op=True)]
            b_ev = [cuda_ms(torch, old) for _ in range(2)]
            b_dev = [device_ms(torch, old, one_op=True) for _ in range(2)]
            ev.append(cuda_ms(torch, new))
            dev_ms.append(device_ms(torch, new, one_op=True))
            times[f"{name}_in_turns"] = statistics.mean(ev)
            times[f"{name}_device_in_turns"] = mean_of(dev_ms)
            times[f"{name}_baseline"] = statistics.mean(b_ev)
            times[f"{name}_baseline_device"] = mean_of(b_dev)
        # kernel, baseline, baseline, kernel
        qe_ev = [cuda_ms(torch, lambda: query_eval_cuda(*qe_args))]
        qe_dev = [device_ms(torch, lambda: query_eval_cuda(*qe_args),
                            one_op=True)]
        b_ev = [cuda_ms(torch, old_qe) for _ in range(2)]
        b_dev = [device_ms(torch, old_qe, one_op=True) for _ in range(2)]
        qe_ev.append(cuda_ms(torch, lambda: query_eval_cuda(*qe_args)))
        qe_dev.append(device_ms(torch, lambda: query_eval_cuda(*qe_args),
                                one_op=True))
        times["query_eval_in_turns"] = statistics.mean(qe_ev)
        times["query_eval_device_in_turns"] = mean_of(qe_dev)
        times["query_eval_baseline"] = statistics.mean(b_ev)
        times["query_eval_baseline_device"] = mean_of(b_dev)
        times["query_eval_baseline_enqueue_host"] = enqueue_ms(torch, old_qe)
    emit(times_ms=times, path=tag, Q=int(q.lo.shape[0]),
         k=int(syn.num_leaves), s=int(syn.sample_a.shape[1]),
         d=int(syn.d), answer_peak_mb_above_resident=answer_peak_mb,
         bounds=bnd, pair_classes=classes, card=card)
    return {"times": times, "bounds": bnd, "peak_mb": answer_peak_mb,
            "classes": classes}


def profile_answer(torch, tag, run) -> None:
    """torch.profiler over 5 answers: device-busy time and kernels per
    answer; the table of the top device ops goes to chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    eng, q = run["eng"], run["q"]
    for _ in range(3):
        eng.answer(q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            eng.answer(q)
        torch.cuda.synchronize()
    busy_us, n = device_busy_us(prof)
    write_table(prof, f"profile_{tag}.txt")
    emit(profile=tag, device_busy_ms_per_answer=busy_us / 1e3 / 5,
         device_kernels_per_answer=n / 5)


def write_table(prof, name: str) -> None:
    """The profiler's table by device time, to chiprun_out/."""
    OUT.mkdir(exist_ok=True)
    sort_key = ("self_device_time_total" if hasattr(
        prof.key_averages()[0], "self_device_time_total")
        else "self_cuda_time_total")
    (OUT / name).write_text(
        prof.key_averages().table(sort_by=sort_key, row_limit=40))


# ---------------------------------------------------------------------------
# Streaming ingest, delta-merge serving and drift re-optimization
# ---------------------------------------------------------------------------

# Rows per ingest batch: the JAX package's streaming benchmark's batch
# (benchmarks/bench_streaming_ingest.py).
STREAM_BATCH = 4096


def batches_of(c, a):
    """The stream in arrival order, cut into STREAM_BATCH-row batches of
    float32 (B, d) coordinates and (B,) values; the last one ragged."""
    c = np.asarray(c, np.float32).reshape(a.shape[0], -1)
    a = np.asarray(a, np.float32)
    return [(c[i:i + STREAM_BATCH], a[i:i + STREAM_BATCH])
            for i in range(0, a.shape[0], STREAM_BATCH)]


def stream_cpu_parity(torch, tag, syn, batches, n: int = 8) -> None:
    """The port on the CPU ingests the first n batches with the same seed:
    routing of every batch, reservoir arrays, k_per_leaf, seen, boxes, oob
    and quarantined are equal; in delta_agg counts, min and max are equal
    and the sums meet rtol=3e-5, atol=1e-3 (fp32 sums in another order)."""
    from repro_torch.streaming import StreamingIngestor
    from repro_torch.streaming.ingest import STATE_FIELDS, route_rows
    gpu = StreamingIngestor(syn, seed=11)
    cpu = StreamingIngestor(syn.to("cpu"), seed=11, device="cpu")
    for i, (cb, ab) in enumerate(batches[:n]):
        ct = torch.from_numpy(cb)
        leaf_g, dist_g = route_rows(gpu.state.leaf_lo, gpu.state.leaf_hi,
                                    ct.cuda())
        leaf_c, dist_c = route_rows(cpu.state.leaf_lo, cpu.state.leaf_hi, ct)
        if not (torch.equal(leaf_g.cpu(), leaf_c)
                and torch.equal(dist_g.cpu(), dist_c)):
            raise AssertionError(f"{tag}: batch {i} routes differently on "
                                 "the card and on the CPU")
        gpu.ingest(cb, ab)
        cpu.ingest(cb, ab)
    for f in STATE_FIELDS:
        g, c = getattr(gpu.state, f).cpu(), getattr(cpu.state, f)
        if f == "delta_agg":
            if not torch.equal(g[:, 2:], c[:, 2:]):
                raise AssertionError(f"{tag}: delta_agg counts/min/max "
                                     "differ from the CPU")
            err = max(close(f"{tag} cpu parity delta_agg[{j}]", g[:, j],
                            c[:, j], K_RTOL, K_ATOL) for j in (0, 1))
        elif not torch.equal(g, c):
            raise AssertionError(f"{tag}: {f} differs from the CPU after "
                                 f"{n} batches")
    emit(check="stream_cpu_parity", path=tag, batches=n,
         delta_sum_max_abs_err=err, n_oob=int(gpu.state.oob))


def stream_path(torch, tag, run, c_base, a_base, c_s, a_s, max_median_err,
                reopt: bool) -> dict:
    """Ingest the whole stream through StreamingIngestor (the launches of
    that window are read right after it), serve the ingestor with
    PassEngine(all five kinds, ci=0.95) (its own window), check the truth
    over base plus stream, and, in 1-D, reoptimize + replace_source and
    check again."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.kernels import native
    from repro_torch.streaming import StreamingIngestor, reoptimize
    syn, q = run["syn"], run["q"]
    d = syn.d
    batches = batches_of(c_s, a_s)
    nb = len(batches)

    ing = StreamingIngestor(syn, seed=11)
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    for cb, ab in batches:
        ing.ingest(cb, ab)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    launches = dict(native.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    # Row 10 twice a batch: the key's split, then the batch's uniforms.
    want.update(segment_reduce=nb, route_multid=nb if d > 1 else 0,
                threefry=2 * nb)
    if launches != want:
        raise AssertionError(f"{tag} stream: launches {launches} != {want}")
    emit(path=f"{tag} stream", rows=int(a_s.shape[0]), batches=nb,
         last_batch=int(batches[-1][1].shape[0]), ingest_s=ingest_s,
         rows_per_s=a_s.shape[0] / ingest_s, launches=launches,
         n_oob=ing.n_oob, n_quarantined=ing.n_quarantined,
         staleness=ing.staleness(), oob_frac=ing.oob_frac())

    native.reset_launches()
    t0 = time.perf_counter()
    eng = PassEngine(ing, ServingConfig(kinds=KINDS), ci=0.95)
    res = eng.answer(q)
    torch.cuda.synchronize()
    answer_s = time.perf_counter() - t0
    serve_launches = dict(native.LAUNCHES)
    if serve_launches["query_eval"] < 1 or \
            serve_launches["stratified_moments"] < 1:
        raise AssertionError(f"{tag} stream: answer launched "
                             f"{serve_launches}")
    check_result_shapes(torch, f"{tag} stream", res, q.lo.shape[0])
    n = 64
    q_lo, q_hi = q.lo[:n].cpu().numpy(), q.hi[:n].cpu().numpy()
    c_all = np.concatenate([np.asarray(c_base).reshape(a_base.shape[0], -1),
                            np.asarray(c_s).reshape(a_s.shape[0], -1)])
    a_all = np.concatenate([a_base, a_s])
    truth = truth_scan(torch, c_all, a_all, q_lo, q_hi)
    emit(check="truth", path=f"{tag} stream", answer_s=answer_s,
         launches=serve_launches, total_rows=ing.total_rows,
         **check_truth(f"{tag} stream", res, truth, n, max_median_err))

    stream_cpu_parity(torch, tag, syn, batches)
    out = {"ing": ing, "eng": eng, "batches": batches, "launches": launches}
    if reopt:
        t0 = time.perf_counter()
        new_ing, report = reoptimize(ing, c_all[:, 0], a_all)
        torch.cuda.synchronize()
        reopt_s = time.perf_counter() - t0
        eng.replace_source(new_ing)
        res = eng.answer(q)
        torch.cuda.synchronize()
        check_result_shapes(torch, f"{tag} reoptimized", res, q.lo.shape[0])
        emit(check="truth", path=f"{tag} reoptimized", reoptimize_s=reopt_s,
             k=report["k"], samples=int(new_ing.base.k_per_leaf.sum()),
             staleness_at_reopt=report["staleness_at_reopt"],
             oob_frac_at_reopt=report["oob_frac_at_reopt"],
             **check_truth(f"{tag} reoptimized", res, truth, n,
                           max_median_err))
    return out


def check_result_shapes(torch, tag, res, Q, kinds=KINDS) -> None:
    for kind in kinds:
        for field in ("estimate", "lower", "upper", "ci_lo", "ci_hi"):
            x = getattr(res[kind], field)
            if x.shape != (Q,) or x.device.type != "cuda":
                raise AssertionError(f"{tag} {kind}.{field}: {x.shape} on "
                                     f"{x.device}")
        if not torch.isfinite(res[kind].estimate).all():
            raise AssertionError(f"{tag} {kind}: non-finite estimate")


def stream_bounds(N, k, B, d) -> dict:
    """Least time for the streaming kernels' work, as bounds() counts it:
    segment_reduce reads 8 bytes a row and writes 20 a segment, ~6 fp32
    operations a row; route_multid reads both boxes and the rows and
    writes 8 bytes a row, 5 fp32 operations a (row, leaf, dimension)."""
    out = {}
    for name, nbytes, ops in (
            ("segment_reduce", 8 * N + 20 * k, 6 * N),
            ("route_multid", 4 * (2 * k * d + B * d) + 8 * B,
             5 * B * k * d)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "operations": ops}
    return out


def stream_kernel_times(torch, s1, s3, card, base=None) -> dict:
    """The two streaming kernels and their plain versions at B = 4096 (one
    ingest batch) and B = 65536, on the main paths' inputs: segment_reduce
    over the 1-D stream's values by their routed leaves (k = 1024, the
    stream's skew), route_multid of the 3-D stream's rows against the 3-D
    boxes (k = 1024, d = 3). Kernel = plain is checked at each shape, and
    with a baseline both kernels bit-equal to the baseline's. Each kernel:
    one call bracketed by CUDA events, its device time from the profiler
    (one device operation a call, held), its host issue; the plain
    version's events and device time; with a baseline the baseline's, in
    turns with the kernel's (kernel, baseline, baseline, kernel; the two
    readings of each averaged; the baseline's device time, like the
    kernel's, a mean per record)."""
    from repro_torch.kernels.route import (route_multid_cuda,
                                           route_multid_plain)
    from repro_torch.kernels.segment_reduce import (segment_reduce_cuda,
                                                    segment_reduce_plain)
    from repro_torch.streaming.ingest import route_rows
    out, errs = {}, []
    st1, st3 = s1["ing"].state, s3["ing"].state
    k = st1.sample_a.shape[0]
    for B in (4096, 65536):
        nb = B // STREAM_BATCH
        c1 = np.concatenate([cb for cb, _ in s1["batches"][:nb]])
        a1 = np.concatenate([ab for _, ab in s1["batches"][:nb]])
        c3 = np.concatenate([cb for cb, _ in s3["batches"][:nb]])
        v = torch.from_numpy(a1).cuda()
        ids, _ = route_rows(st1.leaf_lo, st1.leaf_hi,
                            torch.from_numpy(c1).cuda())
        rows = torch.from_numpy(c3).cuda()
        lo, hi = st3.leaf_lo, st3.leaf_hi
        e, ties = seg_vs_plain(torch, f"main B={B} k={k}", v, ids, k, base)
        errs.append(e)
        route_vs_plain(torch, f"main B={B} k={k} d=3", lo, hi, rows, base)
        fns = {"segment_reduce": lambda: segment_reduce_cuda(v, ids, k),
               "route_multid": lambda: route_multid_cuda(lo, hi, rows)}
        plains = {"segment_reduce": lambda: segment_reduce_plain(v, ids, k),
                  "route_multid": lambda: route_multid_plain(lo, hi, rows)}
        bases = {} if base is None else {
            "segment_reduce": lambda: baseline_segment(torch, base, v, ids,
                                                       k),
            "route_multid": lambda: baseline_route(torch, base, lo, hi,
                                                   rows)}
        row = {"bounds": stream_bounds(B, k, B, 3),
               "segments_hit": int(torch.unique(ids).numel()),
               "segment_reduce_baseline_zero_ties": ties}
        for name, fn in fns.items():
            # kernel, baseline, baseline, kernel; a profiler window that
            # recorded nothing is left out of the mean
            profs = [device_profile(torch, fn, one_op=True)]
            ev = [cuda_ms(torch, fn)]
            if name in bases:
                # Each device operation's mean record, as the kernel's
                # reading: a dropped record leaves it whole (busy time over
                # the calls read 0.95 of it when the profiler kept 19
                # records of 20).
                bdev = [call_device_ms(torch, bases[name])["ms"]
                        for _ in range(2)]
                bev = [cuda_ms(torch, bases[name]) for _ in range(2)]
            profs.append(device_profile(torch, fn, one_op=True))
            ev.append(cuda_ms(torch, fn))
            dev_ms = [x["ms"] for x in profs if x["ms"] is not None]
            row[name] = statistics.mean(ev)
            row[f"{name}_readings"] = ev
            row[f"{name}_device"] = statistics.mean(dev_ms) if dev_ms \
                else None
            row[f"{name}_device_readings"] = [x["ms"] for x in profs]
            row[f"{name}_ops_per_call"] = max(x["ops_per_call"]
                                              for x in profs)
            row[f"{name}_enqueue_host"] = enqueue_ms(torch, fn)
            row[f"{name}_plain"] = cuda_ms(torch, plains[name])
            row[f"{name}_plain_device"] = device_ms(torch, plains[name])
            if name not in bases:
                continue
            bdev = [x for x in bdev if x is not None]
            row[f"{name}_baseline"] = statistics.mean(bev)
            row[f"{name}_baseline_readings"] = bev
            row[f"{name}_baseline_device"] = mean_of(bdev)
            row[f"{name}_baseline_enqueue_host"] = enqueue_ms(torch,
                                                              bases[name])
            row[f"{name}_baseline_bit_equal"] = (name != "segment_reduce"
                                                 or ties == 0)
        if B == STREAM_BATCH:
            row["segment_reduce_zeros"] = seg_zero_times(torch, v, ids, k,
                                                         base)
        out[B] = row
        emit(stream_kernel_times_ms=row, B=B, k=k, card=card)
    return {"times": out, "seg_err": max(errs)}


def seg_zero_times(torch, v, ids, k, base=None) -> dict:
    """segment_reduce on one batch's values and ids with zeros put in: half
    the values (+0.0 or -0.0 by a seeded coin, the rest the stream's) and
    all of them, the signed-zero rule's worst case (every chunk's running
    MIN and MAX sit at zero, so each looks again over its tile's rows).
    Kernel = plain (seg_vs_plain) on both; the kernel's device time and,
    with a baseline, the baseline's, in turns (kernel, baseline, baseline,
    kernel)."""
    from repro_torch.kernels.segment_reduce import segment_reduce_cuda
    rng = np.random.default_rng(17)
    n = v.shape[0]
    zeros = torch.from_numpy(np.where(rng.random(n) < 0.5, -0.0, 0.0)
                             .astype(np.float32)).to(v.device)
    half = torch.from_numpy(rng.random(n) < 0.5).to(v.device)
    out = {}
    for name, vals in (("half_zeros", torch.where(half, zeros, v)),
                       ("all_zeros", zeros)):
        _, ties = seg_vs_plain(torch, f"main B={n} k={k} {name}", vals, ids,
                               k, base)

        def fn():
            return segment_reduce_cuda(vals, ids, k)

        dev = [device_ms(torch, fn, one_op=True)]
        if base is not None:
            bdev = [call_device_ms(torch, lambda: baseline_segment(
                torch, base, vals, ids, k))["ms"] for _ in range(2)]
            out[f"{name}_baseline_device"] = mean_of(bdev)
            out[f"{name}_baseline_zero_ties"] = ties
        dev.append(device_ms(torch, fn, one_op=True))
        out[f"{name}_device"] = mean_of(dev)
    return out


def stream_timings(torch, tag, run, s, card) -> None:
    """Ingest per batch (CUDA events and host clock, medians after warm-up;
    rows/s from the host clock), the as_synopsis merge, and answer from
    the ingestor right after an ingest (merge and re-pin included), on a
    fresh ingestor over the same synopsis and stream."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.streaming import StreamingIngestor, merge_synopsis
    from repro_torch.streaming import subtree_leaf_matrix
    syn, q, batches = run["syn"], run["q"], s["batches"]
    ing = StreamingIngestor(syn, seed=11)
    it = iter(batches * 4)

    def one():
        ing.ingest(*next(it))

    ev = cuda_ms(torch, one, reps=40, warmup=10)
    host = host_ms(torch, one, reps=40)
    subtree = subtree_leaf_matrix(ing.base.tree, ing.base.num_leaves)

    def merge():
        return merge_synopsis(ing.base, ing.state, subtree,
                              total_rows=ing.total_rows)

    eng = PassEngine(ing, ServingConfig(kinds=KINDS), ci=0.95)
    eng.answer(q)
    after = []
    for _ in range(10):
        one()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.answer(q)
        torch.cuda.synchronize()
        after.append((time.perf_counter() - t0) * 1e3)
    times = {"ingest_batch": ev, "ingest_batch_host": host,
             "rows_per_s_host": STREAM_BATCH / host * 1e3,
             "merge": cuda_ms(torch, merge),
             "merge_host": host_ms(torch, merge),
             "answer_after_ingest_host": statistics.median(after)}
    emit(stream_times_ms=times, path=tag, card=card)


def profile_ingest(torch, tag, s) -> None:
    """profile_batches over a fresh StreamingIngestor on the path's base,
    with route_multid and segment_reduce broken out beside row 10."""
    from repro_torch.streaming import StreamingIngestor
    ing = StreamingIngestor(s["ing"].base, seed=11)
    emit(profile=f"ingest {tag}",
         **profile_batches(torch, lambda b: ing.ingest(*b), s["batches"],
                           kernels=("route_multid", "segment_reduce"),
                           table=f"profile_ingest_{tag}.txt"))


def profile_batches(torch, ingest, batches, kernels=(), table=None,
                    host=False) -> dict:
    """torch.profiler over ``ingest(b)`` of batches 3-12 after 3 warm-up
    batches: device kernels, device busy and wall ms a batch and the busy
    share of the wall time; for row 10 (threefry) and each named kernel of
    ``kernels`` (weighted ones left out) its records, device ms a batch and
    shares of the busy and the wall time; with ``host``, the host time by
    operator (host_split); with ``table``, the profiler's table written
    under chiprun_out."""
    from torch.profiler import ProfilerActivity, profile
    for b in batches[:3]:
        ingest(b)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in batches[3:13]:
            ingest(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n = device_busy_us(prof)
    if table is not None:
        write_table(prof, table)
    by_name = {}
    for name in kernels:
        events = [e for e in prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")
                  and name in e.name and "weighted" not in e.name]
        by_name[name] = (sum(e.device_time if hasattr(e, "device_time")
                             else e.cuda_time for e in events), len(events))
    by_name["threefry"] = row10_device_us(prof)
    out = {"batches": 10, "device_kernels_per_batch": n / 10,
           "device_busy_ms_per_batch": busy_us / 1e3 / 10,
           "wall_ms_per_batch": wall_ms / 10,
           "device_busy_share": busy_us / 1e3 / wall_ms,
           "kernels": {name: {"recorded": rec,
                              "device_ms_per_batch": us / 1e3 / 10,
                              "share_of_busy": us / busy_us if busy_us
                              else None,
                              "share_of_wall": us / 1e3 / wall_ms}
                       for name, (us, rec) in by_name.items()}}
    if host:
        out["host"] = host_split(prof, 10)
    return out


# ---------------------------------------------------------------------------
# Streaming A/B: ingest and merge of this checkout against another
# ---------------------------------------------------------------------------

STREAM_AB_ROUNDS = 3


def plain_minmax(torch) -> dict:
    """repro_torch.minmax's functions as the port computed them before the
    signed-zero rule: PyTorch's own MIN/MAX, which keep whichever of two
    zeros comes first. For the A/B of the rule's cost only."""
    return {
        "minimum": torch.minimum, "maximum": torch.maximum,
        "masked_min": lambda x, m, f, d: torch.where(m, x, f).amin(d),
        "masked_max": lambda x, m, f, d: torch.where(m, x, f).amax(d),
        "scatter_min_": lambda o, i, v: o.scatter_reduce_(0, i, v, "amin"),
        "scatter_max_": lambda o, i, v: o.scatter_reduce_(0, i, v, "amax")}


def host_split(prof, n: int, top: int = 12) -> dict:
    """A profiler window's host time per batch (n batches) by operator:
    the top operators by self CPU time, their calls and self ms a batch."""
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
    return {
        "self_cpu_ms_per_batch": sum(e.self_cpu_time_total for e in rows)
        / 1e3 / n,
        "top": [{"op": e.key, "calls": e.count / n,
                 "self_cpu_ms": e.self_cpu_time_total / 1e3 / n}
                for e in rows[:top]]}


def stream_probe(torch, card) -> None:
    """Ingest (events and host clock, per 4096-row batch) and the merge
    (events and host clock) of the repro_torch package first on sys.path,
    on the main paths' 1-D and 3-D synopses and streams, as stream_timings
    measures them, STREAM_AB_ROUNDS rounds, each on a fresh ingestor; and a
    profiler window of 10 batches a path: device busy and kernels per
    batch, host time by operator. Where the package has repro_torch.minmax,
    each round also runs with its functions swapped for plain_minmax's (in
    turns: as is, plain, then plain, as is), so that the signed-zero rule's
    share is read in one process. Each round also times the ingest of a
    ShardedIngestor at D = 4 on the same synopsis and batches, and of a
    JoinStreamingIngestor on phases 19 and 20's join synopsis and newer
    fact rows (``{tag} sharded_d4`` and ``{tag} join``). One JSON line."""
    import repro_torch
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.data.synthetic import nyc_taxi
    from repro_torch.joins import build_dim_table, build_join_synopsis
    from repro_torch.kernels import native
    from repro_torch.sharded import ShardedIngestor, data_mesh
    from repro_torch.streaming import (StreamingIngestor, merge_synopsis,
                                       subtree_leaf_matrix)
    from repro_torch.streaming.join_ingest import JoinStreamingIngestor
    native.build_all()
    try:
        from repro_torch import minmax
    except ImportError:
        minmax = None
    variants = {"as_is": {}}
    if minmax is not None:
        plain = plain_minmax(torch)
        variants["as_is"] = {n: getattr(minmax, n) for n in plain}
        variants["minmax_plain"] = plain

    def use(name):
        for fn_name, fn in variants[name].items():
            setattr(minmax, fn_name, fn)

    out = {"package": str(Path(repro_torch.__file__).resolve().parent)}
    for tag, dims, method in (("1d", 1, "adp"), ("3d", 3, "kd")):
        c, a = nyc_taxi(scale=1.0, dims=dims)
        syn, _ = build_synopsis(c, a, k=1024, sample_rate=0.01,
                                method=method)
        batches = batches_of(*nyc_taxi(scale=0.1, seed=7, dims=dims))
        readings = {v: {"ingest": [], "ingest_host": [], "merge": [],
                         "merge_host": []} for v in variants}
        for rnd in range(STREAM_AB_ROUNDS):
            order = list(variants)
            for name in order if rnd % 2 == 0 else order[::-1]:
                use(name)
                ing = StreamingIngestor(syn, seed=11)
                it = iter(batches * 4)

                def one():
                    ing.ingest(*next(it))

                r = readings[name]
                r["ingest"].append(cuda_ms(torch, one, reps=40, warmup=10))
                r["ingest_host"].append(host_ms(torch, one, reps=40))
                subtree = subtree_leaf_matrix(ing.base.tree,
                                              ing.base.num_leaves)

                def merge():
                    return merge_synopsis(ing.base, ing.state, subtree,
                                          total_rows=ing.total_rows)

                r["merge"].append(cuda_ms(torch, merge))
                r["merge_host"].append(host_ms(torch, merge))
        for name in variants:
            use(name)
            ing = StreamingIngestor(syn, seed=11)
            readings[name]["profile"] = profile_batches(
                torch, lambda b: ing.ingest(*b), batches, host=True)
        use("as_is")
        out[tag] = readings

        cj, aj, kj, dkeys, dattr, _, _ = join_workload(
            JOIN_N, JOIN_ND, JOIN_Q, 0, dims)
        jsyn, _ = build_join_synopsis(
            cj, aj, kj, build_dim_table(dkeys, dattr, num_partitions=JOIN_P),
            k=JOIN_K, p_u=JOIN_PU, seed=0, method=method)
        del cj, aj, kj
        jbatches = join_stream_rows(JOIN_STREAM, JOIN_ND, 1, dims)
        mesh = data_mesh(4)
        others = {
            "sharded_d4": (lambda: ShardedIngestor(syn, mesh=mesh, seed=5),
                           batches),
            "join": (lambda: JoinStreamingIngestor(jsyn, seed=11), jbatches)}
        for name, (make, rows) in others.items():
            r = {"ingest": [], "ingest_host": []}
            for _ in range(STREAM_AB_ROUNDS):
                ing = make()
                it = iter(rows * 4)

                def one():
                    ing.ingest(*next(it))

                r["ingest"].append(cuda_ms(torch, one, reps=40, warmup=10))
                r["ingest_host"].append(host_ms(torch, one, reps=40))
            out[f"{tag} {name}"] = r
        del jsyn
        torch.cuda.empty_cache()
    emit(stream_probe=out, card=card)


def stream_ab(torch, other: Path, card) -> None:
    """stream_probe of `other`'s package and of this checkout's, each in
    its own process, in the order other, this, this, other; then the mean
    of each side's readings. `other` builds its kernels into its own
    build/ directory."""
    sides = [("other", other.resolve() / "src"), ("this", ROOT / "src")]
    runs = {"other": [], "this": []}
    for side, src in sides + sides[::-1]:
        proc = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--stream-probe",
             str(src)], capture_output=True, text=True, timeout=1200)
        if proc.returncode != 0:
            raise RuntimeError(f"stream probe of {src} failed:\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-4000:]}")
        line = [x for x in proc.stdout.splitlines()
                if x.startswith('{"stream_probe"')][-1]
        print(line, flush=True)
        runs[side].append(json.loads(line)["stream_probe"])
    summary = {}
    for side, probes in runs.items():
        for tag in ("1d", "3d"):
            for variant in probes[0][tag]:
                for metric in ("ingest", "ingest_host", "merge",
                               "merge_host"):
                    vals = [x for p in probes
                            for x in p[tag][variant][metric]]
                    summary[f"{side} {variant} {tag} {metric}"] = \
                        statistics.mean(vals)
            for name in ("sharded_d4", "join"):
                for metric in ("ingest", "ingest_host"):
                    vals = [x for p in probes
                            for x in p[f"{tag} {name}"][metric]]
                    summary[f"{side} {name} {tag} {metric}"] = \
                        statistics.mean(vals)
    emit(stream_ab_mean_ms=summary, rounds=STREAM_AB_ROUNDS,
         other=str(other), card=card)


# ---------------------------------------------------------------------------
# The Poisson bootstrap (fused and scan) and the planner
# ---------------------------------------------------------------------------

BOOT_KINDS = ("sum", "count", "avg")
# Replicates and key of the bootstrap serving phases: the CIConfig default
# n_boot and a fixed seed.
N_BOOT = 200
BOOT_KEY = 5
# Queries of the plain bootstrap's timing slice: its (8, Q, k, 128) fp32
# temporaries take ~1 GB each at Q = 256, and tens of GB at Q = 2048.
PLAIN_BOOT_Q = 256


def boot_ci(**kw):
    from repro_torch.api import CIConfig
    return CIConfig(method="bootstrap", n_boot=N_BOOT, key=BOOT_KEY, **kw)


def weighted_inputs(rng, Q, k, s, d, R):
    """Samples with ragged validity, strata 0 and k // 2 without a valid
    sample, weights that are zero, Poisson integers and non-integers (on
    invalid slots too), and an inverted (empty) query box."""
    c = rng.uniform(-1, 1, (k, s, d)).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.7
    valid[0] = False
    valid[k // 2] = False
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
    q_lo = rng.uniform(-1, 0, (Q, d)).astype(np.float32)
    q_hi = q_lo + rng.uniform(0, 1.5, (Q, d)).astype(np.float32)
    if Q > 2:
        q_hi[1] = q_lo[1] - 0.5
    return c, a, valid, W, q_lo, q_hi


def weighted_class_inputs(rng, Q, k, s, d, R):
    """Inputs where all three pair classes appear: each stratum's samples
    lie in its own cell of a grid over [0, 1)^d (ragged validity, strata 0
    and k // 2 without a valid sample, weights on invalid slots too).
    Query 0 covers every sample, queries 1 and 2 miss everything (2 is
    inverted), query 3's edges are the exact extremes of one stratum's
    valid samples, query 4's lower edge is one valid sample's coordinates;
    the rest are random boxes over a few cells."""
    c, a, valid, W, _, _ = weighted_inputs(rng, Q, k, s, d, R)
    g = max(1, int(np.ceil(k ** (1.0 / d) - 1e-9)))
    cell = np.stack([(np.arange(k) // g ** j) % g for j in range(d)], 1)
    c = ((cell[:, None, :] + rng.uniform(0.05, 0.95, (k, s, d)))
         / g).astype(np.float32)
    q_lo = rng.uniform(-0.1, 1.0, (Q, d)).astype(np.float32)
    q_hi = (q_lo + rng.uniform(0.0, 6.0 / g, (Q, d))).astype(np.float32)
    fixed = [(np.full(d, -1.0), np.full(d, 2.0)),
             (np.full(d, 3.0), np.full(d, 4.0)),
             (np.full(d, 0.9), np.full(d, 0.1))]
    leaf = next((i for i in range(k) if valid[i].any()), None)
    if leaf is not None:
        pts = c[leaf][valid[leaf]]
        fixed += [(pts.min(0), pts.max(0)), (pts[0], pts.max(0) + 1.0 / g)]
    for i, (lo, hi) in enumerate(fixed[:Q]):
        q_lo[i], q_hi[i] = lo, hi
    return c, a, valid, W, q_lo, q_hi


def slot_extents(torch, c, valid):
    """Each stratum's extent of its valid slots, a column at a time: (lo,
    hi, nan) of shape (k, d); nan where a valid slot has NaN there (lo /
    hi are then NaN too). A stratum without valid slots gets (+inf, -inf),
    which every query holds."""
    inf = float("inf")
    v = valid[..., None]
    return (torch.where(v, c, inf).amin(1), torch.where(v, c, -inf).amax(1),
            (v & torch.isnan(c)).any(1))


def cut_columns(ext, q_lo, q_hi):
    """(Q, k): the columns that cut each (query, stratum) pair, ext =
    slot_extents: those where the query does not hold the extent of the
    stratum's valid slots, or a valid slot has NaN (csrc/wide_cols.cuh).
    Every other column passes every valid slot, so a slot test needs its
    two compares only in these."""
    lo, hi, nan = ext
    held = (q_lo[:, None] <= lo[None]) & (hi[None] <= q_hi[:, None])
    return (~held | nan[None]).sum(-1)


def pair_classes(torch, c, valid, q_lo, q_hi, chunk: int = 256) -> dict:
    """Counts of (query, stratum) pairs whose box holds none of the
    stratum's valid samples (empty; strata without one among them), all of
    them (covered) or some (mixed): the classes the weighted kernels tell
    apart; and the mixed pairs' cut columns (cut_columns), summed: the
    columns their slot tests need."""
    from repro_torch.kernels.stratified_estimate import samples_inside
    nvalid = valid.sum(-1)
    ext = slot_extents(torch, c, valid)
    out = dict.fromkeys(("covered", "empty", "mixed"), 0)
    out["mixed_cut_columns"] = 0
    for i in range(0, q_lo.shape[0], chunk):
        ql, qh = q_lo[i:i + chunk], q_hi[i:i + chunk]
        n = samples_inside(c, valid, ql, qh).sum(-1)
        empty = n == 0
        covered = ~empty & (n == nvalid)
        mixed = ~empty & ~covered
        out["empty"] += int(empty.sum())
        out["covered"] += int(covered.sum())
        out["mixed"] += int(mixed.sum())
        out["mixed_cut_columns"] += int(
            cut_columns(ext, ql, qh)[mixed].sum())
    return out


def weighted_vs_plain(torch, tag, c, a, valid, W, q_lo, q_hi,
                      base=None) -> dict:
    """Both weighted kernels against their plain versions on the same CUDA
    inputs: sums within rtol=3e-5, atol=1e-3; each kernel bit-equal across
    two launches; every bootstrap_moments slice r torch.equal to
    stratified_weighted_moments with W[r] (DESIGN.md §10); with a baseline,
    both bit-equal to the baseline's kernels wherever
    baseline_bits_required, their differing values counted elsewhere.
    Returns the max absolute errors."""
    from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                               bootstrap_moments_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_weighted_moments_cuda, weighted_moments_plain)
    sm, q = (c, a, valid), (q_lo, q_hi)
    boot = bootstrap_moments_cuda(*sm, W, *q)
    boot2 = bootstrap_moments_cuda(*sm, W, *q)
    one = stratified_weighted_moments_cuda(*sm, W[0], *q)
    one2 = stratified_weighted_moments_cuda(*sm, W[0], *q)
    slices = [stratified_weighted_moments_cuda(*sm, W[r], *q)
              for r in range(W.shape[0])]
    torch.cuda.synchronize()
    for name, x, y in (("bootstrap_moments", boot, boot2),
                       ("stratified_weighted_moments", one, one2)):
        if not torch.equal(x.view(torch.int32), y.view(torch.int32)):
            raise AssertionError(f"{tag}: {name} differs between two "
                                 "launches")
    for r, one_r in enumerate(slices):
        if not torch.equal(boot[r], one_r):
            raise AssertionError(f"{tag}: bootstrap_moments[{r}] is not "
                                 f"stratified_weighted_moments(W[{r}])")
    if base is not None:
        lib = base["weighted_moments"]
        for name, x, w in (("bootstrap_moments", boot, W),
                           ("stratified_weighted_moments", one, W[0])):
            old = baseline_moments(torch, lib, sm, w, *q)
            if not baseline_bits_required(lib, a.shape[1]):
                weighted_baseline_differing(torch, f"{tag} {name}", x, old)
            elif not bits_equal(torch, x, old):
                raise AssertionError(f"{tag}: {name} differs from the "
                                     "baseline kernel")
    return {
        "bootstrap_moments": close(
            f"{tag} bootstrap_moments", boot.cpu(),
            bootstrap_moments_plain(*sm, W, *q).cpu(), K_RTOL, K_ATOL),
        "stratified_weighted_moments": close(
            f"{tag} stratified_weighted_moments", one.cpu(),
            weighted_moments_plain(*sm, W[0], *q).cpu(), K_RTOL, K_ATOL)}


def wseg_vs_plain(torch, tag, v, w, ids, k) -> float:
    """weighted_segment_reduce kernel against plain: sums within
    rtol=3e-5, atol=1e-3, and a second launch bit-equal to the first."""
    from repro_torch.kernels.segment_reduce import (
        weighted_segment_reduce_cuda, weighted_segment_reduce_plain)
    got = weighted_segment_reduce_cuda(v, w, ids, k)
    again = weighted_segment_reduce_cuda(v, w, ids, k)
    want = weighted_segment_reduce_plain(v, w, ids, k)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), again.view(torch.int32)):
        raise AssertionError(f"{tag}: weighted_segment_reduce differs "
                             "between two launches")
    return close(f"{tag} weighted_segment_reduce", got.cpu(), want.cpu(),
                 K_RTOL, K_ATOL)


def edge_cases_weighted(torch, dev, base=None) -> dict:
    """The three new kernels against plain at edge shapes: the weighted
    moments over Q in {1, 129} x k in {1, 53} x s in {1, 75, 300} (one to
    ten mask words) x d in {1, 3, 16}, with R cycling through {1, 7, 8, 9,
    33}, and five cases of weighted_class_inputs, where covered, empty and
    mixed pairs all appear (each prints its counts), all bit-equal to the
    baseline's kernels; three of the class cases again with NaN
    coordinates on valid slots (edge_weighted_nan); weighted_segment_reduce
    over N in {1, 17, 4096, 65537} x k in {1, 53, 1024, 3000} with -1 and
    out-of-range ids, zero weights, and all rows in one segment. Above
    one slot chunk (s = 2500) the baseline's differing values are
    counted."""
    errs = dict.fromkeys(("stratified_weighted_moments", "bootstrap_moments",
                          "weighted_segment_reduce"), 0.0)
    reps = (1, 7, 8, 9, 33)
    cases = 0
    for Q in (1, 129):
        for k in (1, 53):
            for s in (1, 75, 300):
                for d in (1, 3, 16):
                    R = reps[cases % len(reps)]
                    rng = np.random.default_rng(Q * 7919 + k * 31 + s + d)
                    t = [torch.from_numpy(x).to(dev)
                         for x in weighted_inputs(rng, Q, k, s, d, R)]
                    e = weighted_vs_plain(
                        torch, f"edge Q={Q} k={k} s={s} d={d} R={R}", *t,
                        base=base)
                    for name, err in e.items():
                        errs[name] = max(errs[name], err)
                    cases += 1
    # The three pair classes: k = 64 writes 16-byte rows, k = 53 4-byte
    # ones; s = 300 takes several coordinate chunks, s = 2500 a tile of
    # fewer than 32 leaves.
    class_cases = []
    for Q, k, s, d, R in ((129, 64, 75, 1, 9), (129, 53, 75, 3, 33),
                          (33, 64, 300, 2, 7), (33, 53, 2500, 3, 8),
                          (40, 64, 75, 16, 1)):
        rng = np.random.default_rng(Q * 131 + k * 17 + s + d)
        t = [torch.from_numpy(x).to(dev)
             for x in weighted_class_inputs(rng, Q, k, s, d, R)]
        tag = f"edge classes Q={Q} k={k} s={s} d={d} R={R}"
        classes = pair_classes(torch, t[0], t[2], t[4], t[5])
        if min(classes.values()) == 0:
            raise AssertionError(f"{tag}: a pair class is missing: {classes}")
        e = weighted_vs_plain(torch, tag, *t, base=base)
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        emit(check="edge_weighted_classes", case=tag, **classes,
             max_abs_err=e, baseline_bit_equal=None if base is None
             or not baseline_bits_required(base["weighted_moments"], s)
             else True)
        class_cases.append(classes)
        cases += 1
    nan_cases = edge_cases_weighted_nan(torch, dev, base, errs)
    seg_cases = 0
    # k = 3000 takes the kernel's passes of 1024 segments.
    for n in (1, 17, 4096, 65537):
        for k in (1, 53, 1024, 3000):
            rng = np.random.default_rng(n * 37 + k)
            v = rng.lognormal(0.9, 0.8, n).astype(np.float32)
            w = rng.poisson(1.0, n).astype(np.float32)
            w[::5] = rng.uniform(0, 2.5, w[::5].shape)
            ids = rng.integers(-1, k + 2, n).astype(np.int32)
            one = np.full(n, min(k - 1, 7), np.int32)
            for label, idv in (("mixed", ids), ("one segment", one)):
                errs["weighted_segment_reduce"] = max(
                    errs["weighted_segment_reduce"], wseg_vs_plain(
                        torch, f"edge N={n} k={k} {label}",
                        *(torch.from_numpy(x).to(dev) for x in (v, w, idv)),
                        k))
                seg_cases += 1
    emit(check="edge_weighted_kernels", moment_cases=cases,
         class_cases=len(class_cases), nan_cases=nan_cases,
         segment_cases=seg_cases, max_abs_err=errs)
    return errs


def edge_cases_weighted_nan(torch, dev, base, errs) -> int:
    """Rows 3 and 4 on class inputs with NaN coordinates on valid slots, at
    R = 9, 33 and 8: one slot of a stratum (the first with two valid
    slots), column 0 of every slot of another (the second), both with
    positive weights. The slot test rejects NaN, so under every query the
    first stratum is mixed or empty (mixed under query 0, whose box holds
    every other sample) and the second empty; the kernels must equal plain
    (weighted_vs_plain) and never give either stratum its totals, the
    moments of all its valid slots, which a covered pair would copy. With
    a baseline, whether the baseline's kernel differs is recorded (its box
    skipped NaN and covered such strata); one with the same slot chunks
    must give its bits. Updates ``errs``; returns the number of cases."""
    from repro_torch.kernels.bootstrap import bootstrap_moments_cuda
    from repro_torch.kernels.stratified_estimate import samples_inside
    shapes = ((129, 64, 75, 1, 9), (129, 53, 75, 3, 33),
              (33, 53, 2500, 3, 8))
    for Q, k, s, d, R in shapes:
        rng = np.random.default_rng(Q * 131 + k * 17 + s + d + 1)
        c, a, valid, W, q_lo, q_hi = weighted_class_inputs(rng, Q, k, s, d,
                                                           R)
        full = [i for i in range(k) if valid[i].sum() >= 2]
        l1, l2 = full[0], full[1]
        W[:, [l1, l2]] = np.maximum(W[:, [l1, l2]], 0.5)
        c[l1, np.flatnonzero(valid[l1])[0], d - 1] = np.nan
        c[l2, :, 0] = np.nan
        t = [torch.from_numpy(x).to(dev)
             for x in (c, a, valid, W, q_lo, q_hi)]
        tag = f"edge nan classes Q={Q} k={k} s={s} d={d} R={R}"
        n_in = samples_inside(t[0], t[2], t[4], t[5]).sum(-1).cpu().numpy()
        nvalid = valid.sum(-1)
        for leaf in (l1, l2):
            if ((n_in[:, leaf] == nvalid[leaf]) & (n_in[:, leaf] > 0)).any():
                raise AssertionError(f"{tag}: stratum {leaf} is covered")
        if not (n_in[0, l1] > 0 and (n_in[:, l2] == 0).all()):
            raise AssertionError(f"{tag}: the NaN strata are not mixed "
                                 "under query 0 and empty")
        classes = pair_classes(torch, t[0], t[2], t[4], t[5])
        e = weighted_vs_plain(torch, tag, *t)
        for name, err in e.items():
            errs[name] = max(errs[name], err)
        boot = bootstrap_moments_cuda(*t)
        wv = torch.where(t[2], t[3], 0.0).double()
        av = t[1].double()
        totals = torch.stack([wv.sum(-1), (wv * av).sum(-1),
                              (wv * av * av).sum(-1)], -1)   # (R, k, 3)
        for leaf in (l1, l2):
            hit = torch.isclose(boot[:, :, leaf].double(),
                                totals[:, None, leaf], rtol=K_RTOL,
                                atol=K_ATOL).all(-1)
            if hit.any():
                raise AssertionError(f"{tag}: stratum {leaf} takes its "
                                     f"totals in {int(hit.sum())} pairs")
        differs = None
        if base is not None:
            lib = base["weighted_moments"]
            differs = not bits_equal(torch, boot, baseline_moments(
                torch, lib, t[:3], t[3], t[4], t[5]))
            if differs and lib.same_chunks:
                raise AssertionError(f"{tag}: differs from the baseline "
                                     "kernel")
        emit(check="edge_weighted_nan", case=tag, **classes,
             nan_strata=[l1, l2], max_abs_err=e, baseline_differs=differs)
    return len(shapes)


# (Q, k, s, d, R) of rows 3 and 4 around slot chunks of WEIGHTED_CHUNK =
# 2048: on one chunk (the parent's bits) and one past it; on and past
# 32,768 (the parent's largest s), Queue 3 item 1's 40,000 slots, past
# 65,536; k = 1, 3 and 17; d = 1, 3 and 16; NaN coordinates on valid slots
# in every other case.
WEIGHTED_CHUNK_CASES = ((33, 3, 2048, 3, 9), (33, 1, 2049, 1, 9),
                        (17, 17, 32_768, 3, 2), (40, 3, 32_769, 3, 8),
                        (36, 1, 40_000, 1, 7), (20, 17, 40_000, 16, 2),
                        (24, 3, 65_537, 3, 3))
# The most slots a stratum a baseline from before the slot chunks of rows 3
# and 4 takes.
BASELINE_WEIGHTED_MAX_S = 32_768


def baseline_bits_required(lib, s) -> bool:
    """Whether rows 3 and 4 must give the baseline's bits at s slots a
    stratum: always when the baseline folds the same slot chunks of
    WEIGHTED_CHUNK (its ``repro_weighted_chunk``), else up to one chunk,
    where an older baseline's one fold is the same order."""
    from repro_torch.kernels.stratified_estimate import WEIGHTED_CHUNK
    return lib.same_chunks or s <= WEIGHTED_CHUNK


def weighted_baseline_differing(torch, tag, x, want) -> int:
    """Values of rows 3 and 4 that differ from the baseline's above one
    slot chunk, where the chunk fold changes their summation order (as
    rows 2 and 8's did in PR 23); printed, and held within tolerance of
    plain elsewhere."""
    n = int((x.view(torch.int32) != want.view(torch.int32)).sum())
    emit(check="weighted baseline above one chunk", case=tag,
         differing=n, values=int(x.numel()))
    return n


def weighted_plain_chunked(torch, c, a, valid, W, q_lo, q_hi):
    """bootstrap_moments_plain over chunks of queries, so that its
    (8, Q', k, s) temporaries stay near 2**25 elements (its replicates
    already run in blocks of 8)."""
    from repro_torch.kernels.bootstrap import bootstrap_moments_plain
    k, s = a.shape
    step = max(1, (1 << 25) // (8 * k * max(s, 1)))
    return torch.cat([bootstrap_moments_plain(c, a, valid, W, q_lo[i:i + step],
                                              q_hi[i:i + step])
                      for i in range(0, q_lo.shape[0], step)], 1)


def weighted_chunk_check(torch, tag, c, a, valid, W, q_lo, q_hi,
                         base=None) -> float:
    """Rows 3 and 4 at one shape, three ways and against plain:
    bootstrap_moments bit-equal across two launches; its block bit-equal
    to R launches of stratified_weighted_moments (the scan); its rows of
    query 0 and of a slice alone bit-equal to the same rows of the batch;
    within rtol=3e-5, atol=1e-3 of the plain version (over query chunks);
    with a baseline, both kernels bit-equal to the baseline's wherever
    baseline_bits_required, the differing values counted elsewhere up to
    BASELINE_WEIGHTED_MAX_S. Returns the max absolute error."""
    from repro_torch.kernels.bootstrap import bootstrap_moments_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_weighted_moments_cuda)
    sm, q = (c, a, valid), (q_lo, q_hi)
    boot = bootstrap_moments_cuda(*sm, W, *q)
    if not bits_equal(torch, boot, bootstrap_moments_cuda(*sm, W, *q)):
        raise AssertionError(f"{tag}: bootstrap_moments differs between "
                             "two launches")
    for r in range(W.shape[0]):
        if not bits_equal(torch, boot[r], stratified_weighted_moments_cuda(
                *sm, W[r].contiguous(), *q)):
            raise AssertionError(f"{tag}: bootstrap_moments[{r}] is not the "
                                 f"scan's stratified_weighted_moments(W[{r}])")
    Q = q_lo.shape[0]
    for sl in (slice(0, 1), slice(Q // 3, Q - 1)):
        part = bootstrap_moments_cuda(*sm, W, q_lo[sl].contiguous(),
                                      q_hi[sl].contiguous())
        if not bits_equal(torch, part, boot[:, sl]):
            raise AssertionError(f"{tag}: rows {sl.start}-{sl.stop - 1} "
                                 "alone differ from the batch's")
    if base is not None and baseline_bits_required(base["weighted_moments"],
                                                   a.shape[1]):
        lib = base["weighted_moments"]
        if not (bits_equal(torch, boot, baseline_moments(torch, lib, sm, W,
                                                         *q))
                and bits_equal(torch, boot[0], baseline_moments(
                    torch, lib, sm, W[0].contiguous(), *q))):
            raise AssertionError(f"{tag}: differs from the baseline kernel")
    elif base is not None and a.shape[1] <= BASELINE_WEIGHTED_MAX_S:
        weighted_baseline_differing(torch, tag, boot, baseline_moments(
            torch, base["weighted_moments"], sm, W, *q))
    err = close(f"{tag} bootstrap_moments", boot.cpu(),
                weighted_plain_chunked(torch, *sm, W, *q).cpu(), K_RTOL,
                K_ATOL)
    del boot
    torch.cuda.empty_cache()
    return err


def edge_cases_weighted_chunks(torch, dev, base=None) -> dict:
    """Rows 3 and 4 around one slot chunk (WEIGHTED_CHUNK_CASES) on
    chunk_case's banded inputs with Poisson and non-integer weights (on
    invalid slots too): each chunk's classes printed (all three in some
    chunk of every case with k > 1), weighted_chunk_check on each, NaN
    coordinates on valid slots of a chunk in every other case. Returns the
    max absolute error and the case count."""
    from repro_torch.kernels.stratified_estimate import WEIGHTED_CHUNK
    err = 0.0
    for i, (Q, k, s, d, R) in enumerate(WEIGHTED_CHUNK_CASES):
        rng = np.random.default_rng(Q * 37 + k * 11 + s + d)
        c, a, valid, q_lo, q_hi = chunk_case(rng, Q, k, s, d,
                                             nan=i % 2 == 1,
                                             chunk=WEIGHTED_CHUNK)
        W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
        W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
        t = [torch.from_numpy(x).to(dev) for x in (c, a, valid, W, q_lo,
                                                   q_hi)]
        tag = f"edge weighted chunks Q={Q} k={k} s={s} d={d} R={R}"
        per_chunk = chunk_classes(torch, t[0], t[2], t[4], t[5],
                                  chunk=WEIGHTED_CHUNK)
        if k > 1 and not any(min(x.values()) > 0 for x in per_chunk):
            raise AssertionError(f"{tag}: no chunk holds all three "
                                 f"classes: {per_chunk}")
        e = weighted_chunk_check(torch, tag, *t, base=base)
        err = max(err, e)
        emit(check="edge_weighted_chunk_classes", case=tag,
             chunks=len(per_chunk), chunk_classes=per_chunk,
             nan=i % 2 == 1, max_abs_err=e,
             baseline_bit_equal=None if base is None
             or not baseline_bits_required(base["weighted_moments"], s)
             else True)
    return {"err": err, "cases": len(WEIGHTED_CHUNK_CASES)}


# (Q, k, s, d, R, layout) of the walk of rows 3 and 4's mixed pairs: R = 1
# (lanes take pairs), 31, 33 and 200 (lanes take replicates: one block of
# 31, a block and one replicate, six and a part); Q off multiples of 32;
# ragged last chunks (4100 = 2 x 2048 + 4, 2049) and one short segment (s
# = 75); masks with bits only in a chunk's last word ("last"), every pair
# mixed as at Table 1's US arm ("uniform"), NaN coordinates on valid slots
# ("nan").
WALK_CASES = ((45, 1, 4100, 1, 1, "uniform"), (45, 1, 4100, 1, 33, "uniform"),
              (70, 2, 2049, 2, 31, "last"), (70, 2, 2049, 2, 1, "last"),
              (33, 3, 6000, 1, 200, "nan"), (97, 1, 75, 3, 33, "uniform"),
              (40, 2, 4096, 3, 200, "last"), (31, 1, 2048, 1, 31, "nan"))


def walk_case(rng, Q, k, s, d, R, layout):
    """Inputs of one WALK_CASES case: c ~ U(0, 1)^d (every chunk spans the
    cube, so every (query, chunk) pair of a box query is mixed), ragged
    validity, Poisson and non-integer weights (on invalid slots too, with
    +-inf and NaN there), boxes of 5-60 % a column and query 0 over every
    sample. "last": the slots of each chunk's last word of 32 lie in [0.9,
    1)^d and the rest below 0.85, and every other query is [0.9, 1]^d, so
    its mask bits lie in that word alone; "nan": a NaN coordinate on the
    first valid slot of each stratum's chunks."""
    from repro_torch.kernels.stratified_estimate import WEIGHTED_CHUNK
    c = rng.uniform(0, 1, (k, s, d)).astype(np.float32)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
    bad = np.array([np.inf, -np.inf, np.nan], np.float32)
    W[:, ~valid] = bad[rng.integers(0, 3, (R, int((~valid).sum())))]
    q_lo = rng.uniform(0, 0.9, (Q, d)).astype(np.float32)
    q_hi = np.minimum(q_lo + rng.uniform(0.05, 0.6, (Q, d)), 1.0
                      ).astype(np.float32)
    pos = np.arange(s) % WEIGHTED_CHUNK
    ch_len = np.minimum(WEIGHTED_CHUNK, s - np.arange(s) // WEIGHTED_CHUNK
                        * WEIGHTED_CHUNK)
    if layout == "last":
        last = pos >= (ch_len - 1) // 32 * 32
        c[:, last] = rng.uniform(0.9, 1.0, (k, int(last.sum()), d))
        c[:, ~last] = rng.uniform(0.0, 0.85, (k, int((~last).sum()), d))
        q_lo[1::2], q_hi[1::2] = 0.9, 1.0
    if layout == "nan":
        for leaf in range(k):
            for s0 in range(0, s, WEIGHTED_CHUNK):
                on = np.flatnonzero(valid[leaf, s0:s0 + WEIGHTED_CHUNK])
                if on.size:
                    c[leaf, s0 + on[0], d - 1] = np.nan
    q_lo[0], q_hi[0] = -1.0, 2.0
    return c, a, valid, W, q_lo, q_hi


def edge_cases_weighted_walk(torch, dev, base=None) -> dict:
    """Rows 3 and 4's walk of the mixed pairs at WALK_CASES: each case's
    chunk classes printed (mixed pairs in every case), weighted_chunk_check
    (within tolerance of plain, bit-equal across launches, fused = R scan
    launches, rows = batch, the baseline's bits); "last" cases have mask
    bits in a chunk's last word only. Returns the max absolute error and
    the case count."""
    from repro_torch.kernels.stratified_estimate import (WEIGHTED_CHUNK,
                                                         weighted_walk)
    t0 = time.perf_counter()
    err = 0.0
    for i, (Q, k, s, d, R, layout) in enumerate(WALK_CASES):
        rng = np.random.default_rng(1000 + i)
        x = walk_case(rng, Q, k, s, d, R, layout)
        t = [torch.from_numpy(v).to(dev) for v in x]
        tag = f"edge weighted walk Q={Q} k={k} s={s} d={d} R={R} {layout}"
        per_chunk = chunk_classes(torch, t[0], t[2], t[4], t[5],
                                  chunk=WEIGHTED_CHUNK)
        if not any(cl["mixed"] for cl in per_chunk):
            raise AssertionError(f"{tag}: no mixed pair: {per_chunk}")
        if layout == "last":
            from repro_torch.kernels.stratified_estimate import samples_inside
            held = samples_inside(t[0], t[2], t[4][1::2], t[5][1::2]).any(0)
            j = torch.arange(s, device=dev)
            start = j // WEIGHTED_CHUNK * WEIGHTED_CHUNK
            ch_len = torch.clamp(s - start, max=WEIGHTED_CHUNK)
            if (held & (j - start < (ch_len - 1) // 32 * 32)).any():
                raise AssertionError(f"{tag}: a mask bit outside a chunk's "
                                     "last word")
        e = weighted_chunk_check(torch, tag, *t, base=base)
        err = max(err, e)
        emit(check="edge_weighted_walk", case=tag, walk=weighted_walk(R, s),
             chunk_classes=per_chunk, max_abs_err=e,
             baseline_bit_equal=None if base is None
             or not baseline_bits_required(base["weighted_moments"], s)
             else True)
    out = {"err": err, "cases": len(WALK_CASES),
           "seconds": time.perf_counter() - t0}
    emit(check="edge_weighted_walk_cases", **out)
    return out


def boot_serve(torch, tag, run, max_median_err, scan: bool) -> dict:
    """PassEngine(syn, kinds=sum/count/avg, CIConfig(method="bootstrap",
    n_boot=200, key=5)).answer() on the main path's synopsis and queries,
    each answer its own launch window: fused launches bootstrap_moments
    once and no weighted kernel; scan (when ``scan``) launches
    stratified_weighted_moments 200 times and no bootstrap_moments, and
    equals fused bit for bit in both normalize modes. Then the truth of 64
    queries inside [lower, upper] and the AVG interval overlapping the CLT
    one on at least 0.9 of the queries whose count estimate is positive."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.kernels import native
    syn, q = run["syn"], run["q"]
    Q = int(q.lo.shape[0])
    modes = [("hajek", True)]
    if scan:
        modes += [("hajek", False), ("ht", True), ("ht", False)]
    res, engs, launches = {}, {}, {}
    for norm, fused in modes:
        eng = PassEngine(syn, ServingConfig(kinds=BOOT_KINDS),
                         boot_ci(boot_normalize=norm, boot_fused=fused))
        torch.cuda.synchronize()
        native.reset_launches()
        t0 = time.perf_counter()
        out = eng.answer(q)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        got = dict(native.LAUNCHES)
        want = dict.fromkeys(got, 0)
        want.update(query_eval=1, stratified_moments=1)
        # Row 10: one draw of all R weight rows, or one a replicate.
        if fused:
            want.update(bootstrap_moments=1, threefry=1)
        else:
            want.update(stratified_weighted_moments=N_BOOT,
                        threefry=N_BOOT)
        if got != want:
            raise AssertionError(f"{tag} bootstrap {norm} fused={fused}: "
                                 f"launches {got} != {want}")
        if eng.stats()["fused_serves"] != int(fused):
            raise AssertionError(f"{tag}: fused_serves {eng.stats()}")
        check_result_shapes(torch, f"{tag} bootstrap", out, Q, BOOT_KINDS)
        emit(path=f"{tag} bootstrap", normalize=norm, fused=fused,
             first_answer_s=seconds, launches=got,
             fused_serves=eng.stats()["fused_serves"])
        res[norm, fused], engs[norm, fused], launches[norm, fused] = \
            out, eng, got
    if scan:
        for norm in ("hajek", "ht"):
            for kind in BOOT_KINDS:
                for field in ("estimate", "ci_lo", "ci_hi"):
                    a = getattr(res[norm, True][kind], field)
                    b = getattr(res[norm, False][kind], field)
                    if not torch.equal(a, b):
                        raise AssertionError(
                            f"{tag} {norm} {kind}.{field}: fused != scan in "
                            f"{int((a != b).sum())} queries")
        emit(check="fused_equals_scan", path=tag, normalize=["hajek", "ht"],
             ok=True)
    out = res["hajek", True]
    emit(check="truth", path=f"{tag} bootstrap",
         **check_truth(f"{tag} bootstrap", out, run["truth"], 64,
                       max_median_err, BOOT_KINDS))
    clt = run["eng"].answer(q)
    nonempty = clt["count"].estimate > 0
    b, c = out["avg"], clt["avg"]
    overlap = float(((b.ci_lo <= c.ci_hi) & (c.ci_lo <= b.ci_hi))[nonempty]
                    .float().mean())
    emit(check="bootstrap_clt_overlap", path=tag, kind="avg",
         queries=int(nonempty.sum()), overlap=overlap,
         boot_width_median=float((b.ci_hi - b.ci_lo)[nonempty].median()),
         clt_width_median=float((c.ci_hi - c.ci_lo)[nonempty].median()))
    if overlap < 0.9:
        raise AssertionError(f"{tag}: AVG bootstrap overlaps CLT on "
                             f"{overlap} of the queries < 0.9")
    return {"eng": engs["hajek", True], "res": out,
            "scan_eng": engs.get(("hajek", False)),
            "launches": launches["hajek", True],
            "scan_launches": launches.get(("hajek", False))}


def planner_path(torch, tag, run) -> dict:
    """plan_queries (host numpy) over the main path's queries, then
    answer(plan=) with ci=0.95 and with the bootstrap in one launch window,
    in which query_eval must not launch; both answers equal the port's CPU
    answer(plan=). Reports the (query, leaf) pairs where the plan's masks
    differ from query_eval's relation codes."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.engine.executor import plan_to_masks
    from repro_torch.engine.planner import plan_queries
    from repro_torch.kernels import native, ops
    syn, q = run["syn"], run["q"]
    t0 = time.perf_counter()
    plan = plan_queries(syn.tree, q.lo, q.hi, syn.num_leaves)
    plan_s = time.perf_counter() - t0
    rel, _ = ops.query_eval(syn.leaf_lo, syn.leaf_hi, syn.leaf_agg, q.lo,
                            q.hi)
    cover, partial, _ = plan_to_masks(plan, q.lo.device)
    rel_plan = torch.where(cover, 2, torch.where(partial, 1, 0))
    differ = int((rel_plan != rel).sum())
    torch.cuda.synchronize()
    native.reset_launches()
    res_c = PassEngine(syn, ServingConfig(kinds=KINDS), ci=0.95).answer(
        q, plan=plan)
    res_b = PassEngine(syn, ServingConfig(kinds=BOOT_KINDS),
                       boot_ci()).answer(q, plan=plan)
    torch.cuda.synchronize()
    launches = dict(native.LAUNCHES)
    want = dict.fromkeys(launches, 0)
    # The ci=0.95 answer asks all five kinds, so MIN/MAX's extremes too.
    want.update(stratified_moments=2, bootstrap_moments=1,
                sample_extremes=1, threefry=1)
    if launches != want:
        raise AssertionError(f"{tag} planner: launches {launches} != {want}")
    Q = int(q.lo.shape[0])
    check_result_shapes(torch, f"{tag} plan ci=0.95", res_c, Q)
    check_result_shapes(torch, f"{tag} plan bootstrap", res_b, Q,
                        BOOT_KINDS)
    emit(path=f"{tag} planner", plan_s=plan_s, launches=launches,
         visited_mean=float(plan.visited.mean()),
         frontier_mean=float(plan.frontier_size.mean()),
         pairs_differing_from_query_eval=differ,
         pairs=int(rel.numel()))
    check_cpu_parity(torch, f"{tag} plan ci=0.95", syn, q, res_c, plan=True)
    check_cpu_parity(torch, f"{tag} plan bootstrap", syn, q, res_b, n=16,
                     kinds=BOOT_KINDS, ci=boot_ci(), plan=True)
    return {"launches": launches, "differ": differ}


BASELINE_SOURCES = ("weighted_moments", "stratified_moments",
                    "sample_extremes", "segment_reduce", "route_multid",
                    "query_eval", "join_moments")


def build_baseline(base: Path) -> dict:
    """The kernels of rows 1-9 from an earlier checkout ``base``: its
    weighted_moments.cu, stratified_moments.cu, sample_extremes.cu,
    segment_reduce.cu, route_multid.cu, query_eval.cu and join_moments.cu,
    built with the same nvcc flags (one process each, all at once) into
    build/baseline/ and loaded with ctypes, to be held against the current
    ones and timed beside them on the same card. Rows 2 and 8 from before
    the slot chunks (no ``repro_<name>_slot_chunk``) take no scratch.
    Weighted sources from before the cover/empty redesign (no
    ``repro_weighted_plan``) take no scratch pointer, and from before the
    slot chunks (no ``repro_weighted_chunk``) no scratch size; the
    scratch is the size the baseline's ``repro_weighted_scratch`` asks for,
    or the current one's without it; row 9 from before
    the class tiles (no ``repro_join_moments_scratch``) takes no scratch;
    segment_reduce.cu
    sources from before the one-launch weighted kernel (no
    ``repro_weighted_segment_max_chunks``) take a scratch of chunk partials
    and launch twice, and from before the cooperative segment_reduce (no
    ``repro_segment_reduce_max_chunks``) its segment_reduce takes a
    partials scratch and out apart; route_multid.cu sources from before the
    cluster kernel (no ``repro_route_max_groups``) take no plan."""
    from repro_torch.kernels import native
    csrc = base / "src" / "repro_torch" / "kernels" / "csrc"
    out_dir = native.BUILD_DIR.parent / "baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [native._nvcc(), *native.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
         str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name in BASELINE_SOURCES}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"baseline nvcc failed for {name}:\n{log}")
    emit(phase="baseline build", sources=[str(csrc / f"{n}.cu")
                                          for n in BASELINE_SOURCES],
         seconds=time.perf_counter() - t0)
    libs = {name: ctypes.CDLL(str(out_dir / f"{name}.so"))
            for name in BASELINE_SOURCES}
    lib = libs["weighted_moments"]
    lib.scratch = hasattr(lib, "repro_weighted_plan")
    lib.chunked = hasattr(lib, "repro_weighted_chunk")
    # A baseline with this checkout's slot chunks folds rows 3 and 4 in the
    # same order at every s: its bits are required everywhere.
    from repro_torch.kernels.stratified_estimate import WEIGHTED_CHUNK
    lib.same_chunks = (lib.chunked
                       and lib.repro_weighted_chunk() == WEIGHTED_CHUNK)
    if hasattr(lib, "repro_weighted_scratch"):
        lib.repro_weighted_scratch.argtypes = [ctypes.c_int] * 5
        lib.repro_weighted_scratch.restype = ctypes.c_longlong
    ptrs = [ctypes.c_void_p] * (8 if lib.scratch else 7) + (
        [ctypes.c_longlong] if lib.chunked else [])
    lib.repro_stratified_weighted_moments.argtypes = \
        ptrs + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.repro_bootstrap_moments.argtypes = ptrs + [ctypes.c_int] * 5 + \
        [ctypes.c_void_p]
    lib.repro_stratified_weighted_moments.restype = ctypes.c_int
    lib.repro_bootstrap_moments.restype = ctypes.c_int
    for name in ("stratified_moments", "sample_extremes"):
        lib = libs[name]
        lib.chunked = hasattr(lib, f"repro_{name}_slot_chunk")
        # A baseline with wide kernels (d > 16) folds every pair in the
        # same order: rows 2 and 8 must give its bits at every d and s.
        lib.wide = (csrc / "wide_cols.cuh").exists()
        fn = getattr(lib, f"repro_{name}")
        fn.argtypes = [ctypes.c_void_p] * 6 + (
            [ctypes.c_void_p, ctypes.c_longlong] if lib.chunked else []) + \
            [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    seg = libs["segment_reduce"]
    seg.cooperative = hasattr(seg, "repro_segment_reduce_max_chunks")
    seg.repro_segment_reduce.argtypes = \
        [ctypes.c_void_p] * (3 if seg.cooperative else 4) + \
        [ctypes.c_int] * (3 if seg.cooperative else 2) + [ctypes.c_void_p]
    seg.repro_segment_reduce_chunk.argtypes = [ctypes.c_int]
    for fn in (seg.repro_segment_reduce, seg.repro_segment_reduce_chunk):
        fn.restype = ctypes.c_int
    seg.one_launch = hasattr(seg, "repro_weighted_segment_max_chunks")
    seg.repro_weighted_segment_reduce.argtypes = \
        [ctypes.c_void_p] * (4 if seg.one_launch else 5) + \
        [ctypes.c_int] * (4 if seg.one_launch else 2) + [ctypes.c_void_p]
    seg.repro_weighted_segment_reduce.restype = ctypes.c_int
    rt = libs["route_multid"]
    rt.clustered = hasattr(rt, "repro_route_max_groups")
    rt.repro_route_multid.argtypes = [ctypes.c_void_p] * 5 + \
        [ctypes.c_int] * (6 if rt.clustered else 3) + [ctypes.c_void_p]
    rt.repro_route_multid.restype = ctypes.c_int
    qe = libs["query_eval"]
    qe.repro_query_eval.argtypes = [ctypes.c_void_p] * 7 + \
        [ctypes.c_int] * 4 + [ctypes.c_void_p]
    qe.repro_query_eval.restype = ctypes.c_int
    jm = libs["join_moments"]
    jm.scratch = hasattr(jm, "repro_join_moments_scratch")
    # A baseline with wide kernels: row 9's bits at every D > 16 too.
    jm.wide = (csrc / "wide_cols.cuh").exists()
    jm.repro_join_cell_moments.argtypes = (
        [ctypes.c_void_p] * (15 if jm.scratch else 14)
        + ([ctypes.c_longlong] if jm.scratch else []) + [ctypes.c_int] * 5
        + [ctypes.c_float] * 2 + [ctypes.c_void_p])
    jm.repro_join_cell_moments.restype = ctypes.c_int
    return libs


def baseline_call(name, lib_fn, *args) -> None:
    """Call a baseline kernel's C entry on the current stream; raise on a
    nonzero cudaError_t."""
    import torch
    err = lib_fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"baseline {name}: cuda error {err}")


def baseline_moments(torch, lib, sm, w, q_lo, q_hi):
    """The baseline weighted kernel's (Q, k, 3) for a weight row w (k, s),
    or its (R, Q, k, 3) for W (R, k, s)."""
    from repro_torch.kernels.stratified_estimate import weighted_scratch
    c, a, valid = sm
    k, s = a.shape
    Q, d = q_lo.shape
    R = w.shape[0] if w.dim() == 3 else 1
    out = torch.empty((R, Q, k, 3) if w.dim() == 3 else (Q, k, 3),
                      dtype=torch.float32, device=a.device)
    ptrs = [x.data_ptr() for x in (c, a, valid, w, q_lo, q_hi, out)]
    if lib.scratch:
        n = (lib.repro_weighted_scratch(R, Q, k, s, d)
             if hasattr(lib, "repro_weighted_scratch") else -1)
        scratch = (weighted_scratch(R, Q, k, s, d, a.device) if n < 0
                   else torch.empty(n, dtype=torch.float32, device=a.device))
        ptrs.append(scratch.data_ptr())
        if lib.chunked:
            ptrs.append(scratch.numel())
    if w.dim() == 2:
        baseline_call("stratified_weighted_moments",
                      lib.repro_stratified_weighted_moments, *ptrs, Q, k, s,
                      d)
    else:
        baseline_call("bootstrap_moments", lib.repro_bootstrap_moments,
                      *ptrs, R, Q, k, s, d)
    return out


def baseline_join(torch, libs, slots, q_lo, q_hi, cover, sampled, cell_agg,
                  total_rows, p_u):
    """The baseline join_cell_moments kernel's JoinMoments on row 9's
    arguments; one that takes a scratch gets its own."""
    from repro_torch.kernels.join_moments import (PLANES, JoinMoments,
                                                  _scales,
                                                  join_scratch_floats)
    lib = libs["join_moments"]
    k, su, P, D = (slots.num_leaves, slots.capacity, slots.num_partitions,
                   slots.d)
    Q, kp = q_lo.shape[0], k * P
    dev = q_lo.device
    planes = torch.empty((len(PLANES), Q, kp), dtype=torch.float32,
                         device=dev)
    exact3 = torch.empty((Q, 3), dtype=torch.float32, device=dev)
    touched = torch.empty((Q,), dtype=torch.float32, device=dev)
    extra = ()
    if lib.scratch:
        scratch = torch.empty(join_scratch_floats(kp), dtype=torch.float32,
                              device=dev)
        extra = (scratch.data_ptr(), scratch.numel())
    baseline_call("join_cell_moments", lib.repro_join_cell_moments,
                  *(x.data_ptr() for x in (
                      slots.s_coord, slots.s_a, slots.s_last,
                      slots.cell_start, slots.cell_box, q_lo, q_hi, cover,
                      sampled, cell_agg, total_rows, planes, exact3,
                      touched)), *extra, Q, k, su, P, D, *_scales(p_u))
    return JoinMoments(*planes.unbind(0), exact3=exact3, touched=touched)


def baseline_pair(torch, libs, name, c, a, valid, q_lo, q_hi):
    """The baseline stratified_moments kernel's (Q, k, 3) or sample_extremes
    kernel's (2, Q, k); one that takes a scratch gets its own."""
    from repro_torch.kernels.stratified_estimate import pair_scratch_floats
    k, s, d = c.shape
    Q = q_lo.shape[0]
    stats = 3 if name == "stratified_moments" else 2
    out = torch.empty((Q, k, 3) if stats == 3 else (2, Q, k),
                      dtype=torch.float32, device=a.device)
    lib = libs[name]
    extra = ()
    if lib.chunked:
        n = pair_scratch_floats(Q, k, s, d, stats)
        scratch = (torch.empty(n, dtype=torch.float32, device=a.device)
                   if n else None)
        extra = (scratch.data_ptr() if n else None, n)
    baseline_call(name, getattr(lib, f"repro_{name}"),
                  *(x.data_ptr() for x in (c, a, valid, q_lo, q_hi, out)),
                  *extra, Q, k, s, d)
    return out


def baseline_query_eval(torch, libs, leaf_lo, leaf_hi, leaf_agg, q_lo,
                        q_hi):
    """The baseline query_eval kernel's (rel, exact)."""
    lib = libs["query_eval"]
    k, d = leaf_lo.shape
    Q, A = q_lo.shape[0], leaf_agg.shape[1]
    rel = torch.empty((Q, k), dtype=torch.int32, device=q_lo.device)
    exact = torch.empty((Q, A), dtype=torch.float32, device=q_lo.device)
    baseline_call("query_eval", lib.repro_query_eval,
                  *(x.data_ptr() for x in (leaf_lo, leaf_hi, leaf_agg, q_lo,
                                           q_hi, rel, exact)), Q, k, d, A)
    return rel, exact


def baseline_segment(torch, libs, v, ids, k):
    """The baseline segment_reduce kernel's (k, 5)."""
    lib = libs["segment_reduce"]
    n = v.shape[0]
    ch = lib.repro_segment_reduce_chunk(n)
    chunks = -(-n // ch)
    if lib.cooperative:
        buf = torch.empty(((chunks + 1) * k, 5), dtype=torch.float32,
                          device=v.device)
        baseline_call("segment_reduce", lib.repro_segment_reduce,
                      v.data_ptr(), ids.data_ptr(), buf.data_ptr(), n, k, ch)
        return buf[:k]
    part = torch.empty(max(chunks, 1) * 5 * k, dtype=torch.float32,
                       device=v.device)
    out = torch.empty((k, 5), dtype=torch.float32, device=v.device)
    baseline_call("segment_reduce", lib.repro_segment_reduce, v.data_ptr(),
                  ids.data_ptr(), part.data_ptr(), out.data_ptr(), n, k)
    return out


def baseline_route(torch, libs, lo, hi, c):
    """The baseline route_multid kernel's (leaf, dist); a clustered one
    with the plan its version's wrapper gave it: route_launch_plan where
    it has a wide kernel of its own shape (repro_route_wide_warps), else
    route_plan at every d."""
    from repro_torch.kernels.route import route_launch_plan, route_plan
    lib = libs["route_multid"]
    k, d = lo.shape
    B = c.shape[0]
    leaf = torch.empty((B,), dtype=torch.int32, device=c.device)
    dist = torch.empty((B,), dtype=torch.float32, device=c.device)
    plan = (() if not lib.clustered
            else route_launch_plan(B, k, d)
            if hasattr(lib, "repro_route_wide_warps") else route_plan(B, k))
    baseline_call("route_multid", lib.repro_route_multid, lo.data_ptr(),
                  hi.data_ptr(), c.data_ptr(), leaf.data_ptr(),
                  dist.data_ptr(), B, k, d, *plan)
    return leaf, dist


def baseline_wseg(torch, libs, v, w, ids, k):
    """The baseline weighted_segment_reduce kernel's (k, 3): the two-launch
    version with its chunk partials, or the one-launch version with the
    current wrapper's plan."""
    from repro_torch.kernels.segment_reduce import weighted_segment_plan
    lib = libs["segment_reduce"]
    n = v.shape[0]
    ptrs = [x.data_ptr() for x in (v, w, ids)]
    if lib.one_launch:
        chunks, ch, rows = weighted_segment_plan(n, k)
        buf = torch.empty((rows, 3), dtype=torch.float32, device=v.device)
        baseline_call("weighted_segment_reduce",
                      lib.repro_weighted_segment_reduce, *ptrs,
                      buf.data_ptr(), n, k, chunks, ch)
        return buf[:k]
    chunks = -(-n // lib.repro_segment_reduce_chunk(n))
    part = torch.empty(max(chunks, 1) * 3 * k, dtype=torch.float32,
                       device=v.device)
    out = torch.empty((k, 3), dtype=torch.float32, device=v.device)
    baseline_call("weighted_segment_reduce",
                  lib.repro_weighted_segment_reduce, *ptrs, part.data_ptr(),
                  out.data_ptr(), n, k)
    return out


def boot_weights(torch, syn, device):
    """The fused bootstrap's weights (R, k, s) for ``syn``: the threefry
    draw of BOOT_KEY (one row-10 launch), zero on invalid slots."""
    from repro_torch.uncertainty import bootstrap as tboot
    key = tboot.key_tensor(BOOT_KEY, device)
    return tboot.poisson_weights(key, syn.sample_valid, N_BOOT)[0]


def boot_kernel_3d(torch, run, card, base) -> dict:
    """bootstrap_moments at the 3-D bootstrap answer's shapes (R = 200):
    its time, the pair classes there and, with a baseline, rows 3 and 4 in
    turns with its kernels (weighted_turns), bit-equal to them."""
    from repro_torch.kernels.bootstrap import bootstrap_moments_cuda
    from repro_torch.kernels.stratified_estimate import weighted_plan
    syn, q = run["syn"], run["q"]
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    W = boot_weights(torch, syn, q.lo.device)
    k, s = syn.sample_a.shape
    out = {"classes": pair_classes(torch, syn.sample_c, syn.sample_valid,
                                   q.lo, q.hi),
           "plan_leaves_per_tile_and_smem_bytes": weighted_plan(
               int(q.lo.shape[0]), k, s, int(q.lo.shape[1])),
           "ms": cuda_ms(torch, lambda: bootstrap_moments_cuda(
               *sm, W, q.lo, q.hi), reps=10)}
    if base is not None:
        out["turns"] = weighted_turns(torch, "3d", sm, W, q.lo, q.hi, base)
        out["ms_baseline"] = out["turns"]["bootstrap_moments"]["baseline_ms"]
    emit(bootstrap_moments_3d=out, Q=int(q.lo.shape[0]), k=k, s=s,
         R=N_BOOT, card=card)
    return out


def boot_bounds(syn, q, classes, R, N) -> dict:
    """Least time for the three new kernels' work, as bounds() counts it:
    the weighted moments read the samples, the weights and the queries
    once and write 12 bytes per (replicate, query, stratum); they need each
    leaf's box and each pair's class as bounds() counts them, each leaf's
    weighted totals (5 operations a slot and replicate) and the mixed
    pairs' walks (2 compares a slot in each column that cuts the pair, as
    bounds() counts them, 5 operations a slot and replicate).
    weighted_segment_reduce reads 12 bytes a row, writes 12 a segment, 5
    operations a row."""
    Q, d = q.lo.shape
    k, s = syn.sample_a.shape
    valid = int(syn.sample_valid.sum())
    samples = 4 * k * s * d + 4 * k * s + k * s + 8 * Q * d
    shared_ops = 2 * d * valid + 4 * d * Q * k

    def moments_ops(r):
        return (shared_ops + 5 * r * k * s
                + s * (2 * classes["mixed_cut_columns"]
                       + 5 * r * classes["mixed"]))
    out = {}
    for name, nbytes, ops in (
            ("stratified_weighted_moments", samples + 4 * k * s + 12 * Q * k,
             moments_ops(1)),
            ("bootstrap_moments", samples + 4 * R * k * s + 12 * R * Q * k,
             moments_ops(R)),
            ("weighted_segment_reduce", 12 * N + 12 * k, 5 * N)):
        t_bytes = nbytes / PEAK_BYTES_S * 1e3
        t_ops = ops / PEAK_F32_OPS_S * 1e3
        out[name] = {"bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations", "bytes": nbytes, "operations": ops}
    return out


def boot_timings(torch, tag, run, boot, card) -> dict:
    """The bootstrap answer, fused (30 runs) and scan (5), by CUDA events
    and host clock; its split into the draw, the kernel and the epilogue;
    the peak memory of a fused answer above the resident synopsis; a
    profiler window over 3 fused answers."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.engine.executor import compute_artifacts
    from repro_torch.kernels import ops
    from repro_torch.uncertainty import bootstrap as tboot
    syn, q, eng_f = run["syn"], run["q"], boot["eng"]
    eng_s = PassEngine(syn, ServingConfig(kinds=BOOT_KINDS),
                       boot_ci(boot_fused=False))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    eng_f.answer(q)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mb

    def draw():
        return boot_weights(torch, syn, q.lo.device)

    W = draw()
    art = compute_artifacts(syn, q, BOOT_KINDS)
    mom = ops.bootstrap_moments(syn.sample_c, syn.sample_a,
                                syn.sample_valid, W, q.lo, q.hi)
    k_star = W.sum(-1)

    def epilogue():
        reps = tboot._estimates(syn, art, mom, k_star, BOOT_KINDS, "hajek")
        return tboot._quantiles(reps, (0.025, 0.975))

    times = {
        "answer_fused": cuda_ms(torch, lambda: eng_f.answer(q), reps=30,
                                warmup=3),
        "answer_fused_host": host_ms(torch, lambda: eng_f.answer(q),
                                     reps=30),
        "answer_scan": cuda_ms(torch, lambda: eng_s.answer(q), reps=5,
                               warmup=1),
        "answer_scan_host": host_ms(torch, lambda: eng_s.answer(q), reps=5),
        "artifacts": cuda_ms(torch, lambda: compute_artifacts(
            syn, q, BOOT_KINDS), reps=10),
        "draw": cuda_ms(torch, draw, reps=10),
        "bootstrap_moments": cuda_ms(torch, lambda: ops.bootstrap_moments(
            syn.sample_c, syn.sample_a, syn.sample_valid, W, q.lo, q.hi),
            reps=10),
        "epilogue": cuda_ms(torch, epilogue, reps=10),
    }
    del mom
    for _ in range(2):
        eng_f.answer(q)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            eng_f.answer(q)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, n = device_busy_us(prof)
    write_table(prof, f"profile_bootstrap_{tag}.txt")
    # The kernels' own device time (its four kernels), from the same
    # window: on an H100 a profiler window around bare bootstrap_moments
    # launches recorded no device events for them, while this one does.
    kernel_us = sum(e.device_time if hasattr(e, "device_time")
                    else e.cuda_time for e in prof.events()
                    if any(f"weighted_{part}_kernel" in e.name
                           for part in ("totals", "box", "tile", "mixed"))
                    and str(getattr(e, "device_type", "")).endswith("CUDA"))
    times["bootstrap_moments_device"] = kernel_us / 1e3 / 3
    draw_us, draw_n = row10_device_us(prof)
    times["draw_device"] = draw_us / 1e3 / 3
    prof_out = {"device_kernels_per_answer": n / 3,
                "row10_kernels_per_answer": draw_n / 3,
                "device_busy_ms_per_answer": busy_us / 1e3 / 3,
                "wall_ms_per_answer": wall_ms / 3,
                "device_busy_share": busy_us / 1e3 / wall_ms}
    emit(bootstrap_times_ms=times, path=tag, n_boot=N_BOOT,
         answer_peak_mb_above_resident=peak_mb, profile=prof_out, card=card)
    return {"times": times, "W": W}


def boot_kernel_times(torch, run, W, card, base=None) -> dict:
    """The three new kernels and their plain versions at the main path's
    shapes (Q = 2048, k = 1024, s = 75, R = 200; the plain bootstrap on the
    first PLAIN_BOOT_Q queries; weighted_segment_reduce over the flattened
    samples by stratum with the first weight row, as the JAX package's
    fused-bootstrap benchmark calls it, and over uniformly random ids),
    kernel = plain checked at each, and the nearest single library calls,
    with TF32 off, by events and on the device: torch.bmm of the predicate
    (k, Q, s) built beforehand with [w, w*a, w*a^2] (k, s, 3R)
    ("contraction only", rows 2-4) and index_add_ of a prebuilt (N, 3)
    source ("scatter only", row 6). Also the pair classes at these shapes;
    the launch overhead of the weighted kernels and stratified_moments
    (one call bracketed by events, 20 calls back to back, the host's
    enqueue time), and weighted_segment_reduce's; its device operations
    per call, which must be 1; with a baseline, its weighted kernels'
    times and outputs torch.equal to the current ones, and its
    weighted_segment_reduce's times and output within rtol=3e-5,
    atol=1e-3 of the current one; with a baseline, rows 3 and 4 in turns
    with its kernels (weighted_turns), bit-equal to them."""
    from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                               bootstrap_moments_plain)
    from repro_torch.kernels.segment_reduce import (
        weighted_segment_reduce_cuda, weighted_segment_reduce_plain)
    from repro_torch.kernels.stratified_estimate import (
        samples_inside, stratified_moments_cuda,
        stratified_weighted_moments_cuda, weighted_moments_plain)
    syn, q = run["syn"], run["q"]
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    k, s = syn.sample_a.shape
    w0 = W[0].contiguous()
    ql, qh = q.lo[:PLAIN_BOOT_Q], q.hi[:PLAIN_BOOT_Q]
    err_w = close("main stratified_weighted_moments",
                  stratified_weighted_moments_cuda(*sm, w0, q.lo,
                                                   q.hi).cpu(),
                  weighted_moments_plain(*sm, w0, q.lo, q.hi).cpu(),
                  K_RTOL, K_ATOL)
    err_b = close(f"main bootstrap_moments Q={PLAIN_BOOT_Q}",
                  bootstrap_moments_cuda(*sm, W, ql, qh).cpu(),
                  bootstrap_moments_plain(*sm, W, ql, qh).cpu(),
                  K_RTOL, K_ATOL)
    seg_v = syn.sample_a.reshape(-1)
    seg_w = w0.reshape(-1)
    seg_ids = torch.where(syn.sample_valid, torch.arange(
        k, dtype=torch.int32, device=seg_v.device)[:, None], -1
    ).reshape(-1).contiguous()
    err_s = wseg_vs_plain(torch, "main N=k*s", seg_v, seg_w, seg_ids, k)
    # Uniformly random ids over the same rows, made from a seed.
    uni_ids = torch.from_numpy(np.random.default_rng(15).integers(
        0, k, seg_v.shape[0]).astype(np.int32)).to(seg_v.device)
    err_s = max(err_s, wseg_vs_plain(torch, "main N=k*s uniform ids", seg_v,
                                     seg_w, uni_ids, k))
    classes = pair_classes(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi)
    bnd = boot_bounds(syn, q, classes, W.shape[0], seg_v.shape[0])

    def swm():
        return stratified_weighted_moments_cuda(*sm, w0, q.lo, q.hi)

    def smo():
        return stratified_moments_cuda(*sm, q.lo, q.hi)

    def x20(fn):
        return lambda: [fn() for _ in range(20)]

    overhead = {
        "stratified_weighted_moments_x20": cuda_ms(torch, x20(swm),
                                                   reps=10) / 20,
        "stratified_weighted_moments_enqueue_host": enqueue_ms(torch, swm),
        "stratified_moments_single": cuda_ms(torch, smo),
        "stratified_moments_x20": cuda_ms(torch, x20(smo), reps=10) / 20,
        "stratified_moments_enqueue_host": enqueue_ms(torch, smo)}
    base_ms = {}
    if base is not None:
        turns = weighted_turns(torch, "1d", sm, W, q.lo, q.hi, base)
        base_ms = {"turns": turns}
        for name in ("stratified_weighted_moments", "bootstrap_moments"):
            base_ms[name] = turns[name]["baseline_ms"]
            base_ms[f"{name}_device"] = turns[name]["baseline_device_ms"]

    pred = samples_inside(syn.sample_c, syn.sample_valid, q.lo, q.hi
                          ).permute(1, 0, 2).to(torch.float32).contiguous()
    a = syn.sample_a

    def rhs(w):                      # (R', k, s) -> (k, s, 3R')
        t = torch.stack([w, w * a, w * a * a], dim=-1)
        return t.permute(1, 2, 0, 3).reshape(k, s, -1).contiguous()

    rhs2 = rhs(torch.ones_like(a)[None])
    rhs3 = rhs(w0[None])
    rhs4 = rhs(W)
    src = torch.stack([seg_w * seg_v, seg_w * seg_v * seg_v, seg_w], 1)
    acc = torch.zeros((k + 1, 3), dtype=torch.float32, device=seg_v.device)
    wseg = {}
    for layout, ids in (("leaf_major", seg_ids), ("uniform", uni_ids)):
        spill = torch.where(ids >= 0, ids.long(), k)

        def kernel():
            return weighted_segment_reduce_cuda(seg_v, seg_w, ids, k)

        def library():
            return acc.index_add_(0, spill, src)

        # One launch a call: every operation the profiler recorded is the
        # kernel, and there were no more of them than calls.
        prof = device_profile(torch, kernel, one_op=True)
        if any("weighted_segment_kernel" not in n for n in prof["names"]):
            raise AssertionError(f"weighted_segment_reduce ({layout} ids) "
                                 f"ran {prof['names']}")
        row = {"ms": cuda_ms(torch, kernel), "device_ms": prof["ms"],
               "profiler_ops_per_call": prof["ops_per_call"],
               "ms_x20": cuda_ms(torch, lambda: [kernel() for _ in
                                                  range(20)], reps=10) / 20,
               "enqueue_host_ms": enqueue_ms(torch, kernel),
               "library_ms": cuda_ms(torch, library),
               "library_device_ms": device_ms(torch, library, one_op=True),
               "library_enqueue_host_ms": enqueue_ms(torch, library)}
        if base is not None:
            def old():
                return baseline_wseg(torch, base, seg_v, seg_w, ids, k)
            row["baseline_max_abs_err"] = close(
                f"main {layout} weighted_segment_reduce vs baseline",
                kernel().cpu(), old().cpu(), K_RTOL, K_ATOL)
            row["baseline_ms"] = cuda_ms(torch, old)
            row["baseline_device_ms"] = device_ms(torch, old)
        wseg[layout] = row
    times = {
        "stratified_weighted_moments": cuda_ms(
            torch, lambda: stratified_weighted_moments_cuda(
                *sm, w0, q.lo, q.hi)),
        "stratified_weighted_moments_device": device_ms(
            torch, lambda: stratified_weighted_moments_cuda(
                *sm, w0, q.lo, q.hi)),
        "stratified_weighted_moments_plain": cuda_ms(
            torch, lambda: weighted_moments_plain(*sm, w0, q.lo, q.hi),
            reps=10),
        "stratified_weighted_moments_plain_device": device_ms(
            torch, lambda: weighted_moments_plain(*sm, w0, q.lo, q.hi),
            reps=5),
        "bootstrap_moments_plain_q256": cuda_ms(
            torch, lambda: bootstrap_moments_plain(*sm, W, ql, qh), reps=3,
            warmup=1),
        "bootstrap_moments_plain_q256_device": device_ms(
            torch, lambda: bootstrap_moments_plain(*sm, W, ql, qh), reps=2,
            warmup=1),
        "bootstrap_moments_q256": cuda_ms(
            torch, lambda: bootstrap_moments_cuda(*sm, W, ql, qh)),
        "weighted_segment_reduce_plain": cuda_ms(
            torch, lambda: weighted_segment_reduce_plain(seg_v, seg_w,
                                                         seg_ids, k)),
        "weighted_segment_reduce_plain_device": device_ms(
            torch, lambda: weighted_segment_reduce_plain(seg_v, seg_w,
                                                         seg_ids, k)),
        "bmm_stratified_moments": cuda_ms(torch, lambda: torch.bmm(pred,
                                                                   rhs2)),
        "bmm_stratified_moments_device": device_ms(
            torch, lambda: torch.bmm(pred, rhs2)),
        "bmm_stratified_weighted_moments": cuda_ms(
            torch, lambda: torch.bmm(pred, rhs3)),
        "bmm_stratified_weighted_moments_device": device_ms(
            torch, lambda: torch.bmm(pred, rhs3)),
        "bmm_bootstrap_moments": cuda_ms(torch, lambda: torch.bmm(pred,
                                                                  rhs4),
                                         reps=10),
        # One cuBLAS kernel a call; a window drops some of them, so the
        # mean of those it recorded (a window of 5 once recorded none).
        "bmm_bootstrap_moments_device": device_ms(
            torch, lambda: torch.bmm(pred, rhs4), reps=10, warmup=1,
            one_op=True),
    }
    emit(new_kernel_times_ms=times, bounds=bnd, plain_boot_q=PLAIN_BOOT_Q,
         classes_1d=classes, card=card,
         launch_overhead_ms=overhead, baseline_ms=base_ms,
         weighted_segment_reduce_ms=wseg,
         max_abs_err={"stratified_weighted_moments": err_w,
                      "bootstrap_moments": err_b,
                      "weighted_segment_reduce": err_s})
    return {"times": times, "bounds": bnd, "classes": classes,
            "overhead": overhead, "baseline": base_ms, "wseg": wseg,
            "errs": {"stratified_weighted_moments": err_w,
                     "bootstrap_moments": err_b,
                     "weighted_segment_reduce": err_s}}


def wseg_fields(wseg) -> dict:
    """Row 6's times for the kernels line: the leaf-major layout's under
    the row's own keys, the uniform ids' with a ``uniform_`` prefix."""
    keys = ("ms", "device_ms", "profiler_ops_per_call", "ms_x20",
            "enqueue_host_ms", "library_ms", "library_device_ms",
            "library_enqueue_host_ms", "baseline_ms", "baseline_device_ms",
            "baseline_max_abs_err")
    return {**{key: wseg["leaf_major"].get(key) for key in keys},
            **{f"uniform_{key}": wseg["uniform"].get(key) for key in keys}}


# ---------------------------------------------------------------------------
# The serve layer: the degradation ladder, the coalescer, checkpoints and
# faults
# ---------------------------------------------------------------------------

FIELDS = ("estimate", "ci_half", "lower", "upper", "frac_rows_touched",
          "ci_lo", "ci_hi")


def bits_of(x) -> np.ndarray:
    """int32 view of float32 values (a tensor or host array), every NaN as
    one code."""
    x = np.array(host(x), np.float32)
    b = x.view(np.int32).copy()
    b[np.isnan(x)] = 0x7FC00000
    return b


def differing(got, want, kinds, rows=None) -> dict:
    """{kind.field: values whose bits differ} of two result dicts (tensors
    or host arrays), over the first ``rows`` rows of ``want`` when given;
    empty when they are the same bits."""
    out = {}
    for kind in kinds:
        for f in FIELDS:
            g, w = getattr(got[kind], f), getattr(want[kind], f)
            if g is None or w is None:
                if (g is None) != (w is None):
                    out[f"{kind}.{f}"] = "None"
                continue
            w = w if rows is None else w[:rows]
            nd = int((bits_of(g) != bits_of(w)).sum())
            if nd:
                out[f"{kind}.{f}"] = nd
    return out


def require_same(tag, got, want, kinds, rows=None) -> None:
    diff = differing(got, want, kinds, rows)
    if diff:
        raise AssertionError(f"{tag}: bits differ {diff}")


def launches_now(native) -> dict:
    return {k: v for k, v in native.LAUNCHES.items() if v}


def covered_queries(torch, syn, n: int = 256):
    """Queries every relevant stratum of which is covered: in 1-D spans of
    whole leaves (leaf i's lo to leaf j's hi), in d > 1 leaf i's own box;
    kept where the planner finds no partial stratum. Host arrays."""
    from repro_torch.engine.planner import plan_queries
    lo = syn.leaf_lo.cpu().numpy()
    hi = syn.leaf_hi.cpu().numpy()
    k = lo.shape[0]
    rng = np.random.default_rng(16)
    a = rng.integers(0, k, n)
    b = np.minimum(k - 1, a + rng.integers(0, 40, n)) if syn.d == 1 else a
    q_lo, q_hi = lo[a], hi[b]
    keep = lo[a].max(1) <= hi[b].min(1) if syn.d == 1 else \
        (lo[a] <= hi[a]).all(1)
    plan = plan_queries(syn.tree, q_lo[keep], q_hi[keep], k)
    full = ~plan.partial_leaf_mask.any(1) & plan.cover_leaf_mask.any(1)
    return q_lo[keep][full], q_hi[keep][full]


def ladder_path(torch, tag, run, card) -> dict:
    """16. The degradation ladder on the main path's synopsis and queries
    (all five kinds, ci=0.95): answer(deadline_ms=0) serves tier 0 with no
    launch and holds the truth; on covered queries it has the exact path's
    bits (COUNT, MIN, MAX against answer(); SUM against answer(plan=), which
    takes the same planner aggregates; AVG within rtol=3e-5);
    answer_progressive().final() runs ladder_tiers(75) = [9, 18, 37, None],
    each tier one launch of each serving kernel, the intervals tighten at
    every tier and the last tier's own answer is answer()'s bits;
    max_ci_width stops the ladder early. Times: tier 0 by host clock, each
    tier by events and host clock (warm)."""
    from repro_torch.api import CIConfig, PassEngine, ServingConfig
    from repro_torch.core.types import QueryBatch
    from repro_torch.engine.planner import plan_queries
    from repro_torch.kernels import native
    from repro_torch.serve import ladder_tiers, tier0_answer
    from repro_torch.serve.coalescer import host_results
    t_phase = time.perf_counter()
    syn, q = run["syn"], run["q"]
    eng = PassEngine(syn, ServingConfig(kinds=KINDS), ci=0.95)
    plain = host_results(eng.answer(q))
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    r0 = eng.answer(q, deadline_ms=0.0)
    tier0_first_ms = (time.perf_counter() - t0) * 1e3
    if launches_now(native):
        raise AssertionError(f"{tag} tier 0 launched {launches_now(native)}")
    st = eng.stats()
    if (st["tier0_serves"], st["refine_steps"], st["degraded_serves"]) \
            != (1, 0, 1):
        raise AssertionError(f"{tag} tier 0 stats {st}")
    truth_inside(f"{tag} tier 0", r0, run["truth"], 64)
    tier0_ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        tier0_answer(eng, q, KINDS)
        tier0_ms.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    plan_queries(syn.tree, q.lo, q.hi, syn.num_leaves)
    plan_ms = (time.perf_counter() - t0) * 1e3

    # Covered queries.
    c_lo, c_hi = covered_queries(torch, syn)
    cq = QueryBatch(torch.from_numpy(c_lo).cuda(),
                    torch.from_numpy(c_hi).cuda())
    t_cov = tier0_answer(eng, cq, KINDS)
    exact = host_results(eng.answer(cq))
    by_plan = host_results(eng.answer(
        cq, plan=plan_queries(syn.tree, cq.lo, cq.hi, syn.num_leaves)))
    require_same(f"{tag} tier 0 on covered queries", t_cov, exact,
                 ("count", "min", "max"))
    require_same(f"{tag} tier 0 on covered queries, plan", t_cov, by_plan,
                 ("sum",))
    avg_err = close(f"{tag} tier 0 covered avg", torch.from_numpy(
        t_cov["avg"].estimate), torch.from_numpy(exact["avg"].estimate),
        K_RTOL, 0.0)
    avg_same = int((bits_of(t_cov["avg"].estimate)
                    == bits_of(exact["avg"].estimate)).sum())

    # The ladder: first pass cold, with its launches; second pass warm.
    cap = int(syn.sample_a.shape[1])
    tiers = ladder_tiers(cap)
    if cap == 75 and tiers != [9, 18, 37, None]:
        raise AssertionError(f"{tag} ladder tiers {tiers}")
    per_tier = []
    for rnd in range(2):
        h = eng.answer_progressive(q)
        prev = {k: (host(r.ci_lo), host(r.ci_hi))
                for k, r in h.results.items()}
        widths = [h.width()]
        while not h.done:
            slots = h._tiers[0]
            torch.cuda.synchronize()
            native.reset_launches()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            h.refine()
            end.record()
            end.synchronize()
            host_ms_ = (time.perf_counter() - t0) * 1e3
            got = launches_now(native)
            want = {"query_eval": 1, "stratified_moments": 1,
                    "sample_extremes": 1}
            if got != want:
                raise AssertionError(f"{tag} tier {slots}: launches {got}")
            for kind, r in h.results.items():
                # Monotone wherever the running interval is one: a query
                # that touches no stratum has tier 0's inverted AVG
                # envelope (+-3.4e38), which the merge collapses.
                lo, hi = host(r.ci_lo), host(r.ci_hi)
                proper = prev[kind][0] <= prev[kind][1]
                if not ((lo >= prev[kind][0])[proper].all()
                        and (hi <= prev[kind][1])[proper].all()
                        and (lo <= hi)[proper].all()):
                    raise AssertionError(f"{tag} tier {slots} {kind}: the "
                                         "interval widened")
                prev[kind] = (lo, hi)
            widths.append(h.width())
            if rnd == 1:
                per_tier.append({"slots": slots, "ms": start.elapsed_time(
                    end), "host_ms": host_ms_, "launches": got})
        require_same(f"{tag} last tier against answer()", h.last_step, plain,
                     KINDS)
    inside = {k: float(np.mean(
        (host(plain[k].estimate) >= host(h.results[k].ci_lo))
        & (host(plain[k].estimate) <= host(h.results[k].ci_hi))))
        for k in KINDS}
    est_same = {k: float(np.mean(bits_of(h.results[k].estimate)
                                 == bits_of(plain[k].estimate)))
                for k in KINDS}

    # max_ci_width on sum/count/avg: a width a middle tier reaches stops
    # the ladder there; one tier 0 meets takes no tier.
    sv3 = ServingConfig(kinds=BOOT_KINDS)
    e3 = PassEngine(syn, sv3, ci=0.95)
    h = e3.answer_progressive(q)
    w3 = [h.width()]
    while not h.done:
        h.refine()
        w3.append(h.width())
    target = w3[-2] if w3[-2] < w3[0] else w3[0]
    stop = min(t for t, w in enumerate(w3) if w <= target)
    steps = {}
    for name, width in (("middle", target), ("met_by_tier0", 1e40)):
        e = PassEngine(syn, sv3, ci=0.95)
        e.answer(q, ci=CIConfig(level=0.95, max_ci_width=width))
        steps[name] = e.stats()["refine_steps"]
    if steps != {"middle": stop, "met_by_tier0": 0} or stop >= len(tiers):
        raise AssertionError(f"{tag} max_ci_width: steps {steps}, widths "
                             f"{w3}")
    out = {"tier0_first_ms": tier0_first_ms,
           "tier0_host_ms": statistics.median(tier0_ms),
           "plan_queries_ms": plan_ms, "tiers": per_tier,
           "covered_queries": int(c_lo.shape[0]),
           "covered_avg_bit_equal": avg_same,
           "covered_avg_max_abs_err": avg_err,
           "plain_estimate_inside_final_interval": inside,
           "final_estimate_bit_equal_share": est_same,
           "widths_sum_count_avg": w3, "max_ci_width_steps": steps,
           "seconds": time.perf_counter() - t_phase}
    emit(phase=f"16 ladder {tag}", card=card, **out)
    return out


def padded_class_check(torch, tag, run) -> dict:
    """Rows of a short batch against the same rows padded with empty rows
    to the next coalescer class: Q = 1, 3, 8 (class 128), 240 (512) and
    2048 (4096, two classes of 2048), all five kinds, ci=0.95, bit for
    bit."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.types import QueryBatch
    from repro_torch.serve import PAD_HI, PAD_LO
    syn, q = run["syn"], run["q"]
    eng = PassEngine(syn, ServingConfig(kinds=KINDS), ci=0.95)
    d = q.lo.shape[1]
    checked = {}
    for n, cls in ((1, 128), (3, 128), (8, 128), (240, 512), (2048, 4096)):
        pad = QueryBatch(
            torch.cat([q.lo[:n], torch.full((cls - n, d), PAD_LO,
                                            device=q.lo.device)]),
            torch.cat([q.hi[:n], torch.full((cls - n, d), PAD_HI,
                                            device=q.lo.device)]))
        sub = QueryBatch(q.lo[:n].contiguous(), q.hi[:n].contiguous())
        require_same(f"{tag} Q={n} against class {cls}", eng.answer(sub),
                     eng.answer(pad), KINDS, rows=n)
        checked[n] = cls
    emit(check="rows_against_padded_class", path=tag, checked=checked,
         ok=True)
    return checked


def tenant_batches(torch, c, sizes, seed: int, stream=None) -> list:
    """One random query batch a tenant on the card; made on ``stream``
    when given (another stream than the tick's)."""
    from repro_torch.core.query import random_queries
    from repro_torch.core.types import QueryBatch
    out = []
    for i, n in enumerate(sizes):
        qb = random_queries(c, int(n), seed=seed + i)
        if stream is not None:
            with torch.cuda.stream(stream):
                qb = QueryBatch(qb.lo * 1.0, qb.hi * 1.0)
        out.append(qb)
    return out


def coalescer_path(torch, run, c, card) -> dict:
    """17. The coalescer on the 1-D synopsis: 16 tenants of 16-240 rows
    (from a seed, ~2048 rows), CoalescerConfig(shape_classes=(128, 512,
    2048)), all five kinds, ci=0.95: one tick, fewer dispatches than
    requests, each serving kernel once a dispatch, every tenant's demuxed
    result the bits of its own PassEngine.answer; then 4 tenants under the
    fused bootstrap (sum/count/avg, R = 200), bootstrap_moments once a
    dispatch, bit-equal; then the 16 tenants under TickDriver, their
    queries made on a side stream: every future resolves, bit-equal, no
    failure. Times: the coalesced round (submit, tick, results on the
    host) and the per-tenant sequential round (answer, results on the
    host), host clock, warm."""
    from repro_torch.api import CoalescerConfig, PassEngine, ServingConfig
    from repro_torch.kernels import native
    from repro_torch.serve import RequestCoalescer, TickDriver
    from repro_torch.serve.coalescer import host_results
    t_phase = time.perf_counter()
    syn = run["syn"]
    sizes = np.random.default_rng(17).integers(16, 241, 16)
    cfg = CoalescerConfig(shape_classes=(128, 512, 2048))
    sv = ServingConfig(kinds=KINDS)
    qs = tenant_batches(torch, c, sizes, seed=300)
    ref = PassEngine(syn, sv, ci=0.95)
    want = [host_results(ref.answer(qb)) for qb in qs]

    eng = PassEngine(syn, sv, ci=0.95)
    co = RequestCoalescer(eng, cfg)
    torch.cuda.synchronize()
    native.reset_launches()
    futs = [co.submit(f"t{i}", qb) for i, qb in enumerate(qs)]
    n_disp = co.tick()
    launches = launches_now(native)
    if not 0 < n_disp < len(qs):
        raise AssertionError(f"coalescer: {n_disp} dispatches for "
                             f"{len(qs)} requests")
    each = {"query_eval": n_disp, "stratified_moments": n_disp,
            "sample_extremes": n_disp}
    if launches != each:
        raise AssertionError(f"coalescer: launches {launches} != {each}")
    for i, f in enumerate(futs):
        if f.exception(timeout=60) is not None:
            raise AssertionError(f"coalescer t{i}: {f.exception()!r}")
        require_same(f"coalescer t{i} ({sizes[i]} rows)", f.result(), want[i],
                     KINDS)
    stats = co.stats()

    def coalesced_round():
        fs = [co.submit(f"t{i}", qb) for i, qb in enumerate(qs)]
        co.tick()
        return [f.result(timeout=60) for f in fs]

    def sequential_round():
        return [host_results(ref.answer(qb)) for qb in qs]

    rounds = {"coalesced": [], "sequential": []}
    for _ in range(5):
        for name, fn in (("coalesced", coalesced_round),
                         ("sequential", sequential_round)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            rounds[name].append((time.perf_counter() - t0) * 1e3)

    # Fused bootstrap tenants.
    bsv = ServingConfig(kinds=BOOT_KINDS)
    beng = PassEngine(syn, bsv, boot_ci())
    bref = PassEngine(syn, bsv, boot_ci())
    bco = RequestCoalescer(beng, cfg)
    bwant = [host_results(bref.answer(qb)) for qb in qs[:4]]
    native.reset_launches()
    bfuts = [bco.submit(f"b{i}", qb) for i, qb in enumerate(qs[:4])]
    b_disp = bco.tick()
    blaunch = launches_now(native)
    if blaunch != {"query_eval": b_disp, "stratified_moments": b_disp,
                   "bootstrap_moments": b_disp, "threefry": b_disp} \
            or not 0 < b_disp < 4:
        raise AssertionError(f"coalescer bootstrap: {b_disp} dispatches, "
                             f"launches {blaunch}")
    for i, f in enumerate(bfuts):
        require_same(f"coalescer bootstrap b{i}", f.result(timeout=60),
                     bwant[i], BOOT_KINDS)
    del beng, bref, bco
    torch.cuda.empty_cache()

    # TickDriver, queries written on a side stream.
    side = torch.cuda.Stream()
    sq = tenant_batches(torch, c, sizes, seed=300, stream=side)
    dco = RequestCoalescer(PassEngine(syn, sv, ci=0.95),
                           CoalescerConfig(shape_classes=(128, 512, 2048),
                                           tick_ms=1.0, max_outstanding=4,
                                           max_queue_depth=64))
    native.reset_launches()
    with TickDriver(dco):
        with torch.cuda.stream(side):
            dfuts = [dco.submit(f"t{i}", qb) for i, qb in enumerate(sq)]
        for i, f in enumerate(dfuts):
            require_same(f"driver t{i}", f.result(timeout=120), want[i],
                         KINDS)
    dstats = dco.stats()
    if dstats["failed"] or dstats["served"] != len(sq) or \
            dstats["driver_errors"]:
        raise AssertionError(f"driver: {dstats}")
    out = {"tenants": len(qs), "rows": int(sizes.sum()),
           "sizes": sizes.tolist(), "dispatches": n_disp,
           "padded_rows": stats["padded_rows"], "launches": launches,
           "coalesced_round_ms": statistics.median(rounds["coalesced"]),
           "sequential_round_ms": statistics.median(rounds["sequential"]),
           "rounds_ms": rounds, "bootstrap_dispatches": b_disp,
           "bootstrap_launches": blaunch,
           "driver_dispatches": dstats["dispatches"],
           "driver_launches": launches_now(native),
           "seconds": time.perf_counter() - t_phase}
    emit(phase="17 coalescer 1d", card=card, **out)
    return out


def checkpoint_path(torch, run1, run3, s1, card, tmp: Path) -> dict:
    """18. Checkpoints and faults on the 1-D stream: StreamingIngestor(phase
    4's synopsis, seed=11) ingests 32 of phase 8's batches, the engine is
    checkpointed and restored into a fresh engine, both ingest 32 more: the
    states torch.equal, the answers (all five kinds, ci=0.95) bit-equal,
    segment_reduce launched by the restored ingestor. The 3-D synopsis
    round-trips with bit-equal answers. A FaultPlan poisons every 5th of 32
    batches (out-of-box coordinates): the quarantine counter equals the
    poisoned rows, and the state equals, torch.equal, a clean run whose
    same batches carry non-finite coordinates. The file sizes and the save
    and restore seconds are recorded."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.kernels import native
    from repro_torch.streaming import StreamingIngestor
    from repro_torch.streaming.ingest import STATE_FIELDS
    from repro_torch.testing import FaultPlan, inject
    t_phase = time.perf_counter()
    tmp.mkdir(parents=True, exist_ok=True)
    syn, q = run1["syn"], run1["q"]
    batches = s1["batches"][:64]
    sv = ServingConfig(kinds=KINDS)

    def equal_states(tag, a, b):
        for f in STATE_FIELDS:
            if not torch.equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"{tag}: state.{f} differs")

    ing = StreamingIngestor(syn, seed=11)
    for cb, ab in batches[:32]:
        ing.ingest(cb, ab)
    eng = PassEngine(ing, sv, ci=0.95)
    want = host_of(eng.answer(q))
    path = tmp / "stream.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    eng2 = PassEngine.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    require_same("restored stream, at the checkpoint", eng2.answer(q), want,
                 KINDS)
    src2 = eng2.source
    equal_states("restored stream, at the checkpoint", src2.state, ing.state)
    native.reset_launches()
    for cb, ab in batches[32:]:
        src2.ingest(cb, ab)
    restored_launches = launches_now(native)
    if restored_launches != {"segment_reduce": 32, "threefry": 64}:
        raise AssertionError(f"restored ingest launched {restored_launches}")
    for cb, ab in batches[32:]:
        ing.ingest(cb, ab)
    equal_states("restored stream, 32 batches on", src2.state, ing.state)
    require_same("restored stream, 32 batches on", eng2.answer(q),
                 eng.answer(q), KINDS)
    stream_mb = path.stat().st_size / 2 ** 20

    # The 3-D synopsis.
    eng3 = PassEngine(run3["syn"], sv, ci=0.95)
    path3 = tmp / "syn3d.npz"
    t0 = time.perf_counter()
    eng3.checkpoint(path3)
    save3_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    r3 = PassEngine.restore(path3)
    restore3_s = time.perf_counter() - t0
    require_same("restored 3-D synopsis", r3.answer(run3["q"]),
                 eng3.answer(run3["q"]), KINDS)

    # Faults: 32 batches, every 5th poisoned with out-of-box coordinates.
    c_all = np.concatenate([cb for cb, _ in batches[:32]])
    box = ([float(c_all.min())], [float(c_all.max())])
    with inject(FaultPlan(seed=18, poison_every=5, poison_mode="oob")) as inj:
        chaotic = StreamingIngestor(syn, seed=11, quarantine_box=box)
        for cb, ab in batches[:32]:
            chaotic.ingest(cb, ab)
        faults = PassEngine(chaotic, sv).stats()["faults"]
    clean = StreamingIngestor(syn, seed=11, quarantine_box=box)
    poisoned_rows = 0
    for i, (cb, ab) in enumerate(batches[:32], start=1):
        if i % 5 == 0:
            poisoned_rows += ab.shape[0]
            cb = np.full_like(cb, np.inf)
        clean.ingest(cb, ab)
    if (chaotic.n_quarantined != poisoned_rows
            or inj.snapshot() != {"poisoned_batches": 6}
            or faults["quarantined_rows"] != poisoned_rows):
        raise AssertionError(f"fault drill: quarantined "
                             f"{chaotic.n_quarantined}, poisoned "
                             f"{poisoned_rows}, {inj.snapshot()}, {faults}")
    equal_states("fault drill against its clean run", chaotic.state,
                 clean.state)
    out = {"stream_file_mb": stream_mb, "save_s": save_s,
           "restore_s": restore_s,
           "syn3d_file_mb": path3.stat().st_size / 2 ** 20,
           "save3d_s": save3_s, "restore3d_s": restore3_s,
           "restored_launches": restored_launches,
           "poisoned_rows": poisoned_rows, "faults": faults,
           "seconds": time.perf_counter() - t_phase}
    emit(phase="18 checkpoint and faults", card=card, **out)
    path.unlink()
    path3.unlink()
    return out


# ---------------------------------------------------------------------------
# Joins: row 9 at edge shapes, 1-D and 3-D join serving and streaming
# ---------------------------------------------------------------------------

# The join slice's size: the main cells' fact table (7.7 M rows) over
# nd = 30,800 dimension keys, which keeps benchmarks/bench_joins.py's 250
# fact rows a key, with its P = 16 partitions and p_u = 0.05; k = 1024.
JOIN_N, JOIN_ND, JOIN_K, JOIN_P, JOIN_PU = 7_700_000, 30_800, 1024, 16, 0.05
JOIN_Q, JOIN_KINDS = 2048, ("sum", "count", "avg")
# The stream: the main stream's 770,000 rows, 1 % of their keys outside
# the dimension table.
JOIN_STREAM, JOIN_MISSING = 770_000, 0.01
# bench_joins' matched-error budget: median |SUM error| / max(|truth|, 1).
JOIN_ERR = 0.15
JOIN_CPU_Q = 256


def join_workload(n, nd, q, seed, d_fact=1):
    """benchmarks/bench_joins.py ``_workload``'s distributions: fact
    coordinates N(0, 1) in d_fact columns, values Gamma(2, 1), keys uniform
    over the nd dimension keys, one N(0, 1) dimension attribute, and q join
    rectangles, each column a sorted pair of N(0, 1.2) draws (the
    benchmark's one fact pair, one pair a column for d_fact > 1), then the
    dimension's pair. Returns (c, a, keys, dkeys, dattr, q_lo, q_hi)."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(n, d_fact)) if d_fact > 1
         else rng.normal(size=n)).astype(np.float32)
    a = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    keys = rng.integers(0, nd, size=n).astype(np.int32)
    dkeys = np.arange(nd, dtype=np.int32)
    dattr = rng.normal(size=nd).astype(np.float32)
    f = np.sort(rng.normal(0, 1.2, size=(q, d_fact, 2)), -1)
    d = np.sort(rng.normal(0, 1.2, size=(q, 2)), axis=1)
    q_lo = np.concatenate([f[..., 0], d[:, :1]], 1).astype(np.float32)
    q_hi = np.concatenate([f[..., 1], d[:, 1:]], 1).astype(np.float32)
    return c, a, keys, dkeys, dattr, q_lo, q_hi


def join_stream_rows(n, nd, seed, d_fact):
    """Newer fact rows from the build's distributions, JOIN_MISSING of
    their keys outside the dimension table."""
    rng = np.random.default_rng(seed)
    c = (rng.normal(size=(n, d_fact)) if d_fact > 1
         else rng.normal(size=(n, 1))).astype(np.float32)
    a = rng.gamma(2.0, 1.0, size=n).astype(np.float32)
    keys = rng.integers(0, nd, size=n).astype(np.int32)
    miss = rng.random(n) < JOIN_MISSING
    keys[miss] = rng.integers(nd, 2 * nd, size=int(miss.sum()))
    return [(c[i:i + STREAM_BATCH], a[i:i + STREAM_BATCH],
             keys[i:i + STREAM_BATCH]) for i in range(0, n, STREAM_BATCH)]


def join_inputs(torch, slots, jsyn, q_lo, q_hi):
    """Row 9's arguments for a batch: (slots, q_lo, q_hi, cover, sampled,
    cell_agg (k*P, 5), total_rows)."""
    from repro_torch.core.types import QueryBatch
    from repro_torch.engine.planner import classify_join_cells
    cover, sampled, _, _ = classify_join_cells(jsyn, QueryBatch(q_lo, q_hi))
    kp = jsyn.num_leaves * jsyn.num_partitions
    return (slots, q_lo.contiguous(), q_hi.contiguous(), cover, sampled,
            jsyn.cell_agg.reshape(kp, -1).contiguous(), jsyn.base.total_rows)


def join_rows(args, n):
    """The first n queries of row 9's arguments."""
    slots, lo, hi, cover, sampled, agg, tot = args
    return (slots, lo[:n].contiguous(), hi[:n].contiguous(),
            cover[:n].contiguous(), sampled[:n].contiguous(), agg, tot)


def join_vs_plain(torch, tag, args, p_u, zeros=False, times=None,
                  base=None) -> float:
    """Row 9 against its plain version on the same inputs: every output
    within K_RTOL / K_ATOL (bit for bit where ``zeros``: every value +-0.0),
    the kernel bit-equal across two launches, and each of its rows
    bit-equal at Q = 1, 3, 16 and 240 to the same row of the whole batch;
    with a baseline, every output bit-equal to the baseline kernel's.
    With ``times``, the plain call's CUDA-event time goes to
    ``times["join_cell_moments_plain"]`` (one cold call: at the main shape
    it takes seconds, so it is timed where it runs for the check). Returns
    the max abs error."""
    from repro_torch.kernels.join_moments import (PLANES,
                                                  join_cell_moments_cuda,
                                                  join_cell_moments_plain)
    fields = PLANES + ("exact3", "touched")
    m1 = join_cell_moments_cuda(*args, p_u)
    m2 = join_cell_moments_cuda(*args, p_u)
    if base is not None:
        old = baseline_join(torch, base, *args, p_u)
        for f in fields:
            if not bits_equal(torch, getattr(m1, f), getattr(old, f)):
                raise AssertionError(f"{tag}: {f} differs from the baseline "
                                     "kernel")
        del old
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    plain = join_cell_moments_plain(*args, p_u)
    end.record()
    torch.cuda.synchronize()
    if times is not None:
        times["join_cell_moments_plain"] = start.elapsed_time(end)
    err = 0.0
    for f in fields:
        got = getattr(m1, f)
        if not bits_equal(torch, got, getattr(m2, f)):
            raise AssertionError(f"{tag}: {f} differs between two launches")
        want = getattr(plain, f)
        # A non-finite value makes NaN (0 * inf) in both versions, at the
        # same entries; the rest is held to the tolerance.
        g, w = got.cpu(), want.cpu()
        if not torch.equal(torch.isnan(g), torch.isnan(w)):
            raise AssertionError(f"{tag}: {f} is NaN at other entries than "
                                 "plain")
        err = max(err, close(f"{tag} {f}", torch.where(g.isnan(), 0.0, g),
                             torch.where(w.isnan(), 0.0, w), K_RTOL, K_ATOL))
        if zeros and not bits_equal(torch, got, want):
            raise AssertionError(f"{tag}: {f} not the plain version's bits")
    Q = args[1].shape[0]
    for n in (1, 3, 16, 240):
        if n >= Q:
            continue
        part = join_cell_moments_cuda(*join_rows(args, n), p_u)
        for f in fields:
            if not bits_equal(torch, getattr(part, f), getattr(m1, f)[:n]):
                raise AssertionError(f"{tag}: {f} of rows at Q={n} differ "
                                     f"from the same rows at Q={Q}")
    del m1, m2, plain
    torch.cuda.empty_cache()
    return err


def join_case(torch, rng, Q, k, su, P, d_f, d_d, mode, p_u=0.3):
    """Synthetic row 9 inputs: k leaves of su slots (coordinates N(0, 1),
    values Gamma(2, 1), keys over 3 * su values, partition = key mod P,
    70 % valid), Q random boxes, random cover / sampled masks and cell
    aggregates. ``mode``: mixed; empty_leaves (every other leaf has no
    valid slot); singles (every key once: groups of one slot); nopart
    (every key missing from the dimension side); nan (NaN coordinates on
    valid slots); zeros (values +0.0 and -0.0); covered (boxes that hold
    whole cells, Q >= 7); inf (+inf, -inf and NaN values on three valid
    slots: unbounded cell boxes). Modes covered, inf and nan take boxes
    over every finite slot, the unbounded box, three cells' boxes exactly,
    a box with a NaN bound and wide random boxes."""
    from repro_torch.kernels.join_moments import join_slots
    dev = torch.device("cuda")
    u_c = rng.normal(size=(k, su, d_f)).astype(np.float32)
    u_d = rng.normal(size=(k, su, d_d)).astype(np.float32)
    u_a = rng.gamma(2.0, 1.0, size=(k, su)).astype(np.float32)
    u_key = rng.integers(0, 3 * su, size=(k, su)).astype(np.int32)
    u_valid = rng.random((k, su)) < 0.7
    if mode == "empty_leaves":
        u_valid[::2] = False
    elif mode == "singles":
        u_key = np.arange(k * su, dtype=np.int32).reshape(k, su)
    elif mode == "nan":
        u_c[u_valid & (rng.random((k, su)) < 0.2), 0] = np.nan
        u_d[u_valid & (rng.random((k, su)) < 0.1), -1] = np.nan
    elif mode == "zeros":
        u_a = np.where(rng.random((k, su)) < 0.5, 0.0, -0.0).astype(
            np.float32)
    elif mode == "inf":
        on = np.argwhere(u_valid)
        for v, (i, j) in zip((np.inf, -np.inf, np.nan),
                             on[rng.choice(len(on), 3, replace=False)]):
            u_a[i, j] = v
    u_part = (u_key % P).astype(np.int32)
    if mode == "nopart":
        u_part[:] = -1
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    slots = join_slots(T(u_c), T(u_d), T(u_a), T(u_key), T(u_part),
                       T(u_valid), P)
    D, kp = d_f + d_d, k * P
    lo = rng.normal(-0.5, 1.0, size=(Q, D)).astype(np.float32)
    hi = (lo + rng.uniform(0.0, 2.0, size=(Q, D))).astype(np.float32)
    if mode in ("covered", "inf", "nan"):
        # Boxes over every finite slot, unbounded, cell boxes exactly, a
        # NaN bound, then wide random boxes: covered cells in most rows.
        box = slots.cell_box.cpu().numpy()
        finite = np.flatnonzero(np.isfinite(box).all((1, 2)))
        lo[0], hi[0] = -10.0, 10.0
        lo[1], hi[1] = -np.inf, np.inf
        for i, cell in zip(range(2, 5), rng.choice(finite, 3)):
            lo[i], hi[i] = box[cell, 0], box[cell, 1]
        lo[5, 0] = np.nan
        hi[6:] = lo[6:] + rng.uniform(1.0, 4.0, size=(Q - 6, D))
    agg = rng.normal(size=(kp, 5)).astype(np.float32)
    agg[:, 2] = rng.integers(0, 9, kp)
    if mode == "zeros":
        agg[:, :2] = 0.0
    return (slots, T(lo), T(hi), T(rng.random((Q, kp)) < 0.2),
            T(rng.random((Q, kp)) < 0.3), T(agg),
            torch.tensor(1234.0, device=dev))


# (Q, k, su, P, d_fact, d_dim, mode): Q = 1; k = 1; Q, k, k * P off the
# kernel's 32-query and 128-cell tiles and off multiples of 4 (4-byte
# stores); P = 1 and 16; su = 1; leaves with no valid slot; groups of one
# slot; every key missing from the dimension side; NaN coordinates on
# valid slots; +-0.0 values; D = 2, 4, 6 and 16 (compile-time D up to 4);
# long runs (3000 slots a leaf); covered cells (boxes holding cells, the
# unbounded box) with finite and with non-finite values.
JOIN_CASES = ((1, 5, 20, 4, 1, 1, "mixed"), (70, 1, 30, 3, 1, 1, "mixed"),
              (130, 37, 23, 5, 1, 1, "mixed"), (65, 13, 40, 1, 2, 1, "mixed"),
              (129, 13, 40, 16, 1, 2, "mixed"), (33, 19, 1, 4, 1, 1, "mixed"),
              (40, 19, 30, 4, 1, 1, "empty_leaves"),
              (40, 19, 30, 4, 1, 1, "singles"),
              (40, 19, 30, 4, 1, 1, "nopart"), (65, 19, 30, 4, 1, 2, "nan"),
              (300, 19, 30, 4, 1, 1, "zeros"),
              (64, 8, 50, 4, 3, 13, "mixed"), (33, 3, 3000, 4, 1, 1, "mixed"),
              (70, 9, 40, 16, 1, 1, "covered"), (40, 8, 30, 4, 3, 1,
                                                 "covered"),
              (33, 7, 30, 3, 2, 1, "inf"), (20, 5, 30, 4, 1, 5, "covered"),
              (129, 33, 25, 16, 1, 1, "inf"))


def join_classes(torch, args) -> dict:
    """Counts of row 9's (query, cell) classes on its arguments (the
    kernel's rule, join_moments.join_cell_classes), over query chunks."""
    from repro_torch.kernels.join_moments import (COVERED, EMPTY, MIXED,
                                                  cell_nan_flags,
                                                  join_cell_classes)
    slots, lo, hi = args[:3]
    flags = cell_nan_flags(slots)
    out = dict.fromkeys(("empty", "covered", "mixed"), 0)
    for i in range(0, lo.shape[0], 256):
        cls = join_cell_classes(slots, lo[i:i + 256], hi[i:i + 256], flags)
        for name, code in (("empty", EMPTY), ("covered", COVERED),
                           ("mixed", MIXED)):
            out[name] += int((cls == code).sum())
    return out


def edge_cases_join(torch, base=None) -> float:
    """Row 9 against its plain version (and, with a baseline, bit-equal to
    the baseline kernel) at JOIN_CASES, each case's class counts printed;
    covered pairs appear in the covered and inf cases."""
    rng = np.random.default_rng(19)
    err = 0.0
    for Q, k, su, P, d_f, d_d, mode in JOIN_CASES:
        args = join_case(torch, rng, Q, k, su, P, d_f, d_d, mode)
        tag = f"join edge Q={Q} k={k} su={su} P={P} D={d_f + d_d} {mode}"
        classes = join_classes(torch, args)
        if mode in ("covered", "inf") and not classes["covered"]:
            raise AssertionError(f"{tag}: no covered pair: {classes}")
        e = join_vs_plain(torch, tag, args, 0.3, zeros=mode == "zeros",
                          base=base)
        emit(check="join edge classes", case=tag, **classes,
             max_abs_err=e, baseline_bit_equal=None if base is None
             else True)
        err = max(err, e)
    emit(check="join_cell_moments edge cases", cases=len(JOIN_CASES),
         max_abs_err=err, ok=True)
    return err


# Row 11, the join epilogue: the requests each case is checked under,
# (level, delta_budget, small_n_threshold), and the kinds sets.
EPI_REQUESTS = ((None, "stratum", 12), (0.95, "stratum", 12),
                (0.95, "union", 30), (0.9, "union", 12))
EPI_KINDS = (("sum",), ("count",), ("avg",), ("sum", "count", "avg"))
# (Q, k, su, P, mode): Q = 1; Q and k * P off the kernel's block (256
# threads of 4-cell chunks: 1024 cells a round) and off its 4-cell chunks
# (k * P = 185, 13, 1179: no 16-byte loads); P = 1 and 16; more cells than
# a round (1120, 1179); +-0.0 values ("zeros"); an int64 u_overflow.
EPI_CASES = ((1, 5, 20, 4, "mixed"), (300, 37, 23, 5, "mixed"),
             (130, 70, 30, 16, "mixed"), (65, 13, 40, 1, "mixed"),
             (300, 19, 30, 4, "zeros"), (40, 131, 10, 9, "mixed"),
             (17, 64, 30, 16, "int64"))


def epilogue_case(torch, rng, Q, k, su, P, mode):
    """(jsyn, jart) of row 11 for a synthetic case: join_case's row 9
    inputs through the row 9 kernel, and a stand-in synopsis (cell_agg,
    u_overflow, k, P). Empty cells (count 0) carry +inf / -inf MIN / MAX;
    every third stratum overflowed its universe buffer. For Q >= 3: row 0
    has no sampled cell, row 1 only covered cells, row 2 an empty box and
    no covered cell (a count below 1: AVG divides by 1). "zeros": the
    fact values, SUM and MIN / MAX +0.0 or -0.0."""
    import types
    from repro_torch.joins.executor import JoinArtifacts
    from repro_torch.kernels.join_moments import join_cell_moments_cuda
    zeros = mode == "zeros"
    slots, lo, hi, cover, sampled, agg, total = join_case(
        torch, rng, Q, k, su, P, 1, 1, "zeros" if zeros else "mixed")
    kp = k * P
    lo, hi, cover, sampled, agg = (x.clone() for x in (lo, hi, cover,
                                                      sampled, agg))
    if zeros:
        sign = torch.from_numpy(rng.choice(np.float32([0.0, -0.0]),
                                           (kp, 5))).to(agg.device)
        agg[:, 0], agg[:, 3], agg[:, 4] = sign[:, 0], sign[:, 3], sign[:, 4]
    empty = agg[:, 2] == 0
    agg[empty, 3] = float("inf")
    agg[empty, 4] = float("-inf")
    if Q >= 3:
        sampled[0] = False
        cover[1] = True
        sampled[1] = False
        hi[2] = lo[2] - 1.0
        cover[2] = False
    over = torch.zeros(k, dtype=torch.int64 if mode == "int64"
                       else torch.int32, device=agg.device)
    over[::3] = 5
    m = join_cell_moments_cuda(slots, lo, hi, cover, sampled, agg, total,
                               0.3)
    jart = JoinArtifacts(cover=cover, sampled=sampled, exact3=m.exact3,
                         s_cell=m.s_cell, c_cell=m.c_cell, v_s=m.v_s,
                         v_c=m.v_c, cov_sc=m.cov_sc, n_grp=m.n_grp,
                         r_s=m.r_s, r_c=m.r_c, touched=m.touched)
    jsyn = types.SimpleNamespace(cell_agg=agg, u_overflow=over,
                                 num_leaves=k, num_partitions=P)
    return jsyn, jart


def jart_rows(jart, n):
    """The join artifacts of the first n queries."""
    return dataclasses.replace(jart, **{
        f.name: getattr(jart, f.name)[:n].contiguous()
        for f in dataclasses.fields(jart)})


def epilogue_kw(request) -> dict:
    from repro_torch.api import ServingConfig
    level, budget, thr = request
    return dict(lam=ServingConfig().lam, level=level,
                small_n_threshold=thr, delta_budget=budget)


def with_f64_row_sums(torch, fn):
    """``fn()`` with every ``.sum(1)`` of a 2-D float32 tensor taken in
    float64 and rounded once to float32: run on join_epilogue_plain, the
    plain composition with its terms as they are and its row sums
    exact to the last rounding."""
    orig = torch.Tensor.sum

    def sum64(self, *args, **kw):
        if self.dtype == torch.float32 and self.dim() == 2 and args == (1,) \
                and not kw:
            return orig(self.double(), 1).float()
        return orig(self, *args, **kw)
    torch.Tensor.sum = sum64
    try:
        return fn()
    finally:
        torch.Tensor.sum = orig


def half_close(torch, got, want, scale) -> np.ndarray:
    """Where ci_half meets the tolerance of its square: |got^2 - want^2| <=
    2 K_RTOL want^2 + 1e-6 scale^2."""
    g2, w2 = got.cpu().double() ** 2, want.cpu().double() ** 2
    return ((g2 - w2).abs() <= 2 * K_RTOL * w2 + 1e-6 * scale ** 2).numpy()


def epilogue_vs_plain(torch, tag, jsyn, jart, kinds, request, zeros=False,
                      rows=(1, 3, 16, 240)) -> dict:
    """Row 11 against its plain version on the same inputs: every field
    within K_RTOL / K_ATOL; ci_half as the variance it is the root of (2
    K_RTOL, 1e-6 max|estimate|^2) against the plain version or, on the
    queries where it is not, against the plain composition with its row
    sums in float64 (``with_f64_row_sums``; AVG's fallback term divides by
    C - h_c, which can cancel, and there torch's float32 sums alone put
    the plain value off the exact-sum one by more than the tolerance);
    bit for bit on the rows with no sampled cell (every sum exact) and,
    where ``zeros``, on every SUM and AVG field; bit-equal across two
    launches; each of ``rows`` first queries served alone bit-equal to
    the same rows of the batch. Returns the max abs error (ci_half's
    included) and the count of ci_half values that met only the float64
    reference."""
    from repro_torch.kernels.join_epilogue import (FIELDS,
                                                   join_epilogue_cuda,
                                                   join_epilogue_plain)
    kw = epilogue_kw(request)
    r1 = join_epilogue_cuda(jsyn, jart, kinds, **kw)
    r2 = join_epilogue_cuda(jsyn, jart, kinds, **kw)
    plain = join_epilogue_plain(jsyn, jart, kinds, **kw)
    exact = ~jart.sampled.any(1)
    err, f64_only = 0.0, 0
    for kind in kinds:
        scale = float(plain[kind].estimate.abs().max())
        for f in FIELDS:
            got, want = getattr(r1[kind], f), getattr(plain[kind], f)
            if want is None:
                if got is not None or getattr(r2[kind], f) is not None:
                    raise AssertionError(f"{tag} {kind}.{f}: not None")
                continue
            if not same_bits(torch, got, getattr(r2[kind], f)):
                raise AssertionError(f"{tag} {kind}.{f}: differs between "
                                     "two launches")
            if f == "ci_half":
                ok = half_close(torch, got, want, scale)
                if not ok.all():
                    exact64 = with_f64_row_sums(
                        torch, lambda: join_epilogue_plain(
                            jsyn, jart, (kind,), **kw))[kind].ci_half
                    ok64 = half_close(torch, got, exact64, scale)
                    if not (ok | ok64).all():
                        i = int(np.argwhere(~(ok | ok64))[0, 0])
                        raise AssertionError(
                            f"{tag} {kind}.ci_half: {int((~(ok | ok64)).sum())}"
                            f" values off both references, first at {i}: "
                            f"{float(got[i])} vs {float(want[i])} (float64 "
                            f"sums: {float(exact64[i])})")
                    f64_only += int((~ok).sum())
                err = max(err, float((got - want).abs().max()))
            else:
                err = max(err, close(f"{tag} {kind}.{f}", got.cpu(),
                                     want.cpu(), K_RTOL, K_ATOL))
            if not same_bits(torch, got[exact], want[exact]):
                raise AssertionError(f"{tag} {kind}.{f}: not the plain "
                                     "version's bits on exact rows")
            if zeros and kind != "count" and not same_bits(torch, got,
                                                           want):
                raise AssertionError(f"{tag} {kind}.{f}: not the plain "
                                     "version's bits on +-0.0 values")
    Q = jart.sampled.shape[0]
    for n in rows:
        if n >= Q:
            continue
        part = join_epilogue_cuda(jsyn, jart_rows(jart, n), kinds, **kw)
        for kind in kinds:
            for f in FIELDS:
                got = getattr(part[kind], f)
                if got is not None and not bits_equal(
                        torch, got, getattr(r1[kind], f)[:n]):
                    raise AssertionError(f"{tag} {kind}.{f}: rows at Q={n} "
                                         f"differ from the same rows at "
                                         f"Q={Q}")
    return {"err": err, "ci_half_f64_only": f64_only}


def edge_cases_epilogue(torch) -> dict:
    """Row 11 against its plain version at EPI_CASES, every kinds set of
    EPI_KINDS under every request of EPI_REQUESTS."""
    rng = np.random.default_rng(25)
    err, n, f64_only = 0.0, 0, 0
    for Q, k, su, P, mode in EPI_CASES:
        jsyn, jart = epilogue_case(torch, rng, Q, k, su, P, mode)
        for kinds in EPI_KINDS:
            for req in EPI_REQUESTS:
                got = epilogue_vs_plain(
                    torch, f"epilogue edge Q={Q} kP={k * P} P={P} {mode} "
                    f"{'/'.join(kinds)} {req}", jsyn, jart, kinds, req,
                    zeros=mode == "zeros")
                err = max(err, got["err"])
                f64_only += got["ci_half_f64_only"]
                n += 1
        del jsyn, jart
    torch.cuda.empty_cache()
    emit(check="join_epilogue edge cases", cases=len(EPI_CASES),
         comparisons=n, max_abs_err=err, ci_half_f64_only=f64_only, ok=True)
    return {"cases": len(EPI_CASES), "comparisons": n, "err": err,
            "ci_half_f64_only": f64_only}


def epilogue_bound(torch, jsyn, jart, kinds, request) -> dict:
    """Least time for row 11's work on these inputs: max(bytes / HBM
    rate, operations / fp32 rate). Bytes: the planes the request reads
    (s_cell and v_s for sum or avg, c_cell and v_c for count or avg,
    cov_sc for avg; n_grp and r_s / r_c with a level), sampled, cell_agg,
    u_overflow, exact3 and touched read once; 5 (7 with a level) rows of
    Q floats a kind written once. Operations, as the kernel does them a
    (query, cell): a multiply and an add a masked sum (s, c, vs, vc, csc
    as needed, the sum's two bounds, the count's upper), 10 for the sum's
    cell bounds, 2 for the fallback test with a level, 4 for AVG's masked
    extremes; and a fallback cell of this run's data 12 a kind's half."""
    level = request[0]
    w_s = "sum" in kinds or "avg" in kinds
    w_c = "count" in kinds or "avg" in kinds
    planes = (2 * w_s + 2 * w_c + ("avg" in kinds)
              + (level is not None) * (1 + w_s + w_c))
    Q, kp = jart.sampled.shape
    P = jsyn.num_partitions
    nbytes = (planes * Q * kp * 4 + Q * kp + kp * 5 * 4
              + jsyn.u_overflow.numel() * jsyn.u_overflow.element_size()
              + Q * 16 + len(kinds) * (7 if level is not None else 5) * Q * 4)
    sums = (w_s * 2 + w_c * 2 + ("avg" in kinds) + ("sum" in kinds) * 2
            + ("count" in kinds))
    per_cell = (2 * sums + 10 * ("sum" in kinds) + 4 * ("avg" in kinds)
                + 2 * (level is not None))
    ops = float(per_cell) * Q * kp
    if level is not None:
        over = torch.repeat_interleave(jsyn.u_overflow > 0, P)[None]
        fb = float((jart.sampled & ((jart.n_grp < float(request[2]))
                                    | over)).sum())
        ops += fb * 12 * (w_s + w_c) + fb * 10 * ("sum" not in kinds) * w_s
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bytes": nbytes, "operations": ops, "planes_read": planes,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def join_bound(torch, args, jsyn) -> dict:
    """Least time for row 9's work on these inputs: max(bytes / HBM rate,
    operations / fp32 rate). Bytes: the live slots' coordinates, values
    and keys, the run offsets and boxes, the bounds, masks and cell
    aggregates read once, the eight planes, exact3 and touched written
    once. Operations, as this run's data needs them: each cell's totals
    once, 3 flops a slot and 10 a key group; per mixed (query, cell) pair
    (join_cell_classes), a slot's test 2 compares in each column that cuts
    the pair (the query does not hold the cell's box there, or a slot of
    the run has NaN there) and 3 flops a slot, 10 a key group; covered
    and empty pairs none; 2 flops a (query, cell,
    column) of exact3 and touched."""
    from repro_torch.kernels.join_moments import (MIXED, cell_nan_columns,
                                                  join_cell_classes)
    slots, lo, hi, cover, sampled, agg, _ = args
    Q, D = lo.shape
    kp = jsyn.num_leaves * jsyn.num_partitions
    live = int(slots.cell_start[:, -1].sum())
    nbytes = (live * (D + 2) * 4 + slots.cell_start.numel() * 4
              + slots.cell_box.numel() * 4 + 2 * Q * D * 4 + 2 * Q * kp
              + agg.numel() * 4 + 4 + 8 * Q * kp * 4 + Q * 16)
    per_cell = torch.diff(slots.cell_start.long(), dim=1).reshape(-1)
    gid = slots.flat_gid[slots.flat_gid >= 0].unique()
    groups = torch.bincount(slots.g_cell[gid], minlength=kp + 1)[:kp]
    work = (per_cell * 3 + groups * 10).to(torch.float64)
    nan_cols = cell_nan_columns(slots)
    box = slots.cell_box
    ops = float(work.sum())
    for s in range(0, Q, 256):
        ql, qh = lo[s:s + 256], hi[s:s + 256]
        mixed = (join_cell_classes(slots, ql, qh, nan_cols.any(-1))
                 == MIXED).to(torch.float64)
        cut = (~((ql[:, None] <= box[None, :, 0])
                 & (box[None, :, 1] <= qh[:, None]))
               | nan_cols[None]).sum(-1).to(torch.float64)
        ops += float((mixed * (work[None] + 2.0 * cut
                               * per_cell[None])).sum())
    ops += 2.0 * 4 * Q * kp
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_OPS_S
    return {"bytes": nbytes, "operations": ops,
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def join_truth(ground_truth_join, c, a, keys, dkeys, dattr, qn) -> dict:
    """SUM and COUNT of the queries by ``ground_truth_join`` (host f64
    scans of the materialized join), AVG as it derives it from them."""
    s = ground_truth_join(c, a, keys, dkeys, dattr, qn, kind="sum")
    cnt = ground_truth_join(c, a, keys, dkeys, dattr, qn, kind="count")
    return {"sum": s, "count": cnt, "avg": s / np.maximum(cnt, 1)}


def join_truth_check(tag, res, truth, n) -> dict:
    """The truth of the first n queries inside [lower, upper] for every
    kind (AVG on non-empty queries; slack 1e-4 relative for the fp32 sums
    over 16,384 cells), the median SUM error at most JOIN_ERR (bench_joins'
    measure), and the CI95 coverage of SUM and COUNT (reported)."""
    truth_inside(tag, res, truth, n, JOIN_KINDS)
    out = {}
    for kind in ("sum", "count"):
        t = truth[kind]
        est = host(res[kind].estimate[:n]).astype(np.float64)
        half = host(res[kind].ci_half[:n]).astype(np.float64)
        rel = np.abs(est - t) / np.maximum(np.abs(t), 1.0)
        out[f"{kind}_median_rel_err"] = float(np.median(rel))
        out[f"{kind}_ci95_coverage"] = float(np.mean(np.abs(est - t)
                                                     <= half + 1e-6))
    if out["sum_median_rel_err"] > JOIN_ERR:
        raise AssertionError(f"{tag}: median SUM error "
                             f"{out['sum_median_rel_err']} > {JOIN_ERR}")
    return out


def join_cpu_parity(torch, tag, jsyn, q, res, n=JOIN_CPU_Q) -> None:
    """The port on the CPU answers the first n queries from the same
    synopsis: estimate, lower, upper, frac_rows_touched, ci_lo and ci_hi
    within K_RTOL / K_ATOL; ci_half as the variance it is the root of
    (rtol 2 K_RTOL, atol 1e-6 max|estimate|^2: near a cancelled AVG
    variance the root is rounding noise of size sqrt(eps) |est|)."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.types import QueryBatch
    qc = QueryBatch(q.lo[:n].cpu(), q.hi[:n].cpu())
    cpu = PassEngine(jsyn.to("cpu"), ServingConfig(kinds=JOIN_KINDS),
                     ci=0.95, device="cpu").answer_join(qc)
    for kind in JOIN_KINDS:
        scale = float(np.abs(cpu[kind].estimate.numpy()).max())
        for f in ("estimate", "lower", "upper", "frac_rows_touched",
                  "ci_lo", "ci_hi"):
            close(f"{tag} cpu parity {kind}.{f}",
                  getattr(res[kind], f)[:n].cpu(), getattr(cpu[kind], f),
                  K_RTOL, K_ATOL)
        close(f"{tag} cpu parity {kind}.ci_half (squared)",
              res[kind].ci_half[:n].cpu().double() ** 2,
              cpu[kind].ci_half.double() ** 2, 2 * K_RTOL,
              1e-6 * scale ** 2)
    emit(check="join cpu_parity", path=tag, queries=n, ok=True)


def join_path(torch, tag, d_fact, method, card, tmp: Path, seed,
              base=None) -> dict:
    """19 (1-D) / 20 (3-D). Join serving and streaming at the slice's size
    through the entry points a user calls (module doc)."""
    from repro_torch.api import CoalescerConfig, PassEngine, ServingConfig
    from repro_torch.core.query import ground_truth_join
    from repro_torch.core.types import QueryBatch
    from repro_torch.joins import build_dim_table, build_join_synopsis
    from repro_torch.joins.executor import (compute_join_artifacts,
                                            join_answer, join_slots)
    from repro_torch.kernels import native
    from repro_torch.kernels.join_epilogue import (join_epilogue_cuda,
                                                   join_epilogue_plain)
    from repro_torch.kernels.join_moments import join_cell_moments_cuda
    from repro_torch.serve import RequestCoalescer
    from repro_torch.serve.coalescer import host_results
    from repro_torch.streaming.ingest import STATE_FIELDS
    from repro_torch.streaming.join_ingest import (JoinStreamingIngestor,
                                                   JSTATE_FIELDS)
    t_phase = time.perf_counter()
    phase = "19" if d_fact == 1 else "20"
    steps = {}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now
    dev = torch.device("cuda")
    c, a, keys, dkeys, dattr, q_lo, q_hi = join_workload(
        JOIN_N, JOIN_ND, JOIN_Q, seed, d_fact)
    t0 = time.perf_counter()
    dim = build_dim_table(dkeys, dattr, num_partitions=JOIN_P)
    jsyn, report = build_join_synopsis(c, a, keys, dim, k=JOIN_K,
                                       p_u=JOIN_PU, seed=seed,
                                       method=method)
    build_s = time.perf_counter() - t0
    q = QueryBatch(torch.from_numpy(q_lo).to(dev),
                   torch.from_numpy(q_hi).to(dev))
    fq = QueryBatch(q.lo[:, :d_fact], q.hi[:, :d_fact])
    dq = QueryBatch(q.lo[:, d_fact:], q.hi[:, d_fact:])
    sv = ServingConfig(kinds=JOIN_KINDS)
    # Row 10 at the build's shape: the universe test's uniforms of every
    # fact key (fold_in, then uniform_scalar), against plain.
    row10 = join_key_uniforms(torch, keys, seed) if d_fact == 1 else None

    # The answer, through the entry point, counted.
    eng = PassEngine(jsyn, sv, ci=0.95)
    torch.cuda.synchronize()
    native.reset_launches()
    res = eng.answer_join(fq, dq)
    torch.cuda.synchronize()
    answer_launches = launches_now(native)
    if answer_launches != {"query_eval": 2, "join_cell_moments": 1,
                           "join_epilogue": 1}:
        raise AssertionError(f"{tag}: answer_join launched "
                             f"{answer_launches}")
    check_result_shapes(torch, tag, res, JOIN_Q, JOIN_KINDS)
    emit(path=f"join {tag}", rows=JOIN_N, build_s=build_s, report=report,
         launches=answer_launches)
    step("data, build, first answer")

    # Row 9 against plain at the main shape; rows against the batch.
    slots = join_slots(jsyn)
    args = join_inputs(torch, slots, jsyn, q.lo, q.hi)
    plain_time = {}
    classes = join_classes(torch, args)
    emit(check="join cell classes", path=tag, Q=JOIN_Q,
         cells=jsyn.num_leaves * jsyn.num_partitions, p_u=JOIN_PU,
         **classes)
    kernel_err = join_vs_plain(torch, f"{tag} join main Q={JOIN_Q}", args,
                               JOIN_PU, times=plain_time, base=base)
    bound = join_bound(torch, args, jsyn)
    step("row 9 against plain")

    # Row 11 against plain at the main shape: the served request (rows
    # against the batch too), no interval, the "union" budget.
    jart = compute_join_artifacts(jsyn, q, slots)
    served = (0.95, "stratum", 12)
    epi_err, epi_f64_only = 0.0, {}
    for req in (served, (None, "stratum", 12), (0.95, "union", 30)):
        got = epilogue_vs_plain(
            torch, f"{tag} epilogue main Q={JOIN_Q} {req}", jsyn, jart,
            JOIN_KINDS, req, rows=(1, 3, 16, 240) if req == served else ())
        epi_err = max(epi_err, got["err"])
        epi_f64_only[str(req)] = got["ci_half_f64_only"]
    epi_bound = epilogue_bound(torch, jsyn, jart, JOIN_KINDS, served)
    emit(check="join_epilogue main shape", path=tag, max_abs_err=epi_err,
         ci_half_f64_only=epi_f64_only, bound=epi_bound, ok=True)
    step("row 11 against plain")

    # CPU parity, truth.
    join_cpu_parity(torch, tag, jsyn, q, res)
    step("cpu parity")
    n = 64
    qn = QueryBatch(q_lo[:n], q_hi[:n])
    truth = join_truth(ground_truth_join, c, a, keys, dkeys, dattr, qn)
    quality = join_truth_check(f"{tag} join", res, truth, n)
    emit(check="join truth", path=tag, queries=n, **quality)
    step("truth")

    # Times.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    eng.answer_join(fq, dq)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mb
    if peak_mb >= 16 * 1024:
        raise AssertionError(f"{tag}: answer_join peaks {peak_mb} MB above "
                             "resident")
    prof = device_profile(torch, lambda: eng.answer_join(fq, dq), reps=5,
                          warmup=1)
    # Row 9 is two device kernels a call; the profiler may drop records,
    # so its device time is the sum of each kernel's mean record.
    kby = device_by_name(torch, lambda: join_cell_moments_cuda(*args,
                                                               JOIN_PU))
    times = {
        "answer_join": cuda_ms(torch, lambda: eng.answer_join(fq, dq),
                               reps=10, warmup=2),
        "answer_join_host": host_ms(torch, lambda: eng.answer_join(fq, dq),
                                    reps=10),
        "answer_join_device_busy": prof["ms"],
        "kernels_per_answer": prof["ops_per_call"],
        "join_cell_moments": cuda_ms(torch, lambda: join_cell_moments_cuda(
            *args, JOIN_PU), reps=10, warmup=2),
        "join_cell_moments_device": records_ms(kby),
        "join_cell_moments_by_kernel": {
            name.split("::")[-1].split("(")[0]: v["ms_per_record"]
            for name, v in kby.items()},
        "join_cell_moments_enqueue_host": enqueue_ms(
            torch, lambda: join_cell_moments_cuda(*args, JOIN_PU)),
        "join_cell_moments_plain": plain_time["join_cell_moments_plain"],
    }
    if base is not None:
        times.update(join_baseline_turns(torch, tag, eng, fq, dq, args,
                                         base))
    # Row 11 at the served request, by events and on the device (the
    # kernel's record; the wrapper's z and log(3 / delta) are a few torch
    # ops beside it), against the plain epilogue on the same artifacts.
    kw = epilogue_kw(served)
    epi = lambda: join_epilogue_cuda(jsyn, jart, JOIN_KINDS, **kw)  # noqa
    old_epi = lambda: join_epilogue_plain(jsyn, jart, JOIN_KINDS, **kw)  # noqa
    eby = device_by_name(torch, epi)
    plain_prof = device_profile(torch, old_epi, reps=5, warmup=1)
    times.update({
        "join_epilogue": cuda_ms(torch, epi, reps=20, warmup=3),
        "join_epilogue_device": records_ms(
            eby, lambda name: "join_epilogue" in name),
        "join_epilogue_wrapper_device_by_op": {
            name.split("(")[0][:60]: v["ms_per_record"]
            for name, v in eby.items()},
        "join_epilogue_enqueue_host": enqueue_ms(torch, epi),
        "join_epilogue_plain": cuda_ms(torch, old_epi, reps=5, warmup=1),
        "join_epilogue_plain_device": plain_prof["ms"],
        "join_epilogue_plain_ops_per_call": plain_prof["ops_per_call"]})
    # The join answer's stage with row 11 and with the plain epilogue (the
    # parent's composition) on the same pinned synopsis, in turns: plain,
    # kernel, kernel, plain.
    pinned = (jsyn, slots)
    ans_kw = dict(kinds=JOIN_KINDS, **kw)
    new_ans = lambda: join_answer(pinned, q, **ans_kw)  # noqa
    old_ans = lambda: join_epilogue_plain(  # noqa
        jsyn, compute_join_artifacts(jsyn, q, slots), JOIN_KINDS, **kw)
    turns = {"plain": [], "kernel": []}
    for who in ("plain", "kernel", "kernel", "plain"):
        fn = old_ans if who == "plain" else new_ans
        turns[who].append(cuda_ms(torch, fn, reps=5, warmup=1))
    old_prof = device_profile(torch, old_ans, reps=3, warmup=1)
    new_prof = device_profile(torch, new_ans, reps=5, warmup=1)
    times.update({
        "join_answer_in_turns": statistics.mean(turns["kernel"]),
        "join_answer_plain_epilogue_in_turns": statistics.mean(
            turns["plain"]),
        "join_answer_in_turns_runs": turns,
        "join_answer_device_busy": new_prof["ms"],
        "join_answer_kernels": new_prof["ops_per_call"],
        "join_answer_plain_epilogue_device_busy": old_prof["ms"],
        "join_answer_plain_epilogue_kernels": old_prof["ops_per_call"]})
    emit(check="join epilogue times", path=tag, card=card,
         **{k: v for k, v in times.items() if "epilogue" in k
            or k.startswith("join_answer")}, bound=epi_bound)
    del jart
    torch.cuda.empty_cache()
    step("times")

    # The coalescer: 16 tenants of 16-240 rows of the batch and one copy.
    sizes = np.random.default_rng(17).integers(16, 241, 16)
    offs = np.concatenate([[0], np.cumsum(sizes)[:-1]]) % (JOIN_Q - 240)
    tenants = [(QueryBatch(fq.lo[o:o + s], fq.hi[o:o + s]),
                QueryBatch(dq.lo[o:o + s], dq.hi[o:o + s]))
               for o, s in zip(offs, sizes)]
    want = [host_results(eng.answer_join(f, d)) for f, d in tenants]
    co = RequestCoalescer(PassEngine(jsyn, sv, ci=0.95),
                          CoalescerConfig(shape_classes=(128, 512, 2048)))
    torch.cuda.synchronize()
    native.reset_launches()
    futs = [co.submit(f"t{i}", r, join=True) for i, r in enumerate(tenants)]
    dup = co.submit("copy", tenants[3], join=True)
    n_disp = co.tick()
    co_launches = launches_now(native)
    if (not 0 < n_disp < len(tenants)
            or co_launches != {"query_eval": 2 * n_disp,
                               "join_cell_moments": n_disp,
                               "join_epilogue": n_disp}):
        raise AssertionError(f"{tag} join coalescer: {n_disp} dispatches, "
                             f"launches {co_launches}")
    for i, f in enumerate(futs):
        require_same(f"{tag} join coalescer t{i} ({sizes[i]} rows)",
                     f.result(timeout=120), want[i], JOIN_KINDS)
    require_same(f"{tag} join coalescer copy", dup.result(timeout=120),
                 want[3], JOIN_KINDS)
    co_stats = co.stats()
    if co_stats["dedup_hits"] != 1 or co_stats["failed"]:
        raise AssertionError(f"{tag} join coalescer: {co_stats}")
    step("coalescer")

    # The stream, with a checkpoint after 32 batches and a restored
    # ingestor taking the next 32 beside it.
    batches = join_stream_rows(JOIN_STREAM, JOIN_ND, seed + 1, d_fact)
    ing = JoinStreamingIngestor(jsyn, seed=11)
    seng = PassEngine(ing, sv, ci=0.95)
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"join{tag}.npz"
    torch.cuda.synchronize()
    native.reset_launches()
    # A batch regrew the universe buffers where their capacity (a shape,
    # read on the host) grew.
    regrows = 0
    t0 = time.perf_counter()
    for cb, ab, kb in batches:
        cap = ing.jstate.u_a.shape[1]
        ing.ingest(cb, ab, keys=kb)
        regrows += ing.jstate.u_a.shape[1] != cap
    torch.cuda.synchronize()
    ingest_ms = (time.perf_counter() - t0) * 1e3 / len(batches)
    stream_launches = launches_now(native)
    # Row 10 four times a batch (the key's split, the batch's uniforms, the
    # universe test's fold_in and uniform_scalar) and twice a regrow (the
    # universe test of the parked rows).
    nb = len(batches)
    if not regrows:
        raise AssertionError(f"{tag}: the join stream never regrew")
    want_l = {"segment_reduce": 2 * nb, "threefry": 4 * nb + 2 * regrows}
    if d_fact > 1:
        if stream_launches.get("route_multid", 0) < len(batches):
            raise AssertionError(f"{tag}: route_multid launched "
                                 f"{stream_launches}")
        want_l["route_multid"] = stream_launches["route_multid"]
    if stream_launches != want_l:
        raise AssertionError(f"{tag}: the join stream launched "
                             f"{stream_launches}, not {want_l}")
    sres = seng.answer_join(fq, dq)
    c_all = np.concatenate([c.reshape(JOIN_N, -1)]
                           + [b[0] for b in batches])
    a_all = np.concatenate([a] + [b[1] for b in batches])
    k_all = np.concatenate([keys] + [b[2] for b in batches])
    struth = join_truth(ground_truth_join, c_all, a_all, k_all, dkeys,
                        dattr, qn)
    squality = join_truth_check(f"{tag} join stream", sres, struth, n)
    view = ing.as_join_synopsis()
    stream = {"batches": len(batches), "rows": JOIN_STREAM,
              "ingest_ms_per_batch": ingest_ms, "launches": stream_launches,
              "regrows": regrows, "regrown_rows": ing.n_regrown,
              "u_capacity": int(view.u_capacity),
              "u_overflow": int(view.u_overflow.sum()),
              "quarantined": ing.n_quarantined, **squality}
    pro = JoinStreamingIngestor(jsyn, seed=11)
    stream["profile"] = profile_batches(
        torch, lambda b: pro.ingest(b[0], b[1], keys=b[2]), batches)
    del pro
    emit(check="join stream", path=tag, **stream)
    step("stream and its truth")

    first = JoinStreamingIngestor(jsyn, seed=11)
    for cb, ab, kb in batches[:32]:
        first.ingest(cb, ab, keys=kb)
    feng = PassEngine(first, sv, ci=0.95)
    t0 = time.perf_counter()
    feng.checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reng = PassEngine.restore(path)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    for cb, ab, kb in batches[32:64]:
        first.ingest(cb, ab, keys=kb)
        reng.source.ingest(cb, ab, keys=kb)
    for name, fields, x, y in (("state", STATE_FIELDS, first.state,
                                reng.source.state),
                               ("jstate", JSTATE_FIELDS, first.jstate,
                                reng.source.jstate)):
        for f in fields:
            if not torch.equal(getattr(x, f), getattr(y, f)):
                raise AssertionError(f"{tag} restored join stream: "
                                     f"{name}.{f} differs")
    require_same(f"{tag} restored join stream", reng.answer_join(fq, dq),
                 feng.answer_join(fq, dq), JOIN_KINDS)
    ckpt = {"file_mb": path.stat().st_size / 2 ** 20, "save_s": save_s,
            "restore_s": restore_s}
    path.unlink()
    step("checkpoint")
    out = {"rows": JOIN_N, "d_fact": d_fact, "method": method,
           "build_s": build_s, "report": report, "kernel_err": kernel_err,
           "bound": bound, "classes": classes, "epilogue_err": epi_err,
           "epilogue_ci_half_f64_only": epi_f64_only,
           "epilogue_bound": epi_bound, "times_ms": times,
           "answer_peak_mb_above_resident": peak_mb,
           "answer_launches": answer_launches, "quality": quality,
           "coalescer": {"tenants": len(tenants), "rows": int(sizes.sum()),
                         "dispatches": n_disp, "launches": co_launches,
                         "dedup_hits": co_stats["dedup_hits"],
                         "padded_rows": co_stats["padded_rows"]},
           "stream": stream, "checkpoint": ckpt, "step_seconds": steps,
           "row10_key_uniforms": row10,
           "seconds": time.perf_counter() - t_phase}
    emit(phase=f"{phase} join {tag}", card=card, **out)
    del eng, co, seng, ing, first, feng, reng, args, slots, res, sres
    torch.cuda.empty_cache()
    return out


def join_baseline_turns(torch, tag, eng, fq, dq, args, base) -> dict:
    """Row 9 and the join answer with the baseline's row 9 and with this
    one, in turns (baseline, current, current, baseline): row 9 by events
    and on the device (its kernels' mean records), answer_join by events,
    host clock and device busy. The baseline's row 9 goes in through
    kernels.ops, which the join executor calls; the answers with it are
    the current answers' bits."""
    from repro_torch.kernels import ops as kops
    from repro_torch.serve.coalescer import host_results
    own = kops.join_cell_moments_cuda

    def old_row9(slots, *rest):
        return baseline_join(torch, base, slots, *rest)

    row9 = {"current": lambda: own(*args, JOIN_PU),
            "baseline": lambda: old_row9(*args, JOIN_PU)}

    def answer():
        return eng.answer_join(fq, dq)

    runs = {"baseline": [], "current": []}
    want = host_results(answer())
    for who in ("baseline", "current", "current", "baseline"):
        kops.join_cell_moments_cuda = own if who == "current" else old_row9
        try:
            require_same(f"{tag} join answer with the {who} row 9",
                         host_results(answer()), want, JOIN_KINDS)
            kby = device_by_name(torch, row9[who], tries=PROFILE_TRIES)
            runs[who].append({
                "row9_ms": cuda_ms(torch, row9[who], reps=10, warmup=2),
                "row9_device_ms": records_ms(kby),
                "answer_join_ms": cuda_ms(torch, answer, reps=10, warmup=2),
                "answer_join_host_ms": host_ms(torch, answer, reps=10),
                "answer_join_device_busy_ms": device_profile(
                    torch, answer, reps=5, warmup=1)["ms"]})
        finally:
            kops.join_cell_moments_cuda = own
    out = {f"{who}_{key}": mean_of([r[key] for r in rs])
           for who, rs in runs.items() for key in rs[0]}
    emit(check="join row 9 in turns with the baseline", path=tag, **out,
         runs=runs, answers_bit_equal=True)
    return {"in_turns": out}


def join_kernel_row(j1, j3, edge_err, base=None) -> dict:
    """Row 9 of the kernels line: the 1-D join answer's shapes and
    launches, the 3-D ones beside them."""
    t1, t3 = j1["times_ms"], j3["times_ms"]
    return {
        "name": "join_cell_moments", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_moments.cu",
        "replaces": "src/repro/joins/executor.py:108",
        "replaces_note": "no pallas_call: compute_join_artifacts' jnp "
                         "scatter stage",
        "pallas_call": None,
        "launches": j1["answer_launches"]["join_cell_moments"],
        "launches_3d": j3["answer_launches"]["join_cell_moments"],
        "launches_coalesced_tick": j1["coalescer"]["launches"][
            "join_cell_moments"],
        "max_abs_err": max(edge_err, j1["kernel_err"], j3["kernel_err"]),
        "edge_cases": len(JOIN_CASES), "edge_max_abs_err": edge_err,
        "ms": t1["join_cell_moments"],
        "plain_ms": t1["join_cell_moments_plain"],
        "bound_ms": j1["bound"]["bound_ms"],
        "bound_by": j1["bound"]["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "device_ms": t1["join_cell_moments_device"],
        "device_ms_by_kernel": t1["join_cell_moments_by_kernel"],
        "enqueue_host_ms": t1["join_cell_moments_enqueue_host"],
        "ms_3d": t3["join_cell_moments"],
        "device_ms_3d": t3["join_cell_moments_device"],
        "plain_ms_3d": t3["join_cell_moments_plain"],
        "bound_ms_3d": j3["bound"]["bound_ms"],
        "classes_1d": j1["classes"], "classes_3d": j3["classes"],
        "bit_stable_across_launches": True,
        "rows_bit_equal_at_q": [1, 3, 16, 240, JOIN_Q],
        "baseline_bit_equal": None if base is None else True,
        **{f"{key}{sfx}": (j["times_ms"].get("in_turns") or {}).get(key)
           for sfx, j in (("", j1), ("_3d", j3))
           for key in ("baseline_row9_ms", "baseline_row9_device_ms",
                       "current_row9_ms", "current_row9_device_ms")}}


def epilogue_kernel_row(j1, j3, edge) -> dict:
    """Row 11 of the kernels line: the 1-D join answer's shape and
    launches (its served request: sum/count/avg, ci=0.95), the 3-D ones
    beside them."""
    t1, t3 = j1["times_ms"], j3["times_ms"]
    return {
        "name": "join_epilogue", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/join_epilogue.cu",
        "replaces": "src/repro/joins/assemble.py:64",
        "replaces_note": "no pallas_call: assemble_join and "
                         "uncertainty/intervals.py:198,217,308, the jnp "
                         "join epilogue",
        "pallas_call": None,
        "launches": j1["answer_launches"]["join_epilogue"],
        "launches_3d": j3["answer_launches"]["join_epilogue"],
        "launches_coalesced_tick": j1["coalescer"]["launches"][
            "join_epilogue"],
        "coalesced_dispatches": j1["coalescer"]["dispatches"],
        "max_abs_err": max(edge["err"], j1["epilogue_err"],
                           j3["epilogue_err"]),
        "edge_cases": edge["cases"],
        "edge_comparisons": edge["comparisons"],
        "edge_max_abs_err": edge["err"],
        "ci_half_f64_only": {"edge": edge["ci_half_f64_only"],
                             "1d": j1["epilogue_ci_half_f64_only"],
                             "3d": j3["epilogue_ci_half_f64_only"]},
        "ms": t1["join_epilogue"], "plain_ms": t1["join_epilogue_plain"],
        "bound_ms": j1["epilogue_bound"]["bound_ms"],
        "bound_by": j1["epilogue_bound"]["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "device_ms": t1["join_epilogue_device"],
        "plain_device_ms": t1["join_epilogue_plain_device"],
        "plain_ops_per_call": t1["join_epilogue_plain_ops_per_call"],
        "enqueue_host_ms": t1["join_epilogue_enqueue_host"],
        "ms_3d": t3["join_epilogue"],
        "device_ms_3d": t3["join_epilogue_device"],
        "plain_device_ms_3d": t3["join_epilogue_plain_device"],
        "bound_ms_3d": j3["epilogue_bound"]["bound_ms"],
        "bit_stable_across_launches": True,
        "rows_bit_equal_at_q": [1, 3, 16, 240, JOIN_Q]}


# ---------------------------------------------------------------------------
# The partition catalog tier: rows 1, 2 and 5 on catalog shapes; 1-D and 3-D
# ---------------------------------------------------------------------------

# The slice's lake: the main cells' 7.7 M trips (sorted by pickup time) in
# CAT_P time buckets of ~7,500 rows; CatalogConfig(k=16, s_per_leaf=75,
# max_partitions=64, seed=0), so a stack of 64 partitions is the main
# path's 1024 strata x 75 slots.
CAT_P = 1024
CAT_CFG = dict(k=16, s_per_leaf=75, max_partitions=64, seed=0)
CAT_KINDS = ("sum", "count", "avg")
CAT_CPU_Q = 256
# bench_partitions' bar on the median relative SUM error (1-D). The 3-D
# boxes cut ~1000 time buckets a batch and cover almost none of them, so
# the budget of 64 samples the relevant mass thinly: on that cell with 512
# queries the JAX package itself gives a median of 0.3959 over the 19
# non-empty of the first 64 (tools/reference_catalog_error.py, on the CPU),
# and the port on the CPU the same within 2.2e-7, so the 3-D bar is 0.6.
CAT_ERR = {1: 0.15, 3: 0.6}
# bench_partitions.run()'s defaults: 64 clustered partitions of 80,000
# rows, Q = 8 selective queries, per-partition k = 8, s = 32, budget 10;
# the flat side's build k = 64, sample_budget = 2048, method "eq".
BENCH_P, BENCH_ROWS, BENCH_Q = 64, 80_000, 8
# The lake's float32 sums against build_catalog's float64 ones: twice the
# largest relative difference that the JAX package's own partition_stats
# shows on these 1024 buckets, 8.0e-5 (col_sum; col_sumsq 5.5e-5, the
# measure's sums 4.8e-6), measured by tools/reference_catalog_envelope.py
# on the CPU. The float32 summation bound (f32_sum_rtol) of ~7,500 terms is
# 4.5e-4, over five times looser.
LAKE_SUM_RTOL = 1.6e-4


def stats_case(rng, n, P, d, case):
    """(c, a, pid, mask) of one partition_stats edge case: masked rows,
    empty partitions (the last two ids get no row), +-0.0 values and
    coordinates, coordinates beyond the histogram edges."""
    c = rng.uniform(0, 100, (n, d)).astype(np.float32)
    a = rng.normal(0, 30, n).astype(np.float32)
    pid = rng.integers(0, P - 2, n).astype(np.int32)
    mask = None
    if "masked" in case:
        mask = rng.random(n) < 0.7
        pid[~mask & (rng.random(n) < 0.5)] = P - 1
    if "zeros" in case:
        a = np.where(rng.random(n) < 0.5, 0.0, -0.0).astype(np.float32)
        c[: n // 2] = np.where(rng.random((n // 2, d)) < 0.5, 0.0, -0.0)
    if "outside" in case:
        c[::7] = rng.uniform(-500, 600, (len(c[::7]), d))
    return c, a, pid, mask


def f32_sum_rtol(n: int) -> float:
    """Relative error bound of a float32 sum of n terms against the exact
    sum, (n + 1) * 2**-24 (n - 1 additions and, for a sum of squares, one
    rounding of each product; Higham's gamma_n). On the taxi lake's
    buckets of ~7,500 nearly equal pickup times the card's and the CPU's
    sums differ by ~4e-5 relative, a tenth of the bound, and the JAX
    package's own pass by up to 8.0e-5 from build_catalog's (the lake's
    bar is LAKE_SUM_RTOL)."""
    return (n + 1) * 2.0 ** -24


def stats_vs_plain(torch, tag, c, a, pid, P, bins, blo, bhi, mask=None,
                   rtol=None) -> tuple:
    """partition_stats on the card (d + 2 segment_reduce launches, counted)
    against the same pass on the CPU (segment_reduce_plain): n, hist,
    boxes and the measure's count and MIN/MAX bit-equal; a second launch
    bit-equal to the first; sums within atol=1e-3 and ``rtol``, by default
    the larger of 3e-5 and twice f32_sum_rtol of the largest partition's
    rows (two float32 sums of n terms taken in other orders). Returns (the
    max absolute error of the sums, the card's catalog, the launches)."""
    from repro_torch.kernels import native
    from repro_torch.partitions import partition_stats
    dev = torch.device("cuda")
    d = c.shape[1]
    args = [torch.from_numpy(x).to(dev) for x in (c, a, pid)]
    m = None if mask is None else torch.from_numpy(mask).to(dev)
    kw = dict(bins=bins, bin_lo=blo, bin_hi=bhi)
    torch.cuda.synchronize()
    native.reset_launches()
    got = partition_stats(*args, P, mask=m, **kw)
    torch.cuda.synchronize()
    launches = launches_now(native)
    if launches != {"segment_reduce": d + 2}:
        raise AssertionError(f"{tag}: partition_stats launched {launches}")
    again = partition_stats(*args, P, mask=m, **kw)
    want = partition_stats(c, a, pid, P, mask=mask, device="cpu", **kw)
    torch.cuda.synchronize()
    fields = ("n", "col_lo", "col_hi", "col_sum", "col_sumsq", "hist",
              "m_agg")
    for f in fields:
        if not bits_equal(torch, getattr(got, f), getattr(again, f)):
            raise AssertionError(f"{tag}: partition_stats {f} differs "
                                 "between two launches")
    for f in ("n", "col_lo", "col_hi", "hist"):
        if not bits_equal(torch, getattr(got, f).cpu(), getattr(want, f)):
            raise AssertionError(f"{tag}: partition_stats {f} differs "
                                 "from plain")
    if not bits_equal(torch, got.m_agg[:, 2:].cpu(), want.m_agg[:, 2:]):
        raise AssertionError(f"{tag}: partition_stats count/MIN/MAX differ "
                             "from plain")
    if rtol is None:
        rtol = max(K_RTOL, 2 * f32_sum_rtol(int(want.n.max())))
    return max(close(f"{tag} partition_stats {f}", g.cpu(), w, rtol,
                     K_ATOL)
               for f, g, w in (("col_sum", got.col_sum, want.col_sum),
                               ("col_sumsq", got.col_sumsq, want.col_sumsq),
                               ("m_agg sums", got.m_agg[:, :2],
                                want.m_agg[:, :2]))), got, launches


def stack_checks(torch, tag, stacked, n_real, k, q_lo, q_hi) -> dict:
    """Rows 1 and 2 against plain on a stacked pseudo-synopsis: the pad
    blocks (the strata past ``n_real`` partitions) never covered and their
    moments +0.0. query_eval's exact is held in its SUM, SUMSQ and COUNT
    columns by qe_vs_plain; in its MIN and MAX columns the plain product
    meets the pad blocks' +-inf with zeros and is NaN in every row (its
    NaNs are counted, never compared), so those columns are held against
    the product over the finite leaves. The catalog answer reads none of
    them."""
    from repro_torch.kernels.query_eval import query_eval_cuda
    from repro_torch.kernels.stratified_estimate import \
        stratified_moments_cuda
    qe_err, covered = qe_vs_plain(torch, tag, stacked.leaf_lo,
                                  stacked.leaf_hi, stacked.leaf_agg, q_lo,
                                  q_hi)
    sm_err = moments_vs_plain(torch, tag, stacked.sample_c,
                              stacked.sample_a, stacked.sample_valid, q_lo,
                              q_hi, None)
    rel, exact = query_eval_cuda(stacked.leaf_lo, stacked.leaf_hi,
                                 stacked.leaf_agg, q_lo, q_hi)
    mom = stratified_moments_cuda(stacked.sample_c, stacked.sample_a,
                                  stacked.sample_valid, q_lo, q_hi)
    pad = slice(n_real * k, None)
    if bool((rel[:, pad] == 2).any()):
        raise AssertionError(f"{tag}: a pad-block stratum classified "
                             "covered")
    if not bits_equal(torch, mom[:, pad], torch.zeros_like(mom[:, pad])):
        raise AssertionError(f"{tag}: pad-block moments are not +0.0")
    finite = torch.isfinite(stacked.leaf_agg[:, 3:5]).all(1)
    cover = (rel == 2).to(torch.float32)
    plain_nan = int(torch.isnan(cover @ stacked.leaf_agg[:, 3:5]).sum())
    mm_err = close(f"{tag} query_eval exact MIN/MAX",
                   exact[:, 3:5].cpu(),
                   (cover[:, finite] @ stacked.leaf_agg[finite, 3:5]).cpu(),
                   K_RTOL, K_ATOL)
    return {"qe_err": qe_err, "sm_err": sm_err, "covered_pairs": covered,
            "exact_minmax_err": mm_err,
            "exact_minmax_plain_nan": plain_nan,
            "exact_minmax_kernel_nonfinite": int(
                (~torch.isfinite(exact[:, 3:5])).sum()),
            "pad_strata": stacked.num_leaves - n_real * k}


def edge_cases_catalog(torch) -> dict:
    """21, edge cases: rows 1 and 2 on stacks with 1, 2 and 3 pad blocks
    and an all-empty partition inside (1-D eq and 3-D kd partitions, which
    realize fewer than k leaves and carry padded strata of their own), and
    partition_stats (row 5) against plain with masked rows, empty
    partitions, +-0.0 values and out-of-range coordinates at d = 1 and
    3."""
    from repro_torch.api import CatalogConfig
    from repro_torch.partitions import (CatalogSource, PartitionStore,
                                        stack_synopses)
    dev = torch.device("cuda")
    rng = np.random.default_rng(21)
    out = {"stacks": [], "stats": [], "qe_err": 0.0, "sm_err": 0.0,
           "seg_err": 0.0}
    k, s = CAT_CFG["k"], CAT_CFG["s_per_leaf"]
    for d, method in ((1, "eq"), (3, "kd")):
        parts = []
        for p in range(7):
            n = 0 if p == 2 else int(rng.integers(200, 900))
            c = np.sort(rng.uniform(15 * p, 15 * p + 25, (n, d)), axis=0)
            parts.append((c, rng.gamma(2.0, 3.0, n) * (1 + p)))
        src = CatalogSource(PartitionStore(parts),
                            CatalogConfig(method=method, **CAT_CFG))
        syns = [src._build_one(p) for p in range(7)]
        for n_real, pad_to in ((7, 8), (6, 8), (5, 8), (3, 4)):
            stacked = stack_synopses(syns[:n_real], pad_to, k, s, d)
            Q = 37
            q_lo = rng.uniform(-10, 90, (Q, d)).astype(np.float32)
            q_hi = (q_lo + rng.uniform(1, 60, (Q, d))).astype(np.float32)
            q_lo[0], q_hi[0] = -1e9, 1e9          # covers every leaf
            q_lo[1], q_hi[1] = 1e9, 2e9           # misses every leaf
            ql, qh = (torch.from_numpy(x).to(dev) for x in (q_lo, q_hi))
            tag = f"catalog edge {d}d {n_real} of {pad_to}"
            r = stack_checks(torch, tag, stacked, n_real, k, ql, qh)
            out["qe_err"] = max(out["qe_err"], r["qe_err"],
                                r["exact_minmax_err"])
            out["sm_err"] = max(out["sm_err"], r["sm_err"])
            out["stacks"].append({"d": d, "partitions": n_real,
                                  "pad_to": pad_to, **r})
    for d, case in ((1, "masked"), (3, "zeros"), (1, "zeros masked"),
                    (3, "outside masked"), (1, "empty")):
        n = 1 if case == "empty" else 20_000 + 37 * d
        c, a, pid, mask = stats_case(rng, n, 9, d, case)
        out["seg_err"] = max(out["seg_err"], stats_vs_plain(
            torch, f"catalog edge partition_stats {d}d {case}", c, a, pid,
            9, 16, np.zeros(d), np.full(d, 100.0), mask)[0])
        out["stats"].append(f"{d}d {case}")
    emit(check="catalog edge cases", **out)
    return out


def bench_lake(seed=0):
    """benchmarks/bench_partitions.py's _lake and _selective_queries at
    run()'s defaults: partition p covers [10p, 10p+8]; each query spans 4
    clusters, the inner ones covered, the edge ones cut."""
    rng = np.random.default_rng(seed)
    parts = []
    for p in range(BENCH_P):
        c = rng.uniform(10.0 * p, 10.0 * p + 8.0,
                        size=BENCH_ROWS).astype(np.float32)
        a = rng.gamma(2.0, 1.0, size=BENCH_ROWS).astype(np.float32)
        parts.append((c, a))
    rng = np.random.default_rng(seed + 1)
    starts = rng.integers(0, BENCH_P - 4, size=BENCH_Q)
    lo = 10.0 * starts + rng.uniform(5.5, 7.5, size=BENCH_Q)
    hi = 10.0 * (starts + 3) + rng.uniform(0.5, 2.5, size=BENCH_Q)
    return parts, lo[:, None].astype(np.float32), hi[:, None].astype(
        np.float32)


def bench_cell(torch, card) -> dict:
    """21, bench_partitions' defaults: the catalog path (sketch pass,
    selection, 5-10 builds, one answer of Q = 8 rows, served at
    executor.MIN_ROWS) against the flat build of every row plus one
    answer, time to first answer by host clock (3 rounds in turns, the
    medians); both within bench's median relative error 0.15 of the
    truth; the dense twin (no budget, bench's flat build_kw) bit-equal to
    the flat engine (DESIGN §14's p = 1 property)."""
    from repro_torch.api import CatalogConfig, PassEngine, ServingConfig
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.core.types import QueryBatch
    from repro_torch.kernels import native
    dev = torch.device("cuda")
    parts, lo, hi = bench_lake()
    c_all = np.concatenate([c for c, _ in parts])
    a_all = np.concatenate([a for _, a in parts])
    q = QueryBatch(torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))
    sv = ServingConfig(kinds=("sum", "count"))
    cfg = CatalogConfig(k=8, s_per_leaf=32, method="eq", max_partitions=10,
                        seed=0)
    build_kw = dict(k=64, sample_budget=64 * 32, method="eq", seed=0)

    def flat():
        syn, _ = build_synopsis(c_all, a_all, **build_kw)
        eng = PassEngine(syn, serving=sv, ci=0.95)
        return eng, eng.answer(q)

    def catalog():
        eng = PassEngine.from_catalog(parts, catalog=cfg, serving=sv,
                                      ci=0.95)
        return eng, eng.answer(q)

    torch.cuda.synchronize()
    native.reset_launches()
    ceng, cres = catalog()
    torch.cuda.synchronize()
    launches = launches_now(native)
    if launches != {"query_eval": 1, "stratified_moments": 1}:
        raise AssertionError(f"bench catalog answer launched {launches}")
    check_result_shapes(torch, "bench catalog", cres, BENCH_Q, sv.kinds)
    feng, fres = flat()
    truth = {"sum": np.array([a_all[(c_all >= lo_) & (c_all <= hi_)].sum()
                              for lo_, hi_ in zip(lo[:, 0], hi[:, 0])],
                             np.float64),
             "count": np.array([((c_all >= lo_) & (c_all <= hi_)).sum()
                                for lo_, hi_ in zip(lo[:, 0], hi[:, 0])],
                               np.float64)}
    rel = {}
    for name, res in (("flat", fres), ("catalog", cres)):
        truth_inside(f"bench {name}", res, truth, BENCH_Q, sv.kinds)
        for kind in sv.kinds:
            est = host(res[kind].estimate).astype(np.float64)
            r = float(np.median(np.abs(est - truth[kind])
                                / np.maximum(np.abs(truth[kind]), 1.0)))
            rel[f"{name}_{kind}"] = r
            if r > 0.15:
                raise AssertionError(f"bench {name} {kind}: median relative "
                                     f"error {r} > 0.15")
    dense = PassEngine.from_catalog(
        parts, catalog=CatalogConfig(k=8, s_per_leaf=32, method="eq",
                                     max_partitions=None, seed=0),
        serving=sv, ci=0.95, **build_kw)
    require_same("bench dense twin", dense.answer(q), fres, sv.kinds)
    t_flat, t_cat = [], []
    for _ in range(3):
        for name, fn, acc in (("flat", flat, t_flat),
                              ("catalog", catalog, t_cat)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            acc.append(time.perf_counter() - t0)
    out = {"partitions": BENCH_P, "rows": BENCH_P * BENCH_ROWS,
           "queries": BENCH_Q, "launches": launches,
           "materialized": ceng.stats()["catalog"]["materialized"],
           "median_rel_err": rel,
           "flat_build_answer_ms": statistics.median(t_flat) * 1e3,
           "catalog_ms": statistics.median(t_cat) * 1e3,
           "flat_rounds_ms": [t * 1e3 for t in t_flat],
           "catalog_rounds_ms": [t * 1e3 for t in t_cat],
           "dense_twin_bit_equal": True}
    out["speedup_x"] = out["flat_build_answer_ms"] / out["catalog_ms"]
    emit(phase="21 catalog bench_partitions", card=card, **out)
    return out


def catalog_faults(torch, tag, store, cfg, sv, q, res0, sel0, tmp,
                   eng) -> dict:
    """21, faults and checkpoints: a fresh engine draws the first
    selection again with one of its picked partitions failing every build:
    the partition is degraded, the queries that overlap it (and only they)
    get the catalog envelope (estimate its midpoint, the interval the
    whole envelope), the others agree with the clean answer of the same
    draw; then ``eng`` is checkpointed and restored, and the next two
    draws of both are bit-equal."""
    from repro_torch.api import PassEngine
    from repro_torch.testing import FaultPlan, inject
    feng = PassEngine.from_catalog(store, catalog=cfg, serving=sv, ci=0.95)
    p = int(np.flatnonzero(sel0.picked)[0])
    with inject(FaultPlan(materialize_fail_parts=(p,),
                          materialize_fail_times=-1)) as inj:
        fres = feng.answer(q)
    torch.cuda.synchronize()
    st = feng.stats()
    if (st["faults"]["degraded_partitions"] != [p]
            or st["catalog"]["materialize_failures"] != 1
            or st["catalog"]["materialize_retries"] != 3
            or inj.snapshot().get("materialize_failures") != 4):
        raise AssertionError(f"{tag} faults: {st['faults']}, "
                             f"{st['catalog']}, {inj.snapshot()}")
    deg = torch.from_numpy(sel0.overlap[:, p]).to(q.lo.device)
    for kind in sv.kinds:
        r = fres[kind]
        want = {"estimate": 0.5 * (r.lower + r.upper),
                "ci_half": 0.5 * (r.upper - r.lower),
                "ci_lo": r.lower, "ci_hi": r.upper}
        for f, w in want.items():
            got = getattr(r, f)
            if not bits_equal(torch, got[deg], w[deg]):
                raise AssertionError(f"{tag} faults {kind}.{f}: a query "
                                     f"overlapping {p} is not enveloped")
        enveloped = (r.ci_lo == r.lower) & (r.ci_hi == r.upper) & \
            (r.estimate == want["estimate"]) & (r.lower < r.upper)
        if bool((enveloped & ~deg).any()):
            raise AssertionError(f"{tag} faults {kind}: a query apart "
                                 f"from {p} got the envelope")
    keep = ~deg
    scale = float(res0["sum"].estimate.abs().max())
    for kind in sv.kinds:
        for f, rtol in (("estimate", 3e-5), ("lower", 3e-5),
                        ("upper", 3e-5), ("ci_lo", 1e-4), ("ci_hi", 1e-4)):
            close(f"{tag} faults {kind}.{f} apart from {p}",
                  getattr(fres[kind], f)[keep].cpu(),
                  getattr(res0[kind], f)[keep].cpu(), rtol, rtol * scale)
    del feng
    tmp.mkdir(parents=True, exist_ok=True)
    path = tmp / f"catalog{tag}.npz"
    t0 = time.perf_counter()
    eng.checkpoint(path)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reng = PassEngine.restore(path)
    restore_s = time.perf_counter() - t0
    for i in range(2):
        require_same(f"{tag} restored catalog draw {i}", reng.answer(q),
                     eng.answer(q), sv.kinds)
    out = {"failed_partition": p, "degraded_queries": int(deg.sum()),
           "file_mb": path.stat().st_size / 2 ** 20, "save_s": save_s,
           "restore_s": restore_s, "restored_draws_bit_equal": 2}
    path.unlink()
    emit(check="catalog faults and checkpoint", path=tag, **out)
    return out


def catalog_path(torch, tag, c, a, method, card, run, tmp) -> dict:
    """21 (1-D) / 22 (3-D). The time-bucket lake through
    PassEngine.from_catalog (module doc): launches, pruning, CPU parity on
    the same selection, rows 1 and 2 against plain at the stacked shape,
    truth, times, partition_stats over every row; in 1-D also
    bench_partitions' defaults, faults and a checkpoint."""
    from repro_torch.api import CatalogConfig, PassEngine, ServingConfig
    from repro_torch.core.query import random_queries
    from repro_torch.core.types import QueryBatch
    from repro_torch.engine import executor
    from repro_torch.kernels import native
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain)
    from repro_torch.partitions import (partition_rows, partition_stats,
                                        pick_partitions)
    from repro_torch.partitions.executor import catalog_answer
    t_phase = time.perf_counter()
    phase = "21" if c.ndim == 1 else "22"
    d = 1 if c.ndim == 1 else c.shape[1]
    dev = torch.device("cuda")
    steps = {}
    t_step = [time.perf_counter()]

    def step(name):
        now = time.perf_counter()
        steps[name] = now - t_step[0]
        t_step[0] = now
    store = partition_rows(c, a, CAT_P)
    cfg = CatalogConfig(method=method, **CAT_CFG)
    sv = ServingConfig(kinds=CAT_KINDS)
    q = random_queries(c, 2048, seed=3)
    q_lo, q_hi = q.lo.cpu().numpy(), q.hi.cpu().numpy()

    # Cold: catalog, picks, builds, one answer, through the entry point.
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    eng = PassEngine.from_catalog(store, catalog=cfg, serving=sv, ci=0.95)
    res = eng.answer(q)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    launches = launches_now(native)
    if launches != {"query_eval": 1, "stratified_moments": 1}:
        raise AssertionError(f"{tag} catalog: the answer launched "
                             f"{launches}")
    check_result_shapes(torch, f"{tag} catalog", res, 2048, CAT_KINDS)
    src = eng.source
    sel0 = pick_partitions(src.catalog, q_lo, q_hi,
                           budget=cfg.max_partitions,
                           pi_floor=cfg.pi_floor, seed=cfg.seed)
    picked = set(np.flatnonzero(sel0.picked).tolist())
    built = set(src.stats()["materialized_ids"])
    if built != picked or not picked <= set(
            np.flatnonzero(sel0.overlap.any(0)).tolist()):
        raise AssertionError(f"{tag} catalog: built {sorted(built)} but "
                             f"the picker picked {sorted(picked)}")
    step("cold answer")

    # The same selection on the card and on the CPU; rows 1 and 2 against
    # plain at the stacked shape.
    statics = dict(kinds=CAT_KINDS, k_part=cfg.k, level=0.95,
                   small_n_threshold=12, use_fpc=True,
                   delta_budget="stratum")
    args = src.stage(q, sv.lam, executor.MIN_ROWS)
    stacked, qs = args[0], args[1]
    # The stacked partitions come first; every one overlaps some query.
    n_real = int((args[4].sum(0) > 0).sum())
    card_res = catalog_answer(*args, **statics)
    n = CAT_CPU_Q
    cpu_args = (stacked.to("cpu"),
                QueryBatch(qs.lo[:n].cpu(), qs.hi[:n].cpu()),
                *(x.cpu() for x in args[2:4]),
                *(x[:n].cpu() for x in args[4:7]),
                *(x.cpu() for x in args[7:9]), None)
    cpu_res = catalog_answer(*cpu_args, **statics)
    scale = float(cpu_res["sum"].estimate.abs().max())
    for kind in CAT_KINDS:
        for f, rtol in (("estimate", 3e-5), ("lower", 3e-5),
                        ("upper", 3e-5), ("frac_rows_touched", 3e-5),
                        ("ci_half", 1e-4), ("ci_lo", 1e-4),
                        ("ci_hi", 1e-4)):
            sc = 1.0 if f == "frac_rows_touched" else scale
            close(f"{tag} catalog cpu parity {kind}.{f}",
                  getattr(card_res[kind], f)[:n].cpu(),
                  getattr(cpu_res[kind], f), rtol, rtol * sc)
    k_stack = stacked.num_leaves
    stack = stack_checks(torch, f"{tag} catalog stack k={k_stack}", stacked,
                         n_real, cfg.k, qs.lo, qs.hi)
    step("cpu parity and rows 1, 2 at the stack")

    # Truth of 64 queries inside [lower, upper]; median SUM error.
    m = 64
    truth = (truth_1d(c, a, q_lo[:m], q_hi[:m]) if d == 1 else
             truth_scan(torch, c, a, q_lo[:m], q_hi[:m]))
    quality = check_truth(f"{tag} catalog", res, truth, m, CAT_ERR[d],
                          CAT_KINDS)
    emit(check="catalog truth", path=tag, **quality)
    step("truth")

    # Times: a warm answer by events and host clock, its stage alone (the
    # picker, builds of new picks, stacking), the picker alone, device busy
    # and kernels an answer, builds and LRU hits a batch, peak memory.
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2 ** 20
    eng.answer(q)
    torch.cuda.synchronize()
    peak_mb = torch.cuda.max_memory_allocated() / 2 ** 20 - base_mb
    before = src.stats()
    prof = device_profile(torch, lambda: eng.answer(q), reps=5, warmup=1)
    times = {
        "answer": cuda_ms(torch, lambda: eng.answer(q), reps=10, warmup=2),
        "answer_host": host_ms(torch, lambda: eng.answer(q), reps=10),
        "stage_host": host_ms(torch, lambda: src.stage(q, sv.lam,
                                                       executor.MIN_ROWS),
                              reps=10),
        "device_busy": prof["ms"],
        "kernels_per_answer": prof["ops_per_call"],
    }
    after = src.stats()
    batches = after["served_batches"] - before["served_batches"]
    t0 = time.perf_counter()
    for i in range(5):
        pick_partitions(src.catalog, q_lo, q_hi, budget=cfg.max_partitions,
                        pi_floor=cfg.pi_floor, seed=cfg.seed + i)
    times["picker_host"] = (time.perf_counter() - t0) * 1e3 / 5
    times["builds_per_batch"] = (after["materialized"]
                                 - before["materialized"]) / batches
    times["lru_hits_per_batch"] = (after["hits"] - before["hits"]) / batches
    times["evictions_per_batch"] = (after["evictions"]
                                    - before["evictions"]) / batches
    # Rows 1 and 2 at the stacked shape.
    qe_args = (stacked.leaf_lo, stacked.leaf_hi, stacked.leaf_agg, qs.lo,
               qs.hi)
    sm_args = (stacked.sample_c, stacked.sample_a, stacked.sample_valid,
               qs.lo, qs.hi)
    rel, _ = query_eval_cuda(*qe_args)
    classes = pair_classes(torch, stacked.sample_c, stacked.sample_valid,
                           qs.lo, qs.hi)
    kb = bounds(stacked, qs, rel, classes)
    for name, kern, plain, kargs in (
            ("query_eval", query_eval_cuda, query_eval_plain, qe_args),
            ("stratified_moments", stratified_moments_cuda,
             stratified_moments_plain, sm_args)):
        times[f"{name}_stack"] = cuda_ms(torch, lambda: kern(*kargs))
        # A profiler window may record none of a short kernel's launches:
        # the mean of three windows' readings.
        times[f"{name}_stack_device"] = mean_of(
            [device_ms(torch, lambda: kern(*kargs), one_op=True)
             for _ in range(3)])
        times[f"{name}_stack_plain"] = cuda_ms(torch, lambda: plain(*kargs),
                                               reps=5, warmup=1)
        times[f"{name}_stack_bound"] = kb[name]["bound_ms"]
        times[f"{name}_stack_bound_by"] = kb[name]["bound_by"]
    del args, cpu_args, card_res, cpu_res
    torch.cuda.empty_cache()
    step("times")

    # partition_stats over every row: against its CPU pass (stats_vs_plain)
    # and against build_catalog, whose float64 sums it meets within
    # LAKE_SUM_RTOL, the JAX package's own envelope on these buckets.
    pid = np.repeat(np.arange(CAT_P, dtype=np.int32),
                    [store.rows(p)[1].shape[0] for p in range(CAT_P)])
    c2 = c.reshape(c.shape[0], -1).astype(np.float32)
    a32 = a.astype(np.float32)
    host_cat = src.catalog
    kw = dict(bins=cfg.bins, bin_lo=host_cat.bin_lo.numpy(),
              bin_hi=host_cat.bin_hi.numpy())
    stats_err, dcat, stats_launches = stats_vs_plain(
        torch, f"{tag} partition_stats", c2, a32, pid, CAT_P, cfg.bins,
        kw["bin_lo"], kw["bin_hi"], rtol=LAKE_SUM_RTOL)
    exact = {"n": (dcat.n, host_cat.n),
             "col_lo": (dcat.col_lo, host_cat.col_lo),
             "col_hi": (dcat.col_hi, host_cat.col_hi),
             "count_min_max": (dcat.m_agg[:, 2:], host_cat.m_agg[:, 2:]),
             "hist_row_sums": (dcat.hist.sum(2), host_cat.hist.sum(2))}
    for f, (g, w) in exact.items():
        if not bits_equal(torch, g.cpu(), w):
            raise AssertionError(f"{tag} partition_stats {f} differs from "
                                 "build_catalog")
    if not bool((dcat.hist.sum(2) == dcat.n[:, None]).all()):
        raise AssertionError(f"{tag} partition_stats: histogram rows do "
                             "not hold n")
    for f, g, w in (("col_sum", dcat.col_sum, host_cat.col_sum),
                    ("col_sumsq", dcat.col_sumsq, host_cat.col_sumsq),
                    ("m_agg sums", dcat.m_agg[:, :2], host_cat.m_agg[:, :2])):
        close(f"{tag} partition_stats {f} against build_catalog", g.cpu(), w,
              LAKE_SUM_RTOL, K_ATOL)
    ct, at, pt = (torch.from_numpy(x).to(dev) for x in (c2, a32, pid))
    times["partition_stats"] = cuda_ms(
        torch, lambda: partition_stats(ct, at, pt, CAT_P, **kw), reps=5,
        warmup=1)
    times["partition_stats_device"] = device_profile(
        torch, lambda: partition_stats(ct, at, pt, CAT_P, **kw), reps=5,
        warmup=1)["ms"]
    # Its bound: each of the d + 2 passes reads its values and ids (the
    # histogram pass d values an id) and writes (k, 5); ~7 operations a
    # row a pass.
    rows = c2.shape[0]
    seg_bytes = (d + 1) * rows * 8 + rows * d * 8 \
        + 20 * ((d + 1) * CAT_P + CAT_P * d * cfg.bins)
    seg_ops = 7 * rows * (2 * d + 1)
    t_b, t_o = seg_bytes / PEAK_BYTES_S * 1e3, seg_ops / PEAK_F32_OPS_S * 1e3
    times["partition_stats_bound"] = max(t_b, t_o)
    times["partition_stats_bound_by"] = "bytes" if t_b >= t_o \
        else "operations"
    del ct, at, pt, dcat
    torch.cuda.empty_cache()
    step("partition_stats")

    out = {"rows": int(a.shape[0]), "partitions": CAT_P, "d": d,
           "method": method, "config": CAT_CFG, "queries": 2048,
           "launches": launches, "stats_launches": stats_launches,
           "stack_strata": k_stack, "stack_partitions": k_stack // cfg.k,
           "first_selection_picked": len(picked),
           "candidates": int(sel0.overlap.any(0).sum()),
           "covered_partitions": int((sel0.cover.any(0)
                                      & ~sel0.overlap.any(0)).sum()),
           "cold_first_answer_s": cold_s,
           "flat_build_first_answer_s": run["first_answer_s"],
           "answer_peak_mb_above_resident": peak_mb,
           "quality": quality, "times_ms": times, "stack_check": stack,
           "classes": classes, "stats_err": stats_err,
           "stats_rtol": LAKE_SUM_RTOL,
           "stats_f32_sum_rtol": f32_sum_rtol(int(host_cat.n.max()))}
    if d == 1:
        out["bench"] = bench_cell(torch, card)
        step("bench_partitions defaults")
        out["faults"] = catalog_faults(torch, tag, store, cfg, sv, q, res,
                                       sel0, tmp, eng)
        step("faults and checkpoint")
    out["step_seconds"] = steps
    out["seconds"] = time.perf_counter() - t_phase
    emit(phase=f"{phase} catalog {tag}", card=card, **out)
    del eng, res, src, stacked
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# The sharded state and the distributed helpers: a shard axis on one card
# ---------------------------------------------------------------------------

# Phase 23's sizes: k = 1024 leaves and a sample budget of 77,824, so the
# per-leaf capacity is 76 slots, a multiple of 1, 2 and 4: the merged
# (k, S) shape is the same at every shard count compared.
SHARD_COUNTS = (1, 2, 4)
SHARD_K = 1024
SHARD_BUDGET = 77_824
SHARD_S_CAP = 76
SHARD_BATCH_ROWS = 65536
SHARD_CPU_Q = 128


def leaf_stats_host(c, a, assign, k) -> dict:
    """Exact per-leaf statistics of rows assigned by a skeleton, on the
    host: counts, float64 SUM / SUMSQ, float32 MIN / MAX of the values and
    the float32 box of the coordinates (+inf / -inf where a leaf is
    empty)."""
    c = np.asarray(c, np.float32).reshape(a.shape[0], -1)
    a32 = np.asarray(a, np.float32)
    a64 = a32.astype(np.float64)
    counts = np.bincount(assign, minlength=k)
    order = np.argsort(assign, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    full = counts > 0
    out = {"count": counts.astype(np.float64),
           "sum": np.bincount(assign, weights=a64, minlength=k),
           "sumsq": np.bincount(assign, weights=a64 * a64, minlength=k),
           "min": np.full(k, np.inf, np.float32),
           "max": np.full(k, -np.inf, np.float32),
           "lo": np.full((k, c.shape[1]), np.inf, np.float32),
           "hi": np.full((k, c.shape[1]), -np.inf, np.float32)}
    out["min"][full] = np.minimum.reduceat(a32[order], starts[full])
    out["max"][full] = np.maximum.reduceat(a32[order], starts[full])
    out["lo"][full] = np.minimum.reduceat(c[order], starts[full], axis=0)
    out["hi"][full] = np.maximum.reduceat(c[order], starts[full], axis=0)
    return out


def skeleton_assign(torch, c, a, method) -> tuple:
    """The build's static skeleton (its host subsample and seed) and the
    leaf of every row under it, routed on the card in chunks (row 7 in
    d > 1): the assignment every shard count must reproduce."""
    from repro_torch.sharded import cut_skeleton_1d, cut_skeleton_kd
    from repro_torch.sharded.ingest import route_static
    if c.ndim == 1:
        route = cut_skeleton_1d(c, a, SHARD_K, method=method)
    else:
        route = cut_skeleton_kd(c, a, SHARD_K)
    dev = torch.device("cuda")
    rlo, rhi = (torch.from_numpy(x).to(dev) for x in route)
    c2 = np.asarray(c, np.float32).reshape(a.shape[0], -1)
    assign = np.concatenate([
        route_static(rlo, rhi, torch.from_numpy(c2[i:i + (1 << 20)]).to(dev)
                     )[0].cpu().numpy()
        for i in range(0, c2.shape[0], 1 << 20)])
    return route, assign


def shard_fill(assign, D, k) -> np.ndarray:
    """(k,) reservoir slots a D-shard fill leaves filled: every fill batch
    of SHARD_BATCH_ROWS rows is dealt into D contiguous blocks, and a
    shard fills at most SHARD_S_CAP / D slots of a stratum from its own
    rows. Time-sorted rows put a leaf's rows on few shards, so at D > 1
    the merged reservoirs hold fewer samples than the capacity."""
    n = assign.shape[0]
    row = np.arange(n)
    start = row - row % SHARD_BATCH_ROWS
    size = np.minimum(SHARD_BATCH_ROWS, n - start)
    shard = (row - start) // -(-size // D)
    counts = np.zeros((D, k), np.int64)
    np.add.at(counts, (shard, assign), 1)
    return np.minimum(counts, SHARD_S_CAP // D).sum(0).astype(np.int32)


def check_sharded_build(torch, tag, syn, rep, host_stats, assign, D,
                        first) -> None:
    """One shard count's committed build: counts, n_rows, MIN / MAX and
    boxes equal to the skeleton's exact per-leaf statistics, SUM / SUMSQ
    within f32_sum_rtol of their float64 sums (a float32 sum of n terms),
    the reservoirs filled as the rows were dealt (``shard_fill``), and
    against the first shard count's build the same bits on every field but
    the float sums and the samples (the tree's structure, boxes, counts
    and extremes included)."""
    if rep["s_cap"] != SHARD_S_CAP or syn.sample_a.shape[1] != SHARD_S_CAP:
        raise AssertionError(f"{tag}: s_cap {rep['s_cap']}, samples "
                             f"{tuple(syn.sample_a.shape)}")
    agg = syn.leaf_agg.cpu().numpy()
    h = host_stats
    if not np.array_equal(agg[:, 2], h["count"]):
        raise AssertionError(f"{tag}: leaf counts differ from the "
                             "skeleton's assignment")
    if not np.array_equal(syn.n_rows.cpu().numpy(), h["count"]):
        raise AssertionError(f"{tag}: n_rows differ from the counts")
    full = h["count"] > 0
    for name, got, want in (("min", agg[:, 3], h["min"]),
                            ("max", agg[:, 4], h["max"]),
                            ("leaf_lo", syn.leaf_lo.cpu().numpy(), h["lo"]),
                            ("leaf_hi", syn.leaf_hi.cpu().numpy(), h["hi"])):
        if not np.array_equal(got[full], want[full]):
            raise AssertionError(f"{tag}: {name} differs from the rows'")
    if not (np.isinf(syn.leaf_lo.cpu().numpy()[~full]).all()):
        raise AssertionError(f"{tag}: an empty leaf's box is not inverted")
    rtol = f32_sum_rtol(int(h["count"].max()))
    err = max(close(f"{tag} leaf {f}", agg[:, j], h[f], rtol, K_ATOL)
              for j, f in ((0, "sum"), (1, "sumsq")))
    kpl = shard_fill(assign, D, syn.num_leaves)
    if not (np.array_equal(syn.k_per_leaf.cpu().numpy(), kpl)
            and torch.equal(syn.sample_valid.sum(1).to(torch.int32),
                            syn.k_per_leaf)):
        raise AssertionError(f"{tag}: reservoirs not filled as dealt")
    if first is not None:
        exact = [(f, getattr(syn, f), getattr(first, f)) for f in
                 ("leaf_lo", "leaf_hi", "n_rows")]
        exact += [(f"tree.{f}", getattr(syn.tree, f), getattr(first.tree, f))
                  for f in ("lo", "hi", "left", "right", "leaf_id",
                            "level")]
        exact += [("leaf_agg[:, 2:]", syn.leaf_agg[:, 2:],
                   first.leaf_agg[:, 2:]),
                  ("tree.agg[:, 2:]", syn.tree.agg[:, 2:],
                   first.tree.agg[:, 2:])]
        for f, x, y in exact:
            if not torch.equal(x, y) or (x.is_floating_point()
                                         and not bits_equal(torch, x, y)):
                raise AssertionError(f"{tag}: {f} differs across shard "
                                     "counts")
    emit(check="sharded build", path=tag, sums_max_abs_err=err,
         sums_rtol=rtol, leaves_empty=int((~full).sum()),
         samples=int(kpl.sum()), samples_full=int(
             np.minimum(h["count"], SHARD_S_CAP).sum()))


def stream_sharded(torch, tag, ing, batches, d):
    """Ingest the stream into a committed sharded ingestor: row 5 once a
    shard a batch, row 7 too in d > 1, nothing else; host seconds."""
    from repro_torch.kernels import native
    D, nb = ing.n_shards, len(batches)
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    for cb, ab in batches:
        ing.ingest(cb, ab)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = launches_now(native)
    # Row 10: split(key, D + 1), then one uniform a shard.
    want = {"segment_reduce": D * nb, "threefry": (D + 1) * nb}
    if d > 1:
        want["route_multid"] = D * nb
    if launches != want:
        raise AssertionError(f"{tag} stream: launches {launches} != {want}")
    return seconds, launches


def same_synopsis(torch, tag, x, y) -> None:
    """Every field of two synopses byte for byte."""
    from repro_torch.core.types import PartitionTree, Synopsis
    import dataclasses
    for f in dataclasses.fields(Synopsis):
        if f.name == "tree":
            continue
        u, v = getattr(x, f.name), getattr(y, f.name)
        if isinstance(u, torch.Tensor):
            ok = (bits_equal(torch, u, v) if u.is_floating_point()
                  else torch.equal(u, v))
        else:
            ok = u == v
        if not ok:
            raise AssertionError(f"{tag}: {f.name} differs")
    for f in dataclasses.fields(PartitionTree):
        u, v = getattr(x.tree, f.name), getattr(y.tree, f.name)
        ok = (bits_equal(torch, u, v) if u.is_floating_point()
              else torch.equal(u, v))
        if not ok:
            raise AssertionError(f"{tag}: tree.{f.name} differs")


def sharded_stream_profile(torch, base, mesh, batches) -> dict:
    """profile_batches over a fresh sharded ingestor on the committed
    base."""
    from repro_torch.sharded import ShardedIngestor
    ing = ShardedIngestor(base, mesh=mesh, seed=5)
    return profile_batches(torch, lambda b: ing.ingest(*b), batches)


def sharded_path(torch, tag, c, a, c_s, a_s, method, max_median_err, card,
                 reopt_at=None) -> dict:
    """23. The sharded build, stream and serve at D = 1, 2 and 4 on the
    card (module doc). Returns the last shard count's ingestor, the
    skeleton's assignment and the launch counts and times by D."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.query import random_queries
    from repro_torch.kernels import native
    from repro_torch.sharded import (build_synopsis_sharded, data_mesh,
                                     merge_sharded, reoptimize_sharded)
    from repro_torch.streaming import StreamingIngestor
    t_phase = time.perf_counter()
    d = 1 if c.ndim == 1 else c.shape[1]
    q = random_queries(c, 2048, seed=3)
    batches = batches_of(c_s, a_s)
    nb = len(batches)
    n_fill = -(-a.shape[0] // SHARD_BATCH_ROWS)
    t0 = time.perf_counter()
    route, assign = skeleton_assign(torch, np.asarray(c, np.float32),
                                    np.asarray(a, np.float32), method)
    host_stats = leaf_stats_host(c, a, assign, SHARD_K)
    n = 64
    q_lo, q_hi = q.lo[:n].cpu().numpy(), q.hi[:n].cpu().numpy()
    c_all = np.concatenate([np.asarray(c).reshape(a.shape[0], -1),
                            np.asarray(c_s).reshape(a_s.shape[0], -1)])
    a_all = np.concatenate([a, a_s])
    truth = truth_scan(torch, c_all, a_all, q_lo, q_hi)
    emit(path=f"{tag} sharded", setup_s=time.perf_counter() - t0,
         rows=int(a.shape[0]), stream_rows=int(a_s.shape[0]),
         stream_batches=nb, fill_batches=n_fill)

    per_d, first, stream_ref_ms, roots = {}, None, None, set()
    ing = None
    for D in SHARD_COUNTS:
        mesh = data_mesh(D)
        out = {}
        # build: rows 5 (and 7 in d > 1) once a shard a fill batch
        torch.cuda.synchronize()
        native.reset_launches()
        ing, rep = build_synopsis_sharded(
            c, a, k=SHARD_K, mesh=mesh, method=method,
            sample_budget=SHARD_BUDGET, batch_rows=SHARD_BATCH_ROWS)
        torch.cuda.synchronize()
        launches = launches_now(native)
        want = {"segment_reduce": D * n_fill, "threefry": (D + 1) * n_fill}
        if d > 1:
            want["route_multid"] = D * n_fill
        if launches != want:
            raise AssertionError(f"{tag} D={D} build: launches {launches} "
                                 f"!= {want}")
        base = ing.as_synopsis()
        check_sharded_build(torch, f"{tag} D={D} build", base, rep,
                            host_stats, assign, D, first)
        first = base if first is None else first
        out.update(build_skeleton_s=rep["seconds_skeleton"],
                   build_fill_s=rep["seconds_fill"],
                   build_rows_per_s=rep["rows_per_sec"],
                   build_launches=launches)

        # stream: the 770,000 newer trips in 188 batches
        key0 = ing._key.clone()
        stream_s, launches = stream_sharded(torch, f"{tag} D={D}", ing,
                                            batches, d)
        merged = ing.as_synopsis()
        if D == 1:
            ref = StreamingIngestor(base, key=key0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for cb, ab in batches:
                ref.ingest(cb, ab)
            torch.cuda.synchronize()
            stream_ref_ms = (time.perf_counter() - t0) * 1e3 / nb
            same_synopsis(torch, f"{tag} D=1 stream against "
                          "StreamingIngestor", merged, ref.as_synopsis())
            del ref
        roots.add((float(merged.tree.agg[0, 2]), float(merged.total_rows)))
        out.update(stream_launches=launches,
                   ingest_ms_per_batch=stream_s * 1e3 / nb,
                   streaming_ingestor_ms_per_batch=stream_ref_ms,
                   stream_rows_per_s=a_s.shape[0] / stream_s,
                   kernels_per_batch=sum(launches.values()) / nb)
        out.update(sharded_stream_profile(torch, base, mesh, batches))

        def merge():
            return merge_sharded(ing.base, ing.state, ing._subtree,
                                 total_rows=ing.total_rows, mesh=ing.mesh)

        out["merge_ms"] = cuda_ms(torch, merge, reps=10, warmup=2)
        out["merge_host_ms"] = host_ms(torch, merge, reps=10)

        # serve the merged synopsis: rows 1, 2 and 8 once an answer
        eng = PassEngine(ing, ServingConfig(kinds=KINDS), ci=0.95)
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        native.reset_launches()
        res = eng.answer(q)
        torch.cuda.synchronize()
        launches = launches_now(native)
        want = {"query_eval": 1, "stratified_moments": 1,
                "sample_extremes": 1}
        if launches != want:
            raise AssertionError(f"{tag} D={D} answer: launches {launches}")
        out["answer_launches"] = launches
        out["answer_peak_mb_above_resident"] = (
            torch.cuda.max_memory_allocated() - resident) / 2 ** 20
        check_result_shapes(torch, f"{tag} D={D} sharded", res, 2048)
        quality = check_truth(f"{tag} D={D} sharded", res, truth, n,
                              max_median_err)
        check_cpu_parity(torch, f"{tag} D={D} sharded", merged, q, res,
                         n=SHARD_CPU_Q)
        out["answer_ms"] = cuda_ms(torch, lambda: eng.answer(q), reps=10,
                                   warmup=2)
        out["answer_host_ms"] = host_ms(torch, lambda: eng.answer(q),
                                        reps=10)
        out["quality"] = quality
        if reopt_at == D:
            torch.cuda.synchronize()
            native.reset_launches()
            t0 = time.perf_counter()
            new_ing, report = reoptimize_sharded(ing, c_all[:, 0], a_all,
                                                 batch_rows=SHARD_BATCH_ROWS)
            torch.cuda.synchronize()
            out["reoptimize_s"] = time.perf_counter() - t0
            out["reoptimize_launches"] = launches_now(native)
            syn4 = new_ing.as_synopsis()
            if float(syn4.tree.agg[0, 2]) != float(a_all.shape[0]):
                raise AssertionError(f"{tag} D={D} reoptimized: root count "
                                     f"{float(syn4.tree.agg[0, 2])}")
            eng.replace_source(new_ing)
            res = eng.answer(q)
            torch.cuda.synchronize()
            out["reoptimized_quality"] = check_truth(
                f"{tag} D={D} reoptimized", res, truth, n, max_median_err)
            out["reoptimize_k"] = report["k"]
            del new_ing, syn4
        per_d[D] = out
        emit(path=f"{tag} sharded D={D}", card=card, **out)
        del eng, res, merged, base
        torch.cuda.empty_cache()
    if len(roots) != 1:
        raise AssertionError(f"{tag}: root count / total rows after the "
                             f"stream differ across shard counts: {roots}")
    seconds = time.perf_counter() - t_phase
    emit(phase=f"23 sharded {tag}", card=card, seconds=seconds,
         note="shards on one card run in turn: these numbers are the cost "
              "of the shard axis, not a scaling curve")
    return {"ing": ing, "assign": assign, "route": route, "q": q,
            "per_d": per_d, "seconds": seconds}


def _invariance_digests(torch, d, D) -> dict:
    """The reference's invariance configuration (tests/test_sharded.py:
    n = 16,384, k = 8, sample_budget = 64, seed = 3, integer values in
    [0, 100)) at D shards on the card: BUILD, STREAM, SERVE, GLOBAL and,
    in 1-D, REOPT digests."""
    from repro_torch.api import PassEngine
    from repro_torch.core.types import QueryBatch
    from repro_torch.sharded import (build_synopsis_sharded, data_mesh,
                                     reoptimize_sharded)

    def digest(*xs):
        return b"".join(x.detach().cpu().contiguous().numpy().tobytes()
                        for x in xs).hex()

    rng = np.random.default_rng(0)
    n = 16384
    c = rng.normal(size=(n, d)).astype(np.float32)
    a = rng.integers(0, 100, size=n).astype(np.float32)
    out = {}
    ing, _ = build_synopsis_sharded(c, a, k=8, sample_budget=64, seed=3,
                                    mesh=data_mesh(D))
    syn = ing.as_synopsis()
    out["BUILD"] = digest(syn.leaf_agg, syn.leaf_lo, syn.leaf_hi,
                          syn.tree.agg, syn.tree.lo, syn.tree.hi, syn.n_rows)
    c2 = rng.normal(loc=0.25, size=(2048, d)).astype(np.float32)
    a2 = rng.integers(0, 100, size=2048).astype(np.float32)
    ing.ingest(c2, a2)
    syn2 = ing.as_synopsis()
    out["STREAM"] = digest(syn2.leaf_agg, syn2.tree.agg)
    dev = torch.device("cuda")
    res = PassEngine(ing).answer(QueryBatch(
        torch.full((1, d), -50.0, device=dev),
        torch.full((1, d), 50.0, device=dev)))["sum"]
    out["SERVE"] = digest(res.estimate, res.lower, res.upper)
    for i in range(3):
        cb = rng.normal(loc=0.5 * (i + 1), size=(1024, d)).astype(np.float32)
        ab = rng.integers(0, 100, size=1024).astype(np.float32)
        ing.ingest(cb, ab)
    syn3 = ing.as_synopsis()
    out["GLOBAL"] = digest(syn3.tree.agg[0], syn3.total_rows)
    if d == 1:
        ing4, _ = reoptimize_sharded(ing, np.concatenate([c[:, 0],
                                                          c2[:, 0]]),
                                     np.concatenate([a, a2]), seed=11)
        s4 = ing4.as_synopsis()
        out["REOPT"] = digest(s4.tree.agg[0][[0, 2, 3, 4]],
                              s4.total_rows) + str(s4.num_leaves)
    return out


def sharded_invariance(torch) -> dict:
    """The invariance digests equal at D = 1, 2 and 4, d = 1 and 2."""
    t0 = time.perf_counter()
    for d in (1, 2):
        outs = {D: _invariance_digests(torch, d, D) for D in SHARD_COUNTS}
        for tag in outs[1]:
            if len({outs[D][tag] for D in SHARD_COUNTS}) != 1:
                raise AssertionError(f"sharded invariance d={d}: {tag} "
                                     "differs across shard counts")
    out = {"tags_1d": ["BUILD", "STREAM", "SERVE", "GLOBAL", "REOPT"],
           "tags_2d": ["BUILD", "STREAM", "SERVE", "GLOBAL"],
           "shard_counts": list(SHARD_COUNTS),
           "seconds": time.perf_counter() - t0}
    emit(check="sharded invariance", **out)
    return out


def sharded_faults(torch, base) -> dict:
    """Injected dispatch failures at D = 4 on the committed 1-D base: two of
    four dispatches failing twice recover bit-identical to a clean run
    (four retries); a dispatch failing every attempt drops its batch and
    counts it, and the engine reports it."""
    from repro_torch.api import PassEngine
    from repro_torch.sharded import ShardedIngestor, data_mesh
    from repro_torch.sharded import ingest as shingest
    from repro_torch.streaming.ingest import STATE_FIELDS
    from repro_torch.testing import FaultPlan, inject
    rng = np.random.default_rng(12)
    lo, hi = float(base.leaf_lo.min()), float(base.leaf_hi.max())
    batches = [(rng.uniform(lo, hi, STREAM_BATCH).astype(np.float32),
                rng.lognormal(0.9, 0.8, STREAM_BATCH).astype(np.float32))
               for _ in range(4)]
    mesh = data_mesh(4)
    old = shingest.DISPATCH_BACKOFF_S
    shingest.DISPATCH_BACKOFF_S = 1e-5
    try:
        clean = ShardedIngestor(base, mesh=mesh, seed=21)
        chaotic = ShardedIngestor(base, mesh=mesh, seed=21)
        for cb, ab in batches:
            clean.ingest(cb, ab)
        with inject(FaultPlan(shard_fail_every=2, shard_fail_persist=2)):
            for cb, ab in batches:
                chaotic.ingest(cb, ab)
        dropped = ShardedIngestor(base, mesh=mesh, seed=23)
        with inject(FaultPlan(shard_fail_every=2, shard_fail_persist=-1)):
            for cb, ab in batches[:2]:
                dropped.ingest(cb, ab)
    finally:
        shingest.DISPATCH_BACKOFF_S = old
    stats = chaotic.fault_stats()
    if stats["dispatch_retries"] != 4 or stats["dropped_batches"] != 0:
        raise AssertionError(f"transient shard failures: {stats}")
    for f in STATE_FIELDS:
        x, y = getattr(clean.state, f), getattr(chaotic.state, f)
        if not (bits_equal(torch, x, y) if x.is_floating_point()
                else torch.equal(x, y)):
            raise AssertionError(f"transient shard failures: {f} differs "
                                 "from a clean run")
    faults = PassEngine(dropped).stats()["faults"]
    if (faults["dropped_batches"] != 1 or dropped.n_stream != STREAM_BATCH
            or dropped.epoch != 1):
        raise AssertionError(f"persistent shard failure: {faults}")
    out = {"transient": stats, "persistent": faults}
    emit(check="sharded faults", **out)
    return out


def distributed_path(torch, card, ing, assign, c, a, q) -> dict:
    """24. core/distributed.py on a (4, 2) "data" x "model" mesh and the
    sharded catalog delta, on the card (module doc)."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core import distributed as dist
    from repro_torch.core.query import random_queries
    from repro_torch.kernels import native
    from repro_torch.partitions import (build_catalog, partition_rows,
                                        partition_stats)
    from repro_torch.sharded import catalog_delta_sharded, data_mesh, \
        make_mesh
    t_phase = time.perf_counter()
    dev = torch.device("cuda")
    mesh = make_mesh((4, 2), ("data", "model"))
    syn = ing.as_synopsis()
    k = syn.num_leaves
    out, times = {}, {}

    # build_leaf_aggregates over the 7.7 M rows: 8 blocks, row 5 each
    at = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    it = torch.from_numpy(assign.astype(np.int32)).to(dev)
    native.reset_launches()
    agg = dist.build_leaf_aggregates(mesh, at, it, k,
                                     data_axes=("data", "model"))
    torch.cuda.synchronize()
    out["build_leaf_aggregates_launches"] = launches_now(native)
    if out["build_leaf_aggregates_launches"] != {"segment_reduce": 8}:
        raise AssertionError(f"build_leaf_aggregates launched "
                             f"{out['build_leaf_aggregates_launches']}")
    h = leaf_stats_host(a[:, None], a, assign, k)
    full = h["count"] > 0
    g = agg.cpu().numpy().astype(np.float64)
    host_agg = np.stack([h["sum"], h["sumsq"], h["count"],
                         np.where(full, h["min"], 3e38),
                         np.where(full, h["max"], -3e38)], 1)
    out["build_leaf_aggregates_err"] = max(
        close("build_leaf_aggregates sums", g[:, :3], host_agg[:, :3],
              2e-4, 0.0),
        close("build_leaf_aggregates min/max", g[:, 3:], host_agg[:, 3:],
              1e-5, 0.0))
    times["build_leaf_aggregates"] = cuda_ms(
        torch, lambda: dist.build_leaf_aggregates(
            mesh, at, it, k, data_axes=("data", "model")), reps=5, warmup=1)
    del at, it

    # serve_queries_sharded: 8 query blocks against the whole-batch answer
    eng = PassEngine(syn, ServingConfig(kinds=("sum",)))
    q13 = random_queries(c, 13, seed=2)
    for name, qb in (("q2048", q), ("q13", q13)):
        ref = eng.answer(qb)["sum"]
        native.reset_launches()
        got = dist.serve_queries_sharded(mesh, syn, qb, kind="sum")
        torch.cuda.synchronize()
        launches = launches_now(native)
        if launches != {"query_eval": 8, "stratified_moments": 8}:
            raise AssertionError(f"serve_queries_sharded {name}: {launches}")
        out[f"serve_queries_sharded_{name}_launches"] = launches
        for f, x, rtol, atol in (("estimate", got[0], 1e-5, 0.0),
                                 ("ci_half", got[1], 1e-4, 1e-3),
                                 ("lower", got[2], 1e-5, 0.0),
                                 ("upper", got[3], 1e-5, 0.0)):
            close(f"serve_queries_sharded {name} {f}", x.cpu(),
                  getattr(ref, f).cpu(), rtol, atol)
        out[f"serve_queries_sharded_{name}_bit_equal"] = all(
            bits_equal(torch, x, getattr(ref, f)) for x, f in zip(
                got, ("estimate", "ci_half", "lower", "upper")))
    times["serve_queries_sharded"] = host_ms(
        torch, lambda: dist.serve_queries_sharded(mesh, syn, q, kind="sum"),
        reps=5)
    times["answer_whole_batch"] = host_ms(torch, lambda: eng.answer(q),
                                          reps=5)

    # serve_samples_sharded: the slot axis in 2 "model" blocks
    for kind in ("sum", "count"):
        ref = PassEngine(syn, ServingConfig(kinds=(kind,))).answer(q)[kind]
        native.reset_launches()
        est, ci = dist.serve_samples_sharded(mesh, syn, q, kind=kind)
        torch.cuda.synchronize()
        launches = launches_now(native)
        if launches != {"query_eval": 1, "stratified_moments": 2}:
            raise AssertionError(f"serve_samples_sharded {kind}: {launches}")
        out[f"serve_samples_sharded_{kind}_launches"] = launches
        out[f"serve_samples_sharded_{kind}_err"] = close(
            f"serve_samples_sharded {kind}", est.cpu(), ref.estimate.cpu(),
            1e-4, 1e-2)
        if not bool(torch.isfinite(ci).all()):
            raise AssertionError(f"serve_samples_sharded {kind}: ci")
    times["serve_samples_sharded"] = cuda_ms(
        torch, lambda: dist.serve_samples_sharded(mesh, syn, q, kind="sum"),
        reps=5, warmup=1)

    # catalog_delta_sharded over the lake's 1024 time buckets at D = 4
    store = partition_rows(c, a, CAT_P)
    parts = [store.rows(p) for p in range(CAT_P)]
    host_cat = build_catalog(parts, bins=16)
    pid = np.repeat(np.arange(CAT_P, dtype=np.int32),
                    [x[1].shape[0] for x in parts])
    c2 = torch.from_numpy(np.asarray(c, np.float32).reshape(-1, 1)).to(dev)
    a2 = torch.from_numpy(np.asarray(a, np.float32)).to(dev)
    p2 = torch.from_numpy(pid).to(dev)
    kw = dict(bins=16, bin_lo=host_cat.bin_lo, bin_hi=host_cat.bin_hi,
              mesh=data_mesh(4))
    native.reset_launches()
    cat = catalog_delta_sharded(c2, a2, p2, CAT_P, **kw)
    torch.cuda.synchronize()
    launches = launches_now(native)
    if launches != {"segment_reduce": 4 * 3}:
        raise AssertionError(f"catalog_delta_sharded launched {launches}")
    out["catalog_delta_sharded_launches"] = launches
    # build_catalog bins in float64, the device pass in float32, so rows
    # on a bin edge may land one bin apart: the histogram is held to the
    # one-pass partition_stats over the same rows, its row sums to
    # build_catalog's.
    one = partition_stats(c2, a2, p2, CAT_P, bins=16, bin_lo=kw["bin_lo"],
                          bin_hi=kw["bin_hi"])
    for f, x, y in (("n", cat.n, host_cat.n),
                    ("col_lo", cat.col_lo, host_cat.col_lo),
                    ("col_hi", cat.col_hi, host_cat.col_hi),
                    ("hist row sums", cat.hist.sum(2), host_cat.hist.sum(2)),
                    ("count_min_max", cat.m_agg[:, 2:],
                     host_cat.m_agg[:, 2:])):
        if not bits_equal(torch, x, y):
            raise AssertionError(f"catalog_delta_sharded {f} differs from "
                                 "build_catalog")
    for f in ("n", "col_lo", "col_hi", "hist"):
        if not bits_equal(torch, getattr(cat, f), getattr(one, f)):
            raise AssertionError(f"catalog_delta_sharded {f} differs from "
                                 "one partition_stats pass")
    out["catalog_delta_sharded_err"] = max(
        close(f"catalog_delta_sharded {f}", x.cpu(), y.cpu(), LAKE_SUM_RTOL,
              K_ATOL)
        for f, x, y in (("col_sum", cat.col_sum, host_cat.col_sum),
                        ("col_sumsq", cat.col_sumsq, host_cat.col_sumsq),
                        ("m_agg sums", cat.m_agg[:, :2],
                         host_cat.m_agg[:, :2])))
    times["catalog_delta_sharded"] = cuda_ms(
        torch, lambda: catalog_delta_sharded(c2, a2, p2, CAT_P, **kw),
        reps=3, warmup=1)
    del c2, a2, p2, cat, one
    torch.cuda.empty_cache()
    out["times_ms"] = times
    out["seconds"] = time.perf_counter() - t_phase
    emit(phase="24 distributed and sharded catalog", card=card, **out)
    return out


def sharded_phases(torch, nyc_taxi, card, c1=None, a1=None, c3=None,
                   a3=None) -> tuple:
    """Phases 23 and 24 on the main cells' data (loaded here when not
    given): the sharded build, stream and serve in 1-D (re-optimized at
    D = 2) and 3-D, the invariance configuration, dispatch faults, then
    the distributed helpers and the sharded catalog delta."""
    if c1 is None:
        c1, a1 = nyc_taxi(scale=1.0)
        c3, a3 = nyc_taxi(scale=1.0, dims=3)
    cs1, as1 = nyc_taxi(scale=0.1, seed=7)
    sh1 = sharded_path(torch, "1d", c1, a1, cs1, as1, "adp", 0.05, card,
                       reopt_at=2)
    del cs1, as1
    cs3, as3 = nyc_taxi(scale=0.1, seed=7, dims=3)
    sh3 = sharded_path(torch, "3d", c3, a3, cs3, as3, "kd", 0.15, card)
    del cs3, as3, sh3["ing"]
    torch.cuda.empty_cache()
    sh1["invariance"] = sharded_invariance(torch)
    sh1["faults"] = sharded_faults(torch, sh1["ing"].base)
    dist24 = distributed_path(torch, card, sh1["ing"], sh1["assign"], c1, a1,
                              sh1["q"])
    del sh1["ing"]
    torch.cuda.empty_cache()
    return sh1, sh3, dist24


def sharded_summary(sh1, sh3, dist24) -> dict:
    """The sharded phases' numbers by cell and shard count."""
    keys = ("build_skeleton_s", "build_fill_s", "build_rows_per_s",
            "ingest_ms_per_batch", "streaming_ingestor_ms_per_batch",
            "kernels_per_batch", "device_kernels_per_batch",
            "device_busy_ms_per_batch", "device_busy_share", "merge_ms",
            "merge_host_ms", "answer_ms", "answer_host_ms",
            "answer_peak_mb_above_resident")
    out = {tag: {D: dict({k: x[k] for k in keys},
                         sum_median_rel_err=x["quality"][
                             "sum_median_rel_err"])
                 for D, x in sh["per_d"].items()}
           for tag, sh in (("1d", sh1), ("3d", sh3))}
    out["1d"]["reoptimize_s_at_2"] = sh1["per_d"][2]["reoptimize_s"]
    out["seconds"] = {"23_1d": sh1["seconds"], "23_3d": sh3["seconds"],
                      "24": dist24["seconds"]}
    out["distributed_ms"] = dist24["times_ms"]
    out["note"] = ("shards on one card run in turn: the cost of the shard "
                   "axis, not a scaling curve")
    return out


# ---------------------------------------------------------------------------
# Table 1 at paper size: the baselines, the legacy update path, the examples
# ---------------------------------------------------------------------------

# benchmarks/table1_accuracy.py's budgets on the 7.7 M trips: K = 0.5 % of
# the rows (~38,500 samples), B = 64 strata / partitions, one batch of
# random_queries(c, 2048, seed=11).
T1_RATE, T1_B, T1_Q, T1_SEED = 0.005, 64, 2048, 11
T1_KINDS = ("count", "sum", "avg")
T1_CPU_Q = 128
# Queries of the plain bootstrap at the US shape (k = 1, s = 38,500, R =
# 200): its (8, Q', 1, s) temporaries take ~80 MB each at Q' = 64.
US_PLAIN_Q = 64
# tests/test_system.py's ordering on SUM, and AQP++'s bar there.
T1_AQPPP_ERR = 0.1
# A plain version's chunk of queries keeps its (Q, k, s) planes at ~2**27
# elements (512 MB a float32 plane); so does the library call's predicate
# build.
PLAIN_ELEMS = 1 << 27
# fig 8's KD cell (benchmarks/fig8_multidim.py): 2 % samples, k = 64,
# proportional allocation, queries of 30-80 % of each column, seed 19.
F8_RATE, F8_K, F8_Q, F8_SEED = 0.02, 64, 512, 19
# The legacy per-row loop takes the stream's first LEGACY_ROWS rows (it is
# Python per row); to_streaming() ingests the rest in STREAM_BATCH rows. In
# 3-D, LEGACY_ROWS_3D rows per row, then LEGACY_BATCHES_3D batches.
LEGACY_ROWS = 20_000
LEGACY_ROWS_3D, LEGACY_BATCHES_3D = 2_000, 16
EXAMPLES = ("torch_quickstart", "torch_aqp_service", "torch_serve_service",
            "torch_workload_shift")


def plain_step(k: int, s: int) -> int:
    """Queries a chunk of a plain version at k strata of s slots."""
    return max(1, PLAIN_ELEMS // max(k * s, 1))


def chunked_plain(torch, fn, sm, q_lo, q_hi, step):
    """fn(*sm, q_lo, q_hi) over chunks of ``step`` queries, concatenated on
    the query axis (tuple outputs field by field)."""
    outs = [fn(*sm, q_lo[i:i + step], q_hi[i:i + step])
            for i in range(0, q_lo.shape[0], step)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(x) for x in zip(*outs))
    return torch.cat(outs)


def sorted_rows(c, a):
    """(c, a) sorted by the 1-D column (stable), as truth_1d needs."""
    if np.all(np.diff(c) >= 0):
        return c, a
    order = np.argsort(c, kind="stable")
    return c[order], a[order]


def truth_union(parts, q_lo, q_hi) -> dict:
    """truth_1d over the union of 1-D row sets: sums and counts added,
    MIN / MAX combined."""
    out = None
    for c, a in parts:
        t = truth_1d(*sorted_rows(c, a), q_lo, q_hi)
        if out is None:
            out = t
            continue
        out = {"sum": out["sum"] + t["sum"], "count": out["count"] + t["count"],
               "min": np.minimum(out["min"], t["min"]),
               "max": np.maximum(out["max"], t["max"])}
    out["avg"] = out["sum"] / np.maximum(out["count"], 1)
    return out


def median_rel_err(est, t) -> float:
    """Median relative error over the queries whose truth is not zero
    (tests/test_system.py's rule)."""
    est = host(est).astype(np.float64)
    keep = np.abs(t) > 1e-9
    return float(np.median(np.abs(est[keep] - t[keep]) / np.abs(t[keep])))


def serving_vs_plain(torch, tag, syn, q) -> dict:
    """Rows 1, 2 and 8 against their plain versions at this synopsis's
    shapes, the plain ones over chunks of queries: rel equal and exact
    within tolerance (qe_vs_plain), the moments' counts equal and sums
    within rtol=3e-5, atol=1e-3, the extremes bit-equal (NaN as NaN); each
    kernel bit-equal across two launches. Returns the max errors."""
    from repro_torch.kernels.sample_extremes import (sample_extremes_cuda,
                                                     sample_extremes_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain)
    qe_err, covered = qe_vs_plain(torch, tag, syn.leaf_lo, syn.leaf_hi,
                                  syn.leaf_agg, q.lo, q.hi)
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    k, s = syn.sample_a.shape
    step = plain_step(k, s)
    got = stratified_moments_cuda(*sm, q.lo, q.hi)
    again = stratified_moments_cuda(*sm, q.lo, q.hi)
    want = chunked_plain(torch, stratified_moments_plain, sm, q.lo, q.hi,
                         step)
    if not bits_equal(torch, got, again):
        raise AssertionError(f"{tag}: stratified_moments differs between "
                             "two launches")
    if not torch.equal(got[..., 0], want[..., 0]):
        raise AssertionError(f"{tag}: stratified_moments counts differ")
    sm_err = max(close(f"{tag} stratified_moments[{i}]", got[..., i].cpu(),
                       want[..., i].cpu(), K_RTOL, K_ATOL) for i in (1, 2))
    ext = sample_extremes_cuda(*sm, q.lo, q.hi)
    ext2 = sample_extremes_cuda(*sm, q.lo, q.hi)
    ext_p = chunked_plain(torch, sample_extremes_plain, sm, q.lo, q.hi, step)
    for name, g, g2, w in zip(("min", "max"), ext, ext2, ext_p):
        if not (same_bits(torch, g, g2) and same_bits(torch, g, w)):
            raise AssertionError(f"{tag}: sample_extremes {name} differs "
                                 "from plain or between two launches")
    del got, again, want, ext, ext2, ext_p
    torch.cuda.empty_cache()
    errs = {"query_eval": qe_err, "stratified_moments": sm_err,
            "sample_extremes": 0.0}
    emit(check="table1 kernel_vs_plain", shape=tag, k=k, s=s,
         Q=int(q.lo.shape[0]), plain_chunk_queries=step,
         covered_pairs=covered, max_abs_err=errs,
         sample_extremes_bit_equal=True)
    return errs


def table1_kernel_times(torch, tag, syn, q, card) -> dict:
    """Rows 1, 2 and 8 at this synopsis's shapes: events and device time of
    each kernel, its plain version's (over query chunks), its bound from
    this run's pair classes, and for row 2 torch.bmm of a predicate (k, Q,
    s) built beforehand against [1, a, a^2] (k, s, 3), TF32 off, checked
    against the kernel first."""
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    from repro_torch.kernels.sample_extremes import (sample_extremes_cuda,
                                                     sample_extremes_plain)
    from repro_torch.kernels.stratified_estimate import (
        samples_inside, stratified_moments_cuda, stratified_moments_plain)
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    qe = (syn.leaf_lo, syn.leaf_hi, syn.leaf_agg, q.lo, q.hi)
    k, s = syn.sample_a.shape
    Q = q.lo.shape[0]
    step = plain_step(k, s)
    rel, _ = query_eval_cuda(*qe)
    classes = pair_classes(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi,
                           chunk=step)
    bnd = bounds(syn, q, rel, classes)
    times = {}
    for name, kernel, plain in (
            ("query_eval", lambda: query_eval_cuda(*qe),
             lambda: query_eval_plain(*qe)),
            ("stratified_moments",
             lambda: stratified_moments_cuda(*sm, q.lo, q.hi),
             lambda: chunked_plain(torch, stratified_moments_plain, sm, q.lo,
                                   q.hi, step)),
            ("sample_extremes",
             lambda: sample_extremes_cuda(*sm, q.lo, q.hi),
             lambda: chunked_plain(torch, sample_extremes_plain, sm, q.lo,
                                   q.hi, step))):
        times[name] = cuda_ms(torch, kernel, reps=10, warmup=2)
        times[f"{name}_device"] = device_ms(torch, kernel, reps=10,
                                            one_op=True)
        times[f"{name}_plain"] = cuda_ms(torch, plain, reps=3, warmup=1)
        times[f"{name}_plain_device"] = device_ms(torch, plain, reps=2,
                                                  warmup=1)
    pred = torch.empty((k, Q, s), dtype=torch.float32, device=q.lo.device)
    for i in range(0, Q, step):
        pred[:, i:i + step] = samples_inside(
            syn.sample_c, syn.sample_valid, q.lo[i:i + step],
            q.hi[i:i + step]).permute(1, 0, 2)
    a = syn.sample_a
    rhs = torch.stack([torch.ones_like(a), a, a * a], dim=-1).contiguous()
    lib = torch.bmm(pred, rhs).permute(1, 0, 2)
    ker = stratified_moments_cuda(*sm, q.lo, q.hi)
    if not torch.equal(lib[..., 0], ker[..., 0]):
        raise AssertionError(f"{tag}: torch.bmm's counts differ from "
                             "stratified_moments'")
    lib_err = max(close(f"{tag} torch.bmm[{i}]", lib[..., i].cpu(),
                        ker[..., i].cpu(), K_RTOL, K_ATOL) for i in (1, 2))
    del lib, ker
    times["bmm_stratified_moments"] = cuda_ms(
        torch, lambda: torch.bmm(pred, rhs), reps=10, warmup=2)
    times["bmm_stratified_moments_device"] = device_ms(
        torch, lambda: torch.bmm(pred, rhs), reps=10)
    del pred
    torch.cuda.empty_cache()
    emit(times_ms=times, path=f"table1 {tag}", Q=int(Q), k=int(k), s=int(s),
         bounds=bnd, pair_classes=classes, plain_chunk_queries=step,
         bmm_max_abs_err_vs_kernel=lib_err, card=card)
    return {"times": times, "bounds": bnd, "classes": classes, "k": int(k),
            "s": int(s), "Q": int(Q)}


def table1_baseline(torch, syns, q, base) -> dict:
    """Row 2 of every Table 1 arm against the baseline kernel
    (baseline_moments_check: bit-equal for s <= PAIR_CHUNK); above one slot
    chunk the kernel's values are held within tolerance of plain first.
    Returns the differing values by arm."""
    from repro_torch.kernels.stratified_estimate import (
        PAIR_CHUNK, stratified_moments_cuda, stratified_moments_plain)
    out = {}
    for name, syn in syns.items():
        sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
        k, s = syn.sample_a.shape
        got = stratified_moments_cuda(*sm, q.lo, q.hi)
        tag = f"table1 {name} baseline"
        if s > PAIR_CHUNK:
            want = chunked_plain(torch, stratified_moments_plain, sm, q.lo,
                                 q.hi, plain_step(k, s))
            if not torch.equal(got[..., 0], want[..., 0]):
                raise AssertionError(f"{tag}: stratified_moments counts "
                                     "differ")
            for i in (1, 2):
                close(f"{tag} stratified_moments[{i}]", got[..., i].cpu(),
                      want[..., i].cpu(), K_RTOL, K_ATOL)
            del want
        out[name] = {"s": int(s), "differing": baseline_moments_check(
            torch, tag, got, base, *sm, q.lo, q.hi)}
        del got
        torch.cuda.empty_cache()
    emit(check="table1 row 2 against the baseline", arms=out)
    return out


def table1_arm(torch, tag, syn, q, card, **serving_kw) -> dict:
    """One PASS-synopsis arm of Table 1: all five kinds through the
    deprecated ``core.query.answer`` shim and through PassEngine, each in
    its own launch window (rows 1, 2 and 8 must each launch), the two
    answers torch.equal, the port's CPU answer on the first T1_CPU_Q
    queries, and the answer's time by events and device time."""
    import warnings

    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core import answer as shim_answer
    from repro_torch.kernels import native
    torch.cuda.synchronize()
    native.reset_launches()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        via_shim = shim_answer(syn, q, kinds=KINDS, **serving_kw)
    torch.cuda.synchronize()
    shim_launches = launches_now(native)
    native.reset_launches()
    eng = PassEngine(syn, ServingConfig(kinds=KINDS, **serving_kw))
    res = eng.answer(q)
    torch.cuda.synchronize()
    launches = launches_now(native)
    for window, got in (("shim", shim_launches), ("engine", launches)):
        for name in ("query_eval", "stratified_moments", "sample_extremes"):
            if got.get(name, 0) < 1:
                raise AssertionError(f"table1 {tag}: {name} was not launched "
                                     f"in the {window} window ({got})")
    require_same(f"table1 {tag} shim vs PassEngine", via_shim, res, KINDS)
    for kind in KINDS:
        est = res[kind].estimate
        if est.shape != q.lo.shape[:1] or not bool(torch.isfinite(est).all()):
            raise AssertionError(f"table1 {tag} {kind}: estimate of shape "
                                 f"{tuple(est.shape)}, or not finite")
    check_cpu_parity(torch, f"table1 {tag}", syn, q, res, n=T1_CPU_Q,
                     kinds=KINDS, ci=None, **serving_kw)
    times = {"answer": cuda_ms(torch, lambda: eng.answer(q), reps=10,
                               warmup=2),
             "answer_host": host_ms(torch, lambda: eng.answer(q), reps=10),
             "answer_device": device_profile(torch, lambda: eng.answer(q),
                                             reps=5, warmup=1)["ms"]}
    return {"res": res, "launches": launches, "shim_launches": shim_launches,
            "times_ms": times, "k": int(syn.num_leaves),
            "s": int(syn.sample_a.shape[1]),
            "samples": int(syn.sample_valid.sum())}


def table1_shims(torch, syn, q) -> dict:
    """Every deprecated serving shim once on the card against its
    PassEngine answer, torch.equal; the bootstrap shim launches
    bootstrap_moments once (fused)."""
    import warnings

    from repro_torch import engine, uncertainty
    from repro_torch.api import CIConfig, PassEngine, ServingConfig
    from repro_torch.core import estimators
    from repro_torch.kernels import native
    three = ("sum", "count", "avg")
    cases = (
        ("engine.answer", lambda: engine.answer(syn, q, kinds=KINDS),
         ServingConfig(kinds=KINDS), None),
        ("core.estimators.estimate",
         lambda: {"avg": estimators.estimate(syn, q, kind="avg")},
         ServingConfig(kinds=("avg",)), None),
        ("uncertainty.answer_with_ci",
         lambda: uncertainty.answer_with_ci(syn, q, three, level=0.95),
         ServingConfig(kinds=three), CIConfig(level=0.95)),
        ("uncertainty.poisson_bootstrap",
         lambda: uncertainty.poisson_bootstrap(syn, q, three, n_boot=200,
                                               seed=5),
         ServingConfig(kinds=three),
         CIConfig(method="bootstrap", n_boot=200, key=5)))
    out = {}
    for name, call, sv, ci in cases:
        torch.cuda.synchronize()
        native.reset_launches()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            got = call()
        torch.cuda.synchronize()
        out[name] = launches_now(native)
        want = PassEngine(syn, sv, ci=ci).answer(q)
        require_same(f"table1 shim {name}", got, want, tuple(want))
    if out["uncertainty.poisson_bootstrap"].get("bootstrap_moments") != 1:
        raise AssertionError("table1: the poisson_bootstrap shim launched "
                             f"{out['uncertainty.poisson_bootstrap']}")
    emit(check="table1 shims equal PassEngine", launches=out)
    return out


def weighted_device_ms(torch, fn) -> float:
    """Device ms of one weighted launch (rows 3 and 4): the sum of the mean
    record of each of its kernels (weighted_*_kernel) in a profiler
    window."""
    return records_ms(device_by_name(torch, fn), lambda name: (
        "weighted_" in name and "_kernel" in name))


def weighted_turns(torch, tag, sm, W, q_lo, q_hi, base, reps=10) -> dict:
    """Rows 3 (the weight row W[0]) and 4 (W) at one shape in turns with
    the baseline's kernels, kernel, baseline, baseline, kernel, each turn
    by events (median of ``reps``) and on the device (weighted_device_ms);
    first each output bit-equal to the baseline's where
    baseline_bits_required. Without a baseline, the kernel's two turns."""
    from repro_torch.kernels.bootstrap import bootstrap_moments_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_weighted_moments_cuda)
    t0 = time.perf_counter()
    w0 = W[0].contiguous()
    lib = None if base is None else base["weighted_moments"]
    out = {}
    for name, w, fn in (
            ("stratified_weighted_moments", w0,
             lambda: stratified_weighted_moments_cuda(*sm, w0, q_lo, q_hi)),
            ("bootstrap_moments", W,
             lambda: bootstrap_moments_cuda(*sm, W, q_lo, q_hi))):
        turns = [("kernel", fn)]
        if lib is not None:
            def old(w=w):
                return baseline_moments(torch, lib, sm, w, q_lo, q_hi)
            if (baseline_bits_required(lib, sm[1].shape[1])
                    and not bits_equal(torch, fn(), old())):
                raise AssertionError(f"{tag} {name} differs from the "
                                     "baseline kernel")
            torch.cuda.empty_cache()
            turns += [("baseline", old), ("baseline", old)]
        turns.append(("kernel", fn))
        row = {"order": [who for who, _ in turns], "ms": [],
               "device_ms": []}
        for _, f in turns:
            row["ms"].append(cuda_ms(torch, f, reps=reps, warmup=2))
            row["device_ms"].append(weighted_device_ms(torch, f))
        for who in ("kernel", "baseline"):
            got = [i for i, x in enumerate(row["order"]) if x == who]
            if got:
                row[f"{who}_ms"] = mean_of(row["ms"][i] for i in got)
                row[f"{who}_device_ms"] = mean_of(row["device_ms"][i]
                                                  for i in got)
        out[name] = row
    emit(check="rows 3 and 4 in turns with the baseline", shape=tag,
         Q=int(q_lo.shape[0]), k=int(sm[1].shape[0]), s=int(sm[1].shape[1]),
         R=int(W.shape[0]), turns=out, seconds=time.perf_counter() - t0)
    return out


def walk_bound(torch, c, valid, q_lo, q_hi, R, step) -> dict:
    """Least time for rows 3 and 4 at R replicates on these inputs: the
    bytes (samples, weights and queries read once, the (R, Q, k, 3)
    output written once) over 3.35 TB/s, or the operations over 67
    TFLOP/s: 5 a valid slot and replicate for the segments' totals, 4d
    compares a (query, segment) pair for its class, and for the mixed
    pairs (some but not all of a segment's valid slots inside; segments of
    WEIGHTED_CHUNK slots) 2 compares a slot in each column that cuts the
    pair (cut_columns of the segment) and 5 a relevant (replicate, slot).
    Counted over chunks of ``step`` queries."""
    from repro_torch.kernels.stratified_estimate import (WEIGHTED_CHUNK,
                                                         samples_inside,
                                                         weighted_chunks)
    k, s, d = c.shape
    Q = int(q_lo.shape[0])
    n_ch = weighted_chunks(s)
    pad = n_ch * WEIGHTED_CHUNK - s if s > WEIGHTED_CHUNK else 0
    width = WEIGHTED_CHUNK if s > WEIGHTED_CHUNK else max(s, 1)
    seg_valid = torch.nn.functional.pad(valid, (0, pad)).view(
        k, n_ch, width).sum(-1)
    seg_len = torch.nn.functional.pad(torch.ones_like(valid), (0, pad)).view(
        k, n_ch, width).sum(-1)
    ext = slot_extents(
        torch, torch.nn.functional.pad(c, (0, 0, 0, pad)).view(
            k * n_ch, width, d),
        torch.nn.functional.pad(valid, (0, pad)).view(k * n_ch, width))
    mixed = slots = rel = cut_slots = 0
    for i in range(0, Q, step):
        ql, qh = q_lo[i:i + step], q_hi[i:i + step]
        n_in = torch.nn.functional.pad(samples_inside(
            c, valid, ql, qh), (0, pad)).view(-1, k, n_ch, width).sum(-1)
        m = (n_in > 0) & (n_in < seg_valid)
        mixed += int(m.sum())
        slots += int((seg_len * m).sum())
        rel += int((n_in * m).sum())
        cut = cut_columns(ext, ql, qh).view(-1, k, n_ch)
        cut_slots += int((seg_len * m * cut).sum())
    n_valid = int(valid.sum())
    nbytes = (4 * k * s * d + 4 * k * s + k * s + 8 * Q * d + 4 * R * k * s
              + 12 * R * Q * k)
    ops = (5.0 * R * n_valid + 4.0 * d * Q * k * n_ch + 2.0 * cut_slots
           + 5.0 * R * rel)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S * 1e3, ops / PEAK_F32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops, "mixed_pairs": mixed,
            "mixed_pair_slots": slots, "relevant_slots_in_mixed": rel,
            "mixed_pair_cut_column_slots": cut_slots}


def bmm_rhs(torch, W, a):
    """[w, w*a, w*a^2] of R' weight rows (R', k, s) as (k, s, 3R'), the
    right side of the library yardstick's product."""
    k, s = a.shape
    t = torch.stack([W, W * a, W * a * a], dim=-1)
    return t.permute(1, 2, 0, 3).reshape(k, s, -1).contiguous()


def us_bootstrap(torch, card, syn, q, truth, base=None) -> dict:
    """Table 1's US arm (k = 1, s = 38,500: above one slot chunk of rows 3
    and 4) under CIConfig(method="bootstrap", n_boot=200, key=5) through
    PassEngine (use_aggregates=False, as the arm serves): fused (one
    bootstrap_moments and one row-10 launch) and scan (200 of each of
    stratified_weighted_moments and row 10), bit-equal; the truth of 64
    queries inside [lower, upper]; the port's CPU answer on the first 16
    queries. Then row 4 at this shape against plain on the first
    US_PLAIN_Q queries, timed by events and on the device against its
    bound (walk_bound) and torch.bmm of a prebuilt predicate (TF32 off);
    row 3 there (R = 1, the scan's launch) the same way against the R = 1
    product; the device ms of each kernel of both launches; the scan
    answer's time; with a baseline, rows 3 and 4 in turns with its kernels
    (weighted_turns). The poisson_bootstrap shim
    and weighted_moments_flat run on it in table1_shims and
    flat_ops_check."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.kernels import native
    from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                               bootstrap_moments_plain)
    from repro_torch.kernels.stratified_estimate import (
        WEIGHTED_CHUNK, samples_inside, stratified_weighted_moments_cuda,
        weighted_plan)
    t0 = time.perf_counter()
    sv = ServingConfig(kinds=BOOT_KINDS, use_aggregates=False)
    Q = int(q.lo.shape[0])
    res, launches = {}, {}
    for fused in (True, False):
        eng = PassEngine(syn, sv, boot_ci(boot_fused=fused))
        torch.cuda.synchronize()
        native.reset_launches()
        res[fused] = eng.answer(q)
        torch.cuda.synchronize()
        launches[fused] = launches_now(native)
        check_result_shapes(torch, f"table1 US bootstrap fused={fused}",
                            res[fused], Q, BOOT_KINDS)
    if (launches[True].get("bootstrap_moments") != 1
            or "stratified_weighted_moments" in launches[True]
            or launches[False].get("stratified_weighted_moments") != N_BOOT
            or "bootstrap_moments" in launches[False]):
        raise AssertionError(f"table1 US bootstrap launches {launches}")
    for kind in BOOT_KINDS:
        for field in ("estimate", "ci_lo", "ci_hi", "ci_half"):
            x, y = getattr(res[True][kind], field), getattr(res[False][kind],
                                                            field)
            if not bits_equal(torch, x, y):
                raise AssertionError(f"table1 US bootstrap {kind}.{field}: "
                                     "fused != scan")
    n = 64
    quality = check_truth("table1 US bootstrap", res[True],
                          {key: v[:n] for key, v in truth.items()}, n, 0.1,
                          BOOT_KINDS)
    check_cpu_parity(torch, "table1 US bootstrap", syn, q, res[True], n=16,
                     kinds=BOOT_KINDS, ci=boot_ci(), use_aggregates=False)
    # Row 4 alone at this shape.
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    k, s = syn.sample_a.shape
    d = int(q.lo.shape[1])
    W = boot_weights(torch, syn, q.lo.device)
    R = int(W.shape[0])
    ql, qh = q.lo[:US_PLAIN_Q], q.hi[:US_PLAIN_Q]
    err = close(f"table1 US bootstrap_moments Q={US_PLAIN_Q}",
                bootstrap_moments_cuda(*sm, W, ql, qh).cpu(),
                bootstrap_moments_plain(*sm, W, ql, qh).cpu(), K_RTOL,
                K_ATOL)
    step = plain_step(k, s)
    bound = walk_bound(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi, R,
                       step)
    bound1 = walk_bound(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi, 1,
                        step)
    pred = samples_inside(*sm[::2], q.lo, q.hi).permute(1, 0, 2).to(
        torch.float32).contiguous()
    w0 = W[0].contiguous()
    rhs = bmm_rhs(torch, W, syn.sample_a)
    rhs1 = bmm_rhs(torch, w0[None], syn.sample_a)
    err1 = close("table1 US stratified_weighted_moments",
                 stratified_weighted_moments_cuda(*sm, w0, q.lo, q.hi).cpu(),
                 torch.bmm(pred, rhs1).permute(1, 0, 2).cpu(), K_RTOL,
                 K_ATOL)

    def kernel():
        return bootstrap_moments_cuda(*sm, W, q.lo, q.hi)

    def kernel1():
        return stratified_weighted_moments_cuda(*sm, w0, q.lo, q.hi)

    def library():
        return torch.bmm(pred, rhs)

    def library1():
        return torch.bmm(pred, rhs1)

    times = {"bootstrap_moments": cuda_ms(torch, kernel, reps=10, warmup=2),
             "bootstrap_moments_device": weighted_device_ms(torch, kernel),
             f"bootstrap_moments_plain_q{US_PLAIN_Q}": cuda_ms(
                 torch, lambda: bootstrap_moments_plain(*sm, W, ql, qh),
                 reps=2, warmup=1),
             f"bootstrap_moments_q{US_PLAIN_Q}": cuda_ms(
                 torch, lambda: bootstrap_moments_cuda(*sm, W, ql, qh),
                 reps=10, warmup=2),
             "bmm_bootstrap_moments": cuda_ms(torch, library, reps=10,
                                              warmup=2),
             # cuBLAS splits this k = 1 product: a memset and a GEMM a call.
             "bmm_bootstrap_moments_device": call_device_ms(
                 torch, library)["ms"],
             "stratified_weighted_moments": cuda_ms(torch, kernel1, reps=10,
                                                    warmup=2),
             "stratified_weighted_moments_device": weighted_device_ms(
                 torch, kernel1),
             "bmm_stratified_weighted_moments": cuda_ms(torch, library1,
                                                        reps=10, warmup=2),
             "bmm_stratified_weighted_moments_device": call_device_ms(
                 torch, library1)["ms"],
             "answer_fused": cuda_ms(torch, lambda: PassEngine(
                 syn, sv, boot_ci()).answer(q), reps=5, warmup=1),
             "answer_scan": cuda_ms(torch, lambda: PassEngine(
                 syn, sv, boot_ci(boot_fused=False)).answer(q), reps=3,
                 warmup=1)}
    # The device ms a call of each kernel of the two launches.
    by_kernel = {row: {name: v["ms_per_record"] for name, v in
                       device_by_name(torch, fn).items()}
                 for row, fn in (("bootstrap_moments", kernel),
                                 ("stratified_weighted_moments", kernel1))}
    del pred, rhs, rhs1
    torch.cuda.empty_cache()
    turns = weighted_turns(torch, "table1 US", sm, W, q.lo, q.hi, base,
                           reps=5)
    del W
    torch.cuda.empty_cache()
    out = {"launches_fused": launches[True], "launches_scan": launches[False],
           "fused_equals_scan": True, "quality": quality,
           "max_abs_err": err, "max_abs_err_row3": err1, "turns": turns,
           "times_ms": times, "device_ms_by_kernel": by_kernel, "bound": bound, "bound_row3": bound1, "k": k,
           "s": s, "R": R,
           "chunks": -(-s // WEIGHTED_CHUNK),
           "plan_segments_per_tile_and_smem_bytes": weighted_plan(Q, k, s, d)}
    out["seconds"] = time.perf_counter() - t0
    emit(phase="25 table1 US bootstrap", card=card, **out)
    return out


ESS_PLAIN_Q = 8
# Queries on which the ESS shape's torch.bmm yardstick is held to the
# kernel (all 2048 cost seconds of host copies and compares).
ESS_LIB_Q = 256


def ess_bootstrap_kernel(torch, card, syn, q, base=None) -> dict:
    """Row 4 at the PASS-ESS arm's shape (k = 64, s = 19,250: 10 slot
    chunks a stratum, Q = 2048, R = 200, the fused draw of BOOT_KEY) against
    plain on its first ESS_PLAIN_Q queries; timed by events and on the
    device against walk_bound and torch.bmm of a predicate (k, Q, s) built
    beforehand over chunks of PLAIN_ELEMS, TF32 off (checked against the
    kernel first on ESS_LIB_Q queries); with a baseline, rows 3 and 4 in turns with its
    kernels."""
    from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                               bootstrap_moments_plain)
    from repro_torch.kernels.stratified_estimate import samples_inside
    t0 = time.perf_counter()
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    k, s = syn.sample_a.shape
    Q = int(q.lo.shape[0])
    W = boot_weights(torch, syn, q.lo.device)
    R = int(W.shape[0])
    n = ESS_PLAIN_Q
    err = close(f"table1 ESS bootstrap_moments Q={n}",
                bootstrap_moments_cuda(*sm, W, q.lo[:n], q.hi[:n]).cpu(),
                bootstrap_moments_plain(*sm, W, q.lo[:n], q.hi[:n]).cpu(),
                K_RTOL, K_ATOL)
    step = plain_step(k, s)
    bound = walk_bound(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi, R,
                       step)
    pred = torch.empty((k, Q, s), dtype=torch.float32, device=q.lo.device)
    for i in range(0, Q, step):
        pred[:, i:i + step] = samples_inside(
            syn.sample_c, syn.sample_valid, q.lo[i:i + step],
            q.hi[i:i + step]).permute(1, 0, 2)
    rhs = bmm_rhs(torch, W, syn.sample_a)

    def kernel():
        return bootstrap_moments_cuda(*sm, W, q.lo, q.hi)

    def library():
        return torch.bmm(pred, rhs)

    got = kernel()
    n_lib = ESS_LIB_Q
    lib = library().view(k, Q, R, 3)[:, :n_lib].permute(2, 1, 0, 3)
    lib_err = close(f"table1 ESS torch.bmm Q={n_lib}", lib.cpu(),
                    got[:, :n_lib].cpu(), K_RTOL, K_ATOL)
    del got, lib
    torch.cuda.empty_cache()
    times = {"bootstrap_moments": cuda_ms(torch, kernel, reps=10, warmup=2),
             "bootstrap_moments_device": weighted_device_ms(torch, kernel),
             "bmm_bootstrap_moments": cuda_ms(torch, library, reps=3,
                                              warmup=1)}
    lib_dev = call_device_ms(torch, library, reps=3, warmup=0)
    times["bmm_bootstrap_moments_device"] = lib_dev["ms"]
    # The same calls as device_ms reads them, their summed records over 3:
    # lower than the above where the window dropped a call's records.
    window = device_profile(torch, library, reps=3, warmup=0)
    times["bmm_bootstrap_moments_device_one_window"] = window["ms"]
    del pred, rhs
    torch.cuda.empty_cache()
    turns = weighted_turns(torch, "table1 ESS", sm, W, q.lo, q.hi, base,
                           reps=5)
    out = {"k": int(k), "s": int(s), "Q": Q, "R": R, "times_ms": times,
           "bound": bound, "max_abs_err": err, "plain_queries": n,
           "bmm_max_abs_err_vs_kernel": lib_err, "turns": turns,
           "bmm_device_records": lib_dev["records"],
           "bmm_ops_per_call_one_window": window["ops_per_call"]}
    out["seconds"] = time.perf_counter() - t0
    emit(phase="25 table1 ESS bootstrap_moments", card=card, **out)
    return out


def flat_ops_check(torch, syn, q) -> dict:
    """The flat-sample ops on the card: the synopsis's valid samples
    flattened and shuffled (seed 23) with pad rows, through
    stratified_moments_flat (row 2) against the kernel on the synopsis's
    own slots (counts equal, sums within tolerance: the slots hold the
    samples in another order), and weighted_moments_flat (row 3) with
    Poisson(1) weights against its plain version over query chunks."""
    from repro_torch.kernels import native, ops
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, weighted_moments_plain)
    k, s = syn.sample_a.shape
    dev = q.lo.device
    valid = syn.sample_valid.reshape(-1)
    leaf = torch.arange(k, dtype=torch.int32, device=dev).repeat_interleave(
        s)[valid]
    c = syn.sample_c.reshape(k * s, -1)[valid]
    a = syn.sample_a.reshape(-1)[valid]
    rng = np.random.default_rng(23)
    pads = 1000
    perm = torch.from_numpy(rng.permutation(leaf.shape[0] + pads)).to(dev)
    leaf = torch.cat([leaf, torch.full((pads,), -1, dtype=torch.int32,
                                       device=dev)])[perm]
    c = torch.cat([c, torch.zeros((pads, c.shape[1]), device=dev)])[perm]
    a = torch.cat([a, torch.full((pads,), 7.0, device=dev)])[perm]
    w = torch.from_numpy(rng.poisson(1.0, leaf.shape[0]).astype(
        np.float32)).to(dev) * (leaf >= 0)
    torch.cuda.synchronize()
    native.reset_launches()
    got = ops.stratified_moments_flat(c, a, leaf, q.lo, q.hi, k)
    wgot = ops.weighted_moments_flat(c, a, leaf, w, q.lo, q.hi, k)
    torch.cuda.synchronize()
    launches = launches_now(native)
    if launches != {"stratified_moments": 1,
                    "stratified_weighted_moments": 1}:
        raise AssertionError(f"table1 flat ops launched {launches}")
    want = stratified_moments_cuda(syn.sample_c, syn.sample_a,
                                   syn.sample_valid, q.lo, q.hi)
    if not torch.equal(got[..., 0], want[..., 0]):
        raise AssertionError("table1 flat op: counts differ")
    err = max(close(f"table1 flat op [{i}]", got[..., i].cpu(),
                    want[..., i].cpu(), K_RTOL, K_ATOL) for i in (1, 2))
    sc, sa, sv, sw = ops.flat_slots(c, a, leaf, k, w)
    wwant = chunked_plain(
        torch, lambda ql, qh: weighted_moments_plain(sc, sa, sv, sw, ql, qh),
        (), q.lo, q.hi, plain_step(k, sa.shape[1]))
    werr = close("table1 weighted flat op", wgot.cpu(), wwant.cpu(), K_RTOL,
                 K_ATOL)
    emit(check="table1 flat ops", samples=int(valid.sum()), pads=pads,
         launches=launches, max_abs_err=err, weighted_max_abs_err=werr)
    return {"launches": launches, "err": err, "werr": werr}


def table1_path(torch, card, c, a, base=None) -> dict:
    """25. Table 1 at paper size (module doc)."""
    from repro_torch.core.baselines import (aqppp_synopsis,
                                            stratified_synopsis,
                                            uniform_synopsis)
    from repro_torch.core.query import random_queries
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.core.types import QueryBatch
    t_phase = time.perf_counter()
    n = int(a.shape[0])
    K = int(T1_RATE * n)
    B = T1_B
    q = random_queries(c, T1_Q, seed=T1_SEED)
    q_lo, q_hi = q.lo.cpu().numpy(), q.hi.cpu().numpy()
    truth = truth_1d(c, a, q_lo, q_hi)
    builds = {}

    def build(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        builds[name] = time.perf_counter() - t0
        return out[0] if isinstance(out, tuple) else out

    syns = {
        "US": build("US", lambda: uniform_synopsis(c, a, K)),
        "ST": build("ST", lambda: stratified_synopsis(c, a, B, K)),
        "PASS": build("PASS", lambda: build_synopsis(
            c, a, k=B, sample_budget=K, method="adp", kind="sum")),
        "PASS-ESS": build("PASS-ESS", lambda: build_synopsis(
            c, a, k=B, sample_budget=B * K // 2, method="adp", kind="sum")),
        "PASS-BSS2x": build("PASS-BSS2x", lambda: build_synopsis(
            c, a, k=B, sample_budget=2 * K, method="adp", kind="sum")),
        "PASS-BSS10x": build("PASS-BSS10x", lambda: build_synopsis(
            c, a, k=B, sample_budget=10 * K, method="adp", kind="sum")),
    }
    ap = build("AQP++", lambda: aqppp_synopsis(c, a, B, K))
    emit(phase="25 builds", rows=n, K=K, B=B, seconds=builds,
         slots={name: list(x.sample_a.shape) for name, x in syns.items()},
         card=card)
    no_agg = {"use_aggregates": False}
    arms, grid = {}, {}
    for name, syn in syns.items():
        kw = no_agg if name in ("US", "ST") else {}
        arm = table1_arm(torch, name, syn, q, card, **kw)
        grid[name] = {kind: median_rel_err(arm["res"][kind].estimate,
                                           truth[kind]) for kind in T1_KINDS}
        del arm["res"]
        arms[name] = arm
    # AQP++: float64 torch on the card, held against the same structure on
    # the CPU (its first T1_CPU_Q queries) within rtol=1e-6, atol 1e-6 x
    # the field's largest magnitude (float64 sums in another order, one
    # float32 rounding).
    ap_cpu = dataclasses.replace(ap, **{
        f.name: getattr(ap, f.name).cpu() for f in dataclasses.fields(ap)
        if f.name != "n"})
    qc = QueryBatch(q.lo[:T1_CPU_Q].cpu(), q.hi[:T1_CPU_Q].cpu())
    grid["AQP++"] = {}
    for kind in T1_KINDS:
        res = ap.estimate(q, kind)
        cpu = ap_cpu.estimate(qc, kind)
        for field in ("estimate", "ci_half", "lower", "upper",
                      "frac_rows_touched"):
            want = getattr(cpu, field)
            close(f"table1 AQP++ cpu parity {kind}.{field}",
                  getattr(res, field)[:T1_CPU_Q].cpu(), want, 1e-6,
                  1e-6 * float(want.abs().max()))
        grid["AQP++"][kind] = median_rel_err(res.estimate, truth[kind])
    ap_times = {
        "estimate_sum": cuda_ms(torch, lambda: ap.estimate(q, "sum"),
                                reps=10, warmup=2),
        "estimate_sum_device": device_profile(
            torch, lambda: ap.estimate(q, "sum"), reps=5)["ms"],
        "estimate_avg": cuda_ms(torch, lambda: ap.estimate(q, "avg"),
                                reps=5, warmup=1),
        "build_s": builds["AQP++"]}
    e = {name: grid[name]["sum"] for name in grid}
    order = {"PASS < US": e["PASS"] < e["US"],
             "PASS < 1.5 ST": e["PASS"] < 1.5 * e["ST"],
             "ST < US": e["ST"] < e["US"],
             f"AQP++ < {T1_AQPPP_ERR}": e["AQP++"] < T1_AQPPP_ERR}
    emit(phase="25 table1 grid", metric="median relative error",
         queries=T1_Q, seed=T1_SEED, grid=grid, sum_ordering=order,
         card=card)
    if not all(order.values()):
        raise AssertionError(f"table1: SUM ordering fails: {order}, {e}")
    # Kernels against plain and timed at the US (k = 1), ESS (k = 64,
    # s ~ 19,250) and BSS10x (k = 64, s ~ 6,016) shapes; at US and ESS rows
    # 2 and 8 of query subsets against the same rows of the batch.
    from repro_torch.kernels.sample_extremes import sample_extremes_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda)
    shapes = {}
    subsets = (slice(0, 1), slice(0, 16), slice(0, 300), slice(700, 1024))
    for tag, name in (("us", "US"), ("ess", "PASS-ESS"),
                      ("bss10x", "PASS-BSS10x")):
        syn = syns[name]
        errs = serving_vs_plain(torch, f"table1 {tag}", syn, q)
        if tag != "bss10x":
            sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
            for fn in (stratified_moments_cuda, sample_extremes_cuda):
                rows_vs_batch(torch, f"table1 {tag}", fn, sm, q.lo, q.hi,
                              subsets)
            emit(check="table1 rows against the batch", shape=tag,
                 subsets=[[x.start, x.stop] for x in subsets],
                 bit_equal=True)
        shapes[tag] = table1_kernel_times(torch, tag, syn, q, card)
        shapes[tag]["errs"] = errs
    base_differs = (None if base is None
                    else table1_baseline(torch, syns, q, base))
    us_boot = us_bootstrap(torch, card, syns["US"], q, truth, base)
    ess_boot = ess_bootstrap_kernel(torch, card, syns["PASS-ESS"], q, base)
    shims = table1_shims(torch, syns["PASS"], q)
    shims_us = table1_shims(torch, syns["US"], q)
    flat = flat_ops_check(torch, syns["PASS-ESS"], q)
    flat_us = flat_ops_check(torch, syns["US"], q)
    del syns
    torch.cuda.empty_cache()
    out = {"grid": grid, "arms": arms, "aqppp_times_ms": ap_times,
           "builds_s": builds, "shapes": shapes, "shims": shims,
           "shims_us": shims_us, "flat": flat, "flat_us": flat_us,
           "us_bootstrap": us_boot, "ess_bootstrap": ess_boot, "K": K,
           "baseline_differs": base_differs,
           "seconds": time.perf_counter() - t_phase}
    emit(phase="25 table1 times", card=card,
         answer_ms={name: x["times_ms"] for name, x in arms.items()},
         aqppp=ap_times, builds_s=builds, seconds=out["seconds"])
    return out


def fig8_path(torch, card, c, a) -> dict:
    """26. fig 8's 3-D cell at paper size: KD-PASS (kd, proportional
    allocation) against KD-US (aqppp_synopsis(method="kd")) on the same 2 %
    budget; PASS's answer (sum/count/avg, ci=0.95) launches rows 1 and 2,
    holds the truth and the 3-D bar, equals the CPU's on the first queries,
    and its kernels equal their plain versions; ess and skip_rate on the
    card share one query_eval launch."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.baselines import aqppp_synopsis
    from repro_torch.core.estimators import ess, skip_rate
    from repro_torch.core.query import random_queries
    from repro_torch.core.synopsis import build_synopsis
    from repro_torch.kernels import native
    t_phase = time.perf_counter()
    n = int(a.shape[0])
    K = int(F8_RATE * n)
    q = random_queries(c, F8_Q, seed=F8_SEED, min_frac=0.3, max_frac=0.8)
    t0 = time.perf_counter()
    kd, _ = build_synopsis(c, a, k=F8_K, sample_budget=K, kind="sum",
                             method="kd", allocation="proportional")
    kd_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    kdus = aqppp_synopsis(c, a, F8_K, K, method="kd")
    kdus_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    native.reset_launches()
    eng = PassEngine(kd, ServingConfig(kinds=T1_KINDS), ci=0.95)
    res = eng.answer(q)
    torch.cuda.synchronize()
    launches = launches_now(native)
    if launches != {"query_eval": 1, "stratified_moments": 1}:
        raise AssertionError(f"fig8: the answer launched {launches}")
    native.reset_launches()
    e = ess(kd, q)
    sr = skip_rate(kd, q)
    torch.cuda.synchronize()
    tele_launches = launches_now(native)
    if tele_launches != {"query_eval": 1}:
        raise AssertionError(f"fig8: ess and skip_rate launched "
                             f"{tele_launches}")
    q_lo, q_hi = q.lo.cpu().numpy(), q.hi.cpu().numpy()
    truth = truth_scan(torch, c, a, q_lo, q_hi)
    quality = check_truth("fig8 KD-PASS", res, truth, F8_Q, 0.15, T1_KINDS)
    check_cpu_parity(torch, "fig8 KD-PASS", kd, q, res, n=T1_CPU_Q,
                     kinds=T1_KINDS)
    errs = serving_vs_plain(torch, "fig8 KD-PASS", kd, q)
    shape = table1_kernel_times(torch, "fig8", kd, q, card)
    shape["errs"] = errs
    us = kdus.estimate(q, "sum")
    t = truth["sum"]
    keep = np.abs(t) > 1e-9
    ci_ratio = {name: float(np.median(host(r.ci_half).astype(np.float64)[
        keep] / np.abs(t[keep]))) for name, r in (("KD-PASS", res["sum"]),
                                                  ("KD-US", us))}
    out = {"sum_median_rel_err": {
        "KD-PASS": median_rel_err(res["sum"].estimate, t),
        "KD-US": median_rel_err(us.estimate, t)},
        "median_ci_ratio": ci_ratio,
        "skip_rate_median": float(np.median(host(sr))),
        "ess_mean": float(host(e).mean()), "launches": launches,
        "ess_skip_rate_launches": tele_launches, "quality": quality,
        "errs": errs, "shape": shape,
        "build_s": {"KD-PASS": kd_s, "KD-US": kdus_s},
        "answer_ms": cuda_ms(torch, lambda: eng.answer(q), reps=10,
                             warmup=2),
        "kdus_estimate_ms": cuda_ms(torch, lambda: kdus.estimate(q, "sum"),
                                    reps=5, warmup=1),
        "K": K, "slots": list(kd.sample_a.shape),
        "seconds": time.perf_counter() - t_phase}
    emit(phase="26 fig8 3d", card=card, **{key: v for key, v in out.items()
                                           if key not in ("errs", "shape")})
    return out


def legacy_updates(torch, tag, run, c_base, a_base, c_s, a_s, rows, batches,
                   max_median_err, truth_fn) -> dict:
    """UpdatableSynopsis on a main synopsis: ``rows`` stream rows one by
    one (host float64), snapshot() served on the card against the truth
    over base plus those rows, then to_streaming() ingests ``batches``
    STREAM_BATCH-row batches (None: the rest of the stream) with row 5 (and
    row 7 in d > 1) once a batch, served against the truth over base plus
    every ingested row."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.updates import UpdatableSynopsis
    from repro_torch.kernels import native
    d = 1 if c_base.ndim == 1 else c_base.shape[1]
    syn, q = run["syn"], run["q"]
    m = 64
    q_lo, q_hi = q.lo[:m].cpu().numpy(), q.hi[:m].cpu().numpy()
    t0 = time.perf_counter()
    upd = UpdatableSynopsis(syn, seed=0)
    init_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    upd.insert_batch(c_s[:rows], a_s[:rows])
    per_row_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    snap = upd.snapshot()
    torch.cuda.synchronize()
    snapshot_s = time.perf_counter() - t0
    if snap.device != syn.device:
        raise AssertionError(f"legacy {tag}: snapshot on {snap.device}, "
                             f"the synopsis on {syn.device}")
    native.reset_launches()
    res = PassEngine(snap, ServingConfig(kinds=KINDS), ci=0.95).answer(q)
    torch.cuda.synchronize()
    snap_launches = launches_now(native)
    if not {"query_eval", "stratified_moments", "sample_extremes"} <= set(
            snap_launches):
        raise AssertionError(f"legacy {tag}: snapshot answer launched "
                             f"{snap_launches}")
    n_done = rows
    truth = truth_fn([(c_base, a_base), (c_s[:n_done], a_s[:n_done])],
                     q_lo, q_hi)
    q_snap = check_truth(f"legacy {tag} snapshot", res, truth, m,
                         max_median_err)
    torch.cuda.synchronize()
    native.reset_launches()
    t0 = time.perf_counter()
    ing = upd.to_streaming(seed=11)
    n_batches = 0
    stop = c_s.shape[0] if batches is None else min(
        c_s.shape[0], rows + batches * STREAM_BATCH)
    for i in range(rows, stop, STREAM_BATCH):
        ing.ingest(c_s[i:i + STREAM_BATCH], a_s[i:i + STREAM_BATCH])
        n_batches += 1
    torch.cuda.synchronize()
    stream_s = time.perf_counter() - t0
    stream_launches = launches_now(native)
    want = {"segment_reduce": n_batches, "threefry": 2 * n_batches}
    if d > 1:
        want["route_multid"] = n_batches
    if stream_launches != want:
        raise AssertionError(f"legacy {tag}: to_streaming ingest launched "
                             f"{stream_launches}, not {want}")
    res2 = PassEngine(ing, ServingConfig(kinds=KINDS), ci=0.95).answer(q)
    truth2 = truth_fn([(c_base, a_base), (c_s[:stop], a_s[:stop])], q_lo,
                      q_hi)
    q_stream = check_truth(f"legacy {tag} to_streaming", res2, truth2, m,
                           max_median_err)
    out = {"per_row_rows": rows, "per_row_s": per_row_s,
           "per_row_rows_per_s": rows / per_row_s, "init_s": init_s,
           "snapshot_s": snapshot_s, "staleness": upd.staleness(),
           "snapshot_launches": snap_launches, "snapshot_quality": q_snap,
           "stream_batches": n_batches, "stream_rows": stop - rows,
           "stream_ms_per_batch": stream_s / max(n_batches, 1) * 1e3,
           "stream_launches": stream_launches, "stream_quality": q_stream}
    emit(phase=f"27 legacy updates {tag}", **out)
    return out


def delta_codec_check(torch, syn) -> dict:
    """delta_encode / delta_decode of a main synopsis on the card: encoded
    and decoded values and the statistics bit-equal to the port's CPU run;
    each decoded valid value within 2**-23 (|a| + |mean|) of the original
    (one rounding in the subtraction, one in the addition) and invalid
    slots 0.0; the count of values that do not come back bit for bit."""
    from repro_torch.core.synopsis import delta_decode, delta_encode
    enc, stats = delta_encode(syn)
    dec = delta_decode(enc)
    enc_c, stats_c = delta_encode(syn.to("cpu"))
    dec_c = delta_decode(enc_c)
    if stats != stats_c:
        raise AssertionError(f"delta codec: statistics {stats} != CPU's "
                             f"{stats_c}")
    for name, x, y in (("encoded", enc.sample_a, enc_c.sample_a),
                       ("decoded", dec.sample_a, dec_c.sample_a)):
        if not bits_equal(torch, x.cpu(), y):
            raise AssertionError(f"delta codec: {name} values differ from "
                                 "the CPU's bits")
    valid = syn.sample_valid
    a = syn.sample_a.double()
    cnt = syn.leaf_agg[:, 2].double()
    mean = (syn.leaf_agg[:, 0].double() / cnt.clamp(min=1.0))[:, None]
    err = (dec.sample_a.double() - a).abs()
    bound = 2.0 ** -23 * (a.abs() + mean.abs())
    if bool((err > bound)[valid].any()) or bool(
            (dec.sample_a[~valid] != 0).any()):
        raise AssertionError("delta codec: a decoded value lies beyond one "
                             "rounding of each step")
    off = int(((dec.sample_a != syn.sample_a) & valid).sum())
    out = {"stats": stats, "valid_slots": int(valid.sum()),
           "not_bit_exact": off,
           "max_abs_err": float(err[valid].max()) if off else 0.0}
    emit(check="27 delta codec", card_equals_cpu_bits=True, **out)
    return out


def examples_path(torch, card) -> dict:
    """28. The four examples/torch_*.py main()s once each, at their own
    scales, on the card: each launches rows 1 and 2, prints every number
    beside the card's name and power limit, and its summary holds what the
    example shows."""
    import importlib.util

    from repro_torch.kernels import native
    out = {}
    for name in EXAMPLES:
        spec = importlib.util.spec_from_file_location(
            name, ROOT / "examples" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        argv = (["--out", str(ROOT / "build" / "chip_smoke_serve")]
                if name == "torch_serve_service" else [])
        torch.cuda.synchronize()
        native.reset_launches()
        t0 = time.perf_counter()
        summary = mod.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = launches_now(native)
        if not {"query_eval", "stratified_moments"} <= set(launches):
            raise AssertionError(f"{name}: launched {launches}")
        if summary["device"] != card:
            raise AssertionError(f"{name}: device {summary['device']!r}, "
                                 f"not {card!r}")
        out[name] = {"seconds": seconds, "launches": launches}
        if name == "torch_quickstart":
            out[name]["median_rel_err"] = summary["median_rel_err"]
            if min(summary["containment"].values()) < 0.99:
                raise AssertionError(f"{name}: hard-bound containment "
                                     f"{summary['containment']}")
        elif name == "torch_aqp_service":
            out[name].update({k: summary[k] for k in (
                "median_latency_ms", "median_rel_err", "mean_ess",
                "mean_skip_rate")})
            if summary["median_rel_err"]["sum"] > 0.15:
                raise AssertionError(f"{name}: {summary}")
        elif name == "torch_serve_service":
            co = summary["coalescer"]
            out[name].update({k: co[k] for k in ("served", "shed",
                                                  "dispatches", "ticks")})
            if co["served"] < 1 or co.get("failed", 0):
                raise AssertionError(f"{name}: {co}")
        else:
            stream = summary["stream"]
            out[name]["stream"] = stream
            if not (stream["re-optimized (dp_monotone_device)"][1]
                    < stream["frozen base (stale)"][1]):
                raise AssertionError(f"{name}: re-optimization did not "
                                     f"help the drift queries: {stream}")
    emit(phase="28 examples", card=card, **out)
    return out


def table1_phases(torch, nyc_taxi, card, run1, run3, c1, a1, c3, a3,
                  base=None) -> dict:
    """Phases 25-28 (module doc)."""
    t1 = table1_path(torch, card, c1, a1, base)
    f8 = fig8_path(torch, card, c3, a3)
    cs1, as1 = nyc_taxi(scale=0.1, seed=7)
    leg1 = legacy_updates(torch, "1d", run1, c1, a1, cs1, as1, LEGACY_ROWS,
                          None, 0.05, truth_union)
    del cs1, as1
    cs3, as3 = nyc_taxi(scale=0.1, seed=7, dims=3)

    def truth3(parts, q_lo, q_hi):
        return truth_scan(torch, np.concatenate([p[0] for p in parts]),
                          np.concatenate([p[1] for p in parts]), q_lo, q_hi)

    leg3 = legacy_updates(torch, "3d", run3, c3, a3, cs3, as3,
                          LEGACY_ROWS_3D, LEGACY_BATCHES_3D, 0.15, truth3)
    del cs3, as3
    codec = delta_codec_check(torch, run1["syn"])
    ex = examples_path(torch, card)
    return {"table1": t1, "fig8": f8, "legacy_1d": leg1, "legacy_3d": leg3,
            "codec": codec, "examples": ex}


def table1_rows(rows, tab1) -> None:
    """Phases 25-28's launches (each read right after its own window) and
    rows 1, 2 and 8's numbers at the US (k = 1) and ESS (k = 64) shapes
    into the kernels line's rows."""
    tab, f8 = tab1["table1"], tab1["fig8"]
    legs = {"1d": tab1["legacy_1d"], "3d": tab1["legacy_3d"]}
    for row in rows:
        name = row["name"]
        extra = {}
        if name in ("query_eval", "stratified_moments", "sample_extremes"):
            extra["launches_table1_answer"] = {
                arm: x["launches"].get(name, 0)
                for arm, x in tab["arms"].items()}
            extra["launches_table1_shim"] = {
                arm: x["shim_launches"].get(name, 0)
                for arm, x in tab["arms"].items()}
            extra["launches_legacy_snapshot_answer"] = {
                tag: x["snapshot_launches"].get(name, 0)
                for tag, x in legs.items()}
            if name != "sample_extremes":
                extra["launches_fig8_answer"] = f8["launches"].get(name, 0)
            shapes = {**tab["shapes"], "fig8": f8["shape"]}
            for tag, x in shapes.items():
                tm, bd = x["times"], x["bounds"][name]
                extra.update({
                    f"ms_{tag}": tm[name],
                    f"device_ms_{tag}": tm[f"{name}_device"],
                    f"plain_ms_{tag}": tm[f"{name}_plain"],
                    f"plain_device_ms_{tag}": tm[f"{name}_plain_device"],
                    f"bound_ms_{tag}": bd["bound_ms"],
                    f"bound_by_{tag}": bd["bound_by"]})
                row["max_abs_err"] = max(row["max_abs_err"],
                                         x["errs"][name])
            extra["table1_shapes"] = {
                tag: {"Q": x["Q"], "k": x["k"], "s": x["s"],
                      "classes": x["classes"]}
                for tag, x in shapes.items()}
        if name == "query_eval":
            extra["launches_ess_skip_rate"] = f8["ess_skip_rate_launches"][
                name]
        if name == "stratified_moments":
            for tag, x in {**tab["shapes"], "fig8": f8["shape"]}.items():
                extra[f"library_ms_{tag}"] = x["times"][
                    "bmm_stratified_moments"]
                extra[f"library_device_ms_{tag}"] = x["times"][
                    "bmm_stratified_moments_device"]
            extra["baseline_differing_table1"] = tab["baseline_differs"]
            extra["launches_flat_op"] = tab["flat"]["launches"][name]
            row["max_abs_err"] = max(row["max_abs_err"], tab["flat"]["err"])
        us = tab["us_bootstrap"]
        if name == "stratified_weighted_moments":
            extra["launches_flat_op"] = tab["flat"]["launches"][name]
            extra["launches_flat_op_us"] = tab["flat_us"]["launches"][name]
            extra["launches_us_scan_bootstrap_answer"] = us[
                "launches_scan"][name]
            ut = us["times_ms"]
            extra.update({
                "ms_us": ut[name], "device_ms_us": ut[f"{name}_device"],
                "bound_ms_us": us["bound_row3"]["bound_ms"],
                "bound_by_us": us["bound_row3"]["bound_by"],
                "library_ms_us": ut[f"bmm_{name}"],
                "library_device_ms_us": ut[f"bmm_{name}_device"],
                "us_scan_answer_ms": ut["answer_scan"],
                "baseline_turns_us": us["turns"][name]})
            row["max_abs_err"] = max(row["max_abs_err"], tab["flat"]["werr"],
                                     tab["flat_us"]["werr"],
                                     us["max_abs_err_row3"])
        if name == "bootstrap_moments":
            ut = us["times_ms"]
            extra.update({
                "launches_poisson_bootstrap_shim": tab["shims"][
                    "uncertainty.poisson_bootstrap"][name],
                "launches_poisson_bootstrap_shim_us": tab["shims_us"][
                    "uncertainty.poisson_bootstrap"][name],
                "launches_us_fused_bootstrap_answer": us["launches_fused"][
                    name],
                "us_shape": {"Q": T1_Q, "k": us["k"], "s": us["s"],
                             "R": us["R"], "chunks": us["chunks"]},
                "ms_us": ut["bootstrap_moments"],
                "device_ms_us": ut["bootstrap_moments_device"],
                "bound_ms_us": us["bound"]["bound_ms"],
                "bound_by_us": us["bound"]["bound_by"],
                f"plain_ms_us_q{US_PLAIN_Q}": ut[
                    f"bootstrap_moments_plain_q{US_PLAIN_Q}"],
                f"ms_us_q{US_PLAIN_Q}": ut[f"bootstrap_moments_q{US_PLAIN_Q}"],
                "library_ms_us": ut["bmm_bootstrap_moments"],
                "library_device_ms_us": ut["bmm_bootstrap_moments_device"],
                "us_fused_answer_ms": ut["answer_fused"],
                "baseline_turns_us": us["turns"][name]})
            ess = tab["ess_bootstrap"]
            et = ess["times_ms"]
            extra.update({
                "ess_shape": {"Q": ess["Q"], "k": ess["k"], "s": ess["s"],
                              "R": ess["R"]},
                "ms_ess": et[name], "device_ms_ess": et[f"{name}_device"],
                "bound_ms_ess": ess["bound"]["bound_ms"],
                "bound_by_ess": ess["bound"]["bound_by"],
                "library_ms_ess": et[f"bmm_{name}"],
                "library_device_ms_ess": et[f"bmm_{name}_device"],
                "baseline_turns_ess": ess["turns"][name]})
            row["max_abs_err"] = max(row["max_abs_err"], us["max_abs_err"],
                                     ess["max_abs_err"])
        if name in ("segment_reduce", "route_multid"):
            for tag, x in legs.items():
                if name in x["stream_launches"]:
                    extra[f"launches_legacy_to_streaming_{tag}"] = x[
                        "stream_launches"][name]
        row.update(extra)


def table1_summary(tab1) -> dict:
    """Phases 25-28's numbers: the Table 1 grid, each arm's answer time,
    AQP++'s, fig 8's cell, the legacy path, the delta codec, the examples."""
    tab = tab1["table1"]
    return {
        "table1_grid": tab["grid"], "K": tab["K"],
        "answer_ms": {arm: x["times_ms"] for arm, x in tab["arms"].items()},
        "slots": {arm: [x["k"], x["s"], x["samples"]]
                  for arm, x in tab["arms"].items()},
        "aqppp_ms": tab["aqppp_times_ms"], "builds_s": tab["builds_s"],
        "rows_2_8_at": {tag: {"times_ms": x["times"], "bounds": x["bounds"],
                              "classes": x["classes"], "k": x["k"],
                              "s": x["s"], "Q": x["Q"]}
                        for tag, x in {**tab["shapes"],
                                       "fig8": tab1["fig8"]["shape"]}.items()},
        "row2_baseline_differing": tab["baseline_differs"],
        "fig8": {k: tab1["fig8"][k] for k in (
            "sum_median_rel_err", "median_ci_ratio", "skip_rate_median",
            "ess_mean", "answer_ms", "kdus_estimate_ms", "build_s")},
        "legacy": {tag: {k: tab1[f"legacy_{tag}"][k] for k in (
            "per_row_rows", "per_row_rows_per_s", "snapshot_s",
            "stream_batches", "stream_ms_per_batch")} for tag in ("1d", "3d")},
        "delta_codec": tab1["codec"],
        "examples_s": {k: x["seconds"] for k, x in tab1["examples"].items()},
        "seconds": {"25": tab["seconds"], "26": tab1["fig8"]["seconds"]}}


def host_of(res) -> dict:
    """A result dict on the host, one copy (the coalescer's demux pull)."""
    from repro_torch.serve.coalescer import host_results
    return host_results(res)


def pair_baseline_fields(t1, t3, name) -> dict:
    """Row 2's or row 8's times in turns with the baseline's at the 1-D and
    3-D serving shapes (null without --baseline)."""
    out = {}
    for tag, t in (("", t1), ("_3d", t3)):
        tm = t["times"]
        out.update({
            f"ms_in_turns{tag}": tm.get(f"{name}_in_turns"),
            f"device_ms_in_turns{tag}": tm.get(f"{name}_device_in_turns"),
            f"baseline_ms{tag}": tm.get(f"{name}_baseline"),
            f"baseline_device_ms{tag}": tm.get(f"{name}_baseline_device")})
    return out


# ---------------------------------------------------------------------------
# Row 10: the threefry draws (csrc/threefry.cu) against their plain version
# ---------------------------------------------------------------------------

# 64 INT32 lanes an SM x 132 SMs x 1.98 GHz (H100 SXM boost clock): the
# card's int32 operation rate, the threefry kernel's bound.
PEAK_INT32_OPS_S = 64 * 132 * 1.98e9
THREEFRY_KEYS = ((0, 0), (0, 5), (0, 2 ** 31), (0x9E3779B9, 0xF00DBEEF),
                 (2 ** 32 - 1, 2 ** 32 - 1))
THREEFRY_N = (1, 2, 31, 32, 33, 65_537)
# (R, k, s, r0, empty strata): R = 1 is the scan's draw, r0 near 2**32
# wraps the replicate index.
POISSON_CASES = ((1, 1, 1, 0, ()), (1, 7, 33, 199, (3,)),
                 (200, 5, 75, 0, (0, 4)), (3, 37, 31, 2 ** 32 - 2, (36,)),
                 (2, 3, 4103, 70_001, (1,)), (200, 1, 1, 0, ()))


# Row 10's kernels as the profiler names them (csrc/threefry.cu).
THREEFRY_KERNEL_RE = re.compile(
    r"(^|::|\s)(fold_in|uniform|poisson_weights)_kernel\(")


def row10_device_us(prof) -> tuple[float, int]:
    """(summed device us, count) of row 10's kernels in a profiler
    window."""
    ev = [e for e in prof.events()
          if str(getattr(e, "device_type", "")).endswith("CUDA")
          and THREEFRY_KERNEL_RE.search(e.name)]
    return (sum(e.device_time if hasattr(e, "device_time") else e.cuda_time
                for e in ev), len(ev))


def int32_bound(nbytes, ops) -> dict:
    """max(bytes / 3.35 TB/s, int32 operations / 16.7 T/s) in ms."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / PEAK_INT32_OPS_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "operations": ops}


def one_launch(torch, tag, fn):
    """``fn()``'s result, holding that it launched row 10 exactly once and
    nothing else."""
    from repro_torch.kernels import native
    native.reset_launches()
    out = fn()
    if launches_now(native) != {"threefry": 1}:
        raise AssertionError(f"{tag}: launched {launches_now(native)}, not "
                             f"row 10 once")
    return out


def threefry_same(torch, tag, got, want) -> None:
    """Row 10 against its plain version, bit for bit (int64 key words, or
    float32 uniforms and weights as int32 views)."""
    if got.dtype == torch.float32:
        same = bits_equal(torch, got, want)
    else:
        same = got.shape == want.shape and torch.equal(got, want)
    if not same:
        n = (int((got != want).sum()) if got.shape == want.shape
             else "shape")
        raise AssertionError(f"row 10 {tag}: {n} values differ from plain "
                             f"({tuple(got.shape)} vs {tuple(want.shape)})")


def edge_cases_threefry(torch, dev) -> int:
    """Row 10 bit-equal to its plain version at edge shapes: split and
    uniform of n = 1, 2, 31, 32, 33 and 65,537 counters, uniform of 2-D
    shapes and of key batches (a row view of a batch at an offset
    included), uniform_scalar, fold_in of int32 (negative, -2**31) and
    int64 data (>= 2**31, >= 2**32, negative) and of Python ints, under
    keys whose words are 0 or >= 2**31; the Poisson weights at R = 1 and
    200, ragged k x s, strata with no valid slot and replicate indices that
    wrap past 2**32. Each call one launch. Returns the cases checked."""
    from repro_torch import random as trandom
    from repro_torch.uncertainty import bootstrap as tboot
    rng = np.random.default_rng(10)
    cases = 0
    for words in THREEFRY_KEYS:
        key = torch.tensor(words, dtype=torch.int64, device=dev)
        tag = f"key {words}"
        for n in THREEFRY_N:
            threefry_same(torch, f"{tag} split {n}", one_launch(
                torch, "split", lambda: trandom.split(key, n)),
                trandom.split_plain(key, n))
            threefry_same(torch, f"{tag} uniform {n}", one_launch(
                torch, "uniform", lambda: trandom.uniform(key, (n,))),
                trandom.uniform_plain(key, (n,)))
            cases += 2
        batch = trandom.split(key, 7)
        for name, keys, shape in (("2-D", key, (3, 5)),
                                  ("batch", batch, (33,)),
                                  ("row view", batch[3], (65,)),
                                  ("batch slice", batch[1:], (31, 2))):
            threefry_same(torch, f"{tag} uniform {name}", one_launch(
                torch, "uniform", lambda: trandom.uniform(keys, shape)),
                trandom.uniform_plain(keys, shape))
            cases += 1
        threefry_same(torch, f"{tag} uniform_scalar", one_launch(
            torch, "uniform_scalar", lambda: trandom.uniform_scalar(batch)),
            trandom.uniform_scalar_plain(batch))
        for data in (torch.tensor([-1, -2 ** 31, 0, 7, 2 ** 31 - 1],
                                  dtype=torch.int32, device=dev),
                     torch.tensor([2 ** 31, 2 ** 32 - 1, 2 ** 32 + 3, -5, 0],
                                  dtype=torch.int64, device=dev),
                     torch.from_numpy(rng.integers(
                         -2 ** 31, 2 ** 31, (33, 3)).astype(np.int32)
                     ).to(dev), -3, 0, 2 ** 31 + 7, 2 ** 32 - 1):
            threefry_same(torch, f"{tag} fold_in {data}", one_launch(
                torch, "fold_in", lambda: trandom.fold_in(key, data)),
                trandom.fold_in_plain(key, data))
            cases += 1
        cases += 1
    for R, k, s, r0, empty in POISSON_CASES:
        for words in THREEFRY_KEYS[1:4]:
            key = torch.tensor(words, dtype=torch.int64, device=dev)
            valid = rng.random((k, s)) < 0.8
            valid[list(empty)] = False
            valid = torch.from_numpy(valid).to(dev)
            W, ks = one_launch(torch, "poisson_weights",
                               lambda: tboot.poisson_weights(key, valid, R,
                                                             r0))
            W0, ks0 = tboot.poisson_weights_plain(key, valid, R, r0)
            tag = f"poisson {(R, k, s, r0)} key {words}"
            threefry_same(torch, f"{tag} W", W, W0)
            threefry_same(torch, f"{tag} K*", ks, ks0)
            if empty and bool(ks[:, list(empty)].any()):
                raise AssertionError(f"{tag}: an empty stratum drew weight")
            cases += 1
    torch.cuda.synchronize()
    emit(check="row 10 edge cases", cases=cases, bit_equal=True)
    return cases


def threefry_times(torch, tag, fn, plain, nbytes, ops, n_out,
                   one_op=True) -> dict:
    """One main-path shape of row 10: the kernel bit-equal to plain, by
    events and on the device (one device operation a call, unless not
    ``one_op``) against its bound, the plain version, and torch.rand of
    the output's size as a yardstick (Philox: not these bits, never called
    by the port)."""
    got, want = fn(), plain()
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        threefry_same(torch, tag, g, w)
    del got, want
    dev = torch.device("cuda")
    reps = 30 if n_out < 1 << 22 else 10
    out = {"ms": cuda_ms(torch, fn, reps=reps),
           "device_ms": device_ms(torch, fn, one_op=one_op),
           "enqueue_host_ms": enqueue_ms(torch, fn),
           "plain_ms": cuda_ms(torch, plain, reps=5, warmup=1),
           "plain_device_ms": device_ms(torch, plain, reps=3, warmup=1),
           "torch_rand_ms": cuda_ms(torch, lambda: torch.rand(
               n_out, device=dev), reps=reps),
           **int32_bound(nbytes, ops)}
    emit(row10=tag, **out)
    return out


def threefry_main_shapes(torch, run, card) -> dict:
    """Row 10 at the main path's shapes: the fused bootstrap draw (R = 200
    on phase 4's k = 1024, s = 75 slots, key 5), the ingest's split and
    its uniforms over a 4096- and a 65,536-row batch (key 11, as
    StreamingIngestor draws them), and split(key, 5) (the sharded
    ingest's at D = 4). The join build's key_uniforms over the 7.7 M fact
    keys is checked in phase 19."""
    from repro_torch import random as trandom
    from repro_torch.kernels.threefry import (COUNT_OPS, HASH_OPS, KEY_OPS,
                                              UNIFORM_OPS)
    from repro_torch.uncertainty import bootstrap as tboot
    dev = torch.device("cuda")
    valid = run["syn"].sample_valid
    k, s = valid.shape
    key = tboot.key_tensor(BOOT_KEY, dev)
    nv = int(valid.sum())
    out = {"fused_draw": threefry_times(
        torch, "fused draw (200, 1024, 75)",
        lambda: tboot.poisson_weights(key, valid, N_BOOT),
        lambda: tboot.poisson_weights_plain(key, valid, N_BOOT),
        4 * N_BOOT * k * s + 4 * N_BOOT * k + k * s + 16 + 64,
        # a valid slot's hash, uniform, count and K* add; a replicate's
        # fold_in and its key; the root key once
        (HASH_OPS + UNIFORM_OPS + COUNT_OPS + 1) * N_BOOT * nv
        + (HASH_OPS + KEY_OPS) * N_BOOT + KEY_OPS, N_BOOT * k * s)}
    out["fused_draw"].update(R=N_BOOT, k=k, s=s, valid_slots=nv)
    ikey = trandom.PRNGKey(11, dev)
    sub = trandom.split(ikey)[1]
    for n in (STREAM_BATCH, SHARD_BATCH_ROWS):
        out[f"uniform_{n}"] = threefry_times(
            torch, f"ingest uniform {n}", lambda: trandom.uniform(sub, (n,)),
            lambda: trandom.uniform_plain(sub, (n,)), 16 + 4 * n,
            (HASH_OPS + UNIFORM_OPS) * n + KEY_OPS, n)
    for num in (2, 5):
        out[f"split_{num}"] = threefry_times(
            torch, f"split {num}", lambda: trandom.split(ikey, num),
            lambda: trandom.split_plain(ikey, num), 16 + 16 * num,
            HASH_OPS * num + KEY_OPS, 2 * num)
    emit(row10_main_shapes=sorted(out), card=card)
    return out


def threefry_row(tf, edge_cases, b1, b3, s1, s3, j1, j3, coal, ckpt,
                 sharded_stream, sharded_build) -> dict:
    """Row 10 of the kernels line: the fused bootstrap draw's shape and
    launches (one a fused answer), the other main-path shapes and the
    launches of each path beside them."""
    fd = tf["fused_draw"]
    row = {
        "name": "threefry", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threefry.cu",
        "replaces": "src/repro/uncertainty/bootstrap.py:67",
        "pallas_call": None,
        "replaces_note": "no pallas_call: jax.random's threefry2x32, from "
                         "uncertainty/bootstrap.py:67-74, streaming/"
                         "ingest.py:302,386, sharded/ingest.py:113,150,253, "
                         "streaming/join_ingest.py:149,253, "
                         "joins/universe.py:37",
        "launches": b1["launches"]["threefry"],
        "launches_path": "1d fused bootstrap answer (the default)",
        "launches_3d": b3["launches"]["threefry"],
        "launches_scan_answer": b1["scan_launches"]["threefry"],
        "launches_stream_1d": s1["launches"]["threefry"],
        "launches_stream_3d": s3["launches"]["threefry"],
        "launches_join_stream": j1["stream"]["launches"]["threefry"],
        "launches_join_stream_3d": j3["stream"]["launches"]["threefry"],
        "launches_sharded_stream_1d": sharded_stream,
        "launches_sharded_build_1d": sharded_build,
        "launches_coalesced_bootstrap_tick": coal["bootstrap_launches"][
            "threefry"],
        "launches_restored_stream": ckpt["restored_launches"]["threefry"],
        "max_abs_err": 0.0, "bit_equal_to_plain": True,
        "edge_cases": edge_cases,
        "library_ms": None, "library_device_ms": None,
        "library": "none: torch's generators are Philox, no PyTorch call "
                   "computes threefry's bits",
        **{k: fd[k] for k in ("ms", "device_ms", "enqueue_host_ms",
                              "plain_ms", "plain_device_ms", "bound_ms",
                              "bound_by", "torch_rand_ms")}}
    shapes = dict(tf)
    shapes["join_key_uniforms"] = j1["row10_key_uniforms"]
    for tag, x in shapes.items():
        if tag == "fused_draw":
            continue
        for k in ("ms", "device_ms", "plain_ms", "plain_device_ms",
                  "bound_ms", "torch_rand_ms"):
            row[f"{k}_{tag}"] = x[k]
    return row


def join_key_uniforms(torch, keys, seed) -> dict:
    """Row 10 at the join build's shape: ``key_uniforms`` of the build's
    root key over every fact key (two launches: fold_in, uniform_scalar),
    bit-equal to the plain version, timed against the bound of its 4
    bytes in and out a key."""
    from repro_torch import random as trandom
    from repro_torch.joins.universe import key_uniforms
    from repro_torch.kernels import native
    from repro_torch.kernels.threefry import HASH_OPS, KEY_OPS, UNIFORM_OPS
    dev = torch.device("cuda")
    root = trandom.PRNGKey(seed, dev)
    kv = torch.from_numpy(keys).to(dev)
    native.reset_launches()
    key_uniforms(root, kv)
    if launches_now(native) != {"threefry": 2}:
        raise AssertionError(f"key_uniforms launched {launches_now(native)}")
    n = kv.numel()
    return threefry_times(
        torch, f"join key_uniforms {n}", lambda: key_uniforms(root, kv),
        lambda: trandom.uniform_scalar_plain(trandom.fold_in_plain(root,
                                                                   kv)),
        # fold_in: a hash a key under the root key; uniform_scalar: each
        # new key prepared and its counter (0, 0) hashed (its add into x1
        # is free), then the uniform
        8 * n + 16, HASH_OPS * n + KEY_OPS
        + (KEY_OPS + HASH_OPS - 1 + UNIFORM_OPS) * n, n, one_op=False)


# ---------------------------------------------------------------------------
# Any d: rows 1-4, 7, 8 and 9 above 16 predicate columns
# ---------------------------------------------------------------------------

# Phase 29's widths: the most columns the d <= 16 instantiations take, one
# past it, either side of two blocks of 16 and on it, and two far ones.
WIDE_DS = (16, 17, 31, 32, 33, 64, 300)
WIDE_BASE_D = 16
# The extra columns of the bit identity: query bounds -+WIDE_BIG there and
# finite data, so that the widened input selects what its first 16 columns
# select; for row 7 every row lies inside every box there (each term +0.0).
WIDE_BIG = np.float32(3.4e38)


def widen_queries(q_lo, q_hi, extra, at=None):
    """(Q, d) bounds with ``extra`` columns of -+WIDE_BIG inserted before
    column ``at`` (appended by default)."""
    at = q_lo.shape[1] if at is None else at
    lo = np.full((q_lo.shape[0], extra), -WIDE_BIG, np.float32)
    return (np.concatenate([q_lo[:, :at], lo, q_lo[:, at:]], 1),
            np.concatenate([q_hi[:, :at], -lo, q_hi[:, at:]], 1))


def widen_cols(rng, x, extra, lo=0.05, hi=0.95):
    """x (..., d) with ``extra`` more columns of finite uniform data."""
    add = rng.uniform(lo, hi, x.shape[:-1] + (extra,)).astype(np.float32)
    return np.concatenate([x, add], -1)


def wide_bounded(rng, Q, d, lo, hi, first=1, fixed=3, span=(2, 5)):
    """(Q, d) bounds at (lo, hi) in every column, then 2-4 (``span``: a
    range) columns from ``first`` on of each query after the first
    ``fixed`` bounded to a random interval of (0, 1): the rule of the wide
    tables' queries."""
    q_lo = np.full((Q, d), lo, np.float32)
    q_hi = np.full((Q, d), hi, np.float32)
    for i in range(fixed, Q):
        n = min(d - first, int(rng.integers(*span)))
        if n < 1:
            continue
        cols = first + rng.choice(d - first, n, replace=False)
        q_lo[i, cols] = rng.uniform(0.0, 0.5, n)
        q_hi[i, cols] = q_lo[i, cols] + rng.uniform(0.3, 0.7, n)
    return q_lo, q_hi


def wide_query_eval_case(rng, Q, k, d, A):
    """Row 1 at any d: leaf boxes in (-1, 1.5), leaf k // 2 inverted and
    leaf 1 NaN in the last column; query 0 unbounded, query 1 apart from
    every leaf in the last column only, query 2 a NaN bound there; the
    rest bound 2-4 columns (wide_bounded)."""
    lo = rng.uniform(-1, 0.5, (k, d)).astype(np.float32)
    hi = (lo + rng.uniform(0, 1, (k, d))).astype(np.float32)
    if k > 2:
        lo[k // 2, d - 1], hi[k // 2, d - 1] = 1.0, 0.0
        lo[1, d - 1] = np.nan
    agg = rng.normal(0, 1, (k, A)).astype(np.float32)
    q_lo, q_hi = wide_bounded(rng, Q, d, -2.0, 2.0, first=0, fixed=1)
    q_lo = np.where(q_lo > -2.0, q_lo - 1.0, q_lo).astype(np.float32)
    if Q > 2:
        q_lo[1, d - 1], q_hi[1, d - 1] = 5.0, 6.0
        q_lo[2, d - 1] = np.nan
    return lo, hi, agg, q_lo, q_hi


def wide_pair_case(rng, Q, k, s, d, nan=False, special=False,
                   chunk=2048, many=False):
    """Rows 2-4 and 8 at any d: stratum i's samples in band i of column 0
    (chunk j of its slots in the j-th part of the band), the other columns
    uniform in (0.05, 0.95); ragged validity, stratum k // 2 without a
    valid slot (k > 2). Query 0 holds everything, 1 misses everything, 2
    is inverted; the others cut column 0 at band edges and bound 2-4 other
    columns (wide_bounded), so that covered, empty and mixed pairs occur.
    ``nan``: NaN coordinates on valid slots, in the last column of stratum
    k - 1's last chunk and in column 17 % d of stratum 1's first 40 slots;
    ``special``: NaN, +-inf, +-F32_MAX and +-0.0 values (row 8); ``many``:
    the queries bound 5-8 columns, so that most mixed pairs have more cut
    columns than a listed pair keeps (CUT_MAX = 4, csrc/wide_cols.cuh)."""
    n_ch = -(-s // chunk)
    c = rng.uniform(0.05, 0.95, (k, s, d)).astype(np.float32)
    band = (np.arange(s) // chunk)[None, :]
    c[..., 0] = ((np.arange(k)[:, None]
                  + (band + rng.uniform(0.05, 0.95, (k, s))) / n_ch) / k)
    a = rng.normal(0, 3, (k, s)).astype(np.float32)
    valid = rng.random((k, s)) < 0.8
    if k > 2:
        valid[k // 2] = False
    if special:
        w = rng.random((k, s))
        for lo, hi, x in ((0.0, 0.04, np.nan), (0.04, 0.07, np.inf),
                          (0.07, 0.10, -np.inf), (0.10, 0.13, F32_MAX),
                          (0.13, 0.16, -F32_MAX), (0.16, 0.22, -0.0),
                          (0.22, 0.28, 0.0)):
            a[(w >= lo) & (w < hi)] = x
    q_lo, q_hi = wide_bounded(rng, Q, d, -1.0, 2.0,
                              span=(5, 9) if many else (2, 5))
    start = rng.integers(0, k, Q)
    span = rng.integers(1, 3, Q)
    e_lo = rng.integers(0, n_ch + 1, Q) / n_ch
    e_hi = rng.integers(0, n_ch + 1, Q) / n_ch
    q_lo[3:, 0] = ((start + e_lo * 0.9) / k)[3:]
    q_hi[3:, 0] = ((start + span - 1 + 0.05 + e_hi * 0.9) / k)[3:]
    q_lo[1], q_hi[1] = 5.0, 6.0
    if Q > 2:
        q_lo[2], q_hi[2] = 0.6, 0.4
    if nan:
        on = np.flatnonzero(valid[k - 1, (n_ch - 1) * chunk:])
        if on.size:
            c[k - 1, (n_ch - 1) * chunk + on[0], d - 1] = np.nan
        if k > 1:
            c[1, :40, 17 % d] = np.nan
    return c, a, valid, q_lo, q_hi


def wide_weights(rng, R, k, s):
    """Poisson weights with non-integers on every third slot, on invalid
    slots too."""
    W = rng.poisson(1.0, (R, k, s)).astype(np.float32)
    W[:, :, ::3] = rng.uniform(0, 2.5, W[:, :, ::3].shape)
    return W


# Row 9's wide cases (wide_join_case modes): the columns a query bounds.
WIDE_JOIN_SPANS = {"one": (1, 2), "many": (9, 13)}


def wide_join_case(torch, dev, rng, Q, k, su, P, d_f, d_d, nan=False,
                   extra=0, mode="mixed"):
    """Row 9 at D = d_f + d_d columns on join_case's "mixed" distributions
    (``nan``: NaN coordinates on valid slots); query 0 holds every finite
    slot, the others bound 2-4 columns of (-0.5, 1.5)-wide random boxes
    and leave the rest (-10, 10), so that covered, empty and mixed cells
    occur. ``mode``: "one" / "many", each query bounds 1 / 9-12 columns
    (past the wide walk's 8 cut columns); "inf", +inf, -inf and NaN
    values on three valid slots (unbounded cell boxes); "covered", query
    1 unbounded and queries 2-4 three cells' boxes exactly. With
    ``extra``, also the same inputs with that many more fact columns of
    finite data after the first d_f, bounded -+WIDE_BIG. Returns (args,
    widened args or None)."""
    from repro_torch.kernels.join_moments import join_slots
    u_c = rng.normal(size=(k, su, d_f)).astype(np.float32)
    u_d = rng.normal(size=(k, su, d_d)).astype(np.float32)
    u_a = rng.gamma(2.0, 1.0, size=(k, su)).astype(np.float32)
    u_key = rng.integers(0, 3 * su, size=(k, su)).astype(np.int32)
    u_valid = rng.random((k, su)) < 0.7
    if nan:
        u_c[u_valid & (rng.random((k, su)) < 0.2), d_f - 1] = np.nan
        u_d[u_valid & (rng.random((k, su)) < 0.1), -1] = np.nan
    if mode == "inf":
        on = np.argwhere(u_valid)
        for v, (i, j) in zip((np.inf, -np.inf, np.nan),
                             on[rng.choice(len(on), 3, replace=False)]):
            u_a[i, j] = v
    u_part = (u_key % P).astype(np.int32)
    D, kp = d_f + d_d, k * P
    q_lo, q_hi = wide_bounded(rng, Q, D, -10.0, 10.0, first=0, fixed=1,
                              span=WIDE_JOIN_SPANS.get(mode, (2, 5)))
    q_lo = np.where(q_lo > -10.0, q_lo * 4.0 - 2.0, q_lo).astype(np.float32)
    q_hi = np.where(q_hi < 10.0, q_hi * 4.0 - 2.0, q_hi).astype(np.float32)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    rest = (T(rng.random((Q, kp)) < 0.2), T(rng.random((Q, kp)) < 0.3),
            T(rng.normal(size=(kp, 5)).astype(np.float32)),
            torch.tensor(1234.0, device=dev))
    tail = (T(u_a), T(u_key), T(u_part), T(u_valid), P)
    slots = join_slots(T(u_c), T(u_d), *tail)
    if mode == "covered":
        box = slots.cell_box.cpu().numpy()
        q_lo[1], q_hi[1] = -np.inf, np.inf
        finite = np.flatnonzero(np.isfinite(box).all((1, 2)))
        for i, cell in zip(range(2, min(Q, 5)), rng.choice(finite, 3)):
            q_lo[i], q_hi[i] = box[cell, 0], box[cell, 1]
    args = (slots, T(q_lo), T(q_hi), *rest)
    if not extra:
        return args, None
    wq = widen_queries(q_lo, q_hi, extra, at=d_f)
    wide = (join_slots(T(widen_cols(rng, u_c, extra, -3.0, 3.0)), T(u_d),
                       *tail), T(wq[0]), T(wq[1]), *rest)
    return args, wide


def wide_baseline_bits(torch, tag, base, c, a, valid, q_lo, q_hi) -> int:
    """Rows 2 and 8 at d > 16 against a baseline with wide kernels: bit for
    bit (NaN as NaN for row 8) at every s, its fold order being theirs.
    Returns the cases held (0 without such a baseline)."""
    from repro_torch.kernels.sample_extremes import sample_extremes_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda)
    if base is None or not base["stratified_moments"].wide:
        return 0
    sm = (c, a, valid, q_lo, q_hi)
    got = stratified_moments_cuda(*sm)
    ref = baseline_pair(torch, base, "stratified_moments", *sm)
    mn, mx = sample_extremes_cuda(*sm)
    ref8 = baseline_pair(torch, base, "sample_extremes", *sm)
    torch.cuda.synchronize()
    if not bits_equal(torch, got, ref):
        n = int((got.view(torch.int32) != ref.view(torch.int32)).sum())
        raise AssertionError(f"{tag}: stratified_moments differs from the "
                             f"baseline kernel in {n} values")
    for name, g, w in (("min", mn, ref8[0]), ("max", mx, ref8[1])):
        if not same_bits(torch, g, w):
            raise AssertionError(f"{tag}: sample_extremes {name} differs "
                                 "from the baseline kernel")
    return 1


def require_bits(torch, tag, name, got, want) -> None:
    """got bit for bit want (NaN as NaN), or fail naming the count."""
    if not same_bits(torch, got, want):
        n = int((got.view(torch.int32) != want.view(torch.int32)).sum())
        raise AssertionError(f"{tag}: {name} of the widened input differs "
                             f"from the 16-column input's in {n} values")


def wide_identity(torch, dev, d) -> int:
    """The bit identity at d > 16 (module doc, phase 29): each kernel's
    output on a 16-column input, from its d <= 16 instantiation, against
    its output on that input with d - 16 more columns, from the wide one.
    Returns the cases held."""
    from repro_torch.kernels.bootstrap import bootstrap_moments_cuda
    from repro_torch.kernels.join_moments import (PLANES,
                                                  join_cell_moments_cuda)
    from repro_torch.kernels.query_eval import query_eval_cuda
    from repro_torch.kernels.route import route_multid_cuda
    from repro_torch.kernels.sample_extremes import sample_extremes_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_weighted_moments_cuda)
    extra = d - WIDE_BASE_D
    rng = np.random.default_rng(29_500 + d)
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    tag = f"wide identity d={d}"
    cases = 0
    # Row 1, k past one leaf tile.
    lo, hi, agg, q_lo, q_hi = wide_query_eval_case(rng, 37, 1030, 16, 5)
    lo_x = rng.uniform(-1, 0, (lo.shape[0], extra)).astype(np.float32)
    hi_x = (lo_x + rng.uniform(0, 1, lo_x.shape)).astype(np.float32)
    wq = widen_queries(q_lo, q_hi, extra)
    r16 = query_eval_cuda(T(lo), T(hi), T(agg), T(q_lo), T(q_hi))
    rw = query_eval_cuda(T(np.concatenate([lo, lo_x], 1)),
                         T(np.concatenate([hi, hi_x], 1)), T(agg),
                         T(wq[0]), T(wq[1]))
    torch.cuda.synchronize()
    if not torch.equal(r16[0], rw[0]):
        raise AssertionError(f"{tag}: query_eval rel differs")
    require_bits(torch, tag, "query_eval exact", rw[1], r16[1])
    cases += 1
    # Rows 2, 3, 4 and 8: one chunk and above it, NaN coordinates.
    for Q, k, s in ((130, 53, 75), (37, 3, 2500)):
        c, a, valid, q_lo, q_hi = wide_pair_case(rng, Q, k, s, 16, nan=True)
        W = T(wide_weights(rng, 9, k, s))
        sm16 = (T(c), T(a), T(valid))
        smw = (T(widen_cols(rng, c, extra)), sm16[1], sm16[2])
        q16 = (T(q_lo), T(q_hi))
        qw = tuple(T(x) for x in widen_queries(q_lo, q_hi, extra))
        for name, fn in (
                ("stratified_moments", lambda sm, q: (
                    stratified_moments_cuda(*sm, *q),)),
                ("sample_extremes", lambda sm, q: sample_extremes_cuda(
                    *sm, *q)),
                ("stratified_weighted_moments", lambda sm, q: (
                    stratified_weighted_moments_cuda(*sm, W[0], *q),)),
                ("bootstrap_moments", lambda sm, q: (
                    bootstrap_moments_cuda(*sm, W, *q),))):
            for g, w in zip(fn(smw, qw), fn(sm16, q16)):
                require_bits(torch, f"{tag} s={s}", name, g, w)
            cases += 1
    # Row 7: ties, an inverted box; every row inside every box in the
    # extra columns.
    lo, hi, c = route_case(rng, 4096, 1024, 16)
    box_x = np.ones((lo.shape[0], extra), np.float32)
    rows_x = rng.uniform(-0.5, 0.5, (c.shape[0], extra)).astype(np.float32)
    l16, d16 = route_multid_cuda(T(lo), T(hi), T(c))
    lw, dw = route_multid_cuda(T(np.concatenate([lo, -box_x], 1)),
                               T(np.concatenate([hi, box_x], 1)),
                               T(np.concatenate([c, rows_x], 1)))
    torch.cuda.synchronize()
    if not torch.equal(l16, lw):
        raise AssertionError(f"{tag}: route_multid leaf ids differ in "
                             f"{int((l16 != lw).sum())} rows")
    require_bits(torch, tag, "route_multid dist", dw, d16)
    cases += 1
    # Row 9: 15 + extra fact columns and one dimension attribute.
    args, wargs = wide_join_case(torch, dev, rng, 65, 13, 40, 4, 15, 1,
                                 nan=True, extra=extra)
    m16 = join_cell_moments_cuda(*args, 0.3)
    mw = join_cell_moments_cuda(*wargs, 0.3)
    for f in PLANES + ("exact3", "touched"):
        require_bits(torch, tag, f"join_cell_moments {f}", getattr(mw, f),
                     getattr(m16, f))
    cases += 1
    emit(check="wide bit identity", d=d, extra_columns=extra, cases=cases,
         ok=True)
    return cases


def edge_cases_wide(torch, dev, base=None) -> dict:
    """29. Rows 1-4, 7, 8 and 9 at every d of WIDE_DS against their plain
    versions, as phases 3, 7, 11 and 19 hold them: row 1 at k off the
    leaf tile and Q past a block's 8 queries, rel equal and exact within
    tolerance; rows 2 and 8 at one slot chunk (k = 53, s = 75; k = 17 and
    s = 33, a window and a slot) and above it (s = 2500 and 2049), NaN
    coordinates on valid slots, in two of the cases queries that bound
    5-8 columns (pairs past CUT_MAX cut columns), within tolerance and
    bit-equal, rows alone bit-equal to the batch's and, with a baseline
    that has wide kernels, bit-equal to its; rows 3 and 4
    (weighted_chunk_check: fused = scan, rows alone, within tolerance and,
    with such a baseline, its bits) at one chunk with R = 8, 9, 33 and 1
    and above it with R = 3 and 9, NaN coordinates on valid slots, in
    three cases queries that bound 5-8 columns; row 7 with ties, an
    inverted box and B off the row tile, bit-equal; row 9 at D = d (d - 1
    fact columns) at WIDE_JOIN_CASES (NaN coordinates, non-finite values,
    covered cells, queries bounding 1 and 9-12 columns, runs longer than a
    32-slot window, k * P off multiples of 4 and of the 64-cell tile), with
    a baseline that has wide kernels bit-equal to its. Then at each d > 16 the bit
    identity with the 16-column input (wide_identity). Returns the max
    absolute errors and the case counts."""
    from repro_torch.kernels.sample_extremes import sample_extremes_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda)
    t0 = time.perf_counter()
    T = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa
    errs = dict.fromkeys(("query_eval", "stratified_moments",
                          "bootstrap_moments", "join_cell_moments"), 0.0)
    cases = dict.fromkeys(("query_eval", "stratified_moments",
                           "sample_extremes", "bootstrap_moments",
                           "route_multid", "join_cell_moments",
                           "identity", "baseline_bits",
                           "weighted_baseline_bits", "join_baseline_bits",
                           "route_eval_baseline_bits"), 0)
    classes = {}
    for d in WIDE_DS:
        rng = np.random.default_rng(29_000 + d)
        rbase = base if d > WIDE_BASE_D and has_wide(base) else None
        for Q, k in ((9, 53), (37, 1030)):
            e, covered = qe_vs_plain(
                torch, f"wide query_eval d={d} Q={Q} k={k}",
                *(T(x) for x in wide_query_eval_case(rng, Q, k, d, 5)),
                base=rbase)
            errs["query_eval"] = max(errs["query_eval"], e)
            cases["query_eval"] += 1
            cases["route_eval_baseline_bits"] += rbase is not None
        for Q, k, s, many in ((130, 53, 75, False), (40, 17, 33, True),
                              (37, 3, 2500, False), (33, 3, 2049, True)):
            for row in (2, 8):
                t = [T(x) for x in wide_pair_case(
                    rng, Q, k, s, d, nan=True, special=row == 8,
                    many=many)]
                tag = f"wide row {row} d={d} Q={Q} k={k} s={s} many={many}"
                if d > WIDE_BASE_D:
                    cases["baseline_bits"] += wide_baseline_bits(
                        torch, tag, base, *t)
                if row == 2:
                    classes[f"d={d} s={s} many={many}"] = pair_classes(
                        torch, t[0], t[2], t[3], t[4], chunk=32)
                subsets = (slice(0, 1), slice(Q // 3, Q - 1))
                if row == 2:
                    e = moments_vs_plain(torch, tag, *t, None)
                    errs["stratified_moments"] = max(
                        errs["stratified_moments"], e)
                    rows_vs_batch(torch, tag, stratified_moments_cuda,
                                  t[:3], t[3], t[4], subsets)
                    cases["stratified_moments"] += 1
                else:
                    extremes_vs_plain(torch, tag, *t)
                    rows_vs_batch(torch, tag, sample_extremes_cuda, t[:3],
                                  t[3], t[4], subsets)
                    cases["sample_extremes"] += 1
        # R on both sides of WEIGHTED_PAIR_R (8); ``many``: pairs past
        # CUT_MAX cut columns (their tests take every column).
        wbase = base if base is not None and d > WIDE_BASE_D and base[
            "stratified_moments"].wide else None
        for Q, k, s, R, many in ((40, 17, 75, 9, False),
                                 (35, 5, 300, 1, False),
                                 (33, 3, 2049, 3, False),
                                 (40, 17, 75, 8, True), (37, 9, 75, 33, True),
                                 (33, 3, 2049, 9, True)):
            c, a, valid, q_lo, q_hi = wide_pair_case(rng, Q, k, s, d,
                                                     nan=True, many=many)
            e = weighted_chunk_check(
                torch, f"wide rows 3, 4 d={d} Q={Q} k={k} s={s} R={R} "
                f"many={many}",
                *(T(x) for x in (c, a, valid, wide_weights(rng, R, k, s),
                                 q_lo, q_hi)), base=wbase)
            errs["bootstrap_moments"] = max(errs["bootstrap_moments"], e)
            cases["bootstrap_moments"] += 1
            cases["weighted_baseline_bits"] += wbase is not None
        for B, k, case in ((1000, 257, "grid"), (4096, 1024, "grid"),
                           (4096, 1024, "group-ties"),
                           (129, 29, "group-ties")):
            route_vs_plain(torch, f"wide route_multid d={d} B={B} k={k} "
                           f"{case}", *(T(x) for x in route_case(
                               rng, B, k, d, case)), rbase)
            cases["route_multid"] += 1
            cases["route_eval_baseline_bits"] += rbase is not None
        jbase = base if base is not None and d > WIDE_BASE_D and base[
            "join_moments"].wide else None
        for Q, k, su, P, nan, mode in WIDE_JOIN_CASES:
            args, _ = wide_join_case(torch, dev, rng, Q, k, su, P, d - 1, 1,
                                     nan, mode=mode)
            tag = (f"wide join D={d} Q={Q} k={k} su={su} P={P} nan={nan} "
                   f"{mode}")
            e = join_vs_plain(torch, tag, args, 0.3, base=jbase)
            classes[tag] = join_classes(torch, args)
            if d == max(WIDE_DS) and mode in ("mixed", "many"):
                classes[f"{tag} cuts"] = join_cut_histogram(torch, args)
            errs["join_cell_moments"] = max(errs["join_cell_moments"], e)
            cases["join_cell_moments"] += 1
            cases["join_baseline_bits"] += jbase is not None
        if d > WIDE_BASE_D:
            cases["identity"] += wide_identity(torch, dev, d)
        torch.cuda.empty_cache()
    out = {"widths": list(WIDE_DS), "max_abs_err": errs, "cases": cases,
           "classes": classes, "seconds": time.perf_counter() - t0}
    emit(phase="29 wide edge cases", **out)
    return out


# Phase 29's row 9 cases, (Q, k, su, P, nan, mode) of wide_join_case: k * P
# off multiples of 4 (27, 15) and of the 64-cell tile, more than one tile
# (130 cells), NaN coordinates, non-finite values, covered cells, queries
# bounding 1 and 9-12 columns, leaves of 3000 slots (runs of ~600).
WIDE_JOIN_CASES = ((65, 13, 40, 4, False, "mixed"),
                   (40, 9, 30, 3, True, "mixed"),
                   (33, 26, 30, 5, False, "inf"),
                   (40, 10, 30, 13, False, "covered"),
                   (37, 40, 20, 4, False, "one"),
                   (37, 13, 40, 4, False, "many"),
                   (35, 3, 3000, 5, False, "mixed"))


# Phase 30's table: nyc_taxi's five columns at paper size (7.7 M trips) and
# 19 more from a generator seeded with WIDE_SEED (uniform, lognormal and
# integer codes): 24 predicate columns, the value trip distance. Its
# queries bound 2 to 4 columns each (wide_queries).
WIDE_D, WIDE_SEED, WIDE_Q = 24, 24, 2048
# The wide path's bar on the median relative SUM error of its first 64
# queries: about twice the JAX package's own median there, 0.0769, on the
# same table at scale 0.1 with the same 75 slots a stratum and the same
# queries (tools/reference_wide_error.py on the CPU; 0.0701 over 248
# non-empty queries of 256).
WIDE_ERR = 0.15


def wide_columns(n, seed):
    """The wide table's 19 extra columns over n rows: seven uniform, six
    lognormal and six integer codes of 2 to 1000 values."""
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(0.0, 100.0, n) for _ in range(7)]
    cols += [rng.lognormal(1.0, 0.75, n) for _ in range(6)]
    cols += [rng.integers(0, m, n).astype(np.float64)
             for m in (2, 7, 24, 64, 265, 1000)]
    return np.stack(cols, 1)


def wide_table(nyc_taxi, scale, seed=2):
    """(c (n, 24), a (n,)): ``nyc_taxi(scale, seed, dims=5)``'s columns and
    wide_columns(n, WIDE_SEED + seed); ``nyc_taxi`` is the JAX package's or
    the port's (the same generator)."""
    c5, a = nyc_taxi(scale=scale, seed=seed, dims=5)
    return (np.concatenate([c5, wide_columns(a.shape[0], WIDE_SEED + seed)],
                           1), a)


def wide_queries(c, num, seed, sort=np.sort):
    """num rectangles over c (n, d): each bounds 2-4 columns chosen from
    the seed, by random_queries' rule on each (endpoints anchored on the
    column's sorted float32 values, a width of 0.5-30 % of the rows), and
    holds every other column at its float32 [min, max]. random_queries
    over all 24 columns would select nothing. ``sort`` sorts a float32
    column (any exact sort gives the same values). Returns float32 (q_lo,
    q_hi)."""
    rng = np.random.default_rng(seed)
    n, d = c.shape
    bound = np.zeros((num, d), bool)
    for i in range(num):
        bound[i, rng.choice(d, int(rng.integers(2, 5)), replace=False)] = True
    q_lo = np.empty((num, d), np.float32)
    q_hi = np.empty((num, d), np.float32)
    for j in range(d):
        vals = sort(c[:, j].astype(np.float32))
        q_lo[:, j], q_hi[:, j] = vals[0], vals[-1]
        qs = np.flatnonzero(bound[:, j])
        width = rng.uniform(0.005, 0.3, qs.size)
        start = rng.uniform(0, 1 - width)
        lo_idx = (start * (n - 1)).astype(np.int64)
        hi_idx = np.minimum(((start + width) * (n - 1)).astype(np.int64),
                            n - 1)
        q_lo[qs, j], q_hi[qs, j] = vals[lo_idx], vals[hi_idx]
    return q_lo, q_hi


def pair_turns(torch, tag, sm, base, times) -> None:
    """Rows 2 and 8 in turns with a baseline's (kernel, baseline,
    baseline, kernel), by events and on the device, after holding each to
    the baseline's bits (wide_baseline_bits): <row>_in_turns,
    <row>_device_in_turns, <row>_baseline and <row>_baseline_device into
    ``times``."""
    from repro_torch.kernels.sample_extremes import sample_extremes_cuda
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda)
    wide_baseline_bits(torch, tag, base, *sm)
    for name, fn in (("stratified_moments", stratified_moments_cuda),
                     ("sample_extremes", sample_extremes_cuda)):
        def new(fn=fn):
            return fn(*sm)

        def old(name=name):
            return baseline_pair(torch, base, name, *sm)
        ev, dev_ms, b_ev, b_dev = [], [], [], []
        for run, evs, devs in ((new, ev, dev_ms), (old, b_ev, b_dev),
                               (old, b_ev, b_dev), (new, ev, dev_ms)):
            evs.append(cuda_ms(torch, run, reps=10))
            devs.append(device_ms(torch, run, reps=10, one_op=True,
                                  tries=PROFILE_TRIES))
        times[f"{name}_in_turns"] = statistics.mean(ev)
        times[f"{name}_device_in_turns"] = mean_of(dev_ms)
        times[f"{name}_baseline"] = statistics.mean(b_ev)
        times[f"{name}_baseline_device"] = mean_of(b_dev)


def has_wide(base) -> bool:
    """A baseline whose sources have wide (d > 16) kernels."""
    return base is not None and base["stratified_moments"].wide


class baseline_rows_1_7:
    """Within the block the wrappers of rows 1 and 7 (query_eval,
    route_multid) launch the baseline's kernels: its libraries go in as
    the loaded ones (the same C entries; row 7 with the plan this
    checkout's wrapper gives, which the baseline's kernel takes too)."""

    def __init__(self, base):
        self.base = base

    def __enter__(self):
        from repro_torch.kernels import query_eval as qe
        from repro_torch.kernels import route as rt
        qe._kernel(), rt._kernel()  # this checkout's, loaded before the swap
        self.own = (qe._lib, rt._lib)
        qe._lib, rt._lib = (self.base["query_eval"],
                            self.base["route_multid"])
        return self

    def __exit__(self, *exc):
        from repro_torch.kernels import query_eval as qe
        from repro_torch.kernels import route as rt
        qe._lib, rt._lib = self.own
        return False


def route_eval_turns(torch, tag, qe, route, base, times) -> None:
    """Rows 1 and 7 in turns with a baseline's (kernel, baseline,
    baseline, kernel), by events and on the device, after holding each to
    the baseline's bits (row 1's rel and exact, NaN as NaN; row 7's leaf
    and distance): <row>_in_turns, <row>_device_in_turns, <row>_baseline
    and <row>_baseline_device into ``times``."""
    from repro_torch.kernels.query_eval import query_eval_cuda
    from repro_torch.kernels.route import route_multid_cuda
    rel, exact = query_eval_cuda(*qe)
    rel_b, exact_b = baseline_query_eval(torch, base, *qe)
    leaf, dist = route_multid_cuda(*route)
    leaf_b, dist_b = baseline_route(torch, base, *route)
    torch.cuda.synchronize()
    if not (torch.equal(rel, rel_b) and same_bits(torch, exact, exact_b)):
        raise AssertionError(f"{tag}: query_eval differs from the baseline "
                             "kernel")
    if not (torch.equal(leaf, leaf_b) and bits_equal(torch, dist, dist_b)):
        raise AssertionError(f"{tag}: route_multid differs from the "
                             "baseline kernel")
    for name, new, old in (
            ("query_eval", lambda: query_eval_cuda(*qe),
             lambda: baseline_query_eval(torch, base, *qe)),
            ("route_multid", lambda: route_multid_cuda(*route),
             lambda: baseline_route(torch, base, *route))):
        ev, dev_ms, b_ev, b_dev = [], [], [], []
        for run, evs, devs in ((new, ev, dev_ms), (old, b_ev, b_dev),
                               (old, b_ev, b_dev), (new, ev, dev_ms)):
            evs.append(cuda_ms(torch, run, reps=30))
            devs.append(device_ms(torch, run, reps=30, one_op=True,
                                  tries=PROFILE_TRIES))
        times[f"{name}_in_turns"] = statistics.mean(ev)
        times[f"{name}_device_in_turns"] = mean_of(dev_ms)
        times[f"{name}_baseline"] = statistics.mean(b_ev)
        times[f"{name}_baseline_device"] = mean_of(b_dev)
        times[f"{name}_turns"] = {"device": dev_ms, "baseline_device": b_dev}


def wide_stream_turns(torch, tag, run, s_run, base) -> dict:
    """The wide stream again into fresh StreamingIngestors (phase 4's
    seed) with this checkout's rows 1 and 7 and with the baseline's, in
    turns (current, baseline, baseline, current): every state field the
    bits of the phase's own stream, and each stream's ingest ms a batch
    by host clock (ending in a synchronize). Returns the batches and the
    mean ms a batch of each."""
    from contextlib import nullcontext
    from repro_torch.streaming import StreamingIngestor
    from repro_torch.streaming.ingest import STATE_FIELDS
    want = s_run["ing"].state
    batches = s_run["batches"]
    runs = {"current": [], "baseline": []}
    for who in ("current", "baseline", "baseline", "current"):
        with baseline_rows_1_7(base) if who == "baseline" else nullcontext():
            ing = StreamingIngestor(run["syn"], seed=11)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for cb, ab in batches:
                ing.ingest(cb, ab)
            torch.cuda.synchronize()
            runs[who].append((time.perf_counter() - t0) * 1e3 / len(batches))
        for f in STATE_FIELDS:
            u, v = getattr(ing.state, f), getattr(want, f)
            ok = (bits_equal(torch, u, v) if u.is_floating_point()
                  else torch.equal(u, v))
            if not ok:
                raise AssertionError(f"{tag}: the stream with the {who} rows "
                                     f"1 and 7 differs in state.{f}")
    out = {"batches": len(batches),
           "ingest_ms_a_batch_current": statistics.mean(runs["current"]),
           "ingest_ms_a_batch_baseline": statistics.mean(runs["baseline"]),
           "runs": runs}
    emit(check="wide24 stream in turns with the baseline's rows 1 and 7",
         **out, states_bit_equal=True)
    return out


def wide_answer_turns(torch, calls, base) -> dict:
    """Each of ``calls`` ({name: (answer fn, reps, warmup)}) with this
    checkout's rows 1, 2, 3, 4 and 8 and with the baseline's, in turns
    (current, baseline, baseline, current), by events. The baseline's
    libraries go in as the wrappers' loaded ones (the same C entries; rows
    3 and 4 with the baseline's scratch size, its repro_weighted_scratch),
    and each answer with them must have the current answer's bits.
    Returns {<name>_current, <name>_baseline: mean ms}."""
    from repro_torch.kernels import query_eval as qe
    from repro_torch.kernels import sample_extremes as se
    from repro_torch.kernels import stratified_estimate as st
    from repro_torch.serve.coalescer import host_results
    st._kernel(), se._kernel(), qe._kernel()  # loaded before the swap
    st.weighted_library()
    wb = base["weighted_moments"]
    libs = {"current": (st._lib, se._lib, st._wlib,
                        st.weighted_scratch_floats, qe._lib),
            "baseline": (base["stratified_moments"], base["sample_extremes"],
                         wb, lambda R, Q, k, s, d: int(
                             wb.repro_weighted_scratch(R, Q, k, s, d)),
                         base["query_eval"])}
    want = {n: host_results(fn()) for n, (fn, _, _) in calls.items()}
    runs = {f"{n}_{who}": [] for n in calls for who in libs}
    try:
        for who in ("current", "baseline", "baseline", "current"):
            (st._lib, se._lib, st._wlib, st.weighted_scratch_floats,
             qe._lib) = libs[who]
            for n, (fn, reps, warmup) in calls.items():
                require_same(f"wide24 {n} with the {who} rows 1-4 and 8",
                             host_results(fn()), want[n], tuple(want[n]))
                runs[f"{n}_{who}"].append(cuda_ms(torch, fn, reps=reps,
                                                  warmup=warmup))
    finally:
        (st._lib, se._lib, st._wlib, st.weighted_scratch_floats,
         qe._lib) = libs["current"]
    out = {key: statistics.mean(v) for key, v in runs.items()}
    emit(check="wide24 answers in turns with the baseline", **out, runs=runs,
         answers_bit_equal=True)
    return out


def wide_kernel_times(torch, run, boot, s_run, card, base=None) -> dict:
    """Rows 1-4, 7 and 8 at the wide path's shapes (d = 24): rows 3 and 4
    against plain; CUDA-event and device ms of the kernel and of its plain
    version, and its bound (bounds, boot_bounds, stream_bounds); the pair
    classes and row 1's cut columns (qe_cut_histogram); rows 2-4's
    library yardstick (wide_bmm_times); with a baseline that has wide
    kernels, rows 1 and 7 (route_eval_turns) and rows 2 and 8 (pair_turns)
    in turns with its."""
    from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                               bootstrap_moments_plain)
    from repro_torch.kernels.query_eval import (query_eval_cuda,
                                                query_eval_plain)
    from repro_torch.kernels.route import (route_multid_cuda,
                                           route_multid_plain)
    from repro_torch.kernels.sample_extremes import (sample_extremes_cuda,
                                                     sample_extremes_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain,
        stratified_weighted_moments_cuda, weighted_moments_plain,
        weighted_walk)
    syn, q = run["syn"], run["q"]
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    qe = (syn.leaf_lo, syn.leaf_hi, syn.leaf_agg, q.lo, q.hi)
    W = boot_weights(torch, syn, q.lo.device)
    rel, _ = query_eval_cuda(*qe)
    classes = pair_classes(torch, syn.sample_c, syn.sample_valid, q.lo, q.hi,
                           chunk=64)
    # Every MAYBE pair of a launch at d > 16 goes to its one group walk:
    # the mixed pairs are those with a relevant slot.
    _, s, d = syn.sample_c.shape
    walk_pairs = {f"R={R}": {weighted_walk(R, s, d): classes["mixed"]}
                  for R in (1, N_BOOT)}
    bnd = bounds(syn, q, rel, classes)
    bnd.update(boot_bounds(syn, q, classes, N_BOOT, 0))
    del bnd["weighted_segment_reduce"]
    state = s_run["ing"].state
    cb = torch.from_numpy(s_run["batches"][0][0]).cuda()
    route = (state.leaf_lo, state.leaf_hi, cb)
    k, d = state.leaf_lo.shape
    bnd["route_multid"] = stream_bounds(0, k, int(cb.shape[0]), d)[
        "route_multid"]
    pq = slice(0, PLAIN_BOOT_Q)
    # Rows 3 and 4 against plain at these shapes (row 4 on the first
    # PLAIN_BOOT_Q queries), as phase 15 holds them.
    errs = {
        "stratified_weighted_moments": close(
            "wide24 stratified_weighted_moments",
            stratified_weighted_moments_cuda(*sm, W[0], q.lo, q.hi).cpu(),
            weighted_moments_plain(*sm, W[0], q.lo, q.hi).cpu(), K_RTOL,
            K_ATOL),
        "bootstrap_moments": close(
            f"wide24 bootstrap_moments Q={PLAIN_BOOT_Q}",
            bootstrap_moments_cuda(*sm, W, q.lo[pq].contiguous(),
                                   q.hi[pq].contiguous()).cpu(),
            bootstrap_moments_plain(*sm, W, q.lo[pq].contiguous(),
                                    q.hi[pq].contiguous()).cpu(), K_RTOL,
            K_ATOL)}
    torch.cuda.empty_cache()
    one_op = {"query_eval", "stratified_moments", "sample_extremes",
              "route_multid"}
    fns = {
        "query_eval": (lambda: query_eval_cuda(*qe),
                       lambda: query_eval_plain(*qe), 10),
        "stratified_moments": (lambda: stratified_moments_cuda(
            *sm, q.lo, q.hi), lambda: stratified_moments_plain(
            *sm, q.lo, q.hi), 2),
        "sample_extremes": (lambda: sample_extremes_cuda(*sm, q.lo, q.hi),
                            lambda: sample_extremes_plain(*sm, q.lo, q.hi),
                            2),
        "stratified_weighted_moments": (
            lambda: stratified_weighted_moments_cuda(*sm, W[0], q.lo, q.hi),
            lambda: weighted_moments_plain(*sm, W[0], q.lo, q.hi), 2),
        "bootstrap_moments": (
            lambda: bootstrap_moments_cuda(*sm, W, q.lo, q.hi),
            lambda: bootstrap_moments_plain(*sm, W, q.lo[pq].contiguous(),
                                            q.hi[pq].contiguous()), 1),
        "route_multid": (lambda: route_multid_cuda(*route),
                         lambda: route_multid_plain(*route), 10)}
    times = {}
    for name, (kernel, plain, plain_reps) in fns.items():
        reps = 10 if name == "bootstrap_moments" else 30
        times[name] = cuda_ms(torch, kernel, reps=reps)
        times[f"{name}_device"] = (
            device_ms(torch, kernel, reps=reps, one_op=True,
                      tries=PROFILE_TRIES)
            if name in one_op else call_device_ms(
                torch, kernel, tries=PROFILE_TRIES)["ms"])
        times[f"{name}_plain"] = cuda_ms(torch, plain, reps=plain_reps,
                                         warmup=1)
        torch.cuda.empty_cache()
    times["bootstrap_moments_plain_queries"] = PLAIN_BOOT_Q
    if has_wide(base):
        route_eval_turns(torch, "wide24", qe, route, base, times)
        pair_turns(torch, "wide24", (*sm, q.lo, q.hi), base, times)
        # Rows 3 and 4 bit-equal to the baseline's, then in turns.
        turns = weighted_turns(torch, "wide24", sm, W, q.lo, q.hi, base)
        for name, row in turns.items():
            times[f"{name}_device_in_turns"] = row["kernel_device_ms"]
            times[f"{name}_baseline_device"] = row["baseline_device_ms"]
        torch.cuda.empty_cache()
    t_lib = time.perf_counter()
    lib_err = wide_bmm_times(torch, syn, q, W, times)
    lib_s = time.perf_counter() - t_lib
    Q, dq = q.lo.shape
    qe_cuts = qe_cut_histogram(torch, syn.leaf_lo, syn.leaf_hi, q.lo, q.hi)
    emit(phase="30 wide kernel times", times_ms=times, bounds=bnd,
         pair_classes=classes, max_abs_err=errs, walk_pairs=walk_pairs,
         query_eval_cut_columns=qe_cuts,
         bmm_max_abs_err_vs_kernel=lib_err, bmm_s=lib_s,
         profile_windows_retried=PROFILE_RETRIES["windows"], Q=int(Q),
         k=int(syn.num_leaves), s=int(syn.sample_a.shape[1]), d=int(dq),
         R=N_BOOT, route_B=int(cb.shape[0]), card=card)
    return {"times": times, "bounds": bnd, "classes": classes, "errs": errs,
            "walk_pairs": walk_pairs, "qe_cut_columns": qe_cuts}


def bmm_yardstick(torch, tag, sm, q, rhs, ker, times, reps=30) -> float:
    """The library yardstick of a wide shape, as in Table 1: torch.bmm of
    the prebuilt (k, Q, s) predicate (samples_inside over sm = (c, a,
    valid), in query chunks; TF32 off) with each right-hand side of
    ``rhs`` ({row: (R, s, 3)}, whose work does not depend on d); against
    each kernel output of ``ker`` ({row: (Q, k, 3)}), the product's counts
    equal to row 2's and its moments within K_RTOL / K_ATOL; its event and
    device ms into ``times`` (bmm_<row>, bmm_<row>_device; row 4 at most
    10 calls). Returns the largest absolute difference."""
    from repro_torch.kernels.stratified_estimate import samples_inside
    c, a, valid = sm
    k, s = a.shape
    Q = int(q.lo.shape[0])
    step = max(1, plain_step(k, s) // max(1, int(c.shape[2])))
    pred = torch.empty((k, Q, s), dtype=torch.float32, device=q.lo.device)
    for i in range(0, Q, step):
        pred[:, i:i + step] = samples_inside(
            c, valid, q.lo[i:i + step], q.hi[i:i + step]).permute(1, 0, 2)
    # The kernel's counts are integers in fp32: the product's must equal
    # them.
    err = 0.0
    for name, want in ker.items():
        got = torch.bmm(pred, rhs[name]).permute(1, 0, 2)
        if name == "stratified_moments" and not torch.equal(got[..., 0],
                                                            want[..., 0]):
            raise AssertionError(f"{tag}: torch.bmm's counts differ from "
                                 "stratified_moments'")
        err = max(err, close(f"{tag} torch.bmm {name}", got.cpu(),
                             want.cpu(), K_RTOL, K_ATOL))
        del got
    for name, r in rhs.items():
        def library(r=r):
            return torch.bmm(pred, r)
        n = min(reps, 10) if name == "bootstrap_moments" else reps
        times[f"bmm_{name}"] = cuda_ms(torch, library, reps=n)
        times[f"bmm_{name}_device"] = call_device_ms(
            torch, library, tries=PROFILE_TRIES)["ms"]
        torch.cuda.empty_cache()
    del pred
    torch.cuda.empty_cache()
    return err


def wide_bmm_times(torch, syn, q, W, times) -> float:
    """Rows 2, 3 and 4's yardstick at the wide shape (bmm_yardstick): the
    predicate with [1, a, a^2], [w, wa, wa^2] of W[0] and of all of W,
    held to rows 2 and 3's kernels (rows 3 and 4 were held to plain
    above)."""
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_weighted_moments_cuda)
    sm = (syn.sample_c, syn.sample_a, syn.sample_valid)
    a, w0 = sm[1], W[0].contiguous()
    rhs = {"stratified_moments": bmm_rhs(torch, torch.ones_like(a)[None],
                                         a),
           "stratified_weighted_moments": bmm_rhs(torch, w0[None], a),
           "bootstrap_moments": bmm_rhs(torch, W, a)}
    ker = {"stratified_moments": stratified_moments_cuda(*sm, q.lo, q.hi),
           "stratified_weighted_moments": stratified_weighted_moments_cuda(
               *sm, w0, q.lo, q.hi)}
    return bmm_yardstick(torch, "wide24", sm, q, rhs, ker, times)


# The chunk path's reading: Table 1's US arm's sample size (K = 0.5 % of
# the 7.7 M trips: one stratum of 38,500 slots) drawn uniformly from the
# 24-column table, under phase 30's queries.
WIDE_US_S = 38_500


def wide_us_times(torch, c, a, q, card, base=None) -> dict:
    """30, the chunk path: rows 2, 8, 3 and 4 at k = 1, s = WIDE_US_S (a
    uniform sample of the wide table's rows, every slot valid), d = 24, Q
    = WIDE_Q, rows 3 and 4 with the fused bootstrap's weights
    (boot_weights): held to plain (over query chunks; row 2 counts exact,
    sums within K_RTOL / K_ATOL, row 8 bit for bit, rows 3 and 4 within
    K_RTOL / K_ATOL, row 4 on the first PLAIN_BOOT_Q queries) and, with a
    baseline that has wide kernels, to its bits; CUDA-event and device ms
    of each kernel, in turns with the baseline's (pair_turns,
    weighted_turns); torch.bmm of the prebuilt (1, Q, s) predicate against
    [1, a, a^2] and [w, wa, wa^2] of W[0] and of W (bmm_yardstick, held to
    rows 2 and 3) by events and on the device; the bounds (bounds() with
    this run's pair classes, walk_bound for rows 3 and 4)."""
    import types
    from repro_torch.kernels.bootstrap import (bootstrap_moments_cuda,
                                               bootstrap_moments_plain)
    from repro_torch.kernels.sample_extremes import (sample_extremes_cuda,
                                                     sample_extremes_plain)
    from repro_torch.kernels.stratified_estimate import (
        stratified_moments_cuda, stratified_moments_plain,
        stratified_weighted_moments_cuda, weighted_moments_plain)
    t0 = time.perf_counter()
    dev = q.lo.device
    rng = np.random.default_rng(WIDE_SEED + 38)
    idx = np.sort(rng.choice(a.shape[0], WIDE_US_S, replace=False))
    sm = (torch.from_numpy(np.ascontiguousarray(
              c[idx], np.float32)[None]).to(dev),
          torch.from_numpy(np.asarray(a[idx], np.float32)[None]).to(dev),
          torch.ones((1, WIDE_US_S), dtype=torch.bool, device=dev))
    k, s = sm[1].shape
    d = int(sm[0].shape[2])
    step = max(1, plain_step(k, s) // d)
    got = stratified_moments_cuda(*sm, q.lo, q.hi)
    want = chunked_plain(torch, stratified_moments_plain, sm, q.lo, q.hi,
                         step)
    if not torch.equal(got[..., 0], want[..., 0]):
        raise AssertionError("wide US: stratified_moments counts differ")
    err = max(close(f"wide US stratified_moments[{i}]", got[..., i].cpu(),
                    want[..., i].cpu(), K_RTOL, K_ATOL) for i in (1, 2))
    for name, g, w in zip(("min", "max"), sample_extremes_cuda(
            *sm, q.lo, q.hi), chunked_plain(
            torch, sample_extremes_plain, sm, q.lo, q.hi, step)):
        if not same_bits(torch, g, w):
            raise AssertionError(f"wide US: sample_extremes {name} differs "
                                 "from plain")
    classes = pair_classes(torch, *sm[::2], q.lo, q.hi, chunk=step)
    shim = types.SimpleNamespace(sample_a=sm[1], sample_valid=sm[2],
                                 leaf_agg=torch.zeros((k, 5)))
    bnd = bounds(shim, q, torch.zeros((q.lo.shape[0], k)), classes)
    del bnd["query_eval"]
    times = {}
    for name, fn in (("stratified_moments", stratified_moments_cuda),
                     ("sample_extremes", sample_extremes_cuda)):
        times[name] = cuda_ms(torch, lambda fn=fn: fn(*sm, q.lo, q.hi),
                              reps=10)
        times[f"{name}_device"] = device_ms(
            torch, lambda fn=fn: fn(*sm, q.lo, q.hi), reps=10, one_op=True,
            tries=PROFILE_TRIES)
    wide_base = base is not None and base["stratified_moments"].wide
    if wide_base:
        pair_turns(torch, "wide US", (*sm, q.lo, q.hi), base, times)
    del want
    # Rows 3 and 4: above one chunk the query walk takes every MAYBE pair.
    W = boot_weights(torch, shim, dev)
    w0 = W[0].contiguous()
    one = stratified_weighted_moments_cuda(*sm, w0, q.lo, q.hi)
    n = PLAIN_BOOT_Q
    werr = {
        "stratified_weighted_moments": close(
            "wide US stratified_weighted_moments", one.cpu(), chunked_plain(
                torch, weighted_moments_plain, (*sm, w0), q.lo, q.hi,
                step).cpu(), K_RTOL, K_ATOL),
        "bootstrap_moments": close(
            f"wide US bootstrap_moments Q={n}", bootstrap_moments_cuda(
                *sm, W, q.lo[:n], q.hi[:n]).cpu(),
            bootstrap_moments_plain(*sm, W, q.lo[:n], q.hi[:n]).cpu(),
            K_RTOL, K_ATOL)}
    turns = weighted_turns(torch, "wide US", sm, W, q.lo, q.hi,
                           base if wide_base else None)
    for name, row in turns.items():
        times[name] = row["kernel_ms"]
        times[f"{name}_device"] = row["kernel_device_ms"]
        if wide_base:
            times[f"{name}_device_in_turns"] = row["kernel_device_ms"]
            times[f"{name}_baseline_device"] = row["baseline_device_ms"]
    for name, R in (("stratified_weighted_moments", 1),
                    ("bootstrap_moments", int(W.shape[0]))):
        bnd[name] = walk_bound(torch, sm[0], sm[2], q.lo, q.hi, R, step)
    torch.cuda.empty_cache()
    ones = torch.ones_like(sm[1])[None]
    lib_err = bmm_yardstick(
        torch, "wide US", sm, q,
        {"stratified_moments": bmm_rhs(torch, ones, sm[1]),
         "stratified_weighted_moments": bmm_rhs(torch, w0[None], sm[1]),
         "bootstrap_moments": bmm_rhs(torch, W, sm[1])},
        {"stratified_moments": got, "stratified_weighted_moments": one},
        times, reps=10)
    del got, one, W
    out = {"k": int(k), "s": int(s), "d": d, "Q": int(q.lo.shape[0]),
           "R": N_BOOT, "times_ms": times, "bounds": bnd,
           "pair_classes": classes, "max_abs_err": err,
           "weighted_max_abs_err": werr,
           "bmm_max_abs_err_vs_kernel": lib_err,
           "seconds": time.perf_counter() - t0}
    emit(phase="30 wide chunk path", card=card, **out)
    return out


def join_truth_scan(torch, c, a, keys, dkeys, dattr, q_lo, q_hi) -> dict:
    """ground_truth_join's SUM, COUNT and AVG with the scan on the card:
    the fact rows inner-joined with the dimension rows on the key on the
    host (each joined row's coordinates [fact coords, dim attrs]), then
    truth_scan (float64 sums, membership on float32). At 24 fact columns
    the host scan of ground_truth_join takes minutes."""
    order = np.argsort(dkeys, kind="stable")
    dk = np.asarray(dkeys)[order]
    da = np.asarray(dattr, np.float32).reshape(dk.size, -1)[order]
    idx = np.clip(np.searchsorted(dk, keys), 0, dk.size - 1)
    found = dk[idx] == keys
    joined = np.concatenate([np.asarray(c, np.float32).reshape(
        keys.size, -1)[found], da[idx[found]]], 1)
    t = truth_scan(torch, joined, np.asarray(a, np.float64)[found], q_lo,
                   q_hi)
    return {kind: t[kind] for kind in ("sum", "count", "avg")}


def wide_join_data(seed=0):
    """Phase 30's join: join_workload's distributions with WIDE_D fact
    columns (JOIN_N fact rows over JOIN_ND keys), each of the JOIN_Q
    rectangles bounding 2-4 fact columns (the rest at the data's [min,
    max]) and the dimension pair, and the join synopsis built from them
    (P = JOIN_P, p_u = JOIN_PU, k = JOIN_K, "kd"). Returns ((c, a, keys,
    dkeys, dattr, q_lo, q_hi), jsyn, report)."""
    from repro_torch.joins import build_dim_table, build_join_synopsis
    c, a, keys, dkeys, dattr, q_lo, q_hi = join_workload(
        JOIN_N, JOIN_ND, JOIN_Q, seed, WIDE_D)
    rng = np.random.default_rng(seed + 30)
    free = np.ones((JOIN_Q, WIDE_D), bool)
    for i in range(JOIN_Q):
        free[i, rng.choice(WIDE_D, int(rng.integers(2, 5)),
                           replace=False)] = False
    mins, maxs = c.min(0), c.max(0)
    q_lo[:, :WIDE_D] = np.where(free, mins, q_lo[:, :WIDE_D])
    q_hi[:, :WIDE_D] = np.where(free, maxs, q_hi[:, :WIDE_D])
    dim = build_dim_table(dkeys, dattr, num_partitions=JOIN_P)
    jsyn, report = build_join_synopsis(c, a, keys, dim, k=JOIN_K,
                                       p_u=JOIN_PU, seed=seed, method="kd")
    return (c, a, keys, dkeys, dattr, q_lo, q_hi), jsyn, report


def join_cut_histogram(torch, args, tile=None) -> dict:
    """Row 9's cut columns on these inputs: for each mixed (query, cell)
    pair the columns whose test can clear a
    slot's bit (the query does not hold the cell's box there, or a slot
    of the run has NaN there), and for each (query, tile of ``tile``
    cells) with a mixed pair the columns where the query does not hold
    the tile's box, which the wide walk tests (every column for a pair on
    a cell with a NaN coordinate); each as {columns: count}. Also the
    mixed pairs a block of JM_QT queries x ``tile`` cells holds
    (quantiles, and the share of blocks past JM_WIDE_RESULTS). ``tile``:
    the wide kernel's JM_WIDE_CT by default."""
    from repro_torch.kernels.join_moments import (JM_QT, JM_WIDE_CT,
                                                  JM_WIDE_RESULTS, MIXED,
                                                  cell_nan_columns,
                                                  join_cell_classes)
    tile = tile or JM_WIDE_CT
    slots, lo, hi = args[:3]
    Q, D = lo.shape
    kp = slots.cell_box.shape[0]
    nan_cols = cell_nan_columns(slots)
    flags = nan_cols.any(-1)
    box = slots.cell_box
    n_t = -(-kp // tile)
    pad = n_t * tile - kp
    tlo = torch.nn.functional.pad(box[:, 0], (0, 0, 0, pad),
                                  value=float("inf"))
    thi = torch.nn.functional.pad(box[:, 1], (0, 0, 0, pad),
                                  value=float("-inf"))
    tlo = tlo.reshape(n_t, tile, D).amin(1)
    thi = thi.reshape(n_t, tile, D).amax(1)
    pair, per_tile = {}, {}
    blocks = []
    for s in range(0, Q, JM_QT):
        ql, qh = lo[s:s + JM_QT], hi[s:s + JM_QT]
        mixed = join_cell_classes(slots, ql, qh, flags) == MIXED
        cut = (~((ql[:, None] <= box[None, :, 0])
                 & (box[None, :, 1] <= qh[:, None])) | nan_cols[None])
        n = cut.sum(-1)[mixed]
        for v, c in zip(*torch.unique(n, return_counts=True)):
            pair[int(v)] = pair.get(int(v), 0) + int(c)
        held = ((ql[:, None] <= tlo[None]) & (thi[None] <= qh[:, None]))
        nt = (~held).sum(-1)                                  # (q, n_t)
        mt = torch.nn.functional.pad(mixed, (0, pad)).reshape(
            -1, n_t, tile)
        live = mt.any(-1)
        for v, c in zip(*torch.unique(nt[live], return_counts=True)):
            per_tile[int(v)] = per_tile.get(int(v), 0) + int(c)
        blocks.append(mt.sum((0, 2)))
    blocks = torch.cat(blocks).to(torch.float64)
    qs = torch.quantile(blocks, torch.tensor(
        [0.5, 0.9, 0.99, 1.0], dtype=torch.float64, device=blocks.device))
    return {"pair_cut_columns": dict(sorted(pair.items())),
            "tile_cut_columns": dict(sorted(per_tile.items())),
            "tile_cells": tile,
            "block_mixed_pairs_p50_p90_p99_max": [float(x) for x in qs],
            "blocks_past_results": float((blocks > JM_WIDE_RESULTS).to(
                torch.float64).mean())}


def wide_join(torch, card, seed=0, base=None) -> dict:
    """30, join: join_workload's distributions with WIDE_D fact columns at
    the join slice's size (JOIN_N fact rows over JOIN_ND keys, P = 16,
    p_u = 0.05, k = 1024, "kd"), each of its JOIN_Q rectangles bounding 2-4
    fact columns (the rest at the data's [min, max]) and the dimension
    pair; PassEngine(sum/count/avg, ci=0.95).answer_join: query_eval
    twice, rows 9 and 11 once; row 9 against plain at that shape (its
    first JOIN_CPU_Q queries, as the plain time); the truth
    of 64 queries (join_truth_scan) inside [lower, upper], median SUM error
    at most JOIN_ERR; times of the answer and of row 9 against its
    bound; the cut columns of its mixed pairs (join_cut_histogram). With a
    baseline that has wide kernels, row 9 bit-equal to the baseline's at
    the whole shape and, in turns with it, row 9 and the answer
    (join_baseline_turns: the same answer bits), and the answer with the
    baseline's row 1 the same bits."""
    from repro_torch.api import PassEngine, ServingConfig
    from repro_torch.core.types import QueryBatch
    from repro_torch.joins.executor import join_slots
    from repro_torch.kernels import native
    from repro_torch.kernels.join_moments import (PLANES,
                                                  join_cell_moments_cuda)
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    (c, a, keys, dkeys, dattr, q_lo, q_hi), jsyn, report = wide_join_data(
        seed)
    build_s = time.perf_counter() - t0
    q = QueryBatch(torch.from_numpy(q_lo).to(dev),
                   torch.from_numpy(q_hi).to(dev))
    fq = QueryBatch(q.lo[:, :WIDE_D], q.hi[:, :WIDE_D])
    dq = QueryBatch(q.lo[:, WIDE_D:], q.hi[:, WIDE_D:])
    eng = PassEngine(jsyn, ServingConfig(kinds=JOIN_KINDS), ci=0.95)
    torch.cuda.synchronize()
    native.reset_launches()
    res = eng.answer_join(fq, dq)
    torch.cuda.synchronize()
    launches = launches_now(native)
    if launches != {"query_eval": 2, "join_cell_moments": 1,
                    "join_epilogue": 1}:
        raise AssertionError(f"wide join: answer_join launched {launches}")
    check_result_shapes(torch, "wide join", res, JOIN_Q, JOIN_KINDS)
    slots = join_slots(jsyn)
    args = join_inputs(torch, slots, jsyn, q.lo, q.hi)
    classes = join_classes(torch, args)
    # Row 9 against plain on the first JOIN_CPU_Q rows at the wide shape
    # (every cell): the plain version takes ~9 s for all 2048.
    plain_time = {}
    err = join_vs_plain(torch, f"wide join main Q={JOIN_CPU_Q}",
                        join_rows(args, JOIN_CPU_Q), JOIN_PU,
                        times=plain_time)
    n = 64
    truth = join_truth_scan(torch, c, a, keys, dkeys, dattr, q_lo[:n],
                            q_hi[:n])
    quality = join_truth_check("wide join", res, truth, n)

    def row9():
        return join_cell_moments_cuda(*args, JOIN_PU)
    kby = device_by_name(torch, row9, tries=PROFILE_TRIES)
    times = {"answer_join": cuda_ms(torch, lambda: eng.answer_join(fq, dq),
                                    reps=10, warmup=2),
             "answer_join_host": host_ms(torch, lambda: eng.answer_join(
                 fq, dq), reps=10),
             "join_cell_moments": cuda_ms(torch, row9, reps=10, warmup=2),
             "join_cell_moments_device": records_ms(kby),
             "join_cell_moments_by_kernel": {
                 n: v["ms_per_record"] for n, v in kby.items()},
             "join_cell_moments_plain": plain_time[
                 "join_cell_moments_plain"],
             "join_cell_moments_plain_queries": JOIN_CPU_Q}
    baseline_bit_equal = None
    if base is not None and base["join_moments"].wide:
        got, old = row9(), baseline_join(torch, base, *args, JOIN_PU)
        for f in PLANES + ("exact3", "touched"):
            if not bits_equal(torch, getattr(got, f), getattr(old, f)):
                raise AssertionError(f"wide join: row 9's {f} differs from "
                                     "the baseline kernel's")
        del got, old
        baseline_bit_equal = True
        times.update(join_baseline_turns(torch, "wide join", eng, fq, dq,
                                         args, base))
    if has_wide(base):
        from repro_torch.serve.coalescer import host_results
        want = host_results(eng.answer_join(fq, dq))
        with baseline_rows_1_7(base):
            require_same("wide join answer with the baseline's row 1",
                         host_results(eng.answer_join(fq, dq)), want,
                         JOIN_KINDS)
    out = {"rows": JOIN_N, "fact_columns": WIDE_D, "build_s": build_s,
           "report": report, "launches": launches, "classes": classes,
           "cut_columns": join_cut_histogram(torch, args),
           "max_abs_err": err, "quality": quality, "times_ms": times,
           "baseline_bit_equal": baseline_bit_equal,
           "bound": join_bound(torch, args, jsyn),
           "seconds": time.perf_counter() - t0}
    emit(phase="30 wide join", card=card, **out)
    return out


def wide_path(torch, card, base=None) -> dict:
    """30. The 24-column table at paper size through the port's main paths
    (module doc): answer (rows 1, 2, 8), the fused and the scan bootstrap
    (rows 10, 4, 3), a 4096-row stream (rows 10, 5, 7), a join answer
    (rows 1, 9, 11); each window's launches read right after it; rows'
    times and bounds at d = 24; rows 2, 8, 3 and 4 on the chunk path
    (wide_us_times)."""
    from repro_torch.core.types import QueryBatch
    from repro_torch.data.synthetic import nyc_taxi
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    c, a = wide_table(nyc_taxi, 1.0)
    cs, as_ = wide_table(nyc_taxi, 0.1, seed=7)
    q_lo, q_hi = wide_queries(c, WIDE_Q, WIDE_SEED, sort=lambda x: torch.sort(
        torch.from_numpy(x).to(dev)).values.cpu().numpy())
    q = QueryBatch(torch.from_numpy(q_lo).to(dev),
                   torch.from_numpy(q_hi).to(dev))
    emit(phase="30 wide data", rows=int(a.shape[0]), d=int(c.shape[1]),
         stream_rows=int(as_.shape[0]), seconds=time.perf_counter() - t0)
    steps = {"data": time.perf_counter() - t0}

    def step(name):
        steps[name] = time.perf_counter() - t0 - sum(steps.values())
    # The CPU answer on 128 queries: the plain versions over 24 columns on
    # the host take ~4x longer a query than in 3-D.
    run = main_path(torch, "wide24", c, a, "kd",
                    lambda c, a, lo, hi: truth_scan(torch, c, a, lo, hi),
                    WIDE_ERR, queries=q, cpu_queries=128)
    step("build, answer, checks")
    boot = boot_serve(torch, "wide24", run, WIDE_ERR, scan=True)
    step("bootstrap")
    s_run = stream_path(torch, "wide24", run, c, a, cs, as_, WIDE_ERR,
                        reopt=False)
    step("stream")
    kt = wide_kernel_times(torch, run, boot, s_run, card, base)
    step("kernel times")
    stream_turns = None
    if has_wide(base):
        stream_turns = wide_stream_turns(torch, "wide24", run, s_run, base)
        step("stream with the baseline's rows 1 and 7")
    us = wide_us_times(torch, c, a, q, card, base)
    step("chunk path")
    rows = {"query_eval": run["launches"]["query_eval"],
            "stratified_moments": run["launches"]["stratified_moments"],
            "sample_extremes": run["launches"]["sample_extremes"],
            "stratified_weighted_moments": boot["scan_launches"][
                "stratified_weighted_moments"],
            "bootstrap_moments": boot["launches"]["bootstrap_moments"],
            "threefry": boot["launches"]["threefry"],
            "segment_reduce": s_run["launches"]["segment_reduce"],
            "route_multid": s_run["launches"]["route_multid"]}
    calls = {"answer": (lambda: run["eng"].answer(run["q"]), 10, 2),
             "answer_bootstrap_fused": (lambda: boot["eng"].answer(run["q"]),
                                        5, 1),
             "answer_bootstrap_scan": (
                 lambda: boot["scan_eng"].answer(run["q"]), 2, 1)}
    times = {n: cuda_ms(torch, fn, reps=reps, warmup=warmup)
             for n, (fn, reps, warmup) in calls.items()}
    if base is not None and base["stratified_moments"].wide:
        times["in_turns"] = wide_answer_turns(torch, calls, base)
    step("answer times")
    del c, a, cs, as_
    torch.cuda.empty_cache()
    join = wide_join(torch, card, base=base)
    step("join")
    rows.update(join_cell_moments=join["launches"]["join_cell_moments"],
                join_epilogue=join["launches"]["join_epilogue"])
    idle = [name for name, n in rows.items() if n < 1]
    if idle:
        raise AssertionError(f"wide path: {idle} never launched")
    out = {"run": run, "boot": boot, "stream": s_run, "kernels": kt,
           "us": us, "join": join, "times_ms": times, "steps_s": steps,
           "stream_turns": stream_turns,
           "seconds": time.perf_counter() - t0}
    emit(phase="30 wide path", card=card, times_ms=times, steps_s=steps,
         stream_turns=stream_turns,
         launches={"answer": run["launches"], "bootstrap_fused":
                   boot["launches"], "bootstrap_scan": boot["scan_launches"],
                   "stream": s_run["launches"],
                   "join_answer": join["launches"]},
         seconds=out["seconds"])
    return out


def wide_rows(wide, edge) -> list:
    """Each kernel's ``wide`` entry for the kernels line: its launches on
    phase 30's windows (answer, fused and scan bootstrap, stream, join
    answer) and, for the kernels whose work depends on d, its times, plain
    times and bound at d = 24, phase 29's cases and its max absolute error
    against plain there."""
    kt, t, b = wide["kernels"], wide["kernels"]["times"], \
        wide["kernels"]["bounds"]
    j = wide["join"]
    ans, fused = wide["run"]["launches"], wide["boot"]["launches"]
    scan, stream = wide["boot"]["scan_launches"], wide["stream"]["launches"]
    err, cases = dict(edge["max_abs_err"]), edge["cases"]
    main = wide["run"]["errs"]
    for name in ("query_eval", "stratified_moments"):
        err[name] = max(err[name], main[name])
    boot_err = max(err["bootstrap_moments"], *kt["errs"].values())
    out = []
    for name, launches, e, n in (
            ("query_eval", ans["query_eval"], err["query_eval"],
             cases["query_eval"]),
            ("stratified_moments", ans["stratified_moments"],
             err["stratified_moments"], cases["stratified_moments"]),
            ("sample_extremes", ans["sample_extremes"], 0.0,
             cases["sample_extremes"]),
            ("stratified_weighted_moments",
             scan["stratified_weighted_moments"], boot_err,
             cases["bootstrap_moments"]),
            ("bootstrap_moments", fused["bootstrap_moments"], boot_err,
             cases["bootstrap_moments"]),
            ("route_multid", stream["route_multid"], 0.0,
             cases["route_multid"])):
        out.append({"name": name, "wide": {
            "d": WIDE_D, "launches": launches, "max_abs_err": e,
            "edge_cases": n, "edge_widths": edge["widths"],
            "ms": t[name], "device_ms": t[f"{name}_device"],
            "plain_ms": t[f"{name}_plain"],
            "bound_ms": b[name]["bound_ms"], "bound_by": b[name]["bound_by"],
            "library_ms": t.get(f"bmm_{name}"),
            "library_device_ms": t.get(f"bmm_{name}_device")}})
    out[4]["wide"]["plain_queries"] = t["bootstrap_moments_plain_queries"]
    out[1]["wide"]["pair_classes"] = kt["classes"]
    out[0]["wide"]["cut_columns"] = kt["qe_cut_columns"]
    for r in (out[0], out[5]):
        r["wide"]["baseline_bit_equal_cases"] = cases[
            "route_eval_baseline_bits"]
    st = wide["stream_turns"] or {}
    out[5]["wide"]["stream_baseline_bit_equal_batches"] = st.get("batches")
    out[5]["wide"]["stream_ingest_ms_a_batch"] = {
        key: st.get(f"ingest_ms_a_batch_{key}")
        for key in ("current", "baseline")}
    us = wide["us"]
    for r in (*out[0:3], out[5]):
        name = r["name"]
        r["wide"].update({
            key: t.get(f"{name}_{key}") for key in (
                "in_turns", "device_in_turns", "baseline",
                "baseline_device")})
    for r in out[1:5]:
        name, ut = r["name"], us["times_ms"]
        r["wide"]["chunk_path"] = {
            "k": us["k"], "s": us["s"], "d": us["d"], "Q": us["Q"],
            "ms": ut[name], "device_ms": ut[f"{name}_device"],
            "bound_ms": us["bounds"][name]["bound_ms"],
            "bound_by": us["bounds"][name]["bound_by"],
            "library_ms": ut.get(f"bmm_{name}"),
            "library_device_ms": ut.get(f"bmm_{name}_device"),
            **{key: ut.get(f"{name}_{key}") for key in (
                "device_in_turns", "baseline_device")}}
    out[1]["wide"]["baseline_bit_equal_cases"] = edge["cases"][
        "baseline_bits"]
    for r in out[3:5]:
        name = r["name"]
        r["wide"].update(
            walk_pairs=kt["walk_pairs"],
            device_in_turns=t.get(f"{name}_device_in_turns"),
            baseline_device=t.get(f"{name}_baseline_device"),
            baseline_bit_equal_cases=edge["cases"]["weighted_baseline_bits"])
    jt = j["times_ms"]
    out.append({"name": "join_cell_moments", "wide": {
        "d": WIDE_D + 1, "launches": j["launches"]["join_cell_moments"],
        "max_abs_err": max(err["join_cell_moments"], j["max_abs_err"]),
        "edge_cases": cases["join_cell_moments"],
        "edge_widths": edge["widths"], "ms": jt["join_cell_moments"],
        "device_ms": jt["join_cell_moments_device"],
        "plain_ms": jt["join_cell_moments_plain"],
        "plain_queries": jt["join_cell_moments_plain_queries"],
        "bound_ms": j["bound"]["bound_ms"], "bound_by": j["bound"]["bound_by"],
        "library_ms": None, "library_device_ms": None,
        "cell_classes": j["classes"], "cut_columns": j["cut_columns"],
        "device_ms_by_kernel": jt["join_cell_moments_by_kernel"],
        "baseline_bit_equal": j["baseline_bit_equal"],
        "baseline_bit_equal_cases": edge["cases"]["join_baseline_bits"],
        **{key: (jt.get("in_turns") or {}).get(key) for key in (
            "baseline_row9_ms", "baseline_row9_device_ms",
            "current_row9_ms", "current_row9_device_ms",
            "baseline_answer_join_ms", "current_answer_join_ms")}}})
    out.append({"name": "segment_reduce", "wide": {
        "launches": stream["segment_reduce"], "max_abs_err": 0.0}})
    out.append({"name": "threefry", "wide": {
        "launches": fused["threefry"] + scan["threefry"]
        + stream["threefry"], "max_abs_err": 0.0}})
    out.append({"name": "join_epilogue", "wide": {
        "launches": j["launches"]["join_epilogue"], "max_abs_err": 0.0}})
    return out


def check_plan_constants() -> None:
    """The wrappers' launch plans against the CUDA sources' constants:
    weighted_segment_reduce's chunk cap, segment_reduce's chunk rule (on
    which its bits rest), route_multid's block and cluster sizes,
    query_eval's block, leaf tile and queries a block, sample_extremes'
    tiles, rows 2 and 8's slot chunk (on which row 2's bits rest) and
    their scratch, rows 3 and 4's slot chunk (on which their bits rest
    above it), the pairs from which their walk stages a segment and the R
    up to which its lanes take pairs, segments a tile, shared memory and
    scratch, above 16 columns their group walk (lane layout, segments a
    group), row 9's query and cell tiles and scratch, and the length of
    row 10's Poisson table."""
    from repro_torch.kernels import native
    from repro_torch.kernels.query_eval import (QE_LEAF_TILE, QE_MAX_QUERIES,
                                                QE_THREADS, QE_WIDE_COLS)
    from repro_torch.kernels.route import (ROUTE_MAX_GROUPS, ROUTE_THREADS,
                                           ROUTE_WIDE_WARPS)
    from repro_torch.kernels.join_epilogue import EPI_CHUNK, EPI_THREADS
    from repro_torch.kernels.join_moments import (JM_CT, JM_MAX_D, JM_QT,
                                                  JM_WIDE_CT,
                                                  JM_WIDE_RESULTS,
                                                  join_scratch_floats)
    from repro_torch.kernels.threefry import CDF_LEN
    from repro_torch.kernels.sample_extremes import EXTREMES_LT, EXTREMES_QT
    from repro_torch.kernels.segment_reduce import (
        SEG_MAX_CHUNKS, SEG_MIN_ROWS, WSEG_MAX_CHUNKS, segment_plan)
    from repro_torch.kernels.stratified_estimate import (
        PAIR_CHUNK, WEIGHTED_CHUNK, WEIGHTED_PAIR_R, _WSTAGE,
        pair_scratch_floats, weighted_group, weighted_library, weighted_plan,
        weighted_scratch_floats)
    seg = native.library("segment_reduce")
    sm = native.library("stratified_moments")
    rt = native.library("route_multid")
    qe = native.library("query_eval")
    se = native.library("sample_extremes")
    jmo = native.library("join_moments")
    wm = weighted_library()
    got = {"weighted_segment_reduce chunks":
           seg.repro_weighted_segment_max_chunks(),
           "segment_reduce rows": seg.repro_segment_reduce_min_rows(),
           "segment_reduce chunks": seg.repro_segment_reduce_max_chunks(),
           "route_multid threads": rt.repro_route_threads(),
           "route_multid groups": rt.repro_route_max_groups(),
           "route_multid wide warps": rt.repro_route_wide_warps(),
           "query_eval threads": qe.repro_query_eval_threads(),
           "query_eval leaf tile": qe.repro_query_eval_leaf_tile(),
           "query_eval queries a block":
           qe.repro_query_eval_max_queries(),
           "query_eval wide columns": qe.repro_query_eval_wide_cols(),
           "sample_extremes tiles": (se.repro_sample_extremes_query_tile(),
                                     se.repro_sample_extremes_leaf_tile()),
           "slot chunk": (sm.repro_stratified_moments_slot_chunk(),
                          se.repro_sample_extremes_slot_chunk()),
           "weighted slot chunk": wm.repro_weighted_chunk(),
           "weighted walks": (wm.repro_weighted_stage(),
                              wm.repro_weighted_pair_r()),
           "join_cell_moments tiles": (jmo.repro_join_moments_query_tile(),
                                       jmo.repro_join_moments_cell_tile(),
                                       jmo.repro_join_moments_max_d(),
                                       jmo.repro_join_moments_wide_cell_tile(),
                                       jmo.repro_join_moments_wide_results()),
           "threefry table": native.library(
               "threefry").repro_threefry_cdf_len(),
           "join_epilogue launch": (
               native.library("join_epilogue").repro_join_epilogue_threads(),
               native.library("join_epilogue").repro_join_epilogue_chunk())}
    want = {"weighted_segment_reduce chunks": WSEG_MAX_CHUNKS,
            "segment_reduce rows": SEG_MIN_ROWS,
            "segment_reduce chunks": SEG_MAX_CHUNKS,
            "route_multid threads": ROUTE_THREADS,
            "route_multid groups": ROUTE_MAX_GROUPS,
            "route_multid wide warps": ROUTE_WIDE_WARPS,
            "query_eval threads": QE_THREADS,
            "query_eval leaf tile": QE_LEAF_TILE,
            "query_eval queries a block": QE_MAX_QUERIES,
            "query_eval wide columns": QE_WIDE_COLS,
            "sample_extremes tiles": (EXTREMES_QT, EXTREMES_LT),
            "slot chunk": (PAIR_CHUNK, PAIR_CHUNK),
            "weighted slot chunk": WEIGHTED_CHUNK,
            "weighted walks": (_WSTAGE, WEIGHTED_PAIR_R),
            "join_cell_moments tiles": (JM_QT, JM_CT, JM_MAX_D, JM_WIDE_CT,
                                        JM_WIDE_RESULTS),
            "threefry table": CDF_LEN,
            "join_epilogue launch": (EPI_THREADS, EPI_CHUNK)}
    if got != want:
        raise AssertionError(f"launch plans: the sources' constants {got} "
                             f"are not the wrappers' {want}")
    # The chunked launch's scratch: the wrapper allocates what the source
    # asks for (the launch refuses less).
    for lib, name, stats in ((sm, "stratified_moments", 3),
                             (se, "sample_extremes", 2)):
        fn = getattr(lib, f"repro_{name}_scratch")
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_longlong
        for Q, k, s, d in ((2048, 1024, 75, 3), (1, 1, PAIR_CHUNK, 16),
                           (2048, 1, 38_500, 1), (2048, 64, 19_250, 1),
                           (512, 64, PAIR_CHUNK + 1, 3), (7, 3, 6151, 16),
                           (2048, 1024, 75, 24), (37, 3, 2500, 300)):
            if fn(Q, k, s, d) != pair_scratch_floats(Q, k, s, d, stats):
                raise AssertionError(f"{name}: the wrapper's scratch for "
                                     f"{(Q, k, s, d)} is not the source's")
    # Rows 3 and 4: the plan (segments a tile, shared memory) and scratch
    # at the serving shapes, around one chunk and at Table 1's US shape.
    lt, nbytes = ctypes.c_int(), ctypes.c_int()
    for R, Q, k, s, d in ((200, 2048, 1024, 75, 1), (200, 2048, 1024, 75, 3),
                          (1, 2048, 1, 38_500, 1), (200, 2048, 1, 38_500, 1),
                          (9, 33, 1, WEIGHTED_CHUNK, 1),
                          (8, 40, 3, WEIGHTED_CHUNK + 1, 3),
                          (2, 20, 17, 40_000, 16), (3, 24, 3, 65_537, 3),
                          (200, 2048, 64, 19_250, 1), (7, 129, 53, 2500, 3),
                          (1, 1, 1, 0, 1), (200, 2048, 1024, 75, 24),
                          (1, 2048, 1024, 75, 24), (3, 33, 3, 2049, 300),
                          (9, 40, 17, 75, 17)):
        if (wm.repro_weighted_plan(Q, k, s, d, ctypes.byref(lt),
                                   ctypes.byref(nbytes)) != 0
                or (lt.value, nbytes.value) != weighted_plan(Q, k, s, d)
                or wm.repro_weighted_scratch(R, Q, k, s, d)
                != weighted_scratch_floats(R, Q, k, s, d)):
            raise AssertionError(f"weighted kernels: the wrapper's plan or "
                                 f"scratch for {(R, Q, k, s, d)} is not the "
                                 "source's")
    # Above 16 columns: the group walk's lane layout and segments a group.
    gs, gbytes = ctypes.c_int(), ctypes.c_int()
    wm.repro_weighted_group.argtypes = [ctypes.c_int] * 5 + \
        [ctypes.POINTER(ctypes.c_int)] * 2
    for R, s in ((200, 75), (1, 75), (8, 75), (9, 300), (33, 620),
                 (33, 621), (200, 2049), (3, 40_000), (200, 0)):
        reps = wm.repro_weighted_group(R, 2048, 1024, s, 24, ctypes.byref(gs),
                                       ctypes.byref(gbytes))
        got = ("replicates" if reps == 1 else "queries", gs.value)
        if reps < 0 or got != weighted_group(R, s):
            raise AssertionError(f"weighted kernels: the group walk at R={R} "
                                 f"s={s} is {got} in the source, "
                                 f"{weighted_group(R, s)} in the wrapper")
    jmo.repro_join_moments_scratch.argtypes = [ctypes.c_int]
    jmo.repro_join_moments_scratch.restype = ctypes.c_longlong
    for kp in (1, 15, 16_384):
        if jmo.repro_join_moments_scratch(kp) != join_scratch_floats(kp):
            raise AssertionError(f"join_cell_moments: the wrapper's scratch "
                                 f"for k*P={kp} is not the source's")
    seg.repro_segment_reduce_chunk.argtypes = [ctypes.c_int]
    for n in (0, 1, 255, 4096, 65536, 69696, 10 ** 6):
        if segment_plan(n)[0] != seg.repro_segment_reduce_chunk(n):
            raise AssertionError(f"segment_reduce: the wrapper's chunk for "
                                 f"N={n} is not the source's")


def print_ok(torch) -> None:
    """The last line: {"ok": true, "device": {...}}."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="checkout of an earlier commit whose redesigned "
                         "kernels are held against the current ones and "
                         "timed beside them")
    ap.add_argument("--stream-ab", type=Path, default=None, metavar="DIR",
                    help="only time the ingests (streaming, sharded at "
                         "D = 4, join) and the merge of DIR's package "
                         "against this checkout's, in turns, and exit")
    ap.add_argument("--stream-probe", type=Path, default=None,
                    help=argparse.SUPPRESS)
    ap.add_argument("--sharded-only", action="store_true",
                    help="only phases 1, 2, 23 and 24 (the sharded state "
                         "and the distributed helpers), then exit")
    ap.add_argument("--wide-only", action="store_true",
                    help="only phases 1, 2, 29 and 30 (rows 1-4, 7, 8 and "
                         "9 above 16 columns at edge shapes, then the "
                         "24-column table at paper size), then exit")
    ap.add_argument("--table1-only", action="store_true",
                    help="only phases 1, 2, 4, 5 and 25-28 (Table 1 at "
                         "paper size, fig 8's 3-D cell, the legacy update "
                         "path, the examples), then exit")
    args = ap.parse_args(argv)
    if args.stream_probe is not None:
        # Before any import of repro_torch: the package under test first.
        sys.path.insert(0, str(args.stream_probe.resolve()))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs a CUDA card", file=sys.stderr)
        return 2
    from repro_torch.data.synthetic import nyc_taxi
    from repro_torch.kernels import native

    # 1. Device.
    card = card_line()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.stream_probe is not None:
        stream_probe(torch, card)
        return 0
    if args.stream_ab is not None:
        stream_ab(torch, args.stream_ab, card)
        print(card, flush=True)
        return 0
    dev = torch.device("cuda")
    emit(phase="device", card=card, kind=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__,
         cuda=torch.version.cuda)

    # 2. Build.
    t0 = time.perf_counter()
    logs = native.build_all()
    emit(phase="build", seconds=time.perf_counter() - t0,
         built=sorted(logs))
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "smem" in line or "error" in line:
                print(f"nvcc {name}: {line.strip()}", flush=True)

    check_plan_constants()
    base = build_baseline(args.baseline) if args.baseline else None

    if args.sharded_only:
        sh1, sh3, dist24 = sharded_phases(torch, nyc_taxi, card)
        emit(phase="sharded summary", card=card,
             **sharded_summary(sh1, sh3, dist24))
        print(card, flush=True)
        return 0
    if args.wide_only:
        edge_wide = edge_cases_wide(torch, dev, base)
        wide = wide_path(torch, card, base)
        emit(phase="wide summary", card=card,
             rows=[{"name": r["name"], **r["wide"]}
                   for r in wide_rows(wide, edge_wide)])
        print(card, flush=True)
        print_ok(torch)
        return 0
    if args.table1_only:
        c1, a1 = nyc_taxi(scale=1.0)
        c3, a3 = nyc_taxi(scale=1.0, dims=3)
        run1 = main_path(torch, "1d", c1, a1, "adp", truth_1d, 0.05)
        run3 = main_path(torch, "3d", c3, a3, "kd",
                         lambda c, a, lo, hi: truth_scan(torch, c, a, lo,
                                                         hi), 0.15)
        tab1 = table1_phases(torch, nyc_taxi, card, run1, run3, c1, a1, c3,
                             a3, base)
        emit(phase="table1 summary", card=card, **table1_summary(tab1))
        print(card, flush=True)
        return 0

    # 3. Kernels against plain at edge shapes.
    edge_ch = edge_cases_chunks(torch, dev, base)
    edge_sm_err = max(edge_cases(torch, dev, base),
                      edge_cases_moments(torch, dev, base), edge_ch["err"])
    edge_qe_err = edge_cases_query_eval(torch, dev, base)
    edge_se_cases = edge_cases_extremes(torch, dev)
    edge_tf = edge_cases_threefry(torch, dev)

    # 4. 1-D main path; 5. 3-D path.
    t0 = time.perf_counter()
    c1, a1 = nyc_taxi(scale=1.0)
    c3, a3 = nyc_taxi(scale=1.0, dims=3)
    emit(phase="data", seconds=time.perf_counter() - t0,
         rows=int(a1.shape[0]))
    run1 = main_path(torch, "1d", c1, a1, "adp", truth_1d, 0.05, base)
    # Random 3-D boxes over the taxi columns select ~0.5 % of the rows and
    # many are empty, so the 3-D median error bar is looser (a CPU run at
    # scale 0.1 with the same 75 samples per stratum gave 0.057).
    run3 = main_path(torch, "3d", c3, a3, "kd",
                     lambda c, a, lo, hi: truth_scan(torch, c, a, lo, hi),
                     0.15, base)

    # 6. Times.
    t1 = timings(torch, "1d", run1, card, base)
    t3 = timings(torch, "3d", run3, card, base)
    profile_answer(torch, "1d", run1)
    profile_answer(torch, "3d", run3)

    # 7. Streaming kernels against plain at edge shapes.
    edge_s = edge_cases_streaming(torch, dev, base)
    edge_seg_err = edge_s["seg_err"]

    # 8. Streaming, 1-D: ingest, serve the ingestor, reoptimize.
    t0 = time.perf_counter()
    cs1, as1 = nyc_taxi(scale=0.1, seed=7)
    cs3, as3 = nyc_taxi(scale=0.1, seed=7, dims=3)
    emit(phase="stream data", seconds=time.perf_counter() - t0,
         rows=int(as1.shape[0]))
    s1 = stream_path(torch, "1d", run1, c1, a1, cs1, as1, 0.05, reopt=True)
    # 9. Streaming, 3-D (reoptimize is 1-D only, as in the JAX package).
    s3 = stream_path(torch, "3d", run3, c3, a3, cs3, as3, 0.15,
                     reopt=False)

    # 10. Streaming times.
    kt = stream_kernel_times(torch, s1, s3, card, base)
    stream_timings(torch, "1d", run1, s1, card)
    stream_timings(torch, "3d", run3, s3, card)
    profile_ingest(torch, "1d", s1)
    profile_ingest(torch, "3d", s3)

    # 11. The bootstrap's kernels against plain at edge shapes, then rows 3
    # and 4 around one slot chunk.
    edge_w = edge_cases_weighted(torch, dev, base)
    edge_wch = edge_cases_weighted_chunks(torch, dev, base)
    edge_walk = edge_cases_weighted_walk(torch, dev, base)

    # 12. 1-D bootstrap serving, fused and scan; 13. 3-D, fused.
    b1 = boot_serve(torch, "1d", run1, 0.05, scan=True)
    check_cpu_parity(torch, "1d bootstrap", run1["syn"], run1["q"],
                     b1["res"], n=32, kinds=BOOT_KINDS, ci=boot_ci())
    b3 = boot_serve(torch, "3d", run3, 0.15, scan=False)

    # 14. Planner.
    planner_path(torch, "1d", run1)

    # 15. Bootstrap times.
    bt = boot_timings(torch, "1d", run1, b1, card)
    bk = boot_kernel_times(torch, run1, bt["W"], card, base)
    del bt["W"]
    b3k = boot_kernel_3d(torch, run3, card, base)
    # Row 10 at the main path's shapes.
    tf = threefry_main_shapes(torch, run1, card)

    # 16. The degradation ladder, 1-D and 3-D.
    lad1 = ladder_path(torch, "1d", run1, card)
    lad3 = ladder_path(torch, "3d", run3, card)

    # 17. The coalescer, 1-D; rows against their padded class, 1-D and 3-D.
    padded_class_check(torch, "1d", run1)
    padded_class_check(torch, "3d", run3)
    coal = coalescer_path(torch, run1, c1, card)

    # 18. Checkpoints and faults on the 1-D stream.
    ckpt = checkpoint_path(torch, run1, run3, s1, card,
                           ROOT / "build" / "chip_smoke_checkpoints")

    # 19. Row 9 at edge shapes, then 1-D join serving and streaming; 20.
    # the same in 3-D.
    jtmp = ROOT / "build" / "chip_smoke_checkpoints"
    edge_join_err = edge_cases_join(torch, base)
    edge_epi = edge_cases_epilogue(torch)
    j1 = join_path(torch, "1d", 1, "adp", card, jtmp, seed=0, base=base)
    j3 = join_path(torch, "3d", 3, "kd", card, jtmp, seed=0, base=base)

    # 21. The partition catalog tier, 1-D: rows 1, 2 and 5 at catalog edge
    # shapes, the time-bucket lake, bench_partitions' defaults, faults and
    # a checkpoint; 22. the lake in 3-D.
    edge_cat = edge_cases_catalog(torch)
    cat1 = catalog_path(torch, "1d", c1, a1, "eq", card, run1, jtmp)
    cat3 = catalog_path(torch, "3d", c3, a3, "kd", card, run3, jtmp)

    # 23. The sharded state at D = 1, 2 and 4: build, stream and serve in
    # 1-D and 3-D, the invariance configuration, dispatch faults; 24. the
    # distributed helpers and the sharded catalog delta.
    del cs1, as1, cs3, as3
    sh1, sh3, dist24 = sharded_phases(torch, nyc_taxi, card, c1, a1, c3, a3)

    # 25. Table 1 at paper size (US, ST, AQP++, PASS at four budgets); 26.
    # fig 8's 3-D cell (KD-PASS against KD-US); 27. the legacy update path
    # and the delta codec; 28. the examples.
    tab1 = table1_phases(torch, nyc_taxi, card, run1, run3, c1, a1, c3, a3,
                         base)

    # 29. Rows 1-4, 7, 8 and 9 above 16 columns at edge shapes; 30. the
    # 24-column table at paper size through every main path.
    del c1, a1, c3, a3
    torch.cuda.empty_cache()
    edge_wide = edge_cases_wide(torch, dev, base)
    wide = wide_path(torch, card, base)

    # 16. The kernels line: serving kernels at the 1-D answer's shapes and
    # launches per answer; streaming kernels at one ingest batch (B =
    # 4096) with the launches of the whole stream (1-D for segment_reduce,
    # 3-D for route_multid); the bootstrap's kernels at the 1-D bootstrap
    # answer's shapes (R = 200) with the launches of one fused answer
    # (bootstrap_moments) or one scan answer (stratified_weighted_moments);
    # weighted_segment_reduce is on no serving path and launches 0 there.
    # Rows 2 and 5-7 carry the baseline's times (null without
    # --baseline); rows 2-4 and 6 the library call's, by events and on the
    # device.
    bb, btimes, ov = bk["bounds"], bk["times"], bk["overhead"]
    extra = {
        "query_eval": {
            "library_ms": None, "library_device_ms": None,
            "enqueue_host_ms": t1["times"]["query_eval_enqueue_host"],
            "edge_cases": len(QE_CASES), "edge_max_abs_err": edge_qe_err,
            "baseline_bit_equal": None if base is None else True,
            "ms_in_turns": t1["times"].get("query_eval_in_turns"),
            "device_ms_in_turns": t1["times"].get(
                "query_eval_device_in_turns"),
            "baseline_ms": t1["times"].get("query_eval_baseline"),
            "baseline_device_ms": t1["times"].get(
                "query_eval_baseline_device"),
            "baseline_enqueue_host_ms": t1["times"].get(
                "query_eval_baseline_enqueue_host"),
            "baseline_ms_3d": t3["times"].get("query_eval_baseline"),
            "baseline_device_ms_3d": t3["times"].get(
                "query_eval_baseline_device"),
            "device_ms_3d": t3["times"]["query_eval_device"]},
        "sample_extremes": {
            "library_ms": None, "library_device_ms": None,
            "pallas_call": None,
            "replaces_note": "no pallas_call: the jnp broadcast every JAX "
                             "backend shares",
            "enqueue_host_ms": t1["times"]["sample_extremes_enqueue_host"],
            "edge_cases": edge_se_cases + edge_ch["cases"] // 2,
            "bit_equal_to_plain": True,
            "classes_1d": t1["classes"], "classes_3d": t3["classes"],
            "device_ms_3d": t3["times"]["sample_extremes_device"],
            "plain_device_ms_3d": t3["times"][
                "sample_extremes_plain_device"],
            **pair_baseline_fields(t1, t3, "sample_extremes")},
        "stratified_moments": {
            "library_ms": btimes["bmm_stratified_moments"],
            "library_device_ms": btimes["bmm_stratified_moments_device"],
            "library": "torch.bmm, contraction only",
            "ms_x20": ov["stratified_moments_x20"],
            "enqueue_host_ms": ov["stratified_moments_enqueue_host"],
            "edge_max_abs_err": edge_sm_err,
            "baseline_bit_equal_one_chunk": None if base is None else True,
            "device_ms_3d": t3["times"]["stratified_moments_device"],
            **pair_baseline_fields(t1, t3, "stratified_moments")},
    }
    rows = []
    for name in ("query_eval", "stratified_moments", "sample_extremes"):
        source, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": run1["launches"][name],
            "launches_3d": run3["launches"][name],
            "max_abs_err": max(run1["errs"][name], run3["errs"][name]),
            "ms": t1["times"][name], "plain_ms": t1["times"][f"{name}_plain"],
            "bound_ms": t1["bounds"][name]["bound_ms"],
            "bound_by": t1["bounds"][name]["bound_by"],
            "device_ms": t1["times"][f"{name}_device"],
            "plain_device_ms": t1["times"][f"{name}_plain_device"],
            "ms_3d": t3["times"][name],
            "plain_ms_3d": t3["times"][f"{name}_plain"],
            "bound_ms_3d": t3["bounds"][name]["bound_ms"], **extra[name]})
    rows[0]["max_abs_err"] = max(rows[0]["max_abs_err"], edge_qe_err)
    rows[1]["max_abs_err"] = max(rows[1]["max_abs_err"], edge_sm_err)
    b4, b64 = kt["times"][4096], kt["times"][65536]
    for name, path_launches, err in (
            ("segment_reduce", s1["launches"],
             max(edge_seg_err, kt["seg_err"])),
            ("route_multid", s3["launches"], 0.0)):
        source, replaces = SOURCES[name]
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": path_launches[name],
            "launches_1d": s1["launches"][name],
            "launches_3d": s3["launches"][name],
            "max_abs_err": err, "ms": b4[name],
            "plain_ms": b4[f"{name}_plain"],
            "bound_ms": b4["bounds"][name]["bound_ms"],
            "bound_by": b4["bounds"][name]["bound_by"], "library_ms": None,
            "library_device_ms": None,
            "device_ms": b4[f"{name}_device"],
            "plain_device_ms": b4[f"{name}_plain_device"],
            "profiler_ops_per_call": b4[f"{name}_ops_per_call"],
            "enqueue_host_ms": b4[f"{name}_enqueue_host"],
            "device_ms_b65536": b64[f"{name}_device"],
            "plain_device_ms_b65536": b64[f"{name}_plain_device"],
            "ms_b65536": b64[name], "plain_ms_b65536": b64[f"{name}_plain"],
            "bound_ms_b65536": b64["bounds"][name]["bound_ms"],
            "baseline_bit_equal": None if base is None else True,
            "baseline_ms": b4.get(f"{name}_baseline"),
            "baseline_device_ms": b4.get(f"{name}_baseline_device"),
            "baseline_enqueue_host_ms": b4.get(
                f"{name}_baseline_enqueue_host"),
            "baseline_ms_b65536": b64.get(f"{name}_baseline"),
            "baseline_device_ms_b65536": b64.get(
                f"{name}_baseline_device")})
        if name == "route_multid":
            rows[-1].update(edge_cases=edge_s["route_cases"],
                            nonfinite_rows=edge_s["nonfinite"])
        else:
            ties = edge_s["seg_zero_ties"]
            rows[-1].update(
                zeros_device_ms=b4["segment_reduce_zeros"],
                signed_zero_cases=edge_s["seg_zero_cases"],
                baseline_zero_ties=ties,
                baseline_bit_equal=None if base is None else ties == 0)
    boot_rows = {
        "stratified_weighted_moments": {
            "launches": b1["scan_launches"]["stratified_weighted_moments"],
            "launches_path": "1d scan bootstrap answer (boot_fused=False)",
            "ms": btimes["stratified_weighted_moments"],
            "device_ms": btimes["stratified_weighted_moments_device"],
            "plain_ms": btimes["stratified_weighted_moments_plain"],
            "plain_device_ms":
                btimes["stratified_weighted_moments_plain_device"],
            "library_ms": btimes["bmm_stratified_weighted_moments"],
            "library_device_ms":
                btimes["bmm_stratified_weighted_moments_device"],
            "library": "torch.bmm, contraction only",
            "ms_x20": bk["overhead"]["stratified_weighted_moments_x20"],
            "enqueue_host_ms":
                bk["overhead"]["stratified_weighted_moments_enqueue_host"],
            "baseline_ms": bk["baseline"].get("stratified_weighted_moments"),
            "baseline_device_ms": bk["baseline"].get(
                "stratified_weighted_moments_device"),
            "classes_1d": bk["classes"]},
        "bootstrap_moments": {
            "launches": b1["launches"]["bootstrap_moments"],
            "launches_3d": b3["launches"]["bootstrap_moments"],
            "launches_path": "1d fused bootstrap answer (the default)",
            "ms": bt["times"]["bootstrap_moments"],
            "device_ms": bt["times"]["bootstrap_moments_device"],
            "plain_ms": btimes["bootstrap_moments_plain_q256"],
            "plain_device_ms": btimes["bootstrap_moments_plain_q256_device"],
            "plain_queries": PLAIN_BOOT_Q,
            "ms_q256": btimes["bootstrap_moments_q256"],
            "library_ms": btimes["bmm_bootstrap_moments"],
            "library_device_ms": btimes["bmm_bootstrap_moments_device"],
            "library": "torch.bmm, contraction only",
            "baseline_ms": bk["baseline"].get("bootstrap_moments"),
            "ms_3d": b3k["ms"], "baseline_ms_3d": b3k.get("ms_baseline"),
            "classes_1d": bk["classes"], "classes_3d": b3k["classes"]},
        "weighted_segment_reduce": {
            "launches": 0,
            "launches_path": "none: held against plain only",
            **wseg_fields(bk["wseg"]),
            "plain_ms": btimes["weighted_segment_reduce_plain"],
            "plain_device_ms":
                btimes["weighted_segment_reduce_plain_device"],
            "library": "index_add_, scatter only"},
    }
    for name, row in boot_rows.items():
        source, replaces = SOURCES[name]
        chunked = name in ("stratified_weighted_moments",
                           "bootstrap_moments")
        rows.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "max_abs_err": max(edge_w[name], bk["errs"][name],
                               edge_wch["err"] if chunked else 0.0,
                               edge_walk["err"] if chunked else 0.0),
            "bound_ms": bb[name]["bound_ms"],
            "bound_by": bb[name]["bound_by"], **row})
        if chunked:
            rows[-1]["chunk_edge_cases"] = edge_wch["cases"]
            rows[-1]["walk_edge_cases"] = edge_walk["cases"]
    # Launches on the serve layer's paths (phases 16-18), each read right
    # after its own window: one ladder tier, one coalesced tick of 16
    # tenants, one coalesced tick of 4 bootstrap tenants, the restored
    # ingestor's 32 batches.
    serve_launches = {
        "query_eval": {"launches_ladder_tier": 1,
                       "launches_coalesced_tick": coal["launches"][
                           "query_eval"]},
        "stratified_moments": {"launches_ladder_tier": 1,
                               "launches_coalesced_tick": coal["launches"][
                                   "stratified_moments"]},
        "sample_extremes": {"launches_ladder_tier": 1,
                            "launches_coalesced_tick": coal["launches"][
                                "sample_extremes"]},
        "bootstrap_moments": {"launches_coalesced_bootstrap_tick": coal[
            "bootstrap_launches"]["bootstrap_moments"]},
        "segment_reduce": {"launches_restored_stream": ckpt[
            "restored_launches"]["segment_reduce"]},
    }
    for row in rows:
        row.update(serve_launches.get(row["name"], {}))
    # Launches on the join paths (phases 19-20): one 1-D join answer, the
    # 1-D and 3-D join streams (188 batches each).
    join_launches = {
        "query_eval": {"launches_join_answer": j1["answer_launches"][
            "query_eval"]},
        "segment_reduce": {
            "launches_join_stream": j1["stream"]["launches"][
                "segment_reduce"],
            "launches_join_stream_3d": j3["stream"]["launches"][
                "segment_reduce"]},
        "route_multid": {"launches_join_stream_3d": j3["stream"][
            "launches"]["route_multid"]},
    }
    for row in rows:
        row.update(join_launches.get(row["name"], {}))
    rows.append(join_kernel_row(j1, j3, edge_join_err, base))
    rows.append(epilogue_kernel_row(j1, j3, edge_epi))
    # Launches on the catalog paths (phases 21-22), each read right after
    # its own window: one catalog answer, one partition_stats pass over
    # the 7.7 M rows; rows 1 and 2 timed at the 1-D answer's stacked
    # shape, row 5 at that pass.
    for row in rows:
        name = row["name"]
        if name in ("query_eval", "stratified_moments"):
            t1c, t3c = cat1["times_ms"], cat3["times_ms"]
            row.update({
                "launches_catalog_answer": cat1["launches"][name],
                "launches_catalog_answer_3d": cat3["launches"][name],
                "catalog_stack_strata": cat1["stack_strata"],
                "catalog_stack_strata_3d": cat3["stack_strata"],
                "ms_catalog_stack": t1c[f"{name}_stack"],
                "device_ms_catalog_stack": t1c[f"{name}_stack_device"],
                "plain_ms_catalog_stack": t1c[f"{name}_stack_plain"],
                "bound_ms_catalog_stack": t1c[f"{name}_stack_bound"],
                "ms_catalog_stack_3d": t3c[f"{name}_stack"],
                "device_ms_catalog_stack_3d": t3c[
                    f"{name}_stack_device"],
                "bound_ms_catalog_stack_3d": t3c[f"{name}_stack_bound"]})
            err = (max(edge_cat["qe_err"], cat1["stack_check"]["qe_err"],
                       cat3["stack_check"]["qe_err"],
                       cat1["stack_check"]["exact_minmax_err"],
                       cat3["stack_check"]["exact_minmax_err"])
                   if name == "query_eval" else
                   max(edge_cat["sm_err"], cat1["stack_check"]["sm_err"],
                       cat3["stack_check"]["sm_err"]))
            row["max_abs_err"] = max(row["max_abs_err"], err)
        elif name == "segment_reduce":
            row.update({
                "launches_partition_stats": cat1["stats_launches"][name],
                "launches_partition_stats_3d": cat3["stats_launches"][name],
                "partition_stats_ms": cat1["times_ms"]["partition_stats"],
                "partition_stats_device_ms": cat1["times_ms"][
                    "partition_stats_device"],
                "partition_stats_bound_ms": cat1["times_ms"][
                    "partition_stats_bound"],
                "partition_stats_ms_3d": cat3["times_ms"]["partition_stats"],
                "partition_stats_device_ms_3d": cat3["times_ms"][
                    "partition_stats_device"],
                "partition_stats_bound_ms_3d": cat3["times_ms"][
                    "partition_stats_bound"]})
            # partition_stats' sums reach ~1e13 (squared pickup times over a
            # bucket), so their error against plain stands apart, beside the
            # relative bar it was held to (LAKE_SUM_RTOL).
            row["max_abs_err"] = max(row["max_abs_err"], edge_cat["seg_err"])
            row["partition_stats_max_abs_err"] = max(cat1["stats_err"],
                                                     cat3["stats_err"])
            row["partition_stats_rtol"] = cat1["stats_rtol"]
    # Launches on the sharded paths (phases 23-24), each read right after
    # its own window: one answer on the merged synopsis, the build's fill
    # and the stream at each D, the distributed helpers and the sharded
    # catalog delta.
    def by_d(sh, key, name):
        return {D: x[key].get(name, 0) for D, x in sh["per_d"].items()}

    sharded_launches = {
        "query_eval": {
            "launches_sharded_answer": by_d(sh1, "answer_launches",
                                            "query_eval"),
            "launches_serve_queries_sharded": dist24[
                "serve_queries_sharded_q2048_launches"]["query_eval"],
            "launches_serve_samples_sharded": dist24[
                "serve_samples_sharded_sum_launches"]["query_eval"]},
        "stratified_moments": {
            "launches_sharded_answer": by_d(sh1, "answer_launches",
                                            "stratified_moments"),
            "launches_serve_queries_sharded": dist24[
                "serve_queries_sharded_q2048_launches"][
                    "stratified_moments"],
            "launches_serve_samples_sharded": dist24[
                "serve_samples_sharded_sum_launches"]["stratified_moments"]},
        "sample_extremes": {
            "launches_sharded_answer": by_d(sh1, "answer_launches",
                                            "sample_extremes")},
        "segment_reduce": {
            "launches_sharded_build_1d": by_d(sh1, "build_launches",
                                              "segment_reduce"),
            "launches_sharded_build_3d": by_d(sh3, "build_launches",
                                              "segment_reduce"),
            "launches_sharded_stream_1d": by_d(sh1, "stream_launches",
                                               "segment_reduce"),
            "launches_sharded_stream_3d": by_d(sh3, "stream_launches",
                                               "segment_reduce"),
            "launches_sharded_reoptimize": sh1["per_d"][2][
                "reoptimize_launches"]["segment_reduce"],
            "launches_build_leaf_aggregates": dist24[
                "build_leaf_aggregates_launches"]["segment_reduce"],
            "launches_catalog_delta_sharded": dist24[
                "catalog_delta_sharded_launches"]["segment_reduce"]},
        "route_multid": {
            "launches_sharded_build_3d": by_d(sh3, "build_launches",
                                              "route_multid"),
            "launches_sharded_stream_3d": by_d(sh3, "stream_launches",
                                               "route_multid")},
    }
    for row in rows:
        row.update(sharded_launches.get(row["name"], {}))
    rows.append(threefry_row(tf, edge_tf, b1, b3, s1, s3, j1, j3, coal,
                             ckpt, by_d(sh1, "stream_launches", "threefry"),
                             by_d(sh1, "build_launches", "threefry")))
    table1_rows(rows, tab1)
    by_name = {r["name"]: r for r in rows}
    for r in wide_rows(wide, edge_wide):
        by_name[r["name"]]["wide"] = r["wide"]
        by_name[r["name"]]["max_abs_err"] = max(
            by_name[r["name"]]["max_abs_err"], r["wide"]["max_abs_err"])
    emit(phase="table1 summary", card=card, **table1_summary(tab1))
    emit(phase="sharded summary", card=card,
         **sharded_summary(sh1, sh3, dist24))
    emit(phase="catalog summary", card=card, **{
        tag: {"cold_first_answer_s": x["cold_first_answer_s"],
              "flat_build_first_answer_s": x["flat_build_first_answer_s"],
              "answer_ms": x["times_ms"]["answer"],
              "answer_host_ms": x["times_ms"]["answer_host"],
              "stage_host_ms": x["times_ms"]["stage_host"],
              "device_busy_ms": x["times_ms"]["device_busy"],
              "kernels_per_answer": x["times_ms"]["kernels_per_answer"],
              "builds_per_batch": x["times_ms"]["builds_per_batch"],
              "lru_hits_per_batch": x["times_ms"]["lru_hits_per_batch"],
              "peak_mb": x["answer_peak_mb_above_resident"],
              "sum_median_rel_err": x["quality"]["sum_median_rel_err"],
              "seconds": x["seconds"]}
        for tag, x in (("1d", cat1), ("3d", cat3))},
        bench={k: cat1["bench"][k] for k in (
            "flat_build_answer_ms", "catalog_ms", "speedup_x",
            "materialized")})
    emit(phase="join summary", card=card, **{
        tag: {"answer_join_ms": j["times_ms"]["answer_join"],
              "answer_join_host_ms": j["times_ms"]["answer_join_host"],
              "device_busy_ms": j["times_ms"]["answer_join_device_busy"],
              "kernels_per_answer": j["times_ms"]["kernels_per_answer"],
              "peak_mb": j["answer_peak_mb_above_resident"],
              "join_epilogue_device_ms": j["times_ms"][
                  "join_epilogue_device"],
              "join_epilogue_plain_device_ms": j["times_ms"][
                  "join_epilogue_plain_device"],
              "join_answer_in_turns_ms": j["times_ms"][
                  "join_answer_in_turns"],
              "join_answer_plain_epilogue_in_turns_ms": j["times_ms"][
                  "join_answer_plain_epilogue_in_turns"],
              "row9_in_turns_with_baseline": j["times_ms"].get("in_turns"),
              "ingest_ms_per_batch": j["stream"]["ingest_ms_per_batch"],
              "sum_median_rel_err": j["quality"]["sum_median_rel_err"]}
        for tag, j in (("1d", j1), ("3d", j3))})
    emit(phase="serve summary", ladder_1d=lad1["tiers"],
         ladder_3d=lad3["tiers"], tier0_host_ms={
             "1d": lad1["tier0_host_ms"], "3d": lad3["tier0_host_ms"]},
         coalesced_round_ms=coal["coalesced_round_ms"],
         sequential_round_ms=coal["sequential_round_ms"],
         checkpoint={k: ckpt[k] for k in ("stream_file_mb", "save_s",
                                           "restore_s", "syn3d_file_mb",
                                           "save3d_s", "restore3d_s")})
    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print_ok(torch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
