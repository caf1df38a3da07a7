#!/usr/bin/env python3
"""Drive the PyTorch port of SOAR (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N] [--parent DIR]

Phases (any failure exits nonzero; nothing is caught). Each path below is
driven with every kernel's launch counter set to 0 just before and read
just after, and fails if one of its kernels was never launched:
  1. device: nvidia-smi's name and power limit, torch's device name;
  2. build: nvcc builds the CUDA kernels from src/repro_torch/csrc;
  3. main path at GloVe-100-angular's shape (ann-benchmarks
     glove-100-angular: 1,183,514 x 100, 10k queries; here n=1,000,000,
     d=100, nq=10,000 from make_manifold(seed)) with ScaNN's published
     ann-benchmarks config for that set (num_leaves=2000, dims_per_block=2,
     so 50 PQ subspaces): build_ivf_sharded (SOAR lam=1, f32 rerank, and a
     tree router at the JAX package's defaults: 45 supers, t_route 6) ->
     pack_ivf -> search_jit_batched through the flat router (top_t=40,
     final_k=10, rerank_budget=256, bq=128), cold then warm (QPS from the
     first warm run, and the median of five warm runs beside it). Checks
     recall@10 >= 0.85 against exact search, one selecting-scorer launch
     per tile, ids agreeing on >= 99% of slots with the same search
     through the selecting scorer's plain version, and the index's whole (n x 2) assignment
     matrix agreeing on >= 99.9% of rows per column with assign_shards run
     through the plain vq and soar versions; prints the spill phase run
     again warm (host clock) and one shard's assign_fused (CUDA events),
     and one warm tile's stage times (route, LUT, the selecting
     scorer, dedup, rerank) and the warm search's own peak memory
     (kernels: Lloyd, vq_assign, soar_assign, pq_score_probes_select,
     kmeans_pp);
  4. tree-routed search of the same queries through the index's tree
     router, warm: recall@10 >= 0.85, one tree_route launch per tile, ids
     agreeing on >= 99% of slots with the same search through the plain
     route (kernels: tree_route, pq_score_probes_select);
  5. filtered tree-routed search with seeded bitmaps keeping 1% and 0.1%
     of the points, each with and without the escalated second pass:
     every returned id passes the filter, and recall@10 against exact
     filtered search is no lower with escalation;
  6. dense PQ scan of 128 queries over every code row of the index through
     kernels.ops.pq_score, plus the coarse term, best row per point, top-10
     (kernel: pq_score): ids agree on >= 99% of slots with the same scan
     through the plain scorer;
  7. tombstones on the card: the main packed table with 20% of each
     partition's live slots set to -1 in place (the extent kept, sizes the
     live count), searched flat: no row returns a -1 while its window holds
     2 * final_k live slots, and ids agree on >= 99% of slots with the same
     search through the selecting scorer's plain version (kernel:
     pq_score_probes_select);
  8. k-means modes on the first 131,072 rows, c = 2,000: train_kmeans with
     init="parallel", batch_size=16,384, spherical=True, the full-batch
     k-means++ baseline, and the baseline with the Lloyd sweep's plain
     version ("plain Lloyd"); distortion and seconds of each, and the
     parallel and mini-batch distortion no more than 5% above the
     baseline's (kernels: Lloyd, and kmeans_pp, one launch a seeding, in
     every mode but "parallel", which launches none);
  9. variant A, the sharded build as the paper and ScaNN serve GloVe:
     build_ivf_sharded(spill_mode="soar", n_spills=2, lam=1,
     anisotropic_T=0.2 (ScaNN's anisotropic_quantization_threshold in its
     ann-benchmarks glove-100-angular config), rerank="int8",
     pq_subspaces=50), then the flat search cold and warm: build phases,
     memory_bytes("int8"), recall@10 >= 0.85 beside the main path's, QPS,
     peak memory; the three columns of every row distinct, each column
     agreeing on >= 99.9% of rows with assign_shards through the plain vq
     and soar versions, and the int8 codes and scales of the first 65,536
     rows equal to the CPU quantization's (kernels: Lloyd, vq_assign,
     soar_assign, pq_score_probes_select, kmeans_pp; the search reranks
     the int8 rows on int8_rerank);
 10. variant B, the monolithic build on anisotropic primaries:
     build_ivf(spill_mode="soar", n_spills=1, anisotropic_T=0.2,
     rerank="f32", pq_subspaces=50) over all 1,000,000 rows, then the flat
     search: build phases, recall@10 >= 0.85, QPS, peak memory, and the
     spill column agreeing on >= 99.9% of rows with soar_assign_ref on the
     card (kernels: Lloyd, soar_assign, pq_score_probes_select, kmeans_pp).
     Phases 9-10
     count the calls of the build's plain-torch work (the spill columns
     after the first, anisotropic_assign, the anisotropic update's normal
     equations and solve, int8_quantize), which no Pallas kernel computes
     in the JAX package;
 11. serving: the main index of phase 3 wrapped by MutableIVF.from_index
     behind AnnEngine(top_t=40, rerank_budget=256, bq=128); the 10,000
     queries cold and warm through search_request (ids equal to phase 4's
     tree search on >= 99.9% of slots: the same index at the capacity
     width); ten rounds each hard-removing 1,000 random live ids,
     re-adding their vectors (new ids), delta-packing and searching one
     128-query tile, each step's host-clock ms after a synchronise, and
     the delta pack held bit for bit against a full repack
     (invalidate_snapshots) in part_ids, part_codes, sizes, extent and the
     live rerank rows; 10,000 soft removals searched through the standing
     filter, then harden_soft_deletes and compact (ms). Checks: no removed
     or soft-removed id ever returned; the last round's re-added vectors
     find their new id in their own top 10 on >= 90% of rows (top 1
     printed beside it; under MIPS a larger-norm point may outrank a
     point's own); rebuild_reference -> pack_ivf -> the same search gives
     the engine's ids under the id map on >= 99.9% of slots (identity
     expected: the assignment kernels and the s = 2 PQ encode are
     row-independent); search_numpy over to_ivf_index() for 1,000 queries
     (top_t 40, rerank_budget 256) has recall@10 >= 0.85 against exact
     search of the live rows, with its QPS and agreement with the engine.
     Prints the phase's peak memory (kernels: vq_assign, soar_assign,
     tree_route, pq_score_probes_select);
 12. paper metrics at the main path's shape: the exact top 100 of the
     10,000 queries, then KMR curves (kmr_curve) of the main index (SOAR,
     lam=1) and of build_ivf_sharded(spill_mode="none") and ("naive") on
     the main index's codebook and PQ (one rank space). Checks: each curve
     non-decreasing, ending at recall 1.0 and at n_assignments points;
     naive's and SOAR's recall at every t >= none's; rank_statistics of
     the first 1,000 queries on the card equal to the same call on CPU
     copies on >= 99.9% of (query, neighbour) entries. Prints
     points_to_recall at 0.8 / 0.9 / 0.95 / 0.99 for each index, the
     score-error and angle correlations of naive and SOAR (pair_stats;
     the paper's Figs 4, 7, 9), the phase's seconds and peak memory; the
     two extra builds are freed after it (kernels: vq_assign, soar_assign);
 13. durability, from phase 11's engine after its rounds: AnnEngine.save
     into a temporary directory (bytes, seconds, GB/s); AnnEngine.open on
     the card equal to the saved engine bit for bit (part_ids,
     part_codes, sizes, rerank, assignments, alive, centroids, PQ, the
     counters, wal_seq, the router's tables) and its ids equal on every
     slot of the 10,000 queries; then a log attached (fsync "always"),
     three rounds of 1,000 hard removals and re-adds, 1,000 soft removals
     and harden_soft_deletes; a second engine opened from the snapshot
     and the log equal to the live one bit for bit, with equal ids on
     every slot, its replayed adds launching vq_assign and soar_assign;
     one byte of arrays.bin flipped, after which open raises
     CorruptSnapshotError. Prints replay seconds and the log's bytes
     (kernels: vq_assign, soar_assign, tree_route, pq_score_probes_select);
 14. the serving front-end (PR 19) in front of phase 11's engine as phase
     13 left it (about 1,000,000 live points, tree-routed): first each
     query's bits alone against its bits inside batches of 2 to 200 (every
     bucket 8-128; the engine pads to the bucket and runs every tile at
     BQ rows) and a one-query request's host ms before and after that
     repair; (a) 32 closed-loop client threads of 100 single-query
     requests, half of them under 4 tenants (seeded 10% subsets of the live
     ids), through ServingFrontend(policy="local", max_batch=128,
     max_delay_ms=2, default_deadline_ms=50) and, beside it, calling the
     engine directly under one lock (QPS, p50 / p99 ms, mean dispatch);
     every front-end result equals the engine's answer to the same query
     alone after close(), ids and scores, tenant results lie in tenant ∧
     alive, stats["coalesced"] > 0 and one bitmap fill per tenant; (b) 16
     searching clients while a mutator removes 1,000 live ids and re-adds
     their vectors under a tenant, ten rounds: no id returned at or after
     the epoch of its removal, each client's epochs monotone, the last
     round's vectors in their own top 10 under their tenant on >= 90%;
     (c) a 1,024-query burst into a 256-unit shed-oldest queue behind a
     300 ms engine:search delay (every Future done, some shed), a 1 ms
     deadline queued behind it expiring, a transient fault absorbed by
     two retries, an error failing only its group, a BaseException failing
     the queued Future and every later submit; (d) make_replicated_search
     over two replicas on the one card equal to the local path on every
     slot of the 10,000 queries, and the front-end saved with its tenants
     and reopened on the card, equal on every slot (kernels: tree_route,
     pq_score_probes_select, vq_assign, soar_assign);
 15. the kNN attention memory (PR 19) of one (layer, KV head) of
     granite-3-2b (head_dim 64, 4 query heads a KV head): 8 sequences x
     32,768 positions = 262,144 keys from make_manifold (intrinsic dim
     10), seeded normal values, each sequence a segment; KNNMemory.build
     (SOAR lam=1, c = 1,024); key recall and attention error at top_t 8 /
     16 / 32 / 64 on the first queries; 64 decode steps, each appending one
     position per sequence (one add call), retrieving k = 32 for each
     sequence's 4 query heads within its segment (top_t 32), attending,
     and one recency-4,096 request, on engine "jit" and again on "numpy"
     from the same built memory: every id in its segment and window,
     key-recall@32 against exact top-32 within the segment >= 0.85, mean
     attention-output error < 0.15; at top_t 2 SOAR's key recall >= a
     spill_mode="none" memory's - 0.02; the decoded memory saved and
     reopened equal bit for bit, retrievals equal on every slot (kernels:
     Lloyd, vq_assign, soar_assign, kmeans_pp);
 16. the shard-parallel search at the JAX package's production
     shard (src/repro/launch/ann_dryrun.py: 1,000,000 vectors and 2,500
     partitions a shard, d = 100, 1,024 queries, PQ m = d / 4 = 25), four
     shards on the one card (4,000,000 vectors from make_manifold(seed + 7)):
     build_sharded_ivf_pq (SOAR lam=1, f32 rerank) and the same four
     builds with router="tree" at its defaults (50 supers, t_route 7),
     stacked by stack_tree_routers (their stacks equal build_sharded_ivf_pq's
     bit for bit), seconds of each; make_sharded_assign over
     [cuda:0, cuda:0] equal to one assign_fused call on every row; the
     f32 and PQ makers (top_t 40, final_k 10, rerank_k 256, q_chunk 128),
     flat and tree-routed, and filtered through shard_filters by a seeded
     20% mask: cold, then five warm runs (median seconds, QPS, the merge's
     device ms and the local search's ms apart), recall@10 against exact
     search over all 4,000,000 vectors >= 0.85 (f32, PQ), >= 0.70 and
     >= 0.65 (tree f32, tree PQ: the JAX package's bars), filtered recall
     against the filtered exact top 10 >= 0.85 with every id in the mask;
     the PQ and tree-routed searches through the selecting scorer's plain
     version and the plain route agree on >= 99% of slots; HealthTracker masks: all ones
     gives the same bits, shard 2 down returns none of its ids, no -1,
     and every healthy answer of the full search; save_sharded of the four
     shards, load_sharded onto the card, the re-stack and its search
     equal bit for bit (bytes, seconds, GB/s); then two ranks of a gloo
     group (processes, file store, GLOO_SOCKET_IFNAME=lo, a time limit
     on the wait) each load the envelope, keep their two shards
     (local_shards) and run make_distributed_search_pq(group=...): both
     ranks' ids and scores equal the in-process search bit for bit, with
     each rank's collective ms. Peak memory and the phase's seconds
     (kernels: Lloyd, vq_assign, soar_assign, tree_route,
     pq_score_probes_select, kmeans_pp);
 17. the contracts of repro_torch.analysis on the card at the main path's
     width, over the hand-written kernels: each of the 11 registered
     contracts traced by the contracts' op recorder (a TorchDispatchMode
     that keeps each aten op's output shapes, dtypes and devices) through
     drive(), after one warm run: one 128-row tile of phase 3's index
     through search_jit_batched flat, tree-routed, and filtered at 1% with
     escalation, search_jit and the tree route at that tile, assign_fused
     and pq_encode on 65,537 rows, lloyd_sweep on 131,071 (primes), the
     replica fan-out (256 queries) and make_sharded_assign (131,074 rows)
     over [cuda:0, cuda:0], and both shard-parallel makers over phase 16's
     4 x 1,000,000 stack (64 queries, one tile a shard; n is a shard's);
     every search and shard-parallel trace also runs under
     torch.cuda.set_sync_debug_mode("error"). Prints each trace's op
     count, largest output that is not a view (op, shape, bytes), the host
     seconds of the warm and the recorded run, and findings; fails on any
     finding (kernels: every one of phase 3's and the tree route);
 18. each kernel against its plain PyTorch version on the paths' own
     inputs, with its time (CUDA events), the plain version's time and the
     least time the card could take: the larger of bytes / 3.35 TB/s and
     the operations' time, where f32 products (x·cᵀ) count at the TF32
     tensor-core peak three times over (3xTF32, f32 accuracy: 495 TFLOP/s)
     and other f32 work at 67 TFLOP/s (the H100 SXM's published peaks);
     the assignment kernels also print the f32 SIMT figure beside it, the
     vq and soar records the time cuBLAS takes for their products alone
     (product_ms: torch.mm of the shard by the codebook, TF32 off, once
     for vq and twice for soar; a yardstick the port never calls), and
     the Lloyd record gives its launches by shape and the device times of
     its assignment and grouping phases apart (each queued behind a longer
     kernel, so host overhead between launches is not counted); the tree
     route and the dense scorer are timed the same way (device time
     alone), the route also at a second shape that stands for c = 32,768
     at the router's defaults (seeded tables, S = 181, t_route = 23,
     cmax = 256) and at a third, phase 16's shard router ("shard_router":
     shard 0's stacked tables on one 64-query tile, its S, cmax and the
     t_route its search gives it, with phase 16's launches of the route),
     with its wrapper's and the whole router call's host
     microseconds per call (host clock over many calls, no synchronisation
     between them); the int8 rerank on one tile's budget (the dedup of the
     select's slots) over the main rows quantized, with the f32 rerank over
     the rows dequantized beside it (f32_chain_ms, the search's f32 path:
     the yardstick); with --parent DIR (a checkout of the parent commit,
     unpacked beside this one) the parent's route and dense kernels are
     built from DIR and timed on the same inputs in the same way
     ("parent_ms", null without it); the vq and soar records also give
     the kernel at the online inserts' batch (1,000 rows, "online"); the
     dense record also gives its
     lookup floor: n * nq * m LUT lookups at 32 four-byte words a clock an
     SM (the 128 bytes an SM's shared memory delivers), at the card's SM
     count and its maximum SM clock (nvidia-smi); then the plain-torch work
     of phases 9-10 timed the same way at the build's shapes, each beside
     its calls and its bound (bytes / 3.35 TB/s against f32 operations /
     67 TFLOP/s), on a "plain work" line; the probe scorer's record also
     gives it at phase 16's m = 25 ("m25", one 64-query tile of shard 0,
     queued behind a longer kernel over 10 launches and over 50: timed back
     to back, the tile's time followed the host), and its selecting form
     ("pq_score_probes_select", kernel and merge) on the same tile's
     probes, beside the window form followed by the id gather, the mask
     and torch.topk it replaces ("window_chain_ms", the yardstick); the
     seeding kernel at the
     codebook's shape (32,768 sample rows x 100, c = 2,000) and at PQ's
     (50 subspaces x 32,768 rows x 2, c = 16) on small integer
     coordinates, where every f32 dot is exact, equal to its plain loop on
     the card bit for bit; on phase 8's manifold sample twice bit for bit,
     its c seeds c distinct rows of the data; its bound counts X, u and
     the centres once and 2 n d f32 operations a pick (the distances; the
     kernel waits on two team barriers a pick, so it is bound by latency,
     not by either), and it is also timed at deep10m's codebook shape
     (32,768 x 96, c = 32,768: "c32k").
     "launches" of a kernel sum every driven path above but the filtered
     one of phase 5, and phase 21's;
 19. the LM serving path, after phases 1-18's tensors are freed,
     through drive() with no kernel needed (it launches none of the six;
     its counts, all 0, are printed and not added to "launches"):
     granite-3-2b (src/repro_torch/configs/granite_3_2b.py) at full width
     and depth (40 layers, d 2,048, 32 query heads over 8 KV heads,
     head_dim 64, SwiGLU 8,192, vocab 49,155 padded to 49,408), f32
     parameters from init_params(seed), bf16 compute, served by
     ServeEngine: 8 prompts of 4,096 tokens (train_4k's length; numpy,
     seed), 128 new tokens each, max_seq 4,224 (decode_32k's 128 x 32,768
     would need about 340 GB of KV cache). A warm-up (prefill and one
     step), then two runs: ids
     equal bit for bit (a), none >= vocab_padded (d); prefill seconds and
     tokens/s, decode ms a step (median of 127) and tokens/s, parameter,
     bf16-copy and KV-cache bytes, the phase's peak memory, each beside
     nvidia-smi's name and power limit and beside two bounds: decode =
     (bf16 group weights + the f32 head + final norm + one read of the
     whole KV cache) / 3.35 TB/s, prefill = (2 x group parameters x
     tokens + 4 x B x S^2 x heads x head_dim x attention layers) / 989
     TFLOP/s bf16. In f32 on the same parameters: decode_step after
     prefill of 255 tokens against the forward's last logits within 1e-3
     (b); 4 greedy ids of ServeEngine against the argmax of repeated full
     forwards, a difference allowed only at a top-2 gap below 1e-3 and
     printed (c). One prefill and one decode step again under
     torch.profiler (the device's kernel ms, kernels launched, the six
     costliest kernels, the idle share against the host-clock times) and
     the step under the contracts' OpRecorder (aten ops, host syncs).
     Beside it, each twice and bit for bit: xlstm-350m at
     full width and depth (8 x 1,024 tokens, 64 new), qwen3-moe-30b-a3b at
     full width cut to 2 of its 48 layers (8 x 1,024, 32 new; (b) at
     capacity_factor 8), and every registered architecture's smoke config
     on the card against the same f32 parameters on the CPU (logits within
     1e-4), prefill -> decode against the forward, bf16 ids twice. Prints
     "lm ..." lines and one "lm serving: {...}" JSON line;
 20. LM training, after phase 19's tensors are freed, through drive()
     with no kernel needed (launches all 0, printed and not added):
     (a) granite-3-2b at full width and depth, f32 parameters and AdamW
     state, bf16 compute, remat="block", Markov batches from
     for_model(cfg, 4,096 tokens (train_4k's length), global batch 8
     (train_4k's 256 is a pod's), seed), accum 4 (micro-batches of 2),
     through train(): one warm-up step, three timed; every loss and
     grad_norm finite, the first loss within 0.5 of a random model's
     ln(vocab_padded) + 1/2 (logits of variance 1), lr equal to
     warmup_cosine's at each step, every leaf changed; step seconds
     (median), tokens/s, the AdamW update's ms (CUDA events), peak memory,
     beside two bounds: the step's FLOPs at 989 TFLOP/s bf16 (8 a group
     parameter a token: forward, remat recompute, backward; the head's 6;
     attention's 16 B S^2 heads head_dim a layer) and the update's bytes
     at 3.35 TB/s (params, grads, m, v read; params, m, v written); one
     more step under torch.profiler (device busy ms, kernels, the six
     costliest, idle share). (b) at full width cut to 4 layers and 1,024
     tokens: two 4-step runs from one seed equal bit for bit; a run whose
     on_log sends SIGTERM to its own process after step 2 saves and
     exits, and a fresh train() resumes it from its CheckpointManager to
     step 4, equal to the uninterrupted run bit for bit; one save timed
     (bytes, seconds, GB/s) and restored onto the CPU bit for bit. (c)
     accum 1 against 4 on one global batch (loss rtol 2e-4, parameters
     rtol 6e-3 / atol 5e-4, JAX's bars). (d) one f32 train step of every
     smoke config on the card against the CPU (loss 1e-5 relative, m 1e-4
     of its scale, parameters atol 1e-4 = the step's lr). (e) two gloo
     ranks on cuda:0 (`--job train`): the compressed all-reduce and three
     error-feedback steps on a 2,048 x 2,048 leaf equal to the same calls
     on CPU copies bit for bit; the two-stage pipeline at 4 layers, M = 4
     micro-batches of 1 x 1,024 (f32), by group= in the ranks and by
     devices=[cuda:0, cuda:0] here, loss within 1e-5 and the wq and
     embed gradients within 2e-4 of the sequential ones; expert
     parallelism at ep 2 over qwen3-moe-30b-a3b at full width cut to 2
     of 48 layers (f32, 2 x 1,024 tokens): loss within 1e-5 and every
     gradient within 1e-4 of its scale against the dense path. Prints
     "lm train ..." lines and one "lm training: {...}" JSON line;
 21. the launchers, after phase 20's tensors are freed: (a) the ANN dry
     run (repro_torch.launch.ann_dryrun) of both meshes (256 and 512
     shards of 1,000,000 x 100, 2,500 partitions, PMAX 1,000, 1,024
     queries, top_t 40, k 10) and both variants (f32 and PQ m = 25),
     counted on meta tensors through a fake process group by the op
     analysis (launch/op_analysis.py), each printed with fmt_summary
     beside nvidia-smi's name and power limit: collective bytes =
     D x nq x k x 8 and product FLOPs = route + LUTs + rerank (PQ) or
     route + window (f32); (b) one shard at that size built from
     make_manifold(seed + 7) (PQ 25), its 1,024 queries searched through
     make_distributed_search_pq(group=) of a one-rank NCCL group on
     cuda:0 (so the all-gather runs) through drive() with the selecting
     probe scorer required, then the group destroyed and the dry run made
     of the same shard at world 1 and its pmax: argument bytes equal the
     real tensors' bytes, product FLOPs equal the real search's (the op
     analysis over it) and the formula, the dry run's selecting-scorer
     calls equal the launches, collective bytes equal; the same search
     once more on the selecting scorer's plain version, each of its
     tiles' real arguments also given to the kernel: every tile's scores
     within 1e-5, its ids equal where the scores are, ids >= 99% equal; prints the step (CUDA
     events, median of 5 warm) beside its needed-bytes bound (the
     distinct probed partitions' rows up to their extent and the
     distinct rerank rows read once) and beside the dry run's
     bound_step_s (an eager-byte estimate), each with its share, and the
     peak (the arguments plus max_memory_allocated's rise) beside the
     predicted peak_bytes; (c) `python -m
     repro_torch.launch.serve --arch granite-3-2b --device cuda` and (d)
     the four examples/torch/*.py (train_lm at EX_TRAIN_STEPS steps),
     each a process, all started together, with a time limit: exit 0,
     their lines printed ("launcher ..."). One "launchers: {...}" JSON
     line; (b)'s launches are added to the kernels' "launches";
 22. the sharded LM (PR 25), after phase 21's tensors are freed, through
     drive() with no kernel needed (launches all 0, printed and not
     added). One card holds one NCCL rank (NCCL refuses two ranks on one
     GPU), so the mesh is 4 gloo ranks on cuda:0 (`--job mesh`), as
     phases 16 and 20 ran theirs: a (2, 2) ("data", "model") DeviceMesh,
     parameters placed as DTensors by granite-3-2b's logical rules (FSDP
     over "data", TP over "model"; launch/mesh.py). (a) training at full
     width cut to 4 of its 40 layers, f32 parameters and AdamW state,
     bf16 compute, 4 x 1,024 tokens (the batch over "data"), 3 steps from
     init_params(seed) on seeded numpy batches, held against the same
     steps unsharded on the same card (rank 0): loss within
     MESH_BF16_LOSS_BAR (twice JAX's own sharded-vs-single gap at bf16);
     then one f32-compute step, loss and parameters within 1e-5 of the
     unsharded step; step seconds, peak memory per rank, and the second
     step counted by the op analysis on every rank (product FLOPs,
     collective bytes). (b) serving at full width and depth with bf16
     weights under serve_rules: 8 prompts of 512 tokens prefilled, then
     64 decode steps fed the unsharded run's greedy ids (computed here):
     each step's max |logit difference| / max |logit| <= 2e-2 and argmax
     agreement >= 0.99; prefill seconds, decode ms a step, peak memory
     per rank. (c) the LM dry run (launch/dryrun.run_cell) of
     granite-3-2b's four shapes on both production meshes (meta tensors,
     fake groups of 256 / 512), in DRYRUN_WORKERS processes started when
     the phase starts, each line printed with its trace seconds, and
     profile_cell's top contributors of train_4k; and (a)'s cell counted
     here on meta over a fake (2, 2) group, its product FLOPs, collective
     kinds and bytes and argument bytes equal to what rank 0 counted of
     its real step. Prints "mesh ..." lines and one "mesh: {...}" JSON
     line;
 23. the {"kernels": [...]} line, then the device line, last.

It imports nothing of JAX and nothing of the JAX package (src/repro).
"""
from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from collections import Counter
from contextlib import ExitStack, contextmanager
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

N, D, NQ = 1_000_000, 100, 10_000
C, M = 2000, 50
TOP_T, FINAL_K, BUDGET, BQ = 40, 10, 256, 128
TRAIN_SAMPLE, SHARD = 131_072, 65_536
SELECTIVITIES = (0.01, 0.001)      # filtered phase: shares of points kept
ROUNDS, CHURN, SOFT = 10, 1000, 10_000  # serving phase: mutation rounds, ids a round, soft removals
HOST_NQ = 1000                     # serving phase: queries of the host engine
KMR_K, KMR_TARGETS = 100, (0.8, 0.9, 0.95, 0.99)  # paper metrics: neighbours, recall targets
RANK_NQ = 1000                     # paper metrics: queries whose ranks are checked on the CPU
WAL_ROUNDS = 3                     # durability: logged rounds of CHURN removals and re-adds
TENANTS, FE_CLIENTS, FE_REQS = 4, 32, 100  # front-end: tenants, client threads, requests each
BURST = 1024                       # front-end: queued single queries under a 256-unit queue
# kNN memory: one (layer, KV head) of granite-3-2b (src/repro/configs/granite_3_2b.py:
# head_dim 64, 32 query heads over 8 KV heads, so GQA = 4 query heads a memory), 8
# sequences x 32,768 cached positions (Memorizing Transformers' largest memory, 262,144)
HEAD_DIM, GQA, MEM_SEQS, MEM_N = 64, 4, 8, 262_144
MEM_STEPS, K_MEM, RECENCY = 64, 32, 4096   # decode steps, keys retrieved, recency window
MEM_TOP_T = 32                     # partitions probed: 3% of c = 1,024
SPILL_NQ = 512                     # queries of the SOAR-against-none check at top_t 2
ANISO_T = 0.2                      # ScaNN's glove-100-angular anisotropic threshold
DENSE_ROWS = 1_000_000             # code rows of the dense kernel check
# shard-parallel phase: the JAX package's production shard (src/repro/launch/ann_dryrun.py:
# 1,000,000 vectors and 2,500 partitions a shard, d = 100, 1,024 queries, PQ m = d / 4)
SH_D, SH_N, SH_C, SH_M, SH_NQ = 4, 1_000_000, 2_500, 25, 1024
SH_QCHUNK, SH_FILTER, SH_DOWN = 128, 0.2, 2   # JAX's q_chunk, filter share, the shard down
RANK_TIMEOUT = 300                 # seconds the two gloo ranks may take
# LM serving phase: granite-3-2b (src/repro_torch/configs/granite_3_2b.py) at full width
# and depth, 8 prompts of train_4k's 4,096 tokens (models.config.SHAPES) and 128 new
# tokens each; decode_32k's 128 x 32,768 (about 340 GB of KV cache) does not fit one card
LM_ARCH, LM_B, LM_PROMPT, LM_NEW = "granite-3-2b", 8, 4096, 128
LM_CHECK_B, LM_CHECK_S, LM_CHECK_NEW = 2, 256, 4   # the f32 checks (b) and (c)
XLSTM_PROMPT, XLSTM_NEW = 1024, 64                # xlstm-350m at full width and depth
MOE_LAYERS, MOE_PROMPT, MOE_NEW = 2, 1024, 32     # qwen3-moe-30b-a3b, depth cut from 48
# LM training phase: granite-3-2b at full width and depth, train_4k's 4,096 tokens
# (models.config.SHAPES) at a global batch of 8 (train_4k's 256 is a pod's), micro-batches
# of 2 (accum 4); (b)-(c) at full width cut to 4 layers and 1,024 tokens; (e) the
# two-stage pipeline at 4 layers, M = 4 micro-batches of 1 x 1,024, and expert
# parallelism over qwen3-moe-30b-a3b cut to 2 of its 48 layers, 2 x 1,024 tokens
TR_SEQ, TR_BATCH, TR_ACCUM, TR_STEPS, TR_LR = 4096, 8, 4, 4, 3e-4
TR_CUT_LAYERS, TR_CUT_SEQ = 4, 1024
TR_PIPE_M, TR_PIPE_S, TR_EP_B, TR_EP_S, TR_GRAD = 4, 1024, 2, 1024, 2048
# sharded LM phase: granite-3-2b over a (2, 2) ("data", "model") mesh of 4 gloo ranks on
# the one card; (a) training at full width cut to 4 of 40 layers, 4 x 1,024 tokens; (b)
# serving at full width and depth, 8 prompts of 512 tokens and 64 teacher-forced steps
MESH_SHAPE, MESH_LAYERS, MESH_B, MESH_S, MESH_STEPS = (2, 2), 4, 4, 1024, 3
MESH_SERVE_B, MESH_PROMPT, MESH_NEW = 8, 512, 64
MESH_TIMEOUT = 900          # seconds the mesh ranks and the dry-run workers may take
# (a)'s bf16 bar: twice JAX's own sharded-vs-single relative loss gap at bf16 compute
# (1.59e-4, the largest of the 3 steps of tests/test_torch_sharding.py's SPMD step)
MESH_BF16_LOSS_BAR = 3.2e-4
# (c): each worker a list of granite-3-2b's dry-run cells (shape:mesh); "profile"
# prints the cell's top contributors (launch/profile_cell.py)
DRYRUN_WORKERS = ("train_4k:single:profile",
                  "train_4k:multi,decode_32k:single,decode_32k:multi,long_500k:single,"
                  "long_500k:multi",
                  "prefill_32k:single,prefill_32k:multi")
EX_TRAIN_STEPS = 100       # examples/torch/train_lm.py's steps (its default is 300)
LAUNCH_TIMEOUT = 400       # seconds the serve CLI and the examples may take
PEAK_BYTES_S, PEAK_F32_S, PEAK_TF32_S = 3.35e12, 67e12, 495e12
PEAK_BF16_S = 989e12   # the H100 SXM's dense bf16 tensor-core peak
SMEM_WORDS_CLK = 32    # 4-byte words an SM's shared memory delivers a clock (128 B)
DEVICE = "cuda"


def sync():
    torch.cuda.synchronize()


def time_ms(fn, reps: int = 10) -> float:
    """Mean device milliseconds of fn() over reps launches, after a warm-up."""
    fn()
    sync()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, busy, reps: int = 10) -> float:
    """Mean device milliseconds of fn()'s launches alone: each round first
    queues busy() (a longer kernel), so the host has queued all of fn's
    launches before the device reaches them and host overhead between
    them does not count."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    total = 0.0
    for r in range(reps + 1):
        busy()
        start.record()
        fn()
        end.record()
        end.synchronize()
        if r:                                   # the first round warms up
            total += start.elapsed_time(end)
    return total / reps


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds per call of fn() over `calls` calls with no
    synchronisation between them: the wrapper's own cost while the device
    works behind it."""
    fn()
    sync()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = time.perf_counter() - t0
    sync()
    return t / calls * 1e6


def parent_build(parent: Path):
    """The kernel builder of the checkout at `parent` (loaded from its
    file, so it builds that checkout's sources into its own build/)."""
    spec = importlib.util.spec_from_file_location(
        "parent_build", parent / "src" / "repro_torch" / "kernels" / "_build.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.library()
    return mod


def tree_tables(seed: int, S: int, cmax: int, d: int, device):
    """Seeded router tables with ragged children (-1 padded, zero rows),
    as `train_tree_router` lays them out."""
    g = torch.Generator().manual_seed(seed)
    SC = torch.randn((S, d), generator=g)
    CC = torch.randn((S, cmax, d), generator=g)
    pad = torch.rand((S, cmax), generator=g) < 0.25
    pad[:, 0] = False
    CH = torch.where(pad, -1, torch.arange(S * cmax).reshape(S, cmax)).to(torch.int32)
    CC[pad] = 0.0
    return SC.to(device), CC.to(device), CH.to(device)


def bound(nbytes: float, ops: float, mm_ops: float = 0.0):
    """(least ms, what bounds it): bytes at the memory rate against `ops`
    f32 operations at the SIMT rate plus `mm_ops` f32 product operations
    as 3xTF32 on the tensor cores."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = (ops / PEAK_F32_S + 3 * mm_ops / PEAK_TF32_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextmanager
def plain_version(module, name: str, plain):
    """Run with `module.name` (a kernel's wrapper) replaced by its plain
    version."""
    saved = getattr(module, name)
    setattr(module, name, plain)
    try:
        yield
    finally:
        setattr(module, name, saved)


def drive(wrappers: dict, needs, fn):
    """Run one path with every launch counter at 0 → (fn's result, the
    counts after it); fails if a kernel in `needs` was never launched."""
    for w in wrappers.values():
        w.launches = 0
        if hasattr(w, "shapes"):
            w.shapes.clear()
    out = fn()
    sync()
    counts = {k: w.launches for k, w in wrappers.items()}
    assert all(counts[k] > 0 for k in needs), f"a kernel never ran: {counts}"
    return out, counts


def timed(fn):
    """(fn(), host seconds to the end of its device work)."""
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def tile_stages(search, packed, Q, router, reps: int = 10) -> dict:
    """Milliseconds of each stage of one warm unfiltered search tile (the
    stages of search._search_pass's PQ path: the selecting scorer keeps
    each query's top 2 · BUDGET slots) between CUDA events on the device's
    timeline, so time the device waits on the host inside a stage counts."""
    from repro_torch.quant.pq import pq_lut
    from repro_torch.utils import topk_first
    names = ("route", "lut", "select", "dedup", "rerank")
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
    total = dict.fromkeys(names, 0.0)
    for r in range(reps + 1):
        ev[0].record()
        psc, parts = router.route(Q, TOP_T)
        ev[1].record()
        luts = pq_lut(packed.pq, Q)
        ev[2].record()
        keep = min(2 * BUDGET, parts.shape[1] * packed.part_ids.shape[1])
        ci, cv = search.pq_score_probes_select(luts, packed.part_codes, packed.extent, parts,
                                               psc, packed.part_ids, keep)
        ev[3].record()
        bi, bv = search.dedup_ranked(ci, cv, BUDGET)
        ev[4].record()
        exact = torch.einsum("qbd,qd->qb", packed.rerank[bi.clamp(min=0).long()], Q)
        exact = torch.where(torch.isfinite(bv), exact, float("-inf"))
        topk_first(exact, FINAL_K)
        ev[5].record()
        sync()
        if r:                                   # the first round warms up
            for i, k in enumerate(names):
                total[k] += ev[i].elapsed_time(ev[i + 1]) / reps
    return total


@contextmanager
def counting(module, name: str, calls: Counter):
    """Run with `module.name` wrapped so that each call adds one to
    calls[name]."""
    fn = getattr(module, name)

    def counted(*a, **k):
        calls[name] += 1
        return fn(*a, **k)

    with plain_version(module, name, counted):
        yield


def tombstoned(packed, seed: int, share: float = 0.2):
    """The packed table with `share` of each partition's live slots set to
    -1 in place (seeded): the extent stays, sizes become the live count."""
    ids = packed.part_ids
    g = torch.Generator().manual_seed(seed)
    key = torch.where(ids >= 0, torch.rand(ids.shape, generator=g).to(ids.device), 2.0)
    rank = torch.argsort(torch.argsort(key, dim=1), dim=1)
    dead = rank < (share * packed.sizes.float()).floor().long()[:, None]
    ids = torch.where(dead, -1, ids)
    return packed._replace(part_ids=ids, sizes=(ids >= 0).sum(1).to(torch.int32))


def dense_scan(pq_score, luts, Qb, idx, part, k):
    """Brute-force ADC over every code row: PQ score + ⟨q, c⟩ of the row's
    partition, best row per point, top-k points → ids (nq, k)."""
    s = pq_score(luts, idx.codes) + (Qb @ idx.centroids.T)[:, part]
    best = torch.full((Qb.shape[0], idx.n_points), float("-inf"), device=s.device)
    best.scatter_reduce_(1, idx.point_ids.long().expand(Qb.shape[0], -1), s, "amax")
    return torch.topk(best, k, dim=1).indices


def rank_worker(args) -> int:
    """One rank of the shard-parallel phase's gloo group (run by that phase
    as `chip_smoke.py --rank R --world W --workdir DIR`): load the shard
    envelope DIR/env onto the card, re-stack it, keep this rank's block,
    search DIR/q.pt through make_distributed_search_pq(group=...) and save
    the result and times to DIR/rank<R>.pt."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.core import distributed as dist_mod
    from repro_torch.kernels import _build
    from repro_torch.utils import set_f32_precision
    set_f32_precision()
    _build.library()
    t0 = time.perf_counter()
    dist.init_process_group("gloo", init_method=f"file://{args.workdir}/store",
                            rank=args.rank, world_size=args.world,
                            timeout=timedelta(seconds=RANK_TIMEOUT))
    out = {"init_s": time.perf_counter() - t0}
    g = dist.group.WORLD
    shards, _ = dist_mod.load_sharded(f"{args.workdir}/env", device=DEVICE)
    ivf = dist_mod.local_shards(dist_mod.sharded_from_indexes_pq(shards), g)
    del shards
    torch.cuda.empty_cache()
    sync()
    out["load_s"] = time.perf_counter() - t0 - out["init_s"]
    Q = torch.load(f"{args.workdir}/q.pt").to(DEVICE)
    fn = dist_mod.make_distributed_search_pq(top_t=TOP_T, final_k=FINAL_K,
                                             rerank_k=BUDGET, q_chunk=SH_QCHUNK, group=g)
    fn(ivf, Q)                                   # warm
    gather_s = []
    real = dist_mod._all_gather

    def timed_gather(*a):
        r, dt = timed(lambda: real(*a))
        gather_s.append(dt)
        return r

    with plain_version(dist_mod, "_all_gather", timed_gather):
        (ids, sc), out["search_s"] = timed(lambda: fn(ivf, Q))
    out.update(ids=ids.cpu(), scores=sc.cpu(), gather_ms=sum(gather_s) * 1e3,
               local_shards=int(ivf.local_base.shape[0]),
               peak_bytes=torch.cuda.max_memory_allocated())
    torch.save(out, f"{args.workdir}/rank{args.rank}.pt")
    dist.destroy_process_group()
    return 0


@contextmanager
def sync_errors():
    """Run with torch.cuda's sync debug mode at "error": an operation that
    makes the host wait for the device raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def trace_contract(wrappers: dict, name: str, spec, needs, sync_free: bool):
    """Contract `name` of repro_torch.analysis over `spec` on the card: one
    warm run, then one run under the contracts' op recorder through drive()
    (so every kernel in `needs` must launch), inside sync_errors() when
    `sync_free` → (summary with the op count, the largest output, the
    findings and the host seconds of the warm and the recorded run, the
    launch counts). The largest output is the largest that is not a view
    of an input."""
    from repro_torch.analysis import contracts
    _, warm_s = timed(lambda: spec.fn(*spec.args))

    def run():
        with sync_errors() if sync_free else ExitStack():
            return contracts.record_ops(spec)

    t0 = time.perf_counter()
    rec, counts = drive(wrappers, needs, run)
    traced_s = time.perf_counter() - t0
    found = contracts.evaluate(contracts.REGISTRY[name], spec, rec)
    big = max((o for o in rec.outputs if not o.view), key=lambda o: o.nbytes)
    return {"contract": name, "dims": spec.dims, "ops": rec.n_ops,
            "warm_s": warm_s, "traced_s": traced_s,
            "largest": {"op": big.op, "shape": list(big.shape), "dtype": big.dtype,
                        "bytes": big.nbytes},
            "sync_error_mode": sync_free,
            "findings": [f.render() for f in found]}, counts


def contract_traces(packed, flat, idx, X, Q, bits, shards):
    """The contracts' workloads at the main path's width → [(contract name,
    label, TraceSpec, kernels it needs, searched under sync_errors())]:
    one 128-row tile of phase 3's index searched flat, tree-routed and
    filtered with escalation, search_jit on it, the tree route at that
    tile, assign_fused and pq_encode on 65,537 rows, a Lloyd sweep on
    131,071, the replica and build fan-outs over the card twice, and both
    shard-parallel makers over phase 16's stack (64 queries, one tile a
    shard; n is a shard's)."""
    from repro_torch.analysis.contracts import TraceSpec
    from repro_torch.core.distributed import (make_distributed_search,
                                              make_distributed_search_pq,
                                              make_replicated_search, make_sharded_assign)
    from repro_torch.core.search import search_jit, search_jit_batched
    from repro_torch.kernels.soar_assign import assign_fused
    from repro_torch.kernels.lloyd import lloyd_sweep
    from repro_torch.kernels.tree_route import tree_route
    from repro_torch.quant.pq import pq_encode
    ivq, iv, Qs = shards
    n, nl = X.shape[0], iv.rerank.shape[1]
    Qt = Q[:BQ]
    C = idx.centroids
    rt = packed.router
    kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=BUDGET, multiplicity=2)
    probe, route = ("pq_score_probes_select",), ("tree_route", "pq_score_probes_select")
    assign = ("vq_assign", "soar_assign")
    two = [DEVICE + ":0"] * 2
    return [
        ("search_jit_batched", "flat", TraceSpec(
            lambda p, q: search_jit_batched(p, q, bq=BQ, router=flat, **kw),
            (packed, Qt), {"n": n}), probe, True),
        ("search_jit_batched", "tree", TraceSpec(
            lambda p, q: search_jit_batched(p, q, bq=BQ, **kw), (packed, Qt), {"n": n}),
         route, True),
        ("search_jit_batched_filtered", "tree, 1%, escalated", TraceSpec(
            lambda p, q, f: search_jit_batched(p, q, bq=BQ, filter=f, escalate=True, **kw),
            (packed, Qt, bits), {"n": n}), route, True),
        ("search_jit", "tree", TraceSpec(lambda p, q: search_jit(p, q, **kw), (packed, Qt),
                                         {"n": n}), route, True),
        ("tree_route", "main tile", TraceSpec(
            lambda q, sc, cc, ch: tree_route(q, sc, cc, ch, rt.eff_t_route),
            (Qt, rt.super_centroids, rt.child_centroids, rt.children)), ("tree_route",),
         True),
        ("assign_fused", "65,537 rows", TraceSpec(
            lambda x, c: assign_fused(x, c, 1.0, 1), (X[:65_537], C),
            {"n": 65_537, "c": C.shape[0]}), assign, False),
        ("lloyd_sweep", "131,071 rows", TraceSpec(
            lambda x, c: lloyd_sweep(x, c), (X[:131_071], C),
            {"n": 131_071, "c": C.shape[0]}), ("lloyd_sweep",), False),
        ("pq_encode", "65,537 rows", TraceSpec(
            lambda cb, x: pq_encode(cb, x, chunk=512), (idx.pq, X[:65_537]),
            {"n": 65_537, "d": X.shape[1]}), (), False),
        ("replicated_search", "cuda:0 twice", TraceSpec(
            make_replicated_search(two, bq=BQ, **kw), (packed, Q[:2 * BQ]), {"n": n}),
         route, True),
        ("sharded_assign", "cuda:0 twice", TraceSpec(
            make_sharded_assign(two), (X[:131_074], C), {"n": 131_074, "c": C.shape[0]}),
         assign, False),
        ("distributed_search", "4 shards", TraceSpec(
            make_distributed_search(top_t=TOP_T, final_k=FINAL_K, multiplicity=2),
            (iv, Qs), {"n": nl}), (), True),
        ("distributed_search_pq", "4 shards", TraceSpec(
            make_distributed_search_pq(top_t=TOP_T, final_k=FINAL_K, rerank_k=BUDGET,
                                       q_chunk=Qs.shape[0], multiplicity=2),
            (ivq, Qs), {"n": nl}), probe, True),
    ]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--parent", type=Path, default=None,
                    help="checkout of the parent commit: time its route and "
                         "dense kernels beside this one's")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--workdir", type=str, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--job", type=str, default="search", help=argparse.SUPPRESS)
    ap.add_argument("--cells", type=str, default="", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    if args.rank is not None:
        workers = {"train": train_rank_worker, "mesh": mesh_rank_worker,
                   "dryrun": dryrun_worker}
        return workers.get(args.job, rank_worker)(args)

    smi, kind, wrappers, kernels = ann_phases(args)
    gc.collect()                          # phases 1-18's tensors go here
    torch.cuda.empty_cache()
    lm_phase(args.seed, smi, wrappers)
    gc.collect()                          # phase 19's tensors go here
    torch.cuda.empty_cache()
    train_phase(args.seed, smi, wrappers)
    gc.collect()                          # phase 20's tensors go here
    torch.cuda.empty_cache()
    added = launch_phase(args.seed, smi, wrappers)
    for k in kernels:
        k["launches"] += added[k["name"]]
    gc.collect()                          # phase 21's tensors go here
    torch.cuda.empty_cache()
    mesh_phase(args.seed, smi, wrappers)

    # 23. result lines
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def lm_tokens(rng, cfg, B: int, S: int):
    """(B, S) int32 prompt ids below the vocabulary, drawn by numpy, on the card."""
    return torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)).to(DEVICE)


def lm_serve(cfg, model, tokens, n_new: int, warm: bool = False):
    """ServeEngine over `model`: greedy ids twice (bit for bit), the second
    run timed (prefill seconds, median decode step) → (a summary row, the
    engine, the ids)."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(cfg, model, max_seq=tokens.shape[1] + n_new, device=DEVICE)
    if warm:                       # prefill and one step: every shape the runs take
        eng.generate({"tokens": tokens}, 2)
    ids = eng.generate({"tokens": tokens}, n_new)
    t: dict = {}
    again = eng.generate({"tokens": tokens}, n_new, timings=t)
    B, S = tokens.shape
    step = float(np.median(t["step_s"]))
    row = {"arch": cfg.name, "batch": B, "prompt": S, "new": n_new,
           "prefill_s": t["prefill_s"], "prefill_tok_s": B * S / t["prefill_s"],
           "decode_step_ms": step * 1e3, "decode_tok_s": B / step,
           "decode_s": float(np.sum(t["step_s"])),
           "ids_repeat_bitwise": bool(torch.equal(ids, again)),
           "max_id": int(ids.max()), "min_id": int(ids.min()),
           "vocab_padded": cfg.vocab_padded}
    assert row["ids_repeat_bitwise"], f"{cfg.name}: two runs of generate differ"
    assert 0 <= row["min_id"] and row["max_id"] < cfg.vocab_padded, \
        f"{cfg.name}: a token id outside [0, vocab_padded)"
    return row, eng, ids


def lm_profile(fn):
    """One (warm) call of fn() under torch.profiler (CPU and CUDA
    activity) → (the device's kernel time summed, the kernels launched and
    the six kernels that took the most time, by name (None where the
    profiler saw no device activity), and the host's wall ms under the
    profiler; fn's result)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        sync()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    by_name: Counter = Counter()
    for e in dev:
        by_name[e.name[:80]] += e.time_range.elapsed_us() / 1e3
    return {"device_busy_ms": sum(by_name.values()) if dev else None,
            "device_events": len(dev) if dev else None, "profiled_wall_ms": wall * 1e3,
            "top_kernels_ms": dict(by_name.most_common(6)) if dev else None}, out


def lm_decode_matches_forward(cfg, params, inputs: dict, tol: float) -> float:
    """decode_step after prefill of all but the last token against the full
    forward's last logits → the largest difference (fails past tol)."""
    from repro_torch.models import transformer as TT
    tokens = inputs["tokens"]
    S = tokens.shape[1]
    prefix = cfg.n_prefix_embeds if cfg.frontend == "vision" else 0
    with torch.inference_mode():
        x, _ = TT.forward(params, inputs, cfg)
        full = TT.logits_from_hidden(params, x[:, -1:], cfg)
        _, caches = TT.prefill(params, dict(inputs, tokens=tokens[:, :S - 1]), cfg,
                               S + prefix)
        dec, _ = TT.decode_step(params, tokens[:, S - 1:], caches, S - 1 + prefix, cfg)
    assert torch.allclose(dec, full, rtol=tol, atol=tol), \
        f"{cfg.name}: decode after prefill differs from the forward by {(dec - full).abs().max()}"
    return float((dec - full).abs().max())


def lm_granite(seed: int) -> dict:
    """The main run: granite-3-2b served at full width and depth, its
    bounds, and the checks (a)-(d)."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config(LM_ARCH)
    t0 = time.perf_counter()
    model = TT.Transformer(cfg, generator=torch.Generator().manual_seed(seed), device=DEVICE)
    sync()
    init_s = time.perf_counter() - t0
    rng = np.random.default_rng(seed)
    tokens = lm_tokens(rng, cfg, LM_B, LM_PROMPT)
    row, eng, _ = lm_serve(cfg, model, tokens, LM_NEW, warm=True)   # (a), (d)
    groups = [t for _, t in leaf_paths(eng.params["groups"])]
    cast = [t for t in groups if t.dtype == torch.bfloat16]
    kv = [t for st in TT.cache_defs(cfg, LM_B, LM_PROMPT + LM_NEW).values() for t in st]
    n_attn = cfg.block_pattern.count("attn") * cfg.n_groups
    # decode: every group weight as the engine holds it, the f32 head that
    # logits_from_hidden casts each call, the final norm, one read of the
    # whole KV cache; prefill: 2 flops a group parameter a token plus the
    # attention JAX computes (every q x kv tile of S x S)
    dec_bytes = nbytes(groups) + nbytes([eng.params["head"]["w"],
                                         eng.params["final_norm"]["scale"]]) + nbytes(kv)
    pre_flops = (2 * sum(t.numel() for t in groups) * LM_B * LM_PROMPT
                 + 4 * LM_B * LM_PROMPT ** 2 * cfg.n_heads * cfg.hd * n_attn)
    row.update(init_s=init_s,
               param_bytes=nbytes(t for _, t in leaf_paths(model.param_tree())),
               bf16_copy_bytes=nbytes(cast), kv_cache_bytes=nbytes(kv),
               decode_bound_bytes=dec_bytes, decode_bound_ms=dec_bytes / PEAK_BYTES_S * 1e3,
               prefill_bound_flops=pre_flops, prefill_bound_s=pre_flops / PEAK_BF16_S)
    row["decode_share"] = row["decode_bound_ms"] / row["decode_step_ms"]
    row["prefill_share"] = row["prefill_bound_s"] / row["prefill_s"]
    # where a step's time goes: the device's kernel time against the host
    # clock, and the aten ops (and host syncs) of one decode step
    from repro_torch.analysis.contracts import OpRecorder
    from repro_torch.serve.engine import make_serve_step
    step = make_serve_step(cfg)
    with torch.inference_mode():                       # warm: generate ran these
        row["prefill_profile"], (_, caches) = lm_profile(
            lambda: TT.prefill(eng.params, {"tokens": tokens}, cfg, eng.max_seq))
        last = tokens[:, -1:]
        row["decode_profile"], _ = lm_profile(lambda: step(eng.params, last, caches, LM_PROMPT))
        with OpRecorder() as rec:
            step(eng.params, last, caches, LM_PROMPT)
    for key, wall in (("prefill", row["prefill_s"] * 1e3), ("decode", row["decode_step_ms"])):
        busy = row[f"{key}_profile"]["device_busy_ms"]
        row[f"{key}_device_idle_share"] = None if busy is None else max(0.0, 1 - busy / wall)
    row.update(decode_step_aten_ops=rec.n_ops,
               decode_step_non_view_outputs=sum(not o.view for o in rec.outputs),
               decode_step_host_syncs=len(rec.syncs))
    del eng, groups, cast, caches          # the engine's bf16 copy goes with them
    # (b) and (c) in f32 on the same parameters
    cfg32 = cfg.replace(compute_dtype="float32")
    params = model.param_tree()
    toks = lm_tokens(rng, cfg, LM_CHECK_B, LM_CHECK_S)
    row["f32_decode_vs_forward_max_abs"] = lm_decode_matches_forward(
        cfg32, params, {"tokens": toks}, 1e-3)
    eng32 = ServeEngine(cfg32, model, max_seq=LM_CHECK_S + LM_CHECK_NEW, device=DEVICE)
    got = eng32.generate({"tokens": toks}, LM_CHECK_NEW)
    cur, differ = toks, []
    with torch.inference_mode():
        for i in range(LM_CHECK_NEW):
            x, _ = TT.forward(params, {"tokens": cur}, cfg32)
            lg = TT.logits_from_hidden(params, x[:, -1:], cfg32)[:, 0]
            top2 = torch.topk(lg, 2, dim=-1).values
            for r in torch.nonzero(lg.argmax(-1) != got[:, i]).flatten().tolist():
                gap = float(top2[r, 0] - top2[r, 1])
                differ.append({"step": i, "row": r, "top2_gap": gap})
                print(f"lm check (c): step {i} row {r} engine {int(got[r, i])} forward "
                      f"{int(lg[r].argmax())}, top-2 gap {gap:.3g}")
                assert gap < 1e-3, f"greedy id differs from the forward's at a gap of {gap}"
            cur = torch.cat([cur, got[:, i:i + 1]], dim=1)      # follow the engine
    row["f32_greedy_differs"] = differ
    return row


def lm_xlstm(seed: int) -> dict:
    """xlstm-350m at full width and depth: mLSTM chunkwise prefill, sLSTM loop."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    cfg = get_config("xlstm-350m")
    model = TT.Transformer(cfg, generator=torch.Generator().manual_seed(seed), device=DEVICE)
    tokens = lm_tokens(np.random.default_rng(seed + 1), cfg, LM_B, XLSTM_PROMPT)
    return lm_serve(cfg, model, tokens, XLSTM_NEW)[0]


def lm_moe(seed: int) -> dict:
    """qwen3-moe-30b-a3b at full width, depth cut to MOE_LAYERS (48 layers
    are ≈ 122 GB in f32), and check (b) at capacity_factor 8."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    cfg = get_config("qwen3-moe-30b-a3b").replace(n_layers=MOE_LAYERS)
    model = TT.Transformer(cfg, generator=torch.Generator().manual_seed(seed), device=DEVICE)
    rng = np.random.default_rng(seed + 2)
    row = lm_serve(cfg, model, lm_tokens(rng, cfg, LM_B, MOE_PROMPT), MOE_NEW)[0]
    row["f32_decode_vs_forward_max_abs"] = lm_decode_matches_forward(
        cfg.replace(compute_dtype="float32", capacity_factor=8.0), model.param_tree(),
        {"tokens": lm_tokens(rng, cfg, LM_CHECK_B, LM_CHECK_S)}, 1e-3)
    return row


def lm_smoke(seed: int) -> dict:
    """Every registered architecture's smoke config: the port on the card
    against the port on the CPU (same f32 parameters, logits within 1e-4),
    prefill → decode against the forward on the card, bf16 ids twice."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.models import transformer as TT
    from repro_torch.serve.engine import ServeEngine
    out = {}
    for i, arch in enumerate(ARCH_IDS):
        cfg = get_config(arch).smoke_config()
        cfg32 = cfg.replace(compute_dtype="float32")
        cpu = TT.Transformer(cfg32, generator=torch.Generator().manual_seed(seed), device="cpu")
        card = TT.Transformer(cfg32, cpu.param_tree(), device=DEVICE)
        rng = np.random.default_rng(seed + 10 + i)
        if cfg.frontend == "audio":
            inp = {"frames": rng.standard_normal((2, 32, cfg.d_model)).astype(np.float32)}
        else:
            inp = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)}
            if cfg.frontend == "vision":
                inp["patches"] = rng.standard_normal(
                    (2, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
        with torch.inference_mode():
            lg = [TT.logits_from_hidden(m.param_tree(), m({k: torch.from_numpy(v).to(dev)
                                                          for k, v in inp.items()})[0], cfg32)
                  for m, dev in ((cpu, "cpu"), (card, DEVICE))]
        err = float((lg[1].cpu() - lg[0]).abs().max())
        assert err <= 1e-4 * max(1.0, float(lg[0].abs().max())), f"{arch}: card vs CPU {err}"
        row = {"card_vs_cpu_max_abs": err}
        if cfg.has_decode:
            kw = {k: torch.from_numpy(v).to(DEVICE) for k, v in inp.items()}
            kw["tokens"] = kw["tokens"][:, :16]
            row["decode_vs_forward_max_abs"] = lm_decode_matches_forward(
                cfg32.replace(capacity_factor=8.0), card.param_tree(), kw, 1e-4)
            eng = ServeEngine(cfg, card, max_seq=64, device=DEVICE)
            a, b = eng.generate(kw, 8), eng.generate(kw, 8)
            assert torch.equal(a, b), f"{arch}: bf16 generate differs between runs"
            assert int(a.max()) < cfg.vocab_padded
            row["bf16_ids_repeat_bitwise"] = True
        out[arch] = row
    return out


def lm_phase(seed: int, smi: str, wrappers: dict) -> None:
    """19. The LM serving path, through drive() with no kernel needed (it
    launches none of the six): granite-3-2b served at full width and
    depth, xlstm-350m, qwen3-moe-30b-a3b at 2 layers, every smoke config."""
    t_phase = time.perf_counter()
    left = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    def run():
        out = {"granite": lm_granite(seed)}
        gc.collect()
        torch.cuda.empty_cache()
        out["xlstm"] = lm_xlstm(seed)
        out["qwen3_moe_2_layers"] = lm_moe(seed)
        gc.collect()
        torch.cuda.empty_cache()
        out["smoke"] = lm_smoke(seed)
        return out

    out, counts = drive(wrappers, (), run)
    out.update(card=smi, launches=counts, bytes_left_from_earlier_phases=left,
               peak_bytes=torch.cuda.max_memory_allocated(),
               phase_s=time.perf_counter() - t_phase)
    g = out["granite"]
    print(f"lm granite-3-2b ({smi}): params {g['param_bytes']} B, bf16 copy "
          f"{g['bf16_copy_bytes']} B, KV cache {g['kv_cache_bytes']} B; prefill "
          f"{g['prefill_s']:.4f} s ({g['prefill_tok_s']:.0f} tok/s, bound "
          f"{g['prefill_bound_s']:.4f} s); decode {g['decode_step_ms']:.3f} ms a step "
          f"({g['decode_tok_s']:.1f} tok/s, bound {g['decode_bound_ms']:.3f} ms); peak "
          f"{out['peak_bytes']} B; launches {counts}")
    print(f"lm granite-3-2b profile: prefill {g['prefill_profile']} (idle share "
          f"{g['prefill_device_idle_share']}), decode step {g['decode_profile']} (idle share "
          f"{g['decode_device_idle_share']}), {g['decode_step_aten_ops']} aten ops a step "
          f"({g['decode_step_non_view_outputs']} non-view outputs, "
          f"{g['decode_step_host_syncs']} host syncs)")
    for key in ("xlstm", "qwen3_moe_2_layers"):
        r = out[key]
        print(f"lm {r['arch']} ({smi}): prefill {r['prefill_tok_s']:.0f} tok/s, decode "
              f"{r['decode_step_ms']:.3f} ms a step ({r['decode_tok_s']:.1f} tok/s)")
    print("lm serving: " + json.dumps(out))
    assert not any(counts.values()), f"the LM path launched a kernel of the six: {counts}"


# ------------------------------------------------------------------ LM training

def tree_equal(a, b) -> bool:
    """Two parameter trees (or AdamW states) equal leaf for leaf, bit for bit."""
    from repro_torch.models.params import leaf_paths
    if hasattr(a, "_fields"):
        return int(a.step) == int(b.step) and tree_equal(a.m, b.m) and tree_equal(a.v, b.v)
    la, lb = list(leaf_paths(a)), list(leaf_paths(b))
    return len(la) == len(lb) and all(
        pa == pb and torch.equal(ta, tb.to(ta.device)) for (pa, ta), (pb, tb) in zip(la, lb))


def tree_max_diff(a, b) -> float:
    from repro_torch.models.params import leaf_paths
    want = dict(leaf_paths(b))
    return max(float((t - want[p].to(t.device)).abs().max()) for p, t in leaf_paths(a))


def train_flops(cfg, B: int, S: int) -> float:
    """FLOPs of one training step's products: each group parameter 2
    FLOPs a token forward, 2 again in the remat recompute and 4 backward;
    the head 2 forward and 4 backward (it is not recomputed); attention as
    JAX computes it, every (q, kv) tile of S x S: 4 B S^2 heads head_dim
    forward, as much again recomputed, twice that backward."""
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths
    n_group = sum(t.numel() for _, t in leaf_paths(TT.abstract_params(cfg)["groups"]))
    n_attn = cfg.block_pattern.count("attn") * cfg.n_groups
    T = B * S
    return (8 * n_group * T + 6 * cfg.d_model * cfg.vocab_padded * T
            + 16 * B * S * S * cfg.n_heads * cfg.hd * n_attn)


def train_granite(seed: int) -> dict:
    """(a) granite-3-2b at full width and depth through train(): one
    warm-up step, three timed; the step's bounds and its profile."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step, train
    cfg = get_config(LM_ARCH)
    pipe = for_model(cfg, seq_len=TR_SEQ, global_batch=TR_BATCH, seed=seed)
    params = TT.init_params(torch.Generator().manual_seed(seed), cfg, device=DEVICE)
    probes = {p: t.reshape(-1)[:4096].clone() for p, t in leaf_paths(params)}
    stamps, logged, update_events = [], [], []

    def on_log(step, m):
        sync()
        stamps.append(time.perf_counter())
        logged.append({k: float(v) for k, v in m.items()})

    real_update = opt_mod.update

    def timed_update(*a, **k):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = real_update(*a, **k)
        end.record()
        update_events.append((start, end))
        return out

    torch.cuda.reset_peak_memory_stats()
    sync()
    t0 = time.perf_counter()
    with plain_version(opt_mod, "update", timed_update):
        params, state, losses = train(cfg, pipe, steps=TR_STEPS, lr=TR_LR, accum=TR_ACCUM,
                                      params=params, log_every=1, on_log=on_log,
                                      device=DEVICE)
    peak = torch.cuda.max_memory_allocated()
    lr_fn = opt_mod.warmup_cosine(TR_LR, warmup=max(TR_STEPS // 20, 10), total=TR_STEPS)
    lr_want = [float(lr_fn(torch.tensor(i, dtype=torch.int32, device=DEVICE)))
               for i in range(TR_STEPS)]
    step_s = [b - a for a, b in zip(stamps, stamps[1:])]
    update_ms = [s.elapsed_time(e) for s, e in update_events]
    ln_v = math.log(cfg.vocab_size)
    # a random model's loss: ln(padded vocab) + sigma^2 / 2, its logits of
    # variance 1 (unit-RMS final hidden state times the head's 1/sqrt(d) std)
    expected0 = math.log(cfg.vocab_padded) + 0.5
    changed = sum(not torch.equal(dict(leaf_paths(params))[p].reshape(-1)[:4096], t)
                  for p, t in probes.items())
    param_bytes = nbytes(t for _, t in leaf_paths(params))
    flops = train_flops(cfg, TR_BATCH, TR_SEQ)
    row = {"arch": cfg.name, "seq": TR_SEQ, "global_batch": TR_BATCH, "accum": TR_ACCUM,
           "losses": losses, "grad_norm": [m["grad_norm"] for m in logged],
           "lr": [m["lr"] for m in logged], "lr_want": lr_want,
           "warmup_step_s": stamps[0] - t0, "step_s": step_s,
           "step_s_median": float(np.median(step_s)),
           "update_ms": update_ms, "update_ms_median": float(np.median(update_ms[1:])),
           "peak_bytes": peak, "param_bytes": param_bytes,
           "leaves_changed": changed, "leaves": len(probes),
           "first_loss_minus_ln_vocab": losses[0] - ln_v, "expected_first_loss": expected0,
           "step_bound_flops": flops, "step_bound_s": flops / PEAK_BF16_S,
           # params, grads, m and v read once; params, m and v written once
           "update_bound_bytes": 7 * param_bytes,
           "update_bound_ms": 7 * param_bytes / PEAK_BYTES_S * 1e3}
    row["tokens_s"] = TR_SEQ * TR_BATCH / row["step_s_median"]
    row["step_share"] = row["step_bound_s"] / row["step_s_median"]
    row["update_share"] = row["update_bound_ms"] / row["update_ms_median"]
    assert all(math.isfinite(x) for x in losses + row["grad_norm"]), "a loss or grad_norm is not finite"
    assert abs(losses[0] - expected0) < 0.5, \
        f"first loss {losses[0]} is not within 0.5 of a random model's {expected0}"
    assert row["lr"] == lr_want, f"lr {row['lr']} differs from warmup_cosine's {lr_want}"
    assert changed == len(probes), f"only {changed} of {len(probes)} leaves changed"
    # one more step under the profiler
    step = make_train_step(cfg, lr_fn, accum=TR_ACCUM)
    batch = {k: v.to(DEVICE) for k, v in pipe.batch_at(TR_STEPS).items()}
    row["profile"], _ = lm_profile(lambda: step(params, state, batch))
    busy = row["profile"]["device_busy_ms"]
    row["device_idle_share"] = (None if busy is None
                                else max(0.0, 1 - busy / row["profile"]["profiled_wall_ms"]))
    return row


def train_cut(seed: int) -> dict:
    """(b) repeat and resume, (c) accumulation: granite at full width cut
    to TR_CUT_LAYERS layers, TR_CUT_SEQ tokens."""
    import signal
    from repro_torch.ckpt.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths, tree_map
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step, train
    cfg = get_config(LM_ARCH).replace(n_layers=TR_CUT_LAYERS)
    pipe = for_model(cfg, seq_len=TR_CUT_SEQ, global_batch=TR_BATCH, seed=seed)
    kw = dict(steps=TR_STEPS, lr=TR_LR, seed=seed, log_every=1, device=DEVICE)
    out = {"layers": TR_CUT_LAYERS, "seq": TR_CUT_SEQ}
    ref = train(cfg, pipe, **kw)
    again = train(cfg, pipe, **kw)
    out["repeat_bitwise"] = tree_equal(ref[0], again[0]) and tree_equal(ref[1], again[1])
    if not out["repeat_bitwise"]:
        out["repeat_max_abs"] = max(tree_max_diff(again[0], ref[0]),
                                    tree_max_diff(again[1].m, ref[1].m),
                                    tree_max_diff(again[1].v, ref[1].v))
    del again
    saved = signal.getsignal(signal.SIGTERM)

    def kill_after_2(step, metrics):
        if step == 2:
            os.kill(os.getpid(), signal.SIGTERM)

    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "run"), keep=1)
        try:
            _, _, first = train(cfg, pipe, ckpt_manager=mgr, ckpt_every=100,
                                on_log=kill_after_2, **kw)
        finally:
            signal.signal(signal.SIGTERM, saved)
        out["preempted_after_steps"], out["checkpoint_steps"] = len(first), mgr.steps()
        assert len(first) == 3 and mgr.steps() == [3], (first, mgr.steps())
        params, state, rest = train(cfg, pipe, ckpt_manager=CheckpointManager(
            os.path.join(tmp, "run"), keep=1), ckpt_every=100, **kw)
        signal.signal(signal.SIGTERM, saved)
        out["resumed_steps"] = len(rest)
        out["resume_bitwise"] = tree_equal(params, ref[0]) and tree_equal(state, ref[1])
        # one save timed, then restored onto the CPU
        mgr2 = CheckpointManager(os.path.join(tmp, "timed"), keep=1)
        _, save_s = timed(lambda: mgr2.save_train_state(TR_STEPS, params, state))
        save_bytes = nbytes([t for tree in (params, state.m, state.v)
                             for _, t in leaf_paths(tree)])
        out.update(save_bytes=save_bytes, save_s=save_s, save_gb_s=save_bytes / save_s / 1e9)
        cpu_p, cpu_s, data_step = mgr2.restore_train_state(cfg, device="cpu")
        out["restore_on_cpu_bitwise"] = (data_step == TR_STEPS and tree_equal(cpu_p, params)
                                         and tree_equal(cpu_s, state))
        assert all(t.device.type == "cpu" for _, t in leaf_paths(cpu_p))
    assert out["repeat_bitwise"], f"two runs from one seed differ: {out}"
    assert out["resumed_steps"] == 1 and out["resume_bitwise"], f"resume differs: {out}"
    assert out["restore_on_cpu_bitwise"], "the card's checkpoint restores otherwise on the CPU"
    del ref, params, state, cpu_p, cpu_s
    # (c) accum 1 against 4 on one global batch, JAX's bars
    params = TT.init_params(torch.Generator().manual_seed(seed), cfg, device=DEVICE)
    batch = {k: v.to(DEVICE) for k, v in pipe.batch_at(0).items()}
    lr_fn = opt_mod.warmup_cosine(1e-3, 5, 100)
    res = {a: make_train_step(cfg, lr_fn, accum=a)(tree_map(lambda t: t.clone(), params),
                                                   opt_mod.init(params), batch)
           for a in (1, 4)}
    l1, l4 = float(res[1][2]["loss"]), float(res[4][2]["loss"])
    worst = 0.0
    for (_, a), (_, b) in zip(leaf_paths(res[1][0]), leaf_paths(res[4][0])):
        excess = (a - b).abs() - (5e-4 + 6e-3 * b.abs())
        worst = max(worst, float(excess.max()))
    out.update(accum_loss=[l1, l4], accum_loss_rel=abs(l1 - l4) / abs(l1),
               accum_params_max_abs=tree_max_diff(res[4][0], res[1][0]),
               accum_worst_excess=worst)
    assert out["accum_loss_rel"] <= 2e-4, f"accum 1 vs 4 loss {l1} vs {l4}"
    assert worst <= 0, f"accum 1 vs 4 parameters past rtol 6e-3 / atol 5e-4 by {worst}"
    return out


def train_smoke(seed: int) -> dict:
    """(d) one f32 train step of every smoke config on the card against the
    same step on the CPU: loss within 1e-5 relative, every m leaf (0.1 x
    the clipped gradient) within 1e-4 of its largest |value|, parameters
    within rtol 1e-5 and atol 1e-4, the step's lr (Adam's first update is
    lr g / (|g| + eps): where |g| is near eps a last-bit difference in g
    moves the element by up to the step)."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.data.pipeline import for_model
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths, tree_map
    from repro_torch.train import optimizer as opt_mod
    from repro_torch.train.train_loop import make_train_step
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch).smoke_config().replace(compute_dtype="float32")
        cpu = TT.init_params(torch.Generator().manual_seed(seed), cfg, device="cpu")
        card = tree_map(lambda a: a.to(DEVICE, copy=True), cpu)
        batch = for_model(cfg, seq_len=32, global_batch=4, seed=seed).batch_at(0)
        step = make_train_step(cfg, opt_mod.warmup_cosine(1e-3, 10, 100))
        pc, sc, mc = step(cpu, opt_mod.init(cpu), batch)
        pg, sg, mg = step(card, opt_mod.init(card), {k: v.to(DEVICE) for k, v in batch.items()})
        rel = abs(float(mg["loss"]) - float(mc["loss"])) / abs(float(mc["loss"]))
        m_want = dict(leaf_paths(sc.m))
        m_rel = max(float((t.cpu() - m_want[p]).abs().max() / m_want[p].abs().max().clamp(min=1e-30))
                    for p, t in leaf_paths(sg.m))
        want = dict(leaf_paths(pc))
        excess = max(float(((t.cpu() - want[p]).abs() - (1e-4 + 1e-5 * want[p].abs())).max())
                     for p, t in leaf_paths(pg))
        out[arch] = {"loss": float(mg["loss"]), "loss_rel": rel, "m_rel": m_rel,
                     "params_max_abs": tree_max_diff(pg, pc), "params_worst_excess": excess}
        assert rel <= 1e-5, f"{arch}: loss on the card {float(mg['loss'])} vs {float(mc['loss'])}"
        assert m_rel <= 1e-4, f"{arch}: gradients (m) off by {m_rel} of their scale"
        assert excess <= 0, f"{arch}: parameters past the bar by {excess}"
    return out


def train_rank_worker(args) -> int:
    """One rank of phase 20's gloo group on the card (run as `chip_smoke.py
    --rank R --world 2 --workdir DIR --job train`): the compressed
    all-reduce and its feedback loop against the same calls on CPU
    copies, its stage of the two-stage pipeline, and expert parallelism
    against the dense path; results to DIR/rank<R>.pt."""
    from datetime import timedelta
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths, tree_map
    from repro_torch.train import grad_compress as gcm
    from repro_torch.train.pipeline import local_stage, pipelined_loss_and_grad, stack_stage_params
    from repro_torch.utils import set_f32_precision
    set_f32_precision()
    dist.init_process_group("gloo", init_method=f"file://{args.workdir}/store",
                            rank=args.rank, world_size=args.world,
                            timeout=timedelta(seconds=RANK_TIMEOUT))
    g = dist.group.WORLD
    out = {}
    # the compressed all-reduce of one (2,048 x 2,048) gradient leaf
    gen = torch.Generator().manual_seed(args.seed * 100 + args.rank)
    xs = [torch.randn((TR_GRAD, TR_GRAD), generator=gen) for _ in range(4)]
    t0 = time.perf_counter()
    card = gcm.compressed_all_reduce(xs[0].to(DEVICE))
    sync()
    out["compress_ms"] = (time.perf_counter() - t0) * 1e3
    equal = [torch.equal(card.cpu(), gcm.compressed_all_reduce(xs[0]))]
    ec, eg = torch.zeros_like(xs[0]), torch.zeros_like(xs[0]).to(DEVICE)
    for x in xs[1:]:
        rc, ec = gcm.compressed_all_reduce_with_feedback(x, ec)
        rg, eg = gcm.compressed_all_reduce_with_feedback(x.to(DEVICE), eg)
        equal.append(torch.equal(rg.cpu(), rc) and torch.equal(eg.cpu(), ec))
    exact = xs[0].clone()
    dist.all_reduce(exact, group=g)
    out.update(compress_equal_cpu=equal,
               compress_rel=float((card.cpu() - exact).abs().max() / exact.abs().max()))
    # this rank's stage of the two-stage pipeline (f32)
    cfg = get_config(LM_ARCH).replace(n_layers=TR_CUT_LAYERS, compute_dtype="float32",
                                      remat="none")
    params = TT.init_params(torch.Generator().manual_seed(args.seed), cfg, device=DEVICE)
    data = torch.load(os.path.join(args.workdir, "pipe.pt"))
    sp = local_stage(stack_stage_params(params, cfg, 2), g)
    del params
    sync()
    t0 = time.perf_counter()
    loss, grads = pipelined_loss_and_grad(cfg, sp, data["tokens"], data["labels"], 2, group=g)
    sync()
    out.update(pipe_s=time.perf_counter() - t0, pipe_loss=loss.cpu(),
               pipe_wq=grads["groups"]["pos0_attn"]["wq"][0].cpu(),
               pipe_embed=grads["embed"]["table"][0].cpu() if args.rank == 0 else None)
    del sp, grads
    torch.cuda.empty_cache()
    # expert parallelism at ep 2 against the dense path (f32)
    cfg = get_config("qwen3-moe-30b-a3b").replace(n_layers=MOE_LAYERS, compute_dtype="float32")
    params = TT.init_params(torch.Generator().manual_seed(args.seed), cfg, device=DEVICE)
    batch = {k: v.to(DEVICE) for k, v in torch.load(os.path.join(args.workdir, "moe.pt")).items()}

    def loss_and_grads(tree, group):
        leaves = tree_map(lambda a: a.detach().requires_grad_(), tree)
        loss = TT.loss_fn(leaves, batch, cfg, ep_group=group)
        paths, flat = zip(*leaf_paths(leaves))
        return loss.detach(), dict(zip(paths, torch.autograd.grad(loss, flat)))

    dense_loss, dense = loss_and_grads(params, None)
    sync()
    t0 = time.perf_counter()
    ep_loss, ep = loss_and_grads(moe.local_experts(params, cfg, g), g)
    sync()
    out["ep_s"] = time.perf_counter() - t0
    n = cfg.n_experts // args.world
    rel = 0.0
    for path, grad in ep.items():
        want = dense[path]
        if "_moe" in path and path.endswith(("['wi']", "['wo']")):
            want = want[:, args.rank * n:(args.rank + 1) * n]
        rel = max(rel, float((grad - want).abs().max() / want.abs().max().clamp(min=1e-30)))
    out.update(ep_loss=float(ep_loss), dense_loss=float(dense_loss), ep_grad_rel=rel,
               ep_leaves=len(ep), peak_bytes=torch.cuda.max_memory_allocated())
    torch.save(out, os.path.join(args.workdir, f"rank{args.rank}.pt"))
    dist.destroy_process_group()
    return 0


def train_parallel(seed: int) -> dict:
    """(e) two gloo ranks on cuda:0: the compressed all-reduce, the
    two-stage pipeline by group= (and here by devices=), expert
    parallelism; the sequential references here."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    from repro_torch.models.params import leaf_paths, tree_map
    from repro_torch.train.pipeline import pipelined_loss_and_grad, stack_stage_params
    cfg = get_config(LM_ARCH).replace(n_layers=TR_CUT_LAYERS, compute_dtype="float32",
                                      remat="none")
    rng = np.random.default_rng(seed + 20)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TR_PIPE_M, 1, TR_PIPE_S)).astype(np.int32))
    lab = torch.from_numpy(rng.integers(0, cfg.vocab_size, (TR_PIPE_M, 1, TR_PIPE_S)).astype(np.int32))
    mcfg = get_config("qwen3-moe-30b-a3b")
    moe_batch = {k: torch.from_numpy(rng.integers(0, mcfg.vocab_size, (TR_EP_B, TR_EP_S))
                                     .astype(np.int32)) for k in ("tokens", "labels")}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({"tokens": tok, "labels": lab}, os.path.join(tmp, "pipe.pt"))
        torch.save(moe_batch, os.path.join(tmp, "moe.pt"))
        env_vars = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r), "--world", "2",
             "--workdir", tmp, "--job", "train", "--seed", str(seed)], env=env_vars,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(2)]
        # meanwhile: the sequential reference and the pipeline by devices=
        params = TT.init_params(torch.Generator().manual_seed(seed), cfg, device=DEVICE)
        leaves = tree_map(lambda a: a.detach().requires_grad_(), params)
        tk, lb = tok.to(DEVICE), lab.to(DEVICE)
        loss = sum(TT.loss_fn(leaves, {"tokens": tk[i], "labels": lb[i]}, cfg)
                   for i in range(TR_PIPE_M)) / TR_PIPE_M
        ref_wq, ref_embed = torch.autograd.grad(
            loss, [leaves["groups"]["pos0_attn"]["wq"], leaves["embed"]["table"]])
        ref_loss = float(loss.detach())
        del leaves, loss
        sync()
        t1 = time.perf_counter()
        dl, dg = pipelined_loss_and_grad(cfg, stack_stage_params(params, cfg, 2), tok, lab, 2,
                                         devices=[DEVICE, DEVICE])
        sync()
        out["pipe_devices_s"] = time.perf_counter() - t1
        per = ref_wq.shape[0] // 2
        stage_wq = [dg["groups"]["pos0_attn"]["wq"][s] for s in range(2)]
        stage_embed = dg["embed"]["table"][0]
        del params, dg
        torch.cuda.empty_cache()
        try:
            logs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        out["ranks_s"] = time.perf_counter() - t0
        for p, (o, e) in zip(procs, logs):
            assert p.returncode == 0, f"a gloo rank failed ({p.returncode}): {e[-3000:]}"
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]

    def grad_rel(got, want):
        return float((got.to(want.device) - want).abs().max() / want.abs().max())

    out.update(
        pipe_ref_loss=ref_loss, pipe_devices_loss=float(dl),
        pipe_group_loss=[float(r["pipe_loss"]) for r in ranks],
        pipe_devices_wq_rel=max(grad_rel(stage_wq[s], ref_wq[s * per:(s + 1) * per])
                                for s in range(2)),
        pipe_devices_embed_rel=grad_rel(stage_embed, ref_embed),
        pipe_group_wq_rel=max(grad_rel(ranks[s]["pipe_wq"], ref_wq[s * per:(s + 1) * per])
                              for s in range(2)),
        pipe_group_embed_rel=grad_rel(ranks[0]["pipe_embed"], ref_embed),
        pipe_group_s=[r["pipe_s"] for r in ranks],
        compress_equal_cpu=[r["compress_equal_cpu"] for r in ranks],
        compress_rel=[r["compress_rel"] for r in ranks],
        compress_ms=[r["compress_ms"] for r in ranks],
        ep_loss=[r["ep_loss"] for r in ranks], dense_loss=[r["dense_loss"] for r in ranks],
        ep_grad_rel=[r["ep_grad_rel"] for r in ranks], ep_s=[r["ep_s"] for r in ranks],
        rank_peak_bytes=[r["peak_bytes"] for r in ranks])
    for key in ("pipe_devices_loss", "pipe_group_loss"):
        for got in np.atleast_1d(out[key]):
            assert abs(got - ref_loss) / abs(ref_loss) < 1e-5, f"{key} {got} vs {ref_loss}"
    for key in ("pipe_devices_wq_rel", "pipe_devices_embed_rel", "pipe_group_wq_rel",
                "pipe_group_embed_rel"):
        assert out[key] < 2e-4, f"{key} {out[key]}"
    assert all(all(e) for e in out["compress_equal_cpu"]), "compressed all-reduce: card != CPU"
    for r in ranks:
        assert abs(r["ep_loss"] - r["dense_loss"]) / abs(r["dense_loss"]) < 1e-5, r["ep_loss"]
        assert r["ep_grad_rel"] < 1e-4, f"expert-parallel gradients off by {r['ep_grad_rel']}"
    return out


def train_phase(seed: int, smi: str, wrappers: dict) -> None:
    """20. LM training, through drive() with no kernel needed (it launches
    none of the six): (a) granite-3-2b at full width and depth, (b) repeat
    and resume, (c) accumulation, (d) every smoke config against the CPU,
    (e) the parallel paths in two gloo ranks."""
    t_phase = time.perf_counter()
    left = torch.cuda.memory_allocated()

    def run():
        out = {"granite": train_granite(seed)}
        for key, fn in (("cut", train_cut), ("smoke", train_smoke),
                        ("parallel", train_parallel)):
            gc.collect()
            torch.cuda.empty_cache()
            out[key] = fn(seed)
        return out

    out, counts = drive(wrappers, (), run)
    out.update(card=smi, launches=counts, bytes_left_from_earlier_phases=left,
               phase_s=time.perf_counter() - t_phase)
    g, c, p = out["granite"], out["cut"], out["parallel"]
    print(f"lm train granite-3-2b ({smi}): {g['global_batch']} x {g['seq']} tokens, accum "
          f"{g['accum']}; step {g['step_s_median']:.3f} s median of {g['step_s']} "
          f"({g['tokens_s']:.0f} tok/s; bound {g['step_bound_s']:.4f} s, "
          f"{g['step_bound_flops']:.3e} FLOP at 989 TFLOP/s bf16, share {g['step_share']:.3f}); "
          f"update {g['update_ms_median']:.3f} ms (bound {g['update_bound_ms']:.3f} ms, "
          f"{g['update_bound_bytes']} B at 3.35 TB/s); peak {g['peak_bytes']} B; losses "
          f"{g['losses']}, grad_norm {g['grad_norm']}, lr {g['lr']}; launches {counts}")
    print(f"lm train granite-3-2b profile ({smi}): {g['profile']} (idle share "
          f"{g['device_idle_share']})")
    print(f"lm train cut to {c['layers']} layers ({smi}): repeat bitwise {c['repeat_bitwise']}, "
          f"preempted after {c['preempted_after_steps']} steps, resumed {c['resumed_steps']}, "
          f"resume bitwise {c['resume_bitwise']}, CPU restore bitwise "
          f"{c['restore_on_cpu_bitwise']}; save {c['save_bytes']} B in {c['save_s']:.3f} s "
          f"({c['save_gb_s']:.3f} GB/s); accum 1 vs 4 loss rel {c['accum_loss_rel']:.3e}")
    print(f"lm train parallel ({smi}): pipeline loss {p['pipe_ref_loss']:.6f} (devices "
          f"{p['pipe_devices_loss']:.6f}, group {p['pipe_group_loss']}), compressed "
          f"all-reduce equal to the CPU {p['compress_equal_cpu']}, expert-parallel loss "
          f"{p['ep_loss']} vs dense {p['dense_loss']}, gradients within {p['ep_grad_rel']}")
    print("lm training: " + json.dumps(out))
    assert not any(counts.values()), f"the training path launched a kernel of the six: {counts}"


# ------------------------------------------------------------------ launchers

def free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def dryrun_flops(pq: bool, pmax: int) -> int:
    """Product FLOPs of one device's search step (ann_dryrun's shapes):
    the route (Q·Cᵀ), then the LUTs and the rerank of the maker's 256
    (BUDGET) candidates (PQ), or the exact score of the whole top_t·pmax
    window (f32)."""
    from repro_torch.launch import ann_dryrun as a
    route = 2 * a.NQ * a.C_LOCAL * a.D
    if pq:
        m = a.D // 4
        return route + 2 * a.NQ * m * 16 * (a.D // m) + 2 * a.NQ * BUDGET * a.D
    return route + 2 * a.NQ * a.TOP_T * pmax * a.D


def needed_step_bytes(ivq, Q, parts, cands, final_k: int) -> int:
    """Bytes one shard's PQ search step must move at the least: the
    queries, centroids, PQ codebook and local base read once; each
    distinct probed partition's extent, and its code rows and ids up to
    that extent, read once; each distinct rerank candidate's row read
    once; the (nq, final_k) ids and scores written once. `parts` and
    `cands` are the step's probed partitions and rerank candidates."""
    probed = torch.unique(torch.cat([p.reshape(-1) for p in parts]).long())
    rows = int(ivq.extent[0][probed].sum())
    cand = torch.unique(torch.cat([c.reshape(-1) for c in cands]))
    n_cand = int((cand >= 0).sum())
    m, d = ivq.part_codes.shape[3], Q.shape[1]
    return (nbytes([Q, ivq.centroids, ivq.pq_centers, ivq.local_base])
            + probed.numel() * 4 + rows * (m + 4) + n_cand * d * 4
            + Q.shape[0] * final_k * 8)


def launcher_procs(tmp: str) -> dict:
    """Start the serve CLI and the four examples on the card, each a
    process of its own, all at once → {name: Popen}."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ex = ROOT / "examples" / "torch"
    cmds = {
        "serve": ["-m", "repro_torch.launch.serve", "--arch", LM_ARCH, "--device", "cuda"],
        "quickstart": [str(ex / "quickstart.py")],
        "ann_serving": [str(ex / "ann_serving.py")],
        "knn_memory_decode": [str(ex / "knn_memory_decode.py")],
        "train_lm": [str(ex / "train_lm.py"), "--steps", str(EX_TRAIN_STEPS),
                     "--ckpt", os.path.join(tmp, "ckpt")],
    }
    return {k: subprocess.Popen([sys.executable, *c], cwd=ROOT, env=env,
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for k, c in cmds.items()}


def launch_phase(seed: int, smi: str, wrappers: dict) -> Counter:
    """21. The launchers: (a) the ANN dry run on meta tensors, (b) one
    dry-run shard searched for real against its dry run and against the
    plain probe scorer, (c) the serve CLI and (d) the four examples as
    processes → the launches of (b)'s driven path."""
    import torch.distributed as dist
    from repro_torch.core import search
    from repro_torch.core.distributed import (build_sharded_ivf_pq,
                                              make_distributed_search_pq)
    from repro_torch.data.vectors import make_manifold
    from repro_torch.kernels import ref
    from repro_torch.kernels.pq_score import pq_score_probes_select
    from repro_torch.launch import ann_dryrun as a
    from repro_torch.launch.dryrun import fmt_summary
    from repro_torch.launch.op_analysis import analyze
    t_phase = time.perf_counter()
    out: dict = {"card": smi}

    # (a) both meshes, both variants, counted on meta tensors
    out["dryrun"] = {}
    for mp in (False, True):
        for pq in (False, True):
            r = a.run(mp, pq=pq)
            print(f"dryrun {fmt_summary(r)} ({smi})")
            key = f"{r['mesh']}_{'pq' if pq else 'baseline'}"
            out["dryrun"][key] = {k: r[k] for k in ("memory", "collectives", "roofline",
                                                    "per_device", "compile_s")}
            want = r["n_chips"] * a.NQ * a.FINAL_K * 8
            assert r["collective_bytes_total"] == want, f"dry run {key}: collective bytes"
            assert r["per_device"]["flops"] == dryrun_flops(pq, a.PMAX), \
                f"dry run {key}: product FLOPs {r['per_device']['flops']}"

    # (b) one shard at the dry run's size, searched through a one-rank
    # NCCL group, against the dry run of the same shard at world 1
    ds = make_manifold(seed + 7, a.N_LOCAL, a.D, nq=a.NQ, device=DEVICE)
    ivq, build_s = timed(lambda: build_sharded_ivf_pq(seed, ds.X, 1, a.C_LOCAL, a.D // 4,
                                                      device=DEVICE))
    Q = ds.Q.contiguous()
    del ds
    pmax = ivq.part_codes.shape[2]
    real_args = nbytes(list(ivq)) + nbytes([Q])
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", rank=0,
                            world_size=1, device_id=torch.device(DEVICE, 0))
    try:
        # the dry run's maker, at its defaults (rerank_k 256, q_chunk 128)
        fn = make_distributed_search_pq(top_t=a.TOP_T, final_k=a.FINAL_K,
                                        group=dist.group.WORLD)
        fn(ivq, Q)                                  # warm
        (ids, sc), counts = drive(wrappers, ("pq_score_probes_select",), lambda: fn(ivq, Q))
        steps = []
        for _ in range(5):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            fn(ivq, Q)
            ev[1].record()
            ev[1].synchronize()
            steps.append(ev[0].elapsed_time(ev[1]))
        sync()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        fn(ivq, Q)
        sync()
        rise = torch.cuda.max_memory_allocated() - resident
        real = analyze(fn, ivq, Q)
        # the same search on the selecting scorer's plain version; each
        # tile's kernel held against it on the tile's real arguments (the
        # plain sums run in another order, so a near tie may rank the other
        # way), and the probed partitions and rerank candidates kept for
        # the needed bytes
        tiles, parts, cands = [], [], []
        real_dedup = search.dedup_ranked

        def plain_select(*pa):
            want_i, want_v = ref.pq_score_probes_select_ref(*pa)
            got_i, got_v = pq_score_probes_select(*pa)
            fin = torch.isfinite(want_v)
            tiles.append({"shape": list(pa[0].shape[:1]) + list(pa[3].shape[1:]),
                          "inf_equal": torch.equal(torch.isinf(got_v), torch.isinf(want_v)),
                          "close": torch.allclose(got_v[fin], want_v[fin], rtol=1e-5, atol=1e-5),
                          "ids_equal": float((got_i == want_i).float().mean()),
                          "max_abs_err": float((got_v[fin] - want_v[fin]).abs().max())})
            parts.append(pa[3])
            return want_i, want_v

        def kept_dedup(*a_, **k_):
            r = real_dedup(*a_, **k_)
            cands.append(r[0])
            return r

        with plain_version(search, "pq_score_probes_select", plain_select), \
                plain_version(search, "dedup_ranked", kept_dedup):
            pids, _ = fn(ivq, Q)
        need = needed_step_bytes(ivq, Q, parts, cands, a.FINAL_K)
    finally:
        dist.destroy_process_group()
    dry = a.run(False, pq=True, pmax=pmax, world=1)
    print(f"dryrun {fmt_summary(dry)} ({smi})")
    step_ms = sorted(steps)[2]
    bound_s = dry["roofline"]["bound_step_s"]
    need_ms, need_by = bound(need, dryrun_flops(True, pmax))
    peak = real_args + rise
    shard = {"pmax": pmax, "build_s": build_s, "launches": counts,
             "argument_bytes_real": real_args,
             "argument_bytes_dry": dry["memory"]["argument_bytes"],
             "flops_real": real["flops"], "flops_dry": dry["per_device"]["flops"],
             "probe_calls_dry":
                 dry["per_device"]["kernels"]["pq_score_probes_select"]["calls"],
             "collective_bytes_real": real["collective_bytes_total"],
             "collective_bytes_dry": dry["collective_bytes_total"],
             "hbm_bytes_dry": dry["per_device"]["hbm_bytes"],
             "hbm_bytes_real_aten": real["hbm_bytes"],
             "host_syncs_real": real["host_syncs"],
             "step_ms_runs": steps, "step_ms": step_ms, "bound_step_s": bound_s,
             "bound_dominant": dry["roofline"]["dominant"],
             "bound_share": bound_s * 1e3 / step_ms,
             "needed_bytes": need, "needed_bound_ms": need_ms, "needed_bound_by": need_by,
             "needed_share": need_ms / step_ms,
             "plain_scorer_tiles": len(tiles),
             "kernel_max_abs_err": max(t["max_abs_err"] for t in tiles),
             "kernel_tiles_close": all(t["inf_equal"] and t["close"] and t["ids_equal"] >= 0.99
                                       for t in tiles),
             "ids_agree_plain_scorer": float((pids == ids).float().mean()),
             "peak_rise_bytes": rise, "temp_bytes_dry": dry["memory"]["temp_bytes"],
             "peak_bytes_real": peak, "peak_bytes_dry": dry["memory"]["peak_bytes"],
             "peak_ratio_real_over_dry": peak / dry["memory"]["peak_bytes"],
             "ids_valid": bool((ids >= 0).all()) and bool(torch.isfinite(sc).all())}
    out["shard"] = shard
    print(f"dryrun shard for real ({smi}): pmax {pmax}, step {step_ms:.3f} ms (median of 5, "
          f"CUDA events) against the needed-bytes bound {need_ms:.4f} ms ({need_by}, "
          f"{need} B), share {shard['needed_share']:.4f}, and the dry run's eager-byte "
          f"estimate {bound_s * 1e3:.4f} ms ({shard['bound_dominant']}), share "
          f"{shard['bound_share']:.3f}; the plain scorer's ids agree on "
          f"{shard['ids_agree_plain_scorer']:.5f}, the kernel's max error "
          f"{shard['kernel_max_abs_err']:.3g} over {len(tiles)} tiles; peak "
          f"{peak} B (arguments {real_args} + rise {rise}) against predicted "
          f"{shard['peak_bytes_dry']} B, ratio {shard['peak_ratio_real_over_dry']:.3f}; "
          f"launches {counts}")
    assert shard["ids_valid"], "the one-shard search returned a -1 or a non-finite score"
    assert len(tiles) == counts["pq_score_probes_select"] and shard["kernel_tiles_close"], \
        f"pq_score_probes_select against its plain version on the shard's tiles: {tiles}"
    assert shard["ids_agree_plain_scorer"] >= 0.99, \
        f"ids agree with the plain scorer on {shard['ids_agree_plain_scorer']}"
    assert real_args == shard["argument_bytes_dry"], \
        f"argument bytes: real {real_args}, dry run {shard['argument_bytes_dry']}"
    assert real["flops"] == shard["flops_dry"] == dryrun_flops(True, pmax), \
        f"product FLOPs: real {real['flops']}, dry run {shard['flops_dry']}"
    assert shard["probe_calls_dry"] == counts["pq_score_probes_select"], \
        f"probe scorer: {shard['probe_calls_dry']} dry calls, {counts} launches"
    assert real["collective_bytes_total"] == dry["collective_bytes_total"], \
        "collective bytes differ between the real search and its dry run"
    del ivq, Q, ids, sc, real, pids, parts, cands
    torch.cuda.empty_cache()

    # (c) the serve CLI and (d) the four examples, each a process on the card
    out["processes"] = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = launcher_procs(tmp)
        try:
            logs = {k: p.communicate(timeout=LAUNCH_TIMEOUT) for k, p in procs.items()}
        finally:
            for p in procs.values():
                p.kill()
                p.wait()
        out["processes_s"] = time.perf_counter() - t0
    for name, (o, e) in logs.items():
        rc = procs[name].returncode
        lines = o.strip().splitlines()
        out["processes"][name] = {"rc": rc, "lines": lines[-12:]}
        for line in lines[-12:]:
            print(f"launcher {name}: {line}")
        assert rc == 0, f"{name} exited {rc}: {e[-3000:]}"
    out["phase_s"] = time.perf_counter() - t_phase
    print("launchers: " + json.dumps(out))
    return Counter(counts)


# ------------------------------------------------------------------ sharded LM

def mesh_batches(seed: int, cfg, n: int, B: int, S: int) -> list:
    """n seeded numpy (B, S) token / label batches below the vocabulary."""
    rng = np.random.default_rng(seed + 22)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
             for k in ("tokens", "labels")} for _ in range(n)]


def mesh_rank_worker(args) -> int:
    """One rank of phase 22's (2, 2) mesh of gloo ranks on cuda:0 (run as
    `chip_smoke.py --rank R --world 4 --workdir DIR --job mesh`): (a) the
    sharded train steps (rank 0 also runs them unsharded), (b) sharded
    prefill and teacher-forced decode once the unsharded run's ids are in
    DIR; results to DIR/mesh<R>.pt."""
    from datetime import timedelta
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_config, get_rule_overrides
    from repro_torch.launch import specs as LS
    from repro_torch.launch.dryrun import place_out
    from repro_torch.launch.mesh import build_rules, set_mesh
    from repro_torch.launch.op_analysis import analyze
    from repro_torch.models import transformer as TT
    from repro_torch.models.layers import set_logical_rules
    from repro_torch.models.params import distribute, leaf_paths, tree_map
    from repro_torch.train import optimizer as topt
    from repro_torch.utils import set_f32_precision
    set_f32_precision()
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{args.workdir}/store",
                            rank=args.rank, world_size=args.world,
                            timeout=timedelta(seconds=MESH_TIMEOUT))
    mesh = init_device_mesh("cuda", MESH_SHAPE, mesh_dim_names=("data", "model"))
    whole = lambda t: t.full_tensor() if isinstance(t, DTensor) else t   # noqa: E731
    out = {}
    # (a) training: the dry run's train cell at (a)'s shapes, run for real
    cfg = get_config(LM_ARCH).replace(n_layers=MESH_LAYERS)
    rules = build_rules(get_rule_overrides(LM_ARCH), batch_size=MESH_B,
                        dp_degree=MESH_SHAPE[0])
    cell = SimpleNamespace(seq_len=MESH_S, global_batch=MESH_B, kind="train")
    batches = [{k: v.to(DEVICE) for k, v in b.items()}
               for b in torch.load(os.path.join(args.workdir, "mesh_batches.pt"))]
    def grads_of(tree, b, ccfg):
        leaves = tree_map(lambda a: a.detach().requires_grad_(), tree)
        paths, flat = zip(*leaf_paths(leaves))
        return dict(zip(paths, torch.autograd.grad(TT.loss_fn(leaves, b, ccfg), flat)))

    for tag, ccfg in (("bf16", cfg), ("f32", cfg.replace(compute_dtype="float32"))):
        n_steps = MESH_STEPS if tag == "bf16" else 1
        step, _, in_sh, out_sh = LS.train_cell_specs(ccfg, cell, rules, False)
        params = TT.init_params(torch.Generator().manual_seed(args.seed), ccfg, device=DEVICE)
        if tag == "f32":                        # the step's gradients, sharded and not
            set_logical_rules(rules)
            with set_mesh(mesh):
                g_mesh = {p: whole(g) for p, g in grads_of(
                    distribute(params, in_sh[0], mesh), distribute(batches[0], in_sh[2], mesh),
                    ccfg).items()}
            set_logical_rules({})
            if args.rank == 0:
                g_ref = grads_of(params, batches[0], ccfg)
                rels = {p: float((g_mesh[p] - g).abs().max() / g.abs().max().clamp(min=1e-30))
                        for p, g in g_ref.items()}
                out["f32_grad_rel"] = max(rels.values())
                out["f32_grad_worst"] = sorted(rels.items(), key=lambda kv: -kv[1])[:3]
                del g_ref
            del g_mesh
            torch.cuda.empty_cache()
        if args.rank == 0:                      # the same steps unsharded
            ref = tree_map(lambda a: a.clone(), params)
            ost = topt.init(ref)
            ref_losses = []
            for b in batches[:n_steps]:
                ref, ost, m = step(ref, ost, b)
                ref_losses.append(float(m["loss"]))
            del ost
        set_logical_rules(rules)
        with set_mesh(mesh):
            dp = distribute(params, in_sh[0], mesh)
            del params
            ost = topt.init(dp)
            losses, step_s = [], []
            for i, b in enumerate(batches[:n_steps]):
                db = distribute(b, in_sh[2], mesh)
                sync()
                t0 = time.perf_counter()
                if i == 1:                      # counted, as the dry run counts
                    an = analyze(lambda *a: place_out(step(*a), out_sh, mesh), dp, ost, db)
                    dp, ost, m = an.pop("out")
                    out["count"] = {k: an[k] for k in ("flops", "flops_by_dtype", "collectives",
                                                       "collective_bytes_total",
                                                       "argument_bytes", "host_syncs")}
                else:
                    dp, ost, m = step(dp, ost, db)
                sync()
                step_s.append(time.perf_counter() - t0)
                losses.append(float(whole(m["loss"])))
            full = tree_map(whole, dp)
        set_logical_rules({})
        rec = {"losses": losses, "step_s": step_s}
        if args.rank == 0:
            rec["ref_losses"] = ref_losses
            want = dict(leaf_paths(ref))
            diffs = {p: (a - want[p]).abs() for p, a in leaf_paths(full)}
            scale = {p: want[p].abs().max().clamp(min=1e-30) for p in want}
            rec["param_rel"] = max(float(d.max() / scale[p]) for p, d in diffs.items())
            rec["param_max_abs"] = max(float(d.max()) for d in diffs.values())
            rec["params_over_1e5"] = sum(int((d > 1e-5 * scale[p]).sum())
                                         for p, d in diffs.items())
            rec["n_params"] = sum(d.numel() for d in diffs.values())
            rec["lr0"] = float(topt.warmup_cosine(3e-4, warmup=100, total=10_000)(
                torch.zeros((), dtype=torch.int32)))
            del ref, diffs
        out[tag] = rec
        del dp, ost, full
        torch.cuda.empty_cache()
    out["train_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # (b) serving at full depth, bf16 weights, under serve_rules
    cfg = get_config(LM_ARCH).replace(param_dtype="bfloat16")
    rules = LS.serve_rules(cfg, build_rules(get_rule_overrides(LM_ARCH), batch_size=MESH_SERVE_B,
                                            dp_degree=MESH_SHAPE[0]))
    params = TT.init_params(torch.Generator().manual_seed(args.seed), cfg, device=DEVICE)
    tokens = torch.load(os.path.join(args.workdir, "mesh_prompts.pt")).to(DEVICE)
    ids_path = os.path.join(args.workdir, "mesh_ids.pt")
    set_logical_rules(rules)
    with torch.no_grad(), set_mesh(mesh):
        dp = distribute(params, TT.param_pspecs(cfg, rules), mesh)
        del params
        torch.cuda.empty_cache()
        max_seq = MESH_PROMPT + MESH_NEW
        sync()
        t0 = time.perf_counter()
        logits, caches = TT.prefill(dp, distribute({"tokens": tokens},
                                                   {"tokens": (rules["batch"], None)}, mesh),
                                    cfg, max_seq)
        caches = distribute(caches, TT.cache_pspecs(cfg, MESH_SERVE_B, max_seq, rules), mesh)
        first = whole(logits)[:, -1].float().cpu()
        sync()
        out["prefill_s"] = time.perf_counter() - t0
        t_wait = time.perf_counter()
        while not os.path.exists(ids_path):     # the unsharded run's ids, from the phase
            assert time.perf_counter() - t_wait < MESH_TIMEOUT, "no reference ids"
            time.sleep(0.2)
        time.sleep(0.5)                         # the file is written whole before polled
        ids = torch.load(ids_path).to(DEVICE)
        step_logits, step_ms = [first], []
        for i in range(MESH_NEW):
            sync()
            t0 = time.perf_counter()
            lg, caches = TT.decode_step(dp, ids[:, i:i + 1], caches, MESH_PROMPT + i, cfg)
            lg = whole(lg)
            sync()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            step_logits.append(lg[:, -1].float().cpu())
        out["decode_ms"] = step_ms
        if args.rank == 0:
            out["logits"] = torch.stack(step_logits)
    set_logical_rules({})
    out["serve_peak_bytes"] = torch.cuda.max_memory_allocated()
    torch.save(out, os.path.join(args.workdir, f"mesh{args.rank}.pt"))
    dist.destroy_process_group()
    return 0


def dryrun_worker(args) -> int:
    """Phase 22 (c)'s worker (`--job dryrun --cells shape:mesh[:profile],...
    --workdir DIR`): each of granite-3-2b's cells counted on meta tensors
    (launch/dryrun.run_cell; profile_cell where asked), the results to
    DIR/dryrun<rank>.json."""
    from repro_torch.launch.dryrun import fmt_summary, run_cell
    from repro_torch.launch.profile_cell import profile
    res = []
    for spec in args.cells.split(","):
        shape, mesh, *how = spec.split(":")
        t0 = time.perf_counter()
        r = (profile(LM_ARCH, shape, mesh == "multi") if how
             else run_cell(LM_ARCH, shape, mesh == "multi", save=False))
        r["trace_s"] = time.perf_counter() - t0
        print(fmt_summary(r), flush=True)
        res.append(r)
    with open(os.path.join(args.workdir, f"dryrun{args.rank}.json"), "w") as f:
        json.dump(res, f)
    return 0


def mesh_reference(seed: int, workdir: str) -> dict:
    """(b)'s unsharded run on the card: granite-3-2b at full depth, bf16
    weights from init_params(seed), the prompts prefilled and 64 greedy
    steps → each step's last logits (CPU f32); the ids go to workdir for
    the ranks."""
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as TT
    cfg = get_config(LM_ARCH).replace(param_dtype="bfloat16")
    params = TT.init_params(torch.Generator().manual_seed(seed), cfg, device=DEVICE)
    tokens = torch.load(os.path.join(workdir, "mesh_prompts.pt")).to(DEVICE)
    with torch.no_grad():
        logits, caches = TT.prefill(params, {"tokens": tokens}, cfg, MESH_PROMPT + MESH_NEW)
        steps = [logits[:, -1].float()]
        ids = [torch.argmax(steps[0], -1).to(torch.int32)]
        for i in range(MESH_NEW - 1):
            lg, caches = TT.decode_step(params, ids[-1][:, None], caches, MESH_PROMPT + i, cfg)
            steps.append(lg[:, -1].float())
            ids.append(torch.argmax(steps[-1], -1).to(torch.int32))
        # the step after the last id, so both runs take MESH_NEW decode steps
        lg, _ = TT.decode_step(params, ids[-1][:, None], caches, MESH_PROMPT + MESH_NEW - 1, cfg)
        steps.append(lg[:, -1].float())
    tmp = os.path.join(workdir, "mesh_ids.pt.tmp")
    torch.save(torch.stack(ids, 1).cpu(), tmp)
    os.replace(tmp, os.path.join(workdir, "mesh_ids.pt"))
    return {"logits": torch.stack(steps).cpu()}


def mesh_meta_count(seed: int) -> dict:
    """(c): (a)'s train cell counted on meta tensors over a fake (2, 2)
    group (launch/dryrun.count_cell)."""
    import torch.distributed as dist
    from repro_torch.configs import get_config, get_rule_overrides
    from repro_torch.launch.dryrun import count_cell, fake_group
    from repro_torch.launch.mesh import build_rules, make_test_mesh
    cfg = get_config(LM_ARCH).replace(n_layers=MESH_LAYERS)
    rules = build_rules(get_rule_overrides(LM_ARCH), batch_size=MESH_B, dp_degree=MESH_SHAPE[0])
    fake_group(MESH_SHAPE[0] * MESH_SHAPE[1])
    try:
        mesh = make_test_mesh(MESH_SHAPE, device_type="cpu")
        an = count_cell(cfg, SimpleNamespace(seq_len=MESH_S, global_batch=MESH_B, kind="train"),
                        rules, mesh, False)
    finally:
        dist.destroy_process_group()
    return {k: an[k] for k in ("flops", "flops_by_dtype", "collectives",
                               "collective_bytes_total", "argument_bytes", "seconds")}


def mesh_phase(seed: int, smi: str, wrappers: dict) -> None:
    """22. The sharded LM: (a) training and (b) serving on a (2, 2) mesh of
    4 gloo ranks on cuda:0, (c) the LM dry run (module docstring)."""
    from repro_torch.configs import get_config
    t_phase = time.perf_counter()
    cfg = get_config(LM_ARCH)
    env_vars = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
    world = MESH_SHAPE[0] * MESH_SHAPE[1]
    with tempfile.TemporaryDirectory() as tmp:
        dry = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(i), "--world", "1",
             "--workdir", tmp, "--job", "dryrun", "--cells", cells], env=env_vars,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i, cells in enumerate(DRYRUN_WORKERS)]
        torch.save(mesh_batches(seed, cfg, MESH_STEPS, MESH_B, MESH_S),
                   os.path.join(tmp, "mesh_batches.pt"))
        rng = np.random.default_rng(seed + 23)
        torch.save(torch.from_numpy(rng.integers(0, cfg.vocab_size, (MESH_SERVE_B, MESH_PROMPT))
                                    .astype(np.int32)), os.path.join(tmp, "mesh_prompts.pt"))
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r), "--world",
             str(world), "--workdir", tmp, "--job", "mesh", "--seed", str(seed)], env=env_vars,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for r in range(world)]
        try:
            def run():
                res = {"reference": mesh_reference(seed, tmp)}
                torch.cuda.empty_cache()
                res["meta"] = mesh_meta_count(seed)
                logs = [p.communicate(timeout=MESH_TIMEOUT) for p in procs]
                for p, (o, e) in zip(procs, logs):
                    assert p.returncode == 0, f"a mesh rank failed ({p.returncode}): {e[-3000:]}"
                res["ranks"] = [torch.load(os.path.join(tmp, f"mesh{r}.pt"))
                                for r in range(world)]
                res["ranks_s"] = time.perf_counter() - t_phase
                dlogs = [p.communicate(timeout=MESH_TIMEOUT) for p in dry]
                for p, (o, e) in zip(dry, dlogs):
                    assert p.returncode == 0, f"a dry-run worker failed: {e[-3000:]}"
                res["dry_lines"] = [o for o, _ in dlogs]
                res["dry"] = [r for i in range(len(dry))
                              for r in json.load(open(os.path.join(tmp, f"dryrun{i}.json")))]
                return res
            res, counts = drive(wrappers, (), run)
        finally:
            for p in procs + dry:
                p.kill()
                p.wait()
    r0 = res["ranks"][0]
    ref, got = res["reference"]["logits"], r0["logits"]
    step_rel = ((got - ref).abs().amax(dim=(1, 2)) / ref.abs().amax(dim=(1, 2))).tolist()
    differ = got.argmax(-1) != ref.argmax(-1)
    agree = 1.0 - float(differ.float().mean())
    # a differing argmax only where the reference's top two lie within twice
    # the row's largest logit difference of each other (a near-tie)
    top2 = ref.topk(2, dim=-1).values
    gap = top2[..., 0] - top2[..., 1]
    row_err = (got - ref).abs().amax(dim=-1)
    ties_only = bool((gap[differ] <= 2 * row_err[differ]).all())
    meta, real = res["meta"], r0["count"]
    out = dict(
        card=smi, launches=counts, mesh=list(MESH_SHAPE), ranks=world,
        train=dict(layers=MESH_LAYERS, batch=MESH_B, seq=MESH_S,
                   f32_grad_worst=r0["f32_grad_worst"],
                   bf16=r0["bf16"], f32=r0["f32"],
                   step_s_by_rank=[r["bf16"]["step_s"] for r in res["ranks"]],
                   peak_bytes_by_rank=[r["train_peak_bytes"] for r in res["ranks"]],
                   counted=real),
        serve=dict(batch=MESH_SERVE_B, prompt=MESH_PROMPT, new=MESH_NEW,
                   prefill_s_by_rank=[r["prefill_s"] for r in res["ranks"]],
                   decode_ms_median_by_rank=[float(np.median(r["decode_ms"]))
                                             for r in res["ranks"]],
                   peak_bytes_by_rank=[r["serve_peak_bytes"] for r in res["ranks"]],
                   step_rel=step_rel, argmax_agreement=agree,
                   differing_only_at_near_ties=ties_only,
                   differing_gaps=gap[differ].tolist(),
                   differing_row_errors=row_err[differ].tolist()),
        meta_count=meta,
        dryrun=[{k: r.get(k) for k in ("shape", "mesh", "skipped", "trace_s", "per_device",
                                       "memory", "collective_bytes_total", "roofline")}
                for r in res["dry"]],
        ranks_s=res["ranks_s"], phase_s=time.perf_counter() - t_phase)
    bf, f32 = r0["bf16"], r0["f32"]
    bf_gap = max(abs(a - b) / abs(b) for a, b in zip(bf["losses"], bf["ref_losses"]))
    f32_gap = max(abs(a - b) / abs(b) for a, b in zip(f32["losses"], f32["ref_losses"]))
    out["train"].update(bf16_loss_gap=bf_gap, f32_loss_gap=f32_gap,
                        f32_grad_rel=r0["f32_grad_rel"])
    print(f"mesh train granite-3-2b at {MESH_LAYERS} layers on {MESH_SHAPE} gloo ranks ({smi}): "
          f"{MESH_B} x {MESH_S} tokens; bf16 losses {bf['losses']} vs unsharded "
          f"{bf['ref_losses']} (gap {bf_gap:.3e}, params {bf['param_rel']:.3e}); f32 step "
          f"loss gap {f32_gap:.3e}, gradients {r0['f32_grad_rel']:.3e}, params "
          f"{f32['param_rel']:.3e} ({f32['params_over_1e5']} of {f32['n_params']} past 1e-5, "
          f"largest {f32['param_max_abs'] / f32['lr0']:.3f} x lr); step s by rank "
          f"{out['train']['step_s_by_rank']}; collective bytes a step "
          f"{real['collective_bytes_total']:.0f} ({real['collectives']}); product FLOPs "
          f"{real['flops']:.4e}; peak bytes by rank {out['train']['peak_bytes_by_rank']}")
    s = out["serve"]
    print(f"mesh serve granite-3-2b on {MESH_SHAPE} gloo ranks ({smi}): {MESH_SERVE_B} x "
          f"{MESH_PROMPT} prompts, {MESH_NEW} teacher-forced steps; prefill s by rank "
          f"{s['prefill_s_by_rank']}; decode ms a step (median) by rank "
          f"{s['decode_ms_median_by_rank']}; max step |dlogit|/|logit| {max(step_rel):.3e}, "
          f"argmax agreement {agree:.4f} ({int(differ.sum())} differ, each at a top-2 gap "
          f"within twice its row's logit difference: {ties_only}); peak bytes by rank "
          f"{s['peak_bytes_by_rank']}")
    print(f"mesh dry run of ({MESH_SHAPE}) cell ({smi}): meta FLOPs {meta['flops']:.4e} vs "
          f"rank 0 {real['flops']:.4e}; collectives meta {meta['collectives']} vs rank 0 "
          f"{real['collectives']}; argument bytes {meta['argument_bytes']} vs "
          f"{real['argument_bytes']}; traced in {meta['seconds']:.1f} s")
    for lines in res["dry_lines"]:
        for line in lines.splitlines():
            print(f"mesh dryrun ({smi}): {line}")
    for r in res["dry"]:
        print(f"mesh dryrun {r['shape']} {r['mesh']}: trace {r['trace_s']:.1f} s")
    print("mesh: " + json.dumps(out))
    assert not any(counts.values()), f"the sharded LM launched a kernel of the six: {counts}"
    assert bf_gap <= MESH_BF16_LOSS_BAR, f"bf16 sharded loss off by {bf_gap}"
    assert f32_gap < 1e-5 and r0["f32_grad_rel"] < 1e-5, (f32_gap, r0["f32_grad_rel"])
    # AdamW's first update is lr·g/(|g| + eps) per element: a gradient within
    # rounding of 0 may take either sign, so one element moves by at most 2·lr
    assert f32["param_max_abs"] <= 2 * f32["lr0"] * (1 + 1e-3), f32
    assert max(step_rel) <= 2e-2 and ties_only, (max(step_rel), agree)
    assert meta["flops"] == real["flops"], (meta["flops"], real["flops"])
    assert meta["collectives"] == real["collectives"], (meta["collectives"], real["collectives"])
    assert meta["argument_bytes"] == real["argument_bytes"]
    assert real["host_syncs"] == [], real["host_syncs"]
    assert len(res["dry"]) == sum(len(w.split(",")) for w in DRYRUN_WORKERS)
    for r in res["dry"]:      # granite is not sub-quadratic: long_500k alone is skipped
        assert ("skipped" in r) == (r["shape"] == "long_500k"), r
        assert "skipped" in r or r["per_device"]["flops"] > 0, r


def ann_phases(args):
    """Phases 1-18 → (nvidia-smi's name and power limit, the device's
    name, the kernels' wrappers, the kernel records); their tensors are
    freed when it returns."""
    from repro_torch import faults
    from repro_torch.analysis import contracts as contracts_mod
    from repro_torch.ckpt import CorruptSnapshotError, MutationWAL
    from repro_torch.core import (build_ivf, build_ivf_sharded, kmr_curve, pack_ivf,
                                  points_to_recall, rank_statistics, recall_at_k,
                                  router as router_mod, search, search_jit_batched,
                                  true_neighbors)
    from repro_torch.core.analysis import (angle_correlation, pair_stats,
                                           score_error_correlation)
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core import kmeans as kmeans_mod
    from repro_torch.core.build import assign_shards
    from repro_torch.core.kmeans import train_kmeans
    from repro_torch.core.mutable import MutableIVF
    from repro_torch.core import distributed as dist_mod
    from repro_torch.core.distributed import (
        build_sharded_ivf_pq, load_sharded, make_distributed_search,
        make_distributed_search_pq, make_replicated_search, make_sharded_assign,
        save_sharded, shard_filters, shard_generator, sharded_from_indexes,
        sharded_from_indexes_pq, stack_tree_routers)
    from repro_torch.core.search import dedup_ranked, pad_queries, search_numpy
    from repro_torch.core.router import FlatRouter
    from repro_torch.data.vectors import make_manifold
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import lloyd as lloyd_mod
    from repro_torch.kernels import soar_assign as soar_mod
    from repro_torch.kernels.int8_rerank import int8_rerank
    from repro_torch.kernels.kmeans_pp import kmeans_pp
    from repro_torch.kernels.lloyd import lloyd_sweep
    from repro_torch.kernels.pq_score import pq_score, pq_score_probes, pq_score_probes_select
    from repro_torch.kernels.soar_assign import soar_assign, spill_columns, unit_residuals
    from repro_torch.kernels.tree_route import tree_route
    from repro_torch.kernels.vq_assign import vq_assign
    from repro_torch.quant import anisotropic as aniso_mod
    from repro_torch.quant.int8 import int8_dequantize, int8_quantize
    from repro_torch.quant.pq import PQCodebook, pq_lut
    from repro_torch.serve.api import (DeadlineExceededError, FrontendClosedError,
                                       OverloadedError, SearchParams)
    from repro_torch.serve.engine import AnnEngine
    from repro_torch.serve.frontend import ServingFrontend
    from repro_torch.serve.health import HealthTracker
    from repro_torch.serve.knn_memory import KNNMemory, exact_topk_attention
    from repro_torch.utils import set_f32_precision, topk_first, topk_inner_product

    set_f32_precision()
    wrappers = {"pq_score_probes": pq_score_probes,
                "pq_score_probes_select": pq_score_probes_select, "vq_assign": vq_assign,
                "soar_assign": soar_assign, "lloyd_sweep": lloyd_sweep,
                "tree_route": tree_route, "pq_score": pq_score, "kmeans_pp": kmeans_pp,
                "int8_rerank": int8_rerank}

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    kind = torch.cuda.get_device_name(0)
    sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {kind} "
          f"count {torch.cuda.device_count()}")

    # 2. build
    t0 = time.perf_counter()
    lib = _build.library_path()
    _build.library()
    print(f"build: {lib.name} in {time.perf_counter() - t0:.2f} s")

    # 3. main path: build (tree router included), pack, flat search
    t0 = time.perf_counter()
    ds = make_manifold(args.seed, N, D, nq=NQ, device=DEVICE)
    sync()
    print(f"data: {N} x {D}, {NQ} queries in {time.perf_counter() - t0:.2f} s")
    search_kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=BUDGET, bq=BQ)

    torch.cuda.reset_peak_memory_stats()
    phases: dict = {}
    times: dict = {}

    def main_path():
        idx, times["build_s"] = timed(lambda: build_ivf_sharded(
            torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode="soar",
            lam=1.0, pq_subspaces=M, rerank="f32", train_sample=TRAIN_SAMPLE,
            shard_size=SHARD, timings=phases, device=DEVICE, router="tree"))
        packed, times["pack_s"] = timed(lambda: pack_ivf(idx))
        flat = FlatRouter(packed.centroids)
        _, times["first_search_s"] = timed(
            lambda: search_jit_batched(packed, ds.Q, router=flat, **search_kw))
        mem["peak_before_warm_search"] = torch.cuda.max_memory_allocated()
        mem["resident_before_warm_search"] = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        (ids, _), times["search_s"] = timed(
            lambda: search_jit_batched(packed, ds.Q, router=flat, **search_kw))
        mem["warm_search_peak"] = torch.cuda.max_memory_allocated()
        return idx, packed, flat, ids

    mem: dict = {}
    (idx, packed, flat, ids), launches = drive(
        wrappers, ("lloyd_sweep", "vq_assign", "soar_assign", "pq_score_probes_select", "kmeans_pp"),
        main_path)
    lloyd_shapes = dict(lloyd_sweep.shapes)
    peak_mem = max(mem["peak_before_warm_search"], mem["warm_search_peak"])
    rt = idx.router
    pmax = int(packed.part_ids.shape[1])
    sizes = idx.partition_sizes().float()
    gt = true_neighbors(ds.X, ds.Q, k=FINAL_K, chunk=65_536)
    recall = recall_at_k(ids, gt, FINAL_K)
    with plain_version(search, "pq_score_probes_select", ref.pq_score_probes_select_ref):
        plain_ids, _ = search_jit_batched(packed, ds.Q, router=flat, **search_kw)
    agree = float((plain_ids == ids).float().mean())
    # the build's assignment against the same shards through the plain versions
    with plain_version(soar_mod, "vq_assign_prepared",
                       lambda X, cb: ref.vq_assign_ref(X, cb.C)), \
            plain_version(soar_mod, "soar_assign_prepared",
                          lambda X, R, P, cb, lam: ref.soar_assign_ref(X, R, P, cb.C, lam)):
        plain_assign = assign_shards(ds.X, idx.centroids, spill_mode="soar", lam=1.0,
                                     shard_size=SHARD)
    assign_agree = [float((plain_assign[:, j] == idx.assignments[:, j]).float().mean())
                    for j in range(idx.assignments.shape[1])]
    del plain_assign
    # four more warm searches: the spread of the host-bound search time
    runs = [times["search_s"]] + [timed(lambda: search_jit_batched(
        packed, ds.Q, router=flat, **search_kw))[1] for _ in range(4)]
    _, times["spill_assign_warm_s"] = timed(lambda: assign_shards(
        ds.X, idx.centroids, spill_mode="soar", lam=1.0, shard_size=SHARD))
    times["assign_fused_shard_ms"] = time_ms(
        lambda: soar_mod.assign_fused(ds.X[:SHARD], idx.centroids, 1.0, 1))
    tiles = -(-NQ // BQ)
    stages = tile_stages(search, packed, ds.Q[:BQ], flat)
    summary = {
        "n": N, "d": D, "nq": NQ, "c": C, "m": M, "top_t": TOP_T,
        "rerank_budget": BUDGET, "bq": BQ, **times, "build_phases_s": phases,
        "qps": NQ / times["search_s"], "search_s_runs": runs,
        "qps_median": NQ / sorted(runs)[2], "recall_at_10": recall,
        "ids_agree_plain_scorer": agree,
        "assignments_agree_plain_by_column": assign_agree,
        "max_memory_allocated_bytes": peak_mem,
        "warm_search_peak_bytes": mem["warm_search_peak"],
        "warm_search_peak_above_resident_bytes":
            mem["warm_search_peak"] - mem["resident_before_warm_search"],
        "tile_stage_ms": stages, "lloyd_launches_by_shape": lloyd_shapes,
        "n_assignments": idx.n_assignments, "pmax": pmax,
        "mean_partition": float(sizes.mean()), "window": TOP_T * pmax,
        "launches": launches,
    }
    print("main path: " + json.dumps(summary))
    assert recall >= 0.85, f"recall@10 {recall} < 0.85"
    assert agree >= 0.99, f"ids agree with the plain scorer on {agree} < 0.99"
    assert min(assign_agree) >= 0.999, \
        f"assignments agree with the plain versions on {assign_agree} < 0.999"
    assert launches["pq_score_probes_select"] == 2 * tiles, \
        f"selecting-scorer launches {launches} != one per tile of two searches"

    # 4. tree-routed search through the index's router, warm
    search_jit_batched(packed, ds.Q, **search_kw)
    (tids, tsearch_s), tlaunch = drive(
        wrappers, ("tree_route", "pq_score_probes_select"),
        lambda: timed(lambda: search_jit_batched(packed, ds.Q, **search_kw)[0]))
    truns = [tsearch_s] + [timed(lambda: search_jit_batched(packed, ds.Q, **search_kw))[1]
                           for _ in range(4)]
    trecall = recall_at_k(tids, gt, FINAL_K)
    with plain_version(router_mod, "tree_route",
                       lambda Q, SC, CC, CH, t, **_: ref.tree_route_ref(Q, SC, CC, CH, t)):
        tplain, _ = search_jit_batched(packed, ds.Q, **search_kw)
    tagree = float((tplain == tids).float().mean())
    tree_summary = {
        "n_super": rt.n_super, "t_route": rt.eff_t_route, "cmax": rt.cmax,
        "search_s": tsearch_s, "qps": NQ / tsearch_s, "search_s_runs": truns,
        "qps_median": NQ / sorted(truns)[2], "recall_at_10": trecall,
        "recall_ratio_to_flat": trecall / recall,
        "probe_flops_ratio_to_flat": rt.probe_flops(TOP_T) / flat.probe_flops(TOP_T),
        "ids_agree_plain_route": tagree, "launches": tlaunch,
    }
    print("tree search: " + json.dumps(tree_summary))
    assert trecall >= 0.85, f"tree recall@10 {trecall} < 0.85"
    assert tlaunch["tree_route"] == tiles, f"tree_route launches {tlaunch} != {tiles}"
    assert tagree >= 0.99, f"tree ids agree with the plain route on {tagree} < 0.99"

    # 5. filtered tree-routed search
    perm = torch.randperm(N, generator=torch.Generator().manual_seed(args.seed))
    fsummary = {}
    for sel in SELECTIVITIES:
        keep = perm[:int(N * sel)].sort().values.to(DEVICE)
        bits = torch.zeros(N, dtype=torch.uint8, device=DEVICE)
        bits[keep] = 1
        _, fidx = topk_inner_product(ds.Q, ds.X[keep], FINAL_K, chunk=65_536)
        fgt = keep[fidx.long()].to(torch.int32)
        runs = {}
        for esc in (True, False):
            fids, flaunch = drive(wrappers, ("tree_route", "pq_score_probes_select"),
                                  lambda: search_jit_batched(packed, ds.Q, filter=bits,
                                                             escalate=esc, **search_kw)[0])
            got = fids[fids >= 0].long()
            assert bool((bits[got] > 0).all()), "a filtered-out id was returned"
            runs["escalated" if esc else "unescalated"] = {
                "recall_at_10": recall_at_k(fids, fgt, FINAL_K),
                "ids_returned_share": float((fids >= 0).float().mean()),
                "launches": flaunch}
        thin = sum(int((search._search_pass(packed, ds.Q[i0:i0 + BQ], rt, TOP_T,
                                            FINAL_K, BUDGET, 2, bits)[2] < BUDGET).sum())
                   for i0 in range(0, NQ, BQ))
        fsummary[str(sel)] = {"kept": int(keep.numel()),
                              "thin_first_pass_share": thin / NQ, **runs}
        assert runs["escalated"]["recall_at_10"] >= runs["unescalated"]["recall_at_10"], \
            f"escalation lowered filtered recall at selectivity {sel}"
    print("filtered search: " + json.dumps(fsummary))

    # 6. dense PQ scan of one tile of queries over every code row
    Qb = ds.Q[:BQ]
    luts = pq_lut(packed.pq, Qb)
    part = torch.repeat_interleave(torch.arange(C, device=DEVICE), idx.partition_sizes())
    dids, dlaunch = drive(wrappers, ("pq_score",),
                          lambda: dense_scan(ops.pq_score, luts, Qb, idx, part, FINAL_K))
    dplain = dense_scan(ref.pq_score_ref, luts, Qb, idx, part, FINAL_K)
    dagree = float((dplain == dids).float().mean())
    dsummary = {"queries": BQ, "rows": idx.n_assignments,
                "recall_at_10": recall_at_k(dids, gt[:BQ], FINAL_K),
                "ids_agree_plain_scorer": dagree, "launches": dlaunch}
    print("dense scan: " + json.dumps(dsummary))
    assert dagree >= 0.99, f"dense ids agree with the plain scorer on {dagree} < 0.99"
    path_launches = Counter()
    for counts in (launches, tlaunch, dlaunch):
        path_launches.update(counts)

    # 7. tombstones inside partitions, searched flat on the card
    tomb = tombstoned(packed, args.seed)
    (tids_t, tomb_s), tomb_launch = drive(
        wrappers, ("pq_score_probes_select",),
        lambda: timed(lambda: search_jit_batched(tomb, ds.Q, router=flat, **search_kw)[0]))
    path_launches.update(tomb_launch)
    with plain_version(search, "pq_score_probes_select", ref.pq_score_probes_select_ref):
        tplain_t, _ = search_jit_batched(tomb, ds.Q, router=flat, **search_kw)
    live_slots = tomb.sizes[flat.route(ds.Q, TOP_T)[1]].sum(-1)
    enough = live_slots >= 2 * FINAL_K
    tomb_summary = {
        "dead_slots": int((packed.part_ids >= 0).sum() - (tomb.part_ids >= 0).sum()),
        "slots_past_live_count": int((tomb.extent - tomb.sizes).sum()),
        "rows_with_2k_live_slots": int(enough.sum()),
        "minus1_in_those_rows": int((tids_t[enough] < 0).sum()),
        "ids_agree_plain_scorer": float((tplain_t == tids_t).float().mean()),
        "recall_at_10_vs_untombstoned_gt": recall_at_k(tids_t, gt, FINAL_K),
        "search_s": tomb_s, "launches": tomb_launch}
    print("tombstones: " + json.dumps(tomb_summary))
    assert tomb_summary["minus1_in_those_rows"] == 0, "a -1 came back while live points remained"
    assert tomb_summary["ids_agree_plain_scorer"] >= 0.99, \
        f"tombstoned ids agree with the plain scorer on {tomb_summary['ids_agree_plain_scorer']}"
    del tomb, tids_t, tplain_t

    # 8. k-means modes on the training sample
    Xt = ds.X[:TRAIN_SAMPLE].contiguous()
    modes = {"parallel": dict(init="parallel"), "minibatch": dict(batch_size=16_384),
             "spherical": dict(spherical=True), "pp": {}}
    ksummary = {}
    for name, kw in modes.items():
        seeds = () if name == "parallel" else ("kmeans_pp",)
        (res, secs), klaunch = drive(wrappers, ("lloyd_sweep",) + seeds, lambda: timed(
            lambda: train_kmeans(torch.Generator().manual_seed(args.seed), Xt, C, **kw)))
        assert klaunch["kmeans_pp"] == len(seeds), \
            f"k-means {name}: {klaunch['kmeans_pp']} seeding launches"
        path_launches.update(klaunch)
        ksummary[name] = {"distortion": float(res.distortion), "seconds": secs,
                          "sweeps": len(res.history), "launches": klaunch}
    with plain_version(kmeans_mod, "lloyd_sweep", ref.lloyd_sweep_ref):
        res, secs = timed(lambda: train_kmeans(torch.Generator().manual_seed(args.seed), Xt, C))
    ksummary["plain_lloyd"] = {"distortion": float(res.distortion), "seconds": secs,
                               "sweeps": len(res.history)}
    print("k-means modes: " + json.dumps(ksummary))
    for name in ("parallel", "minibatch"):
        assert ksummary[name]["distortion"] <= 1.05 * ksummary["pp"]["distortion"], \
            f"{name} k-means distortion more than 5% above the baseline's"

    # 9-10. the variants' builds, with their plain-torch work counted
    plain_calls: Counter = Counter()
    counted = ((soar_mod, "spill_columns"), (aniso_mod, "anisotropic_assign"),
               (aniso_mod, "_anisotropic_update"), (ivf_mod, "int8_quantize"))

    def variant(build):
        """Build, pack and search twice (cold, warm) → (index, packed, ids,
        numbers); peak memory over the whole variant."""
        out = {"build_phases_s": {}}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        with ExitStack() as stack:
            for mod, name in counted:
                stack.enter_context(counting(mod, name, plain_calls))
            vidx, out["build_s"] = timed(lambda: build(out["build_phases_s"]))
        vpacked = pack_ivf(vidx)
        vflat = FlatRouter(vpacked.centroids)
        _, out["first_search_s"] = timed(
            lambda: search_jit_batched(vpacked, ds.Q, router=vflat, **search_kw))
        (vids, _), out["search_s"] = timed(
            lambda: search_jit_batched(vpacked, ds.Q, router=vflat, **search_kw))
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        out["search_s_runs"] = [out["search_s"]] + [timed(lambda: search_jit_batched(
            vpacked, ds.Q, router=vflat, **search_kw))[1] for _ in range(4)]
        out["qps"] = NQ / out["search_s"]
        out["qps_median"] = NQ / sorted(out["search_s_runs"])[2]
        out["recall_at_10"] = recall_at_k(vids, gt, FINAL_K)
        out["main_path_recall_at_10"] = recall
        out["n_assignments"] = vidx.n_assignments
        return vidx, out

    (aidx, asum), alaunch = drive(
        wrappers, ("lloyd_sweep", "vq_assign", "soar_assign", "pq_score_probes_select", "kmeans_pp"),
        lambda: variant(lambda ph: build_ivf_sharded(
            torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode="soar",
            n_spills=2, lam=1.0, anisotropic_T=ANISO_T, rerank="int8", pq_subspaces=M,
            train_sample=TRAIN_SAMPLE, shard_size=SHARD, timings=ph, device=DEVICE)))
    path_launches.update(alaunch)
    a = aidx.assignments
    srt = torch.sort(a, dim=1).values
    with plain_version(soar_mod, "vq_assign_prepared",
                       lambda X, cb: ref.vq_assign_ref(X, cb.C)), \
            plain_version(soar_mod, "soar_assign_prepared",
                          lambda X, R, P, cb, lam: ref.soar_assign_ref(X, R, P, cb.C, lam)):
        aplain = assign_shards(ds.X, aidx.centroids, spill_mode="soar", lam=1.0,
                               n_spills=2, shard_size=SHARD)
    qcpu = int8_quantize(ds.X[:SHARD].cpu())
    asum.update({
        "memory_bytes_int8": aidx.memory_bytes("int8"),
        "columns_distinct": bool((srt[:, 1:] != srt[:, :-1]).all()),
        "assignments_agree_plain_by_column":
            [float((aplain[:, j] == a[:, j]).float().mean()) for j in range(3)],
        "int8_equal_cpu_first_rows":
            bool(torch.equal(aidx.rerank_int8.q[:SHARD].cpu(), qcpu.q)
                 and torch.equal(aidx.rerank_int8.scale[:SHARD].cpu(), qcpu.scale)),
        "launches": alaunch})
    print("variant A: " + json.dumps(asum))
    assert asum["recall_at_10"] >= 0.85, f"variant A recall@10 {asum['recall_at_10']} < 0.85"
    assert asum["columns_distinct"], "variant A: a row has two equal columns"
    assert min(asum["assignments_agree_plain_by_column"]) >= 0.999, \
        f"variant A columns agree with the plain versions on " \
        f"{asum['assignments_agree_plain_by_column']} < 0.999"
    assert asum["int8_equal_cpu_first_rows"], "variant A int8 rows differ from the CPU's"
    del aidx, aplain, a, srt

    (bidx, bsum), blaunch = drive(
        wrappers, ("lloyd_sweep", "soar_assign", "pq_score_probes_select", "kmeans_pp"),
        lambda: variant(lambda ph: build_ivf(
            torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode="soar",
            n_spills=1, anisotropic_T=ANISO_T, rerank="f32", pq_subspaces=M,
            timings=ph, device=DEVICE)))
    path_launches.update(blaunch)
    bprim = bidx.assignments[:, 0].contiguous()
    bspill = ref.soar_assign_ref(ds.X, unit_residuals(ds.X, bidx.centroids, bprim),
                                 bprim, bidx.centroids, 1.0)[0]
    bsum.update({"spill_agree_plain": float((bspill == bidx.assignments[:, 1]).float().mean()),
                 "launches": blaunch})
    print("variant B: " + json.dumps(bsum))
    assert bsum["recall_at_10"] >= 0.85, f"variant B recall@10 {bsum['recall_at_10']} < 0.85"
    assert bsum["spill_agree_plain"] >= 0.999, \
        f"variant B spills agree with soar_assign_ref on {bsum['spill_agree_plain']} < 0.999"
    del bidx, bspill, bprim

    # 11. serving: the main index behind AnnEngine, mutated online
    def serving():
        """Wrap the main index, search, churn it, soft-remove, harden and
        compact, rebuild, run the host engine → numbers (checks below)."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        mut, out["wrap_s"] = timed(lambda: MutableIVF.from_index(idx))
        eng = AnnEngine(mut, top_t=TOP_T, rerank_budget=BUDGET, bq=BQ)
        Qn = ds.Q.cpu().numpy()
        out["capacity"] = {"slots": int(mut.part_ids.shape[1]), "pmax": pmax,
                           "rerank_rows": int(mut.rerank.shape[0])}
        _, out["first_search_s"] = timed(lambda: eng.search(Qn, k=FINAL_K))
        r, out["search_s"] = timed(lambda: eng.search_request(Qn, SearchParams(k=FINAL_K)))
        out["qps"] = NQ / out["search_s"]
        out["engine_us"] = r.engine_us
        out["ids_agree_tree_search"] = float((torch.from_numpy(r.ids) == tids.cpu())
                                             .float().mean())
        g = torch.Generator().manual_seed(args.seed + 1)
        dead, rounds = [], []
        out["returned_removed"] = 0

        def n_dead(ids):
            """How many of the (numpy) result ids were removed."""
            return int(torch.isin(torch.from_numpy(ids).long(), torch.cat(dead)).sum())

        def delta_matches_full(delta) -> bool:
            """The delta pack against a full repack. Its ids, codes and
            rerank rows are the index's own tensors (a view, the same by
            construction); what the delta computes — sizes, extent and the
            pruned router's children — must equal the repack's."""
            view = all(a.data_ptr() == b.data_ptr() for a, b in (
                (delta.part_ids, mut.part_ids), (delta.part_codes, mut.part_codes),
                (delta.rerank, mut.rerank)))
            mut.invalidate_snapshots()
            full = mut.pack()
            return view and full is not delta and all(torch.equal(a, b) for a, b in (
                (delta.sizes, full.sizes), (delta.extent, full.extent),
                (delta.router.children, full.router.children)))

        same_assign = delta_equal = via_delta = 0
        for _ in range(ROUNDS):
            live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
            victims = live[torch.randperm(live.numel(), generator=g)[:CHURN].to(DEVICE)]
            vecs = mut.rerank[victims].clone()
            before = mut.assignments[victims].clone()
            t = {}
            _, t["remove"] = timed(lambda: eng.remove(victims))
            new, t["add"] = timed(lambda: eng.add(vecs))
            via_delta += mut._packed is not None and mut._dirty_parts is not None
            delta, t["pack"] = timed(mut.pack)
            res, t["search"] = timed(lambda: eng.search_request(
                Qn[:BQ], SearchParams(k=FINAL_K)))
            rounds.append({f"{k}_ms": v * 1e3 for k, v in t.items()})
            dead.append(victims.cpu())
            newt = torch.from_numpy(new).to(DEVICE).long()
            same_assign += int((mut.assignments[newt] == before).all(dim=1).sum())
            delta_equal += int(delta_matches_full(delta))
            out["returned_removed"] += n_dead(res.ids)
        out["rounds_ms"] = rounds
        out["rounds_ms_median"] = {k: sorted(r_[k] for r_ in rounds)[ROUNDS // 2]
                                   for k in rounds[0]}
        out["readded_same_assignments_share"] = same_assign / (ROUNDS * CHURN)
        out["delta_pack_equal_rounds"] = delta_equal
        out["rounds_through_delta"] = via_delta      # the first grows the rows
        out["rerank_rows_after_churn"] = int(mut.rerank.shape[0])
        out["peak_after_rounds_bytes"] = torch.cuda.max_memory_allocated()
        # the last round's re-added vectors, searched for themselves
        own, _ = eng.search(vecs.cpu().numpy(), k=FINAL_K)
        out["readded_in_own_top10"] = float((own == new[:, None]).any(1).mean())
        out["readded_top1"] = float((own[:, 0] == new).mean())
        # prune: empty every child of the super most queries rank first, and
        # one child of the next, so the served router holds a super with no
        # child left and a -1 inside a row; then re-add them, which un-prunes
        trained, served = mut.router, mut.pack().router
        first = torch.bincount((ds.Q @ trained.super_centroids.T).argmax(1),
                               minlength=trained.n_super)
        s1, s2 = torch.topk(first, 2).indices.tolist()
        ch1, ch2 = served.children[s1], served.children[s2]
        emptied = torch.cat([ch1[ch1 >= 0], ch2[ch2 >= 0][:1]]).long()
        slots = mut.part_ids[emptied]
        gone = torch.unique(slots[slots >= 0])
        gone_vecs, gone_assign = mut.rerank[gone].clone(), mut.assignments[gone].clone()
        _, out["prune_remove_ms"] = timed(lambda: eng.remove(gone))
        out["prune_through_delta"] = mut._packed is not None and mut._dirty_parts is not None
        pruned, out["prune_pack_ms"] = timed(mut.pack)
        pch = pruned.router.children
        out["prune"] = {
            "supers": [s1, s2], "partitions_emptied": int(emptied.numel()),
            "ids_removed": int(gone.numel()),
            "children_pruned": int(((pch < 0) & (served.children >= 0)).sum()),
            "queries_reaching_emptied_super": int(
                (torch.topk(ds.Q @ trained.super_centroids.T, trained.eff_t_route).indices
                 == s1).any(1).sum())}
        out["prune_shape_ok"] = (pruned.router is not served and bool((pch[s1] < 0).all())
                                 and int((pch[s2] < 0).sum()) == int((ch2 < 0).sum()) + 1)
        live_parts = (mut.part_ids >= 0).any(dim=1)

        class LiveOnly(type(trained)):
            """The trained tables' route with dead partitions' candidates
            at -inf: the tree search restricted to live partitions,
            reckoned without `pruned`."""

            def route(self, Q, top_t):
                sc, cand = tree_route(Q, self.super_centroids, self.child_centroids,
                                      self.children, self.eff_t_route, checked=True)
                dead_c = (cand >= 0) & ~live_parts[cand.clamp(min=0).long()]
                v, pos = topk_first(sc.masked_fill(dead_c, float("-inf")),
                                    min(top_t, sc.shape[-1]))
                return v, torch.gather(cand, -1, pos).clamp(min=0)

        pr, out["pruned_search_s"] = timed(lambda: eng.search_request(
            Qn, SearchParams(k=FINAL_K)))
        lids, _ = search_jit_batched(pruned, ds.Q, router=LiveOnly(
            trained.super_centroids, trained.children, trained.child_centroids,
            trained.t_route, trained.n_partitions), **search_kw)
        out["pruned_ids_agree_live_route"] = float(
            (torch.from_numpy(pr.ids) == lids.cpu()).float().mean())
        dead.append(gone.cpu())
        out["returned_removed"] += n_dead(pr.ids)
        out["prune_delta_equal"] = delta_matches_full(pruned)
        back, out["prune_readd_ms"] = timed(lambda: eng.add(gone_vecs))
        back = torch.from_numpy(back).to(DEVICE).long()
        out["prune_readd_same_assignments_share"] = float(
            (mut.assignments[back] == gone_assign).all(dim=1).float().mean())
        out["unpruned_after_readd"] = torch.equal(mut.pack().router.children,
                                                  served.children)
        for k in ("prune_remove_ms", "prune_pack_ms", "prune_readd_ms"):
            out[k] *= 1e3
        # soft removal through the standing filter, then harden and compact
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
        soft = live[torch.randperm(live.numel(), generator=g)[:SOFT].to(DEVICE)]
        _, out["soft_remove_ms"] = timed(lambda: eng.remove(soft, hard=False))
        (fids, _), out["filtered_search_s"] = timed(lambda: eng.search(Qn, k=FINAL_K))
        dead.append(soft.cpu())
        out["returned_removed"] += n_dead(fids)
        out["hardened"], out["harden_ms"] = timed(mut.harden_soft_deletes)
        _, out["compact_ms"] = timed(mut.compact)
        out["harden_ms"] *= 1e3
        out["compact_ms"] *= 1e3
        out["soft_remove_ms"] *= 1e3
        (eids, _), out["search_after_compact_s"] = timed(lambda: eng.search(Qn, k=FINAL_K))
        out["returned_removed"] += n_dead(eids)
        # the rebuilt reference: the live rows from scratch on the frozen stages
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
        ref_idx, out["rebuild_s"] = timed(lambda: mut.rebuild_reference(
            torch.Generator().manual_seed(args.seed)))
        rids, _ = search_jit_batched(pack_ivf(ref_idx), ds.Q, **search_kw)
        id_map = torch.full((mut.n_total,), -1, dtype=torch.int64, device=DEVICE)
        id_map[live] = torch.arange(live.numel(), device=DEVICE)
        e = torch.from_numpy(eids).to(DEVICE).long()
        mapped = torch.where(e >= 0, id_map[e.clamp(min=0)], -1)
        out["rebuilt_ids_agree"] = float((mapped == rids.long()).float().mean())
        del ref_idx, rids
        # the host engine over the CSR snapshot, against exact search of the live rows
        csr = mut.to_ivf_index()
        Qh = ds.Q[:HOST_NQ]
        _, gidx = topk_inner_product(Qh, mut.rerank[live], FINAL_K, chunk=65_536)
        hgt = live[gidx.long()].to(torch.int32)
        host = lambda: search_numpy(csr, Qh, top_t=TOP_T, final_k=FINAL_K,  # noqa: E731
                                    rerank_budget=BUDGET)
        _, out["host_first_s"] = timed(host)
        (hids, hstats), out["host_s"] = timed(host)
        out["host_qps"] = HOST_NQ / out["host_s"]
        out["host_recall_at_10"] = recall_at_k(hids, hgt, FINAL_K)
        out["engine_recall_at_10_same_queries"] = recall_at_k(
            torch.from_numpy(eids[:HOST_NQ]).to(DEVICE), hgt, FINAL_K)
        out["host_ids_agree_engine"] = float((hids.cpu() == torch.from_numpy(
            eids[:HOST_NQ])).float().mean())
        out["host_mean_points_read"] = float(hstats.points_read.float().mean())
        out["n_alive"], out["n_total"] = mut.n_alive, mut.n_total
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out, eng

    (ssum, eng), slaunch = drive(wrappers, ("vq_assign", "soar_assign", "tree_route",
                                     "pq_score_probes_select"), serving)
    path_launches.update(slaunch)
    ssum["launches"] = slaunch
    print("serving: " + json.dumps(ssum))
    assert ssum["returned_removed"] == 0, "a removed id was returned"
    assert ssum["readded_in_own_top10"] >= 0.9, \
        f"re-added vectors in their own top 10 on {ssum['readded_in_own_top10']} < 0.9"
    assert ssum["delta_pack_equal_rounds"] == ROUNDS, "a delta pack differs from the full repack"
    assert ssum["rounds_through_delta"] >= ROUNDS - 1 and ssum["prune_through_delta"], \
        "a round's pack did not go through the delta path"
    assert ssum["prune_shape_ok"], f"the served router is not pruned as expected: {ssum['prune']}"
    assert ssum["prune"]["queries_reaching_emptied_super"] > 0, "no query reaches the emptied super"
    assert ssum["pruned_ids_agree_live_route"] >= 0.999, \
        f"pruned engine ids agree with the live-only tree search on " \
        f"{ssum['pruned_ids_agree_live_route']} < 0.999"
    assert ssum["prune_delta_equal"], "the pruned delta pack differs from the full repack"
    assert ssum["unpruned_after_readd"], "re-adding the emptied partitions left the router pruned"
    assert ssum["ids_agree_tree_search"] >= 0.999, \
        f"engine ids agree with the tree search on {ssum['ids_agree_tree_search']} < 0.999"
    assert ssum["rebuilt_ids_agree"] >= 0.999, \
        f"rebuilt ids agree with the engine's on {ssum['rebuilt_ids_agree']} < 0.999"
    assert ssum["host_recall_at_10"] >= 0.85, \
        f"host engine recall@10 {ssum['host_recall_at_10']} < 0.85"

    # 12. the paper metrics: KMR curves of three spill modes on one codebook,
    # rank statistics, the residual correlations
    def paper_metrics():
        """KMR curves of the main index and of its codebook's none and naive
        builds, rank statistics against the CPU, pair statistics → numbers."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        t_phase = time.perf_counter()
        tid, out["true_neighbors_s"] = timed(
            lambda: true_neighbors(ds.X, ds.Q, k=KMR_K, chunk=65_536))
        builds = {"soar": idx}
        for mode in ("none", "naive"):
            builds[mode], out[f"build_{mode}_s"] = timed(lambda: build_ivf_sharded(
                torch.Generator().manual_seed(args.seed), ds.X, C, spill_mode=mode,
                pq_subspaces=M, rerank="f32", codebook=idx.centroids, pq=idx.pq,
                shard_size=SHARD, device=DEVICE))
        out["primary_equal_main_share"] = {
            mode: float((builds[mode].assignments[:, 0] == idx.assignments[:, 0])
                        .float().mean()) for mode in ("none", "naive")}
        curves, out["curves"] = {}, {}
        for mode, ix in builds.items():
            cv, secs = timed(lambda: kmr_curve(ix, ds.Q, tid, k=KMR_K))
            r, pts = cv.recall_at_t, cv.points_at_t
            curves[mode] = cv
            out["curves"][mode] = {
                "kmr_s": secs, "n_assignments": ix.n_assignments,
                "points_to_recall": {str(t): points_to_recall(cv, t) for t in KMR_TARGETS},
                "recall_at_t": {str(t): float(r[t - 1]) for t in (1, 10, TOP_T, 2 * TOP_T)},
                "non_decreasing": bool(np.all(np.diff(r) >= 0)),
                "last_recall": float(r[-1]), "last_points": float(pts[-1])}
        out["spill_dominates_none"] = {
            mode: bool(np.all(curves[mode].recall_at_t >= curves["none"].recall_at_t))
            for mode in ("naive", "soar")}
        # rank statistics of the first queries on the card and on CPU copies
        nr = RANK_NQ
        gp, gs = rank_statistics(idx, ds.Q[:nr], tid[:nr])
        host = SimpleNamespace(centroids=idx.centroids.cpu(),
                               assignments=idx.assignments.cpu())
        wp, ws = rank_statistics(host, ds.Q[:nr].cpu(), tid[:nr].cpu())
        out["rank_stats_agree_cpu"] = [float((gp.cpu() == wp).float().mean()),
                                       float((gs.cpu() == ws).float().mean())]
        out["mean_primary_rank"] = float(gp.float().mean())
        out["mean_spill_rank"] = float(gs.float().mean())
        out["correlations"] = {}
        for mode in ("naive", "soar"):
            st, secs = timed(lambda: pair_stats(ds.X, builds[mode].centroids,
                                                builds[mode].assignments, ds.Q, tid))
            out["correlations"][mode] = {
                "score_error": score_error_correlation(st),
                "angle": angle_correlation(st), "pair_stats_s": secs}
            del st
        del builds["none"], builds["naive"], tid
        out["phase_s"] = time.perf_counter() - t_phase
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out, curves

    (ksum, curves), klaunch = drive(wrappers, ("vq_assign", "soar_assign"), paper_metrics)
    path_launches.update(klaunch)
    ksum["launches"] = klaunch
    torch.cuda.empty_cache()
    print("paper metrics: " + json.dumps(ksum))
    for mode, cv in ksum["curves"].items():
        assert cv["non_decreasing"], f"{mode}: the KMR curve decreases"
        assert abs(cv["last_recall"] - 1.0) <= 1e-6, f"{mode}: the curve ends at {cv['last_recall']}"
        assert abs(cv["last_points"] - cv["n_assignments"]) <= 1e-5 * cv["n_assignments"], \
            f"{mode}: the curve ends at {cv['last_points']} points, not {cv['n_assignments']}"
    assert all(ksum["spill_dominates_none"].values()), \
        f"a spilled curve falls below none's: {ksum['spill_dominates_none']}"
    assert min(ksum["rank_stats_agree_cpu"]) >= 0.999, \
        f"rank statistics agree with the CPU's on {ksum['rank_stats_agree_cpu']} < 0.999"

    # 13. durability: the serving engine saved, reopened, logged, replayed
    def durability(tmp):
        """Save phase 11's engine, open it, log a mutation script, replay
        it into a second engine, corrupt the snapshot → numbers."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        mut, Qn = eng.index, ds.Q.cpu().numpy()
        out["capacity"] = {"slots": int(mut.part_ids.shape[1]),
                           "rerank_rows": int(mut.rerank.shape[0])}
        path = os.path.join(tmp, "engine")
        _, out["save_s"] = timed(lambda: eng.save(path))
        arrays_bin = os.path.join(path, "index", "arrays.bin")
        out["snapshot_bytes"] = sum(os.path.getsize(os.path.join(path, "index", f))
                                    for f in ("arrays.bin", "manifest.json"))
        out["save_gb_s"] = out["snapshot_bytes"] / out["save_s"] / 1e9
        opened, out["open_s"] = timed(lambda: AnnEngine.open(path, device=DEVICE))
        out["open_gb_s"] = out["snapshot_bytes"] / out["open_s"] / 1e9
        out["opened_equal"] = same_state(opened.index, mut)
        ids0, _ = eng.search(Qn, k=FINAL_K)
        (oids, _), out["opened_search_s"] = timed(lambda: opened.search(Qn, k=FINAL_K))
        out["opened_ids_agree"] = float((oids == ids0).mean())
        del opened
        # the log: three rounds of hard removals and re-adds, then soft
        # removals and harden, each record appended before it applies
        mut.attach_wal(MutationWAL(os.path.join(path, "wal.log"), fsync="always",
                                   start_seq=mut.wal_seq))
        g = torch.Generator().manual_seed(args.seed + 2)
        steps = []
        for _ in range(WAL_ROUNDS):
            live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
            victims = live[torch.randperm(live.numel(), generator=g)[:CHURN].to(DEVICE)]
            vecs = mut.rerank[victims].clone()
            t = {}
            _, t["remove"] = timed(lambda: eng.remove(victims))
            _, t["add"] = timed(lambda: eng.add(vecs))
            steps.append({f"{k}_ms": v * 1e3 for k, v in t.items()})
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1)
        soft = live[torch.randperm(live.numel(), generator=g)[:CHURN].to(DEVICE)]
        _, out["soft_remove_ms"] = timed(lambda: eng.remove(soft, hard=False))
        _, out["harden_ms"] = timed(mut.harden_soft_deletes)
        out["soft_remove_ms"] *= 1e3
        out["harden_ms"] *= 1e3
        out["logged_rounds_ms"] = steps
        out["wal_seq"] = mut.wal_seq
        out["wal_bytes"] = os.path.getsize(os.path.join(path, "wal.log"))
        # replay: the snapshot plus the log, into a second engine
        n0 = (vq_assign.launches, soar_assign.launches)
        replayed, out["replay_open_s"] = timed(lambda: AnnEngine.open(path, device=DEVICE))
        out["replay_launches"] = {"vq_assign": vq_assign.launches - n0[0],
                                  "soar_assign": soar_assign.launches - n0[1]}
        out["replayed_equal"] = same_state(replayed.index, mut)
        ids1, _ = eng.search(Qn, k=FINAL_K)
        rids, _ = replayed.search(Qn, k=FINAL_K)
        out["replayed_ids_agree"] = float((rids == ids1).mean())
        replayed.index._wal.close()
        mut._wal.close()
        mut._wal = None
        del replayed
        # one flipped byte of arrays.bin: the next open must refuse it
        faults.flip_byte(arrays_bin, os.path.getsize(arrays_bin) // 2)
        try:
            AnnEngine.open(path, device=DEVICE)
            out["corrupt_open_raised"] = False
        except CorruptSnapshotError:
            out["corrupt_open_raised"] = True
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    def same_state(a, b) -> bool:
        """Two MutableIVFs equal bit for bit: state tensors, counters,
        wal_seq and the router's trained tables."""
        tensors = all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
            "centroids", "part_ids", "part_codes", "sizes", "rerank", "assignments",
            "alive")) and torch.equal(a.pq.centers, b.pq.centers)
        router = all(torch.equal(getattr(a.router, k), getattr(b.router, k)) for k in (
            "super_centroids", "children", "child_centroids"))
        counts = all(getattr(a, k) == getattr(b, k) for k in (
            "n_total", "n_dead_slots", "n_soft_deleted", "wal_seq"))
        return tensors and router and counts

    with tempfile.TemporaryDirectory() as tmp:
        dsum, dlaunch = drive(wrappers, ("vq_assign", "soar_assign", "tree_route",
                                         "pq_score_probes_select"), lambda: durability(tmp))
    path_launches.update(dlaunch)
    dsum["launches"] = dlaunch
    print("durability: " + json.dumps(dsum))
    assert dsum["opened_equal"], "the opened engine differs from the saved one"
    assert dsum["opened_ids_agree"] == 1.0, \
        f"the opened engine's ids agree on {dsum['opened_ids_agree']} < 1.0"
    assert dsum["wal_seq"] == 2 * WAL_ROUNDS + 2, f"wal_seq {dsum['wal_seq']}"
    assert dsum["replayed_equal"], "the replayed engine differs from the live one"
    assert dsum["replayed_ids_agree"] == 1.0, \
        f"the replayed engine's ids agree on {dsum['replayed_ids_agree']} < 1.0"
    assert min(dsum["replay_launches"].values()) > 0, \
        f"the replayed adds did not launch the assignment kernels: {dsum['replay_launches']}"
    assert dsum["corrupt_open_raised"], "a flipped byte of arrays.bin opened without an error"

    # 14. the serving front-end in front of phase 11's engine (after phase 13)
    def frontend_phase(tmp):
        """Coalescing with tenants against direct calls, mutation barriers,
        admission / deadlines / faults, replica fan-out, save and reopen →
        numbers (checks below)."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        t_phase = time.perf_counter()
        mut, Qn = eng.index, ds.Q.cpu().numpy()
        p10 = SearchParams(k=FINAL_K)
        # the padding repair: a query's bits alone and inside every bucket
        solo = [eng.search_request(Qn[i:i + 1], p10) for i in range(64)]
        out["buckets_equal_solo"] = {}
        for nq in (2, 9, 17, 33, 65, 128, 200):
            r = eng.search_request(Qn[:nq], p10)
            out["buckets_equal_solo"][nq] = all(
                np.array_equal(r.ids[i], solo[i].ids[0])
                and np.array_equal(r.scores[i], solo[i].scores[0]) for i in range(min(nq, 64)))
        # what the repair costs a one-query request: 1 row (the parent's
        # engine), bucket 8 (JAX's padding alone), bucket 8 at 128 rows (now)
        packed, q1 = mut.pack(), Qn[:1]
        kw1 = dict(top_t=TOP_T, final_k=FINAL_K, rerank_budget=BUDGET,
                   multiplicity=mut.dedup_multiplicity)
        q8 = pad_queries(q1, BQ)[0]
        out["one_query_ms"] = {name: host_us(fn) / 1e3 for name, fn in (
            ("one_row", lambda: search_jit_batched(packed, q1, bq=BQ, **kw1)[0].cpu()),
            ("bucket8", lambda: search_jit_batched(packed, q8, bq=8, **kw1)[0].cpu()),
            ("bucket8_at_bq_rows", lambda: search_jit_batched(
                packed, q8, bq=8, tile_rows=BQ, **kw1)[0].cpu()),
            ("engine", lambda: eng.search_request(q1, p10)))}
        # (a) 32 closed-loop clients, half of them under 4 tenants
        g = np.random.default_rng(args.seed + 3)
        live = torch.nonzero(mut.alive[:mut.n_total]).reshape(-1).cpu().numpy()
        masks = {}
        for t in range(TENANTS):
            m = np.zeros(mut.n_total, bool)
            m[g.choice(live, live.size // 10, replace=False)] = True
            masks[f"t{t}"] = m
        plan = [(c, g.integers(0, NQ, FE_REQS), f"t{c % TENANTS}" if c < FE_CLIENTS // 2 else None)
                for c in range(FE_CLIENTS)]

        def run_clients(call):
            """Each client sends its FE_REQS single-query requests back to
            back → (wall s, latencies ms, results by (client, i))."""
            lat, res = [], {}
            lock = threading.Lock()

            def client(c, qs, tenant):
                for i, qi in enumerate(qs):
                    t0 = time.perf_counter()
                    r = call(Qn[qi:qi + 1], tenant)
                    dt = (time.perf_counter() - t0) * 1e3
                    with lock:
                        lat.append(dt)
                        res[(c, i)] = r
            threads = [threading.Thread(target=client, args=a) for a in plan]
            t0 = time.perf_counter()
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
                assert not t.is_alive(), "a client hung"
            return time.perf_counter() - t0, np.array(lat), res

        def summary(wall, lat):
            return {"qps": FE_CLIENTS * FE_REQS / wall, "p50_ms": float(np.percentile(lat, 50)),
                    "p99_ms": float(np.percentile(lat, 99)), "wall_s": wall}

        dlock = threading.Lock()

        def direct(q, tenant):
            with dlock:
                return eng.search_request(q, SearchParams(
                    k=FINAL_K, filter_mask=None if tenant is None else masks[tenant]))

        for t in [None, *masks]:                         # warm the direct path
            direct(Qn[:1], t)
        wall, lat, _ = run_clients(direct)
        out["direct"] = summary(wall, lat)
        fe = ServingFrontend(eng, policy="local", max_batch=BQ, max_delay_ms=2,
                             default_deadline_ms=50)
        for t, m in masks.items():
            fe.register_tenant(t, mask=m)
        wall, lat, res = run_clients(
            lambda q, tenant: fe.submit(q, SearchParams(k=FINAL_K, tenant=tenant)).result(timeout=600))
        out["frontend"] = summary(wall, lat)
        st = dict(fe.stats)
        out["frontend"].update(stats=st, mean_dispatch=st["requests"] / st["dispatches"],
                               tenant_fills=fe.tenants.fills)
        bitmaps = {t: fe.tenants.get(t) for t in masks}
        fe.close()
        epoch = mut._alive_epoch
        equal = in_tenant = 0
        for c, qs, tenant in plan:
            for i, qi in enumerate(qs):
                r = res[(c, i)]
                s = eng.search_request(Qn[qi:qi + 1], p10,
                                       _filter_dev=None if tenant is None else bitmaps[tenant])
                equal += (r.epoch == s.epoch == epoch and np.array_equal(r.ids, s.ids)
                          and np.array_equal(r.scores, s.scores))
                if tenant is not None:
                    got = r.ids[r.ids >= 0]
                    in_tenant += bool(masks[tenant][got].all()
                                      and mut.alive[torch.from_numpy(got).to(DEVICE).long()].all())
        out["coalesced_equal_solo_share"] = equal / (FE_CLIENTS * FE_REQS)
        out["tenant_results_in_tenant_share"] = in_tenant / (FE_CLIENTS // 2 * FE_REQS)
        # (b) 16 searching clients and a mutator: 10 rounds of remove + add
        vg = torch.Generator().manual_seed(args.seed + 4)
        pool = torch.from_numpy(live).to(DEVICE)[torch.randperm(live.size, generator=vg)[
            :ROUNDS * CHURN].to(DEVICE)]
        victims = pool.reshape(ROUNDS, CHURN).cpu().numpy()
        vecs = mut.rerank[pool].reshape(ROUNDS, CHURN, -1).cpu().numpy()
        e0 = mut._alive_epoch
        fe = ServingFrontend(eng, policy="local", max_batch=BQ, max_delay_ms=2,
                             default_deadline_ms=50)
        for t, m in masks.items():
            fe.register_tenant(t, mask=m)
        done, seen, steps, new_ids = threading.Event(), [], [], []

        def searcher(c):
            qg = np.random.default_rng(c)
            mine = []
            while not done.is_set():
                qi = int(qg.integers(0, NQ))
                r = fe.submit(Qn[qi:qi + 1], p10).result(timeout=600)
                mine.append((r.epoch, r.ids))
            seen.append(mine)

        threads = [threading.Thread(target=searcher, args=(c,)) for c in range(FE_CLIENTS // 2)]
        for t in threads:
            t.start()
        for rnd in range(ROUNDS):
            t0 = time.perf_counter()
            fe.remove(victims[rnd])
            t1 = time.perf_counter()
            new_ids.append(fe.add(vecs[rnd], tenant=f"t{rnd % TENANTS}"))
            steps.append({"remove_ms": (t1 - t0) * 1e3,
                          "add_ms": (time.perf_counter() - t1) * 1e3})
        done.set()
        for t in threads:
            t.join(timeout=600)
            assert not t.is_alive(), "a searcher hung"
        # the last round's vectors, under their tenant: their new ids
        last_t = f"t{(ROUNDS - 1) % TENANTS}"
        own = fe.submit(vecs[-1], SearchParams(k=FINAL_K, tenant=last_t)).result(timeout=600)
        out["barrier_stats"] = dict(fe.stats)
        fe.close()
        # an id removed in round r is gone from epoch e0 + 2r + 1 on
        gone_at = {int(v): e0 + 2 * r + 1 for r in range(ROUNDS) for v in victims[r]}
        stale = monotone = 0
        for mine in seen:
            eps = [e for e, _ in mine]
            monotone += all(a <= b for a, b in zip(eps, eps[1:]))
            stale += sum(sum(gone_at.get(int(x), e + 1) <= e for x in ids[ids >= 0])
                         for e, ids in mine)
        out["barriers"] = {
            "searches": sum(len(m) for m in seen), "rounds_ms": steps,
            "epochs": [e0, mut._alive_epoch], "stale_ids_returned": stale,
            "clients_monotone": monotone,
            "readded_in_own_tenant_top10": float((own.ids == new_ids[-1][:, None]).any(1).mean())}
        # (c) admission, deadlines and faults
        fe = ServingFrontend(eng, policy="local", max_batch=BQ, max_delay_ms=2,
                             default_deadline_ms=50, max_queue=256, overload="shed-oldest",
                             retry_backoff_ms=0.5)
        res_c = {}
        faults.inject("engine:search@1x1", mode="delay", delay_ms=300.0)
        first = fe.submit(Qn[:1], p10)
        t0 = time.perf_counter()
        while fe._q and time.perf_counter() - t0 < 5.0:
            time.sleep(0.001)
        burst = [fe.submit(Qn[i % NQ:i % NQ + 1], p10) for i in range(BURST)]
        late = fe.submit(Qn[:1], SearchParams(k=FINAL_K, deadline_ms=1.0))
        outcomes = Counter()
        for f in [first] + burst:
            try:
                f.result(timeout=120)
                outcomes["served"] += 1
            except OverloadedError:
                outcomes["shed"] += 1
        try:
            late.result(timeout=120)
            res_c["deadline_raised"] = False
        except DeadlineExceededError:
            res_c["deadline_raised"] = True
        faults.uninstall()
        res_c["burst"] = dict(outcomes)
        res_c["burst_stats"] = dict(fe.stats)
        want = eng.search_request(Qn[:2], p10)
        faults.install("engine:search@1x2", mode="transient")
        r = fe.submit(Qn[:2], p10).result(timeout=120)
        res_c["transient_retries"] = r.retries
        res_c["transient_equal"] = bool(np.array_equal(r.ids, want.ids)
                                        and np.array_equal(r.scores, want.scores))
        faults.install("engine:search@1x1", mode="error")
        try:
            fe.submit(Qn[:1], p10).result(timeout=120)
            res_c["error_raised"] = False
        except faults.InjectedFault:
            res_c["error_raised"] = True
        res_c["served_after_error"] = fe.submit(Qn[:1], p10).result(timeout=120).ids.shape
        faults.install("engine:search@1x1", mode="delay", delay_ms=300.0)
        faults.inject("engine:search@2", mode="raise")
        stall = fe.submit(Qn[:1], p10)
        t0 = time.perf_counter()
        while fe._q and time.perf_counter() - t0 < 5.0:
            time.sleep(0.001)
        s1 = fe.submit(Qn[:1], SearchParams(k=4))
        s2 = fe.submit(Qn[:1], SearchParams(k=5))
        stall.result(timeout=120)
        crash = []
        for f, expect in ((s1, faults.InjectedCrash), (s2, FrontendClosedError)):
            try:
                f.result(timeout=120)
                crash.append(False)
            except expect:
                crash.append(True)
        try:
            fe.submit(Qn[:1], p10)
            crash.append(False)
        except FrontendClosedError:
            crash.append(True)
        faults.uninstall()
        fe.close()
        res_c["crash_fails_every_future_and_submit"] = crash
        res_c["dispatcher_alive_after_crash"] = fe._thread.is_alive()
        out["resilience"] = res_c
        # (d) replicas over [cuda:0, cuda:0], then save and reopen
        Qp, nq, bq = pad_queries(Qn, BQ, multiple=2)
        rep = make_replicated_search([DEVICE, DEVICE], top_t=TOP_T, final_k=FINAL_K,
                                     rerank_budget=BUDGET, multiplicity=kw1["multiplicity"],
                                     bq=bq, tile_rows=BQ)
        (rids, rsc), out["replica_s"] = timed(lambda: rep(mut.pack(), Qp))
        local = eng.search_request(Qn, p10)
        out["replica_equal_local"] = bool(np.array_equal(rids[:nq].cpu().numpy(), local.ids)
                                          and np.array_equal(rsc[:nq].cpu().numpy(), local.scores))
        fe = ServingFrontend(eng, policy="local", max_batch=BQ, max_delay_ms=2,
                             default_deadline_ms=50)
        for t, m in masks.items():
            fe.register_tenant(t, mask=m)
        before = {t: fe.submit(Qn[:HOST_NQ], SearchParams(k=FINAL_K, tenant=t)).result(timeout=600)
                  for t in (None, "t0")}
        path = os.path.join(tmp, "frontend")
        _, out["save_s"] = timed(lambda: fe.save(path))
        fe.close()
        fe2, out["open_s"] = timed(lambda: ServingFrontend.open(path, device=DEVICE))
        after = {t: fe2.submit(Qn[:HOST_NQ], SearchParams(k=FINAL_K, tenant=t)).result(timeout=600)
                 for t in (None, "t0")}
        out["reopened"] = {
            "tenants": fe2.tenants.tenants, "device": str(fe2.engine.index.device),
            "masks_equal": all(np.array_equal(fe2.tenants._masks[t][:m.size], m)
                               for t, m in masks.items()),
            "equal": all(np.array_equal(before[t].ids, after[t].ids)
                         and np.array_equal(before[t].scores, after[t].scores) for t in before)}
        fe2.close()
        del fe2
        out["phase_s"] = time.perf_counter() - t_phase
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        fsum, flaunch = drive(wrappers, ("tree_route", "pq_score_probes_select", "vq_assign",
                                         "soar_assign"), lambda: frontend_phase(tmp))
    path_launches.update(flaunch)
    fsum["launches"] = flaunch
    print("frontend: " + json.dumps(fsum))
    assert all(fsum["buckets_equal_solo"].values()), \
        f"a batched query's bits differ from its solo bits: {fsum['buckets_equal_solo']}"
    assert fsum["coalesced_equal_solo_share"] == 1.0, \
        f"coalesced results equal solo on {fsum['coalesced_equal_solo_share']} < 1.0"
    assert fsum["tenant_results_in_tenant_share"] == 1.0, "a tenant result left tenant ∧ alive"
    assert fsum["frontend"]["stats"]["coalesced"] > 0, "no request was coalesced"
    assert fsum["frontend"]["tenant_fills"] == TENANTS, \
        f"tenant bitmap fills {fsum['frontend']['tenant_fills']} != {TENANTS}"
    bar = fsum["barriers"]
    assert bar["stale_ids_returned"] == 0, "a removed id came back at or after its epoch"
    assert bar["clients_monotone"] == FE_CLIENTS // 2, "a client's epochs decreased"
    assert bar["readded_in_own_tenant_top10"] >= 0.9, \
        f"re-added vectors under their tenant in their own top 10 on {bar['readded_in_own_tenant_top10']}"
    rc = fsum["resilience"]
    assert rc["burst"].get("shed", 0) > 0 and rc["burst_stats"]["shed"] > 0, \
        f"nothing was shed under the burst: {rc['burst']}"
    assert sum(rc["burst"].values()) == BURST + 1, "a burst Future did not complete"
    assert rc["deadline_raised"], "a 1 ms deadline queued behind the delay did not expire"
    assert rc["transient_retries"] == 2 and rc["transient_equal"], "transient faults not absorbed"
    assert rc["error_raised"] and rc["served_after_error"] == (1, FINAL_K), \
        "an error fault was not contained to its group"
    assert all(rc["crash_fails_every_future_and_submit"]) and \
        not rc["dispatcher_alive_after_crash"], "a fatal fault stranded a Future"
    assert fsum["replica_equal_local"], "replicated results differ from the local path"
    assert fsum["reopened"]["equal"] and fsum["reopened"]["masks_equal"] and \
        fsum["reopened"]["tenants"] == [f"t{t}" for t in range(TENANTS)], \
        "the reopened front-end serves other tenants or results"
    del eng

    # 15. the kNN attention memory of one (layer, KV head) of granite-3-2b
    def knn_phase(tmp):
        """Build, decode on both engines against exact attention within the
        segment, SOAR against no spill at top_t 2, save and reopen →
        numbers (checks below)."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        t_phase = time.perf_counter()
        n_new = MEM_STEPS * MEM_SEQS
        kd = make_manifold(args.seed + 5, MEM_N + n_new, HEAD_DIM,
                           nq=MEM_STEPS * MEM_SEQS * GQA, intrinsic_dim=10, device=DEVICE)
        V = torch.randn((MEM_N + n_new, HEAD_DIM),
                        generator=torch.Generator().manual_seed(args.seed + 6)).to(DEVICE)
        seg0 = np.repeat(np.arange(MEM_SEQS), MEM_N // MEM_SEQS)
        mem, out["build_s"] = timed(lambda: KNNMemory.build(
            kd.X[:MEM_N], V[:MEM_N], lam=1.0, spill_mode="soar", seed=args.seed,
            engine="jit", segment=seg0, device=DEVICE))
        out["partitions"] = int(mem.index.centroids.shape[0])
        fresh = os.path.join(tmp, "fresh")
        _, out["save_fresh_s"] = timed(lambda: mem.save(fresh))
        qs = kd.Q.reshape(MEM_STEPS, MEM_SEQS, GQA, HEAD_DIM)

        def quality(m, top_t, steps):
            """Key-recall@K_MEM and attention-output error within each
            sequence's segment for the first `steps` steps' queries, before
            any append → (recall, error)."""
            segs, hits, errs = m.segments[:m.index.n_total], 0.0, 0.0
            for j in range(MEM_SEQS):
                ids_j = torch.nonzero(segs == j).reshape(-1)
                q = qs[:steps, j].reshape(-1, HEAD_DIM)
                eo, ei = exact_topk_attention(q, m.keys[ids_j], m.values[ids_j], K_MEM)
                o, got = m.attend(q.cpu().numpy(), k=K_MEM, top_t=top_t, segment=j)
                hits += (got[:, :, None] == ids_j.cpu().numpy()[ei][:, None, :]).any(-1).mean()
                errs += float(np.mean(np.linalg.norm(o - eo, axis=1)
                                      / np.maximum(np.linalg.norm(eo, axis=1), 1e-9)))
            return hits / MEM_SEQS, errs / MEM_SEQS

        out["probe_sweep"] = {t: dict(zip(("key_recall", "attn_rel_err"), quality(mem, t, 8)))
                              for t in (8, 16, 32, 64)}

        def decode(m):
            """MEM_STEPS steps: append one position per sequence, retrieve
            and attend for each sequence's query heads within its segment,
            one recency request → numbers."""
            t = {"add": 0.0, "retrieve": 0.0, "attend": 0.0}
            hits = errs = 0.0
            bad_segment = bad_recency = 0
            for s in range(MEM_STEPS):
                lo = MEM_N + s * MEM_SEQS
                _, dt = timed(lambda: m.add(kd.X[lo:lo + MEM_SEQS], V[lo:lo + MEM_SEQS],
                                            segment=np.arange(MEM_SEQS)))
                t["add"] += dt
                nt = m.index.n_total
                keys, segs = m.keys, m.segments[:nt]
                sync()
                t0 = time.perf_counter()
                got = [m.retrieve(qs[s, j].cpu().numpy(), k=K_MEM, top_t=MEM_TOP_T, segment=j)[0]
                       for j in range(MEM_SEQS)]
                rec = m.retrieve(qs[s, 0].cpu().numpy(), k=K_MEM, top_t=MEM_TOP_T,
                                 recency=RECENCY)[0]
                sync()
                t["retrieve"] += time.perf_counter() - t0
                t0 = time.perf_counter()
                att = [m.attend(qs[s, j].cpu().numpy(), k=K_MEM, top_t=MEM_TOP_T, segment=j)
                       for j in range(MEM_SEQS)]
                sync()
                t["attend"] += time.perf_counter() - t0
                r = rec[rec >= 0]
                bad_recency += int((r < nt - RECENCY).sum())
                for j in range(MEM_SEQS):
                    ids_j = torch.nonzero(segs == j).reshape(-1)
                    eo, ei = exact_topk_attention(qs[s, j], keys[ids_j], m.values[ids_j], K_MEM)
                    exact_ids = ids_j.cpu().numpy()[ei]
                    g = got[j]
                    bad_segment += int((segs[torch.from_numpy(g[g >= 0]).to(DEVICE).long()]
                                        != j).sum())
                    hits += (g[:, :, None] == exact_ids[:, None, :]).any(-1).mean()
                    out_j, _ = att[j]
                    errs += float(np.mean(np.linalg.norm(out_j - eo, axis=1)
                                          / np.maximum(np.linalg.norm(eo, axis=1), 1e-9)))
            n = MEM_STEPS * MEM_SEQS
            return {"key_recall_at_32": hits / n, "attn_rel_err": errs / n,
                    "ids_outside_segment": bad_segment, "ids_outside_recency": bad_recency,
                    **{f"{k}_ms_per_step": v / MEM_STEPS * 1e3 for k, v in t.items()}}

        out["jit"] = decode(mem)
        twin = KNNMemory.open(fresh, device=DEVICE)
        twin.engine = "numpy"
        out["numpy"] = decode(twin)
        del twin
        # SOAR against no spill at a tight probe budget, over the built keys
        soar = KNNMemory.open(fresh, device=DEVICE)
        none, out["build_none_s"] = timed(lambda: KNNMemory.build(
            kd.X[:MEM_N], V[:MEM_N], spill_mode="none", seed=args.seed, engine="jit",
            device=DEVICE))
        qt = kd.Q[:SPILL_NQ]
        _, exact_ids = exact_topk_attention(qt, kd.X[:MEM_N], V[:MEM_N], K_MEM)
        out["top_t2_key_recall"] = {}
        for name, m in (("soar", soar), ("none", none)):
            ids, _, _ = m.retrieve(qt.cpu().numpy(), k=K_MEM, top_t=2)
            out["top_t2_key_recall"][name] = float(
                (ids[:, :, None] == exact_ids[:, None, :]).any(-1).mean())
        del soar, none
        # the decoded memory saved, reopened: the same bits and retrievals
        path = os.path.join(tmp, "decoded")
        _, out["save_s"] = timed(lambda: mem.save(path))
        back, out["open_s"] = timed(lambda: KNNMemory.open(path, device=DEVICE))
        a, b = mem.index, back.index
        out["reopened_equal"] = bool(
            all(torch.equal(getattr(a, k), getattr(b, k)) for k in (
                "centroids", "part_ids", "sizes", "rerank", "assignments", "alive"))
            and all(getattr(a, k) == getattr(b, k) for k in ("n_total", "n_dead_slots",
                                                              "n_soft_deleted"))
            and torch.equal(mem.values, back.values) and torch.equal(mem.segments, back.segments)
            and (mem.engine, mem.top_t) == (back.engine, back.top_t))
        qn = kd.Q[:SPILL_NQ].cpu().numpy()
        out["reopened_retrieval_equal"] = all(
            np.array_equal(mem.retrieve(qn, k=K_MEM, top_t=MEM_TOP_T, **kw)[0],
                           back.retrieve(qn, k=K_MEM, top_t=MEM_TOP_T, **kw)[0])
            for kw in (dict(), dict(segment=3), dict(recency=RECENCY)))
        out["snapshot_bytes"] = sum(os.path.getsize(os.path.join(path, f))
                                    for f in ("arrays.bin", "manifest.json"))
        out["n_total"] = mem.index.n_total
        out["phase_s"] = time.perf_counter() - t_phase
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out

    with tempfile.TemporaryDirectory() as tmp:
        msum, mlaunch = drive(wrappers, ("lloyd_sweep", "vq_assign", "soar_assign",
                                         "kmeans_pp"),
                              lambda: knn_phase(tmp))
    path_launches.update(mlaunch)
    msum["launches"] = mlaunch
    torch.cuda.empty_cache()
    print("knn memory: " + json.dumps(msum))
    for eng_name in ("jit", "numpy"):
        d = msum[eng_name]
        assert d["ids_outside_segment"] == 0, f"{eng_name}: an id outside its segment"
        assert d["ids_outside_recency"] == 0, f"{eng_name}: an id outside the recency window"
        assert d["key_recall_at_32"] >= 0.85, \
            f"{eng_name}: key-recall@32 {d['key_recall_at_32']} < 0.85"
        assert d["attn_rel_err"] < 0.15, f"{eng_name}: attention error {d['attn_rel_err']}"
    t2 = msum["top_t2_key_recall"]
    assert t2["soar"] >= t2["none"] - 0.02, f"SOAR below no spill at top_t 2: {t2}"
    assert msum["reopened_equal"] and msum["reopened_retrieval_equal"], \
        "the reopened memory differs from the saved one"

    # 16. the shard-parallel search at the JAX dry run's per-shard size
    def shard_phase(tmp):
        """Build four 1,000,000-vector shards, search them every way against
        exact search and the plain kernels, degrade one, save and reload
        the envelope, serve it from two gloo ranks → (numbers, (one m = 25
        probe-scorer tile's arguments, shard 0's tree-route arguments on
        that tile))."""
        out = {}
        torch.cuda.reset_peak_memory_stats()
        out["resident_before_bytes"] = torch.cuda.memory_allocated()
        t_phase = time.perf_counter()
        n = SH_D * SH_N
        sd = make_manifold(args.seed + 7, n, D, nq=SH_NQ, device=DEVICE)
        ivq, out["build_pq_s"] = timed(lambda: build_sharded_ivf_pq(
            args.seed, sd.X, SH_D, SH_C, SH_M, device=DEVICE))
        idxs, out["build_tree_s"] = timed(lambda: [build_ivf_sharded(
            shard_generator(args.seed, s), sd.X[s * SH_N:(s + 1) * SH_N], SH_C,
            pq_subspaces=SH_M, train_iters=8, router="tree", device=DEVICE)
            for s in range(SH_D)])
        srt = stack_tree_routers([i.router for i in idxs])
        out["tree_build_fields_differing"] = [
            f for f, a, b in zip(ivq._fields, sharded_from_indexes_pq(idxs), ivq)
            if not torch.equal(a, b)]
        out["tree_build_stacks_equal"] = not out["tree_build_fields_differing"]
        iv = sharded_from_indexes(idxs)
        out["f32_stack_equals_pq_fields"] = all(
            torch.equal(getattr(iv, f), getattr(ivq, f)) for f in iv._fields)
        _, c, pmax, m = ivq.part_codes.shape
        out.update(pmax=pmax, code_block_bytes=c * pmax * m,
                   code_blocks_on_16_bytes=all(ivq.part_codes[s].data_ptr() % 16 == 0
                                               for s in range(SH_D)),
                   n_super=srt.super_centroids.shape[1], cmax=srt.children.shape[2])
        # the build-side fan-out over the card twice against one call
        C0 = ivq.centroids[0]
        got, out["sharded_assign_s"] = timed(lambda: make_sharded_assign(
            [DEVICE + ":0", DEVICE + ":0"])(sd.X, C0))
        out["sharded_assign_equal"] = torch.equal(got, soar_mod.assign_fused(sd.X, C0))
        del got
        gt = true_neighbors(sd.X, sd.Q, k=FINAL_K, chunk=65_536)
        mask = torch.rand(n, generator=torch.Generator().manual_seed(args.seed)) < SH_FILTER
        keep = torch.nonzero(mask).reshape(-1).to(DEVICE)
        _, fidx = topk_inner_product(sd.Q, sd.X[keep], FINAL_K, chunk=65_536)
        fgt = keep[fidx.long()].to(torch.int32)
        filt = shard_filters(mask, [SH_N] * SH_D).to(DEVICE)
        maskd = mask.to(DEVICE)
        pq_kw = dict(top_t=TOP_T, final_k=FINAL_K, rerank_k=BUDGET, q_chunk=SH_QCHUNK)
        makers = {
            "f32": (make_distributed_search(top_t=TOP_T, final_k=FINAL_K), iv, ()),
            "pq": (make_distributed_search_pq(**pq_kw), ivq, ()),
            "tree_f32": (make_distributed_search(top_t=TOP_T, final_k=FINAL_K,
                                                 with_router=True), iv, (srt,)),
            "tree_pq": (make_distributed_search_pq(with_router=True, **pq_kw), ivq, (srt,)),
            "filtered_f32": (make_distributed_search(top_t=TOP_T, final_k=FINAL_K,
                                                     with_filter=True), iv, (filt,)),
            "filtered_pq": (make_distributed_search_pq(with_filter=True, **pq_kw), ivq,
                            (filt,)),
        }
        merges = []
        real_merge = dist_mod._merge

        def timed_merge(*a):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            r = real_merge(*a)
            ev[1].record()
            merges.append(ev)
            return r

        results = {}
        for name, (fn, ivf, extra) in makers.items():
            (ids, sc), cold = timed(lambda: fn(ivf, sd.Q, *extra))
            runs = []
            for _ in range(5):
                merges.clear()
                with plain_version(dist_mod, "_merge", timed_merge):
                    _, dt = timed(lambda: fn(ivf, sd.Q, *extra))
                runs.append((dt, merges[0][0].elapsed_time(merges[0][1])))
            dt, merge_ms = sorted(runs)[2]
            results[name] = (ids, sc)
            out[name] = {"cold_s": cold, "warm_s_runs": [r[0] for r in runs],
                         "warm_s": dt, "qps": SH_NQ / dt, "merge_ms": merge_ms,
                         "local_search_ms": dt * 1e3 - merge_ms,
                         "recall_at_10": recall_at_k(ids, fgt if "filtered" in name else gt,
                                                     FINAL_K)}
            if "filtered" in name:
                out[name]["ids_outside_filter"] = int((~maskd[ids[ids >= 0].long()]).sum())
        # the same makers on the plain versions of the kernels
        def plain_route():
            return plain_version(router_mod, "tree_route",
                                 lambda Q, SC, CC, CH, t, **_: ref.tree_route_ref(Q, SC, CC, CH, t))

        for name in ("pq", "tree_f32", "tree_pq"):
            fn, ivf, extra = makers[name]
            with ExitStack() as st:
                st.enter_context(plain_version(search, "pq_score_probes_select",
                                               ref.pq_score_probes_select_ref))
                if "tree" in name:
                    st.enter_context(plain_route())
                pids, _ = fn(ivf, sd.Q, *extra)
            out[name]["ids_agree_plain_kernels"] = float(
                (pids == results[name][0]).float().mean())
        # degraded fan-out: all-ones is the plain bits; shard SH_DOWN down
        h = HealthTracker(fail_threshold=1)
        ones = h.mask(SH_D)
        h.failure(SH_DOWN)
        down = h.mask(SH_D)
        lo, hi = SH_DOWN * SH_N, (SH_DOWN + 1) * SH_N
        out["health"] = {}
        for name, fn, ivf in (
                ("f32", make_distributed_search(top_t=TOP_T, final_k=FINAL_K,
                                                with_health=True), iv),
                ("pq", make_distributed_search_pq(with_health=True, **pq_kw), ivq)):
            ids0, sc0 = results[name]
            ids1, sc1 = fn(ivf, sd.Q, ones)
            ids2, _ = fn(ivf, sd.Q, down)
            healthy = (ids0 < lo) | (ids0 >= hi)
            survived = ((ids0[:, :, None] == ids2[:, None, :]).any(-1) | ~healthy).all()
            out["health"][name] = {
                "all_ones_bitwise": torch.equal(ids0, ids1) and torch.equal(sc0, sc1),
                "down_shard_ids": int(((ids2 >= lo) & (ids2 < hi)).sum()),
                "minus_one_ids": int((ids2 < 0).sum()),
                "healthy_answers_survive": bool(survived)}
        # the envelope: save the four shards, load, re-stack, search
        env = os.path.join(tmp, "env")
        _, out["envelope_save_s"] = timed(lambda: save_sharded(env, idxs))
        out["envelope_bytes"] = sum(os.path.getsize(os.path.join(r, f))
                                    for r, _, fs in os.walk(env) for f in fs)
        (loaded, _), out["envelope_load_s"] = timed(lambda: load_sharded(env, device=DEVICE))
        back, out["restack_s"] = timed(lambda: sharded_from_indexes_pq(loaded))
        out["envelope_save_gb_s"] = out["envelope_bytes"] / out["envelope_save_s"] / 1e9
        out["envelope_load_gb_s"] = out["envelope_bytes"] / out["envelope_load_s"] / 1e9
        out["restack_equal"] = all(torch.equal(a, b) for a, b in zip(back, ivq)) and all(
            torch.equal(a, b) for a, b in zip(stack_tree_routers([i.router for i in loaded]),
                                              srt))
        bids, bsc = makers["pq"][0](back, sd.Q)
        out["restack_search_equal"] = (torch.equal(bids, results["pq"][0])
                                       and torch.equal(bsc, results["pq"][1]))
        del loaded, back, idxs
        torch.cuda.empty_cache()
        # two gloo ranks, each serving its two shards from the envelope
        torch.save(sd.Q.cpu(), os.path.join(tmp, "q.pt"))
        env_vars = dict(os.environ, GLOO_SOCKET_IFNAME="lo")
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--rank", str(r), "--world", "2",
             "--workdir", tmp], env=env_vars, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(2)]
        try:
            logs = [p.communicate(timeout=RANK_TIMEOUT) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
        out["ranks_s"] = time.perf_counter() - t0
        for p, (o, e) in zip(procs, logs):
            assert p.returncode == 0, f"a gloo rank failed ({p.returncode}): {e[-3000:]}"
        want = tuple(t.cpu() for t in results["pq"])
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt")) for r in range(2)]
        out["ranks"] = [{k: v for k, v in r.items() if k not in ("ids", "scores")}
                        for r in ranks]
        out["ranks_equal_in_process"] = [torch.equal(r["ids"], want[0])
                                         and torch.equal(r["scores"], want[1])
                                         for r in ranks]
        # one tile of shard 0's probes at m = 25, for the kernel phase
        Qt = sd.Q[:dist_mod.TILE_ROWS]
        psc, parts = FlatRouter(ivq.centroids[0]).route(Qt, TOP_T)
        probe = (pq_lut(PQCodebook(ivq.pq_centers[0]), Qt), ivq.part_codes[0].clone(),
                 ivq.extent[0].clone(), parts, psc)
        # and shard 0's router as the tree searches above route a tile: the
        # stack's (S, cmax) and the t_route the search gives it
        r0 = dist_mod._local_router(ivq.centroids[0], (srt.super_centroids[0],
                                                       srt.children[0],
                                                       srt.child_centroids[0]), None)
        route = (Qt.clone(), r0.super_centroids.clone(), r0.child_centroids.clone(),
                 r0.children.clone(), r0.eff_t_route)
        out["phase_s"] = time.perf_counter() - t_phase
        out["peak_bytes"] = torch.cuda.max_memory_allocated()
        return out, (probe, route), (ivq, iv, Qt.clone())

    with tempfile.TemporaryDirectory() as tmp:
        (ssum, (probe25, route16), shards), slaunch = drive(
            wrappers, ("pq_score_probes_select", "tree_route", "vq_assign", "soar_assign",
                       "lloyd_sweep", "kmeans_pp"), lambda: shard_phase(tmp))
    path_launches.update(slaunch)
    ssum["launches"] = slaunch
    torch.cuda.empty_cache()
    print("shard-parallel: " + json.dumps(ssum))
    assert ssum["tree_build_stacks_equal"], \
        f"the tree-routed build's stack differs in {ssum['tree_build_fields_differing']}"
    assert ssum["f32_stack_equals_pq_fields"], "the f32 stack differs from the PQ stack"
    assert ssum["code_blocks_on_16_bytes"], "a shard's code block is off 16 bytes"
    assert ssum["sharded_assign_equal"], "make_sharded_assign differs from assign_fused"
    for name, bar in (("f32", 0.85), ("pq", 0.85), ("tree_f32", 0.70), ("tree_pq", 0.65),
                      ("filtered_f32", 0.85), ("filtered_pq", 0.85)):
        assert ssum[name]["recall_at_10"] >= bar, \
            f"shard-parallel {name} recall@10 {ssum[name]['recall_at_10']} < {bar}"
    for name in ("filtered_f32", "filtered_pq"):
        assert ssum[name]["ids_outside_filter"] == 0, f"{name}: an id outside the filter"
    for name in ("pq", "tree_f32", "tree_pq"):
        assert ssum[name]["ids_agree_plain_kernels"] >= 0.99, \
            f"{name}: ids agree with the plain kernels on {ssum[name]['ids_agree_plain_kernels']}"
    for name, hs in ssum["health"].items():
        assert hs["all_ones_bitwise"], f"{name}: an all-ones health mask changed the bits"
        assert hs["down_shard_ids"] == 0 and hs["minus_one_ids"] == 0, \
            f"{name}: the degraded search returned a down shard's id or a -1: {hs}"
        assert hs["healthy_answers_survive"], f"{name}: a healthy answer was lost"
    assert ssum["restack_equal"] and ssum["restack_search_equal"], \
        "the re-stacked envelope differs from the saved stack"
    assert all(ssum["ranks_equal_in_process"]), \
        f"the gloo ranks' results differ from the in-process search: {ssum['ranks_equal_in_process']}"

    # 17. the contracts of repro_torch.analysis on the card, at the main
    # path's width
    keep = perm[:int(N * SELECTIVITIES[0])].to(DEVICE)
    bits = torch.zeros(N, dtype=torch.uint8, device=DEVICE)
    bits[keep] = 1
    t0 = time.perf_counter()
    csum = []
    for name, label, spec, needs, sync_free in contract_traces(
            packed, flat, idx, ds.X, ds.Q, bits, shards):
        row, counts = trace_contract(wrappers, name, spec, needs, sync_free)
        path_launches.update(counts)
        csum.append({"label": label, **row, "launches": counts})
        print(f"contract {name} ({label}): {row['ops']} ops, largest "
              f"{row['largest']['op']} {row['largest']['shape']} "
              f"{row['largest']['bytes']} B, warm {row['warm_s']:.4f} s, traced "
              f"{row['traced_s']:.4f} s, findings {row['findings']}")
    del shards, bits, spec
    torch.cuda.empty_cache()
    print("contracts: " + json.dumps({"phase_s": time.perf_counter() - t0,
                                      "traces": csum}))
    assert {r["contract"] for r in csum} == set(contracts_mod.REGISTRY), \
        "a registered contract was not traced on the card"
    for r in csum:
        assert not r["findings"], f"contract {r['contract']} ({r['label']}): {r['findings']}"

    # 18. each kernel against its plain version, on the paths' inputs
    kernels = []

    def record(name, source, replaces, err, ms, plain_ms, nbytes, ops_, mm_ops=0.0,
               **extra):
        b_ms, b_by = bound(nbytes, ops_, mm_ops)
        if mm_ops:
            extra["bound_simt_ms"] = bound(nbytes, ops_ + mm_ops)[0]
        kernels.append({"name": name, "route": "cuda", "source": source,
                        "replaces": replaces, "launches": path_launches[name],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                        "share": b_ms / ms, **extra})
        print(f"kernel {name}: err {err:.3g} ms {ms:.4f} plain {plain_ms:.4f} "
              f"bound {b_ms:.4f} ({b_by}) {extra}")

    # every device time below queues each round behind this longer kernel
    Cb = idx.centroids.contiguous()
    busy = lambda: lloyd_mod.assign_phase(Xt, Cb)   # noqa: E731
    par = parent_build(args.parent.resolve()) if args.parent else None

    # kernel 1: one tile of LUTs against the first DENSE_ROWS code rows
    codes = idx.codes[:DENSE_ROWS]
    got, want = pq_score(luts, codes), ref.pq_score_ref(luts, codes)
    assert torch.allclose(got, want, rtol=1e-5, atol=1e-5), "pq_score"
    assert torch.equal(pq_score(luts, codes), got), "pq_score is not bitwise repeatable"
    nr = codes.shape[0]

    def parent_pq():
        out = torch.empty((BQ, nr), device=DEVICE)
        par.launch("pq_score_launch", luts, codes, BQ, nr, M, out)
        return out

    if par is not None:
        assert torch.allclose(parent_pq(), want, rtol=1e-5, atol=1e-5), "parent pq_score"
    record("pq_score", "src/repro_torch/csrc/pq_score.cu",
           "src/repro/kernels/pq_score.py:66", float((got - want).abs().max()),
           device_ms(lambda: pq_score(luts, codes), busy),
           time_ms(lambda: ref.pq_score_ref(luts, codes), 3),
           codes.numel() + luts.numel() * 4 + got.numel() * 4,
           got.numel() * M, shape=[BQ, nr, M],
           parent_ms=device_ms(parent_pq, busy) if par else None,
           lookup_floor_ms=got.numel() * M / (SMEM_WORDS_CLK * n_sms * sm_mhz * 1e6) * 1e3,
           sms=n_sms, sm_max_mhz=sm_mhz)
    del got, want

    # kernel 2: one bq tile's real probes, read from the packed table
    psc, parts = flat.route(Qb, TOP_T)
    pargs = (luts, packed.part_codes, packed.extent, parts, psc)
    got, want = pq_score_probes(*pargs), ref.pq_score_probes_ref(*pargs)
    fin = torch.isfinite(want)
    assert torch.equal(torch.isinf(got), torch.isinf(want)), "pq_score_probes -inf slots"
    assert torch.allclose(got[fin], want[fin], rtol=1e-5, atol=1e-5), "pq_score_probes"
    code_bytes = int(packed.extent[parts].sum()) * M     # the rows probed

    def probe_bytes(pa, out, code_bytes):
        """Probed code rows, LUTs, int64 probes, coarse scores and one int32
        extent a probe read once; the scores written once."""
        return (code_bytes + pa[0].numel() * 4 + pa[3].numel() * (8 + 4)
                + pa[4].numel() * 4 + out.numel() * 4)

    # the same kernel at the shard-parallel phase's m = 25 (one byte a
    # subspace), one tile of shard 0's probes
    g25, w25 = pq_score_probes(*probe25), ref.pq_score_probes_ref(*probe25)
    f25 = torch.isfinite(w25)
    assert torch.equal(torch.isinf(g25), torch.isinf(w25)), "pq_score_probes m=25 -inf slots"
    assert torch.allclose(g25[f25], w25[f25], rtol=1e-5, atol=1e-5), "pq_score_probes m=25"
    cb25 = int(probe25[2][probe25[3]].sum()) * SH_M
    b25 = bound(probe_bytes(probe25, g25, cb25), cb25)
    ms25 = device_ms(lambda: pq_score_probes(*probe25), busy)
    m25 = {"shape": [probe25[0].shape[0], TOP_T, probe25[1].shape[1], SH_M], "ms": ms25,
           "plain_ms": time_ms(lambda: ref.pq_score_probes_ref(*probe25), 3),
           "ms_reps50": device_ms(lambda: pq_score_probes(*probe25), busy, 50),
           "bound_ms": b25[0], "bound_by": b25[1], "share": b25[0] / ms25,
           "max_abs_err": float((g25[f25] - w25[f25]).abs().max()),
           "probed_code_bytes": cb25}
    del g25, w25
    record("pq_score_probes", "src/repro_torch/csrc/pq_score_probes.cu",
           "src/repro/kernels/pq_score.py:116",
           float((got[fin] - want[fin]).abs().max()),
           time_ms(lambda: pq_score_probes(*pargs)),
           time_ms(lambda: ref.pq_score_probes_ref(*pargs), 3),
           probe_bytes(pargs, got, code_bytes), code_bytes, shape=[BQ, TOP_T, pmax, M],
           probed_code_bytes=code_bytes, m25=m25)
    # its selecting form on the same probes, the search's keep; beside it
    # the window form followed by what the selecting form replaces (the id
    # gather, the mask and torch.topk: the yardstick, never on the path)
    skeep = min(2 * BUDGET, TOP_T * pmax)
    sargs = pargs + (packed.part_ids, skeep)
    si, sv = pq_score_probes_select(*sargs)
    wi, wv = ref.pq_score_probes_select_ref(*sargs)
    sfin = torch.isfinite(wv)
    assert torch.equal(torch.isinf(sv), torch.isinf(wv)), "pq_score_probes_select -inf ranks"
    assert torch.allclose(sv[sfin], wv[sfin], rtol=1e-5, atol=1e-5), "pq_score_probes_select"
    sagree = float((si == wi).float().mean())
    assert sagree >= 0.99, f"pq_score_probes_select ids agree with the plain version on {sagree}"

    def window_chain():
        w = pq_score_probes(*pargs)
        wid = packed.part_ids[parts].reshape(BQ, -1)
        w.masked_fill_(wid < 0, float("-inf"))
        v, pos = torch.topk(w, skeep, dim=-1)
        return torch.gather(wid, -1, pos), v

    record("pq_score_probes_select", "src/repro_torch/csrc/pq_score_probes.cu",
           "none: the search's id gather, mask and top-k over the window",
           float((sv[sfin] - wv[sfin]).abs().max()),
           device_ms(lambda: pq_score_probes_select(*sargs), busy),
           time_ms(lambda: ref.pq_score_probes_select_ref(*sargs), 3),
           code_bytes + luts.numel() * 4 + parts.numel() * (8 + 4) + psc.numel() * 4
           + si.numel() * (4 + 4 + 4), code_bytes, shape=[BQ, TOP_T, pmax, M, skeep],
           ids_agree_plain=sagree, window_chain_ms=device_ms(window_chain, busy),
           probed_code_bytes=code_bytes)
    # the int8 rerank of the same tile's budget (the dedup of the select's
    # slots) over the main rows quantized; beside it the f32 rerank over
    # the rows dequantized (gather, product, mask, stable sort, gather: the
    # yardstick, what the search runs for f32 rows)
    bi, bv = dedup_ranked(si, sv, BUDGET)
    rows8 = int8_quantize(ds.X)
    deq = int8_dequantize(rows8)
    ri8, rv8 = int8_rerank(Qb, rows8, bi, bv, FINAL_K)
    wi8, wv8 = ref.int8_rerank_ref(Qb, rows8.q, rows8.scale, bi, bv, FINAL_K)
    assert torch.allclose(rv8, wv8, rtol=1e-5, atol=1e-6), "int8_rerank"
    ragree = float((ri8 == wi8).float().mean())
    assert ragree >= 0.99, f"int8_rerank ids agree with the plain version on {ragree}"
    valid = int(torch.isfinite(bv).sum())

    def f32_chain():
        ex = torch.einsum("qbd,qd->qb", deq[bi.clamp(min=0).long()], Qb)
        ex = torch.where(torch.isfinite(bv), ex, float("-inf"))
        v, pos = topk_first(ex, FINAL_K)
        return torch.gather(bi, -1, pos), v

    record("int8_rerank", "src/repro_torch/csrc/int8_rerank.cu",
           "none: the search's f32 rerank over a dequantized table",
           float((rv8 - wv8).abs().max()),
           device_ms(lambda: int8_rerank(Qb, rows8, bi, bv, FINAL_K), busy),
           time_ms(lambda: ref.int8_rerank_ref(Qb, rows8.q, rows8.scale, bi, bv, FINAL_K), 3),
           valid * (D + 4 + 4) + Qb.numel() * 4 + ri8.numel() * 8, 2.0 * valid * D,
           shape=[BQ, BUDGET, D, FINAL_K], valid_candidates=valid, ids_agree_plain=ragree,
           f32_chain_ms=device_ms(f32_chain, busy))
    del si, sv, wi, wv, bi, bv, rows8, deq, ri8, rv8, wi8, wv8
    # kernels 3 and 4: one assignment shard against the trained codebook,
    # and the online inserts' batch of CHURN rows (MutableIVF.add)
    Xs = ds.X[:SHARD].contiguous()
    n, c, d = Xs.shape[0], Cb.shape[0], Xs.shape[1]
    Xo = ds.X[SHARD:SHARD + CHURN].contiguous()

    def online(got, want, fn, plain_fn, nbytes, ops_, mm_ops):
        """The kernel at the online batch against its plain version."""
        agree = float((got[0] == want[0]).float().mean())
        assert agree >= 0.999 and torch.allclose(got[1], want[1], rtol=1e-4, atol=1e-4), \
            "assignment kernel at the online batch"
        b_ms, b_by = bound(nbytes, ops_, mm_ops)
        return {"shape": [CHURN, c, d], "ms": time_ms(fn), "plain_ms": time_ms(plain_fn),
                "bound_ms": b_ms, "bound_by": b_by, "index_agreement": agree,
                "max_abs_err": float((got[1] - want[1]).abs().max())}

    gi, gv = vq_assign(Xs, Cb)
    wi, wv = ref.vq_assign_ref(Xs, Cb)
    vq_agree = float((gi == wi).float().mean())
    assert vq_agree >= 0.999 and torch.allclose(gv, wv, rtol=1e-4, atol=1e-4), "vq_assign"
    assert not torch.backends.cuda.matmul.allow_tf32, "product_ms needs f32 products"
    record("vq_assign", "src/repro_torch/csrc/vq_assign.cu",
           "src/repro/kernels/vq_assign.py:56", float((gv - wv).abs().max()),
           time_ms(lambda: vq_assign(Xs, Cb)),
           time_ms(lambda: ref.vq_assign_ref(Xs, Cb)),
           (n * d + c * d) * 4 + n * 8, 0, 2 * n * c * d,
           product_ms=time_ms(lambda: torch.mm(Xs, Cb.T)),
           tile_loop="src/repro_torch/csrc/assign_tc.cuh",
           index_agreement=vq_agree, shape=[n, c, d],
           online=online(vq_assign(Xo, Cb), ref.vq_assign_ref(Xo, Cb),
                         lambda: vq_assign(Xo, Cb), lambda: ref.vq_assign_ref(Xo, Cb),
                         (CHURN * d + c * d) * 4 + CHURN * 8, 0, 2 * CHURN * c * d))

    r = Xs - Cb[wi.long()]
    rhat = (r / torch.linalg.vector_norm(r, dim=-1, keepdim=True).clamp(min=1e-12)).contiguous()
    gi, gv = soar_assign(Xs, rhat, wi, Cb, 1.0)
    si, sv = ref.soar_assign_ref(Xs, rhat, wi, Cb, 1.0)
    soar_agree = float((gi == si).float().mean())
    assert soar_agree >= 0.999 and torch.allclose(gv, sv, rtol=1e-4, atol=1e-4), "soar_assign"
    assert not bool((gi == wi).any()), "soar_assign returned a primary"
    wo = ref.vq_assign_ref(Xo, Cb)[0]
    rho = unit_residuals(Xo, Cb, wo).contiguous()
    record("soar_assign", "src/repro_torch/csrc/soar_assign.cu",
           "src/repro/kernels/soar_assign.py:63", float((gv - sv).abs().max()),
           time_ms(lambda: soar_assign(Xs, rhat, wi, Cb, 1.0)),
           time_ms(lambda: ref.soar_assign_ref(Xs, rhat, wi, Cb, 1.0)),
           (2 * n * d + c * d) * 4 + n * 12, 6 * n * c, 4 * n * c * d,
           product_ms=time_ms(lambda: (torch.mm(Xs, Cb.T), torch.mm(rhat, Cb.T))),
           tile_loop="src/repro_torch/csrc/assign_tc.cuh",
           index_agreement=soar_agree, shape=[n, c, d],
           online=online(soar_assign(Xo, rho, wo, Cb, 1.0),
                         ref.soar_assign_ref(Xo, rho, wo, Cb, 1.0),
                         lambda: soar_assign(Xo, rho, wo, Cb, 1.0),
                         lambda: ref.soar_assign_ref(Xo, rho, wo, Cb, 1.0),
                         (2 * CHURN * d + c * d) * 4 + CHURN * 12, 6 * CHURN * c,
                         4 * CHURN * c * d))

    # kernel 5: one sweep over a training-sample-sized block
    n = Xt.shape[0]
    gC, gcnt, gdist = lloyd_sweep(Xt, Cb)
    wC, wcnt, wdist = ref.lloyd_sweep_ref(Xt, Cb)
    again = lloyd_sweep(Xt, Cb)
    assert all(torch.equal(a, b) for a, b in zip(again, (gC, gcnt, gdist))), \
        "lloyd_sweep is not bitwise reproducible"
    same = gcnt == wcnt
    moved = float((gcnt - wcnt).abs().sum())   # rows that changed centroid, x2
    rel = abs(float(gdist) - float(wdist)) / abs(float(wdist))
    assert moved <= 2 * 0.001 * n, f"lloyd counts differ by {moved}"
    assert torch.allclose(gC[same], wC[same], rtol=1e-5, atol=1e-6), "lloyd centroids"
    assert rel <= 1e-5, f"lloyd distortion rel err {rel}"
    ai, am = lloyd_mod.assign_phase(Xt, Cb)
    assign_agree = float((ai == ref.vq_assign_ref(Xt, Cb)[0]).float().mean())
    assert assign_agree >= 0.999, f"lloyd assignment agrees on {assign_agree} < 0.999"
    # the router's sweeps: its k-means over the c centroids, S supers
    Xr, Sr = idx.centroids.contiguous(), rt.super_centroids.contiguous()
    rcnt, wrcnt = lloyd_sweep(Xr, Sr)[1], ref.lloyd_sweep_ref(Xr, Sr)[1]
    r_moved = float((rcnt - wrcnt).abs().sum())
    assert r_moved <= 2 * 0.001 * Xr.shape[0] + 2, f"router-shape counts differ by {r_moved}"
    by_shape = {k: {"launches": v} for k, v in lloyd_shapes.items()}
    for X_, C_ in ((Xt, Cb), (Xr, Sr)):
        by_shape.setdefault(f"{X_.shape[0]}x{C_.shape[0]}x{X_.shape[1]}",
                            {"launches": 0})["ms"] = device_ms(lambda: lloyd_sweep(X_, C_),
                                                               busy)
    record("lloyd_sweep", "src/repro_torch/csrc/lloyd.cu",
           "src/repro/kernels/lloyd.py:158",
           float((gC[same] - wC[same]).abs().max()),
           time_ms(lambda: lloyd_sweep(Xt, Cb)),
           time_ms(lambda: ref.lloyd_sweep_ref(Xt, Cb)),
           (n * d + 2 * c * d + c) * 4 + 4, n * d, 2 * n * c * d,
           tile_loop="src/repro_torch/csrc/assign_tc.cuh",
           assign_ms=device_ms(lambda: lloyd_mod.assign_phase(Xt, Cb), busy),
           group_ms=device_ms(lambda: lloyd_mod.group_phase(Xt, Cb, ai, am), busy),
           assign_index_agreement=assign_agree, by_shape=by_shape,
           router_shape_count_moves=r_moved,
           counts_equal_share=float(same.float().mean()),
           count_moves=moved, distortion_rel_err=rel, shape=[n, c, d])

    # kernel 6: the trained router's tables; ids checked on every query,
    # timed on one bq tile
    tr = rt.eff_t_route
    tables = (rt.super_centroids, rt.child_centroids, rt.children)
    gs, gi = tree_route(ds.Q, *tables, tr)
    ws, wi = ref.tree_route_ref(ds.Q, *tables, tr)
    rows = (gi == wi).all(dim=1)
    row_agree = float(rows.float().mean())
    assert row_agree >= 0.999, f"tree_route id rows agree on {row_agree} < 0.999"
    assert torch.equal(torch.isinf(gs[rows]), torch.isinf(ws[rows])), "tree_route masks"
    fin = torch.isfinite(ws[rows])
    assert torch.allclose(gs[rows][fin], ws[rows][fin], rtol=1e-4, atol=1e-4), "tree_route"
    assert torch.equal(tree_route(ds.Q, *tables, tr)[0], gs), \
        "tree_route is not bitwise repeatable"

    def route_times(Q_, tabs, t_):
        """(device ms, the parent kernel's device ms or None, the wrapper's
        host µs per call) of one route at these inputs."""
        S_, cm_ = tabs[2].shape
        w = t_ * cm_

        def parent_route():
            sc = torch.empty((Q_.shape[0], w), device=DEVICE)
            ii = torch.empty((Q_.shape[0], w), dtype=torch.int32, device=DEVICE)
            par.launch("tree_route_launch", Q_, *tabs, Q_.shape[0], S_, cm_, Q_.shape[1],
                       t_, sc, ii)
            return sc, ii

        if par is not None:
            assert torch.equal(parent_route()[1], ref.tree_route_ref(Q_, *tabs, t_)[1]), \
                "parent tree_route ids"
        return (device_ms(lambda: tree_route(Q_, *tabs, t_), busy, 50),
                device_ms(parent_route, busy, 50) if par else None,
                host_us(lambda: tree_route(Q_, *tabs, t_)))

    def route_bytes_ops(nq_, S_, cm_, d_, t_):
        return ((nq_ * d_ + S_ * d_ + S_ * cm_ * d_ + S_ * cm_) * 4 + nq_ * t_ * cm_ * 8,
                2 * nq_ * (S_ + t_ * cm_) * d_)

    # the second shape: c = 32,768 at the router's defaults
    S2, T2, CM2 = 181, 23, 256
    tabs2 = tree_tables(args.seed, S2, CM2, D, DEVICE)
    Q2 = ds.Q[BQ:2 * BQ]
    g2s, g2i = tree_route(Q2, *tabs2, T2)
    w2s, w2i = ref.tree_route_ref(Q2, *tabs2, T2)
    assert torch.equal(g2i, w2i), "tree_route ids at the c = 32,768 shape"
    fin2 = torch.isfinite(w2s)
    assert torch.equal(fin2, torch.isfinite(g2s)), "tree_route masks at c = 32,768"
    assert torch.allclose(g2s[fin2], w2s[fin2], rtol=1e-4, atol=1e-4), "tree_route c=32,768"
    ms2, par2, host2 = route_times(Q2, tabs2, T2)
    b2 = bound(*route_bytes_ops(BQ, S2, CM2, D, T2))
    # the third shape: phase 16's shard router, shard 0's tables on one tile
    Q3, *tabs3, T3 = route16
    S3, CM3 = tabs3[2].shape
    g3s, g3i = tree_route(Q3, *tabs3, T3)
    w3s, w3i = ref.tree_route_ref(Q3, *tabs3, T3)
    assert torch.equal(g3i, w3i), "tree_route ids at phase 16's shard router"
    fin3 = torch.isfinite(w3s)
    assert torch.equal(fin3, torch.isfinite(g3s)), "tree_route masks at phase 16's router"
    assert torch.allclose(g3s[fin3], w3s[fin3], rtol=1e-4, atol=1e-4), \
        "tree_route at phase 16's router"
    ms3, par3, host3 = route_times(Q3, tabs3, T3)
    b3 = bound(*route_bytes_ops(Q3.shape[0], S3, CM3, Q3.shape[1], T3))
    S, cm = rt.n_super, rt.cmax
    ms1, par1, host1 = route_times(Qb, tables, tr)
    record("tree_route", "src/repro_torch/csrc/tree_route.cu",
           "src/repro/kernels/tree_route.py:96", float((gs[rows][fin] - ws[rows][fin]).abs().max()),
           ms1, time_ms(lambda: ref.tree_route_ref(Qb, *tables, tr)),
           *route_bytes_ops(BQ, S, cm, D, tr), id_rows_equal_share=row_agree,
           shape=[BQ, S, cm, D, tr], parent_ms=par1, host_us=host1,
           router_call_host_us=host_us(lambda: rt.route(Qb, TOP_T)),
           back_to_back_ms=time_ms(lambda: tree_route(Qb, *tables, tr)),
           c32k={"shape": [BQ, S2, CM2, D, T2], "ms": ms2, "parent_ms": par2,
                 "host_us": host2, "bound_ms": b2[0], "bound_by": b2[1],
                 "share": b2[0] / ms2,
                 "max_abs_err": float((g2s[fin2] - w2s[fin2]).abs().max())},
           shard_router={"shape": [Q3.shape[0], S3, CM3, Q3.shape[1], T3],
                         "phase16_launches": ssum["launches"]["tree_route"],
                         "ms": ms3, "parent_ms": par3, "host_us": host3,
                         "bound_ms": b3[0], "bound_by": b3[1], "share": b3[0] / ms3,
                         "max_abs_err": float((g3s[fin3] - w3s[fin3]).abs().max())})
    del g3s, g3i, w3s, w3i

    # kernel 7: every k-means++ pick of a seeding in one launch, at the
    # codebook's shape and at PQ's; small integer coordinates make every
    # f32 dot exact, so the picks must be the plain loop's
    def pp_case(m, n, d, c, seed, X=None):
        g = torch.Generator().manual_seed(seed)
        if X is None:
            X = torch.randint(-8, 9, (m, n, d), generator=g).float().to(DEVICE)
        return (X, torch.randint(0, n, (m,), generator=g).to(DEVICE),
                torch.rand((c - 1, m), generator=g).to(DEVICE))

    def pp_sizes(m, n, d, c):
        """X, u and the centres moved once, first read once; 2 n d f32
        operations a pick for the distances."""
        return (m * n * d + m * c * d + (c - 1) * m) * 4 + m * 8, 2 * m * n * d * (c - 1)

    pp = {}
    for key, (m, n, d, c) in (("codebook", (1, 32_768, D, C)), ("pq", (M, 32_768, 2, 16))):
        pargs = pp_case(m, n, d, c, args.seed + len(pp))
        got, want = kmeans_pp(*pargs), ref.kmeans_pp_ref(*pargs)
        assert torch.equal(got, want), f"kmeans_pp differs from its plain loop at {key}"
        b_ms, b_by = bound(*pp_sizes(m, n, d, c))
        ms = time_ms(lambda: kmeans_pp(*pargs))
        pp[key] = {"shape": [m, n, d, c], "ms": ms, "bound_ms": b_ms,
                   "max_abs_err": float((got - want).abs().max()),
                   "bound_by": b_by, "share": b_ms / ms, "us_per_pick": ms * 1e3 / (c - 1),
                   "plain_ms": time_ms(lambda: ref.kmeans_pp_ref(*pargs), 2)}
    pargs = pp_case(1, 32_768, D, C, args.seed, Xt[None, :32_768])
    got = kmeans_pp(*pargs)[0]
    assert torch.equal(kmeans_pp(*pargs)[0], got), "kmeans_pp is not bitwise repeatable"
    for i in range(0, C, 100):
        assert bool((got[i:i + 100, None] == pargs[0]).all(-1).any(1).all()), \
            "a kmeans_pp seed is not a row of the data"
    assert got.unique(dim=0).shape[0] == C, "kmeans_pp picked a row twice"
    dargs = pp_case(1, 32_768, 96, 32_768, args.seed + 2)
    d_ms = time_ms(lambda: kmeans_pp(*dargs), 2)
    d_b = bound(*pp_sizes(1, 32_768, 96, 32_768))
    del dargs, got, pargs
    cb = pp.pop("codebook")
    record("kmeans_pp", "src/repro_torch/csrc/kmeans_pp.cu", "src/repro/core/kmeans.py:57",
           cb.pop("max_abs_err"), cb.pop("ms"), cb.pop("plain_ms"), *pp_sizes(*cb["shape"]),
           us_per_pick=cb["us_per_pick"], shape=cb["shape"], pq=pp["pq"],
           c32k={"shape": [1, 32_768, 96, 32_768], "ms": d_ms, "bound_ms": d_b[0],
                 "bound_by": d_b[1], "share": d_b[0] / d_ms,
                 "us_per_pick": d_ms * 1e3 / 32_767})
    del pp, cb

    # the build's plain-torch work at its shapes: one shard for the spill
    # columns, the training sample for the anisotropic steps, all rows for
    # int8
    plain = []

    def plain_row(name, where, calls, ms, nbytes, ops_, shape, **extra):
        b_ms, b_by = bound(nbytes, ops_)
        plain.append({"name": name, "source": where, "calls": calls, "ms": ms,
                      "bound_ms": b_ms, "bound_by": b_by, "share": b_ms / ms,
                      "shape": shape, **extra})

    n, c, d = Xs.shape[0], Cb.shape[0], Xs.shape[1]
    prim = ref.vq_assign_ref(Xs, Cb)[0]
    rh = unit_residuals(Xs, Cb, prim)
    first = torch.stack([prim, ref.soar_assign_ref(Xs, rh, prim, Cb, 1.0)[0]], 1)
    plain_row("spill_columns", "src/repro_torch/kernels/soar_assign.py",
              plain_calls["spill_columns"],
              time_ms(lambda: spill_columns(Xs, Cb, rh, first, 1.0, 1)),
              (2 * n * d + c * d) * 4 + 3 * n * 4, 6 * n * c * d + 12 * n * c, [n, c, d, 1])
    n = Xt.shape[0]
    eta = aniso_mod.eta_from_threshold(ANISO_T, d)
    plain_row("anisotropic_assign", "src/repro_torch/quant/anisotropic.py",
              plain_calls["anisotropic_assign"],
              time_ms(lambda: aniso_mod.anisotropic_assign(Xt, Cb, eta)),
              (n * d + c * d) * 4 + n * 4, 4 * n * c * d + 8 * n * c + 4 * n * d, [n, c, d])
    at = aniso_mod.anisotropic_assign(Xt, Cb, eta)
    A, bvec, _ = aniso_mod.normal_equations(Xt, at, eta, c)
    eye = torch.eye(d, device=DEVICE)
    plain_row("anisotropic_update", "src/repro_torch/quant/anisotropic.py",
              plain_calls["_anisotropic_update"],
              time_ms(lambda: aniso_mod._anisotropic_update(Xt, Cb, at, eta)),
              (n * d + n + 2 * c * d) * 4, 2 * n * d * d + n * d + c * (2 * d ** 3 // 3 + 2 * d * d),
              [n, c, d],
              accumulate_ms=time_ms(lambda: aniso_mod.normal_equations(Xt, at, eta, c)),
              solve_ms=time_ms(lambda: torch.linalg.solve(A + 1e-6 * eye, bvec[..., None])))
    n = N
    plain_row("int8_quantize", "src/repro_torch/quant/int8.py", plain_calls["int8_quantize"],
              time_ms(lambda: int8_quantize(ds.X)), n * d * 5 + n * 4, 5 * n * d, [n, d])
    for row in plain:
        print(f"plain {row['name']}: calls {row['calls']} ms {row['ms']:.4f} "
              f"bound {row['bound_ms']:.4f} ({row['bound_by']})")
    print("plain work: " + json.dumps(plain))

    return smi, kind, wrappers, kernels


if __name__ == "__main__":
    sys.exit(main())
