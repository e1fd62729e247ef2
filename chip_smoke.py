#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``persia_tpu_torch``) on one card.

    python3 chip_smoke.py        # from the repository root, one CUDA card
    python3 chip_smoke.py --ab ROOT OUT.npz [k12|k15|k15s|k16]   # K2, K4, K7-K9, K12, K13, K15 of the tree ROOT
    python3 chip_smoke.py --ab-compare A.npz B.npz ...
    python3 chip_smoke.py --stream-ab PAIRS   # in-order vs pipelined stream, in turns

(``--ab``: see ``ab_run``; it compares two trees' kernels, parent and
change, in one call. ``--stream-ab``: see ``stream_ab``.)

Phases, in order; any failure ends the run with a nonzero exit and no
result line:

1. build the port's CUDA kernels from ``persia_tpu_torch/csrc`` (nvcc,
   sm_90a); the flash-attention kernels' SASS must hold wgmma (HGMMA) and
   TMA loads (UTMALDG), the f32 one without spills; K5's kernels and the
   routing kernel on the dim-16 f32 path without spills; K6-K9's kernels
   (raw gather and its scatter-add, attention pool) and K2's two passes
   reported, K9 by template, K8 and K9 at the DIN path's template (2
   positions a lane) without spills; K12 and its read alone with their
   registers and 16-byte global loads and stores (LDG.128 / STG.128),
   which their 16-byte templates must hold; K15's four templates (f32 and
   bf16 gradients, 8-element units or scalar) with their registers and
   16-byte loads and stores, the bf16 8-element one (the ps-stream
   path's) reported with 16-byte loads (LDG.128), 8-byte code stores
   (STG.64) and 16-byte residual stores (STG.128), none spilling;
2. flash_attention on the card vs its plain version (dense f32 softmax):
   the bf16 route (wgmma) and the f32 route (split TF32 on wgmma, its
   pre-pass held bit for bit to ``tf32_split_planes_reference``) at every
   head dim, ragged L=1000;
3. the DLRM kernels on the card vs their plain versions, at the bench
   shape and at edge shapes: the dot interaction and its backward, the
   grouped gather-pool forward and backward (zipf(1.2) ids at the bench
   shape, all positions on one row, a segment ending on a chunk edge, L=4,
   counts, f32 rows of dim 8, 24 and 10, a group of 70 slots), the
   backward's bitwise determinism and, without counts, its sums bit for
   bit against ``plans.pool_bwd_model`` (its own order, in numpy);
   (3b) the fused tier's kernels: K4 ``fused_gather`` bit for bit against
   its plain version, with and without the update keys it writes for the
   step, and those keys bit for bit the plain routing
   (``update_keys_reference``) (stacked at the bench shape on uniform and
   zipf(1.2) ids with pads, ids at the vocab's last row, past it and far
   past it, a bf16 table with a pooled (B, 5) slot, unstacked with NaN
   rows, dim 10), the standalone routing of the update ids (``update_keys``,
   the graph step's warm-up) bit for bit against its plain version (26 slots of
   B=4096 with pads, ids past the vocab and ids < -1; 130 slots, two
   launches), K5 ``sparse_update`` bit for bit against its plain version on
   the CPU (SGD, Adagrad, Adagrad vectorwise, all with weight decay, and
   Adam, on uniform, zipf(1.2) and one-row streams with pads, on hot
   segments (762, 318, 180 positions and the long threshold - 1, at it and
   + 1) and on segments ending on a staged tile's edge; the bench's 26
   stacked tables with Adagrad(0.05); a bf16 table), each case's longest
   segment printed; and past 2^31 elements, the Criteo-1TB stack
   (183,873,726 x 16 f32 and its Adagrad state, 23.5 GB, on the card):
   K4 with its keys on a Criteo-1TB batch with ids at every slot's last
   rows (the stack's last 12 slots lie past row 2^27, element 2^31), pads
   and ids past the slot, bit for bit its plain version on the card, and
   K5 on those keys bit for bit its plain version on the CPU over the
   touched rows (remapped in order), the table's and state's integer
   checksums moved by the touched rows alone;
   (3c) the DIN path's kernels at its shape (B=1024, L=50, dim 16, two raw
   slots of 26,000 and 9,000 distinct rows), both dtypes: K6
   ``raw_gather_fwd`` bit for bit; K7 ``raw_gather_bwd`` within twice the
   f32 sum-order bound and one rounding of its plain version (index_add_),
   bit for bit twice and against its schedule (``plans.raw_bwd_model``),
   on Taobao-length histories with an empty and a full one (where no row
   is long: also bit for bit its plain version run on the CPU) and on
   every position on one row (long rows), the pad row zero; K8
   ``attention_pool_fwd``
   (weights to 1e-6, the pooled rows inside their f64 envelope: an f32 sum
   in any order, then one rounding) and K9 ``attention_pool_bwd`` (d_hist
   bit for bit, d_logits inside its envelope), kernel and plain version
   alike, nothing at masked positions or on the empty row, no NaN; K8 and
   K9 again at their edges (``ATT_EDGE_CASES``: every template, a lane
   group walking past kAhead, the scalar path) on random masks;
   (3d) DNN's batch norm, K10 (train mode and the running statistics) and
   K11, at the DNN paths' shapes (``BN_CASES``: B=4096 and 256 by C=128
   and 32, B=128 by C=64 and 16), at one row (y = bias), at C=10, in f32
   and over unequal row spans of a cluster (B=2049, 4100): y and dx
   within one ulp of the dtype plus 1e-5 of the column's scale, the
   statistics and the parameters' gradients within 1e-5 of the
   plain versions on the card; bit for bit their schedules
   (``batch_norm_*_schedule``: the plain versions with the kernels' sum
   order) on the CPU and bit for bit twice; eval mode moves nothing;
   (3e) the cache tier's kernels against their plain versions on the CPU:
   K12 ``cache_aux`` (one kernel a call) bit for bit (payload, pool and
   state) for SGD, Adagrad (and vectorwise), Adam, f32 and bf16 aux and
   write-back wires, misses on rows nobody evicts, every miss on a row
   evicted that step and half of them (the other evictions unclaimed),
   every row a pad, no rows, only writes; with the ring (a start that
   fits, one the clamp moves, a negative one), the ring bit for bit too;
   one call's device trace holds exactly one kernel; its read alone
   ``gather_entry_rows`` (2^18 rows, each optimizer's widths); K13
   ``cached_gather`` at the bench's (26, 4096, 1) rows on 2^21- and
   2^18-row pools (zipf rows, pads, scales, eval misses) bit for bit, at
   L = 4 and 8 within the f32 sum-order bound (L - 1) * 2^-23 *
   sum |x| * |scale|, its keys, raw rows and mask bit for bit; K12 with
   the stream's in-flight restores in its launch (the payload, the ring,
   the pool and state bit for bit) for SGD, Adagrad (and vectorwise) and
   Adam from f32 and bf16 rings, restores mixed with warm, cold and
   evicted rows (half the misses, restored ones too, on rows evicted that
   step), every restore a pad, no restores, and two K12 calls, the second
   restoring from the ring span the first filled onto rows it wrote;
   (3f) the mixed tier's int8 gradient wire, K15 ``quantize_int8_ef``, bit
   for bit (codes, scales and the residual it rewrites in place, three
   steps with the residual carried) against its plain version on the card
   and on the CPU, at the ps-stream path's shape (26 segments of 1,536 x
   16) and at ``K15_CASES``: segment lengths that are not multiples of
   512 or of the 8-element unit, empty segments, host-pooled (B, D)
   beside device-pooled (P, D) ones, starts off 8 elements before a
   vector body, one segment past a cluster's registers, 512 segments, the
   mixed leg's 13 segments; a NaN inside one segment (against the card's
   plain version bit for bit, against the CPU's with NaN payloads set
   aside: x86 keeps an operand's, the card returns its canonical NaN) and
   the edges of its division (tiny and huge scales, subnormal gradients,
   rounding midpoints, signed zeros, an infinity), bf16 and f32 gradients;
4. the paths, each with the launch counts set to 0 just before and read
   just after: (a) the flash-attention entry point at (B=4, L=1024, H=8,
   D=64) in bf16 and in f32, causal and not, and its backward (a dense
   recompute that launches no kernel) against the CPU port's; (b) the
   serving slice at bench width — DLRM (13 dense features, 26 single-id
   slots of dim 16, bottom (256, 64, 16), top (512, 256)) behind
   ``InferenceEngine(InferCtx(...))`` on the native store and worker cores,
   answering 5 requests of B=4096 zipf ids through ``predict_from_bytes``,
   held against the same engine on the CPU over the numpy store; (c) the
   training slice at the same width — ``TrainCtx(...).train_step`` with
   device pooling, a bf16 wire, sparse Adagrad(0.05) on the native store and
   Adam(1e-3) on the dense tower: 2 warm-up and 8 measured steps, then 5
   steps stage by stage, its first 3 losses and its PS rows held against
   the same steps on the CPU over the numpy store; (d) the pipelined
   training path at the same width and the bench's settings —
   ``DataLoader(num_workers=4, staleness=4)`` and
   ``TrainCtx.train_step_prepared(..., fetch_metrics=False)`` over 32
   batches after 2 synchronous warm-up steps, the window whole after
   ``flush``, and 4 batches with ``reproducible=True, staleness=1`` held to
   ``train_step`` on the same batches. Phases 4b-4d fail unless the native
   cores build (``g++``) and serve them: no numpy fallback; (e) the fused
   all-on-card tier at the bench's configuration (``bench.py:100-221``: 26
   stacked tables of 1M x 16 f32 with their Adagrad(0.05) state on the
   card, Adam(1e-3), B=4096, uniform ids): the CUDA-graph step held bit for
   bit to the eager step over 5 steps from one state, its first 3 losses,
   the rows they touched and what the steps changed in them held to the
   CPU port's from a copy of the state, the graph step's capture counted
   (its warm-up and the capture: K4 and K5 twice, ``update_keys`` once,
   in the warm-up), 100 timed graph steps, synced
   steps, 100 eager steps (the counted run: a graph replay goes through no
   wrapper; K4, which routes the update ids, and K5 once a step,
   ``update_keys`` never), a zipf(1.2) stream, the
   card's busy time a graph step and its kernels' runs from the device
   trace (K4 and K5's three kernels once a step, the routing kernel
   never), beside the same with the update ids routed by the standalone
   kernel after K4 without keys (in turns: new, standalone, new; card busy,
   PyTorch elementwise kernels and kernel runs a step), and
   ``FusedTrainCtx.train_pipelined`` (depth 2) over
   32 batches; (f) durable state on the hybrid tier at the training path's
   width and settings (native store 2^25, 64 shards): (a) an uninterrupted
   run of 12 ``train_step``s after a cold ``resume``, ``snapshot_job``
   every 4 (each snapshot's PS capture, dense bytes and commit timed);
   a second run on fresh stores, snapshots at 4 and 8, abandoned after
   step 9; fresh stores and ctx ``resume(restore_ps=True)`` from the fence
   at 8 (timed) and replay steps 9-12 (the counted run: K0, K3, K1, K2 4
   times each): the dense state's flax bytes byte-equal and every PS
   shard's dump byte-equal to the uninterrupted run's, or the phase fails
   naming what differs; (b) ``resume(restore_ps=False)`` over the crashed
   run's store: the replayed step moves no entry, ``journal_skips`` at
   least 1 a replayed step; (c) ``EmbeddingWorker.dump`` of one replica
   and ``load`` into two (timed): each replica holds its own signs, their
   union the dump's entries; (d) the port's manifest read back, beside the
   reference's (``tests/fixtures/jax_train_ctx_manifest``): every blob's
   crc, the same layout, its dense state loaded into a DLRM on the card
   and its shards into native stores, both written back byte-equal; one
   snapshot and one rewind resume of the store filled to a quarter of its
   capacity with synthetic rows (ms a MiB; the restored dumps and dense
   bytes equal to the snapshot's); and the journal's host cost, the step's
   samples/s armed and not (96 steps a side in turns, the mean difference
   with its standard error, ``payload_crc`` timed); (g) DIN on Taobao at
   ``examples/taobao_din/train.py``'s width (B=1024, 50-long histories,
   dim 16, the items and cates feature groups, DIN attention (36,), top
   (200, 80), Adagrad(0.05) on two native-store replicas of 2^20 rows and
   16 shards, Adam(1e-3), the f32 wire, ``TaobaoSynthetic(seed=42)`` at its
   default vocabularies): 3 reproducible staleness-1 loader steps held to
   ``train_step`` on the CPU over numpy stores (losses 2e-2, PS rows
   1e-2), then 16 batches through ``DataLoader(num_workers=4,
   staleness=4)`` + ``train_step_prepared`` (the counted run: K6 and K7
   once a step, K8 and K9 once a raw slot), stage p50s, the card's busy
   time a step, the held-out AUC over 4 batches (not gated); (h) the
   trained dense state as flax's bytes loaded into a DIN behind
   ``InferenceEngine(InferCtx(...))``, 5 requests of B=1024 through
   ``predict_from_bytes`` held to the same weights on the CPU (2e-2; K6
   once, K8 twice a request); (i) DeepFM and DCN-v2 (3 cross layers) on
   Avazu at ``examples/avazu/train.py``'s width (21 fields of dim 16, deep
   (256, 128), B=4096): 8 ``TrainCtx.train_step``s each, the first 3
   losses held to the CPU port (2e-2), no kernel of the port launched
   (host pooling); then the router's fan-out across its replicas
   against the same calls run inline and with every part handed to the
   pool (subclasses here), in turns (fan, inline, pool_all, pool_all,
   inline, fan, twice), the same 16 batches a turn on 4g's and
   4i's ctxs (two native replicas) after a warm-up pass over them:
   synchronous ``train_step``s of DIN and DeepFM, and DIN through
   ``DataLoader(num_workers=4, staleness=4)``; each turn's lookup and
   update p50, the router's ms a step (every call's time, its tails
   included) and samples/s;
   (j) DNN with its batch statistics: (a) the adult-income
   example's exact configuration (``persia_tpu_torch.testing.adult_income``,
   from the reference's initial weights) for its 4 epochs on the card and
   on the CPU, each epoch's loss and AUC printed, the final AUC of both
   within 5e-3 of the example's pinned ``REPRODUCIBLE_AUC`` (the
   difference printed, and the first step whose loss leaves the CPU's by
   2e-2), K10 and K11 only (host pooling); (b) DNN at the serving bench's
   width (8 zipf(1.2) slots of dim 16 over 100,000 ids, 8 dense features,
   DNN(32, 128, (128, 64)), native store 2^18 / 4 shards, Adagrad(0.1),
   Adam(3e-3)) with device pooling: 2 + 8 ``train_step``s of B=4096 (the
   counted run: K1 and K2 once a step, K10 and K11 twice), the losses
   within 2e-2, ``batch_stats`` within 1e-2 and 99 % of the touched PS
   rows within 1e-2 (their Adagrad accumulators within 1e-2 of
   themselves; every row within 5e-2 and 0.1) of the CPU port over the
   numpy store (after the first step, from the same state: the rows within
   1e-2 and their accumulators within 1e-2 of themselves), the five widest
   rows with the steps that touched them, and the witness: the same steps
   in f32 compute, card against CPU after the first step (losses and
   statistics within 1e-5, rows and accumulators within twice the gaps
   the first batch with its samples permuted makes on each device, and at
   least 1e-4 and 1e-3), and
   after the first and the last beside the card against itself
   from Dense_2's kernel moved by one ulp (how far training grows a
   rounding-sized difference), samples/s, step p50 and the card's busy
   ms a step; then the trained state's flax bytes loaded into a bare DNN
   (``model_from_flax_bytes``) behind ``InferenceEngine(InferCtx(...))``,
   5 requests of B=256 (K1 once, K10 twice in eval mode a request) within
   2e-2 of the CPU engine, their p50; (c) kill and resume at
   ``bench.py:936-960``'s configuration on the card: the rewind resume bit
   for bit the uninterrupted run (dense bytes with ``batch_stats``, every
   PS shard), the journal resume skipping the replayed window,
   ``time_to_resume_s`` of both; (k) the cache tier
   (``CachedTrainCtx.train_step``) at ``bench.py``'s cached configuration
   (``bench.py:285-344``: 26 zipf(1.2) slots of dim 16 over 1M ids, DLRM
   bottom (256, 64, 16), top (512, 256), Adam(1e-3), Adagrad(0.05),
   native store 2^25 / 64 shards / seed 1, bf16 write-back and aux wires,
   ``admit_touches=2``, B=4096) in two regimes, each counted (K13 once a
   step and once for the eval batch, K12 once a step that touched the
   pool, ``gather_entry_rows`` once for the flush, K5 once a step): the
   fill (2^21 rows, 16 steps) and the saturated cache (2^18 rows, run
   until the last 16 steps all evict), 3 more steps under the profiler;
   samples/s, step p50 and longest, the host stages (``prepare_batch``,
   staging, aux, main step, write-back), card busy ms a step, hit rate,
   misses and evictions a step, peak device bytes; an eval batch leaves
   the directory as it was; the same batches on the CPU port: the
   directory's decisions (row matrices, warm, cold and evicted rows,
   evicted signs) the same at every step, losses within 2e-2, the
   server's entries of the batches' signs after ``flush`` within 1e-2;
   and, with SGD, no eviction, the gate off and f32 wires, the cache
   tier's rows after ``flush`` within 1e-2 of the hybrid ``TrainCtx``'s
   on the same 4 batches; then, in each regime, the stream
   (``CachedTrainCtx.train_stream`` at ``bench.py``'s knobs: ``dispatch_k=8``,
   ``pipeline_depth=1``, ``fetch_final=False``, ``prefetch=3``,
   ``wb_flush_steps=8``) over the same batches from the same start, counted
   (K13, K5 and the dot interaction once a step, K12 once a step that
   touched the pool, restores included; the saturated stream must
   restore): the directory's decisions (row matrices, cold rows, the
   warm and restored rows together, evicted rows and signs) those of the
   synchronous steps at every step, the last loss finite, the server's
   entries after ``flush`` within 1e-5 relative of the synchronous run's;
   samples/s beside the synchronous path's, each lane's busy seconds,
   steps a pack, restores a step, K12/K13 launches a step, card busy
   ms a step (the rest of the batches as a stream under the profiler) and
   peak device bytes; then the stage-pipelined stream (``bench.py``'s
   cached-pipelined knobs: ``pipeline_depth=4``, ``dispatch_k=8``,
   ``fetch_final=False``) from a fresh ctx over the same batches, split
   alike, counted: its decisions those of the in-order stream at every
   step, its servers' entries after ``flush`` bit for bit the in-order
   stream's (else within 1e-5 relative, the differing share printed);
   samples/s and ``speedup_vs_inorder``, hoisted feeds, stalls, barrier
   (restoring) steps, ``stage_overlap_frac``, each lane's busy seconds,
   card busy ms a step, K12/K13 launches a step; then the mixed tier
   (``CachedTrainCtx(ps_slots=, ps_wire_dtype=)``) at ``bench.py``'s
   ps-stream configuration (``bench.py:285-344`` with ``ps_all``: all 26
   slots on the PS through a device-pooling worker, the int8 wire,
   ``cache_rows=8`` unused), each leg counted: (ps-stream) 4 warm-up and
   30 timed batches through ``train_stream(prefetch=4, psgrad_batch=16,
   fetch_final=False)`` as ``bench_ps_stream`` runs them (K15, K1, K2, K0
   and K3 once a step, no cache kernel): samples/s, each lane's busy
   seconds, the PS-gradient flushes, the gradient bytes a sample on the
   d2h wire; staleness 0 and every ref released at the end, every step
   applied once, the batches' signs in the store with moved
   accumulators; (ps-sync) 8 synchronous steps on the card and in the CPU
   port (losses within 2e-2, the PS entries within 1e-2) and with the f32
   wire on the card (the int8 wire's entries within 0.15 of their norm,
   ``tests/test_hbm_cache.py:1613``'s gate); (mixed) cat_0-cat_12 cached
   at 2^18 rows (bf16 wires, the touch gate), cat_13-cat_25 on the PS
   (int8), 16 synchronous steps on the card and the CPU (the cached half's
   decisions equal at every step, losses within 2e-2, entries after flush
   within 1e-2), then the same batches as the stream at the bench's knobs
   (its decisions the synchronous steps', its last loss within 2e-2 of
   theirs); (l) the Criteo DLRM example through the port
   (``persia_tpu_torch.testing.criteo_dlrm``: DLRM bottom (64, 32, 16),
   top (256, 128), Adam(1e-3), Adagrad(0.05), B=4096, the example's 64
   train and 8 held-out batches cut to 12 and 4) at Kaggle and at 1TB
   cardinalities on each tier: hybrid (two numpy replicas of 2^20 rows;
   the first 3 steps through the reproducible loader held to the CPU
   port's, losses 2e-2 and every PS row 1e-2, then the counted run through
   ``DataLoader(num_workers=4, staleness=4)``: K0 and K3 once a step),
   cached (2^18 cache rows; at 1TB the 6 hash-stacked slots on the PS
   tier; the example's stream over every batch, counted: K0, K3, K13 and
   K5 once a step, K12; its first 3 losses held to the CPU port's stream
   at 2e-2; ``publish()``) and fused (every table whole on the card: 33.8M
   rows and 4.3 GB at Kaggle, 183.9M rows and 23.5 GB at 1TB, built by
   ``FusedTrainCtx``; the example's loop, the CUDA-graph step, beside an
   eager twin of the state, the counted run (K4 with keys, K5, K0 and K3
   once a step), bit for bit; the first 3 losses and the rows they touched
   held to a CPU twin that holds only those rows, copied from the card's
   state and remapped in order, at 2e-2, 1e-2 and the deltas at
   ``FUSED_DELTA_RTOL``; peak device bytes); each leg's held-out AUC (not
   gated) and samples/s; (m) the 100T harness
   (``persia_tpu_torch.testing.synthetic_100t``: 128 numpy replicas of 2^16
   rows, 8 slots of 4 uniform u64 ids, B=1024, DLRM bottom (32, 16), top
   (64, 32)): 3 reproducible steps held to the CPU port (losses 2e-2,
   every replica's entries 1e-2), then 8 steps through the example's
   loader, counted (K0 and K3 once a step), and the example's record
   (samples/s, ids/s through the router, rows resident, bytes a row, the
   100T extrapolation); (n) the quality gate
   (``persia_tpu_torch.testing.quality``, ``bench.py:680-900``'s tiers on
   one 200-step stream of ``CriteoSynthetic`` at [1M] x 26, 4 batches
   held out): cached (the bench's cached configuration), ps-stream (every
   slot on the PS, int8, device pooling) and fused (26 stacked 1M x 16
   tables), each counted (cached: K12, K13, K5; ps-stream: K15, K1, K2;
   fused: K4 and K5 in the graph's capture; K0 and K3), its AUC and
   samples/s; the phase fails when the AUCs spread by 0.02 or more;
5. timings of each kernel beside its plain version, the library call that
   computes the same function, and the card's bound, each by CUDA-graph
   replay (host enqueue cost out of the number; eager times beside them):
   flash attention per route and mask (the f32 route's pre-pass also on
   its own), the name of the kernel SDPA runs for f32 (torch.profiler),
   the dot interaction and its backward, the gather-pool forward and
   backward at the training path's own inputs, warm and also cold (inputs
   rotated through more than the 50 MB L2, one copy per captured call,
   beside their library calls); the serving latency and throughput; the
   training throughput and stage breakdown; K4 (with the update keys, as
   the step calls it, and without them, in turns) and K5 at the fused path's
   inputs, warm and cold (fresh batches rotated over the 1.66 GB table;
   K5 on uniform and zipf(1.2) ids with the longest segment printed, each
   of its steps apart (torch.profiler), ``torch.sort``'s time beside it,
   and every position on one row); the standalone routing pass against its
   bound and its plain version, ``torch.sort`` beside both; K6-K9 at the DIN path's
   own step (K6 beside ``torch.index_select``, K7 beside ``index_add_``
   with their ratio, the longest segments, every position on one row and
   its kernels a call in the device trace, K8 beside the softmax + bmm
   composite, K9's registers and its kernels in the device trace), warm
   and cold; the one-launch floor (a one-element ``add_``, twice), the
   standalone routing pass's time over it, and the routing's cost inside
   K4 (K4 with keys − K4 without); K10 and K11 at the DNN training path's
   first batch norm (B=4096, C=128, bf16; C=32 and the B=256 eval mode
   beside), warm and cold, beside ``F.batch_norm`` and aten's
   ``native_batch_norm_backward``; K12, its read alone and K13 at the
   saturated regime's own inputs (its last step's aux pieces and their
   pairing, its pool, its flush's rows, its (26, 4096, 1) rows), warm and
   cold (whole copies of the inputs, pool included, rotated), beside their
   plain versions and library calls (``index_select`` + ``cat`` +
   ``index_copy_``; ``F.embedding_bag`` with ``padding_idx``), K12 and
   its read over the one-launch floor; K12 at the saturated stream's last
   restoring step (its pieces, its ring, its restores, its pool) with its
   restores, without them, and unfolded as two launches (K12 without the
   restores, then a K12 call of the restores alone: a launch of their own,
   as before the fold), beside the bound (with the restores' bytes) and
   the one-launch floor;
   K15 at the ps-stream leg's own last warm-up step (its gradients,
   residual and 26 segments), warm and cold, beside its plain version,
   the 17 composed PyTorch calls that compute it (their bits compared
   with the kernel's) and the bound, over the one-launch floor, with its
   plan (blocks a cluster, blocks, threads, elements a thread);
   K4 (with keys) and K5 again at the Criteo-1TB stack (random, 23.5
   GB), warm and cold, on the Criteo-1TB stream's ids and on ids uniform
   over each slot (``at_1tb`` in their rows);
   and (5b) the flash-attention backward, a dense recompute, beside SDPA's
   backward.

Phase 3g holds K12, its read and K13 on a bf16 pool and K15 under the
loss scale's gate to their plain versions, bit for bit (K13 at L > 1
within the f32 sum-order bound). Phase 4o trains DeepFM and DCN-v2
(``testing/avazu.py --tier fused``: 21 tables, 9,449,205 rows, B=4096)
and DNN (phase 4j's width, its slots as fused tables) on the fused tier:
the CUDA-graph steps bit for bit an eager twin (counted: K4 and K5, DNN's
K10 and K11), the first losses and touched rows within
``FUSED_MODEL_TOL`` of a compact CPU twin, one device trace a model, a
checkpoint round trip bit for bit. Phase 4p runs the cache tier with bf16
pools and the dynamic loss scale at phase 4k saturated's rows, batches
and steps, in two turns of four legs (both options, each alone, neither),
the last counted and held to the CPU port (``PREC_TOL``) and to the
stream bit for bit; the ps-stream (int8) under the scale; and a forced
overflow on the mixed configuration that must move nothing and halve the
scale. Phase 5's rows of the new variants follow 4p: K12, its read and
K13 on a bf16 pool at the f32 rows' inputs, K15 gated at 4p's, warm and
cold, in turns with the f32 (ungated) call.

Phase 3h holds the dense sync's kernels bit for bit to their plain
versions at the bench tower's ring shapes (K16 ``block_quantize_int8``
with and without the error feedback, K17 ``block_dequantize_int8`` as a
hop's accumulate and as the all-gather's rows, the fused hop
``block_requantize_int8``, each also at ``SYNC_ODD_BLOCKS`` on its other
plan, K15's two dense-sync modes, flat passes over the vector:
``segment_absmax`` and the shared-scale quantize, its codes int32 (the
plain version's int8 codes widened), over the tower's leaves and at
``FLAT_CASES``, f32 and bf16, on and off 16 bytes). Phase 3i holds K18
``lp_ring_mix`` (LowPrecisionDecentralized's sync mix) bit for bit to its
plain version at the tower's 12 leaves and at
``testing.dense_sync.LP_MIX_CASES`` (512 segments, empty and 1-element
segments, boundaries inside a unit), on and off 16 bytes, with codes of
+-127 and 0, a scale of 1e-30, NaN and +-inf in x. After "5 (1TB)": phase 4q
runs the cache tier's sharded feeder (``feed_threads=4, feed_shards=8``)
at 4k saturated's 2^18 rows and batches beside the unsharded walk in
turns, synchronous and as the stream (samples/s, ``prepare_batch`` ms,
each shard's busy and stall ns, the host's usable cores), its decisions
held to the CPU port's sharded run and the stream's to the synchronous
steps'; phase 4r runs ``TrainCtx(mesh=, dense_sync=mode)`` for the six
modes at bench width (B=4096) at world size 1 over NCCL, counted (K16
and K17 once a ring step, K15's two modes once a bytegrad step) and held
to the CPU port, then two gloo ranks on the one card for the rings and
``f32-sharded`` (every rank's parameters the same bits, held to two CPU
ranks; a rank's ring step 1 K16, 1 fused hop, 1 K17), then the ring alone
at ``RING_RANKS`` gloo ranks on the card over the tower's padded vector,
bit for bit the same ranks on the CPU (5 launches a rank); "5 (dense
sync)" times K16 (also at a hop's chunk), K17, the fused hop (beside K17
then K16), K15's two modes (the quantize's codes int32, as bytegrad sums
them), and K18 and K15 at LowPrecisionDecentralized's 12 leaves. Phase 4r
also times ``bytegrad_allreduce`` on the card a step. Phase 4s (after
4r) runs ``build_sync_train_step`` with Decentralized(1), LocalSGD(2),
LowPrecisionDecentralized(1) and QAdam(warmup 1) at bench width, 3 steps
each: at world size 1 over NCCL, counted (LP 1 K15 and 1 K18 a step, QAdam
1 ``segment_absmax`` and 1 shared quantize a step after its warmup) and
held to the CPU port; at two gloo ranks on the card held to two CPU ranks
(LP's ``shadow_left`` bit for bit the neighbour's ``shadow_self``); LP's
sync alone at ``RING_RANKS`` gloo ranks, bit for bit as many CPU ranks;
and ``TrainCtx.train_step_prepared`` at two gloo ranks ("f32",
"block-int8-ring", a reproducible staleness-1 loader) beside
``train_step``.
``--ab ROOT OUT.npz k16`` runs another tree's K16 and K17 (and fused hop)
at those shapes; ``--ab ROOT OUT.npz k15s`` its two K15 modes.

Phases 4o-4p and 4l-4n run after phase 5's timings (a profiler session
after them once recorded no device work; whether one does is printed),
then phase 5's 1TB rows. Each phase's seconds are printed as it ends (``phase_seconds``); the
kernels line's ``launches_by_path`` holds each kernel's launches in the
counted runs of phases 4l-4n. The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import pathlib
import re
import shutil
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# the card's published peaks (H100 SXM data sheet, dense): HBM bytes/s and
# operations/s by type (float32: the FMA pipes; tf32: the tensor cores)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "tf32": 494.7e12, "float32": 67e12}

BATCH, N_DENSE, N_SLOTS, EMB_DIM, VOCAB = 4096, 13, 26, 16, 1_000_000
BOTTOM, TOP = (256, 64, EMB_DIM), (512, 256)
REQUESTS, WARM_BATCHES, SEED = 5, 8, 0
TRAIN_WARMUP, TRAIN_STEPS, TRAIN_STAGED, TRAIN_CPU_STEPS = 2, 8, 5, 3
PIPE_WORKERS, PIPE_STALENESS, PIPE_BATCHES, PIPE_PROFILED, PIPE_REPRO = 4, 4, 32, 8, 4
# (lookup threads, variant): "serial_stage" lets one thread stage at a time,
# "switch_0.5ms" runs the interpreter's thread switch interval at 0.5 ms
PIPE_SWEEP = ((1, None), (2, None), (4, None), (4, "serial_stage"), (4, "switch_0.5ms"))
PIPE_SWEEP_BATCHES = 16
# phase 4f: the uninterrupted run's steps, the snapshot interval, the step
# the crashed run dies after, and the steps of each side of the journal's
# cost (armed and not, in turns)
DUR_STEPS, DUR_EVERY, DUR_KILL, JOURNAL_COST_STEPS = 12, 4, 9, 96
# phase 4f's store at a stated fill: synthetic rows loaded into the bench
# store (a quarter of its 2^25-row capacity) before one snapshot and one
# rewind resume
DUR_FILL_ROWS = 1 << 23
# job directories and the checkpoint of phase 4f (inside the checkout,
# ignored by git, removed when the phase ends)
STATE_DIR = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_state"
# a job directory the reference's TrainCtx wrote (tests/test_torch_resume.py
# writes it): DLRM of the flagship's shape, two replicas of 4 shards
FIXTURE_DIR = pathlib.Path(__file__).resolve().parent / "tests" / "fixtures" / "jax_train_ctx_manifest"
FIXTURE_MODEL = dict(num_slots=5, bottom_mlp=(32, 16), top_mlp=(64, 32))
# phases 3c and 4g-4h: DIN on Taobao at examples/taobao_din/train.py's
# width (B, the history length, dim, the attention unit and the top MLP);
# the reproducible steps held to the CPU, the counted loader's batches, the
# held-out batches, the profiled steps and the serving requests
DIN_BATCH, DIN_HIST, DIN_DIM, DIN_ATT, DIN_TOP = 1024, 50, 16, (36,), (200, 80)
DIN_REPRO, DIN_BATCHES, DIN_EVAL, DIN_PROFILED, DIN_REQUESTS = 3, 16, 4, 4, 5
DIN_KERNELS = ("raw_gather_fwd", "raw_gather_bwd", "attention_pool_fwd", "attention_pool_bwd")
RAW_SOURCE, RAW_REPLACES = "persia_tpu_torch/csrc/raw_gather.cu", "persia_tpu/parallel/train_step.py:90"
ATT_SOURCE, ATT_REPLACES = "persia_tpu_torch/csrc/attention_pool.cu", "persia_tpu/models/din.py:67"
# K8/K9's template at the DIN path's shape (bf16, 16-byte vectors, 2
# positions a lane), and the kernels' edge cases (B, L, dim) that phase 3c
# and --ab add: positions a lane (L <= 32, 64, 256, 1536: 1, 2, 8, 48; past
# 256 K9's g goes through shared memory), a lane group walking more than
# kAhead positions (L = 200), the scalar path (dim 10)
ATT_DIN_TEMPLATE = "bf16,8,2"
ATT_EDGE_CASES = [(37, l, 16) for l in (32, 33, 64, 65, 200, 256, 257, 1536)] + [(37, 200, 10)]
# phase 4i: DeepFM and DCN-v2 on Avazu at examples/avazu/train.py's width
AVAZU_FIELDS, AVAZU_BATCH, AVAZU_STEPS, AVAZU_CPU_STEPS, AVAZU_DEEP = 21, 4096, 8, 3, (256, 128)
# phases 3d and 4j: DNN with its batch norms (K10, K11). (b) DNN at the
# serving bench's width (benchmarks/serving_bench.py:37-68): 8 slots of dim
# 16 over 100,000 ids, zipf(1.2), 8 dense features, DNN(32, 128, (128, 64)),
# device pooling; its warm-up and timed steps, the steps held to the CPU,
# the serving requests and their batch. (c) bench.py:936-960's kill and
# resume: DNN(8, 16, (32,)), 2 slots, B=64, 12 steps, a snapshot every 4,
# killed after 9
DNN_SLOTS, DNN_DIM, DNN_VOCAB, DNN_DENSE, DNN_MLP = 8, 16, 100_000, 8, (32, 128, (128, 64))
DNN_WARM, DNN_STEPS, DNN_CPU_STEPS, DNN_REQUESTS, DNN_SERVE_BATCH = 2, 8, 10, 5, 256
DNN_RESUME = dict(steps=12, every=4, kill=9, batch=64)
BN_SOURCE, BN_REPLACES = "persia_tpu_torch/csrc/batch_norm.cu", "persia_tpu/models/dnn.py:39"
BN_KERNELS = ("batch_norm_fwd", "batch_norm_bwd")
# phase 3d's cases (B, C, dtype): the DNN paths' own shapes (serving-bench
# width: B=4096 training, B=256 serving, C=128 and 32; adult income: B=128,
# C=64 and 16), one row (flax's variance 0), C not a multiple of 8, f32,
# rows split over a cluster into spans of unequal length (2049, 4100)
BN_CASES = [(4096, 128, "bfloat16"), (4096, 32, "bfloat16"), (256, 128, "bfloat16"), (256, 32, "bfloat16"),
            (128, 64, "bfloat16"), (128, 16, "bfloat16"), (1, 10, "bfloat16"), (37, 10, "bfloat16"),
            (2049, 128, "bfloat16"), (4100, 10, "bfloat16"), (4096, 128, "float32"), (1, 10, "float32"),
            (37, 10, "float32"), (4100, 10, "float32")]
FA_SOURCE = {"wgmma_bf16": "persia_tpu_torch/csrc/flash_attention_hopper.cu",
             "tf32x3": "persia_tpu_torch/csrc/flash_attention_tf32.cu"}
FA_REPLACES = "persia_tpu/ops/flash_attention.py:107"


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def check_envelope(name, out, ref, envelope, ref_envelope) -> float:
    """Fail unless the kernel's ``out`` lies inside its f64 ``envelope``
    (lo, hi) and the plain version's ``ref`` inside ``ref_envelope``;
    returns the max abs error of out against ref."""
    import torch

    from persia_tpu_torch.testing.envelopes import outside

    bad, bad_ref = outside(out, envelope), outside(ref, ref_envelope)
    max_err = float((out.float() - ref.float()).abs().max())
    width = float((envelope[1] - envelope[0]).max())
    straddle = int((envelope[1] != envelope[0]).sum())
    ok = bool(torch.isfinite(out).all()) and bad == 0 and bad_ref == 0
    print(f"  {name}: max_abs_err={max_err:.3e}; outside the envelope: kernel {bad}, plain {bad_ref} of "
          f"{out.numel()} (envelope widest {width:.3e}, {straddle} not one value) {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return max_err


def check_close(name, out, ref, rtol, atol, base=None) -> float:
    """Fail unless |out - ref| <= atol + rtol * |ref| everywhere (in f32);
    returns the max abs error. ``base``, a tighter (rtol, atol), is only
    reported: how many elements exceed it and by what factor at most."""
    import torch

    out, ref = out.float(), ref.float()
    err = (out - ref).abs()
    max_err = float(err.max())
    atol_shown = float(atol.max()) if torch.is_tensor(atol) else atol
    ok = bool(torch.isfinite(out).all()) and bool((err <= atol + rtol * ref.abs()).all())
    extra = ""
    if base is not None:
        ratio = err / (base[1] + base[0] * ref.abs())
        extra = (f" [beyond rtol {base[0]:g} atol {base[1]:g}: {int((ratio > 1).sum())} of "
                 f"{ratio.numel()}, at most {float(ratio.max()):.2f}x]")
    print(f"  {name}: max_abs_err={max_err:.3e} tolerance=atol {atol_shown:.4g} + rtol {rtol:g}*|ref| "
          f"{'ok' if ok else 'FAIL'}{extra}", flush=True)
    if not ok:
        raise SystemExit(f"{name} disagrees with its plain version")
    return max_err


def eager_ms(fn, iters=50, warmup=5) -> float:
    """Mean time of one eager call, by CUDA events around ``iters`` calls.
    Where a call's kernel is shorter than its host-side enqueue, this
    measures the host, not the card."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, calls=20, replays=10, warmup=3) -> float:
    """Mean device time of one call with the host out of the loop: ``calls``
    calls captured into one CUDA graph, the graph replayed ``replays``
    times between two events. A call that cannot be captured raises."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up (builds, allocator) off the capture
        for _ in range(warmup):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / (replays * calls)
    del graph
    torch.cuda.synchronize()
    return ms


def timings(fn, calls=20, eager_iters=50) -> dict:
    """Graph-replayed ms (the number every comparison uses) and eager ms."""
    return {"graph": graph_ms(fn, calls=calls), "eager": eager_ms(fn, iters=eager_iters)}


COLD_BYTES = 72e6  # rotated input copies per cold timing: more than the 50 MB L2


def cold_ms(fn, make_copy, nbytes: int) -> dict:
    """Graph-replayed ms of ``fn(*inputs)`` with the inputs cold in L2:
    copies from ``make_copy()`` (>= 8 of them, > COLD_BYTES in all), one per
    captured call in turn, so a copy is reused only after the others have
    passed through the cache."""
    import itertools

    n = max(8, -(-int(COLD_BYTES) // nbytes))
    copies = [make_copy() for _ in range(n)]
    it = itertools.cycle(copies)
    ms = graph_ms(lambda: fn(*next(it)), calls=n, replays=5)
    return {"ms": ms, "copies": n, "bytes_per_copy": nbytes}


def bound(bytes_moved: float, ops: float, dtype: str):
    t_bytes = bytes_moved / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def zipf_ids(rng, n, vocab, offset, a=1.2):
    """Rank-skewed ids with a fixed per-slot shift (the bench's stream)."""
    raw = rng.zipf(a, n).astype(np.uint64)
    return (raw + np.uint64(offset)) % np.uint64(vocab)


def zipf_batch_maker(seed, labels=False, dense_scale=1.0):
    """The bench's batches: zipf ids per slot, normal dense features (times
    ``dense_scale``) and, for training, 0/1 labels."""
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)
    offsets = rng.integers(0, VOCAB, N_SLOTS, dtype=np.uint64)

    def make():
        ids = [
            IDTypeFeatureWithSingleID(f"cat_{i}", zipf_ids(rng, BATCH, VOCAB, offsets[i]))
            for i in range(N_SLOTS)
        ]
        dense = (dense_scale * rng.normal(size=(BATCH, N_DENSE))).astype(np.float32)
        if not labels:
            return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(dense)], requires_grad=False)
        y = [Label(rng.integers(0, 2, (BATCH, 1)).astype(np.float32))]
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(dense)], labels=y, requires_grad=True)

    return make


def device_busy_ms(step, batches):
    """Kernel time per call of ``step`` summed by torch.profiler over the
    device's own events (kernels and copies; user annotations such as the
    optimizer's range, which span kernels, are left out), the largest
    ones (names cut to 80 chars), and how many times each of the port's
    kernels (``KERNEL_NAMES``) ran in all: the device's own count, which a
    CUDA graph's replays (which go through no wrapper) also show; under
    "elementwise", the runs of PyTorch's elementwise kernels; under
    "replays", one entry a ``cudaGraphLaunch`` in the trace: the runs of
    each of those kernels that carry its correlation id, and under
    "events" all its device events."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step(b)
        torch.cuda.synchronize()
    per = {}
    runs = dict.fromkeys(KERNEL_NAMES + ("elementwise",), 0)
    replays = {e.id: dict.fromkeys(KERNEL_NAMES + ("events",), 0) for e in prof.events()
               if e.device_type == DeviceType.CPU and e.name.startswith("cudaGraphLaunch")}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False):
            continue
        per[e.name[:80]] = per.get(e.name[:80], 0.0) + e.time_range.elapsed_us() / 1e3 / len(batches)
        replay = replays.get(e.id)
        if replay is not None:
            replay["events"] += 1
        for k in KERNEL_NAMES:
            if re.search(rf"\b{k}\b", e.name):
                runs[k] += 1
                if replay is not None:
                    replay[k] += 1
        runs["elementwise"] += "elementwise_kernel" in e.name
    runs["replays"] = list(replays.values())
    if not sum(per.values()):
        return None, {}, runs
    top = dict(sorted(per.items(), key=lambda kv: -kv[1])[:8])
    return sum(per.values()), top, runs


def kernel_trace(fn, calls=20, tries=3):
    """``device_busy_ms`` over ``calls`` calls of ``fn`` (a call that may
    run again and again, as a timing loop runs it): a session whose trace
    holds no device record is taken again, ``tries`` sessions at most
    (torch.profiler on the card has now and then dropped a whole session's
    device events, while the next session held them); returns (top, runs,
    the sessions taken)."""
    for n in range(1, tries + 1):
        _, top, runs = device_busy_ms(lambda _: fn(), [None] * calls)
        if top:
            break
    return top, runs, n


KERNEL_NAMES = ("fa_fwd_wgmma_kernel", "fa_fwd_tf32x3_kernel", "tf32_split_kernel",
                "dot_interaction_mma_kernel", "dot_interaction_kernel",
                "dot_interaction_bwd_mma_kernel", "dot_interaction_bwd_kernel",
                "gather_pool_fwd_kernel", "segment_sum_chunks_kernel", "segment_sum_rows_kernel",
                "fused_gather_kernel", "update_keys_kernel", "sparse_update_segments_kernel",
                "sparse_update_long_kernel", "sparse_update_short_kernel",
                "raw_gather_fwd_kernel", "raw_gather_bwd_kernel", "attention_pool_fwd_kernel",
                "attention_pool_bwd_kernel", "batch_norm_fwd_kernel", "batch_norm_bwd_kernel",
                "cache_aux_kernel", "entry_rows_kernel", "quantize_int8_ef_kernel", "segment_absmax_kernel",
                "quantize_int8_shared_kernel",
                "block_int8_quantize_warp_kernel", "block_int8_quantize_kernel", "block_int8_dequantize_vec_kernel",
                "block_int8_dequantize_kernel", "lp_ring_mix_kernel")
# the dense ring's kernels (K16 and the fused hop on the warp and the block
# plan, K17 on the vector and the scalar plan)
SYNC_KERNEL_NAMES = ("block_int8_quantize_warp_kernel", "block_int8_quantize_kernel",
                     "block_int8_dequantize_vec_kernel", "block_int8_dequantize_kernel")
# their templates on the ring's path at 256-element blocks: K16 and the
# fused hop (V = 2: two float4 and an 8-byte code store a lane), K17's
# vector plan
SYNC_WIDE = ("block_int8_quantize_warp_kernel<2,false>", "block_int8_quantize_warp_kernel<2,true>",
             "block_int8_dequantize_vec_kernel")
# the DIN path's kernels (K6-K9) and K2's two passes
DIN_KERNEL_NAMES = ("raw_gather_fwd_kernel", "raw_gather_bwd_kernel", "attention_pool_fwd_kernel",
                    "attention_pool_bwd_kernel")
K2_KERNEL_NAMES = ("segment_sum_chunks_kernel", "segment_sum_rows_kernel")
# K12 and its read alone at their 16-byte templates on an f32 pool (the
# bench's widths: bf16 wires, and the flush's f32 read)
K12_WIDE = ("cache_aux_kernel<8,false>", "entry_rows_kernel<4,false>")
# K15 at the ps-stream path's template: bf16 gradients, 8-element units
K15_WIDE = "quantize_int8_ef_kernel<bf16,8>"
# K15's dense-sync modes, flat, at the bytegrad path's templates (f32
# gradients, 8-element units; the codes as int32)
FLAT_KERNEL_NAMES = ("segment_absmax_kernel", "quantize_int8_shared_kernel")
FLAT_WIDE = {"segment_absmax_kernel<f32,8>": ("LDG.128",),
             "quantize_int8_shared_kernel<f32,8>": ("LDG.128", "STG.128")}
# K18 at LowPrecisionDecentralized's template (4-element units: a float4 of
# x and each shadow, read and written)
LP_WIDE = "lp_ring_mix_kernel<4>"
# K5's kernels, and the routing's: on the dim-16 f32 path none may spill
K5_KERNELS = ("sparse_update_segments_kernel", "sparse_update_long_kernel", "sparse_update_short_kernel")
K5_DIM16 = ("sparse_update_segments_kernel", "sparse_update_long_kernel<f32,4>",
            "sparse_update_short_kernel<f32,4,1>", "update_keys_kernel")
# SASS counted per kernel: Hopper's matrix and TMA instructions, and the
# 16-byte global loads and stores (and the shuffles) of the gather-pool
SASS_OPS = {"HGMMA": r"\bHGMMA\b", "UTMALDG": r"\bUTMALDG\b", "UTMASTG": r"\bUTMASTG\b",
            "HMMA": r"\bHMMA\b", "LDG.128": r"\bLDG\.E\.128\b", "STG.128": r"\bSTG\.E\.128\b",
            "STG.64": r"\bSTG\.E\.64\b", "SHFL": r"\bSHFL\."}
DOT_REPLACES = "persia_tpu/models/dlrm.py:50"
POOL_REPLACES = "persia_tpu/parallel/train_step.py:81"


def _template_arg(t) -> str:
    tok = t.group(0)
    if tok.startswith("13"):
        return "bf16"
    if t.group(1):
        return t.group(1)
    if t.group(2):
        return "true" if t.group(2) == "1" else "false"
    if t.group(3):
        return f"uint{t.group(3)}"
    return {"f": "f32", "j": "u32", "t": "u16"}.get(tok, "same")  # S<n>_: a type repeated


def kernel_label(mangled: str):
    """'fa_fwd_wgmma_kernel<64>' from a mangled kernel name (a kernel that
    is no template: its name alone), or None."""
    for name in KERNEL_NAMES:
        if name + "I" in mangled:
            args = mangled.split(name + "I", 1)[1].split("EEv", 1)[0]
            tokens = re.finditer(r"13__nv_bfloat16|Li(\d+)E|Lb([01])E|5uint([24])|S\d*_|f|j|t", args)
            return f"{name}<{','.join(map(_template_arg, tokens)) or args}>"
    for name in KERNEL_NAMES:
        if f"{len(name)}{name}" in mangled:
            return name
    return None


def build_summary(build_log: str, library) -> dict:
    """Per kernel: ptxas registers, static shared memory and spill bytes
    (from the build's -Xptxas -v), and counts of the instructions of
    SASS_OPS in its SASS (cuobjdump -sass on the built library)."""
    out, current = {}, None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            current = kernel_label(m.group(1))
            if current:
                out[current] = {}
            continue
        if current is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            out[current]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m:
            out[current]["registers"] = int(m.group(1))
            out[current]["static_smem_bytes"] = int(m.group(2) or 0)
    sass = subprocess.run(["cuobjdump", "-sass", str(library)], capture_output=True, text=True,
                          timeout=120, check=True).stdout
    current = None
    for line in sass.splitlines():
        if "Function :" in line:
            current = kernel_label(line.split("Function :", 1)[1].strip())
            continue
        if current:
            for op, pattern in SASS_OPS.items():
                if re.search(pattern, line):
                    counts = out.setdefault(current, {}).setdefault("sass", {})
                    counts[op] = counts.get(op, 0) + 1
    return out


def phase_build():
    from persia_tpu_torch.ops import _kernels

    print("== phase 1: build", flush=True)
    t0 = time.perf_counter()
    _kernels.library()
    print(f"  built {_kernels.library_path().name} in {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_kernels.build_seconds:.1f} s)", flush=True)
    if not _kernels.build_log:
        print("  (library built before this run: no ptxas report, SASS counts only)", flush=True)
    summary = build_summary(_kernels.build_log, _kernels.library_path())
    for name, info in summary.items():
        print(f"  {name}: {json.dumps(info)}", flush=True)
    for kernel in ("fa_fwd_wgmma_kernel<64>", "fa_fwd_tf32x3_kernel<64>"):
        fa = summary.get(kernel, {}).get("sass", {})
        if not (fa.get("HGMMA") and fa.get("UTMALDG")):
            raise SystemExit(f"{kernel}'s SASS lacks HGMMA or UTMALDG: {fa}")
    k12 = {k: {"registers": v.get("registers"), "spill_bytes": v.get("spill_bytes"),
               **{op: v.get("sass", {}).get(op, 0) for op in ("LDG.128", "STG.128")}}
           for k, v in summary.items() if k.startswith(("cache_aux_kernel<", "entry_rows_kernel<"))}
    print(f"  K12 and its read alone by template: {json.dumps(k12)}", flush=True)
    wide = {k: k12.get(k, {}) for k in K12_WIDE}
    if not all(v.get("LDG.128") and v.get("STG.128") for v in wide.values()):
        raise SystemExit(f"K12 or its read lacks 16-byte loads or stores at its 16-byte template: {wide}")
    spills = {k: v["spill_bytes"] for k, v in summary.items()
              if k.startswith("fa_fwd_tf32x3_kernel") and v.get("spill_bytes")}
    if spills:
        raise SystemExit(f"the f32 flash-attention kernel spills: {spills}")
    if _kernels.build_log:
        din = {k: v for k, v in summary.items() if k.split("<")[0] in DIN_KERNEL_NAMES}
        print(f"  K6-K9 (raw gather and its scatter-add, attention pool): {json.dumps(din)}", flush=True)
        k2 = {k: v for k, v in summary.items() if k.split("<")[0] in K2_KERNEL_NAMES}
        print(f"  K2 (the gather-pool's two-pass segment sum): {json.dumps(k2)}", flush=True)
        missing = [n for n in DIN_KERNEL_NAMES + K2_KERNEL_NAMES if not any(k.split("<")[0] == n for k in summary)]
        if missing:
            raise SystemExit(f"the build reported nothing for {missing}")
        k9 = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
              if k.startswith("attention_pool_bwd_kernel<")}
        print(f"  K9 by template (registers, spill bytes): {k9}", flush=True)
        k4 = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
              if k.startswith("fused_gather_kernel<")}
        print(f"  K4 by vector (registers, spill bytes): {k4}", flush=True)
        din_path = {f"{n}<{t}>": summary.get(f"{n}<{t}>", {}).get("spill_bytes")
                    for n in ("attention_pool_fwd_kernel", "attention_pool_bwd_kernel")
                    for t in (ATT_DIN_TEMPLATE, "f32,4,2")}
        print(f"  K8 and K9 on the DIN path, spill bytes: {din_path}", flush=True)
        if any(v is None or v for v in din_path.values()):
            raise SystemExit(f"K8 or K9 spills on the DIN path or was not reported: {din_path}")
        bn = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
              if k.startswith(("batch_norm_fwd_kernel<", "batch_norm_bwd_kernel<"))}
        print(f"  K10 and K11 by template (registers, spill bytes): {bn}", flush=True)
        if not {"batch_norm_fwd_kernel<bf16,8>", "batch_norm_bwd_kernel<bf16,8>"} <= set(bn):
            raise SystemExit(f"the build reported nothing for K10 or K11 at the DNN path's template: {bn}")
        k15 = {k: {"registers": v.get("registers"), "spill_bytes": v.get("spill_bytes"),
                   **{op: v.get("sass", {}).get(op, 0) for op in ("LDG.128", "STG.64", "STG.128")}}
               for k, v in summary.items() if k.startswith("quantize_int8_ef_kernel<")}
        print(f"  K15 by input dtype and unit (registers, spill bytes, 16- and 8-byte accesses): "
              f"{json.dumps(k15)}", flush=True)
        wide = k15.get(K15_WIDE, {})
        if not all(wide.get(op) for op in ("LDG.128", "STG.64", "STG.128")) or any(
                v["spill_bytes"] is None or v["spill_bytes"] for v in k15.values()):
            raise SystemExit(f"K15 spills, or was not reported or lacks its 16-byte loads, 8-byte code stores "
                             f"and 16-byte residual stores at the ps-stream path's template {K15_WIDE}: {k15}")
        flat = {k: {"registers": v.get("registers"), "spill_bytes": v.get("spill_bytes"),
                    **{op: v.get("sass", {}).get(op, 0) for op in ("LDG.128", "STG.64", "STG.128")}}
                for k, v in summary.items() if k.split("<")[0] in FLAT_KERNEL_NAMES}
        print(f"  K15's dense-sync modes, flat (registers, spill bytes, 16- and 8-byte accesses): {json.dumps(flat)}",
              flush=True)
        if any(v["spill_bytes"] is None or v["spill_bytes"] for v in flat.values()) or not all(
                flat.get(k, {}).get(op) for k, ops in FLAT_WIDE.items() for op in ops):
            raise SystemExit(f"K15's flat dense-sync modes spill, or were not reported or lack their 16-byte loads "
                             f"and stores on the bytegrad path's templates {list(FLAT_WIDE)}: {flat}")
        k16 = {k: (v.get("registers"), v.get("spill_bytes")) for k, v in summary.items()
               if k.split("<")[0] in SYNC_KERNEL_NAMES}
        print(f"  K16, the fused hop and K17 (the dense ring's block int8; registers, spill bytes): {k16}",
              flush=True)
        if {k.split("<")[0] for k in k16} != set(SYNC_KERNEL_NAMES) or any(v[1] for v in k16.values()):
            raise SystemExit(f"K16, the fused hop or K17 spills or was not reported: {k16}")
        wide = {k: {op: summary.get(k, {}).get("sass", {}).get(op, 0)
                    for op in ("LDG.128", "STG.64", "STG.128", "SHFL")} for k in SYNC_WIDE}
        print(f"  K16, the fused hop and K17 on the ring's path, 16- and 8-byte accesses and shuffles: "
              f"{json.dumps(wide)}", flush=True)
        if not all(v["LDG.128"] and v["STG.128"] for v in wide.values()) or not all(
                wide[k]["STG.64"] and wide[k]["SHFL"] for k in SYNC_WIDE[:2]):
            raise SystemExit(f"K16, the fused hop or K17 lacks its 16-byte loads and stores, 8-byte code stores or "
                             f"shuffles on the ring's path: {wide}")
        lp = {k: {"registers": v.get("registers"), "spill_bytes": v.get("spill_bytes"),
                  **{op: v.get("sass", {}).get(op, 0) for op in ("LDG.128", "STG.128")}}
              for k, v in summary.items() if k.startswith("lp_ring_mix_kernel<")}
        print(f"  K18 by unit (registers, spill bytes, 16-byte accesses): {json.dumps(lp)}", flush=True)
        if len(lp) != 2 or any(v["spill_bytes"] is None or v["spill_bytes"] for v in lp.values()) or not (
                lp.get(LP_WIDE, {}).get("LDG.128") and lp.get(LP_WIDE, {}).get("STG.128")):
            raise SystemExit(f"K18 spills, or was not reported or lacks its 16-byte loads and stores at {LP_WIDE}: "
                             f"{lp}")
        k5 = {k: summary.get(k, {}).get("spill_bytes") for k in K5_DIM16}
        print(f"  K5 and the routing on the dim-16 path, spill bytes: {k5}", flush=True)
        if any(v is None or v for v in k5.values()):
            raise SystemExit(f"K5's dim-16 path spills or was not reported: {k5}")
    return summary


def phase_flash_attention(dev):
    import torch

    from persia_tpu_torch.ops import flash_attention, tf32_split_planes
    from persia_tpu_torch.ops.flash_attention import (
        reference_attention, route_tolerance, tf32_split_planes_reference,
    )

    print("== phase 2: flash_attention vs reference_attention", flush=True)
    # tolerances and their reasons: ops/flash_attention.py::route_tolerance
    dtypes = (torch.bfloat16, torch.float32)
    cases = [
        ((4, 1024, 8, 64), dtype, causal) for dtype in dtypes for causal in (False, True)
    ] + [
        ((4, 1000, 8, 64), dtype, True) for dtype in dtypes
    ] + [
        ((2, 1000, 4, d), dtype, causal)
        for d in (16, 32, 128) for dtype in dtypes for causal in (False, True)
    ]
    g = torch.Generator(device="cpu").manual_seed(SEED)
    errs = {}
    # the f32 route's pre-pass: its planes equal the plain version's bit
    # for bit (the rounding is cvt.rna.tf32's)
    for shape in ((4, 1024, 8, 64), (2, 1000, 4, 16), (2, 1000, 4, 128)):
        q, k, v = (torch.randn(shape, generator=g).to(dev) for _ in range(3))
        planes = tf32_split_planes(q, k, v)
        torch.cuda.synchronize()
        ref = tf32_split_planes_reference(q, k, v)
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32)) for a, b in zip(planes, ref))
        err = max(float((a - b).abs().max()) for a, b in zip(planes, ref))
        print(f"  tf32_split_planes{list(shape)}: bitwise {'ok' if same else 'FAIL'} "
              f"(max_abs_err={err:.3e})", flush=True)
        if not same:
            raise SystemExit("tf32_split_planes disagrees with its plain version")
        errs.setdefault("tf32_split_planes", err)
    for shape, dtype, causal in cases:
        q, k, v = (torch.randn(shape, generator=g).to(dev, dtype) for _ in range(3))
        out = flash_attention(q, k, v, causal=causal)
        torch.cuda.synchronize()
        ref = reference_attention(q, k, v, causal=causal)
        name = f"flash_attention{list(shape)} {str(dtype)[6:]} causal={causal}"
        # reported beside it: bf16 held without the P-rounding term of its atol
        base = (2 ** -7, 1e-3) if dtype == torch.bfloat16 else None
        errs[(shape, dtype, causal)] = check_close(name, out, ref, *route_tolerance(v), base=base)
    return {"bf16": errs[((4, 1024, 8, 64), torch.bfloat16, False)],
            "f32": errs[((4, 1024, 8, 64), torch.float32, False)],
            "tf32_split_planes": errs["tf32_split_planes"]}


def pool_ids(rng, batch, L, d, ids):
    """(batch, L) row ids in [0, d): "clipped", zipf(1.2) ranks clipped at
    d - 1 (a pile on the last row); "zipf", the
    ranks mod d (the hottest row ~18 % of the positions); "one_row", every
    id on row 0; "edge", row 0 takes exactly 64 positions and row 1 the
    next 128, so both end on an edge of 64-position chunks (the rest zipf)."""
    z = rng.zipf(1.2, (batch, L)) - 1
    if ids == "clipped":
        return np.minimum(z, d - 1)
    if ids == "zipf":
        return z % d
    if ids == "one_row":
        return np.zeros((batch, L), np.int64)
    flat = np.concatenate([np.zeros(64), np.ones(128), 2 + z.reshape(-1)[192:] % (d - 2)])
    return rng.permutation(flat).reshape(batch, L).astype(np.int64)


def pool_inputs(dev, dtype, batch, specs, seed, dim=EMB_DIM, ids="clipped"):
    """A group of device-pooled slots as the staging gives them: rows padded
    to one P with zero rows past D, pads indexing row D, the CSR. ``specs``
    is [(distinct D, ids per sample L, counts?)]; ``ids`` as pool_ids."""
    import torch

    from persia_tpu_torch.ops import PoolSlot
    from persia_tpu_torch.ops.embedding_pool import pool_csr

    rng = np.random.default_rng(seed)
    p = max(d for d, _, _ in specs) + 1
    rows, slots = [], []
    for d, L, with_counts in specs:
        r = np.zeros((p, dim), np.float32)
        r[:d] = rng.standard_normal((d, dim))
        counts = rng.integers(0 if L > 1 else 1, L + 1, batch).astype(np.int32)
        index = np.full((batch, L), d, np.int32)
        keep = np.arange(L)[None, :] < counts[:, None]
        index[keep] = pool_ids(rng, batch, L, d, ids)[keep]
        order, offsets = pool_csr(index, p)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        rows.append(t(r).to(dtype))
        slots.append(PoolSlot(t(index), t(counts.reshape(-1, 1)) if with_counts else None,
                              t(order), t(offsets)))
    return rows, slots


def pool_schedule_bits(grad, slots, num_rows, dim):
    """What the backward kernel must give for slots without counts, by
    ``plans.pool_bwd_model`` (its f32 sums in its own order): a list of
    (P, dim) f32 arrays."""
    from persia_tpu_torch.ops import plans

    out = []
    g = grad.cpu().numpy()
    for s, slot in enumerate(slots):
        index = slot.index.cpu().numpy()
        order = slot.order.cpu().numpy()
        L = index.shape[1]
        plan = plans.pool_plan(index.shape[0], 1, dim, 4, num_rows, L)
        out.append(plans.pool_bwd_model(g[order // L, s], index.reshape(-1)[order], num_rows, plan))
    return out


def phase_kernels(dev):
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.dot_interaction import (
        dot_interaction_bwd_reference, dot_interaction_reference,
    )
    from persia_tpu_torch.ops.embedding_pool import (
        gather_pool_bwd_reference, gather_pool_fwd_reference,
    )

    print("== phase 3: DLRM kernels vs their plain versions", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 1)
    bench = (BATCH, N_SLOTS + 1, EMB_DIM)
    errs = {}
    # bf16 (tensor cores): f32 sums in the tensor cores' order, one bf16
    # rounding each side (<= 1 ulp apart); f32 (FMA walk): the same f32 sum
    for dtype, tol in ((torch.bfloat16, (2 ** -7, 1e-3)), (torch.float32, (1e-5, 1e-5))):
        x = torch.randn(bench, generator=g).to(dev, dtype)
        out = ops.dot_interaction(x)
        torch.cuda.synchronize()
        errs[("dot", dtype)] = check_close(f"dot_interaction{list(x.shape)} {str(dtype)[6:]}", out,
                                           dot_interaction_reference(x), *tol)
    # backward: bf16 rounds two f32 sums of ~n terms once (atol for the
    # sums near 0); f32 differs in summation order only. Edge shapes: n not
    # a multiple of 8 on the tensor cores, d=24 on the FMA walk
    for shape, dtype, tol in (
        (bench, torch.bfloat16, (2 ** -7, 1e-2)), (bench, torch.float32, (1e-5, 1e-5)),
        ((333, 13, 16), torch.bfloat16, (2 ** -7, 1e-2)), ((100, 27, 24), torch.bfloat16, (2 ** -7, 1e-2)),
        ((77, 32, 64), torch.float32, (1e-5, 1e-5)),
    ):
        b, n, d = shape
        x = torch.randn(shape, generator=g).to(dev, dtype)
        gr = torch.randn((b, n * (n - 1) // 2), generator=g).to(dev, dtype)
        out = ops.dot_interaction_bwd(x, gr)
        torch.cuda.synchronize()
        err = check_close(f"dot_interaction_bwd{list(shape)} {str(dtype)[6:]}", out,
                          dot_interaction_bwd_reference(x, gr), *tol)
        errs.setdefault(("dot_bwd", dtype), err)
    # gather-pool: the forward sums the same f32 values in l order on both
    # sides. The backward sums a row's n terms in its own fixed order,
    # index_add_ in the order of its atomics: each f32 sum is within (n-1) u
    # sum|x| of the exact one (u = 2^-24), so the two within twice that, per
    # element (hot zipf rows hold hundreds of terms); bf16 then rounds each
    # once. Cases without counts are also held bit for bit to the kernel's
    # own order (plans.pool_bwd_model), and the zipf ones to a second call
    cases = [
        ("bench", torch.bfloat16, BATCH, [(2000, 1, False)] * N_SLOTS, EMB_DIM, "clipped"),
        ("zipf(1.2) bench", torch.bfloat16, BATCH, [(1500, 1, False)] * N_SLOTS, EMB_DIM, "zipf"),
        ("one row", torch.bfloat16, BATCH, [(1500, 1, False)] * 4, EMB_DIM, "one_row"),
        ("chunk edge", torch.bfloat16, 1000, [(300, 1, False)] * 3, EMB_DIM, "edge"),
        ("L=4 counts", torch.bfloat16, 1000, [(300, 4, True), (50, 4, False), (700, 1, True)], EMB_DIM, "clipped"),
        ("L=4 counts", torch.float32, 1000, [(300, 4, True), (50, 4, False), (700, 1, True)], EMB_DIM, "clipped"),
        ("dim 8", torch.float32, 1000, [(300, 4, True), (50, 1, False)], 8, "zipf"),
        ("dim 24", torch.float32, 777, [(200, 2, True), (30, 1, False)], 24, "zipf"),
        ("dim 10 scalar path", torch.float32, 500, [(60, 1, False), (9, 3, False)], 10, "zipf"),
        ("70 slots", torch.bfloat16, 64, [(20 + s, 1 + s % 3, s % 2 == 0) for s in range(70)], EMB_DIM, "clipped"),
    ]
    for label, dtype, batch, specs, dim, ids in cases:
        rows, slots = pool_inputs(dev, dtype, batch, specs, seed=len(specs), dim=dim, ids=ids)
        out = ops.gather_pool_fwd(rows, slots)
        gr = torch.randn(out.shape, generator=g).to(dev)
        grads = ops.gather_pool_bwd(gr, rows, slots)
        torch.cuda.synchronize()
        name = f"gather_pool {label} {str(dtype)[6:]} B={batch} S={len(specs)} dim={dim}"
        err = check_close(f"{name} fwd", out, gather_pool_fwd_reference(rows, slots), 1e-6, 1e-6)
        errs.setdefault(("pool_fwd", dtype), err)
        ref = gather_pool_bwd_reference(gr, rows, slots)
        abs_sums = gather_pool_bwd_reference(gr.abs(), [r.float() for r in rows], slots)
        order = torch.cat([
            2 * (s.offsets[1:] - s.offsets[:-1]).float()[:, None] * 2 ** -24 * a
            for s, a in zip(slots, abs_sums)
        ])
        tol = (1e-6, order) if dtype == torch.float32 else (2 ** -7, 1e-3 + order)
        err = check_close(f"{name} bwd", torch.cat(grads), torch.cat(ref), *tol)
        errs.setdefault(("pool_bwd", dtype), err)
        if ids in ("clipped", "zipf") and label != "L=4 counts":
            again = ops.gather_pool_bwd(gr, rows, slots)
            same = all(torch.equal(a.view(torch.uint8), b.view(torch.uint8)) for a, b in zip(grads, again))
            print(f"  {name} bwd twice: bitwise {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise SystemExit("gather_pool_bwd is not deterministic")
        if all(s.counts is None for s in slots):
            want = pool_schedule_bits(gr, slots, rows[0].shape[0], dim)
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            same = all(torch.equal(a.cpu().view(bits), torch.from_numpy(w).to(dtype).view(bits))
                       for a, w in zip(grads, want))
            print(f"  {name} bwd vs its schedule (plans.pool_bwd_model): bitwise {'ok' if same else 'FAIL'}",
                  flush=True)
            if not same:
                raise SystemExit("gather_pool_bwd does not follow its schedule")
    return {"dot_interaction": errs[("dot", torch.bfloat16)],
            "dot_interaction_bwd": errs[("dot_bwd", torch.bfloat16)],
            "gather_pool_fwd": errs[("pool_fwd", torch.bfloat16)],
            "gather_pool_bwd": errs[("pool_bwd", torch.bfloat16)]}


def path_flash_attention(dev):
    import torch

    from persia_tpu_torch import ops

    print("== phase 4a: flash-attention path (bf16 and f32, both masks, forward and backward)", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 2)
    qkv = [torch.randn((4, 1024, 8, 64), generator=g).to(dev) for _ in range(3)]
    bf = [x.to(torch.bfloat16) for x in qkv]
    leaves = [[x.clone().requires_grad_(True) for x in group] for group in (bf, qkv) for _ in range(2)]
    ops.reset_launch_counts()
    outs = [ops.flash_attention(*x, causal=c) for x, c in zip(leaves, (False, True, False, True))]
    for o in outs:  # the backward: a dense recompute, no kernel of its own
        o.float().sum().backward()
    torch.cuda.synchronize()
    routes = dict(ops.flash_attention.launches_by_route)
    split = ops.tf32_split_planes.launches
    for o, x in zip(outs, leaves):
        if o.shape != qkv[0].shape or not bool(torch.isfinite(o.float()).all()):
            raise SystemExit("flash_attention path: bad output")
        if o.grad_fn is None or not all(bool(torch.isfinite(t.grad.float()).all()) for t in x):
            raise SystemExit("flash_attention path: no finite q, k, v gradients")
    if routes != {"wgmma_bf16": 2, "tf32x3": 2} or ops.flash_attention.launches != 4 or split != 2:
        raise SystemExit(f"flash_attention path launched {routes} and the pre-pass {split} "
                         f"times, expected each route and the pre-pass twice")
    print(f"  flash_attention launches by route={routes}, tf32_split_planes={split} "
          f"(forward and backward of each)", flush=True)
    # the card's gradients against the CPU port's (both the dense
    # recompute) at a shape the CPU takes quickly, route tolerances
    from persia_tpu_torch.ops.flash_attention import route_tolerance

    grad_err = 0.0
    for dtype in (torch.bfloat16, torch.float32):
        for causal, scale in ((False, None), (True, None), (False, -0.2)):
            host = [torch.randn((2, 256, 2, 64), generator=g).to(dtype) for _ in range(3)]
            grads = []
            for d in (dev, "cpu"):
                x = [t.to(d).requires_grad_(True) for t in host]
                ops.flash_attention(*x, causal=causal, scale=scale).float().square().sum().backward()
                grads.append([t.grad.cpu().float() for t in x])
            rtol, atol = route_tolerance(host[2])
            for a, b in zip(*grads):
                grad_err = max(grad_err, check_close(
                    f"flash_attention dq/dk/dv [2, 256, 2, 64] {str(dtype)[6:]} causal={causal} "
                    f"scale={scale}, card vs cpu", a, b, rtol, atol))
    return {**routes, "tf32_split_planes": split, "grad_max_abs_err_vs_cpu": grad_err}


def make_store(backend, **kw):
    """A store of ``backend``; for "native", fail unless the C++ core and
    the native worker core both serve (no numpy fallback)."""
    from persia_tpu_torch.embedding import native_worker
    from persia_tpu_torch.embedding.native_store import create_store, store_backend_name

    store = create_store(backend, **kw)
    name = store_backend_name(store)
    if backend == "native":
        worker_core = native_worker.available()
        print(f"  store backend={name}, native worker core={worker_core}", flush=True)
        if name != "native" or not worker_core:
            raise SystemExit("the native store or worker core did not build or load")
    return store


def path_serving(dev):
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.data import PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.train_step import build_eval_step
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    print("== phase 4b: serving path (DLRM at bench width, 5 requests of B=4096)", flush=True)
    cfg = bench_cfg()
    make_batch = zipf_batch_maker(SEED)
    warm = [make_batch() for _ in range(WARM_BATCHES)]
    engines, sd = {}, None
    # the card's engine on the native cores; the CPU's on the numpy store
    # (the golden model), warmed alike: the two cores held to each other
    for device, backend in ((dev, "native"), ("cpu", "numpy")):
        store = make_store(backend, capacity=1 << 22, num_internal_shards=64,
                             optimizer=Adagrad(lr=0.05).config, seed=1)
        worker = EmbeddingWorker(cfg, [store], device_pooling=True)
        t0 = time.perf_counter()
        for b in warm:  # admit the stream's hot rows; the tail misses → zeros
            worker.forward_directly(b, train=True)
        print(f"  {backend} store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)
        model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device=device)
        sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
        model.load_state_dict(sd)
        engines[device] = InferenceEngine(InferCtx(model, worker, cfg, device=device), device=device)
    requests = [make_batch().to_bytes() for _ in range(REQUESTS)]

    engine = engines[dev]
    ops.reset_launch_counts()
    latencies, preds = [], []
    t_all = time.perf_counter()
    for raw in requests:
        t = time.perf_counter()
        preds.append(engine.predict_from_bytes(raw))  # ends in a device→host copy
        latencies.append(time.perf_counter() - t)
    wall = time.perf_counter() - t_all
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}

    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=REQUESTS, gather_pool_fwd=REQUESTS)
    if launches != expected or engine.forwards != REQUESTS:
        raise SystemExit(f"serving path: launches {launches}, forwards {engine.forwards}; "
                         f"expected one dot_interaction and one gather_pool_fwd per forward")
    print(f"  launches={launches} forwards={engine.forwards}", flush=True)
    # where a request's time goes: the same requests again, stage by stage,
    # each stage ending in a synchronize (host clock); "forward_stream" is
    # the CUDA-event time between the forward's first and last launch,
    # gaps where the card waits for the host included
    ctx = engine.ctx
    eval_step = build_eval_step(ctx.model)
    stages = {k: [] for k in ("decode", "lookup", "stage_h2d", "forward", "forward_stream", "d2h")}
    device_batches = []
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for raw in requests:
        t0 = time.perf_counter()
        batch = PersiaBatch.from_bytes(raw)
        t1 = time.perf_counter()
        emb_batches = ctx.worker.forward_directly(batch, train=False)
        t2 = time.perf_counter()
        device_batch, _ = ctx.prepare_features(batch, emb_batches)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        device_batches.append(device_batch)
        ev0.record()
        out = eval_step(device_batch)
        ev1.record()
        ev1.synchronize()
        t4 = time.perf_counter()
        out.cpu()
        t5 = time.perf_counter()
        for k, a, b in (("decode", t0, t1), ("lookup", t1, t2), ("stage_h2d", t2, t3),
                        ("forward", t3, t4), ("d2h", t4, t5)):
            stages[k].append((b - a) * 1e3)
        stages["forward_stream"].append(ev0.elapsed_time(ev1))
    busy_ms, top_kernels, _ = device_busy_ms(eval_step, device_batches)

    # the same engine on the CPU (plain versions); bf16 rounds at other
    # points there, probabilities (sigmoid slope <= 1/4) agree to 2e-2
    err = 0.0
    for raw, p in zip(requests, preds):
        if p.shape != (BATCH, 1) or not np.isfinite(p).all():
            raise SystemExit(f"serving path: bad predictions, shape {p.shape}")
        ref = engines["cpu"].predict_from_bytes(raw)
        err = max(err, float(np.abs(p - ref).max()))
    print(f"  card vs cpu engine: max_abs_err={err:.3e} tolerance=2e-2 "
          f"{'ok' if err <= 2e-2 else 'FAIL'}", flush=True)
    if err > 2e-2:
        raise SystemExit("serving path: card and CPU predictions disagree")

    lat = [x * 1e3 for x in latencies]
    serving = {
        "requests": REQUESTS, "batch": BATCH,
        "latency_ms_p50": float(np.percentile(lat, 50)),
        "latency_ms_p99": float(np.percentile(lat, 99)),
        "latency_ms_all": lat,
        "samples_per_s": REQUESTS * BATCH / wall,
        "pred_max_abs_err_vs_cpu": err,
        "stage_ms_p50": {k: float(np.percentile(v, 50)) for k, v in stages.items()},
        "stage_ms_all": stages,
        # summed kernel time per forward by torch.profiler (None: the
        # profiler saw no device time)
        "forward_device_busy_ms": busy_ms,
        "forward_top_kernels_ms": top_kernels,
    }
    feats_shape = (BATCH, N_SLOTS + 1, EMB_DIM)
    return launches, serving, feats_shape


def bench_cfg():
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    return EmbeddingConfig(
        slots_config={f"cat_{i}": SlotConfig(dim=EMB_DIM) for i in range(N_SLOTS)},
        feature_index_prefix_bit=8,
    )


def bench_train_ctx(device, backend, warm, sd=None, store=None):
    """The bench's training ctx (bf16 wire, Adagrad(0.05), Adam(1e-3)) over
    one store of ``backend`` (capacity 2^25, 64 internal shards; or over
    ``store``), warmed by admitting lookups of ``warm``; returns (ctx,
    store, weights)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = bench_cfg()
    if store is None:
        store = make_store(backend, capacity=1 << 25, num_internal_shards=64,
                           optimizer=Adagrad(lr=0.05).config, seed=1)
    worker = EmbeddingWorker(cfg, [store], device_pooling=True)
    for b in warm:  # admit the stream's hot rows, as the serving path does
        worker.forward_directly(b, train=True)
    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05),
                   worker, cfg, device=device, wire_dtype="bfloat16").__enter__()
    return ctx, store, sd


def batch_keys(batches, cfg=None):
    """The table keys (signs) of ``batches``' ids (under ``cfg``, the
    bench's by default), sorted and distinct."""
    from persia_tpu_torch.embedding.worker import preprocess_batch

    cfg = cfg or bench_cfg()
    return np.unique(np.concatenate([s.keys for b in batches for s in preprocess_batch(b.id_type_features, cfg)]))


def entries_of(store, signs):
    """{sign: whole entry} for the signs present in ``store``."""
    out = {}
    for sign in signs.tolist():
        e = store.get_embedding_entry(sign)
        if e is not None:
            out[sign] = e.copy()
    return out


def path_training(dev):
    """Phase 4c: ``TrainCtx.train_step`` at bench width on the card, over
    the native store and worker cores."""
    import torch

    from persia_tpu_torch import ops

    print(f"== phase 4c: training path (DLRM at bench width, B={BATCH}, TrainCtx.train_step)", flush=True)
    make_batch = zipf_batch_maker(SEED + 10, labels=True)
    warm = [make_batch() for _ in range(WARM_BATCHES)]
    batches = [make_batch() for _ in range(TRAIN_WARMUP + TRAIN_STEPS + TRAIN_STAGED + 2)]

    t0 = time.perf_counter()
    ctx, store, sd = bench_train_ctx(dev, "native", warm)
    print(f"  store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows "
          f"in {time.perf_counter() - t0:.2f} s", flush=True)
    worker = ctx.worker

    def checked_step(batch):
        m = ctx.train_step(batch)
        if not np.isfinite(m["loss"]) or worker.staleness != 0:
            raise SystemExit(f"training path: loss {m['loss']}, staleness {worker.staleness}")
        return m["loss"]

    losses = [checked_step(b) for b in batches[:TRAIN_WARMUP]]
    ops.reset_launch_counts()
    step_ms = []
    for i, b in enumerate(batches[TRAIN_WARMUP:TRAIN_WARMUP + TRAIN_STEPS]):
        t = time.perf_counter()
        losses.append(checked_step(b))  # ends in the gradients' copy to the host and the update
        step_ms.append((time.perf_counter() - t) * 1e3)
        if len(losses) == TRAIN_CPU_STEPS:  # the PS rows after the steps the CPU repeats (untimed)
            snapshot = entries_of(store, batch_keys(warm + batches[:TRAIN_CPU_STEPS]))
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=TRAIN_STEPS, dot_interaction_bwd=TRAIN_STEPS,
                    gather_pool_fwd=TRAIN_STEPS, gather_pool_bwd=TRAIN_STEPS)
    if launches != expected:
        raise SystemExit(f"training path: launches {launches}, expected {expected}")
    print(f"  launches={launches} over {TRAIN_STEPS} steps; losses {[round(x, 5) for x in losses]}",
          flush=True)
    print(f"  step ms: {[round(x, 2) for x in step_ms]}", flush=True)

    # stage by stage, each stage ending in a synchronize (host clock); the
    # step's device span by CUDA events
    stages = {k: [] for k in ("lookup", "stage_h2d", "step", "step_stream", "grads_d2h", "update")}
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    staged = batches[TRAIN_WARMUP + TRAIN_STEPS:]
    for b in staged[:TRAIN_STAGED]:
        t0 = time.perf_counter()
        ref = worker.put_forward_ids(b)
        emb_batches = worker.forward_batch_id(ref, train=True)
        t1 = time.perf_counter()
        device_batch, counts = ctx.prepare_features(b, emb_batches, csr=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        ev0.record()
        header, gpacked = ctx.run_step(device_batch)
        ev1.record()
        ev1.synchronize()
        t3 = time.perf_counter()
        metrics, emb_grads = ctx.fetch_step_output(header, gpacked, device_batch)
        t4 = time.perf_counter()
        slot_grads = ctx.emb_grads_to_slot_grads(emb_batches, emb_grads, counts)
        worker.update_gradient_batched(ref, slot_grads)
        t5 = time.perf_counter()
        for k, a, c in (("lookup", t0, t1), ("stage_h2d", t1, t2), ("step", t2, t3),
                        ("grads_d2h", t3, t4), ("update", t4, t5)):
            stages[k].append((c - a) * 1e3)
        stages["step_stream"].append(ev0.elapsed_time(ev1))
        losses.append(metrics["loss"])
    # device time of the step alone (these batches' gradients are dropped)
    refs, device_batches = [], []
    for b in staged[TRAIN_STAGED:]:
        refs.append(worker.put_forward_ids(b))
        device_batches.append(ctx.prepare_features(b, worker.forward_batch_id(refs[-1]), csr=True)[0])
    busy_ms, top_kernels, _ = device_busy_ms(ctx.run_step, device_batches)
    for ref in refs:
        worker.abort_gradient(ref)
    if worker.staleness != 0 or not all(np.isfinite(losses)):
        raise SystemExit(f"training path: staleness {worker.staleness}, losses {losses}")

    # the same first steps on the CPU over the numpy store (the golden
    # model): bf16 rounds at other points there
    cpu, cpu_store, _ = bench_train_ctx("cpu", "numpy", warm, sd)
    cpu_losses = [cpu.train_step(b)["loss"] for b in batches[:TRAIN_CPU_STEPS]]
    loss_err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
    print(f"  first {TRAIN_CPU_STEPS} losses card {losses[:TRAIN_CPU_STEPS]} cpu {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance=2e-2 {'ok' if loss_err <= 2e-2 else 'FAIL'}", flush=True)
    cpu_rows = {sign: vec for sh in cpu_store._shards for sign, (_, vec) in sh.entries.items()}
    if set(cpu_rows) != set(snapshot):
        raise SystemExit(f"training path: the card's native store holds {len(snapshot)} of the batches' "
                         f"signs, the CPU's numpy store {len(cpu_rows)}")
    row_err = max(float(np.abs(snapshot[k] - v).max()) for k, v in cpu_rows.items())
    print(f"  PS entries after {TRAIN_CPU_STEPS} steps, card (native store) vs cpu (numpy store), "
          f"{len(cpu_rows)} rows: max_abs_err={row_err:.3e} tolerance=1e-2 "
          f"{'ok' if row_err <= 1e-2 else 'FAIL'}", flush=True)
    if loss_err > 2e-2 or row_err > 1e-2:
        raise SystemExit("training path: card and CPU disagree")

    wall = sum(step_ms) / 1e3
    training = {
        "batch": BATCH, "measured_steps": TRAIN_STEPS, "warmup_steps": TRAIN_WARMUP,
        "store_backend": "native",
        "samples_per_s": TRAIN_STEPS * BATCH / wall,
        "step_ms_mean": wall / TRAIN_STEPS * 1e3,
        "step_ms_max": max(step_ms), "step_ms_all": step_ms,
        "losses": losses,
        "loss_max_abs_err_vs_cpu": loss_err, "ps_entry_max_abs_err_vs_cpu": row_err,
        "stage_ms_p50": {k: float(np.percentile(v, 50)) for k, v in stages.items()},
        "stage_ms_all": stages,
        "step_device_busy_ms": busy_ms,
        "step_top_kernels_ms": top_kernels,
        "store_rows": store.size(),
    }
    # the inputs of the kernels' timing: the last staged step's batch
    return launches, training, device_batches[-1]


def timed_calls(obj, name, sink, cpu_sink, lock=None):
    """Shadow ``obj.name`` (an object's method, or a module's or a class's
    function) with a wrapper that appends each call's ms to ``sink`` and
    the CPU ms its thread spent in it to ``cpu_sink`` (with ``lock``, calls
    run one at a time, the wait for it included); returns the function that
    takes the wrapper away."""
    fn = getattr(obj, name)
    own = name in vars(obj)  # a module's or a class's: put the original back

    def wrapper(*args, **kwargs):
        t, c = time.perf_counter(), time.thread_time()
        try:
            if lock is None:
                return fn(*args, **kwargs)
            with lock:
                return fn(*args, **kwargs)
        finally:
            sink.append((time.perf_counter() - t) * 1e3)
            cpu_sink.append((time.thread_time() - c) * 1e3)

    setattr(obj, name, wrapper)
    return (lambda: setattr(obj, name, fn)) if own else (lambda: delattr(obj, name))


def device_busy_union_ms(fn):
    """Wall ms of ``fn()`` and the ms in it that the card was busy: the
    union of the device's own event intervals (kernels and copies, on any
    stream) by torch.profiler, user annotations left out."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return wall, (busy / 1e3 if spans else None)


def path_pipelined(dev):
    """Phase 4d: the pipelined training path (``DataLoader`` +
    ``train_step_prepared``) at bench width and the bench's settings."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.data_loader import DataLoader

    print(f"== phase 4d: pipelined training (DataLoader num_workers={PIPE_WORKERS}, "
          f"staleness={PIPE_STALENESS}, B={BATCH}, train_step_prepared)", flush=True)
    make_batch = zipf_batch_maker(SEED + 20, labels=True)
    warm = [make_batch() for _ in range(WARM_BATCHES)]
    sync_warm = [make_batch() for _ in range(TRAIN_WARMUP)]
    batches = [make_batch() for _ in range(PIPE_BATCHES + PIPE_PROFILED)]
    sweep = [[make_batch() for _ in range(PIPE_SWEEP_BATCHES)] for _ in PIPE_SWEEP]
    repro = [make_batch() for _ in range(PIPE_REPRO)]
    ctx, store, sd = bench_train_ctx(dev, "native", warm)
    print(f"  store warmed with {WARM_BATCHES} admitting lookups: {store.size()} rows", flush=True)
    for b in sync_warm:
        ctx.train_step(b)

    def run(stream, step_ms=None, workers=PIPE_WORKERS, parts=None):
        """Train the whole stream through a fresh loader; returns it,
        flushed and shut down. ``step_ms`` gets each step's time since the
        previous step ended (the wait for its batch included); ``parts``
        the consumer's wait and step apart."""
        loader = DataLoader(iter(stream), ctx, num_workers=workers, staleness=PIPE_STALENESS)
        t = time.perf_counter()
        it = iter(loader)
        for tb in it:
            got = time.perf_counter()
            ctx.train_step_prepared(tb, loader, fetch_metrics=False)
            now = time.perf_counter()
            if step_ms is not None:
                step_ms.append((now - t) * 1e3)
            if parts is not None:
                parts["wait"].append((got - t) * 1e3)
                parts["step"].append((now - got) * 1e3)
            t = now
        loader.flush()
        loader.shutdown()
        return loader

    ops.reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    loader = run(batches[:PIPE_BATCHES], step_ms)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=PIPE_BATCHES, dot_interaction_bwd=PIPE_BATCHES,
                    gather_pool_fwd=PIPE_BATCHES, gather_pool_bwd=PIPE_BATCHES)
    final = ctx.last_prepared_metrics()
    window = loader.staleness_state()
    print(f"  launches={launches} over {PIPE_BATCHES} batches; final loss {final['loss']:.5f}; "
          f"after flush: staleness {ctx.worker.staleness}, window {window}", flush=True)
    print(f"  step ms: {[round(x, 2) for x in step_ms]}", flush=True)
    if launches != expected:
        raise SystemExit(f"pipelined path: launches {launches}, expected {expected}")
    if not np.isfinite(final["loss"]) or ctx.worker.staleness != 0 or window != {
            "outstanding_gradient_batches": 0, "free_permits": PIPE_STALENESS, "staleness": PIPE_STALENESS}:
        raise SystemExit("pipelined path: non-finite loss, or the staleness window not whole after flush")

    # the card's busy share of the same loop over more batches, profiled
    # apart (the profiler's cost stays out of the numbers above)
    prof_wall, busy = device_busy_union_ms(lambda: run(batches[PIPE_BATCHES:]))
    print(f"  profiled loop of {PIPE_PROFILED} batches: {prof_wall:.1f} ms, card busy {busy} ms", flush=True)

    # where a pipelined batch's time goes, at 1, 2 and 4 lookup threads
    # and in two diagnostic variants (PIPE_SWEEP): the host stages timed
    # inside the loop (lookup and staging on the lookup threads, the update
    # on the gradient threads: wall ms and the CPU ms of the thread in
    # them; the consumer's wait for a batch and its step)
    sweep_out = {}
    for (workers, variant), stream in zip(PIPE_SWEEP, sweep):
        parts = {k: [] for k in ("lookup", "stage", "update", "wait", "step",
                                 "lookup_cpu", "stage_cpu", "update_cpu")}
        restore = [timed_calls(ctx.worker, "forward_batch_id", parts["lookup"], parts["lookup_cpu"]),
                   timed_calls(ctx, "prepare_features", parts["stage"], parts["stage_cpu"],
                               lock=threading.Lock() if variant == "serial_stage" else None),
                   timed_calls(ctx.worker, "update_gradient_batched", parts["update"], parts["update_cpu"])]
        interval = sys.getswitchinterval()
        if variant == "switch_0.5ms":
            sys.setswitchinterval(0.0005)
        try:
            t = time.perf_counter()
            run(stream, workers=workers, parts=parts)
            torch.cuda.synchronize()
            sweep_wall = time.perf_counter() - t
        finally:
            sys.setswitchinterval(interval)
            for undo in restore:
                undo()
        label = f"{workers}" + (f" {variant}" if variant else "")
        sweep_out[label] = {"samples_per_s": len(stream) * BATCH / sweep_wall,
                            **{f"{k}_ms_p50": float(np.percentile(v, 50)) for k, v in parts.items()},
                            "step_ms_max": max(parts["step"]), "wait_ms_max": max(parts["wait"])}
        print(f"  {label} lookup thread(s), {len(stream)} batches: "
              + ", ".join(f"{k} {v:.2f}" for k, v in sweep_out[label].items()), flush=True)

    # reproducible, staleness 1: the loader against train_step on the same
    # batches, from the same weights and an empty native store each
    results = []
    for pipelined in (False, True):
        c, st, _ = bench_train_ctx(dev, "native", [], sd)
        if pipelined:
            ld = DataLoader(iter(repro), c, num_workers=PIPE_WORKERS, staleness=1, reproducible=True)
            losses = [c.train_step_prepared(tb, ld)["loss"] for tb in ld]
            ld.flush()
            ld.shutdown()
        else:
            losses = [c.train_step(b)["loss"] for b in repro]
        results.append((losses, entries_of(st, batch_keys(repro)), st.size()))
    (l_sync, e_sync, n_sync), (l_pipe, e_pipe, n_pipe) = results
    loss_err = max(abs(a - b) for a, b in zip(l_sync, l_pipe))
    same_rows = set(e_sync) == set(e_pipe) and len(e_sync) == n_sync == n_pipe
    row_err = max(float(np.abs(e_sync[k] - e_pipe[k]).max()) for k in e_sync) if same_rows else float("inf")
    ok = same_rows and loss_err <= 1e-5 and row_err <= 1e-5
    print(f"  reproducible staleness=1 loader vs train_step, {PIPE_REPRO} batches: losses max_abs_err="
          f"{loss_err:.3e}, PS entries ({len(e_sync)} rows) max_abs_err={row_err:.3e} tolerance=1e-5 "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("pipelined path: the reproducible loader disagrees with train_step")

    return launches, {
        "batch": BATCH, "batches": PIPE_BATCHES, "num_workers": PIPE_WORKERS,
        "staleness": PIPE_STALENESS, "warmup_sync_steps": TRAIN_WARMUP, "store_backend": "native",
        "samples_per_s": PIPE_BATCHES * BATCH / wall,
        "wall_ms": wall * 1e3, "step_ms_max": max(step_ms),
        "step_ms_p50": float(np.percentile(step_ms, 50)), "step_ms_all": step_ms,
        "final_loss": final["loss"],
        "profiled_batches": PIPE_PROFILED, "profiled_wall_ms": prof_wall, "device_busy_ms": busy,
        "device_busy_share": busy / prof_wall if busy is not None else None,
        "repro_loss_max_abs_err": loss_err, "repro_ps_entry_max_abs_err": row_err,
        "by_lookup_threads": sweep_out,
        "store_rows": store.size(),
    }


def shard_dumps(store):
    return [store.dump_shard(i) for i in range(store.num_internal_shards)]


def dump_entries(dumps) -> dict:
    """{sign: the entry's bytes (dim, len and floats)} of shard dumps."""
    from persia_tpu_torch.checkpoint import iter_shard_entries
    return {s: e[8:] for blob in dumps for s, e in iter_shard_entries(blob)}


def synthetic_shard_blobs(rows, template, seed, chunk=1 << 20):
    """Shard payloads of ``rows`` entries with random signs and values, each
    laid out as ``template`` (an entry of a real dump: its dim and length),
    ``chunk`` entries a payload."""
    rng = np.random.default_rng(seed)
    dim, ln = (int(v) for v in np.frombuffer(template, "<u4", 2, 8))
    entry = np.dtype([("sign", "<u8"), ("dim", "<u4"), ("len", "<u4"), ("data", "<f4", (ln,))])
    for start in range(0, rows, chunk):
        e = np.empty(min(chunk, rows - start), entry)
        e["sign"] = rng.integers(1, 1 << 63, len(e), dtype=np.uint64)
        e["dim"], e["len"] = dim, ln
        e["data"] = rng.random((len(e), ln), dtype=np.float32)
        yield np.uint32(len(e)).tobytes() + e.tobytes()


def dense_diff(a, b) -> str:
    """Where two dense ``TrainState``s differ: each differing parameter or
    Adam state tensor with its largest difference."""
    out = []
    for (name, pa), pb in zip(a.model.named_parameters(), b.model.parameters()):
        pairs = [("", pa, pb)] + [(f".{k}", a.optimizer.state[pa][k], b.optimizer.state[pb][k])
                                  for k in ("exp_avg", "exp_avg_sq", "step")]
        for key, x, y in pairs:
            x, y = x.detach().double().cpu(), y.detach().double().cpu()
            if not (x == y).all():
                out.append(f"{name}{key} {float((x - y).abs().max()):.3e}")
    return "; ".join(out) or "none"


def tree_leaves(tree, prefix=""):
    """(path, dtype name) of a nested dict's leaves, layer numbers as "i"."""
    if isinstance(tree, dict):
        return [leaf for k, v in tree.items() for leaf in tree_leaves(v, f"{prefix}['{k}']")]
    return [(re.sub(r"Dense_\d+", "Dense_i", prefix), None if tree is None else str(tree.dtype))]


def manifest_layout(m):
    """A manifest's layout: its meta keys, its components' names with the
    replica and shard numbers as "r" and "i", and its dense state's leaves."""
    from persia_tpu_torch.serialization import msgpack_restore

    names = {re.sub(r"replica_\d+_shard_\d+", "replica_r_shard_i", n) for n in m.components}
    return sorted(k for k in m.meta if k != "datetime"), names, sorted(set(tree_leaves(
        msgpack_restore(m.read_blob("dense.state")))))


def cross_package(dev, card_manifest):
    """(d): the reference's job directory (the fixture) read by the port on
    the card: every blob's crc, the same layout as the manifest the port
    wrote on the card, its dense state loaded into a DLRM on the card and
    written back to the reference's bytes, its shards restored into native
    stores and dumped back to the reference's bytes."""
    import torch

    from persia_tpu_torch import jobstate
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.train_step import init_train_state
    from persia_tpu_torch.weights import train_state_from_flax_bytes, train_state_to_flax_bytes

    fixture = jobstate.JobStateManager(str(FIXTURE_DIR)).latest()
    if fixture is None:
        raise SystemExit(f"durable state: no manifest in {FIXTURE_DIR}")
    for name in fixture.components:
        fixture.read_blob(name)
    same_layout = manifest_layout(fixture) == manifest_layout(card_manifest)
    raw = fixture.read_blob("dense.state")
    model = DLRM(N_DENSE, FIXTURE_MODEL["num_slots"], EMB_DIM, FIXTURE_MODEL["bottom_mlp"],
                 FIXTURE_MODEL["top_mlp"], device=dev)
    state = init_train_state(model, torch.optim.Adam(model.parameters(), lr=1e-3))
    dense_same = train_state_to_flax_bytes(train_state_from_flax_bytes(state, raw)) == raw
    stores = [make_store("native", capacity=1 << 16, num_internal_shards=4) for _ in range(fixture.meta["ps_replicas"])]
    restored = jobstate.restore_ps(fixture, stores, optimizer=Adagrad(lr=0.1).config)
    shards_same = all(st.dump_shard(i) == fixture.read_blob(f"ps/replica_{r}_shard_{i}.emb")
                      for r, st in enumerate(stores) for i in range(st.num_internal_shards))
    print(f"  (d) the reference's manifest (step {fixture.step}) read on the card: crc ok, layout "
          f"{'same as' if same_layout else 'DIFFERS from'} the port's; dense state written back "
          f"{'byte-equal' if dense_same else 'DIFFERENT'}; {restored} PS entries restored and dumped back "
          f"{'byte-equal' if shards_same else 'DIFFERENT'}", flush=True)
    if not (same_layout and dense_same and shards_same):
        raise SystemExit(f"durable state: the reference's manifest and the port's disagree: "
                         f"{manifest_layout(fixture)} vs {manifest_layout(card_manifest)}")
    return restored


def path_durable(dev):
    """Phase 4f: durable state on the hybrid tier at bench width."""
    from persia_tpu_torch import ops

    print(f"== phase 4f: durable state (TrainCtx at bench width, B={BATCH}, native store: snapshot_job, "
          f"resume, the apply-journal, dump and load)", flush=True)
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    try:
        return durable_cases(dev, ops)
    finally:
        shutil.rmtree(STATE_DIR, ignore_errors=True)


def durable_cases(dev, ops):
    import torch

    from persia_tpu_torch import ctx as ctx_module
    from persia_tpu_torch import jobstate
    from persia_tpu_torch.embedding import worker as worker_module
    from persia_tpu_torch.embedding.hashing import sign_to_shard
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.weights import train_state_to_flax_bytes

    make_batch = zipf_batch_maker(SEED + 30, labels=True)
    batches = [make_batch() for _ in range(DUR_STEPS)]
    cost_batches = [make_batch() for _ in range(JOURNAL_COST_STEPS + TRAIN_WARMUP)]
    job_base, job = STATE_DIR / "job_base", STATE_DIR / "job"

    # (a) the uninterrupted run: a cold resume arms the journal, 12 steps,
    # a snapshot every 4; each snapshot's parts timed
    parts = {k: [] for k in ("ps_capture", "dense_bytes", "commit")}
    undo = [timed_calls(jobstate, "capture_ps", parts["ps_capture"], []),
            timed_calls(ctx_module, "train_state_to_flax_bytes", parts["dense_bytes"], []),
            timed_calls(jobstate.EpochWriter, "commit", parts["commit"], [])]
    snap_ms, snaps = [], []
    try:
        base, base_store, sd = bench_train_ctx(dev, "native", [])
        if base.resume(job_base) is not None:
            raise SystemExit("durable state: a resume on an empty job directory found a manifest")
        for i, b in enumerate(batches):
            base.train_step(b)
            if (i + 1) % DUR_EVERY == 0:
                t = time.perf_counter()
                snaps.append(base.snapshot_job(job_base))
                snap_ms.append((time.perf_counter() - t) * 1e3)
    finally:
        for u in undo:
            u()
    ps_bytes = [m.meta["ps_bytes"] for m in snaps]
    dense_bytes = len(snaps[-1].read_blob("dense.state"))
    print(f"  uninterrupted: {DUR_STEPS} steps, {base_store.size()} PS rows; snapshot ms {snap_ms} "
          f"(PS capture {parts['ps_capture']}, dense bytes {parts['dense_bytes']}, commit {parts['commit']}); "
          f"PS bytes {ps_bytes}, dense bytes {dense_bytes}", flush=True)

    # the crashed run on fresh stores: snapshots at 4 and 8, dies after 9
    # with step 9's gradients applied past the fence
    crash, crash_store, _ = bench_train_ctx(dev, "native", [], sd)
    crash.resume(job)
    for i, b in enumerate(batches[:DUR_KILL]):
        crash.train_step(b)
        if (i + 1) % DUR_EVERY == 0:
            crash.snapshot_job(job)
    del crash  # the trainer dies; its store survives for (b)

    # (a) rewind: fresh stores and ctx, the PS restored from the fence
    rebuilt, rebuilt_store, _ = bench_train_ctx(dev, "native", [], sd)
    t = time.perf_counter()
    m = rebuilt.resume(job, restore_ps=True)
    resume_s = time.perf_counter() - t
    info = rebuilt.last_resume_info
    fence = DUR_EVERY * (DUR_KILL // DUR_EVERY)
    if m is None or m.step != fence:
        raise SystemExit(f"durable state: resumed at {m and m.step}, expected the fence at {fence}")
    ops.reset_launch_counts()
    for b in batches[m.step:]:
        rebuilt.train_step(b)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    replayed = DUR_STEPS - m.step
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=replayed, dot_interaction_bwd=replayed,
                    gather_pool_fwd=replayed, gather_pool_bwd=replayed)
    dense_same = train_state_to_flax_bytes(rebuilt.state) == train_state_to_flax_bytes(base.state)
    base_dumps = shard_dumps(base_store)
    ps_same = shard_dumps(rebuilt_store) == base_dumps
    print(f"  (a) rewind resume from the fence at {m.step}: {info['ps_entries_restored']} PS entries restored, "
          f"resume {resume_s:.4f} s (resume_job {info['time_to_resume_s']} s); replayed {replayed} steps, "
          f"launches={launches}; dense state bytes {'equal' if dense_same else 'DIFFER'} to the uninterrupted "
          f"run's, PS shard dumps ({len(base_dumps)}) {'equal' if ps_same else 'DIFFER'}", flush=True)
    if launches != expected:
        raise SystemExit(f"durable state: launches {launches}, expected {expected}")
    if not (dense_same and ps_same):
        a, b = dump_entries(shard_dumps(rebuilt_store)), dump_entries(base_dumps)
        moved = [k for k in b if a.get(k) != b[k]]
        err = max((float(np.abs(np.frombuffer(a[k][8:], np.float32) - np.frombuffer(b[k][8:], np.float32)).max())
                   for k in moved if k in a and len(a[k]) == len(b[k])), default=0.0)
        raise SystemExit(f"durable state: the resumed run differs from the uninterrupted one: dense "
                         f"{dense_diff(rebuilt.state, base.state)}; PS entries differing {len(moved)} of {len(b)} "
                         f"(max abs err {err:.3e})")
    del rebuilt, rebuilt_store

    # (b) journal resume: the crashed run's store as the crash left it; the
    # replayed window moves no entry, each replayed step skipped
    before = dump_entries(shard_dumps(crash_store))
    jctx, _, _ = bench_train_ctx(dev, "native", [], sd, store=crash_store)
    m = jctx.resume(job, restore_ps=False)
    for b in batches[m.step:DUR_KILL]:
        jctx.train_step(b)
    skips = jctx.worker.lookup_router.journal_skips
    unmoved = dump_entries(shard_dumps(crash_store)) == before
    print(f"  (b) journal resume from the fence at {m.step}: {DUR_KILL - m.step} replayed step(s), "
          f"journal_skips={skips}, PS entries ({len(before)}) {'unmoved' if unmoved else 'MOVED'}", flush=True)
    if not unmoved or skips < DUR_KILL - m.step:
        raise SystemExit("durable state: the journal resume applied a replayed batch again")
    del jctx, crash_store

    # (c) re-shard on load: the uninterrupted run's store dumped as one
    # replica, loaded into two
    ckpt = str(STATE_DIR / "ckpt")
    t = time.perf_counter()
    base.worker.dump(ckpt)
    dump_ms = (time.perf_counter() - t) * 1e3
    two = [make_store("native", capacity=1 << 25, num_internal_shards=64, optimizer=Adagrad(lr=0.05).config,
                      seed=1) for _ in range(2)]
    t = time.perf_counter()
    loaded = EmbeddingWorker(bench_cfg(), two, device_pooling=True).load(ckpt)
    load_ms = (time.perf_counter() - t) * 1e3
    src = dump_entries(base_dumps)
    halves = [dump_entries(shard_dumps(s)) for s in two]
    owned = all((sign_to_shard(np.fromiter(h, np.uint64, len(h)), 2) == r).all() for r, h in enumerate(halves))
    same = loaded == len(src) == len(halves[0]) + len(halves[1]) and {**halves[0], **halves[1]} == src
    print(f"  (c) re-shard on load: dump {dump_ms:.1f} ms, load into 2 replicas {load_ms:.1f} ms, "
          f"{loaded} entries ({len(halves[0])} + {len(halves[1])}); each replica holds its own signs: {owned}; "
          f"entries {'equal' if same else 'DIFFER'}", flush=True)
    if not (owned and same):
        raise SystemExit("durable state: the re-sharded load differs from the dump")
    del two, base, base_store

    # (d) across the packages: the manifest the port wrote here, read back
    # through the port's reader, beside the reference's
    card_manifest = jobstate.JobStateManager(str(job_base)).latest()
    if card_manifest is None or card_manifest.step != DUR_STEPS:
        raise SystemExit("durable state: the port's manifest does not read back")
    for name in card_manifest.components:
        card_manifest.read_blob(name)
    fixture_entries = cross_package(dev, card_manifest)

    fill = durable_at_fill(dev, sd, batches[0], base_dumps)

    # the journal's host cost: phase 4c's step with the journal armed and
    # not, on the same batches, in turns (plain, armed, armed, plain, ...);
    # payload_crc timed on its own in the armed steps
    plain, _, _ = bench_train_ctx(dev, "native", [], sd)
    armed, _, _ = bench_train_ctx(dev, "native", [], sd)
    armed.resume(STATE_DIR / "job_cost")
    for b in cost_batches[:TRAIN_WARMUP]:
        plain.train_step(b)
        armed.train_step(b)
    crc_ms, step_ms = [], {"plain": [], "armed": []}
    undo = timed_calls(worker_module, "payload_crc", crc_ms, [])
    try:
        for i, b in enumerate(cost_batches[TRAIN_WARMUP:]):
            order = (("plain", plain), ("armed", armed)) if i % 2 == 0 else (("armed", armed), ("plain", plain))
            for name, c in order:
                t = time.perf_counter()
                c.train_step(b)
                step_ms[name].append((time.perf_counter() - t) * 1e3)
    finally:
        undo()
    rate = {k: len(v) * BATCH / (sum(v) / 1e3) for k, v in step_ms.items()}
    # each batch's armed step less its plain step: the mean and its standard
    # error say whether the runs resolve the journal's cost
    diff = np.array(step_ms["armed"]) - np.array(step_ms["plain"])
    diff_mean, diff_se = float(diff.mean()), float(diff.std(ddof=1) / np.sqrt(len(diff)))
    print(f"  journal cost ({JOURNAL_COST_STEPS} steps a side): samples/s armed {rate['armed']:.1f}, not armed "
          f"{rate['plain']:.1f}; armed - plain step {diff_mean:.3f} ms (standard error {diff_se:.3f}: "
          f"{'resolved' if abs(diff_mean) > 2 * diff_se else 'not resolved'} at 2 standard errors); "
          f"payload_crc ms mean {np.mean(crc_ms):.3f}, max {max(crc_ms):.3f}", flush=True)
    return launches, {
        "batch": BATCH, "steps": DUR_STEPS, "snapshot_every": DUR_EVERY, "killed_after": DUR_KILL,
        "snapshot_ms": snap_ms, "snapshot_ps_capture_ms": parts["ps_capture"],
        "snapshot_dense_bytes_ms": parts["dense_bytes"], "snapshot_commit_ms": parts["commit"],
        "ps_bytes": ps_bytes, "dense_bytes": dense_bytes,
        "time_to_resume_s": resume_s, "resume_job_s": info["time_to_resume_s"],
        "ps_entries_restored": info["ps_entries_restored"],
        "rewind_dense_bytes_equal": dense_same, "rewind_ps_dumps_equal": ps_same,
        "journal_skips": skips, "journal_replay_unmoved": unmoved,
        "dump_ms": dump_ms, "load_ms": load_ms, "reshard_entries": loaded,
        "samples_per_s_journal_armed": rate["armed"], "samples_per_s_journal_not_armed": rate["plain"],
        "step_ms_armed": step_ms["armed"], "step_ms_not_armed": step_ms["plain"],
        "step_ms_armed_less_plain_mean": diff_mean, "step_ms_armed_less_plain_se": diff_se,
        "payload_crc_ms": crc_ms, "fixture_entries_restored": fixture_entries, "at_fill": fill,
    }


def durable_at_fill(dev, sd, batch, dumps):
    """One snapshot and one rewind resume of the bench store filled with
    ``DUR_FILL_ROWS`` synthetic rows (laid out as the trained rows of
    ``dumps``) and trained one step on ``batch``: each part's ms, ms a MiB of
    PS bytes, and the restored store's dumps and dense bytes equal to the
    snapshotted ones."""
    from persia_tpu_torch import ctx as ctx_module
    from persia_tpu_torch import jobstate
    from persia_tpu_torch.checkpoint import iter_shard_entries
    from persia_tpu_torch.weights import train_state_to_flax_bytes

    job = STATE_DIR / "job_fill"
    template = next(e for blob in dumps for _, e in iter_shard_entries(blob))
    filled, filled_store, _ = bench_train_ctx(dev, "native", [], sd)
    t = time.perf_counter()
    loaded = sum(filled_store.load_shard_bytes(b) for b in synthetic_shard_blobs(DUR_FILL_ROWS, template, SEED + 31))
    fill_s = time.perf_counter() - t
    filled.resume(job)
    filled.train_step(batch)
    rows, capacity = filled_store.size(), 1 << 25
    parts = {k: [] for k in ("ps_capture", "dense_bytes", "commit")}
    undo = [timed_calls(jobstate, "capture_ps", parts["ps_capture"], []),
            timed_calls(ctx_module, "train_state_to_flax_bytes", parts["dense_bytes"], []),
            timed_calls(jobstate.EpochWriter, "commit", parts["commit"], [])]
    try:
        t = time.perf_counter()
        snap = filled.snapshot_job(job)
        snap_ms = (time.perf_counter() - t) * 1e3
    finally:
        for u in undo:
            u()
    ps_mib = snap.meta["ps_bytes"] / 2**20

    rebuilt, rebuilt_store, _ = bench_train_ctx(dev, "native", [], sd)
    t = time.perf_counter()
    m = rebuilt.resume(job, restore_ps=True)
    resume_s = time.perf_counter() - t
    restored = rebuilt.last_resume_info["ps_entries_restored"]
    same = (m.step == snap.step and restored == rows
            and train_state_to_flax_bytes(rebuilt.state) == train_state_to_flax_bytes(filled.state)
            and all(filled_store.dump_shard(i) == rebuilt_store.dump_shard(i)
                    for i in range(filled_store.num_internal_shards)))
    print(f"  at fill: {loaded} synthetic rows loaded in {fill_s:.2f} s, {rows} rows after a step "
          f"({100 * rows / capacity:.1f} % of {capacity}); snapshot {snap_ms:.1f} ms (PS capture "
          f"{parts['ps_capture'][0]:.1f}, dense bytes {parts['dense_bytes'][0]:.1f}, commit {parts['commit'][0]:.1f}) "
          f"for {ps_mib:.1f} MiB of PS bytes, {parts['ps_capture'][0] / ps_mib:.3f} ms a MiB; rewind resume "
          f"{resume_s:.3f} s, {resume_s * 1e3 / ps_mib:.3f} ms a MiB, {restored} entries; dumps and dense bytes "
          f"{'equal' if same else 'DIFFER'}", flush=True)
    if not same:
        raise SystemExit("durable state: the filled store's rewind resume differs from its snapshot")
    return {"rows": rows, "capacity": capacity, "fill_load_s": fill_s, "snapshot_ms": snap_ms,
            "ps_capture_ms": parts["ps_capture"][0], "dense_bytes_ms": parts["dense_bytes"][0],
            "commit_ms": parts["commit"][0], "ps_bytes": snap.meta["ps_bytes"],
            "ps_capture_ms_per_mib": parts["ps_capture"][0] / ps_mib, "time_to_resume_s": resume_s,
            "resume_ms_per_mib": resume_s * 1e3 / ps_mib, "ps_entries_restored": restored}


K4_SOURCE, K4_REPLACES = "persia_tpu_torch/csrc/fused_gather.cu", "persia_tpu/parallel/fused_step.py:242"
K5_SOURCE, K5_REPLACES = "persia_tpu_torch/csrc/sparse_update.cu", "persia_tpu/ops/sparse_update.py:123"
ROUTING_REPLACES = "persia_tpu/parallel/fused_step.py:389"


def same_bits(a, b) -> bool:
    """Bit-for-bit equality of two tensors (NaNs included)."""
    import torch

    a, b = a.detach().reshape(-1), b.detach().reshape(-1)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    return torch.equal(a.cpu().view(torch.uint8), b.cpu().view(torch.uint8))


def fused_ids(rng, kind, n, vocab):
    """n ids in [0, vocab): uniform, zipf(1.2) (rank 1 at id 0) or one row."""
    if kind == "uniform":
        ids = rng.integers(0, vocab, n)
    elif kind == "zipf":
        ids = (rng.zipf(1.2, n) - 1) % vocab
    else:
        ids = np.full(n, vocab // 3)
    return ids.astype(np.int32)


def k5_lengths(n):
    """K5's chosen segment lengths: hot rows (as many positions as zipf(1.2)'s
    hottest rows of a bench slot hold) and the long threshold - 1, at it and
    + 1; segments ending on a staged tile's edge (1 and 2 tiles) and one
    row past it."""
    from persia_tpu_torch.ops import plans

    t, rows = plans.K5_LONG_MIN, plans.sparse_update_plan(n, EMB_DIM).tile_rows
    return {"hot": (762, 318, 180, t + 1, t, t - 1), "tile_edge": (rows, 2 * rows, rows + 1, 3 * rows)}


def k5_ids(rng, kind, n, vocab):
    """n ids for K5's exact check and the positions padding may not take:
    ``fused_ids``' streams, or (``k5_lengths``) uniform ids with rows of
    chosen lengths at random positions past the first 3."""
    keep = np.zeros(n, bool)
    if kind not in ("hot", "tile_edge"):
        return fused_ids(rng, kind, n, vocab), keep
    ids = rng.integers(0, vocab // 2, n).astype(np.int32)
    where = rng.permutation(n - 3) + 3
    k = 0
    for i, length in enumerate(k5_lengths(n)[kind]):
        ids[where[k:k + length]] = vocab // 2 + i  # rows the uniform ids never name
        keep[where[k:k + length]] = True
        k += length
    return ids, keep


def longest_segment(sids) -> int:
    """Positions of the longest run of one row among sorted ids (the
    padding sentinel's run left out)."""
    import torch

    from persia_tpu_torch.ops.sparse_update import PAD_SENTINEL

    live = sids[sids != PAD_SENTINEL]
    return int(torch.unique_consecutive(live, return_counts=True)[1].max()) if live.numel() else 0


def phase_fused_kernels(dev):
    """Phase 3b: K4, the routing and K5 against their plain versions at
    bench shapes."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.optim import SGD, Adagrad, Adam
    from persia_tpu_torch.ops.fused_gather import fused_gather_reference
    from persia_tpu_torch.ops.sparse_update import (
        init_sparse_state, sparse_update_reference, update_keys_reference,
    )

    print("== phase 3b: fused-tier kernels vs their plain versions", flush=True)
    rng = np.random.default_rng(SEED + 5)
    g = torch.Generator(device=dev).manual_seed(SEED + 5)

    def slot_ids(kind, shape, vocab=VOCAB):
        ids = fused_ids(rng, kind, int(np.prod(shape)), vocab)
        ids[rng.random(ids.size) < 0.05] = -1  # padding
        ids[:5] = vocab + np.array([0, 1, 2, -1, 1 << 30])  # past the slot's vocab, its last row, far past it
        return torch.from_numpy(ids.reshape(shape)).to(dev)

    # K4 copies rows: it must equal its plain version bit for bit (NaNs too),
    # with and without the update keys; the keys (integers) bit for bit the
    # plain routing
    table = torch.randn((N_SLOTS * VOCAB, EMB_DIM), device=dev, generator=g)
    offsets = [s * VOCAB for s in range(N_SLOTS)]
    narrow = torch.randn((3 * 1000, 10), device=dev, generator=g)
    cases = [
        ("bench: 26 stacked slots, uniform", table, [slot_ids("uniform", (BATCH,)) for _ in range(N_SLOTS)],
         offsets, VOCAB, True),
        ("bench: 26 stacked slots, zipf(1.2)", table, [slot_ids("zipf", (BATCH,)) for _ in range(N_SLOTS)],
         offsets, VOCAB, True),
        ("bf16 table, 3 single-id slots and a pooled (B, 5) slot", table[:4 * VOCAB].to(torch.bfloat16),
         [slot_ids("uniform", (BATCH,)) for _ in range(3)] + [slot_ids("zipf", (BATCH, 5))], offsets[:4], VOCAB,
         True),
        ("unstacked f32 (NaN past the vocab)", table[:VOCAB], [slot_ids("uniform", (BATCH,))], [0], VOCAB, False),
        ("unstacked bf16 (B, 3)", table[:VOCAB].to(torch.bfloat16), [slot_ids("zipf", (BATCH, 3))], [0], VOCAB,
         False),
        ("dim 10 (4-byte vectors), 3 slots", narrow, [slot_ids("uniform", (777,), 1000) for _ in range(3)],
         [0, 1000, 2000], 1000, True),
    ]
    for label, tbl, ids, offs, vocab, stacked in cases:
        vocabs = [vocab] * len(ids)
        out = ops.fused_gather(tbl, ids, offs, vocabs, stacked)
        rows, keys = ops.fused_gather(tbl, ids, offs, vocabs, stacked, keys=True)
        ref = fused_gather_reference(tbl, ids, offs, vocabs, stacked)
        ref_keys = update_keys_reference(ids, offs, vocabs)
        torch.cuda.synchronize()
        ok = same_bits(out, ref) and same_bits(rows, ref) and same_bits(keys, ref_keys)
        print(f"  fused_gather {label}: {out.shape[0]} rows ({int(out.isnan().any(1).sum())} NaN), with and "
              f"without keys; {keys.numel()} keys ({int((keys == 2 ** 31 - 1).sum())} at the sentinel): "
              f"max_abs_err=0 tolerance=0 (bitwise) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"fused_gather {label} disagrees with its plain version (rows or keys)")
    del table, cases

    # the standalone routing (the graph step's warm-up): integers, bit for
    # bit its plain version (the per-slot update_ids, on the card): the
    # bench's 26 slots with pads, ids past the vocab and ids < -1, and 130
    # slots (two launches) with (B, 3) slots
    def routed(nslots, shape, vocab):
        ids = [torch.from_numpy(rng.integers(-4, vocab + 4, shape).astype(np.int32)).to(dev)
               for _ in range(nslots)]
        return ids, [s * vocab for s in range(nslots)], [vocab] * nslots

    for label, (ids, offs, vocabs) in (("bench: 26 slots of B=4096", routed(N_SLOTS, (BATCH,), VOCAB)),
                                       ("130 slots of (64, 3)", routed(130, (64, 3), 1000))):
        out = ops.update_keys(ids, offs, vocabs)
        ok = same_bits(out, update_keys_reference(ids, offs, vocabs))
        torch.cuda.synchronize()
        print(f"  update_keys {label}: {out.numel()} keys ({int((out == 2 ** 31 - 1).sum())} at the sentinel): "
              f"max_abs_err=0 tolerance=0 (bitwise) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"update_keys {label} disagrees with its plain version")

    # K5 sums each row's gradients in sorted order, as the plain version on
    # the CPU does (index_add_ in index order), and rounds every operation
    # once, as the plain version does: the two must agree bit for bit. The
    # plain version on the card sums with index_add_'s atomics, in another
    # order: its difference is printed, not held
    n = N_SLOTS * BATCH
    adagrad = Adagrad(lr=0.05).config
    k5 = [("bench: 26 stacked slots of 1M, Adagrad(0.05), uniform", adagrad, "uniform", True, torch.float32),
          ("bench: 26 stacked slots of 1M, Adagrad(0.05), zipf(1.2)", adagrad, "zipf", True, torch.float32),
          ("bf16 table, Adagrad(0.05), zipf(1.2)", adagrad, "zipf", False, torch.bfloat16)]
    for name, opt in (("SGD(0.1, wd 0.01)", SGD(lr=0.1, weight_decay=0.01)),
                      ("Adagrad(0.05, momentum 0.95, wd 0.01)",
                       Adagrad(lr=0.05, g_square_momentum=0.95, weight_decay=0.01)),
                      ("Adagrad vectorwise(0.05, wd 0.01)", Adagrad(lr=0.05, vectorwise_shared=True, weight_decay=0.01)),
                      ("Adam(0.01, wd 0.1 ignored), powers at t=3", Adam(lr=0.01, weight_decay=0.1))):
        for kind in ("uniform", "zipf", "one_row", "hot", "tile_edge"):
            k5.append((f"{name}, {kind}", opt.config, kind, False, torch.float32))
    errs = {"fused_gather": 0.0, "update_keys": 0.0}
    for label, cfg, kind, bench, dtype in k5:
        vocab = N_SLOTS * VOCAB if bench else VOCAB
        keep = np.zeros(n, bool)
        if bench:  # each slot's ids in its own rows of the stacked table
            ids = np.concatenate([fused_ids(rng, kind, BATCH, VOCAB) + s * VOCAB for s in range(N_SLOTS)])
        else:
            ids, keep = k5_ids(rng, kind, n, vocab)
        ids[(rng.random(n) < 0.05) & ~keep] = -1  # masked padding
        ids[:3] = vocab + 1  # live past the table: dropped
        idt = torch.from_numpy(ids.astype(np.int32)).to(dev)
        mask = idt >= 0
        grads = torch.randn((n, EMB_DIM), device=dev, generator=g) * 0.1
        tbl = (torch.randn((vocab, EMB_DIM), device=dev, generator=g) * 0.05).to(dtype)
        st = init_sparse_state(cfg, vocab, EMB_DIM, device=dev)
        for k, v in st.items():
            v.uniform_(0.01, 1.0, generator=g)
        bs = torch.tensor([cfg.beta1 ** 3, cfg.beta2 ** 3], dtype=torch.float32, device=dev)
        cpu_tbl, cpu_st = tbl.cpu(), {k: v.cpu() for k, v in st.items()}
        plain_tbl, plain_st = tbl.clone(), {k: v.clone() for k, v in st.items()}
        ops.sparse_update(cfg, tbl, st, idt, grads, bs, mask=mask)
        sparse_update_reference(cfg, plain_tbl, plain_st, idt, grads, bs, mask=mask)
        sparse_update_reference(cfg, cpu_tbl, cpu_st, idt.cpu(), grads.cpu(), bs.cpu(), mask=mask.cpu())
        torch.cuda.synchronize()
        ok = same_bits(tbl, cpu_tbl) and all(same_bits(st[k], cpu_st[k]) for k in st)
        err = max([float((tbl.cpu().float() - cpu_tbl.float()).abs().max())]
                  + [float((st[k].cpu() - cpu_st[k]).abs().max()) for k in st])
        card_err = max([float((tbl.float() - plain_tbl.float()).abs().max())]
                       + [float((st[k] - plain_st[k]).abs().max()) for k in st])
        rows = int(torch.unique(idt[mask & (idt < vocab)]).numel())
        longest = longest_segment(torch.sort(idt[mask & (idt < vocab)])[0])
        print(f"  sparse_update {label}: {rows} rows touched, longest segment {longest}; vs the plain version on "
              f"the CPU: max_abs_err="
              f"{err:.3e} tolerance=0 (bitwise) {'ok' if ok else 'FAIL'}; vs the plain version on the card "
              f"(index_add_ atomics): {card_err:.3e}", flush=True)
        if not ok:
            raise SystemExit(f"sparse_update {label} disagrees with its plain version")
        errs.setdefault("sparse_update", err)
        del tbl, st, cpu_tbl, cpu_st, plain_tbl, plain_st
    torch.cuda.empty_cache()
    return errs


FUSED_HOST_BATCHES, FUSED_CHECK, FUSED_TIMED, FUSED_SYNCED, FUSED_PROFILED, FUSED_PIPE = 8, 5, 100, 40, 8, 32
# card against CPU after 3 fused steps, |delta_card - delta_cpu| / |delta_cpu|
# over the touched rows: both run DLRM in bf16, whose roundings differ, and
# read 7.2e-2 on the H100 (the accumulators do not move: Adagrad's 0.01
# start absorbs g^2 ~ 1e-10); twice that still fails an update that did
# nothing (1), half the step (0.5) or the wrong sign (2)
FUSED_DELTA_RTOL = 0.15


def fused_host_batches(seed, n, kind="uniform"):
    """The bench's fused batches (``bench.py:122-139``): for each slot in
    sorted order B int32 ids, uniform in [0, VOCAB) (or zipf(1.2) with a
    per-slot shift), then normal dense features and 0/1 labels."""
    rng = np.random.default_rng(seed)
    names = sorted(f"cat_{i}" for i in range(N_SLOTS))
    shift = dict(zip(names, rng.integers(0, VOCAB, N_SLOTS)))
    out = []
    for _ in range(n):
        if kind == "uniform":
            ids = {nm: rng.integers(0, VOCAB, BATCH, dtype=np.int32) for nm in names}
        else:
            ids = {nm: ((rng.zipf(1.2, BATCH) - 1 + shift[nm]) % VOCAB).astype(np.int32) for nm in names}
        dense = rng.normal(size=(BATCH, N_DENSE)).astype(np.float32)
        labels = rng.integers(0, 2, (BATCH, 1)).astype(np.float32)
        out.append({"dense": [dense], "labels": [labels], "ids": ids})
    return out


def check_launches(path, launches, expected):
    if launches != expected:
        raise SystemExit(f"{path}: launches {launches}, expected {expected}")


def fused_state_tensors(state):
    """Every tensor a fused step updates (a batch norm's running
    statistics included)."""
    out = [p for p in state.model.parameters()] + list(state.model.buffers())
    for st in state.optimizer.state.values():
        out.extend(v for v in st.values() if hasattr(v, "data_ptr"))
    out.extend(state.tables.values())
    for st in state.emb_state.values():
        out.extend(st.values())
    return out + [state.emb_batch_state, state.step]


def path_fused(dev):
    """Phase 4e: the fused all-on-card tier at bench width
    (``bench.py:100-221``): ``build_fused_train_step`` as a CUDA-graph
    step and eagerly, and ``FusedTrainCtx.train_pipelined``."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
    from persia_tpu_torch.parallel.fused_step import (
        FusedSlotSpec, build_fused_train_step, fused_batch_to_device, group_stacked_specs, init_fused_state,
    )
    from persia_tpu_torch.weights import fused_state_from_flax, fused_state_to_flax

    print(f"== phase 4e: fused training (26 stacked tables of 1M x 16 on the card, B={BATCH}, "
          f"build_fused_train_step)", flush=True)
    specs = {f"cat_{i}": FusedSlotSpec(vocab=VOCAB, dim=EMB_DIM) for i in range(N_SLOTS)}
    cfg = Adagrad(lr=0.05).config
    (group,) = group_stacked_specs(specs, sorted(specs))

    def new_model(device):
        m = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device=device,
                 generator=torch.Generator().manual_seed(SEED))
        return m, torch.optim.Adam(m.parameters(), lr=1e-3)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = init_fused_state(*new_model(dev), torch.Generator().manual_seed(SEED), specs, cfg, stack=True,
                             device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    host = fused_host_batches(SEED + 30, FUSED_HOST_BATCHES)
    zipf_host = fused_host_batches(SEED + 31, FUSED_HOST_BATCHES, "zipf")
    graph_step = build_fused_train_step(cfg, specs, stack=True, jit=True)
    eager_step = build_fused_train_step(cfg, specs, stack=True, jit=False)

    def on_card(h):
        return fused_batch_to_device(h, dev)

    # the graph step against the eager step, FUSED_CHECK steps from one
    # state, bit for bit; the rows the first steps touch kept for the CPU
    manifest, arrays0 = fused_state_to_flax(state)
    twin = fused_state_from_flax(manifest, arrays0, *new_model(dev), device=dev)
    touched = torch.from_numpy(np.unique(np.concatenate(
        [h["ids"][nm] + off for h in host[:TRAIN_CPU_STEPS] for nm, off in zip(group.slots, group.offsets)])))

    def touched_rows(st):
        return st.tables[group.name][touched.to(st.tables[group.name].device)].cpu()

    init_rows = touched_rows(state)
    g_losses, e_losses = [], []
    for i in range(FUSED_CHECK):
        b = on_card(host[i % FUSED_HOST_BATCHES])
        if i == 0:  # the graph step's capture, counted: its warm-up and the capture go through the wrappers
            ops.reset_launch_counts()
        state, (loss, _) = graph_step(state, b)
        if i == 0:
            capture_launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
            expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
            # K4 routes the step's update ids; update_keys only in the warm-up
            expected.update(dot_interaction=2, dot_interaction_bwd=2, fused_gather=2, update_keys=1, sparse_update=2)
            print(f"  graph step's capture (warm-up and capture): launches={capture_launches}", flush=True)
            check_launches("fused path (graph step's capture)", capture_launches, expected)
        twin, (loss2, _) = eager_step(twin, b)
        g_losses.append(loss)
        e_losses.append(loss2)
        if i + 1 == TRAIN_CPU_STEPS:
            card_rows = touched_rows(state)
    torch.cuda.synchronize()
    same = same_bits(torch.stack(g_losses), torch.stack(e_losses)) and all(
        same_bits(a, c) for a, c in zip(fused_state_tensors(state), fused_state_tensors(twin)))
    g_losses = torch.stack(g_losses).cpu().tolist()
    print(f"  graph step vs eager step, {FUSED_CHECK} steps from one state: losses {g_losses}; losses, "
          f"tables, optimizer states and parameters bitwise {'ok' if same else 'FAIL'}", flush=True)
    if not same:
        raise SystemExit("fused path: the graph step and the eager step disagree")

    # the same first steps on the CPU from a copy of the initial state
    cpu_state = fused_state_from_flax(manifest, arrays0, *new_model("cpu"), device="cpu")
    del arrays0
    cpu_step = build_fused_train_step(cfg, specs, stack=True)
    cpu_losses = []
    for h in host[:TRAIN_CPU_STEPS]:
        cpu_losses.append(float(cpu_step(cpu_state, fused_batch_to_device(h, "cpu"))[1][0]))
    loss_err = max(abs(a - c) for a, c in zip(g_losses, cpu_losses))
    cpu_rows = touched_rows(cpu_state)
    row_err = float((card_rows - cpu_rows).abs().max())
    # what the steps changed in the rows, card against CPU: the norm of the
    # difference of the deltas over the norm of the CPU's delta (an update
    # that did nothing reads 1, one that zeroed the rows far more)
    delta_max = float((cpu_rows - init_rows).abs().max())
    delta_err = float((card_rows - cpu_rows).norm() / (cpu_rows - init_rows).norm())
    ok = loss_err <= 2e-2 and row_err <= 1e-2 and delta_err <= FUSED_DELTA_RTOL
    print(f"  first {TRAIN_CPU_STEPS} losses card {g_losses[:TRAIN_CPU_STEPS]} cpu {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance=2e-2; the {touched.numel()} rows they touched: "
          f"max_abs_err={row_err:.3e} tolerance=1e-2; their deltas (largest {delta_max:.3e}): "
          f"|card - cpu| / |cpu| = {delta_err:.3e} tolerance={FUSED_DELTA_RTOL:g} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("fused path: card and CPU disagree")
    del cpu_state, card_rows, cpu_rows, init_rows

    def run(step, st, stream, n, synced=None):
        """n steps over the host batches (staged each step, as the bench
        stages them), then a synchronize; returns (state, seconds,
        losses). ``synced`` gets each step's ms with a synchronize after
        it."""
        losses = []
        t = time.perf_counter()
        for i in range(n):
            t1 = time.perf_counter()
            st, (loss, _) = step(st, on_card(stream[i % len(stream)]))
            losses.append(loss)
            if synced is not None:
                torch.cuda.synchronize()
                synced.append((time.perf_counter() - t1) * 1e3)
        torch.cuda.synchronize()
        return st, time.perf_counter() - t, torch.stack(losses).cpu().numpy()

    state, wall, losses = run(graph_step, state, host, FUSED_TIMED)
    print(f"  graph step: {FUSED_TIMED} steps in {wall * 1e3:.1f} ms, {FUSED_TIMED * BATCH / wall:.1f} samples/s",
          flush=True)
    synced = []
    state, _, more = run(graph_step, state, host, FUSED_SYNCED, synced)
    # the main path as the wrappers count it: a graph replay goes through
    # no wrapper, so the counted run is the eager step's (the graph step's
    # kernels are counted on the card, from the trace, below)
    ops.reset_launch_counts()
    twin, e_wall, e_losses = run(eager_step, twin, host, FUSED_TIMED)
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(dot_interaction=FUSED_TIMED, dot_interaction_bwd=FUSED_TIMED,
                    fused_gather=FUSED_TIMED, sparse_update=FUSED_TIMED)
    print(f"  eager step: {FUSED_TIMED} steps, launches={launches}", flush=True)
    check_launches("fused path (eager step)", launches, expected)
    e_synced = []
    twin, _, _ = run(eager_step, twin, host, FUSED_SYNCED, e_synced)
    state, z_wall, z_losses = run(graph_step, state, zipf_host, FUSED_TIMED)
    all_losses = np.concatenate([losses, more, e_losses, z_losses])
    if not np.isfinite(all_losses).all():
        raise SystemExit("fused path: a non-finite loss")
    print(f"  eager step: {FUSED_TIMED * BATCH / e_wall:.1f} samples/s; graph step on zipf(1.2) ids: "
          f"{FUSED_TIMED * BATCH / z_wall:.1f} samples/s; synced step p50 graph "
          f"{np.percentile(synced, 50):.3f} ms (longest {max(synced):.3f}), eager "
          f"{np.percentile(e_synced, 50):.3f} ms (longest {max(e_synced):.3f})", flush=True)
    # where the eager step's host time goes: PyTorch's operators by their
    # own CPU time over 3 steps (torch.profiler), ms a step
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        twin, _, _ = run(eager_step, twin, host, 3)
    eager_cpu = {e.key[:60]: e.self_cpu_time_total / 1e3 / 3 for e in sorted(
        prof.key_averages(), key=lambda e: -e.self_cpu_time_total)[:10]}
    print(f"  eager step, host CPU ms a step by operator: {eager_cpu}", flush=True)
    del twin
    torch.cuda.empty_cache()

    # the card's own time a step (torch.profiler), and the kernels' runs;
    # then the same with the update ids routed by the standalone kernel
    # after K4 without keys (the step before the routing moved into K4), in
    # turns: new, standalone, new
    from persia_tpu_torch.parallel import fused_step as fused_step_module

    def standalone_routing(table, ids, offsets, vocabs, stacked=True, keys=False):
        rows = ops.fused_gather(table, ids, offsets, vocabs, stacked)
        return (rows, ops.update_keys(ids, offsets, vocabs)) if keys else rows

    prof_batches = [on_card(h) for h in host]
    step_ms = wall / FUSED_TIMED * 1e3

    def traced(step):
        """The graph steps over ``prof_batches``, traced until the trace
        holds every replay whole. A trace can lose device records, a
        replay's all of them too; a graph's replays run the same kernels,
        so a trace with fewer replays than steps, or with replays that
        differ, lost records: it is taken again (three traces at most).
        A fault of the step shows in every replay and is not retraced."""
        for attempt in range(1, 4):
            busy_, top_, runs_ = device_busy_ms(lambda b: step(state, b), prof_batches)
            replays = runs_["replays"]
            if len(replays) == len(prof_batches) and replays[0]["events"] and all(r == replays[0] for r in replays):
                return busy_, top_, runs_, runs_["elementwise"] / len(prof_batches)
            print(f"  trace {attempt} of the graph steps lost device records: {len(replays)} graph launches "
                  f"for {len(prof_batches)} steps, device events a launch {[r['events'] for r in replays]}",
                  flush=True)
        raise SystemExit("fused path: three traces of the graph steps each lost device records")

    def kernel_runs(runs_):
        return {"fused_gather": runs_["fused_gather_kernel"], "update_keys": runs_["update_keys_kernel"],
                **{k: runs_[k] for k in K5_KERNELS},
                "dot_interaction": runs_["dot_interaction_kernel"] + runs_["dot_interaction_mma_kernel"],
                "dot_interaction_bwd": runs_["dot_interaction_bwd_kernel"] + runs_["dot_interaction_bwd_mma_kernel"]}

    busy, top, runs, elementwise = traced(graph_step)
    fused_step_module.fused_gather = standalone_routing
    try:
        standalone_step = build_fused_train_step(cfg, specs, stack=True, jit=True)
        standalone_step(state, prof_batches[0])  # captured with the standalone routing kernel
    finally:
        fused_step_module.fused_gather = ops.fused_gather
    busy_alone, _, runs_alone, elementwise_alone = traced(standalone_step)
    busy2, _, runs2, elementwise2 = traced(graph_step)
    del standalone_step
    graph_runs, graph_runs2, alone_runs = kernel_runs(runs), kernel_runs(runs2), kernel_runs(runs_alone)
    print(f"  card busy {busy} ms of a {step_ms:.3f} ms graph step; top kernels {top}; kernel runs on the card "
          f"in {len(prof_batches)} graph steps (trace): {graph_runs}", flush=True)
    print(f"  routing in K4 vs by the standalone kernel, card busy a graph step: {busy} and {busy2} ms vs "
          f"{busy_alone} ms; PyTorch elementwise kernels a step: {elementwise} and {elementwise2} vs "
          f"{elementwise_alone}; kernel runs (trace) {graph_runs2} vs {alone_runs}", flush=True)
    per_step = dict.fromkeys(graph_runs, len(prof_batches))
    check_launches("fused path (graph step, traced)", graph_runs, {**per_step, "update_keys": 0})
    check_launches("fused path (graph step, traced again)", graph_runs2, {**per_step, "update_keys": 0})
    check_launches("fused path (graph step, standalone routing, traced)", alone_runs, per_step)

    # FusedTrainCtx.train_pipelined (depth 2, k=1) over FUSED_PIPE batches
    def persia_batch(h):
        ids = [IDTypeFeatureWithSingleID(nm, h["ids"][nm].astype(np.uint64)) for nm in sorted(h["ids"])]
        return PersiaBatch(ids, non_id_type_features=[NonIDTypeFeature(h["dense"][0])],
                           labels=[Label(h["labels"][0])], requires_grad=True)

    pbatches = [persia_batch(host[i % FUSED_HOST_BATCHES]) for i in range(FUSED_PIPE + 2)]
    ctx = FusedTrainCtx(*new_model(dev), Adagrad(lr=0.05), specs, stack=True, seed=SEED, device=dev)
    ctx.train_pipelined(pbatches[:2], pipeline_depth=2)  # builds the tables and captures the step
    t = time.perf_counter()
    m = ctx.train_pipelined(pbatches[2:], pipeline_depth=2, dispatch_k=1)
    pipe_wall = time.perf_counter() - t
    pipe_stats = ctx.pipeline_stats()
    if len(m["losses"]) != FUSED_PIPE or not np.isfinite(m["losses"]).all():
        raise SystemExit(f"fused path: pipelined losses {m.get('losses')}")
    print(f"  train_pipelined (depth 2, k=1), {FUSED_PIPE} batches: {FUSED_PIPE * BATCH / pipe_wall:.1f} "
          f"samples/s; {pipe_stats}", flush=True)
    peak = torch.cuda.max_memory_allocated()
    del ctx

    fused = {
        "batch": BATCH, "slots": N_SLOTS, "vocab_per_slot": VOCAB, "dim": EMB_DIM, "stacked": True,
        "sparse_optimizer": "Adagrad(lr=0.05)", "dense_optimizer": "Adam(lr=1e-3)",
        "table_init_s": init_s, "peak_device_bytes": peak,
        "graph_equals_eager_steps": FUSED_CHECK,
        "loss_max_abs_err_vs_cpu": loss_err, "row_max_abs_err_vs_cpu": row_err, "rows_compared": touched.numel(),
        "row_delta_rel_err_vs_cpu": delta_err, "row_delta_max": delta_max, "delta_rel_tolerance": FUSED_DELTA_RTOL,
        "eager_step_launches": {k: launches[k] for k in ("fused_gather", "update_keys", "sparse_update",
                                                         "dot_interaction", "dot_interaction_bwd")},
        "graph_capture_launches": {k: capture_launches[k] for k in ("fused_gather", "update_keys", "sparse_update",
                                                                    "dot_interaction", "dot_interaction_bwd")},
        "graph_step_kernel_runs_traced": graph_runs, "traced_graph_steps": len(prof_batches),
        "standalone_routing_graph_step_kernel_runs_traced": alone_runs,
        "graph_samples_per_s": FUSED_TIMED * BATCH / wall, "graph_step_ms_mean": step_ms,
        "eager_samples_per_s": FUSED_TIMED * BATCH / e_wall,
        "zipf_graph_samples_per_s": FUSED_TIMED * BATCH / z_wall,
        "timed_steps": FUSED_TIMED,
        "graph_step_ms_p50_synced": float(np.percentile(synced, 50)), "graph_step_ms_max_synced": max(synced),
        "eager_step_ms_p50_synced": float(np.percentile(e_synced, 50)), "eager_step_ms_max_synced": max(e_synced),
        "graph_step_device_busy_ms": busy, "graph_step_device_busy_ms_runs": [busy, busy2],
        "graph_step_elementwise_kernels": elementwise,
        "standalone_routing_graph_step_device_busy_ms": busy_alone,
        "standalone_routing_graph_step_elementwise_kernels": elementwise_alone,
        "graph_step_idle_share": None if busy is None else 1 - busy / step_ms,
        "graph_step_top_kernels_ms": top, "eager_step_top_cpu_ms": eager_cpu,
        "pipelined_samples_per_s": FUSED_PIPE * BATCH / pipe_wall, "pipelined_batches": FUSED_PIPE,
        "pipelined_stats": pipe_stats,
        "losses_first": g_losses, "loss_last": float(all_losses[-1]),
    }
    inputs = {"table": state.tables[group.name], "state": state.emb_state[group.name], "group": group,
              "cfg": cfg, "batch": on_card(host[0]), "zipf_batch": on_card(zipf_host[0])}
    return launches, capture_launches, fused, inputs


# ---------------------------------------------------------------------------
# DIN on Taobao (examples/taobao_din/train.py) and DeepFM / DCN-v2 on Avazu
# (examples/avazu/train.py): phases 3c, 4g, 4h and 4i


def raw_inputs(dev, dtype, seed, case, batch=DIN_BATCH, hist=DIN_HIST, distinct=(26_000, 9_000)):
    """A raw group at the DIN path's shape: per slot ``d`` distinct rows of
    dim 16 (P = round_up_pow2(d + 1), rows past d zero) and a (B, L) index
    with Taobao's history lengths (1..L valid positions, pads at P - 1),
    sample 0 with no history and sample 1 with a full one ("taobao"), or
    every position on one row ("one_row"); with each slot's CSR (that of
    the package imported, ``ops.raw_csr``'s arrays in order)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.utils import round_up_pow2

    rng = np.random.default_rng(seed)
    rows, slots = [], []
    for d in distinct:
        p = round_up_pow2(d + 1)
        r = np.zeros((p, DIN_DIM), np.float32)
        r[:d] = rng.standard_normal((d, DIN_DIM))
        if case == "one_row":
            index = np.full((batch, hist), 3, np.int32)
        else:
            lengths = rng.integers(1, hist + 1, batch)
            lengths[0], lengths[1] = 0, hist
            index = np.where(np.arange(hist)[None, :] < lengths[:, None], rng.integers(0, d, (batch, hist)),
                             p - 1).astype(np.int32)
        rows.append(torch.from_numpy(r).to(dev, dtype))
        slots.append(ops.RawSlot(*(torch.from_numpy(a).to(dev) for a in (index, *ops.raw_csr(index, p)))))
    return rows, slots


def raw_bwd_tolerance(grad, rows, slots, dtype):
    """Per element: twice the f32 sum-order bound of its row's n terms (the
    kernel sums a row in its fixed tree order, index_add_ in stream order),
    then one rounding: 1e-6 relative in f32, one bf16 ulp (2^-8) in bf16."""
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference

    abs_sums = raw_gather_bwd_reference(grad.abs().float(), [r.float() for r in rows], slots)
    rtol = 1e-6 if dtype == np.float32 else 2 ** -8
    return rtol, [2 * (s.offsets[1:] - s.offsets[:-1]).float()[:, None] * 2 ** -24 * a
                  for s, a in zip(slots, abs_sums)]


def raw_schedule_bits(grad, slots, dtype):
    """K7's sums by ``plans.raw_bwd_model`` (its order, in numpy) for each
    slot, rounded to ``dtype``, as bits on the CPU."""
    import torch

    from persia_tpu_torch.ops import plans

    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    return [torch.from_numpy(plans.raw_bwd_model(g.reshape(-1, g.shape[-1]).float().cpu().numpy(),
                                                 s.order.cpu().numpy(), s.offsets.cpu().numpy())).to(dtype).view(bits)
            for g, s in zip(grad, slots)]


def att_inputs(dev, dtype, seed, batch=DIN_BATCH, hist=DIN_HIST, dim=DIN_DIM, prefix=True):
    """K8/K9's inputs, by default at the DIN path's shape: f32 logits,
    Taobao's masks (a valid prefix; ``prefix=False``: each position valid
    with probability 1/2), sample 0 with no history, sample 1 a full one,
    history rows zero at the pads, the pooled rows' gradient."""
    import torch

    rng = np.random.default_rng(seed)
    if prefix:
        lengths = rng.integers(1, hist + 1, batch)
        lengths[0], lengths[1] = 0, hist
        mask = np.arange(hist)[None, :] < lengths[:, None]
    else:
        mask = rng.random((batch, hist)) < 0.5
        mask[0], mask[1] = False, True
    h = rng.standard_normal((batch, hist, dim)).astype(np.float32)
    h[~mask] = 0.0
    logits = (2 * rng.standard_normal((batch, hist))).astype(np.float32)
    d_out = rng.standard_normal((batch, dim)).astype(np.float32)
    return (torch.from_numpy(logits).to(dev), torch.from_numpy(mask).to(dev), torch.from_numpy(h).to(dev, dtype),
            torch.from_numpy(d_out).to(dev, dtype))


def phase_din_kernels(dev):
    """Phase 3c: K6-K9 against their plain versions on the card."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.attention_pool import attention_pool_bwd_reference, attention_pool_fwd_reference
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference, raw_gather_fwd_reference
    from persia_tpu_torch.testing.envelopes import attention_pool_bwd_envelope, attention_pool_fwd_envelope

    print(f"== phase 3c: DIN kernels vs their plain versions (B={DIN_BATCH}, L={DIN_HIST}, dim {DIN_DIM})",
          flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    errs = {}
    for dtype, ndt in ((torch.bfloat16, None), (torch.float32, np.float32)):
        name = str(dtype)[6:]
        for case in ("taobao", "one_row"):
            rows, slots = raw_inputs(dev, dtype, SEED + len(case), case)
            out = ops.raw_gather_fwd(rows, slots)
            grad = torch.randn(out.shape, generator=g).to(dev, dtype)
            grads = ops.raw_gather_bwd(grad, rows, slots)
            again = ops.raw_gather_bwd(grad, rows, slots)
            torch.cuda.synchronize()
            label = f"raw_gather {case} {name} {list(out.shape)}"
            same = torch.equal(out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                               raw_gather_fwd_reference(rows, slots).view(
                                   torch.int16 if dtype == torch.bfloat16 else torch.int32))
            print(f"  {label} fwd: bitwise {'ok' if same else 'FAIL'}", flush=True)
            if not same:
                raise SystemExit("raw_gather_fwd disagrees with its plain version")
            errs.setdefault(("raw_fwd", dtype), 0.0)
            rtol, extra = raw_bwd_tolerance(grad, rows, slots, ndt)
            err = check_close(f"{label} bwd", torch.cat(grads), torch.cat(raw_gather_bwd_reference(grad, rows, slots)),
                              rtol, torch.cat(extra) + 1e-30)
            errs.setdefault(("raw_bwd", dtype), err)
            twice = all(torch.equal(a, b) for a, b in zip(grads, again))
            print(f"  {label} bwd twice: bitwise {'ok' if twice else 'FAIL'}", flush=True)
            if not twice:
                raise SystemExit("raw_gather_bwd is not deterministic")
            # K7's own order (plans.raw_bwd_model), both slots; where no row
            # is long (the Taobao histories) that is the plain version's
            # stream order, run on the CPU; the pad row zero
            bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
            sched = all(torch.equal(got.cpu().view(bits), want)
                        for got, want in zip(grads, raw_schedule_bits(grad, slots, dtype)))
            print(f"  {label} bwd vs its schedule (plans.raw_bwd_model): bitwise {'ok' if sched else 'FAIL'}",
                  flush=True)
            if not sched:
                raise SystemExit("raw_gather_bwd does not follow its schedule")
            if case == "taobao":
                if any(s.long_chunks.numel() for s in slots):
                    raise SystemExit("the Taobao histories were to have no long row")
                cpu = raw_gather_bwd_reference(grad.cpu(), [r.cpu() for r in rows],
                                               [ops.RawSlot(*(t.cpu() for t in s)) for s in slots])
                plain = all(torch.equal(a.cpu().view(bits), b.view(bits)) for a, b in zip(grads, cpu))
                print(f"  {label} bwd vs the plain version on the CPU: bitwise {'ok' if plain else 'FAIL'}",
                      flush=True)
                if not plain:
                    raise SystemExit("raw_gather_bwd disagrees with its plain version's stream order")
            if any(bool(got[-1].any()) for got in grads):
                raise SystemExit("raw_gather_bwd wrote the pad row")
        # the attention pool: weights to 1e-6 (exp and sums in another
        # order); the pooled rows and d_logits inside their f64 envelopes
        # (persia_tpu_torch.testing.envelopes: an f32 sum in any order, then
        # one rounding to the dtype), the kernel and the plain version each
        # with its own weights; d_hist bit for bit; nothing at masked
        # positions or on an empty row
        # (at the DIN shape first, its errors the ones reported; then the
        # kernels' edge cases, random masks)
        for b, l, dim in [(DIN_BATCH, DIN_HIST, DIN_DIM)] + ATT_EDGE_CASES:
            din = (b, l, dim) == (DIN_BATCH, DIN_HIST, DIN_DIM)
            logits, mask, hist, d_out = att_inputs(dev, dtype, SEED + 3 + (0 if din else l), b, l, dim, prefix=din)
            out, w = ops.attention_pool_fwd(logits, mask, hist)
            d_logits, d_hist = ops.attention_pool_bwd(d_out, mask, hist, w)
            torch.cuda.synchronize()
            ref_out, ref_w = attention_pool_fwd_reference(logits, mask, hist)
            ref_dl, ref_dh = attention_pool_bwd_reference(d_out, mask, hist, w)
            label = f"attention_pool {name} {list(hist.shape)}"
            check_close(f"{label} weights", w, ref_w, 1e-6, 1e-12)
            err = check_envelope(f"{label} fwd", out, ref_out, attention_pool_fwd_envelope(w, hist),
                                 attention_pool_fwd_envelope(ref_w, hist))
            errs.setdefault(("att_fwd", dtype), err)
            check_close(f"{label} bwd d_hist", d_hist, ref_dh, 0.0, 0.0)
            if not same_bits(d_hist, ref_dh):  # signed zeros at masked positions too
                raise SystemExit(f"{label} bwd d_hist is not bit for bit its plain version")
            env = attention_pool_bwd_envelope(d_out, mask, hist, w)
            err = check_envelope(f"{label} bwd d_logits", d_logits, ref_dl, env, env)
            errs.setdefault(("att_bwd", dtype), err)
            leak = bool(out[0].any()) or bool(d_logits[0].any()) or bool(d_logits[~mask].any())
            nan = not (bool(torch.isfinite(d_logits).all()) and bool(torch.isfinite(d_hist.float()).all()))
            print(f"  {label}: the empty row and masked positions zero, no NaN: "
                  f"{'FAIL' if leak or nan else 'ok'}", flush=True)
            if leak or nan:
                raise SystemExit("attention_pool leaks into masked positions or writes a NaN")
    # the path's dtypes: the f32 wire for K6/K7, bf16 compute for K8/K9
    return {"raw_gather_fwd": errs[("raw_fwd", torch.float32)], "raw_gather_bwd": errs[("raw_bwd", torch.float32)],
            "attention_pool_fwd": errs[("att_fwd", torch.bfloat16)],
            "attention_pool_bwd": errs[("att_bwd", torch.bfloat16)]}


def din_cfg():
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    raw = dict(dim=DIN_DIM, embedding_summation=False, sample_fixed_size=DIN_HIST)
    return EmbeddingConfig(
        slots_config={"item": SlotConfig(dim=DIN_DIM), "cate": SlotConfig(dim=DIN_DIM),
                      "hist_item": SlotConfig(**raw), "hist_cate": SlotConfig(**raw)},
        feature_index_prefix_bit=8,
        feature_groups={"items": ["item", "hist_item"], "cates": ["cate", "hist_cate"]},
    )


def din_ctx(device, backend, sd=None):
    """``examples/taobao_din/train.py``'s ``build_ctx`` through the port: two
    PS replicas of ``backend`` (2^20 rows, 16 shards, Adagrad(0.05), seeds
    13 and 14), DIN(attention (36,), top (200, 80)), Adam(1e-3), the f32
    wire; weights from SEED. Returns (ctx, stores, weights)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DIN
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = din_cfg()
    stores = [make_store(backend, capacity=1 << 20, num_internal_shards=16, optimizer=Adagrad(lr=0.05).config,
                         seed=13 + r) for r in range(2)]
    model = DIN(1, 2, 2, DIN_DIM, DIN_ATT, DIN_TOP, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05), EmbeddingWorker(cfg, stores),
                   cfg, device=device).__enter__()
    return ctx, stores, sd


def entries_of_stores(stores, batches, cfg):
    """{sign: entry} of ``batches``' signs over the replicas that hold them."""
    out = {}
    for store in stores:
        out.update(entries_of(store, batch_keys(batches, cfg)))
    return out


def path_din(dev):
    """Phases 4g (DIN on Taobao, hybrid training) and 4h (DIN serving)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import InferCtx, stage_embeddings
    from persia_tpu_torch.data_loader import DataLoader
    from persia_tpu_torch.models import DIN
    from persia_tpu_torch.serialization import msgpack_restore
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.testing import TaobaoSynthetic, roc_auc
    from persia_tpu_torch.weights import state_dict_from_flax, train_state_to_flax_bytes

    print(f"== phase 4g: DIN on Taobao, hybrid training (B={DIN_BATCH}, L={DIN_HIST}, DataLoader "
          f"num_workers={PIPE_WORKERS}, staleness={PIPE_STALENESS})", flush=True)
    t0 = time.perf_counter()
    n = DIN_REPRO + DIN_BATCHES + DIN_PROFILED
    batches = list(TaobaoSynthetic(num_samples=n * DIN_BATCH, max_hist=DIN_HIST, seed=42).batches(DIN_BATCH))
    held_out = list(TaobaoSynthetic(num_samples=DIN_EVAL * DIN_BATCH, max_hist=DIN_HIST, seed=4242).batches(
        DIN_BATCH, requires_grad=False))
    requests = [b.to_bytes() for b in TaobaoSynthetic(num_samples=DIN_REQUESTS * DIN_BATCH, max_hist=DIN_HIST,
                                                      seed=777).batches(DIN_BATCH, requires_grad=False)]
    print(f"  {n + DIN_EVAL + DIN_REQUESTS} TaobaoSynthetic batches in {time.perf_counter() - t0:.2f} s", flush=True)
    repro, train, profiled = batches[:DIN_REPRO], batches[DIN_REPRO:DIN_REPRO + DIN_BATCHES], batches[-DIN_PROFILED:]
    cfg = din_cfg()

    # reproducible, staleness 1 on the card; train_step on the CPU over the
    # numpy stores (the golden model) from the same weights and initial rows
    ctx, stores, sd = din_ctx(dev, "native")
    loader = DataLoader(iter(repro), ctx, num_workers=PIPE_WORKERS, staleness=1, reproducible=True)
    card_losses = [ctx.train_step_prepared(tb, loader)["loss"] for tb in loader]
    loader.flush()
    loader.shutdown()
    card_rows = entries_of_stores(stores, repro, cfg)
    cpu, cpu_stores, _ = din_ctx("cpu", "numpy", sd)
    cpu_losses = [cpu.train_step(b)["loss"] for b in repro]
    cpu_rows = entries_of_stores(cpu_stores, repro, cfg)
    loss_err = max(abs(a - c) for a, c in zip(card_losses, cpu_losses))
    print(f"  first {DIN_REPRO} losses (reproducible, staleness 1) card {card_losses} cpu {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance=2e-2 {'ok' if loss_err <= 2e-2 else 'FAIL'}", flush=True)
    if set(card_rows) != set(cpu_rows) or not card_rows:
        raise SystemExit(f"DIN training: the card's stores hold {len(card_rows)} of the batches' signs, "
                         f"the CPU's {len(cpu_rows)}")
    row_err = max(float(np.abs(card_rows[k] - v).max()) for k, v in cpu_rows.items())
    print(f"  PS entries after {DIN_REPRO} steps, card (native) vs cpu (numpy), {len(cpu_rows)} rows: "
          f"max_abs_err={row_err:.3e} tolerance=1e-2 {'ok' if row_err <= 1e-2 else 'FAIL'}", flush=True)
    if loss_err > 2e-2 or row_err > 1e-2 or not all(np.isfinite(card_losses)):
        raise SystemExit("DIN training: card and CPU disagree")

    # the example's loop: DataLoader(num_workers=4, staleness=4), counted,
    # each host stage timed inside it
    parts = {k: [] for k in ("lookup", "stage", "update", "lookup_cpu", "stage_cpu", "update_cpu")}
    restore = [timed_calls(ctx.worker, "forward_batch_id", parts["lookup"], parts["lookup_cpu"]),
               timed_calls(ctx, "prepare_features", parts["stage"], parts["stage_cpu"]),
               timed_calls(ctx.worker, "update_gradient_batched", parts["update"], parts["update_cpu"])]
    ops.reset_launch_counts()
    step_ms = []
    t0 = time.perf_counter()
    try:
        loader = DataLoader(iter(train), ctx, num_workers=PIPE_WORKERS, staleness=PIPE_STALENESS)
        t = time.perf_counter()
        for tb in loader:
            ctx.train_step_prepared(tb, loader, fetch_metrics=False)
            now = time.perf_counter()
            step_ms.append((now - t) * 1e3)
            t = now
        loader.flush()
        loader.shutdown()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    finally:
        for undo in restore:
            undo()
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(raw_gather_fwd=DIN_BATCHES, raw_gather_bwd=DIN_BATCHES,
                    attention_pool_fwd=2 * DIN_BATCHES, attention_pool_bwd=2 * DIN_BATCHES)
    final = ctx.last_prepared_metrics()
    print(f"  launches={launches} over {DIN_BATCHES} batches; final loss {final['loss']:.5f}; "
          f"staleness after flush {ctx.worker.staleness}", flush=True)
    check_launches("DIN training path", launches, expected)
    if not np.isfinite(final["loss"]) or ctx.worker.staleness != 0:
        raise SystemExit("DIN training: non-finite loss, or gradients still in flight after flush")

    # the card's busy time a step: the device step alone, profiled apart
    refs, device_batches, looked_up = [], [], []
    for b in profiled:
        refs.append(ctx.worker.put_forward_ids(b))
        looked_up.append(ctx.worker.forward_batch_id(refs[-1], train=True))
        device_batches.append(ctx.prepare_features(b, looked_up[-1], csr=True)[0])
    busy_ms, top_kernels, _ = device_busy_ms(ctx.run_step, device_batches)
    for ref in refs:
        ctx.worker.abort_gradient(ref)
    # the host's staging of a looked-up batch without and with the CSRs the
    # backward kernels walk (raw_csr for the raw slots, pool_csr for the
    # pooled): what the CSRs cost the host a step (median of 3 passes)
    stage_host_ms = {}
    for csr in (False, True):
        times = []
        for _ in range(3):
            for embs in looked_up:
                t0 = time.perf_counter()
                stage_embeddings(embs, dtype=ctx.wire_dtype, csr=csr)
                times.append((time.perf_counter() - t0) * 1e3)
        stage_host_ms["with_csr" if csr else "without_csr"] = float(np.median(times))

    preds = np.concatenate([ctx.eval_batch(b) for b in held_out])
    auc = roc_auc(np.concatenate([b.labels[0].data for b in held_out]), preds)
    stage_p50 = {k: float(np.percentile(v, 50)) for k, v in parts.items()}
    training = {
        "batch": DIN_BATCH, "history": DIN_HIST, "batches": DIN_BATCHES, "num_workers": PIPE_WORKERS,
        "staleness": PIPE_STALENESS, "store_backend": "native", "wire": "float32",
        "samples_per_s": DIN_BATCHES * DIN_BATCH / wall, "wall_ms": wall * 1e3,
        "step_ms_p50": float(np.percentile(step_ms, 50)), "step_ms_max": max(step_ms), "step_ms_all": step_ms,
        "stage_ms_p50": stage_p50, "stage_host_ms": stage_host_ms, "final_loss": final["loss"],
        "repro_losses": card_losses,
        "loss_max_abs_err_vs_cpu": loss_err, "ps_entry_max_abs_err_vs_cpu": row_err,
        "step_device_busy_ms": busy_ms, "step_top_kernels_ms": top_kernels,
        "kernel_launches_per_step": {k: launches[k] / DIN_BATCHES for k in DIN_KERNELS},
        "held_out_auc": auc, "held_out_batches": DIN_EVAL,
        "store_rows": sum(s.size() for s in stores),
    }
    print(f"  {training['samples_per_s']:.1f} samples/s; step p50 {training['step_ms_p50']:.2f} ms, longest "
          f"{training['step_ms_max']:.2f}; stage p50 {json.dumps(stage_p50)}; staging a batch on the host "
          f"{json.dumps(stage_host_ms)} ms; card busy {busy_ms} ms a step; "
          f"launches a step {training['kernel_launches_per_step']}; held-out AUC {auc:.5f} "
          f"({DIN_EVAL} batches, not gated)", flush=True)

    # phase 4h: the trained dense state as flax's bytes, loaded into a
    # fresh DIN behind InferenceEngine(InferCtx) on the card; the same
    # weights on the CPU over the same stores (lookups only: zeros on miss)
    print(f"== phase 4h: DIN serving ({DIN_REQUESTS} requests of B={DIN_BATCH})", flush=True)
    params = msgpack_restore(train_state_to_flax_bytes(ctx.state))["params"]
    engines = {}
    for device in (dev, "cpu"):
        model = DIN(1, 2, 2, DIN_DIM, DIN_ATT, DIN_TOP, device=device)
        model.load_state_dict(state_dict_from_flax(model, params))
        engines[device] = InferenceEngine(InferCtx(model, ctx.worker, cfg, device=device), device=device)
    engine = engines[dev]
    ops.reset_launch_counts()
    latencies, served = [], []
    t_all = time.perf_counter()
    for raw in requests:
        t = time.perf_counter()
        served.append(engine.predict_from_bytes(raw))
        latencies.append((time.perf_counter() - t) * 1e3)
    wall = time.perf_counter() - t_all
    serving_launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(raw_gather_fwd=DIN_REQUESTS, attention_pool_fwd=2 * DIN_REQUESTS)
    print(f"  launches={serving_launches} forwards={engine.forwards}", flush=True)
    check_launches("DIN serving path", serving_launches, expected)
    err = 0.0
    for raw, p in zip(requests, served):
        if p.shape != (DIN_BATCH, 1) or not np.isfinite(p).all():
            raise SystemExit(f"DIN serving: bad predictions, shape {p.shape}")
        err = max(err, float(np.abs(p - engines["cpu"].predict_from_bytes(raw)).max()))
    print(f"  card vs cpu engine: max_abs_err={err:.3e} tolerance=2e-2 {'ok' if err <= 2e-2 else 'FAIL'}", flush=True)
    if err > 2e-2:
        raise SystemExit("DIN serving: card and CPU predictions disagree")
    serving = {
        "requests": DIN_REQUESTS, "batch": DIN_BATCH, "latency_ms_p50": float(np.percentile(latencies, 50)),
        "latency_ms_max": max(latencies), "latency_ms_all": latencies,
        "samples_per_s": DIN_REQUESTS * DIN_BATCH / wall, "pred_max_abs_err_vs_cpu": err,
    }
    print(f"  serving p50 {serving['latency_ms_p50']:.2f} ms, slowest (cold) {serving['latency_ms_max']:.2f} ms, "
          f"{serving['samples_per_s']:.1f} samples/s", flush=True)
    launches = {"din_training": launches, "din_serving": serving_launches}
    return launches, {"training": training, "serving": serving}, device_batches[-1]


def avazu_ctx(name, device, backend, sd=None):
    """``examples/avazu/train.py``'s ``build_ctx`` (hybrid) through the port:
    21 fields of dim 16, two PS replicas of ``backend`` (2^20 rows, 16
    shards, Adagrad(0.05), seeds 11 and 12), deep MLP (256, 128), DCN-v2
    with 3 full-rank cross layers, Adam(1e-3); weights from SEED."""
    import torch

    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DCNv2, DeepFM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = EmbeddingConfig(slots_config={f"field_{i}": SlotConfig(dim=EMB_DIM) for i in range(AVAZU_FIELDS)},
                          feature_index_prefix_bit=8)
    stores = [make_store(backend, capacity=1 << 20, num_internal_shards=16, optimizer=Adagrad(lr=0.05).config,
                         seed=11 + r) for r in range(2)]
    if name == "deepfm":
        model = DeepFM(2, AVAZU_FIELDS, EMB_DIM, AVAZU_DEEP, device="cpu")
    else:
        model = DCNv2(2, AVAZU_FIELDS, EMB_DIM, 3, None, AVAZU_DEEP, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), Adagrad(lr=0.05), EmbeddingWorker(cfg, stores),
                   cfg, device=device).__enter__()
    return ctx, sd


def path_avazu(dev):
    """Phase 4i: DeepFM and DCN-v2 on Avazu, ``TrainCtx.train_step``."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.testing import AvazuSynthetic

    print(f"== phase 4i: DeepFM and DCN-v2 on Avazu, hybrid (B={AVAZU_BATCH}, {AVAZU_STEPS} steps each)", flush=True)
    batches = list(AvazuSynthetic(num_samples=AVAZU_STEPS * AVAZU_BATCH, seed=42).batches(AVAZU_BATCH))
    out, all_launches = {}, {}
    for name in ("deepfm", "dcnv2"):
        ctx, sd = avazu_ctx(name, dev, "native")
        ops.reset_launch_counts()
        losses, step_ms = [], []
        for b in batches:
            t = time.perf_counter()
            losses.append(ctx.train_step(b)["loss"])  # ends in the gradients' copy to the host and the update
            step_ms.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        # host-pooled fields (the example's worker): no kernel of this port runs
        check_launches(f"{name} on Avazu", launches, {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS})
        cpu, _ = avazu_ctx(name, "cpu", "numpy", sd)
        cpu_losses = [cpu.train_step(b)["loss"] for b in batches[:AVAZU_CPU_STEPS]]
        err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
        ok = err <= 2e-2 and all(np.isfinite(losses)) and ctx.worker.staleness == 0
        print(f"  {name}: losses {[round(x, 5) for x in losses]}; first {AVAZU_CPU_STEPS} vs cpu max_abs_err="
              f"{err:.3e} tolerance=2e-2 {'ok' if ok else 'FAIL'}; step ms p50 {np.percentile(step_ms, 50):.2f}, "
              f"longest {max(step_ms):.2f}", flush=True)
        if not ok:
            raise SystemExit(f"{name} on Avazu: card and CPU disagree, or a loss is not finite")
        out[name] = {"batch": AVAZU_BATCH, "steps": AVAZU_STEPS, "losses": losses,
                     "loss_max_abs_err_vs_cpu": err, "step_ms_p50": float(np.percentile(step_ms, 50)),
                     "step_ms_max": max(step_ms), "step_ms_all": step_ms,
                     "samples_per_s": AVAZU_STEPS * AVAZU_BATCH / (sum(step_ms) / 1e3)}
        all_launches[name] = launches
    return all_launches, out


def bn_inputs(dev, b, c, dtype, seed):
    """(x, dy, scale, bias, running mean, running var) on ``dev``: x with
    per-column offsets and spreads (a mean a few stds off zero, as a Dense
    layer's output), f32 parameters and statistics."""
    import torch

    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, c)) * rng.uniform(0.5, 3.0, c) + rng.uniform(-2, 2, c)

    def t(a, dt=torch.float32):
        return torch.from_numpy(np.asarray(a, np.float32)).to(dev, dt)

    return (t(x, dtype), t(rng.standard_normal((b, c)), dtype), t(1 + 0.2 * rng.standard_normal(c)),
            t(0.1 * rng.standard_normal(c)), t(0.3 * rng.standard_normal(c)), t(rng.uniform(0.5, 2.0, c)))


def phase_bn_kernels(dev):
    """Phase 3d: K10 (train mode and the running statistics) and K11
    against their plain versions on the card, and bit for bit against their
    schedules (the plain versions with the kernels' sum order) on the CPU;
    two runs give the same bits."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.batch_norm import (
        batch_norm_bwd_reference, batch_norm_bwd_schedule, batch_norm_fwd_reference, batch_norm_fwd_schedule,
    )

    print("== phase 3d: DNN's batch norm kernels (K10 forward, train and eval; K11 backward) vs their plain "
          "versions", flush=True)
    errs = {}
    for b, c, dt in BN_CASES:
        dtype = getattr(torch, dt)
        x, dy, scale, bias, mean, var = bn_inputs(dev, b, c, dtype, SEED + 7 * b + c)
        # y and dx within one ulp of the dtype plus 1e-5 of the column's
        # scale (the sums in another order move the mean, which moves y
        # where x sits several stds off zero); the statistics and the
        # parameters' gradients within 1e-5
        rel = 2.0 ** -7 if dtype == torch.bfloat16 else 1e-5
        col = (x.float().abs().amax(0) + 1.0)[None, :]
        for train in (True, False):
            label = f"batch_norm {'train' if train else 'eval'} {dt} ({b}, {c})"
            rm, rv, prm, prv, rm2, rv2 = (t.clone() for t in (mean, var) * 3)
            y, saved = ops.batch_norm_fwd(x, scale, bias, rm, rv, train)
            dx, ds, db = ops.batch_norm_bwd(dy, x, scale, saved, train)
            y2, saved2 = ops.batch_norm_fwd(x, scale, bias, rm2, rv2, train)
            dx2, ds2, db2 = ops.batch_norm_bwd(dy, x, scale, saved2, train)
            torch.cuda.synchronize()
            py, psaved = batch_norm_fwd_reference(x, scale, bias, prm, prv, train)
            pdx, pds, pdb = batch_norm_bwd_reference(dy, x, scale, psaved, train)
            m = (psaved[1] * scale).abs()[None, :]
            e_y = check_close(f"{label} y", y, py, rel, 1e-5 * col * m)
            check_close(f"{label} mean and rstd", saved[:2], psaved[:2], 1e-5, 1e-5 * col)
            check_close(f"{label} running mean", rm, prm, 1e-5, 1e-6 * col[0])
            check_close(f"{label} running var", rv, prv, 1e-5, 1e-5 * col[0] ** 2)
            g = float(dy.float().abs().max()) * float(m.max())
            e_dx = check_close(f"{label} dx", dx, pdx, rel, 1e-5 * g)
            dsum = dy.float().abs().sum(0)
            terms = (dy.float() * (x.float() - psaved[0]) * psaved[1]).abs().sum(0)  # sum |dy * x_hat|
            check_close(f"{label} dscale", ds, pds, 1e-5, 1e-5 * terms)
            check_close(f"{label} dbias", db, pdb, 1e-5, 1e-5 * dsum)
            twice = all(torch.equal(p, q) for p, q in ((y, y2), (saved, saved2), (rm, rm2), (rv, rv2), (dx, dx2),
                                                       (ds, ds2), (db, db2)))
            host = [t.cpu() for t in (x, scale, bias, mean, var)]
            wy, wsaved, wrm, wrv = batch_norm_fwd_schedule(*host, train)
            wdx, wds, wdb = batch_norm_bwd_schedule(dy.cpu(), host[0], host[1], wsaved, train)
            sched = all(torch.equal(p.cpu(), q) for p, q in ((y, wy), (saved, wsaved), (rm, wrm), (rv, wrv),
                                                             (dx, wdx), (ds, wds), (db, wdb)))
            still = train or (torch.equal(rm, mean) and torch.equal(rv, var))
            print(f"  {label}: twice bitwise {'ok' if twice else 'FAIL'}; bitwise its schedule on the CPU "
                  f"{'ok' if sched else 'FAIL'}; running statistics {'moved' if train else 'untouched'} "
                  f"{'ok' if still else 'FAIL'}", flush=True)
            if not (twice and sched and still):
                raise SystemExit(f"{label}: not deterministic, off its schedule, or eval mode moved the statistics")
            if b == 1 and train and not torch.equal(y, bias.to(dtype)[None]):
                raise SystemExit(f"{label}: one row must give y = bias (flax's variance 0)")
            if (b, c, dt) == (BATCH, 128, "bfloat16") and train:
                errs = {"batch_norm_fwd": e_y, "batch_norm_bwd": e_dx}
    return errs


def dnn_cfg(slots=DNN_SLOTS, dim=DNN_DIM):
    from persia_tpu_torch.config import EmbeddingConfig, SlotConfig

    return EmbeddingConfig(slots_config={f"cat_{i}": SlotConfig(dim=dim) for i in range(slots)},
                           feature_index_prefix_bit=8)


def dnn_batch_maker(seed, rows, labels=True):
    """The serving bench's batches (``benchmarks/serving_bench.py``): per
    slot i, zipf(1.2) ids shifted by 1000 i, modulo 100,000; 8 normal dense
    features; 0/1 labels for training."""
    from persia_tpu_torch.data import IDTypeFeatureWithSingleID, Label, NonIDTypeFeature, PersiaBatch

    rng = np.random.default_rng(seed)

    def make():
        ids = [IDTypeFeatureWithSingleID(f"cat_{i}", (rng.zipf(1.2, rows).astype(np.uint64) + np.uint64(i * 1000))
                                         % np.uint64(DNN_VOCAB)) for i in range(DNN_SLOTS)]
        dense = [NonIDTypeFeature(rng.normal(size=(rows, DNN_DENSE)).astype(np.float32))]
        if not labels:
            return PersiaBatch(ids, non_id_type_features=dense, requires_grad=False)
        y = [Label(rng.integers(0, 2, (rows, 1)).astype(np.float32))]
        return PersiaBatch(ids, non_id_type_features=dense, labels=y, requires_grad=True)

    return make


def dnn_ctx(device, backend, sd=None, compute_dtype=None):
    """The serving bench's ``_build_ctx`` through the port, with device
    pooling: one store of ``backend`` (2^18 rows, 4 shards, Adagrad(0.1),
    seed 7), DNN(32, 128, (128, 64)) in bf16 compute (or
    ``compute_dtype``), Adam(3e-3); weights from SEED, the statistics at
    flax's start (0 and 1). Returns (ctx, store, weights)."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cfg = dnn_cfg()
    store = make_store(backend, capacity=1 << 18, num_internal_shards=4, optimizer=Adagrad(lr=0.1).config, seed=7)
    model = DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, compute_dtype or torch.bfloat16, device="cpu")
    sd = sd or state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    model.load_state_dict(sd)
    ctx = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1),
                   EmbeddingWorker(cfg, [store], device_pooling=True), cfg, device=device).__enter__()
    return ctx, store, sd


def dnn_gaps(card, cpu, card_store, cpu_store, keys):
    """Card against CPU after the same steps: the losses' largest gap, the
    batch statistics' (mean and var apart), and each PS row's largest gap
    of its embedding and relative gap of its Adagrad accumulator, by key."""
    from persia_tpu_torch.weights import batch_stats_to_flax

    a, b = batch_stats_to_flax(card.model), batch_stats_to_flax(cpu.model)
    stats = {k: max(float(np.abs(a[n][k] - b[n][k]).max()) for n in b) for k in ("mean", "var")}
    card_rows, cpu_rows = entries_of(card_store, keys), entries_of(cpu_store, keys)
    if set(card_rows) != set(cpu_rows) or not card_rows:
        raise SystemExit(f"DNN training: the card's store holds {len(card_rows)} of the batches' signs, the CPU's "
                         f"{len(cpu_rows)}")
    signs = np.array(sorted(cpu_rows), dtype=np.uint64)
    rows = np.array([float(np.abs(card_rows[k][:DNN_DIM] - cpu_rows[k][:DNN_DIM]).max()) for k in signs.tolist()])
    acc = np.array([float((np.abs(card_rows[k][DNN_DIM:] - cpu_rows[k][DNN_DIM:])
                           / np.maximum(np.abs(cpu_rows[k][DNN_DIM:]), 1e-30)).max()) for k in signs.tolist()])
    return stats, signs, rows, acc


def permuted_batch(batch, perm):
    """``batch`` with its samples in the order ``perm``: the same
    arithmetic, every sum over the batch taken in another order."""
    from persia_tpu_torch.data import IDTypeFeature, Label, NonIDTypeFeature, PersiaBatch

    return PersiaBatch([IDTypeFeature(f.name, [f.data[i] for i in perm]) for f in batch.id_type_features],
                       non_id_type_features=[NonIDTypeFeature(f.data[perm], f.name)
                                             for f in batch.non_id_type_features],
                       labels=[Label(f.data[perm], f.name) for f in batch.labels], requires_grad=batch.requires_grad)


def dnn_f32_witness(dev, batches, sd, cfg):
    """Phase 4j (b)'s witness: the same steps in f32 compute on the card,
    on the CPU, and on the card again from the same weights with one layer
    moved by one ulp (Dense_2's kernel, each element). After the first
    step, from the same state on both devices, the card must equal the CPU
    as far as the sums' order can part them, which the first batch with
    its samples permuted measures on each device (rows and accumulators
    within twice the larger of the two gaps, and at least 1e-4 and 1e-3):
    a fault of K1, K2, K10 or K11 shows there, rounding does not. The
    later steps measure
    how training itself grows a rounding-sized difference: Adam's first
    steps move a parameter by ~lr whatever its gradient's size, so a
    gradient near 0 that takes the other sign parts the two runs by 2 lr."""
    import torch

    moved = {k: v.clone() for k, v in sd.items()}
    moved["layers.2.weight"] = torch.nextafter(sd["layers.2.weight"], torch.tensor(float("inf")))
    runs = {name: dnn_ctx(device, backend, weights, torch.float32)[:2] for name, device, backend, weights in (
        ("card", dev, "native", sd), ("cpu", "cpu", "numpy", sd), ("card_ulp", dev, "native", moved))}
    losses = {name: [] for name in runs}
    readings = {}
    spread = {}
    for i, b in enumerate(batches):
        for name, (ctx, _) in runs.items():
            losses[name].append(ctx.train_step(b)["loss"])
        if i == 0:
            perm = np.random.default_rng(SEED).permutation(b.batch_size)
            for name, device, backend in (("card", dev, "native"), ("cpu", "cpu", "numpy")):
                ctx, store = dnn_ctx(device, backend, sd, torch.float32)[:2]
                ctx.train_step(permuted_batch(b, perm))
                _, _, rows, acc = dnn_gaps(runs[name][0], ctx, runs[name][1], store, batch_keys(batches[:1], cfg))
                spread[name] = {"rows_max": float(rows.max()), "rows_p99": float(np.percentile(rows, 99)),
                                "acc_max": float(acc.max())}
        if i in (0, len(batches) - 1):
            keys = batch_keys(batches[:i + 1], cfg)
            (card, card_store) = runs["card"]
            for other in ("cpu", "card_ulp"):
                stats, _, rows, acc = dnn_gaps(card, runs[other][0], card_store, runs[other][1], keys)
                readings[(i, other)] = {
                    "loss": max(abs(a - c) for a, c in zip(losses["card"], losses[other])),
                    "mean": stats["mean"], "var": stats["var"], "rows_max": float(rows.max()),
                    "rows_p99": float(np.percentile(rows, 99)), "acc_max": float(acc.max())}
    first = readings[(0, "cpu")]
    # a fault that drops or misroutes a position moves its row by that
    # position's whole step; rounding moves a row by up to what the
    # permuted batch shows (a relu whose pre-activation lies within
    # rounding of 0 takes the other sign, and its sample's rows move)
    rows_bound = max(1e-4, 2 * max(v["rows_max"] for v in spread.values()))
    acc_bound = max(1e-3, 2 * max(v["acc_max"] for v in spread.values()))
    ok = (first["loss"] <= 1e-5 and first["mean"] <= 1e-5 and first["var"] <= 1e-5
          and first["rows_max"] <= rows_bound and first["acc_max"] <= acc_bound)
    last = len(batches) - 1

    def fmt(r):
        return (f"losses {r['loss']:.3e}, means {r['mean']:.3e}, variances {r['var']:.3e}, rows max "
                f"{r['rows_max']:.3e} p99 {r['rows_p99']:.3e}, accumulators rel {r['acc_max']:.3e}")

    print(f"  f32 witness, card vs cpu after the first step: {fmt(first)} (losses and statistics 1e-5, rows "
          f"{rows_bound:.3e} and accumulators {acc_bound:.3e}: twice the first batch's permuted gaps, at least "
          f"1e-4 and 1e-3; card "
          f"{spread['card']}, cpu {spread['cpu']}) {'ok' if ok else 'FAIL'}; the card vs itself from Dense_2's "
          f"kernel moved by one ulp, after the first step: {fmt(readings[(0, 'card_ulp')])}; after {last + 1} "
          f"steps: card vs cpu "
          f"{fmt(readings[(last, 'cpu')])}"
          f"; card vs the card from Dense_2's kernel moved by one ulp {fmt(readings[(last, 'card_ulp')])}", flush=True)
    return ok, {"steps": last + 1, "first_step_vs_cpu": first, "first_step_permuted": spread,
                "last_step_vs_cpu": readings[(last, "cpu")],
                "last_step_vs_one_ulp": readings[(last, "card_ulp")],
                "first_step_vs_one_ulp": readings[(0, "card_ulp")]}


def bn_launches_expected(ops, **counts):
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(counts)
    return expected


def path_adult(dev):
    """Phase 4j (a): the adult-income example on the card, held to its
    pinned AUC and to the same run on the CPU."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.testing import adult_income

    ai = adult_income
    print(f"== phase 4j (a): adult income (examples/adult_income/train.py's config: VOCABS {ai.VOCABS}, dim "
          f"{ai.DIM}, DNN({ai.DENSE_MLP}, {ai.SPARSE_MLP}, {ai.HIDDEN}), numpy store 2^18 / 4 shards, "
          f"Adagrad(0.1), Adam(3e-3), B={ai.BATCH}, {ai.EPOCHS} epochs of {ai.TRAIN_SAMPLES}, test "
          f"{ai.TEST_SAMPLES}; host pooling)", flush=True)
    pinned = ai.reference_auc(pathlib.Path(__file__).resolve().parent)
    runs = {}
    for device in ("cpu", dev):
        ctx, _ = ai.build_ctx(device)
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        epochs = ai.train(ctx, on_epoch=lambda e, loss, auc, d=device: print(
            f"  {d} epoch {e}: loss={loss:.4f} test_auc={auc:.6f}", flush=True))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs[str(device)] = (epochs, wall, {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS},
                             dict(ops.batch_norm_fwd.launches_by_route))
    (card, card_wall, launches, by_route), (cpu, cpu_wall, _, _) = runs[str(dev)], runs["cpu"]
    steps = sum(len(losses) for losses, _ in card)
    evals = ai.EPOCHS * -(-ai.TEST_SAMPLES // ai.BATCH)
    check_launches("adult income", launches, bn_launches_expected(
        ops, batch_norm_fwd=2 * (steps + evals), batch_norm_bwd=2 * steps))
    if by_route != {"train": 2 * steps, "eval": 2 * evals}:
        raise SystemExit(f"adult income: K10's launches by mode {by_route}, expected {2 * steps} train and "
                         f"{2 * evals} eval")
    card_losses = np.concatenate([losses for losses, _ in card])
    cpu_losses = np.concatenate([losses for losses, _ in cpu])
    gap = np.abs(card_losses - cpu_losses)
    first_off = next((i for i, d in enumerate(gap) if d > 2e-2), None)
    auc, cpu_auc = card[-1][1], cpu[-1][1]
    ok = abs(auc - pinned) <= 5e-3 and abs(cpu_auc - pinned) <= 5e-3 and np.isfinite(card_losses).all()
    print(f"  final test AUC card {auc!r}, cpu {cpu_auc!r}, pinned REPRODUCIBLE_AUC {pinned!r}: card - pinned "
          f"{auc - pinned:+.3e}, cpu - pinned {cpu_auc - pinned:+.3e} (tolerance 5e-3) {'ok' if ok else 'FAIL'}; "
          f"per-step losses card vs cpu max |diff| {gap.max():.3e}, first step past 2e-2: {first_off}; "
          f"{steps} steps + {evals} eval batches in {card_wall:.2f} s (cpu {cpu_wall:.2f} s); launches {launches}",
          flush=True)
    if not ok:
        raise SystemExit("adult income: the final AUC is not within 5e-3 of the reference's pinned one")
    return launches, {
        "epochs": ai.EPOCHS, "batch": ai.BATCH, "steps": steps, "eval_batches": evals,
        "epoch_loss": [float(np.mean(losses)) for losses, _ in card], "epoch_auc": [a for _, a in card],
        "final_auc": auc, "cpu_final_auc": cpu_auc, "pinned_auc": pinned, "auc_minus_pinned": auc - pinned,
        "cpu_auc_minus_pinned": cpu_auc - pinned, "loss_max_abs_diff_vs_cpu": float(gap.max()),
        "first_step_past_2e-2": first_off, "wall_s": card_wall, "cpu_wall_s": cpu_wall,
        "launches_by_mode": by_route,
    }


def path_dnn_hybrid(dev):
    """Phase 4j (b): DNN at the serving bench's width on the hybrid tier,
    trained and then served."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import InferCtx
    from persia_tpu_torch.embedding.worker import preprocess_batch
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.serving.engine import InferenceEngine
    from persia_tpu_torch.weights import model_from_flax_bytes, train_state_to_flax_bytes

    print(f"== phase 4j (b): DNN at the serving bench's width, hybrid ({DNN_SLOTS} slots of dim {DNN_DIM} over "
          f"{DNN_VOCAB} ids, zipf(1.2), DNN{DNN_MLP}, device pooling; {DNN_WARM} + {DNN_STEPS} steps of B={BATCH}, "
          f"then {DNN_REQUESTS} requests of B={DNN_SERVE_BATCH})", flush=True)
    make = dnn_batch_maker(SEED + 21, BATCH)
    batches = [make() for _ in range(DNN_WARM + DNN_STEPS)]
    profiled = [make() for _ in range(4)]
    cfg = dnn_cfg()
    ctx, store, sd = dnn_ctx(dev, "native")
    cpu, cpu_store, _ = dnn_ctx("cpu", "numpy", sd)
    # the first step, from the same state on both devices: the rows within
    # 1e-2 and their accumulators within 1e-2 of themselves
    card_losses = [ctx.train_step(batches[0])["loss"]]
    cpu_losses = [cpu.train_step(batches[0])["loss"]]
    first_stats, _, first_rows, first_acc = dnn_gaps(ctx, cpu, store, cpu_store, batch_keys(batches[:1], cfg))
    first = {"loss": abs(card_losses[0] - cpu_losses[0]), "stats": max(first_stats.values()),
             "rows_max": float(first_rows.max()), "acc_max": float(first_acc.max())}
    first_ok = (first["loss"] <= 2e-2 and first["stats"] <= 1e-2 and first["rows_max"] <= 1e-2
                and first["acc_max"] <= 1e-2)
    print(f"  bf16, card vs cpu after the first step: loss {first['loss']:.3e} (2e-2), batch_stats "
          f"{first['stats']:.3e} (1e-2), PS rows max {first['rows_max']:.3e} (1e-2), Adagrad accumulators rel max "
          f"{first['acc_max']:.3e} (1e-2) {'ok' if first_ok else 'FAIL'}", flush=True)
    card_losses += [ctx.train_step(b)["loss"] for b in batches[1:DNN_WARM]]
    ops.reset_launch_counts()
    step_ms = []
    for b in batches[DNN_WARM:]:
        t = time.perf_counter()
        card_losses.append(ctx.train_step(b)["loss"])  # ends in the gradients' copy to the host and the update
        step_ms.append((time.perf_counter() - t) * 1e3)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    by_route = dict(ops.batch_norm_fwd.launches_by_route)
    check_launches("DNN training path", launches, bn_launches_expected(
        ops, gather_pool_fwd=DNN_STEPS, gather_pool_bwd=DNN_STEPS, batch_norm_fwd=2 * DNN_STEPS,
        batch_norm_bwd=2 * DNN_STEPS))
    if by_route != {"train": 2 * DNN_STEPS, "eval": 0}:
        raise SystemExit(f"DNN training: K10's launches by mode {by_route}")
    cpu_losses += [cpu.train_step(b)["loss"] for b in batches[1:DNN_CPU_STEPS]]
    loss_err = max(abs(a - c) for a, c in zip(card_losses, cpu_losses))
    keys = batch_keys(batches, cfg)
    stats, signs, gaps, acc_gaps = dnn_gaps(ctx, cpu, store, cpu_store, keys)
    stats_err = max(stats.values())
    # the rows after all the steps: training grows any rounding-sized
    # difference (the f32 witness below: card against CPU, and the card
    # against itself from weights moved by one ulp, part as far), so
    # 99 % of the rows within 1e-2 (embeddings) and 1e-2 of itself (the
    # accumulator), every row within 5e-2 and 0.1 (measured in bf16:
    # 2.28e-2 to 3.79e-2 and 4.2e-2 to 4.8e-2)
    row_err, acc_err = float(gaps.max()), float(acc_gaps.max())
    row_p99, acc_p99 = float(np.percentile(gaps, 99)), float(np.percentile(acc_gaps, 99))
    counts = dict(zip(*np.unique(np.concatenate([s.keys for b in batches for s in preprocess_batch(
        b.id_type_features, cfg)]), return_counts=True)))
    tail = [(float(gaps[i]), int(counts[signs[i]])) for i in np.argsort(gaps)[::-1][:5]]
    ok = (loss_err <= 2e-2 and stats_err <= 1e-2 and row_p99 <= 1e-2 and row_err <= 5e-2 and acc_p99 <= 1e-2
          and acc_err <= 0.1 and np.isfinite(card_losses).all())
    print(f"  losses card {[round(x, 5) for x in card_losses]} cpu {[round(x, 5) for x in cpu_losses]}: max_abs_err="
          f"{loss_err:.3e} (tolerance 2e-2); batch_stats max_abs_err mean {stats['mean']:.3e}, var "
          f"{stats['var']:.3e} (1e-2); PS rows ({len(gaps)}, native vs numpy) abs err p50 "
          f"{np.percentile(gaps, 50):.3e}, p99 {row_p99:.3e} (1e-2), max {row_err:.3e} (5e-2), "
          f"{float((gaps > 1e-2).mean()):.4%} past 1e-2; the 5 widest (gap, steps that touched the row) {tail}; "
          f"Adagrad accumulators rel err p99 {acc_p99:.3e} (1e-2), max {acc_err:.3e} (0.1) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    witness_ok, witness = dnn_f32_witness(dev, batches[:DNN_CPU_STEPS], sd, cfg)
    if not first_ok:
        raise SystemExit("DNN training: card and CPU disagree after the first step")
    if not ok:
        raise SystemExit("DNN training: card and CPU disagree")
    if not witness_ok:
        raise SystemExit("DNN training: card and CPU disagree in f32 compute")

    refs, device_batches = [], []
    for b in profiled:
        refs.append(ctx.worker.put_forward_ids(b))
        device_batches.append(ctx.prepare_features(b, ctx.worker.forward_batch_id(refs[-1], train=True), csr=True)[0])
    busy_ms, top_kernels, runs = device_busy_ms(ctx.run_step, device_batches)
    for ref in refs:
        ctx.worker.abort_gradient(ref)
    training = {
        "batch": BATCH, "steps": DNN_STEPS, "warm_steps": DNN_WARM, "store_backend": "native", "device_pooling": True,
        "samples_per_s": DNN_STEPS * BATCH / (sum(step_ms) / 1e3), "step_ms_p50": float(np.percentile(step_ms, 50)),
        "step_ms_max": max(step_ms), "step_ms_all": step_ms, "losses": card_losses,
        "loss_max_abs_err_vs_cpu": loss_err, "batch_stats_max_abs_err_vs_cpu": stats_err,
        "ps_row_max_abs_err_vs_cpu": row_err, "ps_row_p99_abs_err_vs_cpu": row_p99,
        "ps_accumulator_max_rel_err_vs_cpu": acc_err, "ps_accumulator_p99_rel_err_vs_cpu": acc_p99,
        "widest_rows_gap_and_touches": tail, "first_step_vs_cpu": first, "f32_witness": witness,
        "step_device_busy_ms": busy_ms, "step_top_kernels_ms": top_kernels,
        "bn_kernel_runs_4_steps": {k: runs[k] for k in ("batch_norm_fwd_kernel", "batch_norm_bwd_kernel")},
    }
    print(f"  {training['samples_per_s']:.1f} samples/s; step p50 {training['step_ms_p50']:.2f} ms, longest "
          f"{training['step_ms_max']:.2f}; card busy {busy_ms} ms a step; its kernels {json.dumps(top_kernels)}; "
          f"K10/K11 runs in 4 traced steps {training['bn_kernel_runs_4_steps']}", flush=True)

    # serving: the trained state as flax's bytes, loaded into a bare DNN
    # (model_from_flax_bytes: params and batch_stats) behind
    # InferenceEngine(InferCtx); the same bytes on the CPU over the same store
    raw_state = train_state_to_flax_bytes(ctx.state)
    requests = [b.to_bytes() for b in (dnn_batch_maker(SEED + 22, DNN_SERVE_BATCH, labels=False)()
                                       for _ in range(DNN_REQUESTS))]
    engines = {}
    for device in (dev, "cpu"):
        model = model_from_flax_bytes(DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, device=device), raw_state)
        engines[device] = InferenceEngine(InferCtx(model, ctx.worker, cfg, device=device), device=device)
    engine = engines[dev]
    ops.reset_launch_counts()
    latencies, served = [], []
    for raw in requests:
        t = time.perf_counter()
        served.append(engine.predict_from_bytes(raw))
        latencies.append((time.perf_counter() - t) * 1e3)
    serving_launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    serve_route = dict(ops.batch_norm_fwd.launches_by_route)
    check_launches("DNN serving path", serving_launches, bn_launches_expected(
        ops, gather_pool_fwd=DNN_REQUESTS, batch_norm_fwd=2 * DNN_REQUESTS))
    if serve_route != {"train": 0, "eval": 2 * DNN_REQUESTS}:
        raise SystemExit(f"DNN serving: K10's launches by mode {serve_route}")
    err = 0.0
    for raw, p in zip(requests, served):
        if p.shape != (DNN_SERVE_BATCH, 1) or not np.isfinite(p).all():
            raise SystemExit(f"DNN serving: bad predictions, shape {p.shape}")
        err = max(err, float(np.abs(p - engines["cpu"].predict_from_bytes(raw)).max()))
    print(f"  serving launches {serving_launches} (K10 by mode {serve_route}); card vs cpu engine max_abs_err="
          f"{err:.3e} tolerance=2e-2 {'ok' if err <= 2e-2 else 'FAIL'}; p50 {np.percentile(latencies, 50):.2f} ms, "
          f"slowest (cold) {max(latencies):.2f}", flush=True)
    if err > 2e-2:
        raise SystemExit("DNN serving: card and CPU predictions disagree")
    serving = {"requests": DNN_REQUESTS, "batch": DNN_SERVE_BATCH,
               "latency_ms_p50": float(np.percentile(latencies, 50)), "latency_ms_max": max(latencies),
               "latency_ms_all": latencies, "pred_max_abs_err_vs_cpu": err}
    return {"dnn_training": launches, "dnn_serving": serving_launches}, {"training": training, "serving": serving}


def path_dnn_resume(dev):
    """Phase 4j (c): kill and resume at bench.py:936-960's configuration on
    the card, both modes."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.store import EmbeddingStore
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.jobstate import JobStateManager
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.testing import SyntheticClickDataset
    from persia_tpu_torch.weights import (
        batch_stats_to_flax, seeded_flax_params_like, state_dict_from_flax, train_state_to_flax_bytes,
    )

    r = DNN_RESUME
    print(f"== phase 4j (c): DNN kill and resume (bench.py:936-960: DNN(8, 16, (32,)), 2 slots, B={r['batch']}, "
          f"{r['steps']} steps, a snapshot every {r['every']}, killed after {r['kill']})", flush=True)
    cfg = dnn_cfg(2, 8)
    batches = list(SyntheticClickDataset(num_samples=r["steps"] * r["batch"], vocab_sizes=(64, 32), seed=9)
                   .batches(r["batch"]))[:r["steps"]]
    model0 = DNN(5, [8, 8], 8, 16, (32,), device="cpu")
    sd = state_dict_from_flax(model0, seeded_flax_params_like(model0, SEED))

    def make_ctx(stores):
        model = DNN(5, [8, 8], 8, 16, (32,), device="cpu")
        model.load_state_dict(sd)
        return TrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1),
                        EmbeddingWorker(cfg, stores), cfg, device=dev).__enter__()

    def make_stores():
        return [EmbeddingStore(capacity=1 << 16, num_internal_shards=4, seed=7) for _ in range(2)]

    def dumps(stores):
        return [st.dump_shard(i) for st in stores for i in range(st.num_internal_shards)]

    base_stores = make_stores()
    base = make_ctx(base_stores)
    for b in batches:
        base.train_step(b)
    want_bytes, want_dumps = train_state_to_flax_bytes(base.state), dumps(base_stores)
    out, launches = {}, {}
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    try:
        for mode, restore_ps in (("rewind", True), ("journal", False)):
            mgr = JobStateManager(str(STATE_DIR / f"dnn_{mode}"))
            stores = make_stores()
            ctx1 = make_ctx(stores)
            ctx1.resume(mgr)
            for i in range(r["kill"]):
                ctx1.train_step(batches[i])
                if (i + 1) % r["every"] == 0:
                    ctx1.snapshot_job(mgr)
            del ctx1  # the trainer dies; the PS stores survive
            t0 = time.perf_counter()
            ctx2 = make_ctx(stores)
            m = ctx2.resume(mgr, restore_ps=restore_ps)
            resume_s = time.perf_counter() - t0
            ops.reset_launch_counts()
            for i in range(m.step, r["steps"]):
                ctx2.train_step(batches[i])
            torch.cuda.synchronize()
            launches[mode] = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
            replayed = r["steps"] - m.step
            check_launches(f"DNN resume ({mode})", launches[mode], bn_launches_expected(
                ops, batch_norm_fwd=2 * replayed, batch_norm_bwd=2 * replayed))
            router = ctx2.worker.lookup_router
            out[mode] = {"time_to_resume_s": resume_s, "resumed_at_step": m.step, "steps_replayed": replayed,
                         "journal_skips": router.journal_skips}
            if mode == "rewind":
                same_dense = train_state_to_flax_bytes(ctx2.state) == want_bytes
                same_ps = dumps(stores) == want_dumps
                stats = batch_stats_to_flax(ctx2.model)
                moved = all(not np.array_equal(v["var"], np.ones_like(v["var"])) for v in stats.values())
                out[mode].update(dense_bytes_equal=same_dense, ps_dumps_equal=same_ps)
                print(f"  rewind: resumed at step {m.step} in {resume_s:.4f} s, {replayed} steps replayed; dense "
                      f"bytes (params, batch_stats, Adam) equal to the uninterrupted run's: {same_dense}; every PS "
                      f"shard's dump equal: {same_ps}; batch_stats moved from flax's start: {moved}", flush=True)
                if not (same_dense and same_ps and moved):
                    raise SystemExit("DNN rewind resume: not bit for bit the uninterrupted run")
            else:
                applied = r["kill"] - m.step  # replayed steps the crashed run had applied
                print(f"  journal: resumed at step {m.step} in {resume_s:.4f} s, {replayed} steps replayed, "
                      f"{applied} of them applied before the crash; journal_skips {router.journal_skips}", flush=True)
                if router.journal_skips < applied:
                    raise SystemExit("DNN journal resume: a step the crashed run applied was applied again")
    finally:
        shutil.rmtree(STATE_DIR, ignore_errors=True)
    return {"dnn_resume": launches["rewind"]}, out


def path_dnn(dev):
    """Phase 4j: DNN with its batch statistics (a, b, c)."""
    adult_launches, adult = path_adult(dev)
    hybrid_launches, hybrid = path_dnn_hybrid(dev)
    resume_launches, resume = path_dnn_resume(dev)
    return ({"dnn_adult": adult_launches, **hybrid_launches, **resume_launches},
            {"adult_income": adult, **hybrid, "resume": resume})


# ---------------------------------------------------------------------------
# The cache tier (persia_tpu_torch/embedding/hbm_cache) at bench.py's cached
# configuration (bench.py:285-344): phases 3e and 4k, and its kernels' rows
# of phase 5

CACHE_SOURCE = {"cache_aux": "persia_tpu_torch/csrc/cache_aux.cu",
                "gather_entry_rows": "persia_tpu_torch/csrc/cache_aux.cu",
                "cached_gather": "persia_tpu_torch/csrc/cached_gather.cu"}
CACHE_REPLACES = {"cache_aux": "persia_tpu/embedding/hbm_cache/groups.py:260",
                  "gather_entry_rows": "persia_tpu/embedding/hbm_cache/groups.py:240",
                  "cached_gather": "persia_tpu/embedding/hbm_cache/step.py:154"}
# K12 also carries the stream's in-flight restores (the reference's
# _restore_rows) in its one launch
K12_ALSO_REPLACES = "persia_tpu/embedding/hbm_cache/groups.py:250"
# the two regimes: the fill (2^21 rows, CACHE_FILL_STEPS steps) and the
# saturated cache (2^18 rows, run until the last CACHE_SAT_TAIL steps all
# evict; at most CACHE_SAT_MAX steps); CACHE_PROFILED steps of each under
# the profiler; the SGD twin of the hybrid tier: its steps
CACHE_FILL_ROWS, CACHE_SAT_ROWS = 1 << 21, 1 << 18
CACHE_FILL_STEPS, CACHE_SAT_TAIL, CACHE_SAT_MAX, CACHE_PROFILED, CACHE_SGD_STEPS = 16, 16, 120, 3, 4
CACHE_KERNELS = ("cache_aux", "gather_entry_rows", "cached_gather")
# the stream at bench.py's knobs (bench.py:466-522 and train_stream's
# defaults), and the stage-pipelined stream at bench_cached_pipelined's
# (bench.py:525-574: depth 4 from BENCH_PIPE_AB_DEPTH, dispatch_k 8)
STREAM_KNOBS = dict(dispatch_k=8, pipeline_depth=1, fetch_final=False, prefetch=3, wb_flush_steps=8)
PIPELINED_KNOBS = dict(STREAM_KNOBS, pipeline_depth=4)
# the fenced legs (saturated regime, over the same timed batches): the
# in-order stream and the pipelined one at STREAM_KNOBS / PIPELINED_KNOBS
# with a fence every FENCE_EVERY steps committing a manifest; a run dropped
# one step past its second fence and a ctx resumed from it. DNN on the cache
# tier (phase 4j's width): DNN_CACHE_STEPS steps through the stream, one
# fence (at DNN_CACHE_EVERY), DNN_CACHE_ROWS rows
FENCE_EVERY = 16
DNN_CACHE_STEPS, DNN_CACHE_EVERY, DNN_CACHE_ROWS = 8, 4, 1 << 16
CACHE_PATHS = ("cache_fill", "cache_saturated", "cache_stream_fill", "cache_stream_saturated",
               "cache_pipelined_fill", "cache_pipelined_saturated", "cache_fenced_saturated",
               "cache_killed_saturated", "cache_resumed_saturated", "cache_fenced_pipelined_saturated",
               "dnn_cache")


def to_cpu(case):
    """A kernel case's copy on the CPU (tensors, and dicts and tuples of
    them)."""
    import torch

    return {k: (v.cpu().clone() if torch.is_tensor(v) else
                {kk: vv.cpu().clone() for kk, vv in v.items()} if isinstance(v, dict) else
                tuple(t.cpu().clone() for t in v) if isinstance(v, tuple) and v and torch.is_tensor(v[0]) else v)
            for k, v in case.items()}


def bits_equal(a, b) -> bool:
    import torch

    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def phase_cache_kernels(dev):
    """Phase 3e: K12 (with and without restores) and K13 against their
    plain versions (on the CPU)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.cache_aux import (
        cache_aux_reference, cache_aux_ring_reference, gather_entry_rows_reference,
    )
    from persia_tpu_torch.ops.cached_gather import cached_gather_reference
    from persia_tpu_torch.testing.cache_cases import all_pads, aux_case, gather_case

    print("== phase 3e: cache-tier kernels (K12 cache_aux, its restores included, and K13 cached_gather) vs their "
          "plain versions", flush=True)
    errs = {}

    def aux_check(label, case, wb_bf16, ring_pos=None):
        cpu = to_cpu(case)
        ring = rring = None
        if ring_pos is not None:  # a seeded ring of the payload's rows + 1000
            width = case["table"].shape[1] + sum(v.shape[1] for v in case["state"].values())
            rring = torch.randn((case["ev_rows"].shape[0] + 1000, width),
                                generator=torch.Generator().manual_seed(SEED + 32)).to(
                torch.bfloat16 if wb_bf16 else torch.float32)
            ring = rring.to(dev)
        pay = ops.cache_aux(**case, wb_bf16=wb_bf16, ring=ring, ring_pos=ring_pos or 0)
        if ring is None:
            ref = cache_aux_reference(**cpu, wb_bf16=wb_bf16)
        else:
            ref = cache_aux_ring_reference(ring=rring, ring_pos=ring_pos, **cpu, wb_bf16=wb_bf16)
        ok = (bits_equal(pay, ref) and bits_equal(case["table"], cpu["table"])
              and all(bits_equal(case["state"][k], cpu["state"][k]) for k in cpu["state"])
              and (ring is None or bits_equal(ring, rring)))
        err = max([float((pay.float().cpu() - ref.float()).abs().max()) if pay.numel() else 0.0,
                   float((case["table"].cpu() - cpu["table"]).abs().max())])
        claimed = int((case["m_slot"] >= 0).sum()) + int((case["c_slot"] >= 0).sum())
        print(f"  cache_aux {label}: payload {tuple(pay.shape)} {str(pay.dtype)[6:]}, warm {case['m_rows'].numel()}, "
              f"cold {case['c_rows'].numel()} (padded), {claimed} writes on evicted rows"
              f"{'' if ring is None else f', ring from {ring_pos}'}: max_abs_err={err:.3e} tolerance=0 (bitwise) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"cache_aux {label} disagrees with its plain version")
        errs["cache_aux"] = max(errs.get("cache_aux", 0.0), err)

    # the saturated regime's pool (2^18 rows, dim 16) and a step's pieces
    # at its scale: ~8k evictions, as many misses, none, half or each on an
    # evicted row
    reuses = {0: "misses apart", 0.5: "half the misses on evicted rows", 1: "every miss on an evicted row"}
    for kind in ("sgd", "adagrad", "adagrad_vw", "adam"):
        for aux_bf16, wb_bf16 in ((False, False), (True, True), (True, False)):
            for reuse, what in reuses.items():
                case = aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 7700, 4600, 3100, reuse, aux_bf16, dev,
                                seed=SEED + len(kind) + 2 * aux_bf16 + int(4 * reuse))
                aux_check(f"{kind} aux_wire={'bf16' if aux_bf16 else 'f32'} wb_wire={'bf16' if wb_bf16 else 'f32'} "
                          f"{what}", case, wb_bf16)
    # the ring: a start that fits, one the clamp moves, a negative one
    for kind, wires in (("adagrad", True), ("adam", False), ("adagrad_vw", True)):
        for ring_pos in (500, 10 ** 6, -700):
            case = aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 7700, 500, 7200, 0.5, wires, dev, seed=SEED + ring_pos % 89)
            aux_check(f"{kind} wires={'bf16' if wires else 'f32'} half the misses on evicted rows", case, wires,
                      ring_pos=ring_pos)
    aux_check("every row a pad", all_pads(aux_case("adagrad", CACHE_SAT_ROWS, EMB_DIM, 300, 200, 100, False, True, dev,
                                                   seed=SEED + 30), CACHE_SAT_ROWS), True)
    aux_check("no rows", aux_case("adam", CACHE_SAT_ROWS, EMB_DIM, 0, 0, 0, False, False, dev, seed=1), False)
    aux_check("only writes", aux_case("adagrad", CACHE_SAT_ROWS, EMB_DIM, 0, 300, 200, False, True, dev, seed=2), True)
    # one call is one kernel on the card, ring and all (torch.profiler)
    case = aux_case("adagrad", CACHE_SAT_ROWS, EMB_DIM, 7820, 500, 7320, 1, True, dev, seed=SEED + 33)
    ring = torch.empty((2 * case["ev_rows"].shape[0], 2 * EMB_DIM), dtype=torch.bfloat16, device=dev)
    torch.cuda.synchronize()
    for _ in range(3):  # a trace can lose its device records: trace again
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            ops.cache_aux(**case, wb_bf16=True, ring=ring, ring_pos=3)
            torch.cuda.synchronize()
        traced = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
        if traced:
            break
    print(f"  cache_aux: one call (7,820 evictions, every miss on an evicted row, bf16, with the ring) ran "
          f"{len(traced)} kernel(s) on the card: {traced}", flush=True)
    if len(traced) != 1 or "cache_aux_kernel" not in traced[0]:
        raise SystemExit(f"one cache_aux call ran {traced}, not one cache_aux_kernel")
    # (a) alone in f32: the flush's read of every resident row
    rows = torch.randperm(CACHE_SAT_ROWS + 1, generator=torch.Generator().manual_seed(2))[:CACHE_SAT_ROWS].int()
    for kind in ("adagrad", "adagrad_vw", "adam", "sgd"):
        case = aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 1, 0, 0, False, False, dev, seed=SEED + 31)
        got = ops.gather_entry_rows(case["table"], case["state"], rows.to(dev))
        ref = gather_entry_rows_reference(case["table"].cpu(), {k: v.cpu() for k, v in case["state"].items()}, rows)
        ok = bits_equal(got, ref)
        print(f"  gather_entry_rows {kind} ({rows.numel()} rows, {tuple(got.shape)}): tolerance=0 (bitwise) "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"gather_entry_rows ({kind}) disagrees with its plain version")
    errs["gather_entry_rows"] = 0.0

    # K12 with the stream's restores in its one launch, at a saturated
    # stream step's scale (700 restores from a 2^19-row ring into the
    # 2^18-row pool beside 7,700 evictions and 7,000 warm and cold misses,
    # half of all misses on rows evicted that step), every optimizer, both
    # rings (the aux wire alternating), the payload stored into the ring;
    # every restore a pad; no restores; a second call restoring from the
    # span the first filled, onto rows the first wrote
    def restores_check(label, case, wb_bf16, store=True):
        cpu = to_cpu(case)
        ring_pos = case.pop("ring_pos")
        cpu.pop("ring_pos")
        rring = cpu.pop("ring")
        before = ops.cache_aux.launches
        pay = ops.cache_aux(**case, wb_bf16=wb_bf16, ring_pos=ring_pos if store else None)
        if store:
            ref = cache_aux_ring_reference(ring=rring, ring_pos=ring_pos, **cpu, wb_bf16=wb_bf16)
        else:
            ref = cache_aux_reference(**cpu, ring=rring, wb_bf16=wb_bf16)
        ok = (ops.cache_aux.launches == before + 1 and bits_equal(pay, ref) and bits_equal(case["ring"], rring)
              and bits_equal(case["table"], cpu["table"])
              and all(bits_equal(case["state"][k], cpu["state"][k]) for k in cpu["state"]))
        err = max([float((pay.float().cpu() - ref.float()).abs().max()) if pay.numel() else 0.0,
                   float((case["table"].cpu() - cpu["table"]).abs().max())])
        r_dst, r_slot = case["restores"][1], case["restores"][2]
        live = int((r_dst < case["table"].shape[0]).sum())
        print(f"  cache_aux with restores, {label}: {live} live restores of {r_dst.numel()} "
              f"({int((r_slot >= 0).sum())} on rows evicted this step), ring {tuple(case['ring'].shape)} "
              f"{str(case['ring'].dtype)[6:]}{' from ' + str(ring_pos) if store else ' (read only)'}, warm "
              f"{case['m_rows'].numel()}, cold {case['c_rows'].numel()}, evicted {case['ev_rows'].numel()} (padded), "
              f"aux wire {str(case['m_entries'].dtype)[6:]}: max_abs_err={err:.3e} tolerance=0 (bitwise), "
              f"{ops.cache_aux.launches - before} launch {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"cache_aux with restores ({label}) disagrees with its plain version")
        errs["cache_aux"] = max(errs["cache_aux"], err)

    for i, kind in enumerate(("sgd", "adagrad", "adagrad_vw", "adam")):
        for bf16 in (False, True):
            restores_check(f"{kind} ring={'bf16' if bf16 else 'f32'}",
                           aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 7700, 3800, 3200, 0.5, (i + bf16) % 2 == 1, dev,
                                    seed=SEED + 50 + len(kind) + bf16, n_restore=700, ring_rows=1 << 19,
                                    wb_bf16=bf16, ring_pos=(1 << 18) + 100 * i), bf16)
    restores_check("every restore a pad", all_pads(
        aux_case("adagrad", CACHE_SAT_ROWS, EMB_DIM, 300, 200, 100, 0.5, True, dev, seed=SEED + 51, n_restore=100,
                 ring_rows=4096, wb_bf16=True, ring_pos=40), CACHE_SAT_ROWS), True)
    restores_check("no restores (0 rows)", aux_case("adam", CACHE_SAT_ROWS, EMB_DIM, 7700, 3800, 3200, 0.5, False, dev,
                                                    seed=SEED + 52, ring_rows=1 << 14, wb_bf16=False), False)
    # two calls: the first fills the ring's span from 40; the second evicts
    # elsewhere (its span from 9,000) and restores 300 rows from the first
    # span, 100 of them onto rows the first call wrote, 150 onto rows it
    # evicts itself
    first = aux_case("adagrad", CACHE_SAT_ROWS, EMB_DIM, 7700, 500, 7200, 0.5, True, dev, seed=SEED + 53)
    acpu = to_cpu(first)
    ring = torch.zeros((1 << 14, 2 * EMB_DIM), dtype=torch.bfloat16, device=dev)
    rring = ring.cpu().clone()
    ops.cache_aux(**first, wb_bf16=True, ring=ring, ring_pos=40)
    cache_aux_ring_reference(ring=rring, ring_pos=40, **acpu, wb_bf16=True)
    second = aux_case("adagrad", CACHE_SAT_ROWS, EMB_DIM, 400, 0, 0, 0.5, True, dev, seed=SEED + 54, n_restore=300,
                      ring_rows=1 << 14, wb_bf16=True, ring_pos=9000)
    src = torch.zeros(512, dtype=torch.int32)
    src[:300] = 40 + torch.randperm(7700, generator=torch.Generator().manual_seed(4))[:300].int()
    dst, slot = second["restores"][1].cpu().clone(), second["restores"][2].cpu().clone()
    taken = set(second["ev_rows"].cpu().tolist()) | set(dst.tolist())
    written = [r for r in acpu["m_rows"][:500].tolist() if r not in taken][:100]
    on_written = (slot[:300] < 0).nonzero().flatten()[:len(written)]
    dst[on_written] = torch.tensor(written, dtype=torch.int32)
    second.update(table=first["table"], state=first["state"], ring=ring,
                  restores=(src.to(dev), dst.to(dev), slot.to(dev)))
    cpu2 = to_cpu(second)
    cpu2.update(table=acpu["table"], state=acpu["state"])
    before = ops.cache_aux.launches
    ops.cache_aux(**{k: v for k, v in second.items() if k != "ring_pos"}, wb_bf16=True, ring_pos=9000)
    cache_aux_ring_reference(ring=rring, ring_pos=9000, **{k: v for k, v in cpu2.items() if k not in
                                                           ("ring", "ring_pos")}, wb_bf16=True)
    ok = (ops.cache_aux.launches == before + 1 and bits_equal(first["table"], acpu["table"]) and bits_equal(ring, rring)
          and all(bits_equal(first["state"][k], acpu["state"][k]) for k in acpu["state"]))
    print(f"  cache_aux with restores, two calls: 300 restores from the span the first call filled ({len(written)} "
          f"onto rows it wrote, {int((slot >= 0).sum())} onto rows the second evicts): tolerance=0 (bitwise) "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("cache_aux restoring from an earlier call's ring span disagrees with its plain versions")

    # K13: the bench's shape (26 slots x 4096, L=1) on a 2^21 pool with zipf
    # rows, the saturated pool with scales, eval misses; L > 1 with and
    # without scales (an f32 sum in another order: within (L - 1) * 2^-23 *
    # sum |x| * |scale|), eval at L > 1, raw rows
    errs["cached_gather"] = 0.0
    for S, L, C, scale, miss, zipf in ((N_SLOTS, 1, CACHE_FILL_ROWS, False, 0, True),
                                       (N_SLOTS, 1, CACHE_SAT_ROWS, True, 0, True),
                                       (N_SLOTS, 1, CACHE_SAT_ROWS, False, 4000, False),
                                       (4, 4, CACHE_SAT_ROWS, True, 0, False),
                                       (4, 8, CACHE_SAT_ROWS, False, 0, True),
                                       (4, 8, CACHE_SAT_ROWS, True, 1000, False)):
        case = gather_case(S, BATCH, L, C, EMB_DIM, dev, seed=SEED + 40 + L + miss, scale=scale, miss=miss, zipf=zipf)
        cpu = to_cpu(case)
        keys = miss == 0
        sc, mt = case.get("scale"), case.get("miss_table")
        got = ops.cached_gather(case["table"], case["rows"], True, sc, keys=keys, miss_table=mt)
        ref = cached_gather_reference(cpu["table"], cpu["rows"], True, cpu.get("scale"), keys=keys,
                                      miss_table=cpu.get("miss_table"))
        pooled, rpooled = (got[0], ref[0]) if keys else (got, ref)
        err = float((pooled.cpu() - rpooled).abs().max())
        if L == 1:
            ok, tol = bits_equal(pooled, rpooled), "0 (bitwise)"
        else:
            bound_ = cached_gather_reference(cpu["table"].abs(), cpu["rows"], True,
                                             cpu["scale"].abs() if scale else None,
                                             miss_table=cpu["miss_table"].abs() if miss else None)
            ok = bool(((pooled.cpu() - rpooled).abs() <= (L - 1) * 2.0 ** -23 * bound_).all())
            tol = f"(L - 1) * 2^-23 * sum|x| * |scale| (at most {float(((L - 1) * 2.0 ** -23 * bound_).max()):.3e})"
        if keys:
            ok = ok and bits_equal(got[1], ref[1])
        raw = ops.cached_gather(case["table"], case["rows"][0].contiguous(), False, keys=keys, miss_table=mt)
        rraw = cached_gather_reference(cpu["table"], cpu["rows"][0], False, keys=keys, miss_table=cpu.get("miss_table"))
        ok = ok and all(bits_equal(a, b) for a, b in zip(raw, rraw))
        pads = int((cpu["rows"] == C).sum())
        print(f"  cached_gather S={S} B={BATCH} L={L} C={C} scale={scale} eval misses={miss} ({pads} pads): "
              f"max_abs_err={err:.3e} tolerance={tol}; keys, raw rows and mask bitwise {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit("cached_gather disagrees with its plain version")
        errs["cached_gather"] = max(errs["cached_gather"], err)
    torch.cuda.empty_cache()
    return errs


def cache_ctx(device, rows, store, sd, sparse="adagrad", wires="bfloat16", touches=2, **options):
    """``_cached_tier_ctx``'s ctx (bench.py:285-344) through the builder the
    quality gate shares (``testing.quality.tier_ctx``): DLRM at bench width
    from ``sd``, Adam(1e-3), Adagrad(0.05) (or SGD(0.05)), the bf16 wires
    and the touch gate, over ``store``; ``options`` to ``CachedTrainCtx``
    (the sharded feeder's)."""
    from persia_tpu_torch.testing.quality import bench_model, tier_ctx

    return tier_ctx(device, store, cache_rows=rows, wires=wires, admit_touches=touches, sparse=sparse,
                    model=bench_model(state_dict=sd), **options)


def cache_store(sparse="adagrad"):
    from persia_tpu_torch.embedding.optim import SGD, Adagrad

    opt = Adagrad(lr=0.05) if sparse == "adagrad" else SGD(lr=0.05)
    return make_store("native", capacity=1 << 25, num_internal_shards=64, optimizer=opt.config, seed=1)


def cache_recorder(ctx):
    """Shadow the tier's ``prepare_batch``: per step, a digest of what the
    directory decided and the tier staged (the row matrices, the warm,
    cold and evicted rows, the evicted signs, K12's pairing, the restores),
    a digest of the directory's decisions alone (the row matrices, the cold
    rows, the warm and restored rows together: a re-miss is restored from
    the ring or read from the server depending on when its write-back
    lands; the evicted rows and signs), and the step's counts."""
    import hashlib

    steps = []
    tier = ctx.tier
    inner = tier.prepare_batch
    C = tier.groups[0].rows

    def live(r):
        r = np.asarray(r)
        return r[r < C + 1]

    def wrapped(batch, **kw):
        before = tier.counts()
        out = inner(batch, **kw)
        inputs, _layout, miss, cold, restore, ev, meta = out
        h, d = hashlib.sha256(), hashlib.sha256()
        for g in sorted(inputs["stacked_rows"]):
            rows = np.ascontiguousarray(inputs["stacked_rows"][g]).tobytes()
            h.update(rows)
            d.update(rows)
        for dd in (miss, cold):
            for g in sorted(dd):
                h.update(np.asarray(dd[g][0]).tobytes())
                h.update(dd[g][2].tobytes())
        for g in sorted(restore):
            for a in restore[g]:  # ring rows, table rows, payload slots
                h.update(a.tobytes())
        for g in sorted(ev):
            h.update(ev[g][0].tobytes())
            h.update(ev[g][1].tobytes())
            h.update(meta[g][0].tobytes())
            d.update(ev[g][0].tobytes())
            d.update(meta[g][0].tobytes())
        for g in sorted(set(miss) | set(cold) | set(restore)):
            d.update(g.encode())
            d.update(live(cold[g][0]).tobytes() if g in cold else b"")
            back = [live(miss[g][0])] if g in miss else []
            back += [live(restore[g][1])] if g in restore else []
            d.update(np.sort(np.concatenate(back)).astype(np.int64).tobytes() if back else b"")
        after = tier.counts()
        steps.append(dict(
            digest=h.hexdigest(), decisions=d.hexdigest(), touched=bool(miss or cold or ev or restore),
            warm=sum(int((np.asarray(r) < C + 1).sum()) for r, *_ in miss.values()),
            cold=sum(int((np.asarray(r) < C + 1).sum()) for r, *_ in cold.values()),
            restored=sum(int((np.asarray(dst) < C + 1).sum()) for _src, dst, _slot in restore.values()),
            **{k: after[k] - before[k] for k in after}))
        return out

    tier.prepare_batch = wrapped
    return steps


def run_cache_regime(dev, regime, rows, sd):
    """One regime on the card, counted, then on the CPU: returns (launches,
    record, the kernels' inputs for phase 5)."""
    import torch

    from persia_tpu_torch import ops

    fixed = CACHE_FILL_STEPS if regime == "fill" else None
    print(f"== phase 4k ({regime}): the cache tier at bench width ({rows} rows, B={BATCH}, "
          f"{'%d steps' % fixed if fixed else 'until the last %d steps all evict' % CACHE_SAT_TAIL}, "
          f"CachedTrainCtx.train_step)", flush=True)
    make = zipf_batch_maker(SEED + 60, labels=True)
    store = cache_store()
    ctx = cache_ctx(dev, rows, store, sd)
    rec = cache_recorder(ctx)
    stages = {k: [] for k in ("prepare_batch", "staging", "aux", "main_step", "write_back")}
    undo = [timed_calls(ctx.tier, "prepare_batch", stages["prepare_batch"], []),
            timed_calls(ctx, "_stage", stages["staging"], []), timed_calls(ctx, "_apply_feed", stages["aux"], []),
            timed_calls(ctx, "_step", stages["main_step"], []),
            timed_calls(ctx, "_write_back_only", stages["write_back"], [])]
    last = {}
    feed = ctx._apply_feed

    def keep_feed(miss, cold, ev, meta=None):  # the last step's aux pieces, for phase 5
        last["aux"] = (miss, cold, ev)
        return feed(miss, cold, ev, meta)

    ctx._apply_feed = keep_feed
    step_fn = ctx._step

    def keep_step(state, inputs, layout):
        last["rows"] = inputs["stacked_rows"]
        return step_fn(state, inputs, layout)

    ctx._step = keep_step
    batches, headers, step_ms = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    per_step = {k: [] for k in stages}  # each stage's ms in each timed step
    make_s = 0.0  # the synthetic batches' making, inside the loop but no part of a step
    while True:
        t = time.perf_counter()
        batches.append(make())
        make_s += time.perf_counter() - t
        marks = {k: len(v) for k, v in stages.items()}
        t = time.perf_counter()
        ctx.train_step(batches[-1], fetch_metrics=False)
        step_ms.append((time.perf_counter() - t) * 1e3)
        for k, v in stages.items():
            per_step[k].append(sum(v[marks[k]:]))
        headers.append(ctx._pending[3])
        n = len(batches)
        if fixed is not None and n == fixed:
            break
        if fixed is None and n >= CACHE_SAT_TAIL and all(s["evictions"] > 0 for s in rec[-CACHE_SAT_TAIL:]):
            break
        if n >= CACHE_SAT_MAX:
            raise SystemExit(f"cache path ({regime}): no steady eviction after {n} steps")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed_steps = len(batches)
    # the card's busy time a step and its largest kernels (torch.profiler)
    prof = [make() for _ in range(CACHE_PROFILED)]

    def profiled(b):
        ctx.train_step(b, fetch_metrics=False)
        headers.append(ctx._pending[3])

    busy, top_kernels, _ = device_busy_ms(profiled, prof)
    batches += prof
    # eval changes nothing of the directory
    d = ctx.tier.dirs["cache_d16"]
    n0, snap0 = len(d), d.snapshot()
    preds = ctx.eval_batch(zipf_batch_maker(SEED + 61)())
    snap1 = d.snapshot()
    if len(d) != n0 or not (np.array_equal(snap0[0], snap1[0]) and np.array_equal(snap0[1], snap1[1])):
        raise SystemExit(f"cache path ({regime}): eval_batch changed the directory")
    if preds.shape != (BATCH, 1) or not np.isfinite(preds).all():
        raise SystemExit(f"cache path ({regime}): eval predictions {preds.shape}, finite {np.isfinite(preds).all()}")
    # the flush's inputs and the live pool, for phase 5, before the flush
    # zeroes it
    inputs = {"table": ctx.state.tables["cache_d16"].clone(),
              "state": {k: v.clone() for k, v in ctx.state.emb_state["cache_d16"].items()},
              "aux": last["aux"], "rows": last["rows"]["cache_d16"], "consts": ctx._state_consts,
              "flush_rows": snap0[1]}
    ctx.flush()
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated(dev)
    for u in undo:
        u()
    steps = len(batches)
    touched = sum(s["touched"] for s in rec)
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(cached_gather=steps + 1, cache_aux=touched, gather_entry_rows=1, sparse_update=steps,
                    dot_interaction=steps + 1, dot_interaction_bwd=steps)
    print(f"  launches={launches} over {steps} steps, an eval batch and a flush", flush=True)
    if launches != expected:
        raise SystemExit(f"cache path ({regime}): launches {launches}, expected {expected}")
    losses = [float(h[0]) for h in headers]
    if not all(np.isfinite(losses)):
        raise SystemExit(f"cache path ({regime}): losses {losses}")

    # the same batches on the CPU port (the same host code; bf16 rounds at
    # other points there)
    t1 = time.perf_counter()
    cpu_store = cache_store()
    cpu = cache_ctx("cpu", rows, cpu_store, sd)
    crec = cache_recorder(cpu)
    cpu_losses = [cpu.train_step(b)["loss"] for b in batches]
    cpu.flush()
    cpu_s = time.perf_counter() - t1
    same = [a["digest"] == b["digest"] for a, b in zip(rec, crec)]
    if len(rec) != len(crec) or not all(same):
        raise SystemExit(f"cache path ({regime}): the directory's decisions differ from the CPU's at steps "
                         f"{[i for i, s in enumerate(same) if not s]}")
    loss_err = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    signs = batch_keys(batches)
    warm_card, vals_card = store.probe_entries(signs, EMB_DIM)
    warm_cpu, vals_cpu = cpu_store.probe_entries(signs, EMB_DIM)
    if not np.array_equal(warm_card, warm_cpu) or store.size() != cpu_store.size():
        raise SystemExit(f"cache path ({regime}): the servers hold other signs ({store.size()} vs "
                         f"{cpu_store.size()})")
    row_err = float(np.abs(vals_card[warm_card] - vals_cpu[warm_cpu]).max())
    sync = {"batches": batches, "timed_steps": timed_steps, "decisions": [st["decisions"] for st in rec],
            "signs": signs, "warm": warm_card, "vals": vals_card,
            "samples_per_s": timed_steps * BATCH / (wall - make_s)}
    print(f"  directory decisions (row matrices, warm / cold / evicted rows, evicted signs) = the CPU's at every "
          f"one of {steps} steps; losses max_abs_err={loss_err:.3e} tolerance=2e-2; server entries after flush, "
          f"{int(warm_card.sum())} of the batches' {len(signs)} signs: max_abs_err={row_err:.3e} tolerance=1e-2 "
          f"(CPU run {cpu_s:.1f} s) {'ok' if loss_err <= 2e-2 and row_err <= 1e-2 else 'FAIL'}", flush=True)
    if loss_err > 2e-2 or row_err > 1e-2:
        raise SystemExit(f"cache path ({regime}): card and CPU disagree")
    timed = rec[:timed_steps]
    record = {
        "cache_rows": rows, "batch": BATCH, "steps": steps, "timed_steps": timed_steps,
        "samples_per_s": timed_steps * BATCH / (wall - make_s), "wall_s": wall - make_s,
        # as PRs 15-16 measured it: the wall with the batches' making in it
        "samples_per_s_with_batch_making": timed_steps * BATCH / wall, "batch_making_s": make_s,
        "step_ms_p50": float(np.percentile(step_ms, 50)), "step_ms_max": max(step_ms), "step_ms_all": step_ms,
        "stage_ms_p50": {k: float(np.percentile(v, 50)) for k, v in per_step.items()},
        "stage_ms_max": {k: max(v) for k, v in per_step.items()},
        "card_busy_ms_per_step": busy, "card_top_kernels_ms": top_kernels,
        # the steps that evicted (the saturated regime's tail) apart
        "stage_ms_p50_evicting": {k: float(np.percentile([v[i] for i, st in enumerate(timed) if st["evictions"]], 50))
                                  for k, v in per_step.items() if any(st["evictions"] for st in timed)},
        "hit_rate": sum(s["hits"] for s in timed) / max(1, sum(s["hits"] + s["misses"] for s in timed)),
        "misses_per_step": [s["misses"] for s in rec], "warm_per_step": [s["warm"] for s in rec],
        "cold_per_step": [s["cold"] for s in rec], "evictions_per_step": [s["evictions"] for s in rec],
        "resident_rows": n0, "launches": launches, "launches_expected": expected,
        "peak_device_bytes": peak, "losses": losses, "loss_max_abs_err_vs_cpu": loss_err,
        "ps_entry_max_abs_err_vs_cpu": row_err, "store_rows": store.size(),
    }
    print(f"  samples/s {record['samples_per_s']:.0f} (with the batches' making in the wall, as PRs 15-16 timed "
          f"it: {record['samples_per_s_with_batch_making']:.0f}), step p50 {record['step_ms_p50']:.2f} ms, longest "
          f"{record['step_ms_max']:.2f} ms (host, asynchronous), stage p50 ms "
          f"{ {k: round(v, 3) for k, v in record['stage_ms_p50'].items()} } (steps that evicted: "
          f"{ {k: round(v, 3) for k, v in record['stage_ms_p50_evicting'].items()} }), card busy "
          f"{record['card_busy_ms_per_step']} ms a step (largest: {top_kernels}), hit rate {record['hit_rate']:.4f}, misses a step "
          f"{record['misses_per_step'][-3:]}, evictions a step {record['evictions_per_step'][-3:]}, "
          f"peak device bytes {peak}", flush=True)
    del ctx, cpu
    return launches, record, inputs, sync


def run_cache_stream(dev, regime, rows, sd, sync, knobs=STREAM_KNOBS, inorder=None):
    """The stream at ``knobs`` in one regime, on the card, from a fresh ctx
    at the synchronous run's start over its batches (``sync``): the timed
    batches as one stream, counted; the rest as a second one under the
    profiler; its decisions checked against the synchronous run's, its
    servers' entries against the synchronous run's (1e-5 relative) or,
    for the pipelined leg (``inorder``: the in-order leg's result), bit for
    bit against the in-order stream's (else within 1e-5 relative).
    Returns (launches, record, the last restoring step's K12 pieces for
    phase 5 or None, (warm, vals) of the servers after flush)."""
    import torch

    from persia_tpu_torch import ops

    batches, timed_steps = sync["batches"], sync["timed_steps"]
    leg = "pipelined" if knobs["pipeline_depth"] > 1 else "stream"
    print(f"== phase 4k ({regime}, {leg}): CachedTrainCtx.train_stream({knobs}) over the synchronous "
          f"run's {len(batches)} batches from its start, a fresh ctx", flush=True)
    store = cache_store()
    ctx = cache_ctx(dev, rows, store, sd)
    rec = cache_recorder(ctx)
    last = {}
    dispatch = ctx._dispatch

    def keep_restore(inputs, layout, miss, cold, restore, ev, meta=None):  # for phase 5
        if restore:
            last["step"] = (miss, cold, restore, ev, meta)
        return dispatch(inputs, layout, miss, cold, restore, ev, meta)

    ctx._dispatch = keep_restore
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if ctx.train_stream(batches[:timed_steps], **knobs) is not None:
        raise SystemExit(f"cache {leg} ({regime}): fetch_final=False returned metrics")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    timed_stats = ctx.stream_stats()
    _, busy = device_busy_union_ms(lambda: ctx.train_stream(batches[timed_steps:], **knobs))
    prof_stats = ctx.stream_stats()
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    peak = torch.cuda.max_memory_allocated(dev)
    metrics = ctx.last_metrics()
    if metrics is None or not np.isfinite(metrics["loss"]) or metrics["preds"].shape != (BATCH, 1):
        raise SystemExit(f"cache {leg} ({regime}): the last step's metrics {metrics}")
    steps = len(batches)
    restore_steps = timed_stats["restore_steps"] + prof_stats["restore_steps"]
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(cached_gather=steps, cache_aux=sum(st["touched"] for st in rec), sparse_update=steps,
                    dot_interaction=steps, dot_interaction_bwd=steps)
    print(f"  launches={launches} over {steps} steps (K12 once a step that touched the pool, the {restore_steps} "
          f"restoring steps' restores inside it)", flush=True)
    if launches != expected:
        raise SystemExit(f"cache {leg} ({regime}): launches {launches}, expected {expected}")
    if regime == "saturated" and not restore_steps:
        raise SystemExit(f"cache {leg} (saturated): no step restored from the ring")
    same = [a == b for a, b in zip(sync["decisions"], (st["decisions"] for st in rec))]
    if len(rec) != steps or not all(same):
        raise SystemExit(f"cache {leg} ({regime}): the directory's decisions differ from the synchronous steps' "
                         f"at steps {[i for i, ok in enumerate(same) if not ok]}")
    inputs = None
    if "step" in last:
        miss, cold, restore, ev, meta = last["step"]
        g = "cache_d16"
        empty = torch.empty(0, dtype=torch.int32, device=dev)
        inputs = {"table": ctx.state.tables[g].clone(),
                  "state": {k: v.clone() for k, v in ctx.state.emb_state[g].items()},
                  "ring": ctx._ev_ring(g).clone(), "ring_pos": meta[g][2] if g in meta else None,
                  "miss": miss.get(g), "cold": cold.get(g), "ev": ev.get(g, (empty, empty)),
                  "restores": restore[g], "consts": ctx._state_consts}
    ctx.flush()
    warm, vals = store.probe_entries(sync["signs"], EMB_DIM)
    if not np.array_equal(warm, sync["warm"]):
        raise SystemExit(f"cache {leg} ({regime}): the servers hold other signs than after the synchronous run")
    rel = float((np.abs(vals[warm] - sync["vals"][warm]) / np.maximum(np.abs(sync["vals"][warm]), 1e-30)).max())
    ok = bool(np.allclose(vals[warm], sync["vals"][warm], rtol=1e-5, atol=1e-7))
    print(f"  directory decisions = the synchronous steps' at every one of {steps} steps; server entries after "
          f"flush, {int(warm.sum())} signs: max relative err {rel:.3e} vs the synchronous run (tolerance rtol 1e-5, "
          f"atol 1e-7) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"cache {leg} ({regime}): the server's entries differ from the synchronous run's")
    lanes = {k: timed_stats["lane_s"][k] for k in timed_stats["lane_s"]}
    record = {
        "knobs": knobs, "cache_rows": rows, "batch": BATCH, "steps": steps, "timed_steps": timed_steps,
        "samples_per_s": timed_steps * BATCH / wall, "sync_samples_per_s": sync["samples_per_s"], "wall_s": wall,
        "lane_s": lanes, "packs": timed_stats["packs"], "packed_steps": timed_stats["packed_steps"],
        "single_steps": timed_stats["single_steps"],
        "steps_per_pack": timed_stats["packed_steps"] / max(1, timed_stats["packs"]),
        "restore_steps": restore_steps, "restores_per_step": [st["restored"] for st in rec],
        "restored_rows_per_step": (timed_stats["restored_rows"] + prof_stats["restored_rows"]) / steps,
        "ring_waits": timed_stats["ring_waits"], "flushes": timed_stats["flushes"],
        "pipelined_feeds": timed_stats["pipelined_feeds"] + prof_stats["pipelined_feeds"],
        "pipeline_stalls": timed_stats["pipeline_stalls"] + prof_stats["pipeline_stalls"],
        "feed_leads": [a + b for a, b in zip(timed_stats["feed_leads"], prof_stats["feed_leads"])],
        "barrier_steps": restore_steps if knobs["pipeline_depth"] > 1 else 0,
        "stage_overlap_frac": timed_stats["stage_overlap_frac"], "stage_wall_s": timed_stats["stage_wall_s"],
        "launches_per_step": {k: launches[k] / steps for k in ("cache_aux", "cached_gather")},
        "launches": launches, "launches_expected": expected,
        "card_busy_ms_per_step": busy / len(batches[timed_steps:]) if busy is not None else None,
        "peak_device_bytes": peak, "ps_entry_max_rel_err_vs_sync": rel, "last_loss": float(metrics["loss"]),
    }
    if inorder is not None:
        warm0, vals0 = inorder["entries"]
        # the probe leaves a sign the servers lack unwritten: compare the held ones
        same_bits = np.array_equal(warm, warm0) and np.array_equal(vals[warm].view(np.uint32),
                                                                    vals0[warm].view(np.uint32))
        rel0 = float((np.abs(vals[warm] - vals0[warm]) / np.maximum(np.abs(vals0[warm]), 1e-30)).max())
        differ = float((vals[warm] != vals0[warm]).any(axis=1).mean()) if warm.any() else 0.0
        ok = same_bits or bool(np.allclose(vals[warm], vals0[warm], rtol=1e-5, atol=1e-7))
        record.update(speedup_vs_inorder=record["samples_per_s"] / inorder["record"]["samples_per_s"],
                      entries_bitwise_vs_inorder=bool(same_bits), ps_entry_max_rel_err_vs_inorder=rel0,
                      entries_differing_share_vs_inorder=differ,
                      last_loss_vs_inorder=record["last_loss"] - inorder["record"]["last_loss"])
        print(f"  decisions = the in-order stream's (both = the synchronous steps'); server entries after flush vs "
              f"the in-order stream's: {'bit for bit' if same_bits else f'{differ:.2%} of entries differ'}, max "
              f"relative err {rel0:.3e} (tolerance: bitwise, else rtol 1e-5) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"cache pipelined ({regime}): the servers' entries differ from the in-order stream's")
    vs = (f", in order {inorder['record']['samples_per_s']:.0f}: {record['speedup_vs_inorder']:.3f}x"
          if inorder else "")
    print(f"  {leg} samples/s {record['samples_per_s']:.0f} (synchronous {record['sync_samples_per_s']:.0f}{vs}"
          f"), lanes busy s {{{', '.join(f'{k}: {v:.3f}' for k, v in lanes.items())}}} of {wall:.3f} s wall, "
          f"stages busy s {record['stage_wall_s']}, stage_overlap_frac {record['stage_overlap_frac']}, "
          f"{record['packs']} packs ({record['steps_per_pack']:.2f} steps a pack, {record['single_steps']} single), "
          f"hoisted feeds {record['pipelined_feeds']} (by how many earlier dense stages they ran ahead of, 0 up: "
          f"{record['feed_leads']}), stalls {record['pipeline_stalls']}, barrier steps "
          f"{record['barrier_steps']}, restores a step {record['restored_rows_per_step']:.1f} ({restore_steps} "
          f"restoring steps), ring waits {record['ring_waits']}, K12/K13 launches a step "
          f"{record['launches_per_step']}, card busy {record['card_busy_ms_per_step']} ms a step, peak device bytes "
          f"{peak}", flush=True)
    del ctx
    return launches, record, inputs, (warm, vals)


def state_digest(ctx) -> str:
    """sha256 of the state's flax bytes (after a flush: the cold pools)."""
    import hashlib

    from persia_tpu_torch.weights import cached_state_to_flax_bytes

    return hashlib.sha256(cached_state_to_flax_bytes(ctx.state)).hexdigest()


def fenced_leg(dev, name, rows, sd, batches, knobs, root, start_step=0, store=None, resume=False):
    """One fenced stream leg on the card, counted from a fresh ctx (over
    ``store``, else a fresh one; ``resume``: resumed from ``root`` first):
    every fence's manifest read back by the fence callback (its cache.json
    and bytes). Returns (ctx, store, launches, record, the recorder)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.jobstate import JobStateManager

    store = store or cache_store()
    ctx = cache_ctx(dev, rows, store, sd)
    rec = cache_recorder(ctx)
    mgr = JobStateManager(str(root))
    record = {"leg": name, "knobs": dict(knobs), "steps": len(batches)}
    if resume:
        t0 = time.perf_counter()
        m = ctx.resume(mgr)
        torch.cuda.synchronize()
        record.update(resume_wall_s=time.perf_counter() - t0, resumed_at=m.step,
                      time_to_resume_s=ctx.last_resume_info["time_to_resume_s"],
                      ps_entries_restored=ctx.last_resume_info["ps_entries_restored"])
        start_step = m.step
        batches = batches[m.step:]
        record["steps"] = len(batches)
    manifests = []

    def read_manifest(step):
        m = mgr.latest()
        manifests.append({"step": step, "epoch": m.job_epoch, "cache": m.read_json("cache.json"),
                          "bytes": sum(int(c["bytes"]) for c in m.components.values()),
                          "ps_bytes": int(m.meta.get("ps_bytes", 0)),
                          "dense_bytes": int(m.components["dense.state"]["bytes"])})

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if ctx.train_stream(batches, start_step=start_step, job_state=mgr, fence_callback=read_manifest, **knobs):
        raise SystemExit(f"cache fenced ({name}): fetch_final=False returned metrics")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
    st = ctx.stream_stats()
    steps = len(batches)
    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(cached_gather=steps, cache_aux=sum(r["touched"] for r in rec), sparse_update=steps,
                    dot_interaction=steps, dot_interaction_bwd=steps, gather_entry_rows=st["fences"])
    if launches != expected:
        raise SystemExit(f"cache fenced ({name}): launches {launches}, expected {expected}")
    bad = [m for m in manifests if m["cache"]["pending_ledger_entries"] != 0
           or any(r["head"] != r["tail"] for r in m["cache"]["ring"].values())]
    if len(manifests) != st["fences"] or bad:
        raise SystemExit(f"cache fenced ({name}): {st['fences']} fences, manifests {manifests}")
    record.update(wall_s=wall, samples_per_s=steps * BATCH / wall, fences=st["fences"], fence_ms=st["fence_ms"],
                  manifests=manifests, global_step=ctx._global_step, launches=launches,
                  restore_steps=st["restore_steps"], pipelined_feeds=st["pipelined_feeds"],
                  pipeline_drains=st["pipeline_drains"], lane_s=st["lane_s"])
    parts = ("drain", "wb_drain", "flush", "ps_capture", "dense_bytes", "commit")
    print(f"  {name}: {steps} steps from global step {start_step}, {st['fences']} fences, samples/s "
          f"{record['samples_per_s']:.0f}, launches {launches}", flush=True)
    for f, m in zip(st["fence_ms"], manifests):
        print(f"    fence at step {m['step']} (epoch {m['epoch']}): stall {f['total']:.1f} ms = "
              + ", ".join(f"{k} {f[k]:.1f}" for k in parts)
              + f"; manifest {m['bytes']} bytes (PS {m['ps_bytes']}, dense {m['dense_bytes']}), resident rows "
              f"{m['cache']['resident_rows']}, pending ledger {m['cache']['pending_ledger_entries']}", flush=True)
    return ctx, store, launches, record, rec


def run_cache_fenced(dev, rows, sd, sync, inorder_record):
    """Phase 4k's fenced legs in the saturated regime over the synchronous
    run's timed batches: the in-order stream fenced every FENCE_EVERY steps
    (beside the unfenced in-order leg's samples/s), the same batches on the
    card's CPU as synchronous steps with a flush at each fence (the
    decisions), a run dropped one step past its second fence and a ctx
    resumed from its manifest (bit for bit the uninterrupted fenced run),
    and the pipelined stream with the same fences (bit for bit too).
    Returns ({path: launches}, record)."""
    import gc

    import torch

    batches = sync["batches"][:sync["timed_steps"]]
    n = len(batches)
    kill = 2 * FENCE_EVERY + 1
    if n <= kill:
        raise SystemExit(f"cache fenced: {n} batches leave no room for a second fence and a step past it")
    knobs = dict(STREAM_KNOBS, snapshot_every=FENCE_EVERY)
    pipe_knobs = dict(PIPELINED_KNOBS, snapshot_every=FENCE_EVERY)
    print(f"== phase 4k (saturated, fenced): train_stream({knobs}) into a job directory, over the synchronous run's "
          f"{n} timed batches, fresh ctxs; a run dropped after step {kill}, resumed; the pipelined stream fenced",
          flush=True)
    shutil.rmtree(STATE_DIR, ignore_errors=True)
    launches, out = {}, {}
    try:
        ctx, store, launches["cache_fenced_saturated"], out["fenced"], rec = fenced_leg(
            dev, "in order, fenced", rows, sd, batches, knobs, STATE_DIR / "fenced")
        ctx.flush()
        want = state_digest(ctx)
        warm, vals = store.probe_entries(sync["signs"], EMB_DIM)
        decisions = [r["decisions"] for r in rec]
        del ctx, store
        gc.collect()
        torch.cuda.empty_cache()
        out["fenced"]["unfenced_samples_per_s"] = inorder_record["samples_per_s"]
        out["fenced"]["vs_unfenced"] = out["fenced"]["samples_per_s"] / inorder_record["samples_per_s"]

        # the decisions: the same batches on the CPU port, synchronous steps
        # with a flush at every fence (what a fence does to the directory)
        t0 = time.perf_counter()
        cpu = cache_ctx("cpu", rows, cache_store(), sd)
        crec = cache_recorder(cpu)
        for i, b in enumerate(batches):
            if i and i % FENCE_EVERY == 0:
                cpu.flush()
            cpu.train_step(b, fetch_metrics=False)
        cpu.drain()
        cpu_decisions = [r["decisions"] for r in crec]
        del cpu
        same = [a == b for a, b in zip(decisions, cpu_decisions)]
        if len(decisions) != len(cpu_decisions) or not all(same):
            raise SystemExit(f"cache fenced: the directory's decisions differ from the CPU port's at steps "
                             f"{[i for i, ok in enumerate(same) if not ok]}")
        print(f"  directory decisions = the CPU port's (synchronous steps, a flush at each fence) at every one of "
              f"{n} steps (CPU run {time.perf_counter() - t0:.1f} s)", flush=True)

        _ctx1, killed_store, launches["cache_killed_saturated"], out["killed"], _ = fenced_leg(
            dev, f"dropped after step {kill}", rows, sd, batches[:kill], knobs, STATE_DIR / "killed")
        del _ctx1  # the trainer dies; its servers survive
        gc.collect()
        ctx, _, launches["cache_resumed_saturated"], out["resumed"], rrec = fenced_leg(
            dev, "resumed", rows, sd, batches, knobs, STATE_DIR / "killed", store=killed_store, resume=True)
        out["resumed"]["steps_replayed"] = kill - out["resumed"]["resumed_at"]
        ctx.flush()
        got = state_digest(ctx)
        rwarm, rvals = killed_store.probe_entries(sync["signs"], EMB_DIM)
        rdec = [r["decisions"] for r in rrec]
        # the probe leaves a sign the servers lack unwritten: compare the held ones
        resumed_ok = (got == want and np.array_equal(rwarm, warm)
                      and np.array_equal(rvals[warm].view(np.uint32), vals[warm].view(np.uint32))
                      and rdec == decisions[out["resumed"]["resumed_at"]:])
        print(f"  resumed from step {out['resumed']['resumed_at']} (time_to_resume_s "
              f"{out['resumed']['time_to_resume_s']}, resume() {out['resumed']['resume_wall_s']:.3f} s, "
              f"{out['resumed']['ps_entries_restored']} entries restored, {out['resumed']['steps_replayed']} steps "
              f"replayed): state bytes sha256 {got[:16]} vs uninterrupted {want[:16]}, servers' entries of "
              f"{int(warm.sum())} signs {'bit for bit' if resumed_ok else 'DIFFER'}", flush=True)
        if not resumed_ok:
            raise SystemExit("cache fenced: the resumed run is not bit for bit the uninterrupted fenced run")
        del ctx, killed_store
        gc.collect()
        torch.cuda.empty_cache()

        ctx, store, launches["cache_fenced_pipelined_saturated"], out["pipelined"], prec = fenced_leg(
            dev, "pipelined, fenced", rows, sd, batches, pipe_knobs, STATE_DIR / "pipelined")
        ctx.flush()
        pwarm, pvals = store.probe_entries(sync["signs"], EMB_DIM)
        pipe_ok = (state_digest(ctx) == want and np.array_equal(pwarm, warm)
                   and np.array_equal(pvals[warm].view(np.uint32), vals[warm].view(np.uint32))
                   and [r["decisions"] for r in prec] == decisions)
        out["pipelined"]["vs_fenced_inorder"] = out["pipelined"]["samples_per_s"] / out["fenced"]["samples_per_s"]
        print(f"  pipelined fenced leg vs the in-order fenced leg: state bytes, servers' entries and decisions "
              f"{'bit for bit' if pipe_ok else 'DIFFER'}; {out['pipelined']['pipelined_feeds']} feeds hoisted, "
              f"{out['pipelined']['pipeline_drains']} drains", flush=True)
        if not pipe_ok:
            raise SystemExit("cache fenced: the pipelined fenced leg is not bit for bit the in-order fenced leg")
        del ctx, store
        f = out["fenced"]
        print(f"  fenced in-order samples/s {f['samples_per_s']:.0f} vs unfenced {f['unfenced_samples_per_s']:.0f} "
              f"({f['vs_unfenced']:.3f}x); resumed leg {out['resumed']['samples_per_s']:.0f}; pipelined fenced "
              f"{out['pipelined']['samples_per_s']:.0f}", flush=True)
    finally:
        shutil.rmtree(STATE_DIR, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def cache_dnn(dev):
    """DNN on the cache tier at phase 4j's width (the serving bench's DNN
    and its 8 zipf slots over 100,000 ids, B=4096, bf16 compute, Adam(3e-3),
    Adagrad(0.1)) with the cache tier's bench knobs (bf16 wires, the touch
    gate): DNN_CACHE_STEPS steps through the stream, a fence at
    DNN_CACHE_EVERY into a job directory; every step's loss on the card and
    on the CPU port within 2e-2; K10/K11 counted."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.hbm_cache import CachedTrainCtx
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DNN
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    model0 = DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, device="cpu")
    sd = state_dict_from_flax(model0, seeded_flax_params_like(model0, SEED))
    make = dnn_batch_maker(SEED + 70, BATCH)
    batches = [make() for _ in range(DNN_CACHE_STEPS)]
    print(f"== phase 4k (DNN): DNN{DNN_MLP} on the cache tier ({DNN_CACHE_ROWS} rows, B={BATCH}, {DNN_SLOTS} slots "
          f"of dim {DNN_DIM}), train_stream over {DNN_CACHE_STEPS} steps with a fence at {DNN_CACHE_EVERY}, "
          f"card and CPU", flush=True)

    def run(device):
        cfg = dnn_cfg()
        store = make_store("native", capacity=1 << 22, num_internal_shards=4, optimizer=Adagrad(lr=0.1).config,
                           seed=7)
        model = DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, device="cpu")
        model.load_state_dict(sd)
        ctx = CachedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1),
                             EmbeddingWorker(cfg, [store]), cfg, cache_rows=DNN_CACHE_ROWS, device=device,
                             wb_wire_dtype="bfloat16", aux_wire_dtype="bfloat16", admit_touches=2).__enter__()
        rec = cache_recorder(ctx)
        losses = []
        if device != "cpu":
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        ctx.train_stream(batches, snapshot_every=DNN_CACHE_EVERY, job_state=str(STATE_DIR / f"dnn_{device}"),
                         on_metrics=lambda m: losses.append(float(m["loss"])))
        if device != "cpu":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}
        st = ctx.stream_stats()
        return ctx, launches, losses, rec, st, wall

    shutil.rmtree(STATE_DIR, ignore_errors=True)
    try:
        card, launches, losses, rec, st, wall = run(dev)
        steps, touched = DNN_CACHE_STEPS, sum(r["touched"] for r in rec)
        expected = bn_launches_expected(ops, batch_norm_fwd=2 * steps, batch_norm_bwd=2 * steps,
                                        cached_gather=steps, cache_aux=touched, sparse_update=steps,
                                        gather_entry_rows=st["fences"])
        check_launches("DNN cache path", launches, expected)
        stats_moved = float(card.model.norms[0].mean.abs().max())
        del card
        _cpu, _, cpu_losses, cpu_rec, _, cpu_wall = run("cpu")
        del _cpu
    finally:
        shutil.rmtree(STATE_DIR, ignore_errors=True)
    err = max(abs(a - b) for a, b in zip(losses, cpu_losses))
    ok = (len(losses) == len(cpu_losses) == DNN_CACHE_STEPS and np.isfinite(losses).all() and err <= 2e-2
          and st["fences"] == 1 and [r["decisions"] for r in rec] == [r["decisions"] for r in cpu_rec]
          and stats_moved > 0)
    print(f"  launches={launches}; {st['fences']} fence ({st['fence_ms'][0]['total']:.1f} ms); losses "
          f"{[round(x, 4) for x in losses]}: max_abs_err vs the CPU port {err:.3e} tolerance=2e-2; decisions = the "
          f"CPU's; running mean moved (max |mean| {stats_moved:.3e}); {DNN_CACHE_STEPS * BATCH / wall:.0f} samples/s "
          f"with every header read (CPU {cpu_wall:.1f} s) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("DNN on the cache tier: card and CPU disagree")
    return launches, {"steps": DNN_CACHE_STEPS, "losses": losses, "loss_max_abs_err_vs_cpu": err,
                      "fence_ms": st["fence_ms"], "samples_per_s_per_step_reads": DNN_CACHE_STEPS * BATCH / wall,
                      "launches": launches}


def cache_vs_hybrid(dev, sd):
    """SGD, no eviction, the touch gate off and f32 wires: the cache tier's
    rows after flush against the hybrid ``TrainCtx``'s on the same stream,
    both on the card."""
    import torch

    from persia_tpu_torch.ctx import TrainCtx
    from persia_tpu_torch.embedding.optim import SGD
    from persia_tpu_torch.embedding.worker import EmbeddingWorker
    from persia_tpu_torch.models import DLRM

    make = zipf_batch_maker(SEED + 62, labels=True)
    batches = [make() for _ in range(CACHE_SGD_STEPS)]
    cstore, hstore = cache_store("sgd"), cache_store("sgd")
    cached = cache_ctx(dev, CACHE_FILL_ROWS, cstore, sd, sparse="sgd", wires="float32", touches=1)
    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    model.load_state_dict(sd)
    hybrid = TrainCtx(model, torch.optim.Adam(model.parameters(), lr=1e-3), SGD(lr=0.05),
                      EmbeddingWorker(bench_cfg(), [hstore], device_pooling=True), bench_cfg(), device=dev).__enter__()
    losses = [(cached.train_step(b)["loss"], hybrid.train_step(b)["loss"]) for b in batches]
    evictions = cached.tier.evictions
    cached.flush()
    signs = batch_keys(batches)
    wc, vc = cstore.probe_entries(signs, EMB_DIM)
    wh, vh = hstore.probe_entries(signs, EMB_DIM)
    if evictions or not (wc.all() and wh.all()):
        raise SystemExit(f"cache vs hybrid: {evictions} evictions, {int(wc.sum())} / {int(wh.sum())} of "
                         f"{len(signs)} signs on the servers")
    err = float(np.abs(vc - vh).max())
    loss_err = max(abs(a - b) for a, b in losses)
    print(f"== phase 4k (vs hybrid): SGD(0.05), {CACHE_SGD_STEPS} steps, no eviction: cache tier's rows after flush "
          f"vs the hybrid TrainCtx's ({len(signs)} signs): max_abs_err={err:.3e} tolerance=1e-2; losses "
          f"max_abs_err={loss_err:.3e} {'ok' if err <= 1e-2 else 'FAIL'}", flush=True)
    if err > 1e-2:
        raise SystemExit("cache vs hybrid: the rows disagree")
    return {"steps": CACHE_SGD_STEPS, "signs": len(signs), "row_max_abs_err": err, "loss_max_abs_err": loss_err}


def path_cache(dev):
    """Phase 4k: both regimes, each synchronous, then as the in-order
    stream, then as the stage-pipelined stream, and in the saturated regime
    the fenced legs; then the SGD twin of the hybrid tier and DNN on the
    cache tier."""
    import gc

    import torch

    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    sd = state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    launches, records, inputs = {}, {}, None
    for regime, rows in (("fill", CACHE_FILL_ROWS), ("saturated", CACHE_SAT_ROWS)):
        launches[f"cache_{regime}"], records[regime], inp, sync = run_cache_regime(dev, regime, rows, sd)
        gc.collect()
        torch.cuda.empty_cache()
        launches[f"cache_stream_{regime}"], records[f"stream_{regime}"], restore, entries = run_cache_stream(
            dev, regime, rows, sd, sync)
        gc.collect()
        torch.cuda.empty_cache()
        launches[f"cache_pipelined_{regime}"], records[f"pipelined_{regime}"], _, _ = run_cache_stream(
            dev, regime, rows, sd, sync, PIPELINED_KNOBS, inorder={"record": records[f"stream_{regime}"],
                                                                   "entries": entries})
        if regime == "saturated":
            inputs = dict(inp, stream_step=restore)
            fenced_launches, records["fenced"] = run_cache_fenced(dev, rows, sd, sync, records["stream_saturated"])
            launches.update(fenced_launches)
        del inp, sync, restore, entries
        gc.collect()
        torch.cuda.empty_cache()
    records["vs_hybrid"] = cache_vs_hybrid(dev, sd)
    gc.collect()
    torch.cuda.empty_cache()
    launches["dnn_cache"], records["dnn"] = cache_dnn(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, records, inputs


# ---------------------------------------------------------------------------
# The mixed tier (persia_tpu_torch/embedding/hbm_cache with ps_slots) at
# bench.py's ps-stream configuration (bench.py:285-344 with ps_all, and
# bench_ps_stream, bench.py:576-611): phase 3f, its legs of phase 4k and
# K15's row of phase 5

K15_SOURCE = "persia_tpu_torch/csrc/quantize_int8.cu"
K15_REPLACES = "persia_tpu/parallel/grad_sync.py:244"
K15_ALSO_REPLACES = "persia_tpu/embedding/hbm_cache/step.py:361"
PS_ALL = tuple(f"cat_{i}" for i in range(N_SLOTS))
# bench_ps_stream: 4 warm-up batches, then BENCH_PS_STREAM_STEPS (30) timed,
# both through train_stream(prefetch=4, psgrad_batch=16, fetch_final=False)
PS_STREAM_WARMUP, PS_STREAM_STEPS = 4, 30
PS_STREAM_KNOBS = dict(prefetch=4, psgrad_batch=16, fetch_final=False)
# the synchronous all-PS steps held to the CPU port and to the f32 wire; the
# mixed leg: cat_0-cat_12 cached at the saturated regime's rows,
# cat_13-cat_25 on the PS (int8), synchronous and as the stream
PS_SYNC_STEPS, MIXED_STEPS = 8, 16
MIXED_PS = tuple(f"cat_{i}" for i in range(13, N_SLOTS))
# K15's edge cases (segment lengths): not multiples of 512 or of the
# 8-element unit, empty segments, host-pooled (B, D) beside device-pooled
# (P, D), starts off 8 elements before a vector body, one segment past a
# cluster's registers (8 blocks x 512 threads x 32 elements), 512
# segments, the mixed leg's 13 device-pooled slots
K15_CASES = ([1, 511, 512, 513, 1000, 3], [0, 7, 0, 16 * BATCH + 5], [BATCH * EMB_DIM, 1536 * EMB_DIM, 33],
             [5, 2043, 4099, 771, 8], [300_003], [(i * 37) % 251 for i in range(512)],
             [1536 * EMB_DIM] * len(MIXED_PS))
# and a NaN inside the second of four segments (element K15_NAN_AT)
K15_NAN_CASE, K15_NAN_AT = [1536 * EMB_DIM, 1536 * EMB_DIM, 1000, 1536 * EMB_DIM], 1536 * EMB_DIM + 777


def k15_inputs(dev, lengths, dtype, seed):
    """Seeded gradients (``dtype``) and an f32 residual over segments of
    ``lengths``, each segment at its own magnitude; with the offsets."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    mags = torch.cat([torch.full((n,), 10.0 ** (i % 5 - 4)) for i, n in enumerate(lengths)])
    g = (torch.randn(int(mags.numel()), generator=gen) * mags).to(dtype)
    res = torch.randn(int(mags.numel()), generator=gen) * mags * 1e-2
    return g.to(dev), res.to(dev), [0] + np.cumsum(lengths).tolist()


def k15_extreme_inputs(dev, dtype):
    """K15's inputs at the edges of its division: maxima under 1e-30 (the
    scale clamps), scales under 2^-90 and from 2^126 up (IEEE division),
    just inside both (Markstein's), subnormal gradients, v at the codes'
    rounding midpoints under a scale of 1.37, signed zeros (a residual of
    -0.0 under -0.0 and +0.0 gradients), an infinity; with the offsets."""
    import torch

    rng = np.random.default_rng(SEED + 85)
    mid = (np.arange(-127, 127) + 0.5) / 127
    segs = [rng.standard_normal(4099) * 1e-31, rng.standard_normal(4101) * 1e-29,
            np.where(rng.random(4096) < 0.25, 1e-40, rng.standard_normal(4096) * 1e-26),
            rng.standard_normal(4103) * 1e37, rng.standard_normal(4096) * 4e37,
            np.concatenate([[1.37], mid * 1.37, -mid]), np.array([0.0, -0.0, -0.0, 0.0, 1e-3, -0.0, 2e-3, -5e-4] * 64),
            np.array([1.0, np.inf, -2.0, 0.5] * 9)]
    lengths = [len(x) for x in segs]
    res = np.zeros(sum(lengths), np.float32)
    res[sum(lengths[:6]):sum(lengths[:7])] = -0.0
    g = torch.from_numpy(np.concatenate(segs).astype(np.float32)).to(dtype)
    return g.to(dev), torch.from_numpy(res).to(dev), [0] + np.cumsum(lengths).tolist()


def k15_bits(t):
    """An f32 tensor's bits as int32, every NaN made the card's canonical
    one (0x7fffffff): the card's and the CPU's NaN payloads differ; other
    tensors as they are."""
    import torch

    return t.view(torch.int32).masked_fill(t.isnan(), 0x7FFFFFFF) if t.dtype == torch.float32 else t


def phase_quant_kernels(dev):
    """Phase 3f: K15 (``quantize_int8_ef``) against its plain version on
    the card and on the CPU, bit for bit (codes, scales, the residual it
    rewrites in place), three steps with the residual carried: at the
    ps-stream path's shape (26 device-pooled slots of P=1536 rows x 16,
    bf16 gradients), at ``K15_CASES``, at ``K15_NAN_CASE`` (a NaN in one
    segment: NaN payloads set aside against the CPU, whose x86 arithmetic
    keeps an operand's where the card returns 0x7fffffff; the scale's bits
    must be that) and at ``k15_extreme_inputs`` (the edges of the
    division; NaN payloads set aside against the CPU), bf16 and f32; each
    case's plan printed."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef_reference

    print("== phase 3f: the mixed tier's int8 gradient wire (K15 quantize_int8_ef) vs its plain version", flush=True)
    cases = [("", lengths) for lengths in ([1536 * EMB_DIM] * N_SLOTS,) + K15_CASES]
    for kind, lengths in cases + [("nan", K15_NAN_CASE), ("extremes", None)]:
        nan, extremes = kind == "nan", kind == "extremes"
        for dtype in (torch.bfloat16, torch.float32):
            if extremes:
                g, res, offsets = k15_extreme_inputs(dev, dtype)
                lengths = np.diff(offsets).tolist()
            else:
                g, res, offsets = k15_inputs(dev, lengths, dtype, SEED + 80 + len(lengths))
            if nan:
                g[K15_NAN_AT] = float("nan")
            plan = plans.quantize_int8_plan(len(lengths), max(lengths), g.element_size())
            plain_card, plain_cpu = res.clone(), res.cpu()
            diffs = []  # (step, output, which plain version) that differ
            for step in range(3):
                before = ops.quantize_int8_ef.launches
                q, s, new = ops.quantize_int8_ef(g, res, offsets)
                q1, s1, plain_card = quantize_int8_ef_reference(g, plain_card, offsets)
                q2, s2, plain_cpu = quantize_int8_ef_reference(g.cpu(), plain_cpu, offsets)
                torch.cuda.synchronize()
                if new.data_ptr() != res.data_ptr() or ops.quantize_int8_ef.launches != before + 1:
                    diffs.append((step, "residual not in place or not one launch", ""))
                if nan and s.view(torch.int32)[1].item() != 0x7FFFFFFF:
                    diffs.append((step, "the NaN segment's scale", hex(s.view(torch.int32)[1].item())))
                for name, a, b, c in (("codes", q, q1, q2), ("scales", s, s1, s2),
                                      ("residual", new, plain_card, plain_cpu)):
                    for where, ref in (("card", b), ("cpu", c)):
                        x, y = (k15_bits(a.cpu()), k15_bits(ref.cpu())) if (nan or extremes) and where == "cpu" \
                            else (a, ref)
                        x, y = (t.view(torch.int32) if t.dtype == torch.float32 else t for t in (x, y))
                        if not bits_equal(x, y):
                            diffs.append((step, name, where, int((x.cpu() != y.cpu()).sum())))
                g = (g.float() * -0.5 + (0.0 if extremes else 1e-4)).to(dtype)
            ok = not diffs
            print(f"  quantize_int8_ef {len(lengths)} segments of {lengths[:4]}{'...' if len(lengths) > 4 else ''}"
                  f"{' with a NaN' if nan else ''}{' at the edges of the division' if extremes else ''} "
                  f"{str(dtype).split('.')[-1]} (cluster {plan.cluster}, "
                  f"{plan.threads} threads, {plan.elems_a_thread} elements a thread): codes, scales and residual "
                  f"bitwise vs the plain version on the card and on the CPU, 3 steps "
                  f"{'ok' if ok else f'FAIL (step, output, where, elements): {diffs}'}", flush=True)
            if not ok:
                raise SystemExit("quantize_int8_ef disagrees with its plain version")
    torch.cuda.empty_cache()
    return {"quantize_int8_ef": 0.0}


def ps_ctx(device, store, sd, ps_slots=PS_ALL, wire="int8", rows=8):
    """``_cached_tier_ctx(ps_all=True)``'s ctx (bench.py:285-344) through
    ``testing.quality.tier_ctx``: DLRM at bench width from ``sd``,
    Adam(1e-3), Adagrad(0.05), a device-pooling worker over ``store``,
    ``ps_slots`` on the PS with the ``wire`` gradient wire and ``rows``
    cache rows (8: unused); with cached slots beside them the cached
    configuration's bf16 wires and touch gate."""
    from persia_tpu_torch.testing.quality import bench_model, tier_ctx

    return tier_ctx(device, store, ps_slots=ps_slots, ps_wire=wire, cache_rows=rows,
                    model=bench_model(state_dict=sd))


PS_PARTS = ("lookup", "staging", "apply")  # the PS tier's host parts, timed a call


def time_ps_parts(ctx):
    """Shadow the PS tier's host parts with ``timed_calls``: the worker's
    lookup (``forward_batch_id``), the entries' staging
    (``stage_embeddings``, the CSR included) and the gradients' apply
    (``update_gradient_batched``); returns ({part: ms a call}, {part:
    thread CPU ms a call}, the function that takes the wrappers away)."""
    from persia_tpu_torch.embedding.hbm_cache import ctx as ctx_mod

    wall, cpu = {p: [] for p in PS_PARTS}, {p: [] for p in PS_PARTS}
    undo = [timed_calls(ctx.worker, "forward_batch_id", wall["lookup"], cpu["lookup"]),
            timed_calls(ctx_mod, "stage_embeddings", wall["staging"], cpu["staging"]),
            timed_calls(ctx.worker, "update_gradient_batched", wall["apply"], cpu["apply"])]
    return wall, cpu, lambda: [u() for u in undo]


def parts_p50(wall, cpu):
    return {p: {"ms_p50": float(np.percentile(wall[p], 50)), "cpu_ms_p50": float(np.percentile(cpu[p], 50)),
                "calls": len(wall[p])} for p in PS_PARTS if wall[p]}


def refs_released(ctx, what):
    if ctx.worker.staleness or ctx.worker.post_forward_buffer:
        raise SystemExit(f"{what}: staleness {ctx.worker.staleness}, {len(ctx.worker.post_forward_buffer)} refs "
                         "left in the post-forward buffer")


def launches_now():
    from persia_tpu_torch import ops

    return {fn.__name__: fn.launches for fn in ops.KERNEL_WRAPPERS}


def expect_launches(what, launches, **counts):
    from persia_tpu_torch import ops

    expected = {fn.__name__: 0 for fn in ops.KERNEL_WRAPPERS}
    expected.update(counts)
    print(f"  launches={ {k: v for k, v in launches.items() if v} }", flush=True)
    if launches != expected:
        raise SystemExit(f"{what}: launches {launches}, expected {expected}")
    return expected


def run_ps_stream(dev, sd):
    """The ps-stream regime as bench_ps_stream runs it: 4 warm-up batches,
    then 30 timed, counted; staleness 0, every ref released, every step
    applied once (the write-back's count), trained entries in the store.
    Returns (launches, record, K15's inputs at the last warm-up step)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.hbm_cache import native_init_rows
    from persia_tpu_torch.embedding.hbm_cache import step as step_mod

    print(f"== phase 4k (ps-stream): all {N_SLOTS} slots on the PS, the int8 wire, "
          f"CachedTrainCtx.train_stream({PS_STREAM_KNOBS}) over {PS_STREAM_WARMUP} warm-up and {PS_STREAM_STEPS} "
          f"timed batches (bench_ps_stream)", flush=True)
    make = zipf_batch_maker(SEED + 70, labels=True)
    batches = [make() for _ in range(PS_STREAM_WARMUP + PS_STREAM_STEPS)]
    store = cache_store()
    ctx = ps_ctx(dev, store, sd)
    if ctx.tier.groups or ctx.tier.dirs:
        raise SystemExit("ps-stream: the all-PS ctx has cache groups")
    kept = {}
    inner = step_mod.quantize_int8_ef

    def keep(g, res, offsets):  # the last warm-up step's inputs, for phase 5
        kept.update(g=g.clone(), res=res.clone(), offsets=list(offsets))
        return inner(g, res, offsets)

    step_mod.quantize_int8_ef = keep
    try:
        t0 = time.perf_counter()
        ctx.train_stream(batches[:PS_STREAM_WARMUP], **PS_STREAM_KNOBS)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
    finally:
        step_mod.quantize_int8_ef = inner
    warm = ctx.stream_stats()
    part_wall, part_cpu, undo = time_ps_parts(ctx)
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if ctx.train_stream(batches[PS_STREAM_WARMUP:], **PS_STREAM_KNOBS) is not None:
        raise SystemExit("ps-stream: fetch_final=False returned metrics")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    undo()
    parts = parts_p50(part_wall, part_cpu)
    st = ctx.stream_stats()
    launches = launches_now()
    n = PS_STREAM_STEPS
    expected = expect_launches("ps-stream", launches, quantize_int8_ef=n, gather_pool_fwd=n, gather_pool_bwd=n,
                               dot_interaction=n, dot_interaction_bwd=n)
    metrics = ctx.last_metrics()
    if metrics is None or not np.isfinite(metrics["loss"]):
        raise SystemExit(f"ps-stream: the last metrics {metrics}")
    refs_released(ctx, "ps-stream")
    applied = (warm["psgrad_steps"], st["psgrad_steps"])
    if applied != (PS_STREAM_WARMUP, n) or st["psgrad_flushes"] != -(-n // PS_STREAM_KNOBS["psgrad_batch"]):
        raise SystemExit(f"ps-stream: steps applied {applied} in {st['psgrad_flushes']} flushes")
    record = {
        "batch": BATCH, "warmup_steps": PS_STREAM_WARMUP, "steps": n, "knobs": PS_STREAM_KNOBS,
        "samples_per_s": n * BATCH / wall, "wall_s": wall, "warmup_s": warm_s, "lane_s": st["lane_s"],
        "psgrad_flushes": st["psgrad_flushes"], "psgrad_bytes": st["psgrad_bytes"],
        "grad_bytes_per_sample": st["psgrad_bytes"] / (n * BATCH), "k15_launches_per_step": launches[
            "quantize_int8_ef"] / n, "launches": launches, "launches_expected": expected,
        "last_loss": float(metrics["loss"]), "tiers": st["tiers"], "store_rows": store.size(),
        "k15_segments": len(kept["offsets"]) - 1, "k15_elements": int(kept["g"].numel()), "ps_parts": parts,
    }
    print(f"  ps-stream samples/s {record['samples_per_s']:.1f} ({n} steps in {wall:.3f} s), lanes busy s "
          f"{ {k: round(v, 3) for k, v in st['lane_s'].items()} }, psgrad flushes {st['psgrad_flushes']}, gradient "
          f"bytes a sample on the d2h wire {record['grad_bytes_per_sample']:.1f}, K15 launches "
          f"{launches['quantize_int8_ef']} ({record['k15_launches_per_step']:.0f} a step; "
          f"{record['k15_segments']} segments, {record['k15_elements']} elements); the PS tier's host parts a "
          f"call, p50 ms (thread CPU ms): { {k: (round(v['ms_p50'], 2), round(v['cpu_ms_p50'], 2)) for k, v in parts.items()} }",
          flush=True)
    # trained entries: rows moved off the seed the servers birthed them with
    # (a gradient under a slot's scale / 254 ships as code 0 and moves none;
    # so do the Adagrad accumulators of most signs, g^2 under 0.01's ulp)
    signs = batch_keys(batches)
    warm_signs, vals = store.probe_entries(signs, EMB_DIM)
    seeded = native_init_rows(signs, ctx.tier.init_seed, EMB_DIM, ctx.tier.init_method)
    moved = int((vals[:, :EMB_DIM] != seeded).any(axis=1).sum())
    record.update(signs=len(signs), rows_moved=moved)
    print(f"  every ref released (staleness 0), every step applied once ({PS_STREAM_WARMUP} + {n}, "
          f"{st['psgrad_flushes']} flushes); the store holds {int(warm_signs.sum())} of the batches' {len(signs)} "
          f"signs, {moved} ({moved / len(signs):.2%}) of them trained off their seeded rows (at least 100) "
          f"{'ok' if warm_signs.all() and moved >= 100 else 'FAIL'}", flush=True)
    if not warm_signs.all() or moved < 100:
        raise SystemExit("ps-stream: the store lacks trained entries")
    del ctx
    return launches, record, kept


def run_ps_sync(dev, sd):
    """The ps-stream configuration synchronous for ``PS_SYNC_STEPS`` steps,
    counted, on the card and in the CPU port (losses 2e-2, the PS entries
    1e-2: the hybrid tier's card limits); the same steps with the f32 wire
    on the card, the int8 wire's entries drifting from them by under 0.15
    of their norm (tests/test_hbm_cache.py:1613's gate)."""
    import torch

    from persia_tpu_torch import ops

    print(f"== phase 4k (ps-sync): the ps-stream configuration, {PS_SYNC_STEPS} CachedTrainCtx.train_steps on the "
          f"card and on the CPU; the f32 wire beside the int8 one", flush=True)
    make = zipf_batch_maker(SEED + 71, labels=True)
    batches = [make() for _ in range(PS_SYNC_STEPS)]
    signs = batch_keys(batches)
    out = {}
    for label, device, wire in (("card", dev, "int8"), ("cpu", "cpu", "int8"), ("card_f32", dev, "float32")):
        store = cache_store()
        ctx = ps_ctx(device, store, sd, wire=wire)
        if label == "card":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            part_wall, part_cpu, undo = time_ps_parts(ctx)
        t0 = time.perf_counter()
        losses = [ctx.train_step(b)["loss"] for b in batches]
        wall = time.perf_counter() - t0
        if label == "card":
            undo()
            parts = parts_p50(part_wall, part_cpu)
            launches = launches_now()
            expect_launches("ps-sync", launches, quantize_int8_ef=PS_SYNC_STEPS, gather_pool_fwd=PS_SYNC_STEPS,
                            gather_pool_bwd=PS_SYNC_STEPS, dot_interaction=PS_SYNC_STEPS,
                            dot_interaction_bwd=PS_SYNC_STEPS)
        refs_released(ctx, f"ps-sync ({label})")
        warm, vals = store.probe_entries(signs, EMB_DIM)
        out[label] = (losses, warm, vals, wall)
        del ctx, store
    (l8, w8, v8, wall8), (lc, wc, vc, _), (l32, w32, v32, _) = out["card"], out["cpu"], out["card_f32"]
    if not (np.array_equal(w8, wc) and np.array_equal(w8, w32) and w8.all()):
        raise SystemExit("ps-sync: the stores hold other signs")
    loss_err = max(abs(a - b) for a, b in zip(l8, lc))
    row_err = float(np.abs(v8 - vc).max())
    drift = float(np.linalg.norm(v8 - v32) / np.linalg.norm(v32))
    ok = loss_err <= 2e-2 and row_err <= 1e-2 and 0 < drift < 0.15 and all(np.isfinite(l8))
    print(f"  card vs CPU: losses max_abs_err={loss_err:.3e} tolerance=2e-2, PS entries ({len(signs)} signs) "
          f"max_abs_err={row_err:.3e} tolerance=1e-2; int8 vs f32 wire on the card: relative drift {drift:.3e} "
          f"(gate 0.15, above 0); card samples/s {PS_SYNC_STEPS * BATCH / wall8:.1f}, the PS tier's host parts a "
          f"call, p50 ms (thread CPU ms): { {k: (round(v['ms_p50'], 2), round(v['cpu_ms_p50'], 2)) for k, v in parts.items()} } "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("ps-sync: card and CPU disagree, or the int8 wire drifted from the f32 one")
    return launches, {"steps": PS_SYNC_STEPS, "losses": l8, "loss_max_abs_err_vs_cpu": loss_err,
                      "ps_entry_max_abs_err_vs_cpu": row_err, "int8_vs_f32_drift": drift,
                      "samples_per_s": PS_SYNC_STEPS * BATCH / wall8, "losses_f32": l32, "ps_parts": parts}


def run_mixed(dev, sd):
    """cat_0-cat_12 cached (2^18 rows, bf16 wires, the touch gate),
    cat_13-cat_25 on the PS (int8): ``MIXED_STEPS`` synchronous steps on the
    card (counted) and the CPU port (the cached half's decisions equal at
    every step, losses 2e-2, every entry after flush 1e-2), then the same
    batches as the stream at the bench's knobs from a fresh ctx (counted;
    its decisions the synchronous steps', its last loss within 2e-2 of
    theirs: the PS half trains under bounded staleness there)."""
    import torch

    from persia_tpu_torch import ops

    print(f"== phase 4k (mixed): {N_SLOTS - len(MIXED_PS)} slots cached ({CACHE_SAT_ROWS} rows), {len(MIXED_PS)} on "
          f"the PS (int8), {MIXED_STEPS} synchronous steps on the card and the CPU, then the stream", flush=True)
    make = zipf_batch_maker(SEED + 72, labels=True)
    batches = [make() for _ in range(MIXED_STEPS)]
    signs = batch_keys(batches)
    runs, launches, records = {}, {}, {}
    for label, device in (("card", dev), ("cpu", "cpu"), ("stream", dev)):
        store = cache_store()
        ctx = ps_ctx(device, store, sd, MIXED_PS, "int8", rows=CACHE_SAT_ROWS)
        rec = cache_recorder(ctx)
        if device != "cpu":
            torch.cuda.synchronize()
            ops.reset_launch_counts()
        t0 = time.perf_counter()
        if label == "stream":
            ctx.train_stream(batches, **STREAM_KNOBS)
            losses = [ctx.last_metrics()["loss"]]
            st = ctx.stream_stats()
        else:
            losses = [ctx.train_step(b)["loss"] for b in batches]
        wall = time.perf_counter() - t0
        if device != "cpu":
            touched = sum(s["touched"] for s in rec)
            ctx.flush()
            launches[f"mixed_{'sync' if label == 'card' else 'stream'}"] = launches_now()
            expect_launches(f"mixed ({label})", launches_now(), quantize_int8_ef=MIXED_STEPS,
                            gather_pool_fwd=MIXED_STEPS, gather_pool_bwd=MIXED_STEPS, cached_gather=MIXED_STEPS,
                            cache_aux=touched, sparse_update=MIXED_STEPS, gather_entry_rows=1,
                            dot_interaction=MIXED_STEPS, dot_interaction_bwd=MIXED_STEPS)
        else:
            ctx.flush()
        refs_released(ctx, f"mixed ({label})")
        warm, vals = store.probe_entries(signs, EMB_DIM)
        runs[label] = dict(losses=losses, rec=rec, warm=warm, vals=vals, wall=wall,
                           stats=st if label == "stream" else None, evictions=ctx.tier.evictions)
        del ctx, store
    card, cpu, stream = runs["card"], runs["cpu"], runs["stream"]
    same = [a["digest"] == b["digest"] for a, b in zip(card["rec"], cpu["rec"])]
    same_stream = [a["decisions"] == b["decisions"] for a, b in zip(card["rec"], stream["rec"])]
    if not (all(same) and len(same) == MIXED_STEPS and all(same_stream) and len(same_stream) == MIXED_STEPS):
        raise SystemExit(f"mixed: the cached half's decisions differ (card vs CPU at "
                         f"{[i for i, s in enumerate(same) if not s]}, stream vs sync at "
                         f"{[i for i, s in enumerate(same_stream) if not s]})")
    warm = card["warm"]  # the touch gate keeps some cached-slot signs out of the store
    if not np.array_equal(warm, cpu["warm"]):
        raise SystemExit("mixed: the stores hold other signs")
    loss_err = max(abs(a - b) for a, b in zip(card["losses"], cpu["losses"]))
    row_err = float(np.abs(card["vals"][warm] - cpu["vals"][warm]).max())
    stream_gap = abs(stream["losses"][0] - card["losses"][-1])
    ok = loss_err <= 2e-2 and row_err <= 1e-2 and stream_gap <= 2e-2 and np.isfinite(stream["losses"][0])
    st = stream["stats"]
    print(f"  cached half's decisions = the CPU's at every one of {MIXED_STEPS} steps, the stream's = the "
          f"synchronous steps'; losses max_abs_err={loss_err:.3e} tolerance=2e-2; entries after flush "
          f"({int(warm.sum())} of the batches' {len(signs)} signs) max_abs_err={row_err:.3e} tolerance=1e-2; the stream's last loss "
          f"{stream['losses'][0]:.5f} vs the synchronous {card['losses'][-1]:.5f} (gap {stream_gap:.3e}, tolerance "
          f"2e-2) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("mixed: card and CPU disagree, or the stream drifted")
    records = {"steps": MIXED_STEPS, "cache_rows": CACHE_SAT_ROWS, "ps_slots": list(MIXED_PS),
               "losses": card["losses"], "loss_max_abs_err_vs_cpu": loss_err, "entry_max_abs_err_vs_cpu": row_err,
               "stream_last_loss_gap": stream_gap, "sync_samples_per_s": MIXED_STEPS * BATCH / card["wall"],
               "stream_samples_per_s": MIXED_STEPS * BATCH / stream["wall"], "evictions": card["evictions"],
               "stream_lane_s": st["lane_s"], "stream_psgrad_flushes": st["psgrad_flushes"],
               "stream_restore_steps": st["restore_steps"], "stream_tiers": st["tiers"]}
    print(f"  mixed samples/s: synchronous {records['sync_samples_per_s']:.1f}, stream "
          f"{records['stream_samples_per_s']:.1f} (lanes busy s { {k: round(v, 3) for k, v in st['lane_s'].items()} }"
          f", psgrad flushes {st['psgrad_flushes']}, restoring steps {st['restore_steps']}); evictions "
          f"{card['evictions']}", flush=True)
    return launches, records


def path_mixed(dev):
    """Phase 4k's mixed-tier legs: ps-stream, ps-sync, mixed. Returns
    (launches by leg, records, K15's inputs for phase 5)."""
    import gc

    import torch

    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    sd = state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    launches, records = {}, {}
    launches["ps_stream"], records["ps_stream"], k15 = run_ps_stream(dev, sd)
    gc.collect()
    torch.cuda.empty_cache()
    launches["ps_sync"], records["ps_sync"] = run_ps_sync(dev, sd)
    gc.collect()
    torch.cuda.empty_cache()
    mixed_launches, records["mixed"] = run_mixed(dev, sd)
    launches.update(mixed_launches)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, records, k15


K15_COMPOSED_CALLS = 17  # the PyTorch calls of k15_composed, one kernel each


def k15_composed(g, res, seg_ids, segments):
    """The fewest PyTorch calls this script found for K15's function (a
    yardstick, timed here and used nowhere in the port; ``K15_COMPOSED_CALLS``
    of them): a scatter-reduce for the segments' absmax, the rest
    elementwise."""
    import torch

    v = g.float() + res
    amax = torch.zeros(segments, dtype=torch.float32, device=g.device).scatter_reduce_(0, seg_ids, v.abs(), "amax")
    scale = amax.clamp_min(1e-30)
    step = scale / torch.full_like(scale, 127.0)  # tensor by tensor: a true division on the card too
    t = torch.round(v / scale[seg_ids] * 127.0).clamp_(-127, 127)
    return t.to(torch.int8), scale, v - t * step[seg_ids]


def time_k15(dev, launches, errs, k15, floor):
    """Phase 5's row of K15 at the ps-stream path's own inputs (its last
    warm-up step's gradients, residual and segments): graph-replayed warm
    and cold (whole copies rotated through more than the L2), beside the
    plain version, the composed PyTorch calls and the bound; over the
    one-launch floor, and its plan (``plans.quantize_int8_plan``). Another
    tree's K15 on the same shape, for the time and the bits side by side:
    ``--ab ROOT OUT.npz k15`` (``k15_ab``)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef_reference

    g, res0, offsets = k15["g"], k15["res"], k15["offsets"]
    n, segments = g.numel(), len(offsets) - 1
    plan = plans.quantize_int8_plan(segments, int(np.diff(offsets).max()), g.element_size())
    res = res0.clone()
    lengths = torch.tensor(np.diff(offsets), device=dev)
    seg_ids = torch.repeat_interleave(torch.arange(segments, device=dev), lengths)
    q0, s0, r0 = ops.quantize_int8_ef(g, res0.clone(), offsets)
    q1, s1, r1 = k15_composed(g, res0, seg_ids, segments)
    composed_same = bits_equal(q0, q1) and bits_equal(s0, s1) and bits_equal(r0.view(torch.int32),
                                                                             r1.view(torch.int32))
    nbytes = n * (g.element_size() + 4 + 1 + 4) + segments * 4 + 4 * (segments + 1)
    bms, by = bound(nbytes, 6 * n, "float32")
    kernel = lambda: ops.quantize_int8_ef(g, res, offsets)  # noqa: E731 (rewrites ``res`` in place)
    composed = lambda: k15_composed(g, res, seg_ids, segments)  # noqa: E731
    c0, k0, k1, c1 = timings(composed), timings(kernel), timings(kernel), timings(composed)
    plain = timings(lambda: quantize_int8_ef_reference(g, res, offsets))
    cold = [cold_ms(lambda gg, rr: ops.quantize_int8_ef(gg, rr, offsets), lambda: (g.clone(), res.clone()),
                    n * (g.element_size() + 4))["ms"] for _ in range(2)]
    r = dict(name="quantize_int8_ef", route="cuda", cuda_route="cuda", source=K15_SOURCE, replaces=K15_REPLACES,
             also_replaces=K15_ALSO_REPLACES, launches=launches["ps_stream"]["quantize_int8_ef"],
             launches_by_path={p: launches[p]["quantize_int8_ef"] for p in ("ps_stream", "ps_sync", "mixed_sync",
                                                                            "mixed_stream")},
             max_abs_err=errs["quantize_int8_ef"], shape=[segments, n // segments, str(g.dtype).split(".")[-1]],
             ms=min(k0["graph"], k1["graph"]), ms_runs=[k0["graph"], k1["graph"]],
             eager_ms=min(k0["eager"], k1["eager"]), plain_ms=plain["graph"], plain_eager_ms=plain["eager"],
             bound_ms=bms, bound_by=by, library_ms=None, composite_ms=min(c0["graph"], c1["graph"]),
             composite_kernels=K15_COMPOSED_CALLS, composite_bitwise=composed_same, cold_ms=min(cold),
             cold_ms_runs=cold, note=f"no single PyTorch call computes it; {K15_COMPOSED_CALLS} composed calls: "
                                     "composite_ms")
    r["over_launch_floor"] = r["ms"] / min(floor)
    r["ms_over_floor"] = r["ms"] - min(floor)
    r["cold_ms_over_floor"] = r["cold_ms"] - min(floor)
    r["cold_share"] = bms / r["cold_ms"]
    r["plan"] = {"cluster": plan.cluster, "blocks": plan.blocks, "threads": plan.threads,
                 "elems_a_thread": plan.elems_a_thread, "vec": plan.vec}
    print(f"  quantize_int8_ef ({segments} segments of {n // segments}, {g.dtype}; plan {r['plan']}): warm "
          f"{r['ms_runs']} ms, cold {cold} ms, bound {bms:.5f} ({by}; {r['cold_share']:.1%} cold, "
          f"{bms / r['ms']:.1%} warm), {r['over_launch_floor']:.2f}x the launch floor ({r['ms_over_floor']:.5f} ms "
          f"over it warm, {r['cold_ms_over_floor']:.5f} cold); plain {plain['graph']:.4f} ms; composed "
          f"({K15_COMPOSED_CALLS} calls, bitwise the kernel's: {composed_same}) {r['composite_ms']:.5f} ms; launches "
          f"{r['launches_by_path']}", flush=True)
    return [r]


def time_cache_kernels(dev, launches, errs, inputs, floor, build):
    """Phase 5's rows of K12 (``cache_aux``, and its read alone
    ``gather_entry_rows``) and K13 (``cached_gather``) at the saturated
    regime's own inputs (its last step's aux pieces, their pairing and rows,
    its pool, its flush's rows): graph-replayed warm, and cold (whole copies
    of the inputs, pool included, rotated through more than the L2), beside
    the plain version and the library calls; K12 also with the ring, and
    at the saturated stream's last restoring step in three forms (with its
    restores, without them, and unfolded into two launches), and K12 and
    the read over the one-launch floor ``floor`` (this run's two readings);
    K12's and the read's registers from ``build``."""
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.cache_aux import cache_aux_reference, gather_entry_rows_reference
    from persia_tpu_torch.ops.cached_gather import cached_gather_reference

    table, state, consts = inputs["table"], inputs["state"], inputs["consts"]
    miss, cold, ev = inputs["aux"]
    C, dim = table.shape[0] - 1, table.shape[1]
    acc = state["acc"]
    E = dim + acc.shape[1]
    ev_rows, ev_free = ev["cache_d16"]
    m_rows, m_ent, m_slot = miss["cache_d16"]
    c_rows, c_emb, c_slot = cold["cache_d16"]
    pairing = dict(m_slot=m_slot, c_slot=c_slot, ev_free=ev_free)
    n_ev, n_w, n_c = (int((r < lim).sum()) for r, lim in ((ev_rows, C), (m_rows, C + 1), (c_rows, C + 1)))
    esz = m_ent.element_size()
    rows = []

    def row(name, **kw):
        return dict(name=name, route="cuda", cuda_route="cuda", source=CACHE_SOURCE[name],
                    replaces=CACHE_REPLACES[name], launches=launches["cache_saturated"][name],
                    launches_by_path={p: launches[p][name] for p in CACHE_PATHS}, max_abs_err=errs[name], **kw)

    def timed(r, kernel, plain, library):
        lib0 = timings(library)
        k0, k1 = timings(kernel), timings(kernel)
        lib1 = timings(library)
        p = timings(plain)
        r.update(ms=min(k0["graph"], k1["graph"]), ms_runs=[k0["graph"], k1["graph"]],
                 eager_ms=min(k0["eager"], k1["eager"]), plain_ms=p["graph"], plain_eager_ms=p["eager"],
                 library_ms=min(lib0["graph"], lib1["graph"]), library_eager_ms=min(lib0["eager"], lib1["eager"]))
        return r

    def cold(r, kernel, make_copy, nbytes, library, make_lib_copy, lib_bytes):
        k0, k1 = cold_ms(kernel, make_copy, nbytes), cold_ms(kernel, make_copy, nbytes)
        lib = cold_ms(library, make_lib_copy, lib_bytes)
        r.update(cold_ms=min(k0["ms"], k1["ms"]), cold_ms_runs=[k0["ms"], k1["ms"]], cold_copies=k0["copies"],
                 library_cold_ms=lib["ms"])
        r["cold_share"] = r["bound_ms"] / r["cold_ms"]
        return r

    # K12: the step's pieces on a copy of the pool (it writes in place).
    # Bytes: the rows and the pairing read; (a) reads n_ev entries and
    # writes the bf16 payload; (b) reads n_w entries and writes them; (c)
    # reads n_c seeds and writes n_c entries
    pool = (table.clone(), {k: v.clone() for k, v in state.items()})
    nbytes = (4 * (ev_rows.numel() + m_rows.numel() + c_rows.numel() + m_slot.numel() + c_slot.numel()
                   + ev_free.numel()) + n_ev * E * (4 + 2) + n_w * E * (esz + 4) + n_c * (dim * esz + E * 4))
    bms, by = bound(nbytes, 0, "float32")
    ev_live, m_live, c_live = ev_rows[:n_ev].long(), m_rows[:n_w].long(), c_rows[:n_c].long()

    def aux_library(t, s):
        payload = torch.cat([t.index_select(0, ev_live), s["acc"].index_select(0, ev_live)], 1).to(torch.bfloat16)
        t.index_copy_(0, m_live, m_ent[:n_w, :dim].float())
        s["acc"].index_copy_(0, m_live, m_ent[:n_w, dim:].float())
        t.index_copy_(0, c_live, c_emb[:n_c].float())
        s["acc"].index_fill_(0, c_live, consts[0][1])
        return payload

    r = timed(row("cache_aux", shape=[C + 1, dim, n_ev, n_w, n_c], dtype="float32 pool, bf16 wires",
                  bound_ms=bms, bound_by=by, registers=build.get("cache_aux_kernel<8,false>", {}).get("registers"),
                  library_note="index_select + cat + index_copy_ (+ index_fill_ for the cold state), live rows"),
              kernel=lambda: ops.cache_aux(*pool, ev_rows, m_rows, m_ent, c_rows, c_emb, consts, True, **pairing),
              plain=lambda: cache_aux_reference(*pool, ev_rows, m_rows, m_ent, c_rows, c_emb, consts, True,
                                                **pairing),
              library=lambda: aux_library(*pool))
    pool_bytes = (table.numel() + acc.numel()) * 4
    rows.append(cold(r, lambda t, s: ops.cache_aux(t, s, ev_rows, m_rows, m_ent, c_rows, c_emb, consts, True,
                                                   **pairing),
                     lambda: (table.clone(), {k: v.clone() for k, v in state.items()}), pool_bytes,
                     aux_library, lambda: (table.clone(), {k: v.clone() for k, v in state.items()}), pool_bytes))
    # the same call storing the payload a second time into a ring (the
    # stream's hazard restores read it; 2b-1), four payloads long
    ring = torch.empty((4 * ev_rows.numel(), E), dtype=torch.bfloat16, device=dev)
    r["ring_ms"] = min(graph_ms(lambda: ops.cache_aux(*pool, ev_rows, m_rows, m_ent, c_rows, c_emb, consts, True,
                                                      ring=ring, ring_pos=ev_rows.numel(), **pairing))
                       for _ in range(2))
    r["over_launch_floor"] = r["ms"] / min(floor)
    print(f"  cache_aux warm {r['ms_runs']} ms = {r['over_launch_floor']:.3f}x the launch floor {min(floor):.5f} ms "
          f"(floor {floor}); cold {r['cold_ms_runs']}; with the ring {r['ring_ms']:.5f}; bound {r['bound_ms']:.5f} "
          f"({r['cold_share']:.1%} cold); registers {r.get('registers')}", flush=True)
    r.update(also_replaces=K12_ALSO_REPLACES, note="carries the stream's in-flight restores (_restore_rows)",
             **k12_stream_step(dev, inputs["stream_step"], floor))

    # (a) alone: the flush's read of every resident row
    fr = inputs["flush_rows"]
    fpad = np.zeros(1 << max(3, int(len(fr) - 1).bit_length()), np.int32)
    fpad[:len(fr)] = fr
    frows = torch.from_numpy(fpad).to(dev)
    nbytes = 4 * frows.numel() + 2 * frows.numel() * E * 4
    bms, by = bound(nbytes, 0, "float32")
    library = lambda t, a: torch.cat([t.index_select(0, frows), a.index_select(0, frows)], 1)  # noqa: E731
    r = timed(row("gather_entry_rows", shape=[C + 1, E, frows.numel()], dtype="float32", bound_ms=bms, bound_by=by,
                  registers=build.get("entry_rows_kernel<4,false>", {}).get("registers"),
                  library_note="index_select + cat"),
              kernel=lambda: ops.gather_entry_rows(table, state, frows),
              plain=lambda: gather_entry_rows_reference(table, state, frows),
              library=lambda: library(table, acc))
    rows.append(cold(r, lambda t, s: ops.gather_entry_rows(t, s, frows),
                     lambda: (table.clone(), {k: v.clone() for k, v in state.items()}), pool_bytes,
                     library, lambda: (table.clone(), acc.clone()), pool_bytes))
    r["over_launch_floor"] = r["ms"] / min(floor)
    print(f"  gather_entry_rows warm {r['ms_runs']} ms, cold {r['cold_ms_runs']} ms, bound {r['bound_ms']:.5f} "
          f"({r['cold_share']:.1%} cold; warm {r['bound_ms'] / r['ms']:.1%}); {r['over_launch_floor']:.2f}x the launch "
          f"floor", flush=True)

    # K13: the step's (26, 4096, 1) rows, with their keys, as the step calls it
    srows = inputs["rows"]
    S, B, L = srows.shape
    live = int((srows != C).sum())
    nbytes = 4 * srows.numel() + live * dim * 4 + S * B * dim * 4 + 4 * srows.numel()
    bms, by = bound(nbytes, live * dim, "float32")
    flat = srows.view(S * B, L)
    r = timed(row("cached_gather", shape=[S, B, L, C + 1, dim], dtype="float32", bound_ms=bms, bound_by=by,
                  library_note="F.embedding_bag(mode='sum', padding_idx=C) (no scale: per_sample_weights None)"),
              kernel=lambda: ops.cached_gather(table, srows, True, keys=True),
              plain=lambda: cached_gather_reference(table, srows, True, keys=True),
              library=lambda: F.embedding_bag(flat, table, mode="sum", padding_idx=C))
    rows.append(cold(r, lambda t, rr: ops.cached_gather(t, rr, True, keys=True),
                     lambda: (table.clone(), srows.clone()), pool_bytes // 2,
                     lambda t, rr: F.embedding_bag(rr.view(S * B, L), t, mode="sum", padding_idx=C),
                     lambda: (table.clone(), srows.clone()), pool_bytes // 2))
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (cold {r['cold_ms']:.4f}), plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']:.4f} (cold {r['library_cold_ms']:.4f}), bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), launches {r['launches_by_path']}", flush=True)
    return rows


def k12_stream_step(dev, step, floor) -> dict:
    """K12 at the saturated stream's last restoring step (its pieces, its
    ring position, its restores; on copies of the pool and the ring, which
    it writes in place), graph-replayed, each form twice: with its
    restores (one launch); without them (their payload slots listed
    unclaimed, as before the fold); and unfolded (that call, then a K12
    call of the restores alone: two launches). The bound: K12's bytes (the
    indices, the payload read in f32 and written twice, to the payload and
    the ring, in the wire's dtype; the warm and cold writes) plus the
    restores' (their three index arrays; each live restore's ring entry
    read and its pool entry written)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.hbm_cache.common import _bucket

    table, state, ring, consts = step["table"], step["state"], step["ring"], step["consts"]
    C, dim = table.shape[0] - 1, table.shape[1]
    E = dim + sum(v.shape[1] for v in state.values())
    empty = torch.empty(0, dtype=torch.int32, device=dev)
    ev_rows, ev_free = step["ev"]
    m_rows, m_ent, m_slot = step["miss"] or (empty, torch.empty((0, E), dtype=torch.bfloat16, device=dev), empty)
    c_rows, c_emb, c_slot = step["cold"] or (empty, torch.empty((0, dim), dtype=torch.bfloat16, device=dev), empty)
    r_src, r_dst, r_slot = step["restores"]
    ring_pos = step["ring_pos"]
    pool = (table.clone(), {k: v.clone() for k, v in state.items()})
    ring = ring.clone()
    pieces = (ev_rows, m_rows, m_ent, c_rows, c_emb, consts, True)
    # without the restores: their slots join the unclaimed list
    freed = torch.cat([ev_free[ev_free >= 0], r_slot[r_slot >= 0]]).sort().values
    free_wo = torch.full((_bucket(freed.numel()) if freed.numel() else 0,), -1, dtype=torch.int32, device=dev)
    free_wo[:freed.numel()] = freed

    def with_restores():
        ops.cache_aux(*pool, *pieces, m_slot=m_slot, c_slot=c_slot, ev_free=ev_free, ring=ring, ring_pos=ring_pos,
                      restores=(r_src, r_dst, r_slot))

    def without():
        ops.cache_aux(*pool, *pieces, m_slot=m_slot, c_slot=c_slot, ev_free=free_wo, ring=ring, ring_pos=ring_pos)

    no_slot = torch.full_like(r_slot, -1)

    def unfolded():
        without()
        ops.cache_aux(*pool, empty, empty, m_ent[:0], empty, c_emb[:0], consts, True, m_slot=empty, c_slot=empty,
                      ev_free=empty, ring=ring, ring_pos=None, restores=(r_src, r_dst, no_slot))

    n_ev = int((ev_rows < C).sum())
    n_w, n_c = int((m_rows < C + 1).sum()), int((c_rows < C + 1).sum())
    n_r = int((r_dst < C + 1).sum())
    esz, rsz = m_ent.element_size(), ring.element_size()
    k12_bytes = (4 * (ev_rows.numel() + m_rows.numel() + c_rows.numel() + m_slot.numel() + c_slot.numel()
                      + ev_free.numel()) + n_ev * E * (4 + 2 * rsz) + n_w * E * (esz + 4) + n_c * (dim * esz + E * 4))
    restore_bytes = 4 * 3 * r_dst.numel() + n_r * E * (rsz + 4)
    bms, _by = bound(k12_bytes + restore_bytes, 0, "float32")
    out = {"restores_ms": min(graph_ms(with_restores) for _ in range(2)),
           "no_restores_ms": min(graph_ms(without) for _ in range(2)),
           "unfolded_pair_ms": min(graph_ms(unfolded) for _ in range(2)),
           "restores_bound_ms": bms, "restores_bytes": restore_bytes, "restores_k12_bytes": k12_bytes,
           "restores_shape": [C + 1, E, ring.shape[0], n_ev, n_w, n_c, n_r, r_dst.numel()]}
    print(f"  cache_aux at the saturated stream's last restoring step ({n_r} live restores of {r_dst.numel()}, "
          f"{int((r_slot >= 0).sum())} on rows evicted that step; {n_ev} evictions, {n_w} warm, {n_c} cold, ring "
          f"from {ring_pos}): with its restores {out['restores_ms']:.5f} ms, without them {out['no_restores_ms']:.5f}, "
          f"unfolded into two launches {out['unfolded_pair_ms']:.5f}; bound {bms:.6f} ms ({k12_bytes} + "
          f"{restore_bytes} restore bytes); one-launch floor {min(floor):.5f} (floor {floor})", flush=True)
    return out


def time_flash_backward(dev, card):
    """The flash-attention backward, a dense recompute (the gradient of
    ``reference_attention`` at the saved q, k, v; it launches no kernel of
    its own), against SDPA's backward on the same inputs and output
    gradient at (4, 1024, 8, 64): ``torch.autograd.grad`` of each forward's
    output, by CUDA events around 20 eager calls (a call is far longer than
    its host enqueue). Bound: 10·B·H·D·(key, query pairs) operations (S
    recomputed, dP, dS·K, dSᵀ·Q, Pᵀ·dO), bf16 at its tensor-core rate, f32
    at three TF32 passes as the forward's f32 rows; bytes q, k, v, dO read
    and dq, dk, dv written once."""
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops

    print("== phase 5b: flash-attention backward (dense recompute) vs SDPA's backward", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 4)
    b, l, h, d = 4, 1024, 8, 64
    rows = []
    for dtype in (torch.bfloat16, torch.float32):
        for causal in (False, True):
            q, k, v, grad = (torch.randn((b, l, h, d), generator=g).to(dev, dtype) for _ in range(4))
            leaves = [t.requires_grad_(True) for t in (q, k, v)]
            ours = ops.flash_attention(*leaves, causal=causal)
            sdpa = F.scaled_dot_product_attention(*(t.transpose(1, 2) for t in leaves), is_causal=causal)
            grad_t = grad.transpose(1, 2)
            ours_bwd = lambda: torch.autograd.grad(ours, leaves, grad, retain_graph=True)  # noqa: E731
            sdpa_bwd = lambda: torch.autograd.grad(sdpa, leaves, grad_t, retain_graph=True)  # noqa: E731
            lib0, k0, k1, lib1 = (eager_ms(f, iters=20, warmup=3) for f in (sdpa_bwd, ours_bwd, ours_bwd, sdpa_bwd))
            err = max(float((a.float() - c.float()).abs().max()) for a, c in zip(ours_bwd(), sdpa_bwd()))
            pairs = l * (l + 1) // 2 if causal else l * l
            width = q.element_size()
            ops_ = 10 * b * h * d * pairs
            bms, by = (bound(7 * b * l * h * d * width, ops_, "bfloat16") if dtype == torch.bfloat16
                       else bound(7 * b * l * h * d * width, 3 * ops_, "tf32"))
            row = {"name": "flash_attention_bwd", "how": "dense recompute (reference_attention autograd)",
                   "replaces": "persia_tpu/ops/flash_attention.py:139", "shape": [b, l, h, d],
                   "dtype": str(dtype)[6:], "causal": causal, "ms": min(k0, k1), "ms_runs": [k0, k1],
                   "library_ms": min(lib0, lib1), "library_ms_runs": [lib0, lib1],
                   "library": "scaled_dot_product_attention backward", "bound_ms": bms, "bound_by": by,
                   "max_abs_diff_vs_library": err}
            print(json.dumps({"flash_bwd_timing": row, "card": card}), flush=True)
            rows.append(row)
            del ours, sdpa
    return rows


def sdpa_kernels(fn) -> list:
    """Names of the CUDA kernels one call of ``fn`` runs, by torch.profiler."""
    top, _, _ = kernel_trace(fn, calls=3)
    return list(top)


def phase_timing(dev, card, launches, errs, feats_shape, train_batch, fused, din_batch, build):
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.dot_interaction import (
        dot_interaction_bwd_reference, dot_interaction_reference,
    )
    from persia_tpu_torch.ops.embedding_pool import (
        gather_pool_bwd_reference, gather_pool_fwd_reference,
    )
    from persia_tpu_torch.ops.flash_attention import (
        reference_attention, tf32_split_planes_reference,
    )
    from persia_tpu_torch.ops.plans import tf32_plan

    print("== phase 5: timing", flush=True)
    g = torch.Generator(device="cpu").manual_seed(SEED + 3)
    rows = []
    # the one-launch floor: a one-element in-place add_, timed as every
    # kernel is (20 calls in a graph, 10 replays), twice
    one = torch.zeros(1, device=dev)
    floor = [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]
    print(f"  launch_floor_ms {floor} (a one-element add_, graph-replayed)", flush=True)

    b, l, h, d = 4, 1024, 8, 64
    q, k, v = (torch.randn((b, l, h, d), generator=g).to(dev) for _ in range(3))
    def timed(row, kernel, plain, library=None, plain_calls=20):
        """Fill a row's times: graph-replayed (``ms``, ``plain_ms``,
        ``library_ms``) and eager (``*eager_ms``), kernel and library in
        turns (library, kernel, kernel, library) so drift shows."""
        lib0 = timings(library) if library else None
        k0, k1 = timings(kernel), timings(kernel)
        lib1 = timings(library) if library else None
        plain_t = timings(plain, calls=plain_calls, eager_iters=plain_calls)
        row.update(
            ms=min(k0["graph"], k1["graph"]), eager_ms=min(k0["eager"], k1["eager"]),
            ms_runs=[k0["graph"], k1["graph"]],
            plain_ms=plain_t["graph"], plain_eager_ms=plain_t["eager"],
            library_ms=min(lib0["graph"], lib1["graph"]) if library else None,
            library_eager_ms=min(lib0["eager"], lib1["eager"]) if library else None,
            library_ms_runs=[lib0["graph"], lib1["graph"]] if library else None,
        )
        return row

    # f32 rows are bounded by the split-TF32 work (three TF32 products per
    # product) on the tensor cores; the same work on the FMA pipes, once,
    # is printed beside it as fma_bound_ms
    cases = [("wgmma_bf16", torch.bfloat16, False), ("wgmma_bf16", torch.bfloat16, True),
             ("tf32x3", torch.float32, False), ("tf32x3", torch.float32, True)]
    for route, dtype, causal in cases:
        x = [t.to(dtype) for t in (q, k, v)]
        xt = [t.transpose(1, 2) for t in x]
        width = x[0].element_size()
        pairs = l * (l + 1) // 2 if causal else l * l
        ops_ = 4 * b * h * d * pairs
        extra = {}
        if route == "tf32x3":
            bms, by = bound(4 * b * l * h * d * width, 3 * ops_, "tf32")
            extra = dict(bound_note="3 x operations / 494.7 TFLOP/s (TF32)",
                         fma_bound_ms=bound(4 * b * l * h * d * width, ops_, "float32")[0])
        else:
            bms, by = bound(4 * b * l * h * d * width, ops_, "bfloat16")
        library = lambda: F.scaled_dot_product_attention(*xt, is_causal=causal)  # noqa: E731
        if dtype == torch.float32:
            extra["library_kernels"] = sdpa_kernels(library)
            print(f"  SDPA f32 causal={causal} runs: {extra['library_kernels']}", flush=True)
        rows.append(timed(
            dict(name="flash_attention", route="cuda", cuda_route=route,
                 source=FA_SOURCE[route], replaces=FA_REPLACES,
                 shape=[b, l, h, d], dtype=str(dtype)[6:], causal=causal,
                 launches=launches["flash_attention"][route],
                 max_abs_err=errs["flash_attention"]["bf16" if route == "wgmma_bf16" else "f32"],
                 bound_ms=bms, bound_by=by, **extra),
            kernel=lambda: ops.flash_attention(*x, causal=causal),
            plain=lambda: reference_attention(*x, causal=causal),
            library=library,
            plain_calls=4,
        ))

    # the f32 route's pre-pass alone (its time is inside the f32 rows):
    # reads q, k, v once, writes six planes; no PyTorch call computes it
    pad = tf32_plan(b, l, h, d, False).seq_pad
    bms, by = bound(3 * b * l * h * d * 4 + 6 * b * h * pad * d * 4, 0, "float32")
    rows.append(timed(
        dict(name="tf32_split_planes", route="cuda", cuda_route="tf32x3",
             source=FA_SOURCE["tf32x3"], replaces=FA_REPLACES,
             shape=[b, l, h, d], dtype="float32",
             launches=launches["flash_attention"]["tf32_split_planes"],
             max_abs_err=errs["flash_attention"]["tf32_split_planes"],
             bound_ms=bms, bound_by=by),
        kernel=lambda: ops.tf32_split_planes(q, k, v),
        plain=lambda: tf32_split_planes_reference(q, k, v),
        plain_calls=4,
    ))

    feats = torch.randn(feats_shape, generator=g).to(dev, torch.bfloat16)
    bsz, n, dim = feats_shape
    pairs = n * (n - 1) // 2
    bms, by = bound(bsz * n * dim * 2 + bsz * pairs * 2, 2 * bsz * pairs * dim, "bfloat16")
    rows.append(timed(
        dict(name="dot_interaction", route="cuda", cuda_route="cuda",
             source="persia_tpu_torch/csrc/dot_interaction.cu", replaces=DOT_REPLACES,
             shape=list(feats_shape), dtype="bfloat16",
             launches=launches["training"]["dot_interaction"],
             launches_by_path={p: launches[p]["dot_interaction"] for p in ("serving", "training", "pipelined", "durable")},
             max_abs_err=errs["dot_interaction"], bound_ms=bms, bound_by=by),
        kernel=lambda: ops.dot_interaction(feats),
        plain=lambda: dot_interaction_reference(feats),
        # the full (B, n, n) product: a superset of the function, the
        # nearest one-call yardstick
        library=lambda: torch.bmm(feats, feats.transpose(1, 2)),
    ))

    # the backward: reads feats and g, writes dfeats; 2 (n - 1) d FLOP per
    # feature row. Yardstick: bmm of the symmetrised (B, n, n) gradient
    gpair = torch.randn((bsz, pairs), generator=g).to(dev, torch.bfloat16)
    iu, ju = torch.triu_indices(n, n, offset=1, device=dev)
    gsym = torch.zeros((bsz, n, n), device=dev, dtype=torch.bfloat16)
    gsym[:, iu, ju] = gpair
    gsym[:, ju, iu] = gpair
    bms, by = bound(2 * bsz * n * dim * 2 + bsz * pairs * 2, 2 * bsz * n * (n - 1) * dim, "bfloat16")
    rows.append(timed(
        dict(name="dot_interaction_bwd", route="cuda", cuda_route="cuda",
             source="persia_tpu_torch/csrc/dot_interaction.cu", replaces=DOT_REPLACES,
             shape=list(feats_shape), dtype="bfloat16",
             launches=launches["training"]["dot_interaction_bwd"],
             launches_by_path={p: launches[p]["dot_interaction_bwd"] for p in ("training", "pipelined", "durable")},
             max_abs_err=errs["dot_interaction_bwd"], bound_ms=bms, bound_by=by),
        kernel=lambda: ops.dot_interaction_bwd(feats, gpair),
        plain=lambda: dot_interaction_bwd_reference(feats, gpair),
        library=lambda: torch.bmm(gsym, feats),
    ))

    # the gather-pool pair at the training path's own inputs (one staged
    # step's batch): bytes = each input once, each output once (the
    # function's: the backward kernel's index reads and partials are not
    # counted, so the rows compare across designs)
    emb = [e for e in train_batch["emb"] if "pool_index" in e]
    prow = [e["distinct"] for e in emb]
    pslots = [ops.PoolSlot(e["pool_index"], e.get("pool_counts"), e["pool_order"], e["pool_offsets"])
              for e in emb]
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts if t is not None)  # noqa: E731
    pooled = ops.gather_pool_fwd(prow, pslots)
    gpool = torch.randn(pooled.shape, generator=g).to(dev)
    p_rows, width = prow[0].shape
    shape = [bsz, len(prow), width, p_rows]
    # yardsticks: the slots' tables side by side, indexes shifted into them
    table = torch.cat(prow)
    shift = torch.arange(len(prow), device=dev, dtype=torch.int64)[None, :, None] * p_rows
    flat_idx = (torch.stack([s.index.long() for s in pslots], 1) + shift).reshape(bsz * len(prow), -1)
    acc = torch.zeros(table.shape, device=dev, dtype=torch.float32)
    grad_flat = gpool.reshape(bsz * len(prow), width)
    clone = lambda t: None if t is None else t.clone()  # noqa: E731

    def clone_group(rows_, slots_):
        return [r.clone() for r in rows_], [ops.PoolSlot(*map(clone, s)) for s in slots_]

    def with_cold(row, kernel, make_copy, copy_bytes, library=None, make_lib_copy=None, lib_bytes=0):
        """Cold times beside the warm ones (library, kernel, kernel, library)
        and the share read from the cold kernel time."""
        lib0 = cold_ms(library, make_lib_copy, lib_bytes) if library else None
        k0, k1 = cold_ms(kernel, make_copy, copy_bytes), cold_ms(kernel, make_copy, copy_bytes)
        lib1 = cold_ms(library, make_lib_copy, lib_bytes) if library else None
        row.update(
            cold_ms=min(k0["ms"], k1["ms"]), cold_ms_runs=[k0["ms"], k1["ms"]],
            cold_copies=k0["copies"], cold_bytes_per_copy=copy_bytes,
            library_cold_ms=min(lib0["ms"], lib1["ms"]) if library else None,
            library_cold_copies=lib0["copies"] if library else None,
        )
        row["cold_share"] = row["bound_ms"] / row["cold_ms"]
        return row

    fwd_in = nbytes(prow) + nbytes([s.index for s in pslots] + [s.counts for s in pslots])
    bms, by = bound(fwd_in + pooled.numel() * 4, pooled.numel() * flat_idx.shape[1], "float32")
    rows.append(with_cold(
        timed(
            dict(name="gather_pool_fwd", route="cuda", cuda_route="cuda",
                 source="persia_tpu_torch/csrc/embedding_pool.cu", replaces=POOL_REPLACES,
                 shape=shape, dtype=str(prow[0].dtype)[6:],
                 launches=launches["training"]["gather_pool_fwd"],
                 launches_by_path={p: launches[p]["gather_pool_fwd"] for p in ("serving", "training", "pipelined", "durable")},
                 max_abs_err=errs["gather_pool_fwd"], bound_ms=bms, bound_by=by,
                 library_note="F.embedding_bag(mode='sum') over the slots' tables side by side, bf16 out"),
            kernel=lambda: ops.gather_pool_fwd(prow, pslots),
            plain=lambda: gather_pool_fwd_reference(prow, pslots),
            library=lambda: F.embedding_bag(flat_idx, table, mode="sum"),
        ),
        kernel=ops.gather_pool_fwd, make_copy=lambda: clone_group(prow, pslots), copy_bytes=fwd_in,
        library=lambda i, t: F.embedding_bag(i, t, mode="sum"),
        make_lib_copy=lambda: (flat_idx.clone(), table.clone()), lib_bytes=nbytes([flat_idx, table]),
    ))
    bwd_in = gpool.numel() * 4 + nbytes([s.order for s in pslots] + [s.offsets for s in pslots]
                                        + [s.counts for s in pslots])
    bms, by = bound(bwd_in + nbytes(prow), gpool.numel() * flat_idx.shape[1], "float32")
    # a cold copy also holds the index the kernel reads
    bwd_copy = bwd_in + nbytes([s.index for s in pslots])
    single_id = flat_idx.shape[1] == 1
    rows.append(with_cold(
        timed(
            dict(name="gather_pool_bwd", route="cuda", cuda_route="cuda",
                 source="persia_tpu_torch/csrc/embedding_pool.cu", replaces=POOL_REPLACES,
                 shape=shape, dtype=str(prow[0].dtype)[6:],
                 launches=launches["training"]["gather_pool_bwd"],
                 launches_by_path={p: launches[p]["gather_pool_bwd"] for p in ("training", "pipelined", "durable")},
                 max_abs_err=errs["gather_pool_bwd"], bound_ms=bms, bound_by=by,
                 library_note="index_add_ of the (B*S, dim) f32 gradient into the tables side by side (L=1)"),
            kernel=lambda: ops.gather_pool_bwd(gpool, prow, pslots),
            plain=lambda: gather_pool_bwd_reference(gpool, prow, pslots),
            library=(lambda: acc.index_add_(0, flat_idx[:, 0], grad_flat)) if single_id else None,
        ),
        kernel=lambda gr, r, sl: ops.gather_pool_bwd(gr, r, sl),
        make_copy=lambda: (gpool.clone(), *clone_group(prow, pslots)), copy_bytes=bwd_copy,
        library=(lambda i, gr: acc.index_add_(0, i, gr)) if single_id else None,
        make_lib_copy=lambda: (flat_idx[:, 0].clone(), grad_flat.clone()),
        lib_bytes=nbytes([flat_idx[:, 0], grad_flat]),
    ))
    # the backward's two passes apart (torch.profiler), and its time where
    # every position of each slot hits one row (the bench shape otherwise)
    top, _, _ = kernel_trace(lambda: ops.gather_pool_bwd(gpool, prow, pslots))
    rows[-1]["pass_ms"] = {re.search(r"segment_sum_\w+", k).group(0): v for k, v in top.items()
                           if "segment_sum" in k}
    one_rows, one_slots = pool_inputs(dev, prow[0].dtype, bsz, [(p_rows - 1, 1, False)] * len(prow),
                                      seed=SEED, ids="one_row")
    rows[-1]["one_row_ms"] = graph_ms(lambda: ops.gather_pool_bwd(gpool, one_rows, one_slots))

    # the fused tier's kernels at the fused path's own inputs (one bench
    # batch of 26 x 4096 ids, the stacked 26M x 16 table and its Adagrad
    # state, as phase 4e left them); warm (the same batch each call) and
    # cold (fresh batches, rotated: the rows they name spread over the
    # 1.66 GB table, > 72 MB of distinct rows in all), the share read from
    # the cold time
    from persia_tpu_torch.ops.fused_gather import fused_gather_reference, gather_rows
    from persia_tpu_torch.ops.sparse_update import (
        PAD_SENTINEL, sparse_update_reference, sparse_update_sorted, update_keys_reference,
    )

    grp, tbl, acc, cfg = fused["group"], fused["table"], fused["state"], fused["cfg"]
    vocabs = [VOCAB] * len(grp.slots)
    fresh = np.random.default_rng(SEED + 7)

    def fresh_ids(kind):
        """One fresh batch's ids per slot, as ``fused_host_batches`` draws
        them (zipf with a fresh per-slot shift: other hot rows each time)."""
        if kind == "uniform":
            ids = [fresh.integers(0, VOCAB, BATCH, dtype=np.int32) for _ in grp.slots]
        else:
            ids = [((fresh.zipf(1.2, BATCH) - 1 + fresh.integers(0, VOCAB)) % VOCAB).astype(np.int32)
                   for _ in grp.slots]
        return [torch.from_numpy(i).to(dev) for i in ids]

    def flat_rows(ids):
        return torch.cat([gather_rows(i, o, VOCAB, True) for i, o in zip(ids, grp.offsets)])

    ids = [fused["batch"]["ids"][nm] for nm in grp.slots]
    n_pos = sum(i.numel() for i in ids)
    k4_rows = flat_rows(ids)
    k4_copy = n_pos * 4 + n_pos * EMB_DIM * 4  # the ids and the rows they name
    # K4 as the step calls it, with the update keys: the ids read, each row
    # read and written, each key written; beside it K4 without keys (its
    # bound without the keys), before and after, so drift shows
    bms, by = bound(n_pos * 4 + 2 * n_pos * EMB_DIM * 4 + n_pos * 4, 0, "float32")
    no_keys = lambda: ops.fused_gather(tbl, ids, grp.offsets, vocabs, True)  # noqa: E731
    no_keys_cold = lambda: cold_ms(lambda i: ops.fused_gather(tbl, i, grp.offsets, vocabs, True),  # noqa: E731
                                   lambda: (fresh_ids("uniform"),), k4_copy)["ms"]
    nk_warm, nk_cold = [graph_ms(no_keys)], [no_keys_cold()]
    rows.append(with_cold(
        timed(
            dict(name="fused_gather", route="cuda", cuda_route="cuda", source=K4_SOURCE, replaces=K4_REPLACES,
                 shape=[n_pos, EMB_DIM, tbl.shape[0]], dtype="float32", keys=True,
                 launches=launches["fused"]["fused_gather"],
                 max_abs_err=errs["fused_gather"], bound_ms=bms, bound_by=by,
                 registers=build.get("fused_gather_kernel<uint4>", {}).get("registers"),
                 plain_note="fused_gather_reference and update_keys_reference",
                 library_note="torch.index_select of the table at the clamped, offset rows (int64); the rows "
                              "only: no one PyTorch call computes the keys"),
            kernel=lambda: ops.fused_gather(tbl, ids, grp.offsets, vocabs, True, keys=True),
            plain=lambda: (fused_gather_reference(tbl, ids, grp.offsets, vocabs, True),
                           update_keys_reference(ids, grp.offsets, vocabs)),
            library=lambda: torch.index_select(tbl, 0, k4_rows),
        ),
        kernel=lambda i: ops.fused_gather(tbl, i, grp.offsets, vocabs, True, keys=True),
        make_copy=lambda: (fresh_ids("uniform"),), copy_bytes=k4_copy,
        library=lambda r: torch.index_select(tbl, 0, r),
        make_lib_copy=lambda: (flat_rows(fresh_ids("uniform")),), lib_bytes=n_pos * 8 + n_pos * EMB_DIM * 4,
    ))
    nk_warm.append(graph_ms(no_keys))
    nk_cold.append(no_keys_cold())
    k4 = rows[-1]
    k4.update(no_keys_ms=min(nk_warm), no_keys_ms_runs=nk_warm, no_keys_cold_ms=min(nk_cold),
              no_keys_cold_ms_runs=nk_cold, no_keys_bound_ms=bound(n_pos * 4 + 2 * n_pos * EMB_DIM * 4, 0,
                                                                    "float32")[0])
    k4.update(routing_cost_ms=k4["ms"] - k4["no_keys_ms"], routing_cost_cold_ms=k4["cold_ms"] - k4["no_keys_cold_ms"])

    def k5_inputs(ids):
        """K5's inputs for one batch: the step's sentinel-routed update ids,
        sorted; gradients of the step's size; the touched rows; the bound."""
        flat = update_keys_reference(ids, grp.offsets, vocabs)
        sids, perm = torch.sort(flat, stable=True)
        grads = torch.randn((flat.numel(), EMB_DIM), generator=g).to(dev) * 1e-3
        touched = int(torch.unique(sids[sids != PAD_SENTINEL]).numel())
        n = flat.numel()
        # sorted ids, permutation and gradients read once; each touched
        # row and its accumulator read and written once; the segment sums
        # and ~8 operations a touched element
        nbytes = n * 4 + n * 8 + n * EMB_DIM * 4 + touched * EMB_DIM * 4 * 4
        b_, by_ = bound(nbytes + 8, n * EMB_DIM + touched * EMB_DIM * 8, "float32")
        return flat, sids, perm, grads, touched, nbytes, b_, by_

    bs = torch.ones(2, device=dev)
    k5 = {}
    for kind in ("uniform", "zipf"):
        batch = fused["batch" if kind == "uniform" else "zipf_batch"]
        flat, sids, perm, grads, touched, k5_bytes, bms, by = k5_inputs([batch["ids"][nm] for nm in grp.slots])
        runs = [graph_ms(lambda: sparse_update_sorted(cfg, tbl, acc, sids, perm, grads, bs)) for _ in range(2)]
        cold = [cold_ms(lambda si, pe, gr: sparse_update_sorted(cfg, tbl, acc, si, pe, gr, bs),
                        lambda: k5_inputs(fresh_ids(kind))[1:4], k5_bytes) for _ in range(2)]
        sort_ms = graph_ms(lambda: torch.sort(flat, stable=True))
        # each of K5's steps apart (torch.profiler over 20 warm calls)
        top, _, _ = kernel_trace(lambda: sparse_update_sorted(cfg, tbl, acc, sids, perm, grads, bs))
        stages = {re.search(r"sparse_update_\w+_kernel|Memset", k).group(0): v for k, v in top.items()
                  if "sparse_update" in k or "Memset" in k}
        longest = longest_segment(sids)
        print(f"  sparse_update {kind}: {touched} rows touched, longest segment {longest}; warm {runs} ms, cold "
              f"{[c['ms'] for c in cold]} ms (bound {bms:.5f}); torch.sort {sort_ms:.5f} ms; steps {stages}",
              flush=True)
        k5[kind] = dict(ms=min(runs), ms_runs=runs, cold_ms=min(c["ms"] for c in cold),
                        longest_segment=longest, stage_ms=stages,
                        cold_ms_runs=[c["ms"] for c in cold], cold_copies=cold[0]["copies"], sort_ms=sort_ms,
                        bound_ms=bms, bound_by=by, touched_rows=touched, bytes=k5_bytes,
                        eager_ms=eager_ms(lambda: sparse_update_sorted(cfg, tbl, acc, sids, perm, grads, bs)),
                        # its boolean masks synchronise: timed eagerly, sort included
                        plain_ms=eager_ms(lambda: sparse_update_reference(cfg, tbl, acc, flat, grads, bs),
                                          iters=10, warmup=2))
    u, z = k5["uniform"], k5["zipf"]
    # every position of the batch on one row: one long segment
    one = torch.full((n_pos,), grp.offsets[0] + 5, dtype=torch.int32, device=dev)
    one_perm = torch.arange(n_pos, device=dev)
    one_grads = torch.randn((n_pos, EMB_DIM), generator=g).to(dev) * 1e-3
    one_row_ms = min(graph_ms(lambda: sparse_update_sorted(cfg, tbl, acc, one, one_perm, one_grads, bs))
                     for _ in range(2))
    print(f"  sparse_update one row ({n_pos} positions): {one_row_ms:.5f} ms", flush=True)
    rows.append(dict(
        name="sparse_update", route="cuda", cuda_route="cuda", source=K5_SOURCE, replaces=K5_REPLACES,
        shape=[n_pos, EMB_DIM, tbl.shape[0]], dtype="float32", optimizer="Adagrad(lr=0.05)",
        launches=launches["fused"]["sparse_update"], max_abs_err=errs["sparse_update"],
        ms=u["ms"], ms_runs=u["ms_runs"], eager_ms=u["eager_ms"], bound_ms=u["bound_ms"], bound_by=u["bound_by"],
        cold_ms=u["cold_ms"], cold_ms_runs=u["cold_ms_runs"], cold_copies=u["cold_copies"],
        cold_bytes_per_copy=u["bytes"], cold_share=u["bound_ms"] / u["cold_ms"],
        plain_ms=u["plain_ms"], plain_note="eager (boolean masks synchronise), the sort included",
        library_ms=None, library_note="none: no PyTorch call computes it",
        sort_ms=u["sort_ms"], touched_rows=u["touched_rows"],
        zipf_ms=z["ms"], zipf_ms_runs=z["ms_runs"], zipf_cold_ms=z["cold_ms"], zipf_cold_ms_runs=z["cold_ms_runs"],
        zipf_bound_ms=z["bound_ms"], zipf_cold_share=z["bound_ms"] / z["cold_ms"], zipf_sort_ms=z["sort_ms"],
        zipf_plain_ms=z["plain_ms"], zipf_touched_rows=z["touched_rows"],
        longest_segment=u["longest_segment"], zipf_longest_segment=z["longest_segment"],
        stage_ms=u["stage_ms"], zipf_stage_ms=z["stage_ms"], one_row_ms=one_row_ms,
    ))
    # the standalone routing pass (the graph step's warm-up; the step routes
    # inside K4) at the fused path's own batch: reads the ids, writes the
    # keys; its plain version (per-slot comparisons, a where, a cast and the
    # cat) and torch.sort beside it. Its launches: the graph step's capture
    # (the eager step launches it never)
    bms, by = bound(2 * n_pos * 4, 0, "float32")
    rows.append(timed(
        dict(name="update_keys", route="cuda", cuda_route="cuda", source=K5_SOURCE, replaces=ROUTING_REPLACES,
             shape=[len(ids), BATCH], dtype="int32", launches=launches["fused_capture"]["update_keys"],
             launches_by_path={"fused graph step's capture": launches["fused_capture"]["update_keys"],
                               "fused eager step": launches["fused"]["update_keys"]},
             max_abs_err=errs["update_keys"], bound_ms=bms, bound_by=by, sort_ms=u["sort_ms"],
             library_note="none: no one PyTorch call computes it"),
        kernel=lambda: ops.update_keys(ids, grp.offsets, vocabs),
        plain=lambda: update_keys_reference(ids, grp.offsets, vocabs),
    ))
    # K6-K9 at the DIN path's own inputs (one staged step of phase 4g: the
    # two raw slots of B x L positions with their CSR, the f32 wire) and,
    # for K8/K9, that step's history rows cast to bf16 as the model casts
    # them, with its masks; warm and cold (> 72 MB of input copies)
    from persia_tpu_torch.ops.attention_pool import attention_pool_bwd_reference, attention_pool_fwd_reference
    from persia_tpu_torch.ops.raw_gather import raw_gather_bwd_reference, raw_gather_fwd_reference

    raw_e = [e for e in din_batch["emb"] if "mask" in e]
    rrows = [e["distinct"] for e in raw_e]
    rslots = [ops.RawSlot(e["index"], e["order"], e["offsets"], e["long_chunks"]) for e in raw_e]
    gathered = ops.raw_gather_fwd(rrows, rslots)
    n_slots, bsz, hist_len, dim = gathered.shape
    elem = gathered.element_size()
    din_launches = {p: {k: launches[p][k] for k in DIN_KERNELS} for p in ("din_training", "din_serving")}
    table = torch.cat(rrows)
    starts = np.cumsum([0] + [r.shape[0] for r in rrows[:-1]])
    flat = torch.cat([s.index.reshape(-1).long() + int(o) for s, o in zip(rslots, starts)])

    def clone_raw(rows_, slots_):
        return [r.clone() for r in rows_], [ops.RawSlot(*map(clone, s)) for s in slots_]

    # K6 reads the index and the distinct rows it names, writes the positions' rows
    named = sum(int(torch.unique(s.index).numel()) for s in rslots) * dim * elem
    idx_bytes = nbytes([s.index for s in rslots])
    bms, by = bound(idx_bytes + named + gathered.numel() * elem, 0, "float32")
    raw_copy = nbytes(rrows) + idx_bytes
    rows.append(with_cold(
        timed(
            dict(name="raw_gather_fwd", route="cuda", cuda_route="cuda", source=RAW_SOURCE, replaces=RAW_REPLACES,
                 shape=[n_slots, bsz, hist_len, dim], dtype=str(gathered.dtype)[6:],
                 launches=launches["din_training"]["raw_gather_fwd"],
                 launches_by_path={p: v["raw_gather_fwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["raw_gather_fwd"], bound_ms=bms, bound_by=by, named_rows_bytes=named,
                 library_note="torch.index_select of the slots' rows side by side (int64 index)"),
            kernel=lambda: ops.raw_gather_fwd(rrows, rslots),
            plain=lambda: raw_gather_fwd_reference(rrows, rslots),
            library=lambda: torch.index_select(table, 0, flat),
        ),
        kernel=lambda r, s: ops.raw_gather_fwd(r, s), make_copy=lambda: clone_raw(rrows, rslots), copy_bytes=raw_copy,
        library=lambda t, i: torch.index_select(t, 0, i),
        make_lib_copy=lambda: (table.clone(), flat.clone()), lib_bytes=nbytes([table, flat]),
    ))
    # K7 reads the live positions' gradients and their CSR entries, writes
    # every distinct row (the pad row's positions are not in the CSR)
    rgrad = torch.randn(gathered.shape, generator=g).to(dev, gathered.dtype)
    live = [int(s.offsets[-1]) for s in rslots]
    csr_bytes = nbytes([s.offsets for s in rslots]) + 4 * sum(live)
    bms, by = bound(sum(live) * dim * elem + csr_bytes + nbytes(rrows), sum(live) * dim, "float32")
    acc_lib = torch.zeros(table.shape, device=dev, dtype=table.dtype)
    rgrad_flat = rgrad.reshape(-1, dim)
    pad_rows = torch.cat([torch.full((s.index.numel(),), int(o) + r.shape[0] - 1, device=dev)
                          for s, o, r in zip(rslots, starts, rrows)])
    live_sel = torch.nonzero(flat != pad_rows).reshape(-1)
    flat_live, rgrad_live = flat[live_sel], rgrad_flat[live_sel]
    longest = [int((s.offsets[1:] - s.offsets[:-1]).max()) for s in rslots]
    rows.append(with_cold(
        timed(
            dict(name="raw_gather_bwd", route="cuda", cuda_route="cuda", source=RAW_SOURCE, replaces=RAW_REPLACES,
                 shape=[n_slots, bsz, hist_len, dim], dtype=str(gathered.dtype)[6:],
                 launches=launches["din_training"]["raw_gather_bwd"],
                 launches_by_path={p: v["raw_gather_bwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["raw_gather_bwd"], bound_ms=bms, bound_by=by,
                 live_positions=live, longest_segment=longest,
                 library_note="Tensor.index_add_ (atomic) of the live positions' gradients into the slots' rows "
                              "side by side, in the wire dtype"),
            kernel=lambda: ops.raw_gather_bwd(rgrad, rrows, rslots),
            plain=lambda: raw_gather_bwd_reference(rgrad, rrows, rslots),
            library=lambda: acc_lib.index_add_(0, flat_live, rgrad_live),
        ),
        kernel=lambda gr, r, sl: ops.raw_gather_bwd(gr, r, sl),
        make_copy=lambda: (rgrad.clone(), *clone_raw(rrows, rslots)),
        copy_bytes=rgrad.numel() * elem + nbytes([s.order for s in rslots] + [s.offsets for s in rslots]) + raw_copy,
        library=lambda i, gr: acc_lib.index_add_(0, i, gr),
        make_lib_copy=lambda: (flat_live.clone(), rgrad_live.clone()), lib_bytes=nbytes([flat_live, rgrad_live]),
    ))
    # K7 with every position of both slots on one row (long rows: a block a
    # chunk), and the device's events over 20 calls by name (a kernel a
    # call, no memset; the trace may miss some events, so they are counted
    # by name, not held to 20)
    one_rows, one_slots = raw_inputs(dev, gathered.dtype, SEED, "one_row", batch=bsz, hist=hist_len,
                                     distinct=[r.shape[0] - 1 for r in rrows])
    k7 = rows[-1]
    k7["one_row_ms"] = min(graph_ms(lambda: ops.raw_gather_bwd(rgrad, one_rows, one_slots)) for _ in range(2))
    top, runs, k7["trace_sessions"] = kernel_trace(lambda: ops.raw_gather_bwd(rgrad, rrows, rslots))
    k7["trace_20_calls"] = {"raw_gather_bwd_kernel": runs["raw_gather_bwd_kernel"],
                            "segment_sum": runs["segment_sum_chunks_kernel"] + runs["segment_sum_rows_kernel"],
                            "device_events_ms_a_call": top}
    k7["index_add_over_kernel"] = {"warm": k7["library_ms"] / k7["ms"], "cold": k7["library_cold_ms"] / k7["cold_ms"]}
    print(f"  raw_gather_bwd: live positions {live} of {bsz * hist_len} a slot, longest segment {longest}; "
          f"warm {k7['ms']:.5f} ms, cold {k7['cold_ms']:.5f} ms; index_add_ {k7['library_ms']:.5f} warm, "
          f"{k7['library_cold_ms']:.5f} cold (index_add_ / K7: {k7['index_add_over_kernel']['warm']:.3f} warm, "
          f"{k7['index_add_over_kernel']['cold']:.3f} cold); one row of {bsz * hist_len} positions a slot "
          f"{k7['one_row_ms']:.5f} ms; 20 calls in the trace: {k7['trace_20_calls']} ({k7['trace_sessions']} "
          "profiler sessions)", flush=True)

    # K8, K9: the step's masks and history rows in bf16; a masked position's
    # row is not needed (bound: the valid positions' rows)
    mask = raw_e[0]["mask"]
    hist = gathered[0].to(torch.bfloat16)
    logits = torch.randn(mask.shape, generator=g).to(dev)
    valid = int(mask.sum())
    out, w = ops.attention_pool_fwd(logits, mask, hist)
    d_out = torch.randn(out.shape, generator=g).to(dev, torch.bfloat16)
    small = logits.numel() * 4 + mask.numel()  # logits or d_logits, the mask
    bms, by = bound(small + valid * dim * 2 + out.numel() * 2 + w.numel() * 4, valid * dim * 2, "float32")
    masked = torch.where(mask, logits, float("-inf"))
    att_copy = nbytes([logits, mask, hist])

    def composite():  # two PyTorch calls: softmax over L, then the weighted sum
        return torch.bmm(torch.softmax(masked, dim=1).to(torch.bfloat16)[:, None, :], hist)

    rows.append(with_cold(
        timed(
            dict(name="attention_pool_fwd", route="cuda", cuda_route="cuda", source=ATT_SOURCE, replaces=ATT_REPLACES,
                 shape=[bsz, hist_len, dim], dtype="bfloat16", valid_positions=valid,
                 launches=launches["din_training"]["attention_pool_fwd"],
                 launches_by_path={p: v["attention_pool_fwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["attention_pool_fwd"], bound_ms=bms, bound_by=by,
                 registers=build.get(f"attention_pool_fwd_kernel<{ATT_DIN_TEMPLATE}>", {}).get("registers"),
                 composite_ms=min(graph_ms(composite) for _ in range(2)),
                 library_note="none: no one PyTorch call computes it; composite_ms is torch.softmax + torch.bmm "
                              "(two calls, no mask on empty rows)"),
            kernel=lambda: ops.attention_pool_fwd(logits, mask, hist),
            plain=lambda: attention_pool_fwd_reference(logits, mask, hist),
        ),
        kernel=lambda lg, m, h: ops.attention_pool_fwd(lg, m, h),
        make_copy=lambda: (logits.clone(), mask.clone(), hist.clone()), copy_bytes=att_copy,
    ))
    # reads d_out, the mask, the valid rows and w; writes d_hist and d_logits
    bms, by = bound(small + d_out.numel() * 2 + valid * dim * 2 + w.numel() * 4 + hist.numel() * 2,
                    3 * valid * dim, "float32")
    rows.append(with_cold(
        timed(
            dict(name="attention_pool_bwd", route="cuda", cuda_route="cuda", source=ATT_SOURCE, replaces=ATT_REPLACES,
                 shape=[bsz, hist_len, dim], dtype="bfloat16", valid_positions=valid,
                 launches=launches["din_training"]["attention_pool_bwd"],
                 launches_by_path={p: v["attention_pool_bwd"] for p, v in din_launches.items()},
                 max_abs_err=errs["attention_pool_bwd"], bound_ms=bms, bound_by=by,
                 registers=build.get(f"attention_pool_bwd_kernel<{ATT_DIN_TEMPLATE}>", {}).get("registers"),
                 library_note="none: no one PyTorch call computes it"),
            kernel=lambda: ops.attention_pool_bwd(d_out, mask, hist, w),
            plain=lambda: attention_pool_bwd_reference(d_out, mask, hist, w),
        ),
        kernel=lambda d, m, h, w_: ops.attention_pool_bwd(d, m, h, w_),
        make_copy=lambda: (d_out.clone(), mask.clone(), hist.clone(), w.clone()),
        copy_bytes=att_copy + nbytes([d_out, w]) - logits.numel() * 4,
    ))
    # K9 is one kernel a call: the device's events over 20 calls by name
    k9 = rows[-1]
    top, runs, k9["trace_sessions"] = kernel_trace(lambda: ops.attention_pool_bwd(d_out, mask, hist, w))
    if not top:
        raise SystemExit(f"attention_pool_bwd's trace held no device record in {k9['trace_sessions']} sessions "
                         f"(a profiler session now records device work: {profiler_records_device_work(dev)})")
    k9["trace_20_calls"] = {"attention_pool_bwd_kernel": runs["attention_pool_bwd_kernel"],
                            "device_events_ms_a_call": top}
    print(f"  attention_pool_bwd: warm {k9['ms']:.5f} ms, cold {k9['cold_ms']:.5f} ms, bound {k9['bound_ms']:.5f} "
          f"({k9['bound_ms'] / k9['cold_ms']:.1%} cold); registers {k9['registers']} at <{ATT_DIN_TEMPLATE}>; "
          f"20 calls in the trace: {k9['trace_20_calls']} ({k9['trace_sessions']} profiler sessions)", flush=True)
    if not runs["attention_pool_bwd_kernel"] or any("attention_pool_bwd_kernel" not in n for n in top):
        raise SystemExit(f"attention_pool_bwd ran other device work than its kernel: {top}")
    # K10 and K11 at the DNN training path's first batch norm (serving-bench
    # width: B=4096, C=128, bf16) and, beside it, its second (C=32) and
    # the serving path's eval mode (B=256); warm and cold. Bound: x (and
    # dy) read once, y (dx) written once, the (C,) parameters and
    # statistics; the kernels read x twice, the second time from L2.
    # library: F.batch_norm(training=True) and aten's
    # native_batch_norm_backward on the same inputs (their running variance
    # is the unbiased one: a time comparison only)
    from persia_tpu_torch.ops.batch_norm import batch_norm_bwd_reference, batch_norm_fwd_reference

    bn_paths = ("dnn_adult", "dnn_training", "dnn_serving", "dnn_resume", "dnn_cache")
    bn_launches = {p: {k: launches[p][k] for k in BN_KERNELS} for p in bn_paths}
    bx, bdy, bscale, bbias, bmean, bvar = bn_inputs(dev, BATCH, 128, torch.bfloat16, SEED + 11)
    brm, brv, lrm, lrv = bmean.clone(), bvar.clone(), bmean.clone(), bvar.clone()
    n_el, cols = bx.numel(), bx.shape[1]
    _, bsaved = ops.batch_norm_fwd(bx, bscale, bbias, brm, brv, True)
    lib_saved = torch.ops.aten.native_batch_norm(bx, bscale, bbias, lrm, lrv, True, 0.01, 1e-5)[1:]

    def bn_fwd_lib(x_):
        return F.batch_norm(x_, lrm, lrv, bscale, bbias, True, 0.01, 1e-5)

    def bn_bwd_lib(dy_, x_):
        return torch.ops.aten.native_batch_norm_backward(dy_, x_, bscale, lrm, lrv, *lib_saved, True, 1e-5,
                                                         [True, True, True])

    def bn_extra(fn, b_, c_, train):
        x_, dy_, sc_, bi_, m_, v_ = bn_inputs(dev, b_, c_, torch.bfloat16, SEED + b_ + c_)
        _, sv_ = ops.batch_norm_fwd(x_, sc_, bi_, m_.clone(), v_.clone(), train)
        if fn == "fwd":
            return min(graph_ms(lambda: ops.batch_norm_fwd(x_, sc_, bi_, m_, v_, train)) for _ in range(2))
        return min(graph_ms(lambda: ops.batch_norm_bwd(dy_, x_, sc_, sv_, train)) for _ in range(2))

    bms, by = bound(2 * n_el * 2 + 4 * cols * 9, 8 * n_el, "float32")
    rows.append(with_cold(
        timed(
            dict(name="batch_norm_fwd", route="cuda", cuda_route="cuda", source=BN_SOURCE, replaces=BN_REPLACES,
                 shape=[BATCH, cols], dtype="bfloat16", launches=launches["dnn_training"]["batch_norm_fwd"],
                 launches_by_path={p: v["batch_norm_fwd"] for p, v in bn_launches.items()},
                 max_abs_err=errs["batch_norm_fwd"], bound_ms=bms, bound_by=by,
                 registers=build.get("batch_norm_fwd_kernel<bf16,8>", {}).get("registers"),
                 c32_ms=bn_extra("fwd", BATCH, 32, True), eval_256_ms=bn_extra("fwd", DNN_SERVE_BATCH, 128, False),
                 library_note="F.batch_norm(training=True), f32 parameters over bf16 x: its running variance is "
                              "the unbiased one, a time comparison only"),
            kernel=lambda: ops.batch_norm_fwd(bx, bscale, bbias, brm, brv, True),
            plain=lambda: batch_norm_fwd_reference(bx, bscale, bbias, brm, brv, True),
            library=lambda: bn_fwd_lib(bx),
        ),
        kernel=lambda x_: ops.batch_norm_fwd(x_, bscale, bbias, brm, brv, True), make_copy=lambda: (bx.clone(),),
        copy_bytes=n_el * 2, library=bn_fwd_lib, make_lib_copy=lambda: (bx.clone(),), lib_bytes=n_el * 2,
    ))
    bms, by = bound(3 * n_el * 2 + 4 * cols * 6, 12 * n_el, "float32")
    rows.append(with_cold(
        timed(
            dict(name="batch_norm_bwd", route="cuda", cuda_route="cuda", source=BN_SOURCE, replaces=BN_REPLACES,
                 shape=[BATCH, cols], dtype="bfloat16", launches=launches["dnn_training"]["batch_norm_bwd"],
                 launches_by_path={p: v["batch_norm_bwd"] for p, v in bn_launches.items()},
                 max_abs_err=errs["batch_norm_bwd"], bound_ms=bms, bound_by=by,
                 registers=build.get("batch_norm_bwd_kernel<bf16,8>", {}).get("registers"),
                 c32_ms=bn_extra("bwd", BATCH, 32, True),
                 library_note="torch.ops.aten.native_batch_norm_backward (dx, dscale, dbias) from "
                              "native_batch_norm's saved mean and invstd"),
            kernel=lambda: ops.batch_norm_bwd(bdy, bx, bscale, bsaved, True),
            plain=lambda: batch_norm_bwd_reference(bdy, bx, bscale, bsaved, True),
            library=lambda: bn_bwd_lib(bdy, bx),
        ),
        kernel=lambda dy_, x_: ops.batch_norm_bwd(dy_, x_, bscale, bsaved, True),
        make_copy=lambda: (bdy.clone(), bx.clone()), copy_bytes=2 * n_el * 2,
        library=bn_bwd_lib, make_lib_copy=lambda: (bdy.clone(), bx.clone()), lib_bytes=2 * n_el * 2,
    ))
    for r in rows[-2:]:
        print(f"  {r['name']} ({BATCH}, {cols}) bf16: warm {r['ms']:.5f} ms, cold {r['cold_ms']:.5f} ms, bound "
              f"{r['bound_ms']:.5f} ({r['cold_share']:.1%} cold); plain {r['plain_ms']:.5f}; library "
              f"{r['library_ms']:.5f} warm, {r['library_cold_ms']:.5f} cold; C=32 {r['c32_ms']:.5f}; registers "
              f"{r['registers']}; launches {r['launches_by_path']}", flush=True)
    uk = next(r for r in rows if r["name"] == "update_keys")
    uk["over_launch_floor"] = uk["ms"] / min(floor)
    print(f"  update_keys warm {uk['ms']:.5f} ms = {uk['over_launch_floor']:.3f}x the launch floor "
          f"{min(floor):.5f} ms", flush=True)
    print(f"  fused_gather with keys warm {k4['ms_runs']} cold {k4['cold_ms_runs']} ms (bound {k4['bound_ms']:.5f}, "
          f"{k4['cold_share']:.1%} cold), without keys warm {k4['no_keys_ms_runs']} cold {k4['no_keys_cold_ms_runs']} "
          f"ms (bound {k4['no_keys_bound_ms']:.5f}); registers {k4['registers']}; the routing inside K4 costs "
          f"{k4['routing_cost_ms']:.5f} ms warm, {k4['routing_cost_cold_ms']:.5f} cold, against "
          f"{uk['ms']:.5f} ms as the standalone launch (launch floor {floor})", flush=True)
    for r in rows:
        print(json.dumps({"kernel_timing": r, "card": card}), flush=True)
    return rows, floor


# --ab's K4 cases: (label, dtype, dim, slot shapes, vocab, stacked); the
# bench's batch (26 stacked slots of 4,096 from the 26M x 16 f32 table, its
# rows at the fused step's size) and edges of the vector width and slots
K4_AB_CASES = [
    ("bench", "float32", EMB_DIM, [(BATCH,)] * N_SLOTS, VOCAB, True),
    ("bf16_pooled", "bfloat16", EMB_DIM, [(512,), (512, 5)], 1000, True),
    ("unstacked_nan", "float32", EMB_DIM, [(777,)], 1000, False),
    ("dim_10", "float32", 10, [(300,), (50, 2)], 200, True),
    ("dim_3_f32", "float32", 3, [(300,)], 200, True),
    ("dim_3_bf16", "bfloat16", 3, [(300,)], 200, True),
    ("129_slots", "float32", EMB_DIM, [(64,)] * 129, 50, True),
]


def k4_ab(dev, ops, times, as_bits) -> dict:
    """``--ab``'s K4: each ``K4_AB_CASES`` case's rows (and, where this
    tree's ``fused_gather`` takes ``keys``, its rows and keys with them)
    and the plain routing's keys, as bits; into ``times``, at the bench
    case, K4 warm and cold without keys and with them (in turns), the
    standalone ``update_keys`` and the one-launch floor."""
    import inspect

    import torch

    from persia_tpu_torch.ops.sparse_update import update_keys_reference

    has_keys = "keys" in inspect.signature(ops.fused_gather).parameters
    rng = np.random.default_rng(SEED + 13)
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    bits = {}
    for label, dtype, dim, shapes, vocab, stacked in K4_AB_CASES:
        table = torch.randn((vocab * len(shapes), dim), device=dev, generator=g).to(getattr(torch, dtype))
        ids = []
        for shape in shapes:
            a = rng.integers(-1, vocab + 3, shape).astype(np.int32)
            a.reshape(-1)[:4] = [vocab + 7, -1, vocab - 1, 1 << 30]
            ids.append(torch.from_numpy(a).to(dev))
        offs, vocabs = ([i * vocab for i in range(len(shapes))] if stacked else [0]), [vocab] * len(shapes)
        bits[f"k4_rows_{label}"] = as_bits(ops.fused_gather(table, ids, offs, vocabs, stacked))
        bits[f"k4_keys_ref_{label}"] = as_bits(update_keys_reference(ids, offs, vocabs))
        if has_keys:
            rows, keys = ops.fused_gather(table, ids, offs, vocabs, stacked, keys=True)
            bits[f"k4_rows_keys_{label}"], bits[f"k4_keys_{label}"] = as_bits(rows), as_bits(keys)
        if label != "bench":
            continue
        n_pos = sum(i.numel() for i in ids)
        fresh_rng = np.random.default_rng(SEED + 14)  # the cold calls' batches, apart from the cases' ids

        def fresh():
            return ([torch.from_numpy(fresh_rng.integers(0, vocab, BATCH, dtype=np.int32)).to(dev)
                     for _ in shapes],)

        def k4_times(kw):
            return {"warm_ms": graph_ms(lambda: ops.fused_gather(table, ids, offs, vocabs, True, **kw)),
                    "cold_ms": cold_ms(lambda i: ops.fused_gather(table, i, offs, vocabs, True, **kw), fresh,
                                       n_pos * 4 + n_pos * dim * 4)["ms"]}

        sides = [{}, {"keys": True}, {"keys": True}, {}] if has_keys else [{}, {}]
        runs = [(bool(kw), k4_times(kw)) for kw in sides]
        for name, with_keys in (("fused_gather", False), ("fused_gather_keys", True)):
            mine = [t for k, t in runs if k == with_keys]
            if mine:
                times[name] = {"warm_ms": [t["warm_ms"] for t in mine], "cold_ms": [t["cold_ms"] for t in mine]}
        times["update_keys"] = {"warm_ms": [graph_ms(lambda: ops.update_keys(ids, offs, vocabs)) for _ in range(2)]}
        one = torch.zeros(1, device=dev)
        times["launch_floor"] = {"warm_ms": [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]}
        del table
    return bits


def k12_ab_case(dev):
    """``--ab``'s K12 inputs, made here (not by the tree's own helpers): a
    saturated step's pieces on the 2^18-row dim-16 Adagrad pool, as the
    tier builds them: 7,820 misses, each evicting (the directory hands the
    k-th evicted row to the k-th miss), ~500 of them warm and the rest cold
    (bf16 wires, rows padded to buckets of 4,096 with C+1, evictions with
    C), and their pairing."""
    import torch

    rng = np.random.default_rng(SEED + 70)
    C, dim, k = CACHE_SAT_ROWS, EMB_DIM, 7820
    g = torch.Generator().manual_seed(SEED + 70)
    table = torch.randn((C + 1, dim), generator=g)
    table[C] = 0
    acc = torch.rand((C + 1, dim), generator=g)
    ev = rng.permutation(C)[:k].astype(np.int32)
    warm = np.sort(rng.permutation(k)[:500])
    cold_ = np.setdiff1d(np.arange(k), warm)

    def padded(a, n, fill):
        out = np.full(n, fill, np.int32)
        out[:len(a)] = a
        return torch.from_numpy(out).to(dev)

    case = dict(table=table.to(dev), state={"acc": acc.to(dev)}, ev_rows=padded(ev, 8192, C),
                m_rows=padded(ev[warm], 512, C + 1), m_entries=torch.randn((512, 2 * dim), generator=g).to(
                    dev, torch.bfloat16),
                c_rows=padded(ev[cold_], 8192, C + 1), c_emb=torch.randn((8192, dim), generator=g).to(
                    dev, torch.bfloat16), state_consts=(("acc", 0.01),))
    pairing = dict(m_slot=padded(warm, 512, -1), c_slot=padded(cold_, 8192, -1),
                   ev_free=padded(np.arange(k, 8192), 512, -1))
    flush_rows = torch.from_numpy(rng.permutation(C).astype(np.int32)).to(dev)
    # K13's: a step's (26, 4096, 1) rows, one position in 16 the pad row C
    srows = rng.integers(0, C, (N_SLOTS, BATCH, 1)).astype(np.int32)
    srows[rng.random(srows.shape) < 1 / 16] = C
    return case, pairing, flush_rows, torch.from_numpy(srows).to(dev)


def k12_ab(dev, ops, times, as_bits) -> dict:
    """``--ab``'s K12, its read and K13 on the f32 pool: the tree's
    ``cache_aux`` on ``k12_ab_case`` (with the pairing where the tree's K12
    takes it), its payload, table and state as bits, ``gather_entry_rows``
    of every row, and ``cached_gather`` (pooled, with keys) of the case's
    step rows; into ``times`` each warm and cold and the one-launch
    floor."""
    import inspect

    import torch

    case, pairing, frows, srows = k12_ab_case(dev)
    kw = pairing if "m_slot" in inspect.signature(ops.cache_aux).parameters else {}
    args = [case[k] for k in ("ev_rows", "m_rows", "m_entries", "c_rows", "c_emb", "state_consts")]

    def fresh():
        return case["table"].clone(), {"acc": case["state"]["acc"].clone()}

    t, st = fresh()
    pay = ops.cache_aux(t, st, *args, True, **kw)
    bits = {"k12_payload": as_bits(pay), "k12_table": as_bits(t), "k12_acc": as_bits(st["acc"]),
            "k12_flush_read": as_bits(ops.gather_entry_rows(case["table"], case["state"], frows))}
    pool_bytes = 2 * case["table"].numel() * 4
    runs = []
    for _ in range(2):
        t, st = fresh()
        runs.append({"warm_ms": graph_ms(lambda: ops.cache_aux(t, st, *args, True, **kw)),
                     "cold_ms": cold_ms(lambda t_, s_: ops.cache_aux(t_, s_, *args, True, **kw), fresh,
                                        pool_bytes)["ms"]})
    times["cache_aux"] = {k: [r[k] for r in runs] for k in ("warm_ms", "cold_ms")}
    times["gather_entry_rows"] = {
        "warm_ms": [graph_ms(lambda: ops.gather_entry_rows(case["table"], case["state"], frows)) for _ in range(2)],
        "cold_ms": [cold_ms(lambda t_, s_: ops.gather_entry_rows(t_, s_, frows), fresh, pool_bytes)["ms"]
                    for _ in range(2)]}
    pooled, keys = ops.cached_gather(case["table"], srows, True, keys=True)
    bits.update(k13_pooled=as_bits(pooled), k13_keys=as_bits(keys))
    times["cached_gather"] = {
        "warm_ms": [graph_ms(lambda: ops.cached_gather(case["table"], srows, True, keys=True)) for _ in range(2)],
        "cold_ms": [cold_ms(lambda t_, r_: ops.cached_gather(t_, r_, True, keys=True),
                            lambda: (case["table"].clone(), srows.clone()), pool_bytes // 2)["ms"] for _ in range(2)]}
    bits.update(k12_restores_ab(dev, ops, times, as_bits, case, pairing))
    one = torch.zeros(1, device=dev)
    times.setdefault("launch_floor", {"warm_ms": [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]})
    return bits


def k12_restores_ab(dev, ops, times, as_bits, case, pairing) -> dict:
    """``--ab``'s restoring step: ``k12_ab_case`` with 64 of its cold misses
    restored instead, 48 live (their payload slots claimed by the restores)
    from a 2^19-row bf16 ring outside the step's span (4,096 to 12,288). A tree
    whose K12 takes the restores runs it once; a tree with a restore kernel
    of its own runs K12 (the restored misses' slots unclaimed) and then that
    kernel. The payload, table, state and ring as bits (equal across trees
    when the fold changes nothing), the warm time of either form in
    ``times["cache_aux_restores"]``."""
    import inspect

    import torch

    C, E = CACHE_SAT_ROWS, 2 * EMB_DIM
    g = torch.Generator().manual_seed(SEED + 71)
    ring0 = torch.randn((1 << 19, E), generator=g).to(dev, torch.bfloat16)
    c_rows, c_slot = case["c_rows"].clone(), pairing["c_slot"].clone()
    live = torch.arange(48, device=dev) * 97 % int((c_slot >= 0).sum())  # 48 cold misses become restores
    r_dst = torch.full((64,), C + 1, dtype=torch.int32, device=dev)
    r_slot = torch.full((64,), -1, dtype=torch.int32, device=dev)
    r_src = torch.zeros(64, dtype=torch.int32, device=dev)
    r_dst[:48], r_slot[:48] = c_rows[live], c_slot[live]
    r_src[:48] = (16384 + torch.randperm(1 << 18, generator=g)[:48]).int().to(dev)  # past the span [4096, 12288)
    c_rows[live], c_slot[live] = C + 1, -1
    args = [case["ev_rows"], case["m_rows"], case["m_entries"], c_rows, case["c_emb"], case["state_consts"], True]
    folded = "restores" in inspect.signature(ops.cache_aux).parameters
    free_wo = torch.cat([pairing["ev_free"][pairing["ev_free"] >= 0], r_slot[:48].sort().values])
    free_wo = torch.cat([free_wo, torch.full((512 - free_wo.numel() % 512,), -1, dtype=torch.int32, device=dev)])

    def fresh():
        return case["table"].clone(), {"acc": case["state"]["acc"].clone()}, ring0.clone()

    def step(t, st, ring):
        if folded:
            return ops.cache_aux(t, st, *args, m_slot=pairing["m_slot"], c_slot=c_slot, ev_free=pairing["ev_free"],
                                 ring=ring, ring_pos=4096, restores=(r_src, r_dst, r_slot))
        pay = ops.cache_aux(t, st, *args, m_slot=pairing["m_slot"], c_slot=c_slot, ev_free=free_wo, ring=ring,
                            ring_pos=4096)
        ops.restore_rows(t, st, ring, r_src, r_dst)
        return pay

    t, st, ring = fresh()
    pay = step(t, st, ring)
    bits = {"k12r_payload": as_bits(pay), "k12r_table": as_bits(t), "k12r_acc": as_bits(st["acc"]),
            "k12r_ring": as_bits(ring)}
    t, st, ring = fresh()
    times["cache_aux_restores"] = {"form": "one launch" if folded else "K12, then the restore kernel",
                                   "warm_ms": [graph_ms(lambda: step(t, st, ring)) for _ in range(2)]}
    return bits


def k15_ab(dev, ops, times, as_bits) -> dict:
    """``--ab``'s K15: the tree's ``quantize_int8_ef`` three steps with the
    residual carried in place, at the ps-stream shape and at every
    ``K15_CASES`` case, bf16 and f32 (phase 3f's seeded inputs): each
    step's codes and scales and the last residual as bits; into ``times``
    its warm and cold time at the ps-stream shape (bf16) and the
    one-launch floor."""
    import torch

    bits = {}
    for i, lengths in enumerate(([1536 * EMB_DIM] * N_SLOTS,) + K15_CASES):
        for dtype in (torch.bfloat16, torch.float32):
            g, res, offsets = k15_inputs(dev, lengths, dtype, SEED + 80 + len(lengths))
            case = f"k15_{i}_{len(lengths)}x{max(lengths)}_{str(dtype)[6:]}"
            for step in range(3):
                q, s, res = ops.quantize_int8_ef(g, res, offsets)
                bits.update({f"{case}_codes{step}": as_bits(q), f"{case}_scales{step}": as_bits(s)})
                g = (g.float() * -0.5 + 1e-4).to(dtype)
            bits[f"{case}_residual"] = as_bits(res)
    g, res, offsets = k15_inputs(dev, [1536 * EMB_DIM] * N_SLOTS, torch.bfloat16, SEED + 80 + N_SLOTS)
    times["quantize_int8_ef"] = {
        "warm_ms": [graph_ms(lambda: ops.quantize_int8_ef(g, res, offsets)) for _ in range(2)],
        "cold_ms": [cold_ms(lambda gg, rr: ops.quantize_int8_ef(gg, rr, offsets), lambda: (g.clone(), res.clone()),
                            g.numel() * (g.element_size() + 4))["ms"] for _ in range(2)]}
    one = torch.zeros(1, device=dev)
    times.setdefault("launch_floor", {"warm_ms": [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]})
    return bits


def k16_ab(dev, times, as_bits) -> dict:
    """``--ab``'s K16 and K17 (and the fused hop where the tree has it) at
    phase 5's dense sync shapes (``sync_inputs``): K16 on the whole vector
    and at n = 4's chunk, each with the feedback; K17 as a hop's
    accumulate with the feedback and as the all-gather's 4 rows; the hop
    unfolded (K17 then K16) and, where the tree has it, folded
    (``block_requantize_int8``, which must give the unfolded hop's bits).
    The outputs' bits (the unfolded hop's under ``k16ab_hop_*``); into
    ``times`` each one's warm and cold time and the one-launch floor."""
    import torch

    from persia_tpu_torch.ops import block_int8 as b8

    x = sync_inputs(dev)
    bs, n1, n4 = SYNC_BLOCK, x["ppad1"], x["chunk4"]
    q4, s4, _ = b8.block_quantize_int8(x["g4"], bs)
    rows_q, rows_s, _ = b8.block_quantize_int8(x["rows4"], bs)
    hop = lambda: (q4.clone(), s4.clone(), x["base4"].clone(), x["ef4"].clone())  # noqa: E731
    cases = {
        "k16_whole": (lambda v, e: b8.block_quantize_int8(v, bs, ef=e), lambda: (x["g1"].clone(), x["ef1"].clone()),
                      n1 * 8),
        "k16_chunk": (lambda v, e: b8.block_quantize_int8(v, bs, ef=e), lambda: (x["g4"].clone(), x["ef4"].clone()),
                      n4 * 8),
        "k17_hop": (lambda q, sc, b, e: (b8.block_dequantize_int8(q, sc, bs, base=b, ef=e, out=b),), hop, n4 * 9),
        "k17_rows": (lambda q, sc: (b8.block_dequantize_int8(q, sc, bs, n=4, roll=1),),
                     lambda: (rows_q.clone(), rows_s.clone()), 4 * n4),
        "hop": (lambda q, sc, b, e: b8.block_quantize_int8(
            b8.block_dequantize_int8(q, sc, bs, base=b, ef=e, out=b), bs), hop, n4 * 9),
    }
    if hasattr(b8, "block_requantize_int8"):
        cases["hop_fused"] = (lambda q, sc, b, e: b8.block_requantize_int8(q, sc, b, e, bs), hop, n4 * 9)
    bits = {}
    for name, (fn, make, nbytes) in cases.items():
        for i, t in enumerate(fn(*make())):
            bits[f"k16ab_{name}_{i}"] = as_bits(t)
        fixed = make()
        times[name] = {"warm_ms": [graph_ms(lambda: fn(*fixed)) for _ in range(2)],
                       "cold_ms": [cold_ms(fn, make, nbytes)["ms"] for _ in range(2)]}
    if "hop_fused" in cases:
        fused = {k: bits.pop(k) for k in [k for k in bits if k.startswith("k16ab_hop_fused_")]}
        if not all(np.array_equal(v, bits[k.replace("hop_fused", "hop")]) for k, v in fused.items()):
            raise SystemExit("the fused hop's bits differ from K17 then K16's")
    one = torch.zeros(1, device=dev)
    times.setdefault("launch_floor", {"warm_ms": [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]})
    return bits


def k15s_ab(dev, times, as_bits) -> dict:
    """``--ab``'s K15 dense-sync modes at phase 5's shapes (``sync_inputs``:
    the tower's leaves, f32): ``segment_absmax``; and the shared-scale
    quantize at those scales with the codes as int32, which a tree whose
    quantize returns int32 codes writes in the pass and an older tree makes
    by its int8 quantize and a cast, as its bytegrad did. The outputs'
    bits; into ``times`` each one's warm and cold time and the one-launch
    floor."""
    import torch

    from persia_tpu_torch.ops import quantize_int8 as qi

    x = sync_inputs(dev)
    offs = x["offsets"]
    scale = qi.segment_absmax(x["flat"], x["res"], offs)
    def int32_codes(g, r):
        q, sc, new = qi.quantize_int8_ef_shared(g, r, offs, scale)
        return (q if q.dtype == torch.int32 else q.to(torch.int32)), sc, new

    make = lambda: (x["flat"].clone(), x["res"].clone())  # noqa: E731
    in_pass = qi.quantize_int8_ef_shared(*make(), offs, scale)[0].dtype == torch.int32
    form = "int32 codes in the pass" if in_pass else "int8 codes, then the cast"
    cases = {"segment_absmax": (lambda g, r: (qi.segment_absmax(g, r, offs),), x["p"] * 8),
             "shared_int32": (int32_codes, x["p"] * 8)}
    bits = {"k15s_scale_in": as_bits(scale)}
    for name, (fn, nbytes) in cases.items():
        for i, t in enumerate(fn(*make())):
            bits[f"k15s_{name}_{i}"] = as_bits(t)
        fixed = make()
        times[name] = {"warm_ms": [graph_ms(lambda: fn(*fixed)) for _ in range(2)],
                       "cold_ms": [cold_ms(fn, make, nbytes)["ms"] for _ in range(2)]}
    times["shared_int32"]["form"] = form
    one = torch.zeros(1, device=dev)
    times.setdefault("launch_floor", {"warm_ms": [graph_ms(lambda: one.add_(1.0)) for _ in range(2)]})
    return bits


def ab_run(root: str, out_path: str, only: str = "") -> int:
    """``--ab ROOT OUT.npz``: K2, K4, K7, K8 and K9 of the package in the
    checkout ROOT (another commit's tree, unpacked), on this script's
    seeded inputs: phase 3c's for K7 (both dtypes, the Taobao histories
    and every position on one row), K8 and K9 (both dtypes, the DIN shape
    and ``ATT_EDGE_CASES``), phase 3's
    zipf(1.2) bench case for K2, ``K4_AB_CASES`` for K4 (without keys and,
    where the tree's K4 writes them, with; the plain routing beside them).
    Their outputs' bits go to OUT.npz; their
    graph-replayed times, warm and cold (K7 beside ``index_add_`` over the
    live positions, at f32; K8 and K9 at bf16; K4 at the fused step's batch
    with and without keys, the standalone ``update_keys`` and the
    one-launch floor; K12 and its read at ``k12_ab_case``; K15 at the
    ps-stream shape, ``k15_ab``), are printed as one JSON line. ``only`` =
    "k12", "k15", "k15s" or "k16": that kernel alone (K12 with its read and
    K13; K15's dense-sync modes, ``k15s_ab``; K16 with K17 and the fused
    hop, ``k16_ab``). Run it over two trees in turns (A, B, B, A) in one
    call, then ``--ab-compare``."""
    sys.path.insert(0, str(pathlib.Path(root).resolve()))
    import torch

    import persia_tpu_torch
    from persia_tpu_torch import ops

    from persia_tpu_torch.ops import _kernels

    dev = torch.device("cuda", 0)
    pkg = str(pathlib.Path(persia_tpu_torch.__file__).resolve().parent)
    _kernels.library()
    if _kernels.build_log:  # registers, shared memory and spills of this tree's K2, K4, K7-K9
        summary = build_summary(_kernels.build_log, _kernels.library_path())
        print(json.dumps({"ab_build": {k: v for k, v in summary.items()
                                       if k.split("<")[0] in DIN_KERNEL_NAMES + K2_KERNEL_NAMES
                                       or k.startswith(("segment_sum", "fused_gather_kernel", "quantize_int8_ef"))},
                          "package": pkg}), flush=True)
    as_bits = lambda t: t.contiguous().view(torch.uint8).cpu().numpy()  # noqa: E731
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)  # noqa: E731
    bits, times = {"root": np.array(str(pathlib.Path(root).resolve()))}, {}
    if only == "k16":
        bits.update(k16_ab(dev, times, as_bits))
    elif only == "k15s":
        bits.update(k15s_ab(dev, times, as_bits))
    else:
        if only != "k12":
            bits.update(k15_ab(dev, ops, times, as_bits))
        if only != "k15":
            bits.update(k12_ab(dev, ops, times, as_bits))
    if only in ("k12", "k15", "k15s", "k16"):
        np.savez(out_path, **bits)
        print(json.dumps({"ab": {"root": root, "package": pkg, "times": times}, "card": card_line()}), flush=True)
        return 0
    for dtype in (torch.bfloat16, torch.float32):
        name = str(dtype)[6:]
        logits, mask, hist, d_out = att_inputs(dev, dtype, SEED + 3)
        out, w = ops.attention_pool_fwd(logits, mask, hist)
        d_logits, d_hist = ops.attention_pool_bwd(d_out, mask, hist, w)
        bits.update({f"att_fwd_out_{name}": as_bits(out), f"att_fwd_w_{name}": as_bits(w),
                     f"att_bwd_dlogits_{name}": as_bits(d_logits), f"att_bwd_dhist_{name}": as_bits(d_hist)})
        for b, l, dim in ATT_EDGE_CASES:  # phase 3c's edge cases
            e_logits, e_mask, e_hist, e_dout = att_inputs(dev, dtype, SEED + 3 + l, b, l, dim, prefix=False)
            e_out, e_w = ops.attention_pool_fwd(e_logits, e_mask, e_hist)
            e_dl, e_dh = ops.attention_pool_bwd(e_dout, e_mask, e_hist, e_w)
            case = f"{name}_{b}x{l}x{dim}"
            bits.update({f"att_fwd_out_{case}": as_bits(e_out), f"att_fwd_w_{case}": as_bits(e_w),
                         f"att_bwd_dlogits_{case}": as_bits(e_dl), f"att_bwd_dhist_{case}": as_bits(e_dh)})
        if dtype == torch.bfloat16:
            copy = nbytes([logits, mask, hist])
            times["attention_pool_fwd"] = {
                "warm_ms": [graph_ms(lambda: ops.attention_pool_fwd(logits, mask, hist)) for _ in range(2)],
                "cold_ms": [cold_ms(lambda lg, m, h: ops.attention_pool_fwd(lg, m, h),
                                    lambda: (logits.clone(), mask.clone(), hist.clone()), copy)["ms"]
                            for _ in range(2)]}
            times["attention_pool_bwd"] = {
                "warm_ms": [graph_ms(lambda: ops.attention_pool_bwd(d_out, mask, hist, w)) for _ in range(2)],
                "cold_ms": [cold_ms(lambda d, m, h, w_: ops.attention_pool_bwd(d, m, h, w_),
                                    lambda: (d_out.clone(), mask.clone(), hist.clone(), w.clone()),
                                    nbytes([d_out, mask, hist, w]))["ms"] for _ in range(2)]}
    g = torch.Generator(device="cpu").manual_seed(SEED + 9)
    for dtype in (torch.bfloat16, torch.float32):
        for case in ("taobao", "one_row"):
            rows, slots = raw_inputs(dev, dtype, SEED + len(case), case)
            grad = torch.randn((len(rows), DIN_BATCH, DIN_HIST, DIN_DIM), generator=g).to(dev, dtype)
            for i, r in enumerate(ops.raw_gather_bwd(grad, rows, slots)):
                bits[f"k7_{case}_{str(dtype)[6:]}_{i}"] = as_bits(r)
            if dtype == torch.float32:
                key = "raw_gather_bwd" if case == "taobao" else "raw_gather_bwd_one_row"
                times[key] = {"warm_ms": [graph_ms(lambda: ops.raw_gather_bwd(grad, rows, slots))
                                          for _ in range(2)]}
            if dtype == torch.float32 and case == "taobao":
                clone = lambda: (grad.clone(), [r.clone() for r in rows],  # noqa: E731
                                 [ops.RawSlot(*(t.clone() for t in s)) for s in slots])
                times[key]["cold_ms"] = [cold_ms(lambda gr, r, sl: ops.raw_gather_bwd(gr, r, sl), clone,
                                                 nbytes([grad, *rows, *(t for s in slots for t in s)]))["ms"]
                                         for _ in range(2)]
                # index_add_ of the live positions' gradients into the slots' rows side by side
                starts = np.cumsum([0] + [r.shape[0] for r in rows[:-1]])
                flat = torch.cat([s.index.reshape(-1).long() + int(o) for s, o in zip(slots, starts)])
                live = torch.cat([s.index.reshape(-1) != r.shape[0] - 1 for s, r in zip(slots, rows)])
                idx, src = flat[live], grad.reshape(-1, DIN_DIM)[live]
                acc = torch.zeros((sum(r.shape[0] for r in rows), DIN_DIM), device=dev, dtype=dtype)
                times["index_add_"] = {
                    "warm_ms": [graph_ms(lambda: acc.index_add_(0, idx, src)) for _ in range(2)],
                    "cold_ms": [cold_ms(lambda i, x: acc.index_add_(0, i, x), lambda: (idx.clone(), src.clone()),
                                        nbytes([idx, src]))["ms"] for _ in range(2)]}
    rows, slots = pool_inputs(dev, torch.bfloat16, BATCH, [(1500, 1, False)] * N_SLOTS, seed=N_SLOTS, ids="zipf")
    pooled = ops.gather_pool_fwd(rows, slots)
    gpool = torch.randn(pooled.shape, generator=g).to(dev)
    for i, r in enumerate(ops.gather_pool_bwd(gpool, rows, slots)):
        bits[f"k2_zipf_{i}"] = as_bits(r)
    times["gather_pool_bwd"] = {
        "warm_ms": [graph_ms(lambda: ops.gather_pool_bwd(gpool, rows, slots)) for _ in range(2)],
        "cold_ms": [cold_ms(lambda gr: ops.gather_pool_bwd(gr, rows, slots), lambda: (gpool.clone(),),
                            nbytes([gpool]))["ms"] for _ in range(2)]}
    del rows, slots, pooled, gpool
    bits.update(k4_ab(dev, ops, times, as_bits))
    torch.cuda.synchronize()
    np.savez(out_path, **bits)
    print(json.dumps({"ab": {"root": root, "package": pkg, "times": times}, "card": card_line()}), flush=True)
    return 0


def stream_ab(pairs: int) -> int:
    """``--stream-ab PAIRS``: the saturated regime's batches (phase 4k's:
    the same seed, its 59 steps, the first 56 timed) through the in-order
    stream (``STREAM_KNOBS``) and the stage-pipelined one
    (``PIPELINED_KNOBS``), each leg from a fresh store and ctx, after one
    untimed leg of each (the process's first legs run slower), then PAIRS
    pairs in turns (in order first in even pairs, pipelined first in odd
    ones). Prints one line a leg (samples/s, lanes, feed leads, stalls)
    and then one JSON line: every leg's samples/s, the medians and
    quartiles, and the pipelined / in-order ratio of each pair."""
    import torch

    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    dev = torch.device("cuda", 0)
    card = card_line()
    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    sd = state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    make = zipf_batch_maker(SEED + 60, labels=True)
    batches = [make() for _ in range(59)]
    timed = 56

    def leg(knobs) -> dict:
        ctx = cache_ctx(dev, CACHE_SAT_ROWS, cache_store(), sd)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ctx.train_stream(batches[:timed], **knobs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = ctx.stream_stats()  # the timed steps'
        ctx.train_stream(batches[timed:], **knobs)
        out = {"samples_per_s": timed * BATCH / wall, "lane_s": st["lane_s"], "feed_leads": st["feed_leads"],
               "pipeline_stalls": st["pipeline_stalls"], "restore_steps": st["restore_steps"]}
        if not np.isfinite(ctx.last_metrics()["loss"]):
            raise SystemExit("stream A/B: a non-finite loss")
        del ctx
        torch.cuda.empty_cache()
        return out

    for knobs in (STREAM_KNOBS, PIPELINED_KNOBS):  # the warm-up legs
        leg(knobs)
    runs = {"in_order": [], "pipelined": []}
    for i in range(pairs):
        order = ("in_order", "pipelined") if i % 2 == 0 else ("pipelined", "in_order")
        for name in order:
            r = leg(STREAM_KNOBS if name == "in_order" else PIPELINED_KNOBS)
            runs[name].append(r)
            print(f"  pair {i} {name}: {r['samples_per_s']:.0f} samples/s, lanes "
                  f"{ {k: round(v, 3) for k, v in r['lane_s'].items()} }, feed leads {r['feed_leads']}, stalls "
                  f"{r['pipeline_stalls']}, restoring steps {r['restore_steps']}", flush=True)
    sps = {k: [r["samples_per_s"] for r in v] for k, v in runs.items()}
    summary = {k: {"median": float(np.median(v)), "quartiles": [float(np.percentile(v, 25)),
                                                               float(np.percentile(v, 75))]} for k, v in sps.items()}
    ratios = [p / q for p, q in zip(sps["pipelined"], sps["in_order"])]
    print(json.dumps({"stream_ab": {"samples_per_s": sps, "summary": summary, "pipelined_over_in_order": ratios,
                                    "pipelined_wins": sum(r > 1 for r in ratios), "pairs": pairs},
                      "card": card}), flush=True)
    return 0


def ab_compare(paths) -> int:
    """``--ab-compare A.npz B.npz ...``: K2's, K4's, K8's, K9's, K12's
    (and its read's) and K15's bits equal in every file that holds them (K4's keys and its rows with keys
    only where the tree's K4 writes keys), K7's in the files of one tree;
    in each file K4's keys equal to the plain routing and its rows with
    keys to its rows without; prints which differ."""
    runs = [dict(np.load(p)) for p in paths]
    report, ok = {}, True
    for key in sorted(set().union(*runs)):
        if key == "root":
            continue
        same_tree = key.startswith("k7_")
        groups = {}
        for run in runs:
            if key in run:
                groups.setdefault(str(run["root"]) if same_tree else "all", []).append(run[key])
        equal = all(np.array_equal(a, group[0]) for group in groups.values() for a in group)
        report[key] = "bitwise" if equal else "DIFFER"
        ok &= equal
    for run in runs:  # within a file: K4's keys against the plain routing, its rows with keys against without
        for key in sorted(k for k in run if k.startswith("k4_keys_") and not k.startswith("k4_keys_ref_")):
            case = key[len("k4_keys_"):]
            equal = (np.array_equal(run[key], run[f"k4_keys_ref_{case}"])
                     and np.array_equal(run[f"k4_rows_keys_{case}"], run[f"k4_rows_{case}"]))
            report[f"{key} vs plain routing, rows with keys vs without ({run['root']})"] = (
                "bitwise" if equal else "DIFFER")
            ok &= equal
    k7_trees = {str(r["root"]) for r in runs}
    if len(k7_trees) == 2:  # K7's bits between the trees: reported, not required
        a, b = ({k: v for k, v in r.items() if k.startswith("k7_")} for r in
                (next(r for r in runs if str(r["root"]) == t) for t in sorted(k7_trees)))
        report["k7_between_trees"] = {k: bool(np.array_equal(a[k], b[k])) for k in sorted(a)}
    print(json.dumps({"ab_compare": report, "files": list(paths), "ok": ok}), flush=True)
    return 0 if ok else 1


# ---------------------------------------------------------------------------
# The Criteo DLRM example (persia_tpu_torch.testing.criteo_dlrm), the 100T
# harness (testing.synthetic_100t) and the quality gate (testing.quality):
# phases 3b's 1TB case, 4l, 4m, 4n, the fan-out's timing and phase 5's 1TB
# rows

TB_ROWS = 183_873_726  # the Criteo-1TB stacked table's rows (sum of CRITEO_1TB_VOCABS)
# phase 4l: train batches a leg (the example's 64 cut to 12), held-out
# batches (8 cut to 4), the first steps held to the CPU port
CRITEO_STEPS, CRITEO_EVAL, CRITEO_CPU_STEPS = 8, 4, 3
# phase 4m: the harness's timed steps (32 cut to 8) after 3 reproducible
# steps held to the CPU port; B=1024
H100T_STEPS, H100T_REPRO, H100T_BATCH = 8, 3, 1024
QUALITY_STEPS = 200  # phase 4n: bench.py's default budget
FANOUT_STEPS = 16  # steps a turn of the fan-out's timing, the same batches each turn


def criteo_tb_ids(rng, batch_seed, vocabs, top=True):
    """One Criteo-1TB batch's ids per slot, as the example's stream draws
    them (``CriteoSynthetic``, B=4096, batch ``batch_seed``), in the stack's
    slot order; with ``top`` the first positions of every slot at its last
    rows (past row 2^27 for the stack's last 12 slots), pads and ids past
    the slot."""
    from persia_tpu_torch.testing import CriteoSynthetic

    b = next(CriteoSynthetic(num_samples=BATCH, vocab_sizes=vocabs, seed=batch_seed).batches(BATCH))
    by_name = {f.name: np.asarray(f.data).reshape(-1).astype(np.int64) for f in b.id_type_features}
    out = []
    for name, v in zip(sorted(by_name), (vocabs[int(n[4:])] for n in sorted(by_name))):
        ids = by_name[name].copy()
        if top:
            ids[:8] = [v - 1, v - 1, v - 2, v - 3, -1, v, v + 7, 0]
            ids[8:8 + 40] = v - 1  # a long segment on the slot's last row
            ids[rng.random(ids.size) < 0.02] = -1
        out.append(ids.astype(np.int32))
    return out


def phase_fused_1tb_kernels(dev):
    """Phase 3b's case past 2^31 elements: the Criteo-1TB stack (183,873,726
    x 16 f32 and its Adagrad state, 23.5 GB) on the card; K4 with its keys
    and K5 on a Criteo-1TB batch with ids at the top rows of every slot,
    bit for bit their plain versions (K4's on the card; K5's on the CPU over
    the touched rows, compacted in order); no other row moves (an exact
    integer checksum of the whole table and state)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.ops.fused_gather import fused_gather_reference
    from persia_tpu_torch.ops.sparse_update import PAD_SENTINEL, sparse_update_reference, update_keys_reference
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec, group_stacked_specs
    from persia_tpu_torch.testing import CRITEO_1TB_VOCABS

    specs = {f"cat_{i}": FusedSlotSpec(vocab=v, dim=EMB_DIM) for i, v in enumerate(CRITEO_1TB_VOCABS)}
    (grp,) = group_stacked_specs(specs, sorted(specs))
    vocabs = [specs[n].vocab for n in grp.slots]
    print(f"== phase 3b (1TB): the Criteo-1TB stack, {grp.vocab:,} x {EMB_DIM} f32 "
          f"({grp.vocab * EMB_DIM:,} elements) and its Adagrad state on the card", flush=True)
    g = torch.Generator(device=dev).manual_seed(SEED + 40)
    rng = np.random.default_rng(SEED + 40)
    t0 = time.perf_counter()
    tbl = torch.empty((grp.vocab, EMB_DIM), device=dev).normal_(generator=g).mul_(0.05)
    acc = torch.empty((grp.vocab, EMB_DIM), device=dev).uniform_(0.01, 1.0, generator=g)
    torch.cuda.synchronize()
    ids = [torch.from_numpy(i).to(dev) for i in criteo_tb_ids(rng, 5, CRITEO_1TB_VOCABS)]
    rows, keys = ops.fused_gather(tbl, ids, list(grp.offsets), vocabs, True, keys=True)
    ref = fused_gather_reference(tbl, ids, list(grp.offsets), vocabs, True)
    ref_keys = update_keys_reference(ids, list(grp.offsets), vocabs)
    live = keys[keys != PAD_SENTINEL].long()
    top = int(live.max())
    ok4 = same_bits(rows, ref) and same_bits(keys, ref_keys) and top == grp.vocab - 1
    print(f"  fused_gather with keys, 26 slots of B={BATCH} (Criteo-1TB ids, each slot's last rows, pads, ids "
          f"past the slot): {rows.shape[0]} rows, top key {top:,} (element offset {top * EMB_DIM:,}), "
          f"{int((live * EMB_DIM >= 2 ** 31).sum())} positions past 2^31 elements; rows and keys bitwise vs the "
          f"plain version on the card {'ok' if ok4 else 'FAIL'}", flush=True)
    if not ok4:
        raise SystemExit("fused_gather at the 1TB table disagrees with its plain version")
    del rows, ref
    # K5 on those keys; its plain version on the CPU over the touched rows
    # (remapped in order: the same sort, the same segments, the same sums)
    cfg = Adagrad(lr=0.05).config
    grads = torch.randn((keys.numel(), EMB_DIM), device=dev, generator=g) * 0.1
    touched = torch.unique(live)
    before = (tbl[touched].cpu(), acc[touched].cpu())

    def checksum():
        return [int(t.view(torch.int32).sum(dtype=torch.int64)) for t in (tbl, acc)]

    sums = checksum()
    bs = torch.ones(2, device=dev)
    ops.sparse_update(cfg, tbl, {"acc": acc}, keys, grads, bs)
    torch.cuda.synchronize()
    compact = torch.where(keys == PAD_SENTINEL, torch.full_like(keys, PAD_SENTINEL),
                          torch.searchsorted(touched, keys.long()).to(torch.int32)).cpu()
    ctbl, cacc = before[0].clone(), before[1].clone()
    sparse_update_reference(cfg, ctbl, {"acc": cacc}, compact, grads.cpu(), bs.cpu())
    after = (tbl[touched].cpu(), acc[touched].cpu())
    moved = [int(a.view(torch.int32).sum(dtype=torch.int64) - b.view(torch.int32).sum(dtype=torch.int64))
             for a, b in zip(after, before)]
    sums2 = checksum()
    ok5 = same_bits(after[0], ctbl) and same_bits(after[1], cacc) and \
        [s2 - s for s, s2 in zip(sums, sums2)] == moved and not same_bits(after[0], before[0])
    print(f"  sparse_update Adagrad(0.05) on those keys: {touched.numel()} rows touched (top row {top:,}), "
          f"longest segment {longest_segment(torch.sort(keys)[0])}; rows and accumulators bitwise vs the plain "
          f"version on the CPU over the touched rows {'ok' if ok5 else 'FAIL'}; the table's and state's integer "
          f"checksums moved exactly by the touched rows' {'ok' if ok5 else 'FAIL'} ({time.perf_counter() - t0:.1f} s)",
          flush=True)
    if not ok5:
        raise SystemExit("sparse_update at the 1TB table disagrees with its plain version, or moved another row")
    del tbl, acc, grads
    torch.cuda.empty_cache()


def clone_fused_state(state):
    """A second ``FusedTrainState`` on the same card, every tensor copied
    (the model deep-copied, a new Adam over it with the state copied)."""
    import copy

    import torch

    from persia_tpu_torch.parallel.fused_step import FusedTrainState, prepare_dense_optimizer

    model = copy.deepcopy(state.model)
    opt = torch.optim.Adam(model.parameters(), lr=state.optimizer.param_groups[0]["lr"])
    prepare_dense_optimizer(opt, state.step.device)
    for p_src, p_dst in zip(state.model.parameters(), model.parameters()):
        for k, v in state.optimizer.state[p_src].items():
            if torch.is_tensor(v):
                opt.state[p_dst][k].copy_(v)
    return FusedTrainState(model=model, optimizer=opt, tables={k: v.clone() for k, v in state.tables.items()},
                           emb_state={k: {n: t.clone() for n, t in s.items()} for k, s in state.emb_state.items()},
                           emb_batch_state=state.emb_batch_state.clone(), step=state.step.clone())


def compact_fused_twin(ctx, host_batches, model_fn=None, lr=1e-3):
    """The CPU twin of a fused ctx over ``host_batches`` (fused host
    batches, ids in each slot's vocab): each slot's table holds only the
    rows the batches name, copied from the ctx's state, and the ids are
    remapped in order; the model is drawn as the example draws the ctx's
    (``model_fn``: the Criteo example's DLRM unless given), its Adam at
    ``lr``. Returns (state, step, remapped batches, {slot: (touched ids, card
    rows)})."""
    import torch

    from persia_tpu_torch.parallel.fused_step import (
        FusedSlotSpec, build_fused_train_step, group_stacked_specs, init_fused_state,
    )
    from persia_tpu_torch.testing.criteo_dlrm import build_model

    names = sorted(ctx.specs)
    touched = {n: np.unique(np.concatenate([h["ids"][n][h["ids"][n] >= 0] for h in host_batches])) for n in names}
    specs = {n: FusedSlotSpec(vocab=max(1, len(touched[n])), dim=ctx.specs[n].dim) for n in names}
    model = model_fn() if model_fn is not None else build_model(len(names))
    state = init_fused_state(model, torch.optim.Adam(model.parameters(), lr=lr), torch.Generator().manual_seed(0),
                             specs, ctx.sparse_cfg, stack=True, device="cpu")
    (cgrp,) = group_stacked_specs(specs, names)
    (card_grp,) = group_stacked_specs(ctx.specs, names)
    rows = {}
    for n, coff, off in zip(cgrp.slots, cgrp.offsets, card_grp.offsets):
        idx = torch.from_numpy(touched[n].astype(np.int64) + off).to(ctx.device)
        rows[n] = idx
        state.tables[cgrp.name][coff:coff + len(idx)] = ctx.state.tables[card_grp.name][idx].cpu()
        for k, t in state.emb_state[cgrp.name].items():
            t[coff:coff + len(idx)] = ctx.state.emb_state[card_grp.name][k][idx].cpu()
    remapped = [{"dense": h["dense"], "labels": h["labels"],
                 "ids": {n: np.where(h["ids"][n] >= 0, np.searchsorted(touched[n], h["ids"][n]), -1).astype(np.int32)
                         for n in names}} for h in host_batches]
    return state, build_fused_train_step(ctx.sparse_cfg, specs, stack=True), remapped, (cgrp, card_grp, rows)


def compact_rows(state, grp, rows_of, card):
    """The touched rows of every slot in stack order: from the card's
    stacked table (``card``) or from the compact twin's."""
    import torch

    if card:
        return torch.cat([state.tables[grp.name][rows_of[n]].cpu() for n in grp.slots])
    return torch.cat([state.tables[grp.name][off:off + len(rows_of[n])]
                      for n, off in zip(grp.slots, grp.offsets)])


def expect_path_launches(what, launches, exact, at_least=()):
    """The counted run's launches: ``exact`` {kernel: count}, and each of
    ``at_least`` launched at least once; any other count is printed."""
    print(f"  launches={ {k: v for k, v in launches.items() if v} }", flush=True)
    bad = {k: (launches[k], v) for k, v in exact.items() if launches[k] != v}
    bad.update({k: (launches[k], ">= 1") for k in at_least if launches[k] < 1})
    if bad:
        raise SystemExit(f"{what}: launches (got, expected) {bad}")


def criteo_fused_leg(dev, scale, train_b, test_b):
    """The example's fused tier at ``scale``, every table whole on the card:
    the ctx's loop (the CUDA-graph step; the first step, its capture,
    untimed), an eager twin of the state (the counted run) bit for bit the
    graph steps, the compact CPU twin's first steps, the held-out AUC."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.parallel.fused_ctx import batch_to_fused
    from persia_tpu_torch.parallel.fused_step import build_fused_train_step, fused_batch_to_device
    from persia_tpu_torch.testing import criteo_dlrm as cd
    from persia_tpu_torch.testing import roc_auc

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    vocabs = cd.vocabs_of(scale)
    t0 = time.perf_counter()
    ctx = cd.build_ctx(vocabs, tier="fused", device=dev)
    ctx._ensure_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    (tname, table), = ctx.state.tables.items()
    state_bytes = sum(t.numel() * t.element_size() for t in [table, *ctx.state.emb_state[tname].values()])
    print(f"  fused[{scale}]: stacked table {tuple(table.shape)} ({table.numel():,} elements) and its state: "
          f"{state_bytes / 1e9:.2f} GB on the card, built in {init_s:.2f} s", flush=True)
    twin = clone_fused_state(ctx.state)
    host = [batch_to_fused(b, ctx.specs, True) for b in train_b]
    cpu_state, cpu_step, cpu_batches, (cgrp, card_grp, rows_of) = compact_fused_twin(
        ctx, host[:CRITEO_CPU_STEPS])
    init_rows = compact_rows(ctx.state, card_grp, rows_of, card=True)
    losses, step_s = [], []
    for i, b in enumerate(train_b):
        t = time.perf_counter()
        losses.append(ctx.train_step(b)["loss"])  # the example's loop; the first step captures the graph
        step_s.append(time.perf_counter() - t)
        if i + 1 == CRITEO_CPU_STEPS:
            card_rows = compact_rows(ctx.state, card_grp, rows_of, card=True)
    eager = build_fused_train_step(ctx.sparse_cfg, ctx.specs, stack=True, jit=False)
    ops.reset_launch_counts()
    e_losses = []
    for h in host:
        twin, (loss, _) = eager(twin, fused_batch_to_device(h, dev))
        e_losses.append(loss)
    torch.cuda.synchronize()
    launches = launches_now()
    n = len(train_b)
    expect_path_launches(f"criteo fused[{scale}] (eager twin)", launches,
                         dict(fused_gather=n, sparse_update=n, dot_interaction=n, dot_interaction_bwd=n))
    same = same_bits(torch.tensor(losses, dtype=torch.float32), torch.stack(e_losses).cpu()) and all(
        same_bits(a, c) for a, c in zip(fused_state_tensors(ctx.state), fused_state_tensors(twin)))
    del twin
    torch.cuda.empty_cache()
    cpu_losses = [float(cpu_step(cpu_state, fused_batch_to_device(h, "cpu"))[1][0]) for h in cpu_batches]
    loss_err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
    cpu_rows = compact_rows(cpu_state, cgrp, rows_of, card=False)
    row_err = float((card_rows - cpu_rows).abs().max())
    delta_err = float((card_rows - cpu_rows).norm() / (cpu_rows - init_rows).norm())
    ok = same and loss_err <= 2e-2 and row_err <= 1e-2 and delta_err <= FUSED_DELTA_RTOL and np.isfinite(losses).all()
    print(f"  fused[{scale}]: graph steps vs eager twin, {n} steps: losses, tables, states and parameters bitwise "
          f"{'ok' if same else 'FAIL'}; first {CRITEO_CPU_STEPS} losses card {losses[:CRITEO_CPU_STEPS]} cpu "
          f"(compact twin, {cpu_rows.shape[0]} rows) {cpu_losses}: max_abs_err={loss_err:.3e} tolerance=2e-2; rows "
          f"max_abs_err={row_err:.3e} tolerance=1e-2; |delta card - cpu| / |delta cpu| = {delta_err:.3e} "
          f"tolerance={FUSED_DELTA_RTOL:g} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"criteo fused[{scale}]: the graph and eager steps, or card and CPU, disagree")
    preds, labels = cd.predict(ctx, test_b)
    steady = sum(step_s[1:])
    out = {"tier": "fused", "scale": scale, "steps": n, "losses_first": losses[:CRITEO_CPU_STEPS],
           "loss_mean": float(np.mean(losses)), "test_auc": float(roc_auc(labels, preds)),
           "samples_per_s": (n - 1) * BATCH / steady, "first_step_s": step_s[0],
           "step_ms_p50": float(np.percentile(step_s[1:], 50) * 1e3),
           "table_rows": int(table.shape[0]), "table_elements": int(table.numel()), "state_bytes": state_bytes,
           "init_s": init_s, "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "loss_max_abs_err_vs_cpu": loss_err, "row_max_abs_err_vs_cpu": row_err, "rows_compared": cpu_rows.shape[0],
           "row_delta_rel_err_vs_cpu": delta_err, "graph_equals_eager_steps": n, "launches": launches}
    print(f"  fused[{scale}]: {out['samples_per_s']:.1f} samples/s (graph steps after the capture), step p50 "
          f"{out['step_ms_p50']:.2f} ms, test_auc {out['test_auc']:.6f} (not gated), peak device bytes "
          f"{out['peak_device_bytes']:,}", flush=True)
    del ctx, cpu_state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def store_entries(stores):
    """{sign: entry} over numpy stores."""
    return {int(s): np.array(v) for st in stores for sh in st._shards for s, (_, v) in sh.entries.items()}


def entries_close(card_stores, cpu_stores):
    a, b = store_entries(card_stores), store_entries(cpu_stores)
    if a.keys() != b.keys() or not a:
        return float("inf"), len(a)
    return max(float(np.abs(a[k] - b[k]).max()) for k in a), len(a)


def criteo_store_leg(dev, scale, tier, train_b, test_b):
    """The example's hybrid or cached tier at ``scale`` over its numpy
    stores: the first steps on the card and in the CPU port (hybrid: the
    reproducible loader; cached: the example's stream) held together, then
    the counted run as the example runs it (hybrid: the rest through
    ``DataLoader(num_workers=4, staleness=4)``; cached: every batch through
    ``train_stream(on_metrics=...)`` from a fresh ctx), ``publish()`` and the
    held-out AUC."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.testing import criteo_dlrm as cd
    from persia_tpu_torch.testing import roc_auc

    vocabs = cd.vocabs_of(scale)
    above = cd.HASHSTACK_ABOVE_1TB if scale == "1tb" else None
    k = CRITEO_CPU_STEPS
    card = cd.build_ctx(vocabs, tier=tier, hashstack_above=above, device=dev).__enter__()
    cpu = cd.build_ctx(vocabs, tier=tier, hashstack_above=above, device="cpu").__enter__()
    ps = tuple(card.tier.ps_slots) if tier == "cached" else ()
    cpu_losses, _ = cd.train(cpu, tier, train_b[:k], deterministic=True)
    if tier == "hybrid":
        first, _ = cd.train(card, tier, train_b[:k], deterministic=True)
        row_err, n_rows = entries_close(card.worker.lookup_router.replicas, cpu.worker.lookup_router.replicas)
        ops.reset_launch_counts()
        rest, secs = cd.train(card, tier, train_b[k:])  # the example's loader: 4 threads, staleness 4
        launches = launches_now()
        losses, n = first + rest, len(train_b) - k
        expect_path_launches(f"criteo {tier}[{scale}]", launches, dict(dot_interaction=n, dot_interaction_bwd=n))
    else:
        ops.reset_launch_counts()
        losses, secs = cd.train(card, tier, train_b)  # the example's stream, one step a dispatch
        launches = launches_now()
        n = len(train_b)
        expect_path_launches(f"criteo {tier}[{scale}]", launches,
                             dict(dot_interaction=n, dot_interaction_bwd=n, cached_gather=n, sparse_update=n),
                             at_least=("cache_aux",))
        row_err, n_rows = None, 0
    err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
    published = card.publish() if tier == "cached" else None
    preds, labels = cd.predict(card, test_b)
    ok = err <= 2e-2 and np.isfinite(losses).all() and (row_err is None or row_err <= 1e-2)
    out = {"tier": tier, "scale": scale, "steps": len(train_b), "ps_slots": list(ps),
           "losses_first": losses[:k], "cpu_losses": cpu_losses, "loss_max_abs_err_vs_cpu": err,
           "ps_rows_compared": n_rows, "ps_row_max_abs_err_vs_cpu": row_err, "loss_mean": float(np.mean(losses)),
           "test_auc": float(roc_auc(labels, preds)), "samples_per_s": n * BATCH / secs, "timed_steps": n,
           "published_rows": published, "launches": launches}
    print(f"  {tier}[{scale}]{f' (PS slots {list(ps)})' if ps else ''}: first {k} losses card {losses[:k]} cpu "
          f"{cpu_losses} max_abs_err={err:.3e} tolerance=2e-2"
          f"{f'; {n_rows} PS rows max_abs_err={row_err:.3e} tolerance=1e-2' if row_err is not None else ''} "
          f"{'ok' if ok else 'FAIL'}; {out['samples_per_s']:.1f} samples/s over {n} steps; test_auc "
          f"{out['test_auc']:.6f} (not gated){f'; published {published} rows' if published is not None else ''}",
          flush=True)
    if not ok:
        raise SystemExit(f"criteo {tier}[{scale}]: card and CPU disagree, or a loss is not finite")
    card.__exit__(None, None, None)
    cpu.__exit__(None, None, None)
    torch.cuda.empty_cache()
    return launches, out


def path_criteo(dev):
    """Phase 4l: the Criteo DLRM example through the port at B=4096, each
    tier at Kaggle and 1TB scale."""
    from persia_tpu_torch.testing import criteo_dlrm as cd

    print(f"== phase 4l: the Criteo DLRM example (persia_tpu_torch.testing.criteo_dlrm), B={BATCH}, "
          f"{CRITEO_STEPS} train and {CRITEO_EVAL} held-out batches a leg", flush=True)
    launches, out = {}, {}
    for scale in ("kaggle", "1tb"):
        train, test = cd.datasets(scale, CRITEO_STEPS, CRITEO_EVAL, BATCH)
        train_b, test_b = list(train.batches(BATCH)), list(test.batches(BATCH, requires_grad=False))
        for tier in cd.TIERS:
            t = time.perf_counter()
            if tier == "fused":
                la, o = criteo_fused_leg(dev, scale, train_b, test_b)
            else:
                la, o = criteo_store_leg(dev, scale, tier, train_b, test_b)
            o["seconds"] = time.perf_counter() - t
            o["profiler_records_device_work_after"] = profiler_records_device_work(dev)
            # the fused legs' graph steps go through no wrapper: their
            # counts are the eager twin's over the same batches
            key = f"criteo_{tier}_{scale}" + (f" (eager twin of its {CRITEO_STEPS} graph steps)"
                                                if tier == "fused" else "")
            launches[key], out[f"{tier}_{scale}"] = la, o
            print(f"  criteo-dlrm[{scale}] tier={tier} steps={o['steps']} loss={o['loss_mean']:.4f} "
                  f"test_auc={o['test_auc']:.6f} throughput={o['samples_per_s']:,.0f} samples/sec "
                  f"({o['seconds']:.1f} s; a profiler session after it records device work: "
                  f"{o['profiler_records_device_work_after']})", flush=True)
    return launches, out


def path_100t(dev):
    """Phase 4m: the 100T harness at 128 numpy replicas, B=1024: 3
    reproducible steps on the card and in the CPU port held together
    (losses, every replica's entries), then the counted run through the
    example's loader; the example's record."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.testing import synthetic_100t as sh

    print(f"== phase 4m: the 100T harness (persia_tpu_torch.testing.synthetic_100t), 128 replicas, "
          f"B={H100T_BATCH}, {H100T_REPRO} reproducible + {H100T_STEPS} steps", flush=True)
    batches = list(sh.dataset(H100T_REPRO + H100T_STEPS, H100T_BATCH).batches(H100T_BATCH))
    card, stores = sh.build_ctx(device=dev)
    cpu, cpu_stores = sh.build_ctx(device="cpu")
    with card, cpu:
        cpu_losses, _ = sh.train(cpu, batches[:H100T_REPRO], deterministic=True)
        first, _ = sh.train(card, batches[:H100T_REPRO], deterministic=True)
        err = max(abs(a - c) for a, c in zip(first, cpu_losses))
        row_err, n_rows = entries_close(stores, cpu_stores)
        ops.reset_launch_counts()
        losses, secs = sh.train(card, batches[H100T_REPRO:])
        launches = launches_now()
        pool = card.worker.lookup_router._fan_pool._max_workers
    expect_path_launches("100t harness", launches, dict(dot_interaction=H100T_STEPS, dot_interaction_bwd=H100T_STEPS))
    rec = sh.record(stores, first + losses, secs, H100T_STEPS, batch_size=H100T_BATCH)
    ok = err <= 2e-2 and row_err <= 1e-2 and np.isfinite(losses).all() and len(stores) == 128
    th, cap = rec["throughput"], rec["capacity"]
    print(f"  {len(stores)} replicas (fan-out pool of {pool} threads): first {H100T_REPRO} losses card {first} cpu "
          f"{cpu_losses} max_abs_err={err:.3e} tolerance=2e-2; {n_rows} entries max_abs_err={row_err:.3e} "
          f"tolerance=1e-2 {'ok' if ok else 'FAIL'}", flush=True)
    print(f"  synthetic-100t ps_replicas={len(stores)} steps={H100T_STEPS} loss={np.mean(losses):.4f} "
          f"throughput={th['samples_per_sec']:,.0f} samples/sec ({th['ids_per_sec_through_router']:,.0f} ids/sec); "
          f"{cap['rows_resident']:,} rows resident; {cap['bytes_per_row']} B/row -> "
          f"{cap['tb_needed_for_100t']:,.1f} TB for 100T params, {cap['hosts_at_512gb']:,} hosts at 512 GB",
          flush=True)
    if not ok:
        raise SystemExit("100t harness: card and CPU disagree, or a loss is not finite")
    torch.cuda.empty_cache()
    rec.update(loss_max_abs_err_vs_cpu=err, rows_compared=n_rows, row_max_abs_err_vs_cpu=row_err, pool_threads=pool,
               profiler_records_device_work_after=profiler_records_device_work(dev))
    print(f"  a profiler session after it records device work: {rec['profiler_records_device_work_after']}",
          flush=True)
    return {"h100t": launches}, rec


def path_quality(dev):
    """Phase 4n: the quality gate (``testing.quality``) at its 200 steps:
    the cached, ps-stream and fused tiers on the identical stream, each
    counted; fails when their held-out AUCs spread by 0.02 or more."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.testing import quality as q

    print(f"== phase 4n: the quality gate (persia_tpu_torch.testing.quality), {QUALITY_STEPS} steps of B={q.BATCH} "
          f"+ {q.EVAL_BATCHES} held out, tiers {q.TIERS}", flush=True)
    t = time.perf_counter()
    train_b, eval_b = q.quality_data(QUALITY_STEPS)
    data_s = time.perf_counter() - t
    out, launches = {"data_s": data_s}, {}
    for tier in q.TIERS:
        t = time.perf_counter()
        store = None if tier == "fused" else make_store(
            "native", capacity=q.STORE_ROWS, num_internal_shards=q.STORE_SHARDS, optimizer=Adagrad(lr=0.05).config,
            seed=1)
        ops.reset_launch_counts()
        res = q.run_tier(tier, train_b, eval_b, dev, store)
        la = launches_now()
        del store
        # the fused tier's capture (its warm-up and the capture) goes
        # through the wrappers; its replays do not
        expect_path_launches(f"quality {tier}", la, {}, at_least={
            "cached": ("cache_aux", "cached_gather", "sparse_update"),
            "ps-stream": ("quantize_int8_ef", "gather_pool_fwd", "gather_pool_bwd"),
            "fused": ("fused_gather", "sparse_update")}[tier] + ("dot_interaction", "dot_interaction_bwd"))
        torch.cuda.empty_cache()
        res["seconds"] = time.perf_counter() - t
        res["profiler_records_device_work_after"] = profiler_records_device_work(dev)
        key = f"quality_{tier}" + (" (the graph's warm-up and capture; its replays uncounted)"
                                   if tier == "fused" else "")
        out[tier], launches[key] = res, la
        print(f"  {tier}: auc {res['auc']:.10f}, {res['samples_per_sec']:.1f} samples/s over {res['timed_steps']} "
              f"timed steps ({res['seconds']:.1f} s; a profiler session after it records device work: "
              f"{res['profiler_records_device_work_after']})", flush=True)
    out["auc_spread"] = q.spread(out)
    out["steps"] = QUALITY_STEPS
    ok = out["auc_spread"] < q.SPREAD_LIMIT
    print(f"  AUC spread {out['auc_spread']:.6f}, limit {q.SPREAD_LIMIT} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"quality gate: tier AUC spread {out['auc_spread']} is not under {q.SPREAD_LIMIT}")
    return launches, out


def fanout_timing(dev):
    """The router's fan-out across its replicas against the same calls run
    inline, one replica after another, and with every part handed to the
    pool (subclasses here), in turns (fan, inline, pool_all, pool_all,
    inline, fan, twice), over the same ``FANOUT_STEPS`` batches
    each turn on phases 4g's and 4i's ctxs (two native replicas), after a
    warm-up pass over them: synchronous ``train_step``s of DIN and DeepFM
    (one caller) and DIN through ``DataLoader(num_workers=4,
    staleness=4)`` (the loader's lookup threads and gradient lanes call at
    once); each turn's lookup and update p50, the ms a step spent in the
    router's calls (``lookup_groups``, ``update_groups`` and
    ``advance_batch_state``, their tails included: a p50 hides a slow
    hand-off) and its samples/s."""
    import torch

    from persia_tpu_torch.data_loader import DataLoader
    from persia_tpu_torch.embedding.worker import FANOUT_WAIT_S, ShardedLookup
    from persia_tpu_torch.testing import AvazuSynthetic, TaobaoSynthetic

    class Inline(ShardedLookup):
        def _concurrent(self, thunks):
            return [t() for t in thunks]

    class PoolAll(ShardedLookup):
        """Every part handed to a pool thread and waited for: none on the
        caller, none taken back, every call fanned out whichever thread
        makes it."""

        def _concurrent(self, thunks):
            if len(thunks) <= 1 or self._fan_pool is None:
                return [t() for t in thunks]
            futures = [self._fan_pool.submit(t) for t in thunks]
            return [f.result(timeout=FANOUT_WAIT_S) for f in futures]

    modes = {"fan": ShardedLookup, "inline": Inline, "pool_all": PoolAll}
    order = ("fan", "inline", "pool_all", "pool_all", "inline", "fan") * 2
    print(f"== phase 4i (fan-out): the router's fan-out, the same calls inline and every part on the pool, "
          f"in turns {order}, {FANOUT_STEPS} steps a turn, two native replicas", flush=True)

    def turn(ctx, mode, batches, loader):
        router = ctx.worker.lookup_router
        router.__class__ = modes[mode]
        look, upd, adv, sink = [], [], [], []
        undo = [timed_calls(router, "lookup_groups", look, sink), timed_calls(router, "update_groups", upd, sink),
                timed_calls(router, "advance_batch_state", adv, sink)]
        t = time.perf_counter()
        if loader:
            dl = DataLoader(batches, ctx, num_workers=4, staleness=4)
            for tb in dl:
                ctx.train_step_prepared(tb, dl, fetch_metrics=False)
            dl.flush()
            dl.shutdown()
        else:
            for b in batches:
                ctx.train_step(b)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        for u in undo:
            u()
        router.__class__ = ShardedLookup
        return {"mode": mode, "lookup_ms_p50": float(np.percentile(look, 50)),
                "update_ms_p50": float(np.percentile(upd, 50)),
                "router_ms_a_step": (sum(look) + sum(upd) + sum(adv)) / len(batches),
                "samples_per_s": len(batches) * len(batches[0].labels[0].data) / wall}

    out = {}
    legs = (("din_4g", lambda: din_ctx(dev, "native")[0],
             TaobaoSynthetic(num_samples=FANOUT_STEPS * DIN_BATCH, seed=7).batches(DIN_BATCH), (False, True)),
            ("deepfm_4i", lambda: avazu_ctx("deepfm", dev, "native")[0],
             AvazuSynthetic(num_samples=FANOUT_STEPS * AVAZU_BATCH, seed=7).batches(AVAZU_BATCH), (False,)))
    for name, make, stream, loaders in legs:
        batches = list(stream)
        ctx = make()
        for b in batches:  # warm-up: every sign admitted, every path built
            ctx.train_step(b)
        for loader in loaders:
            turns = [turn(ctx, mode, batches, loader) for mode in order]
            key = f"{name}_{'loader' if loader else 'sync'}"
            med = {m: float(np.median([t["samples_per_s"] for t in turns if t["mode"] == m])) for m in modes}
            router_med = {m: float(np.median([t["router_ms_a_step"] for t in turns if t["mode"] == m]))
                          for m in modes}
            out[key] = {"turns": turns, "samples_per_s_median": med, "router_ms_a_step_median": router_med}
            print(f"  {key}: " + "; ".join(
                f"{t['mode']} lookup {t['lookup_ms_p50']:.3f} update {t['update_ms_p50']:.3f} ms p50, "
                f"router {t['router_ms_a_step']:.3f} ms a step, "
                f"{t['samples_per_s']:.1f} samples/s" for t in turns) + f"; median samples/s {med}, "
                f"router ms a step {router_med}", flush=True)
        ctx.__exit__(None, None, None)
    return out


def profiler_records_device_work(dev) -> bool:
    """Whether a torch.profiler session now records the card's work (20
    one-element adds), as a diagnostic."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    x = torch.zeros(1, device=dev)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            x.add_(1.0)
        torch.cuda.synchronize()
    return any(getattr(e, "device_time_total", 0) > 0 for e in prof.key_averages())


def time_fused_1tb(dev, rows):
    """Phase 5's K4 (with keys) and K5 at the Criteo-1TB stack (183.9M x 16
    f32 and its Adagrad state, 23.5 GB, random): warm (one batch) and cold
    (fresh batches rotated), on the Criteo-1TB stream's ids and on ids
    uniform over each slot; added to the K4 and K5 rows (``at_1tb``) beside
    their 26M-row numbers."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.ops.sparse_update import PAD_SENTINEL, sparse_update_sorted, update_keys_reference
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec, group_stacked_specs
    from persia_tpu_torch.testing import CRITEO_1TB_VOCABS

    specs = {f"cat_{i}": FusedSlotSpec(vocab=v, dim=EMB_DIM) for i, v in enumerate(CRITEO_1TB_VOCABS)}
    (grp,) = group_stacked_specs(specs, sorted(specs))
    offs, vocabs = list(grp.offsets), [specs[n].vocab for n in grp.slots]
    g = torch.Generator(device=dev).manual_seed(SEED + 41)
    tbl = torch.empty((grp.vocab, EMB_DIM), device=dev).normal_(generator=g).mul_(0.05)
    acc = torch.empty((grp.vocab, EMB_DIM), device=dev).uniform_(0.01, 1.0, generator=g)
    cfg = Adagrad(lr=0.05).config
    rng = np.random.default_rng(SEED + 41)
    seeds = iter(range(100, 10_000))

    def batch_ids(kind):
        if kind == "criteo":
            ids = criteo_tb_ids(rng, next(seeds), CRITEO_1TB_VOCABS, top=False)
        else:
            ids = [rng.integers(0, v, BATCH).astype(np.int32) for v in vocabs]
        return [torch.from_numpy(i).to(dev) for i in ids]

    n_pos = BATCH * len(vocabs)
    bs = torch.ones(2, device=dev)
    out = {}
    for kind in ("criteo", "uniform"):
        ids = batch_ids(kind)
        k4_bytes = n_pos * 4 + 2 * n_pos * EMB_DIM * 4 + n_pos * 4
        k4_bms, _ = bound(k4_bytes, 0, "float32")
        warm = [graph_ms(lambda: ops.fused_gather(tbl, ids, offs, vocabs, True, keys=True)) for _ in range(2)]
        cold = [cold_ms(lambda i: ops.fused_gather(tbl, i, offs, vocabs, True, keys=True),
                        lambda: (batch_ids(kind),), n_pos * 4 + n_pos * EMB_DIM * 4)["ms"] for _ in range(2)]

        def k5_in(ids_):
            flat = update_keys_reference(ids_, offs, vocabs)
            sids, perm = torch.sort(flat, stable=True)
            grads = torch.randn((flat.numel(), EMB_DIM), device=dev, generator=g) * 1e-3
            return sids, perm, grads

        sids, perm, grads = k5_in(ids)
        touched = int(torch.unique(sids[sids != PAD_SENTINEL]).numel())
        k5_bytes = n_pos * 4 + n_pos * 8 + n_pos * EMB_DIM * 4 + touched * EMB_DIM * 4 * 4
        k5_bms, k5_by = bound(k5_bytes + 8, n_pos * EMB_DIM + touched * EMB_DIM * 8, "float32")
        k5_warm = [graph_ms(lambda: sparse_update_sorted(cfg, tbl, {"acc": acc}, sids, perm, grads, bs))
                   for _ in range(2)]
        k5_cold = [cold_ms(lambda si, pe, gr: sparse_update_sorted(cfg, tbl, {"acc": acc}, si, pe, gr, bs),
                           lambda: k5_in(batch_ids(kind)), k5_bytes)["ms"] for _ in range(2)]
        out[kind] = {"k4_ms": min(warm), "k4_ms_runs": warm, "k4_cold_ms": min(cold), "k4_cold_ms_runs": cold,
                     "k4_bound_ms": k4_bms, "k5_ms": min(k5_warm), "k5_ms_runs": k5_warm, "k5_cold_ms": min(k5_cold),
                     "k5_cold_ms_runs": k5_cold, "k5_bound_ms": k5_bms, "k5_bound_by": k5_by,
                     "touched_rows": touched, "longest_segment": longest_segment(sids)}
        print(f"  at the 1TB stack ({grp.vocab:,} rows), {kind} ids: fused_gather with keys warm {warm} cold {cold} "
              f"ms (bound {k4_bms:.5f}); sparse_update warm {k5_warm} cold {k5_cold} ms (bound {k5_bms:.5f}, "
              f"{touched} rows touched, longest segment {out[kind]['longest_segment']})", flush=True)
    for r in rows:
        if r["name"] == "fused_gather":
            r["at_1tb"] = {"table_rows": grp.vocab, **{k: {kk[3:]: vv for kk, vv in v.items() if kk.startswith("k4_")}
                                                       for k, v in out.items()}}
        elif r["name"] == "sparse_update":
            r["at_1tb"] = {"table_rows": grp.vocab, **{k: {**{kk[3:]: vv for kk, vv in v.items() if kk.startswith("k5_")},
                                                           "touched_rows": v["touched_rows"],
                                                           "longest_segment": v["longest_segment"]}
                                                       for k, v in out.items()}}
    del tbl, acc
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# DeepFM, DCN-v2 and DNN on the fused tier (phase 4o); the cache tier's bf16
# pools and dynamic loss scale (phases 3g and 4p) and their kernels' rows
# of phase 5

PREC_NAMES = {"cache_aux": "cache_aux[bf16 pool]", "gather_entry_rows": "gather_entry_rows[bf16 pool]",
              "cached_gather": "cached_gather[bf16 pool]", "quantize_int8_ef": "quantize_int8_ef[loss scale]"}
FUSED_MODEL_STEPS, FUSED_MODEL_CPU_STEPS = 6, 3
# 4o's card-vs-CPU bounds (first losses, touched rows), two to four times
# what three H100 runs read, the same each run: DeepFM 3.6e-7 / 6.8e-6,
# DCN-v2 2.4e-7 / 3.2e-6, DNN 1.4e-4 / 3.8e-3 (bf16 compute through two
# batch norms)
FUSED_MODEL_TOL = {"deepfm": (1e-6, 2e-5), "dcnv2": (1e-6, 1e-5), "dnn": (5e-4, 1e-2)}
# phase 4p: the cached configuration (bench.py:285-344: bf16 wires, the
# touch gate) at phase 4k saturated's 2^18 rows, batches and 56 timed
# steps (the last 16 all evicting), with bf16 pools and the dynamic loss
# scale, each alone and neither (PREC_LEGS: (bf16 pools, loss scale), one
# turn in this order and one reversed; the last leg, both, is counted);
# the ps-stream (int8) and the forced overflow on the mixed configuration
PREC_STEPS, PREC_PS_STEPS, PREC_OVERFLOW_STEPS = 56, 12, 3
PREC_LEGS = ((True, True), (True, False), (False, True), (False, False))
PREC_LEG_NAMES = {(True, True): "bf16_pools_loss_scale", (True, False): "bf16_pools",
                  (False, True): "f32_pools_loss_scale", (False, False): "f32_pools"}
# 4p's card-vs-CPU bounds (losses, entries after flush), two to three
# times what an H100 run read: 2.1e-4 and 3.7e-4 over the 59 steps
PREC_TOL = (5e-4, 1e-3)
PREC_LS_INIT = float(2 ** 15)
HUGE_SCALE = float(np.float32(3.0e38))  # tests/test_loss_scale.py's: any gradient > ~1 overflows
OVERFLOW_DENSE_SCALE = 1e4  # the overflow leg's dense features: gradients past 1 at the bench model


def phase_precision_kernels(dev):
    """Phase 3g: K12, its read and K13 on a bf16 pool, and K15 under the
    loss scale's gate (``inv`` and ``finite`` read on the card), against
    their plain versions, bit for bit (K13 at L > 1 within the f32
    sum-order bound)."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.cache_aux import (
        cache_aux_reference, cache_aux_ring_reference, gather_entry_rows_reference,
    )
    from persia_tpu_torch.ops.cached_gather import cached_gather_reference
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef_reference
    from persia_tpu_torch.testing.cache_cases import aux_case, gather_case

    print("== phase 3g: K12, its read and K13 on a bf16 pool, K15 under the loss scale, vs their plain versions",
          flush=True)
    bf = torch.bfloat16
    errs = dict.fromkeys(PREC_NAMES.values(), 0.0)

    def aux_check(label, case, wb_bf16, ring_pos=None):
        cpu = to_cpu(case)
        store = ring_pos is not None
        rring = cpu.pop("ring", None)
        cpu.pop("ring_pos", None)
        kw = {k: v for k, v in case.items() if k != "ring_pos"}
        pay = ops.cache_aux(**kw, wb_bf16=wb_bf16, ring_pos=ring_pos)
        if store:
            ref = cache_aux_ring_reference(ring=rring, ring_pos=ring_pos, **cpu, wb_bf16=wb_bf16)
        else:
            ref = cache_aux_reference(**cpu, ring=rring, wb_bf16=wb_bf16)
        ok = (bits_equal(pay, ref) and bits_equal(case["table"], cpu["table"])
              and all(bits_equal(case["state"][k], cpu["state"][k]) for k in cpu["state"])
              and (rring is None or bits_equal(case["ring"], rring)))
        print(f"  cache_aux (bf16 pool) {label}: payload {tuple(pay.shape)} {str(pay.dtype)[6:]}: tolerance=0 "
              f"(bitwise) {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"cache_aux on a bf16 pool ({label}) disagrees with its plain version")

    for kind in ("sgd", "adagrad", "adagrad_vw", "adam"):
        for aux_bf16, wb_bf16 in ((True, True), (False, False)):
            case = aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 7700, 4600, 3100, 0.5, aux_bf16, dev,
                            seed=SEED + 90 + len(kind) + aux_bf16, table_dtype=bf)
            aux_check(f"{kind} wires={'bf16' if wb_bf16 else 'f32'}", case, wb_bf16)
        case = aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 7700, 3800, 3200, 0.5, True, dev, seed=SEED + 95 + len(kind),
                        n_restore=700, ring_rows=1 << 19, wb_bf16=True, ring_pos=(1 << 18) + 100, table_dtype=bf)
        aux_check(f"{kind} with 700 restores from a bf16 ring, the payload stored", case, True, ring_pos=(1 << 18) + 100)
    rows = torch.randperm(CACHE_SAT_ROWS + 1, generator=torch.Generator().manual_seed(3))[:CACHE_SAT_ROWS].int()
    for kind in ("adagrad", "adam", "sgd"):
        case = aux_case(kind, CACHE_SAT_ROWS, EMB_DIM, 1, 0, 0, False, False, dev, seed=SEED + 97, table_dtype=bf)
        got = ops.gather_entry_rows(case["table"], case["state"], rows.to(dev))
        ref = gather_entry_rows_reference(case["table"].cpu(), {k: v.cpu() for k, v in case["state"].items()}, rows)
        back = bits_equal(got[:, :EMB_DIM].to(bf), case["table"][rows.to(dev).long()])
        ok = bits_equal(got, ref) and back
        print(f"  gather_entry_rows (bf16 pool) {kind} ({rows.numel()} rows): tolerance=0 (bitwise); the rows "
              f"widened round back to their bits: {back} {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise SystemExit(f"gather_entry_rows on a bf16 pool ({kind}) disagrees with its plain version")
    for S, L, C, scale, miss, zipf in ((N_SLOTS, 1, CACHE_SAT_ROWS, False, 0, True),
                                       (N_SLOTS, 1, CACHE_SAT_ROWS, True, 0, True),
                                       (N_SLOTS, 1, CACHE_SAT_ROWS, False, 4000, False),
                                       (4, 8, CACHE_SAT_ROWS, True, 1000, False)):
        case = gather_case(S, BATCH, L, C, EMB_DIM, dev, seed=SEED + 98 + L + miss, scale=scale, miss=miss,
                           zipf=zipf, table_dtype=bf)
        cpu = to_cpu(case)
        keys = miss == 0
        sc, mt = case.get("scale"), case.get("miss_table")
        got = ops.cached_gather(case["table"], case["rows"], True, sc, keys=keys, miss_table=mt)
        ref = cached_gather_reference(cpu["table"], cpu["rows"], True, cpu.get("scale"), keys=keys,
                                      miss_table=cpu.get("miss_table"))
        pooled, rpooled = (got[0], ref[0]) if keys else (got, ref)
        err = float((pooled.cpu() - rpooled).abs().max())
        if L == 1:
            ok, tol = bits_equal(pooled, rpooled), "0 (bitwise)"
        else:
            bound_ = cached_gather_reference(cpu["table"].float().abs(), cpu["rows"], True, cpu["scale"].abs(),
                                             miss_table=cpu["miss_table"].abs())
            ok, tol = bool(((pooled.cpu() - rpooled).abs() <= (L - 1) * 2.0 ** -23 * bound_).all()), \
                "(L - 1) * 2^-23 * sum|x| * |scale|"
        if keys:
            ok = ok and bits_equal(got[1], ref[1])
        raw = ops.cached_gather(case["table"], case["rows"][0].contiguous(), False, keys=keys, miss_table=mt)
        rraw = cached_gather_reference(cpu["table"], cpu["rows"][0], False, keys=keys, miss_table=cpu.get("miss_table"))
        ok = ok and all(bits_equal(a, b) for a, b in zip(raw, rraw))
        print(f"  cached_gather (bf16 pool) S={S} B={BATCH} L={L} scale={scale} eval misses={miss}: "
              f"max_abs_err={err:.3e} tolerance={tol}; keys, raw rows and mask bitwise {'ok' if ok else 'FAIL'}",
              flush=True)
        if not ok:
            raise SystemExit("cached_gather on a bf16 pool disagrees with its plain version")
        errs[PREC_NAMES["cached_gather"]] = max(errs[PREC_NAMES["cached_gather"]], err)
    # K15 under the gate: the ps-stream shape and the edge cases, finite
    # (a scale of 2^10) and on an overflow (an inf, inv 0), three steps
    for lengths in ([1536 * EMB_DIM] * N_SLOTS,) + K15_CASES[:3]:
        for dtype in (bf, torch.float32):
            for finite in (True, False):
                g, res, offsets = k15_inputs(dev, lengths, dtype, SEED + 99 + len(lengths))
                g = (g.float() * 1024.0).to(dtype)
                if not finite:
                    g[offsets[-1] // 3] = float("inf")
                inv = torch.tensor(1.0 / 1024.0 if finite else 0.0, device=dev)
                fin = torch.tensor(1.0 if finite else 0.0, device=dev)
                plain = res.clone()
                diffs = []
                for step in range(3):
                    kept = res.clone()
                    before = ops.quantize_int8_ef.launches
                    q, s, new = ops.quantize_int8_ef(g, res, offsets, inv, fin)
                    q1, s1, plain = quantize_int8_ef_reference(g, plain, offsets, inv, fin)
                    torch.cuda.synchronize()
                    if ops.quantize_int8_ef.launches != before + 1 or float(s[-1]) != float(finite):
                        diffs.append((step, "launch or tail"))
                    for name, a, b in (("codes", q, q1), ("scales", s, s1), ("residual", new, plain)):
                        if not bits_equal(a.view(torch.int32) if a.dtype == torch.float32 else a,
                                          b.view(torch.int32) if b.dtype == torch.float32 else b):
                            diffs.append((step, name))
                    if not finite and (q.any() or s.any() or not bits_equal(new, kept)):
                        diffs.append((step, "an overflow moved something"))
                    g = (g.float() * -0.5 + 1e-3).to(dtype)
                print(f"  quantize_int8_ef (loss scale) {len(lengths)} segments of {lengths[:3]}... "
                      f"{str(dtype).split('.')[-1]} {'finite, inv 2^-10' if finite else 'overflow, inv 0'}: codes, "
                      f"scales (tail {float(finite)}) and residual bitwise vs the plain version, 3 steps "
                      f"{'ok' if not diffs else f'FAIL {diffs}'}", flush=True)
                if diffs:
                    raise SystemExit("quantize_int8_ef under the loss scale disagrees with its plain version")
    torch.cuda.empty_cache()
    return errs


def dnn_fused_model():
    """DNN at phase 4j's width (``benchmarks/serving_bench.py:37-68``:
    8 slots of dim 16, DNN(32, 128, (128, 64)), bf16 compute) on the CPU,
    its weights drawn from SEED."""
    import torch

    from persia_tpu_torch.models import DNN

    return DNN(DNN_DENSE, [DNN_DIM] * DNN_SLOTS, *DNN_MLP, device="cpu", generator=torch.Generator().manual_seed(SEED))


def fused_model_ctx(name, dev):
    """DeepFM and DCN-v2: ``testing/avazu.py``'s ``build_ctx(tier="fused")``
    (21 tables at ``AVAZU_VOCABS``' sizes, no cap); DNN: its slots as
    fused tables of DNN_VOCAB rows, Adam(3e-3), Adagrad(0.1), folded ids.
    Returns (ctx, the CPU model builder, the dense lr)."""
    import torch

    from persia_tpu_torch.embedding.optim import Adagrad
    from persia_tpu_torch.parallel.fused_ctx import FusedTrainCtx
    from persia_tpu_torch.parallel.fused_step import FusedSlotSpec
    from persia_tpu_torch.testing import avazu as ta

    if name != "dnn":
        return (ta.build_ctx(name, AVAZU_FIELDS, tier="fused", device=dev),
                lambda: ta.build_model(name, AVAZU_FIELDS), 1e-3)
    model = dnn_fused_model()
    specs = {f"cat_{i}": FusedSlotSpec(vocab=DNN_VOCAB, dim=DNN_DIM) for i in range(DNN_SLOTS)}
    return (FusedTrainCtx(model, torch.optim.Adam(model.parameters(), lr=3e-3), Adagrad(lr=0.1), specs, fold_ids=True,
                          seed=SEED, device=dev), dnn_fused_model, 3e-3)


def fused_model_leg(dev, name, root):
    """One model on the fused tier at full width: the ctx's loop (the
    CUDA-graph step, its first call the capture), an eager twin of the
    state (the counted run) bit for bit the graph steps (DNN's batch
    statistics included), the compact CPU twin's first steps, the card's
    busy time a graph step (whether the trace held device events is
    printed), a checkpoint round trip bit for bit."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.parallel.fused_ctx import batch_to_fused
    from persia_tpu_torch.parallel.fused_step import build_fused_train_step, fused_batch_to_device
    from persia_tpu_torch.testing import AvazuSynthetic
    from persia_tpu_torch.weights import fused_state_to_flax

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ctx, model_fn, lr = fused_model_ctx(name, dev)
    ctx._ensure_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    (tname, table), = ctx.state.tables.items()
    state_bytes = sum(t.numel() * t.element_size() for t in [table, *ctx.state.emb_state[tname].values()])
    n = FUSED_MODEL_STEPS
    if name == "dnn":
        make = dnn_batch_maker(SEED + 70, BATCH)
        train_b = [make() for _ in range(n + 2)]
    else:
        train_b = list(AvazuSynthetic(num_samples=(n + 2) * AVAZU_BATCH, seed=42).batches(AVAZU_BATCH))
    prof_b, train_b = train_b[n:], train_b[:n]
    B = train_b[0].batch_size
    print(f"  fused {name}: {len(ctx.specs)} tables, stacked {tuple(table.shape)} and its state: "
          f"{state_bytes / 1e9:.3f} GB on the card, built in {init_s:.2f} s; B={B}", flush=True)
    twin = clone_fused_state(ctx.state)
    host = [batch_to_fused(b, ctx.specs, True) for b in train_b]
    cpu_state, cpu_step, cpu_batches, (cgrp, card_grp, rows_of) = compact_fused_twin(
        ctx, host[:FUSED_MODEL_CPU_STEPS], model_fn, lr)
    init_rows = compact_rows(ctx.state, card_grp, rows_of, card=True)
    losses, step_s = [], []
    for i, b in enumerate(train_b):
        t = time.perf_counter()
        losses.append(ctx.train_step(b)["loss"])  # the first step captures the graph
        step_s.append(time.perf_counter() - t)
        if i + 1 == FUSED_MODEL_CPU_STEPS:
            card_rows = compact_rows(ctx.state, card_grp, rows_of, card=True)
    eager = build_fused_train_step(ctx.sparse_cfg, ctx.specs, stack=True, jit=False)
    ops.reset_launch_counts()
    e_losses = []
    for h in host:
        twin, (loss, _) = eager(twin, fused_batch_to_device(h, dev))
        e_losses.append(loss)
    torch.cuda.synchronize()
    launches = launches_now()
    bn = 2 * n if name == "dnn" else 0
    expect_path_launches(f"fused {name} (eager twin)", launches,
                         dict(fused_gather=n, sparse_update=n, batch_norm_fwd=bn, batch_norm_bwd=bn))
    same = same_bits(torch.tensor(losses, dtype=torch.float32), torch.stack(e_losses).cpu()) and all(
        same_bits(a, c) for a, c in zip(fused_state_tensors(ctx.state), fused_state_tensors(twin)))
    del twin
    torch.cuda.empty_cache()
    cpu_losses = [float(cpu_step(cpu_state, fused_batch_to_device(h, "cpu"))[1][0]) for h in cpu_batches]
    loss_err = max(abs(a - c) for a, c in zip(losses, cpu_losses))
    cpu_rows = compact_rows(cpu_state, cgrp, rows_of, card=False)
    row_err = float((card_rows - cpu_rows).abs().max())
    loss_tol, row_tol = FUSED_MODEL_TOL[name]
    ok = same and loss_err <= loss_tol and row_err <= row_tol and np.isfinite(losses).all()
    print(f"  fused {name}: graph steps vs eager twin, {n} steps: losses, tables, states, parameters and batch "
          f"statistics bitwise {'ok' if same else 'FAIL'}; first {FUSED_MODEL_CPU_STEPS} losses card "
          f"{losses[:FUSED_MODEL_CPU_STEPS]} cpu (compact twin, {cpu_rows.shape[0]} rows) {cpu_losses}: "
          f"max_abs_err={loss_err:.3e} tolerance={loss_tol:g}; touched rows max_abs_err={row_err:.3e} tolerance={row_tol:g} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit(f"fused {name}: the graph and eager steps, or card and CPU, disagree")
    # the card's busy time a graph step and the port's kernels a replay
    prof_host = [fused_batch_to_device(batch_to_fused(b, ctx.specs, True), dev) for b in prof_b]
    busy, top, runs = device_busy_ms(lambda b: ctx._step(ctx.state, b), prof_host)
    replays = runs["replays"]
    whole = len(replays) == len(prof_host) and bool(replays[0]["events"]) and all(r == replays[0] for r in replays)
    per_step = {k: runs[k] / len(prof_host) for k in KERNEL_NAMES if runs.get(k)}
    print(f"  fused {name}: a trace of {len(prof_host)} graph steps held device events: {busy is not None}, "
          f"every replay whole: {whole}; card busy {busy} ms a step, the port's kernels a step (device trace) "
          f"{per_step}, largest {top}", flush=True)
    # a checkpoint round trip: dump, one more step, load, the state's bits
    path = str(root / f"fused_{name}")
    t = time.perf_counter()
    ctx.dump_checkpoint(path)
    saved = fused_state_to_flax(ctx.state)[1]
    ctx.train_step(prof_b[0])
    ctx.load_checkpoint(path)
    back = fused_state_to_flax(ctx.state)[1]
    ckpt_ok = len(saved) == len(back) and all(
        a.dtype == b.dtype and np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                                              np.ascontiguousarray(b).view(np.uint8)) for a, b in zip(saved, back))
    ckpt_s = time.perf_counter() - t
    shutil.rmtree(path, ignore_errors=True)
    print(f"  fused {name}: checkpoint round trip ({len(saved)} leaves) bitwise {'ok' if ckpt_ok else 'FAIL'} "
          f"({ckpt_s:.1f} s)", flush=True)
    if not ckpt_ok:
        raise SystemExit(f"fused {name}: the checkpoint did not load back bit for bit")
    steady = sum(step_s[1:])
    out = {"model": name, "batch": B, "steps": n, "tables": len(ctx.specs), "table_rows": int(table.shape[0]),
           "state_bytes": state_bytes, "init_s": init_s, "losses": losses, "samples_per_s": (n - 1) * B / steady,
           "first_step_s": step_s[0], "step_ms_p50": float(np.percentile(step_s[1:], 50) * 1e3),
           "card_busy_ms_per_step": busy, "trace_held_device_events": busy is not None,
           "trace_replays_whole": whole, "card_top_kernels_ms": top, "kernels_per_graph_step": per_step,
           "peak_device_bytes": torch.cuda.max_memory_allocated(), "loss_max_abs_err_vs_cpu": loss_err,
           "row_max_abs_err_vs_cpu": row_err, "graph_equals_eager_steps": n, "checkpoint_round_trip_s": ckpt_s,
           "launches_per_eager_step": {k: v / n for k, v in launches.items() if v}}
    print(f"  fused {name}: {out['samples_per_s']:.1f} samples/s (graph steps after the capture, each with its loss "
          f"read), step p50 {out['step_ms_p50']:.2f} ms, peak device bytes {out['peak_device_bytes']:,}", flush=True)
    del ctx, cpu_state
    gc.collect()
    torch.cuda.empty_cache()
    return launches, out


def path_fused_models(dev):
    """Phase 4o: DeepFM and DCN-v2 through ``testing/avazu.py --tier fused``
    at full width (B=4096, 21 tables, 9,449,205 rows), DNN at phase 4j's
    width with its slots as fused tables."""
    print(f"== phase 4o: DeepFM and DCN-v2 (the Avazu example's --tier fused, B={AVAZU_BATCH}) and DNN (B={BATCH}) "
          f"on the fused tier, {FUSED_MODEL_STEPS} steps each", flush=True)
    root = pathlib.Path(__file__).resolve().parent / "build" / "chip_smoke_state"
    root.mkdir(parents=True, exist_ok=True)
    launches, out = {}, {}
    for name in ("deepfm", "dcnv2", "dnn"):
        t = time.perf_counter()
        la, o = fused_model_leg(dev, name, root)
        o["seconds"] = time.perf_counter() - t
        launches[f"fused_{name} (eager twin of its {FUSED_MODEL_STEPS} graph steps)"], out[name] = la, o
    return launches, out


def prec_ctx(device, store, sd, rows=CACHE_SAT_ROWS, ps_slots=(), wire="int8", touches=2, bf16=True, scaled=True,
             **kw):
    """The cached configuration through ``testing.quality.tier_ctx`` (DLRM at
    bench width from ``sd``, bf16 wires, the touch gate) with, where
    ``bf16``, bf16 pools and, where ``scaled``, the dynamic loss scale from
    2^15."""
    import torch

    from persia_tpu_torch.testing.quality import bench_model, tier_ctx

    opts = dict(table_dtype=torch.bfloat16) if bf16 else {}
    if scaled:
        opts.update(dynamic_loss_scale=True, loss_scale_init=PREC_LS_INIT)
    return tier_ctx(device, store, ps_slots=ps_slots, ps_wire=wire, cache_rows=rows, admit_touches=touches,
                    model=bench_model(state_dict=sd), **opts, **kw)


def prec_sync(dev, device, batches, sd, bf16=True, scaled=True, counted=False):
    """The synchronous steps on ``device`` from a fresh store and ctx:
    (ctx, store, recorder, headers, samples/s); ``counted``: the launch
    counts set to 0 before the first step."""
    import torch

    from persia_tpu_torch import ops

    store = cache_store()
    ctx = prec_ctx(device, store, sd, bf16=bf16, scaled=scaled)
    rec = cache_recorder(ctx)
    if device != "cpu":
        torch.cuda.synchronize()
        if counted:
            ops.reset_launch_counts()
    headers = []
    t0 = time.perf_counter()
    for b in batches:
        ctx.train_step(b, fetch_metrics=False)
        headers.append(ctx._pending[3])
    if device != "cpu":
        torch.cuda.synchronize()
    sps = len(batches) * BATCH / (time.perf_counter() - t0)
    return ctx, store, rec, headers, sps


def run_prec_cache(dev, sd):
    """Phase 4p (cache): the cached configuration at the saturated 2^18
    rows over phase 4k saturated's batches, ``PREC_STEPS`` timed
    synchronous steps a leg from a fresh ctx, in two turns over the four
    legs of ``PREC_LEGS`` (bf16 pools and the loss scale, each alone,
    neither), the second turn reversed; the last leg (both options) is the
    counted one: traced over ``CACHE_PROFILED`` more steps (as is the
    second turn's f32 leg), flushed, then the same batches on the CPU port
    (the directory's decisions, scales and flags equal at every step,
    losses and every entry after flush within ``PREC_TOL``) and the stream
    at the bench's knobs from a fresh ctx (each step's loss, scale and
    flag, the state's bytes and every server entry bit for bit the
    synchronous steps')."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.weights import cached_state_to_flax_bytes

    print(f"== phase 4p (cache): bf16 pools and the dynamic loss scale (from 2^15) at the cached configuration, "
          f"{CACHE_SAT_ROWS} rows, B={BATCH}, phase 4k saturated's {PREC_STEPS} + {CACHE_PROFILED} batches; legs "
          f"(bf16 pools, loss scale) {PREC_LEGS} then reversed", flush=True)
    make = zipf_batch_maker(SEED + 60, labels=True)  # phase 4k saturated's batches
    batches = [make() for _ in range(PREC_STEPS + CACHE_PROFILED)]
    prof, batches = batches[PREC_STEPS:], batches[:PREC_STEPS]
    order = list(PREC_LEGS) + list(reversed(PREC_LEGS))
    legs = {PREC_LEG_NAMES[k]: [] for k in PREC_LEGS}
    traces = {}
    for i, (bf16, scaled) in enumerate(order):
        name, last = PREC_LEG_NAMES[(bf16, scaled)], i == len(order) - 1
        ctx, store, rec, headers, sps = prec_sync(dev, dev, batches, sd, bf16, scaled, counted=last)
        legs[name].append(sps)
        print(f"  leg {i} {name}: {sps:.0f} samples/s", flush=True)
        if last or (i >= len(PREC_LEGS) and not (bf16 or scaled)):
            def profiled(b, ctx=ctx, headers=headers):
                ctx.train_step(b, fetch_metrics=False)
                headers.append(ctx._pending[3])

            busy, top, _ = device_busy_ms(profiled, prof)
            traces[name] = {"card_busy_ms_per_step": busy, "trace_held_device_events": busy is not None,
                            "card_top_kernels_ms": top}
            print(f"  {name}: a trace of {len(prof)} steps held device events: {busy is not None}; card busy {busy} "
                  f"ms a step, largest {top}", flush=True)
        if not last:
            del ctx, store
            torch.cuda.empty_cache()
    mean = {k: float(np.mean(v)) for k, v in legs.items()}
    ratios = {k: v / mean["f32_pools"] for k, v in mean.items()}
    print(f"  samples/s by leg {legs}; the mean of each over f32_pools "
          f"{ {k: round(v, 3) for k, v in ratios.items()} }", flush=True)
    headers = [h.cpu() for h in headers]
    steps = [(float(h[0]), float(h[1]), bool(h[2] > 0.5)) for h in headers]
    evictions = sum(s["evictions"] for s in rec)
    batches = batches + prof  # the traced steps trained too: the twins below take the same batches
    ctx.flush()
    torch.cuda.synchronize()
    launches = launches_now()
    n, touched = len(batches), sum(s["touched"] for s in rec)
    expect_launches("cache (bf16 pools, loss scale)", launches, cached_gather=n, cache_aux=touched, sparse_update=n,
                    dot_interaction=n, dot_interaction_bwd=n, gather_entry_rows=1)
    state_bytes = cached_state_to_flax_bytes(ctx.state)
    pool_dtype = ctx.state.tables["cache_d16"].dtype
    signs = batch_keys(batches)
    warm, vals = store.probe_entries(signs, EMB_DIM)
    warm = warm.astype(bool)  # a cold row's values are left unwritten
    tail = sum(s["evictions"] > 0 for s in rec[PREC_STEPS - CACHE_SAT_TAIL:PREC_STEPS])
    print(f"  bf16 pools + loss scale (the counted leg): {evictions} evictions, {tail} of the last {CACHE_SAT_TAIL} "
          f"timed steps evicting; "
          f"(loss, scale, finite) of the first steps {steps[:3]}; pool dtype {pool_dtype}", flush=True)
    cpu, cpu_store, crec, cpu_headers, _ = prec_sync(dev, "cpu", batches, sd)
    cpu.flush()
    same = [a["decisions"] == b["decisions"] for a, b in zip(rec, crec)]
    loss_err = max(abs(float(a[0]) - float(b[0])) for a, b in zip(headers, cpu_headers))
    flags_same = all(float(a[1]) == float(b[1]) and float(a[2]) == float(b[2]) for a, b in zip(headers, cpu_headers))
    cwarm, cvals = cpu_store.probe_entries(signs, EMB_DIM)
    cwarm = cwarm.astype(bool)
    row_err = float(np.abs(vals[warm] - cvals[cwarm]).max()) if np.array_equal(warm, cwarm) else float("inf")
    loss_tol, row_tol = PREC_TOL
    ok = (all(same) and len(rec) == len(crec) and flags_same and loss_err <= loss_tol and row_err <= row_tol
          and tail == CACHE_SAT_TAIL)
    print(f"  vs the CPU port: decisions equal at every one of {len(rec)} steps {all(same)}; scales and flags equal "
          f"{flags_same}; losses max_abs_err={loss_err:.3e} tolerance={loss_tol:g}; entries after flush ({int(warm.sum())} "
          f"of the batches' {len(signs)} signs) max_abs_err={row_err:.3e} tolerance={row_tol:g} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("cache (bf16 pools, loss scale): card and CPU disagree, or the last timed steps did not all "
                         "evict")
    del cpu, cpu_store
    s_store = cache_store()
    sctx = prec_ctx(dev, s_store, sd)
    srec = cache_recorder(sctx)
    seen = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    sctx.train_stream(batches, **dict(STREAM_KNOBS, fetch_final=True), on_metrics=seen.append)
    torch.cuda.synchronize()
    stream_sps = len(batches) * BATCH / (time.perf_counter() - t0)
    stream_launches = launches_now()
    sctx.flush()
    swarm, svals = s_store.probe_entries(signs, EMB_DIM)
    swarm = swarm.astype(bool)
    stream_steps = [(m["loss"], m["loss_scale"], m["grads_finite"]) for m in seen]
    bits = (cached_state_to_flax_bytes(sctx.state) == state_bytes and np.array_equal(swarm, warm)
            and np.array_equal(svals[swarm].view(np.uint32), vals[warm].view(np.uint32)))
    dec = all(a["decisions"] == b["decisions"] for a, b in zip(rec, srec))
    ok = bits and dec and stream_steps == steps and len(seen) == len(batches)
    print(f"  the stream ({STREAM_KNOBS}): {stream_sps:.0f} samples/s; decisions the synchronous steps' {dec}; each "
          f"step's (loss, scale, finite) and the state's bytes and every entry after flush bitwise the synchronous "
          f"steps' {'ok' if ok else 'FAIL'}; restored rows {sctx.stream_stats()['restored_rows']}", flush=True)
    if not ok:
        raise SystemExit("cache (bf16 pools, loss scale): the stream's bits are not the synchronous steps'")
    record = {"cache_rows": CACHE_SAT_ROWS, "batch": BATCH, "steps": PREC_STEPS, "profiled_steps": CACHE_PROFILED,
              "legs": [PREC_LEG_NAMES[k] for k in order], "samples_per_s": legs, "samples_per_s_mean": mean,
              "over_f32_pools": ratios, "stream_samples_per_s": stream_sps, "evictions": evictions,
              "evicting_of_last_timed_steps": [tail, CACHE_SAT_TAIL], "traces": traces, "steps_loss_scale_finite": steps,
              "loss_max_abs_err_vs_cpu": loss_err, "entry_max_abs_err_vs_cpu": row_err, "launches": launches,
              "stream_launches": stream_launches, "stream_restored_rows": sctx.stream_stats()["restored_rows"]}
    del ctx, sctx
    return {"cache_bf16_ls": launches, "cache_bf16_ls_stream": stream_launches}, record


def run_prec_ps(dev, sd):
    """Phase 4p (ps-stream): every slot on the PS tier, int8 wire, under the
    loss scale: ``PREC_PS_STEPS`` steps through the stream (counted: K15
    once a step), every ref released, finite losses; K15's inputs at its
    last step for phase 5."""
    import torch

    from persia_tpu_torch import ops
    from persia_tpu_torch.embedding.hbm_cache import step as step_mod

    print(f"== phase 4p (ps-stream): all {N_SLOTS} slots on the PS (int8) under the loss scale, "
          f"{PREC_PS_STEPS} steps", flush=True)
    make = zipf_batch_maker(SEED + 91, labels=True)
    batches = [make() for _ in range(PREC_PS_STEPS)]
    store = cache_store()
    ctx = prec_ctx(dev, store, sd, rows=8, ps_slots=PS_ALL, wire="int8")
    k15 = {}
    inner = step_mod.quantize_int8_ef
    seen = []
    torch.cuda.synchronize()
    ops.reset_launch_counts()

    def keep(g, res, offsets, inv=None, finite=None):
        k15.update(g=g.clone(), res=res.clone(), offsets=list(offsets), inv=inv.clone(), finite=finite.clone())
        return inner(g, res, offsets, inv, finite)

    step_mod.quantize_int8_ef = keep
    try:
        t0 = time.perf_counter()
        ctx.train_stream(batches, **dict(PS_STREAM_KNOBS, fetch_final=True), on_metrics=seen.append)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        step_mod.quantize_int8_ef = inner
    launches = launches_now()
    refs_released(ctx, "ps-stream under the loss scale")
    expect_launches("ps-stream under the loss scale", launches, quantize_int8_ef=PREC_PS_STEPS,
                    gather_pool_fwd=PREC_PS_STEPS, gather_pool_bwd=PREC_PS_STEPS, dot_interaction=PREC_PS_STEPS,
                    dot_interaction_bwd=PREC_PS_STEPS)
    losses = [m["loss"] for m in seen]
    flags = [m["grads_finite"] for m in seen]
    ok = len(seen) == PREC_PS_STEPS and np.isfinite(losses).all() and flags[-1]
    print(f"  {PREC_PS_STEPS * BATCH / wall:.0f} samples/s; losses {np.round(losses, 5).tolist()}; scales "
          f"{sorted({m['loss_scale'] for m in seen})}; finite steps {sum(flags)} of {len(flags)} {'ok' if ok else 'FAIL'}",
          flush=True)
    if not ok:
        raise SystemExit("ps-stream under the loss scale: a step is missing, a loss is not finite or the last "
                         "step overflowed")
    record = {"steps": PREC_PS_STEPS, "samples_per_s": PREC_PS_STEPS * BATCH / wall, "losses": losses,
              "launches": launches}
    del ctx
    return {"ps_stream_ls": launches}, record, k15


def run_prec_overflow(dev, sd):
    """Phase 4p (overflow): the mixed configuration (cat_0-cat_12 cached in
    bf16 pools, cat_13-cat_25 on the PS, int8), the loss scale at 2^15
    (its ceiling 3e38), every sign admitted at its first touch, dense
    features x1e4 (``tests/test_loss_scale.py`` scales them x100 for
    DNN; the bench's DLRM needs more for its gradients to pass 1):
    ``PREC_OVERFLOW_STEPS`` finite steps (K15's residual non-zero), then
    the scale set to 3e38 and the last batch again, every sign resident:
    nothing admitted or evicted, no pool row or its state, dense parameter
    or Adam moment, PS-tier row or K15 residual moves, the scale halves."""
    import torch

    print("== phase 4p (overflow): a forced overflow on the mixed configuration with nothing to admit", flush=True)
    make = zipf_batch_maker(SEED + 92, labels=True, dense_scale=OVERFLOW_DENSE_SCALE)
    batches = [make() for _ in range(PREC_OVERFLOW_STEPS)]
    store = cache_store()
    ctx = prec_ctx(dev, store, sd, rows=CACHE_SAT_ROWS, ps_slots=MIXED_PS, wire="int8", touches=1,
                   loss_scale_max=HUGE_SCALE)
    for b in batches:
        if not ctx.train_step(b)["grads_finite"]:
            raise SystemExit("overflow leg: a warm-up step overflowed")

    def snapshot():
        dense = [p.detach().clone() for p in ctx.model.parameters()]
        for st in ctx.dense_optimizer.state.values():
            dense.extend(v.clone() for v in st.values() if torch.is_tensor(v))
        pools = [t.clone() for t in ctx.state.tables.values()]
        pools += [v.clone() for st in ctx.state.emb_state.values() for v in st.values()]
        res = [v.clone() for v in ctx._ps_residual.values()]
        return dense, pools, res

    ctx.drain()
    ps_signs = batch_keys([batches[-1]])
    ps_warm, ps_vals = store.probe_entries(ps_signs, EMB_DIM)
    ps_warm = ps_warm.astype(bool)  # a cold row's values are left unwritten
    before = snapshot()
    counts = ctx.tier.counts()
    ctx.state.loss_scale.scale.fill_(HUGE_SCALE)
    m = ctx.train_step(batches[-1])
    ctx.drain()
    after = snapshot()
    moved = ctx.tier.counts()
    admitted = {k: moved[k] - counts[k] for k in ("misses", "evictions")}
    warm2, vals2 = store.probe_entries(ps_signs, EMB_DIM)
    warm2 = warm2.astype(bool)
    same = {what: all(bits_equal(a, b) for a, b in zip(x, y))
            for what, x, y in zip(("dense", "pools", "residual"), before, after)}
    same["ps_rows"] = (np.array_equal(ps_warm, warm2) and bool(ps_warm.any())
                       and np.array_equal(ps_vals[ps_warm].view(np.uint32), vals2[warm2].view(np.uint32)))
    halved = float(ctx.state.loss_scale.scale) == float(np.float32(HUGE_SCALE) * np.float32(0.5))
    nonzero_res = all(bool(v.abs().sum() > 0) for v in before[2]) and bool(before[2])
    ok = (not m["grads_finite"] and m["loss_scale"] == HUGE_SCALE and all(same.values()) and halved and nonzero_res
          and not any(admitted.values()))
    print(f"  the overflow step: grads_finite {m['grads_finite']}, scale used {m['loss_scale']:.4g}, then "
          f"{float(ctx.state.loss_scale.scale):.4g} (halved: {halved}); misses and evictions {admitted}; unchanged "
          f"bit for bit: {same} (K15's residual non-zero before: {nonzero_res}) {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SystemExit("the forced overflow moved state, admitted rows or did not back the scale off")
    refs_released(ctx, "overflow leg")
    record = {"unchanged": same, "scale_halved": halved, "admitted": admitted, "residual_nonzero": nonzero_res}
    del ctx
    return record


def path_precision(dev):
    """Phase 4p: the cache tier's bf16 pools and dynamic loss scale."""
    from persia_tpu_torch.testing.quality import bench_model
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    model = bench_model()
    sd = state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    launches, record = run_prec_cache(dev, sd)
    ps_launches, ps_record, k15 = run_prec_ps(dev, sd)
    record["ps_stream"] = ps_record
    record["overflow"] = run_prec_overflow(dev, sd)
    launches.update(ps_launches)
    return launches, record, k15


def time_precision_kernels(dev, launches, errs, inputs, k15, floor):
    """Phase 5's rows of the new variants. K12, its read and K13 on a bf16
    pool at the f32 rows' own inputs (``time_cache_kernels``': phase 4k
    saturated's last step's pieces, pairing and rows, its pool with the
    table rounded to bf16, its flush's rows), graph-replayed warm and cold
    (copies of the pool rotated through more than the L2), in turns with
    the f32 pool's call at the same inputs (f32, bf16, bf16, f32); K15
    under the loss scale at phase 4p's ps-stream's last step, warm and
    cold, in turns with the ungated call. Each beside its plain version, a
    library call and the bound."""
    import torch
    import torch.nn.functional as F

    from persia_tpu_torch import ops
    from persia_tpu_torch.ops.cache_aux import cache_aux_reference, gather_entry_rows_reference
    from persia_tpu_torch.ops.cached_gather import cached_gather_reference
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef_reference

    f32, state, consts = inputs["table"], inputs["state"], inputs["consts"]
    table = f32.to(torch.bfloat16)
    miss, cold, ev = inputs["aux"]
    C, dim = table.shape[0] - 1, table.shape[1]
    acc = state["acc"]
    E = dim + acc.shape[1]
    ev_rows, ev_free = ev["cache_d16"]
    m_rows, m_ent, m_slot = miss["cache_d16"]
    c_rows, c_emb, c_slot = cold["cache_d16"]
    pairing = dict(m_slot=m_slot, c_slot=c_slot, ev_free=ev_free)
    aux_args = (ev_rows, m_rows, m_ent, c_rows, c_emb, consts, True)
    n_ev, n_w, n_c = (int((r < lim).sum()) for r, lim in ((ev_rows, C), (m_rows, C + 1), (c_rows, C + 1)))
    esz = m_ent.element_size()
    rows = []

    def row(base, path, **kw):
        name = PREC_NAMES[base]
        return dict(name=name, route="cuda", cuda_route="cuda",
                    source=K15_SOURCE if base == "quantize_int8_ef" else CACHE_SOURCE[base],
                    replaces=K15_REPLACES if base == "quantize_int8_ef" else CACHE_REPLACES[base],
                    launches=launches[path][base], launches_by_path={p: launches[p][base] for p in launches
                                                                      if launches[p].get(base)},
                    max_abs_err=errs[name], **kw)

    def timed(r, kernel, beside, make_copy, make_beside, nbytes, beside_bytes, plain, library, lib_copy, lib_bytes):
        """warm and cold of ``kernel`` and of the f32 (ungated) call
        ``beside`` in turns: beside, kernel, kernel, beside."""
        def both(fn, copy, n):
            return graph_ms(fn[0]), cold_ms(fn[1], copy, n)["ms"]

        b0 = both(beside, make_beside, beside_bytes)
        k0, k1 = both(kernel, make_copy, nbytes), both(kernel, make_copy, nbytes)
        b1 = both(beside, make_beside, beside_bytes)
        p = timings(plain)
        lib = timings(library[0]) if library is not None else {"graph": None, "eager": None}
        r.update(ms=min(k0[0], k1[0]), ms_runs=[k0[0], k1[0]], cold_ms=min(k0[1], k1[1]), cold_ms_runs=[k0[1], k1[1]],
                 plain_ms=p["graph"], plain_eager_ms=p["eager"], library_ms=lib["graph"],
                 library_eager_ms=lib["eager"],
                 library_cold_ms=cold_ms(library[1], lib_copy, lib_bytes)["ms"] if library is not None else None,
                 beside_ms_runs=[b0[0], b1[0]], beside_cold_ms_runs=[b0[1], b1[1]])
        r["over_launch_floor"] = r["ms"] / min(floor)
        r["cold_share"] = r["bound_ms"] / r["cold_ms"]
        return r

    def pool_of(t):
        return lambda: (t.clone(), {k: v.clone() for k, v in state.items()})

    bf_bytes = table.numel() * 2 + acc.numel() * 4
    f32_bytes = (f32.numel() + acc.numel()) * 4
    # K12: the table's columns 2 bytes a value read and written
    pool, f32_pool = pool_of(table)(), pool_of(f32)()
    tb = table.element_size()
    nbytes = (4 * (ev_rows.numel() + m_rows.numel() + c_rows.numel() + m_slot.numel() + c_slot.numel()
                   + ev_free.numel()) + n_ev * (dim * tb + (E - dim) * 4 + E * 2)
              + n_w * (E * esz + dim * tb + (E - dim) * 4) + n_c * (dim * esz + dim * tb + (E - dim) * 4))
    bms, by = bound(nbytes, 0, "float32")
    ev_live, m_live, c_live = ev_rows[:n_ev].long(), m_rows[:n_w].long(), c_rows[:n_c].long()

    def aux_library(t, s):
        payload = torch.cat([t.index_select(0, ev_live).float(), s["acc"].index_select(0, ev_live)], 1).to(
            torch.bfloat16)
        t.index_copy_(0, m_live, m_ent[:n_w, :dim].to(t.dtype))
        s["acc"].index_copy_(0, m_live, m_ent[:n_w, dim:].float())
        t.index_copy_(0, c_live, c_emb[:n_c].to(t.dtype))
        s["acc"].index_fill_(0, c_live, consts[0][1])
        return payload

    aux = lambda t, s: ops.cache_aux(t, s, *aux_args, **pairing)  # noqa: E731
    rows.append(timed(row("cache_aux", "cache_bf16_ls", shape=[C + 1, dim, n_ev, n_w, n_c],
                          dtype="bf16 pool, bf16 wires", bound_ms=bms, bound_by=by,
                          library_note="index_select + cat + index_copy_ (+ index_fill_), live rows"),
                      kernel=(lambda: aux(*pool), aux), beside=(lambda: aux(*f32_pool), aux),
                      make_copy=pool_of(table), make_beside=pool_of(f32), nbytes=bf_bytes, beside_bytes=f32_bytes,
                      plain=lambda: cache_aux_reference(*pool, *aux_args, **pairing),
                      library=(lambda: aux_library(*pool), aux_library), lib_copy=pool_of(table), lib_bytes=bf_bytes))
    # its read alone: the flush's rows
    fr = inputs["flush_rows"]
    fpad = np.zeros(1 << max(3, int(len(fr) - 1).bit_length()), np.int32)
    fpad[:len(fr)] = fr
    frows = torch.from_numpy(fpad).to(dev)
    nbytes = 4 * frows.numel() + frows.numel() * (dim * tb + (E - dim) * 4) + frows.numel() * E * 4
    bms, by = bound(nbytes, 0, "float32")
    read = lambda t, s: ops.gather_entry_rows(t, s, frows)  # noqa: E731
    read_lib = lambda t, s: torch.cat([t.index_select(0, frows).float(), s["acc"].index_select(0, frows)], 1)  # noqa
    rows.append(timed(row("gather_entry_rows", "cache_bf16_ls", shape=[C + 1, E, frows.numel()],
                          dtype="bf16 pool", bound_ms=bms, bound_by=by, library_note="index_select + cat"),
                      kernel=(lambda: read(table, state), read), beside=(lambda: read(f32, state), read),
                      make_copy=pool_of(table), make_beside=pool_of(f32), nbytes=bf_bytes, beside_bytes=f32_bytes,
                      plain=lambda: gather_entry_rows_reference(table, state, frows),
                      library=(lambda: read_lib(table, state), read_lib), lib_copy=pool_of(table),
                      lib_bytes=bf_bytes))
    # K13: the step's (26, 4096, 1) rows, with their keys
    srows = inputs["rows"]
    S, B, L = srows.shape
    live = int((srows != C).sum())
    nbytes = 4 * srows.numel() + live * dim * tb + S * B * dim * 4 + 4 * srows.numel()
    bms, by = bound(nbytes, live * dim, "float32")
    gather = lambda t, rr: ops.cached_gather(t, rr, True, keys=True)  # noqa: E731
    bag = lambda t, rr: F.embedding_bag(rr.view(S * B, L), t, mode="sum", padding_idx=C)  # noqa: E731
    rows.append(timed(row("cached_gather", "cache_bf16_ls", shape=[S, B, L, C + 1, dim], dtype="bf16 pool",
                          bound_ms=bms, bound_by=by,
                          library_note="F.embedding_bag(mode='sum', padding_idx=C) on the bf16 table (its "
                                       "output bf16)"),
                      kernel=(lambda: gather(table, srows), gather), beside=(lambda: gather(f32, srows), gather),
                      make_copy=lambda: (table.clone(), srows.clone()),
                      make_beside=lambda: (f32.clone(), srows.clone()), nbytes=table.numel() * 2,
                      beside_bytes=f32.numel() * 4, plain=lambda: cached_gather_reference(table, srows, True, keys=True),
                      library=(lambda: bag(table, srows), bag), lib_copy=lambda: (table.clone(), srows.clone()),
                      lib_bytes=table.numel() * 2))
    # K15 under the gate at the ps-stream's last step
    g, res0, offsets, inv, fin = k15["g"], k15["res"], k15["offsets"], k15["inv"], k15["finite"]
    n, segments = g.numel(), len(offsets) - 1
    res = res0.clone()
    nbytes = n * (g.element_size() + 4 + 1 + 4) + 8 + 4 * (segments + 2)
    bms, by = bound(nbytes, 7 * n, "float32")
    gated = lambda gg, rr: ops.quantize_int8_ef(gg, rr, offsets, inv, fin)  # noqa: E731
    ungated = lambda gg, rr: ops.quantize_int8_ef(gg, rr, offsets)  # noqa: E731
    k15_copy = lambda: (g.clone(), res.clone())  # noqa: E731
    rows.append(timed(row("quantize_int8_ef", "ps_stream_ls", shape=[segments, n // segments, str(g.dtype)[6:]],
                          dtype="gradients unscaled by inv, gated by finite", bound_ms=bms, bound_by=by,
                          library_note="no single PyTorch call computes it"),
                      kernel=(lambda: gated(g, res), gated), beside=(lambda: ungated(g, res), ungated),
                      make_copy=k15_copy, make_beside=k15_copy, nbytes=n * (g.element_size() + 4),
                      beside_bytes=n * (g.element_size() + 4),
                      plain=lambda: quantize_int8_ef_reference(g, res, offsets, inv, fin), library=None, lib_copy=None,
                      lib_bytes=0))
    for r in rows:
        beside = "the f32 pool's" if r["name"] != PREC_NAMES["quantize_int8_ef"] else "the ungated"
        r["f32_pool_same_inputs_ms" if "pool" in beside else "ungated_same_inputs_ms"] = min(r["beside_ms_runs"])
        r["f32_pool_same_inputs_cold_ms" if "pool" in beside else "ungated_same_inputs_cold_ms"] = min(
            r["beside_cold_ms_runs"])
        print(f"  {r['name']}: warm {r['ms_runs']} ms, cold {r['cold_ms_runs']}; {beside} call at the same inputs in "
              f"turns: warm {r['beside_ms_runs']}, cold {r['beside_cold_ms_runs']}; plain {r['plain_ms']:.4f}, library "
              f"{r['library_ms']} (cold {r['library_cold_ms']}), bound {r['bound_ms']:.5f} ms ({r['bound_by']}; "
              f"{r['cold_share']:.1%} cold, {r['bound_ms'] / r['ms']:.1%} warm), {r['over_launch_floor']:.2f}x the "
              f"launch floor; launches {r['launches_by_path']}", flush=True)
    return rows


# ---------------------------------------------------------------------------
# The cache tier's sharded feeder (phase 4q) and the hybrid tier's dense sync
# modes (phases 3h, 4r and the rows of "5 (dense sync)")

FEED_THREADS, FEED_SHARDS, FEED_STEPS = 4, 8, 56
SYNC_SOURCE = "persia_tpu_torch/csrc/block_int8.cu"
SYNC_REPLACES = {"block_quantize_int8": "persia_tpu/parallel/grad_sync.py:312",
                 "block_dequantize_int8": "persia_tpu/parallel/grad_sync.py:327",
                 "block_requantize_int8": "persia_tpu/parallel/grad_sync.py:381",
                 "segment_absmax": "persia_tpu/parallel/grad_sync.py:291",
                 "quantize_int8_ef_shared": "persia_tpu/parallel/grad_sync.py:294"}
SYNC_KERNELS = tuple(SYNC_REPLACES)
SYNC_BLOCK, SYNC_STEPS = 256, 3
# phase 3h's other block sizes: K16's and the fused hop's block plan, K17's
# vector (48) and scalar (100) plans
SYNC_ODD_BLOCKS = (48, 100)
# phase 4r's DLRM: bench width (13 dense, 26 slots of dim 16, bottom 256-64-16,
# top 512-256, B=4096) in f32, over the synthetic click data of 26
# vocabularies of 100,000; Adam(1e-3); the servers two native stores (the
# numpy golden model takes ~75 s a step at this width)
SYNC_SPEC = dict(dense=N_DENSE, vocabs=(100_000,) * N_SLOTS, dim=EMB_DIM, bottom=BOTTOM, top=TOP, bsz=BATCH,
                 lr=1e-3, params_seed=SEED, compute="float32", store="native", entries=False)
TWO_RANK_MODES = ("block-int8-ring", "f32-sharded", "block-int8-ring-sharded")
TWO_RANK_DEVICE = "cuda:0"  # both ranks on the one card
# phase 4r's ring-only leg: the ring all-reduce of the bench tower's padded
# flat gradient on RING_RANKS gloo ranks on the one card, held to the same
# ranks on the CPU; a rank launches 1 K16, RING_RANKS - 1 fused hops, 1 K17
RING_RANKS = 4
# phase 4s: the divergent-replica algorithms on build_sync_train_step at
# SYNC_SPEC, 3 steps each (QAdam's warmup one step, so that steps 2-3 run
# the int8 momentum), at world size 1 over NCCL and at two gloo ranks on
# the one card; a rank's sync kernels a step (after QAdam's warmup)
LP_SOURCE = "persia_tpu_torch/csrc/lp_ring.cu"
LP_REPLACES = "persia_tpu/parallel/grad_sync.py:445"
DIVERGENT_CASES = {
    "decentralized": ("decentralized", {"period": 1}, {}),
    "local_sgd": ("local_sgd", {"period": 2}, {}),
    "lp": ("lp", {"period": 1}, {"quantize_int8_ef": 1, "lp_ring_mix": 1}),
    "qadam": ("qadam", {"lr": 1e-3, "warmup_steps": 1}, {"segment_absmax": 1, "quantize_int8_ef_shared": 1}),
}
DIVERGENT_KERNELS = ("quantize_int8_ef", "lp_ring_mix", "segment_absmax", "quantize_int8_ef_shared")
# QAdam after its warmup, card vs CPU: v froze at the warmup step's squared
# gradient, and an update is lr * (m / bc1) / (sqrt(v / bc2) + eps). An int8
# code of m that flips at a rounding midpoint between the two (their
# gradients differ by ulps) moves m by a code step of its leaf (its scale /
# 127), which an element with a small frozen v scales up (v = 0: by lr /
# eps; 3.7 on one element at bench width, on the card). So each element is
# held to SYNC_PARAM_ATOL plus QADAM_FLIPS code steps' worth of movement a
# step after the warmup, lr / bc1 * (max |m| of its leaf / 127) /
# (sqrt(v / bc2) + eps) each (the leaf's max |m| stands for its scale,
# which it equals at one rank and may be under at two); every element
# after the warmup step at SYNC_PARAM_ATOL, the losses at SYNC_LOSS_RTOL.
QADAM_FLIPS = 4
PREPARED_MODES = ("f32", "block-int8-ring")
# card vs CPU: losses 1e-3 relative; parameters 6e-3 (Adam's steps are
# +-lr whatever a gradient's size, so an int8 code or a bf16 rounding a
# last bit moves flips a near-zero gradient and moves its parameter by
# 2 lr a step, 3 steps)
SYNC_LOSS_RTOL, SYNC_PARAM_ATOL = 1e-3, 6e-3


def sync_leaf_sizes():
    """The bench DLRM tower's leaves' sizes in the flat vector's order."""
    import torch

    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.parallel import grad_sync

    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, compute_dtype=torch.float32, device="cpu")
    return [p.numel() for _path, p, _tr in grad_sync.dense_leaves(model)]


def sync_inputs(dev):
    """The kernels' inputs at the dense ring's shapes on the bench tower:
    the whole padded vector (n = 1), one rank's chunk at n = 4 (a ring
    hop's), the n = 4 all-gather's rows, and the tower's leaves (K15 at a
    shared scale)."""
    import torch

    from persia_tpu_torch.parallel import grad_sync

    sizes = sync_leaf_sizes()
    p = sum(sizes)
    _chunk1, ppad1 = grad_sync._flat_chunk(p, 1, SYNC_BLOCK)
    chunk4, _ = grad_sync._flat_chunk(p, 4, SYNC_BLOCK)
    gen = torch.Generator().manual_seed(SEED + 95)

    def vec(n, scale=1.0):
        return (torch.randn(n, generator=gen) * scale).to(dev)

    g1 = torch.zeros(ppad1, device=dev)
    g1[:p] = vec(p, 1e-2)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
    return {"p": p, "sizes": sizes, "offsets": offsets, "ppad1": ppad1, "chunk4": chunk4,
            "g1": g1, "ef1": vec(ppad1, 1e-5), "g4": vec(chunk4, 4e-2), "ef4": vec(chunk4, 1e-5),
            "base4": vec(chunk4, 4e-2), "rows4": vec(4 * chunk4, 4e-2), "flat": vec(p, 1e-2),
            "res": vec(p, 1e-5)}


def phase_sync_kernels(dev):
    """Phase 3h: the dense sync's kernels against their plain versions on
    the card, bit for bit, at the bench tower's ring shapes: K16
    (``block_quantize_int8``, the warp plan) on the whole padded vector and
    on a rank's chunk at n = 4, each with and without the error feedback;
    K17 (``block_dequantize_int8``, the vector plan) as a hop's accumulate
    into the chunk (with and without the feedback, in place), as the
    all-gather's 4 rows rolled into chunk order and as the one row at n =
    1; the fused hop (``block_requantize_int8``) at the chunk and on the
    whole vector, with and without the feedback and the sum written back;
    each of the three at ``SYNC_ODD_BLOCKS`` (the block and scalar plans);
    K15's scales (``segment_absmax``) and its codes at a shared scale
    (``quantize_int8_ef_shared``) over the tower's leaves, the residual in
    place; then ``flat_mode_cases``."""
    import torch

    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.block_int8 import (
        block_dequantize_int8,
        block_dequantize_int8_reference,
        block_quantize_int8,
        block_quantize_int8_reference,
        block_requantize_int8,
        block_requantize_int8_reference,
    )
    from persia_tpu_torch.ops.quantize_int8 import (
        quantize_int8_ef_reference,
        quantize_int8_ef_shared,
        segment_absmax,
        segment_absmax_reference,
    )

    print("== phase 3h: the dense sync's kernels (K16, K17, the fused hop, K15 at a shared scale) vs their plain "
          "versions", flush=True)
    x = sync_inputs(dev)
    bad = []
    f32_bits = lambda t: t.view(torch.int32)  # noqa: E731

    def check(name, same):
        print(f"  {name}: bitwise {'ok' if same else 'FAIL'}", flush=True)
        if not same:
            bad.append(name)

    def quantize_cases(bs, cases):
        for name, v, ef in cases:
            q, sc, err = block_quantize_int8(v, bs, ef=ef)
            q2, sc2, err2 = block_quantize_int8_reference(v, bs, ef)
            check(f"block_quantize_int8 {name} ({v.numel()} elements, bs {bs}, plan "
                  f"{plans.block_int8_plan(bs, v.numel() // bs)})",
                  bits_equal(q, q2) and bits_equal(sc, sc2) and bits_equal(f32_bits(err), f32_bits(err2)))

    def dequantize_cases(bs, cases):
        for name, q, sc, n, roll, base, ef in cases:
            want = block_dequantize_int8_reference(q, sc, bs, n, roll, base, ef)
            acc = None if base is None else base.clone()
            got = block_dequantize_int8(q, sc, bs, n=n, roll=roll, base=acc, ef=ef, out=acc)
            check(f"block_dequantize_int8 {name} ({q.numel()} elements, bs {bs}, plan "
                  f"{plans.block_dequant_plan(bs, q.numel())})", bits_equal(f32_bits(got), f32_bits(want)))

    def requantize_cases(bs, cases):
        for name, q_in, sc_in, base, ef, write_acc in cases:
            q2, sc2, err2, x2 = block_requantize_int8_reference(q_in, sc_in, base, ef, bs)
            acc = base.clone()
            q, sc, err = block_requantize_int8(q_in, sc_in, acc, ef, bs, write_acc=write_acc)
            same = bits_equal(q, q2) and bits_equal(sc, sc2) and bits_equal(f32_bits(err), f32_bits(err2))
            written = ", sum written" if write_acc else ""
            check(f"block_requantize_int8 {name} ({q_in.numel()} elements, bs {bs}{written})",
                  same and bits_equal(f32_bits(acc), f32_bits(x2 if write_acc else base)))

    chunk = x["chunk4"]
    quantize_cases(SYNC_BLOCK, (("whole vector, feedback", x["g1"], x["ef1"]), ("whole vector", x["g1"], None),
                                ("n=4 chunk, feedback", x["g4"], x["ef4"]), ("n=4 chunk", x["g4"], None)))
    q4, s4, _ = block_quantize_int8(x["rows4"], SYNC_BLOCK)
    q1, s1, _ = block_quantize_int8(x["g1"], SYNC_BLOCK)
    hop_q, hop_s = q4[:chunk], s4[:chunk // SYNC_BLOCK]
    dequantize_cases(SYNC_BLOCK, (("hop accumulate, feedback", hop_q, hop_s, 1, 0, x["base4"], x["ef4"]),
                                  ("hop accumulate", hop_q, hop_s, 1, 0, x["base4"], None),
                                  ("all-gather, 4 rows", q4, s4, 4, 1, None, None),
                                  ("n=1 row", q1, s1, 1, 0, None, None)))
    requantize_cases(SYNC_BLOCK, (("n=4 hop, feedback", hop_q, hop_s, x["base4"], x["ef4"], False),
                                  ("n=4 hop", hop_q, hop_s, x["base4"], None, False),
                                  ("n=4 hop, feedback", hop_q, hop_s, x["base4"], x["ef4"], True),
                                  ("whole vector, feedback", q1, s1, x["g1"], x["ef1"], False)))
    gen = torch.Generator().manual_seed(SEED + 96)
    for bs in SYNC_ODD_BLOCKS:  # the block plan (K16, the fused hop); K17's scalar plan at 100
        n_el = 4 * 96 * bs
        v, ef, base = ((torch.randn(n_el, generator=gen) * scale).to(dev) for scale in (4e-2, 1e-5, 4e-2))
        quantize_cases(bs, (("odd block, feedback", v, ef), ("odd block", v, None)))
        q, sc, _ = block_quantize_int8(v, bs)
        part = n_el // 4
        dequantize_cases(bs, (("odd block, all-gather 4 rows", q, sc, 4, 1, None, None),
                              ("odd block, hop accumulate, feedback", q[:part], sc[:part // bs], 1, 0, base[:part],
                               ef[:part])))
        requantize_cases(bs, (("odd block, feedback", q, sc, base, ef, True), ("odd block", q, sc, base, None, False)))
    offs = x["offsets"]
    scale = segment_absmax(x["flat"], x["res"], offs)
    same_s = bits_equal(scale, segment_absmax_reference(x["flat"], x["res"], offs))
    plain = x["res"].clone()
    q, sc, new = quantize_int8_ef_shared(x["flat"], x["res"].clone(), offs, scale)
    q2, sc2, new2 = quantize_int8_ef_reference(x["flat"], plain, offs, scale=scale)
    same_q = (q.dtype == torch.int32 and bits_equal(q, q2.to(torch.int32)) and bits_equal(sc, sc2)
              and bits_equal(new.view(torch.int32), new2.view(torch.int32)))
    print(f"  segment_absmax over the tower's {len(offs) - 1} leaves ({x['p']} elements): bitwise "
          f"{'ok' if same_s else 'FAIL'}; quantize_int8_ef_shared at those scales: codes, scales, residual bitwise "
          f"{'ok' if same_q else 'FAIL'}", flush=True)
    if not same_s:
        bad.append("segment_absmax")
    if not same_q:
        bad.append("quantize_int8_ef_shared")
    bad += flat_mode_cases(dev)
    bad += absmax_graph_cases(dev)
    if bad:
        raise SystemExit(f"the dense sync's kernels disagree with their plain versions: {bad}")
    return {k: 0.0 for k in SYNC_KERNELS}


# phase 3h's cases of K15's flat dense-sync modes (segment_absmax and the
# shared-scale quantize): the tower's leaves in the flat vector's order and
# by layer; 512 segments; empty and 1-element segments; boundaries inside a
# unit (13 of them in one unit, with empty segments); boundaries on a CTA's
# span boundary (the tower's plan spans 2,584 elements at both unit sizes);
# a leaf of zeros (the floor), a NaN, +-inf
FLAT_CASES = {
    "tower": None,  # sync_leaf_sizes(): each bias before its kernel
    "tower_by_layer": [3328, 256, 16384, 64, 1024, 16, 187904, 512, 131072, 256, 256, 1],
    "segments_512": [(i * 37) % 251 for i in range(512)],
    "empty_and_ones": [0, 1, 0, 1, 1, 5000, 0, 1, 3],
    "inside_units": [3, 5, 13, 2, 9, 4100, 1, 1, 6],
    "many_in_a_unit": [3] + [0] * 10 + [1] * 3 + [5000],  # 13 boundaries in one unit
    "span_boundary": None,  # 2584, 7752, 1, 2583 and the tower's rest
    "specials": [4096, 1000, 1000, 513],
}


def flat_case(dev, case, dtype, off16=False, seed=SEED + 98):
    """(g, residual, offsets) of ``FLAT_CASES[case]``: normal g of mixed
    magnitudes, a residual ~1e-4; "specials": leaf 0 all zeros (g and
    residual), a NaN in leaf 1, +inf and -inf in leaf 2. ``off16``: g and
    the residual start one element past a 16-byte boundary (the scalar
    plan)."""
    import torch

    lengths = FLAT_CASES[case]
    if case == "tower":
        lengths = sync_leaf_sizes()
    elif case == "span_boundary":
        lengths = [2584, 7752, 1, 2583, sum(sync_leaf_sizes()) - 12920]
    offsets = np.concatenate([[0], np.cumsum(lengths)]).astype(int).tolist()
    n = offsets[-1]
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=n) * 10.0 ** rng.integers(-3, 2, n)).astype(np.float32)
    r = (rng.normal(size=n) * 1e-4).astype(np.float32)
    if case == "specials":
        g[:4096] = 0
        r[:4096] = 0
        g[4096 + 17] = np.nan
        g[5096 + 3], g[5096 + 900] = np.inf, -np.inf
    lead = int(off16)
    gbuf = torch.zeros(n + lead, dtype=dtype, device=dev)
    rbuf = torch.zeros(n + lead, dtype=torch.float32, device=dev)
    gbuf[lead:] = torch.from_numpy(g).to(dev, dtype)
    rbuf[lead:] = torch.from_numpy(r).to(dev)
    return gbuf[lead:], rbuf[lead:], offsets


def flat_mode_cases(dev) -> list:
    """Phase 3h's flat cases: at each of ``FLAT_CASES``, f32 and bf16 g, on
    16 bytes and off them, ``segment_absmax`` and the shared-scale quantize
    (at 1.25x the scales) against their plain versions, bit for bit (the
    int32 codes the plain version's int8 codes widened); one launch a
    call. Returns the cases that differ."""
    import torch

    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.quantize_int8 import (
        quantize_int8_ef_reference,
        quantize_int8_ef_shared,
        segment_absmax,
        segment_absmax_reference,
    )

    f32_bits = lambda t: t.view(torch.int32)  # noqa: E731
    bad = []
    for case in FLAT_CASES:
        results = []
        for dtype in (torch.float32, torch.bfloat16):
            for off16 in (False, True):
                g, res, offs = flat_case(dev, case, dtype, off16)
                plan = plans.flat_quant_plan(g.numel(), not off16)
                n0 = (segment_absmax.launches, quantize_int8_ef_shared.launches)
                scale = segment_absmax(g, res, offs)
                ok = bits_equal(f32_bits(scale), f32_bits(segment_absmax_reference(g, res, offs)))
                shared = scale * 1.25
                q2, s2, r2 = quantize_int8_ef_reference(g, res.clone(), offs, scale=shared)
                q, sc, new = quantize_int8_ef_shared(g, res.clone(), offs, shared)
                ok &= (q.dtype == torch.int32 and bits_equal(q, q2.to(torch.int32))
                       and bits_equal(f32_bits(sc), f32_bits(s2)) and bits_equal(f32_bits(new), f32_bits(r2)))
                ok &= (segment_absmax.launches - n0[0], quantize_int8_ef_shared.launches - n0[1]) == (1, 1)
                if case == "specials":
                    ok &= (scale[0].item() == np.float32(1e-30) and np.isnan(scale[1].item())
                           and scale[2].item() == np.inf)
                if case == "span_boundary":
                    ok &= plan.span * plan.vec == 2584
                results.append((f"{str(dtype)[6:]}{' off 16 B' if off16 else ''} (vec {plan.vec}, grid "
                                f"{plan.grid})", ok))
        print(f"  flat segment_absmax and shared-scale quantize (int32 codes), {case} "
              f"({len(offs) - 1} segments, {offs[-1]} elements): "
              + "; ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in results), flush=True)
        bad += [f"flat {case} {k}" for k, v in results if not v]
    return bad


def absmax_graph_cases(dev, replays=20) -> list:
    """Phase 3h's check of ``segment_absmax``'s scratch under CUDA graphs:
    two graphs, each one call of other inputs captured on
    ``torch.cuda.graph``'s shared capture stream, replayed at once on two
    streams (the second graph first), ``replays`` times; every replay's
    scales bit for bit the plain version's (each capture makes its own
    scratch and zeroes it in its graph). Returns the cases that differ."""
    import torch

    from persia_tpu_torch.ops.quantize_int8 import segment_absmax, segment_absmax_reference

    inputs = [flat_case(dev, "tower", torch.float32, seed=SEED + 98 + i) for i in range(2)]
    wants = [segment_absmax_reference(g, r, offs).view(torch.int32) for g, r, offs in inputs]
    torch.cuda.synchronize()
    graphs, outs = [], []
    for g, r, offs in inputs:
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            outs.append(segment_absmax(g, r, offs))
        graphs.append(graph)
    streams = [torch.cuda.Stream() for _ in graphs]
    agree = 0
    for _ in range(replays):
        for out in outs:
            out.zero_()
        torch.cuda.synchronize()
        for graph, stream in zip(graphs[::-1], streams[::-1]):
            with torch.cuda.stream(stream):
                graph.replay()
        torch.cuda.synchronize()
        agree += all(bits_equal(out.view(torch.int32), want) for out, want in zip(outs, wants))
    print(f"  segment_absmax in two CUDA graphs replayed at once on two streams: {agree} of {replays} replays "
          f"bitwise {'ok' if agree == replays else 'FAIL'}", flush=True)
    del graphs
    return [] if agree == replays else ["segment_absmax in concurrent graphs"]


def feeder_leg(device, sd, batches, sharded, stream=False):
    """One leg of phase 4q: phase 4k saturated's ctx (2^18 rows) over a
    fresh store, sharded (``feed_threads``, ``feed_shards``) or not, the
    batches synchronous or as the stream; returns (record, the recorder's
    steps, launches of the leg)."""
    import torch

    from persia_tpu_torch import ops

    feed = dict(feed_threads=FEED_THREADS, feed_shards=FEED_SHARDS) if sharded else dict(feed_threads=1,
                                                                                         feed_shards=0)
    store = cache_store()
    ctx = cache_ctx(device, CACHE_SAT_ROWS, store, sd, **feed)
    rec = cache_recorder(ctx)
    prep, prep_cpu = [], []
    undo = timed_calls(ctx.tier, "prepare_batch", prep, prep_cpu)
    d = ctx.tier.dirs["cache_d16"]
    busy, stall = [], []
    if device != "cpu":
        torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    if stream:
        ctx.train_stream(batches, **STREAM_KNOBS)
        if device != "cpu":
            torch.cuda.synchronize()
    else:
        for b in batches:
            ctx.train_step(b, fetch_metrics=False)
            if sharded:
                busy.append(d.shard_busy_ns().tolist())
                stall.append(d.shard_stall_ns().tolist())
        ctx._land_pending()
        if device != "cpu":
            torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    sizes = d.shard_sizes().tolist()
    ctx.flush()
    launches = launches_now()
    undo()
    st = ctx.stream_stats() if stream else None
    record = {"sharded": sharded, "stream": stream, "samples_per_s": len(batches) * BATCH / wall, "wall_s": wall,
              "prepare_batch_ms_p50": float(np.percentile(prep, 50)), "prepare_batch_ms_mean": float(np.mean(prep)),
              "prepare_batch_cpu_ms_p50": float(np.percentile(prep_cpu, 50)),
              "evictions": ctx.tier.evictions, "shards": d.shards, "feed_threads": d.feed_threads}
    if busy:
        b, s_ = np.asarray(busy), np.asarray(stall)
        record.update(shard_busy_ns_p50=np.percentile(b, 50, axis=0).tolist(),
                      shard_stall_ns_p50=np.percentile(s_, 50, axis=0).tolist(),
                      shard_busy_ns_max=b.max(axis=0).tolist(), shard_sizes=sizes)
    if st is not None:
        record["lane_s"] = st.get("lane_s")
        record["feeder"] = st.get("feeder")
    del ctx
    return record, rec, launches


def path_sharded_feeder(dev):
    """Phase 4q: the cache tier's sharded feeder at phase 4k saturated's
    configuration (2^18 rows, its batches: ``FEED_STEPS`` of B=4096 over 26
    slots), ``feed_threads=4, feed_shards=8`` beside the unsharded leg:
    synchronous in turns (unsharded, sharded, unsharded, sharded), then
    the stream (unsharded, sharded): samples/s, ``prepare_batch`` ms, each
    shard's walk and queue ns (busy, stall). The last sharded synchronous
    leg is counted; its directory decisions must equal the CPU port's
    sharded run bit for bit at every step (the evictions start past step
    32), and the sharded stream's those of the sharded synchronous
    steps."""
    import os

    import torch

    from persia_tpu_torch.models import DLRM
    from persia_tpu_torch.weights import seeded_flax_params_like, state_dict_from_flax

    cores = len(os.sched_getaffinity(0))
    print(f"== phase 4q: the cache tier's sharded feeder (feed_threads={FEED_THREADS}, feed_shards={FEED_SHARDS}) "
          f"beside the unsharded walk, {CACHE_SAT_ROWS} rows, {FEED_STEPS} steps of B={BATCH}; the host's usable "
          f"cores: {cores}", flush=True)
    model = DLRM(N_DENSE, N_SLOTS, EMB_DIM, BOTTOM, TOP, device="cpu")
    sd = state_dict_from_flax(model, seeded_flax_params_like(model, SEED))
    make = zipf_batch_maker(SEED + 60, labels=True)
    batches = [make() for _ in range(FEED_STEPS)]
    legs = {}
    for stream, turns in ((False, 2), (True, 1)):
        for turn in range(turns):
            for sharded in (False, True):
                t_leg = time.perf_counter()
                rec, steps, launches = feeder_leg(dev, sd, batches, sharded, stream)
                rec["leg_s"] = time.perf_counter() - t_leg
                key = f"{'stream' if stream else 'sync'}_{'sharded' if sharded else 'unsharded'}"
                legs.setdefault(key, []).append((rec, steps, launches))
                print(f"  {key} (turn {turn}, {rec['leg_s']:.1f} s): samples/s {rec['samples_per_s']:.0f}, prepare_batch p50 "
                      f"{rec['prepare_batch_ms_p50']:.2f} ms (thread CPU {rec['prepare_batch_cpu_ms_p50']:.2f}), "
                      f"evictions {rec['evictions']}"
                      + (f", shard busy p50 ns {rec['shard_busy_ns_p50']}, stall p50 ns {rec['shard_stall_ns_p50']}"
                         if "shard_busy_ns_p50" in rec else ""), flush=True)
                gc.collect()
                torch.cuda.empty_cache()
    rec, steps, launches = legs["sync_sharded"][-1]
    touched = sum(st["touched"] for st in steps)
    expect_launches("sharded feeder (counted leg)", launches, cached_gather=FEED_STEPS, cache_aux=touched,
                    gather_entry_rows=1, sparse_update=FEED_STEPS, dot_interaction=FEED_STEPS,
                    dot_interaction_bwd=FEED_STEPS)
    t = time.perf_counter()
    _cpu, cpu_steps, _ = feeder_leg("cpu", sd, batches, True)
    cpu_s = time.perf_counter() - t
    same = [a["digest"] == b["digest"] for a, b in zip(steps, cpu_steps)]
    evicting = sum(st["evictions"] > 0 for st in steps)
    stream_same = [a["decisions"] == b["decisions"] for a, b in zip(steps, legs["stream_sharded"][-1][1])]
    unsharded_same = [a["decisions"] == b["decisions"] for a, b in zip(steps, legs["sync_unsharded"][-1][1])]
    print(f"  the sharded directory's decisions = the CPU port's sharded run at {sum(same)} of {len(same)} steps "
          f"({evicting} of them evicting; CPU {cpu_s:.1f} s); the sharded stream's = the sharded synchronous steps' at {sum(stream_same)} of "
          f"{len(stream_same)}; the unsharded walk's at {sum(unsharded_same)} of {len(unsharded_same)} (the shard "
          f"count decides row assignment)", flush=True)
    if len(same) != FEED_STEPS or not all(same) or not all(stream_same) or len(stream_same) != FEED_STEPS:
        raise SystemExit("sharded feeder: the card's decisions differ from the CPU port's or the stream's")
    if rec["evictions"] == 0 or not evicting:
        raise SystemExit("sharded feeder: the saturated regime evicted nothing")
    record = {"cores": cores, "steps": FEED_STEPS, "rows": CACHE_SAT_ROWS, "feed_threads": FEED_THREADS,
              "feed_shards": FEED_SHARDS, "legs": {k: [r for r, _s, _l in v] for k, v in legs.items()},
              "decisions_equal_cpu": all(same), "stream_decisions_equal_sync": all(stream_same),
              "steps_equal_unsharded": sum(unsharded_same)}
    for k, v in legs.items():
        sps = [r["samples_per_s"] for r, _s, _l in v]
        prep = [r["prepare_batch_ms_p50"] for r, _s, _l in v]
        print(f"  {k}: samples/s by turn {[round(x) for x in sps]}, prepare_batch p50 ms {[round(x, 3) for x in prep]}",
              flush=True)
    return {"sharded_feeder": launches}, record


def path_dense_sync(dev):
    """Phase 4r: ``TrainCtx(mesh=data_parallel_mesh(), dense_sync=mode)``
    for each of the six modes at bench width (``SYNC_SPEC``, B=4096),
    ``SYNC_STEPS`` steps each, at world size 1 over NCCL (a process group
    of this process alone; counted: K16 and K17 once a step in the ring,
    K15's two modes once a step in bytegrad), held to the CPU port
    (``SYNC_LOSS_RTOL``, ``SYNC_PARAM_ATOL``); then a two-rank leg on this
    one card over gloo (NCCL refuses two ranks on one device; gloo's
    payloads through pinned host memory, the kernels on the card) for
    ``TWO_RANK_MODES``, every rank's parameters the same bits, held to the
    same two ranks on the CPU, a rank's ring step 1 K16, 1 fused hop and 1
    K17 (the sharded ring's 1 K16 and 1 K17); ``dense_wire_bytes_per_step``
    of each; then ``ring_ranks_leg``. The world-size-1 run also times
    each ``bytegrad_allreduce`` on the card (CUDA events around the call)
    and checks that its codes come as int32 (no cast before the sum)."""
    import torch
    import torch.distributed as dist

    from persia_tpu_torch import ops
    from persia_tpu_torch.distributed import initialize_process_group
    from persia_tpu_torch.parallel import grad_sync
    from persia_tpu_torch.parallel.mesh import data_parallel_mesh
    from persia_tpu_torch.testing import dense_sync as tds

    modes = grad_sync.DENSE_SYNC_MODES
    print(f"== phase 4r: the hybrid tier's dense sync modes {list(modes)} at bench width (B={BATCH}, "
          f"{SYNC_STEPS} steps), world size 1 over NCCL", flush=True)
    initialize_process_group(backend="nccl", init_method=f"tcp://localhost:{tds.free_port()}", world_size=1, rank=0)
    try:
        mesh = data_parallel_mesh()
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise SystemExit(f"dense sync: a mesh of {mesh.size} ranks over {mesh.backend}")
        torch.cuda.synchronize()
        bytegrad_events, wire_dtypes = [], []
        bytegrad, shared = grad_sync.bytegrad_allreduce, grad_sync.quantize_int8_ef_shared

        def timed_bytegrad(*args, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = bytegrad(*args, **kw)
            end.record()
            bytegrad_events.append((start, end))
            return out

        def wire_codes(*args, **kw):
            out = shared(*args, **kw)
            wire_dtypes.append(out[0].dtype)
            return out

        ops.reset_launch_counts()
        grad_sync.bytegrad_allreduce, grad_sync.quantize_int8_ef_shared = timed_bytegrad, wire_codes
        try:
            card = {m: tds.run_case(mesh, dict(mode=m, steps=SYNC_STEPS, seed=SEED + 90), SYNC_SPEC, dev)
                    for m in modes}
        finally:
            grad_sync.bytegrad_allreduce, grad_sync.quantize_int8_ef_shared = bytegrad, shared
        torch.cuda.synchronize()
        launches = launches_now()
    finally:
        dist.destroy_process_group()
    bytegrad_ms = [start.elapsed_time(end) for start, end in bytegrad_events]
    print(f"  bytegrad_allreduce on the card a step (CUDA events around the call, world size 1): {bytegrad_ms} ms; "
          f"the codes on the wire {[str(d) for d in wire_dtypes]}", flush=True)
    if len(bytegrad_ms) != SYNC_STEPS or wire_dtypes != [torch.int32] * SYNC_STEPS:
        raise SystemExit(f"dense sync: bytegrad ran {len(bytegrad_ms)} times, its codes {wire_dtypes} (int32 wanted)")
    expect_path_launches("dense sync (world size 1)", launches,
                         exact={"block_quantize_int8": SYNC_STEPS, "block_dequantize_int8": SYNC_STEPS,
                                "block_requantize_int8": 0, "segment_absmax": SYNC_STEPS,
                                "quantize_int8_ef_shared": SYNC_STEPS},
                         at_least=("dot_interaction", "dot_interaction_bwd"))
    t = time.perf_counter()
    cpu = {m: tds.run_case(data_parallel_mesh(), dict(mode=m, steps=SYNC_STEPS, seed=SEED + 90), SYNC_SPEC,
                           torch.device("cpu")) for m in modes}
    cpu_s = time.perf_counter() - t
    record = {"spec": {k: list(v) if isinstance(v, tuple) else v for k, v in SYNC_SPEC.items() if k != "vocabs"},
              "params": int(grad_sync.dense_param_count(tds.model_and_params(SYNC_SPEC)[0])), "modes": {},
              "bytegrad_card_ms_a_step": bytegrad_ms}
    p = record["params"]
    bad = []
    for m in modes:
        a, b = card[m], cpu[m]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
        param_err = float(np.abs(a["params"] - b["params"]).max())
        per_step = a["launches"]
        record["modes"][m] = {"losses": a["losses"], "cpu_losses": b["losses"], "loss_rel_err_vs_cpu": loss_err,
                              "param_max_abs_err_vs_cpu": param_err, "launches_per_step": per_step,
                              "sync_mode": a["sync_mode"], "wire_bytes_per_step": a["wire_bytes"],
                              "wire_bytes_modelled": {n: grad_sync.dense_sync_wire_bytes(m, p, n) for n in (2, 4, 8)},
                              "opt_state_bytes": a["opt_state_bytes"]}
        print(f"  {m}: losses {[round(x, 6) for x in a['losses']]} (CPU {[round(x, 6) for x in b['losses']]}, "
              f"rel err {loss_err:.2e}), params max abs err vs CPU {param_err:.2e}; a step's launches "
              f"{per_step[-1]}; wire bytes a step {a['wire_bytes']} (modelled at n=2/4/8: "
              f"{record['modes'][m]['wire_bytes_modelled']})", flush=True)
        if loss_err > SYNC_LOSS_RTOL or param_err > SYNC_PARAM_ATOL or not np.isfinite(a["losses"]).all():
            bad.append(m)
    print(f"  (CPU port {cpu_s:.1f} s)", flush=True)
    if bad:
        raise SystemExit(f"dense sync: card and CPU disagree in {bad}")
    # the two-rank leg on the one card, over gloo
    print(f"  two ranks on the one card over gloo: {list(TWO_RANK_MODES)}", flush=True)
    cases = [dict(mode=m, steps=SYNC_STEPS, seed=SEED + 90) for m in TWO_RANK_MODES]
    # the CPU's two ranks run beside the card's (each leg's own processes)
    t = time.perf_counter()
    two_cpu_s = [0.0]

    def cpu_leg():
        try:
            return tds.run_ranks(2, cases, spec=SYNC_SPEC, device="cpu", backend="gloo", timeout=420)
        finally:
            two_cpu_s[0] = time.perf_counter() - t

    with ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(cpu_leg)
        two = tds.run_ranks(2, cases, spec=SYNC_SPEC, device=TWO_RANK_DEVICE, backend="gloo", timeout=420)
        two_s = time.perf_counter() - t
        two_cpu = cpu_future.result()
    two_cpu_s = two_cpu_s[0]
    record["two_rank"] = {"seconds": two_s, "cpu_seconds": two_cpu_s, "modes": {}}
    two_launches = dict.fromkeys(SYNC_KERNELS, 0)
    for i, m in enumerate(TWO_RANK_MODES):
        r0, r1, c0 = two[0][i], two[1][i], two_cpu[0][i]
        same = np.array_equal(r0["params"], r1["params"]) and np.array_equal(two_cpu[1][i]["params"], c0["params"])
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(r0["losses"], c0["losses"]))
        param_err = float(np.abs(r0["params"] - c0["params"]).max())
        ring = int(m.startswith("block-int8-ring"))
        want = {"block_quantize_int8": ring, "block_requantize_int8": ring * (not m.endswith("sharded")),
                "block_dequantize_int8": ring}
        got = {k: r0["launches"][-1][k] for k in want}
        for r in (r0, r1):
            for k in SYNC_KERNELS:
                two_launches[k] += sum(st[k] for st in r["launches"])
        ef_max = float(np.abs(r0["ef"]).max()) if r0["ef"] is not None else None
        record["two_rank"]["modes"][m] = {"losses": r0["losses"], "cpu_losses": c0["losses"],
                                          "params_same_on_both_ranks": same, "loss_rel_err_vs_cpu": loss_err,
                                          "param_max_abs_err_vs_cpu": param_err, "launches_per_step": got,
                                          "wire_bytes_per_step": r0["wire_bytes"], "ef_max_abs": ef_max,
                                          "opt_state_bytes": r0["opt_state_bytes"]}
        print(f"  {m} at 2 ranks: losses {[round(x, 6) for x in r0['losses']]} (CPU rel err {loss_err:.2e}), "
              f"params max abs err vs CPU {param_err:.2e}, both ranks' parameters the same bits: {same}; a rank's "
              f"launches a step {got} (expected {want}); wire bytes a step {r0['wire_bytes']}; |ef| max {ef_max}; "
              f"optimizer state a rank {r0['opt_state_bytes']} B", flush=True)
        if not same or got != want or loss_err > SYNC_LOSS_RTOL or param_err > SYNC_PARAM_ATOL \
                or r0["wire_bytes"] != grad_sync.dense_sync_wire_bytes(m, p, 2):
            raise SystemExit(f"dense sync at two ranks on the card: {m} failed")
    print(f"  two ranks: card {two_s:.1f} s, CPU {two_cpu_s:.1f} s, side by side (process start included)",
          flush=True)
    ring_launches, record["ring_ranks"] = ring_ranks_leg(dev)
    inputs = sync_inputs(dev)
    return ({"dense_sync": launches, "dense_sync_two_ranks": two_launches, "dense_sync_ring4": ring_launches}, record,
            inputs)


def ring_ranks_leg(dev):
    """Phase 4r's ring-only leg: ``testing.dense_sync.ring_allreduce_rank``
    over the bench tower's padded flat gradient (P = 341,073, ``SYNC_BLOCK``)
    on ``RING_RANKS`` gloo ranks on the one card, beside the same ring on as
    many CPU ranks of the port: each rank's sum and new ``ef`` the same bits,
    every rank's sum the same, and a rank's launches 1 K16, ``RING_RANKS``
    - 1 fused hops and 1 K17. Returns (the launches of all ranks, record)."""
    from persia_tpu_torch.parallel import grad_sync
    from persia_tpu_torch.testing import dense_sync as tds

    n = RING_RANKS
    p = sum(sync_leaf_sizes())
    _chunk, p_pad = grad_sync._flat_chunk(p, n, SYNC_BLOCK)
    rng = np.random.default_rng(SEED + 97)
    per_rank = np.zeros((n, p_pad), np.float32)
    per_rank[:, :p] = (rng.normal(size=(n, p)) * 1e-2).astype(np.float32)
    ef = (rng.normal(size=(n, p_pad)) * 1e-5).astype(np.float32)
    print(f"  the ring alone at {n} ranks on the one card over gloo ({p_pad} elements a rank), beside {n} CPU ranks",
          flush=True)
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(tds.run_function, n, tds.ring_allreduce_rank, SYNC_BLOCK, per_rank, ef, "cpu",
                                 timeout=300)
        card = tds.run_function(n, tds.ring_allreduce_launches, SYNC_BLOCK, per_rank, ef, TWO_RANK_DEVICE,
                                device=TWO_RANK_DEVICE, timeout=300)
        cpu = cpu_future.result()
    seconds = time.perf_counter() - t
    same = [all(np.array_equal(a.view(np.int32), b.view(np.int32)) for a, b in zip(c[:2], w))
            for c, w in zip(card, cpu)]
    agree = all(np.array_equal(c[0], card[0][0]) for c in card)
    per_rank_launches = [c[2] for c in card]
    want = {"block_quantize_int8": 1, "block_requantize_int8": n - 1, "block_dequantize_int8": 1,
            "segment_absmax": 0, "quantize_int8_ef_shared": 0, "quantize_int8_ef": 0, "lp_ring_mix": 0}
    print(f"  each rank's sum and ef the CPU ranks' bits: {same}; every rank's sum the same: {agree}; launches a "
          f"rank {per_rank_launches} (expected {want}); {seconds:.1f} s (card and CPU side by side, process start "
          f"included)", flush=True)
    if not all(same) or not agree or any(la != want for la in per_rank_launches):
        raise SystemExit(f"the ring at {n} ranks on the card: failed")
    totals = {k: sum(la[k] for la in per_rank_launches) for k in want}
    return totals, {"ranks": n, "elements_a_rank": int(p_pad), "bits_equal_cpu": same, "sums_agree": agree,
                    "launches_a_rank": per_rank_launches, "seconds": seconds}


def phase_lp_kernels(dev):
    """Phase 3i: K18 (``lp_ring_mix``) against its plain version on the
    card, bit for bit (x and the three shadows, rewritten in place; one
    launch a call): at the bench tower's 12 leaves and at
    ``testing.dense_sync.LP_MIX_CASES`` (512 segments, empty and 1-element
    segments, boundaries inside a 4-element unit), each on 16 bytes and off
    them (the scalar plan), with and without NaN and infinities in x; every
    case has codes of -127, 127 and 0 and a scale of 1e-30."""
    import torch

    from persia_tpu_torch.ops import plans
    from persia_tpu_torch.ops.lp_ring import lp_ring_mix, lp_ring_mix_reference
    from persia_tpu_torch.testing import dense_sync as tds

    print("== phase 3i: K18 (lp_ring_mix, LowPrecisionDecentralized's sync mix) vs its plain version", flush=True)
    bad = []
    cases = {"tower": sync_leaf_sizes(), **tds.LP_MIX_CASES}
    for case, lengths in cases.items():
        results = []
        for off16 in (False, True):
            for specials in (False, True):
                args, offsets = tds.lp_mix_inputs(lengths, dev, SEED + 110, off16, specials)
                want = lp_ring_mix_reference(*args, offsets)
                ins = []
                for i, a in enumerate(args):  # the rewritten four keep the inputs' alignment
                    if i < 4:
                        buf = torch.empty(a.numel() + off16, dtype=a.dtype, device=dev)[int(off16):]
                        buf.copy_(a)
                        a = buf
                    ins.append(a)
                plan = plans.lp_ring_mix_plan(offsets[-1], not off16)
                n0 = lp_ring_mix.launches
                out = lp_ring_mix(*ins, offsets)
                ok = lp_ring_mix.launches == n0 + 1 and plan.vec == (1 if off16 else 4) and all(
                    o is i and bits_equal(o.view(torch.int32), w.view(torch.int32))
                    for o, i, w in zip(out, ins, want))
                results.append((f"{'off 16 B' if off16 else 'on 16 B'}{', NaN/inf' if specials else ''} (vec "
                                f"{plan.vec}, grid {plan.grid})", ok))
        print(f"  {case} ({len(lengths)} segments, {sum(lengths)} elements): "
              + "; ".join(f"{k} {'ok' if v else 'FAIL'}" for k, v in results), flush=True)
        bad += [f"{case} {k}" for k, v in results if not v]
    if bad:
        raise SystemExit(f"K18 disagrees with its plain version: {bad}")
    return {"lp_ring_mix": 0.0}


def divergent_cases():
    return [dict(algorithm=name, kwargs=kw, steps=SYNC_STEPS, seed=SEED + 120) for name, kw, _k in
            DIVERGENT_CASES.values()]


def qadam_flip_step(cpu) -> np.ndarray:
    """Per element, how far one flipped code of m moves a QAdam parameter
    in one update after the warmup (``QADAM_FLIPS``), from the CPU run's m
    and frozen v."""
    algo = DIVERGENT_CASES["qadam"][1]
    lr, eps, b1, b2, warm = algo["lr"], 1e-8, 0.9, 0.999, algo["warmup_steps"]  # QAdam's defaults beside lr
    m, v = np.abs(cpu["algo_state"]["m"]), cpu["algo_state"]["v"]
    sizes = sync_leaf_sizes()
    code_step = np.repeat([leaf.max() / 127.0 if leaf.size else 0.0 for leaf in np.split(m, np.cumsum(sizes)[:-1])],
                          sizes)
    return lr / (1.0 - b1 ** (warm + 1)) * code_step / (np.sqrt(v / (1.0 - b2 ** warm)) + eps)


def divergent_agree(key, card, cpu) -> tuple:
    """(loss relative error, the parameters' largest error, the largest
    error over its tolerance, ok) of a card run against the CPU port's:
    the losses within ``SYNC_LOSS_RTOL``, the parameters after every step
    within ``SYNC_PARAM_ATOL`` (QAdam's after its warmup also within
    ``QADAM_FLIPS`` code flips a step, ``qadam_flip_step``)."""
    loss_err = max(abs(x - y) / abs(y) for x, y in zip(card["losses"], cpu["losses"]))
    param_err, over = 0.0, 0.0
    for s, (a, b) in enumerate(zip(card["params"], cpu["params"])):
        err = np.abs(a - b)
        tol = np.full(err.shape, SYNC_PARAM_ATOL)
        warm = DIVERGENT_CASES[key][1].get("warmup_steps", 0) if key == "qadam" else None
        if warm is not None and s >= warm:
            tol = tol + QADAM_FLIPS * (s + 1 - warm) * qadam_flip_step(cpu)
        param_err, over = max(param_err, float(err.max())), max(over, float((err / tol).max()))
    ok = (loss_err <= SYNC_LOSS_RTOL and over <= 1.0 and np.isfinite(card["losses"]).all()
          and np.isfinite(card["params"][-1]).all())
    return loss_err, param_err, over, ok


def divergent_launches_ok(key, per_step) -> bool:
    """A rank's sync kernels each step: ``DIVERGENT_CASES``'s (QAdam none
    in its warmup step)."""
    want = DIVERGENT_CASES[key][2]
    for s, la in enumerate(per_step):
        got = {k: la[k] for k in DIVERGENT_KERNELS if la.get(k)}
        if got != ({} if key == "qadam" and s == 0 else want):
            return False
    return True


def path_divergent_sync(dev):
    """Phase 4s: ``grad_sync.build_sync_train_step`` with Decentralized(1),
    LocalSGD(2), LowPrecisionDecentralized(1) and QAdam(warmup 1) at bench
    width (``SYNC_SPEC``: B=4096, the tower's P = 341,073 in 12 leaves; 25
    host-pooled slots and a raw one, ``testing.dense_sync.host_batches``),
    ``SYNC_STEPS`` steps each, from ``replicate_for_local`` and
    ``init_sync_opt_state``: at world size 1 over NCCL (counted: LP 1 K15
    and 1 K18 a step, QAdam 1 ``segment_absmax`` and 1 shared quantize a
    step after its warmup, none in it, the others none), held to the CPU
    port (``divergent_agree``); at two gloo ranks on the one card, each
    rank held to two CPU ranks, LP's ``shadow_left`` on each rank bit for
    bit its neighbour's ``shadow_self``; LP's sync alone at ``RING_RANKS``
    gloo ranks on the card over the tower's flat vector, bit for bit as
    many CPU ranks (``lp_ranks_leg``); ``TrainCtx.train_step_prepared`` at
    two gloo ranks (``prepared_leg``)."""
    import torch
    import torch.distributed as dist

    from persia_tpu_torch import ops
    from persia_tpu_torch.distributed import initialize_process_group
    from persia_tpu_torch.parallel.mesh import data_parallel_mesh
    from persia_tpu_torch.testing import dense_sync as tds

    keys = list(DIVERGENT_CASES)
    print(f"== phase 4s: the divergent-replica algorithms {keys} on build_sync_train_step at bench width "
          f"(B={BATCH}, {SYNC_STEPS} steps), world size 1 over NCCL", flush=True)
    cases = divergent_cases()
    initialize_process_group(backend="nccl", init_method=f"tcp://localhost:{tds.free_port()}", world_size=1, rank=0)
    try:
        mesh = data_parallel_mesh()
        if (mesh.size, mesh.backend) != (1, "nccl"):
            raise SystemExit(f"divergent sync: a mesh of {mesh.size} ranks over {mesh.backend}")
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        card = {k: tds.divergent_case(mesh, c, SYNC_SPEC, dev) for k, c in zip(keys, cases)}
        torch.cuda.synchronize()
        launches = launches_now()
    finally:
        dist.destroy_process_group()
    n_lp = SYNC_STEPS
    expect_path_launches("divergent sync (world size 1)", launches,
                         exact={"quantize_int8_ef": n_lp, "lp_ring_mix": n_lp, "segment_absmax": SYNC_STEPS - 1,
                                "quantize_int8_ef_shared": SYNC_STEPS - 1, "block_quantize_int8": 0,
                                "block_dequantize_int8": 0, "block_requantize_int8": 0},
                         at_least=("dot_interaction", "dot_interaction_bwd", "raw_gather_fwd", "raw_gather_bwd"))
    t = time.perf_counter()
    cpu = {k: tds.divergent_case(data_parallel_mesh(), c, SYNC_SPEC, torch.device("cpu"))
           for k, c in zip(keys, cases)}
    cpu_s = time.perf_counter() - t
    record = {"params": int(card["lp"]["params"][-1].size), "algorithms": {}, "cpu_seconds": cpu_s}
    bad = []
    for k in keys:
        a, b = card[k], cpu[k]
        loss_err, param_err, over, ok = divergent_agree(k, a, b)
        launches_ok = divergent_launches_ok(k, a["launches"])
        per_step = [{n: la[n] for n in DIVERGENT_KERNELS if la[n]} for la in a["launches"]]
        record["algorithms"][k] = {"kwargs": DIVERGENT_CASES[k][1], "losses": a["losses"], "cpu_losses": b["losses"],
                                   "loss_rel_err_vs_cpu": loss_err, "param_max_abs_err_vs_cpu": param_err,
                                   "param_err_over_tolerance": over,
                                   "sync_launches_per_step": per_step}
        print(f"  {k} {DIVERGENT_CASES[k][1]}: losses {[round(x, 6) for x in a['losses']]} (CPU "
              f"{[round(x, 6) for x in b['losses']]}, rel err {loss_err:.2e}), params max abs err vs CPU "
              f"{param_err:.2e} ({over:.2f} of its tolerance); sync launches a step {per_step} (expected {DIVERGENT_CASES[k][2]})", flush=True)
        if not ok or not launches_ok:
            bad.append(k)
    print(f"  (CPU port {cpu_s:.1f} s)", flush=True)
    if bad:
        raise SystemExit(f"divergent sync: card and CPU disagree, or the launches differ, in {bad}")
    two_launches, record["two_rank"] = divergent_two_ranks(keys, cases)
    lp_launches, record["lp_ranks"] = lp_ranks_leg()
    prepared_launches, record["prepared"] = prepared_leg()
    return ({"divergent_sync": launches, "divergent_sync_two_ranks": two_launches, "lp_sync_ranks": lp_launches,
             "prepared_two_ranks": prepared_launches}, record)


def divergent_two_ranks(keys, cases):
    """Phase 4s's two-rank leg: ``testing.dense_sync.divergent_rank`` on two
    gloo ranks on the one card beside two CPU ranks (each leg its own
    processes): each rank held to its CPU rank (``divergent_agree``), its
    sync launches a step, LP's shadows' neighbour invariant bit for bit on
    the card. Returns (every rank's sync launches, record)."""
    from persia_tpu_torch.testing import dense_sync as tds

    print("  two ranks on the one card over gloo, beside two CPU ranks", flush=True)
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(tds.run_function, 2, tds.divergent_rank, cases, SYNC_SPEC, "cpu", timeout=420)
        card = tds.run_function(2, tds.divergent_rank, cases, SYNC_SPEC, TWO_RANK_DEVICE, device=TWO_RANK_DEVICE,
                                timeout=420)
        cpu = cpu_future.result()
    seconds = time.perf_counter() - t
    record = {"seconds": seconds, "algorithms": {}}
    totals = dict.fromkeys(DIVERGENT_KERNELS, 0)
    for i, k in enumerate(keys):
        rows = []
        ok = True
        for r in range(2):
            loss_err, param_err, over, agree = divergent_agree(k, card[r][i], cpu[r][i])
            ok &= agree and divergent_launches_ok(k, card[r][i]["launches"])
            rows.append((loss_err, param_err, over))
            for la in card[r][i]["launches"]:
                for n in DIVERGENT_KERNELS:
                    totals[n] += la[n]
        invariant = None
        if k == "lp":
            st = [card[r][i]["algo_state"] for r in range(2)]
            invariant = all(np.array_equal(st[r]["shadow_left"].view(np.int32),
                                           st[1 - r]["shadow_self"].view(np.int32)) for r in range(2))
            ok &= invariant
        same = np.array_equal(card[0][i]["params"][-1], card[1][i]["params"][-1])
        record["algorithms"][k] = {"losses": card[0][i]["losses"], "errors_vs_cpu_by_rank": rows,
                                   "ranks_same_params": same, "shadow_left_is_neighbours_self": invariant}
        print(f"  {k} at 2 ranks: losses {[round(x, 6) for x in card[0][i]['losses']]}; (loss rel err, param max abs "
              f"err, share of its tolerance) vs the CPU rank by rank "
              f"{[(f'{a:.2e}', f'{b:.2e}', f'{c:.2f}') for a, b, c in rows]}; the ranks' parameters "
              f"the same bits: {same}" + (f"; shadow_left = the neighbour's shadow_self, bitwise: {invariant}"
                                          if invariant is not None else ""), flush=True)
        if not ok:
            raise SystemExit(f"divergent sync at two ranks on the card: {k} failed")
    print(f"  two ranks: card and CPU side by side {seconds:.1f} s (process start included)", flush=True)
    return totals, record


def lp_ranks_leg():
    """Phase 4s's LP-only leg: ``testing.dense_sync.lp_sync_rank`` (one
    ``lp_ring_sync``) over the tower's flat vector and 12 leaves on
    ``RING_RANKS`` gloo ranks on the one card, beside as many CPU ranks:
    each rank's new x, shadows and residual the same bits, every rank's
    ``shadow_left`` its left neighbour's ``shadow_self``, a rank's launches
    1 K15 and 1 K18. Returns (the launches of all ranks, record)."""
    from persia_tpu_torch.testing import dense_sync as tds

    n = RING_RANKS
    sizes = sync_leaf_sizes()
    p = sum(sizes)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(int).tolist()
    rng = np.random.default_rng(SEED + 121)
    x = (rng.normal(size=(n, p)) * 5e-2).astype(np.float32)
    ss = (x + rng.normal(size=(n, p)) * 1e-3).astype(np.float32)
    shadows = {"shadow_self": ss, "shadow_left": np.roll(ss, 1, axis=0), "shadow_right": np.roll(ss, -1, axis=0),
               "residual": (rng.normal(size=(n, p)) * 1e-6).astype(np.float32)}
    print(f"  LP's sync alone at {n} ranks on the one card over gloo ({p} elements, {len(sizes)} leaves), beside {n} "
          f"CPU ranks", flush=True)
    t = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        cpu_future = pool.submit(tds.run_function, n, tds.lp_sync_rank, x, shadows, offsets, "cpu", timeout=300)
        card = tds.run_function(n, tds.lp_sync_rank, x, shadows, offsets, TWO_RANK_DEVICE, device=TWO_RANK_DEVICE,
                                timeout=300)
        cpu = cpu_future.result()
    seconds = time.perf_counter() - t
    bits = lambda a: a.view(np.int32)  # noqa: E731
    same = [np.array_equal(bits(c[0]), bits(w[0])) and all(np.array_equal(bits(c[1][k]), bits(w[1][k])) for k in c[1])
            for c, w in zip(card, cpu)]
    invariant = all(np.array_equal(bits(card[r][1]["shadow_left"]), bits(card[(r - 1) % n][1]["shadow_self"]))
                    for r in range(n))
    per_rank = [{k: c[2][k] for k in DIVERGENT_KERNELS} for c in card]
    want = {"quantize_int8_ef": 1, "lp_ring_mix": 1, "segment_absmax": 0, "quantize_int8_ef_shared": 0}
    print(f"  each rank's x, shadows and residual the CPU ranks' bits: {same}; shadow_left = the left neighbour's "
          f"shadow_self: {invariant}; launches a rank {per_rank} (expected {want}); {seconds:.1f} s (card and CPU side "
          f"by side, process start included)", flush=True)
    if not all(same) or not invariant or any(la != want for la in per_rank):
        raise SystemExit(f"LP's sync at {n} ranks on the card: failed")
    totals = {k: sum(la[k] for la in per_rank) for k in want}
    return totals, {"ranks": n, "elements": p, "bits_equal_cpu": same, "neighbour_invariant": invariant,
                    "launches_a_rank": per_rank, "seconds": seconds}


def prepared_leg():
    """Phase 4s's pipelined leg: ``TrainCtx.train_step_prepared`` at two gloo
    ranks on the one card for ``PREPARED_MODES`` (rank 0 over a
    ``DataLoader(reproducible=True, staleness=1)``, rank 1 with None), 3
    steps at ``SYNC_SPEC`` on native stores, beside the synchronous
    ``train_step`` at the same ranks on the same batches: losses within
    ``SYNC_LOSS_RTOL`` (printed: bitwise or not), both ranks' parameters
    the same bits. Returns (the ring kernels' launches, record)."""
    from persia_tpu_torch.testing import dense_sync as tds

    cases = []
    for m in PREPARED_MODES:
        cases += [dict(mode=m, steps=SYNC_STEPS, seed=SEED + 122, loader=True),
                  dict(mode=m, steps=SYNC_STEPS, seed=SEED + 122)]
    print(f"  train_step_prepared at two gloo ranks on the one card, {list(PREPARED_MODES)}, beside train_step",
          flush=True)
    t = time.perf_counter()
    res = tds.run_ranks(2, cases, spec=SYNC_SPEC, device=TWO_RANK_DEVICE, backend="gloo", timeout=420)
    seconds = time.perf_counter() - t
    record = {"seconds": seconds, "modes": {}}
    totals = dict.fromkeys(SYNC_KERNELS, 0)
    for j, m in enumerate(PREPARED_MODES):
        prep, sync = [res[r][2 * j] for r in range(2)], [res[r][2 * j + 1] for r in range(2)]
        loss_err = max(abs(x - y) / abs(y) for x, y in zip(prep[0]["losses"], sync[0]["losses"]))
        bitwise = all(a["losses"] == b["losses"] and np.array_equal(a["params"], b["params"])
                      for a, b in zip(prep, sync))
        same = np.array_equal(prep[0]["params"], prep[1]["params"])
        for r in prep:
            for la in r["launches"]:
                for k in SYNC_KERNELS:
                    totals[k] += la[k]
        record["modes"][m] = {"losses": prep[0]["losses"], "sync_losses": sync[0]["losses"],
                              "loss_rel_err_vs_sync": loss_err, "bitwise_sync": bitwise, "ranks_same_params": same}
        print(f"  {m}: prepared losses {[round(x, 6) for x in prep[0]['losses']]}, train_step's "
              f"{[round(x, 6) for x in sync[0]['losses']]} (rel err {loss_err:.2e}; bit for bit: {bitwise}); both "
              f"ranks' parameters the same bits: {same}", flush=True)
        if loss_err > SYNC_LOSS_RTOL or not same or len(prep[0]["losses"]) != SYNC_STEPS:
            raise SystemExit(f"train_step_prepared at two ranks on the card: {m} failed")
    print(f"  prepared leg {seconds:.1f} s (process start included)", flush=True)
    return totals, record


def time_sync_kernels(dev, launches, errs, inputs, floor):
    """Phase 5's rows of K16, K17, the fused hop and K15 at a shared scale
    at the bench tower's ring shapes (``sync_inputs``): graph-replayed warm
    and cold, beside the plain version (composed PyTorch calls), the bound;
    K16 on the whole padded vector with the feedback (a ring at n = 1) and
    at n = 4's chunk with it (a ring's hop 0, ``hop_chunk_*``), K17 as a
    hop's accumulate at that chunk, the fused hop there (accumulate with
    the feedback, quantize) beside K17 then K16 on the same inputs
    (``unfolded_pair_*``), K15's flat scales and codes over the tower's
    leaves: ``segment_absmax`` beside ``torch._foreach_norm(ord=inf)`` over
    the 12 pre-summed leaves (``foreach_norm_inf_*``, a yardstick of the
    reduction alone, not the same function), the shared-scale quantize
    (int32 codes, bytegrad's). ``launches``: each kernel's launches in phases 4r's and 4s's counted
    runs."""
    import torch

    from persia_tpu_torch.ops.block_int8 import (
        block_dequantize_int8,
        block_dequantize_int8_reference,
        block_quantize_int8,
        block_quantize_int8_reference,
        block_requantize_int8,
        block_requantize_int8_reference,
    )
    from persia_tpu_torch.ops.quantize_int8 import (
        quantize_int8_ef_reference,
        quantize_int8_ef_shared,
        segment_absmax,
    )

    x = inputs
    n1, n4, p = x["ppad1"], x["chunk4"], x["p"]
    blocks4 = n4 // SYNC_BLOCK
    offs = x["offsets"]
    segs = len(offs) - 1
    lengths = torch.tensor(np.diff(offs), device=dev)
    seg_ids = torch.repeat_interleave(torch.arange(segs, device=dev), lengths)
    scale = segment_absmax(x["flat"], x["res"], offs)
    err1, err4 = torch.empty_like(x["g1"]), torch.empty_like(x["g4"])
    q4, s4, _ = block_quantize_int8(x["g4"], SYNC_BLOCK)
    acc, pair_acc = x["base4"].clone(), x["base4"].clone()
    res = x["res"].clone()

    def absmax_composed():
        v = x["flat"] + x["res"]
        return torch.zeros(segs, device=dev).scatter_reduce_(0, seg_ids, v.abs(), "amax").clamp_min(1e-30)

    def shared_composed():
        v = x["flat"] + res
        step = scale / torch.full_like(scale, 127.0)
        t_ = torch.round(v / scale[seg_ids] * 127.0).clamp_(-127, 127)
        return t_.to(torch.int32), v - t_ * step[seg_ids]

    pre_summed = list(torch.split(x["flat"] + x["res"], [int(b - a) for a, b in zip(offs[:-1], offs[1:])]))

    def foreach_norm_inf():
        return torch._foreach_norm(pre_summed, ord=float("inf"))

    def unfolded_pair(q, sc, b, e, r):
        block_dequantize_int8(q, sc, SYNC_BLOCK, base=b, ef=e, out=b)
        return block_quantize_int8(b, SYNC_BLOCK, err=r)

    def hop_copy():
        return q4.clone(), s4.clone(), x["base4"].clone(), x["ef4"].clone(), torch.empty_like(x["g4"])

    cases = {
        "block_quantize_int8": dict(
            kernel=lambda: block_quantize_int8(x["g1"], SYNC_BLOCK, ef=x["ef1"], err=err1),
            plain=lambda: block_quantize_int8_reference(x["g1"], SYNC_BLOCK, x["ef1"]),
            cold=(lambda v, e, r: block_quantize_int8(v, SYNC_BLOCK, ef=e, err=r),
                  lambda: (x["g1"].clone(), x["ef1"].clone(), torch.empty_like(x["g1"])), n1 * 12),
            bytes=n1 * 13 + n1 // SYNC_BLOCK * 4, ops=6 * n1, shape=[n1, SYNC_BLOCK, "n=1 whole vector, feedback"],
            extras={"hop_chunk": (lambda: block_quantize_int8(x["g4"], SYNC_BLOCK, ef=x["ef4"], err=err4),
                                  (lambda v, e, r: block_quantize_int8(v, SYNC_BLOCK, ef=e, err=r),
                                   lambda: (x["g4"].clone(), x["ef4"].clone(), torch.empty_like(x["g4"])), n4 * 12),
                                  n4 * 13 + blocks4 * 4, 6 * n4, f"n=4 chunk, {n4} elements")}),
        "block_dequantize_int8": dict(
            kernel=lambda: block_dequantize_int8(q4, s4, SYNC_BLOCK, base=acc, ef=x["ef4"], out=acc),
            plain=lambda: block_dequantize_int8_reference(q4, s4, SYNC_BLOCK, 1, 0, acc, x["ef4"]),
            cold=(lambda q, sc, b, e: block_dequantize_int8(q, sc, SYNC_BLOCK, base=b, ef=e, out=b),
                  lambda: (q4.clone(), s4.clone(), x["base4"].clone(), x["ef4"].clone()), n4 * 9),
            bytes=n4 * 13 + blocks4 * 4, ops=4 * n4, shape=[n4, SYNC_BLOCK, "n=4 hop accumulate, feedback"]),
        "block_requantize_int8": dict(
            kernel=lambda: block_requantize_int8(q4, s4, x["base4"], x["ef4"], SYNC_BLOCK, err=err4),
            plain=lambda: block_requantize_int8_reference(q4, s4, x["base4"], x["ef4"], SYNC_BLOCK),
            cold=(lambda q, sc, b, e, r: block_requantize_int8(q, sc, b, e, SYNC_BLOCK, err=r), hop_copy, n4 * 13),
            bytes=n4 * 14 + blocks4 * 8, ops=10 * n4, shape=[n4, SYNC_BLOCK, "n=4 hop: accumulate, feedback, quantize"],
            extras={"unfolded_pair": (lambda: unfolded_pair(q4, s4, pair_acc, x["ef4"], err4),
                                      (unfolded_pair, hop_copy, n4 * 13), n4 * 22 + blocks4 * 8, 10 * n4,
                                      f"n=4 chunk, {n4} elements")}),
        "segment_absmax": dict(
            kernel=lambda: segment_absmax(x["flat"], x["res"], offs), plain=absmax_composed,
            cold=(lambda g, r: segment_absmax(g, r, offs), lambda: (x["flat"].clone(), x["res"].clone()), p * 8),
            bytes=p * 8 + segs * 4, ops=3 * p, shape=[segs, p, "the tower's leaves"],
            extras={"foreach_norm_inf": (foreach_norm_inf, (
                lambda *leaves: torch._foreach_norm(list(leaves), ord=float("inf")),
                lambda: tuple(t.clone() for t in pre_summed), p * 4), p * 4 + segs * 4, p,
                "torch._foreach_norm(ord=inf) over the 12 pre-summed leaves: the reduction alone, not the same "
                "function")}),
        "quantize_int8_ef_shared": dict(
            kernel=lambda: quantize_int8_ef_shared(x["flat"], res, offs, scale),
            plain=shared_composed,
            cold=(lambda g, r: quantize_int8_ef_shared(g, r, offs, scale),
                  lambda: (x["flat"].clone(), x["res"].clone()), p * 8),
            bytes=p * 16 + segs * 8, ops=6 * p, shape=[segs, p, "the tower's leaves, int32 codes"]),
    }
    rows = []
    for name, c in cases.items():
        bms, by = bound(c["bytes"], c["ops"], "float32")
        k0, p0, k1 = timings(c["kernel"]), timings(c["plain"]), timings(c["kernel"])
        cold = [cold_ms(c["cold"][0], c["cold"][1], c["cold"][2])["ms"] for _ in range(2)]
        if name == "quantize_int8_ef_shared":
            reference = timings(lambda: quantize_int8_ef_reference(x["flat"], x["res"], offs, scale=scale)[0].to(
                torch.int32))["graph"]
        else:
            reference = None
        by_path = {path: la[name] for path, la in launches.items() if la.get(name)}
        r = dict(name=name if name != "quantize_int8_ef_shared" else "quantize_int8_ef[shared scale]",
                 route="cuda", cuda_route="cuda",
                 source=SYNC_SOURCE if name.startswith("block") else K15_SOURCE, replaces=SYNC_REPLACES[name],
                 launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=errs[name],
                 shape=c["shape"], ms=min(k0["graph"], k1["graph"]), ms_runs=[k0["graph"], k1["graph"]],
                 eager_ms=min(k0["eager"], k1["eager"]), plain_ms=p0["graph"], plain_eager_ms=p0["eager"],
                 bound_ms=bms, bound_by=by, library_ms=None, composite_ms=p0["graph"], cold_ms=min(cold),
                 cold_ms_runs=cold, note="no single PyTorch call computes it; the plain version's composed calls: "
                                         "composite_ms")
        if name == "block_requantize_int8":
            r["also_replaces"] = ["persia_tpu/parallel/grad_sync.py:373", "persia_tpu/parallel/grad_sync.py:395"]
        if name == "quantize_int8_ef_shared":
            r["also_replaces"] = ["persia_tpu/parallel/grad_sync.py:295"]  # the codes' cast to int32
        if reference is not None:
            r["plain_ms"] = reference  # the loop a segment the tests hold it to; composite_ms is vectorised
        r["over_launch_floor"] = r["ms"] / min(floor)
        r["ms_over_floor"] = r["ms"] - min(floor)
        r["cold_ms_over_floor"] = r["cold_ms"] - min(floor)
        r["cold_share"] = bms / r["cold_ms"]
        print(f"  {r['name']} ({c['shape']}): warm {r['ms_runs']} ms, cold {cold} ms, bound {bms:.5f} ({by}; "
              f"{r['cold_share']:.1%} cold, {bms / r['ms']:.1%} warm), {r['over_launch_floor']:.2f}x the launch "
              f"floor; plain {r['plain_ms']:.4f} ms, composed {r['composite_ms']:.4f} ms; launches {by_path}",
              flush=True)
        for extra, (fn, (cold_fn, make, nbytes), ebytes, eops, label) in c.get("extras", {}).items():
            warm = [graph_ms(fn) for _ in range(2)]
            ecold = [cold_ms(cold_fn, make, nbytes)["ms"] for _ in range(2)]
            ebound, eby = bound(ebytes, eops, "float32")
            r.update({f"{extra}_ms": min(warm), f"{extra}_cold_ms": min(ecold), f"{extra}_bound_ms": ebound})
            print(f"  {r['name']}, {extra.replace('_', ' ')} ({label}): warm {warm} ms, cold {ecold} "
                  f"ms, bound {ebound:.5f} ({eby}; {ebound / min(ecold):.1%} cold), {min(warm) / min(floor):.2f}x "
                  f"the launch floor", flush=True)
        rows.append(r)
    return rows


def time_lp_kernels(dev, launches, errs, floor):
    """Phase 5's rows of LowPrecisionDecentralized's sync at the bench
    tower's 12 leaves (P = 341,073): K18 (``lp_ring_mix``) and K15
    (``quantize_int8_ef``, a scale a leaf, the f32 change and its residual:
    ``quantize_int8_ef[lp ring]``), graph-replayed warm and cold (whole
    copies rotated through more than the L2), beside the plain version (for
    K18 its composed PyTorch calls, no single call computing it) and the
    bound: K18 35 bytes an element (x and three shadows read and written,
    three codes read), K15 13 (the change and the residual read, the codes
    and the residual written). ``launches``: phase 4s's counted runs."""
    import torch

    from persia_tpu_torch.ops.lp_ring import lp_ring_mix, lp_ring_mix_reference
    from persia_tpu_torch.ops.quantize_int8 import quantize_int8_ef, quantize_int8_ef_reference
    from persia_tpu_torch.testing import dense_sync as tds

    sizes = sync_leaf_sizes()
    args, offsets = tds.lp_mix_inputs(sizes, dev, SEED + 130)
    p, segs = offsets[-1], len(sizes)
    x, ss = args[0], args[1]
    delta = x - ss
    res = (torch.randn(p, generator=torch.Generator().manual_seed(SEED + 131)) * 1e-6).to(dev)
    mix_in = [a.clone() for a in args]

    def mix_copy():
        return tuple(a.clone() for a in args[:7])

    cases = {
        "lp_ring_mix": dict(
            kernel=lambda: lp_ring_mix(*mix_in, offsets),
            plain=lambda: lp_ring_mix_reference(*args, offsets),
            cold=(lambda *t: lp_ring_mix(*t, *args[7:], offsets), mix_copy, p * 35),
            bytes=p * 35 + segs * 12, ops=12 * p, source=LP_SOURCE, replaces=LP_REPLACES,
            shape=[segs, p, "the tower's leaves: x and three shadows, three codes"]),
        "quantize_int8_ef[lp ring]": dict(
            kernel=lambda: quantize_int8_ef(delta, res, offsets),
            plain=lambda: quantize_int8_ef_reference(delta, res, offsets),
            cold=(lambda g, r: quantize_int8_ef(g, r, offsets), lambda: (delta.clone(), res.clone()), p * 8),
            bytes=p * 13 + segs * 4, ops=6 * p, source=K15_SOURCE, replaces=K15_REPLACES,
            shape=[segs, p, "the tower's leaves, f32: LowPrecisionDecentralized's change"]),
    }
    rows = []
    for name, c in cases.items():
        base = name.split("[")[0]
        bms, by = bound(c["bytes"], c["ops"], "float32")
        p0, k0, k1, p1 = timings(c["plain"]), timings(c["kernel"]), timings(c["kernel"]), timings(c["plain"])
        cold = [cold_ms(*c["cold"])["ms"] for _ in range(2)]
        by_path = {path: la[base] for path, la in launches.items() if la.get(base)}
        r = dict(name=name, route="cuda", cuda_route="cuda", source=c["source"], replaces=c["replaces"],
                 launches=sum(by_path.values()), launches_by_path=by_path, max_abs_err=errs[base],
                 shape=c["shape"], ms=min(k0["graph"], k1["graph"]), ms_runs=[k0["graph"], k1["graph"]],
                 eager_ms=min(k0["eager"], k1["eager"]), plain_ms=min(p0["graph"], p1["graph"]),
                 plain_eager_ms=min(p0["eager"], p1["eager"]), bound_ms=bms, bound_by=by, library_ms=None,
                 composite_ms=min(p0["graph"], p1["graph"]), cold_ms=min(cold), cold_ms_runs=cold,
                 note="no single PyTorch call computes it; the plain version's composed calls: composite_ms")
        if name == "lp_ring_mix":
            r["also_replaces"] = ["persia_tpu/parallel/grad_sync.py:446", "persia_tpu/parallel/grad_sync.py:451",
                                  "persia_tpu/parallel/grad_sync.py:452", "persia_tpu/parallel/grad_sync.py:453"]
        r["over_launch_floor"] = r["ms"] / min(floor)
        r["ms_over_floor"] = r["ms"] - min(floor)
        r["cold_ms_over_floor"] = r["cold_ms"] - min(floor)
        r["cold_share"] = bms / r["cold_ms"]
        print(f"  {name} ({c['shape']}): warm {r['ms_runs']} ms, cold {cold} ms, bound {bms:.5f} ({by}; "
              f"{r['cold_share']:.1%} cold, {bms / r['ms']:.1%} warm), {r['over_launch_floor']:.2f}x the launch "
              f"floor; plain {r['plain_ms']:.4f} ms; launches {by_path}", flush=True)
        rows.append(r)
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--ab"]:
        return ab_run(sys.argv[2], sys.argv[3], *sys.argv[4:5])
    if sys.argv[1:2] == ["--stream-ab"]:
        return stream_ab(int(sys.argv[2]))
    import persia_tpu_torch  # noqa: F401  (fails where the package is absent)

    torch.backends.cuda.matmul.allow_tf32 = False  # f32 plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = card_line()
    print(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}", flush=True)

    seconds = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        try:
            return fn(*args)
        finally:
            seconds[name] = time.perf_counter() - t
            print(f"-- {name}: {seconds[name]:.1f} s", flush=True)

    build = phase("1", phase_build)
    errs = {"flash_attention": phase("2", phase_flash_attention, dev), **phase("3", phase_kernels, dev),
            **phase("3b", phase_fused_kernels, dev)}
    phase("3b (1TB)", phase_fused_1tb_kernels, dev)
    errs.update({**phase("3c", phase_din_kernels, dev), **phase("3d", phase_bn_kernels, dev),
                 **phase("3e", phase_cache_kernels, dev), **phase("3f", phase_quant_kernels, dev),
                 **phase("3g", phase_precision_kernels, dev), **phase("3h", phase_sync_kernels, dev),
                 **phase("3i", phase_lp_kernels, dev)})
    fa_routes = phase("4a", path_flash_attention, dev)
    serving_launches, serving, feats_shape = phase("4b", path_serving, dev)
    training_launches, training, train_batch = phase("4c", path_training, dev)
    pipelined_launches, pipelined = phase("4d", path_pipelined, dev)
    fused_launches, fused_capture_launches, fused, fused_inputs = phase("4e", path_fused, dev)
    durable_launches, durable = phase("4f", path_durable, dev)
    din_launches, din, din_batch = phase("4g-4h", path_din, dev)
    avazu_launches, avazu = phase("4i", path_avazu, dev)
    fanout = phase("4i (fan-out)", fanout_timing, dev)
    dnn_launches, dnn = phase("4j", path_dnn, dev)
    cache_launches, cache, cache_inputs = phase("4k (cache)", path_cache, dev)
    mixed_launches, mixed, k15 = phase("4k (mixed)", path_mixed, dev)
    launches = {"flash_attention": fa_routes, "serving": serving_launches,
                "training": training_launches, "pipelined": pipelined_launches,
                "durable": durable_launches, "fused": fused_launches, "fused_capture": fused_capture_launches,
                **din_launches, **dnn_launches, **cache_launches, **mixed_launches}
    profiler_before = profiler_records_device_work(dev)
    print(f"  a profiler session before phase 5 records device work: {profiler_before}", flush=True)
    t5 = time.perf_counter()
    rows, floor = phase_timing(dev, card, launches, errs, feats_shape, train_batch, fused_inputs, din_batch, build)
    rows += time_cache_kernels(dev, launches, errs, cache_inputs, floor, build)
    rows += time_k15(dev, launches, errs, k15, floor)
    time_flash_backward(dev, card)
    seconds["5"] = time.perf_counter() - t5
    print(f"-- 5: {seconds['5']:.1f} s", flush=True)
    del fused_inputs, k15, train_batch, din_batch
    # phases 4o-4p and 4l-4n after phase 5's traces: in a run with either
    # before it, phase 5's traces held no device events; whether a profiler
    # session records device work before phase 5, after 4o-4p and after
    # 4l-4n is printed, not held; 4o-4p's own traces say whether they held
    # device events. The new variants' rows of phase 5 are timed after 4p,
    # K12, its read and K13 at the f32 rows' inputs, K15 at 4p's
    fused_models_launches, fused_models = phase("4o", path_fused_models, dev)
    prec_launches, prec, prec_k15 = phase("4p", path_precision, dev)
    rows += phase("5 (precision)", time_precision_kernels, dev, prec_launches, errs, cache_inputs, prec_k15, floor)
    del cache_inputs, prec_k15
    profiler_mid = profiler_records_device_work(dev)
    print(f"  a profiler session after phases 4o-4p records device work: {profiler_mid}", flush=True)
    criteo_launches, criteo = phase("4l", path_criteo, dev)
    h100t_launches, h100t = phase("4m", path_100t, dev)
    quality_launches, quality = phase("4n", path_quality, dev)
    phase("5 (1TB)", time_fused_1tb, dev, rows)
    profiler_after = profiler_records_device_work(dev)
    print(f"  a profiler session after phases 4l-4n records device work: {profiler_after}", flush=True)
    feeder_launches, feeder = phase("4q", path_sharded_feeder, dev)
    sync_launches, dense_sync, sync_inputs_ = phase("4r", path_dense_sync, dev)
    divergent_launches, divergent = phase("4s", path_divergent_sync, dev)
    rows += phase("5 (dense sync)", lambda: time_sync_kernels(dev, {**sync_launches, **divergent_launches}, errs,
                                                              sync_inputs_, floor)
                  + time_lp_kernels(dev, divergent_launches, errs, floor))
    del sync_inputs_
    new_paths = {**fused_models_launches, **prec_launches, **criteo_launches, **h100t_launches, **quality_launches,
                 **feeder_launches, **sync_launches, **divergent_launches}
    launches.update(new_paths)
    # the launches the new paths' counted runs made of each kernel
    for r in rows:
        by_path = {p: la[r["name"]] for p, la in new_paths.items() if la.get(r["name"])}
        if by_path:
            r["launches_by_path"] = {**(r.get("launches_by_path") or {}), **by_path}
    print(json.dumps({"serving": serving, "card": card}), flush=True)
    print(json.dumps({"training": training, "card": card}), flush=True)
    print(json.dumps({"pipelined": pipelined, "card": card}), flush=True)
    print(json.dumps({"durable": durable, "card": card}), flush=True)
    print(json.dumps({"build": build, "card": card}), flush=True)
    print(json.dumps({"fused": fused, "card": card}), flush=True)
    print(json.dumps({"din": din, "card": card}), flush=True)
    print(json.dumps({"avazu": avazu, "avazu_launches": avazu_launches, "card": card}), flush=True)
    print(json.dumps({"dnn": dnn, "dnn_launches": dnn_launches, "card": card}), flush=True)
    print(json.dumps({"cache": cache, "cache_launches": cache_launches, "card": card}), flush=True)
    print(json.dumps({"mixed": mixed, "mixed_launches": mixed_launches, "card": card}), flush=True)
    print(json.dumps({"fused_models": fused_models, "fused_models_launches": fused_models_launches, "card": card}),
          flush=True)
    print(json.dumps({"precision": prec, "precision_launches": prec_launches, "card": card}), flush=True)
    print(json.dumps({"fanout": fanout, "card": card}), flush=True)
    print(json.dumps({"criteo": criteo, "card": card}), flush=True)
    print(json.dumps({"synthetic_100t": h100t, "card": card}), flush=True)
    print(json.dumps({"quality": quality, "card": card}), flush=True)
    print(json.dumps({"sharded_feeder": feeder, "card": card}), flush=True)
    print(json.dumps({"dense_sync": dense_sync, "card": card}), flush=True)
    print(json.dumps({"divergent_sync": divergent, "card": card}), flush=True)
    print(json.dumps({"phase_seconds": seconds, "profiler_records_device_work": {
        "before_phase_5": profiler_before, "after_4o_4p": profiler_mid, "after_4l_4n": profiler_after},
        "card": card}), flush=True)

    # one entry per kernel (each flash-attention route by its non-causal
    # row); times graph-replayed, eager beside them
    keys = ("name", "route", "cuda_route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "eager_ms",
            "library_eager_ms", "cold_ms", "library_cold_ms", "sort_ms", "zipf_ms", "zipf_cold_ms",
            "zipf_bound_ms", "zipf_sort_ms", "longest_segment", "zipf_longest_segment", "one_row_ms",
            "composite_ms", "registers", "over_launch_floor", "no_keys_ms", "no_keys_cold_ms", "routing_cost_ms",
            "c32_ms", "eval_256_ms", "ring_ms", "also_replaces", "note", "restores_ms", "no_restores_ms",
            "unfolded_pair_ms", "unfolded_pair_cold_ms", "unfolded_pair_bound_ms", "hop_chunk_ms",
            "hop_chunk_cold_ms", "hop_chunk_bound_ms", "restores_bound_ms", "launches_by_path", "composite_kernels",
            "composite_bitwise",
            "plan", "ms_over_floor", "cold_ms_over_floor", "at_1tb", "f32_pool_same_inputs_ms",
            "f32_pool_same_inputs_cold_ms", "ungated_same_inputs_ms", "ungated_same_inputs_cold_ms")
    kernels = [{k: r.get(k) for k in keys} for r in rows if not r.get("causal")]
    print(json.dumps({"kernels": kernels, "launch_floor_ms": floor, "card": card}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(ab_compare(sys.argv[2:]) if sys.argv[1:2] == ["--ab-compare"] else main())
