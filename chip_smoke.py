"""Chip smoke test of pipe_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own line(s); any failure raises and the script
exits non-zero without a result line:

1. device  -- the card (nvidia-smi name and power limit), torch and CUDA
   versions; TF32 off for matmul and cuDNN, so fp32 means fp32.
2. build   -- nvcc builds every kernel source of the package for sm_90a;
   per kernel instance, ptxas's registers and spill, and the count of
   tensor-core instructions (HMMA/HGMMA) and asynchronous copies
   (LDGSTS/UTMALDG) in its SASS (cuobjdump): every instance of the forward,
   dQ and dK/dV kernels must show both.
3. kernels -- each kernel (flash forward, dQ, dK/dV) against its plain
   PyTorch version on the card at the shapes the main paths give it
   (GPT-2-small's (24, 1024, 64) causal with dropout 0.1 and BERT-large's
   (16, 512, 64) non-causal with dropout 0.1 among them, timed as the
   tutorial LM's training shape is, with the grid's blocks beside the
   card's SMs) and a few more, with and
   without attention dropout (the plain versions fed the same Philox mask),
   with its time, the plain version's, one PyTorch library
   call's, and the least time the card could take (bytes or operations over
   the H100's peak rates). Same seed, same bits: each kernel run twice.
   SDPA is timed beside the forward with and without dropout, and its
   backward five times with dropout and five times without, with their
   spread.
4. slice   -- the eval path: the tutorial Transformer LM at full width
   (d_model 2048, 32 heads, d_ff 2048, 16 layers, bptt 128, random weights
   from a seed) through ``Pipe(chunks=4, n_stages=2)`` in eval mode over 4
   batches of the tutorial text pipeline. The flash kernel must be launched
   16 layers x 4 chunks x 4 batches times, and the logits and losses must
   agree with a twin that runs plain attention on the same weights.
5. train   -- the training path: ``Trainer`` over the same LM with dropout
   0.2 (batch 32, bptt 128, chunks 4, 2 stages, except_last, lr 1e-4) for 8
   steps; the forward kernel must be launched 8 x 112 times (64 forwards and
   48 recomputes a step), dQ and dK/dV 8 x 64 times each; every loss finite,
   the last below the first. Then twins at dropout 0: one step's loss and
   gradients with the kernels and with plain attention on the same weights,
   each held to plain attention in float64.
5h. train_obs -- the rest of the one-device training path over the train
   phase's LM and trainer (batch 32, chunks 4, 2 stages, except_last, lr
   1e-4, dropout 0.2, 8 steps logged every 4). (a) ``Trainer`` plain, with
   ``telemetry_dir``, and with ``telemetry_dir``, ``tb_dir``,
   ``profile_every=4`` and ``prefetch_depth=2``: losses equal bit for bit and
   the three kernels' launches equal; 8 StepReports whose walls over steps
   2-8 sum to within 5% of the loop's elapsed time; every report's
   0 < MFU <= HFU < 1 (the card's fp32 peak, ``n_devices=1``), printed with
   the steady-state MFU/HFU beside the prediction; the report's peak equals
   ``max_memory_allocated``; every TensorBoard record passes its masked
   CRC32C and the file holds every tag ``pipe_tpu`` writes; ``trace_step4``
   gives a ``cuda`` timeline with all 4 x 2 (chunk, stage) cells whose busy
   time is at most the traced wall (measured bubble, device idle share and
   analytic bubble printed); the native prefetcher is taken and its batches
   are ``get_batch``'s. Prints each run's ms per step, train tokens/s and
   peak, and the telemetry cost of an unprofiled step. (b) ``profile_model``
   over the LM's ``Sequential`` (per-layer forward and backward ms);
   ``auto_plan`` at 2 devices, its profile fitted to whole steps at m 2, 4
   and 8 (``fit_step_costs``: each step the larger of the device's work
   and the host's per-cycle overhead; the fitted overhead, scale, residual
   and model printed), after checking that (a) left nothing alive (its
   TensorBoard writer and event log closed, no profiler running, every
   prefetcher's producer freed; the live threads and allocated bytes
   printed): ``Pipe(plan=...)``'s step loss equals the hand-built
   ``Pipe``'s bit for bit; the winner's and the runners-up's predicted ms against measured
   (the first runner-up and the first with another m), and the winner's
   best step is at most 5% over each runner-up's; ``Trainer(plan="auto")``'s
   plan line. (c)
   ``resilience=ResilienceConfig(warmup_steps=2)`` without faults: losses
   and launches equal the plain run's; with ``nan_grads`` at step 3,
   ``loss_spike`` at 5 and ``data_raise`` at 6: both skipped steps leave
   parameters, both Adam moments and Adam's step count bitwise unchanged,
   the data fault is retried once and no step is lost; persistent
   ``nan_grads`` rewinds once and raises ``TrainingAborted``. Prints the
   guarded step's ms, with the verdict read every step and every 8, against
   the plain step's. (d) SIGTERM during step 3
   with ``install_autosave``: 3 steps, a checkpoint; a new trainer restored
   from it takes steps 4-8 with the plain run's losses, bit for bit.
5b. schedules -- the table executor (``parallel/scheduled.py``) over the
   same LM at full width, with the kernels. (a) Dropout 0: one step of the
   gpipe, 1f1b and zb-h1 tables under except_last and under never (zb-h1
   under never twice: the stored-graph split, ``split_stage=None``, and
   the structural split, ``split_stage="auto"``), from one set of weights,
   against the emulator ``Pipe`` path's ``lm_loss`` backward: loss within
   1e-5 relative, every gradient within 1e-4 x max(1, max|g|); the
   structural twin within the same bounds of the stored-graph twin too,
   its dQ and dK/dV launched 64 times (2 stages x 4 micro-batches x 8
   layers). (b) Dropout 0.2: 5 ``Trainer`` steps each of the table gpipe
   (except_last), 1f1b (except_last), zb-h1 (never: the Trainer's
   structural split, and the stored-graph split) and 1f1b (never, zb-h1's
   yardstick): losses finite, every trajectory within 1e-4 relative of
   the table gpipe's (one seed, the same masks). (c) Each run's forward, dQ
   and dK/dV launches equal what its tables imply (``stage_passes`` x 8
   layers a stage), pinned exactly; one micro-batch of stage 1 under
   ``core.remat.count_dots``: the tapped forward dispatches the plain
   forward's matrix products, W exactly the 48 weight-gradient products
   (6 a block), B the fused backward's less those, and W launches neither
   dQ nor dK/dV; each pass's host time to enqueue it and time to the end
   of its device work (least of 5). (d) Under never, one step's peak
   memory for the emulator gpipe, the table gpipe and the table 1f1b
   (after a warm-up step, Adam state resident): 1f1b's below the table
   gpipe's. (e) Per schedule: ms
   per step (mean of steps 2-8, each ending in a synchronize), train
   tokens/s and peak bytes, with ``memory_plan``, and per step the
   allocator's new device segments (``num_device_alloc``), the garbage
   collector's pauses and the bytes still allocated at its end; under
   never, the forward-only walk's ms
   (``ScheduledPipeline.forward``, mean of 3 after one) and sigma = (step -
   walk) / (1f1b/never's step - its walk) of both splits.
5c. gpt2 -- GPT-2-small at its published width (vocab 50,257, d_model 768,
   12 heads, d_ff 3,072, 12 layers, seq 1,024, dropout 0.1; untied head,
   ~163.0M parameters; random weights and tokens from seeds) built with the
   embedding skip, through ``Pipe(chunks=16, balance=[4, 4, 4, 4])``: embed
   + stash + blocks 0-1 | 2-5 | 6-9 | 10-11 + join + head, batch 32.
   (a) Dropout 0: one emulator step (except_last; the loss is ``per_row_ce``
   of the gathered logits) with the kernels, with plain attention and with
   plain attention in float64 on the same weights, held as the train
   phase's twins. (b) From those weights, one ``HeteroScheduledPipeline``
   step of the gpipe and 1f1b tables under except_last and under never:
   loss within 1e-5 relative and every gradient (``wte``/``wpe`` among them,
   fed partly through the skip lane) within 1e-4 x max(1, max|g|) of the
   emulator's; ``memory_plan`` reports one skip lane and its park slots.
   (c) Dropout 0.1: 3 steps each of the emulator and of the 1f1b table with
   the lane (except_last), Adam at lr 1e-4, one seed: every loss finite, the
   trajectories within 1e-4 relative (the table walk folds seeds as the
   emulator's ``ctx.fold(i, j)``, so the masks are the same). (d) Every
   run's forward, dQ and dK/dV launches pinned exactly to what it implies
   (per stage, 16 forwards plus the recomputes and 16 backwards, times the
   12 blocks): the emulator's 372 / 192 / 192 a step under except_last.
   (e) ``apps.zoo``'s ``train`` over ``["gpt2", "--stages", "4",
   "--chunks", "16", "--batch", "32", "--schedule", "1f1b", "--steps",
   "3"]``: finite losses, kept for phase 14; its ms per step is printed. (f) A 4-stage stack of
   (Linear 1024 -> BatchNorm -> ReLU) x 4, chunks 8, batch 256, through
   ``Pipe(deferred_batch_norm=True)`` and the 1f1b table: the running stats
   after one step equal one whole-batch momentum update within 1e-5; zb-h1
   is refused. (g) Prints ms per step (mean of steps 2-8, each ending in a
   synchronize), train tokens/s and peak bytes of the (c) runs, and one
   step's ms and peak under never of the emulator, the table gpipe and the
   table 1f1b.
5d. remat -- ``remat_policy`` on the tutorial LM at full width through the
   1f1b table under except_last, kernels on. (a) Dropout 0, one set of
   weights: the table's step with ``dots_saveable`` against the same step
   without a policy, and the emulator ``Pipe`` called with
   ``remat_policy="dots_saveable"`` against its policy-free step: loss within
   1e-5 relative, every gradient within 1e-4 x max(1, max|g|); forward, dQ
   and dK/dV launches equal with and without the policy and pinned to
   ``stage_passes`` x 8 layers; fewer matrix products dispatched under the
   policy (``core.remat.count_dots``). (b) Dropout 0.2: 3 ``Trainer`` steps
   of the 1f1b table without, with, with and without the policy (in turns):
   launches pinned, trajectories within 1e-4 of each other; ms per step,
   train tokens/s and peak bytes of each. In this phase and the three
   after it each peak is printed beside the bytes still allocated when it
   was reset (``resident_bytes``), which it counts too.
5e. gpt2_serve -- GPT-2-small at full width (random weights from a seed,
   fp32) served by ``ServeEngine`` over ``SingleDeviceSlotBackend`` with 8
   slots: 12 greedy requests of 16-128 random tokens and 32-64 new tokens,
   through the slab tick, the paged pool (blocks of 16, resident loop) and
   the n-gram speculative lane (K 4, resident). Gates: every request
   ``ok`` to its length; each stream equals the port's batch-1
   ``Generator`` token for token up to the first step where the
   reference's top-2 margin is under 1e-4 (a near tie; counted); the
   reference's tokens are the argmax of a naive re-forward of the whole
   sequence wherever that margin exceeds 1e-4; no flash launch by the
   engine; ``apps.generate --family gpt2`` and ``apps.serve --family gpt2``
   exit 0 at full width. Each engine serves the traffic twice (the first
   run captures its programs); prints TTFT p50/p99 and generated tokens/s of
   each run.
5f. bert -- BERT-large at its published width (vocab 30,522, d_model 1,024,
   16 heads, d_ff 4,096, 24 layers, seq 512, dropout 0.1; untied MLM
   projection), BASELINE config #4's composition on one device: 8 stages
   x interleave 3 (24 virtual stages of one block) through the
   interleaved-1F1B table, chunks 32, batch 32, except_last, Adam at lr
   1e-4. (a) Dropout 0: one step with the kernels, with plain attention and
   with plain attention in float64 on the same weights, held as the train
   phase's twins. (b) From the same weights, one step of the table gpipe
   over the 24 stages: loss within 1e-5 relative and every gradient within
   1e-4 x max(1, max|g|) of the interleaved table's. (c) ``apps.zoo bert
   --stages 8 --interleave 3 --schedule interleaved-1f1b --chunks 32
   --batch 32 --lr 1e-4``: 2 dropout-0.1 steps, every loss finite. (d)
   Its forward, dQ and dK/dV launches pinned to ``stage_passes``: 24 x (32
   + 31) forwards and 768 each of dQ and dK/dV a step. (e) The zoo's first
   step again with ``remat_policy="dots_saveable"``: trajectory within
   1e-4 of the zoo's, launches equal; ms per step, train tokens/s and peak
   bytes of both.
5g. vit -- ViT-L/16 at its published width (224 x 224 x 3, patch 16, 197
   tokens, d_model 1,024, 24 layers, 1,000 classes, dropout 0.1). (a)
   ``apps.zoo vit --stages 8 --chunks 8 --batch 32 --lr 1e-4``: 4 steps,
   every loss finite, no kernel launch (197 tokens fail ``supports()``, so
   every block takes plain attention, as ``pipe_tpu``'s gate chooses); ms
   per step. (b) ``Pipe(balance=[3, 3, 3, 3, 3, 3, 3, 5], chunks=8)``
   (embed + 2 blocks | 3 blocks x 6 | 4 blocks + head): one dropout-0.1 step
   of the emulator and one of the hetero 1f1b table from the same weights
   and seed: loss within 1e-5 relative, every gradient within 1e-4 x
   max(1, max|g|), no kernel launch; ms of each step.
6. generate -- KV-cached generation (``Generator`` over
   ``PipelinedLM.from_sequential`` of the eval slice's weights): batch 8
   prompts of 128 eval tokens, 128 new tokens. Gates: teacher-forced cached
   logits of a fixed 256-token sequence within TOL_LOGITS of the ``Pipe``
   eval forward through the flash kernel (64 launches); greedy tokens equal
   that forward's argmax on their own sequence wherever its top-2 margin is
   wide; EOS gives the first-EOS length and pad after it; beam scores (k 4,
   batch 2) equal the forward's sequence log-probs and are no worse than
   greedy's; the same seed samples the same tokens and another seed others,
   each in the top 50 of its logits; int8 logits within 0.08 relative of
   fp32. Prints prefill ms, decode ms per step against its bound (weights
   and the whole cache read once at 3.35 TB/s), generated tokens/s, peak
   memory and KV-cache bytes, for fp32 and int8 (timed from a second call;
   the first call's wall beside it). The decode attention is
   plain, as in ``pipe_tpu``: the generator launches no kernel.

7. serve -- continuous batching (``ServeEngine`` over
   ``SingleDeviceSlotBackend``: 8 slots, 256 cache rows, buckets 16 to 128,
   one decode step a tick captured once in a CUDA graph) over the eval
   weights: 16 greedy requests of 16-128 eval tokens and 32-128 new tokens
   (a seeded rng), four before the first tick and then two a tick, served
   twice (cold: the capture; warm). Gates: every request runs to its
   length; the decode step is captured exactly once over both runs; one
   prefill shape per bucket touched; no flash launch in the engine; every
   response equals a batch-1 ``Generator`` on its prompt wherever the
   reference's top-2 margin exceeds 10 x the generate phase's
   teacher-forced gap (near ties skipped and counted); the same engine run
   eagerly on the card gives the graph's tokens; an EOS that request 0
   emits retires it there with nothing after it; 8 sampled requests (T 0.8,
   top-k 50) give the same tokens alone in a 1-slot engine, among 32
   co-tenants and again, each pick inside the top 50. Prints TTFT p50/p99,
   generated tokens/s over the wall, decode ms per tick (graph and eager,
   in turns) against its bound, launch calls and kernels per tick
   (``torch.profiler``), prefill ms per bucket, peak memory, seconds. The
   engine runs the single-chunk tick here (``resident=False``); prefill is
   one CUDA graph per bucket.

8. paged -- the paged KV pool (blocks of 16 rows, 129 blocks) and the
   resident loop (8 chunks a launch) over the serve phase's model and
   traffic, reusing its batch-1 references. Gates: (a) every request runs
   to its length and greedy tokens equal the references at clear steps;
   (b) one decode and one prefill-chunk capture over every prompt length;
   (c) 8 requests behind a shared 64-token prefix hit the cache and fork a
   shared block, with the tokens of a cache-off run at clear steps; (d) a
   serial run on a 48-block pool with host offload restores blocks and
   gives the tokens of a pool where nothing is evicted, bit for bit; (e)
   int8 KV rows agree with the fp32 forward's argmax on at least 0.8 of
   greedy steps (teacher-forced on the int8 stream; the position-wise
   agreement with the fp32 run is printed beside it); (f) ``resident=
   "auto"`` is the resident loop on the card, and resident tokens equal
   the tick path's bit for bit, slab and paged, greedy, sampled and with
   EOS; (g) one regather decision per admission, none per launch; (h) the
   pool drains. Prints TTFT p50/p99 and tokens/s paged, resident and slab
   resident; decode ms per step (and per token) for the slab graph, the
   paged graph and a resident launch of 8 chunks, with launch calls,
   kernels and device busy time per launch; ghost chunks per launch;
   prefill ms of a 128-token prompt, slab bucket graph against paged
   chunks; pool, view and peak memory bytes.

9. spec -- the speculative lane (K 4, 8 rounds a launch, 272 cache rows)
   over the serve phase's model: n-gram (slab and paged), truncated (the
   first 8 of 16 layers, slab), tree (2 branches, paged) and n-gram on the
   adaptive ladder 2/3/4 (slab), each over the serve phase's 16 greedy
   requests and 8 greedy requests whose 128-token prompts repeat one
   16-token span of eval text, n-gram slab and tree paged over its 8
   sampled requests too. Gates: (a) greedy and sampled tokens
   equal the non-spec resident path's (the paged phase's runs; a warm run
   of the repeated spans) at clear steps, every request to its length;
   (b) one capture per rung, and a second drive captures nothing and gives
   the same tokens; (c) emitted >= rounds and >= tokens - requests; (d) an
   EOS retires where the non-spec run does; (e) graph = eager bit for bit,
   slab and paged; (f) ``validate`` names the speculative headroom; (g) the
   pool drains; (h) no flash launch by the engine. Prints, per run, rounds,
   tokens per round (serve and repeat traffic), acceptance, accept-length
   histogram, draft cost, ghost rounds per launch, capture seconds,
   tokens/s and TTFT p50/p99 beside the non-spec resident path, and per
   rung the ms and device-busy ms per round with every slot live, kernels
   and launch calls per launch, peak memory.

10. fleet -- the serving fleet on one card (``pipe_tpu_torch/fleet``,
   ``serve/router.py``, ``obs/fleet_obs.py``) over the tutorial LM at full
   width (the eval weights, drawn again from the seed by every child): 24
   greedy requests of 128 tokens whose first 64 are one of 4 shared
   prefixes, 64 new tokens each, all at once; replicas of 4 slots, paged
   (16-row blocks, 96 blocks), resident. The reference is one engine on the
   same traffic; a stream passes where it equals the reference's under the
   serve phase's near-tie rule. Gates: (a) 3 replicas in this process,
   serial ticks and one tick thread each (``Router(async_tick=True)``): the
   streams pass, every request ``ok`` and delivered once; (b) 3 child
   processes on the card (``ProcessReplicaTransport``; the children report
   the JSON codec): the streams pass; then one child is SIGKILLed while it
   holds work: every id once and ``ok``, 2 replicas healthy and 1 retired;
   (c) roles prefill, decode, decode as processes (a survivor of (b) the
   mixed fallback): the decode children import prefix blocks
   (``serve.kv.prefix_imported``); the decode runs over prefix rows the
   wire shipped as int8, so, as the paged phase holds int8 KV rows, every
   stream's tokens agree with the fp32 forward's argmax on its own stream
   on at least 0.8 of steps (the first token's logit change over an
   imported int8 prefix against a cold prefill is printed); then the
   prefill child is SIGKILLed mid-handoff: every id once; (d) a journaled
   controller over two fresh children is dropped mid-flight and rebuilt
   with ``FleetController.from_journal``, re-dialing the running children:
   the pre-crash terminals and the recovered deliveries partition the ids;
   (e) a ``wire_corrupt`` storm and a ``wire_partition`` on a survivor's
   wire: CRC rejects counted, every id once; (f) ``slow_replica`` sleeps
   inside replica 0's decode for 3 router ticks over a 0.5 s tick budget:
   ``resilience.watchdog_slow_ticks`` rises by exactly 3 and the replica
   walks healthy, suspect, healthy; (g) over (b)'s clean run, the
   ``--metrics-port`` server: ``/metrics`` holds every replica's
   ``serve.fleet.replica.*`` series and the children's shipped
   ``serve.engine.*`` counters, ``/fleet`` one view per replica, the
   per-replica ``tokens_out`` sum to the tokens delivered, and every
   request's stitched trace holds its delivery and its child's terminal
   record; (h) a ``transport_drop`` on the eval ``Pipe``'s hop for
   micro-batch 1 (the emulator run directly): that micro-batch differs and
   the others equal the clean run bit for bit, ``HopHealth`` streaks as
   planned (and a ``persistent_hop_drop`` marks the hop dead), 64 forward
   launches without a plan. Prints generated tokens/s and TTFT p50/p99 of
   1 engine and of 3 replicas serial, threaded and as processes,
   spawn-to-ready and peak bytes per child, the handoff's bytes, JSON frame
   and ms against a re-prefill, and the failover rates.

11. mesh -- the tutorial LM at full width (random weights from one seed,
   dropout 0.2, batch 32, chunks 4, lr 1e-4) over a world of 4 ranks on the
   one card (2 stages x 2 data, gloo, CUDA tensors staged through pinned
   host memory; ``runtime.distributed.World``, kernels built once before the
   spawn). The weights are drawn once, saved, and read by every rank and by
   the one-device twins, which run before the ranks exist. Gates: (a) one
   step of the Trainer's executors (``SpmdPipeline`` for gpipe,
   ``ScheduledPipeline`` for 1f1b) and of ``Pipe(mesh=)`` (gpipe and 1f1b
   tables), except_last, against the one-device table executors over the
   same weights and seed (C.16: each data rank draws its rows of the whole
   micro-batch's masks): loss within 1e-5 relative, every gradient within
   1e-4 x max(1, max|g|); (b) eval logits through ``SpmdPipeline`` and
   ``Pipe(mesh=)`` against the one-device ``Pipe`` eval, within the same
   bound; (c) each rank's forward, dQ and dK/dV launches equal to its
   column of the tables (``stage_passes(column=)`` x 8 layers); (e) one
   step of the Trainer's zb-h1 under never (the structural B/W split, W on
   each rank's own column) against the one-device table executor with
   ``split_stage="auto"``, within (a)'s bounds, launches as (c); (d) 4
   ``Trainer`` steps with ``zero=True`` (1f1b) with finite, falling losses,
   its parameters after 3 steps within the gradient bound of the plain
   Adam's, and ``apps.lm_tutorial``'s ranks (``--world 4 --schedule
   interleaved``, at its full 16 layers) over the phase's world for 4
   steps with finite, falling losses on every rank. The model of gates
   (a)-(c) and (e) and of ZeRO is the full width cut to 8 layers
   (``MESH_LAYERS``). The Trainer's 1f1b and zb-h1 tables and
   ``Pipe(mesh=)``'s run phase-compiled (the auto setting on CUDA ranks);
   the gpipe ``SpmdPipeline`` stays serialized, as ``pipe_tpu``'s. Prints, per rank, ms per
   step, the bytes and host seconds of the point-to-point exchanges and of
   the all-reduces, the staged bytes, peak bytes, spawn-to-ready time and
   the backend, beside the card's name and power limit; the kernels phase
   times the kernels at the data ranks' shape (128, 128, 64) causal with
   dropout 0.2 (``mesh_shape``) and checks ``bh_base``.

12. ring -- the tutorial LM at full width (``LMConfig`` defaults, random
   weights from one seed) cut to 8 layers, 2 a stage, over a ring of 4 stage
   ranks on the one card (gloo, CUDA tensors staged through pinned host
   memory). (a) The world trains 2 ``Trainer`` steps (1f1b, except_last,
   dropout 0.2, batch 32, chunks 4, lr 1e-4): losses finite, each rank's
   forward, dQ and dK/dV launches equal to its column of the table
   (``stage_passes(column=)`` x 2 layers x 2 steps). (b) On those
   stage-sharded weights, greedy, batch 8 (2 rows a ring group) x 128
   prompt tokens of the corpus, 64 new: ``Trainer.generate`` over the mesh
   (the model gathered over the stage group, the one-device ``Generator``
   on every rank) equals the ``Generator`` on the gathered weights bit for
   bit, and ``PipelinedGenerator`` over the ring, where the weights lie,
   equals it under the near-tie rule. (c) ``RingSlotBackend`` under
   ``ServeEngine`` on the same weights (the engine on the rank of stage 0,
   the others following): 8 requests of 32-128 corpus tokens, four before
   the first tick and then two a tick, 64 new each, 6 greedy and 2
   sampled (T 0.8, top-k 50), through the slab tick, the paged pool
   (blocks of 16) with the resident loop, and the n-gram spec lane (K 4,
   resident): every request ``ok``, one decode (or resident) trace per
   backend, and every stream equal to the one-device engine's with the
   same configuration on the gathered weights under the near-tie rule.
   (d) The ranks of ``apps.generate --stages 4`` (rank 0 returns its 8
   rows of 16 tokens) and of ``apps.serve --stages 4`` (rank 0 exits 0)
   at full width, over the phase's world (since PR 19; an app spawning its
   own world runs in phase 15). The near-tie rule: a stream may depart from its
   reference only at a step where the reference's top-2 scores lie within
   1e-4 x max|score| (the logits, or for sampled streams the keyed
   Gumbel-max scores); departures are counted and printed. Prints per
   rank: ms per generated token of the ring decoder, cycles per decode
   call, ring bytes and messages, staged bytes, p2p seconds, peak bytes,
   spawn-to-ready; per serve run TTFT p50/p99 and tokens/s beside the
   one-device engine's and PR 13's 1,126.3.

13. elastic -- elastic training over a world of 4 ranks on the one card
   (gloo): the tutorial LM at full width (d_model 2048, 32 heads, d_ff
   2048, bptt 128, the corpus's vocabulary, random weights from one seed,
   dropout 0.2, batch 32, chunks 4, 1f1b, except_last, lr 1e-4) cut to 12
   layers, ``pipe_tpu``'s drill geometry: a uniform regroup from n to n-1
   stages needs the layers to divide by both, with n-1 >= 2, and the
   tutorial's 16 divide by no such pair. ``ElasticConfig(snapshot_every=3,
   dead_after=2)`` over 4 stage ranks, a ``kill_stage`` fault on stage 1
   at step 6, 10 steps under ``train_elastic``. Gates: (a) one re-plan:
   stage 1, snapshot 5, detected 7, resume 6, 3 stages; the rank of stage
   1 retires. (b) The recovered run's losses, parameters and Adam moments
   equal, bit for bit, a reference on the same 3 survivor ranks that
   trains the unkilled 4-stage world to step 5, gathers and restacks the
   state (each rank's part through a file, not the buddy ring) and finishes
   steps 6-9 on a trainer born with 3 stages. (c) Every capture verified
   (``verify_replication``); a flipped byte in a held copy is refused. (d)
   Each rank's forward, dQ and dK/dV launches per step: 21 / 12 / 12 with
   3 layers a rank before the loss, 28 / 16 / 16 with 4 after (except_last:
   4 micro-batches, one recompute fewer). (e) The guarded step over phase
   11's 2 x 2 world (the drill's 12 layers, ``zero=True``) under
   ``nan_grads`` at steps 1-2 (a rewind), ``loss_spike`` at 4 and
   ``data_raise`` at 5, 6 steps:
   anomalies, rewinds, steps and Adam's accepted steps equal the
   one-device guarded twin's under the same plan (run first, from the same
   seed), losses within 1e-5 relative, and the parameters: at most 1e-5 of
   the elements past 1e-4 x max(1, max|p|) of their tensor, none past lr x
   the accepted steps (Adam turns a gradient whose sign the summation order
   decides into a step of lr either way; the elements past the bound are
   printed). ``tools/torch_guard_probe.py`` runs this gate alone with the
   twin's gradient of those elements by step, and with a planted fault
   (data rank 1's gradients zeroed before the data all-reduce) that must
   fail the parameter limb on every rank.
   Prints, with the card's name and power limit: each capture's bytes and
   ms per rank, the detection-to-resume seconds and the lost steps, steady
   ms per step before and after the loss for the recovered and the
   unkilled run, peak bytes per rank and the phase's seconds.

14. overlap -- run after phase 11, in the same world of 4 ranks, as 4
   stage ranks. (a) The tutorial LM at full width (``LMConfig`` defaults:
   d_model 2048, 16 layers, 4 a rank; random weights and tokens from
   seeds; dropout 0.2, batch 32, chunks 4): a serialized warm-up step, then
   1f1b/except_last steps through ``ScheduledPipeline(mesh=)`` serialized,
   overlapped, overlapped, serialized (2 steps each, from one set of
   weights): every step's loss and gradients bit for bit the warm-up's, and
   each rank's forward, dQ and dK/dV launches equal to its column of the
   table. (b) Phase-compiled 1f1b/except_last against (a)'s warm-up step,
   and phase-compiled zb-h1/never (the structural split) against its
   interpreted step (2 steps each): bit for bit, launches as (a); the
   programs' cycles
   and segments printed. (c) ``obs/bubble_probe.py``'s ranks with
   ``--schedules --transport`` at ``pipe_tpu``'s widths (d_model 256, d_ff
   512, seq 64, m 8, 4 stages) on the card: its JSON line, every row timed
   and the phase rows accepted. (d) ``apps.zoo``'s stage ranks over the
   world (GPT-2-small at full width, phase gpt2's argv (e) with ``--world
   4`` for 3 steps): losses within 1e-5 relative of phase gpt2's one-device
   zoo, each rank's launches equal to its column of the table x 3 blocks.
   Prints per rank and step: ms, the point-to-point host seconds
   (``p2p_s``) and the seconds waited on posted messages (``wait_s``), the
   header bytes; the means per walk, beside the card's name and power
   limit.

15. context -- run after phase 13, in the same world of 4 ranks, the
   context axis (``make_mesh(..., n_context=)``) at the tutorial LM's full
   width (d_model 2048, 32 heads, d_ff 2048, 16 layers, dropout 0, the
   corpus vocabulary; random weights and tokens from seeds, batch 4 x
   2,048 tokens). The one-device twin runs first in the parent: the LM on
   the same weights over the whole sequence with the flash kernels
   (per-row losses, the gradients of their mean), and the one-device
   ``Generator``'s tokens. (a) Ulysses: ``SpmdPipeline(context_axis=)``
   over ``ContextParallelLM(sp_impl="ulysses")`` on a (1, 1, 4) mesh,
   chunks 2, 1 ``loss_and_grad`` step: per-row losses and the loss within
   1e-5 relative of the twin's, every gradient within 1e-4 x max(1,
   max|g|), each rank's forward, dQ and dK/dV launches a step equal to the
   table's (32 each: 2 micro-batches x 16 layers, the kernels at (16,
   2048, 64) causal). (b) The ring: the 1f1b table (except_last) with
   ``context_axis`` over ``ContextParallelLM(sp_impl="ring")`` on a (2, 1,
   2) mesh, chunks 4, 1 serialized step: the same twin gates, no kernel
   launched (the ring's softmax is einsums); one overlapped and one
   phase-compiled step bit for bit the first serialized one. (c)
   ``ContextShardedGenerator`` over a (1, 1, 4) mesh, a 4,096-token prompt,
   batch 2: 16 greedy tokens equal to the one-device ``Generator``'s except
   at near ties (top-2 within 1e-4 of max|logit|, phase 12's rule), beam 2
   over 8 tokens equal with scores within 1e-5 relative, every rank's
   tokens equal, no kernel launched; the sampled stream's (8 tokens)
   agreement with the one-device ``Generator``'s for the seed is printed,
   not gated. (d) ``apps.generate --context-shards 4 --device cuda`` at
   full width over its own world with a 128-token prompt and 8 new tokens:
   rc 0 and greedy tokens equal to
   ``--context-shards 1``'s (seed 3) except at a near tie;
   ``--context-shards 3`` exits 2 with ``pipe_tpu``'s message. Prints per
   rank and step: loss, ms, launches, the ring and all-to-all bytes and
   seconds, the gradient all-reduce, peak bytes; the generator's prefill
   ms, ms per generated token and the decode collectives' share; all
   beside the card's name and power limit.

16. tp -- run after phase 15, in the same world of 4 ranks, the model axis
   (``make_mesh(..., n_model=)``, tensor parallelism) at the tutorial LM's
   full width (``LMConfig`` defaults: d_model 2048, 32 heads, d_ff 2048,
   16 layers, bptt 128, the corpus vocabulary), dropout 0, with random
   weights and tokens from seeds, through ``TPPipelinedLM`` (Megatron's
   column/row split: two all-reduces over the model line a block, the
   attention einsums and a float32 softmax, no kernel). The one-device
   twins run first in the parent: ``TPPipelinedLM(tp_axis=None)`` on the
   same weights through the one-device table executor (1f1b,
   except_last, batch 32, chunks 4; per-row losses, the loss and its
   gradients), and the one-device ``Generator``'s tokens. (a)
   ``ScheduledPipeline(stage_param_specs=)`` over a (2, 1, 2) mesh,
   1f1b/except_last, 1 ``loss_and_grad`` step: its loss and the
   per-row losses (``forward`` and ``loss_post_fn`` on the last stage's
   ranks) within 1e-5 relative of the twin's, every gradient, gathered
   over the model line into whole leaves, within 1e-4 x max(1, max|g|),
   no flash launch on any rank, and the two ranks of a model line hold
   bitwise-equal replicated gradients (digests of their bytes). (b) A
   (1, 2, 2) mesh (data and model) at 8 layers, one step, the same gates
   against its own twin. (c) ``TPShardedGenerator`` over (1, 1, 4), batch
   2, a 128-token prompt: 16 greedy tokens equal to the one-device
   ``Generator``'s except at near ties (phase 12's rule), beam 2 over 8
   tokens equal with scores within 1e-5 relative, every rank's tokens
   equal, no kernel launched; the sampled stream's (8 tokens) agreement
   with the one-device ``Generator``'s for the seed is printed, not
   gated. (d) In the parent, one zb-h1/never step with
   ``tp_split_backward_stage`` at 8 layers held to the 1f1b/never step of
   the same parameters within the same bounds (ROADMAP.md C.4: never to
   ``pipe_tpu``'s split). Prints per rank and step: ms, the model line's
   all-reduces (count, bytes, seconds), the staged bytes and the peak; the
   generator's prefill ms, ms per generated token and the decode
   collectives' share; all beside the card's name and power limit.

17. moe -- run after phase 16, in the same world of 4 ranks, Mixture of
   Experts over the model axis (``ops/moe.py``: heads and experts sharded
   over the model line; two all-reduces a MoE layer, the router's logits
   and the experts' outputs, three a block with attention's; no
   all-to-all, no kernel) at ``MoELMConfig``'s defaults and the tutorial
   LM's full width (d_model 2048, 32 heads, d_ff 2048, 16 layers, bptt
   128, the corpus vocabulary, 8 experts, top 2, capacity factor 1.25:
   1.42 B parameters), dropout 0, with random weights and tokens from
   seeds, through ``MoEPipelinedLM``. The one-device twins run first in
   the parent and are freed before the ranks build:
   ``MoEPipelinedLM(ep_axis=None)`` on the same weights through the
   one-device table executor (1f1b, except_last, batch 32, chunks 4;
   per-row losses, the loss and its gradients; the token-slots each layer
   drops over capacity, printed), and the one-device ``Generator``'s
   greedy tokens (with the margins of its own teacher-forced logits) and
   beam tokens and scores. (a) ``ScheduledPipeline(stage_param_specs=)``
   over a (2, 1, 2) mesh, 16 layers, 1f1b/except_last, one
   ``loss_and_grad`` step: the loss and the per-row losses within 1e-5
   relative of the twin's, every gradient, gathered over the model line
   into whole leaves, within 1e-4 x max(1, max|g|), the replicated
   gradients of each model line bitwise equal (digests), each rank 4 of
   the 8 experts, no flash launch on any rank. (b) ``TPShardedGenerator``
   over (1, 1, 4), 2 experts and 8 heads a rank, batch 2, a 128-token
   prompt: 32 greedy tokens equal to the one-device ``Generator``'s except
   at near ties (phase 12's rule), beam 2 over 8 tokens equal with scores
   within 1e-5 relative or within one fp32 ulp of the largest |logit| of
   the twin's greedy stream (a score near 0 is a difference of logits that
   large, resolved to that ulp), every rank's tokens equal, no kernel
   launched. Prints per rank: ms a step, the model line's all-reduces
   (``model_collectives``, ``model_bytes``, ``model_s``), the staged bytes
   and the peak; the generator's prefill ms, ms per generated token and
   the collectives' share; all beside the card's name and power limit.
   The kernels JSON line carries ``launches_moe`` (0) in every entry.

Before every phase the collector runs and the allocator's cache is
emptied, and the phase's starting ``memory_allocated`` and the script's
seconds so far are printed. The last two lines are the kernels JSON object and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import gc
import io
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
EVAL_BATCH = 8
BPTT = 128
N_BATCHES = 4
CHUNKS = 4
N_STAGES = 2
# fp32, sums taken in another order than the plain version: |err| at most
# TOL_KERNEL x max(1, max|plain|).
TOL_KERNEL = 1e-4
TOL_LOSS_REL = 1e-4      # flash vs plain-attention twin, per batch
TOL_LOGITS = 1e-3        # flash vs plain-attention twin, abs
# Training twins at dropout 0, each held to a float64 run of plain attention
# on the same weights: per parameter, the largest gradient difference over
# the larger of that parameter's largest gradient and GRAD_FLOOR of the
# largest gradient of any parameter. The floor is for the key projection's
# bias, whose gradient is zero in exact arithmetic (softmax ignores a
# constant added to a row of scores): every path gives rounding noise there,
# which no relative bound of its own holds. The kernel path must come within
# TOL_GRAD_REL, or within GRAD_SLACK times what fp32 plain attention itself
# comes within: a one-ulp change of a ReLU input near 0 switches that
# element's whole term in the feed-forward gradients on or off, so fp32 runs
# that round differently disagree there by far more than rounding.
TOL_GRAD_REL = 1e-3
GRAD_FLOOR = 1e-3
GRAD_SLACK = 2.0
TRAIN_BATCH = 32
TRAIN_STEPS = 8
TRAIN_LR = 1e-4          # lr 5.0 (the reference's) diverges at full width
# Schedules phase: (schedule, checkpoint) of the dropout-0 twins and of the
# 8-step trajectories; the first trajectory is the one the others are held to.
# A third entry "stored-graph" runs zb-h1/never's stored-graph split
# (split_stage=None) where the Trainer and the structural twin run the
# structural one; SPLIT_SIGMA_RUNS are the runs whose sigma is printed
# against the 1f1b/never run's, over FWD_WALKS timed forward-only walks.
SCHED_TWINS = [(s, c) for s in ("gpipe", "1f1b", "zb-h1")
               for c in ("except_last", "never")] + [
                   ("zb-h1", "never", "structural")]
SCHED_RUNS = (("gpipe", "except_last"), ("1f1b", "except_last"),
              ("zb-h1", "never"), ("zb-h1", "never", "stored-graph"),
              ("1f1b", "never"))
SPLIT_SIGMA_RUNS = ("zb-h1/never", "zb-h1/never/stored-graph")
SCHED_STEPS = 5          # each trajectory's steps
FWD_WALKS = 3
SPLIT_TIME_REPS = 5      # gate (c)'s host and device times of each pass
TOL_SCHED_LOSS = 1e-5    # twin loss, relative to the emulator's
TOL_SCHED_GRAD = 1e-4    # twin gradient, of max(1, max|g|) per parameter
TOL_SCHED_TRAJ = 1e-4    # trajectory, relative to the table gpipe's
# GPT-2 phase: GPT-2-small at its published width (BASELINE config #3's
# composition: 4 stages [4, 4, 4, 4] over embed + stash | 12 blocks | join +
# head, chunks 16, batch 32 of 1024 tokens), the trajectories' runs, and the
# deferred-BN stack of gate (f).
GPT2_BALANCE = [4, 4, 4, 4]
GPT2_CHUNKS = 16
GPT2_BATCH = 32
GPT2_TWINS = [(s, c) for s in ("gpipe", "1f1b")
              for c in ("except_last", "never")]
GPT2_RUNS = ("emulator", "1f1b")          # both under except_last
GPT2_STEPS = 3            # the trajectories' and the zoo's steps
BN_WIDTH, BN_DEPTH, BN_CHUNKS, BN_BATCH = 1024, 4, 8, 256
TOL_BN = 1e-5
# Remat phase: the policy the tables take (JAX's headline program is
# except_last + dots_saveable) and the order of the timed runs.
# train_obs phase: the train phase's LM and trainer, 8 steps logged every 4
# (the first and the logged steps synchronize), a profiled step every 4; the
# StepReports' walls over steps 2-8 within TOL_WALL_SUM of the loop's own
# elapsed time; the prediction written in PERF.md before the first chip run
# (MFU and HFU at the emulator's 10,720 train tokens/s against 66.9 TFLOP/s
# fp32); the planner's candidates (m dividing the batch, the emulator's
# schedules) and its timed steps.
OBS_STEPS = 8
OBS_LOG_EVERY = 4
OBS_PROFILE_EVERY = 4
TOL_WALL_SUM = 0.05
PREDICTED_MFU, PREDICTED_HFU = 0.43, 0.53
PLAN_M = (2, 4, 8, 16, 32)
PLAN_SCHEDULES = ("gpipe", "1f1b")
PLAN_REPS = 3
PLAN_FIT_M = (2, 4, 8)      # the m at which auto_plan fits its step costs
TOL_PLAN = 0.05             # the plan's step may be this much over a runner-up's
REMAT_POLICY = "dots_saveable"
REMAT_RUNS = (None, REMAT_POLICY, REMAT_POLICY, None)
REMAT_STEPS = 3          # each trajectory's steps
# GPT-2 serve phase: slots, requests (prompt and new-token lengths drawn
# from a seeded rng), the prompt buckets, the speculative depth, and the
# top-2 margin below which a step is a near tie.
GPT2_SERVE_SLOTS = 8
GPT2_SERVE_REQUESTS = 12
GPT2_SERVE_PROMPT = (16, 128)
GPT2_SERVE_NEW = (32, 64)
GPT2_SERVE_SPEC_K = 4
GPT2_TIE = 1e-4
# BERT phase: BASELINE config #4 on one device (8 stages x interleave 3 =
# 24 virtual stages of one block, chunks 32 of one 512-token row), and the
# steps of (e) under the policy.
BERT_STAGES, BERT_INTERLEAVE, BERT_CHUNKS, BERT_BATCH = 8, 3, 32, 32
BERT_POLICY_STEPS = 1
BERT_ZOO_STEPS = 2
# ViT phase: BASELINE config #5 (8 stages, chunks 8, batch 32) and its
# uneven Pipe balance over embed + 24 blocks + head.
VIT_STAGES, VIT_CHUNKS, VIT_BATCH = 8, 8, 32
VIT_BALANCE = [3] * 7 + [5]
VIT_STEPS = 4            # the zoo's steps
# Generation phase: batch, prompt and new tokens (prompt + new = 256, a
# sequence the flash forward takes, for the reference forward); beam search
# on the first GEN_BEAM_BATCH prompts; sampling; int8 against fp32 logits,
# relative to the largest fp32 logit (pipe_tpu's bound, tests/test_quant.py).
GEN_BATCH = 8
GEN_PROMPT = 128
GEN_NEW = 128
GEN_BEAMS = 4
GEN_BEAM_BATCH = 2
GEN_TEMPERATURE = 0.8
GEN_TOP_K = 50
GEN_EOS_STEP = 5
TOL_INT8_REL = 0.08
TOL_BEAM_REL = 1e-3
MARGIN_OVER_GAP = 10     # greedy is compared where top-2 margin > 10 x gap
# Serve phase: the engine's slots, cache rows and buckets; the traffic
# (prompt and new-token lengths drawn from a seeded rng); the sampled
# requests; the ticks timed for decode ms per tick and profiled for
# launches per tick.
SERVE_SLOTS = 8
SERVE_MAX_LEN = 256
SERVE_BUCKETS = (16, 128)
SERVE_REQUESTS = 16
SERVE_FIRST = 4          # submitted before the first tick, then 2 a tick
SERVE_PROMPT = (16, 128)
SERVE_NEW = (32, 128)
SERVE_SAMPLED = 8
SERVE_TIMED_TICKS = 50
SERVE_PROFILED_TICKS = 10
# Paged/resident serve phase: the pool's block size (pipe_tpu's default),
# the resident depth; a 64-token system prefix shared by PREFIX_REQUESTS
# requests (two of them the bare prefix, whose recompute tail forks a
# shared block); the offload run's pool (OFFLOAD_BLOCKS blocks, so
# OFFLOAD_FILLERS 128-token fillers between two groups of shared-prefix
# requests push the prefix to the host) and its new tokens; int8 KV's
# agreement floor (pipe_tpu's tests/test_kvpool.py).
PAGED_BLOCK = 16
RESIDENT_CHUNKS = 8
PREFIX_LEN = 64
PREFIX_REQUESTS = 8
PREFIX_NEW = 48
OFFLOAD_BLOCKS = 48
OFFLOAD_FILLERS = 8
OFFLOAD_NEW = 32
INT8_AGREE_MIN = 0.8
# Spec phase: draft/verify rounds of SPEC_K tokens, RESIDENT_CHUNKS rounds a
# launch, over 272 cache rows: the bucket ceiling 128 + the request cap +
# the speculative headroom branches x (K - 1) fill 17 blocks of 16 exactly
# (cap 141 for one branch, 138 for the tree's two). On top of the serve
# traffic, REPEAT_REQUESTS prompts that repeat one REPEAT_SPAN-token span of
# eval text 8 times (lists, tables, code: the text an n-gram draft is for).
SPEC_K = 4
SPEC_BRANCHES = 2
SPEC_MAX_LEN = 272
SPEC_CAP = {1: 141, SPEC_BRANCHES: 138}
REPEAT_REQUESTS = 8
REPEAT_SPAN = 16
SPEC_TIMED_LAUNCHES = 5  # timed, then as many profiled, per rung
SPEC_EAGER = (4, 32)     # graph vs eager: the first 4 requests, 32 tokens
# the runs whose sampled traffic is held to the non-spec resident path
SPEC_SAMPLED_RUNS = (("ngram", "slab"), ("tree", "paged"))
# H100 SXM peaks (NVIDIA data sheet, dense): HBM3 bytes/s, and the fastest
# fp32-accurate product rate the card has: TF32 tensor cores (495 TFLOP/s)
# in three passes (big*big + big*small + small*big), which keep fp32-level
# error, against 67 TFLOP/s of fp32 FMA on the CUDA cores.
PEAK_BYTES = 3.35e12
PEAK_FP32_ACCURATE = 495e12 / 3

# (bh, s, d, causal): the eval slice's shape first (b*h = 2 x 32, bptt,
# 2048 / 32); the training path's micro-batch of 8 rows gives b*h = 8 x 32.
TRAIN_SHAPE = (256, 128, 64, True)
DROPOUT = 0.2
# GPT-2-small's training micro-batch: b*h = 2 x 12, seq 1024, 768 / 12.
GPT2_SHAPE = (24, 1024, 64, True)
GPT2_DROPOUT = 0.1
# BERT-large's training micro-batch: one row of 512 tokens, 16 heads of 64.
BERT_SHAPE = (16, 512, 64, False)
BERT_DROPOUT = 0.1
DROP_SEEDS = (12345, (1 << 62) + 977)   # the second uses the key's high word
TIMED_SHAPES = [(64, 128, 64, True), (16, 512, 64, True), (8, 256, 128, False)]
# Ragged and odd shapes the kernel also takes: checked, not timed.
EDGE_SHAPES = [(3, 24, 8, True), (2, 8, 16, False), (4, 40, 48, True),
               (2, 200, 64, True), (2, 96, 96, False), (5, 136, 32, False),
               (3, 72, 8, True), (2, 136, 48, False), (2, 200, 96, True),
               (1, 128, 128, True)]
SDPA_RUNS = 5   # graph timings of SDPA's backward
# the plain versions' timing: fewer calls (each is 4-53 ms at the main
# paths' shapes, far above any launch overhead)
PLAIN_TIMING = dict(iters=2, reps=5)
# Kernels that must run on tensor cores with asynchronous copies (SASS).
TC_KERNELS = ("flash_fwd_kernel", "flash_bwd_dq_kernel", "flash_bwd_dkv_kernel")
# A data rank's attention call in the mesh phase: batch 32 in 4 chunks of 8
# rows, half of them on each of 2 data ranks: (4 rows x 32 heads, 128, 64).
MESH_SHAPE = (128, 128, 64, True)
# A context rank's attention call in phase 15's Ulysses step: a micro-batch of
# 2 rows at the full 2,048-token sequence, 32 / 4 heads a rank: (2 x 8, 2048,
# 64), causal, no dropout.
CONTEXT_SHAPE = (16, 2048, 64, True)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


@functools.lru_cache(maxsize=None)
def _corpus():
    """The synthetic corpus every phase trains on: ``(train lines, val
    lines, vocabulary)``, made once a process (it takes seconds)."""
    from pipe_tpu_torch.data import lm_text
    train_lines, val_lines, _ = lm_text.load_corpus(vocab_size=28782)
    return train_lines, val_lines, lm_text.Vocab(
        map(lm_text.basic_english_tokenize, train_lines))


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py runs on a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi.splitlines()[0], flush=True)
    log("device", name=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda,
        allow_tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
        allow_tf32_cudnn=torch.backends.cudnn.allow_tf32)
    return smi


def sass_counts(lib: str) -> dict:
    """``{kernel instance: (tensor-core instructions, async copies)}`` of a
    built library, from ``cuobjdump --dump-sass``: HMMA/HGMMA and
    LDGSTS/UTMALDG lines per function, names demangled."""
    from pipe_tpu_torch._build import cuda_tool
    out = subprocess.run([cuda_tool("cuobjdump"), "--dump-sass", lib],
                         capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = [0, 0]
        elif name is not None:
            op = line.split(";")[0]
            counts[name][0] += ("HMMA" in op) or ("HGMMA" in op)
            counts[name][1] += ("LDGSTS" in op) or ("UTMALDG" in op)
    names = list(counts)
    plain = subprocess.run([cuda_tool("cu++filt")], input="\n".join(names),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {p.replace("<unnamed>::", "").removeprefix("void "): tuple(counts[n])
            for n, p in zip(names, plain)}


def phase_build() -> None:
    from pipe_tpu_torch import _build
    t0 = time.perf_counter()
    report = _build.build_all()
    total = time.perf_counter() - t0
    for src, info in report.items():
        log("build", source=src, nvcc_s=f"{info['seconds']:.2f}")
        for line in info["ptxas"].splitlines():
            if "Function properties" in line:
                print("    " + line.split(" for ")[-1].strip()[:100], flush=True)
            elif "registers" in line or "spill" in line:
                print("      " + line.replace("ptxas info    :", "").strip(),
                      flush=True)
    log("build", total_s=f"{total:.2f}")
    for src in _build.SOURCES:
        for fn, (tc, cp) in sass_counts(str(_build.lib_path(src))).items():
            log("build", sass=src, kernel=repr(fn.split(">(")[0] + ">"),
                tensor_core=tc, async_copy=cp)
            if any(k in fn for k in TC_KERNELS) and not (tc and cp):
                raise AssertionError(f"{fn} lacks tensor-core instructions "
                                     f"({tc}) or async copies ({cp})")


def time_ms(fn, iters: int = 20, reps: int = 10) -> float:
    """Device time of one ``fn()``: ``iters`` calls captured in a CUDA graph,
    replayed ``reps`` times between CUDA events, so host launch overhead is
    not what is timed."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (iters * reps)


def _bound(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FP32_ACCURATE
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def _pairs(s: int, causal: bool) -> int:
    return s * (s + 1) // 2 if causal else s * s


def attention_bound(bh: int, s: int, d: int, causal: bool, elem: int):
    """Least time (ms) for one flash forward: q, k, v read once, o and lse
    written once; 4*d FLOPs per (query, key) pair the mask keeps."""
    return _bound(4 * bh * s * d * elem + bh * s * 4,
                  4 * d * _pairs(s, causal) * bh)


def bwd_bound(kernel: str, bh: int, s: int, d: int, causal: bool, elem: int):
    """Least time (ms) for one dQ or dK/dV call: q, k, v, dO, L and D read
    once, the gradients written once; 6*d (dQ) or 8*d (dK/dV) FLOPs per
    (query, key) pair the mask keeps."""
    outs, per_pair = {"dq": (1, 6), "dkv": (2, 8)}[kernel]
    return _bound((4 + outs) * bh * s * d * elem + 2 * bh * s * 4,
                  per_pair * d * _pairs(s, causal) * bh)


def _qkv(bh, s, d, dtype, gen, n=3):
    return [torch.randn((bh, s, d), generator=gen, device="cuda").to(dtype)
            for _ in range(n)]


def _err(got: torch.Tensor, want: torch.Tensor) -> float:
    return (got.float() - want.float()).abs().max().item()


def _scale_of(want: torch.Tensor) -> float:
    return max(1.0, want.float().abs().max().item())


def phase_kernels() -> dict:
    """Each kernel against its plain version; returns the kernels' rows."""
    import torch.nn.functional as F

    from pipe_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    worst = {"flash_attn_fwd": 0.0, "flash_attn_bwd_dq": 0.0,
             "flash_attn_bwd_dkv": 0.0}
    rows = {}

    def keep_of(seed, rate, bh, s, base=0):
        return (fa.dropout_keep(seed, rate, bh, s, device="cuda", bh_base=base)
                if rate else None)

    def check(name, errs, scale, tol, where):
        if tol == TOL_KERNEL:                 # fp32: what max_abs_err reports
            worst[name] = max(worst[name], *errs)
        if max(errs) > tol * scale:
            raise AssertionError(
                f"{name} disagrees with its plain version at {where}: "
                f"max|err|={max(errs):.3e} > {tol} x {scale:.3g}")

    def compare_fwd(bh, s, d, causal, dtype, tol, seed=0, rate=0.0, base=0):
        q, k, v = _qkv(bh, s, d, dtype, gen)
        scale = 1.0 / math.sqrt(d)
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, scale=scale,
                                        seed=seed, rate=rate, bh_base=base)
        torch.cuda.synchronize()
        o_ref, lse_ref = fa.flash_attention_ref(q, k, v, causal, scale,
                                                keep_of(seed, rate, bh, s,
                                                        base))
        errs = (_err(o, o_ref), _err(lse, lse_ref))
        check("flash_attn_fwd", errs, _scale_of(o_ref), tol,
              f"bh={bh} s={s} d={d} causal={causal} {dtype} rate={rate} "
              f"bh_base={base}")
        return q, k, v, scale, errs

    def compare_bwd(bh, s, d, causal, dtype, tol, seed=0, rate=0.0, base=0):
        q, k, v, do = _qkv(bh, s, d, dtype, gen, n=4)
        scale = 1.0 / math.sqrt(d)
        keep = keep_of(seed, rate, bh, s, base)
        o, lse = fa.flash_attention_ref(q, k, v, causal, scale, keep)
        delta = fa.attention_delta(o, do)
        kw = dict(causal=causal, scale=scale, seed=seed, rate=rate,
                  bh_base=base)
        dq = fa.flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw)
        dk, dv = fa.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
        torch.cuda.synchronize()
        ref = dict(causal=causal, scale=scale, keep=keep)
        dq_r = fa.flash_attention_bwd_dq_ref(q, k, v, do, lse, delta, **ref)
        dk_r, dv_r = fa.flash_attention_bwd_dkv_ref(q, k, v, do, lse, delta,
                                                    **ref)
        where = (f"bh={bh} s={s} d={d} causal={causal} {dtype} rate={rate} "
                 f"bh_base={base}")
        e_dq = _err(dq, dq_r)
        e_dkv = (_err(dk, dk_r), _err(dv, dv_r))
        check("flash_attn_bwd_dq", (e_dq,), _scale_of(dq_r), tol, where)
        check("flash_attn_bwd_dkv", e_dkv,
              max(_scale_of(dk_r), _scale_of(dv_r)), tol, where)
        return (q, k, v, do, lse, delta, kw), (e_dq, *e_dkv)

    # The forward without dropout: the eval path's shape first.
    for bh, s, d, causal in TIMED_SHAPES:
        q, k, v, scale, (err_o, err_l) = compare_fwd(bh, s, d, causal,
                                                     torch.float32, TOL_KERNEL)
        ms = time_ms(lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                    scale=scale))
        plain = time_ms(lambda: fa.flash_attention_ref(q, k, v, causal,
                                                       scale), **PLAIN_TIMING)
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, scale=scale))
        bound, bound_by = attention_bound(bh, s, d, causal, 4)
        log("kernels", name="flash_attn_fwd", bh=bh, s=s, d=d, causal=causal,
            dtype="f32", rate=0.0, max_abs_dO=f"{err_o:.3e}",
            max_abs_dL=f"{err_l:.3e}", ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
            library_ms=f"{lib:.5f}", bound_ms=f"{bound:.5f}",
            bound_by=bound_by, roofline=f"{bound / ms:.3f}")

    # Every kernel, with and without dropout, at the training shapes (timed
    # below) and at the other shapes (checked); GPT-2-small's with its own
    # dropout rate.
    for shape, drop in ([(sh, DROPOUT) for sh in [TRAIN_SHAPE] + TIMED_SHAPES
                         + EDGE_SHAPES] + [(GPT2_SHAPE, GPT2_DROPOUT),
                                           (BERT_SHAPE, BERT_DROPOUT)]):
        bh, s, d, causal = shape
        for seed, rate in [(0, 0.0)] + [(sd, drop) for sd in DROP_SEEDS]:
            *_, (err_o, err_l) = compare_fwd(bh, s, d, causal, torch.float32,
                                             TOL_KERNEL, seed, rate)
            args, errs = compare_bwd(bh, s, d, causal, torch.float32,
                                     TOL_KERNEL, seed, rate)
            log("kernels", check="fwd+bwd", bh=bh, s=s, d=d, causal=causal,
                rate=rate, seed=seed, max_abs_dO=f"{err_o:.3e}",
                max_abs_dL=f"{err_l:.3e}", max_abs_ddq=f"{errs[0]:.3e}",
                max_abs_ddk=f"{errs[1]:.3e}", max_abs_ddv=f"{errs[2]:.3e}")
    # A data rank's share of the mesh phase's micro-batch: rows 4.. of 8 at
    # 32 heads, its mask the whole micro-batch's (bh_base = 4 x 32).
    for base in (0, MESH_SHAPE[0]):
        for seed, rate in ((DROP_SEEDS[0], DROPOUT), (DROP_SEEDS[1], DROPOUT)):
            *_, (err_o, err_l) = compare_fwd(*MESH_SHAPE, torch.float32,
                                             TOL_KERNEL, seed, rate, base)
            _, errs = compare_bwd(*MESH_SHAPE, torch.float32, TOL_KERNEL,
                                  seed, rate, base)
            log("kernels", check="bh_base", shape=MESH_SHAPE, bh_base=base,
                seed=seed, rate=rate, max_abs_dO=f"{err_o:.3e}",
                max_abs_ddq=f"{errs[0]:.3e}", max_abs_ddk=f"{errs[1]:.3e}",
                max_abs_ddv=f"{errs[2]:.3e}")
    # bf16 in and out (fp32 inside): results round to bf16, 8 bits of
    # mantissa, so the tolerance is 1e-2 of the largest value.
    for seed, rate in ((0, 0.0), (DROP_SEEDS[0], DROPOUT)):
        *_, (err_o, err_l) = compare_fwd(*TRAIN_SHAPE, torch.bfloat16, 1e-2,
                                         seed, rate)
        _, errs = compare_bwd(*TRAIN_SHAPE, torch.bfloat16, 1e-2, seed, rate)
        log("kernels", check="bf16", shape=TRAIN_SHAPE, rate=rate,
            max_abs_dO=f"{err_o:.3e}", max_abs_ddq=f"{errs[0]:.3e}",
            max_abs_ddk=f"{errs[1]:.3e}", max_abs_ddv=f"{errs[2]:.3e}")

    def timed(shape, rate):
        """Check, repeat and time the three kernels at ``shape`` with
        dropout ``rate``, as the main path calls them; returns their rows."""
        rows = {}
        bh, s, d, causal = shape
        seed = DROP_SEEDS[0]
        (q, k, v, do, lse, delta, kw), _ = compare_bwd(
            bh, s, d, causal, torch.float32, TOL_KERNEL, seed, rate)
        scale = kw["scale"]

        # Same seed, same bits: a second run of each kernel equals the first;
        # another seed changes the result.
        runs = [(lambda sd=sd: fa.flash_attention_fwd(
                     q, k, v, causal=causal, scale=scale, seed=sd,
                     rate=rate)[0],
                 lambda sd=sd: fa.flash_attention_bwd_dq(
                     q, k, v, do, lse, delta, **dict(kw, seed=sd)),
                 lambda sd=sd: torch.cat(fa.flash_attention_bwd_dkv(
                     q, k, v, do, lse, delta, **dict(kw, seed=sd))))
                for sd in (seed, DROP_SEEDS[1])]
        for name, a, b in zip(("fwd", "dq", "dkv"), *runs):
            first, again, other = a(), a(), b()
            if not torch.equal(first, again):
                raise AssertionError(f"{name}: the same seed gave other bits")
            if rate and torch.equal(first, other):
                raise AssertionError(f"{name}: another seed gave the same result")
        if rate:
            keep = fa.dropout_keep(seed, rate, bh, s, device="cuda")
            kept = (keep > 0).float().mean().item()
            sigma = math.sqrt(rate * (1 - rate) / keep.numel())
            log("kernels", check="repeat", same_seed_bitwise=True,
                keep_rate=f"{kept:.6f}", expected=1 - rate,
                sigma=f"{sigma:.2e}")
            if abs(kept - (1 - rate)) > 4 * sigma:
                raise AssertionError(f"keep rate {kept} is not within 4 sigma "
                                     f"of {1 - rate}")
        else:
            log("kernels", check="repeat", same_seed_bitwise=True, rate=0.0)

        plain_keep = lambda: (fa.dropout_keep(seed, rate, bh, s, device="cuda")
                              if rate else None)
        ref_kw = dict(causal=causal, scale=scale)
        fwd_ms = time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal=causal, scale=scale, seed=seed, rate=rate))
        fwd_plain = time_ms(lambda: fa.flash_attention_ref(
            q, k, v, causal, scale, plain_keep()), **PLAIN_TIMING)
        dq_ms = time_ms(lambda: fa.flash_attention_bwd_dq(
            q, k, v, do, lse, delta, **kw))
        dq_plain = time_ms(lambda: fa.flash_attention_bwd_dq_ref(
            q, k, v, do, lse, delta, keep=plain_keep(), **ref_kw),
            **PLAIN_TIMING)
        dkv_ms = time_ms(lambda: fa.flash_attention_bwd_dkv(
            q, k, v, do, lse, delta, **kw))
        dkv_plain = time_ms(lambda: fa.flash_attention_bwd_dkv_ref(
            q, k, v, do, lse, delta, keep=plain_keep(), **ref_kw),
            **PLAIN_TIMING)
        # Library yardsticks, timed like the kernels (CUDA graphs). The forward's:
        # SDPA with the same dropout rate (the same function up to the mask's
        # bits, which come from PyTorch's own generator); without dropout beside
        # it. The backward's: SDPA's whole backward (dQ, dK and dV together), as
        # forward+backward less the forward, the mean of SDPA_RUNS graph timings
        # with their spread; with the main path's dropout rate, and without.
        q4, k4, v4 = (x[None].detach().requires_grad_() for x in (q, k, v))
        do4 = do[None]

        def sdpa(p=0.0):
            return F.scaled_dot_product_attention(q4, k4, v4, dropout_p=p,
                                                  is_causal=causal, scale=scale)

        def sdpa_grads(p=0.0):
            return torch.autograd.grad(sdpa(p), (q4, k4, v4), do4)

        with torch.no_grad():
            lib_fwd = time_ms(sdpa)
            lib_fwd_drop = time_ms(lambda: sdpa(rate))
        side = torch.cuda.Stream()       # autograd warms up off the capture stream
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for p in (0.0, rate) * 3:
                sdpa_grads(p)
        torch.cuda.current_stream().wait_stream(side)
        bwd_runs = {p: [] for p in (0.0, rate)}   # one key at rate 0
        for _ in range(SDPA_RUNS):
            for p, runs in bwd_runs.items():
                with torch.no_grad():
                    fwd_only = time_ms(lambda: sdpa(p))
                runs.append(time_ms(lambda: sdpa_grads(p)) - fwd_only)
        lib_bwd, lib_bwd_drop = (sum(bwd_runs[p]) / len(bwd_runs[p])
                                 for p in (0.0, rate))

        for name, ms, plain, lib, lib_nodrop, (bound, by) in (
                ("flash_attn_fwd", fwd_ms, fwd_plain, lib_fwd_drop, lib_fwd,
                 attention_bound(bh, s, d, causal, 4)),
                ("flash_attn_bwd_dq", dq_ms, dq_plain, lib_bwd_drop, lib_bwd,
                 bwd_bound("dq", bh, s, d, causal, 4)),
                ("flash_attn_bwd_dkv", dkv_ms, dkv_plain, lib_bwd_drop, lib_bwd,
                 bwd_bound("dkv", bh, s, d, causal, 4))):
            rows[name] = dict(ms=ms, plain_ms=plain, library_ms=lib,
                              library_ms_no_dropout=lib_nodrop,
                              bound_ms=bound, bound_by=by,
                              max_abs_err=worst[name])
            log("kernels", name=name, bh=bh, s=s, d=d, causal=causal, dtype="f32",
                rate=rate, ms=f"{ms:.5f}", plain_ms=f"{plain:.5f}",
                library_ms=f"{lib:.5f}", library_ms_no_dropout=f"{lib_nodrop:.5f}",
                bound_ms=f"{bound:.5f}", bound_by=by,
                roofline=f"{bound / ms:.3f}", max_abs_err=f"{worst[name]:.3e}")
        for p, runs in bwd_runs.items():
            log("kernels", sdpa_bwd_rate=p, sdpa_bwd_ms=f"{sum(runs) / len(runs):.5f}",
                sdpa_bwd_runs_ms=[f"{x:.5f}" for x in runs],
                sdpa_bwd_spread_ms=f"{max(runs) - min(runs):.5f}")
        log("kernels", sdpa_fwd_ms=f"{lib_fwd:.5f}",
            sdpa_fwd_dropout_ms=f"{lib_fwd_drop:.5f}",
            note=f"library_ms is SDPA with dropout {rate} "
            "(library_ms_no_dropout without): of fwd its forward; of dq and "
            "dkv its whole backward (dQ, dK, dV together)")
        return rows

    # The training shapes with dropout, as the main paths call the kernels:
    # the tutorial LM's, then GPT-2-small's and BERT-large's (their rows ride
    # under gpt2_shape and bert_shape). Every kernel's grid is (bh, s / 64)
    # blocks of 128 threads.
    rows = timed(TRAIN_SHAPE, DROPOUT)
    for key, (shape, rate) in (("gpt2_shape", (GPT2_SHAPE, GPT2_DROPOUT)),
                               ("bert_shape", (BERT_SHAPE, BERT_DROPOUT)),
                               ("mesh_shape", (MESH_SHAPE, DROPOUT)),
                               ("context_shape", (CONTEXT_SHAPE, 0.0))):
        bh, s = shape[:2]
        log("kernels", shape=key, grid_blocks=bh * -(-s // 64),
            sms=torch.cuda.get_device_properties(0).multi_processor_count)
        for name, row in timed(shape, rate).items():
            rows[name][key] = row
    return rows


def make_slice(n_batches: int = N_BATCHES):
    """The tutorial pipeline at full width on the card: ``(cfg, seq, pipe,
    batches)`` with ``batches`` a list of ``(tokens, targets)`` of
    ``[EVAL_BATCH, BPTT]`` from the eval split of the synthetic corpus."""
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig, build_sequential

    train_lines, val_lines, vocab = _corpus()
    val = lm_text.batchify(lm_text.data_process(val_lines, vocab), EVAL_BATCH)
    batches = []
    for b in range(n_batches):
        data, target = lm_text.get_batch(val, b * BPTT, BPTT)
        if data.shape[1] != BPTT:
            raise RuntimeError("eval split too short for the smoke batches")
        batches.append((torch.from_numpy(data).long().cuda(),
                        torch.from_numpy(target).long().cuda()))
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")
    seq = build_sequential(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    pipe = Pipe(seq, chunks=CHUNKS, n_stages=N_STAGES,
                checkpoint="except_last", device="cuda")
    return cfg, seq, pipe, batches


def evaluate(pipe, batches):
    """Eval forward over ``batches``: (per-batch logits, [n] losses)."""
    from pipe_tpu_torch.models.transformer_lm import cross_entropy
    logits, losses = [], []
    for x, y in batches:
        out = pipe(x)
        logits.append(out)
        losses.append(cross_entropy(out, y))
    return logits, torch.stack(losses)


def phase_slice() -> int:
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.models.transformer_lm import build_sequential
    from pipe_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg, seq, pipe, batches = make_slice()
    n_params = sum(p.numel() for p in pipe.parameters())
    log("slice", vocab=cfg.vocab, d_model=cfg.d_model, nhead=cfg.nhead,
        d_ff=cfg.d_ff, n_layers=cfg.n_layers, params=n_params,
        balance=pipe.balance, setup_s=f"{time.perf_counter() - t0:.2f}")

    with torch.inference_mode():
        pipe(batches[0][0])                      # warm-up: not counted
        torch.cuda.synchronize()
        for c in _counters():
            c.launches = 0
        t0 = time.perf_counter()
        logits, losses = evaluate(pipe, batches)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = fa.flash_attention_fwd.launches

    expected = cfg.n_layers * CHUNKS * N_BATCHES
    loss = losses.mean().item()
    tokens = N_BATCHES * EVAL_BATCH * BPTT
    log("slice", eval_loss=f"{loss:.6f}", ppl=f"{math.exp(loss):.2f}",
        log_vocab=f"{math.log(cfg.vocab):.6f}", tokens=tokens,
        seconds=f"{dt:.4f}", tokens_per_s=f"{tokens / dt:.1f}",
        flash_launches=launches, expected=expected,
        logits_shape=tuple(logits[0].shape))
    if launches != expected:
        raise AssertionError(f"flash kernel launched {launches} times on the "
                             f"main path, expected {expected}")
    if not all(torch.isfinite(l).all().item() for l in logits):
        raise AssertionError("non-finite logits")
    if not abs(loss - math.log(cfg.vocab)) <= 1.0:
        raise AssertionError(f"eval loss {loss} is not within 1 nat of "
                             f"log(vocab) {math.log(cfg.vocab)}")

    # The same weights with plain attention.
    twin_seq = build_sequential(
        dataclasses.replace(cfg, attn_impl="xla"), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED + 1))
    twin_seq.load_state_dict(seq.state_dict())
    twin = Pipe(twin_seq, chunks=CHUNKS, n_stages=N_STAGES,
                checkpoint="except_last", device="cuda")
    with torch.inference_mode():
        before = fa.flash_attention_fwd.launches
        twin_logits, twin_losses = evaluate(twin, batches)
        if fa.flash_attention_fwd.launches != before:
            raise AssertionError("the plain-attention twin launched the kernel")
    rel = ((losses - twin_losses).abs() / twin_losses.abs()).max().item()
    dlogits = max((a - b).abs().max().item()
                  for a, b in zip(logits, twin_logits))
    log("slice", twin="xla", max_loss_rel=f"{rel:.3e}",
        max_abs_dlogits=f"{dlogits:.3e}")
    if not (rel <= TOL_LOSS_REL and dlogits <= TOL_LOGITS):
        raise AssertionError(
            f"flash path disagrees with the plain-attention twin: loss rel "
            f"{rel:.3e} (tol {TOL_LOSS_REL}), logits {dlogits:.3e} "
            f"(tol {TOL_LOGITS})")
    return launches


def _counters():
    from pipe_tpu_torch.ops import flash_attention as fa
    return (fa.flash_attention_fwd, fa.flash_attention_bwd_dq,
            fa.flash_attention_bwd_dkv)


def _launch_counts() -> dict:
    return {c.__name__: c.launches for c in _counters()}


def _zero_launches() -> None:
    for c in _counters():
        c.launches = 0


def phase_train() -> dict:
    """The training path; returns each kernel's launches over its 8 steps."""
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import (LMConfig,
                                                      build_sequential,
                                                      pipelined_lm_balance)
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig, lm_loss

    t0 = time.perf_counter()
    train_lines, _, vocab = _corpus()
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")   # dropout 0.2
    tcfg = TrainerConfig(batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
                         n_stages=N_STAGES, checkpoint="except_last",
                         lr=TRAIN_LR)
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              tcfg.batch_size)
    if lm_text.num_batches(source, BPTT) < TRAIN_STEPS:
        raise RuntimeError("train split too short for the smoke steps")
    trainer = Trainer(cfg, tcfg, device="cuda")
    state = trainer.init_state()
    torch.cuda.synchronize()
    log("train", vocab=cfg.vocab, dropout=cfg.dropout,
        params=trainer.num_params(state), balance=trainer.pipe.balance,
        batch=tcfg.batch_size, chunks=tcfg.chunks,
        checkpoint=tcfg.checkpoint, lr=tcfg.lr,
        setup_s=f"{time.perf_counter() - t0:.2f}")

    for c in _counters():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    t_all = time.perf_counter()
    for b in range(TRAIN_STEPS):
        t_step = time.perf_counter()
        state, info = trainer.train_epoch(source, epoch=0, state=state,
                                          max_steps=b + 1, start_step=b,
                                          log_every=1)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t_step)
        losses.append(info["loss"])
    wall = time.perf_counter() - t_all
    launches = {c.__name__: c.launches for c in _counters()}
    tokens = TRAIN_STEPS * tcfg.batch_size * BPTT
    steady = sum(step_s[1:]) / (TRAIN_STEPS - 1)
    log("train", steps=TRAIN_STEPS, losses=[f"{l:.6f}" for l in losses],
        seconds=f"{wall:.4f}", tokens=tokens,
        train_tokens_per_s=f"{tokens / wall:.1f}",
        ms_per_step=[f"{x * 1e3:.1f}" for x in step_s],
        steady_ms_per_step=f"{steady * 1e3:.1f}",
        steady_tokens_per_s=f"{tcfg.batch_size * BPTT / steady:.1f}",
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        **launches)
    per_step = cfg.n_layers * CHUNKS
    recompute = cfg.n_layers * (CHUNKS - 1)      # except_last
    expected = {"flash_attention_fwd": TRAIN_STEPS * (per_step + recompute),
                "flash_attention_bwd_dq": TRAIN_STEPS * per_step,
                "flash_attention_bwd_dkv": TRAIN_STEPS * per_step}
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} on the training "
                             f"path, expected {expected}")
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"non-finite training loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"training loss did not fall: {losses}")
    del trainer, state
    torch.cuda.empty_cache()

    # Twins at dropout 0: one step's loss and gradients from the same weights
    # and batch, with the kernels (fp32), with plain attention (fp32) and
    # with plain attention in float64, the reference both are held to.
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    data, target = lm_text.get_batch(source, 0, BPTT)
    tokens_t = torch.from_numpy(data).long().cuda()
    target_t = torch.from_numpy(target).long().cuda()
    results = {}
    for name, impl, dtype in (("kernel", "flash", torch.float32),
                              ("plain", "xla", torch.float32),
                              ("f64", "xla", torch.float64)):
        # The float32 weights of one seed; the float64 twin holds them in
        # float64 and computes in it (compute_dtype casts the activations).
        seq = build_sequential(
            dataclasses.replace(cfg0, attn_impl=impl, compute_dtype=dtype),
            device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        seq.to(dtype)
        pipe = Pipe(seq, chunks=CHUNKS, checkpoint="except_last",
                    balance=pipelined_lm_balance(cfg.n_layers, N_STAGES),
                    device="cuda")
        before = [c.launches for c in _counters()]
        loss = lm_loss(pipe, tokens_t, target_t, train=True, seed=SEED)
        loss.backward()
        moved = [c.launches - n for c, n in zip(_counters(), before)]
        if (impl == "flash") != all(moved):
            raise AssertionError(f"{name} twin launched kernels {moved}")
        results[name] = (loss.item(), [p.grad for p in pipe.parameters()])
        names = [n for n, _ in pipe.named_parameters()]
        del seq, pipe
    l_64, g_64 = results.pop("f64")
    largest = [g.abs().max().item() for g in g_64]
    floor = GRAD_FLOOR * max(largest)
    worst = {}
    for name, (l, grads) in results.items():
        errs = [(a.double() - b).abs().max().item() / max(m, floor)
                for a, b, m in zip(grads, g_64, largest)]
        worst[name] = max(errs)
        log("train", twin=name, dropout=0.0, loss=f"{l:.9f}",
            loss_f64=f"{l_64:.9f}", loss_rel=f"{abs(l - l_64) / l_64:.3e}",
            max_grad_rel=f"{max(errs):.3e}",
            worst_param=names[errs.index(max(errs))],
            median_grad_rel=f"{sorted(errs)[len(errs) // 2]:.3e}",
            params_over_1e3=sum(e > 1e-3 for e in errs), params=len(errs),
            params_at_floor=sum(m < floor for m in largest))
        if abs(l - l_64) > TOL_LOSS_REL * l_64:
            raise AssertionError(f"{name} twin's loss {l} is not within "
                                 f"{TOL_LOSS_REL} of the float64 {l_64}")
    (l_k, _), (l_x, _) = results["kernel"], results["plain"]
    if abs(l_k - l_x) > TOL_LOSS_REL * abs(l_x):
        raise AssertionError(f"kernel path's loss {l_k} is not within "
                             f"{TOL_LOSS_REL} of plain attention's {l_x}")
    tol = max(TOL_GRAD_REL, GRAD_SLACK * worst["plain"])
    if worst["kernel"] > tol:
        raise AssertionError(
            f"kernel path's gradients are {worst['kernel']:.3e} of each "
            f"parameter's largest from the float64 twin's; plain attention "
            f"in fp32 is {worst['plain']:.3e} from it (tol {tol:.3e})")
    return launches


def _obs_setup():
    """The train phase's corpus, model config and trainer config."""
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    from pipe_tpu_torch.train.loop import TrainerConfig

    train_lines, val_lines, vocab = _corpus()
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")   # dropout 0.2
    tcfg = TrainerConfig(batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
                         n_stages=N_STAGES, checkpoint="except_last",
                         lr=TRAIN_LR)
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              tcfg.batch_size)
    val = lm_text.batchify(lm_text.data_process(val_lines, vocab),
                           tcfg.eval_batch_size)
    return cfg, tcfg, source, val


def _obs_run(trainer, source, steps=OBS_STEPS, start=0, state=None,
             name="_step", log_fn=None, keep=False):
    """``steps - start`` steps of ``trainer`` in one ``train_epoch``, with the
    kernels' counts set to 0 just before and read just after; returns
    ``(state, info, losses, launches, peak_bytes)``, the state only when
    ``keep`` (it holds the run's weights and Adam moments on the card). The
    losses are the step method's (recorded, read back after the run)."""
    losses = []
    step = getattr(trainer, name)
    patched = name in vars(trainer)

    def recording(*a):
        out = step(*a)
        losses.append(out[0] if isinstance(out, tuple) else out)
        return out

    setattr(trainer, name, recording)
    state = trainer.init_state() if state is None else state
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    state, info = trainer.train_epoch(source, state=state, max_steps=steps,
                                      start_step=start,
                                      log_every=OBS_LOG_EVERY,
                                      log_fn=log_fn or (lambda s: None))
    torch.cuda.synchronize()
    launches = _launch_counts()
    if patched:
        setattr(trainer, name, step)
    else:
        delattr(trainer, name)      # no bound method left to cycle on
    return (state if keep else None, info, [float(l) for l in losses],
            launches, torch.cuda.max_memory_allocated())


def _obs_log(run, info, peak, smi, tokens_per_step):
    ms = info["sec_per_step"] * 1e3
    log("train_obs", run=run, steps=info["steps"],
        ms_per_step=f"{ms:.1f}",
        train_tokens_per_s=f"{tokens_per_step / info['sec_per_step']:.1f}",
        peak_mem_gb=f"{peak / 1e9:.2f}", card=repr(smi.splitlines()[0]))


def _crc32c(data: bytes) -> int:
    crc = 0xFFFFFFFF
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (0x82F63B78 if crc & 1 else 0)
    return crc ^ 0xFFFFFFFF


def _tb_tags(path: str) -> set:
    """The tags of a TensorBoard scalar file, every record's two masked
    CRC32Cs checked (a bitwise CRC32C, not the writer's table)."""
    import struct

    def masked(data):
        c = _crc32c(data)
        return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF

    def fields(buf):
        k = 0
        while k < len(buf):
            key = shift = 0
            while True:
                b = buf[k]
                key |= (b & 0x7F) << shift
                k, shift = k + 1, shift + 7
                if not b & 0x80:
                    break
            wire = key & 7
            if wire == 0:
                while buf[k] & 0x80:
                    k += 1
                k, val = k + 1, None
            elif wire in (1, 5):
                k, val = k + (8 if wire == 1 else 4), None
            else:
                n = shift = 0
                while True:
                    b = buf[k]
                    n |= (b & 0x7F) << shift
                    k, shift = k + 1, shift + 7
                    if not b & 0x80:
                        break
                k, val = k + n, buf[k:k + n]
            yield key >> 3, val

    raw, tags, off, n_rec = open(path, "rb").read(), set(), 0, 0
    while off < len(raw):
        header = raw[off:off + 8]
        (n,) = struct.unpack("<Q", header)
        payload = raw[off + 12:off + 12 + n]
        if (struct.unpack("<I", raw[off + 8:off + 12])[0] != masked(header)
                or struct.unpack("<I", raw[off + 12 + n:off + 16 + n])[0]
                != masked(payload)):
            raise AssertionError(f"{path}: record {n_rec} fails its CRC32C")
        for field, summary in fields(payload):
            if field == 5:
                for _, value in fields(summary):
                    tags.update(v.decode() for f, v in fields(value)
                                if f == 1)
        off, n_rec = off + 16 + n, n_rec + 1
    return tags


def _train_state_copy(trainer):
    return ([p.detach().clone() for p in trainer.pipe.parameters()],
            [{k: v.clone() for k, v in st.items()}
             for st in trainer.optimizer.state.values()])


def _same_state(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a[0], b[0])) and all(
        sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
        for sa, sb in zip(a[1], b[1]))


def phase_train_obs(smi: str) -> dict:
    """The rest of the one-device training path at the tutorial LM's full
    width (docstring phase 5h); returns each run's kernel launches."""
    import gc
    import shutil
    import signal

    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.core import planner
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.data.native import (BatchPrefetcher,
                                            prefetch_available)
    from pipe_tpu_torch.models.transformer_lm import build_sequential
    from pipe_tpu_torch.obs import meters
    from pipe_tpu_torch.obs.events import EventLog
    from pipe_tpu_torch.obs.telemetry import (peak_flops_per_chip,
                                              train_flops_per_token)
    from pipe_tpu_torch.resilience import (ChaosPlan, Fault,
                                           ResilienceConfig, TrainingAborted)
    from pipe_tpu_torch.train.loop import (Trainer, lm_loss, plan_line)
    from pipe_tpu_torch.train.state import restore_checkpoint

    t_phase = time.perf_counter()
    card = repr(smi.splitlines()[0])
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "train_obs")
    shutil.rmtree(root, ignore_errors=True)
    cfg, tcfg, source, val = _obs_setup()
    tokens_per_step = tcfg.batch_size * BPTT
    runs = {}

    def fresh(chaos=None, **kw):
        gc.collect()
        torch.cuda.empty_cache()
        return Trainer(cfg, dataclasses.replace(tcfg, **kw), device="cuda",
                       chaos=chaos)

    # (a) telemetry: plain, telemetry on, and telemetry + TensorBoard +
    # profile_every + prefetch
    tr = fresh()
    _, info, plain, runs["plain"], peak = _obs_run(tr, source)
    _obs_log("plain", info, peak, smi, tokens_per_step)
    plain_ms_runs = [info["sec_per_step"] * 1e3]
    del tr
    tr = fresh(telemetry_dir=os.path.join(root, "t0"))
    _, info, losses, runs["telemetry"], peak = _obs_run(tr, source)
    _obs_log("telemetry", info, peak, smi, tokens_per_step)
    unprofiled = [e for e in EventLog.read(os.path.join(root, "t0",
                                                        "events.jsonl"))
                  if e["kind"] == "step_report"]
    log("train_obs", run="telemetry",
        mfu=[r["mfu"] for r in unprofiled],
        hfu=[r["hfu"] for r in unprofiled],
        steady_mfu=f"{sum(r['mfu'] * r['wall_sec'] for r in unprofiled[1:]) / sum(r['wall_sec'] for r in unprofiled[1:]):.4f}",
        predicted_mfu=PREDICTED_MFU, card=card)
    telemetry_ms = [info["sec_per_step"] * 1e3]
    if losses != plain or runs["telemetry"] != runs["plain"]:
        raise AssertionError(f"telemetry changed the steps: {losses} vs "
                             f"{plain}, {runs['telemetry']} vs "
                             f"{runs['plain']}")
    del tr
    tdir = os.path.join(root, "t")
    opened = BatchPrefetcher.opened
    tr = fresh(telemetry_dir=tdir, tb_dir=os.path.join(root, "tb"),
               profile_every=OBS_PROFILE_EVERY, prefetch_depth=2)
    state, info, losses, runs["observed"], peak = _obs_run(tr, source,
                                                           keep=True)
    peak_now = torch.cuda.max_memory_allocated()
    tr.evaluate(val, state, max_steps=1)
    _obs_log("observed", info, peak, smi, tokens_per_step)
    if losses != plain or runs["observed"] != runs["plain"]:
        raise AssertionError(f"telemetry, TensorBoard, profiling and "
                             f"prefetch changed the steps: {losses} vs "
                             f"{plain}, {runs['observed']} vs "
                             f"{runs['plain']}")
    if not prefetch_available() or BatchPrefetcher.opened != opened + 1:
        raise AssertionError("the native prefetcher was not taken")
    with BatchPrefetcher(source, BPTT, depth=2) as pf:
        for b, (d, t) in zip(range(OBS_STEPS), pf):
            want = lm_text.get_batch(source, b * BPTT, BPTT)
            if not (np.array_equal(d, want[0]) and np.array_equal(t, want[1])):
                raise AssertionError(f"prefetched batch {b} differs")
    reports = [e for e in EventLog.read(os.path.join(tdir, "events.jsonl"))
               if e["kind"] == "step_report"]
    if len(reports) != OBS_STEPS:
        raise AssertionError(f"{len(reports)} StepReports, not {OBS_STEPS}")
    walls = sum(r["wall_sec"] for r in reports[1:])
    loop = info["sec_per_step"] * (OBS_STEPS - 1)
    log("train_obs", report_wall_sum_s=f"{walls:.4f}",
        loop_elapsed_s=f"{loop:.4f}",
        rel=f"{abs(walls - loop) / loop:.4f}",
        per_step_wall_ms=[f"{r['wall_sec'] * 1e3:.1f}" for r in reports])
    if abs(walls - loop) > TOL_WALL_SUM * loop:
        raise AssertionError(f"StepReport walls over steps 2-{OBS_STEPS} sum "
                             f"to {walls:.4f} s, the loop took {loop:.4f} s")
    peak_flops = peak_flops_per_chip(cfg.compute_dtype, "cuda")
    req, hw = train_flops_per_token(cfg, tcfg.checkpoint, tcfg.chunks)
    steady_tps = tokens_per_step * (OBS_STEPS - 1) / walls
    log("train_obs", peak_flops=f"{peak_flops:.4g}", card=card,
        flops_per_token_required=f"{req:.4g}",
        flops_per_token_hardware=f"{hw:.4g}",
        mfu=[r["mfu"] for r in reports], hfu=[r["hfu"] for r in reports],
        steady_mfu=f"{req * steady_tps / peak_flops:.4f}",
        steady_hfu=f"{hw * steady_tps / peak_flops:.4f}",
        predicted_mfu=PREDICTED_MFU, predicted_hfu=PREDICTED_HFU)
    for r in reports:
        if not 0 < r["mfu"] <= r["hfu"] < 1:
            raise AssertionError(f"step {r['step']}: mfu {r['mfu']} hfu "
                                 f"{r['hfu']} outside 0 < mfu <= hfu < 1")
    mem = reports[-1]["memory"]["cuda:0"]
    log("train_obs", peak_bytes_in_use=mem["peak_bytes_in_use"],
        max_memory_allocated=peak_now, bytes_limit=mem["bytes_limit"])
    if mem["peak_bytes_in_use"] != peak_now:
        raise AssertionError(f"the report's peak {mem['peak_bytes_in_use']} "
                             f"is not max_memory_allocated {peak_now}")
    tb = os.path.join(root, "tb")
    tags = _tb_tags(os.path.join(tb, os.listdir(tb)[0]))
    want = {"telemetry/tokens_per_sec", "telemetry/ms_step", "telemetry/loss",
            "telemetry/mfu", "telemetry/hfu", "telemetry/analytic_bubble",
            "telemetry/peak_gib/cuda:0", "train/loss", "train/ppl",
            "train/tok_s", "train/ms_batch", "train/lr", "pipeline/bubble",
            "train/epoch_loss", "eval/loss"}
    if not want <= tags:
        raise AssertionError(f"TensorBoard tags missing: {want - tags}")
    trace = os.path.join(tdir, f"trace_step{OBS_PROFILE_EVERY}")
    tl = meters.stage_timeline_from_trace(trace)
    busy = meters.stage_busy_from_trace(trace)
    cells = {j: sorted(s["chunks"]) for j, s in tl["stages"].items()}
    stage_busy = [s["busy_sec"] for s in tl["stages"].values()]
    wall = busy["_span"]
    meter = meters.BubbleMeter(chunks=tcfg.chunks, n_stages=tcfg.n_stages)
    with open(os.path.join(trace, "trace.json")) as f:
        gpu_ranges = sum(e.get("cat") == "gpu_user_annotation"
                         for e in json.load(f)["traceEvents"])
    log("train_obs", timeline_source=tl["source"], cells=cells,
        gpu_user_annotations=gpu_ranges,
        stage_busy_ms=[f"{b * 1e3:.2f}" for b in stage_busy],
        device_busy_ms=f"{busy['cuda:0'] * 1e3:.2f}",
        traced_wall_ms=f"{wall * 1e3:.2f}",
        device_idle_share=f"{1 - busy['cuda:0'] / wall:.4f}",
        measured_bubble=f"{meter.measured(stage_busy, wall):.4f}",
        analytic_bubble=f"{meter.analytic:.4f}",
        trace_mb=f"{os.path.getsize(os.path.join(trace, 'trace.json')) / 1e6:.1f}")
    if tl["source"] != "cuda" or cells != {
            j: list(range(tcfg.chunks)) for j in range(tcfg.n_stages)}:
        raise AssertionError(f"timeline from {tl['source']} with cells "
                             f"{cells}")
    if sum(stage_busy) > wall:
        raise AssertionError(f"stage busy {sum(stage_busy)} s exceeds the "
                             f"traced wall {wall} s")
    # (b) starts with nothing of (a) alive (C.27): the TensorBoard writer
    # and the event log closed, no profiler, every prefetcher's producer
    # freed, (a)'s weights and moments collected
    tr.tb.close()
    tr.events.close()
    del tr, state
    gc.collect()
    torch.cuda.empty_cache()
    import threading
    left = dict(profiler=bool(torch._C._autograd._profiler_enabled()),
                prefetchers=BatchPrefetcher.opened - BatchPrefetcher.closed,
                threads=threading.active_count(),
                memory_allocated=torch.cuda.memory_allocated())
    log("train_obs", before_planner=left)
    if left["profiler"] or left["prefetchers"]:
        raise AssertionError(f"(a) left {left} alive for the planner")
    shutil.rmtree(os.path.join(tdir), ignore_errors=True)

    # (b) the planner
    t_b = time.perf_counter()
    seq = build_sequential(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    data, target = lm_text.get_batch(source, 0, BPTT)
    tokens = torch.from_numpy(data).long().cuda()
    targets = torch.from_numpy(target).long().cuda()
    sample = tokens[:tcfg.batch_size // tcfg.chunks]
    prof = planner.profile_model(seq, sample, repeat=3)
    log("train_obs", profile_rows=prof.rows,
        layer_fwd_ms=[f"{t * 1e3:.3f}" for t in prof.layer_fwd_s],
        layer_bwd_ms=[f"{t * 1e3:.3f}" for t in prof.layer_bwd_s], card=card)
    # the profile auto_plan ranks on, fitted to whole steps at PLAN_FIT_M
    fitted, search = [], planner.search
    planner.search = lambda profile, **kw: (fitted.append(profile)
                                            or search(profile, **kw))
    try:
        plan = planner.auto_plan(seq, sample, n_devices=N_STAGES,
                                 m_candidates=PLAN_M, batch_rows=TRAIN_BATCH,
                                 schedules=PLAN_SCHEDULES,
                                 checkpoint=tcfg.checkpoint, fit_m=PLAN_FIT_M)
    finally:
        planner.search = search
    fit = fitted[0]
    log("train_obs", fit_m=list(PLAN_FIT_M), fit_o_ms=f"{fit.o * 1e3:.3f}",
        fit_scale=f"{fit.layer_fwd_s[1] / prof.layer_fwd_s[1]:.4f}",
        fit_rel_residual=f"{fit.rel_residual:.4f}",
        step_model=fit.step_model, source=fit.source)
    # the first runner-up, and the first with another m: the choice of m is
    # what the fitted overhead decides
    runners = list(plan.runners_up[:1]) + [
        r for r in plan.runners_up if r["m"] != plan.m][:1]
    runners = [r for i, r in enumerate(runners) if r not in runners[:i]]

    def step_of(pipe_kw, reps=PLAN_REPS):
        """Loss and ms of ``reps`` synchronized forward+backward steps of a
        Pipe over ``seq`` (the first, a warm-up, untimed)."""
        pipe = Pipe(seq, device="cuda", **pipe_kw)
        times, loss0 = [], None
        for r in range(reps + 1):
            seq.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = lm_loss(pipe, tokens, targets, train=True, seed=SEED)
            loss.backward()
            torch.cuda.synchronize()
            if r:
                times.append(time.perf_counter() - t0)
            loss0 = loss.detach() if loss0 is None else loss0
        return loss0, times, pipe

    got, t_plan, pipe = step_of({"plan": plan})
    hand, _, _ = step_of({"chunks": plan.m, "checkpoint": plan.checkpoint,
                          "schedule": plan.schedule,
                          "balance": list(plan.balance)}, reps=0)
    if not torch.equal(got, hand):
        raise AssertionError(f"Pipe(plan=...) loss {got.item()} is not the "
                             f"hand-built Pipe's {hand.item()}")
    log("train_obs", plan=f"{plan.schedule} m={plan.m} "
        f"balance={list(plan.balance)} checkpoint={plan.checkpoint}",
        predicted_ms=f"{plan.predicted_step_s * 1e3:.1f}",
        measured_ms=[f"{t * 1e3:.1f}" for t in t_plan],
        loss_plan=f"{got.item():.9f}", loss_hand=f"{hand.item():.9f}",
        card=card)
    for runner in runners:
        _, t_run, _ = step_of({"chunks": runner["m"],
                               "checkpoint": runner["checkpoint"],
                               "schedule": runner["schedule"],
                               "balance": list(runner["balance"])})
        log("train_obs", runner_up=f"{runner['schedule']} m={runner['m']} "
            f"balance={runner['balance']}",
            runner_up_predicted_ms=f"{runner['predicted_step_s'] * 1e3:.1f}",
            runner_up_measured_ms=[f"{t * 1e3:.1f}" for t in t_run])
        if min(t_plan) > (1 + TOL_PLAN) * min(t_run):
            raise AssertionError(
                f"the plan {plan.schedule} m={plan.m} took "
                f"{min(t_plan) * 1e3:.1f} ms, the runner-up "
                f"{runner['schedule']} m={runner['m']} "
                f"{min(t_run) * 1e3:.1f}")
    del seq, pipe, tokens, targets, sample
    tr = fresh(plan="auto")
    log("train_obs", trainer_plan=repr(plan_line(tr.cfg)),
        planner_s=f"{time.perf_counter() - t_b:.1f}")
    del tr

    # (c) the guarded step: no faults, then a ChaosPlan
    rc = ResilienceConfig(warmup_steps=2, data_backoff_s=0.0)
    tr = fresh(resilience=rc)
    _, info, losses, runs["guarded"], peak = _obs_run(
        tr, source, name="_guarded_step")
    _obs_log("guarded", info, peak, smi, tokens_per_step)
    guarded_ms = [info["sec_per_step"] * 1e3]
    # the guard's own device work: the copies before the update and the
    # select after it, over this trainer's parameters and moments
    live = tr._guarded_tensors()
    bufs, ok = tr._guard_bufs, torch.ones((), dtype=torch.bool, device="cuda")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    guard_ms = []
    with torch.no_grad():
        for _ in range(4):
            start.record()
            torch._foreach_copy_(bufs, live)
            for t, old in zip(live, bufs):
                torch.where(ok, t, old, out=t)
            end.record()
            end.synchronize()
            guard_ms.append(start.elapsed_time(end))
    guard_bytes = 5 * sum(t.numel() * t.element_size() for t in live)
    log("train_obs", guard_device_ms=[f"{x:.3f}" for x in guard_ms],
        guard_bytes=guard_bytes,
        guard_bound_ms=f"{guard_bytes / PEAK_BYTES * 1e3:.3f}",
        tensors=len(live), card=card)
    del live, bufs, ok
    if losses != plain or runs["guarded"] != runs["plain"]:
        raise AssertionError(f"the guard without faults changed the steps: "
                             f"{losses} vs {plain}, {runs['guarded']} vs "
                             f"{runs['plain']}")
    del tr
    # the verdict read once at the end: the host waits only one step behind
    tr = fresh(resilience=dataclasses.replace(rc, check_every=OBS_STEPS))
    _, info, losses, _, peak = _obs_run(tr, source, name="_guarded_step")
    _obs_log(f"guarded_check_every_{OBS_STEPS}", info, peak, smi,
             tokens_per_step)
    if losses != plain:
        raise AssertionError(f"the guard read every {OBS_STEPS} steps "
                             f"changed the losses: {losses} vs {plain}")
    guarded_ms.append(info["sec_per_step"] * 1e3)
    del tr
    # telemetry and plain again, so each comparison is made in turns
    # (plain, telemetry, ..., guarded, telemetry, plain)
    tr = fresh(telemetry_dir=os.path.join(root, "t1"))
    _, info, losses, _, peak = _obs_run(tr, source)
    telemetry_ms.append(info["sec_per_step"] * 1e3)
    _obs_log("telemetry", info, peak, smi, tokens_per_step)
    del tr
    tr = fresh()
    _, info, again, _, peak = _obs_run(tr, source)
    plain_ms_runs.append(info["sec_per_step"] * 1e3)
    _obs_log("plain", info, peak, smi, tokens_per_step)
    if losses != plain or again != plain:
        raise AssertionError("a repeated run changed the losses")
    log("train_obs", plain_ms=[f"{x:.1f}" for x in plain_ms_runs],
        telemetry_ms=[f"{x:.1f}" for x in telemetry_ms],
        guarded_ms=f"{guarded_ms[0]:.1f}",
        guarded_check_every_8_ms=f"{guarded_ms[1]:.1f}", card=card)
    del tr
    # one epoch (the loss EWMA lives in it); the state is copied around the
    # faulted steps 3 and 5, Adam's step count settled from the verdict
    tr = fresh(ChaosPlan([Fault("nan_grads", 3), Fault("loss_spike", 5),
                          Fault("data_raise", 6)]), resilience=rc)
    retries = tr.registry.scalars().get("resilience.data_retries", 0)
    guarded = tr._guarded_step
    skipped = {}

    def copying(data, target, seed, step, *rest):
        if step not in (3, 5):
            return guarded(data, target, seed, step, *rest)
        tr._settle_steps()
        before = _train_state_copy(tr)
        out = guarded(data, target, seed, step, *rest)
        tr._settle_steps()
        skipped[step] = _same_state(before, _train_state_copy(tr))
        return out

    tr._guarded_step = copying
    state, info, losses, _, _ = _obs_run(tr, source, name="_guarded_step",
                                         keep=True)
    retried = tr.registry.scalars().get("resilience.data_retries", 0) - retries
    log("train_obs", chaos_losses=[f"{l:.6f}" for l in losses],
        anomalies=info["anomalies"], rewinds=info["rewinds"],
        state_unchanged_by_skipped_step=skipped, data_retries=retried,
        steps=info["steps"])
    if losses[:3] != plain[:3]:
        raise AssertionError("the chaos run's clean steps differ from plain")
    if skipped != {3: True, 5: True} or info["anomalies"] != 2 \
            or info["rewinds"] != 0:
        raise AssertionError(f"skipped steps left the state unchanged: "
                             f"{skipped}; {info}")
    if retried != 1 or info["steps"] != OBS_STEPS or state.step != OBS_STEPS:
        raise AssertionError(f"data fault: {retried} retries, "
                             f"{info['steps']} steps, state at {state.step}")
    del tr, state
    tr = fresh(ChaosPlan([Fault("nan_grads", 2, count=6)]),
               resilience=ResilienceConfig(
                   warmup_steps=2, rewind_after=1, max_rewinds=1,
                   snapshot_every=1, rewind_backoff_s=0.0))
    lines = []
    try:
        _obs_run(tr, source, name="_guarded_step", log_fn=lines.append)
    except TrainingAborted as e:
        log("train_obs", aborted=repr(str(e)[:80]), rewinds=lines)
    else:
        raise AssertionError("persistent nan_grads did not abort")
    if not any("rewind #1 at step 2" in l for l in lines):
        raise AssertionError(f"no rewind before the abort: {lines}")
    del tr

    # (d) autosave: SIGTERM during step 3, resume, bitwise
    auto = os.path.join(root, "auto")
    tr = fresh()
    tr.install_autosave(auto)
    step = tr._step
    calls = [0]

    def step_with_sigterm(*a):
        calls[0] += 1
        if calls[0] == 3:
            os.kill(os.getpid(), signal.SIGTERM)
        return step(*a)

    tr._step = step_with_sigterm
    t_d = time.perf_counter()
    try:
        _, info, first, _, _ = _obs_run(tr, source)
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    del tr
    tr = fresh()
    state = restore_checkpoint(auto, tr.init_state(), verify=False)
    resumed_from = state.step
    _, _, rest, _, _ = _obs_run(tr, source, start=state.step, state=state)
    log("train_obs", autosave_steps=info["steps"], resumed_from=resumed_from,
        resumed_losses=[f"{l:.6f}" for l in first + rest],
        autosave_s=f"{time.perf_counter() - t_d:.1f}")
    if info["steps"] != 3 or first + rest != plain:
        raise AssertionError(f"autosave resume: {first} + {rest} vs {plain}")
    del tr, state
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    log("train_obs", seconds=f"{time.perf_counter() - t_phase:.1f}",
        **{f"launches_{k}": list(v.values()) for k, v in runs.items()})
    return runs


@contextlib.contextmanager
def _gc_pauses():
    """The seconds of each garbage-collector pass while the block runs
    (``gc.callbacks``), as a list filled in place."""
    import gc

    pauses, started = [], []

    def timer(phase, info):
        if phase == "start":
            started.append(time.perf_counter())
        elif started:
            pauses.append(time.perf_counter() - started.pop())

    gc.callbacks.append(timer)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(timer)


def _sched_trainer(cfg, schedule, checkpoint, split=None):
    """A ``Trainer`` whose table executor runs ``schedule`` (gpipe through
    the tables too: the trainer is built for 1f1b, then its executor is
    replaced over the same modules); ``split="stored-graph"``: zb-h1/never
    with the stored-graph split in place of the Trainer's structural one."""
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig

    tcfg = TrainerConfig(batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
                         n_stages=N_STAGES, checkpoint=checkpoint,
                         lr=TRAIN_LR,
                         schedule="1f1b" if schedule == "gpipe" else schedule)
    trainer = Trainer(cfg, tcfg, device="cuda")
    if schedule == "gpipe":
        trainer.scheduled = dataclasses.replace(trainer.scheduled,
                                                schedule="gpipe")
    if split == "stored-graph":
        trainer.scheduled = dataclasses.replace(trainer.scheduled,
                                                split_stage=None)
    return trainer


def _split_dots(model, lps: int) -> dict:
    """Gate (c) of phase 5b: one micro-batch (8 rows) of stage 1 of
    ``model`` at full width, once fused (forward, then the whole backward)
    and once split (the tapped forward, B, W), each under ``count_dots``;
    the attention backward launches during W."""
    from pipe_tpu_torch.core.partition import StageCtx
    from pipe_tpu_torch.core.remat import count_dots, split_backward_stage

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    rows = TRAIN_BATCH // CHUNKS
    h = torch.randn(rows, BPTT, model.cfg.d_model, device="cuda",
                    generator=gen)
    seed = torch.randn(h.shape, device="cuda", generator=gen)
    ctx = StageCtx(train=True, stage=1)
    h0 = h.clone().requires_grad_(True)
    with count_dots() as f_fwd:
        out = model.stage_fn(1, h0, ctx)
    with count_dots() as fused:
        out.backward(seed)
    model.zero_grad(set_to_none=True)
    split = split_backward_stage(model.stage_fn, model)
    h1 = h.clone().requires_grad_(True)
    with count_dots() as s_fwd:
        out, ys, taps = split.tapped_fn(1, h1, ctx)
    with count_dots() as b:
        got = torch.autograd.grad(out, [h1, *ys], seed, allow_unused=True)
    torch.cuda.synchronize()
    _zero_launches()
    with count_dots() as w:
        pairs = split.wgrad_fn(1, taps, list(got[1:]))
        torch.autograd.backward([t for t, _ in pairs], [g for _, g in pairs])
    torch.cuda.synchronize()
    w_launches = _launch_counts()
    model.zero_grad(set_to_none=True)
    res = dict(forward_fused=f_fwd.count, forward_tapped=s_fwd.count,
               fused_backward=fused.count, b=b.count, w=w.count,
               weight_products=6 * lps, w_launches=w_launches)
    log("schedules", gate="c", **res)
    if not (res["forward_fused"] == res["forward_tapped"]
            and res["w"] == res["weight_products"]
            and res["b"] + res["w"] == res["fused_backward"]
            and res["b"] == res["fused_backward"] - res["weight_products"]
            and w_launches["flash_attention_bwd_dq"] == 0
            and w_launches["flash_attention_bwd_dkv"] == 0):
        raise AssertionError(f"schedules (c): the split's products {res}")
    _split_times(model, split, h, seed, ctx)
    return res


def _split_times(model, split, h, seed, ctx, reps: int = SPLIT_TIME_REPS):
    """Where the split's time goes on one micro-batch of stage 1: per pass
    (the plain forward and the fused backward; the tapped forward, B and
    W), the host's time to enqueue it (no synchronize) and its time to the
    end of its device work (a synchronize), each the least over ``reps``
    repetitions after a first one (which builds the split's plan)."""
    best: dict = {}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        host = time.perf_counter() - t0
        torch.cuda.synchronize()
        if k:
            old = best.get(name, (math.inf, math.inf))
            best[name] = (min(old[0], host * 1e3),
                          min(old[1], (time.perf_counter() - t0) * 1e3))
        return out

    for k in range(reps + 1):
        h0 = h.clone().requires_grad_(True)
        out = timed("forward", lambda: model.stage_fn(1, h0, ctx))
        timed("fused_backward", lambda: out.backward(seed))
        model.zero_grad(set_to_none=True)
        h1 = h.clone().requires_grad_(True)
        out, ys, taps = timed("tapped_forward",
                              lambda: split.tapped_fn(1, h1, ctx))
        got = timed("b", lambda: torch.autograd.grad(
            out, [h1, *ys], seed, allow_unused=True))
        del out, ys

        def w_pass():
            pairs = split.wgrad_fn(1, taps, list(got[1:]))
            torch.autograd.backward([t for t, _ in pairs],
                                    [g for _, g in pairs])
        timed("w", w_pass)
        model.zero_grad(set_to_none=True)
    log("schedules", gate="c", times=f"host_ms/ms, least of {reps}",
        **{name: f"{host:.2f}/{ms:.2f}" for name, (host, ms) in best.items()})


def _expected_launches(executor, lps: int, steps: int = 1,
                       m: int = CHUNKS) -> dict:
    passes = executor.stage_passes(m)
    return {"flash_attention_fwd": steps * lps * passes["forward"],
            "flash_attention_bwd_dq": steps * lps * passes["backward"],
            "flash_attention_bwd_dkv": steps * lps * passes["backward"]}


def phase_schedules() -> dict:
    """The table executor's phase; returns each (b) run's launches."""
    import warnings

    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    from pipe_tpu_torch.train.loop import lm_loss

    t_phase = time.perf_counter()
    train_lines, _, vocab = _corpus()
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              TRAIN_BATCH)
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")     # dropout 0.2
    lps = cfg.n_layers // N_STAGES
    tokens_per_step = TRAIN_BATCH * BPTT

    # (a) dropout-0 twins from one set of weights
    trainer = _sched_trainer(dataclasses.replace(cfg, dropout=0.0), "1f1b",
                             "except_last")
    trainer.init_state()
    data, target = lm_text.get_batch(source, 0, BPTT)
    tokens_t = torch.from_numpy(data).long().cuda()
    target_t = torch.from_numpy(target).long().cuda()
    x, rows = mb.stack_scatter({"tokens": tokens_t, "targets": target_t},
                               CHUNKS)
    w = mb.valid_row_mask(x, rows)
    names = [n for n, _ in trainer.model.named_parameters()]
    trainer.optimizer.zero_grad(set_to_none=True)
    loss_ref = lm_loss(trainer.pipe, tokens_t, target_t, train=True,
                       seed=SEED)
    loss_ref.backward()
    loss_ref = loss_ref.item()
    ref = [p.grad.clone() for p in trainer.model.parameters()]
    scale = [max(1.0, g.abs().max().item()) for g in ref]
    base = trainer.scheduled
    stored = None
    for schedule, checkpoint, *split in SCHED_TWINS:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # zb-h1 under except_last
            ex = dataclasses.replace(base, schedule=schedule,
                                     checkpoint=checkpoint,
                                     split_stage="auto" if split else None)
        trainer.optimizer.zero_grad(set_to_none=True)
        _zero_launches()
        loss, grads = ex.loss_and_grad(x, w, seed=SEED)
        torch.cuda.synchronize()
        launches = _launch_counts()
        loss = loss.item()
        errs = [(grads[n] - g).abs().max().item() / m
                for n, g, m in zip(names, ref, scale)]
        worst = max(errs)
        rel = abs(loss - loss_ref) / abs(loss_ref)
        log("schedules", twin="/".join([schedule, checkpoint, *split]),
            dropout=0.0, loss=f"{loss:.9f}", emulator_loss=f"{loss_ref:.9f}",
            loss_rel=f"{rel:.3e}", max_grad_err_of_scale=f"{worst:.3e}",
            worst_param=names[errs.index(worst)], **launches)
        if (schedule, checkpoint) == ("zb-h1", "never") and not split:
            stored = (loss, {n: grads[n].clone() for n in names})
        elif split:
            # (a) the structural split against the stored-graph twin too;
            # (b) dQ and dK/dV once a micro-batch, stage and layer
            s_rel = abs(loss - stored[0]) / abs(stored[0])
            s_worst = max((grads[n] - stored[1][n]).abs().max().item()
                          / max(1.0, stored[1][n].abs().max().item())
                          for n in names)
            log("schedules", twin="zb-h1/never/structural",
                against="zb-h1/never (stored-graph)",
                loss_rel=f"{s_rel:.3e}",
                max_grad_err_of_scale=f"{s_worst:.3e}")
            if not (s_rel <= TOL_SCHED_LOSS and s_worst <= TOL_SCHED_GRAD):
                raise AssertionError(
                    f"structural twin off the stored-graph twin: loss rel "
                    f"{s_rel:.3e}, gradients {s_worst:.3e}")
            per_step = N_STAGES * CHUNKS * lps
            if not (launches["flash_attention_bwd_dq"]
                    == launches["flash_attention_bwd_dkv"] == per_step):
                raise AssertionError(
                    f"structural twin launched {launches}: dQ and dK/dV "
                    f"must run {per_step} times a step")
        if not rel <= TOL_SCHED_LOSS:
            raise AssertionError(f"{schedule}/{checkpoint} twin loss {loss} "
                                 f"is not within {TOL_SCHED_LOSS} of the "
                                 f"emulator's {loss_ref}")
        if not worst <= TOL_SCHED_GRAD:
            raise AssertionError(f"{schedule}/{checkpoint} twin gradients "
                                 f"are {worst:.3e} of max(1, max|g|) from "
                                 f"the emulator's (tol {TOL_SCHED_GRAD})")
        if launches != _expected_launches(ex, lps):
            raise AssertionError(f"{schedule}/{checkpoint} launched "
                                 f"{launches}, its tables imply "
                                 f"{_expected_launches(ex, lps)}")
    # (c) the split's matrix products on one micro-batch of one stage
    _split_dots(trainer.model, lps)
    del trainer, ref, grads, base, ex, stored
    torch.cuda.empty_cache()

    # (b, d, e) dropout 0.2: 8 Trainer steps a schedule, one seed; under
    # never, the forward-only walk too (sigma)
    runs, by_schedule, steady_s, fwd_s = {}, {}, {}, {}
    for schedule, checkpoint, *split in SCHED_RUNS:
        key = "/".join([schedule, checkpoint, *split])
        t0 = time.perf_counter()
        trainer = _sched_trainer(cfg, schedule, checkpoint, *split)
        state = trainer.init_state()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s, mallocs, gc_s, held = [], [], [], [], []
        for b in range(SCHED_STEPS):
            n_malloc = torch.cuda.memory_stats()["num_device_alloc"]
            with _gc_pauses() as pauses:
                t_step = time.perf_counter()
                state, info = trainer.train_epoch(
                    source, epoch=0, state=state, max_steps=b + 1,
                    start_step=b, log_every=0)
                torch.cuda.synchronize()
                step_s.append(time.perf_counter() - t_step)
            gc_s.append(sum(pauses))
            mallocs.append(torch.cuda.memory_stats()["num_device_alloc"]
                           - n_malloc)
            held.append(torch.cuda.memory_allocated())
            losses.append(info["loss"])
        launches = _launch_counts()
        peak = torch.cuda.max_memory_allocated()
        steady = sum(step_s[1:]) / (SCHED_STEPS - 1)
        expected = _expected_launches(trainer.scheduled, lps, SCHED_STEPS)
        runs[key] = losses
        by_schedule[key] = launches
        steady_s[key] = steady
        if checkpoint == "never":
            for k in range(FWD_WALKS + 1):          # the first warms up
                torch.cuda.synchronize()
                t_walk = time.perf_counter()
                with torch.no_grad():
                    trainer.scheduled.forward(x, seed=SEED, train=True)
                torch.cuda.synchronize()
                if k:
                    fwd_s[key] = fwd_s.get(key, 0.0) + (
                        time.perf_counter() - t_walk) / FWD_WALKS
        log("schedules", run=key, dropout=cfg.dropout, steps=SCHED_STEPS,
            losses=[f"{l:.6f}" for l in losses],
            ms_per_step=[f"{t * 1e3:.1f}" for t in step_s],
            steady_ms_per_step=f"{steady * 1e3:.1f}",
            train_tokens_per_s=f"{tokens_per_step / steady:.1f}",
            peak_bytes=peak, setup_s=f"{setup_s:.2f}", cuda_mallocs=mallocs,
            gc_pause_ms=[f"{t * 1e3:.1f}" for t in gc_s], held_bytes=held,
            forward_walk_ms=(f"{fwd_s[key] * 1e3:.1f}" if key in fwd_s
                             else None),
            memory_plan=trainer.scheduled.memory_plan(CHUNKS), **launches)
        if not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"{key}: non-finite training loss {losses}")
        if launches != expected:
            raise AssertionError(f"{key} launched {launches} in "
                                 f"{SCHED_STEPS} steps, its tables imply "
                                 f"{expected}")
        del trainer, state
        torch.cuda.empty_cache()
    # (d) sigma of each split: its backward's time over 1f1b/never's
    base_key = "1f1b/never"
    for key in SPLIT_SIGMA_RUNS:
        sigma = ((steady_s[key] - fwd_s[key])
                 / (steady_s[base_key] - fwd_s[base_key]))
        log("schedules", sigma=key, against=base_key, value=f"{sigma:.4f}",
            step_ms=f"{steady_s[key] * 1e3:.2f}",
            forward_walk_ms=f"{fwd_s[key] * 1e3:.2f}",
            base_step_ms=f"{steady_s[base_key] * 1e3:.2f}",
            base_forward_walk_ms=f"{fwd_s[base_key] * 1e3:.2f}")
    ref_key = "/".join(SCHED_RUNS[0])
    for key, losses in runs.items():
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, runs[ref_key]))
        log("schedules", trajectory=key, against=ref_key,
            max_loss_rel=f"{rel:.3e}")
        if not rel <= TOL_SCHED_TRAJ:
            raise AssertionError(f"{key}'s trajectory is {rel:.3e} from "
                                 f"{ref_key}'s (tol {TOL_SCHED_TRAJ})")

    # (d) peak memory of one step under never, Adam state resident
    trainer = _sched_trainer(cfg, "1f1b", "never")
    state = trainer.init_state()
    data, target = lm_text.get_batch(source, 0, BPTT)
    table_1f1b = trainer.scheduled
    trainer._step(data, target, SEED)                   # warm-up: Adam state
    peaks = {}
    for key, executor in (("emulator-gpipe", None),
                          ("table-gpipe", dataclasses.replace(
                              table_1f1b, schedule="gpipe")),
                          ("table-1f1b", table_1f1b)):
        trainer.scheduled = executor
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer._step(data, target, SEED)
        torch.cuda.synchronize()
        peaks[key] = torch.cuda.max_memory_allocated()
        log("schedules", peak=key, checkpoint="never", peak_bytes=peaks[key],
            memory_plan=(executor.memory_plan(CHUNKS) if executor is not None
                         else None))
    if not peaks["table-1f1b"] < peaks["table-gpipe"]:
        raise AssertionError(f"1f1b's peak {peaks['table-1f1b']} is not "
                             f"below the table gpipe's "
                             f"{peaks['table-gpipe']} under never")
    del trainer, state, table_1f1b
    torch.cuda.empty_cache()
    log("schedules", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_schedule


def _gpt2_expected(ex, checkpoint: str, n_blocks: int, steps: int = 1
                   ) -> dict:
    """Kernel launches a GPT-2 step implies: per stage, the emulator runs
    each micro-batch forward once (plus the recomputes of ``checkpoint``) and
    backward once; a table walk runs its ``stage_passes`` (the same count in
    every stage); times the blocks."""
    if ex is None:
        m = GPT2_CHUNKS
        fwd = m + {"always": m, "except_last": m - 1, "never": 0}[checkpoint]
        per_stage = {"forward": fwd, "backward": m}
    else:
        per_stage = {k: v // ex.d for k, v in ex.stage_passes().items()}
    return {"flash_attention_fwd": steps * n_blocks * per_stage["forward"],
            "flash_attention_bwd_dq": steps * n_blocks * per_stage["backward"],
            "flash_attention_bwd_dkv":
                steps * n_blocks * per_stage["backward"]}


def phase_gpt2() -> tuple:
    """GPT-2-small with the embedding skip; returns each (c) run's kernel
    launches. The gates of the module docstring's phase 5c."""
    import contextlib
    import io

    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.apps import zoo
    from pipe_tpu_torch.core.partition import StageCtx
    from pipe_tpu_torch.extras.norm import BatchNorm
    from pipe_tpu_torch.models import gpt2
    from pipe_tpu_torch.models.common import per_row_ce
    from pipe_tpu_torch.ops.layers import Lambda, Linear, Sequential
    from pipe_tpu_torch.parallel.hetero_scheduled import \
        HeteroScheduledPipeline

    t_phase = time.perf_counter()
    cfg = gpt2.GPT2Config(attn_impl="flash")          # dropout 0.1
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    n_blocks = cfg.n_layers
    tokens_per_step = GPT2_BATCH * cfg.seq_len

    def build(c, dtype=torch.float32):
        seq = gpt2.build_sequential(
            c, embed_skip=True, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        seq.to(dtype)
        return Pipe(seq, chunks=GPT2_CHUNKS, checkpoint="except_last",
                    balance=GPT2_BALANCE, device="cuda")

    def batch(step: int):
        gen = torch.Generator(device="cuda").manual_seed(1000 + step)
        tokens = torch.randint(2, cfg.vocab, (GPT2_BATCH, cfg.seq_len),
                               generator=gen, device="cuda")
        return tokens, torch.roll(tokens, -1, -1)

    def emulator_step(pipe, tokens, targets, seed):
        loss = per_row_ce(pipe(tokens, train=True, seed=seed),
                          targets).mean()
        loss.backward()
        return loss.detach()

    def table(pipe, schedule, checkpoint):
        return HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout,
                                       GPT2_CHUNKS, checkpoint, schedule,
                                       device="cuda")

    def table_step(ex, tokens, targets, seed):
        return ex.loss_and_grad(tokens, targets=targets, loss_fn=per_row_ce,
                                seed=seed)[0]

    # (a) emulator twins at dropout 0: kernels, plain attention, float64
    tokens, targets = batch(0)
    pipe = build(cfg0)
    n_params = sum(p.numel() for p in pipe.parameters())
    names = [n for n, _ in pipe.named_parameters()]
    log("gpt2", params=n_params, balance=pipe.balance, chunks=GPT2_CHUNKS,
        batch=GPT2_BATCH, seq=cfg.seq_len,
        stages=[[type(l).__name__ for l in p] for p in pipe.partitions],
        skip_pairs=[k for k, _ in pipe.skip_layout.by_src_dst])
    _zero_launches()
    ref_loss = emulator_step(pipe, tokens, targets, SEED).item()
    launches = _launch_counts()
    want = _gpt2_expected(None, "except_last", n_blocks)
    if launches != want:
        raise AssertionError(f"gpt2 emulator step launched {launches}, "
                             f"expected {want}")
    ref = [p.grad.clone() for p in pipe.parameters()]
    scale = [max(1.0, g.abs().max().item()) for g in ref]

    # (b) the skip lane through the tables, from the same weights
    for schedule, checkpoint in GPT2_TWINS:
        pipe.zero_grad(set_to_none=True)
        ex = table(pipe, schedule, checkpoint)
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        loss = table_step(ex, tokens, targets, SEED).item()
        torch.cuda.synchronize()
        launches = _launch_counts()
        errs = [(p.grad - g).abs().max().item() / m
                for p, g, m in zip(pipe.parameters(), ref, scale)]
        worst = max(errs)
        rel = abs(loss - ref_loss) / abs(ref_loss)
        plan = ex.memory_plan()
        log("gpt2", twin=f"{schedule}/{checkpoint}", dropout=0.0,
            loss=f"{loss:.9f}", emulator_loss=f"{ref_loss:.9f}",
            loss_rel=f"{rel:.3e}", max_grad_err_of_scale=f"{worst:.3e}",
            worst_param=names[errs.index(worst)],
            wte_err=f"{errs[names.index('partitions.0.layers.0.wte')]:.3e}",
            wpe_err=f"{errs[names.index('partitions.0.layers.0.wpe')]:.3e}",
            peak_bytes=torch.cuda.max_memory_allocated(),
            skip_lanes=plan["skip_lanes"],
            skip_fwd_park_slots=plan["skip_fwd_park_slots"],
            skip_bwd_park_slots=plan["skip_bwd_park_slots"],
            last_slots=ex.last_slots, **launches)
        if not rel <= TOL_SCHED_LOSS:
            raise AssertionError(f"gpt2 {schedule}/{checkpoint}: loss {loss} "
                                 f"is not within {TOL_SCHED_LOSS} of the "
                                 f"emulator's {ref_loss}")
        if not worst <= TOL_SCHED_GRAD:
            raise AssertionError(f"gpt2 {schedule}/{checkpoint}: gradients "
                                 f"are {worst:.3e} of max(1, max|g|) from "
                                 f"the emulator's (tol {TOL_SCHED_GRAD})")
        if plan["skip_lanes"] != 1:
            raise AssertionError(f"gpt2 memory_plan: {plan}")
        if launches != _gpt2_expected(ex, checkpoint, n_blocks):
            raise AssertionError(f"gpt2 {schedule}/{checkpoint} launched "
                                 f"{launches}, its tables imply "
                                 f"{_gpt2_expected(ex, checkpoint, n_blocks)}")
    del pipe, ex
    torch.cuda.empty_cache()

    twins = {"kernel": (ref_loss, ref)}
    for name, impl, dtype in (("plain", "xla", torch.float32),
                              ("f64", "xla", torch.float64)):
        pipe = build(dataclasses.replace(cfg0, attn_impl=impl,
                                         compute_dtype=dtype), dtype)
        _zero_launches()
        loss = emulator_step(pipe, tokens, targets, SEED).item()
        if any(_launch_counts().values()):
            raise AssertionError(f"gpt2 {name} twin launched "
                                 f"{_launch_counts()}")
        twins[name] = (loss, [p.grad for p in pipe.parameters()])
        del pipe
        torch.cuda.empty_cache()
    _hold_twins("gpt2", twins, names)
    del twins, ref
    torch.cuda.empty_cache()

    # (c, d, g) dropout 0.1: 8 steps of the emulator and of the 1f1b table
    # with the lane, Adam at lr TRAIN_LR, one seed
    runs, by_run = {}, {}
    for run in GPT2_RUNS:
        pipe = build(cfg)
        ex = table(pipe, run, "except_last") if run != "emulator" else None
        opt = torch.optim.Adam(pipe.parameters(), lr=TRAIN_LR)
        torch.cuda.synchronize()
        _zero_launches()
        torch.cuda.reset_peak_memory_stats()
        losses, step_s = [], []
        for b in range(GPT2_STEPS):
            tokens, targets = batch(b)
            t_step = time.perf_counter()
            opt.zero_grad(set_to_none=True)
            loss = (emulator_step(pipe, tokens, targets, b) if ex is None
                    else table_step(ex, tokens, targets, b))
            opt.step()
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t_step)
            losses.append(loss.item())
        launches = _launch_counts()
        steady = sum(step_s[1:]) / (GPT2_STEPS - 1)
        key = f"{run}/except_last"
        runs[key], by_run[key] = losses, launches
        expected = _gpt2_expected(ex, "except_last", n_blocks, GPT2_STEPS)
        log("gpt2", run=key, dropout=cfg.dropout, steps=GPT2_STEPS,
            losses=[f"{l:.6f}" for l in losses],
            ms_per_step=[f"{t * 1e3:.1f}" for t in step_s],
            steady_ms_per_step=f"{steady * 1e3:.1f}",
            train_tokens_per_s=f"{tokens_per_step / steady:.1f}",
            peak_bytes=torch.cuda.max_memory_allocated(),
            memory_plan=ex.memory_plan() if ex is not None else None,
            **launches)
        if not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"gpt2 {key}: non-finite loss {losses}")
        if launches != expected:
            raise AssertionError(f"gpt2 {key} launched {launches} in "
                                 f"{GPT2_STEPS} steps, expected {expected}")
        del pipe, ex, opt
        torch.cuda.empty_cache()
    (k_e, l_e), (k_t, l_t) = runs.items()
    rel = max(abs(a - b) / abs(b) for a, b in zip(l_t, l_e))
    log("gpt2", trajectory=k_t, against=k_e, max_loss_rel=f"{rel:.3e}")
    if not rel <= TOL_SCHED_TRAJ:
        raise AssertionError(f"gpt2 {k_t}'s trajectory is {rel:.3e} from "
                             f"{k_e}'s (tol {TOL_SCHED_TRAJ})")

    # (g) one step under never: ms and peak of the emulator and the tables
    pipe = build(dataclasses.replace(cfg))
    pipe.checkpoint = "never"
    tokens, targets = batch(0)
    for key, ex in (("emulator", None),
                    ("table-gpipe", table(pipe, "gpipe", "never")),
                    ("table-1f1b", table(pipe, "1f1b", "never"))):
        for _ in range(2):                   # the second step is measured
            pipe.zero_grad(set_to_none=True)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            (emulator_step(pipe, tokens, targets, SEED) if ex is None
             else table_step(ex, tokens, targets, SEED))
            torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        log("gpt2", peak=key, checkpoint="never", ms_per_step=f"{ms:.1f}",
            train_tokens_per_s=f"{tokens_per_step / ms * 1e3:.1f}",
            peak_bytes=torch.cuda.max_memory_allocated(),
            memory_plan=ex.memory_plan() if ex is not None else None)
    del pipe, ex
    torch.cuda.empty_cache()

    # (e) the zoo at full size (its losses kept for phase 14's world run)
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        res = zoo.train(zoo.build_argparser().parse_args(
            _zoo_gpt2_argv(GPT2_STEPS)))
    lines = out.getvalue().splitlines()
    for line in lines:
        print("    " + line, flush=True)
    zoo_losses = res["losses"]
    log("gpt2", zoo_losses=[f"{l:.6f}" for l in zoo_losses],
        zoo_ms_per_step=f"{res['ms_per_step']:.1f}",
        zoo_seconds=f"{time.perf_counter() - t0:.1f}")
    if len(zoo_losses) != GPT2_STEPS or not all(
            math.isfinite(l) for l in zoo_losses):
        raise AssertionError(f"apps.zoo gpt2: losses {zoo_losses}")
    torch.cuda.empty_cache()

    # (f) deferred BN: one step commits one whole-batch momentum update
    def bn_stack():
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        layers = []
        for _ in range(BN_DEPTH):
            layers += [Linear(BN_WIDTH, BN_WIDTH, device="cuda",
                              generator=gen),
                       BatchNorm(BN_WIDTH, device="cuda"),
                       Lambda(torch.relu)]
        return Sequential(layers)

    x = torch.randn(BN_BATCH, BN_WIDTH, device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(7))
    # the reference: every BN's inputs over the mini-batch, each micro-batch
    # normalized by its own statistics, as the pipeline runs it
    seq = bn_stack()
    seen = [[] for _ in range(BN_DEPTH)]
    with torch.no_grad():
        for chunk in x.chunk(BN_CHUNKS):
            h, k = chunk, 0
            for layer in seq:
                if isinstance(layer, BatchNorm):
                    seen[k].append(h)
                    k += 1
                h = layer(h, ctx=StageCtx(train=True))
    want = []
    for hs in seen:
        h = torch.cat(hs)
        n = h.shape[0]
        want.append((0.1 * h.mean(0),
                     0.9 + 0.1 * h.var(0, unbiased=False) * n / (n - 1)))
    for key in ("emulator", "1f1b"):
        pipe = Pipe(bn_stack(), chunks=BN_CHUNKS, checkpoint="except_last",
                    n_stages=4, deferred_batch_norm=True, device="cuda")
        if key == "emulator":
            pipe(x, train=True).square().mean().backward()
        else:
            HeteroScheduledPipeline(
                pipe.partitions, pipe.skip_layout, BN_CHUNKS, "except_last",
                "1f1b", device="cuda").loss_and_grad(
                    x, loss_fn=lambda o: o.square().mean(-1))
        bns = [l for l in pipe if isinstance(l, BatchNorm)]
        errs = [max((b.mean - m).abs().max().item(),
                    (b.var - v).abs().max().item())
                for b, (m, v) in zip(bns, want)]
        log("gpt2", bn=key, layers=len(bns), max_stat_err=f"{max(errs):.3e}")
        if max(errs) > TOL_BN:
            raise AssertionError(f"deferred BN through {key}: stats are "
                                 f"{max(errs):.3e} from one whole-batch "
                                 f"update (tol {TOL_BN})")
    try:
        Pipe(bn_stack(), chunks=BN_CHUNKS, n_stages=4, schedule="zb-h1",
             deferred_batch_norm=True, device="cuda")
    except NotImplementedError as e:
        log("gpt2", bn="zb-h1", refused=repr(str(e)[:60]))
    else:
        raise AssertionError("deferred BN with zb-h1 was not refused")
    del pipe, seq, seen
    torch.cuda.empty_cache()
    log("gpt2", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_run, zoo_losses


def _hold_twins(phase: str, twins: dict, names) -> None:
    """The train phase's twin gate: ``twins`` maps "kernel", "plain" and
    "f64" to (loss, gradients) of one step from one set of weights; each
    fp32 twin is held to the float64 one."""
    l_64, g_64 = twins.pop("f64")
    largest = [g.abs().max().item() for g in g_64]
    floor = GRAD_FLOOR * max(largest)
    worst = {}
    for name, (l, grads) in twins.items():
        errs = [(a.double() - b).abs().max().item() / max(m, floor)
                for a, b, m in zip(grads, g_64, largest)]
        worst[name] = max(errs)
        log(phase, twin=name, dropout=0.0, loss=f"{l:.9f}",
            loss_f64=f"{l_64:.9f}", loss_rel=f"{abs(l - l_64) / l_64:.3e}",
            max_grad_rel=f"{max(errs):.3e}",
            worst_param=names[errs.index(max(errs))])
        if abs(l - l_64) > TOL_LOSS_REL * l_64:
            raise AssertionError(f"{phase} {name} twin's loss {l} is not "
                                 f"within {TOL_LOSS_REL} of the float64 "
                                 f"{l_64}")
    tol = max(TOL_GRAD_REL, GRAD_SLACK * worst["plain"])
    if worst["kernel"] > tol:
        raise AssertionError(
            f"{phase} kernel path's gradients are {worst['kernel']:.3e} of "
            f"each parameter's largest from the float64 twin's; plain "
            f"attention is {worst['plain']:.3e} (tol {tol:.3e})")


def _hold_step(phase: str, what: str, got, want, names) -> None:
    """One step against another from the same weights: ``(loss, grads)``
    pairs, loss within TOL_SCHED_LOSS relative and every gradient within
    TOL_SCHED_GRAD x max(1, max|g|)."""
    (loss, grads), (ref_loss, ref) = got, want
    errs = [(a - b).abs().max().item() / max(1.0, b.abs().max().item())
            for a, b in zip(grads, ref)]
    rel = abs(loss - ref_loss) / abs(ref_loss)
    log(phase, twin=what, loss=f"{loss:.9f}", against=f"{ref_loss:.9f}",
        loss_rel=f"{rel:.3e}", max_grad_err_of_scale=f"{max(errs):.3e}",
        worst_param=names[errs.index(max(errs))])
    if not rel <= TOL_SCHED_LOSS:
        raise AssertionError(f"{phase} {what}: loss {loss} is not within "
                             f"{TOL_SCHED_LOSS} of {ref_loss}")
    if not max(errs) <= TOL_SCHED_GRAD:
        raise AssertionError(f"{phase} {what}: gradients are "
                             f"{max(errs):.3e} of max(1, max|g|) apart "
                             f"(tol {TOL_SCHED_GRAD})")


def _reset_peak() -> int:
    """Free what earlier work left (collected, cache emptied), reset the
    peak counter and return the bytes still allocated: the new phases log
    them beside each peak, which counts them too."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def _run_zoo(phase: str, argv) -> tuple:
    """``apps.zoo.main(argv)`` with its output echoed: ``(losses, ms per
    step, peak bytes, launches)``; fails unless it exits 0 with a finite
    loss a step."""
    import contextlib
    import io

    from pipe_tpu_torch.apps import zoo

    out = io.StringIO()
    _zero_launches()
    resident = _reset_peak()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = zoo.main(argv)
    torch.cuda.synchronize()
    launches = _launch_counts()
    lines = out.getvalue().splitlines()
    for line in lines:
        print("    " + line, flush=True)
    losses = [float(l.split("loss ")[1]) for l in lines
              if l.startswith("| step")]
    ms = float(lines[-1].split("(")[-1].split(" ms")[0])
    log(phase, zoo=" ".join(argv), zoo_rc=rc, zoo_seconds=
        f"{time.perf_counter() - t0:.1f}", resident_bytes=resident)
    steps = int(argv[argv.index("--steps") + 1])
    if rc != 0 or len(losses) != steps or not all(
            math.isfinite(l) for l in losses):
        raise AssertionError(f"apps.zoo {argv}: rc {rc}, losses {losses}")
    return losses, ms, torch.cuda.max_memory_allocated(), launches


def _expected_launches_emulator(n_layers: int) -> dict:
    """The emulator's launches of one except_last step: every micro-batch
    forward once, all but the last again at the backward, backward once."""
    return {"flash_attention_fwd": n_layers * (2 * CHUNKS - 1),
            "flash_attention_bwd_dq": n_layers * CHUNKS,
            "flash_attention_bwd_dkv": n_layers * CHUNKS}


def phase_remat() -> dict:
    """The remat_policy phase; returns each timed run's launches. The gates
    of the module docstring's phase 5d."""
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.remat import count_dots
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.models.common import per_row_ce
    from pipe_tpu_torch.models.transformer_lm import LMConfig

    t_phase = time.perf_counter()
    train_lines, _, vocab = _corpus()
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              TRAIN_BATCH)
    cfg = LMConfig(vocab=len(vocab), attn_impl="flash")     # dropout 0.2
    lps = cfg.n_layers // N_STAGES
    tokens_per_step = TRAIN_BATCH * BPTT

    # (a) dropout-0 twins from one set of weights: the 1f1b table, and the
    # emulator Pipe with the policy per call
    trainer = _sched_trainer(dataclasses.replace(cfg, dropout=0.0), "1f1b",
                             "except_last")
    trainer.init_state()
    data, target = lm_text.get_batch(source, 0, BPTT)
    tokens_t = torch.from_numpy(data).long().cuda()
    target_t = torch.from_numpy(target).long().cuda()
    x, rows = mb.stack_scatter({"tokens": tokens_t, "targets": target_t},
                               CHUNKS)
    w = mb.valid_row_mask(x, rows)
    names = [n for n, _ in trainer.model.named_parameters()]
    params = list(trainer.model.parameters())

    def table_step(policy):
        ex = dataclasses.replace(trainer.scheduled, remat_policy=policy)
        loss, _ = ex.loss_and_grad(x, w, seed=SEED)
        return ex, loss

    def emulator_step(policy):
        loss = per_row_ce(trainer.pipe(tokens_t, train=True, seed=SEED,
                                       remat_policy=policy),
                          target_t).mean()
        loss.backward()
        return None, loss

    for path, step in (("table-1f1b", table_step),
                       ("emulator", emulator_step)):
        runs = {}
        for policy in (None, REMAT_POLICY):
            trainer.optimizer.zero_grad(set_to_none=True)
            _zero_launches()
            resident = _reset_peak()
            with count_dots() as dots:
                ex, loss = step(policy)
                torch.cuda.synchronize()
            launches = _launch_counts()
            runs[policy] = ((loss.item(), [p.grad.clone() for p in params]),
                            launches, dots.count)
            log("remat", twin=path, policy=policy, dropout=0.0,
                loss=f"{loss.item():.9f}", dots=dots.count,
                resident_bytes=resident,
                peak_bytes=torch.cuda.max_memory_allocated(), **launches)
            want = (_expected_launches(ex, lps) if ex is not None else
                    _expected_launches_emulator(cfg.n_layers))
            if launches != want:
                raise AssertionError(f"remat {path} ({policy}) launched "
                                     f"{launches}, expected {want}")
        (plain, l0, d0), (pol, l1, d1) = runs[None], runs[REMAT_POLICY]
        _hold_step("remat", f"{path}/{REMAT_POLICY}", pol, plain, names)
        log("remat", path=path, dots_without=d0, dots_with=d1,
            launches_equal=l0 == l1)
        if l0 != l1 or not d1 < d0:
            raise AssertionError(f"remat {path}: launches {l0} -> {l1}, "
                                 f"matrix products {d0} -> {d1}")
    del trainer, params, runs
    torch.cuda.empty_cache()

    # (b) dropout 0.2: REMAT_STEPS Trainer steps a run, in turns
    by_run, trajectories = {}, {}
    for k, policy in enumerate(REMAT_RUNS):
        trainer = _sched_trainer(cfg, "1f1b", "except_last")
        trainer.scheduled = dataclasses.replace(trainer.scheduled,
                                                remat_policy=policy)
        state = trainer.init_state()
        _zero_launches()
        resident = _reset_peak()
        losses, step_s = [], []
        for b in range(REMAT_STEPS):
            t_step = time.perf_counter()
            state, info = trainer.train_epoch(source, epoch=0, state=state,
                                              max_steps=b + 1, start_step=b,
                                              log_every=0)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t_step)
            losses.append(info["loss"])
        launches = _launch_counts()
        steady = sum(step_s[1:]) / (REMAT_STEPS - 1)
        key = f"1f1b/except_last/{policy or 'none'}"
        by_run.setdefault(key, launches)
        trajectories.setdefault(key, losses)
        log("remat", run=f"{key}#{k}", dropout=cfg.dropout,
            steps=REMAT_STEPS, losses=[f"{l:.6f}" for l in losses],
            ms_per_step=[f"{t * 1e3:.1f}" for t in step_s],
            steady_ms_per_step=f"{steady * 1e3:.1f}",
            train_tokens_per_s=f"{tokens_per_step / steady:.1f}",
            resident_bytes=resident,
            peak_bytes=torch.cuda.max_memory_allocated(),
            memory_plan=trainer.scheduled.memory_plan(CHUNKS), **launches)
        expected = _expected_launches(trainer.scheduled, lps, REMAT_STEPS)
        if not all(math.isfinite(l) for l in losses):
            raise AssertionError(f"remat {key}: non-finite loss {losses}")
        if launches != expected:
            raise AssertionError(f"remat {key} launched {launches} in "
                                 f"{REMAT_STEPS} steps, expected {expected}")
        del trainer, state
        torch.cuda.empty_cache()
    (key_a, traj_a), (key_b, traj_b) = trajectories.items()
    rel = max(abs(a - b) / abs(b) for a, b in zip(traj_b, traj_a))
    log("remat", trajectory=key_b, against=key_a, max_loss_rel=f"{rel:.3e}")
    if not rel <= TOL_SCHED_TRAJ:
        raise AssertionError(f"remat {key_b}'s trajectory is {rel:.3e} from "
                             f"{key_a}'s (tol {TOL_SCHED_TRAJ})")
    log("remat", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_run


def phase_gpt2_serve() -> None:
    """GPT-2-small served at full width; the gates of the module
    docstring's phase 5e."""
    import contextlib
    import io

    import numpy as np

    from pipe_tpu_torch.apps import generate as gen_app
    from pipe_tpu_torch.apps import serve as serve_app
    from pipe_tpu_torch.inference import GenerationConfig, Generator
    from pipe_tpu_torch.models import gpt2
    from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                      SingleDeviceSlotBackend)

    t_phase = time.perf_counter()
    cfg = gpt2.GPT2Config()
    model = gpt2.PipelinedGPT2(
        cfg, device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    rng = np.random.RandomState(SEED)
    requests = []
    for _ in range(GPT2_SERVE_REQUESTS):
        plen = int(rng.randint(GPT2_SERVE_PROMPT[0], GPT2_SERVE_PROMPT[1] + 1))
        new = int(rng.randint(GPT2_SERVE_NEW[0], GPT2_SERVE_NEW[1] + 1))
        requests.append((rng.randint(2, cfg.vocab, size=plen).tolist(), new))
    seeds = list(range(GPT2_SERVE_REQUESTS))
    buckets = BucketSpec.pow2(*SERVE_BUCKETS)
    max_new = GPT2_SERVE_NEW[1]
    greedy = GenerationConfig(max_new_tokens=max_new, temperature=0.0)

    # the batch-1 references, and the naive re-forward of each
    refs, margins, clear_steps = [], [], 0
    t0 = time.perf_counter()
    for prompt, new in requests:
        toks = Generator(model, GenerationConfig(
            max_new_tokens=new, temperature=0.0)).generate([prompt])[0]
        toks = toks.tolist()
        m, logits = _margins(model, prompt, toks)
        clear = torch.tensor(m, device="cuda") > GPT2_TIE
        picked = logits.argmax(-1)
        want = torch.tensor(toks, device="cuda")
        if not bool((picked[clear] == want[clear]).all()):
            raise AssertionError("gpt2_serve: the Generator's greedy tokens "
                                 "are not the argmax of a naive re-forward "
                                 "at clear steps")
        clear_steps += int(clear.sum())
        refs.append(toks)
        margins.append(m)
    log("gpt2_serve", params=sum(p.numel() for p in model.parameters()),
        requests=len(requests),
        prompt_tokens=sum(len(p) for p, _ in requests),
        new_tokens=sum(n for _, n in requests),
        reforward_clear_steps=clear_steps,
        reference_s=f"{time.perf_counter() - t0:.1f}")

    runs = (("slab-tick", dict(resident=False)),
            ("paged-resident", dict(kv_block_size=PAGED_BLOCK,
                                    resident=True)),
            ("ngram-spec", dict(resident=True,
                                spec_tokens=GPT2_SERVE_SPEC_K)))
    for name, kw in runs:
        slack = GPT2_SERVE_SPEC_K - 1 if "spec_tokens" in kw else 0
        backend = SingleDeviceSlotBackend(
            model, num_slots=GPT2_SERVE_SLOTS,
            max_len=buckets.max_len + max_new + slack, gen=greedy,
            buckets=buckets, decode_chunk=1, **kw)
        eng = ServeEngine(backend)
        _zero_launches()
        for turn in ("cold", "warm"):       # the first run captures
            resps, wall = _traffic(eng, requests, seeds)
            compared = skipped = identical = 0
            for resp, ref, m, (_, new) in zip(resps, refs, margins,
                                               requests):
                if resp.status != "ok" or len(resp.tokens) != new:
                    raise AssertionError(
                        f"gpt2_serve {name}: request {resp.request_id} "
                        f"{resp.status} {resp.finish_reason}, "
                        f"{len(resp.tokens)} of {new} tokens")
                c, sk, ok = _walk(resp.tokens, ref, m, GPT2_TIE)
                if not ok:
                    raise AssertionError(
                        f"gpt2_serve {name}: request {resp.request_id} "
                        f"parts from its Generator reference at a clear "
                        f"step")
                compared, skipped = compared + c, skipped + sk
                identical += resp.tokens == ref
            log("gpt2_serve", run=f"{name}/{turn}", identical_streams=
                f"{identical}/{len(requests)}", compared_steps=compared,
                near_tie_skipped=skipped, **_rates(resps, wall),
                peak_bytes=torch.cuda.max_memory_allocated())
        flash = _launch_counts()
        log("gpt2_serve", run=name, **flash)
        if any(flash.values()):
            raise AssertionError(f"gpt2_serve {name}: the engine launched "
                                 f"{flash}")
        del eng, backend
        torch.cuda.empty_cache()
    del model
    torch.cuda.empty_cache()

    # the entry points at full width
    for app, argv in ((gen_app, ["--family", "gpt2", "--max-new", "16",
                                 "--batch", "2"]),
                      (serve_app, ["--family", "gpt2", "--requests", "8",
                                   "--max-new", "16", "--slots", "4"])):
        out = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = app.main(argv)
        lines = out.getvalue().splitlines()
        log("gpt2_serve", app=app.__name__.rsplit(".", 1)[-1],
            argv=" ".join(argv), rc=rc, lines=len(lines),
            seconds=f"{time.perf_counter() - t0:.1f}")
        if rc != 0:
            raise AssertionError(f"{app.__name__} {argv} exited {rc}")
        if app is serve_app and [json.loads(l)["status"]
                                 for l in lines[:-1]] != ["ok"] * 8:
            raise AssertionError(f"apps.serve --family gpt2: {lines[:-1]}")
    log("gpt2_serve", seconds=f"{time.perf_counter() - t_phase:.1f}")


def phase_bert() -> dict:
    """BERT-large through the interleaved-1F1B table; returns each run's
    launches. The gates of the module docstring's phase 5f."""
    from pipe_tpu_torch.apps import zoo
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.schedule import InterleavedOneFOneBSchedule
    from pipe_tpu_torch.models import bert
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    t_phase = time.perf_counter()
    cfg = bert.BertConfig(attn_impl="flash")          # dropout 0.1
    cfg0 = dataclasses.replace(cfg, dropout=0.0)
    n_virtual = BERT_STAGES * BERT_INTERLEAVE
    lps = cfg.n_layers // n_virtual
    tokens_per_step = BERT_BATCH * cfg.seq_len
    interleaved = InterleavedOneFOneBSchedule(interleave=BERT_INTERLEAVE)

    def build(c, dtype=torch.float32):
        model = bert.PipelinedBERT(
            c, n_virtual, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0))
        return model.to(dtype)

    def table(model, schedule=interleaved, n_stages=BERT_STAGES,
              policy=None):
        return ScheduledPipeline(
            model.stage_fn, model.pre_fn, model.loss_post_fn,
            n_stages=n_stages, module=model, checkpoint="except_last",
            schedule=schedule, device="cuda", remat_policy=policy)

    def batch(step):
        x, rows = mb.stack_scatter(zoo.synthetic_batch(
            "bert", cfg, BERT_BATCH, step, "cuda"), BERT_CHUNKS)
        return x, mb.valid_row_mask(x, rows)

    # (a) dropout-0 twins: kernels, plain attention, float64
    x, w = batch(0)
    twins, launches_a = {}, None
    for name, impl, dtype in (("kernel", "flash", torch.float32),
                              ("plain", "xla", torch.float32),
                              ("f64", "xla", torch.float64)):
        model = build(dataclasses.replace(cfg0, attn_impl=impl,
                                          compute_dtype=dtype), dtype)
        ex = table(model)
        _zero_launches()
        resident = _reset_peak()
        t0 = time.perf_counter()
        loss, _ = ex.loss_and_grad(x, w, seed=SEED)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        launches = _launch_counts()
        grads = [p.grad for p in model.parameters()]
        names = [n for n, _ in model.named_parameters()]
        twins[name] = (loss.item(), grads)
        if name == "kernel":
            n_params = sum(p.numel() for p in model.parameters())
            passes = ex.stage_passes(BERT_CHUNKS)
            launches_a = launches
            per_step = _expected_launches(ex, lps, m=BERT_CHUNKS)
            log("bert", params=n_params, virtual_stages=n_virtual,
                stages=BERT_STAGES, chunks=BERT_CHUNKS, batch=BERT_BATCH,
                seq=cfg.seq_len, stage_passes=passes,
                memory_plan=ex.memory_plan(BERT_CHUNKS))
            if launches != per_step:
                raise AssertionError(f"bert kernel twin launched {launches}, "
                                     f"expected {per_step}")
            kept = model                     # (b) reuses its weights
        elif any(launches.values()):
            raise AssertionError(f"bert {name} twin launched {launches}")
        log("bert", step=f"interleaved-1f1b/{name}", ms=f"{ms:.1f}",
            resident_bytes=resident,
            peak_bytes=torch.cuda.max_memory_allocated(), **launches)
        if name != "kernel":
            del model, ex, grads
            torch.cuda.empty_cache()
    ref = twins["kernel"]
    _hold_twins("bert", twins, names)

    # (b) the table gpipe over the 24 virtual stages, the same weights
    kept.zero_grad(set_to_none=True)
    ex = table(kept, schedule="gpipe", n_stages=n_virtual)
    resident = _reset_peak()
    loss, _ = ex.loss_and_grad(x, w, seed=SEED)
    log("bert", step="gpipe/kernel", resident_bytes=resident,
        peak_bytes=torch.cuda.max_memory_allocated(),
        memory_plan=ex.memory_plan(BERT_CHUNKS))
    _hold_step("bert", "interleaved-1f1b vs gpipe", ref,
               (loss.item(), [p.grad for p in kept.parameters()]), names)
    del kept, ex, ref, x, w
    torch.cuda.empty_cache()

    # (c, d) the zoo, config #4 at dropout 0.1
    by_run = {"twin/interleaved-1f1b": launches_a}
    argv = ["bert", "--stages", str(BERT_STAGES), "--interleave",
            str(BERT_INTERLEAVE), "--schedule", "interleaved-1f1b",
            "--chunks", str(BERT_CHUNKS), "--batch", str(BERT_BATCH),
            "--lr", str(TRAIN_LR), "--steps", str(BERT_ZOO_STEPS)]
    zoo_losses, zoo_ms, zoo_peak, launches = _run_zoo("bert", argv)
    expected = {k: BERT_ZOO_STEPS * v for k, v in per_step.items()}
    by_run["zoo/interleaved-1f1b"] = launches
    log("bert", run="zoo/interleaved-1f1b", dropout=cfg.dropout,
        losses=zoo_losses, steady_ms_per_step=f"{zoo_ms:.1f}",
        train_tokens_per_s=f"{tokens_per_step / zoo_ms * 1e3:.1f}",
        peak_bytes=zoo_peak, **launches)
    if launches != expected:
        raise AssertionError(f"bert zoo launched {launches} in "
                             f"{BERT_ZOO_STEPS} steps, expected {expected}")
    torch.cuda.empty_cache()

    # (e) the zoo's first steps again, with dots_saveable
    steps = BERT_POLICY_STEPS
    model = build(cfg)
    ex = table(model, policy=REMAT_POLICY)
    opt = torch.optim.Adam(model.parameters(), lr=TRAIN_LR)
    _zero_launches()
    resident = _reset_peak()
    losses, step_s = [], []
    for b in range(steps):
        x, w = batch(b)
        t_step = time.perf_counter()
        opt.zero_grad(set_to_none=True)
        loss, _ = ex.loss_and_grad(x, w, seed=b)
        opt.step()
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t_step)
    launches = _launch_counts()
    steady = (sum(step_s[1:]) / (steps - 1) if steps > 1 else step_s[0])
    key = f"loop/interleaved-1f1b/{REMAT_POLICY}"
    by_run[key] = launches
    log("bert", run=key, dropout=cfg.dropout, steps=steps,
        losses=[f"{l:.4f}" for l in losses],
        ms_per_step=[f"{t * 1e3:.1f}" for t in step_s],
        steady_ms_per_step=f"{steady * 1e3:.1f}",
        train_tokens_per_s=f"{tokens_per_step / steady:.1f}",
        resident_bytes=resident, peak_bytes=torch.cuda.max_memory_allocated(),
        memory_plan=ex.memory_plan(BERT_CHUNKS), **launches)
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, zoo_losses))
    want = {k: v * steps // BERT_ZOO_STEPS for k, v in expected.items()}
    if launches != want or not rel <= TOL_SCHED_TRAJ:
        raise AssertionError(f"bert {key}: launches {launches} (expected "
                             f"{want}), trajectory {rel:.3e} from the zoo's")
    del model, ex, opt
    torch.cuda.empty_cache()
    log("bert", seconds=f"{time.perf_counter() - t_phase:.1f}")
    return by_run


def phase_vit() -> None:
    """ViT-L/16 at full width; the gates of the module docstring's phase
    5g."""
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.apps import zoo
    from pipe_tpu_torch.models import vit
    from pipe_tpu_torch.models.common import per_row_ce
    from pipe_tpu_torch.ops.flash_attention import supports
    from pipe_tpu_torch.parallel.hetero_scheduled import \
        HeteroScheduledPipeline

    t_phase = time.perf_counter()
    cfg = vit.ViTConfig()                              # dropout 0.1
    log("vit", tokens=cfg.n_tokens, flash_supports=supports(cfg.n_tokens))

    # (a) the zoo, config #5
    argv = ["vit", "--stages", str(VIT_STAGES), "--chunks", str(VIT_CHUNKS),
            "--batch", str(VIT_BATCH), "--lr", str(TRAIN_LR), "--steps",
            str(VIT_STEPS)]
    losses, ms, peak, launches = _run_zoo("vit", argv)
    log("vit", run="zoo/1f1b", losses=losses, steady_ms_per_step=f"{ms:.1f}",
        train_images_per_s=f"{VIT_BATCH / ms * 1e3:.1f}",
        train_tokens_per_s=f"{VIT_BATCH * cfg.n_tokens / ms * 1e3:.1f}",
        peak_bytes=peak, **launches)
    if any(launches.values()):
        raise AssertionError(f"vit zoo launched {launches}: 197 tokens take "
                             f"plain attention")

    # (b) the uneven Pipe through the emulator and the hetero 1f1b table
    data = zoo.synthetic_batch("vit", cfg, VIT_BATCH, 0, "cuda")
    results = {}
    for path in ("emulator", "table-1f1b"):
        pipe = Pipe(vit.build_sequential(
            cfg, device="cuda",
            generator=torch.Generator(device="cuda").manual_seed(0)),
            chunks=VIT_CHUNKS, checkpoint="except_last",
            balance=VIT_BALANCE, device="cuda")
        _zero_launches()
        resident = _reset_peak()
        t0 = time.perf_counter()
        if path == "emulator":
            loss = per_row_ce(pipe(data["images"], train=True, seed=SEED),
                              data["labels"]).mean()
            loss.backward()
        else:
            ex = HeteroScheduledPipeline(pipe.partitions, pipe.skip_layout,
                                         VIT_CHUNKS, "except_last", "1f1b",
                                         device="cuda")
            loss, _ = ex.loss_and_grad(data["images"],
                                       targets=data["labels"],
                                       loss_fn=per_row_ce, seed=SEED)
        torch.cuda.synchronize()
        launches = _launch_counts()
        log("vit", step=path, balance=pipe.balance,
            ms=f"{(time.perf_counter() - t0) * 1e3:.1f}",
            resident_bytes=resident,
            peak_bytes=torch.cuda.max_memory_allocated(), **launches)
        if any(launches.values()):
            raise AssertionError(f"vit {path} launched {launches}")
        names = [n for n, _ in pipe.named_parameters()]
        results[path] = (loss.item(), [p.grad for p in pipe.parameters()])
        del pipe
    _hold_step("vit", "table-1f1b vs emulator", results["table-1f1b"],
               results["emulator"], names)
    del results, data
    torch.cuda.empty_cache()
    log("vit", seconds=f"{time.perf_counter() - t_phase:.1f}")


def teacher_forced(model, tokens, prompt_len):
    """Logits of ``tokens [b, s]`` through the KV caches: a prefill of the
    first ``prompt_len`` tokens, then one token a step; ``[b, s - 1, V]``
    (the logits that predict tokens 1 .. s - 1)."""
    from pipe_tpu_torch.inference.generate import head_logits

    b, s = tokens.shape
    caches = [blk.attn.make_cache(b, s) for blk in model.blocks]
    h = model.embed_at(tokens[:, :prompt_len], 0)
    for l, blk in enumerate(model.blocks):
        h, caches[l] = blk.decode(h, caches[l], 0)
    out = [head_logits(model, h)]
    for t in range(prompt_len, s - 1):
        h = model.embed_at(tokens[:, t:t + 1], t)
        for l, blk in enumerate(model.blocks):
            h, caches[l] = blk.decode(h, caches[l], t)
        out.append(head_logits(model, h))
    return torch.cat(out, dim=1)


def _seq_logprob(pipe, prompt, cont):
    """Total log-prob of ``cont`` after ``prompt`` by the ``Pipe`` forward."""
    logits = pipe(torch.cat([prompt, cont], dim=1))
    p = prompt.shape[1]
    logp = torch.log_softmax(logits[:, p - 1:-1].double(), dim=-1)
    return torch.gather(logp, -1, cont[..., None])[..., 0].sum(-1)


def _timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _decode_bound_ms(model, batch, max_len):
    """Least time of one decode step: every block and decoder weight byte
    (int8 codes and their scales where quantized) and the whole KV cache
    read once at PEAK_BYTES; the embedding reads only ``batch`` rows."""
    def nbytes(mod):
        return sum(t.numel() * t.element_size()
                   for t in [*mod.parameters(), *mod.buffers()])
    weights = nbytes(model.blocks) + nbytes(model.decoder)
    cfg = model.cfg
    cache = 2 * cfg.n_layers * batch * max_len * cfg.d_model * 4
    return (weights + cache) / PEAK_BYTES * 1e3, weights, cache


def phase_generate() -> float:
    """The generate phase; returns the teacher-forced logit gap, the
    rounding scale that the serve phase's margin gates are set from."""
    from pipe_tpu_torch.inference import (GenerationConfig, Generator,
                                          quantize_params, sequence_lengths)
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.ops import flash_attention as fa

    t0 = time.perf_counter()
    cfg, seq, pipe, batches = make_slice(
        (GEN_PROMPT + GEN_NEW) // BPTT)
    model = PipelinedLM.from_sequential(cfg, seq)
    tokens = torch.cat([x for x, _ in batches], dim=1)      # [8, 256]
    prompts = tokens[:, :GEN_PROMPT]
    log("generate", batch=GEN_BATCH, prompt=GEN_PROMPT, new=GEN_NEW,
        vocab=cfg.vocab, setup_s=f"{time.perf_counter() - t0:.2f}")

    def counted(fn):
        """``fn()`` with the flash forward's count set to 0 before it:
        (result, launches)."""
        fa.flash_attention_fwd.launches = 0
        out = fn()
        torch.cuda.synchronize()
        return out, fa.flash_attention_fwd.launches

    def gen(model, **kw):
        return Generator(model, GenerationConfig(max_new_tokens=GEN_NEW,
                                                 **kw))

    with torch.inference_mode():
        # 1. Teacher-forced cached logits against the Pipe eval forward.
        ref, ref_launches = counted(lambda: pipe(tokens))
        forced, launches = counted(lambda: teacher_forced(model, tokens,
                                                          GEN_PROMPT))
        gap = (forced - ref[:, :-1]).abs().max().item()
        log("generate", gate="teacher_forced", positions=forced.shape[1],
            max_abs_dlogits=f"{gap:.3e}", tol=TOL_LOGITS,
            reference_flash_launches=ref_launches,
            cached_flash_launches=launches)
        expected_ref = cfg.n_layers * CHUNKS
        if ref_launches != expected_ref or launches:
            raise AssertionError(
                f"flash launches: reference {ref_launches} (expected "
                f"{expected_ref}), cached path {launches} (expected 0)")
        if not gap <= TOL_LOGITS:
            raise AssertionError(f"cached logits {gap:.3e} from the Pipe "
                                 f"forward (tol {TOL_LOGITS})")
        del ref

        # 2. Greedy: timed, held to the forward's argmax where it is clear.
        greedy = gen(model, temperature=0.0)
        torch.cuda.reset_peak_memory_stats()
        (out, launches), first = _timed(lambda: counted(
            lambda: greedy.generate(prompts)))
        peak = torch.cuda.max_memory_allocated()
        again, wall = _timed(lambda: greedy.generate(prompts))
        if not torch.equal(again, out):
            raise AssertionError("greedy: a second call gave other tokens")
        prefill = sorted(_timed(lambda: Generator(model, GenerationConfig(
            max_new_tokens=1, temperature=0.0)).generate(prompts))[1]
            for _ in range(3))[1]
        decode_ms = (wall - prefill) * 1e3 / (GEN_NEW - 1)
        bound, w_bytes, kv_bytes = _decode_bound_ms(
            model, GEN_BATCH, GEN_PROMPT + GEN_NEW)
        logits = pipe(torch.cat([prompts, out], dim=1))[:, GEN_PROMPT - 1:-1]
        top2 = torch.topk(logits, 2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > MARGIN_OVER_GAP * gap
        agree = logits.argmax(-1) == out
        log("generate", gate="greedy", prefill_ms=f"{prefill * 1e3:.2f}",
            decode_ms_per_step=f"{decode_ms:.3f}",
            decode_bound_ms_per_step=f"{bound:.4f}",
            bound_share=f"{bound / decode_ms:.3f}",
            wall_s=f"{wall:.4f}", first_call_wall_s=f"{first:.4f}",
            generated_tokens_per_s=f"{GEN_BATCH * GEN_NEW / wall:.1f}",
            peak_mem_gb=f"{peak / 1e9:.2f}", kv_cache_bytes=kv_bytes,
            weight_bytes_per_step=w_bytes, flash_launches=launches,
            steps_compared=int(clear.sum()),
            steps_skipped=int((~clear).sum()))
        if launches or not agree[clear].all():
            raise AssertionError(
                f"greedy: {int((~agree[clear]).sum())} clear steps disagree "
                f"with the forward's argmax; flash launches {launches}")

        # EOS: the first token of row 0 from step GEN_EOS_STEP on that it
        # has not emitted before (so that its length is that step + 1).
        row = out[0].tolist()
        fresh = [s for s in range(GEN_NEW) if row[s] not in row[:s]]
        step = next((s for s in fresh if s >= GEN_EOS_STEP), fresh[-1])
        eos = row[step]
        (toks, lengths), launches = counted(lambda: gen(
            model, temperature=0.0, eos_token_id=eos).generate_with_lengths(
            prompts))
        want_len = sequence_lengths(out, eos)
        pos = torch.arange(GEN_NEW, device=out.device)[None]
        want = torch.where(pos < want_len[:, None], out, 0)
        log("generate", gate="eos", eos=eos, eos_step=step,
            row0_length=int(lengths[0]), lengths=lengths.tolist(),
            flash_launches=launches)
        if (int(lengths[0]) != step + 1 or not torch.equal(lengths, want_len)
                or not torch.equal(toks, want) or launches):
            raise AssertionError(f"EOS {eos}: lengths {lengths.tolist()} "
                                 f"(want {want_len.tolist()}), row 0 "
                                 f"{int(lengths[0])} (want {step + 1})")

        # 3. Beam search against the forward's sequence log-probs.
        bp = prompts[:GEN_BEAM_BATCH]
        ((beam, scores), launches), beam_wall = _timed(lambda: counted(
            lambda: gen(model, num_beams=GEN_BEAMS).generate_with_scores(bp)))
        ext = _seq_logprob(pipe, bp, beam)
        g_score = _seq_logprob(pipe, bp, out[:GEN_BEAM_BATCH])
        rel = ((scores.double() - ext).abs() / ext.abs()).max().item()
        log("generate", gate="beam", beams=GEN_BEAMS, batch=GEN_BEAM_BATCH,
            scores=[f"{x:.4f}" for x in scores.tolist()],
            forward_scores=[f"{x:.4f}" for x in ext.tolist()],
            greedy_scores=[f"{x:.4f}" for x in g_score.tolist()],
            max_rel=f"{rel:.3e}", wall_s=f"{beam_wall:.4f}",
            flash_launches=launches)
        if launches or not rel <= TOL_BEAM_REL:
            raise AssertionError(f"beam scores {rel:.3e} from the forward's")
        if not (ext >= g_score - TOL_BEAM_REL * g_score.abs()).all():
            raise AssertionError("beam search scored below greedy")

        # 4. Sampling: reproducible from its seed, inside the top k.
        sampler = gen(model, temperature=GEN_TEMPERATURE, top_k=GEN_TOP_K)
        (a, launches), sample_wall = _timed(lambda: counted(
            lambda: sampler.generate(prompts, seed=1)))
        again, other = (sampler.generate(prompts, seed=sd) for sd in (1, 2))
        logits = pipe(torch.cat([prompts, a], dim=1))[:, GEN_PROMPT - 1:-1]
        kth = torch.topk(logits, GEN_TOP_K, dim=-1).values[..., -1]
        picked = torch.gather(logits, -1, a[..., None])[..., 0]
        inside = (picked >= kth - 2 * TOL_LOGITS).float().mean().item()
        log("generate", gate="sampled", temperature=GEN_TEMPERATURE,
            top_k=GEN_TOP_K, same_seed_equal=torch.equal(a, again),
            other_seed_differs=not torch.equal(a, other),
            share_in_top_k=inside, wall_s=f"{sample_wall:.4f}",
            flash_launches=launches)
        if (launches or not torch.equal(a, again) or torch.equal(a, other)
                or inside != 1.0):
            raise AssertionError("sampling: not reproducible from its seed, "
                                 "or a token outside the top k")

        # 5. int8 weights: logits against fp32, greedy agreement, timing.
        qmodel = quantize_params(model)
        q_forced = teacher_forced(qmodel, tokens, GEN_PROMPT)
        q_rel = ((q_forced - forced).abs().max()
                 / forced.abs().max()).item()
        del q_forced
        q_greedy = gen(qmodel, temperature=0.0)
        (q_out, launches), q_first = _timed(lambda: counted(
            lambda: q_greedy.generate(prompts)))
        q_wall = _timed(lambda: q_greedy.generate(prompts))[1]
        q_prefill = sorted(_timed(lambda: Generator(qmodel, GenerationConfig(
            max_new_tokens=1, temperature=0.0)).generate(prompts))[1]
            for _ in range(3))[1]
        q_decode = (q_wall - q_prefill) * 1e3 / (GEN_NEW - 1)
        q_bound, q_w_bytes, _ = _decode_bound_ms(
            qmodel, GEN_BATCH, GEN_PROMPT + GEN_NEW)
        log("generate", gate="int8", max_rel_dlogits=f"{q_rel:.4e}",
            tol=TOL_INT8_REL,
            greedy_agreement=f"{(q_out == out).float().mean().item():.4f}",
            prefill_ms=f"{q_prefill * 1e3:.2f}",
            decode_ms_per_step=f"{q_decode:.3f}",
            decode_bound_ms_per_step=f"{q_bound:.4f}",
            weight_bytes_per_step=q_w_bytes,
            generated_tokens_per_s=f"{GEN_BATCH * GEN_NEW / q_wall:.1f}",
            wall_s=f"{q_wall:.4f}", first_call_wall_s=f"{q_first:.4f}",
            flash_launches=launches)
        if launches or not q_rel <= TOL_INT8_REL:
            raise AssertionError(f"int8 logits {q_rel:.4e} from fp32 "
                                 f"(tol {TOL_INT8_REL})")
    del qmodel, model, seq, pipe
    torch.cuda.empty_cache()
    return gap


def _margins(model, prompt, toks, cfg=None, seed=0):
    """Top-2 margins of the scores that picked each of ``toks`` after
    ``prompt`` (the ``PipelinedLM`` forward over the whole sequence), and
    those logits. Greedy: the logits. Sampled (``cfg``): the Gumbel-max
    scores, ``logits / T`` masked to the top k plus the engine's keyed
    noise of ``seed`` at each step."""
    from pipe_tpu_torch.inference import keyed_uniform, seed_word

    dev = next(model.parameters()).device
    x = torch.tensor([list(prompt) + list(toks)], device=dev)
    with torch.no_grad():
        logits = model.post_fn(model.stage_fn(0, model.pre_fn(x)))[0]
    logits = logits[len(prompt) - 1:-1]
    scores = logits
    if cfg is not None:
        scores = logits / cfg.temperature
        kth = torch.topk(scores, cfg.top_k, dim=-1).values[..., -1:]
        scores = torch.where(scores >= kth, scores, -1e30)
        n, vocab = scores.shape
        u = keyed_uniform(torch.full((n,), seed_word(seed), device=dev),
                          torch.arange(n, device=dev), vocab)
        scores = scores + -torch.log(-torch.log(u))
    top2 = torch.topk(scores, 2, dim=-1).values
    return (top2[:, 0] - top2[:, 1]).tolist(), logits


def _walk(got, ref, margins, thresh):
    """``got`` against the reference stream ``ref``, step by step, checked
    where the reference's margin exceeds ``thresh``: ``(compared, skipped,
    ok)``. Where the two differ at a step inside the margin (a near tie)
    the streams part, and the rest is skipped; a difference at a clear
    step, or a stream of another length, fails."""
    compared = skipped = 0
    for t in range(len(ref)):
        clear = margins[t] > thresh
        if t >= len(got) or got[t] != ref[t]:
            return (compared, skipped + len(ref) - t,
                    t < len(got) and not clear)
        compared += clear
        skipped += not clear
    return compared, skipped, len(got) == len(ref)


def _profile_ticks(run, n=SERVE_PROFILED_TICKS):
    """Host launch calls and device kernels per call of ``run`` (a decode
    tick or launch) over ``n`` calls (``torch.profiler``):
    ``(launch calls by name per call, kernels per call, device busy ms per
    call)``, busy as the union of the kernels' spans."""
    from torch.profiler import DeviceType, ProfilerActivity, profile

    names = ("cudaGraphLaunch", "cudaLaunchKernel", "cudaLaunchKernelExC",
             "cuLaunchKernel", "cuLaunchKernelEx", "cudaMemcpyAsync",
             "cudaMemsetAsync")
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            run()
        torch.cuda.synchronize()
    calls = {}
    spans = []
    for e in prof.events():
        if e.device_type == DeviceType.CPU and e.name in names:
            calls[e.name] = calls.get(e.name, 0) + 1
        elif (e.device_type == DeviceType.CUDA
              and not getattr(e, "is_user_annotation", False)):
            spans.append((e.time_range.start, e.time_range.end))
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(spans):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    return ({k: v / n for k, v in sorted(calls.items())}, len(spans) / n,
            busy / 1e3 / n)


def _traffic(eng, reqs, req_seeds):
    """SERVE_FIRST requests before the first tick, then two a tick, then
    ticks until idle: (responses in submit order, wall)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=n, seed=sd).id
           for (p, n), sd in zip(reqs[:SERVE_FIRST], req_seeds)]
    for i in range(SERVE_FIRST, len(reqs), 2):
        eng.tick()
        ids += [eng.submit(p, max_new_tokens=n, seed=sd).id
                for (p, n), sd in zip(reqs[i:i + 2], req_seeds[i:i + 2])]
    eng.run_until_idle()
    torch.cuda.synchronize()
    return [eng.response(r) for r in ids], time.perf_counter() - t0


def _rates(resps, wall):
    from pipe_tpu_torch.obs.telemetry import percentile_exact
    ttft = [r.ttft for r in resps]
    made = sum(len(r.tokens) for r in resps)
    return dict(ttft_p50_ms=f"{percentile_exact(ttft, 0.5) * 1e3:.2f}",
                ttft_p99_ms=f"{percentile_exact(ttft, 0.99) * 1e3:.2f}",
                generated_tokens=made, wall_s=f"{wall:.4f}",
                generated_tokens_per_s=f"{made / wall:.1f}")


def phase_serve(gap: float, smi: str) -> dict:
    """The serve phase (slab KV, the single-chunk tick); returns what the
    paged/resident phase reuses: the model, the traffic, the batch-1
    references and their margins, and the slab engine's runs."""
    import numpy as np

    from pipe_tpu_torch.inference import GenerationConfig, Generator
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.serve import (BucketSpec, ServeEngine,
                                      SingleDeviceSlotBackend)

    t_phase = time.perf_counter()
    card = smi.splitlines()[0]
    cfg, seq, pipe, batches = make_slice((GEN_PROMPT + GEN_NEW) // BPTT)
    del pipe
    model = PipelinedLM.from_sequential(cfg, seq)
    tokens = torch.cat([x for x, _ in batches], dim=1).cpu()   # [8, 256]
    rng = np.random.RandomState(SEED)
    requests = []
    for i in range(SERVE_REQUESTS):
        plen = int(rng.randint(SERVE_PROMPT[0], SERVE_PROMPT[1] + 1))
        new = int(rng.randint(SERVE_NEW[0], SERVE_NEW[1] + 1))
        start = int(rng.randint(0, tokens.shape[1] - plen + 1))
        requests.append(
            (tokens[i % EVAL_BATCH, start:start + plen].tolist(), new))
    seeds = list(range(SERVE_REQUESTS))
    buckets = BucketSpec.pow2(*SERVE_BUCKETS)
    touched = sorted({buckets.bucket_for(len(p)) for p, _ in requests})
    reg = get_registry()
    thresh = MARGIN_OVER_GAP * gap
    log("serve", slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN,
        buckets=list(buckets.lengths), requests=SERVE_REQUESTS,
        prompt_tokens=sum(len(p) for p, _ in requests),
        new_tokens=sum(n for _, n in requests), buckets_touched=touched,
        margin_threshold=f"{thresh:.3e}",
        setup_s=f"{time.perf_counter() - t_phase:.2f}")

    def backend(gen, slots=SERVE_SLOTS, **kw):
        kw.setdefault("resident", False)     # the single-chunk tick
        return SingleDeviceSlotBackend(
            model, num_slots=slots, max_len=SERVE_MAX_LEN, gen=gen,
            buckets=buckets, decode_chunk=1, **kw)

    greedy = GenerationConfig(max_new_tokens=SERVE_NEW[1], temperature=0.0)
    # 1. The main path: the greedy traffic through one engine, twice (the
    # first run captures the decode graph; the second is warm).
    main = backend(greedy)
    eng = ServeEngine(main)
    traces0 = reg.counter("serve.engine.decode_traces").value
    for c in _counters():
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    cold, cold_wall = _traffic(eng, requests, seeds)
    warm, warm_wall = _traffic(eng, requests, seeds)
    peak = torch.cuda.max_memory_allocated()
    flash = [c.launches for c in _counters()]
    traces = reg.counter("serve.engine.decode_traces").value - traces0
    stats = main.program_stats()
    for run, resps, wall in (("cold", cold, cold_wall),
                             ("warm", warm, warm_wall)):
        log("serve", run=run, card=repr(card), **_rates(resps, wall),
            ttft_note="submit to first token, queueing included")
    log("serve", gate="engine", card=repr(card), decode_traces=traces,
        decode_graph=stats["decode_graph"],
        prefill_shapes=stats["prefill_programs"],
        buckets_touched=len(touched), flash_launches=flash,
        peak_mem_gb=f"{peak / 1e9:.2f}")
    bad = [i for i, ((_, n), r) in enumerate(zip(requests, cold))
           if r.status != "ok" or r.finish_reason != "length"
           or len(r.tokens) != n]
    if bad:
        raise AssertionError(f"serve: requests {bad} did not run to length")
    if [r.tokens for r in warm] != [r.tokens for r in cold]:
        raise AssertionError("serve: the warm run gave other tokens")
    if traces != 1 or not stats["decode_graph"]:
        raise AssertionError(f"serve: decode step captured {traces} times "
                             f"(graph {stats['decode_graph']}), expected 1")
    if stats["prefill_programs"] != len(touched):
        raise AssertionError(f"serve: {stats['prefill_programs']} prefill "
                             f"shapes for {len(touched)} buckets touched")
    if any(flash):
        raise AssertionError(f"serve: the engine launched kernels {flash}")

    # 2. (a) Each response against a batch-1 Generator on its prompt.
    t0 = time.perf_counter()
    compared = skipped = 0
    refs, ref_margins = [], []
    for i, ((p, n), r) in enumerate(zip(requests, cold)):
        ref = Generator(model, GenerationConfig(
            max_new_tokens=n, temperature=0.0)).generate([p])[0].tolist()
        margins, _ = _margins(model, p, ref)
        refs.append(ref)
        ref_margins.append(margins)
        c, sk, ok = _walk(r.tokens, ref, margins, thresh)
        compared, skipped = compared + c, skipped + sk
        if not ok:
            raise AssertionError(f"serve: request {i} differs from the "
                                 f"batch-1 Generator at a clear step")
    log("serve", gate="greedy_vs_generator", steps_compared=compared,
        steps_skipped_near_ties=skipped,
        seconds=f"{time.perf_counter() - t0:.2f}")

    # 3. (g) The same engine run eagerly on the card; (d) EOS.
    first = requests[:SERVE_SLOTS]
    eager = backend(greedy, cuda_graph=False)
    e_resps, e_wall = _traffic(ServeEngine(eager), first, seeds)
    equal, g_margins = 0, []
    for i, ((p, _), er, r) in enumerate(zip(first, e_resps, cold)):
        m, _ = _margins(model, p, r.tokens)
        g_margins.append(m)
        equal += er.tokens == r.tokens
        if not _walk(er.tokens, r.tokens, m, thresh)[2]:
            raise AssertionError(f"serve: eager request {i} differs from "
                                 f"the graph's at a clear step")
    log("serve", gate="graph_vs_eager", requests=len(first),
        equal_requests=equal, eager_decode_graph=eager.program_stats()[
            "decode_graph"], **_rates(e_resps, e_wall))
    if equal < 1 or eager.program_stats()["decode_graph"]:
        raise AssertionError("serve: no request equal between the graph "
                             "and the eager engine")
    row = cold[0].tokens
    fresh = [t for t in range(len(row)) if row[t] not in row[:t]]
    step = next((t for t in fresh if t >= GEN_EOS_STEP), fresh[-1])
    eos = row[step]
    e_gen = GenerationConfig(max_new_tokens=SERVE_NEW[1], temperature=0.0,
                             eos_token_id=eos)
    eos_resps, _ = _traffic(ServeEngine(backend(e_gen)), first, seeds)
    r0 = eos_resps[0]
    others_ok = all(
        (r.finish_reason == "eos" and r.tokens[-1] == eos
         and eos not in r.tokens[:-1])
        or (r.finish_reason == "length" and eos not in r.tokens
            and len(r.tokens) == n)
        for r, (_, n) in zip(eos_resps, first))
    log("serve", gate="eos", eos=eos, eos_step=step,
        request0=r0.finish_reason, request0_tokens=len(r0.tokens),
        reasons=[r.finish_reason for r in eos_resps])
    if (r0.finish_reason != "eos" or r0.tokens != row[:step + 1]
            or not others_ok):
        raise AssertionError(f"serve: EOS {eos} did not retire request 0 "
                             f"at step {step} with nothing past it")

    # 4. (e) Sampled requests alone in a 1-slot engine, among the traffic,
    # and again: equal where the Gumbel-max scores are clear, every pick in
    # the top k.
    s_gen = GenerationConfig(max_new_tokens=SERVE_NEW[1],
                             temperature=GEN_TEMPERATURE, top_k=GEN_TOP_K)
    sampled = requests[-SERVE_SAMPLED:]
    s_seeds = [1000 + i for i in range(SERVE_SAMPLED)]
    alone_eng = ServeEngine(backend(s_gen, slots=1))
    alone = []
    for (p, n), sd in zip(sampled, s_seeds):
        rid = alone_eng.submit(p, max_new_tokens=n, seed=sd).id
        alone_eng.run_until_idle()
        alone.append(alone_eng.response(rid).tokens)
    mixed, mixed_seeds, where = [], [], []
    every = SERVE_REQUESTS // SERVE_SAMPLED     # a sampled one every `every`
    for i, (req, sd) in enumerate(zip(requests, seeds)):
        mixed.append(req)
        mixed_seeds.append(sd)
        if i % every == 1:
            where.append(len(mixed))
            mixed.append(sampled[len(where) - 1])
            mixed_seeds.append(s_seeds[len(where) - 1])
    crowd, crowd_wall = _traffic(ServeEngine(backend(s_gen)), mixed,
                                mixed_seeds)
    again, _ = _traffic(ServeEngine(backend(s_gen)), sampled, s_seeds)
    s_thresh = thresh / GEN_TEMPERATURE
    compared = skipped = inside = picks = 0
    for i, ((p, _), sd, a) in enumerate(zip(sampled, s_seeds, alone)):
        m, logits = _margins(model, p, a, s_gen, sd)
        kth = torch.topk(logits, GEN_TOP_K, dim=-1).values[:, -1]
        picked = logits[torch.arange(len(a)), torch.tensor(a)]
        inside += int((picked >= kth - 2 * TOL_LOGITS).sum())
        picks += len(a)
        for other in (crowd[where[i]].tokens, again[i].tokens):
            c, sk, ok = _walk(other, a, m, s_thresh)
            compared, skipped = compared + c, skipped + sk
            if not ok:
                raise AssertionError(f"serve: sampled request {i} depends "
                                     f"on its co-tenants or its run")
    log("serve", gate="sampled", temperature=GEN_TEMPERATURE,
        top_k=GEN_TOP_K, requests=SERVE_SAMPLED, co_tenants=len(mixed) - 1,
        steps_compared=compared, steps_skipped_near_ties=skipped,
        share_in_top_k=f"{inside / picks:.4f}", **_rates(crowd, crowd_wall))
    if inside != picks:
        raise AssertionError("serve: a sampled token outside the top k")

    # 5. Decode ms per tick (all slots live) against its bound, graph and
    # eager on the card in turns; launches per tick; prefill ms.
    live = np.ones(SERVE_SLOTS, bool)

    def tick_ms(b):
        times = []
        for _ in range(SERVE_TIMED_TICKS):
            t0 = time.perf_counter()
            b.decode(live)                        # reads the tokens back
            times.append((time.perf_counter() - t0) * 1e3)
        return sorted(times)

    turns = {"graph": [], "eager": []}
    for name, b in (("graph", main), ("eager", eager), ("eager", eager),
                    ("graph", main)):
        turns[name] += tick_ms(b)
    bound, w_bytes, kv_bytes = _decode_bound_ms(model, SERVE_SLOTS,
                                                SERVE_MAX_LEN)
    for name, b in (("graph", main), ("eager", eager)):
        t = sorted(turns[name])
        calls, kernels, busy = _profile_ticks(lambda: b.decode(live))
        log("serve", decode=name, card=repr(card),
            decode_ms_per_tick=f"{t[len(t) // 2]:.4f}",
            decode_ms_min=f"{t[0]:.4f}", decode_ms_max=f"{t[-1]:.4f}",
            decode_bound_ms=f"{bound:.4f}",
            bound_share=f"{bound / t[len(t) // 2]:.3f}",
            launch_calls_per_tick=f"{sum(calls.values()):.1f}",
            launch_calls=json.dumps(calls).replace(" ", ""),
            kernels_per_tick=f"{kernels:.1f}",
            device_busy_ms_per_tick=f"{busy:.4f}",
            weight_bytes=w_bytes, kv_cache_bytes=kv_bytes)
    pre = {}
    for blen in (SERVE_BUCKETS[0], SERVE_BUCKETS[1]):
        prompt = tokens[0, :blen].tolist()
        pre[blen] = sorted(_timed(lambda: main.prefill(0, prompt, 0))[1]
                           for _ in range(3))[1] * 1e3
    log("serve", card=repr(card), **{f"prefill_ms_{k}": f"{v:.2f}"
                                     for k, v in pre.items()},
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del eager, eng, seq
    torch.cuda.empty_cache()
    return dict(model=model, tokens=tokens, requests=requests, seeds=seeds,
                buckets=buckets, thresh=thresh, refs=refs,
                ref_margins=ref_margins, cold=cold, main=main,
                first=first, e_gen=e_gen, eos_resps=eos_resps, eos=eos,
                s_gen=s_gen, sampled=sampled, s_seeds=s_seeds,
                slab_tick_ms=turns["graph"])


def _delta(reg, names):
    """A function returning each counter's rise since this call."""
    base = {n: reg.counter(n).value for n in names}
    return lambda: {n: reg.counter(n).value - base[n] for n in names}


def _serial(eng, reqs, req_seeds):
    """Each request alone: submit it, tick until idle. Responses."""
    out = []
    for (p, n), sd in zip(reqs, req_seeds):
        rid = eng.submit(p, max_new_tokens=n, seed=sd).id
        eng.run_until_idle()
        out.append(eng.response(rid))
    return out


def phase_serve_paged(ctx: dict, smi: str) -> dict:
    """The paged KV pool and the resident loop through ``ServeEngine`` at
    full width, on the serve phase's model, traffic and references; returns
    the resident (non-spec) runs the spec phase holds its tokens to."""
    import numpy as np

    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.serve import ServeEngine, SingleDeviceSlotBackend

    t_phase = time.perf_counter()
    card = repr(smi.splitlines()[0])
    model, tokens = ctx["model"], ctx["tokens"]
    requests, seeds, thresh = ctx["requests"], ctx["seeds"], ctx["thresh"]
    reg = get_registry()
    greedy = GenerationConfig(max_new_tokens=SERVE_NEW[1], temperature=0.0)
    torch.cuda.reset_peak_memory_stats()

    def backend(gen, **kw):
        kw.setdefault("kv_block_size", PAGED_BLOCK)
        kw.setdefault("resident", False)
        return SingleDeviceSlotBackend(
            model, num_slots=SERVE_SLOTS, max_len=SERVE_MAX_LEN, gen=gen,
            buckets=ctx["buckets"], decode_chunk=1,
            resident_chunks=RESIDENT_CHUNKS, **kw)

    def to_length(resps, reqs, what):
        bad = [i for i, ((_, n), r) in enumerate(zip(reqs, resps))
               if r.status != "ok" or len(r.tokens) != n]
        if bad:
            raise AssertionError(f"{what}: requests {bad} did not run to "
                                 f"their length")

    def same(a, b, what):
        if [r.tokens for r in a] != [r.tokens for r in b]:
            diff = [i for i, (x, y) in enumerate(zip(a, b))
                    if x.tokens != y.tokens]
            raise AssertionError(f"{what}: requests {diff} differ")

    # 1. (a), (b), (h): the paged tick path over the serve traffic, its
    # greedy tokens against the batch-1 Generator references.
    counts = _delta(reg, ("serve.engine.decode_traces",
                          "serve.engine.prefill_chunk_traces"))
    pg = backend(greedy)
    pg_resps, pg_wall = _traffic(ServeEngine(pg), requests, seeds)
    traces = counts()
    to_length(pg_resps, requests, "paged")
    compared = skipped = 0
    for i, (r, ref, m) in enumerate(zip(pg_resps, ctx["refs"],
                                        ctx["ref_margins"])):
        c, sk, ok = _walk(r.tokens, ref, m, thresh)
        compared, skipped = compared + c, skipped + sk
        if not ok:
            raise AssertionError(f"paged: request {i} differs from the "
                                 f"batch-1 Generator at a clear step")
    stats = pg.program_stats()
    pool_bytes = sum(a.numel() * a.element_size()
                     for a in pg._pool_kv.values())
    view_bytes = sum(a.numel() * a.element_size()
                     for a in pg._state["views"].values())
    log("paged", run="tick", card=card, **_rates(pg_resps, pg_wall),
        steps_compared=compared, steps_skipped_near_ties=skipped,
        decode_traces=traces["serve.engine.decode_traces"],
        prefill_chunk_traces=traces["serve.engine.prefill_chunk_traces"],
        prefill_programs=stats["prefill_programs"],
        prompt_lengths=len({len(p) for p, _ in requests}),
        blocks_in_use=pg.pool.stats()["blocks_in_use"],
        pool_blocks=pg.pool.num_blocks, pool_bytes=pool_bytes,
        view_bytes=view_bytes)
    if (list(traces.values()) != [1, 1] or stats["prefill_programs"] != 1
            or not stats["decode_graph"]):
        raise AssertionError(f"paged: traces {traces}, stats {stats}")
    if pg.pool.stats()["blocks_in_use"]:
        raise AssertionError("paged: the pool did not drain")

    # 2. (f), (g): resident="auto" on the card, paged, against the tick
    # path; prefills arm the device regather flag, nothing else decides.
    counts = _delta(reg, ("serve.engine.resident_traces",
                          "serve.kv.regather_host_decisions",
                          "serve.engine.admitted",
                          "serve.engine.resident_chunks_run",
                          "serve.engine.resident_chunks_computed",
                          "serve.engine.host_syncs",
                          "serve.engine.device_exits"))
    pr = backend(greedy, resident="auto")
    if not pr.resident:
        raise AssertionError("resident='auto' did not pick the resident "
                             "loop on the card")
    pr_resps, pr_wall = _traffic(ServeEngine(pr), requests, seeds)
    rc = counts()
    launches = rc["serve.engine.host_syncs"]
    ghost = (rc["serve.engine.resident_chunks_computed"]
             - rc["serve.engine.resident_chunks_run"])
    log("paged", run="resident_auto", card=card, **_rates(pr_resps, pr_wall),
        resident_traces=rc["serve.engine.resident_traces"],
        launches=launches,
        chunks_run=rc["serve.engine.resident_chunks_run"],
        chunks_computed=rc["serve.engine.resident_chunks_computed"],
        ghost_chunks_per_launch=f"{ghost / launches:.3f}",
        device_exits=rc["serve.engine.device_exits"],
        admitted=rc["serve.engine.admitted"],
        regather_host_decisions=rc["serve.kv.regather_host_decisions"])
    same(pr_resps, pg_resps, "paged resident vs tick")
    if (rc["serve.engine.resident_traces"] != 1
            or rc["serve.kv.regather_host_decisions"]
            != rc["serve.engine.admitted"]):
        raise AssertionError(f"paged resident: {rc}")
    if pr.pool.stats()["blocks_in_use"]:
        raise AssertionError("paged resident: the pool did not drain")

    # 3. (f): the slab resident loop against the serve phase's tick run.
    sr = backend(greedy, kv_block_size=None, resident=True)
    sr_resps, sr_wall = _traffic(ServeEngine(sr), requests, seeds)
    same(sr_resps, ctx["cold"], "slab resident vs tick")
    log("paged", run="slab_resident", card=card, **_rates(sr_resps, sr_wall))

    # 4. (f): sampled, both layouts, resident against the tick path.
    s_reqs, s_seeds = ctx["sampled"], ctx["s_seeds"]
    s_resident = {}
    for name, layout in (("slab", None), ("paged", PAGED_BLOCK)):
        runs = [_traffic(ServeEngine(backend(ctx["s_gen"],
                                             kv_block_size=layout,
                                             resident=res)),
                         s_reqs, s_seeds)[0] for res in (False, True)]
        same(runs[0], runs[1], f"sampled resident vs tick (block {layout})")
        to_length(runs[1], s_reqs, "sampled resident")
        s_resident[name] = runs[1]
    # (f) EOS: the resident loop retires where the tick path did.
    e_slab = _traffic(ServeEngine(backend(ctx["e_gen"], kv_block_size=None,
                                          resident=True)),
                      ctx["first"], seeds)[0]
    same(e_slab, ctx["eos_resps"], "slab resident EOS vs tick")
    eos = ctx["eos"]
    e_paged = _traffic(ServeEngine(backend(ctx["e_gen"], resident=True)),
                       ctx["first"], seeds)[0]
    for r, (_, n) in zip(e_paged, ctx["first"]):
        if not ((r.finish_reason == "eos" and r.tokens[-1] == eos
                 and eos not in r.tokens[:-1])
                or (r.finish_reason == "length" and eos not in r.tokens
                    and len(r.tokens) == n)):
            raise AssertionError("paged resident: EOS not retired at once")
    log("paged", gate="resident_equals_tick", card=card,
        greedy_requests=2 * SERVE_REQUESTS, sampled_requests=4 * len(s_reqs),
        eos_requests=2 * len(ctx["first"]),
        eos_retired=sum(r.finish_reason == "eos" for r in e_paged + e_slab))
    del sr

    # 5. (c): a shared 64-token system prefix, cache on and off.
    prefix = tokens[0, :PREFIX_LEN].tolist()
    p_reqs = []
    for j in range(PREFIX_REQUESTS):
        tail = ([] if j in (3, 6) else
                tokens[j, 2 * BPTT - 40 + j:2 * BPTT - 32 + 3 * j].tolist())
        p_reqs.append((prefix + tail, PREFIX_NEW))
    p_seeds = list(range(PREFIX_REQUESTS))
    counts = _delta(reg, ("serve.kv.prefix_hits", "serve.kv.cow_forks"))
    hit = _traffic(ServeEngine(backend(greedy, resident="auto")), p_reqs,
                   p_seeds)[0]
    pc = counts()
    cold = _traffic(ServeEngine(backend(dataclasses.replace(
        greedy, prefix_cache=False), resident="auto")), p_reqs, p_seeds)[0]
    compared = skipped = 0
    for i, ((p, _), a, b) in enumerate(zip(p_reqs, hit, cold)):
        m, _ = _margins(model, p, b.tokens)
        c, sk, ok = _walk(a.tokens, b.tokens, m, thresh)
        compared, skipped = compared + c, skipped + sk
        if not ok:
            raise AssertionError(f"prefix: request {i} differs from the "
                                 f"cache-off run at a clear step")
    log("paged", gate="shared_prefix", card=card,
        prefix_hits=pc["serve.kv.prefix_hits"],
        cow_forks=pc["serve.kv.cow_forks"], steps_compared=compared,
        steps_skipped_near_ties=skipped)
    if not (pc["serve.kv.prefix_hits"] and pc["serve.kv.cow_forks"]):
        raise AssertionError(f"prefix: no hit or no fork {pc}")

    # 6. (d): offload -> restore against a pool where nothing is evicted.
    o_reqs = p_reqs[:4] + [
        (tokens[(i + 1) % EVAL_BATCH, 8 * i:8 * i + BPTT].tolist(),
         OFFLOAD_NEW)
        for i in range(OFFLOAD_FILLERS)] + p_reqs[4:]
    o_reqs = [(p, min(n, OFFLOAD_NEW)) for p, n in o_reqs]
    o_seeds = list(range(len(o_reqs)))
    counts = _delta(reg, ("serve.kv.offload_out", "serve.kv.offload_restores",
                          "serve.kv.evictions"))
    roomy = _serial(ServeEngine(backend(greedy, resident="auto")), o_reqs,
                    o_seeds)
    room = counts()
    counts = _delta(reg, ("serve.kv.offload_out", "serve.kv.offload_restores",
                          "serve.kv.evictions", "serve.kv.restore_traces"))
    ob = backend(greedy, resident="auto", kv_pool_blocks=OFFLOAD_BLOCKS,
                 kv_offload=True)
    tight = _serial(ServeEngine(ob), o_reqs, o_seeds)
    oc = counts()
    log("paged", gate="offload", card=card, requests=len(o_reqs),
        pool_blocks=OFFLOAD_BLOCKS,
        offload_out=oc["serve.kv.offload_out"],
        restores=oc["serve.kv.offload_restores"],
        restore_traces=oc["serve.kv.restore_traces"],
        evictions_roomy=room["serve.kv.evictions"],
        host_kv_bytes=ob.pool.stats()["host_kv_bytes"])
    same(tight, roomy, "offload vs roomy pool")
    to_length(tight, o_reqs, "offload")
    if (not oc["serve.kv.offload_restores"] or room["serve.kv.evictions"]
            or ob.pool.stats()["blocks_in_use"]):
        raise AssertionError(f"offload: {oc}, roomy {room}")
    del ob

    # 7. (e): int8 KV rows. Agreement is counted teacher-forced: each
    # int8 token against the fp32 forward's argmax on the same prefix, so a
    # stream that parted at one near tie is not counted wrong after it;
    # the position-wise agreement with the fp32 run is printed beside it.
    i8 = _traffic(ServeEngine(backend(greedy, kv_dtype="int8",
                                      resident="auto")), requests, seeds)[0]
    to_length(i8, requests, "int8")
    agree = stream = total = 0
    for (p, _), r, f in zip(requests, i8, pg_resps):
        _, logits = _margins(model, p, r.tokens)
        agree += int((logits.argmax(-1).cpu()
                      == torch.tensor(r.tokens)).sum())
        stream += sum(a == b for a, b in zip(r.tokens, f.tokens))
        total += len(r.tokens)
    log("paged", gate="int8_kv", card=card,
        top1_agreement=f"{agree / total:.4f}",
        stream_agreement=f"{stream / total:.4f}", tokens=total,
        floor=INT8_AGREE_MIN)
    if agree / total < INT8_AGREE_MIN:
        raise AssertionError(f"int8 KV: top-1 agreement {agree / total:.4f}")

    # 8. Decode ms per step with all 8 slots live (128-token prompts):
    # slab graph, paged graph, resident launch of 8 chunks, in turns.
    main = ctx["main"]
    live = np.ones(SERVE_SLOTS, bool)
    big = np.full(SERVE_SLOTS, 1 << 30, np.int64)
    for b in (pg, pr):
        for i in range(SERVE_SLOTS):
            b.prefill(i, tokens[i, :BPTT].tolist(), 0,
                      max_new_tokens=SERVE_NEW[1])
    runs = {"slab_graph": lambda: main.decode(live),
            "paged_graph": lambda: pg.decode(live),
            "resident_r8": lambda: pr.decode(live, budgets=big,
                                             r_max=RESIDENT_CHUNKS)}
    times = {k: [] for k in runs}
    for name in ("slab_graph", "paged_graph", "resident_r8", "resident_r8",
                 "paged_graph", "slab_graph"):
        for _ in range(SERVE_TIMED_TICKS // 2):
            _, dt = _timed(runs[name])
            times[name].append(dt * 1e3)
    for name, run in runs.items():
        t = sorted(times[name])
        steps = RESIDENT_CHUNKS if name == "resident_r8" else 1
        calls, kernels, busy = _profile_ticks(run)
        log("paged", decode=name, card=card,
            ms_per_launch=f"{t[len(t) // 2]:.4f}",
            ms_per_step=f"{t[len(t) // 2] / steps:.4f}",
            ms_per_token=f"{t[len(t) // 2] / steps / SERVE_SLOTS:.4f}",
            ms_min=f"{t[0]:.4f}", ms_max=f"{t[-1]:.4f}",
            launch_calls_per_launch=f"{sum(calls.values()):.1f}",
            launch_calls=json.dumps(calls).replace(" ", ""),
            kernels_per_launch=f"{kernels:.1f}",
            device_busy_ms_per_launch=f"{busy:.4f}")
    for b in (pg, pr):
        for i in range(SERVE_SLOTS):
            b.release(i)

    # 9. Prefill ms of a 128-token prompt: the slab bucket graph against
    # the paged chunk program (8 chunks of 16), in turns; fresh prompts and
    # no prefix cache, so every chunk is computed.
    pf = backend(dataclasses.replace(greedy, prefix_cache=False))
    pf.prefill(0, tokens[0, :BPTT].tolist(), 0)
    pf.release(0)
    pre = {"slab_bucket_graph": [], "paged_chunks": []}
    for turn, name in enumerate(("slab_bucket_graph", "paged_chunks",
                                 "paged_chunks", "slab_bucket_graph")):
        for k in range(3):
            prompt = tokens[(turn + k) % EVAL_BATCH, BPTT:].tolist()
            if name == "paged_chunks":
                pre[name].append(_timed(lambda: pf.prefill(0, prompt, 0))[1])
                pf.release(0)
            else:
                pre[name].append(_timed(lambda: main.prefill(0, prompt,
                                                             0))[1])
    log("paged", card=card, prompt_tokens=BPTT,
        **{f"prefill_ms_{k}": f"{sorted(v)[len(v) // 2] * 1e3:.3f}"
           for k, v in pre.items()},
        peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    del pg, pr, pf, main
    return dict(greedy={"slab": (sr_resps, sr_wall),
                        "paged": (pr_resps, pr_wall)},
                sampled=s_resident, eos=e_slab)


def phase_serve_spec(ctx: dict, smi: str) -> None:
    """The speculative lane (K 4, 8 rounds a launch) through ``ServeEngine``
    at full width on the serve phase's model: n-gram (slab and paged),
    truncated (8 of 16 layers, slab), tree (2 branches, paged), n-gram on
    the adaptive ladder (slab), each over the serve phase's greedy and
    sampled traffic and the repeated-span requests, held to the
    non-spec resident path at clear steps."""
    import numpy as np

    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.serve import ServeEngine, SingleDeviceSlotBackend

    t_phase = time.perf_counter()
    card = repr(smi.splitlines()[0])
    ctx.pop("main")
    torch.cuda.empty_cache()
    model, tokens, thresh = ctx["model"], ctx["tokens"], ctx["thresh"]
    requests, seeds = ctx["requests"], ctx["seeds"]
    s_reqs, s_seeds, s_gen = ctx["sampled"], ctx["s_seeds"], ctx["s_gen"]
    s_thresh = thresh / GEN_TEMPERATURE
    S, R, K = SERVE_SLOTS, RESIDENT_CHUNKS, SPEC_K
    # the same modules as two logical stages: a truncated or tree draft is
    # the first of them (8 of 16 layers)
    staged = PipelinedLM.from_sequential(
        model.cfg, [model.embed, model.posenc, *model.blocks, model.head], 2)
    reg = get_registry()
    torch.cuda.reset_peak_memory_stats()
    for c in _counters():
        c.launches = 0
    r_reqs = [(tokens[j, REPEAT_SPAN * j:REPEAT_SPAN * (j + 1)].tolist()
               * (BPTT // REPEAT_SPAN), requests[j][1])
              for j in range(REPEAT_REQUESTS)]
    r_seeds = [2000 + j for j in range(REPEAT_REQUESTS)]

    def gens(branches):
        cap = SPEC_CAP[branches]
        return (GenerationConfig(max_new_tokens=cap, temperature=0.0),
                dataclasses.replace(s_gen, max_new_tokens=cap),
                dataclasses.replace(ctx["e_gen"], max_new_tokens=cap))

    def backend(gen, layout, m=model, **kw):
        kv = {"kv_block_size": PAGED_BLOCK} if layout == "paged" else {}
        return SingleDeviceSlotBackend(
            m, num_slots=S, max_len=SPEC_MAX_LEN, gen=gen,
            buckets=ctx["buckets"], decode_chunk=1, resident=True,
            resident_chunks=R, **kv, **kw)

    margins = {}
    ref_flash = [0, 0, 0]       # the reference forwards' kernel launches
    ref_s = [0.0]               # and their seconds

    def walk_all(got, ref, reqs, what, cfg=None, req_seeds=None):
        """Every response of ``got`` against ``ref`` at clear steps of the
        reference stream's margins: (compared, skipped)."""
        compared = skipped = 0
        for i, ((p, _), a, b) in enumerate(zip(reqs, got, ref)):
            sd = req_seeds[i] if req_seeds is not None else 0
            key = (tuple(p), tuple(b.tokens), sd, cfg is not None)
            if key not in margins:
                before = [c.launches for c in _counters()]
                t0 = time.perf_counter()
                margins[key] = _margins(model, p, b.tokens, cfg, sd)[0]
                ref_s[0] += time.perf_counter() - t0
                for j, c in enumerate(_counters()):
                    ref_flash[j] += c.launches - before[j]
            c, sk, ok = _walk(a.tokens, b.tokens, margins[key],
                              thresh if cfg is None else s_thresh)
            compared, skipped = compared + c, skipped + sk
            if not ok:
                raise AssertionError(f"spec {what}: request {i} differs "
                                     f"from the non-spec path at a clear "
                                     f"step")
        return compared, skipped

    def recorded(b):
        """``b`` with each resident launch recorded: the rung, its wall,
        whether it captured, and the accepted counts of live slots."""
        calls = []
        launch = b.decode

        def decode(live, budgets=None, r_max=None):
            fresh = not b._spec_progs[b._pick_spec_k(live)]._ready
            (toks, valid), dt = _timed(lambda: launch(live, budgets, r_max))
            W = b.decode_width
            counts = valid.reshape(S, -1, W).sum(-1)[np.asarray(live, bool)]
            calls.append((W, dt, fresh, counts[counts > 0].tolist()))
            return toks, valid
        b.decode = decode
        return calls

    # the non-spec resident path on the repeated-span traffic, per layout:
    # captured by one short request first, so that, as in the spec runs,
    # the graph is warm and the pool holds none of these prompts
    g_gen = GenerationConfig(
        max_new_tokens=SPEC_MAX_LEN - ctx["buckets"].max_len, temperature=0.0)
    r_ref = {}
    for lay in ("slab", "paged"):
        r_eng = ServeEngine(backend(g_gen, lay))
        _traffic(r_eng, [(requests[0][0], 8)], seeds)
        r_ref[lay] = _traffic(r_eng, r_reqs, r_seeds)
        del r_eng
    log("spec", card=card, k=K, rounds_per_launch=R, max_len=SPEC_MAX_LEN,
        repeat_requests=REPEAT_REQUESTS,
        repeat_prompt_tokens=sum(len(p) for p, _ in r_reqs),
        repeat_new_tokens=sum(n for _, n in r_reqs),
        margin_threshold=f"{thresh:.3e}",
        repeat_nonspec_slab=json.dumps(_rates(*r_ref["slab"])).replace(
            " ", ""))

    names = ("serve.engine.spec_rounds", "serve.engine.spec_emitted",
             "serve.engine.resident_traces", "serve.engine.host_syncs",
             "serve.engine.resident_chunks_run",
             "serve.engine.resident_chunks_computed",
             "serve.engine.device_exits")
    runs = [("ngram", "slab", model, {}),
            ("ngram", "paged", model, {}),
            ("truncated", "slab", staged, dict(draft="truncated",
                                               draft_stages=1)),
            ("tree", "paged", staged, dict(draft="tree",
                                           spec_branches=SPEC_BRANCHES)),
            ("ngram_adaptive", "slab", model, dict(spec_adaptive=True))]
    for name, layout, m, kw in runs:
        t_run = time.perf_counter()
        branches = kw.get("spec_branches", 1)
        greedy, sampled, e_gen = gens(branches)
        b = backend(greedy, layout, m, spec_tokens=K, **kw)
        calls = recorded(b)
        eng = ServeEngine(b)
        count = _delta(reg, names)
        g, g_wall = _traffic(eng, requests, seeds)
        c0 = count()
        rp, rp_wall = _traffic(eng, r_reqs, r_seeds)
        c1 = count()
        counted = list(calls)               # the launches c1 counts
        # (b) the same traffic again captures nothing, same tokens
        again = _traffic(eng, r_reqs[:2], r_seeds)[0]
        c2 = count()
        if [r.tokens for r in again] != [r.tokens for r in rp[:2]]:
            raise AssertionError(f"spec {name}: a second drive gave other "
                                 f"tokens")
        rungs = b.program_stats()["spec_rungs_ready"]
        if (c1["serve.engine.resident_traces"] != rungs
                or c2["serve.engine.resident_traces"] != rungs):
            raise AssertionError(f"spec {name}: {c1} / {c2} captures for "
                                 f"{rungs} rungs")
        # (a) greedy against the non-spec resident path, same layout
        cg = walk_all(g, ctx["resident"]["greedy"][layout][0], requests,
                      f"{name} greedy")
        cr = walk_all(rp, r_ref[layout][0], r_reqs, f"{name} repeat")
        all_resps = g + rp
        made = sum(len(r.tokens) for r in all_resps)
        rounds = c1["serve.engine.spec_rounds"]
        emitted = c1["serve.engine.spec_emitted"]
        # (c) the lane's counts
        if emitted < rounds or emitted < made - len(all_resps):
            raise AssertionError(f"spec {name}: emitted {emitted}, rounds "
                                 f"{rounds}, tokens {made}")
        bad = [i for i, (r, (_, n)) in enumerate(
            zip(all_resps, requests + r_reqs))
            if r.status != "ok" or len(r.tokens) != n]
        if bad:
            raise AssertionError(f"spec {name}: requests {bad} did not run "
                                 f"to length")
        hist_len = {}
        for _, _, _, cs in counted:
            for v in cs:
                hist_len[v] = hist_len.get(v, 0) + 1
        launches = c1["serve.engine.host_syncs"]
        ghosts = (c1["serve.engine.resident_chunks_computed"]
                  - c1["serve.engine.resident_chunks_run"])
        captures = {w: f"{dt:.2f}" for w, dt, fresh, _ in calls if fresh}
        g_rounds = c0["serve.engine.spec_rounds"]
        g_emitted = c0["serve.engine.spec_emitted"]
        log("spec", run=name, layout=layout, card=card,
            rungs=sorted({w for w, *_ in calls}), captures=rungs,
            capture_s=json.dumps(captures).replace(" ", ""),
            rounds=rounds, emitted=emitted,
            tokens_per_round=f"{emitted / rounds:.4f}",
            tokens_per_round_serve=f"{g_emitted / g_rounds:.4f}",
            tokens_per_round_repeat=(
                f"{(emitted - g_emitted) / (rounds - g_rounds):.4f}"),
            acceptance_rate=f"{b._spec_acc_total / b._spec_draft_total:.4f}",
            accept_len_hist=json.dumps(dict(sorted(hist_len.items()))
                                       ).replace(" ", ""),
            draft_cost_frac=f"{b._drafter.draft_cost_frac(K, 16):.4f}",
            launches=launches, ghost_rounds=ghosts,
            ghost_rounds_per_launch=f"{ghosts / launches:.3f}",
            device_exits=c1["serve.engine.device_exits"],
            greedy_steps_compared=cg[0], greedy_steps_skipped=cg[1],
            repeat_steps_compared=cr[0], repeat_steps_skipped=cr[1])
        nonspec = ctx["resident"]["greedy"][layout]
        for traffic, (resps, wall), ref in (
                ("serve", (g, g_wall), nonspec),
                ("repeat", (rp, rp_wall), r_ref[layout])):
            log("spec", run=name, traffic=traffic, card=card,
                **_rates(resps, wall),
                **{f"nonspec_{k}": v for k, v in _rates(*ref).items()
                   if k != "generated_tokens"})
        # (a) sampled against the non-spec resident path (the ladder's
        # rungs are the programs the runs above hold)
        if (name, layout) in SPEC_SAMPLED_RUNS:
            s_eng = ServeEngine(backend(sampled, layout, m, spec_tokens=K,
                                        **kw))
            s_resps, s_wall = _traffic(s_eng, s_reqs, s_seeds)
            cs = walk_all(s_resps, ctx["resident"]["sampled"][layout],
                          s_reqs, f"{name} sampled", s_gen, s_seeds)
            log("spec", run=name, traffic="sampled", card=card,
                steps_compared=cs[0], steps_skipped_near_ties=cs[1],
                **_rates(s_resps, s_wall))
            del s_eng
        if (name, layout) == ("ngram", "slab"):
            # (d) EOS
            e_resps = _traffic(ServeEngine(backend(e_gen, layout,
                                                   spec_tokens=K)),
                               ctx["first"], seeds)[0]
            ce = walk_all(e_resps, ctx["resident"]["eos"], ctx["first"],
                          "EOS")
            r0 = e_resps[0]
            if r0.finish_reason != "eos" or r0.tokens[-1] != ctx["eos"]:
                raise AssertionError("spec: EOS did not retire request 0")
            log("spec", gate="eos", eos=ctx["eos"], steps_compared=ce[0],
                steps_skipped=ce[1],
                reasons=[r.finish_reason for r in e_resps])
        if (name, layout) == ("ngram", "paged"):
            # a 130-token prompt (the pool takes it; a slab bucket would
            # not) at the cap passes 272 rows only by the headroom
            try:
                eng.submit(tokens[0, :BPTT + 2].tolist(),
                           max_new_tokens=SPEC_CAP[1])
            except ValueError as e:
                if "speculative headroom" not in str(e):
                    raise
                log("spec", gate="headroom", rejected=repr(str(e)[:80]))
            else:
                raise AssertionError("spec: validate took a request past "
                                     "the speculative headroom")
        if name == "ngram":
            # (e) graph = eager bitwise, slab and paged
            short = [(p, SPEC_EAGER[1]) for p, _ in
                     ctx["first"][:SPEC_EAGER[0]]]
            graph_first = _traffic(eng, short, seeds)[0]
            eager = backend(greedy, layout, spec_tokens=K, cuda_graph=False)
            eager_first = _traffic(ServeEngine(eager), short, seeds)[0]
            equal = sum(a.tokens == e.tokens
                        for a, e in zip(graph_first, eager_first))
            log("spec", gate="graph_vs_eager", layout=layout,
                requests=len(graph_first), equal_requests=equal)
            if equal != len(graph_first) or eager.program_stats()[
                    "resident_graph"]:
                raise AssertionError(f"spec {layout}: graph and eager "
                                     f"tokens differ")
            del eager
        # device ms per round for each rung: every slot live with a
        # 128-token prompt, unbounded budgets, SPEC_TIMED_LAUNCHES launches
        del b.decode                        # the unrecorded method
        live = np.ones(S, bool)
        big = np.full(S, 1 << 30, np.int64)
        for i in range(S):
            b.prefill(i, tokens[i, :BPTT].tolist(), 0,
                      max_new_tokens=SPEC_CAP[branches])
        # (the ladder's top rung is the n-gram slab run's program)
        for w in b._spec_ladder[:-1] or b._spec_ladder:
            def run(w=w):
                b._spec_ewma.fill(w - 1)
                return b.decode(live, budgets=big, r_max=R)
            run()
            t = sorted(_timed(run)[1] * 1e3
                       for _ in range(SPEC_TIMED_LAUNCHES))
            calls_pl, kernels, busy = _profile_ticks(run,
                                                     SPEC_TIMED_LAUNCHES)
            log("spec", run=name, layout=layout, rung=w, card=card,
                ms_per_launch=f"{t[len(t) // 2]:.4f}",
                ms_per_round=f"{t[len(t) // 2] / R:.4f}",
                device_busy_ms_per_round=f"{busy / R:.4f}",
                idle_share=f"{1 - busy / t[len(t) // 2]:.3f}",
                kernels_per_launch=f"{kernels:.1f}",
                launch_calls_per_launch=f"{sum(calls_pl.values()):.1f}")
        for i in range(S):
            b.release(i)
        if layout == "paged" and b.pool.stats()["blocks_in_use"]:
            raise AssertionError(f"spec {name}: the pool did not drain")
        log("spec", run=name, seconds=f"{time.perf_counter() - t_run:.1f}",
            peak_mem_gb=f"{torch.cuda.max_memory_allocated() / 1e9:.2f}")
        del b, eng
        torch.cuda.empty_cache()
    flash = [c.launches - r for c, r in zip(_counters(), ref_flash)]
    log("spec", card=card, flash_launches=flash,
        reference_forward_flash_launches=ref_flash,
        reference_forward_s=f"{ref_s[0]:.1f}",
        seconds=f"{time.perf_counter() - t_phase:.1f}")
    if any(flash):
        raise AssertionError(f"spec: the engine launched kernels {flash}")


# Fleet phase: FLEET_REPLICAS replicas of FLEET_SLOTS slots on one card,
# paged (16-row blocks, a 96-block pool), resident (auto), decode chunk 4,
# over FLEET_REQUESTS greedy requests of FLEET_PROMPT tokens whose first
# FLEET_PREFIX tokens are one of FLEET_PREFIXES shared prefixes, FLEET_NEW
# new tokens each, all submitted at once.
FLEET_REPLICAS = 3
FLEET_SLOTS = 4
FLEET_REQUESTS = 24
FLEET_PROMPT = 128
FLEET_PREFIX = 64
FLEET_PREFIXES = 4
FLEET_NEW = 64
FLEET_BLOCK = 16
FLEET_POOL_BLOCKS = 96
FLEET_DECODE_CHUNK = 4
FLEET_MAX_LEN = FLEET_PROMPT + FLEET_NEW
FLEET_DRILL = 16          # requests of each fault drill
FLEET_WAIT_S = 120.0      # every wait of the phase has its own deadline
FLEET_TICK_BUDGET_S = 0.5
FLEET_SLOW_S = 0.6        # slow_replica's sleep inside a decode
FLEET_SLOW_TICKS = 3
FLEET_GAP = 1e-4          # the margin unit when the phase runs alone


def _fleet_prompts(vocab: int, n: int = FLEET_REQUESTS, seed: int = 13):
    rng = np.random.RandomState(SEED + seed)
    prefixes = [rng.randint(1, vocab, FLEET_PREFIX).tolist()
                for _ in range(FLEET_PREFIXES)]
    return [prefixes[i % FLEET_PREFIXES]
            + rng.randint(1, vocab, FLEET_PROMPT - FLEET_PREFIX).tolist()
            for i in range(n)]


def _fleet_backend(model):
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.serve import BucketSpec, SingleDeviceSlotBackend
    return SingleDeviceSlotBackend(
        model, num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN,
        gen=GenerationConfig(max_new_tokens=FLEET_NEW, temperature=0.0),
        buckets=BucketSpec.pow2(16, FLEET_PROMPT),
        decode_chunk=FLEET_DECODE_CHUNK, kv_block_size=FLEET_BLOCK,
        kv_pool_blocks=FLEET_POOL_BLOCKS)


def _fleet_spec(cfg, role="mixed"):
    from pipe_tpu_torch.fleet import ReplicaSpec
    from pipe_tpu_torch.serve import BucketSpec
    return ReplicaSpec(
        lm_cfg={f: getattr(cfg, f) for f in ("vocab", "d_model", "nhead",
                                             "d_ff", "n_layers", "dropout",
                                             "seq_len")},
        init_seed=SEED, num_slots=FLEET_SLOTS, max_len=FLEET_MAX_LEN,
        buckets=list(BucketSpec.pow2(16, FLEET_PROMPT).lengths),
        decode_chunk=FLEET_DECODE_CHUNK, queue_capacity=256,
        gen=dict(max_new_tokens=FLEET_NEW, temperature=0.0),
        kv_block_size=FLEET_BLOCK, kv_pool_blocks=FLEET_POOL_BLOCKS,
        heartbeat_interval_s=0.1, role=role, device="cuda")


def _spawn_children(specs, live):
    """One ``ProcessReplicaTransport`` per spec, spawned together (each
    waits for its child's ready frame on a thread of its own); every
    transport made is appended to ``live`` so the caller's ``finally``
    ends it."""
    import threading

    from pipe_tpu_torch.fleet import ProcessReplicaTransport
    out, errs = [None] * len(specs), []

    def one(i):
        t0 = time.perf_counter()
        try:
            out[i] = ProcessReplicaTransport(
                specs[i], connect_timeout_s=FLEET_WAIT_S,
                rpc_timeout_s=FLEET_WAIT_S)
            # spawn to the child's ready frame: interpreter, imports,
            # device context, the model drawn on the card, the backend
            out[i].spawn_to_ready_s = time.perf_counter() - t0
        except Exception as e:              # noqa: BLE001 -- raised below
            errs.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(specs))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(FLEET_WAIT_S + 30)
    live.extend(t for t in out if t is not None)
    if errs:
        raise errs[0]
    if any(t is None for t in out):
        raise AssertionError("fleet: a replica child never became ready")
    return out


def _fleet_drive(ctl, prompts, what, *, pace=0.0, on_tick=None,
                 first_id=None):
    """Submit every prompt at once (seed = its index), tick until idle:
    ``(responses in submit order, wall, [(delivery time, response)])``.
    Fails unless every id is delivered exactly once, ``ok``, to its
    length."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [ctl.submit(p, max_new_tokens=FLEET_NEW, seed=i).id
           for i, p in enumerate(prompts)]
    got = []
    deadline = t0 + FLEET_WAIT_S
    while not ctl.idle:
        out = ctl.tick()
        now = time.perf_counter()
        got += [(now, r) for r in out]
        if on_tick is not None:
            on_tick(ctl, got)
        if pace and not out:
            time.sleep(pace)
        if now > deadline:
            raise AssertionError(f"{what}: the fleet never went idle")
    wall = time.perf_counter() - t0
    _exactly_once(ids, [r for _, r in got], what)
    by = {r.request_id: r for _, r in got}
    return [by[i] for i in ids], wall, got


def _exactly_once(ids, delivered, what):
    rids = [r.request_id for r in delivered]
    if sorted(rids) != sorted(ids) or len(set(rids)) != len(rids):
        raise AssertionError(
            f"{what}: not exactly once: {len(ids)} submitted, "
            f"{len(rids)} delivered, {len(set(rids))} distinct")
    bad = [r.request_id for r in delivered
           if r.status != "ok" or len(r.tokens) != FLEET_NEW]
    if bad:
        raise AssertionError(f"{what}: requests {bad} did not end ok at "
                             f"{FLEET_NEW} tokens")


def _fleet_streams(resps, refs, margins, thresh, what):
    """Each response against the reference stream of its prompt under the
    serve phase's near-tie rule: ``(steps compared, steps skipped)``."""
    compared = skipped = 0
    for i, (r, ref) in enumerate(zip(resps, refs)):
        c, k, ok = _walk(list(r.tokens), list(ref.tokens),
                         margins[i % len(margins)], thresh)
        if not ok:
            raise AssertionError(f"{what}: request {i} differs from the "
                                 f"single engine at a clear step")
        compared += c
        skipped += k
    return compared, skipped


@contextlib.contextmanager
def _json_wire(tmpdir: str):
    """The process wire's JSON fallback on both ends, whether or not
    msgpack is installed: the parent's flag, and a ``msgpack`` that fails
    to import first on the children's path (the ends do not negotiate a
    codec). Close every transport before leaving: a reader thread left
    running would decode JSON frames with msgpack."""
    from pipe_tpu_torch.fleet import proc as fproc
    stub = os.path.join(tmpdir, "no_msgpack")
    os.makedirs(stub, exist_ok=True)
    with open(os.path.join(stub, "msgpack.py"), "w") as f:
        f.write("raise ImportError('this fleet runs the JSON codec')\n")
    saved = (fproc.HAVE_MSGPACK, fproc._spawn_env)

    def spawn_env(repo_root=None):
        env = saved[1](repo_root)
        env["PYTHONPATH"] = stub + os.pathsep + env["PYTHONPATH"]
        return env

    fproc.HAVE_MSGPACK, fproc._spawn_env = False, spawn_env
    try:
        yield
    finally:
        fproc.HAVE_MSGPACK, fproc._spawn_env = saved


def _end_children(live):
    """End every child of ``live``: the transports shut theirs down (an
    abandoned one's child is ended by its rejoined transport), stragglers
    are killed, and the reader threads are joined."""
    for tr in reversed(live):
        try:
            tr.close()
        except Exception:                   # noqa: BLE001 -- ending them all
            pass
    for tr in live:
        proc = getattr(tr, "_proc", None)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        reader = getattr(tr, "_reader", None)
        if reader is not None:
            reader.join(timeout=10)


def _abandon(tr):
    """Drop a process transport's parent end without a goodbye (what a
    crashed controller leaves): its child keeps running and re-dials."""
    import socket
    tr._closed = True
    for s in (tr._sock, tr._listener):
        try:
            s.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        s.close()


def phase_fleet(smi: str, gap: float = FLEET_GAP) -> dict:
    """The serving fleet on one card (``pipe_tpu_torch/fleet``,
    ``serve/router.py``, ``obs/fleet_obs.py``). Gates (a)-(h) of the
    module docstring; returns the numbers ``PERF.md`` records."""
    import os as _os
    import signal
    import tempfile
    import urllib.request

    from pipe_tpu_torch.apps.serve import _start_metrics_server
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.core.partition import Stage
    from pipe_tpu_torch.fleet import (HEALTHY, RETIRED, SUSPECT,
                                      DisaggController, FleetController,
                                      ProcessReplicaTransport, ReplicaSpec,
                                      RequestJournal, RouterPolicy)
    from pipe_tpu_torch.fleet import proc as fproc
    from pipe_tpu_torch.inference import head_logits
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.obs.fleet_obs import (FleetObserver, SloMonitor,
                                              SloTargets, TraceBuffer)
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.ops import flash_attention as fa
    from pipe_tpu_torch.parallel import emulator
    from pipe_tpu_torch.resilience import (ChaosPlan, Fault, HopHealth,
                                           TickWatchdog)
    from pipe_tpu_torch.serve import RequestQueue, Router, ServeEngine

    t_phase = time.perf_counter()
    card = repr(smi.splitlines()[0])
    cfg, seq, pipe, batches = make_slice(1)
    model = PipelinedLM.from_sequential(cfg, seq)
    prompts = _fleet_prompts(cfg.vocab)
    thresh = MARGIN_OVER_GAP * gap
    reg = get_registry()
    out = {"card": card}
    log("fleet", replicas=FLEET_REPLICAS, slots=FLEET_SLOTS,
        requests=FLEET_REQUESTS, prompt=FLEET_PROMPT, shared_prefix=
        FLEET_PREFIX, new=FLEET_NEW, block=FLEET_BLOCK,
        pool_blocks=FLEET_POOL_BLOCKS, margin_threshold=f"{thresh:.3e}",
        msgpack_installed=fproc.HAVE_MSGPACK,
        setup_s=f"{time.perf_counter() - t_phase:.2f}")
    policy = dict(placement="prefix", backoff_base_s=0.0,
                  heartbeat_timeout_s=10.0)

    # The reference: one engine, the same traffic; each stream's margins.
    eng = ServeEngine(_fleet_backend(model), RequestQueue(capacity=256))
    _fleet_drive(eng, prompts[:8], "fleet warm-up")
    refs, wall, _ = _fleet_drive(eng, prompts, "fleet single engine")
    margins = [_margins(model, p, r.tokens)[0]
               for p, r in zip(prompts, refs)]
    out["engine_1"] = _rates(refs, wall)
    log("fleet", run="1 engine", card=card, **out["engine_1"])
    del eng

    # (a) three replicas in this process: serial ticks, then tick threads.
    keep = None
    for mode in ("inproc", "thread"):
        engines = [ServeEngine(_fleet_backend(model),
                               RequestQueue(capacity=256),
                               watchdog=TickWatchdog())
                   for _ in range(FLEET_REPLICAS)]
        ctl = Router(engines, RequestQueue(capacity=256),
                     policy=RouterPolicy(placement="prefix"),
                     async_tick=mode == "thread")
        pace = 0.0005 if mode == "thread" else 0.0
        try:
            _fleet_drive(ctl, prompts[:8], f"fleet {mode} warm-up",
                         pace=pace)
            resps, wall, _ = _fleet_drive(ctl, prompts, f"fleet {mode}",
                                          pace=pace)
        finally:
            ctl.close()
        c, k = _fleet_streams(resps, refs, margins, thresh, f"fleet {mode}")
        out[mode] = dict(_rates(resps, wall), compared=c, skipped=k,
                         resident_graphs=[
                             e.backend.program_stats().get("resident_graph")
                             for e in engines])
        log("fleet", run=f"3 replicas {mode}", card=card, **out[mode])
        keep = engines if mode == "inproc" else keep

    live = []
    journal_dir = tempfile.mkdtemp(prefix="fleet-journal-")
    with _json_wire(journal_dir):
        try:
            # (b) three CUDA children: spawn-to-ready, codec, peak, a clean run
            # (the streams), then SIGKILL one mid-stream
            t_sp = time.perf_counter()
            trs = _spawn_children([_fleet_spec(cfg)] * FLEET_REPLICAS, live)
            status = [tr._rpc({"op": "status"}) for tr in trs]
            out["spawn_to_ready_s"] = [f"{tr.spawn_to_ready_s:.2f}"
                                       for tr in trs]
            log("fleet", children=len(trs), card=card,
                spawn_wall_s=f"{time.perf_counter() - t_sp:.2f}",
                spawn_to_ready_s=out["spawn_to_ready_s"],
                codecs=[st["codec"] for st in status])
            if any(st["codec"] != "json" for st in status):
                raise AssertionError(f"fleet: children report codecs "
                                     f"{[st['codec'] for st in status]}, not "
                                     f"the JSON fallback")
            trace_buf = TraceBuffer(maxlen=200_000)
            ctl = FleetController(trs, RequestQueue(capacity=256),
                                  policy=RouterPolicy(**policy),
                                  event_log=trace_buf)
            _fleet_drive(ctl, prompts[:8], "fleet proc warm-up", pace=0.0005)
            resps, wall, _ = _fleet_drive(ctl, prompts, "fleet proc",
                                          pace=0.0005)
            c, k = _fleet_streams(resps, refs, margins, thresh, "fleet proc")
            out["proc"] = dict(_rates(resps, wall), compared=c, skipped=k)
            log("fleet", run="3 replicas proc", card=card, **out["proc"])
            out["peak_bytes"] = [tr._rpc({"op": "status"})["peak_bytes"]
                                 for tr in trs]
            log("fleet", child_peak_bytes=out["peak_bytes"], card=card)

            # (g) observability over the clean run: /metrics, /slo, /fleet,
            # the reconcile, the stitched traces
            time.sleep(0.5)                      # the next obs frames land
            observer = FleetObserver(ctl, parent_events=trace_buf)
            srv = _start_metrics_server(0, observer.rollup,
                                        SloMonitor(SloTargets()), observer)
            try:
                base = f"http://127.0.0.1:{srv.server_address[1]}"
                text = urllib.request.urlopen(base + "/metrics",
                                              timeout=30).read().decode()
                slo = json.loads(urllib.request.urlopen(
                    base + "/slo", timeout=30).read())
                per = json.loads(urllib.request.urlopen(
                    base + "/fleet", timeout=30).read())
            finally:
                srv.shutdown()
            rec = observer.reconcile()
            traces = observer.stitch_by_request()
            path = os.path.join(journal_dir, "traces.jsonl")
            n_rec = observer.write_stitched(path)
            missing = [r.request_id for r in resps
                       if not {"delivered", "terminal"} <= {
                           x.get("stage") for x in traces.get(r.request_id,
                                                              [])}]
            per_rep = [f'serve_fleet_replica_state{{replica="{i}"}}'
                       for i in range(FLEET_REPLICAS)]
            log("fleet", gate="g", metrics_lines=len(text.splitlines()),
                per_replica_series=all(x in text for x in per_rep),
                shipped_engine_series="serve_engine_tokens" in text,
                slo_ok=slo["ok"], fleet_view=sorted(per),
                reconcile=rec, trace_records=n_rec, traced=len(traces),
                untraced=missing)
            if not (all(x in text for x in per_rep)
                    and "serve_engine_tokens" in text
                    and len(per) == len(trs)):
                raise AssertionError("fleet (g): /metrics or /fleet lacks the "
                                     "per-replica series")
            if not rec["reconciled"]:
                raise AssertionError(
                    f"fleet (g): tokens do not reconcile {rec}")
            if missing:
                raise AssertionError(f"fleet (g): requests {missing} have no "
                                     f"stitched delivered/terminal records")

            # (b) the kill: SIGKILL one child while it holds work
            marks = {}

            def kill_when_busy(c, got):
                # at the first tick with work in flight (waiting for a
                # delivery first let the victim drain on some runs), the
                # last child that holds some: the placement decides which
                # children get work in this drive (the prefixes the earlier
                # drives left hot may keep one child idle throughout)
                busy = [i for i, t in enumerate(trs) if t._inflight]
                if "kill" not in marks and busy:
                    marks["victim"] = busy[-1]
                    _os.kill(trs[busy[-1]]._proc.pid, signal.SIGKILL)
                    marks["kill"] = time.perf_counter()
                if "kill" in marks and "retired" not in marks \
                        and c.replicas[marks["victim"]].state == RETIRED:
                    marks["retired"] = time.perf_counter()

            t0 = time.perf_counter()
            resps, wall, got = _fleet_drive(ctl, prompts, "fleet kill",
                                            pace=0.0005,
                                            on_tick=kill_when_busy)
            if "kill" not in marks:
                raise AssertionError("fleet (b): the victim never held work")
            c, k = _fleet_streams(resps, refs, margins, thresh, "fleet kill")
            states = [r.state for r in ctl.replicas]
            t_end = t0 + wall
            t_ret = marks.get("retired", t_end)

            def rate(a, b):
                n = sum(len(r.tokens) for t, r in got if a <= t < b)
                return f"{n / max(b - a, 1e-9):.1f}"

            out["failover"] = dict(
                victim=marks["victim"],
                before_tok_s=rate(t0, marks["kill"]),
                failover_tok_s=rate(marks["kill"], t_ret),
                after_tok_s=rate(t_ret, t_end + 1e-6),
                failover_window_s=f"{t_ret - marks['kill']:.3f}",
                states=states, compared=c, skipped=k)
            log("fleet", gate="b_kill", card=card, **out["failover"])
            if states.count(HEALTHY) != FLEET_REPLICAS - 1 \
                    or states.count(RETIRED) != 1:
                raise AssertionError(f"fleet (b): replica states {states}")

            # (e) wire chaos on a survivor: a CRC storm and a partition
            s = states.index(HEALTHY)
            tr = trs[s]
            w = tr._wire_index
            tr.chaos = ChaosPlan([
                Fault("wire_corrupt", step=w + 1, count=3, stage=s),
                Fault("wire_partition", step=w + 6, stage=s, magnitude=0.5)])
            tr.chaos_replica = s
            resps, wall, _ = _fleet_drive(ctl, prompts[:FLEET_DRILL],
                                          "fleet wire chaos", pace=0.0005)
            _fleet_streams(resps, refs, margins, thresh, "fleet wire chaos")
            out["wire"] = dict(crc_rejects=tr.crc_rejects_total,
                               parent_rejects=tr.wire_crc_rejects,
                               partitioned=tr._partition_until > 0,
                               rpc_retries=tr.rpc_retries,
                               frames=tr._wire_index - w,
                               wall_s=f"{wall:.3f}")
            tr.chaos = None
            log("fleet", gate="e", **out["wire"])
            if tr.crc_rejects_total <= 0:
                raise AssertionError(
                    "fleet (e): no CRC reject under the storm")
            survivors = [trs[i] for i, st in enumerate(states)
                         if st == HEALTHY]

            # (c) disaggregated: prefill, decode, decode children (a survivor
            # is the mixed fallback); the int8 handoff; then the prefill child
            # dies mid-handoff. Two fresh mixed children for (d) come up in
            # the same round: a restarted controller must not meet children
            # whose retained responses carry another controller's ids.
            roles = ("prefill", "decode", "decode", "mixed", "mixed")
            dtrs = _spawn_children([_fleet_spec(cfg, r) for r in roles], live)
            log("fleet", children=len(dtrs), card=card,
                spawn_to_ready_s=[f"{t.spawn_to_ready_s:.2f}" for t in dtrs])
            fresh, dtrs = dtrs[3:], dtrs[:3]
            dctl = DisaggController(dtrs + survivors[:1],
                                    RequestQueue(capacity=256),
                                    policy=RouterPolicy(
                                        backoff_base_s=0.0,
                                        heartbeat_timeout_s=10.0))
            # the int8 codec's own logit gap: the first token's logits over an
            # imported int8 prefix against a cold prefill, in this process
            home, dest, cold = (_fleet_backend(model) for _ in range(3))
            gap8 = 0.0
            for p in prompts[:FLEET_PREFIXES]:
                home.prefill(0, p, 0, max_new_tokens=FLEET_NEW)
                home.release(0)
                dest.import_prefix_payload(home.export_prefix_payload(p))
                logits = []
                for b in (dest, cold):
                    b.prefill(0, p, 0, max_new_tokens=FLEET_NEW)
                    logits.append(head_logits(
                        model, b._chunk_prog.st["h_last"]))
                    b.release(0)
                gap8 = max(gap8, (logits[0] - logits[1]).abs().max().item())
            del home, dest, cold
            _fleet_drive(dctl, prompts[:8], "fleet disagg warm-up",
                         pace=0.0005)
            mixed0 = survivors[0].obs_responses_out
            resps, wall, _ = _fleet_drive(dctl, prompts, "fleet disagg",
                                          pace=0.0005)
            # decode runs over int8-shipped prefix rows: each token against the
            # fp32 forward's argmax on its own stream, as the paged phase holds
            # int8 KV rows
            agree = total = 0
            for p, r in zip(prompts, resps):
                am = _margins(model, p, r.tokens)[1].argmax(-1).tolist()
                agree += sum(a == t for a, t in zip(am, r.tokens))
                total += len(r.tokens)
            same = sum(list(r.tokens) == list(f.tokens)
                       for r, f in zip(resps, refs))
            time.sleep(0.5)                      # the next obs frames land
            imported = [int(t.obs_view()[0].counter(
                "serve.kv.prefix_imported").value) for t in dtrs[1:]]
            shipped = reg.counter("serve.fleet.disagg_handoff_shipped").value
            why = {n: reg.counter(f"serve.fleet.disagg_{n}").value
                   for n in ("handoff_warm", "handoff_cold", "decode_refused",
                             "mixed_fallback", "reprefill")}
            out["disagg"] = dict(_rates(resps, wall), **why,
                                 top1_agreement=f"{agree / total:.4f}",
                                 streams_equal_reference=same,
                                 int8_first_token_dlogits=f"{gap8:.3e}",
                                 prefix_imported=imported,
                                 handoff_blocks=shipped,
                                 mixed_served=survivors[0].obs_responses_out
                                 - mixed0)
            log("fleet", run="disagg", card=card, **out["disagg"])
            if not sum(imported) > 0:
                raise AssertionError("fleet (c): the decode children imported "
                                     "no prefix block")
            if agree / total < INT8_AGREE_MIN:
                raise AssertionError(f"fleet (c): top-1 agreement "
                                     f"{agree / total:.4f} over int8 prefixes")
            # one handoff timed alone: export over the JSON wire, import
            extra = _fleet_prompts(cfg.vocab, 1, seed=29)[0]
            q = RequestQueue(capacity=8)
            req = q.submit(extra, max_new_tokens=1, seed=0)
            dtrs[0].place(req)
            deadline = time.perf_counter() + FLEET_WAIT_S
            while not any(r.request_id == req.id for r in dtrs[0].poll()):
                time.sleep(0.001)
                if time.perf_counter() > deadline:
                    raise AssertionError("fleet (c): the timed prefill hung")
            t1 = time.perf_counter()
            payload = dtrs[0].export_prefix(extra)
            t2 = time.perf_counter()
            seated = dtrs[1].import_prefix(payload)
            t3 = time.perf_counter()
            frame = len(fproc._pack({"op": "reply", "rpc": 0,
                                     "value": payload}))
            cold_b = _fleet_backend(model)
            cold_b.prefill(0, extra, 0, max_new_tokens=FLEET_NEW)   # warm
            cold_b.release(0)
            cold_b.pool.invalidate(cold_b.pool.prefix_hashes(extra))
            torch.cuda.synchronize()
            t4 = time.perf_counter()
            cold_b.prefill(0, extra, 0, max_new_tokens=FLEET_NEW)
            t5 = time.perf_counter()
            del cold_b
            out["handoff"] = dict(payload_bytes=payload["nbytes"],
                                  json_frame_bytes=frame, blocks=seated,
                                  export_ms=f"{(t2 - t1) * 1e3:.2f}",
                                  import_ms=f"{(t3 - t2) * 1e3:.2f}",
                                  reprefill_ms=f"{(t5 - t4) * 1e3:.2f}")
            log("fleet", gate="c_handoff", card=card, **out["handoff"])

            marks = {}

            def kill_prefill(c, got):
                if "kill" not in marks and any(
                        getattr(r, "phase", None) == "decode"
                        for r in c._tracked.values()) and dtrs[0]._inflight:
                    _os.kill(dtrs[0]._proc.pid, signal.SIGKILL)
                    marks["kill"] = len(got)

            resps, wall, _ = _fleet_drive(dctl, prompts[:FLEET_DRILL],
                                          "fleet disagg kill", pace=0.0005,
                                          on_tick=kill_prefill)
            log("fleet", gate="c_kill", killed_after=marks.get("kill"),
                states=[r.state for r in dctl.replicas],
                mixed_served=survivors[0].obs_responses_out - mixed0,
                reprefills=reg.counter("serve.fleet.disagg_reprefill").value)
            if "kill" not in marks:
                raise AssertionError("fleet (c): the prefill child was never "
                                     "killed mid-handoff")

            # (d) controller restart over two fresh mixed children: journal,
            # drop the controller mid-flight, rebuild it from the journal
            journal = RequestJournal(journal_dir)
            jctl = FleetController(fresh, RequestQueue(capacity=256),
                                   policy=RouterPolicy(
                                       backoff_base_s=0.0,
                                       heartbeat_timeout_s=10.0),
                                   journal=journal)
            for rep in jctl.replicas:
                journal.record_replica(rep.index,
                                       **rep.transport.rejoin_info())
            ids = [jctl.submit(p, max_new_tokens=FLEET_NEW, seed=i).id
                   for i, p in enumerate(prompts[:FLEET_DRILL])]
            pre = []
            deadline = time.perf_counter() + FLEET_WAIT_S
            while len(pre) < 2:
                pre += jctl.tick()
                time.sleep(0.0005)
                if time.perf_counter() > deadline:
                    raise AssertionError("fleet (d): nothing delivered")
            old = [rep.transport for rep in jctl.replicas]
            for tr in old:
                _abandon(tr)
            t_r = time.perf_counter()
            state = RequestJournal.recover(journal_dir)
            rtrs = [ProcessReplicaTransport(
                        ReplicaSpec(**state.replicas[i]["spec"]),
                        rejoin=state.replicas[i], connect_timeout_s=60)
                    for i in sorted(state.replicas)]
            live.extend(rtrs)
            ctl2 = FleetController.from_journal(
                state, rtrs, RequestQueue(capacity=256),
                journal=RequestJournal(journal_dir),
                policy=RouterPolicy(backoff_base_s=0.0,
                                    heartbeat_timeout_s=10.0))
            post = []
            deadline = time.perf_counter() + FLEET_WAIT_S
            while not ctl2.idle:
                post += ctl2.tick()
                time.sleep(0.0005)
                if time.perf_counter() > deadline:
                    raise AssertionError("fleet (d): the rebuilt fleet hung")
            pre_ids = set(state.terminal)
            post_ids = [r.request_id for r in post]
            once = (sorted(pre_ids | set(post_ids)) == sorted(ids)
                    and len(post_ids) == len(set(post_ids))
                    and not pre_ids & set(post_ids))
            out["restart"] = dict(pre_crash=len(pre_ids),
                                  orphans=len(state.orphans),
                                  recovered=len(post_ids),
                                  recover_s=f"{time.perf_counter() - t_r:.3f}",
                                  exactly_once=once)
            log("fleet", gate="d", **out["restart"])
            if not once or not all(r.status == "ok" for r in post):
                raise AssertionError("fleet (d): the orphans were not "
                                     "delivered exactly once")
        finally:
            _end_children(live)             # the abandoned ones' included

    # (f) the watchdog: slow_replica sleeps inside replica 0's decode for
    # FLEET_SLOW_TICKS router ticks, over a tick budget; the warm inproc
    # engines of (a)
    for e in keep:
        e.watchdog = TickWatchdog(tick_budget_s=FLEET_TICK_BUDGET_S)
    slow0 = reg.counter("resilience.watchdog_slow_ticks").value
    wctl = Router(keep, RequestQueue(capacity=256),
                  policy=RouterPolicy(suspect_slow_streak=2,
                                      recover_healthy_ticks=2),
                  chaos=ChaosPlan([Fault("slow_replica", step=1,
                                         count=FLEET_SLOW_TICKS, stage=0,
                                         magnitude=FLEET_SLOW_S)]))
    walk = []

    def record(c, got):
        if not walk or walk[-1] != c.replicas[0].state:
            walk.append(c.replicas[0].state)

    _fleet_drive(wctl, prompts[:2 * FLEET_DRILL], "fleet watchdog",
                 on_tick=record)
    for _ in range(4):                       # idle ticks: the recovery
        wctl.tick()
        record(wctl, [])
    slow = reg.counter("resilience.watchdog_slow_ticks").value - slow0
    out["watchdog"] = dict(slow_ticks=slow,
                           replica0=keep[0].watchdog.slow_ticks, walk=walk)
    log("fleet", gate="f", **out["watchdog"])
    if slow != FLEET_SLOW_TICKS or keep[0].watchdog.slow_ticks \
            != FLEET_SLOW_TICKS or walk[:3] != [HEALTHY, SUSPECT, HEALTHY]:
        raise AssertionError(f"fleet (f): slow ticks {slow}, walk {walk}")
    del keep, wctl

    # (h) the emulator's hop fault on the eval Pipe: transport_drop on the
    # hop leaving stage 0 for micro-batch 1, and a persistent drop
    x = batches[0][0]
    stages = [Stage(p, name=f"stage{j}")
              for j, p in enumerate(pipe.partitions)]

    def run_emulator(plan, health=None):
        with torch.inference_mode():
            out_b = emulator.run(stages, mb.scatter((x,), CHUNKS),
                                 chaos=plan, hop_health=health)
        return [b.values[0] for b in out_b]

    _zero_launches()
    clean = run_emulator(None)
    clean_launches = fa.flash_attention_fwd.launches
    hh = HopHealth()
    hit = run_emulator(ChaosPlan([Fault("transport_drop", step=0, stage=0,
                                        microbatch=1)]), hh)
    hp = HopHealth()
    run_emulator(ChaosPlan([Fault("persistent_hop_drop", step=0, stage=0)]),
                 hp)
    same = [torch.equal(a, b) for a, b in zip(hit, clean)]
    out["emulator"] = dict(
        launches=clean_launches, expected=cfg.n_layers * CHUNKS,
        same=same, streak=(hh.streak(0), hh.faults(0), hh.dead_hops),
        persistent=(hp.streak(0), hp.faults(0), hp.dead_hops))
    log("fleet", gate="h", **out["emulator"])
    if same != [i != 1 for i in range(CHUNKS)] or clean_launches != \
            cfg.n_layers * CHUNKS or (hh.streak(0), hh.faults(0),
                                      hh.dead_hops) != (0, 1, []) \
            or (hp.streak(0), hp.faults(0), hp.dead_hops) != (
                CHUNKS, CHUNKS, [0]):
        raise AssertionError(f"fleet (h): {out['emulator']}")
    out["seconds"] = f"{time.perf_counter() - t_phase:.1f}"
    log("fleet", seconds=out["seconds"])
    return out



# --- 11. mesh ---------------------------------------------------------------

MESH_STAGES = 2
MESH_DATA = 2
MESH_WORLD = MESH_STAGES * MESH_DATA
MESH_WEIGHT_SEED = 11
MESH_STEP_SEED = 5
MESH_STEPS = 4              # ZeRO's and the lm_tutorial world's steps
# the mesh world's model (phases 11 and 12): the full width cut to 8 layers
MESH_LAYERS = 8
MESH_ZERO_CMP = 3           # ZeRO against the plain Adam after this many steps
MESH_THREADS = 2            # each rank's CPU threads (4 ranks, 8 cores)
MESH_TIMEOUT_S = 600.0
TOL_MESH_LOSS = 1e-5        # relative, against the one-device table walk
TOL_MESH_GRAD = 1e-4        # of max(1, max|g|) per parameter
# The Trainer's table executors held to their one-device twins: (schedule,
# checkpoint); zb-h1 under never runs the structural B/W split.
MESH_TRAINER_RUNS = (("gpipe", "except_last"), ("1f1b", "except_last"),
                     ("zb-h1", "never"))


def _mesh_cfg(vocab: int, dropout: float = DROPOUT,
              n_layers: int = MESH_LAYERS):
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    return LMConfig(vocab=vocab, attn_impl="flash", dropout=dropout,
                    n_layers=n_layers)


def _layer_params(layers):
    """``{"layers.{k}.{name}": parameter}`` over a layer sequence (a
    ``Sequential`` or a ``Pipe``), this process's tensors only."""
    return {f"layers.{k}.{n}": p for k, layer in enumerate(layers)
            for n, p in layer.named_parameters() if p.device.type != "meta"}


def _load_layers(layers, weights) -> None:
    with torch.no_grad():
        for name, p in _layer_params(layers).items():
            p.copy_(weights[name])


def _grad_err(got: dict, ref: dict) -> float:
    """Worst ``max|g - g_ref| / max(1, max|g_ref|)`` over the parameters."""
    worst = 0.0
    for name, g in got.items():
        r = ref[name].to(g.device)
        worst = max(worst, (g - r).abs().max().item()
                    / max(1.0, r.abs().max().item()))
    return worst


def _mesh_refs(tmp: str, vocab: int, x, w, eval_tokens) -> dict:
    """The one-device twins: one step of the LM's gpipe and 1f1b tables and
    of the ``Pipe`` partitions' (``HeteroScheduledPipeline``), except_last,
    and of its zb-h1 table under never with the structural split, dropout
    0.2, from the weights the ranks get; the eval logits. Each reference
    goes to a file the ranks read."""
    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.models.common import per_row_ce
    from pipe_tpu_torch.models.transformer_lm import (PipelinedLM,
                                                      build_sequential,
                                                      pipelined_lm_balance)
    from pipe_tpu_torch.parallel.hetero_scheduled import \
        HeteroScheduledPipeline
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    cfg = _mesh_cfg(vocab)
    seq = build_sequential(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(MESH_WEIGHT_SEED))
    params = _layer_params(seq)
    torch.save({n: p.detach().cpu() for n, p in params.items()},
               os.path.join(tmp, "weights.pt"))
    out = {}
    model = PipelinedLM.from_sequential(cfg, seq, MESH_STAGES)
    pipe = Pipe(seq, chunks=CHUNKS, checkpoint="except_last",
                balance=pipelined_lm_balance(cfg.n_layers, MESH_STAGES),
                device="cuda")
    tokens, targets = x["tokens"].reshape(-1, BPTT), x["targets"].reshape(
        -1, BPTT)
    runs = [(kind, sched, "except_last") for sched in ("gpipe", "1f1b")
            for kind in ("trainer", "pipe")]
    for kind, sched, ckpt in runs + [("trainer", "zb-h1", "never")]:
        for p in params.values():
            p.grad = None
        t0 = time.perf_counter()
        if kind == "trainer":
            ex = ScheduledPipeline(
                model.stage_fn, model.pre_fn, model.loss_post_fn,
                n_stages=MESH_STAGES, module=model, checkpoint=ckpt,
                schedule=sched, device="cuda",
                split_stage="auto" if sched == "zb-h1" else None)
            loss, _ = ex.loss_and_grad(x, w, seed=MESH_STEP_SEED)
        else:
            ex = HeteroScheduledPipeline(
                pipe.partitions, pipe.skip_layout, CHUNKS, "except_last",
                sched, device="cuda")
            loss, _ = ex.loss_and_grad(tokens, targets=targets,
                                       loss_fn=per_row_ce,
                                       seed=MESH_STEP_SEED)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        torch.save({"loss": float(loss),
                    "grads": {n: p.grad.detach().cpu()
                              for n, p in params.items()}},
                   os.path.join(tmp, f"ref_{kind}_{sched}.pt"))
        out[(kind, sched)] = float(loss)
        log("mesh", twin=f"{kind}/{sched}/{ckpt}", loss=f"{float(loss):.6f}",
            one_device_step_ms=f"{ms:.1f}")
    with torch.no_grad():
        logits = pipe(eval_tokens)
    torch.save(logits.cpu(), os.path.join(tmp, "ref_logits.pt"))
    for p in params.values():
        p.grad = None
    del model, pipe, seq, params, logits
    torch.cuda.empty_cache()
    return out


def _rank_counts() -> dict:
    return _launch_counts()


def _mesh_rank_steps(tmp: str, vocab: int) -> dict:
    """On each rank: gates (a)-(c) and (e) over the world (the Trainer's
    gpipe, 1f1b and zb-h1/never executors and ``Pipe(mesh=)``'s, one step
    each, and the eval forwards), against the twins' files."""
    import torch.distributed as dist

    from pipe_tpu_torch import Pipe
    from pipe_tpu_torch.models.common import per_row_ce
    from pipe_tpu_torch.models.transformer_lm import (build_sequential,
                                                      pipelined_lm_balance)
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.parallel.spmd import SpmdPipeline
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig

    mesh = make_mesh(MESH_STAGES, MESH_DATA)
    cfg = _mesh_cfg(vocab)
    weights = torch.load(os.path.join(tmp, "weights.pt"), mmap=True)
    batch = torch.load(os.path.join(tmp, "batch.pt"))
    x = {k: v.cuda() for k, v in batch["x"].items()}
    w = batch["w"].cuda()
    lps = cfg.n_layers // MESH_STAGES
    res = {"rank": mesh.rank, "stage": mesh.stage, "data": mesh.data,
           "backend": mesh.backend, "device": str(mesh.device), "runs": {}}

    def run(name, ex, step, params, ref_file):
        torch.cuda.synchronize()
        _zero_launches()
        mesh.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        loss = step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        ref = torch.load(os.path.join(tmp, ref_file), mmap=True)
        passes = ex.stage_passes(CHUNKS, column=mesh.stage)
        res["runs"][name] = dict(
            loss=float(loss), ref_loss=ref["loss"],
            loss_rel=abs(float(loss) - ref["loss"]) / abs(ref["loss"]),
            grad_err=_grad_err({n: p.grad for n, p in params.items()},
                               ref["grads"]),
            launches=_rank_counts(),
            expected={"flash_attention_fwd": passes["forward"] * lps,
                      "flash_attention_bwd_dq": passes["backward"] * lps,
                      "flash_attention_bwd_dkv": passes["backward"] * lps},
            ms=ms, peak_bytes=torch.cuda.max_memory_allocated(),
            transport=mesh.stats.as_dict())

    for sched, ckpt in MESH_TRAINER_RUNS:
        tr = Trainer(cfg, TrainerConfig(
            batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
            n_stages=MESH_STAGES, n_data=MESH_DATA, schedule=sched,
            checkpoint=ckpt, lr=TRAIN_LR))
        _load_layers(tr.pipe, weights)
        params = _layer_params(tr.pipe)
        run(f"trainer/{sched}", tr.scheduled, lambda: tr.scheduled.loss_and_grad(
            x, w, seed=MESH_STEP_SEED)[0], params, f"ref_trainer_{sched}.pt")
        if sched == "gpipe":
            # (b) the eval logits through SpmdPipeline (the LM's decoder as
            # the post) over the trainer's rank-local model
            ev = SpmdPipeline(tr.model.stage_fn, tr.model.pre_fn,
                              tr.model.post_fn, MESH_STAGES, module=tr.model,
                              mesh=mesh)
            ref_logits = torch.load(os.path.join(tmp, "ref_logits.pt"))
            ex_tokens = batch["eval"].cuda()
            from pipe_tpu_torch.core import microbatch as mb
            xe, _ = mb.stack_scatter({"tokens": ex_tokens}, CHUNKS)
            with torch.no_grad():
                got = ev(xe).reshape(ref_logits.shape)
            res["spmd_logits_err"] = _grad_err({"l": got},
                                               {"l": ref_logits})
        del tr, params
        torch.cuda.empty_cache()
    for sched in ("gpipe", "1f1b"):
        seq = build_sequential(cfg, device="cuda")
        pipe = Pipe(seq, chunks=CHUNKS, checkpoint="except_last",
                    balance=pipelined_lm_balance(cfg.n_layers, MESH_STAGES),
                    schedule=sched, mesh=mesh)
        del seq
        _load_layers(pipe, weights)
        params = _layer_params(pipe)
        tokens = x["tokens"].reshape(-1, BPTT)
        targets = x["targets"].reshape(-1, BPTT)
        run(f"pipe/{sched}", pipe._train_executor,
            lambda: pipe.loss_and_grad(tokens, targets=targets,
                                       loss_fn=per_row_ce,
                                       seed=MESH_STEP_SEED)[0],
            params, f"ref_pipe_{sched}.pt")
        if sched == "gpipe":
            ref_logits = torch.load(os.path.join(tmp, "ref_logits.pt"))
            with torch.no_grad():
                got = pipe(batch["eval"].cuda())
            res["pipe_logits_err"] = _grad_err({"l": got}, {"l": ref_logits})
        del pipe, params
        torch.cuda.empty_cache()
    dist.barrier()
    return res


def _mesh_rank_zero(vocab: int, tmp: str) -> dict:
    """On each rank: gate (d)'s ZeRO half. The plain Adam for
    ``MESH_ZERO_CMP`` steps, then ``zero=True`` for ``MESH_STEPS`` steps
    from the same weights (1f1b, except_last, dropout 0.2), on the
    tutorial corpus."""
    from pipe_tpu_torch.data import lm_text
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig
    from pipe_tpu_torch.train.zero import zero_report

    mesh = make_mesh(MESH_STAGES, MESH_DATA)
    cfg = _mesh_cfg(vocab)
    weights = torch.load(os.path.join(tmp, "weights.pt"), mmap=True)
    source = torch.load(os.path.join(tmp, "batch.pt"))["source"].numpy()
    lps = cfg.n_layers // MESH_STAGES
    out = {"rank": mesh.rank}
    snap = {}
    for zero, steps in ((False, MESH_ZERO_CMP), (True, MESH_STEPS)):
        tr = Trainer(cfg, TrainerConfig(
            batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
            n_stages=MESH_STAGES, n_data=MESH_DATA, schedule="1f1b",
            checkpoint="except_last", lr=TRAIN_LR, zero=zero))
        _load_layers(tr.pipe, weights)
        state = tr._capture(0)
        losses, step_ms = [], []
        _zero_launches()
        mesh.reset_stats()
        torch.cuda.reset_peak_memory_stats()
        for b in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, info = tr.train_epoch(source, state=state, max_steps=b + 1,
                                         start_step=b, log_every=0)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            losses.append(info["loss"])
            if b + 1 == MESH_ZERO_CMP:
                snap[zero] = {n: p.detach().clone()
                              for n, p in _layer_params(tr.pipe).items()}
        passes = tr.scheduled.stage_passes(CHUNKS, column=mesh.stage)
        out["zero" if zero else "plain"] = dict(
            losses=losses, step_ms=step_ms,
            peak_bytes=torch.cuda.max_memory_allocated(),
            launches=_rank_counts(),
            expected={"flash_attention_fwd": passes["forward"] * lps * steps,
                      "flash_attention_bwd_dq": passes["backward"] * lps
                      * steps,
                      "flash_attention_bwd_dkv": passes["backward"] * lps
                      * steps},
            transport=mesh.stats.as_dict(),
            report=zero_report(tr.optimizer) if zero else None)
        del tr, state
        torch.cuda.empty_cache()
    out["zero_param_err"] = _grad_err(snap[True], snap[False])
    return out


def _rank_release() -> None:
    """On each rank of a shared world, after a phase: drop what the phase
    left and hand the allocator's cache back to the card."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def _world(world, n: int, timeout: float, threads: int):
    """The world of ``n`` ranks on the card (gloo) that a phase runs on:
    ``world`` when the caller shares one across phases (each rank then
    releases its memory when the phase is done with it), else its own."""
    from pipe_tpu_torch.runtime.distributed import World
    if world is None:
        with World(n, device="cuda", backend="gloo", timeout=timeout,
                   threads=threads) as own:
            yield own
        return
    if world.n != n:
        raise ValueError(f"a phase of {n} ranks got a world of {world.n}")
    yield world
    world.run(_rank_release)


def phase_mesh(smi: str, world=None) -> dict:
    """Phase 11: the tutorial LM over a (stage, data) world of ranks."""
    import tempfile

    from pipe_tpu_torch.apps import lm_tutorial
    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.data import lm_text

    t_phase = time.perf_counter()
    train_lines, _, vocab = _corpus()
    ids = lm_text.data_process(train_lines, vocab)
    source = lm_text.batchify(ids, TRAIN_BATCH)
    data, target = lm_text.get_batch(source, 0, BPTT)
    x, rows = mb.stack_scatter(
        {"tokens": torch.from_numpy(data).long().cuda(),
         "targets": torch.from_numpy(target).long().cuda()}, CHUNKS)
    w = mb.valid_row_mask(x, rows)
    eval_tokens = torch.from_numpy(lm_text.batchify(ids, EVAL_BATCH)[
        BPTT:2 * BPTT].T.copy()).long().cuda()
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_mesh_")
    torch.save({"x": {k: v.cpu() for k, v in x.items()}, "w": w.cpu(),
                "eval": eval_tokens.cpu(),
                "source": torch.from_numpy(source)},
               os.path.join(tmp, "batch.pt"))
    n_params = None
    refs = _mesh_refs(tmp, len(vocab), x, w, eval_tokens)
    log("mesh", world=MESH_WORLD, stages=MESH_STAGES, data=MESH_DATA,
        backend="gloo", device="cuda:0 (shared)", vocab=len(vocab),
        batch=TRAIN_BATCH, chunks=CHUNKS, dropout=DROPOUT,
        twins_s=f"{time.perf_counter() - t_phase:.1f}")
    with _world(world, MESH_WORLD, MESH_TIMEOUT_S, MESH_THREADS) as world:
        t0 = time.perf_counter()
        steps = world.run(_mesh_rank_steps, tmp, len(vocab))
        log("mesh", spawn_to_ready_s=f"{world.spawn_to_ready_s:.2f}",
            backend=steps[0]["backend"], card=smi.splitlines()[0],
            steps_s=f"{time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        zero = world.run(_mesh_rank_zero, len(vocab), tmp)
        log("mesh", zero_s=f"{time.perf_counter() - t0:.1f}")
        # (d) the tutorial app's ranks over the phase's world, interleaved
        t0 = time.perf_counter()
        app = world.run(lm_tutorial._rank_main, [
            "except_last", "--world", str(MESH_WORLD), "--stages",
            str(MESH_STAGES), "--schedule", "interleaved", "--steps",
            str(MESH_STEPS), "--lr", str(TRAIN_LR)])
        app_s = time.perf_counter() - t0
    launches = {}
    for r in steps:
        for name, run in r["runs"].items():
            log("mesh", rank=r["rank"], stage=r["stage"], data=r["data"],
                run=name, loss=f"{run['loss']:.6f}",
                ref_loss=f"{run['ref_loss']:.6f}",
                loss_rel=f"{run['loss_rel']:.2e}",
                grad_err=f"{run['grad_err']:.2e}", ms=f"{run['ms']:.1f}",
                peak_bytes=run["peak_bytes"], launches=run["launches"],
                expected=run["expected"],
                p2p_bytes=run["transport"]["p2p_bytes"],
                p2p_messages=run["transport"]["p2p_messages"],
                p2p_s=f"{run['transport']['p2p_s']:.3f}",
                allreduce_bytes=run["transport"]["collective_bytes"],
                allreduce_s=f"{run['transport']['collective_s']:.3f}",
                staged_bytes=run["transport"]["staged_bytes"])
            if run["loss_rel"] > TOL_MESH_LOSS:
                raise AssertionError(
                    f"mesh {name} rank {r['rank']}: loss {run['loss']} vs the "
                    f"one-device {run['ref_loss']} (rel {run['loss_rel']:.2e}"
                    f" > {TOL_MESH_LOSS})")
            if run["grad_err"] > TOL_MESH_GRAD:
                raise AssertionError(
                    f"mesh {name} rank {r['rank']}: gradient off by "
                    f"{run['grad_err']:.2e} of max(1, max|g|) "
                    f"(> {TOL_MESH_GRAD})")
            if run["launches"] != run["expected"]:
                raise AssertionError(
                    f"mesh {name} rank {r['rank']}: launches "
                    f"{run['launches']} != the table's {run['expected']}")
            for k, v in run["launches"].items():
                launches.setdefault(name, {}).setdefault(k, 0)
                launches[name][k] += v
        for key in ("spmd_logits_err", "pipe_logits_err"):
            log("mesh", rank=r["rank"], **{key: f"{r[key]:.2e}"})
            if r[key] > TOL_MESH_GRAD:
                raise AssertionError(f"mesh rank {r['rank']}: {key} "
                                     f"{r[key]:.2e} > {TOL_MESH_GRAD}")
    for r in zero:
        for kind in ("plain", "zero"):
            run = r[kind]
            mean_ms = sum(run["step_ms"][1:]) / max(len(run["step_ms"]) - 1, 1)
            log("mesh", rank=r["rank"], run=f"trainer/1f1b zero={kind}",
                losses=[f"{l:.4f}" for l in run["losses"]],
                ms_per_step=f"{mean_ms:.1f}",
                first_step_ms=f"{run['step_ms'][0]:.1f}",
                peak_bytes=run["peak_bytes"], launches=run["launches"],
                p2p_bytes_per_step=run["transport"]["p2p_bytes"]
                // len(run["losses"]),
                p2p_s_per_step=f"{run['transport']['p2p_s'] / len(run['losses']):.3f}",
                allreduce_s_per_step=f"{run['transport']['collective_s'] / len(run['losses']):.3f}",
                staged_bytes_per_step=run["transport"]["staged_bytes"]
                // len(run["losses"]),
                zero_report=run["report"])
            if run["launches"] != run["expected"]:
                raise AssertionError(
                    f"mesh zero={kind} rank {r['rank']}: launches "
                    f"{run['launches']} != the table's {run['expected']}")
            for k, v in run["launches"].items():
                launches.setdefault(f"trainer/1f1b/{kind}", {}).setdefault(
                    k, 0)
                launches[f"trainer/1f1b/{kind}"][k] += v
        ls = r["zero"]["losses"]
        if not (all(math.isfinite(l) for l in ls) and ls[-1] < ls[0]):
            raise AssertionError(f"mesh ZeRO losses not finite and falling: "
                                 f"{ls}")
        log("mesh", rank=r["rank"], zero_param_err=f"{r['zero_param_err']:.2e}")
        if r["zero_param_err"] > TOL_MESH_GRAD:
            raise AssertionError(
                f"mesh rank {r['rank']}: ZeRO's parameters after "
                f"{MESH_ZERO_CMP} steps off the plain run's by "
                f"{r['zero_param_err']:.2e} (> {TOL_MESH_GRAD})")
    ls = app[0]["losses"]
    log("mesh", run="lm_tutorial --world 4 --schedule interleaved",
        losses=[f"{l:.4f}" for l in ls],
        ms_per_step=f"{app[0]['sec_per_step'] * 1e3:.1f}",
        val_loss=f"{app[0]['val_loss']:.4f}", wall_s=f"{app_s:.1f}")
    if not (len(ls) == MESH_STEPS and all(math.isfinite(l) for l in ls)
            and ls[-1] < ls[0]):
        raise AssertionError(f"lm_tutorial --world: losses {ls}")
    if any(a["losses"] != ls for a in app):
        raise AssertionError("lm_tutorial --world: ranks disagree on the loss")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    log("mesh", seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=smi.splitlines()[0])
    return launches


RING_STAGES = 4
RING_WORLD = RING_STAGES     # 4 stage ranks x 1 data
RING_WEIGHT_SEED = 13
RING_STEPS = 2
RING_GEN_BATCH = 8           # 2 rows a ring group
RING_GEN_PROMPT = 128
RING_GEN_NEW = 64
RING_REQUESTS = 8
RING_SAMPLED = 2             # the last 2 of the 8 requests
RING_PROMPT = (32, 128)
RING_NEW = 64
RING_BUCKETS = (32, 64, 128)
RING_MAX_LEN = 128 + RING_NEW + 4   # + the spec lane's headroom K - 1, rounded
RING_BLOCK = 16
RING_RESIDENT = 8
RING_SPEC_K = 4
RING_TIE = 1e-4              # near tie: top-2 within this x max|logit|
RING_TEMPERATURE = 0.8
RING_TOP_K = 50
RING_ENGINE_TPS = 1126.3     # the one-device engine's tokens/s (PR 13)
RING_THREADS = 2
RING_TIMEOUT_S = 600.0
RING_CONFIGS = (
    ("slab", {}),
    ("paged+resident", dict(kv_block_size=RING_BLOCK, resident=True)),
    ("ngram K4+resident", dict(spec_tokens=RING_SPEC_K, resident=True)),
)


def _rel_margins(model, prompt, toks, cfg=None, seed=0):
    """At each step of ``toks`` after ``prompt``: the top-2 gap of the
    scores that picked it over the largest |score| (the near-tie rule's
    unit), from the whole model's forward (every stage of ``model``).
    Greedy: the logits; sampled (``cfg``): the keyed Gumbel-max scores,
    as ``_margins`` scores them."""
    from pipe_tpu_torch.inference import keyed_uniform, seed_word

    dev = next(model.parameters()).device
    x = torch.tensor([list(prompt) + list(toks)], device=dev)
    with torch.no_grad():
        h = model.pre_fn(x)
        for s in range(model.n_stages):
            h = model.stage_fn(s, h)
        scores = model.post_fn(h)[0][len(prompt) - 1:-1].float()
    if cfg is not None:
        scores = scores / cfg.temperature
        kth = torch.topk(scores, cfg.top_k, dim=-1).values[..., -1:]
        scores = torch.where(scores >= kth, scores, -1e30)
        n, vocab = scores.shape
        u = keyed_uniform(torch.full((n,), seed_word(seed), device=dev),
                          torch.arange(n, device=dev), vocab)
        scores = scores + -torch.log(-torch.log(u))
        scores = torch.where(scores > -1e29, scores, 0.0)
    top2 = torch.topk(scores, 2, dim=-1).values
    scale = scores.abs().amax(dim=-1).clamp(min=1e-30)
    return ((top2[:, 0] - top2[:, 1]) / scale).tolist()


def _ring_streams(got, ref, margins, what):
    """Each stream against its reference under the near-tie rule:
    ``(steps compared, departures at a near tie)``; a departure at a clear
    step, or a stream of another length, fails."""
    compared = departures = 0
    for i, (g, r) in enumerate(zip(got, ref)):
        c, k, ok = _walk(list(g), list(r), margins[i], RING_TIE)
        if not ok:
            raise AssertionError(
                f"ring {what}: stream {i} departs from the one-device "
                f"reference at a clear step ({list(g)} vs {list(r)})")
        compared += c
        departures += int(list(g) != list(r))
    return compared, departures


def _ring_traffic(eng, reqs, seeds):
    """Four requests before the first tick, then two a tick, then ticks
    until idle: (responses in submit order, wall)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ids = [eng.submit(p, max_new_tokens=RING_NEW, seed=sd).id
           for p, sd in zip(reqs[:4], seeds[:4])]
    for i in range(4, len(reqs), 2):
        eng.tick()
        ids += [eng.submit(p, max_new_tokens=RING_NEW, seed=sd).id
                for p, sd in zip(reqs[i:i + 2], seeds[i:i + 2])]
    eng.run_until_idle()
    torch.cuda.synchronize()
    return [eng.response(r) for r in ids], time.perf_counter() - t0


def _ring_rank(tmp: str, vocab: int) -> dict:
    """On each rank of the 4-stage world: gates (a)-(c) of phase 12 (its
    docstring). Rank 0 also runs the one-device references and holds the
    ring's streams to them; every rank returns its own numbers."""
    import torch.distributed as dist

    from pipe_tpu_torch.inference import GenerationConfig, Generator
    from pipe_tpu_torch.inference.pipelined import PipelinedGenerator
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM
    from pipe_tpu_torch.obs.telemetry import get_registry
    from pipe_tpu_torch.ops.layers import Sequential
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.serve import (BucketSpec, RingSlotBackend,
                                      ServeEngine, SingleDeviceSlotBackend,
                                      drive_ring)
    from pipe_tpu_torch.train.loop import Trainer, TrainerConfig

    mesh = make_mesh(RING_STAGES, 1)
    cfg = _mesh_cfg(vocab)
    data = torch.load(os.path.join(tmp, "ring.pt"))
    source = data["source"].numpy()
    lps = cfg.n_layers // RING_STAGES
    out = {"rank": mesh.rank, "stage": mesh.stage}
    rank0 = mesh.stage == 0

    # (a) train over the world: the kernels' launches against the table
    tr = Trainer(cfg, TrainerConfig(
        batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
        n_stages=RING_STAGES, n_data=1, schedule="1f1b",
        checkpoint="except_last", lr=TRAIN_LR))
    state = tr.init_state(RING_WEIGHT_SEED)
    torch.cuda.synchronize()
    _zero_launches()
    mesh.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for b in range(RING_STEPS):
        t0 = time.perf_counter()
        state, info = tr.train_epoch(source, state=state, max_steps=b + 1,
                                     start_step=b, log_every=0)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(info["loss"])
    passes = tr.scheduled.stage_passes(CHUNKS, column=mesh.stage)
    out["train"] = dict(
        losses=losses, step_ms=step_ms, launches=_rank_counts(),
        expected={"flash_attention_fwd": passes["forward"] * lps
                  * RING_STEPS,
                  "flash_attention_bwd_dq": passes["backward"] * lps
                  * RING_STEPS,
                  "flash_attention_bwd_dkv": passes["backward"] * lps
                  * RING_STEPS},
        transport=mesh.stats.as_dict(),
        peak_bytes=torch.cuda.max_memory_allocated())

    # (b) Trainer.generate over the mesh; the ring decoder where the
    # weights lie; the one-device Generator on the gathered weights
    prompt = data["prompt"].cuda()
    gcfg = GenerationConfig(max_new_tokens=RING_GEN_NEW, temperature=0.0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    tg = tr.generate(state, prompt, max_new_tokens=RING_GEN_NEW)
    torch.cuda.synchronize()
    tg_ms = (time.perf_counter() - t0) * 1e3
    tg_peak = torch.cuda.max_memory_allocated()
    full = PipelinedLM.from_sequential(
        cfg, Sequential(tr._gathered_layers()), RING_STAGES)
    full.eval()
    ref = Generator(full, gcfg).generate(prompt)
    pg = PipelinedGenerator(mesh, tr.model, gcfg)
    pg.generate(prompt[:RING_STAGES, :8])             # warm-up
    torch.cuda.synchronize()
    mesh.reset_stats()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ring = pg.generate(prompt)
    torch.cuda.synchronize()
    ring_ms = (time.perf_counter() - t0) * 1e3
    out["generate"] = dict(
        trainer_ms=tg_ms, trainer_peak_bytes=tg_peak, ring_ms=ring_ms,
        ring_ms_per_token=ring_ms / (RING_GEN_BATCH * RING_GEN_NEW),
        transport=mesh.stats.as_dict(),
        peak_bytes=torch.cuda.max_memory_allocated(),
        trainer_equals_generator=bool(torch.equal(tg, ref)))
    if rank0:
        margins = [_rel_margins(full, prompt[i].tolist(), ref[i].tolist())
                   for i in range(RING_GEN_BATCH)]
        for name, got in (("Trainer.generate", tg),
                          ("PipelinedGenerator", ring)):
            c, d = _ring_streams(got.tolist(), ref.tolist(), margins, name)
            out["generate"][name] = dict(compared=c, departures=d)

    # (c) the ring engine over the trained weights, three configurations,
    # greedy and sampled traffic, against the one-device engine's
    reqs = [t.tolist() for t in data["requests"]]
    seeds = list(range(100, 100 + RING_REQUESTS))
    buckets = BucketSpec.of(*RING_BUCKETS)
    reg = get_registry()
    out["serve"] = {}
    for name, kw in RING_CONFIGS:
        for sampled in (False, True):
            part = slice(RING_REQUESTS - RING_SAMPLED, None) if sampled \
                else slice(0, RING_REQUESTS - RING_SAMPLED)
            gen = GenerationConfig(
                max_new_tokens=RING_NEW,
                temperature=RING_TEMPERATURE if sampled else 0.0,
                top_k=RING_TOP_K if sampled else None)
            mesh.reset_stats()
            torch.cuda.reset_peak_memory_stats()
            traces0 = reg.counter("serve.ring.decode_traces").value + \
                reg.counter("serve.ring.resident_traces").value
            backend = RingSlotBackend(
                mesh, tr.model, max_len=RING_MAX_LEN, gen=gen,
                buckets=buckets, resident_revolutions=RING_RESIDENT,
                **{"resident": False, **kw})
            got = drive_ring(backend, lambda b: _ring_traffic(
                ServeEngine(b), reqs[part], seeds[part]))
            key = f"{name}/{'sampled' if sampled else 'greedy'}"
            run = dict(transport=mesh.stats.as_dict(),
                       peak_bytes=torch.cuda.max_memory_allocated(),
                       cycles_per_call=backend.cycles_run
                       / max(backend.decode_calls, 1),
                       decode_calls=backend.decode_calls,
                       traces=reg.counter("serve.ring.decode_traces").value
                       + reg.counter("serve.ring.resident_traces").value
                       - traces0)
            if rank0:
                resps, wall = got
                one = SingleDeviceSlotBackend(
                    full, num_slots=RING_STAGES, max_len=RING_MAX_LEN,
                    gen=gen, buckets=buckets,
                    resident_chunks=RING_RESIDENT,
                    **{"resident": False, **kw})
                refs, ref_wall = _ring_traffic(ServeEngine(one),
                                               reqs[part], seeds[part])
                margins = [_rel_margins(
                    full, p, r.tokens, gen if sampled else None, sd)
                    for p, r, sd in zip(reqs[part], refs, seeds[part])]
                c, d = _ring_streams([r.tokens for r in resps],
                                     [r.tokens for r in refs], margins, key)
                run.update(compared=c, departures=d,
                           status=sorted({r.status for r in resps}),
                           rates=_rates(resps, wall),
                           one_device_rates=_rates(refs, ref_wall))
                del one
            out["serve"][key] = run
            dist.barrier()
    del full, tr, state
    torch.cuda.empty_cache()
    return out


def phase_ring(smi: str, world=None) -> dict:
    """Phase 12: the tutorial LM trained, decoded and served over a ring of
    4 stage ranks; returns the kernels' launches per rank of its training."""
    import tempfile

    from pipe_tpu_torch.apps import generate as gen_app
    from pipe_tpu_torch.apps import serve as serve_app
    from pipe_tpu_torch.data import lm_text

    t_phase = time.perf_counter()
    train_lines, _, vocab = _corpus()
    ids = lm_text.data_process(train_lines, vocab)
    source = lm_text.batchify(ids, TRAIN_BATCH)
    flat = np.asarray(ids)
    rng = np.random.default_rng(7)
    prompt = np.stack([flat[i * RING_GEN_PROMPT:(i + 1) * RING_GEN_PROMPT]
                       for i in range(RING_GEN_BATCH)])
    reqs = []
    for i in range(RING_REQUESTS):
        n = int(rng.integers(RING_PROMPT[0], RING_PROMPT[1] + 1))
        at = int(rng.integers(0, flat.size - n))
        reqs.append(torch.from_numpy(flat[at:at + n].copy()).long())
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_ring_")
    torch.save({"source": torch.from_numpy(source),
                "prompt": torch.from_numpy(prompt.copy()).long(),
                "requests": reqs}, os.path.join(tmp, "ring.pt"))
    log("ring", world=RING_WORLD, stages=RING_STAGES, backend="gloo",
        device="cuda:0 (shared)", vocab=len(vocab), card=smi.splitlines()[0])
    with _world(world, RING_WORLD, RING_TIMEOUT_S, RING_THREADS) as world:
        t0 = time.perf_counter()
        res = world.run(_ring_rank, tmp, len(vocab))
        spawn = world.spawn_to_ready_s
        world_s = time.perf_counter() - t0
        # (d) the apps' ranks over the phase's world, at full width (an
        # app's own world is spawned by phase 15's --context-shards 4)
        apps = []
        for name, rank_fn, argv in (
                ("apps.generate --stages 4", gen_app._ring_rank,
                 ["--stages", "4", "--max-new", "16", "--batch", "8"]),
                ("apps.serve --stages 4", serve_app._ring_rank,
                 ["--stages", "4", "--requests", "8", "--max-new", "16"])):
            t1 = time.perf_counter()
            apps.append((name, world.run(rank_fn, argv)[0],
                         time.perf_counter() - t1))
    log("ring", spawn_to_ready_s=f"{spawn:.2f}", world_s=f"{world_s:.1f}")
    launches = {}
    for r in res:
        tr = r["train"]
        ls = tr["losses"]
        log("ring", rank=r["rank"], stage=r["stage"], run="train/1f1b",
            losses=[f"{l:.4f}" for l in ls],
            step_ms=[f"{m:.1f}" for m in tr["step_ms"]],
            launches=tr["launches"], expected=tr["expected"],
            peak_bytes=tr["peak_bytes"],
            p2p_bytes=tr["transport"]["p2p_bytes"],
            staged_bytes=tr["transport"]["staged_bytes"])
        if tr["launches"] != tr["expected"]:
            raise AssertionError(f"ring rank {r['rank']}: launches "
                                 f"{tr['launches']} != {tr['expected']}")
        if not all(math.isfinite(l) for l in ls):
            raise AssertionError(f"ring rank {r['rank']}: losses {ls}")
        for k, v in tr["launches"].items():
            launches[k] = launches.get(k, 0) + v
        g = r["generate"]
        t = g["transport"]
        log("ring", rank=r["rank"], run="generate",
            trainer_generate_ms=f"{g['trainer_ms']:.1f}",
            trainer_generate_peak_bytes=g["trainer_peak_bytes"],
            ring_ms=f"{g['ring_ms']:.1f}",
            ms_per_generated_token=f"{g['ring_ms_per_token']:.4f}",
            ring_tokens_per_s=f"{1e3 / g['ring_ms_per_token']:.1f}",
            ring_bytes=t["p2p_bytes"], ring_messages=t["p2p_messages"],
            staged_bytes=t["staged_bytes"], p2p_s=f"{t['p2p_s']:.3f}",
            peak_bytes=g["peak_bytes"], spawn_to_ready_s=f"{spawn:.2f}")
        if not g["trainer_equals_generator"]:
            raise AssertionError("Trainer.generate over the mesh differs "
                                 "from the Generator on its gathered weights")
        for name in ("Trainer.generate", "PipelinedGenerator"):
            if name in g:
                log("ring", run=name, **g[name])
        for key, run in r["serve"].items():
            t = run["transport"]
            line = dict(rank=r["rank"], run=f"serve {key}",
                        cycles_per_call=f"{run['cycles_per_call']:.2f}",
                        decode_calls=run["decode_calls"],
                        ring_bytes=t["p2p_bytes"],
                        ring_messages=t["p2p_messages"],
                        staged_bytes=t["staged_bytes"],
                        p2p_s=f"{t['p2p_s']:.3f}",
                        plan_broadcasts=t["collectives"],
                        peak_bytes=run["peak_bytes"], traces=run["traces"])
            if "rates" in run:
                line.update(compared=run["compared"],
                            departures=run["departures"],
                            status=run["status"],
                            **{f"ring_{k}": v for k, v in
                               run["rates"].items()},
                            one_device_tokens_per_s=run["one_device_rates"][
                                "generated_tokens_per_s"],
                            pr13_engine_tokens_per_s=RING_ENGINE_TPS)
                if run["status"] != ["ok"]:
                    raise AssertionError(f"ring serve {key}: statuses "
                                         f"{run['status']}")
            log("ring", **line)
            if run["traces"] != 1:
                raise AssertionError(f"ring serve {key}: {run['traces']} "
                                     f"decode traces, not 1")
    for name, got, wall in apps:
        ok = (len(got) == 8 and all(len(row) == 16 for row in got)
              if "generate" in name else got[0] == 0)
        log("ring", run=name, rank0=("8 rows" if "generate" in name
                                     else f"rc {got[0]}"),
            wall_s=f"{wall:.1f}")
        if not ok:
            raise AssertionError(f"{name}: rank 0 returned {got}")
    import shutil
    shutil.rmtree(tmp, ignore_errors=True)
    log("ring", seconds=f"{time.perf_counter() - t_phase:.1f}",
        card=smi.splitlines()[0])
    return launches


ELASTIC_STAGES = 4
ELASTIC_WORLD = ELASTIC_STAGES     # 4 stage ranks x 1 data
ELASTIC_LAYERS = 12                # regroups over 4 and over 3 stages
ELASTIC_WEIGHT_SEED = 17
ELASTIC_STEPS = 10
ELASTIC_KILL = dict(step=6, stage=1)
ELASTIC_RECORD = dict(stage=1, snapshot_step=5, detected_step=7,
                      resume_step=6, n_stages=3)
ELASTIC_LAUNCHES = {3: (21, 12, 12), 4: (28, 16, 16)}  # by layers a rank
GUARD_FAULTS = (("nan_grads", 1, dict(count=2)), ("loss_spike", 4, {}),
                ("data_raise", 5, {}))
GUARD_STEPS = 6
GUARD_WEIGHT_SEED = 19
ELASTIC_THREADS = 2
ELASTIC_TIMEOUT_S = 600.0
# gate (e)'s parameters: Adam turns a gradient whose sign the summation
# order decides into a step of lr either way, so at most this share of the
# elements may pass the gradient bound (sound runs on an H100: 3.1e-7 and
# 6.2e-7), none by more than lr x Adam's accepted steps
TOL_FLIPPED = 1e-5
GUARD_SHOWN = 4     # elements past the bound shown a rank


def _elastic_cfg(vocab: int, n_layers: int = ELASTIC_LAYERS):
    return dataclasses.replace(_mesh_cfg(vocab), n_layers=n_layers)


def _elastic_rc():
    from pipe_tpu_torch.resilience import ResilienceConfig
    return ResilienceConfig(warmup_steps=100, rewind_after=3,
                            snapshot_every=3, data_backoff_s=0.0,
                            rewind_backoff_s=0.0)


def _elastic_tc(n_stages: int, elastic: bool):
    from pipe_tpu_torch.resilience import ElasticConfig
    from pipe_tpu_torch.train.loop import TrainerConfig
    return TrainerConfig(
        batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS, n_stages=n_stages,
        schedule="1f1b", checkpoint="except_last", lr=TRAIN_LR,
        resilience=_elastic_rc(),
        elastic=(ElasticConfig(snapshot_every=3, dead_after=2) if elastic
                 else None))


def _guard_tc(n_data: int):
    from pipe_tpu_torch.resilience import ResilienceConfig
    from pipe_tpu_torch.train.loop import TrainerConfig
    return TrainerConfig(
        batch_size=TRAIN_BATCH, bptt=BPTT, chunks=CHUNKS,
        n_stages=MESH_STAGES, n_data=n_data, schedule="1f1b",
        checkpoint="except_last", lr=TRAIN_LR, zero=True,
        resilience=ResilienceConfig(warmup_steps=1, rewind_after=2,
                                    snapshot_every=2, data_backoff_s=0.0,
                                    rewind_backoff_s=0.0))


def _guard_plan():
    from pipe_tpu_torch.resilience import ChaosPlan, Fault
    return ChaosPlan([Fault(k, s, **kw) for k, s, kw in GUARD_FAULTS],
                     seed=3)


class _StepClock:
    """Wraps ``Trainer._guarded_step`` for the phase: each step's wall (to
    the end of its device work), the trainer's stage count, the kernels'
    launches in it, and whether a buddy capture came just before it (the
    step then waits for the slowest rank's capture)."""

    def __init__(self):
        from pipe_tpu_torch.train.loop import Trainer
        self.steps = []
        self.captured = False
        self._orig = Trainer._guarded_step
        clock = self

        def timed(tr, *a, **kw):
            torch.cuda.synchronize()
            before = _rank_counts()
            t0 = time.perf_counter()
            out = clock._orig(tr, *a, **kw)
            torch.cuda.synchronize()
            after = _rank_counts()
            clock.steps.append(dict(
                ms=(time.perf_counter() - t0) * 1e3,
                after_capture=clock.captured, n_stages=tr.cfg.n_stages,
                layers=tr.model_cfg.n_layers // tr.cfg.n_stages,
                launches={k: after[k] - before[k] for k in after}))
            clock.captured = False
            return out

        Trainer._guarded_step = timed

    def close(self):
        from pipe_tpu_torch.train.loop import Trainer
        Trainer._guarded_step = self._orig


def _steady(steps, n_stages):
    """Median ms of the steps at ``n_stages``, the first of each trainer
    and those right after a buddy capture left out, and how many."""
    ms = [s["ms"] for s in [s for s in steps
                            if s["n_stages"] == n_stages][1:]
          if not s["after_capture"]]
    return (f"{float(np.median(ms)):.1f} ({len(ms)})" if ms else "nan")


def _compare_parts(a, b):
    """Whether two ``Trainer._own_state`` parts are equal bit for bit (the
    same names, every tensor and Adam's step count), and their largest
    difference."""
    same = a[0].keys() == b[0].keys() and a[1].keys() == b[1].keys()
    diff = 0.0
    pairs = [(v, b[0][k]) for k, v in a[0].items() if k in b[0]]
    pairs += [(st[k], b[1][g][k]) for g, st in a[1].items() if g in b[1]
              for k in st]
    for x, y in pairs:
        same = same and torch.equal(x, y)
        diff = max(diff, (x.float() - y.float()).abs().max().item())
    return same, diff


def _elastic_rank(tmp: str, vocab: int) -> dict:
    """On each rank of the 4-stage world: gates (a)-(d) of phase 13."""
    import torch.distributed as dist

    from pipe_tpu_torch.parallel.mesh import make_mesh, survivor_mesh
    from pipe_tpu_torch.resilience import (BuddyStore, ChaosPlan, Fault,
                                           restack_state, train_elastic)
    from pipe_tpu_torch.train.loop import Trainer

    mesh = make_mesh(ELASTIC_STAGES, 1)
    cfg = _elastic_cfg(vocab)
    source = torch.load(os.path.join(tmp, "elastic.pt"))["source"].numpy()
    out = {"rank": mesh.rank, "stage": mesh.stage}
    captures = []
    capture = BuddyStore.capture
    clock = _StepClock()

    def recorded(store, state, step):
        capture(store, state, step)
        captures.append(dict(step=step, verified=store.verify,
                             **store.last_capture))
        clock.captured = True

    BuddyStore.capture = recorded
    torch.cuda.reset_peak_memory_stats()
    _zero_launches()
    lines = []
    try:
        tr = Trainer(cfg, _elastic_tc(ELASTIC_STAGES, True),
                     chaos=ChaosPlan([Fault("kill_stage", **ELASTIC_KILL)]))
        state = tr.init_state(ELASTIC_WEIGHT_SEED)
        tr2, state, info = train_elastic(tr, source, state=state,
                                         max_steps=ELASTIC_STEPS,
                                         log_fn=lines.append)
    finally:
        clock.close()
        BuddyStore.capture = capture
    out["recovered"] = dict(
        launches=_rank_counts(), steps=clock.steps, captures=captures,
        lines=lines, retired=tr2 is None, recoveries=info["recoveries"],
        peak_bytes=torch.cuda.max_memory_allocated(),
        loss_by_step=info.get("loss_by_step"))
    mine = None
    if tr2 is not None:
        # (c) a flipped byte in a held copy is refused
        store = tr2.elastic_store()
        held = next(iter(store._held.values()))
        held[0] ^= 1
        try:
            store._check()
            out["corrupt_refused"] = False
        except RuntimeError as e:
            out["corrupt_refused"] = "manifest" in str(e)
        held[0] ^= 1
        mine = tr2._own_state()
        out["loss_by_step"] = info["loss_by_step"]
    del tr, tr2, state
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the reference: unkilled to the snapshot step, each rank's part
    # through a file, restacked, finished on a trainer born with 3 stages
    clock = _StepClock()
    try:
        ref = Trainer(cfg, _elastic_tc(ELASTIC_STAGES, False))
        state = ref.init_state(ELASTIC_WEIGHT_SEED)
        state, _ = ref.train_epoch(source, state=state,
                                   max_steps=ELASTIC_KILL["step"],
                                   log_every=0)
        torch.save(ref._own_state(), os.path.join(tmp,
                                                  f"part{mesh.rank}.pt"))
        dist.barrier()
        whole = ref._whole_state(
            [torch.load(os.path.join(tmp, f"part{r}.pt"), mmap=True)
             for r in range(ELASTIC_WORLD)], ELASTIC_KILL["step"])
        del ref, state
        gc.collect()
        torch.cuda.empty_cache()
        new = survivor_mesh(mesh, ELASTIC_KILL["stage"])
        if new is not None:
            narrow = Trainer(cfg, _elastic_tc(ELASTIC_STAGES - 1, False),
                             mesh=new)
            state, rinfo = narrow.train_epoch(
                source, state=restack_state(whole, ELASTIC_STAGES,
                                            ELASTIC_STAGES - 1),
                max_steps=ELASTIC_STEPS, start_step=ELASTIC_KILL["step"],
                log_every=0)
            theirs = narrow._own_state()
            out["ref_loss_by_step"] = {ELASTIC_KILL["step"] + i: l for i, l
                                       in enumerate(rinfo["losses"])}
            same, diff = _compare_parts(theirs, mine)
            out["bitwise"] = same
            out["max_diff"] = diff
            del narrow, state
    finally:
        clock.close()
    out["reference_steps"] = clock.steps
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    return out


def _guard_rank(tmp: str, vocab: int, plant: bool = False) -> dict:
    """On each rank: gate (e), the guarded 2 x 2 run with ZeRO under the
    chaos plan, held to the one-device twin's file. With ``plant`` the
    rank of data index 1 zeroes its gradients before the data all-reduce
    (a planted fault that the gate must catch)."""
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.train.loop import Trainer

    mesh = make_mesh(MESH_STAGES, MESH_DATA)
    cfg = _elastic_cfg(vocab)
    source = torch.load(os.path.join(tmp, "elastic.pt"))["source"].numpy()
    reduce = ScheduledPipeline._reduce_grads

    def dropped(self, params):
        for p in params:
            if p.grad is not None:
                p.grad.zero_()
        reduce(self, params)

    if plant and mesh.data == 1:
        ScheduledPipeline._reduce_grads = dropped
    try:
        tr = Trainer(cfg, _guard_tc(MESH_DATA), chaos=_guard_plan())
        state = tr.init_state(GUARD_WEIGHT_SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, info = tr.train_epoch(source, state=state, max_steps=GUARD_STEPS,
                                 log_every=0, log_fn=lambda m: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ScheduledPipeline._reduce_grads = reduce
    twin = torch.load(os.path.join(tmp, "guard_twin.pt"), mmap=True)
    worst = 0.0
    worst_name = None
    beyond = total = 0
    past = []
    for name, p in _layer_params(tr.pipe).items():
        ref = twin["params"][name]
        mine = p.detach().cpu()
        diff = (mine - ref).abs().reshape(-1)
        over = diff > TOL_MESH_GRAD * max(1.0, ref.abs().max().item())
        beyond += int(over.sum())
        total += diff.numel()
        if diff.max().item() > worst:
            worst, worst_name = diff.max().item(), name
        if over.any():
            top = torch.topk(diff, min(GUARD_SHOWN, int(over.sum())))
            past += [dict(name=name, index=int(k), diff=float(d),
                          mine=float(mine.reshape(-1)[k]),
                          twin=float(ref.reshape(-1)[k]))
                     for d, k in zip(top.values, top.indices)]
    past = sorted(past, key=lambda e: -e["diff"])[:GUARD_SHOWN]
    return dict(rank=mesh.rank, anomalies=info["anomalies"],
                rewinds=info["rewinds"], steps=info["steps"],
                accepted=tr.optimizer.step_count, losses=info["losses"],
                param_err=worst, worst_param=worst_name,
                flipped=beyond / total, past=past, wall_s=wall,
                peak_bytes=torch.cuda.max_memory_allocated())


def _guard_twin(tmp: str, vocab: int, watch=()) -> dict:
    """Gate (e)'s one-device guarded twin, in this process, saved for the
    ranks: its counts, losses, Adam's accepted steps and final parameters.
    With ``watch``, ``(parameter name, flat index)`` pairs, it saves
    nothing and returns instead under ``grads``, for each watched element,
    its gradient as the update reads it (after the faults and the clip) and
    its tensor's gradient RMS, by step."""
    from pipe_tpu_torch.train.loop import Trainer

    cfg = _elastic_cfg(vocab)
    source = torch.load(os.path.join(tmp, "elastic.pt"))["source"].numpy()
    tr = Trainer(cfg, _guard_tc(1), chaos=_guard_plan())
    state = tr.init_state(GUARD_WEIGHT_SEED)
    params = _layer_params(tr.pipe)
    grads = []
    step = Trainer._guarded_step

    def read(self, *a, **kw):
        out = step(self, *a, **kw)
        grads.append([(params[n].grad.reshape(-1)[k].item(),
                       params[n].grad.float().square().mean().sqrt().item())
                      for n, k in watch])
        return out

    if watch:
        Trainer._guarded_step = read
    try:
        _, info = tr.train_epoch(source, state=state, max_steps=GUARD_STEPS,
                                 log_every=0, log_fn=lambda m: None)
    finally:
        Trainer._guarded_step = step
    twin = {k: info[k] for k in ("anomalies", "rewinds", "steps", "losses")}
    twin["accepted"] = tr.optimizer.step_count
    if watch:
        twin["grads"] = {w: [st[k] for st in grads]
                         for k, w in enumerate(watch)}
    else:
        torch.save(dict(twin, params={n: p.detach().cpu() for n, p in
                                      params.items()}),
                   os.path.join(tmp, "guard_twin.pt"))
    del tr, state, params
    gc.collect()
    torch.cuda.empty_cache()
    return twin


def _guard_verdict(g, twin) -> tuple:
    """Gate (e)'s limbs for one rank's run against the twin: ``(counts
    equal, loss rel, loss ok, parameters ok)``."""
    rel = max(abs(a - b) / abs(b) for a, b in zip(g["losses"],
                                                  twin["losses"]))
    counts = (g["anomalies"], g["rewinds"], g["steps"], g["accepted"]) == (
        twin["anomalies"], twin["rewinds"], twin["steps"], twin["accepted"])
    params = (g["flipped"] <= TOL_FLIPPED
              and g["param_err"] <= TRAIN_LR * twin["accepted"])
    return counts, rel, rel <= TOL_MESH_LOSS, params


def _guard_gate(guard, twin, watched=None) -> None:
    """Gate (e): print each rank's run of the guarded 2 x 2 world against
    the twin and the elements past the gradient bound (with ``watched``,
    :func:`_guard_twin`'s gradients of them by step), and fail unless the
    counts, the losses and the parameters hold."""
    cap = TRAIN_LR * twin["accepted"]
    for g in guard:
        counts, rel, loss_ok, params_ok = _guard_verdict(g, twin)
        log("elastic", run="guard 2x2 zero", rank=g["rank"],
            anomalies=g["anomalies"], rewinds=g["rewinds"], steps=g["steps"],
            accepted=g["accepted"], loss_rel=f"{rel:.2e}",
            param_err=f"{g['param_err']:.2e}", cap=f"{cap:.1e}",
            worst_param=g["worst_param"], flipped=f"{g['flipped']:.2e}",
            wall_s=f"{g['wall_s']:.1f}", peak_bytes=g["peak_bytes"])
        for e in g["past"]:
            grads = {} if watched is None else dict(
                twin_grad_by_step=[f"{st[0]:.3e}" for st in
                                   watched[(e["name"], e["index"])]],
                tensor_grad_rms_by_step=[f"{st[1]:.3e}" for st in
                                         watched[(e["name"], e["index"])]])
            log("elastic", run="guard 2x2 zero", rank=g["rank"],
                past=e["name"], index=e["index"], diff=f"{e['diff']:.3e}",
                mesh=f"{e['mine']:.6e}", twin=f"{e['twin']:.6e}", **grads)
        if not counts:
            raise AssertionError(f"elastic guard rank {g['rank']}: {g} vs "
                                 f"the twin's {twin}")
        if not (loss_ok and params_ok):
            raise AssertionError(
                f"elastic guard rank {g['rank']}: loss rel {rel:.2e}, "
                f"{g['flipped']:.2e} of the parameters past the gradient "
                f"bound, the worst off by {g['param_err']:.2e} (cap "
                f"{cap:.1e})")


def phase_elastic(smi: str, world=None) -> dict:
    """Phase 13: elastic training over 4 stage ranks and the guarded step
    over a 2 x 2 world with ZeRO; returns the kernels' launches of the
    recovered run, summed over the ranks."""
    import shutil
    import tempfile

    from pipe_tpu_torch.data import lm_text

    t_phase = time.perf_counter()
    train_lines, _, vocab = _corpus()
    source = lm_text.batchify(lm_text.data_process(train_lines, vocab),
                              TRAIN_BATCH)
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_elastic_")
    torch.save({"source": torch.from_numpy(source)},
               os.path.join(tmp, "elastic.pt"))
    card = smi.splitlines()[0]
    log("elastic", world=ELASTIC_WORLD, stages=ELASTIC_STAGES,
        layers=ELASTIC_LAYERS, vocab=len(vocab), backend="gloo",
        device="cuda:0 (shared)", card=card)
    t0 = time.perf_counter()
    twin = _guard_twin(tmp, len(vocab))
    log("elastic", run="guard twin (one device, zero)", **{
        k: twin[k] for k in ("anomalies", "rewinds", "steps")},
        losses=[f"{l:.6f}" for l in twin["losses"]],
        seconds=f"{time.perf_counter() - t0:.1f}")
    with _world(world, ELASTIC_WORLD, ELASTIC_TIMEOUT_S,
                ELASTIC_THREADS) as world:
        t0 = time.perf_counter()
        ranks = world.run(_elastic_rank, tmp, len(vocab))
        log("elastic", spawn_to_ready_s=f"{world.spawn_to_ready_s:.2f}",
            drill_s=f"{time.perf_counter() - t0:.1f}")
        t0 = time.perf_counter()
        guard = world.run(_guard_rank, tmp, len(vocab))
        log("elastic", guard_s=f"{time.perf_counter() - t0:.1f}")
    shutil.rmtree(tmp, ignore_errors=True)

    launches = {"flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
                "flash_attention_bwd_dkv": 0}
    for r in ranks:
        rec = r["recovered"]
        for k, v in rec["launches"].items():
            launches[k] += v
        for c in rec["captures"]:
            log("elastic", rank=r["rank"], capture_step=c["step"],
                bytes=c["bytes"], ms=f"{c['seconds'] * 1e3:.1f}",
                verified=c["verified"])
            if not c["verified"]:
                raise AssertionError(f"elastic rank {r['rank']}: an "
                                     f"unverified capture")
        # (d) launches per step by the layers a rank held
        for k, st in enumerate(rec["steps"]):
            want = dict(zip(launches, ELASTIC_LAUNCHES[st["layers"]]))
            if st["launches"] != want:
                raise AssertionError(
                    f"elastic rank {r['rank']} step {k} ({st['layers']} "
                    f"layers): launches {st['launches']} != {want}")
        for st in r["reference_steps"]:
            want = dict(zip(launches, ELASTIC_LAUNCHES[st["layers"]]))
            if st["launches"] != want:
                raise AssertionError(
                    f"elastic reference rank {r['rank']}: launches "
                    f"{st['launches']} != {want}")
        # (a) the recovery record
        recs = rec["recoveries"]
        if len(recs) != 1 or any(
                recs[0][k] != v for k, v in ELASTIC_RECORD.items()
                if not (rec["retired"] and k in ("n_stages",
                                                 "resume_step"))):
            raise AssertionError(f"elastic rank {r['rank']}: recoveries "
                                 f"{recs}")
        if rec["retired"] != (r["stage"] == ELASTIC_KILL["stage"]):
            raise AssertionError(f"elastic rank {r['rank']}: retired "
                                 f"{rec['retired']}")
        log("elastic", rank=r["rank"], stage=r["stage"],
            retired=rec["retired"],
            recovery_s=f"{recs[0]['recovery_s']:.3f}",
            lost_steps=recs[0]["lost_steps"],
            steady_ms_4_stages=_steady(rec["steps"], 4),
            steady_ms_3_stages=_steady(rec["steps"], 3),
            unkilled_ms_4_stages=_steady(r["reference_steps"], 4),
            unkilled_ms_3_stages=_steady(r["reference_steps"], 3),
            step_ms=[f"{st['ms']:.0f}{'*' if st['after_capture'] else ''}"
                     for st in rec["steps"]],
            peak_bytes=rec["peak_bytes"], launches=rec["launches"],
            card=card)
        if rec["retired"]:
            continue
        # (b) and (c)
        log("elastic", rank=r["rank"], bitwise=r["bitwise"],
            max_diff=r["max_diff"], corrupt_refused=r["corrupt_refused"],
            losses={b: f"{l:.6f}" for b, l in r["loss_by_step"].items()})
        if not (r["bitwise"] and r["loss_by_step"] == r["ref_loss_by_step"]):
            raise AssertionError(
                f"elastic rank {r['rank']}: the recovered run is not the "
                f"restacked reference (max diff {r['max_diff']}, losses "
                f"{r['loss_by_step']} vs {r['ref_loss_by_step']})")
        if not r["corrupt_refused"]:
            raise AssertionError(f"elastic rank {r['rank']}: a corrupt "
                                 f"buddy copy was not refused")
        if not all(math.isfinite(l) for l in r["loss_by_step"].values()):
            raise AssertionError(f"elastic losses {r['loss_by_step']}")
    # (e) the guarded step over 2 x 2 with ZeRO against its twin
    _guard_gate(guard, twin)
    if (twin["anomalies"], twin["rewinds"]) != (3, 1):
        raise AssertionError(f"elastic guard twin: {twin}")
    log("elastic", seconds=f"{time.perf_counter() - t_phase:.1f}", card=card)
    return launches


# --- 14. overlap --------------------------------------------------------------

OV_STAGES = 4                # 4 stage ranks x 1 data, the world of 11-13
OV_WEIGHT_SEED = 19
OV_STEP_SEED = 7
# (a): the transports, in turns, OV_TURN_STEPS steps each
OV_TURNS = (("serialized", False, False), ("overlapped", True, False),
            ("overlapped", True, False), ("serialized", False, False))
OV_TURN_STEPS = 2
# (b): (schedule, checkpoint) of the phase-compiled steps held to the
# interpreted walk; zb-h1 under never with the structural split
OV_PHASE_RUNS = (("1f1b", "except_last"), ("zb-h1", "never"))
# (c): the probe's geometry and widths (pipe_tpu's defaults), timed over
# 2 iterations a row (pipe_tpu's 4)
OV_PROBE = dict(n_stages=OV_STAGES, chunks=8, d_model=256, d_ff=512,
                seq_len=64, iters=2)
# (d): the zoo over the world: phase gpt2's argv (e), for a few steps
ZOO_WORLD_STEPS = 3
TOL_ZOO_WORLD = 1e-5         # relative, against the one-device zoo's losses


def _zoo_gpt2_argv(steps: int) -> list:
    return ["gpt2", "--stages", "4", "--chunks", "16", "--batch", "32",
            "--schedule", "1f1b", "--steps", str(steps)]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _overlap_rank(cfg_overrides=None) -> dict:
    """On each rank: gates (a) and (b) over the full-width tutorial LM
    (``LMConfig`` defaults, random weights and tokens from seeds, dropout
    0.2, batch 32, chunks 4), each rank holding its 4 layers on its mesh's
    device. ``cfg_overrides``: a smaller config, for a CPU rehearsal."""
    import torch.distributed as dist

    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.inference.pipelined import localize_stage
    from pipe_tpu_torch.models.transformer_lm import (LMConfig, PipelinedLM,
                                                      build_sequential)
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    mesh = make_mesh(OV_STAGES, 1)
    dev = mesh.device
    cfg = dataclasses.replace(LMConfig(attn_impl="flash", dropout=DROPOUT),
                              **(cfg_overrides or {}))
    seq = build_sequential(cfg, device=dev, generator=torch.Generator(
        device=dev).manual_seed(OV_WEIGHT_SEED))
    model = localize_stage(PipelinedLM.from_sequential(cfg, seq, OV_STAGES),
                           mesh)
    del seq
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    params = [p for p in model.parameters() if p.device.type != "meta"]
    gen = torch.Generator(device=dev).manual_seed(OV_STEP_SEED)
    tokens = torch.randint(0, cfg.vocab, (TRAIN_BATCH, cfg.seq_len),
                           generator=gen, device=dev)
    x, rows = mb.stack_scatter(
        {"tokens": tokens, "targets": torch.roll(tokens, -1, -1)}, CHUNKS)
    w = mb.valid_row_mask(x, rows)
    lps = cfg.n_layers // OV_STAGES
    out = {"rank": mesh.rank, "stage": mesh.stage, "steps": [],
           "phase": {}}

    def executor(sched, ckpt, overlap, phase):
        return ScheduledPipeline(
            model.stage_fn, model.pre_fn, model.loss_post_fn,
            n_stages=OV_STAGES, module=model, checkpoint=ckpt,
            schedule=sched, mesh=mesh, overlap_transport=overlap,
            phase_compile=phase,
            split_stage="auto" if ckpt == "never" else None)

    def step(ex):
        for p in params:
            p.grad = None
        _sync(dev)
        dist.barrier()
        _zero_launches()
        mesh.reset_stats()
        t0 = time.perf_counter()
        loss, _ = ex.loss_and_grad(x, w, seed=OV_STEP_SEED)
        _sync(dev)
        ms = (time.perf_counter() - t0) * 1e3
        passes = ex.stage_passes(CHUNKS, column=mesh.stage)
        return dict(loss=float(loss), ms=ms, p2p_s=mesh.stats.p2p_s,
                    wait_s=mesh.stats.wait_s,
                    header_bytes=mesh.stats.header_bytes,
                    p2p_bytes=mesh.stats.p2p_bytes,
                    launches=_launch_counts(),
                    expected={"flash_attention_fwd": passes["forward"] * lps,
                              "flash_attention_bwd_dq":
                                  passes["backward"] * lps,
                              "flash_attention_bwd_dkv":
                                  passes["backward"] * lps},
                    transport=ex.memory_plan(CHUNKS)["transport"])

    def same(ref) -> bool:
        return all(torch.equal(p.grad, g) for p, g in zip(params, ref))

    # (a) serialized against overlapped, in turns, from one set of weights,
    # after a serialized warm-up step (the first step in a fresh executor
    # pays its ranks' first kernels and gloo pairs), which is the reference
    s = step(executor("1f1b", "except_last", False, False))
    ref = (s["loss"], [p.grad.clone() for p in params])
    s.update(run="warm-up", bitwise=True)
    out["steps"].append(s)
    for name, overlap, phase in OV_TURNS:
        ex = executor("1f1b", "except_last", overlap, phase)
        for _ in range(OV_TURN_STEPS):
            s = step(ex)
            s.update(run=name, bitwise=s["loss"] == ref[0] and same(ref[1]))
            out["steps"].append(s)
    # (b) phase-compiled against interpreted (1f1b: (a)'s serialized steps)
    for sched, ckpt in OV_PHASE_RUNS:
        base = ref
        if sched != "1f1b":
            s = step(executor(sched, ckpt, False, False))
            base = (s["loss"], [p.grad.clone() for p in params])
            s.update(run=f"{sched}/{ckpt}/interpreted", bitwise=True)
            out["steps"].append(s)
        ex = executor(sched, ckpt, None, True)
        for _ in range(OV_TURN_STEPS):
            s = step(ex)
            s.update(run=f"{sched}/{ckpt}/phase-compiled",
                     bitwise=s["loss"] == base[0] and same(base[1]))
            out["steps"].append(s)
        plan = ex.memory_plan(CHUNKS)
        out["phase"][f"{sched}/{ckpt}"] = {
            k: plan[k] for k in ("cycles", "phase_segments",
                                 "phase_unrolled_cycles",
                                 "phase_scan_cycles", "grad_park_slots",
                                 "stash_slots")}
    del ref, base, model, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    dist.barrier()
    return out


def _probe_rank(n: int, m: int, kw: dict) -> dict:
    """On each rank: the bubble probe's rank (``obs/bubble_probe.py``) with
    its kernels' launches, and the launches its rows' tables imply: per
    row and step, this rank's column's passes x its one layer (the probe's
    model has a layer a stage), times the steps the row times (a warm-up
    and ``iters``, at m and, for the slope rows, at 2m)."""
    from pipe_tpu_torch.obs import bubble_probe
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.parallel.scheduled import (ScheduledPipeline,
                                                   SplitBackwardStage)

    mesh = make_mesh(n, 1)
    _sync(mesh.device)
    _zero_launches()
    record = bubble_probe._rank_probe(n, m, kw)
    _sync(mesh.device)
    launches = _launch_counts()

    def passes(mm, **row):
        if row.pop("split_stage", None) is not None:
            row["split_stage"] = SplitBackwardStage(None, None)
        for k in ("overlap_transport", "phase_compile", "remat_policy"):
            row.pop(k, None)
        table = ScheduledPipeline(lambda s_, h, c: h, lambda x, c: x,
                                  lambda h, x, c: h, n_stages=n,
                                  module=torch.nn.Linear(1, 1),
                                  device="cpu", **row)
        return table.stage_passes(mm, column=mesh.stage)

    steps = 1 + kw["iters"]
    per_step, total = {}, {"forward": 0, "backward": 0}
    runs = []
    if not kw["skip_slope"]:
        runs += [("slope m", dict(schedule="gpipe", checkpoint="never"), m),
                 ("slope 2m", dict(schedule="gpipe", checkpoint="never"),
                  2 * m)]
    for name, row in bubble_probe.schedule_rows(kw["compare_transport"]):
        runs.append((name, row, m))
        if kw["compare_transport"] and name in ("1f1b", "1f1b-overlap"):
            runs.append((f"{name} 2m", row, 2 * m))
    for name, row, mm in runs:
        ps = passes(mm, **dict(row))     # a remat policy changes no count
        per_step[name] = ps
        for k in total:
            total[k] += ps[k] * steps
    expected = {"flash_attention_fwd": total["forward"],
                "flash_attention_bwd_dq": total["backward"],
                "flash_attention_bwd_dkv": total["backward"]}
    return dict(record=record, rank=mesh.rank, launches=launches,
                expected=expected, per_step=per_step)


def _zoo_world_rank(argv) -> dict:
    """On each rank: ``apps.zoo``'s stage rank over the world, with its
    kernels' launches and the ones its column of the table implies."""
    from pipe_tpu_torch.apps import zoo
    from pipe_tpu_torch.parallel.mesh import make_mesh
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline

    mesh = make_mesh(OV_STAGES, 1)
    args = zoo.build_argparser().parse_args(argv)
    _sync(mesh.device)
    _zero_launches()
    res = zoo._rank_main(argv)
    _sync(mesh.device)
    res["launches"] = _launch_counts()
    table = ScheduledPipeline(lambda s, h, c: h, lambda x, c: x,
                              lambda h, x, c: h, n_stages=OV_STAGES,
                              module=torch.nn.Linear(1, 1),
                              checkpoint=args.checkpoint,
                              schedule=args.schedule, device="cpu")
    passes = table.stage_passes(args.chunks, column=mesh.stage)
    blocks = res["n_layers"] // OV_STAGES
    res["expected"] = {
        "flash_attention_fwd": passes["forward"] * blocks * args.steps,
        "flash_attention_bwd_dq": passes["backward"] * blocks * args.steps,
        "flash_attention_bwd_dkv": passes["backward"] * blocks * args.steps}
    res["rank"] = mesh.rank
    gc.collect()
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return res


def phase_overlap(smi: str, world=None, zoo_losses=None) -> dict:
    """Phase 14: overlapped transport, the phase-compiled walk, the bubble
    probe and the zoo over the world of 4 stage ranks; returns the zoo
    world's launches, summed over the ranks. ``zoo_losses``: phase gpt2's
    one-device zoo losses (full precision), run here when not given."""
    from pipe_tpu_torch.apps import zoo
    from pipe_tpu_torch.obs import bubble_probe

    t_phase = time.perf_counter()
    card = smi.splitlines()[0]
    if zoo_losses is None:                 # phase gpt2 did not run
        with contextlib.redirect_stdout(io.StringIO()):
            zoo_losses = zoo.train(zoo.build_argparser().parse_args(
                _zoo_gpt2_argv(ZOO_WORLD_STEPS)))["losses"]
    with _world(world, OV_STAGES, MESH_TIMEOUT_S, MESH_THREADS) as world:
        t0 = time.perf_counter()
        ranks = world.run(_overlap_rank)
        log("overlap", stages=OV_STAGES, backend="gloo",
            device="cuda:0 (shared)", layers_per_rank=16 // OV_STAGES,
            dropout=DROPOUT, batch=TRAIN_BATCH, chunks=CHUNKS, card=card,
            steps_s=f"{time.perf_counter() - t0:.1f}")
        for r in ranks:
            for s in r["steps"]:
                log("overlap", rank=r["rank"], run=s["run"],
                    transport=s["transport"], loss=f"{s['loss']:.6f}",
                    ms=f"{s['ms']:.1f}", p2p_s=f"{s['p2p_s']:.4f}",
                    wait_s=f"{s['wait_s']:.4f}",
                    header_bytes=s["header_bytes"],
                    p2p_bytes=s["p2p_bytes"], bitwise=s["bitwise"],
                    launches=list(s["launches"].values()))
                if not s["bitwise"]:
                    raise AssertionError(
                        f"overlap rank {r['rank']} {s['run']}: loss or "
                        f"gradients differ from the serialized, interpreted "
                        f"walk's")
                if s["launches"] != s["expected"]:
                    raise AssertionError(
                        f"overlap rank {r['rank']} {s['run']}: launches "
                        f"{s['launches']} != the table's {s['expected']}")
                want = ("phase-compiled" if "phase" in s["run"] else
                        "overlapped" if s["run"] == "overlapped"
                        else "serialized")          # and the warm-up
                if s["transport"] != want:
                    raise AssertionError(
                        f"overlap {s['run']}: walked {s['transport']}")
            for run, plan in r["phase"].items():
                log("overlap", rank=r["rank"], phase_program=run, **plan)
        for name in ("serialized", "overlapped",
                     "1f1b/except_last/phase-compiled",
                     "zb-h1/never/interpreted",
                     "zb-h1/never/phase-compiled"):
            per = [s for r in ranks for s in r["steps"] if s["run"] == name]
            log("overlap", summary=name,
                mean_ms=f"{sum(s['ms'] for s in per) / len(per):.1f}",
                mean_p2p_s=f"{sum(s['p2p_s'] for s in per) / len(per):.4f}",
                mean_wait_s=f"{sum(s['wait_s'] for s in per) / len(per):.4f}",
                card=card)
        # (c) the bubble probe's ranks, on the card
        t0 = time.perf_counter()
        kw = dict(OV_PROBE, compare_schedules=True, compare_transport=True,
                  skip_slope=False)
        n, m = kw.pop("n_stages"), kw.pop("chunks")
        probes = world.run(_probe_rank, n, m, kw)
        record = probes[0]["record"]
        print(f"[overlap] probe={json.dumps(record)}", flush=True)
        log("overlap", probe_s=f"{time.perf_counter() - t0:.1f}", card=card)
        for r in probes:
            log("overlap", probe_rank=r["rank"], launches=r["launches"],
                expected=r["expected"], passes_per_step=json.dumps(
                    r["per_step"]).replace(" ", ""))
            if r["launches"] != r["expected"]:
                raise AssertionError(
                    f"bubble probe rank {r['rank']}: launches "
                    f"{r['launches']} != its rows' tables' {r['expected']}")
        rows = record.get("schedules", {})
        if (record.get("platform") != f"cuda-gloo{OV_STAGES}"
                or list(rows) != [r for r, _ in
                                  bubble_probe.schedule_rows(True)]
                or not all(row["sec_per_step"] > 0 for row in rows.values())
                or any(rows[r].get("phase") == "rejected"
                       for r in ("1f1b-phase", "zb-h1-phase"))):
            raise AssertionError(f"bubble probe record: {record}")
        # (d) the zoo over the world against the one-device zoo
        t0 = time.perf_counter()
        argv = _zoo_gpt2_argv(ZOO_WORLD_STEPS) + ["--world", str(OV_STAGES)]
        zres = world.run(_zoo_world_rank, argv)
        want = zoo_losses[:ZOO_WORLD_STEPS]
        for line in zres[0]["stdout"].splitlines():
            print("    " + line, flush=True)
        launches = {}
        for r in zres:
            rel = max(abs(a - b) / abs(b) for a, b in zip(r["losses"], want))
            log("overlap", zoo_rank=r["rank"],
                losses=[f"{l:.6f}" for l in r["losses"]],
                one_device=[f"{l:.6f}" for l in want], max_rel=f"{rel:.2e}",
                ms_per_step=f"{r['ms_per_step']:.1f}",
                launches=r["launches"], expected=r["expected"])
            if len(r["losses"]) != ZOO_WORLD_STEPS or rel > TOL_ZOO_WORLD:
                raise AssertionError(
                    f"zoo --world {OV_STAGES} rank {r['rank']}: losses "
                    f"{r['losses']} vs the one-device {want} (rel {rel:.2e} "
                    f"> {TOL_ZOO_WORLD})")
            if r["launches"] != r["expected"]:
                raise AssertionError(
                    f"zoo --world rank {r['rank']}: launches {r['launches']}"
                    f" != the table's {r['expected']}")
            for k, v in r["launches"].items():
                launches[k] = launches.get(k, 0) + v
        log("overlap", zoo_world_s=f"{time.perf_counter() - t0:.1f}")
    log("overlap", seconds=f"{time.perf_counter() - t_phase:.1f}", card=card)
    return launches


CTX_WORLD = 4
CTX_WEIGHT_SEED = 23
CTX_DATA_SEED = 29
CTX_SEQ = 2048               # the global sequence of (a) and (b)
CTX_BATCH = 4
CTX_ULYSSES = ((1, 1, 4), 2)     # (stages, data, context), chunks
CTX_RING = ((2, 1, 2), 4)
CTX_STEPS = 1
CTX_GEN_PROMPT = 4096
CTX_GEN_BATCH = 2
CTX_GEN_NEW = 16
CTX_BEAMS = 2
CTX_BEAM_NEW = 8
CTX_SAMPLE_SEED = 31
CTX_SAMPLED_NEW = 8          # the sampled stream: a figure, not a gate
CTX_CLI_NEW = 8
CTX_CLI_PROMPT = 128
CTX_THREADS = 2
CTX_TIMEOUT_S = 600.0
TOL_CTX_LOSS = 1e-5          # per-row loss, relative to the one-device twin
TOL_CTX_GRAD = 1e-4          # of max(1, max|g|) per parameter
TOL_CTX_SCORES = 1e-5        # beam scores, relative


def _ctx_cfg(vocab: int):
    """The tutorial LM at full width, 16 layers, dropout 0, the flash
    kernels where the one-device blocks take them."""
    return _mesh_cfg(vocab, dropout=0.0, n_layers=16)


def _ctx_seq(cfg):
    """The LM's modules with phase 15's weights (the same bits in every
    process: one seed on one card)."""
    from pipe_tpu_torch.models.transformer_lm import build_sequential
    return build_sequential(cfg, device="cuda", generator=torch.Generator(
        device="cuda").manual_seed(CTX_WEIGHT_SEED))


def _context_refs(tmp: str, vocab: int) -> dict:
    """The one-device twins, in the parent: the tutorial LM on the weights
    the ranks draw, over the whole 2,048-token batch with the flash
    kernels (per-row losses and the gradients of their mean), and the
    one-device ``Generator``'s greedy, beam and sampled tokens over the
    4,096-token prompt, with the greedy stream's near-tie margins. Written
    to files the ranks read."""
    from pipe_tpu_torch.inference import GenerationConfig, Generator
    from pipe_tpu_torch.models.transformer_lm import PipelinedLM

    cfg = _ctx_cfg(vocab)
    model = PipelinedLM.from_sequential(cfg, _ctx_seq(cfg), 1)
    gen = torch.Generator(device="cuda").manual_seed(CTX_DATA_SEED)
    tokens = torch.randint(0, vocab, (CTX_BATCH, CTX_SEQ), generator=gen,
                           device="cuda")
    prompt = torch.randint(0, vocab, (CTX_GEN_BATCH, CTX_GEN_PROMPT),
                           generator=gen, device="cuda")
    cli = torch.randint(0, vocab, (CTX_CLI_PROMPT,), generator=gen,
                        device="cuda")
    data = {"tokens": tokens.cpu(), "prompt": prompt.cpu(), "cli": cli.cpu()}
    torch.save(data, os.path.join(tmp, "context.pt"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    per_row = model.loss_post_fn(model.stage_fn(0, model.pre_fn(tokens)),
                                 {"targets": tokens.roll(-1, -1)})
    per_row.mean().backward()
    torch.cuda.synchronize()
    twin_ms = (time.perf_counter() - t0) * 1e3
    torch.save({"per_row": per_row.detach().cpu(),
                "grads": {n: p.grad.detach().cpu()
                          for n, p in model.named_parameters()}},
               os.path.join(tmp, "twin.pt"))
    model.zero_grad(set_to_none=True)
    refs = {"twin_ms": twin_ms, "per_row": per_row.detach().cpu()}
    with torch.no_grad():
        greedy = Generator(model, GenerationConfig(
            max_new_tokens=CTX_GEN_NEW, temperature=0.0)).generate(prompt)
        refs["greedy"] = greedy.cpu()
        refs["margins"] = [_rel_margins(model, prompt[i].tolist(),
                                        greedy[i].tolist())
                           for i in range(CTX_GEN_BATCH)]
        toks, scores = Generator(model, GenerationConfig(
            max_new_tokens=CTX_BEAM_NEW, num_beams=CTX_BEAMS)
        ).generate_with_scores(prompt)
        refs["beam"], refs["beam_scores"] = toks.cpu(), scores.cpu()
        refs["sampled"] = Generator(model, GenerationConfig(
            max_new_tokens=CTX_SAMPLED_NEW, temperature=RING_TEMPERATURE,
            top_k=RING_TOP_K)).generate(prompt, seed=CTX_SAMPLE_SEED).cpu()
    del model, per_row, greedy
    gc.collect()
    torch.cuda.empty_cache()
    return refs


def _context_rank(tmp: str, vocab: int) -> dict:
    """On each rank of the world: gates (a)-(c) of phase 15 (its
    docstring), against the twins' files; every rank returns its own
    numbers."""
    import torch.distributed as dist

    from pipe_tpu_torch.core import microbatch as mb
    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.inference.long_context import ContextShardedGenerator
    from pipe_tpu_torch.inference.pipelined import stage_modules
    from pipe_tpu_torch.models.long_context_lm import ContextParallelLM
    from pipe_tpu_torch.parallel.mesh import localize, make_mesh
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    from pipe_tpu_torch.parallel.spmd import SpmdPipeline

    cfg = _ctx_cfg(vocab)
    data = torch.load(os.path.join(tmp, "context.pt"))
    twin = torch.load(os.path.join(tmp, "twin.pt"), mmap=True)
    tokens = data["tokens"].cuda()
    out = {"rank": dist.get_rank()}

    def lm(shape, impl):
        mesh = make_mesh(shape[0], shape[1], n_context=shape[2])
        model = ContextParallelLM.from_sequential(cfg, _ctx_seq(cfg),
                                                  shape[0], impl, mesh=mesh)
        if shape[0] > 1:
            localize(model, stage_modules(model, mesh.stage, shape[0]),
                     "cuda")
        return mesh, model

    def batch(chunks):
        x, _ = mb.stack_scatter({"tokens": tokens,
                                 "targets": tokens.roll(-1, -1)}, chunks)
        return x, torch.ones(chunks, CTX_BATCH // chunks, device="cuda")

    def step(ex, model, mesh, x, w):
        model.zero_grad(set_to_none=True)
        torch.cuda.synchronize()
        _zero_launches()
        mesh.reset_stats()
        t0 = time.perf_counter()
        loss, grads = ex.loss_and_grad(x, w)
        torch.cuda.synchronize()
        return dict(loss=float(loss), ms=(time.perf_counter() - t0) * 1e3,
                    launches=_rank_counts(),
                    transport=mesh.stats.as_dict()), grads

    def per_row_rel(model, mesh, x):
        pipe = SpmdPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                            mesh.n_stages, module=model, post_with_batch=True,
                            mesh=mesh, context_axis="context")
        with torch.no_grad():
            got = pipe(x).reshape(-1).cpu()
        want = twin["per_row"]
        return ((got - want).abs() / want.abs()).max().item()

    # (a) Ulysses: SpmdPipeline over a context line of 4, the flash kernels
    # at the full sequence for heads / 4
    (shape, chunks), runs = CTX_ULYSSES, []
    mesh, model = lm(shape, "ulysses")
    pipe = SpmdPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn, 1,
                        module=model, post_with_batch=True, mesh=mesh,
                        context_axis="context")
    x, w = batch(chunks)
    torch.cuda.reset_peak_memory_stats()
    for i in range(CTX_STEPS):
        rec, grads = step(pipe, model, mesh, x, w)
        if i == 0:
            rec["grad_err"] = _grad_err(grads, twin["grads"])
        runs.append(rec)
    out["ulysses"] = dict(
        steps=runs, per_row_rel=per_row_rel(model, mesh, x),
        expected=_expected_launches(pipe.executor, cfg.n_layers, m=chunks),
        peak_bytes=torch.cuda.max_memory_allocated(),
        loss_rel=abs(runs[0]["loss"] - twin["per_row"].mean().item())
        / twin["per_row"].mean().item())
    del pipe, model, grads
    _rank_release()

    # (b) the ring: the 1f1b table (except_last) over 2 stages x a context
    # line of 2; the serialized walk timed, one overlapped and one
    # phase-compiled step held to its first bit for bit
    (shape, chunks), runs = CTX_RING, []
    mesh, model = lm(shape, "ring")
    x, w = batch(chunks)

    def table(**kw):
        return ScheduledPipeline(
            model.stage_fn, model.pre_fn, model.loss_post_fn,
            n_stages=shape[0], module=model, checkpoint="except_last",
            schedule="1f1b", mesh=mesh, context_axis="context", **kw)

    ser = table(overlap_transport=False, phase_compile=False)
    torch.cuda.reset_peak_memory_stats()
    for i in range(CTX_STEPS):
        rec, grads = step(ser, model, mesh, x, w)
        if i == 0:
            first = {n: g.clone() for n, g in grads.items()}
            rec["grad_err"] = _grad_err(grads, twin["grads"])
        runs.append(rec)
    peak = torch.cuda.max_memory_allocated()
    walks = {}
    for name, ex in (("overlapped", table(overlap_transport=True,
                                          phase_compile=False)),
                     ("phase-compiled", table(phase_compile=True))):
        rec, grads = step(ex, model, mesh, x, w)
        rec["transport_name"] = ex.memory_plan(chunks)["transport"]
        rec["bitwise"] = (rec["loss"] == runs[0]["loss"] and all(
            torch.equal(grads[n], g) for n, g in first.items()))
        walks[name] = rec
    out["ring"] = dict(
        steps=runs, walks=walks, per_row_rel=per_row_rel(model, mesh, x),
        expected={c.__name__: 0 for c in _counters()},   # einsum softmax
        peak_bytes=peak, stage=mesh.stage, context=mesh.context,
        loss_rel=abs(runs[0]["loss"] - twin["per_row"].mean().item())
        / twin["per_row"].mean().item())
    del ser, model, grads, first, walks
    _rank_release()

    # (c) the context-sharded generator over a line of 4: greedy (its
    # prefill timed alone first), beam, sampled
    mesh = make_mesh(1, 1, n_context=4)
    model = ContextParallelLM.from_sequential(cfg, _ctx_seq(cfg), 1,
                                              mesh=mesh)
    prompt = data["prompt"].cuda()
    g = ContextShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=CTX_GEN_NEW, temperature=0.0))
    _zero_launches()
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        torch.cuda.synchronize()
        mesh.reset_stats()
        t0 = time.perf_counter()
        g._prefill(prompt)
        torch.cuda.synchronize()
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_stats = mesh.stats.as_dict()
    mesh.reset_stats()
    t0 = time.perf_counter()
    greedy = g.generate(prompt)
    torch.cuda.synchronize()
    total_ms = (time.perf_counter() - t0) * 1e3
    stats = mesh.stats.as_dict()
    decode_ms = total_ms - prefill_ms
    beam, scores = ContextShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=CTX_BEAM_NEW, num_beams=CTX_BEAMS)
    ).generate_with_scores(prompt)
    sampled = ContextShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=CTX_SAMPLED_NEW, temperature=RING_TEMPERATURE,
        top_k=RING_TOP_K)).generate(prompt, seed=CTX_SAMPLE_SEED)
    out["generate"] = dict(
        greedy=greedy.cpu(), beam=beam.cpu(), beam_scores=scores.cpu(),
        sampled=sampled.cpu(), prefill_ms=prefill_ms, total_ms=total_ms,
        decode_ms_per_token=decode_ms / (CTX_GEN_NEW - 1),
        ms_per_generated_token=total_ms / CTX_GEN_NEW,
        collective_s=stats["collective_s"],
        collectives=stats["collectives"],
        collective_share=stats["collective_s"] / (decode_ms / 1e3),
        prefill_p2p_bytes=prefill_stats["p2p_bytes"],
        prefill_p2p_s=prefill_stats["p2p_s"], launches=_rank_counts(),
        peak_bytes=torch.cuda.max_memory_allocated())
    del g, model
    dist.barrier()
    return out


def phase_context(smi: str, world=None) -> dict:
    """Phase 15: the context axis over the world of 4 ranks; returns the
    kernels' launches of the Ulysses steps, summed over ranks and steps,
    and per rank per step."""
    import shutil
    import tempfile

    from pipe_tpu_torch.apps import generate as gen_app

    t_phase = time.perf_counter()
    card = smi.splitlines()[0]
    _, _, vocab = _corpus()
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_context_")
    refs = _context_refs(tmp, len(vocab))
    log("context", world=CTX_WORLD, backend="gloo", device="cuda:0 (shared)",
        vocab=len(vocab), seq=CTX_SEQ, batch=CTX_BATCH,
        twin_ms=f"{refs['twin_ms']:.1f}",
        refs_s=f"{time.perf_counter() - t_phase:.1f}", card=card)
    with _world(world, CTX_WORLD, CTX_TIMEOUT_S, CTX_THREADS) as world:
        t0 = time.perf_counter()
        res = world.run(_context_rank, tmp, len(vocab))
    log("context", world_s=f"{time.perf_counter() - t0:.1f}")
    launches = {"per_rank_step": None, "total": {}}
    for r in res:
        for what in ("ulysses", "ring"):
            a = r[what]
            for i, s in enumerate(a["steps"]):
                t = s["transport"]
                log("context", rank=r["rank"], run=f"{what}/step{i}",
                    loss=f"{s['loss']:.6f}", ms=f"{s['ms']:.1f}",
                    launches=list(s["launches"].values()),
                    p2p_bytes=t["p2p_bytes"], p2p_s=f"{t['p2p_s']:.3f}",
                    collective_bytes=t["collective_bytes"],
                    collectives=t["collectives"],
                    collective_s=f"{t['collective_s']:.3f}",
                    staged_bytes=t["staged_bytes"], card=card)
                if s["launches"] != a["expected"]:
                    raise AssertionError(
                        f"context {what} rank {r['rank']} step {i}: "
                        f"launches {s['launches']} != {a['expected']}")
                if what == "ulysses":
                    for k, v in s["launches"].items():
                        launches["total"][k] = launches["total"].get(k, 0) + v
            s0 = a["steps"][0]
            log("context", rank=r["rank"], run=what,
                per_row_rel=f"{a['per_row_rel']:.3e}",
                loss_rel=f"{a['loss_rel']:.3e}",
                grad_err=f"{s0['grad_err']:.3e}",
                peak_bytes=a["peak_bytes"],
                mean_ms=f"{sum(s['ms'] for s in a['steps']) / CTX_STEPS:.1f}")
            if (a["per_row_rel"] > TOL_CTX_LOSS or a["loss_rel"] > TOL_CTX_LOSS
                    or s0["grad_err"] > TOL_CTX_GRAD):
                raise AssertionError(
                    f"context {what} rank {r['rank']}: per-row {a['per_row_rel']:.3e}"
                    f" / loss {a['loss_rel']:.3e} (> {TOL_CTX_LOSS}) or "
                    f"gradients {s0['grad_err']:.3e} (> {TOL_CTX_GRAD}) off "
                    f"the one-device twin")
        launches["per_rank_step"] = r["ulysses"]["expected"]
        for name, wk in r["ring"]["walks"].items():
            log("context", rank=r["rank"], run=f"ring/{name}",
                transport=wk["transport_name"], ms=f"{wk['ms']:.1f}",
                bitwise=wk["bitwise"],
                wait_s=f"{wk['transport']['wait_s']:.3f}")
            if not wk["bitwise"] or wk["transport_name"] != name:
                raise AssertionError(
                    f"context ring {name} rank {r['rank']}: walked "
                    f"{wk['transport_name']}, bitwise {wk['bitwise']}")
    # (c) every rank's tokens; rank 0's against the one-device Generator
    g0 = res[0]["generate"]
    for r in res:
        g = r["generate"]
        for k in ("greedy", "beam", "sampled"):
            if not torch.equal(g[k], g0[k]):
                raise AssertionError(f"context generator: rank {r['rank']}'s "
                                     f"{k} tokens differ from rank 0's")
        if any(g["launches"].values()):
            raise AssertionError(f"context generator launched {g['launches']}")
    compared, departures = _ring_streams(g0["greedy"].tolist(),
                                         refs["greedy"].tolist(),
                                         refs["margins"], "context greedy")
    beam_equal = torch.equal(g0["beam"], refs["beam"])
    beam_rel = ((g0["beam_scores"] - refs["beam_scores"]).abs()
                / refs["beam_scores"].abs()).max().item()
    agree = (g0["sampled"] == refs["sampled"]).float().mean().item()
    log("context", run="generate", prompt=CTX_GEN_PROMPT, batch=CTX_GEN_BATCH,
        new=CTX_GEN_NEW, compared=compared, departures=departures,
        beam_equal=beam_equal, beam_scores_rel=f"{beam_rel:.3e}",
        sampled_agreement=f"{agree:.4f}",
        prefill_ms=f"{g0['prefill_ms']:.1f}",
        total_ms=f"{g0['total_ms']:.1f}",
        ms_per_generated_token=f"{g0['ms_per_generated_token']:.3f}",
        decode_ms_per_token=f"{g0['decode_ms_per_token']:.3f}",
        decode_collectives=g0["collectives"],
        decode_collective_s=f"{g0['collective_s']:.3f}",
        decode_collective_share=f"{g0['collective_share']:.3f}",
        prefill_ring_bytes=g0["prefill_p2p_bytes"],
        prefill_ring_s=f"{g0['prefill_p2p_s']:.3f}",
        peak_bytes=g0["peak_bytes"], card=card)
    if not beam_equal or beam_rel > TOL_CTX_SCORES:
        raise AssertionError(f"context beam: tokens equal {beam_equal}, "
                             f"scores rel {beam_rel:.3e}")
    # (d) the CLI over its own world, against one device; a prompt that
    # does not divide exits 2 with pipe_tpu's words
    prompt = ",".join(str(t) for t in torch.load(
        os.path.join(tmp, "context.pt"))["cli"].tolist())
    rows = {}
    for n in (4, 1):
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = gen_app.main(["--context-shards", str(n), "--device", "cuda",
                               "--prompt", prompt, "--seed", "3",
                               "--max-new", str(CTX_CLI_NEW)])
        rows[n] = buf.getvalue().split()
        log("context", run=f"apps.generate --context-shards {n}", rc=rc,
            wall_s=f"{time.perf_counter() - t0:.1f}")
        if rc != 0 or len(rows[n]) != 1:
            raise AssertionError(f"apps.generate --context-shards {n}: rc "
                                 f"{rc}, rows {rows[n]}")
    if rows[4] != rows[1]:
        # equal but at a near tie: the one-device model's margins decide
        args = gen_app.build_argparser().parse_args(["--seed", "3"])
        model = gen_app.build_model(args, gen_app.family_config(args), None)
        ids = [int(t) for t in prompt.split(",")]
        got, want = ([int(t) for t in rows[n][0].split(",")] for n in (4, 1))
        margins = _rel_margins(model, ids, want)
        del model
        torch.cuda.empty_cache()
        _ring_streams([got], [want], [margins], "apps.generate "
                      "--context-shards 4")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = gen_app.main(["--context-shards", "3", "--device", "cuda",
                           "--prompt", prompt])
    want = f"prompt length {CTX_CLI_PROMPT} must divide over 3 context shards"
    log("context", run="apps.generate --context-shards 3", rc=rc,
        stderr=repr(err.getvalue().strip()))
    if rc != 2 or err.getvalue().strip() != want:
        raise AssertionError(f"--context-shards 3: rc {rc}, {err.getvalue()!r}")
    shutil.rmtree(tmp, ignore_errors=True)
    log("context", seconds=f"{time.perf_counter() - t_phase:.1f}", card=card)
    return launches


TP_WORLD = 4
TP_WEIGHT_SEED = 37
TP_DATA_SEED = 41
TP_BATCH = 32
TP_CHUNKS = 4
TP_PP = ((2, 1, 2), 16, 1)       # (stages, data, model), layers, steps
TP_DP = ((1, 2, 2), MESH_LAYERS, 1)
TP_SPLIT_LAYERS = 8
TP_GEN_SHAPE = (1, 1, 4)
TP_GEN_BATCH = 2
TP_GEN_PROMPT = 128
TP_GEN_NEW = 16
TP_BEAMS = 2
TP_BEAM_NEW = 8
TP_SAMPLE_SEED = 43
TP_SAMPLED_NEW = 8           # the sampled stream: a figure, not a gate
TP_THREADS = 2
TP_TIMEOUT_S = 600.0
TOL_TP_LOSS = 1e-5           # loss and per-row losses, relative to the twin
TOL_TP_GRAD = 1e-4           # of max(1, max|g|) per parameter
TOL_TP_SCORES = 1e-5         # beam scores, relative


def _tp_model(vocab: int, n_layers: int, n_stages: int, *, mesh=None,
              tp_axis="model", device="cuda", overrides=None):
    """``TPPipelinedLM`` at full width (``overrides``: a smaller config,
    for a CPU rehearsal), dropout 0, on ``device``, its weights drawn from
    phase 16's seed (the same bits in every process: one seed on one card,
    whatever the stage count or ``tp_axis``)."""
    from pipe_tpu_torch.models.tp_lm import TPPipelinedLM
    from pipe_tpu_torch.models.transformer_lm import LMConfig
    cfg = dataclasses.replace(
        LMConfig(vocab=vocab, dropout=0.0, n_layers=n_layers),
        **(overrides or {}))
    return TPPipelinedLM(cfg, n_stages, tp_axis, mesh=mesh, device=device,
                         generator=torch.Generator(device=device).manual_seed(
                             TP_WEIGHT_SEED))


def _tp_batch(tokens):
    """The micro-batched tokens and unit row weights of phase 16."""
    from pipe_tpu_torch.core import microbatch as mb
    x, _ = mb.stack_scatter({"tokens": tokens, "targets": tokens.roll(-1, -1)},
                            TP_CHUNKS)
    return x, torch.ones(TP_CHUNKS, TP_BATCH // TP_CHUNKS,
                         device=tokens.device)


def _peak_reset(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()


def _peak(device) -> int:
    return (torch.cuda.max_memory_allocated()
            if torch.device(device).type == "cuda" else 0)


def _tp_table(model, n_stages, checkpoint="except_last", schedule="1f1b",
              **kw):
    from pipe_tpu_torch.parallel.scheduled import ScheduledPipeline
    return ScheduledPipeline(model.stage_fn, model.pre_fn, model.loss_post_fn,
                             n_stages=n_stages, module=model,
                             checkpoint=checkpoint, schedule=schedule, **kw)


def _tp_per_row(ex, model, x, rows=None):
    """Per-row losses ``[m, rows]`` of the forward's last-stage outputs
    (this data rank's ``rows`` slice of each micro-batch), or None on a
    rank without the last stage."""
    with torch.no_grad():
        outs = ex.forward(x)
        if outs is None:
            return None
        tg = x["targets"] if rows is None else x["targets"][:, rows]
        return torch.stack([model.loss_post_fn(outs[i], {"targets": tg[i]})
                            for i in range(outs.shape[0])]).cpu()


def _tp_refs(tmp: str, vocab: int, overrides=None, device="cuda") -> dict:
    """The one-device twins, in the parent: ``TPPipelinedLM(tp_axis=None)``
    through the one-device table executor (1f1b, except_last) at (a)'s 16
    layers over 2 stages and (b)'s 8 over 1 (per-row losses, the loss and
    its gradients, written to files the ranks read), and the one-device
    ``Generator``'s greedy, beam and sampled tokens over (c)'s prompt with
    the greedy stream's near-tie margins. ``overrides`` and ``device``: a
    CPU rehearsal's."""
    from pipe_tpu_torch.inference import GenerationConfig, Generator

    seq = (overrides or {}).get("seq_len", BPTT)
    gen = torch.Generator(device=device).manual_seed(TP_DATA_SEED)
    tokens = torch.randint(0, vocab, (TP_BATCH, seq), generator=gen,
                           device=device)
    prompt = torch.randint(0, vocab, (TP_GEN_BATCH, TP_GEN_PROMPT),
                           generator=gen, device=device)
    torch.save({"tokens": tokens.cpu(), "prompt": prompt.cpu()},
               os.path.join(tmp, "tp.pt"))
    x, w = _tp_batch(tokens)
    refs = {}
    for name, ((n_stages, _, _), n_layers, _) in (("pp", TP_PP),
                                                  ("dp", TP_DP)):
        model = _tp_model(vocab, n_layers, n_stages, tp_axis=None,
                          device=device, overrides=overrides)
        ex = _tp_table(model, n_stages, device=device)
        _sync(device)
        t0 = time.perf_counter()
        loss, grads = ex.loss_and_grad(x, w)
        _sync(device)
        refs[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        refs[f"{name}_loss"] = float(loss)
        refs[f"{name}_per_row"] = _tp_per_row(ex, model, x)
        torch.save({"grads": {n: g.detach().cpu() for n, g in grads.items()},
                    "per_row": refs[f"{name}_per_row"], "loss": float(loss)},
                   os.path.join(tmp, f"twin_{name}.pt"))
        del grads, ex
        if name == "pp":
            with torch.no_grad():
                greedy = Generator(model, GenerationConfig(
                    max_new_tokens=TP_GEN_NEW, temperature=0.0)
                ).generate(prompt)
                refs["greedy"] = greedy.cpu()
                refs["margins"] = [_rel_margins(model, prompt[i].tolist(),
                                                greedy[i].tolist())
                                   for i in range(TP_GEN_BATCH)]
                toks, scores = Generator(model, GenerationConfig(
                    max_new_tokens=TP_BEAM_NEW, num_beams=TP_BEAMS)
                ).generate_with_scores(prompt)
                refs["beam"], refs["beam_scores"] = toks.cpu(), scores.cpu()
                refs["sampled"] = Generator(model, GenerationConfig(
                    max_new_tokens=TP_SAMPLED_NEW,
                    temperature=RING_TEMPERATURE, top_k=RING_TOP_K)
                ).generate(prompt, seed=TP_SAMPLE_SEED).cpu()
        del model
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
    return refs


def _tp_rank(tmp: str, vocab: int, overrides=None) -> dict:
    """On each rank of the world: gates (a)-(c) of phase 16 (its
    docstring), against the twins' files; every rank returns its own
    numbers. ``overrides``: a smaller config, for a CPU rehearsal (the
    mesh's device then is the CPU)."""
    import hashlib

    import torch.distributed as dist

    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.inference.generate import head_logits
    from pipe_tpu_torch.inference.pipelined import stage_modules
    from pipe_tpu_torch.inference.tp import TPShardedGenerator
    from pipe_tpu_torch.ops.layers import causal_table
    from pipe_tpu_torch.parallel.mesh import MODEL_AXIS, localize, make_mesh

    from pipe_tpu_torch.runtime.distributed import rank_device

    dev = rank_device()
    data = torch.load(os.path.join(tmp, "tp.pt"))
    x, w = _tp_batch(data["tokens"].to(dev))
    out = {"rank": dist.get_rank()}

    for name, (shape, n_layers, steps) in (("pp", TP_PP), ("dp", TP_DP)):
        twin = torch.load(os.path.join(tmp, f"twin_{name}.pt"), mmap=True)
        mesh = make_mesh(shape[0], shape[1], n_model=shape[2])
        model = _tp_model(vocab, n_layers, shape[0], mesh=mesh, device=dev,
                          overrides=overrides)
        if shape[0] > 1:
            localize(model, stage_modules(model, mesh.stage, shape[0]), dev)
        ex = _tp_table(model, shape[0], mesh=mesh,
                       stage_param_specs=model.stage_param_specs())
        sharded = {n for n, spec in ex._param_specs.items()
                   if spec.dim_of(MODEL_AXIS) is not None}
        _peak_reset(dev)
        runs = []
        for i in range(steps):
            model.zero_grad(set_to_none=True)
            _sync(dev)
            _zero_launches()
            mesh.reset_stats()
            t0 = time.perf_counter()
            loss, grads = ex.loss_and_grad(x, w)
            _sync(dev)
            rec = dict(loss=float(loss), ms=(time.perf_counter() - t0) * 1e3,
                       launches=_rank_counts(),
                       transport=mesh.stats.as_dict(),
                       loss_rel=abs(float(loss) - twin["loss"])
                       / abs(twin["loss"]))
            if i == 0:
                rec["digests"] = {
                    n: hashlib.blake2b(g.detach().cpu().numpy().tobytes(),
                                       digest_size=16).hexdigest()
                    for n, g in grads.items() if n not in sharded}
                rec["n_sharded"] = len(sharded & set(grads))
                rec["grad_err"] = _grad_err(ex.gather_model_grads(grads),
                                            twin["grads"])
            runs.append(rec)
            del grads
        peak = _peak(dev)
        per = TP_BATCH // TP_CHUNKS // shape[1]
        rows = slice(mesh.data * per, (mesh.data + 1) * per)
        got = _tp_per_row(ex, model, x, rows)
        per_row_rel = None
        if got is not None:
            want = twin["per_row"][:, rows]
            per_row_rel = ((got - want).abs() / want.abs()).max().item()
        out[name] = dict(steps=runs, per_row_rel=per_row_rel,
                         peak_bytes=peak, stage=mesh.stage, data=mesh.data,
                         model=mesh.model)
        del ex, model, twin
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    # (c) the generator over a model line of 4: greedy (its prefill timed
    # alone first), beam, sampled
    mesh = make_mesh(*TP_GEN_SHAPE[:2], n_model=TP_GEN_SHAPE[2])
    model = _tp_model(vocab, 16, 1, mesh=mesh, device=dev,
                      overrides=overrides)
    prompt = data["prompt"].to(dev)
    g = TPShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=TP_GEN_NEW, temperature=0.0))
    _zero_launches()
    _peak_reset(dev)
    total = TP_GEN_PROMPT + TP_GEN_NEW
    with torch.inference_mode():
        _sync(dev)
        mesh.reset_stats()
        t0 = time.perf_counter()
        h, _ = g._prefill(prompt, total, causal_table(total, prompt.device))
        head_logits(model, h[:, -1])
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_stats = mesh.stats.as_dict()
        del h
    mesh.reset_stats()
    t0 = time.perf_counter()
    greedy = g.generate(prompt)
    _sync(dev)
    total_ms = (time.perf_counter() - t0) * 1e3
    stats = mesh.stats.as_dict()
    decode_ms = total_ms - prefill_ms
    beam, scores = TPShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=TP_BEAM_NEW, num_beams=TP_BEAMS)
    ).generate_with_scores(prompt)
    sampled = TPShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=TP_SAMPLED_NEW, temperature=RING_TEMPERATURE,
        top_k=RING_TOP_K)).generate(prompt, seed=TP_SAMPLE_SEED)
    out["generate"] = dict(
        greedy=greedy.cpu(), beam=beam.cpu(), beam_scores=scores.cpu(),
        sampled=sampled.cpu(), prefill_ms=prefill_ms, total_ms=total_ms,
        ms_per_generated_token=total_ms / TP_GEN_NEW,
        decode_ms_per_token=decode_ms / (TP_GEN_NEW - 1),
        collectives=stats["model_collectives"],
        collective_bytes=stats["model_bytes"],
        collective_s=stats["model_s"],
        collective_share=stats["model_s"] / (total_ms / 1e3),
        prefill_collective_s=prefill_stats["model_s"],
        heads=int(model.blocks[0].wqkv.shape[2]), nhead=model.cfg.nhead,
        launches=_rank_counts(), peak_bytes=_peak(dev))
    del g, model
    dist.barrier()
    return out


def _tp_split_check(vocab: int, card: str, overrides=None,
                    device="cuda") -> dict:
    """Gate (d), in the parent: one zb-h1/never step with
    ``tp_split_backward_stage`` at 8 layers against the 1f1b/never step of
    the same parameters (2 stages on the card, batch 32, chunks 4)."""
    from pipe_tpu_torch.models.tp_lm import tp_split_backward_stage

    seq = (overrides or {}).get("seq_len", BPTT)
    gen = torch.Generator(device=device).manual_seed(TP_DATA_SEED + 1)
    x, w = _tp_batch(torch.randint(0, vocab, (TP_BATCH, seq), generator=gen,
                                   device=device))
    model = _tp_model(vocab, TP_SPLIT_LAYERS, 2, tp_axis=None, device=device,
                      overrides=overrides)
    res = {}
    for name, schedule, split in (
            ("1f1b/never", "1f1b", None),
            ("zb-h1/never/split", "zb-h1", tp_split_backward_stage(model))):
        ex = _tp_table(model, 2, checkpoint="never", schedule=schedule,
                       split_stage=split, device=device)
        model.zero_grad(set_to_none=True)
        _peak_reset(device)
        _zero_launches()
        _sync(device)
        t0 = time.perf_counter()
        loss, grads = ex.loss_and_grad(x, w)
        _sync(device)
        res[name] = dict(loss=float(loss), ms=(time.perf_counter() - t0) * 1e3,
                         grads={n: g.clone() for n, g in grads.items()},
                         launches=_rank_counts(), peak_bytes=_peak(device))
    ref, got = res["1f1b/never"], res["zb-h1/never/split"]
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_err = _grad_err(got["grads"], ref["grads"])
    for name, r in res.items():
        log("tp", run=f"split/{name}", layers=TP_SPLIT_LAYERS,
            loss=f"{r['loss']:.6f}", ms=f"{r['ms']:.1f}",
            launches=list(r["launches"].values()),
            peak_bytes=r["peak_bytes"], card=card)
    log("tp", run="split", loss_rel=f"{loss_rel:.3e}",
        grad_err=f"{grad_err:.3e}")
    if (loss_rel > TOL_TP_LOSS or grad_err > TOL_TP_GRAD
            or set(got["grads"]) != set(ref["grads"])
            or any(any(r["launches"].values()) for r in res.values())):
        raise AssertionError(
            f"tp split: loss {loss_rel:.3e} (> {TOL_TP_LOSS}) or gradients "
            f"{grad_err:.3e} (> {TOL_TP_GRAD}) off the 1f1b/never step, or "
            f"a kernel launched")
    del model, res, ref, got
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return {"loss_rel": loss_rel, "grad_err": grad_err}


def phase_tp(smi: str, world=None, *, overrides=None, device="cuda",
             vocab=None) -> dict:
    """Phase 16: the model axis over the world of 4 ranks; returns the
    kernels' launches of its runs (all 0: the TP block is einsums),
    summed over ranks and steps. A CPU rehearsal passes a world of CPU
    ranks, a smaller config (``overrides``), ``device="cpu"`` and a
    ``vocab`` size (the corpus's otherwise)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    card = smi.splitlines()[0]
    if vocab is None:
        vocab = len(_corpus()[2])
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_tp_")
    refs = _tp_refs(tmp, vocab, overrides, device)
    log("tp", world=TP_WORLD, backend="gloo", device=f"{device}:0 (shared)",
        vocab=vocab, batch=TP_BATCH, chunks=TP_CHUNKS,
        twin_pp_ms=f"{refs['pp_ms']:.1f}", twin_dp_ms=f"{refs['dp_ms']:.1f}",
        refs_s=f"{time.perf_counter() - t_phase:.1f}", card=card)
    with _world(world, TP_WORLD, TP_TIMEOUT_S, TP_THREADS) as world:
        t0 = time.perf_counter()
        res = world.run(_tp_rank, tmp, vocab, overrides)
    log("tp", world_s=f"{time.perf_counter() - t0:.1f}")
    launches = {c.__name__: 0 for c in _counters()}
    for what, (shape, n_layers, _) in (("pp", TP_PP), ("dp", TP_DP)):
        for r in res:
            a = r[what]
            for i, s in enumerate(a["steps"]):
                t = s["transport"]
                log("tp", rank=r["rank"], run=f"{what}/step{i}",
                    mesh="x".join(map(str, shape)), layers=n_layers,
                    loss=f"{s['loss']:.6f}", loss_rel=f"{s['loss_rel']:.3e}",
                    ms=f"{s['ms']:.1f}",
                    launches=list(s["launches"].values()),
                    model_allreduces=t["model_collectives"],
                    model_bytes=t["model_bytes"],
                    model_s=f"{t['model_s']:.3f}",
                    p2p_bytes=t["p2p_bytes"], p2p_s=f"{t['p2p_s']:.3f}",
                    collectives=t["collectives"],
                    staged_bytes=t["staged_bytes"],
                    peak_bytes=a["peak_bytes"], card=card)
                for k, v in s["launches"].items():
                    launches[k] += v
                if s["loss_rel"] > TOL_TP_LOSS or any(s["launches"].values()):
                    raise AssertionError(
                        f"tp {what} rank {r['rank']} step {i}: loss "
                        f"{s['loss_rel']:.3e} (> {TOL_TP_LOSS}) off the twin, "
                        f"or launches {s['launches']}")
            s0 = a["steps"][0]
            log("tp", rank=r["rank"], run=what, stage=a["stage"],
                data=a["data"], model=a["model"],
                per_row_rel=("-" if a["per_row_rel"] is None
                             else f"{a['per_row_rel']:.3e}"),
                grad_err=f"{s0['grad_err']:.3e}",
                sharded_leaves=s0["n_sharded"],
                mean_ms=f"{sum(s['ms'] for s in a['steps']) / len(a['steps']):.1f}")
            if s0["grad_err"] > TOL_TP_GRAD or (
                    a["per_row_rel"] is not None
                    and a["per_row_rel"] > TOL_TP_LOSS):
                raise AssertionError(
                    f"tp {what} rank {r['rank']}: per-row "
                    f"{a['per_row_rel']} (> {TOL_TP_LOSS}) or gradients "
                    f"{s0['grad_err']:.3e} (> {TOL_TP_GRAD}) off the twin")
        # the ranks of a model line: bitwise-equal replicated gradients
        lines = {}
        for r in res:
            lines.setdefault((r[what]["stage"], r[what]["data"]),
                             []).append(r[what]["steps"][0]["digests"])
        for key, digests in lines.items():
            if len(digests) != shape[2] or any(d != digests[0]
                                               for d in digests):
                raise AssertionError(
                    f"tp {what}: the model line at (stage, data) {key} "
                    f"holds replicated gradients that differ")
        log("tp", run=what, model_lines=len(lines),
            replicated_equal=True,
            replicated_leaves=len(next(iter(lines.values()))[0]))
        if not any(r[what]["per_row_rel"] is not None for r in res):
            raise AssertionError(f"tp {what}: no rank compared per-row losses")
    # (c) every rank's tokens; rank 0's against the one-device Generator
    g0 = res[0]["generate"]
    for r in res:
        g = r["generate"]
        for k in ("greedy", "beam", "sampled"):
            if not torch.equal(g[k], g0[k]):
                raise AssertionError(f"tp generator: rank {r['rank']}'s {k} "
                                     f"tokens differ from rank 0's")
        if any(g["launches"].values()):
            raise AssertionError(f"tp generator launched {g['launches']}")
        if g["heads"] * TP_GEN_SHAPE[2] != g["nhead"]:
            raise AssertionError(f"tp generator: rank {r['rank']} holds "
                                 f"{g['heads']} heads")
    compared, departures = _ring_streams(g0["greedy"].tolist(),
                                         refs["greedy"].tolist(),
                                         refs["margins"], "tp greedy")
    beam_equal = torch.equal(g0["beam"], refs["beam"])
    beam_rel = ((g0["beam_scores"] - refs["beam_scores"]).abs()
                / refs["beam_scores"].abs()).max().item()
    agree = (g0["sampled"] == refs["sampled"]).float().mean().item()
    log("tp", run="generate", mesh="x".join(map(str, TP_GEN_SHAPE)),
        prompt=TP_GEN_PROMPT, batch=TP_GEN_BATCH, new=TP_GEN_NEW,
        compared=compared, departures=departures, beam_equal=beam_equal,
        beam_scores_rel=f"{beam_rel:.3e}", sampled_agreement=f"{agree:.4f}",
        prefill_ms=f"{g0['prefill_ms']:.1f}", total_ms=f"{g0['total_ms']:.1f}",
        ms_per_generated_token=f"{g0['ms_per_generated_token']:.3f}",
        decode_ms_per_token=f"{g0['decode_ms_per_token']:.3f}",
        allreduces=g0["collectives"], allreduce_bytes=g0["collective_bytes"],
        allreduce_s=f"{g0['collective_s']:.3f}",
        collective_share=f"{g0['collective_share']:.3f}",
        prefill_allreduce_s=f"{g0['prefill_collective_s']:.3f}",
        peak_bytes=g0["peak_bytes"], card=card)
    if not beam_equal or beam_rel > TOL_TP_SCORES:
        raise AssertionError(f"tp beam: tokens equal {beam_equal}, scores rel "
                             f"{beam_rel:.3e}")
    _tp_split_check(vocab, card, overrides, device)
    shutil.rmtree(tmp, ignore_errors=True)
    log("tp", seconds=f"{time.perf_counter() - t_phase:.1f}", card=card)
    return launches

# Phase 17: MoELMConfig's defaults at the tutorial LM's full width (8
# experts, top 2, capacity 1.25), dropout 0, weights and tokens from seeds;
# (a) over (2, 1, 2) for one step, (b) the generator over (1, 1, 4).
MOE_WORLD = 4
MOE_WEIGHT_SEED = 47
MOE_DATA_SEED = 53
MOE_PP = ((2, 1, 2), 16, 1)      # (stages, data, model), layers, steps
MOE_GEN_SHAPE = (1, 1, 4)
MOE_GEN_BATCH = 2
MOE_GEN_PROMPT = 128
MOE_GEN_NEW = 32
MOE_BEAMS = 2
MOE_BEAM_NEW = 8


def _moe_model(vocab: int, n_layers: int, n_stages: int, *, mesh=None,
               ep_axis="model", device="cuda", overrides=None):
    """``MoEPipelinedLM`` at full width (``MoELMConfig`` defaults;
    ``overrides``: a smaller config, for a CPU rehearsal), dropout 0, on
    ``device``, its weights drawn from phase 17's seed (the same bits in
    every process on one card, whatever the stage count or ``ep_axis``)."""
    from pipe_tpu_torch.models.moe_lm import MoELMConfig, MoEPipelinedLM
    cfg = dataclasses.replace(
        MoELMConfig(vocab=vocab, dropout=0.0, n_layers=n_layers),
        **(overrides or {}))
    return MoEPipelinedLM(cfg, n_stages, ep_axis, mesh=mesh, device=device,
                          generator=torch.Generator(device=device)
                          .manual_seed(MOE_WEIGHT_SEED))


def _gen_margins(gen, prompt, toks) -> tuple:
    """Per row, at each step of the greedy stream ``toks``: the top-2 gap of
    the logits that picked it over the largest |logit| (the near-tie rule's
    unit), from ``gen``'s own cached calls teacher-forced on ``toks`` (the
    whole batch a call, so a MoE layer's capacity is the stream's own); and
    the largest |logit| of the stream."""
    from pipe_tpu_torch.inference.generate import head_logits
    from pipe_tpu_torch.ops.layers import causal_table

    m = gen.model
    b, p = prompt.shape
    n = toks.shape[1]
    allowed = causal_table(p + n, prompt.device)
    rows = [[] for _ in range(b)]
    scale = 0.0
    with torch.inference_mode():
        h, caches = gen._prefill(prompt, p + n, allowed)
        for t in range(n):
            if t:
                pos = p + t - 1
                h = gen._run_layers(m.embed_at(toks[:, t - 1:t], pos),
                                    caches, pos, allowed)
            logits = head_logits(m, h[:, -1]).float()
            top2 = torch.topk(logits, 2, dim=-1).values
            gap = (top2[:, 0] - top2[:, 1]) / logits.abs().amax(-1)
            scale = max(scale, logits.abs().max().item())
            for i, g in enumerate(gap.tolist()):
                rows[i].append(g)
    return rows, scale


def _moe_refs(tmp: str, vocab: int, overrides=None, device="cuda") -> dict:
    """The one-device twins, in the parent: ``MoEPipelinedLM(ep_axis=None)``
    through the one-device table executor (1f1b, except_last) at (a)'s 16
    layers over 2 stages (per-row losses, the loss and its gradients,
    written to a file the ranks read; the token-slots each layer drops over
    the batch's micro-batches), and the one-device ``Generator``'s greedy
    tokens with their near-tie margins and its beam tokens and scores over
    (b)'s prompt. ``overrides`` and ``device``: a CPU rehearsal's."""
    from pipe_tpu_torch.core.partition import StageCtx
    from pipe_tpu_torch.inference import GenerationConfig, Generator

    seq = (overrides or {}).get("seq_len", BPTT)
    gen = torch.Generator(device=device).manual_seed(MOE_DATA_SEED)
    tokens = torch.randint(0, vocab, (TP_BATCH, seq), generator=gen,
                           device=device)
    prompt = torch.randint(0, vocab, (MOE_GEN_BATCH, MOE_GEN_PROMPT),
                           generator=gen, device=device)
    torch.save({"tokens": tokens.cpu(), "prompt": prompt.cpu()},
               os.path.join(tmp, "moe.pt"))
    x, w = _tp_batch(tokens)
    (n_stages, _, _), n_layers, _ = MOE_PP
    model = _moe_model(vocab, n_layers, n_stages, ep_axis=None,
                       device=device, overrides=overrides)
    refs = {"params": sum(p.numel() for p in model.parameters()),
            "n_experts": model.cfg.n_experts}
    ex = _tp_table(model, n_stages, device=device)
    _peak_reset(device)
    _sync(device)
    t0 = time.perf_counter()
    loss, grads = ex.loss_and_grad(x, w)
    _sync(device)
    refs.update(ms=(time.perf_counter() - t0) * 1e3, loss=float(loss),
                peak_bytes=_peak(device),
                per_row=_tp_per_row(ex, model, x))
    torch.save({"grads": {n: g.detach().cpu() for n, g in grads.items()},
                "per_row": refs["per_row"], "loss": refs["loss"]},
               os.path.join(tmp, "twin_moe.pt"))
    del grads, ex
    dropped = [0] * n_layers
    with torch.no_grad():
        for i in range(x["tokens"].shape[0]):
            h = model.pre_fn({"tokens": x["tokens"][i]}, StageCtx(train=False))
            for l, blk in enumerate(model.blocks):
                dropped[l] += blk.dropped_slots(h)
                h = blk(h)
    refs["dropped"] = dropped
    refs["slots"] = x["tokens"].numel() * model.cfg.top_k
    g = Generator(model, GenerationConfig(max_new_tokens=MOE_GEN_NEW,
                                          temperature=0.0))
    greedy = g.generate(prompt)
    refs["greedy"] = greedy.cpu()
    refs["margins"], refs["logit_scale"] = _gen_margins(g, prompt, greedy)
    toks, scores = Generator(model, GenerationConfig(
        max_new_tokens=MOE_BEAM_NEW, num_beams=MOE_BEAMS)
    ).generate_with_scores(prompt)
    refs["beam"], refs["beam_scores"] = toks.cpu(), scores.cpu()
    del model, g
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    return refs


def _moe_rank(tmp: str, vocab: int, overrides=None) -> dict:
    """On each rank of the world: gates (a) and (b) of phase 17 (its
    docstring), against the twin's file; every rank returns its own
    numbers. ``overrides``: a smaller config, for a CPU rehearsal (the
    mesh's device then is the CPU)."""
    import hashlib

    import torch.distributed as dist

    from pipe_tpu_torch.inference import GenerationConfig
    from pipe_tpu_torch.inference.generate import head_logits
    from pipe_tpu_torch.inference.pipelined import stage_modules
    from pipe_tpu_torch.inference.tp import TPShardedGenerator
    from pipe_tpu_torch.ops.layers import causal_table
    from pipe_tpu_torch.parallel.mesh import MODEL_AXIS, localize, make_mesh
    from pipe_tpu_torch.runtime.distributed import rank_device

    dev = rank_device()
    data = torch.load(os.path.join(tmp, "moe.pt"))
    x, w = _tp_batch(data["tokens"].to(dev))
    out = {"rank": dist.get_rank()}

    # (a) the training step over (2, 1, 2)
    shape, n_layers, steps = MOE_PP
    twin = torch.load(os.path.join(tmp, "twin_moe.pt"), mmap=True)
    mesh = make_mesh(shape[0], shape[1], n_model=shape[2])
    model = _moe_model(vocab, n_layers, shape[0], mesh=mesh, device=dev,
                       overrides=overrides)
    localize(model, stage_modules(model, mesh.stage, shape[0]), dev)
    ex = _tp_table(model, shape[0], mesh=mesh,
                   stage_param_specs=model.stage_param_specs())
    sharded = {n for n, spec in ex._param_specs.items()
               if spec.dim_of(MODEL_AXIS) is not None}
    _peak_reset(dev)
    runs = []
    for i in range(steps):
        model.zero_grad(set_to_none=True)
        _sync(dev)
        _zero_launches()
        mesh.reset_stats()
        t0 = time.perf_counter()
        loss, grads = ex.loss_and_grad(x, w)
        _sync(dev)
        rec = dict(loss=float(loss), ms=(time.perf_counter() - t0) * 1e3,
                   launches=_rank_counts(), transport=mesh.stats.as_dict(),
                   loss_rel=abs(float(loss) - twin["loss"])
                   / abs(twin["loss"]))
        if i == 0:
            rec["digests"] = {
                n: hashlib.blake2b(g.detach().cpu().numpy().tobytes(),
                                   digest_size=16).hexdigest()
                for n, g in grads.items() if n not in sharded}
            rec["n_sharded"] = len(sharded & set(grads))
            rec["experts"] = int(next(
                b for b in model.blocks
                if b.moe.w1.device.type != "meta").moe.w1.shape[0])
            rec["grad_err"] = _grad_err(ex.gather_model_grads(grads),
                                        twin["grads"])
        runs.append(rec)
        del grads
    peak = _peak(dev)
    _zero_launches()
    got = _tp_per_row(ex, model, x)
    per_row_rel = None
    if got is not None:
        want = twin["per_row"]
        per_row_rel = ((got - want).abs() / want.abs()).max().item()
    out["pp"] = dict(steps=runs, per_row_rel=per_row_rel, peak_bytes=peak,
                     stage=mesh.stage, data=mesh.data, model=mesh.model,
                     forward_launches=_rank_counts())
    del ex, model, twin
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (b) the generator over a model line of 4: greedy (its prefill timed
    # alone first), beam
    mesh = make_mesh(*MOE_GEN_SHAPE[:2], n_model=MOE_GEN_SHAPE[2])
    model = _moe_model(vocab, 16, 1, mesh=mesh, device=dev,
                       overrides=overrides)
    prompt = data["prompt"].to(dev)
    g = TPShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=MOE_GEN_NEW, temperature=0.0))
    _zero_launches()
    _peak_reset(dev)
    total = MOE_GEN_PROMPT + MOE_GEN_NEW
    with torch.inference_mode():
        _sync(dev)
        mesh.reset_stats()
        t0 = time.perf_counter()
        h, _ = g._prefill(prompt, total, causal_table(total, prompt.device))
        head_logits(model, h[:, -1])
        _sync(dev)
        prefill_ms = (time.perf_counter() - t0) * 1e3
        prefill_stats = mesh.stats.as_dict()
        del h
    mesh.reset_stats()
    t0 = time.perf_counter()
    greedy = g.generate(prompt)
    _sync(dev)
    total_ms = (time.perf_counter() - t0) * 1e3
    stats = mesh.stats.as_dict()
    beam, scores = TPShardedGenerator(mesh, model, GenerationConfig(
        max_new_tokens=MOE_BEAM_NEW, num_beams=MOE_BEAMS)
    ).generate_with_scores(prompt)
    blk = model.blocks[0]
    out["generate"] = dict(
        greedy=greedy.cpu(), beam=beam.cpu(), beam_scores=scores.cpu(),
        prefill_ms=prefill_ms, total_ms=total_ms,
        ms_per_generated_token=total_ms / MOE_GEN_NEW,
        decode_ms_per_token=(total_ms - prefill_ms) / (MOE_GEN_NEW - 1),
        collectives=stats["model_collectives"],
        collective_bytes=stats["model_bytes"],
        collective_s=stats["model_s"],
        collective_share=stats["model_s"] / (total_ms / 1e3),
        prefill_collectives=prefill_stats["model_collectives"],
        prefill_collective_s=prefill_stats["model_s"],
        heads=int(blk.wqkv.shape[2]), nhead=model.cfg.nhead,
        experts=int(blk.moe.w1.shape[0]), n_experts=model.cfg.n_experts,
        launches=_rank_counts(), peak_bytes=_peak(dev))
    del g, model
    dist.barrier()
    return out


def phase_moe(smi: str, world=None, *, overrides=None, device="cuda",
              vocab=None) -> dict:
    """Phase 17: MoE over the model axis in the world of 4 ranks; returns
    the kernels' launches of its runs (all 0: the MoE block is einsums),
    summed over ranks. A CPU rehearsal passes a world of CPU ranks, a
    smaller config (``overrides``), ``device="cpu"`` and a ``vocab`` size
    (the corpus's otherwise)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    card = smi.splitlines()[0]
    if vocab is None:
        vocab = len(_corpus()[2])
    tmp = tempfile.mkdtemp(prefix="pipe_tpu_moe_")
    refs = _moe_refs(tmp, vocab, overrides, device)
    (shape, n_layers, _) = MOE_PP
    log("moe", world=MOE_WORLD, backend="gloo", device=f"{device}:0 (shared)",
        vocab=vocab, params=refs["params"], batch=TP_BATCH, chunks=TP_CHUNKS,
        twin_ms=f"{refs['ms']:.1f}", twin_loss=f"{refs['loss']:.6f}",
        twin_peak_bytes=refs["peak_bytes"],
        refs_s=f"{time.perf_counter() - t_phase:.1f}", card=card)
    log("moe", run="twin", dropped_slots_per_layer=refs["dropped"],
        slots_per_layer=refs["slots"],
        dropped_share=f"{sum(refs['dropped']) / (refs['slots'] * n_layers):.4f}")
    with _world(world, MOE_WORLD, TP_TIMEOUT_S, TP_THREADS) as world:
        t0 = time.perf_counter()
        res = world.run(_moe_rank, tmp, vocab, overrides)
    log("moe", world_s=f"{time.perf_counter() - t0:.1f}")
    launches = {c.__name__: 0 for c in _counters()}
    for r in res:
        a = r["pp"]
        for i, s in enumerate(a["steps"]):
            t = s["transport"]
            log("moe", rank=r["rank"], run=f"pp/step{i}",
                mesh="x".join(map(str, shape)), layers=n_layers,
                loss=f"{s['loss']:.6f}", loss_rel=f"{s['loss_rel']:.3e}",
                ms=f"{s['ms']:.1f}", launches=list(s["launches"].values()),
                model_collectives=t["model_collectives"],
                model_bytes=t["model_bytes"], model_s=f"{t['model_s']:.3f}",
                p2p_bytes=t["p2p_bytes"], p2p_s=f"{t['p2p_s']:.3f}",
                collectives=t["collectives"], staged_bytes=t["staged_bytes"],
                peak_bytes=a["peak_bytes"], card=card)
            for k, v in s["launches"].items():
                launches[k] += v
            if s["loss_rel"] > TOL_TP_LOSS or any(s["launches"].values()):
                raise AssertionError(
                    f"moe rank {r['rank']} step {i}: loss {s['loss_rel']:.3e} "
                    f"(> {TOL_TP_LOSS}) off the twin, or launches "
                    f"{s['launches']}")
        s0 = a["steps"][0]
        for k, v in a["forward_launches"].items():
            launches[k] += v
        log("moe", rank=r["rank"], run="pp", stage=a["stage"], data=a["data"],
            model=a["model"], experts=s0["experts"],
            per_row_rel=("-" if a["per_row_rel"] is None
                         else f"{a['per_row_rel']:.3e}"),
            grad_err=f"{s0['grad_err']:.3e}",
            sharded_leaves=s0["n_sharded"])
        if s0["grad_err"] > TOL_TP_GRAD or any(
                a["forward_launches"].values()) or (
                a["per_row_rel"] is not None
                and a["per_row_rel"] > TOL_TP_LOSS):
            raise AssertionError(
                f"moe rank {r['rank']}: per-row {a['per_row_rel']} (> "
                f"{TOL_TP_LOSS}) or gradients {s0['grad_err']:.3e} (> "
                f"{TOL_TP_GRAD}) off the twin, or the forward launched "
                f"{a['forward_launches']}")
        if s0["experts"] * shape[2] != refs["n_experts"]:
            raise AssertionError(f"moe rank {r['rank']} holds "
                                 f"{s0['experts']} experts")
    # the ranks of a model line: bitwise-equal replicated gradients
    lines = {}
    for r in res:
        lines.setdefault((r["pp"]["stage"], r["pp"]["data"]),
                         []).append(r["pp"]["steps"][0]["digests"])
    for key, digests in lines.items():
        if len(digests) != shape[2] or any(d != digests[0] for d in digests):
            raise AssertionError(f"moe: the model line at (stage, data) "
                                 f"{key} holds replicated gradients that "
                                 f"differ")
    if not any(r["pp"]["per_row_rel"] is not None for r in res):
        raise AssertionError("moe: no rank compared per-row losses")
    log("moe", run="pp", model_lines=len(lines), replicated_equal=True,
        replicated_leaves=len(next(iter(lines.values()))[0]))
    # (b) every rank's tokens; rank 0's against the one-device Generator
    g0 = res[0]["generate"]
    for r in res:
        g = r["generate"]
        for k in ("greedy", "beam"):
            if not torch.equal(g[k], g0[k]):
                raise AssertionError(f"moe generator: rank {r['rank']}'s {k} "
                                     f"tokens differ from rank 0's")
        if any(g["launches"].values()):
            raise AssertionError(f"moe generator launched {g['launches']}")
        if (g["heads"] * MOE_GEN_SHAPE[2] != g["nhead"]
                or g["experts"] * MOE_GEN_SHAPE[2] != g["n_experts"]):
            raise AssertionError(f"moe generator: rank {r['rank']} holds "
                                 f"{g['heads']} heads, {g['experts']} "
                                 f"experts")
    compared, departures = _ring_streams(g0["greedy"].tolist(),
                                         refs["greedy"].tolist(),
                                         refs["margins"], "moe greedy")
    beam_equal = torch.equal(g0["beam"], refs["beam"])
    beam_diff = (g0["beam_scores"] - refs["beam_scores"]).abs()
    beam_rel = (beam_diff / refs["beam_scores"].abs()).max().item()
    # A beam score sums log-probabilities taken from logits as large as
    # logit_scale, which fp32 resolves to one ulp of that scale: a score
    # near 0 cannot agree more closely than that, whatever its relative
    # bound says.
    ulp = float(np.spacing(np.float32(refs["logit_scale"])))
    beam_ok = bool((beam_diff <= torch.clamp(
        TOL_TP_SCORES * refs["beam_scores"].abs(), min=ulp)).all())
    log("moe", run="generate", mesh="x".join(map(str, MOE_GEN_SHAPE)),
        prompt=MOE_GEN_PROMPT, batch=MOE_GEN_BATCH, new=MOE_GEN_NEW,
        heads=g0["heads"], experts=g0["experts"],
        compared=compared, departures=departures, beam_equal=beam_equal,
        beam_scores_rel=f"{beam_rel:.3e}",
        beam_scores=[f"{v:.9g}" for v in g0["beam_scores"].tolist()],
        twin_beam_scores=[f"{v:.9g}" for v in refs["beam_scores"].tolist()],
        beam_scores_abs=f"{beam_diff.max().item():.3e}",
        logit_scale=f"{refs['logit_scale']:.4g}", logit_ulp=f"{ulp:.3e}",
        prefill_ms=f"{g0['prefill_ms']:.1f}", total_ms=f"{g0['total_ms']:.1f}",
        ms_per_generated_token=f"{g0['ms_per_generated_token']:.3f}",
        decode_ms_per_token=f"{g0['decode_ms_per_token']:.3f}",
        allreduces=g0["collectives"], allreduce_bytes=g0["collective_bytes"],
        allreduce_s=f"{g0['collective_s']:.3f}",
        collective_share=f"{g0['collective_share']:.3f}",
        prefill_allreduces=g0["prefill_collectives"],
        prefill_allreduce_s=f"{g0['prefill_collective_s']:.3f}",
        peak_bytes=g0["peak_bytes"], card=card)
    if not beam_equal or not beam_ok:
        raise AssertionError(f"moe beam: tokens equal {beam_equal}, scores "
                             f"{beam_diff.tolist()} off the twin's, over "
                             f"{TOL_TP_SCORES} relative and one ulp of "
                             f"{refs['logit_scale']:.4g}")
    shutil.rmtree(tmp, ignore_errors=True)
    log("moe", seconds=f"{time.perf_counter() - t_phase:.1f}", card=card)
    return launches


_T_START = time.perf_counter()


def fresh(phase: str) -> None:
    """Start ``phase`` clean: collect the cyclic garbage earlier phases
    left, empty the allocator's cache, print what is still allocated and
    the script's seconds so far (a phase's wall is the next phase's
    ``script_s`` less its own)."""
    gc.collect()
    torch.cuda.empty_cache()
    log(phase, start_memory_allocated=torch.cuda.memory_allocated(),
        script_s=f"{time.perf_counter() - _T_START:.1f}")


def main() -> int:
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    t_start = time.perf_counter()
    smi = phase_device()
    fresh("build")
    phase_build()
    fresh("kernels")
    rows = phase_kernels()
    fresh("slice")
    eval_launches = phase_slice()
    fresh("train")
    train_launches = phase_train()
    fresh("train_obs")
    obs_launches = phase_train_obs(smi)
    fresh("schedules")
    sched_launches = phase_schedules()
    fresh("remat")
    remat_launches = phase_remat()
    fresh("gpt2")
    gpt2_launches, gpt2_zoo_losses = phase_gpt2()
    fresh("gpt2_serve")
    phase_gpt2_serve()
    fresh("bert")
    bert_launches = phase_bert()
    fresh("vit")
    phase_vit()
    fresh("generate")
    gap = phase_generate()
    fresh("serve")
    ctx = phase_serve(gap, smi)
    fresh("paged")
    ctx["resident"] = phase_serve_paged(ctx, smi)
    fresh("spec")
    phase_serve_spec(ctx, smi)
    del ctx
    fresh("fleet")
    phase_fleet(smi, gap)
    # phases 11-17 share one world of 4 ranks: it is spawned, and each
    # rank's CUDA context made, once
    from pipe_tpu_torch.runtime.distributed import World
    with World(MESH_WORLD, device="cuda", backend="gloo",
               timeout=MESH_TIMEOUT_S, threads=MESH_THREADS) as world:
        fresh("mesh")
        mesh_launches = phase_mesh(smi, world)
        fresh("overlap")
        zoo_world_launches = phase_overlap(smi, world, gpt2_zoo_losses)
        fresh("ring")
        ring_launches = phase_ring(smi, world)
        fresh("elastic")
        elastic_launches = phase_elastic(smi, world)
        fresh("context")
        context_launches = phase_context(smi, world)
        fresh("tp")
        tp_launches = phase_tp(smi, world)
        fresh("moe")
        moe_launches = phase_moe(smi, world)
    sources = {"flash_attn_fwd": ("flash_attn_fwd.cu", 87,
                                  "flash_attention_fwd"),
               "flash_attn_bwd_dq": ("flash_attn_bwd.cu", 162,
                                     "flash_attention_bwd_dq"),
               "flash_attn_bwd_dkv": ("flash_attn_bwd_dkv.cu", 201,
                                      "flash_attention_bwd_dkv")}
    kernels = {"kernels": []}
    for name, (src, line, wrapper) in sources.items():
        row = rows[name]
        entry = {
            "name": name,
            "route": "cuda",
            "source": f"pipe_tpu_torch/csrc/{src}",
            "replaces": f"pipe_tpu/ops/pallas_attention.py:{line}",
            "launches": train_launches[wrapper],
            "max_abs_err": row["max_abs_err"],
            "ms": row["ms"],
            "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"],
            "library_ms": row["library_ms"],
            "library_ms_no_dropout": row["library_ms_no_dropout"],
        }
        if name == "flash_attn_fwd":
            entry["launches_eval"] = eval_launches
        entry["launches_by_schedule"] = {
            run: launches[wrapper] for run, launches in sched_launches.items()}
        entry["launches_gpt2"] = {
            run: launches[wrapper] for run, launches in gpt2_launches.items()}
        entry["launches_remat"] = {
            run: launches[wrapper] for run, launches in remat_launches.items()}
        entry["launches_bert"] = {
            run: launches[wrapper] for run, launches in bert_launches.items()}
        entry["launches_vit"] = 0
        entry["launches_train_obs"] = {
            run: launches[wrapper] for run, launches in obs_launches.items()}
        entry["launches_mesh"] = {
            run: launches[wrapper] for run, launches in mesh_launches.items()}
        entry["launches_ring_train"] = ring_launches[wrapper]
        entry["launches_elastic"] = elastic_launches[wrapper]
        entry["launches_zoo_world"] = zoo_world_launches[wrapper]
        entry["launches_context"] = {
            "ulysses_per_rank_step": context_launches["per_rank_step"][wrapper],
            "ulysses_total": context_launches["total"][wrapper],
            "ring": 0, "generator": 0}
        entry["launches_tp"] = tp_launches[wrapper]
        entry["launches_moe"] = moe_launches[wrapper]
        entry["gpt2_shape"] = row["gpt2_shape"]
        entry["bert_shape"] = row["bert_shape"]
        entry["mesh_shape"] = row["mesh_shape"]
        entry["context_shape"] = row["context_shape"]
        kernels["kernels"].append(entry)
    log("done", seconds=f"{time.perf_counter() - t_start:.1f}")
    print(smi.splitlines()[0], flush=True)
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
