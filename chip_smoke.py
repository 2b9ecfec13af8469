#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, with a CUDA device. Phases, in order; any
failure raises and the script exits non-zero without printing a result:

  1. device   the card's name and power limit (nvidia-smi)
  2. build    nvcc builds every kernel from ``src/repro_torch/kernels/csrc``
              (ptxas registers and spills printed); K4's library must hold
              tensor-core instructions (``HGMMA`` in ``cuobjdump -sass``)
  3. parity   each partitioner kernel on small odd-k inputs against the
              plain version on the CPU (K1 and K3's span kernel under the
              layout's span plan and one of 16-entry, 4-row spans, k up to
              64, nb 1 and 3, and on a slab with a hub row of 1,048,589
              entries, two calls bit-equal; K3 in its slots and gather forms
              and on empty rows, its float route on random float values; K1
              in both weight modes and K3's gather form on synthetic integer
              weights up to 10^4, bit-equal; phase 11d checks them on WIKI's
              own contracted levels);
              the load and demand sums
              of odd degrees past 2^24, permuted and repeated on the card,
              equal to the CPU's (the exact sum rounded once); then 3
              Revolver supersteps on the card
              (kernels) against 3 on the CPU (plain versions) from one state
              with the same random draws, both weight modes: labels, lambda,
              loads and score equal, probabilities within tolerance; then 3
              Spinner and 3 restream supersteps the same way: labels, loads,
              score, restream's spent budgets and ranks equal
  4. attn     K4 and K5 on small odd shapes (GQA groups 1, 4, 8; causal,
              windowed, Sq < Skv and Sq > Skv, ragged lengths, kv_len 0, 1,
              S and mixed, with m and l) against their plain versions on the
              CPU, f32 and bf16; K4 also on the tensor-core body's edges
              (Sq = Skv = 129, 255, 1025; Sq = 1 against 1000 keys; D 128 at
              group 8 with a window crossing kv tiles; Sq > Skv at D 128),
              K5 with kv_len on both sides of a split boundary and at S
              with the most splits; K4 at MLA's head widths, 24 (SIMT) and
              192 (bf16 on the tensor-core body), ragged, windowed, one row
              and rows without keys; K4 and K5 at h2o-danube-3-4b's head
              width 120 and zamba2-7b's 224 (bf16 on the tensor-core
              bodies, padded in shared memory; f32 on the SIMT bodies):
              causal, windowed across kv tiles, Sq = Skv = 129 and 1025,
              Sq = 1 against 1000 keys, groups 1 and 4, kv_len 0, 1, S,
              mixed and on both sides of a split boundary, with m and l;
              K4 without a mask at whisper-base's shapes (Sq = Skv = 1500:
              23 whole 64-key tiles and a ragged one; Sq 64 and 1 against
              1500 keys), causal at group 7 (D 64, internvl2-1b) and group
              12 (D 128, command-r-plus-104b); K5 on a 1500-row cache (no
              whole number of split rows) at kv_len 1500, 1499, mixed and on
              both sides of its serving plan's last split, at groups 7 and
              12; every K4 case two calls bit-equal; then reduced GQA tinyllama in f32 (TF32 off):
              prefill and 8 greedy decode steps on the card (kernels) against
              the same on the CPU (plain versions), from one set of weights,
              every weight redrawn around its init first (so constant leaves
              such as norm scales, LoRA b, A_log, dt_bias, D and conv biases
              carry signal), every cache tensor compared; then reduced
              deepseek-v2-lite-16b and deepseek-v2-236b the same way (MoE
              and MLA, K4 at D 24; 236b with q LoRA and routed scale 16;
              both caches, c_kv and k_pe, of the dense and the MoE stack);
              then reduced h2o-danube-3-4b (window 16: the 37-token prompt
              wraps the ring in prefill, its decode through K5 at kv_len
              min(pos + 1, W)) and reduced zamba2-7b (prompts of 37, the
              Mamba2 scan, and 32, the chunked form) the same way, every
              tensor of their caches compared; then reduced whisper-base
              (16 stub frames; its self and cross caches), internvl2-1b (8
              stub patches before the prompt) and command-r-plus-104b (the
              parallel block) the same way
  5. lm-full  tinyllama-1.1b at full width, bf16, random weights from seed 0
              on the card: prefill(1024) + decode(token 1025) against
              prefill(1025) (greedy argmax held as in phase 7's bf16 run)
  6. rwkv-small  K6 on small odd shapes (B 1-3, H 1-4, N 8/16/32/80, S 1
              to 1024: below 8 tokens (the token-serial kernel), below one
              chunk (the spread kernel) and past it with ragged last chunks, strong and weak decays, a nonzero state0,
              the final state written over it) against its plain version on
              the CPU, f32, two calls bit-equal; then reduced rwkv6-3b in f32 (TF32
              off): prefill and 8 greedy decode steps on the card against
              the CPU, from one set of weights, redrawn as in phase 4
  7. rwkv-full  rwkv6-3b at full width, random weights from seed 0 on the
              card: prefill(1024) + decode(token 1025) against prefill(1025)
              (K6 at a ragged S), in bf16 (relative L2 < 5e-2, greedy
              argmax equal on every row whose top-two gap exceeds one bf16
              ulp of its top logit), then with f32 weights and activations
              (relative L2 < 1e-3, greedy argmax equal on every row)
  7c. train  (in the host build's wait, after the side legs of phases
              16, 17, 17h and 11e) every launch counter set to 0 first;
              (a) each of the ten archs reduced, f32 (TF32 off): `lm_loss`
              and every gradient leaf on the card against the port on the
              CPU from one set of weights (redrawn as in phase 4) and one
              batch of the data pipeline (loss to 1e-5 relative, each leaf
              within 1e-4 of its L2 norm, a leaf zero up to rounding below
              1e-6 of the global norm on both), a second backward on the
              card bit-equal, one train step at microbatch 2 against 1
              (loss and grad norm to 1e-5 relative, the first moments leaf
              by leaf as the gradients); the
              Trainer on reduced tinyllama (GQA) with a failure injected at
              step 4 resumes to a state and losses bit-equal to an
              uninterrupted run's; (b) tinyllama-1.1b at full width and
              depth (22 layers, d 2048, vocab 32000), bf16 parameters,
              remat, batch 8 x 512 tokens, 4 steps at lr 1e-3 through
              ``launch/train.py``'s `main` with a temporary checkpoint
              directory (a checkpoint at step 4): every loss finite, the
              first within 5 % of ln 32000, the last below the first; the
              checkpoint's parameters read back bit-equal; a second run
              from the seed bit-equal; the median step time of steps 2-4, tokens/s, the
              model-FLOP share (6 N tokens over the step time and 989
              TFLOP/s), peak memory (within 1.25x either way of the dry
              run's argument + output + temp bytes at batch 8 x 512 on the
              one-rank host mesh, as in 7k), the train state's bytes, one more
              step profiled (busy share, kernels), the checkpoint's save
              and restore seconds; no kernel launched in (a) or (b); (c)
              ``launch/serve.py --ckpt-dir`` on that checkpoint (batch 8,
              1024-token prompts, 16 new tokens, greedy: K4 22, K5 330)
              gives the tokens of an ``Engine`` on the trainer's
              parameters in memory; the directory removed in any case
  7d. deepseek  (in the same wait, after 7c) deepseek-v2-lite-16b at full width and
              depth (27 layers, 64 routed experts top-6 + 2 shared, MLA),
              bf16, random weights from seed 0: 15,706,484,224 parameters
              (`repro`'s count); prefill(1024) + decode(token 1025) against
              prefill(1025) at a capacity factor just above 64 / 6, where
              nothing drops: relative L2 < 5e-2 over all rows, the greedy
              token on every decided row (a row whose router picks differ
              between the paths at some layer is left out only if the gate
              fails with it; the routing agreement, the flipped picks'
              router margins and the rows left out printed); then
              ``Engine.generate`` at the config's capacity factor 1.25 (batch
              8, 1024-token prompts, 128 new tokens, greedy) with every
              launch counter set to 0 just before and read just after: K4
              once a layer (27), no other kernel (MLA's absorbed decode and
              the MoE dispatch are plain PyTorch, as in `repro`); two
              generates bit-equal (no float atomics in the MoE combine); rates, time to first token, peak memory,
              the device busy share over decode steps; each MoE layer's
              dropped pairs and max / mean expert load at the prefill, and
              none dropped in decode. No f32 leg: its weights alone would
              take 62.8 GB
  7j. placement  (right after 7d, on its model) Revolver expert placement
              and the LM mesh: (a) each of the 26 MoE layers' routing
              ``top_idx`` [8192, 6] from the serving prefill (K4 27), the
              unplaced logits and generate kept; (b) ``place_experts`` (64
              experts on 8 ranks, up to 120 supersteps) on every layer, K1
              and K2 once a superstep each, 8 experts a rank, the cross-rank
              co-activation naive and Revolver's printed; the clustered
              routing of ``examples/expert_placement_torch.py``: Revolver at most
              the naive fraction less 0.3; (c) every MoE replaced by its
              ``apply_placement`` copy layer by layer: logits and the
              generate bit-equal to (a)'s; (d) under
              ``use_activation_sharding(LMMesh((1, 8), ("data", "model"),
              [cuda:0] * 8))`` every MoE layer through the expert-parallel
              path in prefill and decode (counted by ``record_dispatch``),
              rank r's experts views of placed experts [8r, 8r + 8):
              prefill and decode logits against (c)'s by the bf16 rule,
              drops equal a layer on the single-device run's layer inputs
              (end to end printed: bf16 rounding flips near-tie routing
              picks downstream) and each layer there within relative L2
              1e-2 (each rank's routed and shared pieces' sizes printed:
              what a psum that lost one would read), ``Engine.generate`` of 16 new tokens
              timed with K4 27 launches, a second generate of 16 tokens
              bit-equal to it, peak memory within 4 GB of 7d's,
              its busy share over 2 decode steps; (e) one MoE layer across pods (mesh
              (2, 1, 4), batch 8 x 512) against the local path at dropless
              capacity, relative L2 < 5e-2; then (f) K5 with (m, l) on 4
              sequence shards of tinyllama-1.1b's decode cache merged by
              ``sharded_decode_attention`` against K5 on the whole cache,
              each row within 1e-2 of its norm, the shards' launches timed
              beside the whole cache's; (g) ``ef_int8_psum`` over 4 ranks
              of f32 [32000, 2048]: codes and scales bit-equal to the
              CPU's, the error within half a step, 50 feedback rounds
              within one step of the input
  7e. h2o   (in the same wait) h2o-danube-3-4b at full width and depth
              (24 layers, d 3840, 32 q / 8 KV heads of 120, sliding window
              4096), bf16, random weights from seed 0: 3,961,839,360
              parameters (`repro`'s count); prefill(4608) + decode(token
              4609) against prefill(4609) at batch 4, past the window, so
              the ring buffer has wrapped (gated as phase 7); then
              ``Engine.generate`` (batch 4, 4608-token prompts, 128 new
              tokens, greedy), every launch counter set to 0 just before
              and read just after: K4 once a layer (24), K5 once a layer and
              decode step (3,048), no other kernel; two generates
              bit-equal; rates, time to first token, peak memory, the
              device busy share over decode steps
  7f. zamba (in the same wait) zamba2-7b at full width, its depth cut
              from 13 to 4 groups (for the script's time limit: 6 once
              phases 7g-7i came, then 4): 4 x [the shared attention block
              at 2 d =
              7168, 32 heads of 224, LoRA rank 128; 5 Mamba2 layers] + 3,
              d 3584),
              random weights from seed 0 with every LoRA b drawn from N(0,
              0.02^2) after init (0 at init, which would make the LoRA path
              vanish): its parameter count at 4 groups, and at all 13
              (6,142,959,936, `repro`'s count) from one group's; in bf16
              prefill(1024) (the chunked SSD form) + decode(token 1025)
              against prefill(1025) (the scan), gated as phase 7; then
              ``Engine.generate`` (batch 8, 1024-token prompts, 128 new
              tokens): K4 once a shared-block application (6), K5 once an
              application and decode step (762), no other kernel (the
              Mamba2 layers are plain PyTorch, as in `repro`); two
              generates bit-equal; rates, time to first token, peak
              memory, busy share; then the consistency leg with f32 weights
              and activations: relative L2 < 1e-3, the greedy token on
              every row
  7g. whisper (after 7f) whisper-base at full width and depth (6 + 6
              layers, 8 heads of 64), bf16, random weights from seed 0, 1500
              stub frames a row from seed 5: 89,569,792 parameters
              (`repro`'s count); prefill(64) + decode(token 65) against
              prefill(65), gated as phase 7; ``Engine.generate`` (batch 8,
              64-token prompts, 384 new tokens: Whisper's 448-token text
              context), every launch counter set to 0 just before and read
              just after: K4 18 (6 encoder, 6 self, 6 cross prefill), K5 12
              a decode step (self and cross: 4,596), no other kernel; two
              generates bit-equal, the second splitting K4's and K5's
              launches by shape; rates, time to first token, peak memory,
              the device busy share over decode steps
  7h. internvl (after 7g) internvl2-1b at full width and depth (24
              layers, 14 q / 2 KV heads of 64), 256 stub patches a row
              before 768-token prompts (a cache of 1,152 rows): 493,780,992
              parameters; gated and served as 7g: K4 24, K5 3,048
  7i. cohere (after 7h) command-r-plus-104b at full width (d 12288, 96 q
              / 8 KV heads of 128, d_ff 33792, vocab 256000), its depth cut
              from 64 to 8 layers (64 take 207.6 GB in bf16):
              15,728,750,592 parameters at 8 layers, 103,809,822,720 at 64
              (from one layer's count), both `repro`'s; batch 8, 1024-token
              prompts, 128 new tokens, gated and served as 7g: K4 8, K5
              1,016
  7k. dryrun (after 7i) the dry run (`repro_torch.launch.dryrun`, meta
              tensors on the CPU) of tinyllama-1.1b's prefill_32k and
              decode_32k on the production single-pod mesh and, at the
              card's batch, on the one-rank host mesh; then tinyllama-1.1b
              at full width and depth, bf16, random weights from seed 0:
              (a) one prefill step of 32,768 tokens at batch 1 (K4 22),
              (a') the same under the host mesh's ``bf16_silu`` (K4 22 and
              F1, the fused bf16 SwiGLU, 22; its logits' relative L2
              against (a)'s printed, its peak held to the dry run's
              ``bf16_silu`` host row, its step time beside (a)'s),
              (b) a prefill of 32,760 tokens at batch 8 into a 32,768-row
              cache (5.9 GB), then 4 decode steps (K4 22, K5 88), every
              launch counter set to 0 just before each leg and read just
              after, the logits finite; each leg's peak memory within 1.25x
              of the host row's argument + output + temp bytes either way,
              its step time printed beside the row's roofline bound; then
              K4 at S 32,768 against its plain version in query blocks of
              1,024 and K5 at kv_len 32,764 (on the leg's cache) against
              its plain version, each row within 1e-2 of its norm and
              within ATTN_TOL["bfloat16"], timed as in phase 13 beside SDPA;
              F1 at [32768, 5632] bf16 against its plain chain (bit-equal,
              or each differing element within one bf16 ulp), timed beside
              the chain and the default f32 SwiGLU, with its bound
 8. graph    the paper's WIKI graph at full size (1.79M vertices), built on
              the host (by a worker process started before phase 2,
              overlapping phases 2-7, which then coarsens it for phase 11d
              while phases 9-17 and 11c run) and laid out on the card in 8
              blocks
  9. kernels  each partitioner kernel against its plain PyTorch version on
              the card, at the main path's shapes (K1 bit-exact in both
              weight modes, two calls bit-equal; K2 at atol 5e-6 / rtol
              5e-5 on random weights and on the input a self_lambda
              superstep gives it, two calls bit-equal), then timed eager,
              as the main path calls them (median of 30 launches after
              warm-up, CUDA events, L2 flushed before each), and as a
              CUDA-graph replay (``graph_ms``, as in phase 13); K2 also by
              its device time under torch.profiler, on both inputs
 10. main     ``run_partitioner("revolver", WIKI, k=8, seed=0)`` on the card,
              with every launch counter set to 0 just before and read just
              after; each partitioner kernel must have launched 8 times per
              superstep
 11. profile  a few supersteps under torch.profiler: device busy share and
              device time by kernel
 11a. rules   ``run_partitioner`` for spinner, restream, hash and range on
              the same layout, each with every launch counter set to 0 just
              before and read just after: K3's span kernel once per Spinner
              superstep and 8 times per restream superstep, its float route
              and every other kernel never, and none for
              the static baselines, whose labels must equal their closed
              forms; metrics recomputed on the host; then a few Spinner and
              restream supersteps profiled as in phase 11
 11b. histogram-kernel  K3 at Spinner's shape (all 8 blocks, one launch)
              and restream's (block 0), the span kernel in its slots and
              gather forms and the row walk, against the plain version on
              the card, two calls bit-equal, then timed as in phase 13 beside
              the ``labels[dst]`` gather the slots form needs first, with
              ``index_put_`` as the yardstick
 11c. stream  (run after phase 15, as 11d: the card idles through their
              host work, after which torch.profiler loses the kernel events
              of short windows, which phases 13 and 15 count)
              ``StreamRunner`` on phase 8's graph: Revolver over the
              first 3 of 8 insertion deltas (cut from all 8 for time) in
              random arrival order (k=8, 15 supersteps and patience 3 a
              delta, warm_sharpen 0.5), every launch counter set to 0 just
              before each delta and read just after (K1 and K2 8 times a
              superstep, nothing else); after the last insertion the
              incremental layout equals the batch layout of the graph the
              deltas make (each slab's live prefix, blk_row_ptr,
              blk_spans); then a delta deleting 1 % of its directed edges; local_edges > 0.5
              and max_norm_load <= 1.30 after both; then Spinner and
              restream over the first of those deltas each (K3 once a
              Spinner and 8 times a restream superstep, nothing else; the
              balance gate and local_edges > 1/k); per delta the merge
              seconds on the host, the refine seconds and supersteps/s
 11d. vcycle  ``run_partitioner("revolver", WIKI, k=8, mode="vcycle")``:
              level sizes, block counts, budgets and steps per level, the
              host worker's coarsening seconds (its stack answers the run's
              ``build_level_stack`` call, whose arguments are checked), and
              the run's wait for that stack, K1 and K2 once per block and
              superstep summed over the levels (nothing else), the same
              quality gates, beside phase 10's flat run; then, on the
              level stack that run coarsened, each level's largest weight
              and row weight sum printed, and K1 (every block, both weight
              modes) and K3's gather form (all blocks) on the layouts of
              level 1, a middle level and the coarsest, bit-equal to the
              plain versions (summed in f64 where a row sum passes 2^24),
              two calls bit-equal
 11e. stream-sharded  (after 11c, before 11d) ``StreamRunner`` over a
              mesh on phase 8's graph: phase 11c's stream settings on phase
              17h's layout (32 blocks on ``BlocksMesh([cuda:0] * 8)``,
              ``chunk_schedule="halo"``, the per-vertex plan with fallback
              off, hubs at outdegree quantile 0.95) over the first 2 of
              phase 11c's deltas (a cold start and a re-pad; cut from 8 for
              time), every launch counter set to 0 just before each delta
              and read just after (K1 and K2 32 times a superstep, H1 once,
              nothing else); each delta's local_edges >= 0.90x phase 11c's
              at the same delta, max_norm_load <= 1.30 after the last
              (where 11c gates; 8 shards' Jacobi moves overshoot within a
              delta's 15 supersteps, so earlier deltas are printed), the metrics
              recomputed on the host from the carried labels; per delta the
              merge, plan and refine seconds, the bytes uploaded, b_max,
              h_max, hub_pad, hub count, coverage, the exchange bytes a
              device and the floors that grew. Its side legs, at WIKI 0.1
              over the 8 insertion deltas and the 1 % deletion, run in four
              processes of their own (started after phase 2, beside phases
              3-7 and the other side legs, collected before phase 8): (a)
              a 1-shard halo stream equals the sequential one (labels after
              every delta, supersteps); (b) 8-shard async at staleness 0
              equals 8-shard halo with hubs, and at staleness 1 meets the
              main leg's gates against the sequential stream (balance
              after the last insertion and the deletion); (c)
              ``assignment="locality"`` decided once and kept, and an
              explicitly permuted stream, their carried labels' host
              metrics equal to the reported ones, quality >= 0.90x the
              contiguous stream; (d) the halo hub stream checkpointed after
              delta 3 and resumed in a new runner equals the uninterrupted
              one, floors and hub set restored; (e) Spinner (K3 once a
              shard) and restream (once a block) on the 8-shard halo
              stream, H1 once a superstep, the balance gate
 12. serve    ``Engine.generate`` on tinyllama-1.1b (batch 8, 1024-token
              prompts, 128 new tokens, greedy), with every launch counter set
              to 0 just before and read just after: K4 once per layer, K5
              once per layer and decode step; a second generate bit-equal
              (tokens and log-probabilities, as in phases 7d and 14); rates,
              time to first token,
              peak memory, and the device busy share over decode steps under
              torch.profiler (the host worker coarsens on another core
              meanwhile; it shares no interpreter lock with this process)
 13. attn-kernels  K4 and K5 at the serving shapes, and K4 at MLA's
              prefill shape ([8,16,1024,192] bf16 causal; its launches are
              phase 7d's), against their plain versions on the card (each
              output row within 1e-2 of its norm), then
              timed as in phase 9 but replayed from a CUDA graph (device
              time without the wrapper's host time; the eager time is
              printed beside), with ``scaled_dot_product_attention`` as the
              yardstick; K4's achieved TFLOP/s; two K4 calls (at D 64 and
              at 192) and two K5 calls bit-equal, and K5 replayed 3 times
              from one CUDA graph equal to K5 eager; the device kernels per
              K5 call (1), counted as the kernel nodes of a captured call,
              and K5's own the only kernel name under torch.profiler; then K4 and K5 at the wide
              heads' serving shapes (zamba2-7b: [8,32,1024,224] causal and
              its decode against 1024 of 1152 positions; h2o-danube-3-4b:
              q [4,32,4608,120] kv [4,8,4608,120] window 4096, and its
              wrapped 4096-slot ring, group 4), against their plain
              versions, two calls bit-equal, timed the same way beside
              their bounds, the plain versions and SDPA (a boolean window
              or kv_len mask); their launches are phases 7e's and 7f's;
              then K4 and K5 at the shapes of phases 7g-7i (whisper-base's
              encoder [8,8,1500,64] and cross prefill [8,8,64|1500,64]
              without a mask, its cross decode on the 1500-row cache, its
              causal self prefill [8,8,64,64] and self decode on the
              448-row cache at kv_len 256;
              internvl2-1b's group 7 and command-r-plus-104b's group 12 at
              D 128, prefill and decode) the same way, each with its
              launches at that shape in phases 7g-7i
 14. rwkv-serve  ``Engine.generate`` on rwkv6-3b at full width and depth,
              as phase 12: K6 once per layer in prefill and once per layer
              and decode step (32 x 128 = 4,096 launches), no other kernel
 15. rwkv-kernel  K6 at full width ([8,S,32,80]) at S = one chunk less one,
              one chunk and one more, then at the rwkv6-3b prefill shape
              [8,1024,32,80] and decode shape [8,1,32,80], against its plain
              version on the card, two calls bit-equal, the device kernels a
              call counted as the kernel nodes of a captured call (2 from
              one chunk on, 1 below, nothing else); all five timed as
              in phase 13 (no single PyTorch call computes the recurrence,
              so it has no yardstick)
 16. crash-safety  (after 15, before 11c/11d) tracing, checkpoints, resume
              and the state guard on Revolver's main path: a layout of
              phase 8's graph built anew; ``run_partitioner`` (k 8,
              sync_every 5) plain, then traced with ``Tracer()``,
              checkpointed every 10 supersteps and guarded
              (``guard="raise"``): labels and supersteps bit-equal, K1 and
              K2 8 times a superstep, the same blocking fetches (the
              runner's ``fetch`` calls) and synchronizing CUDA calls
              (torch's sync debug mode) as the plain run, the saved trace
              valid under ``tools/trace_report.py --validate`` (run as a
              program); both and a traced-only run timed in turns; a run
              cut at superstep 20 and resumed: resumed_from 20, bit-equal;
              ``nan@superstep=8`` under each guard policy (raise raises
              PartitionStateError, reinit ends in range and finite,
              rollback replays to the plain run's labels). Its legs off
              the full graph run while phase 8 waits for the host build: a
              SIGKILL and resume through the CLI at WIKI 0.01
              (``tools/torch_kill_resume_check.py``, exit -9, bit-equal);
              a Revolver stream of 8 deltas at WIKI 0.1 checkpointed every
              2, dropped after delta 4 and resumed in a new ``StreamRunner``:
              labels, probs and supersteps bit-equal to the uninterrupted
              stream. K2 keeps a NaN in its row as the plain version does
              (checked with K2 in phases 3 and 9)
 17. sharded-schedules  (after 16, before 11c/11d) the sharded, halo and
              async schedules on Revolver's main path: phase 8's graph in
              32 blocks, k 8, sync_every 5, on ``BlocksMesh([cuda:0] * 8)``
              (4 blocks a shard). A 1-shard sharded run equals the
              sequential one at 32 blocks (labels, probs, supersteps,
              history; every state field over a window on the engine);
              the 8-shard contiguous ``run_partitioner`` at the sequential
              run's step budget keeps >= 0.97 of its local edges and
              max_norm_load <= 1.30, K1 and K2 launched 32 times a
              superstep; halo (fallback off) equals sharded after every
              window of 10 supersteps on the contiguous and locality
              assignments at block and vertex granularity (the locality
              order keeps the striping on WIKI); async at staleness 0
              equals halo on the interior-first layout; K1 (both weight
              modes) and K3's gather form equal their plain versions on
              shard 3's halo slabs; halo and async (staleness 1) checkpointed every
              10, cut at 20 and resumed equal the uncut runs, the async
              trace valid under ``tools/trace_report.py --validate``.
              Rates, plan and layout build seconds, the exchange's bytes
              and peak memory printed. Its small legs run in the host
              build's wait: a halo and an async superstep on the card equal
              the CPU's with replayed draws (WIKI 0.002, 4 shards), and
              Spinner and restream at WIKI 0.1 on 8 shards, halo equal to
              sharded with K3 8 times a Spinner superstep and once a
              restream block, and K1/K3 on shard 3 of a block-permuted
              halo layout at WIKI 0.1
 17h. hub-schedules  (after 17) hub replication on Revolver's main path:
              phase 17's cell with hubs at outdegree quantile 0.95 (the
              8-shard per-vertex halo plan and the 1-shard plan built by
              the host worker while phases 9-17 run): a 1-shard halo hub
              run equals the sequential hub oracle (every state field over
              2 windows of 5); 8 shards under halo, then async at
              staleness 1, through ``run_partitioner`` at phase 17's
              sequential step budget keep >= 0.90 of its 8-shard sharded
              run's local edges with max_norm_load <= 1.30, K1 and K2 32
              times and H1 (the hub reconcile kernel) once a superstep;
              H1 against its plain version at the state of 10 hub
              supersteps (winners and loads bit-equal, two calls
              bit-equal, its body and rounds those of its schedule on the
              host), then timed as in phase 9 beside its bound (the bytes
              it must move; the one-thread walk's chain of shared-memory
              round trips printed beside it), with its slot, flagged and
              round counts; a checkpoint written by
              the 8-shard hub run at superstep 20 restored onto 4 shards
              and onto 1, bit-equal there (elastic restore). Hub count,
              the vote traffic, the exchange bytes, rates and peak memory
              printed. Its legs off the full graph run in the host
              build's wait: H1 on a synthetic 90,000-slot table (ties,
              slots without votes, pad slots, refused moves) and on
              tables that refuse nothing or everything, hold loads past
              2^24 (its serial body), have k 2 or 64, one slot or no
              flagged slot, each as the mid-run state is checked; and the
              V-cycle at WIKI 0.1, sequential and with its finest level on
              8 shards under halo with hubs, quality side by side

Each model phase starts after the previous model is deleted and the
allocator's cache emptied, with the peak memory statistics reset.

The lines before the last are one JSON object per phase result, the
script's wall time, the ``{"kernels": [...]}`` summary and the nvidia-smi
line; the last line is
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import collections
import dataclasses
import gc
import io
import itertools
import json
import os
import pathlib
import pickle
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

K = 8
N_BLOCKS = 8
SEED = 0
SHARDS = 8                    # phase 17: shards on the one card
SHARD_BLOCKS = 32             # phase 17: 4 blocks a shard
HUB_QUANTILE = 0.95           # phase 17h: hubs at or above this outdegree quantile
# the one-thread walk's bound (H1 before its redesign), printed beside
# H1's: one dependent shared-memory load per flagged slot, ~30 cycles on
# Hopper (published microbenchmarks of the H100/H800 measure 29-33 cycles),
# at the card's maximum SM clock (nvidia-smi)
SMEM_ROUND_TRIP_CYCLES = 30
HBM_BYTES_PER_S = 3.35e12     # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12             # H100 SXM f32 outside the tensor cores
BF16_FLOPS = 989e12           # H100 SXM dense bf16 tensor-core peak
K2_TOL = dict(atol=5e-6, rtol=5e-5)
PROFILE_PAD_S = 0.2           # idle time around a short profiled window
PROFILE_TRIES = 3             # windows tried while one records no device event
PARTITIONER_KERNELS = ("fused_edge_phase", "la_update")
# K3 against its plain version on random float values: both sum a row's
# entries in f32, in other orders, so up to one rounding per entry
K3_FLOAT_ATOL = 1e-5
# attention kernels against their plain versions: in f32 the two differ in
# summation order and fma contraction only (each is ~1e-6 from the exact
# result), but one run saw the CPU plain version 7.3e-5 off the card's, so
# f32 takes 1e-4, and the f32 kernel is also held to an f64 reference at
# 5e-5; in bf16 the output is rounded to bf16 from f32 values that differ
# that little, so by at most one bf16 ulp
ATTN_TOL = {"float32": dict(atol=1e-4, rtol=1e-4),
            "bfloat16": dict(atol=2e-2, rtol=1e-2)}
# K4 and K5 at the serving shapes (phase 13), bf16: there the outputs are
# small (|o| ~ 1/sqrt(keys) for N(0,1) inputs, a mean of 0.021 at 4096 keys)
# and ATTN_TOL's atol would pass an error as large as a typical value. So
# each output row (one query and head, over D) is held to its own norm. The
# kernels round P and o to bf16 (2^-9 relative, random in sign), which a
# CPU emulation of their bodies puts at 2e-3 of a row, 4e-3 at most (on the
# card, 3.1e-3 to 5.1e-3 at the worst row of each of the seven serving
# shapes); a tile of keys dropped or weighted wrong moves its rows by percents
SERVE_ROW_REL_TOL = 1e-2
EXACT_TOL = dict(atol=5e-5, rtol=5e-5)
# reduced GQA tinyllama, f32, card (kernels, cuBLAS) against CPU (plain
# versions): summation order through 2 layers and 8 decode steps
LM_TOL = dict(atol=1e-4, rtol=1e-4)
# tinyllama-1.1b in bf16: prefill(1024) + decode against prefill(1025) take
# different kernels and GEMM shapes; each rounds to bf16 (2^-9 relative) at
# ~10 points per layer over 22 layers, ~3 % relative error in a random walk
FULL_REL_TOL = 5e-2
# rwkv6-3b with f32 weights and activations (TF32 off), same comparison:
# only summation order differs (~1e-5 relative through 32 layers), so the
# greedy token is decided on every row; in bf16 a near-tie between two of
# 65,536 random-weight logits flips within the rounding noise
FULL_F32_REL_TOL = 1e-3
# K6 against its plain version in f32: the kernel fuses multiply-adds and
# sums y in four partial sums; the bound the JAX package holds its own
# kernel to (tests/test_kernels.py), over up to 1024 decayed outer products
WKV_TOL = dict(atol=2e-4, rtol=2e-4)
GQA = dict(n_heads=8, n_kv=2, d_model=128)
SERVE = dict(batch=8, prompt=1024, new=128, s_max=1152)
# h2o-danube-3-4b (phase 7e): prompts past its 4096-token window, so the
# ring buffer wraps in prefill
H2O_SERVE = dict(batch=4, prompt=4608, new=128, s_max=4736)
DEEPSEEK = "deepseek-v2-lite-16b"
# `repro`'s parameter count of deepseek-v2-lite-16b: the leaves of
# ``repro.models.init_lm(cfg, key)`` under ``jax.eval_shape``, summed
# (counted on the CPU; the port's model has the same leaves)
DEEPSEEK_LITE_PARAMS = 15_706_484_224
H2O = "h2o-danube-3-4b"
ZAMBA = "zamba2-7b"
# `repro`'s parameter counts of h2o-danube-3-4b and zamba2-7b, counted as
# DEEPSEEK_LITE_PARAMS
H2O_PARAMS = 3_961_839_360
ZAMBA_PARAMS = 6_142_959_936
# phase 7f's depth: 4 of zamba2-7b's 13 groups (and its 3 trailing Mamba2
# layers), cut so that the phases after it fit the script's time limit
ZAMBA_GROUPS = 4
# phases 7g-7i: whisper-base (64-token decoder prompts against 1500 stub
# frames, 384 new tokens: 448 = Whisper's text context), internvl2-1b (256
# stub patches before 768-token prompts: a cache of 1,152 rows) and
# command-r-plus-104b at full width cut to 8 of its 64 layers (64 take
# 207.6 GB in bf16, more than one card); `repro`'s parameter counts,
# counted as DEEPSEEK_LITE_PARAMS
WHISPER = "whisper-base"
WHISPER_SERVE = dict(batch=8, prompt=64, new=384, s_max=448)
WHISPER_PARAMS = 89_569_792
INTERNVL = "internvl2-1b"
INTERNVL_SERVE = dict(batch=8, prompt=768, new=128, s_max=1152)
INTERNVL_PARAMS = 493_780_992
COHERE = "command-r-plus-104b"
COHERE_LAYERS = 8
COHERE_PARAMS = 15_728_750_592          # at 8 layers
COHERE_FULL_PARAMS = 103_809_822_720    # at its 64
# the train phase: reduced legs of every arch, f32 (TF32 off), card against
# the CPU; then tinyllama-1.1b at full width and depth through the CLI
# phase 11c: Revolver streams the first 3 of WIKI's 8 insertion deltas, then
# the deleting delta (cut from all 8 for time: deltas 5-8 ran 4-8
# supersteps each behind 16-22 s host merges on an H100 host; the 4th, 18 s
# of merging, cut when phase 7k's bf16_silu leg came)
STREAM_INSERTS = 3
TRAIN_LOSS_RTOL = 1e-5        # card vs CPU loss
TRAIN_LEAF_TOL = 1e-4         # each gradient leaf within this of its L2 norm
TRAIN_ZERO_TOL = 1e-6         # a leaf zero up to rounding: below this x the global norm
TRAIN_MB_RTOL = 1e-5          # microbatch 2 against 1: loss and grad norm
TRAIN_FULL = dict(arch="tinyllama-1.1b", batch=8, seq=512, steps=4, lr=1e-3)
TRAIN_SERVE = dict(batch=8, prompt=1024, new=16)
# phase 7k: tinyllama-1.1b at the dry run's prefill_32k (batch 1) and
# decode_32k (batch 8: a prefill of seq - decode_headroom tokens, then
# decode_steps decode steps into a seq-row cache); the dry run's bytes
# against the card's peak within DRYRUN_MEM_FACTOR either way; K4's plain
# version at S 32,768 in query blocks of DRYRUN_PLAIN_BLOCK rows ([1,4,8,
# 1024,32768] f32 scores, 4.3 GB, at the last)
DRYRUN = dict(seq=32_768, prefill_batch=1, decode_batch=8, decode_headroom=8, decode_steps=4)
DRYRUN_MEM_FACTOR = 1.25
DRYRUN_PLAIN_BLOCK = 1024
# phase 7j: deepseek-v2-lite-16b's 64 experts placed on 8 expert-parallel
# ranks of the card (Revolver, up to PLACE_STEPS supersteps a layer); the
# expert-parallel generate's peak may exceed 7d's by EP_PEAK_SLACK bytes
# (its shards are views; the ranks' transient buffers and the psum's f64
# partials are the rest); EP2D runs batch 8 x EP2D_TOKENS through one layer
EP_RANKS = 8
PLACE_STEPS = 120
SYNTH_EXPERTS = 64            # examples/expert_placement_torch.py's clustered routing
EP_PEAK_SLACK = 4 * 10**9
# each expert-parallel MoE layer against the local path on the same input:
# sound ~0.0035 on an H100 (PERF.md); one rank's routed partial or shared-expert share
# left out of the psum reads that piece's size (`rank_piece_sizes`)
EP_LAYER_REL_TOL = 1e-2
EP2D_TOKENS = 512
EP_NEW = 16                   # the timed expert-parallel generate's new tokens (32 until
#                               phase 7k's bf16_silu leg came)
EP_REPEAT_NEW = 16            # the second expert-parallel generate's new tokens
SHARDED_DECODE_SHARDS = 4
EF_RANKS = 4
# the golden-worker graph of the JAX package's tests
PARITY_GRAPH = dict(n=1024, m=8192, n_comm=16, mixing=0.25,
                    degree_exponent=0.5, seed=3)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, flush, reps: int = 30, warmup: int = 3) -> float:
    """Median device time of one ``fn()`` call, CUDA events around each call,
    the 50 MB L2 flushed before every call."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    return times[len(times) // 2]


def graph_ms(torch, fn, flush, reps: int = 30) -> float:
    """Median device time of one ``fn()`` call, L2 flushed before each:
    the call is captured once in a CUDA graph and replayed between CUDA
    events, so the host time of the Python wrapper is not counted (at
    decode sizes it is longer than the kernels)."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return time_ms(torch, graph.replay, flush, reps)


def check_k1_small(torch, np, seed: int) -> int:
    """K1 on small padded slabs with odd k against the CPU plain version,
    before anything large is built: under the default span plan and under
    one of 16-entry, 4-row spans (hub rows cut into pieces, rows cut by the
    row cap). Returns the number of cases."""
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.graphs.blocking import slab_row_ptr
    from repro_torch.kernels import edge_phase

    rng = np.random.default_rng(seed)
    cases = 0
    for nb, e_max, sbv, k in ((3, 512, 128, 5), (1, 256, 64, 3), (2, 1024, 256, 33),
                              (2, 4096, 64, 64)):
        dst = np.zeros((nb, e_max), np.int32)
        rows = np.zeros((nb, e_max), np.int32)
        vals = np.zeros((nb, e_max), np.float32)
        for b in range(nb):
            cnt = int(rng.integers(e_max // 2, e_max))
            rows[b, :cnt] = np.sort(rng.integers(0, sbv, cnt))
            dst[b, :cnt] = rng.integers(0, nb * sbv, cnt)
            vals[b, :cnt] = rng.integers(1, 3, cnt)
        host = [dst, rows, vals,
                rng.integers(0, k, nb * sbv).astype(np.int32),
                rng.integers(0, k, nb * sbv).astype(np.int32),
                rng.integers(0, k, (nb, sbv)).astype(np.int32),
                (rng.random((nb, k)) > 0.3).astype(np.float32)]
        cpu = [torch.from_numpy(a) for a in host]
        cuda = [t.cuda() for t in cpu]
        host_ptr = slab_row_ptr(rows, vals, sbv)
        row_ptr = torch.from_numpy(host_ptr).cuda()
        plans = (SpanPlan.from_row_ptr(host_ptr, "cuda"),
                 SpanPlan.from_row_ptr(host_ptr, "cuda", span_edges=16, row_cap=4))
        for plan, mode in itertools.product(plans, ("self_lambda", "neighbor_lambda")):
            got = edge_phase.fused_edge_phase_cuda(
                cuda[0], cuda[2], row_ptr, plan, *cuda[3:], block_v=sbv, k=k,
                weight_mode=mode)
            want = edge_phase.fused_edge_phase_plain(*cpu, block_v=sbv, k=k,
                                                     weight_mode=mode)
            for a, b in zip(got, want):
                require(torch.equal(a.cpu(), b),
                        f"K1 {mode} k={k} spans of {plan.span_edges} slab differs "
                        "from the CPU plain version")
            cases += 1
    return cases


def check_k1_hub(torch, np, seed: int) -> dict:
    """K1 on a synthetic slab whose row 1000 holds 1,048,589 entries (cut
    into 513 pieces by the default plan) among rows of 0-40, k = 8, both
    weight modes: bit-equal to the plain version on the card, two calls
    bit-equal."""
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.graphs.blocking import slab_row_ptr
    from repro_torch.kernels import edge_phase

    rng = np.random.default_rng(seed)
    bv, hub = 4096, 1_048_589
    deg = rng.integers(0, 41, bv)
    deg[1000] = hub
    e_max = -(-(int(deg.sum()) + 100) // 256) * 256
    rows = np.zeros((1, e_max), np.int32)
    dst = np.zeros((1, e_max), np.int32)
    vals = np.zeros((1, e_max), np.float32)
    cnt = int(deg.sum())
    rows[0, :cnt] = np.repeat(np.arange(bv), deg)
    dst[0, :cnt] = rng.integers(0, bv, cnt)
    vals[0, :cnt] = rng.integers(1, 3, cnt)
    host_ptr = slab_row_ptr(rows, vals, bv)
    plan = SpanPlan.from_row_ptr(host_ptr, "cuda")
    pieces = plan.hubs[0, :, 2].tolist()
    require(max(pieces) * plan.span_edges >= hub, f"hub row not cut into pieces: {pieces}")
    t = [torch.from_numpy(a).cuda() for a in (dst, rows, vals)]
    labels, lam = (torch.from_numpy(rng.integers(0, K, bv).astype(np.int32)).cuda()
                   for _ in range(2))
    actions = torch.from_numpy(rng.integers(0, K, (1, bv)).astype(np.int32)).cuda()
    feasible = torch.from_numpy((rng.random((1, K)) > 0.3).astype(np.float32)).cuda()
    row_ptr = torch.from_numpy(host_ptr).cuda()
    for mode in ("self_lambda", "neighbor_lambda"):
        call = lambda: edge_phase.fused_edge_phase_cuda(  # noqa: E731
            t[0], t[2], row_ptr, plan, labels, lam, actions, feasible, block_v=bv, k=K,
            weight_mode=mode)
        got, again = call(), call()
        want = edge_phase.fused_edge_phase_plain(t[0], t[1], t[2], labels, lam, actions,
                                                 feasible, block_v=bv, k=K, weight_mode=mode)
        torch.cuda.synchronize()
        for a, b, c, name in zip(got, again, want, ("hist", "w_acc")):
            require(torch.equal(a, c), f"K1 {mode} {name} differs from plain on the hub slab")
            require(torch.equal(a, b), f"K1 {mode} {name}: two calls differ on the hub slab")
    return {"hub_entries": hub, "hub_pieces": max(pieces), "slab_entries": cnt}


def check_k1_block(torch, dg, seed: int):
    """K1 against its plain version at the main path's per-block shape (block
    0 of the layout, nb=1), both weight modes; returns the inputs."""
    from repro_torch.kernels import edge_phase

    dev = dg.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    bv = dg.block_v
    labels = torch.randint(0, K, (dg.n_pad,), generator=gen, device=dev, dtype=torch.int32)
    lam = torch.randint(0, K, (dg.n_pad,), generator=gen, device=dev, dtype=torch.int32)
    actions = torch.randint(0, K, (1, bv), generator=gen, device=dev, dtype=torch.int32)
    feasible = (torch.rand((1, K), generator=gen, device=dev) > 0.3).float()
    args = (dg.blk_dst[:1], dg.blk_row[:1], dg.blk_w[:1], labels, lam, actions, feasible)
    for mode in ("self_lambda", "neighbor_lambda"):
        call = lambda: edge_phase.fused_edge_phase_cuda(  # noqa: E731
            dg.blk_dst[:1], dg.blk_w[:1], dg.blk_row_ptr[:1], dg.blk_spans.block(0),
            labels, lam, actions, feasible, block_v=bv, k=K, weight_mode=mode)
        got, again = call(), call()
        want = edge_phase.fused_edge_phase_plain(*args, block_v=bv, k=K, weight_mode=mode)
        torch.cuda.synchronize()
        for a, b, c, name in zip(got, want, again, ("hist", "w_acc")):
            require(torch.equal(a, b), f"K1 {mode} {name} differs from plain at full block")
            require(torch.equal(a, c), f"K1 {mode} {name}: two calls differ at full block")
    live = int((dg.blk_w[0] > 0).sum())
    return args, labels, lam, actions, feasible, live


def check_contracted_weights(torch, np, seed: int) -> dict:
    """K1 in both weight modes and K3's span kernel in its gather form on
    small slabs whose integer weights reach 10^4 (synthetic; phase 11d
    holds both on the layouts of WIKI's contracted levels), under the
    default span plan and one of 16-entry,
    4-row spans (hub rows in pieces): bit-equal to the plain versions on
    the CPU, two calls bit-equal. The layout's weight check passes first."""
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.graphs.blocking import check_integer_weights, slab_row_ptr
    from repro_torch.kernels import edge_histogram as k3
    from repro_torch.kernels import edge_phase

    rng = np.random.default_rng(seed)
    cases = 0
    for nb, e_max, bv, k in ((2, 4096, 128, 8), (3, 2048, 64, 5), (1, 8192, 256, 33)):
        dst = np.zeros((nb, e_max), np.int32)
        rows = np.zeros((nb, e_max), np.int32)
        vals = np.zeros((nb, e_max), np.float32)
        for b in range(nb):
            deg = rng.multinomial(int(rng.integers(e_max // 2, e_max - 64)),
                                  np.full(bv, 1 / bv))
            deg[bv // 3] += 64                  # a row past 16 entries
            cnt = int(deg.sum())
            rows[b, :cnt] = np.repeat(np.arange(bv), deg)
            dst[b, :cnt] = rng.integers(0, nb * bv, cnt)
            vals[b, :cnt] = rng.integers(1, 10_001, cnt)
        host_ptr = slab_row_ptr(rows, vals, bv)
        check_integer_weights(vals, host_ptr)
        labels, lam = (rng.integers(0, k, nb * bv).astype(np.int32) for _ in range(2))
        actions = rng.integers(0, k, (nb, bv)).astype(np.int32)
        feasible = (rng.random((nb, k)) > 0.3).astype(np.float32)
        cpu = [torch.from_numpy(a) for a in (dst, rows, vals, labels, lam, actions, feasible)]
        cuda = [t.cuda() for t in cpu]
        row_ptr = torch.from_numpy(host_ptr).cuda()
        for plan in (SpanPlan.from_row_ptr(host_ptr, "cuda"),
                     SpanPlan.from_row_ptr(host_ptr, "cuda", span_edges=16, row_cap=4)):
            for mode in ("self_lambda", "neighbor_lambda"):
                call = lambda: edge_phase.fused_edge_phase_cuda(  # noqa: E731
                    cuda[0], cuda[2], row_ptr, plan, *cuda[3:], block_v=bv, k=k,
                    weight_mode=mode)
                got, again = call(), call()
                want = edge_phase.fused_edge_phase_plain(*cpu, block_v=bv, k=k,
                                                         weight_mode=mode)
                torch.cuda.synchronize()
                for a, b, c in zip(got, again, want):
                    require(torch.equal(a.cpu(), c), f"K1 {mode} k={k} on weights up to "
                            f"10^4 (spans of {plan.span_edges}) differs from plain")
                    require(torch.equal(a, b), f"K1 {mode} k={k} on weights up to 10^4: "
                            "two calls differ")
                cases += 1
            call = lambda: k3.edge_histogram_spans_cuda(  # noqa: E731
                cuda[0], cuda[2], row_ptr, plan, block_v=bv, k=k, labels=cuda[3])
            got, again = call(), call()
            want = k3.edge_histogram_plain(cpu[3][cpu[0].long()], cpu[1], cpu[2],
                                           block_v=bv, k=k)
            torch.cuda.synchronize()
            require(torch.equal(got.cpu(), want), f"K3 gather form k={k} on weights up to "
                    f"10^4 (spans of {plan.span_edges}) differs from plain")
            require(torch.equal(got, again), f"K3 gather form k={k} on weights up to 10^4: "
                    "two calls differ")
            cases += 1
    return {"contracted_weight_cases": cases, "max_weight": 10_000}


def k2_agrees(torch, p, w, r, what: str) -> float:
    """K2 on the card against its plain version on the card and on the CPU,
    at K2_TOL; returns the max abs error against the card's plain version."""
    from repro_torch.kernels import la_update

    got = la_update.la_update_cuda(p, w, r, 1.0, 0.1)
    again = la_update.la_update_cuda(p, w, r, 1.0, 0.1)
    want = la_update.la_update_plain(p, w, r, 1.0, 0.1)
    want_cpu = la_update.la_update_plain(p.cpu(), w.cpu(), r.cpu(), 1.0, 0.1)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    require(torch.equal(got, again), f"K2 {what}: two calls differ")
    require(torch.allclose(got, want, **K2_TOL),
            f"K2 {what} differs from plain on the card: max abs err {err}")
    require(torch.allclose(got.cpu(), want_cpu, **K2_TOL),
            f"K2 {what} differs from plain on the CPU")
    return err


def check_k2(torch, dev, v: int, k: int, seed: int):
    """K2 against its plain version on dense random [v, k] inputs, and on
    the same with a NaN in row 0; returns the inputs and the error."""
    from repro_torch.core.la import split_weights_and_signals
    from repro_torch.kernels import la_update

    gen = torch.Generator(device=dev).manual_seed(seed)
    p = torch.rand((v, k), generator=gen, device=dev) + 0.01
    p = p / p.sum(-1, keepdim=True)
    w_raw = torch.randint(0, 6, (v, k), generator=gen, device=dev).float()
    w, r = split_weights_and_signals(w_raw)
    err = k2_agrees(torch, p, w, r, f"[{v},{k}] random")
    # a NaN stays in its row, as in the plain version: the state guard
    # finds a corrupt row by it
    p_nan = p.clone()
    p_nan[0, 0] = float("nan")
    got = torch.isnan(la_update.la_update_cuda(p_nan, w, r, 1.0, 0.1))
    want = torch.isnan(la_update.la_update_plain(p_nan, w, r, 1.0, 0.1))
    require(torch.equal(got, want) and bool(got[0].all()) and not bool(got[1:].any()),
            f"K2 [{v},{k}]: a NaN in row 0 gives NaNs at {got.nonzero().tolist()[:8]}, "
            f"the plain version at {want.nonzero().tolist()[:8]}")
    return (p, w, r), err


def capture_k2_inputs(torch, dg, steps: int = 2):
    """The probs, w_norm and r the Revolver rule (self_lambda, k = K) gives
    K2 for block 0 in superstep ``steps`` of a run from seed SEED on ``dg``
    (`ops.la_update` wrapped for the run, that call's inputs copied)."""
    from repro_torch.core import revolver
    from repro_torch.kernels import ops

    cfg = revolver.RevolverConfig(k=K)
    state = revolver.revolver_init(dg, cfg, revolver.make_generator(SEED, dg.device))
    real, seen = ops.la_update, []

    def spy(probs, weights, signals, *args, **kwargs):
        if len(seen) == (steps - 1) * dg.n_blocks:
            seen.append((probs.clone(), weights.clone(), signals.clone()))
        else:
            seen.append(None)
        return real(probs, weights, signals, *args, **kwargs)

    ops.la_update = spy
    try:
        for _ in range(steps):
            state = revolver.revolver_superstep(dg, cfg, state)
    finally:
        ops.la_update = real
    require(cfg.weight_mode == "self_lambda" and len(seen) == steps * dg.n_blocks,
            f"captured {len(seen)} K2 calls in {steps} self_lambda supersteps")
    return seen[(steps - 1) * dg.n_blocks]


def k2_timed(torch, p, w, r, flush) -> dict:
    """K2 on one input: eager (CUDA events around the wrapper call, as the
    Revolver rule calls it), replayed from a CUDA graph, and its device time
    under torch.profiler, beside its bound and the plain version."""
    from repro_torch.kernels import la_update

    v, k = p.shape
    fn = lambda: la_update.la_update_cuda(p, w, r, 1.0, 0.1)  # noqa: E731
    active = int((w > 0).sum())
    nbytes = 4 * v * k * 4
    # a pass on a row is k updates of ~4 operations, then the renorm
    bound_ms, bound_by = bound(nbytes, active * k * 4 + v * k * 2, F32_FLOPS)
    return {"ms": time_ms(torch, fn, flush), "graph_ms": graph_ms(torch, fn, flush),
            "device_ms": sum(device_ms_by_kernel(torch, fn).values()),
            "plain_ms": time_ms(torch, lambda: la_update.la_update_plain(p, w, r, 1.0, 0.1),
                                flush),
            "bound_ms": bound_ms, "bound_by": bound_by, "active_slots": active,
            "rows_with_a_pass": int((w > 0).any(-1).sum())}


def parity_phase(torch, np):
    """3 supersteps with the kernels on the card against 3 with the plain
    versions on the CPU, from one state and one set of draws."""
    from repro_torch.core.convert import revolver_state_from_numpy
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.core.revolver import (
        RevolverConfig,
        make_generator,
        revolver_init,
        revolver_superstep,
    )
    from repro_torch.graphs.generators import dc_sbm

    g = dc_sbm(**PARITY_GRAPH)
    k, steps = 4, 3
    dg_cpu = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cpu")
    dg_gpu = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cuda")
    rng = np.random.default_rng(7)
    shape = (steps, dg_cpu.n_blocks, dg_cpu.block_v)
    u = np.maximum(rng.random(shape + (k,)), np.finfo(np.float32).tiny)
    gumbel = (-np.log(-np.log(u))).astype(np.float32)
    uniform = rng.random(shape).astype(np.float32)
    draws = lambda step, blk: (gumbel[step, blk], uniform[step, blk])  # noqa: E731
    for mode in ("self_lambda", "neighbor_lambda"):
        cfg = RevolverConfig(k=k, weight_mode=mode)
        st_cpu = revolver_init(dg_cpu, cfg, make_generator(7, "cpu"))
        # copies: the CPU state's tensors are updated in place
        arrays = {f: getattr(st_cpu, f).numpy().copy()
                  for f in ("labels", "lam", "probs", "loads", "score")}
        st_gpu = revolver_state_from_numpy(dict(arrays, step=0), "cuda", seed=7)
        for step in range(steps):
            st_cpu = revolver_superstep(dg_cpu, cfg, st_cpu, draws=draws)
            st_gpu = revolver_superstep(dg_gpu, cfg, st_gpu, draws=draws)
            for name in ("labels", "lam", "loads", "score"):
                require(torch.equal(getattr(st_gpu, name).cpu(), getattr(st_cpu, name)),
                        f"parity {mode}: {name} differs after superstep {step}")
            require(torch.allclose(st_gpu.probs.cpu(), st_cpu.probs, **K2_TOL),
                    f"parity {mode}: probs differ after superstep {step}")
        moved = int((st_gpu.labels.cpu() != torch.from_numpy(arrays["labels"])).sum())
        require(moved > 0, f"parity {mode}: no vertex migrated")
    return steps


def k3_slab(rng, np, nb: int, e_max: int, bv: int, k: int, integer: bool):
    """Row-sorted slabs with a zero-valued padded tail, every other row
    empty: slots, rows, values."""
    slots = np.zeros((nb, e_max), np.int32)
    rows = np.zeros((nb, e_max), np.int32)
    vals = np.zeros((nb, e_max), np.float32)
    for b in range(nb):
        cnt = int(rng.integers(e_max // 2, e_max))
        rows[b, :cnt] = np.sort(rng.integers(0, bv // 2, cnt) * 2)
        slots[b, :cnt] = rng.integers(0, k, cnt)
        vals[b, :cnt] = rng.integers(1, 3, cnt) if integer else rng.uniform(0.01, 2.0, cnt)
    return slots, rows, vals


def host_row_ptr(host, block_v: int):
    """`slab_row_ptr` of a (slots, rows, vals) slab triple."""
    from repro_torch.graphs.blocking import slab_row_ptr

    return slab_row_ptr(host[1], host[2], block_v)


def k3_span_forms(torch, k3, host, dst, labels, plan, *, block_v: int, k: int, what: str):
    """The K3 span kernel on the card in the slots form and the gather form
    (slots = labels[dst]) against the plain version on the CPU, bit for bit,
    each called twice (bit-equal)."""
    slots, rows, vals = (torch.from_numpy(a) for a in host)
    dst_t, labels_t = torch.from_numpy(dst), torch.from_numpy(labels)
    row_ptr = torch.from_numpy(host_row_ptr(host, block_v)).cuda()
    forms = {"slots": (slots.cuda(), None), "gather": (dst_t.cuda(), labels_t.cuda())}
    wants = {"slots": k3.edge_histogram_plain(slots, rows, vals, block_v=block_v, k=k),
             "gather": k3.edge_histogram_plain(labels_t[dst_t.long()], rows, vals,
                                               block_v=block_v, k=k)}
    for form, (idx, lab) in forms.items():
        call = lambda: k3.edge_histogram_spans_cuda(  # noqa: E731
            idx, vals.cuda(), row_ptr, plan, block_v=block_v, k=k, labels=lab)
        got, again = call(), call()
        torch.cuda.synchronize()
        require(torch.equal(got.cpu(), wants[form]),
                f"K3 {form} form {what} differs from the CPU plain version")
        require(torch.equal(got, again), f"K3 {form} form {what}: two calls differ")


def check_k3_small(torch, np, seed: int) -> dict:
    """K3 on small padded slabs (odd k up to 64, nb 1 and 3, every other row
    empty) against the CPU plain version: the span kernel in both forms
    under the layout's span plan and one of 16-entry, 4-row spans (rows
    past 16 entries cut into pieces), bit-exact on eq.-(4) weights, two
    calls bit-equal; the float route (the row walk) within K3_FLOAT_ATOL
    times the row's length on random float values."""
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.kernels import edge_histogram as k3

    rng = np.random.default_rng(seed)
    worst = 0.0
    cases = 0
    for nb, e_max, bv, k in ((1, 256, 64, 1), (3, 512, 128, 3), (1, 768, 32, 5),
                             (3, 1024, 64, 8), (1, 2048, 256, 13), (3, 512, 32, 13),
                             (3, 2048, 64, 33), (1, 4096, 128, 64)):
        host = k3_slab(rng, np, nb, e_max, bv, k, True)
        n_lab = 1000
        labels = rng.integers(0, k, n_lab).astype(np.int32)
        dst = np.where(host[2] > 0, rng.integers(0, n_lab, (nb, e_max)), 0).astype(np.int32)
        ptr = host_row_ptr(host, bv)
        for plan in (SpanPlan.from_row_ptr(ptr, "cuda"),
                     SpanPlan.from_row_ptr(ptr, "cuda", span_edges=16, row_cap=4)):
            k3_span_forms(torch, k3, host, dst, labels, plan, block_v=bv, k=k,
                          what=f"nb={nb} k={k} spans of {plan.span_edges}")
            cases += 2
        fl = k3_slab(rng, np, nb, e_max, bv, k, False)
        cpu = [torch.from_numpy(a) for a in fl]
        fl_ptr = host_row_ptr(fl, bv)
        got = k3.edge_histogram_cuda(cpu[0].cuda(), cpu[2].cuda(),
                                     torch.from_numpy(fl_ptr).cuda(), block_v=bv, k=k).cpu()
        want = k3.edge_histogram_plain(*cpu, block_v=bv, k=k)
        run = torch.from_numpy(np.diff(fl_ptr, axis=1).astype(np.float32))
        err = (got - want).abs()
        require(bool((err <= K3_FLOAT_ATOL * run[..., None].clamp_min(1)).all()),
                f"K3 float route nb={nb} k={k}: max abs err {float(err.max())}")
        worst = max(worst, float(err.max()))
        cases += 1
    return {"k3_cases": cases, "k3_float_max_abs_err": worst}


def check_k3_hub(torch, np, seed: int) -> dict:
    """The K3 span kernel, both forms, on a synthetic slab whose row 1000
    holds 1,048,589 entries (cut into 513 pieces by the default plan) among
    rows of 0-40, k = 8: bit-equal to the plain version, two calls
    bit-equal."""
    from repro_torch.core.device_graph import SpanPlan
    from repro_torch.kernels import edge_histogram as k3

    rng = np.random.default_rng(seed)
    bv, hub = 4096, 1_048_589
    deg = rng.integers(0, 41, bv)
    deg[1000] = hub
    cnt = int(deg.sum())
    e_max = -(-(cnt + 100) // 256) * 256
    slots, rows, dst = (np.zeros((1, e_max), np.int32) for _ in range(3))
    vals = np.zeros((1, e_max), np.float32)
    rows[0, :cnt] = np.repeat(np.arange(bv), deg)
    slots[0, :cnt] = rng.integers(0, K, cnt)
    dst[0, :cnt] = rng.integers(0, bv, cnt)
    vals[0, :cnt] = rng.integers(1, 3, cnt)
    labels = rng.integers(0, K, bv).astype(np.int32)
    host = (slots, rows, vals)
    plan = SpanPlan.from_row_ptr(host_row_ptr(host, bv), "cuda")
    pieces = plan.hubs[0, :, 2].tolist()
    require(max(pieces) * plan.span_edges >= hub, f"hub row not cut into pieces: {pieces}")
    k3_span_forms(torch, k3, host, dst, labels, plan, block_v=bv, k=K, what="hub slab")
    return {"hub_entries": hub, "hub_pieces": max(pieces), "slab_entries": cnt}


def rule_parity_phase(torch, np) -> dict:
    """3 supersteps of Spinner and of restream (ramp 3) with K3 on the card
    against 3 with its plain version on the CPU, from one state and one set
    of draws: labels, loads, score, and restream's spent budgets and ranks
    equal bit for bit."""
    from repro_torch.core import convert
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.core.restream import RestreamConfig, restream_init, restream_superstep
    from repro_torch.core.revolver import make_generator
    from repro_torch.core.spinner import SpinnerConfig, spinner_init, spinner_superstep
    from repro_torch.graphs.generators import dc_sbm

    g = dc_sbm(**PARITY_GRAPH)
    k, steps = 4, 3
    dg_cpu = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cpu")
    dg_gpu = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cuda")
    rng = np.random.default_rng(11)
    u_spin = rng.random((steps, dg_cpu.n_pad)).astype(np.float32)
    u_rest = rng.random((steps, dg_cpu.n_blocks, dg_cpu.block_v)).astype(np.float32)
    legs = (
        ("spinner", SpinnerConfig(k=k), spinner_init, spinner_superstep,
         convert.spinner_state_from_numpy, ("labels", "loads"), lambda s: u_spin[s]),
        ("restream", RestreamConfig(k=k, priority_ramp=3), restream_init,
         restream_superstep, convert.restream_state_from_numpy,
         ("labels", "loads", "used", "rank"), lambda s, b: u_rest[s, b]),
    )
    moved = {}
    for name, cfg, init, step_fn, from_numpy, fields, draws in legs:
        st_cpu = init(dg_cpu, cfg, make_generator(7, "cpu"))
        # copies: the CPU state's tensors are updated in place
        arrays = {f: getattr(st_cpu, f).numpy().copy() for f in fields + ("score",)}
        st_gpu = from_numpy(dict(arrays, step=0), "cuda", seed=7)
        for step in range(steps):
            st_cpu = step_fn(dg_cpu, cfg, st_cpu, draws=draws)
            st_gpu = step_fn(dg_gpu, cfg, st_gpu, draws=draws)
            for f in fields + ("score",):
                require(torch.equal(getattr(st_gpu, f).cpu(), getattr(st_cpu, f)),
                        f"{name} parity: {f} differs after superstep {step}")
        moved[name] = int((st_gpu.labels.cpu() != torch.from_numpy(arrays["labels"])).sum())
        require(moved[name] > 0, f"{name} parity: no vertex migrated")
    return {"supersteps": steps, "moved": moved}


def host_metrics(np, g, res) -> tuple[float, float]:
    """local_edges and max_norm_load recomputed on the host from the
    returned labels, held against the run's own; labels in range."""
    labels_h = res.labels
    require(labels_h.shape == (g.n,) and labels_h.min() >= 0 and labels_h.max() < K,
            f"{res.algo}: labels out of range")
    src = np.repeat(np.arange(g.n), np.diff(g.row_ptr))
    le_host = float(np.mean(labels_h[src] == labels_h[g.col_idx]))
    loads = np.bincount(labels_h, weights=g.deg_out, minlength=K)
    ml_host = float(loads.max() / (loads.sum() / K))
    require(abs(le_host - res.local_edges) < 1e-5,
            f"{res.algo}: local_edges {res.local_edges} vs host {le_host}")
    require(abs(ml_host - res.max_norm_load) < 1e-5,
            f"{res.algo}: max_norm_load {res.max_norm_load} vs host {ml_host}")
    require(np.isfinite(res.history["score"]).all(), f"{res.algo}: non-finite score")
    return le_host, ml_host


def rules_phase(torch, np, ops, g, dg) -> dict:
    """``run_partitioner`` for spinner, restream, hash and range on full
    WIKI, each with every launch counter set to 0 just before and read just
    after: K3 once per Spinner superstep and once per block and restream
    superstep, no other kernel; the static baselines launch none and equal
    their closed forms. Returns {algo: result row}."""
    from repro_torch.core import run_partitioner

    v = np.arange(g.n, dtype=np.int64)
    closed = {"hash": v % K, "range": np.minimum(v * K // g.n, K - 1)}
    per_step = {"spinner": 1, "restream": N_BLOCKS}
    rows = {}
    for algo in ("spinner", "restream", "hash", "range"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t = time.perf_counter()
        res = run_partitioner(algo, g, K, seed=SEED, n_blocks=N_BLOCKS, dg=dg)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        counts = ops.launch_counts()
        for name, c in counts.items():
            want = per_step.get(algo, 0) * res.steps if name == "edge_histogram" else 0
            require(c == want, f"{algo}: {name} launched {c} times in "
                    f"{res.steps} supersteps, expected {want}")
        host_metrics(np, g, res)
        if algo in closed:
            require(np.array_equal(res.labels, closed[algo]),
                    f"{algo} labels differ from the closed form")
        else:
            require(res.steps > 0, f"{algo} ran no superstep")
            require(res.local_edges > 0.5, f"{algo}: local_edges {res.local_edges} <= 0.5")
            require(res.max_norm_load <= 1.30,
                    f"{algo}: max_norm_load {res.max_norm_load} > 1.30")
        rows[algo] = {"algo": algo, "steps": res.steps, "converged": res.converged,
                      "local_edges": res.local_edges, "max_norm_load": res.max_norm_load,
                      "wall_s": wall,
                      "supersteps_per_s": res.steps / wall if res.steps else None,
                      "peak_memory_bytes": torch.cuda.max_memory_allocated(),
                      "launches": counts}
    return rows


def expect_launches(counts: dict, want: dict, what: str) -> None:
    """Every launch counter equals ``want`` (0 for a kernel not named)."""
    for name, c in counts.items():
        require(c == want.get(name, 0), f"{what}: {name} launched {c} times, "
                f"expected {want.get(name, 0)}")


def stream_delta(torch, ops, runner, delta, per_step: dict, what: str) -> dict:
    """One `StreamRunner.ingest` with every launch counter set to 0 just
    before and read just after; each kernel of ``per_step`` must have
    launched that many times a superstep (replays included), every other
    kernel never. Returns the delta's printed row."""
    ops.reset_launch_counts()
    rep = runner.ingest(delta)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    expect_launches(counts, {n: c * rep.steps for n, c in per_step.items()},
                    f"{what} delta {rep.delta_idx} ({rep.steps} supersteps)")
    refine_s = rep.wall_s - rep.merge_s - rep.plan_s
    return {"delta": rep.delta_idx, "m": rep.m, "added": rep.added, "deleted": rep.deleted,
            "dirty_blocks": rep.dirty_blocks, "repadded": rep.repadded,
            "e_max": runner.idg.e_max, "steps": rep.steps, "converged": rep.converged,
            "local_edges": rep.local_edges, "max_norm_load": rep.max_norm_load,
            "merge_s": rep.merge_s, "plan_s": rep.plan_s, "upload_bytes": rep.upload_bytes,
            "refine_s": refine_s, "supersteps_per_s": rep.steps / refine_s, "launches": counts}


def stream_reference_layout(np, g, seed: int) -> dict:
    """The batch layout phase 11c's incremental layout is held against:
    the graph its first `STREAM_INSERTS` insertion deltas make, built anew
    (``build_graph``), its `block_edges` at the stream's block width (8
    blocks, a multiple of 8 rows) and their `slab_row_ptr`. Numpy only; the
    host worker builds it."""
    from repro_torch.graphs.blocking import block_edges, slab_row_ptr
    from repro_torch.graphs.csr import build_graph
    from repro_torch.streaming import stream_from_graph

    deltas = list(itertools.islice(stream_from_graph(g, 8, seed=seed), STREAM_INSERTS))
    g_in = build_graph(np.concatenate([d.add_src for d in deltas]),
                       np.concatenate([d.add_dst for d in deltas]), g.n)
    block_v = -(-(-(-g.n // N_BLOCKS)) // 8) * 8
    be = block_edges(g_in, block_v=block_v)
    return {"n": g_in.n, "m": g_in.m, "be": be,
            "ptr": slab_row_ptr(be.edge_row, be.edge_w, be.block_v)}


def check_stream_layout(torch, np, ref: dict, dg) -> dict:
    """The incremental layout after the last insertion delta against the
    batch layout of the same graph (`stream_reference_layout`): each slab's
    live prefix equals `block_edges`' (the tails zero), and `blk_row_ptr`
    and `blk_spans` equal those `slab_row_ptr` and `SpanPlan.from_row_ptr`
    derive."""
    from repro_torch.core.device_graph import SpanPlan

    be, ptr = ref["be"], ref["ptr"]
    require((be.n_blocks, be.block_v, dg.m, dg.n) == (dg.n_blocks, dg.block_v, ref["m"],
                                                      ref["n"]),
            "stream layout: block count or graph size differs from the batch layout")
    require(np.array_equal(dg.blk_row_ptr.cpu().numpy(), ptr),
            "stream layout: blk_row_ptr differs from the batch layout's")
    plan = SpanPlan.from_row_ptr(ptr, "cpu")
    require(torch.equal(dg.blk_spans.spans.cpu(), plan.spans)
            and torch.equal(dg.blk_spans.hubs.cpu(), plan.hubs),
            "stream layout: the span plan differs from the batch layout's")
    for b in range(be.n_blocks):
        cnt = int(ptr[b, -1])
        for name, want in (("blk_dst", be.edge_dst), ("blk_row", be.edge_row),
                           ("blk_w", be.edge_w)):
            got = getattr(dg, name)[b].cpu().numpy()
            require(np.array_equal(got[:cnt], want[b, :cnt]) and not got[cnt:].any(),
                    f"stream layout: block {b} {name} differs from the batch layout's")
    return {"batch_e_max": be.e_max, "stream_e_max": dg.e_max,
            "spans": int(plan.spans.shape[1]), "hub_rows": int(plan.hubs.shape[1])}


def stream_phase(torch, np, ops, g, flat: dict, host=None) -> dict:
    """Phase 11c: `StreamRunner` on full WIKI through the entry point a
    user calls. Revolver over the first `STREAM_INSERTS` of 8 insertion
    deltas in random arrival order (the settings of
    benchmarks/streaming_bench.py), the incremental layout then held
    against the batch layout of the graph they make (from the ``host``
    worker, else built here), then a delta deleting 1 % of its directed
    edges; then Spinner and restream over the first of the 8 deltas each.
    K1 and K2 launch 8 times a Revolver superstep, K3 once a Spinner and 8
    times a restream superstep, nothing else. Returns the phase's rows."""
    from repro_torch.streaming import EdgeDelta, StreamConfig, StreamRunner, stream_from_graph

    t0 = time.perf_counter()
    settings = dict(k=K, refine_max_steps=15, refine_patience=3, sync_every=2)
    torch.cuda.reset_peak_memory_stats()
    runner = StreamRunner(g.n, StreamConfig(**settings, warm_sharpen=0.5), seed=SEED)
    per_step = {n: N_BLOCKS for n in PARTITIONER_KERNELS}
    deltas = list(itertools.islice(stream_from_graph(g, 8, seed=SEED), STREAM_INSERTS))
    rows = [stream_delta(torch, ops, runner, d, per_step, "revolver stream") for d in deltas]
    inserted = rows[-1]
    src = np.concatenate([d.add_src for d in deltas])
    dst = np.concatenate([d.add_dst for d in deltas])
    t = time.perf_counter()
    ref, ref_s = (host.stream_layout() if host is not None
                  else (stream_reference_layout(np, g, SEED), None))
    require(ref["m"] == src.size == inserted["m"], f"stream: {ref['m']} edges inserted, "
            f"{src.size} in the deltas, {inserted['m']} in the runner")
    layout = {**check_stream_layout(torch, np, ref, runner.idg.device_graph),
              "wait_and_check_s": time.perf_counter() - t, "worker_build_s": ref_s}
    del ref
    gone = np.random.default_rng(1).choice(src.size, src.size // 100, replace=False)
    empty = np.empty(0, np.int32)
    rows.append(stream_delta(torch, ops, runner,
                             EdgeDelta(empty, empty, src[gone], dst[gone]), per_step,
                             "revolver stream"))
    require(rows[-1]["deleted"] == gone.size and rows[-1]["m"] == src.size - gone.size,
            f"deletion delta removed {rows[-1]['deleted']} of {gone.size} edges")
    for row in (inserted, rows[-1]):
        require(row["local_edges"] > 0.5, f"stream local_edges {row['local_edges']} <= 0.5")
        require(row["max_norm_load"] <= 1.30,
                f"stream max_norm_load {row['max_norm_load']} > 1.30")
    insert_steps = sum(r["steps"] for r in rows[:-1])
    out = {"revolver": rows, "layout_check": layout,
           "insert_supersteps": insert_steps, "flat_supersteps": flat["steps"],
           "local_edges_vs_flat": inserted["local_edges"] / flat["local_edges"],
           "revolver_peak_memory_bytes": torch.cuda.max_memory_allocated(),
           "revolver_seconds": time.perf_counter() - t0}
    del runner
    # the other rules take the first of the same 8 deltas (a cold start on
    # an eighth of the graph): cut from 2 deltas (a re-pad and a warm start
    # too) to keep the run inside its time limit once phase 17 came; 8
    # deltas over the whole graph spent ~120 s merging on the host per rule
    for algo, k3_per_step in (("spinner", 1), ("restream", N_BLOCKS)):
        t = time.perf_counter()
        runner = StreamRunner(g.n, StreamConfig(**settings), algo=algo, seed=SEED)
        out[algo] = [stream_delta(torch, ops, runner, d, {"edge_histogram": k3_per_step},
                                  f"{algo} stream")
                     for d in itertools.islice(stream_from_graph(g, 8, seed=SEED), 1)]
        # an eighth of the graph in 15 supersteps leaves these rules short
        # of convergence: the gate is the balance, and local edges above
        # hash's 1/k
        last = out[algo][-1]
        require(1 / K < last["local_edges"] <= 1 and last["max_norm_load"] <= 1.30,
                f"{algo} stream: {last}")
        out[f"{algo}_seconds"] = time.perf_counter() - t
        del runner
    rows = [r for algo in ("revolver", "spinner", "restream") for r in out[algo]]
    out["launches"] = {n: sum(r["launches"][n] for r in rows) for n in rows[0]["launches"]}
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# phase 11e: the stream over a mesh
# --------------------------------------------------------------------------
STREAM_SETTINGS = dict(k=K, refine_max_steps=15, refine_patience=3, sync_every=2)
# phase 11e's main leg: the first 2 of 8 deltas (4 before phase 7j; with 4
# and 7j the script took 1,217 s on an H100 host whose host-bound phases
# ran 1.4-2x slower than on the fastest seen)
STREAM_SHARDED_DELTAS = 2


def stream_halo_kw(cuda, shards: int = SHARDS, hubs: bool = True, **extra) -> dict:
    """`StreamRunner` keywords of phase 11e's layout: ``shards`` shards on
    the card, the per-vertex halo plan with fallback off (phase 17h's) and,
    with ``hubs``, hubs at outdegree quantile 0.95."""
    from repro_torch.launch.mesh import BlocksMesh

    kw = dict(chunk_schedule="halo", mesh=BlocksMesh([cuda] * shards), halo_threshold=2.0,
              halo_granularity="vertex")
    kw.update(extra)
    if hubs:
        kw.update(hub_replication=True, hub_quantile=HUB_QUANTILE)
    return kw


def watch_plans(runner) -> list:
    """A one-slot list holding the halo plan of the latest delta's layout,
    as the runner's ``as_sharded`` builds it (the runner keeps no layout
    between deltas; earlier plans are let go, each as large as the slabs)."""
    plans, build = [], runner.idg.as_sharded

    def as_sharded(**kw):
        sdg = build(**kw)
        plans[:] = [sdg.halo]
        return sdg

    runner.idg.as_sharded = as_sharded
    return plans


def sharded_stream_delta(torch, ops, runner, plans: list, delta, per_step: dict,
                         what: str) -> dict:
    """`stream_delta` on a runner over a mesh (``plans`` from
    `watch_plans`), its row extended by the delta's plan: b_max, h_max,
    hub_pad, hub count, coverage, the bytes a superstep's exchange moves a
    device (the tail, and the hub votes), and the floors that grew (the
    runner's recompile causes)."""
    idg = runner.idg
    before = (idg.b_max_floor, idg.h_max_floor, idg.hub_pad_floor)
    row = stream_delta(torch, ops, runner, delta, per_step, what)
    events = ["e_max-repad"] if row["repadded"] and row["delta"] > 0 else []
    if 0 < before[2] < idg.hub_pad_floor:
        events.append("hub-promote")
    elif 0 < before[0] < idg.b_max_floor or 0 < before[1] < idg.h_max_floor:
        events.append("halo-widen")
    row["floor_events"] = events
    spec = plans[-1] if plans else None
    if spec is not None:
        algo = runner.algo
        wire = sum(spec.wire_bytes_per_elem(K, f in algo.wire_int8_fields)
                   for f in algo.vertex_fields)
        tail = spec.gathered_elems_per_device() * wire
        votes = (spec.hub_sync_elems_per_device(K, len(algo.vertex_fields)) * 4
                 if spec.n_hubs else 0)
        row.update(b_max=spec.b_max, h_max=spec.h_max, hub_pad=spec.hub_pad,
                   hub_count=spec.n_hubs, coverage=spec.coverage, tail_bytes=tail,
                   vote_bytes=votes, exchange_bytes_per_device=tail + votes)
    return row


def stream_host_metrics(np, runner, row: dict, what: str) -> None:
    """`host_metrics` of a stream's carried labels (original vertex order)
    on the merged graph, against the delta's reported metrics."""
    import types

    host_metrics(np, runner.idg.graph, types.SimpleNamespace(
        algo=what, labels=runner.labels, local_edges=row["local_edges"],
        max_norm_load=row["max_norm_load"], history={"score": [0.0]}))


def stream_sharded_phase(torch, np, ops, g, le_11c: list, dev: str = "cuda") -> dict:
    """Phase 11e's main leg: `StreamRunner` over a mesh on full WIKI, phase
    11c's stream settings (k 8, 15 supersteps and patience 3 a delta,
    sync_every 2, warm_sharpen 0.5) on phase 17h's layout (32 blocks on
    ``BlocksMesh([cuda:0] * 8)``, the per-vertex halo plan, hubs at
    quantile 0.95), over the first STREAM_SHARDED_DELTAS deltas of phase
    11c's stream. Every
    launch counter set to 0 just before each delta and read just after: K1
    and K2 32 times a superstep and H1 once, nothing else; each delta's
    local_edges >= 0.90x phase 11c's at the same delta (``le_11c``),
    max_norm_load <= 1.30 after the last, metrics recomputed on the host
    from the carried labels. Returns the phase's row."""
    from repro_torch.streaming import StreamConfig, StreamRunner, stream_from_graph

    t0 = time.perf_counter()
    cuda = torch.device(dev, 0 if dev == "cuda" else None)
    torch.cuda.reset_peak_memory_stats()
    runner = StreamRunner(g.n, StreamConfig(**STREAM_SETTINGS, n_blocks=SHARD_BLOCKS,
                                            warm_sharpen=0.5),
                          seed=SEED, device=dev, **stream_halo_kw(cuda))
    plans = watch_plans(runner)
    per_step = {**{n: SHARD_BLOCKS for n in PARTITIONER_KERNELS}, "hub_reconcile": 1}
    rows = []
    for d in itertools.islice(stream_from_graph(g, 8, seed=SEED), STREAM_SHARDED_DELTAS):
        row = sharded_stream_delta(torch, ops, runner, plans, d, per_step, "halo hub stream")
        stream_host_metrics(np, runner, row, f"halo hub stream delta {row['delta']}")
        ref = le_11c[row["delta"]]
        row["local_edges_vs_11c"] = row["local_edges"] / ref
        require(row["local_edges"] >= 0.90 * ref,
                f"halo hub stream delta {row['delta']}: local_edges {row['local_edges']} "
                f"< 0.90 x phase 11c's {ref}")
        rows.append(row)
        emit({"phase": "stream-sharded-delta", "leg": "main", **row})
    # the balance gate after the leg's last delta, where phase 11c gates its
    # stream: within a delta's 15 supersteps the Jacobi moves of 8 shards
    # overshoot and swing back (`repro`'s 8-shard runs do too), so an
    # earlier delta may end above it (1.3447 at delta 2 on an H100)
    require(rows[-1]["max_norm_load"] <= 1.30,
            f"halo hub stream delta {rows[-1]['delta']}: max_norm_load "
            f"{rows[-1]['max_norm_load']} > 1.30")
    require(any(r["repadded"] for r in rows[1:]), "halo hub stream: no re-pad after delta 0")
    out = {"deltas": len(rows), "n_blocks": runner.idg.n_blocks, "shards": SHARDS,
           "repads": [r["delta"] for r in rows if r["repadded"]],
           "supersteps": sum(r["steps"] for r in rows),
           "merge_s": sum(r["merge_s"] for r in rows), "plan_s": sum(r["plan_s"] for r in rows),
           "refine_s": sum(r["refine_s"] for r in rows),
           "upload_bytes": sum(r["upload_bytes"] for r in rows),
           "launches": {n: sum(r["launches"][n] for r in rows) for n in rows[0]["launches"]},
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    out["seconds"] = time.perf_counter() - t0
    return out


# phase 11e's side legs: the runners of each group take every delta in turn
# and are compared after it; each group runs in a process of its own
SIDE_GROUPS = {
    "a": ("sequential", "halo_1_shard", "async_1"),
    "b": ("halo", "async_0"),          # and (d): "resumed" from delta 4 on
    "c": ("locality", "permuted"),
    "e": ("spinner", "restream"),
}


def side_stream(np, scale: float):
    """(the graph, its deltas) of phase 11e's side legs: WIKI ``scale``,
    the 8 insertion deltas of `stream_from_graph(g, 8, seed=0)`, then one
    deleting 1 % of the directed edges (numpy seed 1), as phase 11c's."""
    from repro_torch.graphs import load_dataset
    from repro_torch.graphs.generators import edge_split
    from repro_torch.streaming import EdgeDelta, stream_from_graph

    gs = load_dataset("WIKI", scale=scale, seed=SEED)
    src, dst = edge_split(gs)
    gone = np.random.default_rng(1).choice(gs.m, gs.m // 100, replace=False)
    empty = np.empty(0, np.int32)
    return gs, list(stream_from_graph(gs, 8, seed=SEED)) + [
        EdgeDelta(empty, empty, src[gone], dst[gone])]


def side_runner(name: str, n: int, cuda, dev: str, work, **extra):
    """(the `StreamRunner` of side leg ``name``, its launches a superstep):
    the main leg's settings; "sequential" and "halo_1_shard" without hubs,
    the others on 8 shards with them ("permuted" in a block order of order
    32, since WIKI's locality order keeps the striping)."""
    import numpy as np

    from repro_torch.streaming import StreamConfig, StreamRunner

    revolver = StreamConfig(**STREAM_SETTINGS, n_blocks=SHARD_BLOCKS, warm_sharpen=0.5)
    other = StreamConfig(**STREAM_SETTINGS, n_blocks=SHARD_BLOCKS)
    k12 = {n_: SHARD_BLOCKS for n_ in PARTITIONER_KERNELS}
    hub12 = {**k12, "hub_reconcile": 1}
    ckpt = dict(checkpoint_dir=str(work / "halo"), checkpoint_every=4)
    spec = {
        "sequential": (revolver, {}, k12),
        "halo_1_shard": (revolver, stream_halo_kw(cuda, 1, hubs=False), k12),
        "halo": (revolver, {**stream_halo_kw(cuda), **ckpt}, hub12),
        "async_0": (revolver, stream_halo_kw(cuda, chunk_schedule="async"), hub12),
        "async_1": (revolver, stream_halo_kw(cuda, chunk_schedule="async",
                                             staleness_bound=1), hub12),
        "locality": (revolver, stream_halo_kw(cuda, assignment="locality"), hub12),
        # a block permutation of order 32 (WIKI's locality order keeps the
        # striping): the carried state's vertex order on the card
        "permuted": (revolver, stream_halo_kw(
            cuda, assignment=np.roll(np.arange(SHARD_BLOCKS), 5)), hub12),
        "spinner": (other, dict(algo="spinner", **stream_halo_kw(cuda)),
                    {"edge_histogram": SHARDS, "hub_reconcile": 1}),
        "restream": (other, dict(algo="restream", **stream_halo_kw(cuda)),
                     {"edge_histogram": SHARD_BLOCKS, "hub_reconcile": 1}),
    }
    cfg, kw, per_step = spec[name]
    return StreamRunner(n, cfg, seed=SEED, device=dev, **kw, **extra), per_step


def stream_side_group(torch, np, ops, group: str, dev: str = "cuda",
                      scale: float = 0.1) -> dict:
    """Side-leg group ``group`` of phase 11e (`SIDE_GROUPS`) on the card,
    each delta with every launch counter set to 0 just before and read just
    after; the checks inside the group: (a) the 1-shard halo stream equals
    the sequential one, labels after every delta and supersteps; (b) async
    at staleness 0 equals halo, labels and probabilities; (d) the halo
    stream checkpointed after delta 3 and resumed in a new runner equals the
    uninterrupted one on the remaining deltas, its floors and hub set
    restored; (c) the locality permutation is decided by delta 0 and kept,
    and on it and on an explicitly permuted stream the carried labels' host
    metrics (original vertex order) equal the reported ones. The quality
    gates wait for every group's rows (`stream_sharded_side_legs`). Returns
    each runner's rows."""
    import shutil
    import tempfile

    t0 = time.perf_counter()
    cuda = torch.device(dev, 0 if dev == "cuda" else None)
    gs, deltas = side_stream(np, scale)
    work = pathlib.Path(tempfile.mkdtemp(prefix=f"chip_smoke_side_{group}_"))
    legs = {name: side_runner(name, gs.n, cuda, dev, work) for name in SIDE_GROUPS[group]}
    plans = {name: watch_plans(r) for name, (r, _) in legs.items() if r.mesh is not None}
    rows = {name: [] for name in legs}
    perm = None

    def same(a: str, b: str, what: str) -> None:
        ra, rb = legs[a][0], legs[b][0]
        xa, xb = rows[a][-1], rows[b][-1]
        require(np.array_equal(ra.labels, rb.labels) and xa["steps"] == xb["steps"]
                and (ra.probs is None or np.array_equal(ra.probs, rb.probs)),
                f"{what}: {b} differs from {a} after delta {xa['delta']} "
                f"(steps {xa['steps']} vs {xb['steps']})")

    try:
        for i, delta in enumerate(deltas):
            for name, (runner, per_step) in legs.items():
                what = f"WIKI {scale} {name} stream"
                if name in plans:
                    row = sharded_stream_delta(torch, ops, runner, plans[name], delta,
                                               per_step, what)
                else:
                    row = stream_delta(torch, ops, runner, delta, per_step, what)
                if group == "c":
                    stream_host_metrics(np, runner, row, f"{what} delta {i}")
                rows[name].append(row)
            if group == "a":
                same("sequential", "halo_1_shard", "(a) 1-shard halo")
            elif group == "b":
                same("halo", "async_0", "(b) async at staleness 0")
                if "resumed" in legs:
                    same("halo", "resumed", "(d) resumed halo hub stream")
                elif i == 3:
                    # a copy of the checkpoint written after delta 3; the
                    # uninterrupted runner goes on writing its own
                    halo = legs["halo"][0]
                    halo.finish()
                    shutil.copytree(work / "halo", work / "cut" / "halo")
                    h = halo.idg
                    floors = (h.b_max_floor, h.h_max_floor, h.hub_pad_floor, h.he_max_floor,
                              h.hub_ids, h.e_max)
                    resumed = side_runner("halo", gs.n, cuda, dev, work / "cut",
                                          resume=True)
                    r = resumed[0].idg
                    require(resumed[0].delta_base == 4
                            and (r.b_max_floor, r.h_max_floor, r.hub_pad_floor,
                                 r.he_max_floor, r.hub_ids, r.e_max) == floors,
                            f"(d) resume after delta 3: delta_base {resumed[0].delta_base}, "
                            "its floors, hub set or e_max differ")
                    legs["resumed"] = resumed
                    plans["resumed"] = watch_plans(resumed[0])
                    rows["resumed"] = []
            elif group == "c":
                require(legs["permuted"][0].idg.block_perm is not None,
                        "(c) the permuted stream has no block permutation")
                idg = legs["locality"][0].idg
                if i == 0:
                    require(idg.perm_decided, "(c) the locality assignment is undecided")
                    perm = None if idg.block_perm is None else idg.block_perm.copy()
                require((perm is None and idg.block_perm is None)
                        or (perm is not None and np.array_equal(perm, idg.block_perm)),
                        f"(c) the locality permutation changed at delta {i}")
        for runner, _ in legs.values():
            runner.finish()
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"rows": rows, "seconds": time.perf_counter() - t0}
    if group == "c":
        out["locality_permuted"] = perm is not None
    return out


def side_group_worker(conn, group: str, scale: float) -> None:
    """`stream_side_group` in a process of its own, its result (or its
    traceback) sent back."""
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        import numpy as np
        import torch

        from repro_torch.kernels import ops

        torch.set_num_threads(1)
        conn.send(("ok", stream_side_group(torch, np, ops, group, "cuda", scale)))
    except BaseException:
        conn.send(("error", traceback.format_exc()))
    finally:
        conn.close()


class SideLegs:
    """Phase 11e's side-leg groups, one spawned process each, started once
    the kernels are built: they share the card with phases 3-7 and the
    other side legs while the host builds the graph, and are collected
    before phase 8 (no timed phase runs beside them)."""

    def __init__(self, scale: float = 0.1):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self.t0 = time.perf_counter()
        self._procs = {}
        for group in SIDE_GROUPS:
            conn, child = ctx.Pipe(duplex=False)
            proc = ctx.Process(target=side_group_worker, args=(child, group, scale),
                               daemon=True)
            proc.start()
            child.close()
            self._procs[group] = (proc, conn)

    def results(self) -> dict:
        """{group: its result}; blocks until every group has ended, and
        fails with a group's traceback."""
        out = {}
        for group, (proc, conn) in self._procs.items():
            try:
                got = conn.recv()
            except EOFError:
                proc.join(timeout=10)
                got = ("error", f"exited with code {proc.exitcode}")
            require(got[0] == "ok", f"phase 11e side legs, group {group}: {got[1]}")
            out[group] = got[1]
        out["wall_s"] = time.perf_counter() - self.t0
        return out

    def stop(self) -> None:
        for proc, conn in self._procs.values():
            if proc.is_alive():
                proc.terminate()
            proc.join()
            conn.close()


def stream_sharded_side_legs(np, results: dict, scale: float = 0.1) -> dict:
    """Phase 11e's side legs at WIKI ``scale`` (`stream_side_group`'s
    groups' ``results``; each group's checks already held), their rows
    emitted, then the quality gates: (b) async at staleness 1 meets the
    main leg's gates against the sequential stream (local_edges >= 0.90x
    at every delta, max_norm_load <= 1.30 after the last insertion and
    after the deletion); (c) the locality stream's
    local_edges >= 0.90x the contiguous halo stream's after the last delta;
    (e) Spinner and restream on the 8-shard halo stream, after the deletion:
    max_norm_load <= 1.30 and local_edges above 1/k. Returns the legs'
    row."""
    rows = {name: r for group in SIDE_GROUPS for name, r in results[group]["rows"].items()}
    for name, leg_rows in rows.items():
        for row in leg_rows:
            emit({"phase": "stream-sharded-delta", "leg": name, "scale": scale,
                  **{k: v for k, v in row.items() if k != "launches"},
                  "launches": {k: v for k, v in row["launches"].items() if v}})
    # the balance gate after the last insertion and after the deletion, as
    # the main leg's and phase 11c's: 8 shards' moves overshoot within a
    # delta's 15 supersteps (every 8-shard stream here ends deltas 0 and 1
    # above 1.30)
    for seq, stale in zip(rows["sequential"], rows["async_1"]):
        require(stale["local_edges"] >= 0.90 * seq["local_edges"]
                and (stale["delta"] < 7 or stale["max_norm_load"] <= 1.30),
                f"(b) async at staleness 1, delta {stale['delta']}: local_edges "
                f"{stale['local_edges']} (sequential {seq['local_edges']}), max_norm_load "
                f"{stale['max_norm_load']}")
    contiguous, locality = rows["halo"][-1]["local_edges"], rows["locality"][-1]["local_edges"]
    require(locality >= 0.90 * contiguous,
            f"(c) locality local_edges {locality} < 0.90 x contiguous {contiguous}")
    for algo in ("spinner", "restream"):
        last = rows[algo][-1]
        require(1 / K < last["local_edges"] <= 1 and last["max_norm_load"] <= 1.30,
                f"(e) {algo} on the 8-shard halo stream: {last}")
    launches = collections.Counter()
    for leg_rows in rows.values():
        for row in leg_rows:
            launches.update(row["launches"])
    return {"scale": scale, "deltas": len(rows["sequential"]),
            "locality_permuted": results["c"]["locality_permuted"],
            "quality_locality_vs_contiguous": locality / contiguous,
            "quality_permuted_vs_contiguous": rows["permuted"][-1]["local_edges"] / contiguous,
            "quality_async_1_vs_sequential": (rows["async_1"][-1]["local_edges"]
                                              / rows["sequential"][-1]["local_edges"]),
            "resumed_deltas": len(rows["resumed"]), "launches": dict(launches),
            "group_seconds": {g: results[g]["seconds"] for g in SIDE_GROUPS},
            "wall_s": results["wall_s"]}


def level_weights(np, lg) -> tuple[float, float]:
    """(largest eq.-(4) weight, largest row weight sum) of a level; the row
    sum bounds every (row, label) sum K1 and K3 take on its layout."""
    rows = np.repeat(np.arange(lg.n), np.diff(lg.adj_ptr))
    wsum = np.bincount(rows, weights=lg.adj_w.astype(np.float64), minlength=lg.n)
    return float(lg.adj_w.max()), float(wsum.max())


def check_level_kernels(torch, np, lvl: int, lg, seed: int) -> dict:
    """K1 and K3 on the layout `prepare_device_graph` gives a contracted
    V-cycle level (its weights past 2), at the shapes the V-cycle calls
    them: K1 on every block (nb=1, the block's span plan), both weight
    modes, and K3's gather form over all blocks at once (Spinner's call),
    on random labels. Bit-equal to the plain versions on the card while
    every sum stays below 2^24 (the plain version adds in f32), else to the
    plain version summed in f64 and rounded once (the kernels' contract);
    two calls bit-equal."""
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.kernels import edge_histogram as k3
    from repro_torch.kernels import edge_phase

    dg = prepare_device_graph(lg, n_blocks=N_BLOCKS, device="cuda")
    max_w, max_row_sum = level_weights(np, lg)
    exact_f32 = max_row_sum < 2 ** 24
    # the plain versions' values: f32 where its adds are exact, else f64
    vals = dg.blk_w if exact_f32 else dg.blk_w.double()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    bv, nb = dg.block_v, dg.n_blocks
    labels = torch.randint(0, K, (dg.n_pad,), generator=gen, device="cuda", dtype=torch.int32)
    lam = torch.randint(0, K, (dg.n_pad,), generator=gen, device="cuda", dtype=torch.int32)
    actions = torch.randint(0, K, (nb, bv), generator=gen, device="cuda", dtype=torch.int32)
    feasible = (torch.rand((nb, K), generator=gen, device="cuda") > 0.3).float()
    what = f"level {lvl} (n {lg.n}, block_v {bv}, weights up to {max_w:g})"
    for b, mode in itertools.product(range(nb), ("self_lambda", "neighbor_lambda")):
        blk = slice(b, b + 1)
        call = lambda: edge_phase.fused_edge_phase_cuda(  # noqa: E731
            dg.blk_dst[blk], dg.blk_w[blk], dg.blk_row_ptr[blk], dg.blk_spans.block(b),
            labels, lam, actions[blk], feasible[blk], block_v=bv, k=K, weight_mode=mode)
        got, again = call(), call()
        want = edge_phase.fused_edge_phase_plain(
            dg.blk_dst[blk], dg.blk_row[blk], vals[blk], labels, lam, actions[blk],
            feasible[blk], block_v=bv, k=K, weight_mode=mode)
        torch.cuda.synchronize()
        for a, c, w, name in zip(got, again, want, ("hist", "w_acc")):
            require(torch.equal(a, w.float()), f"K1 {mode} {name} differs from plain on "
                    f"{what}, block {b}")
            require(torch.equal(a, c), f"K1 {mode} {name}: two calls differ on {what}")
    call = lambda: k3.edge_histogram_spans_cuda(  # noqa: E731
        dg.blk_dst, dg.blk_w, dg.blk_row_ptr, dg.blk_spans, block_v=bv, k=K, labels=labels)
    got, again = call(), call()
    want = k3.edge_histogram_plain(labels[dg.blk_dst.long()], dg.blk_row, vals,
                                   block_v=bv, k=K)
    torch.cuda.synchronize()
    require(torch.equal(got, want.float()), f"K3 gather form differs from plain on {what}")
    require(torch.equal(got, again), f"K3 gather form: two calls differ on {what}")
    return {"level": lvl, "n": lg.n, "n_blocks": nb, "block_v": bv, "e_max": dg.e_max,
            "live_entries": int((dg.blk_w > 0).sum()), "hub_rows": int(dg.blk_spans.hubs.shape[1]),
            "max_weight": max_w, "max_row_weight_sum": max_row_sum,
            "held_to": "f32 plain" if exact_f32 else "f64 plain rounded once"}


def vcycle_phase(torch, np, ops, g, flat: dict, host=None) -> dict:
    """Phase 11d: ``run_partitioner("revolver", WIKI, 8, mode="vcycle")``
    through the entry point a user calls, every launch counter set to 0
    just before and read just after: K1 and K2 launch once per block and
    superstep, summed over the levels, nothing else. Metrics recomputed on
    the host; printed beside phase 10's flat run. The run's
    `build_level_stack(g, DEFAULT_COARSE_N)` call is answered with the
    stack the host worker built by that same call on its copy of ``g``
    (`HostWorker`), while the card ran phases 9-17 and 11c; the wrapper
    requires those arguments (without a ``host`` it calls the function
    itself, timed the same way). Then, on that level stack, each level's
    largest weight and row weight sum printed, and K1 and K3 held against
    their plain versions on the layouts of level 1, a middle level and the
    coarsest (`check_level_kernels`)."""
    from repro_torch.core import multilevel, run_partitioner

    # the stack is kept for the kernel checks too (building it took
    # 102-143 s on the host)
    stacks, coarsen = [], {}
    build_level_stack = multilevel.build_level_stack

    def build_and_keep(graph, coarse_n, *args, **kwargs):
        require(graph is g and coarse_n == multilevel.DEFAULT_COARSE_N
                and not args and not kwargs,
                f"vcycle: build_level_stack(n={graph.n}, coarse_n={coarse_n}, {args}, "
                f"{kwargs}), not the call the host worker answered")
        t = time.perf_counter()
        if host is None:
            graphs, cmaps = build_level_stack(graph, coarse_n)
            graphs = graphs[1:]
            coarsen["host_coarsen_s"] = time.perf_counter() - t
        else:
            graphs, cmaps, coarsen["host_coarsen_s"] = host.level_stack()
        coarsen["stack_wait_s"] = time.perf_counter() - t
        graphs = [g, *graphs]
        stacks.append(graphs)
        return graphs, cmaps

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    multilevel.build_level_stack = build_and_keep
    t = time.perf_counter()
    try:
        res = run_partitioner("revolver", g, K, seed=SEED, n_blocks=N_BLOCKS, mode="vcycle")
        torch.cuda.synchronize()
    finally:
        multilevel.build_level_stack = build_level_stack
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    vc = res.vcycle
    require(len(stacks) == 1 and len(vc["level_n_vertices"]) == len(stacks[0])
            and vc["level_n_vertices"] == [lg.n for lg in stacks[0]],
            f"vcycle: level sizes {vc['level_n_vertices']}, the kept stack's "
            f"{[[lg.n for lg in st] for st in stacks]}")
    launches = sum(b * s for b, s in zip(vc["level_n_blocks"], vc["steps_per_level"]))
    expect_launches(counts, {n: launches for n in PARTITIONER_KERNELS}, "vcycle")

    t = time.perf_counter()
    graphs = stacks.pop()
    weights = [level_weights(np, lg) for lg in graphs]
    top = len(graphs) - 1
    checked = [check_level_kernels(torch, np, lvl, graphs[lvl], SEED + lvl)
               for lvl in (sorted({1, max(1, top // 2), top}) if top else [])]
    del graphs
    check_s = time.perf_counter() - t
    host_metrics(np, g, res)
    require(res.local_edges > 0.5, f"vcycle local_edges {res.local_edges} <= 0.5")
    require(res.max_norm_load <= 1.30, f"vcycle max_norm_load {res.max_norm_load} > 1.30")
    return {"algo": "revolver", "k": K, "seed": SEED, **vc,
            "level_max_weight": [w for w, _ in weights],
            "level_max_row_weight_sum": [s for _, s in weights],
            "level_kernel_checks": checked, "level_check_s": check_s, **coarsen,
            "fine_steps": res.steps, "total_supersteps": sum(vc["steps_per_level"]),
            "local_edges": res.local_edges, "max_norm_load": res.max_norm_load,
            "wall_s": wall, "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "launches": counts, "flat": flat}


def counted_run(torch, ops, runner_mod, g, **kw):
    """``run_partitioner("revolver", g, K, **kw)`` with every launch counter
    set to 0 just before and read just after, the run's blocking fetches
    counted two ways: calls of the runner's `fetch` (through which every
    window fetch goes) and the synchronizing CUDA calls torch's sync debug
    mode warns about. Returns (result, wall seconds, launches, fetches,
    synchronizing calls, {source line: synchronizing calls})."""
    import warnings

    calls = [0]
    real = runner_mod.fetch

    def counting(groups):
        calls[0] += 1
        return real(groups)

    torch.cuda.synchronize()
    ops.reset_launch_counts()
    runner_mod.fetch = counting
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            t = time.perf_counter()
            try:
                res = runner_mod.run_partitioner("revolver", g, K, **kw)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        runner_mod.fetch = real
    sites = collections.Counter("/".join(pathlib.Path(w.filename).parts[-2:]) + f":{w.lineno}"
                                for w in caught if "synchroniz" in str(w.message))
    return res, wall, ops.launch_counts(), calls[0], sum(sites.values()), dict(sites)


def crash_safety_phase(torch, np, ops, g, dg) -> dict:
    """Phase 16: tracing, checkpoints, resume and the state guard on
    Revolver's main path (``g`` and its layout ``dg``, k 8, sync_every 5),
    on ``dg``'s device. Every check raises. Returns the phase's row."""
    import shutil

    from repro_torch import faults
    from repro_torch.core import runner as runner_mod
    from repro_torch.core.runner import PartitionStateError
    from repro_torch.obs import Tracer

    t0 = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_crash_safety"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    dev = dg.device.type
    common = dict(seed=SEED, n_blocks=N_BLOCKS, dg=dg, sync_every=5, device=dev)
    per_step = {n: N_BLOCKS for n in PARTITIONER_KERNELS}
    out = {}

    # a counted superstep first, so that both counted runs find the device
    # scalars the runner caches (their creation synchronizes once), and the
    # one synchronizing call torch makes in a process's first debug-mode
    # window (from torch/cuda/__init__.py) falls outside them
    counted_run(torch, ops, runner_mod, g, max_steps=1, **common)

    # 1. reference: untraced, no checkpoints
    ref, wall1, counts1, fetch1, sync1, sites1 = counted_run(torch, ops, runner_mod, g,
                                                             **common)
    expect_launches(counts1, {n: c * ref.steps for n, c in per_step.items()}, "reference run")
    host_metrics(np, g, ref)
    out["reference"] = {"steps": ref.steps, "wall_s": wall1,
                        "supersteps_per_s": ref.steps / wall1, "fetches": fetch1,
                        "synchronizing_calls": sync1, "synchronizing_sites": sites1,
                        "local_edges": ref.local_edges}

    # 2. the same run traced, checkpointed every 10 supersteps and guarded
    tracer = Tracer()
    ckpt = work / "traced"
    res, wall2, counts2, fetch2, sync2, sites2 = counted_run(
        torch, ops, runner_mod, g, trace=tracer, checkpoint_dir=str(ckpt),
        checkpoint_every=10, guard="raise", **common)
    require(np.array_equal(res.labels, ref.labels) and res.steps == ref.steps,
            f"traced run: {res.steps} supersteps, labels equal "
            f"{np.array_equal(res.labels, ref.labels)} (reference {ref.steps})")
    # supersteps/s in turns on this card: plain (run 1), full (run 2), then
    # traced only, traced only, full, plain
    walls = {"plain": [wall1], "traced_only": [], "full": [wall2]}
    for kind in ("traced_only", "traced_only", "full", "plain"):
        extra = {"traced_only": dict(trace=Tracer()),
                 "full": dict(trace=Tracer(), checkpoint_dir=str(work / "turns"),
                              checkpoint_every=10, guard="raise"),
                 "plain": {}}[kind]
        walls[kind].append(counted_run(torch, ops, runner_mod, g, **extra, **common)[1])
    out["turns"] = {kind: {"wall_s": w, "supersteps_per_s": [ref.steps / x for x in w]}
                    for kind, w in walls.items()}
    require(fetch2 == fetch1 and sync2 == sync1,
            f"traced run fetched {fetch2} times ({sync2} synchronizing calls), "
            f"the reference {fetch1} ({sync1}); synchronizing calls by line, "
            f"reference {sites1}, traced {sites2}")
    expect_launches(counts2, {n: c * res.steps for n, c in per_step.items()}, "traced run")
    trace_path = work / "trace.json"
    tracer.save(str(trace_path))
    check = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_report.py"),
                            str(trace_path), "--validate"],
                           capture_output=True, text=True, timeout=300)
    require(check.returncode == 0, f"trace_report --validate: {check.stdout}{check.stderr}")
    summary = tracer.summary()
    saves = [e for e in tracer.events if e["name"] == "checkpoint-save" and e["ph"] == "X"]
    # a save is skipped (not waited for) while two writes are in flight
    require(1 <= len(saves) <= ref.steps // 10 and saves[0]["args"]["bytes"] > 0,
            f"{len(saves)} checkpoint saves in {ref.steps} supersteps")
    out["traced"] = {
        "steps": res.steps, "wall_s": wall2, "supersteps_per_s": res.steps / wall2,
        "fetches": fetch2, "synchronizing_calls": sync2,
        "cost_vs_reference": wall2 / wall1 - 1.0,
        "trace_validate": check.stdout.strip(),
        "span_counts": {k: v["count"] for k, v in summary["spans"].items()},
        "snapshot_bytes": saves[0]["args"]["bytes"],
        "save_snapshot_s": [e["dur"] / 1e6 for e in tracer.events
                            if e["name"] == "checkpoint-snapshot" and e["ph"] == "X"],
        "save_enqueue_s": [e["dur"] / 1e6 for e in saves],
        "save_snapshot_wait_s": [v for _, v in tracer.series["checkpoint_wait_s"]],
        "save_writer_s": [v for _, v in tracer.series["checkpoint_write_s"]],
        "migrations_first_last": [tracer.series["migrations"][0][1],
                                  tracer.series["migrations"][-1][1]]}

    # 3. cut at superstep 20, then resume with the default budget
    cut_dir = work / "cut"
    runner_mod.run_partitioner("revolver", g, K, max_steps=20, checkpoint_dir=str(cut_dir),
                               checkpoint_every=10, **common)
    resumed_trace = Tracer()
    t = time.perf_counter()
    res = runner_mod.run_partitioner("revolver", g, K, checkpoint_dir=str(cut_dir),
                                     checkpoint_every=10, resume=True, trace=resumed_trace,
                                     **common)
    torch.cuda.synchronize()
    resume_wall = time.perf_counter() - t
    require(res.resumed_from == 20, f"resumed from {res.resumed_from}, expected 20")
    require(np.array_equal(res.labels, ref.labels) and res.steps == ref.steps,
            f"resumed run: {res.steps} supersteps, labels equal "
            f"{np.array_equal(res.labels, ref.labels)} (reference {ref.steps})")
    restore = [e["dur"] / 1e6 for e in resumed_trace.events
               if e["name"] == "checkpoint-restore" and e["ph"] == "X"]
    require(len(restore) == 1, f"{len(restore)} checkpoint restores in the resumed run")
    out["resume"] = {"resumed_from": res.resumed_from, "steps": res.steps,
                     "restore_s": restore[0], "wall_s": resume_wall}

    # 4. the guard under each policy, NaN probabilities after superstep 8
    guard = {}
    with faults.use_plan("nan@superstep=8"):
        try:
            runner_mod.run_partitioner("revolver", g, K, guard="raise", **common)
            raised = False
        except PartitionStateError:
            raised = True
    require(raised, "guard='raise' did not raise PartitionStateError")
    guard["raise"] = "PartitionStateError"
    with faults.use_plan("nan@superstep=8"):
        res = runner_mod.run_partitioner("revolver", g, K, guard="reinit", keep_probs=True,
                                         **common)
    require(res.labels.min() >= 0 and res.labels.max() < K and np.isfinite(res.probs).all(),
            "guard='reinit' left labels out of range or probs non-finite")
    guard["reinit"] = {"steps": res.steps, "local_edges": res.local_edges}
    with faults.use_plan("nan@superstep=8"):
        res = runner_mod.run_partitioner("revolver", g, K, guard="rollback",
                                         checkpoint_dir=str(work / "rollback"),
                                         checkpoint_every=5, **common)
    same = bool(np.array_equal(res.labels, ref.labels))
    guard["rollback"] = {"steps": res.steps, "labels_equal_reference": same}
    require(res.labels.min() >= 0 and res.labels.max() < K,
            "guard='rollback' left labels out of range")
    # the generator rewinds with the state, so the replay draws what the
    # first pass drew (`repro` gives the same on the CPU at WIKI 0.002)
    require(same and res.steps == ref.steps + 5,
            f"rollback: labels equal the reference {same}, {res.steps} supersteps "
            f"(reference {ref.steps} + the 5 replayed)")
    out["guard"] = guard

    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def crash_safety_side_legs(torch, np, dev: str = "cuda", *, kill_scale: float = 0.01,
                           stream_scale: float = 0.1) -> dict:
    """Phase 16's legs off the full graph: a SIGKILL and resume through the
    CLI at WIKI ``kill_scale`` (`tools/torch_kill_resume_check.py`, a
    subprocess) and a Revolver stream at WIKI ``stream_scale``
    checkpointed every 2 deltas, dropped after delta 4 and resumed in a new
    `StreamRunner`, against the uninterrupted stream. Every check raises.
    Returns the legs' row."""
    import shutil

    from repro_torch.graphs import load_dataset
    from repro_torch.streaming import StreamConfig, StreamRunner, stream_from_graph

    t0 = time.perf_counter()
    work = ROOT / "build" / "chip_smoke_side_legs"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out = {}

    # a real SIGKILL and resume through the CLI, at WIKI kill_scale
    t = time.perf_counter()
    kill = subprocess.run(
        [sys.executable, str(ROOT / "tools" / "torch_kill_resume_check.py"), "--device",
         dev, "--scale", str(kill_scale), "--k", str(K), "--seed", str(SEED),
         "--max-steps", "290", "--kill-at", "12", "--checkpoint-every", "4",
         "--sync-every", "4"], capture_output=True, text=True, timeout=600)
    lines = kill.stdout.strip().splitlines()
    require(kill.returncode == 0 and lines and lines[-1] == "PASS",
            f"kill-and-resume at WIKI {kill_scale}: {kill.stdout}{kill.stderr}")
    out["sigkill"] = {"scale": kill_scale, "report": lines, "seconds": time.perf_counter() - t}

    # a stream checkpointed every 2 deltas, dropped after delta 4 and
    # resumed in a new runner, against the uninterrupted stream
    t = time.perf_counter()
    gs = load_dataset("WIKI", scale=stream_scale, seed=SEED)
    cfg = StreamConfig(k=K, refine_max_steps=15, refine_patience=3, sync_every=2)
    deltas = list(stream_from_graph(gs, 8, seed=SEED))
    plain = StreamRunner(gs.n, cfg, seed=SEED, device=dev)
    plain.run(deltas)
    sdir = str(work / "stream")
    first = StreamRunner(gs.n, cfg, seed=SEED, device=dev, checkpoint_dir=sdir,
                         checkpoint_every=2)
    first.run(deltas[:4])
    first.finish()
    del first
    second = StreamRunner(gs.n, cfg, seed=SEED, device=dev, checkpoint_dir=sdir,
                          checkpoint_every=2, resume=True)
    require(second.delta_base == 4, f"stream resumed at delta {second.delta_base}, expected 4")
    second.run(deltas)
    second.finish()
    require(np.array_equal(second.labels, plain.labels)
            and np.array_equal(second.probs, plain.probs)
            and second.total_steps == plain.total_steps,
            f"resumed stream: labels/probs equal {np.array_equal(second.labels, plain.labels)}"
            f"/{np.array_equal(second.probs, plain.probs)}, supersteps "
            f"{second.total_steps} vs {plain.total_steps}")
    out["stream"] = {"scale": stream_scale, "n": gs.n, "m": gs.m, "deltas": len(deltas),
                     "resumed_at": second.delta_base, "total_steps": plain.total_steps,
                     "seconds": time.perf_counter() - t}
    shutil.rmtree(work, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# phase 17: the sharded, halo and async schedules
# --------------------------------------------------------------------------
def clone_state(torch, state, device=None):
    """A copy of a rule state (its generator too), on ``device`` or its own.
    Moving a CPU state to the card gives it a fresh card generator: the
    legs that move one replay their draws."""
    dev = state.labels.device if device is None else torch.device(device)
    if dev == state.gen.device:
        gen = torch.Generator(device=dev)
        gen.set_state(state.gen.get_state())
    else:
        gen = torch.Generator(device=dev).manual_seed(SEED)
    return state._replace(gen=gen, **{f: v.to(dev, copy=True) for f, v in state._asdict().items()
                                      if isinstance(v, torch.Tensor)})


def states_equal(torch, a, b, fields) -> dict:
    """{field: bit-equal} over ``fields`` (one device reduction each)."""
    return {f: bool(torch.equal(getattr(a, f), getattr(b, f).to(getattr(a, f).device)))
            for f in fields}


def lockstep(torch, engine, runs: dict, steps: int, window: int, what: str) -> dict:
    """Drive each ``{name: (algo, layout, cfg, state[, halo])}`` through
    ``steps`` supersteps side by side (``halo``: the sequential schedule's
    hub plan) and require every state field (loads, block fields and the
    generator's state included) bit-equal across them after every
    ``window``. Returns {"windows": n, "supersteps": steps}."""
    names = list(runs)
    states = {n: runs[n][3] for n in names}
    windows = 0
    for step in range(steps):
        for n in names:
            algo, layout, cfg = runs[n][:3]
            halo = runs[n][4] if len(runs[n]) > 4 else None
            states[n] = engine.superstep(algo, layout, cfg, states[n], halo=halo)
        if (step + 1) % window == 0 or step + 1 == steps:
            windows += 1
            ref = states[names[0]]
            fields = [f for f, v in ref._asdict().items() if isinstance(v, torch.Tensor)]
            for n in names[1:]:
                eq = states_equal(torch, ref, states[n], fields)
                eq["gen"] = bool(ref.gen.get_state().equal(states[n].gen.get_state()))
                require(all(eq.values()), f"{what}: {n} differs from {names[0]} after "
                        f"superstep {step + 1}: {eq}")
    return {"windows": windows, "supersteps": steps}


def exchange_bytes(sdg, algo) -> dict:
    """What one superstep's exchange moves under the layout's plan: per
    device (`repro`'s ``gathered_bytes_*`` counters) and over all shards."""
    spec = sdg.halo
    wire = sum(spec.wire_bytes_per_elem(K, f in algo.wire_int8_fields)
               for f in algo.vertex_fields)
    per_dev = spec.gathered_elems_per_device() * wire
    full = spec.full_gather_elems_per_device() * 4 * len(algo.vertex_fields)
    return {"per_device": per_dev, "all_shards": per_dev * sdg.n_shards,
            "full_gather_per_device": full}


def plan_row(sdg) -> dict:
    spec = sdg.halo
    return {"decision": spec.decision, "coverage": spec.coverage, "b_max": spec.b_max,
            "h_max": spec.h_max, "interior_split": spec.interior_split,
            "interior_counts": list(spec.interior_counts), "buf_len": spec.buf_len,
            "permuted": sdg.block_perm is not None}


def check_shard_kernels(torch, sdg, s: int, seed: int) -> dict:
    """K1 (both weight modes) and K3's gather form on shard ``s``'s halo
    slabs of ``sdg`` (ids in the shard's ``local + halo`` buffer space),
    against their plain versions on the card, on a random labels buffer of
    the buffer's length: bit-equal. Returns the check's row."""
    from repro_torch.kernels import edge_histogram, edge_phase

    sh = sdg.shards[s]
    dev = sh.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    buf = sdg.halo.buf_len
    labels = torch.randint(0, K, (buf,), generator=gen, device=dev, dtype=torch.int32)
    lam = torch.randint(0, K, (buf,), generator=gen, device=dev, dtype=torch.int32)
    bps, bv = sdg.blocks_per_shard, sdg.block_v
    actions = torch.randint(0, K, (bps, bv), generator=gen, device=dev, dtype=torch.int32)
    feasible = (torch.rand((bps, K), generator=gen, device=dev) > 0.2).float()
    row = {"shard": s, "buf_len": buf, "blocks": bps, "max_dst": int(sh.blk_dst_halo.max()),
           "permuted": sdg.block_perm is not None}
    for mode in ("self_lambda", "neighbor_lambda"):
        got = edge_phase.fused_edge_phase_cuda(
            sh.blk_dst_halo, sh.blk_w, sh.blk_row_ptr, sh.blk_spans, labels, lam, actions,
            feasible, block_v=bv, k=K, weight_mode=mode)
        want = edge_phase.fused_edge_phase_plain(
            sh.blk_dst_halo, sh.blk_row, sh.blk_w, labels, lam, actions, feasible,
            block_v=bv, k=K, weight_mode=mode)
        require(all(torch.equal(a, b) for a, b in zip(got, want)),
                f"K1 ({mode}) on shard {s}'s halo slabs differs from its plain version")
        row[f"k1_{mode}"] = "bit-equal"
    got = edge_histogram.edge_histogram_spans_cuda(
        sh.blk_dst_halo, sh.blk_w, sh.blk_row_ptr, sh.blk_spans, block_v=bv, k=K,
        labels=labels)
    want = edge_histogram.edge_histogram_plain(labels[sh.blk_dst_halo.long()], sh.blk_row,
                                               sh.blk_w, block_v=bv, k=K)
    require(torch.equal(got, want), f"K3 (gather form) on shard {s}'s halo slabs differs")
    row["k3_gather"] = "bit-equal"
    return row


def sharded_side_legs(torch, np, ops, dev: str = "cuda") -> dict:
    """Phase 17's legs off the full graph (run in the host build's wait).
    (1) Card against CPU: WIKI 0.002 on 4 shards under an explicit block
    permutation and the per-vertex plan; 3 halo and 3 async supersteps on
    the card and on the CPU from one state with the same replayed draws:
    labels, lambda and loads equal, probabilities within K2's tolerance.
    (2) Spinner and restream at WIKI 0.1 on 8 shards (16 blocks): halo
    equal to sharded on one layout over 4 supersteps, K3 launched 8 times
    a Spinner superstep (once a shard) and once a restream block. (3) K1
    and K3 on shard 3's slabs of a block-permuted halo layout at WIKI 0.1
    (32 blocks, 8 shards). ``dev`` names the card (a CPU rehearsal passes
    "cpu")."""
    from repro_torch.core import engine
    from repro_torch.core.device_graph import prepare_sharded_device_graph
    from repro_torch.core.registry import get_algorithm
    from repro_torch.graphs import load_dataset
    from repro_torch.launch.mesh import BlocksMesh

    t0 = time.perf_counter()
    out = {}
    cuda, cpu = torch.device(dev, 0 if dev == "cuda" else None), torch.device("cpu")
    revolver = get_algorithm("revolver")
    g = load_dataset("WIKI", scale=0.002, seed=SEED)
    perm = np.random.default_rng(SEED + 17).permutation(16)
    lay = {dev: prepare_sharded_device_graph(
        g, BlocksMesh([dev] * 4), n_blocks=16, assignment=perm, halo=True,
        halo_threshold=2.0, halo_granularity="vertex") for dev in (cpu, cuda)}
    nb, bv = lay[cpu].n_blocks, lay[cpu].block_v
    rng = np.random.default_rng(SEED + 18)
    u = np.maximum(rng.random((3, nb, bv, K), dtype=np.float32),
                   np.finfo(np.float32).tiny)
    gumbel = -np.log(-np.log(u))
    uniform = rng.random((3, nb, bv), dtype=np.float32)

    def draws_block(step, b):
        return gumbel[step][b], uniform[step][b]

    parity = {}
    for sched in ("halo", "async"):
        cfg = revolver.config_cls(k=K, chunk_schedule=sched)
        s_cpu = revolver.init(lay[cpu], cfg, torch.Generator().manual_seed(SEED))
        s_gpu = clone_state(torch, s_cpu, cuda)
        for step in range(3):
            s_cpu = engine.superstep(revolver, lay[cpu], cfg, s_cpu, draws=draws_block)
            s_gpu = engine.superstep(revolver, lay[cuda], cfg, s_gpu, draws=draws_block)
            eq = states_equal(torch, s_cpu, s_gpu, ("labels", "lam", "loads"))
            require(all(eq.values()), f"card vs CPU, {sched} superstep {step}: {eq}")
            err = float((s_gpu.probs.cpu() - s_cpu.probs).abs().max())
            require(torch.allclose(s_gpu.probs.cpu(), s_cpu.probs, **K2_TOL),
                    f"card vs CPU, {sched} superstep {step}: probs off by {err}")
        parity[sched] = {"supersteps": 3, "probs_max_abs_err": err}
    out["card_vs_cpu"] = {"scale": 0.002, "shards": 4, **plan_row(lay[cuda]), **parity}
    del lay

    gs = load_dataset("WIKI", scale=0.1, seed=SEED)
    sdg = prepare_sharded_device_graph(gs, BlocksMesh([cuda] * 8), n_blocks=16, halo=True,
                                       halo_threshold=2.0, halo_granularity="vertex")
    rules = {}
    for algo_name, per_step in (("spinner", 8), ("restream", sdg.n_blocks)):
        algo = get_algorithm(algo_name)
        init = algo.init(sdg, algo.config_cls(k=K), torch.Generator(device=cuda).manual_seed(SEED))
        runs = {}
        for sched in ("sharded", "halo"):
            cfg = algo.config_cls(k=K, chunk_schedule=sched)
            runs[sched] = (algo, sdg, cfg, clone_state(torch, init))
        t = time.perf_counter()
        ops.reset_launch_counts()
        row = lockstep(torch, engine, runs, 4, 2, f"{algo_name} halo vs sharded")
        torch.cuda.synchronize()
        counts = ops.launch_counts()
        expect_launches(counts, {"edge_histogram": 2 * 4 * per_step},
                        f"{algo_name} at 8 shards (both schedules)")
        rules[algo_name] = {**row, "k3_per_superstep": per_step, "launches": counts,
                            "seconds": time.perf_counter() - t}
    out["rules"] = {"scale": 0.1, "n": gs.n, "shards": 8, "n_blocks": sdg.n_blocks,
                    **plan_row(sdg), **rules}
    del sdg
    psdg = prepare_sharded_device_graph(
        gs, BlocksMesh([cuda] * 8), n_blocks=SHARD_BLOCKS,
        assignment=np.random.default_rng(SEED + 19).permutation(SHARD_BLOCKS), halo=True,
        halo_threshold=2.0, halo_granularity="vertex")
    out["permuted_shard_kernels"] = {"scale": 0.1, **plan_row(psdg),
                                     **check_shard_kernels(torch, psdg, 3, SEED + 20)}
    out["seconds"] = time.perf_counter() - t0
    return out


def timed_run(torch, ops, run_partitioner, g, **kw):
    """``run_partitioner("revolver", g, K, **kw)`` with every launch counter
    set to 0 just before and read just after; returns (result, wall s,
    launches)."""
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = run_partitioner("revolver", g, K, seed=SEED, **kw)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t, ops.launch_counts()


def sharded_phase(torch, np, ops, g, dev: str = "cuda") -> dict:
    """Phase 17: the sharded, halo and async schedules on Revolver's main
    path, full WIKI, k 8, 32 blocks, sync_every 5, 8 shards on the one card
    (``BlocksMesh([cuda:0] * 8)``: 4 blocks a shard). Every check raises.
    Returns the phase's row."""
    import shutil
    import tempfile

    from repro_torch.core import engine, run_partitioner
    from repro_torch.core.device_graph import (
        device_graph_from_numpy,
        graph_host_arrays,
        plan_layout,
        shard_device_graph,
        shard_host_arrays,
    )
    from repro_torch.core.halo import interior_first_order
    from repro_torch.core.registry import get_algorithm
    from repro_torch.launch.mesh import BlocksMesh

    t0 = time.perf_counter()
    cuda = torch.device(dev, 0 if dev == "cuda" else None)
    nb, shards, window = SHARD_BLOCKS, SHARDS, 5
    revolver = get_algorithm("revolver")
    mesh8 = BlocksMesh([cuda] * shards)
    common = dict(n_blocks=nb, sync_every=window, device=dev)
    out, rates, build = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()

    t = time.perf_counter()
    arrays = graph_host_arrays(g, nb)
    build["host_arrays_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dg = device_graph_from_numpy(arrays, cuda)
    torch.cuda.synchronize()
    build["layout_s"] = time.perf_counter() - t

    # 1. one shard is the sequential schedule: whole runs (labels, probs,
    # steps, history), then every state field over a window on the engine
    seq, wall, _ = timed_run(torch, ops, run_partitioner, g, dg=dg, keep_probs=True, **common)
    rates["sequential"] = seq.steps / wall
    one, wall, _ = timed_run(torch, ops, run_partitioner, g, dg=dg, keep_probs=True,
                             chunk_schedule="sharded", mesh=BlocksMesh([cuda]), **common)
    rates["sharded_1"] = one.steps / wall
    require(np.array_equal(one.labels, seq.labels) and np.array_equal(one.probs, seq.probs)
            and one.steps == seq.steps and one.history == seq.history,
            f"1 shard vs sequential: steps {one.steps}/{seq.steps}")
    sdg1 = shard_device_graph(dg, BlocksMesh([cuda]))
    init = revolver.init(dg, revolver.config_cls(k=K), torch.Generator(device=cuda).manual_seed(SEED))
    one_window = lockstep(torch, engine, {
        "sequential": (revolver, dg, revolver.config_cls(k=K), clone_state(torch, init)),
        "sharded_1": (revolver, sdg1, revolver.config_cls(k=K, chunk_schedule="sharded"),
                      clone_state(torch, init))}, window, window, "1 shard vs sequential")
    out["one_shard"] = {"steps": seq.steps, "lockstep": one_window}
    del sdg1, init

    # 2. 8 shards, contiguous: the main path, through the entry point, at
    # the sequential run's step budget
    sdg8 = shard_device_graph(dg, mesh8)
    res, wall, counts = timed_run(torch, ops, run_partitioner, g, dg=sdg8, mesh=mesh8,
                                  chunk_schedule="sharded", max_steps=seq.steps,
                                  patience=10_000, **common)
    rates["sharded_8"] = res.steps / wall
    expect_launches(counts, {n: nb * res.steps for n in PARTITIONER_KERNELS},
                    "8-shard sharded main path")
    host_metrics(np, g, res)
    require(res.local_edges >= 0.97 * seq.local_edges,
            f"8 shards: local_edges {res.local_edges} < 0.97 x sequential {seq.local_edges}")
    require(res.max_norm_load <= 1.30, f"8 shards: max_norm_load {res.max_norm_load} > 1.30")
    out["main"] = {"steps": res.steps, "local_edges": res.local_edges,
                   "sequential_local_edges": seq.local_edges,
                   "quality_ratio": res.local_edges / seq.local_edges,
                   "max_norm_load": res.max_norm_load, "wall_s": wall, "launches": counts}
    del sdg8, dg

    # 3. halo equals sharded on one layout: the contiguous and locality
    # assignments at both granularities (the locality order keeps the
    # striping on WIKI: then its layouts are the contiguous ones)
    t = time.perf_counter()
    locality = plan_layout(arrays, shards, assignment="locality")[1]
    build["locality_order_s"] = time.perf_counter() - t
    layouts = {}
    variants = [("contiguous-block", "contiguous", "block"),
                ("contiguous-vertex", "contiguous", "vertex")]
    if locality is not None:
        variants += [("locality-block", "locality", "block"),
                     ("locality-vertex", "locality", "vertex")]
    halo_rows = {}
    for name, assignment, gran in variants:
        t = time.perf_counter()
        sdg = shard_host_arrays(arrays, mesh8, assignment=assignment, halo=True,
                                halo_threshold=2.0, halo_granularity=gran)
        torch.cuda.synchronize()
        build[f"{name}_s"] = time.perf_counter() - t
        init = revolver.init(sdg, revolver.config_cls(k=K),
                             torch.Generator(device=cuda).manual_seed(SEED))
        t = time.perf_counter()
        row = lockstep(torch, engine, {
            sched: (revolver, sdg, revolver.config_cls(k=K, chunk_schedule=sched),
                    clone_state(torch, init)) for sched in ("sharded", "halo")},
            2 * window, window, f"halo vs sharded, {name}")
        halo_rows[name] = {**plan_row(sdg), **row, "exchange_bytes": exchange_bytes(sdg, revolver),
                           "seconds": time.perf_counter() - t}
        layouts[name] = sdg
    out["halo_vs_sharded"] = {"locality_is_striping": locality is None, **halo_rows}

    # 4. async at staleness 0 equals halo on the interior-first layout
    # (over 10 supersteps); on WIKI every block reads the tail, so that
    # layout is the contiguous one when interior_first_order changes nothing
    order_perm = interior_first_order(layouts["contiguous-vertex"].halo)
    if order_perm is None:
        asdg = layouts["contiguous-vertex"]
    else:
        t = time.perf_counter()
        asdg = shard_host_arrays(arrays, mesh8, assignment=order_perm, halo=True,
                                 halo_threshold=2.0, halo_granularity="vertex")
        build["interior_first_s"] = time.perf_counter() - t
    init = revolver.init(asdg, revolver.config_cls(k=K),
                         torch.Generator(device=cuda).manual_seed(SEED))
    out["async_vs_halo"] = {"interior_first_reorders": order_perm is not None,
                            **plan_row(asdg), **lockstep(torch, engine, {
                                sched: (revolver, asdg, revolver.config_cls(k=K, chunk_schedule=sched),
                                        clone_state(torch, init)) for sched in ("halo", "async")},
                                2 * window, window, "async vs halo")}
    del init

    # 5. K1 and K3 on shard 3's halo slabs (the locality layout's: on WIKI
    # it keeps the striping, so the ids are permuted by the halo rewrite
    # alone; the side legs check a block-permuted layout at WIKI 0.1)
    out["shard3_kernels"] = check_shard_kernels(
        torch, layouts.get("locality-vertex", layouts["contiguous-vertex"]), 3, SEED + 20)

    # 6. resume, and the rates of halo and async: each uncut (checkpointed
    # every 10), cut at 20, resumed on the same mesh; async at staleness 1
    # also traced (its cut run), the trace validated
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_sharded_"))
    resume = {}
    hsdg = layouts["contiguous-vertex"]
    for sched, extra, layout in (("halo", {}, hsdg), ("async", {"staleness_bound": 1}, asdg)):
        kw = dict(dg=layout, mesh=mesh8, chunk_schedule=sched, keep_probs=True,
                  checkpoint_every=10, **extra, **common)
        ref, wall, counts = timed_run(torch, ops, run_partitioner, g,
                                      checkpoint_dir=str(work / f"{sched}_ref"), **kw)
        expect_launches(counts, {n: nb * ref.steps for n in PARTITIONER_KERNELS},
                        f"{sched} run")
        rates[sched] = ref.steps / wall
        require(ref.local_edges > 0.5 and ref.max_norm_load <= 1.30,
                f"{sched}: local_edges {ref.local_edges}, max_norm_load {ref.max_norm_load}")
        tracer = None
        if sched == "async":
            from repro_torch.obs import Tracer

            tracer = Tracer()
        run_partitioner("revolver", g, K, seed=SEED, checkpoint_dir=str(work / sched),
                        trace=tracer, **dict(kw, max_steps=20))
        res, _, _ = timed_run(torch, ops, run_partitioner, g, checkpoint_dir=str(work / sched),
                              resume=True, **kw)
        require(res.resumed_from == 20 and res.steps == ref.steps
                and np.array_equal(res.labels, ref.labels)
                and np.array_equal(res.probs, ref.probs),
                f"{sched} resume: from {res.resumed_from}, steps {res.steps}/{ref.steps}, "
                f"labels equal {np.array_equal(res.labels, ref.labels)}")
        resume[sched] = {"steps": ref.steps, "local_edges": ref.local_edges,
                         "max_norm_load": ref.max_norm_load, "resumed_from": res.resumed_from,
                         "bit_equal": True, **extra}
        if tracer is not None:
            path = work / "async_trace.json"
            tracer.save(str(path))
            rep = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_report.py"),
                                  str(path), "--validate"], capture_output=True, text=True,
                                 timeout=300)
            require(rep.returncode == 0, f"async trace invalid: {rep.stdout}{rep.stderr}")
            resume[sched]["trace_valid"] = True
            resume[sched]["staleness_series"] = [v for _, v in tracer.series["halo_staleness"]]
    shutil.rmtree(work, ignore_errors=True)
    out["resume"] = resume
    out["supersteps_per_s"] = rates
    out["build_s"] = build
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t0
    return out


# --------------------------------------------------------------------------
# phase 17h: hub replication, elastic restore, the V-cycle's fine level
# --------------------------------------------------------------------------
def max_sm_clock_hz() -> float:
    """The card's maximum SM clock (nvidia-smi), for H1's serial bound."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0]) * 1e6


def h1_state_inputs(torch, sdg, state):
    """H1's inputs at ``state`` of a hub layout, as the engine assembles
    them after a superstep: the merged votes of the shards' label slices,
    the current hub labels, the plan's degrees and owners, a copy of the
    loads and the capacity."""
    from repro_torch.core.device_graph import capacity_device
    from repro_torch.parallel import collectives

    hubs = [sh.hub for sh in sdg.shards]
    h, ln = hubs[0], sdg.local_n
    parts = [state.labels[s * ln:(s + 1) * ln] for s in range(sdg.n_shards)]
    cur = collectives.hub_gather(parts, h.owner, h.local, sdg.mesh)[0]
    votes = collectives.hub_votes(parts, [x.src for x in hubs], [x.slot for x in hubs],
                                  [x.w for x in hubs], h.hub_pad, K, h.owner.device)
    cap = capacity_device(sdg.m, K, 0.05, "spinner", h.owner.device)
    return votes, cur, h.deg, h.owner, state.loads.clone(), cap


def h1_synthetic(torch, np, dev, hub_pad: int, seed: int, *, k: int = K,
                 headroom: float = 0.0, cap: float = 4.0e6, deg_max: int = 2000):
    """A reconcile input of ``hub_pad`` slots (at least 10), k 8: a tenth
    of the slots pad (owner -1, given votes all the same), a fifth with no
    votes, a tenth an exact tie between two labels, the rest random votes;
    degrees 1-2,000 and loads within ~6,000 of the capacity, so moves are
    taken and refused. ``k``, ``cap``, ``deg_max`` and ``headroom`` (taken
    off every load) change the table."""
    rng = np.random.default_rng(seed)
    votes = rng.integers(0, 50, (hub_pad, k)).astype(np.int32)
    kind = rng.random(hub_pad)
    votes[kind < 0.2] = 0
    tie = (kind >= 0.2) & (kind < 0.3)
    ab = np.stack([rng.permutation(k)[:2] for _ in range(int(tie.sum()))])
    votes[tie] = 0
    votes[np.flatnonzero(tie), ab[:, 0]] = 60
    votes[np.flatnonzero(tie), ab[:, 1]] = 60
    owner = rng.integers(0, SHARDS, hub_pad).astype(np.int32)
    owner[-(hub_pad // 10):] = -1
    cur = rng.integers(0, k, hub_pad).astype(np.int32)
    deg = rng.integers(1, deg_max + 1, hub_pad).astype(np.float32)
    cap = np.float32(cap)
    loads = (cap - headroom - rng.integers(0, 6000, k)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (votes, cur, deg, owner, loads)]
    return (*t, torch.tensor(cap, device=dev))


def h1_tables(torch, np, dev) -> dict:
    """H1's other card checks, {name: (inputs, the body it must take)}:
    tables of 20,000 slots that refuse nothing (3M of room a label,
    degrees up to 200) or everything (every load 1M over the capacity),
    one with loads and capacity past 2^24 (the serial body), k 2 and k 64
    (past 32 labels: the serial body), one slot that moves, and a table
    whose every slot already holds its vote's label (no slot flagged)."""
    from repro_torch.kernels import hub_reconcile as h1

    def synthetic(seed, **kw):
        return h1_synthetic(torch, np, dev, 20_000, SEED + seed, **kw)

    settled = list(synthetic(30))
    settled[1] = h1.hub_candidates(settled[0], settled[1], settled[3])[0]
    one = (torch.tensor([[0, 0, 5, 1]], dtype=torch.int32, device=dev),
           torch.tensor([1], dtype=torch.int32, device=dev),
           torch.tensor([7.0], device=dev), torch.tensor([0], dtype=torch.int32, device=dev),
           torch.tensor([40.0, 30.0, 20.0, 10.0], device=dev), torch.tensor(27.5, device=dev))
    return {"refusal_free": (synthetic(24, headroom=3.0e6, deg_max=200), "parallel"),
            "all_refused": (synthetic(25, headroom=-1.0e6), "parallel"),
            "loads_past_2_24": (synthetic(26, cap=3.0e7), "serial"),
            "k_2": (synthetic(27, k=2), "parallel"),
            "k_64": (synthetic(28, k=64), "serial"),
            "hub_pad_1": (one, "parallel"),
            "none_flagged": (tuple(settled), "parallel")}


def check_h1(torch, inputs, what: str, body: str | None = None) -> dict:
    """H1 against its plain version on ``inputs`` (winners and loads
    bit-equal), and two H1 calls bit-equal; the body it took and its rounds
    equal to its schedule's on the host (`hub_reconcile_schedule`), and the
    body ``body`` where given. Returns the check's row."""
    from repro_torch.kernels import hub_reconcile as h1

    votes, cur, deg, owner, loads, cap = inputs
    runs = []
    for fn in (h1.hub_reconcile_cuda_counts, h1.hub_reconcile_cuda, h1.hub_reconcile_plain,
               h1.hub_reconcile_schedule):
        ld = loads.clone()
        runs.append((fn(votes, cur, deg, owner, ld, cap), ld))
    torch.cuda.synchronize()
    ((wa, walk), la), (wb, lb), (wp, lp), ((ws, plan), ls) = runs
    require(torch.equal(wa, wp) and torch.equal(la, lp),
            f"H1 ({what}) differs from its plain version: winners equal "
            f"{torch.equal(wa, wp)}, loads {la.tolist()} vs {lp.tolist()}")
    require(torch.equal(wa, wb) and torch.equal(la, lb), f"H1 ({what}): two calls differ")
    require(torch.equal(ws, wp) and torch.equal(ls, lp),
            f"H1's schedule ({what}) differs from the plain version")
    require(walk == plan, f"H1 ({what}): the kernel's walk {walk}, its schedule's {plan}")
    require(body is None or walk["body"] == body,
            f"H1 ({what}) took the {walk['body']} body, not the {body} one")
    _, flagged = h1.hub_candidates(votes, cur, owner)
    n_flagged, moved = int(flagged.sum()), int((wa != cur).sum())
    top2 = votes.topk(2, dim=1).values
    return {"what": what, "slots": int(votes.shape[0]), "k": int(votes.shape[1]),
            "hubs": int((owner >= 0).sum()), "flagged": n_flagged, "moved": moved,
            "refused": n_flagged - moved, "body": walk["body"], "rounds": walk["rounds"],
            "zero_vote_slots": int((votes.sum(1) == 0).sum()),
            "tied_slots": int(((top2[:, 0] == top2[:, 1]) & (top2[:, 0] > 0)).sum()),
            "bit_equal": True, "two_calls_bit_equal": True}


def h1_record(torch, inputs, flush, launches: int) -> dict:
    """H1's entry of the ``kernels`` line on ``inputs``: eager (as the
    engine calls it) and CUDA-graph-replayed device time, median of 30 with
    the L2 flushed, each call on a fresh copy of the loads (a [k] copy);
    the plain version's time (3 calls: a host loop); the bound: the bytes
    it must move at the HBM rate (the table, cur, deg, owner and winners
    once, the loads read and written), beside the one-thread walk's bound
    (the design before, kept for comparison): those bytes plus one
    dependent shared-memory round trip per flagged slot at the card's
    maximum SM clock; the walk's body and rounds."""
    from repro_torch.kernels import hub_reconcile as h1

    votes, cur, deg, owner, loads, cap = inputs
    ld = loads.clone()

    def kernel():
        ld.copy_(loads)
        return h1.hub_reconcile_cuda(votes, cur, deg, owner, ld, cap)

    def plain():
        ld.copy_(loads)
        return h1.hub_reconcile_plain(votes, cur, deg, owner, ld, cap)

    hub_pad, k = votes.shape
    flagged = int(h1.hub_candidates(votes, cur, owner)[1].sum())
    walk = h1.hub_reconcile_cuda_counts(votes, cur, deg, owner, loads.clone(), cap)[1]
    nbytes = hub_pad * (4 * k + 16) + 8 * k
    t_bytes = nbytes / HBM_BYTES_PER_S
    clock = max_sm_clock_hz()
    t_serial = flagged * SMEM_ROUND_TRIP_CYCLES / clock
    return {"name": "hub_reconcile", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/hub_reconcile.cu",
            "replaces": "src/repro/core/engine.py:373",
            "launches": launches, "max_abs_err": 0.0,
            "ms": time_ms(torch, kernel, flush), "graph_ms": graph_ms(torch, kernel, flush),
            "plain_ms": time_ms(torch, plain, flush, reps=3, warmup=1),
            "bound_ms": t_bytes * 1e3, "bound_by": "bytes",
            "library_ms": None, "slots": hub_pad, "flagged": flagged, "bytes": nbytes,
            "body": walk["body"], "rounds": walk["rounds"],
            "serial_walk_bound_ms": max(t_bytes, t_serial) * 1e3,
            "serial_ms": t_serial * 1e3, "max_sm_clock_hz": clock}


def hub_side_legs(torch, np, ops, dev: str = "cuda") -> dict:
    """Phase 17h's legs off the full graph (run in the host build's wait).
    (1) H1 on a synthetic table of 90,000 slots (ties, slots without votes,
    pad slots, moves refused for capacity) and on `h1_tables`' tables
    against its plain version, two calls bit-equal, its body and rounds
    its schedule's. (2) The V-cycle at WIKI 0.1, k 8, 8 blocks: the
    sequential one, then one whose finest level runs halo with hubs
    (quantile 0.95) on 8 shards of the card, both through
    ``run_partitioner(mode="vcycle")`` on one level stack (built once here,
    answering both runs' ``build_level_stack`` call), every launch counter
    set to 0 just before each run and read just after: K1 and K2 once a
    block and superstep over the levels, H1 once a fine-level superstep;
    quality printed side by side, max_norm_load <= 1.30. ``dev`` names the
    card."""
    from repro_torch.core import multilevel, run_partitioner
    from repro_torch.graphs import load_dataset
    from repro_torch.launch.mesh import BlocksMesh

    t0 = time.perf_counter()
    cuda = torch.device(dev, 0 if dev == "cuda" else None)
    out = {"h1_synthetic": check_h1(torch, h1_synthetic(torch, np, cuda, 90_000, SEED + 21),
                                    "synthetic", "parallel"),
           "h1_tables": {name: check_h1(torch, inputs, name, body)
                         for name, (inputs, body) in h1_tables(torch, np, cuda).items()}}
    gs = load_dataset("WIKI", scale=0.1, seed=SEED)
    t = time.perf_counter()
    stack = multilevel.build_level_stack(gs, multilevel.DEFAULT_COARSE_N)
    coarsen_s = time.perf_counter() - t
    build_level_stack = multilevel.build_level_stack

    def kept(graph, coarse_n, *args, **kwargs):
        require(graph is gs and coarse_n == multilevel.DEFAULT_COARSE_N,
                f"vcycle: build_level_stack(n={graph.n}, coarse_n={coarse_n})")
        return stack

    runs = {}
    multilevel.build_level_stack = kept
    try:
        for name, kw in (("sequential", {}),
                         ("fine_halo_hubs_8", dict(
                             mesh=BlocksMesh([cuda] * SHARDS), chunk_schedule="halo",
                             halo_threshold=2.0, hub_replication=True,
                             hub_quantile=HUB_QUANTILE))):
            res, wall, counts = timed_run(torch, ops, run_partitioner, gs, mode="vcycle",
                                          n_blocks=N_BLOCKS, device=dev, **kw)
            vc = res.vcycle
            launches = sum(b * s for b, s in zip(vc["level_n_blocks"], vc["steps_per_level"]))
            want = {n: launches for n in PARTITIONER_KERNELS}
            if kw:
                want["hub_reconcile"] = vc["steps_per_level"][0]
            expect_launches(counts, want, f"vcycle ({name})")
            host_metrics(np, gs, res)
            require(res.max_norm_load <= 1.30,
                    f"vcycle ({name}): max_norm_load {res.max_norm_load} > 1.30")
            runs[name] = {"local_edges": res.local_edges, "max_norm_load": res.max_norm_load,
                          "fine_steps": res.steps, "steps_per_level": vc["steps_per_level"],
                          "level_n_blocks": vc["level_n_blocks"], "wall_s": wall,
                          "launches": counts}
    finally:
        multilevel.build_level_stack = build_level_stack
    require(runs["fine_halo_hubs_8"]["steps_per_level"][1:]
            == runs["sequential"]["steps_per_level"][1:],
            "vcycle: the coarse levels of the two runs differ")
    out["vcycle"] = {"scale": 0.1, "n": gs.n, "levels": len(stack[0]),
                     "coarsen_s": coarsen_s, **runs,
                     "quality_ratio": (runs["fine_halo_hubs_8"]["local_edges"]
                                       / runs["sequential"]["local_edges"])}
    out["seconds"] = time.perf_counter() - t0
    return out


def hub_plans(g):
    """Phase 17h's two host plans of full WIKI in 32 blocks, hubs at
    quantile 0.95: the 8-shard per-vertex halo plan and the 1-shard plan of
    the sequential hub oracle (the host worker builds them; `hub_phase`
    without a worker calls this)."""
    from repro_torch.core.device_graph import graph_host_arrays, plan_layout
    from repro_torch.core.halo import HubConfig

    arrays = graph_host_arrays(g, SHARD_BLOCKS)
    hubs = HubConfig(quantile=HUB_QUANTILE)
    spec8 = plan_layout(arrays, SHARDS, halo=True, halo_threshold=2.0,
                        halo_granularity="vertex", hubs=hubs)[2]
    spec1 = plan_layout(arrays, 1, halo=True, halo_threshold=2.0, hubs=hubs)[2]
    return spec8, spec1


def hub_phase(torch, np, ops, g, *, seq_steps: int, sharded_le: float, host=None,
              dev: str = "cuda") -> tuple[dict, dict]:
    """Phase 17h: hub replication on Revolver's main path, full WIKI in 32
    blocks, k 8, sync_every 5, hubs at outdegree quantile 0.95 (the host
    plans from the worker, built while phases 9-17 ran). (1) A 1-shard halo
    hub run equals the sequential hub oracle, every state field over 2
    windows of 5 supersteps. (2) 8 shards on the card, halo (per-vertex
    plan) with hubs, through ``run_partitioner`` at phase 17's sequential
    step budget (``seq_steps``): local_edges >= 0.90x phase 17's 8-shard
    sharded run (``sharded_le``), max_norm_load <= 1.30, K1 and K2 32 times
    and H1 once a superstep. (3) The same under async at staleness 1. (4)
    H1 against its plain version at the state 10 hub supersteps give, two
    calls bit-equal, then timed (`h1_record`). (5) Elastic restore: a
    checkpoint written by the 8-shard hub run at superstep 20, restored
    onto 4 shards (sharded) and onto 1 (sequential), each capped at 20:
    labels and probabilities bit-equal. Returns (the phase's row, H1's
    ``kernels`` record)."""
    import shutil
    import tempfile

    from repro_torch.core import engine, run_partitioner
    from repro_torch.core.device_graph import (
        device_graph_from_numpy,
        graph_host_arrays,
        hub_oracle_slabs,
        shard_device_graph,
        sharded_layout,
    )
    from repro_torch.core.registry import get_algorithm
    from repro_torch.launch.mesh import BlocksMesh

    t0 = time.perf_counter()
    cuda = torch.device(dev, 0 if dev == "cuda" else None)
    nb, window = SHARD_BLOCKS, 5
    revolver = get_algorithm("revolver")
    mesh8 = BlocksMesh([cuda] * SHARDS)
    common = dict(n_blocks=nb, sync_every=window, device=dev)
    hub_kw = dict(halo_threshold=2.0, hub_replication=True, hub_quantile=HUB_QUANTILE)
    out, rates, build = {}, {}, {}
    torch.cuda.reset_peak_memory_stats()

    t = time.perf_counter()
    arrays = graph_host_arrays(g, nb)
    build["host_arrays_s"] = time.perf_counter() - t
    t = time.perf_counter()
    if host is None:
        spec8, spec1 = hub_plans(g)
    else:
        spec8, spec1, build["worker_plan_s"] = host.hub_plans()
    build["plan_wait_s"] = time.perf_counter() - t
    t = time.perf_counter()
    dg = device_graph_from_numpy(arrays, cuda)
    del arrays
    sdg8 = sharded_layout(dg, mesh8, None, spec8)
    sdg1 = sharded_layout(dg, BlocksMesh([cuda]), None, spec1)
    oracle = hub_oracle_slabs(dg, spec1)
    torch.cuda.synchronize()
    build["upload_s"] = time.perf_counter() - t
    xb = exchange_bytes(sdg8, revolver)
    vote_bytes = spec8.hub_sync_elems_per_device(K, len(revolver.vertex_fields)) * 4
    out["plan"] = {**plan_row(sdg8), "hub_count": spec8.n_hubs, "hub_pad": spec8.hub_pad,
                   "he_max": spec8.he_max, "replica_vote_bytes": vote_bytes,
                   "exchange_bytes": xb,
                   "per_device_bytes_with_hubs": xb["per_device"] + vote_bytes}

    # 1. one shard is the sequential hub oracle, every state field
    cfg_seq, cfg_halo = revolver.config_cls(k=K), revolver.config_cls(k=K, chunk_schedule="halo")
    init = revolver.init(dg, cfg_seq, torch.Generator(device=cuda).manual_seed(SEED))
    out["one_shard_vs_oracle"] = lockstep(torch, engine, {
        "sequential-hub-oracle": (revolver, dg, cfg_seq, clone_state(torch, init), oracle),
        "halo-1-shard": (revolver, sdg1, cfg_halo, clone_state(torch, init))},
        2 * window, window, "1-shard hub vs the sequential hub oracle")
    del sdg1, oracle

    # 2. and 3. 8 shards, halo then async (staleness 1), through the entry
    # point at phase 17's step budget
    h1_launches = 0
    for sched, extra in (("halo", {}), ("async", {"staleness_bound": 1})):
        res, wall, counts = timed_run(torch, ops, run_partitioner, g, dg=sdg8, mesh=mesh8,
                                      chunk_schedule=sched, max_steps=seq_steps,
                                      patience=10_000, **extra, **hub_kw, **common)
        expect_launches(counts, {**{n: nb * res.steps for n in PARTITIONER_KERNELS},
                                 "hub_reconcile": res.steps}, f"8-shard {sched} hub run")
        host_metrics(np, g, res)
        require(res.local_edges >= 0.90 * sharded_le,
                f"8-shard {sched} hubs: local_edges {res.local_edges} < 0.90 x sharded "
                f"{sharded_le}")
        require(res.max_norm_load <= 1.30,
                f"8-shard {sched} hubs: max_norm_load {res.max_norm_load} > 1.30")
        rates[f"{sched}_hubs"] = res.steps / wall
        if sched == "halo":
            h1_launches = counts["hub_reconcile"]
        out[sched] = {"steps": res.steps, "local_edges": res.local_edges,
                      "quality_vs_sharded": res.local_edges / sharded_le,
                      "max_norm_load": res.max_norm_load, "wall_s": wall,
                      "launches": counts, **extra}

    # 4. H1 at a mid-run state of the 8-shard hub layout
    st = engine.place_state(revolver, revolver.init(
        sdg8, cfg_halo, torch.Generator(device=cuda).manual_seed(SEED)), sdg8)
    for _ in range(10):
        st = engine.superstep(revolver, sdg8, cfg_halo, st)
    inputs = h1_state_inputs(torch, sdg8, st)
    out["h1_mid_run"] = check_h1(torch, inputs, "full WIKI after 10 hub supersteps")
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device=cuda)
    record = h1_record(torch, inputs, flush, h1_launches)
    del flush, inputs, st

    # 5. elastic restore: written on 8 shards at 20, restored onto 4 and 1
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_elastic_"))
    ck = dict(checkpoint_dir=str(work), checkpoint_every=10, keep_probs=True, max_steps=20,
              patience=10_000)
    cut = run_partitioner("revolver", g, K, seed=SEED, dg=sdg8, mesh=mesh8,
                          chunk_schedule="halo", **hub_kw, **ck, **common)
    elastic = {}
    mesh4 = BlocksMesh([cuda] * 4)
    for name, kw in (("4_shards", dict(dg=shard_device_graph(dg, mesh4), mesh=mesh4,
                                       chunk_schedule="sharded")),
                     ("1_shard", dict(dg=dg))):
        r = run_partitioner("revolver", g, K, seed=SEED, resume=True, **kw, **ck, **common)
        require(r.resumed_from == 20 and r.steps == 20
                and np.array_equal(r.labels, cut.labels) and np.array_equal(r.probs, cut.probs),
                f"elastic restore 8 -> {name}: from {r.resumed_from}, labels equal "
                f"{np.array_equal(r.labels, cut.labels)}")
        elastic[name] = {"resumed_from": r.resumed_from, "bit_equal": True}
    shutil.rmtree(work, ignore_errors=True)
    out["elastic_restore"] = {"written_on": SHARDS, "step": 20, **elastic}
    out["supersteps_per_s"] = rates
    out["build_s"] = build
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t0
    return out, record


def k3_timed(torch, dg, flush, seed: int) -> dict:
    """K3 at the main path's two shapes, Spinner's launch over all blocks
    and restream's block 0, on random labels: the span kernel in the slots
    form (the TPU kernel's signature; its ``ms`` is the kernel table's) and
    the gather form (labels[dst] read in-kernel, as the rules call it),
    each held bit-equal to the plain version on the card and two calls
    bit-equal, then timed as K4-K6 are (graph replay) beside the gather
    ``labels[dst]`` that the slots form needs first (a separate kernel in
    the rules before the gather form), the row walk (the float route, the
    parent's design) on the same slots, and one ``index_put_`` call as the
    yardstick. Returns {shape label: numbers}."""
    from repro_torch.kernels import edge_histogram as k3

    dev = dg.device
    gen = torch.Generator(device=dev).manual_seed(seed)
    labels = torch.randint(0, K, (dg.n_pad,), generator=gen, device=dev, dtype=torch.int32)
    bv = dg.block_v
    out = {}
    for label, nb in (("spinner", dg.n_blocks), ("restream", 1)):
        spans = dg.blk_spans if nb == dg.n_blocks else dg.blk_spans.block(0)
        dst, rows, vals, row_ptr = (dg.blk_dst[:nb], dg.blk_row[:nb], dg.blk_w[:nb],
                                    dg.blk_row_ptr[:nb])
        slots = labels[dst]
        calls = {
            "slots": lambda: k3.edge_histogram_spans_cuda(  # noqa: E731
                slots, vals, row_ptr, spans, block_v=bv, k=K),
            "gather": lambda: k3.edge_histogram_spans_cuda(  # noqa: E731
                dst, vals, row_ptr, spans, block_v=bv, k=K, labels=labels),
            "row walk": lambda: k3.edge_histogram_cuda(  # noqa: E731
                slots, vals, row_ptr, block_v=bv, k=K),
        }
        want = k3.edge_histogram_plain(slots, rows, vals, block_v=bv, k=K)
        for form, fn in calls.items():
            got, again = fn(), fn()
            torch.cuda.synchronize()
            require(torch.equal(got, want), f"K3 {form} at the {label} shape differs from plain")
            require(torch.equal(got, again), f"K3 {form} at the {label} shape: two calls differ")
        err = max_err(torch, got, want)
        del got, again, want
        live = int((vals > 0).sum())
        nbytes = live * 8 + nb * (bv + 1) * 4 + nb * bv * K * 4
        bound_ms, bound_by = bound(nbytes, live, F32_FLOPS)
        gather_bytes = nbytes + dg.n_pad * 4          # the labels, read once
        gather_bound_ms, _ = bound(gather_bytes, live, F32_FLOPS)
        flat_rows = (rows.long() + torch.arange(nb, device=dev)[:, None] * bv).reshape(-1)
        index = (flat_rows, slots.long().reshape(-1))
        flat_vals = vals.reshape(-1)
        out[label] = {
            "max_abs_err": err, "ms": graph_ms(torch, calls["slots"], flush),
            "plain_ms": graph_ms(torch, lambda: k3.edge_histogram_plain(
                slots, rows, vals, block_v=bv, k=K), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": graph_ms(torch, lambda: torch.zeros(
                (nb * bv, K), device=dev).index_put_(index, flat_vals, accumulate=True),
                flush),
            "eager_ms": time_ms(torch, calls["slots"], flush),
            "gather_ms": graph_ms(torch, calls["gather"], flush),
            "gather_eager_ms": time_ms(torch, calls["gather"], flush),
            "gather_bound_ms": gather_bound_ms,
            "slot_gather_alone_ms": graph_ms(torch, lambda: labels[dst], flush),
            "row_walk_ms": graph_ms(torch, calls["row walk"], flush),
            "shape": f"slabs [{nb},{dg.e_max}] ({live} live entries), block_v {bv}, k {K}",
            "bytes": nbytes, "gather_bytes": gather_bytes, "live_entries": live,
            "spans": int(spans.spans.shape[1]), "hub_rows": int(spans.hubs.shape[1]),
        }
        del slots, index, flat_rows, calls
    return out


def profile_phase(torch, dg, algo: str = "revolver", steps: int = 3):
    """Device busy share and device time by kernel over a few supersteps of
    ``algo``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import engine
    from repro_torch.core.registry import get_algorithm
    from repro_torch.core.revolver import make_generator

    algorithm = get_algorithm(algo)
    cfg = algorithm.config_cls(k=K)
    state = algorithm.init(dg, cfg, make_generator(SEED + 1, dg.device))
    state = engine.superstep(algorithm, dg, cfg, state)          # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            state = engine.superstep(algorithm, dg, cfg, state)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    return {"supersteps": steps, "wall_ms_per_superstep": wall_us / steps / 1e3,
            **device_busy(prof, wall_us, steps, "superstep")}


def device_busy(prof, wall_us: float, steps: int, unit: str) -> dict:
    """Device busy time and share (union of kernel spans over the wall),
    kernels and the top device time by kernel, per step."""
    spans, by_name = [], {}
    for e in prof.events():
        if str(getattr(e, "device_type", "")).endswith("CUDA"):
            spans.append((e.time_range.start, e.time_range.end))
            by_name[e.name] = by_name.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    busy = 0.0
    cur_s = cur_e = None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {
        f"device_busy_ms_per_{unit}": busy / steps / 1e3 if spans else None,
        "device_busy_share": busy / wall_us if spans else None,
        f"device_kernels_per_{unit}": len(spans) / steps,
        # [name, ms] pairs, names cut to 100 characters: templated kernel
        # names run to kilobytes and would push earlier lines out of a
        # tail-truncated log
        f"top_device_ms_per_{unit}": [[n[:100], t / steps / 1e3] for n, t in top],
    }


def max_err(torch, a, b) -> float:
    return float((a.float() - b.float()).abs().max()) if a.numel() else 0.0


def check_close(torch, got, want, tol: dict, what: str) -> float:
    err = max_err(torch, got, want)
    require(torch.allclose(got.float(), want.float(), **tol),
            f"{what}: max abs err {err} beyond {tol}")
    return err


def check_rows(torch, got, want, rel_tol: float, what: str) -> dict:
    """``got`` against ``want`` row by row over the last axis: each row's
    ||got - want|| / ||want|| within ``rel_tol``. Returns the largest of
    those, the whole tensor's relative L2 error and the max abs error."""
    diff = (got.float() - want.float()).flatten(0, -2)
    ref = want.float().flatten(0, -2)
    row = diff.norm(dim=-1) / ref.norm(dim=-1).clamp_min(1e-30)
    out = {"max_abs_err": max_err(torch, got, want), "max_row_rel_err": float(row.max()),
           "rel_l2_err": float(diff.norm() / ref.norm()), "row_rel_tol": rel_tol}
    require(out["max_row_rel_err"] <= rel_tol, f"{what}: {out}")
    return out


def attention_f64(torch, q, k, v, mask):
    """Masked-softmax attention in f64 on [B,H,Sq,D] / [B,Hkv,Sk,D]; mask
    broadcasts to [B,1,Sq,Sk]; rows without a valid key give 0."""
    rep = q.shape[1] // k.shape[1]
    kf, vf = (t.double().repeat_interleave(rep, dim=1) for t in (k, v))
    s = torch.einsum("bhqd,bhkd->bhqk", q.double(), kf) / q.shape[-1] ** 0.5
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1).nan_to_num(0.0)
    return torch.einsum("bhqk,bhkd->bhqd", p, vf)


def attention_small_checks(torch) -> dict:
    """K4 and K5 on small odd shapes on the card against their plain
    versions on the CPU, f32 and bf16."""
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4

    gen = torch.Generator().manual_seed(SEED)
    errs = {}
    k4_cases = [  # b, hq, hkv, sq, skv, d, causal, window
        (2, 8, 8, 67, 67, 64, True, None),      # group 1, ragged
        (1, 8, 2, 100, 100, 32, True, None),    # group 4
        (2, 16, 2, 64, 130, 64, True, None),    # group 8, Sq < Skv
        (1, 8, 1, 200, 200, 16, True, 50),      # group 8, window
        (1, 4, 2, 33, 70, 128, False, None),    # d 128, no mask
        (1, 4, 4, 80, 40, 64, True, None),      # Sq > Skv: rows without keys
        (1, 8, 2, 96, 96, 64, False, 20),       # window without causality
        # the tensor-core body's edges (bf16 at D 64 and 128)
        (1, 4, 1, 129, 129, 64, True, None),    # ragged q and kv tiles, diagonal
        (1, 4, 2, 255, 255, 128, True, None),
        (1, 4, 1, 1025, 1025, 64, True, None),
        (2, 8, 2, 1, 1000, 64, True, None),     # one query row against 1000 keys
        (1, 16, 2, 300, 300, 128, True, 100),   # D 128, group 8, window across kv tiles
        (1, 8, 2, 300, 100, 128, True, None),   # Sq > Skv at D 128: rows without keys
        # MLA's head widths: 24 (reduced configs, SIMT) and 192 (DeepSeek-V2,
        # bf16 on the tensor-core body: three 64-column boxes, N 192)
        (1, 4, 4, 67, 67, 24, True, None),      # ragged
        (2, 4, 2, 37, 90, 24, True, None),      # group 2, Sq < Skv
        (1, 4, 4, 129, 129, 192, True, None),   # ragged q and kv tiles, diagonal
        (1, 4, 2, 300, 300, 192, True, 100),    # group 2, window across kv tiles
        (2, 3, 3, 1, 257, 192, True, None),     # one query row against 257 keys
        (1, 2, 2, 200, 70, 192, True, None),    # Sq > Skv: rows without keys
        (1, 2, 2, 65, 65, 192, False, None),    # no mask
        # h2o-danube-3-4b's head width 120 and zamba2-7b's shared-attention
        # 224 (bf16 on the tensor-core body, padded to 128 and 256 in shared
        # memory by TMA's zero fill; f32 on the SIMT body at 2 and 4 threads
        # a row)
        (1, 4, 1, 129, 129, 120, True, None),   # group 4, ragged q and kv tiles
        (1, 4, 4, 1025, 1025, 120, True, None), # group 1
        (1, 8, 2, 300, 300, 120, True, 100),    # group 4, window across kv tiles
        (2, 4, 1, 1, 1000, 120, True, None),    # one query row against 1000 keys
        (1, 4, 1, 70, 200, 120, True, 64),      # Sq < Skv under a window
        (1, 4, 4, 129, 129, 224, True, None),   # group 1, ragged
        (1, 4, 1, 1025, 1025, 224, True, None), # group 4
        (1, 4, 4, 300, 300, 224, True, 100),    # group 1, window across kv tiles
        (2, 4, 4, 1, 1000, 224, True, None),    # one query row against 1000 keys
        (1, 2, 2, 200, 70, 224, True, None),    # Sq > Skv: rows without keys
        # whisper-base's encoder and cross-attention (no mask; 1500 keys are
        # 23 whole 64-key tiles and a ragged one), internvl2-1b's group 7 at
        # D 64 and command-r-plus-104b's group 12 at D 128 (causal)
        (1, 2, 2, 1500, 1500, 64, False, None),  # Sq = Skv = 1500, group 1
        (2, 4, 4, 64, 1500, 64, False, None),    # the cross prefill: Sq 64 against 1500
        (2, 4, 4, 1, 1500, 64, False, None),     # one query row against 1500
        (1, 14, 2, 300, 300, 64, True, None),    # group 7, ragged
        (2, 7, 1, 100, 257, 64, True, None),     # group 7, Sq < Skv
        (1, 24, 2, 200, 200, 128, True, None),   # group 12, ragged
    ]
    k5_cases = [  # b, hq, hkv, s, d, kv_len
        (4, 8, 8, 300, 64, [0, 1, 300, 157]),           # group 1
        (3, 16, 4, 1000, 32, [999, 1, 513]),            # group 4
        (5, 32, 4, 1152, 64, [1088, 0, 1, 1152, 700]),  # group 8
        (2, 8, 1, 77, 128, [77, 40]),                   # group 8, d 128
        (2, 4, 2, 64, 16, [64, 3]),                     # d 16
        (4, 8, 2, 300, 120, [0, 1, 300, 157]),          # d 120, group 4
        (4, 4, 4, 300, 224, [0, 1, 300, 157]),          # d 224, group 1
        # whisper-base's cross cache: 1500 rows (no whole number of
        # SPLIT_ROWS), full, one short and mixed; internvl2-1b's group 7 and
        # command-r-plus-104b's group 12 at D 128
        (4, 8, 8, 1500, 64, [1500, 1499, 1, 777]),
        (3, 14, 2, 1152, 64, [1024, 1, 1152]),          # group 7
        (3, 24, 2, 1152, 128, [1024, 0, 1151]),         # group 12, d 128
    ]
    # kv_len on both sides of a split boundary, and kv_len = S at the most
    # splits (MAX_SPLITS), from the plan the wrapper takes on this card
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    for b, hq, hkv, s, d in ((4, 16, 2, 1152, 64), (4, 8, 1, 768, 128),
                             (4, 16, 4, 1024, 120), (4, 8, 8, 1024, 224)):
        n_split, chunk = k5.split_plan(b, hkv, s, n_sm)
        require(n_split == k5.MAX_SPLITS, f"split plan {n_split} x {chunk} for S {s}")
        k5_cases.append((b, hq, hkv, s, d, [chunk, chunk + 1, chunk - 1, s]))
    # whisper-base's cross decode at its serving plan: the last split ends at
    # row 1500, inside a SPLIT_ROWS run; kv_len on both sides of its start
    n_split, chunk = k5.split_plan(8, 8, 1500, n_sm)
    last = chunk * (n_split - 1)
    require(last < 1500 < chunk * n_split, f"split plan {n_split} x {chunk} for S 1500")
    k5_cases.append((8, 8, 8, 1500, 64, [1500, 1499, last, last + 1, last - 1, chunk, 1, 0]))
    for dtype in (torch.float32, torch.bfloat16):
        tol = ATTN_TOL[str(dtype).split(".")[1]]
        for b, hq, hkv, sq, skv, d, causal, window in k4_cases:
            q = torch.randn((b, hq, sq, d), generator=gen).to(dtype)
            k = torch.randn((b, hkv, skv, d), generator=gen).to(dtype)
            v = torch.randn((b, hkv, skv, d), generator=gen).to(dtype)
            got = k4.flash_attention_cuda(q.cuda(), k.cuda(), v.cuda(),
                                          causal=causal, window=window)
            want = k4.flash_attention_plain(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            name = f"k4 {dtype} {(b, hq, hkv, sq, skv, d, causal, window)}"
            errs[name] = check_close(torch, got.cpu(), want, tol, name)
            require(got.dtype == dtype, f"{name}: output dtype {got.dtype}")
            require(torch.equal(got, k4.flash_attention_cuda(q.cuda(), k.cuda(), v.cuda(),
                                                             causal=causal, window=window)),
                    f"{name}: two calls differ")
            if dtype == torch.float32:
                mask = k4.attention_mask(sq, skv, causal=causal, window=window, device="cpu")
                exact = attention_f64(torch, q, k, v, mask)
                check_close(torch, got.cpu().double(), exact, EXACT_TOL, f"{name} vs f64")
        for b, hq, hkv, s, d, lens in k5_cases:
            q = torch.randn((b, hq, d), generator=gen).to(dtype)
            kc = torch.randn((b, hkv, s, d), generator=gen).to(dtype)
            vc = torch.randn((b, hkv, s, d), generator=gen).to(dtype)
            kv_len = torch.tensor(lens, dtype=torch.int32)
            got = k5.decode_attention_cuda(q.cuda(), kc.cuda(), vc.cuda(),
                                           kv_len.cuda(), return_lse=True)
            want = k5.decode_attention_plain(q, kc, vc, kv_len, return_lse=True)
            torch.cuda.synchronize()
            name = f"k5 {dtype} {(b, hq, hkv, s, d, lens)}"
            for part, a, w in zip("oml", got, want):
                t = tol if part == "o" else ATTN_TOL["float32"]
                errs[f"{name} {part}"] = check_close(torch, a.cpu(), w, t, f"{name} {part}")
            if dtype == torch.float32:
                mask = (torch.arange(s)[None, :] < kv_len[:, None])[:, None, None, :]
                exact = attention_f64(torch, q[:, :, None], kc, vc, mask)[:, :, 0]
                check_close(torch, got[0].cpu().double(), exact, EXACT_TOL, f"{name} vs f64")
            empty = kv_len == 0
            require(bool((got[0].cpu()[empty] == 0).all() and (got[2].cpu()[empty] == 0).all()
                         and (got[1].cpu()[empty] == -1e30).all()),
                    f"{name}: kv_len 0 must give o = 0, m = -1e30, l = 0")
            # positions past kv_len are never read: NaN there changes nothing
            pos = torch.arange(s)[None, None, :, None]
            poison = (pos >= kv_len[:, None, None, None]).cuda()
            again = k5.decode_attention_cuda(
                q.cuda(), kc.cuda().masked_fill(poison, float("nan")),
                vc.cuda().masked_fill(poison, float("nan")), kv_len.cuda())
            require(torch.equal(again, got[0]), f"{name}: reads past kv_len")
    return {"cases": len(errs), "max_abs_err": max(errs.values())}


def cache_tensors(cache):
    """(name, tensor) for every tensor of an LM cache, nested tuples
    flattened (the hybrid's ``ssm`` is (state, (conv_x, conv_bc)))."""
    items = cache.items() if isinstance(cache, dict) else enumerate(cache)
    for key, val in items:
        name = key if isinstance(cache, dict) else f"[{key}]"
        if isinstance(val, tuple):
            for sub, t in cache_tensors(val):
                yield f"{name}{sub}", t
        else:
            yield name, val


def randomize_params(torch, model, seed: int) -> None:
    """Replace every parameter of ``model`` (on the CPU) by seeded draws
    around it, N(p, std(p)^2) (std 0.1 for a constant one; Mamba2's
    ``A_log`` and ``dt_bias`` uniform in [-1, 0.5], where the decays stay
    finite), so that constant leaves of the init (norm scales, LoRA ``b``,
    D, the conv biases) carry signal."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("A_log", "dt_bias")):
                p.copy_(torch.rand(p.shape, generator=gen) * 1.5 - 1.0)
            else:
                std = float(p.float().std()) if p.numel() > 1 else 0.0
                p.add_(torch.randn(p.shape, generator=gen).to(p.dtype) * (std or 0.1))


def reduced_lm_parity(torch, arch: str, overrides: dict, b: int = 3, s: int = 37) -> dict:
    """A reduced config in f32: prefill (ragged prompt) and 8 greedy decode
    steps on the card (kernels) against the CPU (plain versions), from one
    set of weights, every leaf of the init redrawn by `randomize_params`;
    every cache tensor compared at the end."""
    import copy

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_cache, init_lm, lm_decode_step, lm_prefill

    cfg = get_config(arch).reduced(**overrides)
    cpu = init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
    randomize_params(torch, cpu, SEED + 9)
    card = copy.deepcopy(cpu).to("cuda")
    steps = 8
    gen = torch.Generator().manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab, (b, s), dtype=torch.int32, generator=gen)
    batch = {"tokens": toks}
    if cfg.family in ("vlm", "encdec"):      # the stub patches or frames
        batch["frontend"] = torch.randn((b, cfg.n_patches or cfg.enc_seq, cfg.d_model),
                                        generator=gen)
    s_max = cfg.n_patches + s + steps
    with torch.inference_mode():
        lc, cc = lm_prefill(cpu, cfg, init_cache(cfg, b, s_max, "cpu"), batch)
        lg, cg = lm_prefill(card, cfg, init_cache(cfg, b, s_max, "cuda"),
                            {k: t.cuda() for k, t in batch.items()})
        errs = [check_close(torch, lg.cpu(), lc, LM_TOL, f"{arch} reduced prefill logits")]
        for i in range(steps):
            tc, tg = lc.argmax(-1).int(), lg.argmax(-1).int().cpu()
            require(torch.equal(tc, tg), f"{arch} reduced greedy token differs at step {i}")
            lc, cc = lm_decode_step(cpu, cfg, cc, tc)
            lg, cg = lm_decode_step(card, cfg, cg, tg.cuda())
            errs.append(check_close(torch, lg.cpu(), lc, LM_TOL,
                                    f"{arch} reduced decode {i} logits"))
        for (name, got), (_, want) in zip(cache_tensors(cg), cache_tensors(cc)):
            errs.append(check_close(torch, got.cpu(), want, LM_TOL, f"{arch} reduced cache {name}"))
    args = ", ".join(f"{k}={v}" for k, v in overrides.items())
    return {"config": f"{arch} reduced({args}) f32", "prompt": s,
            "decode_steps": steps, "cache_tensors": len(list(cache_tensors(cg))),
            "max_abs_err": max(errs), "tol": LM_TOL}


def full_width_model(torch, arch: str, dtype: str | None = None, serve: dict = SERVE,
                     **changes):
    """``arch`` at full width in its own dtype (bf16) or ``dtype`` (and the
    config ``changes``, e.g. a cut depth), random weights from SEED on the
    card, and random prompts of serve["prompt"] + 1 tokens."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_lm

    cfg = dataclasses.replace(get_config(arch), **changes)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    model = init_lm(cfg, gen, "cuda")
    toks = torch.randint(0, cfg.vocab, (serve["batch"], serve["prompt"] + 1),
                         generator=gen, device="cuda", dtype=torch.int32)
    n_params = sum(p.numel() for p in model.parameters())
    return cfg, model, toks, n_params


def stub_frontend(torch, cfg, batch: int):
    """A VLM's patch or an encoder-decoder's frame embeddings [B, n_patches
    | enc_seq, d] in the compute dtype, drawn from SEED + 5 on the card."""
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    return torch.randn((batch, cfg.n_patches or cfg.enc_seq, cfg.d_model), generator=gen,
                       device="cuda").to(cfg.cdt)


def next_model(torch) -> None:
    """Free what the previous phase's model left in the allocator's cache
    (its references are dropped by the caller) and reset the peak memory
    statistics, before the next phase loads its model."""
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def front(frontend) -> dict:
    """The batch entries of a stub frontend (none without one)."""
    return {} if frontend is None else {"frontend": frontend}


def consistency_logits(torch, cfg, model, toks, serve: dict = SERVE, frontend=None):
    """(decode logits, prefill(P+1) logits): prefill(P) + decode(token P+1)
    against prefill(P+1) at the serving batch (after the same ``frontend``),
    all three finite."""
    from repro_torch.models import init_cache, lm_decode_step, lm_prefill

    p = serve["prompt"]
    with torch.inference_mode():
        cache = init_cache(cfg, serve["batch"], serve["s_max"], "cuda")
        first, cache = lm_prefill(model, cfg, cache, {"tokens": toks[:, :p], **front(frontend)})
        dec, cache = lm_decode_step(model, cfg, cache, toks[:, p])
        del cache
        whole, _ = lm_prefill(model, cfg, init_cache(cfg, serve["batch"], serve["s_max"], "cuda"),
                              {"tokens": toks, **front(frontend)})
    for name, t in (("prefill", first), ("decode", dec), ("prefill+1", whole)):
        require(bool(torch.isfinite(t).all()), f"full-width {name} logits not finite")
    return dec, whole


def consistency_gate(torch, cfg, dec, whole, *, rel_tol: float = FULL_REL_TOL,
                     same_argmax: bool = False, rows=None) -> dict:
    """Decode logits against prefill(P+1)'s within ``rel_tol`` relative L2.
    The greedy token must agree on every row whose top-two gap in
    prefill(P+1) is larger than one ulp of its top logit in the compute
    dtype (``near_ties`` counts the rows within that gap); with
    ``same_argmax`` it must agree on every row. ``tie_gap`` is the largest
    amount by which prefill(P+1) prefers its own greedy token to the
    decode's. ``rows`` (bool [B]) limits the gate to those rows."""
    if rows is not None:
        require(bool(rows.any()), "full-width decode vs prefill: no row left to hold")
        dec, whole = dec[rows], whole[rows]
    rel = float((dec - whole).norm() / whole.norm())
    same = dec.argmax(-1) == whole.argmax(-1)
    agree = float(same.float().mean())
    gap = whole.amax(-1) - whole.gather(1, dec.argmax(-1, keepdim=True))[:, 0]
    top2 = whole.float().topk(2, dim=-1).values
    ulp = torch.exp2(torch.floor(torch.log2(top2[:, 0].abs().clamp_min(1e-30)))) \
        * torch.finfo(cfg.cdt).eps
    decided = top2[:, 0] - top2[:, 1] > ulp
    if same_argmax:
        decided = torch.ones_like(decided)
    require(rel < rel_tol, f"full-width decode vs prefill: relative error {rel}")
    require(bool(same[decided].all()),
            f"full-width decode vs prefill: greedy argmax agrees on {agree} of the rows, "
            f"and differs on a row that is not a near-tie")
    return {"dtype": str(cfg.cdt), "rel_l2_err": rel, "max_abs_err": max_err(torch, dec, whole),
            "logit_abs_max": float(whole.abs().max()), "argmax_agree": agree,
            "near_ties": int((~decided).sum()), "tie_gap": float(gap.max()),
            "tol_rel_l2": rel_tol}


def full_width_consistency(torch, cfg, model, toks, *, rel_tol: float = FULL_REL_TOL,
                           same_argmax: bool = False, serve: dict = SERVE,
                           frontend=None) -> dict:
    """`consistency_gate` on `consistency_logits`: prefill(P) +
    decode(token P+1) logits against prefill(P+1)'s."""
    dec, whole = consistency_logits(torch, cfg, model, toks, serve, frontend)
    return consistency_gate(torch, cfg, dec, whole, rel_tol=rel_tol, same_argmax=same_argmax)


class AttentionShapes:
    """While active, every launch of K4 or K5 (their CUDA wrappers, which
    `ops` calls) is also tallied by its shape: ``counts[key]`` with
    `k4_key` / `k5_key`. The launch counters stay the record; this splits
    them by shape."""

    def __enter__(self):
        from repro_torch.kernels import decode_attention as k5
        from repro_torch.kernels import flash_attention as k4

        self.counts: dict = collections.Counter()
        self._orig = (k4.flash_attention_cuda, k5.decode_attention_cuda)
        f4, f5 = self._orig

        def k4_tally(q, k, v, *, causal=True, window=None):
            out = f4(q, k, v, causal=causal, window=window)
            self.counts[k4_key(q.shape, k.shape, causal)] += 1
            return out

        def k5_tally(q, k_cache, v_cache, kv_len, *, return_lse=False):
            out = f5(q, k_cache, v_cache, kv_len, return_lse=return_lse)
            self.counts[k5_key(q.shape, k_cache.shape)] += 1
            return out

        self._mods = (k4, k5)
        k4.flash_attention_cuda, k5.decode_attention_cuda = k4_tally, k5_tally
        return self

    def __exit__(self, *exc):
        k4, k5 = self._mods
        k4.flash_attention_cuda, k5.decode_attention_cuda = self._orig
        return False


def k4_key(q_shape, kv_shape, causal: bool) -> str:
    return f"k4 q{list(q_shape)} kv{list(kv_shape)} {'causal' if causal else 'no mask'}"


def k5_key(q_shape, cache_shape) -> str:
    return f"k5 q{list(q_shape)} cache{list(cache_shape)}"


def serve_phase(torch, ops, cfg, model, toks, want: dict, serve: dict = SERVE,
                frontend=None) -> tuple[dict, dict]:
    """The serving main path through `Engine.generate` (after ``frontend``,
    a VLM's patches or an encoder-decoder's frames), timed; ``want`` is
    each kernel's launch count in the generate call (others must be 0). A
    second generate must give bit-equal tokens and log-probabilities; it
    also splits K4's and K5's launches by shape (``attention_shapes``),
    which must sum to the first generate's counts."""
    from repro_torch.serve import Engine

    prompts = toks[:, :serve["prompt"]].contiguous()
    eng = Engine(cfg, model, s_max=serve["s_max"])
    eng.generate(prompts, max_new=2, frontend=frontend)    # warm-up
    torch.cuda.synchronize()
    t = time.perf_counter()
    eng.generate(prompts, max_new=1, frontend=frontend)    # prefill + first token
    torch.cuda.synchronize()
    ttft = time.perf_counter() - t
    weights = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = eng.generate(prompts, max_new=serve["new"], frontend=frontend)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    steps = serve["new"] - 1
    for name, c in counts.items():
        require(c == want.get(name, 0), f"serve: {name} launched {c} times, "
                f"expected {want.get(name, 0)}")
    require(tuple(res.tokens.shape) == (serve["batch"], serve["new"]), "serve: token shape")
    require(int(res.tokens.min()) >= 0 and int(res.tokens.max()) < cfg.vocab,
            "serve: tokens out of range")
    require(bool(torch.isfinite(res.logprobs).all()), "serve: non-finite logprobs")
    # the second generate, untimed, splits K4's and K5's launches by shape
    with AttentionShapes() as shapes:
        again = eng.generate(prompts, max_new=serve["new"], frontend=frontend)
    require(torch.equal(again.tokens, res.tokens) and torch.equal(again.logprobs, res.logprobs),
            "serve: two generates differ")
    for name, prefix in (("flash_attention", "k4"), ("decode_attention", "k5")):
        tallied = sum(c for key, c in shapes.counts.items() if key.startswith(prefix))
        require(tallied == counts[name], f"serve: {name} tallied {tallied} launches by "
                f"shape in the second generate, its counter {counts[name]} in the first")
    decode_s = wall - ttft
    b, p = serve["batch"], serve["prompt"]
    return {"arch": cfg.name, "batch": b, "prompt": p, "new_tokens": serve["new"],
            "s_max": serve["s_max"], "wall_s": wall, "ttft_s": ttft,
            "prefill_tokens_per_s": b * p / ttft,
            "decode_tokens_per_s": b * steps / decode_s,
            "decode_ms_per_step": decode_s / steps * 1e3,
            "peak_memory_bytes": peak, "allocated_before_bytes": weights,
            "launches": counts, "attention_shapes": dict(shapes.counts),
            "repeat_bit_equal": True}, counts


def serve_profile(torch, cfg, model, toks, steps: int = 2, serve: dict = SERVE,
                  frontend=None) -> dict:
    """Device busy share over the prefill and over a few decode steps at the
    serving shape (after the serve phase's calls warmed both up)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import init_cache, lm_decode_step, lm_prefill

    with torch.inference_mode():
        cache = init_cache(cfg, serve["batch"], serve["s_max"], "cuda")
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            logits, cache = lm_prefill(model, cfg, cache, {"tokens": toks[:, :serve["prompt"]],
                                                           **front(frontend)})
            torch.cuda.synchronize()
            prefill_us = (time.perf_counter() - t0) * 1e6
        prefill = {"wall_ms": prefill_us / 1e3, **device_busy(prof, prefill_us, 1, "prefill")}
        for _ in range(2):                                 # warm-up
            logits, cache = lm_decode_step(model, cfg, cache, logits.argmax(-1).int())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                logits, cache = lm_decode_step(model, cfg, cache, logits.argmax(-1).int())
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
    return {"decode_steps": steps, "wall_ms_per_step": wall_us / steps / 1e3,
            **device_busy(prof, wall_us, steps, "step"), "prefill": prefill}


class MoEStats:
    """While active, every MoE layer the model runs (`transformer`'s
    ``apply_moe``) also returns its ``return_stats``, appended to ``calls``
    with its capacity (and, with ``router``, each token's router
    probabilities and margin: its K-th probability less its (K+1)-th; with
    ``keep_inputs``, the layer's input to ``inputs``); the layer's output
    is the one it gives without stats (the single-device path)."""

    def __init__(self, router: bool = False, keep_inputs: bool = False):
        self.router, self.keep_inputs = router, keep_inputs
        self.calls: list = []
        self.inputs: list = []

    def __enter__(self):
        from repro_torch.models import moe, transformer

        self._mod, self._orig = transformer, transformer.apply_moe

        def hooked(p, x, spec):
            if self.keep_inputs:
                self.inputs.append(x)
            y, st = moe.apply_moe(p, x, spec, return_stats=True)
            t = x.numel() // x.shape[-1]
            st["capacity"] = moe.moe_capacity(t, spec)
            if self.router:
                _, _, probs = moe.route(p.router, x.reshape(t, -1), spec)
                top = probs.topk(spec.top_k + 1, dim=-1).values
                st["probs"], st["margin"] = probs, top[:, -2] - top[:, -1]
            self.calls.append(st)
            return y

        transformer.apply_moe = hooked
        return self

    def __exit__(self, *exc):
        self._mod.apply_moe = self._orig
        return False


def moe_layer_rows(calls: list) -> list:
    """Per MoE layer: dropped pairs, capacity, max and mean expert load."""
    return [{"dropped": int(c["dropped"]), "capacity": c["capacity"],
             "load_max": float(c["expert_load"].max()),
             "load_mean": float(c["expert_load"].mean())} for c in calls]


def deepseek_consistency(torch, cfg, model, toks) -> dict:
    """deepseek-v2-lite-16b's prefill(P) + decode against prefill(P+1) at a
    capacity factor just above n_experts / top_k, where ``moe_capacity(T)
    >= T`` and nothing drops (capacity drops differ by design between the
    two paths: the last token sorts last within its experts). The routing
    of the last token is compared between the two paths, as a set per
    (layer, row): ``routing_agree`` is the share of its K picks the other
    path also picked; ``router_prob_max_diff`` is the largest difference of
    its router probabilities between the paths, ``router_flip_margins``
    prefill(P+1)'s margin (K-th less (K+1)-th probability) where a pick
    differs. Relative L2 over all rows must stay below FULL_REL_TOL. The
    rest of `consistency_gate` holds on all rows, or, only if that fails
    and some row's routing differs between the paths (an f32 router
    near-tie flipped by the paths' bf16 differences), on the rows whose
    routing agrees in every layer (counted and printed, with the all-row
    failure)."""
    dropless = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k * 1.001)
    with MoEStats(router=True) as st:
        dec, whole = consistency_logits(torch, dropless, model, toks)
    n_moe = cfg.n_layers - cfg.first_dense
    require(len(st.calls) == 3 * n_moe, f"{len(st.calls)} MoE calls, expected {3 * n_moe}")
    require(all(int(c["dropped"]) == 0 for c in st.calls),
            "dropless capacity dropped pairs")
    b, k = SERVE["batch"], cfg.top_k
    agree, prob_diff, flip_margins = [], [], []
    flipped = torch.zeros(b, dtype=torch.bool, device="cuda")
    for d_call, w_call in zip(st.calls[n_moe:2 * n_moe], st.calls[2 * n_moe:]):
        d_idx = d_call["top_idx"].long()                                  # [B, K]
        w_idx = w_call["top_idx"].reshape(b, -1, k)[:, -1].long()         # the last token
        same = (d_idx[:, :, None] == w_idx[:, None, :]).any(-1).sum(-1)  # [B]
        agree.append(same.float() / k)
        row_flip = same < k
        flipped |= row_flip
        w_probs = w_call["probs"].reshape(b, -1, cfg.n_experts)[:, -1]
        prob_diff.append(float((d_call["probs"] - w_probs).abs().max()))
        w_margin = w_call["margin"].reshape(b, -1)[:, -1]
        flip_margins += [float(m) for m in w_margin[row_flip]]
    agree = torch.stack(agree)
    all_rel = float((dec - whole).norm() / whole.norm())
    out = {"capacity_factor": dropless.capacity_factor,
           "capacity": [st.calls[i * n_moe]["capacity"] for i in range(3)],
           "routing_agree": float(agree.mean()),
           "routing_flips": int((agree < 1).sum()), "router_flip_rows": int(flipped.sum()),
           "router_flip_margins": flip_margins, "router_prob_max_diff": max(prob_diff),
           "all_rows_rel_l2_err": all_rel,
           "all_rows_argmax_agree": float((dec.argmax(-1) == whole.argmax(-1)).float().mean())}
    require(all_rel < FULL_REL_TOL, f"full-width decode vs prefill: relative error {all_rel}")
    try:
        out.update(consistency_gate(torch, cfg, dec, whole))
        out["router_flip_rows_excluded"] = 0
    except RuntimeError as e:
        if not bool(flipped.any()):
            raise
        out["gate_all_rows"] = str(e)
        out.update(consistency_gate(torch, cfg, dec, whole, rows=~flipped))
        out["router_flip_rows_excluded"] = int(flipped.sum())
    return out


def deepseek_phase(torch, ops) -> tuple[dict, dict]:
    """deepseek-v2-lite-16b at full width and depth, bf16, random weights
    from SEED (31.4 GB; no f32 leg: its weights alone would be 62.8 GB):
    the parameter count against `repro`'s; prefill + decode against prefill
    at dropless capacity (`deepseek_consistency`); then the serving main
    path at the config's capacity factor (1.25) through `Engine.generate`,
    K4 once a layer (27) and no other kernel, two generates bit-equal, its
    device busy share; then each MoE layer's drops and expert load at the
    prefill and in two decode steps (batch 8 decode never drops: capacity
    8, a token's 6 picks distinct). Returns (its rows, the serve counts)."""
    from repro_torch.models import init_cache, lm_decode_step, lm_prefill

    t = time.perf_counter()
    cfg, model, toks, n_params = full_width_model(torch, DEEPSEEK)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    require(n_params == DEEPSEEK_LITE_PARAMS,
            f"{DEEPSEEK} has {n_params} parameters, repro's has {DEEPSEEK_LITE_PARAMS}")
    t = time.perf_counter()
    full = {"arch": cfg.name, "params": n_params, "init_s": init_s,
            **deepseek_consistency(torch, cfg, model, toks),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t}
    next_model(torch)
    serve, counts = serve_phase(torch, ops, cfg, model, toks,
                                {"flash_attention": cfg.n_layers})
    serve_prof = serve_profile(torch, cfg, model, toks)
    with MoEStats() as st, torch.inference_mode():
        cache = init_cache(cfg, SERVE["batch"], SERVE["s_max"], "cuda")
        logits, cache = lm_prefill(model, cfg, cache, {"tokens": toks[:, :SERVE["prompt"]]})
        n_pre = len(st.calls)
        for _ in range(2):
            logits, cache = lm_decode_step(model, cfg, cache, logits.argmax(-1).int())
    prefill_rows, decode_rows = moe_layer_rows(st.calls[:n_pre]), \
        moe_layer_rows(st.calls[n_pre:])
    require(all(r["dropped"] == 0 for r in decode_rows), "batch 8 decode dropped pairs")
    stats = {"capacity_factor": cfg.capacity_factor, "prefill_layers": prefill_rows,
             "prefill_dropped": sum(r["dropped"] for r in prefill_rows),
             "prefill_pairs": SERVE["batch"] * SERVE["prompt"] * cfg.top_k * len(prefill_rows),
             "decode_layers_dropped": [r["dropped"] for r in decode_rows],
             "decode_load_max": max(r["load_max"] for r in decode_rows)}
    return ({"full": full, "serve": serve, "serve_profile": serve_prof, "moe": stats}, counts,
            (cfg, model, toks))


# --------------------------------------------------------------------------
# phase 7j: Revolver expert placement and expert-parallel serving
# --------------------------------------------------------------------------
def serve_logits(torch, cfg, model, prompts) -> tuple:
    """(prefill logits, one greedy decode step's logits) at the serving
    batch: the logits a generate's first two tokens come from."""
    from repro_torch.models import init_cache, lm_decode_step, lm_prefill

    with torch.inference_mode():
        cache = init_cache(cfg, SERVE["batch"], SERVE["s_max"], "cuda")
        first, cache = lm_prefill(model, cfg, cache, {"tokens": prompts})
        dec, _ = lm_decode_step(model, cfg, cache, first.argmax(-1).int())
    return first, dec


def rank_piece_sizes(torch, layer, x_in, spec, mesh) -> tuple[list, list]:
    """The L2 norms of each expert-parallel rank's two pieces of one MoE
    layer's output on ``x_in`` (its routed experts' gated combine and its
    share of the shared experts): the error the per-layer gate reads, up to
    the sound error, if the psum over the model ranks left that piece
    out."""
    from repro_torch.models import moe
    from repro_torch.models.mlp import apply_mlp
    from repro_torch.parallel.sharding import shard_tree

    k, e_loc = spec.top_k, spec.n_experts // EP_RANKS
    x2 = x_in.reshape(-1, x_in.shape[-1])
    t = x2.shape[0]
    gates, idx, _ = moe.route(layer.router, x2, spec)
    flat = idx.reshape(-1).long()
    routed, shared = [], []
    for r, sh in enumerate(shard_tree(moe._moe_tree(layer), moe._moe_pspec(spec, "model"), mesh)):
        pr = moe._rank_params(sh)
        out, _, _ = moe._pair_dispatch(x2, moe._foreign_key(flat - r * e_loc, e_loc), k, e_loc,
                                       moe.moe_capacity(t, spec), pr.w_gate, pr.w_up,
                                       pr.w_down, foreign=True)
        routed.append(moe._combine(out, gates, t, k).float().norm())
        shared.append(apply_mlp(pr.shared, x2).float().norm())
    return routed, shared


def placement_legs(torch, np, ops, cfg, model, toks, ds_serve: dict) -> dict:
    """deepseek-v2-lite-16b (phase 7d's model, full width and depth):
    (a) each MoE layer's routing ``top_idx`` [8192, 6] from a prefill of the
    serving batch, K4 27 times; the unplaced model's logits and one
    generate as the reference; (b) ``place_experts`` on every MoE layer (64
    experts, 8 devices, up to PLACE_STEPS supersteps; K1 and K2 once a
    superstep each), the cross-rank co-activation fraction naive against
    Revolver's, then the clustered synthetic routing (Revolver at most the
    naive fraction less 0.3, 8 experts a rank); (c) every MoE replaced by
    its placed copy layer by layer: logits and the generate bit-equal to
    (a)'s; (d) expert-parallel on ``LMMesh((1, 8), ("data", "model"),
    [cuda:0] * 8)``: every MoE layer through ``_apply_moe_shardmap`` in
    prefill and decode, rank r holding placed experts [8r, 8r + 8) (views),
    held to (c) by the bf16 rule, the same drops per layer, two generates
    bit-equal, peak memory within EP_PEAK_SLACK of 7d's; (e) one MoE layer
    through ``_apply_moe_ep2d`` on (pod 2, data 1, model 4) against the
    local path at dropless capacity. Returns the legs' rows; the model's
    MoE layers are placed in place."""
    from examples import expert_placement_torch
    from repro_torch.core.placement import (_cross_fraction, apply_placement,
                                            coactivation_graph, place_experts)
    from repro_torch.launch.mesh import LMMesh
    from repro_torch.models import init_cache, lm_prefill, moe
    from repro_torch.models.transformer import moe_spec
    from repro_torch.parallel.act_sharding import use_activation_sharding
    from repro_torch.parallel.sharding import shard_tree
    from repro_torch.serve import Engine

    rows: dict = {}
    e, k, new = cfg.n_experts, cfg.top_k, SERVE["new"]
    n_moe = cfg.n_layers - cfg.first_dense
    prompts = toks[:, :SERVE["prompt"]].contiguous()
    serve_want = {"flash_attention": cfg.n_layers}
    gen_want = {"flash_attention": cfg.n_layers}   # MLA decodes in plain PyTorch

    # (a) routing, and the unplaced reference
    t = time.perf_counter()
    ops.reset_launch_counts()
    with MoEStats() as st, torch.inference_mode():
        lm_prefill(model, cfg, init_cache(cfg, SERVE["batch"], SERVE["s_max"], "cuda"),
                   {"tokens": prompts})
    expect_launches(ops.launch_counts(), serve_want, "placement routing prefill")
    require(len(st.calls) == n_moe, f"{len(st.calls)} MoE layers routed, expected {n_moe}")
    tops = [c["top_idx"].cpu().numpy() for c in st.calls]
    n_tok = SERVE["batch"] * SERVE["prompt"]
    require(all(x.shape == (n_tok, k) for x in tops), "routing: top_idx shape")
    del st
    ref_first, ref_dec = serve_logits(torch, cfg, model, prompts)
    eng = Engine(cfg, model, s_max=SERVE["s_max"])
    ops.reset_launch_counts()
    ref = eng.generate(prompts, max_new=new)
    expect_launches(ops.launch_counts(), gen_want, "placement reference generate")
    rows["routing"] = {"layers": n_moe, "tokens": n_tok, "top_k": k,
                       "ordered_pairs_a_layer": n_tok * k * (k - 1),
                       "seconds": time.perf_counter() - t}

    # (b) placement: Revolver on each layer's co-activation graph
    t = time.perf_counter()
    naive = np.arange(e) // (e // EP_RANKS)
    ops.reset_launch_counts()
    placements, layers = [], []
    for i, top in enumerate(tops):
        t_layer = time.perf_counter()
        pl = place_experts(top, e, EP_RANKS, max_steps=PLACE_STEPS, device="cuda")
        secs = time.perf_counter() - t_layer
        counts = np.bincount(pl.expert_to_device, minlength=EP_RANKS)
        require(counts.min() == counts.max() == e // EP_RANKS, f"layer {i}: ranks hold {counts}")
        g, _ = coactivation_graph(top, e)
        layers.append({"layer": i, "seconds": secs, "supersteps": pl.result.steps,
                       "graph_edges": g.m, "naive_cross": _cross_fraction(top, naive),
                       "revolver_cross": pl.cross_coactivation,
                       "local_edges": pl.result.local_edges,
                       "max_norm_load": pl.result.max_norm_load})
        placements.append(pl)
    counts = ops.launch_counts()
    steps = sum(r["supersteps"] for r in layers)
    expect_launches(counts, {n: steps for n in PARTITIONER_KERNELS}, "placement")
    ops.reset_launch_counts()
    top = expert_placement_torch.synth_routing(SEED)
    pl = place_experts(top, SYNTH_EXPERTS, EP_RANKS, max_steps=PLACE_STEPS, device="cuda")
    synth_counts = ops.launch_counts()
    expect_launches(synth_counts, {n: pl.result.steps for n in PARTITIONER_KERNELS},
                    "placement, clustered routing")
    synth = {"naive_cross": _cross_fraction(top, np.arange(SYNTH_EXPERTS)
                                            // (SYNTH_EXPERTS // EP_RANKS)),
             "revolver_cross": pl.cross_coactivation, "supersteps": pl.result.steps,
             "experts_a_rank": np.bincount(pl.expert_to_device, minlength=EP_RANKS).tolist()}
    require(synth["revolver_cross"] <= synth["naive_cross"] - 0.3,
            f"clustered routing: Revolver's cross fraction {synth}")
    require(set(synth["experts_a_rank"]) == {SYNTH_EXPERTS // EP_RANKS},
            f"clustered routing: {synth}")
    rows["place"] = {"layers": layers, "supersteps": steps, "launches": counts,
                     "seconds_total": sum(r["seconds"] for r in layers),
                     "naive_cross_mean": float(np.mean([r["naive_cross"] for r in layers])),
                     "revolver_cross_mean": float(np.mean([r["revolver_cross"] for r in layers])),
                     "clustered": {**synth, "launches": synth_counts},
                     "seconds": time.perf_counter() - t}

    # (c) every MoE layer replaced by its placed copy, layer by layer
    t = time.perf_counter()
    e_loc = e // EP_RANKS
    for blk, pl in zip(model.blocks, placements):
        blk.moe = apply_placement(blk.moe, pl)      # the old layer's experts go
        for r in range(EP_RANKS):
            mine = pl.permutation[r * e_loc:(r + 1) * e_loc]
            require(bool((pl.expert_to_device[mine] == r).all()),
                    f"placed order: rank {r}'s experts are not Revolver's group {r}")
    with MoEStats(keep_inputs=True) as single:
        first, dec = serve_logits(torch, cfg, model, prompts)
    require(torch.equal(first, ref_first) and torch.equal(dec, ref_dec),
            "placed model: logits differ from the unplaced model's "
            f"(max abs {max_err(torch, first, ref_first)}, {max_err(torch, dec, ref_dec)})")
    ops.reset_launch_counts()
    placed = eng.generate(prompts, max_new=new)
    expect_launches(ops.launch_counts(), gen_want, "placed generate")
    require(torch.equal(placed.tokens, ref.tokens) and torch.equal(placed.logprobs, ref.logprobs),
            "placed model: its generate differs from the unplaced model's")
    rows["permuted"] = {"logits_bit_equal": True, "generate_bit_equal": True,
                        "seconds": time.perf_counter() - t}

    # (d) expert-parallel serving over 8 ranks on the one card
    t = time.perf_counter()
    mesh = LMMesh((1, EP_RANKS), ("data", "model"), ["cuda:0"] * EP_RANKS)
    spec = moe_spec(cfg)
    layer0 = model.blocks[0].moe
    shards = shard_tree(moe._moe_tree(layer0), moe._moe_pspec(spec, "model"), mesh)
    for r, sh in enumerate(shards):
        for name in ("w_gate", "w_up", "w_down"):
            src = getattr(layer0, name)
            require(sh[name].untyped_storage().data_ptr() == src.untyped_storage().data_ptr()
                    and torch.equal(sh[name], src[r * e_loc:(r + 1) * e_loc]),
                    f"rank {r}'s {name} is not a view of placed experts [{r * e_loc}, "
                    f"{(r + 1) * e_loc})")
        require(sh["shared"]["w_gate"]["w"].untyped_storage().data_ptr()
                == layer0.shared.w_gate.w.untyped_storage().data_ptr(), "shared shard copied")
    del shards
    with use_activation_sharding(mesh), moe.record_dispatch() as rec_ep:
        ops.reset_launch_counts()
        ep_first, ep_dec = serve_logits(torch, cfg, model, prompts)
        expect_launches(ops.launch_counts(), gen_want, "expert-parallel prefill + decode")
    paths = collections.Counter(r["path"] for r in rec_ep)
    require(paths == {"shardmap": 2 * n_moe}, f"expert-parallel dispatch paths {dict(paths)}")
    gate_prefill = consistency_gate(torch, cfg, ep_first, first)
    gate_decode = consistency_gate(torch, cfg, ep_dec, dec)
    # each layer on the single-device run's own input: with data = 1 every
    # rank sizes its capacity from all the tokens, so the ranks drop what
    # the local path drops; end to end the layers' inputs differ by the
    # partials' bf16 rounding, and near-tie routing picks flip
    drops_single = [int(c["dropped"]) for c in single.calls[:n_moe]]
    drops_ep, layer_rel, pieces = [], [], []
    with torch.inference_mode():
        for blk, x_in in zip(model.blocks, single.inputs[:n_moe]):
            y_loc = moe.apply_moe(blk.moe, x_in, spec)
            with use_activation_sharding(mesh), moe.record_dispatch() as rec_layer:
                y_ep = moe.apply_moe(blk.moe, x_in, spec)
            drops_ep.append(int(rec_layer[0]["dropped"]))
            y_norm = y_loc.float().norm()
            layer_rel.append(float((y_ep.float() - y_loc.float()).norm() / y_norm))
            pieces.append([[float(n / y_norm) for n in ns]
                           for ns in rank_piece_sizes(torch, blk.moe, x_in, spec, mesh)])
    del single, y_loc, y_ep
    require(drops_ep == drops_single,
            f"drops a layer on the same input: EP {drops_ep}, single {drops_single}")
    require(max(layer_rel) < EP_LAYER_REL_TOL,
            f"an MoE layer's EP output: relative L2 {layer_rel}")
    drops_e2e = [int(r["dropped"]) for r in rec_ep[:n_moe]]
    checks_s = time.perf_counter() - t
    next_model(torch)
    with use_activation_sharding(mesh):
        torch.cuda.synchronize()
        t_gen = time.perf_counter()
        eng.generate(prompts, max_new=1)
        torch.cuda.synchronize()
        ttft = time.perf_counter() - t_gen
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t_gen = time.perf_counter()
        ep = eng.generate(prompts, max_new=EP_NEW)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t_gen
        gen_counts = ops.launch_counts()
        peak = torch.cuda.max_memory_allocated()
        # the second generate: its tokens and log-probabilities against the
        # first generate's first EP_REPEAT_NEW
        with moe.record_dispatch() as rec_gen:
            again = eng.generate(prompts, max_new=EP_REPEAT_NEW)
    expect_launches(gen_counts, gen_want, "expert-parallel generate")
    paths = collections.Counter(r["path"] for r in rec_gen)
    require(paths == {"shardmap": n_moe * EP_REPEAT_NEW},
            f"expert-parallel generate's dispatch paths {dict(paths)}")
    require(torch.equal(again.tokens, ep.tokens[:, :EP_REPEAT_NEW])
            and torch.equal(again.logprobs, ep.logprobs[:, :EP_REPEAT_NEW]),
            "expert-parallel: two generates differ")
    require(peak <= ds_serve["peak_memory_bytes"] + EP_PEAK_SLACK,
            f"expert-parallel peak memory {peak} beyond 7d's "
            f"{ds_serve['peak_memory_bytes']} + {EP_PEAK_SLACK}")
    t_prof = time.perf_counter()
    with use_activation_sharding(mesh):
        prof = serve_profile(torch, cfg, model, toks, steps=2)
    prof_s = time.perf_counter() - t_prof
    decode_s = wall - ttft
    rows["expert-parallel"] = {
        "mesh": {"data": 1, "model": EP_RANKS}, "prefill_gate": gate_prefill,
        "decode_gate": gate_decode, "drops_a_layer_same_input": drops_ep,
        "drops_equal_same_input": True, "layer_rel_l2_same_input_max": max(layer_rel),
        "layer_tol_rel_l2": EP_LAYER_REL_TOL,
        "rank_routed_piece_rel_min": min(min(r) for r, _ in pieces),
        "rank_shared_piece_rel_min": min(min(s) for _, s in pieces),
        "drops_a_layer_end_to_end": drops_e2e,
        "drops_a_layer_end_to_end_single": drops_single,
        "dispatch_paths": dict(paths), "ttft_s": ttft, "wall_s": wall,
        "new_tokens": EP_NEW, "decode_ms_per_step": decode_s / (EP_NEW - 1) * 1e3,
        "decode_ms_per_step_7d": ds_serve["decode_ms_per_step"],
        "tokens_equal_placed_share": float((ep.tokens == placed.tokens[:, :EP_NEW])
                                           .float().mean()),
        "launches": gen_counts, "peak_memory_bytes": peak,
        "peak_memory_bytes_7d": ds_serve["peak_memory_bytes"],
        "serve_profile": prof, "two_generates_bit_equal": True,
        "repeat_new_tokens": EP_REPEAT_NEW, "checks_s": checks_s, "profile_s": prof_s,
        "seconds": time.perf_counter() - t}

    # (e) one MoE layer across pods: EP over (pod 2) x (model 4)
    t = time.perf_counter()
    dropless = dataclasses.replace(spec, capacity_factor=e / k * 1.001)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    x = torch.randn((SERVE["batch"], EP2D_TOKENS, cfg.d_model), generator=gen,
                    device="cuda").to(cfg.cdt)
    mesh2 = LMMesh((2, 1, 4), ("pod", "data", "model"), ["cuda:0"] * EP_RANKS)
    with torch.inference_mode():
        y_local = moe.apply_moe(layer0, x, dropless)
        with use_activation_sharding(mesh2, moe_ep2d=True), moe.record_dispatch() as rec2:
            y = moe.apply_moe(layer0, x, dropless)
    require([r["path"] for r in rec2] == ["ep2d"], f"EP2D dispatch {rec2}")
    rel = float((y.float() - y_local.float()).norm() / y_local.float().norm())
    require(bool(torch.isfinite(y).all()) and rel < FULL_REL_TOL,
            f"EP2D against the local path: relative L2 {rel}")
    rows["ep2d"] = {"mesh": {"pod": 2, "data": 1, "model": 4}, "x": list(x.shape),
                    "capacity_factor": dropless.capacity_factor, "rel_l2_err": rel,
                    "tol_rel_l2": FULL_REL_TOL, "dropped": int(rec2[0]["dropped"]),
                    "seconds": time.perf_counter() - t}
    return rows


def lm_collective_legs(torch, np, ops, flush) -> dict:
    """(f) flash-decode over a seq-sharded cache at tinyllama-1.1b's decode
    shape (q [8,32,64], cache [8,4,1152,64] bf16, kv_len 1024) in
    SHARDED_DECODE_SHARDS shards of 288 rows (local lengths 288, 288, 288,
    160): K5 with (m, l) on each shard, merged, against K5 on the whole
    cache, each row within SERVE_ROW_REL_TOL of its norm; the shards'
    launches timed beside the whole cache's. (g) ``ef_int8_psum`` over
    EF_RANKS ranks of f32 [32000, 2048] (tinyllama's largest leaf): codes
    and scales bit-equal to the CPU's on the same inputs, the error within
    half a step, 50 feedback rounds averaging to the input within one
    step."""
    from repro_torch.parallel.collectives import (_quantize_int8, ef_int8_psum,
                                                  sharded_decode_attention)

    rows: dict = {}
    t = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    b, hq, hkv, s_rows, d, kv = 8, 32, 4, 1152, 64, 1024
    n_sh = SHARDED_DECODE_SHARDS
    width = s_rows // n_sh
    q = torch.randn((b, hq, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc, vc = (torch.randn((b, hkv, s_rows, d), generator=gen, device="cuda").to(torch.bfloat16)
              for _ in range(2))
    kv_len = torch.full((b,), kv, dtype=torch.int32, device="cuda")
    ks = [kc[:, :, i * width:(i + 1) * width].contiguous() for i in range(n_sh)]
    vs = [vc[:, :, i * width:(i + 1) * width].contiguous() for i in range(n_sh)]
    lens = [torch.clamp(kv_len - i * width, 0, width).to(torch.int32) for i in range(n_sh)]
    ops.reset_launch_counts()
    got = sharded_decode_attention(q, ks, vs, lens)[0]
    expect_launches(ops.launch_counts(), {"decode_attention": n_sh}, "sharded decode")
    whole = ops.decode_attention(q, kc, vc, kv_len)
    shards_only = lambda: [ops.decode_attention(q, k_, v_, n_, return_lse=True)  # noqa: E731
                           for k_, v_, n_ in zip(ks, vs, lens)]
    rows["sharded-decode"] = {
        "q": [b, hq, d], "cache": [b, hkv, s_rows, d], "kv_len": kv, "shards": n_sh,
        "local_lengths": [int(n[0]) for n in lens],
        **check_rows(torch, got, whole, SERVE_ROW_REL_TOL, "sharded decode vs whole cache"),
        "shard_launches_ms": graph_ms(torch, shards_only, flush),
        "sharded_with_combine_ms": graph_ms(
            torch, lambda: sharded_decode_attention(q, ks, vs, lens), flush),
        "whole_cache_ms": graph_ms(torch, lambda: ops.decode_attention(q, kc, vc, kv_len), flush),
        "seconds": time.perf_counter() - t}
    del q, kc, vc, ks, vs, got, whole

    t = time.perf_counter()
    shape = (32000, 2048)
    gs = [torch.randn(shape, generator=gen, device="cuda") * 1e-2 for _ in range(EF_RANKS)]
    errs = [torch.randn(shape, generator=gen, device="cuda") * 1e-5 for _ in range(EF_RANKS)]
    g_hat, new_errs = ef_int8_psum(gs, errs)
    worst, half_steps = 0.0, 0.0
    for g, err, new_err in zip(gs, errs, new_errs):
        x = g + err
        codes, scale = _quantize_int8(x)
        cpu_codes, cpu_scale = _quantize_int8(x.cpu())
        require(torch.equal(codes.cpu(), cpu_codes) and scale.item() == cpu_scale.item(),
                "ef_int8: codes or scale differ from the CPU's")
        deq = codes.float() * scale
        require(torch.equal(new_err, x - deq), "ef_int8: the carried error is not x - deq")
        # half a step, and the roundings of x / scale and of deq (2^-24 of
        # up to 127 steps each)
        steps = float((x - deq).abs().max() / scale)
        require(steps <= 0.5 + 1e-4, f"ef_int8: error {steps} steps, beyond half a step")
        worst, half_steps = max(worst, steps), half_steps + float(scale) * 0.5
        del x, deq, codes
    x_mean = torch.stack([g + err for g, err in zip(gs, errs)]).mean(0)
    mean_err = float((g_hat[0] - x_mean).abs().max())
    require(mean_err <= half_steps / EF_RANKS * (1 + 1e-3),
            f"ef_int8: the mean-reduced gradient is {mean_err} off the ranks' mean, beyond "
            f"the mean half step {half_steps / EF_RANKS}")
    del x_mean
    x, err, acc = gs[0], torch.zeros_like(gs[0]), torch.zeros_like(gs[0])
    for _ in range(50):
        xe = x + err
        codes, scale = _quantize_int8(xe)
        deq = codes.float() * scale
        err, acc = xe - deq, acc + deq
    avg_err = float((acc / 50 - x).abs().max())
    require(avg_err <= float(scale), f"ef_int8: 50 rounds average {avg_err} off, step "
            f"{float(scale)}")
    rows["ef-int8"] = {"ranks": EF_RANKS, "shape": list(shape), "codes_bit_equal_cpu": True,
                       "worst_error_in_steps": worst, "mean_max_abs_err": mean_err,
                       "feedback_50_max_abs_err": avg_err, "step": float(scale),
                       "seconds": time.perf_counter() - t}
    return rows


def h2o_phase(torch, ops) -> tuple[dict, dict]:
    """h2o-danube-3-4b at full width and depth, bf16, random weights from
    SEED: the parameter count against `repro`'s; prefill(4608) +
    decode(token 4609) against prefill(4609), past the 4096-token window,
    so the ring has wrapped (gated as phase 7); then the serving main path
    (batch 4, 4608-token prompts, 128 new tokens) through
    `Engine.generate`: K4 once a layer (24), K5 once a layer and decode
    step (24 x 127), no other kernel, two generates bit-equal, its device
    busy share. Returns (its rows, the serve counts)."""
    t = time.perf_counter()
    cfg, model, toks, n_params = full_width_model(torch, H2O, serve=H2O_SERVE)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    require(n_params == H2O_PARAMS, f"{H2O} has {n_params} parameters, repro's has {H2O_PARAMS}")
    require(H2O_SERVE["prompt"] > cfg.window, "the consistency prompt must pass the window")
    t = time.perf_counter()
    full = {"arch": cfg.name, "params": n_params, "init_s": init_s, "window": cfg.window,
            "prompt": H2O_SERVE["prompt"],
            **full_width_consistency(torch, cfg, model, toks, serve=H2O_SERVE),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t}
    next_model(torch)
    serve, counts = serve_phase(
        torch, ops, cfg, model, toks,
        {"flash_attention": cfg.n_layers,
         "decode_attention": cfg.n_layers * (H2O_SERVE["new"] - 1)}, serve=H2O_SERVE)
    serve_prof = serve_profile(torch, cfg, model, toks, serve=H2O_SERVE)
    return {"full": full, "serve": serve, "serve_profile": serve_prof}, counts


def perturb_lora(torch, model, seed: int) -> None:
    """Draw every LoRA ``b`` of the hybrid (0 at init, as in `repro`, which
    makes the per-application deltas vanish) from N(0, 0.02^2), so the LoRA
    path carries signal: at zamba2-7b's width a delta of ~0.2 of the base
    projection's scale."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    with torch.no_grad():
        for lora in model.lora:
            for pair in (lora.q, lora.k, lora.v):
                pair.b.copy_(torch.randn(pair.b.shape, generator=gen, device="cuda") * 0.02)


def zamba_phase(torch, ops) -> tuple[dict, dict]:
    """zamba2-7b at full width, its depth cut to ZAMBA_GROUPS of its 13
    groups of the shared attention block at head width 224 and 5 Mamba2
    layers (3 trailing kept), random weights from SEED with the LoRA ``b``
    leaves drawn after init (`perturb_lora`): the parameter count at all
    13 groups (from one group's) against `repro`'s; in bf16 prefill(1024)
    (the chunked SSD form) + decode(token 1025) against prefill(1025) (the
    scan), gated as phase 7; the serving main path (batch 8, 1024-token
    prompts, 128 new tokens): K4 once an application (6), K5 once an
    application and decode step (6 x 127), no other
    kernel (the Mamba2 layers are plain PyTorch, as in `repro`), two
    generates bit-equal, its device busy share; then the same consistency
    with f32 weights and activations (TF32 off), relative L2 < 1e-3 and the
    greedy token on every row. Returns (its rows, the serve counts)."""
    from repro_torch.configs.registry import get_config

    rows = {}
    for dtype, tol, same_argmax in ((None, FULL_REL_TOL, False),
                                    ("float32", FULL_F32_REL_TOL, True)):
        next_model(torch)
        t = time.perf_counter()
        full = get_config(ZAMBA)
        cut = dict(n_attn_groups=ZAMBA_GROUPS, n_layers=ZAMBA_GROUPS * (1 + full.mamba_per_group)
                   + full.trailing_mamba)
        cfg, model, toks, n_params = full_width_model(torch, ZAMBA, dtype, **cut)
        perturb_lora(torch, model, SEED + 4)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t
        per_group = sum(p.numel() for m in (model.lora[0], model.mamba[0]) for p in m.parameters())
        full_params = n_params + (full.n_attn_groups - ZAMBA_GROUPS) * per_group
        require(full_params == ZAMBA_PARAMS, f"{ZAMBA} at {full.n_attn_groups} groups has "
                f"{full_params} parameters, repro's has {ZAMBA_PARAMS}")
        require(SERVE["prompt"] % cfg.ssm_chunk == 0 and (SERVE["prompt"] + 1) % cfg.ssm_chunk,
                "prefill(P) must take the chunked form and prefill(P+1) the scan")
        t = time.perf_counter()
        rows[str(cfg.cdt)] = {
            "arch": cfg.name, "params": n_params, "groups": ZAMBA_GROUPS, "layers": cfg.n_layers,
            "full_depth_params": full_params, "init_s": init_s, "lora_b": "N(0, 0.02^2)",
            **full_width_consistency(torch, cfg, model, toks, rel_tol=tol,
                                     same_argmax=same_argmax),
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "seconds": time.perf_counter() - t}
        if dtype is None:
            next_model(torch)
            serve, counts = serve_phase(
                torch, ops, cfg, model, toks,
                {"flash_attention": cfg.n_attn_groups,
                 "decode_attention": cfg.n_attn_groups * (SERVE["new"] - 1)})
            serve_prof = serve_profile(torch, cfg, model, toks)
        del model, toks
    return {"full": rows, "serve": serve, "serve_profile": serve_prof}, counts


def serve_leg(torch, ops, arch: str, serve: dict, n_params_want: int, **changes):
    """``arch`` at full width (depth cut by ``changes`` for 7i), bf16,
    random weights from SEED, its stub frontend (a VLM's patches, an
    encoder-decoder's frames) from SEED + 5: the parameter count against
    `repro`'s (and, for a cut depth, the full depth's, from one layer's);
    prefill(P) + decode(token P+1) against prefill(P+1), gated as phase 7;
    then the serving main path through `Engine.generate`: K4 once a layer
    (whisper: once an encoder layer and twice a decoder layer, the self and
    the cross prefill), K5 once a layer and decode step (whisper: twice, the
    self and the cross decode), no other kernel, two generates bit-equal,
    its device busy share. Returns (its rows, the serve counts, the
    launches by shape)."""
    t = time.perf_counter()
    cfg, model, toks, n_params = full_width_model(torch, arch, serve=serve, **changes)
    frontend = (stub_frontend(torch, cfg, serve["batch"])
                if cfg.family in ("vlm", "encdec") else None)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    require(n_params == n_params_want,
            f"{cfg.name} has {n_params} parameters, repro's has {n_params_want}")
    full = {"arch": cfg.name, "params": n_params, "init_s": init_s, "layers": cfg.n_layers,
            "prompt": serve["prompt"]}
    if "n_layers" in changes:
        from repro_torch.configs.registry import get_config

        depth = get_config(arch).n_layers
        per_layer = sum(p.numel() for p in model.blocks[0].parameters())
        full_params = n_params + (depth - cfg.n_layers) * per_layer
        require(full_params == COHERE_FULL_PARAMS,
                f"{arch} at {depth} layers has {full_params} parameters, "
                f"repro's has {COHERE_FULL_PARAMS}")
        full.update(full_depth_layers=depth, full_depth_params=full_params,
                    full_depth_bf16_bytes=2 * full_params)
    if frontend is not None:
        full["frontend"] = list(frontend.shape)
    t = time.perf_counter()
    full.update(**full_width_consistency(torch, cfg, model, toks, serve=serve, frontend=frontend),
                peak_memory_bytes=torch.cuda.max_memory_allocated(),
                seconds=time.perf_counter() - t)
    next_model(torch)
    attn_layers = cfg.n_enc_layers + 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    decode_layers = 2 * cfg.n_layers if cfg.family == "encdec" else cfg.n_layers
    row, counts = serve_phase(torch, ops, cfg, model, toks,
                              {"flash_attention": attn_layers,
                               "decode_attention": decode_layers * (serve["new"] - 1)},
                              serve=serve, frontend=frontend)
    prof = serve_profile(torch, cfg, model, toks, serve=serve, frontend=frontend)
    return {"full": full, "serve": row, "serve_profile": prof}, counts, row["attention_shapes"]


# --------------------------------------------------------------------------
# phase 7k: the dry run's counts against the card
# --------------------------------------------------------------------------
def dryrun_rows(cells) -> dict:
    """`repro_torch.launch.dryrun` rows (CPU work on the meta device): each
    of ``cells`` (arch, shape name, mesh name, ShapeSpec or None[, the dry
    run's switches on: a tuple of names, which the row's key ends with])."""
    from repro_torch.launch.dryrun import dryrun_cell

    rows = {}
    for arch, shape_name, mesh_name, shape, *switches in cells:
        on = switches[0] if switches else ()
        t = time.perf_counter()
        row = dryrun_cell(arch, shape_name, mesh_name, shape=shape, verbose=False,
                          **dict.fromkeys(on, True))
        row.pop("provenance")
        row["wall_s"] = time.perf_counter() - t
        rows["/".join((arch, shape_name, mesh_name) + tuple(on))] = row
    return rows


def dry_run_vs_card(row: dict, peak: int, step_s: float) -> dict:
    """A dry-run row beside the card: its per-rank bytes (argument +
    output + temp) against ``torch.cuda.max_memory_allocated`` over the
    step (within DRYRUN_MEM_FACTOR either way), and the step's wall time
    against the roofline bound max(compute_s, memory_s)."""
    mem = row["mem"]
    counted = (mem["argument_gb"] + mem["output_gb"] + mem["temp_gb"]) * 1e9
    ratio = counted / peak
    require(1 / DRYRUN_MEM_FACTOR <= ratio <= DRYRUN_MEM_FACTOR,
            f"{row['arch']} {row['shape']}: the dry run counts {counted:.4e} bytes, the card "
            f"peaked at {peak} (ratio {ratio:.4f}, allowed {DRYRUN_MEM_FACTOR})")
    bound_s = max(row["compute_s"], row["memory_s"])
    return {"dryrun_bytes": counted, "peak_memory_bytes": peak, "bytes_ratio": ratio,
            "mem_factor": DRYRUN_MEM_FACTOR, "dryrun_mem_gb": mem,
            "step_s": step_s, "bound_s": bound_s, "bound_by": row["bottleneck"],
            "compute_s": row["compute_s"], "memory_s": row["memory_s"],
            "step_over_bound": step_s / bound_s, "dryrun_flops": row["flops"],
            "dryrun_bytes_moved": row["bytes"], "dryrun_kernel_calls": row["kernel_calls"]}


def k4_blocked_plain(torch, q, k, v, block: int = DRYRUN_PLAIN_BLOCK):
    """K4's plain version at a causal shape too long for its whole score
    matrix, in query blocks: block i's queries against the keys up to its
    last row (the right-aligned causal rows of the whole), concatenated."""
    from repro_torch.kernels import flash_attention as k4

    s = q.shape[2]
    return torch.cat([k4.flash_attention_plain(q[:, :, i:i + block], k[:, :, :i + block],
                                               v[:, :, :i + block])
                      for i in range(0, s, block)], dim=2)


def dryrun_phase(torch, ops) -> tuple[dict, dict]:
    """Phase 7k: tinyllama-1.1b at full width and depth (bf16, random
    weights from SEED), its dry-run rows on the one-rank host mesh beside
    the card. (a) prefill_32k at batch 1: one prefill step of 32,768
    tokens (K4 causal at D 64, 22 launches), and again under the host
    mesh's ``bf16_silu`` (`bf16_silu_leg`: F1 22 launches); (b) decode_32k at batch 8:
    a prefill of 32,760 tokens into a 32,768-row cache, then 4 decode
    steps (K5 at kv_len up to 32,764, 88 launches). Every launch counter
    set to 0 just before each leg and read just after; the logits finite;
    each leg's peak memory against the row's bytes and its step time
    against the row's bound (`dry_run_vs_card`). Then K4 at S 32,768 held
    against its plain version in query blocks, K5 at kv_len 32,764 against
    its plain version, each timed beside the plain version and SDPA, with
    its bound, and F1 at the prefill's FFN shape (`swiglu_record`). Also
    the same two cells on the production single-pod mesh. Returns (the
    phase's rows, the three kernel records)."""
    import torch.nn.functional as F

    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4
    from repro_torch.train.step import make_decode_step, make_prefill_step

    arch, s = "tinyllama-1.1b", DRYRUN["seq"]
    pre_shape = ShapeSpec("prefill_32k", s, DRYRUN["prefill_batch"], "prefill")
    dec_shape = ShapeSpec("decode_32k", s, DRYRUN["decode_batch"], "decode")
    t = time.perf_counter()
    rows = dryrun_rows([(arch, "prefill_32k", "host", pre_shape),
                        (arch, "prefill_32k", "host", pre_shape, ("bf16_silu",)),
                        (arch, "decode_32k", "host", dec_shape),
                        (arch, "prefill_32k", "single", None),
                        (arch, "decode_32k", "single", None)])
    count_s = time.perf_counter() - t
    out = {"dryrun_rows": rows, "dryrun_count_s": count_s}
    cfg, model, _, n_params = full_width_model(torch, arch, serve=dict(batch=1, prompt=0))
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)

    # (a) prefill_32k at batch 1
    toks = torch.randint(0, cfg.vocab, (pre_shape.global_batch, s), generator=gen,
                         device="cuda", dtype=torch.int32)
    prefill = make_prefill_step(cfg, s)
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        if i == 0:
            ops.reset_launch_counts()
        t = time.perf_counter()
        with torch.no_grad():
            logits, cache = prefill(model, {"tokens": toks})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        if i == 0:
            pre_counts = ops.launch_counts()
            pre_peak = torch.cuda.max_memory_allocated()
            expect_launches(pre_counts, {"flash_attention": cfg.n_layers}, "7k prefill_32k")
        require(bool(torch.isfinite(logits).all()), "7k prefill_32k: non-finite logits")
        require(tuple(logits.shape) == (pre_shape.global_batch, cfg.vocab),
                f"7k prefill_32k: logits {tuple(logits.shape)}")
        f32_logits = logits
        del logits, cache
    out["prefill_32k"] = {"arch": arch, "params": n_params, "batch": pre_shape.global_batch,
                          "tokens": s, "launches": pre_counts, "step_s_runs": times,
                          **dry_run_vs_card(rows[f"{arch}/prefill_32k/host"], pre_peak,
                                            min(times))}
    # (a') the same prefill under the host mesh's bf16_silu: F1 once a layer
    out["prefill_32k_bf16_silu"], f1_launches = bf16_silu_leg(
        torch, ops, cfg, model, prefill, toks, f32_logits,
        rows[f"{arch}/prefill_32k/host/bf16_silu"], min(times))
    del toks, f32_logits
    next_model(torch)

    # (b) decode_32k at batch 8: prefill to 32,760, then 4 decode steps
    b, p = dec_shape.global_batch, s - DRYRUN["decode_headroom"]
    toks = torch.randint(0, cfg.vocab, (b, p + DRYRUN["decode_steps"]), generator=gen,
                         device="cuda", dtype=torch.int32)
    decode = make_decode_step(cfg)
    ops.reset_launch_counts()
    with torch.no_grad():
        t = time.perf_counter()
        logits, cache = prefill(model, {"tokens": toks[:, :p]})
        torch.cuda.synchronize()
        dec_prefill_s = time.perf_counter() - t
        require(bool(torch.isfinite(logits).all()), "7k decode_32k: non-finite prefill logits")
        torch.cuda.reset_peak_memory_stats()
        step_s = []
        for j in range(DRYRUN["decode_steps"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            logits, cache = decode(model, cache, toks[:, p + j])
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t)
            require(bool(torch.isfinite(logits).all()), f"7k decode_32k: step {j} non-finite")
        dec_peak = torch.cuda.max_memory_allocated()
    dec_counts = ops.launch_counts()
    expect_launches(dec_counts, {"flash_attention": cfg.n_layers,
                                 "decode_attention": cfg.n_layers * DRYRUN["decode_steps"]},
                    "7k decode_32k")
    kv_len = int(cache["pos"][0])
    require(kv_len == p + DRYRUN["decode_steps"], f"7k decode_32k: cache at {kv_len}")
    out["decode_32k"] = {"arch": arch, "batch": b, "prefill_tokens": p,
                         "prefill_s": dec_prefill_s, "kv_len_last": kv_len,
                         "cache_bytes": sum(x.numel() * x.element_size()
                                            for x in cache["main"]),
                         "launches": dec_counts, "step_s_runs": step_s,
                         **dry_run_vs_card(rows[f"{arch}/decode_32k/host"], dec_peak,
                                           sorted(step_s)[len(step_s) // 2])}

    # K5 at kv_len 32,764 on layer 0 of the live cache, against its plain version
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    el, hq, hkv, d = 2, cfg.n_heads, cfg.n_kv, cfg.head_dim
    kc, vc = cache["main"][0][0], cache["main"][1][0]
    qd = torch.randn((b, hq, d), generator=gen, device="cuda").to(cfg.cdt)
    lens = torch.full((b,), kv_len, dtype=torch.int32, device="cuda")
    k5_fn = lambda: k5.decode_attention_cuda(qd, kc, vc, lens)  # noqa: E731
    k5_plain = lambda: k5.decode_attention_plain(qd, kc, vc, lens)  # noqa: E731
    want = k5_plain()
    k5_err = check_rows(torch, k5_fn(), want, SERVE_ROW_REL_TOL, "K5 at kv_len 32,764")
    check_close(torch, k5_fn(), want, ATTN_TOL["bfloat16"], "K5 at kv_len 32,764")
    mask = (torch.arange(kc.shape[2], device="cuda")[None, :] < lens[:, None])[:, None, None, :]
    k5_rec = attention_record(
        torch, flush, "decode_attention_kv32764", "decode_attention", k5_fn, k5_plain,
        lambda: F.scaled_dot_product_attention(qd[:, :, None], kc, vc, attn_mask=mask,
                                               enable_gqa=True),
        k5_err, el * (2 * b * hkv * kv_len * d + 2 * b * hq * d) + 4 * b,
        4 * d * b * hq * kv_len,
        f"q [{b},{hq},{d}] caches [{b},{hkv},{kc.shape[2]},{d}] bf16 kv_len {kv_len}")
    k5_rec["launches"] = dec_counts["decode_attention"]
    del cache, logits, toks, want, kc, vc, mask
    del model
    next_model(torch)

    # K4 at S 32,768 (the prefill_32k shape), against its plain version in
    # query blocks
    q = torch.randn((pre_shape.global_batch, hq, s, d), generator=gen, device="cuda").to(cfg.cdt)
    k = torch.randn((pre_shape.global_batch, hkv, s, d), generator=gen, device="cuda").to(cfg.cdt)
    v = torch.randn((pre_shape.global_batch, hkv, s, d), generator=gen, device="cuda").to(cfg.cdt)
    k4_fn = lambda: k4.flash_attention_cuda(q, k, v)  # noqa: E731
    k4_plain = lambda: k4_blocked_plain(torch, q, k, v)  # noqa: E731
    want = k4_plain()
    got = k4_fn()
    k4_err = check_rows(torch, got, want, SERVE_ROW_REL_TOL, "K4 at S 32,768")
    check_close(torch, got, want, ATTN_TOL["bfloat16"], "K4 at S 32,768")
    del got, want
    pairs = k4.attention_pairs(s, s, causal=True, window=None)
    k4_rec = attention_record(
        torch, flush, "flash_attention_s32768", "flash_attention", k4_fn, k4_plain,
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True),
        k4_err, el * (2 * q.numel() + 2 * k.numel()), 4 * d * pre_shape.global_batch * hq * pairs,
        f"q [{pre_shape.global_batch},{hq},{s},{d}] kv [{pre_shape.global_batch},{hkv},{s},{d}] "
        "bf16 causal", plain_reps=3)
    k4_rec["launches"] = pre_counts["flash_attention"]
    del q, k, v
    # F1 at the prefill's FFN shape [32768, 5632], against its plain chain
    f1_rec = swiglu_record(torch, flush, gen, s * pre_shape.global_batch, cfg.d_ff)
    f1_rec["launches"] = f1_launches
    del flush
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    return out, {"flash_attention_s32768": k4_rec, "decode_attention_kv32764": k5_rec,
                 "swiglu_bf16": f1_rec}


def bf16_silu_leg(torch, ops, cfg, model, prefill, toks, f32_logits, row: dict,
                  f32_step_s: float) -> tuple[dict, int]:
    """Phase 7k's prefill under ``use_activation_sharding(host mesh,
    bf16_silu=True)``: every launch counter set to 0 just before the first
    of two runs and read just after (K4 and F1 once a layer), the logits
    finite and their relative L2 against the f32-SiLU leg's reported, the
    peak held to the dry run's ``bf16_silu`` host row, the step time beside
    the default leg's. Returns (the leg's row, F1's launches)."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.parallel.act_sharding import use_activation_sharding

    times = []
    with use_activation_sharding(make_host_mesh(device="cuda"), bf16_silu=True):
        for i in range(2):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            if i == 0:
                ops.reset_launch_counts()
            t = time.perf_counter()
            with torch.no_grad():
                logits, cache = prefill(model, {"tokens": toks})
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
            if i == 0:
                counts = ops.launch_counts()
                peak = torch.cuda.max_memory_allocated()
                expect_launches(counts, {"flash_attention": cfg.n_layers,
                                         "swiglu": cfg.n_layers}, "7k prefill_32k bf16_silu")
            require(bool(torch.isfinite(logits).all()),
                    "7k prefill_32k bf16_silu: non-finite logits")
            rel = float((logits - f32_logits).norm() / f32_logits.norm())
            del logits, cache
    return {"launches": counts, "step_s_runs": times, "f32_silu_step_s": f32_step_s,
            "logits_rel_l2_vs_f32_silu": rel,
            **dry_run_vs_card(row, peak, min(times))}, counts["swiglu"]


def swiglu_record(torch, flush, gen, rows: int, d_ff: int) -> dict:
    """F1 on bf16 gate and up [rows, d_ff] against its plain chain on the
    card (bit-equal, or the differing elements counted, each within one
    bf16 ulp of the chain's), two calls bit-equal, then timed beside the
    plain chain and the default f32 SwiGLU, with its bound (gate and up
    read, the output written: 6 bytes an element). No single PyTorch call
    computes it: library_ms is null."""
    from repro_torch.kernels import swiglu as f1

    gate = (torch.randn((rows, d_ff), generator=gen, device="cuda") * 2).to(torch.bfloat16)
    up = torch.randn((rows, d_ff), generator=gen, device="cuda").to(torch.bfloat16)
    fn = lambda: f1.swiglu_bf16_cuda(gate, up)  # noqa: E731
    plain = lambda: f1.swiglu_bf16_plain(gate, up)  # noqa: E731
    f32 = lambda: torch.nn.functional.silu(gate.float()).to(gate.dtype) * up  # noqa: E731
    got, want = fn(), plain()
    require(torch.equal(got, fn()), "F1: two calls differ")
    differ = got != want
    n_diff = int(differ.sum())
    if n_diff:                                   # one bf16 ulp of the chain's value
        w = want.float()[differ]
        ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8)
        worst = float(((got.float()[differ] - w).abs() / ulp).max())
        require(worst <= 1.0, f"F1: {n_diff} elements differ, up to {worst} bf16 ulp")
    n = rows * d_ff
    nbytes = 6 * n
    b_ms, b_by = bound(nbytes, 6 * n, F32_FLOPS)
    err = max_err(torch, got, want)
    del got, want, differ
    rec = {"name": "swiglu_bf16", "route": "cuda",
           "source": "src/repro_torch/kernels/csrc/swiglu.cu",
           "replaces": "none (XLA's loop fusion of src/repro/models/common.py:110 "
                       "under bf16_silu)",
           "max_abs_err": err, "elements_differing": n_diff,
           "ms": time_ms(torch, fn, flush), "plain_ms": time_ms(torch, plain, flush),
           "f32_swiglu_ms": time_ms(torch, f32, flush),
           "bound_ms": b_ms, "bound_by": b_by, "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "library_ms": None, "shape": f"gate, up [{rows},{d_ff}] bf16",
           "bytes": nbytes, "deterministic": True}
    del gate, up
    return rec


# --------------------------------------------------------------------------
# the train phase
# --------------------------------------------------------------------------
def train_batch(torch, cfg, b: int, s: int, seed: int, device, mask: bool = True) -> dict:
    """A batch of the port's data pipeline (tokens, labels with row 0's
    first 5 masked unless not ``mask``, a VLM's or Whisper's stub frontend)
    on ``device``."""
    from repro_torch.data import DataConfig, make_batch

    data = DataConfig(vocab=cfg.vocab, seq_len=s, batch_per_host=b, seed=seed, v_eff=cfg.vocab,
                      frontend=((cfg.n_patches or cfg.enc_seq, cfg.d_model)
                                if cfg.family in ("vlm", "encdec") else None))
    batch = make_batch(data, 0)
    if mask:
        batch["labels"][0, :5] = -100
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def lm_grads(torch, cfg, model, batch) -> tuple[float, dict]:
    """(the loss, {name: gradient}) of `lm_loss` through autograd."""
    from repro_torch.models import lm_loss

    names, params = zip(*model.named_parameters())
    loss, _ = lm_loss(model, cfg, batch)
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return float(loss.detach()), {n: torch.zeros_like(p) if g is None else g
                                  for n, p, g in zip(names, params, grads)}


def grads_agree(torch, got: dict, want: dict, what: str) -> tuple[float, int]:
    """Each leaf of ``got`` within `TRAIN_LEAF_TOL` of the L2 norm of
    ``want``'s (max abs error); a leaf of ``want`` zero up to rounding
    (below `TRAIN_ZERO_TOL` of the global norm: Whisper's key biases, to
    which the row softmax is blind) is held to that on both sides.
    Returns (the worst error over its norm, the zero leaves)."""
    gnorm = float(torch.sqrt(sum(torch.sum(g.double() ** 2) for g in want.values())))
    worst, zero = 0.0, 0
    for name, w in want.items():
        g, w = got[name].detach().cpu(), w.detach().cpu()
        wn = float(w.norm())
        if wn < TRAIN_ZERO_TOL * gnorm:
            zero += 1
            require(float(g.norm()) < TRAIN_ZERO_TOL * gnorm,
                    f"{what} {name}: norm {float(g.norm())} where it is 0 up to rounding")
            continue
        rel = float((g - w).abs().max()) / wn
        require(rel <= TRAIN_LEAF_TOL, f"{what} {name}: max abs err {rel} x its norm")
        worst = max(worst, rel)
    return worst, zero


def reduced_train_leg(torch, arch: str, b: int = 4, s: int = 32) -> dict:
    """Leg (a) for ``arch``, reduced, f32: `lm_loss` and every gradient
    leaf on the card against the port on the CPU from one set of weights
    (redrawn by `randomize_params`) and one batch; a second backward on the
    card bit-equal to the first; one train step at microbatch 2 against
    microbatch 1 (loss and grad norm to `TRAIN_MB_RTOL`, the first moments,
    which hold the step's gradients, leaf by leaf as the gradients)."""
    import copy

    from repro_torch.configs.registry import get_config
    from repro_torch.models import init_lm
    from repro_torch.optim import OptConfig
    from repro_torch.train import make_train_step, train_state

    t = time.perf_counter()
    cfg = get_config(arch).reduced()
    cpu = init_lm(cfg, torch.Generator().manual_seed(SEED), "cpu")
    randomize_params(torch, cpu, SEED + 9)
    card = copy.deepcopy(cpu).to("cuda")
    cpu.requires_grad_(True)
    card.requires_grad_(True)
    batch = train_batch(torch, cfg, b, s, SEED + 2, "cpu")
    cbatch = {k: v.cuda() for k, v in batch.items()}
    loss_c, grads_c = lm_grads(torch, cfg, cpu, batch)
    loss_g, grads_g = lm_grads(torch, cfg, card, cbatch)
    loss_g2, grads_g2 = lm_grads(torch, cfg, card, cbatch)
    loss_rel = abs(loss_g - loss_c) / abs(loss_c)
    require(loss_rel < TRAIN_LOSS_RTOL, f"{arch} reduced train loss: card {loss_g} CPU {loss_c}")
    worst, zero_leaves = grads_agree(torch, grads_g, grads_c, f"{arch} reduced grad")
    differ = {n: max_err(torch, grads_g2[n], g) for n, g in grads_g.items()
              if not torch.equal(grads_g2[n], g)}
    require(not differ and loss_g2 == loss_g,
            f"{arch}: two backward passes on the card differ: {differ}")
    del grads_c, grads_g, grads_g2
    # no label masked here: `repro`'s microbatch loss is the mean of the
    # microbatches' means, the whole batch's mean only where each
    # microbatch counts as many labels
    mbatch = train_batch(torch, cfg, b, s, SEED + 2, "cuda", mask=False)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=10, eps=1e-6)
    out = {}
    for mb in (1, 2):
        state = train_state(copy.deepcopy(card))
        state, metrics = make_train_step(cfg, opt, microbatch=mb)(state, mbatch)
        out[mb] = ({k: float(v) for k, v in metrics.items()}, state["opt"]["m"])
    for key in ("loss", "grad_norm"):
        rel = abs(out[2][0][key] - out[1][0][key]) / abs(out[1][0][key])
        require(rel <= TRAIN_MB_RTOL, f"{arch}: microbatch 2 {key} {out[2][0][key]} vs "
                f"{out[1][0][key]}")
    mb_err, _ = grads_agree(torch, out[2][1], out[1][1], f"{arch} microbatch 2 first moment")
    return {"arch": arch, "loss": loss_g, "loss_rel_err": loss_rel,
            "worst_leaf_err_over_norm": worst, "zero_leaves": zero_leaves,
            "leaves": len(out[1][1]), "backward_bit_equal": True,
            "microbatch2_loss": out[2][0]["loss"], "microbatch2_loss_rel_err": abs(
                out[2][0]["loss"] - out[1][0]["loss"]) / abs(out[1][0]["loss"]),
            "microbatch2_worst_leaf_err_over_norm": mb_err,
            "seconds": time.perf_counter() - t}


def state_arrays_equal(torch, a: dict, b: dict) -> bool:
    """Two train states' parameters, masters, moments and count bit-equal."""
    pa, pb = dict(a["params"].named_parameters()), dict(b["params"].named_parameters())
    same = all(torch.equal(p, pb[n]) for n, p in pa.items())
    for key in ("master", "m", "v"):
        same = same and all(torch.equal(t, b["opt"][key][n]) for n, t in a["opt"][key].items())
    return same and torch.equal(a["opt"]["count"], b["opt"]["count"])


def train_resume_leg(torch) -> dict:
    """Leg (a)'s resume: the port's Trainer on the card (reduced tinyllama
    with GQA, checkpoints every 2 steps), a failure injected at step 4 and
    a new Trainer resuming: the losses and the state bit-equal to an
    uninterrupted 6-step run's."""
    import shutil
    import tempfile

    from repro_torch.configs.registry import get_config
    from repro_torch.data import DataConfig
    from repro_torch.optim import OptConfig
    from repro_torch.train import SimulatedFailure, Trainer
    from repro_torch.utils import MetricLogger

    cfg = get_config("tinyllama-1.1b").reduced(**GQA)
    opt = OptConfig(lr=1e-3, warmup_steps=2, total_steps=6)
    data = DataConfig(vocab=cfg.vocab, seq_len=32, batch_per_host=4, seed=SEED, v_eff=cfg.vocab)
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_resume_"))
    try:
        def trainer(name, **kw):
            return Trainer(cfg, opt, data, ckpt_dir=str(work / name), ckpt_every=2,
                           logger=MetricLogger(stream=io.StringIO()), device="cuda", **kw)

        whole = trainer("a").init_or_resume(SEED)
        hist = whole.run(6)
        first = trainer("b", inject_failure_at=4).init_or_resume(SEED)
        try:
            first.run(6)
            require(False, "train resume: the injected failure did not fire")
        except SimulatedFailure:
            pass
        second = trainer("b").init_or_resume(SEED)
        require(second.step == 4, f"train resume: resumed at step {second.step}, expected 4")
        tail = second.run(6)
        require(tail == hist[4:], f"train resume: losses {tail} vs {hist[4:]}")
        require(state_arrays_equal(torch, second.state, whole.state),
                "train resume: the resumed state differs from the uninterrupted run's")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {"config": "tinyllama-1.1b reduced(GQA) f32", "steps": 6, "failed_at": 4,
            "resumed_at": 4, "losses": hist, "bit_equal": True}


def train_full_leg(torch, ops) -> dict:
    """Legs (b) and (c): tinyllama-1.1b at full width and depth, bf16
    parameters, remat, ``TRAIN_FULL`` through ``launch/train.py``'s `main`
    with a temporary checkpoint directory (one checkpoint, at the last
    step); the losses gated; the checkpoint's parameters read back (the
    serving restore) bit-equal; a second run from the same seed (the step
    function alone) bit-equal; one more step profiled. Then ``launch/serve.py --ckpt-dir`` on the checkpoint
    against an `Engine` on the trainer's parameters in memory: the same
    greedy tokens. The directory is removed in any case. The run's peak
    memory is held to the dry run's row at its shape on the one-rank host
    mesh (`dry_run_vs_card`), the one check of the counter's training
    temporaries against the card."""
    import math
    import shutil
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.checkpoint import load_checkpoint_tensors, unflatten
    from repro_torch.configs.shapes import ShapeSpec
    from repro_torch.data import make_batch
    from repro_torch.launch import serve as serve_cli
    from repro_torch.launch import train as train_cli
    from repro_torch.models import init_lm
    from repro_torch.models.convert import tree_to_named
    from repro_torch.parallel import roofline
    from repro_torch.serve import Engine, cache_rows
    from repro_torch.train import init_train_state, make_train_step
    from repro_torch.utils import tree_bytes, tree_param_count

    f = TRAIN_FULL
    work = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        trainer = train_cli.main([
            "--arch", f["arch"], "--steps", str(f["steps"]), "--batch", str(f["batch"]),
            "--seq", str(f["seq"]), "--lr", str(f["lr"]), "--ckpt-dir", str(work),
            "--ckpt-every", str(f["steps"]), "--seed", str(SEED)])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t
        peak = torch.cuda.max_memory_allocated()
        cfg, state = trainer.cfg, trainer.state
        losses = trainer.losses
        ln_v = math.log(cfg.vocab)
        require(all(math.isfinite(x) for x in losses), f"train: non-finite loss {losses}")
        require(abs(losses[0] - ln_v) <= 0.05 * ln_v,
                f"train: first loss {losses[0]} not within 5% of ln {cfg.vocab} = {ln_v}")
        require(losses[-1] < losses[0], f"train: loss did not fall: {losses}")
        n_params = tree_param_count(state["params"])
        total, active = roofline.param_counts(cfg)
        require(total == active == n_params,
                f"train: the roofline counts {total} / {active} parameters, the state {n_params}")
        tokens = f["batch"] * f["seq"]
        step_s = sorted(trainer.step_seconds[1:])[len(trainer.step_seconds[1:]) // 2]
        step_flops = roofline.model_flops(cfg, "train", f["batch"], f["seq"], n_active=active)
        # the dry run's row at this shape on the one-rank host mesh: the
        # counter's training temporaries (remat) against the card's peak
        dry = dryrun_rows([(f["arch"], "train_512", "host",
                            ShapeSpec("train_512", f["seq"], f["batch"], "train"))])
        dry_vs_card = dry_run_vs_card(dry[f"{f['arch']}/train_512/host"], peak, step_s)
        param_bytes = tree_bytes(state["params"])
        opt_bytes = sum(tree_bytes(state["opt"][k]) for k in ("master", "m", "v"))
        ckpt = dict(trainer.checkpoints[-1])
        ckpt_bytes = sum(p.stat().st_size for p in work.rglob("*") if p.is_file())

        # the serving restore (what leg (c)'s CLI reads): the parameters
        # alone, bit-equal to the trainer's
        t = time.perf_counter()
        loaded = load_checkpoint_tensors(str(work), f["steps"], "cuda", prefix="params")
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t
        params = tree_to_named(state["params"], unflatten(loaded)["params"])
        require(all(torch.equal(params[n], p) for n, p in state["params"].named_parameters()),
                "train: the checkpoint's parameters differ from the trainer's")
        del loaded, params

        # a second run from the same seed: the step function over the same
        # batches, bit-equal parameters and masters
        state2 = init_train_state(cfg, trainer.opt_cfg, SEED, "cuda")
        step_fn = make_train_step(cfg, trainer.opt_cfg)
        for i in range(f["steps"]):
            state2, _ = step_fn(state2, make_batch(trainer.data_cfg, i))
        require(state_arrays_equal(torch, state2, state),
                "train: two runs from the same seed differ")
        batch = make_batch(trainer.data_cfg, f["steps"])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            state2, _ = step_fn(state2, batch)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        step_profile = {"wall_ms": wall_us / 1e3, **device_busy(prof, wall_us, 1, "step")}
        del state2, prof
        next_model(torch)
        train_counts = ops.launch_counts()

        # (c) serve from the checkpoint through the CLI, against an Engine
        # on the trainer's parameters in memory
        s = TRAIN_SERVE
        ops.reset_launch_counts()
        t = time.perf_counter()
        res = serve_cli.main(["--arch", f["arch"], "--ckpt-dir", str(work),
                              "--batch", str(s["batch"]), "--prompt-len", str(s["prompt"]),
                              "--max-new", str(s["new"]), "--seed", str(SEED)])
        torch.cuda.synchronize()
        serve_s = time.perf_counter() - t
        serve_counts = ops.launch_counts()
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        init_lm(cfg, gen, "cuda")                  # the CLI's draws before its prompts
        prompts = torch.randint(0, cfg.vocab, (s["batch"], s["prompt"]), generator=gen,
                                device="cuda", dtype=torch.int32)
        want = Engine(cfg, state["params"],
                      s_max=cache_rows(cfg, s["prompt"], s["new"]) + 1).generate(
                          prompts, max_new=s["new"])
        require(torch.equal(res.tokens, want.tokens),
                "train: tokens served from the checkpoint differ from the in-memory model's")
        require(serve_counts["flash_attention"] == cfg.n_layers
                and serve_counts["decode_attention"] == cfg.n_layers * (s["new"] - 1),
                f"train: serving from the checkpoint launched {serve_counts}")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return {
        "arch": cfg.name, "params": n_params, "param_dtype": cfg.param_dtype, "remat": cfg.remat,
        "batch": f["batch"], "seq": f["seq"], "steps": f["steps"], "lr": f["lr"],
        "losses": losses, "ln_vocab": ln_v, "run_s": run_s,
        "step_ms": [x * 1e3 for x in trainer.step_seconds],
        "median_step_ms_2_4": step_s * 1e3, "tokens_per_s": tokens / step_s,
        "model_flops": step_flops,
        "model_flop_share": step_flops / step_s / roofline.PEAK_FLOPS,
        "peak_memory_bytes": peak, "param_bytes": param_bytes, "opt_bytes": opt_bytes,
        "train_state_bytes": param_bytes + opt_bytes, "dryrun": dry_vs_card,
        "checkpoint": {**ckpt, "bytes_on_disk": ckpt_bytes, "params_restore_s": restore_s,
                       "params_restore_bit_equal": True},
        "two_runs_bit_equal": True, "profiled_step": step_profile,
        "train_launches": train_counts,
        "serve_from_checkpoint": {"batch": s["batch"], "prompt": s["prompt"],
                                  "new_tokens": s["new"], "cli_s": serve_s,
                                  "launches": serve_counts, "tokens_equal_in_memory": True},
    }


def train_phase(torch, ops) -> tuple[dict, dict]:
    """The train phase: leg (a) on the ten reduced archs and the resume,
    leg (b) at full width, leg (c) serving its checkpoint (module
    docstring). Training launches no K4, K5 or K6 (none of the kernels).
    Returns (rows, leg (c)'s launches)."""
    from repro_torch.configs.registry import ARCHS

    t = time.perf_counter()
    ops.reset_launch_counts()
    reduced = [reduced_train_leg(torch, arch) for arch in sorted(ARCHS)]
    resume = train_resume_leg(torch)
    reduced_s = time.perf_counter() - t
    next_model(torch)
    full = train_full_leg(torch, ops)
    counts = full.pop("train_launches")
    require(all(c == 0 for c in counts.values()), f"training launched kernels: {counts}")
    return {"reduced": reduced, "resume": resume, "reduced_s": reduced_s, "full": full,
            "train_launches": counts, "seconds": time.perf_counter() - t}, \
        full["serve_from_checkpoint"]["launches"]


def sass_counts(lib_path) -> dict:
    """Tensor-core instructions in a built kernel library's SASS."""
    from repro_torch.kernels import _build

    cuobjdump = pathlib.Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib_path)], capture_output=True,
                          text=True, timeout=120, check=True).stdout
    return {op: len([w for w in sass.split() if w.startswith(op + ".") or w == op])
            for op in ("HGMMA", "HMMA")}


def device_events(torch, fn, calls: int, cpu: bool) -> list:
    """The device events of ``calls`` calls of ``fn()`` (after one warm-up
    call) under torch.profiler. The profiler on the card loses kernel
    events near the edges of a window, more the longer the process has run
    (a window of 20 short calls lost them all late in a run), so the window
    is padded with idle time on both sides; a window that recorded no
    device event at all (the instrument's loss: every call launches a
    kernel) is profiled again, up to PROFILE_TRIES times, the pad doubled
    each time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CPU] if cpu else []
    pad = PROFILE_PAD_S
    for _ in range(PROFILE_TRIES):
        with profile(activities=activities + [ProfilerActivity.CUDA]) as prof:
            time.sleep(pad)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(pad)
        events = [e for e in prof.events()
                  if str(getattr(e, "device_type", "")).endswith("CUDA")]
        if events:
            return events
        pad *= 2
    return events


def profiled_kernel_names(torch, fn, calls: int = 20) -> set:
    """The names of the device kernels ``fn()`` launches, under
    torch.profiler. The profiler loses kernel events late in a long run, so
    it names kernels and counts none: `graph_kernel_nodes` counts them."""
    return {e.name for e in device_events(torch, fn, calls, cpu=True)}


def graph_kernel_nodes(torch, fn) -> tuple[int, int]:
    """(kernel nodes, all nodes) of a CUDA graph captured around one
    ``fn()`` call: the device kernels a call launches, counted exactly
    (torch.profiler loses kernel events late in a long run), through the
    CUDA runtime this process has loaded."""
    import ctypes

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph):
        fn()
    with open("/proc/self/maps") as f:
        paths = {line.split()[-1] for line in f if "libcudart.so" in line}
    require(len(paths) >= 1, "no CUDA runtime library loaded in this process")
    cudart = ctypes.CDLL(sorted(paths)[0])
    handle = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    require(cudart.cudaGraphGetNodes(handle, None, ctypes.byref(n)) == 0, "cudaGraphGetNodes")
    nodes = (ctypes.c_void_p * n.value)()
    require(cudart.cudaGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0, "cudaGraphGetNodes")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        require(cudart.cudaGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)) == 0,
                "cudaGraphNodeGetType")
        kernels += kind.value == 0          # cudaGraphNodeTypeKernel
    return kernels, n.value


def device_ms_by_kernel(torch, fn, calls: int = 10) -> dict:
    """Device time per ``fn()`` call of each kernel it launches, under
    torch.profiler, by name (templated names cut to the kernel's)."""
    import re

    out = {}
    for e in device_events(torch, fn, calls, cpu=False):
        found = re.search(r"\w+_kernel\w*(<[^>]*>)?", e.name)
        name = found.group(0) if found else e.name[:60]
        out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / calls
    return out


def bound(nbytes: float, flops: float, peak_flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def attention_serve_kernels(torch, flush) -> dict:
    """K4 and K5 at the serving shapes: held against their plain versions
    on the card, then timed beside the plain version and one PyTorch call."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4

    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    b, hq, hkv, d = SERVE["batch"], 32, 4, 64
    bf16, s, s_max, kv = torch.bfloat16, SERVE["prompt"], SERVE["s_max"], SERVE["prompt"] + 64
    q = torch.randn((b, hq, s, d), generator=gen, device="cuda").to(bf16)
    k = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(bf16)
    v = torch.randn((b, hkv, s, d), generator=gen, device="cuda").to(bf16)
    k4_err = check_rows(torch, k4.flash_attention_cuda(q, k, v), k4.flash_attention_plain(q, k, v),
                        SERVE_ROW_REL_TOL, "K4 at the serving shape")
    qd = torch.randn((b, hq, d), generator=gen, device="cuda").to(bf16)
    kc = torch.randn((b, hkv, s_max, d), generator=gen, device="cuda").to(bf16)
    vc = torch.randn((b, hkv, s_max, d), generator=gen, device="cuda").to(bf16)
    kv_len = torch.full((b,), kv, dtype=torch.int32, device="cuda")
    got = k5.decode_attention_cuda(qd, kc, vc, kv_len, return_lse=True)
    want = k5.decode_attention_plain(qd, kc, vc, kv_len, return_lse=True)
    k5_err = check_rows(torch, got[0], want[0], SERVE_ROW_REL_TOL, "K5 at the serving shape")
    for a, w, part in zip(got[1:], want[1:], "ml"):
        check_close(torch, a, w, ATTN_TOL["float32"], f"K5 {part} at the serving shape")
    mask = (torch.arange(s_max, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]

    el = 2  # bytes per bf16 element
    k4_bytes = el * (2 * b * hq * s * d + 2 * b * hkv * s * d)
    k4_flops = 4 * d * b * hq * s * (s + 1) // 2       # q.k and p.v over the causal pairs
    k5_bytes = el * (2 * b * hkv * kv * d + 2 * b * hq * d) + 4 * b
    k5_flops = 4 * d * b * hq * kv
    k4_bound, k4_by = bound(k4_bytes, k4_flops, BF16_FLOPS)
    k5_bound, k5_by = bound(k5_bytes, k5_flops, BF16_FLOPS)
    k4_fn = lambda: k4.flash_attention_cuda(q, k, v)  # noqa: E731
    k5_fn = lambda: k5.decode_attention_cuda(qd, kc, vc, kv_len)  # noqa: E731
    # deterministic: two calls bit-equal; K5's single-launch combine gives
    # the eager result from every replay of one CUDA graph
    require(torch.equal(k4_fn(), k4_fn()), "K4: two calls differ")
    eager = k5_fn()
    require(torch.equal(eager, k5_fn()), "K5: two calls differ")
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = k5_fn()
    for i in range(3):
        replayed.zero_()
        graph.replay()
        torch.cuda.synchronize()
        require(torch.equal(replayed, eager), f"K5: CUDA-graph replay {i} differs from eager")
    # one device kernel a call, counted as the nodes of a captured call,
    # and K5's own by name under torch.profiler
    k5_nodes = graph_kernel_nodes(torch, k5_fn)
    require(k5_nodes == (1, 1), f"K5 captures {k5_nodes} (kernel, all) graph nodes a call, "
            "expected one kernel")
    k5_names = profiled_kernel_names(torch, k5_fn)
    require(len(k5_names) == 1 and "decode_attention" in next(iter(k5_names)),
            f"K5 runs device kernels {k5_names} under torch.profiler, expected its own only")
    k4_ms = graph_ms(torch, k4_fn, flush)

    # K4 at DeepSeek-V2's MLA prefill shape: 16 heads of 192 (v padded)
    h192, d192 = 16, 192
    q2, k2, v2 = (torch.randn((b, h192, s, d192), generator=gen, device="cuda").to(bf16)
                  for _ in range(3))
    mla_fn = lambda: k4.flash_attention_cuda(q2, k2, v2)  # noqa: E731
    mla_err = check_rows(torch, mla_fn(), k4.flash_attention_plain(q2, k2, v2),
                         SERVE_ROW_REL_TOL, "K4 at the MLA prefill shape")
    require(torch.equal(mla_fn(), mla_fn()), "K4 at D 192: two calls differ")
    mla_bytes = el * 4 * b * h192 * s * d192
    mla_flops = 4 * d192 * b * h192 * s * (s + 1) // 2
    mla_bound, mla_by = bound(mla_bytes, mla_flops, BF16_FLOPS)
    mla_ms = graph_ms(torch, mla_fn, flush)
    return {
        "flash_attention": {
            "name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:97",
            **k4_err,
            "ms": k4_ms, "tflops": k4_flops / k4_ms / 1e9,
            "plain_ms": graph_ms(torch, lambda: k4.flash_attention_plain(q, k, v), flush),
            "bound_ms": k4_bound, "bound_by": k4_by,
            "library_ms": graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), flush),
            "eager_ms": time_ms(torch, k4_fn, flush),
            "shape": f"q [{b},{hq},{s},{d}] kv [{b},{hkv},{s},{d}] bf16 causal",
            "bytes": k4_bytes, "flops": k4_flops, "deterministic": True,
        },
        "decode_attention": {
            "name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
            "replaces": "src/repro/kernels/decode_attention.py:78",
            **k5_err,
            "ms": graph_ms(torch, k5_fn, flush),
            "plain_ms": graph_ms(torch, lambda: k5.decode_attention_plain(qd, kc, vc, kv_len), flush),
            "bound_ms": k5_bound, "bound_by": k5_by,
            "library_ms": graph_ms(torch, lambda: F.scaled_dot_product_attention(
                qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True), flush),
            "eager_ms": time_ms(torch, k5_fn, flush),
            "shape": f"q [{b},{hq},{d}] caches [{b},{hkv},{s_max},{d}] bf16 kv_len {kv}",
            "bytes": k5_bytes, "flops": k5_flops, "device_kernels_per_call": k5_nodes[0],
            "deterministic": True,
        },
        "flash_attention_d192": {
            "name": "flash_attention_d192", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:97",
            **mla_err,
            "ms": mla_ms, "tflops": mla_flops / mla_ms / 1e9,
            "plain_ms": graph_ms(torch, lambda: k4.flash_attention_plain(q2, k2, v2), flush),
            "bound_ms": mla_bound, "bound_by": mla_by,
            "bound_ops_ms": mla_flops / BF16_FLOPS * 1e3,
            "library_ms": graph_ms(torch, lambda: F.scaled_dot_product_attention(
                q2, k2, v2, is_causal=True), flush),
            "eager_ms": time_ms(torch, mla_fn, flush),
            "shape": f"q, k, v [{b},{h192},{s},{d192}] bf16 causal (MLA prefill)",
            "bytes": mla_bytes, "flops": mla_flops, "deterministic": True,
        },
    }


def attention_record(torch, flush, name, source_kernel, fn, plain, library, err, nbytes,
                     flops, shape, plain_reps: int | None = None) -> dict:
    """A K4 or K5 call ``fn`` at one shape, already held to its plain
    version (``err``): two calls bit-equal, then it, the plain version and
    the ``library`` call timed replayed from a CUDA graph (the eager time
    beside), with the bound of ``nbytes`` and ``flops`` (bf16). With
    ``plain_reps`` the plain version is timed eager over that many calls
    (a graph would keep every block's buffers of a blocked plain version)."""
    require(torch.equal(fn(), fn()), f"{name}: two calls differ")
    ms = graph_ms(torch, fn, flush)
    plain_ms = (graph_ms(torch, plain, flush) if plain_reps is None
                else time_ms(torch, plain, flush, reps=plain_reps, warmup=1))
    b_ms, b_by = bound(nbytes, flops, BF16_FLOPS)
    rec = {"name": name, "route": "cuda",
           "source": f"src/repro_torch/kernels/csrc/{source_kernel}.cu",
           "replaces": ("src/repro/kernels/flash_attention.py:97"
                        if source_kernel == "flash_attention"
                        else "src/repro/kernels/decode_attention.py:78"),
           **err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "bound_bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
           "bound_ops_ms": flops / BF16_FLOPS * 1e3,
           "library_ms": graph_ms(torch, library, flush), "eager_ms": time_ms(torch, fn, flush),
           "shape": shape, "bytes": nbytes, "flops": flops, "deterministic": True}
    if source_kernel == "flash_attention":
        rec["tflops"] = flops / ms / 1e9
    return rec


def wide_head_attention_kernels(torch, flush) -> dict:
    """K4 and K5 at the head widths of h2o-danube-3-4b (120) and zamba2-7b's
    shared attention (224), at their serving shapes (phases 7e and 7f):
    held against their plain versions on the card, two calls bit-equal,
    then timed as in phase 13 beside their bounds, the plain version and
    one PyTorch call (SDPA: causal for zamba's prefill, a boolean window
    mask for h2o's, a boolean kv_len mask for decode)."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    bf16, el = torch.bfloat16, 2

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    def record(*args):
        return attention_record(torch, flush, *args)

    out = {}
    # zamba2-7b's shared-attention prefill: [8, 32, 1024, 224] causal MHA
    b, h, s, d = SERVE["batch"], 32, SERVE["prompt"], 224
    q, k, v = randn(b, h, s, d), randn(b, h, s, d), randn(b, h, s, d)
    fn = lambda: k4.flash_attention_cuda(q, k, v)  # noqa: E731
    plain = lambda: k4.flash_attention_plain(q, k, v)  # noqa: E731
    err = check_rows(torch, fn(), plain(), SERVE_ROW_REL_TOL, "K4 at zamba2-7b's prefill shape")
    out["flash_attention_d224"] = record(
        "flash_attention_d224", "flash_attention", fn, plain,
        lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True), err,
        el * 4 * b * h * s * d, 4 * d * b * h * s * (s + 1) // 2,
        f"q, k, v [{b},{h},{s},{d}] bf16 causal (zamba2-7b shared attention)")
    del q, k, v

    # zamba2-7b's decode: one token against 1024 of 1152 cache positions
    s_max, kv = SERVE["s_max"], SERVE["prompt"]
    qd, kc, vc = randn(b, h, d), randn(b, h, s_max, d), randn(b, h, s_max, d)
    kv_len = torch.full((b,), kv, dtype=torch.int32, device="cuda")
    mask = (torch.arange(s_max, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
    fn = lambda: k5.decode_attention_cuda(qd, kc, vc, kv_len)  # noqa: E731
    plain = lambda: k5.decode_attention_plain(qd, kc, vc, kv_len)  # noqa: E731
    got = k5.decode_attention_cuda(qd, kc, vc, kv_len, return_lse=True)
    want = k5.decode_attention_plain(qd, kc, vc, kv_len, return_lse=True)
    err = check_rows(torch, got[0], want[0], SERVE_ROW_REL_TOL, "K5 at zamba2-7b's decode shape")
    for a, w, part in zip(got[1:], want[1:], "ml"):
        check_close(torch, a, w, ATTN_TOL["float32"], f"K5 {part} at zamba2-7b's decode shape")
    out["decode_attention_d224"] = record(
        "decode_attention_d224", "decode_attention", fn, plain,
        lambda: F.scaled_dot_product_attention(qd[:, :, None], kc, vc, attn_mask=mask), err,
        el * (2 * b * h * kv * d + 2 * b * h * d) + 4 * b, 4 * d * b * h * kv,
        f"q [{b},{h},{d}] caches [{b},{h},{s_max},{d}] bf16 kv_len {kv} (zamba2-7b)")
    del qd, kc, vc, got, want

    # h2o-danube-3-4b's prefill: q [4, 32, 4608, 120], kv [4, 8, 4608, 120],
    # window 4096 (the operations of the pairs the window keeps)
    b, hq, hkv, s, d, w = H2O_SERVE["batch"], 32, 8, H2O_SERVE["prompt"], 120, 4096
    q, k, v = randn(b, hq, s, d), randn(b, hkv, s, d), randn(b, hkv, s, d)
    wmask = k4.attention_mask(s, s, causal=True, window=w, device="cuda")
    fn = lambda: k4.flash_attention_cuda(q, k, v, window=w)  # noqa: E731
    plain = lambda: k4.flash_attention_plain(q, k, v, window=w)  # noqa: E731
    err = check_rows(torch, fn(), plain(), SERVE_ROW_REL_TOL, "K4 at h2o-danube-3-4b's prefill")
    pairs = w * (w + 1) // 2 + (s - w) * w
    out["flash_attention_d120"] = record(
        "flash_attention_d120", "flash_attention", fn, plain,
        lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=wmask, enable_gqa=True), err,
        el * (2 * b * hq * s * d + 2 * b * hkv * s * d), 4 * d * b * hq * pairs,
        f"q [{b},{hq},{s},{d}] kv [{b},{hkv},{s},{d}] bf16 causal window {w} (h2o-danube-3-4b)")
    del q, k, v, wmask

    # h2o-danube-3-4b's ring decode: the 4096-slot ring, wrapped (kv_len W)
    qd, kc, vc = randn(b, hq, d), randn(b, hkv, w, d), randn(b, hkv, w, d)
    kv_len = torch.full((b,), w, dtype=torch.int32, device="cuda")
    mask = torch.ones((b, 1, 1, w), dtype=torch.bool, device="cuda")
    fn = lambda: k5.decode_attention_cuda(qd, kc, vc, kv_len)  # noqa: E731
    plain = lambda: k5.decode_attention_plain(qd, kc, vc, kv_len)  # noqa: E731
    err = check_rows(torch, fn(), plain(), SERVE_ROW_REL_TOL, "K5 at h2o-danube-3-4b's ring")
    out["decode_attention_d120"] = record(
        "decode_attention_d120", "decode_attention", fn, plain,
        lambda: F.scaled_dot_product_attention(qd[:, :, None], kc, vc, attn_mask=mask,
                                               enable_gqa=True), err,
        el * (2 * b * hkv * w * d + 2 * b * hq * d) + 4 * b, 4 * d * b * hq * w,
        f"q [{b},{hq},{d}] ring [{b},{hkv},{w},{d}] bf16 kv_len {w} (h2o-danube-3-4b)")
    return out


def encdec_vlm_attention_kernels(torch, flush) -> dict:
    """K4 and K5 at the serving shapes of phases 7g-7i: whisper-base's
    encoder ([8,8,1500,64], no mask), its cross prefill (q [8,8,64,64]
    against 1500 keys, no mask) and cross decode (the full 1500-row cache),
    its causal self prefill (q = kv = [8,8,64,64]) and self decode (a
    448-row cache at kv_len 256, mid-generate),
    internvl2-1b's group 7 at D 64 and command-r-plus-104b's group 12 at D
    128 (prefill causal over 1024 positions, decode against 1024 of 1152
    cache rows). Each held against its plain version (every output row
    within 1e-2 of its norm), two calls bit-equal, timed as in phase 13
    beside its bound, the plain version and SDPA (no mask, causal with GQA,
    or a kv_len mask). Each record carries the `AttentionShapes` key whose
    launches it reports."""
    import torch.nn.functional as F

    from repro_torch.kernels import decode_attention as k5
    from repro_torch.kernels import flash_attention as k4

    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    bf16, el = torch.bfloat16, 2

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(bf16)

    out = {}
    k4_cases = [  # name, b, hq, hkv, sq, skv, d, causal, what
        ("flash_attention_whisper_encoder", 8, 8, 8, 1500, 1500, 64, False,
         "whisper-base encoder"),
        ("flash_attention_whisper_cross", 8, 8, 8, WHISPER_SERVE["prompt"], 1500, 64, False,
         "whisper-base cross prefill"),
        ("flash_attention_whisper_self", 8, 8, 8, WHISPER_SERVE["prompt"],
         WHISPER_SERVE["prompt"], 64, True, "whisper-base causal self prefill"),
        ("flash_attention_group7", 8, 14, 2, 1024, 1024, 64, True,
         "internvl2-1b: 256 patches + 768 tokens"),
        ("flash_attention_group12", 8, 96, 8, 1024, 1024, 128, True,
         "command-r-plus-104b"),
    ]
    for name, b, hq, hkv, sq, skv, d, causal, what in k4_cases:
        q, k, v = randn(b, hq, sq, d), randn(b, hkv, skv, d), randn(b, hkv, skv, d)
        fn = lambda: k4.flash_attention_cuda(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: k4.flash_attention_plain(q, k, v, causal=causal)  # noqa: E731
        err = check_rows(torch, fn(), plain(), SERVE_ROW_REL_TOL, f"K4 at {what}")
        pairs = sq * (sq + 1) // 2 if causal else sq * skv
        library = (lambda: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=causal, enable_gqa=hq != hkv))
        rec = attention_record(
            torch, flush, name, "flash_attention", fn, plain, library, err,
            el * (2 * b * hq * sq * d + 2 * b * hkv * skv * d), 4 * d * b * hq * pairs,
            f"q [{b},{hq},{sq},{d}] kv [{b},{hkv},{skv},{d}] bf16 "
            f"{'causal' if causal else 'no mask'} ({what})")
        out[name] = {**rec, "shape_key": k4_key(q.shape, k.shape, causal)}
        del q, k, v
    k5_cases = [  # name, b, hq, hkv, s_max, kv, d, what
        ("decode_attention_whisper_cross", 8, 8, 8, 1500, 1500, 64,
         "whisper-base cross decode"),
        # the self cache at mid-generate: 64 prompt + 192 of 384 new tokens
        ("decode_attention_whisper_self", 8, 8, 8, WHISPER_SERVE["s_max"],
         WHISPER_SERVE["prompt"] + WHISPER_SERVE["new"] // 2, 64,
         "whisper-base self decode"),
        ("decode_attention_group7", 8, 14, 2, INTERNVL_SERVE["s_max"], 1024, 64,
         "internvl2-1b"),
        ("decode_attention_group12", 8, 96, 8, SERVE["s_max"], 1024, 128,
         "command-r-plus-104b"),
    ]
    for name, b, hq, hkv, s_max, kv, d, what in k5_cases:
        qd, kc, vc = randn(b, hq, d), randn(b, hkv, s_max, d), randn(b, hkv, s_max, d)
        kv_len = torch.full((b,), kv, dtype=torch.int32, device="cuda")
        mask = (torch.arange(s_max, device="cuda")[None, :] < kv_len[:, None])[:, None, None, :]
        fn = lambda: k5.decode_attention_cuda(qd, kc, vc, kv_len)  # noqa: E731
        plain = lambda: k5.decode_attention_plain(qd, kc, vc, kv_len)  # noqa: E731
        got = k5.decode_attention_cuda(qd, kc, vc, kv_len, return_lse=True)
        want = k5.decode_attention_plain(qd, kc, vc, kv_len, return_lse=True)
        err = check_rows(torch, got[0], want[0], SERVE_ROW_REL_TOL, f"K5 at {what}")
        for a, w, part in zip(got[1:], want[1:], "ml"):
            check_close(torch, a, w, ATTN_TOL["float32"], f"K5 {part} at {what}")
        library = (lambda: F.scaled_dot_product_attention(  # noqa: E731
            qd[:, :, None], kc, vc, attn_mask=mask, enable_gqa=hq != hkv))
        rec = attention_record(
            torch, flush, name, "decode_attention", fn, plain, library, err,
            el * (2 * b * hkv * kv * d + 2 * b * hq * d) + 4 * b, 4 * d * b * hq * kv,
            f"q [{b},{hq},{d}] cache [{b},{hkv},{s_max},{d}] bf16 kv_len {kv} ({what})")
        out[name] = {**rec, "shape_key": k5_key(qd.shape, kc.shape)}
        del qd, kc, vc, got, want
    return out


def wkv6_inputs(torch, gen, b: int, s: int, h: int, n: int, device):
    """f32 r, k, v, logw [B,S,H,N], u [H,N], state0 [B,H,N,N] from ``gen``:
    decays from strong (w = exp(-e^2)) to weak (exp(-e^-6)), a nonzero
    starting state."""
    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=device) * scale
    logw = -torch.exp(torch.rand((b, s, h, n), generator=gen, device=device) * 8.0 - 6.0)
    return (randn(b, s, h, n), randn(b, s, h, n), randn(b, s, h, n), logw,
            randn(h, n, scale=0.3), randn(b, h, n, n, scale=0.1))


def wkv6_small_checks(torch) -> dict:
    """K6 on small odd shapes on the card against its plain version on the
    CPU, f32; both write the final state over their state0."""
    from repro_torch.kernels import wkv6 as k6

    gen = torch.Generator().manual_seed(SEED)
    cases = [  # b, s, h, n: token-serial, spread, whole and ragged chunks
        (1, 1, 1, 8), (2, 7, 3, 16), (3, 64, 4, 32), (2, 129, 2, 80),
        (1, 129, 4, 8), (3, 1, 4, 80), (2, 64, 1, 80), (1, 7, 2, 32),
        (2, 63, 2, 80), (2, 65, 3, 80), (1, 1024, 2, 80), (2, 200, 2, 16),
    ]
    errs = {}
    for b, s, h, n in cases:
        cpu = wkv6_inputs(torch, gen, b, s, h, n, "cpu")
        card = [t.cuda() for t in cpu]
        again = k6.wkv6_cuda(*card[:5], card[5].clone())
        y, st = k6.wkv6_cuda(*card)
        wy, wst = k6.wkv6_plain(*cpu)
        torch.cuda.synchronize()
        name = f"k6 {(b, s, h, n)}"
        require(st is card[5] and wst is cpu[5], f"{name}: state not written over state0")
        require(torch.equal(y, again[0]) and torch.equal(st, again[1]),
                f"{name}: two calls differ")
        errs[f"{name} y"] = check_close(torch, y.cpu(), wy, WKV_TOL, f"{name} y")
        errs[f"{name} state"] = check_close(torch, st.cpu(), wst, WKV_TOL, f"{name} state")
    return {"cases": len(cases), "max_abs_err": max(errs.values()), "tol": WKV_TOL}


def exact_sums_check(torch, np) -> dict:
    """Item 19 on the card: bin sums of odd degrees past 2^24 (90 % of the
    mass in one part) do not change when the vertices are permuted or the
    sum repeated, and equal the CPU's (the exact sum rounded once)."""
    from repro_torch.core import metrics

    rng = np.random.default_rng(19)
    n, k = 4_000_001, 4
    deg = (rng.integers(0, 1000, n) * 2 + 1).astype(np.float32)
    labels = np.where(rng.random(n) < 0.9, 0, rng.integers(1, k, n)).astype(np.int32)
    other = rng.integers(0, k, n).astype(np.int32)
    mass = np.bincount(labels, weights=deg.astype(np.float64), minlength=k)
    require(mass.max() > 2 ** 24, "exact sums: no bin past 2^24")
    want = metrics.bin_sums(torch.from_numpy(labels), torch.from_numpy(deg), k)
    want_moved = metrics.moved_sums(torch.from_numpy(other), torch.from_numpy(labels),
                                    torch.from_numpy(deg), k)
    for order in (np.arange(n), rng.permutation(n), rng.permutation(n)):
        lab, oth, d = (torch.from_numpy(np.ascontiguousarray(a[order])).cuda()
                       for a in (labels, other, deg))
        for _ in range(2):
            require(torch.equal(metrics.bin_sums(lab, d, k).cpu(), want),
                    "exact sums: a permuted or repeated card bin sum differs")
            require(torch.equal(metrics.moved_sums(oth, lab, d, k).cpu(), want_moved),
                    "exact sums: a permuted or repeated card load delta differs")
    return {"vertices": n, "max_bin": float(mass.max()), "bin_sums": want.tolist()}


def k6_kernels_per_call(torch, fn, s: int, chunk: int) -> int:
    """The device kernels of one K6 call over ``s`` tokens, counted as the
    nodes of a captured call: the spread kernel below one chunk, the local
    and stitch passes from one chunk on, and nothing else."""
    want = 2 if s >= chunk else 1
    nodes = graph_kernel_nodes(torch, fn)
    require(nodes == (want, want), f"K6 at S {s} captures {nodes} (kernel, all) graph nodes "
            f"a call, expected {want} kernels")
    return nodes[0]


def wkv6_serve_kernel(torch, flush) -> tuple[dict, dict]:
    """K6 at the rwkv6-3b prefill shape [8,1024,32,80] and decode shape
    [8,1,32,80]: held against its plain version on the card, then timed as
    K4 and K5 are. Returns (the prefill-shape record, the decode-shape
    numbers)."""
    from repro_torch.kernels import wkv6 as k6

    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    b, h, n = SERVE["batch"], 32, 80
    out = {}
    # around one chunk at full width: held to the plain version and timed
    ragged = {}
    for s in (k6.CHUNK - 1, k6.CHUNK, k6.CHUNK + 1):
        args = wkv6_inputs(torch, gen, b, s, h, n, "cuda")
        got = k6.wkv6_cuda(*args[:5], args[5].clone())
        again = k6.wkv6_cuda(*args[:5], args[5].clone())
        want = k6.wkv6_plain(*args[:5], args[5].clone())
        require(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                f"K6 at S {s}: two calls differ")
        ragged[s] = max(check_close(torch, got[0], want[0], WKV_TOL, f"K6 y at S {s}"),
                        check_close(torch, got[1], want[1], WKV_TOL, f"K6 state at S {s}"))
        ragged[f"{s}_device_kernels_per_call"] = k6_kernels_per_call(
            torch, lambda: k6.wkv6_cuda(*args), s, k6.CHUNK)
        # below one chunk the spread kernel runs, from one chunk on the chunked passes
        ragged[f"{s}_ms"] = graph_ms(torch, lambda: k6.wkv6_cuda(*args), flush)
        del args, got, again, want
    for label, s in (("prefill", SERVE["prompt"]), ("decode", 1)):
        args = wkv6_inputs(torch, gen, b, s, h, n, "cuda")
        got = k6.wkv6_cuda(*args[:5], args[5].clone())
        again = k6.wkv6_cuda(*args[:5], args[5].clone())
        want = k6.wkv6_plain(*args[:5], args[5].clone())
        require(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
                f"K6 at the {label} shape: two calls differ")
        err = max(check_close(torch, got[0], want[0], WKV_TOL, f"K6 y at the {label} shape"),
                  check_close(torch, got[1], want[1], WKV_TOL, f"K6 state at the {label} shape"))
        nbytes = 4 * (5 * b * s * h * n + h * n + 2 * b * h * n * n)
        # k v, S w + k v and r S: 5 N^2 a token and head; the u term factors
        # as v[m] sum_n r[n] u[n] k[n]: 3 N for the sum, 2 N to add it to y
        flops = (5 * n * n + 5 * n) * b * s * h
        bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
        fn = lambda: k6.wkv6_cuda(*args)  # noqa: E731
        out[label] = {
            "max_abs_err": err, "ms": graph_ms(torch, fn, flush),
            "plain_ms": graph_ms(torch, lambda: k6.wkv6_plain(*args), flush),
            "bound_ms": bound_ms, "bound_by": bound_by,
            "eager_ms": time_ms(torch, fn, flush),
            "shape": f"r/k/v/logw [{b},{s},{h},{n}] f32, state [{b},{h},{n},{n}] f32",
            "bytes": nbytes, "flops": flops, "chunk": k6.CHUNK,
            "device_kernels_per_call": k6_kernels_per_call(torch, fn, s, k6.CHUNK),
            "deterministic": True, "ragged_max_abs_err": ragged,
        }
        del args, got, again, want
    record = {"name": "wkv6", "route": "cuda",
              "source": "src/repro_torch/kernels/csrc/wkv6.cu",
              "replaces": "src/repro/kernels/wkv6.py:57",
              "library_ms": None, **out["prefill"]}
    return record, out["decode"]


# --------------------------------------------------------------------------
# the host worker: phase 8's graph build and 11d's coarsening
# --------------------------------------------------------------------------
def send_raw(conn, msg) -> None:
    """Sends ``msg`` as a pickle whose array buffers follow it raw on the
    pipe, for `recv_raw`: the connection's own receive reallocates its
    buffer for every chunk the pipe gives, too slow for the V-cycle's ~5 GB
    level stack."""
    bufs = []
    data = pickle.dumps(msg, protocol=5, buffer_callback=bufs.append)
    views = [b.raw() for b in bufs]
    conn.send((data, [v.nbytes for v in views]))
    for v in views:
        while v.nbytes:
            v = v[os.write(conn.fileno(), v):]


def recv_raw(conn):
    """What `send_raw` sent, its arrays over buffers read in place."""
    data, sizes = conn.recv()
    pipe = io.FileIO(conn.fileno(), closefd=False)
    bufs = []
    for n in sizes:
        buf = memoryview(bytearray(n))
        done = 0
        while done < n:
            got = pipe.readinto(buf[done:])
            if not got:
                raise EOFError(f"pipe closed {done} bytes into a {n}-byte buffer")
            done += got
        bufs.append(buf)
    return pickle.loads(data, buffers=bufs)


def host_worker(conn, seed: int) -> None:
    """Builds WIKI at full size and sends it; then builds phase 17h's host
    hub plans (`hub_plans`), writes them to a file and sends its path (a
    small message: the pipe does not block until phase 17h reads it);
    then phase 11c's reference layout (`stream_reference_layout`) the same
    way; then coarsens the graph as the V-cycle does
    (`build_level_stack(g, DEFAULT_COARSE_N)`) and sends the levels one at
    a time. Numpy on one core, in a process of its own, so it shares no
    interpreter lock with the phases that issue the launches. A failure is
    sent as its traceback."""
    import tempfile
    import traceback

    try:
        sys.path.insert(0, str(SRC))
        import numpy as np

        from repro_torch.core import multilevel
        from repro_torch.graphs import load_dataset

        t = time.perf_counter()
        g = load_dataset("WIKI", scale=1.0, seed=seed)
        send_raw(conn, ("graph", g, time.perf_counter() - t))
        t = time.perf_counter()
        plans = hub_plans(g)
        path = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_hubplan_")) / "plans.pkl"
        with open(path, "wb") as f:
            pickle.dump(plans, f, protocol=5)
        del plans
        send_raw(conn, ("hubplan", str(path), time.perf_counter() - t))
        t = time.perf_counter()
        ref = stream_reference_layout(np, g, seed)
        path = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_stream_")) / "layout.pkl"
        with open(path, "wb") as f:
            pickle.dump(ref, f, protocol=5)
        del ref
        send_raw(conn, ("streamlayout", str(path), time.perf_counter() - t))
        t = time.perf_counter()
        graphs, cmaps = multilevel.build_level_stack(g, multilevel.DEFAULT_COARSE_N)
        send_raw(conn, ("levels", len(cmaps), time.perf_counter() - t))
        for lg, cmap in zip(graphs[1:], cmaps):
            send_raw(conn, ("level", lg, cmap))
    except BaseException:
        send_raw(conn, ("error", traceback.format_exc(), None))
    finally:
        conn.close()


class HostWorker:
    """`host_worker` in a spawned process, and the read end of its pipe.
    Each read blocks until the worker has sent what it asks for; a worker
    that failed or died fails the read."""

    def __init__(self, seed: int):
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=False)
        self._proc = ctx.Process(target=host_worker, args=(child, seed), daemon=True)
        self._proc.start()
        child.close()

    def _recv(self, tag: str):
        try:
            got = recv_raw(self._conn)
        except EOFError:
            self._proc.join(timeout=10)
            got = ("error", f"exited with code {self._proc.exitcode}", None)
        require(got[0] == tag, f"host worker, expecting {tag!r}: {got[1]}")
        return got[1:]

    def ready(self) -> bool:
        """True once the graph (or a failure) waits in the pipe."""
        return self._conn.poll()

    def graph(self):
        """(the full WIKI graph, the worker's seconds building it)."""
        return self._recv("graph")

    def hub_plans(self):
        """(phase 17h's 8-shard and 1-shard hub plans, the worker's seconds
        building them); the file they came in is removed."""
        path, seconds = self._recv("hubplan")
        path = pathlib.Path(path)
        with open(path, "rb") as f:
            spec8, spec1 = pickle.load(f)
        path.unlink()
        path.parent.rmdir()
        return spec8, spec1, seconds

    def stream_layout(self):
        """(phase 11c's reference layout, the worker's seconds building
        it); the file it came in is removed."""
        path, seconds = self._recv("streamlayout")
        path = pathlib.Path(path)
        with open(path, "rb") as f:
            ref = pickle.load(f)
        path.unlink()
        path.parent.rmdir()
        return ref, seconds

    def level_stack(self):
        """(levels 1 and up, their coarse maps, the worker's seconds
        coarsening) as `build_level_stack` returns them, level 0 left out."""
        n, seconds = self._recv("levels")
        graphs, cmaps = [], []
        for _ in range(n):
            lg, cmap = self._recv("level")
            graphs.append(lg)
            cmaps.append(cmap)
        return graphs, cmaps, seconds

    def stop(self) -> None:
        if self._proc.is_alive():
            self._proc.terminate()
        self._proc.join()
        self._conn.close()


def main() -> int:
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # phase 8's graph build and 11d's coarsening run in a process of their
    # own from here on, overlapping phases 2-7 and 9-17 and 11c
    host = HostWorker(SEED)
    spawned: list = []       # phase 11e's side-leg processes, once started
    try:
        return run_phases(torch, host, spawned, t_start)
    finally:
        for proc in spawned:
            proc.stop()
        host.stop()


def run_phases(torch, host: HostWorker, spawned: list, t_start: float) -> int:
    """Phases 1-17h in the order of the module docstring; every check
    raises. Processes started here are appended to ``spawned``."""
    import numpy as np

    # f32 references in full f32 (the defaults, stated)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.core import run_partitioner
    from repro_torch.core.device_graph import prepare_device_graph
    from repro_torch.kernels import _build, edge_phase, ops

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # the host graph build is the longest phase (numpy, one core): the host
    # worker started in `main` runs it while the kernels build and the
    # correctness phases run

    # 2. build
    t = time.perf_counter()
    reports = _build.build()
    build_s = time.perf_counter() - t
    for name, log in reports.items():
        for line in log.splitlines():
            if ("registers" in line or "spill" in line or "Compiling entry" in line
                    or "(C75" in line):   # ptxas's notes on serialized wgmma
                print(f"ptxas[{name}] {line.strip()}")
    k4_sass = sass_counts(_build.library_path("flash_attention"))
    require(k4_sass["HGMMA"] > 0, f"K4's library holds no HGMMA instruction: {k4_sass}")
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports),
          "flash_attention_sass": k4_sass})
    # 11e's side legs (WIKI 0.1), one process a group, on the built kernels,
    # beside phases 3-7 and the other side legs while the host build runs
    side = SideLegs()
    spawned.append(side)

    # 3. small kernel checks and superstep parity, before anything large:
    # the kernels on the card against the plain versions on the CPU
    k1_small = check_k1_small(torch, np, SEED)
    k1_hub = check_k1_hub(torch, np, SEED + 6)
    exact_sums = exact_sums_check(torch, np)
    check_k2(torch, torch.device("cuda"), 4099, 5, SEED + 1)
    k3_small = check_k3_small(torch, np, SEED + 4)
    k3_hub = check_k3_hub(torch, np, SEED + 7)
    contracted = check_contracted_weights(torch, np, SEED + 8)
    ops.reset_launch_counts()
    parity_steps = parity_phase(torch, np)
    parity_counts = ops.launch_counts()
    require(all(parity_counts[n] == 2 * N_BLOCKS * parity_steps
                for n in PARTITIONER_KERNELS), f"parity launches {parity_counts}")
    ops.reset_launch_counts()
    rule_parity = rule_parity_phase(torch, np)
    rule_counts = ops.launch_counts()
    # K3 once per Spinner superstep, once per block and restream superstep
    want = {n: (1 + N_BLOCKS) * rule_parity["supersteps"] if n == "edge_histogram" else 0
            for n in rule_counts}
    require(rule_counts == want, f"rule parity launches {rule_counts}, expected {want}")
    emit({"phase": "parity", "supersteps": parity_steps, "weight_modes": 2,
          "launches": parity_counts, "k1_cases": k1_small, "k1_hub": k1_hub, **k3_small,
          "k3_hub": k3_hub, **contracted,
          "exact_sums": exact_sums, "rules": rule_parity, "rule_launches": rule_counts})

    # 4. attention kernels on small odd shapes, then reduced-LM parity: the
    # card (kernels) against the CPU (plain versions)
    t = time.perf_counter()
    attn_small = attention_small_checks(torch)
    lm_small = reduced_lm_parity(torch, "tinyllama-1.1b", GQA)
    # DeepSeek-V2 reduced: MoE + MLA (K4 at D 24); 236b with q LoRA and
    # routed scale 16
    deepseek_small = [reduced_lm_parity(torch, arch, {})
                      for arch in (DEEPSEEK, "deepseek-v2-236b")]
    # h2o-danube-3-4b reduced (window 16: the 37-token prompt wraps the
    # ring in prefill) and zamba2-7b reduced (a 37-token prompt takes the
    # Mamba2 scan, 32 the chunked form)
    swa_small = reduced_lm_parity(torch, H2O, {})
    hybrid_small = [reduced_lm_parity(torch, ZAMBA, {}, s=s) for s in (37, 32)]
    # whisper-base (16 stub frames; both caches), internvl2-1b (8 stub
    # patches before the prompt) and command-r-plus-104b (the parallel
    # block) reduced
    encdec_vlm_small = [reduced_lm_parity(torch, arch, {})
                        for arch in (WHISPER, INTERNVL, COHERE)]
    emit({"phase": "attn", **attn_small, "reduced_lm": lm_small,
          "reduced_deepseek": deepseek_small, "reduced_h2o": swa_small,
          "reduced_zamba": hybrid_small, "reduced_whisper_internvl_cohere": encdec_vlm_small,
          "seconds": time.perf_counter() - t})

    # 5. tinyllama-1.1b at full width: prefill + decode against prefill
    next_model(torch)
    t = time.perf_counter()
    cfg, model, toks, n_params = full_width_model(torch, "tinyllama-1.1b")
    emit({"phase": "lm-full", "arch": cfg.name, "params": n_params,
          **full_width_consistency(torch, cfg, model, toks),
          "peak_memory_bytes": torch.cuda.max_memory_allocated(),
          "seconds": time.perf_counter() - t})
    del model, toks      # rebuilt from the seed for phase 12

    # 6. K6 on small odd shapes, then reduced rwkv6-3b parity: the card
    # (kernels) against the CPU (plain versions)
    next_model(torch)
    t = time.perf_counter()
    wkv_small = wkv6_small_checks(torch)
    rwkv_small = reduced_lm_parity(torch, "rwkv6-3b", {})
    emit({"phase": "rwkv-small", **wkv_small, "reduced_lm": rwkv_small,
          "seconds": time.perf_counter() - t})

    # 7. rwkv6-3b at full width: prefill + decode against prefill, in bf16
    # (the greedy token agrees on every row but near-ties), then with f32
    # weights and activations, where it must agree on every row
    for dtype, tol, same_argmax in ((None, FULL_REL_TOL, False),
                                    ("float32", FULL_F32_REL_TOL, True)):
        next_model(torch)
        t = time.perf_counter()
        cfg, model, toks, n_params = full_width_model(torch, "rwkv6-3b", dtype)
        emit({"phase": "rwkv-full", "arch": cfg.name, "params": n_params,
              **full_width_consistency(torch, cfg, model, toks, rel_tol=tol,
                                       same_argmax=same_argmax),
              "peak_memory_bytes": torch.cuda.max_memory_allocated(),
              "seconds": time.perf_counter() - t})
        del model, toks      # rebuilt from the seed for phase 14
    next_model(torch)

    # 16 (its legs off the full graph, while the host build above runs on):
    # a SIGKILL and resume through the CLI, and a checkpointed stream
    emit({"phase": "crash-safety-side", "graph_built": host.ready(),
          **crash_safety_side_legs(torch, np)})
    # 17 (its small legs, in the same wait): card against CPU at WIKI 0.002,
    # Spinner and restream on 8 shards at WIKI 0.1
    emit({"phase": "sharded-side", "graph_built": host.ready(),
          **sharded_side_legs(torch, np, ops)})
    # 17h (its legs off the full graph, in the same wait): H1 on a synthetic
    # table, the V-cycle with a sharded hub finest level at WIKI 0.1
    emit({"phase": "hub-side", "graph_built": host.ready(),
          **hub_side_legs(torch, np, ops)})

    # 11e (its side legs, started after phase 2): collected before any timed
    # phase runs
    t = time.perf_counter()
    side_results = side.results()
    emit({"phase": "stream-sharded-side", "graph_built": host.ready(),
          "collect_wait_s": time.perf_counter() - t,
          **stream_sharded_side_legs(np, side_results)})
    side.stop()
    spawned.remove(side)

    # 7c. training: the ten archs reduced on the card against the CPU, the
    # trainer's resume, tinyllama-1.1b at full width through the CLI, then
    # served from its checkpoint; in the host build's wait, after the side
    # legs
    next_model(torch)
    train_rows, _ = train_phase(torch, ops)
    for row in train_rows.pop("reduced"):
        emit({"phase": "train-reduced", **row})
    emit({"phase": "train-resume", **train_rows.pop("resume")})
    emit({"phase": "train-full", "graph_built": host.ready(), **train_rows.pop("full")})
    emit({"phase": "train", **train_rows})
    del train_rows

    # 7d. deepseek-v2-lite-16b at full width (MoE + MLA, K4 at D 192): the
    # consistency gate, then served through Engine.generate; in the host
    # build's wait, with the side legs' processes stopped
    next_model(torch)
    t = time.perf_counter()
    ds_rows, ds_counts, ds_model = deepseek_phase(torch, ops)
    emit({"phase": "deepseek-full", "graph_built": host.ready(), **ds_rows["full"]})
    emit({"phase": "deepseek-serve", **ds_rows["serve"]})
    emit({"phase": "deepseek-serve-profile", **ds_rows["serve_profile"]})
    emit({"phase": "deepseek-moe", **ds_rows["moe"], "seconds": time.perf_counter() - t})

    # 7j. on 7d's model: its experts placed by Revolver (K1, K2), served
    # permuted, then expert-parallel on 8 ranks of the card and across pods;
    # then the sharded flash-decode (K5) and the int8 all-reduce
    t = time.perf_counter()
    for leg, row in placement_legs(torch, np, ops, *ds_model, ds_rows["serve"]).items():
        emit({"phase": f"placement-{leg}", **row})
    del ds_rows, ds_model
    next_model(torch)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    for leg, row in lm_collective_legs(torch, np, ops, flush).items():
        emit({"phase": f"placement-{leg}", **row})
    del flush
    emit({"phase": "placement", "graph_built": host.ready(),
          "seconds": time.perf_counter() - t})

    # 7e. h2o-danube-3-4b at full width (sliding window 4096, K4 and K5 at
    # head dim 120, the ring decode through K5), in the same wait
    next_model(torch)
    t = time.perf_counter()
    h2o_rows, h2o_counts = h2o_phase(torch, ops)
    emit({"phase": "h2o-full", "graph_built": host.ready(), **h2o_rows["full"]})
    emit({"phase": "h2o-serve", **h2o_rows["serve"]})
    emit({"phase": "h2o-serve-profile", **h2o_rows["serve_profile"],
          "seconds": time.perf_counter() - t})
    del h2o_rows

    # 7f. zamba2-7b at full width and 4 of its 13 groups (the Mamba2
    # hybrid, K4 and K5 at head dim 224), in bf16 and f32, in the same wait
    t = time.perf_counter()
    zamba_rows, zamba_counts = zamba_phase(torch, ops)
    for dtype, row in zamba_rows["full"].items():
        emit({"phase": "zamba-full", "graph_built": host.ready(), **row})
    emit({"phase": "zamba-serve", **zamba_rows["serve"]})
    emit({"phase": "zamba-serve-profile", **zamba_rows["serve_profile"],
          "seconds": time.perf_counter() - t})
    del zamba_rows

    # 7g-7i. whisper-base (the encoder-decoder), internvl2-1b (the VLM
    # frontend) and command-r-plus-104b at 8 of its 64 layers (the parallel
    # block), K4 and K5 at their new shapes; their launches by shape go to
    # phase 13's records
    leg_shapes = {}
    for phase, arch, serve, n_params, changes in (
            ("whisper", WHISPER, WHISPER_SERVE, WHISPER_PARAMS, {}),
            ("internvl", INTERNVL, INTERNVL_SERVE, INTERNVL_PARAMS, {}),
            ("cohere", COHERE, SERVE, COHERE_PARAMS, {"n_layers": COHERE_LAYERS})):
        next_model(torch)
        t = time.perf_counter()
        rows, _, shapes = serve_leg(torch, ops, arch, serve, n_params, **changes)
        leg_shapes.update(shapes)
        emit({"phase": f"{phase}-full", "graph_built": host.ready(), **rows["full"]})
        emit({"phase": f"{phase}-serve", **rows["serve"]})
        emit({"phase": f"{phase}-serve-profile", **rows["serve_profile"],
              "seconds": time.perf_counter() - t})
        del rows
    next_model(torch)

    # 7k. the dry run of tinyllama-1.1b's prefill_32k (also under bf16_silu)
    # and decode_32k beside the card: peak memory against its bytes, step
    # time against its bound, K4 at S 32,768, K5 at kv_len 32,764 and F1 at
    # [32768, 5632] against their plain versions
    t = time.perf_counter()
    dry, dry_records = dryrun_phase(torch, ops)
    for cell, row in dry.pop("dryrun_rows").items():
        emit({"phase": "dryrun-row", "cell": cell, **row})
    for leg in ("prefill_32k", "prefill_32k_bf16_silu", "decode_32k"):
        emit({"phase": f"dryrun-{leg}", **dry.pop(leg)})
    emit({"phase": "dryrun", "graph_built": host.ready(), **dry,
          "seconds": time.perf_counter() - t})
    next_model(torch)

    # 8. graph: full-size WIKI, host build (started above) then device layout
    t = time.perf_counter()
    g, gen_s = host.graph()
    wait_s = time.perf_counter() - t
    t = time.perf_counter()
    dg = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cuda")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t
    emit({"phase": "graph", "dataset": "WIKI", "scale": 1.0, "n": g.n, "m": g.m,
          "sym_edges": g.num_sym_edges, "n_blocks": dg.n_blocks,
          "block_v": dg.block_v, "e_max": dg.e_max,
          "host_generate_s": gen_s, "host_generate_wait_s": wait_s,
          "layout_s": layout_s})

    # 9. kernels against their plain versions at the main path's shapes,
    # then timed
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    args, labels, lam, actions, feasible, live = check_k1_block(torch, dg, SEED)
    bv = dg.block_v
    k1_cuda = lambda: edge_phase.fused_edge_phase_cuda(  # noqa: E731
        dg.blk_dst[:1], dg.blk_w[:1], dg.blk_row_ptr[:1], dg.blk_spans.block(0), labels,
        lam, actions, feasible, block_v=bv, k=K)
    k1_plain = lambda: edge_phase.fused_edge_phase_plain(*args, block_v=bv, k=K)  # noqa: E731
    k1_bytes = (live * 8 + (bv + 1) * 4 + 2 * dg.n_pad * 4 + bv * 4 + K * 4
                + 2 * bv * K * 4)
    k1_ops = live * (K + 2)
    # K2 on (a) dense random weights and (b) what a self_lambda superstep
    # gives it (one weighted slot a row)
    k2_a, k2_err = check_k2(torch, dg.device, bv, K, SEED)
    k2_b = capture_k2_inputs(torch, dg)
    k2_err_b = k2_agrees(torch, *k2_b, "at a self_lambda superstep's input")
    k2_a_times, k2_b_times = k2_timed(torch, *k2_a, flush), k2_timed(torch, *k2_b, flush)
    records = {
        "fused_edge_phase": {
            "name": "fused_edge_phase", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/edge_phase.cu",
            "replaces": "src/repro/kernels/edge_phase.py:108",
            "max_abs_err": 0.0,
            # eager, as the Revolver rule calls it; the graph replay beside
            "ms": time_ms(torch, k1_cuda, flush),
            "plain_ms": time_ms(torch, k1_plain, flush),
            "graph_ms": graph_ms(torch, k1_cuda, flush),
            "bound_ms": max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_FLOPS) * 1e3,
            "bound_by": "bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_FLOPS else "operations",
            "library_ms": None,
        },
        "la_update": {
            "name": "la_update", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/la_update.cu",
            "replaces": "src/repro/kernels/la_update.py:56",
            "max_abs_err": k2_err,
            # eager on (a), as the Revolver rule calls it; the graph replay
            # and device time beside, and all of them on (b)
            **k2_a_times, "library_ms": None,
            "superstep_input": {"max_abs_err": k2_err_b, **k2_b_times},
        },
    }
    del flush
    emit({"phase": "kernels", "k1_live_edges": live, "k1_bytes": k1_bytes,
          "k2_rows": bv, "shape_note": "K1 at block 0 of full WIKI (nb=1), K2 at "
          "[block_v, 8] on random weights and on superstep 2's block 0 (self_lambda)"})

    # 10. the partitioner main path, through the entry point a user calls
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = run_partitioner("revolver", g, K, seed=SEED, n_blocks=N_BLOCKS, dg=dg)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    for name, c in counts.items():
        want = N_BLOCKS * res.steps if name in PARTITIONER_KERNELS else 0
        require(c == want, f"{name} launched {c} times in {res.steps} "
                f"supersteps, expected {want}")
    # the result, checked by the repo's own means: labels in range, metrics
    # recomputed on the host from the returned labels
    host_metrics(np, g, res)
    require(res.local_edges > 0.5, f"local_edges {res.local_edges} <= 0.5")
    require(res.max_norm_load <= 1.30, f"max_norm_load {res.max_norm_load} > 1.30")
    flat = {"steps": res.steps, "local_edges": res.local_edges,
            "max_norm_load": res.max_norm_load, "wall_s": wall}
    emit({"phase": "main", "dataset": "WIKI", "scale": 1.0, "k": K, "seed": SEED,
          "steps": res.steps, "converged": res.converged,
          "local_edges": res.local_edges, "max_norm_load": res.max_norm_load,
          "wall_s": wall, "supersteps_per_s": res.steps / wall,
          "slab_edges_per_s": res.steps * g.num_sym_edges / wall,
          "peak_memory_bytes": peak, "launches": counts})
    for name, rec in records.items():
        rec["launches"] = counts[name]
        emit(rec)

    # 11. where a superstep's time goes
    emit({"phase": "profile", **profile_phase(torch, dg)})
    del args, labels, lam, actions, feasible, k1_cuda, k1_plain, k2_a, k2_b

    # 11a. Spinner, restream and the static baselines through the same entry
    # point, on the same layout
    t = time.perf_counter()
    rule_rows = rules_phase(torch, np, ops, g, dg)
    for row in rule_rows.values():
        emit({"phase": "rules", "dataset": "WIKI", "scale": 1.0, "k": K, "seed": SEED, **row})
    for algo in ("spinner", "restream"):
        emit({"phase": "rules-profile", "algo": algo, **profile_phase(torch, dg, algo)})
    emit({"phase": "rules-wall", "seconds": time.perf_counter() - t})

    # 11b. K3 at the Spinner and restream shapes, then timed
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    k3_shapes = k3_timed(torch, dg, flush, SEED + 5)
    del flush, dg
    records["edge_histogram"] = {
        "name": "edge_histogram", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/edge_histogram.cu",
        "replaces": "src/repro/kernels/edge_histogram.py:56",
        # the launches of both rules' main-path runs
        "launches": sum(rule_rows[a]["launches"]["edge_histogram"]
                        for a in ("spinner", "restream")),
        **k3_shapes["spinner"]}
    emit(records["edge_histogram"])
    emit({"phase": "histogram-kernel", "restream_shape": k3_shapes["restream"]})


    # 12. the serving main path, through the entry point a user calls
    next_model(torch)
    cfg, model, toks, _ = full_width_model(torch, "tinyllama-1.1b")
    serve, serve_counts = serve_phase(
        torch, ops, cfg, model, toks,
        {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * (SERVE["new"] - 1)})
    emit({"phase": "serve", **serve})
    emit({"phase": "serve-profile", **serve_profile(torch, cfg, model, toks)})

    # 13. the attention kernels at the serving shapes, then timed
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    attn_records = attention_serve_kernels(torch, flush)
    del flush
    for name, rec in attn_records.items():
        # K4 at D 192: its launches in phase 7d's DeepSeek generate
        rec["launches"] = (ds_counts["flash_attention"] if name == "flash_attention_d192"
                           else serve_counts[name])
        records[name] = rec
        emit(rec)
    del model, toks
    # K4 and K5 at head dims 224 and 120: their launches in phases 7f's and
    # 7e's generates
    next_model(torch)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    wide = wide_head_attention_kernels(torch, flush)
    del flush
    for name, rec in wide.items():
        counts = zamba_counts if name.endswith("224") else h2o_counts
        rec["launches"] = counts[name.rsplit("_", 1)[0]]
        records[name] = rec
        emit(rec)
    emit({"phase": "wide-head-kernels", "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    # K4 and K5 at the shapes of phases 7g-7i: their launches there, by shape
    next_model(torch)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    encdec_vlm = encdec_vlm_attention_kernels(torch, flush)
    del flush
    for name, rec in encdec_vlm.items():
        rec["launches"] = leg_shapes.get(rec["shape_key"], 0)
        require(rec["launches"] > 0, f"{name}: no launch at {rec['shape_key']} in phases 7g-7i")
        records[name] = rec
        emit(rec)
    emit({"phase": "encdec-vlm-kernels",
          "peak_memory_bytes": torch.cuda.max_memory_allocated()})
    # K4 at S 32,768, K5 at kv_len 32,764 and F1: their launches in phase 7k
    for name, rec in dry_records.items():
        records[name] = rec
        emit(rec)

    # 14. rwkv6-3b served through the same entry point: K6 once per layer in
    # prefill and once per layer and decode step
    next_model(torch)
    cfg, model, toks, _ = full_width_model(torch, "rwkv6-3b")
    serve, serve_counts = serve_phase(torch, ops, cfg, model, toks,
                                      {"wkv6": cfg.n_layers * SERVE["new"]})
    emit({"phase": "rwkv-serve", **serve})
    emit({"phase": "rwkv-serve-profile", **serve_profile(torch, cfg, model, toks)})
    del model, toks

    # 15. K6 at the rwkv6-3b serving shapes, then timed
    next_model(torch)
    flush = torch.empty(256 * 1024 * 1024 // 4, dtype=torch.float32, device="cuda")
    rec, decode = wkv6_serve_kernel(torch, flush)
    del flush
    rec["launches"] = serve_counts["wkv6"]
    records["wkv6"] = rec
    emit(rec)
    emit({"phase": "rwkv-kernel", "decode_shape": decode})

    # 16. tracing, checkpoints, resume and the state guard on the main path,
    # on phase 8's graph and a layout of it built anew (phase 8's was freed
    # before the serving phases, whose peak memory it would otherwise hold)
    next_model(torch)
    t = time.perf_counter()
    dg = prepare_device_graph(g, n_blocks=N_BLOCKS, device="cuda")
    torch.cuda.synchronize()
    layout_s = time.perf_counter() - t
    emit({"phase": "crash-safety", "layout_s": layout_s,
          **crash_safety_phase(torch, np, ops, g, dg)})
    del dg

    # 17. the sharded, halo and async schedules on the main path: 8 shards
    # on the one card, 32 blocks
    next_model(torch)
    sharded = sharded_phase(torch, np, ops, g)
    emit({"phase": "sharded-schedules", **sharded})

    # 17h. hub replication on the main path (8 shards, the host plans from
    # the worker), H1 against its plain version and timed, elastic restore
    next_model(torch)
    hub_row, records["hub_reconcile"] = hub_phase(
        torch, np, ops, g, seq_steps=sharded["one_shard"]["steps"],
        sharded_le=sharded["main"]["local_edges"], host=host)
    emit({"phase": "hub-schedules", **hub_row})
    emit(records["hub_reconcile"])

    # 11c. streaming repartitioning of phase 8's graph, through StreamRunner,
    # and 11d. the multilevel V-cycle on it. They run last: the card idles
    # through their host work (merges, coarsening), and after such idle
    # minutes torch.profiler loses the kernel events of short windows, which
    # phases 13 and 15 count
    next_model(torch)
    stream = stream_phase(torch, np, ops, g, flat, host)
    le_11c = [row["local_edges"] for row in stream["revolver"]]
    for algo in ("revolver", "spinner", "restream"):
        for row in stream.pop(algo):
            emit({"phase": "stream-delta", "algo": algo, **row})
    emit({"phase": "stream", **stream})
    # 11e. the stream over a mesh: 8 shards on the card, halo with hubs
    next_model(torch)
    emit({"phase": "stream-sharded", **stream_sharded_phase(torch, np, ops, g, le_11c)})
    t = time.perf_counter()
    emit({"phase": "vcycle", **vcycle_phase(torch, np, ops, g, flat, host),
          "seconds": time.perf_counter() - t})
    del g

    emit({"phase": "wall", "seconds": time.perf_counter() - t_start})
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: rec[k] for k in keys} for rec in records.values()]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
