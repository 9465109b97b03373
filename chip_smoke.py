#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase below, a few minutes
    python3 chip_smoke.py --sweep    # also time the kernels' tunables
    python3 chip_smoke.py --compare-with DIR   # K1-K5 here against DIR's

Needs a CUDA device and ``nvcc``; imports only ``repro_torch`` (from ``src/``
beside this file).  Each phase raises on failure, so the exit code is non-zero
unless all of them held:

1. device   — require CUDA; print the card's name and power limit.
2. build    — compile the CUDA kernels from ``src/repro_torch/kernels/csrc``
              (one nvcc per source, all started together) and load the
              library.
3. kernels  — all five kernels against their plain PyTorch versions on the
              card, x / B in float32 and bfloat16, Bx (or Cd) in {1, 4, 37,
              256}:
              * ``demm_xwT`` and ``demm_xwT_q8`` (per-row and per-group
                scales) at the three projection shapes of full-width
                stablelm_3b and the reduced 2:16 shape, as the main path
                launches them (``duplicates=False``), plus duplicate indices
                with non-quarter-integer values (the summing instantiation),
                an all-padded row, a contraction dim that needs several
                shared-memory chunks, non-default tiles and bfloat16 packed
                values;
              * ``demm_block_spmm``, ``demm_block_spmm_q8`` (serving
                orientation, B = xᵀ) at the same shapes with the block
                geometry of ``pack_block``, plus weights with inactive
                (row-block, group) tiles (a_max < G) and an all-zero row
                block, ``a_max > G`` padding, duplicate indices with
                non-quarter-integer values, and B stored (K, Cd);
              * ``demm_spmm`` (paper orientation, B (K, Cd)) at the same
                shapes, plus duplicate indices;
              * the redesigned bodies, each asserted to be the one taken:
                K5's tiled tensor-core body (bf16 B, Cd in {64, 200, 256,
                1024}, R = 100, M in {8, 16, 40, 48, 80}, duplicates, every
                tile, stage count and groups per stage) while a float32 B
                and a transposed B take the gather body, and K5 at narrow B
                never takes K2's cluster body; K2's and K4's cluster body at
                Bx in {1, 4, 8} with inactive tiles, an all-zero row block,
                a_max > G, duplicates and every cluster size; K1's and K3's
                bulk row-tile body at Bx <= 8 (K3 with per-row and per-group
                scales; chunk counts, one-row and ragged tiles, a ring of
                row chunks larger than shared memory, duplicates) while an
                x tile larger than shared memory takes the gather body;
                K1's and K3's wide body at Bx > 8 with bfloat16 x (the
                three shapes at Bx in {9, 20, 32, 37, 256}, K3 with both
                scale units, duplicates, rows per CTA 1, 7, 53, 128 (40
                where 128 rows' pairs do not fit) and x
                tiles of 32, 64, 128, 6912 x 2560 8:128 at 2048 rows, x of
                16,384 columns in chunks) while float32 x keeps the gather
                body;
              * draft tiers: K1, K3 (per-row and per-group scales), K2 and K4
                on the prefix views ``[..., :t]`` of the stored tensors (the
                operand's data_ptr the full tier's), at the three full-width
                shapes at 8:16 (t in {6, 4, 1}) and at the default 5:80 and
                3:48 (t in {2, 4} below n), Bx in {1, 4, 37}, x in float32
                and bfloat16, each on the full tier's body (bulk / cluster
                at Bx <= 8, gather at 37), plus duplicates inside the prefix
                and across its edge.
              * the projection shapes of gemma3_1b and h2o_danube_1_8b
                that stablelm_3b's do not cover (gemma3's 1:1 projections:
                M = 1, Ne = 1, G = 1152), K1-K4 at Bx in {1, 4, 37, 256},
                each on the body the wrappers' rule gives (K2 / K4 at M = 1
                on the gather body at every Bx).
              Tolerances: float32 rtol/atol 1e-4 (summation order; at the
              windowed decoders' shapes, above 432 products an output, the
              atol grows as the square root of the count), bfloat16
              rtol/atol 2e-2.
4. serve    — full-width stablelm_3b, random weights from a seed, packed,
              backend ``cuda``: 4 requests x 8 new tokens on 4 slots through
              ``run_serve``, whose engine captures its decode step once as a
              CUDA graph and replays it every tick; every request completes
              inside the true vocab; the wrappers launched the float kernel
              exactly 7 x 32 x (warm-up steps + 1 capture) times, no other
              kernel, every launch on its serving body (K1 bulk, K2
              cluster); a ``torch.profiler`` window of 3 replays then shows
              7 x 32 x 3 launches of that kernel on the device, by its
              kernel name and on its serving body, and no other DeMM kernel,
              while no wrapper is called.
   4g graph — on the same packed model: the captured step's tokens equal
              the eager step's and its logits are bit-equal on every tick.
5. serve q8 — the same with int8 values (per-row scales) and the int8 kernel
              (K3 every launch on its bulk body); 5g the same graph check.
   4b/5b    — the same two with ``--layout block`` on a fresh model of the
              same seed: float through ``demm_block_spmm``, int8 through
              ``demm_block_spmm_q8`` (both on the cluster body).
   5c spmm  — ``ops.demm_spmm`` (the paper orientation's entry point),
              backend ``cuda``, on the seven projection shapes of one layer
              with B of 4 and of 256 columns: exactly 14 launches of
              ``demm_spmm`` and results equal to backend ``reference``.
6. agree    — full width, 2 layers, float32 compute, per layout: backend
              ``cuda`` and backend ``reference`` give allclose logits on every
              tick (rtol 1e-3) and identical greedy token streams; the xwT and
              block layouts give the same greedy tokens through their kernels.
   6g graph — the same 2-layer float32 model in the four serving modes
              (both layouts, float and int8): the captured step's tokens
              equal the eager step's and backend ``reference``'s; its logits
              are bit-equal to the eager step's and allclose (rtol 1e-3) to
              the reference's.
   6f flight — ``repro_torch.launch.serve`` as a user runs it, full width,
              ``--profile-dir --flight-dir --force-stall --slo-report``:
              exactly one stall dump, and the profiler's trace holds the
              kernels of the warm-up step and of every graph replay by name
              (7 x 32 x (1 + ticks) of K1 on its bulk body).
   6p paged — ``repro_torch.launch.serve --full --packed --paged`` replaying
              the committed tiny trace with priorities on 16 pages of 8
              tokens: all 12 requests complete, at least one preemption.
8. paged    — in each of the four modes, on phase 4/5's packed model: the
              paged engine (``make_engine(model, PagedServeConfig(...))``;
              4 slots, pages of 16, max_len 512, chunks of 32) serves 8
              prompts of 40-400 tokens (each ending on a partial chunk), 16
              new tokens each.  Counted from reset to drain: one capture of
              the prefill chunk and one of the decode step; the wrappers
              launch the mode's kernel 7 x 32 x 2 times for each program
              (warm-up + capture; the chunk's x of 32 rows on K1 / K3's
              wide body or K2 / K4's gather body, the step's on its serving
              body), nothing else; chunks
              dispatched = sum of ceil(len / 32).  A second pass on the
              same engine gives TTFT per request and prompt tokens/s;
              profiled windows show 224 prefill-body launches of the kernel
              (wide for xwT, gather for block) per chunk replay and 224
              serving-body launches per decode
              replay on the device, with device time, busy share and the
              kernels that take it; the page gather is timed alone; the
              dense engine ingests the same prompts token by token for
              comparison; and both captured programs give the eager
              programs' logits bit for bit (4 of the prompts).
   8g       — 2 layers, float32, the four modes: paged tokens equal the
              dense engine's and backend ``reference``'s (logits allclose,
              rtol 1e-3), and a 13-page arena preempts and keeps the tokens.
9. tune     — the autotuner (``repro_torch.tune``) on the card, with a
              tuning cache in a temporary directory of this run's own.  In
              each of the four modes, on a packed model of phase 4's seed at
              full width and 2 of its 32 layers (``TUNE_LAYERS``; the tuned
              problems are phase 4's): ``autotune_packed_tree(model, 4)``
              tunes 3 problems,
              each selecting ``cuda`` at no more than its default's time in
              the tuner's own table (device time on CUDA-graph replays of a
              ring of weight copies larger than L2), every candidate the
              pruner kept measured or refused — and, before it was timed,
              its output within phase 3's tolerance of the default's and
              its launcher's shared memory what ``tune.smem_bytes``
              counted (the tuner raises otherwise) — and each selected
              setting, launched on the model's own weights, within phase
              3's tolerance of the plain version; then ``--backend auto`` on
              the dense engine (``run_serve``) and on the paged engine:
              every decode-width lookup a cache hit, the wrappers' counts
              of phases 4/8 at 2 layers on the expected bodies, the dispatch
              counter on the resolved backend ``cuda``, 7 x 2 launches a
              replay on the device, and each captured program's logits
              bit-equal to its
              eager program's under ``auto``; then
              ``autotune_packed_tree(model, 32)`` tunes the bodies a prefill
              chunk runs (K1 / K3's wide body: rows per CTA and x tile;
              K2 / K4's gather body) (its selected settings held to the plain
              version as at 4 rows), and a chunk's device time is profiled
              under the default and the tuned params in turns; the last
              chunk's logits under the tuned params lie within 5e-2
              (relative L2) of the default params'.  6g also
              serves its 2-layer float32 models with an engine built with
              ``autotune=True`` under ``auto``: the tokens of ``cuda`` and
              ``reference``, logits allclose (rtol 1e-3).  K5:
              ``autotune_spmm`` at Cd 4 and 256 on the three shapes, the
              measure-only ``block_spmm`` measured beside it.  ``--sweep``
              measures more candidates a problem.
7. times    — per kernel and shape at Bx = 4 with bfloat16 activations (what
              the main path launches; K5 at Cd = 4 and 256): CUDA-event
              medians of the kernel over a ring of weight copies larger than
              L2 (so every launch reads its weights from device memory, as a
              decode step does), replayed from a CUDA graph so that device
              time is measured and not the time Python takes to issue a launch
              (that is ``eager_ms``); the byte / operation bound, the plain
              version, and ``torch.matmul`` against the dense weight in the
              same dtype as a yardstick the port never calls; K3 with
              per-row and with per-group scales.  K5's tiled
              body does the dense count of operations at Cd = 256; the floor
              that sets (2 R K Cd at the bf16 peak, computed, not measured)
              is printed on a line of its own, outside the ``kernels`` line,
              as is the launch floor: an empty kernel at K1's and K3's bulk
              grids and an empty cluster launch at K2's, timed the same way.
   7p       — K1-K4 at x of 32 rows, as a prefill chunk launches them, each
              asserted to run its prefill body (K1 and K3: the wide body,
              their gather body timed beside it through the measurement
              hooks; K2 and K4: the gather body), K3 with per-row and
              per-group scales: the same timing rows (``prefill_bx32`` of
              each kernel in the ``kernels`` line, ``gather_ms`` the gather
              body's time per layer).
   7b       — K1 and K3 (per-row scales) at 2048 rows of x on 6912 x 2560
              at 8:128 on the wide body, the gather body beside it, with
              bound and ``torch.matmul`` (``wide_bx2048`` in the
              ``kernels`` line).
   7s       — K1-K4 with their weights stored at 8:16, reading the prefix
              of t in {8, 6, 4} pairs a group, x of 4 and of 32 rows: a
              draft-tier launch against the full tier's, per layer, with the
              bound of the bytes the tier needs (``tier_8_16`` of each
              kernel in the ``kernels`` line).
10. spec    — self-speculative decoding (``repro_torch.spec``) in the four
              modes on stablelm_3b at full width and 2 of its 32 layers
              (``SPEC_LAYERS``) at ``--sparsity 8:16``, draft 6:16, γ = 4,
              4 slots.  At max_len 16 (the windows shrink near
              it, so every width W runs), on the dense and the paged engine:
              token streams equal to the plain engine's, greedy and at
              temperature 0.8 / top-k 8; counted from reset, one capture of
              the draft step, one of the verify program per width W that
              ran, the plain step only if it ran (and, paged, the prefill
              chunk once), the wrappers launching the mode's kernel 7 x 4 x
              2 per captured decode step on its serving body and nothing
              else; the draft graph's nodes launch 7 x 4 kernels of that
              body and a verify graph's of width W 7 x 4 x W (read from
              the graph itself, its DOT dump); the draft and verify graphs
              (and the dense full step's) give their eager programs' logits
              bit for bit over the first 2 windows (4 steps).  Then, timed,
              the paged engine at the main path's sizes (phase 8's engine
              and prompts, 16 new tokens, bfloat16): a pass with and one
              without spec after a warm-up pass that captures every program
              (tokens equal), acceptance, committed tokens per verify,
              tokens/s, and the device times of a full-step, a draft and a
              verify replay (CUDA events).  10g: the checked passes at 2
              layers float32 against backend ``reference`` (tokens equal,
              window logits allclose, rtol 1e-3); 10c: ``launch.serve
              --full --packed --sparsity 8:16 --spec-draft 6:16
              --spec-gamma 4``, dense and ``--paged``.

11. windowed — the windowed decoders.  11b: full-width gemma3_1b at 14
              of its 26 layers (``WINDOWED_LAYERS``; 5 local : 1 global,
              512-slot rings, head_dim 256, one
              KV head, vocab 262,144), random weights from a seed, packed,
              backend ``cuda``, in the four modes: ``run_serve`` of 5
              requests on 4 slots, one of them running to position 607 (the
              local rings wrap on the card) and one taking a freed slot;
              every request completes inside the true vocab; the wrappers
              launch the mode's kernel 7 x 14 x (warm-up + capture), split by
              body as the wrappers select it (xwT: the bulk body at every
              shape; block: the gather body at the five 1:1 shapes, the
              cluster body at wo and down), nothing else; the graph's kernel
              nodes and a profiled window of 3 replays show the same; the
              captured step's logits bit-equal to the eager step's; a
              replay's device time and the eager step's split (K1-K4,
              attention, ring writes, unembedding, the rest).  11e:
              ``prefill`` of a 600-token prompt (the gather bodies at 600
              rows) within 2e-2 (relative L2) of the engine fed the same
              tokens one by one.  11c: full-width h2o_danube_1_8b in xwT
              float, 4 requests x 8 new tokens, the same counts and graph
              check.  11d: 2-3 layers, float32, rings of 8 (gemma3 with a
              local, a global and a tail layer; h2o), the four modes: graph
              = eager logits bit for bit, tokens = backend ``reference``'s,
              logits allclose (rtol 1e-3), and gemma3's prefill of 40
              tokens allclose (rtol 1e-3) to token-by-token decode.  11f:
              ``launch.serve --arch gemma3_1b --full --packed``, and again
              with ``--layout block --autotune`` (every decode-width lookup
              a cache hit).
   7w       — K1-K4 at every projection shape of gemma3_1b and
              h2o_danube_1_8b at Bx = 4 (``gemma3`` and ``h2o`` of each
              kernel in the ``kernels`` line: per layer and per shape).
12. train   — the training path.  12a: the packed ops under autograd —
              ``xwT``, ``xwT_q8`` (per-row and per-group scales), ``block``
              and ``block_q8`` at stablelm_3b's three projection shapes and
              gemma3's 1:1 gate/up shape, Bx 4 (bulk / cluster bodies) and
              32 (gather bodies), x float32 and bfloat16, every fifth row
              under-full: the forward through ``cuda`` (K1-K4, counted by
              the wrappers, on the body their rule names) within phase 3's
              tolerance of ``reference``'s; the gradients at x and the
              float operand (values; an int8 weight's scales) through
              ``cuda`` against autograd through the plain dense product
              x @ W_denseᵀ (W_dense built from that operand; phase 3's
              tolerance for x's dtype, its atol grown with the sum's
              length), at every slot but the padded ones, whose gradients
              are exactly 0, and bit-equal to those through ``reference``
              (by construction: the same backward ops); and a
              packed 2-layer full-width model differentiated under remat
              ``none`` (K1 7 x 2 launches) and ``full`` (7 x 2 x 2: the
              backward relaunches each layer's forward), bit-equal.  12b:
              ``launch.train.main(--arch stablelm_3b --steps 4 --batch 2
              --seq 256 --lr 1e-3)`` at full width on the masked dense step
              the reference launcher runs (no DeMM kernel launched; loss
              falls, the launcher's own check), its step times, peak device
              memory and checkpoint (params, AdamW m and v) bytes and save
              seconds; then ``launch.serve --full --ckpt-dir --packed
              --layout xwT`` (backend cuda), and the restored weights in
              float32 compute served through ``cuda`` and ``reference``
              with equal tokens.  12c: reduced stablelm_3b, float32,
              ``--sparsify 8:128 --qat int8`` under the supervisor for 12
              steps, uninterrupted and with ``inject_failure_once(6)``:
              parameters, AdamW state and mask state bit-equal; the baked
              final masks verified; packed int8 in both layouts, ``cuda``
              tokens = ``reference`` tokens.

13. families — the other model families, random weights from a seed,
              packed, backend ``cuda``.  13a: olmoe_1b_7b, llama4_scout (at
              full width and 4 of its 48 layers: about 41 GB of float32),
              internvl2_1b, seamless_m4t_medium, zamba2_7b (at full width
              and 27 of its 81 layers) and xlstm_125m at full width, ``run_serve`` of 4 requests x 8 new tokens on 4
              slots, ``--layout xwT``: every request completes inside the
              true vocab; the wrappers launch K1 its per-step count (64,
              16, 168, 84, 82, 51: confirmed from the model's packed nodes
              in the decode path) x (warm-up + capture) on the bulk body,
              nothing else; the graph's nodes the same; the captured step's
              logits bit-equal to the eager step's on every tick; a
              replay's device time and tokens/s.  13b: each family at 2-3
              layers of full width (zamba2 5 at a shared block every 2,
              xlstm 4), float32, the four modes: graph = eager bit for bit,
              tokens = backend ``reference``'s, logits allclose (rtol
              1e-3).  13c: the paged engine for olmoe (experts with room for
              every token), internvl2 and seamless at 2 layers float32:
              tokens equal the dense engine's; zamba2 and xlstm refuse
              ``paged`` with the reference's message.  13d: zamba2 and
              xlstm at full width, ``prefill`` of 200 tokens against
              token-by-token decode, three prompts: within 4.1e-2
              (relative L2) in bfloat16 (rounding grows with depth; the CPU
              tests hold the port's gap to the reference's own), allclose
              at rtol 1e-3 in float32.  13e:
              ``launch.train.main`` per family (xlstm at full width, 6
              steps; olmoe, zamba2, llama4, internvl2, seamless reduced, 12
              steps; 15g trains internvl2 and seamless at full width): the
              loss falls, the experts' aux loss > 0; then
              ``launch.serve --ckpt-dir --packed`` of the xlstm checkpoint.
   7f       — K1-K4 at zamba2's in_proj (14,576 x 3,584, 7:112) and
              out_proj (3,584 x 7,168) and xlstm's 6:96 projection (1,536 x
              1,536), Bx = 4 (``families`` of each kernel in the
              ``kernels`` line; ``launches_families``: its launches in
              phase 13); phase 3 checks the three shapes at Bx 1, 4, 37.

14. dist    — distribution (``repro_torch.sharding``).  14a: the sharded
              packed matmul ``ops._demm_matmul_sharded`` with no group in the
              context (the sequential sum over the slices) at stablelm_3b's
              row-parallel shapes (wo 2560 x 2560 at 5:80, down 2560 x 6912
              at 3:48), tp 2 and 4, x of 4 and 32 rows in float32 and
              bfloat16: K1, K3 and K2 on the renumbered slices against the
              plain versions of the same slices and against the unsharded
              kernel (phase 3's tolerance); K1-K4 on column-parallel blocks
              of wq against the whole product's rows; the block weights'
              per-shard a_max; one shard-local launch of each at tp 2 timed
              against its byte bound and a bf16 ``torch.matmul`` of the local
              dense slice (``tp2_local`` of each kernel in the ``kernels``
              line).  14b: two ranks spawned under ``gloo`` (a ``file://``
              rendezvous in a temporary directory, both on cuda:0; rank 0
              loads the kernel library, the other waits for it) serve
              full-width stablelm_3b under ``ShardingPlan(tp=2)``, ``--layout
              xwT`` and ``--layout block``, float, phase 4's prompts on 4
              slots, eager steps, in float32 compute and in phase 4's
              bfloat16, every sampled token's logits kept; each leg is also
              served on one rank in this process (a captured step; in
              bfloat16 its tokens equal phase 4's).  In every leg: each
              rank's logits are within ``DIST_LOGITS_GAP`` (relative L2) of
              the one rank's at every token up to and including the first
              one where the streams differ, and there the one rank's margin
              between the two tokens is within twice the logits' largest
              difference; in float32 the tokens are equal outright (in
              bfloat16 the row-parallel sums round in another order, which
              may move argmax at the random model's near-ties); the ranks'
              streams and logits are equal; each rank holds its half of the
              row-parallel packed bytes (xwT exactly half) and of the KV
              cache (allocated at its local shape), its memory once placed
              peaks below the one rank's through the drain, and its
              wrappers launched the mode's kernel 7 x 32 per tick and
              nothing else.  14c: the same world serves the 8-layer
              full-width model in float32 under ``ShardingPlan(pp=2)`` (4
              layers a rank, two microbatches of 2 slots), held to the same
              8-layer model on one rank as 14b's legs are, 7 x 4 x 2 K1
              launches a tick.  14d:
              ``make_engine(replicas=2)`` on phase 4's xwT model (built and
              packed again from its seed), two captured engines sharing its
              tensors: every request's tokens equal the single engine's, one
              capture and 7 x 32 x (warm-up + capture) launches per replica.
              A rank that fails fails the phase; the parent joins the world
              within 420 s (``launches_dist`` of each kernel in the
              ``kernels`` line).

15. dist train — distributed training: one spawned world of 4 ``gloo``
              ranks on the card, ``ShardingPlan(tp=2, dp=2)`` (rank 0 loads
              the kernel library, the others wait for it); every leg is
              first run on one rank in this process while the ranks start
              up, its results go to a temporary directory, and the ranks
              take the card once it is free.
              15a: stablelm_3b at full width and 4 of its 32 layers, float32,
              the reference's Markov tokens, global batch 4 x 128, 2
              microbatches a dp rank, lr 1e-3: 3 masked steps
              (``make_train_step(..., plan=)``: premasked blocks, Megatron's
              collectives under autograd, the gradients' mean over dp, the
              global norm over tp, AdamW on ZeRO-1 moment blocks, the
              updated blocks gathered), then one step with
              ``compression="int8"``: each rank's loss and grad_norm within
              relative 1e-5 of one rank's at every step, its parameters
              within 2 x lr x steps of one rank's, its moments exactly half
              its tp block; step seconds, collectives a step and peak GB
              per rank.  15b: the packed fine-tuning step (``mode=
              "packed"``, xwT, K1 under autograd on each rank's column
              blocks and renumbered row slices): the wrappers count K1's
              launches in a rank's step gradients (equal to one rank's,
              nothing else launched), and the gradients at the packed values
              within relative L2 1e-5 of one rank's at the same slots.
              15c: olmoe_1b_7b at full width and 2 of its 16 layers, 32
              experts a rank (expert parallel), room for every token
              (capacity factor E / k): one step's loss and grad_norm within
              relative 1e-5 of one rank's over the same chunks of rows.
              15d: ``pipeline_apply`` over the 4 ranks as stages (the
              reference test's toy stages and sizes): outputs and the
              gradients at each stage's weight and at x within 1e-5 of
              autograd through the sequential composition.  15e:
              ``compressed_psum_int8`` over the dp group on CUDA tensors
              within 8 x scale of the exact sum.  15f: 15a's state after
              its 3 steps saved from the world (rank 0 writes whole leaves,
              each rank's blocks bit-equal to them), restored whole in this
              process (every leaf; parameters within 2 x lr x steps of one
              rank's) and under ``ShardingPlan(tp=2)`` on the first two
              ranks (``elastic_restore``: params and moments bit-equal to
              the saved leaves' blocks); 15b's shard stacks (the renumbered
              row-parallel values) and moment blocks saved the same way and
              restored under tp 2 at their slices' shapes, bit-equal.
              15g: two masked steps each of zamba2 (6 layers: its Mamba2
              mixers split by heads, their row maps), xlstm (one period:
              mLSTM split by heads, ``w_if`` / ``conv_w`` summed over tp),
              internvl2 and seamless (their frontends gathered), and
              stablelm_3b with one KV head (gathered), with wk / wv
              replicated and with int8 fake quantization (the row max over
              tp), each loss and grad_norm within relative 1e-5 of one
              rank's; of every leaf of the first block and the frontend,
              the rank's block of the AdamW moment m norm-wise within 2e-4
              of one rank's and of the update within 1e-2.  15h: 15a's
              model on a pod 2 x data 1 x model 2 mesh (dp over pod x
              data): one step within 1e-5 of one rank's first, one packed
              decode tick of each dp rank's slots equal to one rank's
              (tokens, logits relative L2 1e-5).
              ``launches_dist_train`` of each kernel in the ``kernels``
              line.

16. dist families — every family under ``ShardingPlan(tp=2)``: one
              spawned world of 2 ``gloo`` ranks on the card (both on
              cuda:0), each leg first served on one rank in this process
              (eager, as the ranks step) while the ranks start up.  16b:
              ``DF_LEGS`` at full width and cut depth: olmoe (expert
              parallel), zamba2 through its shared block, xlstm (int8),
              internvl2 (block), seamless (block int8), gemma3 past its
              512-slot rings with its one KV head gathered, h2o, and
              stablelm_3b with ``--spec-draft`` on both engines.  Each rank:
              its streams and logits equal the other rank's; float32 legs'
              tokens equal one rank's, bfloat16 legs' logits within
              ``DIST_LOGITS_GAP`` of one rank's up to the first differing
              token; zamba2's and xlstm's mixers split by heads (nothing
              gathered but mLSTM's xm and sLSTM's input, row-mapped
              projections, at most 0.55 of one rank's decode state); K1-K4
              counted from the engine's build to its drain
              (the dense legs: the rank's own decode step's launches by
              body x ticks; nothing else launched); the packed bytes it
              holds under the whole model's; a spec leg's draft nodes views
              of the rank's slices, and a float32 spec leg's ticks and
              launches by kernel equal one rank's.  16a: every rank-local
              packed weight of the legs (each at one layer or period, placed
              as ranks 0 and 1 place it) against its plain version at Bx =
              4, bfloat16 and float32; the spec model tier-sorted, placed
              and its 6:16 draft derived, both tiers at Bx 4, 8, 20 (the
              verify window) and 32 (the paged prefill chunk); zamba2 in
              the block layout too (``in_proj`` re-blocked by heads); and
              each
              leg's largest column block and row slice
              timed against its byte bound and a bf16 matmul of its local
              dense slice (``launches_dist_families`` and ``tp2_families``
              of each kernel in the ``kernels`` line).

17. paper    — the paper's workloads: every sparse im2col GEMM of ResNet50
              and ConvNeXt-T (``core.perfmodel``'s inventories) on the masks
              the figure scripts draw (Fig. 6's 95 % unstructured on
              ResNet50, seed 0; Fig. 8's 1:8, 1:4, 1:2 on both, seed 1; the
              DeMM cycles of each layer equal ``run_network``'s), values
              standard normal rounded to bf16, K padded with zeros to a
              multiple of 128, packed at 8k:128 (Fig. 6: the least k whose
              8k holds the densest group; Fig. 8: k = 2, 4, 8), B (K_pad, P)
              bf16.  17a: K5 through ``ops.demm_spmm(..., backend="cuda")``
              on all 125 problems (exactly 125 launches, no other kernel;
              the body each takes recorded) against the engine model
              ``core.demm.demm_spmm_k_passes`` on the card in float32,
              atol grown as the square root of the products summed.  17b:
              per network and pattern, K5's ms (graph replays of a ring
              larger than L2, 3 passes), the bound of the unpadded GEMM,
              one bf16 ``torch.matmul`` of the unpadded dense A, and, in
              the 17b lines only, the perf model's DeMM cycles at 500 MHz
              (the paper's modelled 512-MAC engine, not a measurement, so
              kept out of the JSON line).  17c: an
              ``activation_calibration``-quantized
              stablelm_3b gate projection through K3 at Bx = 4, the slices
              of ``pack_block_stacked`` of a two-layer weight through K2,
              and ``apply_packed`` with a re-tagged ``cfg`` through K1,
              counted and each against its plain version
              (``launches_paper`` of K5 and ``launches_leftovers`` of K1-K3
              in the ``kernels`` line).
18. census   — the dry-run census (``repro_torch.launch.dryrun``) against
              the card.  18a, run right after phase 4's xwT serve on its
              engine: the census of one packed decode step of the same
              cell on the meta device (stablelm_3b at full width, 4 slots,
              max_len 64, the engine's float32 cache and int64 tokens)
              must count exactly the engine's argument bytes (model,
              decode state, tokens) and exactly the K1 launches that one
              eager step on the engine counts (7 x 32); its peak live
              bytes against the ``max_memory_allocated`` rise over that
              step, and its ``memory_s`` against a captured step's device
              time, are printed (no gate).  18b: the census row of
              ``stablelm_3b decode_32k --packed`` on ``pod16x16``, on the
              meta device.

The last three lines are: the card as ``nvidia-smi`` names it, one JSON object
``{"kernels": [...], "serve": [...], "agree": {...}, "graph": {...},
"flight": {...}, "paged": [...], "paged_gates": {...}, "paged_cli": {...},
"tune": {...}, "spec": {...}, "windowed": {...}, "train": {...},
"families": {...}, "distribution": {...}, "distributed_training": {...},
"distribution_families": {...}, "paper": {...}, "census": {...}}``
(per kernel: wrapper launches on the dense, the paged, the speculative, the
training and the families' paths, error, times, bound, its gather body at
Bx = 32; per
serve run: ticks, decode-step time,
tokens/s, device launches per replay), and one JSON object ``{"ok": true,
"device": ...}``.

``--profile`` also profiles a steady window of decode ticks of the four
serving modes, the captured step and the eager step in turns (graph, eager,
eager, graph), and prints a table: host-clock tick, device time per tick,
device busy share, device launches per tick, tokens/s.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import json
import os
import shutil
import statistics
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense rates).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12}
L2_BYTES = 50e6
DEVICE = "cuda"

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
# products per output (G x Ne) up to which TOL["float32"] holds as it is
# (stablelm_3b's down projection, 144 x 3); see check_kernels.compare
F32_TERMS = 432

# (label, O, K, n, m) — what layers.init_linear gives full-width stablelm_3b
MAIN_SHAPES = [("wq/wk/wv/wo", 2560, 2560, 5, 80),
               ("gate/up", 6912, 2560, 5, 80),
               ("down", 2560, 6912, 3, 48)]
LAYER_MIX = {"wq/wk/wv/wo": 4, "gate/up": 2, "down": 1}   # launches per layer
REDUCED_SHAPE = ("reduced", 256, 128, 2, 16)
BATCHES = (1, 4, 37, 256)
# K1 / K3 at the widths of a prefill: the wide body's case (phase 3)
WIDE_BATCHES = (9, 20, 32, 37, 256)


def xwt_rule(bx, k, m, x_dtype):
    """The body K1 and K3 must take for ``bx`` rows of ``x_dtype``
    activations at contraction ``k`` and group width ``m``, weights of the
    main path (16-byte aligned, rows of pairs that fit): ``bulk`` at Bx <=
    8, ``wide`` for more rows of bfloat16 x whose rows and groups are whole
    16-byte vectors, ``gather`` otherwise (float32 x, M = 1)."""
    if bx <= 8:
        return "bulk"
    return ("wide" if str(x_dtype).endswith("bfloat16") and k % 8 == 0
            and m % 8 == 0 else "gather")


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# inputs
# ---------------------------------------------------------------------------

KERNELS = ("demm_xwT", "demm_xwT_q8", "demm_block_spmm", "demm_block_spmm_q8",
           "demm_spmm")


def kernel_fns():
    """name -> (kernel wrapper, plain version)."""
    from repro_torch.kernels import demm_block_spmm as kb
    from repro_torch.kernels import demm_q8 as kq
    from repro_torch.kernels import demm_spmm as ks
    from repro_torch.kernels import demm_xwT as kx
    return {
        "demm_xwT": (kx.demm_xwT, kx.demm_xwT_plain),
        "demm_xwT_q8": (kq.demm_xwT_q8, kq.demm_xwT_q8_plain),
        "demm_block_spmm": (kb.demm_block_spmm, kb.demm_block_spmm_plain),
        "demm_block_spmm_q8": (kq.demm_block_spmm_q8,
                               kq.demm_block_spmm_q8_plain),
        "demm_spmm": (ks.demm_spmm, ks.demm_spmm_plain),
    }


def make_packed(o, k, n, m, gen, *, duplicates=False):
    """Random packed weight on the card: distinct sorted indices per group
    (or, with ``duplicates``, every slot of a group on one column, values
    standard normal — their sums are not exact in bfloat16 — row 0 all
    padded)."""
    import torch
    g = k // m
    dev = gen.device
    if duplicates:
        idx = torch.randint(0, m, (o, g, 1), generator=gen, device=dev)
        idx = idx.expand(o, g, n).contiguous()
        vals = torch.randn((o, g, n), generator=gen, device=dev)
        vals[0] = 0
        idx[0] = 0
    else:
        scores = torch.rand((o, g, m), generator=gen, device=dev)
        idx = scores.topk(n, dim=-1).indices.sort(dim=-1).values
        vals = torch.randn((o, g, n), generator=gen, device=dev)
    return vals.to(torch.float32).contiguous(), idx.to(torch.int32).contiguous()


def make_dense(o, k, n, m, gen):
    """A random dense (O, K) weight on the card that satisfies n:m."""
    from repro_torch.core.sparsity import SparsityConfig, unpack
    vals, idx = make_packed(o, k, n, m, gen)
    return unpack(vals, idx, SparsityConfig(n, m), (o, k))


def make_q8(o, g, n, per_group, gen):
    import torch
    dev = gen.device
    q = torch.randint(-127, 128, (o, g, n), generator=gen, device=dev,
                      dtype=torch.int32).to(torch.int8)
    shape = (o, g) if per_group else (o,)
    scales = torch.rand(shape, generator=gen, device=dev) * 0.02 + 0.001
    return q, scales.to(torch.float32)


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def check_kernels(gen):
    import torch
    from repro_torch.core.sparsity import SparsityConfig, pack_block
    from repro_torch.kernels.demm_block_spmm import block_body
    from repro_torch.kernels.demm_q8 import block_q8_body, demm_xwT_q8_on
    from repro_torch.kernels.demm_spmm import spmm_body
    from repro_torch.kernels.demm_xwT import demm_xwT_on, xwt_body
    from repro_torch.quant import quantize_packed

    fns = kernel_fns()
    err = {name: 0.0 for name in KERNELS}
    bodies = {name: set() for name in KERNELS}
    n_cases = 0

    def compare(name, got, want, dtype, what, main, terms=0):
        """``terms``: products summed into one output, given for the
        windowed decoders' shapes only.  The float32 tolerance was set at
        stablelm_3b's shapes, at most 432 products an output; above that
        (gemma3's 1:1 projections sum 1152, the sums' intermediates growing
        as their square root while an output can cancel to near 0) its
        absolute part grows as the square root of the count: the rounding
        of a float32 sum in another order."""
        nonlocal n_cases
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or got.shape != want.shape:
            raise AssertionError(f"{name} {what}: bad output {got.dtype} "
                                 f"{tuple(got.shape)}")
        tol = dict(TOL[dtype])
        if dtype == "float32" and terms > F32_TERMS:
            tol["atol"] *= (terms / F32_TERMS) ** 0.5
        torch.testing.assert_close(got, want, **tol,
                                   msg=lambda m: f"{name} {what}: {m}")
        if main:
            err[name] = max(err[name], float((got - want).abs().max()))
        n_cases += 1

    def run_xwt(label, o, k, n, m, batches, *, duplicates=False, main=False,
                rows_per_block=None, values_dtype=torch.float32, expect=None,
                tunables=(), lanes=(), by_terms=False, wide_tunables=(),
                dtypes=("float32", "bfloat16"), q8=True):
        """K1 and K3 (per-row and per-group scales) on one random packed
        weight.  Each must take the body ``expect`` names (a body, or
        {x dtype: body}; None: ``bulk`` at Bx <= 8 where x's tile takes at
        most half a block's shared memory and K3's int8 rows and per-group
        scale rows are 16-byte multiples, either between; at Bx > 8
        :func:`xwt_rule`'s ``wide`` or ``gather``); ``tunables``: keyword
        arguments of the bulk body (rows per CTA, chunks), each through the
        measurement hooks; ``lanes``: K3's slot lanes per row, each forced
        at the default tile (the tunables' tiles reach the launcher's own
        choice of 8 or 16); ``wide_tunables``: keyword arguments of the wide
        body (rows per CTA, x tile); ``by_terms``: the float32 tolerance
        grows with the products an output sums (``compare``); ``q8``: K3
        too."""
        cfg = SparsityConfig(n, m)
        g = k // m
        terms = g * n if by_terms else 0
        kern, plain = fns["demm_xwT"]
        kern_q, plain_q = fns["demm_xwT_q8"]
        vals, idx = make_packed(o, k, n, m, gen, duplicates=duplicates)
        vals = vals.to(values_dtype)
        for bx in batches:
            for dtype in dtypes:
                x = torch.randn((bx, k), generator=gen, device=gen.device)
                x = x.to(getattr(torch, dtype))
                want_x = (expect.get(dtype) if isinstance(expect, dict)
                          else expect)
                what = (f"{label} O={o} K={k} {n}:{m} Bx={bx} x={dtype}"
                        + (" duplicates" if duplicates else "")
                        + (f" rows_per_block={rows_per_block}"
                           if rows_per_block else ""))
                body = xwt_body(x, vals, idx, m, duplicates=duplicates)
                tile = 8 if duplicates else 1 << (bx - 1).bit_length()
                want_body = want_x or (
                    xwt_rule(bx, k, m, x.dtype) if bx > 8 else "bulk"
                    if tile * k * x.element_size() <= BULK_SMEM_BYTES // 2
                    else body)
                if body != want_body:
                    raise AssertionError(f"{what}: K1 would take its {body} "
                                         "body")
                bodies["demm_xwT"].add(body)
                want = plain(x, vals, idx, cfg)
                # the main path says duplicates=False; duplicates take the
                # instantiation that sums them
                compare("demm_xwT",
                        kern(x, vals, idx, cfg, duplicates=duplicates,
                             rows_per_block=rows_per_block),
                        want, dtype, f"{what} {body}", main, terms)
                for tun in tunables if body == "bulk" else ():
                    compare("demm_xwT",
                            demm_xwT_on("bulk", x, vals, idx, cfg,
                                        duplicates=duplicates, **tun),
                            want, dtype, f"{what} bulk {tun}", main,
                            terms)
                for tun in wide_tunables if body == "wide" else ():
                    compare("demm_xwT",
                            demm_xwT_on("wide", x, vals, idx, cfg,
                                        duplicates=duplicates, **tun),
                            want, dtype, f"{what} wide {tun}", main,
                            terms)
                for per_group in (False, True) if q8 else ():
                    q, scales = make_q8(o, g, n, per_group, gen)
                    if duplicates:
                        q[0] = 0
                    what_q = what + (" per_group" if per_group else " per_row")
                    body = xwt_body(x, q, idx, m, duplicates=duplicates,
                                    scales=scales)
                    spans = (g * n) % 16 == 0 and (g % 4 == 0 or not per_group)
                    want_body = want_x or (
                        xwt_rule(bx, k, m, x.dtype) if bx > 8 else "bulk"
                        if spans and tile * k * x.element_size()
                        <= BULK_SMEM_BYTES // 2 else body)
                    if body != want_body:
                        raise AssertionError(f"{what_q}: K3 would take its "
                                             f"{body} body")
                    bodies["demm_xwT_q8"].add(body)
                    want = plain_q(x, q, idx, scales, cfg)
                    compare("demm_xwT_q8",
                            kern_q(x, q, idx, scales, cfg,
                                   duplicates=duplicates,
                                   rows_per_block=rows_per_block),
                            want, dtype, f"{what_q} {body}", main, terms)
                    q8_tunables = [*tunables,
                                   *(dict(lanes=ln) for ln in lanes)]
                    for tun in q8_tunables if body == "bulk" else ():
                        compare("demm_xwT_q8",
                                demm_xwT_q8_on("bulk", x, q, idx, scales, cfg,
                                               duplicates=duplicates, **tun),
                                want, dtype, f"{what_q} bulk {tun}", main,
                                terms)
                    for tun in wide_tunables if body == "wide" else ():
                        compare("demm_xwT_q8",
                                demm_xwT_q8_on("wide", x, q, idx, scales, cfg,
                                               duplicates=duplicates, **tun),
                                want, dtype, f"{what_q} wide {tun}", main,
                                terms)

    def run_block(what, pw, batches, main=False, paper_b=False,
                  cluster_sizes=(None,), dtypes=("float32", "bfloat16"),
                  by_terms=False):
        """K2 and K4 on one block packing, B = xᵀ (or B (K, Cd)); both take
        the cluster body in the serving orientation at Bx <= 8 where a
        group's activations are a 16-byte multiple; ``by_terms`` as
        ``run_xwt``'s."""
        o, k = pw.dense_shape
        kern, plain = fns["demm_block_spmm"]
        kern_q, plain_q = fns["demm_block_spmm_q8"]
        qw = quantize_packed(pw)
        # products an output sums: A_max x Ne
        terms = pw.values.shape[1] * pw.values.shape[-1] if by_terms else 0
        for bx in batches:
            for dtype in dtypes:
                x = torch.randn((bx, k), generator=gen, device=gen.device)
                b = (x.T.contiguous() if paper_b else x.T).to(
                    getattr(torch, dtype))
                tag = (f"{what} O={o} K={k} {pw.cfg.pattern_name()} "
                       f"block_geom={pw.block_geom} Cd={bx} B={dtype}")
                # the cluster body's spans: a group's M activations of B a
                # 16-byte multiple (not at M = 1, gemma3's 1:1 projections)
                serving = ("cluster" if bx <= 8 and not paper_b and
                           (pw.cfg.m * b.element_size()) % 16 == 0
                           else "gather")
                body = block_q8_body(qw.values, qw.indices, qw.scales, b,
                                     pw.cfg.m)
                body2 = block_body(pw.active_groups, pw.values, pw.indices,
                                   b, pw.cfg.m)
                if (body, body2) != (serving, serving):
                    raise AssertionError(f"{tag}: K4 / K2 would take their "
                                         f"{body} / {body2} bodies")
                bodies["demm_block_spmm_q8"].add(body)
                bodies["demm_block_spmm"].add(body2)
                want = plain(pw.active_groups, pw.values, pw.indices, b,
                             pw.cfg, r=o)
                for cs in cluster_sizes:
                    compare("demm_block_spmm",
                            kern(pw.active_groups, pw.values, pw.indices, b,
                                 pw.cfg, r=o, duplicates=pw.has_duplicates,
                                 cluster_size=cs), want, dtype,
                            f"{tag} {body2}"
                            + (f" cluster_size={cs}" if cs else ""), main,
                            terms)
                want = plain_q(qw.active_groups, qw.values, qw.indices,
                               qw.scales, b, qw.cfg, r=o)
                for cs in cluster_sizes:
                    compare("demm_block_spmm_q8",
                            kern_q(qw.active_groups, qw.values, qw.indices,
                                   qw.scales, b, qw.cfg, r=o,
                                   duplicates=qw.has_duplicates,
                                   cluster_size=cs), want, dtype,
                            f"{tag} {body}"
                            + (f" cluster_size={cs}" if cs else ""), main,
                            terms)

    def run_spmm(label, o, k, n, m, batches, *, duplicates=False, main=False,
                 dtypes=("float32", "bfloat16"), transposed=False,
                 expect=None, tunables=(None,)):
        """K5 with B (K, Cd) (or the transpose of a (Cd, K) tensor); with
        ``expect`` ("tiled" or "gather") the body a bfloat16 B must take (a
        float32 B always takes the gather body).  ``tunables``: (tile,
        groups per stage, stages) of the tiled body, each through the
        measurement hook; None: the wrapper's defaults."""
        from repro_torch.kernels.demm_spmm import demm_spmm_on
        cfg = SparsityConfig(n, m)
        kern, plain = fns["demm_spmm"]
        vals, idx = make_packed(o, k, n, m, gen, duplicates=duplicates)
        for cd in batches:
            for dtype in dtypes:
                shape = (cd, k) if transposed else (k, cd)
                b = torch.randn(shape, generator=gen, device=gen.device)
                b = b.to(getattr(torch, dtype))
                b = b.T if transposed else b
                body = spmm_body(vals, idx, b, m)
                if expect is not None and body != (
                        expect if dtype == "bfloat16" else "gather"):
                    raise AssertionError(f"{label} Cd={cd} B={dtype}: K5 "
                                         f"would take its {body} body")
                # K5's gather body is K2's launcher with the identity
                # address stream: never the cluster body
                if block_body(None, vals, idx, b, m) != "gather":
                    raise AssertionError(f"{label} Cd={cd}: K5 would take "
                                         "K2's cluster body")
                bodies["demm_spmm"].add(body)
                want = plain(vals, idx, b, cfg)
                for tun in tunables:
                    if tun is None:
                        got = kern(vals, idx, b, cfg, duplicates=duplicates)
                    else:
                        tile, ng, st = tun
                        got = demm_spmm_on(None, vals, idx, b, cfg,
                                           duplicates=duplicates, tile=tile,
                                           groups_per_stage=ng, stages=st)
                    compare("demm_spmm", got, want, dtype,
                            f"{label} R={o} K={k} {n}:{m} Cd={cd} B={dtype} "
                            f"{body}" + (" duplicates" if duplicates else "")
                            + (f" tile={tile} groups_per_stage={ng} "
                               f"stages={st}" if tun else ""),
                            main)

    for shape in MAIN_SHAPES + [REDUCED_SHAPE]:
        run_xwt(*shape, BATCHES, main=True)
    # K = 128 projections of the reduced config come out as 1:8
    run_xwt("reduced 1:8", 384, 128, 1, 8, (4, 37))
    # duplicate indices and an all-padded row
    run_xwt(*REDUCED_SHAPE, (4, 37), duplicates=True)
    run_xwt(*MAIN_SHAPES[2], (1, 4, 8), duplicates=True,
            tunables=[dict(chunks=4), dict(rows_per_block=7)],
            lanes=BULK_LANES)
    # x tile larger than a block's shared memory: the gather body's group
    # loop runs in chunks (and the bulk body does not take it; the wide body
    # takes bfloat16 x of 13 rows, in chunks of x's columns of its own)
    run_xwt("chunked", 520, 16384, 8, 128, (8,), expect="gather")
    run_xwt("chunked", 520, 16384, 8, 128, (13,),
            expect={"float32": "gather", "bfloat16": "wide"})
    # the wide body (Bx > 8, bfloat16 x) at the three main shapes, K3 with
    # both scale units, as a prefill chunk (32), a whole-sequence prefill
    # and ragged tiles launch it; its tunables (rows per CTA: one, ragged,
    # a CTA's most; x tile) and duplicates; 8:128 at 2048 rows (the
    # paper's example, several tiles split over CTAs along x)
    from repro_torch.kernels.demm_xwT import wide_plan
    for label, o, k, n, m in MAIN_SHAPES:
        run_xwt(label + " wide", o, k, n, m, WIDE_BATCHES,
                dtypes=("bfloat16",), main=True)
        # a CTA's most rows (128) where their decoded pairs fit
        most = 128 if wide_plan(37, o, k // m, m, n, rows=128) else 40
        run_xwt(label + " wide tunables", o, k, n, m, (20, 37),
                dtypes=("bfloat16",), wide_tunables=[
                    dict(rows_per_block=r, tile=t)
                    for r, t in ((1, 32), (7, 64), (most, 128), (53, None),
                                 (None, 64))])
        run_xwt(label + " wide", o, k, n, m, (9, 37), duplicates=True,
                dtypes=("bfloat16",))
    run_xwt("wide 8:128", 6912, 2560, 8, 128, (2048,), dtypes=("bfloat16",),
            wide_tunables=[dict(tile=32), dict(rows_per_block=96)])
    # non-default tiles, ragged against O
    run_xwt("tiles", 1000, 2560, 5, 80, (4,), rows_per_block=8)
    run_xwt("tiles", 1000, 2560, 5, 80, (3,), rows_per_block=72)
    # the bulk body's tunables at the three main shapes: rows per CTA (one
    # row; ragged; more than fit at once: a ring), chunks
    for label, o, k, n, m in MAIN_SHAPES:
        run_xwt(label + " bulk tunables", o, k, n, m, (1, 4, 8),
                tunables=[dict(chunks=c) for c in BULK_CHUNKS]
                + [dict(rows_per_block=r) for r in (1, 7, 160)]
                + [dict(rows_per_block=40, chunks=3)], lanes=BULK_LANES)
    # a tile far larger than shared memory: the ring of row chunks
    run_xwt("bulk ring", 3000, 6912, 3, 48, (4,),
            tunables=[dict(rows_per_block=3000), dict(rows_per_block=1000,
                                                      chunks=16)],
            lanes=BULK_LANES)
    # packed values already in bfloat16
    run_xwt("bf16 values", 300, 2560, 5, 80, (4,), values_dtype=torch.bfloat16)
    # 8:16-style override pattern (dense-ish groups), tiny M
    run_xwt("8:16", 384, 256, 8, 16, (2, 5))
    run_xwt("1:1", 64, 32, 1, 1, (2,))

    # the block layout: the main-path shapes as pack_block packs them, then
    # inactive tiles with an all-zero row block, a_max > G and duplicates
    for label, o, k, n, m in MAIN_SHAPES + [REDUCED_SHAPE]:
        cfg = SparsityConfig(n, m)
        g = k // m
        dense = make_dense(o, k, n, m, gen)
        pw = pack_block(dense, cfg)
        run_block(label, pw, BATCHES, main=True)
        br = pw.block_geom[0]
        keep = torch.rand((o // br, 1, g, 1), generator=gen,
                          device=gen.device) > 0.3
        keep[:, :, 1] = False            # at least one inactive group
        sparse = (dense.reshape(o // br, br, g, m) * keep).reshape(o, k)
        sparse[br:2 * br] = 0
        inactive = pack_block(sparse, cfg)
        if inactive.block_geom[1] >= g:
            raise AssertionError(f"{label}: no inactive group left")
        run_block(label + " inactive tiles + all-zero row block", inactive,
                  (1, 4, 8, 37))
        run_block(label + " a_max > G", pack_block(dense, cfg, a_max=g + 3),
                  (1, 4, 8))
        run_block(label + " B (K, Cd)", pw, (37,), paper_b=True)
        dv = torch.randn(pw.values.shape, generator=gen, device=gen.device)
        di = pw.indices[..., :1].expand(pw.indices.shape).contiguous()
        dv[0, :, 0] = 0
        dup = pw.replace(values=dv, indices=di)
        if not dup.has_duplicates:
            raise AssertionError("duplicate case holds no duplicates")
        run_block(label + " duplicates", dup, (1, 4, 8))
        if label != REDUCED_SHAPE[0]:
            # every cluster size, one stage ring (size 1 at 2560 x 6912),
            # both K2 and K4
            run_block(label + " cluster sizes", pw, (1, 4, 8),
                      cluster_sizes=CLUSTER_SIZES)
        run_spmm(label, o, k, n, m, BATCHES, main=True)
        run_spmm(label, o, k, n, m, (4,), duplicates=True)

    # the projection shapes of gemma3_1b and h2o_danube_1_8b that
    # stablelm_3b's do not cover, as the main path launches them, among them
    # gemma3's 1:1 patterns (M = 1, Ne = 1, G = 1152: every group one slot at
    # index 0, every group active in the block layout)
    covered = {(o, k, n, m) for _, o, k, n, m in MAIN_SHAPES}
    for cfg in windowed_cfgs().values():
        for label, o, k, n, m, _ in projection_shapes(cfg):
            if (o, k, n, m) in covered:
                continue
            covered.add((o, k, n, m))
            run_xwt(label, o, k, n, m, BATCHES, by_terms=True)
            pw = pack_block(make_dense(o, k, n, m, gen), SparsityConfig(n, m))
            run_block(label, pw, BATCHES, by_terms=True)

    # the families' shapes that phase 7f times (phase 13 runs every
    # family's shapes end to end): zamba2's in_proj (14,576 rows, so
    # pack_block's row blocks are 16 rows, the largest power of two
    # dividing them), its out_proj, and xlstm's 6:96 projection
    for label, o, k, n, m in FAMILY_TIMED_SHAPES:
        if (o, k, n, m) in covered:
            continue
        covered.add((o, k, n, m))
        run_xwt(label, o, k, n, m, (1, 4, 37), by_terms=True)
        pw = pack_block(make_dense(o, k, n, m, gen), SparsityConfig(n, m))
        run_block(label, pw, (1, 4, 37), by_terms=True)

    # K5's tiled body: ragged R, M of 16, 48, 80 and two that are not
    # multiples of 16 (zero rows written by the kernel), duplicates summed as
    # they are placed, every tile and stage count; a float32 B and a
    # transposed B take the gather body
    for n, m, g in ((2, 16, 10), (3, 48, 8), (5, 80, 8), (2, 40, 6),
                    (1, 8, 12)):
        run_spmm(f"tiled {n}:{m}", 100, g * m, n, m, (64, 200, 256, 1024),
                 dtypes=("bfloat16",), expect="tiled")
    run_spmm("tiled duplicates", 100, 640, 5, 80, (200,), duplicates=True,
             dtypes=("bfloat16",), expect="tiled")
    # every tile, groups per stage and stage count (8 groups: 3 or 5 per
    # stage leave a last stage of fewer groups), each (tile, groups per
    # stage, stages) one that fits a block's shared memory
    run_spmm("tiled tunables", 300, 640, 5, 80, (320,), dtypes=("bfloat16",),
             expect="tiled", tunables=(
                 ((128, 1), 1, 4), ((128, 1), 2, 3), ((128, 1), 3, 2),
                 ((128, 2), 1, 4), ((128, 2), 2, 2), ((256, 1), 1, 4),
                 ((256, 1), 1, 3), ((256, 2), 1, 3)))
    run_spmm("tiled tunables", 300, 384, 3, 48, (320,), dtypes=("bfloat16",),
             expect="tiled", tunables=(
                 ((128, 1), 4, 2), ((128, 1), 5, 2), ((256, 1), 2, 2),
                 ((256, 2), 2, 2)))
    run_spmm("gather float32 B", 100, 640, 5, 80, (256,),
             dtypes=("float32",), expect="gather")
    run_spmm("gather transposed B", 100, 640, 5, 80, (256,),
             dtypes=("bfloat16",), transposed=True, expect="gather")
    # rows of pairs not 16-byte aligned (G x Ne = 30): the gather body
    run_spmm("gather unaligned pair rows", 100, 480, 5, 80, (256,),
             dtypes=("bfloat16",), expect="gather")
    # draft tiers: K1-K4 on the prefix view [..., :t] of a stored stream,
    # read in place at the stored pitch, on every body
    tier_cases = [(label, o, k, 8, 16, (6, 4, 1))
                  for label, o, k, _, _ in MAIN_SHAPES]
    tier_cases += [(label, o, k, n, m, tuple(t for t in (2, 4) if t < n))
                   for label, o, k, n, m in MAIN_SHAPES]
    for label, o, k, n, m, tiers in tier_cases:
        for t in tiers:
            run_tier(f"{label} tier", o, k, n, m, t, (1, 4, 37), fns, gen,
                     compare, bodies)
    # duplicates inside the prefix and across its edge
    for t in (6, 4):
        run_tier("wq/wk/wv/wo tier duplicates", 2560, 2560, 8, 16, t, (1, 4),
                 fns, gen, compare, bodies, duplicates=True)
    # inf in x where only slots past the prefix point
    for t in (6, 1):
        run_tier_inf(2560, 2560, 8, 16, t, fns, gen)
        n_cases += 1
    for name, want in (("demm_xwT", {"bulk", "wide", "gather"}),
                       ("demm_xwT_q8", {"bulk", "wide", "gather"}),
                       ("demm_block_spmm", {"cluster", "gather"}),
                       ("demm_spmm", {"tiled", "gather"}),
                       ("demm_block_spmm_q8", {"cluster", "gather"})):
        if bodies[name] != want:
            raise AssertionError(f"{name} ran the bodies {bodies[name]}, "
                                 f"expected {want}")
    return err, n_cases


def tier_views(full, t):
    """The prefix views ``[..., :t]`` a draft tier hands the wrappers,
    asserted to start at the full tensors' storage (no copy)."""
    views = [a[..., :t] for a in full]
    for v, a in zip(views, full):
        if v.data_ptr() != a.data_ptr() or v.is_contiguous() and t < a.shape[-1]:
            raise AssertionError("a tier view is not a prefix view of the "
                                 "full tier's tensor")
    return views


def run_tier(label, o, k, n, m, t, batches, fns, gen, compare, bodies, *,
             duplicates=False):
    """K1, K3 (per-row and per-group scales), K2 and K4 on a draft tier:
    the first ``t`` of the ``n`` pairs stored per group, read in place.
    Each launch must take the body the full tier takes (bulk / cluster at
    Bx <= 8; at Bx = 37 K1 / K3's wide body for bfloat16 x, else gather;
    the bulk and cluster bodies copy the stored spans, the wide body
    decodes the prefix) and hold against the plain version on the same
    views.
    ``duplicates``: slots 0 and 1 of every group on one column (inside the
    prefix) and slots t-1 and t (across its edge)."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, pack_block
    from repro_torch.kernels.demm_block_spmm import block_body
    from repro_torch.kernels.demm_q8 import block_q8_body
    from repro_torch.kernels.demm_xwT import xwt_body
    from repro_torch.quant import quantize_packed

    full_cfg, cfg = SparsityConfig(n, m), SparsityConfig(t, m)
    g = k // m
    vals, idx = make_packed(o, k, n, m, gen)
    dense = make_dense(o, k, n, m, gen)
    pw = pack_block(dense, full_cfg)
    if duplicates:
        vals = torch.randn(vals.shape, generator=gen, device=gen.device)
        dv = torch.randn(pw.values.shape, generator=gen, device=gen.device)
        di = pw.indices.clone()
        for a in (idx, di):
            a[..., 1] = a[..., 0]
            a[..., t] = a[..., t - 1]
        pw = pw.replace(values=dv, indices=di)
    qw = quantize_packed(pw)
    kern, plain = fns["demm_xwT"]
    kern_q, plain_q = fns["demm_xwT_q8"]
    kb, plain_b = fns["demm_block_spmm"]
    kbq, plain_bq = fns["demm_block_spmm_q8"]
    v, i = tier_views((vals, idx), t)
    bv, bi = tier_views((pw.values, pw.indices), t)
    qv, qi = tier_views((qw.values, qw.indices), t)
    for bx in batches:
        for dtype in ("float32", "bfloat16"):
            x = torch.randn((bx, k), generator=gen, device=gen.device)
            x = x.to(getattr(torch, dtype))
            what = (f"{label} O={o} K={k} {n}:{m} t={t} Bx={bx} x={dtype}"
                    + (" duplicates" if duplicates else ""))
            body = xwt_body(x, v, i, m, duplicates=duplicates)
            if body != xwt_body(x, vals, idx, m, duplicates=duplicates) or \
                    body != xwt_rule(bx, k, m, x.dtype):
                raise AssertionError(f"{what}: K1 would take its {body} "
                                     "body")
            before = kern.body_launches[body]
            compare("demm_xwT", kern(x, v, i, cfg, duplicates=duplicates),
                    plain(x, v, i, cfg), dtype, f"{what} {body}", False)
            if kern.body_launches[body] != before + 1:
                raise AssertionError(f"{what}: K1 did not launch its {body} "
                                     "body")
            bodies["demm_xwT"].add(body)
            for per_group in (False, True):
                q, scales = make_q8(o, g, n, per_group, gen)
                if duplicates:
                    q[0] = 0
                (qx,) = tier_views((q,), t)
                tag = what + (" per_group" if per_group else " per_row")
                body = xwt_body(x, qx, i, m, duplicates=duplicates,
                                scales=scales)
                if body != xwt_body(x, q, idx, m, duplicates=duplicates,
                                    scales=scales):
                    raise AssertionError(f"{tag}: K3's tier body {body} is "
                                         "not its full tier's")
                before = kern_q.body_launches[body]
                compare("demm_xwT_q8",
                        kern_q(x, qx, i, scales, cfg, duplicates=duplicates),
                        plain_q(x, qx, i, scales, cfg), dtype,
                        f"{tag} {body}", False)
                if kern_q.body_launches[body] != before + 1:
                    raise AssertionError(f"{tag}: K3 did not launch its "
                                         f"{body} body")
                bodies["demm_xwT_q8"].add(body)
            b = x.T
            serving = "gather" if bx > 8 else "cluster"
            body = block_body(pw.active_groups, bv, bi, b, m)
            body_q = block_q8_body(qv, qi, qw.scales, b, m)
            if (body, body_q) != (serving, serving):
                raise AssertionError(f"{what}: K2 / K4 would take their "
                                     f"{body} / {body_q} bodies")
            before = kb.body_launches[body]
            compare("demm_block_spmm",
                    kb(pw.active_groups, bv, bi, b, cfg, r=o,
                       duplicates=duplicates),
                    plain_b(pw.active_groups, bv, bi, b, cfg, r=o), dtype,
                    f"{what} block {body}", False)
            if kb.body_launches[body] != before + 1:
                raise AssertionError(f"{what}: K2 did not launch its {body} "
                                     "body")
            compare("demm_block_spmm_q8",
                    kbq(qw.active_groups, qv, qi, qw.scales, b, cfg, r=o,
                        duplicates=duplicates),
                    plain_bq(qw.active_groups, qv, qi, qw.scales, b, cfg,
                             r=o), dtype, f"{what} block q8 {body_q}", False)
            bodies["demm_block_spmm"].add(body)
            bodies["demm_block_spmm_q8"].add(body_q)


def run_tier_inf(o, k, n, m, t, fns, gen):
    """K1, K3 (per-row and per-group scales), K2 and K4 on a draft tier
    whose prefix slots name columns 0..t-1 of their group and whose slots
    past it columns m-n+t..m-1, where x holds inf: on every body (Bx 1
    and 4, bulk / cluster; 37, K1 / K3's wide in bfloat16, gather) the
    output must be finite and
    bit-equal to the output on x without the inf, since a slot past the
    prefix is not multiplied."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, pack_block
    from repro_torch.quant import quantize_packed

    cfg, g = SparsityConfig(t, m), k // m
    cols = torch.tensor([s if s < t else m - n + s for s in range(n)],
                        dtype=torch.int32, device=gen.device)
    vals, _ = make_packed(o, k, n, m, gen)
    idx = cols.expand(o, g, n).contiguous()
    pw = pack_block(make_dense(o, k, n, m, gen), SparsityConfig(n, m))
    pw = pw.replace(indices=cols.expand(pw.indices.shape).contiguous())
    qw = quantize_packed(pw)
    tail = (torch.arange(g, device=gen.device)[:, None] * m
            + torch.arange(m - n + t, m, device=gen.device)).reshape(-1)
    v, i = tier_views((vals, idx), t)
    bv, bi = tier_views((pw.values, pw.indices), t)
    qv, qi = tier_views((qw.values, qw.indices), t)
    kern = fns["demm_xwT"][0]
    kern_q = fns["demm_xwT_q8"][0]
    kb = fns["demm_block_spmm"][0]
    kbq = fns["demm_block_spmm_q8"][0]
    for bx in (1, 4, 37):
        for dtype in ("float32", "bfloat16"):
            x = torch.randn((bx, k), generator=gen, device=gen.device)
            x = x.to(getattr(torch, dtype))
            x_inf = x.clone()
            x_inf[:, tail] = float("inf")
            calls = {"demm_xwT": lambda x: kern(x, v, i, cfg,
                                                duplicates=False),
                     "demm_block_spmm": lambda x: kb(
                         pw.active_groups, bv, bi, x.T, cfg, r=o,
                         duplicates=False),
                     "demm_block_spmm_q8": lambda x: kbq(
                         qw.active_groups, qv, qi, qw.scales, x.T, cfg, r=o,
                         duplicates=False)}
            for per_group in (False, True):
                q, scales = make_q8(o, g, n, per_group, gen)
                (qx,) = tier_views((q,), t)
                calls[f"demm_xwT_q8 per_group={per_group}"] = (
                    lambda x, qx=qx, scales=scales: kern_q(
                        x, qx, i, scales, cfg, duplicates=False))
            for name, call in calls.items():
                want, got = call(x), call(x_inf)
                torch.cuda.synchronize()
                if not (torch.isfinite(got).all() and torch.equal(got,
                                                                  want)):
                    raise AssertionError(
                        f"{name} t={t} Bx={bx} x={dtype}: inf at columns "
                        "only slots past the prefix name changed the "
                        "output")


# ---------------------------------------------------------------------------
# phases 4-6: serving
# ---------------------------------------------------------------------------

def reset_counts():
    for kern, _ in kernel_fns().values():
        kern.launches = 0
        for body in getattr(kern, "body_launches", {}):
            kern.body_launches[body] = 0


def read_counts():
    return {name: kern.launches for name, (kern, _) in kernel_fns().items()}


def read_body_counts():
    """Launches by body of the kernels that count them (K1, K2, K3)."""
    return {name: dict(kern.body_launches)
            for name, (kern, _) in kernel_fns().items()
            if hasattr(kern, "body_launches")}


# the body each serving kernel must run at Bx = 4 (K4's body is told apart
# on the device only, by its kernel name; K5 does not serve)
SERVING_BODY = {"demm_xwT": "bulk", "demm_xwT_q8": "bulk",
                "demm_block_spmm": "cluster", "demm_block_spmm_q8": "cluster"}


def device_kernel_of(name: str):
    """(kernel, body) of a DeMM kernel as the profiler names it on the card
    (the CUDA function's name and its weight policy), else None."""
    head = name.split("(")[0]
    q8 = "Int8" in head
    if "xwt_bulk_kernel" in head:
        return ("demm_xwT_q8" if q8 else "demm_xwT"), "bulk"
    if "xwt_wide_kernel" in head:
        return ("demm_xwT_q8" if q8 else "demm_xwT"), "wide"
    if "xwt_kernel" in head:
        return ("demm_xwT_q8" if q8 else "demm_xwT"), "gather"
    if "block_cluster_kernel" in head:
        return ("demm_block_spmm_q8" if q8 else "demm_block_spmm"), "cluster"
    if "block_spmm_kernel" in head:
        return ("demm_block_spmm_q8" if q8 else "demm_block_spmm"), "gather"
    if "spmm_tc_kernel" in head:
        return "demm_spmm", "tiled"
    return None


def device_kernel_counts(prof) -> dict:
    """Launches of each (kernel, body) in a torch.profiler window."""
    import torch
    counts = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        kb = device_kernel_of(e.key)
        if kb is not None:
            counts[kb] = counts.get(kb, 0) + e.count
    return counts


def profiled_replays(engine, cfg, expect, ticks=3, want=None):
    """A ``torch.profiler`` window of ``ticks`` graph replays on a drained
    engine given 4 new requests: each replay must launch the expected kernel
    7 x layers times on its serving body on the device (or, given ``want``,
    {(kernel, body): launches} per replay), and no other DeMM kernel, while
    no wrapper is called (the Python counters stay put).  The exact count
    a replay launches is read from the captured step's own nodes
    (:func:`graph_kernel_counts`: the engine must have captured under
    :func:`graphs_kept`); the profiler has lost the records of part of a
    window's first or last graph launch, so its window must see between
    ``ticks - 1`` and ``ticks`` replays' launches of those kernels and no
    other.  Returns the launches of one replay (given ``want``: the
    window's counts)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import Request

    per = want or {(expect, SERVING_BODY[expect]): 7 * cfg.num_layers}
    nodes, kernels = graph_kernel_counts(engine._graph)
    if nodes != per:
        raise AssertionError(f"the captured step's nodes launch {nodes} "
                             f"({kernels} kernel nodes), expected {per}")
    rng = np.random.default_rng(7)
    for i in range(4):
        engine.submit(Request(uid=100 + i, max_new_tokens=50,
                              prompt=rng.integers(0, cfg.vocab_size, 3,
                                                  dtype=np.int32)))
    engine.step()                        # claims the slots; a replay
    torch.cuda.synchronize()
    before = read_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    if read_counts() != before:
        raise AssertionError(f"graph replays called a kernel wrapper: "
                             f"{before} -> {read_counts()}")
    got = device_kernel_counts(prof)
    if set(got) != set(per) or not all(
            (ticks - 1) * n <= got[kb] <= ticks * n
            for kb, n in per.items()):
        raise AssertionError(
            f"{ticks} profiled replays launched {got} on the device: expected "
            f"{per} per replay ({cfg.num_layers} layers), nothing else (the "
            f"records of up to one replay may be lost)")
    if want is not None:
        return got
    return per[(expect, SERVING_BODY[expect])]


def serve_full_width(model, cfg, *, layout, quantize, expect, keep=None):
    """Drive run_serve once; check the outputs, that the wrappers launched
    the expected kernel 7 x layers times in each of the warm-up step(s) and
    the capture of the decode step (K1, K2, K3 on their serving bodies) and
    nothing else, and that each replay of the captured step ran it on the
    device 7 x layers times on its serving body (a profiled window).
    ``keep`` (a list): the engine is appended to it (phase 18a)."""
    import torch
    from repro_torch import obs
    from repro_torch.launch.serve import run_serve
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    requests, max_new = 4, 8
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    with graphs_kept():                  # profiled_replays reads the graph
        engine = run_serve(model, cfg.vocab_size, packed=True,
                           layout=layout, quantize=quantize, backend="cuda",
                           requests=requests, slots=4, max_new=max_new,
                           max_len=64, seed=0, device=DEVICE,
                           metrics=obs.MetricsRegistry())
    body = SERVING_BODY[expect]
    launches = check_step_counts(        # ... and just after
        expect, {(expect, body): 7 * cfg.num_layers}, CAPTURE_WARMUP + 1,
        f"{cfg.name} {layout} {quantize}")
    ticks = engine.drain_ticks
    if len(engine.completed) != requests:
        raise AssertionError(f"{len(engine.completed)} of {requests} "
                             "requests completed")
    for r in engine.completed:
        if len(r.output) != max_new:
            raise AssertionError(f"request {r.uid}: {len(r.output)} tokens")
        if not all(0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: token outside the true "
                                 f"vocab: {r.output}")
    import numpy as np
    if not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError("non-finite logits")
    if engine._graph is None:
        raise AssertionError("the CUDA engine did not capture its step")
    tokens = sum(len(r.output) for r in engine.completed)
    entry = {
        "layout": layout, "quantize": quantize, "ticks": ticks,
        "tokens": tokens, "drain_s": engine.drain_seconds,
        "tick_ms_mean": 1e3 * engine.drain_seconds / ticks,
        "decode_step_ms_p50": 1e3 * engine._sk_tok.quantile(0.5),
        "tokens_per_s": tokens / engine.drain_seconds,
        "launches": launches,
        "body": body,
        "first_output": engine.completed[0].output,
        "outputs": {r.uid: list(r.output) for r in engine.completed},
    }
    entry["device_launches_per_replay"] = profiled_replays(engine, cfg,
                                                           expect)
    if keep is not None:
        keep.append(engine)
    return entry


def spmm_path(gen):
    """Phase 5c: the paper orientation's entry point, ``ops.demm_spmm``,
    backend ``cuda``, on the seven projection shapes of one layer with B of
    4 and of 256 columns; the launch count and backend ``reference``."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels import ops

    problems = []
    for label, o, k, n, m in MAIN_SHAPES:
        for _ in range(LAYER_MIX[label]):
            vals, idx = make_packed(o, k, n, m, gen)
            for cd in (4, 256):
                b = torch.randn((k, cd), generator=gen, device=gen.device)
                problems.append((vals, idx, b.to(torch.bfloat16),
                                 SparsityConfig(n, m), (o, k)))
    torch.cuda.synchronize()
    reset_counts()                       # just before the path ...
    outs = [ops.demm_spmm(v, i, b, cfg, shape, backend="cuda",
                          duplicates=False)
            for v, i, b, cfg, shape in problems]
    torch.cuda.synchronize()
    counts = read_counts()               # ... and just after
    want = {name: 0 for name in KERNELS}
    want["demm_spmm"] = len(problems)
    if counts != want:
        raise AssertionError(f"ops.demm_spmm launch counts {counts}, "
                             f"expected {want}")
    worst = 0.0
    for out, (v, i, b, cfg, shape) in zip(outs, problems):
        ref = ops.demm_spmm(v, i, b, cfg, shape, backend="reference")
        torch.testing.assert_close(out, ref, **TOL["bfloat16"])
        worst = max(worst, float((out - ref).abs().max()))
    return {"calls": len(problems), "launches": counts["demm_spmm"],
            "max_abs_err_vs_reference": worst}


def serve_collect(model, cfg, backend, eager=False, slots=2,
                  autotune=False):
    """Greedy serve on ``slots`` slots, keeping every tick's logits;
    ``eager`` runs the decode step eagerly instead of replaying its captured
    graph (the engine's measurement hook); ``autotune`` has the engine tune
    its packed weights at ``slots`` rows first."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    engine = ServeEngine(model, ServeConfig(num_slots=slots, max_len=48),
                         policy=ExecPolicy(mode="packed", backend=backend),
                         device=DEVICE, metrics=obs.MetricsRegistry(),
                         autotune=autotune, _eager=eager)
    rng = np.random.default_rng(1)
    for i in range(3):
        prompt = rng.integers(0, cfg.vocab_size, rng.integers(4, 9),
                              dtype=np.int32)
        engine.submit(Request(uid=i, prompt=prompt, max_new_tokens=6))
    logits = []
    while engine.queue or any(r is not None for r in engine.active):
        engine.step()
        logits.append(engine.last_logits.copy())
    return logits, {r.uid: list(r.output) for r in engine.completed}


def check_backends_agree(cfg_full):
    import numpy as np
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model

    cfg = dataclasses.replace(cfg_full, num_layers=2, compute_dtype="float32")
    report, tokens = {}, {}
    for layout in ("xwT", "block"):
        model = pack_tree(build_model(cfg, device=DEVICE, seed=1),
                          layout=layout)
        la, ta = serve_collect(model, cfg, "cuda")
        lb, tb = serve_collect(model, cfg, "reference")
        if len(la) != len(lb):
            raise AssertionError(f"{layout}: tick counts differ: {len(la)} vs "
                                 f"{len(lb)}")
        worst = 0.0
        for t, (a, b) in enumerate(zip(la, lb)):
            a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
            if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                raise AssertionError(
                    f"{layout} tick {t}: logits differ between backends, max "
                    f"abs {np.abs(a - b).max()}")
            worst = max(worst, float(np.abs(a - b).max()))
        if ta != tb:
            raise AssertionError(f"{layout}: token streams differ: {ta} vs "
                                 f"{tb}")
        report[layout] = {"ticks": len(la), "max_abs_logit_diff": worst,
                          "streams": len(ta)}
        tokens[layout] = ta
    if tokens["xwT"] != tokens["block"]:
        raise AssertionError(f"xwT and block layouts give different tokens: "
                             f"{tokens['xwT']} vs {tokens['block']}")
    report["xwT_tokens_equal_block_tokens"] = True
    return report


def graph_vs_eager(model, cfg, label, backend="cuda", slots=2):
    """Phase 4g/5g (and 9 under ``auto``): the captured step against the
    eager step on the same model: the same tokens, and bit-equal logits on
    every tick.  Returns the report and the captured step's logits and
    tokens."""
    import numpy as np

    lg, tg = serve_collect(model, cfg, backend, slots=slots)
    le, te = serve_collect(model, cfg, backend, eager=True, slots=slots)
    if len(lg) != len(le) or tg != te:
        raise AssertionError(f"{label}: graph and eager steps give different "
                             f"tokens: {tg} vs {te}")
    for t, (a, b) in enumerate(zip(lg, le)):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{label} tick {t}: graph and eager logits differ, max abs "
                f"{np.abs(a - b).max()}")
    return {"mode": label, "ticks": len(lg), "streams": len(tg),
            "tokens_equal": True, "logits_bit_equal": True}, lg, tg


def check_graph_modes(cfg_full, auto=True, prefill=False, **over):
    """Phase 6g: full width, 2 layers, float32 compute, in the four serving
    modes: the captured step's tokens equal the eager step's and backend
    ``reference``'s (its logits bit-equal to the eager step's, allclose to
    the reference's at rtol 1e-3).  Phase 9's leg on the same models
    (``auto``): an engine built with ``autotune=True`` under backend
    ``auto`` gives the tokens of ``cuda`` and ``reference``, its logits
    allclose to both.  ``over``: other fields of the config (11d);
    ``prefill``: also prefill of a 40-token prompt against the engine fed
    its tokens one by one, allclose at rtol 1e-3 (11e)."""
    import numpy as np
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model

    cfg = dataclasses.replace(cfg_full, **{"num_layers": 2,
                                           "compute_dtype": "float32",
                                           **over})
    report = {}
    for layout in ("xwT", "block"):
        for quantize in (None, "int8"):
            label = f"{layout}" + (f"+{quantize}" if quantize else "")
            model = pack_tree(build_model(cfg, device=DEVICE, seed=1),
                              layout=layout, quantize=quantize)
            entry, lg, tg = graph_vs_eager(model, cfg, label)
            lr, tr = serve_collect(model, cfg, "reference")
            if tg != tr:
                raise AssertionError(f"{label}: graph cuda and reference "
                                     f"tokens differ: {tg} vs {tr}")
            worst = 0.0
            for t, (a, b) in enumerate(zip(lg, lr)):
                a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
                if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                    raise AssertionError(
                        f"{label} tick {t}: graph logits differ from the "
                        f"reference's, max abs {np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
            entry["tokens_equal_reference"] = True
            entry["max_abs_logit_diff_vs_reference"] = worst
            if prefill:
                entry["prefill_rel_l2_gap_40_tokens"] = prefill_gap(
                    model, cfg, mode_kernel(layout, quantize), rtol=1e-3,
                    tokens=40)[0]
            if not auto:
                report[label] = entry
                continue
            la, ta = serve_collect(model, cfg, "auto", autotune=True)
            if ta != tg or len(la) != len(lg):
                raise AssertionError(f"{label}: auto and cuda tokens "
                                     f"differ: {ta} vs {tg}")
            entry["auto"] = {"tokens_equal_cuda_and_reference": True}
            for backend, other in (("cuda", lg), ("reference", lr)):
                diff = 0.0
                for t, (a, b) in enumerate(zip(la, other)):
                    a, b = a[:, :cfg.vocab_size], b[:, :cfg.vocab_size]
                    if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                        raise AssertionError(
                            f"{label} tick {t}: auto logits differ from "
                            f"{backend}'s, max abs {np.abs(a - b).max()}")
                    diff = max(diff, float(np.abs(a - b).max()))
                entry["auto"][f"max_abs_logit_diff_vs_{backend}"] = diff
            report[label] = entry
    return report


def flight_run(cfg):
    """Phase 6f: ``launch.serve`` as a user runs it, at full width with
    ``--profile-dir``, ``--flight-dir``, ``--slo-report`` and one forced
    stall: exactly one flight dump, and the profiler trace holds the
    kernels of every replay of the captured step by name (7 x layers of K1
    on its bulk body for the warm-up step and each tick)."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch.serve import main as serve_main

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_flight_")
    flight, prof = (os.path.join(out_dir, d) for d in ("flight", "profile"))
    metrics_out = os.path.join(out_dir, "metrics.json")
    prev = obs.default_registry()
    obs.set_default_registry(obs.MetricsRegistry())
    try:
        serve_main(["--arch", cfg.name, "--full", "--packed", "--requests",
                    "4", "--max-new", "8", "--max-len", "64",
                    "--profile-dir", prof, "--flight-dir", flight,
                    "--force-stall", "--slo-report", "--metrics-out",
                    metrics_out])
        return read_flight_run(cfg, flight, prof, metrics_out)
    finally:
        obs.set_default_registry(prev)
        shutil.rmtree(out_dir, ignore_errors=True)


def read_flight_run(cfg, flight, prof, metrics_out):
    """Check what :func:`flight_run`'s serve program left behind."""
    from repro_torch.obs.profile import TRACE_FILE
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    dumps = sorted(os.listdir(flight))
    if dumps != ["flight-0001-stall-serve_tick"]:
        raise AssertionError(f"expected one stall dump, found {dumps}")
    for f in ("rings.json", "metrics.json", "meta.json"):
        if not os.path.exists(os.path.join(flight, dumps[0], f)):
            raise AssertionError(f"flight dump without {f}")
    with open(metrics_out) as f:
        snap = json.load(f)
    (tick_hist,) = [h for h in snap["histograms"]
                    if h["name"] == "serve_tick_seconds"]
    ticks = tick_hist["count"]
    with open(os.path.join(prof, TRACE_FILE)) as f:
        events = json.load(f)["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kb = device_kernel_of(e.get("name", ""))
            if kb is not None:
                kernels[kb] = kernels.get(kb, 0) + 1
    want = {("demm_xwT", "bulk"): 7 * cfg.num_layers * (CAPTURE_WARMUP
                                                        + ticks)}
    if kernels != want:
        raise AssertionError(
            f"profiler trace of {ticks} ticks holds DeMM kernels {kernels}: "
            f"expected {want} (the warm-up step and every replay)")
    graph_launches = sum(1 for e in events
                         if "cudaGraphLaunch" in str(e.get("name", "")))
    return {"ticks": ticks, "dumps": dumps,
            "trace_kernels": sum(kernels.values()),
            "graph_launches_in_trace": graph_launches,
            "trace_bytes": os.path.getsize(os.path.join(prof, TRACE_FILE))}


def profile_ticks(model, cfg, label, ticks=5, eager=False):
    """``--profile``: a steady window of decode ticks on 4 full slots, first
    on the host clock, then under ``torch.profiler``; prints the device-busy
    share and the kernels that take the device time, under ``label`` (the
    serving mode).  ``eager`` runs the eager step in place of the graph."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    engine = ServeEngine(model, ServeConfig(num_slots=4, max_len=64),
                         policy=ExecPolicy(mode="packed", backend="cuda"),
                         device=DEVICE, metrics=obs.MetricsRegistry(),
                         _eager=eager)
    rng = np.random.default_rng(0)
    for i in range(4):
        engine.submit(Request(uid=i, max_new_tokens=50, prompt=rng.integers(
            0, cfg.vocab_size, 4, dtype=np.int32)))
    for _ in range(6):
        engine.step()
    torch.cuda.synchronize()
    tok0 = engine._m_tokens.value
    t0 = time.perf_counter()
    for _ in range(ticks):
        engine.step()
    torch.cuda.synchronize()
    plain_tick_ms = 1e3 * (time.perf_counter() - t0) / ticks
    tokens_per_s = (engine._m_tokens.value - tok0) / (plain_tick_ms * ticks
                                                      / 1e3)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    ka = prof.key_averages()
    # kernel rows only: an op's row repeats the time of the kernels it launched
    dev = [(e.key, e.self_device_time_total / 1e3, e.count) for e in ka
           if e.device_type == torch.autograd.DeviceType.CUDA]
    dev.sort(key=lambda r: -r[1])
    dev_ms = sum(r[1] for r in dev)
    report = {
        "mode": label, "step": "eager" if eager else "graph",
        "ticks": ticks, "tick_ms_unprofiled": plain_tick_ms,
        "tokens_per_s_unprofiled": tokens_per_s,
        "tick_ms_profiled": wall_ms / ticks,
        "device_ms_per_tick": dev_ms / ticks,
        "device_busy_share_unprofiled": dev_ms / ticks / plain_tick_ms,
        "device_launches_per_tick": sum(r[2] for r in dev) / ticks,
        "top_device_ms_per_tick": [
            {"name": k[:70], "ms": t / ticks, "calls": c / ticks}
            for k, t, c in dev[:12]],
    }
    log(f"[profile] {json.dumps(report)}")
    return report


# ---------------------------------------------------------------------------
# phase 8: the paged engine (chunked prefill and decode, two captured graphs)
# ---------------------------------------------------------------------------

PAGED = dict(num_slots=4, max_len=512, page_size=16, prefill_chunk=32)
PAGED_REQUESTS, PAGED_NEW = 8, 16
# the body each serving kernel runs in a prefill chunk: x of 32 bfloat16 rows
PREFILL_BODY = {"demm_xwT": "wide", "demm_xwT_q8": "wide",
                "demm_block_spmm": "gather", "demm_block_spmm_q8": "gather"}


def paged_prompts(vocab, n=PAGED_REQUESTS, seed=11, lo=40, hi=400,
                  chunk=PAGED["prefill_chunk"]):
    """``n`` prompts of ``lo`` to ``hi`` tokens from a seeded generator, none
    a multiple of the chunk: every request takes several chunks and ends on
    a partial one."""
    import numpy as np
    rng = np.random.default_rng(seed)
    lengths = rng.integers(lo, hi + 1, n)
    lengths[lengths % chunk == 0] += 1
    return [rng.integers(0, vocab, int(t), dtype=np.int32) for t in lengths]


def paged_engine(model, backend="cuda", eager=False, **cfg):
    """A paged engine through ``make_engine`` (as a user builds one), or the
    eager-programs measurement hook."""
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import make_engine

    config = PagedServeConfig(**{**PAGED, **cfg})
    policy = ExecPolicy(mode="packed", backend=backend)
    if eager:
        return PagedServeEngine(model, config, policy=policy, device=DEVICE,
                                metrics=obs.MetricsRegistry(), _eager=True)
    return make_engine(model, config, policy=policy, device=DEVICE,
                       metrics=obs.MetricsRegistry())


def submit_all(engine, prompts, max_new, uid0=0):
    from repro_torch.serve import Request
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=uid0 + i, prompt=p, max_new_tokens=max_new))


def drain_recording(engine, prompts, max_new, uid0=0):
    """Serve ``prompts`` (uid = index) to the end, keeping every logits row
    the sampler reads, in call order, as (program, uid, position, row):
    ``"prefill"`` for a request's last chunk, ``"decode"`` for a decode
    step's lane.  (The rows of masked lanes are not kept: they may read the
    null page, whose content is not deterministic.)  Returns (that list,
    {uid: tokens}).  Request ``i`` gets uid ``uid0 + i``."""
    import numpy as np

    seen, program = [], ["decode"]
    finish, sample = engine._finish_prefill, engine.sampler.sample

    def in_prefill(*args):
        program[0] = "prefill"
        try:
            return finish(*args)
        finally:
            program[0] = "decode"

    def record(logits, uid, pos):
        seen.append((program[0], uid, pos, np.array(logits, copy=True)))
        return sample(logits, uid, pos)

    engine._finish_prefill = in_prefill
    engine.sampler = types.SimpleNamespace(sample=record)  # (a frozen dataclass)
    submit_all(engine, prompts, max_new, uid0)
    engine.run_until_drained()
    del engine._finish_prefill              # no reference cycle left
    return seen, {r.uid: list(r.output) for r in engine.completed
                  if r.uid >= uid0}


def pass_report(engine, requests, t0, t1):
    """Time to first token per request (ms, by uid), prompt tokens per
    second until the last first token, and tokens per second over the pass
    [t0, t1] (host clock) of ``requests``."""
    reqs = sorted(requests, key=lambda r: r.uid)
    prompt_tokens = sum(len(r.prompt) for r in reqs)
    last_first = max(r.first_token_ts for r in reqs)
    first_submit = min(r.submit_ts for r in reqs)
    return {
        "ttft_ms": [1e3 * (r.first_token_ts - r.submit_ts) for r in reqs],
        "prompt_tokens": prompt_tokens,
        "prompt_tokens_per_s": prompt_tokens / (last_first - first_submit),
        "drain_s": t1 - t0,
        "tokens_per_s": sum(len(r.output) for r in reqs) / (t1 - t0),
    }


def profiled_window(engine, ticks):
    """``ticks`` engine ticks under ``torch.profiler``: device ms, DeMM
    device launches by (kernel, body), the program dispatches in the window
    and the kernels that take the device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    p0, d0 = engine.prefill.dispatches, engine._m_disp_decode.value
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            engine.step()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    rows.sort(key=lambda r: -r[1])
    return {"prefill_dispatches": engine.prefill.dispatches - p0,
            "decode_dispatches": int(engine._m_disp_decode.value - d0),
            "device_ms": sum(r[1] for r in rows),
            "device_launches": sum(r[2] for r in rows),
            "demm": device_kernel_counts(prof),
            "top": [{"name": k[:70], "ms": t, "calls": c}
                    for k, t, c in rows[:14]]}


def replay_window(engine, ticks, dispatches, graph, want, what):
    """:func:`profiled_window` over ``ticks`` ticks of a paged engine that
    must dispatch ``dispatches`` = (prefill chunks, decode steps), replays
    of ``graph`` (captured under :func:`graphs_kept`) whose nodes launch
    exactly ``want`` = {(kernel, body): launches} each (read from the graph
    itself, :func:`graph_kernel_counts`).  The profiler has lost the
    records of part of a window's first or last graph launch (784 and 888
    of 896 DeMM records in two windows of four chunk replays on the H100),
    so its DeMM records must name those kernels only and cover all but at
    most one replay's launches; the window's device ms and launches are
    scaled to the whole window by the share of DeMM records it kept (1
    when none was lost), the share reported beside them, and its DeMM
    launches are the graph's."""
    replays = sum(dispatches)
    got, kernels = graph_kernel_counts(graph)
    if got != want:
        raise AssertionError(f"{what}: the graph's nodes launch {got} "
                             f"({kernels} kernel nodes), expected {want}")
    window = profiled_window(engine, ticks)
    seen = window["demm"]
    if (window["prefill_dispatches"], window["decode_dispatches"]) \
            != dispatches or set(seen) != set(want) or not all(
                (replays - 1) * n <= seen[kb] <= replays * n
                for kb, n in want.items()):
        raise AssertionError(
            f"{what}: expected {dispatches} dispatches and {want} per "
            f"replay (the records of at most one replay lost): {window}")
    share = sum(seen.values()) / (replays * sum(want.values()))
    window["demm_records_share"] = share
    window["device_ms_recorded"] = window["device_ms"]
    window["device_ms"] /= share
    window["device_launches"] /= share
    window["demm"] = {kb: n * replays for kb, n in want.items()}
    return window


def paged_windows(engine, cfg, expect):
    """On a drained engine whose programs are captured: 4 requests of 129
    prompt tokens (5 chunks each) and 50 new tokens.  Tick 1 (host clock,
    synchronised) and tick 2 (profiled) run 4 non-final chunks each and no
    decode step; once all 4 decode, 5 ticks on the host clock and 5 under
    the profiler.  Each prefill replay must launch the mode's kernel 7 x
    layers times on the gather body and each decode replay 7 x layers times
    on its serving body, and no other DeMM kernel (the graphs' nodes, and
    the profiler's records: :func:`replay_window`); the engine's programs
    must have been captured under :func:`graphs_kept`."""
    import numpy as np
    import torch

    per = 7 * cfg.num_layers
    rng = np.random.default_rng(5)
    submit_all(engine, [rng.integers(0, cfg.vocab_size, 129, dtype=np.int32)
                        for _ in range(4)], 50, uid0=1000)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.step()
    torch.cuda.synchronize()
    chunk_ms = 1e3 * (time.perf_counter() - t0) / 4
    pre = replay_window(engine, 1, (4, 0), engine.prefill._graph,
                        {(expect, PREFILL_BODY[expect]): per},
                        "prefill window")
    while not engine._decode_mask.all():
        engine.step()
    for _ in range(2):
        engine.step()
    torch.cuda.synchronize()
    tok0 = engine._m_tokens.value
    t0 = time.perf_counter()
    for _ in range(5):
        engine.step()
    torch.cuda.synchronize()
    tick_ms = 1e3 * (time.perf_counter() - t0) / 5
    tokens_per_s = (engine._m_tokens.value - tok0) / (5 * tick_ms / 1e3)
    dec = replay_window(engine, 5, (0, 5), engine._graph,
                        {(expect, SERVING_BODY[expect]): per},
                        "decode window")
    engine.run_until_drained()
    return {
        "prefill_chunk": {
            "ms_host_clock": chunk_ms,
            "device_ms": pre["device_ms"] / 4,
            "demm_records_share": pre["demm_records_share"],
            "device_launches": pre["device_launches"] / 4,
            "demm_launches_by_body": {f"{k}/{b}": n // 4 for (k, b), n
                                      in pre["demm"].items()},
            "top_device_ms": [{**t, "ms": t["ms"] / 4, "calls": t["calls"] / 4}
                              for t in pre["top"]]},
        "decode_tick": {
            "ms_host_clock": tick_ms, "tokens_per_s": tokens_per_s,
            "device_ms": dec["device_ms"] / 5,
            "demm_records_share": dec["demm_records_share"],
            "busy_share": dec["device_ms"] / 5 / tick_ms,
            "device_launches": dec["device_launches"] / 5,
            "demm_launches_by_body": {f"{k}/{b}": n // 5 for (k, b), n
                                      in dec["demm"].items()},
            "top_device_ms": [{**t, "ms": t["ms"] / 5, "calls": t["calls"] / 5}
                              for t in dec["top"]]},
    }


def page_gather_ms(engine, cfg):
    """Device time of the decode step's page gathers, timed alone, with
    every slot's block-table row full of distinct pages (all slots at
    ``max_len``: the most a tick gathers; a ring over the layers' arenas,
    which exceed L2): K and V of every layer, per tick.  Its bound is the
    bytes of those pages read once and of the gathered caches written
    once."""
    import torch
    from repro_torch.models.attention import gather_pages

    caches = engine.state["caches"]
    slots, nblk = caches["block_table"].shape
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    bt = (torch.randperm(engine.layout.usable_pages, generator=gen,
                         device=DEVICE)[:slots * nblk] + 1).view(slots, nblk)
    calls = [lambda a=a: gather_pages(a, bt)
             for name in ("k", "v") for a in caches[name].unbind(0)]
    ms = time_ring(calls)[0]
    one = gather_pages(caches["k"][0], bt)
    nbytes = 2 * one.nbytes             # distinct pages read, copy written
    del one
    torch.cuda.empty_cache()
    return {"ms_per_gather": ms, "gathers_per_tick": len(calls),
            "ms_per_tick": ms * len(calls), "bytes_per_gather": nbytes,
            "bound_ms_per_tick": 1e3 * nbytes * len(calls) / HBM_BYTES_PER_S}


def graph_equals_eager_paged(model, cfg, prompts, max_new, label,
                             backend="cuda"):
    """Both captured programs against the eager programs on the same model
    and prompts: bit-equal logits of every request's last chunk and of every
    decode step, the same tokens, one capture of each program."""
    import numpy as np

    graph = paged_engine(model, backend=backend)
    lg, tg = drain_recording(graph, prompts, max_new)
    le, te = drain_recording(paged_engine(model, backend=backend, eager=True),
                             prompts, max_new)
    if (graph.captures, graph.prefill.captures) != (1, 1):
        raise AssertionError(f"{label}: captures {graph.captures} (decode), "
                             f"{graph.prefill.captures} (prefill); expected "
                             "one each")
    if [e[:3] for e in lg] != [e[:3] for e in le] or tg != te:
        raise AssertionError(f"{label}: graph and eager programs give "
                             f"different tokens: {tg} vs {te}")
    for (kind, uid, pos, a), (*_, b) in zip(lg, le):
        if not np.array_equal(a, b):
            raise AssertionError(
                f"{label} {kind} logits of request {uid} at {pos}: graph "
                f"and eager differ, max abs {np.abs(a - b).max()}")
    return {"prefill_logits_bit_equal": sum(e[0] == "prefill" for e in lg),
            "decode_logits_bit_equal": sum(e[0] == "decode" for e in lg),
            "tokens_equal": True, "captures": [1, 1]}


def paged_full_width(model, cfg, mode, expect):
    """Phase 8: the paged engine at full width on ``model`` (packed as
    ``mode``), 8 prompts of 40-400 tokens, 16 new tokens each.  The first
    pass, counted from reset to drain, builds and captures both programs:
    the wrappers launch ``expect`` 7 x layers x 2 times in each program's
    warm-up and capture (the prefill chunk's on the gather body, the
    step's on its serving body) and nothing else.  A second pass on the
    same engine is timed (TTFT, prompt tokens/s); then the profiled windows,
    the page gather alone, the dense engine's token-by-token ingest of the
    same prompts, and the captured programs against the eager ones."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import ServeConfig, make_engine

    prompts = paged_prompts(cfg.vocab_size)
    chunks = sum(-(-len(p) // PAGED["prefill_chunk"]) for p in prompts)
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    engine = paged_engine(model)
    submit_all(engine, prompts, PAGED_NEW)
    t0 = time.perf_counter()
    with graphs_kept():                  # paged_windows reads the graphs
        ticks = engine.run_until_drained()
    t1 = time.perf_counter()
    counts = read_counts()               # ... and just after
    body_counts = read_body_counts()
    first = pass_report(engine, engine.completed, t0, t1)
    if len(engine.completed) != len(prompts):
        raise AssertionError(f"{len(engine.completed)} of {len(prompts)} "
                             "requests completed")
    for r in engine.completed:
        if len(r.output) != PAGED_NEW or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: {r.output}")
    if not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError("non-finite logits")
    if (engine.captures, engine.prefill.captures) != (1, 1):
        raise AssertionError(f"captures: decode {engine.captures}, prefill "
                             f"{engine.prefill.captures}; expected 1 and 1")
    if engine.prefill.dispatches != chunks:
        raise AssertionError(f"{engine.prefill.dispatches} chunks "
                             f"dispatched, expected {chunks}")
    per = 7 * cfg.num_layers
    want = {name: 0 for name in KERNELS}
    want[expect] = 4 * per
    if counts != want:
        raise AssertionError(f"paged launch counts {counts}: expected {want}"
                             " (7 x layers x (warm-up + capture) of each of "
                             "the two programs, nothing else)")
    serving = SERVING_BODY[expect]
    if expect in body_counts and {
            b: n for b, n in body_counts[expect].items() if n} != {
            PREFILL_BODY[expect]: 2 * per, serving: 2 * per}:
        raise AssertionError(f"{expect} launches by body "
                             f"{body_counts[expect]}: expected {2 * per} "
                             f"{PREFILL_BODY[expect]} (prefill), {2 * per} "
                             f"{serving}")
    decode_ticks = int(engine._m_disp_decode.value)
    # the second pass: both programs captured
    n0 = len(engine.completed)
    submit_all(engine, prompts, PAGED_NEW, uid0=100)
    t0 = time.perf_counter()
    engine.run_until_drained()
    t1 = time.perf_counter()
    second = pass_report(engine, engine.completed[n0:], t0, t1)
    same = {r.uid - 100: r.output for r in engine.completed[n0:]} == {
        r.uid: r.output for r in engine.completed[:n0]}
    if not same:
        raise AssertionError(f"{mode}: the second pass gave other tokens")
    entry = {
        "mode": mode, "kernel": expect,
        "prompt_lengths": [len(p) for p in prompts],
        "chunks": chunks, "ticks": ticks, "decode_steps": decode_ticks,
        "launches": counts[expect],
        "launches_by_body": body_counts.get(expect),
        "captures": [engine.captures, engine.prefill.captures],
        "first_pass": first, "second_pass": second,
        "first_output": engine.completed[0].output}
    entry.update(paged_windows(engine, cfg, expect))
    entry["page_gather"] = page_gather_ms(engine, cfg)
    del engine
    torch.cuda.empty_cache()
    # the dense engine ingesting the same prompts token by token, its
    # decode step captured first by a one-token request
    dense = make_engine(model, ServeConfig(num_slots=PAGED["num_slots"],
                                           max_len=PAGED["max_len"]),
                        policy=ExecPolicy(mode="packed", backend="cuda"),
                        device=DEVICE, metrics=obs.MetricsRegistry())
    submit_all(dense, prompts[:1], 1, uid0=500)
    dense.run_until_drained()
    submit_all(dense, prompts, PAGED_NEW)
    t0 = time.perf_counter()
    dense_ticks = dense.run_until_drained()
    t1 = time.perf_counter()
    entry["dense_token_by_token"] = {
        **pass_report(dense, dense.completed[1:], t0, t1),
        "ticks": dense_ticks}
    del dense
    torch.cuda.empty_cache()
    entry["graph_vs_eager"] = graph_equals_eager_paged(
        model, cfg, prompts[:4], 8, mode)
    return entry


def paged_gates(cfg_full):
    """Phase 8g: 2 layers, float32 compute, the four serving modes, 6
    prompts of 40-112 tokens, 8 new tokens, chunks of 32 on pages of 16
    (max_len 128): the paged engine's tokens equal the dense engine's
    (token-by-token ingest; NBLK x page_size = max_len) and backend
    ``reference``'s (logits allclose, rtol 1e-3), and an arena of 13 pages
    preempts at least once and still gives the uninterrupted tokens."""
    import numpy as np
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.serve import ServeConfig, make_engine

    cfg = dataclasses.replace(cfg_full, num_layers=2, compute_dtype="float32")
    prompts = paged_prompts(cfg.vocab_size, n=6, seed=2, hi=112)
    report = {}
    for layout in ("xwT", "block"):
        for quantize in (None, "int8"):
            label = layout + (f"+{quantize}" if quantize else "")
            model = pack_tree(build_model(cfg, device=DEVICE, seed=1),
                              layout=layout, quantize=quantize)
            eng = paged_engine(model, max_len=128)
            lg, tg = drain_recording(eng, prompts, 8)
            lr, tr = drain_recording(
                paged_engine(model, backend="reference", max_len=128),
                prompts, 8)
            if tg != tr:
                raise AssertionError(f"{label}: paged cuda and reference "
                                     f"tokens differ: {tg} vs {tr}")
            worst = 0.0
            for (kind, *_, a), (*_, b) in zip(lg, lr):
                a, b = a[..., :cfg.vocab_size], b[..., :cfg.vocab_size]
                if not np.allclose(a, b, rtol=1e-3, atol=1e-3):
                    raise AssertionError(f"{label} {kind}: logits differ "
                                         f"from the reference's, max abs "
                                         f"{np.abs(a - b).max()}")
                worst = max(worst, float(np.abs(a - b).max()))
            dense = make_engine(model, ServeConfig(num_slots=4, max_len=128),
                                policy=ExecPolicy(mode="packed",
                                                  backend="cuda"),
                                device=DEVICE, metrics=obs.MetricsRegistry())
            submit_all(dense, prompts, 8)
            dense.run_until_drained()
            td = {r.uid: list(r.output) for r in dense.completed}
            if td != tg:
                raise AssertionError(f"{label}: paged and dense tokens "
                                     f"differ: {tg} vs {td}")
            small = paged_engine(model, max_len=128, num_pages=13)
            _, tp = drain_recording(small, prompts, 8)
            preempts = small.metrics.counter("serve_preempt_total").value
            if preempts < 1 or tp != tg:
                raise AssertionError(f"{label}: {preempts} preemptions, "
                                     f"tokens {tp} vs {tg}")
            report[label] = {
                "streams": len(tg), "paged_equals_dense": True,
                "cuda_equals_reference": True,
                "max_abs_logit_diff_vs_reference": worst,
                "preemptions": preempts, "preempted_tokens_equal": True,
                "captures": [eng.captures, eng.prefill.captures]}
    return report


def paged_cli(cfg):
    """Phase 6p: ``launch.serve --full --packed --paged`` as a user runs
    it, replaying the committed tiny trace with priorities on an arena of
    16 pages of 8 tokens (it preempts), with the SLO report: every request
    completes, at least one preemption, both programs dispatched."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch.serve import main as serve_main

    trace = os.path.join(HERE, "benchmarks", "traces", "tiny_trace.jsonl")
    out_dir = tempfile.mkdtemp(prefix="chip_smoke_paged_")
    metrics_out = os.path.join(out_dir, "metrics.json")
    prev = obs.default_registry()
    obs.set_default_registry(obs.MetricsRegistry())
    try:
        serve_main(["--arch", cfg.name, "--full", "--packed", "--paged",
                    "--trace-replay", trace, "--max-len", "96",
                    "--page-size", "8", "--max-pages", "16",
                    "--scheduler", "priority", "--slo-report",
                    "--metrics-out", metrics_out])
        with open(metrics_out) as f:
            snap = json.load(f)
    finally:
        obs.set_default_registry(prev)
        shutil.rmtree(out_dir, ignore_errors=True)
    counters = {(c["name"], tuple(sorted(c["labels"].items()))): c["value"]
                for c in snap["counters"]}
    got = {"completed": counters[("serve_requests_completed_total", ())],
           "preemptions": counters[("serve_preempt_total", ())],
           "prefill_dispatches": counters[("serve_step_dispatch_total",
                                           (("program", "prefill"),))],
           "decode_dispatches": counters[("serve_step_dispatch_total",
                                          (("program", "decode"),))]}
    if got["completed"] != 12 or got["preemptions"] < 1 \
            or got["prefill_dispatches"] < 12 or got["decode_dispatches"] < 1:
        raise AssertionError(f"launch.serve --paged: {got}")
    return got


# ---------------------------------------------------------------------------
# phase 9: tune — the autotuner on the card, serving under backend "auto"
# ---------------------------------------------------------------------------

# candidates measured per problem, and CUDA-graph replays per candidate
TUNE_KW = dict(max_measure=5, warmup=1, iters=3)
# phase 9 tunes the projections of full-width stablelm_3b and serves them
# under ``auto`` on a model of phase 4's seed cut to this many of its 32
# layers (the tuned problems are the same at any depth; the script's time
# limit sets the depth)
TUNE_LAYERS = 2
TUNE_SWEEP_KW = dict(max_measure=16, warmup=1, iters=7)
# a prefill chunk's logits under the tuned params against the default
# params' (relative L2): bfloat16 through the layers, the projections' sums
# in another order; a wrong kernel setting gives an error of order 1
CHUNK_LOGITS_RTOL = 5e-2
PRUNED = ("pruned_geometry", "pruned_smem", "pruned_rank")


def tuned_rows(results, label):
    """One row per tuned problem of ``autotune_packed_tree``: the body, the
    default's and the selected candidate's device us (the tuner's own
    table), the tuned params, and the candidates by status.  Raises unless
    every problem selected ``cuda`` at a time no longer than its default's
    and every candidate the pruner kept was measured or refused."""
    from collections import Counter
    from repro_torch import tune

    rows = []
    for key, res in results.items():
        default = res.default
        statuses = Counter(c.status for c in res.candidates)
        kept = [c for c in res.candidates if c.status not in PRUNED]
        if res.best.backend != "cuda":
            raise AssertionError(f"{label} {key}: selected "
                                 f"{res.best.backend}, expected cuda")
        if res.best.measured_us > default.measured_s * 1e6:
            raise AssertionError(f"{label} {key}: tuned {res.best} slower "
                                 f"than the default {default.row()}")
        bad = [c.row() for c in kept if c.status not in ("measured",
                                                          "refused")]
        if bad:
            raise AssertionError(f"{label} {key}: candidates neither "
                                 f"measured nor refused: {bad}")
        rows.append({"key": key, "body": tune.cuda_body(res.problem),
                     "default_us": default.measured_s * 1e6,
                     "tuned_us": res.best.measured_us,
                     "tuned_params": res.best.params,
                     "default_over_tuned": default.measured_s * 1e6
                     / res.best.measured_us,
                     "candidates": dict(statuses),
                     "refused": [c.row() for c in kept
                                 if c.status == "refused"]})
    return rows


def check_selected(model, results, batch, label):
    """Each tuned problem's selected params, launched through the registered
    ``cuda`` variant (what ``backend="auto"`` dispatches) on one of the
    model's own packed weights with ``batch`` random rows, against the plain
    version on the same operands at phase 3's tolerance.  Returns the max
    abs error by problem key."""
    import torch
    from repro_torch import tune
    from repro_torch.core.sparsity import LAYOUT_BLOCK, PackedWeight

    gen = torch.Generator(device=DEVICE).manual_seed(batch)
    dtype = getattr(torch, model.cfg.compute_dtype)
    err = {}
    for pw in (mod for mod in model.modules()
               if isinstance(mod, PackedWeight)):
        o, k = pw.dense_shape
        x = torch.randn((batch, k), generator=gen, device=DEVICE).to(dtype)
        if pw.layout == LAYOUT_BLOCK:
            p = tune.Problem.for_xwT_block(x.shape, pw, dtype, x.device)
            args = (x, pw.values, pw.indices, pw.active_groups)
        else:
            p = tune.Problem.for_xwT(x.shape, (o, k), pw.cfg, dtype,
                                     x.device, quantized=pw.qdtype is not None,
                                     duplicates=pw.has_duplicates)
            args = (x, pw.values, pw.indices)
        args += (pw.scales,) if pw.qdtype is not None else ()
        key = tune.problem_key(p)
        if key in err:
            continue
        best = results[key].best
        got = tune.get_variant(p.op, best.backend).call(
            *args, pw.cfg, (o, k), duplicates=pw.has_duplicates,
            **best.params)
        want = tune.get_variant(p.op, "reference").call(*args, pw.cfg, (o, k))
        torch.cuda.synchronize()
        torch.testing.assert_close(
            got, want, **TOL[model.cfg.compute_dtype],
            msg=lambda m: f"{label} {key} tuned {best.params}: {m}")
        err[key] = float((got - want).abs().max())
    if set(err) != set(results):
        raise AssertionError(f"{label}: checked {sorted(err)}, tuned "
                             f"{sorted(results)}")
    return err


def swapped_registry():
    """A fresh default metrics registry (the tuning cache's and the
    dispatch counters' home) and the one it replaced."""
    from repro_torch import obs
    prev = obs.default_registry()
    reg = obs.MetricsRegistry()
    obs.set_default_registry(reg)
    return reg, prev


def cache_counts(reg, width):
    """Hits and misses of the tuning cache in ``reg`` for problems of
    ``width`` activation rows (from the ``tune_cache_resolve`` events),
    and the dispatch counter by (op, backend)."""
    outcome = {"hit": 0, "miss": 0}
    for e in reg.trace.named("tune_cache_resolve"):
        if f"|r{width}|" in e.get("key", ""):
            outcome[e["outcome"]] += 1
    snap = json.loads(json.dumps(reg.snapshot()))
    dispatch = {f"{c['labels']['op']}/{c['labels']['backend']}": c["value"]
                for c in snap["counters"]
                if c["name"] == "kernel_dispatch_total"}
    return outcome, dispatch


def serve_auto(model, cfg, *, layout, quantize, expect):
    """Phase 9's dense serve under ``--backend auto`` (tuned at 4 rows):
    every decode-width lookup hits the cache, the wrappers launch the
    mode's kernel 7 x layers x (warm-up + capture) times on its serving
    body, the dispatch counter carries the resolved backend ``cuda``, and a
    profiled window shows 7 x layers launches per replay on that body."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.launch.serve import run_serve
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    reg, prev = swapped_registry()
    try:
        torch.cuda.synchronize()
        reset_counts()
        with graphs_kept():              # profiled_replays reads the graph
            engine = run_serve(model, cfg.vocab_size, packed=True,
                               layout=layout, quantize=quantize,
                               backend="auto", requests=4, slots=4,
                               max_new=8, max_len=64, seed=0, device=DEVICE,
                               metrics=obs.MetricsRegistry())
        counts, body_counts = read_counts(), read_body_counts()
        outcome, dispatch = cache_counts(reg, 4)
    finally:
        obs.set_default_registry(prev)
    per = 7 * cfg.num_layers * (CAPTURE_WARMUP + 1)
    want = {name: 0 for name in KERNELS}
    want[expect] = per
    body = SERVING_BODY[expect]
    if counts != want or (expect in body_counts
                          and body_counts[expect][body] != per):
        raise AssertionError(f"auto: launch counts {counts}, by body "
                             f"{body_counts}: expected {want}, all on {body}")
    if outcome["miss"] or not outcome["hit"]:
        raise AssertionError(f"auto at decode width: cache {outcome}, "
                             "expected hits only")
    if set(k.split("/")[1] for k in dispatch) != {"cuda"} \
            or sum(dispatch.values()) != per:
        raise AssertionError(f"auto: dispatches {dispatch}, expected {per} "
                             "on the resolved backend cuda")
    if not all(len(r.output) == 8 for r in engine.completed) or \
            not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError("auto: incomplete requests or non-finite "
                             "logits")
    return {"launches": counts[expect], "cache": outcome,
            "dispatch": dispatch,
            "device_launches_per_replay": profiled_replays(engine, cfg,
                                                           expect)}


def paged_auto(model, cfg, mode, expect):
    """Phase 9's paged serve under ``--backend auto``: 4 prompts, no cache
    miss at decode width (the chunk's 32-row problems miss once each and
    take the heuristic, the default params), each program captured once
    with the wrappers' counts of phase 8, and both programs' logits
    bit-equal to the eager programs' under ``auto``.  Returns the report
    and the engine (its chunk program runs the default params)."""
    import torch

    from repro_torch import obs

    prompts = paged_prompts(cfg.vocab_size, n=4, seed=13, hi=160)
    per = 7 * cfg.num_layers
    reg, prev = swapped_registry()
    try:
        torch.cuda.synchronize()
        reset_counts()
        engine = paged_engine(model, backend="auto")
        submit_all(engine, prompts, 8)
        engine.run_until_drained()
        counts, body_counts = read_counts(), read_body_counts()
        decode, _ = cache_counts(reg, 4)
        chunk, dispatch = cache_counts(reg, PAGED["prefill_chunk"])
    finally:
        obs.set_default_registry(prev)
    want = {name: 0 for name in KERNELS}
    want[expect] = 4 * per
    serving = SERVING_BODY[expect]
    if counts != want or (expect in body_counts and {
            b: n for b, n in body_counts[expect].items() if n}
            != {PREFILL_BODY[expect]: 2 * per, serving: 2 * per}):
        raise AssertionError(f"paged auto: launch counts {counts}, by body "
                             f"{body_counts}: expected {want}")
    if decode["miss"] or not decode["hit"]:
        raise AssertionError(f"paged auto at decode width: cache {decode}, "
                             "expected hits only")
    if set(k.split("/")[1] for k in dispatch) != {"cuda"}:
        raise AssertionError(f"paged auto: dispatches {dispatch}")
    return {"launches": counts[expect], "cache_decode_width": decode,
            "cache_chunk_width": chunk, "dispatch": dispatch,
            "graph_vs_eager": graph_equals_eager_paged(
                model, cfg, prompts[:2], 6, mode, backend="auto")}, engine


def chunk_turns(model, cfg, expect, default):
    """A prefill chunk's device time under the default params and under the
    tuned ones, in turns (default, tuned, tuned, default): ``default`` is
    the paged engine of :func:`paged_auto` (its chunk program captured
    before tuning at chunk width, on the heuristic), the tuned one a fresh
    engine under ``auto`` after it.  Each is warmed (both programs
    captured) and given 4 prompts of 129 tokens; each turn profiles one
    tick of 4 non-final chunks, which must launch the mode's kernel 7 x
    layers times a chunk on the gather body and nothing else; then one
    decode tick of each, 7 x layers launches on the serving body (the
    graphs' nodes and the profiler's records, :func:`replay_window`: run
    it under :func:`graphs_kept`, with ``default`` captured under it).  Last,
    both serve 2 fresh prompts of 129 tokens: the logits of each request's
    last chunk under the tuned params must lie within
    ``CHUNK_LOGITS_RTOL`` (relative L2) of the default params' — the
    tunables change only the order of a reduction, so a wrong setting shows
    as an error of order 1.  Returns the device ms of each turn and that
    comparison (with each turn's ``demm_records_share``)."""
    import numpy as np

    engines = {"default": default,
               "tuned": paged_engine(model, backend="auto")}
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab_size, 129, dtype=np.int32)
               for _ in range(4)]
    submit_all(engines["tuned"], prompts[:1], 1, uid0=900)
    engines["tuned"].run_until_drained()     # captures both programs
    for engine in engines.values():
        submit_all(engine, prompts, 3, uid0=1000)
        engine.step()                        # the first chunk of each
    per = 7 * cfg.num_layers
    ms, share = {"default": [], "tuned": []}, {"default": [], "tuned": []}
    for name in ("default", "tuned", "tuned", "default"):
        window = replay_window(engines[name], 1, (4, 0),
                               engines[name].prefill._graph,
                               {(expect, PREFILL_BODY[expect]): per},
                               f"chunk window ({name})")
        ms[name].append(window["device_ms"] / 4)
        share[name].append(window["demm_records_share"])
    for name, engine in engines.items():
        while not engine._decode_mask.all():
            engine.step()
        replay_window(engine, 1, (0, 1), engine._graph,
                      {(expect, SERVING_BODY[expect]): per},
                      f"decode window ({name})")
        engine.run_until_drained()
    fresh = [rng.integers(0, cfg.vocab_size, 129, dtype=np.int32)
             for _ in range(2)]
    rows = {name: [e for e in drain_recording(engine, fresh, 2, uid0=2000)[0]
                   if e[0] == "prefill"]
            for name, engine in engines.items()}
    if [e[1:3] for e in rows["tuned"]] != [e[1:3] for e in rows["default"]] \
            or len(rows["tuned"]) != 2:
        raise AssertionError(f"chunk logits: rows {rows}")
    # the true vocabulary only: the padding columns hold -1e30
    pairs = [(a[-1][:cfg.vocab_size].astype(np.float64),
              b[-1][:cfg.vocab_size].astype(np.float64))
             for a, b in zip(rows["tuned"], rows["default"])]
    rel = [float(np.linalg.norm(a - b) / np.linalg.norm(b))
           for a, b in pairs]
    if not max(rel) <= CHUNK_LOGITS_RTOL:
        raise AssertionError(f"chunk logits under the tuned params differ "
                             f"from the default params' by {rel} (relative "
                             f"L2), more than {CHUNK_LOGITS_RTOL}")
    return ms, {"rel_l2": rel,
                "bit_equal": [bool(np.array_equal(a, b)) for a, b in pairs],
                "demm_records_share": share}


def tune_full_width(model, cfg, mode, expect, *, layout, quantize, kw):
    """Phase 9 in one mode on a packed model of phase 4's seed at full
    width and ``TUNE_LAYERS`` layers (``cfg``): tune at decode
    width (3 problems), serve under ``auto`` on the dense and the paged
    engine, then tune at chunk width (the gather bodies) and time a chunk
    under the tuned and the default params, in turns."""
    import torch
    from repro_torch import tune

    t0 = time.time()
    res4 = tune.autotune_packed_tree(model, 4, **kw)
    if len(res4) != 3:
        raise AssertionError(f"{mode}: {len(res4)} problems at Bx = 4, "
                             "expected 3")
    entry = {"mode": mode, "kernel": expect,
             "bx4": tuned_rows(res4, mode),
             "tune_s_bx4": time.time() - t0,
             "bx4_vs_plain": check_selected(model, res4, 4, mode)}
    entry["dense_auto"] = serve_auto(model, cfg, layout=layout,
                                     quantize=quantize, expect=expect)
    entry["dense_graph_vs_eager"] = graph_vs_eager(
        model, cfg, mode, backend="auto", slots=4)[0]
    with graphs_kept():                  # chunk_turns reads the graphs
        entry["paged_auto"], default = paged_auto(model, cfg, mode, expect)
    t0 = time.time()
    res32 = tune.autotune_packed_tree(model, PAGED["prefill_chunk"], **kw)
    entry["bx32"] = tuned_rows(res32, mode)
    entry["tune_s_bx32"] = time.time() - t0
    entry["bx32_vs_plain"] = check_selected(model, res32,
                                            PAGED["prefill_chunk"], mode)
    if {r["body"] for r in entry["bx32"]} != {
            PREFILL_BODY[expect]}:
        raise AssertionError(f"{mode}: Bx = 32 bodies "
                             f"{[r['body'] for r in entry['bx32']]}")
    with graphs_kept():
        entry["chunk_device_ms"], entry["chunk_logits_tuned_vs_default"] = \
            chunk_turns(model, cfg, expect, default)
    del default
    torch.cuda.empty_cache()
    return entry


def tune_spmm(gen, kw):
    """Phase 9, K5 off the serving path: ``autotune_spmm`` on the three
    projection shapes with B (K, 4) and (K, 256) bfloat16 — the gather body
    at 4 columns, the tiled body at 256 — each selecting ``cuda`` at no more
    than its default's time; the measure-only ``block_spmm`` (host repack,
    then K2) is measured beside it and never selected."""
    import torch
    from repro_torch import tune
    from repro_torch.core.sparsity import SparsityConfig

    rows = []
    for label, o, k, n, m in MAIN_SHAPES:
        vals, idx = make_packed(o, k, n, m, gen)
        for cd in (4, 256):
            b = torch.randn((k, cd), generator=gen,
                            device=gen.device).to(torch.bfloat16)
            res = tune.autotune_spmm(vals, idx, b, SparsityConfig(n, m),
                                     (o, k), duplicates=False, **kw)
            key = tune.problem_key(res.problem)
            row = tuned_rows({key: res}, f"spmm {label} Cd={cd}")[0]
            row["block_spmm_us"] = {
                str(c.params): c.measured_s * 1e6 for c in res.candidates
                if c.backend == "block_spmm" and c.status == "measured"}
            if not row["block_spmm_us"]:
                raise AssertionError(f"spmm {label} Cd={cd}: the "
                                     "measure-only block_spmm was not "
                                     "measured")
            rows.append(row)
        del vals, idx
    torch.cuda.empty_cache()
    return rows


# ---------------------------------------------------------------------------
# phase 10: self-speculative decoding (repro_torch.spec) on both engines
# ---------------------------------------------------------------------------

SPEC_SPARSITY, SPEC_DRAFT, SPEC_GAMMA = "8:16", "6:16", 4
# the full-width model of the checked and timed passes, cut to this many of
# stablelm_3b's 32 layers (the script's time limit sets the depth)
SPEC_LAYERS = 2
# the checked passes: prompts of 3-7 tokens and max_len 16, so that the
# windows shrink near max_len (widths below γ + 1 run too)
SPEC_NEW, SPEC_MAX_LEN = 10, 16
SPEC_SAMPLED = dict(temperature=0.8, top_k=8, seed=3)
EAGER_WINDOWS = 2
# the timed pass: the paged engine at the main path's sizes (phase 8's
# engine and prompts, PAGED_NEW new tokens each); a warm-up pass of short
# prompts captures every program first
SPEC_WARM_PROMPT = 40


def spec_model(cfg_full, layout, quantize=None, **over):
    """The model phase 10 serves: stablelm_3b at 8:16 (``--sparsity
    8:16``), random weights from seed 0, packed in ``layout`` (then
    quantized), tier-sorted once so that every engine below reads one pair
    order."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.spec import parse_tier, tier_sort_tree

    cfg = dataclasses.replace(cfg_full, sparsity=SparsityConfig(
        *parse_tier(SPEC_SPARSITY), 1), **over)
    model = pack_tree(build_model(cfg, device=DEVICE, seed=0), layout=layout,
                      quantize=quantize)
    tier_sort_tree(model)
    torch.cuda.synchronize()
    return cfg, model


def spec_prompts(vocab, n=4, seed=21):
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(3, 8)), dtype=np.int32)
            for _ in range(n)]


def spec_engine(model, paged, spec, backend="cuda", eager=False,
                sampled=False, max_len=SPEC_MAX_LEN):
    """A dense or paged engine of 4 slots on ``model``, with ``spec`` (the
    draft 6:16, γ = 4) or without; ``eager`` runs every program eagerly.
    The paged engine has phase 8's pages and chunks."""
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import ServeConfig, ServeEngine
    from repro_torch.spec import SpecConfig

    kw = SPEC_SAMPLED if sampled else {}
    common = dict(policy=ExecPolicy(mode="packed", backend=backend),
                  device=DEVICE, metrics=obs.MetricsRegistry(),
                  spec=SpecConfig(SPEC_DRAFT, SPEC_GAMMA) if spec else None,
                  _eager=eager)
    if paged:
        return PagedServeEngine(model, PagedServeConfig(
            **{**PAGED, "max_len": max_len}, **kw), **common)
    return ServeEngine(model, ServeConfig(num_slots=4, max_len=max_len,
                                          **kw), **common)


def spec_drive(engine, prompts, uid0=0, records=None, max_new=SPEC_NEW):
    """Serve ``prompts`` to the drain (or until ``records`` ticks are
    recorded), recording every window's draft and verify logits of its
    lanes (or, without spec, every tick's logits).  Returns (tokens by uid
    of the completed requests, the records, wall seconds)."""
    import time as _time
    from repro_torch.serve import Request

    n0 = len(engine.completed)
    for i, p in enumerate(prompts):
        engine.submit(Request(uid=uid0 + i, prompt=p,
                              max_new_tokens=max_new))
    logs = []
    t0 = _time.perf_counter()
    while _busy(engine) and (records is None or len(logs) < records):
        spec = getattr(engine, "_spec", None) is not None
        if spec:
            engine.last_window_logits = None
        before = engine.last_logits
        engine.step()
        if spec and engine.last_window_logits is not None:
            w = engine.last_window_logits
            logs.append(("window", w["draft"][:, w["lanes"]],
                         w["verify"][w["lanes"]]))
        elif engine.last_logits is not None and engine.last_logits is not \
                before:
            logs.append(("step", engine.last_logits))
    dt = _time.perf_counter() - t0
    done = engine.completed[n0:]
    return {r.uid - uid0: list(r.output) for r in done}, logs, dt


def _busy(engine):
    if any(r is not None for r in engine.active):
        return True
    queue = getattr(engine, "queue", None)
    return len(queue if queue is not None else engine.sched) > 0


def same_logs(a, b, what, exact=True, tol=None):
    """Two recordings of one token stream: the same kinds of ticks with
    bit-equal (``exact``) or allclose logits; returns the largest
    difference."""
    import numpy as np
    if [x[0] for x in a] != [x[0] for x in b]:
        raise AssertionError(f"{what}: the ticks differ")
    worst = 0.0
    for t, (x, y) in enumerate(zip(a, b)):
        for u, v in zip(x[1:], y[1:]):
            if exact and not np.array_equal(u, v):
                raise AssertionError(
                    f"{what} tick {t}: logits differ, max abs "
                    f"{np.abs(u - v).max()}")
            if not exact and not np.allclose(u, v, **tol):
                raise AssertionError(
                    f"{what} tick {t}: logits not allclose, max abs "
                    f"{np.abs(u - v).max()}")
            worst = max(worst, float(np.abs(u - v).max()))
    return worst


def graph_device_ms(graph, replays=5, windows=3):
    """Device time of one replay of ``graph``: CUDA events around
    ``replays`` replays queued behind one more, so that the device is
    still busy while the host submits them (a graph of thousands of
    nodes), divided by ``replays``; the median of ``windows`` such
    windows."""
    import torch
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(windows):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        graph.replay()
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / replays)
    return statistics.median(times)


@contextlib.contextmanager
def graphs_kept():
    """Every CUDA graph made inside keeps its node graph (``keep_graph``:
    instantiated at its first replay), so that :func:`graph_kernel_counts`
    can read it."""
    import torch
    made = torch.cuda.CUDAGraph

    def kept():
        return made(keep_graph=True)

    torch.cuda.CUDAGraph = kept
    try:
        yield
    finally:
        torch.cuda.CUDAGraph = made


def graph_kernel_counts(graph) -> dict:
    """DeMM kernels by (kernel, body) among the nodes of ``graph``
    (captured under :func:`graphs_kept`): what each of its replays
    launches on the device, read from the graph itself through its DOT
    dump (``cudaGraphDebugDotPrint``, which names the function of every
    kernel node), so that no profiler record can go missing.  Returns
    (counts, the number of kernel nodes)."""
    import re
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "graph.dot")
        graph.debug_dump(path)
        with open(path) as f:
            dot = f.read()
    # a kernel node's label: {KERNEL | {ID | <id> (topoId: <n>) |
    # <function>\<\<\<grid,block,smem\>\>\>} | ...}
    names = re.findall(r"\{ID \| [^|]*\| ([^|}]*?)\\<\\<\\<", dot)
    counts, kernels = {}, len(names)
    for name in names:
        kb = device_kernel_of(name)
        if kb is not None:
            counts[kb] = counts.get(kb, 0) + 1
    return counts, kernels


def graph_launches(graph, expect, want_launches, what):
    """``graph`` launches exactly ``want_launches`` kernels of ``expect``
    on its serving body and no other DeMM kernel, each replay."""
    got, kernels = graph_kernel_counts(graph)
    want = {(expect, SERVING_BODY[expect]): want_launches}
    if got != want:
        raise AssertionError(f"{what}: the graph's nodes launch {got} "
                             f"({kernels} kernel nodes), expected {want}")
    return {"demm": want_launches, "kernel_nodes": kernels}


def spec_counted(engine, cfg, expect, paged):
    """The spec engine's counted pass (from reset to drain): one capture of
    the draft step, one of the verify program for each width W that ran,
    the plain step captured only if it ran (and, on the paged engine, the
    prefill chunk once); the wrappers launched ``expect`` 7 x layers x 2
    (warm-up + capture) times per captured decode step, on its serving body
    (the chunk's on the gather body), nothing else."""
    per = 7 * cfg.num_layers
    windows = dict(engine.spec_windows)
    widths = sorted(w for w in windows if w > 1)
    plain = windows.get(1, 0) > 0
    caps = engine.spec_captures
    want_caps = {"draft": 1 if widths else 0,
                 "verify": {w: 1 for w in widths}}
    prefill_caps = engine.prefill.captures if paged else 1
    if caps != want_caps or engine.captures != int(plain) or \
            prefill_caps != 1:
        raise AssertionError(f"captures {caps}, plain step "
                             f"{engine.captures}; windows {windows}: expected "
                             f"{want_caps} and {int(plain)}")
    steps = (1 if widths else 0) + sum(widths) + int(plain)
    counts, bodies = read_counts(), read_body_counts()
    want = {name: 0 for name in KERNELS}
    want[expect] = 2 * per * steps + (2 * per if paged else 0)
    if counts != want:
        raise AssertionError(f"spec launch counts {counts}, windows "
                             f"{windows}: expected {want}")
    if expect in bodies:
        serving = SERVING_BODY[expect]
        want_b = {serving: 2 * per * steps}
        if paged:
            want_b[PREFILL_BODY[expect]] = 2 * per
        got_b = {k: v for k, v in bodies[expect].items() if v}
        if got_b != want_b:
            raise AssertionError(f"{expect} launches by body {got_b}: "
                                 f"expected {want_b}")
    return {"windows": {str(w): n for w, n in sorted(windows.items())},
            "captures": {"draft": caps["draft"],
                         "verify": {str(w): n for w, n
                                    in caps["verify"].items()},
                         "plain": engine.captures},
            "launches": counts[expect]}


def spec_rates(engine):
    sm = engine._spec_metrics
    return {"drafted": int(sm.drafted.value),
            "accepted": int(sm.accepted.value),
            "committed": sm._committed_total,
            "acceptance_rate": sm.accepted.value / max(sm.drafted.value, 1),
            "verify_dispatches": sm._verify_dispatches,
            "tokens_per_verify": (sm._committed_total
                                  / max(sm._verify_dispatches, 1))}


def spec_full_width(cfg, model, mode, expect):
    """Phase 10 in one mode on the 8:16 model, dense and paged engines, at
    max_len 16: spec streams equal to the non-spec streams (greedy; then
    sampled, the same captured engines given the sampler of temperature
    0.8, top-k 8), the counted pass, the launches of each graph read from
    its nodes (224 a draft replay, 224 x W a verify replay), and the draft
    and verify graphs (and, dense, the full step's) bit-equal to their
    eager programs over the first windows.  Then :func:`spec_timed`.
    ``seconds``: where the phase's time went."""
    import torch
    from repro_torch.spec import ReplaySafeSampler
    prompts = spec_prompts(cfg.vocab_size)
    out = {"mode": mode, "kernel": expect}
    per = 7 * cfg.num_layers
    for paged in (False, True):
        name = "paged" if paged else "dense"
        clock = [time.time()]
        seconds = {}

        def lap(what):
            seconds[what] = time.time() - clock[0]
            clock[0] = time.time()

        base = spec_engine(model, paged, False)
        base_tok, base_logs, _ = spec_drive(base, prompts)
        torch.cuda.synchronize()
        reset_counts()                   # just before the spec path ...
        spec = spec_engine(model, paged, True)
        with graphs_kept():
            tok, logs, _ = spec_drive(spec, prompts)
        torch.cuda.synchronize()
        entry = spec_counted(spec, cfg, expect, paged)   # ... just after
        if tok != base_tok:
            raise AssertionError(f"{mode} {name}: spec tokens {tok} differ "
                                 f"from the plain engine's {base_tok}")
        entry.update(spec_rates(spec))
        graphs = spec._spec_graphs
        entry["graph_launches"] = {
            "draft": graph_launches(graphs["draft"][0], expect, per,
                                    f"{mode} {name} draft"),
            **{f"verify_W{w}": graph_launches(graphs[w][0], expect, per * w,
                                              f"{mode} {name} verify W={w}")
               for w in sorted(k for k in graphs if k != "draft")}}
        lap("first_pass_with_captures")
        # sampled: the same engines, the sampler swapped (host side only)
        for eng in (base, spec):
            eng.sampler = ReplaySafeSampler(**SPEC_SAMPLED)
        s_base, _, _ = spec_drive(base, prompts, uid0=200)
        s_spec, _, _ = spec_drive(spec, prompts, uid0=200)
        if s_base != s_spec:
            raise AssertionError(f"{mode} {name}: sampled spec tokens differ")
        entry["sampled_tokens_equal"] = entry["greedy_tokens_equal"] = True
        lap("sampled_passes")
        # the eager programs on the same stream: bit-equal logits over the
        # first EAGER_WINDOWS windows (ticks)
        eager = spec_engine(model, paged, True, eager=True)
        _, elogs, _ = spec_drive(eager, prompts, records=EAGER_WINDOWS)
        same_logs(logs[:EAGER_WINDOWS], elogs,
                  f"{mode} {name} draft/verify graph vs eager")
        entry["draft_verify_logits_bit_equal"] = len(elogs)
        if not paged:
            ebase = spec_engine(model, paged, False, eager=True)
            _, blogs, _ = spec_drive(ebase, prompts,
                                     records=2 * EAGER_WINDOWS)
            same_logs(base_logs[:2 * EAGER_WINDOWS], blogs,
                      f"{mode} full step graph vs eager")
            entry["full_step_logits_bit_equal"] = len(blogs)
            del ebase
        lap("eager_passes")
        entry["seconds"] = seconds
        out[name] = entry
        del base, spec, eager
        torch.cuda.empty_cache()
    t0 = time.time()
    out["timed"] = spec_timed(cfg, model, mode)
    out["timed"]["seconds"] = time.time() - t0
    return out


def spec_timed(cfg, model, mode):
    """The paged engine at the main path's sizes (phase 8's: max_len 512,
    pages of 16, chunks of 32, its 8 prompts, PAGED_NEW new tokens each,
    the model's compute dtype), with and without spec: after a warm-up
    pass that captures every program, one timed pass each (host clock,
    the spec tokens equal to the plain tokens), acceptance and committed
    tokens per verify over it, and the device time of a replay of the full
    step, the draft step and each verify width used (CUDA events)."""
    import numpy as np
    import torch
    prompts = paged_prompts(cfg.vocab_size)
    warm = [np.resize(p, SPEC_WARM_PROMPT).astype(np.int32)
            for p in prompts[:4]]
    max_len = PAGED["max_len"]
    base = spec_engine(model, True, False, max_len=max_len)
    spec = spec_engine(model, True, True, max_len=max_len)
    passes = {}
    for eng, name in ((base, "plain"), (spec, "spec")):
        spec_drive(eng, warm, uid0=500, max_new=2 * SPEC_GAMMA + 2)
        torch.cuda.synchronize()
        if name == "spec":
            before, windows0 = spec_rates(eng), dict(eng.spec_windows)
            captured = json.dumps(eng.spec_captures)
        passes[name] = spec_drive(eng, prompts, max_new=PAGED_NEW)
        torch.cuda.synchronize()
    if json.dumps(spec.spec_captures) != captured or base.captures != 1:
        raise AssertionError(f"{mode} timed: the timed pass captured a "
                             f"program ({spec.spec_captures}, plain step "
                             f"{base.captures})")
    tok, _, dt = passes["spec"]
    if tok != passes["plain"][0]:
        raise AssertionError(f"{mode} timed: spec tokens differ from the "
                             "plain engine's")
    after = spec_rates(spec)
    drafted, accepted, committed, verifies = (
        after[k] - before[k] for k in ("drafted", "accepted", "committed",
                                       "verify_dispatches"))
    n_tok = sum(len(v) for v in tok.values())
    graphs = spec._spec_graphs
    out = {"engine": "paged", "max_len": max_len,
           "prompt_tokens": [len(p) for p in prompts],
           "new_tokens": n_tok,
           "windows": {str(w): n - windows0.get(w, 0)
                       for w, n in sorted(spec.spec_windows.items())},
           "acceptance_rate": accepted / max(drafted, 1),
           "tokens_per_verify": committed / max(verifies, 1),
           "drain_s": {"spec": dt, "plain": passes["plain"][2]},
           "tokens_per_s": {"spec": n_tok / dt,
                            "plain": n_tok / passes["plain"][2]},
           "device_ms": {
               "full_step": graph_device_ms(base._graph),
               "draft": graph_device_ms(graphs["draft"][0]),
               **{f"verify_W{w}": graph_device_ms(graphs[w][0])
                  for w in sorted(k for k in graphs if k != "draft")}}}
    del base, spec
    torch.cuda.empty_cache()
    return out


def spec_gates(cfg_full):
    """Phase 10g: 2 layers, float32, the four modes, both engines: the spec
    engine on backend ``cuda`` against backend ``reference`` (tokens equal,
    the windows' logits allclose at rtol 1e-3) and against the plain
    engine's tokens."""
    import torch
    report = {}
    for layout in ("xwT", "block"):
        for quantize in (None, "int8"):
            mode = f"--layout {layout}" + (" --quantize int8" if quantize
                                           else "")
            cfg, model = spec_model(cfg_full, layout, quantize, num_layers=2,
                                    compute_dtype="float32")
            prompts = spec_prompts(cfg.vocab_size)
            r = {}
            for paged in (False, True):
                name = "paged" if paged else "dense"
                plain, _, _ = spec_drive(spec_engine(model, paged, False),
                                         prompts)
                tc, lc, _ = spec_drive(spec_engine(model, paged, True),
                                       prompts)
                tr, lr, _ = spec_drive(spec_engine(model, paged, True,
                                                   backend="reference"),
                                       prompts)
                if not tc == tr == plain:
                    raise AssertionError(f"{mode} {name}: tokens differ "
                                         f"(cuda {tc}, reference {tr}, plain "
                                         f"{plain})")
                r[name] = {"tokens_equal": True,
                           "max_abs_logit_diff": same_logs(
                               lc, lr, f"{mode} {name} cuda vs reference",
                               exact=False, tol=dict(rtol=1e-3, atol=1e-3))}
            report[mode] = r
            del model
            torch.cuda.empty_cache()
    return report


def spec_cli(cfg, paged):
    """``launch.serve --full --packed --sparsity 8:16 --spec-draft 6:16
    --spec-gamma 4`` (``--paged``) as a user runs it: every request
    completes and the draft proposed tokens that the verifier accepted."""
    import shutil
    import tempfile
    from repro_torch import obs
    from repro_torch.launch.serve import main as serve_main

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_spec_")
    metrics_out = os.path.join(out_dir, "metrics.json")
    prev = obs.default_registry()
    obs.set_default_registry(obs.MetricsRegistry())
    try:
        serve_main(["--arch", cfg.name, "--full", "--packed", "--sparsity",
                    SPEC_SPARSITY, "--spec-draft", SPEC_DRAFT, "--spec-gamma",
                    str(SPEC_GAMMA), "--max-len", "64", "--requests", "4",
                    "--max-new", "8",
                    "--metrics-out", metrics_out]
                   + (["--paged"] if paged else []))
        with open(metrics_out) as f:
            snap = json.load(f)
    finally:
        obs.set_default_registry(prev)
        shutil.rmtree(out_dir, ignore_errors=True)
    counters = {c["name"]: c["value"] for c in snap["counters"]
                if not c["labels"]}
    got = {k: counters.get(k) for k in (
        "serve_requests_completed_total", "spec_draft_tokens_total",
        "spec_accepted_tokens_total", "serve_tokens_total")}
    if got["serve_requests_completed_total"] != 4 \
            or not got["spec_draft_tokens_total"] \
            or not got["spec_accepted_tokens_total"]:
        raise AssertionError(f"launch.serve --spec-draft: {got}")
    return got


# ---------------------------------------------------------------------------
# phase 11: windowed decoders (gemma3_1b local:global, h2o_danube_1_8b swa)
# ---------------------------------------------------------------------------

WINDOWED_ARCHS = ("gemma3_1b", "h2o_danube_1_8b")
# 11b: five requests on 4 slots; uid 0 runs to position 24 + 584 - 1 = 607,
# past gemma3's 512-slot local rings; uid 4 arrives later and takes a freed
# slot (its rings reset on the card)
WINDOWED_TRACE = [dict(uid=0, arrival_tick=0, prompt_len=24, max_new=584),
                  dict(uid=1, arrival_tick=0, prompt_len=7, max_new=8),
                  dict(uid=2, arrival_tick=0, prompt_len=12, max_new=16),
                  dict(uid=3, arrival_tick=0, prompt_len=30, max_new=32),
                  dict(uid=4, arrival_tick=40, prompt_len=9, max_new=8)]
WINDOWED_MAX_LEN = 640
# 11b-11e serve gemma3 at 14 of its 26 layers (2 periods of 5 local layers
# and a global one, the 2-layer tail), cut for the script's time limit
WINDOWED_LAYERS = 14
# 11c: 4 requests x 8 new tokens
SHORT_TRACE = [dict(uid=i, arrival_tick=0, prompt_len=n, max_new=8)
               for i, n in enumerate((6, 9, 5, 11))]
# 11e: one prompt of 600 tokens through the whole-sequence prefill
PREFILL_TOKENS = 600
# 11e's bound on the relative L2 gap between prefill's last logits and the
# dense engine's after the same 600 tokens one by one, at full width in
# bfloat16 compute: the two paths round at other places (the gather bodies
# at 600 rows against the serving bodies at 1 row, the chunked online
# softmax against one softmax over the ring or cache) through the layers; a
# wrong mask or ring slot gives a gap of order 1.  It gates gemma3 at
# WINDOWED_LAYERS: 1.4687e-2 to 1.5509e-2 over the four modes at 14 of 26
# layers (1.66e-2 to 1.80e-2 at 26), the same in every run on the H100;
# the bound is 1.29x the largest at 14 (the gap grows with depth)
PREFILL_GAP_BF16 = 2e-2


def windowed_cfgs():
    """The full-width configs of phase 11, by name."""
    from repro_torch.configs.base import get_arch
    return {name: get_arch(name) for name in WINDOWED_ARCHS}


def projection_shapes(cfg):
    """[(label, O, K, n, m, launches per layer)]: the packed projections of
    one layer of ``cfg`` as ``layers.init_linear`` makes them (the group
    config adapted to each contraction dim), projections of one shape and
    pattern merged."""
    from repro_torch.models.layers import linear_sparsity
    d, hd = cfg.d_model, cfg.resolved_head_dim
    projs = [("wq", cfg.num_heads * hd, d), ("wk", cfg.num_kv_heads * hd, d),
             ("wv", cfg.num_kv_heads * hd, d), ("wo", d, cfg.num_heads * hd),
             ("gate", cfg.d_ff, d), ("up", cfg.d_ff, d),
             ("down", d, cfg.d_ff)]
    merged = {}
    for name, o, k in projs:
        sp = linear_sparsity(k, cfg.sparsity, name)
        merged.setdefault((o, k, sp.n * sp.k, sp.m), []).append(name)
    return [(f"{cfg.name} {'/'.join(names)}", o, k, n, m, len(names))
            for (o, k, n, m), names in merged.items()]


def mode_kernel(layout, quantize):
    return {("xwT", None): "demm_xwT", ("xwT", "int8"): "demm_xwT_q8",
            ("block", None): "demm_block_spmm",
            ("block", "int8"): "demm_block_spmm_q8"}[(layout, quantize)]


def step_bodies(model, bx=4, modules=None, check=True):
    """{(kernel, body): launches} of one decode step of the packed
    ``model`` at ``bx`` rows (its packed nodes under ``modules``: the
    whole model by default), each projection's body read from the
    wrappers' own selection (``demm_xwT.xwt_body`` with K3's scales,
    ``demm_block_spmm.block_body``, ``demm_q8.block_q8_body``) on its
    weight, x in the compute dtype; and, with ``check``, each checked
    against the rule as this script states it: K1 and K3 on the body
    :func:`xwt_rule` names; K2 and K4 on their cluster body where a group's M
    activations are a 16-byte multiple, else (M = 1: gemma3's 1:1
    projections) on their gather body.  (A rank's slice of a weight may
    fall to a gather body: phase 16 reads the bodies unchecked and reports
    them.)"""
    import torch
    from repro_torch.core.sparsity import PackedWeight
    from repro_torch.kernels.demm_block_spmm import block_body
    from repro_torch.kernels.demm_q8 import block_q8_body
    from repro_torch.kernels.demm_xwT import xwt_body
    from repro_torch.models.layers import dtype_of

    dtype = dtype_of(model.cfg.compute_dtype)
    out = {}
    for pw in (modules if modules is not None else model).modules():
        if not isinstance(pw, PackedWeight):
            continue
        o, k = pw.dense_shape
        m = pw.cfg.m
        x = torch.zeros((bx, k), dtype=dtype, device=pw.values.device)
        if pw.layout == "block":
            name = ("demm_block_spmm_q8" if pw.qdtype else "demm_block_spmm")
            body = (block_q8_body(pw.values, pw.indices, pw.scales, x.T, m)
                    if pw.qdtype else
                    block_body(pw.active_groups, pw.values, pw.indices, x.T,
                               m))
            rule = ("cluster" if bx <= 8 and (m * x.element_size()) % 16 == 0
                    else "gather")
        else:
            name = "demm_xwT_q8" if pw.qdtype else "demm_xwT"
            body = xwt_body(x, pw.values, pw.indices, m,
                            duplicates=pw.has_duplicates,
                            scales=pw.scales if pw.qdtype else None)
            rule = xwt_rule(bx, k, m, dtype)
        if check and body != rule:
            raise AssertionError(
                f"{name} at ({o}, {k}) {pw.cfg.pattern_name()}, Bx = {bx}: "
                f"the wrapper selects its {body} body, expected {rule}")
        out[(name, body)] = out.get((name, body), 0) + 1
    return out


def bodies_json(counts):
    return {f"{k} {b}": n for (k, b), n in sorted(counts.items())}


def check_step_counts(kernel, per_step, steps, what):
    """The wrappers' counts since the last reset: ``kernel`` launched
    ``steps`` times its per-step bodies ``per_step`` ({(kernel, body): n}),
    nothing else launched (K1, K2 and K3 count by body)."""
    counts, bodies = read_counts(), read_body_counts()
    want = {name: 0 for name in KERNELS}
    want[kernel] = steps * sum(per_step.values())
    if counts != want:
        raise AssertionError(f"{what}: launch counts {counts}, expected "
                             f"{want}")
    if kernel in bodies:
        want_b = {b: 0 for b in bodies[kernel]}
        for (name, body), n in per_step.items():
            want_b[body] += steps * n
        if bodies[kernel] != want_b:
            raise AssertionError(f"{what}: {kernel} launches by body "
                                 f"{bodies[kernel]}, expected {want_b}")
    return counts[kernel]


def step_split(engine, steps=3):
    """Where the device time of the eager decode step goes (a split the
    captured step's profile cannot give: a replay runs no Python): a
    ``torch.profiler`` window of ``steps`` eager steps on the engine's state,
    with ranges put around the ring attention, the global layers' attention
    and the unembedding for the window only.  Kernels by name: the DeMM
    kernels (all projections); inside the ranges, the ring writes (the
    kernels of ``aten::index_put_`` inside a ring attention), the rest of
    attention and the unembedding; the rest (norms, the MLP's gating, RoPE,
    the embedding, casts) is everything else.  ms per step."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    from repro_torch.models import attention as am
    from repro_torch.models import transformer as tm

    ranges = {(tm, "ring_decode_attention"): "ring attention",
              (am, "apply_attention_decode"): "global attention",
              (tm, "apply_unembedding"): "unembedding"}
    saved = {key: getattr(*key) for key in ranges}

    def wrap(fn, name):
        def inner(*a, **kw):
            with record_function(name):
                return fn(*a, **kw)
        return inner

    for (mod, attr), name in ranges.items():
        setattr(mod, attr, wrap(saved[(mod, attr)], name))
    try:
        with torch.inference_mode():
            engine._decode()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(steps):
                    engine._decode()
                torch.cuda.synchronize()
    finally:
        for (mod, attr), fn in saved.items():
            setattr(mod, attr, fn)
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.events()
    names = set(ranges.values())
    total = demm = 0.0
    by_name = {}
    for e in events:
        # a range also appears on the device's timeline, spanning its
        # kernels: not a kernel
        if e.device_type == cuda and e.name not in names:
            total += e.device_time_total
            by_name[e.name[:80]] = (by_name.get(e.name[:80], 0.0)
                                    + e.device_time_total)
            if device_kernel_of(e.name) is not None:
                demm += e.device_time_total
    split = {"ring writes": 0.0, "attention": 0.0, "unembedding": 0.0}
    for e in events:
        if e.device_type == cuda or not e.kernels:
            continue
        inside, writes, p = None, False, e
        while p is not None:
            if inside is None and p.name in names:
                inside = p.name
            writes = writes or p.name == "aten::index_put_"
            p = p.cpu_parent
        if inside is None:
            continue
        for kinfo in e.kernels:
            if device_kernel_of(kinfo.name) is not None:
                continue
            cat = ("unembedding" if inside == "unembedding" else
                   "ring writes" if writes and inside == "ring attention"
                   else "attention")
            split[cat] += kinfo.duration
    out = {"K1-K4": demm, **split}
    out["other"] = total - sum(out.values())
    out["total"] = total
    out = {k: v / 1e3 / steps for k, v in out.items()}
    out["top"] = {name: ms / 1e3 / steps for name, ms in
                  sorted(by_name.items(), key=lambda kv: -kv[1])[:8]}
    return out


def serve_windowed(model, cfg, layout, quantize, trace=WINDOWED_TRACE,
                   past=600):
    """11b / 11c: ``run_serve`` of ``trace`` (its prompts from the seed,
    replayed at their arrival ticks) on 4 slots, backend ``cuda``, ``model``
    packed in place to the mode.  Every request completes inside the true
    vocab and (given ``past``) uid 0 runs past that position; counted from
    reset to
    drain, the wrappers launch the mode's kernel 7 x layers x (warm-up +
    capture), split by body as the wrappers select them (:func:`step_bodies`),
    nothing else; the captured graph's kernel nodes
    (:func:`graph_kernel_counts`) launch the same on every replay, and a
    profiled window of 3
    replays shows them on the device (the profiler may drop the records of
    one replay, :func:`profiled_replays`).  Then the device time of a replay
    and the eager step's split (:func:`step_split`)."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.launch.serve import run_serve
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    kernel = mode_kernel(layout, quantize)
    pack_tree(model, layout=layout, quantize=quantize)   # in place
    per_step = step_bodies(model)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_windowed_")
    path = os.path.join(tmp, "trace.jsonl")
    with open(path, "w") as f:
        for row in trace:
            f.write(json.dumps(row) + "\n")
    try:
        torch.cuda.synchronize()
        reset_counts()                   # just before the main path ...
        with graphs_kept():
            engine = run_serve(
                model, cfg.vocab_size, packed=True, layout=layout,
                quantize=quantize, backend="cuda", slots=4,
                max_len=WINDOWED_MAX_LEN, seed=0, device=DEVICE,
                metrics=obs.MetricsRegistry(), trace_replay=path)
        launches = check_step_counts(              # ... and just after
            kernel, per_step, CAPTURE_WARMUP + 1, f"{cfg.name} {layout}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    done = {r.uid: r for r in engine.completed}
    if sorted(done) != [r["uid"] for r in trace]:
        raise AssertionError(f"completed {sorted(done)}")
    for row in trace:
        r = done[row["uid"]]
        if len(r.output) != row["max_new"] or not all(
                0 <= t < cfg.vocab_size for t in r.output):
            raise AssertionError(f"request {r.uid}: {len(r.output)} tokens, "
                                 f"or one outside the true vocab")
    last = len(done[0].prompt) + len(done[0].output) - 1
    if past is not None and last <= past:
        raise AssertionError(f"the long request ended at position {last}")
    if not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError("non-finite logits")
    if engine._graph is None or engine.captures != 1:
        raise AssertionError("the CUDA engine did not capture its step once")
    tokens = sum(len(r.output) for r in engine.completed)
    per_replay, nodes = graph_kernel_counts(engine._graph)
    if per_replay != per_step:
        raise AssertionError(f"{cfg.name} {layout} {quantize}: the graph's "
                             f"nodes launch {per_replay} ({nodes} kernel "
                             f"nodes), expected {per_step}")
    window = profiled_replays(engine, cfg, kernel, want=per_step)
    entry = {
        "arch": cfg.name, "layout": layout, "quantize": quantize,
        "kernel": kernel, "requests": len(done), "ticks": engine.drain_ticks,
        "last_position": last, "tokens": tokens,
        "drain_s": engine.drain_seconds,
        "tokens_per_s": tokens / engine.drain_seconds,
        "tick_ms_mean": 1e3 * engine.drain_seconds / engine.drain_ticks,
        "decode_step_ms_p50": 1e3 * engine._sk_tok.quantile(0.5),
        "launches": launches, "bodies_per_step": bodies_json(per_step),
        "device_launches_per_replay": bodies_json(per_replay),
        "kernel_nodes_per_replay": nodes,
        "profiled_3_replays": bodies_json(window),
        "step_device_ms": graph_device_ms(engine._graph),
        "eager_step_split_ms": step_split(engine),
    }
    return entry


def prefill_gap(model, cfg, kernel, rtol=None, tokens=PREFILL_TOKENS,
                per_prefill=None, bound=None, seed=5):
    """11e: ``model.prefill`` of one prompt of ``tokens`` tokens (drawn
    from ``seed``; 600: the
    projections at 600 rows, every launch on the body the rule gives
    (:func:`step_bodies` at ``tokens`` rows: K1's wide body for bfloat16 x,
    gather for float32 x or M = 1), or ``per_prefill`` {(kernel, body):
    n}),
    against the dense engine fed the same tokens
    one by one (a captured step per token; its logits after the last one).
    Returns (the relative L2 gap of the last logits over the true vocab,
    ``kernel``'s launches in the prefill as the wrappers counted them);
    raises above ``bound`` (:data:`PREFILL_GAP_BF16` by default) or, with
    ``rtol``, where ``allclose`` at ``rtol`` fails."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.serve import Request, ServeConfig, ServeEngine

    policy = ExecPolicy(mode="packed", backend="cuda")
    prompt = np.random.default_rng(seed).integers(
        0, cfg.vocab_size, tokens).astype(np.int32)
    torch.cuda.synchronize()
    reset_counts()
    with torch.inference_mode():
        logits, state = model.prefill(
            {"tokens": torch.from_numpy(prompt).to(DEVICE)[None]},
            policy=policy)
        got = logits[0, 0, :cfg.vocab_size].float().cpu().numpy()
    launched = check_step_counts(kernel, per_prefill or step_bodies(
        model, bx=tokens), 1, f"{cfg.name} prefill")
    if state["pos"].tolist() != [0]:
        raise AssertionError("prefill's decode state is not fresh")
    engine = ServeEngine(model, ServeConfig(num_slots=1, max_len=tokens + 8),
                         policy=policy, device=DEVICE,
                         metrics=obs.MetricsRegistry())
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=1))
    engine.run_until_drained()
    want = engine.last_logits[0, :cfg.vocab_size]
    gap = float(np.linalg.norm(got - want) / np.linalg.norm(want))
    if rtol is not None:
        if not np.allclose(got, want, rtol=rtol, atol=rtol):
            raise AssertionError(f"{cfg.name}: prefill and token-by-token "
                                 f"logits differ, max abs "
                                 f"{np.abs(got - want).max()}")
    elif not gap <= (bound or PREFILL_GAP_BF16):
        raise AssertionError(f"{cfg.name}: prefill's last logits lie {gap} "
                             f"(relative L2) from the token-by-token ones")
    if int(np.argmax(got)) != int(np.argmax(want)) and rtol is not None:
        raise AssertionError(f"{cfg.name}: prefill and decode pick "
                             "different tokens")
    return gap, launched


def windowed_gates():
    """11d: 2-3 layers of full width, float32 compute, short windows so
    that the rings wrap (serve_collect's prompts of 4-8 tokens and 6 new):
    gemma3 with ``local_global_ratio`` 1, 3 layers and ``local_window`` 8
    (a local, a global and a tail layer), h2o with ``window`` 8.  In the four
    modes: the captured step's tokens equal the eager step's and backend
    ``reference``'s, its logits bit-equal to the eager step's and allclose
    (rtol 1e-3) to the reference's (:func:`check_graph_modes`); and prefill
    of a 40-token prompt agrees with the token-by-token engine at rtol 1e-3
    (:func:`prefill_gap`, on the gemma3 models)."""
    cfgs = windowed_cfgs()
    over = {"gemma3_1b": dict(num_layers=3, local_global_ratio=1,
                              local_window=8),
            "h2o_danube_1_8b": dict(num_layers=2, window=8)}
    report = {}
    for name, cfg in cfgs.items():
        report[name] = check_graph_modes(
            cfg, auto=False, prefill=name == "gemma3_1b", **over[name])
    return report


def windowed_cli():
    """11f: ``launch.serve --arch gemma3_1b --full --packed`` as a user
    runs it, then again with ``--layout block --autotune`` (a tuning cache
    of this run's own): 4 requests complete, 8 tokens each; the tuned run
    measured candidates and every decode-width lookup hit the cache."""
    import shutil
    import tempfile
    from repro_torch import obs, tune

    from repro_torch.launch.serve import main as serve_main

    out_dir = tempfile.mkdtemp(prefix="chip_smoke_windowed_cli_")
    prev = obs.default_registry()
    report = {}
    try:
        for label, extra in (("default", []),
                             ("block autotune", ["--layout", "block",
                                                 "--autotune"])):
            metrics_out = os.path.join(out_dir, f"{len(report)}.json")
            reg = obs.MetricsRegistry()
            obs.set_default_registry(reg)
            tune.set_default_cache(tune.TuneCache(
                os.path.join(out_dir, "tune_cache.json")))
            t0 = time.time()
            serve_main(["--arch", "gemma3_1b", "--full", "--packed",
                        "--requests", "4", "--max-new", "8",
                        "--metrics-out", metrics_out, *extra])
            with open(metrics_out) as f:
                snap = json.load(f)
            got = {}
            for c in snap["counters"]:
                got[c["name"]] = got.get(c["name"], 0) + c["value"]
            if got.get("serve_requests_completed_total") != 4 or \
                    got.get("serve_tokens_total") != 32:
                raise AssertionError(f"launch.serve --arch gemma3_1b "
                                     f"{' '.join(extra)}: counters {got}")
            entry = {"requests": 4, "tokens": 32, "s": time.time() - t0}
            if extra:
                measured = got.get("tune_autotune_measurements_total", 0)
                outcome, dispatch = cache_counts(reg, 4)
                if not measured or outcome["miss"] or not outcome["hit"] or \
                        set(dispatch) != {"xwT_block/cuda"}:
                    raise AssertionError(
                        f"--autotune: {measured} measurements, decode-width "
                        f"lookups {outcome}, dispatches {dispatch}")
                entry.update(measurements=measured, lookups=outcome,
                             dispatch=dispatch)
            report[label] = entry
    finally:
        obs.set_default_registry(prev)
        tune.set_default_cache(None)
        shutil.rmtree(out_dir, ignore_errors=True)
    return report


def windowed_phase():
    """Phase 11 in full; returns the ``windowed`` report."""
    import torch
    from repro_torch.models.families import build_model

    cfgs = windowed_cfgs()
    cfg = dataclasses.replace(cfgs["gemma3_1b"], num_layers=WINDOWED_LAYERS)
    report = {"modes": {}, "prefill_gap": {}}
    for layout in ("xwT", "block"):
        t0 = time.time()
        model = build_model(cfg, device=DEVICE, seed=0)
        log(f"[11 windowed] built {cfg.name} ({cfg.num_layers} layers, "
            f"d_model {cfg.d_model}, heads {cfg.num_heads} x "
            f"{cfg.resolved_head_dim}, kv heads {cfg.num_kv_heads}, d_ff "
            f"{cfg.d_ff}, vocab {cfg.padded_vocab}) in "
            f"{time.time() - t0:.1f} s")
        for quantize in (None, "int8"):      # packed, then quantized
            mode = f"--layout {layout}" + (" --quantize int8" if quantize
                                           else "")
            t0 = time.time()
            entry = serve_windowed(model, cfg, layout, quantize)
            entry["graph_vs_eager"] = graph_vs_eager(model, cfg, mode)[0]
            gap = prefill_gap(model, cfg, entry["kernel"])[0]
            entry["prefill_rel_l2_gap"] = gap
            report["prefill_gap"][mode] = gap
            report["modes"][mode] = entry
            log(f"[11b windowed] {cfg.name} {mode} ({time.time() - t0:.1f} "
                f"s): {json.dumps(entry)}")
        del model
        torch.cuda.empty_cache()
    h2o = cfgs["h2o_danube_1_8b"]
    t0 = time.time()
    model = build_model(h2o, device=DEVICE, seed=0)
    entry = serve_windowed(model, h2o, "xwT", None, trace=SHORT_TRACE,
                           past=None)
    entry["graph_vs_eager"] = graph_vs_eager(model, h2o, "--layout xwT")[0]
    report["h2o_danube_1_8b"] = entry
    log(f"[11c windowed] {h2o.name} --layout xwT ({time.time() - t0:.1f} s): "
        f"{json.dumps(entry)}")
    del model
    torch.cuda.empty_cache()
    t0 = time.time()
    report["2 layers float32"] = windowed_gates()
    log(f"[11d windowed] graph vs eager vs reference, rings of 8, float32, "
        f"four modes ({time.time() - t0:.1f} s): "
        f"{json.dumps(report['2 layers float32'])}")
    t0 = time.time()
    report["cli"] = windowed_cli()
    log(f"[11f windowed cli] launch.serve --arch gemma3_1b --full --packed "
        f"[--layout block --autotune] ({time.time() - t0:.1f} s): "
        f"{json.dumps(report['cli'])}")
    return report


def windowed_times(gen, rows_by_shape):
    """Phase 7w: K1-K4 at every projection shape of gemma3_1b and
    h2o_danube_1_8b, Bx = 4, bf16 x, as :func:`time_shape` times them (a
    shape stablelm_3b shares reuses its rows, ``rows_by_shape``); returns
    {kernel: {arch: per-layer totals and the per-shape rows}}."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig

    out = {name: {} for name in KERNELS[:4]}
    for arch, cfg in windowed_cfgs().items():
        per = {name: [] for name in KERNELS[:4]}
        for label, o, k, n, m, count in projection_shapes(cfg):
            key = (o, k, f"{n}:{m}")
            rows = rows_by_shape.get(key)
            if rows is None:
                x, vals, idx, q, scales, meta = shape_inputs(
                    label, o, k, n, m, gen)
                cfgs = SparsityConfig(n, m)
                rows = time_xwt(x, vals, idx, q, scales, cfgs, meta)
                dense, blocks = time_block(x, vals, idx, cfgs, meta)
                rows.update(blocks)
                lib = library_ms(x, dense)
                for entries in rows.values():
                    for e in entries:
                        e["library_ms"] = lib
                rows_by_shape[key] = rows
                del dense
                torch.cuda.empty_cache()
            for name in per:
                for e in rows[name]:
                    if e.get("scales", "per_row") == "per_row":
                        per[name].append({**e, "shape": label,
                                          "count": count})
        for name, rows in per.items():
            out[name][arch] = {
                key: sum(e["count"] * e[key] for e in rows)
                for key in ("ms", "plain_ms", "bound_ms", "library_ms")}
            bound_by = {e["bound_by"] for e in rows}
            out[name][arch]["bound_by"] = (bound_by.pop() if len(bound_by)
                                           == 1 else "bytes")
            out[name][arch]["shapes"] = rows
    return out


# ---------------------------------------------------------------------------
# phase 12: training (launch.train), the packed ops under autograd, and the
# trained checkpoint served packed
# ---------------------------------------------------------------------------

# 12a: one stablelm_3b layer's projection shapes and gemma3's 1:1 gate/up
TRAIN_SHAPES = MAIN_SHAPES + [("gemma3 gate/up", 6912, 1152, 1, 1)]
TRAIN_BX = (4, 32)
# 12b: full width through the entry point, then its checkpoint served
TRAIN_FULL_ARGS = ["--arch", "stablelm_3b", "--steps", "4", "--batch", "2",
                   "--seq", "256", "--lr", "1e-3", "--log-every", "1"]
# 12c: reduced, float32 compute, the sparsify + QAT path with a restart
TRAIN_SPARSE_STEPS, TRAIN_FAIL_AT = 12, 6


def train_ops(w, cfg):
    """{op: (kernel, PackedWeight)} of the dense ``w``: the four packed
    forms a training step can run through K1-K4."""
    from repro_torch.core.sparsity import PackedWeight, pack_block
    from repro_torch.quant import quantize_packed
    xwt = PackedWeight.from_dense(w, cfg)
    blk = pack_block(w, cfg)
    return {"xwT": ("demm_xwT", xwt),
            "xwT_q8": ("demm_xwT_q8", quantize_packed(xwt)),
            "xwT_q8/per_group": ("demm_xwT_q8",
                                 quantize_packed(xwt,
                                                 granularity="per_group")),
            "block": ("demm_block_spmm", blk),
            "block_q8": ("demm_block_spmm_q8", quantize_packed(blk))}


def grads_through(pw, x, dy, backend):
    """y and the gradients of sum(y * dy) at x and the float operand (the
    values of a float weight, the scales of an int8 one), through
    ``ops.demm_matmul_packed`` on ``backend``, on leaves of their own."""
    import torch
    from repro_torch.kernels import ops
    xl = x.clone().requires_grad_(True)
    if pw.qdtype is None:
        p = pw.values.clone().requires_grad_(True)
        pw = pw.replace(values=p, has_duplicates=False)
    else:
        p = pw.scales.clone().requires_grad_(True)
        pw = pw.replace(scales=p)
    y = ops.demm_matmul_packed(xl, pw, backend=backend)
    gx, gp = torch.autograd.grad((y * dy).sum(), [xl, p])
    return y.detach(), gx, gp


def dense_grads(pw, x, dy):
    """The gradients of sum(y * dy) at x and the float operand (as in
    ``grads_through``), by autograd through the plain dense product y =
    x @ W_denseᵀ in float32, W_dense built from that operand as a leaf (the
    values scattered, or the int8 values times the scales), with no packed
    op in the way: what a wrong backward of K1-K4's autograd functions
    would disagree with."""
    import torch
    from repro_torch.core.sparsity import (LAYOUT_BLOCK, expand_scales,
                                           unpack, unpack_block)
    xl = x.to(torch.float32).requires_grad_(True)
    if pw.qdtype is None:
        p = pw.values.to(torch.float32).requires_grad_(True)
        vals = p
    else:
        p = pw.scales.to(torch.float32).requires_grad_(True)
        vals = pw.values.to(torch.float32) * expand_scales(p, pw.values)
    shape = tuple(pw.dense_shape)
    if pw.layout == LAYOUT_BLOCK:
        w = unpack_block(pw.active_groups, vals, pw.indices, pw.cfg, shape)
    else:
        w = unpack(vals, pw.indices, pw.cfg, shape)
    y = xl @ w.T
    return torch.autograd.grad((y * dy).sum(), [xl, p])


def grad_tol(dtype, terms):
    """12a's tolerance on a gradient against ``dense_grads``: phase 3's for
    x's dtype (dx comes back in it; the float operand's gradient is float32
    either way), its atol grown as sqrt(terms / F32_TERMS) past F32_TERMS
    products a sum, as phase 3 grows it for the forward."""
    tol = dict(TOL[dtype])
    if terms > F32_TERMS:
        tol["atol"] *= (terms / F32_TERMS) ** 0.5
    return tol


def train_grads(gen):
    """12a: the packed ops' gradients through the ``cuda`` forward (K1-K4)
    agree with autograd through the plain dense product (``dense_grads``,
    tolerance ``grad_tol``) everywhere but at padded slots, which get
    exactly 0; they equal those through the ``reference`` forward bit for
    bit (which holds by construction: the backward is the same tensor ops
    on the same saved operands, so only the forward differs, held to phase
    3's tolerance); every ``cuda`` forward launched its kernel on the body
    the wrapper's rule names."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, unpack
    from repro_torch.kernels.demm_block_spmm import block_body
    from repro_torch.kernels.demm_xwT import xwt_body

    reset_counts()
    want = {name: 0 for name in KERNELS}
    want_b = {name: {b: 0 for b in bodies}
              for name, bodies in read_body_counts().items()}
    err, gerr, cases, padded = {}, {}, 0, 0
    for label, o, k, n, m in TRAIN_SHAPES:
        cfg = SparsityConfig(n, m)
        vals, idx = make_packed(o, k, n, m, gen)
        vals[::5, :, 0] = 0.0            # every fifth row under-full
        w = unpack(vals, idx, cfg, (o, k))
        for op, (kernel, pw) in train_ops(w, cfg).items():
            for bx in TRAIN_BX:
                for dtype in ("float32", "bfloat16"):
                    x = torch.randn((bx, k), generator=gen, device=DEVICE)
                    x = x.to(getattr(torch, dtype))
                    dy = torch.randn((bx, o), generator=gen, device=DEVICE)
                    what = f"{op} {label} Bx={bx} x={dtype}"
                    yc, gxc, gpc = grads_through(pw, x, dy, "cuda")
                    yr, gxr, gpr = grads_through(pw, x, dy, "reference")
                    torch.cuda.synchronize()
                    tol = dict(TOL[dtype])
                    if dtype == "float32" and k // m * n > F32_TERMS:
                        tol["atol"] *= (k // m * n / F32_TERMS) ** 0.5
                    torch.testing.assert_close(
                        yc, yr, **tol, msg=lambda s: f"12a {what}: {s}")
                    if not (torch.equal(gxc, gxr) and torch.equal(gpc, gpr)):
                        raise AssertionError(
                            f"12a {what}: gradients through cuda and "
                            f"reference differ (dx max "
                            f"{float((gxc - gxr).abs().max())}, d-operand "
                            f"max {float((gpc - gpr).abs().max())})")
                    gxd, gpd = dense_grads(pw, x, dy)
                    pad = pw.values == 0
                    # the longest sums: dx's over the O rows' slots on one
                    # column, a value's over Bx, a scale's over Bx times
                    # the slots it scales
                    x_terms = o * n // m
                    p_terms = bx * (1 if pw.qdtype is None else
                                    pw.values.numel() // pw.scales.numel())
                    torch.testing.assert_close(
                        gxc.to(torch.float32), gxd,
                        **grad_tol(dtype, x_terms),
                        msg=lambda s: f"12a {what} dx vs dense: {s}")
                    keep = ~pad if pw.qdtype is None else slice(None)
                    torch.testing.assert_close(
                        gpc.to(torch.float32)[keep], gpd[keep],
                        **grad_tol("float32", p_terms),
                        msg=lambda s: f"12a {what} d-operand vs dense: {s}")
                    gerr[kernel] = max(
                        gerr.get(kernel, 0.0),
                        float((gxc.to(torch.float32) - gxd).abs().max()),
                        float((gpc.to(torch.float32)[keep]
                               - gpd[keep]).abs().max()))
                    if pw.qdtype is None:
                        if not bool(pad.any()) or bool(gpc[pad].any()):
                            raise AssertionError(
                                f"12a {what}: padded slots' gradient not 0 "
                                f"(or no padded slot)")
                        padded += int(pad.sum())
                    e = float((yc - yr).abs().max())
                    err[kernel] = max(err.get(kernel, 0.0), e)
                    want[kernel] += 1
                    if kernel in ("demm_xwT", "demm_xwT_q8"):
                        body = xwt_body(x, pw.values, pw.indices, m,
                                        duplicates=False,
                                        scales=pw.scales)
                        rule = xwt_rule(bx, x.shape[1], m, x.dtype)
                    elif kernel == "demm_block_spmm":
                        body = block_body(pw.active_groups, pw.values,
                                          pw.indices, x.T, m)
                        rule = ("cluster" if bx <= 8 and
                                (m * x.element_size()) % 16 == 0
                                else "gather")
                    else:
                        body = rule = None
                    if body != rule:
                        raise AssertionError(f"12a {what}: body {body}, "
                                             f"expected {rule}")
                    if body is not None:
                        want_b[kernel][body] += 1
                    cases += 1
    counts, bodies = read_counts(), read_body_counts()
    if counts != want or bodies != want_b:
        raise AssertionError(f"12a: launches {counts} by body {bodies}, "
                             f"expected {want} by body {want_b}")
    return {"cases": cases, "padded_slots_checked": padded,
            "forward_max_abs_err": err, "launches": counts,
            "launches_by_body": bodies,
            "grads_vs_dense_max_abs_err": gerr,
            "grads_bit_equal_cuda_vs_reference": True}


def train_remat_relaunch():
    """12a, remat: a packed 2-layer full-width stablelm_3b (xwT, bf16
    compute, one sequence of 32 tokens: K1's gather body) differentiated at
    every float tensor under ``remat="none"`` and ``"full"``.  Expected K1
    launches: 7 x 2 forward, and under ``full`` 7 x 2 more when the
    backward recomputes each layer; the recomputed forward is the first
    again, so loss and gradients are bit-equal across the two."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.train.train_loop import train_params

    base = dataclasses.replace(get_arch("stablelm_3b"), num_layers=2)
    rng = torch.Generator(device=DEVICE)
    rng.manual_seed(5)
    tokens = torch.randint(0, base.vocab_size, (1, 33), generator=rng,
                           device=DEVICE)
    batch = {"tokens": tokens[:, :-1], "targets": tokens[:, 1:]}
    out, launches = {}, {}
    for remat in ("none", "full"):
        cfg = dataclasses.replace(base, remat=remat)
        model = pack_tree(build_model(cfg, device=DEVICE, seed=3))
        leaves = {n: t.clone().requires_grad_(True)
                  for n, t in train_params(model).items()}
        torch.cuda.synchronize()
        reset_counts()
        loss, _ = torch.func.functional_call(
            model, leaves, (batch,),
            {"policy": ExecPolicy(mode="packed", backend="cuda")})
        grads = torch.autograd.grad(loss, list(leaves.values()))
        torch.cuda.synchronize()
        launches[remat] = read_counts()["demm_xwT"]
        out[remat] = (loss.detach(), grads)
        del model, leaves
    want = {"none": 7 * 2, "full": 7 * 2 * 2}
    if launches != want:
        raise AssertionError(f"12a remat: K1 launches {launches}, expected "
                             f"{want}")
    same = torch.equal(out["none"][0], out["full"][0]) and all(
        torch.equal(a, b) for a, b in zip(out["none"][1], out["full"][1]))
    if not same:
        raise AssertionError("12a remat: the recomputed forward changed the "
                             "loss or the gradients")
    return {"launches": launches, "loss": float(out["none"][0]),
            "bit_equal": True}


def serve_tokens(model, cfg, backend, **kw):
    """{uid: tokens} of ``run_serve`` on the packed ``model`` (4 requests
    of 8 new tokens), and the wrappers' launches in it."""
    import torch
    from repro_torch import obs
    from repro_torch.launch.serve import run_serve
    torch.cuda.synchronize()
    reset_counts()
    engine = run_serve(model, cfg.vocab_size, packed=True, backend=backend,
                       requests=4, slots=4, max_new=8, max_len=64, seed=0,
                       device=DEVICE, metrics=obs.MetricsRegistry(), **kw)
    torch.cuda.synchronize()
    out = {r.uid: list(r.output) for r in engine.completed}
    if len(out) != 4 or any(len(t) != 8 or not all(
            0 <= v < cfg.vocab_size for v in t) for t in out.values()):
        raise AssertionError(f"serving {backend}: bad outputs {out}")
    return out, read_counts()


def restored_model(cfg, ckpt_dir):
    from repro_torch.launch.serve import restore_checkpoint
    from repro_torch.models.families import build_model
    model = build_model(cfg, device=DEVICE, seed=0)
    step = restore_checkpoint(model, ckpt_dir)
    return model, step


def train_full_width(tmp):
    """12b: ``launch.train.main`` at full width on the plain masked path
    (no DeMM kernel runs in it), then its checkpoint served packed: the CLI
    (``launch.serve --ckpt-dir --packed --layout xwT``, backend cuda, bf16
    compute), and the restored weights in float32 compute through
    ``cuda`` and ``reference`` with equal tokens (float32: the backends'
    sums in another order must not flip a bf16 rounding, phase 6's
    reason)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    ckpt_dir = os.path.join(tmp, "full")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.time()
    summary = train_main(TRAIN_FULL_ARGS + ["--ckpt-dir", ckpt_dir])
    train_s = time.time() - t0
    gc.collect()              # the trainer's closures hold the model
    torch.cuda.empty_cache()
    counts = read_counts()
    if any(counts.values()):
        raise AssertionError(f"12b: the masked train step launched DeMM "
                             f"kernels {counts}")
    del summary["params"]                # the trained tensors
    losses = summary["losses"]
    report = {
        "losses": losses, "step_seconds": summary["step_seconds"],
        "step_seconds_after_first": summary["step_seconds"][1:],
        "peak_device_gb": summary["peak_device_bytes"] / 1e9,
        "ckpt_gb": summary["ckpt_bytes"] / 1e9,
        "ckpt_save_seconds": summary["ckpt_save_seconds"],
        "n_params": summary["n_params"], "train_main_seconds": train_s}
    torch.cuda.empty_cache()
    t0 = time.time()
    engine = serve_main(["--arch", "stablelm_3b", "--full", "--ckpt-dir",
                         ckpt_dir, "--packed", "--layout", "xwT",
                         "--requests", "4", "--max-new", "8", "--backend",
                         "cuda"])
    cli_launches = read_counts()
    if len(engine.completed) != 4 or not cli_launches["demm_xwT"]:
        raise AssertionError(f"12b: the CLI served {len(engine.completed)} "
                             f"requests, K1 launches {cli_launches}")
    report["cli_serve_seconds"] = time.time() - t0
    report["cli_tokens"] = {r.uid: list(r.output) for r in engine.completed}
    del engine
    torch.cuda.empty_cache()
    t0 = time.time()
    cfg = dataclasses.replace(get_arch("stablelm_3b"),
                              compute_dtype="float32")
    model, step = restored_model(cfg, ckpt_dir)
    report["restore_seconds"] = time.time() - t0
    tok_c, launch_c = serve_tokens(model, cfg, "cuda")
    tok_r, _ = serve_tokens(model, cfg, "reference")
    if tok_c != tok_r:
        raise AssertionError(f"12b: cuda tokens {tok_c} != reference "
                             f"{tok_r}")
    report.update(tokens_f32=tok_c, cuda_equals_reference=True,
                  launches_serve=cli_launches["demm_xwT"]
                  + launch_c["demm_xwT"])
    del model
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    torch.cuda.empty_cache()
    return report


def sparse_run(model, cfg, ckpt_dir, injector):
    """The reduced sparsify 8:128 + QAT int8 run under the supervisor, as
    ``launch.train --sparsify 8:128 --qat int8`` drives it."""
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.optim import adamw
    from repro_torch.sparsetrain import SparseTrainRecipe, SparseTrainer
    from repro_torch.sparsetrain.masks import parse_schedule
    from repro_torch.train.fault_tolerance import (SupervisorConfig,
                                                   TrainingSupervisor)
    from repro_torch.train.train_loop import train_params

    steps = TRAIN_SPARSE_STEPS
    opt_cfg = adamw.AdamWConfig(lr=3e-3, total_steps=steps, warmup_steps=2)
    trainer = SparseTrainer(model, opt_cfg, SparseTrainRecipe(
        parse_schedule("8:128", steps, update_every=2), qat="int8"))
    params = {n: p.clone() for n, p in train_params(model).items()}
    trainer.init_state(params)
    opt = adamw.init(opt_cfg, params)
    sup = TrainingSupervisor(
        SupervisorConfig(ckpt_dir=ckpt_dir, ckpt_every=4), trainer.train_step,
        DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8),
        extra_state=trainer)
    p, o, m, restarts = sup.run(params, opt, steps, failure_injector=injector)
    return p, o, trainer, restarts, float(m["loss"])


def train_sparse_restart(tmp):
    """12c: the reduced sparsify + QAT run, uninterrupted and with an
    injected failure at step 6 (restored from step 4): parameters, AdamW
    state and mask state bit-equal; the baked final masks verified; the
    baked weights packed int8 in both layouts serve the same tokens through
    ``cuda`` and ``reference``."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.launch.train import verify_final_masks
    from repro_torch.models.families import build_model
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.fault_tolerance import inject_failure_once

    cfg = dataclasses.replace(get_arch("stablelm_3b").reduced(),
                              compute_dtype="float32")
    model = build_model(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    reset_counts()
    pa, oa, ta, ra, loss_a = sparse_run(model, cfg, os.path.join(tmp, "a"),
                                        None)
    pb, ob, tb, rb, loss_b = sparse_run(
        model, cfg, os.path.join(tmp, "b"),
        inject_failure_once(TRAIN_FAIL_AT))
    if any(read_counts().values()):
        raise AssertionError("12c: the masked train step launched DeMM "
                             "kernels")
    if (ra, rb) != (0, 1):
        raise AssertionError(f"12c: restarts {ra}, {rb}")
    diff = [n for n in pa if not (torch.equal(pa[n], pb[n])
                                  and torch.equal(oa.m[n], ob.m[n])
                                  and torch.equal(oa.v[n], ob.v[n]))]
    diff += [n for n, mk in ta.state["masks"].items()
             if not torch.equal(mk, tb.state["masks"][n])]
    if diff or int(oa.step) != int(ob.step) or \
            int(ta.state["phase"]) != int(tb.state["phase"]) or \
            int(ta.state["last_update"]) != int(tb.state["last_update"]):
        raise AssertionError(f"12c: the restarted run differs from the "
                             f"uninterrupted one at {diff[:5]}")
    baked = ta.finalize(pa)
    n_sparse = verify_final_masks(baked, ta.sparsity)
    ckpt_dir = os.path.join(tmp, "baked")
    ckpt.save({"params": baked, "opt": oa, "extra": ta.extra_state()},
              ckpt_dir, TRAIN_SPARSE_STEPS)
    report = {"steps": TRAIN_SPARSE_STEPS, "failed_at": TRAIN_FAIL_AT,
              "final_loss": loss_a, "bitwise_equal_after_restart": True,
              "sparse_linears_verified": n_sparse, "serve": {}}
    launches = {}
    for layout in ("xwT", "block"):
        served, _ = restored_model(cfg, ckpt_dir)
        pack_tree(served, layout=layout, quantize="int8")
        tok_c, lc = serve_tokens(served, cfg, "cuda")
        tok_r, _ = serve_tokens(served, cfg, "reference")
        if tok_c != tok_r:
            raise AssertionError(f"12c {layout} int8: cuda tokens {tok_c} "
                                 f"!= reference {tok_r}")
        kernel = mode_kernel(layout, "int8")
        if not lc[kernel] or sum(lc.values()) != lc[kernel]:
            raise AssertionError(f"12c {layout} int8: launches {lc}")
        launches[kernel] = lc[kernel]
        report["serve"][layout] = {"tokens": tok_c, "launches": lc[kernel],
                                   "cuda_equals_reference": True}
    report["launches"] = launches
    shutil.rmtree(tmp, ignore_errors=True)
    return report


def train_phase(gen):
    """Phase 12 in full; returns the ``train`` report."""
    import tempfile
    t12 = time.time()
    report = {}
    t0 = time.time()
    report["grads"] = train_grads(gen)
    report["remat"] = train_remat_relaunch()
    log(f"[12a train grads] K1-K4 under autograd, cuda vs the dense "
        f"product's autograd and vs reference "
        f"({time.time() - t0:.1f} s): {json.dumps(report['grads'])}; remat "
        f"{json.dumps(report['remat'])}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        t0 = time.time()
        report["full_width"] = train_full_width(tmp)
        log(f"[12b train full width] launch.train "
            f"{' '.join(TRAIN_FULL_ARGS)}, then launch.serve --ckpt-dir "
            f"--packed ({time.time() - t0:.1f} s): "
            f"{json.dumps(report['full_width'])}")
        t0 = time.time()
        report["sparse_restart"] = train_sparse_restart(
            os.path.join(tmp, "sparse"))
        log(f"[12c train sparsify+qat] reduced, {TRAIN_SPARSE_STEPS} steps, "
            f"failure at {TRAIN_FAIL_AT} ({time.time() - t0:.1f} s): "
            f"{json.dumps(report['sparse_restart'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = time.time() - t12
    return report


# ---------------------------------------------------------------------------
# phase 13: the other model families (MoE, vision, encoder-decoder, Mamba2
# hybrid, xLSTM) served and trained through K1-K4
# ---------------------------------------------------------------------------

# the six architectures at full width; llama4_scout's 48 layers hold some
# 400 GB of float32 weights, so it runs at full width and 4 layers; zamba2
# at 27 of its 81 layers (4 periods of 6 Mamba2 layers and the shared
# block, the 3-layer tail), cut for the script's time limit
FAMILY_ARCHS = {"olmoe_1b_7b": {}, "llama4_scout_17b_a16e": {"num_layers": 4},
                "internvl2_1b": {}, "seamless_m4t_medium": {},
                "zamba2_7b": {"num_layers": 27}, "xlstm_125m": {}}
# K1 launches of one decode step, as the families' code gives them: attention
# only for the MoE decoders (routers and experts are dense); every layer's
# 7 for internvl2 and seamless's decoder (cross-attention is dense, the
# encoder does not run in decode); zamba2's in_proj and out_proj in each of
# 27 layers and the shared block's 7 in each of 4 periods; xlstm's 3 x (3
# mLSTM x 5 + sLSTM 2)
FAMILY_STEP_LAUNCHES = {"olmoe_1b_7b": 16 * 4, "llama4_scout_17b_a16e": 4 * 4,
                        "internvl2_1b": 24 * 7, "seamless_m4t_medium": 12 * 7,
                        "zamba2_7b": 27 * 2 + 4 * 7,
                        "xlstm_125m": 3 * (3 * 5 + 2)}
# 13b: 2-3 layers (zamba2 5 at a shared block every 2, as ``reduced()``
# cuts it; xlstm 4, one period; seamless's encoder 2 layers), float32
FAMILY_GATE_OVER = {"olmoe_1b_7b": {}, "llama4_scout_17b_a16e": {},
                    "internvl2_1b": {},
                    "seamless_m4t_medium": {"encoder_layers": 2},
                    "zamba2_7b": {"num_layers": 5, "shared_attn_every": 2},
                    "xlstm_125m": {"num_layers": 4}}
PAGED_FAMILIES = ("olmoe_1b_7b", "internvl2_1b", "seamless_m4t_medium")
RECURRENT_FAMILIES = ("zamba2_7b", "xlstm_125m")
FAMILY_PREFILL_TOKENS = 200
# 13d's prompts (their seeds), each prefilled and decoded in bfloat16; the
# float32 leg takes the first
FAMILY_PREFILL_SEEDS = (5, 6, 7)
# 13d's bound on the relative L2 gap in bfloat16 compute, where rounding
# makes prefill and decode differ more the deeper the model: at the
# phase's depths and seeds, zamba2's 27 layers (4 shared blocks) give
# 2.93e-2 to 3.23e-2 at full width, xlstm 2.03e-2 to 3.04e-2 (81 layers
# gave 4.68e-2 to 5.47e-2), the same in every run on the H100; the bound
# is 1.27x the largest.  The port's gap is the reference's own
# (``tests/test_torch_ssm.py::test_bf16_prefill_gap_is_the_references``:
# within 10 % at 7 layers on the CPU, both rounding each op), and the
# float32 leg holds the invariant at rtol 1e-3; a wrong state or mask gives
# a gap of order 1
FAMILY_PREFILL_GAP_BF16 = 4.1e-2
# 13e: launch.train per family: full width for xlstm (125 M parameters),
# the reduced config for the others (more steps: the reduced experts' loss
# falls in about 10 steps, as on the CPU); internvl2 and seamless train at
# full width, cut in depth, in 15g instead, for the script's time limit
FAMILY_TRAIN_FULL = ("xlstm_125m",)
FAMILY_TRAIN_ARGS = {
    "full": ["--steps", "6", "--batch", "8", "--seq", "128", "--lr", "2e-3",
             "--log-every", "1"],
    "reduced": ["--reduced", "--steps", "12", "--batch", "8", "--seq", "64",
                "--lr", "3e-3", "--log-every", "1"]}
# 7f: K1-K4 at zamba2's in_proj (14,576 rows; the block layout takes
# 16-row blocks there, so nothing is padded) and out_proj, and xlstm's 6:96
# wq/wk/wv
FAMILY_TIMED_SHAPES = [("zamba2_7b in_proj", 14576, 3584, 7, 112),
                       ("zamba2_7b out_proj", 3584, 7168, 7, 112),
                       ("xlstm_125m wq/wk/wv", 1536, 1536, 6, 96)]


def family_cfg(arch, **over):
    from repro_torch.configs.base import get_arch
    return dataclasses.replace(get_arch(arch), **{**FAMILY_ARCHS[arch],
                                                  **over})


def decode_step_bodies(model, check=True, bx=4):
    """{(kernel, body): launches} of one decode step of the packed family
    ``model`` (:func:`step_bodies` of the modules the step runs: an
    encoder-decoder's encoder does not run in decode, and the hybrid's one
    shared block runs once a period); ``bx``: the step's rows (a prefill's
    tokens)."""
    per = step_bodies(model, bx=bx, modules=(model.dec_layers
                                             if hasattr(model, "dec_layers")
                                             else model), check=check)
    if hasattr(model, "shared"):
        n_periods = model.layout(model.cfg)[1]
        for kb, n in step_bodies(model, bx=bx, modules=model.shared,
                                 check=check).items():
            per[kb] += (n_periods - 1) * n
    return per


def family_serve(arch):
    """13a: ``run_serve`` of 4 requests x 8 new tokens on 4 slots, full
    width, packed ``xwT``, backend ``cuda``: every request completes inside
    the true vocab; counted from reset to drain, K1 launches its per-step
    count (:data:`FAMILY_STEP_LAUNCHES`, confirmed from the model's packed
    nodes) x (warm-up + capture), every launch on its bulk body, nothing
    else; the captured graph's nodes launch the same each replay; the
    captured step's logits bit-equal to the eager step's on every tick
    (:func:`graph_vs_eager`); a replay's device time (CUDA events) and
    tokens/s."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.launch.serve import run_serve
    from repro_torch.models.families import build_model
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    cfg = family_cfg(arch)
    t0 = time.time()
    model = build_model(cfg, device=DEVICE, seed=0)
    torch.cuda.synchronize()
    built_s = time.time() - t0
    gb = torch.cuda.memory_allocated() / 1e9
    pack_tree(model)                     # in place, before anything counts
    per_step = decode_step_bodies(model)
    want = FAMILY_STEP_LAUNCHES[arch]
    if per_step != {("demm_xwT", "bulk"): want}:
        raise AssertionError(f"{arch}: the decode step's packed nodes give "
                             f"{per_step}, expected {want} bulk launches")
    requests, max_new = 4, 8
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    with graphs_kept():
        engine = run_serve(model, cfg.vocab_size, packed=True,
                           backend="cuda", requests=requests, slots=4,
                           max_new=max_new, max_len=64, seed=0,
                           device=DEVICE, metrics=obs.MetricsRegistry())
    launches = check_step_counts(        # ... and just after
        "demm_xwT", per_step, CAPTURE_WARMUP + 1, arch)
    if len(engine.completed) != requests or any(
            len(r.output) != max_new
            or not all(0 <= t < cfg.vocab_size for t in r.output)
            for r in engine.completed):
        raise AssertionError(f"{arch}: outputs {[r.output for r in engine.completed]}")
    if not np.isfinite(engine.last_logits[:, :cfg.vocab_size]).all():
        raise AssertionError(f"{arch}: non-finite logits")
    if engine.captures != 1:
        raise AssertionError(f"{arch}: {engine.captures} captures")
    per_replay, nodes = graph_kernel_counts(engine._graph)
    if per_replay != per_step:
        raise AssertionError(f"{arch}: the graph's nodes launch "
                             f"{per_replay}, expected {per_step}")
    tokens = sum(len(r.output) for r in engine.completed)
    entry = {
        "arch": arch, "layers": cfg.num_layers, "build_s": built_s,
        "weights_gb_float32": gb, "ticks": engine.drain_ticks,
        "tokens": tokens, "tokens_per_s": tokens / engine.drain_seconds,
        "decode_step_ms_p50": 1e3 * engine._sk_tok.quantile(0.5),
        "launches": launches, "launches_per_step": want,
        "kernel_nodes_per_replay": nodes,
        "step_device_ms": graph_device_ms(engine._graph)}
    del engine
    entry["graph_vs_eager"] = graph_vs_eager(model, cfg, "--layout xwT")[0]
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return entry


def family_gates():
    """13b: each family at 2-3 layers of full width, float32 compute, in
    the four modes (:data:`FAMILY_GATE_OVER`): the captured step's tokens
    equal the eager step's and backend ``reference``'s, its logits
    bit-equal to the eager step's and allclose (rtol 1e-3) to the
    reference's (:func:`check_graph_modes`).  Returns the report and the
    wrappers' launches over it."""
    import torch
    from repro_torch.configs.base import get_arch
    report = {}
    torch.cuda.synchronize()
    reset_counts()
    for arch, over in FAMILY_GATE_OVER.items():
        report[arch] = check_graph_modes(get_arch(arch), auto=False, **over)
    torch.cuda.synchronize()
    return report, read_counts()


def no_drop(cfg):
    """``cfg`` with room in every expert for every token (capacity factor
    E / k): routing then does not depend on the other tokens of a step."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts
        / cfg.moe.experts_per_token))


def family_paged():
    """13c: the paged engine for the attention-cache families at 2 layers
    of full width (seamless: 2 encoder layers), float32 compute, packed
    xwT, backend ``cuda``: 4 slots, pages of 16, chunks of 32, 5 prompts of
    40-200 tokens, 8 new: the paged engine's tokens equal the dense
    engine's (token-by-token ingest), one capture of each program.
    olmoe's experts get room for every token: with capacity drops, a token's
    output depends on the tokens it shares a step with, and a 32-token
    chunk and a 4-slot decode step share it with others (in the reference
    too).  zamba2 and xlstm refuse ``paged`` with the reference's message."""
    import torch
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.serve import ServeConfig, make_engine

    report = {}
    for arch in PAGED_FAMILIES:
        cfg = no_drop(family_cfg(arch, num_layers=2, compute_dtype="float32",
                                 **FAMILY_GATE_OVER[arch]))
        prompts = paged_prompts(cfg.vocab_size, n=5, seed=3, hi=200)
        model = pack_tree(build_model(cfg, device=DEVICE, seed=1))
        eng = paged_engine(model, max_len=256)
        _, tg = drain_recording(eng, prompts, 8)
        dense = make_engine(model, ServeConfig(num_slots=4, max_len=256),
                            policy=ExecPolicy(mode="packed", backend="cuda"),
                            device=DEVICE, metrics=obs.MetricsRegistry())
        submit_all(dense, prompts, 8)
        dense.run_until_drained()
        td = {r.uid: list(r.output) for r in dense.completed}
        if td != tg or len(tg) != len(prompts):
            raise AssertionError(f"{arch}: paged tokens {tg}, dense {td}")
        if (eng.captures, eng.prefill.captures) != (1, 1):
            raise AssertionError(f"{arch}: captures {eng.captures}, "
                                 f"{eng.prefill.captures}")
        report[arch] = {"streams": len(tg), "paged_equals_dense": True,
                        "prefill_dispatches": eng.prefill.dispatches,
                        "prompt_lengths": [len(p) for p in prompts]}
        del model, eng, dense
        torch.cuda.empty_cache()
    for arch in RECURRENT_FAMILIES:
        cfg = family_cfg(arch, num_layers=FAMILY_GATE_OVER[arch][
            "num_layers"], **{k: v for k, v in FAMILY_GATE_OVER[arch].items()
                             if k != "num_layers"})
        model = build_model(cfg, device=DEVICE, seed=1)
        try:
            paged_engine(pack_tree(model), max_len=64)
        except NotImplementedError as e:
            if "paged KV cache is attention-only" not in str(e):
                raise
            report[arch] = {"paged_refused": str(e)}
        else:
            raise AssertionError(f"{arch}: the paged engine did not refuse")
        del model
        torch.cuda.empty_cache()
    return report


def family_prefill():
    """13d: zamba2 and xlstm at full width: ``prefill`` of a 200-token
    prompt (every packed projection once at 200 rows: K1's wide body in
    bfloat16, its gather body in float32)
    against the dense engine fed the same tokens one by one, the
    reference's own invariant (``tests/test_models_smoke.py``): last logits
    within :data:`FAMILY_PREFILL_GAP_BF16` (relative L2) in bfloat16
    compute for each prompt of :data:`FAMILY_PREFILL_SEEDS`, and allclose
    at rtol 1e-3 (the same greedy token) in float32 compute on the same
    weights for the first.  ``launches``: K1's, as counted in every
    prefill."""
    import torch
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    report = {}
    for arch in RECURRENT_FAMILIES:
        cfg = family_cfg(arch)
        model = pack_tree(build_model(cfg, device=DEVICE, seed=0))
        bodies = decode_step_bodies(model, bx=FAMILY_PREFILL_TOKENS)
        if sum(bodies.values()) != FAMILY_STEP_LAUNCHES[arch]:
            raise AssertionError(f"{arch} prefill: bodies {bodies}, expected "
                                 f"{FAMILY_STEP_LAUNCHES[arch]} launches")
        t0 = time.time()
        gaps, launches = [], 0
        for seed in FAMILY_PREFILL_SEEDS:
            gap, n = prefill_gap(model, cfg, "demm_xwT",
                                 tokens=FAMILY_PREFILL_TOKENS,
                                 per_prefill=bodies,
                                 bound=FAMILY_PREFILL_GAP_BF16, seed=seed)
            gaps.append(gap)
            launches += n
        model.cfg = cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
        gap32, n = prefill_gap(model, cfg32, "demm_xwT", rtol=1e-3,
                               tokens=FAMILY_PREFILL_TOKENS,
                               per_prefill=decode_step_bodies(
                                   model, bx=FAMILY_PREFILL_TOKENS),
                               seed=FAMILY_PREFILL_SEEDS[0])
        report[arch] = {"tokens": FAMILY_PREFILL_TOKENS,
                        "seeds": list(FAMILY_PREFILL_SEEDS),
                        "rel_l2_gap": max(gaps), "rel_l2_gaps": gaps,
                        "rel_l2_gap_float32": gap32,
                        "launches": launches + n, "s": time.time() - t0}
        del model
        torch.cuda.empty_cache()
    return report


def family_train(tmp):
    """13e: ``launch.train.main`` for each family (full width, 6 steps of
    8 x 128 tokens at lr 2e-3: xlstm; reduced, 12 steps of 8 x 64: olmoe,
    zamba2, llama4, internvl2, seamless): the loss finite and falling (the
    launcher's own check), the
    experts' aux loss > 0; then ``launch.serve --ckpt-dir --packed`` of
    the full-width xlstm checkpoint (backend cuda)."""
    import math
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.launch.serve import main as serve_main
    from repro_torch.launch.train import main as train_main

    report = {}
    for arch in FAMILY_ARCHS:
        full = arch in FAMILY_TRAIN_FULL
        ckpt_dir = os.path.join(tmp, arch)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        summary = train_main(["--arch", arch, "--ckpt-dir", ckpt_dir,
                              *FAMILY_TRAIN_ARGS[
                                  "full" if full else "reduced"]])
        del summary["params"]
        gc.collect()
        losses, aux = summary["losses"], summary["aux"]
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"{arch}: losses {losses}")
        if (get_arch(arch).moe is not None) != bool(aux and min(aux) > 0):
            raise AssertionError(f"{arch}: aux {aux}")
        report[arch] = {
            "full_width": full, "n_params": summary["n_params"],
            "losses": losses, "aux": aux,
            "step_seconds": summary["step_seconds"],
            "peak_device_gb": summary["peak_device_bytes"] / 1e9,
            "ckpt_gb": summary["ckpt_bytes"] / 1e9,
            "ckpt_save_seconds": summary["ckpt_save_seconds"],
            "s": time.time() - t0}
        if arch != "xlstm_125m":
            shutil.rmtree(ckpt_dir, ignore_errors=True)
        log(f"[13e family train] {arch} ({report[arch]['s']:.1f} s): "
            f"{json.dumps(report[arch])}")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    reset_counts()
    engine = serve_main(["--arch", "xlstm_125m", "--full", "--ckpt-dir",
                         os.path.join(tmp, "xlstm_125m"), "--packed",
                         "--requests", "4", "--max-new", "8", "--backend",
                         "cuda"])
    counts = read_counts()
    if len(engine.completed) != 4 or counts["demm_xwT"] != \
            FAMILY_STEP_LAUNCHES["xlstm_125m"] * 2:
        raise AssertionError(f"13e: the checkpoint served "
                             f"{len(engine.completed)} requests, launches "
                             f"{counts}")
    report["serve_xlstm_ckpt"] = {
        "requests": 4, "launches": counts["demm_xwT"],
        "tokens": {r.uid: list(r.output) for r in engine.completed}}
    return report


def family_phase():
    """Phase 13 in full; returns the ``families`` report."""
    import tempfile
    t13 = time.time()
    report = {"serve": {}}
    for arch in FAMILY_ARCHS:
        t0 = time.time()
        report["serve"][arch] = family_serve(arch)
        log(f"[13a family serve] {arch} --layout xwT ({time.time() - t0:.1f}"
            f" s): {json.dumps(report['serve'][arch])}")
    t0 = time.time()
    report["gates"], report["gate_launches"] = family_gates()
    log(f"[13b family gates] graph vs eager vs reference, 2-5 layers "
        f"float32, four modes ({time.time() - t0:.1f} s): "
        f"{json.dumps(report['gates'])}; launches "
        f"{json.dumps(report['gate_launches'])}")
    t0 = time.time()
    report["paged"] = family_paged()
    log(f"[13c family paged] paged vs dense, 2 layers float32 "
        f"({time.time() - t0:.1f} s): {json.dumps(report['paged'])}")
    t0 = time.time()
    report["prefill"] = family_prefill()
    log(f"[13d family prefill] {FAMILY_PREFILL_TOKENS} tokens vs token by "
        f"token, full width ({time.time() - t0:.1f} s): "
        f"{json.dumps(report['prefill'])}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_family_train_")
    try:
        t0 = time.time()
        report["train"] = family_train(tmp)
        log(f"[13e family train] ({time.time() - t0:.1f} s): xlstm "
            f"checkpoint served: "
            f"{json.dumps(report['train']['serve_xlstm_ckpt'])}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    report["seconds"] = time.time() - t13
    return report


def family_times(gen):
    """Phase 7f: K1-K4 at :data:`FAMILY_TIMED_SHAPES`, Bx = 4, bf16 x, as
    :func:`time_shape` times them; returns {kernel: {label: row}}."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig

    out = {name: {} for name in KERNELS[:4]}
    for label, o, k, n, m in FAMILY_TIMED_SHAPES:
        x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen)
        cfg = SparsityConfig(n, m)
        rows = time_xwt(x, vals, idx, q, scales, cfg, meta)
        dense, blocks = time_block(x, vals, idx, cfg, meta)
        rows.update(blocks)
        lib = library_ms(x, dense)
        for name in out:
            row = next(e for e in rows[name]
                       if e.get("scales", "per_row") == "per_row")
            out[name][label] = {**row, "library_ms": lib}
        del dense, x, vals, idx, q, scales
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 14: distribution — the sharded packed matmul, TP = 2 and PP = 2
# worlds of two ranks on the one card, and engine replicas
# ---------------------------------------------------------------------------

# stablelm_3b's row-parallel projections, and wq as the column-parallel one
DIST_ROW_SHAPES = [("wo", 2560, 2560, 5, 80), ("down", 2560, 6912, 3, 48)]
DIST_COL_SHAPE = ("wq", 2560, 2560, 5, 80)
# 14c: the pipeline at full width and this many layers (two stages of 4)
DIST_PP_LAYERS = 8
# the parent's limit on the spawned world (both ranks joined within it)
DIST_TIMEOUT_S = 420
# phase 4's run, which 14b repeats under the plan
PHASE4_RUN = dict(requests=4, slots=4, max_new=8, max_len=64, seed=0)
# 14b / 14c's bound on the relative L2 gap between a rank's logits and the
# single rank's, at every sampled token up to and including the first one
# where the two streams differ (until then both decode the same sequence):
# in bfloat16 compute the row-parallel sums and the shard-local launches
# round in another order through 32 layers, the same kind of gap as
# PREFILL_GAP_BF16's; a wrong slice or a lost partial sum gives a gap of
# order 1
DIST_LOGITS_GAP = 5e-2


def phase4_prompts(vocab, requests=4, seed=0):
    """The prompts ``run_serve`` draws for phase 4 (the same numpy calls in
    the same order)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, rng.integers(4, 12), dtype=np.int32)
            for _ in range(requests)]


def packed_bytes(pw) -> int:
    return sum(t.nbytes for t in (pw.values, pw.indices, pw.active_groups,
                                  pw.scales) if t is not None)


def col_block(pw, rank, tp):
    """Rank ``rank``'s column-parallel block of ``pw`` (its output rows: the
    row blocks of the block layout), as ``ShardingPlan.shard_params`` keeps
    it."""
    o, k = pw.dense_shape
    n = pw.values.shape[0] // tp

    def take(t):
        return None if t is None else t[rank * n:(rank + 1) * n].clone()

    return pw.replace(values=take(pw.values), indices=take(pw.indices),
                      active_groups=take(pw.active_groups),
                      scales=take(pw.scales), dense_shape=(o // tp, k),
                      has_duplicates=pw.has_duplicates)


def local_entry(name, label, kind, tp, local, x, gen):
    """A shard-local launch timed: K1-K4 on ``local`` (a rank's slice) over
    a ring of its copies larger than L2, its plain version, the bound of the
    bytes the launch moves, and one bf16 ``torch.matmul`` against the local
    dense slice."""
    from repro_torch.kernels import ops

    bx, k = x.shape
    o = local.dense_shape[0]
    nbytes = packed_bytes(local) + x.nbytes + bx * o * 4
    nnz = o * (k // local.cfg.m) * local.cfg.n_effective
    copies = [local.replace(**{n: t.clone() for n, t in (
        ("values", local.values), ("indices", local.indices),
        ("active_groups", local.active_groups), ("scales", local.scales))
        if t is not None}, has_duplicates=False)
        for _ in range(ring_size(packed_bytes(local)))]
    kern = [lambda c=c: ops.demm_matmul_packed(x, c, "cuda") for c in copies]
    plain = [lambda c=c: ops.demm_matmul_packed(x, c, "reference")
             for c in copies]
    meta = {"kernel": name, "shape": label, "split": kind, "tp": tp,
            "O": o, "K": k,
            "pattern": local.cfg.pattern_name(), "Bx": bx,
            "x_dtype": "bfloat16"}
    entry = timed_entry(meta, kern, plain, nbytes, 2 * bx * nnz)
    entry["library_ms"] = library_ms(x, local.to_dense())
    del copies
    return entry


def dist_matmul(gen):
    """14a: ``ops._demm_matmul_sharded`` with no group in the context (the
    meshless sequential sum over the slices) at stablelm_3b's row-parallel
    shapes, tp 2 and 4, x of 4 and 32 rows in float32 and bfloat16: K1, K3
    and K2 on renumbered slices against the plain versions of the same
    slices and against the unsharded kernel, each within phase 3's
    tolerance; K1-K4 on column-parallel blocks of wq against the rows of the
    whole product; each block weight's per-shard a_max; and one
    shard-local launch at tp 2 timed against its byte bound and a bf16
    matmul of the local dense slice."""
    import torch
    from repro_torch.core.sparsity import (PackedWeight, SparsityConfig,
                                           pack_block,
                                           shard_packed_row_parallel,
                                           shard_slice)
    from repro_torch.kernels import ops
    from repro_torch.quant import quantize_packed
    from repro_torch.sharding.context import get_context

    if get_context() is not None:
        raise AssertionError("14a runs with no sharding context")
    err = {name: 0.0 for name in KERNELS[:4]}
    cases, a_max, timed = 0, {}, []

    def check(name, got, want, dtype, what):
        nonlocal cases
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, **TOL[dtype],
                                   msg=lambda m: f"14a {name} {what}: {m}")
        err[name] = max(err[name], float((got - want).abs().max()))
        cases += 1

    def weights(o, k, n, m, block_q8):
        dense = make_dense(o, k, n, m, gen)
        cfg = SparsityConfig(n, m)
        xwt = PackedWeight.from_dense(dense, cfg)
        out = {"demm_xwT": xwt, "demm_xwT_q8": quantize_packed(xwt),
               "demm_block_spmm": pack_block(dense, cfg)}
        if block_q8:
            out["demm_block_spmm_q8"] = quantize_packed(pack_block(dense,
                                                                   cfg))
        return out

    xs = {}
    for label, o, k, n, m in DIST_ROW_SHAPES:
        for name, pw in weights(o, k, n, m, False).items():
            for tp in (2, 4):
                sh = shard_packed_row_parallel(pw, tp)
                if pw.block_geom is not None:
                    a_max[f"{label} tp{tp}"] = {
                        "whole": pw.block_geom[1],
                        "per_shard": sh.block_geom[1],
                        "groups_per_shard": pw.groups // tp}
                for bx in (4, 32):
                    for dtype in ("float32", "bfloat16"):
                        x = torch.randn((bx, k), generator=gen,
                                        device=DEVICE).to(getattr(torch,
                                                                  dtype))
                        got = ops._demm_matmul_sharded(x, sh, "cuda")
                        what = f"{label} tp{tp} Bx{bx} {dtype}"
                        check(name, got, ops._demm_matmul_sharded(
                            x, sh, "reference"), dtype, what + " vs plain")
                        check(name, got, ops.demm_matmul_packed(
                            x, pw, "cuda"), dtype, what + " vs unsharded")
                        if tp == 2 and bx == 4 and dtype == "bfloat16":
                            xs[label] = x
                if tp == 2:
                    timed.append(local_entry(
                        name, label, "row", 2, shard_slice(sh, 0),
                        xs[label][:, :k // 2].contiguous(), gen))
    label, o, k, n, m = DIST_COL_SHAPE
    for name, pw in weights(o, k, n, m, True).items():
        for bx in (4, 32):
            for dtype in ("float32", "bfloat16"):
                x = torch.randn((bx, k), generator=gen,
                                device=DEVICE).to(getattr(torch, dtype))
                whole = ops.demm_matmul_packed(x, pw, "cuda")
                for r in range(2):
                    blk = col_block(pw, r, 2)
                    got = ops.demm_matmul_packed(x, blk, "cuda")
                    what = f"{label} col rank {r} Bx{bx} {dtype}"
                    check(name, got, ops.demm_matmul_packed(
                        x, blk, "reference"), dtype, what + " vs plain")
                    check(name, got, whole[:, r * o // 2:(r + 1) * o // 2],
                          dtype, what + " vs whole")
                if bx == 4 and dtype == "bfloat16":
                    xs[label] = x
        timed.append(local_entry(name, label, "col", 2, col_block(pw, 0, 2),
                                 xs[label], gen))
    torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": err, "a_max": a_max,
            "tp2_local": timed}


def dist_runs():
    """(label, config, layout, plan) of the legs the two-rank world serves:
    TP = 2 in both layouts in bfloat16 compute (phase 4's mode) and in
    float32, PP = 2 at 8 layers in float32."""
    import dataclasses
    from repro_torch.configs.base import get_arch
    from repro_torch.sharding.plan import ShardingPlan

    cfg = get_arch("stablelm_3b")
    f32 = dataclasses.replace(cfg, compute_dtype="float32")
    return [(f"tp2 --layout {layout}{tag}", c, layout, ShardingPlan(tp=2))
            for tag, c in (("", cfg), (" float32", f32))
            for layout in ("xwT", "block")] + [
        ("pp2 --layout xwT float32",
         dataclasses.replace(f32, num_layers=DIST_PP_LAYERS), "xwT",
         ShardingPlan(pp=2))]


class LogitsRecorder:
    """Wraps an engine's sampler and keeps the logits row (over the true
    vocab) of every token it samples, per request, in order."""

    def __init__(self, inner, vocab):
        self.inner, self.vocab, self.rows = inner, vocab, {}

    def sample(self, logits, uid, pos):
        import numpy as np
        self.rows.setdefault(uid, []).append(
            np.array(logits[:self.vocab], dtype=np.float32))
        return self.inner.sample(logits, uid, pos)


def serve_recorded(c, layout, plan, device):
    """Phase 4's run of ``c`` (built from seed 0, packed ``layout``, phase
    4's prompts on 4 slots) through ``make_engine`` on ``device`` under
    ``plan`` (None: one rank, a captured step), every sampled token's
    logits kept.  The wrappers' counts are reset just before the engine is
    built and read just after its drain.  Returns (the drained engine, a
    dict of what the run measured, with ``rows``: the logits per request).
    Memory is counted from just before the model is built: ``placed_gb``
    what the engine holds once built, ``serve_peak_gb`` the peak from then
    to the end of the drain."""
    import torch

    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.serve import Request, ServeConfig, make_engine

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    t0 = time.time()
    model = pack_tree(build_model(c, device=device, seed=0), layout=layout)
    whole = {n: packed_bytes(m) for n, m in model.named_modules()
             if hasattr(m, "dense_shape")}
    torch.cuda.synchronize()
    reset_counts()                   # just before the main path ...
    eng = make_engine(model, ServeConfig(
        num_slots=PHASE4_RUN["slots"], max_len=PHASE4_RUN["max_len"]),
        policy=ExecPolicy(mode="packed", backend="cuda", plan=plan),
        device=device, metrics=obs.MetricsRegistry())
    del model
    rec = eng.sampler = LogitsRecorder(eng.sampler, c.vocab_size)
    for uid, prompt in enumerate(phase4_prompts(c.vocab_size)):
        eng.submit(Request(uid=uid, prompt=prompt,
                           max_new_tokens=PHASE4_RUN["max_new"]))
    torch.cuda.synchronize()
    placed = torch.cuda.memory_allocated(device) - base
    torch.cuda.reset_peak_memory_stats(device)
    t1 = time.time()
    ticks = eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.time() - t1
    counts, bodies = read_counts(), read_body_counts()   # ... after
    caches = eng.state["caches"]
    return eng, {
        "outputs": {r.uid: list(r.output) for r in eng.completed},
        "rows": rec.rows, "whole_packed": whole,
        "ticks": ticks, "serve_s": serve_s,
        "tokens_per_s": sum(len(r.output) for r in eng.completed) / serve_s,
        "build_pack_s": t1 - t0, "launches": counts,
        "launches_by_body": bodies,
        "kv_cache_gb": (caches["k"].nbytes + caches["v"].nbytes) / 1e9,
        "placed_gb": placed / 1e9,
        "serve_peak_gb": (torch.cuda.max_memory_allocated(device) - base)
        / 1e9}


def dist_rank(rank, nprocs, init):
    """One rank of 14b / 14c on the card: joins the two-rank ``gloo`` world
    (both ranks on cuda:0), loads the kernel library once per world, then
    serves each leg of :func:`dist_runs` (:func:`serve_recorded`)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.kernels._build import load_library_once
    from repro_torch.sharding.world import init_world

    world = init_world("cuda", rank=rank, world_size=nprocs,
                       init_method=init)
    t0 = time.time()
    load_library_once()
    out = {"rank": world.rank, "backend": world.backend,
           "device": str(world.device), "library_s": time.time() - t0}
    for label, c, layout, plan in dist_runs():
        eng, e = serve_recorded(c, layout, plan, world.device)
        whole = e.pop("whole_packed")
        if eng._use_graph or eng._graph is not None or not eng.multi_rank:
            raise AssertionError(f"{label}: a multi-rank engine must step "
                                 "eagerly")
        held = {n: (getattr(m, "tp_kind", None), packed_bytes(m))
                for n, m in eng.model.named_modules()
                if hasattr(m, "dense_shape")}
        row = [n for n, (kind, _) in held.items() if kind == "row"]
        out[label] = dict(
            e,
            row_parallel_gb={"rank": sum(held[n][1] for n in row) / 1e9,
                             "whole": sum(whole[n] for n in row) / 1e9},
            packed_gb={"rank": sum(b for _, b in held.values()) / 1e9,
                       "whole": sum(whole.values()) / 1e9},
            layers_held=sum(type(m).__name__ == "TBlock"
                            for m in eng.model.layers),
            finite=bool(np.isfinite(
                eng.last_logits[:, :c.vocab_size]).all()),
            labels=eng._trace_labels())
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


def dist_replicas(single):
    """14d: phase 4's model (built and packed xwT again from its seed) under
    two replicas of a captured engine sharing its tensors behind the router
    (``make_engine(replicas=2)``), phase 4's prompts routed round-robin:
    each replica captures its own step, the wrappers launch 7 x 32 x
    (warm-up + capture) per replica, and every request's tokens equal the
    single engine's (``single``: phase 4's outputs)."""
    import torch
    from repro_torch.configs.base import get_arch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.serve import (ReplicaRouter, Request, ServeConfig,
                                   make_engine)
    from repro_torch.serve.serve_loop import CAPTURE_WARMUP

    cfg = get_arch("stablelm_3b")
    model = pack_tree(build_model(cfg, device=DEVICE, seed=0), layout="xwT")
    torch.cuda.synchronize()
    reset_counts()                       # just before the main path ...
    router = make_engine(model, ServeConfig(
        num_slots=PHASE4_RUN["slots"], max_len=PHASE4_RUN["max_len"]),
        policy=ExecPolicy(mode="packed", backend="cuda"), device=DEVICE,
        replicas=2)
    if not isinstance(router, ReplicaRouter):
        raise AssertionError("replicas=2 did not build a router")
    for uid, prompt in enumerate(phase4_prompts(cfg.vocab_size)):
        router.submit(Request(uid=uid, prompt=prompt,
                              max_new_tokens=PHASE4_RUN["max_new"]))
    ticks = router.run_until_drained()
    launches = check_step_counts(        # ... and just after
        "demm_xwT", {("demm_xwT", "bulk"): 7 * cfg.num_layers},
        2 * (CAPTURE_WARMUP + 1), "14d replicas")
    got = {r.uid: list(r.output) for r in router.completed}
    if got != single:
        raise AssertionError(f"14d: replicas' tokens {got} != the single "
                             f"engine's {single}")
    captures = [e.captures for e in router.replicas]
    if captures != [1, 1]:
        raise AssertionError(f"14d: captures per replica {captures}")
    snap = router.metrics.snapshot(meta=False)
    routed = [e["value"] for e in snap["counters"]
              if e["name"] == "serve_router_requests_total"]
    out = {"ticks": ticks, "launches": launches, "captures": captures,
           "routed": routed, "uids_per_replica": [
               sorted(r.uid for r in e.completed) for e in router.replicas],
           "tokens_equal_single": True}
    del router, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def log_dist(dist, smi):
    """Phase 14's report lines."""
    log(f"[14d replicas] make_engine(replicas=2) on phase 4's model: "
        f"{json.dumps(dist['replicas'])}")
    m = dist["matmul"]
    log(f"[14a dist matmul] _demm_matmul_sharded with no group, {m['cases']} "
        f"comparisons held ({m['seconds']:.1f} s); max abs err "
        f"{json.dumps(m['max_abs_err'])}; block a_max whole / per shard: "
        f"{json.dumps(m['a_max'])}")
    log("[14a dist matmul] kernel | shape | split | O x K local | Bx | ms | "
        "bound ms | plain ms | bf16 matmul ms (local dense)")
    for e in m["tp2_local"]:
        log(f"[14a dist matmul] {e['kernel']} | {e['shape']} | {e['split']} "
            f"| {e['O']} x {e['K']} | {e['Bx']} | {e['ms']:.4f} | "
            f"{e['bound_ms']:.4f} | {e['plain_ms']:.4f} | "
            f"{e['library_ms']:.4f}")
    for r in dist["ranks"]:
        for label, _, _, _ in dist_runs():
            e = {k: v for k, v in r[label].items() if k != "outputs"}
            log(f"[14{'b' if label.startswith('tp') else 'c'} dist] rank "
                f"{r['rank']} ({r['backend']}, {r['device']}) {label}: "
                f"{json.dumps(e)}")
    for label, a in dist["agreement"].items():
        log(f"[14 dist] {label} rank 0 against one rank (logits gap bound "
            f"{DIST_LOGITS_GAP}): {json.dumps(a)}")
    log(f"[14 dist] memory GB (KV cache, held once placed, peak from the "
        f"build through the drain): {json.dumps(dist['memory_gb'])}")
    log(f"[14 dist] float32 legs: tokens equal the single rank's; every "
        f"leg: both ranks' streams and logits equal, logits within "
        f"{DIST_LOGITS_GAP} of one rank's up to the first differing token; "
        f"one rank {dist['single_seconds']:.1f} s, world "
        f"{dist['world_seconds']:.1f} s, phase {dist['seconds']:.1f} s in "
        f"all; {smi}")


def logits_agreement(got, want, rows, want_rows):
    """A rank's streams ``got`` and logits ``rows`` against the single
    rank's: for each request the first token where they differ (None:
    none), the relative L2 gap of the logits at every sampled token up to
    and including it, and there the single rank's margin between its token
    and the rank's (``margin``) beside the largest logit difference of that
    step (``max_abs_diff``)."""
    import numpy as np

    out = {}
    for u in want:
        first = next((i for i, (a, b) in enumerate(zip(got[u], want[u]))
                      if a != b), None)
        steps = len(want[u]) if first is None else first + 1
        gaps = [float(np.linalg.norm(rows[u][j] - want_rows[u][j])
                      / np.linalg.norm(want_rows[u][j]))
                for j in range(steps)]
        e = {"first_difference": first, "max_gap": max(gaps)}
        if first is not None:
            lw = want_rows[u][first]
            e["margin"] = float(lw[want[u][first]] - lw[got[u][first]])
            e["max_abs_diff"] = float(np.abs(rows[u][first] - lw).max())
            e["logit_rms"] = float(np.sqrt(np.mean(lw ** 2)))
        out[u] = e
    return out


def dist_phase(gen, single):
    """Phase 14.  ``single``: phase 4's outputs per mode."""
    import gc

    import torch
    from repro_torch.sharding.world import spawn_world

    t_all = time.time()
    t0 = time.time()
    out = {"matmul": dist_matmul(gen)}
    out["matmul"]["seconds"] = time.time() - t0
    t0 = time.time()
    out["replicas"] = dist_replicas(single["tp2 --layout xwT"])
    out["replicas"]["seconds"] = time.time() - t0
    # each leg's model served on one rank (a captured step), its logits
    # kept; the bfloat16 legs' tokens are phase 4's
    t0 = time.time()
    ref = {}
    for label, c, layout, _ in dist_runs():
        eng, ref[label] = serve_recorded(c, layout, None, DEVICE)
        if label in single and ref[label]["outputs"] != single[label]:
            raise AssertionError(
                f"14 {label}: one rank's tokens {ref[label]['outputs']} "
                f"!= phase 4's {single[label]}")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    out["single_seconds"] = time.time() - t0
    t0 = time.time()
    ranks = spawn_world(dist_rank, 2, timeout_s=DIST_TIMEOUT_S)
    out["world_seconds"] = time.time() - t0
    out["agreement"], out["memory_gb"] = {}, {}
    for label, c, layout, _ in dist_runs():
        kernel = "demm_block_spmm" if layout == "block" else "demm_xwT"
        want = ref[label]["outputs"]
        if ranks[0][label]["outputs"] != ranks[1][label]["outputs"]:
            raise AssertionError(f"14 {label}: the ranks' streams differ")
        for u, rows in ranks[0][label]["rows"].items():
            if any((a != b).any() for a, b in zip(
                    rows, ranks[1][label]["rows"][u])):
                raise AssertionError(f"14 {label}: the ranks' logits "
                                     "differ")
        tp = label.startswith("tp")
        for r in ranks:
            e = r[label]
            got = e["outputs"]
            if c.compute_dtype == "float32" and got != want:
                raise AssertionError(
                    f"14 {label} rank {r['rank']}: tokens {got} != the "
                    f"single rank's {want}")
            agree = logits_agreement(got, want, e.pop("rows"),
                                     ref[label]["rows"])
            for u, a in agree.items():
                if not a["max_gap"] <= DIST_LOGITS_GAP:
                    raise AssertionError(
                        f"14 {label} rank {r['rank']} request {u}: logits "
                        f"gap {a['max_gap']} to the single rank's, more "
                        f"than {DIST_LOGITS_GAP}")
                if "margin" in a and not \
                        0 <= a["margin"] <= 2 * a["max_abs_diff"]:
                    raise AssertionError(
                        f"14 {label} rank {r['rank']} request {u}: the "
                        f"tokens differ at margin {a['margin']}, beyond "
                        f"twice the logits' difference {a['max_abs_diff']}")
            if r["rank"] == 0:
                out["agreement"][label] = {
                    "requests_equal": sum(got[u] == want[u] for u in want),
                    "requests": len(want), "per_request": agree}
            if not e["finite"]:
                raise AssertionError(f"14 {label}: non-finite logits")
            layers = c.num_layers // (1 if tp else 2)
            # every tick runs the eager step: 7 projections a layer; under
            # pp each stage runs its layers once per microbatch (2 a step)
            per_tick = 7 * layers * (1 if tp else 2)
            expect = {n: 0 for n in KERNELS}
            expect[kernel] = per_tick * e["ticks"]
            if e["launches"] != expect:
                raise AssertionError(
                    f"14 {label} rank {r['rank']}: launches "
                    f"{e['launches']}, expected {expect}")
            gb = e["row_parallel_gb"]
            if tp and not 0 < gb["rank"] < gb["whole"]:
                raise AssertionError(f"14 {label}: rank holds {gb}")
            if tp and layout == "xwT" and \
                    abs(gb["rank"] - gb["whole"] / 2) > 1e-9:
                raise AssertionError(f"14 {label}: row-parallel bytes {gb} "
                                     "are not half the whole's")
            if not tp and e["layers_held"] != DIST_PP_LAYERS // 2:
                raise AssertionError(f"14 {label}: rank holds "
                                     f"{e['layers_held']} layers")
            # the rank's KV cache is half the single rank's (heads over
            # tp, layers over pp), and its memory from the model's build
            # on, once placed, peaks below the single rank's
            one = ref[label]
            if abs(2 * e["kv_cache_gb"] - one["kv_cache_gb"]) > 1e-9:
                raise AssertionError(
                    f"14 {label} rank {r['rank']}: KV cache "
                    f"{e['kv_cache_gb']} GB, the single rank's "
                    f"{one['kv_cache_gb']} GB")
            if not e["serve_peak_gb"] < one["serve_peak_gb"]:
                raise AssertionError(
                    f"14 {label} rank {r['rank']}: peak {e['serve_peak_gb']}"
                    f" GB after placement, the single rank's "
                    f"{one['serve_peak_gb']} GB")
            out["memory_gb"].setdefault(label, {
                "single": {k: one[k] for k in ("kv_cache_gb", "placed_gb",
                                               "serve_peak_gb")}})[
                f"rank{r['rank']}"] = {
                k: e[k] for k in ("kv_cache_gb", "placed_gb",
                                  "serve_peak_gb")}
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("two ranks on one card must take gloo")
    out["ranks"] = ranks
    out["seconds"] = time.time() - t_all
    return out


# ---------------------------------------------------------------------------
# phase 15: distributed training, one world of four ranks (tp 2 x dp 2) on
# the one card
# ---------------------------------------------------------------------------

# 15a / 15b: stablelm_3b at full width and this many of its 32 layers (four
# ranks' training state at full depth does not fit one card; 2 since phase
# 18 came, for the script's time limit), float32
DT_LAYERS = 2
# the global batch (rows x tokens), microbatches a dp rank, steps
DT_BATCH, DT_SEQ, DT_MICRO, DT_STEPS = 4, 128, 2, 3
DT_OPT = dict(lr=1e-3, total_steps=10, warmup_steps=1)
# 15c: olmoe_1b_7b at full width and 2 of its 16 layers
DT_MOE_LAYERS = 2
# 15d: the reference test's toy stages (its sizes) over the four ranks
DT_PIPE = dict(num_mb=4, mb=2, d=16)
DT_RANKS = 4
DT_TIMEOUT_S = 300
# written into the phase's directory once the one-rank runs are done and
# the card is free: the ranks start up meanwhile and wait for it
DT_READY = "one_rank_done"
# loss and grad_norm against one rank's (relative); the parameters within
# 2 x lr x steps (AdamW's first steps are about lr x sign(g), and a gradient
# near 0 may flip under another reduction order); the packed values'
# gradients (relative L2); the pipeline (float32)
DT_REL, DT_PACKED_REL, DT_PIPE_TOL = 1e-5, 1e-5, 1e-5
# 15g: every family, the head fallbacks and int8 fake quantization under tp
# 2 x dp 2, DT_FAMILY_STEPS masked steps each (the first at the warmup's lr
# of 0) at full width and cut depth (label -> arch,
# config overrides, plan keywords, step keywords): zamba2 6 of its 81
# layers (one period of 6 Mamba2 layers, split by heads, and the shared
# block), xlstm 4 of 12 (one period: 3 mLSTM split by heads, 1 sLSTM
# whole), internvl2 2 of 24 (its patch projection gathered), seamless 2 of
# 12 decoder layers and 1 of 12 encoder layers, stablelm_3b at DT_LAYERS
# with one KV head (k / v gathered, read in part), with wk / wv replicated,
# and with ``fake_quant="int8"`` (a row-parallel weight's per-row scale the
# max over the whole row)
DT_FAMILY_LEGS = {
    "zamba2_7b": ("zamba2_7b", {"num_layers": 6}, {}, {}),
    "xlstm_125m": ("xlstm_125m", {"num_layers": 4}, {}, {}),
    "internvl2_1b": ("internvl2_1b", {"num_layers": 2}, {}, {}),
    "seamless_m4t_medium": ("seamless_m4t_medium",
                            {"num_layers": 2, "encoder_layers": 1}, {}, {}),
    "kv1": ("stablelm_3b", {"num_layers": DT_LAYERS, "num_kv_heads": 1},
            {}, {}),
    "kv_replicated": ("stablelm_3b", {"num_layers": DT_LAYERS},
                      {"attn_kv_replicated": True}, {}),
    "fake_quant": ("stablelm_3b", {"num_layers": DT_LAYERS}, {},
                   {"fake_quant": "int8"}),
}
# 15h: a pod 2 x data 1 x model 2 mesh (dp over pod x data): 15a's model,
# one step, and one packed decode tick of DT_POD_ROWS slots (each dp rank
# its rows) against the same tick of one rank
DT_POD_MESH = ((2, 1, 2), ("pod", "data", "model"))
DT_POD_ROWS, DT_POD_LEN = 4, 16


def dt_cfgs():
    """(15a/15b's stablelm_3b, 15c's olmoe_1b_7b with room for every
    token), float32 compute."""
    from repro_torch.configs.base import get_arch

    lm = dataclasses.replace(get_arch("stablelm_3b"), num_layers=DT_LAYERS,
                             compute_dtype="float32")
    moe = get_arch("olmoe_1b_7b")
    moe = dataclasses.replace(
        moe, num_layers=DT_MOE_LAYERS, compute_dtype="float32",
        moe=dataclasses.replace(moe.moe, capacity_factor=(
            moe.moe.num_experts / moe.moe.experts_per_token)))
    return lm, moe


def dt_batch(cfg, step):
    """The global batch of ``step``: the reference's Markov tokens
    (``data.pipeline.global_batch``), the same on every rank, and the stub
    frontends' inputs (``launch.train.add_frontend_inputs``, numpy seeded by
    the step)."""
    import numpy as np
    from repro_torch.data.pipeline import DataConfig, global_batch
    from repro_torch.launch.train import add_frontend_inputs
    batch = global_batch(DataConfig(vocab_size=cfg.vocab_size,
                                    seq_len=DT_SEQ, global_batch=DT_BATCH),
                         step)
    return add_frontend_inputs(cfg, batch, np.random.default_rng(step))


DT_FAMILY_STEPS = 2
# 15g holds, of every leaf of a leg's first block and of its frontend's
# projection (DT_CHECKED), the rank's block of the AdamW first moment m (the
# steps' clipped gradients) norm-wise within DT_MOMENT_REL of the one
# rank's, and of the update the steps made within DT_UPDATE_REL.  The
# moments round in another order on the card (a rank's GEMMs have half the
# rows and heads): 3.0e-6 to 6.7e-5 over the seven legs' blocks on an H100
# 80GB HBM3 at 700 W, a ZeRO-1 block of a small vector (A_log, a norm's
# scale) among the largest; 1e-5 on the CPU.  The update divides a
# gradient's rounding by AdamW's eps where the gradient is near 0 (4.0e-4
# at most there).  A wrong sign, a missed sum or no update is off by 0.1 to
# 1 or more.
DT_CHECKED = (r"^(layers|periods|enc_layers|dec_layers)\.0\."
              r"|^(patch|frame)_proj\.w$")
DT_MOMENT_REL, DT_UPDATE_REL = 2e-4, 1e-2


def dt_norm_rel(got, want) -> float:
    """||got - want|| / ||want|| of a tensor on the card and a numpy array
    (float64, on the card; 0 where both are 0)."""
    import numpy as np
    import torch
    want = torch.from_numpy(np.ascontiguousarray(want)).to(got.device,
                                                          torch.float64)
    num = float((got.to(torch.float64) - want).norm())
    return 0.0 if num == 0 else num / max(float(want.norm()), 1e-30)


def dt_checked(params: dict) -> dict:
    """15g's checked leaves of ``params``, as copies (DT_CHECKED)."""
    import re
    return {n: t.detach().clone() for n, t in params.items()
            if re.search(DT_CHECKED, n)}


def dt_family_cfg(label):
    """15g's config of the leg ``label``, float32 compute."""
    from repro_torch.configs.base import get_arch
    arch, over, _, _ = DT_FAMILY_LEGS[label]
    return dataclasses.replace(get_arch(arch), compute_dtype="float32",
                               **over)


def dt_steps(model, cfg, *, plan=None, micro=DT_MICRO, first=0,
             steps=DT_STEPS, compression=None, opt_state=None,
             fake_quant=None):
    """``steps`` masked train steps from ``first``; returns (per step
    [loss, grad_norm], seconds of each step, the params, the opt state, the
    step)."""
    import torch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step, train_params

    opt_cfg = adamw.AdamWConfig(**DT_OPT, compression=compression)
    step = make_train_step(model, opt_cfg, num_microbatches=micro, plan=plan,
                           policy=ExecPolicy(mode="masked"),
                           fake_quant=fake_quant)
    params = train_params(model)
    opt = (adamw.init(opt_cfg, params, layout=step.layout)
           if opt_state is None else opt_state)
    metrics, secs = [], []
    for s in range(first, first + steps):
        torch.cuda.synchronize()
        t0 = time.time()
        params, opt, m = step(params, opt, dt_batch(cfg, s), s)
        metrics.append([float(m["loss"]), float(m["grad_norm"])])
        secs.append(time.time() - t0)
    return metrics, secs, params, opt, step


def dt_save(tensors: dict, d):
    """Each tensor as ``<d>/<name>.npy`` on the host (the ranks map them)."""
    import numpy as np
    os.makedirs(d, exist_ok=True)
    for n, t in tensors.items():
        np.save(os.path.join(d, n + ".npy"), t.detach().cpu().numpy())


def dt_block(d, name, lay):
    """This rank's block under the TrainLayout ``lay`` of the one rank's
    tensor ``name`` kept under ``d`` (memory-mapped).  A renumbered
    row-parallel weight's shard stack holds the one rank's xwT (O, G, Ne)
    groups in tp runs: the one rank's tensor is cut into that stack
    first."""
    import numpy as np
    arr = np.load(os.path.join(d, name + ".npy"), mmap_mode="r")
    if lay.split(name) and lay.placement[name][1]:
        arr = np.stack(np.split(arr, lay.ctx.tp, axis=1))
    return np.array(lay.block_of(name, arr))


def dt_held_equal(ck, state, lay):
    """Whether every leaf of ``state`` (``{"params": ...}`` and, if there,
    ``"opt"``'s moments) is bit-equal to its block under the TrainLayout
    ``lay`` of the whole leaf in the checkpoint at ``ck``."""
    import numpy as np
    import torch

    saved = os.path.join(ck, f"step_{DT_STEPS:08d}")
    trees = [("params", state["params"], False)]
    if "opt" in state:
        trees += [("opt__m", state["opt"].m, True),
                  ("opt__v", state["opt"].v, True)]
    equal = True
    for kind, tree, moment in trees:
        for n, t in tree.items():
            arr = np.load(os.path.join(saved, f"{kind}__" + n.replace(
                ".", "__") + ".npy"), mmap_mode="r")
            want = np.array(lay.block_of(n, arr, moment))
            equal &= tuple(t.shape) == want.shape and bool(torch.equal(
                t, torch.from_numpy(want).to(t.device)))
    return equal


def dt_free():
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def dt_single(tmp):
    """The one-rank runs in this process, before the world starts (their
    tensors go to ``tmp`` and the card is freed): 15a's steps and its int8
    step, 15b's gradients at the packed values (K1 counted), 15c's step."""
    import torch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.optim import adamw
    from repro_torch.train.train_loop import make_train_step, train_params

    lm, moe = dt_cfgs()
    out = {}
    torch.cuda.reset_peak_memory_stats()
    model = build_model(lm, device=DEVICE, seed=0)
    m, secs, params, opt, _ = dt_steps(model, lm)
    out["a"] = {"metrics": m, "step_s": secs,
                "moment_bytes": sum(t.nbytes for t in opt.m.values()),
                "param_bytes": sum(t.nbytes for t in params.values())}
    dt_save(params, os.path.join(tmp, "one_a"))
    m, _, params, opt, _ = dt_steps(model, lm, first=DT_STEPS, steps=1,
                                    compression="int8", opt_state=opt)
    out["a"]["int8_metrics"] = m
    out["a"]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    dt_save(params, os.path.join(tmp, "one_int8"))
    del model, params, opt
    dt_free()
    model = pack_tree(build_model(lm, device=DEVICE, seed=0), layout="xwT")
    step = make_train_step(model, adamw.AdamWConfig(**DT_OPT),
                           num_microbatches=DT_MICRO,
                           policy=ExecPolicy(mode="packed", backend="cuda"))
    torch.cuda.synchronize()
    reset_counts()
    loss, _, grads = step.grads(train_params(model), dt_batch(lm, 0))
    out["b"] = {"loss": float(loss), "launches": read_counts()}
    dt_save({n: g for n, g in grads.items() if n.endswith(".values")},
            os.path.join(tmp, "one_b"))
    del model, grads
    dt_free()
    model = build_model(moe, device=DEVICE, seed=0)
    # the world's chunks of rows: dp x microbatches of the global batch
    m, secs, _, _, _ = dt_steps(model, moe, micro=2 * DT_MICRO, steps=1)
    out["c"] = {"metrics": m, "step_s": secs}
    del model
    dt_free()
    out["g"] = {}
    for label, (_, _, _, step_kw) in DT_FAMILY_LEGS.items():
        cfg = dt_family_cfg(label)
        model = build_model(cfg, device=DEVICE, seed=0)
        start = dt_checked(train_params(model))
        m, secs, params, opt, _ = dt_steps(model, cfg, steps=DT_FAMILY_STEPS,
                                           **step_kw)
        dt_save({n: opt.m[n] for n in start},
                os.path.join(tmp, f"one_g_m_{label}"))
        dt_save({n: params[n] - t for n, t in start.items()},
                os.path.join(tmp, f"one_g_u_{label}"))
        out["g"][label] = {"metrics": m, "step_s": secs}
        del model, params, opt, start
        dt_free()
    # 15h's tick on one rank: its logits kept for the ranks
    import numpy as np
    model = pack_tree(build_model(lm, device=DEVICE, seed=0), layout="xwT")
    with torch.no_grad():
        logits, _ = model.decode_step(
            model.init_decode_state(DT_POD_ROWS, DT_POD_LEN,
                                    dtype=torch.float32, device=DEVICE),
            dt_pod_tokens(), policy=ExecPolicy(mode="packed",
                                                backend="cuda"))
    np.save(os.path.join(tmp, "pod_tick.npy"), logits.cpu().numpy())
    del model
    dt_free()
    return out


def dt_pod_tokens():
    """15h's tokens: one a slot."""
    import torch
    return torch.arange(1, DT_POD_ROWS + 1, device=DEVICE).reshape(
        DT_POD_ROWS, 1)


def dt_families(dev, tmp):
    """15g on this rank: each leg's masked steps under ``ShardingPlan(tp=2,
    dp=2, **plan keywords)``; the checked leaves' moments and updates
    against the one rank's (its blocks of them, under ``tmp``); what the
    rank holds, the row maps and the tensors summed over tp."""
    import numpy as np
    from repro_torch.core.sparse_linear import gathers_output
    from repro_torch.models.families import build_model
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.train.train_loop import train_params

    out = {}
    for label, (_, _, plan_kw, step_kw) in DT_FAMILY_LEGS.items():
        t_leg = time.time()
        cfg = dt_family_cfg(label)
        model = build_model(cfg, device=dev, seed=0)
        plan = ShardingPlan(tp=2, dp=2, **plan_kw)
        model.train_mesh = plan.make_mesh()
        lay = plan.place_for_training(model, model.train_mesh)
        start = dt_checked(train_params(model))
        m, secs, params, opt, step = dt_steps(
            model, cfg, plan=plan, steps=DT_FAMILY_STEPS, **step_kw)
        m_rel, u_rel = {}, {}
        for n, t in start.items():
            one_m = np.load(os.path.join(tmp, f"one_g_m_{label}", n + ".npy"),
                            mmap_mode="r")
            one_u = np.load(os.path.join(tmp, f"one_g_u_{label}", n + ".npy"),
                            mmap_mode="r")
            m_rel[n] = dt_norm_rel(opt.m[n], lay.block_of(n, one_m,
                                                          moment=True))
            u_rel[n] = dt_norm_rel(params[n] - t, lay.block_of(n, one_u))
        out[label] = {
            "metrics": m, "step_s": secs, "layers": cfg.num_layers,
            "checked": len(start),
            "m_rel": max(m_rel.items(), key=lambda kv: kv[1]),
            "update_rel": max(u_rel.items(), key=lambda kv: kv[1]),
            "row_maps": len(lay.rows), "partial": len(lay.partial),
            "gathered": sorted({n.rsplit(".", 1)[-1] for n, mod in
                                model.named_modules()
                                if gathers_output(mod)}),
            "tp_block_bytes": sum(t.nbytes for t in params.values()),
            "collectives": step.context.collectives,
            "seconds": time.time() - t_leg}
        del model, params, opt, step, lay, start
        dt_free()
    return out


def dt_pod(dev, tmp):
    """15h on this rank: 15a's model on the pod mesh, one masked step (dp
    over pod x data), and one packed decode tick of this dp rank's slots
    against the one rank's tick."""
    import numpy as np
    import torch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.sharding.context import make_context, use_mesh
    from repro_torch.sharding.plan import ShardingPlan

    t_leg = time.time()
    lm, _ = dt_cfgs()
    mesh = make_test_mesh(*DT_POD_MESH)
    plan = ShardingPlan(tp=2, dp=2)
    model = build_model(lm, device=dev, seed=0)
    plan.place_for_training(model, mesh)
    model.train_mesh = mesh
    m, secs, _, _, step = dt_steps(model, lm, plan=plan, steps=1)
    ctx = step.context
    out = {"metrics": m, "step_s": secs, "dp": [ctx.dp, ctx.dp_rank],
           "tp_rank": ctx.tp_rank}
    del model, step
    dt_free()
    served = pack_tree(build_model(lm, device=dev, seed=0), layout="xwT")
    ShardingPlan(tp=2).shard_params(served, mesh)
    sctx = make_context(mesh, num_kv_heads=lm.num_kv_heads,
                        num_heads=lm.num_heads)
    per = DT_POD_ROWS // sctx.dp
    rows = slice(sctx.dp_rank * per, (sctx.dp_rank + 1) * per)
    state = ShardingPlan(tp=2).shard_decode_state(
        lambda device: served.init_decode_state(
            per, DT_POD_LEN, dtype=torch.float32, device=device),
        dev, mesh, num_kv_heads=lm.num_kv_heads, cfg=lm)
    with torch.no_grad(), use_mesh(sctx):
        got, _ = served.decode_step(state, dt_pod_tokens().to(dev)[rows],
                                    policy=ExecPolicy(mode="packed",
                                                      backend="cuda"))
    want = torch.from_numpy(np.load(os.path.join(tmp, "pod_tick.npy"))
                            [rows]).to(dev)
    out.update(rows=[rows.start, rows.stop],
               tick_rel_l2=float(torch.linalg.norm(got - want)
                                 / torch.linalg.norm(want)),
               tokens=got.argmax(-1).flatten().tolist(),
               want_tokens=want.argmax(-1).flatten().tolist(),
               kv_heads=int(state["caches"]["k"].shape[-2]),
               seconds=time.time() - t_leg)
    del served, state
    dt_free()
    return out


def dt_rank(rank, nprocs, init, tmp):
    """One rank of phase 15's world on the card (``gloo``, every rank on
    cuda:0; rank 0 loads the kernel library, the others wait for it)."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.kernels._build import load_library_once
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.optim import adamw
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.sharding.world import init_world
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.train_loop import make_train_step, train_params

    t_rank = time.time()
    # four ranks share the host's cores: no rank takes them all
    torch.set_num_threads(max(1, (os.cpu_count() or 8) // nprocs))
    world = init_world("cuda", rank=rank, world_size=nprocs, init_method=init)
    dev = world.device
    load_library_once()
    lm, moe = dt_cfgs()
    plan = ShardingPlan(tp=2, dp=2)
    # what a first step imports (non-reentrant checkpointing imports
    # torch._dynamo, seconds of Python), then wait for the card
    torch.utils.checkpoint.checkpoint(
        torch.square, torch.ones(1, requires_grad=True),
        use_reentrant=False).backward()
    out = {"rank": world.rank, "backend": world.backend, "device": str(dev),
           "init_s": time.time() - t_rank}
    deadline = time.time() + DT_TIMEOUT_S
    while not os.path.exists(os.path.join(tmp, DT_READY)):
        if time.time() > deadline:
            raise TimeoutError("15: the one-rank runs did not finish")
        time.sleep(0.1)
    t_rank = time.time()

    def max_diff(params, d, lay):
        worst = 0.0
        for n, p in params.items():
            want = torch.from_numpy(dt_block(d, n, lay))
            worst = max(worst, float((p - want.to(dev)).abs().max()))
        return worst

    # 15a: three masked steps, ZeRO-1 moments
    t_leg = time.time()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(lm, device=dev, seed=0)
    m, secs, params, opt, step = dt_steps(model, lm, plan=plan)
    lay, ctx = step.layout, step.context
    a = {"metrics": m, "step_s": secs, "coords": [ctx.dp_rank, ctx.tp_rank],
         "collectives_per_step": ctx.collectives / DT_STEPS,
         "moment_bytes": sum(t.nbytes for t in opt.m.values()),
         "tp_block_bytes": sum(t.nbytes for t in params.values()),
         "max_param_diff": max_diff(params, os.path.join(tmp, "one_a"),
                                    lay)}
    # 15f: the state saved whole (rank 0 writes), each rank's blocks
    # bit-equal to the saved leaves
    t0 = time.time()
    ck = os.path.join(tmp, "ckpt")
    ckpt.save({"params": params, "opt": opt}, ck, DT_STEPS, plan=plan,
              layout=lay)
    f = {"save_s": time.time() - t0}
    f["held_equal_saved"] = dt_held_equal(ck, {"params": params, "opt": opt},
                                          lay)
    # ... and the int8 step
    m, _, params, opt, _ = dt_steps(model, lm, plan=plan, first=DT_STEPS,
                                    steps=1, compression="int8",
                                    opt_state=opt)
    a["int8_metrics"] = m
    a["int8_max_param_diff"] = max_diff(params, os.path.join(tmp, "one_int8"),
                                        lay)
    a["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    a["seconds"] = time.time() - t_leg - f["save_s"]
    out["a"] = a
    del model, params, opt, step
    dt_free()

    # 15f: restored under tp 2 on the first two ranks (a smaller mesh)
    t0 = time.time()
    small = ShardingPlan(tp=2)
    mesh = small.make_mesh()
    if mesh.get_coordinate() is not None:
        from repro_torch.train.fault_tolerance import elastic_restore
        m2 = build_model(lm, device=dev, seed=1)
        lay2 = small.place_for_training(m2, mesh)
        p2 = train_params(m2)
        template = {"params": p2, "opt": adamw.init(
            adamw.AdamWConfig(**DT_OPT), p2, layout=lay2)}
        got = elastic_restore(template, ck, DT_STEPS, mesh,
                              lay2.state_specs(template))
        f["elastic_equal_saved"] = dt_held_equal(ck, got, lay2)
        f["elastic_leaves"] = 3 * len(p2)
        del m2, p2, template, got
        dt_free()
    f["restore_s"] = time.time() - t0
    out["f"] = f
    dist.barrier()

    # 15b: the packed fine-tuning step's gradients, K1 on the rank's slices
    t_leg = time.time()
    pm = pack_tree(build_model(lm, device=dev, seed=0), layout="xwT")
    pstep = make_train_step(pm, adamw.AdamWConfig(**DT_OPT),
                            num_microbatches=DT_MICRO, plan=plan,
                            policy=ExecPolicy(mode="packed", backend="cuda"))
    torch.cuda.synchronize()
    reset_counts()                   # just before the main path ...
    loss, _, grads = pstep.grads(train_params(pm), dt_batch(lm, 0))
    torch.cuda.synchronize()
    b = {"loss": float(loss), "launches": read_counts()}   # ... after
    worst = 0.0
    for n, g in grads.items():
        if not n.endswith(".values"):
            continue
        want = torch.from_numpy(dt_block(
            os.path.join(tmp, "one_b"), n, pstep.layout)).to(dev)
        worst = max(worst, float(torch.linalg.norm(g - want)
                                 / torch.linalg.norm(want)))
    b["max_rel_l2"] = worst
    b["kinds"] = sorted({str(v) for v in pstep.layout.placement.values()})
    # 15f: the shard stacks (renumbered row-parallel values) saved, their
    # moments holding this rank's gradient blocks, and restored under tp 2
    # on the first two ranks (tp 2's placement is the world's: the same
    # tp blocks, moments whole over the one dp rank)
    t0 = time.time()
    play = pstep.layout
    pparams = train_params(pm)
    stacks = [n for n in pparams if play.split(n) and play.placement[n][1]]
    zb = {n: play.zero_block(n, grads[n]).clone() for n in stacks}
    pstate = {"params": {n: pparams[n] for n in stacks},
              "opt": adamw.AdamWState(
                  step=torch.zeros((), dtype=torch.int32, device=dev), m=zb,
                  v={n: g.square() for n, g in zb.items()})}
    pck = os.path.join(tmp, "ckpt_packed")
    ckpt.save(pstate, pck, DT_STEPS, plan=plan, layout=play)
    f = out["f"]
    f["packed_stacks"] = len(stacks)
    f["packed_held_equal_saved"] = dt_held_equal(pck, pstate, play)
    if mesh.get_coordinate() is not None:
        from repro_torch.sharding.plan import TrainLayout
        from repro_torch.train.fault_tolerance import elastic_restore
        lay2 = TrainLayout(small.context(mesh), pm)
        template = {"params": {n: torch.empty_like(p) for n, p in
                               pstate["params"].items()},
                    "opt": adamw.init(adamw.AdamWConfig(**DT_OPT),
                                      pstate["params"], layout=lay2)}
        got = elastic_restore(template, pck, DT_STEPS, mesh,
                              lay2.state_specs(template))
        f["packed_elastic_equal_saved"] = dt_held_equal(pck, got, lay2) \
            and all(torch.equal(got["params"][n], pparams[n])
                    for n in stacks)
        del got, template
    f["packed_save_restore_s"] = time.time() - t0
    del pstate, zb
    b["seconds"] = time.time() - t_leg
    out["b"] = b
    del pm, pstep, grads
    dt_free()

    # 15c: MoE expert parallelism, 32 experts a rank
    t_leg = time.time()
    mm = build_model(moe, device=dev, seed=0)
    m, secs, _, _, mstep = dt_steps(mm, moe, plan=plan, steps=1)
    out["c"] = {"metrics": m, "step_s": secs,
                "experts": int(mm.layers[0].moe.w_gate.shape[0]),
                "collectives": mstep.context.collectives,
                "seconds": time.time() - t_leg}
    dp_group = mstep.context.dp_group
    del mm, mstep
    dt_free()

    out["d"] = dt_pipeline(dev)
    # 15e: the int8-compressed sum over the dp group, CUDA tensors
    from repro_torch.optim.compression import compressed_psum_int8
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    xs = torch.randn((2, 4096), generator=gen, device=dev)
    coords = out["a"]["coords"]
    got = compressed_psum_int8(xs[coords[0]], dp_group)
    scale = float(xs.abs().max()) / 127
    out["e"] = {"max_err": float((got - xs.sum(0)).abs().max()),
                "bound": 8 * scale, "device": str(got.device)}
    out["g"] = dt_families(dev, tmp)
    out["h"] = dt_pod(dev, tmp)
    out["seconds"] = time.time() - t_rank
    return out


def dt_pipeline(dev):
    """15d: ``pipeline_apply`` over the four ranks as stages, the reference
    test's toy stages at its sizes; outputs and the gradients at this
    stage's weight and at x against autograd through the sequential
    composition on the card."""
    import torch
    from repro_torch.sharding.pipeline import pipeline_apply
    from repro_torch.sharding.plan import ShardingPlan

    plan = ShardingPlan(pp=DT_RANKS)
    ctx = plan.context(plan.make_mesh())
    gen = torch.Generator(device=dev)
    gen.manual_seed(23)
    d = DT_PIPE["d"]
    ws = torch.randn((DT_RANKS, d, d), generator=gen, device=dev) * 0.3
    x = torch.randn((DT_PIPE["num_mb"], DT_PIPE["mb"], d), generator=gen,
                    device=dev)
    cot = torch.randn(x.shape, generator=gen, device=dev)

    def stage_fn(p, xm):
        return torch.tanh(xm @ p["w"])

    w = ws[ctx.pp_rank].clone().requires_grad_(True)
    xg = x.clone().requires_grad_(True)
    t0 = time.time()
    y = pipeline_apply(stage_fn, {"w": w}, xg, ctx)
    gw, gx = torch.autograd.grad((y * cot).sum(), [w, xg])
    y = y.detach()
    secs = time.time() - t0
    seq = [ws[i].clone().requires_grad_(True) for i in range(DT_RANKS)]
    xs = x.clone().requires_grad_(True)
    ys = xs
    for wi in seq:
        ys = torch.tanh(ys @ wi)
    want = torch.autograd.grad((ys * cot).sum(), seq + [xs])
    ys = ys.detach()
    return {"stage": ctx.pp_rank, "seconds": secs,
            "y_err": float((y - ys).abs().max()),
            "gw_err": float((gw - want[ctx.pp_rank]).abs().max()),
            "gx_err": float((gx - want[-1]).abs().max())}


def dt_gates(one, ranks, tmp):
    """Phase 15's gates over the one rank's and the ranks' results; the
    checkpoint restored whole in this process."""
    import numpy as np
    import torch
    from repro_torch.launch.specs import param_shapes
    from repro_torch.optim import adamw
    from repro_torch.train import checkpoint as ckpt

    def rel(a, b):
        return abs(a - b) / max(abs(b), 1e-12)

    bound = 2 * DT_OPT["lr"] * DT_STEPS
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("15: four ranks on one card must take gloo")
    for r in ranks:
        tag = f"15 rank {r['rank']}"
        a, b, c = r["a"], r["b"], r["c"]
        for what, got, want in (
                ("15a", a["metrics"], one["a"]["metrics"]),
                ("15a int8", a["int8_metrics"], one["a"]["int8_metrics"]),
                ("15c", c["metrics"], one["c"]["metrics"])):
            for g, w in zip(got, want):
                if not (rel(g[0], w[0]) < DT_REL and rel(g[1], w[1]) < DT_REL):
                    raise AssertionError(
                        f"{tag} {what}: loss / grad_norm {g} against one "
                        f"rank's {w} (relative {DT_REL})")
        for key in ("max_param_diff", "int8_max_param_diff"):
            lim = bound if key == "max_param_diff" else \
                2 * DT_OPT["lr"] * (DT_STEPS + 1)
            if not a[key] <= lim:
                raise AssertionError(f"{tag} 15a: {key} {a[key]} > {lim}")
        if 2 * a["moment_bytes"] != a["tp_block_bytes"]:
            raise AssertionError(f"{tag} 15a: moments {a['moment_bytes']} "
                                 f"B, not half the tp block's "
                                 f"{a['tp_block_bytes']} B")
        k1 = one["b"]["launches"]["demm_xwT"]
        want = {n: 0 for n in KERNELS}
        want["demm_xwT"] = k1
        if b["launches"] != want or not k1:
            raise AssertionError(f"{tag} 15b: launches {b['launches']}, "
                                 f"expected {want} (the one rank's K1)")
        if not (b["max_rel_l2"] < DT_PACKED_REL
                and rel(b["loss"], one["b"]["loss"]) < DT_REL):
            raise AssertionError(f"{tag} 15b: gradients at the values "
                                 f"{b['max_rel_l2']} (relative L2), loss "
                                 f"{b['loss']} vs {one['b']['loss']}")
        if c["experts"] != 32:
            raise AssertionError(f"{tag} 15c: {c['experts']} experts")
        d = r["d"]
        if not max(d["y_err"], d["gw_err"], d["gx_err"]) <= DT_PIPE_TOL:
            raise AssertionError(f"{tag} 15d: {d}")
        e = r["e"]
        if not (e["max_err"] < e["bound"] and e["device"].startswith("cuda")):
            raise AssertionError(f"{tag} 15e: {e}")
        f = r["f"]
        if not (f["held_equal_saved"] and f["packed_held_equal_saved"]
                and f["packed_stacks"] == 2 * DT_LAYERS
                and f.get("elastic_equal_saved", True) is True
                and f.get("packed_elastic_equal_saved", True) is True):
            raise AssertionError(f"{tag} 15f: {f}")
    for r in ranks:
        tag = f"15 rank {r['rank']}"
        for label, g in r["g"].items():
            for got, want in zip(g["metrics"], one["g"][label]["metrics"]):
                if not (rel(got[0], want[0]) < DT_REL
                        and rel(got[1], want[1]) < DT_REL):
                    raise AssertionError(
                        f"{tag} 15g {label}: loss / grad_norm {got} against "
                        f"one rank's {want} (relative {DT_REL})")
            if not (len(g["metrics"]) == DT_FAMILY_STEPS and g["checked"]
                    and g["m_rel"][1] <= DT_MOMENT_REL
                    and g["update_rel"][1] <= DT_UPDATE_REL):
                raise AssertionError(
                    f"{tag} 15g {label}: {g['checked']} checked leaves, the "
                    f"worst moment {g['m_rel']} (norm-wise, {DT_MOMENT_REL}) "
                    f"and update {g['update_rel']} ({DT_UPDATE_REL}) "
                    "against one rank's")
        # the mixers split by heads: row maps, and xlstm's w_if / conv_w
        # summed over tp
        if not (r["g"]["zamba2_7b"]["row_maps"]
                and r["g"]["xlstm_125m"]["row_maps"]
                and r["g"]["xlstm_125m"]["partial"]):
            raise AssertionError(f"{tag} 15g: the mixers are not split by "
                                 f"heads ({r['g']})")
        if r["g"]["zamba2_7b"]["gathered"] or \
                r["g"]["xlstm_125m"]["gathered"] != ["up", "w_in"]:
            raise AssertionError(f"{tag} 15g: gathered projections "
                                 f"{r['g']['zamba2_7b']['gathered']}, "
                                 f"{r['g']['xlstm_125m']['gathered']}")
        h = r["h"]
        first = one["a"]["metrics"][0]
        if not (h["dp"] == [2, r["rank"] // 2]
                and h["tp_rank"] == r["rank"] % 2
                and rel(h["metrics"][0][0], first[0]) < DT_REL
                and rel(h["metrics"][0][1], first[1]) < DT_REL):
            raise AssertionError(f"{tag} 15h: pod step {h['metrics']} dp "
                                 f"{h['dp']}, one rank's {first}")
        if not (h["tokens"] == h["want_tokens"]
                and h["tick_rel_l2"] < DT_REL
                and 2 * h["kv_heads"] == dt_cfgs()[0].num_kv_heads):
            raise AssertionError(f"{tag} 15h: pod tick {h}")
    for key in ("elastic_equal_saved", "packed_elastic_equal_saved"):
        if [r["rank"] for r in ranks if key in r["f"]] != [0, 1]:
            raise AssertionError(f"15f: the tp 2 restore ({key}) ran on "
                                 f"ranks {[r['rank'] for r in ranks]}")
    if sorted(r["d"]["stage"] for r in ranks) != list(range(DT_RANKS)):
        raise AssertionError("15d: stages")
    # the checkpoint restored whole in one process, onto the host (a
    # template of the one-rank tree's names): every leaf, and the
    # parameters within the bound of the one rank's
    lm, _ = dt_cfgs()
    t0 = time.time()
    names = list(param_shapes(lm))
    template = {"params": dict.fromkeys(names), "opt": adamw.AdamWState(
        step=None, m=dict.fromkeys(names), v=dict.fromkeys(names))}
    got = ckpt.restore(template, os.path.join(tmp, "ckpt"), DT_STEPS)
    worst = 0.0
    for n, p in got["params"].items():
        want = torch.from_numpy(np.load(os.path.join(tmp, "one_a",
                                                     n + ".npy")))
        worst = max(worst, float((p - want).abs().max()))
    leaves = [got["params"], got["opt"].m, got["opt"].v]
    if not worst <= bound or not all(
            list(d) == names and all(t is not None for t in d.values())
            for d in leaves):
        raise AssertionError(f"15f: the whole restore's parameters differ "
                             f"from the one rank's by {worst}, or it lacks "
                             "leaves")
    return {"leaves": sum(map(len, leaves)),
            "max_param_diff_vs_one_rank": worst,
            "seconds": time.time() - t0}


def dist_train_phase():
    """Phase 15: the one-rank runs, then the world of four ranks, then the
    gates.  Returns the ``distributed_training`` report."""
    import tempfile

    from repro_torch.sharding.world import spawn_world

    import threading

    t_all = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_train_")
    one, one_s, errors = {}, [], []

    def single():
        # the one-rank runs, while the ranks start up; the card is free
        # for them once this is done
        t0 = time.time()
        try:
            one.update(dt_single(tmp))
        except BaseException as e:      # raised in the phase's thread
            errors.append(e)
        finally:
            one_s.append(time.time() - t0)
            open(os.path.join(tmp, DT_READY), "w").close()

    try:
        t0 = time.time()
        thread = threading.Thread(target=single)
        thread.start()
        try:
            ranks = spawn_world(dt_rank, DT_RANKS, (tmp,),
                                timeout_s=DT_TIMEOUT_S)
        finally:
            thread.join()
            if errors:
                raise errors[0]
        world_s = time.time() - t0
        restore = dt_gates(one, ranks, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return {"one_rank": one, "ranks": ranks, "whole_restore": restore,
            "single_seconds": one_s[0], "world_seconds": world_s,
            "seconds": time.time() - t_all}


def log_dist_train(r, smi):
    one = r["one_rank"]
    log(f"[15 dist train] one rank ({r['single_seconds']:.1f} s): "
        f"{json.dumps(one)}")
    for e in r["ranks"]:
        log(f"[15 dist train] rank {e['rank']} ({e['backend']}, "
            f"{e['device']}): {json.dumps(e)}")
    log(f"[15f dist train] whole restore in one process: "
        f"{json.dumps(r['whole_restore'])}")
    log("[15a dist train] rank | loss per step | grad_norm per step | step "
        "s (gloo, host-staged) | collectives a step | moments MB / tp block "
        "MB | peak GB")
    for e in r["ranks"]:
        a = e["a"]
        log(f"[15a dist train] {e['rank']} | "
            + ", ".join(f"{m[0]:.6f}" for m in a["metrics"]) + " | "
            + ", ".join(f"{m[1]:.6f}" for m in a["metrics"]) + " | "
            + ", ".join(f"{s:.2f}" for s in a["step_s"])
            + f" | {a['collectives_per_step']:.0f} | "
            f"{a['moment_bytes'] / 1e6:.1f} / {a['tp_block_bytes'] / 1e6:.1f}"
            f" | {a['peak_gb']:.2f}")
    log("[15g dist train] leg | layers | loss rank 0 / one rank | "
        "grad_norm rank 0 / one rank | step s rank 0 / one rank | row maps |"
        " summed over tp | gathered | tp block MB | collectives | leg s | "
        "checked leaves | worst m / update against one rank (norm-wise)")
    for label, g in r["ranks"][0]["g"].items():
        o = one["g"][label]
        log(f"[15g dist train] {label} | {g['layers']} | "
            f"{g['metrics'][0][0]:.6f} / {o['metrics'][0][0]:.6f} | "
            f"{g['metrics'][0][1]:.6f} / {o['metrics'][0][1]:.6f} | "
            f"{g['step_s'][0]:.2f} / {o['step_s'][0]:.2f} | "
            f"{g['row_maps']} | {g['partial']} | {','.join(g['gathered'])} "
            f"| {g['tp_block_bytes'] / 1e6:.1f} | {g['collectives']} | "
            f"{g['seconds']:.1f} | {g['checked']} | {g['m_rel'][1]:.3e} "
            f"({g['m_rel'][0]}) / {g['update_rel'][1]:.3e} "
            f"({g['update_rel'][0]})")
    for e in r["ranks"]:
        h = e["h"]
        log(f"[15h dist train] rank {e['rank']} pod x data dp {h['dp']}: "
            f"loss {h['metrics'][0][0]:.6f} grad_norm "
            f"{h['metrics'][0][1]:.6f} (one rank "
            f"{one['a']['metrics'][0][0]:.6f}, "
            f"{one['a']['metrics'][0][1]:.6f}); tick rows {h['rows']} "
            f"tokens {h['tokens']} (one rank {h['want_tokens']}), logits "
            f"relative L2 {h['tick_rel_l2']:.2e}; {h['seconds']:.1f} s")
    log(f"[15 dist train] one rank: losses "
        + ", ".join(f"{m[0]:.6f}" for m in one["a"]["metrics"])
        + f"; step s " + ", ".join(f"{s:.2f}" for s in one["a"]["step_s"])
        + f"; peak {one['a']['peak_gb']:.2f} GB; world "
        f"{r['world_seconds']:.1f} s, phase {r['seconds']:.1f} s; {smi}")


# ---------------------------------------------------------------------------
# phase 16: every family served under ShardingPlan(tp=2), two-rank worlds
# on the one card at full width
# ---------------------------------------------------------------------------

# (label, arch, config overrides, layout, quantize, engine) of each leg, at
# full width and cut depth (the script's time limit): olmoe 2 of 16 layers
# (room in every expert for every token), zamba2 7 of 81 (one period of 6
# Mamba2 layers and the shared block, one tail layer), internvl2 4 of 24,
# seamless's decoder 4 of 12 (encoder 2), gemma3 6 of 26 (5 local layers on
# 512-slot rings and the global one, the fewest the reference serves; one
# prompt of DF_LONG_PROMPT tokens on one slot runs past the rings, token by
# token: the longest leg), h2o 2 of 24 (its 4096-slot rings do not wrap),
# stablelm_3b SPEC_LAYERS of 32 at 8:16 drafted at 6:16 on both engines;
# xlstm whole.  Float32 legs gate the tokens against one rank's outright,
# bfloat16 legs the logits (DIST_LOGITS_GAP); the layouts spread the legs
# over K1-K4.
DF_LEGS = [
    ("olmoe_1b_7b", "olmoe_1b_7b", {"num_layers": 2}, "xwT", None, "dense"),
    ("zamba2_7b", "zamba2_7b", {"num_layers": 7, "compute_dtype": "float32"},
     "xwT", None, "dense"),
    ("xlstm_125m", "xlstm_125m", {"compute_dtype": "float32"}, "xwT", "int8",
     "dense"),
    ("internvl2_1b", "internvl2_1b", {"num_layers": 4}, "block", None,
     "dense"),
    ("seamless_m4t_medium", "seamless_m4t_medium",
     {"num_layers": 4, "encoder_layers": 2}, "block", "int8", "dense"),
    ("gemma3_1b", "gemma3_1b", {"num_layers": 6, "compute_dtype": "float32"},
     "xwT", None, "long"),
    ("h2o_danube_1_8b", "h2o_danube_1_8b", {"num_layers": 2}, "block", None,
     "dense"),
    ("stablelm_3b spec", "stablelm_3b",
     {"num_layers": SPEC_LAYERS, "compute_dtype": "float32"}, "xwT", None,
     "spec"),
    ("stablelm_3b spec paged", "stablelm_3b",
     {"num_layers": SPEC_LAYERS, "compute_dtype": "float32"}, "xwT", None,
     "spec_paged"),
]
DF_SLOTS, DF_NEW, DF_MAX_LEN = 4, 8, 64
DF_PREFILL_CHUNK = 32
# the rows a spec leg's projections meet on a rank: the draft and decode
# steps (one a slot), the bulk body's widest, the widest verify window
# (gamma + 1 a slot) and the paged prefill chunk (16a holds both tiers of
# the placed model at each)
DF_SPEC_ROWS = (DF_SLOTS, 8, DF_SLOTS * (SPEC_GAMMA + 1), DF_PREFILL_CHUNK)
DF_LONG_PROMPT, DF_LONG_MAX_LEN = 520, 544
DF_TIMEOUT_S = 600
# the legs whose mixers split by heads, what each rank still gathers, and
# the most of one rank's decode state a rank may hold (half the heads'
# recurrent state and half the KV heads, Mamba2's B / C conv channels
# whole: 0.50 and 0.51 of one rank's, computed from the shapes)
DF_SPLIT_MIXERS = {"zamba2_7b": [], "xlstm_125m": ["up", "w_in"]}
DF_SPLIT_STATE = 0.55
# 16a also places zamba2 in the block layout: its in_proj rows re-blocked
# by heads (``core.sparsity.select_rows``) on K2
DF_SHAPE_LEGS = [("zamba2_7b block", "zamba2_7b",
                  {"compute_dtype": "float32"}, "block", None, "dense")]
# the ranks start serving once the one-rank runs are done (a file in the
# phase's directory): they share the card
DF_READY = "one_rank_done"


def df_cfg(arch, over, kind):
    """The leg's config: ``arch`` with ``over``; the experts with room for
    every token, the spec legs packed at 8:16."""
    from repro_torch.configs.base import get_arch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.spec import parse_tier

    cfg = no_drop(dataclasses.replace(get_arch(arch), **over))
    if kind.startswith("spec"):
        cfg = dataclasses.replace(cfg, sparsity=SparsityConfig(
            *parse_tier(SPEC_SPARSITY), 1))
    return cfg


def df_prompts(vocab, kind):
    """Phase 4's four prompts; the long leg's one prompt of DF_LONG_PROMPT
    tokens (on one slot: the leg's ticks are host-bound, each one
    collective-bound)."""
    import numpy as np
    if kind == "long":
        return [np.random.default_rng(16).integers(
            0, vocab, DF_LONG_PROMPT, dtype=np.int32)]
    return phase4_prompts(vocab)


def df_packed(model) -> dict:
    return {n: packed_bytes(m) for n, m in model.named_modules()
            if hasattr(m, "dense_shape")}


def df_serve(leg, plan, device):
    """One leg on ``device`` under ``plan`` (None: one rank), eager: the
    leg's model built from seed 0 and packed, its prompts drained, every
    sampled token's logits kept (but in the spec legs); the wrappers'
    counts reset just before the engine is built and read after the drain.
    Returns (the engine, what the run measured)."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.paged import PagedServeConfig, PagedServeEngine
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    from repro_torch.serve.serve_loop import state_tensors
    from repro_torch.spec import SpecConfig

    label, arch, over, layout, quantize, kind = leg
    t_leg = time.time()
    cfg = df_cfg(arch, over, kind)
    model = pack_tree(build_model(cfg, device=device, seed=0), layout=layout,
                      quantize=quantize)
    whole = sum(df_packed(model).values())
    max_len, slots = ((DF_LONG_MAX_LEN, 1) if kind == "long"
                      else (DF_MAX_LEN, DF_SLOTS))
    common = dict(
        policy=ExecPolicy(mode="packed", backend="cuda", plan=plan),
        device=device, metrics=obs.MetricsRegistry(), _eager=True,
        spec=(SpecConfig(SPEC_DRAFT, SPEC_GAMMA) if kind.startswith("spec")
              else None))
    torch.cuda.synchronize()
    reset_counts()                   # just before the main path ...
    if kind == "spec_paged":
        eng = PagedServeEngine(model, PagedServeConfig(
            num_slots=slots, max_len=max_len, page_size=16,
            prefill_chunk=DF_PREFILL_CHUNK), **common)
    else:
        eng = ServeEngine(model, ServeConfig(num_slots=slots,
                                             max_len=max_len), **common)
    del model
    rec = None
    if common["spec"] is None:
        rec = eng.sampler = LogitsRecorder(eng.sampler, cfg.vocab_size)
    for uid, prompt in enumerate(df_prompts(cfg.vocab_size, kind)):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=DF_NEW))
    torch.cuda.synchronize()
    t0 = time.time()
    ticks = eng.run_until_drained()
    torch.cuda.synchronize()
    serve_s = time.time() - t0
    counts, bodies = read_counts(), read_body_counts()   # ... after
    per_step = (decode_step_bodies(eng.model, check=False)
                if kind in ("dense", "long") else None)
    e = {"outputs": {r.uid: list(r.output) for r in eng.completed},
         "ticks": ticks, "serve_s": serve_s, "tick_ms": 1e3 * serve_s / ticks,
         "layers": cfg.num_layers, "dtype": cfg.compute_dtype,
         "launches": counts, "launches_by_body": bodies,
         "step_bodies": None if per_step is None else bodies_json(per_step),
         "expect": None if per_step is None else {
             name: ticks * sum(n for (k, _), n in per_step.items()
                               if k == name) for name in KERNELS},
         "packed_bytes": sum(df_packed(eng.model).values()),
         "whole_packed_bytes": whole,
         "state_bytes": sum(t.nbytes for t in state_tensors(eng.state)),
         "finite": bool(np.isfinite(
             eng.last_logits[:, :cfg.vocab_size]).all()),
         "seconds": time.time() - t_leg}
    if rec is not None:
        e["rows"] = rec.rows
    return eng, e


def df_draft_views(eng) -> dict:
    """The spec engine's draft model against its placed model: narrowed
    nodes, those whose values and indices are the placed node's own (a
    prefix view of the rank's slice) and those carrying its placement."""
    full = dict(eng.model.named_modules())
    out = {"narrowed": 0, "shared": 0, "placed": 0}
    for name, d in eng.draft_model.named_modules():
        if getattr(d, "tier_ne", None) is None:
            continue
        f = full[name]
        out["narrowed"] += 1
        out["shared"] += d.values is f.values and d.indices is f.indices
        out["placed"] += (getattr(d, "tp_kind", None)
                          == getattr(f, "tp_kind", None))
    return out


def df_rank(rank, nprocs, init, tmp):
    """One rank of 16b on the card: joins the two-rank ``gloo`` world (both
    ranks on cuda:0), loads the kernel library once per world, waits for
    the one-rank runs, then serves every leg under ``ShardingPlan(tp=2)``."""
    import torch

    from repro_torch.core.sparse_linear import gathers_output
    from repro_torch.kernels._build import load_library_once
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.sharding.world import init_world

    world = init_world("cuda", rank=rank, world_size=nprocs,
                       init_method=init)
    load_library_once()
    out = {"rank": world.rank, "backend": world.backend,
           "device": str(world.device)}
    while not os.path.exists(os.path.join(tmp, DF_READY)):
        time.sleep(0.2)
    for leg in DF_LEGS:
        eng, e = df_serve(leg, ShardingPlan(tp=2), world.device)
        if eng._use_graph or not eng.multi_rank:
            raise AssertionError(f"{leg[0]}: a multi-rank engine must step "
                                 "eagerly")
        e["labels"] = eng._trace_labels()
        e["collectives_per_tick"] = eng._shctx.collectives / e["ticks"]
        e["collective_bytes_per_tick"] = \
            eng._shctx.collective_bytes / e["ticks"]
        e["gathered"] = sorted({n.rsplit(".", 1)[-1] for n, m in
                                eng.model.named_modules()
                                if gathers_output(m)})
        e["row_maps"] = sum(m.tp_rows is not None and not m.tp_rows.is_block
                            for m in eng.model.modules()
                            if hasattr(m, "tp_rows"))
        if leg[5].startswith("spec"):
            e["draft"] = df_draft_views(eng)
        out[leg[0]] = e
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    return out


class RankMesh:
    """What ``ShardingPlan.shard_params`` reads of a DeviceMesh: a ``model``
    dim of two ranks, this process at ``rank`` on it (16a places a model as
    that rank would, in this process)."""
    mesh_dim_names = ("model",)

    def __init__(self, rank):
        self.rank = rank

    def size(self, dim):
        return 2

    def get_local_rank(self, name):
        return self.rank

    def get_group(self, name):
        return None


def df_shapes(gen):
    """16a: every rank-local packed weight of the legs (each leg's model at
    one layer, or one period, placed as ranks 0 and 1 place it) against its
    plain version in bfloat16 and float32: at Bx = 4, and for the spec
    leg's model (tier-sorted before it is placed, as the engines do) at
    each of :data:`DF_SPEC_ROWS`, both its full-tier nodes and its draft
    view's narrowed ones (the prefix of the rank's slice at the row pitch).
    Each leg's largest column block and row slice of rank 0 timed
    (:func:`local_entry`: its byte bound, its plain version, a bf16 matmul
    of the local dense slice).  Returns (the checks, the timed entries)."""
    import torch
    from repro_torch.core.sparsity import PackedWeight
    from repro_torch.kernels import ops
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model
    from repro_torch.sharding.plan import ShardingPlan
    from repro_torch.spec.tiers import derive_draft_tier, tier_sort_tree

    depth = {"zamba2_7b": {"num_layers": 6}, "xlstm_125m": {"num_layers": 4},
             "seamless_m4t_medium": {"num_layers": 1, "encoder_layers": 1}}
    checks, timed, seen = [], [], set()
    for label, arch, over, layout, quantize, kind in DF_LEGS + DF_SHAPE_LEGS:
        if kind == "spec_paged":
            continue                     # the spec leg's model
        spec = kind == "spec"
        cfg = df_cfg(arch, {**over, "num_layers": 1, **depth.get(arch, {})},
                     kind)
        largest = {}
        for rank in (0, 1):
            model = pack_tree(build_model(cfg, device=DEVICE, seed=0),
                              layout=layout, quantize=quantize)
            if spec:
                tier_sort_tree(model)
            ShardingPlan(tp=2).shard_params(model, RankMesh(rank))
            name = mode_kernel(layout, quantize)
            nodes = [(n, pw, "full") for n, pw in model.named_modules()
                     if isinstance(pw, PackedWeight)]
            if spec:
                draft, _ = derive_draft_tier(model, SPEC_DRAFT)
                nodes += [(n, pw, "draft") for n, pw in draft.named_modules()
                          if getattr(pw, "tier_ne", None) is not None]
            for mod_name, pw, tier in nodes:
                o, k = pw.dense_shape
                key = (label, rank, o, k, pw.cfg.pattern_name(), pw.tp_kind,
                       pw.tp_sharded, tier)
                if key in seen:
                    continue
                seen.add(key)
                err = {}
                for rows in (DF_SPEC_ROWS if spec else (DF_SLOTS,)):
                    for dtype in ("bfloat16", "float32"):
                        x = torch.randn((rows, k), generator=gen,
                                        device=DEVICE).to(getattr(torch,
                                                                  dtype))
                        got = ops.demm_matmul_packed(x, pw, "cuda")
                        want = ops.demm_matmul_packed(x, pw, "reference")
                        torch.cuda.synchronize()
                        torch.testing.assert_close(
                            got, want, **TOL[dtype], msg=lambda m: (
                                f"16a {label} rank {rank} {mod_name} "
                                f"({tier} tier, Bx {rows}): {m}"))
                        err[dtype] = max(err.get(dtype, 0.0),
                                         float((got - want).abs().max()))
                checks.append({"leg": label, "rank": rank, "kernel": name,
                               "module": mod_name, "tier": tier,
                               "rows": list(DF_SPEC_ROWS if spec
                                            else (DF_SLOTS,)),
                               "split": pw.tp_kind,
                               "sharded": pw.tp_sharded, "O": o, "K": k,
                               "pattern": pw.cfg.pattern_name(),
                               "max_abs_err": err})
                split = pw.tp_kind if pw.tp_sharded else "whole"
                if rank == 0 and tier == "full" and split in ("col", "row") \
                        and (split not in largest or packed_bytes(pw)
                             > packed_bytes(largest[split][1])):
                    largest[split] = (mod_name, pw)
            if rank == 0:
                for split, (mod_name, pw) in sorted(largest.items()):
                    x = torch.randn((4, pw.dense_shape[1]), generator=gen,
                                    device=DEVICE).to(torch.bfloat16)
                    entry = local_entry(name, f"{label} {mod_name}", split,
                                        2, pw, x, gen)
                    timed.append(entry)
            del model, nodes
            gc.collect()
            torch.cuda.empty_cache()
    if not any(c["tier"] == "draft" for c in checks):
        raise AssertionError("16a: no draft node of a placed spec model was "
                             "checked")
    return checks, timed


def df_gates(one, ranks):
    """16b's gates for every leg and rank; returns each leg's agreement."""
    agreement = {}
    for leg in DF_LEGS:
        label, kind = leg[0], leg[5]
        want = one[label]
        r0, r1 = (r[label] for r in ranks)
        if r0["outputs"] != r1["outputs"]:
            raise AssertionError(f"16 {label}: the ranks' streams differ")
        if "rows" in r0 and any((a != b).any() for u in r0["rows"]
                                for a, b in zip(r0["rows"][u],
                                                r1["rows"][u])):
            raise AssertionError(f"16 {label}: the ranks' logits differ")
        kernel = mode_kernel(leg[3], leg[4])
        for r in ranks:
            e = r[label]
            got = e["outputs"]
            if len(got) != len(want["outputs"]) or any(
                    len(t) != DF_NEW for t in got.values()):
                raise AssertionError(f"16 {label}: outputs {got}")
            if e["dtype"] == "float32" and got != want["outputs"]:
                raise AssertionError(
                    f"16 {label} rank {r['rank']}: tokens {got} != one "
                    f"rank's {want['outputs']}")
            if "rows" in e:
                agree = logits_agreement(got, want["outputs"],
                                         e.pop("rows"), want["rows"])
                for u, a in agree.items():
                    if not a["max_gap"] <= DIST_LOGITS_GAP:
                        raise AssertionError(
                            f"16 {label} rank {r['rank']} request {u}: "
                            f"logits gap {a['max_gap']} to one rank's, more "
                            f"than {DIST_LOGITS_GAP}")
                    if "margin" in a and not \
                            0 <= a["margin"] <= 2 * a["max_abs_diff"]:
                        raise AssertionError(
                            f"16 {label} rank {r['rank']} request {u}: the "
                            f"tokens differ at margin {a['margin']}, beyond "
                            f"twice the logits' difference "
                            f"{a['max_abs_diff']}")
                if r["rank"] == 0:
                    agreement[label] = agree
            if not e["finite"]:
                raise AssertionError(f"16 {label}: non-finite logits")
            if e["expect"] is not None and e["launches"] != e["expect"]:
                raise AssertionError(
                    f"16 {label} rank {r['rank']}: launches {e['launches']},"
                    f" expected {e['expect']} ({e['step_bodies']} a step)")
            # a float32 spec leg: the same tokens give the same schedule
            # (drafts accepted, verify windows, prefill chunks), so a rank
            # launches each kernel as often as one rank does, in as many
            # ticks; a wrong draft changes the acceptance and so the ticks
            if kind.startswith("spec") and e["dtype"] == "float32" and (
                    e["ticks"] != want["ticks"]
                    or e["launches"] != want["launches"]):
                raise AssertionError(
                    f"16 {label} rank {r['rank']}: {e['ticks']} ticks, "
                    f"launches {e['launches']}; one rank {want['ticks']} "
                    f"ticks, launches {want['launches']}")
            others = {n: c for n, c in e["launches"].items()
                      if n != kernel and c}
            if not e["launches"][kernel] or others:
                raise AssertionError(f"16 {label} rank {r['rank']}: "
                                     f"launches {e['launches']}")
            if not 0 < e["packed_bytes"] < e["whole_packed_bytes"]:
                raise AssertionError(
                    f"16 {label} rank {r['rank']}: holds {e['packed_bytes']}"
                    f" of {e['whole_packed_bytes']} packed bytes")
            if label in DF_SPLIT_MIXERS and not (
                    e["gathered"] == DF_SPLIT_MIXERS[label]
                    and e["row_maps"] > 0 and e["state_bytes"]
                    <= DF_SPLIT_STATE * want["state_bytes"]):
                raise AssertionError(
                    f"16 {label} rank {r['rank']}: the mixers not split by "
                    f"heads: gathered {e['gathered']}, {e['row_maps']} row "
                    f"maps, state {e['state_bytes']} B of one rank's "
                    f"{want['state_bytes']} B")
            d = e.get("draft")
            if d is not None and not (
                    d["narrowed"] > 0
                    and d["shared"] == d["placed"] == d["narrowed"]):
                raise AssertionError(f"16 {label} rank {r['rank']}: draft "
                                     f"views {d}")
        want.pop("rows", None)
    return agreement


def dist_families_phase(gen):
    """Phase 16: the one-rank runs (while the ranks start up), the world of
    two ranks, the gates, then 16a's shapes on the quiet card."""
    import tempfile
    import threading

    import torch
    from repro_torch.sharding.world import spawn_world

    t_all = time.time()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_families_")
    one, one_s, errors = {}, [], []

    def single():
        t0 = time.time()
        try:
            for leg in DF_LEGS:
                eng, one[leg[0]] = df_serve(leg, None, DEVICE)
                del eng
                gc.collect()
                torch.cuda.empty_cache()
        except BaseException as e:      # raised in the phase's thread
            errors.append(e)
        finally:
            one_s.append(time.time() - t0)
            open(os.path.join(tmp, DF_READY), "w").close()

    try:
        t0 = time.time()
        thread = threading.Thread(target=single)
        thread.start()
        try:
            ranks = spawn_world(df_rank, 2, (tmp,), timeout_s=DF_TIMEOUT_S)
        finally:
            thread.join()
            if errors:
                raise errors[0]
        world_s = time.time() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError("two ranks on one card must take gloo")
    agreement = df_gates(one, ranks)
    t0 = time.time()
    checks, timed = df_shapes(gen)
    return {"one_rank": one, "ranks": ranks, "agreement": agreement,
            "shape_checks": checks, "tp2_local": timed,
            "single_seconds": one_s[0], "world_seconds": world_s,
            "shapes_seconds": time.time() - t0,
            "seconds": time.time() - t_all}


def log_dist_families(r, smi):
    """Phase 16's report lines."""
    for e in r["ranks"]:
        log(f"[16b dist families] rank {e['rank']} ({e['backend']}, "
            f"{e['device']}): {json.dumps(e)}")
    log(f"[16b dist families] one rank: {json.dumps(r['one_rank'])}")
    log(f"[16b dist families] bf16 legs, rank 0 against one rank (logits "
        f"gap bound {DIST_LOGITS_GAP}): {json.dumps(r['agreement'])}")
    log("[16b dist families] leg | layers | dtype | ticks | eager tick ms "
        "rank 0 / one rank | collectives a tick (KB) | packed MB rank / "
        "whole | "
        "state MB rank / one rank | launches a rank | bodies a step | leg s "
        "rank 0 / one rank")
    for leg in DF_LEGS:
        label = leg[0]
        e, one = r["ranks"][0][label], r["one_rank"][label]
        n = {k: v for k, v in e["launches"].items() if v}
        log(f"[16b dist families] {label} | {e['layers']} | {e['dtype']} | "
            f"{e['ticks']} | {e['tick_ms']:.2f} / {one['tick_ms']:.2f} | "
            f"{e['collectives_per_tick']:.1f} "
            f"({e['collective_bytes_per_tick'] / 1e3:.1f}) | "
            f"{e['packed_bytes'] / 1e6:.1f} / "
            f"{e['whole_packed_bytes'] / 1e6:.1f} | "
            f"{e['state_bytes'] / 1e6:.1f} / {one['state_bytes'] / 1e6:.1f} "
            f"| {json.dumps(n)} | {json.dumps(e['step_bodies'])} | "
            f"{e['seconds']:.1f} / {one['seconds']:.1f}")
    for label in DF_SPLIT_MIXERS:
        e = r["ranks"][0][label]
        log(f"[16b dist families] {label} split by heads: gathered "
            f"{e['gathered']}, {e['row_maps']} row-mapped projections, "
            f"state {e['state_bytes'] / 1e6:.2f} MB a rank against one "
            f"rank's {r['one_rank'][label]['state_bytes'] / 1e6:.2f} MB, "
            f"{e['collective_bytes_per_tick'] / 1e3:.1f} KB of collectives "
            f"a tick")
    errs = {}
    for c in r["shape_checks"]:
        e = errs.setdefault(f"{c['kernel']} {c['tier']} tier Bx "
                            f"{','.join(map(str, c['rows']))}",
                            {"shapes": 0, "bfloat16": 0.0, "float32": 0.0})
        e["shapes"] += 1
        for dt, v in c["max_abs_err"].items():
            e[dt] = max(e[dt], v)
    log(f"[16a dist families] {len(r['shape_checks'])} rank-local packed "
        f"weights (the spec model's draft views among them) against their "
        f"plain versions, max abs err by kernel, tier and rows: "
        f"{json.dumps(errs)}")
    log("[16a dist families] kernel | leg and module | split | O x K local "
        "| ms | bound ms | plain ms | bf16 matmul ms (local dense)")
    for e in r["tp2_local"]:
        log(f"[16a dist families] {e['kernel']} | {e['shape']} | "
            f"{e['split']} | {e['O']} x {e['K']} | {e['ms']:.4f} | "
            f"{e['bound_ms']:.4f} | {e['plain_ms']:.4f} | "
            f"{e['library_ms']:.4f}")
    log(f"[16 dist families] one rank {r['single_seconds']:.1f} s, world "
        f"{r['world_seconds']:.1f} s, 16a {r['shapes_seconds']:.1f} s, phase "
        f"{r['seconds']:.1f} s; {smi}")


# ---------------------------------------------------------------------------
# phase 17: the paper's workloads — the CNN GEMMs of Fig. 6 / Fig. 8 through
# K5 against the engine model, their time on the card, and the packed-API
# leftovers on the card
# ---------------------------------------------------------------------------

# (label, network, seed, mask of a GemmShape, k of the DeMM(8,128,.,k)
# packing: None = the least k whose 8k holds the layer's densest group) —
# the masks ``core.perfmodel.run_network`` draws for the figures
PAPER_PATTERNS = [
    ("fig6 95% unstructured", "resnet50", 0, ("unstructured", 0.95), None),
    ("fig8 1:8", "resnet50", 1, ("nm", 1, 8), 2),
    ("fig8 1:8", "convnext", 1, ("nm", 1, 8), 2),
    ("fig8 1:4", "resnet50", 1, ("nm", 1, 4), 4),
    ("fig8 1:4", "convnext", 1, ("nm", 1, 4), 4),
    ("fig8 1:2", "resnet50", 1, ("nm", 1, 2), 8),
    ("fig8 1:2", "convnext", 1, ("nm", 1, 2), 8),
]
PAPER_N, PAPER_M = 8, 128          # the paper's DeMM(8, 128, 64, 8)


def paper_mask_fn(mask):
    """The figure scripts' ``mask_fn(rng, gemm)`` of a PAPER_PATTERNS
    mask."""
    from repro_torch.core import perfmodel as pm

    if mask[0] == "unstructured":
        return lambda rng, s: pm.unstructured_mask(rng, s.r, s.k, mask[1])
    return lambda rng, s: pm.nm_mask(rng, s.r, s.k, mask[1], mask[2])


def paper_masks(gemms, mask, seed):
    """{layer: (R, K) bool} drawn as ``run_network`` draws them (one rng of
    ``seed``, the sparse layers in order; dense layers draw nothing)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    fn = paper_mask_fn(mask)
    return {s.name: fn(rng, s) for s in gemms if s.sparse}


def paper_problems(gen):
    """Every sparse GEMM of both networks at each pattern: A (R, K) on its
    mask with standard normal values rounded to bf16, K padded with zero
    columns to a multiple of 128 and packed at 8k:128; B (K_pad, P) bf16
    with zero rows past K.  Also each pattern's DeMM cycles per layer
    (x count) from the perf model, checked against ``run_network``'s."""
    import numpy as np
    import torch
    from repro_torch.core import perfmodel as pm
    from repro_torch.core.sparsity import SparsityConfig, pack

    nets = {"resnet50": pm.resnet50_gemms(),
            "convnext": pm.convnext_t_gemms()}
    engine = pm.DeMMEngine(PAPER_N, PAPER_M, 64, 8)
    problems = []
    for label, net, seed, mask, k_fixed in PAPER_PATTERNS:
        gemms = nets[net]
        masks = paper_masks(gemms, mask, seed)
        # the figure's own draw: equal cycles say these are its masks
        want = pm.run_network([engine], gemms, paper_mask_fn(mask),
                              seed=seed)[engine.name]
        for s in gemms:
            if not s.sparse:
                continue
            m = masks[s.name]
            cycles = engine.gemm_cycles(s, m) * s.count
            if cycles != want[s.name]:
                raise AssertionError(f"17 {label} {net} {s.name}: cycles "
                                     f"{cycles} != run_network's "
                                     f"{want[s.name]}")
            k_pad = -(-s.k // PAPER_M) * PAPER_M
            dense_z = int(np.pad(m, ((0, 0), (0, k_pad - s.k))).reshape(
                s.r, -1, PAPER_M).sum(-1).max())
            k = k_fixed or max(1, -(-dense_z // PAPER_N))
            if PAPER_N * k < dense_z:
                raise AssertionError(f"17 {label} {s.name}: a group of "
                                     f"{dense_z} non-zeros > 8 x {k}")
            cfg = SparsityConfig(PAPER_N, PAPER_M, k)
            mk = torch.zeros((s.r, k_pad), dtype=torch.bool,
                             device=gen.device)
            mk[:, :s.k] = torch.from_numpy(m).to(gen.device)
            a = torch.randn((s.r, k_pad), generator=gen, device=gen.device)
            a = torch.where(mk, a, 0.0).to(torch.bfloat16).to(torch.float32)
            p = pack(a, cfg)
            b = torch.zeros((k_pad, s.p), dtype=torch.bfloat16,
                            device=gen.device)
            b[:s.k] = torch.randn((s.k, s.p), generator=gen,
                                  device=gen.device).to(torch.bfloat16)
            problems.append({
                "label": label, "net": net, "layer": s.name, "count": s.count,
                "R": s.r, "K": s.k, "K_pad": k_pad, "P": s.p, "k": k,
                "cfg": cfg, "nnz": int(m.sum()), "densest_group": dense_z,
                "a": a, "packed": p, "vals": p.values.to(torch.bfloat16),
                "b": b, "cycles": cycles})
    return problems


def paper_engine_vs_k5(problems):
    """17a: K5 through ``ops.demm_spmm(..., backend="cuda")`` on every
    problem (the launch count must equal the problems, no other kernel)
    against the engine model ``core.demm.demm_spmm_k_passes`` on the card,
    on the float32 of the same bf16 values and B; float32 tolerance, its
    atol grown as the square root of the products summed past
    ``F32_TERMS``.  Each problem's body is recorded."""
    import torch
    from repro_torch.core.demm import demm_spmm_k_passes
    from repro_torch.kernels import ops
    from repro_torch.kernels.demm_spmm import spmm_body

    for pr in problems:
        pr["body"] = spmm_body(pr["vals"], pr["packed"].indices, pr["b"],
                               PAPER_M)
    torch.cuda.synchronize()
    reset_counts()                       # just before the path ...
    outs = [ops.demm_spmm(pr["vals"], pr["packed"].indices, pr["b"],
                          pr["cfg"], (pr["R"], pr["K_pad"]), backend="cuda",
                          duplicates=False) for pr in problems]
    torch.cuda.synchronize()
    counts = read_counts()               # ... and just after
    want = {name: 0 for name in KERNELS}
    want["demm_spmm"] = len(problems)
    if counts != want:
        raise AssertionError(f"17a launch counts {counts}, expected {want}")
    worst, worst_rel = 0.0, 0.0
    for out, pr in zip(outs, problems):
        engine = demm_spmm_k_passes(pr["packed"], pr["b"].to(torch.float32),
                                    pr["k"])
        terms = (pr["K_pad"] // PAPER_M) * PAPER_N * pr["k"]
        tol = dict(TOL["float32"])
        if terms > F32_TERMS:
            tol["atol"] *= (terms / F32_TERMS) ** 0.5
        what = f"17a {pr['label']} {pr['net']} {pr['layer']}"
        if out.shape != (pr["R"], pr["P"]) or not torch.isfinite(out).all():
            raise AssertionError(f"{what}: bad output {tuple(out.shape)}")
        torch.testing.assert_close(out, engine, **tol,
                                   msg=lambda m: f"{what}: {m}")
        err = float((out - engine).abs().max())
        pr["max_abs_err"] = err
        worst = max(worst, err)
        worst_rel = max(worst_rel, err / max(float(engine.abs().max()),
                                             1e-30))
    bodies = {}
    for pr in problems:
        key = f"{pr['label']} {pr['net']}"
        bodies.setdefault(key, {}).setdefault(pr["body"], 0)
        bodies[key][pr["body"]] += 1
    return {"problems": len(problems), "launches": counts["demm_spmm"],
            "max_abs_err": worst, "max_rel_err": worst_rel,
            "bodies": bodies}


def paper_times(problems):
    """17b: per network and pattern, the layers' K5 device ms (graph
    replays of a ring of operand copies larger than L2, as phase 7 times)
    weighted by each layer's count and summed, the bound of the unpadded
    GEMM (bf16 values + int32 indices of its ceil(K / 128) groups, bf16 B
    of (K, P), float32 C, each once at 3.35 TB/s, or the non-zeros'
    2 x nnz x P operations at the bf16 peak, whichever is larger) and one
    bf16 ``torch.matmul`` of the unpadded dense A (R, K) by B (K, P)
    (timed once per layer shape: its time does not depend on the pattern).
    Also, apart from the rows (they go into the kernels line), the perf
    model's DeMM ms at 500 MHz per row — the paper's modelled 512-MAC
    engine, not a measurement, so only logged."""
    import torch
    from repro_torch.core import perfmodel as pm
    from repro_torch.kernels.demm_spmm import demm_spmm

    library = {}
    rows = {}
    cycles = {}
    for pr in problems:
        vals, idx, b, cfg = pr["vals"], pr["packed"].indices, pr["b"], pr["cfg"]
        c_bytes = pr["R"] * pr["P"] * 4
        r = ring((vals, idx, b), vals.nbytes + idx.nbytes + b.nbytes
                 + c_bytes)
        ms = time_ring([lambda v=v, i=i, bb=bb: demm_spmm(
            v, i, bb, cfg, duplicates=False) for v, i, bb in r],
            passes=3)[0]
        del r
        key = (pr["net"], pr["layer"])
        b_bytes = pr["K"] * pr["P"] * b.element_size()
        if key not in library:
            a = pr["a"][:, :pr["K"]].to(torch.bfloat16).contiguous()
            bk = b[:pr["K"]].contiguous()
            r = ring((a, bk), a.nbytes + b_bytes + c_bytes // 2)
            library[key] = time_ring([lambda aa=aa, bb=bb: torch.matmul(
                aa, bb) for aa, bb in r], passes=3)[0]
            del r, a, bk
        nbytes = vals.nbytes + idx.nbytes + b_bytes + c_bytes
        t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        t_ops = 1e3 * 2 * pr["nnz"] * pr["P"] / PEAK_OPS_PER_S["bfloat16"]
        pr.update(ms=ms, bound_ms=max(t_bytes, t_ops),
                  bound_by="bytes" if t_bytes >= t_ops else "operations",
                  library_ms=library[key])
        row = rows.setdefault((pr["label"], pr["net"]), {
            "pattern": pr["label"], "network": pr["net"], "layers": 0,
            "launches_weighted": 0, "ms": 0.0, "bound_ms": 0.0,
            "library_ms": 0.0, "tiled_share_of_ms": 0.0, "k": set()})
        row["layers"] += 1
        row["launches_weighted"] += pr["count"]
        for key2 in ("ms", "bound_ms", "library_ms"):
            row[key2] += pr["count"] * pr[key2]
        if pr["body"] == "tiled":
            row["tiled_share_of_ms"] += pr["count"] * ms
        cycles[pr["label"], pr["net"]] = (
            cycles.get((pr["label"], pr["net"]), 0) + pr["cycles"])
        row["k"].add(pr["k"])
        torch.cuda.empty_cache()
    out = []
    for row in rows.values():
        row["tiled_share_of_ms"] /= row["ms"]
        row["k"] = sorted(row["k"])
        row["bound_share"] = row["bound_ms"] / row["ms"]
        out.append(row)
    modelled = {key: 1e3 * c / pm.CLOCK_HZ for key, c in cycles.items()}
    return out, modelled


def paper_leftovers(gen):
    """17c: the packed-API leftovers on the card, counted from just before
    to just after: an ``activation_calibration``-quantized stablelm_3b gate
    projection (6912 x 2560, 5:80) through K3 at Bx = 4; the two slices of
    ``pack_block_stacked`` of a two-layer 2560 x 2560 weight through K2;
    ``apply_packed`` of a 2560 x 2560 8:128 weight re-tagged as two passes
    of 4:128 through K1 — each against its plain version (bf16 tolerance).
    The re-tagging keeps the stored layout (``_reconfigure`` allows only
    an unchanged n_effective), so K1 runs the stored pattern."""
    import torch
    from repro_torch.core.sparse_linear import apply_packed
    from repro_torch.core.sparsity import (PackedWeight, SparsityConfig,
                                           pack_block_stacked, prune)
    from repro_torch.kernels import ops
    from repro_torch.kernels.demm_block_spmm import demm_block_spmm_plain
    from repro_torch.kernels.demm_q8 import demm_xwT_q8_plain
    from repro_torch.kernels.demm_xwT import demm_xwT_plain
    from repro_torch.quant import (activation_calibration, amax_scales,
                                   quantize_packed)

    dev = gen.device

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # K3: the gate projection calibrated on 16 activation rows
    cfg = SparsityConfig(5, 80)
    pw = PackedWeight.from_dense(randn(6912, 2560), cfg)
    x_cal = randn(16, 2560) * torch.exp(randn(2560))
    obs = activation_calibration(x_cal)
    qw = quantize_packed(pw, observer=obs)
    clipped = float((qw.scales < amax_scales(pw) * (1 - 1e-6)).float()
                    .mean())
    x4 = randn(4, 2560).to(torch.bfloat16)
    # pack_block_stacked: two layers, one shared a_max
    wst = prune(randn(2, 2560, 2560).reshape(-1, 2560), cfg).reshape(
        2, 2560, 2560)
    slices = pack_block_stacked(wst, cfg)
    # apply_packed re-tagged: 8:128 stored, served as 2 x 4:128
    cfg8 = SparsityConfig(8, 128)
    pk = PackedWeight.from_dense(randn(2560, 2560), cfg8)
    torch.cuda.synchronize()
    reset_counts()                       # just before the path ...
    y_q = ops.demm_matmul_packed(x4, qw, backend="cuda")
    y_s = [ops.demm_matmul_packed(x4, s, backend="cuda") for s in slices]
    y_a = apply_packed(pk, x4, cfg=SparsityConfig(4, 128, 2),
                       backend="cuda")
    torch.cuda.synchronize()
    counts = read_counts()               # ... and just after
    want = {name: 0 for name in KERNELS}
    want.update({"demm_xwT_q8": 1, "demm_block_spmm": 2, "demm_xwT": 1})
    if counts != want:
        raise AssertionError(f"17c launch counts {counts}, expected {want}")
    errs = {}

    def check(name, got, ref):
        torch.testing.assert_close(got.to(torch.float32), ref,
                                   **TOL["bfloat16"],
                                   msg=lambda m: f"17c {name}: {m}")
        errs[name] = max(errs.get(name, 0.0),
                         float((got.to(torch.float32) - ref).abs().max()))

    check("activation_calibration K3", y_q,
          demm_xwT_q8_plain(x4, qw.values, qw.indices, qw.scales, cfg))
    for s, y in zip(slices, y_s):
        check("pack_block_stacked K2", y, demm_block_spmm_plain(
            s.active_groups, s.values, s.indices, x4.T, cfg,
            r=s.out_features).T)
    check("apply_packed K1", y_a,
          demm_xwT_plain(x4, pk.values, pk.indices, cfg8))
    if len({tuple(s.block_geom) for s in slices}) != 1:
        raise AssertionError("17c pack_block_stacked: slices' geometries "
                             "differ")
    return {"launches": {k: v for k, v in counts.items() if v},
            "max_abs_err": errs,
            "calibrated_rows_clipped_below_amax": clipped,
            "stacked_block_geom": list(slices[0].block_geom)}


def paper_phase(gen):
    """Phase 17."""
    t0 = time.time()
    problems = paper_problems(gen)
    t_build = time.time() - t0
    t1 = time.time()
    engine = paper_engine_vs_k5(problems)
    t_a = time.time() - t1
    t1 = time.time()
    times, modelled = paper_times(problems)
    t_b = time.time() - t1
    t1 = time.time()
    left = paper_leftovers(gen)
    t_c = time.time() - t1
    per_problem = [{k: pr[k] for k in (
        "label", "net", "layer", "count", "R", "K", "K_pad", "P", "k",
        "nnz", "densest_group", "body", "max_abs_err", "ms", "bound_ms",
        "bound_by", "library_ms")} for pr in problems]
    del problems
    import torch
    torch.cuda.empty_cache()
    return {"engine_vs_k5": engine, "times": times, "leftovers": left,
            "problems": per_problem,
            "seconds": {"build": t_build, "a": t_a, "b": t_b, "c": t_c,
                        "phase": time.time() - t0}}, modelled


def log_paper(r, modelled, smi):
    """Phase 17's report lines; ``modelled`` (the perf model's DeMM ms by
    pattern and network) goes into the 17b lines only."""
    e = r["engine_vs_k5"]
    log(f"[17a paper] K5 (ops.demm_spmm, backend cuda) against the engine "
        f"model demm_spmm_k_passes on {e['problems']} GEMMs: launches "
        f"{e['launches']}, max abs err {e['max_abs_err']:.3g} (rel "
        f"{e['max_rel_err']:.3g}); bodies {json.dumps(e['bodies'])}")
    log("[17b paper] pattern | network | layers (weighted launches) | k | "
        "K5 ms | bound ms (share) | bf16 matmul ms | tiled body's share of "
        "K5 ms | modelled DeMM(8,128,64,8) ms at 500 MHz (the paper's "
        "512-MAC engine, not a measurement)")
    for row in r["times"]:
        log(f"[17b paper] {row['pattern']} | {row['network']} | "
            f"{row['layers']} ({row['launches_weighted']}) | {row['k']} | "
            f"{row['ms']:.4f} | {row['bound_ms']:.4f} "
            f"({100 * row['bound_share']:.1f} %) | {row['library_ms']:.4f} "
            f"| {100 * row['tiled_share_of_ms']:.1f} % | "
            f"{modelled[(row['pattern'], row['network'])]:.4f}")
    log(f"[17c paper] leftovers on the card: {json.dumps(r['leftovers'])}")
    s = r["seconds"]
    log(f"[17 paper] build {s['build']:.1f} s, 17a {s['a']:.1f} s, 17b "
        f"{s['b']:.1f} s, 17c {s['c']:.1f} s, phase {s['phase']:.1f} s; "
        f"{smi}")


# ---------------------------------------------------------------------------
# phase 7: times
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# phase 18: the dry-run census against the card
# ---------------------------------------------------------------------------

def census_vs_engine(engine, cfg):
    """18a: the census of one packed decode step of phase 4's cell on the
    meta device against ``engine`` (phase 4's xwT engine, drained): its
    argument bytes and packed-matmul count must equal the engine's tensors'
    bytes and one eager step's K1 launches exactly; its peak live bytes and
    ``memory_s`` are set against the ``max_memory_allocated`` rise of that
    step and a captured step's device time."""
    import torch
    from repro_torch.core.sparse_linear import ExecPolicy
    from repro_torch.launch import census, dryrun
    from repro_torch.launch.pack_tree import pack_tree_shapes
    from repro_torch.launch.specs import meta_model

    t0 = time.time()
    slots, max_len = engine.cfg.num_slots, engine.cfg.max_len
    model = pack_tree_shapes(meta_model(cfg))
    state = model.init_decode_state(slots, max_len, dtype=torch.float32,
                                    device="meta")
    tokens = torch.empty(tuple(engine._tokens.shape),
                         dtype=engine._tokens.dtype, device="meta")
    policy = ExecPolicy(mode="packed")

    def step(state, tokens):
        with torch.no_grad():
            return model.decode_step(state, tokens, policy=policy)

    _, a, census_s = census.run(step, state, tokens,
                                arguments=(model, state, tokens))
    engine_bytes = census.tree_bytes((engine.model, engine.state,
                                      engine._tokens))
    if a.argument_bytes != engine_bytes:
        raise AssertionError(f"census argument bytes {a.argument_bytes} != "
                             f"the engine's {engine_bytes}")
    # one eager step on the engine's tensors: K1's launches and the rise
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with torch.no_grad():
        engine.model.decode_step(engine.state, engine._tokens,
                                 policy=engine.policy)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    launches = read_counts()
    want = {"demm_xwT": a.packed_launches.get("xwT", 0)}
    got = {k: v for k, v in launches.items() if v}
    if got != want or want["demm_xwT"] != 7 * cfg.num_layers:
        raise AssertionError(f"census packed matmuls {a.packed_launches} "
                             f"!= one eager step's launches {got}")
    step_ms = graph_device_ms(engine._graph)
    memory_ms = 1e3 * a.bytes_accessed / dryrun.HBM_BW
    return {"census_s": census_s, "argument_bytes": a.argument_bytes,
            "engine_bytes": engine_bytes,
            "packed_matmuls": a.packed_launches["xwT"],
            "k1_launches_eager_step": got["demm_xwT"],
            "census_temp_bytes": a.peak_live_bytes,
            "census_peak_bytes": a.peak_bytes,
            "eager_step_allocated_rise": rise,
            "temp_over_rise": a.peak_live_bytes / rise if rise else None,
            "census_bytes_accessed": a.bytes_accessed,
            "census_memory_ms": memory_ms,
            "graph_step_device_ms": step_ms,
            "memory_ms_over_step_ms": memory_ms / step_ms,
            "seconds": time.time() - t0}


def census_row():
    """18b: the census record of ``stablelm_3b decode_32k --packed`` on
    ``pod16x16`` (meta device, host only)."""
    from repro_torch.launch import dryrun

    t0 = time.time()
    rec = dryrun.lower_cell("stablelm_3b", "decode_32k", packed=True)
    if rec["cost_analysis"]["packed_launches"] != {"xwT": 224} or \
            not rec["memory_analysis"]["peak_bytes"] < dryrun.HBM_BYTES:
        raise AssertionError(f"census row: {json.dumps(rec)}")
    return rec, time.time() - t0


def log_census(a, row, row_s, smi):
    """Phase 18's report lines."""
    log(f"[18a census] phase 4's cell (stablelm_3b, 32 layers, packed xwT, "
        f"4 slots, max_len 64) on the meta device: argument bytes "
        f"{a['argument_bytes']} = the engine's {a['engine_bytes']}; packed "
        f"matmuls {a['packed_matmuls']} = one eager step's K1 launches "
        f"{a['k1_launches_eager_step']}; census temp bytes "
        f"{a['census_temp_bytes']} / the eager step's max_memory_allocated "
        f"rise {a['eager_step_allocated_rise']} = {a['temp_over_rise']:.3f}"
        f"; census memory_s {a['census_memory_ms']:.4f} ms / a captured "
        f"step's device time {a['graph_step_device_ms']:.4f} ms = "
        f"{a['memory_ms_over_step_ms']:.3f}; census {a['census_s']:.2f} s, "
        f"18a {a['seconds']:.1f} s; {smi}")
    log(f"[18b census] stablelm_3b decode_32k --packed pod16x16 "
        f"({row_s:.1f} s): {json.dumps(row)}; {smi}")


def time_ring(calls, passes=7):
    """Device time and host-issued time of one call, in ms.

    The ring of calls is captured once into a CUDA graph and the graph is
    replayed between two CUDA events: the launches then run back to back on
    the device, so the quotient is the calls' device time and not the time
    Python takes to issue them.  The second number is the same ring issued
    eagerly from Python, which is what a caller that launches one by one
    waits for.  Both are medians over ``passes``."""
    import torch

    def timed(run):
        times = []
        for _ in range(passes):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end) / len(calls))
        return statistics.median(times)

    def eager():
        for c in calls:
            c()

    eager()                              # warm up
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        eager()
    graph.replay()
    torch.cuda.synchronize()
    return timed(graph.replay), timed(eager)


def ring_size(nbytes, target=4 * L2_BYTES, lo=4, hi=128):
    return int(min(hi, max(lo, -(-target // nbytes))))


def timed_entry(meta, kern, plain, nbytes, ops, *, sweep=(), variants=None):

    """One timing row: the kernel over its ring (graph replay and eager),
    the plain version over the first copies, and the bound from the bytes
    each input and output must cross once and the operations at the bf16
    peak.  ``sweep`` times ``rows_per_block`` values; ``variants`` maps a
    key of the row to {label: keyword arguments of the call} and times
    each (a launcher's refusal is recorded; any other error fails the run
    where it happens)."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * ops / PEAK_OPS_PER_S["bfloat16"]
    ms, eager_ms = time_ring(kern)
    entry = {**meta, "ring_copies": len(kern), "bytes": nbytes, "ms": ms,
             "eager_ms": eager_ms,
             "plain_ms": time_ring(plain[:8], passes=3)[0],
             "bound_ms": max(t_bytes, t_ops),
             "bound_by": "bytes" if t_bytes >= t_ops else "operations",
             "achieved_GBps": nbytes / ms / 1e6}
    if sweep:
        entry["rows_per_block_ms"] = {
            str(r): time_ring([lambda c=c, r=r: c(rows_per_block=r)
                               for c in kern], passes=5)[0]
            for r in sweep}
    if variants:
        from repro_torch.kernels.demm_xwT import LaunchRefused
    for key, cases in (variants or {}).items():
        entry[key] = {}
        for label, kw in cases.items():
            try:
                entry[key][label] = time_ring(
                    [lambda c=c, kw=kw: c(**kw) for c in kern], passes=5)[0]
            except LaunchRefused as e:    # e.g. stages that do not fit
                entry[key][label] = f"refused: {e}"
    return entry


def ring(tensors, nbytes):
    """Copies of ``tensors`` (a tuple) enough to exceed L2 several times."""
    copies = ring_size(nbytes)
    return list(zip(*(t.repeat(copies, *([1] * t.ndim)).unbind(0)
                      for t in tensors)))


def shape_inputs(label, o, k, n, m, gen, bx=4):
    """The Bx = 4 (or ``bx``) bf16 activations and one random packed weight
    (float, and int8 with per-row and with per-group scales) of a projection
    shape, with the timing rows' metadata."""
    import torch
    g = k // m
    x = torch.randn((bx, k), generator=gen, device=gen.device).to(torch.bfloat16)
    vals, idx = make_packed(o, k, n, m, gen)
    q, per_row = make_q8(o, g, n, False, gen)
    scales = {"per_row": per_row, "per_group": make_q8(o, g, n, True, gen)[1]}
    meta = {"shape": label, "O": o, "K": k, "pattern": f"{n}:{m}", "Bx": bx,
            "x_dtype": "bfloat16"}
    return x, vals, idx, q, scales, meta


def time_xwt(x, vals, idx, q, scales, cfg, meta, *, sweep=(), extra=None):
    """K1 and K3 as the main path launches them, K3 with each of the
    ``scales`` ({"per_row": (O,), "per_group": (O, G)}); with the sweep on,
    both kernels' bulk-body tunables (rows per CTA, chunks) and their gather
    body, K3's also at the gather body's rows per block ``sweep``;
    ``extra``: more variants of both, as ``timed_entry`` takes them.  (A
    checkout from before the duplicate repair has no ``duplicates`` flag:
    its one instantiation is the main path's; one from before K3's bulk
    body has no K3 hook and runs the gather body.)"""
    import inspect
    from repro_torch.kernels import demm_q8 as kq
    from repro_torch.kernels import demm_xwT as kx
    demm_xwT_q8, demm_xwT_q8_plain = kq.demm_xwT_q8, kq.demm_xwT_q8_plain

    demm_xwT, demm_xwT_plain = kx.demm_xwT, kx.demm_xwT_plain
    main = ({"duplicates": False}
            if "duplicates" in inspect.signature(demm_xwT).parameters else {})
    bx, o = x.shape[0], vals.shape[0]
    nnz = int((vals != 0).sum())
    y_bytes = bx * o * 4
    out = {}
    w_bytes = vals.nbytes + idx.nbytes
    r = ring((vals, idx), w_bytes)

    def k1(v, i, body=None, **kw):
        if body is None and not {"chunks", "tile"} & kw.keys():
            return demm_xwT(x, v, i, cfg, **main, **kw)
        return kx.demm_xwT_on(body, x, v, i, cfg, **main, **kw)

    variants = None
    if sweep:
        variants = {
            "bulk_rows_ms": {str(n): {"rows_per_block": n} for n in BULK_ROWS},
            "bulk_chunks_ms": {str(c): {"chunks": c} for c in BULK_CHUNKS},
            "gather_body_ms": {"default": {"body": "gather"}}}
    if extra:
        variants = {**(variants or {}), **extra}
    out["demm_xwT"] = [timed_entry(
        {**meta, "body": kx.xwt_body(x, vals, idx, cfg.m, **main)
         if hasattr(kx, "xwt_body") else "gather"},
        [lambda v=v, i=i, **kw: k1(v, i, **kw) for v, i in r],
        [lambda v=v, i=i: demm_xwT_plain(x, v, i, cfg) for v, i in r],
        x.nbytes + w_bytes + y_bytes, 2 * bx * nnz, variants=variants)]
    has_bulk = hasattr(kq, "demm_xwT_q8_on")

    def k3(v, i, sc, body=None, **kw):
        if body is None and not {"chunks", "lanes", "tile"} & kw.keys():
            return demm_xwT_q8(x, v, i, sc, cfg, **main, **kw)
        return kq.demm_xwT_q8_on(body, x, v, i, sc, cfg, **main, **kw)

    if sweep and has_bulk:
        variants = {**variants, **(extra or {}), "bulk_lanes_ms": {
            str(n): {"lanes": n} for n in BULK_LANES}, "gather_body_ms": {
            "default": {"body": "gather"},
            **{f"rows_per_block={n}": {"body": "gather", "rows_per_block": n}
               for n in sweep}}}
    out["demm_xwT_q8"] = []
    for unit, sc0 in scales.items():
        w_bytes = q.nbytes + idx.nbytes + sc0.nbytes
        r = ring((q, idx, sc0), w_bytes)
        body = (kx.xwt_body(x, q, idx, cfg.m, scales=sc0, **main)
                if has_bulk else "gather")
        out["demm_xwT_q8"].append(timed_entry(
            {**meta, "scales": unit, "body": body},
            [lambda v=v, i=i, sc=sc, **kw: k3(v, i, sc, **kw)
             for v, i, sc in r],
            [lambda v=v, i=i, sc=sc: demm_xwT_q8_plain(x, v, i, sc, cfg)
             for v, i, sc in r],
            x.nbytes + w_bytes + y_bytes, 2 * bx * nnz,
            sweep=() if has_bulk else sweep, variants=variants))
        del r
    return out


# --sweep: the redesigned bodies' tunables
CLUSTER_SIZES = (1, 2, 4, 8)
BULK_CHUNKS = (1, 2, 4, 16)
BULK_LANES = (8, 16)
BULK_ROWS = (8, 12, 16, 20, 24, 32, 40, 53, 64)
BULK_SMEM_BYTES = 232448     # an H100 block's shared memory (opt-in)
TC_TILES = ((128, 1), (128, 2), (256, 1), (256, 2))
TC_GROUPS = (1, 2, 3, 4)
TC_STAGES = (2, 3, 4)
SPMM_CROSSOVER_CDS = (16, 32, 64, 128, 256)


def time_block(x, vals, idx, cfg, meta, *, sweep=False):
    """K2 and K4 on the block layout of the same weight as ``vals, idx``
    (every group active, a_max = G), B = xᵀ as serving passes it; with the
    sweep on, also their cluster sizes and gather body.  Returns the dense
    weight and {kernel: [timing row]}."""
    from repro_torch.core.sparsity import pack_block, unpack
    from repro_torch.kernels.demm_block_spmm import (block_body,
                                                     demm_block_spmm_on)
    from repro_torch.kernels.demm_q8 import (block_q8_body,
                                             demm_block_spmm_q8_on)
    from repro_torch.quant import quantize_packed

    fns = kernel_fns()
    bx, o, k = x.shape[0], vals.shape[0], x.shape[1]
    nnz = int((vals != 0).sum())
    y_bytes = bx * o * 4
    out = {}
    variants = ({"cluster_size_ms": {
        str(c): {"cluster_size": c} for c in CLUSTER_SIZES},
        "gather_body_ms": {"default": {"body": "gather"}}}
        if sweep else None)
    dense = unpack(vals, idx, cfg, (o, k))
    pw = pack_block(dense, cfg)
    bmeta = {**meta, "block_geom": list(pw.block_geom)}
    xt = x.T
    kern, plain = fns["demm_block_spmm"]
    w_bytes = pw.values.nbytes + pw.indices.nbytes + pw.active_groups.nbytes
    r = ring((pw.active_groups, pw.values, pw.indices), w_bytes)

    def k2(a, v, i, body=None, **kw):
        if body is None:
            return kern(a, v, i, xt, cfg, r=o, duplicates=False, **kw)
        return demm_block_spmm_on(body, a, v, i, xt, cfg, r=o,
                                  duplicates=False, **kw)

    out["demm_block_spmm"] = [timed_entry(
        {**bmeta, "body": block_body(pw.active_groups, pw.values, pw.indices,
                                     xt, cfg.m)},
        [lambda a=a, v=v, i=i, **kw: k2(a, v, i, **kw) for a, v, i in r],
        [lambda a=a, v=v, i=i: plain(a, v, i, xt, cfg, r=o) for a, v, i in r],
        x.nbytes + w_bytes + y_bytes, 2 * bx * nnz, variants=variants)]
    qw = quantize_packed(pw)
    kern, plain = fns["demm_block_spmm_q8"]
    w_bytes = (qw.values.nbytes + qw.indices.nbytes + qw.active_groups.nbytes
               + qw.scales.nbytes)
    r = ring((qw.active_groups, qw.values, qw.indices, qw.scales), w_bytes)

    def k4(a, v, i, sc, body=None, **kw):
        if body is None:
            return kern(a, v, i, sc, xt, cfg, r=o, duplicates=False, **kw)
        return demm_block_spmm_q8_on(body, a, v, i, sc, xt, cfg, r=o,
                                     duplicates=False, **kw)

    out["demm_block_spmm_q8"] = [timed_entry(
        {**bmeta, "body": block_q8_body(qw.values, qw.indices, qw.scales, xt,
                                        cfg.m)},
        [lambda a=a, v=v, i=i, sc=sc, **kw: k4(a, v, i, sc, **kw)
         for a, v, i, sc in r],
        [lambda a=a, v=v, i=i, sc=sc: plain(a, v, i, sc, xt, cfg, r=o)
         for a, v, i, sc in r],
        x.nbytes + w_bytes + y_bytes, 2 * bx * nnz, variants=variants)]
    return dense, out


def library_ms(x, dense):
    """The yardstick of K1-K4: one bf16 ``torch.matmul`` of x against the
    dense weight, over a ring of weight copies larger than L2."""
    import torch
    w = dense.to(torch.bfloat16)
    wr = [wt.T for wt in w.repeat(ring_size(w.nbytes, hi=32), 1, 1).unbind(0)]
    return time_ring([lambda wt=wt: torch.matmul(x, wt) for wt in wr])[0]


def time_prefill_bodies(label, o, k, n, m, gen, bx=32):
    """K1-K4 at one projection shape with x of ``bx`` rows (bf16), as a
    prefill chunk launches them: K1 and K3 on their wide body, their gather
    body timed beside it through the measurement hooks
    (``gather_body_ms``), K2 and K4 on their gather body (the bulk and
    cluster bodies take at most 8 rows), K3 with per-row scales as served
    and with per-group scales.  Rows as :func:`time_shape`'s, with the
    library yardstick."""
    from repro_torch.core.sparsity import SparsityConfig

    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen,
                                                 bx=bx)
    out = time_xwt(x, vals, idx, q, scales, cfg, meta,
                   extra={"gather_body_ms": {"default": {"body": "gather"}}})
    dense, blocks = time_block(x, vals, idx, cfg, meta)
    out.update(blocks)
    lib = library_ms(x, dense)
    for name, entries in out.items():
        for e in entries:
            e["library_ms"] = lib
            if e["body"] != PREFILL_BODY[name]:
                raise AssertionError(f"{label} {name} at Bx = {bx}: "
                                     f"{e['body']} body, expected "
                                     f"{PREFILL_BODY[name]}")
    return out


# the paper's example at prefill width (benchmarks/torch_run.py's shape)
WIDE_BIG = ("6912x2560 8:128", 6912, 2560, 8, 128, 2048)


def time_wide_big(gen):
    """K1 and K3 (per-row scales) on the wide body at 2048 rows of bf16 x
    on 6912 x 2560 at 8:128, the gather body beside them through the
    measurement hooks, with bound and the library yardstick: {kernel:
    row}."""
    from repro_torch.core.sparsity import SparsityConfig

    label, o, k, n, m, bx = WIDE_BIG
    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen,
                                                 bx=bx)
    out = time_xwt(x, vals, idx, q, {"per_row": scales["per_row"]}, cfg,
                   meta,
                   extra={"gather_body_ms": {"default": {"body": "gather"}}})
    from repro_torch.core.sparsity import unpack
    lib = library_ms(x, unpack(vals, idx, cfg, (o, k)))
    rows = {}
    for name, entries in out.items():
        e = entries[0]
        if e["body"] != "wide":
            raise AssertionError(f"{label} {name} at Bx = {bx}: {e['body']} "
                                 "body, expected wide")
        e["library_ms"] = lib
        e["gather_ms"] = e.pop("gather_body_ms")["default"]
        rows[name] = e
    return rows


# builds of the wide body in pieces (--wide-pieces): the library's, one
# without the products, one without reading a packed byte
WIDE_PIECES = (("full", ""), ("no products", "-DDEMM_WIDE_NO_PRODUCTS"),
               ("no pairs", "-DDEMM_WIDE_NO_PAIRS"))


def wide_piece_times():
    """Device ms of the wide body of the library this process built (its
    flags from ``$REPRO_TORCH_NVCC_FLAGS``): K1 and K3 (per-row scales) per
    stablelm_3b layer at Bx = 32, K1 on 6912 x 2560 8:128 at Bx = 2048
    (graph replays of a ring larger than L2)."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels.demm_q8 import demm_xwT_q8_on
    from repro_torch.kernels.demm_xwT import demm_xwT_on
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    out = {"k1_bx32_layer_ms": 0.0, "k3_bx32_layer_ms": 0.0}
    for label, o, k, n, m in MAIN_SHAPES:
        cfg = SparsityConfig(n, m)
        x, vals, idx, q, scales, _ = shape_inputs(label, o, k, n, m, gen,
                                                  bx=32)
        r = ring((vals, idx), vals.nbytes + idx.nbytes)
        out["k1_bx32_layer_ms"] += LAYER_MIX[label] * time_ring(
            [lambda v=v, i=i: demm_xwT_on("wide", x, v, i, cfg,
                                          duplicates=False)
             for v, i in r])[0]
        sc = scales["per_row"]
        r = ring((q, idx, sc), q.nbytes + idx.nbytes + sc.nbytes)
        out["k3_bx32_layer_ms"] += LAYER_MIX[label] * time_ring(
            [lambda v=v, i=i, sc=sc: demm_xwT_q8_on(
                "wide", x, v, i, sc, cfg, duplicates=False)
             for v, i, sc in r])[0]
    label, o, k, n, m, bx = WIDE_BIG
    cfg = SparsityConfig(n, m)
    x, vals, idx, _, _, _ = shape_inputs(label, o, k, n, m, gen, bx=bx)
    r = ring((vals, idx), vals.nbytes + idx.nbytes)
    out["k1_bx2048_ms"] = time_ring(
        [lambda v=v, i=i: demm_xwT_on("wide", x, v, i, cfg, duplicates=False)
         for v, i in r])[0]
    return out


def wide_pieces():
    """The wide body timed in pieces: each build of :data:`WIDE_PIECES` in
    its own process and library (the flags are part of the library's
    hash), in turns the builds in order, then in reverse order.  {piece:
    [rows]}."""
    import subprocess
    out = {}
    order = list(WIDE_PIECES) + list(reversed(WIDE_PIECES))
    for name, flags in order:
        env = dict(os.environ)
        env["REPRO_TORCH_NVCC_FLAGS"] = " ".join(
            f for f in (env.get("REPRO_TORCH_NVCC_FLAGS", ""), flags) if f)
        res = subprocess.run([sys.executable, __file__, "--piece-times"],
                             env=env, capture_output=True, text=True,
                             timeout=600)
        if res.returncode != 0:
            raise RuntimeError(f"piece {name}: {res.stderr[-2000:]}")
        out.setdefault(name, []).append(
            json.loads(res.stdout.strip().splitlines()[-1]))
    return out


def time_shape(label, o, k, n, m, gen, *, sweep=(), block_sweep=()):
    """Times of the five kernels at one projection shape: K1-K4 at Bx = 4
    with bfloat16 activations, as the main path launches them; K5 at
    Cd = 4 and 256 with B (K, Cd) bfloat16.  With the sweep on, also K4's
    cluster sizes and its gather body, K5's tiles, groups per stage and
    stages at Cd = 256 (through the kernels' measurement hooks), and
    both K5 bodies at Cd from 16 to 256 (where the tiled body starts to
    win)."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig
    from repro_torch.kernels.demm_spmm import demm_spmm_on, spmm_body

    fns = kernel_fns()
    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen)
    nnz = int((vals != 0).sum())
    out = time_xwt(x, vals, idx, q, scales, cfg, meta, sweep=sweep)

    dense, blocks = time_block(x, vals, idx, cfg, meta, sweep=bool(sweep))
    out.update(blocks)
    lib = library_ms(x, dense)
    for entries in out.values():
        for e in entries:
            e["library_ms"] = lib
    w = dense.to(torch.bfloat16)

    # K5, the paper orientation C = A @ B, with B of 4 and 256 columns; its
    # yardstick is the dense bf16 product A @ B
    kern, plain = fns["demm_spmm"]
    w_bytes = vals.nbytes + idx.nbytes
    r = ring((vals, idx), w_bytes)
    wr = list(w.repeat(ring_size(w.nbytes, hi=32), 1, 1).unbind(0))
    out["demm_spmm"] = []

    def k5(v, i, b, body=None, groups_per_stage=None, **kw):
        if body is None and groups_per_stage is None:
            return kern(v, i, b, cfg, duplicates=False, **kw)
        return demm_spmm_on(body, v, i, b, cfg, duplicates=False,
                            groups_per_stage=groups_per_stage, **kw)

    for cd in (4, 256):
        b = torch.randn((k, cd), generator=gen, device=gen.device)
        b = b.to(torch.bfloat16)
        tiled = spmm_body(vals, idx, b, m) == "tiled"
        variants = None
        if sweep and tiled:
            # columns x rows / groups per stage / stages
            variants = {"tile_groups_stages_ms": {
                f"{t[0]}x{64 * t[1]}/{ng}/{st}":
                    {"tile": t, "groups_per_stage": ng, "stages": st}
                for t in TC_TILES for ng in TC_GROUPS for st in TC_STAGES}}
        e = timed_entry(
            {**meta, "Bx": cd, "Cd": cd, "B_dtype": "bfloat16",
             "body": spmm_body(vals, idx, b, m)},
            [lambda v=v, i=i, b=b, **kw: k5(v, i, b, **kw) for v, i in r],
            [lambda v=v, i=i, b=b: plain(v, i, b, cfg) for v, i in r],
            b.nbytes + w_bytes + o * cd * 4, 2 * cd * nnz,
            sweep=() if tiled else block_sweep, variants=variants)
        e["library_ms"] = time_ring(
            [lambda wt=wt, b=b: torch.matmul(wt, b) for wt in wr])[0]
        out["demm_spmm"].append(e)
    if sweep:
        # both bodies at widths around the switch (TILED_MIN_CD)
        cross = {}
        for cd in SPMM_CROSSOVER_CDS:
            b = torch.randn((k, cd), generator=gen,
                            device=gen.device).to(torch.bfloat16)
            cross[str(cd)] = {
                body: time_ring([lambda v=v, i=i, b=b, body=body:
                                 k5(v, i, b, body=body) for v, i in r],
                                passes=5)[0]
                for body in ("tiled", "gather")}
        out["demm_spmm"][-1]["body_ms_by_cd"] = cross
    del r, wr, w, dense
    torch.cuda.empty_cache()
    return out


def tier_times(gen, tiers=(8, 6, 4)):
    """Phase 7s: what a draft-tier launch costs against the full tier's.
    K1, K3 (per-row scales), K2 and K4 at the three projection shapes
    stored at 8:16, x bf16 of 4 rows (the bulk / cluster bodies) and of 32
    rows (the gather bodies), reading the prefix views ``[..., :t]`` for t
    in ``tiers`` (8: the full tier); device ms per launch from a graph of a
    ring of weight copies larger than L2 (``time_ring``).  The bound counts
    the bytes the tier needs: x, y and the prefix's pairs (t of 8 per
    group), scales and group ids."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, pack_block
    from repro_torch.quant import quantize_packed

    fns = kernel_fns()
    n, m = 8, 16
    rows = []
    for label, o, k, _, _ in MAIN_SHAPES:
        g = k // m
        vals, idx = make_packed(o, k, n, m, gen)
        q, scales = make_q8(o, g, n, False, gen)
        pw = pack_block(make_dense(o, k, n, m, gen), SparsityConfig(n, m))
        qw = quantize_packed(pw)
        kernels = {
            "demm_xwT": ((vals, idx), lambda x, c, v, i: fns["demm_xwT"][0](
                x, v, i, c, duplicates=False), 8),
            "demm_xwT_q8": ((q, idx, scales), lambda x, c, v, i, s:
                            fns["demm_xwT_q8"][0](x, v, i, s, c,
                                                  duplicates=False), 5),
            "demm_block_spmm": (
                (pw.values, pw.indices, pw.active_groups),
                lambda x, c, v, i, a: fns["demm_block_spmm"][0](
                    a, v, i, x.T, c, r=o, duplicates=False), 8),
            "demm_block_spmm_q8": (
                (qw.values, qw.indices, qw.active_groups, qw.scales),
                lambda x, c, v, i, a, s: fns["demm_block_spmm_q8"][0](
                    a, v, i, s, x.T, c, r=o, duplicates=False), 5)}
        for bx in (4, 32):
            x = torch.randn((bx, k), generator=gen,
                            device=gen.device).to(torch.bfloat16)
            for name, (tensors, call, pair_bytes) in kernels.items():
                nbytes = sum(t.numel() * t.element_size() for t in tensors)
                copies = ring(tensors, nbytes)
                extra = nbytes - sum(t.numel() * t.element_size()
                                     for t in tensors[:2])
                for t in tiers:
                    cfg = SparsityConfig(t, m)
                    calls = [lambda c=c: call(x, cfg, c[0][..., :t],
                                              c[1][..., :t], *c[2:])
                             for c in copies]
                    ms, _ = time_ring(calls)
                    need = (tensors[0].numel() // n * t * pair_bytes + extra
                            + x.numel() * 2 + bx * o * 4)
                    rows.append({"kernel": name, "shape": label, "Bx": bx,
                                 "t": t, "ms": ms,
                                 "bound_ms": 1e3 * need / HBM_BYTES_PER_S})
        del vals, idx, q, scales, pw, qw
        torch.cuda.empty_cache()
    per_layer = {}
    for r in rows:
        key = (r["kernel"], r["Bx"], r["t"])
        acc = per_layer.setdefault(key, {"ms": 0.0, "bound_ms": 0.0})
        acc["ms"] += LAYER_MIX[r["shape"]] * r["ms"]
        acc["bound_ms"] += LAYER_MIX[r["shape"]] * r["bound_ms"]
    return rows, per_layer


def launch_floor():
    """An empty kernel launched at K1's and K3's bulk grid (about one CTA
    per SM, as ``csrc/demm_xwt_bulk.cuh`` sizes it), at their wide grid at
    Bx = 32 (``demm_xwT.wide_plan``) and at K2's cluster grid
    (a cluster of ``cl_auto_csize`` CTAs per row block), each with the
    dynamic shared memory the kernel asks for at Bx = 4 bf16, timed by the
    same graph replay as the kernels: what a launch of that shape costs
    before any work.  ms per shape and per layer."""
    import torch
    from repro_torch.kernels._build import load_library
    from repro_torch.kernels.demm_xwT import raise_on_launch_error

    lib = load_library()
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def empty(blocks, threads, csize, smem):
        def call():
            raise_on_launch_error(lib.demm_empty_launch(
                blocks, threads, csize, smem, torch.cuda.current_device(),
                torch.cuda.current_stream().cuda_stream), "demm_empty")
        return call

    from repro_torch.kernels.demm_xwT import wide_plan
    out = {"demm_xwT": {}, "demm_xwT_q8": {}, "demm_block_spmm": {},
           "demm_xwT_wide_bx32": {}}
    for label, o, k, n, m in MAIN_SHAPES:
        g, bx, block_r = k // m, 4, 128
        rows = -(-o // sms)
        x1 = bx * k * 2                                  # bf16 x, transposed
        smem1 = min(BULK_SMEM_BYTES, 128 + x1 + rows * g * n * 8)  # fp32 + int32
        smem3 = min(BULK_SMEM_BYTES, 128 + x1 + rows * g * n * 5)  # int8, int32
        rb = o // block_r
        csize = 2
        while csize < 8 and rb * csize < sms:
            csize *= 2
        per = -(-g // csize)
        smem2 = (16 + ((256 // block_r + 1) * block_r * bx + 8) * 4
                 + per * (block_r * n * 8 + bx * m * 2))
        grids = {"demm_xwT": (-(-o // rows), 512, 1, smem1),
                 "demm_xwT_q8": (-(-o // rows), 512, 1, smem3),
                 "demm_block_spmm": (rb * csize, 256, csize, smem2)}
        plan = wide_plan(32, o, g, m, n, sms=sms)       # the prefill chunk's
        grids["demm_xwT_wide_bx32"] = (
            -(-o // plan["rows"]) * plan["split"] * plan["xsplit"], 512,
            plan["split"], plan["smem"])
        for name, (blocks, threads, cs, smem) in grids.items():
            ms = time_ring([empty(blocks, threads, cs, smem)] * 64)[0]
            out[name][label] = {"blocks": blocks, "threads": threads,
                                "cluster": cs, "smem": smem, "ms": ms}
    for name, per_shape in out.items():
        per_shape["per_layer_ms"] = sum(LAYER_MIX[lb] * e["ms"]
                                        for lb, e in per_shape.items())
    return out


def layer_entry(name, source, replaces, per_shape, launches, max_abs_err, *,
                work, source_wide=None):
    """One line of the ``kernels`` report: the seven launches of one decoder
    layer (4 + 2 + 1 over the three shapes) at Bx (Cd) = 4 summed, every
    per-shape row beside; for K5 also the layer at Cd = 256 (``*_wide``,
    run by the body in ``source_wide``), for K3 also the layer with
    per-group scales (``*_per_group``; the main figures are per-row, as
    served)."""
    def total(key, cd=4, scales="per_row"):
        return sum(LAYER_MIX[e["shape"]] * e[key] for e in per_shape
                   if e["Bx"] == cd and e.get("scales", "per_row") == scales)
    bound_by = {e["bound_by"] for e in per_shape if e["Bx"] == 4}
    entry = {
        "name": name, "route": "cuda", "source": source, "replaces": replaces,
        "launches": launches, "max_abs_err": max_abs_err, "work": work,
        "ms": total("ms"), "eager_ms": total("eager_ms"),
        "plain_ms": total("plain_ms"),
        "bound_ms": total("bound_ms"),
        "bound_by": bound_by.pop() if len(bound_by) == 1 else "bytes",
        "library_ms": total("library_ms"),
    }
    if any(e.get("scales") == "per_group" for e in per_shape):
        entry.update({f"{key}_per_group": total(key, scales="per_group")
                      for key in ("ms", "plain_ms", "bound_ms", "library_ms")})
    if any(e["Bx"] == 256 for e in per_shape):
        entry["source_wide"] = source_wide
        entry.update({f"{key}_wide": total(key, 256) for key in (
            "ms", "plain_ms", "bound_ms", "library_ms")})
    entry["shapes"] = per_shape
    return entry


# ---------------------------------------------------------------------------

COMPARED = ("demm_xwT", "demm_xwT_q8", "demm_xwT_q8/per_group",
            "demm_block_spmm", "demm_block_spmm_q8", "demm_spmm@4",
            "demm_spmm@256")


def kernel_times(label, o, k, n, m, gen):
    """Device time of each kernel at one projection shape as the main path
    launches it (K1-K4 at Bx = 4, bf16 x; K5 with B (K, 4) and (K, 256)
    bf16), defaults and ``duplicates=False`` only, so that an older
    checkout's wrappers take the same calls."""
    import torch
    from repro_torch.core.sparsity import SparsityConfig, pack_block, unpack
    from repro_torch.kernels.demm_block_spmm import demm_block_spmm
    from repro_torch.kernels.demm_q8 import demm_block_spmm_q8
    from repro_torch.kernels.demm_spmm import demm_spmm
    from repro_torch.quant import quantize_packed

    cfg = SparsityConfig(n, m)
    x, vals, idx, q, scales, meta = shape_inputs(label, o, k, n, m, gen)
    out = {name + ("/per_group" if row.get("scales") == "per_group" else ""):
           row["ms"]
           for name, rows in time_xwt(x, vals, idx, q, scales, cfg,
                                      meta).items() for row in rows}
    pw = pack_block(unpack(vals, idx, cfg, (o, k)), cfg)
    qw = quantize_packed(pw)
    xt = x.T
    r = ring((pw.active_groups, pw.values, pw.indices),
             pw.values.nbytes + pw.indices.nbytes)
    out["demm_block_spmm"] = time_ring(
        [lambda a=a, v=v, i=i: demm_block_spmm(a, v, i, xt, cfg, r=o,
                                               duplicates=False)
         for a, v, i in r])[0]
    r = ring((qw.active_groups, qw.values, qw.indices, qw.scales),
             qw.values.nbytes + qw.indices.nbytes + qw.scales.nbytes)
    out["demm_block_spmm_q8"] = time_ring(
        [lambda a=a, v=v, i=i, sc=sc: demm_block_spmm_q8(
            a, v, i, sc, xt, cfg, r=o, duplicates=False)
         for a, v, i, sc in r])[0]
    r = ring((vals, idx), vals.nbytes + idx.nbytes)
    for cd in (4, 256):
        b = torch.randn((k, cd), generator=gen,
                        device=gen.device).to(torch.bfloat16)
        out[f"demm_spmm@{cd}"] = time_ring(
            [lambda v=v, i=i, b=b: demm_spmm(v, i, b, cfg, duplicates=False)
             for v, i in r])[0]
    del r, pw, qw
    torch.cuda.empty_cache()
    return out


def times_of(src: str) -> dict:
    """``--times-of SRC`` (one process per checkout): K1-K5 per layer,
    built and imported from the checkout whose ``src/`` is SRC."""
    sys.path.insert(0, os.path.abspath(src))
    sys.path.remove(os.path.join(HERE, "src"))
    import torch
    import repro_torch

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)
    per = {name: 0.0 for name in COMPARED}
    for label, o, k, n, m in MAIN_SHAPES:
        for name, ms in kernel_times(label, o, k, n, m, gen).items():
            per[name] += LAYER_MIX[label] * ms
    return {"package": repro_torch.__file__, **per}


def compare_with(other: str):
    """``--compare-with DIR``: K1-K5 per layer of the checkout at DIR and of
    this one, each in its own process (its own build), in the turns DIR,
    this, this, DIR; prints one JSON line and the ratios."""
    runs = []
    for root in (other, HERE, HERE, other):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--times-of",
             os.path.join(root, "src")],
            capture_output=True, text=True, timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"--times-of {root} failed:\n"
                               f"{proc.stderr[-3000:]}")
        runs.append({"root": root,
                     **json.loads(proc.stdout.strip().splitlines()[-1])})
    log(f"[compare] ms per layer, in turns: {json.dumps(runs)}")
    summary = {}
    for name in COMPARED:
        parent = [runs[0][name], runs[3][name]]
        this = [runs[1][name], runs[2][name]]
        summary[name] = {
            "parent_ms": parent, "this_ms": this,
            "speedup": statistics.mean(parent) / statistics.mean(this),
            "parent_spread": abs(parent[0] - parent[1]) / min(parent),
            "this_vs_parent": (statistics.mean(this) - statistics.mean(parent))
            / statistics.mean(parent)}
    log(f"[compare] summary: {json.dumps(summary)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also time the tunables: K1's and K3's bulk body "
                         "(rows per CTA, chunks; K3's slot lanes per row) "
                         "against their gather body, K3's gather body at "
                         "rows_per_block in {8, 16, 24, 32, 48, 64}, K2's "
                         "and K4's cluster sizes against their gather body, "
                         "K5's rows_per_block in {8, 16, 32, 64} at Cd = 4, "
                         "its tile and stages at Cd = 256, and both K5 "
                         "bodies at Cd 16-256; phase 9 measures up to 16 "
                         "candidates a problem")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a steady window of decode ticks of "
                         "the four serving modes (both layouts, float and "
                         "int8) with torch.profiler, the captured step and "
                         "the eager step in turns")
    ap.add_argument("--stop-after", type=int, default=None, metavar="PHASE",
                    help="development aid: stop after this phase (3: build "
                         "and check the kernels only); prints no result line")
    ap.add_argument("--compare-with", default=None, metavar="DIR",
                    help="development aid: time K1-K5 of the checkout at DIR "
                         "against this one's, in turns, and stop; prints no "
                         "result line")
    ap.add_argument("--wide-pieces", action="store_true",
                    help="development aid: after phase 3, time K1 / K3's "
                         "prefill bodies (7p, 7b) and the wide body built "
                         "without its products and without reading its "
                         "pairs, each build in its own process, and stop; "
                         "prints no result line")
    ap.add_argument("--times-of", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--piece-times", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    t_start = time.time()
    if args.times_of:
        print(json.dumps(times_of(args.times_of)), flush=True)
        return 0
    if args.piece_times:
        print(json.dumps(wide_piece_times()), flush=True)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 2

    from repro_torch.configs.base import get_arch
    from repro_torch.device import nvidia_smi_line
    from repro_torch.kernels import _build
    from repro_torch.launch.pack_tree import pack_tree
    from repro_torch.models.families import build_model

    # 1. device
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1 device] {kind} x{torch.cuda.device_count()}; nvidia-smi "
        f"name, power.limit: {smi}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(0)

    # 2. build
    t0 = time.time()
    _build.load_library()
    built = _build.build_seconds
    log(f"[2 build] kernel library ready in {time.time() - t0:.1f} s "
        + (f"(nvcc: {built:.1f} s)" if built is not None else "(reused)"))

    # 3. kernels vs plain versions
    t0 = time.time()
    errs, n_cases = check_kernels(gen)
    log(f"[3 kernels] {n_cases} comparisons against the plain versions held "
        f"(f32 {TOL['float32']}, bf16 {TOL['bfloat16']}); max abs err at the "
        f"main-path shapes: {errs}; {time.time() - t0:.1f} s")

    if args.compare_with:
        compare_with(args.compare_with)
        log(f"stopped after the comparison as asked "
            f"({time.time() - t_start:.1f} s)")
        return 0

    if args.stop_after is not None and args.stop_after <= 3:
        log(f"stopped after phase 3 as asked ({time.time() - t_start:.1f} s)")
        return 0

    if args.wide_pieces:
        t0 = time.time()
        for shape in MAIN_SHAPES:
            for name, entries in time_prefill_bodies(*shape, gen).items():
                for entry in entries:
                    log(f"[7p prefill Bx=32] {name} {json.dumps(entry)}")
        for name, e in time_wide_big(gen).items():
            log(f"[7b wide Bx=2048] {name} {json.dumps(e)}")
        log(f"[7p/7b] {time.time() - t0:.1f} s")
        t0 = time.time()
        for name, rows in wide_pieces().items():
            log(f"[wide pieces] {name}: {json.dumps(rows)}")
        log(f"[wide pieces] {time.time() - t0:.1f} s; {smi}; stopped as "
            f"asked ({time.time() - t_start:.1f} s)")
        return 0


    # 9. (run inside 4-8's loop) a tuning cache of this run's own
    import shutil
    import tempfile
    from repro_torch import tune
    tune_dir = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    tune.set_default_cache(tune.TuneCache(os.path.join(tune_dir,
                                                       "tune_cache.json")))
    tune_kw = TUNE_SWEEP_KW if args.sweep else TUNE_KW

    # 4./5. serve at full width, xwT layout; 4b/5b block layout on a fresh
    # model of the same seed (packing is in place)
    cfg = get_arch("stablelm_3b")
    serve, graph, profiles, paged, tuned = {}, {}, [], {}, {}
    t_tune = 0.0
    for layout in ("xwT", "block"):
        t0 = time.time()
        torch.cuda.reset_peak_memory_stats()
        model = build_model(cfg, device=DEVICE, seed=0)
        cfg9 = dataclasses.replace(cfg, num_layers=TUNE_LAYERS)
        model9 = build_model(cfg9, device=DEVICE, seed=0)
        torch.cuda.synchronize()
        log(f"[4 serve] built {cfg.name} ({cfg.num_layers} layers, d_model "
            f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.padded_vocab}) in "
            f"{time.time() - t0:.1f} s; "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak")
        float_kernel, q8_kernel = (("demm_xwT", "demm_xwT_q8")
                                   if layout == "xwT" else
                                   ("demm_block_spmm", "demm_block_spmm_q8"))
        for kernel, quantize in ((float_kernel, None), (q8_kernel, "int8")):
            mode = f"--layout {layout}" + (f" --quantize {quantize}"
                                           if quantize else "")
            t0 = time.time()
            # the model is packed (then quantized) in place
            kept = []
            serve[kernel] = serve_full_width(
                model, cfg, layout=layout, quantize=quantize, expect=kernel,
                keep=kept if kernel == "demm_xwT" else None)
            phase = "[5 serve q8]" if quantize else "[4 serve]"
            log(f"{phase} packed {mode}, backend cuda ({time.time() - t0:.1f}"
                f" s with packing): {json.dumps(serve[kernel])}")
            if kept:
                # 18a. the census against phase 4's engine
                census18 = census_vs_engine(kept.pop(), cfg)

            graph[mode] = graph_vs_eager(model, cfg, mode)[0]
            log(f"[{phase[1]}g graph] {json.dumps(graph[mode])}")
            t0 = time.time()
            paged[mode] = paged_full_width(model, cfg, mode, kernel)
            log(f"[8 paged] {mode} ({time.time() - t0:.1f} s): "
                f"{json.dumps(paged[mode])}")
            t0 = time.time()
            # phase 9's model, packed (then quantized) in place as phase 4's
            pack_tree(model9, layout=layout, quantize=quantize)
            tuned[mode] = tune_full_width(model9, cfg9, mode, kernel,
                                          layout=layout, quantize=quantize,
                                          kw=tune_kw)
            t_tune += time.time() - t0
            log(f"[9 tune] {mode} ({time.time() - t0:.1f} s): "
                f"{json.dumps(tuned[mode])}")
            if args.profile:             # graph and eager, paired
                for eager in (False, True, True, False):
                    profiles.append(profile_ticks(model, cfg, mode,
                                                  eager=eager))
        del model, model9
        torch.cuda.empty_cache()
    spmm = spmm_path(gen)
    log(f"[5c spmm] ops.demm_spmm, backend cuda: {json.dumps(spmm)}")

    # 6. backends agree end to end
    agree = check_backends_agree(get_arch("stablelm_3b"))
    log(f"[6 agree] cuda vs reference, 2 layers float32: {json.dumps(agree)}")
    t0 = time.time()
    graph["2 layers float32"] = check_graph_modes(get_arch("stablelm_3b"))
    tuned["2 layers float32"] = {mode: r["auto"] for mode, r
                                 in graph["2 layers float32"].items()}
    log(f"[6g graph] graph vs eager vs reference, and [9 tune] auto with "
        f"autotune vs cuda vs reference, 2 layers float32, four modes "
        f"({time.time() - t0:.1f} s): "
        f"{json.dumps(graph['2 layers float32'])}")
    t0 = time.time()
    tuned["spmm"] = tune_spmm(gen, tune_kw)
    t_tune += time.time() - t0
    log(f"[9 tune] autotune_spmm at Cd 4 and 256 ({time.time() - t0:.1f} "
        f"s): {json.dumps(tuned['spmm'])}")
    log("[9 tune] mode | problem | body | default us | tuned us | tuned "
        "params | default / tuned")
    for mode, r in tuned.items():
        for row in (r.get("bx4", []) + r.get("bx32", [])
                    if mode.startswith("--") else r if mode == "spmm"
                    else []):
            log(f"[9 tune] {mode} | {row['key']} | {row['body']} | "
                f"{row['default_us']:.2f} | {row['tuned_us']:.2f} | "
                f"{json.dumps(row['tuned_params'])} | "
                f"{row['default_over_tuned']:.3f}")
        if "chunk_device_ms" in r:
            log(f"[9 tune] {mode} | prefill chunk device ms, default params "
                f"{r['chunk_device_ms']['default']}, tuned "
                f"{r['chunk_device_ms']['tuned']}; last-chunk logits tuned "
                f"vs default {r['chunk_logits_tuned_vs_default']}; selected "
                f"params vs plain, max abs err "
                f"{max(r['bx4_vs_plain'].values()):.3g} (Bx = 4), "
                f"{max(r['bx32_vs_plain'].values()):.3g} (Bx = 32)")
    log(f"[9 tune] {t_tune:.1f} s in all")
    tune.set_default_cache(None)
    shutil.rmtree(tune_dir, ignore_errors=True)
    t0 = time.time()
    paged_gate = paged_gates(get_arch("stablelm_3b"))
    log(f"[8g paged] paged vs dense vs reference, preemption, 2 layers "
        f"float32, four modes ({time.time() - t0:.1f} s): "
        f"{json.dumps(paged_gate)}")
    log("[8 paged] mode | TTFT ms median (dense) | prompt tok/s (dense) | "
        "chunk ms host / device | decode tick ms host / device | busy | "
        "page gather ms/tick")
    for mode, r in paged.items():
        sp, dn = r["second_pass"], r["dense_token_by_token"]
        log(f"[8 paged] {mode} | {statistics.median(sp['ttft_ms']):.1f} "
            f"({statistics.median(dn['ttft_ms']):.1f}) | "
            f"{sp['prompt_tokens_per_s']:.0f} "
            f"({dn['prompt_tokens_per_s']:.0f}) | "
            f"{r['prefill_chunk']['ms_host_clock']:.3f} / "
            f"{r['prefill_chunk']['device_ms']:.3f} | "
            f"{r['decode_tick']['ms_host_clock']:.3f} / "
            f"{r['decode_tick']['device_ms']:.3f} | "
            f"{100 * r['decode_tick']['busy_share']:.1f} % | "
            f"{r['page_gather']['ms_per_tick']:.3f}")
    # 10. self-speculative decoding: full width at 8:16, draft 6:16, the
    # four modes on both engines; 10g at 2 layers float32; 10c the CLI
    spec = {}
    t10 = time.time()
    for layout in ("xwT", "block"):
        t0 = time.time()
        cfg10, model = spec_model(cfg, layout, num_layers=SPEC_LAYERS)
        log(f"[10 spec] built and packed {cfg10.name} at {SPEC_SPARSITY} "
            f"--layout {layout} ({time.time() - t0:.1f} s; "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB peak)")
        float_kernel, q8_kernel = (("demm_xwT", "demm_xwT_q8")
                                   if layout == "xwT" else
                                   ("demm_block_spmm", "demm_block_spmm_q8"))
        for kernel, quantize in ((float_kernel, None), (q8_kernel, "int8")):
            mode = f"--layout {layout}" + (f" --quantize {quantize}"
                                           if quantize else "")
            if quantize:
                pack_tree(model, quantize=quantize)   # in place
            t0 = time.time()
            spec[mode] = spec_full_width(cfg10, model, mode, kernel)
            log(f"[10 spec] {mode} ({time.time() - t0:.1f} s): "
                f"{json.dumps(spec[mode])}")
        del model
        torch.cuda.empty_cache()
    t0 = time.time()
    spec["2 layers float32"] = spec_gates(cfg)
    log(f"[10g spec] cuda vs reference vs plain, 2 layers float32, four "
        f"modes, both engines ({time.time() - t0:.1f} s): "
        f"{json.dumps(spec['2 layers float32'])}")
    t0 = time.time()
    spec["cli"] = {"dense": spec_cli(cfg, False), "paged": spec_cli(cfg, True)}
    log(f"[10c spec cli] launch.serve --full --packed --sparsity "
        f"{SPEC_SPARSITY} --spec-draft {SPEC_DRAFT} --spec-gamma "
        f"{SPEC_GAMMA} [--paged] ({time.time() - t0:.1f} s): "
        f"{json.dumps(spec['cli'])}")
    log(f"[10 spec] {time.time() - t10:.1f} s in all; {smi}")
    log("[10 spec] mode | acceptance | tokens per verify | device ms: full "
        "step, draft, verify W | tokens/s spec / plain (paged engine, "
        f"max_len {PAGED['max_len']}, phase 8's prompts, {PAGED_NEW} new)")
    for mode, r in spec.items():
        if not mode.startswith("--"):
            continue
        e = r["timed"]
        ms = e["device_ms"]
        log(f"[10 spec] {mode} | {e['acceptance_rate']:.4f} | "
            f"{e['tokens_per_verify']:.4f} | {ms['full_step']:.4f}, "
            f"{ms['draft']:.4f}, "
            + ", ".join(f"{k[-2:]} {v:.4f}" for k, v in ms.items()
                        if k.startswith("verify"))
            + f" | {e['tokens_per_s']['spec']:.2f} / "
            f"{e['tokens_per_s']['plain']:.2f}")

    # 11. the windowed decoders: gemma3_1b and h2o_danube_1_8b
    t0 = time.time()
    windowed = windowed_phase()
    log(f"[11 windowed] {time.time() - t0:.1f} s in all; {smi}")
    log("[11 windowed] mode | ticks | step device ms | tokens/s | launches "
        "per replay by body | eager step split ms | prefill gap")
    for mode, e in windowed["modes"].items():
        log(f"[11 windowed] gemma3_1b {mode} | {e['ticks']} | "
            f"{e['step_device_ms']:.4f} | {e['tokens_per_s']:.2f} | "
            f"{json.dumps(e['device_launches_per_replay'])} | "
            f"{json.dumps(e['eager_step_split_ms'])} | "
            f"{e['prefill_rel_l2_gap']:.3g}")

    # 12. training: the packed ops under autograd, full-width
    # launch.train and its checkpoint served packed, the reduced sparsify +
    # QAT run restarted
    train = train_phase(gen)
    fw = train["full_width"]
    log(f"[12 train] {train['seconds']:.1f} s in all; full width: losses "
        f"{fw['losses']}, step s after the first "
        f"{fw['step_seconds_after_first']}, peak {fw['peak_device_gb']:.2f} "
        f"GB, checkpoint {fw['ckpt_gb']:.2f} GB in "
        f"{fw['ckpt_save_seconds']:.1f} s; {smi}")

    # 13. the other model families: MoE, vision, encoder-decoder, Mamba2
    # hybrid, xLSTM, served and trained through K1-K4
    families = family_phase()
    log(f"[13 families] {families['seconds']:.1f} s in all; {smi}")
    log("[13 families] arch | layers | step device ms | tokens/s | K1 "
        "launches a step | graph = eager | prefill gap | train losses")
    for arch, r in families["serve"].items():
        gap = families["prefill"].get(arch, {}).get("rel_l2_gap")
        tr = families["train"][arch]
        log(f"[13 families] {arch} | {r['layers']} | "
            f"{r['step_device_ms']:.4f} | {r['tokens_per_s']:.2f} | "
            f"{r['launches_per_step']} | "
            f"{r['graph_vs_eager']['logits_bit_equal']} | "
            + (f"{gap:.3g}" if gap is not None else "-")
            + f" | {'full' if tr['full_width'] else 'reduced'} "
            + ", ".join(f"{v:.4f}" for v in tr["losses"]))

    # 14. distribution: the sharded matmul (14a), replicas (14d), TP = 2
    # (14b) and PP = 2 (14c) worlds of two ranks on the card
    dist = dist_phase(gen, {
        "tp2 --layout xwT": serve["demm_xwT"]["outputs"],
        "tp2 --layout block": serve["demm_block_spmm"]["outputs"]})
    log_dist(dist, smi)

    # 15. distributed training: one world of four ranks, tp 2 x dp 2
    dist_train = dist_train_phase()
    log_dist_train(dist_train, smi)

    # 16. every family under tp 2: two-rank worlds at full width (16b), and
    # the rank-local shapes against their plain versions, timed (16a)
    dist_families = dist_families_phase(gen)
    log_dist_families(dist_families, smi)

    # 17. the paper's workloads: ResNet50 / ConvNeXt-T im2col GEMMs at the
    # Fig. 6 / Fig. 8 patterns through K5 against the engine model (17a),
    # timed (17b); the packed-API leftovers on the card (17c)
    paper, modelled = paper_phase(gen)
    log_paper(paper, modelled, smi)

    # 18. the dry-run census: 18a ran beside phase 4; 18b's row
    row, row_s = census_row()
    census18["row_seconds"] = row_s
    log_census(census18, row, row_s, smi)

    if profiles:
        log("[profile] mode | step | tick ms (host) | device ms/tick | busy "
            "| launches/tick | tokens/s")
        for r in profiles:
            log(f"[profile] {r['mode']} | {r['step']} | "
                f"{r['tick_ms_unprofiled']:.3f} | "
                f"{r['device_ms_per_tick']:.3f} | "
                f"{100 * r['device_busy_share_unprofiled']:.1f} % | "
                f"{r['device_launches_per_tick']:.0f} | "
                f"{r['tokens_per_s_unprofiled']:.1f}")

    # 6f. the serve program with its observability flags, a forced stall
    t0 = time.time()
    flight = flight_run(cfg)
    log(f"[6f flight] launch.serve --full --profile-dir --flight-dir "
        f"--force-stall ({time.time() - t0:.1f} s): {json.dumps(flight)}")
    t0 = time.time()
    cli = paged_cli(cfg)
    log(f"[6p paged cli] launch.serve --full --packed --paged "
        f"--trace-replay ({time.time() - t0:.1f} s): {json.dumps(cli)}")

    # 7. times
    sweep = (8, 16, 24, 32, 48, 64) if args.sweep else ()
    block_sweep = (8, 16, 32, 64) if args.sweep else ()
    per_kernel = {name: [] for name in KERNELS}
    for shape in MAIN_SHAPES:
        timed = time_shape(*shape, gen, sweep=sweep, block_sweep=block_sweep)
        for name, entries in timed.items():
            for entry in entries:
                per_kernel[name].append(entry)
                log(f"[7 times] {name} {json.dumps(entry)}")
    prefill32 = {name: [] for name in KERNELS[:4]}
    for shape in MAIN_SHAPES:
        for name, entries in time_prefill_bodies(*shape, gen).items():
            for entry in entries:
                prefill32[name].append(entry)
                log(f"[7p prefill Bx=32] {name} {json.dumps(entry)}")
    log("[7p prefill Bx=32] kernel | scales | body | ms per layer | gather "
        "body ms | bound ms | library ms")
    for name in KERNELS[:4]:
        for unit in ("per_row", "per_group"):
            rows = [e for e in prefill32[name]
                    if e.get("scales", "per_row") == unit]
            if name != "demm_xwT_q8" and unit == "per_group":
                continue
            per = {key: sum(LAYER_MIX[e["shape"]] * e[key] for e in rows)
                   for key in ("ms", "bound_ms", "library_ms")}
            gath = (sum(LAYER_MIX[e["shape"]] * e["gather_body_ms"]["default"]
                        for e in rows) if rows[0].get("gather_body_ms")
                    else per["ms"])
            log(f"[7p prefill Bx=32] {name} | {unit} | {rows[0]['body']} | "
                f"{per['ms']:.4f} | {gath:.4f} | {per['bound_ms']:.4f} | "
                f"{per['library_ms']:.4f}")
    t0 = time.time()
    big = time_wide_big(gen)
    for name, e in big.items():
        log(f"[7b wide Bx=2048] {name} {WIDE_BIG[0]}: wide {e['ms']:.4f} ms, "
            f"gather {e['gather_ms']:.4f}, bound {e['bound_ms']:.4f} "
            f"({e['bound_by']}), library {e['library_ms']:.4f}, plain "
            f"{e['plain_ms']:.3f}; {time.time() - t0:.1f} s; {smi}")
    t0 = time.time()
    tier_rows, tier_layer = tier_times(gen)
    for r in tier_rows:
        log(f"[7s tier times] {json.dumps(r)}")
    log("[7s tier times] kernel | Bx | ms per layer at t = 8 (full), 6, 4 "
        "of 8:16 | bound ms at t = 8, 6, 4 | t=6 / t=8")
    for name in KERNELS[:4]:
        for bx in (4, 32):
            row = [tier_layer[(name, bx, t)] for t in (8, 6, 4)]
            log(f"[7s tier times] {name} | {bx} | "
                + ", ".join(f"{r['ms']:.4f}" for r in row) + " | "
                + ", ".join(f"{r['bound_ms']:.4f}" for r in row)
                + f" | {row[1]['ms'] / row[0]['ms']:.3f}")
    log(f"[7s tier times] {time.time() - t0:.1f} s; {smi}")
    csrc = "src/repro_torch/kernels/csrc/"
    layer = ("the 7 packed projections of one stablelm_3b decoder layer "
             "(4 x 2560x2560 5:80, 2 x 6912x2560 5:80, 1 x 2560x6912 3:48), "
             "{}, weights read from device memory")
    serving = layer.format("Bx=4, bfloat16 activations")
    launches = {name: run["launches"] for name, run in serve.items()}
    launches["demm_spmm"] = spmm["launches"]
    sources = {
        "demm_xwT": (csrc + "demm_xwt.cu",
                     "src/repro/kernels/demm_spmm.py:180", serving),
        "demm_xwT_q8": (csrc + "demm_xwt_bulk.cuh",
                        "src/repro/kernels/demm_q8.py:79",
                        serving + ", int8 values with per-row scales, the "
                        "bulk row-tile body launched by demm_xwt_q8.cu; "
                        "*_per_group: scales (O, G)"),
        "demm_block_spmm": (csrc + "demm_block_spmm.cu",
                            "src/repro/kernels/demm_block_spmm.py:85",
                            serving + ", block layout"),
        "demm_block_spmm_q8": (csrc + "demm_block_spmm_q8.cu",
                               "src/repro/kernels/demm_q8.py:162",
                               serving + ", block layout"),
        "demm_spmm": (csrc + "demm_block_spmm.cu",
                      "src/repro/kernels/demm_spmm.py:111",
                      layer.format("C = A @ B with B (K, 4) bfloat16, the "
                                   "gather body of demm_block_spmm.cu; "
                                   "*_wide: B (K, 256), the tiled body of "
                                   "source_wide")),
    }
    kernels = [layer_entry(name, src, replaces, per_kernel[name],
                           launches[name], errs[name], work=work,
                           source_wide=csrc + "demm_spmm_tc.cu")
               for name, (src, replaces, work) in sources.items()]
    for entry in kernels:
        rows = prefill32.get(entry["name"])
        if rows is None:
            continue
        # the paged engine: wrapper launches over its counted pass, and the
        # gather body at Bx = 32, as a prefill chunk launches it, per layer
        entry["launches_paged"] = sum(r["launches"] for r in paged.values()
                                      if r["kernel"] == entry["name"])
        # the speculative engines' counted passes (draft, verify widths,
        # plain step and, paged, the prefill chunk), dense + paged
        entry["launches_spec"] = sum(
            r[e]["launches"] for r in spec.values()
            if r.get("kernel") == entry["name"] for e in ("dense", "paged"))
        # a draft tier's launches against the full tier's, per layer, the
        # weights stored at 8:16 (phase 7s)
        entry["tier_8_16"] = {
            f"Bx{bx}": {f"t{t}": tier_layer[(entry["name"], bx, t)]
                        for t in (8, 6, 4)} for bx in (4, 32)}
        # phase 11's counted serving passes: gemma3_1b in the four modes,
        # h2o_danube_1_8b in xwT float
        entry["launches_windowed"] = sum(
            r["launches"] for r in windowed["modes"].values()
            if r["kernel"] == entry["name"]) + (
            windowed["h2o_danube_1_8b"]["launches"]
            if entry["name"] == "demm_xwT" else 0)
        # the prefill chunk's body at Bx = 32, per layer (K3: per-row
        # scales as served; per_group beside it), and K1 / K3's gather body
        # at the same shapes
        served = [e for e in rows if e.get("scales", "per_row") == "per_row"]
        entry["prefill_bx32"] = {
            "body": PREFILL_BODY[entry["name"]],
            **{key: sum(LAYER_MIX[e["shape"]] * e[key] for e in served)
               for key in ("ms", "plain_ms", "bound_ms", "library_ms")},
            "shapes": rows}
        if served[0].get("gather_body_ms"):
            entry["prefill_bx32"]["gather_ms"] = sum(
                LAYER_MIX[e["shape"]] * e["gather_body_ms"]["default"]
                for e in served)
        per_group = [e for e in rows if e.get("scales") == "per_group"]
        if per_group:
            entry["prefill_bx32"]["per_group"] = {
                key: sum(LAYER_MIX[e["shape"]] * e[key] for e in per_group)
                for key in ("ms", "bound_ms", "library_ms")}
            entry["prefill_bx32"]["per_group"]["gather_ms"] = sum(
                LAYER_MIX[e["shape"]] * e["gather_body_ms"]["default"]
                for e in per_group)
        if entry["name"] in big:
            entry["wide_bx2048"] = big[entry["name"]]
    # phase 12's launches: the forwards under autograd (12a, the remat
    # check's K1 launches included) and the trained checkpoints served
    # (12b: K1, 12c: K3 and K4)
    for entry in kernels:
        name = entry["name"]
        entry["launches_train"] = (
            train["grads"]["launches"][name]
            + (sum(train["remat"]["launches"].values())
               if name == "demm_xwT" else 0)
            + (train["full_width"]["launches_serve"]
               if name == "demm_xwT" else 0)
            + train["sparse_restart"]["launches"].get(name, 0))
    # the windowed decoders' projections (phase 7w), per layer of each
    rows_by_shape = {}
    for name in KERNELS[:4]:
        for e in per_kernel[name]:
            if e.get("scales", "per_row") == "per_row":
                key = (e["O"], e["K"], e["pattern"])
                rows_by_shape.setdefault(key, {}).setdefault(
                    name, []).append(e)
    for name, per in windowed_times(gen, rows_by_shape).items():
        entry = next(e for e in kernels if e["name"] == name)
        for arch, row in per.items():
            entry[arch.split("_")[0]] = row
            log(f"[7w times] {name} {arch} per layer: ms {row['ms']:.4f}, "
                f"bound {row['bound_ms']:.4f}, plain {row['plain_ms']:.3f}, "
                f"library {row['library_ms']:.4f}; "
                + "; ".join(f"{r['shape']} {r.get('body', '')} "
                            f"{r['ms']:.4f}" for r in row["shapes"]))
    # the families' shapes (phase 7f), and their launches in phase 13: the
    # full-width serving runs (13a, K1), the float32 gates in the four modes
    # (13b), the recurrent families' prefills (13d, K1's gather body) and
    # the trained xlstm checkpoint served (13e, K1)
    t0 = time.time()
    for name, per in family_times(gen).items():
        entry = next(e for e in kernels if e["name"] == name)
        entry["families"] = per
        for label, row in per.items():
            log(f"[7f times] {name} {label}: ms {row['ms']:.4f}, bound "
                f"{row['bound_ms']:.4f}, plain {row['plain_ms']:.3f}, "
                f"library {row['library_ms']:.4f}, body "
                f"{row.get('body', '')}")
    log(f"[7f times] {time.time() - t0:.1f} s; {smi}")
    for entry in kernels:
        k1 = entry["name"] == "demm_xwT"
        entry["launches_families"] = {
            "serve": ({arch: r["launches"]
                       for arch, r in families["serve"].items()}
                      if k1 else {}),
            "gates_float32": families["gate_launches"][entry["name"]],
            "prefill": (sum(r["launches"]
                            for r in families["prefill"].values())
                        if k1 else 0),
            "train_ckpt_serve": (families["train"]["serve_xlstm_ckpt"][
                "launches"] if k1 else 0)}
    # phase 14's launches: each rank's wrapper counts in 14b (TP = 2, the
    # float kernels of both layouts) and 14c (PP = 2, K1), and 14d's
    # replicas (K1); the shard-local launches of 14a timed at tp 2
    for entry in kernels:
        name = entry["name"]
        entry["launches_dist"] = {
            f"{label} rank{r['rank']}": r[label]["launches"][name]
            for r in dist["ranks"] for label, _, _, _ in dist_runs()
            if r[label]["launches"][name]}
        if name == "demm_xwT":
            entry["launches_dist"]["replicas"] = dist["replicas"][
                "launches"]
        entry["tp2_local"] = [e for e in dist["matmul"]["tp2_local"]
                              if e["kernel"] == name]
        # phase 15b: each rank's launches in the packed step's gradients
        # (forwards and remat's recomputes under autograd)
        entry["launches_dist_train"] = {
            f"rank{r['rank']}": r["b"]["launches"][name]
            for r in dist_train["ranks"]}
        # phase 16b: each rank's counts per family leg under tp 2; 16a's
        # rank-local shapes timed
        entry["launches_dist_families"] = {
            f"{leg[0]} rank{r['rank']}": r[leg[0]]["launches"][name]
            for r in dist_families["ranks"] for leg in DF_LEGS
            if r[leg[0]]["launches"][name]}
        entry["tp2_families"] = [e for e in dist_families["tp2_local"]
                                 if e["kernel"] == name]
        # phase 17: K5 on the paper's CNN GEMMs (17a's counted launches and
        # 17b's rows by network and pattern); K1-K3 on the leftovers (17c)
        entry["launches_leftovers"] = paper["leftovers"]["launches"].get(
            name, 0)
        if name == "demm_spmm":
            entry["launches_paper"] = paper["engine_vs_k5"]["launches"]
            entry["paper"] = {
                "work": "every sparse im2col GEMM of ResNet50 (Fig. 6: 95 % "
                        "unstructured, and Fig. 8) and ConvNeXt-T (Fig. 8: "
                        "1:8, 1:4, 1:2), A packed at 8k:128 with K padded "
                        "to 128, B (K_pad, P) bfloat16; per network and "
                        "pattern, each layer weighted by its count; "
                        "bound_ms and library_ms of the unpadded GEMM",
                "max_abs_err_vs_engine": paper["engine_vs_k5"][
                    "max_abs_err"],
                "bodies": paper["engine_vs_k5"]["bodies"],
                "rows": paper["times"]}
    # K5's tiled body does the dense count of operations: its floor, worked
    # from the shapes (not a measurement, so not in the kernels line)
    floor = {label: 1e3 * 2 * o * k * 256 / PEAK_OPS_PER_S["bfloat16"]
             for label, o, k, _, _ in MAIN_SHAPES}
    log(f"[7 times] launch floor, an empty kernel at each redesigned "
        f"kernel's grid and shared memory, graph replay, ms: "
        f"{json.dumps(launch_floor())}")
    log(f"[7 times] demm_spmm Cd=256 dense tile-product floor, 2 R K Cd at "
        f"the bf16 peak, computed from the shapes, ms: {json.dumps(floor)}; "
        f"per layer {sum(LAYER_MIX[s] * t for s, t in floor.items())}")
    log(f"[done] {time.time() - t_start:.1f} s in all")
    log(smi)
    log(json.dumps({"kernels": kernels, "serve": list(serve.values()),
                    "spmm": spmm, "agree": agree, "graph": graph,
                    "flight": flight, "paged": list(paged.values()),
                    "paged_gates": paged_gate, "paged_cli": cli,
                    "tune": tuned, "spec": spec, "windowed": windowed,
                    "train": train, "families": families,
                    "distribution": dist,
                    "distributed_training": dist_train,
                    "distribution_families": dist_families,
                    "paper": paper,
                    "census": {"vs_engine": census18, "row": row}}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
