"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py                  (every phase: under 900 s on a typical H100 host)
    python3 chip_smoke.py --phases 19,18   (the build and those phases only)

Needs one CUDA card, ``nvcc`` and the repository checkout (it imports
``kakveda_tpu_torch`` from beside this file, and nothing of JAX or of the
JAX package). Phases, each of which raises on failure (exit code != 0):

1. the card: its name and power limit (``nvidia-smi``), TF32 off;
2. build every kernel from ``kakveda_tpu_torch/csrc`` (one ``nvcc`` each,
   in parallel; the flash source as one library per head_dim);
3. each kernel against its plain PyTorch version at the main path's shape —
   ``fused_topk`` over a 1,048,576 × 2048 bf16 index (~90 % valid) for
   B ∈ {1, 64}, k ∈ {5, 8}, against ``fused_topk_reference`` and the
   kernel's own schedule in plain PyTorch (``fused_topk_schedule_reference``
   over one block per SM): scores within 1e-4, ids equal wherever the plain
   scores of neighbouring ranks differ by more than 1e-4, exact
   lowest-index ties on duplicated rows; warm times from CUDA events beside
   the bound, its share of HBM, the plain version and one PyTorch yardstick
   call (never used by the port), eager and replayed from a CUDA graph; the kernel's registers, spills (ptxas),
   shared memory and ring depth per wgmma width;
4. the failure-memory main path, with launch counts zeroed just before and
   read just after: ``Platform(capacity=2^20, dim=2048)`` on the card runs
   the demo flow (warn → ingest for app-A/app-B, repeats that degrade
   app-A, a follow-up warn), then ``ingest_batch`` of 4096 traces in batches
   of 512 and ``warn_batch`` of 64, whose matches are checked against the
   plain top-k of the same index. Mining on that ingest path: the cluster
   state covers every row, never went stale, one delta top-k per 512-batch;
   ``mine()`` serves incrementally, ``mine(mode="full")`` sweeps and
   re-seeds (this stream is past the k-neighbour cap, where the streamed
   partition is not the sweep's, in the JAX package too); a warned
   signature's ingest attaches with no dispatch; the delta's device time
   beside its bound. Then two more Platforms ingest one stream whose
   clusters no neighbour list overflows: incremental patterns and
   partition equal the full sweep's. Then ingest traces/s on fresh
   Platforms with mining off, on, on, off;
5. ``flash_gqa_cache`` (bf16 cache and int8 cache) against its plain
   versions, the split schedule's (``flash_gqa_cache_split_reference`` with
   the kernel's ``n_split``) and the unsplit one, at the model plane's
   shapes (H = 32, KV = 8, D = 128): decode (B = 8, S = 1, L = 512,
   per-slot ``kv_valid``, one slot that sees nothing and must give exact
   zeros), decode under the engine's own mask (``_forward_wide`` at phase
   6's last step: rows [left pad, 95] of every slot, a left pad of 10-16,
   ``pos0`` = 512, with the engine's ``reach`` hint of 96 and, timed beside
   it, without), admission (B = 1, S = 64, L = 512, 13 left-pad slots),
   a long cache (B = 8, S = 1, L = 8192), and phase 10's two shapes with
   S > 1 at pos0 > 0: a prefix-hit admission (B = 1, S = 512, L = 2048,
   pos0 = 512, rows [464, 1024) valid: a 560-token judge prompt reusing the
   69-token judge head) and chunked prefill (B = 64, S = 256, L = 1024,
   pos0 = 256 and 512, per-row left pads); then the shapes phase 10's own
   traffic gives, worked out from its judge prompts by the engine's and the
   solo path's arithmetic with the exact ``kv_valid`` of the run (arm A's
   heaviest whole admission, B = 1, S = 1024, pos0 = 0, L = 2048, and
   heaviest prefix hit; arm B's DecodeSession pieces, B = 64, S = 256,
   L = 2048, pos0 = 0, 256, 512, 768); every bf16 output row within two
   bf16 steps of its largest plain value (2^-6 of it) and within 2e-2;
   each shape's ``n_split`` and live-tile fraction; device
   times from a CUDA graph of many calls replayed between CUDA events (so
   the wrappers' host time is not counted; one eager call's time is printed
   beside), cycling enough copies of the cache to defeat the 50 MB L2,
   beside the bound in two forms (every cache row, and only the rows some
   query sees) and one PyTorch yardstick call
   (``scaled_dot_product_attention``, never used by the port);
6. the model plane's main path: ``LlamaRuntime(LlamaConfig.llama3_8b())``
   at full width and 12 of its 32 layers (random bf16 weights from seed 0,
   7.34 GB; the smoke's depth, ROADMAP) serves
   ``generate_batch`` of 8 prompts × 32 tokens through the engine (8 slots,
   window 512, chunk 8), once with a bf16 cache and once with an int8
   cache, launch counts zeroed just before and read just after each run:
   the run's kernel launches 12 × (forward passes) times, the other kernel
   0. Each prompt's tokens equal a solo ``generate_tokens`` up to the first
   step whose solo top-2 logit margin is below 0.25 (bf16 noise between
   batch shapes can flip a nearer tie), and every engine token lies within
   0.25 of the solo argmax on the engine's own prefix (one teacher-forced
   pass, so all 32 steps are checked); the int8 cache's first-step logits
   keep a cosine ≥ 0.99 to the bf16 cache's. Admission ms, decode step p50
   ms (host clock) and the step's device time (graph replay, with the
   engine's ``reach`` hint) against the 4.8 ms weight-read bound, and
   tokens/s.

7. mining at the reference bench's size (``bench.py``'s corpus: 120
   templates, seed 0, ~1,080 distinct texts expanded on the card): the full
   sweep at 500,000 rows (projection tier) and 131,072 (exact tier), each
   split into its stages (CUDA events) beside each stage's bound, purity ≥
   0.99 against the templates; the first 20,000 rows streamed through the
   delta top-k into a ``ClusterState`` in batches of 512, whose labels must
   equal the full sweep's; the card's delta top-k of 64 rows against a
   float64 host computation on the same bf16 rows (scores within 1e-4, ids
   equal where the host's neighbouring scores differ by more, and on exact
   ties, lowest row first).

8. the service plane (``KAKVEDA_NATIVE=require`` holds for the whole run:
   the native host tier must build with ``g++`` and load, and phase 4
   already runs on it): ``make_app`` over a fresh
   ``Platform(capacity=2^20, dim=2048)`` on a ``TCPSite`` at 127.0.0.1,
   driven by an ``aiohttp.ClientSession`` in this process (aiohttp is
   required: without it the phase fails). a. ``/ingest/batch`` of 8 × 512
   traces, three in four failing: the summed failures equal the GFKB's
   growth; traces/s. b. 256 ``/warn`` at concurrency 1, half of ingested
   signatures: p50, p99. c. 64 clients × 16 ``/warn``: p50, p99, warns/s,
   ``fused_topk`` launches (under 1024 and at least 16), requests per
   launch, and the share of the arm's wall that each batch's device
   dispatch spans (CUDA events). d. ``/failures/match``, ``/patterns``,
   ``/health/app-A``, ``/readyz`` (native available, the card) agree with
   the platform, and every answer of b and c equals a direct
   ``warn_batch`` of the same requests (action, confidence within 1e-4,
   the top-1 id wherever the direct top-2 differ by more). e.
   ``/patterns/mine {"mode": "full"}`` equals ``plat.mine(mode="full")``;
   after one more ingest ``/patterns/mine {}`` is incremental. The
   ``fused_topk`` launches of the service's own requests (a–e, counter
   zeroed before a; the direct calls that check them are left out) are
   the kernel row's ``launches_service``. Then the
   warn path's stages at B = 1 and 64 (signature text, featurize native
   and Python, upload, densify and ``fused_topk`` with CUDA events, d2h,
   the rest) beside the unsynchronized ``warn_batch`` wall, and one
   512-trace ingest batch's (classify, featurize, insert, delta dispatch,
   log append). Last ``python3 -m kakveda_tpu_torch.service`` as a
   process on the card with a 2^20-row index: it answers ``/healthz``
   within 120 s, ingests 8 × 512 traces, warns an ingested signature back
   to itself, serves 64 clients × 16 warns from this process (so client
   and server no longer share one event loop), exits 0 on SIGINT leaving a
   v5 snapshot, and a fresh ``Platform`` reopens its data dir; a second
   start restores the snapshot (its log and ``/failures`` say so) and
   answers the same ``/warn``.

11. restart and lifecycle at real size (after phase 12, before the model
   phases, which get the card back; in the pre-tiered configuration,
   ``KAKVEDA_GFKB_TIERED=0``: on ``restart_corpus``, which has no coarse
   structure, the default router spawns a centroid per cluster and its
   per-batch update grows with them, past the run's time limit at this
   phase's rows, as ``measure_router`` shows; phase 12 drives the tiered
   lifecycle): 2^16 distinct signatures (2^19, then 2^18 and 2^17, until
   the model phases 14 and 16 and then phase 19 needed the run's time; every depth cut is listed in
   ROADMAP, "The smoke's depth")
   (``restart_corpus``, clusters of 1-10, 1 in 64 spanning apps) through
   ``upsert_failures_batch`` × 4096 into a 2^20 × 2048 GFKB with mining
   on; ``crashsweep.run_sweep`` at the two fence sites with its
   children on the card (0 corrupt recoveries; started after phase 19,
   whose readings of the card's memory it would disturb, beside phase 12's
   untimed stages and joined before phase 12's first timed one);
   ``snapshot()`` timed by
   stage; a full replay (snapshot moved aside) and its first mine, a full
   sweep; the restore, which must take the restore path, timed by stage;
   the restored emb, valid and types bit-equal to the replay's, equal
   records, 64 held-out warns equal (ids, ties, scores), labels equal to
   the build's and the sweep's, a first mine that is incremental; aging
   of the first 1/8 (no warn returns an aged row, held against a plain
   top-k over the live rows), an organic resurrection whose row is
   bit-equal to its pre-tombstone row, ``compact()`` (log bytes before and
   after) and a reopen that is identical, tombstones kept; last, a full
   mine's wall where every cluster spans apps, at 2^13 and 2^14 rows,
   beside 1 in 64 at 2^14 (the pattern emission grows with the square of
   the spread clusters). Then ``measure_router``: the default
   ``TierConfig`` on 2^14 rows of ``restart_corpus`` against 2^14 of
   ``tier_corpus``, each through ``upsert_failures_batch`` × 4096 on the
   card: build rows/s, the router's ms per batch against its centroid
   count (and the fit's projection to this phase's and phase 12's rows), the
   [4096, C] score matrix's bytes, the routed match's p50 at B = 1 and 64
   over every row (the degraded warn's) and its top-1 recall against the
   exact scan. ``fused_topk``'s launches there are the kernel row's
   ``launches_restart``.

9. Mixtral-8x7B width with int8 weight-only weights, 8 of its 32 layers
   (the published config.json's values in ``MIXTRAL_8X7B``; random weights
   from seed 0). a. One 4096 × 14336 f32 matrix quantized on the card and on the
   CPU: ``q`` and ``s`` bit-identical. b. Two layers of Mixtral's width in
   bf16 (5.8 GB) and their int8 quantization on the same prompts:
   first-step logits keep a cosine ≥ 0.99 (``hold_cosine``: a prompt whose
   expert choice flipped across a router near-tie is printed, not held).
   c. ``LlamaRuntime(quant="int8")`` draws each matrix in f32 and quantizes
   it before the next: 12,013,220,864 bytes at 8 layers (46,872,802,304 at
   32; int8 projections and experts, a bf16 embedding, f32 scales, router
   and norms), the draw time and the
   peak allocated. d. Layer 0's ``moe_mlp`` at T = 8 and 64 against a
   per-token oracle (``moe_mlp_reference``): the same experts, each output
   row within 2^-6 of its largest oracle value. e. Phase 6's engine runs
   and checks, both caches (``KAKVEDA_KV_QUANT=int8``). f. Admission, decode
   step p50, the step's device time from a CUDA-graph replay of one
   ``_forward_wide`` (which a host sync in the MoE block would break) and
   its split into dequantize, GEMMs and ``bmm``s, ``flash_gqa_cache``, and
   router + dispatch + combine, beside the 14.0 ms weight-read bound.

10. the LLM judge on the ingest path (after phase 6 frees its model):
   ``KAKVEDA_CLASSIFIER=tiered KAKVEDA_MODEL_RUNTIME=torch`` puts
   Llama-3-8B (``get_runtime``, random bf16 weights from seed 0) beside a
   ``Platform(capacity=2^20, dim=2048)`` on the card. 4 × 512 traces from
   a seed, 1 in 8 ambiguous (citations asked for, no marker; prompt +
   response over 200-760 bytes), ingested rule-only on a fresh Platform
   and then with the judge. The submitted prompts must be ``judge_batches``'s,
   whose shapes phase 5 held. Arm A (``KAKVEDA_SERVE_WINDOW=2048``): every
   judge result through the engine, the prefix stats equal to the matching
   rules replayed over the submitted ids (``expected_prefix_stats``), flash
   launches 32 × forwards (prefix prefills and admissions counted), the
   signals the rule's plus ``parse_judge_verdict`` over the texts, the
   GFKB, cluster state, patterns and health consistent, then a
   ``warn_batch`` of 64 that launches ``fused_topk``. Arm B (window 512,
   ``KAKVEDA_PREFILL_CHUNK=256``): the same judge prompts, none fits the
   engine, one ``DecodeSession`` a batch, launches 32 × (pieces + steps),
   tokens equal arm A's or departing at a near-tie (``margin_rule``). One
   prefix-hit admission per cache type against the same prompt admitted
   whole (``KAKVEDA_SERVE_PREFIX=0``). Prints ingest traces/s with and
   without the judge, the judge's wall per batch, ``register_prefix`` ms,
   admission ms with and without the prefix (host, CUDA events, and the
   forward's graph replay), arm B's wall and prefill device time, and the
   peak allocated with both planes resident.

12. the host tiers past the hot cap and device loss (after phase 19, before
   phase 11; its build, recall, aging and compaction beside phase 11's
   crash sweep and its own d child, both joined before b's p50s): a
   2^20 × 2048 GFKB on the card with the hot cap at 2^18
   (``KAKVEDA_GFKB_HOT_ROWS``; nprobe 8, max_list 4096;
   ``KAKVEDA_GFKB_WARM_ROWS`` at 2^18 + 2^15 so 2^15 rows reach the cold
   shards) holding 2^18 + 2^16 rows of
   ``tier_corpus`` (prompt templates, an assumed structure the router can
   partition; ``measure_router`` in phase 11 sets it beside
   ``restart_corpus``), upserted × 4096 with mining off. a. The card stops
   at 2^18 rows; warm and cold rows and bytes. b. ``warn_batch`` at B = 1
   and 64 over hot, warm, cold and unseen signatures answers
   ``tier="tiered"``; p50 of 50 calls through ``Platform.warn_batch``,
   split into featurize, the hot ``fused_topk`` (CUDA events), the host
   routed match, merge and the rest; the hot part against
   ``fused_topk_reference``; routed top-1 recall against the exact host
   scan ≥ 0.99; the routed and exact host scans all in C++ (the scorer's
   ``ivf``, ``warm`` and ``cold`` counts move, no fallback). Aging of the
   first 1/8 on the tiered store, 16 cold rows in the promote-LRU exempt,
   no warn returning an aged row. c. ``device.unavailable``
   armed: 1,024 warns answer degraded from the warm tier (top-1 agreement
   with the healthy answers printed), ``/warn`` through ``make_app`` 200
   degraded, ``/readyz`` latched, ``generate_batch`` of a 2-layer bf16
   Llama (head_dim 128) raises ``DeviceUnavailableError`` in < 1 s; disarmed,
   the probe (``KAKVEDA_DEGRADED_PROBE=1``) unlatches within 2 s; the
   fallback count equals the degraded warns. d. A child process
   (``--sticky-child``, started with phase 11's crash sweep beside this
   phase's untimed stages) opens a store of 2^14 + 2^13 rows with the hot cap at 2^14
   (mining on: every overflow row attaches from the tiers),
   poisons its CUDA context with a device-side assert, and its warns then
   answer degraded and equal the ones it recorded before; the probe keeps
   failing, generation fails fast. e. ``compact()`` (a snapshot with its
   ``tiers`` section, then the log swap) and the restore through
   ``Platform``, each with its wall: 2^18 rows on the card, the aged ones
   untyped, the tombstones kept, the router restored bit-equal, the 64
   warns equal. f. The latch's transitions and the fallback count are 0
   after phases 4, 8 and 18, and after 19, 11, 12 and the model phases
   exactly the latches and degraded warns of the drills so far (phase 19
   a's storm, then c's one latch and 1,025 degraded warns); phase 10's warn
   is not degraded. ``fused_topk``'s launches there are the kernel row's
   ``launches_tiers``.
13. the serving engine's request lifecycle, inside phase 6's model
   lifetime on its Llama-3-8B weights (8 slots, window 512, chunk 8; the
   engine's backlog bound raised to 128 for b): a. 64 concurrent
   ``generate_stream`` consumers × 64 greedy tokens over phase 6's prompts,
   each stream's text equal to ``generate``'s for its prompt (or departing
   at a near-tie, phase 6's margin rule); TTFT p50 / p99, the delta gap
   p50 and tokens/s beside phase 6's ``generate_batch``; the bf16 kernel
   launched once a layer per forward (the row's ``launches_stream``). b. 8
   streams closed at their first delta free all 8 slots within two chunks;
   then 16 of 64 closed mid-decode and 4 requests cancelled while queued
   (``fut.cancel()``, not counted): the ``cancelled`` outcome equals the
   mid-decode closes, survivors equal their text. c. 4 requests past a
   3 s deadline (DEADLINE_S, 4 s at 16 layers) fail with ``DeadlineExceededError``, their tokens a prefix
   of an undeadlined run (or a near-tie departure), their slots freed, no
   restart; one queued behind them expires with no tokens. d. On the int8
   cache, ``engine.dispatch`` armed with 8 requests in flight and 1 queued:
   the 8 fail ``EngineRetryableError``, the queued one and a resubmit hold
   their pre-crash tokens, the registered prefix hits after the rebuild,
   allocated memory returns within one cache, and the restart's wall is
   printed; a second engine with ``KAKVEDA_SERVE_RESTARTS=1`` and every
   dispatch failing dies, and ``submit`` raises ``EngineDeadError`` in
   under 1 s; the int8 kernel launched 32 × forwards times
   (``launches_supervisor``). e. ``_sample_top_p`` at V = 128,256, B = 8:
   the kept sets on the card equal the CPU's, 1,000 draws inside them,
   ``top_p = 1e-9`` greedy. f. ``GET /metrics`` from a ``make_app`` in the
   process: ``kakveda_serving_requests_total`` by outcome equals the
   phase's own counts; ``GET /flightrecorder`` holds d's ``engine_error``
   and ``engine_restart``.
14. the model families (after phase 9; phase 5 first holds flash at their
   shapes, both bodies: Gemma-2-9B's H 16, KV 8, D 256 with the softcap of
   50 at the engine's decode mask with and without its 4,096-row band, the
   4,000-token admission and a 512-row prefill piece at pos0 4608 with
   and without the window; Phi-3-mini's H 32, KV 32, D 96 at decode and a
   piece; with the softcap q scaled so the scores reach past the cap, and
   the plain version without the cap held to fall outside the tolerance;
   the library call SDPA where no softcap applies, a compiled
   ``flex_attention`` with the cap as its score_mod where one does; and
   the blocks per SM the split count plans at each head_dim against the
   card's occupancy calculator). a. Gemma-2-9B width, 14 of its 42 layers
   (its published config through ``hf_config_to_llama``; random bf16
   weights drawn on the card, 9.22 GB) through ``LlamaRuntime`` ->
   ``ServingEngine`` at ``KAKVEDA_SERVE_WINDOW=8192`` (a 7.5 GB bf16
   cache): 8 prompts x 32 tokens and a 4,000-token prompt x 128 that
   decodes past the even layers' 4,096-token window, launch counts zeroed
   just before and read just after (14 x forwards, the other body 0),
   tokens held to the runtime's solo ``DecodeSession`` path by the margin
   rule; a 4,700-token prompt through the solo path in 512-row pieces
   (the engine takes no prompt past 4,096 tokens at this window) held to a
   single-shot prefill; admission and decode-step times beside the
   weight-read bound. b. The same weights with
   ``KAKVEDA_KV_QUANT=int8``: 4 prompts x 16 and the crossing prompt.
   c. Checkpoints of Qwen2 (biases, D 128), Qwen3 (q/k norms, D 128),
   Gemma (D 256), Gemma-2 (a query scale off the default, D 256) and Phi-3
   (longrope, fused projections, D 96), written by the script (config.json
   and a safetensors file from a few-line writer), loaded by
   ``hf_convert.load_hf_checkpoint(device="cuda")`` (leaves equal the CPU
   load's) and served through the engine: tokens equal the CPU runtime's,
   or depart at near-ties only.
15. speculative decoding, inside phase 6's model lifetime after phase 13
   and on its weights (phase 5 first holds flash at the verify chunk's
   per-slot positions, an int32 [B] ``pos0`` on the card, B = 8, S = 5:
   Llama-3-8B's heads at L = 2048 with slots at rows 95-1,900, Gemma-2-9B's
   with the softcap and window 4096 at L = 8192; and at D = 32, the
   default preset's H 8, KV 4: decode under the engine's mask and a
   512-row piece; both bodies; the library call SDPA with the boolean
   [B, 1, S, L] mask, or ``flex_attention`` with the softcap). a.
   ``LlamaRuntime.generate_batch`` of phase 6's 8 prompts and 8 prompts of
   a template repeated three times x 32 tokens through the engine with
   ``KAKVEDA_SERVE_SPEC=4`` (the default gate) and with ``spec_k`` 0, with
   each cache type: launches = layers x forwards, verify chunks run, tokens held
   to ``spec_k`` 0's by the margin rule, ``/metrics``' spec families equal
   to ``spec_stats``; tokens/s, tokens per verify and the gate's state; the
   verify chunk's S = 5 forward, a 1-wide step and the whole verify chunk
   as CUDA graphs replayed in turns. b. ``KAKVEDA_SPEC=1``
   ``LlamaRuntime.generate`` on 2 prompts x 64 tokens against the plain
   solo ``generate_tokens`` (margin rule), with its tokens per round. c.
   ``LlamaRuntime()`` with no preset (head_dim 32, seed 0) through the
   engine with and without speculation, tokens held to the CPU port's on
   the same weights, then ``get_runtime("torch")`` under a
   ``TieredClassifier`` judging 16 traces.

16. the model plane's last gaps (after phase 14; phase 5 first holds the
   f32 body, ``csrc/flash_gqa_cache_f32.cu``, at D 64 and 128 on three
   shapes, Llama-3-8B's heads: decode under the engine's mask at L 2048,
   the verify chunk at per-slot positions, a 512-row prefill piece; max
   |kernel - plain| within 1e-4, rtol 0, and the plain version over inputs
   rounded to TF32 or bf16 outside it; SDPA in f32 as the library call;
   the bound over the rows some query sees and the scores the mask keeps, its
   operations at 3xTF32's 165 TFLOP/s; correctness-only rows at
   the edges of its 16-, 32- and 64-row blocks, and their blocks per SM;
   phase 9 g speculates with Mixtral-8x7B int8: the engine at
   ``KAKVEDA_SERVE_SPEC=4`` on 4 prompts x 32 tokens and ``KAKVEDA_SPEC=1``
   on one, held to phase 9 e's greedy tokens with departures counted at
   logit or router near-ties, and layer 0's ``moe_mlp`` inside a verify
   chunk against its plain version). a. ``llama3_8b()`` in f32 at 12 of its 32 layers (14.67 GB)
   through the engine with and without ``KAKVEDA_SERVE_SPEC=4``, the f32
   body launched once a layer per forward, tokens held to the solo
   ``generate_tokens`` by the margin rule, the step beside its weight-read
   bound, then a tiny f32 config whose tokens equal the CPU port's. b.
   head_dim 80 (bf16 and f32) and an f16 model through ``gqa_grouped``,
   tokens equal to the CPU port's; ``gqa_grouped`` launched 0 times in
   every earlier model phase. c. a ``full_mask`` on the card == the CPU
   port. d. two written checkpoints with a ``tokenizer.json`` written by
   hand served by ``LlamaRuntime.from_hf`` and ``MultiModelRuntime``,
   texts and tokens == the CPU port's, the loads' seconds. e.
   ``core.profiling.profile()`` around a warm ``warn_batch`` at B = 64 and
   a solo ``generate_batch``: the trace's ``topk_kernel`` launches lie in
   ``gfkb.match.dispatch``, its ``flash_gqa_kernel`` launches in
   ``llama.generate_batch``; the ten costliest device operations with their
   shares; ``kakveda_device_block_seconds`` on ``/metrics``.

17. the request plane (on objects that exist: no new model, no new 2^20
   index). a-d on phase 8's ``Platform(capacity=2^20, dim=2048)`` and its
   app, a second app over the same Platform where a knob is read at
   ``make_app``: a. 256 ``/warn`` at concurrency 64, each with its own W3C
   ``traceparent``: every trace holds ``service.request`` under the
   caller's span and ``gfkb.warn`` under it (tier, native, not degraded,
   the answer's action), ``fused_topk`` launched once a micro-batch; the
   span ring's counts. b. ``KAKVEDA_RATELIMIT_RPS=50``, ``_BURST=10``: 100
   quick ``/ingest`` from one client admit the bucket's arithmetic (burst +
   rps x elapsed, ±1), the rest 429 with ``reason: "ratelimit"`` and a
   ``Retry-After``, counted on ``kakveda_admission_shed_total``. c. a small
   ``KAKVEDA_ADMIT_WARN`` (32): a noisy tenant at concurrency 128 beside a
   victim at 4: every shed is ``tenant_quota`` naming the noisy tenant, as
   many as ``kakveda_admission_tenant_shed_total`` counts; the victim holds
   the reference's noisy-neighbour contract (shed rate ≤ 0.05, the flooder
   ≥ 0.9 of the sheds, no gap past 1 s; its p95 against 3x its baseline a
   reading). d. ``KAKVEDA_SANITIZE=1``: one 400 ms block of the loop is one
   stall of at least 250 ms with a stack; the stalls under a ``/warn``
   flood and phase 8 b's p50 (named locks off) are readings. e. on phase
   6's Llama-3-8B after phase 15, the engine (8 slots) with
   ``KAKVEDA_SERVE_SPEC=4``, the gate held open, under the process-global
   brownout ladder driven by ``note_pressure`` (dwell 0.5 s): verify chunks
   at step 0; none at step 1 and the tokens of a ``spec_k`` 0 engine; every
   output cut at 32 at step 2; the background class then the interactive
   class shed with ``reason="brownout"`` at steps 3 and 4; down one step a
   dwell; ``kakveda_brownout_state`` and ``_transitions_total`` equal to the
   controller's own record; every ``serving.request`` span under its
   submitter's; then 16 clients through a small interactive bound move the
   ladder by themselves (a reading). f. phase 8's entry-point child under
   ``KAKVEDA_FAULTS_TIMELINE`` (``service.handler:1.0:20`` and
   ``trace.record:1.0:-1`` at t = 2 s): ``/healthz`` answers exactly 20
   500s, then 200; every ``/warn`` after answers 200 with every span
   dropped.

18. replication and the fleet plane (after phase 8, whose Platform this
   process must have freed): ``python3 -m kakveda_tpu_torch.cli up
   --replicas 2`` on the card, each replica a process with a 2^20 × 2048
   bf16 index (the card's used memory grows by at least 2 × 4 GiB beside
   this process's own; each ``/readyz`` names the card), and an oracle
   ``Platform`` in this process holding the same rows. a. phase 8's 8 × 512
   traces through the router: both replicas converge on 3,072 rows (write
   amplification 2); 256 ``/warn`` at concurrency 1 and 64 × 16 at 64
   through the router, every answer's action, top-1 confidence (1e-4) and
   scores rank by rank (1e-4) equal to the oracle's; p50, p99, warns/s;
   every answer not degraded and from the hot tier, no replica latched
   degraded; each replica's ``fused_topk`` launches across the two arms
   (its own ``fused_topk.launches``, which its ``/readyz`` reports under
   ``device.launches``, read before and after) > 0. b.
   SIGKILL of replica 1 under 64 concurrent clients: no warn lost; the card
   regains a 4 GiB index within 10 s (so the supervisor's children hold no
   device lease); an ingest while it is dead dead-letters, the router's
   supervisor restarts it (``KAKVEDA_FLEET_RESTARTS=1``) and the DLQ's
   auto-replay (``KAKVEDA_DLQ_AUTO_S``) converges the counts. d. 256
   concurrent ingests of clean batches at replica 0 (four times its ingest
   bound): its peer's ``kakveda_fleet_pressure`` and ladder step rise, and
   fall back within the gossip TTL. e. ``/metrics/fleet`` holds every
   replica's families and the router's; ``/trace/{id}`` through the router
   assembles ``router.forward`` with the replica's ``service.request``. c.
   ``KAKVEDA_FLEET_OWNERSHIP=1``, 4 replicas, R = 2, 64 apps (one ingest of
   48 traces each): the largest replica holds ≤ 0.6 of the rows, write
   amplification ≤ 2.3; each app's scatter-gather ``/warn`` is not partial
   and its top-1 confidence equals a second oracle's (1e-4), none
   degraded, every tier hot, each replica's ``fused_topk`` launches across
   them > 0; a 5th replica and ``POST /fleet/rebalance`` under 16 warn
   clients (epoch + 1, no warn lost, partial or degraded, the newcomer's
   rows none foreign); SIGTERM of an owner under the clients (ejected,
   promoted, every survivor at the router's epoch, coverage holes 0, no
   warn lost, partial or degraded); a stale-epoch ``/replicate`` is a 2xx
   drop counted on ``kakveda_fleet_fenced_rows_total``; no live replica
   latched degraded.

19. the elastic fleet and the traffic harness (after phase 18, before
   phase 11's crash sweep; a wall limit of its own, PHASE19_WALL_S). a. The
   storm drill as ``cli traffic storm`` runs it (``cli.main.run_storm``: the
   reference CLI's admission limits and brownout settings) on a 2^20 × 2048
   Platform on the card seeded with phase 8's 4,096 traces, the ``storm``
   scenario at tests/test_traffic.py's numbers (seed 5, 8 s at speed 1.5,
   gossip TTL 3 s): every SLO gate raises; warns answered inside the
   chaos timeline's device-loss window come degraded from the host, every
   other from the hot index with ``fused_topk`` launched; the latch back
   and the drill counted by ``check_healthy``. b. 256 ``/warn`` and 8
   ``/ingest/batch`` to ``python3 -m kakveda_tpu_torch.service`` on the
   card; ``cli traffic record`` writes its capture ring, equal to
   ``from_flightrecorder`` of the same dump; ``cli traffic replay --log``
   at speed 1 loses and hangs nothing, the child's ``fused_topk``
   launches rise and no warn falls back. c. ``cli up --replicas 2
   --autoscale 2:3 -d`` with ownership (R = 2) at 2^20 × 2048 a replica,
   bench.py ``_bench_elastic``'s replica env and drill knobs, under the
   ``flash_crowd`` scenario at tests/test_autoscaler.py's numbers (seed
   11, 4 + 18 + 12 s, replica 1 SIGKILLed at surge end): a scale-up
   whose replica holds rows and whose epoch only the router flips (where
   its migration meets the SIGKILL, as the JAX package's does when its
   replica is as late to be ready, the gate prints as failed beside the
   JAX reading, ROADMAP Queue 3, and the drain is not asked for), r1
   replaced at its index holding its rows again, a drain whose process
   outlives its place in the ring, at most one flap, every warn ok, not
   partial, from the hot index and held to an oracle Platform (action,
   top-1 confidence, distinct scores), ``scale_log.jsonl`` == the router's
   ``autoscale`` block == ``kakveda_fleet_scale_*``; each replica process's
   own ``fused_topk`` launches; the card's memory back after ``down``.

20. the application layer (its own wall limit, PHASE20_WALL_S, and ``jinja2``
   required). a. The dashboard mounted beside phase 8's app over phase 8's
   Platform (2^20 × 2048 bf16) by ``service.main.mount_dashboard``, as
   ``cli up --dashboard-port`` mounts it, its model the configured runtime
   (the stub): logged in as the demo admin, 8 ``/scenarios/run`` (warn →
   generate → ingest), each warn's stored answer held to
   ``fused_topk_reference`` over the index as it stood at that warn (the
   referenced failure id, or none, and the confidence within 1e-4; ranks
   within 1e-4 of the top are ties); a 64-example dataset through
   ``/datasets/{id}/eval``, whose one ``warn_batch`` is held likewise;
   ``/``, ``/warnings``, ``/runs``, ``/runs/{id}``, ``/failures/{id}``,
   ``/health-page`` and ``/admin/audit`` read back; ``fused_topk``'s
   launches of those requests > 0. b. A dashboard over phase 6's
   Llama-3-8B runtime (12 layers, bf16) and a small Platform on the card:
   one ``/playground/run`` and one ``/playground/stream`` at once, the run's
   text == ``rt.generate`` of the prompt (greedy), the stream's deltas
   joined == it (each, or its tokens depart at a near-tie, phase 6's
   margin rule, printed), ``/admin/serving`` showing the engine, the bf16 flash
   launches of the two requests > 0 and no other body's. c. ``python3 -m
   kakveda_tpu_torch.service.agent_echo`` as a child, registered through
   ``/api/agents/register``: ``/admin/agents/echo/test`` answers 200 healthy
   and a playground ``agent:echo`` target returns the echo; then, phase 8's
   Platform closed, ``cli status``, ``cli compact`` on the card and ``cli
   doctor`` on phase 20 a's data dir: every live row's warn answer (top-1
   id and score, ties as in a) equal after the compaction, ``doctor``
   naming the card. With ``--phases 20`` alone it builds phase 8 a's
   Platform and phase 6's runtime itself.

Prints a ``{"kernels": [...]}`` line (the flash rows with phase 9's,
phase 10's, phase 13's, phase 14's, phase 15's and phase 20's launches
beside phase 6's, phase 19's and phase 20's ``fused_topk`` launches, and
the judge, family and verify shapes' times), each phase's wall,
the card line, and last ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import contextlib
import dataclasses
import gc
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from datetime import datetime, timezone
from pathlib import Path
from typing import Optional

import torch

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOP_PER_S = 989e12  # dense bf16 tensor-core peak
F32_FLOP_PER_S = 67e12  # float32 outside the tensor cores
TF32X3_FLOP_PER_S = 495e12 / 3  # f32-grade products on the tensor cores: 3xTF32, three TF32 products each
ROWS, DIM = 1 << 20, 2048
ATOL = 1e-4  # bf16 inputs, f32 sums taken in another order than the plain version
# Flash: bf16 outputs from f32 sums taken in another order than the plain
# version's, so a probability's or an output's bf16 rounding may fall the
# other way. One bf16 step of x is at most 2^-7 |x|: each output row must lie
# within two steps of its largest plain value (FLASH_REL of it), and never
# past FLASH_ATOL (the largest outputs, |out| <~ 3, have steps of 1.6e-2).
FLASH_REL = 2.0**-6
FLASH_ATOL = 2e-2
# Softcap rows scale q by this: scaled scores ~N(0, 20^2) reach past a cap of
# 50 (randn inputs give |s| < 5, where the cap moves a score by < 0.012).
SOFTCAP_Q_SCALE = 20.0
H, KV, HD = 32, 8, 128  # Llama-3-8B attention heads, kv heads, head_dim
# Phase 6 (and 13, 15, 17 e, 16 a and 20 b on its weights or config) serves
# Llama-3-8B at full width and LLAMA3_LAYERS of its 32 layers (the smoke's
# depth: ROADMAP). bf16 bytes: the embedding and the untied head, and one
# layer's matrices (its norms are within the check's 0.01 GB).
LLAMA3_LAYERS = 12
LLAMA3_OTHER_BYTES = 2 * 128256 * 4096 * 2
LLAMA3_LAYER_BYTES = 2 * (2 * 4096 * 4096 + 2 * 4096 * 1024 + 3 * 4096 * 14336)
L2_BYTES = 50e6
# Solo top-2 logit margin below which a batched token may flip. A router
# logit is a logit: a gap between an expert kept and one left out below it
# is a near-tie that noise may flip too (bf16 between batch shapes, int8
# weights, an int8 cache through 32 layers).
MARGIN_TOL = 0.25
# Mixtral-8x7B-v0.1's published config.json (mistralai/Mixtral-8x7B-v0.1 on
# the Hugging Face Hub) as LlamaConfig fields, written out: nothing is
# downloaded. vocab 32000 (a multiple of 8, so no pad columns), 32 layers of
# 32 heads over 8 KV heads, 8 experts of width 14336, top-2, rope theta 1e6.
MIXTRAL_8X7B = dict(
    vocab_size=32000, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8, d_ff=14336,
    max_seq_len=32768, rope_theta=1e6, norm_eps=1e-5, sliding_window=0,
    n_experts=8, n_experts_per_tok=2, router_aux_coef=0.02,
)
# Phase 9 serves MIXTRAL_LAYERS of the 32 layers at full width (the smoke's
# depth: ROADMAP). int8 weight-only bytes: one layer (attention, eight
# experts, router, norms), and the embedding, head and final norm.
MIXTRAL_LAYERS = 8
MIXTRAL_LAYER_BYTES, MIXTRAL_OTHER_BYTES = 1_452_482_560, 393_360_384
INT8_COS_MIN = 0.99  # first-step logits, int8 cache vs bf16 cache, int8 weights vs bf16
STUB_RESPONSE = (
    "Here is a summary with references.\n\n"
    "References:\n"
    "[1] Smith et al. (2020) A Study on Things.\n"
    "[2] Doe (2021) Another Paper.\n"
)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Median of per-launch CUDA-event times after a warm-up."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def graph_ms(fn, n: int = 20) -> float:
    """Device time per call: ``n`` calls captured in one CUDA graph and
    replayed between CUDA events, so the host's time between launches (the
    wrappers' Python) is not counted. Median of three replays."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm up on a side stream before capture
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(n):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    del g
    return statistics.median(times)


def check_topk(v, i, rv, ri, what: str) -> float:
    """Scores within ATOL; ids equal where neighbouring plain scores differ."""
    err = (v - rv).abs().max().item()
    if not torch.isfinite(v).all() or err > ATOL:
        raise AssertionError(f"{what}: max |score - plain| = {err} > {ATOL}")
    gap = rv[:, :-1] - rv[:, 1:]
    big = torch.ones_like(rv, dtype=torch.bool)
    big[:, :-1] &= gap > ATOL
    big[:, 1:] &= gap > ATOL
    bad = (i != ri) & big
    if bad.any():
        raise AssertionError(f"{what}: ids differ where scores are separated: {bad.nonzero()[:5].tolist()}")
    return err


def phase_kernels(fused_topk, fused_topk_reference, card: str) -> dict:
    from kakveda_tpu_torch.ops.fused_topk import fused_topk_schedule_reference, workspace_shape

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    emb = torch.randn(ROWS, DIM, device="cuda", generator=gen)
    emb /= emb.norm(dim=1, keepdim=True)
    emb = emb.to(torch.bfloat16)
    valid = torch.rand(ROWS, device="cuda", generator=gen) < 0.9
    q = torch.randn(64, DIM, device="cuda", generator=gen)
    q /= q.norm(dim=1, keepdim=True)
    log(f"index {ROWS} x {DIM} bf16, {int(valid.sum())} valid rows")

    rows = {}
    max_err = 0.0
    for b in (1, 64):
        qb = q[:b].contiguous()
        n_cta = workspace_shape(b, ROWS, sms)[1]
        for k in (5, 8):
            v, i = fused_topk(emb, valid, qb, k)
            torch.cuda.synchronize()
            rv, ri = fused_topk_reference(emb, valid, qb, k)
            err = check_topk(v, i, rv, ri, f"fused_topk B={b} k={k}")
            sv, si = fused_topk_schedule_reference(emb, valid, qb, k, n_cta)
            err = max(err, check_topk(v, i, sv, si, f"fused_topk B={b} k={k} (schedule, {n_cta} blocks)"))
            max_err = max(max_err, err)
            ms = cuda_ms(lambda: fused_topk(emb, valid, qb, k))
            plain_ms = cuda_ms(lambda: fused_topk_reference(emb, valid, qb, k), iters=3, warmup=1)
            def library():
                return torch.topk(torch.where(valid, qb.to(torch.bfloat16) @ emb.T, -2.0), k, dim=1)

            lib_ms = cuda_ms(library)
            # Device time alone: launches replayed from a CUDA graph (the
            # eager times above include the wrapper's host time).
            dev_ms = graph_ms(lambda: fused_topk(emb, valid, qb, k), n=10)
            lib_dev_ms = graph_ms(library, n=10)
            nbytes = ROWS * DIM * 2 + ROWS + b * DIM * 4 + b * k * 8
            flops = 2 * b * ROWS * DIM
            bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
            bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations"
            log(
                f"fused_topk B={b} k={k} ({n_cta} blocks): max_abs_err={err:.3g} kernel_ms={ms:.4f} "
                f"plain_ms={plain_ms:.4f} library_ms={lib_ms:.4f} bound_ms={bound_ms:.4f} ({bound_by}) "
                f"share_of_bound={bound_ms / ms:.3f} kernel/library={ms / lib_ms:.3f}; graph replay: "
                f"kernel_ms={dev_ms:.4f} library_ms={lib_dev_ms:.4f} share_of_bound={bound_ms / dev_ms:.3f} [{card}]"
            )
            if k == 5:  # B = 1: the single warn, the main path's most frequent shape; 64: warn_batch
                rows[b] = dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bound_ms,
                               bound_by=bound_by, graph_ms=dev_ms, library_graph_ms=lib_dev_ms)
    row = rows[1]
    row["max_abs_err"] = max_err
    row["b64"] = rows[64]

    # Duplicated rows: exact ties across tiles resolve to the lowest row id.
    n_base = 4096
    emb.copy_(emb[:n_base].repeat(ROWS // n_base, 1))
    valid.fill_(True)
    qd = emb[:8].float()
    v, i = fused_topk(emb, valid, qd, 8)
    rv, ri = fused_topk_reference(emb, valid, qd, 8)
    want = torch.arange(8, device="cuda")[:, None] + n_base * torch.arange(8, device="cuda")[None, :]
    if not (torch.equal(i.long(), want) and torch.equal(ri.long(), want)):
        raise AssertionError(f"duplicate-row ties: kernel {i[0].tolist()} plain {ri[0].tolist()}")
    if not torch.equal(v, v[:, :1].expand_as(v)):
        raise AssertionError("duplicate rows must score exactly equal")
    log("fused_topk duplicate rows: lowest-index ties exact")
    return row


def _trace(TracePayload, i, app_id, prompt, response=STUB_RESPONSE):
    return TracePayload(
        trace_id=f"smoke-{i:06d}", ts=datetime.now(timezone.utc), app_id=app_id,
        agent_id="agent-1", prompt=prompt, response=response, model="stub",
        temperature=0.2, tools=[], env={"os": "linux"},
    )


def phase_platform(data_dir: Path, fused_topk, fused_topk_reference, card: str) -> dict:
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=data_dir, capacity=ROWS, dim=DIM)
    if plat.device.type != "cuda" or plat.gfkb._emb.dtype != torch.bfloat16:
        raise AssertionError(f"Platform is on {plat.device} / {plat.gfkb._emb.dtype}")
    scenarios = [
        ("app-A", "Summarize this document and include citations even if not provided."),
        ("app-B", "Explain research paper and add references."),
    ]

    async def demo():
        n = 0
        for app_id, prompt in scenarios:
            w = plat.warn(WarningRequest(app_id=app_id, agent_id="agent-1", prompt=prompt,
                                         tools=[], env={"os": "linux"}))
            if w.action not in ("warn", "block", "silent"):
                raise AssertionError(f"warn action {w.action!r}")
            await plat.ingest(_trace(TracePayload, n, app_id, prompt))
            n += 1
        for j in range(8):
            prompt = "Summarize and add references" if j % 2 == 0 else "Short answer with citations"
            await plat.ingest(_trace(TracePayload, n, "app-A", prompt))
            n += 1

    asyncio.run(demo())
    failures = plat.failures()
    if not failures or {a for f in failures for a in f.affected_apps} != {"app-A", "app-B"}:
        raise AssertionError(f"demo failures wrong: {failures}")
    patterns = plat.patterns_list()
    if len(patterns) != 1 or patterns[0].pattern_id != "FP-0001" or patterns[0].affected_apps != ["app-A", "app-B"]:
        raise AssertionError(f"demo pattern wrong: {patterns}")
    pts = plat.health_points("app-A")
    if not (len(pts) >= 9 and pts[-1].score < pts[0].score and pts[-1].recurrent_penalty > 0):
        raise AssertionError("app-A health did not fall")
    follow = WarningRequest(app_id="app-C", prompt=scenarios[0][1], tools=[], env={"os": "linux"})
    w2 = plat.warn(follow)
    if not (w2.confidence > 0.9 and w2.pattern_id == "FP-0001" and w2.references):
        raise AssertionError(f"follow-up warn wrong: {w2}")
    log(f"demo flow: {len(failures)} failures, pattern FP-0001 over app-A/app-B, "
        f"app-A health {pts[0].score} -> {pts[-1].score}, follow-up confidence {w2.confidence:.4f}")

    traces = [
        _trace(TracePayload, 100 + i, f"app-{i % 8}", f"Summarize report {i} and include citations")
        for i in range(4096)
    ]
    t0 = time.perf_counter()
    for lo in range(0, len(traces), 512):
        sig = asyncio.run(plat.ingest_batch(traces[lo : lo + 512]))
        if len(sig) != 512:
            raise AssertionError("ingest_batch lost failures")
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if plat.gfkb.count != len(failures) + 4096:
        raise AssertionError(f"GFKB count {plat.gfkb.count}")

    reqs = [
        WarningRequest(app_id="z", prompt=f"Summarize report {i * 61} and include citations", tools=[], env={})
        for i in range(64)
    ]
    res = plat.warn_batch(reqs)
    if len(res) != 64 or not all(r.confidence > 0.5 and r.pattern_id == "FP-0001" for r in res):
        raise AssertionError("warn_batch verdicts wrong")
    # The batch's matches against the plain top-k of the same index.
    gfkb = plat.gfkb
    idx, val = gfkb.featurizer.encode_batch_sparse([signature_text(r.prompt, r.tools, r.env) for r in reqs])
    q = gfkb._knn.densify(torch.as_tensor(idx, device="cuda"), torch.as_tensor(val, device="cuda"))
    rv, ri = fused_topk_reference(gfkb._emb, gfkb._valid, q, gfkb.top_k)
    by_slot = plat.failures()
    for j, r in enumerate(res):
        if abs(r.confidence - min(1.0, rv[j, 0].item())) > ATOL:
            raise AssertionError(f"warn {j}: confidence {r.confidence} vs plain {rv[j, 0].item()}")
        separated = rv[j, 0].item() - rv[j, 1].item() > ATOL
        want = by_slot[int(ri[j, 0])].failure_id
        if separated and not (r.references and r.references[0].failure_id == want):
            raise AssertionError(f"warn {j}: top-1 differs from the plain top-k ({want})")

    mining = check_mining(plat, card)

    one = [follow]
    warn1 = []
    for _ in range(50):
        t = time.perf_counter()
        plat.warn_batch(one)
        warn1.append((time.perf_counter() - t) * 1e3)
    warn64 = []
    for _ in range(20):
        t = time.perf_counter()
        plat.warn_batch(reqs)
        warn64.append((time.perf_counter() - t) * 1e3)
    records = plat.gfkb.count
    plat.close()
    del plat, gfkb
    torch.cuda.empty_cache()
    mining["parity"] = check_mining_parity(data_dir.parent, card)
    torch.cuda.empty_cache()

    ingest_ab = ingest_mining_off_on(data_dir.parent, traces)
    out = {
        "ingest_traces_per_s": 4096 / ingest_s,
        "ingest_ab": ingest_ab,
        "warn_p50_ms": statistics.median(warn1),
        "warn_batch64_p50_ms": statistics.median(warn64),
        "records": records,
        "mining": mining,
    }
    log("ingest of 4096 traces on fresh Platforms, mining off / on / on / off: "
        + " / ".join(f"{r['traces_per_s']:.1f}" for r in ingest_ab) + " traces/s; host ms in the mining "
        "attach per 512-batch (on): " + " / ".join(f"{r['attach_host_ms_per_batch']:.2f}" for r in ingest_ab
                                                   if r["mining"]) + f" [{card}]")
    log("main path: " + json.dumps(out))
    return out


def ingest_mining_off_on(base: Path, traces) -> list:
    """``ingest_batch`` of the same traces (batches of 512, after one warm-up
    batch) on fresh Platforms with mining off, on, on, off
    (``KAKVEDA_MINE_INCREMENTAL``), the card synchronized at both ends; with
    mining on, the host wall spent in the attach (the delta's dispatch and
    the match-cache reuse), per batch."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    warm = [_trace(TracePayload, 90_000 + i, "app-w", f"Warm up batch {i} and include citations")
            for i in range(512)]
    out = []
    for j, mining in enumerate((False, True, True, False)):
        os.environ["KAKVEDA_MINE_INCREMENTAL"] = "1" if mining else "0"
        try:
            plat = Platform(data_dir=base / f"ingest-{j}", capacity=ROWS, dim=DIM)
        finally:
            del os.environ["KAKVEDA_MINE_INCREMENTAL"]
        gfkb = plat.gfkb
        attach = gfkb._mine_attach_new
        spent = [0.0]

        def timed(*a, attach=attach, spent=spent):
            t = time.perf_counter()
            try:
                return attach(*a)
            finally:
                spent[0] += time.perf_counter() - t

        gfkb._mine_attach_new = timed
        asyncio.run(plat.ingest_batch(warm))
        torch.cuda.synchronize()
        spent[0] = 0.0
        t0 = time.perf_counter()
        for lo in range(0, len(traces), 512):
            asyncio.run(plat.ingest_batch(traces[lo : lo + 512]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        st = gfkb.mine_state_info()
        if mining != st["enabled"] or (not mining and gfkb.mine_delta_dispatches):
            raise AssertionError(f"KAKVEDA_MINE_INCREMENTAL={int(mining)}: {st}")
        if mining and (st["stale"] or not st["covers_all_rows"]):
            raise AssertionError(f"mining state after ingest: {st}")
        out.append(dict(mining=mining, traces_per_s=len(traces) / wall,
                        attach_host_ms_per_batch=spent[0] * 1e3 / (len(traces) // 512)))
        plat.close()
        del plat, gfkb
        torch.cuda.empty_cache()
    return out


MINING_CALLS = {"delta": 0, "sweep": 0, "rescore": 0}


def count_mining_calls() -> None:
    """Count the calls of the mining device programs in ``MINING_CALLS``:
    ``_block_topk`` as the ingest delta (bound into ``ops.incremental``) and
    as the sweep (``ops.clustering``), and ``_rescore_pairs``."""
    from kakveda_tpu_torch.ops import clustering, incremental

    for mod, attr, name in ((incremental, "_block_topk", "delta"), (clustering, "_block_topk", "sweep"),
                            (clustering, "_rescore_pairs", "rescore")):
        def counted(*a, fn=getattr(mod, attr), name=name, **k):
            MINING_CALLS[name] += 1
            return fn(*a, **k)

        setattr(mod, attr, counted)


def _pattern_key(patterns):
    return {(p.name, tuple(p.failure_ids), tuple(sorted(p.affected_apps)), p.description) for p in patterns}


def check_mining(plat, card: str) -> dict:
    """Mining on the ingest path (phase 4, after the batch ingest): the
    streaming state covers every row and never went stale, one delta per
    512-batch; ``mine()`` serves incrementally, then a full sweep re-seeds
    it; a warned signature attaches with no dispatch; the delta's device
    time beside its bound."""
    import numpy as np

    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.ops.incremental import delta_topk_sparse

    gfkb = plat.gfkb
    st = gfkb.mine_state_info()
    if not (st.get("enabled") and not st["stale"] and st["covers_all_rows"] and st["delta_dispatches"] >= 8):
        raise AssertionError(f"mining state after ingest: {st}")
    t = time.perf_counter()
    inc, info = plat.mine()
    inc_ms = (time.perf_counter() - t) * 1e3
    if info["mode"] != "incremental" or not inc or info["stale"] or not info["covers_all_rows"]:
        raise AssertionError(f"incremental mine: {info}, {len(inc)} patterns")
    labels_inc = gfkb._mine.labels()
    t = time.perf_counter()
    full, finfo = plat.mine(mode="full")
    full_ms = (time.perf_counter() - t) * 1e3
    labels_full = gfkb._mine.labels()  # the sweep's, installed by the re-seed
    if finfo["mode"] != "full" or not full:
        raise AssertionError(f"full mine: {finfo}, {len(full)} patterns")
    # "Summarize report {i}" rows each have thousands of neighbours above the
    # threshold, so the k-neighbour cap binds (evictions) and the streamed
    # graph is not the sweep's: the JAX package's partitions differ the same
    # way on this stream (tests/test_torch_mining.py). Equality where no list
    # evicts is check_mining_parity's.
    same = bool(np.array_equal(labels_inc, labels_full))
    if info["evictions"] == 0 and not same:
        raise AssertionError("no list evicted, yet the incremental partition differs from the sweep's")
    # A warned signature's ingest reuses the warn's neighbours: no dispatch.
    prompt = "Summarize report 99999 and include citations"
    d0 = gfkb.mine_delta_dispatches
    plat.warn(WarningRequest(app_id="app-1", prompt=prompt, tools=[], env={"os": "linux"}))
    asyncio.run(plat.ingest_batch([_trace(TracePayload, 99_999, "app-1", prompt)]))
    if gfkb.mine_delta_dispatches != d0:
        raise AssertionError("a warned signature's ingest dispatched a delta")
    again, ainfo = plat.mine()
    if ainfo["mode"] != "incremental" or ainfo["stale"] or not ainfo["covers_all_rows"]:
        raise AssertionError(f"after the reused attach: {ainfo}")

    calls = dict(MINING_CALLS)  # the main path's, before the timing below
    # One 512-batch delta against the 2^20-row index, device time.
    texts = [signature_text(f"Delta batch row {i} and include citations", [], {"os": "linux"})
             for i in range(512)]
    idx, val = gfkb.featurizer.encode_batch_sparse(texts)
    k = gfkb._mine.k + 1
    delta_ms = cuda_ms(lambda: delta_topk_sparse(gfkb._emb, gfkb._valid, idx, val, k), iters=5, warmup=1)
    nbytes = ROWS * DIM * 2 + ROWS + 512 * DIM * 2 + 512 * 2 * k * 4
    flops = 2 * 512 * ROWS * DIM
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    out = dict(
        calls=calls, delta_dispatches=ainfo["delta_dispatches"], attached=ainfo["attached"],
        evictions=info["evictions"],
        clusters_incremental=int(len(np.unique(labels_inc))), clusters_full=int(len(np.unique(labels_full))),
        partitions_equal=same, patterns=len(inc), mine_incremental_ms=inc_ms, mine_full_ms=full_ms,
        mine_incremental_wall_ms=info["wall_ms"], mine_full_wall_ms=finfo["wall_ms"],
        delta_ms_per_512=delta_ms, delta_bound_ms=bound_ms,
        delta_bound_by="bytes" if t_bytes >= t_ops else "operations",
    )
    log(f"mining on the ingest path: {ainfo['delta_dispatches']} delta dispatches, {ainfo['attached']} rows "
        f"attached, never stale; incremental mine {inc_ms:.2f} ms ({len(inc)} patterns, "
        f"{out['clusters_incremental']} clusters, {info['evictions']} evictions), full sweep {full_ms:.2f} ms "
        f"({len(full)} patterns, {out['clusters_full']} clusters), partitions equal: {same}; warned signature "
        f"attached with 0 dispatches; delta top-k (k={k}) of 512 rows vs {ROWS} x {DIM} bf16: "
        f"{delta_ms:.4f} ms, bound {bound_ms:.4f} ms ({out['delta_bound_by']}); calls on the main path "
        f"{json.dumps(calls)} [{card}]")
    return out


def parity_corpus(n: int, seed: int = 1):
    """(app, prompt) pairs of citation failures in clusters of 1-10 members
    (thirteen random four-letter words, one of them changed per member):
    about 0.85 cosine inside a cluster, under 0.45 across, so no row has
    more than nine neighbours above 0.6 and no list ever evicts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    out, c = [], 0
    while len(out) < n:
        words = ["".join(rng.choice(letters, 4)) for _ in range(13)]
        for j in range(int(rng.integers(1, 11))):
            w = list(words)
            w[j] = "zz" + w[j][2:]
            out.append((f"app-{(c + j) % 8}", f"Sources: {' '.join(w)}"))
        c += 1
    return out[:n]


def check_mining_parity(data_dir: Path, card: str) -> dict:
    """Incremental mining equals the full sweep where the reference promises
    it (no neighbour list evicts): two Platforms at the GFKB's real size
    ingest one stream of 4096 traces in batches of 512; one mines
    incrementally, the other by a full sweep; the patterns (name, failure
    ids, apps, description) and the partitions must be equal."""
    import numpy as np

    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    traces = [_trace(TracePayload, 200_000 + i, app, prompt) for i, (app, prompt) in enumerate(parity_corpus(4096))]
    plats = [Platform(data_dir=data_dir / name, capacity=ROWS, dim=DIM) for name in ("auto", "full")]
    for p in plats:
        for lo in range(0, len(traces), 512):
            asyncio.run(p.ingest_batch(traces[lo : lo + 512]))
    auto, full = plats
    t = time.perf_counter()
    inc, info = auto.mine()
    inc_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    swept, finfo = full.mine(mode="full")
    full_ms = (time.perf_counter() - t) * 1e3
    if info["mode"] != "incremental" or info["stale"] or info["evictions"] or finfo["mode"] != "full":
        raise AssertionError(f"parity stream: {info} / {finfo}")
    if not inc or _pattern_key(inc) != _pattern_key(swept):
        raise AssertionError(f"incremental patterns ({len(inc)}) differ from the full sweep's ({len(swept)})")
    labels = auto.gfkb._mine.labels()
    if not np.array_equal(labels, full.gfkb._mine.labels()):
        raise AssertionError("incremental partition differs from the full sweep's")
    for p in plats:
        p.close()
    out = dict(rows=len(labels), clusters=int(len(np.unique(labels))), patterns=len(inc),
               mine_incremental_ms=inc_ms, mine_full_ms=full_ms, delta_dispatches=info["delta_dispatches"])
    log(f"incremental == full where no list evicts: {len(labels)} rows, {out['clusters']} clusters, "
        f"{len(inc)} patterns equal; incremental mine {inc_ms:.2f} ms, full sweep {full_ms:.2f} ms "
        f"({info['delta_dispatches']} delta dispatches) [{card}]")
    return out


VERBS = ["Summarize", "Explain", "Describe", "Review", "Outline"]
OBJS = ["report", "paper", "contract", "dataset", "incident", "ticket"]
TAILS = [
    "and include citations even if not provided",
    "and add references for every claim",
    "listing all sources used",
    "with a short bibliography",
]
MINE_N, MINE_EXACT_N, MINE_INC_N, MINE_BATCH, MINE_TEMPLATES = 500_000, 1 << 17, 20_000, 512, 120
MINE_MIN_PURITY = 0.99


def mine_corpus(n: int, n_templates: int, dim: int):
    """``bench.py``'s mining corpus (seed 0): (template ids [n], bf16 rows
    [n, dim] on the card, text id [n]). The ~1,080 distinct texts are
    encoded once and expanded by index on the card."""
    import numpy as np

    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.ops.featurizer import HashedNGramFeaturizer
    from kakveda_tpu_torch.ops.knn import densify

    rng = np.random.default_rng(0)
    tmpl = rng.integers(0, n_templates, size=n)
    item = rng.integers(0, 9, size=n)  # the same stream as one draw per row
    combo = tmpl * 9 + item
    uniq, text_id = np.unique(combo, return_inverse=True)
    texts = [
        signature_text(f"{VERBS[t % len(VERBS)]} the {OBJS[(t // len(VERBS)) % len(OBJS)]} "
                       f"variant {t} {TAILS[t % len(TAILS)]} item {c % 9}", [], {"os": "linux"})
        for c in uniq.tolist() for t in [c // 9]
    ]
    idx, val = HashedNGramFeaturizer(dim=dim).encode_batch_sparse(texts)
    u = densify(torch.from_numpy(idx).cuda(), torch.from_numpy(val).cuda(), dim).to(torch.bfloat16)
    return tmpl, u[torch.from_numpy(text_id).cuda()], text_id


def purity(labels, truth) -> float:
    """Majority-template share per cluster label (``bench.py``'s measure)."""
    import numpy as np

    order = np.argsort(labels, kind="stable")
    sl, st = labels[order], truth[order]
    bounds = np.flatnonzero(np.r_[True, sl[1:] != sl[:-1], True])
    correct = sum(int(np.unique(st[a:b], return_counts=True)[1].max()) for a, b in zip(bounds[:-1], bounds[1:]))
    return correct / len(labels)


def sweep_bounds(n: int, tier: str, candidates: int) -> dict:
    """The least device time of the sweep's stages at ``n`` rows: the
    candidate sweep (every pair's product, bf16 on the tensor cores in the
    exact tier, f32 over the projected rows otherwise; the rows read once,
    the packed top-k written once) and, in the projection tier, the
    projection and the f32 re-score of the ``candidates`` pairs."""
    from kakveda_tpu_torch.ops import clustering

    kk = clustering._KNN_K + 1
    out = {}
    if tier == "exact":
        ops, nbytes = 2 * n * n * DIM / BF16_FLOP_PER_S, (n * DIM * 2 + n * kk * 8) / HBM_BYTES_PER_S
    else:
        m = clustering._MINE_DIM
        ops, nbytes = 2 * n * n * m / F32_FLOP_PER_S, (n * m * 4 + n * kk * 8) / HBM_BYTES_PER_S
        out["project_bound_ms"] = max(2 * n * DIM * m / F32_FLOP_PER_S, (n * DIM * 2 + n * m * 4) / HBM_BYTES_PER_S) * 1e3
        out["rescore_bound_ms"] = max(candidates * 2 * DIM / F32_FLOP_PER_S,
                                      (n * DIM * 2 + candidates * 20) / HBM_BYTES_PER_S) * 1e3
    out["sweep_bound_ms"] = max(ops, nbytes) * 1e3
    return out


def sweep_block_split(v, text_id, card: str) -> dict:
    """One block of the sweep at phase 7's shapes, its stages apart (CUDA
    events): ``_QBLOCK`` query rows against a column block as wide as
    ``_SCORE_BLOCK_BYTES`` of f32 scores allow; the product (bf16 on the
    tensor cores over the full dim, f32 over the projected rows) and the
    selection (``torch.topk`` alone, and the exact top-k with its tie
    resolution that ``_block_topk`` runs). The block's duplicated rows
    (``text_id``) must score bit-identically: the tie rule rests on it."""
    import numpy as np

    from kakveda_tpu_torch.ops import clustering

    qn = clustering._QBLOCK
    width = clustering._SCORE_BLOCK_BYTES // (4 * qn)
    k = clustering._KNN_K + 1
    proj = clustering._project(v[:width], clustering._MINE_DIM)
    _, first = np.unique(text_id[:width], return_index=True)
    first_of = torch.from_numpy(first[np.unique(text_id[:width], return_inverse=True)[1]]).cuda()
    out = {}
    for tier, rows in (("exact", v[:width]), ("projection", proj)):
        q = rows[:qn]
        product_ms = cuda_ms(lambda: clustering._scores(q, rows), iters=5, warmup=1)
        s = clustering._scores(q, rows)
        if not torch.equal(s, s[:, first_of]):
            raise AssertionError(f"{tier}: duplicated rows score differently in one product")
        topk_ms = cuda_ms(lambda: torch.topk(s, k, dim=1), iters=5, warmup=1)
        select_ms = cuda_ms(lambda: clustering._exact_topk(s, k), iters=5, warmup=1)
        out[tier] = dict(q=qn, width=width, dim=rows.shape[1], dtype=str(rows.dtype).replace("torch.", ""),
                         product_ms=product_ms, topk_ms=topk_ms, exact_topk_ms=select_ms)
        del s
    log("one sweep block [" + f"{qn} x {width}" + "]: " + "; ".join(
        f"{t} ({r['dtype']}, d={r['dim']}) product {r['product_ms']:.3f} ms, torch.topk {r['topk_ms']:.3f} ms, "
        f"exact top-k with ties {r['exact_topk_ms']:.3f} ms" for t, r in out.items())
        + f"; duplicated rows bit-identical in both products [{card}]")
    return out


def phase_mining(card: str) -> dict:
    """Mining at the reference bench's size: the full sweep (projection
    tier) at 500,000 rows and the exact tier at 131,072, each split into
    its stages; the incremental arm on the first 20,000 rows, whose labels
    must equal the full sweep's; and the card's delta top-k against a
    float64 host computation on the same bf16 rows."""
    import numpy as np

    from kakveda_tpu_torch.ops import clustering
    from kakveda_tpu_torch.ops.incremental import ClusterState, delta_topk_dense, unpack_topk

    t0 = time.perf_counter()
    tmpl, v, text_id = mine_corpus(MINE_N, MINE_TEMPLATES, DIM)
    torch.cuda.synchronize()
    log(f"mining corpus: {MINE_N} rows x {DIM} bf16 from {int(text_id.max()) + 1} distinct texts, "
        f"{MINE_TEMPLATES} templates, built in {time.perf_counter() - t0:.2f} s (untimed)")
    out = {}
    for name, n in (("full_500k", MINE_N), ("exact_131k", MINE_EXACT_N)):
        stats = {}
        t = time.perf_counter()
        labels = clustering.cluster_embeddings(v[:n], threshold=0.6, stats=stats)
        wall = (time.perf_counter() - t) * 1e3
        p = purity(labels, tmpl[:n])
        n_cl = int(len(np.unique(labels)))
        tier = "projection" if "rescore_ms" in stats else "exact"
        bounds = sweep_bounds(n, tier, stats["candidates"])
        out[name] = dict(n=n, tier=tier, wall_ms=wall, purity=p, clusters=n_cl, **stats, **bounds)
        log(f"full sweep at {n} rows ({tier} tier): wall {wall:.1f} ms = " + ", ".join(
            f"{key} {val:.1f}" for key, val in stats.items() if key.endswith("ms"))
            + f"; {stats['edges']} edges of {stats['candidates']} candidates, {n_cl} clusters, purity {p:.4f}; "
            + ", ".join(f"{key} {val:.2f}" for key, val in bounds.items()) + f" [{card}]")
        if p < MINE_MIN_PURITY:
            raise AssertionError(f"purity {p} below {MINE_MIN_PURITY} at {n} rows")
        if name == "full_500k" and tier != "projection":
            raise AssertionError("500,000 rows did not take the projection tier")

    out["block_split"] = sweep_block_split(v, text_id, card)

    # Incremental arm: the first 20,000 rows streamed in batches of 512.
    n, bs, k = MINE_INC_N, MINE_BATCH, clustering._KNN_K
    vv = v[:n]
    t = time.perf_counter()
    labels_sub = clustering.cluster_embeddings(vv, threshold=0.6)
    full_sub_ms = (time.perf_counter() - t) * 1e3
    state = ClusterState(threshold=0.6, k=k)
    unpack_topk(delta_topk_dense(vv[:bs], vv, bs, k + 1), bs)  # warm-up, off the clock
    t_stream = 0.0
    for s in range(0, n, bs):
        e = min(s + bs, n)
        t = time.perf_counter()
        sims, idx = unpack_topk(delta_topk_dense(vv[s:e], vv, e, k + 1), e - s)
        for r in range(e - s):
            state.add_row(s + r)
        for r in range(e - s):
            state.attach(s + r, idx[r], sims[r])
        t_stream += time.perf_counter() - t
    t = time.perf_counter()
    inc_labels = state.labels()
    refresh_ms = (time.perf_counter() - t) * 1e3
    parity = bool(np.array_equal(inc_labels, labels_sub))
    p_inc = purity(inc_labels, tmpl[:n])
    out["incremental_20k"] = dict(n=n, batch=bs, stream_wall_s=t_stream, ms_per_row=t_stream * 1e3 / n,
                                  refresh_ms=refresh_ms, full_sweep_ms=full_sub_ms, parity=parity,
                                  purity=p_inc, clusters=state.n_clusters, evictions=state.evictions)
    log(f"incremental arm: {n} rows in batches of {bs}, stream {t_stream:.3f} s "
        f"({t_stream * 1e3 / n:.4f} ms/row), refresh {refresh_ms:.2f} ms vs full sweep {full_sub_ms:.1f} ms, "
        f"parity {parity}, purity {p_inc:.4f}, {state.n_clusters} clusters, {state.evictions} evictions [{card}]")
    if not parity or p_inc < MINE_MIN_PURITY:
        raise AssertionError(f"incremental arm: parity {parity}, purity {p_inc}")

    # Card against host: 64 rows' delta top-k vs float64 on the same bf16
    # rows (computed per distinct text, so duplicated rows tie exactly).
    q0 = 5000
    sims, idx = unpack_topk(delta_topk_dense(vv[q0 : q0 + 64], vv, n, k + 1), 64)
    u64 = v[:n].double().cpu().numpy()
    first = np.unique(text_id[:n], return_index=True)[1]
    tid = np.searchsorted(np.unique(text_id[:n]), text_id[:n])
    host = (u64[first][tid[q0 : q0 + 64]] @ u64[first].T)[:, tid]  # [64, n]
    # One rank past k + 1, so a near-tie across the boundary is seen.
    order = np.lexsort((np.broadcast_to(np.arange(n), host.shape), -host), axis=1)[:, : k + 2]
    hv = np.take_along_axis(host, order, 1)
    err = float(np.abs(sims - hv[:, : k + 1]).max())
    gap = np.abs(np.diff(hv, axis=1))
    ok = (gap > ATOL) | (gap == 0)  # separated, or an exact tie (lowest row first)
    sep = np.ones_like(hv, dtype=bool)
    sep[:, :-1] &= ok
    sep[:, 1:] &= ok
    bad = (idx != order[:, : k + 1]) & sep[:, : k + 1]
    if err > ATOL or bad.any():
        raise AssertionError(f"delta top-k vs host: max |score| err {err}, {int(bad.sum())} ids differ")
    ties = int((gap == 0).sum())
    out["card_vs_host"] = dict(rows=64, k=k + 1, max_abs_err=err, exact_ties_checked=ties)
    log(f"delta top-k of 64 rows vs float64 host on the same bf16 rows: max |score err| {err:.3g}, "
        f"ids equal ({ties} exact ties, lowest row first) [{card}]")
    del v, vv
    torch.cuda.empty_cache()
    log("mining: " + json.dumps(out))
    return out


def flash_check(out, ref):
    """(max |out - ref|, its worst share of the tolerance): every row within
    FLASH_REL of its largest |ref| and within FLASH_ATOL; a share > 1 fails."""
    diff = (out.float() - ref.float()).abs()
    tol = (ref.float().abs().amax(dim=-1, keepdim=True) * FLASH_REL).clamp(max=FLASH_ATOL)
    return diff.max().item(), (diff / tol.clamp_min(1e-30)).max().item()


ENGINE_POS = 95  # phase 6's last decode row: prompts in the 64 bucket + 32 new tokens
FLASH_SHAPES = [
    # (name, B, S, L, pos0, kv_valid, reach hint)
    ("decode", 8, 1, 512, 512, "slots", None),
    ("decode_engine", 8, 1, 512, 512, "engine", ENGINE_POS + 1),
    ("admission", 1, 64, 512, 0, "leftpad", None),
    ("long_cache", 8, 1, 8192, 8192, None, None),
    # The LLM judge's shapes (phase 10): a 560-token judge prompt reusing the
    # 69-token judge head at window 2048 (bucket 1024, left pad 464, sw 512,
    # split 48), and DecodeSession's pieces for 64 judge prompts of <= 768
    # tokens at KAKVEDA_PREFILL_CHUNK=256.
    ("prefix_admission", 1, 512, 2048, 512, "prefix", None),
    ("chunk_prefill_256", 64, 256, 1024, 256, "chunkpad", None),
    ("chunk_prefill_512", 64, 256, 1024, 512, "chunkpad", None),
]
JUDGE_SHAPES = ("prefix_admission", "chunk_prefill_256", "chunk_prefill_512")


def judge_flash_shapes() -> list:
    """The flash shapes phase 10's own traffic gives, from the arithmetic
    the engine and the solo path apply to its judge prompts (so the checked
    shapes and the run's cannot drift apart; phase 10 asserts its prompts
    are these): arm A's heaviest whole admission (B = 1, S = its bucket,
    pos0 = 0, L = the 2048 window) and heaviest prefix hit (S = sw at pos0 =
    off + split), and each DecodeSession piece of arm B's widest batch (B =
    its prompts, S = 256, pos0 = k·256, L = its cache rows), with the exact
    ``kv_valid`` each runs with."""
    from kakveda_tpu_torch.models import generate as G
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.models.serving import ContinuousBatcher
    from kakveda_tpu_torch.models.tokenizer import ByteTokenizer
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT

    batches = judge_batches()
    head = ByteTokenizer().encode(_JUDGE_PROMPT.split("{prompt}")[0])
    admissions = []
    expected_prefix_stats(head, batches, JUDGE_WINDOW, JUDGE_PREFIX_MAX, admissions)
    ar = torch.arange(JUDGE_WINDOW)

    def admission(name, p, sw, split):
        bucket = ContinuousBatcher.bucket_for(p, JUDGE_WINDOW)
        off = bucket - p
        valid = ((ar >= off) & (ar < bucket))[None]
        return (name, 1, sw or bucket, JUDGE_WINDOW, off + split if sw else 0, valid, None)

    p = max(p for p, sw, _ in admissions if sw is None)
    out = [admission("judge_whole_admission", p, None, 0)]
    hit = max(((sw, p, split) for p, sw, split in admissions if sw is not None), default=None)
    if hit is not None:
        out.append(admission("judge_prefix_hit", hit[1], hit[0], hit[2]))
    widths = [G._prefill_width(max(map(len, ids)), JUDGE_CHUNK) for ids in batches]
    b = max(range(len(batches)), key=lambda i: (widths[i], i))
    ml = G._bucket_len(widths[b] + JUDGE_MAX_TOKENS + 1, LlamaConfig.llama3_8b().max_seq_len)
    valid = torch.from_numpy(G._pack_prompts(batches[b], ml, plen=widths[b])[1])
    out += [(f"judge_chunk_{pos0}", len(batches[b]), JUDGE_CHUNK, ml, pos0, valid, None)
            for pos0 in range(0, widths[b], JUDGE_CHUNK)]
    return out


def flash_inputs(gen, b, s, l, kind, kv8, copies, heads=(H, KV, HD), dtype=torch.bfloat16):
    """q, ``copies`` replicas of the cache (cycled so timed launches find it
    cold in L2, as the 32 layers of a real step do), scales, kv_valid.
    ``heads`` is (H, KV, D); q and a float cache in ``dtype``."""
    from kakveda_tpu_torch.models.llama import _kv_quant_rows

    h, kvh, d = heads
    q = torch.randn(b, s, h, d, device="cuda", generator=gen).to(dtype)
    ks = vs = None
    k = torch.randn(copies, b, kvh, l, d, device="cuda", generator=gen).to(dtype)
    v = torch.randn(copies, b, kvh, l, d, device="cuda", generator=gen).to(dtype)
    if kv8:
        k, ks = _kv_quant_rows(k)
        v, vs = _kv_quant_rows(v)
    ar = torch.arange(l, device="cuda")
    valid = None
    if kind == "slots":  # the serving decode regime: a band per slot
        lo = torch.randint(0, 64, (b, 1), device="cuda", generator=gen)
        hi = torch.randint(64, l + 1, (b, 1), device="cuda", generator=gen)
        valid = ((ar >= lo) & (ar < hi)).contiguous()
        valid[b - 1] = False  # a slot that sees nothing
    elif kind == "engine":  # _forward_wide's mask: rows [left pad, slot_pos], one slot_pos for all
        off = torch.randint(10, 17, (b, 1), device="cuda", generator=gen)  # 48-54-token prompts
        valid = ((ar >= off) & (ar <= ENGINE_POS)).contiguous()
    elif kind == "leftpad":  # admission: 13 left-pad rows, the prompt bucket of 64
        valid = ((ar >= 13) & (ar < s)).expand(b, l).contiguous()
    elif kind == "prefix":  # the slot's prompt rows [off, bucket) of a prefix-hit admission
        valid = ((ar >= 464) & (ar < 1024)).expand(b, l).contiguous()
    elif kind == "chunkpad":  # DecodeSession: rows from each prompt's left pad on
        off = torch.randint(0, 507, (b, 1), device="cuda", generator=gen)  # prompts of 262-768 tokens
        valid = (ar >= off).contiguous()
    elif torch.is_tensor(kind):  # the exact mask a run gives (judge_flash_shapes)
        valid = kind.to("cuda").expand(b, l).contiguous()
    elif isinstance(kind, tuple) and kind[0] == "from":  # a prompt's rows [off, end)
        valid = ((ar >= kind[1]) & (ar < kind[2])).expand(b, l).contiguous()
    elif isinstance(kind, tuple) and kind[0] == "slots_at":  # the engine's decode mask, slots at rows [lo, hi), the band when > 0
        _, lo, hi, band = kind
        pos = torch.randint(lo, hi, (b, 1), device="cuda", generator=gen)
        off = torch.randint(0, 64, (b, 1), device="cuda", generator=gen)
        valid = (ar >= off) & (ar <= pos)
        if band:
            valid &= ar > pos - band
        valid = valid.contiguous()
    return q, k, v, ks, vs, valid


def flash_bound_ms(b, s, l, kv8, seen_rows=None, heads=(H, KV, HD), eb=2, flop_rate=BF16_FLOP_PER_S,
                   kept=None):
    """Each input read once, the output written once, over 3.35 TB/s; the
    two products' flops over 989 TFLOP/s bf16 (``eb`` bytes an element and
    ``flop_rate`` for another type: the f32 body gives 4 and the tensor
    cores' 3xTF32 rate). Returns (ms, bound_by).
    With ``seen_rows`` (cache rows, summed over the batch, that at least one
    query row can see) only those rows' K/V count, in bytes and flops: the
    least a kernel that skips what no query sees must still read. With
    ``kept`` (the scores the mask keeps: over the batch and the query
    positions, the cache rows each one sees) the flops count those scores
    alone. A softcap's tanh per score is not counted."""
    h, kvh, d = heads
    r = h // kvh
    rows = b * l if seen_rows is None else seen_rows
    kv_bytes = 2 * rows * (d + 4) if kv8 else 2 * rows * d * eb
    nbytes = kvh * (b * 2 * s * r * d * eb + kv_bytes) + b * l
    flops = 4 * kvh * r * d * (s * rows if kept is None else kept)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def flash_schedule(b, s, l, pos0, valid, reach=None, heads=(H, KV, HD), window=0, kv8=False, f32=False):
    """The kernel's schedule at this shape: (n_split, live-tile fraction
    over all its (b·kv, q block) tile visits, cache rows some query sees).
    ``pos0`` is an int or, for a verify chunk, an int32 [B] tensor (the
    wrapper then plans from ``reach`` alone, all of L without one)."""
    from kakveda_tpu_torch.models.attention import (
        flash_live_tiles, flash_split_count, kernel_blocks_per_sm, kernel_q_rows,
    )

    h, kvh, d = heads
    r = h // kvh
    sr = s * r
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    vec = torch.is_tensor(pos0)
    hint = reach if vec else (pos0 + s if reach is None else min(pos0 + s, reach))
    n_split = flash_split_count(b * kvh, sr, l, sms, reach=hint,
                                blocks_per_sm=kernel_blocks_per_sm(d, kv8, sr, f32))
    qb = kernel_q_rows(sr)
    live = [flash_live_tiles(l, pos0, r, r0, min(sr, r0 + qb), valid, window).expand(b, -1).float().mean().item()
            for r0 in range(0, sr, qb)]
    col = torch.arange(l, device="cuda")[None, :]
    p0 = pos0.long()[:, None] if vec else pos0
    seen = col <= p0 + s - 1
    if window:
        seen = seen & (col > p0 - window)
    if valid is not None:
        seen = seen & valid
    return n_split, statistics.mean(live), int(seen.expand(b, l).sum())


# flex_attention's mask and score functions read the row's mask and cap
# from here, so that one traced pair serves every softcap row: a compile
# per shape, not per row or body.
_FLEX_ROW = {}
_FLEX = {}


def _flex_mask(b, h, q_idx, kv_idx):
    row = _FLEX_ROW
    q_pos = q_idx + row["pos0"][b]
    return (q_pos >= kv_idx) & (q_pos - kv_idx < row["window"]) & row["valid"][b, kv_idx]


def _flex_softcap(score, b, h, q_idx, kv_idx):
    return _FLEX_ROW["cap"] * torch.tanh(score / _FLEX_ROW["cap"])


def flex_library(q, pos0, valid, window, softcap, l, k0, v0, ref):
    """The library call of a softcap row: one ``flex_attention``, compiled
    to its fused Triton kernel (eager where the compile fails), with the
    cap as its score_mod (applied to the D^-0.5-scaled scores, before the
    mask, the kernel's order) and the causal / window / kv_valid mask as its
    block mask, q heads-major, ``enable_gqa``. Held to the plain version
    ``ref`` on the first cache copy (``k0``, ``v0``). Returns (call(k, v),
    how); call is None, and how says why, where it cannot serve."""
    from torch.nn.attention.flex_attention import create_block_mask, flex_attention

    b, s = q.shape[:2]
    _FLEX_ROW.update(
        pos0=(pos0.long() if torch.is_tensor(pos0) else torch.full((b,), pos0, device="cuda")),
        window=torch.tensor(window or 2 * l + s, device="cuda"),
        valid=valid if valid is not None else torch.ones(b, l, dtype=torch.bool, device="cuda"), cap=float(softcap))
    qh = q.transpose(1, 2).contiguous()
    errors = []
    for how in ("compiled", "eager"):
        try:
            if how == "compiled" and "fn" not in _FLEX:
                _FLEX["fn"] = torch.compile(flex_attention, dynamic=False)
            fn = _FLEX["fn"] if how == "compiled" else flex_attention
            bm = create_block_mask(_flex_mask, B=b, H=None, Q_LEN=s, KV_LEN=l, device="cuda")

            def call(kk, vv, fn=fn, bm=bm):
                return fn(qh, kk, vv, score_mod=_flex_softcap, block_mask=bm, enable_gqa=True)

            t0 = time.perf_counter()
            out = call(k0, v0).transpose(1, 2)
            torch.cuda.synchronize()
            first_s = time.perf_counter() - t0
        except Exception as e:  # noqa: BLE001 - a yardstick that cannot run is reported, not fatal
            errors.append(f"{how}: {type(e).__name__}: {str(e)[:200]}")
            continue
        err, use = flash_check(out, ref)
        if use > 1.0:
            return None, (f"flex_attention ({how}) departs from the plain version: max_abs_err {err:.3g}, "
                          f"{use:.3g} of the tolerance")
        return call, f"flex_attention ({how}; first call {first_s:.2f} s; {use:.3f} of the tolerance)"
    return None, f"flex_attention cannot run on torch {torch.__version__}: " + "; ".join(errors)


def flash_row(gen, name, kv8, shape, card, heads=(H, KV, HD), softcap=0.0, window=0) -> dict:
    """One flash shape, one body: the kernel against the plain version of
    its split schedule and the unsplit one (with the ``reach`` hint and,
    where there is one, without), then its device time from a graph replay
    beside the plain version's, the library call's and both bound forms.
    The library call is SDPA with ``enable_gqa`` on the same boolean mask,
    and with a softcap ``flex_attention`` (:func:`flex_library`), int8
    dequantized first. With a softcap, q is scaled so that the scores reach
    past the cap, and the plain version without the cap must fall outside
    the tolerance (a kernel that skipped the cap would fail). ``shape`` is
    (label, B, S, L, pos0, kv_valid kind, reach hint); ``heads`` (H, KV, D).
    A pos0 of ("verify", lo, hi) is a verify chunk's: per-slot positions
    drawn from [lo, hi] as an int32 [B] tensor the kernel reads on the
    card, each slot's rows [left pad, pos + S) valid (``_grow_valid``),
    and the reach hint the engine passes, max(pos) + S."""
    import torch.nn.functional as F

    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache,
        flash_gqa_cache_reference,
        flash_gqa_cache_split_reference,
    )
    from kakveda_tpu_torch.models.llama import _kv_dequant

    label, b, s, l, pos0, kind, reach = shape
    h, kvh, d = heads
    kv_bytes = b * kvh * l * (2 * (d + 4) if kv8 else 4 * d)
    copies = max(1, math.ceil(2.5 * L2_BYTES / kv_bytes))
    q, k, v, ks, vs, valid = flash_inputs(gen, b, s, l, kind, kv8, copies, heads)
    vec = isinstance(pos0, tuple)
    if vec:  # a verify chunk: per-slot positions on the card
        pos0 = torch.randint(pos0[1], pos0[2] + 1, (b,), device="cuda", generator=gen).to(torch.int32)
        off = torch.randint(10, 17, (b, 1), device="cuda", generator=gen)
        ar = torch.arange(l, device="cuda")
        valid = ((ar >= off) & (ar < pos0[:, None].long() + s)).contiguous()
        reach = int(pos0.max()) + s
    if softcap:  # scores past the cap, so that a kernel skipping it fails the check
        q = (q.float() * SOFTCAP_Q_SCALE).to(torch.bfloat16)
    n_split, live_frac, seen_rows = flash_schedule(b, s, l, pos0, valid, reach, heads, window, kv8)
    # Without the hint, the split count pos0 alone gives (what the
    # engine's decode took before it passed one).
    n_split_bare = flash_schedule(b, s, l, pos0, valid, None, heads, window, kv8)[0]
    opts = dict(window=window, softcap=softcap)

    def args(i):
        i %= copies
        return dict(q=q, k=k[i], v=v[i], pos0=pos0, kv_valid=valid,
                    k_scale=None if ks is None else ks[i], v_scale=None if vs is None else vs[i])

    a = args(0)
    kw = dict(k_scale=a["k_scale"], v_scale=a["v_scale"], **opts)
    err = use = 0.0
    uncapped = None
    for hint, ns in ((reach, n_split), (None, n_split_bare)):
        out = flash_gqa_cache(a["q"], a["k"], a["v"], pos0, valid, reach=hint, **kw)
        torch.cuda.synchronize()
        for ref in (flash_gqa_cache_split_reference(a["q"], a["k"], a["v"], pos0, valid, n_split=ns, **kw),
                    flash_gqa_cache_reference(a["q"], a["k"], a["v"], pos0, valid, **kw)):
            e, u = flash_check(out, ref)
            err, use = max(err, e), max(use, u)
        if not torch.isfinite(out).all() or use > 1.0:
            raise AssertionError(f"{name} {label} (reach {hint}): max |kernel - plain| = {err}, "
                                 f"{use:.3g} of the tolerance (FLASH_REL {FLASH_REL}, FLASH_ATOL {FLASH_ATOL})")
        if kind == "slots" and not torch.equal(out[b - 1], torch.zeros_like(out[b - 1])):
            raise AssertionError(f"{name} {label}: the slot that sees nothing is not zeros")
        if softcap and uncapped is None:
            uncapped = flash_check(out, flash_gqa_cache_reference(a["q"], a["k"], a["v"], pos0, valid,
                                                                  **dict(kw, softcap=0.0)))[1]
            if uncapped <= 1.0:
                raise AssertionError(f"{name} {label}: the plain version without the softcap is within the "
                                     f"tolerance ({uncapped:.3g} of it): the check cannot see the cap")
        if reach is None:
            break

    it = iter(range(1 << 30))

    def kern(hint=reach):
        a = args(next(it))
        flash_gqa_cache(a["q"], a["k"], a["v"], pos0, a["kv_valid"],
                        k_scale=a["k_scale"], v_scale=a["v_scale"], reach=hint, **opts)

    def plain():
        a = args(next(it))
        flash_gqa_cache_reference(a["q"], a["k"], a["v"], pos0, a["kv_valid"],
                                  k_scale=a["k_scale"], v_scale=a["v_scale"], **opts)

    # Yardstick: one library call on the same inputs (int8 dequantized
    # first), q heads-major, the same boolean mask ([B, 1, S, L] at per-slot
    # positions).
    q_pos = (pos0.long()[:, None] if vec else pos0) + torch.arange(s, device="cuda")
    col = torch.arange(l, device="cuda")
    mask = q_pos[..., :, None] >= col
    if window:
        mask &= (q_pos[..., :, None] - col) < window
    mask = mask[:, None] if vec else mask[None, None]
    if valid is not None:
        mask = mask & valid[:, None, None, :]
    qh = q.transpose(1, 2)

    def cache(a):
        if not kv8:
            return a["k"], a["v"]
        return _kv_dequant(a["k"], a["k_scale"], torch.bfloat16), _kv_dequant(a["v"], a["v_scale"], torch.bfloat16)

    lib_how = "SDPA"
    if softcap:
        flex, lib_how = flex_library(q, pos0, valid, window, softcap, l, *cache(a),
                                     flash_gqa_cache_reference(a["q"], a["k"], a["v"], pos0, valid, **kw))

    def lib_call():
        kk, vv = cache(args(next(it)))
        if softcap:
            flex(kk, vv)
        else:
            F.scaled_dot_product_attention(qh, kk, vv, attn_mask=mask, enable_gqa=True)

    ms = graph_ms(kern, n=4 * copies)
    bare = ""
    if reach is not None:  # the same launches without the hint, in the same run
        bare = (f" without the reach hint: n_split={n_split_bare} "
                f"kernel_ms={graph_ms(lambda: kern(None), n=4 * copies):.6f};")
    plain_ms = graph_ms(plain, n=2)
    lib_ms = None
    if not softcap or flex is not None:
        try:
            lib_ms = graph_ms(lib_call, n=4 * copies)
        except Exception as e:  # noqa: BLE001 - a call graph capture refuses: CUDA events around each call
            lib_how += f", timed by events (graph capture: {type(e).__name__})"
            lib_ms = cuda_ms(lib_call, iters=4 * copies, warmup=2)
    call_ms = cuda_ms(kern, iters=50, warmup=5)  # one eager call, wrapper included
    bound_ms, bound_by = flash_bound_ms(b, s, l, kv8, heads=heads)
    seen_ms, _ = flash_bound_ms(b, s, l, kv8, seen_rows, heads=heads)
    lib_txt = f"{lib_ms:.6f}" if lib_ms is not None else "null"
    if vec:
        pos0 = f"per-slot {sorted(pos0.tolist())}"
    log(f"{name} {label} (H={h} KV={kvh} D={d} B={b} S={s} L={l} pos0={pos0} window={window} "
        f"softcap={softcap} reach={reach}): n_split={n_split} live_tiles={live_frac:.4f} "
        f"max_abs_err={err:.3g} ({use:.3f} of the tolerance"
        f"{'' if uncapped is None else f'; the plain version without the cap: {uncapped:.1f} of it'}) "
        f"kernel_ms={ms:.6f};{bare} "
        f"plain_ms={plain_ms:.4f} library_ms={lib_txt} ({lib_how}) "
        f"bound_ms={bound_ms:.6f} ({bound_by}) bound_seen_ms={seen_ms:.6f} "
        f"({seen_rows} of {b * l} rows seen) eager_call_ms={call_ms:.4f} [{card}]")
    del q, k, v, ks, vs
    return dict(shape=f"H={h} KV={kvh} D={d} B={b} S={s} L={l} pos0={pos0} window={window} softcap={softcap}",
                n_split=n_split, live_tiles=live_frac, ms=ms, plain_ms=plain_ms, library_ms=lib_ms, library=lib_how,
                bound_ms=bound_ms, bound_by=bound_by, bound_seen_ms=seen_ms, max_abs_err=err,
                tolerance_share=use, uncapped_share=uncapped)


def phase_flash(card: str) -> dict:
    """Both flash bodies against the plain version at the main path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    judge_shapes = judge_flash_shapes()
    rows = {}
    for kv8 in (False, True):
        name = "flash_gqa_cache_kv8" if kv8 else "flash_gqa_cache"
        row = {"max_abs_err": 0.0}
        for shape in FLASH_SHAPES + judge_shapes:
            r = flash_row(gen, name, kv8, shape, card)
            row["max_abs_err"] = max(row["max_abs_err"], r["max_abs_err"])
            label = shape[0]
            if label == "decode":  # the main path's most frequent shape
                row.update({k: r[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by",
                                              "bound_seen_ms")})
            if label in JUDGE_SHAPES or label.startswith("judge_"):
                b, s, l, pos0 = shape[1:5]
                row.setdefault("judge_shapes", {})[label] = dict(r, shape=f"B={b} S={s} L={l} pos0={pos0}")
        rows[name] = row
    torch.cuda.empty_cache()
    return rows


# Gemma-2-9B's attention (google/gemma-2-9b config.json: 16 heads over 8 KV
# heads of head_dim 256, attn_logit_softcapping 50, sliding_window 4096 on
# even layers) and Phi-3-mini's (microsoft/Phi-3-mini-4k-instruct: 32 heads,
# 32 KV heads, head_dim 96), at phase 14's cache length.
G2_HEADS, P3_HEADS = (16, 8, 256), (32, 32, 96)
G2_SOFTCAP, G2_WINDOW = 50.0, 4096
FAMILY_WINDOW = 8192  # phase 14's KAKVEDA_SERVE_WINDOW and its solo path's cache
FAMILY_FLASH_SHAPES = [
    # (label, heads, softcap, window, (label, B, S, L, pos0, kv_valid, reach hint))
    # Decode under the engine's mask (pos0 = L), slots at rows 4,200-8,191:
    # the even layers' band (rows past slot_pos - 4096 are masked) and the
    # odd layers' full causal rows.
    ("g2_decode_engine_sliding", G2_HEADS, G2_SOFTCAP, 0,
     (8, 1, FAMILY_WINDOW, FAMILY_WINDOW, ("slots_at", 4200, FAMILY_WINDOW, G2_WINDOW), FAMILY_WINDOW)),
    ("g2_decode_engine_full", G2_HEADS, G2_SOFTCAP, 0,
     (8, 1, FAMILY_WINDOW, FAMILY_WINDOW, ("slots_at", 4200, FAMILY_WINDOW, 0), FAMILY_WINDOW)),
    # Phase 14's 4,700-token prompt in DecodeSession's 512-row pieces: the
    # last, past the window (rows from its left pad of 420 on).
    ("g2_prefill_piece_sliding", G2_HEADS, G2_SOFTCAP, G2_WINDOW,
     (1, 512, FAMILY_WINDOW, 4608, ("from", 420, FAMILY_WINDOW), None)),
    ("g2_prefill_piece_full", G2_HEADS, G2_SOFTCAP, 0, (1, 512, FAMILY_WINDOW, 4608, ("from", 420, FAMILY_WINDOW), None)),
    # Phase 14's 4,000-token admission into the engine: bucket 4096 from row
    # 0, left pad 96 (an even layer: the window passes, and masks nothing).
    ("g2_admission_sliding", G2_HEADS, G2_SOFTCAP, G2_WINDOW, (1, 4096, FAMILY_WINDOW, 0, ("from", 96, 4096), None)),
    ("p3_decode_engine", P3_HEADS, 0.0, 0, (8, 1, 4096, 4096, ("slots_at", 1000, 4096, 0), 4096)),
    ("p3_prefill_piece", P3_HEADS, 0.0, 0, (1, 512, 4096, 512, ("from", 100, 4096), None)),
]


def phase_flash_families(card: str) -> dict:
    """Phase 5 at the model families' shapes: Gemma-2-9B's (D = 256, the
    softcap, the window) and Phi-3-mini's (D = 96), both bodies, with the
    resident blocks per SM the split count plans for held against the
    card's occupancy calculator at every head_dim."""
    from kakveda_tpu_torch.models.attention import KERNEL_HEAD_DIMS, _lib, kernel_blocks_per_sm

    blocks = {}
    for d in KERNEL_HEAD_DIMS:
        lib = _lib(d)
        for kv8 in (0, 1):
            for sr in (4, 64):
                planned, granted = kernel_blocks_per_sm(d, kv8, sr), lib.kkv_flash_gqa_cache_blocks_per_sm(d, kv8, sr, 0)
                blocks[f"D{d}_{'int8' if kv8 else 'bf16'}_{'wide' if sr > 16 else 'decode'}"] = [planned, granted]
                if granted < planned:
                    raise AssertionError(f"flash D={d} kv8={kv8} sr={sr}: the split count plans {planned} "
                                         f"blocks per SM, the card grants {granted}")
    log(f"flash blocks per SM [planned, granted by the card]: {json.dumps(blocks)}")
    gen = torch.Generator(device="cuda").manual_seed(14)
    rows = {}
    for kv8 in (False, True):
        name = "flash_gqa_cache_kv8" if kv8 else "flash_gqa_cache"
        for label, heads, cap, window, shape in FAMILY_FLASH_SHAPES:
            rows.setdefault(name, {})[label] = flash_row(
                gen, name, kv8, (label, *shape), card, heads=heads, softcap=cap, window=window)
    torch.cuda.empty_cache()
    return rows


# Phase 15's verify chunks (KAKVEDA_SERVE_SPEC=4: S = 5) and the default
# preset's attention (LlamaConfig(): d_model 256 over 8 heads, 4 KV heads,
# head_dim 32), held and timed in phase 5.
SPEC_K = 4
D32_HEADS = (8, 4, 32)
SPEC_FLASH_SHAPES = [
    # (label, heads, softcap, window, (B, S, L, pos0, kv_valid, reach hint)); a
    # pos0 of ("verify", lo, hi) draws per-slot positions (flash_row).
    ("verify_llama3", (H, KV, HD), 0.0, 0, (8, SPEC_K + 1, 2048, ("verify", 95, 1900), None, None)),
    # Phase 15 a's and c's engines: window 512, positions from the admission
    # bucket (64) to the window's last verify chunk.
    ("verify_llama3_engine", (H, KV, HD), 0.0, 0, (8, SPEC_K + 1, 512, ("verify", 64, 512 - SPEC_K - 1), None, None)),
    ("verify_gemma2", G2_HEADS, G2_SOFTCAP, G2_WINDOW,
     (8, SPEC_K + 1, FAMILY_WINDOW, ("verify", 95, FAMILY_WINDOW - SPEC_K - 1), None, None)),
    ("d32_decode_engine", D32_HEADS, 0.0, 0, (8, 1, 512, 512, "engine", ENGINE_POS + 1)),
    ("verify_d32", D32_HEADS, 0.0, 0, (8, SPEC_K + 1, 512, ("verify", 64, 512 - SPEC_K - 1), None, None)),
    ("d32_prefill_piece", D32_HEADS, 0.0, 0, (1, 512, 1024, 512, ("from", 100, 1024), None)),
]


def phase_flash_spec(card: str) -> dict:
    """Phase 5 at phase 15's shapes: verify chunks at per-slot positions
    (Llama-3-8B's heads at L 2048 and at the engine's window 512;
    Gemma-2-9B's with the softcap and the window) and D = 32 at the default
    preset's heads (decode under the engine's mask, the verify chunk at the
    engine's window, a 512-row prefill piece), both bodies."""
    gen = torch.Generator(device="cuda").manual_seed(15)
    rows = {}
    for kv8 in (False, True):
        name = "flash_gqa_cache_kv8" if kv8 else "flash_gqa_cache"
        for label, heads, cap, window, shape in SPEC_FLASH_SHAPES:
            rows.setdefault(name, {})[label] = flash_row(
                gen, name, kv8, (label, *shape), card, heads=heads, softcap=cap, window=window)
    torch.cuda.empty_cache()
    return rows


# The f32 body (csrc/flash_gqa_cache_f32.cu): max |kernel - plain| within
# F32_ATOL, rtol 0 (f32 sums in another order). q is scaled so that the
# scores are ~N(0, 16): rows sharp enough that the plain version over inputs
# rounded to TF32 (a 10-bit mantissa) or to bf16 falls outside F32_ATOL, the
# control that the tolerance tells f32 from lower precision.
F32_ATOL = 1e-4
F32_Q_SCALE = 4.0
F32_FLASH_SHAPES = [
    # (label, (B, S, L, pos0, kv_valid, reach hint)): decode under the engine's
    # mask (slots at rows 64-2,047), the verify chunk at per-slot positions
    # (S = 5), a 512-row prefill piece; at Llama-3-8B's heads, D 64 and 128.
    ("f32_decode_engine", (8, 1, 2048, 2048, ("slots_at", 64, 2048, 0), 2048)),
    ("f32_verify", (8, SPEC_K + 1, 2048, ("verify", 95, 1900), None, None)),
    ("f32_prefill_piece", (1, 512, 1024, 512, ("from", 100, 1024), None)),
]


# Correctness-only rows of the f32 body at its block plan's edges (16, 32
# or 64 folded rows a block: S*R = 16, 17, 32, 33, 64, 65 and a ragged last
# 64-row block), at D 64 and 128, L <= 1024, among them a softcap, windows,
# per-slot pos0 and n_split > 1: (label, (B, S, H, KV, L, D, pos0, window,
# softcap)), pos0 "verify" for per-slot positions.
F32_EDGE_SHAPES = [
    ("sr16", (4, 4, 32, 8, 1024, 128, 1020, 0, 0.0)),
    ("sr17", (2, 17, 8, 8, 512, 64, 400, 128, 0.0)),
    ("sr32", (8, 8, 32, 8, 1024, 128, "verify", 0, 2.0)),
    ("sr33", (2, 33, 8, 8, 640, 128, 500, 0, 0.0)),
    ("sr64", (2, 16, 16, 4, 1024, 64, 900, 256, 2.0)),
    ("sr65", (1, 65, 8, 8, 1024, 128, 600, 0, 0.0)),
    ("sr200_ragged", (1, 50, 32, 8, 768, 64, 700, 0, 0.0)),
    ("sr20_verify", (4, 5, 32, 8, 1024, 64, "verify", 300, 0.0)),
]


def flash_f32_edges(gen) -> dict:
    """F32_EDGE_SHAPES through the f32 body, each held within F32_ATOL (rtol
    0) of both plain versions; no timing."""
    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache,
        flash_gqa_cache_reference,
        flash_gqa_cache_split_reference,
    )

    rows = {}
    for label, (b, s, h, kvh, l, d, pos0, window, cap) in F32_EDGE_SHAPES:
        q = torch.randn(b, s, h, d, device="cuda", generator=gen) * F32_Q_SCALE
        k = torch.randn(b, kvh, l, d, device="cuda", generator=gen)
        v = torch.randn(b, kvh, l, d, device="cuda", generator=gen)
        ar = torch.arange(l, device="cuda")
        if pos0 == "verify":
            pos0 = torch.randint(l // 8, l - s + 1, (b,), device="cuda", generator=gen).to(torch.int32)
            off = torch.randint(0, 17, (b, 1), device="cuda", generator=gen)
            valid = ((ar >= off) & (ar < pos0[:, None].long() + s)).contiguous()
            reach = int(pos0.max()) + s
        else:
            valid = (ar >= 13).expand(b, l).contiguous()
            reach = None
        n_split = flash_schedule(b, s, l, pos0, valid, reach, (h, kvh, d), window, f32=True)[0]
        before = flash_gqa_cache.launches_f32
        out = flash_gqa_cache(q, k, v, pos0, valid, reach=reach, window=window, softcap=cap)
        torch.cuda.synchronize()
        kw = dict(window=window, softcap=cap)
        err = max((out - flash_gqa_cache_reference(q, k, v, pos0, valid, **kw)).abs().max().item(),
                  (out - flash_gqa_cache_split_reference(q, k, v, pos0, valid, n_split=n_split, **kw))
                  .abs().max().item())
        if flash_gqa_cache.launches_f32 != before + 1 or not torch.isfinite(out).all() or err > F32_ATOL:
            raise AssertionError(f"flash f32 edge {label} D={d}: max |kernel - plain| = {err} > {F32_ATOL} "
                                 f"or launches {before} -> {flash_gqa_cache.launches_f32}")
        sr = s * (h // kvh)
        rows[f"D{d}_edge_{label}"] = dict(sr=sr, n_split=n_split, max_abs_err=err)
        log(f"flash_gqa_cache_f32 edge {label} (S*R={sr} D={d} B={b} L={l} window={window} softcap={cap}): "
            f"n_split={n_split} max_abs_err={err:.3g} (F32_ATOL {F32_ATOL}, rtol 0)")
    return rows


def round_mantissa(x, bits: int):
    """``x`` (f32) rounded to ``bits`` explicit mantissa bits: 10 is TF32, 7 bf16."""
    i = x.contiguous().view(torch.int32)
    drop = 23 - bits
    return ((i + (1 << (drop - 1))) & ~((1 << drop) - 1)).view(torch.float32)


def flash_f32_row(gen, label, d, shape, card) -> dict:
    """One shape of the f32 body: the kernel against the plain version of
    its split schedule and the unsplit one within F32_ATOL (rtol 0), the
    TF32 / bf16 control outside it, then its device time from a graph
    replay beside its bound (f32: 4 bytes an element, the K/V of the cache
    rows some query sees and the flops of the scores the mask keeps, at the
    tensor cores' 3xTF32 rate, 495 / 3 TFLOP/s; logged beside it the 67
    TFLOP/s FFMA figure and the bound over every row and score of the
    rectangle), the plain version's time and SDPA's in f32 with the boolean
    mask."""
    import torch.nn.functional as F

    from kakveda_tpu_torch.models.attention import (
        flash_gqa_cache,
        flash_gqa_cache_reference,
        flash_gqa_cache_split_reference,
    )

    b, s, l, pos0, kind, reach = shape
    heads = (H, KV, d)
    copies = max(1, math.ceil(2.5 * L2_BYTES / (b * KV * l * 8 * d)))
    q, k, v, _, _, valid = flash_inputs(gen, b, s, l, kind, False, copies, heads, dtype=torch.float32)
    q = q * F32_Q_SCALE
    vec = isinstance(pos0, tuple)
    if vec:
        pos0 = torch.randint(pos0[1], pos0[2] + 1, (b,), device="cuda", generator=gen).to(torch.int32)
        off = torch.randint(10, 17, (b, 1), device="cuda", generator=gen)
        ar = torch.arange(l, device="cuda")
        valid = ((ar >= off) & (ar < pos0[:, None].long() + s)).contiguous()
        reach = int(pos0.max()) + s
    n_split, live_frac, seen_rows = flash_schedule(b, s, l, pos0, valid, reach, heads, f32=True)
    before = (flash_gqa_cache.launches, flash_gqa_cache.launches_kv8, flash_gqa_cache.launches_f32)
    out = flash_gqa_cache(q, k[0], v[0], pos0, valid, reach=reach)
    torch.cuda.synchronize()
    after = (flash_gqa_cache.launches, flash_gqa_cache.launches_kv8, flash_gqa_cache.launches_f32)
    if after != (before[0], before[1], before[2] + 1) or out.dtype != torch.float32:
        raise AssertionError(f"f32 {label} D={d}: counters {before} -> {after}, out {out.dtype}")
    ref = flash_gqa_cache_reference(q, k[0], v[0], pos0, valid)
    split = flash_gqa_cache_split_reference(q, k[0], v[0], pos0, valid, n_split=n_split)
    err = max((out - ref).abs().max().item(), (out - split).abs().max().item())
    if not torch.isfinite(out).all() or err > F32_ATOL:
        raise AssertionError(f"flash f32 {label} D={d}: max |kernel - plain| = {err} > {F32_ATOL}")
    control = {}
    for bits, name in ((10, "tf32"), (7, "bf16")):
        lo = flash_gqa_cache_reference(*(round_mantissa(x, bits) for x in (q, k[0], v[0])), pos0, valid)
        control[name] = (lo - ref).abs().max().item()
        if control[name] <= F32_ATOL:
            raise AssertionError(f"flash f32 {label} D={d}: inputs rounded to {name} give {control[name]} <= "
                                 f"{F32_ATOL}: the tolerance cannot tell f32 from {name}")
    it = iter(range(1 << 30))
    q_pos = (pos0.long()[:, None] if vec else pos0) + torch.arange(s, device="cuda")
    mask = q_pos[..., :, None] >= torch.arange(l, device="cuda")
    mask = (mask[:, None] if vec else mask[None, None]) & valid[:, None, None, :]
    qh = q.transpose(1, 2)

    def kern():
        i = next(it) % copies
        flash_gqa_cache(q, k[i], v[i], pos0, valid, reach=reach)

    def plain():
        i = next(it) % copies
        flash_gqa_cache_reference(q, k[i], v[i], pos0, valid)

    def lib():
        i = next(it) % copies
        F.scaled_dot_product_attention(qh, k[i], v[i], attn_mask=mask, enable_gqa=True)

    ms = graph_ms(kern, n=4 * copies)
    plain_ms = graph_ms(plain, n=2)
    lib_ms = graph_ms(lib, n=4 * copies)
    kept = int(mask.expand(b, 1, s, l).sum())
    bound_ms, bound_by = flash_bound_ms(b, s, l, False, seen_rows, heads, 4, TF32X3_FLOP_PER_S, kept)
    ffma_ms, ffma_by = flash_bound_ms(b, s, l, False, seen_rows, heads, 4, F32_FLOP_PER_S, kept)
    all_ms, _ = flash_bound_ms(b, s, l, False, heads=heads, eb=4, flop_rate=TF32X3_FLOP_PER_S)
    shown = f"per-slot {sorted(pos0.tolist())}" if vec else pos0
    log(f"flash_gqa_cache_f32 {label} (H={H} KV={KV} D={d} B={b} S={s} L={l} pos0={shown} reach={reach}): "
        f"n_split={n_split} live_tiles={live_frac:.4f} max_abs_err={err:.3g} (F32_ATOL {F32_ATOL}, rtol 0; the plain "
        f"version over TF32-rounded inputs {control['tf32']:.3g}, bf16-rounded {control['bf16']:.3g}) "
        f"kernel_ms={ms:.6f} plain_ms={plain_ms:.4f} library_ms={lib_ms:.6f} (SDPA f32) bound_ms={bound_ms:.6f} "
        f"({bound_by}, 3xTF32 at 165 TFLOP/s; {seen_rows} of {b * l} rows seen, {kept} of {b * s * l} scores kept) "
        f"bound_ffma_ms={ffma_ms:.6f} ({ffma_by}, FFMA at 67 TFLOP/s) bound_all_ms={all_ms:.6f} (every row and "
        f"score) [{card}]")
    del q, k, v
    return dict(shape=f"H={H} KV={KV} D={d} B={b} S={s} L={l}", n_split=n_split, live_tiles=live_frac, ms=ms,
                plain_ms=plain_ms, library_ms=lib_ms, library="SDPA f32", bound_ms=bound_ms, bound_by=bound_by,
                bound_all_ms=all_ms, bound_ffma_ms=ffma_ms, max_abs_err=err, control=control)


def phase_flash_f32(card: str) -> dict:
    """Phase 5 at f32: the f32 body at D 64 and 128, the three shapes of
    F32_FLASH_SHAPES, the correctness-only rows of F32_EDGE_SHAPES, and the
    blocks per SM its split count plans against the card's occupancy
    calculator at each block size (16, 32 and 64 rows)."""
    from kakveda_tpu_torch.models.attention import KERNEL_F32_HEAD_DIMS, _lib, kernel_blocks_per_sm, kernel_f32_q_rows

    blocks = {}
    for d in KERNEL_F32_HEAD_DIMS:
        for sr in (4, 20, 64):
            planned = kernel_blocks_per_sm(d, False, sr, f32=True)
            granted = _lib(d, f32=True).kkv_flash_gqa_cache_blocks_per_sm(d, 0, sr, 0)
            blocks[f"D{d}_f32_q{kernel_f32_q_rows(sr)}"] = [planned, granted]
            if granted < planned:
                raise AssertionError(f"flash f32 D={d} sr={sr}: planned {planned} blocks per SM, granted {granted}")
    log(f"flash f32 blocks per SM [planned, granted by the card]: {json.dumps(blocks)}")
    gen = torch.Generator(device="cuda").manual_seed(16)
    rows = {f"D{d}_{label}": flash_f32_row(gen, label, d, shape, card)
            for d in KERNEL_F32_HEAD_DIMS for label, shape in F32_FLASH_SHAPES}
    rows.update(flash_f32_edges(gen))
    torch.cuda.empty_cache()
    return rows


class RecordingTokenizer:
    """The byte tokenizer, remembering the ids each ``decode`` was given, so
    the tokens behind ``generate_batch``'s texts can be checked."""

    def __init__(self):
        from kakveda_tpu_torch.models.tokenizer import ByteTokenizer

        self._tok = ByteTokenizer()
        self.PAD, self.BOS, self.EOS = self._tok.PAD, self._tok.BOS, self._tok.EOS
        self.vocab_size = self._tok.vocab_size
        self.decoded = []

    def encode(self, text, **kw):
        return self._tok.encode(text, **kw)

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self._tok.decode(ids)


PROMPTS = [  # 8 distinct prompts of 48-52 tokens: one admission bucket of 64
    f"Incident {i}: the {what} failed; summarize why."
    for i, what in enumerate(
        ["checkout API", "search index", "login flow", "payments batch",
         "image resizer", "mail relay", "audit export", "cache warmer"]
    )
]


class RouterTrace:
    """While on, records each ``moe.router_topk`` call of ``moe_mlp``: the
    experts chosen, copied to the host (a sync: used only around the passes
    that check, never on a timed path)."""

    def __init__(self):
        from kakveda_tpu_torch.models import moe

        self._moe = moe
        self.calls = []

    @contextlib.contextmanager
    def on(self):
        real = self._moe.router_topk
        self.calls = []

        def traced(logits, k):
            res = real(logits, k)
            self.calls.append(res[1].cpu())
            return res

        self._moe.router_topk = traced
        try:
            yield self.calls
        finally:
            self._moe.router_topk = real

    def table(self):
        """The last traced pass's choices: ``{token: {layer: experts}}``."""
        routes = {}
        for layer, idx in enumerate(self.calls):
            for n, experts in enumerate(idx.tolist()):
                routes.setdefault(n, {})[layer] = tuple(experts)
        return routes


def first_steps(params, cfg, ids, tok, pin=None):
    """Each prompt's first-step logits (the tokenizer's vocab, float64) from
    one solo pass over it, with its expert choices ``{token: {layer:
    experts}}``; or, given ``pin`` (another run's choices per prompt), each
    token's experts pinned to them and the choices where this pass's own
    top k differs (``pinned_forced``)."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    trace, out = RouterTrace(), []
    for i, p_ids in enumerate(ids):
        if pin is None:
            cache = init_cache(cfg, batch=1, max_len=len(p_ids), device="cuda")
            with trace.on():
                logits, _ = decode_step(params, cfg, torch.tensor([p_ids], device="cuda"), cache,
                                        last_only=True)
            lg, extra = logits[0, -1], trace.table()
        else:
            logits, extra = pinned_forced(params, cfg, p_ids, pin[i])
            lg = logits[-1]
        lg = mask_pad_vocab(lg, cfg)[: tok.vocab_size].double()
        if not torch.isfinite(lg).all():
            raise AssertionError("non-finite first-step logits")
        out.append((lg, extra))
    return out


def hold_cosine(ref, other, what: str) -> dict:
    """First-step logits of two runs of each prompt, the second's expert
    choices pinned to the first's (``first_steps``): cosine ≥ INT8_COS_MIN
    for every prompt, and every expert choice where the second run's own
    router differs from the pin lies across a gap under MARGIN_TOL. Pinned,
    because an expert choice on a router near-tie may flip under the
    perturbation and move the logits by design, and flips at other tokens
    and layers compound through the cache."""
    cos = [torch.nn.functional.cosine_similarity(la, lb, dim=0).item() for (la, _), (lb, _) in zip(ref, other)]
    flips = [f for _, fl in other for f in fl]
    worst = max((g for _, _, g in flips), default=0.0)
    n_choices = sum(len(t) * len(t[0]) for _, t in ref if t)
    log(f"{what}: first-step logits cosine min {min(cos):.6f} over {len(cos)} prompts (bound "
        f"{INT8_COS_MIN}); {len(flips)} of {n_choices} expert choices differ from the reference's, the "
        f"widest across a router gap of {worst:.4f} (bound {MARGIN_TOL})")
    if min(cos) < INT8_COS_MIN or worst >= MARGIN_TOL:
        raise AssertionError(f"{what}: cosine {cos}, expert flip across a router gap of {worst}")
    return dict(cos_min=min(cos), expert_flips=len(flips), expert_choices=n_choices, widest_flip_gap=worst)


def param_bytes(params) -> int:
    leaves = [params["embed"], params["final_norm"], params["lm_head"]]
    leaves += [w for layer in params["layers"] for w in layer.values()]
    flat = [t for w in leaves for t in (w.values() if isinstance(w, dict) else [w])]
    return sum(t.numel() * t.element_size() for t in flat)


def serve_engine(rt, tok, ids, what: str) -> dict:
    """The model plane's engine runs and checks (phases 6 and 9): ``rt``'s
    weights serve ``generate_batch`` of 8 prompts × 32 tokens through the
    engine (8 slots, window 512, chunk 8), once with a bf16 cache and once
    with ``KAKVEDA_KV_QUANT=int8``, launch counts zeroed just before and read
    just after each run: the run's kernel launches 32 × (forward passes)
    times, the other kernel 0. Then the tokens (``check_dense_tokens`` or,
    for a MoE model, ``check_moe_tokens``) and the two caches' first-step
    logits (``hold_cosine``)."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    cfg = rt.cfg
    out, first = {}, {}
    for kvq in ("", "int8"):
        tag = kvq or "bf16"
        rq = rt
        if kvq:
            os.environ["KAKVEDA_KV_QUANT"] = kvq
            try:
                rq = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok)
            finally:
                del os.environ["KAKVEDA_KV_QUANT"]
        if rq.cfg.kv_quant != kvq:
            raise AssertionError(f"KAKVEDA_KV_QUANT={kvq!r} gave a {rq.cfg.kv_quant!r} cache")
        eng = rq.engine()
        if (eng.cb.B, eng.cb.max_len, eng.cb.chunk_steps) != (8, 512, 8):
            raise AssertionError("engine is not 8 slots, window 512, chunk 8")
        rq.generate_batch(PROMPTS[:2], max_tokens=8)  # warm-up: cuBLAS heuristics, allocator
        tok.decoded.clear()
        routes = EngineRoutes(eng.cb)
        flash_gqa_cache.launches = 0
        flash_gqa_cache.launches_kv8 = 0
        f0 = eng.cb.forwards
        with routes.on() if cfg.n_experts else contextlib.nullcontext():
            t = time.perf_counter()
            res = rq.generate_batch(PROMPTS, max_tokens=32)
            wall = time.perf_counter() - t
        n_fwd = eng.cb.forwards - f0
        mine, other = flash_gqa_cache.launches, flash_gqa_cache.launches_kv8
        if kvq:
            mine, other = other, mine
        got = list(tok.decoded)
        rq.close()
        if mine != cfg.n_layers * n_fwd or other != 0:
            raise AssertionError(f"{what} {tag}: {mine} launches for {n_fwd} forwards (want {cfg.n_layers} "
                                 f"each), {other} of the other kernel")
        if len(res) != 8 or not all(r.meta.get("continuous") for r in res) or len(got) != 8:
            raise AssertionError(f"{what} {tag}: generate_batch did not run through the engine")
        n_tok = sum(len(g) for g in got)
        out[tag] = dict(launches=mine, forwards=n_fwd, tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                        ids=got)
        if cfg.n_experts:
            out[tag].update(check_moe_tokens(rq, tok, ids, got, routes, f"{what}, {tag} cache"))
        else:
            out[tag].update(check_dense_tokens(rq, tok, ids, got, f"{what}, {tag} cache"))
        pin = [t for _, t in first["bf16"]] if kvq else None
        first[tag] = first_steps(rq.params, rq.cfg, ids, tok, pin=pin)
        log(f"{what}, {tag} cache: {n_fwd} forwards, {mine} launches")
    out["kv_cache_cos"] = hold_cosine(first["bf16"], first["int8"], f"{what}, int8 cache vs bf16 cache")
    return out


def check_dense_tokens(rq, tok, ids, got, what: str) -> dict:
    """Each prompt's engine tokens equal a solo ``generate_tokens`` up to the
    first step whose solo top-2 logit margin is below MARGIN_TOL (bf16 noise
    between batch shapes can flip a nearer tie), and every engine token lies
    within MARGIN_TOL of the solo argmax on the engine's own prefix (one
    teacher-forced pass, so all 32 steps are checked)."""
    from kakveda_tpu_torch.models.generate import generate_tokens
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    def forced(p_ids, toks):
        """Solo logits [len(toks) + 1, V] along prompt + toks, one pass."""
        seq = torch.tensor([p_ids + toks], device="cuda")
        cache = init_cache(rq.cfg, batch=1, max_len=seq.shape[1], device="cuda")
        logits, _ = decode_step(rq.params, rq.cfg, seq, cache)
        lg = mask_pad_vocab(logits[0, len(p_ids) - 1:], rq.cfg)
        if not torch.isfinite(lg[:, : tok.vocab_size]).all():
            raise AssertionError(f"{what}: non-finite logits")
        return lg

    compared, deficit = [], 0.0
    for p_ids, eng_ids in zip(ids, got):
        solo = generate_tokens(rq.params, rq.cfg, p_ids, max_new_tokens=32, eos_id=tok.EOS)
        top2 = forced(p_ids, solo).topk(2, dim=-1).values
        margin = (top2[:, 0] - top2[:, 1]).tolist()
        n = min(len(solo), next((j for j, m in enumerate(margin) if m < MARGIN_TOL), len(solo)))
        if eng_ids[:n] != solo[:n]:
            raise AssertionError(f"{what}: engine {eng_ids[:n]} != solo {solo[:n]} within {n} steps")
        compared.append(n)
        picks = eng_ids + ([tok.EOS] if len(eng_ids) < 32 else [])
        lg = forced(p_ids, eng_ids)[: len(picks)]
        d = lg.max(dim=-1).values - lg[torch.arange(len(picks)), torch.tensor(picks)]
        deficit = max(deficit, d.max().item())
        if deficit > MARGIN_TOL:
            raise AssertionError(f"{what}: an engine token is {deficit} below the solo argmax")
    log(f"{what}: engine == solo generate_tokens on {sum(compared)} of {sum(map(len, got))} tokens "
        f"(per prompt {compared}); every engine token within {deficit:.4f} of the solo argmax "
        f"on its own prefix")
    return dict(compared=sum(compared), max_deficit=deficit)


def check_moe_tokens(rq, tok, ids, got, routes, what: str) -> dict:
    """A MoE model's tokens. Its expert choices are discrete: bf16 noise
    between the engine's batch shapes and a solo pass's flips a choice that
    sits on a router near-tie, and the logits jump with it, so phase 6's
    token rules are held on the engine's own choices. One teacher-forced
    solo pass per prompt along the engine's tokens, each token's experts
    pinned to the ones the engine chose (``pinned_forced``): every expert
    choice of the engine that differs from the solo pass's own lies across
    a router gap under MARGIN_TOL; every engine token (and its EOS stop) lies
    within MARGIN_TOL of the solo argmax, and equals it wherever the solo
    top-2 margin is MARGIN_TOL or more."""
    from kakveda_tpu_torch.models.llama import mask_pad_vocab

    table = routes.table()
    rids = routes.admitted
    if len(rids) != len(ids):
        raise AssertionError(f"{what}: {len(rids)} admissions for {len(ids)} prompts")
    compared, deficit, flips = 0, 0.0, []
    for p_ids, eng_ids, rid in zip(ids, got, rids):
        logits, pflips = pinned_forced(rq.params, rq.cfg, p_ids + eng_ids, table[rid])
        flips += pflips
        picks = eng_ids + ([tok.EOS] if len(eng_ids) < 32 else [])
        lg = mask_pad_vocab(logits[len(p_ids) - 1:], rq.cfg)[: len(picks)]
        if not torch.isfinite(lg[:, : tok.vocab_size]).all():
            raise AssertionError(f"{what}: non-finite logits")
        top2 = lg.topk(2, dim=-1)
        sure = (top2.values[:, 0] - top2.values[:, 1] >= MARGIN_TOL).cpu()
        pick = torch.tensor(picks)
        if not torch.equal(top2.indices[:, 0].cpu()[sure], pick[sure]):
            raise AssertionError(f"{what}: an engine token differs from a clear solo argmax")
        compared += int(sure.sum())
        d = lg.max(dim=-1).values - lg[torch.arange(len(picks)), pick.to(lg.device)]
        deficit = max(deficit, d.max().item())
    worst = max((g for _, _, g in flips), default=0.0)
    n_choices = sum(len(p) + len(e) for p, e in zip(ids, got)) * rq.cfg.n_layers
    log(f"{what}: on the engine's expert choices, engine == solo argmax on {compared} of "
        f"{sum(map(len, got))} tokens (every solo margin >= {MARGIN_TOL}), every engine token within "
        f"{deficit:.4f} of the solo argmax; {len(flips)} of {n_choices} engine expert choices differ "
        f"from the solo pass's own, the widest across a router gap of {worst:.4f} (bound {MARGIN_TOL})")
    if deficit > MARGIN_TOL or worst >= MARGIN_TOL:
        raise AssertionError(f"{what}: deficit {deficit}, expert flip across a router gap of {worst}")
    return dict(compared=compared, max_deficit=deficit, expert_flips=len(flips), expert_choices=n_choices,
                widest_flip_gap=worst)


class EngineRoutes:
    """While on, records the experts the engine chose for every request's
    tokens, per layer (device copies, read after the run): ``admit`` and
    ``step_async`` are wrapped on the batcher to note which request and
    token each row of a forward holds. ``table()`` gives ``{request id:
    {token index: [experts per layer]}}`` and the admitted request ids."""

    def __init__(self, cb):
        from kakveda_tpu_torch.models import moe, serving

        self._moe, self._serving, self._cb = moe, serving, cb
        self.calls, self.admitted = [], []

    @contextlib.contextmanager
    def on(self):
        moe, serving, cb = self._moe, self._serving, self._cb
        real_topk, real_fw = moe.router_topk, serving._forward_wide
        real_admit, real_step = cb.admit, cb.step_async
        ctx = {"rows": None, "layer": 0}

        def topk(logits, k):
            res = real_topk(logits, k)
            if ctx["rows"] is not None:
                self.calls.append((ctx["rows"], ctx["layer"], res[1].clone()))
                ctx["layer"] += 1
            return res

        def admit(prompt_ids, max_new_tokens=64, temperature=0.0, on_tokens=None):
            p = len(prompt_ids)
            off = cb.bucket_for(p, cb.max_len) - p
            self.admitted.append(cb._next_id)
            ctx.update(rows=[None] * off + [(cb._next_id, n) for n in range(p)], layer=0)
            try:
                return real_admit(prompt_ids, max_new_tokens, temperature, on_tokens)
            finally:
                ctx["rows"] = None

        def step_async():
            live = {slot: st.req_id for slot, st in cb.slots.items() if not st.done}
            pos, off, step = cb._pos_np.copy(), cb._off_np.copy(), [0]

            def forward(*a, **k):  # step t writes row pos + t: token pos + t - off
                ctx.update(rows=[(live[b], int(pos[b] + step[0] - off[b])) if b in live else None
                                 for b in range(cb.B)], layer=0)
                step[0] += 1
                try:
                    return real_fw(*a, **k)
                finally:
                    ctx["rows"] = None

            serving._forward_wide = forward
            try:
                return real_step()
            finally:
                serving._forward_wide = real_fw

        moe.router_topk, cb.admit, cb.step_async = topk, admit, step_async
        try:
            yield self
        finally:
            moe.router_topk = real_topk
            del cb.admit, cb.step_async

    def table(self):
        routes = {}
        for rows, layer, idx in self.calls:
            for key, experts in zip(rows, idx.cpu().tolist()):
                if key is not None:
                    routes.setdefault(key[0], {}).setdefault(key[1], {})[layer] = tuple(experts)
        return routes


def pinned_forced(params, cfg, seq_ids, routes):
    """Solo logits [len(seq_ids), V] along ``seq_ids`` in one pass, each
    token's experts pinned to ``routes[n][layer]`` (the engine's), their
    weights from this pass's own router probabilities. Returns (logits,
    expert choices where this pass's own top k differs from the pin: a list
    of (token, layer, own router gap between its k-th and (k+1)-th
    logits))."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.llama import decode_step, init_cache

    real, k, layer, flips = moe.router_topk, cfg.n_experts_per_tok, [0], []
    s = len(seq_ids)

    def pinned(logits, k_):
        li = layer[0]
        layer[0] += 1
        _, own, probs = real(logits, k_)
        pin = torch.tensor([routes[n][li] for n in range(s)], device=logits.device)
        top = logits.float().sort(dim=-1, descending=True).values
        gap = (top[:, k - 1] - top[:, k]).cpu()
        differ = (own.sort(dim=-1).values != pin.sort(dim=-1).values).any(dim=-1).cpu()
        flips.extend((n, li, gap[n].item()) for n in differ.nonzero()[:, 0].tolist())
        w = probs.gather(1, pin)
        return w / w.sum(dim=-1, keepdim=True).clamp_min(1e-20), pin, probs

    moe.router_topk = pinned
    try:
        cache = init_cache(cfg, batch=1, max_len=s, device="cuda")
        logits, _ = decode_step(params, cfg, torch.tensor([seq_ids], device="cuda"), cache)
    finally:
        moe.router_topk = real
    return logits[0], flips


def step_times(rt, ids, out: dict, n_bytes: int, what: str, card: str, split=None, max_len: int = 512,
               caches=(("", "bf16"), ("int8", "int8"))) -> None:
    """Admission and decode-step times on a batcher of the engine's shape
    (8 slots, window ``max_len``), per cache type (``caches``: the
    ``kv_quant`` and its key in ``out``), into ``out``: admission
    p50 and decode step p50 on the host clock, the step's device time from
    a CUDA graph of ``_forward_wide`` (with the engine's ``reach`` hint)
    beside the weight-read bound (``n_bytes``, the weights a step reads);
    ``split(cb, dev_args, reach, step_ms)`` breaks the bf16-cache step up."""
    from kakveda_tpu_torch.models.serving import ContinuousBatcher, _forward_wide

    for kvq, tag in caches:
        cb = ContinuousBatcher(rt.params, dataclasses.replace(rt.cfg, kv_quant=kvq),
                               batch_slots=8, max_len=max_len, chunk_steps=8, eos_id=None)
        adm = []
        for p_ids in ids:
            torch.cuda.synchronize()
            t = time.perf_counter()
            cb.admit(p_ids, max_new_tokens=400)
            torch.cuda.synchronize()
            adm.append((time.perf_counter() - t) * 1e3)
        cb.step()  # warm
        steps = []
        for _ in range(6):
            t = time.perf_counter()
            cb.step()  # ends in the tokens' device->host copy
            steps.append((time.perf_counter() - t) * 1e3 / cb.chunk_steps)
        if cb.active != 8:
            raise AssertionError("a slot retired early")
        # The same step's device time, its launches replayed from a graph.
        dev_args = (torch.zeros((8, 1), dtype=torch.long, device="cuda"),
                    torch.from_numpy(cb._pos_np.copy()).to("cuda"),
                    torch.from_numpy(cb._kv_np.copy()).to("cuda"),
                    torch.from_numpy(cb._off_np.copy()).to("cuda"))
        reach = int(cb._pos_np.max()) + 1  # the hint step_async passes
        step_dev = graph_ms(lambda: _forward_wide(cb.params, cb.cfg, cb.cache, *dev_args, reach=reach),
                            n=4 if split is None else 1)
        weight_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        out[tag].update(admission_ms_p50=statistics.median(adm), decode_step_ms_p50=statistics.median(steps),
                        decode_step_device_ms=step_dev, weight_read_bound_ms=weight_ms)
        log(f"{what}, {tag} cache: admission p50 {statistics.median(adm):.2f} ms (B=1, S=64), decode step p50 "
            f"{statistics.median(steps):.2f} ms at 8 slots (device time {step_dev:.2f} ms) vs the "
            f"weight-read bound {weight_ms:.2f} ms, engine {out[tag]['tokens_per_s']:.1f} tokens/s [{card}]")
        if split is not None and not kvq:
            out[tag]["step_split"] = split(cb, dev_args, reach, step_dev)
        del cb
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phase 13: the engine's request lifecycle on the card (inside phase 6's
# model lifetime, on its weights)
# ---------------------------------------------------------------------------

STREAMS = 64  # concurrent generate_stream consumers in a and b
STREAM_TOKENS = 64
LONG_TOKENS = 400  # c's requests: bucket 64 + 400 + 1 fits the 512 window
# c's deadline: after 8 one-at-a-time admissions (each waits for a chunk
# boundary: 2-2.5 s for the eight at 32 layers, about half at 16, more on a
# slow host), before 400 tokens (5.4-8 s at 8 slots and 16 layers: 376 of
# them came by 6 s on a fast host). It was 4 s at 16 layers, where 152-184
# tokens came by it; at LLAMA3_LAYERS = 12, 4 s let 168-312 come, so 3 s
# keeps both margins where 16 layers had them. Set it anew with the depth.
DEADLINE_S = 3.0


class StreamTokenizer(RecordingTokenizer):
    """The byte tokenizer remembering, per thread, the ids of its last
    ``decode``: a stream's last delta decodes all of its tokens, so each
    consumer's tokens can be read back for the near-tie rule."""

    def __init__(self):
        super().__init__()
        self.last = {}

    def decode(self, ids):
        self.last[threading.get_ident()] = list(ids)
        return self._tok.decode(ids)


def outcome_counts(engine: str) -> dict:
    """``kakveda_serving_requests_total`` by outcome for one engine label,
    read from the port's registry."""
    from kakveda_tpu_torch.core import metrics

    fam = metrics.get_registry().counter(
        "kakveda_serving_requests_total", "Serving requests by outcome", ("engine", "outcome"))
    return {key[1]: int(child.value) for key, child in fam._series() if key[0] == engine}


def run_streams(rt, prompts, close_after_first=frozenset()):
    """One ``generate_stream`` consumer thread per prompt, all released
    together: per stream its submit-to-first-delta time, the gaps between
    its deltas, its text and (from the tokenizer) its tokens; a stream in
    ``close_after_first`` is closed at its first delta, with the time and
    the engine's chunk count at the close. Returns (streams, wall)."""
    eng = rt.engine()
    res = [None] * len(prompts)
    gate = threading.Barrier(len(prompts) + 1)

    def consume(i):
        gate.wait()
        t0 = time.perf_counter()
        times, parts = [], []
        gen = rt.generate_stream(prompts[i], max_tokens=STREAM_TOKENS)
        r = {}
        try:
            for d in gen:
                times.append(time.perf_counter())
                parts.append(d)
                if i in close_after_first:
                    r["chunks_at_close"] = eng.stats()["chunks"]
                    gen.close()
                    r["t_close"] = time.perf_counter()
                    break
        except BaseException as e:  # noqa: BLE001 — reported by the caller
            r["error"] = e
        r.update(t0=t0, times=times, text="".join(parts), ids=rt.tokenizer.last.get(threading.get_ident(), []))
        res[i] = r

    threads = [threading.Thread(target=consume, args=(i,)) for i in range(len(prompts))]
    for t in threads:
        t.start()
    gate.wait()
    t = time.perf_counter()
    for th in threads:
        th.join(timeout=600)
        if th.is_alive():
            raise AssertionError("phase 13: a stream consumer hung")
    wall = time.perf_counter() - t
    for i, r in enumerate(res):
        if "error" in r:
            raise AssertionError(f"phase 13: stream {i} failed: {type(r['error']).__name__}: {r['error']}")
    return res, wall


def hold_streams(rq, tok, prompt_ids, ref, items, what: str) -> dict:
    """Each stream's text equals the reference's for its prompt, or its
    tokens depart from the reference's at a near-tie (``margin_rule``):
    the engine's rows run in another split schedule as other slots' rows
    grow (the kernel's ``reach``), and bf16 sums in another order may flip
    a nearer tie. ``items``: (prompt index, stream) pairs."""
    equal, ties = 0, []
    for j, s in items:
        if s["text"] == ref[j][0]:
            equal += 1
            continue
        m = margin_rule(rq.params, rq.cfg, tok, prompt_ids[j], ref[j][1], s["ids"], f"{what}, prompt {j}")
        ties.append(0.0 if m is None else m)
    log(f"{what}: {equal} of {len(items)} streams equal generate's text; {len(ties)} depart at a "
        f"near-tie (solo margins {[round(m, 4) for m in ties]})")
    return dict(equal=equal, near_tie=len(ties))


def phase_lifecycle(rt, model_out: dict, card: str) -> dict:
    """Phase 13 on phase 6's Llama-3-8B weights (8 slots, window 512,
    chunk 8): a. 64 concurrent streams; b. cancel mid-decode and while
    queued; c. deadlines; d. the supervisor on the int8 cache; e. top-p at
    the full vocabulary; f. ``/metrics`` and ``/flightrecorder``."""
    from concurrent.futures import CancelledError

    from kakveda_tpu_torch.core import faults
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime, _sample_top_p, top_p_keep
    from kakveda_tpu_torch.models.serving import (
        DeadlineExceededError,
        EngineDeadError,
        EngineRetryableError,
        ServingEngine,
    )

    cfg, out, tally = rt.cfg, {}, {}
    tok = StreamTokenizer()
    name = "llama3-8b-phase13"
    rq = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok, model_label=name, device=rt.device)
    # b holds 64 streams, their 16 cancels and 4 more requests in the
    # engine's backlog at once: past the default bound of 64 it would shed.
    os.environ["KAKVEDA_ADMIT_QUEUE"] = "128"
    try:
        eng = rq.engine()
    finally:
        del os.environ["KAKVEDA_ADMIT_QUEUE"]
    if (eng.cb.B, eng.cb.max_len, eng.cb.chunk_steps) != (8, 512, 8):
        raise AssertionError("phase 13: the engine is not 8 slots, window 512, chunk 8")
    ids = [tok.encode(p) for p in PROMPTS]
    ref = []
    for p in PROMPTS:  # generate's text and tokens per prompt, each alone in the engine
        r = rq.generate(p, max_tokens=STREAM_TOKENS)
        ref.append((r.text, tok.last[threading.get_ident()]))
    prompts = [PROMPTS[i % len(PROMPTS)] for i in range(STREAMS)]

    # a. 64 streams
    flash_gqa_cache.launches = 0
    flash_gqa_cache.launches_kv8 = 0
    f0 = eng.cb.forwards
    streams, wall = run_streams(rq, prompts)
    torch.cuda.synchronize()
    n_fwd = eng.cb.forwards - f0
    launches, other = flash_gqa_cache.launches, flash_gqa_cache.launches_kv8
    if launches != cfg.n_layers * n_fwd or other != 0:
        raise AssertionError(f"phase 13 a: {launches} launches for {n_fwd} forwards, {other} of the int8 kernel")
    held = hold_streams(rq, tok, ids, ref, [(i % len(ids), s_) for i, s_ in enumerate(streams)], "phase 13 a")
    ttft = [(s["times"][0] - s["t0"]) * 1e3 for s in streams]
    gaps = [(b - a) * 1e3 for s in streams for a, b in zip(s["times"], s["times"][1:])]
    n_tok = sum(len(s["ids"]) for s in streams)
    out["a"] = dict(streams=STREAMS, tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                    ttft_ms_p50=_pct(ttft, 0.5), ttft_ms_p99=_pct(ttft, 0.99), delta_gap_ms_p50=_pct(gaps, 0.5),
                    generate_batch_tokens_per_s=model_out["bf16"]["tokens_per_s"],
                    launches=launches, forwards=n_fwd, **held)
    tally["completed"] = len(PROMPTS) + STREAMS
    log(f"phase 13 a: {STREAMS} concurrent generate_stream consumers x {STREAM_TOKENS} tokens in {wall:.3f} s: "
        f"{n_tok / wall:.1f} tokens/s (phase 6's generate_batch {model_out['bf16']['tokens_per_s']:.1f}); TTFT p50 "
        f"{out['a']['ttft_ms_p50']:.2f} ms, p99 {out['a']['ttft_ms_p99']:.2f} ms; delta gap p50 "
        f"{out['a']['delta_gap_ms_p50']:.2f} ms; {launches} flash launches = {cfg.n_layers} x {n_fwd} forwards "
        f"[{card}]")

    # b1. 8 streams on the 8 slots, each closed at its first delta: the
    # slots free within two chunks of the last close.
    c0 = outcome_counts(name).get("cancelled", 0)
    first8, _ = run_streams(rq, PROMPTS, close_after_first=frozenset(range(len(PROMPTS))))
    last_close = max(s["chunks_at_close"] for s in first8)
    t = time.perf_counter()
    while eng.cb.active and time.perf_counter() - t < 60:
        time.sleep(0.001)
    freed_after = eng.stats()["chunks"] - last_close
    if eng.cb.active or freed_after > 2:
        raise AssertionError(f"phase 13 b: {eng.cb.active} slots still held, {freed_after} chunks after the last close")
    mid1 = sum(len(s["ids"]) < len(ref[i][1]) for i, s in enumerate(first8))
    # b2. 64 streams, 16 closed at their first delta, and 4 requests
    # cancelled while still queued behind them.
    close = frozenset(range(0, STREAMS, STREAMS // 16))
    queued, sub0 = [], eng.stats()["submitted"]

    def cancel_queued():
        while eng.stats()["submitted"] < sub0 + STREAMS:
            time.sleep(0.0005)
        for p_ids in ids[:4]:
            f = eng.submit(p_ids, STREAM_TOKENS)
            eng.cancel(f)
            queued.append(f)

    canceller = threading.Thread(target=cancel_queued)
    canceller.start()
    streams_b, _ = run_streams(rq, prompts, close_after_first=close)
    canceller.join(timeout=60)
    if len(queued) != 4 or not all(f.cancelled() for f in queued):
        raise AssertionError("phase 13 b: a request cancelled while queued was not cancelled outright")
    for f in queued:
        try:
            f.result(timeout=1)
            raise AssertionError("phase 13 b: a cancelled queued request returned tokens")
        except CancelledError:
            pass
    mid2 = sum(len(s["ids"]) < len(ref[i % len(ids)][1]) for i, s in enumerate(streams_b) if i in close)
    held_b = hold_streams(rq, tok, ids, ref, [(i % len(ids), s_) for i, s_ in enumerate(streams_b) if i not in close],
                          "phase 13 b survivors")
    cancelled = outcome_counts(name).get("cancelled", 0) - c0
    if cancelled != mid1 + mid2 or mid2 != len(close) or mid1 != len(PROMPTS):
        raise AssertionError(f"phase 13 b: cancelled outcome {cancelled}, mid-decode closes {mid1} + {mid2}")
    tally["completed"] += STREAMS - len(close)
    tally["cancelled"] = cancelled
    out["b"] = dict(closed_first8=len(first8), chunks_to_free=freed_after, closed=len(close), queued_cancelled=4,
                    cancelled_outcome=cancelled, survivors_equal=held_b["equal"],
                    survivors_near_tie=held_b["near_tie"])
    log(f"phase 13 b: 8 streams closed at their first delta freed every slot {freed_after} chunk(s) after the last "
        f"close; then {len(close)} of {STREAMS} closed mid-decode and 4 cancelled while queued (fut.cancel(), not "
        f"counted): cancelled outcome {cancelled} = {mid1} + {mid2} [{card}]")

    # c. deadlines: 4 long requests that cannot finish in DEADLINE_S beside
    # 4 that have none, then one queued behind them whose deadline passes.
    long_ref = [f.result(timeout=300) for f in [eng.submit(p_ids, LONG_TOKENS) for p_ids in ids[:4]]]
    tally["completed"] += 4
    r0 = eng.stats()["restarts"]

    def admitted(fut_list, n):
        # One at a time into an empty queue: with a backlog, the engine's
        # deadline-aware shed would read a and b's queue waits (seconds)
        # and shed the deadline at submit, as the reference does. All n
        # must be in the pool at once, so that the late request queues.
        t_ = time.perf_counter()
        while eng.cb.active < n:
            gone = [f for f in fut_list + plain if f.done()]
            if gone or time.perf_counter() - t_ > 60:
                why = [repr(f.exception()) for f in gone]
                raise AssertionError(f"phase 13 c: {eng.cb.active} of {n} requests in the pool; ended before the "
                                     f"last was admitted: {why}")
            time.sleep(0.0005)
        return fut_list

    futs, plain = [], []
    for k, p_ids in enumerate(ids):
        if k < 4:
            futs.append(eng.submit(p_ids, LONG_TOKENS, deadline_s=DEADLINE_S))
        else:
            plain.append(eng.submit(p_ids, 120))
        admitted(futs, k + 1)
    late = eng.submit(ids[0], 8, deadline_s=0.05)
    partial = []
    for f, want, p_ids in zip(futs, long_ref, ids):
        try:
            f.result(timeout=300)
            raise AssertionError("phase 13 c: a request outlived its deadline")
        except DeadlineExceededError as e:
            if not 0 < len(e.tokens) < LONG_TOKENS:
                raise AssertionError(f"phase 13 c: {len(e.tokens)} tokens at the deadline")
            margin_rule(rq.params, rq.cfg, tok, p_ids, want[: len(e.tokens)], e.tokens, "phase 13 c")
            partial.append(len(e.tokens))
    t = time.perf_counter()
    while eng.cb.active > 4 and time.perf_counter() - t < 60:
        time.sleep(0.001)
    freed = eng.cb.active <= 4
    try:
        late.result(timeout=60)
        raise AssertionError("phase 13 c: the queued request outlived its deadline")
    except DeadlineExceededError as e:
        if e.tokens:
            raise AssertionError("phase 13 c: the queued request decoded tokens")
    for f in plain:
        f.result(timeout=300)
    tally["completed"] += 4
    tally["deadline"] = 5
    where = [e["where"] for e in eng.recorder.dump() if e["kind"] == "deadline"]
    queued_where = [w for w in where if w != "mid-decode"]
    if not freed or eng.stats()["restarts"] != r0 or where.count("mid-decode") != 4 \
            or queued_where not in (["while queued"], ["expired before admission"]):
        raise AssertionError(f"phase 13 c: slots freed {freed}, restarts {eng.stats()['restarts']}, {where}")
    out["c"] = dict(partial_tokens=partial, queued_where=queued_where[0])
    log(f"phase 13 c: 4 requests past a {DEADLINE_S} s deadline failed with DeadlineExceededError after {partial} tokens "
        f"(each a prefix of its undeadlined run, or departing at a near-tie), their slots freed, no restart; "
        f"the one queued behind them expired {queued_where[0]} with no tokens [{card}]")
    counts = outcome_counts(name)
    rq.close()

    # d. the supervisor on the int8 cache
    os.environ["KAKVEDA_KV_QUANT"] = "int8"
    try:
        r8 = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok, model_label=name + "-int8", device=rt.device)
    finally:
        del os.environ["KAKVEDA_KV_QUANT"]
    name8 = r8.model_label
    e8 = r8.engine()
    head = tok.encode("System: you are the incident summarizer; answer in one short line. Incident ")
    if not e8.register_prefix(head):
        raise AssertionError("phase 13 d: the prefix was refused")
    hp = [head + tok.encode(f"{i}: the {w} failed; summarize why.", bos=False)
          for i, w in enumerate(["queue drain", "dns cache", "token mint", "rate gate",
                                 "blob store", "cron fanout", "search shard", "session pin", "ledger sync"])]
    flash_gqa_cache.launches = 0
    flash_gqa_cache.launches_kv8 = 0
    cbs, fwd0 = [e8.cb], e8.cb.forwards
    solo8 = [f.result(timeout=300) for f in [e8.submit(p, 64) for p in hp]]
    torch.cuda.synchronize()
    cache_bytes = sum(t_.numel() * t_.element_size() for v in e8.cb.cache.values() if isinstance(v, list) for t_ in v)
    mem_before = torch.cuda.memory_allocated()
    started = threading.Semaphore(0)

    def first_chunk():
        fired = [False]

        def on_tokens(new, done):
            if not fired[0]:
                fired[0] = True
                started.release()
        return on_tokens

    inflight = [e8.submit(p, 256, on_tokens=first_chunk()) for p in hp[:8]]
    queued8 = e8.submit(hp[8], 64)
    for _ in inflight:
        if not started.acquire(timeout=120):
            raise AssertionError("phase 13 d: the 8 requests never started")
    faults.arm("engine.dispatch:1:1")
    for f in inflight:
        try:
            f.result(timeout=300)
            raise AssertionError("phase 13 d: an in-flight request survived the crash")
        except EngineRetryableError:
            pass
    got_q = queued8.result(timeout=300)
    faults.disarm()
    if e8.cb is cbs[0]:
        raise AssertionError("phase 13 d: no rebuild")
    cbs.append(e8.cb)
    margin_rule(r8.params, r8.cfg, tok, hp[8], solo8[8], got_q, "phase 13 d queued")
    again = e8.submit(hp[0], 64).result(timeout=300)
    margin_rule(r8.params, r8.cfg, tok, hp[0], solo8[0], again, "phase 13 d resubmit")
    with e8.cb.stats_lock:
        hits = e8.cb.prefix_stats["hits"]
    torch.cuda.synchronize()
    mem_after = torch.cuda.memory_allocated()
    ev = e8.recorder.dump()
    t_err = next(e["t"] for e in ev if e["kind"] == "engine_error")
    t_rst = next(e["t"] for e in ev if e["kind"] == "engine_restart")
    if hits < 2 or abs(mem_after - mem_before) >= cache_bytes or e8.stats()["restarts"] != 1:
        raise AssertionError(f"phase 13 d: prefix hits {hits} after the rebuild, memory {mem_before} -> {mem_after} "
                             f"(a cache is {cache_bytes}), restarts {e8.stats()['restarts']}")
    counts8 = outcome_counts(name8)
    r8.close()
    # ... then a budget of one restart and every dispatch failing: dead.
    os.environ["KAKVEDA_SERVE_RESTARTS"] = "1"
    try:
        dead = ServingEngine(r8.params, r8.cfg, batch_slots=8, max_len=512, chunk_steps=8, eos_id=tok.EOS,
                             name=name + "-dead")
    finally:
        del os.environ["KAKVEDA_SERVE_RESTARTS"]
    cbs.append(dead.cb)
    faults.arm("engine.dispatch:1:-1")
    try:
        try:
            dead.submit(hp[0], 8).result(timeout=300)
            raise AssertionError("phase 13 d: a request survived an armed dispatch")
        except EngineRetryableError:
            pass
        t = time.perf_counter()
        while dead.cb is cbs[-1] and time.perf_counter() - t < 60:
            time.sleep(0.001)
        cbs.append(dead.cb)
        try:
            dead.submit(hp[1], 8).result(timeout=300)
            raise AssertionError("phase 13 d: the engine outlived its restart budget")
        except EngineDeadError:
            pass
        if not dead._dead.wait(60):
            raise AssertionError("phase 13 d: the engine never latched dead")
        t = time.perf_counter()
        try:
            dead.submit(hp[2], 8)
            raise AssertionError("phase 13 d: submit on a dead engine did not raise")
        except EngineDeadError:
            refuse_ms = (time.perf_counter() - t) * 1e3
    finally:
        faults.disarm()
        dead.close()
    torch.cuda.synchronize()
    n_fwd8 = sum(cb.forwards for cb in cbs) - fwd0
    l8, l16 = flash_gqa_cache.launches_kv8, flash_gqa_cache.launches
    if refuse_ms >= 1000 or l8 != cfg.n_layers * n_fwd8 or l16 != 0:
        raise AssertionError(f"phase 13 d: refusal {refuse_ms} ms, {l8} int8 launches for {n_fwd8} forwards, "
                             f"{l16} bf16")
    out["d"] = dict(restart_wall_s=t_rst - t_err, prefix_hits=hits, mem_before=mem_before, mem_after=mem_after,
                    cache_bytes=cache_bytes, dead_refusal_ms=refuse_ms, launches=l8, forwards=n_fwd8)
    log(f"phase 13 d (int8 cache): engine.dispatch crash with 8 in flight and 1 queued: the 8 failed "
        f"EngineRetryableError, the queued one and a resubmit held their pre-crash tokens; restart wall "
        f"{t_rst - t_err:.3f} s (error to rebuilt, prefix registered again: {hits} hits after it); allocated "
        f"{mem_before} -> {mem_after} bytes (a cache is {cache_bytes}); a budget of 1 spent: submit raised "
        f"EngineDeadError in {refuse_ms:.3f} ms; {l8} int8 flash launches = {cfg.n_layers} x {n_fwd8} forwards "
        f"[{card}]")

    # e. top-p at Llama-3's vocabulary on the card
    gen = torch.Generator(device="cuda").manual_seed(13)
    logits = 3.0 * torch.randn((8, cfg.vocab_size), generator=gen, device="cuda")
    kept = {}
    for top_p in (0.5, 0.9, 0.95):
        keep = top_p_keep(logits, 0.8, top_p)
        plain = top_p_keep(logits.cpu(), 0.8, top_p)
        if not torch.equal(keep.cpu(), plain):
            raise AssertionError(f"phase 13 e: top_p {top_p}: the card's kept set differs from the CPU's")
        g = torch.Generator(device="cuda").manual_seed(int(top_p * 100))
        draws = torch.stack([_sample_top_p(logits, 0.8, top_p, g) for _ in range(125)])  # 1,000 draws
        if not keep.gather(1, draws.T).all():
            raise AssertionError(f"phase 13 e: top_p {top_p}: a draw outside the kept set")
        kept[top_p] = keep.sum(-1).tolist()
    if not torch.equal(_sample_top_p(logits, 0.8, 1e-9, gen), logits.argmax(-1)):
        raise AssertionError("phase 13 e: top_p 1e-9 is not greedy")
    out["e"] = dict(kept=kept)
    log(f"phase 13 e: top-p at V = {cfg.vocab_size}, B = 8: kept sets card == CPU, sizes {kept}; 1,000 draws "
        f"each inside; top_p 1e-9 greedy [{card}]")

    # f. the metrics plane through make_app in this process
    import re

    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    with tempfile.TemporaryDirectory(prefix="kakveda-metrics-") as d:
        plat = Platform(data_dir=Path(d), capacity=1024, dim=1024, device=rt.device)

        async def scrape():
            client = TestClient(TestServer(make_app(plat)))
            await client.start_server()
            try:
                return await (await client.get("/metrics")).text(), await (await client.get("/flightrecorder")).json()
            finally:
                await client.close()

        try:
            text, fr = asyncio.run(scrape())
        finally:
            plat.close()
    scraped = {}
    for ln in text.splitlines():
        mt = re.match(r'kakveda_serving_requests_total\{engine="([^"]+)",outcome="([^"]+)"\} (\S+)', ln)
        if mt:
            scraped.setdefault(mt.group(1), {})[mt.group(2)] = int(float(mt.group(3)))
    want8 = {"completed": len(hp) + 2}
    if scraped.get(name) != tally or counts != tally or scraped.get(name8) != want8 or counts8 != want8:
        raise AssertionError(f"phase 13 f: /metrics {scraped.get(name)} / {scraped.get(name8)} against the phase's "
                             f"{tally} / {want8}")
    rec = next((r for r in fr["recorders"] if r["name"] == f"serving/{name8}"), None)
    kinds = [e["kind"] for e in rec["events"]] if rec else []
    if kinds.count("engine_error") != 1 or kinds.count("engine_restart") != 1:
        raise AssertionError(f"phase 13 f: /flightrecorder holds {kinds}")
    for fam in ("queue_wait_seconds", "prefill_seconds", "ttft_seconds", "request_seconds", "tokens_per_second",
                "chunk_seconds", "requests_total", "tokens_total", "engine_errors_total", "engine_restarts_total"):
        if f"# TYPE kakveda_serving_{fam} " not in text:
            raise AssertionError(f"phase 13 f: /metrics lacks kakveda_serving_{fam}")
    out["f"] = dict(requests=scraped.get(name), requests_int8=scraped.get(name8))
    log(f"phase 13 f: /metrics kakveda_serving_requests_total {scraped.get(name)} (the phase's {tally}), int8 "
        f"engine {scraped.get(name8)}; /flightrecorder serving/{name8}: engine_error and engine_restart")
    log("phase 13: " + json.dumps(out))
    return out




# ---------------------------------------------------------------------------
# phase 15: speculative decoding on the card (inside phase 6's model
# lifetime, on its weights), then the default preset
# ---------------------------------------------------------------------------

SPEC_TOKENS = 128  # a's budget per request, and c's under the default gate: room for the gate to settle
SPEC_SOLO_TOKENS = 64  # b's
SPEC_CPU_TOKENS = 32  # c's runs held to the CPU port's, and a's int8 arm (the smoke's depth: ROADMAP)
REPEAT_PROMPTS = [  # 8 template-shaped prompts: a template repeated three times (the reference tests' shape)
    " ".join([f"Source [{i}] cites report {i}; verdict: no citation found."] * 3) for i in range(8)
]


@contextlib.contextmanager
def env_set(**kw):
    """Environment variables set for the block, restored after."""
    old = {k: os.environ.get(k) for k in kw}
    os.environ.update({k: str(v) for k, v in kw.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def spec_metrics(name: str, stats: dict) -> dict:
    """The speculation families ``GET /metrics`` shows for engine ``name``
    (the registry's render), held to the engine's ``spec_stats``: drafted
    and accepted counts, the gate's state gauge, the last verify width."""
    import re

    from kakveda_tpu_torch.core import metrics

    text = metrics.get_registry().render()

    def val(fam, extra=""):
        m = re.search(rf'^{fam}{{engine="{re.escape(name)}"{extra}}} (\S+)$', text, re.M)
        return float(m.group(1)) if m else None

    got = dict(drafted=val("kakveda_serving_spec_drafted_total"), accepted=val("kakveda_serving_spec_accepted_total"),
               gate=val("kakveda_serving_spec_gate_state", f',state="{stats["gate_state"]}"'),
               spec_k=val("kakveda_serving_spec_k"))
    want = dict(drafted=stats["drafted"], accepted=stats["accepted"], gate=1.0, spec_k=stats["k_trace"][-1])
    if got != want:
        raise AssertionError(f"phase 15 a: /metrics {got} against spec_stats {want}")
    return got


def spec_engine_run(rt, tok, prompts, kvq: str, spec: int, name: str, what: str, n_tok: int) -> dict:
    """One ``generate_batch`` of ``prompts`` × ``n_tok`` through a fresh
    runtime on ``rt``'s weights (8 slots, window 512, chunk 8;
    ``KAKVEDA_SERVE_SPEC=spec``, ``KAKVEDA_KV_QUANT=kvq``), after a warm-up
    batch; launch counts zeroed just before and read just after: the run's
    kernel body launches n_layers × (forwards), the others and
    ``gqa_grouped`` none (``hold_launches``)."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    with env_set(KAKVEDA_SERVE_SPEC=spec, **({"KAKVEDA_KV_QUANT": kvq} if kvq else {})):
        rq = LlamaRuntime(cfg=rt.cfg, params=rt.params, tokenizer=tok, model_label=name, device=rt.device)
        eng = rq.engine()
    try:
        if (eng.cb.B, eng.cb.max_len, eng.cb.chunk_steps, eng.cb.spec_k, rq.cfg.kv_quant) != (8, 512, 8, spec, kvq):
            raise AssertionError(f"{what}: engine {eng.cb.B} x {eng.cb.max_len}, spec_k {eng.cb.spec_k}, "
                                 f"cache {rq.cfg.kv_quant!r}")
        rq.generate_batch(prompts[:2], max_tokens=8)  # warm-up
        tok.decoded.clear()
        zero_launches()
        f0, c0 = eng.cb.forwards, eng.stats()["spec"]["chunks"]
        t = time.perf_counter()
        res = rq.generate_batch(prompts, max_tokens=n_tok)
        wall = time.perf_counter() - t
        torch.cuda.synchronize()
        n_fwd = eng.cb.forwards - f0
        got = list(tok.decoded)
        stats = eng.stats()["spec"]
        mine = hold_launches(rq.cfg, kvq, n_fwd, what)  # the other bodies and gqa_grouped: 0
        if len(got) != len(prompts) or not all(r.meta.get("continuous") for r in res):
            raise AssertionError(f"{what}: generate_batch did not run through the engine")
        n_tok = sum(map(len, got))
        out = dict(tokens=got, launches=mine, forwards=n_fwd, wall_s=wall, tokens_per_s=n_tok / wall,
                   n_tokens=n_tok, spec_chunks=stats["chunks"] - c0, spec=stats)
        if spec:
            out["metrics"] = spec_metrics(name, stats)
        return out
    finally:
        rq.close()


def graphs_in_turns(fns, n: int = 2, rounds: int = 5) -> list:
    """Device ms per call of each function: each one's ``n`` calls captured
    in a CUDA graph of its own, then the graphs replayed in turns (A B C A B
    C …) between CUDA events, ``rounds`` times; the median of each. Turns,
    so a clock or power change mid-run falls on all of them alike."""
    graphs = []
    for fn in fns:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()  # warm up on a side stream before capture
        torch.cuda.current_stream().wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(n):
                fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for g, t in zip(graphs, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            g.replay()
            end.record()
            end.synchronize()
            t.append(start.elapsed_time(end) / n)
    del graphs
    return [statistics.median(t) for t in times]


def verify_forward_ms(rt, ids, card: str) -> dict:
    """Device ms of one verify chunk's forward (S = 5) beside one 1-wide step
    (S = 1) and the whole verify chunk (argmax, forward, acceptance) on a
    pool of 8 slots admitted with phase 6's prompts, the bf16 cache, each
    from a CUDA graph, replayed in turns (``graphs_in_turns``)."""
    from kakveda_tpu_torch.models.serving import ContinuousBatcher, _forward_wide, _spec_chunk

    cfg = rt.cfg
    cb = ContinuousBatcher(rt.params, cfg, batch_slots=8, max_len=512, chunk_steps=8, spec_k=SPEC_K)
    for p in ids[:8]:
        cb.admit(p, max_new_tokens=64)
    cb._grow_valid(SPEC_K + 1)
    pos = torch.from_numpy(cb._pos_np.copy()).to("cuda")
    valid = torch.from_numpy(cb._kv_np.copy()).to("cuda")
    off = torch.from_numpy(cb._off_np.copy()).to("cuda")
    top = int(cb._pos_np.max())
    tok1 = torch.zeros((8, 1), dtype=torch.long, device="cuda")
    tok5 = torch.zeros((8, SPEC_K + 1), dtype=torch.long, device="cuda")
    drafts = torch.zeros((8, SPEC_K), dtype=torch.long, device="cuda")
    one, wide, chunk = graphs_in_turns([
        lambda: _forward_wide(cb.params, cfg, cb.cache, tok1, pos, valid, off, reach=top + 1),
        lambda: _forward_wide(cb.params, cfg, cb.cache, tok5, pos, valid, off, reach=top + SPEC_K + 1),
        lambda: _spec_chunk(cb.params, cfg, cb.cache, cb.last, pos, valid, off, drafts, reach=top + SPEC_K + 1),
    ])
    del cb
    torch.cuda.empty_cache()
    log(f"phase 15 a: device ms at 8 slots, bf16 cache: a 1-wide step {one:.3f}, the verify chunk's S = "
        f"{SPEC_K + 1} forward {wide:.3f} ({wide / one:.3f}x), the whole verify chunk {chunk:.3f} [{card}]")
    return dict(step_1_ms=one, forward_5_ms=wide, verify_chunk_ms=chunk, ratio=wide / one)


def _params_to(params, device):
    if isinstance(params, dict):
        return {k: _params_to(v, device) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_to(v, device) for v in params]
    return params.to(device)


def default_preset(card: str) -> dict:
    """Phase 15 c: ``LlamaRuntime()`` with no preset (head_dim 32, seed 0)
    on the card: ``generate_batch`` of phase 6's prompts through the engine
    without and with speculation (the gate held open:
    ``KAKVEDA_SERVE_SPEC_CALIB=0``, ``_BREAKEVEN=0``), the tokens held to
    the CPU port's on the same weights by the margin rule, the D = 32
    library's launches counted; then the same prompts under the default
    gate, SPEC_TOKENS each, against spec_k 0: on this traffic drafts are
    seldom accepted, so the gate must turn speculation off (its break-even,
    a verify chunk's span over a plain token's, past the tokens per
    verify); then ``get_runtime("torch")`` (the default preset) under a
    ``TieredClassifier`` judges one batch of phase 10's traffic (its judge
    prompts take the solo path at the default window)."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.models import runtime as TR
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.pipeline.classifier import RuleClassifier, TieredClassifier, _wants_citations

    os.environ.pop("KAKVEDA_LLAMA_PRESET", None)
    out, toks = {}, {}
    tok = RecordingTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    params = None
    runs = [(spec, SPEC_CPU_TOKENS, dict(KAKVEDA_SERVE_SPEC_CALIB=0, KAKVEDA_SERVE_SPEC_BREAKEVEN=0), f"k{spec}")
            for spec in (0, SPEC_K)]
    runs += [(spec, SPEC_TOKENS, {}, f"gate_k{spec}") for spec in (0, SPEC_K)]  # {}: the default gate
    for spec, n_tok, knobs, key in runs:
        with env_set(KAKVEDA_SERVE_SPEC=spec, **knobs):
            rq = LlamaRuntime(tokenizer=tok, model_label=f"default-preset-{key}")
            eng = rq.engine()
        try:
            if rq.device.type != "cuda" or rq.cfg.head_dim != 32 or eng.cb.spec_k != spec:
                raise AssertionError(f"phase 15 c: {rq.device}, head_dim {rq.cfg.head_dim}, spec_k {eng.cb.spec_k}")
            tok.decoded.clear()
            flash_gqa_cache.launches = 0
            f0 = eng.cb.forwards
            t = time.perf_counter()
            rq.generate_batch(PROMPTS, max_tokens=n_tok)
            wall = time.perf_counter() - t
            n_fwd = eng.cb.forwards - f0
            if flash_gqa_cache.launches != rq.cfg.n_layers * n_fwd:
                raise AssertionError(f"phase 15 c: {flash_gqa_cache.launches} launches for {n_fwd} forwards")
            toks[key] = list(tok.decoded)
            st = eng.stats()["spec"]
            if spec and not st["chunks"]:
                raise AssertionError(f"phase 15 c {key}: no verify chunk ran")
            out[key] = dict(launches=flash_gqa_cache.launches, forwards=n_fwd, wall_s=wall,
                            tokens_per_s=sum(map(len, toks[key])) / wall,
                            spec={k: st[k] for k in ("chunks", "emitted", "slot_chunks", "gate_state",
                                                     "tokens_per_verify", "break_even")})
            params, cfg = rq.params, rq.cfg
        finally:
            rq.close()
    gate = out[f"gate_k{SPEC_K}"]["spec"]
    if gate["gate_state"] != "off":
        raise AssertionError(f"phase 15 c: the default gate left speculation on at {gate['tokens_per_verify']} "
                             f"tokens per verify against a break-even of {gate['break_even']}")
    gate_margins = [margin_rule(params, cfg, tok, p, ref, got, "phase 15 c (default gate)", SPEC_TOKENS)
                    for p, ref, got in zip(ids, toks["gate_k0"], toks[f"gate_k{SPEC_K}"])]
    out["gate_departures"] = [m for m in gate_margins if m is not None]
    tok_cpu = RecordingTokenizer()
    r_cpu = LlamaRuntime(cfg=cfg, params=_params_to(params, "cpu"), tokenizer=tok_cpu, device="cpu")
    try:
        r_cpu.generate_batch(PROMPTS, max_tokens=SPEC_CPU_TOKENS)
    finally:
        r_cpu.close()
    cpu = list(tok_cpu.decoded)
    margins = [margin_rule(params, cfg, tok, p, ref, got, "phase 15 c", SPEC_CPU_TOKENS)
               for spec in (0, SPEC_K) for p, ref, got in zip(ids, cpu, toks[f"k{spec}"])]
    out["departures"] = [m for m in margins if m is not None]
    TR.clear_runtimes()
    try:
        judge_rt = TR.get_runtime("torch")
        if judge_rt.device.type != "cuda" or judge_rt.cfg.head_dim != 32:
            raise AssertionError("phase 15 c: get_runtime('torch') is not the default preset on the card")
        traces = judge_traffic(TracePayload, 16)
        flash_gqa_cache.launches = 0
        t = time.perf_counter()
        res = TieredClassifier(runtime=judge_rt).classify_batch(traces)
        judge_s = time.perf_counter() - t
        torch.cuda.synchronize()
        judged = sum(r is None and _wants_citations(tr.prompt)
                     for tr, r in zip(traces, RuleClassifier().classify_batch(traces)))
        if len(res) != len(traces) or flash_gqa_cache.launches <= 0:
            raise AssertionError(f"phase 15 c: the judge ran no kernel ({flash_gqa_cache.launches} launches)")
        out["judge"] = dict(traces=len(traces), judged=judged, failures=sum(r is not None for r in res),
                            launches=flash_gqa_cache.launches, wall_s=judge_s)
    finally:
        TR.clear_runtimes()
    g0, g1 = out["gate_k0"], out[f"gate_k{SPEC_K}"]
    log(f"phase 15 c: the default preset (head_dim 32) on the card: generate_batch of 8 x {SPEC_CPU_TOKENS} tokens "
        f"{out['k0']['tokens_per_s']:.1f} tokens/s without spec, {out[f'k{SPEC_K}']['tokens_per_s']:.1f} with "
        f"the gate held open ({out[f'k{SPEC_K}']['spec']}); under the default gate, 8 x {SPEC_TOKENS} tokens: "
        f"{g0['tokens_per_s']:.1f} tokens/s without spec, {g1['tokens_per_s']:.1f} with ({g1['spec']}), tokens == "
        f"spec_k 0's but for {len(out['gate_departures'])} departures at margins "
        f"{[round(m, 4) for m in out['gate_departures']]}; held-open tokens == the CPU port's but for "
        f"{len(out['departures'])} departures at "
        f"margins {[round(m, 4) for m in out['departures']]}; TieredClassifier judged {len(traces)} traces in "
        f"{judge_s:.3f} s ({judged} ambiguous, to the judge), {flash_gqa_cache.launches} D = 32 launches, "
        f"{out['judge']['failures']} failures [{card}]")
    return out


def phase_spec(rt, model_out: dict, card: str) -> dict:
    """Phase 15 on phase 6's Llama-3-8B weights: a. the engine with
    ``KAKVEDA_SERVE_SPEC=4`` (the default gate) against ``spec_k = 0``:
    with the bf16 cache on phase 6's 8 prompts and on 8 template-shaped
    ones apart, SPEC_TOKENS each (the reading of each traffic), with the
    int8 cache on the 16 together, SPEC_CPU_TOKENS each (its checks);
    tokens by the margin rule, verify chunks run, ``/metrics``'s spec
    families == ``spec_stats``; and the verify chunk's device time against
    a 1-wide step; b. ``KAKVEDA_SPEC=1``'s solo path against the plain solo
    path; c. the default preset (``default_preset``)."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime, generate_tokens

    t_phase = time.perf_counter()
    cfg, out = rt.cfg, {}
    tok = RecordingTokenizer()
    prompts = PROMPTS + REPEAT_PROMPTS
    ids = [tok.encode(p) for p in prompts]
    if not all(len(i) + SPEC_TOKENS + 1 < 512 for i in ids):
        raise AssertionError("phase 15: a prompt does not fit the engine's window")
    arms = (("", SPEC_TOKENS, (("distinct", PROMPTS), ("template", REPEAT_PROMPTS))),
            ("int8", SPEC_CPU_TOKENS, (("mixed", prompts),)))
    for kvq, n_tok, sets in arms:
        tag = kvq or "bf16"
        out[tag] = agg = dict(launches=0, launches_spec=0, forwards_spec=0, spec_chunks=0)
        for set_name, set_prompts in sets:
            runs = {spec: spec_engine_run(rt, tok, set_prompts, kvq, spec,
                                          f"llama3-8b-phase15-{tag}-{set_name}-k{spec}",
                                          f"phase 15 a {tag} {set_name} spec_k={spec}", n_tok) for spec in (0, SPEC_K)}
            sp = runs[SPEC_K]
            if sp["spec_chunks"] <= 0:
                raise AssertionError(f"phase 15 a {tag} {set_name}: no verify chunk ran ({sp['spec']})")
            margins = [margin_rule(rt.params, dataclasses.replace(cfg, kv_quant=kvq), tok, tok.encode(p), ref, got,
                                   f"phase 15 a {tag} {set_name}", n_tok)
                       for p, ref, got in zip(set_prompts, runs[0]["tokens"], sp["tokens"])]
            deps = [m for m in margins if m is not None]
            st = sp["spec"]
            tpv = st["emitted"] / max(st["slot_chunks"], 1)
            agg["launches"] += runs[0]["launches"]
            agg["launches_spec"] += sp["launches"]
            agg["forwards_spec"] += sp["forwards"]
            agg["spec_chunks"] += sp["spec_chunks"]
            agg[set_name] = dict(
                tokens_per_s=runs[0]["tokens_per_s"], tokens_per_s_spec=sp["tokens_per_s"],
                wall_s=runs[0]["wall_s"], wall_s_spec=sp["wall_s"], spec_chunks=sp["spec_chunks"],
                tokens_per_verify=tpv, drafted=st["drafted"], accepted=st["accepted"],
                gate_state=st["gate_state"], break_even=st["break_even"], k_trace=st["k_trace"][-8:],
                departures=deps, metrics=sp["metrics"])
            log(f"phase 15 a, {tag} cache, {set_name} prompts: {len(set_prompts)} x {n_tok} tokens, "
                f"{runs[0]['tokens_per_s']:.1f} tokens/s with spec_k 0, {sp['tokens_per_s']:.1f} with spec_k {SPEC_K} "
                f"under the default gate ({sp['spec_chunks']} verify chunks, {st['emitted']} tokens over "
                f"{st['slot_chunks']} slot-chunks: {tpv:.3f} tokens per verify, {st['accepted']} of {st['drafted']} "
                f"drafts accepted; gate {st['gate_state']}, break-even {st['break_even']}); {sp['launches']} launches "
                f"for {sp['forwards']} forwards; spec == plain but for {len(deps)} departures at margins "
                f"{[round(m, 4) for m in deps]}; /metrics spec families == spec_stats [{card}]")
    out["verify_forward"] = verify_forward_ms(rt, ids, card)

    # b. the solo path
    solo = []
    with env_set(KAKVEDA_SPEC=1):
        rs = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok, model_label="llama3-8b-phase15-solo",
                          device=rt.device)
        for p, p_ids in ((prompts[0], ids[0]), (REPEAT_PROMPTS[0], ids[len(PROMPTS)])):
            flash_gqa_cache.launches = 0
            t = time.perf_counter()
            r = rs.generate(p, max_tokens=SPEC_SOLO_TOKENS)
            wall = time.perf_counter() - t
            got = tok.decoded[-1]
            launches = flash_gqa_cache.launches
            if not r.meta.get("speculative") or r.meta.get("continuous"):
                raise AssertionError(f"phase 15 b: meta {r.meta}")
            ref = generate_tokens(rt.params, cfg, p_ids, max_new_tokens=SPEC_SOLO_TOKENS, eos_id=tok.EOS)
            m = margin_rule(rt.params, cfg, tok, p_ids, ref, got, "phase 15 b", SPEC_SOLO_TOKENS)
            solo.append(dict(tokens_per_round=r.meta["tokens_per_round"], tokens=len(got), launches=launches,
                             wall_s=wall, departure=m))
    if any(s["launches"] <= 0 or s["launches"] % cfg.n_layers for s in solo):
        raise AssertionError(f"phase 15 b: launches {[s['launches'] for s in solo]}")
    out["solo"] = solo
    log(f"phase 15 b: KAKVEDA_SPEC=1 generate, 2 prompts x {SPEC_SOLO_TOKENS} tokens: tokens_per_round "
        f"{[s['tokens_per_round'] for s in solo]}, walls {[round(s['wall_s'], 3) for s in solo]} s, launches "
        f"{[s['launches'] for s in solo]}, == the plain solo path but for departures at "
        f"{[s['departure'] for s in solo]} [{card}]")
    out["default_preset"] = default_preset(card)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 15: {out['wall_s']:.1f} s; " + json.dumps(out))
    return out


LADDER_DWELL_S = 0.5  # phase 17 e's short dwell (the knob's default is 5 s)
LADDER_FLOOD_S, LADDER_FLOOD_CLIENTS, LADDER_INTERACTIVE = 6.0, 16, 4


def _ladder_run(rq, tok, eng, n_tok: int, what: str, tracer) -> dict:
    """``generate_batch`` of the 8 prompts through ``rq``'s engine under one
    caller span; launch counts zeroed just before and read just after."""
    tok.decoded.clear()
    zero_launches()
    f0, c0 = eng.cb.forwards, eng.stats()["spec"]["chunks"]
    with tracer.start_span("smoke.generate_batch", what=what) as caller:
        res = rq.generate_batch(PROMPTS, max_tokens=n_tok)
    torch.cuda.synchronize()
    n_fwd = eng.cb.forwards - f0
    mine = hold_launches(rq.cfg, "", n_fwd, what)
    if len(res) != 8 or not all(r.meta.get("continuous") for r in res):
        raise AssertionError(f"{what}: generate_batch did not run through the engine")
    return dict(tokens=list(tok.decoded), launches=mine, forwards=n_fwd,
                spec_chunks=eng.stats()["spec"]["chunks"] - c0, caller=caller.span_id)


def phase_ladder(rt, card: str) -> dict:
    """Phase 17 e on phase 6's Llama-3-8B weights, after phase 15: the
    engine (8 slots, window 512, chunk 8) with ``KAKVEDA_SERVE_SPEC=4``, the
    gate held open, under the process-global brownout ladder, driven by
    ``note_pressure`` with a dwell of LADDER_DWELL_S to each step and back:
    verify chunks at step 0; at step 1 none, and the tokens of a spec_k 0
    engine; at step 2 every output cut at the cap of 32, the plain tokens'
    prefix; at steps 3 and 4 the background, then the interactive class shed
    with ``reason="brownout"``; down one step a dwell; the state gauge and
    transition counts equal to the controller's own record. Then real
    interactive load past a small interactive bound moves the ladder by
    itself (a reading). Every ``serving.request`` span lies under its
    submitter's span."""
    from kakveda_tpu_torch.core import admission, metrics, trace
    from kakveda_tpu_torch.core.admission import BROWNOUT_STATES, OverloadError
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    t_phase = time.perf_counter()
    tok = RecordingTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    tracer, reg = trace.get_tracer(), metrics.get_registry()
    adm = admission.get_admission()
    b = adm.brownout
    if b.step != 0:
        raise AssertionError(f"phase 17 e: the ladder is at {b.state} before the phase")
    knobs = dict(dwell_s=b.dwell_s, exit=b.exit, interactive=adm.limits["interactive"])
    out = {}

    def transitions():
        series = reg.snapshot()["kakveda_brownout_transitions_total"]["series"]
        return {k: v for k, v in series.items()}

    def gauge_state():
        series = reg.snapshot()["kakveda_brownout_state"]["series"]
        on = [k.split("=", 1)[1] for k, v in series.items() if v == 1.0]
        if len(on) != 1:
            raise AssertionError(f"phase 17 e: kakveda_brownout_state {series}")
        return on[0]

    def climb_to(step: int) -> None:
        while b.step < step:
            if b.step:
                time.sleep(LADDER_DWELL_S)
            b.note_pressure(1.0)
        if b.step != step or gauge_state() != b.state:
            raise AssertionError(f"phase 17 e: climbing to step {step}: at {b.state}, gauge {gauge_state()}")

    def step_down_timed() -> list:
        """Zero-pressure samples every 20 ms until step 0: (seconds, step)
        at each move."""
        moves, t0 = [], time.perf_counter()
        while b.step > 0:
            if time.perf_counter() - t0 > 10 * LADDER_DWELL_S * len(BROWNOUT_STATES):
                raise AssertionError(f"phase 17 e: the ladder stuck at {b.state} on the way down")
            before = b.step
            b.note_pressure(0.0)
            if b.step != before:
                moves.append((time.perf_counter() - t0, b.step))
            time.sleep(0.02)
        return moves

    tr0 = transitions()
    wall0 = time.time()
    with env_set(KAKVEDA_SERVE_SPEC=SPEC_K, KAKVEDA_SERVE_SPEC_CALIB=0, KAKVEDA_SERVE_SPEC_BREAKEVEN=0):
        rq = LlamaRuntime(cfg=rt.cfg, params=rt.params, tokenizer=tok, model_label="llama3-8b-phase17",
                          device=rt.device)
        eng = rq.engine()
    plain_rt = LlamaRuntime(cfg=rt.cfg, params=rt.params, tokenizer=tok, model_label="llama3-8b-phase17-plain",
                            device=rt.device)
    try:
        if (eng.cb.B, eng.cb.max_len, eng.cb.chunk_steps, eng.cb.spec_k) != (8, 512, 8, SPEC_K):
            raise AssertionError("phase 17 e: the engine is not 8 slots, window 512, chunk 8, speculating")
        plain_eng = plain_rt.engine()
        plain_rt.generate_batch(PROMPTS[:2], max_tokens=8)  # warm-ups
        rq.generate_batch(PROMPTS[:2], max_tokens=8)
        tracer.reset()  # from here, one caller span over each run's serving.request spans
        plain = _ladder_run(plain_rt, tok, plain_eng, 32, "phase 17 e plain", tracer)
        b.dwell_s, b.exit = LADDER_DWELL_S, -1.0  # hold each step: the engine's own samples are 0
        runs = {0: _ladder_run(rq, tok, eng, 32, "phase 17 e step 0", tracer)}
        if runs[0]["spec_chunks"] <= 0:
            raise AssertionError("phase 17 e: no verify chunk ran at step 0 with the gate held open")
        climb_to(1)
        runs[1] = _ladder_run(rq, tok, eng, 32, "phase 17 e step 1", tracer)
        if runs[1]["spec_chunks"] or runs[1]["tokens"] != plain["tokens"]:
            raise AssertionError(f"phase 17 e step 1: {runs[1]['spec_chunks']} verify chunks; tokens == spec_k 0's: "
                                 f"{runs[1]['tokens'] == plain['tokens']}")
        climb_to(2)
        runs[2] = _ladder_run(rq, tok, eng, 48, "phase 17 e step 2", tracer)
        cap = b.token_cap()
        if cap != 32 or runs[2]["spec_chunks"] or any(
                len(t) != cap or t != p[:cap] for t, p in zip(runs[2]["tokens"], plain["tokens"])):
            raise AssertionError(f"phase 17 e step 2: cap {cap}, lengths {[len(t) for t in runs[2]['tokens']]}")
        sheds = {}
        for step in (3, 4):
            climb_to(step)
            sheds[step] = []
            for klass in ("background", "interactive"):
                try:
                    got = eng.submit(ids[0], 16, klass=klass).result()
                    sheds[step].append((klass, "served", len(got)))
                except OverloadError as e:
                    sheds[step].append((klass, e.reason, e.klass))
        want = {3: [("background", "brownout", "background"), ("interactive", "served", 16)],
                4: [("background", "brownout", "background"), ("interactive", "brownout", "interactive")]}
        if sheds != want:
            raise AssertionError(f"phase 17 e steps 3-4: {sheds}")
        b.exit = knobs["exit"]
        down = step_down_timed()
        gaps = [t for t, _ in down[:1]] + [b2 - a2 for (a2, _), (b2, _) in zip(down, down[1:])]
        if [s2 for _, s2 in down] != [3, 2, 1, 0] or min(gaps[1:]) < LADDER_DWELL_S - 0.01:
            raise AssertionError(f"phase 17 e: the way down {down}")
        events = [e for e in adm.recorder.dump() if e["kind"] == "brownout" and e["t"] >= wall0]
        moved = {}
        for e in events:
            key = f"from={e['from']},to={e['to']}"
            moved[key] = moved.get(key, 0) + 1
        tr1 = transitions()
        delta = {k: v - tr0.get(k, 0) for k, v in tr1.items() if v != tr0.get(k, 0)}
        if delta != moved or gauge_state() != "normal" or len(events) != 8:
            raise AssertionError(f"phase 17 e: transitions_total moved {delta}, the controller recorded {moved}")
        occupancy = b.occupancy()
        # Every serving.request span lies under its generate_batch's span.
        spans = tracer.dump()
        callers = {r["caller"] for r in (plain, *runs.values())}
        served = [x for x in spans if x["name"] == "serving.request"]
        # 8 a run under its caller's span, and step 3's interactive submit,
        # made under none, as a root.
        if len(served) != 8 * 4 + 1 or sum(x["parent_id"] in callers for x in served) != 32:
            raise AssertionError(f"phase 17 e: {len(served)} serving.request spans, parents "
                                 f"{sorted({x['parent_id'] for x in served})} against callers {sorted(callers)}")
        out["steps"] = dict(spec_chunks_step0=runs[0]["spec_chunks"], spec_chunks_step1=runs[1]["spec_chunks"],
                            cap=cap, sheds={str(k): v for k, v in sheds.items()}, way_down=down,
                            transitions=delta, spans=len(served),
                            launches={"plain": plain["launches"], **{str(k): r["launches"] for k, r in runs.items()}})
        log(f"phase 17 e: Llama-3-8B bf16, 8 slots, KAKVEDA_SERVE_SPEC={SPEC_K} (gate held open), the global ladder "
            f"driven by note_pressure (dwell {LADDER_DWELL_S} s): step 0 {runs[0]['spec_chunks']} verify chunks; step 1 "
            f"none, 8 x 32 tokens == the spec_k 0 engine's; step 2 every output cut at {cap}, == their prefix; "
            f"step 3 background shed (brownout), interactive served; step 4 both shed; down one step a dwell "
            f"({[round(t, 3) for t, _ in down]} s); transitions_total moved {delta} == the controller's record; "
            f"{len(served)} serving.request spans, each under its submitter's span [{card}]")

        # Real interactive load: clients admitted through the interactive
        # class (bound LADDER_INTERACTIVE) flood the engine; the ladder moves
        # by itself.
        tr_f = transitions()
        adm.limits["interactive"] = LADDER_INTERACTIVE
        steps, outcomes, lock = [], {}, threading.Lock()
        stop = time.perf_counter() + LADDER_FLOOD_S

        def client(c):
            j = 0
            while time.perf_counter() < stop:
                try:
                    with adm.slot("interactive", tenant=f"client-{c}"):
                        eng.submit(ids[(c + j) % 8], 16, klass="interactive").result()
                    key = "served"
                except OverloadError as e:
                    key = e.reason
                    time.sleep(0.01)
                with lock:
                    outcomes[key] = outcomes.get(key, 0) + 1
                j += 1

        threads = [threading.Thread(target=client, args=(c,)) for c in range(LADDER_FLOOD_CLIENTS)]
        for th in threads:
            th.start()
        while any(th.is_alive() for th in threads):
            steps.append(b.step)
            time.sleep(0.05)
        for th in threads:
            th.join()
        adm.limits["interactive"] = knobs["interactive"]
        occ_flood = b.occupancy()
        down_flood = step_down_timed()
        moved_f = {k: v - tr_f.get(k, 0) for k, v in transitions().items() if v != tr_f.get(k, 0)}
        out["flood"] = dict(max_step=max(steps), steps_seen=sorted(set(steps)), outcomes=outcomes,
                            occupancy=occ_flood, transitions=moved_f, way_down=down_flood)
        log(f"phase 17 e, a flood: {LADDER_FLOOD_CLIENTS} clients through the interactive class (bound "
            f"{LADDER_INTERACTIVE}) for {LADDER_FLOOD_S:g} s: outcomes {outcomes}; the ladder reached "
            f"{BROWNOUT_STATES[max(steps)]} by itself (steps seen {sorted(set(steps))}), seconds in each state "
            f"{ {k: round(v, 3) for k, v in occ_flood.items()} }, transitions {moved_f} (a reading) [{card}]")
        out["occupancy"] = occupancy
    finally:
        b.dwell_s, b.exit = knobs["dwell_s"], knobs["exit"]
        adm.limits["interactive"] = knobs["interactive"]
        rq.close()
        plain_rt.close()
    if b.step != 0:
        raise AssertionError(f"phase 17 e: the ladder left at {b.state}")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 17 e: {out['wall_s']:.1f} s")
    return out


def phase_model(card: str, playground: bool = False) -> dict:
    """Phases 6, 13, 15 and 17 e on one Llama-3-8B runtime; with
    ``playground``, phase 20 b last, on the same runtime."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=LLAMA3_LAYERS)
    t0 = time.perf_counter()
    tok = RecordingTokenizer()
    rt = LlamaRuntime(cfg=cfg, seed=0, tokenizer=tok)
    torch.cuda.synchronize()
    n_bytes = param_bytes(rt.params)
    log(f"Llama-3-8B width, {cfg.n_layers} of its 32 layers, {n_bytes / 1e9:.2f} GB of weights "
        f"on {rt.device}, drawn in {time.perf_counter() - t0:.1f} s")
    want_bytes = LLAMA3_OTHER_BYTES + cfg.n_layers * LLAMA3_LAYER_BYTES  # 16.06e9 at 32 layers
    if rt.device.type != "cuda" or abs(n_bytes - want_bytes) > 0.01e9:
        raise AssertionError(f"model on {rt.device} with {n_bytes} bytes")
    ids = [tok.encode(p) for p in PROMPTS]
    if len({tuple(i) for i in ids}) != 8 or not all(33 <= len(i) <= 64 for i in ids):
        raise AssertionError("prompts must be 8 distinct, of one admission bucket")
    walls, t = {}, time.perf_counter()
    out = serve_engine(rt, tok, ids, "Llama-3-8B")
    step_times(rt, ids, out, n_bytes, "Llama-3-8B", card)
    log("model plane: " + json.dumps(out))
    walls["6"], t = time.perf_counter() - t, time.perf_counter()
    out["lifecycle"] = phase_lifecycle(rt, out, card)
    walls["13"], t = time.perf_counter() - t, time.perf_counter()
    out["spec"] = phase_spec(rt, out, card)
    walls["15"], t = time.perf_counter() - t, time.perf_counter()
    out["ladder"] = phase_ladder(rt, card)
    walls["17 e"], t = time.perf_counter() - t, time.perf_counter()
    if playground:
        out["playground"] = asyncio.run(phase_playground(rt, card))
        walls["20 b"] = time.perf_counter() - t
    out["walls_s"] = {k: round(v, 1) for k, v in walls.items()}
    log(f"phases 6, 13, 15, 17 e{', 20 b' if playground else ''} walls (s): {json.dumps(out['walls_s'])} [{card}]")
    return out


def moe_step_split(cb, dev_args, reach: int, step_ms: float, card: str) -> dict:
    """One MoE decode step (B = 8, the bf16 cache) split into its parts, each
    replayed from a CUDA graph between CUDA events at the step's shapes:
    dequantize (every ``wmat`` of a step), the GEMMs and ``bmm``s on
    dequantized weights (layer 0's, once per layer, and ``lm_head``; the
    SwiGLU's silu and product included), ``flash_gqa_cache`` (every layer's
    cache, the step's mask and ``reach``), and router + dispatch + combine
    (every layer's router at T = 8). The rest (embedding, norms, rope, cache
    writes, residual adds) is the step's device time less their sum. Bounds:
    the bytes each part must move at the HBM rate."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.attention import gqa_cache_attention
    from kakveda_tpu_torch.models.llama import wmat

    params, cfg, cache = cb.params, cb.cfg, cb.cache
    b, d, dt, e, k = cb.B, cfg.d_model, cfg.dtype, cfg.n_experts, cfg.n_experts_per_tok
    names = ("wq", "wk", "wv", "wo", "we_gate", "we_up", "we_down")
    g = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape):
        return torch.randn(shape, device="cuda", generator=g).to(dt)

    def dequant():
        for layer in params["layers"]:
            for n in names:
                wmat(layer[n], dt)
        wmat(params["lm_head"], dt)

    l0 = {n: wmat(params["layers"][0][n], dt) for n in names}
    head = wmat(params["lm_head"], dt)
    cap = moe.expert_capacity(b, cfg)
    x, attn, xe, ye = rnd(b, 1, d), rnd(b, 1, cfg.n_heads * cfg.head_dim), rnd(e, cap, d), rnd(e, cap, d)
    q = rnd(b, 1, cfg.n_heads, cfg.head_dim)

    def gemms():
        for _ in range(cfg.n_layers):
            x @ l0["wq"], x @ l0["wk"], x @ l0["wv"], attn @ l0["wo"]
            moe.expert_swiglu(xe, l0)
        x @ head

    _, pos, kv_valid, _ = dev_args
    col = torch.arange(cb.max_len, device="cuda")[None, :]
    mask = kv_valid & (col <= pos[:, None])

    def flash():
        for li in range(cfg.n_layers):
            gqa_cache_attention(q, cache["k"][li], cache["v"][li], cb.max_len, mask, reach=reach)

    xf = x.reshape(b, d)

    def route():
        for layer in params["layers"]:
            w, idx, _ = moe.router_topk(xf.float() @ layer["router"].float(), k)
            order, tok_sorted, slot, keep = moe.dispatch_slots(idx, cap, e)
            moe.dispatch(xf, tok_sorted, slot, e, cap)
            moe.combine(ye, w, order, slot, keep, b)

    q_bytes = sum(layer[n]["q"].numel() for layer in params["layers"] for n in names)
    q_bytes += params["lm_head"]["q"].numel()
    parts = {
        "dequantize": (graph_ms(dequant, n=1), 3 * q_bytes),  # read int8, write bf16
        "gemms_and_bmms": (graph_ms(gemms, n=1), 2 * q_bytes),  # read bf16
        "flash_gqa_cache": (graph_ms(flash, n=1), None),
        "router_dispatch_combine": (graph_ms(route, n=1), None),
    }
    split = {name: dict(ms=ms, bound_ms=None if nb is None else nb / HBM_BYTES_PER_S * 1e3)
             for name, (ms, nb) in parts.items()}
    split["rest"] = dict(ms=step_ms - sum(p["ms"] for p in split.values()), bound_ms=None)
    split["step"] = dict(ms=step_ms, bound_ms=param_bytes(params) / HBM_BYTES_PER_S * 1e3)
    del l0, head
    for name, p in split.items():
        p["per_layer_ms"] = p["ms"] / cfg.n_layers
        bound = "" if p["bound_ms"] is None else f" (bound {p['bound_ms']:.2f} ms)"
        log(f"  MoE decode step split: {name} {p['ms']:.3f} ms{bound}, {p['per_layer_ms']:.3f} ms per layer of "
            f"{cfg.n_layers} [{card}]")
    return split


def phase_mixtral(card: str) -> dict:
    """Phase 9: Mixtral-8x7B at full width and MIXTRAL_LAYERS of its depth,
    int8 weight-only, on the card."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.models.quant import quantize_tensor_int8

    held = torch.cuda.memory_allocated()
    if held > 1e9:  # from earlier phases: name the largest tensors still alive
        live = sorted(((o.numel() * o.element_size(), tuple(o.shape), str(o.dtype)) for o in gc.get_objects()
                       if isinstance(o, torch.Tensor) and o.is_cuda), reverse=True)[:8]
        log(f"phase 9: {held} bytes held from earlier phases; the largest live tensors: {live}")
    cfg = LlamaConfig(**{**MIXTRAL_8X7B, "n_layers": MIXTRAL_LAYERS})
    tok = RecordingTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    out = {}

    # a. The card's quantizer against the CPU's on one f32 expert matrix.
    g = torch.Generator(device="cuda").manual_seed(9)
    w = torch.randn((cfg.d_model, cfg.d_ff), device="cuda", generator=g).div_(math.sqrt(cfg.d_model))
    on_card, on_host = quantize_tensor_int8(w), quantize_tensor_int8(w.cpu())
    same = (torch.equal(on_card["q"].cpu(), on_host["q"]), torch.equal(on_card["s"].cpu(), on_host["s"]))
    log(f"phase 9 a: int8 quantization of a {cfg.d_model} x {cfg.d_ff} f32 matrix, card == CPU: "
        f"q {same[0]}, s {same[1]}")
    if not all(same):
        raise AssertionError("the card's int8 quantization differs from the CPU's")
    del w, on_card

    # b. int8 weights against bf16 weights at Mixtral's width, 2 layers.
    bf = LlamaRuntime(cfg=dataclasses.replace(cfg, n_layers=2), seed=1, tokenizer=tok)
    i8 = LlamaRuntime(cfg=bf.cfg, params=bf.params, quant="int8", tokenizer=tok)
    log(f"phase 9 b: 2 layers of Mixtral's width, bf16 {param_bytes(bf.params) / 1e9:.2f} GB and its int8 "
        f"quantization {param_bytes(i8.params) / 1e9:.2f} GB")
    ref = first_steps(bf.params, bf.cfg, ids, tok)
    out["int8_vs_bf16"] = hold_cosine(ref, first_steps(i8.params, i8.cfg, ids, tok, pin=[t for _, t in ref]),
                                      "phase 9 b: int8 weights vs bf16 weights")
    del bf, i8
    gc.collect()
    torch.cuda.empty_cache()

    # c. The whole model, drawn on the card and quantized matrix by matrix.
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rt = LlamaRuntime(cfg=cfg, seed=0, quant="int8", tokenizer=tok)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    n_bytes = param_bytes(rt.params)
    peak = torch.cuda.max_memory_allocated() - base
    bad = [f"{li}.{n}" for li, layer in enumerate(rt.params["layers"]) for n, v in layer.items()
           if (n.startswith("w") and v["q"].dtype != torch.int8) or (n == "router" and v.dtype != torch.float32)]
    log(f"phase 9 c: Mixtral-8x7B width, {cfg.n_layers} of its {MIXTRAL_8X7B['n_layers']} layers x "
        f"{cfg.n_experts} experts, "
        f"{n_bytes} bytes ({n_bytes / 1e9:.2f} GB) of int8 weight-only weights on {rt.device}, drawn and "
        f"quantized in {draw_s:.1f} s, peak allocated by the draw {peak / 1e9:.2f} GB [{card}]")
    want_bytes = MIXTRAL_OTHER_BYTES + cfg.n_layers * MIXTRAL_LAYER_BYTES  # 46,872,802,304 at 32 layers
    if rt.device.type != "cuda" or abs(n_bytes - want_bytes) > 0.01e9 or bad:
        raise AssertionError(f"model on {rt.device} with {n_bytes} bytes; not int8 / f32: {bad}")
    out.update(weight_bytes=n_bytes, draw_s=draw_s, init_peak_bytes=peak)

    # d. Layer 0's moe_mlp against the per-token oracle at T = 8 and 64.
    layer0 = rt.params["layers"][0]
    trace = RouterTrace()
    out["moe_vs_oracle"] = {}
    for t in (8, 64):
        x = torch.randn((1, t, cfg.d_model), device="cuda", generator=g).to(cfg.dtype)
        with trace.on():
            got = moe.moe_mlp(x, layer0, cfg)
        want, experts = moe.moe_mlp_reference(x, layer0, cfg)
        chosen = trace.calls[0]
        diff = (got.float() - want.float()).abs()[0]
        scale = want.float()[0].abs().amax(dim=-1, keepdim=True)
        use = (diff / (FLASH_REL * scale)).max().item()
        log(f"phase 9 d: layer 0 moe_mlp at T={t} vs the per-token oracle: experts equal "
            f"{torch.equal(chosen, experts)}, max_abs_err {diff.max().item():.4g}, {use:.3f} of the "
            f"per-row tolerance (2^-6 of the row's largest oracle value)")
        if not torch.equal(chosen, experts) or use > 1.0 or not torch.isfinite(got).all():
            raise AssertionError(f"phase 9 d: moe_mlp at T={t} disagrees with the oracle")
        out["moe_vs_oracle"][t] = dict(max_abs_err=diff.max().item(), tolerance_used=use)

    # e. Through the engine, both caches; f. times and the step's split.
    out.update(serve_engine(rt, tok, ids, "phase 9 e: Mixtral-8x7B int8"))
    greedy = [out[tag].pop("ids") for tag in ("bf16", "int8")][0]
    step_times(rt, ids, out, n_bytes, "phase 9 f: Mixtral-8x7B int8", card,
               split=lambda cb, a, r, ms: moe_step_split(cb, a, r, ms, card))
    # g. MoE under speculation.
    out["spec"] = mixtral_spec(rt, tok, ids, greedy, card)
    rt.close()
    del rt
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 9: " + json.dumps(out))
    return out


MIXTRAL_SPEC_PROMPTS = 4


def moe_departure(params, cfg, tok, prompt_ids, ref, got, what: str, n_max: int):
    """A MoE run's tokens against ``ref``: None when equal, else (the solo
    top-2 logit margin at the first departure along ``ref``, the narrowest
    router gap between a chosen expert and the best left out over every
    token and layer of that prefix). A departure is a near-tie of the
    logits or of some expert choice: it fails when both are MARGIN_TOL or
    more (MoE routing in bf16 is not batch-invariant: a verify chunk's
    S = k+1 GEMMs round otherwise than a 1-wide step's)."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

    a = list(ref) + ([tok.EOS] if len(ref) < n_max else [])
    b = list(got) + ([tok.EOS] if len(got) < n_max else [])
    n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if n is None:
        return None
    gaps, real, k = [], moe.router_topk, cfg.n_experts_per_tok

    def traced(logits, k_):
        top = logits.float().sort(dim=-1, descending=True).values
        gaps.append((top[:, k - 1] - top[:, k]).min().item())
        return real(logits, k_)

    moe.router_topk = traced
    try:
        seq = list(prompt_ids) + a[:n]
        logits, _ = decode_step(params, cfg, torch.tensor([seq], device="cuda"),
                                init_cache(cfg, 1, len(seq), device="cuda"), last_only=True)
    finally:
        moe.router_topk = real
    top2 = mask_pad_vocab(logits[0, -1], cfg)[: tok.vocab_size].topk(2).values
    margin, gap = (top2[0] - top2[1]).item(), min(gaps)
    if margin >= MARGIN_TOL and gap >= MARGIN_TOL:
        raise AssertionError(f"{what}: tokens depart at step {n} where the logit margin is {margin:.4f} and the "
                             f"narrowest router gap {gap:.4f}, both >= {MARGIN_TOL}")
    return round(margin, 4), round(gap, 4)


def mixtral_spec(rt, tok, ids, greedy, card: str) -> dict:
    """Phase 9 g: Mixtral-8x7B int8 under speculation. The engine with
    ``KAKVEDA_SERVE_SPEC=4`` (the gate held open) on MIXTRAL_SPEC_PROMPTS
    prompts × 32 tokens, and ``KAKVEDA_SPEC=1``'s solo path on one prompt,
    held to phase 9 e's greedy tokens (``moe_departure``: departures
    counted, with their margins); layer 0's ``moe_mlp`` inside one verify
    chunk (T = B·(k+1)) against its per-token plain version."""
    from kakveda_tpu_torch.models import moe
    from kakveda_tpu_torch.models.generate import LlamaRuntime

    cfg = rt.cfg
    prompts = PROMPTS[:MIXTRAL_SPEC_PROMPTS]
    captured, real = [], moe.moe_mlp

    def spy(x, layer, c):
        if not captured and x.shape[1] == SPEC_K + 1 and layer is rt.params["layers"][0]:
            captured.append(x.clone())
        return real(x, layer, c)

    moe.moe_mlp = spy
    try:
        with env_set(KAKVEDA_SERVE_SPEC_CALIB=0, KAKVEDA_SERVE_SPEC_BREAKEVEN=0):
            r = spec_engine_run(rt, tok, prompts, "", SPEC_K, "mixtral-8x7b-spec", "phase 9 g engine", 32)
    finally:
        moe.moe_mlp = real
    if r["spec_chunks"] <= 0 or not captured:
        raise AssertionError(f"phase 9 g: {r['spec_chunks']} verify chunks, moe_mlp captured {len(captured)}")
    deps = [moe_departure(rt.params, cfg, tok, p, ref, got, "phase 9 g engine", 32)
            for p, ref, got in zip(ids, greedy, r["tokens"])]
    x = captured[0]
    got = moe.moe_mlp(x, rt.params["layers"][0], cfg)
    want, experts = moe.moe_mlp_reference(x, rt.params["layers"][0], cfg)
    trace = RouterTrace()
    with trace.on():
        moe.moe_mlp(x, rt.params["layers"][0], cfg)
    diff = (got.float() - want.float()).abs().reshape(-1, cfg.d_model)
    scale = want.float().reshape(-1, cfg.d_model).abs().amax(dim=-1, keepdim=True)
    use = (diff / (FLASH_REL * scale)).max().item()
    same = torch.equal(trace.calls[0], experts.cpu())
    if not same or use > 1.0 or not torch.isfinite(got).all():
        raise AssertionError(f"phase 9 g: moe_mlp inside the verify chunk (T={x.shape[0] * x.shape[1]}) disagrees "
                             f"with its plain version: experts equal {same}, {use:.3f} of the tolerance")
    with env_set(KAKVEDA_SPEC=1):
        rs = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok, model_label="mixtral-solo-spec", device=rt.device)
        zero_launches()
        t = time.perf_counter()
        res = rs.generate(PROMPTS[0], max_tokens=32)
        solo_wall = time.perf_counter() - t
        counts = launch_counts()
    if not res.meta.get("speculative") or counts["bf16"] <= 0 or counts["bf16"] % cfg.n_layers:
        raise AssertionError(f"phase 9 g solo: meta {res.meta}, launches {counts}")
    solo_dep = moe_departure(rt.params, cfg, tok, ids[0], greedy[0], tok.decoded[-1], "phase 9 g solo", 32)
    st = r["spec"]
    out = dict(tokens_per_s=r["tokens_per_s"], spec_chunks=r["spec_chunks"], launches=r["launches"],
               tokens_per_verify=st["emitted"] / max(st["slot_chunks"], 1), departures=[d for d in deps if d],
               moe_verify_chunk=dict(tokens=x.shape[0] * x.shape[1], experts_equal=same, tolerance_used=use,
                                     max_abs_err=diff.max().item()),
               solo=dict(tokens_per_round=res.meta["tokens_per_round"], wall_s=solo_wall, launches=counts["bf16"],
                         departure=solo_dep))
    log(f"phase 9 g: Mixtral-8x7B int8 with KAKVEDA_SERVE_SPEC={SPEC_K} (gate held open), {len(prompts)} x 32 tokens: "
        f"{r['tokens_per_s']:.1f} tokens/s, {r['spec_chunks']} verify chunks, {out['tokens_per_verify']:.3f} tokens "
        f"per verify, {r['launches']} launches; == phase 9 e's greedy tokens but for {len(out['departures'])} "
        f"departures at (logit margin, router gap) {out['departures']}; layer 0's moe_mlp in a verify chunk "
        f"(T = {out['moe_verify_chunk']['tokens']}) vs its plain version: experts equal, {use:.3f} of the tolerance; "
        f"KAKVEDA_SPEC=1 on 1 prompt: {res.meta['tokens_per_round']} tokens per round in {solo_wall:.2f} s, "
        f"departure {solo_dep} [{card}]")
    return out


# ---------------------------------------------------------------------------
# phase 14: the model families on the card
# ---------------------------------------------------------------------------

# google/gemma-2-9b's published config.json (Hugging Face Hub), the fields
# the converter reads, written out: nothing is downloaded. 42 layers of 16
# heads over 8 KV heads of head_dim 256, GeGLU of width 14336, vocab 256000,
# a 4096-token window on even layers, softcaps 50 (attention) and 30
# (logits), query_pre_attn_scalar 256 (= head_dim: the default scale).
GEMMA2_9B_HF = {
    "model_type": "gemma2", "hidden_size": 3584, "num_hidden_layers": 42, "num_attention_heads": 16,
    "num_key_value_heads": 8, "head_dim": 256, "intermediate_size": 14336, "vocab_size": 256000,
    "max_position_embeddings": 8192, "rope_theta": 10000.0, "rms_norm_eps": 1e-6, "sliding_window": 4096,
    "attn_logit_softcapping": 50.0, "final_logit_softcapping": 30.0, "query_pre_attn_scalar": 256,
    "hidden_activation": "gelu_pytorch_tanh",
}
# Phase 14 serves GEMMA2_LAYERS of the 42 layers at full width (the smoke's
# depth: ROADMAP), an even count so the 4096-token window still alternates.
# bf16 bytes: the embedding and the untied head, and one layer's matrices
# (its norms are within the check's 0.02 GB).
GEMMA2_LAYERS = 14
GEMMA2_OTHER_BYTES, GEMMA2_LAYER_BYTES = 2 * 256000 * 3584 * 2, 2 * (2 * 3584 * 4096 + 2 * 3584 * 2048 + 3 * 3584 * 14336)
FAMILY_ENGINE_WINDOW = 8192  # KAKVEDA_SERVE_WINDOW: 8 slots x 8192 rows x 14 layers of bf16 K and V = 7.5 GB
CROSS_TOKENS = 4000  # a prompt that fits the engine (bucket 4096) and decodes past the 4096-token window
CROSS_NEW = 128
LONG_TOKENS_G2 = 4700  # past 4096 tokens: the engine cannot take it (see phase_families), the solo path does,
# in 10 pieces of 512 rows after a left pad of 420, the last at pos0 4608 (phase 5's g2_prefill_piece)
FAMILY_CHUNK = 512  # KAKVEDA_PREFILL_CHUNK of the solo path


def _filler_ids(tok, n: int, seed: int) -> list:
    """``n`` token ids (BOS and n - 1 bytes of incident-log text)."""
    import random

    words = ["latency", "rose", "after", "deploy", "queue", "backlog", "citation", "missing", "retry",
             "timeout", "schema", "drift", "tenant", "region", "cache", "miss"]
    rng = random.Random(seed)
    text = ""
    while len(text) < n:
        text += " ".join(rng.choice(words) for _ in range(12)) + ". "
    ids = tok.encode(text[: n - 1])
    assert len(ids) == n
    return ids


def _write_safetensors(path: Path, tensors: dict) -> None:
    """A ``.safetensors`` file by hand: the little-endian header length, the
    JSON header (dtype, shape, byte range per tensor, padded to 8 bytes),
    then the raw little-endian data."""
    import struct

    header, blobs, off = {}, [], 0
    for name, t in tensors.items():
        b = t.contiguous().view(torch.uint8).numpy().tobytes()
        header[name] = {"dtype": {torch.bfloat16: "BF16", torch.float32: "F32"}[t.dtype],
                        "shape": list(t.shape), "data_offsets": [off, off + len(b)]}
        blobs.append(b)
        off += len(b)
    h = json.dumps(header).encode()
    h += b" " * (-len(h) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(h)) + h)
        for b in blobs:
            f.write(b)


# One small checkpoint per family phase 14 c writes: (config.json fields,
# family extras). Vocab 264, so the byte tokenizer drives them; head dims
# as the families' released models have them (Phi-3's 96, Gemma's 256).
LOADER_FAMILIES = {
    "qwen2": dict(model_type="qwen2", hidden_size=512, num_attention_heads=4, num_key_value_heads=2,
                  intermediate_size=1024, num_hidden_layers=2, rope_theta=1e6, tie_word_embeddings=False),
    "qwen3": dict(model_type="qwen3", hidden_size=256, num_attention_heads=4, num_key_value_heads=2, head_dim=128,
                  intermediate_size=512, num_hidden_layers=2, rope_theta=1e6, tie_word_embeddings=False),
    "gemma": dict(model_type="gemma", hidden_size=512, num_attention_heads=2, num_key_value_heads=1, head_dim=256,
                  intermediate_size=1024, num_hidden_layers=2),
    "gemma2": dict(model_type="gemma2", hidden_size=512, num_attention_heads=4, num_key_value_heads=2, head_dim=256,
                   intermediate_size=1024, num_hidden_layers=4, sliding_window=32, attn_logit_softcapping=50.0,
                   final_logit_softcapping=30.0, query_pre_attn_scalar=144),
    "phi3": dict(model_type="phi3", hidden_size=384, num_attention_heads=4, num_key_value_heads=4,
                 intermediate_size=1024, num_hidden_layers=2, original_max_position_embeddings=64,
                 rope_scaling={"type": "longrope",
                               "short_factor": [1.0 + 0.01 * i for i in range(48)],
                               "long_factor": [2.0 + 0.08 * i for i in range(48)]},
                 tie_word_embeddings=False),
}


def write_family_checkpoint(path: Path, family: str, seed: int) -> None:
    """``config.json`` and ``model.safetensors`` of a random checkpoint of
    ``family`` (HF tensor names and ``[out, in]`` layouts, bf16 weights;
    Gemma norms zero-centred as Gemma stores them, others near 1; Qwen2's
    biases non-zero; Phi-3's projections fused)."""
    cfg = dict(vocab_size=264, max_position_embeddings=512, rms_norm_eps=1e-6, **LOADER_FAMILIES[family])
    path.mkdir(parents=True)
    (path / "config.json").write_text(json.dumps(cfg))
    g = torch.Generator().manual_seed(seed)
    d, f, v = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    hd = cfg.get("head_dim") or d // cfg["num_attention_heads"]
    nq, nkv = cfg["num_attention_heads"] * hd, cfg["num_key_value_heads"] * hd
    gemma = family.startswith("gemma")

    def mat(out, inp):
        return (torch.randn(out, inp, generator=g) / math.sqrt(inp)).to(torch.bfloat16)

    def norm(n):
        return (torch.randn(n, generator=g) * 0.2 + (0.0 if gemma else 1.0)).to(torch.bfloat16)

    t = {"model.embed_tokens.weight": mat(v, d), "model.norm.weight": norm(d)}
    if not gemma:
        t["lm_head.weight"] = mat(v, d)
    for i in range(cfg["num_hidden_layers"]):
        pre = f"model.layers.{i}."
        t[pre + "input_layernorm.weight"] = norm(d)
        t[pre + "post_attention_layernorm.weight"] = norm(d)
        if family == "gemma2":
            t[pre + "pre_feedforward_layernorm.weight"] = norm(d)
            t[pre + "post_feedforward_layernorm.weight"] = norm(d)
        if family == "phi3":
            t[pre + "self_attn.qkv_proj.weight"] = mat(nq + 2 * nkv, d)
            t[pre + "mlp.gate_up_proj.weight"] = mat(2 * f, d)
        else:
            t[pre + "self_attn.q_proj.weight"] = mat(nq, d)
            t[pre + "self_attn.k_proj.weight"] = mat(nkv, d)
            t[pre + "self_attn.v_proj.weight"] = mat(nkv, d)
            t[pre + "mlp.gate_proj.weight"] = mat(f, d)
            t[pre + "mlp.up_proj.weight"] = mat(f, d)
        t[pre + "self_attn.o_proj.weight"] = mat(d, nq)
        t[pre + "mlp.down_proj.weight"] = mat(d, f)
        if family == "qwen2":
            for n, w in (("q", nq), ("k", nkv), ("v", nkv)):
                t[pre + f"self_attn.{n}_proj.bias"] = (torch.randn(w, generator=g) * 0.5).to(torch.bfloat16)
        if family == "qwen3":
            t[pre + "self_attn.q_norm.weight"] = norm(hd)
            t[pre + "self_attn.k_norm.weight"] = norm(hd)
    _write_safetensors(path / "model.safetensors", t)


def _leaves(params):
    out = [("embed", params["embed"]), ("final_norm", params["final_norm"]), ("lm_head", params["lm_head"])]
    out += [(f"{i}.{k}", w) for i, layer in enumerate(params["layers"]) for k, w in layer.items()]
    return out


def family_loader(base: Path, card: str) -> dict:
    """Phase 14 c: each family's checkpoint loaded onto the card by
    ``hf_convert.load_hf_checkpoint(device="cuda")`` equals the CPU load leaf
    for leaf (bit for bit, same dtype), and served by ``LlamaRuntime`` on
    the card gives the CPU runtime's greedy tokens, or departs from them
    only where the teacher-forced top-2 margin along the CPU's tokens is
    under MARGIN_TOL."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.hf_convert import load_hf_checkpoint

    out = {}
    for i, family in enumerate(LOADER_FAMILIES):
        path = base / family
        write_family_checkpoint(path, family, seed=140 + i)
        t0 = time.perf_counter()
        params, cfg = load_hf_checkpoint(str(path), device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cpu_params, cpu_cfg = load_hf_checkpoint(str(path), device="cpu")
        if cfg != cpu_cfg:
            raise AssertionError(f"phase 14 c {family}: card and CPU configs differ")
        for (name, a), (_, b) in zip(_leaves(params), _leaves(cpu_params)):
            if a.dtype != b.dtype or a.device.type != "cuda" or not torch.equal(a.cpu(), b):
                raise AssertionError(f"phase 14 c {family}: leaf {name} differs between the card and the CPU load")
        tok_card, tok_cpu = RecordingTokenizer(), RecordingTokenizer()
        ids = [tok_card.encode(p) for p in PROMPTS]
        flash_gqa_cache.launches = flash_gqa_cache.launches_kv8 = 0
        rt = LlamaRuntime(cfg=cfg, params=params, tokenizer=tok_card)
        res = rt.generate_batch(PROMPTS, max_tokens=16)
        launches = flash_gqa_cache.launches
        rt.close()
        cpu = LlamaRuntime(cfg=cpu_cfg, params=cpu_params, tokenizer=tok_cpu, device="cpu")
        cpu.generate_batch(PROMPTS, max_tokens=16)
        cpu.close()
        if not all(r.meta.get("continuous") for r in res) or launches <= 0:
            raise AssertionError(f"phase 14 c {family}: not served through the engine's kernel ({launches} launches)")
        margins = [margin_rule(params, cfg, tok_card, p_ids, ref, got, f"phase 14 c {family}", 16)
                   for p_ids, ref, got in zip(ids, tok_cpu.decoded, tok_card.decoded)]
        departed = [round(m, 4) for m in margins if m is not None]
        out[family] = dict(head_dim=cfg.head_dim, load_s=load_s, launches=launches,
                           tokens=sum(map(len, tok_card.decoded)), departures=departed)
        log(f"phase 14 c {family}: head_dim {cfg.head_dim}, loaded onto the card in {load_s:.3f} s, leaves == the "
            f"CPU load's; {out[family]['tokens']} greedy tokens through the engine ({launches} flash launches), "
            f"card == CPU but for {len(departed)} departures at margins {departed} (< {MARGIN_TOL}) [{card}]")
        del rt, cpu, params, cpu_params
    return out


def phase_families(card: str) -> dict:
    """Phase 14: a. Gemma-2-9B width and depth, bf16 weights drawn on the
    card, through ``LlamaRuntime`` -> ``ServingEngine`` (8 slots, window
    8192): 8 prompts, and a 4,000-token prompt (bucket 4096) that decodes
    past the 4,096-token window, launch counts zeroed before and read after;
    tokens held to the runtime's solo ``DecodeSession`` path by the margin
    rule; a 4,700-token prompt through the solo path in 512-row pieces
    (``_encode`` keeps the last max_seq_len // 2 = 4096 tokens of a text,
    and a bucket of 8192 leaves no decode room in a window of 8192, so no
    prompt past 4,096 tokens enters the engine: the JAX package's
    arithmetic too) held to one single-shot pass; admission and decode-step
    times beside the weight-read bound. b. The same weights with
    ``KAKVEDA_KV_QUANT=int8``. c. The loader (``family_loader``)."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.hf_convert import hf_config_to_llama

    log_held("phase 9, before phase 14")
    cfg = dataclasses.replace(hf_config_to_llama(GEMMA2_9B_HF), n_layers=GEMMA2_LAYERS)
    if (cfg.head_dim, cfg.attn_softcap, cfg.query_scale, cfg.layer_window(0), cfg.layer_window(1)) != (256, 50.0, 0.0, 4096, 0):
        raise AssertionError(f"phase 14: the converter mapped Gemma-2-9B to {cfg}")
    tok = RecordingTokenizer()
    ids = [tok.encode(p) for p in PROMPTS]
    cross = _filler_ids(tok, CROSS_TOKENS, seed=14)
    cross_text = tok._tok.decode(cross)
    long_ids = _filler_ids(tok, LONG_TOKENS_G2, seed=15)
    out = {}
    env = {"KAKVEDA_SERVE_WINDOW": str(FAMILY_ENGINE_WINDOW), "KAKVEDA_PREFILL_CHUNK": str(FAMILY_CHUNK)}
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        t0 = time.perf_counter()
        rt = LlamaRuntime(cfg=cfg, seed=0, tokenizer=tok)
        torch.cuda.synchronize()
        n_bytes = param_bytes(rt.params)
        read_bytes = n_bytes - rt.params["embed"].numel() * rt.params["embed"].element_size()
        log(f"phase 14 a: Gemma-2-9B width, {cfg.n_layers} of its {GEMMA2_9B_HF['num_hidden_layers']} layers, "
            f"{n_bytes / 1e9:.2f} GB of bf16 weights "
            f"({n_bytes // 2 / 1e9:.2f} G parameters) drawn on {rt.device} in {time.perf_counter() - t0:.1f} s; "
            f"a decode step reads {read_bytes / 1e9:.2f} GB of them (the embedding is gathered)")
        want_bytes = GEMMA2_OTHER_BYTES + cfg.n_layers * GEMMA2_LAYER_BYTES  # 20.32e9 at 42 layers
        if rt.device.type != "cuda" or abs(n_bytes - want_bytes) > 0.02e9:
            raise AssertionError(f"phase 14: model on {rt.device} with {n_bytes} bytes")
        for kvq in ("", "int8"):
            tag = kvq or "bf16"
            rq = rt
            if kvq:
                os.environ["KAKVEDA_KV_QUANT"] = kvq
                try:
                    rq = LlamaRuntime(cfg=cfg, params=rt.params, tokenizer=tok)
                finally:
                    del os.environ["KAKVEDA_KV_QUANT"]
            eng = rq.engine()
            if (eng.cb.B, eng.cb.max_len, rq.cfg.kv_quant) != (8, FAMILY_ENGINE_WINDOW, kvq):
                raise AssertionError(f"phase 14 {tag}: engine {eng.cb.B} x {eng.cb.max_len}, cache {rq.cfg.kv_quant!r}")
            rq.generate_batch(PROMPTS[:2], max_tokens=4)  # warm-up
            n_short = 32 if not kvq else 16
            batch = PROMPTS if not kvq else PROMPTS[:4]
            tok.decoded.clear()
            flash_gqa_cache.launches = flash_gqa_cache.launches_kv8 = 0
            f0 = eng.cb.forwards
            t = time.perf_counter()
            res = rq.generate_batch(batch, max_tokens=n_short)
            cross_res = rq.generate(cross_text, max_tokens=CROSS_NEW)
            wall = time.perf_counter() - t
            n_fwd = eng.cb.forwards - f0
            mine, other = flash_gqa_cache.launches, flash_gqa_cache.launches_kv8
            if kvq:
                mine, other = other, mine
            got = list(tok.decoded)
            rq.close()
            del eng  # its KV pool goes before the next one is built
            if mine != cfg.n_layers * n_fwd or other != 0:
                raise AssertionError(f"phase 14 {tag}: {mine} launches for {n_fwd} forwards, {other} of the other body")
            if not all(r.meta.get("continuous") for r in res + [cross_res]):
                raise AssertionError(f"phase 14 {tag}: a request did not run through the engine")
            n_tok = sum(len(g) for g in got)
            # The solo path on the same requests: one DecodeSession for the
            # batch, one for the crossing prompt (prefilled in 512-row pieces).
            solo = rq._generate_ids_chunked([ids[i] for i in range(len(batch))], n_short)
            solo += rq._generate_ids_chunked([cross], CROSS_NEW)
            margins = [margin_rule(rq.params, rq.cfg, tok, p, ref, g, f"phase 14 {tag} engine vs solo", n)
                       for p, ref, g, n in zip(ids[: len(batch)] + [cross], solo, got,
                                               [n_short] * len(batch) + [CROSS_NEW])]
            departed = [round(m, 4) for m in margins if m is not None]
            crossed = len(cross) + len(got[-1]) - 1 > cfg.sliding_window
            out[tag] = dict(launches=mine, forwards=n_fwd, tokens=n_tok, wall_s=wall, tokens_per_s=n_tok / wall,
                            prompt_lens=sorted({len(i) for i in ids[: len(batch)]}) + [len(cross)],
                            cross_tokens=len(got[-1]), crossed_window=crossed, departures=departed)
            log(f"phase 14 {'a' if not kvq else 'b'} ({tag} cache): generate_batch of {len(batch)} prompts x {n_short} "
                f"tokens and one {len(cross)}-token prompt x {CROSS_NEW} through the engine (its last position "
                f"{len(cross) + len(got[-1]) - 1}: past the {cfg.sliding_window}-token window {crossed}) in "
                f"{wall:.2f} s: {n_tok} tokens, {n_tok / wall:.1f} tokens/s; {n_fwd} forwards, {mine} flash launches; "
                f"engine == solo DecodeSession path but for {len(departed)} departures at solo margins {departed} "
                f"(< {MARGIN_TOL}) [{card}]")
            if not crossed:
                raise AssertionError(f"phase 14 {tag}: the crossing prompt stopped before the window")
            if kvq:
                del rq
        # The 4,700-token prompt: the runtime's solo path, 512-row pieces,
        # against a single-shot prefill of the prompt then its tokens
        # teacher-forced in one more piece.
        from kakveda_tpu_torch.models.llama import decode_step, init_cache, mask_pad_vocab

        flash_gqa_cache.launches = 0
        t = time.perf_counter()
        (long_out,) = rt._generate_ids_chunked([long_ids], 16)
        torch.cuda.synchronize()
        long_s = time.perf_counter() - t
        long_launches = flash_gqa_cache.launches
        cache = init_cache(rt.cfg, 1, len(long_ids) + len(long_out), device="cuda")
        first, _ = decode_step(rt.params, rt.cfg, torch.tensor([long_ids], device="cuda"), cache, last_only=True)
        rest, _ = decode_step(rt.params, rt.cfg, torch.tensor([long_out[:-1]], device="cuda"), cache)
        lg = mask_pad_vocab(torch.cat([first[0], rest[0]]), rt.cfg)[:, : tok.vocab_size]
        del cache
        top2 = lg.topk(2, dim=-1)
        single = top2.indices[:, 0].tolist()
        gaps = (top2.values[:, 0] - top2.values[:, 1]).tolist()
        # Teacher-forced along the chunked path's tokens: every step stands
        # alone, and each may differ only at a near-tie.
        differ = [j for j, (x, y) in enumerate(zip(single, long_out)) if x != y]
        n_eq = len(long_out) - len(differ)
        if any(gaps[j] >= MARGIN_TOL for j in differ):
            raise AssertionError(f"phase 14 a long: chunked {long_out} differs from single-shot {single} at steps "
                                 f"{differ}, margins {[gaps[j] for j in differ]}")
        out["long_prompt"] = dict(prompt_len=len(long_ids), tokens=len(long_out), wall_s=long_s, equal_steps=n_eq,
                                  launches=long_launches)
        log(f"phase 14 a: a {len(long_ids)}-token prompt through the solo DecodeSession path "
            f"(KAKVEDA_PREFILL_CHUNK={FAMILY_CHUNK}: {-(-len(long_ids) // FAMILY_CHUNK)} pieces, the last at pos0 "
            f"{(-(-len(long_ids) // FAMILY_CHUNK) - 1) * FAMILY_CHUNK}) x {len(long_out)} tokens in {long_s:.2f} s, "
            f"{long_launches} flash launches; equal to the single-shot pass's argmax for {n_eq} of "
            f"{len(long_out)} steps (a departure only at a margin under {MARGIN_TOL}) [{card}]")
        step_times(rt, ids, out, read_bytes, "phase 14 a: Gemma-2-9B", card, max_len=FAMILY_ENGINE_WINDOW)
        rt.close()
        del rt
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    with tempfile.TemporaryDirectory(prefix="kakveda-ckpts-") as d:
        out["loader"] = family_loader(Path(d), card)
    log("phase 14: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 10: the LLM judge on the ingest path
# ---------------------------------------------------------------------------

JUDGE_ASKS = [  # citation-asking prompts that start differently: the batch's common head is the judge head
    "Summarize incident {i} and include citations.",
    "Explain outage {i} with references to the sources.",
    "Write a brief on service {i} and cite your sources.",
    "List what caused failure {i}, with citations.",
]
FILLER = ("the system reported that latency rose after deploy while Smith noted a queue backlog and "
          "operators restarted workers but errors persisted across regions for hours").split()


def judge_traffic(TracePayload, n: int, seed: int = 10):
    """``n`` traces from a seed: 1 in 8 ambiguous (a citation-asking prompt, a
    response with no citation marker, prompt + response drawn over 200-760
    bytes), 4 in 8 rule-positive (a citation-asking prompt answered with the
    stub's citations), 3 in 8 benign. ASCII, so bytes are characters."""
    import random

    rng = random.Random(seed)
    out = []
    for i in range(n):
        kind, app = i % 8, f"app-{i % 5}"
        if kind == 7:
            prompt = JUDGE_ASKS[rng.randrange(len(JUDGE_ASKS))].format(i=i)
            total = rng.randint(200, 760)
            words = []
            while len(" ".join(words)) < total - len(prompt):
                words.append(rng.choice(FILLER))
            out.append(_trace(TracePayload, i, app, prompt, " ".join(words)[: total - len(prompt)]))
        elif kind < 4:
            out.append(_trace(TracePayload, i, app, f"Summarize report {i} and include citations"))
        else:
            out.append(_trace(TracePayload, i, app, f"What is the status of job {i}?", f"Job {i} is running."))
    return out


JUDGE_WINDOW = 2048  # arm A's KAKVEDA_SERVE_WINDOW
JUDGE_PREFIX_MAX = 4  # KAKVEDA_SERVE_PREFIX_MAX
JUDGE_CHUNK = 256  # arm B's KAKVEDA_PREFILL_CHUNK
JUDGE_MAX_TOKENS = 4  # TieredClassifier's max_tokens


def judge_batches() -> list:
    """The token ids ``TieredClassifier`` submits per ingest batch of phase
    10's traffic: the rule tier's ambiguous traces, each wrapped in the judge
    template and encoded as ``LlamaRuntime`` encodes for Llama-3-8B."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.models.tokenizer import ByteTokenizer
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT, RuleClassifier, TieredClassifier, _wants_citations

    tok, keep = ByteTokenizer(), LlamaConfig.llama3_8b().max_seq_len // 2
    cut = TieredClassifier.max_judge_chars
    traces, out = judge_traffic(TracePayload, 4 * 512), []
    for b in range(4):
        batch = traces[512 * b: 512 * (b + 1)]
        rule = RuleClassifier().classify_batch(batch)
        out.append([tok.encode(_JUDGE_PROMPT.format(prompt=t.prompt[:cut], response=t.response[:cut]))[-keep:]
                    for t, sig in zip(batch, rule) if sig is None and _wants_citations(t.prompt)])
    return out


def expected_prefix_stats(head, batches, max_len: int, maxp: int, admissions=None) -> dict:
    """``ContinuousBatcher``'s prefix rules replayed in plain Python over the
    token ids the judge submitted: the judge head registered first, then per
    ``generate_batch`` call its common head (two or more prompts, 16 or more
    tokens), then each admission in submission order. A prefix registers when
    8 <= len and len + 9 < the window; the longest registered prefix of a
    prompt matches and moves to the end of the LRU order (KAKVEDA_SERVE_PREFIX_
    MAX entries); the match reuses split = p - sw rows when positive, sw the
    power of two (floor 8) >= p - len(prefix). ``admissions``, when given,
    gets (p, sw, split) per admission, sw None for one admitted whole."""
    from collections import OrderedDict

    store, stats = OrderedDict(), dict(registered=0, hits=0, hit_tokens_saved=0)

    def register(ids):
        ids = tuple(ids)
        if len(ids) < 8 or len(ids) + 9 >= max_len or ids in store:
            return
        while len(store) >= max(1, maxp):
            store.popitem(last=False)
        store[ids] = True
        stats["registered"] += 1

    register(head)
    for ids_list in batches:
        if len(ids_list) >= 2:
            common = os.path.commonprefix(ids_list)
            if len(common) >= 16:
                register(common)
        for ids in ids_list:
            best = max((pe for pe in store if len(ids) >= len(pe) and tuple(ids[: len(pe)]) == pe),
                       key=len, default=None)
            sw = None
            if best is not None:
                store.move_to_end(best)
                sw = 8
                while sw < len(ids) - len(best):
                    sw <<= 1
                if len(ids) - sw > 0:
                    stats["hits"] += 1
                    stats["hit_tokens_saved"] += len(ids) - sw
                else:
                    sw = None
            if admissions is not None:
                admissions.append((len(ids), sw, len(ids) - sw if sw else 0))
    return stats


def forced_last_logits(params, cfg, prompt_ids, toks):
    """The solo next-token logits [V] after ``prompt_ids + toks``, teacher-
    forced: one pass, or under Phi-3 longrope the prompt then one decode
    step per token. A longrope row's regime follows the running length, so
    decode rotates the prompt's keys with the short factors once and for
    all, where one pass over a sequence past the original context would
    rotate every position with the long ones: another function."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache

    cache = init_cache(cfg, 1, len(prompt_ids) + len(toks), device="cuda")
    head = list(prompt_ids) + ([] if cfg.rope_dim_factors_long else list(toks))
    logits, _ = decode_step(params, cfg, torch.tensor([head], device="cuda"), cache, last_only=True)
    for t in toks if cfg.rope_dim_factors_long else []:
        logits, _ = decode_step(params, cfg, torch.tensor([[t]], device="cuda"), cache)
    return logits[0, -1]


def margin_rule(params, cfg, tok, prompt_ids, ref, got, what: str, n_max: int = 4):
    """Phase 6's token rule: ``got`` equals ``ref`` (each closed with EOS when
    it stopped before ``n_max`` tokens), or first departs from it at a step
    whose solo top-2 margin along ``ref`` (teacher-forced,
    ``forced_last_logits``) is under MARGIN_TOL. Returns None when equal,
    else the margin at the departure."""
    from kakveda_tpu_torch.models.llama import mask_pad_vocab

    a = list(ref) + ([tok.EOS] if len(ref) < n_max else [])
    b = list(got) + ([tok.EOS] if len(got) < n_max else [])
    n = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
    if n is None:
        return None
    top2 = mask_pad_vocab(forced_last_logits(params, cfg, prompt_ids, a[:n]), cfg)[: tok.vocab_size].topk(2).values
    margin = (top2[0] - top2[1]).item()
    if margin >= MARGIN_TOL:
        raise AssertionError(f"{what}: tokens {b} depart from {a} at step {n}, where the solo margin is "
                             f"{margin:.4f} >= {MARGIN_TOL}")
    return margin


def ingest_timed(plat, traces, batch: int = 512):
    """``ingest_batch`` in batches of ``batch``, the card synchronized at both
    ends: (signals per batch, traces/s, wall per batch in s)."""
    sigs, walls = [], []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for lo in range(0, len(traces), batch):
        t = time.perf_counter()
        sigs.append(asyncio.run(plat.ingest_batch(traces[lo: lo + batch])))
        walls.append(time.perf_counter() - t)
    torch.cuda.synchronize()
    return sigs, len(traces) / (time.perf_counter() - t0), walls


def judge_admissions(rt, tok, head, card: str) -> dict:
    """One prefix-hit admission per cache type against the same prompt
    admitted whole (``KAKVEDA_SERVE_PREFIX=0``) on batchers of the engine's
    window (2048): a 560-token judge prompt (bucket 1024, left pad 464, sw
    512, split 48: phase 5's prefix_admission shape). Host ms (the card
    synchronized) and device ms (CUDA events) per admission, medians of 4;
    then 4 tokens each, held by ``margin_rule``."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.models.serving import ContinuousBatcher
    from kakveda_tpu_torch.pipeline.classifier import _JUDGE_PROMPT

    prompt = "Summarize incident 7 and include citations."
    text = _JUDGE_PROMPT.format(prompt=prompt, response="x" * (298 - len(prompt)))
    ids = tok.encode(text)
    if len(ids) != 560:
        raise AssertionError(f"the admission prompt is {len(ids)} tokens, not 560")
    out, launches = {}, {}
    for kvq in ("", "int8"):
        tag = kvq or "bf16"
        toks, times = {}, {}
        for use in ("1", "0"):
            os.environ["KAKVEDA_SERVE_PREFIX"] = use
            try:
                counter = "launches_kv8" if kvq else "launches"
                flash_gqa_cache.launches = 0
                flash_gqa_cache.launches_kv8 = 0
                cb = ContinuousBatcher(rt.params, dataclasses.replace(rt.cfg, kv_quant=kvq), batch_slots=4,
                                       max_len=2048, chunk_steps=4, eos_id=None)
                cb.register_prefix(head)
                host, dev = [], []
                for _ in range(4):
                    torch.cuda.synchronize()
                    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                    t = time.perf_counter()
                    start.record()
                    cb.admit(ids, max_new_tokens=4)
                    end.record()
                    torch.cuda.synchronize()
                    host.append((time.perf_counter() - t) * 1e3)
                    dev.append(start.elapsed_time(end))
                want = (4, 4 * 48) if use == "1" else (0, 0)
                got = (cb.prefix_stats["hits"], cb.prefix_stats["hit_tokens_saved"])
                if got != want:
                    raise AssertionError(f"{tag} KAKVEDA_SERVE_PREFIX={use}: hits, saved {got} != {want}")
                while cb.active:
                    cb.step()
                launched = getattr(flash_gqa_cache, counter)
                both = flash_gqa_cache.launches + flash_gqa_cache.launches_kv8
                if launched != rt.cfg.n_layers * cb.forwards or both != launched:
                    raise AssertionError(f"{tag}: {launched} flash launches for {cb.forwards} forwards")
                launches[tag] = launches.get(tag, 0) + launched
                fwd_ms = admission_forward_ms(cb, ids, use == "1")
                rows = [cb.results[r] for r in sorted(cb.results)]
                if any(r != rows[0] for r in rows):
                    raise AssertionError(f"{tag}: four admissions of one prompt decoded differently: {rows}")
                toks[use] = rows[0]
                times[use] = (statistics.median(host), statistics.median(dev), fwd_ms)
                del cb
            finally:
                del os.environ["KAKVEDA_SERVE_PREFIX"]
        margin = margin_rule(rt.params, dataclasses.replace(rt.cfg, kv_quant=kvq), tok, ids, toks["0"], toks["1"],
                             f"phase 10 prefix-hit admission, {tag} cache")
        out[tag] = dict(hit_host_ms=times["1"][0], hit_events_ms=times["1"][1], hit_forward_graph_ms=times["1"][2],
                        whole_host_ms=times["0"][0], whole_events_ms=times["0"][1],
                        whole_forward_graph_ms=times["0"][2], tokens_equal=margin is None, departure_margin=margin)
        log(f"phase 10 admission of a 560-token judge prompt, {tag} cache: with the prefix (S=512 at "
            f"pos0=512) {times['1'][0]:.2f} ms host / {times['1'][1]:.2f} ms between CUDA events / "
            f"{times['1'][2]:.2f} ms device in its forward's graph replay; whole (S=1024 at pos0=0) "
            f"{times['0'][0]:.2f} / {times['0'][1]:.2f} / {times['0'][2]:.2f} ms (hit / whole: events "
            f"{times['1'][1] / times['0'][1]:.3f}, graph {times['1'][2] / times['0'][2]:.3f}); tokens "
            + ("equal" if margin is None else f"depart at a near-tie (margin {margin:.4f})") + f" [{card}]")
        torch.cuda.empty_cache()
    out["launches"] = launches
    return out


def admission_forward_ms(cb, ids, use_prefix: bool) -> float:
    """Device time of one admission's forward alone, replayed from a CUDA
    graph (so the eager wrappers' host time is not counted): the prompt
    whole at its bucket from row 0, or with the matching prefix's slab in
    the scratch cache and only the suffix from row off + split."""
    from kakveda_tpu_torch.models.llama import decode_step, init_cache

    p = len(ids)
    bucket = cb.bucket_for(p, cb.max_len)
    off = bucket - p
    kv = torch.zeros((1, cb.max_len), dtype=torch.bool, device="cuda")
    kv[0, off:bucket] = True
    offs = torch.tensor([off], device="cuda")
    scratch = init_cache(cb.cfg, batch=1, max_len=cb.max_len, device="cuda")
    pos, toks = 0, [0] * off + list(ids)
    if use_prefix:
        pe, split, _ = cb._match_prefix(list(ids))
        for key, slabs in pe.kv.items():
            for sk, pk in zip(scratch[key], slabs):
                sk[:, :, off: off + len(pe.ids)] = pk
        pos, toks = off + split, list(ids[split:])
    tt = torch.tensor([toks], device="cuda")

    def fwd():
        scratch["pos"] = pos
        decode_step(cb.params, cb.cfg, tt, scratch, kv_valid=kv, pos_offset=offs, last_only=True)

    ms = graph_ms(fwd, n=2)
    del scratch
    return ms


def phase_judge(base: Path, fused_topk, card: str) -> dict:
    """Phase 10: the LLM judge on the ingest path, the Platform's 2^20 x 2048
    index and Llama-3-8B (random bf16 weights from seed 0) on one card."""
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.index.gfkb import fallback_total
    from kakveda_tpu_torch.models import generate as G
    from kakveda_tpu_torch.models import runtime as R
    from kakveda_tpu_torch.models.attention import flash_gqa_cache
    from kakveda_tpu_torch.pipeline.classifier import (
        _JUDGE_PROMPT, RuleClassifier, TieredClassifier, _wants_citations, parse_judge_verdict)
    from kakveda_tpu_torch.platform import Platform

    out = {}
    traces = judge_traffic(TracePayload, 4 * 512)
    torch.cuda.reset_peak_memory_stats()

    # Rule-only, the same traces, on a fresh Platform: the comparison arm.
    plat = Platform(data_dir=base / "rule", capacity=ROWS, dim=DIM)
    if not isinstance(plat.classifier, RuleClassifier):
        raise AssertionError("without KAKVEDA_CLASSIFIER the Platform must classify by rule")
    rule_sigs, out["ingest_rule_only_traces_per_s"], _ = ingest_timed(plat, traces)
    plat.close()
    del plat
    gc.collect()
    torch.cuda.empty_cache()

    env = dict(KAKVEDA_CLASSIFIER="tiered", KAKVEDA_MODEL_RUNTIME="torch", KAKVEDA_LLAMA_PRESET="8b",
               KAKVEDA_SERVE_WINDOW=str(JUDGE_WINDOW), KAKVEDA_SERVE_PREFIX_MAX=str(JUDGE_PREFIX_MAX))
    saved = {k: os.environ.get(k) for k in (*env, "KAKVEDA_PREFILL_CHUNK")}
    os.environ.update(env)
    os.environ.pop("KAKVEDA_PREFILL_CHUNK", None)
    R.clear_runtimes()
    try:
        t0 = time.perf_counter()
        plat = Platform(data_dir=base / "judge", capacity=ROWS, dim=DIM)
        torch.cuda.synchronize()
        rt = plat.classifier.runtime
        if not (isinstance(plat.classifier, TieredClassifier) and isinstance(rt, G.LlamaRuntime)
                and rt.device == plat.device and rt.params["embed"].device.type == "cuda"
                and rt.cfg.n_layers == 32 and abs(param_bytes(rt.params) - 16.06e9) < 0.01e9):
            raise AssertionError("KAKVEDA_CLASSIFIER=tiered did not put Llama-3-8B beside the index")
        log(f"phase 10: Platform(2^20 x 2048) and Llama-3-8B ({param_bytes(rt.params) / 1e9:.2f} GB) on "
            f"{plat.device}, up in {time.perf_counter() - t0:.1f} s")
        tok = rt.tokenizer = RecordingTokenizer()
        head = tok.encode(_JUDGE_PROMPT.split("{prompt}")[0])
        if len(head) != 69:
            raise AssertionError(f"the judge head is {len(head)} tokens, not 69")
        eng = rt.engine()
        if (eng.cb.B, eng.cb.max_len) != (8, JUDGE_WINDOW):
            raise AssertionError(f"engine of {eng.cb.B} slots, window {eng.cb.max_len}")

        calls = []
        real_batch, real_reg = rt.generate_batch, rt.register_prefix

        def recorded_batch(prompts, **kw):
            tok.decoded.clear()
            t = time.perf_counter()
            res = real_batch(prompts, **kw)
            calls.append(dict(prompts=list(prompts), results=res, tokens=list(tok.decoded),
                              wall_s=time.perf_counter() - t))
            return res

        reg_ms = []

        def recorded_reg(prefix):
            t = time.perf_counter()
            ok = real_reg(prefix)
            torch.cuda.synchronize()
            reg_ms.append((time.perf_counter() - t) * 1e3)
            return ok

        rt.generate_batch, rt.register_prefix = recorded_batch, recorded_reg
        flash_gqa_cache.launches = 0
        flash_gqa_cache.launches_kv8 = 0
        f0 = eng.cb.forwards
        sigs, out["ingest_judge_traces_per_s"], walls = ingest_timed(plat, traces)
        n_fwd = eng.cb.forwards - f0
        launches, other = flash_gqa_cache.launches, flash_gqa_cache.launches_kv8
        if launches != 32 * n_fwd or other != 0 or n_fwd == 0:
            raise AssertionError(f"arm A: {launches} flash launches ({other} int8) for {n_fwd} forwards")
        if len(calls) != 4 or len(reg_ms) != 1:
            raise AssertionError(f"{len(calls)} judge calls, {len(reg_ms)} registrations")
        ids_per_call = [[rt._encode(p) for p in c["prompts"]] for c in calls]
        if ids_per_call != judge_batches():  # phase 5 held the kernel at the shapes these give
            raise AssertionError("the judge's prompts are not the ones phase 5 took its flash shapes from")
        stats = dict(eng.cb.prefix_stats)
        want = expected_prefix_stats(head, ids_per_call, JUDGE_WINDOW, JUDGE_PREFIX_MAX)
        if stats != want or stats["hits"] == 0 or stats["hits"] == sum(map(len, ids_per_call)):
            raise AssertionError(f"prefix stats {stats} != {want} worked out from the prompt lengths")
        if not all(r.meta.get("continuous") for c in calls for r in c["results"]):
            raise AssertionError("a judge result of arm A did not come through the engine")
        # The signals: the rule's verdicts plus parse_judge_verdict over the texts.
        n_yes = 0
        for b, (c, got) in enumerate(zip(calls, sigs)):
            batch = traces[512 * b: 512 * (b + 1)]
            rule = RuleClassifier().classify_batch(batch)
            amb = [i for i, (t, s) in enumerate(zip(batch, rule)) if s is None and _wants_citations(t.prompt)]
            if len(amb) != 64 or len(c["results"]) != 64 or len(c["tokens"]) != 64:
                raise AssertionError(f"batch {b}: {len(amb)} ambiguous traces, {len(c['results'])} verdicts")
            yes = {batch[i].trace_id for i, r in zip(amb, c["results"]) if parse_judge_verdict(r.text)}
            n_yes += len(yes)
            want_ids = {batch[i].trace_id for i, s in enumerate(rule) if s is not None} | yes
            if {s.trace_id for s in got} != want_ids:
                raise AssertionError(f"batch {b}: the judged signals are not the rule's plus the YES verdicts")
        # The stream's end state (the phase 4 checks): one record per failure,
        # the cluster state current, patterns and health for every app.
        n_fail = sum(map(len, sigs))
        st = plat.gfkb.mine_state_info()
        if plat.gfkb.count != n_fail or n_fail != sum(map(len, rule_sigs)) + n_yes:
            raise AssertionError(f"GFKB holds {plat.gfkb.count} records for {n_fail} failures")
        if not (st.get("enabled") and not st["stale"] and st["covers_all_rows"] and st["delta_dispatches"] >= 4):
            raise AssertionError(f"mining state after the judged stream: {st}")
        pats, info = plat.mine()
        if info["mode"] != "incremental" or not pats or not plat.patterns_list():
            raise AssertionError(f"mine after the judged stream: {info}")
        for app in sorted({t.app_id for t in traces}):
            pts = plat.health_points(app)
            if not pts or not all(0.0 <= p.score <= 100.0 for p in pts):
                raise AssertionError(f"{app}: health {pts[-1:] if pts else 'missing'}")
        # The warn that follows, on the same card.
        fused_topk.launches = 0
        reqs = [WarningRequest(app_id="z", prompt=f"Summarize report {i * 31} and include citations",
                               tools=[], env={"os": "linux"}) for i in range(64)]
        fb0 = fallback_total()
        res = plat.warn_batch(reqs)
        if (len(res) != 64 or fused_topk.launches < 1 or not all(r.confidence > 0.5 for r in res)
                or any(r.degraded for r in res) or fallback_total() != fb0):
            raise AssertionError(f"warn_batch after the judged stream: {fused_topk.launches} launches, "
                                 f"{sum(r.degraded for r in res)} degraded, fallback {fallback_total() - fb0}")
        # register_prefix once more, warm (the first one paid the first
        # forward at S = 69): another head of the judge's length.
        other = _JUDGE_PROMPT.split("{prompt}")[0].replace("applications", "applicationz")
        t = time.perf_counter()
        if not real_reg(other) or len(tok.encode(other)) != 69:
            raise AssertionError("a second 69-token head did not register")
        torch.cuda.synchronize()
        reg_ms.append((time.perf_counter() - t) * 1e3)
        out.update(
            judge_launches=launches, judge_forwards=n_fwd, warn_fused_topk_launches=fused_topk.launches,
            prefix_stats=stats, register_prefix_ms=reg_ms[0], register_prefix_warm_ms=reg_ms[1], judge_wall_s=[c["wall_s"] for c in calls],
            ingest_batch_wall_s=walls, judged_yes=n_yes, failures=n_fail,
            prompt_tokens=[min(map(len, i)) for i in ids_per_call] + [max(map(len, i)) for i in ids_per_call],
        )
        log(f"phase 10 arm A (engine, window 2048): 4 x 512 traces, {sum(map(len, ids_per_call))} judged in "
            f"{len(calls)} generate_batch calls, every result through the engine; prefix stats {stats} == the "
            f"arithmetic's; {n_fwd} forwards, {launches} flash launches; register_prefix {reg_ms[0]:.2f} ms "
            f"(the first), {reg_ms[1]:.2f} ms (warm); "
            f"judge wall per batch " + " / ".join(f"{c['wall_s']:.3f}" for c in calls) + " s; ingest "
            f"{out['ingest_judge_traces_per_s']:.1f} traces/s with the judge, "
            f"{out['ingest_rule_only_traces_per_s']:.1f} rule-only; {n_yes} YES verdicts, {n_fail} failures; "
            f"warn_batch-64 after it: {fused_topk.launches} fused_topk launches [{card}]")

        # Arm B: the same judge prompts at the default window (512), prefill in
        # pieces of 256: none fits the engine, each batch one DecodeSession.
        del os.environ["KAKVEDA_SERVE_WINDOW"]
        os.environ["KAKVEDA_PREFILL_CHUNK"] = str(JUDGE_CHUNK)
        tok_b = RecordingTokenizer()
        rt_b = G.LlamaRuntime(cfg=rt.cfg, params=rt.params, tokenizer=tok_b)
        try:
            eng_b = rt_b.engine()
            if eng_b.cb.max_len != 512 or any(eng_b.fits(len(i), 4) for ids in ids_per_call for i in ids):
                raise AssertionError("arm B: a judge prompt fits the engine at window 512")
            walls_b, departures, pieces, launches_b, other = [], [], 0, 0, 0
            for c, ids in zip(calls, ids_per_call):
                tok_b.decoded.clear()
                flash_gqa_cache.launches = 0
                flash_gqa_cache.launches_kv8 = 0
                t = time.perf_counter()
                res = rt_b.generate_batch(c["prompts"], max_tokens=JUDGE_MAX_TOKENS)
                walls_b.append(time.perf_counter() - t)
                # Read here: margin_rule's teacher-forced passes below launch it too.
                launches_b += flash_gqa_cache.launches
                other += flash_gqa_cache.launches_kv8
                if any("continuous" in r.meta for r in res):
                    raise AssertionError("arm B: a judge result came through the engine")
                width = G._prefill_width(max(map(len, ids)), JUDGE_CHUNK)
                ml = G._bucket_len(width + JUDGE_MAX_TOKENS + 1, rt.cfg.max_seq_len)
                pieces += width // JUDGE_CHUNK + min(JUDGE_MAX_TOKENS, ml - 1 - width)
                for p_ids, a, b_ in zip(ids, c["tokens"], tok_b.decoded):
                    m = margin_rule(rt.params, rt.cfg, tok, p_ids, a, b_, "phase 10 arm B vs arm A")
                    if m is not None:
                        departures.append(m)
            if launches_b != 32 * pieces or other != 0 or eng_b.cb.forwards != 0:
                raise AssertionError(f"arm B: {launches_b} flash launches ({other} int8) for {pieces} forwards")
            # Its prefill alone, in device time: the last batch, pieces of 256.
            ids = ids_per_call[-1]
            width = G._prefill_width(max(map(len, ids)), JUDGE_CHUNK)
            ml = G._bucket_len(width + JUDGE_MAX_TOKENS + 1, rt.cfg.max_seq_len)
            toks, valid, offs, _ = G._pack_prompts(ids, ml, plen=width)
            cache = G.init_cache(rt.cfg, batch=len(ids), max_len=ml, device="cuda")
            args = [torch.from_numpy(a).cuda() for a in (toks, valid, offs)]
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            G.prefill(rt.params, rt.cfg, args[0], cache, args[1], args[2], chunk=JUDGE_CHUNK)
            end.record()
            end.synchronize()
            prefill_ms = start.elapsed_time(end)
            del cache, args
        finally:
            rt_b.close()
        out.update(arm_b_wall_s=walls_b, arm_b_prefill_device_ms=prefill_ms, arm_b_prefill_width=width,
                   arm_b_cache_rows=ml, arm_b_forwards=pieces, arm_b_launches=launches_b,
                   arm_b_departures=len(departures),
                   arm_b_departure_margin_max=max(departures, default=None))
        log(f"phase 10 arm B (window 512, KAKVEDA_PREFILL_CHUNK=256): no judge prompt fits the engine; "
            f"{pieces} forwards, {launches_b} flash launches; wall per batch "
            + " / ".join(f"{w:.3f}" for w in walls_b) + f" s; the last batch's prefill ({len(ids)} prompts at "
            f"width {width}, cache {ml} rows) {prefill_ms:.2f} ms device; tokens == arm A's except "
            f"{len(departures)} prompts that depart at a near-tie (margins up to "
            f"{max(departures, default=0.0):.4f} < {MARGIN_TOL}) [{card}]")

        out["admission"] = judge_admissions(rt, tok, head, card)
        out["admission_launches"] = out["admission"].pop("launches")
        out["peak_allocated_bytes"] = torch.cuda.max_memory_allocated()
        log(f"phase 10: peak allocated with both planes resident {out['peak_allocated_bytes'] / 1e9:.2f} GB "
            f"[{card}]")
        plat.close()
    finally:
        R.clear_runtimes()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    del plat, rt
    gc.collect()
    torch.cuda.empty_cache()
    log("phase 10: " + json.dumps(out))
    return out


def _forget_apps() -> None:
    """aiohttp keeps each app's middleware-wrapped handlers in a module-level
    LRU, and the handlers hold their Platform: clear it, or a 2^20-row index
    stays on the card for the rest of the run."""
    from aiohttp import web_app

    cache = getattr(web_app, "_cached_build_middleware", None)
    if cache is not None:
        cache.cache_clear()
    gc.collect()
    torch.cuda.empty_cache()


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(round(q * (len(xs) - 1))))]


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _service_traces(TracePayload, lo: int, n: int):
    """Phase 4's trace generator, failing and passing mixed: three in four
    ask for citations and get a cited answer (a HALLUCINATION_CITATION each,
    every signature new); the fourth gets an answer with no markers."""
    return [
        _trace(TracePayload, 200_000 + i, f"app-{'ABCDEFG'[i % 7]}", f"Summarize report {i} and include citations",
               response=STUB_RESPONSE if i % 4 else "No sources were provided, so none are cited.")
        for i in range(lo, lo + n)
    ]


def _warn_body(app_id: str, prompt: str) -> dict:
    return {"app_id": app_id, "prompt": prompt, "tools": [], "env": {"os": "linux"}}


class _Tally:
    """``fused_topk`` launches of the service's own requests: the counter's
    growth summed over spans of HTTP calls, so the direct calls that check
    their answers stay out of the count."""

    def __init__(self, fused_topk):
        self.fn, self.n = fused_topk, 0

    @contextlib.contextmanager
    def span(self):
        mark = self.fn.launches
        try:
            yield
        finally:
            self.n += self.fn.launches - mark


class _DispatchSpans:
    """CUDA events around every ``topk_async_sparse`` call of ``knn`` (one
    warn batch's upload, densify, ``fused_topk`` and pack), from whichever
    thread makes it. A span also holds the host's enqueue gaps inside the
    call, so their sum bounds the card's busy time from above."""

    def __init__(self, knn):
        self.knn, self.pairs, self.lock = knn, [], threading.Lock()
        fn = knn.topk_async_sparse

        def timed(*a, **k):
            ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            ev[0].record()
            try:
                return fn(*a, **k)
            finally:
                ev[1].record()
                with self.lock:
                    self.pairs.append(ev)

        knn.topk_async_sparse = timed

    def close(self) -> float:
        """Unwrap and return the spans' summed device ms."""
        del self.knn.topk_async_sparse  # the method again
        torch.cuda.synchronize()
        return sum(a.elapsed_time(b) for a, b in self.pairs)


class _Http:
    """Phase 8's client over real TCP to ``make_app`` on a ``TCPSite``."""

    def __init__(self, session, base: str):
        self.s, self.base = session, base

    async def _post(self, path, body):
        async with self.s.post(self.base + path, json=body) as r:
            out = await r.json()
            if r.status != 200:
                raise AssertionError(f"POST {path}: {r.status} {out}")
            return out

    async def get(self, path):
        async with self.s.get(self.base + path) as r:
            out = await r.json()
            if r.status != 200:
                raise AssertionError(f"GET {path}: {r.status} {out}")
            return out

    async def ingest_batch(self, traces):
        return await self._post("/ingest/batch", {"traces": traces})

    async def warn(self, body):
        return await self._post("/warn", body)

    async def mine(self, body):
        return await self._post("/patterns/mine", body)

    async def match(self, sig):
        return await self._post("/failures/match", {"signature_text": sig})


async def _service_arms(client, plat, fused_topk, card: str) -> dict:
    """Steps a-e of phase 8 through ``client``; ``launches_service`` counts
    the ``fused_topk`` launches of their HTTP requests alone."""
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest

    out = {}
    # a. Ingest: 8 x 512 traces.
    traces = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 0, 4096)]
    n0 = plat.gfkb.count
    fused_topk.launches = 0
    tally = _Tally(fused_topk)
    t0 = time.perf_counter()
    failures = 0
    with tally.span():
        for lo in range(0, 4096, 512):
            failures += (await client.ingest_batch(traces[lo : lo + 512]))["failures"]
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if failures != plat.gfkb.count - n0 or failures != 3072:
        raise AssertionError(f"ingest: {failures} failures answered, GFKB grew {plat.gfkb.count - n0}")
    out["ingest_traces_per_s"] = 4096 / ingest_s
    log(f"phase 8 a: {failures} failures of 4096 traces in 8 batches of 512, "
        f"{out['ingest_traces_per_s']:.1f} traces/s end to end [{card}]")

    # b. One client: 256 warns, half of ingested signatures, half new.
    seen = [i for i in range(4096) if i % 4][:128]
    b_bodies = [_warn_body(f"app-{'ABCDEFGH'[j % 8]}", f"Summarize report {i} and include citations")
                for j, i in enumerate(seen)]
    b_bodies += [_warn_body(f"app-{'ABCDEFGH'[j % 8]}", f"Translate poem {j} into French verse")
                 for j in range(128)]
    order = [x for pair in zip(b_bodies[:128], b_bodies[128:]) for x in pair]
    lat_b, res_b = [], []
    with tally.span():
        await client.warn(order[0])  # warm the handler path
        for body in order:
            t = time.perf_counter()
            res_b.append(await client.warn(body))
            lat_b.append((time.perf_counter() - t) * 1e3)
    out["warn_c1_p50_ms"], out["warn_c1_p99_ms"] = _pct(lat_b, 0.5), _pct(lat_b, 0.99)
    log(f"phase 8 b: /warn at concurrency 1, 256 requests: p50 {out['warn_c1_p50_ms']:.3f} ms, "
        f"p99 {out['warn_c1_p99_ms']:.3f} ms [{card}]")

    # c. 64 clients x 16 warns; fused_topk is the card's only caller here.
    c_bodies = [[_warn_body(f"app-{'ABCDEFGH'[c % 8]}",
                            f"Summarize report {(c * 16 + j) * 3 + 1} and include citations" if j % 2 == 0
                            else f"Client {c} asks {j} about a new topic") for j in range(16)] for c in range(64)]
    lat_c = [[] for _ in range(64)]
    res_c = [[None] * 16 for _ in range(64)]

    async def one_client(c):
        for j, body in enumerate(c_bodies[c]):
            t = time.perf_counter()
            res_c[c][j] = await client.warn(body)
            lat_c[c].append((time.perf_counter() - t) * 1e3)

    spans = _DispatchSpans(plat.gfkb._knn)
    mark = fused_topk.launches
    try:
        with tally.span():
            t0 = time.perf_counter()
            await asyncio.gather(*[one_client(c) for c in range(64)])
            wall = time.perf_counter() - t0
    finally:
        span_ms = spans.close()
    launches = fused_topk.launches - mark
    flat = [x for xs in lat_c for x in xs]
    if not (1024 // 64 <= launches < 1024) or len(spans.pairs) != launches:
        raise AssertionError(f"1024 concurrent warns took {launches} fused_topk launches "
                             f"in {len(spans.pairs)} dispatches")
    out.update(warn_c64_p50_ms=_pct(flat, 0.5), warn_c64_p99_ms=_pct(flat, 0.99), warn_c64_per_s=1024 / wall,
               warn_c64_launches=launches, warn_c64_requests_per_launch=1024 / launches,
               warn_c64_dispatch_device_ms=span_ms, warn_c64_dispatch_span_share=span_ms / (wall * 1e3))
    log(f"phase 8 c: /warn at concurrency 64, 64 x 16 requests: p50 {out['warn_c64_p50_ms']:.3f} ms, "
        f"p99 {out['warn_c64_p99_ms']:.3f} ms, {out['warn_c64_per_s']:.1f} warns/s, {launches} fused_topk "
        f"launches, {out['warn_c64_requests_per_launch']:.2f} requests per launch; the batches' device "
        f"dispatches (upload, densify, fused_topk, pack; CUDA events) span {span_ms:.3f} ms of the arm's "
        f"{wall * 1e3:.3f} ms ({100 * out['warn_c64_dispatch_span_share']:.2f} %) [{card}]")

    # c, the tracer's cost: 64 x 16 warns at the tracer's head sampling 1
    # (the default, every span recorded) and 0 (what KAKVEDA_TRACE_SAMPLE=0
    # sets at import: spans counted, none recorded), in turns 1, 0, 0, 1.
    # Not in the tally: phase 8's launch count stays comparable.
    from kakveda_tpu_torch.core import trace

    tracer = trace.get_tracer()
    sample0, by_rate = tracer.sample, {1.0: [], 0.0: []}
    try:
        for rate in (1.0, 0.0, 0.0, 1.0):
            tracer.sample = rate
            by_rate[rate].append(await _warn_clients(client._post, 64, 16))
    finally:
        tracer.sample = sample0
    on, off = (statistics.mean(r["warns_per_s"] for r in by_rate[x]) for x in (1.0, 0.0))
    out["trace_cost"] = dict(sample1=by_rate[1.0], sample0=by_rate[0.0], warns_per_s_sample1=on,
                             warns_per_s_sample0=off, cost=1.0 - on / off)
    log(f"phase 8 c, the tracer's cost: 64 x 16 /warn in turns at head sampling 1, 0, 0, 1: "
        f"{[round(r['warns_per_s'], 1) for r in by_rate[1.0]]} warns/s at 1 (p50 "
        f"{[round(r['p50_ms'], 3) for r in by_rate[1.0]]} ms) against {[round(r['warns_per_s'], 1) for r in by_rate[0.0]]} "
        f"at 0 (p50 {[round(r['p50_ms'], 3) for r in by_rate[0.0]]} ms): recording every span costs "
        f"{100 * out['trace_cost']['cost']:.2f} % of the warns/s [{card}]")

    # d. The read routes agree with the platform, then every answer equals
    # a direct warn_batch of the same requests.
    sig = signature_text(f"Summarize report {seen[0]} and include citations", [], {"os": "linux"})
    with tally.span():
        m = (await client.match(sig))["matches"]
        pats = (await client.get("/patterns"))["patterns"]
        pts = (await client.get("/health/app-A"))["points"]
        ready = await client.get("/readyz")
    want = plat.gfkb.match(sig)
    if [x["failure_id"] for x in m[:1]] != [want[0].failure_id] or abs(m[0]["score"] - want[0].score) > ATOL:
        raise AssertionError(f"/failures/match {m[:1]} vs {want[:1]}")
    if _pattern_key_json(pats) != _pattern_key(plat.patterns_list()):
        raise AssertionError("/patterns differs from the platform's")
    if len(pts) != len(plat.health_history("app-A")) or not pts:
        raise AssertionError("/health/app-A differs from the platform's")
    if not (ready["native"]["available"] and ready["device"]["name"] == torch.cuda.get_device_name(0)
            and ready["gfkb_count"] == plat.gfkb.count):
        raise AssertionError(f"/readyz: {ready}")
    bodies = order + [b for bs in c_bodies for b in bs]
    answers = res_b + [r for rs in res_c for r in rs]
    reqs = [WarningRequest.model_validate(b) for b in bodies]
    direct, tops = [], []
    for lo in range(0, len(reqs), 64):
        chunk = reqs[lo : lo + 64]
        direct += plat.warn_batch(chunk)
        tops += plat.gfkb.match_batch([signature_text(r.prompt, r.tools, r.env) for r in chunk])
    checked_ids = 0
    for j, (a, d, top) in enumerate(zip(answers, direct, tops)):
        if a["action"] != d.action or abs(a["confidence"] - d.confidence) > ATOL:
            raise AssertionError(f"answer {j}: {a['action']} {a['confidence']} vs direct {d.action} {d.confidence}")
        separated = len(top) < 2 or top[0].score - top[1].score > ATOL
        if d.references and separated:
            if not a["references"] or a["references"][0]["failure_id"] != d.references[0].failure_id:
                raise AssertionError(f"answer {j}: reference differs from the direct warn")
            checked_ids += 1
    out["answers_checked"] = len(answers)
    log(f"phase 8 d: /failures/match, /patterns, /health, /readyz agree with the platform; {len(answers)} "
        f"answers equal a direct warn_batch (action, confidence within {ATOL}, reference id on {checked_ids} "
        f"separated top-1s)")

    # e. Mining through the route.
    with tally.span():
        body = await client.mine({"mode": "full"})
    t = time.perf_counter()
    direct_full, dinfo = plat.mine(mode="full")
    direct_ms = (time.perf_counter() - t) * 1e3
    if body["mining"]["mode"] != "full" or _pattern_key_json(body["patterns"]) != _pattern_key(direct_full):
        raise AssertionError(f"/patterns/mine full differs from plat.mine(mode='full'): {body['mining']}")
    more = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 4096, 512)]
    with tally.span():
        await client.ingest_batch(more)
        t = time.perf_counter()
        inc = await client.mine({})
        inc_ms = (time.perf_counter() - t) * 1e3
    if inc["mining"]["mode"] != "incremental":
        raise AssertionError(f"/patterns/mine after one more ingest: {inc['mining']}")
    out.update(mine_full_route_wall_ms=body["mining"]["wall_ms"], mine_full_direct_ms=direct_ms,
               mine_incremental_route_ms=inc_ms, patterns=len(direct_full))
    log(f"phase 8 e: /patterns/mine full == plat.mine(mode='full') ({len(direct_full)} patterns, route wall "
        f"{body['mining']['wall_ms']:.1f} ms, direct {direct_ms:.1f} ms); after 512 more traces /patterns/mine "
        f"{{}} is incremental ({inc_ms:.1f} ms, {inc['mining'].get('attached')} rows attached) [{card}]")
    out["launches_service"] = tally.n
    return out


def _pattern_key_json(patterns):
    return {(p["name"], tuple(p["failure_ids"]), tuple(sorted(p["affected_apps"])), p["description"])
            for p in patterns}


class _Stages:
    """Per-call stage times through wrappers on the real call path: a
    stage's host time is taken with the card synchronized at both of its
    boundaries (device stages also get CUDA events)."""

    def __init__(self):
        self.host, self.dev, self._undo = {}, {}, []

    def wrap(self, obj, attr, name, sync=True, events=False):
        fn = getattr(obj, attr)

        def timed(*a, **k):
            if sync:
                torch.cuda.synchronize()
            if events:
                ev = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                ev[0].record()
            t = time.perf_counter()
            try:
                return fn(*a, **k)
            finally:
                if events:
                    ev[1].record()
                if sync:
                    torch.cuda.synchronize()
                self.host[name] = self.host.get(name, 0.0) + (time.perf_counter() - t) * 1e3
                if events:
                    self.dev[name] = self.dev.get(name, 0.0) + ev[0].elapsed_time(ev[1])

        own = attr in vars(obj)
        setattr(obj, attr, timed)
        self._undo.append((obj, attr, fn if own else None))

    def take(self):
        out = dict(host=self.host, dev=self.dev)
        self.host, self.dev = {}, {}
        return out

    def restore(self):
        for obj, attr, fn in reversed(self._undo):
            if fn is None:
                delattr(obj, attr)  # a method again, not an instance attribute
            else:
                setattr(obj, attr, fn)
        self._undo.clear()


def host_split(plat, card: str) -> dict:
    """The warn path's stages for B = 1 and B = 64, and one 512-trace
    ingest batch's, at phase 8's index (medians over repeated calls)."""
    from kakveda_tpu_torch import native
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.ops import knn as knn_mod
    from kakveda_tpu_torch.ops.featurizer import dense_rows_to_sparse
    from kakveda_tpu_torch.pipeline import warning as warning_mod
    from kakveda_tpu_torch.core.fingerprint import signature_text

    gfkb, f, lib = plat.gfkb, plat.gfkb.featurizer, native.load()
    out = {}
    for b in (1, 64):
        reqs = [WarningRequest(app_id="app-s", prompt=f"Summarize report {i * 7 + 1} and include citations",
                               tools=[], env={"os": "linux"}) for i in range(b)]
        sigs = [signature_text(r.prompt, r.tools, r.env) for r in reqs]
        walls = []
        for _ in range(3):
            plat.warn_batch(reqs)
        for _ in range(30):
            t = time.perf_counter()
            plat.warn_batch(reqs)
            walls.append((time.perf_counter() - t) * 1e3)
        torch.cuda.synchronize()
        py_ms, nat_ms = [], []
        for _ in range(30):
            t = time.perf_counter()
            dense_rows_to_sparse(f._encode_batch_py(sigs), f.dim)
            py_ms.append((time.perf_counter() - t) * 1e3)
            t = time.perf_counter()
            f._encode_sparse_native(lib, sigs)
            nat_ms.append((time.perf_counter() - t) * 1e3)
        st = _Stages()
        st.wrap(warning_mod, "signature_text", "signature_text", sync=False)
        st.wrap(f, "encode_batch_sparse", "featurize (native)", sync=False)
        st.wrap(knn_mod, "to_device", "upload (idx, val)")
        st.wrap(gfkb._knn, "densify", "densify", events=True)
        st.wrap(knn_mod, "fused_topk", "fused_topk", events=True)
        st.wrap(gfkb._knn, "topk_result", "d2h + unpack")
        st.wrap(plat.warning_policy, "warn_batch", "call")
        calls = []
        try:
            for _ in range(30):
                plat.warn_batch(reqs)
                calls.append(st.take())
        finally:
            st.restore()
        med = lambda key, kind="host": statistics.median(c[kind].get(key, 0.0) for c in calls)  # noqa: E731
        stages = {k: med(k) for k in ("signature_text", "featurize (native)", "upload (idx, val)", "densify",
                                      "fused_topk", "d2h + unpack")}
        # The rest: the bucket pad, the lock, the packed cat, the match
        # cache, FailureMatch and WarningResponse construction.
        stages["pad + matches + responses (rest)"] = med("call") - sum(stages.values())
        out[f"warn_b{b}"] = dict(
            stages_host_ms=stages, densify_dev_ms=med("densify", "dev"), fused_topk_dev_ms=med("fused_topk", "dev"),
            featurize_python_ms=statistics.median(py_ms), featurize_native_ms=statistics.median(nat_ms),
            synced_call_ms=med("call"), warn_batch_wall_ms=statistics.median(walls),
        )
        log(f"warn host split, B = {b}: " + json.dumps(out[f"warn_b{b}"]) + f" [{card}]")

    # One 512-trace ingest batch (after a warm-up batch).
    traces = _service_traces(TracePayload, 10_000, 1024)
    asyncio.run(plat.ingest_batch(traces[:512]))
    batch = traces[512:]
    texts = [signature_text(t.prompt, t.tools, t.env) for t in batch if t.response == STUB_RESPONSE]
    t = time.perf_counter()
    dense_rows_to_sparse(f._encode_batch_py(texts), f.dim)
    py_ms = (time.perf_counter() - t) * 1e3
    t = time.perf_counter()
    f._encode_sparse_native(lib, texts)
    nat_ms = (time.perf_counter() - t) * 1e3
    st = _Stages()
    st.wrap(plat.classifier, "classify_batch", "classify", sync=False)
    st.wrap(f, "encode_batch_sparse", "featurize (native)", sync=False)
    st.wrap(gfkb._knn, "insert_sparse", "insert")
    st.wrap(gfkb, "_mine_attach_new", "delta dispatch")
    st.wrap(gfkb, "_append_line", "log append", sync=False)
    st.wrap(gfkb, "_flush_logs", "log flush", sync=False)
    torch.cuda.synchronize()
    try:
        t = time.perf_counter()
        asyncio.run(plat.ingest_batch(batch))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
        got = st.take()
    finally:
        st.restore()
    stages = dict(got["host"])
    stages["rest (records, health, patterns, event loop)"] = wall - sum(stages.values())
    out["ingest_512"] = dict(stages_host_ms=stages, featurize_python_ms=py_ms, featurize_native_ms=nat_ms,
                             failures=len(texts), wall_ms=wall)
    log("ingest host split, 512 traces: " + json.dumps(out["ingest_512"]) + f" [{card}]")
    return out


async def _warn_clients(post, clients: int, per_client: int) -> dict:
    """``clients`` concurrent clients, each sending ``per_client`` warns in
    turn (half of ingested signatures, half new): p50, p99, warns/s."""
    lat = []

    async def one(c):
        for j in range(per_client):
            prompt = (f"Summarize report {(c * per_client + j) * 3 + 1} and include citations" if j % 2 == 0
                      else f"Client {c} asks {j} about a new topic")
            t = time.perf_counter()
            body = await post("/warn", _warn_body(f"app-{'ABCDEFG'[c % 7]}", prompt))
            lat.append((time.perf_counter() - t) * 1e3)
            if body["action"] not in ("warn", "block", "silent"):
                raise AssertionError(f"warn answer {body}")

    t0 = time.perf_counter()
    await asyncio.gather(*[one(c) for c in range(clients)])
    wall = time.perf_counter() - t0
    return dict(p50_ms=_pct(lat, 0.5), p99_ms=_pct(lat, 0.99), warns_per_s=clients * per_client / wall)


def _start_service(root: Path, data: Path, out_path: Path, **extra_env):
    """``python3 -m kakveda_tpu_torch.service`` on the card at the GFKB's
    real size, its output to ``out_path``; returns (process, base URL)."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(root), KAKVEDA_LOG_FORMAT="text", KAKVEDA_INDEX_CAPACITY=str(ROWS),
               **extra_env)
    with open(out_path, "wb") as out_f:
        proc = subprocess.Popen([sys.executable, "-m", "kakveda_tpu_torch.service", "--port", str(port),
                                 "--data-dir", str(data)], cwd=root, env=env,
                                stdout=out_f, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}"


async def _wait_healthz(s, base_url: str, proc, out_path: Path, t0: float) -> float:
    import aiohttp

    while True:
        if proc.poll() is not None:
            raise AssertionError("the service exited early:\n" + out_path.read_text()[-3000:])
        if time.perf_counter() - t0 > 120:
            raise AssertionError("the service did not answer /healthz within 120 s")
        try:
            async with s.get(base_url + "/healthz") as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except aiohttp.ClientConnectionError:
            await asyncio.sleep(0.2)


def _stop_service(proc, out_path: Path) -> str:
    """SIGINT; the exit code must be 0. Returns the process's output."""
    import signal

    try:
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    text = out_path.read_text()
    if rc != 0:
        raise AssertionError(f"service exit code {rc}:\n" + text[-3000:])
    return text


# Phase 17 f's fault timeline in the entry-point child: at TIMELINE_AT_S
# service.handler fails the next TIMELINE_500S requests, and trace.record
# every span until TIMELINE_WARNS /warn have gone through (one span a
# failed /healthz, one the 200 that ends the poll, two a /warn), so the
# timed arms after run with no fault armed.
TIMELINE_AT_S, TIMELINE_500S, TIMELINE_WARNS = 2.0, 20, 16
TIMELINE_RECORD_FIRES = TIMELINE_500S + 1 + 2 * TIMELINE_WARNS


async def _wait_healthz_timeline(s, base_url: str, proc, out_path: Path, t0: float):
    """``_wait_healthz`` for a child whose fault timeline arms
    ``service.handler`` for TIMELINE_500S requests: polls until a 200
    follows that many 500s, and checks that the answers after any early
    200s are exactly the 500s, then 200. Returns (seconds, statuses)."""
    import aiohttp

    statuses = []
    while True:
        if proc.poll() is not None:
            raise AssertionError("the service exited early:\n" + out_path.read_text()[-3000:])
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"phase 17 f: no 200 after {TIMELINE_500S} x 500 within 120 s: {statuses}")
        try:
            async with s.get(base_url + "/healthz") as r:
                statuses.append(r.status)
                body = await r.json()
        except aiohttp.ClientConnectionError:
            await asyncio.sleep(0.2)
            continue
        if r.status == 500 and "service.handler" not in body.get("error", ""):
            raise AssertionError(f"phase 17 f: a 500 that is not the armed site's: {body}")
        if r.status == 200 and statuses.count(500) >= TIMELINE_500S:
            break
        if r.status == 200:
            await asyncio.sleep(0.05)  # up before the timeline fired: poll on
    tail = statuses[next(i for i, x in enumerate(statuses) if x != 200):]
    if tail != [500] * TIMELINE_500S + [200]:
        raise AssertionError(f"phase 17 f: /healthz answered {statuses}")
    return time.perf_counter() - t0, statuses


def run_entry_point(base: Path, card: str) -> dict:
    """``python3 -m kakveda_tpu_torch.service`` as its own process on the
    card, its index at the GFKB's real size: it answers ``/healthz`` within
    120 s, ingests a warm-up batch and 8 timed batches of 512 traces, warns
    (one ingested signature must match itself; then 64 clients x 16 warns,
    the client in this process and the server in its own), exits 0 on
    SIGINT leaving a v5 snapshot, and its data dir reopens. A second start
    (phase 11's arm) restores the snapshot — its log and ``/failures`` say
    so — and answers the same ``/warn`` as before the restart."""
    import aiohttp

    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    root = Path(__file__).resolve().parent
    data = base / "service-data"
    out_path = base / "service.log"
    t0 = time.perf_counter()
    # Phase 17 f: the child's fault timeline, offsets from its import of
    # core/faults.
    timeline = json.dumps([{"t": TIMELINE_AT_S, "spec": f"service.handler:1.0:{TIMELINE_500S},"
                                                        f"trace.record:1.0:{TIMELINE_RECORD_FIRES}"}])
    proc, base_url = _start_service(root, data, out_path, KAKVEDA_FAULTS_TIMELINE=timeline)
    warn_body = _warn_body("app-z", "Summarize report 1 and include citations")

    async def drive():
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=128)) as s:
            async def post(path, body):
                async with s.post(base_url + path, json=body) as r:
                    out = await r.json()
                    if r.status != 200:
                        raise AssertionError(f"service POST {path}: {r.status} {out}")
                    return out

            up_s, statuses = await _wait_healthz_timeline(s, base_url, proc, out_path, t0)
            # Phase 17 f: TIMELINE_WARNS /warn answer 200 while trace.record
            # drops each of their spans; that spends the site, so the ring
            # has recorded nothing since the timeline fired.
            for i in range(TIMELINE_WARNS):
                await post("/warn", _warn_body("app-t", f"Trace {i} with trace.record armed"))
            async with s.get(base_url + "/trace") as r:
                plane = (await r.json())["plane"]
            early = next(i for i, x in enumerate(statuses) if x != 200)  # answered before the timeline fired
            if plane["dropped"] != TIMELINE_RECORD_FIRES or plane["recorded"] != early or plane["ring"] != early:
                raise AssertionError(f"phase 17 f: the child's trace plane {plane} with trace.record armed "
                                     f"for {TIMELINE_RECORD_FIRES} spans")
            # One warm-up batch first (the process's first device calls
            # initialize cuBLAS and the allocator), then 8 timed batches.
            warm = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 100_000, 512)]
            await post("/ingest/batch", {"traces": warm})
            traces = [t.model_dump(mode="json") for t in _service_traces(TracePayload, 0, 4096)]
            t = time.perf_counter()
            failures = 0
            for lo in range(0, 4096, 512):
                failures += (await post("/ingest/batch", {"traces": traces[lo : lo + 512]}))["failures"]
            ingest_s = time.perf_counter() - t
            w = await post("/warn", warn_body)
            async with s.get(base_url + "/readyz") as r:
                ready = await r.json()
            if failures != 3072 or not w["references"] or w["confidence"] < 0.99:
                raise AssertionError(f"service answers: {failures} failures, {w}")
            if not (ready["native"]["available"] and ready["device"]["type"] == "cuda"
                    and ready["gfkb_count"] == 3072 + 384):
                raise AssertionError(f"service /readyz: {ready}")
            await post("/warn", _warn_body("app-z", "warm up"))
            c64 = await _warn_clients(post, 64, 16)
            return dict(start_s=up_s, ingest_traces_per_s=4096 / ingest_s, warn_c64=c64,
                        confidence=w["confidence"], failure_id=w["references"][0]["failure_id"],
                        references=[(r["failure_id"], r["score"]) for r in w["references"]],
                        timeline=dict(statuses=statuses, plane=plane))

    try:
        out = asyncio.run(drive())
    finally:
        first = _stop_service(proc, out_path)
    n_rec = 3072 + 384
    manifest = json.loads((data / "snapshot" / "manifest.json").read_text())
    if f"gfkb snapshot written ({n_rec} entries)" not in first or manifest["version"] != 5 or manifest["n"] != n_rec:
        raise AssertionError(f"shutdown snapshot: {manifest}\n" + first[-2000:])
    rows = (data / "failures.jsonl").read_text().splitlines()
    plat = Platform(data_dir=data, capacity=1 << 12, dim=DIM)
    if len(rows) != n_rec or plat.gfkb.count != n_rec or plat.device.type != "cuda":
        raise AssertionError(f"reopen: {len(rows)} log rows, {plat.gfkb.count} records on {plat.device}")
    out["replayed"] = plat.gfkb.count
    plat.close()
    del plat

    out_path2 = base / "service-restart.log"
    t0 = time.perf_counter()
    proc, base_url = _start_service(root, data, out_path2)

    async def again():
        async with aiohttp.ClientSession() as s:
            up_s = await _wait_healthz(s, base_url, proc, out_path2, t0)
            async with s.get(base_url + "/failures") as r:
                count = len((await r.json())["failures"])
            async with s.post(base_url + "/warn", json=warn_body) as r:
                w = await r.json()
            return up_s, count, w

    try:
        up2, count2, w2 = asyncio.run(again())
    finally:
        second = _stop_service(proc, out_path2)
    refs2 = [(r["failure_id"], r["score"]) for r in w2["references"]]
    if (f"restored a snapshot of {n_rec} rows" not in second or f"restored from a snapshot: {n_rec}" not in second
            or count2 != n_rec or refs2 != out["references"] or w2["confidence"] != out["confidence"]):
        raise AssertionError(f"restart: /failures {count2}, /warn {refs2} vs {out['references']}\n" + second[-2000:])
    out["restart_start_s"] = up2
    tl = out["timeline"]
    log(f"phase 17 f: the entry-point child under KAKVEDA_FAULTS_TIMELINE (service.handler:1.0:{TIMELINE_500S} and "
        f"trace.record:1.0:{TIMELINE_RECORD_FIRES} at t = {TIMELINE_AT_S} s from its import): /healthz answered "
        f"{tl['statuses'].count(500)} x 500 then 200 ({len(tl['statuses'])} answers); {TIMELINE_WARNS} /warn then "
        f"answered 200 with trace.record armed (ring {tl['plane']['ring']}, {tl['plane']['dropped']} spans dropped, "
        f"{tl['plane']['orphaned']} open), which spent the site before the timed arms below [{card}]")
    c64 = out["warn_c64"]
    log(f"python3 -m kakveda_tpu_torch.service ({ROWS} x {DIM} index): answered /healthz after "
        f"{out['start_s']:.1f} s; /ingest/batch 8 x 512 (after one warm-up batch) at "
        f"{out['ingest_traces_per_s']:.1f} traces/s; an ingested "
        f"signature warned at {out['confidence']:.6f} ({out['failure_id']}); /warn at concurrency 64 (64 x 16, "
        f"client in another process): p50 {c64['p50_ms']:.3f} ms, p99 {c64['p99_ms']:.3f} ms, "
        f"{c64['warns_per_s']:.1f} warns/s; exited 0 on SIGINT with a v5 snapshot of {n_rec} rows; a fresh "
        f"Platform on the card reopened {out['replayed']} records; a second start restored the snapshot, "
        f"answered /healthz after {up2:.1f} s, /failures {count2}, and the same /warn [{card}]")
    return out


def _snap_value(reg, fam: str, label: str = ""):
    """One series of the registry's snapshot: a counter's or gauge's value,
    a histogram's count (0 when the series does not exist yet)."""
    v = reg.snapshot().get(fam, {}).get("series", {}).get(label, 0)
    return v["count"] if isinstance(v, dict) else v


async def _serve_app(app):
    """``app`` on a TCPSite at a free port: (runner, base URL)."""
    from aiohttp import web

    runner = web.AppRunner(app)
    await runner.setup()
    port = _free_port()
    await web.TCPSite(runner, "127.0.0.1", port).start()
    return runner, f"http://127.0.0.1:{port}"


async def _fetch(s, method: str, url: str, **kw):
    """(status, headers, JSON body) of one request."""
    async with getattr(s, method)(url, **kw) as r:
        return r.status, r.headers, await r.json()


PLANE_WARNS, PLANE_CONC = 256, 64  # phase 17 a
RL_RPS, RL_BURST, RL_REQUESTS = 50.0, 10.0, 100  # phase 17 b
def tenant_clients(app_id: str, conc: str, start_s: str, run_s: str) -> int:
    """Phase 17 c's clients of one tenant, in a process of their own (run as
    ``python3 -c`` with this function's source, so it imports neither torch
    nor this script): prints READY once its session is open, waits for a
    line ``go <base URL>`` on stdin, then keeps ``conc`` /warn of
    ``app_id`` in flight from ``start_s`` to ``start_s + run_s`` seconds
    after it. Prints one line, ``TENANT`` and the JSON list of (send time
    from the go line, status, latency ms, reason, error)."""
    import asyncio
    import json
    import sys
    import time

    import aiohttp

    start_s, run_s = float(start_s), float(run_s)

    async def go():
        rec = []
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=0)) as s:
            print("READY", flush=True)
            line = await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
            base = line.split()[1]
            t0 = time.perf_counter()
            until = t0 + start_s + run_s

            async def one(c):
                j = 0
                while time.perf_counter() < until:
                    body = {"app_id": app_id, "prompt": f"Summarize report {4 * (c * 997 + j) + 1} and include "
                                                        "citations", "tools": [], "env": {"os": "linux"}}
                    t = time.perf_counter()
                    async with s.post(base + "/warn", json=body) as r:
                        b = await r.json()
                    rec.append((t - t0, r.status, (time.perf_counter() - t) * 1e3, b.get("reason"),
                                b.get("error", "")))
                    j += 1

            await asyncio.sleep(start_s)
            await asyncio.gather(*[one(c) for c in range(int(conc))])
        return rec

    print("TENANT " + json.dumps(asyncio.run(go())), flush=True)
    return 0


def ingest_flood_clients(name: str, conc: str, run_s: str, body_path: str) -> int:
    """Phase 18 d's flood, in a process of its own (run as ``python3 -c``
    with this function's source, as ``tenant_clients``; ``name`` keys its
    records): prints READY once
    its session is open, waits for a line ``go <base URL>`` on stdin, then
    keeps ``conc`` /ingest/batch of the JSON body in ``body_path`` in flight
    for ``run_s`` seconds. Prints one line, ``TENANT`` and the JSON list of
    (status, failures classified)."""
    import asyncio
    import json
    import sys
    import time

    import aiohttp

    with open(body_path) as f:
        body = json.load(f)

    async def go():
        rec = []
        async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=0)) as s:
            print("READY", flush=True)
            line = await asyncio.get_running_loop().run_in_executor(None, sys.stdin.readline)
            base = line.split()[1]
            until = time.perf_counter() + float(run_s)

            async def one():
                while time.perf_counter() < until:
                    async with s.post(base + "/ingest/batch", json=body) as r:
                        b = await r.json()
                    rec.append((r.status, b.get("failures", 0) if r.status == 200 else 0))

            await asyncio.gather(*[one() for _ in range(int(conc))])
        return rec

    print("TENANT " + json.dumps(asyncio.run(go())), flush=True)
    return 0


def spawn_tenant_clients(tenants, fn=tenant_clients) -> list:
    """Starts ``fn`` (``tenant_clients``: once per (app id, concurrency,
    start s, run s)) in a process per argument tuple; ``run_tenant_clients``
    sends them off."""
    import inspect

    src = inspect.getsource(fn) + f"\nimport sys\nsys.exit({fn.__name__}(*sys.argv[1:]))\n"
    return [(t, subprocess.Popen([sys.executable, "-c", src, *map(str, t)], stdin=subprocess.PIPE,
                                 stdout=subprocess.PIPE)) for t in tenants]


async def run_tenant_clients(procs, base: str, what: str = "phase 17 c"):
    """Once every client process of ``spawn_tenant_clients`` is ready, one
    go line starts them all against ``base`` while this loop goes on
    serving. Returns (each process's records under its first argument, the
    go time on this process's ``perf_counter``). Every process is killed
    on the way out."""
    loop = asyncio.get_running_loop()
    try:
        for _, p in procs:
            line = await asyncio.wait_for(loop.run_in_executor(None, p.stdout.readline), 120)
            if line.strip() != b"READY":
                raise AssertionError(f"{what}: a client process said {line!r}")
        t_go = time.perf_counter()
        for _, p in procs:
            p.stdin.write(f"go {base}\n".encode())
            p.stdin.flush()
        out = {}
        for (key, *_), p in procs:
            stdout, _ = await asyncio.wait_for(loop.run_in_executor(None, p.communicate), 120)
            line = next((ln for ln in stdout.decode().splitlines() if ln.startswith("TENANT ")), None)
            if p.returncode != 0 or line is None:
                raise AssertionError(f"{what}: the {key} client process exited {p.returncode}")
            out[key] = json.loads(line[7:])
        return out, t_go
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


# Phase 17 c: the victim alone for TENANT_BASE_S, then the flood beside it.
TENANT_WARN_BOUND, NOISY_CONC, VICTIM_CONC, TENANT_BASE_S, TENANT_FLOOD_S = 32, 128, 4, 1.0, 4.0
# Phase 17 d's block: the watchdog stamps and checks every 250 / 4 ms, so
# only a block past 250 + 2 x 62.5 ms is always seen (a 300 ms one went
# unrecorded once on a slow host).
STALL_BLOCK_S = 0.4
RECORDED_WARN_C1_P50 = "5.363-8.468 ms"  # phase 8 b's range as PERF.md section 5 records it


async def _request_plane(s, base: str, plat, fused_topk, card: str, warn_c1_p50: float) -> dict:
    """Phase 17 a-d on phase 8's Platform (2^20 x 2048 on the card) and its
    app at ``base``; a second app over the same Platform wherever a knob is
    read at ``make_app``. a. traces of 256 concurrent /warn; b. the token
    bucket; c. tenant quotas under a noisy neighbour; d. the loop-stall
    watchdog."""
    import uuid

    from kakveda_tpu_torch.core import admission, metrics, sanitize, trace
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.service.app import make_app

    out = {}
    reg, tracer = metrics.get_registry(), trace.get_tracer()
    t_phase = time.perf_counter()

    # a. Causal traces: 256 /warn at concurrency 64, each with its own
    # traceparent; one micro-batch, one fused_topk launch.
    tracer.reset()
    heads = [(uuid.uuid4().hex, uuid.uuid4().hex[:16]) for _ in range(PLANE_WARNS)]
    bodies = [_warn_body(f"app-{'ABCDEFGH'[i % 8]}", f"Summarize report {4 * i + 1} and include citations"
                         if i % 2 else f"Trace {i} asks about a new topic") for i in range(PLANE_WARNS)]
    mb0, l0 = _snap_value(reg, "kakveda_microbatch_batch_size", "batcher=warn"), fused_topk.launches
    answers = [None] * PLANE_WARNS

    async def tracer_client(c):
        for i in range(c, PLANE_WARNS, PLANE_CONC):
            tid, sid = heads[i]
            answers[i] = await _fetch(s, "post", base + "/warn", json=bodies[i],
                                      headers={"traceparent": f"00-{tid}-{sid}-01"})

    t = time.perf_counter()
    await asyncio.gather(*[tracer_client(c) for c in range(PLANE_CONC)])
    wall_a = time.perf_counter() - t
    launches = fused_topk.launches - l0
    batches = _snap_value(reg, "kakveda_microbatch_batch_size", "batcher=warn") - mb0
    if any(a[0] != 200 for a in answers) or launches != batches or not 0 < batches < PLANE_WARNS:
        raise AssertionError(f"phase 17 a: statuses {sorted({a[0] for a in answers})}, {launches} fused_topk "
                             f"launches for {batches} micro-batches")
    _, _, ring = await _fetch(s, "get", base + "/trace")
    spans = {}
    for sp in ring["spans"]:
        spans.setdefault(sp["trace_id"], []).append(sp)
    ones = [(await _fetch(s, "get", f"{base}/trace/{heads[i][0]}"))[2]["spans"] for i in range(PLANE_WARNS - 8,
                                                                                                  PLANE_WARNS)]
    for i, (tid, sid) in enumerate(heads):
        got = {sp["name"]: sp for sp in spans.get(tid, [])}
        req, warn = got.get("service.request"), got.get("gfkb.warn")
        if (len(spans.get(tid, [])) != 2 or req is None or warn is None or req["parent_id"] != sid
                or warn["parent_id"] != req["span_id"] or req["attrs"].get("status") != 200
                or {k: warn["attrs"].get(k) for k in ("degraded", "native", "action")}
                != {"degraded": False, "native": True, "action": answers[i][2]["action"]}
                or warn["attrs"].get("tier") != answers[i][2]["tier"]):
            raise AssertionError(f"phase 17 a: trace {tid}: {spans.get(tid)}")
    if any(sorted(x["name"] for x in o) != ["gfkb.warn", "service.request"] for o in ones):
        raise AssertionError(f"phase 17 a: /trace/{{id}} gave {ones}")
    plane = tracer.plane()
    out["a"] = dict(warns=PLANE_WARNS, micro_batches=batches, launches=launches, warns_per_s=PLANE_WARNS / wall_a,
                    ring=ring["plane"], plane=plane, tier=answers[0][2]["tier"])
    log(f"phase 17 a: {PLANE_WARNS} /warn at concurrency {PLANE_CONC}, each with its own traceparent, "
        f"{PLANE_WARNS / wall_a:.1f} warns/s: every /trace holds service.request (under the caller's span) -> "
        f"gfkb.warn (tier {answers[0][2]['tier']}, native, not degraded, the answer's action); {batches} "
        f"micro-batches, {launches} fused_topk launches; the ring read {ring['plane']['ring']} spans of "
        f"{ring['plane']['capacity']}, {ring['plane']['orphaned']} open (the /trace request's own), "
        f"{ring['plane']['dropped']} dropped [{card}]")

    # b. The token bucket, on a second app over the same Platform.
    with env_set(KAKVEDA_RATELIMIT_RPS=RL_RPS, KAKVEDA_RATELIMIT_BURST=RL_BURST):
        runner_b, base_b = await _serve_app(make_app(plat))
    shed0 = _snap_value(reg, "kakveda_admission_shed_total", "klass=ingest,reason=ratelimit")
    traces = [_trace(TracePayload, 400_000 + i, "app-rl", f"Summarize ledger {i} and include citations")
              .model_dump(mode="json") for i in range(RL_REQUESTS)]
    res, sent, lat = [], [], []
    try:
        for tr in traces:
            t = time.perf_counter()
            sent.append(t)
            res.append(await _fetch(s, "post", base_b + "/ingest", json={"trace": tr}))
            lat.append(time.perf_counter() - t)
    finally:
        await runner_b.cleanup()
    ok = sum(r[0] == 200 for r in res)
    shed = [r for r in res if r[0] != 200]
    span = sent[-1] - sent[0]
    lo, hi = RL_BURST + RL_RPS * (span - lat[0]) - 1, RL_BURST + RL_RPS * (span + lat[-1]) + 1
    sheds = _snap_value(reg, "kakveda_admission_shed_total", "klass=ingest,reason=ratelimit") - shed0
    if (not lo <= ok <= hi or any(r[0] != 429 or r[2].get("reason") != "ratelimit" or not r[1].get("Retry-After")
                                  for r in shed) or sheds != len(shed)):
        raise AssertionError(f"phase 17 b: {ok} admitted over {span:.3f} s (bucket allows {lo:.1f}-{hi:.1f}), "
                             f"{len(shed)} shed, shed_total moved {sheds}: {shed[:2]}")
    out["b"] = dict(admitted=ok, shed=len(shed), span_s=span, allowed=[lo, hi])
    log(f"phase 17 b: KAKVEDA_RATELIMIT_RPS={RL_RPS:g}, BURST={RL_BURST:g}: {RL_REQUESTS} quick /ingest from one "
        f"client over {span:.3f} s: {ok} admitted (the bucket's arithmetic allows {lo:.1f}-{hi:.1f}), {len(shed)} "
        f"answered 429 with Retry-After and reason ratelimit; kakveda_admission_shed_total{{ingest,ratelimit}} "
        f"moved {sheds} [{card}]")

    # c. Tenant quotas: a small warn bound, a noisy tenant flooding beside a
    # victim, both on a third app over the same Platform. Each tenant's
    # clients run in a process of their own, so this loop serves the app
    # and nothing else; it also times its own iterations meanwhile.
    procs = spawn_tenant_clients([("app-victim", VICTIM_CONC, 0.0, TENANT_BASE_S + TENANT_FLOOD_S),
                                  ("app-noisy", NOISY_CONC, TENANT_BASE_S, TENANT_FLOOD_S)])
    with env_set(KAKVEDA_ADMIT_WARN=TENANT_WARN_BOUND):
        adm_c = admission.AdmissionController()
    runner_c, base_c = await _serve_app(make_app(plat, admission=adm_c))
    tsh0 = _snap_value(reg, "kakveda_admission_tenant_shed_total", "tenant=app-noisy")
    lags, lagging = [], [True]

    async def loop_lag():
        while lagging[0]:
            t = time.perf_counter()
            await asyncio.sleep(0.005)
            lags.append((t, (time.perf_counter() - t - 0.005) * 1e3))

    lag_task = asyncio.ensure_future(loop_lag())
    try:
        rec, t_go = await run_tenant_clients(procs, base_c)
    finally:
        lagging[0] = False
        await lag_task
        await runner_c.cleanup()
    noisy = rec["app-noisy"]
    base_v = [x for x in rec["app-victim"] if x[0] < TENANT_BASE_S]
    victim = [x for x in rec["app-victim"] if x[0] >= TENANT_BASE_S]
    sheds_n = [x for x in noisy if x[1] == 429]
    sheds_v = [x for x in victim + base_v if x[1] == 429]
    other = [x for x in noisy + victim + base_v if x[1] not in (200, 429)]
    quota = [x for x in sheds_n if x[3] == "tenant_quota" and "app-noisy" in x[4]]
    tsh = _snap_value(reg, "kakveda_admission_tenant_shed_total", "tenant=app-noisy") - tsh0
    # The noisy-neighbour contract (the reference's traffic SLO, as
    # tests/test_tenants.py sets it): over the flood, the victim's shed rate
    # <= 0.05, the flooder's share of sheds >= 0.9, no victim starved a
    # second, and the victim's p95 <= 3x its own p95 alone. The first three
    # hold or the phase fails. The p95 gate fails here in both packages (the
    # JAX app too, under these clients on a CPU): the flood's own HTTP work
    # stretches this one loop's iterations, and a victim's request spans
    # several of them. It is printed, and stays open in ROADMAP Queue 3.
    v_rate = len(sheds_v) / max(1, len(victim))
    flood_share = len(sheds_n) / max(1, len(sheds_n) + len(sheds_v))
    v_ok = sorted(x[0] for x in victim if x[1] == 200)
    starve = max((b - a for a, b in zip(v_ok, v_ok[1:])), default=0.0)
    v95 = _pct([x[2] for x in victim if x[1] == 200], 0.95) if v_ok else float("inf")
    b95 = _pct([x[2] for x in base_v if x[1] == 200], 0.95)
    if (other or not sheds_n or sheds_v or len(quota) != len(sheds_n) or tsh != len(sheds_n)
            or v_rate > 0.05 or flood_share < 0.9 or starve > 1.0):
        raise AssertionError(f"phase 17 c: noisy {len(noisy)} ({len(sheds_n)} shed, {len(quota)} tenant_quota), "
                             f"victim {len(victim)} ({len(sheds_v)} shed), other statuses {other[:3]}, "
                             f"tenant_shed_total moved {tsh}, starved {starve:.3f} s")
    flood0 = t_go + TENANT_BASE_S
    lag_base = [x for t, x in lags if t_go <= t < flood0]
    lag_flood = [x for t, x in lags if flood0 <= t < flood0 + TENANT_FLOOD_S]

    def pcts(xs):
        return [_pct(xs, q) for q in (0.5, 0.95, 1.0)] if xs else None

    out["c"] = dict(noisy=len(noisy), noisy_shed=len(sheds_n), victim=len(victim), victim_shed=len(sheds_v),
                    victim_baseline=len(base_v), victim_p95_ms=v95, victim_baseline_p95_ms=b95,
                    victim_p50_ms=_pct([x[2] for x in victim if x[1] == 200], 0.5),
                    victim_baseline_p50_ms=_pct([x[2] for x in base_v if x[1] == 200], 0.5),
                    victim_p95_x_baseline=v95 / b95, p95_gate_holds=v95 <= 3.0 * b95, victim_starve_s=starve,
                    loop_lag_baseline_ms=pcts(lag_base), loop_lag_flood_ms=pcts(lag_flood),
                    tenants=adm_c.tenants_info())
    log(f"phase 17 c: KAKVEDA_ADMIT_WARN={TENANT_WARN_BOUND}: app-victim at concurrency {VICTIM_CONC} alone for "
        f"{TENANT_BASE_S:g} s ({len(base_v)} warns, p95 {b95:.3f} ms), then app-noisy at {NOISY_CONC} beside it for "
        f"{TENANT_FLOOD_S:g} s, each tenant's clients in a process of their own: {len(sheds_n)} of {len(noisy)} "
        f"noisy warns shed, every one tenant_quota naming app-noisy, kakveda_admission_tenant_shed_total"
        f"{{app-noisy}} moved {tsh}; the victim: {len(victim)} warns, {len(sheds_v)} shed, longest gap between "
        f"answers {starve * 1e3:.1f} ms, p95 {v95:.3f} ms, {v95 / b95:.2f}x its p95 alone: the reference's 3x gate "
        f"{'holds' if v95 <= 3.0 * b95 else 'FAILS (open in ROADMAP Queue 3, as in the JAX app)'}; this loop's lag "
        f"(p50, p95, max ms) {pcts(lag_base)} alone, {pcts(lag_flood)} under the flood [{card}]")

    # d. The loop-stall watchdog on an app built with KAKVEDA_SANITIZE=1.
    with env_set(KAKVEDA_SANITIZE=1):
        runner_d, base_d = await _serve_app(make_app(plat))
    try:
        sanitize.reset()
        asyncio.get_running_loop().call_soon(time.sleep, STALL_BLOCK_S)
        await asyncio.sleep(STALL_BLOCK_S + 0.3)
        stalls = sanitize.sanitizer_report()["stalls"]
        if (len(stalls) != 1 or stalls[0]["stall_ms"] < 250 or not stalls[0]["stack"].strip()
                or stalls[0]["stack"] == "<no frame>"):
            raise AssertionError(f"phase 17 d: stalls after one {STALL_BLOCK_S} s block: {stalls}")
        blocked = stalls[0]["stall_ms"]
        sanitize.reset()
        flood = await _warn_clients(_Http(s, base_d)._post, 64, 4)
        under = sanitize.sanitizer_report()["stalls"]
    finally:
        await runner_d.cleanup()
        sanitize.reset()
    out["d"] = dict(stall_ms=blocked, flood_stalls=len(under), flood_stall_ms=[x["stall_ms"] for x in under],
                    flood=flood, warn_c1_p50_ms=warn_c1_p50)
    log(f"phase 17 d: KAKVEDA_SANITIZE=1: one {STALL_BLOCK_S * 1e3:.0f} ms block of the loop recorded as one stall "
        f"of {blocked:.1f} ms with the loop's stack; under 64 x 4 /warn, {len(under)} stalls past 250 ms "
        f"({[round(x['stall_ms'], 1) for x in under]}, a reading); phase 8 b's /warn p50 at concurrency 1 with "
        f"the named locks off: {warn_c1_p50:.3f} ms (PERF.md's recorded range: {RECORDED_WARN_C1_P50}, a reading) [{card}]")
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 17 a-d: {out['wall_s']:.1f} s")
    return out


def phase_service(base: Path, fused_topk, card: str, echo: Optional[tuple] = None) -> dict:
    """Phase 8: the service plane on the card at the GFKB's real size. With
    ``echo`` (``start_agent_echo``'s), phase 20 a and c ride on its
    Platform: the dashboard mounted beside the app after phase 17 a-d, the
    CLI on its data dir once it is closed (``out["dashboard"]``)."""
    import aiohttp  # required: without it phase 8 fails
    from aiohttp import web

    from kakveda_tpu_torch.ops.fused_topk import fused_topk_reference
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    log(f"aiohttp {aiohttp.__version__}")
    plat = Platform(data_dir=base / "service", capacity=ROWS, dim=DIM)
    if plat.device.type != "cuda":
        raise AssertionError(f"Platform on {plat.device}")

    async def go():
        runner = web.AppRunner(make_app(plat))
        await runner.setup()
        port = _free_port()
        await web.TCPSite(runner, "127.0.0.1", port).start()
        try:
            async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=256)) as s:
                arms = await _service_arms(_Http(s, f"http://127.0.0.1:{port}"), plat, fused_topk, card)
                # Phase 17 a-d rides on this Platform and app; its launches
                # count apart from phase 8's.
                mark = fused_topk.launches
                arms["request_plane"] = await _request_plane(s, f"http://127.0.0.1:{port}", plat, fused_topk, card,
                                                             arms["warn_c1_p50_ms"])
                arms["launches_request_plane"] = fused_topk.launches - mark
                if echo is not None:
                    arms["dashboard"] = await phase_dashboard(plat, base, fused_topk, fused_topk_reference, echo,
                                                              card)
                return arms
        finally:
            await runner.cleanup()

    out = asyncio.run(go())
    out["host_split"] = host_split(plat, card)
    before = live_answers(plat.gfkb) if echo is not None else None
    plat.close()
    del plat
    _forget_apps()
    if echo is not None:
        out["dashboard"]["c_cli"] = phase_cli(base, before, card)
    out["entry_point"] = run_entry_point(base, card)
    log("phase 8: " + json.dumps({k: v for k, v in out.items() if k != "host_split"}))
    return out


# ---------------------------------------------------------------------------
# phase 11: restart and lifecycle at real size
# ---------------------------------------------------------------------------

RESTART_N, RESTART_BATCH = 1 << 16, 4096
RESTART_TYPES = ("HALLUCINATION_CITATION", "TIMEOUT", "SCHEMA")
RESTART_AGED_BATCHES = RESTART_N // RESTART_BATCH // 8  # the first 1/8 of the rows age out


def restart_corpus(n: int, seed: int = 11, spread: int = 64):
    """(failure type, app, signature) of ``n`` distinct failure signatures in
    clusters of 1-10 members, drawn as ``parity_corpus`` draws them
    (thirteen random four-letter words per cluster, one changed per member,
    so no row has more than nine neighbours above 0.6), in bulk. Member j
    puts a digit in word j, which no drawn word holds, so members differ
    from each other and from every other cluster's. One cluster in
    ``spread`` spans apps (a pattern); the rest stay in one app each.
    ``parity_corpus`` spreads every cluster (``spread=1``); phase 11's
    lifecycle runs at 64, because a full mine's pattern emission grows with
    the square of the spread clusters (``measure_emission``)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    sizes = rng.integers(1, 11, size=n)
    n_cl = int(np.searchsorted(np.cumsum(sizes), n)) + 1
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    words = alpha[rng.integers(0, 26, size=(n_cl, 13, 4))].view("S4")[..., 0].astype(str).tolist()
    out = []
    for c in range(n_cl):
        w = words[c]
        for j in range(int(sizes[c])):
            sig = " ".join(w[:j] + ["9" + w[j][1:]] + w[j + 1 :])
            app = (c + j) % 8 if c % spread == 0 else c % 8
            out.append((RESTART_TYPES[c % 3], f"app-{app}", f"Sources: {sig}"))
            if len(out) == n:
                return out
    return out


def _build_store(data: Path, corpus, capacity: int):
    """A GFKB on the card holding ``corpus``, upserted in batches of
    RESTART_BATCH with mining on; returns it and each batch's timestamp."""
    from kakveda_tpu_torch.index.gfkb import GFKB

    store = GFKB(data_dir=data, capacity=capacity, dim=DIM)
    batch_ts = []
    for lo in range(0, len(corpus), RESTART_BATCH):
        res = store.upsert_failures_batch([
            {"failure_type": ft, "signature_text": sig, "app_id": app, "impact_severity": "medium"}
            for ft, app, sig in corpus[lo : lo + RESTART_BATCH]
        ])
        if not all(created for _, created in res):
            raise AssertionError(f"phase 11: batch at {lo} re-upserted a signature")
        batch_ts.append(res[0][0].updated_at.timestamp())
    store.mine_drain()
    return store, batch_ts


EMIT_N = 1 << 13  # measure_emission's smaller store (a reading with no check: the smoke's depth, ROADMAP)


def measure_emission(base: Path, card: str) -> dict:
    """A full mine's wall where every cluster spans apps (``spread=1``, as
    ``parity_corpus``) at EMIT_N and 2 x EMIT_N rows, beside phase 11's
    spread of 64 at 2 x EMIT_N. Each spread cluster upserts into one of three patterns (named by
    failure type) and the mine keeps every upsert's view, a copy of the whole
    membership so far, so the emission grows with the square of the spread
    clusters (the JAX package's ``_pattern_view`` too); 651 s at 2^19 rows."""
    from kakveda_tpu_torch.pipeline.patterns import PatternDetector

    out = {}
    for n, spread in ((EMIT_N, 1), (2 * EMIT_N, 1), (2 * EMIT_N, 64)):
        store, _ = _build_store(base / f"emit-{n}-{spread}", restart_corpus(n, spread=spread), 1 << 17)
        t = time.perf_counter()
        pats, info = PatternDetector(store).mine_patterns_ex(0.6, mode="full")
        wall = time.perf_counter() - t
        members = sum(len(p.failure_ids) for p in pats)
        out[f"{n}/{spread}"] = {"full_mine_s": wall, "upserts": len(pats), "view_members": members}
        log(f"phase 11 emission: {n} rows, 1 cluster in {spread} spanning apps: full mine {wall:.3f} s, "
            f"{len(pats)} pattern upserts whose views hold {members} failure ids in all [{card}]")
        store.close()
        del store, pats
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _same_records(a, b) -> bool:
    return [(r.failure_id, r.version, r.occurrences, tuple(r.affected_apps)) for r in a._records] == [
        (r.failure_id, r.version, r.occurrences, tuple(r.affected_apps)) for r in b._records
    ]


def _same_buffers(a, b) -> bool:
    return torch.equal(a._emb, b._emb) and torch.equal(a._valid, b._valid) and torch.equal(a._types, b._types)


def _same_matches(a, b, queries) -> bool:
    ma, mb = a.match_batch(queries), b.match_batch(queries)
    return [[(m.failure_id, m.score) for m in row] for row in ma] == [
        [(m.failure_id, m.score) for m in row] for row in mb
    ]


def start_crash_sweep() -> tuple:
    """Phase 11's crash sweep at the two fence sites, its children on the
    card, on a thread: (thread, its result, its start). It starts after
    phases 18 and 19 (whose readings of the card's memory and of latency it
    would disturb) and runs beside phase 12's untimed stages, which joins it
    before its first timed one (phase 11 alone: beside its untimed build)."""
    from kakveda_tpu_torch.index.crashsweep import run_sweep

    sweep_out: dict = {}

    def sweep() -> None:
        try:
            sweep_out.update(run_sweep(rows=10, aged=5, sites=("gfkb.compact_fence", "gfkb.compact_swap"),
                                       device="cuda"))
        except Exception as e:  # noqa: BLE001 — reported and failed in phase 11
            sweep_out["error"] = f"{type(e).__name__}: {e}"

    t_sweep = time.perf_counter()
    sweeper = threading.Thread(target=sweep, name="crash-sweep")
    sweeper.start()
    return sweeper, sweep_out, t_sweep


def phase_restart(base: Path, fused_topk_reference, card: str, sweep: tuple, beside=()) -> dict:
    """Phase 11 in the pre-tiered configuration (``KAKVEDA_GFKB_TIERED=0``:
    no hot cap, no router, no cold tier; the warm mirror stays):
    ``restart_corpus`` has no coarse structure, so the default router
    spawns a centroid per cluster, and ``measure_router``, under the
    default ``TierConfig`` after it, measures what that costs. Phase 12
    runs the tiered lifecycle. ``sweep``: ``start_crash_sweep()``'s;
    ``beside``: threads of other phases' child processes started before
    it, joined with the crash sweep."""
    before = os.environ.get("KAKVEDA_GFKB_TIERED")
    os.environ["KAKVEDA_GFKB_TIERED"] = "0"
    try:
        out = _phase_restart(base, fused_topk_reference, card, sweep, beside)
    finally:
        if before is None:
            os.environ.pop("KAKVEDA_GFKB_TIERED", None)
        else:
            os.environ["KAKVEDA_GFKB_TIERED"] = before
    out["router"] = measure_router(base, card)
    log("phase 11 router: " + json.dumps(out["router"]))
    return out


ROUTER_N = 1 << 14  # 4 batches; the router's cost per batch grows with its centroids (a reading: ROADMAP)


def measure_router(base: Path, card: str) -> dict:
    """The default ``TierConfig`` on ROUTER_N rows of ``restart_corpus``
    (random-word clusters: nothing coarse to partition) and of
    ``tier_corpus`` (prompt templates), each through
    ``upsert_failures_batch`` x RESTART_BATCH into a GFKB on the card with
    mining on: build rows/s; ``CoarseRouter.add_batch``'s ms per batch
    against the centroid count C it scored against; for ``restart_corpus``,
    a least-squares line through them, summed over the batches of phase
    11's RESTART_N-row build and of phase 12's TIER_N rows, as C grows
    in this run's ratio of centroids to rows; the [B, C] f32 score matrix of the
    last batch; the routed match over every row (what a degraded warn
    runs, and what the overflow runs past the cap) at B = 1 and 64, p50,
    and its top-1 recall against the exact host scan over the same 64
    stored signatures."""
    import numpy as np

    from kakveda_tpu_torch.index.gfkb import GFKB

    out = {}
    corpora = (("restart_corpus", [r[2] for r in restart_corpus(ROUTER_N)]),
               ("tier_corpus", [r[5] for r in tier_corpus(ROUTER_N)]))
    for name, sigs in corpora:
        store = GFKB(data_dir=base / f"router-{name}", capacity=ROUTER_N, dim=DIM)
        router = store._tiers.router
        add = router.add_batch
        per = []

        def timed(*a, **k):
            c = router.c
            t = time.perf_counter()
            try:
                return add(*a, **k)
            finally:
                per.append((c, (time.perf_counter() - t) * 1e3))

        router.add_batch = timed
        t = time.perf_counter()
        for lo in range(0, ROUTER_N, RESTART_BATCH):
            store.upsert_failures_batch([
                {"failure_type": RESTART_TYPES[0], "signature_text": sig, "app_id": "app-r",
                 "impact_severity": "medium"} for sig in sigs[lo : lo + RESTART_BATCH]
            ])
        build_s = time.perf_counter() - t
        del router.add_batch
        if store.count != ROUTER_N or not router.covers(ROUTER_N) or len(per) != ROUTER_N // RESTART_BATCH:
            raise AssertionError(f"router measure on {name}: {store.count} rows, {len(per)} router updates")
        cs = np.array([c for c, _ in per], np.float64)
        ms = np.array([m for _, m in per], np.float64)
        per_row = router.c / ROUTER_N
        fit = projected = None
        if name == "restart_corpus":  # C grows with the rows: the line and its sums
            slope, icpt = np.polyfit(cs, ms, 1)
            fit = {"intercept_ms": float(icpt), "ms_per_1000_centroids": float(slope * 1e3)}
            projected = {
                label: float((icpt + slope * per_row * np.arange(0, rows, RESTART_BATCH, dtype=np.float64)).sum()
                             / 1e3)
                for label, rows in (("phase 11", RESTART_N), ("phase 12", TIER_N))
            }

        rng = np.random.default_rng(16)
        q_idx, q_val = store.featurizer.encode_batch_sparse([sigs[int(i)] for i in rng.choice(ROUTER_N, 64,
                                                                                                replace=False)])
        routed = store._tiers.match_host_batch(q_idx, q_val, store.top_k, exact=False)
        exact = store._tiers.match_host_batch(q_idx, q_val, store.top_k, exact=True)
        recall = sum(1 for r, e in zip(routed, exact) if r[1][0] == e[1][0] or r[0][0] >= e[0][0] - 1e-6) / 64
        match_ms = {}
        for b, calls in ((1, 20), (64, 5)):
            walls = []
            for _ in range(calls):
                t = time.perf_counter()
                store._tiers.match_host_batch(q_idx[:b], q_val[:b], store.top_k, exact=False)
                walls.append((time.perf_counter() - t) * 1e3)
            match_ms[b] = statistics.median(walls)
        out[name] = dict(
            rows=ROUTER_N, build_s=build_s, rows_per_s=ROUTER_N / build_s, centroids=router.c,
            splits=router.splits, router_ms_first=float(ms[0]), router_ms_last=float(ms[-1]),
            router_s_total=float(ms.sum() / 1e3), fit=fit, projected_router_s=projected,
            score_matrix_bytes_last=int(RESTART_BATCH * cs[-1] * 4), routed_p50_ms=match_ms, recall_top1=recall,
        )
        line = "" if fit is None else (
            f", fit {fit['intercept_ms']:.1f} ms + {fit['ms_per_1000_centroids']:.2f} ms per 1000 centroids, "
            f"which summed over phase 11's {RESTART_N}-row build is {projected['phase 11']:.0f} s and over phase 12's {TIER_N} rows "
            f"{projected['phase 12']:.0f} s")
        log(f"phase 11 router, default TierConfig on {ROUTER_N} rows of {name}: build {build_s:.1f} s "
            f"({ROUTER_N / build_s:.1f} rows/s, mining on), {router.c} centroids, {router.splits} splits; "
            f"add_batch {ms[0]:.1f} ms at the first batch, {ms[-1]:.1f} ms at the last (C = {int(cs[-1])}, its "
            f"[{RESTART_BATCH}, C] f32 scores {int(RESTART_BATCH * cs[-1] * 4)} bytes), {ms.sum() / 1e3:.1f} s in "
            f"all{line}; routed match over every row p50 {match_ms[1]:.3f} ms at B = 1, {match_ms[64]:.3f} ms at B = 64, "
            f"top-1 recall {recall:.4f} against the exact scan [{card}]")
        store.close()
        del store, router
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _phase_restart(base: Path, fused_topk_reference, card: str, sweep: tuple, beside=()) -> dict:
    """Phase 11: the GFKB's durable lifecycle on the card at RESTART_N rows
    of a ROWS x DIM index. Build (mining on) → snapshot, timed by stage →
    full replay (snapshot moved aside) and its first mine, a full sweep →
    restore, timed by stage, which must take the restore path → the
    restored buffers bit-equal to the replay's, equal warns, the restored
    labels equal to the build's and the sweep's, an incremental first mine
    → aging of a known 1/8 (no warn returns an aged row, held against a
    plain top-k over the live rows), an organic resurrection (its row
    bit-equal to before), a compaction that reopens identically → the
    pattern emission's growth (``measure_emission``). The crash sweep at the
    two fence sites (``sweep``, started after phase 18) runs beside the
    untimed build, its children on the card, and is joined before the
    first timed stage, with the threads of ``beside`` (phase 12 d's child,
    started before this phase)."""
    import numpy as np

    from kakveda_tpu_torch.index.gfkb import GFKB
    from kakveda_tpu_torch.pipeline.patterns import PatternDetector

    sweeper, sweep_out, t_sweep = sweep

    n = RESTART_N
    data = base / "gfkb"
    out: dict = {"rows": n, "capacity": ROWS, "dim": DIM, "apps_spread_every": 64}
    t = time.perf_counter()
    corpus = restart_corpus(n)
    gen_s = time.perf_counter() - t
    t = time.perf_counter()
    store, batch_ts = _build_store(data, corpus, ROWS)
    build_s = time.perf_counter() - t
    st = store.mine_state_info()
    if store.count != n or st["stale"] or not st["covers_all_rows"] or st["evictions"]:
        raise AssertionError(f"phase 11 build: {store.count} rows, mining {st}")
    build_labels = store._mine.labels()
    log(f"phase 11 build: {n} distinct signatures (drawn in {gen_s:.1f} s; 1 cluster in 64 spans apps, not "
        f"every cluster as in parity_corpus, since a full mine's pattern emission grows with the square of "
        f"the spread clusters: see the emission lines) through upsert_failures_batch x {RESTART_BATCH} with "
        f"mining on in {build_s:.1f} s (untimed set-up), {st['delta_dispatches']} "
        f"delta dispatches, {int(len(np.unique(build_labels)))} clusters, no list evicted [{card}]")

    # No child may run during a timed stage.
    t = time.perf_counter()
    sweeper.join()
    sweep_s = time.perf_counter() - t_sweep
    for th in beside:
        th.join()
    log(f"phase 11: waited {time.perf_counter() - t:.1f} s for the crash sweep ({sweep_s:.1f} s in all) and "
        f"{[th.name for th in beside]} ({time.perf_counter() - t_sweep:.1f} s since the sweep started) before "
        f"the first timed stage [{card}]")
    if "error" in sweep_out or sweep_out.get("corrupt_recoveries") != 0 or sweep_out.get("kill_points", 0) < 2:
        raise AssertionError(f"phase 11 crash sweep: {sweep_out}")
    if not str(sweep_out["device"]).startswith("cuda"):
        raise AssertionError(f"phase 11 crash sweep ran on {sweep_out['device']}")
    out["crash_sweep"] = {k: sweep_out[k] for k in ("kill_points", "corrupt_recoveries", "sites", "stable_queries")}
    out["crash_sweep_s"] = sweep_s
    log(f"phase 11 crash sweep (children on {sweep_out['device']}, {sweep_s:.1f} s): {sweep_out['kill_points']} "
        f"kill points at {sweep_out['sites']}, 0 corrupt recoveries [{card}]")

    t = time.perf_counter()
    store.snapshot()
    out["snapshot_s"] = time.perf_counter() - t
    snap = store.lifecycle_info()["snapshot"]
    out["snapshot"] = snap
    out["log_bytes"] = store.failures_path.stat().st_size
    store.close()
    del store
    gc.collect()
    torch.cuda.empty_cache()
    sec = snap["seconds"]
    log(f"phase 11 snapshot of {n} rows: {out['snapshot_s']:.3f} s = capture {sec['capture']:.3f} + device copy "
        f"{sec['device_copy']:.3f} + sparsify on the card and d2h {sec['sparse_gather']:.3f} + stack "
        f"{sec['stack']:.3f} + disk write {sec['write']:.3f}; payload {snap['bytes']} bytes, failures.jsonl "
        f"{out['log_bytes']} bytes [{card}]")

    sd, aside = data / "snapshot", data / "snapshot.aside"
    sd.rename(aside)
    t = time.perf_counter()
    a = GFKB(data_dir=data, capacity=ROWS, dim=DIM)
    out["replay_open_s"] = time.perf_counter() - t
    if a.lifecycle_info()["restore"] is not None or a.count != n or a.mine_usable(0.6):
        raise AssertionError(f"phase 11: store A did not fully replay: {a.lifecycle_info()['restore']}")
    t = time.perf_counter()
    _, a_info = PatternDetector(a).mine_patterns_ex(0.6)
    out["replay_first_mine_s"] = time.perf_counter() - t
    if a_info["mode"] != "full":
        raise AssertionError(f"phase 11: A's first mine was {a_info['mode']}, not the full sweep")
    a.close()
    sweep_labels = a._mine.labels()
    log(f"phase 11 full replay (snapshot moved aside): open {out['replay_open_s']:.3f} s; first mine, a full sweep, "
        f"{out['replay_first_mine_s']:.3f} s [{card}]")

    aside.rename(sd)
    t = time.perf_counter()
    b = GFKB(data_dir=data, capacity=ROWS, dim=DIM)
    out["restore_open_s"] = time.perf_counter() - t
    restore = b.lifecycle_info()["restore"]
    if not restore or restore["rows"] != n:
        raise AssertionError(f"phase 11: store B did not take the restore path: {restore}")
    out["restore"] = restore
    rs = restore["seconds"]
    log(f"phase 11 restore: open {out['restore_open_s']:.3f} s = verify (checksums) {rs['verify']:.3f} + records "
        f"{rs['records']:.3f} + payload load {rs['payload']:.3f} + device insert {rs['insert']:.3f} + labels "
        f"{rs['labels']:.3f} + the rest {out['restore_open_s'] - sum(rs.values()):.3f} (tail from byte "
        f"{restore['log_offset']}) [{card}]")

    if not _same_buffers(a, b):
        raise AssertionError("phase 11: restored emb/valid/types differ from the full replay's")
    if not _same_records(a, b):
        raise AssertionError("phase 11: restored records differ from the full replay's")
    rng = np.random.default_rng(12)
    held = [f"Sources: {' '.join('yy' + w[2:] if k == 3 else w for k, w in enumerate(corpus[int(i)][2][9:].split()))}"
            for i in rng.choice(n, 64, replace=False)]
    if not _same_matches(a, b, held):
        raise AssertionError("phase 11: match_batch of the restored store differs from the full replay's")
    b_labels = b._mine.labels()
    if not (np.array_equal(b_labels, build_labels) and np.array_equal(b_labels, sweep_labels)):
        raise AssertionError("phase 11: restored labels differ from the build's or the full sweep's partition")
    t = time.perf_counter()
    _, b_info = PatternDetector(b).mine_patterns_ex(0.6)
    out["restore_first_mine_s"] = time.perf_counter() - t
    if b_info["mode"] != "incremental":
        raise AssertionError(f"phase 11: B's first mine was {b_info['mode']}, not incremental")
    log(f"phase 11 B == A: emb, valid, types bit-equal; records equal; 64 held-out warns equal (ids, ties, "
        f"scores); labels = the build's = the sweep's ({int(len(np.unique(b_labels)))} clusters); first mine "
        f"incremental in {out['restore_first_mine_s'] * 1e3:.3f} ms against the sweep's "
        f"{out['replay_first_mine_s']:.3f} s [{card}]")
    del a
    gc.collect()

    # Aging: the first RESTART_AGED_BATCHES batches predate the cut.
    n_aged = min(RESTART_AGED_BATCHES, len(batch_ts) - 1) * RESTART_BATCH
    cut = (batch_ts[n_aged // RESTART_BATCH - 1] + batch_ts[n_aged // RESTART_BATCH]) / 2
    victim = 5
    before = (b._emb[victim].clone(), bool(b._valid[victim]), int(b._types[victim]))
    t = time.perf_counter()
    aged = b.age_rows(ttl_s=1000.0, now=cut + 1000.0)
    out["age_s"] = time.perf_counter() - t
    if aged["tombstoned"] != n_aged or sorted(b._tombstoned) != list(range(n_aged)):
        raise AssertionError(f"phase 11: aging retired {aged['tombstoned']} rows, not the first {n_aged}")
    sigs = [corpus[int(i)][2] for i in np.concatenate([rng.choice(n_aged, 32, replace=False),
                                                       n_aged + rng.choice(n - n_aged, 32, replace=False)])]
    got = b.match_batch(sigs)
    if any(b._slot_by_id[m.failure_id] < n_aged for row in got for m in row):
        raise AssertionError("phase 11: a warn returned an aged row")
    q_idx, q_val = b.featurizer.encode_batch_sparse(sigs)
    from kakveda_tpu_torch.ops.knn import to_device

    q = b._knn.densify(to_device(q_idx, np.int32, b.device), to_device(q_val, np.float32, b.device))
    live = b._valid.clone()
    live[:n_aged] = False
    rv, ri = fused_topk_reference(b._emb, live, q, b.top_k)
    rv = rv.clamp(-1.0, 1.0)  # as match_batch reports cosines: a bf16 self-match may pass 1.0
    if any(len(row) != b.top_k for row in got):
        raise AssertionError("phase 11: a warn returned fewer than k live rows")
    gv = torch.tensor([[m.score for m in row] for row in got], device=rv.device)
    gi = torch.tensor([[b._slot_by_id[m.failure_id] for m in row] for row in got], device=ri.device, dtype=ri.dtype)
    err = check_topk(gv, gi, rv, ri, "phase 11 warns vs a plain top-k over the live rows")
    rec, created = b.upsert_failure(failure_type=corpus[victim][0], signature_text=corpus[victim][2],
                                    app_id="app-back", impact_severity="medium")
    after = (b._emb[victim], bool(b._valid[victim]), int(b._types[victim]))
    if created or victim in b._tombstoned or not torch.equal(after[0], before[0]) or after[1:] != before[1:]:
        raise AssertionError("phase 11: the resurrected row is not its pre-tombstone row")
    log(f"phase 11 aging: {aged['tombstoned']} rows (the first 1/8) tombstoned in {out['age_s']:.3f} s; 64 warns "
        f"(32 of aged signatures) return no aged row and equal a plain top-k over the live rows "
        f"(max |score - plain| {err:.3g}); an organic upsert resurrected {rec.failure_id} bit-equal [{card}]")

    t = time.perf_counter()
    comp = b.compact()
    out["compact_s"] = time.perf_counter() - t
    out["compact"] = comp
    b.close()
    t = time.perf_counter()
    c = GFKB(data_dir=data, capacity=ROWS, dim=DIM)
    out["reopen_s"] = time.perf_counter() - t
    cinfo = c.lifecycle_info()
    if not (cinfo["restore"] and cinfo["restore"]["rows"] == n and cinfo["compact_generation"] == 1
            and c._tombstoned == b._tombstoned and _same_buffers(b, c) and _same_records(b, c)
            and _same_matches(b, c, held + sigs)):
        raise AssertionError(f"phase 11: the compacted store did not reopen identically: {cinfo}")
    log(f"phase 11 compact: {out['compact_s']:.3f} s, failures.jsonl {comp['bytes_before']} -> {comp['bytes_after']} "
        f"bytes, {comp['tombstone_lines']} tombstone lines; reopened in {out['reopen_s']:.3f} s with buffers, "
        f"records, {len(c._tombstoned)} tombstones and warns identical [{card}]")
    c.close()
    del b, c
    gc.collect()

    out["emission"] = measure_emission(base, card)
    log("phase 11: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 12: the host tiers past the hot cap, and device loss
# ---------------------------------------------------------------------------

# Phase 12's hot cap, set with the reference's own knob (KAKVEDA_GFKB_HOT_ROWS;
# its default, 2^20, is the card index's capacity, which stays 2^20 here):
# the smoke's depth (ROADMAP). An overflow of 2^16 rows past it, half warm,
# half cold (the default warm budget of 2^22 would take 4.2M rows to reach
# the cold tier).
TIER_HOT = 1 << 18
TIER_N = TIER_HOT + (1 << 16)
TIER_WARM = TIER_HOT + (1 << 15)
TIER_BATCH = 4096
TIER_ASKS = (
    "summarize it and include citations even if not provided",
    "explain why with references",
    "give a short summary",
    "describe the steps taken",
    "list the sources",
    "answer briefly",
)
TIER_TOOLS = ((), ("web_search",), ("retriever", "web_search"), ("sql_query",), ("calculator", "code_exec"))
TIER_ENVS = ((), ("model", "temperature"), ("region", "tenant"), ("model", "region", "temperature"))
# Phase 12 d's child: a hot cap of 2^14 and 2^13 overflow rows past it (the
# host takes the routed path past 4,096 overflow rows; the child's warns
# must). Its build is the child's wall: the overflow rows attach to mining
# from the host tiers at 136-189 rows/s on the H100's host (2^14 of them
# took 107.7 s of a 124.3 s child), the hot ones at 6,100-8,300 rows/s.
STICKY_HOT = 1 << 14
STICKY_ROWS = STICKY_HOT + (1 << 13)


def tier_corpus(n: int, seed: int = 12, per_template: int = 1280):
    """``n`` distinct failures as (type, app, prompt, tools, env keys,
    signature), the signature ``signature_text(prompt, tools, env)``. Apps
    run prompt templates: n / ``per_template`` templates of six random
    four-letter words, each with an ask (which sets the intent tags), a tool
    set and env keys; a failure cluster (1-7 members) adds seven words,
    member j changing word j. Same-template rows share their tags, tools
    and template words (cosine ~0.7), other templates share at most the
    tags: the coarse structure the router partitions. That structure is
    assumed, not taken from a traffic source: no trace source in the repo
    shows how real failures group into templates. ``restart_corpus`` has
    none (every cluster is random words), so the router spawns one centroid
    per cluster there (``tests/test_torch_tiers.py``); ``measure_router``
    measures both corpora under the default ``TierConfig``."""
    import numpy as np

    from kakveda_tpu_torch.core.fingerprint import prompt_intent_tags

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz", np.uint8)
    n_t = max(1, n // per_template)
    tw = alpha[rng.integers(0, 26, size=(n_t, 6, 4))].view("S4")[..., 0].astype(str).tolist()
    meta = []
    for t in range(n_t):
        ask = TIER_ASKS[int(rng.integers(len(TIER_ASKS)))]
        tools = TIER_TOOLS[int(rng.integers(len(TIER_TOOLS)))]
        env = TIER_ENVS[int(rng.integers(len(TIER_ENVS)))]
        tags = ",".join(prompt_intent_tags(ask))  # random words hold no keyword
        meta.append((ask, tools, env, f" | tools:{','.join(sorted(tools))} | env_keys:{','.join(env)}", tags))
    sizes = rng.integers(1, 8, size=n)
    n_cl = int(np.searchsorted(np.cumsum(sizes), n)) + 1
    cw = alpha[rng.integers(0, 26, size=(n_cl, 7, 4))].view("S4")[..., 0].astype(str).tolist()
    ct = rng.integers(0, n_t, size=n_cl).tolist()
    out = []
    for c in range(n_cl):
        t = ct[c]
        ask, tools, env, tail, tags = meta[t]
        head, w = " ".join(tw[t]), cw[c]
        for j in range(int(sizes[c])):
            prompt = f"{head} {' '.join(w[:j] + ['9' + w[j][1:]] + w[j + 1:])}. {ask}"
            sig = f"intent_tags:{tags} | prompt_hint:{prompt[:80]}{tail}"
            out.append((RESTART_TYPES[c % 3], f"app-{c % 8}", prompt, tools, env, sig))
            if len(out) == n:
                return out
    return out


def _tier_requests(rows, app="app-w"):
    from kakveda_tpu_torch.core.schemas import WarningRequest

    return [WarningRequest(app_id=app, prompt=p, tools=list(tl), env={k: "x" for k in env})
            for _, _, p, tl, env, _ in rows]


def _tier_build(store, corpus, label: str, card: str, batch_ts: Optional[list] = None) -> dict:
    """Upsert ``corpus`` in TIER_BATCH batches; rows/s of the batches below
    and past the hot cap. ``batch_ts`` gets each batch's timestamp."""
    walls = {"hot": [], "overflow": []}
    for lo in range(0, len(corpus), TIER_BATCH):
        t = time.perf_counter()
        res = store.upsert_failures_batch([
            {"failure_type": ft, "signature_text": sig, "app_id": app, "impact_severity": "medium"}
            for ft, app, _, _, _, sig in corpus[lo : lo + TIER_BATCH]
        ])
        walls["overflow" if lo >= store._hot_cap() else "hot"].append(time.perf_counter() - t)
        if not all(created for _, created in res):
            raise AssertionError(f"{label}: batch at {lo} re-upserted a signature")
        if batch_ts is not None:
            batch_ts.append(res[0][0].updated_at.timestamp())
    out = {k: {"batches": len(v), "rows_per_s": len(v) * TIER_BATCH / sum(v)} for k, v in walls.items() if v}
    log(f"{label} build: " + json.dumps(out) + f" [{card}]")
    return out


def _answers(res):
    return [(r.action, r.confidence, tuple(m.failure_id for m in r.references), r.tier, r.degraded) for r in res]


def _agreement(store, sig: str, a, b, tol: float, threshold: float = 0.8) -> str:
    """How two warn answers to ``sig`` agree: "equal" (action, top-1 and
    confidence within ``tol``), "tie" (the confidences within ``tol`` and the
    two top-1 rows scoring within ``tol`` of each other against the query,
    in f32 on the host: rows tied at bf16 precision, whose order the card's
    bf16 scores and the host's f32 ones may break differently), or
    "threshold" (the confidences within ``tol`` of each other and of the
    threshold, so the action, or whether a reference is kept, sits on the
    tie), "routed miss" (b's
    best is worse by more than ``tol``: b routed over candidate lists that
    lacked a's top-1, which an exact scan found); else "differ"."""
    import numpy as np

    if b.confidence < a.confidence - tol:
        return "routed miss"  # b's routed candidates lacked a's top-1
    if abs(a.confidence - b.confidence) > tol:
        return "differ"
    ra = a.references[0].failure_id if a.references else None
    rb = b.references[0].failure_id if b.references else None
    if a.action == b.action and ra == rb:
        return "equal"
    if a.action != b.action or ra is None or rb is None:  # a reference is kept only at the threshold or above
        return "threshold" if abs(a.confidence - threshold) <= tol else "differ"
    q_idx, q_val = store.featurizer.encode_batch_sparse([sig])
    qd = store._tiers.densify_query(q_idx[0], q_val[0])
    sc = []
    for fid in (ra, rb):
        idx, val = store._tiers.row(store._slot_by_id[fid])
        sc.append(float((qd[np.minimum(idx, store.featurizer.dim)] * val).sum()))
    return "tie" if abs(sc[0] - sc[1]) <= tol else "differ"


def sticky_child(data: Path, rows: int, hot: int) -> int:
    """Phase 12 d, in its own process on the card: a ``rows``-row store with
    the hot cap at ``hot`` (mining on, so the overflow rows attach from the
    tiers), warns recorded, then a device-side assert poisons the CUDA
    context. The warns must answer degraded and equal the recorded ones,
    the probe keep failing and generation fail fast. Prints one JSON line;
    exits 0 when every check held (os._exit: the poisoned context is not
    torn down)."""
    import numpy as np

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    os.environ.update(KAKVEDA_GFKB_HOT_ROWS=str(hot), KAKVEDA_DEGRADED_PROBE="1", KAKVEDA_NATIVE="require")
    from kakveda_tpu_torch.core.admission import DeviceUnavailableError, get_device_health
    from kakveda_tpu_torch.core.fingerprint import signature_text
    from kakveda_tpu_torch.index.gfkb import GFKB, fallback_total
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy

    t_child = time.perf_counter()
    out: dict = {"rows": rows, "hot": hot}
    corpus = tier_corpus(rows + 64, seed=13, per_template=640)
    store = GFKB(data_dir=data, capacity=hot, dim=DIM)
    t = time.perf_counter()
    out["set_up_s"] = t - t_child
    out["build"] = _tier_build(store, corpus[:rows], "phase 12 d child", "child")
    out["build_s"] = time.perf_counter() - t
    st = store.mine_state_info()
    out["mining"] = {k: st[k] for k in ("stale", "covers_all_rows", "tier_attaches", "delta_dispatches")}
    out["attach_ok"] = bool(not st["stale"] and st["covers_all_rows"] and st["tier_attaches"] == rows - hot)
    rt = LlamaRuntime(cfg=LlamaConfig(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, max_seq_len=256), device="cuda")
    rng = np.random.default_rng(14)
    pick = np.concatenate([rng.choice(hot, 24, replace=False), hot + rng.choice(rows - hot, 24, replace=False)])
    reqs = _tier_requests([corpus[int(i)] for i in pick] + corpus[rows : rows + 16])
    policy = WarningPolicy(store)
    before = policy.warn_batch(reqs)
    out["before_tiers"] = sorted({r.tier for r in before})
    health = get_device_health()
    # The poison: an out-of-range index trips the gather kernel's
    # device-side assert. Nothing here waits for it: the next CUDA call
    # (the warn's dispatch or its fetch) is what reports it.
    x = torch.zeros(4, device="cuda")
    x[torch.tensor([1 << 20], device="cuda")]
    time.sleep(0.5)
    t = time.perf_counter()
    after = policy.warn_batch(reqs)
    out["degraded_warn_s"] = time.perf_counter() - t
    out["reason"] = health.info()["reason"]
    out["all_degraded"] = all(r.degraded for r in after) and health.degraded
    out["after_tiers"] = sorted({r.tier for r in after})
    sigs = [signature_text(r.prompt, r.tools, r.env) for r in reqs]
    kinds = [_agreement(store, q, a, b, 1e-2) for q, a, b in zip(sigs, before, after)]
    out["agreement"] = {k: kinds.count(k) for k in ("equal", "tie", "threshold", "routed miss", "differ")}
    out["stored_equal"] = kinds[:48].count("equal")
    out["max_conf_diff"] = max(abs(a.confidence - b.confidence) for a, b in zip(before, after))
    out["queries"] = len(reqs)
    out["fallback"] = fallback_total()
    time.sleep(2.5)  # two probe intervals: the poisoned context keeps failing it
    out["probes"] = dict(health.probes)
    out["still_degraded"] = health.degraded
    t = time.perf_counter()
    try:
        rt.generate_batch(["a prompt"], max_tokens=4)
        out["generate"] = "ran"
    except DeviceUnavailableError:
        out["generate"] = "DeviceUnavailableError"
    out["generate_s"] = time.perf_counter() - t
    out["ok"] = bool(
        out["attach_ok"] and out["all_degraded"] and out["agreement"]["equal"] + out["agreement"]["tie"]
        + out["agreement"]["threshold"] == len(reqs) and out["stored_equal"] == 48
        and out["before_tiers"] == ["tiered"]
        and out["still_degraded"] and out["probes"]["fail"] >= 1 and out["probes"]["ok"] == 0
        and out["generate"] == "DeviceUnavailableError" and out["generate_s"] < 1.0
        and out["fallback"] == len(reqs)
    )
    print("STICKY " + json.dumps(out), flush=True)
    sys.stderr.flush()
    os._exit(0 if out["ok"] else 1)


def _run_sticky_child(data: Path, sink: dict) -> None:
    """Phase 12 d's child (this script with ``--sticky-child``), beside the
    parent's untimed build; ``sink`` gets its JSON line or its failure."""
    env = {k: v for k, v in os.environ.items() if k not in ("KAKVEDA_MINE_INCREMENTAL", "KAKVEDA_GFKB_WARM_ROWS")}
    t = time.perf_counter()
    try:
        p = subprocess.run(
            [sys.executable, str(Path(__file__).resolve()), "--sticky-child", str(data),
             str(STICKY_ROWS), str(STICKY_HOT)],
            capture_output=True, text=True, timeout=600, env=env,
        )
        line = next((ln for ln in p.stdout.splitlines() if ln.startswith("STICKY ")), None)
        sink.update(rc=p.returncode, result=json.loads(line[7:]) if line else None,
                    tail=(p.stdout + p.stderr)[-3000:], wall_s=time.perf_counter() - t)
    except Exception as e:  # noqa: BLE001 — reported and failed by the parent
        sink["error"] = f"{type(e).__name__}: {e}"


DRILL_WARNS = 1024 + 1  # phase 12 c: 1,024 warns and one /warn through make_app


def check_healthy(after: str) -> None:
    """Phase 12 f: on a healthy path the latch never moved and no warn
    took the host fallback; the device-loss drills so far (``DRILLS``:
    phase 19 a's storm, phase 12 c) account for every latch, un-latch and
    degraded warn."""
    from kakveda_tpu_torch.core.admission import get_device_health
    from kakveda_tpu_torch.index.gfkb import fallback_total

    n = DRILLS["latches"]
    tr = get_device_health().transitions
    if tr != {"degraded": n, "healthy": n} or fallback_total() != DRILLS["fallback"]:
        raise AssertionError(f"after {after}: latch transitions {tr}, fallback warns {fallback_total()}, drills "
                             f"{DRILLS}")
    log(f"after {after}: latch transitions {tr}, fallback warns {fallback_total()} (drills {DRILLS})")


def tier_split(plat, reqs, fused_topk, calls: int) -> dict:
    """Warn stages at one batch: p50 of ``calls`` ``Platform.warn_batch``
    walls, and per stage (medians of synchronized calls through wrappers on
    the real path): featurize, the hot ``fused_topk`` (upload + densify +
    kernel, with CUDA events; then the d2h), the host routed match over the
    overflow, the merge (the same numpy expressions re-run on the call's
    arrays), and the rest (signature text, tombstones, matches, responses).
    The routed match must score in C++: the scorer's ``ivf`` count (one a
    routed query) moves on every call and no fallback is counted."""
    import numpy as np

    from kakveda_tpu_torch.pipeline import warning as warning_mod

    gfkb = plat.gfkb
    scorer = gfkb._tiers.scorer
    calls0, fb0 = dict(scorer.calls), sum(scorer.fallbacks.values())
    for _ in range(3):
        plat.warn_batch(reqs)
    walls = []
    for _ in range(calls):
        t = time.perf_counter()
        plat.warn_batch(reqs)
        walls.append((time.perf_counter() - t) * 1e3)
    st = _Stages()
    seen = {}
    route = gfkb._tiers.match_host_batch
    fetch = gfkb._knn.topk_result

    def keep_route(*a, **k):
        seen["overflow"] = route(*a, **k)
        return seen["overflow"]

    def keep_fetch(*a, **k):
        seen["hot"] = fetch(*a, **k)
        return seen["hot"]

    gfkb._tiers.match_host_batch = keep_route
    gfkb._knn.topk_result = keep_fetch
    st.wrap(warning_mod, "signature_text", "signature_text", sync=False)
    st.wrap(gfkb.featurizer, "encode_batch_sparse", "featurize", sync=False)
    st.wrap(gfkb._knn, "topk_async_sparse", "hot fused_topk", events=True)
    st.wrap(gfkb._knn, "topk_result", "hot d2h")
    st.wrap(gfkb._tiers, "match_host_batch", "host routed match")
    st.wrap(plat.warning_policy, "warn_batch", "call")
    per = []
    try:
        for _ in range(min(calls, 20)):
            launches = fused_topk.launches
            plat.warn_batch(reqs)
            got = st.take()
            if gfkb.device.type == "cuda" and fused_topk.launches != launches + 1:
                raise AssertionError("phase 12: a healthy warn did not launch fused_topk once")
            scores, slots = seen["hot"]
            t = time.perf_counter()
            k = scores.shape[1]
            for i in range(len(reqs)):  # the merge of match_batch_info, re-run
                o_s, o_sl, _ = seen["overflow"][i]
                cs = np.concatenate([scores[i], o_s])
                csl = np.concatenate([slots[i], o_sl])
                order = np.argsort(-cs)[:k]
                cs[order], csl[order]
            got["host"]["merge"] = (time.perf_counter() - t) * 1e3
            per.append(got)
    finally:
        st.restore()
        del gfkb._tiers.match_host_batch, gfkb._knn.topk_result
    n_calls = 3 + calls + len(per)
    grew = {k: scorer.calls[k] - calls0[k] for k in scorer.calls}
    if grew["ivf"] < n_calls or sum(scorer.fallbacks.values()) != fb0:
        raise AssertionError(f"phase 12 b: {n_calls} warns made native scorer calls {grew}, "
                             f"fallbacks {scorer.fallbacks}")
    med = lambda key, kind="host": statistics.median(c[kind].get(key, 0.0) for c in per)  # noqa: E731
    stages = {k: med(k) for k in ("signature_text", "featurize", "hot fused_topk", "hot d2h", "host routed match",
                                  "merge")}
    stages["assembly (rest)"] = med("call") - sum(stages.values())
    return dict(b=len(reqs), p50_ms=statistics.median(walls), p99_ms=_pct(walls, 0.99), calls=calls,
                stages_host_ms=stages, hot_dev_ms=med("hot fused_topk", "dev"), synced_call_ms=med("call"),
                scorer_calls=grew, scorer_fallbacks=dict(scorer.fallbacks))


def phase_tiers(base: Path, fused_topk, fused_topk_reference, card: str, child: dict, child_runner,
                beside=()) -> dict:
    """Phase 12: a 2^20 x 2048 GFKB on the card under ``TierConfig`` with
    the hot cap at TIER_HOT (nprobe 8, max_list 4096) holding TIER_N rows
    of ``tier_corpus``: the card stops at the hot cap, the overflow lives in
    the host tiers (TIER_WARM warm, the rest cold). a. residency and host
    bytes; b. healthy warns (``tier == "tiered"``, stage split, the hot part
    against the plain top-k, routed top-1 recall against the exact host
    scan, every host scan in C++) and aging of the first 1/8; c. the
    ``device.unavailable`` drill; d. a real sticky CUDA error in a child
    process (``child``: its outcome, from ``child_runner``, a thread started
    beside this phase's untimed build and phase 11's crash sweep); e. ``compact()``, whose snapshot has the ``tiers`` section, and
    the restore, which installs the router; f. the latch and the fallback count
    stay 0 on every healthy path (checked here before the drill and after
    phases 4, 8 and 11 in ``main``)."""
    import aiohttp  # noqa: F401 — required: /warn and /readyz go through make_app
    import numpy as np
    from aiohttp.test_utils import TestClient, TestServer

    from kakveda_tpu_torch.core import faults
    from kakveda_tpu_torch.core.admission import DeviceUnavailableError, get_device_health
    from kakveda_tpu_torch.index.gfkb import GFKB, fallback_total
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.ops.knn import to_device
    from kakveda_tpu_torch.pipeline.warning import WarningPolicy
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.app import make_app

    env_before = {k: os.environ.get(k) for k in ("KAKVEDA_GFKB_WARM_ROWS", "KAKVEDA_MINE_INCREMENTAL",
                                                 "KAKVEDA_GFKB_HOT_ROWS")}
    os.environ["KAKVEDA_GFKB_HOT_ROWS"] = str(TIER_HOT)
    os.environ["KAKVEDA_GFKB_WARM_ROWS"] = str(TIER_WARM)
    os.environ["KAKVEDA_MINE_INCREMENTAL"] = "0"  # the build's cut: the overflow attach is d's
    out: dict = {"rows": TIER_N, "capacity": ROWS, "dim": DIM, "hot_rows": TIER_HOT, "warm_rows": TIER_WARM}
    try:
        t = time.perf_counter()
        corpus = tier_corpus(TIER_N + 4096)
        held = corpus[TIER_N:]
        corpus = corpus[:TIER_N]
        gen_s = time.perf_counter() - t
        from kakveda_tpu_torch.core.fingerprint import signature_text

        for row in corpus[:: TIER_N // 64] + held[:8]:
            if signature_text(row[2], row[3], {k: "x" for k in row[4]}) != row[5]:
                raise AssertionError(f"phase 12: tier_corpus's signature is not signature_text's: {row}")
        data = base / "gfkb"
        store = GFKB(data_dir=data, capacity=ROWS, dim=DIM)
        cfg = store._tiers.cfg
        if (cfg.hot_rows, cfg.nprobe, cfg.max_list, cfg.warm_rows) != (TIER_HOT, 8, 4096, TIER_WARM):
            raise AssertionError(f"phase 12: TierConfig {vars(cfg)}")
        t = time.perf_counter()
        batch_ts: list = []
        out["build"] = _tier_build(store, corpus, "phase 12", card, batch_ts)
        out["build_s"] = time.perf_counter() - t

        # a. residency
        info = store.tiers_info()
        out["tiers"] = info
        if not (store.count == TIER_N and info["hot"] == TIER_HOT and info["warm"] == TIER_WARM
                and info["cold"] == TIER_N - TIER_WARM and info["warm_overflow"] == 0
                and store._knn.capacity == ROWS and int(store._valid.sum()) == TIER_HOT
                and os.environ["KAKVEDA_GFKB_HOT_ROWS"] == str(TIER_HOT)):
            raise AssertionError(f"phase 12 a: {store.count} rows, capacity {store._knn.capacity}, {info}")
        log(f"phase 12 a: {TIER_N} rows of tier_corpus (drawn in {gen_s:.1f} s) through upsert_failures_batch x "
            f"{TIER_BATCH} in {out['build_s']:.1f} s (mining off): card {info['hot']} rows (capacity "
            f"{store._knn.capacity}, valid {int(store._valid.sum())}), warm {info['warm']} rows in "
            f"{info['warm_bytes']} host bytes (K = {info['warm_k']}), cold {info['cold']} rows in "
            f"{info['cold_bytes']} bytes of shards; router {info['centroids']} centroids, {info['splits']} "
            f"splits [{card}]")

        # Queries: 16 each of hot, warm-overflow and cold rows, 16 unseen.
        rng = np.random.default_rng(15)
        pick = lambda lo, hi, m: [corpus[int(i)] for i in lo + rng.choice(hi - lo, m, replace=False)]  # noqa: E731
        unseen = held[:8] + [("X", "app-x", f"unrelated question number {i} about the weather", (), (), "")
                             for i in range(8)]
        rows64 = pick(0, TIER_HOT, 16) + pick(TIER_HOT, TIER_WARM, 16) + pick(TIER_WARM, TIER_N, 16) + unseen
        reqs64 = _tier_requests(rows64)

        # b. healthy warns; the routed and exact host scans run in C++
        check_healthy("phase 12's build")
        scorer = store._tiers.scorer
        calls0 = dict(scorer.calls)
        policy = WarningPolicy(store)
        before = policy.warn_batch(reqs64)
        if {r.tier for r in before} != {"tiered"} or any(r.degraded for r in before):
            raise AssertionError(f"phase 12 b: tiers {[r.tier for r in before]}")
        q_idx, q_val = store.featurizer.encode_batch_sparse([r[5] or "" for r in rows64[:48]])
        routed = store._tiers.match_host_batch(q_idx, q_val, store.top_k, min_slot=TIER_HOT)
        exact = store._tiers.match_host_batch(q_idx, q_val, store.top_k, min_slot=TIER_HOT, exact=True)
        hits = sum(1 for r, e in zip(routed, exact) if r[1][0] == e[1][0] or r[0][0] >= e[0][0] - 1e-6)
        out["recall_top1"] = hits / len(exact)
        if out["recall_top1"] < 0.99 or {m for *_, m in routed} != {"routed"}:
            raise AssertionError(f"phase 12 b: routed top-1 recall {out['recall_top1']}")
        full = store._tiers.match_host_batch(q_idx, q_val, store.top_k, exact=True)
        own = sum(1 for r, e in zip(before[:48], full) if r.references
                  and store._slot_by_id[r.references[0].failure_id] == int(e[1][0]))
        grew = {k: scorer.calls[k] - calls0[k] for k in scorer.calls}
        out["scorer"] = dict(calls=grew, fallbacks=dict(scorer.fallbacks))
        if not (scorer.enabled and scorer.require and grew["ivf"] > 0 and grew["cold"] > 0 and grew["warm"] > 0
                and not any(scorer.fallbacks.values())):
            raise AssertionError(f"phase 12 b: the host scans did not all run in C++: {out['scorer']}")
        log(f"phase 12 b: routed top-1 recall over the overflow {out['recall_top1']:.4f} (48 queries against the "
            f"exact host scan); the warn's top-1 is the exact full scan's for {own} of 48 stored signatures; "
            f"native scorer calls {grew}, fallbacks {scorer.fallbacks} [{card}]")

        # Aging on the tiered store: the first 1/8 of the batches, with 16
        # cold rows paged into the promote-LRU first (exempt, though aging
        # is a time cut and the cold rows are the newest).
        n_aged_b = len(batch_ts) // 8
        n_aged = n_aged_b * TIER_BATCH
        for slot in TIER_WARM + rng.choice(TIER_N - TIER_WARM, 16, replace=False):
            if store._tiers.row(int(slot)) is None:
                raise AssertionError(f"phase 12: cold slot {slot} did not page in")
        cut = (batch_ts[n_aged_b - 1] + batch_ts[n_aged_b]) / 2
        t = time.perf_counter()
        aged = store.age_rows(ttl_s=1000.0, now=cut + 1000.0)
        out["age_s"] = time.perf_counter() - t
        promoted = store._tiers.recently_promoted_slots()
        if (aged["tombstoned"] != n_aged or sorted(store._tombstoned) != list(range(n_aged))
                or aged["exempt"] != len(promoted) or len(promoted) < 16 or min(promoted) < TIER_WARM
                or not bool((store._types[:n_aged] == -1).all())
                or bool((store._types[n_aged:TIER_HOT] == -1).any())):
            raise AssertionError(f"phase 12: aging {aged}, {len(store._tombstoned)} tombstones")
        before = policy.warn_batch(reqs64)
        if ({r.tier for r in before} != {"tiered"}
                or any(store._slot_by_id[m.failure_id] < n_aged for r in before for m in r.references)):
            raise AssertionError("phase 12: a warn after aging returned an aged row")
        log(f"phase 12 aging: {aged['tombstoned']} rows (the first 1/8) tombstoned in {out['age_s']:.3f} s, "
            f"{aged['exempt']} cold rows in the promote-LRU exempt; 64 warns return no aged row [{card}]")

        # e. compaction (a snapshot with its tiers section, then the log
        # swap), then the restore through the Platform (the slice's entry)
        t = time.perf_counter()
        comp = store.compact()
        out["compact_s"] = time.perf_counter() - t
        out["compact"] = comp
        out["snapshot"] = store.lifecycle_info()["snapshot"]
        store.close()
        manifest = json.loads((data / "snapshot" / "manifest.json").read_text())
        if manifest.get("tiers", {}).get("n") != TIER_N or manifest["tiers"]["hot"] != TIER_HOT:
            raise AssertionError(f"phase 12 e: manifest {manifest.get('tiers')}")
        router_before = store._tiers.router.export_state()
        del store, policy
        gc.collect()
        torch.cuda.empty_cache()
        t = time.perf_counter()
        plat = Platform(data_dir=data, capacity=ROWS, dim=DIM)
        out["restore_open_s"] = time.perf_counter() - t
        restore = plat.gfkb.lifecycle_info()["restore"]
        out["restore"] = restore
        rc, ra = plat.gfkb._tiers.router.export_state()
        if not (restore and restore["rows"] == TIER_N and restore["hot"] == TIER_HOT and restore["router"] == "restored"
                and rc.tobytes() == router_before[0].tobytes() and ra.tobytes() == router_before[1].tobytes()
                and sorted(plat.gfkb._tombstoned) == list(range(n_aged))
                and int(plat.gfkb._valid.sum()) == TIER_HOT and bool((plat.gfkb._types[:n_aged] == -1).all())):
            raise AssertionError(f"phase 12 e: restore {restore}")
        after = plat.warn_batch(reqs64)
        if _answers(after) != _answers(before):
            raise AssertionError("phase 12 e: the restored store's warns differ from the compacted store's")
        sec = out["snapshot"]["seconds"]
        log(f"phase 12 e: compact {out['compact_s']:.3f} s (failures.jsonl {comp['bytes_before']} -> "
            f"{comp['bytes_after']} bytes, {comp['tombstone_lines']} tombstone lines), its snapshot "
            f"{sec['total']:.3f} s ({json.dumps({k: round(v, 3) for k, v in sec.items()})}, payload "
            f"{out['snapshot']['bytes']} bytes, tiers section n={TIER_N} hot={TIER_HOT}); restore open "
            f"{out['restore_open_s']:.3f} s ({json.dumps({k: round(v, 3) for k, v in restore['seconds'].items()})}): "
            f"{TIER_HOT} rows on the card, the {n_aged} aged ones zeroed and untyped, tombstones kept, router restored "
            f"bit-equal, not rebuilt; 64 warns equal before and after [{card}]")

        # No child process runs during the timed stages (b's p50s, c's
        # drill): the sticky-error child and the threads of ``beside`` (phase
        # 11's crash sweep) are joined here.
        t = time.perf_counter()
        for th in (child_runner, *beside):
            th.join()
        log(f"phase 12: waited {time.perf_counter() - t:.1f} s for {[th.name for th in (child_runner, *beside)]} "
            f"before the first timed stage [{card}]")

        # b. stage split and p50s through Platform.warn_batch
        check_healthy("phase 12's build, snapshot and restore")
        split = {}
        for b, reqs in ((1, reqs64[16:17]), (64, reqs64)):
            split[b] = tier_split(plat, reqs, fused_topk, calls=50)
            log(f"phase 12 b, B = {b}: " + json.dumps(split[b]) + f" [{card}]")
        out["split"] = split
        gfkb = plat.gfkb
        q_idx, q_val = gfkb.featurizer.encode_batch_sparse([r[5] or "x" for r in rows64])
        q = gfkb._knn.densify(to_device(q_idx, np.int32, gfkb.device), to_device(q_val, np.float32, gfkb.device))
        launches = fused_topk.launches
        v, i = fused_topk(gfkb._emb, gfkb._valid, q, gfkb.top_k)
        rv, ri = fused_topk_reference(gfkb._emb, gfkb._valid, q, gfkb.top_k)
        out["hot_max_abs_err"] = check_topk(v, i, rv, ri, "phase 12 b: the hot part vs fused_topk_reference")
        fused_topk.launches = launches  # a check launch is not the path's
        check_healthy("phase 12's healthy warns")

        # c. the injected drill
        rt = LlamaRuntime(cfg=LlamaConfig(d_model=256, n_heads=2, n_kv_heads=1, d_ff=512, max_seq_len=256),
                          device="cuda")
        healthy_gen = rt.generate_batch(["a healthy prompt"], max_tokens=4)
        drill_rows = [corpus[int(i)] for i in rng.choice(TIER_N, 1024 - 64, replace=False)] + rows64
        drill = _tier_requests(drill_rows)
        healthy = [r for lo in range(0, 1024, 64) for r in plat.warn_batch(drill[lo : lo + 64])]
        health = get_device_health()
        fb0 = fallback_total()
        faults.arm("device.unavailable:1:-1")
        t = time.perf_counter()
        degraded = [r for lo in range(0, 1024, 64) for r in plat.warn_batch(drill[lo : lo + 64])]
        drill_s = time.perf_counter() - t
        if not (all(r.degraded for r in degraded) and health.degraded
                and {r.tier for r in degraded} <= {"warm_routed", "warm"}):
            raise AssertionError("phase 12 c: a drill warn was not degraded")
        kinds = [_agreement(plat.gfkb, signature_text(q.prompt, q.tools, q.env), a, b, 1e-2)
                 for q, a, b in zip(drill, healthy, degraded)]
        agree = {k: kinds.count(k) for k in ("equal", "tie", "threshold", "routed miss", "differ")}
        if agree["differ"]:
            raise AssertionError(f"phase 12 c: degraded answers against the healthy ones: {agree}")

        async def http():
            client = TestClient(TestServer(make_app(plat)))
            await client.start_server()
            try:
                r = await client.post("/warn", json={"app_id": "app-h", "prompt": drill_rows[0][2],
                                                    "tools": list(drill_rows[0][3]),
                                                    "env": {k: "x" for k in drill_rows[0][4]}})
                body = (r.status, await r.json())
                ready = await (await client.get("/readyz")).json()
                return body, ready
            finally:
                await client.close()

        (status, body), ready = asyncio.run(http())
        if status != 200 or body["degraded"] is not True or ready["device"]["degraded"] is not True:
            raise AssertionError(f"phase 12 c: /warn {status} {body}, /readyz {ready['device']}")
        t = time.perf_counter()
        try:
            rt.generate_batch(["a prompt"], max_tokens=4)
            raise AssertionError("phase 12 c: generate_batch ran while degraded")
        except DeviceUnavailableError:
            gen_ms = (time.perf_counter() - t) * 1e3
        if gen_ms >= 1000.0:
            raise AssertionError(f"phase 12 c: generation took {gen_ms} ms to fail")
        n_degraded = fallback_total() - fb0
        if n_degraded != DRILL_WARNS or ready["tiers"]["fallback"] != DRILL_WARNS:
            raise AssertionError(f"phase 12 c: fallback count {n_degraded}, not {DRILL_WARNS}")
        faults.disarm()
        t = time.perf_counter()
        while health.degraded and time.perf_counter() - t < 5.0:
            time.sleep(0.01)
        unlatch_s = time.perf_counter() - t
        if health.degraded or unlatch_s > 2.0:
            raise AssertionError(f"phase 12 c: the probe took {unlatch_s} s to unlatch")
        DRILLS["latches"] += 1
        DRILLS["fallback"] += n_degraded
        post = plat.warn_batch(reqs64)
        if _answers(post) != _answers(before):
            raise AssertionError("phase 12 c: the warns after recovery differ from the healthy ones")
        rt.close()
        out["drill"] = dict(warns=1024, wall_s=drill_s, agreement=agree, http_status=status,
                            readyz_device=ready["device"], generate_fail_ms=gen_ms, unlatch_s=unlatch_s,
                            fallback=n_degraded, transitions=dict(health.transitions), probes=dict(health.probes),
                            healthy_generate=healthy_gen[0].meta.get("tokens_generated"))
        log(f"phase 12 c: device.unavailable armed: 1024 warns answered degraded from the warm tier in "
            f"{drill_s:.3f} s; against the healthy answers {agree} (tie: top-1 rows within 1e-2 in f32; "
            f"threshold: the action on the 0.8 edge; routed miss: the degraded path routes the hot rows too, "
            f"and its nprobe lists lacked the card's exact top-1); /warn 200 degraded, /readyz "
            f"degraded ({ready['device']['reason']}); generate_batch raised DeviceUnavailableError in "
            f"{gen_ms:.3f} ms; disarmed, the probe unlatched in {unlatch_s:.3f} s; fallback count {n_degraded} = "
            f"1024 + 1 /warn; transitions {health.transitions}; warns after recovery equal the healthy ones "
            f"[{card}]")
        plat.close()
        # make_app's routes stay reachable from aiohttp's method caches, and
        # through them this Platform: hand its 4.3 GB index back to the card
        # for the model phases.
        gfkb._emb = gfkb._valid = gfkb._types = None
        del plat, gfkb, q, v, i, rv, ri
        gc.collect()
        torch.cuda.empty_cache()
        # d. the sticky-error child, started beside this phase's build and
        # joined before b's timed stages.
        res = child.get("result")
        if child.get("error") or child.get("rc") != 0 or not res or not res["ok"]:
            raise AssertionError(f"phase 12 d: {child}")
        out["sticky"] = res
        log(f"phase 12 d child: {child['wall_s']:.1f} s as a process, of which set-up {res['set_up_s']:.1f} s and "
            f"the build {res['build_s']:.1f} s ({json.dumps(res['build'])}) [{card}]")
        log(f"phase 12 d (child on the card, {res['rows']} rows, hot cap {res['hot']}, mining on: "
            f"{res['mining']['tier_attaches']} overflow rows attached from the tiers): a device-side assert "
            f"poisoned the context; {res['queries']} warns then answered degraded ({res['reason']}) in "
            f"{res['degraded_warn_s'] * 1e3:.1f} ms, against the recorded answers {res['agreement']} (the 48 "
            f"stored signatures all equal; max |conf diff| {res['max_conf_diff']:.3g}), tiers "
            f"{res['before_tiers']} -> {res['after_tiers']}; probe "
            f"{res['probes']} after 2.5 s, still degraded; generate_batch -> {res['generate']} in "
            f"{res['generate_s'] * 1e3:.3f} ms [{card}]")
    finally:
        for k, v in env_before.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    log("phase 12: " + json.dumps({k: out[k] for k in out if k not in ("sticky",)}, default=str))
    return out


# ---------------------------------------------------------------------------
# phase 16: the model plane's last gaps on the card (f32 models, head_dims and
# dtypes no kernel body takes, full_mask, checkpoints with a tokenizer.json,
# the device profiler)
# ---------------------------------------------------------------------------

LAUNCH_COUNTERS = ("bf16", "int8", "f32", "grouped")


# ---------------------------------------------------------------------------
# phase 18: replication and the fleet plane on the card
# ---------------------------------------------------------------------------

# The fleet's knobs for phase 18 (each the reference's): quick probes and
# gossip, a breaker that opens on one failed event and half-opens after
# 1 s, the DLQ's auto-replay 1 s after a re-close, a short ladder dwell and
# occupancy hold so b's heal and d's decay fit the run.
FLEET_ENV = dict(
    KAKVEDA_FLEET_GOSSIP_S="0.5", KAKVEDA_ROUTER_PROBE_S="0.3", KAKVEDA_ROUTER_EJECT_FAILS="2",
    KAKVEDA_BUS_RETRIES="2", KAKVEDA_BUS_RETRY_BASE="0.05", KAKVEDA_BUS_BREAKER_THRESHOLD="1",
    KAKVEDA_BUS_BREAKER_COOLDOWN="1", KAKVEDA_DLQ_AUTO_S="1", KAKVEDA_BROWNOUT_DWELL="0.5",
    KAKVEDA_ADMIT_OCC_WINDOW_S="1", KAKVEDA_LOG_FORMAT="text",
)
INDEX_BYTES = ROWS * DIM * 2  # one replica's bf16 index, 4 GiB
FLEET_APPS = 64  # phase 18 c: one ingest batch of 48 traces per app, three in four failing
FLEET_FLOOD = 256  # phase 18 d: concurrent ingests at one replica, four times its ingest admission bound
FLEET_FLOOD_PROCS, FLEET_FLOOD_S = 2, 3.0  # its client processes, and how long they keep it up


def _fleet_metric(text: str, sample: str, labels: str = "") -> float:
    """The sum of one sample's values (those whose labels contain
    ``labels``) in a Prometheus exposition."""
    from kakveda_tpu_torch.core.metrics import parse_prometheus_text

    return sum(v for fam in parse_prometheus_text(text).values() for name, lab, v in fam["samples"]
               if name == sample and labels in lab)


def _card_free() -> int:
    return torch.cuda.mem_get_info(0)[0]


def _fleet_ports(n: int) -> int:
    """A base of ``n`` consecutive free ports outside the kernel's ephemeral
    range (below it, else above it). Under the floods the smoke, the
    router and the replicas hold hundreds of keep-alive connections, each
    on an ephemeral local port, so a replica port drawn from that range
    (as ``pick_port_base`` draws) can be taken before its replica binds
    it: the fifth replica's, or a restarted one's."""
    import random
    import socket

    lo, hi = map(int, Path("/proc/sys/net/ipv4/ip_local_port_range").read_text().split())
    spans = [(s, e) for s, e in ((10_000, lo - n), (hi + 1, 65_535 - n)) if e > s]
    rng = random.Random()
    for _ in range(256):
        if not spans:
            break
        base = rng.randrange(*rng.choice(spans))
        try:
            for port in range(base, base + n):
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
    raise AssertionError(f"no {n} consecutive free ports outside the ephemeral range {lo}-{hi}")


class _FleetProc:
    """``python3 -m kakveda_tpu_torch.cli up --replicas n`` on the card (the
    router on ``port``, replicas on ``base`` .. ``base + n - 1``), its output
    in ``root/fleet.out``; ``down`` stops it and sweeps its replicas. With
    ``detach`` the command is ``up -d`` (the router then runs in its own
    session, its output in ``root/server.log``); ``args`` are added to it
    (phase 19 c's ``--autoscale``)."""

    def __init__(self, root: Path, n: int, detach: bool = False, args=(), extra_ports: int = 1, **env):
        self.root, self.n = root, n
        self.repo = Path(__file__).resolve().parent
        # The router, n replicas and ``extra_ports`` more (phase 18 c's fifth, the
        # replicas phase 19 c's autoscaler spawns).
        self.port = _fleet_ports(n + 1 + extra_ports)
        self.base = self.port + 1
        self.env = {**os.environ, "PYTHONPATH": str(self.repo), "KAKVEDA_INDEX_CAPACITY": str(ROWS), **FLEET_ENV,
                    **env}
        self.out = root / "fleet.out"
        root.mkdir(parents=True, exist_ok=True)
        cmd = [sys.executable, "-m", "kakveda_tpu_torch.cli", "up", "--dir", str(root), "--port", str(self.port),
               "--port-base", str(self.base), "--replicas", str(n), *(["-d"] if detach else []), *args]
        with open(self.out, "wb") as f:
            self.proc = subprocess.Popen(cmd, cwd=self.repo, env=self.env, stdout=f, stderr=subprocess.STDOUT)
        if detach:
            # `up -d` returns once it has started the router in the background.
            if self.proc.wait(timeout=60) != 0:
                raise AssertionError(f"cli up -d: {self.proc.returncode}\n{self.tail()}")
            self.proc = None
        self.router = f"http://127.0.0.1:{self.port}"

    def url(self, i: int) -> str:
        return f"http://127.0.0.1:{self.base + i}"

    def pid(self, i: int) -> int:
        return int((self.root / f"replica-{i}.pid").read_text().strip())

    def router_pid(self) -> Optional[int]:
        try:
            return int((self.root / "server.pid").read_text().strip())
        except (OSError, ValueError):
            return None

    def tail(self) -> str:
        logs = [self.out, self.root / "server.log", *sorted(self.root.glob("replica-*.log"))]
        return "\n".join(f"--- {p.name}\n" + p.read_text(errors="replace")[-1500:] for p in logs if p.exists())

    async def wait_router(self, s, healthy: int, timeout: float = 180.0) -> float:
        import aiohttp

        t0 = time.perf_counter()
        while True:
            if self.proc is not None and self.proc.poll() is not None:
                raise AssertionError(f"the fleet exited early ({self.proc.returncode}):\n{self.tail()}")
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"the fleet's router did not report {healthy} healthy replicas:\n{self.tail()}")
            try:
                async with s.get(self.router + "/readyz") as r:
                    if r.status == 200 and (await r.json())["fleet"]["healthy"] == healthy:
                        return time.perf_counter() - t0
            except aiohttp.ClientError:
                pass
            await asyncio.sleep(0.25)

    def down(self) -> None:
        # This process reaps the router as it exits (else `down` would wait
        # on a zombie), while `down` stops it and sweeps the replicas.
        d = subprocess.Popen([sys.executable, "-m", "kakveda_tpu_torch.cli", "down", "--dir", str(self.root),
                              "--timeout", "60"], cwd=self.repo, env=self.env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True)
        try:
            if self.proc is not None:
                self.proc.wait(timeout=90)
            text, _ = d.communicate(timeout=90)
        finally:
            if d.poll() is None:
                d.kill()
                d.wait()
        rc = 0 if self.proc is None else self.proc.returncode
        if d.returncode != 0 or rc != 0:
            raise AssertionError(f"cli down: {d.returncode} (fleet {rc}) {text}\n{self.tail()}")

    def kill(self) -> None:
        """Last resort on a failed phase: SIGKILL the router and whatever
        replicas its pid files name."""
        import signal

        if self.proc is not None and self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        if self.proc is None and self.router_pid():
            with contextlib.suppress(OSError):
                os.kill(self.router_pid(), signal.SIGKILL)
        for p in self.root.glob("replica-*.pid"):
            with contextlib.suppress(OSError, ValueError):
                os.kill(int(p.read_text().strip()), signal.SIGKILL)


async def _jpost(s, url: str, body, ok=(200,)):
    async with s.post(url, json=body) as r:
        out = await r.json()
        if r.status not in ok:
            raise AssertionError(f"POST {url}: {r.status} {out}")
        return out


async def _jget(s, url: str):
    async with s.get(url) as r:
        if r.status != 200:
            raise AssertionError(f"GET {url}: {r.status}")
        return await r.json()


async def _tget(s, url: str) -> str:
    async with s.get(url) as r:
        if r.status != 200:
            raise AssertionError(f"GET {url}: {r.status}")
        return await r.text()


async def _counts(s, urls) -> list:
    return [(await _jget(s, u + "/readyz"))["gfkb_count"] for u in urls]


async def _converge(s, urls, want, timeout: float, what: str) -> list:
    """Poll the replicas' counts until ``want(counts)`` holds."""
    t0 = time.perf_counter()
    while True:
        counts = await _counts(s, urls)
        if want(counts):
            return counts
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{what}: counts {counts} after {timeout} s")
        await asyncio.sleep(0.2)


async def _launches(s, urls) -> list:
    """Each replica's own ``fused_topk.launches`` (its ``/readyz``
    ``device.launches``), raised where the kernel launches and nowhere
    else; a section's launches are the difference across it."""
    return [(await _jget(s, u + "/readyz"))["device"]["launches"]["fused_topk"] for u in urls]


async def _warn_batches(s, urls) -> list:
    """Each replica's warn batches (``kakveda_warn_batch_seconds``' count),
    counted after whichever path served the batch."""
    return [int(_fleet_metric(await _tget(s, u + "/metrics"), "kakveda_warn_batch_seconds_count")) for u in urls]


def _minus(after: list, before: list) -> list:
    return [a - b for a, b in zip(after, before)]


async def _card_healthy(s, urls, what: str) -> None:
    """Fail when a replica's card is latched degraded (its warns then come
    from the host tiers, not the kernel)."""
    for u in urls:
        dev = (await _jget(s, u + "/readyz"))["device"]
        if dev["degraded"] is not False:
            raise AssertionError(f"{what}: {u} is latched degraded: {dev}")


def _from_the_card(answers, what: str) -> None:
    """Every answer came from the replicas' hot index on the card: none
    degraded, every tier ``hot``."""
    bad = [a for a in answers if a.get("degraded") is not False or a.get("tier") != "hot"]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} of {len(answers)} answers not from the card's index, e.g. "
                             f"degraded {bad[0].get('degraded')} tier {bad[0].get('tier')}")


def _hold_to_oracle(answers, reqs, oracle, what: str) -> int:
    """Every answer against the oracle Platform's ``warn_batch`` of the same
    requests: the action, the top-1 confidence within 1e-4, and the scores
    rank by rank within ATOL (ids are each replica's own)."""
    direct = []
    for lo in range(0, len(reqs), 64):
        direct += oracle.warn_batch(reqs[lo : lo + 64])
    for j, (a, d) in enumerate(zip(answers, direct)):
        got, want = [x["score"] for x in a["references"]], [x.score for x in d.references]
        if a["action"] != d.action or abs(a["confidence"] - d.confidence) > 1e-4 or len(got) != len(want) \
                or any(abs(x - y) > ATOL for x, y in zip(got, want)):
            raise AssertionError(f"{what} answer {j}: {a['action']} {a['confidence']} {got} vs oracle "
                                 f"{d.action} {d.confidence} {want}")
    return len(direct)


def _oracle(base: Path, name: str, batches, TracePayload):
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=base / name, capacity=ROWS, dim=DIM)
    for b in batches:
        asyncio.run(plat.ingest_batch([TracePayload.model_validate(t) for t in b]))
    return plat


def _drop(plat) -> None:
    plat.close()
    del plat
    gc.collect()
    torch.cuda.empty_cache()


async def _legacy_fleet(s, fl: _FleetProc, oracle, batches, reqs_b, bodies_c, card: str) -> dict:
    """Phase 18 a, b, d, e on a two-replica fleet with legacy replication."""
    from kakveda_tpu_torch.core.schemas import WarningRequest
    from kakveda_tpu_torch.fleet.hashring import HashRing

    out = {}
    urls = [fl.url(i) for i in range(2)]
    name = torch.cuda.get_device_name(0)
    for u in urls:
        dev = (await _jget(s, u + "/readyz"))["device"]
        if dev.get("name") != name:
            raise AssertionError(f"{u}/readyz names {dev}, not the card")

    # a. Ingest through the router: the owner accepts, its bus replicates.
    t0 = time.perf_counter()
    failures = 0
    for b in batches:
        failures += (await _jpost(s, fl.router + "/ingest/batch", {"traces": b}))["failures"]
    counts = await _converge(s, urls, lambda c: c == [failures] * 2, 30.0, "phase 18 a replication")
    out["ingest_s"] = time.perf_counter() - t0
    out["write_amplification"] = sum(counts) / failures
    if failures != 3072 or out["write_amplification"] != 2.0:
        raise AssertionError(f"phase 18 a: {failures} failures, counts {counts}")
    l0, b0 = await _launches(s, urls), await _warn_batches(s, urls)
    lat, answers = [], []
    for body in reqs_b:
        t = time.perf_counter()
        answers.append(await _jpost(s, fl.router + "/warn", body))
        lat.append((time.perf_counter() - t) * 1e3)
    out.update(c1_p50_ms=_pct(lat, 0.5), c1_p99_ms=_pct(lat, 0.99), c1_per_s=len(lat) / (sum(lat) / 1e3))
    l1 = await _launches(s, urls)
    res_c = [[None] * 16 for _ in range(64)]
    lat_c = []

    async def client(c):
        for j, body in enumerate(bodies_c[c]):
            t = time.perf_counter()
            res_c[c][j] = await _jpost(s, fl.router + "/warn", body)
            lat_c.append((time.perf_counter() - t) * 1e3)

    t0 = time.perf_counter()
    await asyncio.gather(*[client(c) for c in range(64)])
    wall = time.perf_counter() - t0
    out.update(c64_p50_ms=_pct(lat_c, 0.5), c64_p99_ms=_pct(lat_c, 0.99), c64_per_s=1024 / wall)
    l2, b2 = await _launches(s, urls), await _warn_batches(s, urls)
    flat_c = [b for bs in bodies_c for b in bs]
    fleet_answers = answers + [r for rs in res_c for r in rs]
    _from_the_card(fleet_answers, "phase 18 a")
    await _card_healthy(s, urls, "phase 18 a")
    n = _hold_to_oracle(fleet_answers, [WarningRequest.model_validate(b) for b in reqs_b + flat_c], oracle,
                        "phase 18 a")
    out.update(launches_c1=_minus(l1, l0), launches_c64=_minus(l2, l1), launches_a=_minus(l2, l0),
               warn_batches_a=_minus(b2, b0))
    if min(out["launches_a"]) <= 0:
        raise AssertionError(f"phase 18 a: a replica launched no fused_topk: {out['launches_a']}")
    log(f"phase 18 a: 2 replicas x 2^20 x 2048 bf16 on the card; 4096 traces through the router, "
        f"{failures} failures on each replica (write amplification {out['write_amplification']}) in "
        f"{out['ingest_s']:.3f} s; /warn at concurrency 1 (256): p50 {out['c1_p50_ms']:.3f} ms, p99 "
        f"{out['c1_p99_ms']:.3f} ms, {out['c1_per_s']:.1f} warns/s; 64 x 16 at concurrency 64: p50 "
        f"{out['c64_p50_ms']:.3f} ms, p99 {out['c64_p99_ms']:.3f} ms, {out['c64_per_s']:.1f} warns/s; {n} answers "
        f"== an oracle Platform's (scores rank by rank within {ATOL}, top-1 confidence within 1e-4), none degraded, "
        f"every tier hot; fused_topk launches per replica (each replica's own count across the arms) "
        f"{out['launches_c1']} at concurrency 1 + {out['launches_c64']} at 64, warn batches {out['warn_batches_a']} "
        f"[{card}]")

    # b. SIGKILL replica 1 under a concurrency-64 flood; its index comes back
    # to the card, a gap ingest dead-letters, the supervisor restarts it and
    # the DLQ's auto-replay heals the gap once a breaker to it re-closes
    # (the gossip's, or the replication's, whichever delivers first).
    import signal

    ring = HashRing(["r0", "r1"])
    survivor_app = next(f"app-{c}" for c in "ABCDEFGH" if ring.assign(f"app-{c}") == "r0")
    statuses, stop = [], asyncio.Event()

    async def flood(c):
        j = 0
        while not stop.is_set():
            async with s.post(fl.router + "/warn", json=bodies_c[c][j % 16]) as r:
                await r.read()
                statuses.append(r.status)
            j += 1

    free0 = _card_free()
    tasks = [asyncio.create_task(flood(c)) for c in range(64)]
    await asyncio.sleep(1.0)
    victim = fl.pid(1)
    os.kill(victim, signal.SIGKILL)
    t_kill = time.perf_counter()
    peak = free0
    while time.perf_counter() - t_kill < 10.0:
        peak = max(peak, _card_free())
        if peak - free0 >= INDEX_BYTES:
            break
        await asyncio.sleep(0.05)
    out["freed_bytes"], out["freed_s"] = peak - free0, time.perf_counter() - t_kill
    if out["freed_bytes"] < INDEX_BYTES:
        raise AssertionError(f"phase 18 b: the card regained {out['freed_bytes']} bytes within 10 s of the SIGKILL")
    gap = _service_batches(lo=8192, n=64, app=survivor_app)[0]
    gap_fail = (await _jpost(s, fl.router + "/ingest/batch", {"traces": gap}))["failures"]
    await asyncio.sleep(1.0)
    stop.set()
    await asyncio.gather(*tasks)
    dlq = fl.root / "data" / "replica-0" / "dlq.jsonl"
    if not (dlq.exists() and dlq.read_text().strip()):
        raise AssertionError("phase 18 b: the gap ingest left no DLQ record")
    lost = [x for x in statuses if x != 200]
    if lost:
        raise AssertionError(f"phase 18 b: {len(lost)} of {len(statuses)} warns lost under the kill: {lost[:5]}")
    t0 = time.perf_counter()
    while True:  # the router's supervise loop restarts it (KAKVEDA_FLEET_RESTARTS=1)
        with contextlib.suppress(OSError, ValueError, AssertionError):
            if fl.pid(1) != victim:
                await _jget(s, fl.url(1) + "/readyz")
                break
        if time.perf_counter() - t0 > 120:
            raise AssertionError(f"phase 18 b: replica 1 was not restarted:\n{fl.tail()}")
        await asyncio.sleep(0.25)
    out["restart_s"] = time.perf_counter() - t_kill
    before = await _counts(s, urls)
    want = 3072 + gap_fail
    t0 = time.perf_counter()
    healed = await _converge(s, urls, lambda c: c == [want] * 2, 30.0, "phase 18 b heal")
    out["heal_s"] = time.perf_counter() - t0
    while True:  # the replay thread rewrites the DLQ, then counts, after its last POST
        auto = _fleet_metric(await _tget(s, urls[0] + "/metrics"), "kakveda_bus_dlq_auto_total", 'result="replayed"')
        if auto >= 1 and not dlq.read_text().strip():
            break
        if time.perf_counter() - t0 > 40.0:
            raise AssertionError(f"phase 18 b: the gap healed with {auto} DLQ auto-replays and {dlq.read_text()!r} left")
        await asyncio.sleep(0.1)
    await _card_healthy(s, urls, "phase 18 b")
    log(f"phase 18 b: SIGKILL of replica 1 under 64 concurrent clients: {len(statuses)} warns, none lost; the card "
        f"regained {out['freed_bytes']} bytes (>= one 2^20 x 2048 index) {out['freed_s']:.2f} s after the kill, so a "
        f"killed replica holds no device lease; the gap ({gap_fail} rows) dead-lettered, the supervisor restarted "
        f"the replica ({out['restart_s']:.1f} s after the kill, counts {before} at its first /readyz), and the DLQ's "
        f"auto-replay after a breaker re-closed left {healed} {out['heal_s']:.2f} s later [{card}]")

    # d. Gossip: flood replica 0 past its ingest admission bound with
    # batches that classify clean (so nothing replicates and the peer's own
    # load stays nil); the peer's folded pressure and ladder step rise,
    # then fall within the TTL. (/warn takes no admission slot: its bound
    # is the micro-batcher's queue, which occupancy does not count.)
    async def peer_state():
        # Both reads at once: the folded pressure holds for one gossip tick
        # (KAKVEDA_FLEET_GOSSIP_S), which serial reads on a slow host can miss.
        text, ready = await asyncio.gather(_tget(s, urls[1] + "/metrics"), _jget(s, urls[1] + "/readyz"))
        return _fleet_metric(text, "kakveda_fleet_pressure"), ready["admission"]["brownout_step"]

    # The flood comes from client processes of their own (this loop only
    # reads the peer), so a slow host's loop does not thin it.
    clean = [t for t in _service_batches(lo=9000, n=512)[0] if t["response"] != STUB_RESPONSE][:8]
    body_path = fl.root / "flood.json"
    body_path.write_text(json.dumps({"traces": clean}))
    procs = spawn_tenant_clients([(f"flood-{i}", FLEET_FLOOD // FLEET_FLOOD_PROCS, FLEET_FLOOD_S, body_path)
                                  for i in range(FLEET_FLOOD_PROCS)], fn=ingest_flood_clients)
    flood = asyncio.create_task(run_tenant_clients(procs, urls[0], "phase 18 d"))
    peak_p, peak_step = 0.0, 0
    while not flood.done():
        p, step = await peer_state()
        peak_p, peak_step = max(peak_p, p), max(peak_step, step)
        await asyncio.sleep(0.02)
    rec, _ = await flood
    t_end = time.perf_counter()
    bad = [n for r in rec.values() for st, n in r if st == 200 and n]
    if bad:
        raise AssertionError(f"phase 18 d: {len(bad)} flood batches classified failures ({bad[:4]})")
    shed = [st == 429 for r in rec.values() for st, _ in r]
    ttl = float(fl.env.get("KAKVEDA_FLEET_GOSSIP_TTL_S", "5"))
    while True:
        p, step = await peer_state()
        if p < 0.5 and step == 0:
            break
        if time.perf_counter() - t_end > ttl:
            raise AssertionError(f"phase 18 d: the peer's pressure {p} and step {step} after the TTL")
        await asyncio.sleep(0.1)
    out["gossip"] = dict(peak_pressure=peak_p, peak_step=peak_step, decay_s=time.perf_counter() - t_end,
                         flood_warns=len(shed), flood_shed=sum(shed))
    if peak_p < 0.85 or peak_step < 1:
        raise AssertionError(f"phase 18 d: the peer's pressure peaked at {peak_p}, its step at {peak_step}")
    log(f"phase 18 d: {FLEET_FLOOD} concurrent ingests at replica 0 ({len(shed)} sent, {sum(shed)} shed 429): its "
        f"peer's kakveda_fleet_pressure peaked at {peak_p} and its ladder at step {peak_step}; both back (< 0.5, "
        f"step 0) {out['gossip']['decay_s']:.2f} s after the flood, within the {ttl} s gossip TTL [{card}]")

    # e. The operator's view through the router.
    fed = await _tget(s, fl.router + "/metrics/fleet")
    for fam in ("kakveda_warn_batch_seconds", "kakveda_gfkb_replicate_apply_total", "kakveda_bus_dlq_total",
                "kakveda_fleet_forwards_total", "kakveda_fleet_gossip_total"):
        if f"# TYPE {fam} " not in fed:
            raise AssertionError(f"/metrics/fleet lacks {fam}")
    for rid in ("r0", "r1", "__router__"):
        if f'replica="{rid}"' not in fed:
            raise AssertionError(f"/metrics/fleet has no gauge of {rid}")
    batches = await _warn_batches(s, urls)
    if _fleet_metric(fed, "kakveda_warn_batch_seconds_count") != sum(batches):
        raise AssertionError("/metrics/fleet's warn batches are not the replicas' sum")
    tid = os.urandom(16).hex()
    async with s.post(fl.router + "/warn", json=reqs_b[0], headers={"traceparent": f"00-{tid}-{os.urandom(8).hex()}-01"}) as r:
        await r.read()
    tr = await _jget(s, fl.router + f"/trace/{tid}")
    names = {x["name"] for x in tr["spans"]}
    if not {"router.request", "router.forward", "service.request", "gfkb.warn"} <= names or not tr["tree"]:
        raise AssertionError(f"/trace/{tid} through the router: {sorted(names)} {tr['sources']}")
    log(f"phase 18 e: /metrics/fleet holds both replicas' families and the router's ({len(fed.splitlines())} lines; "
        f"warn batches summed {int(sum(batches))}); /trace/{{id}} through the router assembles {sorted(names)} "
        f"from {tr['sources']}")
    return out


def _service_batches(lo: int = 0, n: int = 4096, app: Optional[str] = None) -> list:
    """Phase 8's traces (three in four failing) as JSON in batches of 512,
    all under ``app`` when given."""
    from kakveda_tpu_torch.core.schemas import TracePayload

    traces = [t.model_dump(mode="json") for t in _service_traces(TracePayload, lo, n)]
    if app:
        for t in traces:
            t["app_id"] = app
    return [traces[i : i + 512] for i in range(0, n, 512)]


async def _sharded_fleet(s, fl: _FleetProc, oracle, batches, card: str) -> dict:
    """Phase 18 c on four replicas with sharded ownership (R = 2)."""
    from kakveda_tpu_torch.fleet.ownership import OwnershipView
    from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor

    out = {}
    urls = [fl.url(i) for i in range(4)]
    unique = 0
    for b in batches:
        unique += (await _jpost(s, fl.router + "/ingest/batch", {"traces": b}))["failures"]
    counts = await _converge(s, urls, lambda c: sum(c) == 2 * unique, 30.0, "phase 18 c replication")
    out.update(unique=unique, counts=counts, max_share=max(counts) / unique, write_amplification=sum(counts) / unique)
    if out["max_share"] > 0.6 or out["write_amplification"] > 2.3:
        raise AssertionError(f"phase 18 c residency: {out}")
    bodies = [_warn_body(f"app-{a:02d}", b[1]["prompt"]) for a, b in enumerate(batches)]
    l0 = await _launches(s, urls)
    got = [await _jpost(s, fl.router + "/warn", body) for body in bodies]
    out["launches_scatter"] = _minus(await _launches(s, urls), l0)
    _from_the_card(got, "phase 18 c")
    from kakveda_tpu_torch.core.schemas import WarningRequest

    direct = oracle.warn_batch([WarningRequest.model_validate(b) for b in bodies])
    for a, (g, d) in enumerate(zip(got, direct)):
        if g["partial"] or abs(g["confidence"] - d.confidence) > 1e-4:
            raise AssertionError(f"phase 18 c app-{a:02d}: partial {g['partial']} {g['confidence']} vs {d.confidence}")
    if min(out["launches_scatter"]) <= 0:
        raise AssertionError(f"phase 18 c: a replica launched no fused_topk: {out['launches_scatter']}")
    log(f"phase 18 c: 4 replicas, R = 2, {FLEET_APPS} apps: {unique} rows, resident {counts} (largest "
        f"{out['max_share']:.3f} of the corpus, write amplification {out['write_amplification']}); {len(got)} "
        f"scatter-gather /warn, partial false, none degraded, every tier hot, top-1 confidence == an oracle "
        f"Platform's within 1e-4; fused_topk launches per replica (each replica's own count across them) "
        f"{out['launches_scatter']} [{card}]")

    # A fifth replica, then the range migration under a warn flood.
    sup = FleetSupervisor(fl.root, port_base=fl.base, replicas=4,
                          env={k: fl.env[k] for k in fl.env if k.startswith("KAKVEDA_")})
    statuses, stop = [], asyncio.Event()

    async def flood(c):
        j = 0
        while not stop.is_set():
            async with s.post(fl.router + "/warn", json=bodies[(c * 7 + j) % len(bodies)]) as r:
                body = await r.json()
                statuses.append((r.status, bool(body.get("partial")), body.get("degraded", True)))
            j += 1

    try:
        idx = sup.add_replica()
        t0 = time.perf_counter()
        await asyncio.get_running_loop().run_in_executor(None, lambda: sup.wait_ready(180.0, only=[idx]))
        out["spawn_s"] = time.perf_counter() - t0
        epoch0 = (await _jget(s, fl.router + "/readyz"))["ownership"]["epoch"]
        all5 = urls + [sup.url(idx)]
        l0 = await _launches(s, all5)
        tasks = [asyncio.create_task(flood(c)) for c in range(16)]
        t0 = time.perf_counter()
        reb = await _jpost(s, fl.router + "/fleet/rebalance", {"add": {"id": sup.replica_id(idx), "url": sup.url(idx)}})
        out["rebalance_s"] = time.perf_counter() - t0
        await asyncio.sleep(0.5)
        stop.set()
        await asyncio.gather(*tasks)
        out["launches_rebalance"] = _minus(await _launches(s, all5), l0)
        epoch1 = (await _jget(s, fl.router + "/readyz"))["ownership"]["epoch"]
        r4 = (await _jget(s, sup.url(idx) + "/readyz"))
        bad = [x for x in statuses if x != (200, False, False)]
        if epoch1 != epoch0 + 1 or reb["rows_moved"] <= 0 or bad or r4["gfkb_count"] <= 0 \
                or r4["ownership"]["rows"]["foreign"]:
            raise AssertionError(f"phase 18 c rebalance: epoch {epoch0} -> {epoch1}, {reb}, {len(bad)} bad warns "
                                 f"{bad[:3]}, the new replica {r4['gfkb_count']} rows {r4['ownership']['rows']}")
        out["rebalance"] = dict(epoch=[epoch0, epoch1], rows_moved=reb["rows_moved"], warns=len(statuses),
                                wall_s=reb["wall_s"])
        log(f"phase 18 c: a 5th replica up in {out['spawn_s']:.1f} s; POST /fleet/rebalance moved {reb['rows_moved']} "
            f"rows in {reb['batches']} batches ({reb['wall_s']} s), epoch {epoch0} -> {epoch1}; {len(statuses)} warns "
            f"during it, none lost, partial or degraded, fused_topk launches per replica {out['launches_rebalance']}; "
            f"the newcomer holds {r4['gfkb_count']} rows, none foreign [{card}]")

        # SIGTERM an owner under the flood: no hole, no lost warn.
        import signal

        statuses.clear()
        stop = asyncio.Event()
        tasks = [asyncio.create_task(flood(c)) for c in range(16)]
        await asyncio.sleep(0.5)
        os.kill(fl.pid(0), signal.SIGTERM)
        t0 = time.perf_counter()
        while True:
            rep = await _jget(s, fl.router + "/readyz")
            if rep["replicas"]["r0"]["ejected"] and rep["ownership"]["epoch"] > epoch1:
                break
            if time.perf_counter() - t0 > 15:
                raise AssertionError(f"phase 18 c: r0 not ejected and promoted: {rep}")
            await asyncio.sleep(0.2)
        await asyncio.sleep(1.0)
        stop.set()
        await asyncio.gather(*tasks)
        rep = await _jget(s, fl.router + "/readyz")
        bad = [x for x in statuses if x != (200, False, False)]
        if rep["ownership"]["coverage_holes"] or bad:
            raise AssertionError(f"phase 18 c after the SIGTERM: holes {rep['ownership']['coverage_holes']}, "
                                 f"{len(bad)} bad warns {bad[:3]}")
        live = [fl.url(i) for i in (1, 2, 3)] + [sup.url(idx)]
        epochs = [(await _jget(s, u + "/fleet/ownership"))["epoch"] for u in live]
        if min(epochs) != rep["ownership"]["epoch"]:
            raise AssertionError(f"phase 18 c: survivors at epochs {epochs}, the router at {rep['ownership']['epoch']}")
        out["kill"] = dict(warns=len(statuses), epoch=rep["ownership"]["epoch"], survivor_epochs=epochs)
        log(f"phase 18 c: SIGTERM of owner r0 under 16 clients: ejected and promoted to epoch "
            f"{rep['ownership']['epoch']} (every survivor acknowledged it), coverage holes 0, {len(statuses)} "
            f"warns none lost, partial or degraded [{card}]")

        # A stale-epoch replication event for a range r1 does not hold.
        view = OwnershipView.from_dict(await _jget(s, fl.url(1) + "/fleet/ownership"))
        foreign = next(f"app-{a:02d}" for a in range(FLEET_APPS) if "r1" not in view.holders(f"app-{a:02d}"))
        row = {"failure_type": "TIMEOUT", "signature_text": "stale epoch row", "app_id": foreign,
               "impact_severity": "medium"}
        m0 = _fleet_metric(await _tget(s, fl.url(1) + "/metrics"), "kakveda_fleet_fenced_rows_total")
        fenced = await _jpost(s, fl.url(1) + "/replicate", {"id": "stale-smoke", "epoch": 1, "rows": [row]})
        m1 = _fleet_metric(await _tget(s, fl.url(1) + "/metrics"), "kakveda_fleet_fenced_rows_total")
        if fenced.get("reason") != "stale_epoch" or m1 != m0 + 1:
            raise AssertionError(f"phase 18 c fence: {fenced}, fenced rows {m0} -> {m1}")
        await _card_healthy(s, live, "phase 18 c")
        log(f"phase 18 c: a stale-epoch /replicate answered {fenced} and kakveda_fleet_fenced_rows_total rose "
            f"{m0} -> {m1}; no live replica latched degraded [{card}]")
    finally:
        sup.stop_all()
    return out


def phase_fleet(base: Path, card: str) -> dict:
    """Phase 18: replication and the fleet plane at full width on the card."""
    import aiohttp

    from kakveda_tpu_torch.core.schemas import TracePayload

    t_phase = time.perf_counter()
    out = {}
    batches_a = _service_batches()
    reqs_b = ([_warn_body(f"app-{'ABCDEFGH'[j % 8]}", f"Summarize report {i} and include citations")
               for j, i in enumerate([i for i in range(4096) if i % 4][:128])]
              + [_warn_body(f"app-{'ABCDEFGH'[j % 8]}", f"Translate poem {j} into French verse") for j in range(128)])
    bodies_c = [[_warn_body(f"app-{'ABCDEFGH'[c % 8]}",
                            f"Summarize report {(c * 16 + j) * 3 + 1} and include citations" if j % 2 == 0
                            else f"Client {c} asks {j} about a new topic") for j in range(16)] for c in range(64)]
    if torch.cuda.memory_allocated() >= INDEX_BYTES:
        raise AssertionError(f"phase 18: this process still holds {torch.cuda.memory_allocated()} bytes on the card")
    free0, mine0 = _card_free(), torch.cuda.memory_reserved()
    fl = _FleetProc(base / "fleet-a", 2, KAKVEDA_FLEET_RESTARTS="1")
    oracle = None
    try:
        oracle = _oracle(base, "oracle-a", batches_a, TracePayload)  # while the replicas start

        async def go_a():
            async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=1024),
                                             timeout=aiohttp.ClientTimeout(total=60)) as s:
                ready_s = await fl.wait_router(s, 2)
                # The card's used memory, less what this process's allocator
                # took for the oracle: the replicas' share.
                grown = free0 - _card_free() - (torch.cuda.memory_reserved() - mine0)
                if grown < 2 * INDEX_BYTES:
                    raise AssertionError(f"phase 18 a: the card's used memory grew {grown} bytes for 2 replicas")
                out["replica_bytes"] = grown
                log(f"phase 18 a: `cli up --replicas 2` ready {ready_s:.1f} s after the oracle's ingest; the card's "
                    f"used memory grew {grown} bytes for the two replicas (>= 2 x {INDEX_BYTES})")
                return await _legacy_fleet(s, fl, oracle, batches_a, reqs_b, bodies_c, card)

        out["legacy"] = asyncio.run(go_a())
        fl.down()
    except BaseException:
        fl.kill()
        raise
    finally:
        if oracle is not None:
            _drop(oracle)
    oracle = None
    batches_c = [b[0][:48] for b in (_service_batches(lo=20_000 + 48 * a, n=48, app=f"app-{a:02d}")
                                    for a in range(FLEET_APPS))]
    fl = _FleetProc(base / "fleet-c", 4, KAKVEDA_FLEET_OWNERSHIP="1", KAKVEDA_FLEET_REPLICATION="2")
    try:
        oracle = _oracle(base, "oracle-c", batches_c, TracePayload)

        async def go_c():
            async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=256),
                                             timeout=aiohttp.ClientTimeout(total=60)) as s:
                await fl.wait_router(s, 4)
                return await _sharded_fleet(s, fl, oracle, batches_c, card)

        out["sharded"] = asyncio.run(go_c())
        fl.down()
    except BaseException:
        fl.kill()
        raise
    finally:
        if oracle is not None:
            _drop(oracle)
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 18: {out['wall_s']:.1f} s; " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 19: the elastic fleet and the traffic harness on the card
# ---------------------------------------------------------------------------

# Phase 19 a: the storm drill at tests/test_traffic.py's storm smoke numbers.
STORM = dict(seed=5, duration_s=8.0, speed=1.5, timeout_s=15.0, gossip_ttl_s=3.0)
STORM_UNLATCH_S = 2.5  # the probe (KAKVEDA_DEGRADED_PROBE=1) un-latches within this of the disarm
STORM_IN_FLIGHT_S = 0.25  # a warn answered this soon after the arm may have been dispatched before it
# Phase 19 b: the requests captured, then replayed.
REPLAY_WARNS, REPLAY_INGESTS = 256, 8
# Phase 19 c: tests/test_autoscaler.py's flash crowd (its scenario numbers)
# under bench.py _bench_elastic's replica env and drill knobs.
ELASTIC_SCENARIO = dict(seed=11, baseline_s=4.0, surge_s=18.0, decay_s=12.0, warn_rps=4.0, surge_x=3.0, bg_rps=12.0,
                        apps=8, crash_replica=1, gossip_ttl_s=3.0, max_scale_flaps=1)
ELASTIC_ENV = dict(
    KAKVEDA_FLEET_OWNERSHIP="1", KAKVEDA_FLEET_REPLICATION="2", KAKVEDA_ADMIT_BACKGROUND="1",
    KAKVEDA_ADMIT_WARN="64", KAKVEDA_DLQ_AUTO_S="2", KAKVEDA_SCALE_UP_OCC="0.6", KAKVEDA_SCALE_DOWN_OCC="0.2",
    KAKVEDA_SCALE_DWELL_S="2", KAKVEDA_SCALE_COOLDOWN_S="5", KAKVEDA_SCALE_REPLACE_S="3",
    KAKVEDA_SCALE_REPLACE_BACKOFF_S="3", KAKVEDA_SCALE_TICK_S="0.5",
)
ELASTIC_PER_APP = 48  # rows per app of the seed corpus, as phase 18 c
ELASTIC_MAX_PARTIAL = 0.1  # the reference's max_partial_rate (rebalance_storm's SLO)
ELASTIC_CONVERGE_S = 40.0  # after the replay: the replacement's heal and the drain back to 2
PHASE19_WALL_S = 100.0  # the phase's own limit; each wait inside it is bounded by what is left
# The scale-up's range migration against the SIGKILL at surge end (ROADMAP
# Queue 3): the JAX package on the CPU, its replicas started late enough to
# be ready as late as a card replica on a slow host, fails the same way
# (``python tests/torch_elastic_witness.py jax 9``; its reading, quoted).
ELASTIC_JAX_WITNESS = ("the JAX package on the CPU, its newcomer ready 14.41 s after its spawn: scale_up:error "
                       "'MigrationError: rebalance 1->2 failed (pre-flip)', no scale-up, 235 of 235 warns ok")
# Device-loss drills so far (phase 19 a's storm, phase 12 c's): latches and
# the warns they served from the host; check_healthy holds the process to it.
DRILLS = {"latches": 0, "fallback": 0}


class _Deadline:
    def __init__(self, seconds: float, what: str):
        self.end, self.what = time.perf_counter() + seconds, what

    def left(self, cap: float) -> float:
        left = self.end - time.perf_counter()
        if left <= 0:
            raise AssertionError(f"{self.what}: past its wall limit")
        return min(cap, left)


def phase_storm(base: Path, fused_topk, card: str) -> dict:
    """Phase 19 a: ``cli traffic storm``'s drill in process (``run_storm``:
    its admission limits and brownout settings) on a Platform on the card,
    seeded with phase 8's 4,096 traces through ``/ingest/batch``. Every SLO
    gate of the scenario raises; warns answered inside the device-loss
    window come degraded from the host, every other warn from the card's
    hot index, with ``fused_topk`` launched; the latch is released after,
    and the drill is counted in ``DRILLS``."""
    from kakveda_tpu_torch.cli.main import run_storm
    from kakveda_tpu_torch.core.admission import get_device_health
    from kakveda_tpu_torch.index.gfkb import fallback_total

    answers = []
    health = get_device_health()
    tr0, fb0, l0 = dict(health.transitions), fallback_total(), fused_topk.launches
    t = time.perf_counter()
    sc, res, rep = run_storm(**STORM, device="cuda", capacity=ROWS, dim=DIM, data_dir=base / "storm",
                             seed_batches=_service_batches(),
                             on_response=lambda path, st, body, at: answers.append((at, st, body))
                             if path == "/warn" else None)
    wall = time.perf_counter() - t
    launches = fused_topk.launches - l0
    _forget_apps()
    speed = STORM["speed"]
    arm = min(c["t"] for c in sc.chaos if c["action"] == "faults" and c["spec"]) / speed
    disarm = max(c["t"] for c in sc.chaos if c["action"] == "faults" and not c["spec"]) / speed
    ok = [(at, b) for at, st, b in answers if st == 200]
    degraded = [at for at, b in ok if b.get("degraded")]
    hot = [(at, b.get("tier")) for at, b in ok if not b.get("degraded")]
    late_deg = [round(at, 3) for at in degraded if not arm - 0.05 <= at <= disarm + STORM_UNLATCH_S]
    bad_hot = [(round(at, 3), tier) for at, tier in hot if tier != "hot" or arm + STORM_IN_FLIGHT_S <= at <= disarm]
    n_fb = fallback_total() - fb0
    tr = {k: health.transitions[k] - tr0.get(k, 0) for k in health.transitions}
    out = dict(wall_s=wall, launches=launches, warns=len(answers), degraded=len(degraded), hot=len(hot),
               fallback=n_fb, transitions=tr, window_s=[arm, disarm], slo=rep.to_dict(), replay=res.to_dict(),
               warn_p95_ms={ph: round(_pct(res.latencies_ms("warn", ph), 0.95), 3)
                            for ph in ("baseline", "storm", "recovery") if res.latencies_ms("warn", ph)})
    log(f"phase 19 a: storm (seed {STORM['seed']}, {STORM['duration_s']} s at speed {speed}) on a "
        f"{ROWS} x {DIM} Platform seeded with 4096 traces: {len(answers)} warns, {res.class_counts()}; "
        f"device-loss window {arm:.3f}-{disarm:.3f} s: {len(degraded)} warns answered degraded from the host, "
        f"{len(hot)} from the card's hot index; fused_topk launches {launches}; fallback warns {n_fb}; latch "
        f"{tr}; warn p95 by phase {out['warn_p95_ms']} ms; ladder back in {res.ladder_recovery_s} s; "
        f"{rep.summary()}; {wall:.1f} s [{card}]")
    if not rep.ok:
        raise AssertionError(f"phase 19 a: {rep.summary()}")
    if not degraded or not hot or late_deg or bad_hot:
        raise AssertionError(f"phase 19 a: degraded answers outside the window {late_deg[:5]}, answers not from "
                             f"the card's hot index {bad_hot[:5]} ({len(degraded)} degraded, {len(hot)} hot)")
    if launches <= 0 or n_fb != len(degraded) or tr != {"degraded": 1, "healthy": 1} or health.degraded:
        raise AssertionError(f"phase 19 a: launches {launches}, fallback {n_fb} for {len(degraded)} degraded "
                             f"answers, latch {tr}, degraded now {health.degraded}")
    DRILLS["latches"] += 1
    DRILLS["fallback"] += n_fb
    return out


def _cli(args, timeout: float, **env) -> str:
    """``python3 -m kakveda_tpu_torch.cli`` with ``args``; its stdout (rc 0)."""
    repo = Path(__file__).resolve().parent
    r = subprocess.run([sys.executable, "-m", "kakveda_tpu_torch.cli", *args], cwd=repo, capture_output=True,
                       text=True, timeout=timeout, env={**os.environ, "PYTHONPATH": str(repo), **env})
    if r.returncode != 0:
        raise AssertionError(f"cli {' '.join(args)}: {r.returncode}\n{r.stdout[-2000:]}\n{r.stderr[-3000:]}")
    return r.stdout


async def _record_replay(s, url: str, base: Path, card: str, dl: _Deadline) -> dict:
    """Phase 19 b against the entry-point child at ``url``."""
    from kakveda_tpu_torch import traffic as T

    out = {}
    for b in _service_batches(lo=40_000)[:REPLAY_INGESTS]:
        await _jpost(s, url + "/ingest/batch", {"traces": b})
    bodies = [_warn_body(f"app-{'ABCDEFG'[i % 7]}", f"Summarize report {40_000 + 3 * i + 1} and include citations")
              for i in range(REPLAY_WARNS)]

    async def client(c):
        for body in bodies[c::16]:
            await _jpost(s, url + "/warn", body)

    await asyncio.gather(*(client(c) for c in range(16)))
    log_path = base / "captured.jsonl"
    loop = asyncio.get_running_loop()
    rec = json.loads(await loop.run_in_executor(None, lambda: _cli(
        ["traffic", "record", "--url", url, "--out", str(log_path)], dl.left(60.0))))
    dump = await _jget(s, url + "/flightrecorder")
    meta, events = T.read_log(log_path)
    if rec["events"] != REPLAY_WARNS + REPLAY_INGESTS or events != T.from_flightrecorder(dump, seed=0):
        raise AssertionError(f"phase 19 b: record wrote {rec}; its events equal from_flightrecorder of the same "
                             f"dump: {events == T.from_flightrecorder(dump, seed=0)}")
    r0 = await _jget(s, url + "/readyz")
    rep = json.loads(await loop.run_in_executor(None, lambda: _cli(
        ["traffic", "replay", "--url", url, "--log", str(log_path), "--speed", "1"], dl.left(90.0))))
    r1 = await _jget(s, url + "/readyz")
    launches = r1["device"]["launches"]["fused_topk"] - r0["device"]["launches"]["fused_topk"]
    fallback = r1["tiers"]["fallback"] - r0["tiers"]["fallback"]
    counts = rep["replay"]["class_counts"]
    out.update(events=len(events), meta=meta, counts=counts, late_p95_ms=rep["replay"]["late_p95_ms"],
               wall_s=rep["replay"]["wall_s"], span_s=events[-1]["t"], launches=launches, fallback=fallback,
               slo=rep["slo"]["ok"])
    if (counts != {"warn": {"ok": REPLAY_WARNS}, "ingest": {"ok": REPLAY_INGESTS}} or not rep["slo"]["ok"]
            or launches <= 0 or fallback != 0 or r1["device"]["degraded"] is not False):
        raise AssertionError(f"phase 19 b: replay {counts}, SLO {rep['slo']}, fused_topk launches {launches}, "
                             f"fallback warns {fallback}, device {r1['device']}")
    log(f"phase 19 b: {REPLAY_WARNS} /warn and {REPLAY_INGESTS} /ingest/batch to the entry-point child; `cli traffic "
        f"record` wrote {rec['events']} events (== from_flightrecorder of the same dump, {events[-1]['t']:.3f} s of "
        f"traffic); `cli traffic replay --log --speed 1`: {counts}, none lost or hung, late p95 "
        f"{out['late_p95_ms']} ms, {out['wall_s']} s; the child's fused_topk launches {launches}, fallback warns "
        f"{fallback}, not degraded [{card}]")
    return out


class _PidSupervisor:
    """The chaos timeline's supervisor handle for a fleet whose router
    supervises it: ``crash_replica`` SIGKILLs the pid in
    ``replica-<i>.pid``; the lease marker is the supervisor's own."""

    def __init__(self, fl):
        from kakveda_tpu_torch.fleet.supervisor import FleetSupervisor

        self.fl, self.killed = fl, []
        self.sup = FleetSupervisor(fl.root, port_base=fl.base, replicas=fl.n, device="cuda",
                                   env={k: v for k, v in fl.env.items() if k.startswith("KAKVEDA_")})

    def may_hold_device_lease(self, i: int) -> bool:
        return self.sup.may_hold_device_lease(i)

    def stop(self, i: int, timeout_s: float = 20.0, sig=None) -> None:
        import signal

        pid = self.fl.pid(i)
        os.kill(pid, sig or signal.SIGTERM)
        self.killed.append((i, pid, time.perf_counter()))

    def start(self, i: int) -> None:
        raise AssertionError("phase 19 c starts no replica: the autoscaler replaces")


class _RemoteScaler:
    """The router's autoscaler as ``run_scenario`` reads it, through the
    router's ``/readyz`` ``autoscale`` block."""

    def __init__(self, router: str):
        self.router = router

    def info(self) -> dict:
        from kakveda_tpu_torch.core import httpjson

        return json.loads(httpjson.request("GET", self.router + "/readyz", timeout=5.0)[1])["autoscale"]

    def decision_counts(self) -> dict:
        return dict(self.info()["counts"])

    def flap_count(self) -> int:
        return int(self.info()["flaps"])


def _distinct(scores) -> list:
    out = []
    for x in scores:
        if not out or abs(out[-1] - x) > ATOL:
            out.append(x)
    return out


def _hold_merged_to_oracle(answers, bodies, oracle, what: str) -> int:
    """Scatter-gather answers against the oracle Platform's ``warn_batch`` of
    the same requests: the action, the top-1 confidence within 1e-4, and the
    distinct scores rank by rank within ATOL (under R = 2 the merge repeats
    a row held by owner and standby, in the JAX package too: ROADMAP Queue
    3)."""
    from kakveda_tpu_torch.core.schemas import WarningRequest

    direct = []
    for lo in range(0, len(bodies), 64):
        direct += oracle.warn_batch([WarningRequest.model_validate(b) for b in bodies[lo : lo + 64]])
    for j, (a, d) in enumerate(zip(answers, direct)):
        got = _distinct([x["score"] for x in a["references"]])
        want = _distinct([x.score for x in d.references])
        if a["action"] != d.action or abs(a["confidence"] - d.confidence) > 1e-4 or got != want[: len(got)] \
                or len(got) < min(2, len(want)):
            raise AssertionError(f"{what} answer {j}: {a['action']} {a['confidence']} {got} vs oracle "
                                 f"{d.action} {d.confidence} {want}")
    return len(direct)


def _migration_met_the_kill(lines: list, killed: list, wall_to_perf: float) -> list:
    """The scale-ups whose range migration failed against the replica the
    chaos timeline SIGKILLed (a ``MigrationError`` ledgered after the kill)
    while no scale-up succeeded: the race the JAX package loses too when
    its newcomer is ready as late (ROADMAP Queue 3). Empty otherwise."""
    if any(ln["action"] == "scale_up" and ln["outcome"] == "ok" for ln in lines) or len(killed) != 1:
        return []
    t_kill = killed[0][2]
    return [ln for ln in lines if ln["action"] == "scale_up" and ln["outcome"] == "error"
            and "MigrationError" in ln.get("detail", "") and ln["ts"] + wall_to_perf > t_kill]


async def _elastic(s, fl, oracle, batches, card: str, dl: _Deadline) -> dict:
    """Phase 19 c on the fleet ``fl`` (router and two replicas up). A run
    whose only scale-up lost its migration to the SIGKILL (the race of
    :func:`_migration_met_the_kill`) is held to every other check and
    prints the gate as failed beside the JAX package's reading."""
    import dataclasses as dc

    from kakveda_tpu_torch import traffic as T

    out = {}
    urls = [fl.url(i) for i in range(4)]  # the two, the third, a failed scale-up's
    unique = 0
    for b in batches:
        unique += (await _jpost(s, fl.router + "/ingest/batch", {"traces": b}))["failures"]
    await _converge(s, urls[:2], lambda c: c == [unique] * 2, dl.left(30.0), "phase 19 c seed")
    rep0 = await _jget(s, fl.router + "/readyz")
    epoch0, pids0 = rep0["ownership"]["epoch"], {i: fl.pid(i) for i in range(2)}

    samples, stop = [], asyncio.Event()

    async def monitor():
        """Router epoch and members, and each live replica process's count
        and launches, every 0.25 s."""
        while not stop.is_set():
            # A replica's log file appears when the supervisor spawns it.
            row = {"t": time.perf_counter(), "replicas": {},
                   "logs": [i for i in range(len(urls)) if (fl.root / f"replica-{i}.log").exists()]}
            with contextlib.suppress(Exception):
                rep = await _jget(s, fl.router + "/readyz")
                row.update(epoch=rep["ownership"]["epoch"], members=sorted(rep["ownership"]["members"]),
                           holes=rep["ownership"]["coverage_holes"])
            for i, u in enumerate(urls):
                pid = None
                with contextlib.suppress(OSError, ValueError):
                    pid = fl.pid(i)
                    os.kill(pid, 0)
                if pid is None:
                    continue
                with contextlib.suppress(Exception):
                    r = await _jget(s, u + "/readyz")
                    row["replicas"][i] = dict(pid=pid, count=r["gfkb_count"],
                                              launches=r["device"]["launches"]["fused_topk"],
                                              epoch=r["ownership"]["epoch"], degraded=r["device"]["degraded"])
                    continue
                row["replicas"][i] = dict(pid=pid)  # alive, not answering yet
            samples.append(row)
            await asyncio.sleep(0.25)

    answers, partial = [], [0]

    async def post(path, body):
        async with s.post(fl.router + path, json=body) as r:
            data = await r.read()
            if path == "/warn" and r.status == 200:
                a = json.loads(data)
                answers.append((body, a))
                partial[0] += bool(a.get("partial"))
            return r.status

    sc = T.make_scenario("flash_crowd", **ELASTIC_SCENARIO)
    crasher, scaler = _PidSupervisor(fl), _RemoteScaler(fl.router)
    mon = asyncio.create_task(monitor())
    t0 = time.perf_counter()
    try:
        res = await T.run_scenario(sc, post=post, speed=1.0, supervisor=crasher, autoscaler=scaler, timeout_s=15.0)
        out["replay_s"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        wall_to_perf = time.perf_counter() - time.time()
        raced = []
        while True:
            info = (await _jget(s, fl.router + "/readyz"))
            counts = info["autoscale"]["counts"]
            live = [rid for rid, r in info["replicas"].items() if r["healthy"] and not r["ejected"]]
            held = [r["gfkb_count"] for rid, r in info["replicas"].items() if rid in live]
            ledger = fl.root / "data" / "scale_log.jsonl"
            with contextlib.suppress(OSError, ValueError):  # not written yet, or a line half written
                raced = _migration_met_the_kill([json.loads(x) for x in ledger.read_text().splitlines()],
                                                crasher.killed, wall_to_perf)
            scaled = counts.get("scale_up:ok", 0) >= 1 and counts.get("scale_down:ok", 0) >= 1
            if ((scaled or raced) and counts.get("replace:ok", 0) >= 1 and len(live) == 2
                    and info["ownership"]["coverage_holes"] == 0 and held == [unique, unique]
                    and info["autoscale"]["state"] in ("steady", "cooldown")):
                break
            if time.perf_counter() - t1 > dl.left(ELASTIC_CONVERGE_S):
                raise AssertionError(f"phase 19 c: no convergence {time.perf_counter() - t1:.1f} s after the "
                                     f"replay: decisions {counts}, live {live} holding {held} of {unique}, holes "
                                     f"{info['ownership']['coverage_holes']}; scale_log.jsonl:\n{ledger.read_text()}")
            await asyncio.sleep(0.25)
        out["converge_s"] = time.perf_counter() - t1
    finally:
        stop.set()
        await mon
    res.notes["scale_flaps"] = float(info["autoscale"]["flaps"])
    res.notes["partial"] = float(partial[0])
    report = T.evaluate(dc.replace(sc.slo, max_partial_rate=ELASTIC_MAX_PARTIAL), res)

    # The ledger, its families and the decisions taken (two ticks on, so
    # the replicas gauge has read the drained fleet).
    await asyncio.sleep(2 * float(ELASTIC_ENV["KAKVEDA_SCALE_TICK_S"]))
    lines = [json.loads(x) for x in (fl.root / "data" / "scale_log.jsonl").read_text().splitlines()]
    by = {}
    for ln in lines:
        by[f"{ln['action']}:{ln['outcome']}"] = by.get(f"{ln['action']}:{ln['outcome']}", 0) + 1
    text = await _tget(s, fl.router + "/metrics")
    fams = {k: _fleet_metric(text, "kakveda_fleet_scale_decisions_total", f'action="{k.split(":")[0]}",'
                             f'outcome="{k.split(":")[1]}"') for k in by}
    flaps_m = _fleet_metric(text, "kakveda_fleet_scale_flaps_total")
    state_m = {st: _fleet_metric(text, "kakveda_fleet_scale_state", f'state="{st}"')
               for st in ("steady", "scale_up", "drain", "replace", "cooldown")}
    replicas_m = _fleet_metric(text, "kakveda_fleet_scale_replicas")
    trans_m = _fleet_metric(text, "kakveda_fleet_scale_transitions_total")
    info = (await _jget(s, fl.router + "/readyz"))["autoscale"]
    if (by != info["counts"] or {k: int(v) for k, v in fams.items()} != by or int(flaps_m) != info["flaps"]
            or state_m[info["state"]] != 1.0 or sum(state_m.values()) != 1.0 or replicas_m != 2.0
            or trans_m < 2 * len(lines)):
        raise AssertionError(f"phase 19 c: scale_log {by} vs info {info['counts']} vs families {fams}, flaps "
                             f"{flaps_m} vs {info['flaps']}, state {state_m} vs {info['state']}, replicas "
                             f"{replicas_m}, transitions {trans_m} for {len(lines)} decisions")

    # The actions themselves, from the log and the monitor's samples.
    ups = [ln for ln in lines if ln["action"] == "scale_up" and ln["outcome"] == "ok"]
    repl = [ln for ln in lines if ln["action"] == "replace" and ln["outcome"] == "ok"]
    downs = [ln for ln in lines if ln["action"] == "scale_down" and ln["outcome"] == "ok"]
    epochs = [r["epoch"] for r in samples if "epoch" in r]
    seen3 = [r for r in samples if len(r.get("members", [])) == 3]
    newcomer = sorted({m for r in seen3 for m in r["members"]} - {"r0", "r1"})
    nc_rows = max((x.get("count") or 0 for r in samples for i, x in r["replicas"].items()
                   if newcomer and f"r{i}" == newcomer[0]), default=0)
    rep_epochs = {x["epoch"] for r in samples for x in r["replicas"].values() if "epoch" in x}
    killed = crasher.killed
    members = (await _jget(s, fl.router + "/readyz"))["ownership"]["members"]
    final = {int(m[1:]): fl.pid(int(m[1:])) for m in members}
    raced = _migration_met_the_kill(lines, killed, wall_to_perf)
    if raced:  # the shared race: no third member, no drain; every other check holds
        nc = int(raced[0]["target"][1:])
        spawn = next((r["t"] for r in samples if nc in r["logs"]), None)
        ready = next((r["t"] for r in samples if "count" in r["replicas"].get(nc, {})), None)
        out["raced"] = dict(target=raced[0]["target"], detail=raced[0]["detail"],
                            spawn_to_ready=None if None in (spawn, ready) else round(ready - spawn, 2),
                            kill_after_spawn=None if spawn is None else round(killed[0][2] - spawn, 2),
                            logged_after_kill=round(raced[0]["ts"] + wall_to_perf - killed[0][2], 2))
        log(f"phase 19 c: the scale-up's range migration met the SIGKILLed r{killed[0][0]}: {out['raced']}; "
            f"the gate 'a scale-up runs' FAILS here, as in the JAX package at a late spawn ({ELASTIC_JAX_WITNESS}); "
            f"open in ROADMAP Queue 3. Every other check of phase 19 c still holds [{card}]")
    elif not (ups and ups[0]["target"] in newcomer and nc_rows > 0 and max(epochs) > epoch0
              and rep_epochs <= set(epochs) | {epoch0}):
        raise AssertionError(f"phase 19 c scale-up: {ups}, members seen {newcomer}, the newcomer's rows {nc_rows}, "
                             f"router epochs {sorted(set(epochs))} from {epoch0}, replica epochs {rep_epochs}")
    # The replacement: the SIGKILLed index back with a new process that
    # holds at least what the dead one held.
    crash_i, crash_pid, t_kill = killed[0] if len(killed) == 1 else (None, None, 0.0)
    before_kill = [x["count"] for r in samples if r["t"] < t_kill for i, x in r["replicas"].items()
                   if i == crash_i and x.get("pid") == crash_pid and "count" in x]
    healed = next((r["t"] for r in samples if r["t"] > t_kill and crash_i in r["replicas"]
                   and r["replicas"][crash_i].get("pid") not in (None, crash_pid)
                   and (r["replicas"][crash_i].get("count") or 0) >= (before_kill or [1 << 30])[-1]), None)
    if not (crash_i is not None and crash_pid == pids0[crash_i] and repl and repl[0]["target"] == f"r{crash_i}"
            and healed is not None):
        raise AssertionError(f"phase 19 c replacement: killed {killed}, replaced {repl}, held before "
                             f"{before_kill[-1:]}, healed at {healed}, pids {pids0} -> {final}")
    # The drain: the victim's process still alive when the ring last held
    # it (migrate, de-ring, THEN stop), gone after.
    victim = downs[0]["target"] if downs else "r?"
    vi = int(victim[1:]) if downs else -1
    ringed = [r["t"] for r in samples if victim in r.get("members", ())]
    alive = [r["t"] for r in samples if vi in r["replicas"]]
    if raced:
        if downs or len(final) != 2:
            raise AssertionError(f"phase 19 c: no scale-up, yet drains {downs}, replicas left {final}")
    elif not (downs and ringed and alive and alive[-1] >= ringed[-1] and vi not in final and len(final) == 2
              and not (fl.root / f"replica-{vi}.pid").exists()):
        raise AssertionError(f"phase 19 c drain: {downs}, {victim} last in the ring at {ringed[-1:]}, its process "
                             f"last alive at {alive[-1:]}, replicas left {final}")
    wc = res.class_counts().get("warn", {})
    n_gen = res.generated("warn")
    bad = [a for _, a in answers if a.get("degraded") is not False or a.get("tier") != "hot"]
    if not report.ok or int(res.notes["scale_flaps"]) > 1 or wc.get("ok", 0) != n_gen or bad:
        raise AssertionError(f"phase 19 c: {report.summary()}, flaps {res.notes['scale_flaps']}, warns {wc} of "
                             f"{n_gen}, {len(bad)} answers not from the card's hot index")
    held = _hold_merged_to_oracle([a for _, a in answers], [b for b, _ in answers], oracle, "phase 19 c")

    # Each replica process's own fused_topk launches across the section.
    first, last = {}, {}
    for r in samples:
        for i, x in r["replicas"].items():
            if "launches" in x:
                key = (i, x["pid"])
                first.setdefault(key, x["launches"] if r is samples[0] else 0)
                last[key] = x["launches"]
    launches = {f"r{i}/{pid}": last[(i, pid)] - first[(i, pid)] for i, pid in sorted(last)}
    if sum(launches.values()) <= 0:
        raise AssertionError(f"phase 19 c: no replica launched fused_topk: {launches}")
    out.update(decisions=by, flaps=int(res.notes["scale_flaps"]), warns=wc, generated=n_gen, partial=partial[0],
               held_to_oracle=held, launches=launches, epochs=sorted(set(epochs)), newcomer=newcomer,
               newcomer_rows=nc_rows, killed=[(i, pid) for i, pid, _ in killed], slo=report.to_dict(),
               log=lines, late_p95_ms=res.late_p95_ms(), wall_replay_s=res.wall_s)
    # Times from the monitor's samples: the newcomer's spawn (its log file)
    # to its first answer and to the router's flip to three members; the
    # SIGKILL to the replacement holding the dead process's rows again.
    out["times_s"] = dict(kill_to_healed=round(healed - t_kill, 2))
    if not raced:
        nc = int(newcomer[0][1:])
        spawn = next((r["t"] for r in samples if nc in r["logs"]), None)
        ready3 = next((r["t"] for r in samples if "count" in r["replicas"].get(nc, {})), None)
        out["times_s"].update(
            spawn_to_ready=None if ready3 is None or spawn is None else round(ready3 - spawn, 2),
            spawn_to_flip=None if spawn is None else round(seen3[0]["t"] - spawn, 2),
            scale_up_logged_s=round(ups[0]["ts"] + wall_to_perf - t0, 2))
    log(f"phase 19 c: `cli up --replicas 2 --autoscale 2:3 -d`, ownership R = 2, {unique} rows; flash_crowd "
        f"(seed {ELASTIC_SCENARIO['seed']}, {sc.duration_s} s): warns {wc} of {n_gen}, {partial[0]} partial, "
        f"{held} held to an oracle Platform; decisions {by} (scale_log == /readyz == "
        f"kakveda_fleet_scale_decisions_total), flaps {out['flaps']}; "
        + ("no scale-up (the race above), no drain; " if raced else
           f"scale-up {newcomer} holding {nc_rows} rows (router epochs {out['epochs']}); {victim} drained then "
           "stopped; ")
        + f"r{crash_i} SIGKILLed at surge end and replaced at its index; times {out['times_s']}; fused_topk "
        f"launches per replica process {launches}; "
        f"converged {out['converge_s']:.1f} s after the replay; {report.summary()} [{card}]")
    return out


def phase_elastic(base: Path, fused_topk, card: str) -> dict:
    """Phase 19: a. the storm drill in process, b. record → replay against
    the entry-point child, c. the elastic fleet under the flash crowd. The
    child and the fleet start first, so their start-up overlaps a."""
    import aiohttp

    from kakveda_tpu_torch.core.schemas import TracePayload

    t_phase = time.perf_counter()
    dl = _Deadline(PHASE19_WALL_S, "phase 19")
    repo = Path(__file__).resolve().parent
    out = {}
    free0, mine0 = _card_free(), torch.cuda.memory_reserved()
    batches = [b[0][:ELASTIC_PER_APP] for b in (_service_batches(lo=50_000 + ELASTIC_PER_APP * a, n=ELASTIC_PER_APP,
                                                                 app=f"app-{a}")
                                                for a in range(ELASTIC_SCENARIO["apps"]))]
    # Two more ports: the third replica, and one a scale-up that fails after
    # its spawn leaves running (a crash while the surge's pressure holds).
    fl = _FleetProc(base / "elastic", 2, detach=True, args=("--autoscale", "2:3"), extra_ports=2, **ELASTIC_ENV)
    child_out = base / "child.out"
    proc, url = _start_service(repo, base / "child-data", child_out)
    oracle = None
    try:
        out["a"] = phase_storm(base, fused_topk, card)
        oracle = _oracle(base, "oracle-elastic", batches, TracePayload)

        async def go():
            async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=256),
                                             timeout=aiohttp.ClientTimeout(total=60)) as s:
                await _wait_healthz(s, url, proc, child_out, time.perf_counter())
                b = await _record_replay(s, url, base, card, dl)
                await asyncio.get_running_loop().run_in_executor(None, _stop_service, proc, child_out)
                await fl.wait_router(s, 2, timeout=dl.left(120.0))
                c = await _elastic(s, fl, oracle, batches, card, dl)
                return b, c

        out["b"], out["c"] = asyncio.run(go())
        fl.down()
    except BaseException:
        fl.kill()
        raise
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        if oracle is not None:
            _drop(oracle)
    oracle = None
    gc.collect()
    torch.cuda.empty_cache()
    # The card's free memory, plus what this process's allocator holds
    # beyond its start-of-phase share: back to the start's, less 512 MiB.
    t = time.perf_counter()
    while (back := _card_free() + torch.cuda.memory_reserved() - mine0) < free0 - (1 << 29):
        if time.perf_counter() - t > dl.left(15.0):
            raise AssertionError(f"phase 19 c: the card's free memory {_card_free()} after down (this process "
                                 f"holding {torch.cuda.memory_reserved() - mine0} more), {free0} before up")
        time.sleep(0.1)
    out["memory_back_s"] = time.perf_counter() - t
    out["wall_s"] = time.perf_counter() - t_phase
    log(f"phase 19: {out['wall_s']:.1f} s (limit {PHASE19_WALL_S:.0f}); the card's free memory back to {back} "
        f"(>= {free0} - 512 MiB) {out['memory_back_s']:.2f} s after `cli down`")
    log("phase 19: " + json.dumps({k: v for k, v in out.items()}, default=str))
    return out


def launch_counts() -> dict:
    """Every attention launch counter: the flash kernel's three bodies and
    ``gqa_grouped`` on the card."""
    from kakveda_tpu_torch.models.attention import flash_gqa_cache, gqa_grouped

    return dict(bf16=flash_gqa_cache.launches, int8=flash_gqa_cache.launches_kv8,
                f32=flash_gqa_cache.launches_f32, grouped=gqa_grouped.launches)


def zero_launches() -> None:
    from kakveda_tpu_torch.models.attention import flash_gqa_cache, gqa_grouped

    flash_gqa_cache.launches = flash_gqa_cache.launches_kv8 = flash_gqa_cache.launches_f32 = 0
    gqa_grouped.launches = 0


def path_counter(cfg, kvq: str) -> str:
    """The counter a forward of ``cfg`` with cache ``kvq`` moves on the card
    (``card_path``)."""
    from kakveda_tpu_torch.models.attention import card_path

    if card_path(cfg.dtype, cfg.head_dim, False, bool(kvq)) == "grouped":
        return "grouped"
    return "int8" if kvq else ("f32" if cfg.dtype == torch.float32 else "bf16")


def hold_launches(cfg, kvq: str, n_fwd: int, what: str) -> int:
    """The counter of ``cfg``'s path moved n_layers × forwards, every other 0."""
    counts = launch_counts()
    mine = counts.pop(path_counter(cfg, kvq))
    if mine != cfg.n_layers * n_fwd or any(counts.values()):
        raise AssertionError(f"{what}: {mine} launches on {path_counter(cfg, kvq)} for {n_fwd} forwards "
                             f"(want {cfg.n_layers} each), others {counts}")
    return mine


F32_TOKENS = 32  # phase 16 a's requests


def f32_model(card: str) -> dict:
    """Phase 16 a: ``llama3_8b()`` in f32 at full width and phase 6's depth,
    LLAMA3_LAYERS of its 32 layers (random weights from seed 0, 14.7 GB;
    32.1 GB at 32) through the engine (8 slots, window 512):
    8 prompts × F32_TOKENS with ``spec_k`` 0 and with ``KAKVEDA_SERVE_SPEC=4``
    (the gate held open), each launching the f32 body once a layer per
    forward; tokens held to the solo ``generate_tokens`` by the margin rule
    (departures counted); the step's device time against its weight-read
    bound, the host step and tokens/s; then a tiny f32 config (head_dim 64)
    whose engine tokens, with and without spec, equal the CPU port's."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime, generate_tokens
    from kakveda_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), dtype=torch.float32, n_layers=LLAMA3_LAYERS)
    tok = RecordingTokenizer()
    t0 = time.perf_counter()
    rt = LlamaRuntime(cfg=cfg, seed=0, tokenizer=tok)
    torch.cuda.synchronize()
    draw_s = time.perf_counter() - t0
    cfg = rt.cfg  # the byte tokenizer's vocabulary masks the table's pad columns
    n_bytes = param_bytes(rt.params)
    log(f"phase 16 a: Llama-3-8B in f32, {cfg.n_layers} of its 32 layers, {n_bytes / 1e9:.2f} GB of weights on "
        f"{rt.device}, drawn in {draw_s:.1f} s")
    want_bytes = 2 * (LLAMA3_OTHER_BYTES + cfg.n_layers * LLAMA3_LAYER_BYTES)  # f32: 32.12e9 at 32 layers
    if rt.device.type != "cuda" or abs(n_bytes - want_bytes) > 0.05e9:
        raise AssertionError(f"f32 model on {rt.device} with {n_bytes} bytes")
    ids = [tok.encode(p) for p in PROMPTS]
    out = dict(weight_bytes=n_bytes, draw_s=draw_s)
    solo = [generate_tokens(rt.params, cfg, p, max_new_tokens=F32_TOKENS, eos_id=tok.EOS) for p in ids]
    with env_set(KAKVEDA_SERVE_SPEC_CALIB=0, KAKVEDA_SERVE_SPEC_BREAKEVEN=0):
        for spec in (0, SPEC_K):
            r = spec_engine_run(rt, tok, PROMPTS, "", spec, f"llama3-8b-f32-k{spec}", f"phase 16 a spec_k={spec}",
                                F32_TOKENS)
            margins = [margin_rule(rt.params, cfg, tok, p, ref, got, f"phase 16 a spec_k={spec}", F32_TOKENS)
                       for p, ref, got in zip(ids, solo, r["tokens"])]
            deps = [round(m, 4) for m in margins if m is not None]
            out[f"k{spec}"] = dict(launches=r["launches"], forwards=r["forwards"], tokens_per_s=r["tokens_per_s"],
                                   wall_s=r["wall_s"], spec_chunks=r["spec_chunks"], departures=deps,
                                   tokens_per_verify=r["spec"]["tokens_per_verify"] if spec else None)
            log(f"phase 16 a spec_k={spec}: 8 x {F32_TOKENS} tokens through the engine, {r['tokens_per_s']:.1f} "
                f"tokens/s, {r['launches']} f32 launches = {cfg.n_layers} x {r['forwards']} forwards, "
                f"{r['spec_chunks']} verify chunks; == the solo generate_tokens but for {len(deps)} departures at "
                f"margins {deps} (< {MARGIN_TOL}) [{card}]")
    out["f32"] = dict(tokens_per_s=out["k0"]["tokens_per_s"])
    step_times(rt, ids, out, n_bytes, "phase 16 a: Llama-3-8B f32", card, caches=(("", "f32"),))
    rt.close()
    del rt
    gc.collect()
    torch.cuda.empty_cache()

    # The tiny f32 config at head_dim 64: card == CPU port.
    tiny = LlamaConfig(vocab_size=264, d_model=256, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512, max_seq_len=512,
                       effective_vocab=259, dtype=torch.float32)
    out["tiny"] = card_vs_cpu(tiny, "phase 16 a tiny f32 (head_dim 64)", card, spec=True)
    return out


def card_vs_cpu(cfg, what: str, card: str, spec: bool = False, n_tok: int = 24) -> dict:
    """``cfg`` with random weights from a seed, drawn on the CPU and copied
    to the card, served through the engine on both: 8 prompts × ``n_tok``
    (and with ``KAKVEDA_SERVE_SPEC=4``, the gate held open, when ``spec``);
    the card's launches on ``cfg``'s path only, its tokens == the CPU port's
    by the margin rule."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import init_params

    params = init_params(torch.Generator().manual_seed(16), dataclasses.replace(cfg, dtype=torch.float32), "cpu")
    params = _params_to(_params_dtype(params, cfg.dtype), "cpu")
    card_params = _params_to(params, "cuda")
    out = {}
    for k in ((0, SPEC_K) if spec else (0,)):
        toks = {}
        with env_set(KAKVEDA_SERVE_SPEC=k, KAKVEDA_SERVE_SPEC_CALIB=0, KAKVEDA_SERVE_SPEC_BREAKEVEN=0):
            for dev, p in (("cuda", card_params), ("cpu", params)):
                tok = RecordingTokenizer()
                rt = LlamaRuntime(cfg=cfg, params=p, tokenizer=tok, device=dev)
                try:
                    if dev == "cuda":
                        zero_launches()
                        f0 = rt.engine().cb.forwards
                    res = rt.generate_batch(PROMPTS, max_tokens=n_tok)
                    if dev == "cuda":
                        torch.cuda.synchronize()
                        n_fwd = rt.engine().cb.forwards - f0
                        launches = hold_launches(rt.cfg, "", n_fwd, f"{what} spec_k={k}")
                        chunks = rt.engine().stats()["spec"]["chunks"]
                finally:
                    rt.close()
                if not all(r.meta.get("continuous") for r in res):
                    raise AssertionError(f"{what}: not served through the engine on {dev}")
                toks[dev] = list(tok.decoded)
        if k and not chunks:
            raise AssertionError(f"{what} spec_k={k}: no verify chunk ran")
        ids = [RecordingTokenizer().encode(p) for p in PROMPTS]
        margins = [margin_rule(card_params, cfg, RecordingTokenizer(), p, ref, got, f"{what} spec_k={k}", n_tok)
                   for p, ref, got in zip(ids, toks["cpu"], toks["cuda"])]
        deps = [round(m, 4) for m in margins if m is not None]
        out[f"k{k}"] = dict(launches=launches, path=path_counter(cfg, ""), departures=deps, spec_chunks=chunks)
        log(f"{what} spec_k={k}: {launches} launches on {path_counter(cfg, '')} for {n_fwd} forwards; 8 x {n_tok} "
            f"tokens card == the CPU port's but for {len(deps)} departures at margins {deps} [{card}]")
    return out


def _params_dtype(params, dtype):
    if isinstance(params, dict):
        return {k: _params_dtype(v, dtype) for k, v in params.items()}
    if isinstance(params, list):
        return [_params_dtype(v, dtype) for v in params]
    return params.to(dtype) if params.is_floating_point() else params


def full_mask_on_card(card: str) -> dict:
    """Phase 16 c: ``gqa_cache_attention`` with a ``full_mask`` (the
    reference's per-slot mask of a verify chunk) on the card goes through
    ``gqa_grouped`` and equals the CPU port's, bf16 at D 128 (within 2e-2)
    and f32 at D 64 (within 1e-4)."""
    from kakveda_tpu_torch.models.attention import gqa_cache_attention

    g = torch.Generator().manual_seed(161)
    out = {}
    for dtype, d, tol in ((torch.bfloat16, HD, FLASH_ATOL), (torch.float32, 64, F32_ATOL)):
        b, s, l = 8, SPEC_K + 1, 512
        q = torch.randn(b, s, H, d, generator=g).to(dtype)
        k = torch.randn(b, KV, l, d, generator=g).to(dtype)
        v = torch.randn(b, KV, l, d, generator=g).to(dtype)
        pos = torch.randint(64, l - s, (b,), generator=g)
        ar = torch.arange(l)
        valid = ar[None] >= torch.randint(0, 16, (b, 1), generator=g)
        mask = valid[:, None, :] & (ar[None, None, :] <= (pos[:, None] + torch.arange(s))[..., None])
        want = gqa_cache_attention(q, k, v, 0, valid, full_mask=mask)
        zero_launches()
        got = gqa_cache_attention(*(t.cuda() for t in (q, k, v)), 0, valid.cuda(), full_mask=mask.cuda())
        torch.cuda.synchronize()
        counts = launch_counts()
        err = (got.float().cpu() - want.float()).abs().max().item()
        if counts != dict(bf16=0, int8=0, f32=0, grouped=1) or err > tol:
            raise AssertionError(f"phase 16 c {dtype}: launches {counts}, max |card - CPU| {err} > {tol}")
        out[str(dtype)] = err
    log(f"phase 16 c: full_mask through gqa_grouped on the card == the CPU port: max_abs_err {out} [{card}]")
    return out


# A byte-level BPE tokenizer.json written by hand (the card's machine has no
# `tokenizers` to train one): the 256 byte symbols, seven merges and an
# end-of-text token, 264 ids: the written checkpoints' vocabulary.
HAND_MERGES = [("Ġ", "t"), ("h", "e"), ("Ġt", "he"), ("i", "n"), ("e", "r"), ("o", "n"), ("a", "t")]


def write_tokenizer(path: Path) -> None:
    from kakveda_tpu_torch.models.tokenizer import _BYTE_CHAR

    vocab = {"<|endoftext|>": 0}
    for b in range(256):
        vocab[_BYTE_CHAR[b]] = len(vocab)
    for a, b in HAND_MERGES:
        vocab[a + b] = len(vocab)
    (path / "tokenizer.json").write_text(json.dumps({
        "version": "1.0",
        "added_tokens": [{"id": 0, "content": "<|endoftext|>", "single_word": False, "lstrip": False,
                          "rstrip": False, "normalized": False, "special": True}],
        "normalizer": None,
        "pre_tokenizer": {"type": "ByteLevel", "add_prefix_space": False, "trim_offsets": True, "use_regex": True},
        "post_processor": None,
        "decoder": {"type": "ByteLevel", "add_prefix_space": True, "trim_offsets": True, "use_regex": True},
        "model": {"type": "BPE", "dropout": None, "unk_token": None, "continuing_subword_prefix": None,
                  "end_of_word_suffix": None, "fuse_unk": False, "byte_fallback": False, "ignore_merges": False,
                  "vocab": vocab, "merges": [list(m) for m in HAND_MERGES]},
    }))
    (path / "tokenizer_config.json").write_text(json.dumps(
        {"bos_token": "<|endoftext|>", "eos_token": "<|endoftext|>", "clean_up_tokenization_spaces": False}))


def _record_decode(tok) -> list:
    """The ids of every ``decode`` of ``tok`` from now on."""
    seen, real = [], tok.decode

    def decode(ids):
        seen.append(list(ids))
        return real(ids)

    tok.decode = decode
    return seen


def checkpoints_with_tokenizer(base: Path, card: str) -> dict:
    """Phase 16 d: two written checkpoints (phase 14 c's Qwen2 and Qwen3)
    with the hand-written ``tokenizer.json``, served on the card by
    ``LlamaRuntime.from_hf`` and by a ``MultiModelRuntime`` over both, with
    no ``transformers`` on the machine; the texts and tokens equal the CPU
    port's (the margin rule), the load's seconds printed."""
    import importlib.util

    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.runtime import MultiModelRuntime

    out = dict(transformers_installed=importlib.util.find_spec("transformers") is not None)
    loaded_before = {m for m in ("transformers", "tokenizers") if m in sys.modules}
    paths = []
    for i, family in enumerate(("qwen2", "qwen3")):
        path = base / f"{family}-tok"
        write_family_checkpoint(path, family, seed=160 + i)
        write_tokenizer(path)
        paths.append(path)
    prompts = PROMPTS[:4]
    for path in paths:
        runs = {}
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            rt = LlamaRuntime.from_hf(str(path), device=dev)
            load_s = time.perf_counter() - t0
            seen = _record_decode(rt.tokenizer)
            try:
                zero_launches()
                texts = [r.text for r in rt.generate_batch(prompts, max_tokens=16)]
                counts = launch_counts()
            finally:
                rt.close()
            runs[dev] = (texts, list(seen), load_s, counts, rt)
        texts, toks, load_s, counts, rt = runs["cuda"]
        if rt.tokenizer.vocab_size != 264 or counts["bf16"] <= 0 or counts["grouped"]:
            raise AssertionError(f"phase 16 d {path.name}: vocab {rt.tokenizer.vocab_size}, launches {counts}")
        ids = [rt.tokenizer.encode(p) for p in prompts]
        margins = [margin_rule(rt.params, rt.cfg, rt.tokenizer, p, ref, got, f"phase 16 d {path.name}", 16)
                   for p, ref, got in zip(ids, runs["cpu"][1], toks)]
        deps = [round(m, 4) for m in margins if m is not None]
        if not deps and texts != runs["cpu"][0]:
            raise AssertionError(f"phase 16 d {path.name}: equal tokens but different texts")
        out[path.name] = dict(load_s=load_s, load_s_cpu=runs["cpu"][2], departures=deps,
                              tokens=sum(map(len, toks)), launches=counts["bf16"])
        log(f"phase 16 d {path.name}: LlamaRuntime.from_hf on the card in {load_s:.3f} s (CPU {runs['cpu'][2]:.3f} s), "
            f"tokenizer.json read by the port ({rt.tokenizer.vocab_size} ids); {out[path.name]['tokens']} tokens, "
            f"texts and tokens card == CPU but for {len(deps)} departures at margins {deps} [{card}]")
    texts = {}
    for dev in ("cuda", "cpu"):
        mm = MultiModelRuntime([str(p) for p in paths], device=dev)
        try:
            t0 = time.perf_counter()
            texts[dev] = {p.name: [r.text for r in mm.generate_batch(prompts[:2], model=p.name, max_tokens=12)]
                          for p in paths}
            wall = time.perf_counter() - t0
            if dev == "cuda":
                out["multi"] = dict(labels=mm.list_models(), wall_s=wall, loaded_bytes=mm.loaded_bytes())
        finally:
            mm.close()
    same = texts["cuda"] == texts["cpu"]
    out["multi"]["texts_equal_cpu"] = same
    pulled = {m for m in ("transformers", "tokenizers") if m in sys.modules} - loaded_before
    if pulled:
        raise AssertionError(f"phase 16 d: the tokenizer reader loaded {sorted(pulled)}")
    if not same and not any(out[p.name]["departures"] for p in paths):
        raise AssertionError(f"phase 16 d: MultiModelRuntime texts differ between the card and the CPU: {texts}")
    log(f"phase 16 d: MultiModelRuntime over {out['multi']['labels']} on the card (loads on first request, "
        f"{out['multi']['wall_s']:.2f} s for both), texts == the CPU's: {same}; transformers installed: "
        f"{out['transformers_installed']}, loaded by the reader: no [{card}]")
    return out


def trace_check(path: Path, card: str) -> dict:
    """The Chrome trace of phase 16 e: each kernel launched inside the range
    that names it (by the launch's correlation id, the host range holding
    its runtime call; or, where the trace has them, the range's device
    span), and the ten device operations that took the most time, with
    their shares of the traced window."""
    events = json.loads(path.read_text())["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel" and e.get("ph") == "X"]
    launch = {e["args"]["correlation"]: e for e in events
              if e.get("cat") in ("cuda_runtime", "cuda_driver") and "correlation" in e.get("args", {})}

    def ranges(name, cat):
        return [e for e in events if e.get("cat") == cat and e.get("name") == name and e.get("ph") == "X"]

    def inside(e, rs):
        return any(r["ts"] <= e["ts"] and e["ts"] + e.get("dur", 0) <= r["ts"] + r["dur"] for r in rs)

    checks = {}
    for kname, rname in (("topk_kernel", "gfkb.match.dispatch"), ("flash_gqa_kernel", "llama.generate_batch")):
        ks = [e for e in kernels if kname in e["name"]]
        host, dev = ranges(rname, "user_annotation"), ranges(rname, "gpu_user_annotation")
        by_launch = [inside(launch[e["args"]["correlation"]], host) for e in ks
                     if e.get("args", {}).get("correlation") in launch]
        by_device = [inside(e, dev) for e in ks] if dev else []
        ok = bool(ks) and ((by_launch and all(by_launch)) or (by_device and all(by_device)))
        checks[kname] = dict(kernels=len(ks), range=rname, host_ranges=len(host), device_ranges=len(dev),
                             inside_by_launch=f"{sum(by_launch)} of {len(by_launch)}",
                             inside_by_device=f"{sum(by_device)} of {len(by_device)}")
        if not ok:
            raise AssertionError(f"phase 16 e: {kname} is not inside {rname}: {checks[kname]}")
    dev_ops = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") and e.get("ph") == "X"]
    t0 = min(e["ts"] for e in dev_ops)
    t1 = max(e["ts"] + e.get("dur", 0) for e in dev_ops)
    tot = {}
    for e in dev_ops:
        tot[e["name"]] = tot.get(e["name"], 0.0) + e.get("dur", 0)
    busy = sum(tot.values())
    top = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
    top10 = [dict(name=n[:80], us=round(us, 1), share=round(us / (t1 - t0), 4)) for n, us in top]
    log(f"phase 16 e: trace {path.name}: {len(kernels)} kernels over a {(t1 - t0) / 1e3:.3f} ms device window, "
        f"device busy {busy / (t1 - t0):.3f} of it; kernels inside their ranges {json.dumps(checks)}; the ten "
        f"device operations that took the most time: {json.dumps(top10)} [{card}]")
    return dict(checks=checks, window_ms=(t1 - t0) / 1e3, busy_share=busy / (t1 - t0), top10=top10)


def profiler_phase(base: Path, card: str) -> dict:
    """Phase 16 e: ``core.profiling.profile()`` around one warm
    ``warn_batch`` at B = 64 on a Platform on the card (2^16 × 2048, 4,096
    failures) and one ``generate_batch`` of a 2-layer bf16 model (head_dim
    128) on the solo path (``KAKVEDA_SERVE_CONTINUOUS=0``: the kernels
    launch on the calling thread, inside ``llama.generate_batch``); the
    trace parsed (``trace_check``); ``/metrics`` shows
    ``kakveda_device_block_seconds`` under the ranges' names."""
    from kakveda_tpu_torch.core import metrics, profiling
    from kakveda_tpu_torch.core.schemas import TracePayload, WarningRequest
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=base / "data", capacity=1 << 16, dim=DIM)
    traces = [_trace(TracePayload, i, "app-A", f"Summarize incident report {i} and include citations")
              for i in range(4096)]
    for i in range(0, len(traces), 512):
        asyncio.run(plat.ingest_batch(traces[i:i + 512]))
    reqs = [WarningRequest(app_id="app-A", prompt=f"Summarize incident report {i * 61} and include citations",
                           tools=[], env={}) for i in range(64)]
    cfg = LlamaConfig(vocab_size=264, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=1024,
                      max_seq_len=512, effective_vocab=259)
    with env_set(KAKVEDA_SERVE_CONTINUOUS=0):
        rt = LlamaRuntime(cfg=cfg, seed=1, tokenizer=RecordingTokenizer())
        try:
            plat.warn_batch(reqs)  # warm: outside the trace
            rt.generate_batch(PROMPTS[:2], max_tokens=8)
            torch.cuda.synchronize()
            logdir = base / "trace"
            with profiling.profile(logdir):
                res = plat.warn_batch(reqs)
                gen = rt.generate_batch(PROMPTS[:4], max_tokens=16)
                torch.cuda.synchronize()
        finally:
            rt.close()
            plat.close()
    if len(res) != 64 or any(r.meta.get("continuous") for r in gen):
        raise AssertionError("phase 16 e: the traced work did not run as set up")
    files = sorted(logdir.glob("*.json"))
    if len(files) != 1:
        raise AssertionError(f"phase 16 e: {len(files)} trace files")
    out = trace_check(files[0], card)
    text = metrics.get_registry().render()
    names = ("gfkb.match.dispatch", "gfkb.match.fetch", "gfkb.insert", "llama.generate_batch")
    missing = [n for n in names if f'kakveda_device_block_seconds_count{{name="{n}"}}' not in text]
    if missing:
        raise AssertionError(f"phase 16 e: /metrics lacks kakveda_device_block_seconds for {missing}")
    out["metrics_names"] = list(names)
    log(f"phase 16 e: /metrics shows kakveda_device_block_seconds for {list(names)}")
    return out


def phase_gaps(base: Path, card: str) -> dict:
    """Phase 16 (after phase 14): a. ``f32_model``; b. head_dim 80 (bf16)
    and an f16 model through ``gqa_grouped`` (``card_vs_cpu``), the grouped
    count above 0 there and 0 in every bf16 phase before; c.
    ``full_mask_on_card``; d. ``checkpoints_with_tokenizer``; e.
    ``profiler_phase``."""
    from kakveda_tpu_torch.models.llama import LlamaConfig

    t0 = time.perf_counter()
    out, walls = {}, {}
    out["a"] = f32_model(card)
    walls["a"] = time.perf_counter() - t0
    out["b"] = {}
    for name, cfg in (
        ("d80_bf16", LlamaConfig(vocab_size=264, d_model=320, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                                 max_seq_len=512, effective_vocab=259)),
        ("d128_f16", LlamaConfig(vocab_size=264, d_model=512, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=1024,
                                 max_seq_len=512, effective_vocab=259, dtype=torch.float16)),
        ("d80_f32", LlamaConfig(vocab_size=264, d_model=320, n_layers=2, n_heads=4, n_kv_heads=2, d_ff=512,
                                max_seq_len=512, effective_vocab=259, dtype=torch.float32)),
    ):
        if path_counter(cfg, "") != "grouped":
            raise AssertionError(f"phase 16 b {name}: takes {path_counter(cfg, '')}, not gqa_grouped")
        out["b"][name] = card_vs_cpu(cfg, f"phase 16 b {name}", card)
    walls["b"] = time.perf_counter() - t0 - sum(walls.values())
    out["c"] = full_mask_on_card(card)
    walls["c"] = time.perf_counter() - t0 - sum(walls.values())
    out["d"] = checkpoints_with_tokenizer(base, card)
    walls["d"] = time.perf_counter() - t0 - sum(walls.values())
    out["e"] = profiler_phase(base, card)
    walls["e"] = time.perf_counter() - t0 - sum(walls.values())
    out["walls_s"] = {k: round(v, 1) for k, v in walls.items()}
    log("phase 16: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# phase 20: the application layer (the dashboard, the playground, the agent
# echo app, the operator CLI)
# ---------------------------------------------------------------------------

PHASE20_WALL_S = 30.0  # the phase's own limit (a + b + c)
DASH_SCENARIOS = (  # (app, prompt): phase 8 a ingested "Summarize report i ..." (i % 4: a failure)
    ("app-A", "Summarize report 1 and include citations"),
    ("app-B", "Summarize report 2 and include citations"),
    ("app-C", "Explain the rollout of feature 7 with references"),
    ("app-A", "Summarize report 1 and include citations"),  # again: matches the first run's own ingest
    ("app-D", "Summarize report 4 and include citations"),  # a passing trace of 8 a: no failure row
    ("app-E", "Describe the outage of the queue workers."),
    ("app-F", "Summarize report 4093 and include citations"),
    ("app-G", "Summarize report 30 and include citations"),
)
DASH_EXAMPLES = 64  # 20 a's dataset: half ingested signatures, half new
PLAYGROUND_PROMPT = PROMPTS[3]
PLAYGROUND_TOKENS = 64  # the playground's generate and generate_stream default


def _dash_session():
    import aiohttp

    # The dashboard's cookies come from 127.0.0.1: the default jar drops
    # cookies of a bare IP.
    return aiohttp.ClientSession(cookie_jar=aiohttp.CookieJar(unsafe=True))


async def _dash_login(s, base: str) -> None:
    async with s.post(base + "/login", data={"email": "admin@local", "password": "admin123", "next": "/"},
                      allow_redirects=False) as r:
        if r.status != 302 or r.headers.get("Location") != "/":
            raise AssertionError(f"dashboard login: {r.status} {r.headers.get('Location')}")


async def _dash_page(s, base: str, path: str, *marks: str) -> str:
    async with s.get(base + path) as r:
        body = await r.text()
        if r.status != 200 or not all(m in body for m in marks):
            raise AssertionError(f"GET {path}: {r.status}; missing {[m for m in marks if m not in body]}")
        return body


async def _dash_post(s, base: str, path: str, data: dict, want: int = 302) -> tuple:
    async with s.post(base + path, data=data, allow_redirects=False) as r:
        body = await r.text()
        if r.status != want:
            raise AssertionError(f"POST {path}: {r.status} (want {want}) {body[:500]}")
        return r.headers.get("Location"), body


def _pre_text(body: str, what: str) -> str:
    """The playground's result: the text inside its ``<pre>``, unescaped."""
    import html
    import re

    m = re.search(r"<h2>Result .*?</h2>\s*<pre>(.*?)</pre>", body, re.S)
    if m is None:
        raise AssertionError(f"{what}: no result on the page")
    return html.unescape(m.group(1))


def warn_oracle(plat, prompts, fused_topk_reference) -> list:
    """Each prompt's warn answer by ``fused_topk_reference`` over the index as
    it stands (the dashboard's warns carry no tools and no env): its top score
    and the ids of every rank within ATOL of it."""
    from kakveda_tpu_torch.core.fingerprint import signature_text

    gfkb = plat.gfkb
    idx, val = gfkb.featurizer.encode_batch_sparse([signature_text(p, [], {}) for p in prompts])
    q = gfkb._knn.densify(torch.as_tensor(idx, device=gfkb.device), torch.as_tensor(val, device=gfkb.device))
    rv, ri = fused_topk_reference(gfkb._emb, gfkb._valid, q, gfkb.top_k)
    rv, ri = rv.cpu().tolist(), ri.cpu().tolist()
    recs = gfkb._records
    return [(min(1.0, v[0]), {recs[i].failure_id for s_, i in zip(v, ids) if v[0] - s_ <= ATOL})
            for v, ids in zip(rv, ri)]


def hold_warn(confidence: float, failure_id, oracle: tuple, threshold: float, what: str) -> None:
    """A warn's answer (its confidence and referenced failure id, None when it
    cites none) against the oracle's: the same id, the same score."""
    top, tied = oracle
    if abs(confidence - top) > ATOL:
        raise AssertionError(f"{what}: confidence {confidence} vs the plain top-k's {top}")
    if failure_id is None:
        if top >= threshold + ATOL:
            raise AssertionError(f"{what}: no reference, yet the plain top-1 scores {top}")
    elif failure_id not in tied or top < threshold - ATOL:
        raise AssertionError(f"{what}: references {failure_id}, the plain top-k {sorted(tied)} at {top}")


def start_agent_echo(log_path: Path) -> tuple:
    """``python3 -m kakveda_tpu_torch.service.agent_echo`` on a free port, its
    output in ``log_path``: (process, its URL, ``log_path``)."""
    port = _free_port()
    repo = Path(__file__).resolve().parent
    with open(log_path, "wb") as f:
        proc = subprocess.Popen([sys.executable, "-m", "kakveda_tpu_torch.service.agent_echo", "--port", str(port)],
                                cwd=repo, env={**os.environ, "PYTHONPATH": str(repo)},
                                stdout=f, stderr=subprocess.STDOUT)
    return proc, f"http://127.0.0.1:{port}", log_path


def stop_agent_echo(echo: tuple) -> None:
    proc = echo[0]
    proc.terminate()
    try:
        proc.wait(timeout=10)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()


async def _wait_echo(s, url: str, proc, log_path: Path, timeout_s: float = 60.0) -> float:
    """Poll the echo app's ``/health`` until it answers; seconds waited."""
    import aiohttp

    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout_s:
        if proc.poll() is not None:
            raise AssertionError(f"agent_echo exited {proc.returncode}: {log_path.read_text()[-2000:]}")
        try:
            async with s.get(url + "/health") as r:
                if r.status == 200:
                    return time.perf_counter() - t0
        except aiohttp.ClientError:
            pass
        await asyncio.sleep(0.1)
    raise AssertionError(f"agent_echo not up within {timeout_s} s")


async def phase_dashboard(plat, base: Path, fused_topk, fused_topk_reference, echo: tuple, card: str) -> dict:
    """Phase 20 a and c's agent part: the dashboard mounted beside the
    service over phase 8's Platform (2^20 x 2048 bf16), through
    ``service.main.mount_dashboard`` as ``cli up --dashboard-port`` mounts
    it. Logged in as the demo admin: DASH_SCENARIOS through
    ``/scenarios/run`` (warn → generate → ingest), each warn's stored answer
    held to ``warn_oracle`` over the index as it stood at that warn; a
    dataset of DASH_EXAMPLES examples through ``/datasets/{id}/eval``, whose
    one ``warn_batch`` is held to the oracle likewise; the pages read back.
    Then the agent echo app (``echo``: ``start_agent_echo``'s child, started
    beside the build so its interpreter is up by now) registered through
    ``/api/agents/register``, its health test and a playground ``agent:``
    target."""
    import jinja2  # required: the dashboard renders its pages with it

    from kakveda_tpu_torch.core.config import ConfigStore
    from kakveda_tpu_torch.dashboard.core import CTX_KEY
    from kakveda_tpu_torch.service.main import mount_dashboard

    t_phase = time.perf_counter()
    echo, echo_url, echo_log = echo
    threshold = ConfigStore().similarity_threshold()
    out = {"jinja2": jinja2.__version__}
    port = _free_port()
    base_url = f"http://127.0.0.1:{port}"
    mark = fused_topk.launches
    runner = await mount_dashboard(plat, "127.0.0.1", port, db_path=base / "dashboard.db")
    try:
        db = runner.app[CTX_KEY].db
        model = runner.app[CTX_KEY].model
        async with _dash_session() as s:
            await _dash_login(s, base_url)
            # Scenarios: each warn held to the oracle over the index before
            # its run (the run ingests only after its warn).
            held, cited, traces = 0, [], []
            for i, (app_id, prompt) in enumerate(DASH_SCENARIOS):
                want = warn_oracle(plat, [prompt], fused_topk_reference)[0]
                loc, _ = await _dash_post(s, base_url, "/scenarios/run", {"app_id": app_id, "prompt": prompt})
                wid = int(loc.rsplit("#w-", 1)[1])
                row = db.one("SELECT confidence, failure_id FROM warning_events WHERE id=?", (wid,))
                hold_warn(row["confidence"], row["failure_id"], want, threshold, f"phase 20 a scenario {i}")
                held += 1
                if row["failure_id"]:
                    cited.append(row["failure_id"])
            runs = db.query("SELECT trace_id FROM scenario_runs ORDER BY id")
            if len(runs) != len(DASH_SCENARIOS) or not cited:
                raise AssertionError(f"phase 20 a: {len(runs)} scenario runs, {len(cited)} cited a failure")
            # A dataset and its eval: one warn_batch, one generate_batch, one
            # ingest_batch. The warn_batch's answers, recorded at the call.
            await _dash_post(s, base_url, "/datasets/create", {"name": "phase20", "description": "smoke"})
            ds = db.one("SELECT id FROM datasets WHERE name=?", ("phase20",))["id"]
            prompts = [f"Summarize report {61 * i + 5} and include citations" if i % 2 else
                       f"Explain change {i} to the billing job" for i in range(DASH_EXAMPLES)]
            for i, p in enumerate(prompts):
                await _dash_post(s, base_url, f"/datasets/{ds}/examples", {"app_id": f"eval-{i % 4}", "prompt": p})
            want = warn_oracle(plat, prompts, fused_topk_reference)
            seen = []
            real = plat.warn_batch

            def recording(reqs):
                res = real(reqs)
                seen.append(([r.prompt for r in reqs], res))
                return res

            plat.warn_batch = recording
            try:
                n0 = plat.gfkb.count
                loc, _ = await _dash_post(s, base_url, f"/datasets/{ds}/eval", {})
            finally:
                del plat.warn_batch
            if len(seen) != 1 or seen[0][0] != prompts:
                raise AssertionError(f"phase 20 a eval: {len(seen)} warn_batch calls")
            for j, (r, w) in enumerate(zip(seen[0][1], want)):
                hold_warn(r.confidence, r.references[0].failure_id if r.references else None, w, threshold,
                          f"phase 20 a eval example {j}")
            ev = await _dash_page(s, base_url, loc, "pass rate", "p50")
            run = db.one("SELECT total, passed, status FROM evaluation_runs WHERE id=?", (int(loc.rsplit("/", 1)[1]),))
            n_res = db.one("SELECT COUNT(*) AS n FROM evaluation_results WHERE eval_run_id=?",
                           (int(loc.rsplit("/", 1)[1]),))["n"]
            if run["total"] != DASH_EXAMPLES or run["status"] != "done" or n_res != DASH_EXAMPLES:
                raise AssertionError(f"phase 20 a eval: {dict(run)}, {n_res} results")
            # The pages a user reads, from the rows just written.
            trace = runs[0]["trace_id"]
            await _dash_page(s, base_url, "/", "Failure intelligence overview")
            await _dash_page(s, base_url, "/warnings", 'id="tile-total"', DASH_SCENARIOS[0][0])
            await _dash_page(s, base_url, "/runs", "app-A")
            await _dash_page(s, base_url, f"/runs/{trace}", "scenario.run", "warn_policy.call", "ingestion.ingest")
            await _dash_page(s, base_url, f"/failures/{cited[0]}", cited[0])
            await _dash_page(s, base_url, "/health-page?app_id=app-A", "app-A")
            await _dash_page(s, base_url, "/admin/audit", "scenario.run", "eval.run")
            out["a"] = dict(scenarios=held, cited=len(cited), eval_examples=DASH_EXAMPLES,
                            eval_passed=run["passed"], eval_ingested=plat.gfkb.count - n0,
                            launches=fused_topk.launches - mark, runtime=getattr(model, "name", None),
                            eval_page_bytes=len(ev), wall_s=time.perf_counter() - t_phase)
            if out["a"]["launches"] <= 0:
                raise AssertionError("phase 20 a: the dashboard's warns never launched fused_topk")
            log(f"phase 20 a: the dashboard beside the service over phase 8's Platform ({plat.gfkb.count} rows of "
                f"{plat.gfkb._knn.capacity} x {plat.gfkb._emb.shape[1]} {str(plat.gfkb._emb.dtype)[6:]}), jinja2 {jinja2.__version__}, runtime {out['a']['runtime']}: {held} scenario "
                f"warns (warn -> generate -> ingest), {len(cited)} citing a failure, and a {DASH_EXAMPLES}-example "
                f"eval's warn_batch == fused_topk_reference's answers over the index at each warn; eval {run['passed']}"
                f"/{run['total']} passed, {out['a']['eval_ingested']} rows ingested; 7 pages read back; "
                f"fused_topk launches of the dashboard's requests: {out['a']['launches']} [{card}]")
            # c, the agent echo app: registered, tested, invoked.
            t_c = time.perf_counter()
            waited = await _wait_echo(s, echo_url, echo, echo_log)
            async with s.post(base_url + "/api/agents/register", json={"name": "echo", "base_url": echo_url}) as r:
                if r.status != 200 or not (await r.json())["ok"]:
                    raise AssertionError(f"agent register: {r.status}")
            await _dash_page(s, base_url, "/admin/agents/echo/test", "Test: echo", "200 —", "healthy")
            _, body = await _dash_post(s, base_url, "/playground/run",
                                       {"prompt": "phase 20 echo", "target": "agent:echo"}, want=200)
            events = json.loads(_pre_text(body, "playground agent:echo"))
            if not (len(events) == 1 and events[0]["event_type"] == "echo"
                    and events[0]["payload"]["received_payload"] == {"prompt": "phase 20 echo"}):
                raise AssertionError(f"phase 20 c: the echo answered {events}")
            out["c_agent"] = dict(echo_waited_s=waited, wall_s=time.perf_counter() - t_c)
            log(f"phase 20 c: agent_echo (a child; {waited:.2f} s waited for its /health) registered through "
                f"/api/agents/register; /admin/agents/echo/test answered 200 healthy; the playground's agent:echo "
                f"target returned the echo of the prompt [{card}]")
    finally:
        await runner.cleanup()
        del runner
    return out


def live_answers(gfkb) -> dict:
    """Each live row's warn answer: its signature's top-1 score and the ids
    within ATOL of it (``match_batch``, 64 a call)."""
    tomb = gfkb._tombstoned  # slot -> reason
    sigs = [r.signature_text for slot, r in enumerate(gfkb.list_failures()) if slot not in tomb]
    out = {}
    for lo in range(0, len(sigs), 64):
        for sig, m in zip(sigs[lo : lo + 64], gfkb.match_batch(sigs[lo : lo + 64])):
            out[sig] = (m[0].score, {x.failure_id for x in m if m[0].score - x.score <= ATOL})
    return out


def _cli_in_process(argv) -> tuple:
    """``kakveda_tpu_torch.cli.main.main(argv)`` here, its stdout captured:
    (rc, stdout)."""
    import io

    from kakveda_tpu_torch.cli.main import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(list(argv))
    return rc, buf.getvalue()


def phase_cli(base: Path, before: dict, card: str) -> dict:
    """Phase 20 c's CLI part, after phase 8's Platform is closed, on the data
    dir phase 20 a wrote (``base/service``, as ``--dir base/cli``'s
    ``data``): ``status``, ``compact`` on the card (its GFKB's capacity the
    next power of two over the rows), every live row's warn answer after it
    against ``before`` (taken on phase 8's Platform), ``status`` again,
    ``doctor``, which must name the card."""
    from kakveda_tpu_torch.index.gfkb import GFKB

    t0 = time.perf_counter()
    root = base / "cli"
    root.mkdir()
    (root / "data").symlink_to(base / "service", target_is_directory=True)
    rc, text = _cli_in_process(["status", "--dir", str(root)])
    st0 = json.loads(text)
    if rc != 0 or not st0["exists"] or st0["failures"] < len(before) or st0["server"]["running"]:
        raise AssertionError(f"cli status: rc {rc}, {text[:500]}")
    cap = max(1 << 14, 1 << (len(before) - 1).bit_length())
    rc, text = _cli_in_process(["compact", "--dir", str(root), "--capacity", str(cap), "--dim", str(DIM)])
    comp = json.loads(text[text.index("{"):])
    if rc != 0 or not comp["compact"].get("compacted"):
        raise AssertionError(f"cli compact: rc {rc}, {text[-1000:]}")
    kb = GFKB(data_dir=root / "data", capacity=cap, dim=DIM)
    try:
        if kb.device.type != "cuda":
            raise AssertionError(f"the compacted GFKB reopened on {kb.device}")
        after = live_answers(kb)
    finally:
        kb.close()
        del kb
        torch.cuda.empty_cache()
    if after.keys() != before.keys():
        raise AssertionError(f"compact: {len(after)} live rows after, {len(before)} before")
    for sig, (score, tied) in before.items():
        score2, tied2 = after[sig]
        if abs(score - score2) > ATOL or not (tied & tied2):
            raise AssertionError(f"compact changed the warn answer of {sig!r}: {score} {sorted(tied)} -> "
                                 f"{score2} {sorted(tied2)}")
    rc, text = _cli_in_process(["status", "--dir", str(root)])
    st1 = json.loads(text)
    if rc != 0 or st1["durability"]["compact_generation"] < 1:
        raise AssertionError(f"cli status after compact: {text[:500]}")
    held_env = os.environ.get("KAKVEDA_DATA_DIR")
    os.environ["KAKVEDA_DATA_DIR"] = str(root / "data")  # doctor's writable probe lands in the temp dir
    try:
        rc, doctor = _cli_in_process(["doctor", "--dir", str(root)])
    finally:
        if held_env is None:
            os.environ.pop("KAKVEDA_DATA_DIR", None)
        else:
            os.environ["KAKVEDA_DATA_DIR"] = held_env
    name = torch.cuda.get_device_name(0)
    if rc != 0 or f"[ok] cuda: {name}" not in doctor or "[ok] kernel build:" not in doctor:
        raise AssertionError(f"cli doctor: rc {rc}\n{doctor}")
    out = dict(rows=len(before), capacity=cap, compact=comp["compact"], replay_estimate_s=comp["replay_estimate_s"],
               status_failures=st0["failures"], wall_s=time.perf_counter() - t0)
    log(f"phase 20 c: cli status ({st0['failures']} failure lines), compact on the card (capacity {cap}: "
        f"{comp['compact']['bytes_before']} -> {comp['compact']['bytes_after']} log bytes, generation "
        f"{comp['compact']['generation']}; replay estimate {comp['replay_estimate_s']}), every one of "
        f"{len(before)} live rows' warn answers equal after it, status again, doctor naming {name} "
        f"({out['wall_s']:.1f} s) [{card}]")
    for line in doctor.splitlines():
        log("  doctor " + line)
    return out


async def phase_playground(rt, card: str) -> dict:
    """Phase 20 b: a dashboard over phase 6's ``LlamaRuntime`` (Llama-3-8B
    width, LLAMA3_LAYERS layers, bf16) and a small Platform on the card. One
    ``/playground/run`` and one ``/playground/stream`` of PLAYGROUND_PROMPT
    at once, the bf16 flash launches counted over them; the run's text must
    equal ``rt.generate`` (greedy) of the same prompt, and the stream's
    deltas, joined, that text, or their tokens depart from generate's at a
    near-tie (phase 6's ``margin_rule``: whether the two requests share a
    chunk depends on timing, and bf16 sums over another batch shape may
    flip a solo margin under MARGIN_TOL); ``/admin/serving`` shows the
    engine."""
    from kakveda_tpu_torch.platform import Platform
    from kakveda_tpu_torch.service.main import mount_dashboard

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="kakveda-playground-") as d:
        plat = Platform(data_dir=Path(d) / "data", capacity=1024, dim=DIM)
        if plat.device.type != "cuda":
            raise AssertionError(f"phase 20 b: Platform on {plat.device}")
        port = _free_port()
        base_url = f"http://127.0.0.1:{port}"
        runner = await mount_dashboard(plat, "127.0.0.1", port, db_path=Path(d) / "dash.db", model=rt)
        try:
            async with _dash_session() as s:
                await _dash_login(s, base_url)

                async def stream():
                    deltas = []
                    async with s.post(base_url + "/playground/stream",
                                      data={"prompt": PLAYGROUND_PROMPT, "target": "model"}) as r:
                        if r.status != 200:
                            raise AssertionError(f"/playground/stream: {r.status}")
                        async for raw in r.content:
                            line = raw.decode().strip()
                            if line.startswith("data: "):
                                ev = json.loads(line[6:])
                                if "error" in ev:
                                    raise AssertionError(f"/playground/stream: {ev}")
                                if "delta" in ev:
                                    deltas.append(ev["delta"])
                    return deltas

                tok = rt.tokenizer
                n0 = len(tok.decoded)
                mark = launch_counts()  # deltas: the run's zeroed counters keep their meaning
                page, deltas = await asyncio.gather(
                    _dash_post(s, base_url, "/playground/run", {"prompt": PLAYGROUND_PROMPT, "target": "model"},
                               want=200),
                    stream())
                launches = {k: v - mark[k] for k, v in launch_counts().items()}
                n1 = len(tok.decoded)
                text = _pre_text(page[1], "playground run")
                ref = (await asyncio.get_running_loop().run_in_executor(None, rt.generate, PLAYGROUND_PROMPT)).text
                ref_ids = _decoded_ids(tok, tok.decoded[n1:], ref, "rt.generate")
                departures = {}
                for what, got in (("run", text), ("stream", "".join(deltas))):
                    if got != ref:  # raises unless the tokens part at a near-tie
                        departures[what] = margin_rule(
                            rt.params, rt.cfg, tok, rt._encode(PLAYGROUND_PROMPT), ref_ids,
                            _decoded_ids(tok, tok.decoded[n0:n1], got, f"/playground/{what}"),
                            f"phase 20 b /playground/{what}", PLAYGROUND_TOKENS)
                serving = await _dash_page(s, base_url, "/admin/serving", "slots ×", "submitted / completed")
            if launches["bf16"] <= 0 or launches["int8"] or launches["f32"] or launches["grouped"]:
                raise AssertionError(f"phase 20 b: launches {launches}")
        finally:
            await runner.cleanup()
            del runner
            plat.close()
            del plat
            rt.close()  # the engine the requests built: its loop thread would keep the weights on the card
    _forget_apps()
    out = dict(chars=len(ref), deltas=len(deltas), launches=launches["bf16"], serving_page_bytes=len(serving),
               near_tie_departures=departures, wall_s=time.perf_counter() - t0)
    held = "; ".join(f"/playground/{w} departs from it at a near-tie (solo margin {m:.4f})"
                     for w, m in departures.items()) or "both equal it"
    log(f"phase 20 b: a dashboard over phase 6's Llama-3-8B ({rt.cfg.n_layers} layers, bf16): /playground/run "
        f"and /playground/stream ({len(deltas)} deltas) at once, held to rt.generate's text ({len(ref)} chars): "
        f"{held}; /admin/serving shows the engine; bf16 flash launches of the two requests: {launches['bf16']} "
        f"({out['wall_s']:.1f} s) [{card}]")
    return out


def _decoded_ids(tok, entries, text: str, what: str) -> list:
    """The longest of ``entries`` (ids a ``RecordingTokenizer`` decoded)
    that decodes to ``text``: the tokens behind a finished generation."""
    hits = [e for e in entries if tok._tok.decode(e) == text]
    if not hits:
        raise AssertionError(f"phase 20 b: no decode of {what}'s tokens gives its text")
    return max(hits, key=len)


def phase_dashboard_alone(base: Path, fused_topk, fused_topk_reference, echo: tuple, card: str) -> dict:
    """``--phases 20`` without 8: phase 8 a's Platform and ingest (8 x 512
    traces), then 20 a and 20 c."""
    from kakveda_tpu_torch.core.schemas import TracePayload
    from kakveda_tpu_torch.platform import Platform

    plat = Platform(data_dir=base / "service", capacity=ROWS, dim=DIM)
    for lo in range(0, 4096, 512):
        asyncio.run(plat.ingest_batch(_service_traces(TracePayload, lo, 512)))
    out = asyncio.run(phase_dashboard(plat, base, fused_topk, fused_topk_reference, echo, card))
    before = live_answers(plat.gfkb)
    plat.close()
    del plat
    _forget_apps()
    out["c_cli"] = phase_cli(base, before, card)
    return out


def playground_alone(card: str) -> dict:
    """``--phases 20`` without 6: phase 6's runtime (its config, seed and
    tokenizer), then 20 b."""
    from kakveda_tpu_torch.models.generate import LlamaRuntime
    from kakveda_tpu_torch.models.llama import LlamaConfig

    cfg = dataclasses.replace(LlamaConfig.llama3_8b(), n_layers=LLAMA3_LAYERS)
    rt = LlamaRuntime(cfg=cfg, seed=0, tokenizer=RecordingTokenizer())
    try:
        rt.generate(PROMPTS[0], max_tokens=8)  # the engine built, as phase 6 leaves it
        return asyncio.run(phase_playground(rt, card))
    finally:
        rt.close()
        del rt
        log_held("phase 20 b")


def phase20_wall(dash: dict, play: dict, card: str) -> float:
    wall = dash["a"]["wall_s"] + dash["c_agent"]["wall_s"] + dash["c_cli"]["wall_s"] + play["wall_s"]
    log(f"phase 20 wall: {wall:.1f} s (a {dash['a']['wall_s']:.1f}, b {play['wall_s']:.1f}, c "
        f"{dash['c_agent']['wall_s'] + dash['c_cli']['wall_s']:.1f}; its limit {PHASE20_WALL_S:g}) [{card}]")
    if wall > PHASE20_WALL_S:
        raise AssertionError(f"phase 20 took {wall:.1f} s, past its {PHASE20_WALL_S:g} s")
    return wall


def log_held(after: str) -> None:
    gc.collect()
    torch.cuda.empty_cache()
    log(f"device memory still allocated after {after}: {torch.cuda.memory_allocated()} bytes")


# The phases in the order a whole run takes them; ``--phases`` picks some
# (the build, 1-2, always runs). Each id names the group its lap times.
PHASE_ORDER = ("3", "4", "7", "8", "18", "19", "12", "11", "5", "6", "10", "9", "14", "16", "20")


def _phases_arg(argv) -> tuple:
    """``--phases 19,18`` → the chosen ids in run order; none → all."""
    if not argv:
        return PHASE_ORDER
    if len(argv) != 2 or argv[0] != "--phases":
        raise SystemExit(f"usage: chip_smoke.py [--phases ID,ID,...] (ids: {','.join(PHASE_ORDER)})")
    want = {x.strip() for x in argv[1].split(",") if x.strip()}
    if not want or want - set(PHASE_ORDER):
        raise SystemExit(f"unknown phases {sorted(want - set(PHASE_ORDER))}; ids: {','.join(PHASE_ORDER)}")
    return tuple(p for p in PHASE_ORDER if p in want)


def main() -> int:
    if len(sys.argv) == 5 and sys.argv[1] == "--sticky-child":
        return sticky_child(Path(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]))
    phases = _phases_arg(sys.argv[1:])
    every = phases == PHASE_ORDER
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    # The whole run on the native host tier: no silent Python fallback.
    os.environ["KAKVEDA_NATIVE"] = "require"
    # Phase 12 c's probe: one try a second, so a disarmed drill unlatches
    # within 2 s. The latch is process-global and built at first use.
    os.environ["KAKVEDA_DEGRADED_PROBE"] = "1"
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} on {name}; phases {','.join(phases)}")

    t0 = time.perf_counter()
    # Phase 20 c's agent echo app, a child process: its interpreter starts
    # beside the build, and it idles until phase 20 calls it.
    echo_dir = tempfile.TemporaryDirectory(prefix="kakveda-echo-") if "20" in phases else None
    echo = start_agent_echo(Path(echo_dir.name) / "agent_echo.log") if echo_dir else None
    try:
        return _main(phases, every, card, name, t0, echo)
    finally:
        if echo is not None:
            stop_agent_echo(echo)
            echo_dir.cleanup()


def _main(phases, every: bool, card: str, name: str, t0: float, echo: Optional[tuple]) -> int:
    """``main`` from the build on; ``echo``: phase 20's agent echo child."""
    from kakveda_tpu_torch import native
    from kakveda_tpu_torch.ops import _build
    from kakveda_tpu_torch.ops.fused_topk import fused_topk, fused_topk_reference

    t_lap = t0
    walls = {}

    def lap(name: str) -> None:
        """The wall since the last lap, under ``name`` (printed at the end)."""
        nonlocal t_lap
        now = time.perf_counter()
        walls[name] = round(now - t_lap, 1)
        t_lap = now

    names = _build.targets()
    g_plus = threading.Thread(target=native.load)  # g++ beside the nvcc builds
    g_plus.start()
    libs = _build.build(names)
    g_plus.join()
    log(f"built {names} in {time.perf_counter() - t0:.2f} s")
    if native.load() is None:
        raise AssertionError("KAKVEDA_NATIVE=require, yet the native library did not load")
    log("native host tier: " + json.dumps(native.status()) + " (featurizer and GFKB logs run on it)")
    for lib in libs.values():
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "entry function" in line or "registers" in line or "spill" in line:
                log("  ptxas: " + line.strip())
    topk_lib = _build.load("fused_topk")
    for width in (8, 16, 32, 64):
        log(f"  fused_topk at wgmma N={width}: {topk_lib.kkv_fused_topk_stages(width)} ring stages, "
            f"{topk_lib.kkv_fused_topk_smem_bytes(width)} bytes of dynamic shared memory")
    lap("1-2 build")
    done = {}  # each phase's result

    if "3" in phases:
        done["3"] = phase_kernels(fused_topk, fused_topk_reference, card)
        torch.cuda.empty_cache()
        lap("3 fused_topk")

    if "4" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-smoke-") as d:
            count_mining_calls()
            fused_topk.launches = 0
            MINING_CALLS.update(dict.fromkeys(MINING_CALLS, 0))
            phase_platform(Path(d) / "data", fused_topk, fused_topk_reference, card)
            done["4"] = fused_topk.launches
        if done["4"] <= 0:
            raise AssertionError("the main path never launched fused_topk")
        log(f"fused_topk launches on the main path: {done['4']}")
        check_healthy("phase 4")
        log_held("phase 4")  # the 2^20 x 2048 index should be gone; the models need the room
        lap("4 platform")

    if "7" in phases:
        phase_mining(card)
        log_held("phase 7")
        lap("7 mining")

    # Phase 20 rides on phases 8 (a, c) and 6 (b) when they run; alone,
    # it builds what they would have (its lap, at the end, times that).
    if "8" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-service-") as d:
            done["8"] = phase_service(Path(d), fused_topk, card, echo=echo)
        if done["8"]["launches_service"] <= 0:
            raise AssertionError("the service path never launched fused_topk")
        log(f"fused_topk launches of the service's requests (phase 8 a-e): {done['8']['launches_service']}")
        check_healthy("phase 8")
        log_held("phase 8")
        lap("8, 17 a-d, 17 f, 20 a, 20 c service" if "20" in phases else "8, 17 a-d, 17 f service")

    if "18" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-fleet-") as d:
            done["18"] = phase_fleet(Path(d), card)
        check_healthy("phase 18")
        lap("18 fleet")

    if "19" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-elastic-") as d:
            done["19"] = phase_elastic(Path(d), fused_topk, card)
        check_healthy("phase 19")
        log_held("phase 19")
        lap("19 elastic, traffic")

    # Phase 11's crash sweep and phase 12 d's child process start here, after
    # phase 19 (whose memory and latency readings they would disturb), and
    # run beside phase 12's build, recall, aging and compaction: phase 12
    # joins both before its first timed stage (b's p50s, c's drill).
    sticky: dict = {}
    sticky_dir = sticky_runner = sweep = None
    if "12" in phases:
        sticky_dir = tempfile.TemporaryDirectory(prefix="kakveda-sticky-")
        sticky_runner = threading.Thread(target=_run_sticky_child, args=(Path(sticky_dir.name) / "sticky", sticky),
                                         name="sticky-child")
        sticky_runner.start()
    if "11" in phases:
        sweep = start_crash_sweep()
    if "12" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-tiers-") as d:
            fused_topk.launches = 0
            phase_tiers(Path(d), fused_topk, fused_topk_reference, card, sticky, sticky_runner,
                        beside=() if sweep is None else (sweep[0],))
            done["12"] = fused_topk.launches
        sticky_dir.cleanup()
        if done["12"] <= 0:
            raise AssertionError("phase 12 never launched fused_topk")
        log(f"fused_topk launches of phase 12 (the hot tier under every healthy warn): {done['12']}")
        check_healthy("phase 12")
        log_held("phase 12")
        lap("12 tiers")

    if "11" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-restart-") as d:
            fused_topk.launches = 0
            phase_restart(Path(d), fused_topk_reference, card, sweep)
            done["11"] = fused_topk.launches
        if done["11"] <= 0:
            raise AssertionError("the restart phase never launched fused_topk")
        log(f"fused_topk launches of phase 11: {done['11']}")
        check_healthy("phase 11")
        log_held("phase 11")
        lap("11 restart")

    zero_launches()  # gqa_grouped stays 0 through every bf16 phase, until phase 16 b
    if "5" in phases:
        done["5"] = dict(flash=phase_flash(card), families=phase_flash_families(card), spec=phase_flash_spec(card),
                      f32=phase_flash_f32(card))
        lap("5 flash")
    held = torch.cuda.memory_allocated()
    if "6" in phases:
        done["6"] = phase_model(card, playground="20" in phases)
        log_held("phase 6")
        lap("6, 13, 15, 17 e, 20 b model" if "20" in phases else "6, 13, 15, 17 e model")
        if torch.cuda.memory_allocated() > held + 0.5e9:  # phases 10 and 9 need phase 6's 16 GB back
            raise AssertionError(f"phase 6 left {torch.cuda.memory_allocated() - held} bytes allocated")
    if "10" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-judge-") as d:
            done["10"] = phase_judge(Path(d), fused_topk, card)
        log_held("phase 10")
        if torch.cuda.memory_allocated() > held + 0.5e9:  # phase 9 needs the card back
            raise AssertionError(f"phase 10 left {torch.cuda.memory_allocated() - held} bytes allocated")
        lap("10 judge")
    if "9" in phases:
        done["9"] = phase_mixtral(card)
        lap("9 mixtral")
    if "14" in phases:
        done["14"] = phase_families(card)
        log_held("phase 14")
        lap("14 families")
    if launch_counts()["grouped"]:
        raise AssertionError(f"gqa_grouped ran {launch_counts()['grouped']} times in the bf16 phases 5, 6, 9, 10, "
                             "13, 14, 15")
    if "16" in phases:
        with tempfile.TemporaryDirectory(prefix="kakveda-gaps-") as d:
            done["16"] = phase_gaps(Path(d), card)
        log_held("phase 16")
        lap("16 gaps")
    if "20" in phases:
        if "8" in phases:
            dash = done["8"]["dashboard"]
        else:
            with tempfile.TemporaryDirectory(prefix="kakveda-dashboard-") as d:
                dash = phase_dashboard_alone(Path(d), fused_topk, fused_topk_reference, echo, card)
            log_held("phase 20 a, c")
        if "6" in phases:
            play = done["6"]["playground"]
        else:
            play = playground_alone(card)
        done["20"] = dict(dashboard=dash, playground=play, wall_s=phase20_wall(dash, play, card))
        check_healthy("phase 20")
        lap("20 application layer (alone)" if not {"6", "8"} <= set(phases) else "20 (its parts ran in 8 and 6)")
    log(f"phase walls (s): {json.dumps(walls)}; {time.perf_counter() - t0:.1f} s in all [{card}]")
    # No warn served from the host and no latch outside the device-loss drills
    # (phase 19 a's storm, phase 12 c).
    check_healthy("the last phase")
    if not every:
        print(card, flush=True)
        print(json.dumps({"ok": True, "phases": list(phases), "device": {"platform": "gpu", "kind": name,
                                                                         "count": torch.cuda.device_count()}}),
              flush=True)
        return 0

    row, service, fleet, elastic = done["3"], done["8"], done["18"], done["19"]
    flash, flash_families, flash_spec, flash_f32 = (done["5"][k] for k in ("flash", "families", "spec", "f32"))
    model, judge, mixtral, families, gaps = done["6"], done["10"], done["9"], done["14"], done["16"]
    kernels = [dict(
        name="fused_topk", route="cuda", source="kakveda_tpu_torch/csrc/fused_topk.cu",
        replaces="kakveda_tpu/ops/pallas_knn.py:128", launches=done["4"],
        launches_service=service["launches_service"], launches_service_c64=service["warn_c64_launches"],
        launches_restart=done["11"], launches_tiers=done["12"],
        max_abs_err=row["max_abs_err"], ms=row["ms"], plain_ms=row["plain_ms"],
        bound_ms=row["bound_ms"], bound_by=row["bound_by"], library_ms=row["library_ms"],
        shape="B=1, k=5", b64=dict(shape="B=64, k=5", **row["b64"]),
    )]
    for kname, tag in (("flash_gqa_cache", "bf16"), ("flash_gqa_cache_kv8", "int8")):
        r = flash[kname]
        kernels.append(dict(
            name=kname, route="cuda", source="kakveda_tpu_torch/csrc/flash_gqa_cache.cu",
            replaces="kakveda_tpu/models/attention.py:284", launches=model[tag]["launches"],
            **({"launches_stream": model["lifecycle"]["a"]["launches"]} if tag == "bf16" else
               {"launches_supervisor": model["lifecycle"]["d"]["launches"]}),
            launches_mixtral=mixtral[tag]["launches"],
            launches_judge=judge["judge_launches"] if tag == "bf16" else None,
            launches_judge_solo=judge["arm_b_launches"] if tag == "bf16" else None,
            launches_judge_admissions=judge["admission_launches"][tag],
            launches_gemma2=families[tag]["launches"],
            **({"launches_gemma2_long_prompt": families["long_prompt"]["launches"],
                "launches_loader": {f: v["launches"] for f, v in families["loader"].items()}}
               if tag == "bf16" else {}),
            launches_spec=model["spec"][tag]["launches_spec"],
            **({"launches_spec_solo": [s["launches"] for s in model["spec"]["solo"]],
                "launches_default_preset": {k: model["spec"]["default_preset"][k]["launches"]
                                            for k in ("k0", f"k{SPEC_K}", "gate_k0", f"gate_k{SPEC_K}")},
                "launches_default_preset_judge": model["spec"]["default_preset"]["judge"]["launches"]}
               if tag == "bf16" else {}),
            judge_shapes=r["judge_shapes"], family_shapes=flash_families[kname], spec_shapes=flash_spec[kname],
            max_abs_err=max([r["max_abs_err"]] + [x["max_abs_err"] for x in flash_spec[kname].values()]),
            ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
            bound_seen_ms=r["bound_seen_ms"],
        ))
    f32_main = flash_f32["D128_f32_decode_engine"]  # the main path's most frequent f32 shape
    kernels.append(dict(
        name="flash_gqa_cache_f32", route="cuda", source="kakveda_tpu_torch/csrc/flash_gqa_cache_f32.cu",
        replaces="kakveda_tpu/models/attention.py:284", launches=gaps["a"]["k0"]["launches"],
        launches_spec=gaps["a"][f"k{SPEC_K}"]["launches"], launches_tiny=gaps["a"]["tiny"]["k0"]["launches"],
        max_abs_err=max(r["max_abs_err"] for r in flash_f32.values()),
        ms=f32_main["ms"], plain_ms=f32_main["plain_ms"], bound_ms=f32_main["bound_ms"],
        bound_by=f32_main["bound_by"], library_ms=f32_main["library_ms"], bound_all_ms=f32_main["bound_all_ms"],
        shape=f32_main["shape"], f32_shapes=flash_f32,
    ))
    kernels[0]["launches_judge_warn"] = judge["warn_fused_topk_launches"]
    kernels[0]["launches_request_plane"] = service["launches_request_plane"]
    # Phase 18's replicas, each its own process: its own fused_topk.launches
    # across a's warn arms, c's scatter-gather warns and c's rebalance flood.
    kernels[0]["launches_fleet"] = fleet["legacy"]["launches_a"]
    kernels[0]["launches_fleet_sharded"] = fleet["sharded"]["launches_scatter"]
    kernels[0]["launches_fleet_rebalance"] = fleet["sharded"]["launches_rebalance"]
    kernels[1]["launches_ladder"] = model["ladder"]["steps"]["launches"]
    # Phase 19: the storm's in-process Platform, the entry-point child under
    # the replayed log (its /readyz count), each elastic replica process's own.
    kernels[0]["launches_storm"] = elastic["a"]["launches"]
    kernels[0]["launches_replay"] = elastic["b"]["launches"]
    kernels[0]["launches_elastic"] = sum(elastic["c"]["launches"].values())
    kernels[0]["launches_elastic_per_replica"] = elastic["c"]["launches"]
    # Phase 20: the dashboard's own requests (a), the playground's (b).
    kernels[0]["launches_dashboard"] = done["20"]["dashboard"]["a"]["launches"]
    kernels[1]["launches_dashboard"] = done["20"]["playground"]["launches"]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
