#!/usr/bin/env python3
"""Drive the PyTorch port's LM serving and training paths, its
`MultiLayerNetwork` (the char-LSTM, the conv nets, DBN pretraining, the
solvers, the training CLI and the precision plane), its word embeddings
(Word2Vec, GloVe, ParagraphVectors), classifier serving, the serving
fleet in threads and in supervised worker processes, supervised,
checkpointed training, the sentiment pipeline (the HMM tagger, the
TreeParser, RNTN and the recursive autoencoder), KMeans and the
host-only tail (model import, determinism checks, remote storage, the
profiler, `ml`), the scaleout control plane (master, workers, the TCP
tracker, the performers), data parallelism, the LM mesh trainers
(ring attention, tensor and expert parallelism, the GPipe pipeline) and
data-parallel training across processes on one NVIDIA GPU and check
them.

    python3 chip_smoke.py            # every phase, from the repo root

Phases (any failure exits non-zero, and no result line is printed; each
phase logs its wall seconds, and a ``phases:`` line sums them up):

1. facts   — card name, device count, ``nvidia-smi`` name and power limit.
2. build   — build every CUDA kernel of the port from ``csrc/`` (one nvcc
             per source, started together); print the time and the
             ``ptxas`` register / shared-memory lines.
3. kernel  — the paged-attention kernel (split across blocks, with its
             merge) against its plain PyTorch version on the card (B=8,
             H=12, page 16, 64 pages per lane; C=1 and C=16 at K=64, the
             served widths, and C=128 at K=64 and C=64 at K=128, the wide
             prefill chunks; float32 and bfloat16, and float16 at C=1
             and C=16 (its FMA route); ragged pos/n_feed, an
             inactive lane, page straddles, shuffled physical pages; max
             abs error at fed columns <= 1e-4 / 2e-2, and each lane's
             <= 1e-4 / 1e-2 of its largest reference value), each
             timed with CUDA events against the plain version, one
             ``scaled_dot_product_attention`` call over the gathered
             history (a yardstick the port never calls) and its bound.
4. flash   — the flash-attention forward, dK/dV and dQ kernels against
             their plain versions in f32 on the same inputs (B=2, H=12;
             D 64 and 128; S 1024 and 1000; causal and not; float32,
             bfloat16 and float16; relative max error <= 1e-4 / 2e-2 /
             2e-2; each entry's route: bfloat16 on the tensor cores,
             float32, float16 and bfloat16 at D=20 on the FMA pipes), the
             tensor-core backward also against
             the plain backward with P and dS rounded to bfloat16
             (relative 5e-3), and at S=1024, D=64 causal timed against the
             plain versions, SDPA (forward; forward + backward, and the
             backward alone, for the backward pair) and their bounds, in
             bfloat16 and in float16.
5. serve   — `ContinuousLMServer` at ``gpt2_small(max_len=1024)`` width in
             bfloat16 (random weights from a numpy seed), 12 concurrent
             requests sharing a 128-token prefix; checks completion, vocab
             range, prefix hits, the chunk program, kernel launches =
             n_layers x dispatches (each program's launches counted per
             replay) and the page ledger; warmup captures JAX's program
             keys once each (``lm:paged[w1]``, ``lm:paged[w16]``,
             ``lm:page_copy``) and neither the requests nor a 24-request
             storm with prefix hits and copy-on-write builds another;
             then one request through the HTTP front (`UiServer`,
             ``POST /lm/generate``).
5b. programs — every LM program key (the 1-wide and 16-wide paged
             programs, verify and decode head, the dense and draft slot
             steps, the page copy, gather and install) at the serve
             pool's shapes: the build and two CUDA-graph replays bitwise
             their eager step, outputs and pools; ``classifier:*``
             bucket programs on both LSTM kernel routes (the cluster
             route at H 256, the wide route's grid-barrier launch at H
             1024) bitwise the eager `output`; an unwarmed pool's first
             request carries ``xla_compile`` spans with its keys; a
             poisoned dispatch builds nothing again.
6. parity  — float32 at full width: served greedy tokens against the
             argmax of the plain full-recompute forward (`_forward` with
             the plain `attention`, no kernel in it) on the card,
             teacher-forced; a near-tie (top-2 gap < 1e-3) ends the
             comparison of that request and is reported.
7. train   — `make_accum_train_step` at ``gpt2_small(max_len=1024)`` in
             bfloat16 compute with f32 masters, Adam, global batch 8 x
             1024 in 4 microbatches: 2 warm-up and 5 timed steps; checks
             finite, falling losses, f32 masters, flash launches per step
             (forward 2 x layers x accum with remat, each backward kernel
             layers x accum); float32 loss and gradients through the
             kernels against the plain-attention forward (relative 1e-3);
             then ``cli lm -preset gpt2-small`` on this repository's prose,
             its saved LM served by `UiServer` and one greedy
             ``POST /lm/generate`` checked against the plain forward.
8. lstm    — the fused LSTM scan kernel against its plain version on the
             card over T {1, 64, 200} x B {1, 32, 33} x H {8, 37, 256,
             1024}, float32, bfloat16 and float16, with and without
             residuals (relative max error of hs, cs, zs <= 1e-5 / 2e-2 /
             2e-2; float16 plans as bfloat16 does); f32
             gradients through it against autograd through the plain
             steps (relative 1e-4); at the char-LSTM shape (T 64, B 32,
             H 256) timed against the plain version, its bound and
             ``torch.nn.LSTM(80, 256)`` (cuDNN) forward over [64, 32, 80],
             in each dtype.
9. rnn     — `MultiLayerNetwork(char_lstm(compute_dtype="bfloat16"))` at
             full width (vocab 80, hidden 256), the bench_lstm recipe
             (batch 32 x 64 one-hot characters, Adam lr 0.01): 3 warm-up
             and 20 timed `fit_batch` steps, then 2 with ``accum_steps=2``;
             checks finite, falling losses, f32 masters, one kernel launch
             per layer and microbatch (with residuals); f32 loss and every
             gradient through the kernel against ``fused=False`` (the
             step-by-step scan) at relative 1e-4; `output`/`predict`
             against the plain path (one launch per call, no residuals);
             and a `save_model` / `load_model` round trip.
10. decode — the LM server's other decode modes at
             ``gpt2_small(max_len=1024)`` in bfloat16 (the serve phase's
             weights): (1) a paged pool (8 slots, page 16, chunk 16)
             speculating with the n-gram drafter (draft_len 4, verify
             width 16) and the same pool without speculation, over the
             serve phase's 12 requests and 4 whose prompts repeat a
             32-token motif, 64 new tokens each; (2) model self-drafting
             at full width, then a 2-layer float32 model whose drafts must
             all be accepted; (3) the dense slot pool over the 12
             requests, with its peak memory; (4) whole-sequence
             `generate`, batch 4 x prompt 128 + 32 tokens: greedy, top-k 1
             (every token a largest logit of its step, replayed through
             the same steps: greedy up to a bf16 tie) and top-k 40 / top-p
             0.9 (every token inside the support, replayed), n_layers
             flash launches a call; (5) `beam_search(beam_size=4)` in
             float32 over 2 prompts: the winner's score within relative
             1e-3 of its teacher-forced log-prob, and beam size 1 =
             greedy.  Greedy ids are held to the plain fp32 recompute of
             the served weights, teacher-forced: every token's fp32 logit
             within 1e-3 (float32) of the position's largest, or (bf16)
             within twice the bf16 logit error measured there by the
             plain bf16 recompute.  Paged launches = n_layers x
             dispatches at each width on every paged pool, none on the
             dense pool.
11. mln    — `MultiLayerNetwork`'s conv nets, pretraining, solvers and
             training CLI (no hand kernel on this path: float32
             convolutions by im2col and one matmul, bf16 ones and the
             pooling by cuDNN, plain ops): f32 loss and every
             gradient of `lenet_mnist` and `alexnet_cifar10(dropout=0)`
             at batch 8 on the card against the port's CPU run on the
             same weights with TF32 off (relative 1e-4); the f32 step
             time and gradient error of each other way to take the
             convolutions (cuDNN, cuDNN off, `F.unfold`), reported; the
             same two nets in bf16 compute against the port's CPU runs
             (loss within 1e-3 of the CPU's bf16 loss; gradients no
             further from the CPU's f32 gradients than twice the CPU's
             bf16 ones, in relative L2 norm); `rbm_apply` /
             `rbm_pretrain_loss` card vs CPU (1e-5); LBFGS and CG on
             `iris_mlp` over a seeded 150 x 4 three-class CSV, the
             objective at every iteration card vs CPU (relative 1e-4),
             falling, then `fit`; ``python -m deeplearning4j_tpu_torch.cli
             train | test | predict`` on that CSV (exit codes 0, training
             accuracy >= 0.9, the predictions file = the saved model's
             `predict`); `lenet_mnist(updater="sgd")` in bfloat16 at batch
             256 (the bench.py recipe: 5 warm-up and 100 timed `fit_batch`
             steps over `synthetic_mnist`; step ms, examples/s, peak
             memory, TFLOP/s by bench.py's flop count) and
             `alexnet_cifar10` bf16 at batch 128 (3 + 20 steps over
             `synthetic_cifar10`), every step's loss finite and the
             loss of the staged batches without dropout falling over the
             steps; `dbn_mnist` `fit` (1 epoch of greedy
             pretraining, then SGD) over 6000 binarized synthetic images
             at batch 100, each RBM's reconstruction error falling.
12. precision — the precision plane: the char-LSTM at full width under
             "mixed" (float32 masters, bfloat16 compute, dynamic loss
             scaling) and under float16 compute with loss scaling, 3
             warm-up and 20 timed `fit_batch` steps each (B5 once a step,
             losses finite and falling, masters f32, the scaler's
             state), then one poison batch (parameters and updater state
             bitwise unchanged, the scale halved, one overflow); the
             float16 char-LSTM's loss and gradients at batch 8 against
             the port's CPU float16 and float32 runs (slice 8's bf16
             rule); LeNet-MNIST under mixed at batch 256 over 8 staged
             batches and a ragged tail, `fit(chunk_size=8)` against the
             `fit_batch` loop (examples/s of each), host reads a chunk,
             float32 chunk 1 against 8 bitwise, mixed chunk 1 against 8
             beside chunk 1's run-to-run difference, `train_state_bytes`
             for fp32 and mixed beside the measured peak; `QuantizedNet`
             of a trained `mnist_mlp` and AlexNet-CIFAR10 through
             `output_bucketed` on the ladder (1, 8, 32) (top-1 agreement
             >= 0.99, parameter bytes >= 3.5x smaller, bucketed = the
             padded dispatch bitwise, input signatures <= buckets); and
             ``cli train -precision mixed -chunk 8`` on a seeded Iris CSV
             (exit 0, accuracy >= 0.9, the ``precision:`` lines, the CSV
             read by the native library that g++ built).
13. moe    — MoE layers: ``gpt2_small(max_len=1024)`` with 8 experts,
             top-2, capacity factor 1.25, aux weight 0.01 (~0.52 B
             parameters) under the train phase's recipe, 2 warm-up and 5
             timed steps on one batch (finite, falling losses; flash
             launches 96 / 48 / 48 a step; peak memory); the routing at
             init and after (dropped assignments and each expert's load
             by layer, the load-balancing loss); f32 loss and every
             gradient through the kernels against plain attention at
             batch 2 x 512 (relative 1e-3; expert leaves expert by
             expert, every expert that received tokens); capacity
             dispatch at cf = E against the dense-masked oracle (1e-5,
             f32); the serve phase's 12 requests on the bf16 paged pool
             and one `generate` 4 x 128 + 32 (12 flash launches), ids
             held by the greedy rule with their served routing
             (`greedy_checker`); and ``cli lm -experts 4 -moe-top-k 2``
             on this repository's prose, then ``-generate`` from the
             saved directory.
14. mobility — KV page mobility at ``gpt2_small`` in bf16 (page 16,
             chunk 16): 8 requests prefilled on one pool, framed,
             unframed and admitted on another (ms a frame: gather,
             serialize, deserialize, install; frame bytes; int8 frames
             against the exact bytes and the dequantized pages' error;
             shipped ids equal to local decode, counted), one
             ``POST /lm/prefill`` -> ``/lm/admit_pages``; a best_effort
             victim filling a 2-slot pool preempted mid-decode by an
             interactive arrival, swapped out to the host and resumed;
             the brownout ladder under a 16-request burst and back to
             healthy; a session hibernated, resumed on its pool (turn 2
             prefills only its new tokens) and resumed by a fresh server
             on the same state_dir, while a prompt cached beside it keeps
             its radix hit through the sweep, no pool resets while its
             worker runs and no dispatch fails.  Every output by the
             greedy rule, B1 launches = n_layers x dispatches by width on
             each pool, ledgers balanced.
15. nlp    — the word-embedding family (BASELINE config #3; no hand
             kernel on this path: gathers and ``index_add_``): bench.py's
             Word2Vec row as it runs offline (vector 128, window 5,
             negative 5, batch 4096 over its zipf corpus of 120 000 tokens
             and 2 000 words; a warm-up fit, then a timed fit), the same
             at negative 0 (HS), and a text8-scale row (word2vec's
             demo-word.sh settings, vector 200, window 8, negative 25,
             sample 1e-4, over a synthetic zipf corpus of 2 000 000 tokens
             and 71 290 words): words/s, pairs, steps, ms a step, host
             pair-generation seconds, peak memory; the HS and NEG steps at
             the bench's shape and one GloVe step on the card and on the
             CPU from the same inputs (duplicate rows, a saturated HS
             pair, the same negatives), each held to the float64
             recompute of the step: every touched element within gamma_n
             (|x0| + sum |d|) plus its run's own update error and one ulp
             of its row (n its row's updates; any summation order stays
             inside), the loss within gamma_N |loss| (the worst ratio of
             error to bound logged per leg; the old fixed 1e-5 card-vs-
             CPU reading recorded); whether two seeded card fits are bitwise
             equal (recorded); and on the two-topic corpus of
             tests/test_nlp.py, Word2Vec HS and NEG separating the topics,
             GloVe's losses falling and ParagraphVectors predicting each
             topic's label (HS at batch 128 and NEG at batch 512; at the
             test's HS batch 512 the outcome depends on the scatter's
             summation order and is recorded).
16. ops    — the LM server's operations plane over real HTTP on
             ``127.0.0.1``: the serve phase's model through
             `UiServer.serve_lm` (8 slots, page 16, chunk 16) with the
             tenants ``interactive`` (weight 4, SLO 250 ms) and ``batch``
             (500 tokens/s, burst 1000) and a breaker (threshold 3,
             cooldown 0.5 s): the serve phase's 12 prompts streamed from
             12 threads (SSE, tenant interactive, 64 new tokens, greedy;
             the token events make the ``done`` ids, each held by the
             greedy rule; TTFT p50 / p99 and streamed tokens/s; the share
             equal to the same requests unstreamed; B1 launches by width
             = n_layers x the run's dispatches by width, B2's counted);
             two streams closed after 4 tokens (abandoned, slots free,
             pages balanced); a flood of 16 batch requests (cost 192
             each) beside 4 interactive ones (429s with a Retry-After no
             smaller than the bucket's refill time, no interactive 429,
             admitted + throttled = sent on ``/metrics``); a chaos hook
             failing 3 dispatches (the breaker opens, a 503 with
             Retry-After, /readyz 503, a probe after the cooldown closes
             it; the /metrics gauge 0, 1, 2, 0); every ``/metrics`` line
             Prometheus text with the ``serving_lm_*`` and tenant
             families; one ``/trace/recent`` trace for every admitted
             request id (ordered spans inside the request); then ``cli
             train -metrics-port 0`` (mnist-mlp, mixed, chunks of 4)
             scraped before it stops: its step counter = the steps
             taken.
17. classify — classifier serving at the width of the repo's serving
             models: bench.py bench_serving's recipe (``mnist_mlp``
             784-2048-2048-10, float32 with TF32 off, ladder (1, 8, 16, 32),
             640 one-row requests from 16 threads) micro-batched by the
             `ServingEngine` and sequentially (requests/s, p50 / p99,
             rows a dispatch; signatures <= the ladder, each reply within
             1e-5 relative of its rows through ``net.output`` alone); the
             char-LSTM (config #4) in bf16 behind the engine on (1, 8, 32)
             without length buckets, 48 client threads of 1-8 one-hot
             sequences of T 64 (B5 launches = dispatches + the warmup's 3,
             each reply within 2e-2 of the f32 net, its argmax equal where
             the f32 top-2 gap exceeds 4e-2, fewer dispatches than
             requests); a coalesced dispatch with one request poisoned by
             `chaos_dispatch` (the others answered, one
             `InjectedDispatchFault`, ``serving_poison_isolated_total`` 1
             on /metrics) and an expired deadline answered 504; ``cli serve
             -model zoo:mnist-mlp -quantize int8 -buckets 1,8,32 -warmup``
             on the main thread, driven over HTTP (top-1 agreement with
             the float net >= 0.99 over 256 seeded rows, /metrics
             Prometheus text with the classifier families, /readyz 200,
             then 503 during the SIGTERM drain while a request held at a
             dispatch gate finishes 200).
18. fleet  — the thread-hosted fleet: bench.py bench_serving_fleet's
             recipe through a `FleetServer` (3 mnist_mlp replicas, 384
             one-row requests from 32 threads over HTTP, `chaos_fleet`
             killing replica-0 a third of the way in and replica-1's
             /readyz lying twice: failed 0, failovers counted, the client
             ledger balanced, ejection and re-admission on /fleet/stats),
             then a rolling swap to new weights under live traffic (zero
             5xx, every reply after the flip from the new weights); 2
             `both` replicas of the bf16 ``gpt2_small(max_len=1024)``
             behind the front: the serve phase's 12 prompts through POST
             /lm/generate (ids by the greedy rule, all on the affinity-
             preferred replica and its prefix hits, B1 = n_layers x the
             replicas' dispatches by width), one top-k and one beam
             request (B2 = n_layers each) and one relayed SSE stream;
             bench.py bench_disagg's topologies at that width (3 `both`
             workers, then 1 prefill + 2 decode): 8 long prompts of 272
             tokens and 16 short chats streamed from the client (TTFT p50
             / p99, tokens/s; shipped lanes counted, ids by the greedy
             rule, page ledgers balanced, B1 by width), and a kill leg
             (the prefill worker stopped mid-storm: zero failed).
19. procfleet — process-hosted fleets: 3 ``cli serve -lm`` workers of
             the bf16 ``gpt2_small(max_len=1024)`` (8 slots, page 16,
             chunk 16; the weights `numpy_params(seed=0)` saved in `cli
             lm`'s format) and one ``serve -model zoo:mnist-mlp`` worker,
             each its own process on the card (the kernels built once by
             the parent, loaded by the workers), under two
             `FleetSupervisor`s behind `FleetServer` fronts.  The 12
             prompts of the fleet phase through POST /lm/generate with a
             SIGKILL of the worker serving dispatch attempt 4 (classified
             crash, restarted after backoff, re-admitted), again with a
             SIGSTOP at attempt 2 (classified wedged, hard-killed,
             restarted), then streamed over SSE (TTFT p50 / p99,
             tokens/s) with one top-k request; 64 mnist-mlp requests
             (replies within 1e-5 of the same net in the parent); a boot
             flake repeated into crash-loop quarantine (`CrashLoopError`
             on /fleet/stats).  Zero failed client requests, submitted =
             answered + rejected, every greedy reply by the greedy rule,
             ``fleet_process_*`` on /metrics; after the stop every
             spawned process reaped and none on the card
             (``nvidia-smi --query-compute-apps``); each LM worker's
             SIGTERM drain snapshot (the port's ``kernel_launches``) has
             B1 by width = n_layers x its dispatches by width since its
             warm-up, and the workers' B2 sums to n_layers (the top-k
             request).
20. resilience — `TrainingSupervisor` over the char-LSTM at bench_lstm
             width (T 64, B 32, H 256, bf16 compute, B5 every step) on 24
             seeded batches: a stream with 2 extra NaN records, a fetch
             failure and a preemption, then a fresh net resumed from the
             emergency checkpoint on the same source — final params
             bitwise (or within 1e-6 relative per leaf, recorded) equal
             to an uninterrupted supervised run, B5 launches = LSTM
             layers x steps run; the same at chunk 4 against a chunk-4
             reference; a one-shot `InvalidScoreError` rolled back with
             lr_scale 0.5; a save killed mid-commit keeps the previous
             step, a flipped and a truncated shard refused as
             `CheckpointCorruptError` and rebuilt; checkpoint save / load
             ms; ``cli train -resilience -ckpt-every 5`` on a seeded Iris
             CSV SIGTERM'd after its first checkpoint (exit 0, an
             emergency checkpoint), then the same command resumed there
             to the end.
21. sentiment — the reference's sentiment pipeline, no hand kernel (TF32
             off): `default_tagger` on the card tags the seed corpus and
             20 held-out sentences as the CPU's does; the device Viterbi
             at T 64, S 45 (seeded emissions) gives the CPU's path, the
             log-prob within 1e-5 relative; the bundled reviews parsed
             on the card as on the CPU, RNTN's and the recursive
             autoencoder's loss and every gradient at d 16 within 1e-4
             relative of the CPU's; tests/test_quality_gates.py's RNTN
             gate (3 stratified splits, d 16, lr 0.05, 100 epochs: mean
             held-out root accuracy >= 0.6); the autoencoder's 50-epoch
             loss falling >= 10 %; RNTN at the reference's width (d 25,
             5 classes) on an SST-sized synthetic treebank (8 544
             right-branching trees of 2-50 zipf tokens, ~20 000 words,
             every node labelled): 10 epochs with finite, falling
             losses, ms an epoch, nodes/s and peak memory recorded.
22. cluster — KMeans at MNIST's shape (60 000 x 784 seeded float32
             blobs, k 10) from the same initial centres on the card and
             the CPU (TF32 off): equal n_iter, assignments equal but at
             near-ties (the two nearest squared distances within 1e-4
             relative; counted), centres within 1e-4 relative; ms a
             sweep, host reads, fit seconds and peak memory recorded;
             `PlotFiltersIterationListener` and
             `ActivationRenderListener` on a card-resident bfloat16 LeNet
             write their files (``.npy`` grids without matplotlib).
23. tail   — the host-only tail: a GPT-2-small stand-in (HF's names and
             shapes: V 50257, d 768, 12 layers, 12 heads, 1024
             positions; weights from a numpy seed, a ``SimpleNamespace``
             config) through `import_hf_gpt2` onto the card (every leaf
             bitwise against the stand-in's arrays by JAX's mapping);
             the serve phase's 12 requests from it in bf16 on the paged
             pool (B1 = n_layers x dispatches by width, ids by the
             greedy rule); 3 train steps of it at the train phase's
             recipe (finite losses, B2-B4 launches 96 / 48 / 48 a step);
             `trace()` around one served request inside an `annotate`
             span (the Chrome trace holds the span and B1's kernels);
             `device_memory_stats()` (peak >= in use, the limit = the
             card's memory); B3 and B4 twice on the same inputs
             (dK, dV, dQ equal word for word: the one hard determinism
             check); determinism reported as it is for the dense GPT-2
             step, the MoE step, the char-LSTM network (B5) and a
             Word2Vec NEG step (bitwise, or the first leaf that
             differs and its max abs diff);
             the char-LSTM's remote checkpoint and model through
             ``memory://`` bitwise; a LeNet-shaped ``nn.Sequential``
             imported with `import_torch_sequential` against the module
             on the card (TF32 off, 1e-5); an iris ``Pipeline([
             StandardScaler, NetworkClassifier])`` on the card against
             the same on the CPU (1e-4; Iris's class means and spreads,
             seeded: the chip machine has no sklearn).
24. scaleout — the scaleout control plane, 2 worker threads on the card:
             (1) `DistributedRunner.simulate` of 8 char-LSTM jobs (bf16,
             T 64, B 32, H 256, V 80; `NetworkPerformer`, iterative
             reduce, parameter averaging from a numpy tree): B5 launches
             = LSTM layers x performs, updates = jobs, each absorbed
             once, the final model bitwise equal to a single-thread
             replay of the logged assignment (or within 1e-6 relative a
             leaf, recorded) with every round's starting model equal by
             digest, the averaged model's held loss falling; the same
             under `HogwildWorkRouter(depth=2)` (counts, B5, finite); one
             f32 SGD round card vs the port's CPU (TF32 off; every leaf,
             and its step, within 1e-4 relative); tests/test_scaleout.py's
             Iris gate (accuracy > 0.9 on `iris_shaped`); (2) a
             `StateTrackerServer` with a secret on loopback, a `Master`
             and 2 `Worker`s each with its own `RemoteStateTracker`, 4
             jobs: the same checks, a client without the secret refused,
             ms a round and bytes a parameter-tree frame recorded; (3)
             `Word2VecPerformer` (HS, the bench row's settings, its zipf
             corpus in 8 jobs) and, on the two-topic corpus, Word2Vec HS
             and `GlovePerformer` at `nlp_quality`'s settings, under
             `DeltaSumAggregator`: each perform restores its replica's
             tables bitwise, each replica starts its job at the round's
             model bitwise, every round's model re-derived on the host
             from the logged deltas bitwise, finite tables; ms and MB of
             delta a job, the topic similarities recorded; (4) word
             count over the tracker = one `collections.Counter`, a
             worker killed holding a job (heartbeat timeout 1 s: it is
             the one reaped, updates = jobs), two simulates on one
             runner.
25. dp     — data parallelism, a 4-shard mesh over the one card
             (``devices=[cuda:0] * 4``): the bf16 char-LSTM (T 64, H
             256, V 80) at global batch 128, 32 rows a shard, 3 + 10
             ZeRO-1 steps, losses finite and falling, B5 = LSTM layers
             x 4 x steps; float32, dropout 0, TF32 off: ZeRO-1 and
             ``shard_update=False`` bitwise (params and moments, 5 Adam
             steps), 4 shards vs one device's `fit_batch` on the same
             batches (5 SGD steps, every leaf within 1e-4 relative;
             Adam recorded), local SGD every 4 (every replica bitwise
             after each sync round), the ZeRO-1 checkpoint resumed on 2
             and 1 shards (published trees bitwise); "mixed": a batch
             infinite on shard 0's rows only, and a finite loss with an
             inf planted in the last shard's gradient slice, each
             skipped on every shard (params and moments bitwise, the
             scale halved, one overflow); a Word2Vec HS ``mesh=`` step at batch 4096 held
             to the float64 recompute under `hs_step_bounds`; ``cli
             train -runtime spmd -replicas 1`` (exit 0, accuracy >=
             0.9); AlexNet bf16 at batch 128 on 4 shards and 1 (2 + 10
             steps, losses finite).  Recorded ("4 shards on one card"):
             ms a step vs one device, examples/s, train state a
             replica, peak memory.
26. mesh   — the LM mesh trainers, 4 shards on one card
             (``devices=[cuda:0] * 4``): `HybridParallelTrainer` at
             ``gpt2_small(max_len=1024)`` width, 4 layers deep (bf16
             compute, f32 masters, Adam, 8 x 1024) on the (data 1, seq
             2, model 2) mesh `_lm_mesh_layout` picks for 4 devices, 2 +
             3 steps at lr 3e-4 beside the one-device step on the same
             batch: losses finite and falling, flash launches a step
             B3 = B4 = L dp tp sp (sp + 1) / 2 = 24 and B2 = (1 + remat)
             times that = 48 (remat recomputes the whole block, ring
             included), the peak memory above the resident state; the
             `PipelineParallelTrainer` on (data 1, stage 4), 2
             microbatches: B2 = 2 L m = 16, B3 = B4 = 8; the moe
             phase's config, 4 layers, on (1, 2, 2), 2 steps, every
             dispatch over the global tokens at the global capacity;
             float32, TF32 off, 4 layers: one SGD step of each trainer
             at batch 2 vs the
             one-device step (loss within 1e-5 relative, each leaf's
             change within 1e-3 of its largest change) and ZeRO-1 =
             replicated bitwise on (2, 1, 2) and (2, 2) (2 layers, 3
             Adam steps); `ring_flash_attention` over 4 seq shards vs
             the one-device flash (B 2, S 1024, H 12, D 64; f32 within
             1e-4, bf16 2e-2 relative; B2 = B3 = B4 = 10 causal, 16
             not; device ms of forward + backward); ``cli lm -runtime
             hybrid|pipeline`` on the visible card (the trivial mesh)
             and ``python -m deeplearning4j_tpu_torch.dryrun 4`` GREEN.
             Recorded ("4 shards on one card"): ms a step against the
             one-device step (and the train phase's), the losses' largest
             difference from the one-device step's, tokens/s, peak
             memory, parameter bytes a shard.
27. multiproc — training across processes: 2 worker processes
             (``chip_smoke.py --multiproc-worker``, each with a
             deadline) join one gloo group through
             `initialize_multihost` (NCCL refuses two ranks on one
             card), 2 shards of card 0 each, and train the dp phase's
             bf16 char-LSTM (global batch 128, 32 rows a shard):
             ZeRO-1 and replicated 10 steps each (B5 = 1 layer x 2
             shards x 10 = 20 launches a process and leg) and local
             SGD (2 rounds of 4), every loss and leaf bitwise the same
             runs over one process's 4 shards, ZeRO-1 = replicated
             bitwise; the ZeRO-1 run's step-5 checkpoint in JAX's v1
             per-host layout (``processes`` 2), reloaded here bitwise
             and resumed at 1 process x 4 shards bitwise with the
             uninterrupted run; a save in which process 1 is killed
             after its params file (no COMMIT, process 0 fails at the
             barrier, the latest checkpoint stays step 5); a Word2Vec
             NEG ``mesh=`` fit and step, each process's and this
             process's 4-shard step within the nlp phase's a-priori
             bound; an NCCL group of one process over 4 shards (the
             collectives equal to their one-process forms, ZeRO-1
             bitwise, B5 = 40); then the LM mesh trainers by 2 gloo
             processes x 2 shards at ``gpt2_small`` width (bf16 compute,
             f32 masters, Adam, ZeRO-1, 4 x 1024, 3 steps):
             `HybridParallelTrainer` on (1, 2, 2) (the ring across the
             processes) and (2, 1, 2) at 2 layers, the moe phase's 8
             experts top-2 on (1, 1, 4) at 2 layers, and the
             `PipelineParallelTrainer` on (1, 4) at 4 layers with 4
             microbatches: losses and every exported leaf bitwise those
             of the same runs over this process's 4 shards, B2 / B3 / B4
             a step each process's own block pairs (the (1, 2, 2) ring:
             4 and 8) and summed the one process's.  Recorded: ms a
             step at 2 processes, 1 process x 4 shards, NCCL, one
             device; the LM legs' ms a step at 2 processes, 1 process x
             4 shards and one device, and the bytes each process sends
             the other a step.

Kernel times (``ms``, ``plain_ms``, ``library_ms``) are device time per
call (`device_ms`: the calls are queued behind a spin kernel, so they run
back to back without the host's time between launches); ``call_ms`` is
the CUDA-event time per call of calls made back to back from the host,
which for a fast kernel measures the host's launch path instead.

Prints the ``kernels`` JSON line, then the ``nvidia-smi`` card line, then
``{"ok": true, "device": {...}}`` as the last line.  ``--only`` runs a
subset of phases (facts and build always run), e.g. ``--only
lstm,rnn``; ``--profile`` traces the serve phase's load, the train,
rnn and mln phases' timed steps, the decode phase's speculating and
plain pools, one more fit of each nlp row, the classify phase's
char-LSTM storm, the fleet phase's LM storm and one SST-scale RNTN
epoch with ``torch.profiler`` and adds device time by kernel group and
the device's idle share to their lines.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np

KERNEL_REPLACES = "deeplearning4j_tpu/parallel/paged_kernel.py:77"
KERNEL_SOURCE = "deeplearning4j_tpu_torch/csrc/paged_attention.cu"
HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"float32": 67e12,      # fp32 outside the tensor cores
            "bfloat16": 989e12,    # bf16 dense tensor-core peak
            "float16": 989e12}     # fp16 dense tensor-core peak
PHASES = ("kernel", "flash", "serve", "programs", "parity", "train",
          "lstm", "rnn", "decode", "mln", "precision", "moe", "mobility", "nlp", "ops",
          "classify", "fleet", "procfleet", "resilience", "sentiment",
          "cluster", "tail", "scaleout", "dp", "mesh", "multiproc")
# what the times of the kernels line measure
TIMING_NOTE = {
    "ms": "device time per call: calls queued behind a spin kernel, run "
          "back to back without the host's time between launches (also "
          "kernel_ms, plain_ms, library_ms)",
    "call_ms": "CUDA events around calls made back to back from the host; "
               "for a fast kernel this is the host's launch path"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    return out[0].strip()


def cuda_ms(fn, iters: int = 100, warmup: int = 5) -> float:
    """Mean milliseconds per call of `fn` by CUDA events after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int = 50, warmup: int = 3, reps: int = 3) -> float:
    """Mean device milliseconds per call of `fn`, without the host's time
    between launches: a spin kernel (``torch.cuda._sleep``) holds the
    device while `iters` calls are queued behind it, so they then run
    back to back; CUDA events around them give the device time (kernels
    and the gaps between them).  The spin is sized from the measured
    enqueue time and checked: if the device reached the first event
    before the last call was queued, the spin was too short and the
    window is taken again with fewer calls.  Median of `reps` windows."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles_per_s = torch.cuda.get_device_properties(0).clock_rate * 1e3
    out = []
    while len(out) < reps:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int((2 * enqueue_s + 2e-3) * cycles_per_s))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        late = start.query()              # the device already got there
        torch.cuda.synchronize()
        if late and iters > 1:
            iters = max(1, iters // 2)
            enqueue_s *= 2
            continue
        out.append(start.elapsed_time(end) / iters)
    return float(np.median(out))


# ---------------------------------------------------------------------------
# phase 3: the kernel against its plain version


# (C, K) of the kernel phase: decode and the served 16-column chunk, then
# the wide prefill chunks the first design refused; float16 at the main
# shapes (decode and the 16-column chunk)
KERNEL_CASES = ((1, 64), (16, 64), (128, 64), (64, 128), (1, 384),
                (16, 512))
KERNEL_F16_CASES = ((1, 64), (16, 64))


def kernel_inputs(c: int, dtype, kd: int = 64, layers: int = 12,
                  seed: int = 0):
    """Paged-attention inputs at the served shape, one pool per layer so
    that timing loops over layers read device memory the way a dispatch
    does (the pools together exceed the 50 MB L2 cache)."""
    import torch

    b, h, ps, mp = 8, 12, 16, 64
    pages = 1 + b * mp
    rng = np.random.default_rng(seed)
    if c == 1:
        pos = np.array([0, 15, 16, 100, 511, 777, 1023, 0], np.int32)
        nf = np.array([1, 1, 1, 1, 1, 1, 1, 0], np.int32)
    else:
        # the last lane's chunk ends in the table's last page
        pos = np.array([0, 15, 16, 100, 511, 777, min(1000, mp * ps - c), 0],
                       np.int32)
        nf = np.array([c, 3, c, c // 2 - 1, c, 9, c, 0], np.int32)
    table = np.zeros((b, mp), np.int32)
    ids = rng.permutation(np.arange(1, pages)).astype(np.int32)
    live_pages = []
    for i in range(b):
        n_lp = min((int(pos[i]) + max(int(nf[i]), 1) - 1) // ps + 1, mp)
        live_pages.append(n_lp)
        if nf[i] > 0:                      # the inactive lane keeps nulls
            table[i, :n_lp] = ids[i * mp:i * mp + n_lp]
    dev = torch.device("cuda")
    q = torch.from_numpy(rng.standard_normal((layers, b, c, h, kd),
                                             np.float32)).to(dev, dtype)
    kp = torch.from_numpy(rng.standard_normal(
        (layers, pages, ps, h, kd), np.float32)).to(dev, dtype)
    vp = torch.from_numpy(rng.standard_normal(
        (layers, pages, ps, h, kd), np.float32)).to(dev, dtype)
    return {"q": q, "k": kp, "v": vp,
            "table": torch.from_numpy(table).to(dev),
            "pos": torch.from_numpy(pos).to(dev),
            "n_feed": torch.from_numpy(nf).to(dev),
            "nf_host": nf, "live_pages": live_pages,
            "shape": dict(B=b, C=c, H=h, K=kd, ps=ps, MP=mp, P=pages)}


def fed_max_err(got, want, nf) -> float:
    err = 0.0
    for i, n in enumerate(nf):
        if n:
            d = (got[i, :n].float() - want[i, :n].float()).abs().max()
            err = max(err, float(d))
    return err


def fed_lane_rel_err(got, want, nf) -> float:
    """The worst lane's max abs error at its fed columns over that lane's
    largest reference value: on a long lane the outputs are averages over
    ~1000 keys and far smaller than the absolute limit, so a dropped or
    misweighted split shows here."""
    err = 0.0
    for i, n in enumerate(nf):
        if n:
            w = want[i, :n].float()
            d = (got[i, :n].float() - w).abs().max()
            err = max(err, float(d / w.abs().max().clamp_min(1e-30)))
    return err


def kernel_case(c: int, dtype_name: str, kd: int = 64) -> dict:
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel.kernels import mask_value
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
        paged_flash_attention_plain,
        paged_split_plan,
    )

    dtype = getattr(torch, dtype_name)
    x = kernel_inputs(c, dtype, kd)
    sh = x["shape"]
    b, h, kd, ps, mp = sh["B"], sh["H"], sh["K"], sh["ps"], sh["MP"]
    layers = x["q"].shape[0]
    table, pos, nf = x["table"], x["pos"], x["n_feed"]
    got = paged_flash_attention(x["q"][0], x["k"][0], x["v"][0], table,
                                pos, nf)
    torch.cuda.synchronize()
    # the reference: the plain version in float32 on the same inputs
    want = paged_flash_attention_plain(x["q"][0].float(),
                                       x["k"][0].float(),
                                       x["v"][0].float(), table, pos, nf)
    err = fed_max_err(got, want, x["nf_host"])
    lane_rel = fed_lane_rel_err(got, want, x["nf_host"])
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    lane_rtol = 1e-4 if dtype == torch.float32 else 1e-2
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"paged kernel C={c} {dtype_name}: max abs "
                             f"err {err} > {tol}")
    if not math.isfinite(lane_rel) or lane_rel > lane_rtol:
        raise AssertionError(f"paged kernel C={c} {dtype_name}: worst lane's "
                             f"relative err {lane_rel} > {lane_rtol}")
    # one SDPA call over the gathered history with the same causal mask
    gidx = (table.long()[:, :, None] * ps
            + torch.arange(ps, device=table.device)).reshape(b, mp * ps)
    hist = [(x["k"][i].reshape(-1, h, kd)[gidx].transpose(1, 2)
             .contiguous(),
             x["v"][i].reshape(-1, h, kd)[gidx].transpose(1, 2)
             .contiguous()) for i in range(layers)]
    qh = [x["q"][i].transpose(1, 2).contiguous() for i in range(layers)]
    wpos = pos.long()[:, None] + torch.arange(c, device=pos.device)
    mask = (torch.arange(mp * ps, device=pos.device)[None, None, :]
            <= wpos[:, :, None])[:, None]                   # [B,1,C,S]
    lib_out = F.scaled_dot_product_attention(qh[0], hist[0][0], hist[0][1],
                                             attn_mask=mask)
    lib_err = fed_max_err(lib_out.transpose(1, 2), want, x["nf_host"])
    it = {"i": 0}

    def nxt():
        it["i"] = (it["i"] + 1) % layers
        return it["i"]

    def run_kernel():
        i = nxt()
        paged_flash_attention(x["q"][i], x["k"][i], x["v"][i], table, pos,
                              nf)

    def run_plain():
        i = nxt()
        paged_flash_attention_plain(x["q"][i], x["k"][i], x["v"][i], table,
                                    pos, nf)

    def run_library():
        i = nxt()
        F.scaled_dot_product_attention(qh[i], hist[i][0], hist[i][1],
                                       attn_mask=mask)

    plain_ms = cuda_ms(run_plain, iters=20)
    kernel_ms = cuda_ms(run_kernel, iters=200)
    library_ms = cuda_ms(run_library, iters=100)
    kernel_ms_2 = cuda_ms(run_kernel, iters=200)
    dev = {"kernel": device_ms(run_kernel, iters=96),
           "plain": device_ms(run_plain, iters=12),
           "library": device_ms(run_library, iters=96)}
    item = dtype.itemsize
    plan = paged_split_plan(b, c, h, kd, mp, ps, dtype,
                            torch.cuda.get_device_properties(0)
                            .multi_processor_count)
    live_keys = sum(x["live_pages"]) * ps
    nbytes = (2 * live_keys * h * kd * item          # live K and V pages
              + 2 * b * c * h * kd * item              # q in, out
              + (b * mp + 2 * b) * 4)                  # table, pos, n_feed
    ops = 4 * c * live_keys * h * kd                   # QK^T and PV
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return {"C": c, "dtype": dtype_name, "shape": sh,
            "max_abs_err": err, "tolerance": tol,
            "lane_rel_err": lane_rel, "lane_rel_tolerance": lane_rtol,
            "kernel_ms": dev["kernel"], "plain_ms": dev["plain"],
            "library_ms": dev["library"],
            "call_ms": min(kernel_ms, kernel_ms_2),
            "call_ms_runs": [kernel_ms, kernel_ms_2],
            "plain_call_ms": plain_ms, "library_call_ms": library_ms,
            "library_max_abs_err": lib_err,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops, "split_plan": plan,
            "route": "tensor_cores" if plan["cols"] >= 16 else "fma"}


def paged_route_names() -> dict:
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        MAX_MMA_HEAD_DIM,
    )

    return {"bfloat16": {
        "C=1": "fma (vectorised warp dot products)",
        "C>1": f"tensor_cores (mma.sync m16n8k16, 16 columns a block) up "
               f"to K={MAX_MMA_HEAD_DIM}, fma (4 columns a block) above"},
        "float32": "fma",
        "float16": "fma (vectorised warp dot products; 1 column a block at "
                   "C=1, 4 above)"}


def dtype_summary(case: dict, timing: dict = None) -> dict:
    """A kernel's keys for one dtype's case: route, device ms, plain and
    library ms, bound, error."""
    t = case if timing is None else timing
    return {"dtype": case["dtype"], "route": case["route"],
            "ms": t["kernel_ms"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "max_abs_err": (case["max_abs_err"] if timing is None
                            else max(case["max_abs_err"].values())),
            "shape": case["shape"]}


# ---------------------------------------------------------------------------
# phase 4: the flash-attention kernels against their plain versions

FLASH_SOURCE = "deeplearning4j_tpu_torch/csrc/flash_attention.cu"
# name -> (the TPU kernel it replaces, products of 2 S^2 D B H flops each)
FLASH_KERNELS = {
    "flash_fwd": ("deeplearning4j_tpu/parallel/kernels.py:95", 2),
    "flash_bwd_dkv": ("deeplearning4j_tpu/parallel/kernels.py:197", 4),
    "flash_bwd_dq": ("deeplearning4j_tpu/parallel/kernels.py:254", 3),
}
FLASH_B, FLASH_H, FLASH_D = 2, 12, 64   # one microbatch of the train phase
FLASH_DS = (64, 128)                    # head dims of the flash phase
FLASH_WIDE_DS = (136, 192, 256, 512)    # the D-chunked route
FLASH_WIDE_TIMED = 256                  # Gemma's head dim
BF16_ROUNDED_TOL = 5e-3                 # tensor-core backward vs rounding ref


def flash_bound(name: str, b: int, s: int, h: int, d: int, causal: bool,
                dtype_name: str) -> dict:
    """The least time the card needs for one kernel's work: the larger of
    its bytes (each input read once, each output written once) over the
    memory rate and its flops (causal: half the score matrix) over the
    dtype's peak."""
    x = b * s * h * d * (4 if dtype_name == "float32" else 2)
    stat = b * h * s * 4                              # one [B*H, S] f32
    nbytes = {"flash_fwd": 4 * x + stat,              # q k v in, out, lse
              "flash_bwd_dkv": 6 * x + 2 * stat,      # q k v dO, dk dv
              "flash_bwd_dq": 5 * x + 2 * stat}[name]
    ops = FLASH_KERNELS[name][1] * 2 * s * s * d * b * h
    if causal:
        ops //= 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def rel_err(got, want) -> float:
    want = want.float()
    return float((got.float() - want).abs().max() / want.abs().max())


def bf16_rounded_bwd(q, k, v, g, lse, delta, causal: bool):
    """The plain backward as the tensor cores take it: f32 products of the
    bf16 inputs with P and dS rounded to bf16 before their products
    (dV = P^T dO, dK = dS^T Q, dQ = dS K).  A yardstick tighter than the
    f32 plain version, private to this script: a misplaced or dropped tile
    fails it."""
    import torch

    b, s, h, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, gf = (x.float() for x in (q, k, v, g))
    sc = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        keep = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
        sc = sc.masked_fill(~keep, float("-inf"))
    p = torch.exp(sc - lse.reshape(b, h, s, 1))
    dv = torch.einsum("bhqk,bqhd->bkhd", p.bfloat16().float(), gf)
    dp = torch.einsum("bqhd,bkhd->bhqk", gf, vf)
    ds = (p * (dp - delta.reshape(b, h, s, 1))).bfloat16().float()
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    return dq, dk, dv


def flash_case(s: int, causal: bool, dtype_name: str, timed: bool,
               d: int = FLASH_D) -> dict:
    """The three kernels on one input against their plain versions in f32
    on the same inputs (the backward pair gets the kernel's own lse and
    delta, so every kernel is held on identical inputs); each entry's
    route against the rule; on the tensor-core route the backward also
    against `bf16_rounded_bwd`."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel import kernels as fk

    dtype = getattr(torch, dtype_name)
    b, h = FLASH_B, FLASH_H
    rng = np.random.default_rng(1000 * s + int(causal) + d)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        (b, s, h, d), np.float32)).to("cuda", dtype) for _ in range(4))
    out, lse = fk.flash_forward(q, k, v, causal)
    delta = fk.row_delta(g, out)
    dk, dv = fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal)
    dq = fk.flash_bwd_dq(q, k, v, g, lse, delta, causal)
    torch.cuda.synchronize()
    tensors = {"fwd": (q, k, v, out), "dkv": (q, k, v, g, dk, dv),
               "dq": (q, k, v, g, dq)}
    routes = {kind: fk.flash_route(kind, *ts) for kind, ts in tensors.items()}
    for kind, ts in tensors.items():
        want_route = ("tensor_cores" if dtype == torch.bfloat16 and d % 8 == 0
                      and d <= fk.MAX_MMA_HEAD_DIM[kind] else "fma_chunks"
                      if d > fk.CHUNK_HEAD_DIM else "fma")
        rule = fk.flash_route_rule(dtype, d, [t.data_ptr() for t in ts],
                                   kind)
        if routes[kind] != want_route or rule != want_route:
            raise AssertionError(f"flash {kind} D={d} {dtype_name}: the "
                                 f"entry took the {routes[kind]} route, the "
                                 f"rule says {rule}, want {want_route}")
    f32 = [x.float() for x in (q, k, v, g)]
    want_out, want_lse = fk.flash_forward_plain(*f32[:3], causal)
    want_dq, want_dk, want_dv = fk.flash_bwd_block_plain(*f32, lse, delta,
                                                         causal)
    pairs = {"out": (out, want_out), "lse": (lse, want_lse),
             "dq": (dq, want_dq), "dk": (dk, want_dk), "dv": (dv, want_dv)}
    rel = {n: rel_err(a, w) for n, (a, w) in pairs.items()}
    absolute = {n: float((a.float() - w.float()).abs().max())
                for n, (a, w) in pairs.items()}
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    bad = {n: e for n, e in rel.items() if not math.isfinite(e) or e > tol}
    if bad:
        raise AssertionError(f"flash S={s} D={d} causal={causal} "
                             f"{dtype_name}: relative max error {bad} > "
                             f"{tol}")
    case = {"S": s, "D": d, "causal": causal, "dtype": dtype_name,
            "route": routes["fwd"], "routes": routes,
            "shape": dict(B=b, S=s, H=h, D=d), "tolerance": tol,
            "max_rel_err": rel, "max_abs_err": absolute}
    if routes["dkv"] == "tensor_cores":
        tight = bf16_rounded_bwd(q, k, v, g, lse, delta, causal)
        rel_t = {n: rel_err(a, w) for n, a, w in
                 zip(("dq", "dk", "dv"), (dq, dk, dv), tight)}
        bad = {n: e for n, e in rel_t.items()
               if not math.isfinite(e) or e > BF16_ROUNDED_TOL}
        if bad:
            raise AssertionError(f"flash S={s} D={d} causal={causal}: "
                                 f"backward vs the bf16-rounding reference "
                                 f"{bad} > {BF16_ROUNDED_TOL}")
        case["max_rel_err_bf16_rounded"] = rel_t
    if not timed:
        return case
    # one SDPA call as the yardstick (the port never calls it): its
    # forward for the forward kernel; its forward + backward, and its
    # backward alone on one forward output, for the pair
    qh, kh, vh, gh = (x.transpose(1, 2).contiguous() for x in (q, k, v, g))
    qr, kr, vr = (x.detach().requires_grad_() for x in (qh, kh, vh))
    o_sdpa = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)

    def sdpa_fwd():
        F.scaled_dot_product_attention(qh, kh, vh, is_causal=causal)

    def sdpa_fwd_bwd():
        o = F.scaled_dot_product_attention(qr, kr, vr, is_causal=causal)
        torch.autograd.grad(o, (qr, kr, vr), gh)

    def sdpa_bwd():
        torch.autograd.grad(o_sdpa, (qr, kr, vr), gh, retain_graph=True)

    runs = {
        "flash_fwd": (lambda: fk.flash_forward(q, k, v, causal),
                      lambda: fk.flash_forward_plain(q, k, v, causal),
                      sdpa_fwd, None),
        "flash_bwd_dkv": (
            lambda: fk.flash_bwd_dkv(q, k, v, g, lse, delta, causal),
            lambda: fk.flash_bwd_dkv_plain(q, k, v, g, lse, delta, causal),
            sdpa_fwd_bwd, sdpa_bwd),
        "flash_bwd_dq": (
            lambda: fk.flash_bwd_dq(q, k, v, g, lse, delta, causal),
            lambda: fk.flash_bwd_dq_plain(q, k, v, g, lse, delta, causal),
            sdpa_fwd_bwd, sdpa_bwd),
    }
    case["timing"] = {}
    for name, (kern, plain, library, library_bwd) in runs.items():
        plain_ms = cuda_ms(plain, iters=10, warmup=2)
        kernel_ms = cuda_ms(kern, iters=50)
        library_ms = cuda_ms(library, iters=50)
        kernel_ms_2 = cuda_ms(kern, iters=50)
        plain_ms_2 = cuda_ms(plain, iters=10, warmup=1)
        t = case["timing"][name] = {
            "kernel_ms": device_ms(kern, iters=50),
            "plain_ms": device_ms(plain, iters=5),
            "library_ms": device_ms(library, iters=50),
            "call_ms": min(kernel_ms, kernel_ms_2),
            "call_ms_runs": [kernel_ms, kernel_ms_2],
            "plain_call_ms": min(plain_ms, plain_ms_2),
            "plain_call_ms_runs": [plain_ms, plain_ms_2],
            "library_call_ms": library_ms,
            **flash_bound(name, b, s, h, d, causal, dtype_name)}
        if library_bwd is not None:
            t["library_bwd_ms"] = device_ms(library_bwd, iters=50)
            t["library_bwd_call_ms"] = cuda_ms(library_bwd, iters=50)
    return case


def flash_phase(card: str) -> list:
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = []
    for d in FLASH_DS:
        for s in (1024, 1000):
            for causal in (True, False):
                for dt in ("float32", "bfloat16", "float16"):
                    case = flash_case(s, causal, dt, d=d, timed=(
                        s == 1024 and causal and d == FLASH_D))
                    cases.append(case)
                    tight = case.get("max_rel_err_bf16_rounded")
                    log(f"flash: S={s} D={d} causal={causal} {dt} (routes "
                        f"{'/'.join(case['routes'].values())}): relative "
                        f"err " + ", ".join(f"{n} {e:.3g}" for n, e in
                                            case["max_rel_err"].items())
                        + ("" if tight is None else "; vs bf16-rounding "
                           "reference " + ", ".join(
                               f"{n} {e:.3g}" for n, e in tight.items())))
                    for name, t in case.get("timing", {}).items():
                        log(f"flash: {name} S={s} D={d} {dt}: device ms: "
                            f"kernel {t['kernel_ms']:.4f}, plain "
                            f"{t['plain_ms']:.4f}, sdpa "
                            f"{t['library_ms']:.4f}"
                            + (f", sdpa backward alone "
                               f"{t['library_bwd_ms']:.4f}"
                               if "library_bwd_ms" in t else "")
                            + f", bound {t['bound_ms']:.4f} "
                            f"({t['bound_by']}); per call back to back: "
                            f"kernel {t['call_ms']:.4f}, sdpa "
                            f"{t['library_call_ms']:.4f} ({card})")
                    torch.cuda.empty_cache()
    # bf16 at a head dim that is not a multiple of 8: the FMA route of all
    # three entries
    case = flash_case(1000, True, "bfloat16", timed=False, d=20)
    cases.append(case)
    log(f"flash: S=1000 D=20 causal=True bfloat16 (routes "
        f"{'/'.join(case['routes'].values())}): relative err "
        + ", ".join(f"{n} {e:.3g}" for n, e in case["max_rel_err"].items()))
    # head dims above 128: the D-chunked route
    for d in FLASH_WIDE_DS:
        for causal in (True, False):
            for dt in ("float32", "bfloat16", "float16"):
                case = flash_case(500, causal, dt, timed=False, d=d)
                cases.append(case)
                log(f"flash: S=500 D={d} causal={causal} {dt} (routes "
                    f"{'/'.join(case['routes'].values())}): relative err "
                    + ", ".join(f"{n} {e:.3g}" for n, e in
                                case["max_rel_err"].items()))
    case = flash_case(1024, True, "bfloat16", timed=True, d=FLASH_WIDE_TIMED)
    cases.append(case)
    kind_of = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv",
               "flash_bwd_dq": "dq"}
    for name, t in case["timing"].items():
        log(f"flash: {name} S=1024 D={FLASH_WIDE_TIMED} bfloat16 "
            f"({case['routes'][kind_of[name]]}): device ms: kernel "
            f"{t['kernel_ms']:.4f}, plain {t['plain_ms']:.4f}, sdpa "
            f"{t['library_ms']:.4f}"
            + (f", sdpa backward alone {t['library_bwd_ms']:.4f}"
               if "library_bwd_ms" in t else "")
            + f", bound {t['bound_ms']:.4f} ({t['bound_by']}) ({card})")
    torch.cuda.empty_cache()
    return cases


def head256_grad_parity() -> dict:
    """float32: the loss and every gradient of a 2-layer transformer with
    d_model 512 over 2 heads (head dim 256, the D-chunked route) through
    the flash kernels against the plain-attention forward, relative max
    error (a key bias against its layer's query bias scale)."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import _master_f32
    from deeplearning4j_tpu_torch.tree import flatten_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = tfm.TransformerConfig(vocab_size=128, d_model=512, n_heads=2,
                                n_layers=2, d_ff=256, max_len=96,
                                attn_bias=True, tie_embeddings=True,
                                remat=True, dtype="float32")
    params = _master_f32(tfm.params_from_numpy(tfm.numpy_params(cfg),
                                               device="cuda"))
    flat = flatten_tree(params)
    names, leaves = list(flat), list(flat.values())
    data = torch.from_numpy(np.random.default_rng(4).integers(
        0, 128, (2, 97))).cuda()
    tok, tgt = data[:, :-1], data[:, 1:]
    loss_k = tfm.lm_loss(cfg, params, tok, tgt)
    grads_k = torch.autograd.grad(loss_k, leaves)
    logits = tfm._forward(cfg, params, tok, tfm.attention)
    loss_p = -F.log_softmax(logits, dim=-1).gather(
        -1, tgt[..., None])[..., 0].mean()
    grads_p = torch.autograd.grad(loss_p, leaves)
    scale = dict(zip(names, (float(g.abs().max()) for g in grads_p)))
    errs = {n: float((gk - gp).abs().max()) / scale[n.replace("//bk", "//bq")]
            for n, gk, gp in zip(names, grads_k, grads_p)}
    worst = max(errs.items(), key=lambda kv: kv[1])
    lk_, lp_ = float(loss_k.detach()), float(loss_p.detach())
    out = {"head_dim": 256, "loss_rel_err": abs(lk_ - lp_) / abs(lp_),
           "grad_max_rel_err": worst[1], "grad_worst_leaf": worst[0]}
    if not out["loss_rel_err"] <= 1e-3 or not all(
            math.isfinite(e) and e <= 1e-3 for e in errs.values()):
        raise AssertionError(f"flash: head dim 256 gradients vs plain "
                             f"attention: {out}")
    return out


# ---------------------------------------------------------------------------
# phase 5: the serving slice in bfloat16 at full width


def device_breakdown(prof, wall_s: float, dispatches: int) -> dict:
    """Device time by kernel from a `torch.profiler` run over a load
    (serving dispatches or train steps): the busy share of the wall
    clock, device time by kernel group, and per kernel name its total and
    share of the busy time."""
    from torch.autograd import DeviceType

    rows = []
    for ev in prof.key_averages():
        # device events only: a CPU op (aten::mm, an autograd node) also
        # carries its kernels' device time, which would count them twice
        if (getattr(ev, "device_type", None) != DeviceType.CUDA
                or getattr(ev, "is_user_annotation", False)):
            continue
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0)
        if dev_us > 0:
            rows.append((ev.key, float(dev_us), int(ev.count)))
    busy_us = sum(r[1] for r in rows)
    rows.sort(key=lambda r: -r[1])

    def group(name: str) -> str:
        low = name.lower()
        for kernel in ("paged_attention", "flash_fwd", "flash_bwd_dkv",
                       "flash_bwd_dq", "lstm_forward"):
            if kernel in low:
                return kernel
        if any(s in low for s in ("gemm", "gemv", "cutlass", "xmma",
                                  "splitk", "matmul", "nvjet")):
            return "matmul"
        if "memcpy" in low or "memset" in low:
            return "copies"
        return "other"

    groups: dict = {}
    for key, us, _ in rows:
        groups[group(key)] = groups.get(group(key), 0.0) + us
    return {
        "wall_ms": wall_s * 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": max(0.0, 1.0 - busy_us / 1e3 / (wall_s * 1e3)),
        "per_dispatch_busy_ms": busy_us / 1e3 / max(dispatches, 1),
        "device_events_per_dispatch": (sum(r[2] for r in rows)
                                       / max(dispatches, 1)),
        "groups_ms": {k: v / 1e3 for k, v in sorted(groups.items())},
        "top": [{"kernel": key[:90], "ms": us / 1e3, "calls": n,
                 "share_of_busy": us / busy_us if busy_us else 0.0}
                for key, us, n in rows[:12]],
    }


def zero_build_storm(srv, cfg, rng) -> dict:
    """`tests/test_paged.py`'s storm at the serve pool's scale on the warm
    pool: 24 concurrent greedy requests of mixed lengths, every third a
    40-token system prefix and 12 tokens of its own (page 16: a cached
    third page shared for 8 tokens, so copy-on-write), 8 new tokens
    each."""
    system = rng.integers(0, cfg.vocab_size, 40).tolist()
    prompts = []
    for i in range(PROGRAM_STORM):
        if i % 3 == 0:
            prompts.append(system + rng.integers(0, cfg.vocab_size,
                                                 12).tolist())
        else:
            prompts.append(rng.integers(0, cfg.vocab_size, int(
                rng.integers(1, 301))).tolist())
    hits0 = srv.stats().get("prefix_hits", 0)
    copies0 = srv._copy.programs[0].replays
    results = [None] * len(prompts)

    def client(i):
        results[i] = srv.generate(prompts[i], PROGRAM_STORM_NEW,
                                  timeout=600)

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(prompts))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    for p, r in zip(prompts, results):
        if r is None or len(r) != len(p) + PROGRAM_STORM_NEW:
            raise AssertionError("serve: a storm request did not finish")
    out = {"requests": len(prompts),
           "prefix_hits": srv.stats().get("prefix_hits", 0) - hits0,
           "cow_copies": srv._copy.programs[0].replays - copies0}
    if not (out["prefix_hits"] > 0 and out["cow_copies"] > 0):
        raise AssertionError(f"serve: the storm took no prefix hit or "
                             f"copy-on-write: {out}")
    return out


def serve_phase(tree, card: str, profile: bool = False) -> dict:
    import torch

    from deeplearning4j_tpu_torch.obs import compile_watcher
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    from deeplearning4j_tpu_torch.parallel.transformer import (
        gpt2_small,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer
    from deeplearning4j_tpu_torch.ui.server import UiServer

    cfg = gpt2_small(max_len=1024)
    params = params_from_numpy(tree, device="cuda", dtype=cfg.dtype)
    srv = ContinuousLMServer(cfg, params, slots=8, page_size=16,
                             prefill_chunk=16, device="cuda")
    try:
        before = compile_watcher().counts()
        t_warm = time.perf_counter()
        warmed = srv.warmup()
        built = watcher_delta(before)
        capture_s = build_seconds(t_warm, time.perf_counter())
        want_keys = {"lm:paged[w1]": 1, "lm:paged[w16]": 1,
                     "lm:page_copy": 1}
        if built != want_keys or warmed != 3:
            raise AssertionError(f"serve: warmup built {built} ({warmed} "
                                 f"programs), not JAX's {want_keys}")
        pool_bytes = graph_pool_bytes(srv._graph_pool)
        log(f"serve: pool warm ({warmed} programs, each captured once: "
            f"{built}; build s {capture_s}; graph pool {pool_bytes} "
            f"bytes); {srv.kv_pages} pages x {srv.page_size} tokens, "
            f"{srv.n_slots} slots")
        rng = np.random.default_rng(1)
        prefix = rng.integers(0, cfg.vocab_size, 128).tolist()
        tails = rng.integers(16, 301, 12)
        reqs = []
        for i, n in enumerate(tails):
            prompt = prefix + rng.integers(0, cfg.vocab_size,
                                           int(n)).tolist()
            temp, seed = (0.8, 1000 + i) if i >= 10 else (0.0, 0)
            reqs.append((prompt, temp, seed))
        results = [None] * len(reqs)
        errors = []

        def client(i):
            prompt, temp, seed = reqs[i]
            try:
                results[i] = srv.generate(prompt, 64, temperature=temp,
                                          seed=seed, timeout=600)
            except Exception as e:  # noqa: BLE001 — reported below
                errors.append(f"request {i}: {type(e).__name__}: {e}")

        paged_flash_attention.launches.reset()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(reqs))]
        prof = None
        if profile:
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = paged_flash_attention.launches.value
        stats = srv.stats()
        if errors or any(t.is_alive() for t in threads):
            raise AssertionError(f"serve: requests failed: {errors}")
        for (prompt, _, _), out in zip(reqs, results):
            if out is None or len(out) != len(prompt) + 64:
                raise AssertionError("serve: a request did not finish")
            if out[:len(prompt)] != prompt or not all(
                    0 <= t < cfg.vocab_size for t in out):
                raise AssertionError("serve: ids outside the vocab or "
                                     "prompt not echoed")
        if not stats.get("prefix_hit_rate", 0) > 0:
            raise AssertionError(f"serve: no prefix hits: {stats}")
        if not stats["dispatch_widths"].get("16", 0):
            raise AssertionError("serve: the chunk program never ran")
        dispatches = stats["dispatches"]
        if launches != cfg.n_layers * dispatches or launches == 0:
            raise AssertionError(
                f"serve: kernel launches {launches} != n_layers "
                f"{cfg.n_layers} x dispatches {dispatches}")
        ledger = srv.page_ledger()
        if not ledger["balanced"] or ledger["in_use"] != ledger[
                "radix_nodes"]:
            raise AssertionError(f"serve: page ledger off before stop: "
                                 f"{ledger}")
        storm = zero_build_storm(srv, cfg, rng)
        if watcher_delta(before) != want_keys:
            raise AssertionError(f"serve: the requests built programs: "
                                 f"{watcher_delta(before)}")
        log(f"serve: the 12 requests and a {PROGRAM_STORM}-request storm "
            f"({storm['prefix_hits']} prefix hits, {storm['cow_copies']} "
            f"copy-on-write pages) built no program ({card})")
    finally:
        srv.stop()
    ledger_after = srv.page_ledger()
    if not ledger_after["balanced"]:
        raise AssertionError(f"serve: page ledger off after stop: "
                             f"{ledger_after}")
    generated = sum(len(r) - len(p) for (p, _, _), r in zip(reqs, results))
    out = {
        "card": card, "requests": len(reqs), "wall_s": wall,
        "tokens_per_s": generated / wall,
        "requests_per_s": len(reqs) / wall,
        "ttft_p50_ms": stats["ttft"]["p50_ms"],
        "ttft_p99_ms": stats["ttft"]["p99_ms"],
        "latency_p50_ms": stats["latency"]["p50_ms"],
        "latency_p99_ms": stats["latency"]["p99_ms"],
        "dispatches": dispatches,
        "dispatch_widths": stats["dispatch_widths"],
        "kernel_launches": launches,
        "prefix_hit_rate": stats["prefix_hit_rate"],
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "programs": {"built_at_warmup": built, "build_s": capture_s,
                     "graph_pool_bytes": pool_bytes,
                     "compiled_programs": stats["compiled_programs"],
                     "builds_after_warmup": 0, "storm": storm},
    }
    for k in ("tokens_per_s", "requests_per_s", "ttft_p50_ms",
              "ttft_p99_ms", "latency_p50_ms", "latency_p99_ms"):
        log(f"serve: {k} = {out[k]} ({card})")
    if prof is not None:
        out["profile"] = device_breakdown(prof, wall, dispatches)

    # the HTTP front: one greedy request over POST /lm/generate against
    # the same request made in process on the same (otherwise idle) pool;
    # a sub-page prompt leaves nothing in the radix cache, so both runs
    # take identical dispatches
    ui = UiServer(port=0).serve_lm(cfg, params, slots=8, page_size=16,
                                   prefill_chunk=16, device="cuda").start()
    try:
        prompt = reqs[0][0][:15]
        body = json.dumps({"prompt_ids": prompt,
                           "max_new_tokens": 64}).encode()
        req = urllib.request.Request(
            ui.url + "/lm/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            http_ids = json.loads(resp.read())["ids"]
        local_ids = ui.state.lm_server.generate(prompt, 64, timeout=600)
        if http_ids != local_ids:
            raise AssertionError("serve: /lm/generate ids differ from the "
                                 "in-process generate")
    finally:
        ui.stop()
    log("serve: POST /lm/generate matches the in-process generate")
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 5b: the serving programs (CUDA-graph capture of every program key)


PROGRAM_LANES, PROGRAM_PAGE, PROGRAM_WIDE = 8, 16, 16
PROGRAM_STORM = 24               # the zero-build storm's requests
PROGRAM_STORM_NEW = 8


def watcher_delta(before: dict) -> dict:
    """Program builds by key since the `compile_watcher().counts()`
    snapshot `before`."""
    from deeplearning4j_tpu_torch.obs import compile_watcher

    after = compile_watcher().counts()
    return {k: n - before.get(k, 0) for k, n in sorted(after.items())
            if n != before.get(k, 0)}


def build_seconds(t0: float, t1: float) -> dict:
    """Seconds of each program build (warm run + capture) that ended in
    the perf-clock window [t0, t1], by program key."""
    from deeplearning4j_tpu_torch.obs import compile_watcher

    out: dict = {}
    for end, dur, key in compile_watcher().events_between(t0, t1):
        if end - dur >= t0:
            out.setdefault(key, []).append(dur)
    return out


def graph_pool_bytes(pool) -> int:
    """Bytes the caching allocator holds in one graph memory pool (the
    segments whose pool id is `pool`)."""
    import torch

    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))


def bitwise(a, b) -> bool:
    import torch

    if isinstance(a, torch.Tensor):
        return a.shape == b.shape and torch.equal(a, b)
    return len(a) == len(b) and all(bitwise(x, y) for x, y in zip(a, b))


def replay_vs_eager(cfg, params, card: str) -> dict:
    """Every LM program key at the serve pool's widths (8 lanes, page 16,
    the 16-wide programs), built over one pool and called three times
    (the build: warm run + capture; then two replays) against its eager
    step on a twin pool from the same seeded contents: the outputs
    bitwise equal, and the pools bitwise equal after every call outside
    the null page (whose contents are garbage by design)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import generation as gen

    b, ps, w = PROGRAM_LANES, PROGRAM_PAGE, PROGRAM_WIDE
    mp = gen.pages_per_seq(cfg, ps)
    pages = 1 + b * mp
    dt = params["embed"].dtype
    paged_shape = (cfg.n_layers, pages, ps, cfg.n_heads, cfg.head_dim)
    dense_shape = (cfg.n_layers, b, cfg.max_len, cfg.n_heads, cfg.head_dim)
    table = (1 + np.arange(b * mp, dtype=np.int32)).reshape(b, mp)
    lanes = np.arange(b, dtype=np.int32)

    def twins(shape, seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        k = torch.randn(shape, generator=g, device="cuda").to(dt)
        v = torch.randn(shape, generator=g, device="cuda").to(dt)
        return [k.clone(), v.clone()], [k, v]

    def paged_args(i, width, verify):
        rng = np.random.default_rng(100 + i)
        pos = rng.integers(300, 500, b).astype(np.int32)
        n_draft = (rng.integers(0, width, b) if verify
                   else np.zeros(b)).astype(np.int32)
        n_draft[1] = 0
        n_feed = (n_draft + 1 if verify
                  else rng.integers(1, width + 1, b)).astype(np.int32)
        tokens = rng.integers(0, cfg.vocab_size, (b, width)).astype(np.int32)
        temp = np.zeros(b, np.float32)
        temp[1] = 0.8                              # one sampled lane
        return (table, pos, n_feed, n_draft, tokens, temp, lanes + i,
                np.full(b, i, np.int32))

    def dense_args(i, sampled):
        rng = np.random.default_rng(200 + i)
        temp = (np.array([0, 0.8, 0, 1.2] * (b // 4), np.float32)
                if sampled else np.zeros(b, np.float32))
        return (rng.integers(0, 700, b).astype(np.int32),
                rng.integers(0, cfg.vocab_size, b).astype(np.int32), temp,
                lanes + i, np.full(b, i, np.int32))

    src_pages = torch.randn((cfg.n_layers, mp, ps, cfg.n_heads,
                             cfg.head_dim), generator=torch.Generator()
                            .manual_seed(9)).to(dt)
    cases = {   # key: (step, pool shape, takes params, args of call i, outputs)
        "lm:paged[w1]": (
            gen.make_spec_step(cfg, pages, ps, 1, verify=False), paged_shape,
            True, lambda i: paged_args(i, 1, False), slice(0, 2)),
        f"lm:paged[w{w}] verify": (
            gen.make_spec_step(cfg, pages, ps, w, verify=True), paged_shape,
            True, lambda i: paged_args(i, w, True), slice(0, 2)),
        f"lm:paged[w{w}] decode head": (
            gen.make_spec_step(cfg, pages, ps, w, verify=False),
            paged_shape, True, lambda i: paged_args(i, w, False),
            slice(0, 2)),
        "lm:dense": (gen.make_slot_step(cfg), dense_shape, True,
                     lambda i: dense_args(i, True), slice(0, 1)),
        "lm:draft": (gen.make_slot_step(cfg, key="lm:draft"), dense_shape,
                     True, lambda i: dense_args(i, False), slice(0, 1)),
        "lm:page_copy": (gen.make_page_copy(cfg, pages, ps), paged_shape,
                         False, lambda i: (3 + i, pages - 1 - i),
                         slice(0, 0)),
        "lm:page_gather": (gen.make_page_gather(cfg, pages, ps),
                           paged_shape, False, lambda i: (table[i + 2],),
                           slice(0, 2)),
        "lm:page_install": (
            gen.make_page_install(cfg, pages, ps), paged_shape, False,
            lambda i: (src_pages[:, :20 + i], src_pages[:, :20 + i],
                       table[b - 1 - i], 10 + i), slice(0, 0)),
    }
    out = {}
    for key in list(cases):
        step, shape, with_params, args_of, outs = cases.pop(key)
        graph_kv, eager_kv = twins(shape, seed=len(out))
        head = (params,) if with_params else ()
        # the dense caches have no null page; a paged pool's page 0 takes
        # every padding write
        lo = 0 if shape == dense_shape else 1
        equal = True
        for i in range(3):
            got = step(*head, *graph_kv, *args_of(i))
            want = step.eager(*head, *eager_kv, *args_of(i))
            torch.cuda.synchronize()
            equal &= bitwise(tuple(got[outs]), tuple(want[outs]))
            equal &= all(torch.equal(a[:, lo:], e[:, lo:])
                         for a, e in zip(graph_kv, eager_kv))
        (program,) = step.programs
        out[key] = {"bitwise": bool(equal), "replays": program.replays,
                    "captured": program.graph is not None,
                    "build_s": program.build_s}
        if not (equal and program.graph is not None
                and program.replays == 2):
            raise AssertionError(f"programs: {key} replay != its eager "
                                 f"step ({out[key]})")
        del graph_kv, eager_kv, step
        torch.cuda.empty_cache()
    log(f"programs: every LM program key replays bitwise its eager step "
        f"(outputs and pools, 3 calls each): build s "
        f"{ {k: round(v['build_s'], 4) for k, v in out.items()} } ({card})")
    return out


def lstm_programs(card: str) -> dict:
    """``classifier:*`` on both B5 routes: a bf16 char-LSTM bucket (H 256,
    the cluster route) and a 1024-unit bf16 Graves LSTM bucket (the wide
    route's grid-barrier launch, inside the graph): `output_bucketed`
    built and replayed twice under the engine's scope, each call bitwise
    the eager `output` of the same padded batch, one B5 launch a call."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.obs import compile_scope
    from deeplearning4j_tpu_torch.serving import BucketLadder

    ladder = BucketLadder((LSTM_B,))
    nets = {
        "cluster": MultiLayerNetwork(char_lstm(
            compute_dtype="bfloat16")).init(),
        "wide": MultiLayerNetwork(tconf.MultiLayerConfiguration(
            conf=tconf.NeuralNetConfiguration(seed=6,
                                              compute_dtype="bfloat16"),
            layers=(tconf.GravesLSTMConf(n_in=LSTM_V, n_out=1024),
                    tconf.RnnOutputLayerConf(n_in=1024,
                                             n_out=LSTM_V)))).init()}
    eye = np.eye(LSTM_V, dtype=np.float32)
    out = {}
    for route, net in nets.items():
        hidden = net.conf.layers[0].n_out
        plan = lk.launch_plan(torch.bfloat16, LSTM_B, hidden)
        if plan["route"] != route:
            raise AssertionError(f"programs: H {hidden} takes the "
                                 f"{plan['route']} route, not {route}")
        counter = lk.fused_lstm_forward.launches
        equal = True
        for i in range(3):
            x = eye[np.random.default_rng(i).integers(
                0, LSTM_V, (LSTM_B - 3 - i, LSTM_T))]
            before = counter.value
            with compile_scope(f"classifier:{(LSTM_B, LSTM_T, LSTM_V)}"):
                got = net.output_bucketed(x, ladder=ladder)
            torch.cuda.synchronize()
            if counter.value - before != 1:
                raise AssertionError(f"programs: {route} route call {i} "
                                     f"launched B5 "
                                     f"{counter.value - before} times")
            padded, _ = ladder.pad_rows(x)
            want = net.output(padded).float().cpu().numpy()[:len(x)]
            equal &= bool(np.array_equal(got, want))
        (program,) = [e[1] for e in
                      net._bucket_programs._programs.values()]
        out[route] = {"hidden": hidden, "bitwise": equal,
                      "replays": program.replays,
                      "captured": program.graph is not None,
                      "build_s": program.build_s,
                      "launches_a_call": plan["launches"]}
        if not (equal and program.graph is not None
                and program.replays == 2):
            raise AssertionError(f"programs: the {route} route's program "
                                 f"!= eager output ({out[route]})")
    log(f"programs: classifier programs on both B5 routes replay bitwise "
        f"their eager output: {out} ({card})")
    return out


def unwarmed_and_poisoned(cfg, params, card: str) -> dict:
    """An unwarmed serve pool's first request carries ``xla_compile``
    spans with the program keys it built; after warmup, a poisoned
    dispatch zeroes the pool in place and builds nothing again, and the
    pool then decodes the request the warm pool decoded before the
    fault."""
    import torch

    from deeplearning4j_tpu_torch.obs import compile_watcher
    from deeplearning4j_tpu_torch.obs.trace import TraceRecorder
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer

    tracer = TraceRecorder()
    srv = ContinuousLMServer(cfg, params, slots=PROGRAM_LANES,
                             page_size=PROGRAM_PAGE,
                             prefill_chunk=PROGRAM_WIDE, tracer=tracer,
                             device="cuda")
    prompt = np.random.default_rng(7).integers(0, cfg.vocab_size,
                                               40).tolist()
    try:
        srv.generate(prompt, 8, timeout=600, request_id="cold")
        (tr,) = tracer.find("cold")
        cold_keys = sorted({s["attrs"]["program_key"] for s in tr["spans"]
                            if s["name"] == "xla_compile"})
        want_keys = sorted({"lm:paged[w1]", f"lm:paged[w{PROGRAM_WIDE}]"})
        if cold_keys != want_keys:
            raise AssertionError(f"programs: the unwarmed request's "
                                 f"xla_compile keys {cold_keys} != "
                                 f"{want_keys}")
        srv.warmup()
        want = srv.generate(prompt, 8, timeout=600)
        built = compile_watcher().total(prefix="lm:")
        ptrs = [t.data_ptr() for t in srv._cache]
        real = srv._step

        def poisoned(*a, **kw):
            raise RuntimeError("poisoned dispatch")

        srv._step = poisoned
        try:
            srv.generate(prompt, 8, timeout=600)
        except RuntimeError as e:
            if "poisoned" not in str(e):
                raise
        else:
            raise AssertionError("programs: the poisoned dispatch "
                                 "succeeded")
        finally:
            srv._step = real
        again = srv.generate(prompt, 8, timeout=600)
        torch.cuda.synchronize()
        after = compile_watcher().total(prefix="lm:")
        same_tensors = [t.data_ptr() for t in srv._cache] == ptrs
    finally:
        srv.stop()
    if after != built or not same_tensors or again != want:
        raise AssertionError(
            f"programs: the poisoned dispatch built {after - built} "
            f"programs (same pool tensors: {same_tensors}, ids equal: "
            f"{again == want})")
    log(f"programs: an unwarmed request carries xla_compile {cold_keys}; "
        f"a poisoned dispatch builds nothing (compiles_total {built} -> "
        f"{after}, the pool zeroed in place) ({card})")
    return {"cold_request_keys": cold_keys, "compiles_total_before": built,
            "compiles_total_after": after, "pool_tensors_kept": True}


def programs_phase(tree, card: str) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import (
        gpt2_small,
        params_from_numpy,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_small(max_len=1024)
    params = params_from_numpy(tree, device="cuda", dtype=cfg.dtype)
    out = {"card": card,
           "lm": replay_vs_eager(cfg, params, card),
           "lstm": lstm_programs(card),
           "contract": unwarmed_and_poisoned(cfg, params, card)}
    del params
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 6: float32 teacher-forced parity at full width


def parity_phase(tree) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import (
        _forward,
        attention,
        gpt2_small,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = gpt2_small(max_len=1024, dtype="float32")
    params = params_from_numpy(tree, device="cuda", dtype="float32")
    srv = ContinuousLMServer(cfg, params, slots=8, page_size=16,
                             prefill_chunk=16, device="cuda")
    rng = np.random.default_rng(2)
    base = rng.integers(0, cfg.vocab_size, 40).tolist()   # 2.5 pages
    prompts = {"straddle_40": base,
               "straddle_17": rng.integers(0, cfg.vocab_size, 17).tolist(),
               "long_100": rng.integers(0, cfg.vocab_size, 100).tolist()}
    results = {}
    try:
        threads = [threading.Thread(
            target=lambda n=n, p=p: results.__setitem__(
                n, srv.generate(p, 32, timeout=600)))
            for n, p in prompts.items()]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
        # after the first finished: reuses its two cached full pages
        prompts["radix_reuse"] = base[:37] + rng.integers(
            0, cfg.vocab_size, 20).tolist()
        results["radix_reuse"] = srv.generate(prompts["radix_reuse"], 32,
                                              timeout=600)
        stats = srv.stats()
    finally:
        srv.stop()
    if stats.get("prefix_tokens_saved", 0) < 32:
        raise AssertionError(f"parity: the radix request reused nothing: "
                             f"{stats}")
    report = {}
    with torch.no_grad():
        for name, prompt in prompts.items():
            seq = results.get(name)
            if seq is None:
                raise AssertionError(f"parity: {name} did not finish")
            logits = _forward(cfg, params, torch.tensor([seq],
                                                        device="cuda"),
                              attention)[0]
            top2 = logits.float().topk(2, dim=-1)
            checked, tie = 0, None
            for p in range(len(prompt), len(seq)):
                gap = float(top2.values[p - 1, 0] - top2.values[p - 1, 1])
                if int(top2.indices[p - 1, 0]) != seq[p]:
                    if gap < 1e-3:
                        tie = {"position": p, "gap": gap}
                        break
                    raise AssertionError(
                        f"parity: {name} token {p} = {seq[p]} but the "
                        f"checker's argmax is {int(top2.indices[p - 1, 0])}"
                        f" (top-2 gap {gap})")
                if gap < 1e-3:
                    tie = {"position": p, "gap": gap}
                    checked += 1
                    break
                checked += 1
            report[name] = {"prompt": len(prompt), "checked": checked,
                            "near_tie": tie}
            log(f"parity: {name}: {checked} tokens match the checker"
                + (f" (stopped at near-tie {tie})" if tie else ""))
    del params
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 10: the LM server's other decode modes


# greedy ids against the argmax of the plain fp32 recompute, teacher-forced
# on the served sequence.  A served token's deficit (the position's largest
# fp32 logit minus the token's) must be at most: in float32, the parity
# phase's near-tie; in bfloat16, twice the bf16 logit error measured at that
# position (the largest |bf16 - fp32| difference of the plain bf16 recompute
# over the vocabulary).  The argmax of logits within e of the fp32 ones lies
# within 2e of the fp32 largest, so wherever the fp32 top-2 gap exceeds 2e
# the served token must be the fp32 argmax itself.
F32_TIE = 1e-3
DECODE_NEW = 64                         # new tokens a served request
SPEC_DRAFT_LEN = 4
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 128, 32
BEAM_PROMPT, BEAM_NEW, BEAM_SIZE = 64, 16, 4
BEAM_REL_TOL = 1e-3


def decode_requests(cfg) -> list:
    """The serve phase's 12 requests (a shared 128-token prefix, 16-300
    more tokens, the last two sampled at 0.8) and 4 greedy prompts that
    repeat a 32-token motif 2-5 times."""
    rng = np.random.default_rng(1)
    prefix = rng.integers(0, cfg.vocab_size, 128).tolist()
    tails = rng.integers(16, 301, 12)
    reqs = []
    for i, n in enumerate(tails):
        prompt = prefix + rng.integers(0, cfg.vocab_size, int(n)).tolist()
        reqs.append((prompt, *((0.8, 1000 + i) if i >= 10 else (0.0, 0))))
    motif_rng = np.random.default_rng(5)
    for reps in range(2, 6):
        motif = motif_rng.integers(0, cfg.vocab_size, 32).tolist()
        reqs.append((motif * reps, 0.0, 0))
    return reqs


def moe_forward(cfg, params, ids, routes=None):
    """`_forward` with the plain `attention` of an MoE config (every
    block dense-masked) written out block by block, with the routing
    given: `routes` ``[L, R, k]`` are the experts of rows ``0..R-1`` in
    each layer (their weights renormalized from this run's router
    probabilities, as `_router_weights` does); later rows take their own
    top-k.  -> (logits ``[1, S, V]``, router probabilities ``[L, S, E]``
    float32).  With `routes` None it computes what `_forward` does."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel import transformer as tfm

    x = params["embed"][ids] + params["pos"][None, :ids.shape[1], :]
    probs = []
    for i, layer in enumerate(params["layers"]):
        q, k, v = tfm.qkv_proj(layer["attn"],
                               tfm._layer_norm(layer["ln1"], x))
        x = x + tfm.out_proj(layer["attn"], tfm.attention(q, k, v))
        h = tfm._layer_norm(layer["ln2"], x)
        p = layer["moe"]
        e, d = p["w1"].shape[0], h.shape[-1]
        gate_w = torch.softmax(h @ p["gate"], dim=-1)           # [1, S, E]
        probs.append(gate_w[0].float())
        idx, w = tfm._router_weights(gate_w, cfg.moe_top_k)
        if routes is not None:
            r = routes.shape[1]
            idx = idx.clone()
            idx[0, :r] = routes[i]
            pr = gate_w[0].gather(1, idx[0])                     # [S, k]
            w = (pr / pr.sum(-1, keepdim=True) if cfg.moe_top_k > 1
                 else pr)[None]
        combine = (w[..., None] * F.one_hot(idx, e).to(h.dtype)).sum(-2)
        y = tfm._experts(p, h.reshape(1, -1, d).expand(e, -1, d))
        x = x + torch.einsum("end,ne->nd", y, combine.reshape(-1, e)
                             ).reshape(x.shape)
    x = tfm._layer_norm(params["ln_f"], x)
    return x @ tfm.lm_head(params), torch.stack(probs)


class RouteRecorder:
    """Records the expert choices of an MoE model's served run: wraps the
    port's `_router_weights` (every MoE block calls it) and keeps, for
    each sequence row computed, its ``[L, k]`` experts keyed by the
    tokens up to and including that row (KV at a row is a function of
    those tokens, so a radix-reused row has one routing whichever
    request computed it).  `attach(srv)` wraps a paged pool's dispatch
    entry, `generate` a whole-sequence call.  A pool's programs must be
    built inside the recorder: a capture's router outputs (keyed by the
    query width) are the tensors each replay of that program refreshes,
    read after every replay."""

    def __init__(self, n_layers: int):
        self.n_layers = n_layers
        self.calls = []
        self.captured = {}
        self.dispatches = []
        self.rows = {}

    def __enter__(self):
        import torch

        from deeplearning4j_tpu_torch.parallel import transformer as tfm

        self._real = real = tfm._router_weights

        def recording(probs, top_k):
            idx, w = real(probs, top_k)
            if torch.cuda.is_current_stream_capturing():
                self.captured.setdefault(probs.shape[1], []).append(idx)
            else:
                self.calls.append(idx)
            return idx, w

        tfm._router_weights = recording
        return self

    def __exit__(self, *exc):
        from deeplearning4j_tpu_torch.parallel import transformer as tfm

        tfm._router_weights = self._real

    def attach(self, srv) -> None:
        """Record every dispatch of a started pool: the layer calls stay
        on the device with a snapshot of each fed lane's tokens, and
        `routes` maps them to rows after the run (no host sync a
        dispatch)."""
        real_step = srv._step

        def step(params, k, v, table, pos, n_feed, n_draft, tokens, *rest):
            self.calls = []
            out = real_step(params, k, v, table, pos, n_feed, n_draft,
                            tokens, *rest)
            if not self.calls:          # a replay: its program's routes
                static = self.captured[tokens.shape[1]]
                if len(static) != self.n_layers:
                    raise AssertionError(
                        f"moe: {len(static)} captured routings at width "
                        f"{tokens.shape[1]}, not one a layer")
                self.calls = [t.clone() for t in static]
            lanes = [(i, slot.req.prompt + slot.generated, int(pos[i]),
                      int(n_feed[i])) for i, slot in enumerate(srv._slots)
                     if slot.req is not None and n_feed[i]]
            if lanes:
                self.dispatches.append((self.calls, lanes))
            return out

        srv._step = step

    def _index_dispatches(self) -> None:
        import torch

        for calls, lanes in self.dispatches:
            idx = torch.stack(calls).cpu()               # [L, B, C, k]
            for i, hist, pos, n_feed in lanes:
                for j in range(n_feed):
                    self.rows[tuple(hist[:pos + j + 1])] = idx[:, i, j]
        self.dispatches = []

    def generate(self, fn, prompt: np.ndarray):
        """Run `fn()` (a `generate` over `prompt` ``[B, P]``, returning
        its ids as lists) recording: the prefill's layer calls give rows
        0..P-1 of every sequence, each decode step's the next row."""
        import torch

        self.calls.clear()
        ids = fn()
        for bi, seq in enumerate(ids):
            row = 0
            for s in range(0, len(self.calls), self.n_layers):
                chunk = torch.stack(self.calls[s:s + self.n_layers]).cpu()
                for j in range(chunk.shape[2]):          # [L, B, C, k]
                    self.rows[tuple(seq[:row + 1])] = chunk[:, bi, j]
                    row += 1
        return ids

    def routes(self, seq):
        """``[L, n - 1, k]`` experts of rows 0..n-2 of `seq`."""
        import torch

        self._index_dispatches()
        return torch.stack([self.rows[tuple(seq[:row + 1])]
                            for row in range(len(seq) - 1)], dim=1)


def greedy_checker(cfg, params):
    """`check(prompt, seq[, routes])`: the greedy rule above over the
    plain fp32 full recompute (`_forward` with the plain `attention`) of
    the served weights, upcast, and in bfloat16 the plain bf16 recompute
    that measures the limit.

    MoE configs route each token by a top-k over its router
    probabilities: a discrete choice that bf16 noise flips where two
    experts' probabilities lie closer than the bf16 router error, and a
    flipped route moves the logits far more than the bf16 error of the
    recompute measures.  So an MoE sequence is checked with its served
    routing `routes` (``[L, n - 1, k]``, recorded by `RouteRecorder`):
    the fp32 and bf16 recomputes both route as the served run did, and
    the logit rule holds unchanged on them; and every served route that
    differs from the fp32 recompute's own top-k must be a near-tie: the
    fp32 probability of its weakest expert at most twice that layer's
    bf16 router error (the largest |bf16 - fp32| router probability over
    the sequence) below the fp32 k-th largest.  Each flip is reported
    (position, layer, gap, limit)."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import (
        _forward,
        attention,
        map_tree,
    )

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = map_tree(lambda t: t.float(), params)
    bf16 = cfg.dtype == "bfloat16"

    def route_flips(routes, p32, p16) -> list:
        """The served routes that differ from the fp32 top-k, each with
        its gap; raises when one is not a near-tie."""
        k = cfg.moe_top_k
        top = torch.sort(p32, dim=-1, descending=True, stable=True)
        r = routes.shape[1]
        kth = top.values[:, :r, k - 1]                             # [L, R]
        chosen = p32[:, :r].gather(2, routes.to(p32.device))       # [L, R, k]
        gap = kth - chosen.min(-1).values
        limit = 2 * (p16 - p32).abs().amax(dim=(1, 2))             # [L]
        differs = (torch.sort(routes.to(p32.device), -1).values
                   != torch.sort(top.indices[:, :r, :k], -1).values).any(-1)
        flips = [{"position": int(row) + 1, "layer": int(layer),
                  "router_gap": float(gap[layer, row]),
                  "limit": float(limit[layer])}
                 for layer, row in torch.nonzero(differs).tolist()]
        bad = [f for f in flips if f["router_gap"] > f["limit"]]
        if bad:
            raise AssertionError(f"moe: served routes that are not "
                                 f"near-ties of the fp32 router: {bad}")
        return flips

    def check(prompt, seq, routes=None) -> dict:
        p, n = len(prompt), len(seq)
        ids = torch.tensor([seq], device="cuda")
        flips = None
        with torch.no_grad():
            if cfg.n_experts:
                if routes is None:
                    raise ValueError("an MoE sequence is checked with its "
                                     "served routes")
                full32, p32 = moe_forward(cfg32, params32, ids, routes)
                rows = full32[0, p - 1:n - 1]
                full16, p16 = moe_forward(cfg, params, ids, routes)
                low = full16[0, p - 1:n - 1]
                flips = route_flips(routes, p32, p16)
            else:
                rows = _forward(cfg32, params32, ids,
                                attention)[0, p - 1:n - 1]
                low = (_forward(cfg, params, ids, attention)[0, p - 1:n - 1]
                       if bf16 else None)
            if bf16:
                limit = 2 * (low.float() - rows).abs().amax(-1)
            else:
                limit = torch.full((n - p,), F32_TIE, device="cuda")
        gen = torch.tensor(seq[p:], device="cuda")
        top2 = rows.topk(2, dim=-1).values
        deficit = top2[:, 0] - rows.gather(1, gen[:, None])[:, 0]
        off = torch.nonzero(deficit > 0)
        out = {"tokens": n - p, "exact": int((deficit == 0).sum()),
               "forced_exact": int((top2[:, 0] - top2[:, 1] > limit).sum()),
               "worst_deficit": float(deficit.max()),
               "worst_deficit_over_limit": float(
                   (deficit / limit.clamp_min(1e-12)).max()),
               "limit_min": float(limit.min()),
               "limit_max": float(limit.max()),
               "first_divergence": (p + int(off[0, 0]) if len(off)
                                    else None)}
        if flips is not None:
            out["route_flips"] = flips
        if bool((deficit > limit).any()):
            raise AssertionError(
                f"decode: a served token's fp32 logit lies further below "
                f"the position's largest than the {cfg.dtype} limit: {out}")
        return out

    return check


def checks_summary(checks: list) -> dict:
    out = {"greedy_tokens": sum(c["tokens"] for c in checks),
           "greedy_exact": sum(c["exact"] for c in checks),
           "forced_exact": sum(c["forced_exact"] for c in checks)}
    for key in ("worst_deficit", "worst_deficit_over_limit", "limit_max"):
        out[key] = max(c[key] for c in checks)
    out["limit_min"] = min(c["limit_min"] for c in checks)
    flips = [f for c in checks for f in c.get("route_flips", [])]
    if any("route_flips" in c for c in checks):
        out["route_flips"] = len(flips)
        out["route_flip_gap_max"] = max(
            (f["router_gap"] for f in flips), default=0.0)
        out["route_flip_gap_over_limit_max"] = max(
            (f["router_gap"] / f["limit"] for f in flips), default=0.0)
        out["route_flips_first"] = flips[:8]
    return out


def run_pool(srv, reqs, max_new: int, profile: bool = False) -> dict:
    """Warm the pool, then serve `reqs` concurrently with the kernel
    counts set to 0 just before and read just after (and, with
    `profile`, device time by kernel group over the run).  A paged pool
    must have launched the paged kernel n_layers times a dispatch at
    each width; a dense pool, never."""
    import torch

    from deeplearning4j_tpu_torch.parallel.kernels import flash_forward
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )

    srv.warmup()
    results = [None] * len(reqs)
    errors = []

    def client(i):
        prompt, temp, seed = reqs[i]
        try:
            results[i] = srv.generate(prompt, max_new, temperature=temp,
                                      seed=seed, timeout=900)
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(f"request {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(reqs))]
    torch.cuda.synchronize()
    paged_flash_attention.launches.reset()
    flash_forward.launches.reset()
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=1200)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    paged = paged_flash_attention.launches.value
    by_width = {str(c): n for c, n in sorted(
        paged_flash_attention.launches.by_key().items())}
    flash = flash_forward.launches.value
    stats = srv.stats()
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"decode: requests failed: {errors}")
    want = ({w: srv.cfg.n_layers * n
             for w, n in stats["dispatch_widths"].items()}
            if srv.kv == "paged" else {})
    if by_width != want or paged != sum(want.values()):
        raise AssertionError(
            f"decode: paged launches by width {by_width} (total {paged}) "
            f"!= n_layers x dispatches by width {want}")
    for (prompt, _, _), out in zip(reqs, results):
        if (out is None or len(out) != len(prompt) + max_new
                or out[:len(prompt)] != prompt
                or not all(0 <= t < srv.cfg.vocab_size for t in out)):
            raise AssertionError("decode: a request did not finish, "
                                 "echo its prompt or stay in the vocab")
    generated = sum(len(r) - len(p) for (p, _, _), r in zip(reqs, results))
    out = {"results": results, "stats": stats, "wall_s": wall,
           "tokens_per_s": generated / wall, "paged_launches": paged,
           "paged_launches_by_width": by_width, "flash_launches": flash}
    if prof is not None:
        out["profile"] = device_breakdown(prof, wall, stats["dispatches"])
    return out


def pool_summary(run: dict, checks: list) -> dict:
    stats = run["stats"]
    out = {"wall_s": run["wall_s"], "tokens_per_s": run["tokens_per_s"],
           "dispatches": stats["dispatches"],
           "dispatch_widths": stats["dispatch_widths"],
           "paged_launches": run["paged_launches"],
           "paged_launches_by_width": run["paged_launches_by_width"],
           **checks_summary(checks)}
    for key in ("decode_rounds", "tokens_per_decode_round", "spec_drafted",
                "spec_accepted", "spec_accept_rate"):
        if key in stats:
            out[key] = stats[key]
    if "profile" in run:
        out["profile"] = run["profile"]
    return out


def dispatch_ms(cfg, params, iters: int = 20) -> dict:
    """Wall milliseconds a call (its host sync included) of the pool's
    paged programs on 8 lanes at position 400 of a full-width pool, each
    replayed (`make_spec_step`) and run as its eager step (`.eager`), in
    turns (replay, eager, eager, replay): the 1-wide decode, a 16-wide
    prefill chunk on the decode head (the LM head at the last fed column
    only; the pool without speculation) and a 16-wide verify of 1 + 4
    drafts (the head over every column; the speculating pool).  This is
    what one dispatch of each kind costs the serving loop, which is
    host-bound."""
    import torch

    from deeplearning4j_tpu_torch.parallel import generation as gen

    b, ps, w = 8, 16, 16
    mp = gen.pages_per_seq(cfg, ps)
    pages = 1 + b * mp
    cache = gen.init_paged_cache(cfg, pages, ps, device="cuda")
    k, v = cache["k"], cache["v"]
    table = np.arange(1, pages, dtype=np.int32).reshape(b, mp)
    pos = np.full(b, 400, np.int32)
    zf, zi = np.zeros(b, np.float32), np.zeros(b, np.int32)
    tok = np.random.default_rng(0).integers(0, cfg.vocab_size, (b, w))
    steps = {
        "decode_1": (gen.make_spec_step(cfg, pages, ps, 1, verify=False),
                     (table, pos, np.ones(b, np.int32), zi, tok[:, :1])),
        "chunk_16": (gen.make_spec_step(cfg, pages, ps, w, verify=False),
                     (table, pos, np.full(b, w, np.int32), zi, tok)),
        "verify_16": (gen.make_spec_step(cfg, pages, ps, w, verify=True),
                      (table, pos, np.full(b, 5, np.int32),
                       np.full(b, 4, np.int32), tok)),
    }
    out = {}
    for name, (step, args) in steps.items():
        times = {"replay": [], "eager": []}
        for kind in ("replay", "eager", "eager", "replay"):
            fn = step if kind == "replay" else step.eager
            for i in range(iters + 3):
                if i == 3:
                    t0 = time.perf_counter()
                res = fn(params, k, v, *args, zf, zi, zi)
                res[0].cpu()
            times[kind].append((time.perf_counter() - t0) / iters * 1e3)
        out[name] = {"replay_ms": float(np.mean(times["replay"])),
                     "eager_ms": float(np.mean(times["eager"])),
                     "runs_ms": times}
    del cache, k, v, steps
    return out


def decode_phase(tree, card: str, profile: bool = False) -> dict:
    import dataclasses
    import gc

    import torch

    from deeplearning4j_tpu_torch.parallel import generation as gen
    from deeplearning4j_tpu_torch.parallel.kernels import flash_forward
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    from deeplearning4j_tpu_torch.parallel.transformer import (
        _forward,
        attention,
        gpt2_small,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.serving.draft import NgramDrafter
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_small(max_len=1024)
    params = params_from_numpy(tree, device="cuda", dtype=cfg.dtype)
    check = greedy_checker(cfg, params)
    reqs = decode_requests(cfg)
    greedy = [i for i, r in enumerate(reqs) if r[1] == 0.0]
    report = {"card": card}

    def served(kv="paged", **kw):
        return ContinuousLMServer(cfg, params, slots=8, kv=kv, page_size=16,
                                  prefill_chunk=16, device="cuda", **kw)

    # 1. speculation (ngram) and the same pool without it
    runs = {}
    for mode in ("ngram", "off"):
        srv = served(speculate=mode, draft_len=SPEC_DRAFT_LEN)
        try:
            runs[mode] = run_pool(srv, reqs, DECODE_NEW, profile=profile)
            ledger = srv.page_ledger()
        finally:
            srv.stop()
        run = runs[mode]
        if not ledger["balanced"] or ledger["in_use"] != ledger[
                "radix_nodes"]:
            raise AssertionError(f"decode: page ledger off ({mode}): "
                                 f"{ledger}")
        if (run["paged_launches"] != cfg.n_layers * run["stats"][
                "dispatches"] or run["paged_launches"] == 0):
            raise AssertionError(
                f"decode: paged launches {run['paged_launches']} != "
                f"n_layers x dispatches {run['stats']['dispatches']} "
                f"({mode})")
        checks = [check(reqs[i][0], run["results"][i]) for i in greedy]
        report[f"spec_{mode}"] = pool_summary(run, checks)
    ngram = runs["ngram"]["stats"]
    if not (ngram["dispatch_widths"].get("16", 0)
            and ngram.get("spec_accepted", 0) > 0):
        raise AssertionError(f"decode: the verify program never accepted "
                             f"a draft: {ngram}")
    same = [runs["ngram"]["results"][i] == runs["off"]["results"][i]
            for i in range(len(reqs))]
    report["spec_ngram"]["ids_equal_to_off"] = int(sum(same))
    # the drafter's host cost: one proposal round over 8 served histories
    hists = runs["ngram"]["results"][:8]
    drafter = NgramDrafter()
    t0 = time.perf_counter()
    for _ in range(20):
        drafter.propose(hists, [SPEC_DRAFT_LEN] * len(hists))
    report["spec_ngram"]["ngram_propose_ms"] = (
        (time.perf_counter() - t0) / 20 * 1e3)
    report["dispatch_ms"] = dispatch_ms(cfg, params)
    log(f"decode: wall ms a dispatch (8 lanes at position 400): "
        f"{report['dispatch_ms']}; an n-gram proposal round "
        f"{report['spec_ngram']['ngram_propose_ms']:.4f} ms ({card})")
    log(f"decode: ngram speculation: drafted {ngram['spec_drafted']}, "
        f"accepted {ngram['spec_accepted']} (rate "
        f"{ngram['spec_accept_rate']}), {ngram['tokens_per_decode_round']} "
        f"tokens a decode round, dispatches {ngram['dispatch_widths']}, "
        f"paged launches {runs['ngram']['paged_launches']} = "
        f"{cfg.n_layers} x {ngram['dispatches']}, by width "
        f"{runs['ngram']['paged_launches_by_width']}; "
        f"{runs['ngram']['tokens_per_s']:.2f} "
        f"tokens/s against {runs['off']['tokens_per_s']:.2f} without "
        f"speculation ({card}); ids equal to the plain pool's in "
        f"{sum(same)} of {len(reqs)} requests")

    # 2. speculation (model): self-drafting at full width, then a 2-layer
    # f32 model whose self-drafts must all be accepted
    srv = served(speculate="model", draft_len=SPEC_DRAFT_LEN)
    try:
        run = run_pool(srv, reqs[:8], DECODE_NEW)
    finally:
        srv.stop()
    checks = [check(reqs[i][0], run["results"][i])
              for i in greedy if i < 8]
    report["spec_model"] = pool_summary(run, checks)
    cfg2 = dataclasses.replace(gpt2_small(max_len=1024, dtype="float32"),
                               n_layers=2)
    tree2 = dict(tree, layers=tree["layers"][:2])
    params2 = params_from_numpy(tree2, device="cuda", dtype="float32")
    srv = ContinuousLMServer(cfg2, params2, slots=4, page_size=16,
                             prefill_chunk=16, speculate="model",
                             draft_len=SPEC_DRAFT_LEN, device="cuda")
    try:
        run2 = run_pool(srv, [(r[0][:200], 0.0, 0) for r in reqs[:4]], 32)
    finally:
        srv.stop()
    st2 = run2["stats"]
    if not 0 < st2.get("spec_accepted", 0) == st2.get("spec_drafted", 0):
        raise AssertionError(f"decode: 2-layer f32 self-drafts were not all "
                             f"accepted: {st2.get('spec_drafted')} drafted, "
                             f"{st2.get('spec_accepted')} accepted")
    report["spec_model"]["f32_2_layers"] = {
        k: st2[k] for k in ("spec_drafted", "spec_accepted",
                            "spec_accept_rate", "tokens_per_decode_round")}
    log(f"decode: model self-drafting, accept rate "
        f"{report['spec_model']['spec_accept_rate']} (bf16, "
        f"{cfg.n_layers} layers); "
        f"2-layer f32: {st2['spec_accepted']} of {st2['spec_drafted']} "
        f"accepted ({card})")

    # 3. the dense pool; its peak memory is also read above what the
    # phase holds before the pool exists (the served weights and the
    # checker's fp32 copy)
    del srv, params2
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    srv = served(kv="dense")
    try:
        run = run_pool(srv, reqs[:12], DECODE_NEW)
    finally:
        srv.stop()
    peak = torch.cuda.max_memory_allocated()
    if run["paged_launches"] or run["flash_launches"]:
        raise AssertionError("decode: the dense pool launched a kernel")
    checks = [check(reqs[i][0], run["results"][i])
              for i in greedy if i < 12]
    report["dense"] = dict(pool_summary(run, checks),
                           peak_memory_bytes=peak,
                           peak_above_start_bytes=peak - base,
                           slot_cache_bytes=srv.stats()["kv_bytes"][
                               "provisioned"])
    log(f"decode: dense pool {run['tokens_per_s']:.2f} tokens/s, peak "
        f"memory {peak} bytes, {peak - base} above the phase's start "
        f"({card})")

    # 4. whole-sequence generate, batch 4 x prompt 128 + 32 new tokens
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))
    timed, flash_calls = {}, {}

    def counted(name, **kw):
        torch.cuda.synchronize()
        flash_forward.launches.reset()
        paged_flash_attention.launches.reset()
        t0 = time.perf_counter()
        out = gen.generate(cfg, params, prompt, GEN_NEW, device="cuda", **kw)
        torch.cuda.synchronize()
        timed[name] = time.perf_counter() - t0
        flash_calls[name] = flash_forward.launches.value
        if (flash_calls[name] != cfg.n_layers
                or paged_flash_attention.launches.value):
            raise AssertionError(
                f"decode: generate ({name}) made {flash_calls[name]} flash "
                f"launches (want {cfg.n_layers}) and "
                f"{paged_flash_attention.launches.value} paged ones (want 0)")
        return out.tolist()

    def replay(ids, kept):
        """Feed `ids`' new tokens through `_prefill` and `decode_step`,
        the steps `generate` ran, and assert `kept(logits, tok)` at every
        step: the logits are those the run drew each token from."""
        with torch.no_grad():
            cache, logits = gen._prefill(cfg, params, torch.tensor(
                prompt, device="cuda"))
            for t in range(GEN_NEW):
                tok = torch.tensor([s[GEN_PROMPT + t] for s in ids],
                                   device="cuda")
                if not bool(kept(logits, tok).all()):
                    raise AssertionError(f"decode: a token at step {t} lies "
                                         f"outside its filtered support")
                if t + 1 < GEN_NEW:
                    logits, cache = gen.decode_step(cfg, params, cache, tok)

    def largest(logits, tok):
        return logits.gather(1, tok[:, None])[:, 0] == logits.max(-1).values

    greedy_ids = counted("greedy")
    gen_checks = [check(prompt[b].tolist(), greedy_ids[b])
                  for b in range(GEN_BATCH)]
    # top-k 1 keeps every logit equal to the largest, and bf16 logits tie
    # there: each token must hold its step's largest logit (greedy's tie
    # rule), and so equals greedy's up to a row's first tie
    top1 = counted("top_k_1", temperature=1.0, seed=5, top_k=1)
    replay(top1, largest)
    top1_rows = sum(a == b for a, b in zip(top1, greedy_ids))
    sampled = counted("top_k_40_top_p_0.9", temperature=1.0, seed=7,
                      top_k=40, top_p=0.9)
    replay(sampled, lambda logits, tok: gen.filtered_logits(
        logits, 1.0, 40, 0.9).gather(1, tok[:, None]) > -1e29)
    report["generate"] = {
        "batch": GEN_BATCH, "prompt": GEN_PROMPT, "new": GEN_NEW,
        "flash_launches_per_call": flash_calls,
        "greedy": checks_summary(gen_checks),
        "top_k_1_rows_equal_to_greedy": top1_rows,
        "seconds": timed,
        "tokens_per_s": {k: GEN_BATCH * GEN_NEW / v
                         for k, v in timed.items()}}
    log(f"decode: generate {GEN_BATCH} x {GEN_PROMPT} + {GEN_NEW}: greedy "
        f"{report['generate']['greedy']}; top_k=1 takes a largest logit at "
        f"every step and equals greedy in {top1_rows} of {GEN_BATCH} rows; "
        f"top-k 40 / top-p 0.9 inside the support; flash launches a call "
        f"{flash_calls}; seconds {timed} ({card})")

    # 5. beam search in f32
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = params_from_numpy(tree, device="cuda", dtype="float32")
    bprompt = rng.integers(0, cfg.vocab_size, (2, BEAM_PROMPT))
    flash_forward.launches.reset()
    toks, scores = gen.beam_search(cfg32, params32, bprompt, BEAM_NEW,
                                   beam_size=BEAM_SIZE, device="cuda")
    beam_flash = flash_forward.launches.value
    with torch.no_grad():
        logp = torch.log_softmax(_forward(cfg32, params32, toks.long(),
                                          attention), dim=-1)
    rel = []
    for b in range(2):
        tf = sum(float(logp[b, t - 1, toks[b, t]])
                 for t in range(BEAM_PROMPT, BEAM_PROMPT + BEAM_NEW))
        rel.append(abs(tf - float(scores[b])) / abs(tf))
    one, _ = gen.beam_search(cfg32, params32, bprompt, BEAM_NEW, beam_size=1,
                             device="cuda")
    greedy32 = gen.generate(cfg32, params32, bprompt, BEAM_NEW,
                            device="cuda")
    if max(rel) > BEAM_REL_TOL or beam_flash != cfg.n_layers:
        raise AssertionError(f"decode: beam score vs teacher-forced "
                             f"log-prob rel {rel} (limit {BEAM_REL_TOL}), "
                             f"flash launches {beam_flash}")
    if one.tolist() != greedy32.tolist():
        raise AssertionError("decode: beam_size=1 differs from greedy")
    report["beam"] = {"beam_size": BEAM_SIZE, "prompt": BEAM_PROMPT,
                      "new": BEAM_NEW, "scores": scores.tolist(),
                      "score_rel_err": max(rel),
                      "flash_launches": beam_flash}
    log(f"decode: beam search f32, scores {scores.tolist()} within "
        f"{max(rel):.3g} of the teacher-forced log-prob (limit "
        f"{BEAM_REL_TOL}); beam_size=1 equals greedy")
    del params, params32, srv
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 7: GPT-2-small training in bf16 compute with f32 masters


TRAIN_ACCUM, TRAIN_BATCH, TRAIN_SEQ = 4, 8, 1024
TRAIN_WARMUP, TRAIN_STEPS = 2, 5
SERVE_PROMPT, SERVE_NEW = 48, 32        # the trained LM's served request


def grad_parity(tree, tokens, targets) -> dict:
    """float32 at full width, accum 1, B = 2: the loss and every gradient
    through the flash kernels against the plain-attention `_forward` on
    the card (relative max error).  A key bias's exact gradient is zero
    (softmax is shift-invariant within a row), so its error is taken
    relative to the query bias gradient of the same layer."""
    import dataclasses

    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import _master_f32
    from deeplearning4j_tpu_torch.tree import flatten_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(tfm.gpt2_small(max_len=TRAIN_SEQ),
                              dtype="float32")
    params = _master_f32(tfm.params_from_numpy(tree, device="cuda"))
    flat = flatten_tree(params)
    names, leaves = list(flat), list(flat.values())
    tok, tgt = tokens[:2], targets[:2]
    loss_k = tfm.lm_loss(cfg, params, tok, tgt)
    grads_k = torch.autograd.grad(loss_k, leaves)
    logits = tfm._forward(cfg, params, tok, tfm.attention)
    loss_p = -F.log_softmax(logits, dim=-1).gather(
        -1, tgt[..., None])[..., 0].mean()
    del logits
    grads_p = torch.autograd.grad(loss_p, leaves)
    scale = dict(zip(names, (float(g.abs().max()) for g in grads_p)))
    worst, worst_name = 0.0, None
    for name, gk, gp in zip(names, grads_k, grads_p):
        denom = scale[name.replace("//bk", "//bq")]
        err = float((gk - gp).abs().max()) / denom
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    out = {"loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": loss_err, "grad_max_rel_err": worst,
           "grad_worst_leaf": worst_name, "leaves": len(leaves)}
    if not loss_err <= 1e-3 or not worst <= 1e-3:
        raise AssertionError(f"train: f32 kernels vs plain attention "
                             f"disagree: {out}")
    return out


def cli_round_trip(card: str) -> dict:
    """`python -m deeplearning4j_tpu_torch.cli lm` on this repository's
    prose at gpt2-small width, then its saved LM served by the port's
    `UiServer`: one greedy ``POST /lm/generate`` whose tokens must match
    the argmax of the plain-attention forward (teacher-forced, f32)."""
    import glob
    import os
    import re
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.cli import load_saved_lm
    from deeplearning4j_tpu_torch.parallel.transformer import (
        _forward,
        attention,
    )
    from deeplearning4j_tpu_torch.ui.server import UiServer

    with tempfile.TemporaryDirectory(prefix="chip-smoke-lm-") as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "wb") as f:
            for path in ["README.md"] + sorted(glob.glob("docs/*.md")):
                with open(path, "rb") as src:
                    f.write(src.read())
        out_dir = os.path.join(tmp, "lm")
        cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "lm",
               "-input", corpus, "-output", out_dir, "-preset",
               "gpt2-small", "-seq", str(TRAIN_SEQ), "-batch",
               str(TRAIN_BATCH), "-accum", str(TRAIN_ACCUM), "-eval",
               "README.md"]
        t0 = time.perf_counter()
        run = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=900)
        cli_s = time.perf_counter() - t0
        if run.returncode != 0:
            raise AssertionError(f"train: the lm CLI exited "
                                 f"{run.returncode}:\n{run.stdout}\n"
                                 f"{run.stderr[-4000:]}")
        trained = re.search(r"Trained (\d+) steps \(final loss ([\d.]+), "
                            r"(\d+) tokens/sec\)", run.stdout)
        ev = re.search(r"nll ([\d.]+), perplexity ([\d.]+)", run.stdout)
        if not trained or not ev:
            raise AssertionError(f"train: unexpected CLI output:\n"
                                 f"{run.stdout}")
        cfg, params = load_saved_lm(out_dir, device="cuda")
    steps, final, rate = (int(trained.group(1)), float(trained.group(2)),
                          int(trained.group(3)))
    nll, ppl = float(ev.group(1)), float(ev.group(2))
    if not (math.isfinite(final) and math.isfinite(ppl)) or ppl >= 256:
        raise AssertionError(f"train: CLI loss {final}, perplexity {ppl}")
    log(f"train: cli lm: {steps} steps, final loss {final}, {rate} "
        f"tokens/s, held-out nll {nll}, perplexity {ppl}, {cli_s:.1f} s "
        f"({card})")
    ui = UiServer(port=0).serve_lm(cfg, params, slots=2, page_size=16,
                                   prefill_chunk=16, device="cuda").start()
    try:
        with open("README.md", "rb") as f:
            prompt = list(f.read()[:SERVE_PROMPT])
        body = json.dumps({"prompt_ids": prompt,
                           "max_new_tokens": SERVE_NEW}).encode()
        req = urllib.request.Request(
            ui.url + "/lm/generate", data=body,
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            ids = json.loads(resp.read())["ids"]
    finally:
        ui.stop()
    if ids[:len(prompt)] != prompt or len(ids) != len(prompt) + SERVE_NEW or \
            not \
            all(0 <= t < cfg.vocab_size for t in ids):
        raise AssertionError(f"train: served ids malformed: {ids}")
    torch.backends.cuda.matmul.allow_tf32 = False
    with torch.no_grad():
        logits = _forward(cfg, params, torch.tensor([ids], device="cuda"),
                          attention)[0]
    top2 = logits.float().topk(2, dim=-1)
    checked, tie = 0, None
    for p in range(len(prompt), len(ids)):
        gap = float(top2.values[p - 1, 0] - top2.values[p - 1, 1])
        if gap < 1e-3:
            tie = {"position": p, "gap": gap}
            break
        if int(top2.indices[p - 1, 0]) != ids[p]:
            raise AssertionError(f"train: served token {p} = {ids[p]}, the "
                                 f"checker's argmax is "
                                 f"{int(top2.indices[p - 1, 0])}")
        checked += 1
    log(f"train: served the trained LM: {checked} greedy tokens match the "
        f"plain forward" + (f" (stopped at near-tie {tie})" if tie else ""))
    return {"steps": steps, "final_loss": final, "tokens_per_s": rate,
            "eval_nll": nll, "eval_perplexity": ppl, "wall_s": cli_s,
            "served_tokens_checked": checked, "near_tie": tie,
            "served_text": bytes(ids[len(prompt):]).decode("latin-1")}


def train_phase(card: str, profile: bool = False) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel import kernels as fk
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        _master_f32,
        make_accum_train_step,
    )
    from deeplearning4j_tpu_torch.tree import tree_leaves

    cfg = tfm.gpt2_small(max_len=TRAIN_SEQ)             # bf16 compute
    tree = tfm.numpy_params(cfg, seed=0)
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    tokens, targets = data[:, :-1], data[:, 1:]
    params = _master_f32(tfm.params_from_numpy(tree, device="cuda"))
    step, init_state = make_accum_train_step(cfg, lr=1e-3,
                                             accum=TRAIN_ACCUM,
                                             updater="adam")
    opt = init_state(params)
    losses = []
    for _ in range(TRAIN_WARMUP):
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"flash_fwd": fk.flash_forward.launches,
                "flash_bwd_dkv": fk.flash_bwd_dkv.launches,
                "flash_bwd_dq": fk.flash_bwd_dq.launches}
    for c in counters.values():
        c.reset()
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ts = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))                      # waits for the step
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    launches = {n: c.value for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"train: losses {losses}")
    dtypes = {str(p.dtype) for p in tree_leaves(params)}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"train: masters are {dtypes} after training")
    per_step = cfg.n_layers * TRAIN_ACCUM
    want = {"flash_fwd": 2 * per_step * TRAIN_STEPS,       # remat: twice
            "flash_bwd_dkv": per_step * TRAIN_STEPS,
            "flash_bwd_dq": per_step * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"train: launches {launches}, expected {want}")
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    out = {
        "card": card, "config": "gpt2_small(max_len=1024), bf16 compute, "
        "f32 masters, adam lr 1e-3", "accum": TRAIN_ACCUM,
        "global_batch": TRAIN_BATCH, "seq": TRAIN_SEQ,
        "warmup_steps": TRAIN_WARMUP, "steps": TRAIN_STEPS,
        "losses": losses, "step_ms": step_ms,
        "step_ms_mean": wall * 1e3 / TRAIN_STEPS,
        "tokens_per_s": tokens_per_step * TRAIN_STEPS / wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": {n: v / TRAIN_STEPS
                              for n, v in launches.items()},
    }
    log(f"train: step {out['step_ms_mean']:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s, peak memory "
        f"{peak / 2**30:.2f} GiB, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} ({card})")
    if prof is not None:
        bd = device_breakdown(prof, wall, TRAIN_STEPS)
        flash_ms = sum(bd["groups_ms"].get(n, 0.0) for n in counters)
        bd["flash_share_of_busy"] = (flash_ms / bd["device_busy_ms"]
                                     if bd["device_busy_ms"] else 0.0)
        out["profile"] = bd
        log(f"train: profile: busy {bd['device_busy_ms']:.1f} ms of "
            f"{bd['wall_ms']:.1f} ms wall, idle share "
            f"{bd['device_idle_share']:.3f}, flash share of busy "
            f"{bd['flash_share_of_busy']:.3f}, groups {bd['groups_ms']} "
            f"({card})")
    del params, opt
    torch.cuda.empty_cache()
    out["f32_parity"] = grad_parity(tree, tokens, targets)
    log(f"train: f32 kernels vs plain attention: loss rel err "
        f"{out['f32_parity']['loss_rel_err']:.3g}, worst gradient rel err "
        f"{out['f32_parity']['grad_max_rel_err']:.3g} "
        f"({out['f32_parity']['grad_worst_leaf']})")
    torch.cuda.empty_cache()
    out["cli"] = cli_round_trip(card)
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 8: the fused LSTM scan kernel against its plain version

LSTM_SOURCE = "deeplearning4j_tpu_torch/csrc/lstm.cu"
LSTM_REPLACES = "deeplearning4j_tpu/nn/layers/lstm_kernel.py:65"
LSTM_T, LSTM_B, LSTM_H, LSTM_V = 64, 32, 256, 80   # the char-LSTM shape
LSTM_LIBRARY = ("torch.nn.LSTM(80, 256) forward over [64, 32, 80] (cuDNN; "
                "a vanilla LSTM with its input projection, no peepholes)")


def lstm_inputs(t: int, b: int, h: int, dtype, seed: int = 0,
                batch_major: bool = False):
    """xz ~ N(0, 1), RW at the xavier scale of [H, 4H], peepholes
    ~ N(0, 0.2), on the card; xz as [T, B, 4H] or as the transposed view
    of a batch-major [B, T, 4H] tensor (the layer's layout)."""
    import torch

    rng = np.random.default_rng(seed)

    def rand(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale)
                                .astype(np.float32)).to("cuda", dtype)

    xz = (rand((b, t, 4 * h), 1.0).transpose(0, 1) if batch_major
          else rand((t, b, 4 * h), 1.0))
    rw = rand((h, 4 * h), (2.0 / (5 * h)) ** 0.5)
    return [xz, rw, rand((h,), 0.2), rand((h,), 0.2), rand((h,), 0.2)]


def lstm_bound(t: int, b: int, h: int, dtype_name: str,
               residuals: bool) -> dict:
    """The least time for one launch's work: the bytes it must move (xz,
    RW and the peepholes read once; hs, and with residuals cs and zs,
    written once) over the memory rate, or its 2*T*B*H*4H flops over the
    dtype's peak, whichever is larger.  The T steps are serial, which
    neither term sees."""
    item = 4 if dtype_name == "float32" else 2
    nbytes = (t * b * 4 * h + h * 4 * h + 3 * h + t * b * h) * item
    if residuals:
        nbytes += (t * b * h + t * b * 4 * h) * 4
    ops = 2 * t * b * h * 4 * h
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "ops": ops}


def lstm_phase(card: str) -> dict:
    import torch

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    worst_abs = {"float32": 0.0, "bfloat16": 0.0, "float16": 0.0}
    cases = 0
    for t in (1, 64, 200):
        for b in (1, 32, 33):
            for h in (8, 37, 256, 1024):
                for dt in ("float32", "bfloat16", "float16"):
                    for res in (False, True):
                        args = lstm_inputs(t, b, h, getattr(torch, dt),
                                           seed=cases, batch_major=res)
                        got = lk.fused_lstm_forward(*args, save_residuals=res)
                        want = lk.fused_lstm_forward_plain(
                            *args, save_residuals=res)
                        torch.cuda.synchronize()
                        errs = [rel_err(a, w) for a, w in zip(got, want)
                                if w is not None]
                        tol = 1e-5 if dt == "float32" else 2e-2
                        if not all(math.isfinite(e) and e <= tol
                                   for e in errs):
                            raise AssertionError(
                                f"lstm T={t} B={b} H={h} {dt} residuals="
                                f"{res}: relative errors {errs} > {tol}")
                        worst[dt] = max(worst[dt], *errs)
                        worst_abs[dt] = max(worst_abs[dt], *(
                            float((a.float() - w.float()).abs().max())
                            for a, w in zip(got, want) if w is not None))
                        cases += 1
    log(f"lstm: {cases} cases, worst relative error f32 "
        f"{worst['float32']:.3g}, bf16 {worst['bfloat16']:.3g}, f16 "
        f"{worst['float16']:.3g}")

    # the cluster route's limit and one past it, and batches past the
    # wide route's first ceiling (B 3039 at H 1024): each on the route its
    # plan names, the plan equal to `lstm_route_rule`
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    limits = []
    for t, b, h, dt in ((20, 33, 384, "float32"), (20, 33, 385, "float32"),
                        (20, 33, 512, "bfloat16"), (20, 33, 513, "bfloat16"),
                        (20, 33, 512, "float16"), (20, 33, 513, "float16"),
                        (8, 3040, 1024, "float32"), (8, 4096, 1024, "float32"),
                        (8, 3040, 1024, "bfloat16"),
                        (8, 4096, 1024, "bfloat16")):
        dtype = getattr(torch, dt)
        plan = lk.launch_plan(dtype, b, h)
        rule = lk.lstm_route_rule(dtype, b, h, n_sm=n_sm)
        same = {k: plan[k] for k in rule if k != "active_clusters"} == {
            k: v for k, v in rule.items() if k != "active_clusters"}
        if plan["error"] != 0 or not same:
            raise AssertionError(f"lstm plan T={t} B={b} H={h} {dt}: {plan}"
                                 f" vs the rule {rule}")
        args = lstm_inputs(t, b, h, dtype, seed=h + b, batch_major=True)
        got = lk.fused_lstm_forward(*args, save_residuals=True)
        want = lk.fused_lstm_forward_plain(*args, save_residuals=True)
        torch.cuda.synchronize()
        errs = [rel_err(a, w) for a, w in zip(got, want)]
        tol = 1e-5 if dt == "float32" else 2e-2
        if not all(math.isfinite(e) and e <= tol for e in errs):
            raise AssertionError(f"lstm T={t} B={b} H={h} {dt} on the "
                                 f"{plan['route']} route: relative errors "
                                 f"{errs} > {tol}")
        worst[dt] = max(worst[dt], *errs)
        limits.append({"T": t, "B": b, "H": h, "dtype": dt,
                       "route": plan["route"], "cluster": plan["cluster"],
                       "launches": plan["launches"],
                       "batch_tile": plan["batch_tile"],
                       "max_rel_err": max(errs)})
        log(f"lstm: T={t} B={b} H={h} {dt}: {plan['route']} route "
            f"(cluster {plan['cluster']}, {plan['launches']} launch(es) of "
            f"{plan['batch_tile']} rows), relative error {max(errs):.3g}")
        del args, got, want
        torch.cuda.empty_cache()
    output_4096 = graves_output_4096()
    log(f"lstm: output() of 4096 sequences through a 1024-unit Graves LSTM: "
        f"1 launch, relative error vs the plain path "
        f"{output_4096['rel_err']:.3g}")

    grads = {}
    for t, b, h in ((LSTM_T, LSTM_B, LSTM_H), (200, 33, 37)):
        args = lstm_inputs(t, b, h, torch.float32, seed=7, batch_major=True)
        g = torch.from_numpy(np.random.default_rng(8).standard_normal(
            (t, b, h)).astype(np.float32)).cuda()
        res = []
        for fn in (lk.fused_lstm_scan, lk.fused_lstm_scan_plain):
            leaves = [a.detach().clone().requires_grad_() for a in args]
            hs = fn(*leaves)
            res.append(torch.autograd.grad(hs, leaves, g))
        errs = {n: rel_err(a, w) for n, a, w in
                zip(("xz", "rw", "pi", "pf", "po"), *res)}
        if not all(math.isfinite(e) and e <= 1e-4 for e in errs.values()):
            raise AssertionError(f"lstm gradients T={t} B={b} H={h}: "
                                 f"relative errors {errs} > 1e-4")
        grads[f"T{t}_B{b}_H{h}"] = errs
    log(f"lstm: f32 gradients through the kernel vs the plain steps: "
        f"{grads}")

    lib_lstm = torch.nn.LSTM(LSTM_V, LSTM_H).cuda()
    timing = {}
    for dt in ("bfloat16", "float32", "float16"):
        dtype = getattr(torch, dt)
        args = lstm_inputs(LSTM_T, LSTM_B, LSTM_H, dtype, seed=9,
                           batch_major=True)
        lib_lstm.to(dtype)
        lib_lstm.flatten_parameters()      # one cuDNN weight buffer
        lib_x = torch.randn(LSTM_T, LSTM_B, LSTM_V, device="cuda",
                            dtype=dtype)
        with torch.no_grad():
            library_ms = cuda_ms(lambda: lib_lstm(lib_x), iters=50)
            library_dev = device_ms(lambda: lib_lstm(lib_x), iters=50)
        for res in (True, False):
            def plain():
                lk.fused_lstm_forward_plain(*args, save_residuals=res)

            def kern():
                lk.fused_lstm_forward(*args, save_residuals=res)

            plain_ms = cuda_ms(plain, iters=5, warmup=1)
            kernel_ms = cuda_ms(kern, iters=50)
            kernel_ms_2 = cuda_ms(kern, iters=50)
            kernel_dev = device_ms(kern, iters=50)
            timing[f"{dt}_{'train' if res else 'inference'}"] = {
                "dtype": dt, "residuals": res,
                "route": lk.launch_plan(dtype, LSTM_B, LSTM_H)["route"],
                "kernel_ms": kernel_dev,
                "step_us": kernel_dev * 1e3 / LSTM_T,
                "plain_ms": device_ms(plain, iters=3, warmup=1),
                "library_ms": library_dev,
                "call_ms": min(kernel_ms, kernel_ms_2),
                "call_ms_runs": [kernel_ms, kernel_ms_2],
                "plain_call_ms": plain_ms, "library_call_ms": library_ms,
                **lstm_bound(LSTM_T, LSTM_B, LSTM_H, dt, res)}
    for name, c in timing.items():
        c["bound_step_us"] = c["bound_ms"] * 1e3 / LSTM_T
        log(f"lstm: {name} T={LSTM_T} B={LSTM_B} H={LSTM_H} ({c['route']} "
            f"route): device ms: kernel {c['kernel_ms']:.4f} "
            f"({c['step_us']:.3f} us a step), plain {c['plain_ms']:.4f}, "
            f"cuDNN nn.LSTM {c['library_ms']:.4f}, bound "
            f"{c['bound_ms']:.5f} ({c['bound_by']}; the {LSTM_T} steps are "
            f"serial); per call "
            f"back to back: kernel {c['call_ms']:.4f}, plain "
            f"{c['plain_call_ms']:.4f}, cuDNN {c['library_call_ms']:.4f} "
            f"({card})")
    return {"cases": cases, "worst_rel_err": worst,
            "worst_abs_err": worst_abs, "grad_rel_err": grads,
            "timing": timing, "limits": limits, "output_4096": output_4096,
            "plan": {dt: lk.launch_plan(getattr(torch, dt), LSTM_B, LSTM_H)
                     for dt in ("bfloat16", "float32", "float16")},
            "library": LSTM_LIBRARY}


def graves_output_4096() -> dict:
    """`output()` of 4096 sequences (T 3) through a 1024-unit Graves LSTM
    in f32: one launch without residuals, against the same net with the
    kernel's plain version in its place (relative 1e-4)."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.nn.layers import recurrent

    conf = tconf.MultiLayerConfiguration(
        conf=tconf.NeuralNetConfiguration(seed=3),
        layers=(tconf.GravesLSTMConf(n_in=11, n_out=1024),
                tconf.RnnOutputLayerConf(n_in=1024, n_out=11)))
    net = MultiLayerNetwork(conf).init()
    ids = np.random.default_rng(0).integers(0, 11, (4096, 3))
    x = torch.from_numpy(np.eye(11, dtype=np.float32)[ids]).cuda()
    counters = (lk.fused_lstm_forward.launches,
                lk.fused_lstm_forward.residual_launches)
    for c in counters:
        c.reset()
    out = net.output(x)
    torch.cuda.synchronize()
    launches = [c.value for c in counters]
    recurrent.fused_lstm_scan = lk.fused_lstm_scan_plain
    try:
        want = net.output(x)
    finally:
        recurrent.fused_lstm_scan = lk.fused_lstm_scan
    res = {"launches": launches, "rel_err": rel_err(out, want),
           "plan": lk.launch_plan(torch.float32, 4096, 1024)}
    if launches != [1, 0] or out.shape != (4096, 3, 11) or not \
            torch.isfinite(out).all() or not res["rel_err"] <= 1e-4:
        raise AssertionError(f"lstm: output of 4096 sequences: {res}")
    return res


# ---------------------------------------------------------------------------
# phase 9: the char-LSTM MultiLayerNetwork at full width

RNN_WARMUP, RNN_STEPS = 3, 20


def char_batch():
    """The bench_lstm batch: one-hot ids from default_rng(0), targets the
    ids rolled by one, staged on the card once."""
    import torch

    ids = np.random.default_rng(0).integers(0, LSTM_V, (LSTM_B, LSTM_T))
    eye = np.eye(LSTM_V, dtype=np.float32)
    return (torch.from_numpy(eye[ids]).cuda(),
            torch.from_numpy(eye[np.roll(ids, -1, axis=1)]).cuda())


def rnn_grad_parity(x, y) -> dict:
    """float32 at full width: the loss and every gradient through the
    kernel against the same net with ``fused=False`` (the step-by-step
    scan) on the card; then `output`/`predict` of both."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        char_lstm,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    torch.backends.cuda.matmul.allow_tf32 = False
    conf = char_lstm()
    scan_conf = dataclasses.replace(conf, layers=tuple(
        dataclasses.replace(lc, fused=False) if hasattr(lc, "fused") else lc
        for lc in conf.layers))
    net = MultiLayerNetwork(conf).init()
    scan = MultiLayerNetwork(scan_conf).init()
    scan.params = params_from_numpy(scan, net.params_flat())
    lk.fused_lstm_forward.launches.reset()
    out = {}
    for name, n in (("kernel", net), ("scan", scan)):
        loss, _ = n._objective(n.params, n.state, x, y, None)
        out[name] = (float(loss), n._grads(loss))
    if lk.fused_lstm_forward.launches.value != 1:
        raise AssertionError("rnn: the f32 kernel net did not launch once")
    names = [k for k, _ in net._param_leaves()]
    gk = dict(zip(names, (g for _, g in sorted_grads(out["kernel"][1]))))
    gs = dict(zip(names, (g for _, g in sorted_grads(out["scan"][1]))))
    errs = {n: rel_err(gk[n], gs[n]) for n in names}
    loss_err = abs(out["kernel"][0] - out["scan"][0]) / abs(out["scan"][0])
    report = {"loss_kernel": out["kernel"][0], "loss_scan": out["scan"][0],
              "loss_rel_err": loss_err, "grad_rel_err": errs}
    if not loss_err <= 1e-4 or not all(
            math.isfinite(e) and e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"rnn: f32 kernel vs scan disagree: {report}")
    o_k, o_s = net.output(x), scan.output(x)
    report["output_rel_err"] = rel_err(o_k, o_s)
    if not report["output_rel_err"] <= 1e-4:
        raise AssertionError(f"rnn: f32 output vs scan: {report}")
    top2 = o_s.topk(2, dim=-1)
    clear = (top2.values[..., 0] - top2.values[..., 1]) > 1e-4
    if not torch.equal(torch.from_numpy(net.predict(x)).cuda()[clear],
                       top2.indices[..., 0][clear]):
        raise AssertionError("rnn: f32 predict differs from the scan's")
    return report


def sorted_grads(grads):
    return [(f"{i}/{k}", g[k]) for i, g in enumerate(grads)
            for k in sorted(g)]


def rnn_phase(card: str, profile: bool = False) -> dict:
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.nn.layers import recurrent
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        load_model,
        save_model,
    )

    log(f"rnn: device memory allocated before the phase: "
        f"{torch.cuda.memory_allocated()} bytes")
    x, y = char_batch()
    net = MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()
    n_lstm = sum(hasattr(lc, "fused") for lc in net.conf.layers)
    losses = [net.fit_batch(x, y) for _ in range(RNN_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = (lk.fused_lstm_forward.launches,
                lk.fused_lstm_forward.residual_launches)
    for c in counters:
        c.reset()
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(RNN_STEPS):
        ts = time.perf_counter()
        losses.append(net.fit_batch(x, y))          # waits for the step
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    launches, with_res = (c.value for c in counters)
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"rnn: losses {losses}")
    dtypes = {str(p.dtype) for _, p in net._param_leaves()}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"rnn: masters are {dtypes} after training")
    if launches != n_lstm * RNN_STEPS or with_res != launches:
        raise AssertionError(f"rnn: {launches} launches ({with_res} with "
                             f"residuals) in {RNN_STEPS} steps, expected "
                             f"{n_lstm} per step, all with residuals")
    for c in counters:
        c.reset()
    accum_losses = [net.fit_batch(x, y, accum_steps=2) for _ in range(2)]
    if counters[0].value != 2 * 2 * n_lstm or not all(
            math.isfinite(v) for v in accum_losses):
        raise AssertionError(f"rnn: accum=2 made {counters[0].value} "
                             f"launches, losses {accum_losses}")
    out = {
        "card": card, "config": "char_lstm(vocab 80, hidden 256), bf16 "
        "compute, f32 masters, adam lr 0.01", "batch": LSTM_B,
        "seq": LSTM_T, "warmup_steps": RNN_WARMUP, "steps": RNN_STEPS,
        "losses": losses, "accum2_losses": accum_losses,
        "step_ms": step_ms, "step_ms_mean": wall * 1e3 / RNN_STEPS,
        "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
        "examples_per_s": LSTM_B * RNN_STEPS / wall,
        "peak_memory_bytes": peak, "launches": launches,
        "launches_per_step": launches / RNN_STEPS,
    }
    log(f"rnn: step {out['step_ms_mean']:.3f} ms (min {min(step_ms):.3f}, "
        f"max {max(step_ms):.3f}), {out['examples_per_s']:.1f} examples/s, "
        f"peak memory {peak} bytes, losses {losses[0]:.4f} -> "
        f"{losses[-1]:.4f} ({card})")
    if prof is not None:
        bd = device_breakdown(prof, wall, RNN_STEPS)
        bd["lstm_share_of_busy"] = (
            bd["groups_ms"].get("lstm_forward", 0.0) / bd["device_busy_ms"]
            if bd["device_busy_ms"] else 0.0)
        out["profile"] = bd
        log(f"rnn: profile: busy {bd['device_busy_ms']:.2f} ms of "
            f"{bd['wall_ms']:.2f} ms wall, idle share "
            f"{bd['device_idle_share']:.3f}, lstm kernel share of busy "
            f"{bd['lstm_share_of_busy']:.3f}, groups {bd['groups_ms']} "
            f"({card})")

    # inference on the card: one launch per layer per call, no residuals,
    # against the same net with the kernel's plain version in its place
    for c in counters:
        c.reset()
    probs = net.output(x)
    pred = net.predict(x)
    if counters[0].value != 2 * n_lstm or counters[1].value != 0:
        raise AssertionError(f"rnn: output/predict made {counters[0].value}"
                             f" launches ({counters[1].value} with "
                             f"residuals), expected {n_lstm} each, none")
    recurrent.fused_lstm_scan = lk.fused_lstm_scan_plain
    try:
        want = net.output(x)
    finally:
        recurrent.fused_lstm_scan = lk.fused_lstm_scan
    out["output_rel_err_bf16"] = rel_err(probs, want)
    if probs.shape != (LSTM_B, LSTM_T, LSTM_V) or not torch.isfinite(
            probs).all() or not out["output_rel_err_bf16"] <= 2e-2 or \
            pred.shape != (LSTM_B, LSTM_T):
        raise AssertionError(f"rnn: bf16 output vs the plain path: "
                             f"{out['output_rel_err_bf16']}")
    with tempfile.TemporaryDirectory(prefix="chip-smoke-rnn-") as tmp:
        save_model(net, tmp, save_updater=True)
        back = load_model(tmp)
        if not np.array_equal(back.params_flat(), net.params_flat()) or \
                not torch.equal(back.output(x), probs):
            raise AssertionError("rnn: save_model/load_model round trip "
                                 "changed the net")
    log(f"rnn: output/predict: 1 launch per call, bf16 rel err vs the plain "
        f"path {out['output_rel_err_bf16']:.3g}; save/load round trip ok")
    del net, back
    torch.cuda.empty_cache()
    out["f32_parity"] = rnn_grad_parity(x, y)
    worst = max(out["f32_parity"]["grad_rel_err"].items(),
                key=lambda kv: kv[1])
    log(f"rnn: f32 kernel vs scan: loss rel err "
        f"{out['f32_parity']['loss_rel_err']:.3g}, worst gradient "
        f"{worst[0]} {worst[1]:.3g}, output "
        f"{out['f32_parity']['output_rel_err']:.3g}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 11: MultiLayerNetwork's conv nets, pretraining, solvers and CLI


MLN_LENET_B, MLN_LENET_WARMUP, MLN_LENET_STEPS = 256, 5, 100
MLN_ALEX_B, MLN_ALEX_WARMUP, MLN_ALEX_STEPS = 128, 3, 20
MLN_DBN_N, MLN_DBN_B = 6000, 100
MLN_PARITY_B = 8
MLN_ROUTE_WARMUP, MLN_ROUTE_STEPS = 3, 20
MLN_BF16_LOSS_TOL, MLN_BF16_GRAD_RATIO = 1e-3, 2.0
MLN_SOLVER_ITERS = 10


def lenet_train_flops_per_example() -> float:
    """`bench.py`'s count (`_lenet_train_flops_per_example`): matmul and
    conv FLOPs of one LeNet training example, forward 2 x MACs, training
    3 x forward."""
    fwd = (2 * (28 * 28 * 6 * 5 * 5 * 1) + 2 * (10 * 10 * 16 * 5 * 5 * 6)
           + 2 * (400 * 120) + 2 * (120 * 84) + 2 * (84 * 10))
    return 3.0 * fwd


def staged_batches(ds, batch: int, n_batches: int):
    """`n_batches` consecutive batches of a DataSet as tensors on the
    card, staged once."""
    import torch

    return [(torch.from_numpy(ds.features[i * batch:(i + 1) * batch]).cuda(),
             torch.from_numpy(ds.labels[i * batch:(i + 1) * batch]).cuda())
            for i in range(n_batches)]


def timed_fit(net, batches, warmup: int, steps: int,
              profile: bool = False) -> dict:
    """`warmup` then `steps` timed `fit_batch` calls cycling over
    `batches` (each waits for its step); step ms, peak memory, losses.
    Checks that every step's loss is finite and that the loss of the
    staged batches without dropout (`score`, before the first step and
    after the last) falls: the step losses of AlexNet's dropout-0.5 steps
    fall by about as much as they scatter."""
    import torch

    def staged_score():
        return float(np.mean([net.score(x, y) for x, y in batches]))

    score_before = staged_score()
    losses = [net.fit_batch(*batches[i % len(batches)])
              for i in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    step_ms = []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        losses.append(net.fit_batch(*batches[(warmup + i) % len(batches)]))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    if prof is not None:
        prof.__exit__(None, None, None)
    batch = int(batches[0][0].shape[0])
    out = {"batch": batch, "warmup_steps": warmup, "steps": steps,
           "losses": losses, "step_ms": step_ms,
           "step_ms_mean": wall * 1e3 / steps, "step_ms_min": min(step_ms),
           "step_ms_max": max(step_ms),
           "examples_per_s": batch * steps / wall,
           "peak_memory_bytes": torch.cuda.max_memory_allocated()}
    if prof is not None:
        out["profile"] = device_breakdown(prof, wall, steps)
    out["score_before"], out["score_after"] = score_before, staged_score()
    head, tail = losses[:10], losses[-10:]
    out["losses_head_mean"], out["losses_tail_mean"] = (float(np.mean(head)),
                                                        float(np.mean(tail)))
    if not all(math.isfinite(v) for v in losses) or \
            not out["score_after"] < out["score_before"]:
        raise AssertionError(f"mln: losses not finite, or the staged "
                             f"batches' loss did not fall: {out}")
    dtypes = {str(p.dtype) for _, p in net._param_leaves()}
    if dtypes != {"torch.float32"}:
        raise AssertionError(f"mln: masters are {dtypes} after training")
    return out


def conv_loss_and_grads(conf, shape, dtype: str = "float32") -> dict:
    """The loss and the sorted gradients of `conf` (compute in `dtype`)
    on one seeded batch: the port's CPU run and its card run on the same
    weights, and (`cpu_f32`) the CPU run of the same net in float32."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        params_from_numpy,
    )

    rng = np.random.default_rng(0)
    x = rng.random(shape, dtype=np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, shape[0])]
    f32 = dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, compute_dtype="float32"))
    cpu = MultiLayerNetwork(conf, device="cpu").init()
    nets = {"cpu": cpu, "card": MultiLayerNetwork(conf).init()}
    if dtype != "float32":
        nets["cpu_f32"] = MultiLayerNetwork(f32, device="cpu").init()
    got = {}
    for name, net in nets.items():
        net.params = params_from_numpy(net, cpu.params_flat())
        xs, ys = (torch.from_numpy(a).to(net.device) for a in (x, y))
        loss, _ = net._objective(net.params, net.state, xs, ys, None)
        got[name] = (loss.item(), [(n, g.detach().float().cpu()) for n, g
                                   in sorted_grads(net._grads(loss))])
    return got


def grads_l2_err(got, want) -> float:
    """||got - want|| / ||want|| over every gradient leaf at once."""
    import torch

    g = torch.cat([t.double().ravel() for _, t in got])
    w = torch.cat([t.double().ravel() for _, t in want])
    return float((g - w).norm() / w.norm())


def conv_grad_parity(conf, shape) -> dict:
    """float32 with TF32 off: the loss and every gradient of `conf` on the
    card against the port's CPU run on the same weights and batch, each
    within 1e-4 relative max error."""
    got = conv_loss_and_grads(conf, shape)
    errs = {n: rel_err(g, w) for (n, g), (_, w) in
            zip(got["card"][1], got["cpu"][1])}
    loss_err = abs(got["card"][0] - got["cpu"][0]) / abs(got["cpu"][0])
    report = {"batch": shape[0], "loss_card": got["card"][0],
              "loss_cpu": got["cpu"][0], "loss_rel_err": loss_err,
              "grad_rel_err": errs}
    if not loss_err <= 1e-4 or not all(
            math.isfinite(e) and e <= 1e-4 for e in errs.values()):
        raise AssertionError(f"mln: f32 card vs CPU disagree: {report}")
    return report


def conv_bf16_parity(conf, shape) -> dict:
    """bfloat16 compute (cuDNN's convolutions on the card) against the
    port's CPU runs on the same weights and batch: the loss within
    `MLN_BF16_LOSS_TOL` relative of the CPU's bf16 loss, and the card's
    gradients no further from the CPU's float32 gradients (relative L2
    norm over every leaf at once) than `MLN_BF16_GRAD_RATIO` times the
    CPU's bf16 gradients are.  The CPU's bf16 run is the one the CPU tests
    hold to the JAX package's."""
    got = conv_loss_and_grads(conf, shape, "bfloat16")
    card, cpu, f32 = got["card"], got["cpu"], got["cpu_f32"]
    report = {"batch": shape[0], "loss_card": card[0], "loss_cpu": cpu[0],
              "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
              "grad_l2_err": grads_l2_err(card[1], cpu[1]),
              "grad_l2_err_vs_f32": grads_l2_err(card[1], f32[1]),
              "cpu_grad_l2_err_vs_f32": grads_l2_err(cpu[1], f32[1])}
    if not (report["loss_rel_err"] <= MLN_BF16_LOSS_TOL
            and report["grad_l2_err_vs_f32"] <= MLN_BF16_GRAD_RATIO
            * report["cpu_grad_l2_err_vs_f32"]):
        raise AssertionError(f"mln: bf16 card vs CPU disagree: {report}")
    return report


class cudnn_enabled:
    """`torch.backends.cudnn.enabled` set to `flag` inside the block (unlike
    `torch.backends.cudnn.flags`, no other cuDNN setting is touched)."""

    def __init__(self, flag: bool):
        self.flag = flag

    def __enter__(self):
        import torch

        self.was = torch.backends.cudnn.enabled
        torch.backends.cudnn.enabled = self.flag

    def __exit__(self, *exc):
        import torch

        torch.backends.cudnn.enabled = self.was


def conv_f32_routes() -> dict:
    """The ways other than the port's (`convolution.im2col_conv`, im2col
    by a strided view of the NHWC input) to take a float32 convolution on
    the card, each as ``(conv, cudnn_enabled)`` with the signature of the
    port's `convolution._conv_nhwc` (the padded NCHW view, the HWIO
    kernel, the stride; NHWC out): `F.conv2d` with cuDNN ("cudnn") and
    without it ("native": PyTorch's own im2col and GEMM, one sample at a
    time), and im2col by `F.unfold` with one matmul
    ("im2col_unfold")."""
    import torch.nn.functional as F

    def conv2d(xc, w, stride):
        return F.conv2d(xc, w.permute(3, 2, 0, 1),
                        stride=stride).permute(0, 2, 3, 1)

    def unfold(xc, w, stride):
        kh, kw, cin, cout = w.shape
        oh = (xc.shape[2] - kh) // stride[0] + 1
        ow = (xc.shape[3] - kw) // stride[1] + 1
        cols = F.unfold(xc, (kh, kw), stride=stride)
        w_mat = w.permute(2, 0, 1, 3).reshape(cin * kh * kw, cout)
        return (cols.transpose(1, 2) @ w_mat).reshape(xc.shape[0], oh, ow,
                                                      cout)

    return {"cudnn": (conv2d, True), "native": (conv2d, False),
            "im2col_unfold": (unfold, True)}


def conv_route_report(card: str) -> dict:
    """float32 with TF32 off, for the port's own route and each of
    `conv_f32_routes` on the card (the CPU keeps the port's route):
    the training step of LeNet-5 (batch 256) and AlexNet-CIFAR10 (batch
    128) in ms, and the worst gradient error against the port's CPU run
    at batch 8.  Reported, not checked: the port's route is held by
    `conv_grad_parity`."""
    from deeplearning4j_tpu_torch.datasets.fetchers import (
        synthetic_cifar10,
        synthetic_mnist,
    )
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        alexnet_cifar10,
        lenet_mnist,
    )
    from deeplearning4j_tpu_torch.nn.layers import convolution

    port = convolution._conv_nhwc
    routes = {"port": (port, True), **conv_f32_routes()}
    nets = {"lenet": (lenet_mnist(updater="sgd"), lenet_mnist(updater="sgd"),
                      (MLN_PARITY_B, 28, 28, 1),
                      staged_batches(synthetic_mnist(MLN_LENET_B * 2),
                                     MLN_LENET_B, 2)),
            "alexnet": (alexnet_cifar10(), alexnet_cifar10(dropout=0.0),
                        (MLN_PARITY_B, 32, 32, 3),
                        staged_batches(synthetic_cifar10(MLN_ALEX_B * 2),
                                       MLN_ALEX_B, 2))}
    out = {}
    for name, (conf, parity_conf, shape, batches) in nets.items():
        for route, (fn, cudnn_on) in routes.items():
            convolution._conv_nhwc = (
                lambda xc, w, stride, fn=fn: (fn if xc.is_cuda else port)(
                    xc, w, stride))
            try:
                with cudnn_enabled(cudnn_on):
                    got = conv_loss_and_grads(parity_conf, shape)
                    net = MultiLayerNetwork(conf).init()
                    for i in range(MLN_ROUTE_WARMUP):
                        net.fit_batch(*batches[i % 2])
                    t0 = time.perf_counter()
                    for i in range(MLN_ROUTE_STEPS):
                        net.fit_batch(*batches[i % 2])
                    step_ms = (time.perf_counter() - t0) * 1e3 / \
                        MLN_ROUTE_STEPS
            finally:
                convolution._conv_nhwc = port
            errs = {n: rel_err(g, w) for (n, g), (_, w) in
                    zip(got["card"][1], got["cpu"][1])}
            worst = max(errs, key=errs.get)
            out[f"{name}/{route}"] = {"step_ms": step_ms,
                                      "worst_grad": worst,
                                      "worst_grad_rel_err": errs[worst]}
            log(f"mln: f32 {name} conv route {route}: step "
                f"{step_ms:.3f} ms, worst gradient {worst} "
                f"{errs[worst]:.3g} ({card})")
            del net
    return out


def rbm_card_parity() -> dict:
    """`rbm_apply` and `rbm_pretrain_loss` of dbn_mnist's first RBM on the
    card against the CPU on the same weights (f32, TF32 off)."""
    import torch

    from deeplearning4j_tpu_torch.models import dbn_mnist
    from deeplearning4j_tpu_torch.nn.layers import pretrain

    lc = dbn_mnist().layers[0]
    params, _ = pretrain.rbm_init(lc, torch.Generator().manual_seed(1))
    x = torch.from_numpy((np.random.default_rng(1).random(
        (MLN_DBN_B, lc.n_in)) > 0.5).astype(np.float32))
    card = {k: v.cuda() for k, v in params.items()}
    h_cpu, _ = pretrain.rbm_apply(lc, params, {}, x)
    h_card, _ = pretrain.rbm_apply(lc, card, {}, x.cuda())
    l_cpu = pretrain.rbm_pretrain_loss(lc, params, x).item()
    l_card = pretrain.rbm_pretrain_loss(lc, card, x.cuda()).item()
    report = {"apply_max_abs_err": float((h_card.cpu() - h_cpu).abs().max()),
              "loss_abs_err": abs(l_card - l_cpu), "loss_cpu": l_cpu}
    if not (report["apply_max_abs_err"] <= 1e-5
            and report["loss_abs_err"] <= 1e-5 * max(1.0, abs(l_cpu))):
        raise AssertionError(f"mln: RBM card vs CPU: {report}")
    return report


def iris_like_csv(path: str, n: int = 150) -> tuple:
    """A seeded, separable Iris-shaped CSV: 4 features, 3 classes, the
    class index last."""
    rng = np.random.default_rng(0)
    labels = np.arange(n) % 3
    x = (rng.standard_normal((n, 4)) * 0.3 + labels[:, None] * 2.0).astype(
        np.float32)
    np.savetxt(path, np.column_stack([x, labels]), delimiter=",", fmt="%.5f")
    return x, labels


def solver_phase(x: np.ndarray, labels: np.ndarray) -> dict:
    """LBFGS and CG on `iris_mlp`, full batch: the objective after every
    iteration on the card against the CPU on the same weights (f32, TF32
    off), each falling below its start; then `fit` on the card."""
    import dataclasses

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        iris_mlp,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.optimize import Solver

    y = np.eye(3, dtype=np.float32)[labels]
    out = {}
    for algo in ("lbfgs", "conjugate_gradient"):
        base = iris_mlp()
        conf = dataclasses.replace(base, conf=dataclasses.replace(
            base.conf, optimization_algo=algo,
            num_iterations=MLN_SOLVER_ITERS))
        seen = {}
        cpu = MultiLayerNetwork(conf, device="cpu").init()
        card = MultiLayerNetwork(conf).init()
        card.params = params_from_numpy(card, cpu.params_flat())
        for name, net in (("cpu", cpu), ("card", card)):
            rec = seen[name] = [net.score(x, y)]
            listener = type("Record", (), {"iteration_done": (
                lambda self, m, i, s, rec=rec: rec.append(s))})()
            Solver.for_model(net, x, y, algorithm=algo,
                             num_iterations=MLN_SOLVER_ITERS,
                             max_line_iters=conf.conf
                             .max_num_line_search_iterations,
                             listeners=[listener]).fit_model()
        card_net = MultiLayerNetwork(conf).init()
        t0 = time.perf_counter()
        card_net.fit((x, y))
        fit_s = time.perf_counter() - t0
        errs = [abs(c - p) / abs(p) for c, p in zip(seen["card"],
                                                    seen["cpu"])]
        out[algo] = {"losses_card": seen["card"], "losses_cpu": seen["cpu"],
                     "max_rel_err": max(errs), "fit_s": fit_s,
                     "fit_score": card_net.score(x, y)}
        if len(seen["card"]) != len(seen["cpu"]) or max(errs) > 1e-4 or \
                not seen["card"][-1] < seen["card"][0] or \
                not out[algo]["fit_score"] < seen["card"][0]:
            raise AssertionError(f"mln: solver {algo}: {out[algo]}")
    return out


def mln_cli(csv: str, x: np.ndarray, labels: np.ndarray, tmp: str) -> dict:
    """`python -m deeplearning4j_tpu_torch.cli train | test | predict` on
    the card: exit codes 0, training accuracy >= 0.9, and the predictions
    file equal to the saved model's `predict`."""
    import os
    import re

    from deeplearning4j_tpu_torch.runtime.checkpoint import load_model

    out_dir = os.path.join(tmp, "run")
    preds = os.path.join(tmp, "preds.txt")
    base = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli"]
    runs = {}
    for name, args in (
            ("train", ["train", "-input", csv, "-model", "zoo:iris-mlp",
                       "-output", out_dir, "-epochs", "30", "-batch",
                       "32"]),
            ("test", ["test", "-input", csv, "-model",
                      os.path.join(out_dir, "model")]),
            ("predict", ["predict", "-input", csv, "-model",
                         os.path.join(out_dir, "model"), "-output",
                         preds])):
        t0 = time.perf_counter()
        proc = subprocess.run(base + args, capture_output=True, text=True,
                              timeout=300)
        runs[name] = {"rc": proc.returncode,
                      "s": time.perf_counter() - t0,
                      "stdout_tail": proc.stdout[-600:]}
        if proc.returncode != 0:
            raise AssertionError(f"mln: cli {name} exited "
                                 f"{proc.returncode}: {proc.stderr[-2000:]}")
    text = runs["train"]["stdout_tail"]
    rate = re.search(r"\(([\d.]+) examples/sec\)", text)
    acc = re.search(r"Accuracy:\s+([\d.]+)", text)
    got = np.loadtxt(preds, dtype=int)
    want = load_model(os.path.join(out_dir, "model")).predict(x)
    report = {"runs": runs,
              "examples_per_s": float(rate.group(1)) if rate else None,
              "train_accuracy": float(acc.group(1)) if acc else None,
              "predictions_equal": bool(np.array_equal(got, want))}
    if not (rate and acc and report["train_accuracy"] >= 0.9
            and report["predictions_equal"]):
        raise AssertionError(f"mln: cli {report}")
    return report


def mln_phase(card: str, profile: bool = False) -> dict:
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.datasets.fetchers import (
        synthetic_cifar10,
        synthetic_mnist,
    )
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        alexnet_cifar10,
        dbn_mnist,
        lenet_mnist,
    )

    out = {"card": card}
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        out["lenet_f32_parity"] = conv_grad_parity(
            lenet_mnist(updater="sgd"), (MLN_PARITY_B, 28, 28, 1))
        out["alexnet_f32_parity"] = conv_grad_parity(
            alexnet_cifar10(dropout=0.0), (MLN_PARITY_B, 32, 32, 3))
        out["routes_f32"] = conv_route_report(card)
        out["lenet_bf16_parity"] = conv_bf16_parity(
            lenet_mnist(updater="sgd", compute_dtype="bfloat16"),
            (MLN_PARITY_B, 28, 28, 1))
        out["alexnet_bf16_parity"] = conv_bf16_parity(
            alexnet_cifar10(dropout=0.0, compute_dtype="bfloat16"),
            (MLN_PARITY_B, 32, 32, 3))
        out["rbm_parity"] = rbm_card_parity()
        with tempfile.TemporaryDirectory(prefix="chip-smoke-mln-") as tmp:
            csv = f"{tmp}/iris.csv"
            x, labels = iris_like_csv(csv)
            out["solvers"] = solver_phase(x, labels)
            out["cli"] = mln_cli(csv, x, labels, tmp)
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    for name in ("lenet_f32_parity", "alexnet_f32_parity"):
        worst = max(out[name]["grad_rel_err"].items(), key=lambda kv: kv[1])
        log(f"mln: {name}: loss rel err {out[name]['loss_rel_err']:.3g}, "
            f"worst gradient {worst[0]} {worst[1]:.3g}")
    for name in ("lenet_bf16_parity", "alexnet_bf16_parity"):
        r = out[name]
        log(f"mln: {name}: card bf16 vs CPU bf16: loss rel err "
            f"{r['loss_rel_err']:.3g} (limit {MLN_BF16_LOSS_TOL:g}), "
            f"gradients L2 {r['grad_l2_err']:.3g}; gradients L2 vs CPU "
            f"f32: card bf16 {r['grad_l2_err_vs_f32']:.3g}, CPU bf16 "
            f"{r['cpu_grad_l2_err_vs_f32']:.3g} (limit "
            f"{MLN_BF16_GRAD_RATIO:g}x)")
    log(f"mln: rbm card vs cpu {out['rbm_parity']}")
    for algo, r in out["solvers"].items():
        log(f"mln: {algo}: card vs cpu max rel err {r['max_rel_err']:.3g}, "
            f"loss {r['losses_card'][0]:.4f} -> {r['losses_card'][-1]:.4f}, "
            f"fit {r['fit_s']:.3f} s ({card})")
    log(f"mln: cli train {out['cli']['examples_per_s']} examples/s, "
        f"accuracy {out['cli']['train_accuracy']}, predictions equal "
        f"{out['cli']['predictions_equal']} ({card})")

    lenet = MultiLayerNetwork(lenet_mnist(updater="sgd",
                                          compute_dtype="bfloat16")).init()
    batches = staged_batches(synthetic_mnist(MLN_LENET_B * 8),
                             MLN_LENET_B, 8)
    r = out["lenet_bf16"] = timed_fit(lenet, batches, MLN_LENET_WARMUP,
                                      MLN_LENET_STEPS, profile)
    r["tflops"] = (MLN_LENET_B * lenet_train_flops_per_example()
                   / (r["step_ms_mean"] * 1e-3) / 1e12)
    log(f"mln: lenet bf16 batch {MLN_LENET_B}: step {r['step_ms_mean']:.3f} "
        f"ms (min {r['step_ms_min']:.3f}, max {r['step_ms_max']:.3f}), "
        f"{r['examples_per_s']:.1f} examples/s, {r['tflops']:.4f} TFLOP/s, "
        f"peak memory {r['peak_memory_bytes']} bytes, losses "
        f"{r['losses'][0]:.4f} -> {r['losses'][-1]:.4f} ({card})")
    del lenet, batches
    alex = MultiLayerNetwork(alexnet_cifar10(
        compute_dtype="bfloat16")).init()
    batches = staged_batches(synthetic_cifar10(MLN_ALEX_B * 4),
                             MLN_ALEX_B, 4)
    r = out["alexnet_bf16"] = timed_fit(alex, batches, MLN_ALEX_WARMUP,
                                        MLN_ALEX_STEPS, profile)
    log(f"mln: alexnet bf16 batch {MLN_ALEX_B}: step "
        f"{r['step_ms_mean']:.3f} ms (min {r['step_ms_min']:.3f}, max "
        f"{r['step_ms_max']:.3f}), {r['examples_per_s']:.1f} examples/s, "
        f"peak memory {r['peak_memory_bytes']} bytes ({card})")
    for key in ("lenet_bf16", "alexnet_bf16"):
        r = out[key]
        log(f"mln: {key}: step losses, mean of the first 10 "
            f"{r['losses_head_mean']:.5f}, of the last 10 "
            f"{r['losses_tail_mean']:.5f}; staged batches' loss without "
            f"dropout {r['score_before']:.5f} -> {r['score_after']:.5f}")
        if "profile" in out[key]:
            bd = out[key]["profile"]
            log(f"mln: {key} profile: busy {bd['device_busy_ms']:.2f} ms of "
                f"{bd['wall_ms']:.2f} ms wall, idle share "
                f"{bd['device_idle_share']:.3f}, groups {bd['groups_ms']} "
                f"({card})")
    del alex, batches
    torch.cuda.empty_cache()

    dbn = MultiLayerNetwork(dbn_mnist()).init()
    ds = synthetic_mnist(MLN_DBN_N, binarize=True, flatten=True)
    batches = [(ds.features[i:i + MLN_DBN_B], ds.labels[i:i + MLN_DBN_B])
               for i in range(0, MLN_DBN_N, MLN_DBN_B)]
    t0 = time.perf_counter()
    dbn.fit(batches)                    # pretrain (1 epoch), then SGD
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    errs = dbn.pretrain_errors
    out["dbn"] = {"examples": MLN_DBN_N, "batch": MLN_DBN_B,
                  "fit_s": fit_s, "score": dbn.score(ds.features,
                                                     ds.labels),
                  "recon_err": {str(i): {"first": e[0], "last": e[-1],
                                         "first5": float(np.mean(e[:5])),
                                         "last5": float(np.mean(e[-5:]))}
                                for i, e in errs.items()}}
    log(f"mln: dbn_mnist pretrain + fit over {MLN_DBN_N} binarized images "
        f"in {fit_s:.2f} s; reconstruction error by layer "
        f"{out['dbn']['recon_err']} ({card})")
    if sorted(errs) != [0, 1] or not all(
            np.mean(e[-5:]) < np.mean(e[:5]) for e in errs.values()):
        raise AssertionError(f"mln: DBN reconstruction error did not fall: "
                             f"{out['dbn']}")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 12: the precision plane — loss-scaled training (B5 under mixed and
# float16), the fused chunked fit, int8 serving and the train CLI's flags

PREC_WARMUP, PREC_STEPS = 3, 20
PREC_PARITY_B = 8
PREC_LENET_B, PREC_LENET_BATCHES, PREC_LENET_TAIL = 256, 8, 100
PREC_CHUNK, PREC_EPOCHS = 8, 3
PREC_LADDER = (1, 8, 32)
PREC_REQUESTS = (1, 5, 8, 20, 32, 32, 30)       # 128 examples, ragged
PREC_AGREEMENT, PREC_BYTES_RATIO = 0.99, 3.5
# AlexNet-CIFAR10 for the int8 leg, trained until its logits are not
# near-ties (on the CPU this recipe reaches accuracy 1.0 on held-out
# synthetic_cifar10 by step 60; SGD at lr 0.01 stays near chance there)
ALEX_Q_CONF = dict(updater="adam", learning_rate=3e-4, dropout=0.0)
ALEX_Q_STEPS, ALEX_Q_BATCHES = 60, 8


def f16_policy():
    from deeplearning4j_tpu_torch.precision import (
        LossScaleConfig,
        PrecisionPolicy,
    )

    return PrecisionPolicy("float32", "float16",
                           loss_scale=LossScaleConfig())


def tree_bytes_snapshot(tree) -> list:
    """Every leaf of a tree copied to the host, for a bitwise check."""
    from deeplearning4j_tpu_torch.tree import tree_leaves

    return [t.detach().cpu().clone() for t in tree_leaves(tree)]


def loss_scaled_char_lstm(policy, name: str, card: str) -> dict:
    """The char-LSTM at full width under a loss-scaled policy: warm-up and
    timed `fit_batch` steps (B5 once a step, losses finite and falling,
    masters f32, the scaler's state), then one poison batch (an inf
    feature): parameters and updater state bitwise at their pre-step
    values, the scale halved, one overflow counted (the loss itself may
    stay finite: saturated gates turn the inf into NaN only in the
    backward)."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    x, y = char_batch()
    net = MultiLayerNetwork(char_lstm()).init().set_precision(policy)
    losses = [net.fit_batch(x, y) for _ in range(PREC_WARMUP)]
    torch.cuda.synchronize()
    lk.fused_lstm_forward.launches.reset()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(PREC_STEPS):
        ts = time.perf_counter()
        losses.append(net.fit_batch(x, y))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    launches = lk.fused_lstm_forward.launches.value
    stats = net.scaler_stats()
    dtypes = {str(p.dtype) for _, p in net._param_leaves()}
    out = {"policy": net.precision.describe(), "launches": launches,
           "launches_per_step": launches / PREC_STEPS, "losses": losses,
           "step_ms_mean": wall * 1e3 / PREC_STEPS,
           "step_ms_min": min(step_ms), "step_ms_max": max(step_ms),
           "examples_per_s": LSTM_B * PREC_STEPS / wall,
           "scaler_stats": stats, "masters": sorted(dtypes)}
    if launches != PREC_STEPS or dtypes != {"torch.float32"} or \
            not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0] or stats["overflow_count"] != 0 or \
            stats["good_steps"] != PREC_WARMUP + PREC_STEPS:
        raise AssertionError(f"precision: {name} char-LSTM: {out}")
    before = (tree_bytes_snapshot(net.params),
              tree_bytes_snapshot(net.updater_state))
    scale = stats["scale"]
    poison = x.clone()
    poison[3, 7, 0] = float("inf")
    bad_loss = net.fit_batch(poison, y)
    after = (tree_bytes_snapshot(net.params),
             tree_bytes_snapshot(net.updater_state))
    same = all(torch.equal(a, b) for pa, pb in zip(before, after)
               for a, b in zip(pa, pb))
    stats = net.scaler_stats()
    out["overflow"] = {"loss": bad_loss, "state_bitwise_unchanged": same,
                       "scaler_stats": stats}
    if not same or stats["overflow_count"] != 1 or \
            stats["scale"] != scale / 2:
        raise AssertionError(f"precision: {name} overflow step: "
                             f"{out['overflow']}")
    log(f"precision: {name} char-LSTM batch {LSTM_B}x{LSTM_T}: step "
        f"{out['step_ms_mean']:.3f} ms (min {out['step_ms_min']:.3f}, max "
        f"{out['step_ms_max']:.3f}), {out['examples_per_s']:.1f} "
        f"examples/s, B5 {launches} launches in {PREC_STEPS} steps, losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}, scaler {out['scaler_stats']};"
        f" poison batch: state bitwise unchanged, scaler {stats} ({card})")
    del net
    torch.cuda.empty_cache()
    return out


def f16_char_lstm_parity() -> dict:
    """float16 compute at batch `PREC_PARITY_B`: the loss and gradients of
    the char-LSTM on the card (B5 in f16) against the port's CPU runs on
    the same weights, in float16 and in float32: the loss within 1e-3 of
    the CPU's f16 loss, the gradients no further from the CPU's f32 ones
    (relative L2 over every leaf) than twice the CPU's f16 gradients
    are (slice 8's bf16 rule)."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        char_lstm,
        params_from_numpy,
    )

    x, y = char_batch()
    x, y = x[:PREC_PARITY_B], y[:PREC_PARITY_B]
    conf = char_lstm()
    f16 = dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, compute_dtype="float16"))
    nets = {"card": MultiLayerNetwork(f16).init(),
            "cpu": MultiLayerNetwork(f16, device="cpu").init(),
            "cpu_f32": MultiLayerNetwork(conf, device="cpu").init()}
    ref = nets["cpu"].params_flat()
    got = {}
    for name, net in nets.items():
        net.params = params_from_numpy(net, ref)
        xs, ys = x.to(net.device), y.to(net.device)
        loss, _ = net._objective(net.params, net.state, xs, ys, None)
        got[name] = (loss.item(), [(n, g.detach().float().cpu()) for n, g
                                   in sorted_grads(net._grads(loss))])
    card, cpu, f32 = got["card"], got["cpu"], got["cpu_f32"]
    report = {"batch": PREC_PARITY_B, "loss_card": card[0],
              "loss_cpu": cpu[0], "loss_cpu_f32": f32[0],
              "loss_rel_err": abs(card[0] - cpu[0]) / abs(cpu[0]),
              "grad_l2_err": grads_l2_err(card[1], cpu[1]),
              "grad_l2_err_vs_f32": grads_l2_err(card[1], f32[1]),
              "cpu_grad_l2_err_vs_f32": grads_l2_err(cpu[1], f32[1])}
    if not (report["loss_rel_err"] <= MLN_BF16_LOSS_TOL
            and report["grad_l2_err_vs_f32"] <= MLN_BF16_GRAD_RATIO
            * report["cpu_grad_l2_err_vs_f32"]):
        raise AssertionError(f"precision: f16 char-LSTM card vs CPU: "
                             f"{report}")
    return report


def lenet_batches_with_tail():
    """`PREC_LENET_BATCHES` staged LeNet batches of `PREC_LENET_B` plus a
    ragged tail of `PREC_LENET_TAIL`, as host arrays."""
    from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_mnist

    b = PREC_LENET_B
    ds = synthetic_mnist(b * PREC_LENET_BATCHES + PREC_LENET_TAIL)
    return [(ds.features[i:i + b], ds.labels[i:i + b])
            for i in range(0, len(ds.features), b)]


def lenet_fit(policy, batches, chunk=None, epochs: int = 1):
    """A fresh seeded LeNet (SGD) under `policy`, fit over `batches`;
    (net, seconds)."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, lenet_mnist

    net = MultiLayerNetwork(lenet_mnist(updater="sgd")).init()
    net.set_precision(policy)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    net.fit(batches, epochs=epochs, chunk_size=chunk)
    torch.cuda.synchronize()
    return net, time.perf_counter() - t0


def chunked_lenet(card: str) -> dict:
    """LeNet-MNIST at batch 256 over 8 staged batches plus a ragged tail:
    `fit(chunk_size=8)` against the `fit_batch` loop under mixed
    (examples/s of each, bench_lenet's two figures, recorded); host reads
    a chunk; f32 chunk 1 against 8 bitwise; mixed chunk 1 against 8 and
    chunk 1 against itself; `train_state_bytes` for fp32 and mixed beside
    the measured peak."""
    import torch

    from deeplearning4j_tpu_torch.optimize import ScoreIterationListener

    batches = lenet_batches_with_tail()
    n_ex = sum(len(x) for x, _ in batches)
    out = {"batch": PREC_LENET_B, "batches": len(batches),
           "tail": PREC_LENET_TAIL, "chunk": PREC_CHUNK,
           "epochs": PREC_EPOCHS}
    lenet_fit("mixed", batches, PREC_CHUNK)           # warm-up
    for mode, chunk in (("fit_batch", None), ("chunk", PREC_CHUNK)):
        net, s = lenet_fit("mixed", batches, chunk, PREC_EPOCHS)
        out[f"{mode}_examples_per_s"] = n_ex * PREC_EPOCHS / s
        out[f"{mode}_s"] = s
        out[f"{mode}_score"] = float(np.mean([net.score(x, y)
                                              for x, y in batches]))
    # host reads: a score listener due at every chunk's end
    reads = []
    real_cpu = torch.Tensor.cpu

    def counting_cpu(self, *a, **kw):
        reads.append(tuple(self.shape))
        return real_cpu(self, *a, **kw)

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, lenet_mnist

    net = MultiLayerNetwork(lenet_mnist(updater="sgd")).init()
    net.set_precision("mixed")
    net.add_listener(ScoreIterationListener(print_iterations=PREC_CHUNK,
                                            out=lambda s: None))
    torch.Tensor.cpu = counting_cpu
    try:
        net.fit(batches, chunk_size=PREC_CHUNK, prefetch=0)
    finally:
        torch.Tensor.cpu = real_cpu
    n_chunks = 1 + (len(batches) - PREC_CHUNK)          # [8] + the [1] tail
    out["host_reads"] = len(reads)
    out["host_reads_per_chunk"] = len(reads) / n_chunks
    if len(reads) != 1:                    # only the first chunk is due
        raise AssertionError(f"precision: {len(reads)} host reads in "
                             f"{n_chunks} chunks, one due listener: "
                             f"{reads}")
    # f32: chunk 1 against chunk 8, bitwise (im2col and cuBLAS at fixed
    # shapes); mixed: the largest difference beside chunk 1's run-to-run
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        flat = {k: lenet_fit("fp32", batches, k)[0].params_flat()
                for k in (1, PREC_CHUNK)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out["f32_chunk1_vs_8_bitwise"] = bool(
        flat[1].tobytes() == flat[PREC_CHUNK].tobytes())
    if not out["f32_chunk1_vs_8_bitwise"]:
        raise AssertionError(
            f"precision: f32 chunk 1 vs {PREC_CHUNK} differ by "
            f"{float(np.abs(flat[1] - flat[PREC_CHUNK]).max())}")
    mixed = [lenet_fit("mixed", batches, k)[0].params_flat()
             for k in (1, 1, PREC_CHUNK)]
    out["mixed_chunk1_vs_8_max_abs_diff"] = float(
        np.abs(mixed[0] - mixed[2]).max())
    out["mixed_chunk1_run_to_run_max_abs_diff"] = float(
        np.abs(mixed[0] - mixed[1]).max())
    # the training-state model beside the measured peak of one step
    x = torch.from_numpy(batches[0][0]).cuda()
    y = torch.from_numpy(batches[0][1]).cuda()
    out["train_state"] = {}
    for policy in ("fp32", "mixed"):
        net = MultiLayerNetwork(lenet_mnist(updater="sgd")).init()
        net.set_precision(policy)
        net.fit_batch(x, y)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        net.fit_batch(x, y)
        torch.cuda.synchronize()
        out["train_state"][policy] = {
            "train_state_bytes": net.train_state_bytes(batches[0][0]),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "peak_above_resident_bytes":
                torch.cuda.max_memory_allocated() - base}
        del net
    log(f"precision: lenet mixed batch {PREC_LENET_B}, {len(batches)} "
        f"batches ({PREC_LENET_TAIL}-row tail) x {PREC_EPOCHS} epochs: "
        f"fit_batch loop {out['fit_batch_examples_per_s']:.1f} examples/s, "
        f"fit(chunk_size={PREC_CHUNK}) {out['chunk_examples_per_s']:.1f} "
        f"examples/s; host reads {out['host_reads']} in {n_chunks} chunks; "
        f"f32 chunk 1 vs {PREC_CHUNK} bitwise; mixed chunk 1 vs "
        f"{PREC_CHUNK} {out['mixed_chunk1_vs_8_max_abs_diff']:.3g}, run to "
        f"run {out['mixed_chunk1_run_to_run_max_abs_diff']:.3g}; state "
        f"{out['train_state']} ({card})")
    torch.cuda.empty_cache()
    return out


def quantized_serving(name: str, net, x: np.ndarray) -> dict:
    """`QuantizedNet` of a trained net through `output_bucketed` on the
    ladder `PREC_LADDER`, fed as ragged requests: top-1 agreement with
    the float net, resident bytes, bucketed = a dispatch of the padded
    batch (bitwise), the unpadded difference reported, and the forward's
    input signatures at most the buckets."""
    import torch

    from deeplearning4j_tpu_torch.precision import QuantizedNet
    from deeplearning4j_tpu_torch.serving import BucketLadder

    q = QuantizedNet(net)
    ladder = BucketLadder(PREC_LADDER)
    outs, bitwise, unpadded = [], True, 0.0
    i = 0
    for n in PREC_REQUESTS:
        xr = x[i:i + n]
        i += n
        got = q.output_bucketed(xr, ladder=ladder)
        b = ladder.batch_bucket(n)
        padded = np.concatenate([xr, np.zeros((b - n,) + xr.shape[1:],
                                              xr.dtype)])
        want = q.output(padded).float().cpu().numpy()[:n]
        bitwise &= got.tobytes() == want.tobytes()
        # the unpadded dispatch, through the forward itself (`output`
        # would add its shape to the signatures counted below)
        alone = q._forward(torch.from_numpy(xr).cuda(), None)
        unpadded = max(unpadded, float(np.abs(
            got - alone.float().cpu().numpy()).max()))
        outs.append(got)
    got = np.concatenate(outs)
    agree = float((got.argmax(-1) == net.predict(x[:i])).mean())
    rep = q.quantization_report()
    out = {"examples": i, "requests": list(PREC_REQUESTS),
           "ladder": list(PREC_LADDER), "top1_agreement": agree,
           "bytes_ratio": rep["float_param_bytes"] / rep["param_bytes"],
           "report": rep, "bucketed_equals_padded_dispatch": bitwise,
           "unpadded_max_abs_diff": unpadded,
           "forward_program_count": q.forward_program_count()}
    if not (agree >= PREC_AGREEMENT and out["bytes_ratio"] >= PREC_BYTES_RATIO
            and bitwise and out["forward_program_count"] <= len(PREC_LADDER)):
        raise AssertionError(f"precision: quantized {name}: {out}")
    del q
    torch.cuda.empty_cache()
    return out


def quantized_phase(card: str) -> dict:
    """`QuantizedNet` on `mnist_mlp` (bench_precision's serving leg:
    trained 10 steps on separable synthetic classes) and on AlexNet-
    CIFAR10 (trained on `synthetic_cifar10` at batch 128) through
    `output_bucketed`."""
    from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_cifar10
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        alexnet_cifar10,
        mnist_mlp,
    )

    rng = np.random.default_rng(0)
    sy = rng.integers(0, 10, 512)
    sx = rng.normal(0, 0.3, (512, 784)).astype(np.float32)
    sx[np.arange(512), sy * 78] += 3.0
    mlp = MultiLayerNetwork(mnist_mlp()).init()
    for _ in range(10):
        mlp.fit_batch(sx, np.eye(10, dtype=np.float32)[sy])
    probe = rng.normal(0, 0.3, (128, 784)).astype(np.float32)
    probe[np.arange(128), (np.arange(128) % 10) * 78] += 3.0
    out = {"mnist_mlp": quantized_serving("mnist_mlp", mlp, probe)}
    del mlp
    ds = synthetic_cifar10(128 * (ALEX_Q_BATCHES + 1))
    alex = MultiLayerNetwork(alexnet_cifar10(**ALEX_Q_CONF)).init()
    for i in range(ALEX_Q_STEPS):
        b = i % ALEX_Q_BATCHES
        alex.fit_batch(ds.features[b * 128:(b + 1) * 128],
                       ds.labels[b * 128:(b + 1) * 128])
    held = ds.features[ALEX_Q_BATCHES * 128:]
    out["alexnet_cifar10"] = quantized_serving("alexnet_cifar10", alex, held)
    out["alexnet_cifar10"]["float_accuracy"] = float(
        (alex.predict(held) == ds.labels[ALEX_Q_BATCHES * 128:].argmax(-1))
        .mean())
    out["alexnet_cifar10"]["training"] = dict(ALEX_Q_CONF,
                                              steps=ALEX_Q_STEPS,
                                              batch=128)
    for name, r in out.items():
        log(f"precision: QuantizedNet {name}: top-1 agreement "
            f"{r['top1_agreement']:.4f} over {r['examples']} examples, "
            f"param bytes {r['report']['param_bytes']} vs "
            f"{r['report']['float_param_bytes']} ({r['bytes_ratio']:.2f}x), "
            f"bucketed = padded dispatch {r['bucketed_equals_padded_dispatch']}"
            f", unpadded diff {r['unpadded_max_abs_diff']:.3g}, signatures "
            f"{r['forward_program_count']} for "
            f"{len(PREC_LADDER)} buckets ({card})")
    return out


def precision_cli(card: str) -> dict:
    """``cli train -precision mixed -chunk 8`` on the seeded Iris CSV, in
    this process: exit 0, accuracy >= 0.9, the ``precision:`` lines, and
    the CSV read by the native library (built by g++ here)."""
    import contextlib
    import io
    import re
    import tempfile

    from deeplearning4j_tpu_torch import cli, native

    with tempfile.TemporaryDirectory(prefix="chip-smoke-prec-") as tmp:
        csv = f"{tmp}/iris.csv"
        iris_like_csv(csv)
        before = native.READS["csv_read"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["train", "-input", csv, "-model", "zoo:iris-mlp",
                           "-output", f"{tmp}/run", "-epochs", "30",
                           "-batch", "32", "-precision", "mixed", "-chunk",
                           str(PREC_CHUNK)])
        s = time.perf_counter() - t0
    text = buf.getvalue()
    acc = re.search(r"Accuracy:\s+([\d.]+)", text)
    rate = re.search(r"\(([\d.]+) examples/sec\)", text)
    out = {"rc": rc, "s": s,
           "accuracy": float(acc.group(1)) if acc else None,
           "examples_per_s": float(rate.group(1)) if rate else None,
           "precision_lines": [ln for ln in text.splitlines()
                               if ln.startswith("precision:")],
           "have_native": native.have_native(),
           "native_library": str(native.library_path()),
           "native_csv_reads": native.READS["csv_read"] - before}
    if not (rc == 0 and out["accuracy"] is not None
            and out["accuracy"] >= 0.9 and len(out["precision_lines"]) == 2
            and out["have_native"] and out["native_csv_reads"] == 1):
        raise AssertionError(f"precision: cli {out}\n{text[-2000:]}")
    log(f"precision: cli train -precision mixed -chunk {PREC_CHUNK}: rc 0, "
        f"accuracy {out['accuracy']}, {out['examples_per_s']} examples/s, "
        f"{out['precision_lines']}; native csv reader used "
        f"({out['native_library']}) ({card})")
    return out


def precision_phase(card: str) -> dict:
    import torch

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    t0 = time.perf_counter()
    out = {"card": card}
    out["mixed_char_lstm"] = loss_scaled_char_lstm("mixed", "mixed", card)
    out["f16_char_lstm"] = loss_scaled_char_lstm(f16_policy(), "float16",
                                                 card)
    tf32 = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        lk.fused_lstm_forward.launches.reset()
        r = out["f16_char_lstm_parity"] = f16_char_lstm_parity()
        r["b5_launches"] = lk.fused_lstm_forward.launches.value
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = tf32
    log(f"precision: f16 char-LSTM batch {PREC_PARITY_B} card vs CPU: loss "
        f"rel err {r['loss_rel_err']:.3g} (limit {MLN_BF16_LOSS_TOL:g}); "
        f"gradients L2 vs CPU f32: card f16 {r['grad_l2_err_vs_f32']:.3g}, "
        f"CPU f16 {r['cpu_grad_l2_err_vs_f32']:.3g} (limit "
        f"{MLN_BF16_GRAD_RATIO:g}x); card vs CPU f16 {r['grad_l2_err']:.3g}")
    out["lenet_chunked"] = chunked_lenet(card)
    out["quantized"] = quantized_phase(card)
    out["cli"] = precision_cli(card)
    out["seconds"] = time.perf_counter() - t0
    log(f"precision: phase in {out['seconds']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: MoE transformer layers on the train and serve paths


MOE_EXPERTS, MOE_TOP_K, MOE_CF, MOE_AUX = 8, 2, 1.25, 0.01
MOE_PARITY_B, MOE_PARITY_S = 2, 512


def moe_config(dtype: str = "bfloat16"):
    import dataclasses

    from deeplearning4j_tpu_torch.parallel.transformer import gpt2_small

    return dataclasses.replace(
        gpt2_small(max_len=TRAIN_SEQ, dtype=dtype), n_experts=MOE_EXPERTS,
        moe_top_k=MOE_TOP_K, moe_capacity_factor=MOE_CF,
        moe_aux_weight=MOE_AUX)


def moe_routing(cfg, params, tokens) -> dict:
    """The training route of every MoE layer on `tokens` (no grad): the
    fraction of (token, expert) assignments dropped past capacity and
    each expert's share of the kept assignments, by layer; and the
    load-balancing loss."""
    import torch

    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.kernels import flash_attention

    dropped, load = [], []
    with torch.no_grad():
        x = params["embed"][tokens] + params["pos"][None, :tokens.shape[1]]
        for layer in params["layers"]:
            q, k, v = tfm.qkv_proj(layer["attn"],
                                   tfm._layer_norm(layer["ln1"], x))
            x = x + tfm.out_proj(layer["attn"], flash_attention(q, k, v,
                                                                True))
            h = tfm._layer_norm(layer["ln2"], x)
            e_flat, _, _, keep, _ = tfm._moe_route(
                layer["moe"], h.reshape(-1, h.shape[-1]), cfg.moe_capacity_factor,
                cfg.moe_top_k)
            dropped.append(float(1 - keep.float().mean()))
            kept = torch.bincount(e_flat[keep > 0], minlength=cfg.n_experts)
            load.append((kept.float() / max(1, int(kept.sum()))).tolist())
            x = x + tfm._moe_dispatch(layer["moe"], h,
                                      cfg.moe_capacity_factor, cfg.moe_top_k)
        _, aux = tfm.apply(cfg, params, tokens, train=True,
                           return_aux=True)
    return {"dropped_fraction_by_layer": dropped,
            "dropped_fraction": sum(dropped) / len(dropped),
            "expert_load_by_layer": load, "aux_loss": float(aux)}


def moe_grad_parity(tree, tokens, targets) -> dict:
    """float32 at full width, B = 2, S = 512: the MoE loss (capacity
    dispatch and the load-balancing term) and every gradient through the
    flash kernels against the plain-attention forward on the card.  Each
    leaf's error is relative to its plain gradient's largest value; an
    expert's w1, b1, w2 and b2 are held expert by expert, every expert
    that received tokens (the others have no gradient on either path);
    a key bias's against its layer's query bias (its exact gradient is
    zero)."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import _master_f32
    from deeplearning4j_tpu_torch.tree import flatten_tree

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe_config("float32")
    params = _master_f32(tfm.params_from_numpy(tree, device="cuda"))
    flat = flatten_tree(params)
    names, leaves = list(flat), list(flat.values())
    tok = tokens[:MOE_PARITY_B, :MOE_PARITY_S]
    tgt = targets[:MOE_PARITY_B, :MOE_PARITY_S]
    loss_k = tfm.lm_loss(cfg, params, tok, tgt)
    grads_k = torch.autograd.grad(loss_k, leaves)
    logits, aux = tfm._forward(cfg, params, tok, tfm.attention, train=True,
                               return_aux=True)
    loss_p = -F.log_softmax(logits, dim=-1).gather(
        -1, tgt[..., None])[..., 0].mean() + cfg.moe_aux_weight * aux
    del logits
    grads_p = torch.autograd.grad(loss_p, leaves)
    by_name = dict(zip(names, grads_p))
    worst, worst_name, experts_held, experts_idle = 0.0, None, 0, 0
    for name, gk, gp in zip(names, grads_k, grads_p):
        if "//moe//" in name and not name.endswith("gate"):
            for e in range(gp.shape[0]):       # expert by expert
                scale = float(gp[e].abs().max())
                if scale == 0.0:
                    experts_idle += 1
                    if float(gk[e].abs().max()) != 0.0:
                        worst, worst_name = math.inf, f"{name}[{e}]"
                    continue
                experts_held += 1
                err = float((gk[e] - gp[e]).abs().max()) / scale
                if not math.isfinite(err) or err > worst:
                    worst, worst_name = err, f"{name}[{e}]"
            continue
        ref = by_name[name.replace("//bk", "//bq")]
        err = float((gk - gp).abs().max()) / float(ref.abs().max())
        if not math.isfinite(err) or err > worst:
            worst, worst_name = err, name
    loss_k, loss_p = float(loss_k.detach()), float(loss_p.detach())
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    out = {"batch": MOE_PARITY_B, "seq": MOE_PARITY_S,
           "loss_kernel": loss_k, "loss_plain": loss_p,
           "loss_rel_err": loss_err, "grad_max_rel_err": worst,
           "grad_worst_leaf": worst_name, "leaves": len(leaves),
           "expert_leaves_held": experts_held,
           "expert_leaves_without_tokens": experts_idle}
    if not loss_err <= 1e-3 or not worst <= 1e-3:
        raise AssertionError(f"moe: f32 kernels vs plain attention "
                             f"disagree: {out}")
    del params, grads_k, grads_p
    return out


def moe_dispatch_vs_dense() -> dict:
    """`_moe_dispatch` at capacity factor E (no drops) against the
    dense-masked `_moe_dense` on the card, f32, TF32 off, at one MoE
    layer of the phase's width over 2 x 1024 tokens (top-2): the largest
    difference relative to the largest output."""
    import torch

    from deeplearning4j_tpu_torch.parallel import transformer as tfm

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = moe_config("float32")
    rng = np.random.default_rng(11)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts

    def t(shape, scale):
        return torch.from_numpy((rng.standard_normal(shape) * scale).astype(
            np.float32)).cuda()

    p = {"gate": t((d, e), d ** -0.5), "w1": t((e, d, f), d ** -0.5),
         "b1": t((e, f), 0.1), "w2": t((e, f, d), f ** -0.5),
         "b2": t((e, d), 0.1)}
    x = t((2, TRAIN_SEQ, d), 1.0)
    with torch.no_grad():
        dense = tfm._moe_dense(p, x, cfg.moe_top_k)
        disp = tfm._moe_dispatch(p, x, float(e), cfg.moe_top_k)
    err = float((disp - dense).abs().max() / dense.abs().max())
    out = {"tokens": 2 * TRAIN_SEQ, "top_k": cfg.moe_top_k,
           "capacity_factor": float(e), "max_rel_err": err}
    if not err <= 1e-5:
        raise AssertionError(f"moe: dispatch at cf = E differs from the "
                             f"dense-masked oracle: {out}")
    return out


def moe_cli(card: str) -> dict:
    """``cli lm -experts 4 -moe-top-k 2`` on this repository's prose (the
    small default model, 1 epoch), then ``-generate`` from the saved
    directory: exit codes 0, ``n_experts`` in the saved config."""
    import glob
    import os
    import tempfile

    with tempfile.TemporaryDirectory(prefix="chip-smoke-moe-") as tmp:
        corpus = os.path.join(tmp, "corpus.txt")
        with open(corpus, "wb") as f:
            for path in ["README.md"] + sorted(glob.glob("docs/*.md")):
                with open(path, "rb") as src:
                    f.write(src.read())
        out_dir = os.path.join(tmp, "lm")
        base = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "lm",
                "-output", out_dir]
        t0 = time.perf_counter()
        train = subprocess.run(base + ["-input", corpus, "-experts", "4",
                                       "-moe-top-k", "2"],
                               capture_output=True, text=True, timeout=600)
        gen = subprocess.run(base + ["-generate", "The ", "-max-new", "32"],
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        saved = (json.loads(open(os.path.join(out_dir, "lm_config.json"))
                            .read())
                 if os.path.exists(os.path.join(out_dir, "lm_config.json"))
                 else {})
    if train.returncode or gen.returncode or saved.get("n_experts") != 4 \
            or saved.get("moe_top_k") != 2:
        raise AssertionError(
            f"moe: cli lm -experts 4 exited {train.returncode} / "
            f"{gen.returncode}, saved config {saved}:\n{train.stdout}\n"
            f"{train.stderr[-3000:]}\n{gen.stderr[-3000:]}")
    line = next((ln for ln in train.stdout.splitlines()
                 if ln.startswith("Trained")), "")
    log(f"moe: cli lm -experts 4 -moe-top-k 2: {line}; generate exit 0; "
        f"{wall:.1f} s ({card})")
    return {"trained": line, "n_experts": saved["n_experts"],
            "moe_top_k": saved["moe_top_k"], "wall_s": wall,
            "generated": gen.stdout.strip()[-80:]}


def moe_phase(card: str) -> dict:
    """``gpt2_small(max_len=1024)`` with 8 experts of top-2 (capacity
    factor 1.25, aux weight 0.01): the train phase's recipe for 2 + 5
    steps on one repeated batch (finite, falling losses; flash launches
    96 / 48 / 48 a step), its routing (drops and expert loads by layer,
    the load-balancing loss), f32 loss and gradients through the kernels
    against plain attention, dispatch at cf = E against the dense-masked
    oracle, the 12-request bf16 paged pool (ids by the greedy rule, B1 =
    n_layers x dispatches by width), one `generate` 4 x 128 + 32 (12
    flash launches), and ``cli lm -experts``."""
    import torch

    from deeplearning4j_tpu_torch.parallel import generation as gen
    from deeplearning4j_tpu_torch.parallel import kernels as fk
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        _master_f32,
        make_accum_train_step,
    )
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer
    from deeplearning4j_tpu_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    cfg = moe_config()
    tree = tfm.numpy_params(cfg, seed=0)
    n_params = sum(int(np.prod(a.shape)) for a in
                   tree_leaves(tree))
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    tokens, targets = data[:, :-1], data[:, 1:]
    params = _master_f32(tfm.params_from_numpy(tree, device="cuda"))
    mb = TRAIN_BATCH // TRAIN_ACCUM
    compute = tfm.map_tree(lambda a: a.detach().to(torch.bfloat16), params)
    routing_at_init = moe_routing(cfg, compute, tokens[:mb])
    del compute
    step, init_state = make_accum_train_step(cfg, lr=1e-3,
                                             accum=TRAIN_ACCUM,
                                             updater="adam")
    opt = init_state(params)
    losses = []
    for _ in range(TRAIN_WARMUP):
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counters = {"flash_fwd": fk.flash_forward.launches,
                "flash_bwd_dkv": fk.flash_bwd_dkv.launches,
                "flash_bwd_dq": fk.flash_bwd_dq.launches}
    for c in counters.values():
        c.reset()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(TRAIN_STEPS):
        ts = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    launches = {n: c.value for n, c in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    if not all(math.isfinite(x) for x in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"moe: losses {losses}")
    per_step = cfg.n_layers * TRAIN_ACCUM
    want = {"flash_fwd": 2 * per_step * TRAIN_STEPS,
            "flash_bwd_dkv": per_step * TRAIN_STEPS,
            "flash_bwd_dq": per_step * TRAIN_STEPS}
    if launches != want:
        raise AssertionError(f"moe: launches {launches}, expected {want}")
    compute = tfm.map_tree(lambda a: a.detach().to(torch.bfloat16), params)
    routing = moe_routing(cfg, compute, tokens[:mb])
    del compute, params, opt
    torch.cuda.empty_cache()
    out = {"card": card, "config": "gpt2_small(max_len=1024) with "
           f"n_experts={MOE_EXPERTS}, moe_top_k={MOE_TOP_K}, "
           f"moe_capacity_factor={MOE_CF}, moe_aux_weight={MOE_AUX}; bf16 "
           "compute, f32 masters, adam lr 1e-3", "parameters": n_params,
           "accum": TRAIN_ACCUM, "global_batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "warmup_steps": TRAIN_WARMUP,
           "steps": TRAIN_STEPS, "losses": losses, "step_ms": step_ms,
           "step_ms_mean": wall * 1e3 / TRAIN_STEPS,
           "tokens_per_s": TRAIN_BATCH * TRAIN_SEQ * TRAIN_STEPS / wall,
           "peak_memory_bytes": peak, "launches": launches,
           "launches_per_step": {n: v / TRAIN_STEPS
                                 for n, v in launches.items()},
           "routing_at_init": routing_at_init,
           "routing_after_training": routing}
    log(f"moe: train step {out['step_ms_mean']:.1f} ms, "
        f"{out['tokens_per_s']:.0f} tokens/s, peak {peak / 2**30:.2f} GiB, "
        f"losses {losses[0]:.4f} -> {losses[-1]:.4f}; at init aux "
        f"{routing_at_init['aux_loss']:.4f}, dropped "
        f"{routing_at_init['dropped_fraction']:.4f} of assignments; after "
        f"the 7 steps on one batch aux {routing['aux_loss']:.4f}, dropped "
        f"{routing['dropped_fraction']:.4f} ({card})")
    out["f32_parity"] = moe_grad_parity(tree, tokens, targets)
    log(f"moe: f32 kernels vs plain attention: loss rel err "
        f"{out['f32_parity']['loss_rel_err']:.3g}, worst gradient rel err "
        f"{out['f32_parity']['grad_max_rel_err']:.3g} "
        f"({out['f32_parity']['grad_worst_leaf']}; "
        f"{out['f32_parity']['expert_leaves_held']} expert leaves held, "
        f"{out['f32_parity']['expert_leaves_without_tokens']} without "
        f"tokens)")
    torch.cuda.empty_cache()
    out["dispatch_vs_dense"] = moe_dispatch_vs_dense()
    log(f"moe: dispatch at cf = E vs dense-masked: "
        f"{out['dispatch_vs_dense']['max_rel_err']:.3g}")
    torch.cuda.empty_cache()

    # serving: the serve phase's 12 requests on the bf16 paged pool
    params = tfm.params_from_numpy(tree, device="cuda", dtype=cfg.dtype)
    del tree
    check = greedy_checker(cfg, params)
    reqs = decode_requests(cfg)[:12]
    srv = ContinuousLMServer(cfg, params, slots=8, page_size=16,
                             prefill_chunk=16, device="cuda")
    try:
        with RouteRecorder(cfg.n_layers) as rec:
            # builds the dispatch entry and captures the programs with
            # the recorder's router inside them
            srv.warmup()
            rec.attach(srv)
            run = run_pool(srv, reqs, DECODE_NEW)
        ledger = srv.page_ledger()
    finally:
        srv.stop()
    if not ledger["balanced"]:
        raise AssertionError(f"moe: page ledger off: {ledger}")
    checks = [check(reqs[i][0], run["results"][i],
                    rec.routes(run["results"][i]))
              for i in range(len(reqs)) if reqs[i][1] == 0.0]
    out["serve"] = pool_summary(run, checks)
    log(f"moe: served 12 requests, {run['tokens_per_s']:.2f} tokens/s, "
        f"B1 launches by width {run['paged_launches_by_width']}, greedy "
        f"{checks_summary(checks)} ({card})")

    # whole-sequence decode: generate 4 x 128 + 32
    prompt = np.random.default_rng(7).integers(
        0, cfg.vocab_size, (GEN_BATCH, GEN_PROMPT))
    torch.cuda.synchronize()
    fk.flash_forward.launches.reset()
    paged_flash_attention.launches.reset()
    t0 = time.perf_counter()
    with RouteRecorder(cfg.n_layers) as rec:
        ids = rec.generate(lambda: gen.generate(
            cfg, params, prompt, GEN_NEW, device="cuda").tolist(), prompt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    flash = fk.flash_forward.launches.value
    if flash != cfg.n_layers or paged_flash_attention.launches.value:
        raise AssertionError(f"moe: generate made {flash} flash launches "
                             f"(want {cfg.n_layers}) and "
                             f"{paged_flash_attention.launches.value} "
                             f"paged ones")
    gen_checks = [check(prompt[b].tolist(), ids[b], rec.routes(ids[b]))
                  for b in range(GEN_BATCH)]
    out["generate"] = {"batch": GEN_BATCH, "prompt": GEN_PROMPT,
                       "new": GEN_NEW, "seconds": gen_s,
                       "flash_launches": flash,
                       "greedy": checks_summary(gen_checks)}
    log(f"moe: generate {GEN_BATCH} x {GEN_PROMPT} + {GEN_NEW} in "
        f"{gen_s:.3f} s, {flash} flash launches, greedy "
        f"{out['generate']['greedy']} ({card})")
    del params, check
    torch.cuda.empty_cache()
    out["cli"] = moe_cli(card)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 14: page mobility — shipping, preemption with host swap, the
# brownout ladder and session hibernation


MOB_REQUESTS, MOB_NEW = 8, 32


def pool_launch_check(name: str, srv, launches: int, by_width: dict) -> None:
    """A paged pool's B1 launches of one run = n_layers x its dispatches
    at each width (the counts were set to 0 just before the run)."""
    want = {w: srv.cfg.n_layers * n
            for w, n in srv.stats()["dispatch_widths"].items()}
    if by_width != want or launches != sum(want.values()) or not launches:
        raise AssertionError(f"mobility: {name} B1 launches {by_width} "
                             f"!= n_layers x dispatches by width {want}")


def balanced(name: str, srv) -> dict:
    ledger = srv.page_ledger()
    if not ledger["balanced"]:
        raise AssertionError(f"mobility: {name} page ledger off: {ledger}")
    return ledger


def concurrently(fns) -> list:
    """Run the thunks on threads; their results, or the first error."""
    results, errors = [None] * len(fns), []

    def run(i):
        try:
            results[i] = fns[i]()
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"{i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=run, args=(i,))
               for i in range(len(fns))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"requests failed: {errors}")
    return results


def ship_leg(cfg, params, check, card: str) -> dict:
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer
    from deeplearning4j_tpu_torch.serving.transfer import (
        deserialize_export,
        quantize_export,
        serialize_export,
    )
    from deeplearning4j_tpu_torch.ui.server import UiServer

    reqs = decode_requests(cfg)[:MOB_REQUESTS]
    kw = dict(slots=8, page_size=16, prefill_chunk=16, ship=True,
              device="cuda")
    pre = ContinuousLMServer(cfg, params, **kw)
    dec = ContinuousLMServer(cfg, params, **kw)
    out = {}
    try:
        pre.warmup()
        dec.warmup()
        torch.cuda.synchronize()
        counter = paged_flash_attention.launches
        counter.reset()
        t0 = time.perf_counter()
        exports = concurrently([lambda p=p: pre.prefill_export(p, MOB_NEW,
                                                               timeout=900)
                                for p, _, _ in reqs])
        torch.cuda.synchronize()
        prefill_s = time.perf_counter() - t0
        launches = {"prefill": {str(c): n for c, n in
                                counter.by_key().items()}}
        pool_launch_check("prefill pool", pre, counter.value,
                          launches["prefill"])
        ser_ms, de_ms, frames, sizes = [], [], [], []
        for ex in exports:
            ts = time.perf_counter()
            blob = serialize_export(ex)
            ser_ms.append((time.perf_counter() - ts) * 1e3)
            ts = time.perf_counter()
            frames.append(deserialize_export(blob))
            de_ms.append((time.perf_counter() - ts) * 1e3)
            sizes.append(len(blob))
        counter.reset()
        t0 = time.perf_counter()
        shipped = concurrently([lambda f=f: dec.admit_with_pages(
            f, timeout=900) for f in frames])
        torch.cuda.synchronize()
        decode_s = time.perf_counter() - t0
        launches["decode"] = {str(c): n for c, n in
                              counter.by_key().items()}
        pool_launch_check("decode pool", dec, counter.value,
                          launches["decode"])
        checks = [check(p, ids) for (p, _, _), ids in zip(reqs, shipped)]
        ledgers = {"prefill": balanced("prefill pool", pre),
                   "decode": balanced("decode pool", dec)}
        pre_ship, dec_ship = pre.stats()["ship"], dec.stats()["ship"]
        # the same requests decoded locally on the decode pool
        local = concurrently([lambda p=p: dec.generate(p, MOB_NEW,
                                                       timeout=900)
                              for p, _, _ in reqs])
        balanced("decode pool", dec)
    finally:
        pre.stop()
        dec.stop()
    # quantized frames: bytes and the dequantized pages' error, of the
    # bf16 frames and of the same pages as a float32 pool ships them.
    # int8 pages and one f32 scale per (layer, page, head) come to
    # 1/s + 4/(ps K s) of an exact frame of itemsize s: 0.254 for
    # float32 (held to JAX's 0.3) and 0.502 for bfloat16 (held to that)
    q_ratio = {"bfloat16": [], "float32": []}
    q_err = []
    for ex in exports:
        for name, frame in (("bfloat16", ex), ("float32", dataclasses.replace(
                ex, pages_k=ex.pages_k.float(), pages_v=ex.pages_v.float()))):
            q = deserialize_export(serialize_export(quantize_export(frame)))
            q_ratio[name].append(q.nbytes() / q.exact_nbytes())
            back = q.dequantized()
            for got, want in ((back.pages_k, frame.pages_k),
                              (back.pages_v, frame.pages_v)):
                flat_g = got.float().flatten(1, 2)[:, :ex.pos]
                flat_w = want.float().flatten(1, 2)[:, :ex.pos]
                q_err.append(float((flat_g - flat_w).abs().max()
                                   / flat_w.abs().max()))
    q_max = {k: max(v) for k, v in q_ratio.items()}
    bf16_limit = 0.5 + 2.0 / (16 * cfg.head_dim)
    if (q_max["float32"] > 0.3 or q_max["bfloat16"] > bf16_limit
            or max(q_err) > 1e-2):
        raise AssertionError(f"mobility: quantized frames at {q_max} of "
                             f"the exact bytes with page error "
                             f"{max(q_err):.4g} of the largest value "
                             f"(limits float32 0.3, bfloat16 "
                             f"{bf16_limit:.4f}, 1e-2)")
    ms_frame = (pre_ship["mean_ms"] + sum(ser_ms) / len(ser_ms)
                + sum(de_ms) / len(de_ms) + dec_ship["mean_ms"])
    same = sum(a == b for a, b in zip(shipped, local))
    out.update({
        "requests": len(reqs), "new": MOB_NEW, "prefill_s": prefill_s,
        "decode_s": decode_s,
        "decode_tokens_per_s": len(reqs) * MOB_NEW / decode_s,
        "frame_bytes_mean": sum(sizes) / len(sizes),
        "frame_bytes_max": max(sizes),
        "gather_ms_mean": pre_ship["mean_ms"],
        "serialize_ms_mean": sum(ser_ms) / len(ser_ms),
        "deserialize_ms_mean": sum(de_ms) / len(de_ms),
        "install_ms_mean": dec_ship["mean_ms"], "ms_per_frame": ms_frame,
        "quantized_bytes_ratio_max": q_max,
        "quantized_page_err_max": max(q_err),
        "shipped_equal_to_local": same, "ledgers": ledgers,
        "launches": launches,
        "greedy": checks_summary(checks)})
    log(f"mobility: shipped {len(reqs)} lanes, {ms_frame:.3f} ms a frame "
        f"(gather {pre_ship['mean_ms']:.3f}, serialize "
        f"{out['serialize_ms_mean']:.3f}, deserialize "
        f"{out['deserialize_ms_mean']:.3f}, install "
        f"{dec_ship['mean_ms']:.3f}), {out['frame_bytes_mean']:.0f} bytes "
        f"a frame, quantized {q_max} of exact (page error "
        f"{max(q_err):.4g}), {same} of {len(reqs)} equal to local decode, "
        f"greedy {out['greedy']} ({card})")

    # one /lm/prefill -> /lm/admit_pages round trip over HTTP
    ui = UiServer(port=0).serve_lm(cfg, params, **{
        k: v for k, v in kw.items() if k != "device"}, device="cuda").start()
    try:
        prompt = reqs[0][0]
        req = urllib.request.Request(
            ui.url + "/lm/prefill", data=json.dumps(
                {"prompt_ids": prompt, "max_new_tokens": MOB_NEW}).encode(),
            headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            blob = resp.read()
        req = urllib.request.Request(
            ui.url + "/lm/admit_pages", data=blob,
            headers={"Content-Type": "application/octet-stream"})
        with urllib.request.urlopen(req, timeout=600) as resp:
            http_ids = json.loads(resp.read())["ids"]
    finally:
        ui.stop()
    out["http"] = {"frame_bytes": len(blob),
                   "greedy": checks_summary([check(prompt, http_ids)])}
    log(f"mobility: POST /lm/prefill -> /lm/admit_pages: {len(blob)} bytes, "
        f"{out['http']['greedy']}")
    return out


def preempt_leg(cfg, params, check, card: str) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer

    rng = np.random.default_rng(13)
    victim = rng.integers(0, cfg.vocab_size, 200).tolist()
    urgent = rng.integers(0, cfg.vocab_size, 100).tolist()
    v_new, u_new = 300, MOB_NEW
    pages = -(-(len(victim) + v_new - 1) // 16)     # the victim fills it
    swap_cap = 64 << 20
    srv = ContinuousLMServer(cfg, params, slots=2, page_size=16,
                             pages=pages, prefill_chunk=16, preempt=True,
                             swap_bytes=swap_cap, swap_quantize=False,
                             device="cuda")
    res = {}
    try:
        srv.warmup()
        torch.cuda.synchronize()
        paged_flash_attention.launches.reset()
        t = threading.Thread(target=lambda: res.__setitem__(
            "victim", srv.generate(victim, v_new, priority="best_effort",
                                   timeout=900)))
        t.start()
        deadline = time.perf_counter() + 300
        while time.perf_counter() < deadline:     # mid-decode
            with srv._cond:
                s = srv._slots[0]
                if s.active and len(s.generated) >= 8:
                    break
            time.sleep(0.001)
        t0 = time.perf_counter()
        res["urgent"] = srv.generate(urgent, u_new, priority="interactive",
                                     timeout=900)
        urgent_s = time.perf_counter() - t0
        t.join(timeout=900)
        torch.cuda.synchronize()
        launches = {str(c): n for c, n in
                    paged_flash_attention.launches.by_key().items()}
        pool_launch_check("preempting pool", srv,
                          paged_flash_attention.launches.value, launches)
        stats = srv.stats()
        ledger = balanced("preempting pool", srv)
    finally:
        srv.stop()
    swap = stats["pressure"]["swap"]
    if (stats.get("preemptions", 0) < 1 or stats["swap"]["out"] < 1
            or stats["swap"]["in"] < 1 or swap["peak_bytes"] > swap_cap
            or "victim" not in res):
        raise AssertionError(f"mobility: preemption did not swap out and "
                             f"back within the cap: {stats}")
    checks = [check(victim, res["victim"]), check(urgent, res["urgent"])]
    out = {"pages": pages, "victim_new": v_new, "urgent_new": u_new,
           "preemptions": stats["preemptions"], "swap": stats["swap"],
           "swap_peak_bytes": swap["peak_bytes"], "swap_cap": swap_cap,
           "urgent_latency_s": urgent_s, "ledger": ledger,
           "launches": launches,
           "greedy": checks_summary(checks)}
    log(f"mobility: preempted {stats['preemptions']} best_effort lane(s), "
        f"swap {stats['swap']}, peak {swap['peak_bytes']} bytes of "
        f"{swap_cap}; the interactive request took {urgent_s:.3f} s; "
        f"greedy {out['greedy']} ({card})")

    # the brownout ladder: a burst on 2 slots, then idle until it is down
    srv = ContinuousLMServer(cfg, params, slots=2, page_size=16,
                             prefill_chunk=16, brownout=True, device="cuda")
    try:
        srv.warmup()
        burst = [(rng.integers(0, cfg.vocab_size, 32).tolist(), 0.0, 0)
                 for _ in range(16)]
        levels = []
        stop = threading.Event()

        def watch():
            while not stop.is_set():
                levels.append(srv.stats()["pressure"]["brownout"]["level"])
                time.sleep(0.005)

        watcher = threading.Thread(target=watch)
        watcher.start()
        concurrently([lambda p=p: srv.generate(p, 16, timeout=900)
                      for p, _, _ in burst])
        deadline = time.perf_counter() + 60
        while (srv.stats()["pressure"]["brownout"]["level"] > 0
               and time.perf_counter() < deadline):
            time.sleep(0.01)
        stop.set()
        watcher.join()
        ladder = srv.stats()["pressure"]["brownout"]
        balanced("brownout pool", srv)
    finally:
        srv.stop()
    if max(levels) < 1 or ladder["level"] != 0 or \
            ladder["transitions_down"] < 1:
        raise AssertionError(f"mobility: the ladder did not enter a level "
                             f"and step back down: {ladder}, levels seen "
                             f"{sorted(set(levels))}")
    out["brownout"] = {"burst": len(burst), "slots": 2,
                       "max_level": max(levels), "final": ladder}
    log(f"mobility: brownout burst of {len(burst)} on 2 slots: max level "
        f"{max(levels)}, back to {ladder['level']} "
        f"({ladder['transitions_up']} up, {ladder['transitions_down']} "
        f"down)")
    return out


def hibernate_leg(cfg, params, check, card: str) -> dict:
    import tempfile

    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer

    rng = np.random.default_rng(17)
    turn1 = rng.integers(0, cfg.vocab_size, 200).tolist()
    # a prompt cached beside the session, never hibernated: the sweep
    # must leave its chain in the radix tree
    beside = rng.integers(0, cfg.vocab_size, 120).tolist()
    faults = {"resets_while_running": 0, "breaker_failures": 0}

    def pool(state_dir, idle_s):
        srv = ContinuousLMServer(cfg, params, slots=2, page_size=16,
                                 prefill_chunk=16, hibernate_idle_s=idle_s,
                                 state_dir=state_dir, device="cuda")
        # a reset while the worker runs is the worker's catch-all after
        # a failed dispatch; start and stop reset with it down
        reset = srv._reset_pool_locked

        def counted():
            if srv._running:
                faults["resets_while_running"] += 1
            reset()

        srv._reset_pool_locked = counted
        if srv.breaker is not None:
            fail = srv.breaker.record_failure

            def failed(*a, **k):
                faults["breaker_failures"] += 1
                return fail(*a, **k)

            srv.breaker.record_failure = failed
        return srv

    def saved_on_repeat(srv):
        before = srv.stats().get("prefix_tokens_saved", 0)
        ids = srv.generate(beside, MOB_NEW, timeout=900)
        return ids, srv.stats().get("prefix_tokens_saved", 0) - before

    def wait_hibernated(srv, n):
        deadline = time.perf_counter() + 60
        while time.perf_counter() < deadline:
            if srv.stats().get("hibernate", {}).get("out", 0) >= n:
                return
            time.sleep(0.01)
        raise AssertionError(f"mobility: the idle sweep did not hibernate "
                             f"{n} session(s): {srv.stats()}")

    def turn(srv, prev, prompt, stats_before):
        """One turn whose prompt extends the previous turn's sequence
        `prev`: it must resume prev's hibernated whole pages (every
        position before prev's last token) and prefill only the rest."""
        ids = srv.generate(prompt, MOB_NEW, session_id="s1", timeout=900)
        st = srv.stats()
        saved = (st.get("prefix_tokens_saved", 0)
                 - stats_before.get("prefix_tokens_saved", 0))
        covered = (len(prev) - 1) // 16 * 16
        hib_in = (st["hibernate"]["in"]
                  - stats_before.get("hibernate", {}).get("in", 0))
        if hib_in != 1 or saved != covered:
            raise AssertionError(
                f"mobility: the turn did not resume its hibernated prefix: "
                f"{hib_in} resumed, {saved} prompt tokens from cache, "
                f"{covered} covered: {st}")
        return ids, st, len(prompt) - saved

    with tempfile.TemporaryDirectory(prefix="chip-smoke-hib-") as tmp:
        srv = pool(tmp, 0.2)
        try:
            srv.warmup()
            cached = srv.generate(beside, MOB_NEW, timeout=900)
            _, saved_unswept = saved_on_repeat(srv)
            out1 = srv.generate(turn1, MOB_NEW, session_id="s1",
                                timeout=900)
            wait_hibernated(srv, 1)
            again, saved_swept = saved_on_repeat(srv)
            if saved_swept != saved_unswept or again != cached:
                raise AssertionError(
                    f"mobility: after the sweep a prompt cached beside the "
                    f"session saved {saved_swept} prefix tokens, "
                    f"{saved_unswept} before it (ids equal: "
                    f"{again == cached})")
            turn2 = out1 + rng.integers(0, cfg.vocab_size, 24).tolist()
            t0 = time.perf_counter()
            out2, st2, fed2 = turn(srv, out1, turn2, srv.stats())
            turn2_s = time.perf_counter() - t0
            wait_hibernated(srv, 2)
            balanced("hibernating pool", srv)
        finally:
            srv.stop()                      # a clean stop flushes to disk
        fresh = pool(tmp, 30.0)
        try:
            turn3 = out2 + rng.integers(0, cfg.vocab_size, 24).tolist()
            t0 = time.perf_counter()
            out3, st3, fed3 = turn(fresh, out2, turn3, {})
            turn3_s = time.perf_counter() - t0
            disk = st3["hibernation"]["store"]["disk"]
            balanced("fresh pool", fresh)
        finally:
            fresh.stop()
    if any(faults.values()):
        raise AssertionError(f"mobility: the hibernating pools failed a "
                             f"dispatch: {faults}")
    checks = [check(turn1, out1), check(turn2, out2), check(turn3, out3),
              check(beside, cached)]
    out = {"turn_prompts": [len(turn1), len(turn2), len(turn3)],
           "beside_saved_before_and_after_the_sweep": [saved_unswept,
                                                       saved_swept],
           "faults": faults,
           "turn2_fed": fed2, "turn3_fed_after_restart": fed3,
           "turn2_s": turn2_s, "turn3_s": turn3_s,
           "hibernate": st2["hibernate"], "restart_disk": disk,
           "greedy": checks_summary(checks)}
    log(f"mobility: hibernated session: turn 2 fed {fed2} of "
        f"{len(turn2)} prompt tokens ({turn2_s:.3f} s), a fresh server on "
        f"the same state_dir fed {fed3} of {len(turn3)} ({turn3_s:.3f} s), "
        f"bytes ratio {st2['hibernate']['bytes_ratio']}; a prompt cached "
        f"beside it saved {saved_swept} prefix tokens after the sweep "
        f"({saved_unswept} before), no reset, no failure; greedy "
        f"{out['greedy']} ({card})")
    return out


def mobility_phase(card: str) -> dict:
    """GPT-2-small in bf16 on paged pools (page 16, chunk 16): KV page
    shipping between a prefill and a decode pool on the one card (8
    requests through `prefill_export`, the wire frame and
    `admit_with_pages`, and one HTTP round trip), a best_effort lane
    preempted by an interactive arrival and swapped out to the host,
    the brownout ladder under a burst, and a two-turn session that
    hibernates, resumes, and resumes again in a fresh server on the
    same state_dir.  Every output by the greedy rule; B1 launches =
    n_layers x dispatches by width on each pool; ledgers balanced."""
    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import (
        gpt2_small,
        numpy_params,
        params_from_numpy,
    )

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_small(max_len=1024)
    params = params_from_numpy(numpy_params(cfg, seed=0), device="cuda",
                               dtype=cfg.dtype)
    check = greedy_checker(cfg, params)
    out = {"card": card, "config": "gpt2_small(max_len=1024), bfloat16, "
           "page 16, chunk 16"}
    out["ship"] = ship_leg(cfg, params, check, card)
    out["preempt"] = preempt_leg(cfg, params, check, card)
    out["hibernate"] = hibernate_leg(cfg, params, check, card)
    out["phase_s"] = time.perf_counter() - t_phase
    del params, check
    torch.cuda.empty_cache()
    return out


def lstm_f16_entry(lstm: dict, precision) -> dict:
    """The LSTM kernel's float16 keys: the timed train shape (with
    residuals, what `fit` launches) and its launches in the precision
    phase's float16 char-LSTM `fit_batch` steps."""
    t = lstm["timing"]["float16_train"]
    return {"dtype": "float16", "route": t["route"], "ms": t["kernel_ms"],
            "step_us": t["step_us"], "plain_ms": t["plain_ms"],
            "library_ms": t["library_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "max_rel_err": lstm["worst_rel_err"]["float16"],
            "max_abs_err": lstm["worst_abs_err"]["float16"],
            "inference_ms": lstm["timing"]["float16_inference"]["kernel_ms"],
            "launches": (precision["f16_char_lstm"]["launches"]
                         if precision else 0),
            "launches_per_step": (precision["f16_char_lstm"]
                                  ["launches_per_step"]
                                  if precision else None)}


def decode_launches(decode, kernel: str):
    """The decode phase's counts of a kernel's launches on its paths, each
    read from a run driven with the counts set to 0 just before it."""
    if decode is None:
        return None
    if kernel == "paged":
        spec = decode["spec_ngram"]
        return {"speculating_pool": spec["paged_launches"],
                "speculating_pool_dispatches": spec["dispatches"],
                "speculating_pool_by_width": spec["paged_launches_by_width"],
                "plain_pool": decode["spec_off"]["paged_launches"],
                "plain_pool_by_width": decode["spec_off"][
                    "paged_launches_by_width"],
                "dense_pool": decode["dense"]["paged_launches"]}
    return {"generate_per_call": decode["generate"][
        "flash_launches_per_call"],
        "beam_search_per_call": decode["beam"]["flash_launches"]}


def fleet_launches(fleet, key: str):
    """The fleet phase's counts of one kernel, by leg."""
    if fleet is None:
        return None
    lm, dis = fleet["lm"], fleet["disagg"]
    if key == "b2_launches":
        return {"lm_fleet_storm": lm["b2_launches"],
                "top_k_request": lm["top_k_b2_launches"],
                "beam_request": lm["beam_b2_launches"]}
    return {"lm_fleet_storm": lm[key],
            "lm_fleet_dispatches_by_width": lm["dispatches_by_width"],
            "disagg_both": dis["both"][key], "disagg_split": dis["split"][key],
            "disagg_split_dispatches_by_width":
                dis["split"]["dispatches_by_width"]}


def mobility_launches(mobility):
    """The mobility phase's B1 launches by query width on each pool,
    each read from a run driven with the counts set to 0 just before."""
    if mobility is None:
        return None
    return {"prefill_pool": mobility["ship"]["launches"]["prefill"],
            "decode_pool": mobility["ship"]["launches"]["decode"],
            "preempting_pool": mobility["preempt"]["launches"]}


# ---------------------------------------------------------------------------
# phase 15: the word-embedding family (BASELINE config #3)

# bench.py's Word2Vec row (bench_word2vec), run as it runs offline
W2V_BENCH = dict(vector_length=128, window=5, negative=5, epochs=1,
                 batch_size=4096)
W2V_BENCH_TOKENS, W2V_BENCH_VOCAB = 120_000, 2_000
# word2vec's demo-word.sh settings over a synthetic corpus of text8's
# vocabulary size (71 290 words at min-count 5); text8 itself is not in
# the repository
W2V_TEXT8 = dict(vector_length=200, window=8, negative=25, subsample=1e-4,
                 epochs=1, batch_size=4096)
W2V_TEXT8_TOKENS, W2V_TEXT8_VOCAB = 2_000_000, 71_290
W2V_TEXT8_REDUCED = (
    "synthetic zipf corpus (text8 is not in the repository): 2 000 000 "
    "tokens over 71 290 words, not text8's 17 005 207; 1 epoch, not "
    "demo-word.sh's 15; skip-gram (the port's only mode), not -cbow 1; "
    "min-count 1")
FRUIT = ["apple", "banana", "cherry", "mango", "grape"]
TECH = ["cpu", "gpu", "ram", "disk", "cache"]


def zipf_sentences(n_tokens: int, vocab: int, seed: int = 0) -> list:
    """bench.py's offline Word2Vec corpus (`bench_word2vec`): zipf word
    ids from ``default_rng(seed)``, cut into sentences of 8-23 words."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    zipf = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, size=n_tokens, p=zipf / zipf.sum())
    sentences, k = [], 0
    while k < n_tokens:
        n = int(rng.integers(8, 24))
        sentences.append(" ".join(words[i] for i in ids[k:k + n]))
        k += n
    return sentences


def topic_corpus(n: int = 600, seed: int = 0) -> list:
    """tests/test_nlp.py's two-topic corpus."""
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(FRUIT if i % 2 == 0 else TECH, size=6))
            for i in range(n)]


def timed_fit_parts(w2v):
    """Wrap the model's pair generation (on the fit's producer thread) to
    record (seconds, pairs) per epoch, and its step to record the host
    clock at the first step's start and the last step's end."""
    make_pairs, step = w2v._make_pairs, w2v._step
    spent, marks = [], []

    def pairs(encoded, rng):
        t0 = time.perf_counter()
        out = make_pairs(encoded, rng)
        spent.append((time.perf_counter() - t0, len(out)))
        return out

    def stepped(*args):
        if not marks:
            marks.append(time.perf_counter())
        out = step(*args)
        marks[1:] = [time.perf_counter()]
        return out
    w2v._make_pairs, w2v._step = pairs, stepped
    return spent, marks


def w2v_row(name: str, sentences: list, n_tokens: int, knobs: dict,
            card: str, profile: bool):
    """One warm-up fit, then a timed fit (the warm second fit keeps its
    vocabulary and weights, as bench.py's does); words/sec is the corpus
    tokens over the timed fit's seconds.  Returns (row, model)."""
    import torch

    from deeplearning4j_tpu_torch.nlp import Word2Vec

    w2v = Word2Vec(**knobs)
    t0 = time.perf_counter()
    w2v.fit(sentences)
    warm_s = time.perf_counter() - t0
    spent, marks = timed_fit_parts(w2v)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()     # what earlier phases hold
    t0 = time.perf_counter()
    w2v.fit(sentences)                   # ends in the tables' copy back
    t1 = time.perf_counter()
    fit_s = t1 - t0
    pairs = sum(p for _, p in spent)
    steps = sum(-(-p // knobs["batch_size"]) for _, p in spent)
    tables = [a for a in (w2v.syn0, w2v.syn1, w2v.syn1neg) if a is not None]
    row = {"name": name, "settings": knobs, "tokens": n_tokens,
           "vocab": len(w2v.vocab), "words_per_s": n_tokens / fit_s,
           "fit_s": fit_s, "warmup_fit_s": warm_s, "pairs": pairs,
           "steps": steps, "ms_per_step": fit_s * 1e3 / max(steps, 1),
           # host clock: tokenizing, encoding and the first epoch's pairs
           # before the first step; the step loop; the sync and copy back
           "before_first_step_s": marks[0] - t0,
           "step_loop_s": marks[1] - marks[0],
           "loop_ms_per_step": (marks[1] - marks[0]) * 1e3 / max(steps, 1),
           "after_last_step_s": t1 - marks[1],
           "pairgen_host_s": sum(s for s, _ in spent),
           "peak_device_bytes": torch.cuda.max_memory_allocated(),
           "peak_above_start_bytes": (torch.cuda.max_memory_allocated()
                                      - resident),
           "table_bytes": sum(a.nbytes for a in tables),
           "tables_finite": bool(all(np.isfinite(a).all() for a in tables)),
           "card": card}
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        with prof:
            t0 = time.perf_counter()
            w2v.fit(sentences)
            wall = time.perf_counter() - t0
        row["profile"] = device_breakdown(prof, wall, steps)
    log(f"nlp: {name}: {row['words_per_s']:.1f} words/s ({n_tokens} tokens "
        f"in {fit_s:.3f} s; vocab {row['vocab']}, {pairs} pairs, {steps} "
        f"steps, {row['ms_per_step']:.4f} ms a step of the fit, "
        f"{row['loop_ms_per_step']:.4f} of the step loop, "
        f"{row['before_first_step_s']:.3f} s before the first step, pair "
        f"generation {row['pairgen_host_s']:.3f} s on the host, peak "
        f"{row['peak_above_start_bytes']} bytes above the fit's start, "
        f"tables finite "
        f"{row['tables_finite']}"
        + (f", device idle {row['profile']['device_idle_share']:.3f}"
           if profile else "") + f") ({card})")
    return row, w2v


U32 = 2.0 ** -24                 # float32 unit roundoff
ETA = 2.0 ** -149                # float32 underflow: the least subnormal
# ulps allowed to one float32 evaluation of exp, log, pow, sigmoid or
# logsigmoid (CUDA documents at most 2 for expf, 1 for logf, 4 for powf;
# the sigmoids compose one exp, one add and a divide or a log)
EVAL_ULPS = 8


def gamma(n):
    """Higham's gamma_n = n u / (1 - n u): the relative bound of n float32
    roundings (elementwise on a tensor of counts)."""
    return n * U32 / (1.0 - n * U32)


def prod_err(a, ea, b, eb):
    """Bound of |fl32(a' b') - a b| for |a' - a| <= ea, |b' - b| <= eb
    (a, b float64 tensors or numbers)."""
    a, b = abs(a), abs(b)
    return a * eb + b * ea + ea * eb + U32 * (a + ea) * (b + eb) + ETA


def sigmoid_err(x, dx):
    """Bound of |fl32 sigmoid(x') - sigmoid(x)| for |x' - x| <= dx: the
    slope is at most 1/4, the evaluation within EVAL_ULPS ulps."""
    import torch

    return (0.25 * dx + EVAL_ULPS * U32 * (torch.sigmoid(x) + 0.25 * dx)
            + ETA)


def logsigmoid_err(x, dx):
    """Bound of |fl32 logsigmoid(x') - logsigmoid(x)| for |x' - x| <= dx:
    the slope is at most 1; the evaluation within EVAL_ULPS ulps of the
    result, and absolutely (log of 1 + exp(-|x|) rounded near 1)."""
    import torch.nn.functional as F

    return dx + EVAL_ULPS * U32 * (F.logsigmoid(x).abs() + dx + 1.0)


def sum_err(mag, err, n: int):
    """Bound of a float32 sum of `n` terms, each within `err` of its
    float64 value, whose float64 magnitudes sum to `mag`: gamma_n (mag +
    err) + err (sums of tensors, or numbers)."""
    return gamma(n) * (mag + err) + err


def alpha_err(src, esrc, lr: float):
    """``index_add_(..., alpha=lr)`` adds fl32(src' fl32(lr)): the bound of
    its distance from src lr, for |src' - src| <= esrc."""
    return abs(lr) * esrc + gamma(2) * abs(lr) * (src.abs() + esrc) + ETA


def scatter_err(x0, adds):
    """Per element of a table `x0` (float64) that took the float32 adds
    (rows, d64, e), each within e of its float64 value d64: the count of
    adds n into each row and the bound gamma_{n+1} (|x0| + sum (|d64| +
    e)) + sum e of the float32 scatter in any order against the float64
    one (one rounding more than the adds, for an add fused with alpha's
    product)."""
    import torch

    n = torch.zeros(x0.shape[0], dtype=torch.float64)
    mag, err = x0.abs().clone(), torch.zeros_like(x0)
    for rows, d64, e in adds:
        n.index_add_(0, rows, torch.ones(rows.shape[0], dtype=torch.float64))
        mag.index_add_(0, rows, d64.abs() + e)
        err.index_add_(0, rows, e)
    shape = (-1,) + (1,) * (x0.dim() - 1)
    return n.reshape(shape), gamma(n.reshape(shape) + 1) * mag + err


def hs_step_bounds(tables, hs, inputs, targets, lr: float) -> dict:
    """The a-priori float32 error of each add of `hs_step` (every pair
    valid) and of its loss, from the step's own arithmetic on the float64
    values of the same inputs: dots of length D, the sigmoids, the
    MAX_EXP clip (either side when the dot's bound straddles it), dh a
    dot of length L, dw one product, alpha.  Returns {"adds": [(table,
    rows, bound)], "loss": bound}."""
    import torch
    import torch.nn.functional as F

    from deeplearning4j_tpu_torch.nlp.word2vec import MAX_EXP

    syn0, syn1 = (t.detach().cpu().double() for t in tables)
    points, codes, lengths = (a.cpu() for a in hs)
    inputs, targets = inputs.cpu(), targets.cpu()
    h, p = syn0[inputs], points[targets]
    mask = (torch.arange(points.shape[1])[None, :]
            < lengths[targets][:, None]).double()
    w = syn1[p]
    d_len, l_len = h.shape[1], p.shape[1]
    sign = 1.0 - 2.0 * codes[targets].double()
    x = sign * torch.einsum("bd,bld->bl", h, w)          # sign * dots
    dx = gamma(d_len) * torch.einsum("bd,bld->bl", h.abs(), w.abs())
    loss = sum_err(float((-F.logsigmoid(x) * mask).abs().sum()),
                   float((logsigmoid_err(x, dx) * mask).sum()), x.numel())
    g = sign * torch.sigmoid(-x) * mask
    eg = sigmoid_err(-x, dx) * mask
    near = (x.abs() - MAX_EXP).abs() <= dx
    eg = torch.where(near, g.abs() + eg,
                     torch.where(x.abs() < MAX_EXP, eg, torch.zeros_like(eg)))
    g = torch.where(x.abs() < MAX_EXP, g, torch.zeros_like(g))
    dh = torch.einsum("bl,bld->bd", g, w)
    edh = (torch.einsum("bl,bld->bd", eg, w.abs())
           + gamma(l_len) * torch.einsum("bl,bld->bd", g.abs() + eg,
                                         w.abs())
           + l_len * ETA)
    dw = g[:, :, None] * h[:, None, :]
    edw = prod_err(g[:, :, None], eg[:, :, None], h[:, None, :], 0.0)
    return {"adds": [(0, inputs, alpha_err(dh, edh, lr)),
                     (1, p.reshape(-1),
                      alpha_err(dw, edw, lr).reshape(-1, d_len))],
            "loss": loss}


def neg_step_bounds(tables, inputs, targets, negs, lr: float) -> dict:
    """`hs_step_bounds` for `neg_step` (every pair valid): the positive and
    negative dots of length D, the sigmoids, dh a dot of length K + 1
    with one rounding more for its final add, dpos and dneg one product
    each, alpha."""
    import torch
    import torch.nn.functional as F

    syn0, syn1 = (t.detach().cpu().double() for t in tables)
    inputs, targets, negs = inputs.cpu(), targets.cpu(), negs.cpu()
    h, pos, neg = syn0[inputs], syn1[targets], syn1[negs]
    d_len, k_len = h.shape[1], negs.shape[1]
    pdot = (h * pos).sum(1)
    dp = gamma(d_len) * (h.abs() * pos.abs()).sum(1)
    ndot = torch.einsum("bd,bkd->bk", h, neg)
    dn = gamma(d_len) * torch.einsum("bd,bkd->bk", h.abs(), neg.abs())
    keep = (negs != targets[:, None]).double()
    mag = float(F.logsigmoid(pdot).abs().sum()
                + (F.logsigmoid(-ndot) * keep).abs().sum())
    err = float(logsigmoid_err(pdot, dp).sum()
                + (logsigmoid_err(-ndot, dn) * keep).sum())
    loss = sum_err(mag, err, pdot.numel() + ndot.numel() + 1)
    gp, egp = torch.sigmoid(-pdot), sigmoid_err(-pdot, dp)
    gn, egn = -torch.sigmoid(ndot) * keep, sigmoid_err(ndot, dn) * keep
    dh = gp[:, None] * pos + torch.einsum("bk,bkd->bd", gn, neg)
    edh = (egp[:, None] * pos.abs()
           + torch.einsum("bk,bkd->bd", egn, neg.abs())
           + gamma(k_len + 2) * ((gp + egp)[:, None] * pos.abs()
                                 + torch.einsum("bk,bkd->bd", gn.abs() + egn,
                                                neg.abs()))
           + (k_len + 2) * ETA)
    dpos = gp[:, None] * h
    epos = prod_err(gp[:, None], egp[:, None], h, 0.0)
    dneg = gn[:, :, None] * h[:, None, :]
    eneg = prod_err(gn[:, :, None], egn[:, :, None], h[:, None, :], 0.0)
    return {"adds": [(0, inputs, alpha_err(dh, edh, lr)),
                     (1, targets, alpha_err(dpos, epos, lr)),
                     (1, negs.reshape(-1),
                      alpha_err(dneg, eneg, lr).reshape(-1, d_len))],
            "loss": loss}


def glove_step_bounds(tables, ii, jj, xx, lr: float, x_max: float,
                      alpha: float) -> dict:
    """`hs_step_bounds` for `glove_step` (every entry valid; `tables` are
    w, wc, b, bc and their AdaGrad accumulators): diff a dot of length D
    plus three terms and a log, fx a divide and a pow, the products, the
    accumulators' g^2 adds, then each parameter add -lr g / sqrt(H + eps)
    with H the accumulator after its scatter, whose own bound is the
    scatter's (`scatter_err`)."""
    import torch

    from deeplearning4j_tpu_torch.nlp.glove import ADAGRAD_EPS

    w, wc, b, bc, *acc = (t.detach().cpu().double() for t in tables)
    ii, jj, xx = ii.cpu(), jj.cpu(), xx.cpu().double()
    d_len = w.shape[1]
    logx = torch.log(xx)
    diff = (w[ii] * wc[jj]).sum(1) + b[ii] + bc[jj] - logx
    ediff = (gamma(d_len + 3) * ((w[ii] * wc[jj]).abs().sum(1) + b[ii].abs()
                                 + bc[jj].abs() + logx.abs())
             + EVAL_ULPS * U32 * logx.abs() + ETA)
    base = (xx / x_max) ** alpha
    fx = base.clamp(max=1.0)
    efx = (EVAL_ULPS + 2 * alpha + 2) * U32 * base + ETA
    e = fx * diff
    ee = prod_err(fx, efx, diff, ediff)
    loss = sum_err(float((0.5 * e * diff).abs().sum()),
                   float(0.5 * prod_err(e, ee, diff, ediff).sum()), e.numel())
    grads = ((e[:, None] * wc[jj], prod_err(e[:, None], ee[:, None],
                                            wc[jj], 0.0)),
             (e[:, None] * w[ii], prod_err(e[:, None], ee[:, None],
                                           w[ii], 0.0)),
             (e, ee), (e, ee))
    adds = []
    for k, (rows, (g, eg)) in enumerate(zip((ii, jj, ii, jj), grads)):
        eg2 = prod_err(g, eg, g, eg)
        adds.append((4 + k, rows, eg2))
        big_h = acc[k].index_add(0, rows, g * g)[rows]
        _, eh = scatter_err(acc[k], [(rows, g * g, eg2)])
        y = big_h + ADAGRAD_EPS
        ey = eh[rows] + gamma(2) * (y + eh[rows])
        s = y.sqrt()
        y_low = (y - ey).clamp_min(ADAGRAD_EPS / 2)
        es = ey / (y_low.sqrt() + s)
        es = es + U32 * (s + es)
        num, enum = lr * g, lr * eg + gamma(2) * lr * (g.abs() + eg)
        q = num / s
        dq = (enum * s + num.abs() * es) / (s * (s - es).clamp_min(1e-300))
        eq = dq + U32 * (q.abs() + dq) + ETA
        adds.append((k, rows, eq))
    return {"adds": adds, "loss": loss}


def recorded_step(run, tables, device, dtype: str) -> dict:
    """Run `run(copies)` — one in-place scatter step, returning its loss —
    on copies of the float32 `tables` cast to `dtype` on `device`, with
    every ``index_add_`` into those copies recorded: for each, the table,
    the rows and the values it added (as float64 on the host).  Returns
    {"loss", "tables" (after the step), "adds"}."""
    import torch

    dt = getattr(torch, dtype)
    copies = [t.detach().to(device=device, dtype=dt).clone() for t in tables]
    slot = {id(t): i for i, t in enumerate(copies)}
    adds = []
    plain = torch.Tensor.index_add_

    def recording(self, dim, index, source, *, alpha=1):
        i = slot.get(id(self))
        if i is not None:
            adds.append((i, index.cpu(), (source * alpha).detach().cpu()
                         .double().reshape((index.shape[0],)
                                           + tuple(self.shape[1:]))))
        return plain(self, dim, index, source, alpha=alpha)

    torch.Tensor.index_add_ = recording
    try:
        loss = float(run(copies))
    finally:
        torch.Tensor.index_add_ = plain
    return {"loss": loss, "tables": copies, "adds": adds}


def _ratio(err, bound) -> float:
    """The worst err / bound; 0 where both are 0, and a NaN reads as inf."""
    import torch

    r = torch.where(bound > 0, err / bound.clamp_min(1e-300),
                    torch.where(err == 0, 0.0, math.inf))
    return float(torch.nan_to_num(r, nan=math.inf, posinf=math.inf).max())


def scatter_bound_ratio(tables, got: dict, ref: dict, bounds: dict) -> dict:
    """How far one float32 run of a scatter step (`got`, from
    `recorded_step`) lies from the float64 recompute `ref` of the same step
    on the same float32 inputs `tables`, as worst ratios of error to the
    a-priori bounds `bounds` (from the step's `*_step_bounds`):

    - "updates": each value the run added, against its float64 value,
      within the step's bound e for it;
    - "tables": a touched element, x0 plus the n updates its row took,
      within gamma_{n+1} (|x0| + sum (|d64| + e)) + sum e (the float32
      summation in any order, of updates within e) plus one ulp of the
      row's largest float64 value; an untouched row unchanged;
    - "loss": within the step's loss bound plus one ulp.

    Nothing in a bound is measured from the run under test, so a wrong
    update fails "updates", and an add lost or doubled fails "tables".
    Summation order (atomics on the card, sequential on the CPU) moves a
    result inside these bounds and never past them.  A NaN reads as inf."""
    import torch

    if not len(got["adds"]) == len(ref["adds"]) == len(bounds["adds"]):
        raise AssertionError(f"{len(got['adds'])} adds recorded, "
                             f"{len(bounds['adds'])} bounded")
    updates = []
    for (i, rows, d), (_, _, d64), (j, brows, e) in zip(
            got["adds"], ref["adds"], bounds["adds"]):
        if i != j or not torch.equal(rows, brows.cpu()):
            raise AssertionError("the recorded adds are not the bounded ones")
        updates.append(_ratio((d - d64).abs(), e))
    ratios = []
    for i, x0 in enumerate(tables):
        x0 = x0.detach().cpu().double()
        want = ref["tables"][i].detach().cpu().double()
        n, bound = scatter_err(x0, [(rows, d64, e) for (_, _, d64), (j, rows,
                                                                     e)
                                    in zip(ref["adds"], bounds["adds"])
                                    if j == i])
        row_max = (want.abs().amax(dim=tuple(range(1, want.dim())))
                   if want.dim() > 1 else want.abs())
        ulp = torch.from_numpy(np.spacing(row_max.float().numpy())).double()
        bound = torch.where(n > 0, bound + ulp.reshape(n.shape),
                            torch.zeros_like(bound))
        g = got["tables"][i].detach().cpu().double()
        ratios.append(_ratio((g - want).abs(), bound))
    loss64 = ref["loss"]
    loss_bound = bounds["loss"] + float(np.spacing(np.float32(abs(loss64))))
    loss_err = abs(got["loss"] - loss64)
    return {"updates": max(updates), "tables": max(ratios),
            "per_table": ratios,
            "loss": (loss_err / loss_bound if loss_err == loss_err
                     else math.inf)}


def step_card_vs_cpu(run, tables, bounds) -> dict:
    """One scatter step on the CPU and on the card from the same float32
    `tables`, both held to the float64 recompute by `scatter_bound_ratio`
    under the step's a-priori `bounds` (TF32 off: the bounds model IEEE
    float32 products)."""
    import torch

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = recorded_step(run, tables, "cpu", "float64")
        runs = {dev: recorded_step(run, tables, dev, "float32")
                for dev in ("cpu", "cuda")}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    out = {f"{leg}_ratio": scatter_bound_ratio(tables, runs[dev], ref,
                                               bounds)
           for leg, dev in (("cpu", "cpu"), ("card", "cuda"))}
    out["worst_ratio"] = max(out[k][m] for k in ("cpu_ratio", "card_ratio")
                             for m in ("updates", "tables", "loss"))
    return out


def w2v_steps_card_vs_cpu(hs_model, neg_model, pairs) -> dict:
    """The port's HS and NEG steps on the card and on the CPU from the same
    tables and batch (the bench row's first 4096 pairs, zipf-skewed, so
    rows repeat); the HS batch's first pair saturates (|dot| >= 6); the
    NEG leg feeds both the same negatives.  The tables are the HS row's
    trained ones and, for NEG, a seeded random syn1neg (the NEG row's own
    tables are not finite, see `tables_finite`).  Each leg is held to
    the float64 recompute by its a-priori float32 bounds
    (`step_card_vs_cpu`)."""
    import torch

    from deeplearning4j_tpu_torch.nlp import word2vec as tw

    b = W2V_BENCH["batch_size"]
    inputs = torch.from_numpy(pairs[:b, 0]).long()
    targets = torch.from_numpy(pairs[:b, 1]).long()
    out = {"batch": b, "distinct_inputs": int(inputs.unique().numel()),
           "distinct_targets": int(targets.unique().numel())}
    hs_cpu = tuple(a.cpu() for a in hs_model._hs)
    syn0 = torch.from_numpy(hs_model.syn0.copy())
    syn1 = torch.from_numpy(hs_model.syn1.copy())
    p = hs_cpu[0][targets[0], :hs_cpu[2][targets[0]]]
    syn0[inputs[0]] = 1.0
    syn1[p] = 1.0
    dot0 = float((syn1[p] @ syn0[inputs[0]]).abs().min())

    def hs_run(t):
        dev, dt = t[0].device, t[0].dtype
        return tw.hs_step(t[0], t[1], tuple(a.to(dev) for a in hs_cpu),
                          inputs.to(dev), targets.to(dev), 0.025,
                          torch.ones(b, dtype=dt, device=dev))

    out["hs"] = dict(step_card_vs_cpu(
        hs_run, [syn0, syn1],
        hs_step_bounds([syn0, syn1], hs_cpu, inputs, targets, 0.025)),
        saturated_dot=dot0)
    gen = torch.Generator().manual_seed(0)
    negs = neg_model._neg_table.cpu()[torch.randint(
        0, neg_model._neg_table.shape[0], (b, neg_model.negative),
        generator=gen)]
    syn0 = torch.from_numpy(hs_model.syn0.copy())
    syn1n = torch.from_numpy(np.random.default_rng(2).standard_normal(
        hs_model.syn0.shape).astype(np.float32) * 0.1)

    def neg_run(t):
        dev, dt = t[0].device, t[0].dtype
        return tw.neg_step(t[0], t[1], inputs.to(dev), targets.to(dev),
                           negs.to(dev), 0.025,
                           torch.ones(b, dtype=dt, device=dev))

    out["neg"] = dict(step_card_vs_cpu(
        neg_run, [syn0, syn1n],
        neg_step_bounds([syn0, syn1n], inputs, targets, negs, 0.025)),
        collisions=int((negs == targets[:, None]).sum()))
    return out


def glove_step_card_vs_cpu() -> dict:
    """One GloVe AdaGrad step at the bench's width (V 2000, D 128, B 4096)
    on the card and on the CPU: duplicate rows, a warm accumulator; held
    to the float64 recompute by its a-priori float32 bounds."""
    import torch

    from deeplearning4j_tpu_torch.nlp.glove import glove_step

    rng = np.random.default_rng(1)
    v, d, b = W2V_BENCH_VOCAB, W2V_BENCH["vector_length"], 4096
    params = [rng.standard_normal((v, d)).astype(np.float32) * 0.1,
              rng.standard_normal((v, d)).astype(np.float32) * 0.1,
              rng.standard_normal(v).astype(np.float32) * 0.1,
              rng.standard_normal(v).astype(np.float32) * 0.1]
    ada = [rng.random(np.shape(p)).astype(np.float32) for p in params]
    ii = torch.from_numpy(rng.integers(0, 200, b))
    jj = torch.from_numpy(rng.integers(0, v, b))
    xx = torch.from_numpy(rng.random(b).astype(np.float32) * 50 + 0.5)

    def run(t):
        dev, dt = t[0].device, t[0].dtype
        return glove_step(tuple(t[:4]), tuple(t[4:]), ii.to(dev),
                          jj.to(dev), xx.to(device=dev, dtype=dt),
                          torch.ones(b, dtype=dt, device=dev), 0.05, 100.0,
                          0.75)

    tables = [torch.from_numpy(a) for a in params + ada]
    return step_card_vs_cpu(run, tables, glove_step_bounds(
        tables, ii, jj, xx, 0.05, 100.0, 0.75))


# ParagraphVectors at tests/test_nlp.py's settings (HS, batch 512) is
# chaotic in the summation order of its scatter-adds: each batch adds ~50
# updates into each label's row at once, and on the CPU a random order
# can predict a wrong label (the CPU's own order predicts right;
# tests/test_torch_nlp.py test_label_prediction_against_the_summation_order).
# CUDA's index_add_ adds in atomic order, so that fit is recorded; the
# labels are held at batch 128 (HS) and with NEG at batch 512, where every
# order tried on the CPU predicts right.
PV_HELD = {"hs_batch_128": dict(batch_size=128),
           "neg_batch_512": dict(negative=5)}


# the topic corpus's Word2Vec (HS and NEG) and GloVe settings
NLP_W2V = dict(vector_length=24, window=3, epochs=5, seed=1, batch_size=512,
               learning_rate=0.025)
NLP_GLOVE = dict(vector_length=16, window=4, epochs=30, seed=3, x_max=10.0)


def nlp_quality() -> dict:
    """tests/test_nlp.py's behaviours on the card: Word2Vec HS and NEG
    separate the two topics, GloVe's epoch losses fall, ParagraphVectors
    predicts each topic's label (PV_HELD; the test's own settings are
    recorded)."""
    from deeplearning4j_tpu_torch.nlp import Glove, ParagraphVectors, Word2Vec

    corpus = topic_corpus()
    out = {}
    for neg in (0, 5):
        w = Word2Vec(**NLP_W2V, negative=neg)
        w.fit(corpus)
        out[f"w2v_{'neg' if neg else 'hs'}"] = {
            "within": w.similarity("apple", "banana"),
            "across": w.similarity("apple", "gpu"),
            "nearest_cpu": w.words_nearest("cpu", top_n=4)}
    g = Glove(**NLP_GLOVE)
    g.fit(corpus)
    out["glove"] = {"first_loss": g.losses[0], "last_loss": g.losses[-1],
                    "within": g.similarity("apple", "cherry"),
                    "across": g.similarity("apple", "ram")}
    labels = ["fruit" if i % 2 == 0 else "tech" for i in range(len(corpus))]
    out["paragraph_vectors"] = {}
    for name, knobs in {"test_settings_recorded": {}, **PV_HELD}.items():
        pv = ParagraphVectors(**{**dict(
            vector_length=24, window=3, epochs=5, seed=2, batch_size=512,
            learning_rate=0.025), **knobs})
        pv.fit_labelled(corpus, labels)
        out["paragraph_vectors"][name] = {
            "fruit": pv.predict(["apple", "banana", "grape"]),
            "tech": pv.predict(["cpu", "disk", "cache"])}
    return out


def nlp_phase(card: str, profile: bool = False) -> dict:
    import torch

    from deeplearning4j_tpu_torch.nlp import Word2Vec

    t_phase = time.perf_counter()
    bench = zipf_sentences(W2V_BENCH_TOKENS, W2V_BENCH_VOCAB)
    neg_row, neg_model = w2v_row("bench_neg", bench, W2V_BENCH_TOKENS,
                                 W2V_BENCH, card, profile)
    hs_row, hs_model = w2v_row("bench_hs", bench, W2V_BENCH_TOKENS,
                               dict(W2V_BENCH, negative=0), card, profile)
    t0 = time.perf_counter()
    text8 = zipf_sentences(W2V_TEXT8_TOKENS, W2V_TEXT8_VOCAB)
    corpus_s = time.perf_counter() - t0
    text8_row, _ = w2v_row("text8_scale", text8, W2V_TEXT8_TOKENS,
                           W2V_TEXT8, card, profile)
    text8_row.update(corpus_build_s=corpus_s, reduced=W2V_TEXT8_REDUCED)

    pairs = Word2Vec._make_pairs(          # the unwrapped method
        neg_model, [neg_model.vocab.encode(s.split()) for s in bench[:400]],
        np.random.default_rng(0))
    steps = w2v_steps_card_vs_cpu(hs_model, neg_model, pairs)
    glove = glove_step_card_vs_cpu()
    hs, neg = steps["hs"], steps["neg"]
    legs = {"hs": hs, "neg": neg, "glove": glove}
    for name, leg in legs.items():
        log(f"nlp: {name} step at B 4096, D 128, card and CPU float32 vs "
            f"the float64 recompute, worst error / a-priori bound: "
            + "; ".join(f"{side} updates {leg[side + '_ratio']['updates']:.3g}"
                        f", tables {leg[side + '_ratio']['tables']:.3g}, "
                        f"loss {leg[side + '_ratio']['loss']:.3g}"
                        for side in ("card", "cpu")))
    log(f"nlp: HS saturated dot {hs['saturated_dot']:.1f}; NEG "
        f"{neg['collisions']} collisions")
    worst = {name: leg["worst_ratio"] for name, leg in legs.items()}
    if not all(r <= 1.0 for r in worst.values()):   # a NaN reads as inf
        raise AssertionError(f"nlp: a step leaves its float32 bound "
                             f"(worst error / bound {worst})")
    if not 6.0 <= hs["saturated_dot"]:
        raise AssertionError("nlp: the HS batch holds no saturated pair")

    # on the HS row: the NEG row's tables are NaN, and NaN != NaN
    def fresh_fit():
        return Word2Vec(**dict(W2V_BENCH, negative=0)).fit(bench).syn0
    first, second = fresh_fit(), fresh_fit()
    bitwise = bool(np.array_equal(first, second))
    seeded_diff = float(np.abs(first - second).max())
    log(f"nlp: two identically seeded card fits of the bench HS row bitwise "
        f"equal: {bitwise}, max abs difference {seeded_diff:.3g} (recorded, "
        f"not required)")

    quality = nlp_quality()
    for name in ("w2v_hs", "w2v_neg"):
        q = quality[name]
        if not (q["within"] > q["across"] + 0.2
                and set(q["nearest_cpu"]) <= set(TECH) - {"cpu"}):
            raise AssertionError(
                f"nlp: {name} does not separate the topics: {q}")
    g = quality["glove"]
    if not g["last_loss"] < g["first_loss"]:
        raise AssertionError(f"nlp: GloVe's losses do not fall: {g}")
    for name in PV_HELD:
        pv = quality["paragraph_vectors"][name]
        if pv != {"fruit": "fruit", "tech": "tech"}:
            raise AssertionError(
                f"nlp: ParagraphVectors ({name}) predicts {pv}")
    log(f"nlp: quality on the two-topic corpus: {quality}")
    torch.cuda.empty_cache()
    return {"rows": [neg_row, hs_row, text8_row], "steps": steps,
            "glove_step": glove,
            "seeded_hs_fits_bitwise_equal": bitwise,
            "seeded_hs_fits_max_abs_diff": seeded_diff, "quality": quality,
            "phase_s": time.perf_counter() - t_phase, "card": card}


# ---------------------------------------------------------------------------
# phase 16: the LM server's operations plane over real HTTP

# the -tenants JSON of the phase: a weighted interactive tenant with an
# SLO, and a metered batch tenant (500 tokens/s, a burst of 1000)
OPS_TENANTS = ('{"interactive": {"weight": 4, "slo_ms": 250}, '
               '"batch": {"weight": 1, "rate": 500, "burst": 1000}}')
OPS_NEW = 64                 # new tokens a request
OPS_FLOOD = 16               # batch requests of the flood
OPS_BREAKER = dict(breaker_threshold=3, breaker_cooldown_s=0.5)
OPS_TIMEOUT_S = 300          # every HTTP exchange ends within this
PROM_LINE = (r"^[a-zA-Z_:][a-zA-Z0-9_:]*"
             r"(\{([a-zA-Z_][a-zA-Z0-9_]*=\"([^\"\\]|\\.)*\",?)*\})? "
             r"(-?[0-9.e+-]+|[+-]Inf|NaN)$")


class InjectedDispatchFault(RuntimeError):
    """The chaos hook's dispatch failure."""


class ChaosDispatch:
    """Wraps a pool's dispatch entry (`srv._step`): the next `fail`
    calls raise `InjectedDispatchFault` on the card's worker thread, the
    rest dispatch.  The hook lives here, never in the package."""

    def __init__(self, srv):
        self.fail = 0
        self.raised = 0
        self.real = srv._step
        srv._step = self

    def __call__(self, *args):
        if self.fail > 0:
            self.fail -= 1
            self.raised += 1
            raise InjectedDispatchFault("chaos: injected dispatch fault")
        return self.real(*args)


def http_json(url: str, path: str, payload, rid: str) -> dict:
    """POST JSON; the status, headers, body and the client's send and
    receive stamps (perf_counter: the server runs in this process)."""
    req = urllib.request.Request(
        url + path, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json", "X-Request-Id": rid})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=OPS_TIMEOUT_S) as resp:
            code, hdrs, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as e:
        code, hdrs, raw = e.code, dict(e.headers), e.read()
    return {"rid": rid, "status": code, "headers": hdrs,
            "body": json.loads(raw), "t_send": t0,
            "t_end": time.perf_counter()}


def http_get(url: str, path: str):
    try:
        with urllib.request.urlopen(url + path,
                                    timeout=OPS_TIMEOUT_S) as resp:
            return resp.status, resp.read().decode()
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode()


def sse_request(url: str, payload, rid: str, stop_after=None) -> dict:
    """POST a ``stream: true`` request and read its events as they come:
    the tokens (with the time of the first), the ``done`` ids and any
    ``error`` event.  With `stop_after` the client closes its socket
    after that many tokens (a disconnect)."""
    import http.client
    import urllib.parse

    u = urllib.parse.urlsplit(url)
    conn = http.client.HTTPConnection(u.hostname, u.port,
                                      timeout=OPS_TIMEOUT_S)
    out = {"rid": rid, "tokens": [], "done": None, "error": None,
           "t_first": None}
    try:
        out["t_send"] = time.perf_counter()
        conn.request("POST", "/lm/generate",
                     json.dumps(dict(payload, stream=True)).encode(),
                     {"Content-Type": "application/json",
                      "X-Request-Id": rid})
        resp = conn.getresponse()
        out.update(status=resp.status,
                   ctype=resp.getheader("Content-Type"),
                   echoed=resp.getheader("X-Request-Id"))
        if resp.status != 200:
            out["body"] = json.loads(resp.read())
            return out
        event = None
        while True:
            line = resp.readline()
            if not line:
                break
            line = line.decode().rstrip("\n")
            if line.startswith("event: "):
                event = line[len("event: "):]
            elif line.startswith("data: "):
                data = json.loads(line[len("data: "):])
                if event is None:
                    if out["t_first"] is None:
                        out["t_first"] = time.perf_counter()
                    if data["index"] != len(out["tokens"]):
                        raise AssertionError(f"ops: stream {rid} skipped "
                                             f"an index: {data}")
                    out["tokens"].append(data["token"])
                    if stop_after and len(out["tokens"]) >= stop_after:
                        break
                elif event == "done":
                    out["done"] = data["ids"]
                elif event == "error":
                    out["error"] = data["error"]
            elif not line:
                event = None
    finally:
        out["t_end"] = time.perf_counter()
        conn.close()
    return out


def prom_samples(text: str) -> dict:
    """Every sample line of a Prometheus text scrape, checked against
    the format, by series; raises on a line that does not parse."""
    import re

    line_re = re.compile(PROM_LINE)
    out = {}
    for line in text.splitlines():
        if line.startswith("# HELP ") or line.startswith("# TYPE "):
            continue
        if not line_re.match(line):
            raise AssertionError(f"ops: /metrics line is not Prometheus "
                                 f"text: {line!r}")
        series, value = line.rsplit(" ", 1)
        out[series] = float(value)
    return out


def percentile_ms(xs, q: float) -> float:
    xs = sorted(xs)
    return 1e3 * xs[min(len(xs) - 1, max(0, math.ceil(q * len(xs)) - 1))]


def ops_streams(url, srv, reqs, check, card: str) -> tuple:
    """The 12 requests streamed from 12 threads (tenant interactive,
    greedy): each stream's tokens equal its ``done`` ids and hold the
    greedy rule; B1 launches counted by width over the run against
    n_layers x its dispatches; then the same requests without streaming,
    and the share of equal answers."""
    from deeplearning4j_tpu_torch.parallel.kernels import flash_forward
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )
    import torch

    widths0 = dict(srv.stats()["dispatch_widths"])
    torch.cuda.synchronize()
    paged_flash_attention.launches.reset()
    flash_forward.launches.reset()
    streams = concurrently([
        (lambda i=i: sse_request(
            url, {"prompt_ids": reqs[i], "max_new_tokens": OPS_NEW,
                  "tenant": "interactive"}, f"ops-stream-{i}"))
        for i in range(len(reqs))])
    torch.cuda.synchronize()
    launches = paged_flash_attention.launches.value
    by_width = {str(c): n for c, n in sorted(
        paged_flash_attention.launches.by_key().items())}
    flash = flash_forward.launches.value
    widths = srv.stats()["dispatch_widths"]
    delta = {w: n - widths0.get(w, 0) for w, n in widths.items()
             if n - widths0.get(w, 0)}
    want = {w: srv.cfg.n_layers * n for w, n in delta.items()}
    if by_width != want or launches != sum(want.values()) or not launches:
        raise AssertionError(f"ops: B1 launches by width {by_width} != "
                             f"n_layers x dispatches by width {want}")
    checks = []
    for prompt, s in zip(reqs, streams):
        if s["status"] != 200 or s["ctype"] != "text/event-stream":
            raise AssertionError(f"ops: stream {s['rid']} answered "
                                 f"{s['status']} {s.get('body')}")
        if s["error"] is not None or s["done"] is None:
            raise AssertionError(f"ops: stream {s['rid']} ended with "
                                 f"{s['error']!r}")
        if s["echoed"] != s["rid"]:
            raise AssertionError(f"ops: stream {s['rid']} echoed "
                                 f"{s['echoed']}")
        if (s["done"] != prompt + s["tokens"]
                or len(s["tokens"]) != OPS_NEW):
            raise AssertionError(f"ops: stream {s['rid']}: the token "
                                 f"events do not make the done ids")
        checks.append(check(prompt, s["done"]))
    plain = concurrently([
        (lambda i=i: http_json(
            url, "/lm/generate", {"prompt_ids": reqs[i],
                                  "max_new_tokens": OPS_NEW,
                                  "tenant": "interactive"},
            f"ops-plain-{i}")) for i in range(len(reqs))])
    for r in plain:
        if r["status"] != 200 or r["headers"].get("X-Request-Id") != \
                r["rid"]:
            raise AssertionError(f"ops: {r['rid']} answered {r['status']} "
                                 f"{r['body']}")
    same = sum(s["done"] == r["body"]["ids"] for s, r in zip(streams,
                                                              plain))
    t0 = min(s["t_send"] for s in streams)
    t1 = max(s["t_end"] for s in streams)
    ttft = [s["t_first"] - s["t_send"] for s in streams]
    out = {"streams": len(streams),
           "ttft_p50_ms": percentile_ms(ttft, 0.50),
           "ttft_p99_ms": percentile_ms(ttft, 0.99),
           "streamed_tokens_per_s": sum(len(s["tokens"])
                                        for s in streams) / (t1 - t0),
           "wall_s": t1 - t0,
           "equal_to_unstreamed_share": same / len(streams),
           "b1_launches": launches, "b1_launches_by_width": by_width,
           "dispatches_by_width": delta, "b2_launches": flash,
           **checks_summary(checks)}
    log(f"ops: 12 streams: TTFT p50 {out['ttft_p50_ms']:.1f} ms, p99 "
        f"{out['ttft_p99_ms']:.1f} ms, {out['streamed_tokens_per_s']:.1f} "
        f"streamed tokens/s; equal to the unstreamed answer "
        f"{same}/{len(streams)}; B1 launches by width {by_width}, B2 "
        f"{flash} ({card})")
    return out, streams + plain


def wait_idle(srv, timeout: float = 60.0) -> float:
    """Poll until no slot is active and nothing is queued; the time."""
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        with srv._cond:
            if not any(s.active for s in srv._slots) and not srv._queue:
                return time.perf_counter()
        time.sleep(0.005)
    raise AssertionError("ops: the pool did not go idle")


def ops_disconnect(url, srv, reqs) -> tuple:
    """Two streams close their sockets after 4 tokens: both requests
    are abandoned, and after the next admit round every slot is free and
    the page ledger balances."""
    shed0 = srv.stats()["shed"]
    cut = concurrently([
        (lambda i=i: sse_request(
            url, {"prompt_ids": reqs[i][:140], "max_new_tokens": 256,
                  "tenant": "interactive"}, f"ops-cut-{i}", stop_after=4))
        for i in range(2)])
    if any(c["status"] != 200 for c in cut):
        raise AssertionError(f"ops: a disconnecting stream answered "
                             f"{[(c['status'], c.get('body')) for c in cut]}")
    t_idle = wait_idle(srv)
    for c in cut:
        c["t_end"] = t_idle      # the server's side ends after the client's
    ledger = srv.page_ledger()
    shed = srv.stats()["shed"] - shed0
    if not ledger["balanced"] or shed != 2 or any(
            len(c["tokens"]) != 4 for c in cut):
        raise AssertionError(f"ops: disconnects: shed {shed}, ledger "
                             f"{ledger}")
    log(f"ops: 2 streams closed after 4 tokens: abandoned, slots free, "
        f"pages balanced ({ledger['in_use']} in use by the radix cache)")
    return {"abandoned": shed, "ledger": ledger}, cut


def ops_flood(url, srv, reqs) -> tuple:
    """16 batch requests (128-token prompts + 64 new: cost 192 each
    against a bucket of 1000 refilling at 500/s) beside 4 interactive
    ones: some batch requests are 429s with a Retry-After no smaller
    than their bucket's refill time, no interactive request is, and the
    /metrics ledger reads admitted + throttled = sent for batch."""
    import re

    rng = np.random.default_rng(7)
    vocab = srv.cfg.vocab_size
    batch = [rng.integers(0, vocab, 128).tolist() for _ in range(OPS_FLOOD)]
    fns = [(lambda i=i: http_json(
        url, "/lm/generate", {"prompt_ids": batch[i],
                              "max_new_tokens": OPS_NEW,
                              "tenant": "batch"}, f"ops-flood-{i}"))
           for i in range(OPS_FLOOD)]
    fns += [(lambda i=i: http_json(
        url, "/lm/generate", {"prompt_ids": reqs[i],
                              "max_new_tokens": OPS_NEW,
                              "tenant": "interactive"}, f"ops-ia-{i}"))
            for i in range(4)]
    res = concurrently(fns)
    flood, ia = res[:OPS_FLOOD], res[OPS_FLOOD:]
    if any(r["status"] != 200 for r in ia):
        raise AssertionError(f"ops: an interactive request was refused "
                             f"during the flood: {[r['status'] for r in ia]}")
    throttled = [r for r in flood if r["status"] == 429]
    served = [r for r in flood if r["status"] == 200]
    if not throttled or len(throttled) + len(served) != OPS_FLOOD:
        raise AssertionError(f"ops: flood answered "
                             f"{[r['status'] for r in flood]}")
    for r in throttled:
        m = re.search(r"retry in ([\d.]+)s", r["body"]["error"])
        header = int(r["headers"]["Retry-After"])
        if m is None or header < float(m.group(1)) or \
                r["body"]["retry_after_s"] != header:
            raise AssertionError(f"ops: a 429's Retry-After {header} is "
                                 f"not its bucket's refill: {r['body']}")
    samples = prom_samples(http_get(url, "/metrics")[1])
    reqs_b = samples.get(
        'serving_lm_tenant_requests_total{plane="lm",tenant="batch"}', 0)
    thr_b = samples.get(
        'serving_lm_tenant_throttled_total{plane="lm",tenant="batch"}', 0)
    ledger = srv.stats()["tenancy"]["batch"]
    if (reqs_b + thr_b != OPS_FLOOD
            or ledger["admitted"] + ledger["throttled"] != OPS_FLOOD
            or thr_b != len(throttled)):
        raise AssertionError(f"ops: batch ledger {reqs_b} + {thr_b} (and "
                             f"{ledger}) != {OPS_FLOOD} sent")
    out = {"batch_sent": OPS_FLOOD, "batch_served": len(served),
           "batch_throttled": len(throttled),
           "retry_after_s": sorted({int(r["headers"]["Retry-After"])
                                    for r in throttled}),
           "interactive_served": len(ia), "tenancy": srv.stats()["tenancy"]}
    log(f"ops: flood: {len(served)} batch served, {len(throttled)} 429s "
        f"(Retry-After {out['retry_after_s']} s), 4/4 interactive served")
    return out, res


def breaker_gauge(url) -> float:
    return prom_samples(http_get(url, "/metrics")[1])[
        'serving_breaker_state{plane="lm"}']


def ops_breaker(url, srv, reqs) -> tuple:
    """The chaos hook fails the next 3 dispatches on the card: the
    breaker opens, a request gets a 503 with Retry-After, /readyz is
    503; after the cooldown a probe closes it.  The /metrics gauge reads
    0 closed, 1 open, 2 half-open, 0 closed."""
    chaos = ChaosDispatch(srv)
    gauge = [breaker_gauge(url)]
    try:
        failed = []
        for i in range(3):
            chaos.fail = 1
            failed.append(http_json(
                url, "/lm/generate", {"prompt_ids": reqs[i][:40],
                                      "max_new_tokens": 8},
                f"ops-chaos-{i}"))
        if [r["status"] for r in failed] != [400] * 3 or not all(
                "InjectedDispatchFault" in r["body"]["error"]
                for r in failed) or chaos.raised != 3:
            raise AssertionError(f"ops: chaos requests answered "
                                 f"{[(r['status'], r['body']) for r in failed]}")
        gauge.append(breaker_gauge(url))
        refused = http_json(url, "/lm/generate",
                            {"prompt_ids": reqs[0][:40],
                             "max_new_tokens": 8}, "ops-open")
        ready_open = http_get(url, "/readyz")[0]
        if (refused["status"] != 503
                or int(refused["headers"].get("Retry-After", 0)) < 1
                or "circuit breaker open" not in refused["body"]["error"]
                or ready_open != 503):
            raise AssertionError(f"ops: open breaker answered "
                                 f"{refused['status']} {refused['body']}, "
                                 f"/readyz {ready_open}")
        time.sleep(OPS_BREAKER["breaker_cooldown_s"] + 0.1)
        ready_half = http_get(url, "/readyz")[0]     # commits half-open
        gauge.append(breaker_gauge(url))
        probe = http_json(url, "/lm/generate",
                          {"prompt_ids": reqs[0][:40], "max_new_tokens": 8},
                          "ops-probe")
        gauge.append(breaker_gauge(url))
    finally:
        srv._step = chaos.real
    stats = srv.stats()
    if (probe["status"] != 200 or ready_half != 200
            or gauge != [0.0, 1.0, 2.0, 0.0]
            or stats["breaker_state"] != "closed"
            or stats["breaker_opens"] != 1):
        raise AssertionError(f"ops: breaker: gauge {gauge}, probe "
                             f"{probe['status']}, stats "
                             f"{stats['breaker_state']}")
    if not srv.page_ledger()["balanced"]:
        raise AssertionError("ops: the page ledger is off after the "
                             "breaker")
    log(f"ops: breaker opened after 3 injected faults, answered 503 "
        f"(Retry-After {refused['headers']['Retry-After']} s), closed on "
        f"a probe; gauge {gauge}")
    return {"faults": chaos.raised, "gauge": gauge,
            "retry_after_s": int(refused["headers"]["Retry-After"]),
            "opens": stats["breaker_opens"]}, failed + [refused, probe]


def ops_traces(url, sent) -> dict:
    """One trace for every admitted request id the phase sent, none for
    a request refused at admission (429, 503); spans ordered, non-negative
    and inside the client's send and receive stamps."""
    status, body = http_get(url, "/trace/recent")
    traces = json.loads(body)["traces"]
    by_id = {}
    for t in traces:
        by_id.setdefault(t["request_id"], []).append(t)
    for r in sent:
        got = by_id.get(r["rid"], [])
        refused = r.get("status") in (429, 503)
        if len(got) != (0 if refused else 1):
            raise AssertionError(f"ops: {len(got)} traces for "
                                 f"{r['rid']} ({r.get('status')})")
        if refused:
            continue
        tr = got[0]
        spans = tr["spans"]
        names = [s["name"] for s in spans]
        if names not in (["queue_wait", "decode"], ["queue_wait"]):
            raise AssertionError(f"ops: {r['rid']} spans {names}")
        prev = -math.inf
        for s in spans:
            if s["dur_s"] < 0 or s["t0_s"] < prev:
                raise AssertionError(f"ops: {r['rid']} spans out of order")
            prev = s["t0_s"] + s["dur_s"]
        if not (r["t_send"] <= tr["t0_s"]
                and tr["t0_s"] + tr["dur_s"] <= r["t_end"]):
            raise AssertionError(f"ops: {r['rid']}'s trace lies outside "
                                 f"its request")
    statuses = {}
    for t in traces:
        statuses[t["status"]] = statuses.get(t["status"], 0) + 1
    log(f"ops: /trace/recent: one trace for each of "
        f"{sum(r.get('status') not in (429, 503) for r in sent)} admitted "
        f"requests ({statuses})")
    return {"traces": len(traces), "statuses": statuses}


def ops_scrape(url) -> dict:
    status, text = http_get(url, "/metrics")
    samples = prom_samples(text)
    families = {line.split()[2] for line in text.splitlines()
                if line.startswith("# TYPE ")}
    need = {"serving_requests_total", "serving_lm_ttft_seconds",
            "serving_lm_decode_tokens_total", "serving_breaker_state",
            "serving_lm_tenant_requests_total",
            "serving_lm_tenant_throttled_total",
            "serving_lm_tenant_slo_burn_rate", "server_uptime_seconds"}
    if status != 200 or need - families:
        raise AssertionError(f"ops: /metrics lacks {need - families}")
    return {"lines": len(text.splitlines()), "series": len(samples),
            "families": len(families)}


def ops_train_metrics(card: str) -> dict:
    """``cli train -metrics-port 0`` (mnist-mlp on a seeded 784-feature
    CSV, mixed precision, chunks of 4, telemetry every 4 steps) with its
    endpoint scraped once before the run stops it: the step counter
    equals the steps taken."""
    import re
    import tempfile

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.obs import http as obs_http

    rows, batch, epochs = 1024, 64, 2
    scraped = {}
    real_stop = obs_http.MetricsServer.stop

    def stop(self):
        scraped["text"] = http_get(self.url, "/metrics")[1]
        real_stop(self)

    with tempfile.TemporaryDirectory() as tmp:
        rng = np.random.default_rng(0)
        labels = np.arange(rows) % 10
        x = rng.random((rows, 784)).astype(np.float32) * 0.1
        x[np.arange(rows), labels * 78] += 1.0
        csv = f"{tmp}/mnist.csv"
        np.savetxt(csv, np.column_stack([x, labels]), delimiter=",",
                   fmt="%.3f")
        obs_http.MetricsServer.stop = stop
        try:
            t0 = time.perf_counter()
            rc = cli.main(["train", "-input", csv, "-model",
                           "zoo:mnist-mlp", "-output", f"{tmp}/out",
                           "-epochs", str(epochs), "-batch", str(batch),
                           "-precision", "mixed", "-chunk", "4",
                           "-metrics-port", "0", "-metrics-interval", "4"])
            wall = time.perf_counter() - t0
        finally:
            obs_http.MetricsServer.stop = real_stop
    samples = prom_samples(scraped["text"])
    steps = samples['train_steps_total{job="train"}']
    want = epochs * -(-rows // batch)
    if rc != 0 or steps != want or not math.isfinite(
            samples['train_loss{job="train"}']):
        raise AssertionError(f"ops: train -metrics-port counted {steps} "
                             f"steps of {want} (rc {rc})")
    out = {"steps": steps, "loss": samples['train_loss{job="train"}'],
           "loss_scale": samples['train_loss_scale{job="train"}'],
           "examples_per_s": samples[
               'train_examples_per_sec{job="train"}'],
           "wall_s": wall, "card": card}
    log(f"ops: train -metrics-port: {int(steps)} steps counted of {want}, "
        f"loss {out['loss']:.4f}, loss scale {out['loss_scale']:g} ({card})")
    return out


def ops_phase(card: str) -> dict:
    """The serve phase's model over real HTTP through `UiServer.serve_lm`
    with tenants and a breaker: 12 streams, 2 disconnects, a flood of a
    metered tenant, the breaker's open / 503 / probe cycle, the scrape
    and the traces, then ``train -metrics-port``."""
    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import (
        gpt2_small,
        numpy_params,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.ui.server import UiServer

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = gpt2_small(max_len=1024)
    params = params_from_numpy(numpy_params(cfg, seed=0), device="cuda",
                               dtype=cfg.dtype)
    check = greedy_checker(cfg, params)
    reqs = [p for p, _, _ in decode_requests(cfg)[:12]]
    ui = UiServer(port=0).serve_lm(
        cfg, params, slots=8, page_size=16, prefill_chunk=16,
        tenants=OPS_TENANTS, device="cuda", **OPS_BREAKER).start()
    srv = ui.state.lm_server
    out = {"card": card, "config": "gpt2_small(max_len=1024), bfloat16, "
           "8 slots, page 16, chunk 16", "tenants": json.loads(OPS_TENANTS),
           **OPS_BREAKER}
    sent = []
    try:
        out["warm_programs"] = srv.warmup()
        out["streams"], r = ops_streams(ui.url, srv, reqs, check, card)
        sent += r
        out["disconnect"], r = ops_disconnect(ui.url, srv, reqs)
        sent += r
        out["flood"], r = ops_flood(ui.url, srv, reqs)
        sent += r
        out["breaker"], r = ops_breaker(ui.url, srv, reqs)
        sent += r
        wait_idle(srv)
        out["scrape"] = ops_scrape(ui.url)
        out["traces"] = ops_traces(ui.url, sent)
        ledger = srv.page_ledger()
        if not ledger["balanced"]:
            raise AssertionError(f"ops: page ledger off: {ledger}")
    finally:
        ui.stop()
    del params, check
    torch.cuda.empty_cache()
    out["train_metrics"] = ops_train_metrics(card)
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 17: classifier serving (the ServingEngine, /model/predict, cli serve)

CLS_LADDER = (1, 8, 16, 32)          # bench.py bench_serving's ladder
CLS_CONC, CLS_TOTAL = 16, 640        # its concurrency; 40 requests a client
CLS_RTOL = 1e-5                      # f32 replies vs net.output alone
LSTM_LADDER = (1, 8, 32)             # the char-LSTM engine, no length buckets
LSTM_CLIENTS, LSTM_T = 48, 64
# bf16 vs f32 probabilities over 80 classes (about 0.0125 each): the limit
# is 4x the bf16 error the plain CPU path shows on these rows (1.13e-3);
# the argmax is held wherever the f32 top-2 gap exceeds LSTM_GAP, at no
# fewer than LSTM_HELD_SHARE of the served positions (29 % on the CPU)
LSTM_TOL, LSTM_GAP, LSTM_HELD_SHARE = 5e-3, 5e-3, 0.1
INT8_ROWS, INT8_AGREE = 256, 0.99


class DispatchGate:
    """Holds a batcher's next dispatch until `release()`: what arrives
    meanwhile queues, and coalesces into the dispatch after it.  Lives
    here, never in the package."""

    def __init__(self, batcher):
        self.batcher, self.inner = batcher, batcher._dispatch
        self.event, self.entered = threading.Event(), threading.Event()
        batcher._dispatch = self

    def __call__(self, x, mask, n_real):
        self.entered.set()
        if not self.event.wait(OPS_TIMEOUT_S):
            raise AssertionError("dispatch gate never released")
        return self.inner(x, mask, n_real)

    def release(self):
        self.batcher._dispatch = self.inner
        self.event.set()


def serving_storm(conc: int, reqs: list, fn) -> tuple:
    """`conc` client threads share `reqs` round robin, each calling
    `fn(x)`; returns (wall seconds, the replies in request order)."""
    out = [None] * len(reqs)
    errors = []
    barrier = threading.Barrier(conc)

    def client(c):
        try:
            barrier.wait()
            for i in range(c, len(reqs), conc):
                out[i] = fn(reqs[i])
        except Exception as e:  # noqa: BLE001 — raised below
            errors.append(f"{type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(conc)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=OPS_TIMEOUT_S)
    wall = time.perf_counter() - t0
    if errors or any(t.is_alive() for t in threads):
        raise AssertionError(f"storm: {errors[:3]}")
    return wall, out


def worst_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def mnist_storm(net, card: str) -> dict:
    """bench.py bench_serving on the card: 640 one-row requests from 16
    threads, micro-batched through the engine and sequentially (one
    `net.output` a request under a lock); every reply within CLS_RTOL of
    its rows through `net.output` alone."""
    from deeplearning4j_tpu_torch.serving import BucketLadder, ServingEngine

    rng = np.random.default_rng(0)
    reqs = [rng.random((1, 784)).astype(np.float32)
            for _ in range(CLS_TOTAL)]
    lock = threading.Lock()

    def sequential(x):
        with lock:
            return net.output(x).cpu().numpy()

    sequential(reqs[0])
    seq_s = min(serving_storm(CLS_CONC, reqs, sequential)[0]
                for _ in range(2))
    engine = ServingEngine(net, ladder=BucketLadder(CLS_LADDER),
                           max_wait_ms=2.0)
    try:
        sig0 = net.forward_program_count()
        warmed = engine.warmup(np.zeros((784,), np.float32))
        runs = [serving_storm(CLS_CONC, reqs, engine.predict_proba)
                for _ in range(2)]
        stats = engine.stats()
    finally:
        engine.stop()
    bat_s, replies = min(runs, key=lambda r: r[0])
    alone = [net.output(x).cpu().numpy() for x in reqs]
    err = max(worst_rel(r, a) for r, a in zip(replies, alone))
    sigs = net.forward_program_count() - sig0
    lat = stats["latency"]
    out = {"model": "mnist_mlp 784-2048-2048-10, float32, TF32 off",
           "ladder": list(CLS_LADDER), "concurrency": CLS_CONC,
           "requests": CLS_TOTAL, "warmed": warmed,
           "requests_per_s": CLS_TOTAL / bat_s,
           "sequential_requests_per_s": CLS_TOTAL / seq_s,
           "batched_vs_sequential": seq_s / bat_s,
           "p50_ms": lat.get("p50_ms"), "p99_ms": lat.get("p99_ms"),
           "dispatches": stats["dispatches"],
           "mean_rows_a_dispatch": stats.get("mean_batch_occupancy"),
           "signatures": stats["compiled_programs"],
           "forward_signatures": sigs, "max_rel_err_vs_alone": err,
           "card": card}
    if not (stats["compiled_programs"] <= len(CLS_LADDER)
            and sigs <= len(CLS_LADDER)):
        raise AssertionError(f"classify: {stats['compiled_programs']} "
                             f"signatures for a ladder of "
                             f"{len(CLS_LADDER)}")
    if not err <= CLS_RTOL:
        raise AssertionError(f"classify: a reply is {err} from its rows "
                             f"through net.output alone")
    log(f"classify: mnist-mlp storm {out['requests_per_s']:.1f} requests/s "
        f"micro-batched vs {out['sequential_requests_per_s']:.1f} "
        f"sequential ({out['batched_vs_sequential']:.2f}x), p50 "
        f"{out['p50_ms']} ms, p99 {out['p99_ms']} ms, "
        f"{out['mean_rows_a_dispatch']} rows a dispatch over "
        f"{out['dispatches']} dispatches, {sigs} signatures, worst "
        f"{err:.3g} from net.output alone ({card})")
    return out


def profiled(profile: bool):
    """A started `torch.profiler` over the card's kernels, or None."""
    if not profile:
        return None
    import torch

    prof = torch.profiler.profile(activities=[
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA])
    prof.__enter__()
    return prof


def char_lstm_engine(card: str, profile: bool = False) -> dict:
    """The char-LSTM (config #4, vocab 80, hidden 256) in bf16 behind the
    engine on (1, 8, 32) without length buckets: 48 client threads of 1-8
    one-hot sequences of T 64.  B5 launches = dispatches + the warmup's
    3; each reply within LSTM_TOL of the f32 net on the same weights,
    its argmax equal wherever the f32 top-2 gap exceeds LSTM_GAP, and
    that at LSTM_HELD_SHARE of the positions or more."""
    import torch

    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        char_lstm,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.serving import BucketLadder, ServingEngine

    net = MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()
    ref = MultiLayerNetwork(char_lstm()).init()
    ref.params = params_from_numpy(ref, [
        {k: v.detach().float().cpu().numpy() for k, v in layer.items()}
        for layer in net.params])
    rng = np.random.default_rng(4)
    eye = np.eye(80, dtype=np.float32)
    reqs = [eye[rng.integers(0, 80, (int(rng.integers(1, 9)), LSTM_T))]
            for _ in range(LSTM_CLIENTS)]
    from deeplearning4j_tpu_torch.obs import compile_watcher

    engine = ServingEngine(net, ladder=BucketLadder(LSTM_LADDER),
                           max_batch=max(LSTM_LADDER), max_wait_ms=2.0)
    want_keys = {f"classifier:{(b, LSTM_T, 80)}": 1 for b in LSTM_LADDER}
    try:
        torch.cuda.synchronize()
        lk.fused_lstm_forward.launches.reset()
        before = compile_watcher().counts()
        t_warm = time.perf_counter()
        warmed = engine.warmup(np.zeros((LSTM_T, 80), np.float32))
        built = watcher_delta(before)
        capture_s = build_seconds(t_warm, time.perf_counter())
        if built != want_keys:
            raise AssertionError(f"classify: the engine's warmup built "
                                 f"{built}, not {want_keys}")
        prof = profiled(profile)
        t0 = time.perf_counter()
        _, replies = serving_storm(LSTM_CLIENTS, reqs, engine.predict_proba)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
        launches = lk.fused_lstm_forward.launches.value
        stats = engine.stats()
        if watcher_delta(before) != want_keys:
            raise AssertionError(f"classify: the storm built programs: "
                                 f"{watcher_delta(before)}")
    finally:
        engine.stop()
    err, held, gap_rows = 0.0, True, 0
    positions = sum(x.shape[0] * x.shape[1] for x in reqs)
    for x, got in zip(reqs, replies):
        want = ref.output(x).float().cpu().numpy()
        err = max(err, float(np.abs(got - want).max()))
        top2 = np.sort(want, axis=-1)[..., -2:]
        sure = (top2[..., 1] - top2[..., 0]) > LSTM_GAP
        gap_rows += int(sure.sum())
        held &= bool(np.array_equal(got.argmax(-1)[sure],
                                    want.argmax(-1)[sure]))
    out = {"model": "char_lstm vocab 80 hidden 256, bfloat16",
           "ladder": list(LSTM_LADDER), "clients": LSTM_CLIENTS,
           "T": LSTM_T, "requests": len(reqs), "warmed": warmed,
           "dispatches": stats["dispatches"], "b5_launches": launches,
           "max_abs_err_vs_f32": err, "argmax_held_positions": gap_rows,
           "positions": positions,
           "wall_s": wall, "requests_per_s": len(reqs) / wall,
           "mean_rows_a_dispatch": stats.get("mean_batch_occupancy"),
           "programs": {"built_at_warmup": built, "build_s": capture_s,
                        "builds_after_warmup": 0,
                        "compiles_total": stats["compiles_total"]},
           "card": card}
    if prof is not None:
        out["profile"] = device_breakdown(prof, wall, stats["dispatches"])
    if launches != stats["dispatches"] + warmed or warmed != 3:
        raise AssertionError(f"classify: B5 launches {launches} != "
                             f"dispatches {stats['dispatches']} + warmup "
                             f"{warmed}")
    if not (err <= LSTM_TOL and held
            and gap_rows >= LSTM_HELD_SHARE * positions):
        raise AssertionError(f"classify: char-LSTM replies {err} from the "
                             f"f32 net (argmax held: {held}, at {gap_rows} "
                             f"of {positions} positions)")
    if not stats["dispatches"] < len(reqs):
        raise AssertionError("classify: the char-LSTM requests did not "
                             "coalesce")
    log(f"classify: char-LSTM engine {len(reqs)} requests in "
        f"{stats['dispatches']} dispatches ({out['mean_rows_a_dispatch']} "
        f"rows each), B5 launches {launches} = dispatches + {warmed}; "
        f"worst {err:.3g} from the f32 net (limit {LSTM_TOL}), argmax held "
        f"at {gap_rows} of {positions} positions"
        + (f", device idle {out['profile']['device_idle_share']:.3f}"
           if profile else "") + f" ({card})")
    return out


def cli_int8_serve(card: str, tmp: str) -> dict:
    """``cli serve -model zoo:mnist-mlp -quantize int8 -buckets 1,8,32
    -warmup`` run on this (main) thread; a helper thread talks to it over
    HTTP: /readyz 200, 256 seeded rows (agreement with the float net >=
    INT8_AGREE), /metrics as Prometheus text with the classifier
    families, then a request held at a dispatch gate while SIGTERM
    starts the drain: /readyz 503 during it, the held request answered
    200, the drain snapshot written."""
    import os
    import re
    import signal

    from deeplearning4j_tpu_torch import cli
    from deeplearning4j_tpu_torch.ui import server as ui_server

    started = []
    real_start = ui_server.UiServer.start

    def start(self):
        started.append(self)
        return real_start(self)

    prev = signal.getsignal(signal.SIGTERM)
    res = {"errors": []}
    drain_stats = os.path.join(tmp, "serving_stats.json")

    def helper():
        sent = False
        try:
            t0 = time.perf_counter()
            while not started or signal.getsignal(signal.SIGTERM) is prev:
                if time.perf_counter() - t0 > 600:
                    raise AssertionError("cli serve never came up")
                time.sleep(0.01)
            srv = started[0]
            url, engine = srv.url, srv.state.engine
            res["readyz_before"] = http_get(url, "/readyz")[0]
            rows = np.random.default_rng(7).random(
                (INT8_ROWS, 784)).astype(np.float32)
            answers = concurrently([
                (lambda i=i: http_json(url, "/model/predict",
                                       {"features": rows[i:i + 32]
                                        .tolist()}, f"int8-{i}"))
                for i in range(0, INT8_ROWS, 32)])
            preds = np.concatenate([a["body"]["predictions"]
                                    for a in answers])
            want = engine.net.output(rows).float().cpu().numpy().argmax(-1)
            res["agreement"] = float(np.mean(preds == want))
            code, text = http_get(url, "/metrics")
            bad = [ln for ln in text.splitlines()
                   if not ln.startswith("#") and not re.match(PROM_LINE, ln)]
            res["metrics"] = {
                "status": code, "bad_lines": bad[:3],
                "classifier_families": sorted({
                    ln.split("{")[0] for ln in text.splitlines()
                    if 'plane="classifier"' in ln})}
            res["quantization"] = engine.stats()["quantization"]
            gate = DispatchGate(engine.batcher)
            held = []
            t = threading.Thread(target=lambda: held.append(http_json(
                url, "/model/predict", {"features": rows[:1].tolist()},
                "int8-held")))
            t.start()
            if not gate.entered.wait(60):
                raise AssertionError("the held request never dispatched")
            os.kill(os.getpid(), signal.SIGTERM)
            sent = True
            codes = []
            t1 = time.perf_counter()
            while time.perf_counter() - t1 < 30:
                codes.append(http_get(url, "/readyz")[0])
                if codes[-1] == 503:
                    break
                time.sleep(0.005)
            res["readyz_during_drain"] = codes[-1]
            gate.release()
            t.join(60)
            res["held_status"] = held[0]["status"] if held else None
        except Exception as e:  # noqa: BLE001 — checked by the caller
            res["errors"].append(f"{type(e).__name__}: {e}")
        finally:
            if not sent:
                os.kill(os.getpid(), signal.SIGTERM)

    ui_server.UiServer.start = start
    th = threading.Thread(target=helper, daemon=True)
    th.start()
    try:
        rc = cli.main(["serve", "-model", "zoo:mnist-mlp", "-quantize",
                       "int8", "-buckets", "1,8,32", "-warmup", "-port",
                       "0", "-drain-stats", drain_stats,
                       "-serve-seconds", "900"])
    finally:
        ui_server.UiServer.start = real_start
    th.join(120)
    snap = json.loads(open(drain_stats).read())
    res.update(rc=rc, drained_requests=snap["classifier"]["requests"],
               drain_accepting=snap["classifier"]["accepting"], card=card)
    fams = res.get("metrics", {}).get("classifier_families", [])
    if res["errors"] or rc != 0:
        raise AssertionError(f"classify: cli serve: {res}")
    if not (res["readyz_before"] == 200
            and res["readyz_during_drain"] == 503
            and res["held_status"] == 200):
        raise AssertionError(f"classify: cli serve readiness {res}")
    if not res["agreement"] >= INT8_AGREE:
        raise AssertionError(f"classify: int8 agreement {res['agreement']}")
    if res["metrics"]["bad_lines"] or not {
            "serving_requests_total", "serving_dispatches_total",
            "serving_poison_isolated_total"} <= set(fams):
        raise AssertionError(f"classify: /metrics {res['metrics']}")
    log(f"classify: cli serve -quantize int8: agreement "
        f"{res['agreement']:.4f} over {INT8_ROWS} rows, "
        f"{res['quantization']['quantized_layers']} layers int8, /readyz "
        f"{res['readyz_before']} then {res['readyz_during_drain']} in the "
        f"SIGTERM drain, the held request {res['held_status']} ({card})")
    return res


def poison_and_deadline(net, card: str) -> dict:
    """`UiServer.serve_model` over the mnist net: a coalesced dispatch of
    four requests, one poisoned by `chaos_dispatch`, is bisected (the
    three answered within CLS_RTOL of their sequential replies, one
    `InjectedDispatchFault`, ``serving_poison_isolated_total`` 1 on
    /metrics); then a request whose deadline passes while it queues is
    answered 504."""
    from deeplearning4j_tpu_torch.resilience import (
        ServingChaosConfig,
        chaos_dispatch,
    )
    from deeplearning4j_tpu_torch.serving import BucketLadder
    from deeplearning4j_tpu_torch.ui.server import UiServer

    ui = UiServer(port=0).serve_model(
        net, ladder=BucketLadder((1, 8)), max_batch=8,
        warmup_example=np.zeros((784,), np.float32)).start()
    out = {"card": card}
    try:
        batcher = ui.state.engine.batcher
        plain = batcher._dispatch
        chaos = chaos_dispatch(plain, ServingChaosConfig(poison_value=9.0))
        batcher._dispatch = chaos
        rng = np.random.default_rng(8)
        rows = [rng.random((1, 784)).astype(np.float32) for _ in range(4)]
        rows[2] = np.full((1, 784), 9.0, np.float32)
        gate = DispatchGate(batcher)
        first = threading.Thread(target=http_json, args=(
            ui.url, "/model/predict", {"features": rows[0].tolist()},
            "poison-0"))
        first.start()
        gate.entered.wait(60)
        box = [None] * 3

        def send(i):
            box[i - 1] = http_json(ui.url, "/model/predict",
                                   {"features": rows[i].tolist()},
                                   f"poison-{i}")

        threads = [threading.Thread(target=send, args=(i,))
                   for i in (1, 2, 3)]
        for t in threads:
            t.start()
        t0 = time.perf_counter()
        while len(batcher._queue) < 3 and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        gate.release()
        first.join(60)
        for t in threads:
            t.join(60)
        batcher._dispatch = plain
        codes = [b["status"] for b in box]
        errs = [worst_rel(box[i - 1]["body"]["outputs"],
                          net.output(rows[i]).cpu().numpy())
                for i in (1, 3)]
        text = http_get(ui.url, "/metrics")[1]
        isolated = [ln for ln in text.splitlines() if ln.startswith(
            'serving_poison_isolated_total{plane="classifier"}')]
        out.update(statuses=codes, poison_error=box[1]["body"]["error"],
                   max_rel_err=max(errs), metrics_line=isolated,
                   chaos_calls=chaos.calls)
        if not (codes == [200, 400, 200] and "InjectedDispatchFault"
                in box[1]["body"]["error"] and max(errs) <= CLS_RTOL
                and isolated == ['serving_poison_isolated_total'
                                 '{plane="classifier"} 1']):
            raise AssertionError(f"classify: poison isolation {out}")
        gate = DispatchGate(batcher)
        first = threading.Thread(target=http_json, args=(
            ui.url, "/model/predict", {"features": rows[0].tolist()},
            "deadline-0"))
        first.start()
        gate.entered.wait(60)
        late = []
        t = threading.Thread(target=lambda: late.append(http_json(
            ui.url, "/model/predict", {"features": rows[1].tolist(),
                                       "deadline_ms": 5}, "deadline-1")))
        t.start()
        t0 = time.perf_counter()
        while not batcher._queue and time.perf_counter() - t0 < 60:
            time.sleep(0.005)
        time.sleep(0.05)               # its 5 ms expire while it queues
        gate.release()
        first.join(60)
        t.join(60)
        out["deadline"] = {"status": late[0]["status"],
                           "error": late[0]["body"]["error"]}
        if late[0]["status"] != 504:
            raise AssertionError(f"classify: deadline shed {out}")
    finally:
        ui.stop()
    log(f"classify: poison isolated ({out['statuses']}, worst "
        f"{out['max_rel_err']:.3g} from sequential, /metrics "
        f"{out['metrics_line'][0]}); an expired deadline answered "
        f"{out['deadline']['status']} ({card})")
    return out


def classify_phase(card: str, profile: bool = False) -> dict:
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, mnist_mlp

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    net = MultiLayerNetwork(mnist_mlp()).init()
    out = {"card": card}
    out["mnist_storm"] = mnist_storm(net, card)
    out["char_lstm"] = char_lstm_engine(card, profile)
    out["poison"] = poison_and_deadline(net, card)
    with tempfile.TemporaryDirectory() as tmp:
        out["cli_int8"] = cli_int8_serve(card, tmp)
    del net
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 18: the thread-hosted serving fleet (FleetRouter, FleetServer)

FLEET_CONC, FLEET_TOTAL = 32, 384    # bench.py bench_serving_fleet's storm
FLEET_LM_NEW = 64
DISAGG_LONG, DISAGG_SHORT = 8, 16    # long prompts (256 + 16), short chats
DISAGG_NEW_LONG, DISAGG_NEW_SHORT = 32, 16
DISAGG_MIN_PROMPT = 64


def classifier_fleet(card: str) -> dict:
    """bench.py bench_serving_fleet's recipe through a `FleetServer`: 3
    mnist_mlp replicas, 384 one-row requests from 32 threads over HTTP,
    `chaos_fleet` killing replica-0 at a third of the attempts while
    replica-1's /readyz lies twice; health polls eject both and re-admit
    replica-1; then a rolling swap to new weights under live traffic."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, mnist_mlp
    from deeplearning4j_tpu_torch.resilience import (
        FleetChaosConfig,
        chaos_fleet,
    )
    from deeplearning4j_tpu_torch.serving import (
        BucketLadder,
        FleetRouter,
        FleetServer,
        check_fleet_ledger,
        spawn_local_replica,
    )

    old_net = MultiLayerNetwork(mnist_mlp()).init()
    new_net = MultiLayerNetwork(mnist_mlp(seed=6)).init()
    warm = np.zeros((784,), np.float32)

    def factory_of(net):
        def factory(name):
            return spawn_local_replica(
                name, net, ladder=BucketLadder(CLS_LADDER), max_wait_ms=2.0,
                warmup_example=warm)
        return factory

    router = FleetRouter(factory_of(old_net), replicas=3,
                         request_timeout_s=OPS_TIMEOUT_S,
                         replica_breaker_threshold=2,
                         replica_breaker_cooldown_s=0.5)
    front = FleetServer(router, port=0).start()
    out = {"card": card, "replicas": 3, "concurrency": FLEET_CONC,
           "requests": FLEET_TOTAL}
    try:
        chaos = chaos_fleet(router, FleetChaosConfig(
            kill_at_attempt=FLEET_TOTAL // 3, kill_replica="replica-0",
            flaky_readyz_polls=(0, 1), flaky_replica="replica-1"))
        rng = np.random.default_rng(9)
        reqs = [rng.random((1, 784)).astype(np.float32)
                for _ in range(FLEET_TOTAL)]
        failed = []

        def one(x):
            r = http_json(front.url, "/model/predict",
                          {"features": x.tolist()}, "fleet")
            if r["status"] != 200:
                failed.append(r["status"])
            return r["body"].get("outputs")

        wall, replies = serving_storm(FLEET_CONC, reqs, one)
        chaos_killed = list(chaos.killed)
        polls = [router.poll_health_once(), router.poll_health_once()]
        time.sleep(0.6)
        polls.append(router.poll_health_once())
        chaos.uninstall()
        code, text = http_get(front.url, "/fleet/stats")
        if code != 200:
            raise AssertionError(f"fleet: /fleet/stats {code}: {text}")
        stats = json.loads(text)
        summary = {e["name"]: e for e in stats["replicas"]}
        ledger = check_fleet_ledger(stats, submitted=FLEET_TOTAL)
        err = max(worst_rel(r, old_net.output(x).cpu().numpy())
                  for r, x in zip(replies[:64], reqs[:64]) if r is not None)
        lat = stats["fleet"]["latency"]
        out.update(
            requests_per_s=FLEET_TOTAL / wall, failed=len(failed),
            p50_ms=lat.get("p50_ms"), p99_ms=lat.get("p99_ms"),
            failovers=stats["fleet"]["failovers"], killed=chaos_killed,
            health_polls=[{k: bool(v) for k, v in p.items()}
                          for p in polls],
            ejections={n: e["ejections"] for n, e in summary.items()},
            readmissions={n: e["readmissions"] for n, e in summary.items()},
            client_balanced=ledger["client_balanced"],
            ledger_failures=ledger["failures"],
            ledger_balanced_recorded=ledger["balanced"],
            replicas_reachable=ledger["replicas_reachable"],
            max_rel_err=err)
        if failed or chaos_killed != ["replica-0"] or \
                not out["failovers"] >= 1:
            raise AssertionError(f"fleet: storm {out}")
        if not (ledger["client_balanced"] and not ledger["failures"]):
            raise AssertionError(f"fleet: ledger {ledger}")
        if not (summary["replica-0"]["ejections"] >= 1
                and summary["replica-1"]["ejections"] >= 1
                and summary["replica-1"]["readmissions"] >= 1
                and summary["replica-1"]["breaker"] == "closed"):
            raise AssertionError(f"fleet: ejection / re-admission not seen "
                                 f"on /fleet/stats: {summary}")
        if not err <= CLS_RTOL:
            raise AssertionError(f"fleet: a reply is {err} from net.output")
        # the rolling swap under live traffic
        x = np.linspace(0, 1, 784, dtype=np.float32).reshape(1, 784)
        old_out = old_net.output(x).cpu().numpy()
        new_out = new_net.output(x).cpu().numpy()
        stop, seen, bad = threading.Event(), [], []

        def live():
            while not stop.is_set():
                r = http_json(front.url, "/model/predict",
                              {"features": x.tolist()}, "swap")
                if r["status"] != 200:
                    bad.append(r["status"])
                    return
                o = np.asarray(r["body"]["outputs"])
                is_old = worst_rel(o, old_out) <= CLS_RTOL
                is_new = worst_rel(o, new_out) <= CLS_RTOL
                if not (is_old or is_new):
                    bad.append("mixed")
                seen.append("new" if is_new else "old")

        clients = [threading.Thread(target=live) for _ in range(8)]
        for t in clients:
            t.start()
        t0 = time.perf_counter()
        steps = router.rolling_swap(factory_of(new_net), grace_s=30.0)
        swap_s = time.perf_counter() - t0
        after = [http_json(front.url, "/model/predict",
                           {"features": x.tolist()}, "after")
                 for _ in range(16)]
        stop.set()
        for t in clients:
            t.join(60)
        after_ok = all(r["status"] == 200 and worst_rel(
            r["body"]["outputs"], new_out) <= CLS_RTOL for r in after)
        out["swap"] = {"steps": steps, "seconds": swap_s,
                       "live_replies": len(seen), "errors": bad,
                       "new_replies": seen.count("new"),
                       "after_flip_all_new": after_ok,
                       "versions": [r.version for r in router.replicas()]}
        if bad or not after_ok or not seen:
            raise AssertionError(f"fleet: rolling swap {out['swap']}")
    finally:
        front.stop()
    del old_net, new_net
    torch.cuda.empty_cache()
    log(f"fleet: classifier storm {out['requests_per_s']:.1f} requests/s, "
        f"failed {out['failed']}, {out['failovers']} failovers, p99 "
        f"{out['p99_ms']} ms; ejections {out['ejections']}, re-admissions "
        f"{out['readmissions']}; rolling swap {out['swap']['seconds']:.2f} "
        f"s under {out['swap']['live_replies']} live replies, zero 5xx "
        f"({card})")
    return out


def lm_replica(cfg, params, name: str, role: str = "both"):
    from deeplearning4j_tpu_torch.serving import spawn_local_replica

    return spawn_local_replica(
        name, lm=(cfg, params), lm_slots=8, lm_page_size=16,
        lm_prefill_chunk=16, role=role, device="cuda")


def fleet_pools(router) -> list:
    return [r.server.state.lm_server for r in router.replicas()
            if r.server is not None and r.server.state.lm_server is not None]


def width_delta(pools, before) -> dict:
    """Dispatches by width over the pools since `before` (their widths
    then), summed."""
    out = {}
    for srv, w0 in zip(pools, before):
        for w, n in srv.stats()["dispatch_widths"].items():
            if n - w0.get(w, 0):
                out[w] = out.get(w, 0) + n - w0.get(w, 0)
    return out


def counted(fn, pools, need_b1: bool = True):
    """Run `fn()` with the B1 and B2 counts set to 0 just before and read
    just after; B1 held to n_layers x the pools' dispatches by width (and,
    with `need_b1`, launched at least once)."""
    import torch

    from deeplearning4j_tpu_torch.parallel.kernels import flash_forward
    from deeplearning4j_tpu_torch.parallel.paged_kernel import (
        paged_flash_attention,
    )

    before = [dict(s.stats()["dispatch_widths"]) for s in pools]
    torch.cuda.synchronize()
    paged_flash_attention.launches.reset()
    flash_forward.launches.reset()
    result = fn()
    torch.cuda.synchronize()
    by_width = {str(c): n for c, n in sorted(
        paged_flash_attention.launches.by_key().items())}
    delta = width_delta(pools, before)
    n_layers = pools[0].cfg.n_layers
    want = {w: n_layers * n for w, n in delta.items()}
    if by_width != want or (need_b1 and not by_width):
        raise AssertionError(f"fleet: B1 launches by width {by_width} != "
                             f"n_layers x dispatches by width {want}")
    return result, {"b1_launches": paged_flash_attention.launches.value,
                    "b1_launches_by_width": by_width,
                    "dispatches_by_width": delta,
                    "b2_launches": flash_forward.launches.value}


def lm_fleet(cfg, params, check, reqs, card: str,
             profile: bool = False) -> dict:
    """2 `both` replicas of the bf16 gpt2_small behind a `FleetServer`:
    the serve phase's 12 prompts through POST /lm/generate (every id by
    the greedy rule, all on the affinity-preferred replica, B1 by width),
    one top-k and one beam request (B2 = n_layers each), one SSE stream
    relayed (its tokens make its done ids)."""
    from deeplearning4j_tpu_torch.serving import FleetRouter, FleetServer

    router = FleetRouter(lambda n: lm_replica(cfg, params, n), replicas=2,
                         affinity_spill_depth=16,
                         request_timeout_s=OPS_TIMEOUT_S)
    front = FleetServer(router, port=0).start()
    pools = fleet_pools(router)
    out = {"card": card, "replicas": 2, "new_tokens": FLEET_LM_NEW}
    try:
        prof = profiled(profile)
        t0 = time.perf_counter()
        answers, launches = counted(lambda: concurrently([
            (lambda i=i: http_json(front.url, "/lm/generate",
                                   {"prompt_ids": reqs[i],
                                    "max_new_tokens": FLEET_LM_NEW},
                                   f"fleet-lm-{i}"))
            for i in range(len(reqs))]), pools)
        wall = time.perf_counter() - t0
        if prof is not None:
            prof.__exit__(None, None, None)
            out["profile"] = device_breakdown(
                prof, wall, sum(launches["dispatches_by_width"].values()))
        checks = []
        for prompt, a in zip(reqs, answers):
            if a["status"] != 200:
                raise AssertionError(f"fleet: {a['rid']} {a['status']} "
                                     f"{a['body']}")
            checks.append(check(prompt, a["body"]["ids"]))
        per = [s.stats() for s in pools]
        served = [p["requests"] for p in per]
        hits = [p.get("prefix_hits", 0) for p in per]
        out.update(launches, wall_s=wall,
                   tokens_per_s=len(reqs) * FLEET_LM_NEW / wall,
                   requests_by_replica=served, prefix_hits_by_replica=hits,
                   **checks_summary(checks))
        if sorted(served) != [0, len(reqs)] or sorted(hits)[0] != 0 \
                or not max(hits):
            raise AssertionError(f"fleet: the shared-prefix requests were "
                                 f"not kept on one replica: {served}, "
                                 f"prefix hits {hits}")
        for name, body in (("top_k", {"top_k": 40, "seed": 3}),
                           ("beam", {"beam_size": 4})):
            ans, ln = counted(lambda body=body: http_json(
                front.url, "/lm/generate",
                dict(body, prompt_ids=reqs[0], max_new_tokens=16),
                f"fleet-{name}"), pools, need_b1=False)
            if ans["status"] != 200 or ln["b2_launches"] != cfg.n_layers:
                raise AssertionError(f"fleet: {name}: {ans['status']}, B2 "
                                     f"{ln['b2_launches']}")
            ids = ans["body"]["ids"]
            if ids[:len(reqs[0])] != reqs[0] or len(ids) != \
                    len(reqs[0]) + 16 or max(ids) >= cfg.vocab_size:
                raise AssertionError(f"fleet: {name} ids malformed")
            out[f"{name}_b2_launches"] = ln["b2_launches"]
        s = sse_request(front.url, {"prompt_ids": reqs[1],
                                    "max_new_tokens": 16}, "fleet-sse")
        if s["status"] != 200 or s["done"] != reqs[1] + s["tokens"] or \
                len(s["tokens"]) != 16:
            raise AssertionError(f"fleet: relayed stream {s}")
        check(reqs[1], s["done"])
        out["sse_ttft_ms"] = (s["t_first"] - s["t_send"]) * 1e3
        for srv in pools:
            if not srv.page_ledger()["balanced"]:
                raise AssertionError("fleet: a page ledger is off")
    finally:
        front.stop()
    log(f"fleet: LM fleet 12 requests on {out['requests_by_replica']} "
        f"(prefix hits {out['prefix_hits_by_replica']}), "
        f"{out['tokens_per_s']:.1f} tokens/s, B1 by width "
        f"{out['b1_launches_by_width']}, B2 top-k "
        f"{out['top_k_b2_launches']} beam {out['beam_b2_launches']}, a "
        f"relayed stream's TTFT {out['sse_ttft_ms']:.1f} ms"
        + (f", device idle {out['profile']['device_idle_share']:.3f}"
           if profile else "") + f" ({card})")
    return out


def disagg_storm(router, check, longs, shorts, kill=None) -> dict:
    """Long prompts through `generate` and short chats streamed through
    `open_lm_stream` (sticky sessions), all at once; TTFT from the client
    (the first ``data:`` event).  With `kill` the replica is stopped once
    two long prompts are done."""
    lock = threading.Lock()
    failed, ttfts, done = [], [], [0]

    def long_req(p):
        try:
            ids = router.generate(p, DISAGG_NEW_LONG, timeout=OPS_TIMEOUT_S)
        except Exception as e:  # noqa: BLE001 — the storm counts failures
            with lock:
                failed.append(repr(e))
            return None
        with lock:
            done[0] += 1
            stop = kill is not None and done[0] == 2
        if stop:
            kill.kill()
        return ids

    def short_req(i, p):
        t0 = time.perf_counter()
        try:
            resp = router.open_lm_stream(p, DISAGG_NEW_SHORT,
                                         timeout=OPS_TIMEOUT_S,
                                         session_id=f"chat-{i}")
        except Exception as e:  # noqa: BLE001 — the storm counts failures
            with lock:
                failed.append(repr(e))
            return None
        first, buf = None, b""
        try:
            while True:
                chunk = resp.read1(4096)
                if not chunk:
                    break
                buf += chunk
                if first is None and b"data: " in buf:
                    first = time.perf_counter() - t0
        finally:
            resp.close()
        ev = [e for e in buf.decode().split("\n\n")
              if e.startswith("event: done")]
        with lock:
            if first is not None:
                ttfts.append(first)
        return json.loads(ev[0].split("data: ", 1)[1])["ids"] if ev else None

    t0 = time.perf_counter()
    results = concurrently(
        [(lambda p=p: long_req(p)) for p in longs]
        + [(lambda i=i, p=p: short_req(i, p)) for i, p in enumerate(shorts)])
    wall = time.perf_counter() - t0
    checks = [check(p, ids) for p, ids in zip(longs + shorts, results)
              if ids is not None]
    missing = sum(ids is None for ids in results)
    tokens = (len(longs) * DISAGG_NEW_LONG + len(shorts) * DISAGG_NEW_SHORT)
    return {"failed": len(failed) + missing, "errors": failed[:3],
            "wall_s": wall, "tokens_per_s": tokens / wall,
            "short_ttft_p50_ms": percentile_ms(ttfts, 0.50),
            "short_ttft_p99_ms": percentile_ms(ttfts, 0.99),
            **checks_summary(checks)}


def disagg_fleet(cfg, params, check, card: str) -> dict:
    """bench.py bench_disagg's topologies at gpt2_small width: 3 `both`
    workers, then 1 prefill + 2 decode workers (prompts of at least
    DISAGG_MIN_PROMPT tokens shipped); the same storm of 8 long prompts
    and 16 short streamed chats on each; then a kill leg on the split
    fleet (the prefill worker stopped mid-storm: zero failed, the later
    long prompts recomputed on the decode workers)."""
    from deeplearning4j_tpu_torch.serving import FleetRouter

    rng = np.random.default_rng(11)
    longs = [rng.integers(0, cfg.vocab_size, 272).tolist()
             for _ in range(DISAGG_LONG)]
    shorts = [rng.integers(0, cfg.vocab_size, 6).tolist()
              for _ in range(DISAGG_SHORT)]
    out = {"card": card, "long_prompts": DISAGG_LONG,
           "short_chats": DISAGG_SHORT, "disagg_min_prompt":
           DISAGG_MIN_PROMPT}
    for name, roles in (("both", ("both",) * 3),
                        ("split", ("prefill", "decode", "decode"))):
        router = FleetRouter(disagg_min_prompt=DISAGG_MIN_PROMPT,
                             request_timeout_s=OPS_TIMEOUT_S)
        for i, role in enumerate(roles):
            router.attach(lm_replica(cfg, params, f"{role}-{i}", role))
        pools = fleet_pools(router)
        try:
            storm, launches = counted(
                lambda: disagg_storm(router, check, longs, shorts), pools)
            storm.update(launches, ships=router.ships,
                         ship_fallbacks=router.ship_fallbacks)
            if storm["failed"]:
                raise AssertionError(f"fleet: {name} storm {storm}")
            for srv in pools:
                if not srv.page_ledger()["balanced"]:
                    raise AssertionError(f"fleet: {name} page ledger off")
            if name == "split":
                ship = [s.stats().get("ship", {}) for s in pools]
                storm["ship_out_ms_mean"] = ship[0].get("mean_ms")
                storm["ship_in_ms_mean"] = [s.get("mean_ms")
                                            for s in ship[1:]]
                storm["frame_bytes_a_lane"] = (
                    ship[0].get("ship_bytes", 0) / max(ship[0].get("out",
                                                                   0), 1))
                if router.ships != DISAGG_LONG or router.ship_fallbacks:
                    raise AssertionError(f"fleet: shipped {router.ships} "
                                         f"of {DISAGG_LONG} lanes")
                # the prefill worker stops once two long prompts of the
                # first wave are done; the second wave meets its corpse
                ships0 = router.ships
                waves = [disagg_storm(router, check, longs[:3], shorts[:4],
                                      kill=router.replicas()[0]),
                         disagg_storm(router, check, longs[3:6], shorts[4:8])]
                kill = {"failed": sum(w["failed"] for w in waves),
                        "errors": waves[0]["errors"] + waves[1]["errors"],
                        "ships": router.ships - ships0,
                        "ship_fallbacks": router.ship_fallbacks,
                        "greedy_tokens": sum(w["greedy_tokens"]
                                             for w in waves)}
                if kill["failed"] or not kill["ship_fallbacks"]:
                    raise AssertionError(f"fleet: kill leg {kill}")
                out["kill_leg"] = kill
            out[name] = storm
        finally:
            router.stop()
    log(f"fleet: disaggregated vs 3 both workers: short-chat TTFT p50 "
        f"{out['split']['short_ttft_p50_ms']:.1f} / "
        f"{out['both']['short_ttft_p50_ms']:.1f} ms, p99 "
        f"{out['split']['short_ttft_p99_ms']:.1f} / "
        f"{out['both']['short_ttft_p99_ms']:.1f} ms, "
        f"{out['split']['tokens_per_s']:.1f} / "
        f"{out['both']['tokens_per_s']:.1f} tokens/s; {out['split']['ships']}"
        f" lanes shipped (export {out['split']['ship_out_ms_mean']} ms a "
        f"lane); kill leg failed {out['kill_leg']['failed']} with "
        f"{out['kill_leg']['ship_fallbacks']} recomputes ({card})")
    return out


def fleet_phase(card: str, profile: bool = False) -> dict:
    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import (
        gpt2_small,
        numpy_params,
        params_from_numpy,
    )

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"card": card}
    out["classifier"] = classifier_fleet(card)
    cfg = gpt2_small(max_len=1024)
    params = params_from_numpy(numpy_params(cfg, seed=0), device="cuda",
                               dtype=cfg.dtype)
    check = greedy_checker(cfg, params)
    reqs = [p for p, _, _ in decode_requests(cfg)[:12]]
    out["lm"] = lm_fleet(cfg, params, check, reqs, card, profile)
    out["disagg"] = disagg_fleet(cfg, params, check, card)
    del params, check
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 19: process-hosted fleets (FleetSupervisor over `cli serve` workers)

PROC_LM_WORKERS = 3
PROC_NEW = 64                    # new tokens a request
PROC_KILL_AT, PROC_STOP_AT = 4, 2     # dispatch attempts of storms A and B
PROC_CLS_REQS = 64               # one-row mnist-mlp requests
PROC_READY_S = 240.0             # a worker's boot on the card, kernels cached


def free_base_port(n: int) -> int:
    """A base port with `n` consecutive free ports above it."""
    import socket

    rng = np.random.default_rng()
    for _ in range(200):
        base = int(rng.integers(20000, 40000))
        ok = True
        for p in range(base, base + n):
            with socket.socket() as s:
                try:
                    s.bind(("127.0.0.1", p))
                except OSError:
                    ok = False
                    break
        if ok:
            return base
    raise RuntimeError("no run of free ports")


def write_lm_dir(cfg, path) -> None:
    """`cli lm`'s output format: lm_config.json + lm_params.npz, the
    weights `numpy_params(cfg, seed=0)` (float32 on disk, the config
    dtype when served)."""
    import dataclasses
    import pathlib

    from deeplearning4j_tpu_torch.parallel.transformer import numpy_params
    from deeplearning4j_tpu_torch.runtime.checkpoint import tree_to_npz

    path = pathlib.Path(path)
    path.mkdir(parents=True, exist_ok=True)
    (path / "lm_config.json").write_text(json.dumps(dataclasses.asdict(cfg)))
    tree_to_npz(path / "lm_params.npz", numpy_params(cfg, seed=0))


def recording_spawns(sup) -> list:
    """Every process `sup` spawns, in spawn order (its `_spawn` wrapped)."""
    procs = []
    orig = sup._spawn

    def spawn(worker):
        orig(worker)
        if worker.proc is not None and worker.proc not in procs:
            procs.append(worker.proc)

    sup._spawn = spawn
    return procs


def client_storm(fn, n: int) -> dict:
    """`n` requests through `fn(i)` -> (status, body) from n threads: the
    client's ledger (submitted = answered + rejected + failed) and the
    answers by index."""
    lock = threading.Lock()
    led = {"submitted": 0, "answered": 0, "rejected": 0, "failed": 0,
           "errors": []}
    answers = [None] * n

    def one(i):
        with lock:
            led["submitted"] += 1
        try:
            code, body = fn(i)
        except Exception as e:  # noqa: BLE001 — the storm counts failures
            with lock:
                led["failed"] += 1
                led["errors"].append(repr(e)[:200])
            return
        with lock:
            if code == 200:
                led["answered"] += 1
                answers[i] = body
            elif code in (429, 503):
                led["rejected"] += 1
            else:
                led["failed"] += 1
                led["errors"].append(f"{code} {str(body)[:200]}")

    t0 = time.perf_counter()
    concurrently([(lambda i=i: one(i)) for i in range(n)])
    led["wall_s"] = time.perf_counter() - t0
    led["answers"] = answers
    return led


def storm_ok(name: str, led: dict) -> None:
    if led["failed"] or led["submitted"] != led["answered"] + led["rejected"]:
        raise AssertionError(f"procfleet: {name}: {led['failed']} failed "
                             f"client requests, ledger {led}")


def wait_readmitted(sup, n_restarts: int, timeout_s: float) -> None:
    """Until `sup` counted `n_restarts` restarts and every worker that is
    not quarantined or stopped is ready again."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        st = sup.stats()
        if st["counters"]["restarts"] >= n_restarts and all(
                w["state"] in ("ready", "quarantined", "stopped")
                for w in st["workers"].values()):
            return
        time.sleep(0.1)
    raise AssertionError(f"procfleet: no re-admission: {sup.stats()}")


def worker_launch_check(name: str, snap: dict, n_layers: int) -> dict:
    """One worker's kernel counts from its SIGTERM drain snapshot: B1 by
    width since the warm-up = n_layers x the pool's dispatches by width."""
    kl = snap["kernel_launches"]
    warm, total = kl["warmup"], kl["total"]
    by_width = {w: n - warm["paged_attention_by_width"].get(w, 0)
                for w, n in total["paged_attention_by_width"].items()}
    by_width = {w: n for w, n in by_width.items() if n}
    dispatches = {w: n for w, n in snap["lm"]["dispatch_widths"].items()
                  if n}
    want = {w: n_layers * n for w, n in dispatches.items()}
    if by_width != want:
        raise AssertionError(f"procfleet: {name}: B1 by width {by_width} != "
                             f"n_layers x dispatches by width {want}")
    return {"b1_by_width": by_width, "dispatches_by_width": dispatches,
            "b2": total["flash_fwd"] - warm["flash_fwd"],
            "requests": snap["lm"]["requests"]}


def compute_app_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=30)
    return [int(x) for x in out.stdout.split() if x.strip().isdigit()]


def procfleet_phase(card: str) -> dict:
    """3 `cli serve -lm` workers of the bf16 gpt2_small and one `serve
    -model zoo:mnist-mlp` worker, each its own process on the card under a
    `FleetSupervisor`, behind `FleetServer` fronts: a SIGKILL mid-storm,
    a SIGSTOP wedge and a boot flake into crash-loop quarantine
    (`chaos_procfleet`), zero failed client requests throughout."""
    import os
    import tempfile

    import torch

    from deeplearning4j_tpu_torch import _build
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, mnist_mlp
    from deeplearning4j_tpu_torch.parallel.transformer import (
        gpt2_small,
        numpy_params,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.resilience import (
        ProcessChaosConfig,
        chaos_procfleet,
    )
    from deeplearning4j_tpu_torch.runtime.launcher import (
        FleetProcessLauncher,
        replica_serve_command,
    )
    from deeplearning4j_tpu_torch.serving import FleetRouter, FleetServer
    from deeplearning4j_tpu_torch.serving.procfleet import (
        FleetSupervisor,
        RestartPolicy,
        WorkerSpec,
    )

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()          # cached: the workers load it instead of nvcc
    cfg = gpt2_small(max_len=1024)
    out = {"card": card, "lm_workers": PROC_LM_WORKERS,
           "new_tokens": PROC_NEW}
    tmp = tempfile.mkdtemp(prefix="procfleet-")
    write_lm_dir(cfg, os.path.join(tmp, "lm"))
    lm_launch = FleetProcessLauncher(
        None, n_replicas=PROC_LM_WORKERS,
        base_port=free_base_port(PROC_LM_WORKERS), lm_dir=os.path.join(
            tmp, "lm"), lm_slots=8, lm_page_size=16, prefill_chunk=16,
        log_dir=os.path.join(tmp, "lm-logs"), device="cuda")
    cls_launch = FleetProcessLauncher(
        "zoo:mnist-mlp", n_replicas=1, base_port=free_base_port(2),
        buckets="1,8,32", log_dir=os.path.join(tmp, "cls-logs"),
        device="cuda")
    policy = dict(backoff_initial_s=0.5, backoff_max_s=4.0, jitter=0.0,
                  crash_loop_threshold=3, crash_loop_window_s=60.0)
    kw = dict(poll_interval_s=0.25, ready_timeout_s=PROC_READY_S,
              wedge_threshold=3, probe_timeout_s=2.0, detach_grace_s=0.5)
    lm_router = FleetRouter(request_timeout_s=OPS_TIMEOUT_S,
                            affinity_spill_depth=16)
    cls_router = FleetRouter(request_timeout_s=OPS_TIMEOUT_S)
    lm_sup = FleetSupervisor(lm_router, policy=RestartPolicy(**policy), **kw)
    cls_sup = FleetSupervisor(cls_router, policy=RestartPolicy(**policy),
                              **kw)
    spawned = recording_spawns(lm_sup)
    cls_spawned = recording_spawns(cls_sup)
    fronts = []
    try:
        t0 = time.perf_counter()
        lm_sup.manage_launcher(lm_launch)
        cls_sup.manage_launcher(cls_launch)
        lm_sup.start()
        cls_sup.start()
        if not (lm_sup.wait_all_ready(PROC_READY_S)
                and cls_sup.wait_all_ready(PROC_READY_S)):
            raise AssertionError(f"procfleet: workers not ready: "
                                 f"{lm_sup.stats()} {cls_sup.stats()}")
        out["boot_s"] = time.perf_counter() - t0
        front = FleetServer(lm_router, port=0).start()
        cls_front = FleetServer(cls_router, port=0).start()
        fronts = [front, cls_front]
        lm_router.start_health_loop()
        cls_router.start_health_loop()
        params = params_from_numpy(numpy_params(cfg, seed=0), device="cuda",
                                   dtype=cfg.dtype)
        check = greedy_checker(cfg, params)
        reqs = [p for p, _, _ in decode_requests(cfg)[:12]]

        def generate(i, body=None):
            a = http_json(front.url, "/lm/generate",
                          dict(body or {}, prompt_ids=reqs[i % len(reqs)],
                               max_new_tokens=PROC_NEW), f"proc-{i}")
            return a["status"], a["body"]

        def held(name, led):
            storm_ok(name, led)
            checks = [check(reqs[i], a["ids"])
                      for i, a in enumerate(led["answers"]) if a]
            return dict({k: v for k, v in led.items() if k != "answers"},
                        tokens_per_s=len(reqs) * PROC_NEW / led["wall_s"],
                        **checks_summary(checks))

        # A: SIGKILL of the worker serving dispatch attempt PROC_KILL_AT
        chaos = chaos_procfleet(lm_sup, ProcessChaosConfig(
            kill_at_dispatch=PROC_KILL_AT))
        out["kill"] = held("kill", client_storm(generate, len(reqs)))
        chaos.uninstall()
        if len(chaos.killed) != 1:
            raise AssertionError(f"procfleet: no SIGKILL fired {chaos.killed}")
        wait_readmitted(lm_sup, 1, PROC_READY_S)
        crash = [d for w in lm_sup.stats()["workers"].values()
                 for d in w["deaths"] if d["kind"] == "crash"]
        if not crash or "signal 9" not in crash[-1]["detail"]:
            raise AssertionError(f"procfleet: kill not classified crash: "
                                 f"{lm_sup.stats()}")
        out["kill"].update(victim=chaos.killed[0],
                           readmit_s=lm_sup.restart_events[-1]["latency_s"])
        # B: SIGSTOP wedge of the worker serving attempt PROC_STOP_AT
        chaos = chaos_procfleet(lm_sup, ProcessChaosConfig(
            sigstop_at_dispatch=PROC_STOP_AT))
        out["wedge"] = held("wedge", client_storm(generate, len(reqs)))
        chaos.uninstall()
        if len(chaos.stopped) != 1:
            raise AssertionError(f"procfleet: no SIGSTOP fired")
        wait_readmitted(lm_sup, 2, PROC_READY_S)
        if lm_sup.counters["deaths_wedged"] != 1:
            raise AssertionError(f"procfleet: wedge not classified: "
                                 f"{lm_sup.stats()}")
        out["wedge"].update(victim=chaos.stopped[0],
                            readmit_s=lm_sup.restart_events[-1]["latency_s"])
        # C: no fault — SSE streams (TTFT) and one top-k request (B2)
        ttfts = []

        def stream(i):
            s = sse_request(front.url, {"prompt_ids": reqs[i],
                                        "max_new_tokens": PROC_NEW},
                            f"proc-sse-{i}")
            if s["t_first"] is not None:
                ttfts.append(s["t_first"] - s["t_send"])
            if s["done"] is None or s["done"] != reqs[i] + s["tokens"]:
                return 500, s
            return s["status"], {"ids": s["done"]}

        out["streams"] = held("streams", client_storm(stream, len(reqs)))
        out["streams"].update(ttft_p50_ms=percentile_ms(ttfts, 0.50),
                              ttft_p99_ms=percentile_ms(ttfts, 0.99))
        code, body = generate(0, {"top_k": 40, "seed": 3})
        ids = body.get("ids", []) if code == 200 else []
        if ids[:len(reqs[0])] != reqs[0] or len(ids) != len(reqs[0]) + \
                PROC_NEW or max(ids) >= cfg.vocab_size:
            raise AssertionError(f"procfleet: top-k {code} {body}")
        # the classifier worker: replies = the same net on the card
        net = MultiLayerNetwork(mnist_mlp()).init()
        rng = np.random.default_rng(0)
        xs = [rng.random((1, 784)).astype(np.float32)
              for _ in range(PROC_CLS_REQS)]

        def predict(i):
            a = http_json(cls_front.url, "/model/predict",
                          {"features": xs[i].tolist()}, f"proc-cls-{i}")
            return a["status"], a["body"]

        led = client_storm(predict, PROC_CLS_REQS)
        storm_ok("classifier", led)
        err = max(worst_rel(np.asarray(a["outputs"], np.float32),
                            net.output(x).cpu().numpy())
                  for a, x in zip(led["answers"], xs))
        if not err <= CLS_RTOL:
            raise AssertionError(f"procfleet: a classifier reply is {err} "
                                 f"from the same net on the card")
        out["classifier"] = dict(
            {k: v for k, v in led.items() if k != "answers"},
            max_rel_err=err)
        # a boot flake repeated into crash-loop quarantine
        chaos = chaos_procfleet(cls_sup, ProcessChaosConfig(
            flake_boot_spawns=(0, 1, 2, 3), flake_exit_code=3))
        flaky_port = cls_launch.port(1)
        cls_sup.manage(WorkerSpec(
            name="flaky", url=f"http://127.0.0.1:{flaky_port}",
            command=replica_serve_command("zoo:mnist-mlp", port=flaky_port,
                                          device="cuda")))
        deadline = time.monotonic() + 60
        while cls_sup.stats()["workers"]["flaky"]["state"] != "quarantined":
            if time.monotonic() > deadline:
                raise AssertionError(f"procfleet: no quarantine: "
                                     f"{cls_sup.stats()}")
            time.sleep(0.1)
        chaos.uninstall()
        fleet_stats = json.loads(http_get(cls_front.url, "/fleet/stats")[1])
        sup_st = fleet_stats["supervision"]
        if sup_st["quarantined"] != ["flaky"] or "CrashLoopError" not in \
                (sup_st["workers"]["flaky"]["error"] or ""):
            raise AssertionError(f"procfleet: /fleet/stats {sup_st}")
        out["crash_loop"] = {"spawns": chaos.spawns,
                             "error": sup_st["workers"]["flaky"]["error"]}
        code, text = http_get(front.url, "/metrics")
        fams = sorted({ln.split("{")[0].split(" ")[0]
                       for ln in text.splitlines()
                       if ln.startswith("fleet_process_")})
        bad = [ln for ln in text.splitlines() if ln and not
               ln.startswith("#") and len(ln.rsplit(" ", 1)) != 2]
        need = {"fleet_process_spawns_total", "fleet_process_restarts_total",
                "fleet_process_deaths_total", "fleet_process_workers",
                "fleet_process_last_restart_latency_seconds"}
        if code != 200 or not need <= set(fams) or bad:
            raise AssertionError(f"procfleet: /metrics {code} {fams} {bad}")
        out["metrics_families"] = fams
        out["supervision"] = {"lm": lm_sup.stats()["counters"],
                              "classifier": cls_sup.stats()["counters"]}
    finally:
        for f in fronts:
            f.stop()
        lm_sup.stop(grace_s=30.0)
        cls_sup.stop(grace_s=30.0)
        lm_router.stop()
        cls_router.stop()
    # every worker ever spawned is reaped, none left on the card
    procs = spawned + cls_spawned
    alive = []
    for p in procs:
        try:
            os.kill(p.pid, 0)
            alive.append(p.pid)
        except ProcessLookupError:
            pass
    on_card = sorted(set(compute_app_pids()) & {p.pid for p in procs})
    if any(p.returncode is None for p in procs) or alive or on_card:
        raise AssertionError(f"procfleet: workers left: alive {alive}, on "
                             f"the card {on_card}")
    out["processes"] = {"spawned": len(procs), "reaped": len(procs)}
    # B1 and B2 from each LM worker's drain snapshot (its last incarnation)
    workers, b2 = {}, 0
    for i in range(PROC_LM_WORKERS):
        with open(os.path.join(tmp, "lm-logs",
                               f"worker-{i}.drain.json")) as f:
            snap = json.load(f)
        workers[f"worker-{i}"] = worker_launch_check(f"worker-{i}", snap,
                                                     cfg.n_layers)
        b2 += workers[f"worker-{i}"]["b2"]
    if b2 != cfg.n_layers or not any(w["b1_by_width"]
                                     for w in workers.values()):
        raise AssertionError(f"procfleet: B2 {b2} (want {cfg.n_layers}), "
                             f"workers {workers}")
    out["worker_launches"] = workers
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"procfleet: {PROC_LM_WORKERS} LM worker processes + 1 classifier "
        f"on the card, boot {out['boot_s']:.1f} s; SIGKILL storm failed "
        f"{out['kill']['failed']} (readmit {out['kill']['readmit_s']} s), "
        f"SIGSTOP storm failed {out['wedge']['failed']} (readmit "
        f"{out['wedge']['readmit_s']} s), crash loop quarantined after "
        f"{out['crash_loop']['spawns']} spawns; streams "
        f"{out['streams']['tokens_per_s']:.1f} tokens/s, TTFT p50 "
        f"{out['streams']['ttft_p50_ms']:.1f} / p99 "
        f"{out['streams']['ttft_p99_ms']:.1f} ms; {len(procs)} processes "
        f"reaped; B1/B2 per worker {[(n, w['b1_by_width'], w['b2']) for n, w in workers.items()]} "
        f"({card})")
    return out


# ---------------------------------------------------------------------------
# phase 20: supervised, checkpointed training (TrainingSupervisor)

RES_BATCHES = 24                 # real batches of the stream
RES_NAN_AT = (5, 17)             # fetch positions of the extra NaN records
RES_FETCH_FAIL_AT, RES_PREEMPT_AT = 9, 13
RES_CKPT_EVERY = 5
RES_INVALID_AT = 7               # the one-shot InvalidScoreError's step
RES_REL = 1e-6                   # per-leaf relative bound where not bitwise
RES_TIMED = 5                    # checkpoint saves / loads timed
RES_CLI_EPOCHS = 200             # 1000 supervised steps of iris-mlp


def char_batches(n: int, seed: int = 1) -> list:
    """`n` bench_lstm-shaped batches (B 32 x T 64 one-hot over 80
    characters, targets the ids rolled by one) as host arrays."""
    rng = np.random.default_rng(seed)
    eye = np.eye(LSTM_V, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, LSTM_V, (LSTM_B, LSTM_T))
        out.append((eye[ids], eye[np.roll(ids, -1, axis=1)]))
    return out


def leaf_compare(got, want) -> dict:
    """Bitwise, or the worst per-leaf relative difference."""
    import torch

    from deeplearning4j_tpu_torch.tree import flatten_tree

    g = {k: v.detach() for k, v in flatten_tree(got).items()}
    w = {k: v.detach() for k, v in flatten_tree(want).items()}
    bitwise = all(torch.equal(g[k], w[k]) for k in w)
    worst = max(float((g[k].float() - w[k].float()).abs().max()
                      / max(float(w[k].float().abs().max()), 1e-30))
                for k in w)
    return {"bitwise": bitwise, "max_rel_leaf": worst}


class CountingRunner:
    """A `MultiLayerNetwork` proxy counting the fit calls that reach the
    net (each launches B5 once per LSTM layer) and raising one
    `InvalidScoreError` at step `invalid_at` before the step runs."""

    def __init__(self, net, invalid_at=None):
        self.net, self.invalid_at, self.calls = net, invalid_at, 0

    def __getattr__(self, name):
        return getattr(self.net, name)

    def fit_batch(self, x, y, mask=None):
        from deeplearning4j_tpu_torch.optimize.api import InvalidScoreError

        if self.invalid_at is not None and \
                self.net._iteration == self.invalid_at:
            self.invalid_at = None
            raise InvalidScoreError(self.net._iteration, float("nan"))
        self.calls += 1
        return self.net.fit_batch(x, y, mask)

    def fit_chunk_async(self, xs, ys, masks=None, weights=None):
        self.calls += int(np.shape(xs)[0])
        return self.net.fit_chunk_async(xs, ys, masks, weights)


def supervised_leg(name: str, chunk: int, clean: list, tmp: str,
                   ref_params, n_lstm: int) -> dict:
    """The chaos stream (NaN records, a fetch failure, a preemption)
    through a supervisor, then a fresh net resumed from the emergency
    checkpoint on the same source; held against `ref_params`."""
    import os

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.resilience import (
        ChaosConfig,
        ChaosDataSource,
        ResilienceConfig,
        RetryPolicy,
        TrainingSupervisor,
    )

    stream = list(clean)
    for pos in RES_NAN_AT:
        stream.insert(pos, clean[0])
    src = ChaosDataSource(stream, ChaosConfig(
        nan_steps=RES_NAN_AT, fetch_fail_steps=(RES_FETCH_FAIL_AT,),
        preempt_at=RES_PREEMPT_AT))
    d = os.path.join(tmp, name)

    def config():
        return ResilienceConfig(
            checkpoint_dir=d, checkpoint_every=RES_CKPT_EVERY,
            chunk_size=chunk, fetch_retry=RetryPolicy(
                max_attempts=3, base_delay=0.0, jitter=0.0))

    torch.cuda.synchronize()
    lk.fused_lstm_forward.launches.reset()
    r1_runner = CountingRunner(MultiLayerNetwork(
        char_lstm(compute_dtype="bfloat16")).init())
    r1 = TrainingSupervisor(r1_runner, config()).run(src)
    r2_runner = CountingRunner(MultiLayerNetwork(
        char_lstm(compute_dtype="bfloat16", seed=9)).init())
    sup2 = TrainingSupervisor(r2_runner, config())
    resumed = sup2.resume()
    resume_step = sup2.step
    r2 = sup2.run(src)
    torch.cuda.synchronize()
    launches = lk.fused_lstm_forward.launches.value
    calls = r1_runner.calls + r2_runner.calls
    faults = [(f.kind, f.action) for f in r1.faults + r2.faults]
    out = {"chunk_size": chunk, "steps_before_preemption": r1.steps,
           "resume_step": resume_step, "steps": r2.steps,
           "skipped": r1.skipped + r2.skipped, "preempted": r1.preempted,
           "faults": faults, "b5_launches": launches,
           "b5_launches_want": n_lstm * calls, "fit_steps": calls,
           "final_loss": r2.final_loss,
           **leaf_compare(r2_runner.net.params, ref_params)}
    if not (resumed and r1.preempted and not r2.preempted
            and out["skipped"] == len(RES_NAN_AT)
            and faults.count(("fetch_error", "retry")) == 1
            and resume_step == r1.steps and r2.steps == len(clean)
            and calls == len(clean) and launches == n_lstm * calls
            and (out["bitwise"] or out["max_rel_leaf"] <= RES_REL)):
        raise AssertionError(f"resilience: {name} leg {out}")
    return out


def resilience_phase(card: str) -> dict:
    """`TrainingSupervisor` over the char-LSTM at bench_lstm width (bf16
    compute, B5 every step): a chaos stream with a preemption resumed by
    a fresh net equal to an uninterrupted run, a rollback from a one-shot
    `InvalidScoreError`, the chunk 4 path; crash-safe checkpoints; ``cli
    train -resilience`` SIGTERM'd and resumed."""
    import os
    import re
    import signal
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.resilience import (
        ChaosConfig,
        ChaosDataSource,
        CheckpointChaosConfig,
        InjectedCheckpointCrash,
        ResilienceConfig,
        TrainingSupervisor,
        chaos_checkpoint,
        corrupt_checkpoint,
    )
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        CheckpointCorruptError,
        latest_checkpoint,
        load_checkpoint,
        save_checkpoint,
        verify_checkpoint,
    )

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="resilience-")
    clean = char_batches(RES_BATCHES)
    out = {"card": card, "shape": dict(T=LSTM_T, B=LSTM_B, H=LSTM_H,
                                       V=LSTM_V), "dtype": "bfloat16",
           "batches": RES_BATCHES}

    def fresh():
        return MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()

    n_lstm = sum(hasattr(lc, "fused") for lc in fresh().conf.layers)
    # the references: uninterrupted runs over the same real batches
    plain = fresh()
    plain.fit_batch(*clean[0])                 # warm the kernels
    plain = fresh()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for x, y in clean:
        plain.fit_batch(x, y)
    plain_ms = (time.perf_counter() - t0) * 1e3 / RES_BATCHES
    refs = {}
    for chunk in (1, 4):
        net = fresh()
        sup = TrainingSupervisor(net, ResilienceConfig(
            checkpoint_dir=os.path.join(tmp, f"ref-{chunk}"),
            checkpoint_every=RES_CKPT_EVERY, chunk_size=chunk))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = sup.run(ChaosDataSource(clean, ChaosConfig()))
        out[f"supervised_step_ms_chunk{chunk}"] = (
            (time.perf_counter() - t0) * 1e3 / RES_BATCHES)
        if rep.steps != RES_BATCHES or rep.faults:
            raise AssertionError(f"resilience: reference run {rep}")
        refs[chunk] = net.params
    out["unsupervised_step_ms"] = plain_ms
    out["supervised_vs_plain"] = leaf_compare(refs[1], plain.params)
    out["chaos"] = supervised_leg("chaos", 1, clean, tmp, refs[1], n_lstm)
    out["chunked"] = supervised_leg("chunked", 4, clean, tmp, refs[4],
                                    n_lstm)
    # rollback: a one-shot InvalidScoreError inside step RES_INVALID_AT
    lk.fused_lstm_forward.launches.reset()
    runner = CountingRunner(fresh(), invalid_at=RES_INVALID_AT)
    rep = TrainingSupervisor(runner, ResilienceConfig(
        checkpoint_dir=os.path.join(tmp, "rollback"),
        checkpoint_every=RES_CKPT_EVERY)).run(
            ChaosDataSource(clean, ChaosConfig()))
    torch.cuda.synchronize()
    out["rollback"] = {"rollbacks": rep.rollbacks, "lr_scale": rep.lr_scale,
                       "steps": rep.steps, "final_loss": rep.final_loss,
                       "fit_steps": runner.calls,
                       "b5_launches": lk.fused_lstm_forward.launches.value,
                       "faults": [(f.kind, f.action) for f in rep.faults]}
    if not (rep.rollbacks == 1 and rep.lr_scale == 0.5
            and math.isfinite(rep.final_loss)
            and out["rollback"]["b5_launches"] == n_lstm * runner.calls):
        raise AssertionError(f"resilience: rollback {out['rollback']}")
    # crash safety at the char-LSTM's size
    net = fresh()
    net.fit_batch(*clean[0])
    d = os.path.join(tmp, "crash")
    save_checkpoint(d, 1, net.params, updater_state=net.updater_state,
                    net_state=net.state)
    with chaos_checkpoint(CheckpointChaosConfig(crash_at_phase="manifest")):
        try:
            save_checkpoint(d, 2, net.params,
                            updater_state=net.updater_state)
            raise AssertionError("resilience: the chaos save did not die")
        except InjectedCheckpointCrash:
            pass
    if latest_checkpoint(d).name != "ckpt-1":
        raise AssertionError("resilience: a torn save became the latest")
    refused = []
    for mode in ("flip", "truncate"):
        corrupt_checkpoint(os.path.join(d, "ckpt-1"), mode=mode)
        try:
            verify_checkpoint(os.path.join(d, "ckpt-1"))
            raise AssertionError(f"resilience: {mode} not refused")
        except CheckpointCorruptError as e:
            refused.append(f"{mode}: {str(e)[:80]}")
        save_checkpoint(d, 1, net.params, updater_state=net.updater_state,
                        net_state=net.state)      # rebuilt
        verify_checkpoint(os.path.join(d, "ckpt-1"))
    out["crash_safety"] = {"torn_save": "previous step kept",
                           "refused": refused}
    # checkpoint save and load at this size
    save_ms, load_ms = [], []
    for i in range(RES_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "timed"), i, net.params,
                        updater_state=net.updater_state, net_state=net.state)
        save_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        load_checkpoint(os.path.join(tmp, "timed"), net.params,
                        net.updater_state)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)
    out["checkpoint_save_ms"] = sorted(save_ms)[RES_TIMED // 2]
    out["checkpoint_load_ms"] = sorted(load_ms)[RES_TIMED // 2]
    out["checkpoint_bytes"] = sum(
        os.path.getsize(os.path.join(tmp, "timed", f"ckpt-{RES_TIMED - 1}",
                                     f))
        for f in os.listdir(os.path.join(tmp, "timed",
                                         f"ckpt-{RES_TIMED - 1}")))
    # the CLI: SIGTERM after the first checkpoint, then the same command
    csv = os.path.join(tmp, "iris.csv")
    iris_like_csv(csv)
    cli_out = os.path.join(tmp, "cli")
    cmd = [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
           "-input", csv, "-model", "zoo:iris-mlp", "-output", cli_out,
           "-epochs", str(RES_CLI_EPOCHS), "-resilience", "-ckpt-every",
           str(RES_CKPT_EVERY), "-device", "cuda"]
    total = RES_CLI_EPOCHS * 5
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 300
        while not os.path.exists(os.path.join(cli_out, "ckpts", "ckpt-5")):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise AssertionError(f"resilience: cli train never "
                                     f"checkpointed: {proc.stdout.read()}")
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        text, _ = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    m = re.search(r"preempted — emergency checkpoint at step (\d+)", text)
    if proc.returncode != 0 or not m or not os.path.exists(os.path.join(
            cli_out, "ckpts", f"ckpt-{m.group(1)}")):
        raise AssertionError(f"resilience: cli SIGTERM rc {proc.returncode}"
                             f": {text[-2000:]}")
    stopped = int(m.group(1))
    t0 = time.perf_counter()
    again = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
    if again.returncode != 0 or \
            f"resumed from checkpoint step {stopped}" not in again.stdout \
            or f"resilience: completed: {total} steps" not in again.stdout:
        raise AssertionError(f"resilience: cli resume rc "
                             f"{again.returncode}: {again.stdout[-2000:]} "
                             f"{again.stderr[-2000:]}")
    out["cli"] = {"preempted_at": stopped, "steps": total,
                  "resume_run_s": time.perf_counter() - t0}
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"resilience: char-LSTM bf16 chaos + resume "
        f"{'bitwise' if out['chaos']['bitwise'] else 'max rel ' + format(out['chaos']['max_rel_leaf'], '.3g')}"
        f" vs the uninterrupted run (chunk 4: "
        f"{'bitwise' if out['chunked']['bitwise'] else format(out['chunked']['max_rel_leaf'], '.3g')}"
        f"), B5 {out['chaos']['b5_launches']} = {n_lstm} x "
        f"{out['chaos']['fit_steps']} steps; rollback lr_scale "
        f"{out['rollback']['lr_scale']}; step ms supervised "
        f"{out['supervised_step_ms_chunk1']:.2f} vs plain {plain_ms:.2f}; "
        f"checkpoint save {out['checkpoint_save_ms']:.1f} ms / load "
        f"{out['checkpoint_load_ms']:.1f} ms ({out['checkpoint_bytes']} "
        f"bytes); cli SIGTERM at step {stopped}, resumed to {total} "
        f"({card})")
    return out


# ---------------------------------------------------------------------------
# phase 21: the sentiment pipeline (tagger -> TreeParser -> RNTN, the RAE)

# 20 held-out sentences none of which is in the seed corpus; the first 5
# are tests/test_quality_gates.py's hand-tagged ones
TAGGER_HELD_OUT = [
    "the quiet student reads in the library .",
    "three dogs chased the red ball .",
    "she slowly opens a small box .",
    "my friend and his sister sing loudly .",
    "cold rain falls on the empty street .",
    "the young doctor carefully examined the sick child .",
    "two cats slept under the warm stove all afternoon .",
    "our neighbours painted their old fence bright blue .",
    "he quickly finished the difficult puzzle .",
    "the tiny bird built a nest in the tall oak .",
    "we visited the famous museum last summer .",
    "a loud thunderstorm shook the quiet town .",
    "the clever fox escaped from the angry farmer .",
    "my grandmother bakes delicious apple pies on sunday .",
    "five runners crossed the finish line together .",
    "the zorbulous quibbler vanished 42 times faster .",
    "students often forget their heavy books at school .",
    "the calm lake reflected the golden evening sky .",
    "they happily sang old songs around the fire .",
    "a strange noise woke the tired travellers .",
]
TAGGER_GOLD = [
    ["DET", "ADJ", "NOUN", "VERB", "ADP", "DET", "NOUN", "."],
    ["NUM", "NOUN", "VERB", "DET", "ADJ", "NOUN", "."],
    ["PRON", "ADV", "VERB", "DET", "ADJ", "NOUN", "."],
    ["PRON", "NOUN", "CONJ", "PRON", "NOUN", "VERB", "ADV", "."],
    ["ADJ", "NOUN", "VERB", "ADP", "DET", "ADJ", "NOUN", "."],
]
SST_TREES = 8544           # SST's training split (Socher et al. 2013)
SST_ID_SPACE = 25_000      # zipf ids drawn; ~20 000 distinct words appear
SST_EPOCHS = 10
SST_REDUCED = (
    "synthetic treebank (SST is not in the repository): 8 544 right-"
    "branching trees over seeded zipf sentences of 2-50 tokens (<= 99 "
    "nodes), every node labelled 0-4 from its span's mean word score; "
    "10 epochs, not the reference's to convergence")
GATE_SEEDS = (0, 1, 2)


def stratified_split(trees, seed: int, frac: float = 0.8):
    """tests/test_quality_gates.py's `_stratified_split` (80/20 per class,
    ``default_rng(seed)``)."""
    rng = np.random.default_rng(seed)
    tr, te = [], []
    for cls in (0, 1):
        grp = [t for t in trees if t.label == cls]
        idx = rng.permutation(len(grp))
        k = int(frac * len(grp))
        tr += [grp[i] for i in idx[:k]]
        te += [grp[i] for i in idx[k:]]
    return tr, te


def tree_shape(tree):
    """A tree as nested (label, word, children) tuples."""
    return (tree.label, tree.word, tuple(tree_shape(c)
                                         for c in tree.children))


def sst_scale_trees(n: int, id_space: int, seed: int = 0) -> list:
    """`n` right-branching trees over zipf sentences of 2-50 tokens; a
    word's score is 0 for 70 % of the words and N(0, 1) for the rest;
    each node's label is its span's mean score cut at -0.75, -0.25,
    0.25, 0.75 into 0-4."""
    from deeplearning4j_tpu_torch.nlp import right_branching

    rng = np.random.default_rng(seed)
    score = rng.standard_normal(id_space) * (rng.random(id_space) < 0.3)
    lens = rng.integers(2, 51, n)
    zipf = 1.0 / np.arange(1, id_space + 1)
    ids = rng.choice(id_space, size=int(lens.sum()), p=zipf / zipf.sum())
    edges = np.array([-0.75, -0.25, 0.25, 0.75])
    trees, k = [], 0
    for length in lens:
        sent = ids[k:k + length]
        k += length
        suffix = np.cumsum(score[sent][::-1])[::-1] / np.arange(length, 0, -1)
        cls = np.searchsorted(edges, suffix, side="right")
        leaf = np.searchsorted(edges, score[sent], side="right")
        root = node = right_branching([f"w{i}" for i in sent])
        for j in range(length - 1):          # node j spans tokens j..end
            node.label = int(cls[j])
            node.children[0].label = int(leaf[j])
            node = node.children[1]
        node.label = int(leaf[-1])
        trees.append(root)
    return trees


def tree_grads_card_vs_cpu(module, params, arrays, *extra) -> dict:
    """A tree model's loss and gradients from the same inputs on the
    card and on the CPU (TF32 off): relative max error of the loss and of
    each gradient."""
    import torch

    from deeplearning4j_tpu_torch.models.rntn import loss_and_grads

    out = {}
    for dev in ("cpu", "cuda"):
        loss, grads = loss_and_grads(
            module.loss_fn, {k: v.to(dev) for k, v in params.items()},
            tuple(a.to(dev) for a in arrays), *extra)
        out[dev] = (float(loss), {k: g.cpu() for k, g in grads.items()})
    torch.cuda.synchronize()
    (lc, gc), (lg, gg) = out["cpu"], out["cuda"]
    errs = {k: worst_rel(gg[k], gc[k]) for k in gc}
    return {"loss_cpu": lc, "loss_card": lg,
            "loss_rel_err": abs(lg - lc) / max(abs(lc), 1e-30),
            "grad_rel_err": errs, "worst_grad": max(errs, key=errs.get),
            "worst_grad_rel_err": max(errs.values())}


def sentiment_tagging(card: str) -> dict:
    """The seed corpus and 20 held-out sentences tagged on the card and
    on the CPU by `default_tagger` (equal tags, hard); Viterbi at T 64,
    S 45 on seeded emissions (equal paths, log-prob within 1e-5
    relative, hard)."""
    import torch

    from deeplearning4j_tpu_torch.nlp import default_tagger
    from deeplearning4j_tpu_torch.nlp.annotators import seed_corpus
    from deeplearning4j_tpu_torch.utils import Viterbi

    t0 = time.perf_counter()
    card_tagger = default_tagger("cuda")
    fit_s = time.perf_counter() - t0
    cpu_tagger = default_tagger("cpu")
    sentences = [[w for w, _ in s] for s in seed_corpus()] + [
        s.split() for s in TAGGER_HELD_OUT]
    differ = [i for i, toks in enumerate(sentences)
              if card_tagger.tag(toks) != cpu_tagger.tag(toks)]
    if differ:
        raise AssertionError(f"sentiment: the card's tags differ from the "
                             f"CPU's on sentences {differ}")
    gold = [t for toks, tags in zip(TAGGER_HELD_OUT, TAGGER_GOLD)
            for t in zip(card_tagger.tag(toks.split()), tags)]
    held_out_acc = float(np.mean([got == want for (_, got), want in gold]))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for toks in sentences:
        card_tagger.tag(toks)
    tag_ms = (time.perf_counter() - t0) * 1e3 / len(sentences)

    rng = np.random.default_rng(0)
    emit = np.log(rng.dirichlet(np.ones(45), size=64))
    trans = np.log(rng.dirichlet(np.full(45, 0.5), size=45))
    init = np.log(rng.dirichlet(np.ones(45)))
    vit = Viterbi(trans, init, log_space=True, device="cuda")
    path, logp = vit.decode(emit, log_space=True)
    cpu_path, cpu_logp = Viterbi(trans, init, log_space=True,
                                 device="cpu").decode(emit, log_space=True)
    logp_err = abs(logp - cpu_logp) / abs(cpu_logp)
    if not (np.array_equal(path, cpu_path) and logp_err <= 1e-5):
        raise AssertionError(
            f"sentiment: Viterbi T 64 S 45 on the card: path equal "
            f"{np.array_equal(path, cpu_path)}, log-prob rel err "
            f"{logp_err:.3g} (limit 1e-5)")
    decode_ms = cuda_ms(lambda: vit.decode(emit, log_space=True), iters=20,
                        warmup=2)
    log(f"sentiment: tagger fitted on the card in {fit_s:.2f} s; "
        f"{len(sentences)} sentences tagged equal on card and CPU, "
        f"{tag_ms:.2f} ms a sentence, held-out accuracy {held_out_acc:.3f}; "
        f"Viterbi T 64 S 45 path equal, log-prob rel err {logp_err:.3g}, "
        f"{decode_ms:.3f} ms a decode ({card})")
    return {"sentences": len(sentences), "tags_equal": True,
            "tagger_fit_s": fit_s, "tag_ms_a_sentence": tag_ms,
            "held_out_accuracy_5_gold": held_out_acc,
            "viterbi_T64_S45": {"path_equal": True, "logp": logp,
                                "logp_rel_err": logp_err,
                                "decode_ms": decode_ms}}


def rntn_quality_gate(trees) -> dict:
    """tests/test_quality_gates.py:191 on the card: three stratified
    splits, RNTN(num_classes=2, d=16, lr=0.05, epochs=100); the mean
    held-out root accuracy must be >= 0.6."""
    from deeplearning4j_tpu_torch.models import RNTN, RNTNEval

    accs, fit_s = [], []
    for seed in GATE_SEEDS:
        train, test = stratified_split(trees, seed)
        t0 = time.perf_counter()
        model = RNTN(num_classes=2, d=16, lr=0.05, epochs=100, seed=0,
                     device="cuda").fit(train)
        fit_s.append(time.perf_counter() - t0)
        ev = RNTNEval()
        ev.eval(model, test)
        accs.append(ev.root_accuracy())
    mean = float(np.mean(accs))
    if not mean >= 0.6:
        raise AssertionError(f"sentiment: held-out root accuracy {accs} "
                             f"(mean {mean:.3f}) < 0.6")
    return {"root_accuracy": accs, "mean_root_accuracy": mean,
            "fit_s": fit_s, "train_trees": len(train),
            "test_trees": len(test)}


def sst_scale_rntn(card: str, profile: bool) -> dict:
    """RNTN at the reference's width (d 25, 5 classes) on an SST-sized
    synthetic treebank: 10 epochs whose losses must be finite and
    falling; ms an epoch, nodes a second and peak memory recorded (and
    under ``--profile`` one more epoch traced)."""
    import torch

    from deeplearning4j_tpu_torch.models import RNTN
    from deeplearning4j_tpu_torch.models.rntn import program_arrays
    from deeplearning4j_tpu_torch.nlp import compile_trees

    t0 = time.perf_counter()
    trees = sst_scale_trees(SST_TREES, SST_ID_SPACE)
    build_s = time.perf_counter() - t0
    model = RNTN(num_classes=5, d=25, epochs=SST_EPOCHS, seed=0,
                 device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model.fit(trees)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    losses = model.losses
    if not (len(losses) == SST_EPOCHS and np.all(np.isfinite(losses))
            and losses[-1] < losses[0]):
        raise AssertionError(f"sentiment: SST-scale RNTN losses {losses} "
                             f"are not finite and falling")
    t0 = time.perf_counter()
    prog = compile_trees(trees, model.vocab)
    compile_s = time.perf_counter() - t0
    arrays = program_arrays(prog, model.device)
    ada = {k: torch.zeros_like(v) for k, v in model.params.items()}
    params = model.params

    def epoch():
        nonlocal params, ada
        params, ada, _ = model._step(params, ada, arrays)
    epoch_ms = cuda_ms(epoch, iters=3, warmup=1)
    nodes = int(prog.mask.sum())
    out = {"trees": len(trees), "vocab": len(model.vocab),
           "max_nodes": prog.n_nodes, "real_nodes": nodes,
           "labelled_nodes": int((prog.mask * prog.labeled).sum()),
           "tokens": int(prog.is_leaf.sum()), "d": 25, "classes": 5,
           "epochs": SST_EPOCHS, "losses": losses, "fit_s": fit_s,
           "treebank_build_s": build_s, "compile_trees_s": compile_s,
           "epoch_ms": epoch_ms, "nodes_per_s": nodes / (epoch_ms / 1e3),
           "peak_bytes": peak, "reduced": SST_REDUCED}
    if profile:
        torch.cuda.synchronize()
        prof = profiled(True)
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof.__exit__(None, None, None)
        out["profile"] = device_breakdown(prof, wall, 1)
    log(f"sentiment: SST-scale RNTN ({len(trees)} trees, vocab "
        f"{len(model.vocab)}, N {prog.n_nodes}, {nodes} nodes, d 25, 5 "
        f"classes): losses {losses[0]:.4f} -> {losses[-1]:.4f}, fit "
        f"{fit_s:.2f} s, {epoch_ms:.2f} ms an epoch, "
        f"{out['nodes_per_s']:.4g} nodes/s, peak {peak / 2**30:.2f} GiB"
        + (f", idle {out['profile']['device_idle_share']:.3f}"
           if profile else "") + f" ({card})")
    return out


def sentiment_phase(card: str, profile: bool = False) -> dict:
    """Phase 21: the reference's sentiment pipeline on the card (the HMM
    tagger on the device Viterbi -> TreeParser -> labelled trees ->
    RNTN with AdaGrad -> RNTNEval), and the recursive autoencoder."""
    import torch

    from deeplearning4j_tpu_torch.models import RecursiveAutoEncoder
    from deeplearning4j_tpu_torch.models import recursive_autoencoder as rae
    from deeplearning4j_tpu_torch.models import rntn
    from deeplearning4j_tpu_torch.nlp import compile_trees, sentiment_trees

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"tagging": sentiment_tagging(card)}

    trees = sentiment_trees(device="cuda")
    cpu_trees = sentiment_trees(device="cpu")
    if [tree_shape(t) for t in trees] != [tree_shape(t) for t in cpu_trees]:
        raise AssertionError("sentiment: the card's parses of the reviews "
                             "differ from the CPU's")
    model = rntn.RNTN(num_classes=2, d=16, seed=0, device="cpu")
    model._build_vocab(trees)
    prog = compile_trees(trees, model.vocab)
    grads = tree_grads_card_vs_cpu(
        rntn, model._init_params(), rntn.program_arrays(
            prog, torch.device("cpu")), model.reg)
    auto = RecursiveAutoEncoder(d=16, seed=0, device="cpu")
    for t in trees:
        for w in t.tokens():
            auto.vocab.setdefault(w, len(auto.vocab))
    rae_prog = compile_trees(trees, auto.vocab)
    rae_grads = tree_grads_card_vs_cpu(
        rae, auto._init_params(), rntn.program_arrays(
            rae_prog, torch.device("cpu"), with_targets=False)
        + (torch.from_numpy(rae_prog.mask),))
    for name, g in (("RNTN", grads), ("RAE", rae_grads)):
        log(f"sentiment: {name} d 16 on {len(trees)} review trees, card vs "
            f"CPU (TF32 off): loss rel err {g['loss_rel_err']:.3g}, worst "
            f"gradient {g['worst_grad']} {g['worst_grad_rel_err']:.3g}")
        if not (g["loss_rel_err"] <= 1e-4
                and g["worst_grad_rel_err"] <= 1e-4):
            raise AssertionError(f"sentiment: {name} card vs CPU beyond "
                                 f"1e-4: {g}")
    out.update(reviews=len(trees), rntn_grads=grads, rae_grads=rae_grads)

    out["quality_gate"] = rntn_quality_gate(trees)
    q = out["quality_gate"]
    log(f"sentiment: RNTN quality gate on the card, held-out root accuracy "
        f"{q['root_accuracy']} (mean {q['mean_root_accuracy']:.3f}, limit "
        f"0.6), {np.mean(q['fit_s']):.2f} s a 100-epoch fit ({card})")

    t0 = time.perf_counter()
    fitted = RecursiveAutoEncoder(d=16, lr=0.05, epochs=50, seed=0,
                                  device="cuda").fit(trees)
    rae_s = time.perf_counter() - t0
    drop = 1.0 - fitted.losses[-1] / fitted.losses[0]
    vecs = fitted.encode(trees)
    if not (np.all(np.isfinite(fitted.losses)) and drop >= 0.1
            and vecs.shape == (len(trees), 16)
            and np.all(np.isfinite(vecs))):
        raise AssertionError(f"sentiment: RAE losses {fitted.losses[0]} -> "
                             f"{fitted.losses[-1]} (fall {drop:.3f} < 0.1) "
                             f"or encodings not finite")
    log(f"sentiment: RAE 50 epochs on the card, loss {fitted.losses[0]:.4f} "
        f"-> {fitted.losses[-1]:.4f} (fall {drop:.3f}), {rae_s:.2f} s")
    out["rae_fit"] = {"first_loss": fitted.losses[0],
                      "last_loss": fitted.losses[-1], "fall": drop,
                      "fit_s": rae_s}
    out["sst_scale"] = sst_scale_rntn(card, profile)
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 22: KMeans at MNIST's shape, and a plotting listener on the card

KMEANS_N, KMEANS_D, KMEANS_K = 60_000, 784, 10


def kmeans_blobs(seed: int = 0) -> np.ndarray:
    """60 000 x 784 float32 points around 10 seeded centres (centre
    coordinates N(0, 0.15^2), noise N(0, 1)): overlapping enough that
    Lloyd takes several sweeps."""
    rng = np.random.default_rng(seed)
    centres = rng.standard_normal((KMEANS_K, KMEANS_D)) * 0.15
    which = rng.integers(0, KMEANS_K, KMEANS_N)
    pts = centres[which] + rng.standard_normal((KMEANS_N, KMEANS_D))
    return pts.astype(np.float32)


def kmeans_card_vs_cpu(card: str) -> dict:
    """Lloyd from the same initial centres on the card and on the CPU
    (TF32 off): equal n_iter, assignments equal except at near-ties (the
    two nearest centres' squared distances within 1e-4 relative, counted),
    centres within 1e-4 relative."""
    import torch

    from deeplearning4j_tpu_torch.clustering import KMeansClustering
    from deeplearning4j_tpu_torch.clustering.kmeans import (
        _pairwise_sq_dists,
        initial_indices,
        kmeans_lloyd,
    )

    t0 = time.perf_counter()
    pts = kmeans_blobs()
    data_s = time.perf_counter() - t0
    x = torch.from_numpy(pts)
    init = x[initial_indices(KMEANS_N, KMEANS_K, 0)]
    t0 = time.perf_counter()
    cpu = kmeans_lloyd(x, init)
    cpu_s = time.perf_counter() - t0
    xc, ic = x.cuda(), init.cuda()
    kmeans_lloyd(xc, ic, max_iter=2)                     # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    card_run = kmeans_lloyd(xc, ic)
    torch.cuda.synchronize()
    card_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    d2 = torch.sort(_pairwise_sq_dists(x, cpu[0]), dim=1).values
    near_tie = ((d2[:, 1] - d2[:, 0]) < 1e-4 * d2[:, 1].abs()).numpy()
    differ = card_run[1].cpu().numpy() != cpu[1].numpy()
    centre_err = worst_rel(card_run[0].cpu(), cpu[0])
    out = {"n": KMEANS_N, "d": KMEANS_D, "k": KMEANS_K,
           "n_iter_card": card_run[2], "n_iter_cpu": cpu[2],
           "host_reads": card_run[3], "near_ties": int(near_tie.sum()),
           "differ": int(differ.sum()),
           "differ_outside_near_ties": int((differ & ~near_tie).sum()),
           "centre_rel_err": centre_err, "fit_s": card_s,
           "ms_a_sweep": card_s * 1e3 / max(card_run[2], 1),
           "cpu_fit_s": cpu_s, "data_s": data_s, "peak_bytes": peak,
           # each sweep reads the points twice (distances, then sums)
           "sweep_bytes_bound_ms": 2 * pts.nbytes / HBM_BYTES_PER_S * 1e3}
    centers = card_run[0]

    def sweep():
        kmeans_lloyd(xc, centers, max_iter=1)
    out["device_ms_a_sweep"] = cuda_ms(sweep, iters=10, warmup=2)
    km = KMeansClustering(KMEANS_K, device="cuda")
    assign = km.fit(pts)
    out["predict_equals_fit"] = bool(np.array_equal(km.predict(pts), assign))
    log(f"cluster: KMeans {KMEANS_N} x {KMEANS_D}, k {KMEANS_K}: n_iter "
        f"card {card_run[2]} / CPU {cpu[2]}, {out['differ']} assignments "
        f"differ ({out['differ_outside_near_ties']} outside the "
        f"{out['near_ties']} near-ties), centres rel err {centre_err:.3g}; "
        f"fit {card_s:.3f} s ({out['ms_a_sweep']:.3f} ms a sweep with its "
        f"host read, {out['device_ms_a_sweep']:.3f} ms a timed sweep, bound "
        f"{out['sweep_bytes_bound_ms']:.3f}), CPU {cpu_s:.2f} s, peak "
        f"{peak / 2**30:.2f} GiB ({card})")
    if not (card_run[2] == cpu[2] and out["differ_outside_near_ties"] == 0
            and centre_err <= 1e-4 and card_run[3] == card_run[2]
            and out["predict_equals_fit"]):
        raise AssertionError(f"cluster: KMeans card vs CPU: {out}")
    return out


def plot_listener_on_card(tmp: str) -> dict:
    """`PlotFiltersIterationListener` and `ActivationRenderListener` on a
    card-resident bfloat16 LeNet: every fired iteration writes its file
    (PNG where matplotlib is installed, else the grid as .npy)."""
    import dataclasses
    import os

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, zoo
    from deeplearning4j_tpu_torch.plot import (
        ActivationRenderListener,
        PlotFiltersIterationListener,
    )

    conf = zoo.lenet_mnist(compute_dtype="bfloat16")
    conf = dataclasses.replace(conf, conf=dataclasses.replace(
        conf.conf, dtype="bfloat16"))
    net = MultiLayerNetwork(conf).init()
    w = net.params[0]["W"]
    rng = np.random.default_rng(0)
    x = rng.random((32, 28, 28, 1)).astype(np.float32)
    y = np.eye(10, dtype=np.float32)[rng.integers(0, 10, 32)]
    fdir, adir = os.path.join(tmp, "filters"), os.path.join(tmp, "acts")
    net.add_listener(PlotFiltersIterationListener(net, fdir, every=1))
    net.add_listener(ActivationRenderListener(net, x[:8], adir, every=2))
    for _ in range(4):
        net.fit_batch(x, y)
    torch.cuda.synchronize()
    files = {"filters": sorted(os.listdir(fdir)),
             "activations": sorted(os.listdir(adir))}
    ok = (w.is_cuda and w.dtype == torch.bfloat16
          and len(files["filters"]) == 4 and len(files["activations"]) == 2)
    if not ok:
        raise AssertionError(f"cluster: plotting listeners on the card's "
                             f"bf16 LeNet wrote {files}")
    return {"weights_dtype": str(w.dtype), "files": files}


def cluster_phase(card: str) -> dict:
    """Phase 22: KMeans at MNIST's shape card vs CPU, and the plotting
    listeners on a card-resident bfloat16 network."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {"kmeans": kmeans_card_vs_cpu(card)}
    with tempfile.TemporaryDirectory() as tmp:
        out["listeners"] = plot_listener_on_card(tmp)
    log(f"cluster: listeners on a card bf16 LeNet wrote "
        f"{out['listeners']['files']}")
    out["phase_s"] = time.perf_counter() - t_phase
    out["card"] = card
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 23: the host-only tail on the card (model import, determinism,
# remote storage, the profiler, `import_torch_sequential`, `ml`)

# HF GPT-2-small (the published "gpt2" config): the names and shapes the
# importer reads, weights from a numpy seed (no checkpoint is in the repo)
GPT2_HF = dict(vocab_size=50257, n_positions=1024, n_embd=768, n_layer=12,
               n_head=12, n_inner=None, activation_function="gelu_new",
               layer_norm_epsilon=1e-5)
TAIL_TRAIN_STEPS = 3
TAIL_DET_STEPS = 2          # steps of each determinism run
TAIL_SEQ_B = 64             # LeNet-shaped import: batch of 28 x 28 images
TAIL_ML_EPOCHS = 20
TAIL_ML_TOL = 1e-4          # iris pipeline probabilities, card vs CPU
TAIL_SEQ_TOL = 1e-5         # imported LeNet vs the module's own forward


def hf_gpt2_stand_in(seed: int = 0, **sizes):
    """An object with HF GPT2LMHeadModel's ``.config`` fields and
    ``.state_dict()`` names and shapes (tied head), its weights drawn
    from ``default_rng(seed)`` (scale 0.02, as HF initialises), and the
    numpy state dict.  GPT-2 small (`GPT2_HF`) unless `sizes` overrides
    its config fields (``n_embd``, ``n_layer``, ...)."""
    import types

    import torch

    c = types.SimpleNamespace(**{**GPT2_HF, **sizes})
    d, v, p = c.n_embd, c.vocab_size, c.n_positions
    f = 4 * d
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=0.02):
        return rng.standard_normal(shape, dtype=np.float32) * np.float32(
            scale)

    sd = {"transformer.wte.weight": normal(v, d),
          "transformer.wpe.weight": normal(p, d, scale=0.01)}
    for i in range(c.n_layer):
        h = f"transformer.h.{i}."
        for ln in ("ln_1", "ln_2"):
            sd[h + ln + ".weight"] = 1 + normal(d)
            sd[h + ln + ".bias"] = normal(d)
        sd[h + "attn.c_attn.weight"] = normal(d, 3 * d)
        sd[h + "attn.c_attn.bias"] = normal(3 * d)
        sd[h + "attn.c_proj.weight"] = normal(d, d)
        sd[h + "attn.c_proj.bias"] = normal(d)
        sd[h + "mlp.c_fc.weight"] = normal(d, f)
        sd[h + "mlp.c_fc.bias"] = normal(f)
        sd[h + "mlp.c_proj.weight"] = normal(f, d)
        sd[h + "mlp.c_proj.bias"] = normal(d)
    sd["transformer.ln_f.weight"] = 1 + normal(d)
    sd["transformer.ln_f.bias"] = normal(d)
    sd["lm_head.weight"] = sd["transformer.wte.weight"]
    tensors = {k: torch.from_numpy(a) for k, a in sd.items()}
    return types.SimpleNamespace(config=c, state_dict=lambda: tensors), sd


def imported_tree_bitwise(params, sd: dict) -> int:
    """Every imported leaf, read back, equals the stand-in's array by
    JAX's mapping, word for word; returns the leaves checked."""
    d, h = GPT2_HF["n_embd"], GPT2_HF["n_head"]
    k = d // h

    def want(i):
        p = f"transformer.h.{i}."
        qw, kw, vw = np.split(sd[p + "attn.c_attn.weight"], 3, axis=1)
        qb, kb, vb = np.split(sd[p + "attn.c_attn.bias"], 3)
        return {
            "ln1": {"scale": sd[p + "ln_1.weight"],
                    "bias": sd[p + "ln_1.bias"]},
            "ln2": {"scale": sd[p + "ln_2.weight"],
                    "bias": sd[p + "ln_2.bias"]},
            "attn": {"wq": qw.reshape(d, h, k), "wk": kw.reshape(d, h, k),
                     "wv": vw.reshape(d, h, k), "bq": qb.reshape(h, k),
                     "bk": kb.reshape(h, k), "bv": vb.reshape(h, k),
                     "wo": sd[p + "attn.c_proj.weight"].reshape(h, k, d),
                     "bo": sd[p + "attn.c_proj.bias"]},
            "mlp": {"w1": sd[p + "mlp.c_fc.weight"],
                    "b1": sd[p + "mlp.c_fc.bias"],
                    "w2": sd[p + "mlp.c_proj.weight"],
                    "b2": sd[p + "mlp.c_proj.bias"]}}

    from deeplearning4j_tpu_torch.tree import flatten_tree

    tree = {"embed": sd["transformer.wte.weight"],
            "pos": sd["transformer.wpe.weight"],
            "layers": [want(i) for i in range(GPT2_HF["n_layer"])],
            "ln_f": {"scale": sd["transformer.ln_f.weight"],
                     "bias": sd["transformer.ln_f.bias"]},
            "head": sd["lm_head.weight"].T}
    got, ref = flatten_tree(params), flatten_tree(tree)
    if sorted(got) != sorted(ref):
        raise AssertionError(f"tail: imported keys {sorted(got)[:5]}... != "
                             f"{sorted(ref)[:5]}...")
    for key, a in ref.items():
        t = got[key].detach().cpu().numpy()
        if t.dtype != np.float32 or t.shape != a.shape or \
                t.tobytes() != np.ascontiguousarray(a).tobytes():
            raise AssertionError(f"tail: imported leaf {key} differs from "
                                 f"the stand-in's array")
    return len(ref)


def flash_bwd_bitwise() -> dict:
    """B3 and B4 called twice on the same inputs (the train phase's shape,
    bf16, causal): dK, dV and dQ equal word for word.  These launches
    compare a kernel with itself and count on no path."""
    import torch

    from deeplearning4j_tpu_torch.parallel import kernels as fk

    g = torch.Generator(device="cuda").manual_seed(7)
    b, s, h, d = 2, TRAIN_SEQ, 12, FLASH_D
    q, k, v, do = (torch.randn(b, s, h, d, generator=g, device="cuda",
                               dtype=torch.bfloat16) for _ in range(4))
    o, lse = fk.flash_forward(q, k, v, True)
    delta = fk.row_delta(do, o)
    runs = [fk.flash_bwd_dkv(q, k, v, do, lse, delta, True)
            + (fk.flash_bwd_dq(q, k, v, do, lse, delta, True),)
            for _ in range(2)]
    torch.cuda.synchronize()
    out = {}
    for name, a, b2 in zip(("dk", "dv", "dq"), runs[0], runs[1]):
        out[name] = bool(torch.equal(a.view(torch.int16),
                                     b2.view(torch.int16)))
    if not all(out.values()):
        raise AssertionError(f"tail: B3 / B4 are not bitwise across two "
                             f"calls on the same inputs: {out}")
    return out


def reported(check) -> dict:
    """Run a determinism `check` and report it as it is: bitwise, or the
    first leaf that differs and its max abs diff; and its seconds."""
    from deeplearning4j_tpu_torch.runtime.determinism import (
        NondeterminismError,
    )

    t0 = time.perf_counter()
    try:
        check()
        rep = {"bitwise": True, "max_abs_diff": 0.0, "first_leaf": None}
    except NondeterminismError as e:
        rep = {"bitwise": False, "max_abs_diff": e.max_abs_diff,
               "first_leaf": e.leaf}
    return dict(rep, steps=TAIL_DET_STEPS, s=time.perf_counter() - t0)


def determinism_paths(cfg_train, params32, tokens, targets) -> dict:
    """`check_step_determinism` (2 steps from two fresh states) on the
    imported dense GPT-2 step, the MoE step and a Word2Vec NEG step, and
    `check_network_determinism` on the char-LSTM network (B5): each
    reported as it is (`reported`).  Nothing here fails the phase: only
    B3 / B4 are bitwise by design (`flash_bwd_bitwise`)."""
    import torch

    from deeplearning4j_tpu_torch.models import char_lstm
    from deeplearning4j_tpu_torch.nlp import word2vec as tw
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        _master_f32,
        make_accum_train_step,
    )
    from deeplearning4j_tpu_torch.runtime.determinism import (
        check_network_determinism,
        check_step_determinism,
    )

    def lm_check(cfg, fresh_params, tok, tgt, accum):
        step, init_state = make_accum_train_step(cfg, lr=1e-3, accum=accum,
                                                 updater="adam")

        def make_state():
            p = _master_f32(fresh_params())
            return p, init_state(p)

        def one(state):
            p, opt, _ = step(state[0], state[1], tok, tgt)
            return p, opt

        return lambda: check_step_determinism(
            make_state, one, steps=TAIL_DET_STEPS, extract=lambda st: st[0])

    out = {"gpt2_dense": reported(lm_check(
        cfg_train, lambda: tfm.map_tree(lambda t: t.detach().clone(),
                                        params32), tokens, targets,
        TRAIN_ACCUM))}
    torch.cuda.empty_cache()

    moe_cfg = moe_config()
    moe_tree = tfm.numpy_params(moe_cfg, seed=0)
    mb = TRAIN_BATCH // TRAIN_ACCUM
    out["moe"] = dict(reported(lm_check(
        moe_cfg, lambda: tfm.params_from_numpy(moe_tree, device="cuda"),
        tokens[:mb], targets[:mb], 1)), batch=mb)
    del moe_tree
    torch.cuda.empty_cache()

    x, y = char_batch()
    out["char_lstm"] = reported(lambda: check_network_determinism(
        char_lstm(compute_dtype="bfloat16"), x, y, steps=TAIL_DET_STEPS,
        device="cuda"))

    vocab, dim, b = W2V_BENCH_VOCAB, W2V_BENCH["vector_length"], \
        W2V_BENCH["batch_size"]
    rng = np.random.default_rng(11)
    zipf = np.minimum(rng.zipf(1.3, (b, 2)) - 1, vocab - 1)
    inputs = torch.from_numpy(zipf[:, 0]).cuda()
    targets_w = torch.from_numpy(zipf[:, 1]).cuda()
    negs = torch.from_numpy(rng.integers(
        0, vocab, (b, W2V_BENCH["negative"]))).cuda()
    valid = torch.ones(b, device="cuda")
    syn0 = rng.standard_normal((vocab, dim)).astype(np.float32) * 0.1
    syn1 = rng.standard_normal((vocab, dim)).astype(np.float32) * 0.1

    def w2v_step(tables):
        tw.neg_step(tables[0], tables[1], inputs, targets_w, negs, 0.025,
                    valid)
        return tables

    out["word2vec_neg"] = dict(reported(lambda: check_step_determinism(
        lambda: [torch.from_numpy(syn0).cuda(),
                 torch.from_numpy(syn1).cuda()],
        w2v_step, steps=TAIL_DET_STEPS)),
        batch=b, distinct_inputs=int(inputs.unique().numel()))
    return out


def remote_storage_on_card() -> dict:
    """The char-LSTM (bf16 compute, B5) trained 3 steps on the card, its
    params and Adam state through ``save_checkpoint_remote("memory://")``
    and back, and through `RemoteModelSaver` / `load_model_remote`: every
    leaf equal word for word, and the reloaded net's output equal."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.runtime.storage import (
        MemoryStore,
        RemoteModelSaver,
        load_checkpoint_remote,
        load_model_remote,
        save_checkpoint_remote,
    )
    from deeplearning4j_tpu_torch.tree import flatten_tree

    def words(t):
        if not t.is_floating_point():
            return t
        return t.view({2: torch.int16, 4: torch.int32,
                       8: torch.int64}[t.element_size()])

    def same(a, b) -> bool:
        fa, fb = flatten_tree(a), flatten_tree(b)
        return fa.keys() == fb.keys() and all(
            fa[k].dtype == fb[k].dtype and fa[k].device == fb[k].device
            and torch.equal(words(fa[k]), words(fb[k])) for k in fa)

    x, y = char_batch()
    net = MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()
    for _ in range(3):
        net.fit_batch(x, y)
    url = "memory://tail/ckpts"
    t0 = time.perf_counter()
    save_checkpoint_remote(url, 3, net.params,
                           updater_state=net.updater_state)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    step, params, upd, _ = load_checkpoint_remote(
        url, net.params, updater_like=net.updater_state)
    load_s = time.perf_counter() - t0
    blob = sum(len(b) for k, b in MemoryStore("tail").blobs.items())
    if step != 3 or not same(params, net.params) or \
            not same(upd, net.updater_state):
        raise AssertionError("tail: the remote checkpoint did not come "
                             "back bitwise")
    RemoteModelSaver("memory://tail/model").save(net)
    back = load_model_remote("memory://tail/model")
    if not same(back.params, net.params) or not torch.equal(
            back.output(x), net.output(x)):
        raise AssertionError("tail: the remote model did not come back "
                             "bitwise")
    MemoryStore.reset()
    return {"bitwise": True, "step": step, "save_ms": save_s * 1e3,
            "load_ms": load_s * 1e3, "stored_bytes": blob}


def sequential_import_on_card() -> dict:
    """A LeNet-shaped ``nn.Sequential`` on the card (conv 5x5 20, max
    pool, conv 5x5 50, max pool, flatten, 800 -> 500 relu -> 10) imported
    with `import_torch_sequential` onto the card, its softmax outputs
    against the module's own forward on the card, TF32 off."""
    import torch

    from deeplearning4j_tpu_torch.runtime.model_import import (
        import_torch_sequential,
    )

    torch.manual_seed(0)
    model = torch.nn.Sequential(
        torch.nn.Conv2d(1, 20, 5), torch.nn.MaxPool2d(2),
        torch.nn.Conv2d(20, 50, 5), torch.nn.MaxPool2d(2),
        torch.nn.Flatten(),
        torch.nn.Linear(800, 500), torch.nn.ReLU(),
        torch.nn.Linear(500, 10)).cuda().eval()
    net, report = import_torch_sequential(model, device="cuda")
    x = np.random.default_rng(2).random((TAIL_SEQ_B, 28, 28, 1)).astype(
        np.float32)
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            want = torch.softmax(model(torch.from_numpy(x).cuda().permute(
                0, 3, 1, 2)), dim=1).cpu().numpy()
        got = net.label_probabilities(x)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev
    err = float(np.abs(got - want).max())
    if not all(p.device.type == "cuda" for layer in net.params
               for p in layer.values()) or err > TAIL_SEQ_TOL:
        raise AssertionError(f"tail: imported LeNet vs the module: max abs "
                             f"error {err} (limit {TAIL_SEQ_TOL})")
    return {"layers": len(net.conf.layers), "report": report,
            "max_abs_err": err, "tol": TAIL_SEQ_TOL, "batch": TAIL_SEQ_B}


# Iris's class means and spreads (cm; Fisher 1936): the chip machine has
# no sklearn, whose bundled copy `iris_dataset` reads
IRIS_MEANS = ((5.01, 3.43, 1.46, 0.25), (5.94, 2.77, 4.26, 1.33),
              (6.59, 2.97, 5.55, 2.03))
IRIS_SDS = (0.35, 0.35, 0.45, 0.25)


def iris_shaped(n: int = 150, seed: int = 0) -> tuple:
    """Seeded Iris-shaped features in raw units (the scaler has work to
    do) and integer labels, 50 a class."""
    rng = np.random.default_rng(seed)
    y = np.arange(n) % 3
    x = (np.asarray(IRIS_MEANS)[y] + rng.standard_normal((n, 4))
         * np.asarray(IRIS_SDS)).astype(np.float32)
    return x, y


def ml_pipeline_card_vs_cpu() -> dict:
    """An Iris-shaped `Pipeline([StandardScaler, NetworkClassifier])`
    trained on the card and the same on the CPU (the same seed, so the
    same initial weights and batches; TF32 off): probabilities within
    TAIL_ML_TOL and the training accuracy of each."""
    import torch

    from deeplearning4j_tpu_torch.ml import (
        NetworkClassifier,
        Pipeline,
        StandardScaler,
    )
    from deeplearning4j_tpu_torch.models import zoo

    x, y = iris_shaped()
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    try:
        for dev in ("cuda", "cpu"):
            t0 = time.perf_counter()
            pipe = Pipeline([
                ("scale", StandardScaler()),
                ("clf", NetworkClassifier(zoo.iris_mlp(),
                                          epochs=TAIL_ML_EPOCHS,
                                          batch_size=32, device=dev))])
            pipe.fit(x, y)
            out[dev] = {"proba": pipe.predict_proba(x),
                        "score": pipe.score(x, y),
                        "fit_s": time.perf_counter() - t0,
                        "on": str(pipe.steps[-1][1].network.device)}
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    err = float(np.abs(out["cuda"]["proba"] - out["cpu"]["proba"]).max())
    if out["cuda"]["on"].split(":")[0] != "cuda" or err > TAIL_ML_TOL:
        raise AssertionError(f"tail: iris pipeline card vs CPU: max abs "
                             f"error {err} (limit {TAIL_ML_TOL}), trained "
                             f"on {out['cuda']['on']}")
    return {"epochs": TAIL_ML_EPOCHS, "max_abs_err": err, "tol": TAIL_ML_TOL,
            "score_card": out["cuda"]["score"],
            "score_cpu": out["cpu"]["score"],
            "fit_s_card": out["cuda"]["fit_s"],
            "fit_s_cpu": out["cpu"]["fit_s"]}


def trace_one_dispatch(srv, prompt, tmp: str) -> dict:
    """`trace()` around one served request of one new token (one prefill
    dispatch) inside an `annotate` span: the Chrome trace must hold the
    span and B1's kernels."""
    import os

    from deeplearning4j_tpu_torch.runtime.profiler import annotate, trace

    logdir = os.path.join(tmp, "trace")
    with trace(logdir):
        with annotate("tail-serve-dispatch"):
            srv.generate(prompt, 1, timeout=600)
    files = [os.path.join(logdir, f) for f in os.listdir(logdir)]
    if len(files) != 1:
        raise AssertionError(f"tail: trace wrote {files}")
    with open(files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    names = {e.get("name", "") for e in events}
    b1 = sorted(n for n in names if "paged_attention" in n)
    if "tail-serve-dispatch" not in names or not b1:
        raise AssertionError(f"tail: the trace lacks the span or B1 "
                             f"(B1 kernels {b1})")
    return {"file_bytes": os.path.getsize(files[0]), "events": len(events),
            "b1_kernels": b1}


def tail_phase(card: str) -> dict:
    """Import a GPT-2-small stand-in with `import_hf_gpt2`, serve it and
    train it through the kernels, and drive the rest of the tail."""
    import dataclasses
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.parallel import kernels as fk
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        _master_f32,
        make_accum_train_step,
    )
    from deeplearning4j_tpu_torch.runtime.model_import import import_hf_gpt2
    from deeplearning4j_tpu_torch.runtime.profiler import device_memory_stats
    from deeplearning4j_tpu_torch.serving.lm import ContinuousLMServer
    from deeplearning4j_tpu_torch.tree import tree_leaves

    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    stand_in, sd = hf_gpt2_stand_in(seed=0)
    t0 = time.perf_counter()
    cfg, params32 = import_hf_gpt2(stand_in)
    import_s = time.perf_counter() - t0
    n_leaves = imported_tree_bitwise(params32, sd)
    del sd, stand_in
    out = {"card": card, "config": dict(GPT2_HF), "import_s": import_s,
           "imported_leaves_bitwise": n_leaves,
           "n_params": sum(t.numel() for t in tree_leaves(params32))}
    log(f"tail: imported the GPT-2-small stand-in ({out['n_params']} "
        f"parameters, {n_leaves} leaves bitwise) in {import_s:.2f} s")

    # import and serve: the serve phase's 12 requests, bf16, paged (B1)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    params16 = tfm.map_tree(lambda t: t.to(torch.bfloat16), params32)
    reqs = decode_requests(cfg16)[:12]
    srv = ContinuousLMServer(cfg16, params16, slots=8, page_size=16,
                             prefill_chunk=16, device="cuda")
    try:
        run = run_pool(srv, reqs, DECODE_NEW)
        with tempfile.TemporaryDirectory() as tmp:
            out["trace"] = trace_one_dispatch(srv, reqs[0][0][:15], tmp)
    finally:
        srv.stop()
    check = greedy_checker(cfg16, params16)
    checks = [check(p, r) for (p, temp, _), r in zip(reqs, run["results"])
              if temp == 0.0]
    out["serve"] = pool_summary(run, checks)
    out["serve"]["greedy_requests"] = len(checks)
    log(f"tail: served 12 requests from the imported model: "
        f"{run['tokens_per_s']:.2f} tokens/s, B1 {run['paged_launches']} "
        f"by width {run['paged_launches_by_width']}, greedy worst deficit "
        f"over limit {out['serve']['worst_deficit_over_limit']:.3f} "
        f"({card})")
    del params16
    torch.cuda.empty_cache()

    # import and train: the train phase's recipe, 3 steps (B2-B4)
    cfg_train = dataclasses.replace(cfg, dtype="bfloat16", remat=True)
    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    tokens, targets = data[:, :-1], data[:, 1:]
    params = _master_f32(tfm.map_tree(lambda t: t.detach().clone(),
                                      params32))
    step, init_state = make_accum_train_step(cfg_train, lr=1e-3,
                                             accum=TRAIN_ACCUM,
                                             updater="adam")
    opt = init_state(params)
    counters = {"flash_fwd": fk.flash_forward.launches,
                "flash_bwd_dkv": fk.flash_bwd_dkv.launches,
                "flash_bwd_dq": fk.flash_bwd_dq.launches}
    torch.cuda.synchronize()
    for c in counters.values():
        c.reset()
    losses, step_ms = [], []
    for _ in range(TAIL_TRAIN_STEPS):
        ts = time.perf_counter()
        params, opt, loss = step(params, opt, tokens, targets)
        losses.append(float(loss))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    launches = {n: c.value for n, c in counters.items()}
    per_step = cfg.n_layers * TRAIN_ACCUM
    want = {"flash_fwd": 2 * per_step * TAIL_TRAIN_STEPS,
            "flash_bwd_dkv": per_step * TAIL_TRAIN_STEPS,
            "flash_bwd_dq": per_step * TAIL_TRAIN_STEPS}
    if not all(math.isfinite(x) for x in losses) or launches != want:
        raise AssertionError(f"tail: training the imported model: losses "
                             f"{losses}, launches {launches} (want {want})")
    out["train"] = {"steps": TAIL_TRAIN_STEPS, "losses": losses,
                    "step_ms": step_ms, "launches": launches,
                    "recipe": f"bf16 compute, f32 masters, adam lr 1e-3, "
                              f"{TRAIN_BATCH} x {TRAIN_SEQ} in "
                              f"{TRAIN_ACCUM} microbatches, remat"}
    log(f"tail: trained the imported model {TAIL_TRAIN_STEPS} steps: "
        f"losses {losses}, step ms {[round(x, 1) for x in step_ms]}, "
        f"launches {launches} ({card})")
    del params, opt
    torch.cuda.empty_cache()

    # device memory: read while the imported tree is still resident
    stats = device_memory_stats()
    total = torch.cuda.get_device_properties(0).total_memory
    if len(stats) != torch.cuda.device_count() or \
            stats[0]["peak_bytes_in_use"] < stats[0]["bytes_in_use"] or \
            stats[0]["bytes_limit"] != total:
        raise AssertionError(f"tail: device_memory_stats {stats}")
    out["device_memory_stats"] = stats

    out["flash_bwd_bitwise"] = flash_bwd_bitwise()
    out["determinism"] = determinism_paths(cfg_train, params32, tokens,
                                           targets)
    for path, rep in out["determinism"].items():
        log(f"tail: determinism {path}: bitwise {rep['bitwise']}, max abs "
            f"diff {rep['max_abs_diff']:.3g}, first leaf "
            f"{rep['first_leaf']} ({rep['s']:.1f} s; {card})")
    del params32
    torch.cuda.empty_cache()
    out["storage"] = remote_storage_on_card()
    out["sequential"] = sequential_import_on_card()
    out["ml"] = ml_pipeline_card_vs_cpu()
    log(f"tail: remote checkpoint bitwise (save "
        f"{out['storage']['save_ms']:.1f} ms, load "
        f"{out['storage']['load_ms']:.1f} ms); imported LeNet vs "
        f"the module {out['sequential']['max_abs_err']:.3g}; iris pipeline "
        f"card vs CPU {out['ml']['max_abs_err']:.3g}, accuracy "
        f"{out['ml']['score_card']:.3f} / {out['ml']['score_cpu']:.3f}")
    out["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"tail: phase in {out['phase_s']:.1f} s, peak memory "
        f"{out['peak_memory_bytes'] / 2**30:.2f} GiB ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 24: the scaleout control plane

SCALEOUT_JOBS = 8                # char-LSTM batches of the network legs
SCALEOUT_TCP_JOBS = 4
SCALEOUT_WORKERS = 2
SCALEOUT_REL = 1e-6              # per-leaf bound where a replay is not bitwise
SCALEOUT_F32_REL = 1e-4          # one f32 SGD round, card vs CPU (rnn's bound)
SCALEOUT_IRIS_GATE = 0.9         # tests/test_scaleout.py's accuracy gate
SCALEOUT_IRIS_PASSES = 80
SCALEOUT_REAP_S = 1.0            # the reaper leg's heartbeat timeout
SCALEOUT_RUN_S = 300.0           # every run's own time limit


def tree_digest(tree) -> str:
    """sha256 over a host tree's leaves in tree order (None: "none")."""
    import hashlib

    if tree is None:
        return "none"
    h = hashlib.sha256()
    layers = tree if isinstance(tree, list) else [tree]
    for layer in layers:
        for k in sorted(layer):
            h.update(k.encode())
            h.update(np.ascontiguousarray(layer[k]).tobytes())
    return h.hexdigest()


class ReplicaLog:
    """Which replica performed which job, in order, and the digest of the
    global model the job started from (`Recorded` performers log here)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.entries = []              # (replica, job_id, digest)
        self.replicas = 0

    def wrap(self, inner):
        with self.lock:
            replica, self.replicas = self.replicas, self.replicas + 1
        return Recorded(inner, replica, self)

    def rounds(self) -> list:
        """[(digest, [(replica, job_id), ...])]: consecutive jobs that
        started from one global model form a round."""
        out = []
        for replica, job_id, digest in self.entries:
            if not out or out[-1][0] != digest:
                out.append((digest, []))
            out[-1][1].append((replica, job_id))
        return out


class Recorded:
    """A performer that logs each job to a `ReplicaLog`, then runs it."""

    def __init__(self, inner, replica: int, log: ReplicaLog):
        self.inner, self.replica, self.log = inner, replica, log
        self.digest = None

    def update(self, state) -> None:
        self.digest = tree_digest(state)
        self.inner.update(state)

    def perform(self, job) -> None:
        with self.log.lock:
            self.log.entries.append((self.replica, job.job_id, self.digest))
        self.inner.perform(job)


class CountingAggregator:
    """An aggregator proxy keeping what it accumulates (so that objects
    stay alive and distinct ones keep distinct ids)."""

    def __init__(self, inner):
        self.inner, self.seen = inner, []

    def accumulate(self, result) -> None:
        self.seen.append(result)
        self.inner.accumulate(result)

    def distinct(self) -> int:
        return len({id(r) for r in self.seen})

    def aggregate(self):
        return self.inner.aggregate()

    def reset(self) -> None:
        self.inner.reset()


def replay_rounds(log: ReplicaLog, payloads: list, initial, make) -> tuple:
    """A single-thread replay of a logged parameter-averaging run: fresh
    performers (`make()`) per replica, each job from the global model its
    round started from, each round's results averaged.  Returns (final
    model, rounds whose starting model's digest equals the logged one)."""
    from deeplearning4j_tpu_torch.scaleout import (
        Job,
        ParameterAveragingAggregator,
    )

    perfs, model, digests_equal = {}, initial, 0
    for digest, jobs in log.rounds():
        if len(jobs) > SCALEOUT_WORKERS:
            raise AssertionError(f"scaleout: a round of {len(jobs)} jobs "
                                 f"(the average of three is order-bound)")
        digests_equal += tree_digest(model) == digest
        agg = ParameterAveragingAggregator()
        for replica, job_id in jobs:
            perf = perfs.setdefault(replica, make())
            perf.update(model)
            job = Job(work=payloads[job_id], job_id=job_id)
            perf.perform(job)
            agg.accumulate(job.result)
        model = agg.aggregate()
    return model, digests_equal


def host_leaf_compare(got, want) -> dict:
    """Two host parameter trees: bitwise, else the worst leaf, its max
    abs difference and its max relative difference."""
    worst = {"leaf": None, "max_abs_diff": 0.0, "max_rel": 0.0}
    bitwise = True
    for i, (g, w) in enumerate(zip(got, want)):
        for k in sorted(w):
            a, b = np.asarray(g[k]), np.asarray(w[k])
            if np.array_equal(a, b):
                continue
            bitwise = False
            d = float(np.abs(a - b).max())
            rel = d / max(float(np.abs(b).max()), 1e-30)
            if rel >= worst["max_rel"]:
                worst = {"leaf": f"{i}/{k}", "max_abs_diff": d,
                         "max_rel": rel}
    return {"bitwise": bitwise, **worst}


def leaves_finite(tree) -> bool:
    return all(np.isfinite(np.asarray(layer[k])).all()
               for layer in tree for k in layer)


def scaleout_payloads(n: int, seed: int) -> list:
    """`n` char-LSTM jobs, bench_lstm-shaped (x, y) host batches of a
    seeded character chain: each id is followed by the next or the one
    after (mod V) at even odds, so the next-character loss has a floor of
    ln 2 that a few steps approach, and a held batch can show learning
    (uniform random ids, as `char_batches` draws, cannot)."""
    rng = np.random.default_rng(seed)
    eye = np.eye(LSTM_V, dtype=np.float32)
    out = []
    for _ in range(n):
        steps = 1 + rng.integers(0, 2, (LSTM_B, LSTM_T))
        ids = (rng.integers(0, LSTM_V, (LSTM_B, 1))
               + np.cumsum(steps, axis=1)) % LSTM_V
        out.append((eye[ids], eye[np.roll(ids, -1, axis=1)]))
    return out


def network_leg(conf_json: str, payloads: list, initial, router,
                replay: bool) -> dict:
    """`DistributedRunner.simulate` of `payloads` over 2 worker threads
    of `NetworkPerformer` on the card: B5 launches, updates, the final
    model and (with `replay`) the single-thread replay of its rounds."""
    import torch

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.scaleout import (
        DistributedRunner,
        NetworkPerformer,
        ParameterAveragingAggregator,
    )

    log = ReplicaLog()
    agg = CountingAggregator(ParameterAveragingAggregator())
    runner = DistributedRunner()
    torch.cuda.synchronize()
    lk.fused_lstm_forward.launches.reset()
    t0 = time.perf_counter()
    final = runner.simulate(
        payloads, lambda: log.wrap(NetworkPerformer(conf_json)), agg,
        n_workers=SCALEOUT_WORKERS, initial_model=initial, router=router,
        timeout=SCALEOUT_RUN_S)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = lk.fused_lstm_forward.launches.value
    out = {"jobs": len(payloads), "performs": len(log.entries),
           "updates": runner.tracker.counter("updates"),
           "absorbed": len(agg.seen), "absorbed_distinct": agg.distinct(),
           "b5_launches": launches, "rounds": len(log.rounds()),
           "run_s": run_s, "finite": leaves_finite(final),
           "assignment": [list(e[:2]) for e in log.entries]}
    out["ms_a_round"] = 1e3 * run_s / max(out["rounds"], 1)
    if replay:
        want, equal = replay_rounds(
            log, payloads, initial, lambda: NetworkPerformer(conf_json))
        out["replay"] = dict(host_leaf_compare(final, want),
                             round_digests_equal=equal)
    return out, final


def check_network_leg(name: str, leg: dict, n_lstm: int) -> None:
    if leg["performs"] != leg["jobs"] or leg["updates"] != leg["jobs"]:
        raise AssertionError(f"scaleout: {name}: {leg['performs']} "
                             f"performs, {leg['updates']} updates of "
                             f"{leg['jobs']} jobs")
    if leg["absorbed"] != leg["jobs"] or \
            leg["absorbed_distinct"] != leg["jobs"]:
        raise AssertionError(f"scaleout: {name}: {leg['absorbed']} updates "
                             f"absorbed ({leg['absorbed_distinct']} "
                             f"distinct) of {leg['jobs']}")
    if leg["b5_launches"] != n_lstm * leg["performs"]:
        raise AssertionError(f"scaleout: {name}: B5 launched "
                             f"{leg['b5_launches']} times for "
                             f"{leg['performs']} performs x {n_lstm} LSTM "
                             f"layers")
    if not leg["finite"]:
        raise AssertionError(f"scaleout: {name}: a leaf is not finite")
    rep = leg.get("replay")
    if rep is not None:
        if rep["round_digests_equal"] != leg["rounds"]:
            raise AssertionError(f"scaleout: {name}: the replay's round "
                                 f"models differ from the run's: {rep}")
        if not rep["bitwise"] and not rep["max_rel"] <= SCALEOUT_REL:
            raise AssertionError(f"scaleout: {name}: the replay is "
                                 f"{rep['max_rel']:.3g} off ({rep})")


def held_loss(conf_json: str, tree, batch) -> float:
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        params_from_numpy,
    )

    net = MultiLayerNetwork.from_json(conf_json)
    net.params = params_from_numpy(net, tree)
    return net.score(*batch)


def f32_round_card_vs_cpu(initial_of) -> dict:
    """One round of 2 jobs at f32 with SGD on the card (TF32 off) and
    the same round in the port on the CPU: every leaf of the averaged
    model relative to the leaf's largest value, and every element's
    difference against the bound on its step (relative to the leaf's
    largest step, plus the element's f32 ulp, the step's resolution)."""
    import torch

    from deeplearning4j_tpu_torch.models import char_lstm
    from deeplearning4j_tpu_torch.scaleout import (
        DistributedRunner,
        NetworkPerformer,
        ParameterAveragingAggregator,
    )

    conf_json = char_lstm(updater="sgd").to_json()
    initial = initial_of(conf_json)
    payloads = scaleout_payloads(SCALEOUT_WORKERS, seed=11)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = {}
        for side, dev in (("card", "cuda"), ("cpu", "cpu")):
            t0 = time.perf_counter()
            got[side] = DistributedRunner().simulate(
                payloads, lambda d=dev: NetworkPerformer(conf_json,
                                                         device=d),
                ParameterAveragingAggregator(),
                n_workers=SCALEOUT_WORKERS, initial_model=initial,
                timeout=SCALEOUT_RUN_S)
            got[side + "_s"] = time.perf_counter() - t0
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    rel, step_rel, step_ratio = {}, {}, {}
    for i, (c, h, s) in enumerate(zip(got["card"], got["cpu"], initial)):
        for k in sorted(s):
            key = f"{i}/{k}"
            diff = np.abs(c[k] - h[k])
            rel[key] = float(diff.max()
                             / max(float(np.abs(h[k]).max()), 1e-30))
            step = float(np.abs(h[k] - s[k]).max())
            step_rel[key] = float(diff.max() / max(step, 1e-30))
            # a step is stored in the f32 parameter, so it is resolved
            # to one ulp of that parameter: each element's difference
            # within the bound of the leaf's largest step plus its ulp
            step_ratio[key] = float((diff / (SCALEOUT_F32_REL * step
                                             + np.spacing(np.abs(h[k])))
                                     ).max())
    out = {"bound": SCALEOUT_F32_REL, "leaf_rel_err": rel,
           "step_rel_err": step_rel, "step_err_over_bound": step_ratio,
           "card_s": got["card_s"], "cpu_s": got["cpu_s"]}
    if not all(math.isfinite(v) and v <= SCALEOUT_F32_REL
               for v in rel.values()) or not all(
            math.isfinite(v) and v <= 1.0 for v in step_ratio.values()):
        raise AssertionError(f"scaleout: f32 round card vs CPU: {out}")
    return out


def iris_gate_on_card() -> dict:
    """tests/test_scaleout.py's parameter-averaging gate on the card: its
    net (Dense 4-8, softmax 8-3, Adam 0.01, seed 7), its payloads (4
    strided batches x 80 passes), 2 workers, on `iris_shaped()`
    normalised as `iris_dataset` normalises."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        params_from_numpy,
    )
    from deeplearning4j_tpu_torch.nn import conf as tconf
    from deeplearning4j_tpu_torch.scaleout import (
        DistributedRunner,
        NetworkPerformer,
        ParameterAveragingAggregator,
    )
    from deeplearning4j_tpu_torch.scaleout.performers import host_params

    x, labels = iris_shaped()
    ds = DataSet(x, np.eye(3, dtype=np.float32)[labels]
                 ).normalize_zero_mean_unit_variance()
    conf_json = tconf.MultiLayerConfiguration(
        conf=tconf.NeuralNetConfiguration(learning_rate=0.01,
                                          updater="adam", seed=7),
        layers=(tconf.DenseLayerConf(n_in=4, n_out=8),
                tconf.OutputLayerConf(n_in=8, n_out=3))).to_json()
    seed_net = MultiLayerNetwork.from_json(conf_json)
    batches = [(ds.features[i::4], ds.labels[i::4]) for i in range(4)]
    payloads = batches * SCALEOUT_IRIS_PASSES
    runner = DistributedRunner()
    t0 = time.perf_counter()
    final = runner.simulate(
        payloads, lambda: NetworkPerformer(conf_json),
        ParameterAveragingAggregator(),
        initial_model=host_params(seed_net.params),
        n_workers=SCALEOUT_WORKERS, timeout=SCALEOUT_RUN_S)
    run_s = time.perf_counter() - t0
    seed_net.params = params_from_numpy(seed_net, final)
    acc = seed_net.evaluate(ds.features, ds.labels).accuracy()
    out = {"accuracy": acc, "gate": SCALEOUT_IRIS_GATE,
           "jobs": len(payloads), "updates": runner.tracker.counter(
               "updates"), "run_s": run_s,
           "ms_a_job": 1e3 * run_s / len(payloads)}
    if not acc > SCALEOUT_IRIS_GATE or out["updates"] != len(payloads):
        raise AssertionError(f"scaleout: the iris gate: {out}")
    return out


def tcp_leg(conf_json: str, payloads: list, initial) -> tuple:
    """A `StateTrackerServer` with a secret on loopback, a `Master` and
    two `Worker`s built by hand, each with its own `RemoteStateTracker`:
    the network leg over TCP, its replay, and a client without the
    secret refused."""
    import pickle
    import secrets

    import torch

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.scaleout import (
        IterativeReduceWorkRouter,
        JobIterator,
        Master,
        NetworkPerformer,
        ParameterAveragingAggregator,
        RemoteStateTracker,
        StateTrackerServer,
        Worker,
    )
    from deeplearning4j_tpu_torch.scaleout.runner import MODEL_KEY

    secret = secrets.token_hex(16)
    server = StateTrackerServer(secret=secret).start()
    host, port = server.address
    clients, workers = [], []
    log = ReplicaLog()
    agg = CountingAggregator(ParameterAveragingAggregator())
    try:
        def client():
            clients.append(RemoteStateTracker(host, port, secret=secret))
            return clients[-1]

        tracker = client()
        tracker.reset_run_state()
        tracker.set_global(MODEL_KEY, initial)
        workers = [Worker(client(), log.wrap(NetworkPerformer(conf_json)),
                          heartbeat_interval=0.05).start()
                   for _ in range(SCALEOUT_WORKERS)]
        master = Master(tracker, JobIterator(payloads), agg,
                        router=IterativeReduceWorkRouter())
        torch.cuda.synchronize()
        lk.fused_lstm_forward.launches.reset()
        t0 = time.perf_counter()
        final = master.run(timeout=SCALEOUT_RUN_S)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = lk.fused_lstm_forward.launches.value
        updates = tracker.counter("updates")
        bad = RemoteStateTracker(host, port, timeout=30.0)
        clients.append(bad)
        try:
            bad.workers()
            refused = None
        except (RuntimeError, ConnectionError, OSError) as e:
            refused = type(e).__name__
    finally:
        for w in workers:
            w.request_stop()
        for w in workers:
            w.stop()
        for c in clients:
            c.close()
        server.stop()
    if refused is None:
        raise AssertionError("scaleout: tcp: a client without the secret "
                             "was answered")
    out = {"jobs": len(payloads), "performs": len(log.entries),
           "updates": updates, "absorbed": len(agg.seen),
           "absorbed_distinct": agg.distinct(), "b5_launches": launches,
           "rounds": master.rounds, "run_s": run_s,
           "ms_a_round": 1e3 * run_s / max(master.rounds, 1),
           "finite": leaves_finite(final), "unauthenticated": refused,
           "assignment": [list(e[:2]) for e in log.entries],
           "tree_frame_bytes": 4 + 32 + len(pickle.dumps(
               ("ok", final), protocol=pickle.HIGHEST_PROTOCOL))}
    want, equal = replay_rounds(log, payloads, initial,
                                lambda: NetworkPerformer(conf_json))
    out["replay"] = dict(host_leaf_compare(final, want),
                         round_digests_equal=equal)
    return out, final


class DeltaReplica:
    """A delta performer (`Word2VecPerformer`, `GlovePerformer`) under a
    master whose global is ``{"tables": model, "deltas": [each round's
    aggregate]}``: `update` passes each aggregate the replica has not
    applied to the performer's own `update`, in order; `perform` records
    the job's delta and ms, whether the replica's tables matched the
    round's model bitwise before it, and whether they are bitwise as
    they were after it."""

    def __init__(self, inner, tables_of, log: list, lock):
        self.inner, self.tables_of = inner, tables_of
        self.log, self.lock = log, lock
        self.applied, self.model = 0, None

    def update(self, state) -> None:
        for agg in state["deltas"][self.applied:]:
            self.inner.update(agg)
        self.applied = len(state["deltas"])
        self.model = state["tables"]

    def perform(self, job) -> None:
        before = self.tables_of(self.inner)
        matched = all(np.array_equal(before[k], self.model[k])
                      for k in before)
        t0 = time.perf_counter()
        self.inner.perform(job)
        ms = 1e3 * (time.perf_counter() - t0)
        after = self.tables_of(self.inner)
        with self.lock:
            self.log.append({
                "job": job.job_id, "round": self.applied, "ms": ms,
                "delta": job.result, "matched_model": matched,
                "restored": all(np.array_equal(after[k], before[k])
                                for k in before),
                "delta_mb": sum(np.asarray(v).nbytes
                                for v in job.result.values()) / 1e6})


def fold_round(model, agg):
    return {"tables": {k: model["tables"][k] + agg[k] for k in agg},
            "deltas": model["deltas"] + [agg]}


def delta_run(name: str, make_model, make_performer, tables_of,
              payloads: list) -> tuple:
    """2 workers of a delta performer under `DeltaSumAggregator`; every
    round's model re-derived on the host from the start and the logged
    deltas must equal the run's bitwise."""
    from deeplearning4j_tpu_torch.scaleout import (
        DeltaSumAggregator,
        DistributedRunner,
    )

    start = tables_of(make_performer(make_model()))
    log, lock = [], threading.Lock()
    t0 = time.perf_counter()
    final = DistributedRunner().simulate(
        payloads,
        lambda: DeltaReplica(make_performer(make_model()), tables_of, log,
                             lock),
        DeltaSumAggregator(), n_workers=SCALEOUT_WORKERS,
        initial_model={"tables": start, "deltas": []},
        apply_aggregate=fold_round, timeout=SCALEOUT_RUN_S)
    run_s = time.perf_counter() - t0
    model = dict(start)
    for r in range(len(final["deltas"])):
        deltas = [e["delta"] for e in log if e["round"] == r]
        if len(deltas) > SCALEOUT_WORKERS:
            raise AssertionError(f"scaleout: {name}: round {r} holds "
                                 f"{len(deltas)} deltas")
        total = deltas[0]
        for d in deltas[1:]:
            total = {k: total[k] + d[k] for k in total}
        model = {k: model[k] + total[k] for k in model}
    out = {"jobs": len(payloads), "performs": len(log),
           "rounds": len(final["deltas"]), "run_s": run_s,
           "ms_a_job": float(np.mean([e["ms"] for e in log])),
           "delta_mb_a_job": float(np.mean([e["delta_mb"] for e in log])),
           "restored_bitwise": all(e["restored"] for e in log),
           "replicas_at_round_model": all(e["matched_model"] for e in log),
           "rounds_rederived_bitwise": all(
               np.array_equal(model[k], final["tables"][k]) for k in model),
           "finite": all(np.isfinite(v).all()
                         for v in final["tables"].values())}
    if not (out["performs"] == out["jobs"] and out["restored_bitwise"]
            and out["replicas_at_round_model"]
            and out["rounds_rederived_bitwise"] and out["finite"]):
        raise AssertionError(f"scaleout: {name}: {out}")
    return out, final["tables"]


def embedding_leg() -> dict:
    """Word2Vec (HS) at the bench row's settings over its zipf corpus in
    8 jobs, Word2Vec HS and GloVe at `nlp_quality`'s settings over the
    two-topic corpus, each on 2 workers of delta performers."""
    from deeplearning4j_tpu_torch.nlp import Glove, Word2Vec
    from deeplearning4j_tpu_torch.scaleout import (
        GlovePerformer,
        Word2VecPerformer,
    )

    def cut(sentences):
        n = -(-len(sentences) // SCALEOUT_JOBS)
        return [sentences[i:i + n] for i in range(0, len(sentences), n)]

    def w2v_maker(knobs, corpus):
        tokens = Word2Vec(**knobs)._sentences_to_tokens(corpus)

        def make():
            w = Word2Vec(**knobs)
            w.build_vocab(tokens)
            w.reset_weights()
            return w
        return make

    def w2v_tables(p):
        return {"syn0": p.w2v.syn0.copy(), "syn1": p.w2v.syn1.copy()}

    def glove_tables(p):
        return {k: t.detach().cpu().numpy().copy()
                for k, t in zip(p.KEYS, p.glove._params)}

    bench = zipf_sentences(W2V_BENCH_TOKENS, W2V_BENCH_VOCAB)
    out = {}
    out["w2v_bench_hs"], _ = delta_run(
        "w2v_bench_hs", w2v_maker(dict(W2V_BENCH, negative=0), bench),
        Word2VecPerformer, w2v_tables, cut(bench))
    topics = topic_corpus()
    hs_knobs = dict(NLP_W2V, negative=0)
    make_topic = w2v_maker(hs_knobs, topics)
    out["w2v_topics_hs"], tables = delta_run(
        "w2v_topics_hs", make_topic, Word2VecPerformer, w2v_tables,
        cut(topics))
    probe = make_topic()
    probe.syn0 = tables["syn0"]
    out["w2v_topics_hs"].update(
        within=probe.similarity("apple", "banana"),
        across=probe.similarity("apple", "gpu"))

    def make_glove():
        g = Glove(**NLP_GLOVE)
        g.vocab.fit(g._tokenize_all(topics))
        return g

    out["glove_topics"], _ = delta_run(
        "glove_topics", make_glove,
        lambda g: GlovePerformer(g, epochs=NLP_GLOVE["epochs"]),
        glove_tables, cut(topics))
    return out


class KilledMidJob:
    """A performer whose worker dies holding its first job of id `at` or
    later (the middle of the run, past its first round): it kills
    the worker (no more heartbeats, no deregistration) and blocks until
    released, as a lost host would; then it posts nothing useful."""

    def __init__(self, inner, at: int):
        self.inner, self.at = inner, at
        self.worker = None
        self.entered, self.release = threading.Event(), threading.Event()

    def update(self, state) -> None:
        self.inner.update(state)

    def perform(self, job) -> None:
        if job.job_id >= self.at and not self.entered.is_set():
            self.worker.kill()
            self.entered.set()
            self.release.wait(SCALEOUT_RUN_S)
            job.result = None
            return
        self.inner.perform(job)


def host_leg(conf_json: str, initial, n_lstm: int) -> dict:
    """Word count over the tracker, a worker killed mid-job and reaped,
    and two simulates on one runner."""
    import torch

    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.scaleout import (
        DistributedRunner,
        JobIterator,
        Master,
        NetworkPerformer,
        ParameterAveragingAggregator,
        StateTracker,
        Worker,
    )
    from deeplearning4j_tpu_torch.scaleout.runner import MODEL_KEY
    from deeplearning4j_tpu_torch.scaleout.text_performers import (
        CounterAggregator,
        WordCountPerformer,
    )

    out = {}
    topics = topic_corpus()
    docs = [topics[i:i + 75] for i in range(0, len(topics), 75)]

    def fold(model, agg):
        if model is None:
            return agg
        for k, v in agg.items():
            model.increment(k, v)
        return model

    counts = DistributedRunner().simulate(
        docs, WordCountPerformer, CounterAggregator(), apply_aggregate=fold,
        n_workers=SCALEOUT_WORKERS, timeout=SCALEOUT_RUN_S)
    want = collections.Counter(w for s in topics for w in s.split())
    out["word_count"] = {"words": len(want), "tokens": sum(want.values()),
                         "equal": dict(counts.items()) == dict(want)}

    payloads = scaleout_payloads(SCALEOUT_JOBS, seed=21)
    tracker = StateTracker()
    tracker.set_global(MODEL_KEY, initial)
    doomed = KilledMidJob(NetworkPerformer(conf_json), at=2)
    workers = [Worker(tracker, doomed, heartbeat_interval=0.05),
               Worker(tracker, NetworkPerformer(conf_json),
                      heartbeat_interval=0.05)]
    doomed.worker = workers[0]
    master = Master(tracker, JobIterator(payloads),
                    ParameterAveragingAggregator(),
                    heartbeat_timeout=SCALEOUT_REAP_S)
    torch.cuda.synchronize()
    lk.fused_lstm_forward.launches.reset()
    t0 = time.perf_counter()
    try:
        for w in workers:
            w.start()
        final = master.run(timeout=SCALEOUT_RUN_S)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = lk.fused_lstm_forward.launches.value
        updates = tracker.counter("updates")
    finally:
        doomed.release.set()
        for w in workers:
            w.request_stop()
        for w in workers:
            w.stop()
    out["reaper"] = {
        "killed": workers[0].worker_id, "reaped": master.reaped,
        "killed_mid_job": doomed.entered.is_set(), "jobs": len(payloads),
        "updates": updates, "b5_launches": launches,
        "survivor_performed": workers[1].performed,
        "heartbeat_timeout_s": SCALEOUT_REAP_S, "run_s": run_s,
        "finite": leaves_finite(final)}
    rep = out["reaper"]
    if not (rep["killed_mid_job"] and rep["reaped"] == [rep["killed"]]
            and updates == len(payloads) and rep["finite"]
            and launches == n_lstm * len(payloads)):
        raise AssertionError(f"scaleout: reaper: {rep}")

    class AddOne:
        def perform(self, job):
            job.result = job.work + 1.0

        def update(self, model):
            pass

    runner = DistributedRunner()
    agg = ParameterAveragingAggregator()
    out["repeat"] = {
        "first": float(runner.simulate([1.0, 3.0], AddOne, agg,
                                       n_workers=SCALEOUT_WORKERS,
                                       timeout=SCALEOUT_RUN_S)),
        "second": float(runner.simulate([5.0, 7.0], AddOne, agg,
                                        n_workers=SCALEOUT_WORKERS,
                                        timeout=SCALEOUT_RUN_S))}
    if not out["word_count"]["equal"] or out["repeat"] != {
            "first": 3.0, "second": 7.0}:
        raise AssertionError(f"scaleout: host leg: {out}")
    return out


def scaleout_phase(card: str) -> dict:
    """The four legs of the scaleout phase (the module docstring, 24)."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.conf.layers import GravesLSTMConf
    from deeplearning4j_tpu_torch.scaleout import (
        HogwildWorkRouter,
        IterativeReduceWorkRouter,
    )
    from deeplearning4j_tpu_torch.scaleout.performers import host_params

    t_phase = time.perf_counter()
    conf = char_lstm(compute_dtype="bfloat16")
    conf_json = conf.to_json()
    n_lstm = sum(isinstance(lc, GravesLSTMConf) for lc in conf.layers)

    def initial_of(js):
        return host_params(MultiLayerNetwork.from_json(js,
                                                       device="cpu").params)

    initial = initial_of(conf_json)
    payloads = scaleout_payloads(SCALEOUT_JOBS, seed=3)
    # warm-up, not counted: the worker threads' first steps on the card
    # (cuBLAS handles, the allocator) stay out of the timed rounds
    from deeplearning4j_tpu_torch.scaleout import (
        DistributedRunner,
        NetworkPerformer,
        ParameterAveragingAggregator,
    )
    DistributedRunner().simulate(
        payloads[:SCALEOUT_WORKERS], lambda: NetworkPerformer(conf_json),
        ParameterAveragingAggregator(), n_workers=SCALEOUT_WORKERS,
        initial_model=initial, timeout=SCALEOUT_RUN_S)
    out = {"card": card, "workers": SCALEOUT_WORKERS,
           "shape": dict(T=LSTM_T, B=LSTM_B, H=LSTM_H, V=LSTM_V),
           "dtype": "bfloat16", "lstm_layers": n_lstm}

    # 1. in process
    leg, final = network_leg(conf_json, payloads, initial,
                             IterativeReduceWorkRouter(), replay=True)
    check_network_leg("iterative reduce", leg, n_lstm)
    held = scaleout_payloads(1, seed=99)[0]
    leg["held_loss_start"] = held_loss(conf_json, initial, held)
    leg["held_loss_end"] = held_loss(conf_json, final, held)
    if not leg["held_loss_end"] < leg["held_loss_start"]:
        raise AssertionError(f"scaleout: the averaged model's held loss "
                             f"does not fall: {leg}")
    out["iterative_reduce"] = leg
    log(f"scaleout: iterative reduce, {leg['jobs']} jobs on "
        f"{SCALEOUT_WORKERS} workers in {leg['rounds']} rounds "
        f"({leg['ms_a_round']:.1f} ms a round): B5 {leg['b5_launches']}, "
        f"updates {leg['updates']}, replay bitwise "
        f"{leg['replay']['bitwise']} (worst {leg['replay']['leaf']} "
        f"{leg['replay']['max_abs_diff']:.3g}), held loss "
        f"{leg['held_loss_start']:.4f} -> {leg['held_loss_end']:.4f} "
        f"({card})")
    hog, _ = network_leg(conf_json, payloads, initial,
                         HogwildWorkRouter(depth=2), replay=False)
    check_network_leg("hogwild", hog, n_lstm)
    out["hogwild"] = hog
    out["f32_card_vs_cpu"] = f32_round_card_vs_cpu(initial_of)
    out["iris"] = iris_gate_on_card()
    f32 = out["f32_card_vs_cpu"]
    log(f"scaleout: hogwild B5 {hog['b5_launches']}, updates "
        f"{hog['updates']}; f32 SGD round card vs CPU worst leaf "
        f"{max(f32['leaf_rel_err'].values()):.3g}, worst step "
        f"{max(f32['step_rel_err'].values()):.3g} (error / bound "
        f"{max(f32['step_err_over_bound'].values()):.3g}; bound "
        f"{SCALEOUT_F32_REL:g}); iris accuracy {out['iris']['accuracy']:.3f}"
        f" over {out['iris']['jobs']} jobs")

    # 2. over TCP
    tcp, _ = tcp_leg(conf_json, payloads[:SCALEOUT_TCP_JOBS], initial)
    check_network_leg("tcp", tcp, n_lstm)
    out["tcp"] = tcp
    log(f"scaleout: tcp, {tcp['jobs']} jobs in {tcp['rounds']} rounds: "
        f"{tcp['ms_a_round']:.1f} ms a round (in process "
        f"{leg['ms_a_round']:.1f}), {tcp['tree_frame_bytes']} bytes a "
        f"parameter-tree frame, B5 {tcp['b5_launches']}, replay bitwise "
        f"{tcp['replay']['bitwise']}, no secret: {tcp['unauthenticated']}")

    # 3. embeddings
    out["embeddings"] = emb = embedding_leg()
    for name, e in emb.items():
        log(f"scaleout: {name}: {e['jobs']} jobs, {e['ms_a_job']:.1f} ms "
            f"and {e['delta_mb_a_job']:.3f} MB of delta a job, restored "
            f"{e['restored_bitwise']}, rounds re-derived "
            f"{e['rounds_rederived_bitwise']}")
    log(f"scaleout: Word2Vec HS on the topics, 2 workers: within "
        f"{emb['w2v_topics_hs']['within']:.3f}, across "
        f"{emb['w2v_topics_hs']['across']:.3f} (recorded)")

    # 4. host
    out["host"] = host_leg(conf_json, initial, n_lstm)
    rep = out["host"]["reaper"]
    log(f"scaleout: word count equal {out['host']['word_count']['equal']}; "
        f"reaper: {rep['killed']} killed mid-job, reaped {rep['reaped']}, "
        f"updates {rep['updates']} of {rep['jobs']}; repeat "
        f"{out['host']['repeat']}")
    out["b5_launches"] = {k: out[k]["b5_launches"] for k in (
        "iterative_reduce", "hogwild", "tcp")}
    out["b5_launches"]["reaper"] = rep["b5_launches"]
    out["performs"] = {k: out[k]["performs"] for k in (
        "iterative_reduce", "hogwild", "tcp")}
    torch.cuda.empty_cache()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"scaleout: phase in {out['phase_s']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 25: data parallelism on the card (a 4-shard mesh over the one H100)


DP_SHARDS = 4
DP_B = 128                       # global batch: 32 a shard, the rnn batch
DP_WARMUP, DP_STEPS = 3, 10
DP_PARITY_STEPS = 5
DP_SYNC = 4
DP_F32_REL = 1e-4                # every leaf, DP vs one device (rnn's bound)
DP_SGD_LR = 0.1
DP_ALEX_WARMUP, DP_ALEX_STEPS = 2, 10


def dp_mesh(n: int):
    """A mesh of `n` shards that all lie on card 0."""
    import torch

    from deeplearning4j_tpu_torch.parallel import make_mesh

    return make_mesh((n,), ("data",), devices=[torch.device("cuda", 0)] * n)


def dp_char_batches(n: int, b: int = DP_B, seed: int = 0) -> list:
    """`n` char-LSTM batches of `b` rows (T 64, one-hot over 80), targets
    the ids rolled by one, staged on the card."""
    import torch

    rng = np.random.default_rng(seed)
    eye = np.eye(LSTM_V, dtype=np.float32)
    out = []
    for _ in range(n):
        ids = rng.integers(0, LSTM_V, (b, LSTM_T))
        out.append((torch.from_numpy(eye[ids]).cuda(),
                    torch.from_numpy(eye[np.roll(ids, -1, axis=1)]).cuda()))
    return out


def dp_timed(fit, batches, warmup: int, steps: int) -> dict:
    """`warmup` then `steps` timed calls of `fit(x, y)` (each returns a
    host float, so each waits for its step), cycling over `batches`."""
    import torch

    losses = [fit(*batches[i % len(batches)]) for i in range(warmup)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = []
    t0 = time.perf_counter()
    for i in range(steps):
        ts = time.perf_counter()
        losses.append(fit(*batches[(warmup + i) % len(batches)]))
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    b = int(batches[0][0].shape[0])
    return {"batch": b, "warmup_steps": warmup, "steps": steps,
            "losses": losses, "step_ms": step_ms,
            "step_ms_mean": wall * 1e3 / steps,
            "examples_per_s": b * steps / wall,
            "peak_memory_bytes": torch.cuda.max_memory_allocated()}


def dp_trainer(conf, n: int, **kw):
    from deeplearning4j_tpu_torch.models import MultiLayerNetwork
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    net = MultiLayerNetwork(conf).init()
    return net, DataParallelTrainer(net, mesh=dp_mesh(n), **kw)


def dp_f32_legs(batches) -> dict:
    """float32, dropout 0, TF32 off: ZeRO-1 against ``shard_update=False``
    (Adam, 5 steps: parameters and moments bitwise), 4 shards against
    one device's `fit_batch` on the same 128-row batches (SGD, 5 steps:
    every leaf within 1e-4 relative; Adam's recorded), local SGD (every
    replica bitwise equal after each sync round) and the elastic restore
    of the ZeRO-1 run's checkpoint on 2 and 1 shards (published trees
    bitwise)."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.runtime.checkpoint import save_checkpoint

    torch.backends.cuda.matmul.allow_tf32 = False
    out = {}
    runs = {}
    for name, kw in (("zero1", {}), ("replicated", {"shard_update": False})):
        net, tr = dp_trainer(char_lstm(), DP_SHARDS, **kw)
        runs[name] = (net, tr, [tr.fit_batch(*batches[i % len(batches)])
                                for i in range(DP_PARITY_STEPS)])
        tr.publish_train_state()
    (za, zt, zl), (ra, _, rl) = runs["zero1"], runs["replicated"]
    out["zero1_vs_replicated"] = {
        "params": leaf_compare(za.params, ra.params),
        "moments": leaf_compare(za.updater_state, ra.updater_state),
        "losses_equal": zl == rl}
    if not (out["zero1_vs_replicated"]["params"]["bitwise"]
            and out["zero1_vs_replicated"]["moments"]["bitwise"]
            and zl == rl):
        raise AssertionError(f"dp: f32 ZeRO-1 and replicated differ: "
                             f"{out['zero1_vs_replicated']}")
    one = MultiLayerNetwork(char_lstm()).init()
    for i in range(DP_PARITY_STEPS):
        one.fit_batch(*batches[i % len(batches)])
    out["adam_vs_one_device"] = leaf_compare(za.params, one.params)
    sgd = {}
    for name, n in (("dp", DP_SHARDS), ("one", 0)):
        conf = char_lstm(updater="sgd", learning_rate=DP_SGD_LR)
        if n:
            net, tr = dp_trainer(conf, n)
            fit = tr.fit_batch
        else:
            net = MultiLayerNetwork(conf).init()
            fit = net.fit_batch
        for i in range(DP_PARITY_STEPS):
            fit(*batches[i % len(batches)])
        sgd[name] = net
    out["sgd_vs_one_device"] = leaf_compare(sgd["dp"].params,
                                            sgd["one"].params)
    if not out["sgd_vs_one_device"]["max_rel_leaf"] <= DP_F32_REL:
        raise AssertionError(f"dp: 4 shards vs one device: "
                             f"{out['sgd_vs_one_device']}")

    # local SGD: the replicas drift between sync rounds, equal after each
    net, tr = dp_trainer(char_lstm(), DP_SHARDS, sync_every=DP_SYNC)
    rounds = []
    for i in range(2 * DP_SYNC):
        tr.fit_batch(*batches[i % len(batches)])
        reps = [r[0] for r in tr._rep]
        if (i + 1) % DP_SYNC == 0:
            same = all(leaf_compare(r, reps[0])["bitwise"] for r in reps)
            pub = leaf_compare(net.params, reps[0])["bitwise"]
            rounds.append({"step": i + 1, "replicas_bitwise": same,
                           "net_is_average": pub})
    out["local_sgd"] = {"sync_every": DP_SYNC, "rounds": rounds}
    if not all(r["replicas_bitwise"] and r["net_is_average"]
               for r in rounds):
        raise AssertionError(f"dp: local SGD sync rounds: {rounds}")

    # elastic: the ZeRO-1 run's checkpoint on 4 shards, resumed on 2 and 1
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dp-") as tmp:
        part = zt.checkpoint_partition()
        save_checkpoint(tmp, DP_PARITY_STEPS, za.params,
                        updater_state=za.updater_state,
                        net_state=za.state, spec=part["spec"],
                        shards=part["shards"])
        el = {}
        for m in (2, 1):
            net, tr = dp_trainer(char_lstm(), m)
            step = tr.resume(tmp)
            tr.publish_train_state()
            el[f"to_{m}"] = {
                "step": step, "params": leaf_compare(net.params, za.params),
                "moments": leaf_compare(net.updater_state,
                                        za.updater_state),
                "next_loss": tr.fit_batch(*batches[0])}
        out["elastic"] = el
    if not all(e["step"] == DP_PARITY_STEPS and e["params"]["bitwise"]
               and e["moments"]["bitwise"] and math.isfinite(e["next_loss"])
               for e in el.values()):
        raise AssertionError(f"dp: elastic 4 -> 2 / 1: {el}")
    torch.backends.cuda.matmul.allow_tf32 = True
    return out


def dp_mixed_leg(batches) -> dict:
    """f32 masters, bf16 compute, loss scaling: two clean steps, then two
    steps that every shard must skip.  (a) A batch infinite in shard 0's
    rows only, so the mean loss is infinite too.  (b) A clean batch whose
    reduced gradient carries one inf planted in the last shard's ZeRO-1
    slice: the loss stays finite, so only the non-finite count over the
    slices (`shard_update_finite`) can see it.  After each: parameters
    and moments bitwise unchanged, the scale halved, one overflow more."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer

    net = MultiLayerNetwork(char_lstm()).init().set_precision("mixed")
    tr = DataParallelTrainer(net, mesh=dp_mesh(DP_SHARDS))
    good = [tr.fit_batch(*batches[i]) for i in range(2)]

    def skipped(x, y) -> dict:
        tr.publish_train_state()
        snap = [{k: v.detach().clone() for k, v in layer.items()}
                for layer in net.params]
        upd = {k: (v.detach().clone() if isinstance(v, torch.Tensor)
                   else [{kk: t.clone() for kk, t in layer.items()}
                         for layer in v])
               for k, v in net.updater_state.items()}
        before = net.scaler_stats()
        loss = tr.fit_batch(x, y)
        tr.publish_train_state()
        after = net.scaler_stats()
        return {"loss": loss, "params": leaf_compare(net.params, snap),
                "moments": leaf_compare(net.updater_state, upd),
                "scaler_before": before, "scaler_after": after,
                "skipped": (after["scale"] == before["scale"] / 2
                            and after["overflow_count"]
                            == before["overflow_count"] + 1)}

    x, y = batches[2]
    bad = x.clone()
    bad[3, 5, 0] = float("inf")          # row 3 lies in shard 0 of 4
    out = {"clean_losses": good, "poison_input": skipped(bad, y)}

    plain = tr._shard_grads

    def planted(*args, **kwargs):
        pieces = plain(*args, **kwargs)
        grads = pieces[1][2]             # shard 1's leaves, flat order
        grads[-1] = grads[-1].clone()
        # flat lane k0 - 1, which the reduce-scatter hands the last shard
        grads[-1].view(-1)[-1] = float("inf")
        return pieces

    tr._shard_grads = planted
    try:
        out["poison_grad_slice"] = skipped(*batches[3])
    finally:
        del tr._shard_grads
    out["next_loss"] = tr.fit_batch(*batches[0])
    cases = (out["poison_input"], out["poison_grad_slice"])
    if not (all(c["params"]["bitwise"] and c["moments"]["bitwise"]
                and c["skipped"] for c in cases)
            and math.isfinite(out["poison_grad_slice"]["loss"])
            and math.isfinite(out["next_loss"])):
        raise AssertionError(f"dp: a poisoned step was not skipped in "
                             f"lockstep: {out}")
    return out


def dp_w2v_check() -> dict:
    """Word2Vec HS with ``mesh=`` over 4 shards of the card against
    ``mesh=None``: one step at batch 4096 held, as the nlp phase holds
    its steps, to the float64 recompute of the single-device step under
    the a-priori float32 bounds (`hs_step_bounds`,
    `scatter_bound_ratio`); whole fits of the two-topic corpus compared
    (recorded)."""
    import torch

    from deeplearning4j_tpu_torch.nlp import word2vec as tw

    sents = topic_corpus()
    kw = dict(vector_length=100, window=5, negative=0, epochs=1,
              batch_size=4096, seed=1)
    single = tw.Word2Vec(**kw).fit(sents)
    meshed = tw.Word2Vec(mesh=dp_mesh(DP_SHARDS), **kw).fit(sents)
    encoded = [single.vocab.encode(t)
               for t in single._sentences_to_tokens(sents)]
    pairs = single._make_pairs(encoded, np.random.default_rng(5))[:4096]
    b = len(pairs)
    inputs = torch.from_numpy(pairs[:, 0]).long()
    targets = torch.from_numpy(pairs[:, 1]).long()
    hs_cpu = tuple(a.cpu() for a in single._hs)
    tables = [torch.from_numpy(single.syn0.copy()),
              torch.from_numpy(single.syn1.copy())]

    def single_run(t):
        dev, dt = t[0].device, t[0].dtype
        return tw.hs_step(t[0], t[1], tuple(a.to(dev) for a in hs_cpu),
                          inputs.to(dev), targets.to(dev), 0.025,
                          torch.ones(b, dtype=dt, device=dev))

    def mesh_run(t):
        return meshed._step(t[0], t[1], inputs.cuda(), targets.cuda(),
                            0.025, torch.ones(b, device="cuda"), None)

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        ref = recorded_step(single_run, tables, "cpu", "float64")
        got = recorded_step(mesh_run, tables, "cuda", "float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    bounds = hs_step_bounds(tables, hs_cpu, inputs, targets, 0.025)
    ratio = scatter_bound_ratio(tables, got, ref, bounds)
    out = {"batch": b, "shards": DP_SHARDS, "ratio": ratio,
           "worst_ratio": max(ratio[k] for k in ("updates", "tables",
                                                 "loss")),
           "fit_syn0_max_abs_diff": float(np.abs(single.syn0
                                                 - meshed.syn0).max()),
           "fit_batch_size": meshed.batch_size}
    if not out["worst_ratio"] <= 1.0:
        raise AssertionError(f"dp: Word2Vec HS mesh step past its bound: "
                             f"{out}")
    return out


def dp_cli(tmp: str) -> dict:
    """`cli train -runtime spmd -replicas 1` as a subprocess on a seeded
    Iris-shaped CSV: exit code 0, accuracy >= 0.9."""
    import os
    import re

    csv = os.path.join(tmp, "iris.csv")
    iris_like_csv(csv)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.cli", "train",
         "-input", csv, "-model", "zoo:iris-mlp", "-output",
         os.path.join(tmp, "run"), "-epochs", "30", "-batch", "32",
         "-runtime", "spmd", "-replicas", "1"],
        capture_output=True, text=True, timeout=300)
    acc = re.search(r"Accuracy:\s+([\d.]+)", proc.stdout)
    out = {"rc": proc.returncode, "s": time.perf_counter() - t0,
           "accuracy": float(acc.group(1)) if acc else None,
           "mesh_line": "spmd: elastic mesh over 1 of" in proc.stdout}
    if proc.returncode != 0 or not out["accuracy"] or \
            out["accuracy"] < 0.9 or not out["mesh_line"]:
        raise AssertionError(f"dp: cli train -runtime spmd: {out} "
                             f"{proc.stdout[-800:]} {proc.stderr[-2000:]}")
    return out


def dp_phase(card: str) -> dict:
    """Phase 25 (the module docstring): a 4-shard mesh over the one
    card."""
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.datasets.fetchers import synthetic_cifar10
    from deeplearning4j_tpu_torch.models import (
        MultiLayerNetwork,
        alexnet_cifar10,
        char_lstm,
    )
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk

    t_phase = time.perf_counter()
    conf = char_lstm(compute_dtype="bfloat16")
    n_lstm = sum(hasattr(lc, "fused") for lc in conf.layers)
    batches = dp_char_batches(4)
    out = {"card": card, "shards": DP_SHARDS,
           "mesh": "4 shards on one card (devices=[cuda:0] * 4)",
           "config": "char_lstm(vocab 80, hidden 256), bf16 compute, f32 "
                     "masters, adam lr 0.01, ZeRO-1",
           "global_batch": DP_B, "shard_batch": DP_B // DP_SHARDS,
           "seq": LSTM_T, "lstm_layers": n_lstm}

    # 1. the char-LSTM at full width: B5 once a layer, shard and step
    net, tr = dp_trainer(conf, DP_SHARDS)
    counters = (lk.fused_lstm_forward.launches,
                lk.fused_lstm_forward.residual_launches)
    warm = [tr.fit_batch(*batches[i % 4]) for i in range(DP_WARMUP)]
    for c in counters:
        c.reset()
    run = dp_timed(tr.fit_batch, batches, 0, DP_STEPS)
    launches, with_res = (c.value for c in counters)
    run["losses"] = warm + run["losses"]
    run["warmup_steps"] = DP_WARMUP
    out["char_lstm"] = run
    out["launches"] = launches
    out["launches_expected"] = n_lstm * DP_SHARDS * DP_STEPS
    if launches != out["launches_expected"] or with_res != launches:
        raise AssertionError(f"dp: B5 launched {launches} times ({with_res}"
                             f" with residuals) in {DP_STEPS} steps, "
                             f"expected {out['launches_expected']}")
    losses = run["losses"]
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"dp: losses {losses}")
    zero1_bytes = tr.train_state_bytes()
    del net, tr
    net, tr = dp_trainer(conf, DP_SHARDS, shard_update=False)
    out["train_state_bytes"] = {"zero1": zero1_bytes,
                                "replicated": tr.train_state_bytes(),
                                "note": "per replica (the JAX model)"}
    del net, tr
    one = MultiLayerNetwork(conf).init()
    out["one_device"] = dp_timed(one.fit_batch, batches, DP_WARMUP, DP_STEPS)
    del one
    torch.cuda.empty_cache()
    log(f"dp: char-LSTM bf16, 4 shards x {DP_B // DP_SHARDS} rows: step "
        f"{run['step_ms_mean']:.3f} ms against one device's "
        f"{out['one_device']['step_ms_mean']:.3f} ms at batch {DP_B}; "
        f"B5 {launches} launches in {DP_STEPS} steps; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; peak memory "
        f"{run['peak_memory_bytes']} bytes; train state a replica "
        f"{zero1_bytes} (ZeRO-1) vs "
        f"{out['train_state_bytes']['replicated']} bytes (replicated) "
        f"(4 shards on one card, {card})")

    # 2. float32: bitwise planes, one-device parity, local SGD, elastic
    out["f32"] = dp_f32_legs(batches)
    f = out["f32"]
    log(f"dp: f32 ZeRO-1 = replicated bitwise (params and moments, "
        f"{DP_PARITY_STEPS} steps); 4 shards vs one device, SGD: worst "
        f"leaf {f['sgd_vs_one_device']['max_rel_leaf']:.3g} (bound "
        f"{DP_F32_REL:g}), Adam {f['adam_vs_one_device']['max_rel_leaf']:.3g}"
        f" (recorded); local SGD every {DP_SYNC}: replicas bitwise after "
        f"{len(f['local_sgd']['rounds'])} rounds; elastic 4 -> 2, 1 "
        f"bitwise")
    torch.cuda.empty_cache()

    # 3. mixed precision: the lockstep skip
    out["mixed"] = dp_mixed_leg(batches)
    m = out["mixed"]
    log(f"dp: mixed: an inf input row on shard 0 (loss "
        f"{m['poison_input']['loss']}) and an inf in the last shard's "
        f"gradient slice (loss {m['poison_grad_slice']['loss']:.6g}) "
        f"each skipped on all 4, scale "
        f"{m['poison_input']['scaler_before']['scale']:g} -> "
        f"{m['poison_grad_slice']['scaler_after']['scale']:g}, overflows "
        f"{m['poison_grad_slice']['scaler_after']['overflow_count']}")
    torch.cuda.empty_cache()

    # 4. Word2Vec HS mesh=
    out["w2v_mesh"] = dp_w2v_check()
    log(f"dp: Word2Vec HS mesh step: worst error / bound "
        f"{out['w2v_mesh']['worst_ratio']:.3g}; fit syn0 max diff "
        f"{out['w2v_mesh']['fit_syn0_max_abs_diff']:.3g} (recorded)")

    # 5. the CLI
    with tempfile.TemporaryDirectory(prefix="chip-smoke-dp-cli-") as tmp:
        out["cli"] = dp_cli(tmp)
    log(f"dp: cli train -runtime spmd -replicas 1: accuracy "
        f"{out['cli']['accuracy']:.3f} in {out['cli']['s']:.1f} s")

    # 6. AlexNet bf16 at global batch 128, 4 shards and 1
    cifar = synthetic_cifar10(DP_B * 2)
    alex_batches = staged_batches(cifar, DP_B, 2)
    alex = {}
    for n in (DP_SHARDS, 1):
        net, tr = dp_trainer(alexnet_cifar10(compute_dtype="bfloat16"), n)
        alex[f"shards_{n}"] = dp_timed(tr.fit_batch, alex_batches,
                                       DP_ALEX_WARMUP, DP_ALEX_STEPS)
        del net, tr
        torch.cuda.empty_cache()
    out["alexnet_bf16"] = alex
    if not all(math.isfinite(v) for r in alex.values()
               for v in r["losses"]):
        raise AssertionError(f"dp: alexnet losses {alex}")
    log(f"dp: alexnet bf16 batch {DP_B}: 4 shards "
        f"{alex['shards_4']['step_ms_mean']:.3f} ms a step "
        f"({alex['shards_4']['examples_per_s']:.1f} examples/s), 1 shard "
        f"{alex['shards_1']['step_ms_mean']:.3f} ms "
        f"({alex['shards_1']['examples_per_s']:.1f} examples/s) "
        f"(4 shards on one card, {card})")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"dp: phase in {out['phase_s']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 26: the LM mesh trainers, 4 shards on one card

MESH_SHARDS = 4
MESH_LAYERS = 4                  # gpt2_small's 12 cut to 4 for time
MESH_WARMUP, MESH_STEPS = 2, 3
MESH_MOE_STEPS = 2
# Adam's rate for the full-width legs: at the train phase's 1e-3 the
# one-device step itself rises on the fifth step on this one batch, so
# a five-step "falling" check cannot hold; at 3e-4 every path falls
MESH_LR = 3e-4
MESH_PARITY_B = 2
MESH_PARITY_LR = 1.0             # one SGD step: the change is -g exactly
MESH_PARITY_LOSS_REL = 1e-5
MESH_PARITY_LEAF_REL = 1e-3      # the train phase's bound
MESH_ZERO_LAYERS, MESH_ZERO_STEPS = 2, 3
MESH_RING_SHAPE = (2, 1024, 12, 64)
MESH_RING_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
MESH_CLI_ARGS = ("-d-model", "64", "-layers", "4")


def mesh_of(shape, names):
    """A mesh of prod(shape) shards that all lie on card 0."""
    import torch

    from deeplearning4j_tpu_torch.parallel import make_mesh

    n = int(np.prod(shape))
    return make_mesh(shape, names, devices=[torch.device("cuda", 0)] * n)


def flash_counters() -> dict:
    from deeplearning4j_tpu_torch.parallel import kernels as fk

    return {"flash_fwd": fk.flash_forward.launches,
            "flash_bwd_dkv": fk.flash_bwd_dkv.launches,
            "flash_bwd_dq": fk.flash_bwd_dq.launches}


def mesh_batch(cfg, b: int):
    """The train phase's tokens (default_rng(3)), the first `b` rows."""
    import torch

    rng = np.random.default_rng(3)
    data = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1))).cuda()
    return data[:b, :-1], data[:b, 1:]


def mesh_train_leg(name: str, trainer, tokens, targets, want: dict) -> dict:
    """`MESH_WARMUP` then `MESH_STEPS` timed steps on one batch: losses
    finite and falling, the flash launches a timed step equal to
    `want`."""
    import torch

    counters = flash_counters()
    losses = [trainer.fit_batch(tokens, targets)
              for _ in range(MESH_WARMUP)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated()
    for c in counters.values():
        c.reset()
    step_ms = []
    t0 = time.perf_counter()
    for _ in range(MESH_STEPS):
        ts = time.perf_counter()
        losses.append(trainer.fit_batch(tokens, targets))  # waits
        step_ms.append((time.perf_counter() - ts) * 1e3)
    wall = time.perf_counter() - t0
    per_step = {n: c.value / MESH_STEPS for n, c in counters.items()}
    if per_step != want:
        raise AssertionError(f"mesh {name}: flash launches a step "
                             f"{per_step}, expected {want}")
    if not all(math.isfinite(v) for v in losses) or \
            not losses[-1] < losses[0]:
        raise AssertionError(f"mesh {name}: losses {losses}")
    b, s = tokens.shape
    return {"losses": losses, "warmup_steps": MESH_WARMUP,
            "steps": MESH_STEPS, "step_ms": step_ms,
            "step_ms_mean": wall * 1e3 / MESH_STEPS,
            "tokens_per_s": b * s * MESH_STEPS / wall,
            "peak_memory_bytes": torch.cuda.max_memory_allocated(),
            "resident_bytes": resident,
            "peak_above_resident_bytes":
                torch.cuda.max_memory_allocated() - resident,
            "launches_per_step": per_step}


def hybrid_shard_bytes(trainer) -> dict:
    """Parameter bytes a ``model`` shard: its slices of the split leaves,
    and the replicated leaves every shard reads."""
    from deeplearning4j_tpu_torch.tree import flatten_tree

    specs = flatten_tree(trainer._pspecs)
    split = [0] * trainer._grid.tp
    replicated = 0
    for key, t in flatten_tree(trainer.params).items():
        size = t.numel() * t.element_size()
        if key in specs:
            replicated += size
        else:
            split[trainer._units[key][1]] += size
    return {"split_by_model_shard": split, "replicated": replicated}


def mesh_full_width(card: str, train) -> dict:
    """Legs 1-2: the hybrid and the pipeline trainer at gpt2_small width
    (`MESH_LAYERS` deep), bf16 compute, Adam, global batch 8 x 1024, the
    layouts `_lm_mesh_layout` picks for 4 devices."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.cli import _lm_mesh_layout
    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        HybridParallelTrainer,
        PipelineParallelTrainer,
    )
    from deeplearning4j_tpu_torch.tree import tree_leaves

    cfg = dataclasses.replace(tfm.gpt2_small(max_len=TRAIN_SEQ),
                              n_layers=MESH_LAYERS)
    tree = tfm.numpy_params(cfg, seed=0)
    tokens, targets = mesh_batch(cfg, TRAIN_BATCH)
    L, remat = cfg.n_layers, int(cfg.remat)
    out = {}
    # the reference: the one-device step on the same batch, rate and
    # steps (accum 1)
    one = OneDeviceLM(cfg, tree)
    out["one_device"] = mesh_train_leg(
        "one device", one, tokens, targets,
        {"flash_fwd": (1 + remat) * L, "flash_bwd_dkv": L,
         "flash_bwd_dq": L})
    del one
    torch.cuda.empty_cache()
    shape, b, _ = _lm_mesh_layout("hybrid", MESH_SHARDS, TRAIN_SEQ,
                                  cfg.n_heads, cfg.n_layers, TRAIN_BATCH)
    dp, sp, tp = shape
    pairs = sp * (sp + 1) // 2
    tr = HybridParallelTrainer(cfg, mesh_of(shape, ("data", "seq", "model")),
                               lr=MESH_LR, updater="adam", params=tree)
    # remat recomputes the whole block, ring included: B2 twice a block
    # pair, as jax.checkpoint(block) runs it
    want = {"flash_fwd": (1 + remat) * L * dp * tp * pairs,
            "flash_bwd_dkv": L * dp * tp * pairs,
            "flash_bwd_dq": L * dp * tp * pairs}
    leg = mesh_train_leg("hybrid", tr, tokens, targets, want)
    leg.update(mesh=list(shape), batch=b,
               param_bytes=hybrid_shard_bytes(tr))
    out["hybrid"] = leg
    del tr
    torch.cuda.empty_cache()
    shape, b, mb = _lm_mesh_layout("pipeline", MESH_SHARDS, TRAIN_SEQ,
                                   cfg.n_heads, cfg.n_layers, TRAIN_BATCH)
    dp, stages = shape
    tr = PipelineParallelTrainer(cfg, mesh_of(shape, ("data", "stage")),
                                 n_microbatches=mb, lr=MESH_LR,
                                 updater="adam", params=tree)
    want = {"flash_fwd": 2 * L * mb * dp, "flash_bwd_dkv": L * mb * dp,
            "flash_bwd_dq": L * mb * dp}       # remat_stage: twice
    leg = mesh_train_leg("pipeline", tr, tokens, targets, want)
    stage_bytes = [sum(t.numel() * t.element_size()
                       for t in tr._stage_leaves(s)) for s in range(stages)]
    leg.update(mesh=list(shape), batch=b, microbatches=mb,
               param_bytes={"by_stage": stage_bytes, "io": sum(
                   t.numel() * t.element_size()
                   for t in tree_leaves(tr.io_params))})
    out["pipeline"] = leg
    del tr
    torch.cuda.empty_cache()
    one = out["one_device"]
    for leg in (out["hybrid"], out["pipeline"]):
        leg["one_device_step_ms"] = one["step_ms_mean"]
        leg["vs_one_device"] = leg["step_ms_mean"] / one["step_ms_mean"]
        leg["train_phase_step_ms"] = (train["step_ms_mean"] if train
                                      else None)
        leg["max_abs_loss_diff_vs_one_device"] = max(
            abs(a - b) for a, b in zip(leg["losses"], one["losses"]))
    return out


class OneDeviceLM:
    """`make_accum_train_step` (accum 1) on card 0 behind the trainers'
    `fit_batch`."""

    def __init__(self, cfg, tree):
        from deeplearning4j_tpu_torch.parallel import transformer as tfm
        from deeplearning4j_tpu_torch.parallel.hybrid import (
            _master_f32,
            make_accum_train_step,
        )

        self.params = _master_f32(tfm.params_from_numpy(tree, device="cuda"))
        self.step, init = make_accum_train_step(cfg, lr=MESH_LR,
                                                updater="adam")
        self.opt = init(self.params)

    def fit_batch(self, tokens, targets) -> float:
        self.params, self.opt, loss = self.step(self.params, self.opt,
                                                tokens, targets)
        return float(loss)


def mesh_moe(card: str) -> dict:
    """Leg 3: the moe phase's config (`MESH_LAYERS` deep) on (1, 2, 2), 2
    steps: finite losses, and every dispatch's capacity that of the
    global tokens."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import HybridParallelTrainer

    cfg = dataclasses.replace(moe_config(), n_layers=MESH_LAYERS)
    tokens, targets = mesh_batch(cfg, TRAIN_BATCH)
    tr = HybridParallelTrainer(cfg, mesh_of((1, 2, 2), ("data", "seq",
                                                        "model")),
                               lr=MESH_LR, updater="adam",
                               params=tfm.numpy_params(cfg, seed=0))
    caps = []
    route = tfm._moe_route

    def recording(p, xf, cf, top_k):
        res = route(p, xf, cf, top_k)
        caps.append((int(xf.shape[0]), res[4]))
        return res

    tfm._moe_route = recording
    try:
        t0 = time.perf_counter()
        losses = [tr.fit_batch(tokens, targets)
                  for _ in range(MESH_MOE_STEPS)]
        wall = time.perf_counter() - t0
    finally:
        tfm._moe_route = route
    a = TRAIN_BATCH * TRAIN_SEQ * cfg.moe_top_k
    c = max(1, min(a, math.ceil(cfg.moe_capacity_factor * a
                                / cfg.n_experts)))
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"mesh moe: losses {losses}")
    if {cap for _, cap in caps} != {c} or \
            {n for n, _ in caps} != {TRAIN_BATCH * TRAIN_SEQ}:
        raise AssertionError(f"mesh moe: dispatches over {set(caps)} "
                             f"(tokens, capacity), expected the global "
                             f"{TRAIN_BATCH * TRAIN_SEQ} tokens at C {c}")
    peak = torch.cuda.max_memory_allocated()
    del tr
    torch.cuda.empty_cache()
    return {"mesh": [1, 2, 2], "experts": cfg.n_experts,
            "experts_a_model_shard": cfg.n_experts // 2,
            "top_k": cfg.moe_top_k, "capacity_factor":
            cfg.moe_capacity_factor, "capacity": c,
            "dispatches": len(caps), "losses": losses,
            "step_ms_mean": wall * 1e3 / MESH_MOE_STEPS,
            "peak_memory_bytes": peak}


def leaf_change_errors(init: dict, got: dict, want: dict) -> tuple:
    """The worst leaf: max |change got - change want| over the leaf's
    largest |change want|.  A key bias's exact gradient is zero, so its
    error is taken relative to the query bias of the same layer."""
    from deeplearning4j_tpu_torch.tree import flatten_tree

    i, g, w = (flatten_tree(t) for t in (init, got, want))
    scale = {k: float(np.abs(np.asarray(w[k], np.float64)
                             - np.asarray(i[k], np.float64)).max())
             for k in w}
    worst, worst_key = 0.0, None
    for k in w:
        dg = np.asarray(g[k], np.float64) - np.asarray(i[k], np.float64)
        dw = np.asarray(w[k], np.float64) - np.asarray(i[k], np.float64)
        err = float(np.abs(dg - dw).max()) / scale[k.replace("//bk",
                                                             "//bq")]
        if not math.isfinite(err) or err > worst:
            worst, worst_key = err, k
    return worst, worst_key


def mesh_f32_parity() -> dict:
    """Leg 4: float32 at full width (`MESH_LAYERS` deep), TF32 off.  One
    SGD step of each trainer at batch 2 x 1024 against the one-device
    `make_accum_train_step`; then ZeRO-1 = replicated bitwise on (2, 1,
    2) and (2, 2) with 2 layers and 3 Adam steps."""
    import dataclasses

    import torch

    from deeplearning4j_tpu_torch.parallel import transformer as tfm
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        HybridParallelTrainer,
        PipelineParallelTrainer,
        _master_f32,
        make_accum_train_step,
    )
    from deeplearning4j_tpu_torch.tree import flatten_tree, tree_leaves

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = dataclasses.replace(tfm.gpt2_small(max_len=TRAIN_SEQ),
                                  dtype="float32", n_layers=MESH_LAYERS)
        tree = tfm.numpy_params(cfg, seed=0)
        tokens, targets = mesh_batch(cfg, MESH_PARITY_B)
        params = _master_f32(tfm.params_from_numpy(tree, device="cuda"))
        step, init = make_accum_train_step(cfg, lr=MESH_PARITY_LR)
        params, _, loss = step(params, init(params), tokens, targets)
        want_loss = float(loss)
        want = tfm.params_to_numpy(params)
        del params
        out = {}
        for name, make in (
                ("hybrid", lambda: HybridParallelTrainer(
                    cfg, mesh_of((1, 2, 2), ("data", "seq", "model")),
                    lr=MESH_PARITY_LR, params=tree)),
                ("pipeline", lambda: PipelineParallelTrainer(
                    cfg, mesh_of((1, 4), ("data", "stage")),
                    n_microbatches=2, lr=MESH_PARITY_LR, params=tree))):
            tr = make()
            got_loss = tr.fit_batch(tokens, targets)
            worst, key = leaf_change_errors(tree, tr.export_params(), want)
            loss_rel = abs(got_loss - want_loss) / abs(want_loss)
            out[name] = {"loss": got_loss, "loss_one_device": want_loss,
                         "loss_rel_err": loss_rel,
                         "leaf_change_max_rel_err": worst,
                         "worst_leaf": key}
            del tr
            torch.cuda.empty_cache()
            if not loss_rel <= MESH_PARITY_LOSS_REL or \
                    not worst <= MESH_PARITY_LEAF_REL:
                raise AssertionError(f"mesh f32 {name} vs one device: "
                                     f"{out[name]}")
        zcfg = dataclasses.replace(cfg, n_layers=MESH_ZERO_LAYERS)
        ztree = tfm.numpy_params(zcfg, seed=1)
        zb = {"hybrid": 2, "pipeline": 4}
        for name in ("hybrid", "pipeline"):
            tok, tgt = mesh_batch(zcfg, zb[name])
            runs = []
            for shard in (True, False):
                if name == "hybrid":
                    tr = HybridParallelTrainer(
                        zcfg, mesh_of((2, 1, 2), ("data", "seq", "model")),
                        lr=MESH_LR, updater="adam", shard_update=shard,
                        params=ztree)
                else:
                    tr = PipelineParallelTrainer(
                        zcfg, mesh_of((2, 2), ("data", "stage")),
                        n_microbatches=2, lr=MESH_LR, updater="adam",
                        shard_update=shard, params=ztree)
                losses = [tr.fit_batch(tok, tgt)
                          for _ in range(MESH_ZERO_STEPS)]
                moments = None
                if name == "hybrid" and shard:
                    part = tr.opt_partition()
                    moments = {k: torch.cat([st["m"][k] for st in
                                             tr.opt_state], dim=p.dim)
                               if not p.is_replicated
                               else tr.opt_state[0]["m"][k]
                               for k, p in part.items()}
                elif name == "hybrid":
                    moments = flatten_tree(tr.opt_state["m"])
                runs.append((losses, tr.export_params(), moments))
                del tr
                torch.cuda.empty_cache()
            (la, pa, ma), (lb, pb, mb) = runs
            same = la == lb and all(
                np.array_equal(a, b) for a, b in zip(tree_leaves(pa),
                                                     tree_leaves(pb)))
            if ma is not None:
                same = same and all(torch.equal(ma[k], mb[k]) for k in mb)
            out[f"zero1_{name}"] = {"mesh": [2, 1, 2] if name == "hybrid"
                                    else [2, 2], "steps": MESH_ZERO_STEPS,
                                    "bitwise": same, "losses": la}
            if not same:
                raise AssertionError(f"mesh: ZeRO-1 {name} differs from "
                                     f"the replicated update")
        return out
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def ring_case(dtype_name: str, causal: bool) -> dict:
    """`ring_flash_attention` over 4 seq shards of card 0 against
    `flash_attention` on the whole sequence: outputs and dq / dk / dv,
    the block pairs launched, device ms of forward + backward."""
    import torch

    from deeplearning4j_tpu_torch.parallel.kernels import flash_attention
    from deeplearning4j_tpu_torch.parallel.mesh import Program, make_mesh
    from deeplearning4j_tpu_torch.parallel.ring_attention import (
        ring_flash_attention,
    )

    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype_name]
    rng = np.random.default_rng(5)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(
        MESH_RING_SHAPE).astype(np.float32)).cuda().to(dt)
        for _ in range(4))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]

    def whole():
        out = flash_attention(*leaves, causal)
        return (out, *torch.autograd.grad(out, leaves, g))

    mesh = make_mesh((MESH_SHARDS,), ("seq",),
                     devices=["cuda:0"] * MESH_SHARDS)

    def ring():
        # the trainers' ring: one program over the mesh, dicts of blocks
        blocks = [dict(enumerate(t.chunk(MESH_SHARDS, dim=1)))
                  for t in leaves]
        out = ring_flash_attention(*blocks, "seq", causal,
                                   program=Program(mesh))
        out = torch.cat([out[s] for s in range(MESH_SHARDS)], dim=1)
        return (out, *torch.autograd.grad(out, leaves, g))

    want = whole()
    counters = flash_counters()
    for c in counters.values():
        c.reset()
    got = ring()
    torch.cuda.synchronize()
    launches = {n: c.value for n, c in counters.items()}
    pairs = (MESH_SHARDS * (MESH_SHARDS + 1) // 2 if causal
             else MESH_SHARDS ** 2)
    if launches != {n: pairs for n in counters}:
        raise AssertionError(f"mesh ring ({dtype_name}, causal {causal}): "
                             f"launches {launches}, expected {pairs} each")
    errs = {}
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, want):
        a, b = a.detach().float(), b.detach().float()
        errs[name] = float((a - b).abs().max() / b.abs().max())
    tol = MESH_RING_TOL[dtype_name]
    if not all(e <= tol for e in errs.values()):
        raise AssertionError(f"mesh ring ({dtype_name}, causal {causal}): "
                             f"relative errors {errs} over {tol}")
    ring_ms = device_ms(ring, iters=10)
    whole_ms = device_ms(whole, iters=10)
    return {"dtype": dtype_name, "causal": causal,
            "shape": dict(zip("BSHD", MESH_RING_SHAPE)),
            "shards": MESH_SHARDS, "launches": launches,
            "rel_err": errs, "tol": tol, "ring_ms": ring_ms,
            "one_device_flash_ms": whole_ms}


def mesh_cli(card: str, tmp: str) -> dict:
    """Leg 6: `cli lm -runtime hybrid|pipeline` in process on the visible
    cards (one: the trivial mesh), then `python -m
    deeplearning4j_tpu_torch.dryrun 4` as a child process."""
    import contextlib
    import io
    import os
    import re

    from deeplearning4j_tpu_torch import cli

    root = os.path.dirname(os.path.abspath(__file__))
    corpus = os.path.join(root, "README.md")
    out = {}
    for runtime in ("hybrid", "pipeline"):
        counters = flash_counters()
        for c in counters.values():
            c.reset()
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["lm", "-input", corpus, "-output",
                           os.path.join(tmp, runtime), "-runtime", runtime,
                           *MESH_CLI_ARGS])
        text = buf.getvalue()
        m = re.search(r"final loss ([0-9.]+|nan|inf)", text)
        loss = float(m.group(1)) if m else float("nan")
        out[runtime] = {"rc": rc, "s": time.perf_counter() - t0,
                        "layout": next((ln for ln in text.splitlines()
                                        if "training on mesh" in ln), None),
                        "final_loss": loss,
                        "launches": {n: c.value
                                     for n, c in counters.items()}}
        if rc != 0 or not math.isfinite(loss) or \
                out[runtime]["layout"] is None or \
                not out[runtime]["launches"]["flash_fwd"]:
            raise AssertionError(f"mesh cli {runtime}: {out[runtime]}\n"
                                 f"{text}")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "deeplearning4j_tpu_torch.dryrun",
         str(MESH_SHARDS), "--out", tmp], cwd=root, capture_output=True,
        text=True, timeout=600)
    out["dryrun"] = {"rc": proc.returncode, "s": time.perf_counter() - t0,
                     "lines": [ln for ln in proc.stdout.splitlines()
                               if ln.startswith("dryrun")]}
    if proc.returncode != 0 or "dryrun GREEN" not in proc.stdout:
        raise AssertionError(f"mesh dryrun: {proc.stdout}\n{proc.stderr}")
    return out


def mesh_phase(card: str, train=None) -> dict:
    """Phase 26 (the module docstring): the LM mesh trainers, 4 shards on
    one card (``devices=[cuda:0] * 4``)."""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    out = {"card": card,
           "mesh": "4 shards on one card (devices=[cuda:0] * 4)",
           "config": "gpt2_small(max_len=1024), bf16 compute, f32 masters, "
                     f"adam lr {MESH_LR}", "global_batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ}
    out.update(mesh_full_width(card, train))
    one = out["one_device"]
    log(f"mesh: one device, batch {TRAIN_BATCH} x {TRAIN_SEQ} (accum 1): "
        f"{one['step_ms_mean']:.1f} ms a step, losses "
        f"{[round(v, 4) for v in one['losses']]} ({card})")
    for name in ("hybrid", "pipeline"):
        leg = out[name]
        log(f"mesh: {name} {leg['mesh']} at gpt2_small, batch "
            f"{leg['batch']} x {TRAIN_SEQ}: {leg['step_ms_mean']:.1f} ms a "
            f"step ({leg['tokens_per_s']:.0f} tokens/s; "
            f"{leg['vs_one_device']:.2f}x one device's), bf16 losses vs "
            f"one device max diff "
            f"{leg['max_abs_loss_diff_vs_one_device']:.4g} (bf16 "
            f"resolution; the f32 leg checks parity), "
            f"flash launches a step "
            f"{leg['launches_per_step']}, losses {leg['losses'][0]:.4f} -> "
            f"{leg['losses'][-1]:.4f}, peak "
            f"{leg['peak_memory_bytes'] / 2**30:.2f} GiB "
            f"({leg['peak_above_resident_bytes'] / 1e9:.2f} GB above the "
            f"resident {leg['resident_bytes'] / 1e9:.2f} GB), "
            f"parameter bytes "
            f"{leg['param_bytes']} (4 shards on one card, {card})")
    out["moe"] = mesh_moe(card)
    log(f"mesh: MoE hybrid (1, 2, 2), {out['moe']['experts']} experts, "
        f"{out['moe']['experts_a_model_shard']} a model shard: capacity "
        f"{out['moe']['capacity']} from the global tokens in "
        f"{out['moe']['dispatches']} dispatches, losses "
        f"{out['moe']['losses']}, {out['moe']['step_ms_mean']:.1f} ms a "
        f"step ({card})")
    out["f32"] = mesh_f32_parity()
    f = out["f32"]
    log(f"mesh: f32 one SGD step vs one device: hybrid loss "
        f"{f['hybrid']['loss_rel_err']:.3g}, worst leaf change "
        f"{f['hybrid']['leaf_change_max_rel_err']:.3g} "
        f"({f['hybrid']['worst_leaf']}); pipeline loss "
        f"{f['pipeline']['loss_rel_err']:.3g}, leaf "
        f"{f['pipeline']['leaf_change_max_rel_err']:.3g} "
        f"({f['pipeline']['worst_leaf']}); ZeRO-1 = replicated bitwise "
        f"(hybrid (2, 1, 2), pipeline (2, 2))")
    torch.cuda.empty_cache()
    out["ring"] = [ring_case(dt, causal) for dt in ("float32", "bfloat16")
                   for causal in (True, False)]
    for r in out["ring"]:
        log(f"mesh: ring {r['dtype']} causal {r['causal']}: B2 "
            f"{r['launches']['flash_fwd']}, errors "
            f"{ {k: float(f'{v:.3g}') for k, v in r['rel_err'].items()} }, "
            f"fwd+bwd {r['ring_ms']:.4f} ms on 4 shards vs "
            f"{r['one_device_flash_ms']:.4f} ms one device ({card})")
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="chip-smoke-mesh-") as tmp:
        out["cli"] = mesh_cli(card, tmp)
    c = out["cli"]
    log(f"mesh: cli lm -runtime hybrid: {c['hybrid']['layout']}, loss "
        f"{c['hybrid']['final_loss']}; pipeline: {c['pipeline']['layout']}"
        f", loss {c['pipeline']['final_loss']}; dryrun 4: "
        f"{c['dryrun']['lines'][-1]}")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"mesh: phase in {out['phase_s']:.1f} s ({card})")
    return out


# ---------------------------------------------------------------------------
# phase 27: training across processes, 2 processes of 2 shards on the card

MP_PROCS = 2
MP_LOCAL = DP_SHARDS // MP_PROCS   # shards a process
MP_STEPS = 10                      # each of ZeRO-1 and replicated
MP_CKPT_AT = 5                     # the ZeRO-1 run's checkpoint
MP_KILLED_AT = 99                  # the save process 1 dies in
MP_SYNC = 4                        # local SGD: 2 rounds of 4 steps
MP_GROUP_TIMEOUT_S = 120           # a collective's or barrier's wait
MP_JOB_S = 420                     # a job's deadline
MP_W2V_B = 4096
# the LM mesh trainers across the 2 processes: gpt2_small width, bf16
# compute, f32 masters, Adam, ZeRO-1, global batch 4 x 1024, 3 steps;
# depth cut to 2 layers (4 for the pipeline, one a stage)
MP_LM_B, MP_LM_STEPS, MP_LM_MICROBATCHES = 4, 3, 4
MP_LM_LEGS = (("hybrid_1x2x2", "hybrid", (1, 2, 2), 2),   # the ring
              ("hybrid_2x1x2", "hybrid", (2, 1, 2), 2),   # data, ZeRO-1
              ("moe_1x1x4", "moe", (1, 1, 4), 2),         # experts
              ("pipeline_1x4", "pipeline", (1, 4), 4))    # the hops
MP_LM_AXES = {"hybrid": ("data", "seq", "model"),
              "moe": ("data", "seq", "model"), "pipeline": ("data", "stage")}


def mp_mesh(local: int):
    """The 4-shard mesh: `local` shards of card 0 in this process (in a
    job of 2 processes, the other process's 2 follow)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import make_mesh

    return make_mesh((DP_SHARDS,), ("data",),
                     devices=[torch.device("cuda", 0)] * local)


def host_arrays(tree, prefix: str = "") -> dict:
    """A tree's leaves as float32 host copies, by keypath."""
    from deeplearning4j_tpu_torch.tree import flatten_tree

    return {prefix + k: v.detach().float().cpu().numpy().copy()
            for k, v in flatten_tree(tree).items()}


def arrays_compare(got: dict, want: dict) -> dict:
    """Bitwise, or the largest absolute difference, over matching keys."""
    if set(got) != set(want):
        return {"bitwise": False, "max_abs": math.inf,
                "keys": sorted(set(got) ^ set(want))}
    bitwise = all(np.array_equal(got[k], want[k]) for k in want)
    worst = max(float(np.abs(got[k].astype(np.float64)
                             - want[k].astype(np.float64)).max())
                for k in want)
    return {"bitwise": bitwise, "max_abs": worst}


def mp_train_leg(mesh, batches, steps: int = MP_STEPS, ckpt=None,
                 **kw) -> tuple:
    """The dp phase's bf16 char-LSTM over `mesh`, `steps` steps from the
    seeded init (the B5 count set to 0 just before, read just after);
    with `ckpt` the published state of step `MP_CKPT_AT` is saved there.
    Returns (net, record, arrays)."""
    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.nn.layers import lstm_kernel as lk
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer
    from deeplearning4j_tpu_torch.runtime.checkpoint import save_checkpoint

    net = MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()
    tr = DataParallelTrainer(net, mesh=mesh, **kw)
    arrays, losses, ms = {}, [], []
    counter = lk.fused_lstm_forward.launches
    counter.reset()
    for i in range(steps):
        t0 = time.perf_counter()
        losses.append(tr.fit_batch(*batches[i % len(batches)]))
        ms.append((time.perf_counter() - t0) * 1e3)
        if ckpt is not None and i + 1 == MP_CKPT_AT:
            tr.publish_train_state()
            arrays.update(host_arrays(net.params, "saved_params/"))
            arrays.update(host_arrays(net.updater_state, "saved_updater/"))
            save_checkpoint(ckpt, MP_CKPT_AT, net.params,
                            updater_state=net.updater_state)
    torch.cuda.synchronize()
    launches = counter.value
    tr.finalize()
    arrays.update(host_arrays(net.params, "params/"))
    arrays.update(host_arrays(net.updater_state, "updater/"))
    return net, {"losses": losses, "step_ms": ms,
                 "step_ms_mean": float(np.mean(ms[1:])), "b5": launches,
                 "scaling_report": tr.scaling_report()}, arrays


def mp_w2v(mesh) -> tuple:
    """Word2Vec NEG over `mesh`: a one-epoch fit of the topic corpus at
    batch 4096, then one step of its `_step` on the fitted tables and the
    corpus's first 4096 pairs, every ``index_add_`` recorded
    (`recorded_step`) with the negatives it drew.  Across processes each
    process applies the gathered scatter to its own copy of the tables,
    deterministically (`parallel.mesh.sparse_allgather_step`), so every
    process's fit and step see the same tables."""
    import torch

    from deeplearning4j_tpu_torch.nlp import word2vec as tw

    sents = topic_corpus()
    w = tw.Word2Vec(vector_length=100, window=5, negative=5, epochs=1,
                    batch_size=MP_W2V_B, seed=1, mesh=mesh).fit(sents)
    encoded = [w.vocab.encode(t) for t in w._sentences_to_tokens(sents)]
    pairs = w._make_pairs(encoded, np.random.default_rng(5))[:MP_W2V_B]
    b = len(pairs)
    inputs = torch.from_numpy(pairs[:, 0]).long()
    targets = torch.from_numpy(pairs[:, 1]).long()
    tables = [torch.from_numpy(w.syn0), torch.from_numpy(w.syn1neg)]
    negs = w._negatives(torch.Generator(device="cuda").manual_seed(5), b)

    def run(t):
        return w._step(t[0], t[1], inputs.cuda(), targets.cuda(), 0.025,
                       torch.ones(b, device="cuda"),
                       torch.Generator(device="cuda").manual_seed(5))

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = recorded_step(run, tables, "cuda", "float32")
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    arrays = {"inputs": inputs.numpy(), "targets": targets.numpy(),
              "negs": negs.cpu().numpy(), "table0": w.syn0.copy(),
              "table1": w.syn1neg.copy(),
              "got0": got["tables"][0].cpu().numpy(),
              "got1": got["tables"][1].cpu().numpy()}
    for n, (i, rows, d) in enumerate(got["adds"]):
        arrays.update({f"add{n}_i": np.asarray(i), f"add{n}_rows":
                       rows.numpy(), f"add{n}_d": d.numpy()})
    return {"loss": got["loss"], "adds": len(got["adds"]), "batch": b}, arrays


def mp_w2v_check(recs: list) -> dict:
    """Each run's NEG step (a process's of the 2-process mesh, or this
    process's 4-shard mesh), on its own fitted tables, against the
    float64 recompute of the one-device `neg_step` on the same tables,
    pairs and negatives, under the nlp phase's a-priori float32 bounds
    (`neg_step_bounds`, `scatter_bound_ratio`).  The two processes' fits
    ("table0", "table1") and steps ("got0", "got1") must be bitwise
    equal: every process keeps an equal replica.  The one-process fit
    adds by the card's atomics, in their order: its distance from the
    processes' fit is reported."""
    import torch

    from deeplearning4j_tpu_torch.nlp import word2vec as tw

    a0 = recs[0][1]
    out = {}
    for name, (rec, arr) in zip(("process_0", "process_1", "one_process"),
                                recs):
        tables = [torch.from_numpy(arr["table0"]),
                  torch.from_numpy(arr["table1"])]
        inputs, targets, negs = (torch.from_numpy(arr[k])
                                 for k in ("inputs", "targets", "negs"))
        b = int(inputs.shape[0])

        def single(t):
            return tw.neg_step(t[0], t[1], inputs, targets, negs, 0.025,
                               torch.ones(b, dtype=t[0].dtype))

        ref = recorded_step(single, tables, "cpu", "float64")
        bounds = neg_step_bounds(tables, inputs, targets, negs, 0.025)
        got = {"loss": rec["loss"],
               "tables": [torch.from_numpy(arr["got0"]),
                          torch.from_numpy(arr["got1"])],
               "adds": [(int(arr[f"add{n}_i"]),
                         torch.from_numpy(arr[f"add{n}_rows"]),
                         torch.from_numpy(arr[f"add{n}_d"]))
                        for n in range(rec["adds"])]}
        ratio = scatter_bound_ratio(tables, got, ref, bounds)
        out[name] = {
            "same_pairs": all(np.array_equal(arr[k], a0[k]) for k in
                              ("inputs", "targets", "negs")),
            "ratio": {k: ratio[k] for k in ("updates", "tables", "loss")}}
    out["worst_ratio"] = max(max(out[k]["ratio"].values()) for k in
                             ("process_0", "process_1", "one_process"))
    a1, one = recs[1][1], recs[2][1]
    out["replicas_bitwise"] = all(np.array_equal(a1[k], a0[k]) for k in
                                  ("table0", "table1", "got0", "got1"))
    out["fit_max_abs_diff"] = {
        "process_1_vs_0": max(float(np.abs(a1[k] - a0[k]).max())
                              for k in ("table0", "table1")),
        "one_process_vs_process_0": max(
            float(np.abs(one[k] - a0[k]).max())
            for k in ("table0", "table1"))}
    return out


def mp_lm_config(kind: str, layers: int):
    import dataclasses

    from deeplearning4j_tpu_torch.parallel.transformer import gpt2_small

    base = (moe_config() if kind == "moe"
            else gpt2_small(max_len=TRAIN_SEQ))
    return dataclasses.replace(base, n_layers=layers)


def mp_lm_want(kind: str, shape, layers: int, shards) -> dict:
    """B2 / B3 / B4 launches a step of the mesh shards `shards`: a ring
    block at seq position j runs j + 1 causal block pairs a layer, B2
    once more with remat (the mesh program recomputes the whole block,
    ring included); a pipeline stage runs the flash kernels once a
    microbatch and layer, B2 twice (the stage is recomputed)."""
    if kind == "pipeline":
        per = layers // shape[1] * MP_LM_MICROBATCHES * len(shards)
        return {"flash_fwd": 2 * per, "flash_bwd_dkv": per,
                "flash_bwd_dq": per}
    sp, tp = shape[1], shape[2]
    pairs = layers * sum((s // tp) % sp + 1 for s in shards)
    remat = int(mp_lm_config(kind, layers).remat)
    return {"flash_fwd": (1 + remat) * pairs, "flash_bwd_dkv": pairs,
            "flash_bwd_dq": pairs}


def leaf_digests(flat: dict) -> dict:
    """sha256 of each leaf's bytes: two runs' leaves compared bitwise
    without moving them between processes."""
    import hashlib

    return {k: hashlib.sha256(np.ascontiguousarray(v).tobytes()).hexdigest()
            for k, v in flat.items()}


def mp_lm_leg(kind: str, shape, layers: int, mesh) -> dict:
    """`MP_LM_STEPS` steps of one LM leg over `mesh` from
    ``numpy_params(seed=0)`` on the train phase's tokens: losses, ms a
    step (host wall, each step read back), B2 / B3 / B4 launches a step
    (counts set to 0 just before, read just after), the bytes this
    process sent to the other a step, the exported leaves' digests."""
    import torch

    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.parallel.hybrid import (
        HybridParallelTrainer,
        PipelineParallelTrainer,
    )
    from deeplearning4j_tpu_torch.parallel.transformer import numpy_params
    from deeplearning4j_tpu_torch.tree import flatten_tree

    cfg = mp_lm_config(kind, layers)
    tree = numpy_params(cfg, seed=0)
    tokens, targets = mesh_batch(cfg, MP_LM_B)
    if kind == "pipeline":
        tr = PipelineParallelTrainer(cfg, mesh,
                                     n_microbatches=MP_LM_MICROBATCHES,
                                     lr=MESH_LR, updater="adam", params=tree)
    else:
        tr = HybridParallelTrainer(cfg, mesh, lr=MESH_LR, updater="adam",
                                   params=tree)
    counters = flash_counters()
    torch.cuda.synchronize()
    for c in (*counters.values(), mesh_lib.P2P_SENT):
        c.reset()
    losses, ms = [], []
    for _ in range(MP_LM_STEPS):
        t0 = time.perf_counter()
        losses.append(tr.fit_batch(tokens, targets))        # waits
        ms.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    out = {"mesh": list(shape), "layers": layers, "losses": losses,
           "step_ms": ms, "step_ms_mean": float(np.mean(ms[1:])),
           "launches_per_step": {n: c.value / MP_LM_STEPS
                                 for n, c in counters.items()},
           "bytes_sent_per_step": mesh_lib.P2P_SENT.value / MP_LM_STEPS,
           "digests": leaf_digests(flatten_tree(tr.export_params()))}
    del tr
    torch.cuda.empty_cache()
    return out


def mp_lm_legs(local: int) -> dict:
    """Every leg of `MP_LM_LEGS` over a 4-shard mesh of card 0, `local`
    shards in this process (every process builds every mesh, in order)."""
    import torch

    from deeplearning4j_tpu_torch.parallel import make_mesh

    out = {}
    for name, kind, shape, layers in MP_LM_LEGS:
        mesh = make_mesh(shape, MP_LM_AXES[kind],
                         devices=[torch.device("cuda", 0)] * local)
        out[name] = mp_lm_leg(kind, shape, layers, mesh)
        out[name]["want"] = mp_lm_want(kind, shape, layers,
                                       mesh.local_shards())
    return out


def mp_write(out_dir: str, name: str, rec: dict, arrays: dict) -> None:
    import os

    np.savez(os.path.join(out_dir, f"{name}.npz"), **arrays)
    with open(os.path.join(out_dir, f"{name}.json"), "w") as f:
        json.dump(rec, f)


def mp_read(out_dir: str, name: str) -> tuple:
    import os

    with open(os.path.join(out_dir, f"{name}.json")) as f:
        rec = json.load(f)
    with np.load(os.path.join(out_dir, f"{name}.npz")) as z:
        return rec, {k: z[k] for k in z.files}


def multiproc_worker(spec: dict) -> int:
    """One process of the multiproc phase's jobs (``chip_smoke.py
    --multiproc-worker SPEC``).  "gloo": process `rank` of 2 on card 0
    (NCCL refuses two ranks on one card), 2 shards each: ZeRO-1 (with
    the checkpoint), replicated, local SGD, Word2Vec NEG, then the save
    in which process 1 is killed after its params file.  "nccl": one
    process, an NCCL group of world size 1 over 4 shards: the
    collectives against their one-process forms, and ZeRO-1.  "lm":
    process `rank` of 2 (gloo) on card 0, 2 shards each: the LM mesh
    trainers' legs (`MP_LM_LEGS`)."""
    import os
    import signal

    import torch
    import torch.distributed as dist

    from deeplearning4j_tpu_torch.parallel import mesh as mesh_lib
    from deeplearning4j_tpu_torch.runtime import checkpoint as ck
    from deeplearning4j_tpu_torch.runtime.launcher import (
        initialize_multihost,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    rank, out_dir = int(spec["rank"]), spec["out"]
    t0 = time.perf_counter()
    if spec["mode"] == "lm":
        info = initialize_multihost(spec["address"], MP_PROCS, rank,
                                    backend="gloo", device="cuda:0",
                                    timeout_s=MP_GROUP_TIMEOUT_S)
        rec = {"info": info, "legs": mp_lm_legs(MP_LOCAL)}
        rec["worker_s"] = time.perf_counter() - t0
        mp_write(out_dir, f"lm{rank}", rec, {})
        dist.destroy_process_group()
        return 0
    if spec["mode"] == "nccl":
        info = initialize_multihost(spec["address"], 1, 0, device="cuda:0",
                                    timeout_s=MP_GROUP_TIMEOUT_S)
        mesh = mp_mesh(DP_SHARDS)
        gen = torch.Generator(device="cuda").manual_seed(0)
        xs = [torch.randn(4096, device="cuda", generator=gen)
              for _ in range(DP_SHARDS)]
        dev = torch.device("cuda", 0)
        devs = mesh.local_devices()
        checks = {
            "psum": torch.equal(mesh_lib.psum(xs, dev, mesh),
                                mesh_lib.psum(xs, dev)),
            "pmean": torch.equal(mesh_lib.pmean(xs, dev, mesh),
                                 mesh_lib.pmean(xs, dev)),
            "psum_scatter": all(torch.equal(a, b) for a, b in zip(
                mesh_lib.psum_scatter(xs, devs, mesh),
                mesh_lib.psum_scatter(xs, devs))),
            "all_gather": torch.equal(mesh_lib.all_gather(xs, dev, mesh),
                                      mesh_lib.all_gather(xs, dev))}
        _, rec, arrays = mp_train_leg(mesh, dp_char_batches(4))
        rec.update(info=info, backend=dist.get_backend(),
                   host_staged=mesh._host_staged, collectives=checks,
                   worker_s=time.perf_counter() - t0)
        mp_write(out_dir, "nccl", rec, arrays)
        dist.destroy_process_group()
        return 0
    info = initialize_multihost(spec["address"], MP_PROCS, rank,
                                backend="gloo", device="cuda:0",
                                timeout_s=MP_GROUP_TIMEOUT_S)
    mesh = mp_mesh(MP_LOCAL)
    batches = dp_char_batches(4)
    rec = {"info": info, "local_shards": mesh.local_shards(),
           "backend": dist.get_backend(), "host_staged": mesh._host_staged}
    arrays = {}
    net, rec["zero1"], arr = mp_train_leg(mesh, batches, ckpt=spec["ckpt"])
    arrays.update({"zero1/" + k: v for k, v in arr.items()})
    _, rec["replicated"], arr = mp_train_leg(mesh, batches,
                                             shard_update=False)
    arrays.update({"replicated/" + k: v for k, v in arr.items()})
    _, rec["local_sgd"], arr = mp_train_leg(mesh, batches, 2 * MP_SYNC,
                                            sync_every=MP_SYNC)
    arrays.update({"local_sgd/" + k: v for k, v in arr.items()})
    rec["w2v"], arr = mp_w2v(mesh)
    arrays.update({"w2v/" + k: v for k, v in arr.items()})
    rec["worker_s"] = time.perf_counter() - t0
    mp_write(out_dir, f"rank{rank}", rec, arrays)
    # the killed save: process 1 dies right after writing its params file
    if rank == 1:
        def die(phase, path):
            if phase == "shard:params.proc00001.npz":
                os.kill(os.getpid(), signal.SIGKILL)
        ck.set_phase_hook(die)
    t1 = time.perf_counter()
    try:
        ck.save_checkpoint(spec["ckpt"], MP_KILLED_AT, net.params,
                           updater_state=net.updater_state)
        kill = {"save": "returned"}
    except RuntimeError as e:
        kill = {"save": str(e)}
    kill["s"] = time.perf_counter() - t1
    mp_write(out_dir, f"rank{rank}_kill", kill, {})
    sys.stdout.flush()
    os._exit(0)   # the group lost a member: no teardown


def mp_spawn(out_dir: str, mode: str, n: int, extra: dict) -> list:
    """`n` worker processes of `mode` (``chip_smoke.py --multiproc-worker``)
    on a free local port, their output in ``out_dir``; their exit codes.
    A job past `MP_JOB_S` is killed and fails the phase."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    port = free_base_port(1)
    procs = []
    for rank in range(n):
        spec = dict(extra, mode=mode, rank=rank, out=out_dir,
                    address=f"127.0.0.1:{port}")
        with open(os.path.join(out_dir, f"{mode}{rank}.log"), "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--multiproc-worker", json.dumps(spec)],
                cwd=os.path.dirname(os.path.abspath(__file__)),
                stdout=log, stderr=subprocess.STDOUT))
    deadline = time.monotonic() + MP_JOB_S
    try:
        for p in procs:
            p.wait(timeout=max(0.1, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"multiproc: the {mode} job passed its "
                             f"{MP_JOB_S} s deadline:\n"
                             + mp_logs(out_dir)) from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs]


def mp_logs(out_dir: str) -> str:
    import glob
    import os

    return "\n".join(f"--- {os.path.basename(p)}\n"
                     + open(p).read()[-4000:]
                     for p in sorted(glob.glob(os.path.join(out_dir,
                                                            "*.log"))))


def mp_lm_phase(out_dir: str) -> dict:
    """The LM legs by 2 gloo processes of 2 shards of card 0, then the
    same legs in this process over ``[cuda:0] * 4`` and the one-device
    step on the same configs: every process's losses and leaves bitwise
    this process's, each process's launches its own block pairs' and the
    two adding up to this process's."""
    import torch

    from deeplearning4j_tpu_torch.parallel.transformer import numpy_params

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    rcs = mp_spawn(out_dir, "lm", MP_PROCS, {})
    job_s = time.perf_counter() - t0
    if rcs != [0] * MP_PROCS:
        raise AssertionError(f"multiproc lm: job exit codes {rcs}\n"
                             + mp_logs(out_dir))
    procs = [mp_read(out_dir, f"lm{r}")[0] for r in range(MP_PROCS)]
    one = mp_lm_legs(DP_SHARDS)
    out = {"job_s": job_s, "config": "gpt2_small width (vocab 50304, d "
           "768, 12 heads x 64, d_ff 3072, tied, attention biases), bf16 "
           "compute, f32 masters, adam lr 3e-4, ZeRO-1",
           "global_batch": [MP_LM_B, TRAIN_SEQ], "steps": MP_LM_STEPS,
           "worker_s": [p["worker_s"] for p in procs]}
    bad = []
    for name, kind, shape, layers in MP_LM_LEGS:
        ref = one[name]
        cfg = mp_lm_config(kind, layers)
        dev = OneDeviceLM(cfg, numpy_params(cfg, seed=0))
        tokens, targets = mesh_batch(cfg, MP_LM_B)
        ms = []
        for _ in range(MP_LM_STEPS):
            ts = time.perf_counter()
            dev.fit_batch(tokens, targets)
            ms.append((time.perf_counter() - ts) * 1e3)
        del dev
        torch.cuda.empty_cache()
        leg = {"mesh": list(shape), "layers": layers,
               "losses": ref["losses"],
               "one_process_step_ms_mean": ref["step_ms_mean"],
               "one_device_step_ms_mean": float(np.mean(ms[1:])),
               "one_process_launches_per_step": ref["launches_per_step"],
               "want_one_process": ref["want"]}
        total = {k: 0.0 for k in ref["launches_per_step"]}
        for r, rec in enumerate(procs):
            mine = rec["legs"][name]
            for k, v in mine["launches_per_step"].items():
                total[k] += v
            leg[f"process_{r}"] = {
                "losses_equal": mine["losses"] == ref["losses"],
                "leaves_bitwise": mine["digests"] == ref["digests"],
                "leaves": len(mine["digests"]),
                "step_ms_mean": mine["step_ms_mean"],
                "launches_per_step": mine["launches_per_step"],
                "want": mine["want"],
                "bytes_sent_per_step": mine["bytes_sent_per_step"]}
            p = leg[f"process_{r}"]
            if not (p["losses_equal"] and p["leaves_bitwise"]
                    and p["launches_per_step"] == p["want"]):
                bad.append(f"{name} process {r}: {p}")
        leg["launches_summed"] = total
        if not (total == ref["launches_per_step"] == ref["want"]
                and all(math.isfinite(v) for v in ref["losses"])):
            bad.append(f"{name}: one process {ref['launches_per_step']}, "
                       f"want {ref['want']}, summed {total}, losses "
                       f"{ref['losses']}")
        out[name] = leg
    if bad:
        raise AssertionError("multiproc lm: " + "; ".join(bad))
    return out


def multiproc_phase(card: str) -> dict:
    """Phase 27 (the module docstring): the dp phase's char-LSTM trained
    by 2 processes of 2 shards of card 0 (gloo) against one process of
    4 shards bitwise, their checkpoint, a killed process, Word2Vec NEG,
    and an NCCL group of one process."""
    import os
    import shutil
    import tempfile

    import torch

    from deeplearning4j_tpu_torch.models import MultiLayerNetwork, char_lstm
    from deeplearning4j_tpu_torch.parallel import DataParallelTrainer
    from deeplearning4j_tpu_torch.runtime.checkpoint import (
        latest_checkpoint,
        load_checkpoint,
    )

    t_phase = time.perf_counter()
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    tmp = tempfile.mkdtemp(prefix="chip-smoke-mp-")
    ckpt = os.path.join(tmp, "ckpt")
    out = {"card": card, "processes": MP_PROCS, "shards": DP_SHARDS,
           "shards_a_process": MP_LOCAL, "backend": "gloo",
           "config": "char_lstm(vocab 80, hidden 256), bf16 compute, f32 "
                     "masters, adam lr 0.01",
           "global_batch": DP_B, "shard_batch": DP_B // DP_SHARDS,
           "steps": MP_STEPS}
    try:
        t0 = time.perf_counter()
        rcs = mp_spawn(os.path.join(tmp, "gloo"), "gloo", MP_PROCS,
                       {"ckpt": ckpt})
        out["gloo_job_s"] = time.perf_counter() - t0
        if rcs != [0, -9]:
            raise AssertionError(f"multiproc: gloo job exit codes {rcs} "
                                 f"(want [0, -9]: process 1 is killed)\n"
                                 + mp_logs(os.path.join(tmp, "gloo")))
        procs = [mp_read(os.path.join(tmp, "gloo"), f"rank{r}")
                 for r in range(MP_PROCS)]
        kill = mp_read(os.path.join(tmp, "gloo"), "rank0_kill")[0]
        t0 = time.perf_counter()
        rcs = mp_spawn(os.path.join(tmp, "nccl"), "nccl", 1, {})
        out["nccl_job_s"] = time.perf_counter() - t0
        if rcs != [0]:
            raise AssertionError(f"multiproc: nccl job exit code {rcs}\n"
                                 + mp_logs(os.path.join(tmp, "nccl")))
        nccl = mp_read(os.path.join(tmp, "nccl"), "nccl")

        # the same runs in this process over 4 shards, and one device
        mesh = mp_mesh(DP_SHARDS)
        batches = dp_char_batches(4)
        ref = {}
        for name, kw, steps in (
                ("zero1", {}, MP_STEPS),
                ("replicated", {"shard_update": False}, MP_STEPS),
                ("local_sgd", {"sync_every": MP_SYNC}, 2 * MP_SYNC)):
            _, rec, arr = mp_train_leg(mesh, batches, steps, **kw)
            ref[name] = (rec, arr)
        one = MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()
        one_ms = []
        for i in range(MP_STEPS):
            t0 = time.perf_counter()
            one.fit_batch(*batches[i % len(batches)])
            one_ms.append((time.perf_counter() - t0) * 1e3)
        del one
        out["info"] = [p[0]["info"] for p in procs]
        out["local_shards"] = [p[0]["local_shards"] for p in procs]

        # 1. training: each process = the one-process run, bitwise
        for name in ("zero1", "replicated", "local_sgd"):
            rrec, rarr = ref[name]
            leg = {"one_process_losses": rrec["losses"],
                   "one_process_step_ms_mean": rrec["step_ms_mean"],
                   "one_process_b5": rrec["b5"]}
            for r, (rec, arr) in enumerate(procs):
                mine = {k[len(name) + 1:]: v for k, v in arr.items()
                        if k.startswith(name + "/")
                        and not k.startswith(name + "/saved_")}
                leg[f"process_{r}"] = {
                    "losses_equal": rec[name]["losses"] == rrec["losses"],
                    "trees": arrays_compare(mine, {
                        k: v for k, v in rarr.items()
                        if not k.startswith("saved_")}),
                    "b5": rec[name]["b5"],
                    "step_ms_mean": rec[name]["step_ms_mean"]}
            out[name] = leg
        out["b5_per_process_expected"] = MP_LOCAL * MP_STEPS
        out["zero1_vs_replicated"] = arrays_compare(
            ref["zero1"][1], ref["replicated"][1])
        out["scaling_report"] = procs[0][0]["zero1"]["scaling_report"]
        out["one_device_step_ms_mean"] = float(np.mean(one_ms[1:]))
        bad = [f"{name} process {r}" for name in ("zero1", "replicated",
                                                  "local_sgd")
               for r in range(MP_PROCS)
               if not (out[name][f"process_{r}"]["losses_equal"]
                       and out[name][f"process_{r}"]["trees"]["bitwise"])]
        if bad:
            raise AssertionError(f"multiproc: not bitwise the one-process "
                                 f"run: {bad}: {out}")
        if not out["zero1_vs_replicated"]["bitwise"]:
            raise AssertionError(f"multiproc: ZeRO-1 vs replicated: "
                                 f"{out['zero1_vs_replicated']}")
        launches = [p[0][name]["b5"] for p in procs
                    for name in ("zero1", "replicated")]
        if launches != [MP_LOCAL * MP_STEPS] * (2 * MP_PROCS):
            raise AssertionError(f"multiproc: B5 launches {launches}, want "
                                 f"{MP_LOCAL * MP_STEPS} a process and leg")
        losses = out["zero1"]["one_process_losses"]
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"multiproc: losses {losses}")

        # 2. the checkpoint: the layout, a reload, the resume, the kill
        step_dir = os.path.join(ckpt, f"ckpt-{MP_CKPT_AT}")
        files = sorted(os.listdir(step_dir))
        with open(os.path.join(step_dir, "meta.json")) as f:
            meta = json.load(f)
        net = MultiLayerNetwork(char_lstm(compute_dtype="bfloat16")).init()
        tr = DataParallelTrainer(net, mesh=mesh)
        like = tr._updater.init(net.params)
        step, params, upd, _ = load_checkpoint(ckpt, net.params, like,
                                               step=MP_CKPT_AT)
        saved = {k[len("zero1/"):]: v for k, v in procs[0][1].items()
                 if k.startswith("zero1/saved_")}
        reload = arrays_compare(
            {**host_arrays(params, "saved_params/"),
             **host_arrays(upd, "saved_updater/")}, saved)
        resumed_at = tr.resume(ckpt)
        res_losses = [tr.fit_batch(*batches[i % len(batches)])
                      for i in range(MP_CKPT_AT, MP_STEPS)]
        tr.finalize()
        resume = arrays_compare(
            {**host_arrays(net.params, "params/"),
             **host_arrays(net.updater_state, "updater/")},
            {k: v for k, v in ref["zero1"][1].items()
             if not k.startswith("saved_")})
        latest = latest_checkpoint(ckpt)
        out["checkpoint"] = {
            "files": files, "processes": meta["processes"],
            "reload": dict(reload, step=step),
            "resume_one_process": dict(
                resume, step=resumed_at,
                losses_equal=res_losses
                == ref["zero1"][0]["losses"][MP_CKPT_AT:]),
            "killed_save": kill,
            "killed_step_files": sorted(os.listdir(os.path.join(
                ckpt, f"ckpt-{MP_KILLED_AT}"))),
            "latest": latest.name if latest else None}
        c = out["checkpoint"]
        want_files = ["COMMIT", "meta.json"] + sorted(
            f"{t}.proc0000{r}.npz" for t in ("params", "updater")
            for r in range(MP_PROCS))
        if not (files == want_files and meta["processes"] == MP_PROCS
                and reload["bitwise"] and step == MP_CKPT_AT
                and resume["bitwise"] and resumed_at == MP_CKPT_AT
                and c["resume_one_process"]["losses_equal"]):
            raise AssertionError(f"multiproc: checkpoint {c}")
        if not ("barrier 'ckpt-99-written' failed" in kill["save"]
                and kill["s"] < MP_GROUP_TIMEOUT_S + 30
                and "COMMIT" not in c["killed_step_files"]
                and "params.proc00001.npz" in c["killed_step_files"]
                and c["latest"] == f"ckpt-{MP_CKPT_AT}"):
            raise AssertionError(f"multiproc: the killed save {c}")

        # 3. Word2Vec NEG: the processes' replicas bitwise equal, each
        # run's step within the a-priori bound
        one_w2v = mp_w2v(mesh)
        out["w2v_neg"] = mp_w2v_check(
            [(p[0]["w2v"], {k[4:]: v for k, v in p[1].items()
                            if k.startswith("w2v/")}) for p in procs]
            + [one_w2v])
        w2v = out["w2v_neg"]
        if not (w2v["worst_ratio"] <= 1.0 and w2v["replicas_bitwise"]
                and all(w2v[k]["same_pairs"] for k in
                        ("process_0", "process_1", "one_process"))):
            raise AssertionError(f"multiproc: Word2Vec NEG {w2v}")

        # 4. NCCL, one process: the collectives and ZeRO-1
        nrec, narr = nccl
        out["nccl"] = {
            "info": nrec["info"], "backend": nrec["backend"],
            "host_staged": nrec["host_staged"],
            "collectives": nrec["collectives"], "b5": nrec["b5"],
            "losses_equal": nrec["losses"] == ref["zero1"][0]["losses"],
            "trees": arrays_compare(narr, {
                k: v for k, v in ref["zero1"][1].items()
                if not k.startswith("saved_")}),
            "step_ms_mean": nrec["step_ms_mean"],
            "worker_s": nrec["worker_s"]}
        n = out["nccl"]
        if not (n["backend"] == "nccl" and not n["host_staged"]
                and all(n["collectives"].values())
                and n["b5"] == DP_SHARDS * MP_STEPS and n["losses_equal"]
                and n["trees"]["bitwise"]):
            raise AssertionError(f"multiproc: NCCL world size 1 {n}")
        out["worker_s"] = [p[0]["worker_s"] for p in procs]

        # 5. the LM mesh trainers: each process = one process, bitwise
        out["lm"] = mp_lm_phase(os.path.join(tmp, "lm"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.backends.cuda.matmul.allow_tf32 = tf32
    z = out["zero1"]
    log(f"multiproc: char-LSTM bf16, 2 processes x 2 shards of card 0 "
        f"(gloo) = 1 process x 4 shards bitwise (ZeRO-1, replicated, local "
        f"SGD); B5 {[z[f'process_{r}']['b5'] for r in range(MP_PROCS)]} "
        f"launches a process in {MP_STEPS} steps; step ms: 2 processes "
        f"{z['process_0']['step_ms_mean']:.3f} / "
        f"{z['process_1']['step_ms_mean']:.3f}, 1 process x 4 shards "
        f"{z['one_process_step_ms_mean']:.3f}, one device "
        f"{out['one_device_step_ms_mean']:.3f}, NCCL 1 process x 4 shards "
        f"{out['nccl']['step_ms_mean']:.3f} ({card})")
    log(f"multiproc: checkpoint {out['checkpoint']['files']} reloaded and "
        f"resumed at 1 process bitwise; the killed save left "
        f"{out['checkpoint']['killed_step_files']} and latest "
        f"{out['checkpoint']['latest']}; Word2Vec NEG replicas bitwise "
        f"{out['w2v_neg']['replicas_bitwise']}, worst error / bound "
        f"{out['w2v_neg']['worst_ratio']:.3g}, one process's fit "
        f"{out['w2v_neg']['fit_max_abs_diff']['one_process_vs_process_0']:.3g}"
        f" from theirs; NCCL collectives "
        f"{out['nccl']['collectives']}")
    for name, *_ in MP_LM_LEGS:
        leg = out["lm"][name]
        per = [leg[f"process_{r}"] for r in range(MP_PROCS)]
        log(f"multiproc: LM {name} (gpt2_small width, {leg['layers']} "
            f"layers, bf16, Adam ZeRO-1, batch {MP_LM_B} x {TRAIN_SEQ}), 2 "
            f"processes x 2 shards = 1 process x 4 bitwise: losses "
            f"{[round(v, 4) for v in leg['losses']]}; B2 a step "
            f"{[p['launches_per_step']['flash_fwd'] for p in per]} (sum "
            f"{leg['launches_summed']['flash_fwd']}); step ms: 2 processes "
            f"{[round(p['step_ms_mean'], 1) for p in per]}, 1 process x 4 "
            f"shards {leg['one_process_step_ms_mean']:.1f}, one device "
            f"{leg['one_device_step_ms_mean']:.1f}; bytes sent a step "
            f"{[int(p['bytes_sent_per_step']) for p in per]} ({card})")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"multiproc: phase in {out['phase_s']:.1f} s ({card})")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--profile", action="store_true",
                    help="trace the serve load, the timed train and rnn "
                    "steps, the decode phase's speculating and plain "
                    "pools, one more fit of each nlp row, the char-LSTM "
                    "engine's storm, the LM fleet's storm and one "
                    "SST-scale RNTN epoch with "
                    "torch.profiler and print device time by kernel "
                    "(slows them)")
    ap.add_argument("--multiproc-worker", metavar="SPEC",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    phases = [p for p in args.only.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from deeplearning4j_tpu_torch import _build
    except ImportError as e:
        print(f"chip_smoke: the port's package is missing ({e}); run from "
              f"the repository root", file=sys.stderr)
        return 2
    if args.multiproc_worker:
        return multiproc_worker(json.loads(args.multiproc_worker))

    # 1. facts
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    card = card_line()
    log(f"facts: {name}, {count} device(s), nvidia-smi: {card}; torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    built = _build.build()
    log(f"build: {len(built)} kernel librar{'y' if len(built) == 1 else 'ies'}"
        f" in {time.perf_counter() - t0:.1f} s")
    for res in built.values():
        for line in res.log.splitlines():
            if ("ptxas info" in line and ("Used" in line
                                          or "Compiling" in line)) or \
                    "spill" in line:
                log(f"build: {res.name}: {line.strip()}")

    wall: dict = {}

    def run(phase: str, fn, *fargs, **kw):
        """`fn(*fargs, **kw)` when `phase` was asked for, its wall seconds
        logged (None otherwise)."""
        if phase not in phases:
            return None
        t = time.perf_counter()
        out = fn(*fargs, **kw)
        wall[phase] = round(time.perf_counter() - t, 1)
        log(f"{phase}: phase wall {wall[phase]} s")
        return out

    kernels_line = None
    if "kernel" in phases:
        t_phase = time.perf_counter()
        cases = []
        for c, kd in KERNEL_CASES:
            for dt in ("float32", "bfloat16") + (
                    ("float16",) if (c, kd) in KERNEL_F16_CASES else ()):
                case = kernel_case(c, dt, kd)
                cases.append(case)
                plan = case["split_plan"]
                log(f"kernel: C={c} K={kd} {dt} ({case['route']}, "
                    f"{plan['n_splits']} splits of "
                    f"{plan['pages_per_split']} pages, {plan['blocks']} "
                    f"blocks): err {case['max_abs_err']:.3g}, worst lane "
                    f"relative {case['lane_rel_err']:.3g}; device ms: "
                    f"kernel {case['kernel_ms']:.4f}, plain "
                    f"{case['plain_ms']:.4f}, sdpa "
                    f"{case['library_ms']:.4f}, bound "
                    f"{case['bound_ms']:.4f}; per call back to back: "
                    f"kernel {case['call_ms']:.4f}, sdpa "
                    f"{case['library_call_ms']:.4f} ({card})")
                torch.cuda.empty_cache()
        kernels_line = cases
        wall["kernel"] = round(time.perf_counter() - t_phase, 1)
    flash = head256 = None
    if "flash" in phases:
        t_phase = time.perf_counter()
        flash = flash_phase(card)
        head256 = head256_grad_parity()
        wall["flash"] = round(time.perf_counter() - t_phase, 1)
        log(f"flash: head dim 256 transformer, f32 loss and gradients "
            f"through the kernels vs plain attention: loss rel err "
            f"{head256['loss_rel_err']:.3g}, worst gradient "
            f"{head256['grad_worst_leaf']} {head256['grad_max_rel_err']:.3g}")
    tree = None
    if {"serve", "programs", "parity", "decode"} & set(phases):
        from deeplearning4j_tpu_torch.parallel.transformer import (
            gpt2_small,
            numpy_params,
        )

        tree = numpy_params(gpt2_small(max_len=1024), seed=0)
    prof = {"profile": args.profile}
    serve = run("serve", serve_phase, tree, card, **prof)
    programs = run("programs", programs_phase, tree, card)
    parity = run("parity", parity_phase, tree)
    train = run("train", train_phase, card, **prof)
    lstm = run("lstm", lstm_phase, card)
    rnn = run("rnn", rnn_phase, card, **prof)
    decode = run("decode", decode_phase, tree, card, **prof)
    mln = run("mln", mln_phase, card, **prof)
    precision = run("precision", precision_phase, card)
    moe = run("moe", moe_phase, card)
    mobility = run("mobility", mobility_phase, card)
    nlp = run("nlp", nlp_phase, card, **prof)
    ops = run("ops", ops_phase, card)
    classify = run("classify", classify_phase, card, **prof)
    fleet = run("fleet", fleet_phase, card, **prof)
    procfleet = run("procfleet", procfleet_phase, card)
    resilience = run("resilience", resilience_phase, card)
    sentiment = run("sentiment", sentiment_phase, card, **prof)
    cluster = run("cluster", cluster_phase, card)
    tail = run("tail", tail_phase, card)
    scaleout = run("scaleout", scaleout_phase, card)
    dp = run("dp", dp_phase, card)
    mesh = run("mesh", mesh_phase, card, train)
    multiproc = run("multiproc", multiproc_phase, card)
    log(f"phases: wall s {json.dumps(wall)}")

    entries = []
    if kernels_line is not None:
        main_case = next(c for c in kernels_line
                         if c["C"] == 1 and c["dtype"] == "bfloat16")
        chunk_case = next(c for c in kernels_line
                          if c["C"] == 16 and c["dtype"] == "bfloat16")
        launches = serve["kernel_launches"] if serve else 0
        per_dispatch = (launches / serve["dispatches"]
                        if serve and serve["dispatches"] else None)
        entries.append({
            "name": "paged_attention", "route": "cuda",
            "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
            "launches": launches,
            "launches_per_dispatch": per_dispatch,
            "max_abs_err": main_case["max_abs_err"],
            "ms": main_case["kernel_ms"],
            "kernel_ms": main_case["kernel_ms"],
            "call_ms": main_case["call_ms"],
            "plain_ms": main_case["plain_ms"],
            "bound_ms": main_case["bound_ms"],
            "bound_by": main_case["bound_by"],
            "library_ms": main_case["library_ms"],
            "shape": main_case["shape"], "dtype": "bfloat16",
            "redesigned": True, "routes": paged_route_names(),
            "chunk_ms": chunk_case["kernel_ms"],
            "wide_head_ms": {f"C={c['C']} K={c['shape']['K']} {c['dtype']}":
                             {k: c[k] for k in ("route", "kernel_ms",
                                                "plain_ms", "bound_ms",
                                                "library_ms")}
                             for c in kernels_line if c["shape"]["K"] > 256},
            "chunk_library_ms": chunk_case["library_ms"],
            "decode_launches": decode_launches(decode, "paged"),
            "moe_launches": (moe["serve"]["paged_launches_by_width"]
                             if moe else None),
            "mobility_launches": mobility_launches(mobility),
            "ops_launches": (
                {"streams_by_width": ops["streams"]["b1_launches_by_width"],
                 "streams_dispatches_by_width": ops["streams"][
                     "dispatches_by_width"]} if ops else None),
            "fleet_launches": fleet_launches(fleet, "b1_launches_by_width"),
            "procfleet_launches": (
                {n: w["b1_by_width"] for n, w in
                 procfleet["worker_launches"].items()}
                if procfleet else None),
            "tail_launches": (
                {"by_width": tail["serve"]["paged_launches_by_width"],
                 "dispatches_by_width": tail["serve"]["dispatch_widths"]}
                if tail else None),
            "split_plan": main_case["split_plan"],
            "float16": dict(dtype_summary(next(
                c for c in kernels_line
                if c["C"] == 1 and c["dtype"] == "float16")),
                chunk=dtype_summary(next(
                    c for c in kernels_line
                    if c["C"] == 16 and c["dtype"] == "float16"))),
            "cases": kernels_line,
        })
    if flash is not None:
        # the train phase's shape: S = 1024, causal, bf16
        main_case = next(c for c in flash if c["S"] == 1024 and c["causal"]
                         and c["dtype"] == "bfloat16" and c["D"] == FLASH_D)
        wide_case = next(c for c in flash if c["S"] == 1024 and
                         c["D"] == FLASH_WIDE_TIMED)
        f16_case = next(c for c in flash if c["S"] == 1024 and c["causal"]
                        and c["dtype"] == "float16" and c["D"] == FLASH_D)
        err_of = {"flash_fwd": ("out", "lse"), "flash_bwd_dkv": ("dk", "dv"),
                  "flash_bwd_dq": ("dq",)}
        kind_of = {"flash_fwd": "fwd", "flash_bwd_dkv": "dkv",
                   "flash_bwd_dq": "dq"}
        for kname, (replaces, _) in FLASH_KERNELS.items():
            t = main_case["timing"][kname]
            launches = train["launches"][kname] if train else 0
            entries.append({
                "name": kname, "route": "cuda", "source": FLASH_SOURCE,
                "replaces": replaces, "launches": launches,
                "launches_per_step": (launches / train["steps"]
                                      if train else None),
                **({"decode_launches": decode_launches(decode, "flash"),
                    "fleet_launches": fleet_launches(fleet, "b2_launches"),
                    "procfleet_launches": (
                        {n: w["b2"] for n, w in
                         procfleet["worker_launches"].items()}
                        if procfleet else None)}
                   if kname == "flash_fwd" else {}),
                "tail_launches": (tail["train"]["launches"][kname]
                                  if tail else None),
                "mesh_launches": (
                    {"hybrid_per_step":
                     mesh["hybrid"]["launches_per_step"][kname],
                     "pipeline_per_step":
                     mesh["pipeline"]["launches_per_step"][kname],
                     "ring": {f"{r['dtype']} causal {r['causal']}":
                              r["launches"][kname] for r in mesh["ring"]}}
                    if mesh else None),
                "multiproc_launches": (
                    {name: {"per_process_per_step": [
                        multiproc["lm"][name][f"process_{r}"][
                            "launches_per_step"][kname]
                        for r in range(MP_PROCS)],
                        "one_process_per_step": multiproc["lm"][name][
                            "one_process_launches_per_step"][kname]}
                     for name, *_ in MP_LM_LEGS} if multiproc else None),
                "moe_launches": (
                    {"train": moe["launches"][kname],
                     "train_per_step": moe["launches_per_step"][kname],
                     **({"generate_per_call": moe["generate"][
                         "flash_launches"]} if kname == "flash_fwd"
                        else {})} if moe else None),
                "max_abs_err": max(main_case["max_abs_err"][n]
                                   for n in err_of[kname]),
                "max_rel_err": max(main_case["max_rel_err"][n]
                                   for n in err_of[kname]),
                "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
                "call_ms": t["call_ms"],
                "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                "bound_by": t["bound_by"], "library_ms": t["library_ms"],
                "library": ("scaled_dot_product_attention forward"
                            if kname == "flash_fwd" else
                            "scaled_dot_product_attention forward + "
                            "backward"),
                **({} if kname == "flash_fwd" else {
                    "library_bwd_ms": t["library_bwd_ms"],
                    "library_bwd_call_ms": t["library_bwd_call_ms"],
                    "library_bwd": "scaled_dot_product_attention backward "
                                   "alone (autograd.grad on one forward "
                                   "output)",
                    "max_rel_err_bf16_rounded": max(
                        main_case["max_rel_err_bf16_rounded"][n]
                        for n in err_of[kname])}),
                "shape": main_case["shape"], "causal": True,
                "dtype": "bfloat16", "redesigned": True,
                "route_taken": main_case["routes"][kind_of[kname]],
                "routes": {"bfloat16": "tensor_cores (wgmma) for D <= 128 "
                           "with D % 8 == 0, fma for other D <= 128, "
                           "fma_chunks for 128 < D <= 512",
                           "float32": "fma for D <= 128, fma_chunks for "
                           "128 < D <= 512"},
                "head_dim_256": {
                    "route": wide_case["routes"][kind_of[kname]],
                    "shape": wide_case["shape"], "causal": True,
                    **{k: wide_case["timing"][kname][k] for k in (
                        "kernel_ms", "plain_ms", "bound_ms", "bound_by",
                        "library_ms")}},
                "head_dim_256_grad_parity": head256,
                "float16": dict(
                    dtype_summary(f16_case, f16_case["timing"][kname]),
                    route=f16_case["routes"][kind_of[kname]],
                    max_abs_err=max(f16_case["max_abs_err"][n]
                                    for n in err_of[kname]),
                    max_rel_err=max(f16_case["max_rel_err"][n]
                                    for n in err_of[kname]),
                    **({} if kname == "flash_fwd" else {
                        "library_bwd_ms":
                            f16_case["timing"][kname]["library_bwd_ms"]})),
                "cases": [{k: v for k, v in c.items() if k != "timing"}
                          for c in flash],
            })
    if lstm is not None:
        t = lstm["timing"]["bfloat16_train"]          # what fit launches
        entries.append({
            "name": "lstm_forward", "route": "cuda", "source": LSTM_SOURCE,
            "replaces": LSTM_REPLACES,
            "launches": rnn["launches"] if rnn else 0,
            "launches_per_step": rnn["launches_per_step"] if rnn else None,
            "classify_launches": (
                {"char_lstm_engine": classify["char_lstm"]["b5_launches"],
                 "dispatches": classify["char_lstm"]["dispatches"],
                 "warmup": classify["char_lstm"]["warmed"]}
                if classify else None),
            "resilience_launches": (
                {leg: {"b5": resilience[leg]["b5_launches"],
                       "fit_steps": resilience[leg]["fit_steps"]}
                 for leg in ("chaos", "chunked", "rollback")}
                if resilience else None),
            "scaleout_launches": (
                {"b5": scaleout["b5_launches"],
                 "performs": scaleout["performs"]} if scaleout else None),
            "dp_launches": (
                {"b5": dp["launches"], "shards": dp["shards"],
                 "steps": DP_STEPS, "lstm_layers": dp["lstm_layers"]}
                if dp else None),
            "multiproc_launches": (
                {"b5_per_process": {
                    leg: [multiproc[leg][f"process_{r}"]["b5"]
                          for r in range(MP_PROCS)]
                    for leg in ("zero1", "replicated")},
                 "processes": MP_PROCS, "shards_a_process": MP_LOCAL,
                 "steps": MP_STEPS,
                 "nccl_one_process_b5": multiproc["nccl"]["b5"]}
                if multiproc else None),
            "max_abs_err": max(lstm["worst_abs_err"].values()),
            "max_rel_err": lstm["worst_rel_err"],
            "ms": t["kernel_ms"], "kernel_ms": t["kernel_ms"],
            "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "kernel_route": t["route"],
            "cluster": lstm["plan"]["bfloat16"]["cluster"],
            "step_us": t["step_us"], "bound_step_us": t["bound_step_us"],
            "redesigned": True, "library": LSTM_LIBRARY,
            "shape": dict(T=LSTM_T, B=LSTM_B, H=LSTM_H), "dtype": "bfloat16",
            "residuals": True, "timing": lstm["timing"],
            "grad_rel_err": lstm["grad_rel_err"], "cases": lstm["cases"],
            "limits": lstm["limits"], "output_4096": lstm["output_4096"],
            "plan": lstm["plan"],
            "float16": lstm_f16_entry(lstm, precision)})
    if entries:
        print(json.dumps({"kernels": entries, "timing": TIMING_NOTE}),
              flush=True)
    if serve is not None:
        print(json.dumps({"serve": serve}), flush=True)
    if programs is not None:
        print(json.dumps({"programs": programs}), flush=True)
    if parity is not None:
        print(json.dumps({"parity": parity}), flush=True)
    if train is not None:
        print(json.dumps({"train": train}), flush=True)
    if rnn is not None:
        print(json.dumps({"rnn": rnn}), flush=True)
    if decode is not None:
        print(json.dumps({"decode": decode}), flush=True)
    if mln is not None:
        print(json.dumps({"mln": mln}), flush=True)
    if precision is not None:
        print(json.dumps({"precision": precision}), flush=True)
    if moe is not None:
        print(json.dumps({"moe": moe}), flush=True)
    if mobility is not None:
        print(json.dumps({"mobility": mobility}), flush=True)
    if nlp is not None:
        print(json.dumps({"nlp": nlp}), flush=True)
    if ops is not None:
        print(json.dumps({"ops": ops}), flush=True)
    if classify is not None:
        print(json.dumps({"classify": classify}), flush=True)
    if fleet is not None:
        print(json.dumps({"fleet": fleet}), flush=True)
    if procfleet is not None:
        print(json.dumps({"procfleet": procfleet}), flush=True)
    if resilience is not None:
        print(json.dumps({"resilience": resilience}), flush=True)
    if sentiment is not None:
        print(json.dumps({"sentiment": sentiment}), flush=True)
    if cluster is not None:
        print(json.dumps({"cluster": cluster}), flush=True)
    if tail is not None:
        print(json.dumps({"tail": tail}), flush=True)
    if scaleout is not None:
        print(json.dumps({"scaleout": scaleout}), flush=True)
    if dp is not None:
        print(json.dumps({"dp": dp}), flush=True)
    if mesh is not None:
        print(json.dumps({"mesh": mesh}), flush=True)
    if multiproc is not None:
        print(json.dumps({"multiproc": multiproc}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
