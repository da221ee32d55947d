#!/usr/bin/env python3
"""End-to-end check of the PyTorch/CUDA package on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; the script exits non-zero and prints no
result line):

1. probe: torch, the device, ``nvidia-smi`` name and power limit, the
   host libraries the reader needs (pyarrow, cv2 or PIL, fsspec), and what
   decides the host's decode path: the g++ on ``PATH``, whether the native
   ring (``native/ringbuf.cpp``) and the native image decoder
   (``native/imgcodec.cpp``, with or without libdeflate) built and why not,
   the JPEG parity check's verdict, the free bytes of ``/dev/shm`` and the
   cores;
2. build every CUDA kernel of the main path from ``petastorm_tpu_torch/csrc``;
3. hold K1 against its plain PyTorch version on the card, bit for bit, at
   the main path's shapes, at ragged ones and on contiguous views that are
   not 16-byte aligned, and time both with CUDA events (every timing starts
   behind a device sleep, so the host's preparation of a call is not
   counted); then K1's general route (``normalize_u8_strided``) on crops,
   transposes, an NCHW tensor seen as NHWC, 1 and 5 channels and a
   zero-size crop, bit for bit with the launch name checked, and timed on
   the main path's batch cropped to 208x208;
4. the main path at full size: a seeded 2048-row store of 224x224x3 JPEG
   images written with the package's writer, read by ``make_reader``
   (8 decode threads), batched by ``DataLoader(batch_size=256,
   device="cuda")`` and normalised on the card by ``normalize_images``, two
   epochs; launch counts are reset just before and read just after. Then
   the staged bytes of a CUDA loader are held against a CPU loader's;
5. flash attention (K2) against its plain version on the card: the token
   path's shape (2, 8192, 32 heads over 8 kv heads, 128) bf16 causal in
   its "out" and "lse" modes on the tensor-core route, then ragged,
   cross-length, non-causal, MHA, f32, f16 and head-dim cases on whichever
   route ``ops.flash_attn.fwd_route`` gives them (logged, launch counts
   checked), q/k/v as views of one fused tensor (read in place), each held
   to an absolute bar and to bars scaled to each output row; deliberately
   wrong attentions made from the plain version must fail those bars on
   the long rows; the FMA route forced at the token path's shape, held to
   the same bars; equal bits over two launches; both routes in both modes,
   the plain version and PyTorch's ``scaled_dot_product_attention``
   (yardstick only) timed with CUDA events, in turns;
6. the token path at full width: a seeded store of 12 windows of 8192
   tokens written by ``write_token_store``, read as dense NGram windows by
   ``make_reader`` (8 threads, ``num_epochs=None``), batched by
   ``DataLoader(batch_size=2, device="cuda")``, and the next-token loss of
   ``LlamaConfig()`` at full width (4 of its 32 layers, seeded random
   weights, bf16 compute) with ``make_flash_attention(causal=True)``, one
   warm-up and four steps under ``torch.inference_mode()``; launch counts
   are reset just before and read just after. Then the breakdown by layer,
   and one batch's logits held against the same forward on the plain
   attention, with the wrong attentions (and one of zeros) as controls
   that the bar must reject;
7. the flash backward (K3: dq, K4: dk and dv) against the plain backward on
   the card: the token path's shape bf16 causal on the tensor-core route,
   held to bars scaled to each query row (dq) and key row (dk, dv), with
   deliberately wrong backwards made from the plain version
   (``BWD_CONTROLS``) that the bars must reject, and two launches giving
   equal bits; the FMA route forced at the same inputs, held to the same
   bars; then short cases on whichever route they take (logged, and checked
   against the launch counts): ragged, cross-length both ways, non-causal,
   MHA, rep 4, f32, f16, d 32/64/72/128 on tensor cores, d 60 and 256 and
   f32 on FMAs, q/k/v as strided views of one fused tensor, also held to
   absolute bars; K3 and K4 of both routes, the plain backward and the
   backward of PyTorch's ``scaled_dot_product_attention`` (yardstick only)
   timed with CUDA events, in turns;
8. the training path at full width: ``run_llm_bench`` on a seeded
   ``write_token_store`` store (window 8192) with ``LlamaConfig()`` at full
   width cut to 4 layers, batch 2, flash attention, one warm-up step, four
   timed steps and two resident ones; launch counts are reset just before
   and read just after (the tensor-core K2, K3 and K4 once per layer per
   step; the FMA routes and the plain versions never). Then one step with ``remat_layers`` and ``xent_chunk``
   against the plain step, a ``torch.profiler`` split of one resident
   step, and the whole-slice gradient check: every parameter's gradient
   through the kernels against the plain forward and backward, with the
   wrong backwards as controls;
9. the image path's end to end: ``run_imagenet_bench`` (ResNet-50 at
   224x224, SGD, batch 256, 8 decode threads, 20 pipelined steps and 5
   resident ones) on a 2048-row ``write_synthetic_imagenet`` store, fed by
   ``make_reader`` -> ``DataLoader(device="cuda")``; its result keys must be
   the JAX bench's, its losses finite, and none of the port's kernels run
   (the bench preprocesses with ``/ 255`` as the reference does). Then a
   ``torch.profiler`` split of one resident step, the peak memory of one
   step with and without ``remat``, and the flagship forward of
   ``petastorm_tpu_torch.entry`` (bf16) against the same forward in float32
   with TF32 off, timed;
10. sequence-parallel Llama training. First K2's "stats" mode (the ring's
   local step: the unnormalised float32 output, the row max m and the
   normaliser l) against its plain version on the card at the ring's block
   (1, 4096, 32 heads over 8 kv heads, 128) bf16, causal (the diagonal
   block) and not (a past block), on the tensor-core route and with the FMA
   route forced, then a ragged and a GQA case on whichever route they take;
   o held to the row-scaled bars, m and l to float32 bars, and wrong stats
   (``STATS_CONTROLS``) must fail them; K3 and K4 as the ring's backward
   launches them (a diagonal and a past block against the global lse of
   the two merged) held to the plain backward with phase 7's bars, which
   ``BWD_CONTROLS`` must fail; both routes, the plain version and
   ``scaled_dot_product_attention`` timed. Then the path:
   ``run_seq_parallel_train`` spawns 2 ranks on ``cuda:0`` (gloo), each
   reading the same windows of 8192 tokens from a ``write_token_store``
   store through the NGram reader and a ``DataLoader`` and training
   ``LlamaConfig()`` at full width (2 of its 32 layers, bf16, AdamW) on its
   4096-token block, 2 steps with ring attention (``local_attn="flash"``:
   K2 "stats", K3, K4), then 2 with Ulysses (K2 "lse", K3, K4); launch
   counts are reset just before and read just after, on every rank. The
   first step's loss and summed gradients are held against one process
   training on the whole window with ``make_flash_attention``, and the two
   strategies against each other;
11. the process path: on phase 4's store, the reader alone with
   ``reader_pool_type="thread"`` and ``"process"`` at 8 and 4 workers
   (rows/s, the ring, the workers' start-up, and how many images each
   decoder took, which must be what the probe predicts); the process
   pool's rows equal to the thread pool's as a multiset of (id, sha1 of
   the image), and 64 of them bit-equal to a cv2 decode of their blobs;
   the main path on processes (``make_reader(reader_pool_type="process")``
   -> ``DataLoader(batch_size=256, device="cuda")`` -> ``normalize_images``,
   two epochs, counts reset just before and read just after: K1 launched
   once a batch and nothing else); no worker on the card (``nvidia-smi``
   lists no worker, no worker maps libcuda or libtorch, and a spawned
   worker reports ``CUDA_VISIBLE_DEVICES=""`` and no torch); then
   ``run_imagenet_bench(pool_type="process")`` with phase 9's settings
   beside phase 9's thread run, and ``run_llm_bench(flash=True,
   pool_type="process")`` at ``LlamaConfig()`` width, 2 layers, 2
   pipelined steps (K2 "lse", K3, K4 counted); last, the teardown (no
   worker alive and no ring left in ``/dev/shm`` after ``join()``) and a
   worker killed with SIGKILL mid-epoch, which must make the reader raise
   within 10 s;
12. the columnar path, which launches none of the kernels (the counts are
   reset before the phase and must read nothing after it). On the JAX
   bench's scalar store (``generate_scalar_dataset``: 100,000 rows, 16
   float32 and 4 int64 columns, groups of 2048) ``batched_loader_throughput``
   at the JAX bench's settings (batch 1024, 10 warm-up and 300 timed
   batches, 3 threads or 2 processes) onto the CPU and onto the card; the
   loaders' stager alone on one batch of the scalar, tensor and image paths
   (host time, median of 200); the reader alone (``next_batch``) on both
   pools; and one seeded
   ``InMemBatchedDataLoader`` load served for 3 epochs onto the card, byte
   for byte the batches of the same loader on the CPU. Then the tensor
   bench's schema (``id``, 8 float32 and 2 float32 ``FixedSizeList(64)``
   columns, 552 bytes a row) written as the Spark converter writes it: 4
   files of 262,144 rows, groups of 65,536 rows (36.2 MB), 579 MB in all;
   ``make_batch_reader`` on 8 threads and on 8 processes, alone and under
   ``BatchedDataLoader(batch_size=1024, device="cuda")``, plain and with
   ``shuffling_queue_capacity=8192, seed=0``, one epoch each, and an
   ``InMemBatchedDataLoader`` load on 4 processes (whose rings hold less
   than the store) served one seeded epoch onto the card. Every staged
   batch is held on the card against a ``pyarrow.parquet`` read of the
   store gathered by ``id``, bit for bit, and each epoch's ids, sorted,
   must be ``arange(1,048,576)``. On processes every row group must cross
   the ring zero-copy (the claim counters), and no ring record may stay
   pinned once the loader's batches are gone (none is kept past ``join()``);
13. resume, the device cache and the augmentations, on phase 9's store and
   model. Rows are named by their index in the store, found from a
   fingerprint of their pixels. (a) ``make_reader(seed=0, workers_count=1)``
   -> ``DataLoader(device="cuda")`` -> flip, crop (padding 4) and cutout
   (16) on the card, drawn from a generator seeded ``(0, step)`` -> K1 ->
   ResNet-50's SGD step (cuDNN deterministic): 8 steps uninterrupted; then 3,
   ``CheckpointManager.save(3, loader=...)``, everything dropped, a model
   from another seed restored (its parameters and momenta bit-equal to the
   saved ones) and ``make_reader(resume_state=...)`` for 5 more, whose rows
   must be the uninterrupted steps 4-8 and whose losses must agree within
   ``RESUME_LOSS_REL_BAR``; then on 8 threads and 8 processes a cut after 3
   batches and a resume, which must bring back every row not delivered
   (the rows read again are counted). (b) ``DeviceCachedDataset`` of the
   store (308 MB of uint8 on the card): every row once per epoch, the two
   epochs in different orders, a gathered batch byte-equal to the cached
   rows, then 2 epochs of the same augmentations -> K1 -> the train step,
   timed as phase 9's bench times its steps. K1's launches are counted over
   (a) and (b). (c) each augmentation on the card against the same apply on
   the CPU with the same draws (uint8 bit-equal, mixup within
   ``MIXUP_BAR``), and the chain timed. (d) a ``torch.profiler`` window over
   two loader batches shows the ``petastorm_tpu.host_batch`` and
   ``petastorm_tpu.stage`` spans, and ``loader.metrics`` counts the pass.

14. selection and worker transforms. (a) On phase 9's store:
   ``make_reader(predicate=in_pseudorandom_split([0.75, 0.25], 0, "label"),
   transform_spec=TransformSpec(<center crop to 192x192>, edit_fields=...))``
   on 8 threads, then on 8 processes -> ``DataLoader(batch_size=256,
   device="cuda")`` -> K1 (bf16) -> 4 SGD steps of ResNet-50; launch counts
   reset just before and read just after (K1 once a batch and nothing
   else); K1's output of every batch (the short last one too) bit-equal to
   ``normalize_images_plain`` of the same batch; the rows, as a multiset of
   (label, sha1 of the crop), equal a filter and crop of the store by
   ``pyarrow.parquet``, cv2 and numpy alone; then the rows per second of
   the crop with and without the split, from the call and after the first
   batch. (b) ``build_rowgroup_index`` with a ``SingleFieldIndexer``
   on ``label``, then ``rowgroup_selector=SingleIndexSelector("label_ix",
   [3, 7, 11])``: the rows read are those of the groups whose label column,
   read from the Parquet file, holds one of the labels. (c) On phase 8's
   token store: the dense NGram reader under ``cur_shard`` 0 and 1 of 2
   with ``shard_seed=7``, and under ``rowgroup_subset`` halves: disjoint,
   and together the unsharded reader's windows; shard 0's windows through
   the Llama forward at ``LlamaConfig()`` width (4 layers) on
   ``make_flash_attention(causal=True)``, K2 counted once a layer per
   forward. (d) Phase 12's scalar schema with an int32 ``part`` column
   written with ``partition_by=["part"]``, read by
   ``make_batch_reader(filters=[("part", "in", {1, 3})],
   predicate=in_range("i0", 0, 500), transform_spec=<a pandas column
   total = i0 + f0>)`` -> ``BatchedDataLoader(device="cuda")`` on 3
   threads and 2 processes: byte-equal to the same loader on the CPU (as
   rows, on processes), the rows a numpy filter keeps; the rows per second
   with and without the predicate, from the call and after the first batch.
15. the deterministic epoch plane and the throughput harness. (a) Phase
   9's store read with ``sample_order="deterministic"``,
   ``shuffle_row_groups=True``, ``shuffle_window=4`` and seed 5 ->
   ``DataLoader(batch_size=256, device="cuda")`` -> K1 (bf16) -> ResNet-50's
   SGD step (cuDNN deterministic), 4 steps on 8 processes and 4 on 8
   threads: the rows (named by fingerprint) and labels equal, the losses
   bit-equal; then a run on processes cut at step 2 through
   ``CheckpointManager`` and resumed on threads from the restored cursor
   and state: the uninterrupted run's rows and losses, bit for bit. K1's
   output of every batch is bit-equal to ``normalize_images_plain`` of the
   batch, and K1 is launched once a batch and nothing else. (b) Phase 12's
   tensor store by ``make_batch_reader(sample_order="deterministic")``
   under ``BatchedDataLoader(1024)`` onto the card on 8 processes and 8
   threads: the rows/s from the first batch free, then deterministic,
   on each pool, then one kept
   deterministic epoch a pool, byte-equal across the pools; every group
   zero-copy on processes (beside phase 12's counters). (c) Phase 8's token store and a second one (seed 1), each a
   deterministic dense-NGram reader, mixed 70/30 by
   ``WeightedSamplingReader`` (seed 21) -> ``DataLoader(batch_size=2)`` ->
   ``LlamaConfig()`` at full width, 4 layers, AdamW on K2 "lse", K3 and K4:
   4 steps, then a run cut at step 2 whose input is rebuilt from the
   loader's ``state_dict()`` through ``resume_states()``: the same picks,
   tokens and bit-equal losses; K2, K3 and K4 launched once a layer a step.
   (d) ``python -m petastorm_tpu_torch.benchmark.cli --json`` on the
   reference's 10-row hello-world store at the reference's defaults (printed
   beside BASELINE.md's 709.84 samples/s, unspecified hardware), then on a
   steady-state store of 1,200 rows at 100 a group (its write projected from
   a 200-row probe and logged) with ``-d python`` on threads and on
   processes and with ``-d torch --device-step-ms 50``;
   ``loader_throughput_sweep`` onto the card; the transport sweep from 1 KB
   to 1 MB. Every number is printed beside the card's name and power limit.
16. data-parallel ingestion. (a) ``run_llm_bench(mesh_ingest=True,
   mesh_hosts=4, flash=True)`` on phase 8's token store with phase 8's
   model, batch and steps: every step takes its windows from 4 simulated
   hosts (``MeshDataLoader``), K2, K3 and K4 launched once a layer a step,
   the tokens/s and input stall printed beside phase 8's single reader.
   (b) Phase 12's scalar store through ``MeshDataLoader(batch_size=1000,
   num_hosts=8, pad_last)`` onto the card, host 5 killed after the first
   batch: every row once (rows named by their f0 and f1 bits), each batch
   bit-equal to pyarrow's read, one reshard; again, cut at the first cursor
   that carries ``recovered``, and resumed: no row lost. Phase 8's token
   store through 4 hosts into phase 8's training loop (1 epoch) with host 2
   killed after the first step (its reader waits after its first window
   until then, so the kill lands mid-plan): every window, any read twice in
   host 2's plan, finite losses, K2-K4 once a layer a step. (c) 2 ranks on
   ``cuda:0`` (gloo), each ``run_llm_bench(mesh_ingest=True)`` at phase
   10's width (2 layers), one window of 8192 a rank, 3 steps (launches
   counted); then a data-parallel loop of 2 steps: each rank's windows its
   plan's groups in order, the ranks' losses and parameters bit-equal, the
   first step held against one process on both windows (loss within
   ``DP_LOSS_REL_BAR``, each parameter's update within
   ``DP_UPDATE_REL_BAR``), and a control that leaves out the gradient sum,
   which the update bar must reject; the gloo gradient sum's calls, bytes,
   seconds and share of each step. (d) Phase 4's image store through
   ``MeshDataLoader(batch_size=256, num_hosts=4)`` and K1: 2048 distinct
   rows, 8 launches, bit-equal to ``normalize_images_plain``.
17. the lazy row plane and data-parallel ResNet-50. (a) Phase 4's store
   through ``make_reader(row_materialization="lazy")`` and the eager reader,
   on 8 threads and 8 processes, once each: 2 epochs through
   ``DataLoader(batch_size=256, shuffling_queue_capacity=1024, seed=0)``
   -> K1 (bf16, bit-equal to ``normalize_images_plain`` on every batch, one
   launch a batch) -> phase 9's ResNet-50 SGD step (labels ``id % 100``):
   one warm-up step, 10 pipelined; rows/s from the first batch, samples/s
   and input stall of the pipelined window; both epochs' ids must be every
   row twice; then the host ms a batch of the shuffle and the collate alone,
   eager and lazy, on one epoch replayed from memory. (b) On 2 ranks
   sharing ``cuda:0`` (gloo): ``run_imagenet_bench`` on phase 9's store at
   128 rows a rank (global 256), 4 pipelined and 2 resident steps, with
   the cross-rank batch norm; a 2-step data-parallel loop whose losses,
   parameters and moving statistics must be bit-equal on the ranks, with
   step ms and the gloo seconds of the batch norms and of the gradient sum;
   the loop's first batch stepped in float32 (TF32 off, remat) against one
   process on the ranks' 256 rows within ``DPR_*_REL_BAR``, and a per-rank
   batch norm that must miss them. (c) ``DeviceCachedDataset(sharding=
   data_sharding(mesh))`` of phase 4's store on the same ranks: half the
   bytes each, 2 epochs at batch 256 whose rank slices are the unsharded
   cache's batches bit for bit, K1 bit-equal on every slice.
18. tensor and expert parallelism at Mixtral-8x7B's widths
   (``LlamaConfig()`` with 8 experts, top-2, capacity factor 1.25: layer 0
   dense, layer 1 a switch MoE; 2 of 32 layers), bf16, AdamW, windows of
   8192 tokens of phase 8's store read as phase 10 reads them. First the
   kernels against their plain versions with the row bars at the shapes
   the ranks give them: K2 ("lse"), K3 and K4 at a model rank's (1, 8192,
   16 heads over 4, 128) and a Ulysses rank's (1, 8192, 8 over 2, 128), K2
   "stats" and the ring's K3 and K4 at a ring block (1, 4096, 16 over 4,
   128); then one process on the whole model: 2 bf16 steps on (a)'s
   windows (losses and routing by step), and a float32 AdamW step on the
   first whose update the ranks are held to. (a) 2 ranks on
   ``cuda:0`` (gloo), mesh (1, 1, 2) on ("data", "seq", "model"), each
   with its slice of every split leaf (``llama.shard_params``): 2 steps
   with ``make_flash_attention`` over the rank's heads (launches counted,
   each step's ms and tokens/s, the gloo calls, bytes, seconds and share
   of the step by op, peak memory, tokens per expert, the dropped share
   and the aux loss); the ranks' first loss within ``TP_LOSS_REL_BAR`` of
   one process's, the dropped share and aux of every step within
   ``TP_TREND_*_BAR`` of one process's; then the float32 first step on the ranks, each leaf's
   update within ``TP_UPDATE_REL_BAR`` of one process's and its routing
   within ``TP_ROUTE_BAR``, and a control with the router's gradient left
   partial over the model group, which the update bar must reject. (b) 4
   ranks, mesh (1, 2, 2), the MoE layer alone: one step with ring
   attention (``local_attn="flash"``: K2 "stats", K3, K4) and one with
   Ulysses (K2 "lse", K3, K4), ``head_axis="model"``, each loss within
   ``TP_LOSS_REL_BAR`` of one process's, launches counted; then each
   strategy's float32 gradient (summed over the sequence ranks, no update)
   against one process's, every leaf within ``TP_GRAD_REL_BAR``, and a
   control whose query heads meet the wrong KV heads of their rank, which
   the bar must reject.

19. FSDP, the pipeline and the dry run, at ``LlamaConfig()``'s widths (dense,
   2 of its 32 layers), bf16, AdamW, phase 8's windows of 8192 tokens, on 4
   ranks sharing ``cuda:0`` (gloo). First K2 "stats", K3 and K4 against
   their plain versions at the dry run's per-rank block (2, 32, 4 over 2
   heads, d = 8: the tensor-core route, its tiles' columns 8-63 TMA's zero
   fill), with ``BWD_CONTROLS``; then one process: the bf16 losses over the
   first 8 windows, one bf16 AdamW step's peak memory on one window, and
   the float32 gradient accumulated over the first 4 windows, followed by
   one AdamW step. Then one spawn of 4 ranks: (a) FSDP
   (``param_shardings_fsdp``, ``fsdp_group=``) on mesh (4, 1, 1), one window
   a rank, and with the model axis on (2, 1, 2), two windows a data rank:
   ``FSDP_STEPS`` steps each (launches counted, step ms, tokens/s, the gloo
   calls, bytes and seconds by op and their share of the step, peak memory
   a rank beside the unsharded layout's bytes and the rank's own), the first
   loss within ``TP_LOSS_REL_BAR`` of one process's; then on (4, 1, 1) the
   float32 step, each leaf's update within ``FSDP_UPDATE_REL_BAR``, and a
   gather whose backward does not sum that must miss it. (b) the GPipe
   pipeline (``make_pipeline``, ``stack_stage_params``, ``layers_fn``) on
   (2, 2) of ("pipe", "data"), one layer a stage, 4 microbatches of one
   window a data rank, ``xent_chunk``: the same figures, then the float32
   step on the first 4 windows (2 microbatches a data rank): its gradient
   (every leaf within ``PIPE_GRAD_REL_BAR``) and update, and an output op
   that sums its cotangent over the stages, which must miss the gradient
   bar. Last, ``entry.dryrun_multichip(4)`` on 4 ranks on
   ``cuda:0``, its lines printed and its launches counted.
20. the Spark dataset converter feeding ViT-B/16 (BASELINE config 4), and
   the MNIST MLP (config 2). (a) The converter's cache store written
   directly, as the converter writes one without a JVM, by
   ``examples/torch_spark_to_vit``'s ``build_store_sparkless``: 1,024 rows
   of a uint8 ``FixedSizeList`` image column (224x224x3, class prototypes
   plus noise over 10 labels) and an int32 label, groups of 256 rows
   (38.5 MB), 154 MB; its ``write_dataset_metadata(url, None)`` gives the
   row count for ``SparkDatasetConverter``; ``make_device_loader(batch_size=128,
   num_epochs=None, workers_count=8, shuffle_row_groups=True, seed=0)``
   -> each batch viewed as (128, 224, 224, 3) and normalised by K1 to bf16,
   every batch bit-equal to ``normalize_images_plain`` -> ViT-B/16 at its
   published widths and full depth (``models.vit.VIT_B16``: 12 layers,
   hidden 768, MLP 3072, 12 heads, 86 M parameters, 1000 classes), bf16
   compute on float32 weights, plain SGD at lr 0.05: 2 warm-up steps, 10
   pipelined, 5 resident; launch counts reset just before and read just
   after (K1 once a batch, nothing else). Printed: step ms (pipelined and
   resident), samples/s, input stall, MFU against 989 TFLOP/s with its
   formula, a profiled resident step's idle share and kernel groups, peak
   memory. Checks: the loss finite at every step and the mean of the last
   3 pipelined steps below the first step's; 4 images of the first batch
   through a float32 forward on the card (TF32 off) within
   ``VIT_F32_BAR`` of the same forward on the CPU, and the exact-erf GELU
   and the unbiased variance, each of which must miss it. (b) 10,000
   synthetic MNIST rows (``examples/torch_mnist``'s schema, 1,000 a group)
   through ``make_reader`` -> ``DataLoader(batch_size=128,
   shuffling_queue_capacity=5000)`` -> the MLP's momentum SGD on the card,
   ``MNIST_EPOCHS`` epochs; accuracy above ``MNIST_ACC_BAR``; no kernel.
   (c) One pass of the torch adapter (``petastorm_tpu_torch.pytorch``) over
   (b)'s store with a worker transform adding a bool column: tensors on
   ``cuda:0`` by default, the bool column as uint8.
21. the telemetry plane (``petastorm_tpu_torch.telemetry``). (a) Phase 20's
   converter store -> ``make_device_loader(batch_size=128)`` with spans on
   -> K1 (bit-equal to its plain version on every batch) -> ViT-B/16's
   step, ``PH21_STEPS`` steps synced as ``training_input_stall`` syncs them,
   then one closing delivery: ``stall_report()`` must count one step a
   delivered batch, its delivery wait plus consumer busy time must be
   within ``PH21_WALL_REL_BAR`` of the loop's wall clock, and
   ``stage_breakdown()`` must have the JAX loaders' keys; printed beside
   ``training_input_stall``'s stall of the same steps, with the stage
   split a batch and the critical-path counts; then phase 20's
   ``VIT_PIPELINED`` pipelined steps, the gauge's and the stage split's
   share of them printed beside ``pipelined_window``'s wait. (b) Phase 4's store on 8
   processes in trace mode -> ``DataLoader(256)`` -> K1 -> phase 9's
   ResNet-50 step, one epoch: one ``petastorm_tpu.worker_decode`` span a
   row group, from the workers' pids, must reach the parent, and
   ``export_trace`` must write a Chrome trace with the worker, ``host_batch``
   and ``stage`` spans that reads back as JSON; then phase 20's store on
   processes through ``BatchedDataLoader``: ``transport.zero_copy_batches``
   equal to the ring records delivered. (c) The converter loader alone with
   spans off, on and in trace mode, in turns: samples/s, no bar. (d) A
   50,000-row store of the ``tensor_50k`` schema with its embeddings as
   ``NdarrayCodec`` cells read by ``make_reader`` with the batch decode
   and with one ``np.load`` a cell, in turns: rows/s, and the two decodes
   bit-equal.

The line before the last is a JSON object listing every kernel with its
launches, error, times and bound; the last line is
``{"ok": true, "device": {...}}``.
"""
import collections
import contextlib
import dataclasses
import functools
import gc
import hashlib
import json
import os
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from petastorm_tpu_torch import kernels
from petastorm_tpu_torch.benchmark.imagenet_bench import (pipelined_window, run_imagenet_bench,
                                                          write_synthetic_imagenet)
from petastorm_tpu_torch.benchmark.llm_bench import run_llm_bench, write_token_store
from petastorm_tpu_torch import native
from petastorm_tpu_torch.codecs import CompressedImageCodec, ScalarCodec, native_decode_status
from petastorm_tpu_torch.etl.rowgroup_indexers import SingleFieldIndexer
from petastorm_tpu_torch.etl.rowgroup_indexing import build_rowgroup_index
from petastorm_tpu_torch.etl.writer import materialize_dataset_local
from petastorm_tpu_torch.kernels.build import build
from petastorm_tpu_torch import entry as entry_module
from petastorm_tpu_torch.entry import entry
from petastorm_tpu_torch.loader import DataLoader
from petastorm_tpu_torch.loader import loader as loader_module
from petastorm_tpu_torch.models import llama, mlp, resnet, vit
from petastorm_tpu_torch import pytorch as torch_adapter
from petastorm_tpu_torch.spark.spark_dataset_converter import SparkDatasetConverter
from petastorm_tpu_torch.ngram import NGram
from petastorm_tpu_torch.ops import flash_attn
from petastorm_tpu_torch.ops.flash_attn import (FlashAttentionFunction, flash_attention,
                                                flash_attention_bwd, flash_attention_bwd_plain,
                                                flash_attention_lse, flash_attention_plain,
                                                make_flash_attention)
from petastorm_tpu_torch.ops.image_ops import (KERNEL_NAME, STRIDED_KERNEL_NAME,
                                               normalize_images, normalize_images_plain)
from petastorm_tpu_torch.benchmark.scalar_bench import (batched_loader_throughput,
                                                        generate_scalar_dataset,
                                                        generate_tensor_dataset)
from petastorm_tpu_torch.benchmark.dummy_reader import loader_throughput_sweep
from petastorm_tpu_torch.benchmark.hello_world import generate_hello_world_dataset
from petastorm_tpu_torch.benchmark.transport_bench import run_sweep, to_markdown
from petastorm_tpu_torch.loader import (BatchedDataLoader, CheckpointManager, DeviceCachedDataset,
                                        InMemBatchedDataLoader, MeshDataLoader, MeshReaderFactory)
from petastorm_tpu_torch.benchmark.seq_parallel_bench import token_windows
from petastorm_tpu_torch.parallel import comm, moe
from petastorm_tpu_torch.parallel.launch import run_ranks
from petastorm_tpu_torch.parallel.mesh import make_mesh
from petastorm_tpu_torch.parallel.pipeline import make_pipeline, stack_stage_params
from petastorm_tpu_torch.parallel.ring_attention import make_ring_attention
from petastorm_tpu_torch.parallel.ulysses_attention import make_ulysses_attention
from petastorm_tpu_torch.ops import augment
from petastorm_tpu_torch.predicates import in_pseudorandom_split, in_range
from petastorm_tpu_torch.reader import make_batch_reader, make_reader, shm_free_bytes
from petastorm_tpu_torch.selectors import SingleIndexSelector
from petastorm_tpu_torch.test_util.stub_workers import EnvironmentWorker
from petastorm_tpu_torch.test_util.transforms import add_sum_column, center_crop
from petastorm_tpu_torch.transform import TransformSpec
from petastorm_tpu_torch.unischema import Unischema, UnischemaField
from petastorm_tpu_torch.weighted_sampling_reader import WeightedSamplingReader
from petastorm_tpu_torch.workers_pool import EmptyResultError
from petastorm_tpu_torch.workers_pool.process_pool import ProcessPool

#: H100 SXM device-memory rate, float32 (non-tensor-core) and bf16
#: tensor-core dense peaks.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12

ROWS, ROWS_PER_GROUP, BATCH, EPOCHS, WORKERS = 2048, 64, 256, 2, 8
IMAGE_SHAPE = (224, 224, 3)
TIMING_REPS = 50
#: Device clock cycles of the sleep each timing starts behind (about 2 ms
#: at the H100's 1.98 GHz boost clock).
SLEEP_CYCLES = 4_000_000

# Token path: the JAX package's llm_bench settings at LlamaConfig() width,
# depth cut from 32 layers to 4 to fit the run's time.
WINDOW, TOKEN_WINDOWS, TOKEN_BATCH, TOKEN_STEPS, TOKEN_WORKERS = 8192, 12, 2, 4, 8
LLAMA = llama.LlamaConfig(n_layers=4)
FLASH_REPS = 5   # repetitions at the token path's shape (about 0.1-0.5 s a call)
#: Kernel vs plain version on the card: two bars, both held at every case.
#: Absolute: the JAX package's flash bars (f32 2e-5, bf16 3e-2) and, for
#: f16, whose mantissa has 3 more bits than bf16's, 3e-2 / 8 rounded up; lse
#: (float32 in every mode) 2e-5. They suit rows of a few hundred keys, whose
#: outputs are about 0.1-1.
FLASH_BARS = {torch.float32: 2e-5, torch.bfloat16: 3e-2, torch.float16: 4e-3}
LSE_BAR = 2e-5
#: Scaled to each output row (one query of one head). With q, k, v drawn
#: from N(0, 1) a row that sees n keys has outputs of about sqrt(e / n),
#: 0.018 at n = 8192: under the absolute bf16 bar. So each element must also
#: meet |err| <= eps |want| + worst * rms(row of want), eps being the output
#: type's relative spacing (one rounding step either way), and the root mean
#: square of err / rms(row) over all elements must stay under rms: it sees an
#: error common to many rows (a normaliser 1 % off) that one rounding step
#: hides. (eps, worst, rms) per type; the controls below must fail them.
ROW_BARS = {torch.bfloat16: (2 ** -7, 2 ** -5, 2 ** -7),
            torch.float16: (2 ** -10, 2 ** -8, 2 ** -10),
            torch.float32: (2 ** -23, 2 ** -16, 2 ** -18)}
#: Deliberately wrong attentions, built from the plain version: bugs a
#: kernel could have. The bars must reject the first three at the token
#: path's shape on its long rows alone (rows from WINDOW // 2 on, which see
#: 4097-8192 keys). The last differs from the plain version by less than
#: the output's rounding (the kernel's own p roundings differ from the plain
#: version's, since it rounds exp(s - running max)); it is shown, not judged.
CONTROLS = ("last K/V tile skipped", "1 key in 32 dropped", "normaliser 1 % off",
            "p kept in float32")
MUST_FAIL = CONTROLS[:3]
#: One batch's logits through the kernel vs through the plain attention:
#: mean |difference| over mean |logit|. The compute is bf16, so a last-bit
#: difference in one layer's attention moves later roundings. On an H100
#: the kernel read 1.21 % and the nearest control, "normaliser 1 % off",
#: 2.08 %; the bar lies between them. The other controls and an attention
#: of zeros read 17-133 %.
LOGITS_MEAN_REL_BAR = 0.016
SLICE_MUST_FAIL = ("zero attention",) + MUST_FAIL

# Flash backward (K3, K4) against the plain backward. Absolute bars at the
# short cases: the JAX package's gradient bar in float32 (2e-4) and its flash
# bars in 16 bits (bf16 3e-2, f16 4e-3), each plus one rounding step of the
# value (gradients reach about 10, where one bf16 step is 0.0625). Every case
# is also held to the row-scaled bars of ROW_BARS, a row being one query of
# one head for dq and one key of one kv head for dk and dv. A row's scale is
# at least GRAD_ROW_FLOOR of the whole gradient's rms: a row whose gradient
# cancels to about zero (query 0 of a causal head, whose only key gives
# dp = D) holds rounding noise alone, judged against the tensor's scale.
GRAD_ROW_FLOOR = 2 ** -7
BWD_ABS_BARS = {torch.float32: 2e-4, torch.bfloat16: 3e-2, torch.float16: 4e-3}
#: Deliberately wrong backwards, made by giving the plain backward altered
#: inputs; the bars must reject each at the token path's shape. On an H100
#: the tensor-core kernels read, at that shape, row-scaled worst 0.0073 and
#: rms 0.00038 (dv; the FMA route, whose sums run in the plain version's
#: order, 8.7e-6 and 9.1e-5); the nearest control, "p 1 % low", read worst
#: 0.042 and rms 0.0105, outside the bf16 bars (0.031, 0.0078); the others
#: read rms 0.047-27.
BWD_CONTROLS = ("D left out", "GQA sum over the first head of each group only",
                "last q tile skipped in dK/dV", "lse + ln 1.01 (p 1 % low)")
BWD_MUST_FAIL = BWD_CONTROLS
# Training path: LlamaConfig() at full width, 4 layers, as phase 6.
TRAIN_STEPS, TRAIN_RESIDENT, XENT_CHUNK = 4, 2, 2048
#: Whole-slice gradient check: per parameter leaf, |g - g_plain| / |g_plain|
#: (Euclidean norms) against the gradients through the plain forward and
#: backward, the largest over the leaves. The controls run the plain forward
#: with a wrong backward, so they are held, like for like, against the
#: kernel backward on the plain forward: on an H100 that read 0.89 % (0.83 %
#: on the FMA route) and the nearest control, "p 1 % low", 1.94 %;
#: GRAD_BWD_REL_BAR lies between and every control must exceed it. The
#: whole path on the kernels (K2's bf16 roundings differ from the plain
#: forward's, and the bf16 model carries them into every gradient) read
#: 2.05 % and the nearest control it must reject, "last q tile skipped",
#: 8.07 %; GRAD_REL_BAR lies between. "p 1 % low" moves the gradients by
#: less than K2's roundings do and is shown, not judged, at that bar.
GRAD_REL_BAR = 0.04
GRAD_BWD_REL_BAR = 0.013
GRAD_MUST_FAIL = BWD_CONTROLS[:3]

# Image path: the JAX package's ImageNet bench at ResNet-50's full width
# (224x224, 1000 -> 100 classes as the bench's default), batch 256; the
# store is cut to 2048 rows so it is written inside the run.
IMAGENET_ROWS, IMAGENET_CLASSES, IMAGENET_BATCH = 2048, 100, 256
IMAGENET_STEPS, IMAGENET_RESIDENT, IMAGENET_WORKERS = 20, 5, 8
#: The JAX bench's result keys on a device with a known peak.
IMAGENET_KEYS = {"samples_per_sec", "samples_per_sec_per_chip", "input_stall_pct", "devices",
                 "global_batch", "echo", "loss_first", "loss_last", "step_time_ms",
                 "device_kind", "step_time_ms_resident", "samples_per_sec_resident",
                 "samples_per_sec_per_chip_resident", "model_flops_per_step_per_chip",
                 "achieved_tflops_per_chip", "mfu_pct", "peak_flops_source",
                 "achieved_tflops_per_chip_resident", "mfu_pct_resident"}
#: The flagship forward in bf16 against itself in float32 (TF32 off): mean
#: |difference| over mean |logit|. On the CPU the port read 0.36 % on the
#: reference's weights and 0.49 % on its own (the JAX package's own bf16
#: forward 0.37 %); tests/test_torch_imagenet_bench.py.
ENTRY_F32_BAR = 0.01

# Sequence parallelism (phase 10): LlamaConfig() at full width, 2 of its 32
# layers, the token path's window over 2 ranks on one card; 2 steps a
# strategy (cut from 3 for the whole run's time).
SEQ_RANKS, SEQ_STEPS = 2, 2
SEQ_LLAMA = llama.LlamaConfig(n_layers=2)
SEQ_BLOCK = WINDOW // SEQ_RANKS
SEQ_WATCH = ("layers.0.wq", "layers.0.wk", "layers.0.wo", "embed")
#: K2 "stats" against its plain version: o by ROW_BARS of its inputs' type
#: (o is float32, but p is rounded to bf16 before p v), m absolute and l
#: relative. On an H100 the kernels read m 2.4e-6 and l 2.4e-6 at the ring's
#: block (the FMA route 0 and 5.5e-7); every control reads 1e-2 or more.
STATS_M_BAR, STATS_L_REL_BAR = 2e-5, 2e-5
STATS_CONTROLS = ("m left in units of log2", "normaliser l 1 % off", "last K/V tile skipped",
                  "1 key in 32 dropped", "o divided by l")
#: The sequence-parallel step's first loss against one process on the whole
#: window: |difference| / loss, both in bf16 compute (the ring merges its
#: blocks' partials in float32, one process takes the whole row at once).
SEQ_LOSS_REL_BAR = 2e-3

# The process path (phase 11): phase 4's store and batch, phase 9's bench
# settings, the token bench at LlamaConfig() width cut to 2 layers and 2
# pipelined steps.
PROCESS_WORKERS = (8, 4)
PROCESS_LLAMA = llama.LlamaConfig(n_layers=2)
PROCESS_TRAIN_STEPS = 2
PARITY_ROWS = 64
KILL_BAR_S = 10.0

# The columnar path (phase 12): the JAX bench's scalar store and
# batched_loader_throughput settings (bench.py:291-361), and its tensor_50k
# schema (bench.py:343-352) at the Spark converter's layout: files above its
# 50 MB median, groups near its 32 MB default, one epoch shard of 2^20 rows.
SCALAR_BENCH = dict(batch_size=1024, warmup_batches=10, measure_batches=300)
SCALAR_WORKERS = {"thread": 3, "process": 2}
SCALAR_ROW_BYTES = 16 * 4 + 4 * 8
INMEM_EPOCHS, INMEM_SEED = 3, 0
TENSOR_ROWS, TENSOR_FILES, TENSOR_GROUP, TENSOR_LIST = 1 << 20, 4, 1 << 16, 64
COLUMNAR_WORKERS, COLUMNAR_BATCH = 8, 1024
COLUMNAR_SHUFFLE = dict(shuffling_queue_capacity=8192, seed=0)
# The in-memory load of the tensor store runs on 4 processes: the store
# (579 MB) is larger than their rings (4 x 128 MiB), so a load that kept its
# groups pinned in the rings would stall.
INMEM_WORKERS = 4

# Resume, device cache, augmentation (phase 13): phase 9's store, model and
# batch (ResNet-50, bf16, SGD at lr 0.05, 256 rows: one epoch is 8 steps and
# every batch ends on a 64-row group), the CIFAR/ImageNet recipe on the card.
RESUME_STEPS, RESUME_CUT, RESUME_WORKERS = 8, 3, 8
AUG_PADDING, CUTOUT_SIZE, MIXUP_ALPHA = 4, 16, 0.2
CACHE_EPOCHS, CACHE_RESIDENT = 2, 5
#: The resumed run's losses against the uninterrupted run's, |difference| /
#: loss, on bit-equal parameters and the same rows (cuDNN deterministic). On
#: an H100 the 8 losses came out bit-equal; the bar leaves room for one
#: stray rounding, far below the 2-4 % a step moves the loss.
RESUME_LOSS_REL_BAR = 1e-5
#: mixup on the card against the CPU, given the same draws: float32, the
#: same three operations with one rounding each.
MIXUP_BAR = 1e-6

# Selection and worker transforms (phase 14): phase 9's store, model and
# batch cut to a 192x192 center crop and a 75 % split by label; phase 8's
# token store in two shards; phase 12's scalar schema in 4 hive partitions.
SELECT_FRACTIONS, SELECT_CROP, SELECT_STEPS, SELECT_WORKERS = [0.75, 0.25], 192, 4, 8
SELECT_LABELS, SELECT_SHARD_SEED = [3, 7, 11], 7
SELECT_PARTS, SELECT_KEEP_PARTS, SELECT_I0 = 4, {1, 3}, (0, 500)
SELECT_SCALAR_ROWS = 25_000

# The deterministic epoch plane and the throughput harness (phase 15): phase
# 9's store and ResNet-50 read in plan order with a window of 4 groups;
# phase 12's tensor store; phase 8's token store and a second one mixed 70/30
# under Llama training at the token path's width; the reference's
# hello-world store at the CLI's defaults and at a steady-state size (the
# JAX docstring's 10,000 rows cut to 1,200 to keep the whole run inside its
# time: the CLI measures 1,000 rows after 200 of warm-up either way).
DET_SEED, DET_WINDOW, DET_STEPS, DET_CUT = 5, 4, 4, 2
MIX_PROBS, MIX_SEED, MIX_STEPS, MIX_CUT = (0.7, 0.3), 21, 4, 2
HELLO_ROWS, HELLO_GROUP = 1_200, 100
#: BASELINE.md's hello-world rate of the reference (unspecified hardware),
#: printed beside the port's and not compared with it.
BASELINE_HELLO_RATE = 709.84
DEVICE_STEP_MS = 50

# Data-parallel ingestion (phase 16): phase 8's token store, model and steps
# through 4 simulated hosts; phase 12's scalar store through 8 hosts; 2
# data-parallel ranks on cuda:0 at phase 10's width; phase 4's image store.
MESH_HOSTS, MESH_TOKEN_KILL = 4, 2
MESH_SCALAR_BATCH, MESH_SCALAR_HOSTS, MESH_SCALAR_KILL = 1000, 8, 5
DP_RANKS, DP_STEPS, DP_BENCH_STEPS = 2, 2, 2
DP_LLAMA = llama.LlamaConfig(n_layers=2)
#: The data-parallel step (each rank its own window, gradients summed over
#: gloo) against one process stepping on both windows, bf16 compute: the loss
#: within DP_LOSS_REL_BAR relative (SEQ_LOSS_REL_BAR's bar), and every
#: parameter leaf's update within DP_UPDATE_REL_BAR, |p_dp - p_one| /
#: |p_one - p_0|. AdamW's first update is about lr * sign(g), so the second
#: reads 2 sqrt(f) for a share f of elements whose gradient changes sign:
#: the ranks' bf16 gradients summed in float32 against one bf16 gradient
#: flip those whose two halves cancel; a step on one rank's window alone
#: (the control: no gradient sum) flips about a quarter, near 1.
DP_LOSS_REL_BAR, DP_UPDATE_REL_BAR = 2e-3, 0.3
# The lazy row plane and data-parallel ResNet-50 (phase 17): phase 4's store
# and batch through lazy and eager readers on both pools, in turns; phase 9's
# model and store on 2 ranks sharing cuda:0, 128 rows a rank (global batch
# 256); the sharded device cache of phase 4's store on the same ranks.
LAZY_SHUFFLE, LAZY_TURNS, LAZY_STEPS = 1024, 1, 10
LAZY_POOLS = ("thread", "process")
DPR_RANKS, DPR_STEPS, DPR_RESIDENT, DPR_LOOP = 2, 4, 2, 2
CACHE_DP_EPOCHS = 2
#: The data-parallel step's first update against one process on the same
#: 256 rows and weights, in float32 with TF32 off (bf16 roundings would be
#: of the size of the control's difference): the loss within
#: DPR_LOSS_REL_BAR relative, and every parameter leaf's update within
#: DPR_UPDATE_REL_BAR, |p_dp - p_one| / |p_one - p_0| (Euclidean norms).
#: A per-rank batch norm (the control: statistics of 128 rows, not 256)
#: must miss them. The update bar was 2e-3 before the first card run, which
#: expected 1e-5 from summation order alone; an H100 read 0.028 on the
#: largest leaf (loss 1.0e-7) and the control 1.64 (smallest leaf 0.0018),
#: so float32 noise in leaves whose gradient nearly cancels is far above
#: the expectation. The bar now lies between the two, and the log shows one
#: process's update on the same rows in another order (summation order
#: alone) beside them.
DPR_LOSS_REL_BAR, DPR_UPDATE_REL_BAR = 1e-4, 0.2
# Tensor and expert parallelism (phase 18): LlamaConfig()'s widths, those of
# Mixtral-8x7B (hidden 4096, SwiGLU 14336, 32 heads over 8 kv heads, vocab
# 32000, 8 experts, top-2), 2 of its 32 layers (layer 0 dense, layer 1 a
# switch MoE), bf16, AdamW, the token path's window, on 2 model ranks
# sharing cuda:0; the composition with sequence parallelism on 4 ranks cut
# to the MoE layer alone (4 ranks' slices and AdamW states of 2 layers do
# not fit one card).
TP_RANKS, TP_STEPS = 2, 2
TP_LLAMA = llama.LlamaConfig(n_layers=2, n_experts=8, moe_every=2, moe_dispatch="switch",
                             moe_top_k=2, moe_capacity_factor=1.25)
TP_COMPOSE = dataclasses.replace(TP_LLAMA, n_layers=1, moe_every=1)
TP_COMPOSE_MESH = (1, 2, 2)
#: The ranks' first bf16 loss against one process on the same window and
#: weights (SEQ_LOSS_REL_BAR's bar: the partial sums are added in another
#: order, and a token whose two best experts are that close may route
#: otherwise). The float32 first step: each leaf's update within
#: TP_UPDATE_REL_BAR, |p_tp - p_one| / |p_one - p_0| (phase 17's bar: an
#: AdamW first update is about lr * sign(g), so leaves whose gradient nearly
#: cancels flip), which the control, the router's gradient left partial over
#: the model group, must miss; its routing within TP_ROUTE_BAR of the
#: assignments (top_k per token) of one process's.
TP_LOSS_REL_BAR, TP_UPDATE_REL_BAR, TP_ROUTE_BAR = 2e-3, 0.2, 0.005
#: The ranks' routing over TP_STEPS float32 steps against one process's
#: steps on the same windows: the dropped share within TP_TREND_DROP_BAR
#: (absolute) and the aux loss within TP_TREND_AUX_BAR (relative) at every
#: step. The bars were first set on the bf16 steps; an H100 read 0.9 and
#: 1.6 points, 1.5 % and 14 % at steps 1 and 2 there, each side collapsing
#: alike (dropped 10 -> 22 -> 27-29 %) and their difference growing from
#: bf16 roundings of equal size on the first step (loss 1.3e-5 apart), so
#: the bf16 trajectories are logged beside the float32 ones, which the bars
#: hold.
TP_TREND_DROP_BAR, TP_TREND_AUX_BAR = 0.02, 0.05
#: (b)'s float32 gradient on 4 ranks (summed over the sequence ranks, the
#: model ranks' slices joined) against one process's on the same window and
#: weights: every leaf within TP_GRAD_REL_BAR, |g_ranks - g_one| / |g_one|
#: (Euclidean norms; summation order alone should read 1e-6 to 1e-4). A
#: gradient, not an update: AdamW's float32 state of four ranks' slices does
#: not fit the card beside their float32 activations. The control, each
#: query head meeting its rank's next KV head, must miss it.
TP_GRAD_REL_BAR = 1e-2
#: The kernels phase 18 counts.
TP_KERNELS = (flash_attn.KERNEL_NAME, flash_attn.STATS_KERNEL_NAME,
              flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME,
              flash_attn.FMA_KERNEL_NAME, flash_attn.STATS_FMA_KERNEL_NAME,
              flash_attn.BWD_DQ_FMA_KERNEL_NAME, flash_attn.BWD_DKV_FMA_KERNEL_NAME)
# FSDP and the pipeline (phase 19): LlamaConfig()'s widths (dense, 2 of its
# 32 layers), bf16, AdamW, phase 8's windows of 8192 tokens, 4 ranks sharing
# cuda:0. FSDP on (4, 1, 1) and with Megatron's axis on (2, 1, 2) of
# ("data", "seq", "model"), both on the store's first 4 windows (one a data
# rank, or two); the pipeline on (2, 2) of ("pipe", "data"), one layer a
# stage, 4 microbatches of one window a data rank (the first 8 windows).
# The float32 checks run on the first 4 windows: the pipeline's with 2
# microbatches a data rank (a float32 step at this width takes 4-6 s a rank
# on the card's float32 units, shared by the 4 ranks).
FSDP_LLAMA = llama.LlamaConfig(n_layers=2)
FSDP_MESHES = ((4, 1, 1), (2, 1, 2))
FSDP_WINDOWS, PIPE_WINDOWS, PIPE_MESH, PIPE_MICROBATCHES = 4, 8, (2, 2), 4
FSDP_STEPS, PHASE19_XENT_CHUNK = 2, 4096
#: The float32 first step against one process on the same windows and
#: weights (its gradient accumulated window by window, then one AdamW
#: step): each leaf's update within FSDP_UPDATE_REL_BAR, |p_ranks - p_one| /
#: |p_one - p_0| (phase 18's bar: an AdamW first update is about
#: lr * sign(g), so leaves whose gradient nearly cancels flip), and for the
#: pipeline each leaf's gradient within PIPE_GRAD_REL_BAR, |g_ranks - g_one|
#: / |g_one| (phase 18 (b)'s bar: summation order alone reads 1e-6 to 1e-4).
#: AdamW's first update does not see a gradient's scale, so the pipeline's
#: control (its output op summing the cotangent over the 2 stages: twice the
#: gradient) must miss the gradient bar; FSDP's (a gather whose backward
#: keeps the rank's block of its own gradient) must miss the update bar. The
#: first bf16 loss of each run within TP_LOSS_REL_BAR of one process's.
FSDP_UPDATE_REL_BAR, PIPE_GRAD_REL_BAR = 0.2, 1e-2
#: The dry run's per-rank shape: ring-flash blocks of (2, 32, 8/2 heads
#: over 4/2 kv heads, 8) at 4 ranks, d = 8 on the tensor-core route.
DRYRUN_BLOCK = (2, 32, 4, 2, 8)
# The converter -> ViT-B/16 (phase 20, BASELINE config 4): the converter's
# cache store of 1,024 rows in groups of 256 (38.5 MB, near the reference
# converter's 32 MB default), ViT-B/16 at full width and depth, batch 128,
# 8 reader threads, plain SGD at the JAX converter example's lr.
CONV_ROWS, CONV_ROWS_PER_GROUP, CONV_CLASSES = 1024, 256, 10
VIT_BATCH, VIT_WORKERS, VIT_LR = 128, 8, 0.05
VIT_WARMUP, VIT_PIPELINED, VIT_RESIDENT = 2, 10, 5
#: Images of the first batch held in float32, card (TF32 off) against CPU:
#: max |card - CPU| over max |CPU| of the logits within VIT_F32_BAR. On the
#: CPU, ViT-B/16's float32 forward is 9.5e-7 from its float64 one
#: (summation order alone), while the exact-erf GELU moves the logits by
#: 2.0e-4 and the unbiased variance by 1.1e-3 (4 such images, seed 0): the
#: bar sits between them.
VIT_F32_ROWS, VIT_F32_BAR = 4, 2e-5
#: Kernel groups of a profiled ViT step.
VIT_GROUPS = (("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
              ("softmax", ("softmax",)),
              ("layer norm", ("layer_norm", "layernorm")),
              ("GELU", ("gelu",)),
              ("elementwise (casts, adds, SGD)", ("elementwise", "vectorized", "unrolled",
                                                  "foreach", "copy")))
# The MNIST MLP (phase 20 (b), BASELINE config 2): the example's store and
# loop; examples/mnist asserts accuracy above 0.9 after 3 epochs.
MNIST_ROWS, MNIST_BATCH, MNIST_EPOCHS, MNIST_ACC_BAR = 10_000, 128, 2, 0.9
# The telemetry plane (phase 21). (a) phase 20's converter -> K1 -> ViT-B/16
# with spans on, PH21_STEPS steps each synced as training_input_stall syncs
# them; (b) phase 4's store on 8 processes in trace mode into K1 and phase
# 9's ResNet-50 step, one epoch, then phase 20's store on PH21_BATCH_WORKERS
# processes through BatchedDataLoader (zero-copy); (c) the converter loader
# alone, spans off / on / trace mode, PH21_OVH_TURNS turns of
# PH21_OVH_BATCHES batches; (d) a store of the tensor_50k schema with its two
# embeddings as NdarrayCodec cells (50,000 rows, groups of 2,048), read by
# make_reader on PH21_DECODE_WORKERS threads with the batch decode and with
# per-cell np.load, PH21_DECODE_TURNS turns each.
PH21_STEPS = 8
PH21_BATCH_WORKERS = 4
PH21_OVH_TURNS, PH21_OVH_BATCHES = 2, 16
PH21_DECODE_ROWS, PH21_DECODE_GROUP, PH21_DECODE_WORKERS, PH21_DECODE_TURNS = \
    50_000, 2048, 8, 2
#: The JAX loaders' stage_breakdown() keys (petastorm_tpu/jax/loader.py:880-887).
JAX_STAGE_KEYS = {"decode_s", "pool_queue_s", "shuffle_s", "host_wait_s", "stage_s",
                  "device_put_wait_s"}
#: delivery_wait_s + consumer_busy_s against the loop's wall clock.
PH21_WALL_REL_BAR = 0.05
#: The bench's result keys without a resident phase or a device peak, and
#: the mesh keys it adds.
LLM_KEYS = {"tokens_per_sec", "input_stall_pct", "step_time_ms", "tokens_per_step", "echo",
            "dense", "flash", "xent_chunk", "remat_layers", "window", "devices", "loss_first",
            "loss_last", "device_kind"}
MESH_KEYS = {"mesh_ingest", "mesh_hosts", "mesh_report"}


def log(msg):
    print(msg, flush=True)


def ordered_bits16(t: torch.Tensor) -> torch.Tensor:
    """16-bit float bit patterns mapped to integers that are consecutive
    for consecutive representable values (sign-magnitude -> two's order)."""
    i = t.view(torch.int16).to(torch.int32)
    return torch.where(i < 0, -(i & 0x7FFF), i)


def check_close(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    """Bit-equal in every dtype: the kernel rounds x*scale and then the add
    one at a time, as the plain version does (no contracted FMA). Returns
    the max abs error (0)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    err = (got.float() - want.float()).abs().max().item()
    bits = torch.int32 if got.dtype == torch.float32 else torch.int16
    if not torch.equal(got.view(bits), want.view(bits)):
        ulps = (ordered_bits16(got) - ordered_bits16(want)).abs().max().item() \
            if bits == torch.int16 else None
        raise AssertionError(f"{what}: not bit-equal (max abs error {err}, max {ulps} ulp)")
    return err


def median_ms(*fns, reps=TIMING_REPS, warmup=3) -> list:
    """Median CUDA-event time of each of ``fns``, timed in turns (the order
    alternates every repetition) after ``warmup`` calls of each. Each
    timing starts behind a device sleep of about 2 ms (``SLEEP_CYCLES``),
    during which the host prepares the call, so the time is the device's
    from the call's first kernel on: without it, a call whose host side
    takes longer than its kernels (K1: about 0.2 ms of Python around a
    kernel of tens of microseconds) would be timed by its host side."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for rep in range(reps):
        order = range(len(fns)) if rep % 2 == 0 else reversed(range(len(fns)))
        for i in order:
            start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(SLEEP_CYCLES)
            start.record()
            fns[i]()
            stop.record()
            stop.synchronize()
            times[i].append(start.elapsed_time(stop))
    return [statistics.median(t) for t in times]


def phase_probe() -> str:
    import fsspec  # noqa: F401
    import pyarrow  # noqa: F401
    try:
        import cv2  # noqa: F401
    except ImportError:
        import PIL  # noqa: F401
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"[probe] torch {torch.__version__} cuda {torch.version.cuda} device {name!r}; "
        f"pyarrow {pyarrow.__version__}")
    decode = native_decode_status()
    log(f"[probe] g++ {native.find_cxx()}; native ring "
        f"{'built' if native.ring_available() else 'NOT built: ' + str(native.ring_error())}; "
        f"native image decoder "
        + (f"built ({'with' if decode['libdeflate'] else 'without'} libdeflate)"
           if decode["native_built"] else f"NOT built: {decode['native_error']}")
        + f"; cv2 {decode['cv2']}; JPEG parity {decode['jpeg_parity']}; /dev/shm free "
        f"{shm_free_bytes()} bytes; {os.cpu_count()} cores")
    return smi


def phase_build():
    t0 = time.perf_counter()
    paths = build(["normalize", "flash_attn", "flash_attn_bwd"])
    log(f"[build] {sorted(p.name for p in paths.values())} in "
        f"{time.perf_counter() - t0:.2f} s")


def phase_kernels() -> dict:
    rng = np.random.default_rng(0)
    imagenet = ((0.485, 0.456, 0.406, 0.5), (0.229, 0.224, 0.225, 0.25))
    # x/255 hits these means exactly (0.4 = 102/255, 0.6 = 153/255), so
    # x*scale + bias cancels to about 0: where an FMA would round otherwise.
    cancelling = ((0.4, 0.5, 0.6, 0.7), (0.2, 0.25, 0.3, 0.35))
    # (shape, dtype, factors, offset): a non-zero offset makes the input a
    # contiguous view that many bytes into its allocation, so not 16-byte
    # aligned (the kernel's scalar loop); odd lengths leave a tail that is
    # not a whole 16-byte vector.
    cases = [((BATCH,) + IMAGE_SHAPE, torch.bfloat16, imagenet, 0),
             ((BATCH,) + IMAGE_SHAPE, torch.float32, imagenet, 0),
             ((3, 17, 19, 3), torch.bfloat16, imagenet, 0), ((3, 17, 19, 3), torch.float32, imagenet, 0),
             ((16, 224, 224, 1), torch.bfloat16, imagenet, 0),
             ((16, 64, 64, 4), torch.float16, imagenet, 0),
             ((8,) + IMAGE_SHAPE, torch.bfloat16, cancelling, 0),
             ((5, 33, 31, 3), torch.bfloat16, imagenet, 1),
             ((5, 33, 31, 3), torch.float32, cancelling, 7),
             ((7, 13, 11, 2), torch.float16, imagenet, 0),
             ((8,) + IMAGE_SHAPE, torch.bfloat16, imagenet, 5)]
    result = None
    for shape, dtype, (mean, std), offset in cases:
        flat = rng.integers(0, 256, int(np.prod(shape)) + offset, dtype=np.uint8)
        x = torch.from_numpy(flat).cuda()[offset:].view(shape)
        kernels.reset_launch_counts()
        got = normalize_images(x, mean, std, out_dtype=dtype)
        if kernels.launch_counts != {KERNEL_NAME: 1}:
            raise AssertionError(f"{shape} {dtype}: launches {kernels.launch_counts}")
        want = normalize_images_plain(x, mean, std, out_dtype=dtype)
        torch.cuda.synchronize()
        err = check_close(got, want, f"{shape} {dtype} offset {offset}")
        line = (f"[kernel] {KERNEL_NAME} {shape} {dtype} (data_ptr % 16 = {x.data_ptr() % 16}): "
                f"bit-equal, max abs err {err:.3g}")
        if shape == (BATCH,) + IMAGE_SHAPE and offset == 0:
            n = x.numel()
            out_bytes = torch.empty((), dtype=dtype).element_size()
            bound_ms = max(n * (1 + out_bytes) / HBM_BYTES_PER_S,
                           2 * n / F32_FLOPS) * 1e3
            ms, plain_ms = median_ms(
                lambda: normalize_images(x, mean, std, out_dtype=dtype),
                lambda: normalize_images_plain(x, mean, std, out_dtype=dtype))
            line += (f"; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
                     f"({n * (1 + out_bytes) / 1e6:.1f} MB), kernel at {bound_ms / ms:.1%} of "
                     f"the bound; no single PyTorch call "
                     f"computes this function (library_ms null)")
            if dtype == torch.bfloat16:  # the main path's output type
                result = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms}
        log(line)
    return result, phase_strided()


#: K1's general route: (what, view of a contiguous uint8 batch on the card,
#: channels, out dtype). The batch is (8, 256, 256, 3) unless a view says
#: otherwise.
STRIDED_CASES = [
    ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3, torch.bfloat16),
    ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3, torch.float32),
    ("crop [:, 16:240, 16:240]", lambda x: x[:, 16:240, 16:240], 3, torch.float16),
    ("transpose(1, 2)", lambda x: x.transpose(1, 2), 3, torch.bfloat16),
    ("NCHW and back through a view",
     lambda x: x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), 3, torch.float32),
    ("every other image, odd crop", lambda x: x[::2, 3:250, 5:254], 3, torch.bfloat16),
    ("C = 1, cropped", lambda x: x[..., :1].contiguous()[:, 8:216, 8:216], 1, torch.bfloat16),
    ("C = 5, contiguous", lambda x: x.reshape(-1)[:8 * 100 * 100 * 5].view(8, 100, 100, 5), 5,
     torch.float16),
    ("C = 5, cropped", lambda x: x.reshape(-1)[:8 * 100 * 100 * 5].view(8, 100, 100, 5)[:, 1:99],
     5, torch.bfloat16),
    ("zero-size crop", lambda x: x[:, 5:5], 3, torch.bfloat16),
]
STRIDED_FACTORS = ((0.4, 0.5, 0.6, 0.7, 0.45), (0.2, 0.25, 0.3, 0.35, 0.3))
#: The timed case: the main path's batch cropped to 208x208.
CROP = 208


def phase_strided() -> dict:
    rng = np.random.default_rng(1)
    base = torch.from_numpy(rng.integers(0, 256, (8, 256, 256, 3), dtype=np.uint8)).cuda()
    for what, view, channels, dtype in STRIDED_CASES:
        x = view(base)
        mean, std = (f[:channels] for f in STRIDED_FACTORS)
        kernels.reset_launch_counts()
        got = normalize_images(x, mean, std, out_dtype=dtype)
        counts = dict(kernels.launch_counts)
        want = normalize_images_plain(x, mean, std, out_dtype=dtype).contiguous()
        torch.cuda.synchronize()
        if counts != ({STRIDED_KERNEL_NAME: 1} if x.numel() else {}):
            raise AssertionError(f"{what} {dtype}: launches {counts}")
        if not got.is_contiguous() or got.shape != x.shape:
            raise AssertionError(f"{what} {dtype}: output {tuple(got.shape)} "
                                 f"{got.stride()}, not contiguous of the input's shape")
        err = check_close(got, want, f"{what} {dtype}") if x.numel() else 0.0
        log(f"[kernel] {STRIDED_KERNEL_NAME} {what} {tuple(x.shape)} strides {x.stride()} "
            f"{dtype}: bit-equal, max abs err {err:.3g}, launches {counts}")
    del base
    # The main path's batch, cropped: the general route against the plain
    # version, and the vector route on the uncropped batch beside it.
    full = torch.from_numpy(rng.integers(0, 256, (BATCH,) + IMAGE_SHAPE, dtype=np.uint8)).cuda()
    off = (IMAGE_SHAPE[0] - CROP) // 2
    x = full[:, off:off + CROP, off:off + CROP]
    kernels.reset_launch_counts()
    got = normalize_images(x)
    if kernels.launch_counts != {STRIDED_KERNEL_NAME: 1}:
        raise AssertionError(f"cropped batch: launches {kernels.launch_counts}")
    err = check_close(got, normalize_images_plain(x).contiguous(), "cropped batch")
    ms, plain_ms, contiguous_ms = median_ms(lambda: normalize_images(x),
                                            lambda: normalize_images_plain(x),
                                            lambda: normalize_images(full))
    n = x.numel()
    bound_ms = max(n * 3 / HBM_BYTES_PER_S, 2 * n / F32_FLOPS) * 1e3
    full_bound_ms = full.numel() * 3 / HBM_BYTES_PER_S * 1e3
    log(f"[kernel] {STRIDED_KERNEL_NAME} main path's batch cropped to {tuple(x.shape)} bf16: "
        f"bit-equal; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
        f"({n * 3 / 1e6:.1f} MB), kernel at {bound_ms / ms:.1%} of the bound; the vector "
        f"route on the uncropped batch {contiguous_ms:.4f} ms against its bound "
        f"{full_bound_ms:.4f} ms ({bound_ms / ms:.1%} against {full_bound_ms / contiguous_ms:.1%})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms}


def smooth_image(rng) -> np.ndarray:
    """A seeded natural-ish image: a bilinear blow-up of a coarse random
    grid plus mild noise (pure noise would make JPEG a worst case)."""
    coarse = rng.integers(0, 256, (7, 7, 3)).astype(np.float32)

    def lerp(a, axis, size):
        t = np.linspace(0, a.shape[axis] - 1, size)
        i = np.minimum(t.astype(int), a.shape[axis] - 2)
        f = np.expand_dims(t - i, tuple(range(1, a.ndim - axis)))
        return np.take(a, i, axis) * (1 - f) + np.take(a, i + 1, axis) * f

    img = lerp(lerp(coarse, 0, IMAGE_SHAPE[0]), 1, IMAGE_SHAPE[1])
    img += rng.normal(0, 6, IMAGE_SHAPE)
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_slice(tmp: str) -> int:
    url = f"file://{tmp}/imagenet_like"
    schema = Unischema("ImageNetLike", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False),
        UnischemaField("image", np.uint8, IMAGE_SHAPE, CompressedImageCodec("jpeg", 90), False)])
    rng = np.random.default_rng(1234)
    t0 = time.perf_counter()
    with materialize_dataset_local(url, schema, rows_per_row_group=ROWS_PER_GROUP) as w:
        for i in range(ROWS):
            w.write_row({"id": i, "image": smooth_image(rng)})
    log(f"[slice] wrote {ROWS} rows in {time.perf_counter() - t0:.2f} s")

    # The main path, counted.
    kernels.reset_launch_counts()
    batches = samples = 0
    last = None
    t0 = time.perf_counter()
    with make_reader(url, reader_pool_type="thread", workers_count=WORKERS, seed=0,
                     num_epochs=EPOCHS) as reader:
        for batch in DataLoader(reader, batch_size=BATCH, device="cuda"):
            if not (batch["image"].is_cuda and batch["id"].is_cuda):
                raise AssertionError("a staged batch is not on the card")
            last = normalize_images(batch["image"])
            batches += 1
            samples += batch["image"].shape[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts.get(KERNEL_NAME, 0)
    if set(kernels.launch_counts) != {KERNEL_NAME}:
        raise AssertionError(f"the image path launched {kernels.launch_counts}")
    if batches != ROWS * EPOCHS // BATCH:
        raise AssertionError(f"{batches} batches, expected {ROWS * EPOCHS // BATCH}")
    if launches != batches:
        raise AssertionError(f"{KERNEL_NAME} launched {launches} times for {batches} batches")
    if last.shape != (BATCH,) + IMAGE_SHAPE or last.dtype != torch.bfloat16 \
            or not torch.isfinite(last.float()).all():
        raise AssertionError(f"bad normalised batch {last.shape} {last.dtype}")
    log(f"[slice] {batches} batches, {samples} samples in {wall:.3f} s: "
        f"{samples / wall:.1f} samples/s; {KERNEL_NAME} launches {launches}")

    # Where the time goes: the same read with the layers above taken away
    # one at a time, then the main path again, warm.
    def rows_per_s(what, consume):
        t0 = time.perf_counter()
        with make_reader(url, reader_pool_type="thread", workers_count=WORKERS, seed=0,
                         num_epochs=EPOCHS) as reader:
            rows = consume(reader)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        log(f"[slice] {what}: {rows} rows in {wall:.3f} s: {rows / wall:.1f} rows/s")

    rows_per_s(f"reader alone (read + JPEG decode, {WORKERS} threads)",
               lambda r: sum(1 for _ in r))
    rows_per_s("reader + DataLoader(device='cpu') (collate, no staging)",
               lambda r: sum(len(b["id"]) for b in DataLoader(r, batch_size=BATCH, device="cpu")))
    rows_per_s("main path again, warm (staging + normalize)",
               lambda r: sum(normalize_images(b["image"]).shape[0]
                             for b in DataLoader(r, batch_size=BATCH, device="cuda")))

    # Staged bytes: CUDA loader vs CPU loader on the same deterministic read.
    def first_batch(device):
        with make_reader(url, reader_pool_type="dummy", shuffle_row_groups=False) as reader:
            return next(iter(DataLoader(reader, batch_size=BATCH, device=device)))
    on_card, on_host = first_batch("cuda"), first_batch("cpu")
    for name in ("id", "image"):
        if not torch.equal(on_card[name].cpu(), on_host[name]):
            raise AssertionError(f"staged {name!r} bytes differ between cuda and cpu loaders")
    err = check_close(normalize_images(on_card["image"]).cpu(),
                      normalize_images_plain(on_host["image"]), "slice batch")
    log(f"[slice] staged bytes equal to the CPU loader's; normalised batch within "
        f"1 bf16 ulp of the plain CPU version (max abs err {err:.3g})")
    return launches


def flash_flops_bytes(b, sq, sk, h, kv_h, d, causal, itemsize, with_lse):
    """Operations (4*b*h*d per visible (query, key) pair: two products of
    2 operations each) and bytes (q, k, v read once, o and lse written
    once) of one flash call."""
    if causal:   # query i sees keys 0..min(i, sk-1)
        visible = sum(min(i + 1, sk) for i in range(sq)) if sq != sk else sq * (sq + 1) // 2
    else:
        visible = sq * sk
    flops = 4 * b * h * d * visible
    nbytes = itemsize * (2 * b * sq * h * d + 2 * b * sk * kv_h * d) + (4 * b * h * sq if with_lse else 0)
    return flops, nbytes


def row_scaled_errors(got: torch.Tensor, want: torch.Tensor, floor: float = 0.0, dtype=None):
    """(worst, rms) of ``got - want`` against each output row's scale:
    max (|err| - eps |want|) / rms(row) and sqrt(mean((err / rms(row))^2)).
    With ``floor`` a row's scale is at least that fraction of the whole
    tensor's rms. eps is that of ``dtype`` (default want's)."""
    w = want.float()
    row = w.square().mean(-1, keepdim=True).sqrt().clamp_min(
        max(1e-30, floor * w.square().mean().sqrt().item()))
    err = (got.float() - w).abs()
    worst = ((err - ROW_BARS[dtype or want.dtype][0] * w.abs()) / row).max().item()
    return worst, (err / row).square().mean().sqrt().item()


def flash_verdict(got: torch.Tensor, want: torch.Tensor):
    """-> (max abs err, worst, rms, within every bar)."""
    err = (got.float() - want.float()).abs().max().item()
    worst, rms = row_scaled_errors(got, want)
    _, worst_bar, rms_bar = ROW_BARS[want.dtype]
    return err, worst, rms, err <= FLASH_BARS[want.dtype] and worst <= worst_bar and rms <= rms_bar


def check_flash(gen, b, sq, sk, h, kv_h, d, causal, dtype, what):
    """Kernel ("out" and "lse") against the plain version on the same
    inputs; raises past the stated bars. -> (inputs, plain output, plain
    lse, max abs err)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
    route = flash_attn.fwd_route(dtype, d)
    kernels.reset_launch_counts()
    o_out = flash_attention(q, k, v, causal=causal)
    o, lse = flash_attention_lse(q, k, v, causal=causal)
    counts = dict(kernels.launch_counts)
    want_o, want_lse = flash_attention_plain(q, k, v, causal=causal)
    torch.cuda.synchronize()
    if counts != {flash_attn._FWD_KERNELS[route]: 2}:
        raise AssertionError(f"{what}: route {route!r}, launches {counts}")
    if o.shape != (b, sq, h, d) or o.dtype != dtype or lse.shape != (b, h, sq, 1) \
            or lse.dtype != torch.float32:
        raise AssertionError(f"{what}: o {o.shape} {o.dtype}, lse {lse.shape} {lse.dtype}")
    if not torch.equal(o, o_out):
        raise AssertionError(f"{what}: the 'out' and 'lse' modes give different outputs")
    if not (torch.isfinite(o.float()).all() and torch.isfinite(lse).all()):
        raise AssertionError(f"{what}: non-finite output")
    err, worst, rms, ok = flash_verdict(o, want_o)
    lse_err = (lse - want_lse).abs().max().item()
    _, worst_bar, rms_bar = ROW_BARS[dtype]
    log(f"[flash] {what} [{route}; launches {counts}]: max abs err o {err:.3g} "
        f"(bar {FLASH_BARS[dtype]}), row-scaled worst {worst:.3g} (bar {worst_bar:.3g}) "
        f"rms {rms:.3g} (bar {rms_bar:.3g}); "
        f"lse {lse_err:.3g} (bar {LSE_BAR})")
    if not (ok and lse_err <= LSE_BAR):
        raise AssertionError(f"{what}: the kernel's output is outside a bar")
    return (q, k, v), want_o, want_lse, err


def control_attention(q, k, v, flaw):
    """Causal attention computed as flash_attention_plain computes it, with
    one ``flaw`` of CONTROLS (``None``: none)."""
    b, s, h, d = q.shape
    kv_h = k.shape[2]
    kf = k.float().permute(0, 2, 1, 3)[:, :, None]          # (b, kv_h, 1, s, d)
    vf = v.float().permute(0, 2, 1, 3)[:, :, None]
    o = torch.empty_like(q)
    rows = max(1, flash_attn._PLAIN_SCORE_BYTES // (4 * b * h * s))   # the plain version's blocks
    for q0 in range(0, s, rows):
        q1 = min(s, q0 + rows)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        k_pos = torch.arange(q1, device=q.device)[None, :]
        seen = q_pos >= k_pos
        if flaw == CONTROLS[0]:   # the key loop ends one 64-key tile early
            seen &= (k_pos < q_pos // 64 * 64) | (q_pos < 64)
        elif flaw == CONTROLS[1]:
            seen &= k_pos % 32 != 31
        qc = q[:, q0:q1].float().reshape(b, q1 - q0, kv_h, h // kv_h, d).permute(0, 2, 3, 1, 4)
        sc = torch.matmul(qc, kf[..., :q1, :].transpose(-1, -2)) * flash_attn.softmax_scale(d)
        sc = sc.masked_fill(~seen, float("-inf"))
        p = torch.exp(sc - sc.amax(-1, keepdim=True))
        pv = p if flaw == CONTROLS[3] else p.to(v.dtype).float()
        acc = torch.matmul(pv, vf[..., :q1, :]) / p.sum(-1, keepdim=True)
        if flaw == CONTROLS[2]:
            acc = acc * 1.01
        o[:, q0:q1] = acc.to(q.dtype).permute(0, 3, 1, 2, 4).reshape(b, q1 - q0, h, d)
    return o


def sdpa(q, k, v):
    """PyTorch's fused attention on the same inputs (yardstick only)."""
    return F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                          v.transpose(1, 2), is_causal=True,
                                          enable_gqa=True).transpose(1, 2)


def phase_flash() -> dict:
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are on: the plain version would not be float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    b, h, kv_h, d = TOKEN_BATCH, LLAMA.n_heads, LLAMA.n_kv_heads, LLAMA.head_dim
    (q, k, v), want, want_lse, err = check_flash(
        gen, b, WINDOW, WINDOW, h, kv_h, d, True, torch.bfloat16,
        f"token path ({b}, {WINDOW}, {h}/{kv_h}, {d}) bf16 causal")
    # The bars against wrong outputs, on the long rows alone.
    long = WINDOW // 2
    if not torch.equal(control_attention(q, k, v, None), want):
        raise AssertionError("control_attention without a flaw differs from the plain version")
    for flaw in (None,) + CONTROLS:
        got = flash_attention(q, k, v, causal=True) if flaw is None else \
            control_attention(q, k, v, flaw)
        c_err, c_worst, c_rms, ok = flash_verdict(got[:, long:], want[:, long:])
        name = "kernel" if flaw is None else f"control {flaw!r}"
        log(f"[flash] {name}, rows {long}..{WINDOW - 1}: max abs err {c_err:.3g}, row-scaled "
            f"worst {c_worst:.3g} rms {c_rms:.3g}: {'within the bars' if ok else 'rejected'}"
            f"{'' if c_err > FLASH_BARS[torch.bfloat16] else ' (within the absolute bar)'}")
        if (flaw is None and not ok) or (flaw in MUST_FAIL and ok):
            raise AssertionError(f"{name}: the bars do not tell it from the plain "
                                 f"version")
    for case in [(1, 100, 100, 4, 2, 64, True, torch.bfloat16, "ragged 100x100 d64 causal"),
                 (2, 96, 64, 4, 2, 64, True, torch.bfloat16, "causal sq 96 > sk 64"),
                 (2, 77, 130, 4, 1, 64, False, torch.bfloat16, "non-causal sq 77, sk 130"),
                 (2, 200, 200, 4, 4, 128, True, torch.bfloat16, "h == kv_h"),
                 (2, 300, 300, 8, 2, 64, True, torch.float32, "f32 d64 causal"),
                 (2, 150, 150, 8, 4, 128, False, torch.float16, "f16 non-causal"),
                 (1, 70, 70, 2, 1, 256, True, torch.bfloat16, "d256 causal"),
                 (2, 40, 130, 4, 1, 128, True, torch.bfloat16, "causal sq 40 < sk 130, rep 4"),
                 (1, WINDOW - 37, WINDOW - 37, 8, 2, 128, True, torch.bfloat16,
                  f"ragged {WINDOW - 37} causal (not a multiple of 64)"),
                 (1, 300, 300, 4, 2, 72, True, torch.bfloat16, "bf16 d72 causal"),
                 (1, 300, 300, 4, 2, 32, False, torch.float16, "f16 d32 non-causal"),
                 (1, 130, 130, 4, 2, 60, True, torch.bfloat16, "bf16 d60 causal")]:
        check_flash(gen, *case)
    # Fused qkv views: TMA reads them in place, without a copy.
    qkv = torch.randn(2, 256, 8 + 2 * 2, 128, generator=gen, device="cuda").bfloat16()
    views = (qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:])
    if not all(a is b for a, b in zip(flash_attn._fwd_inputs(flash_attn.TENSOR_CORES, *views), views)):
        raise AssertionError("a fused qkv view was copied on the tensor-core route")
    kernels.reset_launch_counts()
    f_o, f_lse = flash_attention_lse(*views, causal=True)
    f_want, f_want_lse = flash_attention_plain(*views, causal=True)
    f_err, f_worst, f_rms, f_ok = flash_verdict(f_o, f_want)
    f_lse_err = (f_lse - f_want_lse).abs().max().item()
    log(f"[flash] q, k, v strided views of fused qkv [launches {dict(kernels.launch_counts)}]: max "
        f"abs err o {f_err:.3g}, row-scaled worst {f_worst:.3g} rms {f_rms:.3g}; lse {f_lse_err:.3g}")
    if not (f_ok and f_lse_err <= LSE_BAR) or kernels.launch_counts != {flash_attn.KERNEL_NAME: 1}:
        raise AssertionError("fused qkv views: outside a bar or not on the tensor-core route")
    # The FMA route forced at the token path's shape: the same bars.
    fma_o, fma_lse = flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, True)
    fma_err, fma_worst, fma_rms, fma_ok = flash_verdict(fma_o, want)
    fma_lse_err = (fma_lse - want_lse).abs().max().item()
    log(f"[flash] FMA route forced, token path's shape: max abs err o {fma_err:.3g}, row-scaled "
        f"worst {fma_worst:.3g} rms {fma_rms:.3g}; lse {fma_lse_err:.3g}")
    if not (fma_ok and fma_lse_err <= LSE_BAR):
        raise AssertionError("the FMA route forced at the token path's shape: outside a bar")
    again = flash_attention_lse(q, k, v, causal=True)
    first = flash_attention_lse(q, k, v, causal=True)
    torch.cuda.synchronize()
    equal = torch.equal(again[0], first[0]) and torch.equal(again[1], first[1])
    log(f"[flash] two launches give equal bits: {equal}")
    if not equal:
        raise AssertionError("two launches of K2 gave different bits")
    del again, first, fma_o, fma_lse

    # Times at the token path's shape, in turns: both routes in both modes,
    # the plain version and SDPA.
    flops, nbytes = flash_flops_bytes(b, WINDOW, WINDOW, h, kv_h, d, True, 2, with_lse=False)
    bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
    bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
    ms, lse_ms, fma_ms, fma_lse_ms, plain_ms, library_ms = median_ms(
        lambda: flash_attention(q, k, v, causal=True),
        lambda: flash_attention_lse(q, k, v, causal=True),
        lambda: flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, False),
        lambda: flash_attn._flash_fwd(flash_attn.FMA, q, k, v, True, True),
        lambda: flash_attention_plain(q, k, v, causal=True),
        lambda: sdpa(q, k, v), reps=FLASH_REPS, warmup=1)
    log(f"[flash] token path shape: tensor cores {ms:.4f} ms ('lse' mode {lse_ms:.4f} ms), "
        f"{flops / ms / 1e9:.4g} TFLOP/s; FMA route {fma_ms:.4f} ms ('lse' mode {fma_lse_ms:.4f} "
        f"ms), {flops / fma_ms / 1e9:.4g} TFLOP/s; plain {plain_ms:.4f} ms; "
        f"scaled_dot_product_attention {library_ms:.4f} ms; bound {bound_ms:.4f} ms by "
        f"{bound_by} ({flops:.4g} operations, {nbytes / 1e9:.4g} GB)")
    row = {"plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
           "library_ms": library_ms}
    return {"K2": {"max_abs_err": err, "ms": ms, **row},
            "K2 fma": {"max_abs_err": fma_err, "ms": fma_ms, **row}}


#: Kernel groups of a profiled step: (label, substrings of the kernel name).
#: K2's group matches both routes' kernels (flash_fwd_tc_kernel, flash_fwd_kernel).
FORWARD_GROUPS = (("flash_fwd_*kernel (K2)", ("flash_fwd_",)),
                  ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")))
TRAIN_GROUPS = (("flash_fwd_*kernel (K2)", ("flash_fwd_",)),
                ("flash_bwd_dq_*kernel (K3)", ("flash_bwd_dq_",)),
                ("flash_bwd_dkv_*kernel (K4)", ("flash_bwd_dkv_",)),
                ("matmuls (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass")),
                ("AdamW (multi-tensor kernels)", ("multi_tensor_apply", "adam")))


def profile_step(step, what: str, groups=FORWARD_GROUPS, top: int = 6) -> dict:
    """One ``step`` under ``torch.profiler``: device time by kernel (the
    kernels' own events, so nothing is counted twice) against the host
    wall time; the rest of the wall time is the device's idle share.
    Returns ``{group: ms}`` with the wall and busy times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # Kernels only: a user annotation (the optimizer's step range) also
    # carries device time, which would count its kernels twice.
    by_kernel = {e.key: e.self_device_time_total / 1e3 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0
                 and not getattr(e, "is_user_annotation", False)}
    busy_ms = sum(by_kernel.values())
    if busy_ms <= 0:
        raise AssertionError(f"the profiled {what} shows no device time")
    split = {label: 0.0 for label, _ in groups}
    split["everything else"] = 0.0
    for name, ms in by_kernel.items():
        label = next((label for label, tags in groups
                      if any(tag in name.lower() for tag in tags)), "everything else")
        split[label] += ms
    top_kernels = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    log(f"[profile] {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
        f"(idle {100 * (1 - busy_ms / wall_ms):.1f} %), {len(by_kernel)} kernels; by group: "
        + "; ".join(f"{g} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for g, ms in split.items()))
    log(f"[profile] {what}, top kernels: " + "; ".join(
        f"{name[:90]} {ms:.1f} ms ({100 * ms / busy_ms:.1f} %)" for name, ms in top_kernels))
    return dict(split, wall_ms=wall_ms, busy_ms=busy_ms)


def phase_tokens(tmp: str) -> int:
    url = f"file://{tmp}/tokens"
    t0 = time.perf_counter()
    write_token_store(url, windows=TOKEN_WINDOWS, window=WINDOW, vocab=LLAMA.vocab, seed=0)
    log(f"[tokens] wrote {TOKEN_WINDOWS} x {WINDOW} tokens in {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), LLAMA, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for layer in params["layers"] for t in layer.values()) + sum(
        params[k].numel() for k in ("embed", "norm_out", "lm_head"))
    log(f"[tokens] LlamaConfig(n_layers={LLAMA.n_layers}) at full width: {n_params / 1e9:.3f} B "
        f"float32 params in {time.perf_counter() - t0:.2f} s")
    attn_fn = make_flash_attention(causal=True)

    def reader(**kw):
        ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                      timestamp_field="ts", timestamp_overlap=False, dense=True)
        return make_reader(url, schema_fields=ngram, shuffle_row_groups=True, seed=0,
                           workers_count=TOKEN_WORKERS, num_epochs=None, **kw)

    def loss_of(tokens):
        return llama.loss_fn(params, {"tokens": tokens}, LLAMA, attn_fn=attn_fn,
                             compute_dtype=torch.bfloat16, shift="roll")

    def check_batch(batch):
        tok = batch["token"]
        if tok.shape != (TOKEN_BATCH, WINDOW) or tok.dtype != torch.int32 or not tok.is_cuda:
            raise AssertionError(f"staged token batch {tuple(tok.shape)} {tok.dtype} {tok.device}")
        return tok

    # The main path, counted: one warm-up forward, then the timed steps.
    kernels.reset_launch_counts()
    with torch.inference_mode(), reader() as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cuda"))
        warm = loss_of(check_batch(next(it))).item()
        t0 = time.perf_counter()
        losses = [loss_of(check_batch(next(it))) for _ in range(TOKEN_STEPS)]
        losses = [x.item() for x in losses]
        wall = time.perf_counter() - t0
        it.close()
    launches = kernels.launch_counts.get(flash_attn.KERNEL_NAME, 0)
    if kernels.launch_counts != {flash_attn.KERNEL_NAME: LLAMA.n_layers * (1 + TOKEN_STEPS)}:
        raise AssertionError(f"launches {kernels.launch_counts} for {1 + TOKEN_STEPS} forwards "
                             f"of {LLAMA.n_layers} layers: expected the tensor-core K2 alone")
    if not all(np.isfinite([warm] + losses)):
        raise AssertionError(f"non-finite loss: {warm}, {losses}")
    tokens_per_step = TOKEN_BATCH * WINDOW
    log(f"[tokens] {TOKEN_STEPS} steps in {wall:.3f} s: {tokens_per_step * TOKEN_STEPS / wall:.1f} "
        f"tokens/s, step {wall / TOKEN_STEPS * 1e3:.1f} ms; loss warm-up {warm:.4f}, "
        f"steps {[round(x, 4) for x in losses]}; {flash_attn.KERNEL_NAME} launches {launches}")

    # Where the time goes: the reader alone, the reader + the CPU loader,
    # and the forward alone on a resident batch.
    n_windows = 2 * TOKEN_WINDOWS
    t0 = time.perf_counter()
    with reader() as r:
        for _ in range(n_windows):
            next(r)
    wall = time.perf_counter() - t0
    log(f"[tokens] reader alone ({TOKEN_WORKERS} threads, dense NGram): {n_windows} windows in "
        f"{wall:.3f} s: {n_windows / wall:.1f} windows/s")
    t0 = time.perf_counter()
    with reader() as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cpu"))
        for _ in range(n_windows // TOKEN_BATCH):
            next(it)
        it.close()
    wall = time.perf_counter() - t0
    log(f"[tokens] reader + DataLoader(device='cpu'): {n_windows} windows in {wall:.3f} s: "
        f"{n_windows / wall:.1f} windows/s")
    with reader() as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cuda"))
        tokens = check_batch(next(it)).clone()
        it.close()
    with torch.inference_mode():
        times = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss_of(tokens).item()
            times.append(time.perf_counter() - t0)
        fwd = statistics.median(times)
        log(f"[tokens] forward alone on a resident batch (median of 3): {fwd * 1e3:.1f} ms, "
            f"{tokens_per_step / fwd:.1f} tokens/s")
        profile_step(lambda: loss_of(tokens).item(), "resident forward")

        # The slice against itself on plain attention: one batch's logits,
        # and the same forward on wrong attentions to show the bar rejects them.
        def attention(fn):
            fn.supports_gqa = True
            return fn
        want = llama.apply(params, tokens, LLAMA, attn_fn=attention(
            lambda q, k, v: flash_attention_plain(q, k, v, causal=True)[0]))
        scale = want.abs().mean().item()
        controls = {"zero attention": attention(lambda q, k, v: torch.zeros_like(q))}
        controls.update((flaw, attention(lambda q, k, v, flaw=flaw: control_attention(q, k, v, flaw)))
                        for flaw in CONTROLS)
        for name, fn in [("kernel", attn_fn)] + list(controls.items()):
            got = llama.apply(params, tokens, LLAMA, attn_fn=fn)
            if not (torch.isfinite(got).all() and got.shape == (TOKEN_BATCH, WINDOW, LLAMA.vocab)):
                raise AssertionError(f"{name}: bad logits {tuple(got.shape)}")
            rel = (got - want).abs().mean().item() / scale
            ok = rel <= LOGITS_MEAN_REL_BAR
            log(f"[tokens] logits, {name} vs plain attention: mean abs difference {rel:.4%} of "
                f"the mean |logit| {scale:.4g} (bar {LOGITS_MEAN_REL_BAR:.2%}): "
                f"{'within the bar' if ok else 'rejected'}")
            if (name == "kernel" and not ok) or (name in SLICE_MUST_FAIL and ok):
                raise AssertionError(f"logits of {name}: the bar does not hold")
            del got
    return launches


def grad_verdict(got: torch.Tensor, want: torch.Tensor, absolute: bool):
    """-> (max abs err, worst, rms, within every bar) of one gradient; the
    absolute bar (plus one rounding step of the value) only where
    ``absolute``."""
    err = (got.float() - want.float()).abs()
    worst, rms = row_scaled_errors(got, want, GRAD_ROW_FLOOR)
    eps, worst_bar, rms_bar = ROW_BARS[want.dtype]
    ok = worst <= worst_bar and rms <= rms_bar
    if absolute:
        ok = ok and bool((err <= BWD_ABS_BARS[want.dtype] + eps * want.float().abs()).all())
    return err.max().item(), worst, rms, ok


def judge_grads(got, want, absolute: bool, what: str):
    """Log each of (dq, dk, dv) against the plain backward's; -> (max abs
    err of each, within every bar)."""
    readings = [grad_verdict(g, w, absolute) for g, w in zip(got, want)]
    log(f"[bwd] {what}: " + "; ".join(
        f"d{n} max abs {e:.3g} worst {wo:.3g} rms {r:.3g}{'' if ok else ' OUTSIDE'}"
        for n, (e, wo, r, ok) in zip("qkv", readings)))
    return [r[0] for r in readings], all(r[3] for r in readings)


def control_backward(q, k, v, o, lse, do, causal, flaw):
    """The plain backward with one ``flaw`` of BWD_CONTROLS, made by giving
    it altered inputs: o = 0 makes D = rowsum(dO . o) = 0; dO zero on all but
    the first query head of each group leaves dk and dv that head's alone;
    q and dO zero on the last 64 rows take that q tile out of dk and dv;
    lse + ln 1.01 divides every p by 1.01."""
    if flaw == BWD_CONTROLS[0]:
        return flash_attention_bwd_plain(q, k, v, torch.zeros_like(o), lse, do, causal)
    if flaw == BWD_CONTROLS[3]:
        return flash_attention_bwd_plain(q, k, v, o, lse + float(np.log(1.01)), do, causal)
    dq = flash_attention_bwd_plain(q, k, v, o, lse, do, causal)[0]
    if flaw == BWD_CONTROLS[1]:
        rep = q.shape[2] // k.shape[2]
        keep = (torch.arange(q.shape[2], device=q.device) % rep == 0).view(1, 1, -1, 1)
        _, dk, dv = flash_attention_bwd_plain(q, k, v, o, lse, do * keep, causal)
    else:
        sq = q.shape[1]
        keep = (torch.arange(sq, device=q.device) < (sq - 1) // 64 * 64).view(1, -1, 1, 1)
        _, dk, dv = flash_attention_bwd_plain(q * keep, k, v, o, lse, do * keep, causal)
    return dq, dk, dv


def bwd_flops_bytes(b, sq, sk, h, kv_h, d, causal, itemsize, products, kv_outputs):
    """Operations (2*b*h*d per visible (query, key) pair for each of
    ``products`` products) and bytes (q, dO, k, v, lse and D read once, dq
    or dk and dv written once) of one backward kernel."""
    flops = flash_flops_bytes(b, sq, sk, h, kv_h, d, causal, itemsize, False)[0] // 2 * products
    q_side = b * sq * h * d * itemsize
    kv_side = b * sk * kv_h * d * itemsize
    nbytes = 2 * q_side + 2 * kv_side + 8 * b * h * sq + (2 * kv_side if kv_outputs else q_side)
    return flops, nbytes


#: Launch-count names of each backward route: (K3, K4).
BWD_ROUTES = {flash_attn.TENSOR_CORES: (flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME),
              flash_attn.FMA: (flash_attn.BWD_DQ_FMA_KERNEL_NAME, flash_attn.BWD_DKV_FMA_KERNEL_NAME)}
#: Short backward cases: (b, sq, sk, h, kv_h, d, causal, dtype, what, q/k/v
#: as strided views of one fused (b, s, h + 2 kv_h, d) tensor). The route
#: each takes follows from its dtype and d (flash_attn.bwd_route).
BWD_CASES = [(1, 100, 100, 4, 2, 64, True, torch.bfloat16, "ragged 100x100 d64 causal", False),
             (1, 70, 70, 4, 1, 200, True, torch.float32, "ragged d200 causal, rep 4", False),
             (2, 96, 64, 4, 2, 64, True, torch.bfloat16, "causal sq 96 > sk 64", False),
             (2, 40, 130, 4, 1, 64, True, torch.float32, "causal sq 40 < sk 130, rep 4", False),
             (2, 77, 130, 4, 1, 64, False, torch.bfloat16, "non-causal sq 77, sk 130", False),
             (2, 200, 200, 4, 4, 128, True, torch.bfloat16, "MHA (h == kv_h)", False),
             (2, 300, 300, 8, 2, 64, True, torch.float32, "f32 d64 causal, rep 4", False),
             (2, 150, 150, 8, 4, 128, False, torch.float16, "f16 non-causal", False),
             (1, 70, 90, 2, 1, 256, True, torch.bfloat16, "d256 causal", False),
             (1, WINDOW - 37, WINDOW - 37, 8, 2, 128, True, torch.bfloat16,
              f"ragged {WINDOW - 37} causal (not a multiple of 64)", False),
             (2, 300, 200, 8, 2, 128, True, torch.bfloat16, "causal sq 300 > sk 200, d128", False),
             (2, 200, 300, 8, 2, 128, True, torch.bfloat16, "causal sq 200 < sk 300, d128", False),
             (2, 500, 500, 8, 8, 128, True, torch.bfloat16, "MHA d128 causal", False),
             (2, 1000, 1000, 8, 2, 128, True, torch.float16, "f16 d128 causal", False),
             (2, 1000, 1000, 8, 2, 64, True, torch.bfloat16, "bf16 d64 causal", False),
             (1, 300, 300, 4, 2, 72, True, torch.bfloat16, "bf16 d72 causal", False),
             (1, 300, 300, 4, 2, 32, False, torch.float16, "f16 d32 non-causal", False),
             (1, 130, 130, 4, 2, 60, True, torch.bfloat16, "bf16 d60 causal", False),
             (2, 256, 256, 8, 2, 128, True, torch.bfloat16, "q, k, v strided views of fused qkv", True)]


def bwd_launches():
    """Backward launches since the last reset, by route: {route: (K3, K4)}."""
    return {route: tuple(kernels.launch_counts.get(n, 0) for n in names)
            for route, names in BWD_ROUTES.items()}


def phase_flash_bwd():
    gen = torch.Generator(device="cuda").manual_seed(1)
    b, h, kv_h, d = TOKEN_BATCH, LLAMA.n_heads, LLAMA.n_kv_heads, LLAMA.head_dim

    def inputs(b, sq, sk, h, kv_h, d, causal, dtype, strided=False):
        def randn(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)
        if strided:
            qkv = randn(b, sq, h + 2 * kv_h, d)
            q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kv_h], qkv[:, :, h + kv_h:]
        else:
            q, k, v = randn(b, sq, h, d), randn(b, sk, kv_h, d), randn(b, sk, kv_h, d)
        do = randn(b, sq, h, d)
        o, lse = flash_attention_lse(q, k, v, causal=causal)
        return q, k, v, o, lse, do

    def routed(route):
        """The launch counts one flash_attention_bwd call on ``route`` gives."""
        return {r: (1, 1) if r == route else (0, 0) for r in BWD_ROUTES}

    failures = []
    # The token path's shape: row-scaled bars, equal bits, the controls.
    q, k, v, o, lse, do = inputs(b, WINDOW, WINDOW, h, kv_h, d, True, torch.bfloat16)
    route = flash_attn.bwd_route(q.dtype, d)
    kernels.reset_launch_counts()
    got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    counts = bwd_launches()
    again = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
    want = flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True)
    torch.cuda.synchronize()
    if route != flash_attn.TENSOR_CORES or counts != routed(route):
        failures.append(f"token path's shape took route {route!r}, launches {counts}")
    if not all(torch.equal(x, y) for x, y in zip(got, again)):
        failures.append("two launches of K3/K4 gave different bits")
    if not all(torch.isfinite(g.float()).all() for g in got):
        failures.append("non-finite gradients at the token path's shape")
    token_errs, ok = judge_grads(got, want, False,
                                 f"kernel ({route}), token path ({b}, {WINDOW}, {h}/{kv_h}, {d}) "
                                 f"bf16 causal; launches {counts}")
    log(f"[bwd] two launches give equal bits: {all(torch.equal(x, y) for x, y in zip(got, again))}")
    if not ok:
        failures.append("the kernels at the token path's shape")
    del got, again
    # The FMA route forced at the same inputs: the same bars.
    fma_in = flash_attn._bwd_inputs(flash_attn.FMA, q, k, v, o, lse, do)
    fma_got = (flash_attn._flash_bwd_dq(flash_attn.FMA, *fma_in, True),
               *flash_attn._flash_bwd_dkv(flash_attn.FMA, *fma_in, True))
    fma_errs, fma_ok = judge_grads(fma_got, want, False, "FMA route forced, token path's shape")
    if not fma_ok:
        failures.append("the FMA route at the token path's shape")
    del fma_got
    for flaw in BWD_CONTROLS:
        _, c_ok = judge_grads(control_backward(q, k, v, o, lse, do, True, flaw), want, False,
                              f"control {flaw!r}")
        log(f"[bwd] control {flaw!r}: {'within the bars' if c_ok else 'rejected'}")
        if c_ok and flaw in BWD_MUST_FAIL:
            failures.append(f"control {flaw!r} within the bars")
    del want
    # Short cases, on whichever route they take: absolute bars as well.
    for *shape, causal, dtype, what, strided in BWD_CASES:
        c_q, c_k, c_v, c_o, c_lse, c_do = inputs(*shape, causal, dtype, strided)
        c_route = flash_attn.bwd_route(dtype, shape[5])
        kernels.reset_launch_counts()
        c_got = flash_attention_bwd(c_q, c_k, c_v, c_o, c_lse, c_do, causal)
        c_counts = bwd_launches()
        _, c_ok = judge_grads(c_got, flash_attention_bwd_plain(c_q, c_k, c_v, c_o, c_lse, c_do, causal),
                              True, f"{what} [{c_route}; launches {c_counts}]")
        if not c_ok or c_counts != routed(c_route):
            failures.append(what)

    # Times at the token path's shape, in turns: K3 and K4 of both routes
    # alone (D and the layouts made once), the whole tensor-core backward,
    # the plain backward, and SDPA's backward without its forward.
    tc_in = flash_attn._bwd_inputs(flash_attn.TENSOR_CORES, q, k, v, o, lse, do)
    qq, kk, vv = (t.detach().transpose(1, 2).requires_grad_() for t in (q, k, v))
    out = F.scaled_dot_product_attention(qq, kk, vv, is_causal=True, enable_gqa=True)
    g = do.transpose(1, 2)
    dq_ms, dkv_ms, dq_fma_ms, dkv_fma_ms, bwd_ms, plain_ms, library_ms = median_ms(
        lambda: flash_attn._flash_bwd_dq(flash_attn.TENSOR_CORES, *tc_in, True),
        lambda: flash_attn._flash_bwd_dkv(flash_attn.TENSOR_CORES, *tc_in, True),
        lambda: flash_attn._flash_bwd_dq(flash_attn.FMA, *fma_in, True),
        lambda: flash_attn._flash_bwd_dkv(flash_attn.FMA, *fma_in, True),
        lambda: flash_attention_bwd(q, k, v, o, lse, do, causal=True),
        lambda: flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
        lambda: torch.autograd.grad(out, (qq, kk, vv), g, retain_graph=True),
        reps=FLASH_REPS, warmup=1)
    rows = {}
    for name, ms, products, kv_outputs, err in (
            ("K3", dq_ms, 3, False, token_errs[0]), ("K4", dkv_ms, 4, True, max(token_errs[1:])),
            ("K3 fma", dq_fma_ms, 3, False, fma_errs[0]),
            ("K4 fma", dkv_fma_ms, 4, True, max(fma_errs[1:]))):
        flops, nbytes = bwd_flops_bytes(b, WINDOW, WINDOW, h, kv_h, d, True, 2, products, kv_outputs)
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        log(f"[bwd] {name} at the token path's shape: {ms:.4f} ms, bound {bound_ms:.4f} ms by "
            f"{bound_by} ({flops:.4g} operations, {nbytes / 1e9:.4g} GB), {flops / ms / 1e9:.4g} "
            f"TFLOP/s")
        rows[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": library_ms}
    log(f"[bwd] flash_attention_bwd (D + K3 + K4, tensor cores) {bwd_ms:.4f} ms; plain backward "
        f"(dq, dk, dv together) {plain_ms:.4f} ms; scaled_dot_product_attention backward "
        f"{library_ms:.4f} ms; FMA route K3 + K4 {dq_fma_ms + dkv_fma_ms:.4f} ms against tensor "
        f"cores {dq_ms + dkv_ms:.4f} ms")
    if failures:
        raise AssertionError("flash backward: " + "; ".join(failures))
    return rows


class CountingPlainVersions:
    """While active, counts the calls of the plain flash forward and
    backward (the module functions the wrappers call on CPU tensors)."""

    def __enter__(self):
        self.calls = {"flash_attention_plain": 0, "flash_attention_bwd_plain": 0}
        self.saved = {name: getattr(flash_attn, name) for name in self.calls}
        for name, fn in self.saved.items():
            def counted(*a, _name=name, _fn=fn, **kw):
                self.calls[_name] += 1
                return _fn(*a, **kw)
            setattr(flash_attn, name, counted)
        return self

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(flash_attn, name, fn)
        return False


def attention(fn):
    """``fn(q, k, v)`` as a GQA-native ``attn_fn``."""
    fn.supports_gqa = True
    return fn


def free_cuda():
    gc.collect()
    torch.cuda.empty_cache()


def _llama_kwargs(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _flash_counts() -> dict:
    """K2, K3, K4 and their FMA routes' launch counts since the last reset."""
    names = (flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME,
             flash_attn.FMA_KERNEL_NAME) + BWD_ROUTES[flash_attn.FMA]
    return {n: kernels.launch_counts.get(n, 0) for n in names}


def phase_train(tmp: str) -> tuple:
    url = f"file://{tmp}/tokens"
    write_token_store(url, windows=TOKEN_WINDOWS, window=WINDOW, vocab=LLAMA.vocab, seed=0)
    model_kwargs = _llama_kwargs(LLAMA)
    names = (flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME)
    fma_names = (flash_attn.FMA_KERNEL_NAME,) + BWD_ROUTES[flash_attn.FMA]   # never launched here
    failures = []

    # The main path, counted: one warm-up, the timed steps, the resident ones.
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with CountingPlainVersions() as plain:
        result = run_llm_bench(url, steps=TRAIN_STEPS, batch_size=TOKEN_BATCH, window=WINDOW,
                               workers_count=TOKEN_WORKERS, resident_steps=TRAIN_RESIDENT,
                               flash=True, model_kwargs=model_kwargs, device="cuda")
    launches = _flash_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for key, value in result.items():
        log(f"[train] {key}: {value}")
    steps = 1 + TRAIN_STEPS + TRAIN_RESIDENT
    log(f"[train] launches {launches} for {steps} steps of {LLAMA.n_layers} layers; plain "
        f"versions called {plain.calls}; peak memory {peak_gb:.2f} GB")
    if any(launches[n] != LLAMA.n_layers * steps for n in names) or any(plain.calls.values()) \
            or any(launches[n] for n in fma_names):
        failures.append(f"launches {launches}, plain calls {plain.calls}")
    if not (np.isfinite(result["loss_first"]) and np.isfinite(result["loss_last"])):
        failures.append(f"non-finite loss {result['loss_first']}, {result['loss_last']}")

    ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    with make_reader(url, schema_fields=ngram, shuffle_row_groups=True, seed=0,
                     workers_count=TOKEN_WORKERS, num_epochs=None) as r:
        it = iter(DataLoader(r, batch_size=TOKEN_BATCH, device="cuda"))
        batch = {"tokens": next(it)["token"].clone()}
        it.close()

    def fresh_params():
        return llama.init_params(torch.Generator(device="cuda").manual_seed(0), LLAMA, device="cuda")

    # One step as the bench takes it, then one with remat_layers and xent_chunk.
    losses = {}
    remat = f"remat_layers, xent_chunk={XENT_CHUNK}"
    for label, kw in (("plain step", {}), (remat, {"remat_layers": True,
                                                  "xent_chunk": XENT_CHUNK})):
        free_cuda()
        params = fresh_params()
        init_opt, step = llama.make_train_step(LLAMA, attn_fn=make_flash_attention(causal=True),
                                               shift="roll", **kw)
        opt = init_opt(params)

        def watched():   # a few leaves, to see that the step moves them
            return {"embed": params["embed"], "layers.0.wq": params["layers"][0]["wq"],
                    "last layer's w2": params["layers"][-1]["w2"], "lm_head": params["lm_head"]}
        before = {n: t.detach().clone() for n, t in watched().items()}
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        _, opt, loss = step(params, opt, batch)
        losses[label] = loss.item()
        peak = torch.cuda.max_memory_allocated() / 1e9
        counts = _flash_counts()
        moved = {n: not torch.equal(before[n], t.detach()) for n, t in watched().items()}
        log(f"[train] {label}: loss {losses[label]:.6f}, launches {counts}, peak memory "
            f"{peak:.2f} GB, parameters moved {moved}")
        want_k2 = LLAMA.n_layers * (2 if kw else 1)
        if counts != {names[0]: want_k2, names[1]: LLAMA.n_layers, names[2]: LLAMA.n_layers,
                      **{n: 0 for n in fma_names}}:
            failures.append(f"{label}: launches {counts}")
        if not all(moved.values()):
            failures.append(f"{label}: parameters did not move {moved}")
        if not kw:
            profile_step(lambda: step(params, opt, batch)[2].item(), "resident train step",
                         TRAIN_GROUPS)
        del params, opt, init_opt, step, before
    if abs(losses["plain step"] - losses[remat]) > 5e-3:
        failures.append(f"remat/xent_chunk loss {losses}")

    # Whole-slice gradient check against the plain forward and backward.
    free_cuda()
    params = fresh_params()
    leaves = llama.param_leaves(params)
    for t in leaves:
        t.requires_grad_(True)
    leaf_names = []   # in llama.param_leaves' order
    for key in sorted(params):
        if key == "layers":
            leaf_names += [f"layers.{i}.{k}" for i, layer in enumerate(params["layers"])
                           for k in sorted(layer)]
        else:
            leaf_names.append(key)

    def grads(fwd, bwd):
        attn_fn = attention(lambda q, k, v: FlashAttentionFunction.apply(q, k, v, True, fwd, bwd))
        loss = llama.loss_fn(params, batch, LLAMA, attn_fn=attn_fn, shift="roll")
        return torch.autograd.grad(loss, leaves)

    ref = grads(flash_attention_plain, flash_attention_bwd_plain)
    readings = {}
    runs = [("kernels (K2, K3, K4)", flash_attention_lse, flash_attention_bwd),
            ("plain forward, kernel backward (K3, K4)", flash_attention_plain, flash_attention_bwd)]
    runs += [(f"control {flaw!r}", flash_attention_plain,
              lambda *a, flaw=flaw: control_backward(*a, flaw=flaw)) for flaw in BWD_CONTROLS]
    n = LLAMA.n_layers
    want_launches = [{names[0]: n, names[1]: n, names[2]: n}, {names[1]: n, names[2]: n}]
    for (label, fwd, bwd), want in zip(runs, want_launches + [{}] * len(BWD_CONTROLS)):
        kernels.reset_launch_counts()
        got = grads(fwd, bwd)
        if kernels.launch_counts != want:
            failures.append(f"{label}: launches {dict(kernels.launch_counts)}, expected {want}")
        rel = [((g - r).norm() / r.norm()).item() for g, r in zip(got, ref)]
        worst = max(range(len(rel)), key=rel.__getitem__)
        readings[label] = rel[worst]
        attn_leaves = {n: round(x, 5) for n, x in zip(leaf_names, rel) if n.startswith("layers.0.w")}
        log(f"[grad] {label}: largest |g - g_plain| / |g_plain| {rel[worst]:.5f} at "
            f"{leaf_names[worst]}; layer 0: {attn_leaves}; launches {dict(kernels.launch_counts)}")
        del got
    for (label, value), bar in zip(readings.items(), (GRAD_REL_BAR, GRAD_BWD_REL_BAR)):
        if value > bar:
            failures.append(f"{label}: gradient {value:.5f} > {bar}")
    for flaw in BWD_CONTROLS:
        value = readings[f"control {flaw!r}"]
        within = [bar for bar in (GRAD_BWD_REL_BAR, GRAD_REL_BAR) if value <= bar]
        log(f"[grad] control {flaw!r}: {value:.5f}, " + (
            f"within {within}" if within else "rejected by both bars"))
        if GRAD_BWD_REL_BAR in within or (flaw in GRAD_MUST_FAIL and within):
            failures.append(f"control {flaw!r}: gradient {value:.5f} within {within}")
    del ref, params, leaves
    free_cuda()
    if failures:
        raise AssertionError("training path: " + "; ".join(failures))
    return launches, result


#: Kernel groups of a profiled ResNet-50 step, matched in this order. The
#: convolutions' kernels carry GEMM names too (cuDNN runs them as implicit
#: GEMMs); the head's matmul, 0.3 GFLOP of the step's 6.3 TFLOP, falls in
#: the same group.
IMAGE_GROUPS = (("batch norm", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
                ("SGD (multi-tensor kernels)", ("multi_tensor_apply", "sgd")),
                ("convolutions (cuDNN) and the head's matmul, forward and backward",
                 ("conv", "fprop", "dgrad", "wgrad", "implicit", "cudnn", "winograd", "nhwc",
                  "nchw", "gemm", "nvjet", "xmma", "cutlass")))


def phase_imagenet(tmp: str) -> dict:
    url = f"file://{tmp}/imagenet"
    t0 = time.perf_counter()
    write_synthetic_imagenet(url, rows=IMAGENET_ROWS, classes=IMAGENET_CLASSES,
                             rows_per_row_group=ROWS_PER_GROUP)
    log(f"[imagenet] wrote {IMAGENET_ROWS} rows of 224x224x3 JPEG q85 in "
        f"{time.perf_counter() - t0:.2f} s")
    failures = []

    # The main path, counted: one warm-up, the pipelined steps, the resident ones.
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    result = run_imagenet_bench(url, steps=IMAGENET_STEPS, per_device_batch=IMAGENET_BATCH,
                                workers_count=IMAGENET_WORKERS, classes=IMAGENET_CLASSES,
                                resident_steps=IMAGENET_RESIDENT, device="cuda")
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    for key, value in sorted(result.items()):
        log(f"[imagenet] {key}: {value}")
    log(f"[imagenet] launches {launches} (the bench preprocesses with / 255: none expected); "
        f"peak memory {peak_gb:.2f} GB")
    if set(result) != IMAGENET_KEYS:
        failures.append(f"result keys {sorted(set(result) ^ IMAGENET_KEYS)} differ from the "
                        f"JAX bench's")
    if launches:
        failures.append(f"launches {launches}")
    if not (np.isfinite(result["loss_first"]) and np.isfinite(result["loss_last"])):
        failures.append(f"non-finite loss {result['loss_first']}, {result['loss_last']}")

    with make_reader(url, reader_pool_type="thread", workers_count=IMAGENET_WORKERS, seed=0,
                     num_epochs=None) as r:
        it = iter(DataLoader(r, batch_size=IMAGENET_BATCH, device="cuda"))
        staged = next(it)
        batch = {"image": staged["image"].float() / 255.0, "label": staged["label"].clone()}
        it.close()
        del staged

    # One step from fresh parameters, with and without remat; the first is
    # profiled once warm.
    losses = {}
    for remat in (False, True):
        free_cuda()
        params = resnet.init_params(torch.Generator(device="cuda").manual_seed(0),
                                    IMAGENET_CLASSES, device="cuda")
        init_opt, step = resnet.make_train_step(learning_rate=0.05, remat=remat)
        opt = init_opt(params)
        torch.cuda.reset_peak_memory_stats()
        params, opt, loss, _ = step(params, opt, batch)
        losses[remat] = loss.item()
        peak = torch.cuda.max_memory_allocated() / 1e9
        log(f"[imagenet] one step{' with remat' if remat else ''}: loss {losses[remat]:.6f}, "
            f"peak memory {peak:.2f} GB")
        if not remat:
            def resident():
                nonlocal params, opt
                params, opt, loss, _ = step(params, opt, batch)
                loss.item()
            profile_step(resident, "resident ResNet-50 train step", IMAGE_GROUPS, top=12)
        del params, opt, init_opt, step
    if abs(losses[True] - losses[False]) > 1e-3 * abs(losses[False]):
        failures.append(f"remat changed the loss {losses}")

    # The flagship forward: bf16 against float32 with TF32 off.
    free_cuda()
    forward, (params, images) = entry(device="cuda")
    with torch.inference_mode():
        got = forward(params, images)
        saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
        try:
            want = resnet.apply(params, images, compute_dtype=torch.float32)[0]
        finally:
            torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
        rel = ((got - want).abs().mean() / want.abs().mean()).item()
        (fwd_ms,) = median_ms(lambda: forward(params, images), reps=10)
        profile_step(lambda: forward(params, images).sum().item(), "entry() forward, batch 8",
                     IMAGE_GROUPS)
    ok = bool(torch.isfinite(got).all()) and got.shape == (8, 1000) and rel <= ENTRY_F32_BAR
    log(f"[imagenet] entry() forward, 8 x 224x224, bf16 against float32 (TF32 off): mean abs "
        f"difference {rel:.4%} of the mean |logit| {want.abs().mean().item():.4g} (bar "
        f"{ENTRY_F32_BAR:.0%}): {'within the bar' if ok else 'OUTSIDE'}; forward {fwd_ms:.3f} ms")
    if not ok:
        failures.append(f"entry() forward {rel:.4%} from float32")
    del params, images, got, want
    free_cuda()
    if failures:
        raise AssertionError("image path: " + "; ".join(failures))
    return result


def control_stats(q, k, v, causal, flaw):
    """K2 "stats" (kernel layout: m, l (b, h, sq)) computed as its plain
    version computes them, with one ``flaw`` of STATS_CONTROLS."""
    o, m, l = flash_attn._stats_plain(q, k, v, causal)
    if flaw == STATS_CONTROLS[0]:
        return o, m / float(np.log(2.0)), l
    if flaw == STATS_CONTROLS[1]:
        return o, m, l * 1.01
    if flaw == STATS_CONTROLS[4]:
        return o / l.transpose(1, 2)[..., None], m, l
    # Keys dropped: the plain block math over the keys the flaw keeps.
    from petastorm_tpu_torch.parallel.ring_attention import _block_attention_chunked
    sq, sk = q.shape[1], k.shape[1]
    q_pos, k_pos = torch.arange(sq, device="cuda"), torch.arange(sk, device="cuda")
    if flaw == STATS_CONTROLS[2]:   # the key loop ends one 64-key tile early
        keep = k_pos < (sk - 1) // 64 * 64
    else:
        keep = k_pos % 32 != 31
    return _block_attention_chunked(q, k[:, keep], v[:, keep], k_pos[keep], q_pos, causal, 1024)


def stats_verdict(got, want, dtype):
    """-> (o worst, o rms, m max abs err, l max rel err, within every bar)."""
    worst, rms = row_scaled_errors(got[0], want[0], dtype=dtype)
    m_err = (got[1] - want[1]).abs().max().item()
    l_err = ((got[2] - want[2]).abs() / want[2]).max().item()
    _, worst_bar, rms_bar = ROW_BARS[dtype]
    ok = worst <= worst_bar and rms <= rms_bar and m_err <= STATS_M_BAR and l_err <= STATS_L_REL_BAR
    return worst, rms, m_err, l_err, ok


def phase_stats() -> dict:
    """K2 "stats" against its plain version at the ring's block."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    h, kv_h, d = SEQ_LLAMA.n_heads, SEQ_LLAMA.n_kv_heads, SEQ_LLAMA.head_dim

    def randn(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device="cuda").to(dtype)
    q, k, v = randn(1, SEQ_BLOCK, h, d), randn(1, SEQ_BLOCK, kv_h, d), randn(1, SEQ_BLOCK, kv_h, d)
    failures, errs = [], {}
    bars = (f"bars: o row-scaled worst {ROW_BARS[torch.bfloat16][1]:.3g} rms "
            f"{ROW_BARS[torch.bfloat16][2]:.3g}, m {STATS_M_BAR}, l relative {STATS_L_REL_BAR}")
    for causal in (True, False):
        want = flash_attn._stats_plain(q, k, v, causal)
        for route in (flash_attn.TENSOR_CORES, flash_attn.FMA):
            kernels.reset_launch_counts()
            if route == flash_attn.TENSOR_CORES:   # the public entry point takes this route
                o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=causal)
                got = (o, m.transpose(1, 2), l.transpose(1, 2))
            else:
                got = flash_attn._flash_stats_fwd(route, q, k, v, causal)
            counts = dict(kernels.launch_counts)
            torch.cuda.synchronize()
            worst, rms, m_err, l_err, ok = stats_verdict(got, want, torch.bfloat16)
            err = max((got[0] - want[0]).abs().max().item(), m_err)
            errs[route, causal] = err
            log(f"[stats] (1, {SEQ_BLOCK}, {h}/{kv_h}, {d}) bf16 "
                f"{'causal' if causal else 'non-causal'} [{route}; launches {counts}]: o row-scaled worst {worst:.3g} rms {rms:.3g}, "
                f"max abs {(got[0] - want[0]).abs().max().item():.3g}; m {m_err:.3g}; l relative "
                f"{l_err:.3g} ({bars})")
            if not ok or counts != {flash_attn._STATS_KERNELS[route]: 1} \
                    or got[0].dtype != torch.float32 or got[0].shape != q.shape:
                failures.append(f"{route} causal={causal}")
            del got
        if causal:
            for flaw in STATS_CONTROLS:
                worst, rms, m_err, l_err, ok = stats_verdict(control_stats(q, k, v, True, flaw),
                                                             want, torch.bfloat16)
                log(f"[stats] control {flaw!r}: o worst {worst:.3g} rms {rms:.3g}; m {m_err:.3g}; "
                    f"l relative {l_err:.3g}: {'within the bars' if ok else 'rejected'}")
                if ok:
                    failures.append(f"control {flaw!r} within the bars")
        del want
    # Ragged, GQA rep 8 and other types, on whichever route they take.
    for b, sq, sk, hh, kk, dd, causal, dtype, what in (
            (1, SEQ_BLOCK - 37, SEQ_BLOCK - 37, h, kv_h, d, True, torch.bfloat16, "ragged causal"),
            (2, 777, 1500, 32, 4, 128, False, torch.bfloat16, "GQA rep 8, sq 777 < sk 1500"),
            (1, 300, 300, 8, 2, 64, True, torch.float16, "f16 d64 causal"),
            (2, 150, 150, 8, 2, 64, True, torch.float32, "f32 causal")):
        cq, ck, cv = randn(b, sq, hh, dd, dtype=dtype), randn(b, sk, kk, dd, dtype=dtype), \
            randn(b, sk, kk, dd, dtype=dtype)
        route = flash_attn.fwd_route(dtype, dd)
        kernels.reset_launch_counts()
        o, m, l = flash_attn.flash_attention_stats(cq, ck, cv, causal=causal)
        counts = dict(kernels.launch_counts)
        worst, rms, m_err, l_err, ok = stats_verdict(
            (o, m.transpose(1, 2), l.transpose(1, 2)), flash_attn._stats_plain(cq, ck, cv, causal),
            dtype)
        log(f"[stats] {what} [{route}; launches {counts}]: o worst {worst:.3g} rms {rms:.3g}; "
            f"m {m_err:.3g}; l relative {l_err:.3g}")
        if not ok or counts != {flash_attn._STATS_KERNELS[route]: 1}:
            failures.append(what)

    failures += ring_backward_check(q, k, v, randn)

    # Times at the ring's block, in turns: both routes, the plain version and
    # SDPA (whose (O, lse, 1) is an equivalent triple for the ring's merge).
    def sdpa_block(causal):
        return lambda: F.scaled_dot_product_attention(q.transpose(1, 2), k.transpose(1, 2),
                                                      v.transpose(1, 2), is_causal=causal,
                                                      enable_gqa=True)
    rows = {}
    for causal in (False, True):
        ms, fma_ms, plain_ms, library_ms = median_ms(
            lambda: flash_attn._flash_stats_fwd(flash_attn.TENSOR_CORES, q, k, v, causal),
            lambda: flash_attn._flash_stats_fwd(flash_attn.FMA, q, k, v, causal),
            lambda: flash_attn._stats_plain(q, k, v, causal), sdpa_block(causal),
            reps=FLASH_REPS, warmup=1)
        flops, nbytes = flash_flops_bytes(1, SEQ_BLOCK, SEQ_BLOCK, h, kv_h, d, causal, 2, False)
        nbytes += 2 * SEQ_BLOCK * h * d + 2 * 4 * SEQ_BLOCK * h   # o in float32; m and l
        bound_ms = max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = "operations" if flops / BF16_FLOPS >= nbytes / HBM_BYTES_PER_S else "bytes"
        log(f"[stats] ring block {'causal (diagonal)' if causal else 'non-causal (past block)'}: "
            f"tensor cores {ms:.4f} ms ({flops / ms / 1e9:.4g} TFLOP/s), FMA route {fma_ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, scaled_dot_product_attention {library_ms:.4f} ms; "
            f"bound {bound_ms:.4f} ms by {bound_by} ({flops:.4g} operations, "
            f"{nbytes / 1e6:.4g} MB)")
        row = {"plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": library_ms}
        if not causal:   # the kernels line: a strictly-past block, the ring's common step
            rows = {"stats": {"max_abs_err": errs[flash_attn.TENSOR_CORES, False], "ms": ms, **row},
                    "stats fma": {"max_abs_err": errs[flash_attn.FMA, False], "ms": fma_ms, **row}}
    if failures:
        raise AssertionError("K2 stats: " + "; ".join(failures))
    return rows


def ring_backward_check(q, k, v, randn) -> list:
    """K3 and K4 as the ring's backward launches them on rank 1 of 2: q
    against the diagonal block (k, v; causal) and a strictly-past block
    (non-causal), each given the output and the global lse of the two
    blocks merged, so a block's p rows do not sum to 1 and D comes from the
    merged output. Each block's (dq, dk, dv) is held against the plain
    backward on the same inputs with the row-scaled bars, and BWD_CONTROLS
    must fail them. -> failures."""
    from petastorm_tpu_torch.parallel.ring_attention import _merge
    k_past, v_past, do = randn(*k.shape), randn(*v.shape), randn(*q.shape)
    o, m, l = _merge(flash_attn._stats_plain(q, k_past, v_past, False),
                     flash_attn._stats_plain(q, k, v, True))
    out = (o / l.transpose(1, 2)[..., None]).to(q.dtype)
    lse = (m + torch.log(l))[..., None]
    del o, m, l
    failures = []
    for kb, vb, causal, what in ((k, v, True, "diagonal block, causal"),
                                 (k_past, v_past, False, "past block, non-causal")):
        kernels.reset_launch_counts()
        got = flash_attention_bwd(q, kb, vb, out, lse, do, causal)
        counts = bwd_launches()
        want = flash_attention_bwd_plain(q, kb, vb, out, lse, do, causal)
        _, ok = judge_grads(got, want, False,
                            f"ring backward on rank 1 of 2, {what}, global lse "
                            f"({tuple(q.shape)}, kv {kb.shape[2]}) bf16; launches {counts}")
        if not ok or counts != {flash_attn.TENSOR_CORES: (1, 1), flash_attn.FMA: (0, 0)}:
            failures.append(f"ring backward, {what}")
        del got
        for flaw in BWD_CONTROLS:
            _, c_ok = judge_grads(control_backward(q, kb, vb, out, lse, do, causal, flaw), want,
                                  False, f"ring backward, {what}: control {flaw!r}")
            log(f"[bwd] ring backward, {what}: control {flaw!r}: "
                f"{'within the bars' if c_ok else 'rejected'}")
            if c_ok:
                failures.append(f"ring backward, {what}: control {flaw!r} within the bars")
        del want
    return failures


def phase_seq_parallel(tmp: str) -> dict:
    """The sequence-parallel training path (see the module docstring, phase
    10). Returns the kernels' launch counts summed over the ranks and both
    strategies."""
    from petastorm_tpu_torch.benchmark.seq_parallel_bench import (leaf, run_seq_parallel_train,
                                                                  token_windows)
    url = f"file://{tmp}/seq_tokens"
    write_token_store(url, windows=4, window=WINDOW, vocab=SEQ_LLAMA.vocab, seed=0)
    model_kwargs = _llama_kwargs(SEQ_LLAMA)
    failures = []

    # One process on the whole window: the first step's loss and gradients.
    free_cuda()
    with DataLoader(token_windows(url, WINDOW), batch_size=1, device="cuda") as loader:
        it = iter(loader)
        batch = {"tokens": next(it)["token"]}
        it.close()
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), SEQ_LLAMA,
                               device="cuda")
    for t in llama.param_leaves(params):
        t.requires_grad_(True)
    loss = llama.loss_fn(params, batch, SEQ_LLAMA, attn_fn=make_flash_attention(causal=True),
                         shift="roll")
    loss.backward()
    ref_loss = loss.item()
    ref_grads = {n: leaf(params, n).grad.cpu() for n in SEQ_WATCH}
    del params, loss, batch
    free_cuda()
    log(f"[seq] one process, window {WINDOW}: first loss {ref_loss:.6f}")

    t0 = time.perf_counter()
    results = run_seq_parallel_train(url, world_size=SEQ_RANKS, steps=SEQ_STEPS, window=WINDOW,
                                     model_kwargs=model_kwargs, watch=SEQ_WATCH, device="cuda")
    log(f"[seq] {SEQ_RANKS} ranks, both strategies: {time.perf_counter() - t0:.1f} s with the "
        f"spawn")
    names = (flash_attn.STATS_KERNEL_NAME, flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
             flash_attn.BWD_DKV_KERNEL_NAME, flash_attn.STATS_FMA_KERNEL_NAME,
             flash_attn.FMA_KERNEL_NAME) + BWD_ROUTES[flash_attn.FMA]
    n, steps = SEQ_LLAMA.n_layers, SEQ_STEPS
    # Per rank r of P, per layer and step: the ring runs r + 1 blocks (K2
    # "stats", then K3 and K4 each); Ulysses one K2 "lse", K3 and K4.
    blocks = sum(r + 1 for r in range(SEQ_RANKS))
    want = {"ring": {names[0]: blocks * n * steps, names[2]: blocks * n * steps,
                     names[3]: blocks * n * steps},
            "ulysses": {names[1]: SEQ_RANKS * n * steps, names[2]: SEQ_RANKS * n * steps,
                        names[3]: SEQ_RANKS * n * steps}}
    totals = {name: 0 for name in names}
    first = {}
    for strategy, ranks in results.items():
        counts = {name: sum(r["launches"].get(name, 0) for r in ranks) for name in names}
        for name in names:
            totals[name] += counts[name]
        r0 = ranks[0]
        ms = statistics.median(r0["step_ms"])
        transfers = {op: f"{v['calls']} calls, {v['bytes'] / 1e9:.3f} GB, {v['seconds']:.3f} s"
                     for op, v in r0["transfers"].items()}
        log(f"[seq] {strategy}: losses {r0['losses']}; step ms "
            f"{[round(x, 1) for x in r0['step_ms']]} (median {ms:.1f}, {r0['tokens_per_sec']:.1f} tokens/s); peak memory by rank "
            f"{[round(r['peak_memory_gb'], 2) for r in ranks]} GB; rank 0's transfers over "
            f"{steps} steps: {transfers}; launches over the ranks {counts}")
        if any(r["losses"] != r0["losses"] for r in ranks):
            failures.append(f"{strategy}: the ranks' losses differ")
        if {k: v for k, v in counts.items() if v} != want[strategy]:
            failures.append(f"{strategy}: launches {counts}, expected {want[strategy]}")
        if not np.isfinite(r0["losses"]).all():
            failures.append(f"{strategy}: non-finite loss {r0['losses']}")
        loss_rel = abs(r0["losses"][0] - ref_loss) / abs(ref_loss)
        rel = {name: ((g - ref_grads[name]).norm() / ref_grads[name].norm()).item()
               for name, g in r0["grads"].items()}
        log(f"[seq] {strategy} against one process: first loss {loss_rel:.3g} relative (bar "
            f"{SEQ_LOSS_REL_BAR}); gradients |g - g_one| / |g_one| "
            f"{ {k: round(x, 5) for k, x in rel.items()} } (bar {GRAD_REL_BAR})")
        if loss_rel > SEQ_LOSS_REL_BAR or set(rel) != set(SEQ_WATCH) \
                or max(rel.values()) > GRAD_REL_BAR:
            failures.append(f"{strategy}: loss {loss_rel:.3g}, gradients {rel}")
        first[strategy] = r0
    ring, uly = first["ring"], first["ulysses"]
    loss_rel = abs(ring["losses"][0] - uly["losses"][0]) / abs(uly["losses"][0])
    rel = max(((ring["grads"][n_] - uly["grads"][n_]).norm() / uly["grads"][n_].norm()).item()
              for n_ in SEQ_WATCH)
    log(f"[seq] ring against Ulysses: first loss {loss_rel:.3g} relative, gradients {rel:.5f}")
    if loss_rel > SEQ_LOSS_REL_BAR or rel > GRAD_REL_BAR:
        failures.append(f"ring against Ulysses: loss {loss_rel:.3g}, gradients {rel:.5f}")
    if failures:
        raise AssertionError("sequence-parallel path: " + "; ".join(failures))
    return totals


def _maps_libraries(pid: int) -> set:
    """Which of libcuda and libtorch the process ``pid`` has mapped."""
    with open(f"/proc/{pid}/maps") as f:
        maps = f.read()
    return {lib for lib in ("libcuda", "libtorch") if lib in maps}


def _gpu_pids() -> list:
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout
    return [int(word) for word in out.split() if word.isdigit()]


def busiest_processes(seconds: float = 0.5, top: int = 4) -> list:
    """The host's busiest processes over ``seconds``: (pid, name, share of
    one core), from ``/proc/<pid>/stat``."""
    def sample():
        ticks = {}
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat") as f:
                    fields = f.read().rsplit(")", 1)
                name = fields[0].split("(", 1)[1]
                rest = fields[1].split()
                ticks[int(pid)] = (name, int(rest[11]) + int(rest[12]))
            except (OSError, IndexError, ValueError):
                continue
        return ticks
    before = sample()
    time.sleep(seconds)
    after = sample()
    hz = os.sysconf("SC_CLK_TCK")
    busy = sorted(((after[p][1] - before[p][1]) / hz / seconds, p, after[p][0])
                  for p in after if p in before)
    return [(pid, name, round(share, 2)) for share, pid, name in busy[::-1][:top]]


def _assert_torn_down(pool, what: str):
    alive = [p.pid for p in pool._processes if p.poll() is None]
    left = [n for n in pool.ring_names if os.path.exists(f"/dev/shm/{n}")]
    if alive or left or not pool.ring_names:
        raise AssertionError(f"{what}: workers {alive} alive, rings {left} left after join()")


def phase_process(slice_url: str, token_url: str, imagenet_url: str, thread_bench: dict) -> dict:
    """The process path (see the module docstring, phase 11). Returns the
    main paths' launches: K1's and the token bench's K2/K3/K4."""
    t_phase = time.perf_counter()
    failures = []
    decode = native_decode_status()
    if not native.ring_available():
        # nvcc needs g++, so a host that built the kernels builds the ring.
        failures.append(f"the native ring did not build: {native.ring_error()}")
    native_jpeg = decode["native_usable"] and decode["jpeg_parity"]
    predicted = "native" if native_jpeg else "codec (cv2)"
    log(f"[process] host before the phase: load average {os.getloadavg()}, "
        f"{len(os.sched_getaffinity(0))} usable cores, busiest processes (pid, name, cores) "
        f"{busiest_processes()}")

    # 1. The reader alone, threads against processes; 2. the same rows.
    digests = {}
    for workers in PROCESS_WORKERS:
        for pool_type in ("thread", "process"):
            kept = []
            t0 = time.perf_counter()
            with make_reader(slice_url, reader_pool_type=pool_type, workers_count=workers,
                             seed=0, num_epochs=EPOCHS) as reader:
                for row in reader:
                    if not kept:
                        t_first = time.perf_counter()
                    kept.append(row)
                wall = time.perf_counter() - t0
                read = time.perf_counter() - t_first
                counters, pool = reader.counters, reader.pool
            n_native = counters.get("images_native", 0)
            n_codec = counters.get("images_codec", 0)
            ring = getattr(pool, "ring_impl", None)
            start = getattr(pool, "start_seconds", None)
            log(f"[process] reader alone, {pool_type} x{workers}: {len(kept)} rows in "
                f"{wall:.3f} s: {len(kept) / wall:.1f} rows/s ({(len(kept) - 1) / read:.1f} "
                f"rows/s from the first row on, {t_first - t0:.3f} s to it); images decoded native "
                f"{n_native}, codec {n_codec} (predicted {predicted})"
                + (f"; ring {ring}, workers ready in {start:.3f} s" if ring else ""))
            rows = ROWS * EPOCHS
            if len(kept) != rows or (n_native, n_codec) != ((rows, 0) if native_jpeg
                                                            else (0, rows)):
                failures.append(f"{pool_type} x{workers}: {len(kept)} rows, native {n_native}, "
                                f"codec {n_codec}, predicted {predicted}")
            if pool_type == "process":
                if ring != "native":
                    failures.append(f"process x{workers} ran on the {ring!r} ring")
                _assert_torn_down(pool, f"process x{workers}")
            if workers == PROCESS_WORKERS[0]:
                digests[pool_type] = sorted((int(r.id), hashlib.sha1(r.image.tobytes()).hexdigest())
                                            for r in kept)
                if pool_type == "process":
                    by_id = {int(r.id): r.image for r in kept}
            del kept
    if digests["process"] != digests["thread"]:
        failures.append("the process pool's rows differ from the thread pool's")
    log(f"[process] the process pool's {len(digests['process'])} rows equal the thread "
        f"pool's as a multiset of (id, sha1(image)): {digests['process'] == digests['thread']}")

    import cv2
    import pyarrow.parquet as pq
    from petastorm_tpu_torch.etl.dataset_metadata import DatasetContext, load_row_groups
    ctx = DatasetContext(slice_url)
    rg = load_row_groups(ctx)[0]
    with ctx.filesystem.open(rg.path, "rb") as f:
        table = pq.ParquetFile(f).read_row_group(rg.row_group, columns=["id", "image"])
    ids, blobs = table.column("id").to_pylist(), table.column("image").to_pylist()
    equal = sum(np.array_equal(by_id[i], cv2.cvtColor(cv2.imdecode(
        np.frombuffer(b, np.uint8), cv2.IMREAD_UNCHANGED), cv2.COLOR_BGR2RGB))
        for i, b in zip(ids[:PARITY_ROWS], blobs[:PARITY_ROWS]))
    log(f"[process] {equal}/{PARITY_ROWS} images of the process pool bit-equal to a per-cell "
        f"cv2 decode of their blobs")
    if equal != PARITY_ROWS:
        failures.append(f"{PARITY_ROWS - equal} images differ from cv2's")
    del by_id, table, blobs

    # 3. The main path on processes, counted; 4. no worker on the card.
    kernels.reset_launch_counts()
    batches = samples = 0
    last = None
    t0 = time.perf_counter()
    with make_reader(slice_url, reader_pool_type="process", workers_count=WORKERS, seed=0,
                     num_epochs=EPOCHS) as reader:
        for batch in DataLoader(reader, batch_size=BATCH, device="cuda"):
            last = normalize_images(batch["image"])
            batches += 1
            samples += batch["image"].shape[0]
            if batches == 1:
                worker_pids = reader.pool.worker_pids
                on_card = _gpu_pids()
                mapped = {pid: _maps_libraries(pid) for pid in worker_pids}
        pool = reader.pool
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.launch_counts)
    log(f"[process] main path on processes: {batches} batches, {samples} samples in "
        f"{wall:.3f} s: {samples / wall:.1f} samples/s; launches {launches}")
    if launches != {KERNEL_NAME: ROWS * EPOCHS // BATCH} or batches != ROWS * EPOCHS // BATCH \
            or last.dtype != torch.bfloat16 or not torch.isfinite(last.float()).all():
        failures.append(f"main path on processes: {batches} batches, launches {launches}")
    _assert_torn_down(pool, "main path")
    log(f"[process] nvidia-smi compute pids {on_card} (this process {os.getpid()}, workers "
        f"{worker_pids}); libraries the workers map: {mapped}")
    if set(on_card) & set(worker_pids) or len(on_card) > 1 or any(mapped.values()):
        failures.append(f"a worker holds the card: nvidia-smi {on_card}, maps {mapped}")
    env_pool = ProcessPool(2, ring_capacity=16 << 20)
    env_pool.start(EnvironmentWorker)
    for i in range(2):
        env_pool.ventilate(value=i)
    seen = []
    while True:
        try:
            seen.append(env_pool.get_results())
        except EmptyResultError:
            break
    env_pool.stop()
    env_pool.join()
    log(f"[process] spawned workers report {seen}")
    if len(seen) != 2 or any(s["cuda_visible_devices"] != "" or s["torch_imported"] for s in seen):
        failures.append(f"workers' environment {seen}")

    # 5. The image training path on processes, beside phase 9's threads.
    free_cuda()
    kernels.reset_launch_counts()
    result = run_imagenet_bench(imagenet_url, steps=IMAGENET_STEPS,
                                per_device_batch=IMAGENET_BATCH, workers_count=IMAGENET_WORKERS,
                                classes=IMAGENET_CLASSES, resident_steps=IMAGENET_RESIDENT,
                                pool_type="process", device="cuda")
    bench_launches = dict(kernels.launch_counts)
    for key in ("step_time_ms", "samples_per_sec", "input_stall_pct", "step_time_ms_resident",
                "loss_first", "loss_last"):
        log(f"[process] imagenet bench {key}: processes {result[key]}, threads (phase 9) "
            f"{thread_bench[key]}")
    if set(result) != IMAGENET_KEYS or bench_launches \
            or not np.isfinite([result["loss_first"], result["loss_last"]]).all():
        failures.append(f"imagenet bench on processes: keys {sorted(set(result) ^ IMAGENET_KEYS)}"
                        f", launches {bench_launches}")

    # 6. The token training path on processes, counted.
    free_cuda()
    names = (flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME)
    model_kwargs = _llama_kwargs(PROCESS_LLAMA)
    kernels.reset_launch_counts()
    with CountingPlainVersions() as plain:
        tokens = run_llm_bench(token_url, steps=PROCESS_TRAIN_STEPS, batch_size=TOKEN_BATCH,
                               window=WINDOW, workers_count=TOKEN_WORKERS, flash=True,
                               model_kwargs=model_kwargs, pool_type="process", device="cuda")
    token_launches = dict(kernels.launch_counts)
    want = PROCESS_LLAMA.n_layers * (1 + PROCESS_TRAIN_STEPS)
    log(f"[process] llm bench on processes: {tokens['tokens_per_sec']:.1f} tokens/s, step "
        f"{tokens['step_time_ms']:.1f} ms, input stall {tokens['input_stall_pct']:.2f} %, loss "
        f"{tokens['loss_first']:.4f} -> {tokens['loss_last']:.4f}; launches {token_launches} "
        f"(expected {want} of each); plain versions called {plain.calls}")
    if token_launches != {n: want for n in names} or any(plain.calls.values()) \
            or not np.isfinite([tokens["loss_first"], tokens["loss_last"]]).all():
        failures.append(f"llm bench on processes: launches {token_launches}, plain "
                        f"{plain.calls}")
    free_cuda()

    # 7. A worker killed mid-epoch makes the reader raise, promptly.
    reader = make_reader(slice_url, reader_pool_type="process", workers_count=WORKERS,
                         num_epochs=None)
    try:
        next(reader)
        os.kill(reader.pool.worker_pids[0], signal.SIGKILL)
        t0 = time.perf_counter()
        try:
            for _ in range(10 * ROWS):
                next(reader)
            raised = None
        except RuntimeError as e:
            raised = e
        waited = time.perf_counter() - t0
    finally:
        reader.stop()
        reader.join()
    _assert_torn_down(reader.pool, "killed worker")
    log(f"[process] SIGKILL of worker {reader.pool.worker_pids[0]}: the reader raised after "
        f"{waited:.3f} s: {raised!r}")
    if raised is None or waited > KILL_BAR_S:
        failures.append(f"a killed worker: raised {raised!r} after {waited:.3f} s")
    log(f"[process] phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("process path: " + "; ".join(failures))
    return {"normalize": launches.get(KERNEL_NAME, 0), **{n: token_launches.get(n, 0)
                                                           for n in names}}


def _reader_alone(url: str, pool_type: str, workers: int) -> dict:
    """One epoch of ``make_batch_reader(url).next_batch()``, copying nothing:
    rows, bytes, seconds (from the call, and from the first batch on), the
    workers' start-up and the pool's counters."""
    rows = nbytes = 0
    t0 = time.perf_counter()
    with make_batch_reader(url, reader_pool_type=pool_type, workers_count=workers,
                           seed=0) as reader:
        while True:
            try:
                batch = reader.next_batch()
            except StopIteration:
                break
            if not rows:
                t_first = time.perf_counter()
            rows += len(batch["id"] if "id" in batch else next(iter(batch.values())))
            nbytes += sum(v.nbytes for v in batch.values())
            del batch
        t_end = time.perf_counter()
        pinned = reader.pool.pinned if pool_type == "process" else 0
        out = {"rows": rows, "bytes": nbytes, "s": t_end - t0, "from_first_s": t_end - t_first,
               "start_s": getattr(reader.pool, "start_seconds", None), "counters": reader.counters,
               "pinned": pinned}
    out["leaked"] = list(getattr(reader.pool, "leaked_rings", []))
    return out


def _columnar_line(what: str, r: dict) -> str:
    start = "none (threads)" if r["start_s"] is None else f"{r['start_s']:.3f} s"
    return (f"[columnar] {what}: {r['rows']} rows, {r['bytes'] / 1e6:.1f} MB in {r['s']:.3f} s: "
            f"{r['rows'] / r['s']:.1f} rows/s, {r['bytes'] / 1e6 / r['s']:.1f} MB/s "
            f"({r['rows'] / r['from_first_s']:.1f} rows/s from the first batch on); workers' "
            f"start-up {start}; zero-copy batches {r['counters'].get('zero_copy_batches', 0)}, "
            f"bytes {r['counters'].get('zero_copy_bytes', 0)}")


def _tensor_reference(url: str) -> dict:
    """The tensor store read by ``pyarrow.parquet`` alone, each column on the
    card in ``id`` order (float32 columns seen as int32, so that equality is
    bit equality)."""
    import pyarrow.parquet as pq
    table = pq.read_table(url[len("file://"):])
    ids = table.column("id").to_numpy()
    order = np.argsort(ids, kind="stable")
    if not np.array_equal(ids[order], np.arange(TENSOR_ROWS)):
        raise AssertionError("the tensor store's ids are not arange(rows)")
    ref = {}
    for name in table.column_names:
        col = table.column(name).combine_chunks()
        arr = (col.values.to_numpy().reshape(len(col), col.type.list_size)
               if hasattr(col.type, "list_size") else col.to_numpy())
        t = torch.from_numpy(np.ascontiguousarray(arr[order])).to("cuda")
        ref[name] = t.view(torch.int32) if t.dtype == torch.float32 else t
    return ref


def _tensor_loader_epoch(url: str, pool_type: str, make_loader, ref: dict,
                         workers: int = COLUMNAR_WORKERS) -> dict:
    """One timed epoch of ``make_loader(make_batch_reader(url))`` onto the
    card (an in-memory loader's load inside the timed window), its batches
    kept there; then, out of the timed window, every column of every batch
    held against ``ref`` by id and the epoch's ids gathered."""
    rows = nbytes = 0
    batches = []
    t0 = time.perf_counter()
    with make_batch_reader(url, reader_pool_type=pool_type, workers_count=workers,
                           seed=0) as reader:
        for batch in make_loader(reader):
            if not rows:
                t_first = time.perf_counter()
            batches.append(batch)
            rows += len(batch["id"])
            nbytes += sum(v.numel() * v.element_size() for v in batch.values())
        del batch
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        gc.collect()
        pinned = reader.pool.pinned if pool_type == "process" else 0
        out = {"rows": rows, "bytes": nbytes, "s": t_end - t0, "from_first_s": t_end - t_first,
               "start_s": getattr(reader.pool, "start_seconds", None), "counters": reader.counters,
               "pinned": pinned}
    out["leaked"] = list(getattr(reader.pool, "leaked_rings", []))
    ids = torch.cat([b["id"] for b in batches])
    out["every_row_once"] = bool(torch.equal(torch.sort(ids).values,
                                             torch.arange(TENSOR_ROWS, device="cuda")))
    mismatches = 0
    for name, want in ref.items():
        got = torch.cat([b[name] for b in batches])
        got = got.view(torch.int32) if got.dtype == torch.float32 else got
        mismatches += int((got != want[ids]).sum())
        del got
    out["mismatches"] = mismatches
    return out


def staging_batches(scalar_url: str) -> dict:
    """One batch of each path's columns, as the loaders stage them: the
    scalar store's first 1024 rows, a seeded batch of the tensor store's
    schema, and the selection phase's image batch (256 192x192x3 crops and
    their labels)."""
    import pyarrow.parquet as pq
    table = pq.read_table(scalar_url[len("file://"):]).slice(0, SCALAR_BENCH["batch_size"])
    rng = np.random.default_rng(0)
    tensor = {"id": np.arange(COLUMNAR_BATCH, dtype=np.int64)}
    tensor.update({f"f{i}": rng.standard_normal(COLUMNAR_BATCH).astype(np.float32)
                   for i in range(8)})
    tensor.update({f"emb{j}": rng.standard_normal((COLUMNAR_BATCH, TENSOR_LIST))
                   .astype(np.float32) for j in range(2)})
    image = {"image": rng.integers(0, 256, (IMAGENET_BATCH, SELECT_CROP, SELECT_CROP, 3),
                                   dtype=np.uint8),
             "label": rng.integers(0, IMAGENET_CLASSES, IMAGENET_BATCH)}
    return {"scalar": {name: table.column(name).to_numpy() for name in table.column_names},
            "tensor": tensor, "image": image}


def staging_ms(cols: dict, reps: int = 200) -> float:
    """Host milliseconds that the loaders' stager takes to stage ``cols``
    onto the card (the staging thread's share of a loader's batch: the
    pinned copy, the device copies issued, the consumer's stream made to
    wait), the median over ``reps`` batches after a warm-up."""
    stager = loader_module._PinnedStager(torch.device("cuda", torch.cuda.current_device()), 3)
    consumer = torch.cuda.current_stream()
    for _ in range(10):
        stager.stage(cols)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        staged, event = stager.stage(cols)
        consumer.wait_event(event)
        for v in staged.values():
            v.record_stream(consumer)
        times.append(time.perf_counter() - t0)
        del staged
    torch.cuda.synchronize()
    return 1e3 * statistics.median(times)


def phase_columnar(tmp: str) -> dict:
    """The columnar path (see the module docstring, phase 12). Returns the
    zero-copy batches of each tensor-store run on processes."""
    t_phase = time.perf_counter()
    failures = []
    kernels.reset_launch_counts()

    def zero_copy_ok(what, r, groups):
        if r["counters"].get("zero_copy_batches", 0) != groups or r["pinned"] or r["leaked"]:
            failures.append(f"{what}: zero-copy batches {r['counters'].get('zero_copy_batches')} "
                            f"of {groups} groups, {r['pinned']} records pinned, rings kept "
                            f"{r['leaked']}")

    # The scalar store: the JAX bench's settings, onto the CPU and the card.
    scalar_url = generate_scalar_dataset(f"file://{tmp}/scalar_100k")
    scalar_groups = -(-100_000 // 2048)
    for pool_type, workers in SCALAR_WORKERS.items():
        for device in ("cpu", "cuda"):
            rate = batched_loader_throughput(scalar_url, workers_count=workers,
                                             pool_type=pool_type, device=device, **SCALAR_BENCH)
            log(f"[columnar] scalar bench, {pool_type} x{workers} -> {device}: {rate:.1f} rows/s, "
                f"{rate * SCALAR_ROW_BYTES / 1e6:.1f} MB/s")
            if not rate > 0:
                failures.append(f"scalar bench {pool_type} {device}: {rate}")
        r = _reader_alone(scalar_url, pool_type, workers)
        log(_columnar_line(f"scalar reader alone, {pool_type} x{workers}", r))
        if r["rows"] != 100_000:
            failures.append(f"scalar reader alone {pool_type}: {r['rows']} rows")
        if pool_type == "process":
            zero_copy_ok(f"scalar reader alone {pool_type}", r, scalar_groups)

    # The staging alone, on one batch of each store's columns.
    for what, cols in staging_batches(scalar_url).items():
        log(f"[columnar] staging alone, a {what} batch ({len(cols)} columns, "
            f"{sum(v.nbytes for v in cols.values())} bytes): {staging_ms(cols):.4f} ms "
            f"(host, median of 200)")

    # Staging is exact: one seeded in-memory load, 3 epochs on the card
    # against the same loader on the CPU.
    with make_batch_reader(scalar_url, reader_pool_type="thread", workers_count=3,
                           shuffle_row_groups=False) as reader:
        on_card = InMemBatchedDataLoader(reader, batch_size=SCALAR_BENCH["batch_size"],
                                         num_epochs=INMEM_EPOCHS, seed=INMEM_SEED, device="cuda")
    with make_batch_reader(scalar_url, reader_pool_type="thread", workers_count=3,
                           shuffle_row_groups=False) as reader:
        on_cpu = InMemBatchedDataLoader(reader, batch_size=SCALAR_BENCH["batch_size"],
                                        num_epochs=INMEM_EPOCHS, seed=INMEM_SEED, device="cpu")
    t0 = time.perf_counter()
    staged = [batch for batch in on_card]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    rows = sum(len(b["f0"]) for b in staged)
    equal = sum(all(torch.equal(got[k].cpu(), want[k]) for k in want)
                for got, want in zip(staged, on_cpu))
    log(f"[columnar] scalar in memory, {INMEM_EPOCHS} epochs -> cuda: {rows} rows in {wall:.3f} s: "
        f"{rows / wall:.1f} rows/s, {rows * SCALAR_ROW_BYTES / 1e6 / wall:.1f} MB/s; "
        f"{equal}/{len(staged)} batches byte-equal to the CPU loader's")
    want_rows = INMEM_EPOCHS * (100_000 // SCALAR_BENCH["batch_size"]) * SCALAR_BENCH["batch_size"]
    if equal != len(staged) or rows != want_rows:
        failures.append(f"in memory: {equal}/{len(staged)} batches equal, {rows} rows")
    del staged, on_card, on_cpu

    # The tensor store at the converter's layout.
    t0 = time.perf_counter()
    tensor_url = generate_tensor_dataset(f"file://{tmp}/tensor", rows=TENSOR_ROWS,
                                         files=TENSOR_FILES, row_group_size=TENSOR_GROUP,
                                         list_size=TENSOR_LIST)
    tensor_groups = TENSOR_ROWS // TENSOR_GROUP
    on_disk = sum(os.path.getsize(f"{tmp}/tensor/part{k}.parquet") for k in range(TENSOR_FILES))
    ref = _tensor_reference(tensor_url)
    log(f"[columnar] tensor store: {TENSOR_ROWS} rows in {TENSOR_FILES} files of "
        f"{tensor_groups // TENSOR_FILES} groups, {on_disk / 1e6:.1f} MB on disk, "
        f"{sum(t.numel() * t.element_size() for t in ref.values()) / 1e6:.1f} MB of columns; "
        f"written and read for reference in {time.perf_counter() - t0:.3f} s")
    zero_copy = {}
    for pool_type in ("thread", "process"):
        r = _reader_alone(tensor_url, pool_type, COLUMNAR_WORKERS)
        log(_columnar_line(f"tensor reader alone, {pool_type} x{COLUMNAR_WORKERS}", r))
        if r["rows"] != TENSOR_ROWS:
            failures.append(f"tensor reader alone {pool_type}: {r['rows']} rows")
        if pool_type == "process":
            zero_copy_ok(f"tensor reader alone {pool_type}", r, tensor_groups)
            zero_copy["reader alone"] = r["counters"].get("zero_copy_batches", 0)
        loaders = [(f"BatchedDataLoader {kind}, {pool_type} x{COLUMNAR_WORKERS}",
                    COLUMNAR_WORKERS,
                    lambda reader, shuffle=shuffle: BatchedDataLoader(
                        reader, batch_size=COLUMNAR_BATCH, device="cuda", **shuffle))
                   for kind, shuffle in (("plain", {}), ("shuffled", COLUMNAR_SHUFFLE))]
        if pool_type == "process":
            loaders.append((f"InMemBatchedDataLoader load + 1 epoch, {pool_type} x{INMEM_WORKERS}",
                            INMEM_WORKERS,
                            lambda reader: InMemBatchedDataLoader(
                                reader, batch_size=COLUMNAR_BATCH, seed=INMEM_SEED,
                                device="cuda")))
        for name, workers, make_loader in loaders:
            r = _tensor_loader_epoch(tensor_url, pool_type, make_loader, ref, workers)
            what = f"tensor {name} -> cuda"
            log(_columnar_line(what, r) + f"; every row once {r['every_row_once']}, "
                f"{r['mismatches']} values differ from pyarrow's; {r['pinned']} records pinned, "
                f"rings kept past join {r['leaked']}")
            if r["rows"] != TENSOR_ROWS or not r["every_row_once"] or r["mismatches"]:
                failures.append(f"{what}: {r['rows']} rows, every row once "
                                f"{r['every_row_once']}, {r['mismatches']} values differ")
            if pool_type == "process":
                zero_copy_ok(what, r, tensor_groups)
                zero_copy[name] = r["counters"].get("zero_copy_batches", 0)
    del ref
    free_cuda()

    launches = dict(kernels.launch_counts)
    log(f"[columnar] kernel launches during the phase: {launches}; phase took "
        f"{time.perf_counter() - t_phase:.1f} s")
    if launches:
        failures.append(f"the columnar path launched kernels: {launches}")
    if failures:
        raise AssertionError("columnar path: " + "; ".join(failures))
    return zero_copy


def _tree_map(fn, node):
    if isinstance(node, dict):
        return {k: _tree_map(fn, v) for k, v in node.items()}
    if isinstance(node, list):
        return [_tree_map(fn, v) for v in node]
    return fn(node)


def _tree_leaves(node) -> list:
    if isinstance(node, dict):
        return [t for v in node.values() for t in _tree_leaves(v)]
    if isinstance(node, list):
        return [t for v in node for t in _tree_leaves(v)]
    return [node]


def fingerprint(images: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """One int64 per row: the row's pixels dotted with fixed random weights
    below 2^31 (no overflow: 150,528 x 255 x 2^31 < 2^63)."""
    return (images.reshape(images.shape[0], -1).to(torch.int64) * weights).sum(1)


class RowIds:
    """Row index in the store's file order, from a fingerprint of the
    decoded pixels (the store has no id column)."""

    def __init__(self, url: str):
        gen = torch.Generator().manual_seed(13)
        self.weights = torch.randint(1, 2 ** 31, (int(np.prod(IMAGE_SHAPE)),), generator=gen,
                                     dtype=torch.int64).to("cuda")
        with make_reader(url, shuffle_row_groups=False, workers_count=RESUME_WORKERS) as r:
            fps = torch.cat([fingerprint(b["image"], self.weights) for b in
                             DataLoader(r, batch_size=IMAGENET_BATCH, drop_last=False,
                                        device="cuda")]).tolist()
        self.table = {fp: i for i, fp in enumerate(fps)}
        if len(fps) != IMAGENET_ROWS or len(self.table) != len(fps):
            raise AssertionError(f"row fingerprints: {len(self.table)} distinct of {len(fps)}")

    def __call__(self, images: torch.Tensor) -> list:
        return [self.table[fp] for fp in fingerprint(images, self.weights).tolist()]


def augmented(images: torch.Tensor, step: int) -> torch.Tensor:
    """Phase 13's input tail: flip, crop and cutout drawn from a generator
    seeded ``(0, step)``, then K1 to bf16."""
    gen = augment.seeded_generator((0, step), images.device)
    x = augment.random_flip_horizontal(gen, images)
    x = augment.random_crop(gen, x, padding=AUG_PADDING)
    x = augment.cutout(gen, x, size=CUTOUT_SIZE)
    return normalize_images(x)


def _fresh_model(seed: int):
    init_opt, step = resnet.make_train_step(learning_rate=0.05)
    params = resnet.init_params(torch.Generator(device="cuda").manual_seed(seed),
                                IMAGENET_CLASSES, device="cuda")
    return params, init_opt(params), step


def _train_part(url, ids, model, first: int, count: int, resume_state=None, on_cut=None):
    """``count`` steps (global indices ``first``...) of the resume
    pipeline; returns the model, each step's row ids and loss, and whether
    the stream ended right after them. ``on_cut(loader, params, opt)`` runs
    before the reader stops."""
    params, opt, step = model
    rows, losses = [], []
    reader = make_reader(url, shuffle_row_groups=True, seed=0, workers_count=1,
                         resume_state=resume_state)
    with DataLoader(reader, batch_size=IMAGENET_BATCH, device="cuda") as loader:
        it = iter(loader)
        for s in range(first, first + count):
            batch = next(it)
            rows.append(ids(batch["image"]))
            params, opt, loss, _ = step(params, opt, {"image": augmented(batch["image"], s),
                                                      "label": batch["label"]})
            losses.append(loss.item())
        if on_cut is not None:
            on_cut(loader, params, opt)
        ended = next(it, None) is None
        it.close()
    return (params, opt, step), rows, losses, ended


def _cut_and_resume(url, pool: str, ids) -> dict:
    """A cut after ``RESUME_CUT`` batches and a resume, on ``pool``: every
    row not delivered before the cut must come back."""
    kw = dict(reader_pool_type=pool, workers_count=RESUME_WORKERS, shuffle_row_groups=True,
              seed=0)
    with make_reader(url, **kw) as r:
        loader = DataLoader(r, batch_size=IMAGENET_BATCH, drop_last=False, device="cuda")
        it = iter(loader)
        first = [i for _ in range(RESUME_CUT) for i in ids(next(it)["image"])]
        state = loader.state_dict()
        it.close()
    with make_reader(url, resume_state=state, **kw) as r:
        rest = [i for b in DataLoader(r, batch_size=IMAGENET_BATCH, drop_last=False,
                                      device="cuda") for i in ids(b["image"])]
    undelivered = set(range(IMAGENET_ROWS)) - set(first)
    lost = undelivered - set(rest)
    reread = len(set(first) & set(rest))
    log(f"[resume] {pool} x{RESUME_WORKERS}: cut after {len(first)} rows at {state}; the resume "
        f"read {len(rest)} rows: {len(lost)} lost, {reread} read again "
        f"({len(rest) - len(set(rest))} twice within the resume)")
    return {"lost": len(lost), "reread": reread, "dup": len(rest) - len(set(rest))}


def phase_resume(url: str, thread_bench: dict) -> dict:
    """Resume, the device cache and the augmentations (see the module
    docstring, phase 13). Returns K1's launches by name on (a) and (b)."""
    t_phase = time.perf_counter()
    failures = []
    free_cuda()
    ids = RowIds(url)
    log(f"[resume] {len(ids.table)} rows named by fingerprint in "
        f"{time.perf_counter() - t_phase:.2f} s")
    saved_cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kernels.reset_launch_counts()
    expected_k1 = 0

    # (a) Resume: the uninterrupted run, then a cut at step 3 and a restore.
    try:
        model, full_rows, full_losses, ended = _train_part(url, ids, _fresh_model(0), 0,
                                                           RESUME_STEPS)
        expected_k1 += RESUME_STEPS
        if not ended:
            failures.append("the uninterrupted epoch has more than 8 batches")
        del model
        free_cuda()
        saved = {}
        with tempfile.TemporaryDirectory() as ckpt_dir:
            mgr = CheckpointManager(ckpt_dir, max_to_keep=2)

            def on_cut(loader, params, opt):
                mgr.save(RESUME_CUT, {"model": _tree_map(torch.Tensor.detach, params),
                                      "opt": opt.state_dict()}, loader=loader)
                saved["params"] = [t.detach().clone() for t in _tree_leaves(params)]
                saved["momenta"] = [opt.state[p]["momentum_buffer"].clone()
                                    for p in resnet.param_leaves(params)]
                saved["cursor"] = loader.state_dict()

            model, cut_rows, cut_losses, _ = _train_part(url, ids, _fresh_model(0), 0,
                                                         RESUME_CUT, on_cut=on_cut)
            expected_k1 += RESUME_CUT
            del model
            free_cuda()
            # A model from another seed: only the restore can make it equal.
            params, opt, step = _fresh_model(1)
            state, cursor = mgr.restore(map_location="cuda")
            with torch.no_grad():
                for dst, src in zip(_tree_leaves(params), _tree_leaves(state["model"])):
                    dst.copy_(src)
            opt.load_state_dict(state["opt"])
            del state
            params_equal = all(torch.equal(a, b) for a, b in
                               zip(_tree_leaves(params), saved["params"]))
            momenta_equal = all(torch.equal(opt.state[p]["momentum_buffer"], m) for p, m in
                                zip(resnet.param_leaves(params), saved["momenta"]))
            log(f"[resume] checkpoint at step {RESUME_CUT}: {len(saved['params'])} parameter "
                f"tensors {'bit-equal' if params_equal else 'DIFFERENT'} after the restore, "
                f"{len(saved['momenta'])} momenta {'bit-equal' if momenta_equal else 'DIFFERENT'}; "
                f"cursor {cursor} (the loader's at the cut: {saved['cursor']}); steps kept "
                f"{mgr.all_steps()}")
            if not (params_equal and momenta_equal and cursor == saved["cursor"]):
                failures.append("the restored state differs from the saved one")
            del saved
            model, rest_rows, rest_losses, ended = _train_part(
                url, ids, (params, opt, step), RESUME_CUT, RESUME_STEPS - RESUME_CUT,
                resume_state=cursor)
            expected_k1 += RESUME_STEPS - RESUME_CUT
            del model, params, opt
            free_cuda()
        if not ended:
            failures.append("the resumed stream did not end after steps 4-8")
        if cut_rows != full_rows[:RESUME_CUT] or rest_rows != full_rows[RESUME_CUT:]:
            failures.append("the resumed rows are not the uninterrupted steps 4-8")
        rel = [abs(a - b) / abs(b) for a, b in zip(cut_losses + rest_losses, full_losses)]
        log(f"[resume] rows: steps 1-3 and resumed steps 4-8 "
            f"{'equal' if cut_rows + rest_rows == full_rows else 'DIFFERENT from'} the "
            f"uninterrupted run's (every step {IMAGENET_BATCH} distinct rows: "
            f"{all(len(set(r)) == IMAGENET_BATCH for r in full_rows)}; the epoch "
            f"{'every row once' if sorted(sum(full_rows, [])) == list(range(IMAGENET_ROWS)) else 'NOT every row once'})")
        log(f"[resume] losses uninterrupted {[f'{x:.6f}' for x in full_losses]}; cut and resumed "
            f"{[f'{x:.6f}' for x in cut_losses + rest_losses]}; |difference| / loss max "
            f"{max(rel):.3e} (bar {RESUME_LOSS_REL_BAR:g}; bit-equal at "
            f"{sum(a == b for a, b in zip(cut_losses + rest_losses, full_losses))} of "
            f"{RESUME_STEPS} steps)")
        if max(rel) > RESUME_LOSS_REL_BAR or not all(np.isfinite(full_losses + rest_losses)):
            failures.append(f"resumed losses {max(rel):.3e} from the uninterrupted run's")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_cudnn
    resume_pools = {pool: _cut_and_resume(url, pool, ids) for pool in ("thread", "process")}
    for pool, r in resume_pools.items():
        if r["lost"]:
            failures.append(f"{pool}: {r['lost']} rows lost across the resume")

    # (b) The device cache: load, check an epoch's rows, then train from it.
    free_cuda()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with make_reader(url, shuffle_row_groups=False, workers_count=RESUME_WORKERS) as r:
        cache = DeviceCachedDataset(r, device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    want_bytes = IMAGENET_ROWS * (int(np.prod(IMAGE_SHAPE)) + 4)
    epochs = [[] for _ in range(CACHE_EPOCHS)]
    steps_per_epoch = IMAGENET_ROWS // IMAGENET_BATCH
    order0 = torch.randperm(IMAGENET_ROWS, generator=augment.seeded_generator((0, 0), "cuda"),
                            device="cuda")
    gather_equal = None
    for i, b in enumerate(cache.batches(IMAGENET_BATCH, num_epochs=CACHE_EPOCHS, seed=0)):
        if i == 0:
            gather_equal = (torch.equal(b["image"], cache._data["image"][order0[:IMAGENET_BATCH]])
                            and torch.equal(b["label"],
                                            cache._data["label"][order0[:IMAGENET_BATCH]]))
        epochs[i // steps_per_epoch].extend(ids(b["image"]))
    once = all(sorted(e) == list(range(IMAGENET_ROWS)) for e in epochs)
    log(f"[cache] DeviceCachedDataset: {cache.num_rows} rows, columns {cache.columns}, "
        f"nbytes {cache.nbytes()} (want {want_bytes}), loaded in {load_s:.3f} s; every row once "
        f"per epoch: {once}; epochs in different orders: {epochs[0] != epochs[1]}; first "
        f"batch byte-equal to the cached rows at its indices: {gather_equal}")
    if cache.nbytes() != want_bytes or not once or epochs[0] == epochs[1] or not gather_equal:
        failures.append("the device cache's epochs are wrong")

    params, opt, step = _fresh_model(0)
    batches = cache.batches(IMAGENET_BATCH, num_epochs=CACHE_EPOCHS, seed=0)
    counter = iter(range(1 << 30))

    def run_step(batch):
        nonlocal params, opt
        params, opt, loss, _ = step(params, opt, {"image": augmented(batch["image"],
                                                                     next(counter)),
                                                  "label": batch["label"]})
        return loss

    timed = CACHE_EPOCHS * steps_per_epoch - 1
    first = next(batches)
    warm = run_step(first)
    loss_first, loss_last, wait_s, wall_s, resident_s = pipelined_window(
        run_step, lambda: next(batches), timed, CACHE_RESIDENT, warm_loss=warm)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    profile_step(lambda: run_step(first).item(), "ResNet-50 step from the device cache "
                 "(augmentations, K1)", IMAGE_GROUPS, top=8)
    expected_k1 += 1 + timed + CACHE_RESIDENT + 1
    cache_result = {"load_s": load_s, "nbytes": cache.nbytes(), "peak_gb": peak_gb,
                    "step_ms": 1e3 * (wall_s - wait_s) / timed, "wall_ms": 1e3 * wall_s / timed,
                    "samples_per_sec": timed * IMAGENET_BATCH / wall_s,
                    "resident_ms": 1e3 * resident_s, "wait_pct": 100 * wait_s / wall_s}
    log(f"[cache] ResNet-50 from the cache, {timed} timed steps of {IMAGENET_BATCH} with the "
        f"augmentations and K1 on the card: {cache_result['wall_ms']:.2f} ms a step on the wall, "
        f"{cache_result['step_ms']:.2f} ms less the batch waits ({cache_result['wait_pct']:.2f} % "
        f"waiting), {cache_result['samples_per_sec']:.1f} samples/s, resident "
        f"{cache_result['resident_ms']:.2f} ms; losses {loss_first:.4f} -> {loss_last:.4f}; "
        f"peak memory {peak_gb:.2f} GB. Phase 9 in this run (reader on {IMAGENET_WORKERS} "
        f"threads, / 255 and no augmentation): step {thread_bench['step_time_ms']:.2f} ms, "
        f"resident {thread_bench['step_time_ms_resident']:.2f} ms, "
        f"{thread_bench['samples_per_sec']:.1f} samples/s")
    if not (np.isfinite(loss_first) and np.isfinite(loss_last)):
        failures.append("non-finite loss from the cache")
    del params, opt, step, batches, first
    launches = dict(kernels.launch_counts)
    log(f"[resume] K1 launches over (a) and (b): {launches} (expected {expected_k1} on "
        f"{KERNEL_NAME}; the augmentations hand K1 contiguous batches, so none takes the "
        f"general route)")
    if launches != {KERNEL_NAME: expected_k1}:
        failures.append(f"K1 launches {launches}, expected {expected_k1}")

    # (c) Each augmentation on the card against the same apply on the CPU.
    images = next(cache.batches(IMAGENET_BATCH, shuffle=False))["image"]
    del cache
    free_cuda()
    gen = augment.seeded_generator((0, 1 << 20), "cuda")
    b = images.shape[0]
    draws = {"flip": augment.draw_flips(gen, b, device="cuda"),
             "crop": augment.draw_crop_offsets(gen, b, AUG_PADDING, "cuda"),
             "cutout": augment.draw_cutout_centres(gen, b, *IMAGE_SHAPE[:2], "cuda"),
             "mixup": augment.draw_mixup_lam(gen, b, MIXUP_ALPHA, "cuda")}
    ops = {"flip": lambda x, d: augment.apply_flip(x, d),
           "crop": lambda x, d: augment.apply_crop(x, d, AUG_PADDING),
           "cutout": lambda x, d: augment.apply_cutout(x, d, CUTOUT_SIZE)}
    host = images.cpu()
    card_x, host_x = images, host
    for name, op in ops.items():
        card_x, host_x = op(card_x, draws[name]), op(host_x, draws[name].cpu())
        same = card_x.device.type == "cuda" and torch.equal(card_x.cpu(), host_x)
        log(f"[augment] {name} on the card {'bit-equal to' if same else 'DIFFERENT from'} the CPU "
            f"with the same draws")
        if not same:
            failures.append(f"{name} on the card differs from the CPU")
    labels = torch.arange(b) % IMAGENET_CLASSES
    mixed = augment.apply_mixup(normalize_images(card_x, out_dtype=torch.float32),
                                labels.cuda(), draws["mixup"], IMAGENET_CLASSES)
    want = augment.apply_mixup(normalize_images_plain(host_x, out_dtype=torch.float32), labels,
                               draws["mixup"].cpu(), IMAGENET_CLASSES)
    mix_err = max((g.cpu() - w).abs().max().item() for g, w in zip(mixed, want))
    log(f"[augment] mixup on the card against the CPU: max abs error {mix_err:.3e} (bar "
        f"{MIXUP_BAR:g})")
    if not mix_err <= MIXUP_BAR:
        failures.append(f"mixup {mix_err:.3e} from the CPU")
    del mixed, want, host, host_x
    (chain_ms,) = median_ms(lambda: augmented(images, 0), reps=10)
    log(f"[augment] flip + crop + cutout + K1 at {tuple(images.shape)}: {chain_ms:.3f} ms")
    del images, card_x

    # (d) The loader's spans in a profiler window, and its metrics.
    config = torch._C._profiler._ExperimentalConfig(profile_all_threads=True)
    with make_reader(url, workers_count=RESUME_WORKERS, seed=0) as r:
        loader = DataLoader(r, batch_size=IMAGENET_BATCH, device="cuda")
        it = iter(loader)
        next(it)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA],
                                    experimental_config=config) as prof:
            next(it)
            next(it)
            torch.cuda.synchronize()
        delivered = 3 + sum(1 for _ in it)
    names = [e.name for e in prof.events()]
    spans = {n: names.count(n) for n in ("petastorm_tpu.host_batch", "petastorm_tpu.stage")}
    metrics = loader.metrics.as_dict()
    want_metrics = {"batches": steps_per_epoch, "samples": IMAGENET_ROWS,
                    "bytes_staged": want_bytes}
    log(f"[metrics] spans in a two-batch profiler window: {spans}; loader.metrics after the pass "
        f"({delivered} batches delivered): {metrics}")
    if min(spans.values()) < 1 or delivered != steps_per_epoch \
            or {k: metrics[k] for k in want_metrics} != want_metrics:
        failures.append(f"spans {spans}, metrics {metrics}")
    log(f"[resume] phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("resume phase: " + "; ".join(failures))
    return {**launches, "cache": cache_result, "resume": resume_pools, "augment_ms": chain_ms}


def bucket_kept(value) -> bool:
    """``in_pseudorandom_split(SELECT_FRACTIONS, 0, ...)`` written out: md5
    of the value's string form modulo ``sys.maxsize`` below the first
    fraction's bound."""
    bucket = int(hashlib.md5(str(value).encode("utf-8")).hexdigest(), 16) % sys.maxsize
    return bucket < SELECT_FRACTIONS[0] * (sys.maxsize - 1)


def _parquet_files(url: str) -> list:
    root = url[len("file://"):]
    return sorted(os.path.join(d, f) for d, _, names in os.walk(root) for f in names
                  if f.endswith(".parquet"))


def _plain_selected_images(url: str) -> list:
    """(label, sha1 of the center crop) of every row of the store whose
    label the split keeps, from ``pyarrow.parquet``, cv2 and numpy alone,
    sorted."""
    import cv2
    import pyarrow.parquet as pq
    from concurrent.futures import ThreadPoolExecutor
    top = (IMAGE_SHAPE[0] - SELECT_CROP) // 2

    def one(cell):
        label, blob = cell
        image = cv2.cvtColor(cv2.imdecode(np.frombuffer(blob, np.uint8), cv2.IMREAD_UNCHANGED),
                             cv2.COLOR_BGR2RGB)
        crop = np.ascontiguousarray(image[top:top + SELECT_CROP, top:top + SELECT_CROP])
        return label, hashlib.sha1(crop.tobytes()).hexdigest()

    cells = []
    for path in _parquet_files(url):
        table = pq.read_table(path, columns=["label", "image"])
        cells += [c for c in zip(table.column("label").to_pylist(),
                                 table.column("image").to_pylist()) if bucket_kept(c[0])]
    with ThreadPoolExecutor(os.cpu_count()) as pool:
        return sorted(pool.map(one, cells))


def _select_image_reader(url: str, pool: str, predicate: bool = True):
    spec = TransformSpec(functools.partial(center_crop, field="image", size=SELECT_CROP),
                         edit_fields=[("image", np.uint8, (SELECT_CROP, SELECT_CROP, 3), False)])
    return make_reader(url, reader_pool_type=pool, workers_count=SELECT_WORKERS, seed=0,
                       transform_spec=spec,
                       predicate=in_pseudorandom_split(SELECT_FRACTIONS, 0, "label")
                       if predicate else None)


def _rows_per_s(make, rows_of) -> tuple:
    """(rows, rows/s, rows/s after the first batch) of one epoch of
    ``make()`` (a loader in a ``with``) onto the card: every row over the
    time from the call to the last batch's arrival, then the rows after the
    first batch over the time from its arrival to the last's (the workers'
    start-up left out)."""
    rows = first = 0
    t0 = time.perf_counter()
    with make() as loader:
        for batch in loader:
            if not rows:
                t_first = time.perf_counter()
                first = rows_of(batch)
            rows += rows_of(batch)
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    return rows, rows / (t_end - t0), (rows - first) / (t_end - t_first)


def _write_partitioned_scalar(url: str) -> dict:
    """Phase 12's scalar schema (16 float32, 4 int64 columns from
    ``default_rng(0)``, groups of 2048) with an int32 ``part`` column, row
    ``i`` in ``part = i % 4``, written by the package's writer with
    ``partition_by=["part"]``; returns the columns."""
    rng = np.random.default_rng(0)
    n = SELECT_SCALAR_ROWS
    cols = {f"f{i}": rng.standard_normal(n).astype(np.float32) for i in range(16)}
    cols.update({f"i{i}": rng.integers(0, 1000, n).astype(np.int64) for i in range(4)})
    cols["part"] = (np.arange(n) % SELECT_PARTS).astype(np.int32)
    schema = Unischema("ScalarParts",
                       [UnischemaField(k, v.dtype.type, ()) for k, v in cols.items()])
    names = list(cols)
    with materialize_dataset_local(url, schema, rows_per_row_group=2048,
                                   partition_by=["part"]) as w:
        for i in range(n):
            w.write_row({k: cols[k][i] for k in names})
    return cols


def _sorted_rows(batches: list) -> np.ndarray:
    """Every row of host batches as bytes, sorted: the batches' multiset."""
    names = sorted(batches[0])
    rows = np.concatenate([np.concatenate([b[k].reshape(len(b[k]), -1).view(np.uint8)
                                           for k in names], axis=1) for b in batches])
    return np.sort(rows.view(np.dtype((np.void, rows.shape[1]))).ravel())


def phase_selection(image_url: str, token_url: str, tmp: str) -> dict:
    """Row-group selection and worker transforms (see the module
    docstring, phase 14). Returns the launches by kernel name."""
    t_phase = time.perf_counter()
    failures = []
    free_cuda()

    # (a) The image path: split by label, center crop, K1, ResNet-50 SGD.
    t0 = time.perf_counter()
    want = _plain_selected_images(image_url)
    log(f"[select] plain filter and crop of the store: {len(want)} of {IMAGENET_ROWS} rows kept "
        f"in {time.perf_counter() - t0:.2f} s")
    k1 = 0
    for pool in ("thread", "process"):
        params, opt, step = _fresh_model(0)
        got, losses, batches, shapes, k1_err = [], [], 0, set(), 0.0
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        with _select_image_reader(image_url, pool) as reader:
            for batch in DataLoader(reader, batch_size=IMAGENET_BATCH, drop_last=False,
                                    device="cuda"):
                images = normalize_images(batch["image"])
                batches += 1
                shapes.add(tuple(batch["image"].shape))
                # K1 at this path's shapes (the last batch is short), against
                # its plain version on the same batch: bit-equal.
                try:
                    k1_err = max(k1_err, check_close(
                        images, normalize_images_plain(batch["image"]),
                        f"image path {pool}, batch {batches}"))
                except AssertionError as e:
                    failures.append(str(e))
                if len(losses) < SELECT_STEPS:
                    params, opt, loss, _ = step(params, opt, {"image": images,
                                                              "label": batch["label"]})
                    losses.append(loss)
                got += [(label, hashlib.sha1(image.tobytes()).hexdigest()) for label, image in
                        zip(batch["label"].tolist(), batch["image"].cpu().numpy())]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(kernels.launch_counts)
        losses = [x.item() for x in losses]
        k1 += launches.get(KERNEL_NAME, 0)
        log(f"[select] image path on {pool} x{SELECT_WORKERS}: {len(got)} rows in {batches} "
            f"batches of {IMAGENET_BATCH} ({SELECT_CROP}x{SELECT_CROP}) in {wall:.2f} s, "
            f"ResNet-50 losses {[round(x, 4) for x in losses]}; launches {launches}; K1 on "
            f"{sorted(shapes)} against the plain version: max abs err {k1_err} (bit-equal is "
            f"the bar); rows {'equal to' if sorted(got) == want else 'DIFFERENT from'} the "
            f"plain filter and crop")
        if launches != {KERNEL_NAME: batches}:
            failures.append(f"image path {pool}: launches {launches} for {batches} batches")
        if sorted(got) != want:
            failures.append(f"image path {pool}: rows differ from the plain filter and crop")
        if len(losses) != SELECT_STEPS or not np.all(np.isfinite(losses)):
            failures.append(f"image path {pool}: losses {losses}")
        del params, opt, step
        free_cuda()
    rates = {}
    for pool in ("thread", "process"):
        for predicate in (True, False):
            rows, rate, after_first = _rows_per_s(
                lambda: DataLoader(_select_image_reader(image_url, pool, predicate),
                                   batch_size=IMAGENET_BATCH, drop_last=False, device="cuda"),
                lambda b: b["image"].shape[0])
            rates[f"image {pool} {'predicate' if predicate else 'no predicate'}"] = rate
            log(f"[select] crop{' + split' if predicate else ''} -> DataLoader(cuda), {pool} "
                f"x{SELECT_WORKERS}: {rows} rows, {rate:.1f} rows/s from the call, "
                f"{after_first:.1f} rows/s after the first batch")

    # (b) rowgroup_selector through a stored index, against the Parquet file.
    import pyarrow.parquet as pq
    build_rowgroup_index(image_url, [SingleFieldIndexer("label_ix", "label")])
    want_labels, want_groups = [], 0
    for path in _parquet_files(image_url):
        f = pq.ParquetFile(path)
        for g in range(f.num_row_groups):
            labels = f.read_row_group(g, columns=["label"]).column(0).to_pylist()
            if set(labels) & set(SELECT_LABELS):
                want_labels += labels
                want_groups += 1
    with make_reader(image_url, schema_fields=["label"], shuffle_row_groups=False,
                     workers_count=SELECT_WORKERS,
                     rowgroup_selector=SingleIndexSelector("label_ix", SELECT_LABELS)) as reader:
        got_labels = [int(r.label) for r in reader]
    log(f"[select] rowgroup_selector label in {SELECT_LABELS}: {len(got_labels)} rows, "
        f"{want_groups} groups hold one of the labels in the file; the rows "
        f"{'equal' if got_labels == want_labels else 'DIFFER from'} those groups' rows")
    if got_labels != want_labels or not want_groups:
        failures.append("rowgroup_selector read other groups than the file's")

    # (c) The token path: two shards, two subsets, then K2 on one shard.
    def window_starts(**kw) -> list:
        ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                      timestamp_field="ts", timestamp_overlap=False, dense=True)
        with make_reader(token_url, schema_fields=ngram, workers_count=TOKEN_WORKERS,
                         **kw) as reader:
            return [int(w["ts"][0]) for w in reader]

    every = window_starts(shuffle_row_groups=False)
    shards = [window_starts(cur_shard=k, shard_count=2, shard_seed=SELECT_SHARD_SEED, seed=0)
              for k in range(2)]
    half = TOKEN_WINDOWS // 2
    halves = [window_starts(rowgroup_subset=list(range(k * half, (k + 1) * half)),
                            shuffle_row_groups=False) for k in range(2)]
    log(f"[select] token windows by first timestamp: all {every}; shards (shard_seed "
        f"{SELECT_SHARD_SEED}) {shards}; rowgroup_subset halves {halves}")
    for what, parts in (("shards", shards), ("subset halves", halves)):
        if set(parts[0]) & set(parts[1]) or sorted(parts[0] + parts[1]) != sorted(every):
            failures.append(f"token {what} {parts} do not split {every}")
    if halves != [every[:half], every[half:]] \
            or every != [i * WINDOW for i in range(TOKEN_WINDOWS)]:
        failures.append(f"rowgroup_subset halves {halves} out of the subsets' order")
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), LLAMA, device="cuda")
    attn_fn = make_flash_attention(causal=True)
    ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    kernels.reset_launch_counts()
    losses, forwards = [], 0
    with torch.inference_mode(), make_reader(token_url, schema_fields=ngram, cur_shard=0,
                                             shard_count=2, shard_seed=SELECT_SHARD_SEED,
                                             seed=0, workers_count=TOKEN_WORKERS) as reader:
        for batch in DataLoader(reader, batch_size=TOKEN_BATCH, device="cuda"):
            losses.append(llama.loss_fn(params, {"tokens": batch["token"]}, LLAMA,
                                        attn_fn=attn_fn, compute_dtype=torch.bfloat16,
                                        shift="roll").item())
            forwards += 1
    k2 = dict(kernels.launch_counts)
    log(f"[select] shard 0's windows through LlamaConfig(n_layers={LLAMA.n_layers}) on K2: "
        f"{forwards} forwards, losses {[round(x, 4) for x in losses]}; launches {k2}")
    if k2 != {flash_attn.KERNEL_NAME: LLAMA.n_layers * forwards} or \
            forwards != len(shards[0]) // TOKEN_BATCH or not np.all(np.isfinite(losses)):
        failures.append(f"token shard: {forwards} forwards, launches {k2}, losses {losses}")
    del params
    free_cuda()

    # (d) The columnar path: partition filters, a predicate, a pandas transform.
    t0 = time.perf_counter()
    scalar_url = f"file://{tmp}/scalar_parts"
    cols = _write_partitioned_scalar(scalar_url)
    keep = np.isin(cols["part"], list(SELECT_KEEP_PARTS)) & (cols["i0"] >= SELECT_I0[0]) \
        & (cols["i0"] < SELECT_I0[1])
    log(f"[select] wrote {SELECT_SCALAR_ROWS} rows of the scalar schema in {SELECT_PARTS} hive "
        f"partitions in {time.perf_counter() - t0:.2f} s; numpy keeps {int(keep.sum())}")
    spec = TransformSpec(functools.partial(add_sum_column, name="total", left="i0", right="f0"),
                         edit_fields=[("total", np.float64, (), False)])

    def columnar(pool, device, predicate=True):
        reader = make_batch_reader(
            scalar_url, reader_pool_type=pool, workers_count=SCALAR_WORKERS[pool], seed=0,
            filters=[("part", "in", SELECT_KEEP_PARTS)], transform_spec=spec,
            predicate=in_range("i0", *SELECT_I0) if predicate else None)
        return BatchedDataLoader(reader, batch_size=SCALAR_BENCH["batch_size"], drop_last=False,
                                 device=device)

    for pool in SCALAR_WORKERS:
        with columnar(pool, "cuda") as loader:
            on_card = [{k: v.cpu().numpy() for k, v in b.items()} for b in loader]
        with columnar(pool, "cpu") as loader:
            on_cpu = [{k: v.numpy().copy() for k, v in b.items()} for b in loader]
        if pool == "thread":
            same = len(on_card) == len(on_cpu) and all(
                g.keys() == w.keys() and all(g[k].dtype == w[k].dtype
                                             and g[k].tobytes() == w[k].tobytes() for k in w)
                for g, w in zip(on_card, on_cpu))
        else:   # processes deliver in the order their workers finish
            same = np.array_equal(_sorted_rows(on_card), _sorted_rows(on_cpu))
        rows = sum(len(b["total"]) for b in on_card)
        total_ok = all(np.array_equal(b["total"], b["i0"] + b["f0"].astype(np.float64))
                       for b in on_card)
        log(f"[select] columnar, {pool} x{SCALAR_WORKERS[pool]}: {rows} rows in {len(on_card)} "
            f"batches on the card, {'byte-equal to' if same else 'DIFFERENT from'} the CPU "
            f"loader's; columns {sorted(on_card[0])}; total = i0 + f0 {total_ok}")
        if not same or rows != int(keep.sum()) or not total_ok:
            failures.append(f"columnar {pool}: equal {same}, {rows} rows of {int(keep.sum())}, "
                            f"total {total_ok}")
        for predicate in (True, False):
            n, rate, after_first = _rows_per_s(lambda: columnar(pool, "cuda", predicate),
                                               lambda b: len(b["total"]))
            rates[f"columnar {pool} {'predicate' if predicate else 'no predicate'}"] = rate
            log(f"[select] filters{' + predicate' if predicate else ''} + pandas transform -> "
                f"BatchedDataLoader(cuda), {pool} x{SCALAR_WORKERS[pool]}: {n} rows, "
                f"{rate:.1f} rows/s from the call, {after_first:.1f} rows/s after the first "
                f"batch")

    log(f"[select] phase took {time.perf_counter() - t_phase:.1f} s")
    if failures:
        raise AssertionError("selection phase: " + "; ".join(failures))
    return {KERNEL_NAME: k1, flash_attn.KERNEL_NAME: k2.get(flash_attn.KERNEL_NAME, 0),
            "rates": rates}


def _det_image_run(url, ids, pool, model, first, count, k1_errs, resume_state=None,
                   on_cut=None):
    """``count`` ResNet-50 steps (global indices ``first``...) on phase 9's
    store read in plan order (``DET_WINDOW``, ``DET_SEED``) on ``pool``: K1
    on every batch, held against ``normalize_images_plain`` of the same
    batch. Returns the model and each step's row ids, labels and loss."""
    params, opt, step = model
    rows, labels, losses = [], [], []
    reader = make_reader(url, reader_pool_type=pool, workers_count=IMAGENET_WORKERS,
                         shuffle_row_groups=True, seed=DET_SEED, sample_order="deterministic",
                         shuffle_window=DET_WINDOW, resume_state=resume_state)
    with DataLoader(reader, batch_size=IMAGENET_BATCH, device="cuda") as loader:
        it = iter(loader)
        for s in range(first, first + count):
            batch = next(it)
            images = normalize_images(batch["image"])
            k1_errs.append(check_close(images, normalize_images_plain(batch["image"]),
                                       f"K1 on {pool}, step {s + 1}"))
            rows.append(ids(batch["image"]))
            labels.append(batch["label"].tolist())
            params, opt, loss, _ = step(params, opt, {"image": images, "label": batch["label"]})
            losses.append(loss.item())
        if on_cut is not None:
            on_cut(loader, params, opt)
        it.close()
    return (params, opt, step), rows, labels, losses


def _tensor_epoch(url: str, pool: str, order: str, keep: bool) -> dict:
    """One epoch of phase 12's tensor store through ``make_batch_reader``
    (``sample_order=order``, seed 0) and ``BatchedDataLoader(1024)`` onto the
    card: rows, seconds from the call and from the first batch, the reader's
    counters, and the batches when ``keep``."""
    rows, batches = 0, []
    t0 = time.perf_counter()
    with make_batch_reader(url, reader_pool_type=pool, workers_count=COLUMNAR_WORKERS, seed=0,
                           sample_order=order) as reader:
        for batch in BatchedDataLoader(reader, batch_size=COLUMNAR_BATCH, device="cuda"):
            if not rows:
                t_first = time.perf_counter()
            rows += len(batch["id"])
            if keep:
                batches.append(batch)
        del batch
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        gc.collect()
        out = {"rows": rows, "s": t_end - t0, "from_first_s": t_end - t_first,
               "counters": reader.counters,
               "pinned": reader.pool.pinned if pool == "process" else 0, "batches": batches}
    out["leaked"] = list(getattr(reader.pool, "leaked_rings", []))
    return out


def _token_ngram() -> NGram:
    return NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                 timestamp_field="ts", timestamp_overlap=False, dense=True)


def _token_mixture(urls, states=None, step=0) -> WeightedSamplingReader:
    """The two token stores as deterministic dense-NGram readers (seeds 0
    and 1), mixed ``MIX_PROBS`` with ``MIX_SEED``; resumed from ``states``
    and ``step`` when given."""
    members = [make_reader(url, schema_fields=_token_ngram(), workers_count=TOKEN_WORKERS,
                           num_epochs=None, sample_order="deterministic", seed=k,
                           resume_state=None if states is None else states[k])
               for k, url in enumerate(urls)]
    return WeightedSamplingReader(members, MIX_PROBS, seed=MIX_SEED, start_step=step)


def _cli(args: list, timeout: float = 600) -> dict:
    """``python -m petastorm_tpu_torch.benchmark.cli ... --json`` in a new
    interpreter; its JSON line."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (root, os.environ.get("PYTHONPATH")) if p))
    out = subprocess.run([sys.executable, "-m", "petastorm_tpu_torch.benchmark.cli", *args,
                          "--json"], cwd=root, env=env, capture_output=True, text=True,
                         timeout=timeout)
    if out.returncode != 0:
        raise AssertionError(f"cli {args}: rc {out.returncode}: {out.stderr[-2000:]}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def phase_epoch_plane(smi: str, image_url: str, token_url: str, tensor_url: str,
                      columnar: dict, tmp: str) -> dict:
    """The deterministic epoch plane and the throughput harness (see the
    module docstring, phase 15). Returns the launches by kernel name."""
    t_phase = time.perf_counter()
    failures = []
    free_cuda()
    card = f"({smi})"
    launches = {}

    # (a) ResNet-50 in plan order on processes and threads, and a cut.
    t0 = time.perf_counter()
    ids = RowIds(image_url)
    saved_cudnn = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    kernels.reset_launch_counts()
    k1_errs = []
    try:
        full = {}
        for pool in ("process", "thread"):
            model, rows, labels, losses = _det_image_run(image_url, ids, pool, _fresh_model(0), 0,
                                                         DET_STEPS, k1_errs)
            full[pool] = (rows, labels, losses)
            del model
            free_cuda()
        saved = {}
        with tempfile.TemporaryDirectory() as ckpt_dir:
            mgr = CheckpointManager(ckpt_dir)

            def on_cut(loader, params, opt):
                mgr.save(DET_CUT, {"model": _tree_map(torch.Tensor.detach, params),
                                   "opt": opt.state_dict()}, loader=loader)
                saved["cursor"] = loader.state_dict()

            model, cut_rows, cut_labels, cut_losses = _det_image_run(
                image_url, ids, "process", _fresh_model(0), 0, DET_CUT, k1_errs, on_cut=on_cut)
            del model
            free_cuda()
            params, opt, step = _fresh_model(1)
            state, cursor = mgr.restore(map_location="cuda")
            with torch.no_grad():
                for dst, src in zip(_tree_leaves(params), _tree_leaves(state["model"])):
                    dst.copy_(src)
            opt.load_state_dict(state["opt"])
            del state
            model, rest_rows, rest_labels, rest_losses = _det_image_run(
                image_url, ids, "thread", (params, opt, step), DET_CUT, DET_STEPS - DET_CUT,
                k1_errs, resume_state=cursor)
            del model, params, opt
            free_cuda()
    except AssertionError as e:   # K1 not bit-equal to its plain version
        failures.append(str(e))
        full, cursor = None, None
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved_cudnn
    launches[KERNEL_NAME] = kernels.launch_counts.get(KERNEL_NAME, 0)
    if full is not None:
        (p_rows, p_labels, p_losses), (t_rows, t_labels, t_losses) = full["process"], full["thread"]
        delivered = [i for r in p_rows for i in r]
        log(f"[epoch] (a) {card} ResNet-50, {DET_STEPS} steps of {IMAGENET_BATCH} in plan order "
            f"(seed {DET_SEED}, shuffle_window {DET_WINDOW} groups of 64): rows on 8 processes "
            f"{'equal to' if p_rows == t_rows else 'DIFFERENT from'} 8 threads', labels "
            f"{'equal' if p_labels == t_labels else 'DIFFERENT'}, {len(set(delivered))} distinct "
            f"rows of {len(delivered)}; losses processes {p_losses}, threads {t_losses}: "
            f"{'bit-equal' if p_losses == t_losses else 'NOT bit-equal'}")
        log(f"[epoch] (a) {card} cut at step {DET_CUT} on processes, cursor {cursor} (the loader's "
            f"{saved.get('cursor')}), resumed on threads: rows "
            f"{'equal to' if cut_rows + rest_rows == p_rows else 'DIFFERENT from'} the "
            f"uninterrupted run's, labels "
            f"{'equal' if cut_labels + rest_labels == p_labels else 'DIFFERENT'}, losses "
            f"{cut_losses + rest_losses}: "
            f"{'bit-equal' if cut_losses + rest_losses == p_losses else 'NOT bit-equal'}; K1 "
            f"against normalize_images_plain on all {len(k1_errs)} batches: max abs error "
            f"{max(k1_errs)}; launches {dict(kernels.launch_counts)}; "
            f"{time.perf_counter() - t0:.1f} s")
        if p_rows != t_rows or p_labels != t_labels or p_losses != t_losses:
            failures.append("(a) processes and threads delivered or trained differently")
        if len(set(delivered)) != len(delivered):
            failures.append("(a) a row was delivered twice in one epoch")
        if cut_rows + rest_rows != p_rows or cut_losses + rest_losses != p_losses:
            failures.append("(a) the cut and resumed run differs from the uninterrupted one")
        if not (cursor == saved.get("cursor") and cursor.get("sample_order") == "deterministic"
                and cursor.get("window") == DET_WINDOW
                and cursor.get("offset") == DET_CUT * IMAGENET_BATCH // 64):
            failures.append(f"(a) cursor {cursor}")
        if not np.all(np.isfinite(p_losses)):
            failures.append(f"(a) losses {p_losses}")
    want_k1 = 3 * DET_STEPS
    if dict(kernels.launch_counts) != {KERNEL_NAME: want_k1}:
        failures.append(f"(a) launches {dict(kernels.launch_counts)}, expected {want_k1} K1")

    # (b) The columnar path in plan order: zero-copy, equal bytes, the cost.
    t0 = time.perf_counter()
    groups = TENSOR_ROWS // TENSOR_GROUP
    kept, rates = {}, {}
    for pool in ("thread", "process"):
        # Timed with nothing kept; then one kept epoch for the bytes.
        for order in ("free", "deterministic", "kept"):
            keep = order == "kept"
            r = _tensor_epoch(tensor_url, pool, "deterministic" if keep else order, keep=keep)
            rate = r["rows"] / r["from_first_s"]
            if not keep:
                rates.setdefault(f"{pool} {order}", []).append(rate)
            zc = tuple(r["counters"].get(k, 0) for k in ("zero_copy_batches", "zero_copy_bytes"))
            log(f"[epoch] (b) {card} tensor store, BatchedDataLoader({COLUMNAR_BATCH}) -> cuda, "
                f"{pool} x{COLUMNAR_WORKERS}, {order}: {r['rows']} rows, {r['rows'] / r['s']:.1f} "
                f"rows/s from the call, {rate:.1f} rows/s from the first batch; zero-copy "
                f"batches {zc[0]}, bytes {zc[1]}; gate {r['counters'].get('units_reordered', '-')} "
                f"units reordered; {r['pinned']} records pinned, rings kept {r['leaked']}")
            if r["rows"] != TENSOR_ROWS:
                failures.append(f"(b) {pool} {order}: {r['rows']} rows")
            if pool == "process" and (zc[0] != groups or r["pinned"] or r["leaked"]):
                failures.append(f"(b) {pool} {order}: zero-copy {zc[0]} of {groups} groups, "
                                f"{r['pinned']} pinned, kept {r['leaked']}")
            if keep:
                kept[pool] = r["batches"]
    same = len(kept["thread"]) == len(kept["process"]) and all(
        g.keys() == w.keys() and all(torch.equal(_bits(g[k]), _bits(w[k])) for k in w)
        for g, w in zip(kept["process"], kept["thread"]))
    cost = {pool: statistics.mean(rates[f"{pool} deterministic"])
            / statistics.mean(rates[f"{pool} free"]) for pool in ("thread", "process")}
    log(f"[epoch] (b) {card} deterministic batches on processes "
        f"{'byte-equal to' if same else 'DIFFERENT from'} those on threads "
        f"({len(kept['process'])} batches, kept on the card); zero-copy in phase 12 on "
        f"processes: {columnar}; rows/s from the first batch, deterministic over free (turns "
        f"free, det, det, free, nothing kept): "
        f"threads {cost['thread']:.3f}x, processes {cost['process']:.3f}x; "
        f"{time.perf_counter() - t0:.1f} s")
    if not same:
        failures.append("(b) deterministic batches differ between the pools")
    del kept
    free_cuda()

    # (c) A 70/30 token mixture under Llama training, cut at step 2.
    t0 = time.perf_counter()
    url_b = f"file://{tmp}/tokens_b"
    write_token_store(url_b, windows=TOKEN_WINDOWS, window=WINDOW, vocab=LLAMA.vocab, seed=1)
    urls = (token_url, url_b)
    gen = torch.Generator().manual_seed(17)
    weights = torch.randint(1, 2 ** 20, (WINDOW,), generator=gen, dtype=torch.int64).to("cuda")

    def fingerprints(tokens: torch.Tensor) -> list:
        return (tokens.to(torch.int64) * weights).sum(-1).tolist()
    names = {}
    for tag, url in zip("ab", urls):
        with make_reader(url, schema_fields=_token_ngram(), shuffle_row_groups=False,
                         workers_count=TOKEN_WORKERS) as r:
            for w in r:
                (fp,) = fingerprints(torch.from_numpy(w["token"][None]).to("cuda"))
                names[fp] = f"{tag}{int(w['ts'][0]) // WINDOW}"
    if len(names) != 2 * TOKEN_WINDOWS:
        failures.append(f"(c) {len(names)} distinct windows of {2 * TOKEN_WINDOWS}")
    init_opt, step = llama.make_train_step(LLAMA, attn_fn=make_flash_attention(causal=True),
                                           shift="roll")

    def fresh():
        params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), LLAMA,
                                   device="cuda")
        return params, init_opt(params)

    def train(mix, params, opt, count):
        picks, tokens, losses = [], [], []
        with DataLoader(mix, batch_size=TOKEN_BATCH, device="cuda") as loader:
            it = iter(loader)
            for _ in range(count):
                batch = next(it)
                picks += [names.get(fp, "?") for fp in fingerprints(batch["token"])]
                tokens.append(batch["token"].clone())
                _, opt, loss = step(params, opt, {"tokens": batch["token"]})
                losses.append(loss.item())
            state = loader.state_dict()
            it.close()
        return picks, tokens, losses, state

    kernels.reset_launch_counts()
    params, opt = fresh()
    picks, tokens, losses, _ = train(_token_mixture(urls), params, opt, MIX_STEPS)
    del params, opt
    free_cuda()
    params, opt = fresh()
    cut_picks, cut_tokens, cut_losses, state = train(_token_mixture(urls), params, opt, MIX_CUT)
    # The input pipeline is torn down and rebuilt from its JSON-safe cursor;
    # the model goes on in memory.
    state = json.loads(json.dumps(state))
    rest_picks, rest_tokens, rest_losses, _ = train(
        _token_mixture(urls, WeightedSamplingReader.resume_states(state), state["step"]),
        params, opt, MIX_STEPS - MIX_CUT)
    del params, opt
    free_cuda()
    mix_launches = dict(kernels.launch_counts)
    want = {n: LLAMA.n_layers * 2 * MIX_STEPS for n in (
        flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME, flash_attn.BWD_DKV_KERNEL_NAME)}
    tokens_equal = all(torch.equal(a, b) for a, b in zip(cut_tokens + rest_tokens, tokens))
    log(f"[epoch] (c) {card} LlamaConfig(n_layers={LLAMA.n_layers}) AdamW on a {MIX_PROBS} mixture "
        f"of two token stores (seed {MIX_SEED}), {MIX_STEPS} steps of {TOKEN_BATCH} windows of "
        f"{WINDOW}: picks {picks}; cut at step {MIX_CUT} (mixer step {state['step']}, member "
        f"cursors {[(s['epoch'], s['offset']) for s in state['readers']]}) and resumed: picks "
        f"{cut_picks + rest_picks} "
        f"({'equal' if cut_picks + rest_picks == picks else 'DIFFERENT'}), "
        f"tokens {'bit-equal' if tokens_equal else 'DIFFERENT'}; losses {losses}, cut and "
        f"resumed {cut_losses + rest_losses}: "
        f"{'bit-equal' if cut_losses + rest_losses == losses else 'NOT bit-equal'}; launches "
        f"{mix_launches} (want {want}); {time.perf_counter() - t0:.1f} s")
    if cut_picks + rest_picks != picks or not tokens_equal or "?" in picks:
        failures.append("(c) the resumed mixture differs from the uninterrupted one")
    if cut_losses + rest_losses != losses or not np.all(np.isfinite(losses)):
        failures.append(f"(c) losses {losses} against {cut_losses + rest_losses}")
    if mix_launches != want:
        failures.append(f"(c) launches {mix_launches}, expected {want}")
    launches.update(mix_launches)

    # (d) The throughput CLI and the small benches on the card's host.
    t0 = time.perf_counter()
    hello = generate_hello_world_dataset(f"file://{tmp}/hello_world")
    ref = _cli([hello])
    log(f"[cli] {card} reference hello-world store (10 rows, 1 a group), thread x3, 200 warm-up "
        f"and 1000 measured rows: {json.dumps(ref)}; BASELINE.md's 709.84 samples/s is the "
        f"reference's on unspecified hardware (not a comparison)")
    t1 = time.perf_counter()
    steady = generate_hello_world_dataset(f"file://{tmp}/hello_steady", rows_count=HELLO_ROWS,
                                          rows_per_row_group=HELLO_GROUP)
    on_disk = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(f"{tmp}/hello_steady")
                  for f in fs)
    log(f"[cli] {card} steady-state store: wrote {HELLO_ROWS} rows, {HELLO_GROUP} a group, "
        f"{on_disk / 1e9:.3f} GB in {time.perf_counter() - t1:.1f} s")
    cli_rates = {"reference": ref}
    for label, args in (("python thread", ["-p", "thread"]), ("python process", ["-p", "process"]),
                        (f"torch thread, {DEVICE_STEP_MS} ms step",
                         ["-d", "torch", "--device-step-ms", str(DEVICE_STEP_MS)])):
        got = _cli([steady, *args])
        cli_rates[label] = got
        log(f"[cli] {card} steady-state store, -d {label}: {json.dumps(got)}")
    for label, got in cli_rates.items():
        if not got["samples_per_second"] > 0:
            failures.append(f"(d) cli {label}: {got}")
    step_ms = cli_rates[f"torch thread, {DEVICE_STEP_MS} ms step"]["device_step_ms_actual"]
    if step_ms is None or not 0.75 * DEVICE_STEP_MS <= step_ms <= 1.25 * DEVICE_STEP_MS:
        failures.append(f"(d) the {DEVICE_STEP_MS} ms step measured {step_ms} ms")
    sweep = loader_throughput_sweep(device="cuda")
    log(f"[bench] {card} loader_throughput_sweep -> cuda (50,000 rows of 128 float32): "
        f"{ {bs: round(r, 1) for bs, r in sweep.items()} } samples/s")
    transport = run_sweep()
    for row in transport:
        log(f"[bench] {card} transport {json.dumps(row)}")
    log("[bench] transport sweep\n" + to_markdown(transport))
    log(f"[cli] (d) took {time.perf_counter() - t0:.1f} s")

    log(f"[epoch] {card} phase took {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    if failures:
        raise AssertionError("epoch plane phase: " + "; ".join(failures))
    return {**launches, "cost": cost, "cli": cli_rates, "sweep": sweep, "transport": transport}


def _flash_exact(counts: dict, per_kernel: int) -> bool:
    """K2 "lse", K3 and K4 launched ``per_kernel`` times each, no FMA route."""
    return all(counts[n] == per_kernel for n in (flash_attn.KERNEL_NAME,
                                                 flash_attn.BWD_DQ_KERNEL_NAME,
                                                 flash_attn.BWD_DKV_KERNEL_NAME)) \
        and not any(v for n, v in counts.items() if n.endswith("_fma"))


def _row_keys(f0: np.ndarray, f1: np.ndarray) -> np.ndarray:
    """A scalar-store row's name: the bits of its f0 and f1 (the store has no
    id column; the pair is unique in the 100,000 rows, checked)."""
    return (f0.view(np.uint32).astype(np.uint64) << np.uint64(32)) | f1.view(np.uint32)


def _valid_rows(batch) -> torch.Tensor:
    n = next(iter(batch.values())).shape[0]
    return batch["__valid__"].cpu() if "__valid__" in batch else torch.ones(n, dtype=torch.bool)


def _scalar_rows(loader, ref: dict, index, kill_after=None, stop_on_recovered=False):
    """The store rows a scalar-store mesh loader delivers, in order, each
    batch's every column held bit for bit against ``ref`` (pyarrow's read)
    at those rows. Kills host ``MESH_SCALAR_KILL`` after ``kill_after``
    batches; with
    ``stop_on_recovered`` stops at the first cursor that carries
    ``recovered`` and returns it."""
    rows, state = [], None
    with loader:
        it = iter(loader)
        for b, batch in enumerate(it):
            valid = _valid_rows(batch)
            host = {k: v.cpu()[valid].numpy() for k, v in batch.items() if k != "__valid__"}
            at = index(_row_keys(host["f0"], host["f1"]))
            for name, col in host.items():
                if not np.array_equal(col.view(np.uint8), ref[name][at].view(np.uint8)):
                    raise AssertionError(f"mesh batch {b}: column {name!r} differs from the store")
            rows.extend(at.tolist())
            if kill_after is not None and b + 1 == kill_after:
                loader.kill_host(MESH_SCALAR_KILL)
            if stop_on_recovered:
                state = loader.state_dict()
                if "recovered" in state:
                    it.close()
                    break
        report = loader.mesh_report()
    return rows, state, report


class _GatedReader:
    """A host's reader that hands out its first window, then waits for
    ``gate`` before the next: the host is certain to be mid-plan when it is
    killed, however fast the others read ahead."""

    def __init__(self, reader, gate):
        self._reader, self._gate = reader, gate
        self.batched_output = reader.batched_output

    def __iter__(self):
        for i, item in enumerate(self._reader):
            if i == 1 and not self._gate.wait(60.0):
                raise RuntimeError("the gated host was never released")
            yield item

    def state_dict(self):
        return self._reader.state_dict()

    def stop(self):
        self._gate.set()
        self._reader.stop()

    def join(self):
        self._reader.join()


class _GatedFactory(MeshReaderFactory):
    """Gates the reader of one host's primary plan (:class:`_GatedReader`)."""

    def __init__(self, url, ordinals, gate, **kwargs):
        super().__init__(url, **kwargs)
        self._ordinals, self._gate = list(ordinals), gate

    def __call__(self, rowgroup_subset):
        reader = super().__call__(rowgroup_subset)
        return (_GatedReader(reader, self._gate) if list(rowgroup_subset) == self._ordinals
                else reader)


def _train_windows(loader, cfg, kill_after=None, gate=None):
    """Train AdamW steps of ``cfg`` (flash attention) on every batch of
    ``loader`` (its valid windows), killing host ``MESH_TOKEN_KILL`` after
    ``kill_after`` steps and then opening ``gate`` -> (each window's first
    ts, the losses, the loader's ``mesh_report``)."""
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    init_opt, step = llama.make_train_step(cfg, shift="roll",
                                           attn_fn=make_flash_attention(causal=True))
    opt = init_opt(params)
    starts, losses = [], []
    with loader:
        for b, batch in enumerate(loader):
            valid = _valid_rows(batch).cuda()
            tokens = batch["token"][valid]
            starts.extend(batch["ts"][valid][:, 0].tolist())
            _, opt, loss = step(params, opt, {"tokens": tokens})
            losses.append(loss.item())
            if kill_after is not None and b + 1 == kill_after:
                loader.kill_host(MESH_TOKEN_KILL)
                gate.set()
        report = loader.mesh_report()
    del params, opt
    return starts, losses, report


def _digest(leaves) -> list:
    """sha1 of each tensor's bytes: equal digests are equal bits."""
    return [hashlib.sha1(t.detach().cpu().contiguous().view(torch.uint8).numpy()).hexdigest()
            for t in leaves]


def _rank_data_parallel(rank: int, world: int, url: str, model_kwargs: dict) -> dict:
    """Phase 16 (c) on one of ``world`` ranks sharing ``cuda:0``: the bench
    with ``mesh_ingest`` (launches and transfers counted), then a
    data-parallel loop of ``DP_STEPS`` steps whose rows, losses and final
    parameters are returned, and on rank 0 the first step held against one
    process on the ranks' first windows together and against the control."""
    out = {}
    cfg = llama.LlamaConfig(**model_kwargs)
    kernels.reset_launch_counts()
    comm.reset_transfer_stats()
    out["bench"] = run_llm_bench(url, steps=DP_BENCH_STEPS, batch_size=world, window=WINDOW,
                                 flash=True, model_kwargs=model_kwargs, mesh_ingest=True,
                                 device="cuda")
    out["bench_launches"] = _flash_counts()
    out["bench_transfers"] = {op: dict(v) for op, v in comm.transfer_stats.items()}
    free_cuda()

    group = make_mesh([-1], ["data"]).group("data")
    ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    loader = MeshDataLoader(MeshReaderFactory(url, schema_fields=ngram), batch_size=world, seed=0,
                            num_epochs=1, device="cuda")
    out["plan"] = loader.epoch_plan(0)[rank]
    p0 = llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    params = _tree_map(torch.Tensor.clone, p0)
    attn = make_flash_attention(causal=True)
    init_opt, step = llama.make_train_step(cfg, shift="roll", attn_fn=attn, data_group=group)
    opt = init_opt(params)
    starts, losses, step_ms, sums = [], [], [], []
    with loader:
        it = iter(loader)
        for i in range(DP_STEPS):
            batch = next(it)
            tokens = batch["token"]
            starts.append(int(batch["ts"][0, 0]))
            comm.reset_transfer_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, opt, loss = step(params, opt, {"tokens": tokens})
            losses.append(loss.item())   # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            sums.append(dict(comm.transfer_stats["all_reduce"]))
            if i == 0:
                first_tokens = tokens.cpu()
                after1 = [t.detach().clone() for t in llama.param_leaves(params)]
        it.close()
    out.update(starts=starts, losses=losses, step_ms=step_ms, sums=sums,
               digest=_digest(llama.param_leaves(params)))
    gathered = [torch.empty_like(first_tokens) for _ in range(world)]
    dist.all_gather(gathered, first_tokens)
    out["first_tokens"] = gathered
    del params, opt, init_opt, step
    free_cuda()
    if rank == 0:
        p0_leaves = llama.param_leaves(p0)
        for label, tokens in (("one process on both windows", torch.cat(gathered)),
                              ("control: rank 0's window, no gradient sum", gathered[0])):
            params = _tree_map(torch.Tensor.clone, p0)
            init_opt, step = llama.make_train_step(cfg, shift="roll", attn_fn=attn)
            opt = init_opt(params)
            _, opt, loss = step(params, opt, {"tokens": tokens.cuda()})
            rel = [((a - r).norm() / (r - p).norm()).item()
                   for a, r, p in zip(after1, llama.param_leaves(params), p0_leaves)]
            out[label] = {"loss": loss.item(), "update_rel": rel}
            del params, opt, init_opt, step
            free_cuda()
    del p0, after1
    free_cuda()
    return out


def phase_mesh(smi: str, token_url: str, scalar_url: str, image_url: str,
               single_reader: dict) -> dict:
    """Data-parallel ingestion (see the module docstring, phase 16), beside
    phase 8's ``single_reader`` bench result. Returns the launches by kernel
    name."""
    import pyarrow.parquet as pq
    t_phase = time.perf_counter()
    card = f"({smi})"
    failures = []
    launches = {n: 0 for n in (KERNEL_NAME, flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
                               flash_attn.BWD_DKV_KERNEL_NAME)}

    def add(counts):
        for n in launches:
            launches[n] += counts.get(n, 0)

    # (a) Single-process mesh ingestion into the training path.
    t0 = time.perf_counter()
    free_cuda()
    kernels.reset_launch_counts()
    with CountingPlainVersions() as plain:
        result = run_llm_bench(token_url, steps=TRAIN_STEPS, batch_size=TOKEN_BATCH, window=WINDOW,
                               resident_steps=TRAIN_RESIDENT, flash=True,
                               model_kwargs=_llama_kwargs(LLAMA), mesh_ingest=True,
                               mesh_hosts=MESH_HOSTS, device="cuda")
    counts = _flash_counts()
    add(counts)
    steps = 1 + TRAIN_STEPS + TRAIN_RESIDENT
    report = result["mesh_report"]
    for key, value in result.items():
        log(f"[mesh] (a) {key}: {value}")
    log(f"[mesh] (a) {card} {MESH_HOSTS} hosts: {result['tokens_per_sec']} tokens/s, input stall "
        f"{result['input_stall_pct']} %, step {result['step_time_ms']} ms; phase 8's single "
        f"reader in this run: {single_reader.get('tokens_per_sec')} tokens/s, stall "
        f"{single_reader.get('input_stall_pct')} %, step {single_reader.get('step_time_ms')} ms; "
        f"launches "
        f"{counts} for {steps} steps of {LLAMA.n_layers} layers; plain calls {plain.calls}; "
        f"{time.perf_counter() - t0:.1f} s")
    if not LLM_KEYS | MESH_KEYS <= set(result):
        failures.append(f"(a) result keys lack {sorted(LLM_KEYS | MESH_KEYS - set(result))}")
    if not _flash_exact(counts, LLAMA.n_layers * steps) or any(plain.calls.values()):
        failures.append(f"(a) launches {counts}, plain calls {plain.calls}")
    groups = sum(h["rowgroups"] for h in report["per_host"].values())
    windows = sum(h["rows"] for h in report["per_host"].values())
    if report["hosts"] != MESH_HOSTS or report["reshard_events"] or report["hosts_lost"] \
            or groups != windows or windows < TOKEN_BATCH * steps:
        failures.append(f"(a) mesh_report {report}")
    if not (np.isfinite(result["loss_first"]) and np.isfinite(result["loss_last"])):
        failures.append(f"(a) losses {result['loss_first']}, {result['loss_last']}")
    free_cuda()

    # (b) Host loss and the cursor: the columnar store, then the token store.
    t0 = time.perf_counter()
    table = pq.read_table(scalar_url.replace("file://", ""))
    ref = {name: table.column(name).to_numpy() for name in table.column_names}
    keys = _row_keys(ref["f0"], ref["f1"])
    order = np.argsort(keys)
    if len(np.unique(keys)) != len(keys):
        raise AssertionError("the scalar store's (f0, f1) pairs are not unique")

    def index(k):
        at = np.searchsorted(keys[order], k)
        if not np.array_equal(keys[order][np.minimum(at, len(keys) - 1)], k):
            raise AssertionError("a delivered row is not in the store")
        return order[at]

    def scalar_loader(**kw):
        return MeshDataLoader(MeshReaderFactory(scalar_url, batched=True),
                              batch_size=MESH_SCALAR_BATCH, num_hosts=MESH_SCALAR_HOSTS, seed=0,
                              device="cuda", drop_last=False, pad_last=True, **kw)
    rows, _, report = _scalar_rows(scalar_loader(), ref, index, kill_after=1)
    seen = collections.Counter(rows)
    log(f"[mesh] (b) {card} scalar store, {MESH_SCALAR_HOSTS} hosts, batch {MESH_SCALAR_BATCH}, "
        f"host {MESH_SCALAR_KILL} killed after the first batch: {len(rows)} rows delivered, "
        f"{len(seen)} distinct, most {max(seen.values())} times; reshards "
        f"{report['reshard_events']}, lost {[h['host'] for h in report['hosts_lost']]}")
    if sorted(seen) != list(range(len(keys))) or max(seen.values()) != 1 \
            or report["reshard_events"] != 1 \
            or [h["host"] for h in report["hosts_lost"]] != [MESH_SCALAR_KILL]:
        failures.append(f"(b) kill: {len(seen)} distinct of {len(keys)}, most "
                        f"{max(seen.values())}, report {report}")
    first, state, _ = _scalar_rows(scalar_loader(), ref, index, kill_after=1,
                                   stop_on_recovered=True)
    rest, _, resumed = _scalar_rows(scalar_loader(resume_state=state), ref, index)
    again = collections.Counter(rest)
    overlap = len(set(first) & set(rest))
    log(f"[mesh] (b) {card} cursor after the reshard: {len(first)} rows before it, recovered "
        f"groups {state and state.get('recovered')}, hosts {state and state['hosts']}; the "
        f"resumed loader delivers {len(rest)} rows ({len(again)} distinct), {overlap} of them "
        f"also before the cut (groups in flight); together {len(set(first) | set(rest))} of "
        f"{len(keys)}")
    if not state or not state.get("recovered") or not state.get("resharded") \
            or set(first) | set(rest) != set(range(len(keys))) or max(again.values()) != 1 \
            or overlap > MESH_SCALAR_HOSTS * 2 * 2048 or resumed["reshard_events"]:
        failures.append(f"(b) resume: state {state}, {len(set(first) | set(rest))} of "
                        f"{len(keys)}, overlap {overlap}")

    ngram = NGram({o: ["ts", "token"] for o in range(WINDOW)}, delta_threshold=1,
                  timestamp_field="ts", timestamp_overlap=False, dense=True)
    plan = MeshDataLoader(MeshReaderFactory(token_url, schema_fields=ngram), batch_size=TOKEN_BATCH,
                          num_hosts=MESH_HOSTS, seed=0, device="cpu").epoch_plan(0)
    gate = threading.Event()
    token_loader = MeshDataLoader(_GatedFactory(token_url, plan[MESH_TOKEN_KILL], gate,
                                                schema_fields=ngram),
                                  batch_size=TOKEN_BATCH, num_hosts=MESH_HOSTS, seed=0,
                                  num_epochs=1, device="cuda", drop_last=False, pad_last=True)
    free_cuda()
    kernels.reset_launch_counts()
    starts, losses, report = _train_windows(token_loader, LLAMA, kill_after=1, gate=gate)
    counts = _flash_counts()
    add(counts)
    got = collections.Counter(starts)
    dups = sorted(s // WINDOW for s, n in got.items() if n > 1)
    log(f"[mesh] (b) {card} token store, {MESH_HOSTS} hosts, host {MESH_TOKEN_KILL} killed after "
        f"the first step: windows (first ts / {WINDOW}) {[s // WINDOW for s in starts]}, read "
        f"twice {dups} (host {MESH_TOKEN_KILL}'s plan {plan[MESH_TOKEN_KILL]}); {len(losses)} "
        f"steps, losses "
        f"{losses}; reshards {report['reshard_events']}; launches {counts}; "
        f"{time.perf_counter() - t0:.1f} s for (b)")
    if sorted(got) != [g * WINDOW for g in range(TOKEN_WINDOWS)] \
            or not set(dups) <= set(plan[MESH_TOKEN_KILL]) or report["reshard_events"] != 1 \
            or not np.isfinite(losses).all() \
            or not _flash_exact(counts, LLAMA.n_layers * len(losses)):
        failures.append(f"(b) token drill: windows {starts}, dups {dups}, report {report}, "
                        f"launches {counts}")
    free_cuda()

    # (c) Data parallelism over 2 ranks sharing cuda:0.
    t0 = time.perf_counter()
    dp_kwargs = _llama_kwargs(DP_LLAMA)
    ranks = run_ranks(_rank_data_parallel, DP_RANKS, args=(token_url, dp_kwargs), device="cuda")
    wall = time.perf_counter() - t0
    n = DP_LLAMA.n_layers
    plan = MeshDataLoader(MeshReaderFactory(token_url, schema_fields=ngram), batch_size=DP_RANKS,
                          num_hosts=DP_RANKS, seed=0, device="cpu").epoch_plan(0)
    for r, got in enumerate(ranks):
        bench = got["bench"]
        add(got["bench_launches"])
        sums = got["sums"]
        share = [s["seconds"] / (ms / 1e3) for s, ms in zip(sums, got["step_ms"])]
        log(f"[mesh] (c) {card} rank {r}: bench {bench['tokens_per_sec']} tokens/s (global batch "
            f"{bench['tokens_per_step']} tokens), stall {bench['input_stall_pct']} %, step "
            f"{bench['step_time_ms']} ms, devices {bench['devices']}, losses "
            f"{bench['loss_first']} -> {bench['loss_last']}; launches {got['bench_launches']}; "
            f"bench transfers {got['bench_transfers']}")
        log(f"[mesh] (c) {card} rank {r}: data-parallel loop, plan {got['plan']}, windows "
            f"(first ts / {WINDOW}) {[s // WINDOW for s in got['starts']]}, losses "
            f"{got['losses']}, step ms {got['step_ms']}; gloo gradient sum a step "
            f"{[(s['calls'], s['bytes'] / 1e9, s['seconds']) for s in sums]} (calls, GB, s), "
            f"{[round(100 * x, 2) for x in share]} % of the step")
        if got["plan"] != plan[r] or got["starts"] != [g * WINDOW for g in plan[r][:DP_STEPS]] \
                or not LLM_KEYS | MESH_KEYS <= set(bench) or bench["devices"] != DP_RANKS \
                or bench["tokens_per_step"] != DP_RANKS * WINDOW \
                or not _flash_exact(got["bench_launches"], n * (1 + DP_BENCH_STEPS)):
            failures.append(f"(c) rank {r}: plan {got['plan']}, windows {got['starts']}, "
                            f"launches {got['bench_launches']}, keys {sorted(bench)}")
    r0, r1 = ranks
    if not all(torch.equal(a, b) for a, b in zip(r0["first_tokens"], r1["first_tokens"])):
        failures.append("(c) the ranks gathered different first windows")
    if (r0["bench"]["loss_first"], r0["bench"]["loss_last"]) != \
            (r1["bench"]["loss_first"], r1["bench"]["loss_last"]) or r0["losses"] != r1["losses"]:
        failures.append(f"(c) the ranks' losses differ: {r0['losses']} {r1['losses']}")
    same = sum(a == b for a, b in zip(r0["digest"], r1["digest"]))
    if same != len(r0["digest"]):
        failures.append(f"(c) parameters bit-equal in {same} of {len(r0['digest'])} leaves")
    ref, ctrl = (r0[k] for k in ("one process on both windows",
                                 "control: rank 0's window, no gradient sum"))
    loss_rel = abs(r0["losses"][0] - ref["loss"]) / abs(ref["loss"])
    worst, worst_ctrl = max(ref["update_rel"]), min(ctrl["update_rel"])
    log(f"[mesh] (c) {card} {DP_RANKS} ranks, {wall:.1f} s with the spawn: parameters bit-equal "
        f"on the ranks in {same} of {len(r0['digest'])} leaves after {DP_STEPS} steps; first "
        f"step against one process on both windows: loss {r0['losses'][0]} vs {ref['loss']} "
        f"({loss_rel:.3g} relative, bar {DP_LOSS_REL_BAR}), |p_dp - p_one| / |p_one - p_0| "
        f"largest {worst:.4g} over the leaves (bar {DP_UPDATE_REL_BAR}); control (rank 0's "
        f"window, no sum): loss {ctrl['loss']}, smallest {worst_ctrl:.4g}, largest "
        f"{max(ctrl['update_rel']):.4g}")
    if loss_rel > DP_LOSS_REL_BAR or worst > DP_UPDATE_REL_BAR:
        failures.append(f"(c) data-parallel step: loss {loss_rel:.3g}, update {worst:.4g}")
    if worst_ctrl <= DP_UPDATE_REL_BAR:
        failures.append(f"(c) the control (no gradient sum) passed the bar: {worst_ctrl:.4g}")
    free_cuda()

    # (d) The image path through the mesh loader.
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    ids, batches = [], 0
    with MeshDataLoader(MeshReaderFactory(image_url), batch_size=BATCH, num_hosts=MESH_HOSTS,
                        device="cuda") as loader:
        for batch in loader:
            images = normalize_images(batch["image"])
            check_close(images, normalize_images_plain(batch["image"]), f"(d) batch {batches}")
            ids.extend(batch["id"].tolist())
            batches += 1
        report = loader.mesh_report()
    torch.cuda.synchronize()
    k1 = kernels.launch_counts.get(KERNEL_NAME, 0)
    launches[KERNEL_NAME] += k1
    log(f"[mesh] (d) {card} image store through {MESH_HOSTS} hosts: {batches} batches, "
        f"{len(set(ids))} distinct rows, {KERNEL_NAME} {k1} launches, bit-equal to the plain "
        f"version on every batch; {len(ids) / (time.perf_counter() - t0):.1f} rows/s; per host "
        f"{ {h: v['rows'] for h, v in report['per_host'].items()} }")
    if sorted(ids) != list(range(ROWS)) or k1 != ROWS // BATCH \
            or set(kernels.launch_counts) != {KERNEL_NAME}:
        failures.append(f"(d) {len(set(ids))} rows, launches {dict(kernels.launch_counts)}")
    log(f"[mesh] {card} phase took {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    if failures:
        raise AssertionError("mesh phase: " + "; ".join(failures))
    return launches


class _ReplayReader:
    """A reader stand-in that serves rows or ColumnarBatches read before, so
    that a loader's host batches can be timed without the decode: the
    shuffle and the collate alone."""

    def __init__(self, schema, items, lazy: bool):
        self.schema, self.ngram = schema, None
        self.row_materialization = "lazy" if lazy else "eager"
        self.batched_output = False
        self.last_row_consumed = False
        self._items = items
        self._it = iter(items)

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._it)

    def next_batch(self):
        return next(self._it)

    def state_dict(self):
        return {}


def _shuffle_collate_ms(url: str) -> dict:
    """Host ms a batch of ``DataLoader(batch_size=BATCH,
    shuffling_queue_capacity=LAZY_SHUFFLE, seed=0)``'s shuffle and collate
    alone, eager and lazy, over one epoch of phase 4's store read into
    memory first (rows, or one ColumnarBatch a row group), in turns."""
    items = {}
    for mode in ("eager", "lazy"):
        with make_reader(url, reader_pool_type="thread", workers_count=WORKERS, seed=0,
                         row_materialization=mode) as reader:
            items[mode] = list(reader) if mode == "eager" else list(_batches_of(reader))
            schema = reader.schema
    ms = {"eager": [], "lazy": []}
    for turn in range(LAZY_TURNS):
        for mode in (("eager", "lazy") if turn % 2 == 0 else ("lazy", "eager")):
            loader = DataLoader(_ReplayReader(schema, items[mode], mode == "lazy"),
                                batch_size=BATCH, shuffling_queue_capacity=LAZY_SHUFFLE, seed=0,
                                device="cpu")
            t0 = time.perf_counter()
            n = sum(1 for _ in loader._host_batches())
            ms[mode].append((time.perf_counter() - t0) * 1e3 / n)
    del items
    return ms


def _batches_of(reader):
    while True:
        try:
            yield reader.next_batch()
        except StopIteration:
            return


def _lazy_turn(url: str, pool: str, mode: str, failures: list) -> dict:
    """Phase 17 (a), one turn: 2 epochs of phase 4's store through
    ``make_reader(row_materialization=mode)`` on ``pool`` ->
    ``DataLoader(BATCH, shuffling_queue_capacity=LAZY_SHUFFLE, seed=0)`` ->
    K1 (bf16, held bit for bit to the plain version on every batch) ->
    phase 9's ResNet-50 SGD step: one warm-up step, LAZY_STEPS pipelined,
    the rest of the 2 epochs through K1 alone. Labels are ``id % 100``."""
    kernels.reset_launch_counts()
    params = resnet.init_params(torch.Generator(device="cuda").manual_seed(0),
                                IMAGENET_CLASSES, device="cuda")
    init_opt, raw_step = resnet.make_train_step(learning_rate=0.05)
    opt = init_opt(params)
    ids, batches = [], 0

    def staged():
        nonlocal batches
        batch = next(it)
        images = normalize_images(batch["image"])
        check_close(images, normalize_images_plain(batch["image"]),
                    f"(a) {pool} {mode} batch {batches}")
        ids.append(batch["id"])
        batches += 1
        return {"image": images, "label": batch["id"] % IMAGENET_CLASSES}

    def step(batch):
        nonlocal params, opt
        params, opt, loss, _ = raw_step(params, opt, batch)
        return loss

    t_call = time.perf_counter()
    with make_reader(url, reader_pool_type=pool, workers_count=WORKERS, seed=0, num_epochs=2,
                     row_materialization=mode) as reader:
        if reader.row_materialization != mode:
            failures.append(f"(a) {pool}: asked {mode}, reader is {reader.row_materialization}")
        loader = DataLoader(reader, batch_size=BATCH, shuffling_queue_capacity=LAZY_SHUFFLE,
                            seed=0, device="cuda")
        it = iter(loader)
        first = staged()
        t_first = time.perf_counter()
        loss = step(first)
        loss_first, loss_last, wait_s, wall, _ = pipelined_window(step, staged, LAZY_STEPS, 0,
                                                                  warm_loss=loss)
        for batch in it:
            images = normalize_images(batch["image"])
            check_close(images, normalize_images_plain(batch["image"]),
                        f"(a) {pool} {mode} batch {batches}")
            ids.append(batch["id"])
            batches += 1
        torch.cuda.synchronize()
        t_end = time.perf_counter()
    rows = torch.cat(ids).cpu()
    launches = kernels.launch_counts.get(KERNEL_NAME, 0)
    if launches != batches or set(kernels.launch_counts) != {KERNEL_NAME}:
        failures.append(f"(a) {pool} {mode}: launches {dict(kernels.launch_counts)} for "
                        f"{batches} batches")
    del params, opt, init_opt, raw_step, first
    return {"rows": rows, "launches": launches, "batches": batches,
            "rows_per_s": (len(rows) - BATCH) / (t_end - t_first),
            "first_batch_s": t_first - t_call,
            "samples_per_s": LAZY_STEPS * BATCH / wall, "stall_pct": 100.0 * wait_s / wall,
            "loss_first": loss_first, "loss_last": loss_last}


def _rank_resnet_dp(rank: int, world: int, image_url: str, slice_url: str) -> dict:
    """Phase 17 (b) and (c) on one of ``world`` ranks sharing ``cuda:0``.

    (b) ``run_imagenet_bench`` on the ranks (transfers counted); a
    data-parallel loop of DPR_LOOP bf16 steps (step ms, the gloo seconds
    by kind, digests of the parameters and moving statistics after it);
    the first loop batch's step in float32 (TF32 off, remat) with the
    cross-rank batch norm and with the per-rank control, and on rank 0 one
    process's step on the ranks' rows together.
    (c) ``DeviceCachedDataset(sharding=data_sharding(mesh))`` of phase 4's
    store: this rank's bytes, digests of its slices of CACHE_DP_EPOCHS
    epochs at BATCH (K1 on each, held to the plain version), and on rank 0
    digests of the unsharded cache's batches, split as the ranks split them."""
    from petastorm_tpu_torch.parallel.mesh import data_sharding, reader_shard_for_mesh
    out = {}
    comm.reset_transfer_stats()
    out["bench"] = run_imagenet_bench(image_url, steps=DPR_STEPS, per_device_batch=BATCH // world,
                                      workers_count=WORKERS // world, classes=IMAGENET_CLASSES,
                                      resident_steps=DPR_RESIDENT, device="cuda")
    out["bench_transfers"] = {op: dict(v) for op, v in comm.transfer_stats.items()}
    free_cuda()

    mesh = make_mesh([-1], ["data"])
    group = mesh.group("data")
    cur_shard, shard_count = reader_shard_for_mesh(mesh)
    p0 = resnet.init_params(torch.Generator(device="cuda").manual_seed(0), IMAGENET_CLASSES,
                            device="cuda")
    params = _tree_map(torch.Tensor.clone, p0)
    init_opt, step = resnet.make_train_step(learning_rate=0.05, data_group=group)
    opt = init_opt(params)
    losses, step_ms, gloo = [], [], []
    with make_reader(image_url, reader_pool_type="thread", workers_count=WORKERS // world, seed=0,
                     num_epochs=None, cur_shard=cur_shard, shard_count=shard_count) as reader:
        loader = DataLoader(reader, batch_size=BATCH // world, device="cuda",
                            sharding=data_sharding(mesh))
        it = iter(loader)
        for i in range(DPR_LOOP):
            staged = next(it)
            batch = {"image": staged["image"].float() / 255.0, "label": staged["label"]}
            if i == 0:
                first = {k: v.cpu() for k, v in staged.items()}
            comm.reset_transfer_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, opt, loss, _ = step(params, opt, batch)
            losses.append(loss.item())   # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            gloo.append({op: dict(v) for op, v in comm.transfer_stats.items()})
        it.close()
    out.update(losses=losses, step_ms=step_ms, gloo=gloo,
               digest=_digest(resnet.param_leaves(params)),
               stats_digest=_digest(_stat_leaves(params)))
    del params, opt, init_opt, step
    free_cuda()

    # The first loop batch in float32, TF32 off, remat: the cross-rank step,
    # the per-rank control, and one process on both ranks' rows.
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    apply_bf16 = resnet.apply
    resnet.apply = functools.partial(apply_bf16, compute_dtype=torch.float32)
    try:
        mine = {"image": first["image"].cuda().float() / 255.0, "label": first["label"].cuda()}
        after = {}
        for label in ("cross-rank batch norm", "control: per-rank batch norm"):
            params = _tree_map(torch.Tensor.clone, p0)
            cross = label.startswith("cross")
            init_opt, step = resnet.make_train_step(learning_rate=0.05, remat=True,
                                                    data_group=group if cross else None)
            opt = init_opt(params)
            if cross:
                _, _, loss, _ = step(params, opt, mine)
            else:
                loss, _ = resnet.loss_fn(params, mine, remat=True)
                loss.backward()
                grads = [t.grad for t in resnet.param_leaves(params)]
                comm.all_reduce_(grads, group)
                for g in grads:
                    g.div_(world)
                summed = loss.detach().clone()
                comm.all_reduce_([summed], group)
                loss = summed / world
                opt.step()
            after[label] = ([t.detach().clone() for t in resnet.param_leaves(params)],
                            loss.item())
            del params, opt, init_opt, step
            free_cuda()
        images = [torch.empty_like(first["image"]) for _ in range(world)]
        labels = [torch.empty_like(first["label"]) for _ in range(world)]
        dist.all_gather(images, first["image"])
        dist.all_gather(labels, first["label"])
        if rank == 0:
            whole = {"image": torch.cat(images).cuda().float() / 255.0,
                     "label": torch.cat(labels).cuda()}
            # One process on the 256 rows, then on the same rows in another
            # order: the second differs from the first only in summation
            # order, the noise floor of a float32 update.
            order = torch.randperm(len(whole["label"]), generator=torch.Generator().manual_seed(1))
            for label, rows in (("one process", whole),
                                ("one process, rows permuted",
                                 {k: v[order.cuda()] for k, v in whole.items()})):
                params = _tree_map(torch.Tensor.clone, p0)
                init_opt, step = resnet.make_train_step(learning_rate=0.05, remat=True)
                _, _, loss, _ = step(params, init_opt(params), rows)
                after[label] = ([t.detach().clone() for t in resnet.param_leaves(params)],
                                loss.item())
                del params, init_opt, step
            ref, ref_loss = after.pop("one process")
            p0_leaves = resnet.param_leaves(p0)
            for label, (leaves, got_loss) in after.items():
                rel = [((a - r).norm() / (r - p).norm()).item()
                       for a, r, p in zip(leaves, ref, p0_leaves)]
                out[label] = {"loss": got_loss, "ref_loss": ref_loss, "update_rel": rel}
            out["leaf_names"] = _leaf_names(p0)
            del whole, ref
    finally:
        resnet.apply = apply_bf16
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
    del p0, after, first, mine
    free_cuda()

    # (c) The sharded device cache.
    kernels.reset_launch_counts()
    comm.reset_transfer_stats()
    t0 = time.perf_counter()
    with make_reader(slice_url, reader_pool_type="thread", workers_count=WORKERS // world,
                     shuffle_row_groups=False) as reader:
        cache = DeviceCachedDataset(reader, device="cuda", sharding=data_sharding(mesh))
    load_s = time.perf_counter() - t0
    slices = []
    t0 = time.perf_counter()
    for b, batch in enumerate(cache.batches(BATCH, num_epochs=CACHE_DP_EPOCHS, seed=0)):
        check_close(normalize_images(batch["image"]), normalize_images_plain(batch["image"]),
                    f"(c) rank {rank} batch {b}")
        slices.append(_digest([batch["id"], batch["image"]]))
    torch.cuda.synchronize()
    out["cache"] = {"nbytes": cache.nbytes(), "shard_rows": cache.shard_rows,
                    "num_rows": cache.num_rows, "slices": slices, "load_s": load_s,
                    "serve_s": time.perf_counter() - t0,
                    "launches": dict(kernels.launch_counts),
                    "transfers": {op: dict(v) for op, v in comm.transfer_stats.items()}}
    del cache
    free_cuda()
    if rank == 0:
        with make_reader(slice_url, reader_pool_type="thread", workers_count=WORKERS // world,
                         shuffle_row_groups=False) as reader:
            whole = DeviceCachedDataset(reader, device="cuda")
        out["cache"]["whole_nbytes"] = whole.nbytes()
        out["cache"]["whole"] = [
            [_digest([batch["id"][s], batch["image"][s]])
             for s in (slice(0, BATCH // world), slice(BATCH // world, None))]
            for batch in whole.batches(BATCH, num_epochs=CACHE_DP_EPOCHS, seed=0)]
        del whole
        free_cuda()
    return out


def _leaf_names(params) -> list:
    """Names of ``resnet.param_leaves(params)``, in its order."""
    names = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}" if path else k)
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
        elif path.rsplit(".", 1)[-1] not in ("mean", "var"):
            names.append(path)

    walk(params, "")
    return names


def _stat_leaves(params) -> list:
    """Every batch norm's moving mean and variance, in a fixed order."""
    out = []

    def walk(node, key=None):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], k)
        elif isinstance(node, list):
            for v in node:
                walk(v)
        elif key in ("mean", "var"):
            out.append(node)

    walk(params)
    return out


def phase_lazy_dp(smi: str, slice_url: str, image_url: str) -> dict:
    """The lazy row plane and data-parallel ResNet-50 (see the module
    docstring, phase 17). Returns K1's launches."""
    t_phase = time.perf_counter()
    card = f"({smi})"
    failures = []
    k1 = 0

    # (a) Lazy against eager at full width, in turns.
    t0 = time.perf_counter()
    runs = {(pool, mode): [] for pool in LAZY_POOLS for mode in ("eager", "lazy")}
    want = torch.arange(ROWS).repeat(2).sort().values
    for turn in range(LAZY_TURNS):
        modes = ("eager", "lazy") if turn % 2 == 0 else ("lazy", "eager")
        for pool in LAZY_POOLS:
            for mode in modes:
                free_cuda()
                r = _lazy_turn(slice_url, pool, mode, failures)
                k1 += r["launches"]
                if not torch.equal(r.pop("rows").sort().values, want):
                    failures.append(f"(a) {pool} {mode} turn {turn}: the 2 epochs' ids are not "
                                    f"every row twice")
                runs[(pool, mode)].append(r)
    for (pool, mode), rs in runs.items():
        log(f"[lazy] (a) {card} {pool} x{WORKERS} {mode}: rows/s from the first batch "
            f"{[round(r['rows_per_s'], 1) for r in rs]}, first batch after "
            f"{[round(r['first_batch_s'], 2) for r in rs]} s; pipelined ResNet-50 "
            f"{[round(r['samples_per_s'], 1) for r in rs]} samples/s, input stall "
            f"{[round(r['stall_pct'], 1) for r in rs]} %; losses "
            f"{[(round(r['loss_first'], 4), round(r['loss_last'], 4)) for r in rs]}; "
            f"{rs[0]['batches']} batches and K1 launches a turn")
    ms = _shuffle_collate_ms(slice_url)
    log(f"[lazy] (a) {card} host ms a batch of shuffle + collate alone (one epoch replayed from "
        f"memory, batch {BATCH}, capacity {LAZY_SHUFFLE}): eager "
        f"{[round(x, 2) for x in ms['eager']]}, lazy {[round(x, 2) for x in ms['lazy']]}; "
        f"(a) took {time.perf_counter() - t0:.1f} s")
    free_cuda()

    # (b) and (c) on 2 ranks sharing cuda:0.
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_resnet_dp, DPR_RANKS, args=(image_url, slice_url), device="cuda")
    wall = time.perf_counter() - t0
    for r, got in enumerate(ranks):
        bench = got["bench"]
        share = []
        for g, ms_step in zip(got["gloo"], got["step_ms"]):
            s_bn = sum(g.get(k, {}).get("seconds", 0.0) for k in ("bn_stats", "bn_grad"))
            s_sum = g.get("all_reduce", {}).get("seconds", 0.0)
            share.append((round(s_bn, 4), round(s_sum, 4),
                          round(100 * (s_bn + s_sum) / (ms_step / 1e3), 1)))
        log(f"[lazy] (b) {card} rank {r}: bench {bench['samples_per_sec']} samples/s (global "
            f"batch {bench['global_batch']}, devices {bench['devices']}), per chip "
            f"{bench['samples_per_sec_per_chip']}, stall {bench['input_stall_pct']} %, step "
            f"{bench['step_time_ms']} ms, resident {bench.get('step_time_ms_resident')} ms, "
            f"gloo {bench['gloo_s']} s over {DPR_STEPS + DPR_RESIDENT} steps, losses "
            f"{bench['loss_first']} -> {bench['loss_last']}; transfers {got['bench_transfers']}")
        log(f"[lazy] (b) {card} rank {r}: data-parallel loop step ms "
            f"{[round(x, 1) for x in got['step_ms']]}, losses {got['losses']}; gloo a step "
            f"(batch norms s, gradient sum s, % of the step) {share}; calls "
            f"{ {k: v['calls'] for k, v in got['gloo'][-1].items()} }")
        if set(bench) != IMAGENET_KEYS | {"gloo_s"} or bench["devices"] != DPR_RANKS \
                or bench["global_batch"] != BATCH:
            failures.append(f"(b) rank {r}: bench keys {sorted(bench)}")
    r0, r1 = ranks
    if (r0["bench"]["loss_first"], r0["bench"]["loss_last"], r0["losses"]) != \
            (r1["bench"]["loss_first"], r1["bench"]["loss_last"], r1["losses"]):
        failures.append(f"(b) the ranks' losses differ: {r0['losses']} {r1['losses']}")
    same = sum(a == b for a, b in zip(r0["digest"], r1["digest"]))
    same_stats = sum(a == b for a, b in zip(r0["stats_digest"], r1["stats_digest"]))
    if same != len(r0["digest"]) or same_stats != len(r0["stats_digest"]):
        failures.append(f"(b) bit-equal on the ranks: parameters {same} of {len(r0['digest'])}, "
                        f"moving statistics {same_stats} of {len(r0['stats_digest'])}")
    cross, ctrl = r0["cross-rank batch norm"], r0["control: per-rank batch norm"]
    floor = r0["one process, rows permuted"]
    loss_rel = abs(cross["loss"] - cross["ref_loss"]) / abs(cross["ref_loss"])
    ctrl_loss_rel = abs(ctrl["loss"] - ctrl["ref_loss"]) / abs(ctrl["ref_loss"])
    worst, worst_ctrl = max(cross["update_rel"]), max(ctrl["update_rel"])
    names = r0["leaf_names"]
    for label, r in (("cross-rank", cross), ("rows permuted", floor), ("control", ctrl)):
        top = sorted(range(len(names)), key=lambda i: -r["update_rel"][i])[:4]
        log(f"[lazy] (b) {card} {label}: largest update distances "
            f"{[(names[i], round(r['update_rel'][i], 5)) for i in top]}; median "
            f"{statistics.median(r['update_rel']):.3g}")
    log(f"[lazy] (b) {card} {DPR_RANKS} ranks, {wall:.1f} s with the spawn: parameters bit-equal "
        f"on the ranks in {same} of {len(r0['digest'])} leaves, moving statistics in "
        f"{same_stats} of {len(r0['stats_digest'])}, after {DPR_LOOP} steps; first step in "
        f"float32 against one process on the {BATCH} rows: loss {cross['loss']} vs "
        f"{cross['ref_loss']} ({loss_rel:.3g} relative, bar {DPR_LOSS_REL_BAR}), "
        f"|p_dp - p_one| / |p_one - p_0| largest {worst:.4g} (bar {DPR_UPDATE_REL_BAR}); "
        f"control (per-rank batch norm): loss {ctrl['loss']} ({ctrl_loss_rel:.3g}), largest "
        f"{worst_ctrl:.4g}, smallest {min(ctrl['update_rel']):.4g}")
    if loss_rel > DPR_LOSS_REL_BAR or worst > DPR_UPDATE_REL_BAR:
        failures.append(f"(b) cross-rank step: loss {loss_rel:.3g}, update {worst:.4g}")
    if worst_ctrl <= DPR_UPDATE_REL_BAR and ctrl_loss_rel <= DPR_LOSS_REL_BAR:
        failures.append(f"(b) the control (per-rank batch norm) passed the bar: "
                        f"{worst_ctrl:.4g}, {ctrl_loss_rel:.3g}")

    c0, c1 = r0["cache"], r1["cache"]
    row_bytes = int(np.prod(IMAGE_SHAPE)) + 8   # the image and the int64 id
    half = -(-ROWS // DPR_RANKS) * row_bytes
    joined = [[a, b] for a, b in zip(c0["slices"], c1["slices"])]
    cache_k1 = sum(c["launches"].get(KERNEL_NAME, 0) for c in (c0, c1))
    k1 += cache_k1
    log(f"[lazy] (c) {card} sharded cache: {c0['nbytes']} + {c1['nbytes']} bytes on the ranks "
        f"(unsharded {c0['whole_nbytes']}), shard rows {c0['shard_rows']}; load "
        f"{c0['load_s']:.2f} / {c1['load_s']:.2f} s, {len(c0['slices'])} steps served in "
        f"{c0['serve_s']:.2f} / {c1['serve_s']:.2f} s; slices equal to the unsharded batches: "
        f"{joined == c0['whole']}; K1 {cache_k1} launches, bit-equal on every slice; "
        f"transfers rank 0 {c0['transfers']}")
    if c0["nbytes"] != half or c1["nbytes"] != half or c0["whole_nbytes"] != ROWS * row_bytes \
            or joined != c0["whole"] \
            or len(joined) != CACHE_DP_EPOCHS * ROWS // BATCH \
            or cache_k1 != DPR_RANKS * len(joined):
        failures.append(f"(c) sharded cache: bytes {c0['nbytes']}, {c1['nbytes']} (want {half}), "
                        f"equal {joined == c0['whole']}, launches {cache_k1}")
    log(f"[lazy] {card} phase took {time.perf_counter() - t_phase:.1f} s; K1 launches {k1}")
    if failures:
        raise AssertionError("lazy/data-parallel phase: " + "; ".join(failures))
    return {KERNEL_NAME: k1}


# ------------------------------------------------------------------ phase 18
def _tp_windows(url: str, count: int) -> list:
    """The first ``count`` windows of ``url`` in the order every rank reads
    them (phase 10's reader), on the card."""
    with DataLoader(token_windows(url, WINDOW), batch_size=1, device="cuda") as loader:
        it = iter(loader)
        windows = [next(it)["token"] for _ in range(count)]
        it.close()
    return windows


def _tp_params(cfg, mesh) -> dict:
    """This rank's slice of the weights drawn on the card from seed 0."""
    full = llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")
    params = llama.shard_params(full, llama.param_shardings(mesh, cfg), mesh)
    del full
    free_cuda()
    return params


def _routes(record: list) -> list:
    """A ``moe.record_routing`` record on the host: (kept per expert, dropped
    share, this rank's aux share) per call."""
    return [(s["kept"].tolist(), 1.0 - s["kept"].sum().item() / (s["top_k"] * s["tokens"]),
             s["aux"].item()) for s in record]


def _transfers() -> dict:
    return {op: dict(v) for op, v in comm.transfer_stats.items()}


def _router_unsummed(probs, group):
    """The control's ``moe.combine_weights``: the router's gradient left
    partial over the model group."""
    return probs


def _kv_heads_rolled(attn):
    """The control's attention: each query head meets the next KV head of
    its rank, as a head layout mismatched over the model axis would."""
    def rolled(q, k, v):
        return attn(q, k.roll(1, dims=2), v.roll(1, dims=2))
    rolled.supports_gqa = attn.supports_gqa
    return rolled


class _GradKeeper:
    """An optimizer for ``make_train_step``'s step that keeps the gradients
    the step summed (``grads``) and updates nothing."""

    def __init__(self, params):
        self.leaves, self.grads = llama.param_leaves(params), None

    def step(self):
        self.grads = [t.grad for t in self.leaves]

    def zero_grad(self, set_to_none=True):
        for t in self.leaves:
            t.grad = None


def _distances(got: list, want: list, split: list, group, world: int) -> torch.Tensor:
    """Squared distances of the model group's joined leaves of ``got`` from
    the whole leaves ``want`` sliced as ``got`` (host tensors): a split
    leaf's is the sum over the ranks' slices; each rank holds a replicated
    leaf whole (``world``, the group's size, is a power of 2: exact)."""
    d2 = torch.tensor([(g.detach() - w.cuda()).norm().item() ** 2 for g, w in zip(got, want)],
                      dtype=torch.float64)
    d2 = torch.where(torch.tensor(split), d2, d2 / world)
    dist.all_reduce(d2, group=group)
    return d2


def _rank_tensor_parallel(rank: int, world: int, url: str, part: str, ref: dict) -> dict:
    """Phase 18 on one of ``world`` ranks sharing ``cuda:0``. ``part`` "a":
    mesh (1, 1, world), TP_STEPS bf16 AdamW steps of TP_LLAMA (the main
    path), then the float32 first step and its control against the one
    process's update in ``ref``. ``part`` "b": mesh TP_COMPOSE_MESH, one
    bf16 step of TP_COMPOSE with ring attention, then one with Ulysses, then
    the float32 gradient of each and of the control against the one
    process's in ``ref``."""
    out = {}
    sizes = (1, 1, world) if part == "a" else TP_COMPOSE_MESH
    mesh = make_mesh(sizes, ("data", "seq", "model"))
    groups = dict(model_group=mesh.group("model"), seq_group=mesh.group("seq"),
                  data_group=mesh.group("data"))
    model_world = sizes[2]
    windows = _tp_windows(url, TP_STEPS if part == "a" else 1)
    if part == "a":
        runs = [("tensor parallel", TP_LLAMA, make_flash_attention(causal=True), windows)]
    else:
        runs = [(name, TP_COMPOSE, maker(mesh, head_axis="model", local_attn="flash"),
                 windows[:1])
                for name, maker in (("ring", make_ring_attention),
                                    ("ulysses", make_ulysses_attention))]
    for name, cfg, attn, batches in runs:
        t_run = time.perf_counter()
        params = _tp_params(cfg, mesh)
        init_opt, step = llama.make_train_step(cfg, attn_fn=attn, shift="roll", **groups)
        opt = init_opt(params)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        losses, step_ms, transfers, routes = [], [], [], []
        for tokens in batches:
            comm.reset_transfer_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with moe.record_routing() as record:
                opt, loss = step(params, opt, {"tokens": tokens})[1:]
                losses.append(loss.item())   # waits for the step
            step_ms.append((time.perf_counter() - t0) * 1e3)
            transfers.append(_transfers())
            routes += _routes(record)
        launches = {n: kernels.launch_counts.get(n, 0) for n in TP_KERNELS}
        out[name] = {"losses": losses, "step_ms": step_ms, "transfers": transfers,
                     "launches": launches, "routes": routes,
                     "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        del params, opt, init_opt, step
        free_cuda()
        out[name]["s"] = time.perf_counter() - t_run

    if part == "a":
        # The float32 first step (flash attention on its float32 route)
        # against the one process's update, and the control.
        cfg, reference = TP_LLAMA, ref["after"]
        checks = [(label, make_flash_attention(causal=True), combine)
                  for label, combine in (("float32", moe.combine_weights),
                                         ("control: router gradient unsummed", _router_unsummed))]
    else:
        # Each strategy's float32 gradient against the one process's, and
        # the control.
        cfg, reference = TP_COMPOSE, ref["compose_grads"]
        checks = [(label, attn(maker(mesh, head_axis="model", local_attn="flash")),
                   moe.combine_weights)
                  for label, maker, attn in (
                      ("ring float32", make_ring_attention, lambda a: a),
                      ("ulysses float32", make_ulysses_attention, lambda a: a),
                      ("control: ring, kv heads rolled", make_ring_attention, _kv_heads_rolled))]
    whole = llama.param_leaves(reference)
    want = llama.param_leaves(llama.shard_params(reference, llama.param_shardings(mesh, cfg), mesh))
    split = [w.shape != a.shape for w, a in zip(want, whole)]
    norms = torch.tensor(ref["update_norms" if part == "a" else "compose_grad_norms"])
    for label, attn, combine in checks:
        t_run = time.perf_counter()
        params = _tp_params(cfg, mesh)
        init_opt, step = llama.make_train_step(cfg, attn_fn=attn, shift="roll",
                                               compute_dtype=torch.float32, **groups)
        opt = init_opt(params)
        if part == "b":
            opt = _GradKeeper(params)
        # (a)'s float32 run takes every window: its routing by step is held
        # to one process's; the first step's result to the reference.
        losses, routes, rel = [], [], None
        saved, moe.combine_weights = moe.combine_weights, combine
        try:
            for tokens in windows if label == "float32" else windows[:1]:
                with moe.record_routing() as record:
                    losses.append(step(params, opt, {"tokens": tokens})[2].item())
                routes += _routes(record)
                if rel is None:
                    got = llama.param_leaves(params) if part == "a" else opt.grads
                    d2 = _distances(got, want, split, mesh.group("model"), model_world)
                    rel = (d2.sqrt() / norms).tolist()
                    del got
        finally:
            moe.combine_weights = saved
        del params, opt, init_opt, step
        free_cuda()
        out[label] = {"losses": losses, "routes": routes, "rel": rel,
                      "s": time.perf_counter() - t_run}
    return out


def _gloo_line(transfers: dict, step_ms: float) -> str:
    total = sum(v["seconds"] for v in transfers.values())
    return (f"{ {op: (v['calls'], round(v['bytes'] / 1e9, 4), round(v['seconds'], 4)) for op, v in sorted(transfers.items())} } "
            f"(calls, GB, s); {total:.3f} s, {100 * total / (step_ms / 1e3):.1f} % of the step")


def _rank_shape_kernels(gen, failures: list) -> None:
    """K2 ("lse"), K3 and K4 at a model rank's shape in (a) and a Ulysses
    rank's in (b), and K2 "stats" with the ring's K3 and K4 at a ring block
    of (b), against their plain versions with the row bars."""
    hd, seq = TP_LLAMA.head_dim, TP_COMPOSE_MESH[1]
    heads, kv_heads = TP_LLAMA.n_heads // TP_RANKS, TP_LLAMA.n_kv_heads // TP_RANKS
    for h, kv_h, what in ((heads, kv_heads, "a model rank's heads"),
                          (heads // seq, kv_heads // seq, "a Ulysses rank's heads")):
        shape = f"(1, {WINDOW}, {h}/{kv_h}, {hd})"
        (q, k, v), _, _, _ = check_flash(gen, 1, WINDOW, WINDOW, h, kv_h, hd, True,
                                         torch.bfloat16, f"{what} {shape} bf16 causal")
        o, lse = flash_attention_lse(q, k, v, causal=True)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)
        kernels.reset_launch_counts()
        got = flash_attention_bwd(q, k, v, o, lse, do, causal=True)
        counts = bwd_launches()
        _, ok = judge_grads(got, flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True),
                            False, f"{what} {shape}; launches {counts}")
        if not ok or counts != {flash_attn.TENSOR_CORES: (1, 1), flash_attn.FMA: (0, 0)}:
            failures.append(f"K3/K4 at {what} {shape}: launches {counts}")
        del q, k, v, o, lse, do, got
        free_cuda()

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    block = WINDOW // seq
    q = randn(1, block, heads, hd)
    k, v = randn(1, block, kv_heads, hd), randn(1, block, kv_heads, hd)
    for causal in (True, False):
        kernels.reset_launch_counts()
        o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=causal)
        counts = dict(kernels.launch_counts)
        worst, rms, m_err, l_err, ok = stats_verdict(
            (o, m.transpose(1, 2), l.transpose(1, 2)), flash_attn._stats_plain(q, k, v, causal),
            torch.bfloat16)
        log(f"[stats] a ring block of (b) (1, {block}, {heads}/{kv_heads}, {hd}) bf16 "
            f"{'causal' if causal else 'non-causal'} [launches {counts}]: o row-scaled worst "
            f"{worst:.3g} rms {rms:.3g}; m {m_err:.3g}; l relative {l_err:.3g}")
        if not ok or counts != {flash_attn.STATS_KERNEL_NAME: 1}:
            failures.append(f"K2 stats at a ring block, causal={causal}: launches {counts}")
    failures += ring_backward_check(q, k, v, randn)
    del q, k, v
    free_cuda()


def _one_process(token_url: str) -> dict:
    """The whole model in one process: TP_STEPS bf16 AdamW steps of
    TP_LLAMA on (a)'s windows and TP_STEPS float32 ones (losses and routing
    by step; the first float32 update is the one (a) is held to), and
    TP_COMPOSE's float32 loss and gradient on the first window (those (b)
    is held to)."""
    windows = _tp_windows(token_url, TP_STEPS)
    attn = make_flash_attention(causal=True)
    ref = {"losses": [], "routes": []}
    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), TP_LLAMA,
                               device="cuda")
    init_opt, step = llama.make_train_step(TP_LLAMA, attn_fn=attn, shift="roll")
    opt = init_opt(params)
    for tokens in windows:
        with moe.record_routing() as record:
            ref["losses"].append(step(params, opt, {"tokens": tokens})[2].item())
        ref["routes"] += _routes(record)
    del params, opt, init_opt, step
    free_cuda()

    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), TP_LLAMA,
                               device="cuda")
    p0 = [t.clone() for t in llama.param_leaves(params)]
    init_opt, step = llama.make_train_step(TP_LLAMA, attn_fn=attn, shift="roll",
                                           compute_dtype=torch.float32)
    opt = init_opt(params)
    ref["losses32"], ref["routes32"] = [], []
    for tokens in windows:
        with moe.record_routing() as record:
            ref["losses32"].append(step(params, opt, {"tokens": tokens})[2].item())
        ref["routes32"] += _routes(record)
        if p0:
            ref["update_norms"] = [(a.detach() - b).norm().item()
                                   for a, b in zip(llama.param_leaves(params), p0)]
            # A copy: the next steps update ``params`` in place.
            ref["after"] = _tree_map(lambda t: t.detach().to("cpu", copy=True), params)
            p0 = None
            free_cuda()
    del params, opt, init_opt, step
    free_cuda()

    batch = {"tokens": windows[0]}

    params = llama.init_params(torch.Generator(device="cuda").manual_seed(0), TP_COMPOSE,
                               device="cuda")
    with torch.no_grad():
        ref["compose_loss"] = llama.loss_fn(params, batch, TP_COMPOSE, attn_fn=attn,
                                            shift="roll").item()
    for t in llama.param_leaves(params):
        t.requires_grad_(True)
    loss = llama.loss_fn(params, batch, TP_COMPOSE, attn_fn=attn, shift="roll",
                         compute_dtype=torch.float32)
    loss.backward()
    ref["compose_loss32"] = loss.item()
    grads = _tree_map(lambda t: t.grad, params)
    ref["compose_grad_norms"] = [g.norm().item() for g in llama.param_leaves(grads)]
    ref["compose_grads"] = _tree_map(lambda t: t.cpu(), grads)
    del params, loss, grads, batch, windows
    free_cuda()
    return ref


def phase_tensor_parallel(smi: str, token_url: str) -> dict:
    """Tensor and expert parallelism (see the module docstring, phase 18).
    Returns the launches by kernel name."""
    t_phase = time.perf_counter()
    card = f"({smi})"
    failures = []
    _rank_shape_kernels(torch.Generator(device="cuda").manual_seed(18), failures)

    t0 = time.perf_counter()
    ref = _one_process(token_url)
    kept, dropped, aux = ref["routes"][0]
    kept32 = ref["routes32"][0][0]
    log(f"[tp] {card} one process, LlamaConfig() width, {TP_LLAMA.n_layers} layers (layer 1 a "
        f"switch MoE, {TP_LLAMA.n_experts} experts, top-{TP_LLAMA.moe_top_k}, capacity factor "
        f"{TP_LLAMA.moe_capacity_factor}), window {WINDOW}: bf16 losses by step {ref['losses']}, "
        f"tokens per expert, dropped share and aux by step "
        f"{[(k_, round(100 * d_, 3), round(a_, 6)) for k_, d_, a_ in ref['routes']]}; float32 "
        f"losses {ref['losses32']}, tokens per expert, dropped share and aux by step "
        f"{[(k_, round(100 * d_, 3), round(a_, 6)) for k_, d_, a_ in ref['routes32']]}; "
        f"{TP_COMPOSE.n_layers}-layer loss bf16 {ref['compose_loss']:.6f}, "
        f"float32 {ref['compose_loss32']:.6f}; {time.perf_counter() - t0:.1f} s")

    # (a) Tensor x expert parallel on TP_RANKS ranks.
    t0 = time.perf_counter()
    compose_grads = ref.pop("compose_grads")
    ranks = run_ranks(_rank_tensor_parallel, TP_RANKS, args=(token_url, "a", ref), device="cuda")
    wall = time.perf_counter() - t0
    names = _leaf_names(ref.pop("after"))
    launches = {n: 0 for n in TP_KERNELS}
    for r, got in enumerate(ranks):
        run = got["tensor parallel"]
        for n in TP_KERNELS:
            launches[n] += run["launches"][n]
        for i, (ms, transfers) in enumerate(zip(run["step_ms"], run["transfers"])):
            log(f"[tp] (a) {card} rank {r} step {i}: {ms:.1f} ms, "
                f"{WINDOW / (ms / 1e3):.1f} tokens/s; gloo {_gloo_line(transfers, ms)}")
        log(f"[tp] (a) {card} rank {r}: {run['s']:.1f} s; losses {run['losses']}; peak memory "
            f"{run['peak_gb']:.2f} GB; tokens per expert, dropped share and aux by step "
            f"{[(k_, round(100 * d_, 3), round(a_, 6)) for k_, d_, a_ in run['routes']]}; "
            f"launches {run['launches']}")
    r0 = ranks[0]
    run0 = r0["tensor parallel"]
    if any(g["tensor parallel"]["losses"] != run0["losses"] for g in ranks):
        failures.append("(a) the ranks' losses differ")
    if not np.isfinite(run0["losses"]).all():
        failures.append(f"(a) non-finite losses {run0['losses']}")
    want = {n: 0 for n in TP_KERNELS}
    for n in (flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
              flash_attn.BWD_DKV_KERNEL_NAME):
        want[n] = TP_RANKS * TP_LLAMA.n_layers * TP_STEPS
    if launches != want:
        failures.append(f"(a) launches {launches}, expected {want}")
    loss_rel = abs(run0["losses"][0] - ref["losses"][0]) / abs(ref["losses"][0])
    kept_tp = run0["routes"][0][0]
    moved = sum(abs(a - b) for a, b in zip(kept_tp, kept))
    f32, ctrl = r0["float32"], r0["control: router gradient unsummed"]
    worst, worst_ctrl = max(f32["rel"]), max(ctrl["rel"])
    kept32_tp = f32["routes"][0][0]
    moved32 = sum(abs(a - b) for a, b in zip(kept32_tp, kept32))
    assigned = TP_LLAMA.moe_top_k * WINDOW
    for label, r in (("float32", f32), ("control", ctrl)):
        top = sorted(range(len(names)), key=lambda i: -r["rel"][i])[:4]
        log(f"[tp] (a) {card} {label} ({r['s']:.1f} s on rank 0): largest update distances "
            f"{[(names[i], round(r['rel'][i], 5)) for i in top]}; median "
            f"{statistics.median(r['rel']):.3g}")
    log(f"[tp] (a) {card} {TP_RANKS} ranks, mesh (1, 1, {TP_RANKS}), {wall:.1f} s with the spawn: "
        f"first bf16 loss {run0['losses'][0]} vs one process {ref['losses'][0]} ({loss_rel:.3g} "
        f"relative, bar {TP_LOSS_REL_BAR}); tokens per expert {kept_tp} vs {kept} ({moved} "
        f"assignments moved of {assigned}); float32 first step: loss {f32['losses'][0]} vs "
        f"{ref['losses32'][0]}, tokens per expert {kept32_tp} vs {kept32} ({moved32} moved, bar "
        f"{TP_ROUTE_BAR * assigned:.0f}), |p_tp - p_one| / |p_one - p_0| largest {worst:.4g} "
        f"(bar {TP_UPDATE_REL_BAR}); control (router gradient unsummed): largest "
        f"{worst_ctrl:.4g}")
    if loss_rel > TP_LOSS_REL_BAR:
        failures.append(f"(a) first loss {loss_rel:.3g} from one process")
    if worst > TP_UPDATE_REL_BAR or moved32 > TP_ROUTE_BAR * assigned:
        failures.append(f"(a) float32 step: update {worst:.4g}, routing moved {moved32}")
    if worst_ctrl <= TP_UPDATE_REL_BAR:
        failures.append(f"(a) the control (router gradient unsummed) passed the bar: "
                        f"{worst_ctrl:.4g}")
    # The routing by step, on the ranks and in one process: float32 (held to
    # the bars) and bf16 (logged).
    for label, tp, one, held in (("float32", f32, {"routes": ref["routes32"],
                                                    "losses": ref["losses32"]}, True),
                                 ("bf16", run0, ref, False)):
        for i, ((_, d_tp, a_tp), (_, d_one, a_one), l_tp, l_one) in enumerate(
                zip(tp["routes"], one["routes"], tp["losses"], one["losses"])):
            log(f"[tp] (a) {card} {label} step {i}: dropped {100 * d_tp:.3f} % vs one process "
                f"{100 * d_one:.3f} %, aux {a_tp:.6f} vs {a_one:.6f} "
                f"({abs(a_tp - a_one) / a_one:.3g} relative), loss {l_tp:.6f} vs {l_one:.6f} "
                f"({abs(l_tp - l_one) / abs(l_one):.3g} relative)"
                + (f"; bars {100 * TP_TREND_DROP_BAR:g} points, {TP_TREND_AUX_BAR} relative"
                   if held else ""))
            if held and (abs(d_tp - d_one) > TP_TREND_DROP_BAR
                         or abs(a_tp - a_one) > TP_TREND_AUX_BAR * a_one):
                failures.append(f"(a) {label} step {i}: dropped {d_tp:.4f} vs {d_one:.4f}, aux "
                                f"{a_tp:.5f} vs {a_one:.5f}")
        if held and len(tp["routes"]) != TP_STEPS:
            failures.append(f"(a) {label}: {len(tp['routes'])} steps routed")
    free_cuda()

    # (b) The composition: ring, then Ulysses, over the sequence axis.
    t0 = time.perf_counter()
    world = int(np.prod(TP_COMPOSE_MESH))
    ref["compose_grads"] = compose_grads
    ranks = run_ranks(_rank_tensor_parallel, world, args=(token_url, "b", ref), device="cuda")
    wall = time.perf_counter() - t0
    names = _leaf_names(ref.pop("compose_grads"))
    del compose_grads
    seq, model = TP_COMPOSE_MESH[1:]
    blocks = sum(r + 1 for r in range(seq)) * model
    expect = {"ring": {flash_attn.STATS_KERNEL_NAME: blocks, flash_attn.BWD_DQ_KERNEL_NAME: blocks,
                       flash_attn.BWD_DKV_KERNEL_NAME: blocks},
              "ulysses": {flash_attn.KERNEL_NAME: world, flash_attn.BWD_DQ_KERNEL_NAME: world,
                          flash_attn.BWD_DKV_KERNEL_NAME: world}}
    for strategy in ("ring", "ulysses"):
        runs = [g[strategy] for g in ranks]
        counts = {n: sum(x["launches"][n] for x in runs) for n in TP_KERNELS}
        for n in TP_KERNELS:
            launches[n] += counts[n]
        loss = runs[0]["losses"][0]
        rel = abs(loss - ref["compose_loss"]) / abs(ref["compose_loss"])
        aux = sum(x["routes"][0][2] for x in runs[::model])
        log(f"[tp] (b) {card} {strategy}, mesh {TP_COMPOSE_MESH}, {runs[0]['s']:.1f} s on rank 0: "
            f"loss {loss} vs one process "
            f"{ref['compose_loss']} ({rel:.3g} relative, bar {TP_LOSS_REL_BAR}); step ms by rank "
            f"{[round(x['step_ms'][0], 1) for x in runs]} ({WINDOW / (runs[0]['step_ms'][0] / 1e3):.1f} "
            f"tokens/s); peak memory by rank {[round(x['peak_gb'], 2) for x in runs]} GB; tokens "
            f"per expert {runs[0]['routes'][0][0]}, dropped "
            f"{100 * runs[0]['routes'][0][1]:.3f} %, aux {aux:.6f}; rank 0's gloo "
            f"{_gloo_line(runs[0]['transfers'][0], runs[0]['step_ms'][0])}; launches {counts}")
        if any(x["losses"] != runs[0]["losses"] for x in runs) or rel > TP_LOSS_REL_BAR:
            failures.append(f"(b) {strategy}: losses {[x['losses'] for x in runs]}, {rel:.3g} "
                            f"from one process")
        if {n: c for n, c in counts.items() if c} != expect[strategy]:
            failures.append(f"(b) {strategy}: launches {counts}, expected {expect[strategy]}")
    for label in ("ring float32", "ulysses float32", "control: ring, kv heads rolled"):
        r = ranks[0][label]
        top = sorted(range(len(names)), key=lambda i: -r["rel"][i])[:4]
        worst = max(r["rel"])
        log(f"[tp] (b) {card} {label}, {r['s']:.1f} s on rank 0: loss {r['losses'][0]} vs one "
            f"process {ref['compose_loss32']}; |g_ranks - g_one| / |g_one| largest {worst:.4g} (bar "
            f"{TP_GRAD_REL_BAR}), by leaf {[(names[i], round(r['rel'][i], 6)) for i in top]}; "
            f"median {statistics.median(r['rel']):.3g}")
        if (worst <= TP_GRAD_REL_BAR) == label.startswith("control"):
            failures.append(f"(b) {label}: gradient {worst:.4g} against the bar {TP_GRAD_REL_BAR}")
    log(f"[tp] (b) {card} {world} ranks, {wall:.1f} s with the spawn")
    log(f"[tp] {card} phase took {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    if failures:
        raise AssertionError("tensor-parallel phase: " + "; ".join(failures))
    return launches


# ------------------------------------------------------------------ phase 19
def _dryrun_shape_kernels(gen, failures: list) -> None:
    """K2 "stats" (causal and not), then K3 and K4 as the ring's backward
    launches them, at the dry run's ring-flash block (DRYRUN_BLOCK: d = 8 on
    the tensor-core route) against their plain versions."""
    b, block, heads, kv_heads, hd = DRYRUN_BLOCK

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
    q = randn(b, block, heads, hd)
    k, v = randn(b, block, kv_heads, hd), randn(b, block, kv_heads, hd)
    for causal in (True, False):
        kernels.reset_launch_counts()
        o, m, l = flash_attn.flash_attention_stats(q, k, v, causal=causal)
        counts = dict(kernels.launch_counts)
        worst, rms, m_err, l_err, ok = stats_verdict(
            (o, m.transpose(1, 2), l.transpose(1, 2)), flash_attn._stats_plain(q, k, v, causal),
            torch.bfloat16)
        log(f"[stats] the dry run's ring block {DRYRUN_BLOCK} bf16 "
            f"{'causal' if causal else 'non-causal'} [launches {counts}]: o row-scaled worst "
            f"{worst:.3g} rms {rms:.3g}; m {m_err:.3g}; l relative {l_err:.3g}")
        if not ok or counts != {flash_attn.STATS_KERNEL_NAME: 1}:
            failures.append(f"K2 stats at the dry run's block, causal={causal}: launches {counts}")
    failures += ring_backward_check(q, k, v, randn)


def _fresh_llama(cfg) -> dict:
    return llama.init_params(torch.Generator(device="cuda").manual_seed(0), cfg, device="cuda")


def _phase19_reference(windows: list) -> dict:
    """The whole model in one process on the runs' windows: the peak memory
    of one bf16 AdamW step on one window; the bf16 losses over the first
    FSDP_WINDOWS and over all PIPE_WINDOWS windows; the float32 gradient
    accumulated over the first FSDP_WINDOWS (each window's loss weighted so
    that the sum is the mean over their targets, as the ranks' global loss
    is), and one AdamW step on it -> the gradient and the update the ranks
    are held to."""
    cfg, attn = FSDP_LLAMA, make_flash_attention(causal=True)
    kw = dict(attn_fn=attn, shift="roll", xent_chunk=PHASE19_XENT_CHUNK)
    ref = {}
    params = _fresh_llama(cfg)
    init_opt, step = llama.make_train_step(cfg, **kw)
    opt = init_opt(params)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step(params, opt, {"tokens": windows[0]})
    torch.cuda.synchronize()
    ref["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    del params, opt, init_opt, step
    free_cuda()

    params = _fresh_llama(cfg)
    with torch.no_grad():
        losses = [llama.loss_fn(params, {"tokens": w}, cfg, **kw).item() for w in windows]
    ref["fsdp_loss"] = statistics.mean(losses[:FSDP_WINDOWS])
    ref["pipe_loss"] = statistics.mean(losses[:PIPE_WINDOWS])
    leaves = llama.param_leaves(params)
    opt = llama.make_train_step(cfg)[0](params)
    p0 = [t.detach().clone() for t in leaves]
    losses32 = []
    for w in windows[:FSDP_WINDOWS]:
        loss = llama.loss_fn(params, {"tokens": w}, cfg, compute_dtype=torch.float32, **kw)
        (loss / FSDP_WINDOWS).backward()
        losses32.append(loss.item())
        del loss
    ref["loss32"] = statistics.mean(losses32)
    ref["grads"] = _tree_map(lambda t: t.grad.to("cpu", copy=True), params)
    opt.step()
    ref["update_norms"] = [(t.detach() - a).norm().item() for t, a in zip(leaves, p0)]
    ref["after"] = _tree_map(lambda t: t.detach().to("cpu", copy=True), params)
    del params, leaves, p0, opt
    free_cuda()
    return ref


def _state_gb(params: dict) -> float:
    """float32 weights, gradients and both AdamW moments of ``params``."""
    return 16 * sum(t.numel() for t in llama.param_leaves(params)) / 1e9


def _steps(params, step, batch, count: int, hook=None) -> dict:
    """``count`` steps of ``step`` (``make_train_step``'s pair), launches
    counted from the first, ``hook`` run before each AdamW update: losses,
    step ms, gloo transfers by step, launches, peak memory and the rank's
    state."""
    opt = step[0](params)
    if hook is not None:
        opt.register_step_pre_hook(hook)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, step_ms, transfers = [], [], []
    for _ in range(count):
        comm.reset_transfer_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(step[1](params, opt, batch)[2].item())   # waits for the step
        step_ms.append((time.perf_counter() - t0) * 1e3)
        transfers.append(_transfers())
    return {"losses": losses, "step_ms": step_ms, "transfers": transfers,
            "launches": {n: kernels.launch_counts.get(n, 0) for n in TP_KERNELS},
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9, "state_gb": _state_gb(params)}


def _unsummed_scatter(t, group, dim=0, record_as="reduce_scatter"):
    """The FSDP control's reduce-scatter: this rank's block of its own
    gradient, not summed over the data group."""
    return t.chunk(dist.get_world_size(group), dim)[dist.get_rank(group)].contiguous()


class _SummedCotangent(torch.autograd.Function):
    """The pipeline control's output op: the last stage's output on every
    stage, and a backward that sums the cotangent over the stages that each
    computed the same loss (the gradient S times too large)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        host = t.detach().cpu() if dist.get_rank(group) == dist.get_world_size(group) - 1 \
            else torch.empty(t.shape, dtype=t.dtype)
        dist.broadcast(host, dist.get_global_rank(group, dist.get_world_size(group) - 1),
                       group=group)
        return host.to(t.device)

    @staticmethod
    def backward(ctx, g):
        host = g.cpu()
        dist.all_reduce(host, group=ctx.group)
        return host.to(g.device), None


def _rank_fsdp_pipeline(rank: int, world: int, url: str, ref: dict) -> dict:
    """Phase 19's spawn, on one of 4 ranks sharing ``cuda:0``: (a) FSDP on
    each of FSDP_MESHES, then the float32 step and its control on the
    first; (b) the pipeline on PIPE_MESH, then the float32 step and its
    control."""
    cfg, attn = FSDP_LLAMA, make_flash_attention(causal=True)
    windows = _tp_windows(url, PIPE_WINDOWS)
    out = {}

    # (a) FSDP.
    for sizes in FSDP_MESHES:
        mesh = make_mesh(sizes, ("data", "seq", "model"))
        tp = sizes[2] > 1
        shardings = llama.param_shardings_fsdp(mesh, cfg, model_axis="model" if tp else None)
        per, d = FSDP_WINDOWS // sizes[0], dist.get_rank(mesh.group("data"))
        batch = {"tokens": torch.cat(windows[d * per:(d + 1) * per])}
        groups = dict(fsdp_group=mesh.group("data"),
                      model_group=mesh.group("model") if tp else None)
        checks = [("bf16", torch.bfloat16, comm.reduce_scatter)]
        if not tp:
            checks += [("float32", torch.float32, comm.reduce_scatter),
                       ("control: gather unsummed", torch.float32, _unsummed_scatter)]
        for label, dtype, scatter in checks:
            t_run = time.perf_counter()
            params = llama.shard_params(_fresh_llama(cfg), shardings, mesh)
            free_cuda()
            step = llama.make_train_step(cfg, attn_fn=attn, shift="roll", compute_dtype=dtype,
                                         xent_chunk=PHASE19_XENT_CHUNK, **groups)
            saved, comm.reduce_scatter = comm.reduce_scatter, scatter
            try:
                run = _steps(params, step, batch, FSDP_STEPS if dtype == torch.bfloat16 else 1)
            finally:
                comm.reduce_scatter = saved
            if dtype == torch.float32:
                whole = llama.param_leaves(ref["after"])
                want = llama.param_leaves(llama.shard_params(ref["after"], shardings, mesh))
                split = [w.shape != a.shape for w, a in zip(want, whole)]
                d2 = _distances(llama.param_leaves(params), want, split, mesh.group("data"),
                                sizes[0])
                run["rel"] = (d2.sqrt() / torch.tensor(ref["update_norms"])).tolist()
            run["s"] = time.perf_counter() - t_run
            out[f"fsdp {sizes} {label}"] = run
            del params, step
            free_cuda()

    # (b) The pipeline: one layer a stage.
    pmesh = make_mesh(PIPE_MESH, ("pipe", "data"))
    stage, d = dist.get_rank(pmesh.group("pipe")), dist.get_rank(pmesh.group("data"))

    def stage_fn(layer, x):
        return llama.apply_block(layer, x, cfg, attn_fn=attn)[0]

    ref_grads = ref["grads"]
    names = ["embed"] + [f"layers.{stage}.{k}" for k in sorted(ref_grads["layers"][stage])] + \
        ["lm_head", "norm_out"]

    def mine(tree):
        """This stage's leaves of a whole tree, as ``param_leaves`` orders
        the stage's parameters."""
        return [tree["embed"]] + [tree["layers"][stage][k] for k in sorted(tree["layers"][stage])] \
            + [tree["lm_head"], tree["norm_out"]]

    for label, dtype, replicate in (("bf16", torch.bfloat16, comm.replicate_from_last),
                                    ("float32", torch.float32, comm.replicate_from_last),
                                    ("control: cotangent summed", torch.float32,
                                     _SummedCotangent.apply)):
        t_run = time.perf_counter()
        per = (PIPE_WINDOWS if dtype == torch.bfloat16 else FSDP_WINDOWS) // PIPE_MESH[1]
        batch = {"tokens": torch.cat(windows[d * per:(d + 1) * per])}
        pipe = make_pipeline(pmesh, stage_fn, per, data_axis="data")

        def layers_fn(stage_params, x):
            return pipe(stage_params, x), torch.zeros((), device=x.device)

        full = _fresh_llama(cfg)
        params = {"embed": full["embed"], "norm_out": full["norm_out"],
                  "lm_head": full["lm_head"],
                  "layers": stack_stage_params(full["layers"], pmesh)}
        del full
        free_cuda()
        step = llama.make_train_step(cfg, shift="roll", compute_dtype=dtype,
                                     xent_chunk=PHASE19_XENT_CHUNK, layers_fn=layers_fn,
                                     data_group=pmesh.group("data"))
        rel_grad = []

        def grad_distances(*_):   # the step's gradient, summed over the data ranks
            rel_grad.extend(((t.grad - w.cuda()).norm() / w.norm().cuda()).item()
                            for t, w in zip(llama.param_leaves(params), mine(ref_grads)))
        saved, comm.replicate_from_last = comm.replicate_from_last, replicate
        try:
            run = (_steps(params, step, batch, FSDP_STEPS) if dtype == torch.bfloat16
                   else _steps(params, step, batch, 1, hook=grad_distances))
        finally:
            comm.replicate_from_last = saved
        if dtype == torch.float32:
            run["rel_grad"] = rel_grad
            run["rel"] = [((t.detach() - w.cuda()).norm() / n).item() for t, w, n in zip(
                llama.param_leaves(params), mine(ref["after"]),
                mine(_tree_from_leaves(ref_grads, ref["update_norms"])))]
        run["names"], run["s"] = names, time.perf_counter() - t_run
        out[f"pipe {label}"] = run
        del params, step
        free_cuda()
    return out


def _tree_from_leaves(like: dict, leaves: list) -> dict:
    """``leaves`` (in ``param_leaves`` order) as a tree shaped like ``like``."""
    it = iter(leaves)
    tree = {}
    for key in sorted(like):
        node = like[key]
        tree[key] = [{k: next(it) for k in sorted(layer)} for layer in node] \
            if isinstance(node, list) else next(it)
    return tree


def phase_fsdp_pipeline(smi: str, token_url: str) -> dict:
    """FSDP, the pipeline and the dry run (see the module docstring, phase
    19). Returns the launches by kernel name."""
    t_phase = time.perf_counter()
    card = f"({smi})"
    failures = []
    _dryrun_shape_kernels(torch.Generator(device="cuda").manual_seed(19), failures)

    t0 = time.perf_counter()
    windows = _tp_windows(token_url, PIPE_WINDOWS)
    ref = _phase19_reference(windows)
    del windows
    free_cuda()
    n_params = sum(int(np.prod(shape)) for node in llama._param_shapes(FSDP_LLAMA).values()
                   for shape in ([s for layer in node for s in layer.values()]
                                 if isinstance(node, list) else [node]))
    layout_gb = 16 * n_params / 1e9
    log(f"[fsdp] {card} one process, LlamaConfig() width, {FSDP_LLAMA.n_layers} layers (dense, "
        f"{n_params / 1e6:.1f} M parameters: {layout_gb:.2f} GB of float32 weights, gradients "
        f"and AdamW moments), window {WINDOW}: peak memory of a bf16 AdamW step on one window "
        f"{ref['peak_gb']:.2f} GB; bf16 loss over {FSDP_WINDOWS} windows {ref['fsdp_loss']:.6f}, "
        f"over {PIPE_WINDOWS} {ref['pipe_loss']:.6f}; float32 over {FSDP_WINDOWS} "
        f"{ref['loss32']:.6f}; {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    ranks = run_ranks(_rank_fsdp_pipeline, 4, args=(token_url, ref), device="cuda")
    wall = time.perf_counter() - t0
    names = _leaf_names(ref["after"])
    launches = {n: 0 for n in TP_KERNELS}
    layers = FSDP_LLAMA.n_layers
    runs = [(f"fsdp {sizes} bf16", f"(a) FSDP mesh {sizes}", FSDP_WINDOWS * WINDOW // sizes[0],
             {flash_attn.KERNEL_NAME: 4 * 2 * layers * FSDP_STEPS,
              flash_attn.BWD_DQ_KERNEL_NAME: 4 * layers * FSDP_STEPS,
              flash_attn.BWD_DKV_KERNEL_NAME: 4 * layers * FSDP_STEPS}, ref["fsdp_loss"])
            for sizes in FSDP_MESHES]
    per_stage = PIPE_MICROBATCHES * FSDP_STEPS * 4
    runs.append(("pipe bf16", f"(b) pipeline {PIPE_MESH} of (pipe, data)",
                 PIPE_WINDOWS * WINDOW // PIPE_MESH[1],
                 {flash_attn.KERNEL_NAME: 2 * per_stage, flash_attn.BWD_DQ_KERNEL_NAME: per_stage,
                  flash_attn.BWD_DKV_KERNEL_NAME: per_stage}, ref["pipe_loss"]))
    for key, what, tokens, expect, want_loss in runs:
        counts = {n: sum(r[key]["launches"][n] for r in ranks) for n in TP_KERNELS}
        for n in TP_KERNELS:
            launches[n] += counts[n]
        for r, got in enumerate(ranks):
            run = got[key]
            for i, (ms, transfers) in enumerate(zip(run["step_ms"], run["transfers"])):
                log(f"[fsdp] {what} {card} rank {r} step {i}: {ms:.1f} ms, "
                    f"{tokens / (ms / 1e3):.1f} tokens/s a rank; gloo "
                    f"{_gloo_line(transfers, ms)}")
            log(f"[fsdp] {what} {card} rank {r}: {run['s']:.1f} s; losses {run['losses']}; peak "
                f"memory {run['peak_gb']:.2f} GB (its float32 weights, gradients and moments "
                f"{run['state_gb']:.2f} GB; the unsharded layout {layout_gb:.2f} GB; one process "
                f"on one window {ref['peak_gb']:.2f} GB); launches {run['launches']}")
        losses = ranks[0][key]["losses"]
        rel = abs(losses[0] - want_loss) / abs(want_loss)
        log(f"[fsdp] {what} {card}: first bf16 loss {losses[0]} vs one process {want_loss} "
            f"({rel:.3g} relative, bar {TP_LOSS_REL_BAR}); launches {counts}")
        if any(g[key]["losses"] != losses for g in ranks) or not np.isfinite(losses).all():
            failures.append(f"{what}: losses {[g[key]['losses'] for g in ranks]}")
        if rel > TP_LOSS_REL_BAR:
            failures.append(f"{what}: first loss {rel:.3g} from one process")
        if {n: c for n, c in counts.items() if c} != expect:
            failures.append(f"{what}: launches {counts}, expected {expect}")
    peak = max(g[f"fsdp {FSDP_MESHES[0]} bf16"]["peak_gb"] for g in ranks)
    if peak >= ref["peak_gb"]:
        failures.append(f"(a) an FSDP rank's peak {peak:.2f} GB is not below one process's "
                        f"{ref['peak_gb']:.2f} GB")
    for label in ("float32", "control: gather unsummed"):
        r = ranks[0][f"fsdp {FSDP_MESHES[0]} {label}"]
        worst = max(r["rel"])
        top = sorted(range(len(names)), key=lambda i: -r["rel"][i])[:4]
        log(f"[fsdp] (a) FSDP mesh {FSDP_MESHES[0]} {card} {label} ({r['s']:.1f} s on rank 0): "
            f"loss {r['losses'][0]} vs one process {ref['loss32']}; |p_ranks - p_one| / "
            f"|p_one - p_0| largest {worst:.4g} (bar {FSDP_UPDATE_REL_BAR}), by leaf "
            f"{[(names[i], round(r['rel'][i], 6)) for i in top]}; median "
            f"{statistics.median(r['rel']):.3g}")
        if (worst <= FSDP_UPDATE_REL_BAR) == label.startswith("control"):
            failures.append(f"(a) {label}: update {worst:.4g} against the bar "
                            f"{FSDP_UPDATE_REL_BAR}")
    for label in ("float32", "control: cotangent summed"):
        grad, upd = {}, {}
        for g in ranks:
            r = g[f"pipe {label}"]
            for name, a, b in zip(r["names"], r["rel_grad"], r["rel"]):
                grad[name], upd[name] = max(grad.get(name, 0.0), a), max(upd.get(name, 0.0), b)
        worst = max(grad.values())
        log(f"[fsdp] (b) pipeline {card} {label} ({ranks[0]['pipe ' + label]['s']:.1f} s on rank "
            f"0), {FSDP_WINDOWS // PIPE_MESH[1]} microbatches a data rank: loss "
            f"{ranks[0]['pipe ' + label]['losses'][0]} vs one process {ref['loss32']}; "
            f"|g_ranks - g_one| / |g_one| largest {worst:.4g} (bar "
            f"{PIPE_GRAD_REL_BAR}), by leaf {sorted(grad.items(), key=lambda kv: -kv[1])[:4]}; "
            f"update distance largest {max(upd.values()):.4g} (bar {FSDP_UPDATE_REL_BAR}), by "
            f"leaf {sorted(upd.items(), key=lambda kv: -kv[1])[:3]}")
        if label == "float32" and (worst > PIPE_GRAD_REL_BAR
                                   or max(upd.values()) > FSDP_UPDATE_REL_BAR):
            failures.append(f"(b) float32: gradient {worst:.4g}, update {max(upd.values()):.4g}")
        if label.startswith("control") and worst <= PIPE_GRAD_REL_BAR:
            failures.append(f"(b) the control (cotangent summed) passed the bar: {worst:.4g}")
    log(f"[fsdp] {card} 4 ranks, {wall:.1f} s with the spawn")
    del ref
    free_cuda()

    # The dry run on 4 ranks on the card.
    t0 = time.perf_counter()
    dry = entry_module.dryrun_multichip(4, device="cuda")
    plan = entry_module.dryrun_plan(4)
    dp, sp, tp = plan["mesh"]
    blocks = dp * tp * sum(r + 1 for r in range(sp)) * 2   # causal blocks, 2 layers
    expect = {flash_attn.STATS_KERNEL_NAME: blocks, flash_attn.BWD_DQ_KERNEL_NAME: blocks,
              flash_attn.BWD_DKV_KERNEL_NAME: blocks}
    counts = {n: dry["launches"].get(n, 0) for n in TP_KERNELS}
    for n in TP_KERNELS:
        launches[n] += counts[n]
    log(f"[dryrun] {card} dryrun_multichip(4) on cuda:0 ranks, {time.perf_counter() - t0:.1f} s "
        f"with the spawn; launches {counts}")
    if {n: c for n, c in counts.items() if c} != expect:
        failures.append(f"dryrun_multichip(4): launches {counts}, expected {expect}")
    log(f"[fsdp] {card} phase took {time.perf_counter() - t_phase:.1f} s; launches {launches}")
    if failures:
        raise AssertionError("FSDP and pipeline phase: " + "; ".join(failures))
    return launches


def _unbiased_layer_norm(x, p, eps=1e-6):
    """The control of phase 20's float32 bar: layer norm by the unbiased
    variance."""
    x32 = x.float()
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, unbiased=True)
    return ((x32 - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def _with_even(row: dict) -> dict:
    """Phase 20 (c)'s worker transform: a bool column."""
    return {**row, "even": np.bool_(row["label"] % 2 == 0)}


def _vit_float32_check(params, images: torch.Tensor) -> dict:
    """Float32 logits of ``images`` on the card (TF32 off) against the same
    forward on the CPU with the same weights, as max |card - CPU| over
    max |CPU|: the port's, and two controls' (the exact-erf GELU, the
    unbiased variance), which must miss ``VIT_F32_BAR``."""
    cpu_params = _tree_map(lambda t: t.detach().cpu(), params)
    shape = {"patch": vit.VIT_B16["patch"], "heads": vit.VIT_B16["heads"],
             "compute_dtype": torch.float32}
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    errs = {}
    try:
        with torch.no_grad():
            want = vit.apply(cpu_params, images.cpu(), **shape)
            for what, name, replacement in (("port", None, None),
                                            ("exact-erf GELU", "_gelu", F.gelu),
                                            ("unbiased variance", "_layer_norm",
                                             _unbiased_layer_norm)):
                original = getattr(vit, name) if name else None
                if name:
                    setattr(vit, name, replacement)
                try:
                    got = vit.apply(params, images, **shape).cpu()
                finally:
                    if name:
                        setattr(vit, name, original)
                errs[what] = ((got - want).abs().max() / want.abs().max()).item()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return errs


def phase_converter_vit(smi: str, tmp: str) -> dict:
    from examples.torch_spark_to_vit.main import build_store_sparkless
    failures = []
    side = vit.VIT_B16["image_size"]
    url = f"file://{tmp}/converter_cache"
    t0 = time.perf_counter()
    stats = build_store_sparkless(url, CONV_ROWS, CONV_CLASSES, side, CONV_ROWS_PER_GROUP)
    converter = SparkDatasetConverter(url, stats["total_rows"])
    log(f"[converter] wrote the cache store: {CONV_ROWS} rows of {side}x{side}x3 uint8 in groups "
        f"of {CONV_ROWS_PER_GROUP} ({CONV_ROWS_PER_GROUP * side * side * 3 / 1e6:.1f} MB), files "
        f"{stats['file_sizes']} bytes, in {time.perf_counter() - t0:.2f} s; dataset_size "
        f"{len(converter)} from the footers")
    if len(converter) != CONV_ROWS:
        failures.append(f"dataset_size {len(converter)}")

    free_cuda()
    params = vit.init_params(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                             **vit.VIT_B16)
    n_params = sum(t.numel() for t in vit.param_leaves(params))
    step = vit.make_train_step(VIT_LR, patch=vit.VIT_B16["patch"], heads=vit.VIT_B16["heads"])
    losses, mismatches, last = [], [], []

    def next_batch(it):
        # K1, and its plain version on the same pixels: the comparison is a
        # count kept on the card, read after the run (no sync in the loop).
        batch = next(it)
        pixels = batch["image"].view(-1, side, side, 3)
        images = normalize_images(pixels)
        mismatches.append((images.view(torch.int16)
                           != normalize_images_plain(pixels).view(torch.int16)).sum())
        last[:] = [{"image": images, "label": batch["label"]}]
        return last[0]

    def run_step(batch):
        nonlocal params
        params, loss, _ = step(params, batch)
        losses.append(loss)
        return loss

    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with converter.make_device_loader(batch_size=VIT_BATCH, num_epochs=None,
                                      workers_count=VIT_WORKERS, shuffle_row_groups=True,
                                      seed=0) as loader:
        it = iter(loader)
        first = next_batch(it)
        # Float32 on the initial weights, before the first step changes them.
        errs = _vit_float32_check(params, first["image"][:VIT_F32_ROWS].float())
        warm = run_step(first)
        for _ in range(VIT_WARMUP - 1):
            warm = run_step(next_batch(it))
        _, _, wait_s, wall_s, resident_s = pipelined_window(
            run_step, lambda: next_batch(it), VIT_PIPELINED, VIT_RESIDENT, warm)
        it.close()
    launches = dict(kernels.launch_counts)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    values = [v.item() for v in losses]
    mismatched = [int(m.item()) for m in mismatches]
    pipelined = values[VIT_WARMUP:VIT_WARMUP + VIT_PIPELINED]
    flops_step = 3 * VIT_BATCH * vit.vit_flops_per_image(
        **{k: v for k, v in vit.VIT_B16.items() if k != "heads"})
    step_ms, resident_ms = 1e3 * wall_s / VIT_PIPELINED, 1e3 * resident_s
    mfu, mfu_resident = (100 * flops_step / (ms / 1e3) / BF16_FLOPS
                         for ms in (step_ms, resident_ms))
    log(f"[converter] ({smi}) ViT-B/16 ({n_params / 1e6:.1f} M parameters), batch {VIT_BATCH}, "
        f"bf16 on float32 weights, SGD lr {VIT_LR}: pipelined step {step_ms:.2f} ms "
        f"({VIT_BATCH * VIT_PIPELINED / wall_s:.1f} samples/s, input stall "
        f"{100 * wait_s / wall_s:.1f} %), resident step {resident_ms:.2f} ms "
        f"({VIT_BATCH / resident_s:.1f} samples/s); peak memory {peak_gb:.2f} GB")
    log(f"[converter] MFU = 3 x {VIT_BATCH} x F / step time / 989e12, F = 2 P (p^2 3) D + L "
        f"(2 T (4 D^2 + 2 D M) + 4 T^2 D) + 2 D K = {flops_step / 3 / VIT_BATCH / 1e9:.2f} "
        f"GFLOP an image forward (P 196 patches, T 197 tokens, D 768, M 3072, L 12, K 1000), "
        f"{flops_step / 1e12:.2f} TFLOP a step: {mfu:.1f} % pipelined, {mfu_resident:.1f} % "
        f"resident")
    log(f"[converter] losses: warm-up {[round(v, 4) for v in values[:VIT_WARMUP]]}, pipelined "
        f"{[round(v, 4) for v in pipelined]}, resident "
        f"{[round(v, 4) for v in values[VIT_WARMUP + VIT_PIPELINED:]]}; launches {launches}; "
        f"K1 against its plain version: {sum(mismatched)} elements differ over "
        f"{len(mismatched)} batches")
    if not all(np.isfinite(values)):
        failures.append(f"non-finite loss {values}")
    if not np.mean(pipelined[-3:]) < values[0]:
        failures.append(f"the loss did not fall: first {values[0]:.4f}, mean of the last 3 "
                        f"pipelined {np.mean(pipelined[-3:]):.4f}")
    if any(mismatched):
        failures.append(f"K1 not bit-equal to its plain version: {mismatched}")
    if launches != {KERNEL_NAME: VIT_WARMUP + VIT_PIPELINED}:
        failures.append(f"launches {launches}")

    batch = last[0]

    def resident():
        nonlocal params
        params, loss, _ = step(params, batch)
        loss.item()
    profile_step(resident, "resident ViT-B/16 train step", VIT_GROUPS, top=8)
    log(f"[converter] float32 forward of {VIT_F32_ROWS} images of the first batch on the initial "
        f"weights, card (TF32 off) against CPU, max |diff| / max |logit|: "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + f" (bar {VIT_F32_BAR:g}; the "
        f"controls must miss it)")
    if not errs["port"] <= VIT_F32_BAR:
        failures.append(f"float32 card against CPU {errs['port']:.3g}")
    for control in ("exact-erf GELU", "unbiased variance"):
        if not errs[control] > VIT_F32_BAR:
            failures.append(f"the {control} control passed the float32 bar ({errs[control]:.3g})")

    del params, batch, last[:]
    free_cuda()

    # (b) The MNIST MLP, the example's store and loop.
    from examples.torch_mnist.main import synthetic_mnist, train as mnist_train, write_dataset
    mnist_url = f"file://{tmp}/mnist"
    t0 = time.perf_counter()
    images, labels = synthetic_mnist(MNIST_ROWS)
    write_dataset(mnist_url, images, labels)
    log(f"[mnist] wrote {MNIST_ROWS} rows in {time.perf_counter() - t0:.2f} s")
    kernels.reset_launch_counts()
    result = mnist_train(mnist_url, epochs=MNIST_EPOCHS, batch_size=MNIST_BATCH, device="cuda",
                         log=lambda line: log(f"[mnist] {line}"))
    mnist_launches = dict(kernels.launch_counts)
    log(f"[mnist] ({smi}) {result['steps']} steps over {MNIST_EPOCHS} epochs: "
        f"{result['samples_per_sec']:.1f} samples/s, accuracy of the last 10 steps "
        f"{result['accuracy']:.4f} (bar {MNIST_ACC_BAR}); launches {mnist_launches}")
    if not result["accuracy"] > MNIST_ACC_BAR:
        failures.append(f"MNIST accuracy {result['accuracy']:.4f}")
    if mnist_launches:
        failures.append(f"MNIST launches {mnist_launches}")

    # (c) The torch adapter over (b)'s store, default device.
    t0 = time.perf_counter()
    rows, bad = 0, []
    spec = TransformSpec(_with_even, edit_fields=[("even", np.bool_, (), False)])
    with make_reader(mnist_url, num_epochs=1, shuffle_row_groups=False,
                     transform_spec=spec) as reader:
        for b in torch_adapter.DataLoader(reader, batch_size=MNIST_BATCH):
            devices = {str(v.device) for v in b.values()}
            if devices != {"cuda:0"} or b["even"].dtype != torch.uint8 \
                    or not torch.equal(b["even"], (b["label"] % 2 == 0).to(torch.uint8)):
                bad.append((devices, b["even"].dtype))
            rows += len(b["label"])
    log(f"[adapter] petastorm_tpu_torch.pytorch.DataLoader over the MNIST store: {rows} rows in "
        f"{time.perf_counter() - t0:.2f} s, every tensor on cuda:0, the bool column as uint8"
        + (f"; WRONG in {len(bad)} batches: {bad[:3]}" if bad else ""))
    if bad or rows != MNIST_ROWS // MNIST_BATCH * MNIST_BATCH:
        failures.append(f"adapter: {rows} rows, {bad[:3]}")
    free_cuda()
    if failures:
        raise AssertionError("converter -> ViT-B/16 and MNIST: " + "; ".join(failures))
    return {KERNEL_NAME: launches.get(KERNEL_NAME, 0)}


class _StampedIterator:
    """``next(inner)``, the moment each delivery returned kept in ``stamps``."""

    def __init__(self, inner):
        self._inner = inner
        self.stamps = []

    def __iter__(self):
        return self

    def __next__(self):
        item = next(self._inner)
        self.stamps.append(time.perf_counter())
        return item


@contextlib.contextmanager
def _telemetry_env(mode: str):
    """The telemetry environment of readers made inside: ``"off"`` (the
    default), ``"spans"`` or ``"trace"``."""
    names = {"spans": "PETASTORM_TPU_TELEMETRY_SPANS", "trace": "PETASTORM_TPU_TELEMETRY_TRACE"}
    saved = {n: os.environ.pop(n, None) for n in names.values()}
    if mode != "off":
        os.environ[names[mode]] = "1"
    try:
        yield
    finally:
        for n, v in saved.items():
            os.environ.pop(n, None)
            if v is not None:
                os.environ[n] = v


def _per_batch_ms(breakdown: dict, batches: int) -> str:
    return ", ".join(f"{k} {1e3 * v / max(1, batches):.2f}" for k, v in breakdown.items())


def _decode_store(url: str) -> None:
    """Phase 21 (d)'s store: the tensor_50k schema (``id``, ``f0..f7``
    float32) with its two 64-float embeddings as ``NdarrayCodec`` cells."""
    from petastorm_tpu_torch.codecs import NdarrayCodec
    schema = Unischema("Tensor50kCells", [
        UnischemaField("id", np.int64, (), ScalarCodec(np.int64), False)]
        + [UnischemaField(f"f{i}", np.float32, (), ScalarCodec(np.float32), False)
           for i in range(8)]
        + [UnischemaField(f"emb{j}", np.float32, (64,), NdarrayCodec(), False) for j in range(2)])
    rng = np.random.default_rng(0)
    with materialize_dataset_local(url, schema, rows_per_row_group=PH21_DECODE_GROUP) as w:
        for start in range(0, PH21_DECODE_ROWS, PH21_DECODE_GROUP):
            n = min(PH21_DECODE_GROUP, PH21_DECODE_ROWS - start)
            f = rng.standard_normal((n, 8)).astype(np.float32)
            e = rng.standard_normal((n, 2, 64)).astype(np.float32)
            w.write_rows([{"id": start + i, **{f"f{k}": f[i, k] for k in range(8)},
                           "emb0": e[i, 0], "emb1": e[i, 1]} for i in range(n)])


def _decode_turn(url: str, per_cell: bool) -> tuple:
    """One read of (d)'s store: rows/s from the call, and the embeddings
    stacked in id order. ``per_cell`` swaps the batch decode for one
    ``np.load`` a cell (the decode before the fast paths)."""
    import io as io_module
    from petastorm_tpu_torch import codecs as codecs_module
    from petastorm_tpu_torch.utils import decode as decode_module
    saved = decode_module.batch_decode_ndarrays, codecs_module.NdarrayCodec.decode
    if per_cell:
        decode_module.batch_decode_ndarrays = lambda *args: None
        codecs_module.NdarrayCodec.decode = \
            lambda self, field, encoded: np.load(io_module.BytesIO(encoded), allow_pickle=False)
    try:
        t0 = time.perf_counter()
        with make_reader(url, workers_count=PH21_DECODE_WORKERS, shuffle_row_groups=False,
                         schema_fields=["id", "emb0", "emb1"]) as reader:
            rows = [(r.id, r.emb0, r.emb1) for r in reader]
        wall = time.perf_counter() - t0
    finally:
        decode_module.batch_decode_ndarrays, codecs_module.NdarrayCodec.decode = saved
    rows.sort(key=lambda r: r[0])
    return len(rows) / wall, np.stack([r[1] for r in rows]), np.stack([r[2] for r in rows])


def phase_telemetry(smi: str, slice_url: str, converter_url: str, tmp: str) -> dict:
    from petastorm_tpu_torch.benchmark.throughput import training_input_stall
    failures = []
    side = vit.VIT_B16["image_size"]
    converter = SparkDatasetConverter(converter_url, CONV_ROWS)
    kernels.reset_launch_counts()

    # (a) Where the ViT-B/16 input wait goes.
    free_cuda()
    params = vit.init_params(torch.Generator(device="cuda").manual_seed(0), device="cuda",
                             **vit.VIT_B16)
    step = vit.make_train_step(VIT_LR, patch=vit.VIT_B16["patch"], heads=vit.VIT_B16["heads"])
    stepped = []

    def vit_step(batch):
        nonlocal params
        pixels = batch["image"].view(-1, side, side, 3)
        images = normalize_images(pixels)
        check_close(images, normalize_images_plain(pixels), f"(a) batch {len(stepped)}")
        params, loss, _ = step(params, {"image": images, "label": batch["label"]})
        stepped.append(loss)
        return loss

    with _telemetry_env("spans"):
        loader = converter.make_device_loader(batch_size=VIT_BATCH, num_epochs=None,
                                              workers_count=VIT_WORKERS, shuffle_row_groups=True,
                                              seed=0)
    with loader:
        spans_on = loader.telemetry.recorder.enabled
        it = _StampedIterator(iter(loader))
        tis = training_input_stall(loader, vit_step, steps=PH21_STEPS, it=it)
        next(it)   # the closing delivery: it records the last step's busy time
        wall = it.stamps[-1] - it.stamps[0]
        delivered = len(it.stamps) - 1
        stall, breakdown = loader.stall_report(), loader.stage_breakdown()
        critical = loader.critical_path_report()
        snap = loader.telemetry.snapshot()
        staged = loader.metrics.batches
        # Then phase 20's regime: pipelined steps, one sync at the end.
        _, _, pipe_wait, pipe_wall, _ = pipelined_window(
            vit_step, lambda: next(it), VIT_PIPELINED, 0, stepped[-1])
        next(it)
        pipe = {"stall": loader.stall_report(), "breakdown": loader.stage_breakdown(),
                "critical": loader.critical_path_report()["counts"],
                "staged": loader.metrics.batches - staged}
        it._inner.close()
    accounted = stall["delivery_wait_s"] + stall["consumer_busy_s"]
    losses = [v.item() for v in stepped]
    log(f"[telemetry] (a) ({smi}) converter -> K1 -> ViT-B/16, batch {VIT_BATCH}, spans "
        f"{'on' if spans_on else 'OFF'}: {delivered} batches after the first in {wall:.3f} s; "
        f"stall_report: steps {stall['steps']}, input_stall_pct {stall['input_stall_pct']:.2f} "
        f"(training_input_stall over the same steps: {tis['input_stall_percent']:.2f}; its wait "
        f"{1e3 * tis['wait_s'] / tis['steps']:.2f} ms a step against the gauge's "
        f"{1e3 * stall['delivery_wait_s'] / stall['steps']:.2f}), "
        f"verdict {stall['verdict']} {stall['counts']}, delivery wait {stall['delivery_wait_s']:.4f} "
        f"+ consumer busy {stall['consumer_busy_s']:.4f} = {accounted:.4f} s against the loop's "
        f"{wall:.4f} s; host side {stall['host_side']}")
    log(f"[telemetry] (a) stage_breakdown, ms a staged batch ({staged} staged): "
        f"{_per_batch_ms(breakdown, staged)}; critical path {critical['counts']} "
        f"(dominant {critical['dominant']}); reader.pool_wait_s p50/p99 "
        f"{snap['histograms']['reader.pool_wait_s']['p50']:.4f}/"
        f"{snap['histograms']['reader.pool_wait_s']['p99']:.4f} s, worker.decode_s p50 "
        f"{snap['histograms']['worker.decode_s']['p50']:.4f} s over "
        f"{snap['histograms']['worker.decode_s']['count']} groups; spans "
        f"{ {k: (v['count'], round(v['total_s'], 4)) for k, v in snap['spans'].items()} }; "
        f"losses {[round(v, 4) for v in losses]}")
    delta = {k: pipe["stall"][k] - stall[k]
             for k in ("steps", "delivery_wait_s", "consumer_busy_s")}
    log(f"[telemetry] (a) {VIT_PIPELINED} pipelined steps (phase 20's regime): "
        f"pipelined_window's wait {1e3 * pipe_wait / VIT_PIPELINED:.2f} ms a step, stall "
        f"{100 * pipe_wait / pipe_wall:.2f} % of {pipe_wall:.3f} s; the gauge over the same "
        f"{delta['steps']} deliveries: wait {1e3 * delta['delivery_wait_s'] / VIT_PIPELINED:.2f} "
        f"ms a step, input stall {100 * delta['delivery_wait_s'] / max(1e-9, delta['delivery_wait_s'] + delta['consumer_busy_s']):.2f} %; "
        f"stage_breakdown over its {pipe['staged']} staged batches, ms a batch: "
        + _per_batch_ms({k: pipe["breakdown"][k] - breakdown[k] for k in breakdown},
                        pipe["staged"])
        + f"; critical path {pipe['critical']}")
    if not spans_on:
        failures.append("(a) spans were not on")
    if stall["steps"] != delivered:
        failures.append(f"(a) stall steps {stall['steps']} for {delivered} batches delivered")
    if abs(accounted - wall) > PH21_WALL_REL_BAR * wall:
        failures.append(f"(a) wait + busy {accounted:.4f} s against the loop's {wall:.4f} s")
    if set(breakdown) != JAX_STAGE_KEYS:
        failures.append(f"(a) stage_breakdown keys {sorted(breakdown)}")
    if not all(np.isfinite(losses)):
        failures.append(f"(a) non-finite loss {losses}")
    del params, stepped
    free_cuda()

    # (b) The image path on processes in trace mode, and the zero-copy leg.
    params = resnet.init_params(torch.Generator(device="cuda").manual_seed(0),
                                IMAGENET_CLASSES, device="cuda")
    init_opt, raw_step = resnet.make_train_step(learning_rate=0.05)
    opt = init_opt(params)
    trace_path = os.path.join(tmp, "image_trace.json")
    losses, batches = [], 0
    with _telemetry_env("trace"):
        reader = make_reader(slice_url, reader_pool_type="process", workers_count=WORKERS,
                             seed=0)
    with DataLoader(reader, batch_size=BATCH, device="cuda") as loader:
        for batch in loader:
            images = normalize_images(batch["image"])
            check_close(images, normalize_images_plain(batch["image"]), f"(b) batch {batches}")
            params, opt, loss, _ = raw_step(params, opt, {
                "image": images, "label": batch["id"] % IMAGENET_CLASSES})
            losses.append(loss.item())
            batches += 1
        spans = [sp.as_dict() for sp in reader.telemetry.recorder.spans()]
        exported = loader.export_trace(trace_path)
        groups = reader.diagnostics["items_processed"]
        worker_pids = set(reader.pool.worker_pids)
    with open(trace_path) as f:
        trace = json.load(f)
    by_name = collections.Counter(e["name"] for e in trace["traceEvents"] if e["ph"] in "Xi")
    decode = [sp for sp in spans if sp["name"] == "petastorm_tpu.worker_decode"]
    lineages = {sp["trace"] for sp in decode}
    log(f"[telemetry] (b) ({smi}) phase 4's store on {WORKERS} processes, trace mode -> "
        f"DataLoader({BATCH}) -> K1 -> ResNet-50: {batches} batches, losses "
        f"{[round(v, 4) for v in losses]}; {len(decode)} worker decode spans from "
        f"{len({sp['pid'] for sp in decode})} worker pids for {groups} row groups, "
        f"{len(lineages)} lineages; export_trace wrote {exported} spans to a Chrome trace of "
        f"{len(trace['traceEvents'])} events, by name {dict(by_name)}")
    if batches != ROWS // BATCH or not all(np.isfinite(losses)):
        failures.append(f"(b) {batches} batches, losses {losses}")
    if len(decode) != groups or not {sp["pid"] for sp in decode} <= worker_pids:
        failures.append(f"(b) {len(decode)} decode spans for {groups} groups, pids "
                        f"{ {sp['pid'] for sp in decode} } against workers {worker_pids}")
    if len(lineages) != groups:
        failures.append(f"(b) {len(lineages)} lineages for {groups} groups")
    for name in ("petastorm_tpu.worker_decode", "petastorm_tpu.host_batch",
                 "petastorm_tpu.stage"):
        if not by_name.get(name):
            failures.append(f"(b) the Chrome trace has no {name} span")
    if exported != len(spans):
        failures.append(f"(b) exported {exported} spans of {len(spans)}")
    del params, opt, init_opt, raw_step
    free_cuda()

    with _telemetry_env("trace"):
        reader = make_batch_reader(converter_url, reader_pool_type="process",
                                   workers_count=PH21_BATCH_WORKERS, shuffle_row_groups=False)
    zc_batches = 0
    with BatchedDataLoader(reader, batch_size=VIT_BATCH, device="cuda") as loader:
        for batch in loader:
            pixels = batch["image"].view(-1, side, side, 3)
            check_close(normalize_images(pixels), normalize_images_plain(pixels),
                        f"(b) converter batch {zc_batches}")
            zc_batches += 1
        counters = reader.telemetry.snapshot()["counters"]
        items = reader.diagnostics["items_processed"]
        pool_counters = dict(reader.counters)
        decode_spans = sum(sp.name == "petastorm_tpu.worker_decode"
                           for sp in reader.telemetry.recorder.spans())
    log(f"[telemetry] (b) phase 20's store on {PH21_BATCH_WORKERS} processes -> "
        f"BatchedDataLoader({VIT_BATCH}) -> K1: {zc_batches} batches, {items} ring records "
        f"(row groups) delivered, transport.zero_copy_batches "
        f"{counters.get('transport.zero_copy_batches')}, zero_copy_bytes "
        f"{counters.get('transport.zero_copy_bytes')} (the pool's {pool_counters}), "
        f"transport.deserialize_s {counters.get('transport.deserialize_s', 0):.4f}, "
        f"{decode_spans} worker decode spans")
    if counters.get("transport.zero_copy_batches") != items or items != CONV_ROWS // \
            CONV_ROWS_PER_GROUP:
        failures.append(f"(b) zero-copy batches {counters.get('transport.zero_copy_batches')} "
                        f"for {items} ring records")
    if counters.get("transport.zero_copy_bytes") != pool_counters.get("zero_copy_bytes") \
            or decode_spans != items:
        failures.append(f"(b) zero-copy bytes {counters.get('transport.zero_copy_bytes')}, "
                        f"pool {pool_counters}, {decode_spans} decode spans")
    free_cuda()

    # (c) The converter loader alone, spans off / on / trace mode, in turns.
    rates = collections.defaultdict(list)
    for turn in range(PH21_OVH_TURNS + 1):
        # The first turn (spans off) warms the host and is not counted.
        for mode in (("off", "spans", "trace") if turn else ("warm-up",)):
            with _telemetry_env("off" if mode == "warm-up" else mode):
                loader = converter.make_device_loader(
                    batch_size=VIT_BATCH, num_epochs=None, workers_count=VIT_WORKERS,
                    shuffle_row_groups=True, seed=0)
            with loader:
                it = iter(loader)
                next(it)
                t0 = time.perf_counter()
                for _ in range(PH21_OVH_BATCHES):
                    next(it)
                torch.cuda.synchronize()
                rates[mode].append(PH21_OVH_BATCHES * VIT_BATCH / (time.perf_counter() - t0))
                it.close()
    log(f"[telemetry] (c) ({smi}) the converter loader alone, {PH21_OVH_BATCHES} batches of "
        f"{VIT_BATCH} after the first, samples/s by turn: "
        + "; ".join(f"{m} {[round(r, 1) for r in v]}" for m, v in rates.items()
                    if m != "warm-up")
        + " (no speed bar)")

    # (d) The NdarrayCodec batch decode against per-cell np.load.
    decode_url = f"file://{tmp}/tensor50k_cells"
    t0 = time.perf_counter()
    _decode_store(decode_url)
    log(f"[telemetry] (d) wrote {PH21_DECODE_ROWS} rows of the tensor_50k schema with "
        f"NdarrayCodec embeddings in {time.perf_counter() - t0:.2f} s")
    decoded = {}
    rows_per_s = collections.defaultdict(list)
    for _ in range(PH21_DECODE_TURNS):
        for mode in ("batch", "np.load"):
            rate, emb0, emb1 = _decode_turn(decode_url, per_cell=mode == "np.load")
            rows_per_s[mode].append(rate)
            if mode in decoded:
                same = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                           for a, b in zip(decoded[mode], (emb0, emb1)))
                if not same:
                    failures.append(f"(d) {mode}: two reads differ")
            decoded[mode] = (emb0, emb1)
    equal = all(np.array_equal(a.view(np.int32), b.view(np.int32))
                for a, b in zip(decoded["batch"], decoded["np.load"]))
    log(f"[telemetry] (d) ({smi}) make_reader on {PH21_DECODE_WORKERS} threads, rows/s by turn: "
        + "; ".join(f"{m} {[round(r, 1) for r in v]}" for m, v in rows_per_s.items())
        + f"; the two decodes bit-equal: {equal} ({decoded['batch'][0].shape} x 2)")
    if not equal or decoded["batch"][0].shape != (PH21_DECODE_ROWS, 64):
        failures.append(f"(d) decodes bit-equal {equal}, shape {decoded['batch'][0].shape}")
    launches = dict(kernels.launch_counts)
    expect = PH21_STEPS + 1 + VIT_PIPELINED + ROWS // BATCH + CONV_ROWS // VIT_BATCH
    if launches != {KERNEL_NAME: expect}:
        failures.append(f"launches {launches}, expected {KERNEL_NAME}: {expect}")
    log(f"[telemetry] launches {launches}")
    if failures:
        raise AssertionError("telemetry phase: " + "; ".join(failures))
    return {KERNEL_NAME: launches.get(KERNEL_NAME, 0)}


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t`` seen as integers of its width, so that equality is bit equality."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


#: Seconds each phase took in this run, by name, in order.
PHASE_SECONDS: dict = {}


def timed(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, its seconds kept under ``name`` in
    ``PHASE_SECONDS``."""
    t0 = time.perf_counter()
    out = fn(*args, **kwargs)
    PHASE_SECONDS[name] = time.perf_counter() - t0
    log(f"[smoke] phase {name}: {PHASE_SECONDS[name]:.1f} s")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    t_run = time.perf_counter()
    smi = timed("1 probe", phase_probe)
    timed("2 build", phase_build)
    k1, k1_strided = timed("3 kernels", phase_kernels)
    # Phase 11 reads the stores of phases 4, 8 and 9 again, phase 13 phase 9's,
    # phase 15 those of phases 8, 9 and 12, phase 16 those of phases 4, 8 and 12.
    with tempfile.TemporaryDirectory() as slice_tmp, \
            tempfile.TemporaryDirectory() as train_tmp, \
            tempfile.TemporaryDirectory() as image_tmp, \
            tempfile.TemporaryDirectory() as columnar_tmp:
        launches = timed("4 slice", phase_slice, slice_tmp)
        k2_rows = timed("5 flash", phase_flash)
        with tempfile.TemporaryDirectory() as tmp:
            k2_launches = timed("6 tokens", phase_tokens, tmp)
        bwd = timed("7 flash bwd", phase_flash_bwd)
        counts, single_reader = timed("8 train", phase_train, train_tmp)
        thread_bench = timed("9 imagenet", phase_imagenet, image_tmp)
        stats = timed("K2 stats", phase_stats)
        with tempfile.TemporaryDirectory() as tmp:
            seq = timed("10 seq parallel", phase_seq_parallel, tmp)
        proc = timed("11 process", phase_process, f"file://{slice_tmp}/imagenet_like",
                     f"file://{train_tmp}/tokens", f"file://{image_tmp}/imagenet", thread_bench)
        free_cuda()
        columnar = timed("12 columnar", phase_columnar, columnar_tmp)
        # Phase 13 reads phase 9's store again, phase 14 phase 9's and 8's.
        resume = timed("13 resume", phase_resume, f"file://{image_tmp}/imagenet", thread_bench)
        free_cuda()
        with tempfile.TemporaryDirectory() as tmp:
            select = timed("14 selection", phase_selection, f"file://{image_tmp}/imagenet",
                           f"file://{train_tmp}/tokens", tmp)
        free_cuda()
        with tempfile.TemporaryDirectory() as tmp:
            epoch = timed("15 epoch plane", phase_epoch_plane, smi,
                          f"file://{image_tmp}/imagenet", f"file://{train_tmp}/tokens",
                          f"file://{columnar_tmp}/tensor", columnar, tmp)
        free_cuda()
        mesh = timed("16 mesh", phase_mesh, smi, f"file://{train_tmp}/tokens",
                     f"file://{columnar_tmp}/scalar_100k", f"file://{slice_tmp}/imagenet_like",
                     single_reader)
        free_cuda()
        lazy = timed("17 lazy + dp resnet", phase_lazy_dp, smi,
                     f"file://{slice_tmp}/imagenet_like", f"file://{image_tmp}/imagenet")
        free_cuda()
        tp = timed("18 tensor parallel", phase_tensor_parallel, smi, f"file://{train_tmp}/tokens")
        free_cuda()
        fsdp = timed("19 fsdp + pipeline + dryrun", phase_fsdp_pipeline, smi,
                     f"file://{train_tmp}/tokens")
        free_cuda()
        with tempfile.TemporaryDirectory() as tmp:
            conv = timed("20 converter + vit", phase_converter_vit, smi, tmp)
            free_cuda()
            # Phase 21 reads phase 4's store and phase 20's converter store.
            tele = timed("21 telemetry", phase_telemetry, smi,
                         f"file://{slice_tmp}/imagenet_like", f"file://{tmp}/converter_cache",
                         tmp)
    log(f"[smoke] ({smi}) seconds by phase "
        f"{ {n: round(t, 1) for n, t in PHASE_SECONDS.items()} }; the whole run "
        f"{time.perf_counter() - t_run:.1f} s")
    for name in (flash_attn.KERNEL_NAME, flash_attn.BWD_DQ_KERNEL_NAME,
                 flash_attn.BWD_DKV_KERNEL_NAME):
        counts[name] += proc[name] + epoch[name] + mesh[name]
    for name in TP_KERNELS:
        counts[name] = counts.get(name, 0) + tp[name] + fsdp[name]
    source = "petastorm_tpu_torch/csrc/flash_attn_bwd.cu"
    print(json.dumps({"kernels": [{
        "name": KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/image_ops.py:27",
        "launches": (launches + proc["normalize"] + resume.get(KERNEL_NAME, 0)
                     + select[KERNEL_NAME] + epoch[KERNEL_NAME] + mesh[KERNEL_NAME]
                     + lazy[KERNEL_NAME] + conv[KERNEL_NAME] + tele[KERNEL_NAME]),
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"], "plain_ms": k1["plain_ms"], "bound_ms": k1["bound_ms"],
        "bound_by": "bytes", "library_ms": None}, {
        # K1's general route (any strides, any channel count): timed on the
        # main path's batch cropped to 208x208; no main path launches it
        # (phase 13's augmentations hand K1 contiguous batches).
        "name": STRIDED_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/normalize.cu",
        "replaces": "petastorm_tpu/ops/image_ops.py:27",
        "launches": resume.get(STRIDED_KERNEL_NAME, 0), **k1_strided,
        "bound_by": "bytes", "library_ms": None}, {
        "name": flash_attn.KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        # The token forward's launches ("out"), the training path's and
        # Ulysses' ("lse").
        "launches": (k2_launches + counts[flash_attn.KERNEL_NAME] + seq[flash_attn.KERNEL_NAME]
                     + select[flash_attn.KERNEL_NAME]),
        **k2_rows["K2"]}, {
        # The FMA route (f32, 16-bit d > 128 or d % 8 != 0): timed forced at
        # the token path's bf16 shape; the main paths never launch it.
        "name": flash_attn.FMA_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        "launches": counts[flash_attn.FMA_KERNEL_NAME] + seq[flash_attn.FMA_KERNEL_NAME],
        **k2_rows["K2 fma"]}, {
        # K2 "stats": the ring's local step; timed at a strictly-past block.
        "name": flash_attn.STATS_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        "launches": seq[flash_attn.STATS_KERNEL_NAME] + counts[flash_attn.STATS_KERNEL_NAME],
        **stats["stats"]}, {
        "name": flash_attn.STATS_FMA_KERNEL_NAME, "route": "cuda",
        "source": "petastorm_tpu_torch/csrc/flash_attn.cu",
        "replaces": "petastorm_tpu/ops/flash_attn.py:89",
        "launches": seq[flash_attn.STATS_FMA_KERNEL_NAME] + counts[flash_attn.STATS_FMA_KERNEL_NAME],
        **stats["stats fma"]}, {
        "name": flash_attn.BWD_DQ_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:272",
        "launches": counts[flash_attn.BWD_DQ_KERNEL_NAME] + seq[flash_attn.BWD_DQ_KERNEL_NAME],
        **bwd["K3"]}, {
        "name": flash_attn.BWD_DKV_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:305",
        "launches": counts[flash_attn.BWD_DKV_KERNEL_NAME] + seq[flash_attn.BWD_DKV_KERNEL_NAME],
        **bwd["K4"]}, {
        # The FMA route (f32, 16-bit d > 128 or d % 8 != 0): timed forced at
        # the token path's bf16 shape; the main path never launches it.
        "name": flash_attn.BWD_DQ_FMA_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:272",
        "launches": (counts[flash_attn.BWD_DQ_FMA_KERNEL_NAME]
                     + seq[flash_attn.BWD_DQ_FMA_KERNEL_NAME]),
        **bwd["K3 fma"]}, {
        "name": flash_attn.BWD_DKV_FMA_KERNEL_NAME, "route": "cuda", "source": source,
        "replaces": "petastorm_tpu/ops/flash_attn.py:305",
        "launches": (counts[flash_attn.BWD_DKV_FMA_KERNEL_NAME]
                     + seq[flash_attn.BWD_DKV_FMA_KERNEL_NAME]),
        **bwd["K4 fma"]}]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
