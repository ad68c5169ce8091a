#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper,
``sm_90a``).  It builds the port's kernels from the checkout's sources
into ``build/torch_kernels/`` and drives the port's three paths: the
SPARK-fed training path (the main path), in-process training and
serving, plus the ``fused_rmsnorm`` entry point, and ResNet-50 in
process and SPARK-fed (which launches none of the kernels), then the
TFRecord paths: ResNet-50 fed from TFRecord shards in process and
SPARK-fed (the executor reads the shards), MNIST under
``InputMode.TENSORFLOW``, and the online serving tier
(``serving.Server`` over a 2-replica ``ReplicaPool``, its HTTP frontend
and ``TFCluster.serve``) and, after phase 16, ResNet-50 SPARK-fed from
JPEG TFRecord shards through the native libjpeg decoder with the raw
shards ``imagenet_data_setup`` converts from them, remote (``memory://``)
record IO and checkpoints, the ``AsyncCheckpointer`` and MNIST's chief
checkpoint, then the Spark ML pipeline and SPARK-mode
inference (``TFEstimator.fit``, ``TFModel.transform``,
``TFCluster.inference()``, ps and evaluator nodes, the batch-inference
CLI and ``parallel_run``), then the MobileNetV2-UNet segmentation model
(BASELINE.json config 4) in process and SPARK-fed, the data service
(``cluster.train`` of a ``data.Pipeline``, static and dynamic dispatch,
a data worker killed mid-split), and last the streaming feed
(``TFCluster.train_stream``, a STOP from outside) with the eval
sidecar evaluating its checkpoints, a successive-halving sweep of
actors on the card, and the serving tier's elastic pool, fabric and
deploy loop on the full-width transformer.  It builds the
host-native feed ring, marshal, TFRecord codec and JPEG decoder
(``tensorflowonspark_tpu_torch/native/``) into ``build/torch_native/``
too:

0. preflight: a CUDA device must be present (else exit 2 at once); the
   card's name and power limit from ``nvidia-smi``; whether the host has
   libjpeg's ``jpeglib.h`` and library, PIL and the libjpeg its wheel
   bundles, and fsspec's version (``host`` line, reported only); TF32
   off for float32 matmuls and convolutions, bf16 and float16 matmuls
   accumulate in float32;
1. build every kernel library (the flash sources once per head_dim and
   dtype, and once per dtype for the chunked kernels of any head_dim
   above 256, one ``nvcc`` each, as many at once as the host has cores;
   before any executor is spawned), and the feed's shm ring and the
   TFRecord codec (``g++``, started together; a failure of either fails
   the run) and marshal (``cc``; the numpy marshal runs where it cannot
   build): their seconds, which marshal and codec, ``/dev/shm``'s free
   bytes and the ring's capacity (``native build`` line); the ``ptxas``
   registers and spills of every kernel; the bf16 and float16 flash
   kernels (forward, dq, dk/dv) must issue tensor-core MMAs (``HMMA`` in
   their SASS, read with ``cuobjdump``) and spill nothing up to head_dim
   128 and in the chunked kernels, the float32 ones none; every flash
   kernel's registers, shared
   memory, local bytes and CTAs an SM as the card holds it;
2. the flash forward kernel (bf16 and float16: tensor cores; float32:
   FMAs) against its plain PyTorch version on the card, at the main
   path's shapes, Pythia's and Gemma-2B's, the tail / head_dim cases,
   the padded head_dims, head_dim 320, 512 and 1024 (the chunked
   kernels) and 65,600 batch x heads, with times beside its bound and a
   library call (SDPA, with the backend it picked);
3. the flash backward's dq and dk/dv kernels (bf16 and float16: tensor
   cores; float32: FMAs) against ``flash_backward_plain`` in the same cases,
   timed the same way (the library call is SDPA's backward);
4. the RMSNorm kernel against ``rmsnorm_reference`` at the transformer's
   activation shape in bf16 and float32 and at tail shapes (scalar
   path, ragged rows, a misaligned input), forward and gradient through
   ``fused_rmsnorm``, each case naming the kernel path it took (the
   one-pass registers path or the two-pass path); times beside its
   bound and ``F.rms_norm``;
5. training at full width (the repo's on-chip transformer config,
   bf16, batch 8): five Adam(1e-3) steps fed through
   ``prefetch_to_device``; every loss finite and the loss falling; the
   forward, dq and dk/dv kernels each launched once per layer per step;
   ``remat=True`` and ``remat="dots"`` give the same loss, running the
   forward twice; the blockwise CE gives the dense loss; a profiled
   rerun splits the device time by kernel group;
6. the same training SPARK-fed (the main path): ``cluster.run`` on a
   one-executor ``LocalEngine`` with ``num_gpus=1``, the same batch as
   8 token records a step through the rendezvous, the node's GPU claim,
   a forked trainer, ``torch_initialize``, the node's shm ring (columnar
   chunks; any other transport fails the phase), ``DataFeed`` and
   ``device_feed``; its five losses equal phase 5's, each flash kernel
   launched 8 times a step in the trainer, every partition consumed
   once (the rendezvous ledger) and no trainer left after shutdown; the
   line splits each partition's hand-off (engine hop, encode, ring
   put, pop, the feeder's poll, pop to the next put, pinned copy);
7. gradient exactness at full width in float32: one step's loss and
   every parameter's gradient through the kernels equal those through
   ``mha_reference`` attention, which never touches a kernel;
8. serving at full width (bf16): a paged, prefix-sharing
   ``DecodeEngine`` answers 16 sessions; every token index streams once
   and in order, the prefix trie is hit, the cache ends empty with no
   leaked block, and the flash kernel ran on every layer of every plain
   prefill;
9. token-exactness at full width in float32: ``DecodeEngine`` greedy
   tokens equal the full-recompute ``greedy_decode_reference`` with
   ``mha_reference`` attention;
10. ResNet-50 in process at the north-star shape (1000 classes, 224x224
    uint8 images, batch 256, bf16 compute, SGD(0.1, momentum 0.9)): one
    ``bn_fused=False`` step (its loss equals the fused first step's; its
    peak memory), two warm-up and six timed steps on one seeded batch
    (images/s, MFU, peak memory; every loss finite, every BN running
    statistic finite and moved off (0, 1)), the space-to-depth stem
    against the 7x7 stem in bf16 and float32, and a profiled rerun split
    into convolutions (forward, dgrad, wgrad), BN statistics,
    elementwise work, the optimizer and copies; no transformer kernel
    launched;
11. one float32 ResNet-50 step (TF32 off) at batch 4, 64x64, on the card
    against the same step on the CPU: loss, every gradient, new BN state;
12. ResNet-50 SPARK-fed (this slice's main path): ``cluster.run`` of
    ``resnet_imagenet_spark.main_fun`` on the one-executor engine with
    ``num_gpus=1``, phase 10's batch as 256 (uint8 image, label) records
    a step for six steps through the node's shm ring as columnar chunks
    (any other transport fails the phase), ``DataFeed`` and
    ``device_feed(columnar=True)``; its losses equal phase 10's first
    six, every partition consumed once, no trainer left, and the chief's
    checkpoint (HWIO on disk) restores in this process into params whose
    loss is phase 10's seventh; the hand-off split as in phase 6;
13. the same six partitions on a second one-executor engine whose
    executor has ``TFOS_SHM_FEED=0`` (``spark_resnet_manager``): columnar
    chunks through the manager queue, the same gates, so the ring and
    the manager queue compare on one card in one run;
14. TFRecord IO (``tfrecord_io``): phase 10's batch as six raw-uint8
    shards of 256 records (``"image"`` 150,528 bytes, ``"label"``
    int64; ~38.6 MB a shard) through the native writer, read back
    through ``TFRecordReader`` and ``load_columnar`` with the same bytes
    and labels; write and read MB/s; the native codec must have run;
15. ``InputMode.TENSORFLOW``'s fast path at the north-star size
    (``tfrecord_resnet``): ``infeed.tfrecord_device_feed`` over those
    shards feeds phase 10's step for six steps in process, losses equal
    phase 10's first six; images/s, the stall and the ``tfrecord_read``
    span a batch;
16. this slice's main path (``spark_tfrecord_resnet``): ``cluster.run``
    of ``resnet_imagenet_spark.main_fun`` (``num_gpus=1``) fed
    ``resnet_imagenet_spark._records`` with ``--data_dir`` on phase
    14's directory: two partitions of three shards' read units, which
    the executor reads and decodes through the engine's lineage, then
    the shm ring as columnar chunks (any other transport fails); phase
    12's gates, no ring left, every task the engine pickled under
    64 KiB, the executor's reader on the native codec and no kernel
    launched in the trainer; images/s end to end, the stall, the device
    step, the hand-off split and the read and decode time a partition;
16a. ``jpeg_decode``: two shards of 256 seeded JPEG records (PIL,
    quality 90; 500x375, 375x500, 1024x768 and 224x224, a quarter each;
    ``image/encoded``, 1-based ``image/class/label``) through the port's
    writer; the native decoder must build (the system's libjpeg, else
    the vendored headers and Pillow's bundled ABI-62 libjpeg: the line
    names the route and file) and pass its self-test; all 512 decode
    natively with 0 PIL arbitrations, on one thread and through
    ``decode_batch``'s pool, with the same bytes; a CMYK JPEG decodes
    through one arbitration; a truncated one raises ValueError; images/s
    of one thread, the pool and the PIL path (``TFOS_NO_NATIVE=1`` in a
    subprocess, one shard), ``os.cpu_count()``;
16b. ``imagenet_setup``: ``imagenet_data_setup.convert`` of those shards
    on the first engine; 0 skipped, and each raw shard equals
    ``decode_records_batch`` of its JPEG records here;
16c. ``spark_jpeg_resnet`` (the JPEG slice's main path): phase 16's run with
    ``--data_dir`` on the JPEG shards (the executor reads and decodes
    them natively, then the shm ring as columnar chunks), and again on
    16b's raw shards, two steps each: losses equal to 1e-3, and the
    chiefs' restored checkpoints' losses on phase 10's batch too; every
    partition once,
    no trainer or ring left, tasks under 64 KiB, every JPEG decoded
    natively in the executor, no kernel launched; images/s, the stall,
    the device step, read and decode ms a partition for both;
16d. ``remote_io``: phase 14's shards through ``memory://`` (fsspec):
    ``TFRecordWriter`` gives the local files' bytes, ``TFRecordReader``
    and ``load_columnar`` read them back as locally (MB/s); a ResNet-50
    checkpoint tree through ``save_checkpoint``/``restore_latest`` and
    ``export_model``/``load_exported`` equals the local round trip;
16e. ``async_checkpoint``: phase 10's net on the card (params, BN state,
    SGD momentum, ~205 MB) saved every 2 steps, twice through
    ``save_checkpoint`` and 3 times through ``AsyncCheckpointer(keep=2)``:
    the ms each save blocks the step loop; each file holds its own
    step's tree and not the next one's (the snapshot check), ``keep``
    prunes, ``close`` waits, a ``checkpoint.save`` fault in the writer
    surfaces at the next call;
16f. ``spark_mnist_checkpoint``: ``mnist_spark.main_fun`` SPARK-fed on
    the card for 4 steps; the chief's ``ckpt`` restores through
    ``restore_latest`` with the export's values, the trainer's final
    params;
17. MNIST under ``InputMode.TENSORFLOW`` (``tf_mode_mnist``), on an
    engine of its own (the executor runs ``main_fun`` on the card, so it
    holds a CUDA context and must fork no SPARK trainer after it):
    ``mnist_data_setup``'s four shards, ``cluster.run`` of
    ``mnist_tf_ds.main_fun`` for 10 steps; every loss finite and equal
    to the same batches stepped here (float32, TF32 off, deterministic
    cuDNN, 1e-5 relative); no kernel launched in the executor's steps;
    the chief's export loads with ``load_exported`` and predicts as the
    trained params do;
18. ``serve_decode``: the full-width transformer (bf16, flash, seed 0)
    exported with ``export_model`` and served by ``serving.Server`` over
    a 2-replica ``ReplicaPool`` (slots 8, paged 16-token blocks, prefix
    sharing, 32 tokens) on a 2-executor engine of its own (each replica
    a CUDA context on the one card); ``serve_http`` on an ephemeral
    port; a first burst of phase 8's mix from another seed (the
    ``cold`` figures), then phase 8's 16 sessions at once as ``POST
    /v1/generate``: each streams indices 0-31 once, tokens in range, the
    replicas' ``flash_fwd`` launches at least ``n_layers`` x their plain
    prefills and no other kernel launched, a prefix hit; TTFT and
    per-token gap p50/p99 from the sessions' own ``ttft_ms`` /
    ``token_ms``, tokens/s, pool boot, each replica's peak memory and
    launches, ``GET /stats``; then ``run_open_loop`` over
    ``Server.generate`` (``SERVE_OPEN_LOOP``);
19. ``serve_exact``: the same pool in float32 (seed 1): phase 9's three
    prompts x 16 greedy tokens through ``Server.generate`` equal
    ``greedy_decode_reference`` with ``mha_reference`` on the card, and
    two of them through HTTP the same;
20. ``serve_failover`` (the float32 pool): 8 sessions in flight, a
    replica SIGKILLed once one of its sessions streams; every session
    completes with each index once and the tokens the same prompts got
    without the kill, the engine respawns the replica (``live_replicas``
    ``[0, 1]`` again), the time back to ``up``;
21. ``serve_reload``: a step-2 checkpoint of other params (seed 2) in
    the pool's ``ckpt_dir``; both replicas report version 2 within
    ``TFOS_SERVE_RELOAD_SECS`` plus ``SERVE_RELOAD_SLACK_S``, and the
    next sessions give the step-2 params' reference tokens;
22. ``serve_predict``: ``TFCluster.serve`` of phase 17's export on phase
    17's cluster after its shutdown; 64 single-image ``POST
    /v1/predict`` requests at once equal ``mnist.predict`` here (float32,
    TF32 off, 1e-5 of the largest logit), at most log2(max_batch)+1
    signatures a replica; then, every pool and its engine stopped
    (``serve_cleanup``): no replica process alive, no ``/dev/shm/tfos-*``
    ring, no child-pid file in the working dir;
23. ``pipeline_fit``: ``TFEstimator(mnist_pipeline.train_fun)`` fit
    SPARK-fed (``num_gpus=1``, 2,048 seeded records, batch 64) on a
    one-executor engine of its own, then ``TFModel.transform`` of 30,000
    seeded MNIST-shaped rows at batch 1,024 on a second, two-executor
    engine, cold and again with the cached model; every loss finite,
    every row back once in order, logits equal ``mnist.predict`` on the
    export here (float32, TF32 off, 1e-5 of the largest logit), the
    model cache loaded once an executor, and a SPARK-mode cluster on
    the second engine refused (its executors hold CUDA contexts); rows/s
    and their MFU (``metrics.mnist_inference_flops_per_row`` a row over
    float32's dense peak; phases 24 and 26 too), the predict's ms a
    batch, each executor's peak memory;
24. ``cluster_inference``: ``TFCluster.inference()`` of 4 partitions of
    5,000 ``(id, image)`` rows into a SPARK-mode trainer on the card
    (``mnist_pipeline.infer_fun``, ``DataFeed.batch_results``) on the
    first engine: every row's result once, in partition order, equal to
    phase 23's reference; rows/s;
25. ``roles``: ``mnist_eval`` with a ps node, an evaluator and a chief on
    a four-executor engine (``InputMode.TENSORFLOW``; the chief and the
    worker train on the card over gloo, ps and evaluator see no GPU, the
    evaluator evaluates each checkpoint on the CPU; TensorBoard asked
    for, its absence said in the line): the roles, eval lines for the
    checkpoint steps, ``shutdown`` returns, and after the engine stops no
    role process, ring or child-pid file; the wall time;
26. ``inference_cli``: ``inference.run`` over phase 17's shards with
    phase 17's export, and ``parallel_run`` of ``mnist_inference`` over
    the same, on the second engine: every record's prediction (the
    CLI's logits too) equal ``mnist.predict`` here;
27. ``segmentation``: the MobileNetV2-UNet in process at the JAX bench
    lane's shape (width 1.0, 21 classes, batch 16 x 256x256x3 seeded
    images and masks, Adam(1e-3)), 2 untimed and 10 timed steps in
    float32 and again in bf16 (f32 masters): ms a step (CUDA events),
    images/s, MFU (3 x the forward's 494,206,976 FLOPs an image, which
    the FLOP counter must give, against the dtype's dense peak, named on
    the line), peak memory, one profiled step's device time by group and
    idle share; every loss finite and the last below the first;
28. ``segmentation_exact``: one float32 step (TF32 off) at 4 x 64x64 on
    the card against the same step on the CPU from one seeded params
    tree, the CPU taking the card's ReLU/ReLU6 branches: loss, logits,
    every gradient and the new BN state within ``SEG_EXACT_RTOL``;
29. ``spark_segmentation``: ``examples/segmentation_spark`` on the first
    engine (``num_gpus=1``), the example's synthetic pets at 256x256,
    width 1.0, batch 16, six partitions of 16 records (~16.8 MB) through
    the node's shm ring as columnar chunks (any other transport fails);
    losses equal the same steps here, every partition once, no trainer
    left, the chief's checkpoint (HWIO) restores through
    ``params_from_jax`` to this process's trained params; images/s, the
    stall, the hand-off split;
30. ``spec_decode``: phase 8's 16 sessions (32 tokens, paged, prefix
    sharing) at full width in bf16 through three engines: plain, a
    narrow draft (dim 256, 2 layers, 4 heads, window 4) and the target
    as its own draft: tokens/s, TTFT p50/p99, iterations, the accept
    rate, flash launches, and the share of sessions whose tokens equal
    the plain run's; streams contiguous and valid, caches drained, the
    flash forward on every layer of each target and draft prefill;
31. ``spec_exact``: the same three runs in float32 (TF32 off) on four
    sessions, two greedy and two seeded-sampled: every speculative
    stream equals the plain one and the self draft accepts every
    proposal (a divergence names its index and the plain run's top-2
    logit gap there);
32. ``parallel_one_rank``: a one-rank NCCL group (``tcp://127.0.0.1``)
    in this process, destroyed after the phase: (a) the full-width bf16
    transformer's step through ``mesh_value_and_grad`` on a
    data x fsdp x seq x model mesh of ones, placed by ``param_specs``,
    Ulysses attention over the flash kernels, against the plain step
    (loss to 1e-6, gradient norm to 1e-2, the train phase's bounds),
    the flash forward, dq and dk/dv once a layer, the wrapped and plain
    steps' ms and the peak memory; (b) ring and zigzag attention at
    [8, 2048, 8, 128] float32 causal within 2e-5 of ``mha_reference``;
    (c) ``moe.apply`` at dim 1024, hidden 4096, 8 experts over 8 x 2048
    tokens in bf16, forward and backward, against its float32 run;
    (d) ``pipeline_apply`` with one stage and 4 microbatches against
    the stage itself;
33. ``dryrun_multichip``: ``parallel.dryrun.dryrun_multichip(8)`` on 8
    gloo CPU ranks of this host: its four ``OK`` lines, the second the
    elastic shrink (4 of the ranks leave, the other 4 re-form a group and
    step at accumulation 2: ``8 virtual -> 4 devices accum=2``); it
    runs on a thread beside phase 36b, after phase 36a;
34. ``spark_recover``: the full-width bf16 transformer (flash) SPARK-fed
    through ``cluster.run(restarts=1, num_gpus=1)`` on a one-executor
    engine of its own, 6 partitions of 8 records, the chief checkpointing
    params and Adam's state every step; the plan ``feed.put:kill@6``
    SIGKILLs the executor while it feeds the 6th partition.  One
    recovery to epoch 1, one respawn, every partition in the ledger once,
    the epoch-1 trainer resumed at the dead one's last checkpoint, its
    losses those of a replay here from that checkpoint over the same rows
    (``SPARK_LOSS_RTOL``), each incarnation's flash launches 8 x its
    steps, no epoch-0 trainer and no feed ring left; seconds from the
    kill to ``cluster/recover_done`` and to the first resumed step,
    steps lost, the saves' ms;
35. ``spark_elastic``: two trainers on this card (gloo, ``cuda:0``, no
    GPU claim) at full width through ``elastic_data=2`` (global batch
    8 x 2048), on a two-executor engine built with no respawn budget;
    ``feed.put:kill@7`` on executor 1 and ``run(restarts=1,
    min_executors=1)`` shrink the cluster to ``{"worker": [0]}``: epoch
    0 at world 2 with accum 1, epoch 1 at world 1 with accum 2, every
    partition in the ledger once, the first resumed step's loss that of
    an accum-2 replay here from the restored checkpoint, flash launches
    8 x the microbatches; each incarnation's step ms and the restore ms;
35a. ``elastic_exact``: float32 at full width, 2 layers, batch 2, here
    at world 1: the layout's accum-2 gradient equals the flat one leaf
    by leaf (1e-5 of each leaf's largest value);
36. ``obs``: the main path (phase 6's transformer, 70 partitions of one
    step) with the observability plane on (``TFOS_OBS_PORT=0``,
    ``TFOS_TELEMETRY_DIR``, ``TFOS_HEALTH_GRADNORM=1``): while it trains,
    ``tfos_train_steps_total`` rises between two ``/metrics`` scrapes
    beside the step histogram, ``/statusz`` names the worker, ``/healthz``
    is ok, ``POST /profilez`` (2 s) acks a ``torch.profiler`` capture
    that holds the flash forward and backward kernels (``obs capture``
    line: the device's idle share over the capture, the busy union of
    kernel and copy intervals) and ``POST /flightz`` a flight dump; after
    ``shutdown()`` the run directory holds the driver's, the executor's
    and the trainer's spools, ``tfos-postmortem-torch`` and the JAX
    package's ``scripts/trace_merge.py`` (stdlib only, run as a
    subprocess) read it, no ring is left, and each flash kernel launched
    8 times a step; 36b ``obs_halt``: a NaN planned on the 4th step's
    loss under ``TFOS_HEALTH_ACTION=halt`` halts the trainer, whose chief
    checkpointed every step: the latest checkpoint is step 3's and
    finite, the shutdown raises nothing and leaves no trainer or ring;
    36c ``obs cost``: the median step with the plane on beside phase 6's
    with every gate off;
37. ``engine_outside_kill``: on the host, executor 1 of a fresh
    two-executor engine SIGKILLed from outside while idle heals: a
    spread job runs on its respawn and a shared-queue job of four tasks
    finishes within 60 s (``heal_s``).
38. the data service, ``cluster.train(data.Pipeline)``:
    ``service_static`` (38a): ResNet-50 fed phase 14's shards through
    ``data.from_tfrecords(...).map(decode_block)`` with
    ``data_dispatch="static"`` and two data workers on a two-executor
    engine (the serving worker on executor 1): losses equal phase 10's
    (``SPARK_LOSS_RTOL``), the unit once in the ledger, no trainer or
    ring left, no executor holding a CUDA context, images/s and stall
    beside ``spark_tfrecord_resnet``'s; ``service_dynamic`` (38b): the
    default dynamic dispatch with one-batch splits under the plane's
    gates: every split id once in ``split_feed`` and in the trainer's
    feed, the batch digests the shards', each worker's
    ``tfos_data_splits_claimed_total``, and ``/statusz``'s ``actors``
    and ``data`` read once mid-run; ``service_kill`` (38c): two-batch
    splits, the serving worker SIGKILLed mid-split
    (``data.split_serve:kill@4``, its first incarnation): the job
    completes, the provider requeued >= 1 split, the trainer dropped
    the re-served prefix, the digests cover the shards once;
    ``service_transformer`` (38d): the full-width transformer fed phase
    6's records through ``data.from_arrays`` (static): losses equal
    ``spark_train``'s, 8 launches of each flash kernel a step.  38d runs
    on a thread beside 38a (``service measured_beside``), so their times
    are taken beside each other; 38b and 38c run after them.
39. streaming feeds: ``stream_transformer`` (39a): phase 6's
    transformer fed through ``TFCluster.train_stream`` on phase 6's
    engine, 8 micro-batches of phase 6's 8 records, the chief
    checkpointing every 4 steps: the first 5 losses equal
    ``spark_train``'s exactly, 8 launches of each flash kernel a step, no
    ring left, no CUDA context in the feeding executor; step ms, tokens/s
    and the stall beside ``spark_train``'s; ``eval_sidecar``: a
    ``workloads.EvalSidecar`` in an ``ActorSystem`` on a one-executor
    engine of its own watches the checkpoints (the stream waits at each
    one until it was evaluated): steps 4, 8 and 12 evaluated once each,
    the held-out loss (8 x 2048, bf16, the flash forward 8 times in the
    sidecar's executor) within ``SPARK_LOSS_RTOL`` of the driver's from
    the same checkpoint; ``stream_stop`` (39b): a fresh cluster whose
    stream is STOPped by ``examples/stop_streaming.py`` in a subprocess
    after the 4th micro-batch: ``train_stream`` returns within one
    micro-batch (the seconds from the STOP), ``shutdown()`` raises
    nothing, the trainer took fewer than 12 steps, its losses
    ``spark_train``'s;
40. ``sweep``: ``workloads.successive_halving`` over 4 SGD learning rates
    (budget 1, eta 2) with 2 ``TrialActor``s on a two-executor engine,
    each trial MNIST on the card for 10 x budget steps from seeded params
    and records (score: minus the last loss): the rungs and the best
    config equal those of the same trials run here in the same order,
    each score within 1e-5; it runs on a thread beside phases 36b and
    37 (36b gates on correctness alone);
41. ``serve_elastic``: ``Server(elastic=True, num_replicas=3,
    logical_replicas=6)`` over a float32 export and ``ckpt_dir`` of the
    full-width transformer (seed 2) on an engine of its own: 12 greedy
    sessions (40-1100-token prompts, 16 tokens) in flight, the params
    files deleted, a replica SIGKILLed while it streams; the generation
    bumps and the survivors cover 3+3 slots; the pool is degraded and
    sessions past its shrunk admission are shed with Retry-After; every
    session gives ``greedy_decode_reference``'s tokens; the respawn sends
    ``hello``, adopts the mirror (``stats()["elastic"]["boot"]``
    ``"adopted"``: a cold boot would find no params) and the pool
    re-grows to 2+2+2; 4 more sessions (one on the adopted replica)
    equal the reference; ``drain`` lets a replica finish its in-flight
    sessions and refuses the last; the resize ms, kill to resize and to
    re-grown, the mirror's bytes and seconds, the adoption's seconds,
    each replica's peak memory and ``torch.cuda.mem_get_info``;
42. ``serve_fabric``: ``Server(fabric=True, fabric_hosts=2,
    replicas_per_host=1, autoscale=...)`` over the same transformer on
    an engine of its own: 8 sessions with distinct route ids equal the
    reference ("miss"); each one's second turn (its prompt and answer,
    the same route id) is a "hit" on the same (host, worker) and maps
    its prefix from that worker's trie; bursts of 16 sessions until the
    ``ServeAutoscaler`` grows a host to 2 workers (the directive acked,
    the worker map grown), whose new worker prefills with the flash
    forward; ``/statusz`` has a pods row a host; a host SIGKILLed with 8
    sessions in flight (each the reference's tokens), its respawn booted
    at a newer checkpoint and steered back to the pinned version; the
    affinity hit rate, kill to failover, the scale-up's seconds, the
    launches a host;
43. ``serve_deploy``: a 3-replica bf16 decode pool with a ``ckpt_dir`` on
    an engine of its own, an ``ActorSystem`` on a second engine with an
    ``EvalSidecar`` (``deploy_eval``: the held-out 8 x 2048 loss on the
    card, the flash forward 8 times) and a ``PromotionController``, and
    a ``DeployLoop(pct=50, canary_count=1, burn_secs=4, min_samples=3)``
    under 4 threads of sessions: step 1 (phase 6's init) blessed and
    bootstrap-pinned, step 2 (10 Adam steps on the held-out batch)
    canaried and promoted, step 3 (step 2's embedding x 1000) canaried and
    rolled back for an eval regression with a ``deploy/rollback`` flight
    dump and a tombstone, step 4 (a NaN weight) tombstoned at the gate;
    the watermark ends at 2 on every replica, no session dropped,
    versions 1-3 each served, every eval loss within ``SPARK_LOSS_RTOL``
    of the driver's on the same checkpoint, a ``/statusz`` deploy row;
    canary to verdict seconds, each arm's p95, the eval ms;
44. ``serve_graphs``: the decode engine's CUDA graph per bucket
    (``utils/cuda_graphs.py``) at full width, after phase 31: for bf16
    (seed 0) and float32 (seed 1) an engine stepping in graphs and one
    with ``jit=False`` on the same params, one after the other, each
    through phase 8's 16 sessions (32 tokens; the captures), the same
    shapes with fresh tokens (timed), again under ``torch.profiler``
    (the device's idle share), in float32 phase 9's three prompts, and a
    third burst whose second wave of 8 follows a ``set_params`` to seed
    2's params; every burst is submitted under the engine's queue lock,
    so both engines admit the same groups.  Graphed tokens equal eager
    ones session by session in every burst, float32's equal
    ``greedy_decode_reference``, the reload refills the graphs (none
    dropped), the graphed engine steps no signature eagerly and its
    flash launches (replays counted, captures not) cover every plain
    prefill's layers; the speculative engine of phase 30 (narrow draft)
    graphed and eager gives equal tokens and accept counts.  Printed per
    engine: tokens/s, TTFT and gap p50/p99 per burst, graphs, capture
    ms, memory after the captures, the idle share.
45. ``pythia``: Pythia-2.8B's widths (head_dim 80, 4 of its 32 layers,
    ``PYTHIA``): (a) bf16 batch 2 x 2048 SPARK-fed through
    ``cluster.run`` of ``transformer_spark.main_fun`` for 4 Adam steps on
    phase 6's engine, the chief exporting the f32 params to a temp dir
    (free space checked first; deleted at the end): every loss finite,
    the flash kernels launched once a layer a step, every partition fed,
    no trainer alive after; (b) the export served by a one-replica
    ``Server`` in that executor (graphs on, paged KV, prefix sharing) to
    4 sessions of 64-1,500 tokens, then 4 fresh ones of the same
    lengths: every token
    in range, the replica's prefills through the flash forward, no
    signature served eagerly; (c) in this process, on the same params
    and batch, ``attn_impl="flash"`` against ``"reference"`` in bf16 and
    float16: the step-0 loss to one rounding step, the gradients and a
    prefill's last-position logits no further apart than a dithered
    reference's (``_Dithered``); the trainer's first loss (c)'s.  Step
    ms, tokens/s, MFU, peak memory, export seconds and bytes, boot and
    load, TTFT and gaps.
46. ``heads512``: the main transformer (``FULL``) at 2 heads of 512
    (``HEADS512``), the flash kernels' chunked variants: phase 45's
    (a)-(c) on the same helpers (``phase_width``) with the main path's
    batch 8 x 2048, on the pipeline's fit engine (its executor has
    never touched CUDA: only forked trainers did): 8 launches of each
    flash kernel a step, the export served to phase 45's 4 sessions,
    flash against the reference in bf16 and float16.

Every serving phase (8, 9, 18-22, 30-31, 41-43) runs its engines and
predicts at the default ``jit=None``, so in CUDA graphs: each gates that
every engine (replica, host, worker) stepped no signature eagerly and
holds at least one graph once it prefilled, and 22 that each replica
captured one graph a bucket (one ``compiles`` entry each).  The launch
counts count what ran on the device: a graph's replay adds the launches
its capture recorded, and the capture none.

Any failure raises, so the exit code is non-zero and the last line is
not printed.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
the line before it names the card, the one before that lists the
kernels' results, with their launches on the path each is on (the flash
kernels: in-process training, and ``launches_spark_train`` in the
SPARK-fed trainer; RMSNorm: one call of ``fused_rmsnorm``; and 0 on
the paths that reach no kernel: ``launches_resnet``, phase 10 in this
process, ``launches_tfrecord``, phase 15 in this process,
``launches_spark_tfrecord``, phase 16's trainer, and
``launches_tf_mode``, phase 17's executor, each counted in that run
alone, and ``launches_jpeg``, phase 16c's two trainers and phase 16e's
steps summed), ``launches_serve``, phase 18's replicas summed (the flash
forward > 0, the other three 0), ``launches_pipeline``, phases
23-26's trainers and predicting executors summed (all 0),
``launches_segmentation``, phases 27-29 summed (all 0),
``launches_spec``, phase 30's three runs summed (the flash forward > 0),
``launches_graphs``, phase 44's engines summed (the flash forward > 0,
the other three 0),
``launches_parallel``, phase 32's sharded step (the three flash
kernels > 0), ``launches_recover`` and ``launches_elastic``, phases
34 and 35's trainer incarnations summed (the three flash kernels > 0,
RMSNorm 0), ``launches_obs``, phase 36a's trainer (8 a step of
each flash kernel, RMSNorm 0), and ``launches_service``, phases
38a-38d's trainers summed (38d's flash kernels, RMSNorm 0),
``launches_stream``, phase 39's two streaming trainers summed (the three
flash kernels, RMSNorm 0), ``launches_eval``, the eval sidecar's
evaluations summed (the flash forward only), and
``launches_serve_elastic``, ``launches_fabric`` and
``launches_deploy``, phases 41-43's replicas (42's hosts; 43's
evaluations too) summed (the flash forward only).  A ``phase_seconds`` line
before the kernels line gives each phase's seconds.  Imports only torch,
numpy and the port; phase 36a runs the JAX package's stdlib-only
``scripts/trace_merge.py`` in a subprocess.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import concurrent.futures
import ctypes
import dataclasses
import gc
import glob
import io
import functools
import itertools
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch

from tensorflowonspark_tpu_torch import cluster as TFCluster
from tensorflowonspark_tpu_torch import (
    dfutil,
    elastic,
    inference,
    infeed,
    node,
    ops,
    parallel,
    parallel_run,
    pipeline,
    recordio,
    serving,
)
from tensorflowonspark_tpu_torch.engine import LocalEngine
from tensorflowonspark_tpu_torch.examples import (
    imagenet_data_setup,
    imagenet_records,
    mnist_data_setup,
    mnist_eval,
    mnist_inference,
    mnist_pipeline,
    mnist_spark,
    mnist_tf_ds,
    resnet_imagenet_spark,
    segmentation_spark,
    transformer_spark,
)
from tensorflowonspark_tpu_torch.examples import (
    segmentation as segmentation_example,
)
from tensorflowonspark_tpu_torch.models import (
    layers,
    mnist,
    resnet,
    segmentation,
)
from tensorflowonspark_tpu_torch.models import transformer as T
from tensorflowonspark_tpu_torch.ops import (
    _build,
    attention,
    fused_rmsnorm,
    norm,
)
from tensorflowonspark_tpu_torch.recordio import _build as native_build
from tensorflowonspark_tpu_torch.recordio import fs as rfs
from tensorflowonspark_tpu_torch.recordio import jpeg, marshal, shm
from tensorflowonspark_tpu_torch.utils import checkpoint as ckpt
from tensorflowonspark_tpu_torch.utils import (
    faults,
    metrics,
    profiler,
    telemetry,
)
from tensorflowonspark_tpu_torch.utils import train as train_utils
from tensorflowonspark_tpu_torch.serving import run_open_loop, serve_http
from tensorflowonspark_tpu_torch.serving.decode import (
    DecodeEngine,
    DecodeSpec,
)

# H100 SXM data-sheet peaks (dense), at the full 700 W power limit
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float16: 989e12,
              torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# bench.py's on-chip transformer: the only full-width config the repo runs
FULL = dict(vocab_size=16384, dim=1024, n_layers=8, n_heads=8, max_seq=2048)

# (B, S, H, D, causal, dtype, out atol); the first is the main path's full
# prompt bucket, the one the kernels line reports; the second holds the
# kernels at that shape in float32, where the tolerance is absolute
FLASH_CASES = [
    (8, 2048, 8, 128, True, torch.bfloat16, 2e-5),
    (8, 2048, 8, 128, True, torch.float32, 2e-5),
    (2, 96, 8, 128, False, torch.float32, 2e-5),   # tail masking
    (1, 1, 8, 128, True, torch.bfloat16, 2e-5),    # a one-token prompt
    (3, 300, 4, 64, True, torch.float32, 2e-5),    # head_dim 64
    # the bf16 twins of the tail cases, which reach the tensor-core
    # backward kernels, and a ragged causal sequence at full width
    (2, 96, 8, 128, False, torch.bfloat16, 2e-5),
    (3, 300, 4, 64, True, torch.bfloat16, 2e-5),
    (1, 1000, 8, 128, True, torch.bfloat16, 2e-5),
    # Pythia-2.8B's training shape (head_dim 80) and Gemma-2B's attention
    # widths (head_dim 256: the forward's tile in two 128-column CTAs,
    # the backward's in four of 64), in each dtype
    (2, 2048, 32, 80, True, torch.bfloat16, 2e-5),
    (2, 2048, 32, 80, True, torch.float32, 2e-5),
    (2, 2048, 32, 80, True, torch.float16, 2e-5),
    (1, 2048, 8, 256, True, torch.bfloat16, 2e-5),
    (1, 2048, 8, 256, True, torch.float32, 2e-5),
    (1, 2048, 8, 256, True, torch.float16, 2e-5),
    # tails at head_dims 96 and 32, and the padded path: 72 runs the
    # head_dim-80 kernels, 200 the 256 ones, on zero-padded inputs
    (2, 300, 4, 96, True, torch.float16, 2e-5),
    (3, 257, 4, 32, True, torch.bfloat16, 2e-5),
    (2, 128, 4, 72, True, torch.bfloat16, 2e-5),
    (2, 128, 4, 200, False, torch.float16, 2e-5),
    # the chunked kernels (head_dim above 256): phase 46's attention, the
    # main transformer at 2 heads of 512, in each dtype; a tail and the
    # pad to the chunk (320 runs as 384); "any D" (1024)
    (8, 2048, 2, 512, True, torch.bfloat16, 2e-5),
    (8, 2048, 2, 512, True, torch.float32, 2e-5),
    (8, 2048, 2, 512, True, torch.float16, 2e-5),
    (2, 300, 4, 320, False, torch.float16, 2e-5),
    (2, 256, 2, 1024, True, torch.bfloat16, 2e-5),
    # B*H = 65,600 (many short prompts in one batch): past the 65,535 a
    # grid's y may hold, on x in every launcher
    (16400, 16, 4, 64, False, torch.float32, 2e-5),
    (16400, 16, 4, 64, False, torch.bfloat16, 2e-5),
]
LSE_TOL = 1e-4
# Every kernel and its plain version compute in float32 from the same
# inputs and round each output once to the input dtype, so they differ by
# float32 summation order (~1e-6 of the terms) and, in bf16, by at most
# one rounding step of each element.  The check is per element,
# |got - ref| <= rtol*|ref| + atol:
# - bf16: rtol = 2^-7, one bf16 ulp of the element (bf16 keeps 8
#   significant bits, so an ulp is 2^-8..2^-7 of the value);
# - atol: the float32 tolerance of the same output, which covers the
#   summation-order noise and values that cancel to ~0 (the dq of a
#   one-token sequence, ds = p * (g.v - g.out) with out = v).
# - f16: rtol = 2^-10, one fp16 ulp of the element (11 significant bits:
#   an ulp is 2^-11..2^-10 of the value), with the same atol, which also
#   covers fp16's subnormal outputs (spacing 2^-24);
# Gradients: float32 at 2e-4 absolute, tests/test_ops.py's gradient
# tolerance.  Typical gradient elements are ~0.03 at the main shape
# (randn inputs, softmax scale 1/sqrt(D)), so a row whose gradient is lost
# or mis-scaled fails.
BF16_RTOL = 2.0 ** -7
F16_RTOL = 2.0 ** -10
BWD_F32_TOL = 2e-4
# ~1.1 ms at the H100's 1.755 GHz boost clock: longer than the host takes to
# enqueue any one timed call (time_ms)
SPIN_CYCLES = 2_000_000

TRAIN_BATCH, TRAIN_STEPS = 8, 5  # bench.py:920's batch; five Adam steps

# (shape, dtype, element offset of x in its buffer); the first is the
# transformer's activation, [8*2048, 1024], the one the kernels line
# reports.  Tails: dim 100 (bf16) and 97 (f32) are no multiple of a
# 16-byte vector, 900 / 903 / 7 rows no multiple of a CTA's 8; the f16
# input starts one element past a 16-byte boundary.  The main shapes take
# the kernel's registers path, the tails its two-pass scalar path.
RMS_CASES = [
    ((8, 2048, 1024), torch.bfloat16, 0),
    ((8, 2048, 1024), torch.float32, 0),
    ((3, 300, 100), torch.bfloat16, 0),
    ((3, 301, 97), torch.float32, 0),
    ((7, 64), torch.float16, 1),
]
# Kernel and plain version compute in float32 from the same inputs and
# round once: per element, one ulp of the output type (2^-7 of |ref| in
# bf16, 2^-10 in f16) plus 1e-5, or 1e-5 + 1e-5*|ref| in float32 (rsqrt
# and summation order).
RMS_RTOL = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10,
            torch.float32: 1e-5}
RMS_ATOL = 1e-5
# the SPARK-fed losses against the in-process ones: the same kernels on
# the same batches, but bf16 embedding gradients are summed with atomics
# in no fixed order
SPARK_LOSS_RTOL = 1e-3

# ResNet-50 at the JAX package's north-star shape: 1000 classes, 224x224x3
# uint8 images, batch 256, SGD(0.1, momentum 0.9)
# (examples/resnet/resnet_imagenet_spark.py's defaults, bench.py's on-chip
# shape and optimizer); bf16 compute, f32 masters and BN statistics
RESNET = dict(depth=50, num_classes=1000, image=224, batch=256, lr=0.1)
RESNET_WARMUP, RESNET_STEPS = 2, 6   # in process: untimed, then timed
SPARK_RESNET_STEPS = 6               # SPARK-fed: the first six of those
# bn_fused=False computes the same forward op for op, so the first step's
# loss agrees but for cuDNN's own run-to-run order
RESNET_FUSED_RTOL = 1e-5
# stem_s2d against the 7x7 stem, max |difference| over max |logit|.  The
# two stems sum the same products in another order; in bf16 each conv
# output is then one rounding apart in some elements, and that spreads
# through 53 layers, each renormalised by BN: 2e-2 of the largest logit
# (2.8e-3 on the H100; a wrong fold of the kernel or the input moves
# logits by O(1) of it).  float32: 1e-4.
RESNET_S2D_BF16_RTOL = 2e-2
RESNET_S2D_F32_RTOL = 1e-4
# one float32 step on the card against the CPU: max |difference| over each
# tensor's largest value
RESNET_EXACT = dict(batch=4, image=64)
RESNET_EXACT_RTOL = 1e-3
# the SPARK-fed TFRecord phase ships read units, not images: every task
# the engine pickles stays under this
TFRECORD_TASK_MAX_BYTES = 64 << 10
# the JPEG phases (16a-16c): JPEG_SHARDS shards of RESNET["batch"]
# records (one SPARK-fed step a shard), JPEGs at PIL's quality 90 in
# ImageNet's common sizes (h, w): landscape and portrait 500x375, a
# 1024x768 one (libjpeg decodes it at 1/2 for 224) and a 224x224 one,
# a quarter each; JPEG_DISTINCT seeded images a size, each shard a seeded
# permutation of them with its own labels.  The PIL path is timed on one
# shard (it decodes ~10x slower)
JPEG_SIZES = ((375, 500), (500, 375), (768, 1024), (224, 224))
JPEG_DISTINCT = 16
JPEG_SHARDS = 2   # two SPARK-fed steps (phases 10 and 16 run six)
JPEG_QUALITY = 90
# phase 16e: a save every `every` steps of phase 10's step on the card,
# `sync_saves` through save_checkpoint, then `async_saves` through an
# AsyncCheckpointer that keeps `keep` of them
ASYNC_CKPT = dict(every=2, sync_saves=1, async_saves=3, keep=2)
# phase 16f: mnist_spark's chief checkpoint after this many steps of 64
MNIST_CKPT_STEPS = 2
# InputMode.TENSORFLOW MNIST (mnist_tf_ds): the data setup's four shards
# of 2048 records, 10 steps of batch 64 (the example's default is 40),
# SGD(0.05, momentum 0.9), as the example's defaults; float32 with TF32 off and deterministic cuDNN on
# both sides, so the executor's steps repeat in this process to 1e-5
# relative (the same kernels on the same batches)
TF_MNIST = dict(num_examples=2048, partitions=4, batch_size=64, steps=10,
                lr=0.05)
TF_MNIST_RTOL = 1e-5
# online serving: the open loop offered to the bf16 pool (sessions of
# phase 8's mix, 32 tokens each, Poisson arrivals), the hot-reload poll
# and the slack a full-width reload gets past it, and the served MNIST
# logits' tolerance against the in-process predict (float32, TF32 off)
SERVE_OPEN_LOOP = dict(rate_rps=4.0, sessions=8)
SERVE_RELOAD_ENV = "TFOS_SERVE_RELOAD_SECS"
SERVE_RELOAD_SECS = "1"
SERVE_RELOAD_SLACK_S = 60.0
SERVE_PREDICT_RTOL = 1e-5
# the pipeline phases (MNIST at its full width): the fit's seeded records
# (batch 64, SGD(0.05, momentum 0.9), one epoch), the transform's 30,000
# rows at batch 1,024 in 8 partitions, inference()'s 4 partitions of
# 5,000 (id, image) rows, the roles run (mnist_eval's defaults, plus a
# ps node), and the predictions' tolerance against mnist.predict in this
# process (float32, TF32 off, of the largest logit)
PIPELINE = dict(fit_rows=2048, fit_partitions=4, batch_size=64, lr=0.05,
                rows=30000, partitions=8, transform_batch=1024,
                infer_partitions=4, infer_rows=5000)
ROLES = dict(num_examples=2048, batch_size=64, steps=10, ckpt_steps=5,
             lr=0.05, eval_timeout=300.0)
PIPELINE_RTOL = 1e-5
# the segmentation phases (BASELINE.json config 4, MobileNetV2-UNet): the
# JAX bench lane's shape (bench.py:1080-1095: width 1.0, 21 classes,
# batch 16 x 256x256x3, Adam(1e-3)), two untimed and ten timed steps in
# float32 and in bf16; the forward FLOPs an image at that shape, as the
# JAX package's counter gives them; the float32 card-vs-CPU step at
# 4 x 64x64 and its tolerances (loss relative; logits of the largest
# logit; each gradient and state leaf of the larger of its largest
# element and SEG_ZERO_SCALE of its tree's largest, since a training-mode
# BN downstream leaves some leaves ~0: their float32 values are rounding
# noise); the SPARK-fed run: the example's synthetic pets (3 classes) at
# 256x256, width 1.0, batch 16, six steps of one partition each, and its
# checkpoint's leaves against the in-process params, absolute: Adam turns
# the rounding noise of a ~0 gradient into an update of about lr a step
# whose sign the noise picks, so two runs may part by ~2 lr a step there
SEG = dict(image=256, num_classes=21, width=1.0, batch=16, lr=1e-3)
SEG_WARMUP, SEG_STEPS = 2, 10
SEG_FWD_FLOPS = 494_206_976
SEG_EXACT = dict(batch=4, image=64)
SEG_EXACT_RTOL = dict(loss=1e-4, logits=1e-4, grads=1e-3, state=1e-4)
SEG_ZERO_SCALE = 1e-3
SPARK_SEG = dict(image=256, width=1.0, batch=16, steps=6)
SEG_CKPT_ATOL = 3 * SEG["lr"] * SPARK_SEG["steps"]


def ptxas_report(log):
    """{kernel symbol: (registers, spill store bytes, spill load bytes)}
    from ``nvcc -Xptxas -v`` output."""
    report, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            report[fn] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            report[fn][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            report[fn][0] = int(m.group(1))
    return {k: tuple(v) for k, v in report.items()}


def sass_mma_counts(lib_path):
    """{kernel symbol: tensor-core MMA instructions (HMMA)} in the SASS of
    a built kernel library, read with the toolkit's ``cuobjdump``."""
    cuobjdump = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and "HMMA" in line:
            counts[fn] += 1
    return counts


# kernel source -> the flash kernels its libraries hold
TC_LIBS = {"flash_fwd": ("flash_fwd",), "flash_bwd": ("flash_dq", "flash_dkv")}
ATTR_KEYS = ("runtime_registers", "shared_bytes", "local_bytes",
             "ctas_per_sm")


def _lib_attrs(source, lib):
    """{kernel: registers, dynamic shared memory, local bytes and CTAs an
    SM} of one flash library, as the card's runtime reports them."""
    out = {}
    for i, name in enumerate(TC_LIBS[source]):
        vals = (ctypes.c_int * 4)()
        if source == "flash_fwd":
            fn = lib.tfos_flash_fwd_attrs
            fn.argtypes = [ctypes.POINTER(ctypes.c_int)]
            err = fn(vals)
        else:
            fn = lib.tfos_flash_bwd_attrs
            fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
            err = fn(i, vals)
        if err:
            raise RuntimeError(f"{name} attrs failed: "
                               f"{lib.tfos_cuda_error_string(err).decode()}")
        out[name] = dict(zip(ATTR_KEYS, vals))
    return out


def check_tc_build():
    """Every flash library, one a (head_dim, dtype): the bf16 and float16
    kernels issue tensor-core MMAs (``HMMA`` in the SASS) and, up to
    head_dim 128, spill nothing (``ptxas``, as this process built it,
    and the local bytes the card's runtime reports), the float32 ones
    issue none.  Prints a ``flash_fwd build`` and a ``flash_bwd build``
    line; returns {kernel: {dtype: {head_dim: {registers, spill bytes,
    hmma, runtime registers, shared bytes, local bytes, CTAs an SM}}}}."""
    out = {n: {} for names in TC_LIBS.values() for n in names}
    libs = [(src, d, code) for src in TC_LIBS
            for d in (*attention.HEAD_DIMS, _build.CHUNKED)
            for code in _build.FLASH_DTYPES]
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        mmas = list(pool.map(lambda x: sass_mma_counts(_build._lib_path(
            _build.variant(*x))), libs))
    for (src, d, code), counts in zip(libs, mmas):
        lib_name = _build.variant(src, d, code)
        regs = ptxas_report(_build.build_log.get(lib_name, ""))
        dtype = _build.FLASH_DTYPES[code]
        attrs = _lib_attrs(src, attention._typed(_build.load(lib_name), src))
        for name in TC_LIBS[src]:
            fn = next((f for f in counts if name in f), None)
            if fn is None:
                raise AssertionError(f"{name} not in {lib_name}: "
                                     f"{sorted(counts)}")
            n_mma = counts[fn]
            if ("_tc_kernel" in fn) != (code != 0) or (n_mma > 0) != (
                    code != 0):
                raise AssertionError(f"{lib_name} {fn}: {n_mma} HMMA "
                                     f"instructions")
            r, st, ld = regs.get(fn, (None, None, None))
            row = dict(registers=r, spill_bytes=(st or 0) + (ld or 0),
                       hmma=n_mma, **attrs[name])
            # the tensor-core kernels are gated up to head_dim 128, the
            # main paths' (Pythia's 80 among them), and in the chunked
            # libraries (key CHUNKED = 0, phase 46's); at 256 the dk/dv
            # kernel's 32-byte spill (ptxas holds every head_dim-256
            # backward at 254-255 registers however its loops are cut)
            # and the float32 FMA kernels' spills (the dq kernel's at 64
            # predates the gate) are reported in the build lines
            if code and d <= 128 and (row["spill_bytes"]
                                      or row["local_bytes"]):
                raise AssertionError(f"{lib_name} {fn} spills: {row}")
            key = "chunked" if d == _build.CHUNKED else str(d)
            out[name].setdefault(dtype, {})[key] = row
    print("flash_fwd build " + json.dumps(out["flash_fwd"]), flush=True)
    print("flash_bwd build " + json.dumps(
        {n: out[n] for n in TC_LIBS["flash_bwd"]}), flush=True)
    return out


def gpu_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=30, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps, queued=True):
    """Median CUDA-event time of ``fn`` over ``reps`` runs, after warm-up.
    ``queued``: each run waits on the card behind a device-side spin of
    ``SPIN_CYCLES``, so that the events time the device's work and not
    the host's enqueue of it (tens of microseconds of Python and ctypes a
    call, as long as the small kernels themselves); otherwise the events
    also span that enqueue."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def visible_pairs(sq, skv, causal):
    """(q, kv) pairs the causal or full mask leaves visible, per head."""
    if causal:
        return sum(min(i + 1, skv) for i in range(sq))
    return sq * skv


def peak_name(dtype):
    """The dense peak an MFU is taken against, named for its line."""
    return (f"{PEAK_FLOPS[dtype] / 1e12:g} TFLOP/s dense "
            f"{str(dtype).removeprefix('torch.')} (H100 SXM data sheet, "
            "700 W)")


def bound_ms(flops, nbytes, dtype):
    """Least time for the card: the larger of ``flops`` over the dense
    peak for the dtype and ``nbytes`` over the memory rate."""
    t_ops, t_bytes = flops / PEAK_FLOPS[dtype], nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def flash_bound_ms(b, sq, skv, h, d, causal, dtype):
    """Forward: 2 matmuls of 2*D flops per visible (q, kv) pair; q, k, v
    read once, out and lse written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    nbytes = esize * b * h * d * (2 * sq + 2 * skv) + 4 * b * h * sq
    return bound_ms(4.0 * b * h * d * visible_pairs(sq, skv, causal), nbytes,
                    dtype)


def flash_bwd_bound_ms(kernel, b, sq, skv, h, d, causal, dtype):
    """Backward kernels.  dq: s, dp and dq, 3 products of 2*D flops per
    visible pair; dk/dv: s, dp, dv and dk, 4 products; the pair as one
    backward ("pair"): s, dp, dq, dk and dv, 5 products.  Bytes: q, k,
    v, g, lse and delta read once, the kernel's gradients written once."""
    esize = torch.tensor([], dtype=dtype).element_size()
    products, n_out = {"flash_dq": (3, sq), "flash_dkv": (4, 2 * skv),
                       "pair": (5, sq + 2 * skv)}[kernel]
    flops = 2.0 * products * b * h * d * visible_pairs(sq, skv, causal)
    nbytes = (esize * b * h * d * (2 * sq + 2 * skv + n_out)
              + 8 * b * h * sq)
    return bound_ms(flops, nbytes, dtype)


def phase_flash(dev):
    """Kernel against the plain version; returns the main case's row."""
    gen = torch.Generator(device=dev).manual_seed(1234)
    rows = []
    for i, (b, s, h, d, causal, dtype, tol) in enumerate(FLASH_CASES):
        # q, k, v as strided views of a fused projection, as prefill has them
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        scale = 1.0 / d ** 0.5
        out, lse = attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)
        ref, ref_lse = attention.flash_attention_plain(q, k, v, causal=causal,
                                                       scale=scale)
        torch.cuda.synchronize()
        err, share = _close(out, ref, dtype, tol)
        lse_err = (lse - ref_lse).abs().max().item()
        if not (share <= 1.0 and lse_err <= LSE_TOL):
            raise AssertionError(
                f"flash_fwd disagrees with its plain version at "
                f"{(b, s, h, d, causal, dtype)}: out err {err} ({share:.3g} "
                f"of the per-element tolerance, atol {tol}), lse err "
                f"{lse_err} (tol {LSE_TOL})")
        # the main path's rows the longest (the others' rows for the clock)
        reps = (20 if i < 2 else 5) if s >= 1024 else 20
        def kernel():
            return attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)

        ms = time_ms(kernel, reps)
        # the host's enqueue beside the device time: the main path's rows
        ms_with_enqueue = (time_ms(kernel, reps, queued=False) if i < 2
                           else None)
        plain_ms = time_ms(lambda: attention.flash_attention_plain(
            q, k, v, causal=causal, scale=scale), reps)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        library_ms = time_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale), reps)
        bound, bound_by = flash_bound_ms(b, s, s, h, d, causal, dtype)
        row = dict(shape=[b, s, h, d],
                   kernel_head_dim=attention.kernel_head_dim(d),
                   causal=causal,
                   dtype=str(dtype).replace("torch.", ""), max_abs_err=err,
                   tol_share=share, lse_err=lse_err, ms=ms,
                   ms_with_enqueue=ms_with_enqueue, plain_ms=plain_ms,
                   bound_ms=bound,
                   bound_by=bound_by, library_ms=library_ms,
                   library_backend=sdpa_backend(qt, kt, vt, causal, scale))
        print("flash_fwd case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def sdpa_backend(q, k, v, causal, scale):
    """The backend ``scaled_dot_product_attention`` picks for these
    [B, H, S, D] inputs (its flash backend stops at head_dim 256), by
    the name of ``torch.nn.attention.SDPBackend``, from torch's own
    chooser ``torch._fused_sdp_choice``."""
    from torch.nn.attention import SDPBackend

    names = {int(b.value): n for n, b in SDPBackend.__members__.items()}
    choice = torch._fused_sdp_choice(q, k, v, None, 0.0, causal,
                                     scale=scale)
    return names.get(int(choice), f"code {int(choice)}")


def _close(got, ref, dtype, atol):
    """(max abs error, worst share of the per-element tolerance
    ``rtol*|ref| + atol``) of a kernel's output against its plain
    version; it passes where the share is at most 1."""
    rtol = {torch.bfloat16: BF16_RTOL, torch.float16: F16_RTOL}.get(dtype,
                                                                   0.0)
    ref = ref.float()
    diff = (got.float() - ref).abs()
    share = (diff / (rtol * ref.abs() + atol)).max().item()
    return diff.max().item(), share


def phase_flash_bwd(dev):
    """dq and dk/dv kernels against ``flash_backward_plain``; returns the
    main case's row."""
    gen = torch.Generator(device=dev).manual_seed(4321)
    rows = []
    for i, (b, s, h, d, causal, dtype, _) in enumerate(FLASH_CASES):
        qkv = torch.randn((b, s, 3, h, d), generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        g = torch.randn((b, s, h, d), generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        scale = 1.0 / d ** 0.5
        out, lse = attention._flash_forward(q, k, v, causal=causal,
                                            scale=scale)
        got = attention._flash_backward_cuda(q, k, v, out, lse, g,
                                             causal=causal, scale=scale)
        ref = attention.flash_backward_plain(q, k, v, out, lse, g,
                                             causal=causal, scale=scale)
        torch.cuda.synchronize()
        errs = {}
        for name, x, r in zip(("dq", "dk", "dv"), got, ref):
            err, share = _close(x, r, dtype, BWD_F32_TOL)
            if not (x.dtype == dtype and share <= 1.0):
                raise AssertionError(
                    f"flash backward {name} disagrees with the plain "
                    f"version at {(b, s, h, d, causal, dtype)}: err {err} "
                    f"({share:.3g} of the per-element tolerance), dtype "
                    f"{x.dtype}")
            errs[name] = (err, share)
        reps = (10 if i < 2 else 3) if s >= 1024 else 20
        # the kernels at the head_dim they run: a padded case's inputs as
        # padded_head_dim hands them over
        kd = attention.kernel_head_dim(d)
        pq, pk, pv, pout, pg = (torch.nn.functional.pad(x, (0, kd - d))
                                if kd > d else x for x in (q, k, v, out, g))
        gi, lse_i, delta = attention._bwd_inputs(pq, pk, pv, pout, lse, pg)
        dq, dk, dv = (torch.empty_like(x) for x in (pq, pk, pv))
        common = dict(causal=causal, scale=scale)
        dq_ms = time_ms(lambda: attention._launch_bwd(
            "flash_dq", pq, pk, pv, gi, lse_i, delta, dq, dq, **common),
            reps)
        dkv_ms = time_ms(lambda: attention._launch_bwd(
            "flash_dkv", pq, pk, pv, gi, lse_i, delta, dk, dv, **common),
            reps)
        plain_ms = time_ms(lambda: attention.flash_backward_plain(
            q, k, v, out, lse, g, **common), reps)
        qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_()
                      for x in (q, k, v))
        lib_out = torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal, scale=scale)
        gt = g.transpose(1, 2)
        library_ms = time_ms(lambda: torch.autograd.grad(
            lib_out, (qt, kt, vt), gt, retain_graph=True), reps)
        shape = (b, s, s, h, d, causal, dtype)
        dq_bound, dq_by = flash_bwd_bound_ms("flash_dq", *shape)
        dkv_bound, dkv_by = flash_bwd_bound_ms("flash_dkv", *shape)
        pair_bound, _ = flash_bwd_bound_ms("pair", *shape)
        row = dict(shape=[b, s, h, d], kernel_head_dim=kd, causal=causal,
                   dtype=str(dtype).replace("torch.", ""),
                   max_abs_err={n: e for n, (e, _) in errs.items()},
                   tol_share={n: t for n, (_, t) in errs.items()},
                   dq_ms=dq_ms, dkv_ms=dkv_ms, plain_ms=plain_ms,
                   dq_bound_ms=dq_bound, dq_bound_by=dq_by,
                   dkv_bound_ms=dkv_bound, dkv_bound_by=dkv_by,
                   pair_bound_ms=pair_bound, library_ms=library_ms,
                   library_backend=sdpa_backend(qt, kt, vt, causal, scale))
        print("flash_bwd case " + json.dumps(row), flush=True)
        rows.append(row)
        del qt, kt, vt, lib_out
    return rows[0]


def _rms_close(got, ref, dtype):
    """(max abs error, worst share of ``RMS_RTOL*|ref| + RMS_ATOL``)."""
    ref = ref.float()
    diff = (got.float() - ref).abs()
    share = (diff / (RMS_RTOL[dtype] * ref.abs() + RMS_ATOL)).max().item()
    return diff.max().item(), share


def phase_rmsnorm(dev):
    """The RMSNorm kernel against ``rmsnorm_reference``, forward and
    gradient through ``fused_rmsnorm``; the entry point's path is one
    forward and backward at the main shape.  Returns the main case's
    row."""
    gen = torch.Generator(device=dev).manual_seed(99)
    rows = []
    for shape, dtype, offset in RMS_CASES:
        n = int(np.prod(shape))
        buf = torch.randn(n + offset, generator=gen, device=dev,
                          dtype=torch.float32).to(dtype)
        x = buf[offset:].view(shape)
        dim = shape[-1]
        scale = (torch.randn(dim, generator=gen, device=dev) + 1.0)
        g = torch.randn(shape, generator=gen, device=dev,
                        dtype=torch.float32).to(dtype)
        norm.launches = 0  # the entry point's path: one call
        xk = x.detach().requires_grad_()
        sk = scale.detach().requires_grad_()
        y = fused_rmsnorm(xk, sk)
        gx, gs = torch.autograd.grad(y, (xk, sk), g)
        path_launches = norm.launches
        # the wrapper's choice: x as given, y freshly allocated (aligned)
        path = norm.kernel_path(dim, x.element_size(),
                                x.data_ptr() % 16 == 0)
        xr = x.detach().requires_grad_()
        sr = scale.detach().requires_grad_()
        yr = norm.rmsnorm_reference(xr, sr)
        rgx, rgs = torch.autograd.grad(yr, (xr, sr), g)
        torch.cuda.synchronize()
        err, share = _rms_close(y, yr, dtype)
        gerr = max(_rms_close(gx, rgx, dtype)[1],
                   _rms_close(gs, rgs, torch.float32)[1])
        if not (y.dtype == dtype and share <= 1.0 and gerr <= 1.0
                and path_launches == 1):
            raise AssertionError(
                f"rmsnorm kernel disagrees with its plain version at "
                f"{shape} {dtype} (offset {offset}): out err {err} "
                f"({share:.3g} of the per-element tolerance), grad share "
                f"{gerr:.3g}, {path_launches} launches for one call")
        reps = 50 if n >= 1 << 20 else 100
        with torch.no_grad():
            def kernel():
                return norm._rmsnorm_cuda(x, scale, 1e-6, 256)

            ms = time_ms(kernel, reps)
            ms_with_enqueue = time_ms(kernel, reps, queued=False)
            plain_ms = time_ms(lambda: norm.rmsnorm_reference(x, scale),
                               reps)
            s_lib = scale.to(dtype)
            library_ms = time_ms(lambda: torch.nn.functional.rms_norm(
                x, (dim,), s_lib, 1e-6), reps)
        esize = x.element_size()
        bound, bound_by = bound_ms(4.0 * n, 2 * esize * n + 4 * dim,
                                   torch.float32)
        row = dict(shape=list(shape), dtype=str(dtype).replace("torch.", ""),
                   offset=offset, path=path, max_abs_err=err,
                   tol_share=share,
                   grad_tol_share=gerr, launches=path_launches, ms=ms,
                   ms_with_enqueue=ms_with_enqueue, plain_ms=plain_ms,
                   bound_ms=bound, bound_by=bound_by,
                   library_ms=library_ms)
        print("rmsnorm case " + json.dumps(row), flush=True)
        rows.append(row)
    return rows[0]


def _param_leaves(params):
    return [params["embed"], params["ln_f"], params["head"],
            *params["layers"].values()]


def _counts():
    return dict(flash_fwd=attention.launches,
                flash_dq=attention.dq_launches,
                flash_dkv=attention.dkv_launches)


def _reset_counts():
    attention.launches = attention.dq_launches = attention.dkv_launches = 0


def _grad_norm(leaves):
    return torch.sqrt(sum(torch.sum(p.grad.float() ** 2)
                          for p in leaves)).item()


def phase_train(dev, gpu):
    """Full-width bf16 training through the kernels: the blockwise-CE
    check on the initial params, five Adam steps, then the remat checks
    and a profiled rerun; returns the five steps' launch counts and
    summary."""
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    leaves = _param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    # bench.py's transformer lane: one seeded batch, trained on each step
    tokens = np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq)).astype(np.int64)
    items = TRAIN_BATCH * cfg.max_seq
    tm = metrics.TrainMetrics(
        flops_per_item=metrics.transformer_flops_per_token(cfg, causal=True),
        device=dev)

    def step(toks, **kw):
        loss = T.loss_fn(params, toks, cfg, **kw)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        return loss

    toks = torch.from_numpy(tokens).to(dev)

    def check(name, **kw):
        """One forward and backward, no optimizer step: loss, gradient
        norm and launches."""
        _reset_counts()
        loss = step(toks, **kw).item()
        out = dict(loss=loss, grad_norm=_grad_norm(leaves),
                   launches=_counts())
        opt.zero_grad(set_to_none=True)
        checks[name] = out
        return out

    # blockwise against dense CE on the initial params.  The dense CE
    # rounds each logit to bf16 (unbiased, up to 2^-8 relative), the
    # blockwise one keeps them in f32; with a random head's logits those
    # roundings average out near 2e-6 of the loss over the batch's 16,376
    # positions, so 2e-5 holds while a wrong block, offset or mask moves
    # the loss by far more.  (After training on one batch the gold logits
    # grow, and so does their rounding.)
    checks = {}
    base0, blk = check("dense_init"), check(
        "blockwise_init", ce_impl="blockwise",
        ce_block=min(2048, cfg.vocab_size))
    if abs(blk["loss"] - base0["loss"]) > 2e-5 * abs(base0["loss"]):
        raise AssertionError(f"blockwise CE loss {blk['loss']} vs dense "
                             f"{base0['loss']} (rtol 2e-5)")

    torch.cuda.reset_peak_memory_stats(dev)
    losses, step_ms = [], []
    _reset_counts()
    norm.launches = 0
    feed = iter(infeed.prefetch_to_device(
        (tokens for _ in range(TRAIN_STEPS)), depth=2, placement=dev))
    while True:
        # the host's wait for the next staged batch: TrainMetrics'
        # infeed_stall_frac.  The first wait precedes its first timed step.
        t_wait = time.perf_counter()
        batch = next(feed, None)
        if batch is None:
            break
        if losses:
            tm.infeed_wait(time.perf_counter() - t_wait)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss = step(batch)
        opt.step()
        end.record()
        losses.append(loss.item())  # waits for the step
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        tm.step(items=items, loss=losses[-1])
    launches = _counts()
    if norm.launches:
        raise AssertionError(f"the transformer calls rmsnorm_reference; "
                             f"the RMSNorm kernel ran {norm.launches} times")
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    if len(losses) != TRAIN_STEPS or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"loss did not fall: {losses}")
    want = cfg.n_layers * TRAIN_STEPS
    if launches != dict(flash_fwd=want, flash_dq=want, flash_dkv=want):
        raise AssertionError(f"launches {launches}, want {want} of each "
                             f"({cfg.n_layers} layers x {TRAIN_STEPS} "
                             f"steps)")
    med = statistics.median(step_ms)
    peak = metrics.peak_flops(dev)
    summary = dict(
        batch=TRAIN_BATCH, seq=cfg.max_seq, steps=TRAIN_STEPS,
        losses=losses, step_ms=step_ms, step_ms_median=med,
        tokens_per_s=items / (med / 1e3),
        mfu_median_step=(items / (med / 1e3) * tm.flops_per_item / peak
                         if peak else None),
        train_metrics=tm.report(), launches=launches, peak_mem_gb=peak_gb,
        gpu=gpu)
    print("train " + json.dumps(summary), flush=True)

    # one further step on the trained params, with and without remat
    base = check("dense")
    for name, mode in (("remat", True), ("dots", "dots")):
        c = check(name, remat=mode)
        # the same kernels on the same inputs: the recompute repeats the
        # forward exactly, so the loss agrees to float32 rounding; the
        # gradient norm to 1e-2, since bf16 embedding gradients are summed
        # with atomics in no fixed order
        if abs(c["loss"] - base["loss"]) > 1e-6 * abs(base["loss"]) or \
                abs(c["grad_norm"] - base["grad_norm"]) > \
                1e-2 * base["grad_norm"]:
            raise AssertionError(f"{name}: {c} vs no remat {base}")
        if c["launches"] != dict(flash_fwd=2 * cfg.n_layers,
                                 flash_dq=cfg.n_layers,
                                 flash_dkv=cfg.n_layers):
            raise AssertionError(f"{name} launches {c['launches']}")
    print("train checks " + json.dumps(checks), flush=True)

    # two more steps under the profiler: device time by kernel group and
    # the idle share of their wall (the profiler's overhead lengthens it)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(toks)
            opt.step()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    print("train profile " + json.dumps(device_breakdown(prof, pwall)),
          flush=True)
    del params, leaves, opt, prof
    torch.cuda.empty_cache()
    return launches, summary


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _ring_bytes():
    """The feed ring's capacity, as the executors (which inherit this
    process's env) make it."""
    return int(os.environ.get("TFOS_SHM_FEED_BYTES", "") or
               node.SHM_FEED_BYTES)


def feed_summary(report, dispatch):
    """The SPARK-fed trainer's view of its feed (``DataFeed.stats``, the
    feeders' timings from the node's KV, the pinned copies), the
    driver's pickling of the feed job's tasks (``dispatch``, the
    engine's ``last_dispatch``), and the hand-off of each partition
    split into its parts: the engine's hop to the executor (its
    receipt: the wait since the previous task ended, and its
    unpickling), the feeder task's set-up (manager, ring) up to its
    first put, its encode and ring put, the trainer's pop (the call, and
    its copy and decode), the feeder's poll until it saw the ring empty,
    its ledger entry, the gap between one feeder task's end and the next
    one's start, the gap from the trainer's pop to the next partition's
    first put, and the copy into pinned memory a batch."""
    feed, feeders, pin = report["feed"], report["feeders"] or [], \
        report["pin"]
    feeders = sorted(feeders, key=lambda f: f["part"])
    # the trainer's pops in order: the first sum(chunks) carried data
    pops = feed["pops"]
    ends, n = [], 0
    for f in feeders:
        n += f["chunks"]
        ends.append(n - 1)
    pop_wall = [pops[i][0] if i < len(pops) else None for i in ends]
    split = []
    for i, f in enumerate(feeders):
        popped = ends[i] < len(pops)
        row = dict(part=f["part"], records=f["records"],
                   engine_hop_ms=f["recv_ms"] + f["loads_ms"],
                   engine_recv_ms=f["recv_ms"],
                   engine_loads_ms=f["loads_ms"],
                   setup_ms=1e3 * (f["first_put_wall"] - f["start_wall"]),
                   encode_ms=f["encode_ms"], put_ms=f["put_ms"],
                   marshal=f["marshal"],
                   lineage_ms=f.get("lineage_ms") or [],
                   pop_call_ms=pops[ends[i]][1] if popped else None,
                   pop_copy_ms=pops[ends[i]][2] if popped else None,
                   ledger_ms=1e3 * (f["done_wall"] - f["consumed_wall"]))
        if popped:
            row["poll_ms"] = 1e3 * (f["consumed_wall"] - pop_wall[i])
        if i + 1 < len(feeders):
            nxt = feeders[i + 1]
            row["between_tasks_ms"] = 1e3 * (nxt["start_wall"]
                                             - f["done_wall"])
            if popped:
                row["pop_to_next_put_ms"] = 1e3 * (nxt["first_put_wall"]
                                                   - pop_wall[i])
        split.append(row)

    def median(key):
        vals = [r[key] for r in split if r.get(key) is not None]
        return statistics.median(vals) if vals else None

    marshals = sorted({f["marshal"] for f in feeders if f["marshal"]})
    codecs = sorted({f["codec"] for f in feeders if f.get("codec")})
    return dict(
        feed_transport=feed["transport"], columnar=feed["columnar"],
        columnar_chunks=feed["columnar_chunks"],
        row_chunks=feed["row_chunks"],
        marshal="+".join(marshals) if marshals else None,
        marshal_native_built=marshal.native_available(),
        # the codec the executor's dfutil reader ran; None for records the
        # driver made
        codec="+".join(codecs) if codecs else None,
        ring_capacity_bytes=(_ring_bytes() if feed["transport"] == "shm"
                             else None),
        dev_shm_free_bytes=shm.shm_free_bytes(),
        driver_pickle_ms_per_task=1e3 * dispatch["pickle_s"]
        / dispatch["tasks"],
        task_mb=dispatch["bytes"] / dispatch["tasks"] / 1e6,
        task_max_bytes=dispatch["max_bytes"],
        pin_ms_per_batch=(1e3 * pin["s"] / pin["batches"]
                          if pin["batches"] else None),
        pin_mb_per_batch=(pin["bytes"] / pin["batches"] / 1e6
                          if pin["batches"] else None),
        handoff_median_ms={k: median(k) for k in (
            "engine_hop_ms", "engine_recv_ms", "engine_loads_ms",
            "setup_ms", "encode_ms", "put_ms",
            "pop_call_ms", "pop_copy_ms", "poll_ms", "ledger_ms",
            "between_tasks_ms", "pop_to_next_put_ms")},
        handoff=split)


def check_feed(line, fs, transport):
    """The SPARK-fed phase's feed must have taken ``transport`` with
    columnar chunks: no silent fall-back on the card."""
    if fs["feed_transport"] != transport or not fs["columnar"]:
        raise AssertionError(
            f"{line}: feed transport {fs['feed_transport']!r}, columnar "
            f"{fs['columnar']} ({fs['columnar_chunks']} columnar and "
            f"{fs['row_chunks']} row chunks); want {transport!r} and "
            "columnar")


def phase_spark_train(engine, gpu, train):
    """The main path: phase_train's five steps SPARK-fed through the
    port's cluster on ``engine``, a one-executor ``LocalEngine`` started
    with the script (its interpreter boots while the kernel phases run,
    so the boot time below is the cluster's).  The token records go
    through the node's shm ring as columnar chunks.  ``train`` is
    phase_train's summary, whose losses this run must give."""
    cfg = dict(FULL, dtype="bfloat16", attn_impl="flash")
    n_layers = FULL["n_layers"]
    tokens = np.random.default_rng(0).integers(
        0, FULL["vocab_size"], (TRAIN_BATCH, FULL["max_seq"]))
    # phase_train's batch as 8 records a step, 5 partitions of 8
    records = [tokens[i].astype(np.int32) for i in range(TRAIN_BATCH)] \
        * TRAIN_STEPS
    out_dir = tempfile.mkdtemp(prefix="tfos_spark_train_")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": cfg, "batch_size": TRAIN_BATCH, "seed": 0,
             "out_dir": out_dir},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        t_run = time.time() - t0
        c.train(engine.parallelize(records, TRAIN_STEPS), feed_timeout=600)
        dispatch = engine.last_dispatch
        fed = c.server.fed_partitions("input")
        c.shutdown()
        t_total = time.time() - t0
        with open(os.path.join(out_dir, "transformer-rank0.json")) as f:
            report = json.load(f)
        orphan = _alive(report["pid"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses, ref = report["losses"], train["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    med = statistics.median(report["step_ms"])
    items = TRAIN_BATCH * FULL["max_seq"]
    summary = dict(
        losses=losses, phase_train_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        step_ms=report["step_ms"], step_ms_median=med,
        step_wall_ms=report["step_wall_ms"],
        step_wall_ms_median=statistics.median(report["step_wall_ms"]),
        tokens_per_s=items / (med / 1e3),
        phase_train_step_ms_median=train["step_ms_median"],
        phase_train_tokens_per_s=train["tokens_per_s"],
        infeed_stall_frac=report["train_metrics"]["infeed_stall_frac"],
        phase_train_infeed_stall_frac=train["train_metrics"][
            "infeed_stall_frac"],
        feed_wait_s=report["feed_wait_s"],
        boot_s=report["first_step_wall"] - t0, cluster_run_s=t_run,
        main_start_s=report["main_start_wall"] - t0,
        joined_s=report["joined_wall"] - t0,
        model_ready_s=report["model_wall"] - t0,
        total_s=t_total, launches=report["launches"],
        records=report["records"], fed_partitions=fed,
        trainer_alive_after_shutdown=orphan, health=report["health"],
        cuda_visible_devices=report["cuda_visible_devices"],
        train_metrics=report["train_metrics"],
        peak_mem_gb=report["peak_mem_gb"],
        **feed_summary(report, dispatch), gpu=gpu)
    print("spark_train " + json.dumps(summary), flush=True)
    check_feed("spark_train", summary, "shm")
    if len(losses) != TRAIN_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"SPARK-fed losses {losses} vs in-process "
                             f"{ref} (rtol {SPARK_LOSS_RTOL})")
    want = n_layers * TRAIN_STEPS
    if report["launches"] != dict(flash_fwd=want, flash_dq=want,
                                  flash_dkv=want, rmsnorm=0):
        raise AssertionError(f"trainer launches {report['launches']}, want "
                             f"{want} of each flash kernel, no RMSNorm")
    if fed != list(range(TRAIN_STEPS)) or \
            report["records"] != TRAIN_BATCH * TRAIN_STEPS:
        raise AssertionError(f"fed partitions {fed}, records the trainer's "
                             f"DataFeed handed out {report['records']}")
    if orphan:
        raise AssertionError(f"trainer {report['pid']} alive after "
                             "shutdown")
    return report["launches"], summary


def phase_grad_exact(dev):
    """Float32 at full width, batch 2: loss and every gradient through the
    kernels against ``mha_reference`` attention under autograd."""
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    ref_cfg = T.Config(**FULL, dtype="float32", attn_impl="reference")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    leaves = _param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, cfg.max_seq))).to(dev)
    runs = {}
    for name, c in (("flash", cfg), ("reference", ref_cfg)):
        _reset_counts()
        loss = T.loss_fn(params, toks, c)
        grads = torch.autograd.grad(loss, leaves)
        runs[name] = (loss.item(), grads, _counts())
    loss, grads, launches = runs["flash"]
    ref_loss, ref_grads, ref_launches = runs["reference"]
    if launches != dict(flash_fwd=cfg.n_layers, flash_dq=cfg.n_layers,
                        flash_dkv=cfg.n_layers) or any(ref_launches.values()):
        raise AssertionError(f"launches: flash {launches}, reference "
                             f"{ref_launches}")
    # both runs are float32 end to end (no TF32) and differ only in the
    # order of the attention sums, ~1e-6 relative per layer; 1e-3 of each
    # tensor's largest gradient leaves room for 8 layers of that, while a
    # masking or indexing fault moves gradients by O(1) of their size
    names = ["embed", "ln_f", "head", *params["layers"]]
    worst = {}
    for name, gk, gr in zip(names, grads, ref_grads):
        scale = gr.abs().max().item()
        err = (gk - gr).abs().max().item()
        worst[name] = err / scale
        if not (torch.isfinite(gk).all() and err <= 1e-3 * scale):
            raise AssertionError(f"grad {name}: max err {err}, largest "
                                 f"reference gradient {scale}")
    if abs(loss - ref_loss) > 1e-5 * abs(ref_loss):
        raise AssertionError(f"loss {loss} vs reference {ref_loss}")
    print("exact float32 grads " + json.dumps(dict(
        loss=loss, ref_loss=ref_loss, rel_err_by_param=worst,
        launches=launches)), flush=True)
    del params, leaves, grads, ref_grads, runs
    torch.cuda.empty_cache()


def _graph_gate(what, dec):
    """A decode engine on the card stepped in CUDA graphs: no signature
    stepped eagerly, and at least one graph once it prefilled."""
    if dec["eager_signatures"] or (dec["prefills"] and dec["graphs"] < 1):
        raise AssertionError(f"{what}: {dec['graphs']} graphs, "
                             f"{dec['eager_signatures']} eager signatures")


def run_engine(params, spec, jobs, dev, timeout, jit=None):
    """Submit ``jobs`` = [(sid, prompt[, submit kwargs])] to a fresh
    engine on the card (``jit`` its graph rule: None steps in CUDA
    graphs, which :func:`_graph_gate` then requires) and wait for all;
    any error emission or init error raises.  Returns
    (done {sid: tokens}, streamed {sid: [(index, token)]}, first-token
    times {sid: s}, wall seconds, stats, engine)."""
    lock = threading.Lock()
    done, errors = {}, {}
    streamed = {job[0]: [] for job in jobs}
    first = {}
    t_submit = {}

    def emit(kind, sid, *rest):
        now = time.perf_counter()
        with lock:
            if kind == "token":
                streamed[sid].append(tuple(int(x) for x in rest))
                if rest[0] == 0:
                    first[sid] = now - t_submit[sid]
            elif kind == "done":
                done[sid] = [int(t) for t in rest[0]]
            else:
                errors[sid] = rest[0]

    eng = DecodeEngine(params, spec, emit, device=dev, jit=jit)
    eng.start(timeout=600)
    try:
        t0 = time.perf_counter()
        for sid, prompt, *kw in jobs:
            with lock:
                t_submit[sid] = time.perf_counter()
            eng.submit(sid, prompt, **(kw[0] if kw else {}))
        deadline = time.time() + timeout
        while time.time() < deadline:
            with lock:
                if errors or len(done) == len(jobs):
                    break
            time.sleep(0.005)
        wall = time.perf_counter() - t0
        stats = eng.stats()
    finally:
        eng.stop()
    if errors:
        raise AssertionError(f"engine emitted errors: {errors}")
    if len(done) != len(jobs):
        raise AssertionError(f"only {len(done)}/{len(jobs)} sessions done "
                             f"within {timeout}s")
    if jit is not False:
        _graph_gate("engine", stats)
    return done, streamed, first, wall, stats, eng


def _transformer_group(name):
    """Kernel group of a transformer step's device event."""
    low = name.lower()
    return ("flash_fwd" if "flash_fwd" in low else
            "flash_dq" if "flash_dq" in low else
            "flash_dkv" if "flash_dkv" in low else
            "memcpy" if "memcpy" in low else
            "matmul" if any(w in low for w in ("gemm", "nvjet", "cutlass",
                                               "cublas"))
            else "softmax" if "softmax" in low else
            "optimizer" if any(w in low for w in ("adam", "multi_tensor"))
            else "index/gather/scatter" if any(
                w in low for w in ("index", "gather", "scatter"))
            else "other")


def _union(spans):
    """The length of the union of ``(start, end)`` intervals."""
    busy, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy += t1 - t0
            end = t1
        elif t1 > end:
            busy += t1 - end
            end = t1
    return busy


def device_breakdown(prof, wall_s, classify=_transformer_group, top=8):
    """Device time of a profiled run: busy time (union of kernel and copy
    intervals), the idle share of ``wall_s``, and time by kernel group
    (``classify(kernel name) -> group``)."""
    spans, groups, names = [], collections.Counter(), collections.Counter()
    for e in prof.events():
        # device-side ranges of record_function annotations (such as
        # "Optimizer.step#Adam.step") span kernels counted on their own
        if e.device_type != torch.autograd.DeviceType.CUDA or \
                getattr(e, "is_user_annotation", False):
            continue
        t0, t1 = e.time_range.start, e.time_range.end
        spans.append((t0, t1))
        name = e.name
        groups[classify(name)] += (t1 - t0) / 1e3
        names[name[:90]] += (t1 - t0) / 1e3
    busy_ms = _union(spans) / 1e3
    return dict(wall_ms=1e3 * wall_s, device_busy_ms=busy_ms,
                idle_share=1.0 - busy_ms / (1e3 * wall_s),
                device_events=len(spans),
                groups_ms=dict(groups.most_common()),
                top_kernels_ms=names.most_common(top))


def serving_jobs(cfg, seed=0):
    """The 16 serving sessions ``[(sid, prompt)]``: 64-1536 tokens, 8 of
    them behind one 512-token system prompt."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, size=512).tolist()
    jobs = []
    for i in range(16):
        n = int(rng.integers(64, 1536 + 1))
        if i % 2 == 0:   # 8 sessions share a 512-token system prompt
            n = max(n, 512 + 16)
            prompt = system + rng.integers(1, cfg.vocab_size,
                                           size=n - 512).tolist()
        else:
            prompt = rng.integers(1, cfg.vocab_size, size=n).tolist()
        jobs.append((f"s{i:02d}", prompt))
    return jobs


def phase_serving(dev, gpu):
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    n_params = sum(p.numel() for p in params.values() if torch.is_tensor(p))
    n_params += sum(p.numel() for p in params["layers"].values())
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=32)
    jobs = serving_jobs(cfg)
    attention.launches = 0
    done, streamed, first, wall, stats, eng = run_engine(
        params, spec, jobs, dev, timeout=600)
    launches = attention.launches
    for sid, prompt in jobs:
        toks = done[sid]
        if [i for i, _ in streamed[sid]] != list(range(32)):
            raise AssertionError(f"{sid}: streamed indices "
                                 f"{[i for i, _ in streamed[sid]]}")
        if [t for _, t in streamed[sid]] != toks or not all(
                0 <= t < cfg.vocab_size for t in toks):
            raise AssertionError(f"{sid}: bad tokens {toks}")
    cache = eng._cache
    if stats["prefix_hits"] < 1:
        raise AssertionError(f"no prefix hit: {stats}")
    if cache.occupancy != 0 or cache.leaked_blocks() != []:
        raise AssertionError(f"cache not drained: occupancy "
                             f"{cache.occupancy}, leaked "
                             f"{cache.leaked_blocks()}")
    plain_prefills = stats["prefills"] - stats["extends"]
    if launches < cfg.n_layers * plain_prefills or launches == 0:
        raise AssertionError(f"flash kernel launched {launches} times for "
                             f"{plain_prefills} plain prefills x "
                             f"{cfg.n_layers} layers")
    ttft = sorted(first.values())
    summary = dict(
        params=n_params, sessions=len(jobs), tokens=32 * len(jobs),
        ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
        ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
        tokens_per_s=32 * len(jobs) / wall, wall_s=wall,
        prefills=stats["prefills"], extends=stats["extends"],
        prefix_hits=stats["prefix_hits"],
        prefix_tokens_saved=stats["prefix_tokens_saved"],
        iterations=stats["iterations"], flash_launches=launches,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, gpu=gpu)
    print("serving " + json.dumps(summary), flush=True)
    # the same traffic once more under the profiler: where the device time
    # goes and how much of the wall the device sits idle (the profiler's
    # own overhead lengthens this wall)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        _, _, _, pwall, _, _ = run_engine(params, spec, jobs, dev,
                                          timeout=600)
    print("serving profile " + json.dumps(device_breakdown(prof, pwall)),
          flush=True)
    del params, eng, cache
    torch.cuda.empty_cache()
    return launches


def phase_exact(dev):
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=16)
    rng = np.random.default_rng(1)
    jobs = [(f"x{n}", rng.integers(1, cfg.vocab_size, size=n).tolist())
            for n in (40, 300, 1100)]
    before = attention.launches
    done, _, _, _, _, _ = run_engine(params, spec, jobs, dev, timeout=600)
    if attention.launches == before:
        raise AssertionError("float32 engine run never launched the kernel")
    ref_attn = lambda q, k, v: attention.mha_reference(q, k, v, causal=True)
    for sid, prompt in jobs:
        ref = T.greedy_decode_reference(params, prompt, cfg, max_tokens=16,
                                        attn_fn=ref_attn)
        if done[sid] != ref:
            raise AssertionError(f"{sid}: engine {done[sid]} != "
                                 f"reference {ref}")
    print(f"exact float32: {len(jobs)} prompts x 16 greedy tokens equal the "
          "full-recompute reference", flush=True)


# -- ResNet-50 ----------------------------------------------------------------

def _resnet_batch():
    """The in-process phase's batch: ``RESNET["batch"]`` seeded uint8
    NHWC images and labels (numpy seed 0, as bench.py seeds its batch)."""
    rng = np.random.default_rng(0)
    b, side = RESNET["batch"], RESNET["image"]
    images = rng.integers(0, 256, (b, side, side, 3), dtype=np.uint8)
    labels = rng.integers(0, RESNET["num_classes"], b).astype(np.int64)
    return images, labels


def _resnet_net(dev, seed=0, bn_fused=True):
    params, state = resnet.init(
        torch.Generator(device=dev).manual_seed(seed), depth=RESNET["depth"],
        num_classes=RESNET["num_classes"], device=dev)
    leaves = [p.requires_grad_() for p in resnet.param_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=RESNET["lr"], momentum=0.9)
    step = resnet.make_train_step(opt, depth=RESNET["depth"],
                                  bn_fused=bn_fused)
    return params, state, step


def _rel_max(got, ref):
    """max |got - ref| over max |ref| (float64 on the host)."""
    got = got.detach().double().cpu()
    ref = ref.detach().double().cpu()
    return ((got - ref).abs().max() / ref.abs().max().clamp_min(1e-30)
            ).item()


def _resnet_group(name):
    """Kernel group of a ResNet step's device event."""
    low = name.lower()
    if "dgrad" in low:
        return "conv dgrad"
    if "wgrad" in low:
        return "conv wgrad"
    if "fprop" in low or "convolve" in low or "conv2d" in low:
        return "conv forward"
    if any(w in low for w in ("xmma", "cudnn", "cutlass", "implicit_gemm",
                              "nchwtonhwc", "nhwctonchw")):
        return "conv other (cuDNN)"
    if any(w in low for w in ("gemm", "nvjet", "cublas")):
        # cuDNN runs many 1x1 convolutions as plain GEMMs
        return "GEMM (1x1 convs, fc)"
    if "reduce" in low:
        return "BN statistics and reductions"
    if "max_pool" in low or "maxpool" in low:
        return "max pool"
    if any(w in low for w in ("multi_tensor", "sgd", "foreach")):
        return "optimizer"
    if "memcpy" in low or "memset" in low:
        return "memcpy/memset"
    if "copy" in low:
        return "copies (dtype casts, layouts)"
    if "elementwise" in low or "vectorized" in low:
        return "elementwise (BN apply, ReLU, adds, gates)"
    return "other"


def phase_resnet(dev, gpu):
    """ResNet-50 in process at the north-star shape (bf16 compute, f32
    masters and BN statistics, SGD(0.1, momentum 0.9)): one unfused-BN
    step for its loss and peak memory, then warm-up and timed fused
    steps on one seeded batch, the stem and state gates, and a profiled
    rerun.  Returns the summary (its ``losses`` are every step's)."""
    images_np, labels_np = _resnet_batch()
    images = torch.from_numpy(images_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    b = RESNET["batch"]
    flops_img = 3 * resnet.flops_per_image(RESNET["depth"], RESNET["image"])
    _reset_counts()
    norm.launches = 0

    # bn_fused=False: autograd over the same forward; the first step's
    # loss must equal the fused path's, which saves only x per BN
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    params, state, step = _resnet_net(dev, bn_fused=False)
    loss_unfused = step(params, state, images, labels)[0].item()
    peak_unfused = torch.cuda.max_memory_allocated(dev) / 1e9
    del params, state, step
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    params, state, step = _resnet_net(dev)
    losses, step_ms = [], []
    for _ in range(RESNET_WARMUP + RESNET_STEPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        loss, acc, state = step(params, state, images, labels)
        end.record()
        losses.append(loss.item())  # waits for the step
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
    peak_fused = torch.cuda.max_memory_allocated(dev) / 1e9
    timed = step_ms[RESNET_WARMUP:]
    med = statistics.median(timed)
    peak = metrics.peak_flops(dev)
    summary = dict(
        depth=RESNET["depth"], batch=b, image=RESNET["image"],
        dtype="bfloat16", warmup_steps=RESNET_WARMUP, losses=losses,
        step_ms=step_ms, step_ms_median=med, images_per_s=b / (med / 1e3),
        mfu_median_step=(b / (med / 1e3) * flops_img / peak
                         if peak else None),
        flops_per_image=flops_img, peak_mem_gb=peak_fused,
        peak_mem_gb_unfused_step=peak_unfused,
        first_loss_fused=losses[0], first_loss_unfused=loss_unfused,
        cudnn_benchmark=torch.backends.cudnn.benchmark,
        final_acc=float(acc), gpu=gpu)
    print("resnet " + json.dumps(summary), flush=True)
    if not all(np.isfinite(losses)):
        raise AssertionError(f"resnet losses {losses}")
    if abs(loss_unfused - losses[0]) > RESNET_FUSED_RTOL * abs(losses[0]):
        raise AssertionError(f"first-step loss: bn_fused=False "
                             f"{loss_unfused} vs fused {losses[0]} (rtol "
                             f"{RESNET_FUSED_RTOL})")
    for path, t in _leaf_items(state):
        init = 0.0 if path.endswith("mean") else 1.0
        if not (torch.isfinite(t).all() and (t != init).any()):
            raise AssertionError(f"BN running stat {path} not finite or "
                                 f"still at its initial {init}")

    # the space-to-depth stem against the 7x7/s2 SAME stem on the card,
    # on the trained params, training-mode BN over the batch
    checks = {}
    with torch.no_grad():
        for name, dtype, rtol in (("bfloat16", torch.bfloat16,
                                   RESNET_S2D_BF16_RTOL),
                                  ("float32", torch.float32,
                                   RESNET_S2D_F32_RTOL)):
            out = [resnet.apply(params, state, images, depth=RESNET["depth"],
                                compute_dtype=dtype, stem_s2d=s2d)[0]
                   for s2d in (True, False)]
            err = _rel_max(out[0], out[1])
            checks[f"s2d_vs_7x7_{name}"] = dict(rel_err=err, rtol=rtol)
            if not (torch.isfinite(out[0]).all() and err <= rtol):
                raise AssertionError(f"stem_s2d logits differ from the 7x7 "
                                     f"stem's in {name}: {err} (rtol "
                                     f"{rtol})")
    print("resnet checks " + json.dumps(checks), flush=True)

    # two more steps under the profiler: device time by kernel group and
    # the idle share of their wall (the profiler's overhead lengthens it)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(2):
            step(params, state, images, labels)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    print("resnet profile " + json.dumps(
        device_breakdown(prof, pwall, _resnet_group, top=25)), flush=True)
    launches = _counts()
    launches["rmsnorm"] = norm.launches
    if any(launches.values()):
        raise AssertionError(f"ResNet launched a transformer kernel: "
                             f"{launches}")
    summary["launches"] = launches
    del params, state, step, prof
    torch.cuda.empty_cache()
    return summary


class _PinnedBranches:
    """Records the branches that ``layers.relu`` (1 above 0, 1/2 at 0, 0
    below) and ``layers.max_pool`` (each window's argmax) take on one run,
    and makes a second run take the same ones, counting where its own
    would differ.  The card's convolutions and the CPU's sum in other
    orders, so a ReLU input or a pooling window within float32 rounding
    of a tie can branch differently, and one such element moves every
    gradient upstream of it by up to O(1) of a small layer's; pinned,
    both runs differentiate the same function."""

    def __init__(self):
        self.relu_masks, self.pool_idx = [], []
        self.replay = False
        self.relu_differ = self.pool_differ = 0

    def relu(self, x):
        own = (x > 0).to(x.dtype) + 0.5 * (x == 0).to(x.dtype)
        if not self.replay:
            self.relu_masks.append(own.cpu())
            return layers._max0(x)
        m = self.relu_masks.pop(0).to(x.device)
        self.relu_differ += int((own != m).sum())
        return x * m

    def max_pool(self, x, window, stride, padding):
        # ResNet's stem pool: SAME
        w, st = layers._pair(window), layers._pair(stride)
        xp, _ = layers._pad_same(x, w, st, value=float("-inf"))
        y, idx = torch.nn.functional.max_pool2d(xp, w, st,
                                                return_indices=True)
        if not self.replay:
            self.pool_idx.append(idx.cpu())
            return y
        pinned = self.pool_idx.pop(0).to(x.device)
        self.pool_differ += int((pinned != idx).sum())
        return xp.flatten(2).gather(2, pinned.flatten(2)).view_as(y)


def phase_resnet_exact(dev):
    """One float32 step of ResNet-50 (TF32 off) at a small batch and image
    on the card against the same step on the CPU through the same code
    (``bn_fused=False``, whose ReLUs all go through ``layers.relu``, the
    CPU run taking the card's ReLU and pooling branches: see
    ``_PinnedBranches``): the loss, every gradient and the new BN
    state."""
    side, b = RESNET_EXACT["image"], RESNET_EXACT["batch"]
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, (b, side, side, 3),
                                           dtype=np.uint8))
    labels = torch.from_numpy(rng.integers(0, RESNET["num_classes"], b))
    params_cpu, state_cpu = resnet.init(
        torch.Generator().manual_seed(3), depth=RESNET["depth"],
        num_classes=RESNET["num_classes"], device="cpu")
    runs = {}
    pins = _PinnedBranches()
    real = layers.relu, layers.max_pool
    layers.relu, layers.max_pool = pins.relu, pins.max_pool
    try:
        for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            pins.replay = name == "cpu"
            runs[name] = _resnet_exact_run(params_cpu, state_cpu, images,
                                           labels, d)
    finally:
        layers.relu, layers.max_pool = real
    if pins.relu_masks or pins.pool_idx:
        raise AssertionError("the CPU run took another path than the "
                             "card's")
    (loss, grads, new_state), (rloss, rgrads, rstate) = runs["cuda"], \
        runs["cpu"]
    worst, worst_names = {}, {}
    for what, got, ref in (("grads", grads, rgrads),
                           ("state", new_state, rstate)):
        errs = sorted(((_rel_max(a, b), path) for (path, a), (_, b) in zip(
            _leaf_items(got), _leaf_items(ref))), reverse=True)
        worst[what] = errs[0][0]
        worst_names[what] = errs[:3]
    worst["loss"] = _rel_max(loss, rloss)
    print("resnet exact " + json.dumps(dict(
        batch=b, image=side, loss=loss.item(), cpu_loss=rloss.item(),
        rel_err=worst, worst_tensors=worst_names, rtol=RESNET_EXACT_RTOL,
        cpu_relu_branches_pinned=pins.relu_differ,
        cpu_pool_branches_pinned=pins.pool_differ)), flush=True)
    if not all(v <= RESNET_EXACT_RTOL for v in worst.values()):
        raise AssertionError(f"float32 ResNet step on the card vs the CPU: "
                             f"{worst} (rtol {RESNET_EXACT_RTOL})")


def _resnet_exact_run(params_cpu, state_cpu, images, labels, d):
    """(loss, grads, new state) of one float32 ResNet-50 step on ``d``,
    unfused BN."""
    # on the card through the JAX-layout round trip, which lays the conv
    # kernels out channels-last there
    params, state = resnet.params_from_jax(
        *resnet.params_to_jax(params_cpu, state_cpu), device=d)

    def loss_fn(p):
        logits, new_state = resnet.apply(
            p, state, images.to(d), depth=RESNET["depth"],
            compute_dtype=torch.float32, bn_fused=False)
        return layers.softmax_cross_entropy(logits, labels.to(d)), new_state

    (loss, new_state), grads = train_utils.value_and_grad(
        loss_fn, has_aux=True)(params)
    return loss, grads, new_state


def _leaf_items(tree, prefix=""):
    """(path, tensor) of a tree's leaves in sorted-key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaf_items(tree[k], f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def phase_spark_resnet(dev, engine, gpu, res, transport="shm"):
    """The main path: ResNet-50 SPARK-fed through the port's cluster on
    ``engine``: phase_resnet's batch as ``RESNET["batch"]`` (uint8 image,
    label) records a step, ``SPARK_RESNET_STEPS`` steps, into
    ``resnet_imagenet_spark.main_fun``.  ``res`` is phase_resnet's
    summary, whose first losses this run must give.  ``transport``: the
    feed the run must have taken, ``"shm"`` (the node's ring, the
    ``spark_resnet`` line) or ``"manager"`` (an engine whose executor
    has ``TFOS_SHM_FEED=0``, the ``spark_resnet_manager`` line); columnar
    chunks either way."""
    line = "spark_resnet" if transport == "shm" else "spark_resnet_manager"
    images_np, labels_np = _resnet_batch()
    b = RESNET["batch"]
    records = [(images_np[i], int(labels_np[i])) for i in range(b)] \
        * SPARK_RESNET_STEPS
    tmp = tempfile.mkdtemp(prefix="tfos_spark_resnet_")
    model_dir = os.path.join(tmp, "model")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, resnet_imagenet_spark.main_fun,
            {"batch_size": b, "lr": RESNET["lr"], "image_size": RESNET["image"],
             "num_classes": RESNET["num_classes"], "model_dir": model_dir,
             "save_every": 10 ** 6, "seed": 0, "out_dir": tmp},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        t_run = time.time() - t0
        c.train(engine.parallelize(records, SPARK_RESNET_STEPS),
                feed_timeout=600)
        dispatch = engine.last_dispatch
        fed = c.server.fed_partitions("input")
        c.shutdown()
        t_total = time.time() - t0
        with open(os.path.join(tmp, "resnet_imagenet-rank0.json")) as f:
            report = json.load(f)
        orphan = _alive(report["pid"])
        tree, saved = ckpt.restore_latest(os.path.join(model_dir, "ckpt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    losses, ref = report["losses"], res["losses"][:SPARK_RESNET_STEPS]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref)]
    med = statistics.median(report["step_ms"][1:])
    tm = report["train_metrics"]

    # the chief's checkpoint: HWIO kernels on disk, restored into the
    # port's params on the card, whose loss on the batch is the in-process
    # run's next step's
    kernels = {path: v.shape for path, v in _leaf_items(tree["params"])
               if v.ndim == 4}
    hwio = kernels.pop("stem/w") == (7, 7, 3, 64) and all(
        sh[0] == sh[1] in (1, 3) for sh in kernels.values())
    restored_loss = _restored_loss(dev, tree)
    next_ref = res["losses"][SPARK_RESNET_STEPS]
    peak = metrics.peak_flops(dev)
    summary = dict(
        losses=losses, phase_resnet_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        # end to end: TrainMetrics over the timed steps, the trainer's
        # waits for its next batch included
        images_per_s=tm.get("items_per_sec"), mfu=tm.get("mfu"),
        step_ms=report["step_ms"], step_ms_median_after_first=med,
        device_step_images_per_s=b / (med / 1e3),
        device_step_mfu=(b / (med / 1e3) * res["flops_per_image"] / peak
                         if peak else None),
        train_metrics=tm, infeed_stall_frac=tm["infeed_stall_frac"],
        feed_wait_s=report["feed_wait_s"],
        boot_s=report["first_step_wall"] - t0, cluster_run_s=t_run,
        main_start_s=report["main_start_wall"] - t0,
        model_ready_s=report["model_wall"] - t0, total_s=t_total,
        records=report["records"], fed_partitions=fed,
        trainer_alive_after_shutdown=orphan, peak_mem_gb=report["peak_mem_gb"],
        checkpoint_step=saved, checkpoint_hwio=hwio,
        restored_loss=restored_loss, phase_resnet_next_loss=next_ref,
        phase_resnet_images_per_s=res["images_per_s"],
        image_mb_per_step=b * images_np[0].nbytes / 1e6,
        cuda_visible_devices=report["cuda_visible_devices"],
        **feed_summary(report, dispatch), gpu=gpu)
    print(f"{line} " + json.dumps(summary), flush=True)
    check_feed(line, summary, transport)
    if len(losses) != SPARK_RESNET_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"SPARK-fed ResNet losses {losses} vs "
                             f"in-process {ref} (rtol {SPARK_LOSS_RTOL})")
    if fed != list(range(SPARK_RESNET_STEPS)) or \
            report["records"] != b * SPARK_RESNET_STEPS:
        raise AssertionError(f"fed partitions {fed}, records the trainer's "
                             f"DataFeed handed out {report['records']}")
    if orphan:
        raise AssertionError(f"trainer {report['pid']} alive after "
                             "shutdown")
    if saved != SPARK_RESNET_STEPS or not hwio or \
            abs(restored_loss - next_ref) > SPARK_LOSS_RTOL * abs(next_ref):
        raise AssertionError(
            f"chief checkpoint: step {saved}, HWIO {hwio}, loss of the "
            f"restored params {restored_loss} vs in-process {next_ref}")
    return summary


def phase_tfrecord_io(gpu, out_dir):
    """Phase 10's batch, ``SPARK_RESNET_STEPS`` times, as that many raw-
    uint8 TFRecord shards under ``out_dir`` (one step's records a shard:
    ``"image"`` the HWC bytes, ``"label"`` int64) through the port's
    native writer; read back through ``TFRecordReader`` and
    ``load_columnar``, which must give the same bytes and labels.  The
    native codec must be the one that ran.  Returns the shard paths."""
    if recordio.codec() != "native":
        raise AssertionError("the native TFRecord codec did not load: "
                             f"{recordio.tfrecord_native.error()}")
    images_np, labels_np = _resnet_batch()
    b = RESNET["batch"]
    examples = [dfutil.to_example({"image": images_np[i].tobytes(),
                                   "label": int(labels_np[i])})
                for i in range(b)]
    files = []
    t0 = time.perf_counter()
    for s in range(SPARK_RESNET_STEPS):
        path = os.path.join(out_dir, f"part-r-{s:05d}")
        with recordio.TFRecordWriter(path) as w:
            for ex in examples:
                w.write(ex)
        files.append(path)
    write_s = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(f) for f in files)

    t0 = time.perf_counter()
    recs = [list(recordio.TFRecordReader(f)) for f in files]
    read_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cols = [recordio.load_columnar(f) for f in files]
    columnar_s = time.perf_counter() - t0
    want = [images_np[i].tobytes() for i in range(b)]
    for f, rs, col in zip(files, recs, cols):
        rows = [recordio.decode_example(r) for r in rs]
        if [r["image"][1][0] for r in rows] != want or \
                [r["label"][1][0] for r in rows] != labels_np.tolist():
            raise AssertionError(f"TFRecordReader: {f} reads back other "
                                 "images or labels")
        if col["image"] != ("bytes", want) or col["label"][0] != "int64" \
                or not np.array_equal(col["label"][1], labels_np):
            raise AssertionError(f"load_columnar: {f} reads back other "
                                 "images or labels")
    summary = dict(
        codec=recordio.codec(), shards=len(files), records_per_shard=b,
        shard_mb=nbytes / len(files) / 1e6, write_s=write_s,
        write_mb_per_s=nbytes / write_s / 1e6, read_s=read_s,
        read_mb_per_s=nbytes / read_s / 1e6, columnar_s=columnar_s,
        columnar_mb_per_s=nbytes / columnar_s / 1e6,
        native_build_s=native_build.build_seconds.get("tfrecord"), gpu=gpu)
    print("tfrecord_io " + json.dumps(summary), flush=True)
    return files


def _resnet_columns(cols):
    """tfrecord_device_feed's collate: a column batch of raw-uint8 records
    -> (uint8 [n, H, W, 3], int64 [n]).  The image is a read-only view of
    the joined bytes; the placer's pinned copy is its one copy."""
    side = RESNET["image"]
    images = np.frombuffer(b"".join(cols["image"]), np.uint8).reshape(
        -1, side, side, 3)
    return images, np.asarray(cols["label"], np.int64)


def phase_tfrecord_resnet(dev, gpu, res, files):
    """``InputMode.TENSORFLOW``'s fast path at the north-star size:
    ``infeed.tfrecord_device_feed`` over phase 14's shards feeds phase
    10's step for ``SPARK_RESNET_STEPS`` steps in this process; the
    losses must equal phase 10's first ones.  Telemetry is on for the
    phase, so each batch's read lands as a ``tfrecord_read`` span."""
    params, state, step = _resnet_net(dev)
    b = RESNET["batch"]
    tm = metrics.TrainMetrics(flops_per_item=res["flops_per_image"],
                              device=dev)
    spans = tempfile.mkdtemp(prefix="tfos_tfrecord_spans_")
    saved = os.environ.get(telemetry.DIR_ENV)
    os.environ[telemetry.DIR_ENV] = spans
    try:
        _reset_counts()
        norm.launches = 0
        losses, step_ms = [], []
        batches = infeed.tfrecord_device_feed(files, b,
                                              collate=_resnet_columns,
                                              placement=dev)
        while True:
            t_wait = time.perf_counter()
            batch = next(batches, None)
            if batch is None:
                break
            if losses:
                tm.infeed_wait(time.perf_counter() - t_wait)
            images, labels = batch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, _, state = step(params, state, images, labels)
            end.record()
            losses.append(loss.item())
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
            tm.step(items=b)
        launches = _counts()
        launches["rmsnorm"] = norm.launches
        telemetry.flush()
        reads = [json.loads(line) for f in glob.glob(
            os.path.join(spans, "*.jsonl")) for line in open(f)]
    finally:
        if saved is None:
            os.environ.pop(telemetry.DIR_ENV, None)
        else:
            os.environ[telemetry.DIR_ENV] = saved
        shutil.rmtree(spans, ignore_errors=True)
    read_ms = [r["dur_ms"] for r in reads if r["name"] == "data/stage"
               and r["attrs"].get("stage") == "tfrecord_read"]
    ref = res["losses"][:SPARK_RESNET_STEPS]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref)]
    r = tm.report()
    summary = dict(
        losses=losses, phase_resnet_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        images_per_s=r.get("items_per_sec"), mfu=r.get("mfu"),
        infeed_stall_frac=r["infeed_stall_frac"], step_ms=step_ms,
        step_ms_median_after_first=statistics.median(step_ms[1:]),
        tfrecord_read_ms_per_batch=(statistics.median(read_ms)
                                    if read_ms else None),
        tfrecord_read_spans=len(read_ms),
        pin_ms_per_batch=(1e3 * infeed.pin_stats["s"]
                          / max(infeed.pin_stats["batches"], 1)),
        codec=recordio.codec(), launches=launches, gpu=gpu)
    print("tfrecord_resnet " + json.dumps(summary), flush=True)
    del params, state, step
    torch.cuda.empty_cache()
    if len(losses) != SPARK_RESNET_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"TFRecord-fed ResNet losses {losses} vs "
                             f"in-process {ref} (rtol {SPARK_LOSS_RTOL})")
    if len(read_ms) != SPARK_RESNET_STEPS:
        raise AssertionError(f"{len(read_ms)} tfrecord_read spans for "
                             f"{SPARK_RESNET_STEPS} batches")
    if any(launches.values()):
        raise AssertionError(f"the TFRecord-fed ResNet launched {launches}")
    return launches


def phase_spark_tfrecord_resnet(dev, engine, gpu, res, data_dir):
    """This slice's main path: ResNet-50 SPARK-fed from phase 14's
    TFRecord shards, which the executor reads itself
    (:func:`_spark_data_dir_run`).  The gates of phase 12 (losses, every
    partition once, no trainer left, the chief's checkpoint gives phase
    10's next loss), and no ring left, and the shm ring with columnar
    chunks, and every task the engine pickled under
    ``TFRECORD_TASK_MAX_BYTES``, the native codec, no kernel launched."""
    r = _spark_data_dir_run(dev, engine, data_dir)
    b = RESNET["batch"]
    losses, ref = r["losses"], res["losses"][:SPARK_RESNET_STEPS]
    rel = [abs(a - x) / abs(x) for a, x in zip(losses, ref)]
    next_ref = res["losses"][SPARK_RESNET_STEPS]
    summary = dict(r, phase_resnet_losses=ref,
                   max_rel_loss_diff=max(rel) if rel else None,
                   phase_resnet_next_loss=next_ref,
                   phase_resnet_images_per_s=res["images_per_s"], gpu=gpu)
    print("spark_tfrecord_resnet " + json.dumps(summary), flush=True)
    check_feed("spark_tfrecord_resnet", summary, "shm")
    if len(losses) != SPARK_RESNET_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"TFRecord SPARK-fed ResNet losses {losses} "
                             f"vs in-process {ref} (rtol {SPARK_LOSS_RTOL})")
    if r["fed_partitions"] != list(range(r["partitions"])) or \
            r["records"] != b * SPARK_RESNET_STEPS:
        raise AssertionError(f"fed partitions {r['fed_partitions']} of "
                             f"{r['partitions']}, records the trainer's "
                             f"DataFeed handed out {r['records']}")
    if r["trainer_alive_after_shutdown"] or r["ring_left"]:
        raise AssertionError(f"after shutdown: trainer alive "
                             f"{r['trainer_alive_after_shutdown']}, ring "
                             f"left {r['ring_left']}")
    if r["task_max_bytes"] >= TFRECORD_TASK_MAX_BYTES:
        raise AssertionError(f"the engine pickled a task of "
                             f"{r['task_max_bytes']} bytes (limit "
                             f"{TFRECORD_TASK_MAX_BYTES})")
    if r["codec"] != "native":
        raise AssertionError(f"the executor read the shards with the "
                             f"{r['codec']!r} codec, not the native one")
    if r["checkpoint_step"] != SPARK_RESNET_STEPS or \
            abs(r["restored_loss"] - next_ref) > SPARK_LOSS_RTOL * abs(next_ref):
        raise AssertionError(f"chief checkpoint: step {r['checkpoint_step']}"
                             f", loss of the restored params "
                             f"{r['restored_loss']} vs in-process {next_ref}")
    if any(r["launches"].values()):
        raise AssertionError(f"the TFRecord SPARK-fed trainer launched "
                             f"{r['launches']}")
    return r["launches"], r


def _restored_loss(dev, tree):
    """Phase 10's batch's loss under the params of a checkpoint tree."""
    images_np, labels_np = _resnet_batch()
    params, state, _ = _resnet_net(dev)
    resnet.restore_checkpoint_tree(tree, params, state, torch.optim.SGD(
        resnet.param_leaves(params), lr=RESNET["lr"]))
    with torch.no_grad():
        logits, _ = resnet.apply(params, state,
                                 torch.from_numpy(images_np).to(dev),
                                 depth=RESNET["depth"])
        loss = layers.softmax_cross_entropy(
            logits, torch.from_numpy(labels_np).to(dev)).item()
    del params, state, logits
    torch.cuda.empty_cache()
    return loss


def _spark_data_dir_run(dev, engine, data_dir, steps=SPARK_RESNET_STEPS):
    """``resnet_imagenet_spark.main_fun`` SPARK-fed (``num_gpus=1``) from
    the TFRecord shards of ``data_dir`` on ``engine``, read and decoded
    by the executor: ``_records`` with ``--data_dir``
    (``dfutil.load_tfrecords``' read units, then the decode, through
    ``map_partitions``), so the tasks carry file names, never images.
    Returns what the trainer reported, the feed's summary, the
    partitions, what shutdown left (trainer, ring) and the loss of
    phase 10's batch under the chief's restored checkpoint."""
    b = RESNET["batch"]
    args = argparse.Namespace(
        data_dir=data_dir, cluster_size=1, image_size=RESNET["image"],
        batch_size=b, num_classes=RESNET["num_classes"],
        steps=steps, decode_threads=None)
    tmp = tempfile.mkdtemp(prefix="tfos_spark_jpeg_")
    try:
        t0 = time.time()
        ds = resnet_imagenet_spark._records(args, engine)
        c = TFCluster.run(
            engine, resnet_imagenet_spark.main_fun,
            {"batch_size": b, "lr": RESNET["lr"],
             "image_size": RESNET["image"],
             "num_classes": RESNET["num_classes"],
             "model_dir": os.path.join(tmp, "model"),
             "save_every": 10 ** 6, "seed": 0, "out_dir": tmp},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        t_run = time.time() - t0
        c.train(ds, feed_timeout=600)
        dispatch = engine.last_dispatch
        fed = c.server.fed_partitions("input")
        ring = "/dev/shm" + node.feed_ring_name(c.cluster_meta["id"], 0)
        c.shutdown()
        total_s = time.time() - t0
        with open(os.path.join(tmp, "resnet_imagenet-rank0.json")) as f:
            report = json.load(f)
        tree, saved = ckpt.restore_latest(os.path.join(tmp, "model", "ckpt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fs = feed_summary(report, dispatch)
    tm = report["train_metrics"]
    med = statistics.median(report["step_ms"][1:])
    stages = [row["lineage_ms"] for row in fs["handoff"]]
    decodes = collections.Counter()
    for f in report["feeders"] or []:
        decodes.update(f.get("jpeg") or {})
    return dict(
        losses=report["losses"], images_per_s=tm.get("items_per_sec"),
        mfu=tm.get("mfu"), infeed_stall_frac=tm["infeed_stall_frac"],
        step_ms=report["step_ms"], step_ms_median_after_first=med,
        device_step_images_per_s=b / (med / 1e3),
        feed_wait_s=report["feed_wait_s"], total_s=total_s,
        boot_s=report["first_step_wall"] - t0, cluster_run_s=t_run,
        main_start_s=report["main_start_wall"] - t0,
        model_ready_s=report["model_wall"] - t0,
        first_feeder_start_s=min((f["start_wall"] for f in
                                  report["feeders"] or []),
                                 default=t0) - t0,
        partitions=ds.num_partitions,
        records_per_partition=[row["records"] for row in fs["handoff"]],
        read_ms_per_partition=[s[0] for s in stages if s],
        decode_ms_per_partition=[s[1] for s in stages if len(s) > 1],
        jpeg_decodes=dict(decodes), records=report["records"],
        fed_partitions=fed, trainer_alive_after_shutdown=_alive(
            report["pid"]),
        ring_left=os.path.exists(ring), checkpoint_step=saved,
        restored_loss=_restored_loss(dev, tree) if tree else None,
        launches=report["launches"], peak_mem_gb=report["peak_mem_gb"],
        **fs)


def _photo(rng, h, w):
    """A seeded photo-like uint8 [h, w, 3] image: smooth waves a channel
    and mild noise, so its JPEG is photo-sized (random noise would make
    JPEGs several times larger and slower to decode than ImageNet's)."""
    yy = np.linspace(0, 2 * np.pi, h, dtype=np.float32)[:, None]
    xx = np.linspace(0, 2 * np.pi, w, dtype=np.float32)[None, :]
    chans = []
    for _ in range(3):
        fx, fy = rng.uniform(1, 6, 2)
        px, py = rng.uniform(0, 2 * np.pi, 2)
        chans.append(128 + 90 * np.sin(fx * xx + px) * np.cos(fy * yy + py))
    img = np.stack(chans, -1) + rng.integers(-12, 13, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


def _jpeg(arr, mode=None):
    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr, mode=mode).save(buf, "JPEG", quality=JPEG_QUALITY)
    return buf.getvalue()


def write_jpeg_shards(out_dir):
    """``JPEG_SHARDS`` shards of ``RESNET["batch"]`` JPEG records
    under ``out_dir`` with the TF-official keys (``image/encoded``,
    1-based ``image/class/label``), through the port's writer.  Returns
    ``(paths, [[(payload, 0-based label)] a shard], seconds)``."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    pool = [_jpeg(_photo(rng, h, w)) for h, w in JPEG_SIZES
            for _ in range(JPEG_DISTINCT)]
    b = RESNET["batch"]
    os.makedirs(out_dir, exist_ok=True)
    paths, shards = [], []
    for s in range(JPEG_SHARDS):
        order = rng.permutation(len(pool))[np.arange(b) % len(pool)]
        labels = rng.integers(0, RESNET["num_classes"], b)
        recs = [(pool[i], int(lbl)) for i, lbl in zip(order, labels)]
        path = os.path.join(out_dir, f"part-r-{s:05d}")
        with recordio.TFRecordWriter(path) as w:
            for payload, label in recs:
                w.write(recordio.encode_example({
                    "image/encoded": ("bytes", [payload]),
                    "image/class/label": ("int64", [label + 1])}))
        paths.append(path)
        shards.append(recs)
    return paths, shards, time.perf_counter() - t0


_PIL_DECODE = r"""
import json, sys, time
from tensorflowonspark_tpu_torch import recordio
from tensorflowonspark_tpu_torch.recordio import jpeg
datas = [recordio.decode_example(r)["image/encoded"][1][0]
         for r in recordio.TFRecordReader(sys.argv[1])]
t0 = time.perf_counter()
jpeg.decode_batch(datas, int(sys.argv[2]))
dt = time.perf_counter() - t0
print(json.dumps(dict(images=len(datas), seconds=dt,
                      available=jpeg.available(),
                      counts=jpeg.decode_counts())))
"""


def phase_jpeg_decode(gpu, jpeg_dir):
    """16a ``jpeg_decode``: the port's native libjpeg decoder on the
    card's host.  It must build (by the system's libjpeg, or the
    vendored headers and Pillow's bundled libjpeg) and pass its
    self-test; every JPEG of the shards decodes natively (0 PIL
    arbitrations), on one thread and through ``decode_batch``'s pool,
    with the same bytes; a CMYK JPEG decodes through one arbitration; a
    truncated stream raises ValueError.  Times the native decode on one
    thread and the pool, and the PIL path (``TFOS_NO_NATIVE=1``, one
    shard) in a subprocess.  Returns the shards' records."""
    t0 = time.perf_counter()
    native_build.build(["jpeg"])
    build_s = time.perf_counter() - t0
    if not jpeg.available():
        raise AssertionError(f"the native JPEG decoder did not build or "
                             f"failed its self-test: {jpeg.error()}")
    paths, shards, make_s = write_jpeg_shards(jpeg_dir)
    datas = [p for recs in shards for p, _ in recs]
    size = RESNET["image"]
    jpeg.reset_decode_counts()
    t0 = time.perf_counter()
    one = np.stack([jpeg.decode_resized(d, size) for d in datas])
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    pool = jpeg.decode_batch(datas, size)
    pool_s = time.perf_counter() - t0
    counts = jpeg.decode_counts()
    same = bool(np.array_equal(one, pool))
    jpeg.reset_decode_counts()
    cmyk = jpeg.decode_resized(_jpeg(np.full((375, 500, 4), 120, np.uint8),
                                     mode="CMYK"), size)
    cmyk_counts = jpeg.decode_counts()
    try:
        jpeg.decode_resized(datas[0][:int(len(datas[0]) * 0.8)], size)
        truncated = "decoded"
    except ValueError:
        truncated = "ValueError"
    # the port's root: this file's directory
    env = dict(os.environ, TFOS_NO_NATIVE="1",
               PYTHONPATH=os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", _PIL_DECODE, paths[0],
                          str(size)], env=env, capture_output=True,
                         text=True, timeout=600)
    if out.returncode != 0:
        raise AssertionError(f"the PIL decode subprocess failed: "
                             f"{out.stderr[-2000:]}")
    pil = json.loads(out.stdout.strip().splitlines()[-1])
    sizes = [len(d) for d in datas]
    summary = dict(
        build=native_build.jpeg_build_info(), build_s=build_s,
        built_this_run=native_build.build_seconds.get("jpeg"),
        cpu_count=os.cpu_count(), affinity=len(os.sched_getaffinity(0)),
        pool_threads=jpeg.default_threads(), images=len(datas),
        sizes=[f"{w}x{h}" for h, w in JPEG_SIZES],
        distinct_images=len(JPEG_SIZES) * JPEG_DISTINCT,
        jpeg_kb_mean=statistics.mean(sizes) / 1e3, make_s=make_s,
        native_1_thread_images_per_s=len(datas) / one_s,
        native_pool_images_per_s=len(datas) / pool_s,
        pil_images_per_s=pil["images"] / pil["seconds"],
        pil_images=pil["images"], pil_subprocess=pil,
        counts=counts, pool_equals_sequential=same,
        cmyk_counts=cmyk_counts, cmyk_shape=list(cmyk.shape),
        truncated=truncated, gpu=gpu)
    print("jpeg_decode " + json.dumps(summary), flush=True)
    if counts != {"native": 2 * len(datas), "pil": 0}:
        raise AssertionError(f"JPEG decodes {counts}: want all "
                             f"{2 * len(datas)} native, 0 through PIL")
    if not same:
        raise AssertionError("decode_batch differs from decode_resized")
    if cmyk_counts != {"native": 0, "pil": 1}:
        raise AssertionError(f"CMYK decode counts {cmyk_counts}")
    if truncated != "ValueError":
        raise AssertionError("a truncated JPEG decoded")
    if pil["available"] or pil["counts"]["native"]:
        raise AssertionError(f"TFOS_NO_NATIVE=1 decoded natively: {pil}")
    return shards


def phase_imagenet_setup(gpu, engine, jpeg_dir, raw_dir, shards):
    """16b ``imagenet_setup``: ``imagenet_data_setup.convert`` of the JPEG
    shards into raw ones through the one-executor engine; nothing
    skipped, and each raw shard equals ``decode_records_batch`` of its
    JPEG records in this process."""
    t0 = time.perf_counter()
    results = imagenet_data_setup.convert(engine, jpeg_dir, raw_dir,
                                          RESNET["image"], 1)
    setup_s = time.perf_counter() - t0
    records = sum(r[1] for r in results)
    skipped = sum(r[2] for r in results)
    mismatched = []
    for (name, _, _), recs in zip(results, shards):
        want = imagenet_records.decode_records_batch(
            [{"image/encoded": [p], "image/class/label": [lbl + 1]}
             for p, lbl in recs], RESNET["image"])
        cols = recordio.load_columnar(os.path.join(raw_dir, name))
        if cols["image"][1] != [img.tobytes() for img, _ in want] or \
                cols["label"][1].tolist() != [lbl for _, lbl in want]:
            mismatched.append(name)
    summary = dict(shards=len(results), records=records, skipped=skipped,
                   seconds=setup_s, images_per_s=records / setup_s,
                   mismatched=mismatched, gpu=gpu)
    print("imagenet_setup " + json.dumps(summary), flush=True)
    if skipped or records != RESNET["batch"] * JPEG_SHARDS \
            or mismatched:
        raise AssertionError(f"imagenet_data_setup: {records} records, "
                             f"{skipped} skipped, shards differing from "
                             f"decode_records_batch: {mismatched}")


def phase_spark_jpeg_resnet(dev, engine, gpu, jpeg_dir, raw_dir):
    """16c ``spark_jpeg_resnet``, the JPEG slice's main path:
    ``resnet_imagenet_spark.main_fun`` SPARK-fed (``num_gpus=1``) with
    ``--data_dir`` on the JPEG shards, which the executor reads and
    decodes natively, then hands over the shm ring as columnar chunks;
    then the same on ``imagenet_setup``'s raw shards.  The pixels are
    the same, so the losses (and the chiefs' restored params' losses)
    agree within ``SPARK_LOSS_RTOL``; every partition once, no trainer
    and no ring left, every task under ``TFRECORD_TASK_MAX_BYTES``, every
    JPEG decoded natively, no kernel launched in either trainer.
    Returns both trainers' launches, summed."""
    runs = {name: _spark_data_dir_run(dev, engine, d, steps=JPEG_SHARDS)
            for name, d in (("jpeg", jpeg_dir), ("raw", raw_dir))}
    jr, rr = runs["jpeg"], runs["raw"]
    rel = [abs(a - r) / abs(r) for a, r in zip(jr["losses"], rr["losses"])]
    n = RESNET["batch"] * JPEG_SHARDS
    summary = dict(max_rel_loss_diff=max(rel) if rel else None,
                   jpeg=jr, raw=rr, gpu=gpu)
    print("spark_jpeg_resnet " + json.dumps(summary), flush=True)
    for name, r in runs.items():
        check_feed(f"spark_jpeg_resnet ({name})", r, "shm")
        if r["fed_partitions"] != list(range(r["partitions"])) or \
                r["records"] != n:
            raise AssertionError(f"{name}: fed partitions "
                                 f"{r['fed_partitions']} of "
                                 f"{r['partitions']}, records {r['records']}")
        if r["trainer_alive_after_shutdown"] or r["ring_left"]:
            raise AssertionError(f"{name}: trainer or ring left after "
                                 "shutdown")
        if r["task_max_bytes"] >= TFRECORD_TASK_MAX_BYTES:
            raise AssertionError(f"{name}: a task of {r['task_max_bytes']} "
                                 f"bytes")
        if r["checkpoint_step"] != JPEG_SHARDS or \
                r["restored_loss"] is None:
            raise AssertionError(f"{name}: the chief's checkpoint did not "
                                 f"restore (step {r['checkpoint_step']})")
        if any(r["launches"].values()):
            raise AssertionError(f"{name}: the trainer launched "
                                 f"{r['launches']}")
    if len(jr["losses"]) != JPEG_SHARDS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"JPEG-fed losses {jr['losses']} vs raw "
                             f"{rr['losses']} (rtol {SPARK_LOSS_RTOL})")
    if abs(jr["restored_loss"] - rr["restored_loss"]) > \
            SPARK_LOSS_RTOL * abs(rr["restored_loss"]):
        raise AssertionError(f"restored losses {jr['restored_loss']} (JPEG) "
                             f"vs {rr['restored_loss']} (raw)")
    if jr["jpeg_decodes"] != {"native": n, "pil": 0}:
        raise AssertionError(f"the executor's JPEG decodes "
                             f"{jr['jpeg_decodes']}: want {n} native")
    return _sum_launches(jr["launches"], rr["launches"])


def _remote_url(name):
    return f"memory://tfos-chip-smoke-{os.getpid()}/{name}"


def phase_remote_io(dev, gpu, files):
    """16d ``remote_io``, in process through ``memory://`` (fsspec):
    phase 14's shards written with ``TFRecordWriter`` (framed in memory,
    one PUT each) have the local files' bytes, read back through
    ``TFRecordReader`` and ``load_columnar`` as the local files read; a
    ResNet-50 checkpoint tree (``checkpoint_tree`` of phase 10's net)
    round-trips through ``save_checkpoint``/``restore_latest`` and
    ``export_model``/``load_exported`` as locally."""
    base = _remote_url("")
    mfs, root = rfs.get_fs(base)
    tmp = tempfile.mkdtemp(prefix="tfos_remote_io_")
    try:
        recs = [list(recordio.TFRecordReader(f)) for f in files]
        nbytes = sum(os.path.getsize(f) for f in files)
        urls = [_remote_url(f"tfr/{os.path.basename(f)}") for f in files]
        t0 = time.perf_counter()
        for url, rs in zip(urls, recs):
            with recordio.TFRecordWriter(url) as w:
                for r in rs:
                    w.write(r)
        write_s = time.perf_counter() - t0
        same_bytes = all(rfs.read_bytes(u) == open(f, "rb").read()
                         for u, f in zip(urls, files))
        t0 = time.perf_counter()
        back = [list(recordio.TFRecordReader(u)) for u in urls]
        read_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        cols = [recordio.load_columnar(u) for u in urls]
        columnar_s = time.perf_counter() - t0
        same_cols = all(
            c["image"] == lc["image"] and np.array_equal(c["label"][1],
                                                         lc["label"][1])
            for c, lc in zip(cols, (recordio.load_columnar(f)
                                    for f in files)))
        del recs, back, cols

        params, state, _ = _resnet_net(dev)
        tree = resnet.checkpoint_tree(params, state, torch.optim.SGD(
            resnet.param_leaves(params), lr=RESNET["lr"]))
        del params, state
        tree_mb = sum(v.nbytes for v in ckpt._flatten(tree).values()) / 1e6
        trips = {}
        for where, d in (("remote", _remote_url("model")),
                         ("local", tmp)):
            t0 = time.perf_counter()
            ckpt.save_checkpoint(rfs.join(d, "ckpt"), tree, 1)
            got, step_no = ckpt.restore_latest(rfs.join(d, "ckpt"))
            ckpt.export_model(rfs.join(d, "export"), tree["params"],
                              metadata={"predict": "resnet"})
            exported, meta = ckpt.load_exported(rfs.join(d, "export"))
            trips[where] = dict(seconds=time.perf_counter() - t0,
                                step=step_no, tree=ckpt._flatten(got),
                                export=ckpt._flatten(exported), meta=meta)
        want = ckpt._flatten(tree)
        n_params = sum(k.startswith("params/") for k in want)
        ckpt_same = all(
            t["step"] == 1 and sorted(t["tree"]) == sorted(want)
            and all(np.array_equal(t["tree"][k], want[k]) for k in want)
            and len(t["export"]) == n_params
            and all(np.array_equal(v, want["params/" + k])
                    for k, v in t["export"].items())
            for t in trips.values())
    finally:
        if mfs.exists(root):
            mfs.rm(root, recursive=True)
        shutil.rmtree(tmp, ignore_errors=True)
    summary = dict(
        shards=len(files), mb=nbytes / 1e6, write_mb_per_s=nbytes / write_s
        / 1e6, read_mb_per_s=nbytes / read_s / 1e6,
        columnar_mb_per_s=nbytes / columnar_s / 1e6,
        bytes_equal_local=same_bytes, columns_equal_local=same_cols,
        checkpoint_mb=tree_mb,
        checkpoint_round_trip_s={k: t["seconds"] for k, t in trips.items()},
        checkpoint_equal_local=ckpt_same, gpu=gpu)
    print("remote_io " + json.dumps(summary), flush=True)
    if not (same_bytes and same_cols and ckpt_same):
        raise AssertionError(f"memory:// round trips differ from the local "
                             f"ones: {summary}")


def phase_async_checkpoint(dev, gpu):
    """16e ``async_checkpoint``: phase 10's net (params, BN state and SGD
    momentum on the card) steps on phase 10's batch, saving its tree
    every ``ASYNC_CKPT["every"]`` steps: ``sync_saves`` times through
    ``save_checkpoint``, then ``async_saves`` times through an
    ``AsyncCheckpointer(keep=ASYNC_CKPT["keep"])``.  Times how long each
    save blocks the step loop.  Each file must hold the tree of its own
    step (taken to the host beside the save, outside the timing) and
    differ from the tree after the steps that follow (the snapshot
    check); ``keep`` prunes the oldest; ``close`` waits for the last
    file; a ``checkpoint.save`` fault planned for the writer surfaces at
    the next call.  Returns the kernels' launches in these steps."""
    images_np, labels_np = _resnet_batch()
    images = torch.from_numpy(images_np).to(dev)
    labels = torch.from_numpy(labels_np).to(dev)
    params, state = resnet.init(
        torch.Generator(device=dev).manual_seed(0), depth=RESNET["depth"],
        num_classes=RESNET["num_classes"], device=dev)
    leaves = [p.requires_grad_() for p in resnet.param_leaves(params)]
    opt = torch.optim.SGD(leaves, lr=RESNET["lr"], momentum=0.9)
    step = resnet.make_train_step(opt, depth=RESNET["depth"])
    every = ASYNC_CKPT["every"]
    _reset_counts()
    norm.launches = 0

    def tree():
        return {"params": params, "state": state,
                "opt": train_utils.sgd_momentum_tree(opt, params)}

    def host_tree():  # copies (a CPU tensor's numpy() is a view)
        return {k: v.copy() for k, v in ckpt._flatten(tree()).items()}

    tmp = tempfile.mkdtemp(prefix="tfos_async_ckpt_")
    blocked, refs, finals = {"sync": [], "async": []}, {}, {}
    try:
        n = 0
        for mode, saves in (("sync", ASYNC_CKPT["sync_saves"]),
                            ("async", ASYNC_CKPT["async_saves"])):
            d = os.path.join(tmp, mode)
            saver = (ckpt.AsyncCheckpointer(d, keep=ASYNC_CKPT["keep"])
                     if mode == "async" else None)
            for _ in range(saves):
                for _ in range(every):
                    _, _, state = step(params, state, images, labels)
                    n += 1
                t0 = time.perf_counter()
                if saver is None:
                    ckpt.save_checkpoint(d, tree(), n, keep=10)
                else:
                    saver.save(n, tree())
                blocked[mode].append(1e3 * (time.perf_counter() - t0))
                refs[(mode, n)] = host_tree()
            for _ in range(every):  # the steps after the last save
                _, _, state = step(params, state, images, labels)
                n += 1
            finals[mode] = host_tree()
            if saver is not None:
                saver.close()
                closed = sorted(os.listdir(d))
                saver.close()  # idempotent
        launches = _counts()
        launches["rmsnorm"] = norm.launches
        tree_mb = sum(v.nbytes for v in finals["sync"].values()) / 1e6
        # each file against its step's tree, and the tree that followed
        mismatched, undiscriminating = [], []
        keys = sorted(refs)
        for i, (mode, s) in enumerate(keys):
            path = os.path.join(tmp, mode, f"ckpt-{s:08d}.npz")
            if not os.path.exists(path):
                continue
            got = ckpt._flatten(ckpt.load_checkpoint(path))
            want = refs[(mode, s)]
            later = (refs[keys[i + 1]] if i + 1 < len(keys)
                     and keys[i + 1][0] == mode else finals[mode])
            if sorted(got) != sorted(want) or not all(
                    np.array_equal(got[k], want[k]) for k in want):
                mismatched.append(path)
            if all(np.array_equal(got[k], later[k]) for k in want):
                undiscriminating.append(path)
        async_steps = [s for m, s in keys if m == "async"]
        want_kept = [f"ckpt-{s:08d}.npz"
                     for s in async_steps[-ASYNC_CKPT["keep"]:]]

        # a fault planned for the writer surfaces at the next call
        os.environ[faults.PLAN_ENV] = "checkpoint.save:exc@1"
        try:
            saver = ckpt.AsyncCheckpointer(os.path.join(tmp, "fault"))
            saver.save(1, {"w": np.zeros(4, np.float32)})
            try:
                saver.close()
                fault = "not raised"
            except faults.FaultInjected as e:
                fault = f"raised at close: {e}"
        finally:
            os.environ.pop(faults.PLAN_ENV, None)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        del params, state, step, opt
        torch.cuda.empty_cache()
    summary = dict(
        tree_mb=tree_mb, every=every,
        blocked_ms={k: v for k, v in blocked.items()},
        blocked_ms_median={k: statistics.median(v)
                           for k, v in blocked.items()},
        saves=[f"{m}-{s}" for m, s in keys], kept_async=closed,
        want_kept_async=want_kept, mismatched=mismatched,
        equal_to_the_next_tree=undiscriminating, fault=fault,
        launches=launches, gpu=gpu)
    print("async_checkpoint " + json.dumps(summary), flush=True)
    if mismatched or undiscriminating:
        raise AssertionError(f"checkpoint files not their own step's tree: "
                             f"{mismatched}; equal to a later tree: "
                             f"{undiscriminating}")
    if closed != want_kept:
        raise AssertionError(f"after close the async directory holds "
                             f"{closed}, want {want_kept}")
    if not fault.startswith("raised"):
        raise AssertionError("a checkpoint.save fault in the writer did "
                             "not surface")
    if any(launches.values()):
        raise AssertionError(f"the ResNet steps launched {launches}")
    return launches


def phase_spark_mnist_checkpoint(engine, gpu):
    """16f ``spark_mnist_checkpoint``: ``mnist_spark.main_fun`` SPARK-fed
    on the card (``num_gpus=1``) for ``MNIST_CKPT_STEPS`` steps with a
    ``model_dir``: the chief's ``ckpt`` restores through
    ``restore_latest`` at the last step, with the export's values, which
    are the trainer's final params (HWIO on disk)."""
    b = 64
    records = mnist_spark.synthetic_records(b * MNIST_CKPT_STEPS, seed=5)
    tmp = tempfile.mkdtemp(prefix="tfos_mnist_ckpt_")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, mnist_spark.main_fun,
            {"batch_size": b, "lr": 0.05, "seed": 0,
             "model_dir": os.path.join(tmp, "model"), "out_dir": tmp},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        c.train(engine.parallelize(records, 4), feed_timeout=600)
        c.shutdown()
        total_s = time.time() - t0
        tree, saved = ckpt.restore_latest(os.path.join(tmp, "model", "ckpt"))
        exported, meta = ckpt.load_exported(os.path.join(tmp, "model",
                                                         "export"))
        final = dict(np.load(os.path.join(tmp, "mnist-rank0.npz")))
        with open(os.path.join(tmp, "mnist-rank0.json")) as f:
            losses = json.load(f)["losses"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    got, want = ckpt._flatten(tree or {}), ckpt._flatten(exported)
    same_export = sorted(got) == sorted(want) and all(
        np.array_equal(got[k], want[k]) for k in want)
    same_final = all(
        np.array_equal(got[k], final[k.replace("/", ".")].transpose(2, 3, 1, 0)
                       if got[k].ndim == 4 else final[k.replace("/", ".")])
        for k in got)
    summary = dict(steps=len(losses), checkpoint_step=saved,
                   equals_export=same_export, equals_final_params=same_final,
                   predict=meta.get("predict"), total_s=total_s,
                   losses_first_last=[losses[0], losses[-1]] if losses
                   else None, gpu=gpu)
    print("spark_mnist_checkpoint " + json.dumps(summary), flush=True)
    if saved != MNIST_CKPT_STEPS or not (same_export and same_final):
        raise AssertionError(f"mnist_spark's chief checkpoint: {summary}")


def tf32_off_main(args, ctx):
    """``mnist_tf_ds.main_fun`` with float32 kept float32 in the executor
    (TF32 off, deterministic cuDNN), as this process computes its
    reference: a module-level function, so the engine ships it."""
    _exact_float32()
    mnist_tf_ds.main_fun(args, ctx)


def _exact_float32():
    """TF32 off for float32 matmuls and convolutions, and cuDNN's
    deterministic algorithms; returns the previous determinism flag."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    saved = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    return saved


def phase_tf_mode_mnist(dev, engine, gpu, tmp):
    """``InputMode.TENSORFLOW`` end to end: ``mnist_data_setup``'s four
    TFRecord shards in ``tmp``, then ``cluster.run`` of
    ``mnist_tf_ds.main_fun`` on ``engine`` (an engine of its own: the
    executor runs ``main_fun`` and so holds a CUDA context, and must fork
    no SPARK trainer after it), 10 steps on the card.  Every loss finite
    and equal to the same batches stepped here; the chief's export loads
    with ``load_exported`` and predicts as this process's trained
    params.  Returns the launches and the shut-down cluster, which
    ``phase_serve_predict`` serves the export from."""
    cfg = TF_MNIST
    try:
        images, labels = mnist_data_setup.synthetic_mnist(cfg["num_examples"])
        _, tfr = mnist_data_setup.write_shards(images, labels, tmp,
                                               cfg["partitions"])
        t0 = time.time()
        c = TFCluster.run(
            engine, tf32_off_main,
            {"batch_size": cfg["batch_size"], "lr": cfg["lr"],
             "steps": cfg["steps"], "data_dir": tfr, "seed": 0,
             "model_dir": os.path.join(tmp, "model"), "out_dir": tmp},
            num_executors=1, input_mode=TFCluster.InputMode.TENSORFLOW,
            master_node="chief", num_gpus=1, reservation_timeout=300)
        c.shutdown()
        total_s = time.time() - t0
        with open(os.path.join(tmp, "mnist_tf-rank0.json")) as f:
            report = json.load(f)
        exported, meta = ckpt.load_exported(os.path.join(tmp, "model",
                                                         "export"))
    except BaseException:
        engine.stop()
        raise

    # the same steps here: the same init (seed 0), records and batches
    deterministic = _exact_float32()
    try:
        params = mnist.init_params(
            torch.Generator(device=dev).manual_seed(0), device=dev)
        leaves = [p.requires_grad_() for layer in params.values()
                  for p in layer.values()]
        step_fn = mnist.make_train_step(torch.optim.SGD(
            leaves, lr=cfg["lr"], momentum=0.9))
        images_t = torch.from_numpy(images).to(dev)
        labels_t = torch.from_numpy(labels.astype(np.int64)).to(dev)
        rng = np.random.default_rng(0)
        ref = []
        for _ in range(cfg["steps"]):
            idx = torch.from_numpy(rng.integers(0, len(images),
                                                cfg["batch_size"])).to(dev)
            loss, _ = step_fn(params, images_t[idx], labels_t[idx])
            ref.append(loss.item())
        probe = images[:cfg["batch_size"] * 4]
        with torch.no_grad():
            want = mnist.apply(params, torch.from_numpy(probe).to(dev)).cpu()
        got = mnist.predict(exported, {"image": probe}, device=dev)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    pred_err = (torch.from_numpy(got["logits"]) - want).abs().max().item() \
        / want.abs().max().item()
    losses = report["losses"]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref)]
    summary = dict(
        steps=len(losses), losses_first_last=[losses[0], losses[-1]],
        ref_first_last=[ref[0], ref[-1]],
        max_rel_loss_diff=max(rel) if rel else None,
        files=report["files"], records=report["records"],
        executor_pid=report["pid"], device=report["device"],
        export_format=meta.get("format"), export_predict=meta.get("predict"),
        predict_rel_err=pred_err,
        predict_same_argmax=bool((got["prediction"]
                                  == want.argmax(-1).numpy()).all()),
        total_s=total_s, launches=report["launches"], gpu=gpu)
    print("tf_mode_mnist " + json.dumps(summary), flush=True)
    if not all(np.isfinite(losses)) or len(losses) != cfg["steps"] or \
            max(rel) > TF_MNIST_RTOL:
        raise AssertionError(f"TENSORFLOW-mode MNIST losses {losses} vs "
                             f"in-process {ref} (rtol {TF_MNIST_RTOL})")
    if report["pid"] == os.getpid() or not report["device"].startswith(
            dev.type) or report["records"] != cfg["num_examples"] or \
            len(report["files"]) != cfg["partitions"]:
        raise AssertionError(f"main_fun ran in pid {report['pid']} on "
                             f"{report['device']}, read {report['files']} "
                             f"({report['records']} records)")
    if meta.get("format") != ckpt.EXPORT_FORMAT or \
            meta.get("predict") != mnist.PREDICT or \
            not summary["predict_same_argmax"] or pred_err > TF_MNIST_RTOL:
        raise AssertionError(f"export {meta}: predictions off by "
                             f"{pred_err} of the largest logit")
    if any(report["launches"].values()):
        raise AssertionError(f"the TENSORFLOW-mode executor launched "
                             f"{report['launches']}")
    return report["launches"], c


# -- online serving -----------------------------------------------------------

def _percentile(vals, q):
    return float(np.percentile(vals, q)) if len(vals) else None


def _http_json(url, body=None, timeout=600):
    """GET (``body`` None) or POST a JSON body; the decoded reply."""
    req = urllib.request.Request(
        url, data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.loads(r.read())


def _concurrently(fn, items):
    """``fn(item)`` for every item on a thread each; the results in
    order.  Any failure raises."""
    out, errors = [None] * len(items), []

    def one(i):
        try:
            out[i] = fn(items[i])
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(items))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _decode_spec(cfg, max_tokens):
    """The serve phases' decode tier: slots 8, paged KV in 16-token
    blocks, prefix sharing."""
    return DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=max_tokens)


def _replica_launches(reps):
    """The kernels' launches of a pool's replicas (or hosts), summed."""
    return {k: sum(r["launches"][k] for r in reps.values())
            for k in ("flash_fwd", "flash_dq", "flash_dkv", "rmsnorm")}


def _decode_server(export_dir, ckpt_dir, cfg, dev, engine, max_tokens):
    """A started 2-replica decode ``Server`` on ``engine`` with
    :func:`_decode_spec`'s tier."""
    spec = serving.ModelSpec(
        export_dir=export_dir, ckpt_dir=ckpt_dir, device=str(dev),
        decode=_decode_spec(cfg, max_tokens))
    return serving.Server(spec, num_replicas=2, engine=engine,
                          request_timeout=600).start(timeout=600)


def _serve_launch_gate(reps, cfg):
    """Every replica launched the flash forward kernel on each layer of
    each of its plain prefills (a graph's replay counting the launches
    its capture recorded), and none of the other kernels; its engine
    stepped in CUDA graphs (:func:`_graph_gate`)."""
    for idx, r in reps.items():
        _graph_gate(f"replica {idx}", r["decode"])
        plain = r["decode"]["prefills"] - r["decode"]["extends"]
        got = r["launches"]
        if got["flash_fwd"] < cfg.n_layers * plain or (
                plain and got["flash_fwd"] == 0):
            raise AssertionError(f"replica {idx}: flash_fwd launched "
                                 f"{got['flash_fwd']} times for {plain} "
                                 f"plain prefills x {cfg.n_layers} layers")
        if any(got[k] for k in ("flash_dq", "flash_dkv", "rmsnorm")):
            raise AssertionError(f"replica {idx} launched {got}")


def _session_gate(sid, out, max_tokens, vocab):
    toks = out["tokens"]
    if len(toks) != max_tokens or len(out["token_ms"]) != max_tokens - 1 \
            or not all(0 <= t < vocab for t in toks):
        raise AssertionError(f"{sid}: {len(toks)} tokens, "
                             f"{len(out['token_ms'])} gaps, tokens {toks}")


def phase_serve_decode(dev, gpu, engine, tmp):
    """``serve_decode``: the full-width transformer (bf16, flash, seed 0)
    exported with ``export_model`` and served by a 2-replica ``Server``
    on ``engine``; phase 8's 16 sessions go in at once as ``POST
    /v1/generate``, after a first burst of the same mix drawn from
    another seed (fresh replicas: their first cuBLAS calls, kernel-library
    loads and allocations; its figures are the ``cold`` ones).  Each
    session streams indices 0-31 exactly once
    (the session ledger: 32 tokens and 31 gaps), every token in range,
    each replica launched the flash forward on every layer of each plain
    prefill and no other kernel, the prefix trie is hit.  Then an open
    loop of ``SERVE_OPEN_LOOP`` over ``Server.generate``.  Returns the
    replicas' summed launches."""
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    export_dir = os.path.join(tmp, "lm_bf16")
    ckpt.export_model(export_dir, params, metadata={"config": FULL})
    del params
    torch.cuda.empty_cache()
    jobs = serving_jobs(cfg)
    srv = _decode_server(export_dir, None, cfg, dev, engine, 32)
    httpd = serve_http(srv, port=0, block=False)
    try:
        base = "http://%s:%d" % httpd.server_address

        def post(job):
            t = time.perf_counter()
            out = _http_json(base + "/v1/generate",
                             {"prompt": job[1], "max_tokens": 32})
            out["client_ms"] = 1e3 * (time.perf_counter() - t)
            return out

        def burst(jobs):
            t0 = time.perf_counter()
            outs = _concurrently(post, jobs)
            wall = time.perf_counter() - t0
            for (sid, _), out in zip(jobs, outs):
                _session_gate(sid, out, 32, cfg.vocab_size)
            return outs, wall

        cold, cold_wall = burst(serving_jobs(cfg, seed=1))
        outs, wall = burst(jobs)
        stats_http = _http_json(base + "/stats")
        reps = srv.summary(include_replicas=True)["replica_stats"]
        _serve_launch_gate(reps, cfg)
        hits = sum(r["decode"]["prefix_hits"] for r in reps.values())
        if hits < 1:
            raise AssertionError(f"no prefix hit: {reps}")
        def session(i):
            out = srv.generate(jobs[i % len(jobs)][1], max_tokens=32)
            return dict(ttft_ms=out["ttft_ms"], token_ms=out["token_ms"],
                        tokens=len(out["tokens"]))

        loop = run_open_loop(
            session,
            rate_rps=SERVE_OPEN_LOOP["rate_rps"],
            n_requests=SERVE_OPEN_LOOP["sessions"], seed=0,
            shed_exc=serving.Overloaded)
        if loop["completed"] != SERVE_OPEN_LOOP["sessions"]:
            raise AssertionError(f"open loop: {loop}")
    finally:
        httpd.shutdown()
        srv.stop()
    ttft = [o["ttft_ms"] for o in outs]
    gaps = [g for o in outs for g in o["token_ms"]]
    cold_ttft = [o["ttft_ms"] for o in cold]
    cold_gaps = [g for o in cold for g in o["token_ms"]]
    # each session's own time in the pool (submit to its last token):
    # the wall beyond the longest is the front end's and the clients'
    total = [o["total_ms"] for o in outs]
    cold_total = [o["total_ms"] for o in cold]
    client = [o["client_ms"] for o in outs]
    launches = _replica_launches(reps)
    summary = dict(
        sessions=len(jobs), tokens=32 * len(jobs), transport="http",
        ttft_p50_ms=_percentile(ttft, 50), ttft_p99_ms=_percentile(ttft, 99),
        tok_p50_ms=_percentile(gaps, 50), tok_p99_ms=_percentile(gaps, 99),
        tokens_per_s=32 * len(jobs) / wall, wall_s=wall,
        session_total_p50_ms=_percentile(total, 50),
        session_total_max_ms=max(total),
        client_p50_ms=_percentile(client, 50), client_max_ms=max(client),
        cold=dict(ttft_p50_ms=_percentile(cold_ttft, 50),
                  ttft_p99_ms=_percentile(cold_ttft, 99),
                  tok_p50_ms=_percentile(cold_gaps, 50),
                  tok_p99_ms=_percentile(cold_gaps, 99),
                  tokens_per_s=32 * len(cold) / cold_wall,
                  wall_s=cold_wall,
                  session_total_p50_ms=_percentile(cold_total, 50),
                  session_total_max_ms=max(cold_total)),
        pool_boot_s=srv.pool.boot_s,
        replicas={idx: dict(
            pid=r["pid"], peak_mem_bytes=r.get("peak_mem_bytes"),
            mem_bytes=r.get("mem_bytes"), graphs=r["decode"]["graphs"],
            capture_ms=r["decode"]["capture_ms"],
            launches=r["launches"], prefills=r["decode"]["prefills"],
            extends=r["decode"]["extends"],
            prefix_hits=r["decode"]["prefix_hits"],
            iterations=r["decode"]["iterations"])
            for idx, r in sorted(reps.items())},
        stats=stats_http, open_loop=dict(loop, **SERVE_OPEN_LOOP),
        contexts="two replica processes share the one card", gpu=gpu)
    print("serve_decode " + json.dumps(summary), flush=True)
    return launches, srv.pool.replica_pids()


def phase_serve_f32(dev, gpu, engine, tmp):
    """``serve_exact``, ``serve_failover`` and ``serve_reload`` on one
    2-replica float32 pool (seed 1) with a ``ckpt_dir``.  Returns the
    replicas' pids, the respawned one's included."""
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    export_dir = os.path.join(tmp, "lm_f32")
    ckpt_dir = os.path.join(tmp, "lm_f32_ckpt")
    ckpt.export_model(export_dir, params, metadata={"config": FULL})
    ref_attn = lambda q, k, v: attention.mha_reference(q, k, v, causal=True)
    rng = np.random.default_rng(1)
    exact = [rng.integers(1, cfg.vocab_size, size=n).tolist()
             for n in (40, 300, 1100)]
    srv = _decode_server(export_dir, ckpt_dir, cfg, dev, engine, 16)
    pids = set(srv.pool.replica_pids().values())
    httpd = serve_http(srv, port=0, block=False)
    try:
        base = "http://%s:%d" % httpd.server_address
        # serve_exact: greedy tokens equal the full-recompute reference
        outs = _concurrently(lambda p: srv.generate(p, max_tokens=16),
                             exact)
        refs = [T.greedy_decode_reference(params, p, cfg, max_tokens=16,
                                          attn_fn=ref_attn) for p in exact]
        for p, out, ref in zip(exact, outs, refs):
            if out["tokens"] != ref:
                raise AssertionError(f"{len(p)}-token prompt: served "
                                     f"{out['tokens']} != reference {ref}")
        http = _concurrently(lambda p: _http_json(
            base + "/v1/generate", {"prompt": p, "max_tokens": 16}),
            exact[:2])
        if [o["tokens"] for o in http] != refs[:2]:
            raise AssertionError(f"HTTP {[o['tokens'] for o in http]} != "
                                 f"{refs[:2]}")
        print("serve_exact " + json.dumps(dict(
            prompts=[len(p) for p in exact], tokens=16, http_pair=2,
            replicas=sorted({o["replica"] for o in outs}), gpu=gpu)),
            flush=True)
        del params
        torch.cuda.empty_cache()

        # serve_failover: 8 sessions in flight, one replica SIGKILLed
        prompts = [rng.integers(1, cfg.vocab_size, size=n).tolist()
                   for n in rng.integers(64, 1024, size=8)]
        want = _concurrently(lambda p: srv.generate(p, max_tokens=16),
                             prompts)
        replayed0 = srv.pool.replayed_tokens
        respawns0 = srv.pool.respawns_observed
        victim = 0
        table = srv.pool._table

        def streaming_on_victim():
            for key in table.owned_by({victim}):
                entry = table.get(key)
                if entry is not None and entry["session"].tokens_so_far():
                    return True
            return False

        got = [None] * len(prompts)
        errors = []

        def one(i):
            try:
                got[i] = srv.generate(prompts[i], max_tokens=16)
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        deadline = time.monotonic() + 300
        while not streaming_on_victim():
            if time.monotonic() > deadline or not any(
                    t.is_alive() for t in threads):
                raise AssertionError("no session streamed on the victim")
            time.sleep(0.002)
        victim_pid = srv.pool.replica_pids()[victim]
        t_kill = time.monotonic()
        os.kill(victim_pid, 9)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        for i, (w, g) in enumerate(zip(want, got)):
            _session_gate(f"failover {i}", g, 16, cfg.vocab_size)
            if g["tokens"] != w["tokens"]:
                raise AssertionError(f"session {i}: {g['tokens']} after "
                                     f"the kill, {w['tokens']} without")
        deadline = time.monotonic() + 300
        while srv.pool.respawns_observed <= respawns0 or \
                srv.pool.live_replicas() != [0, 1]:
            if time.monotonic() > deadline:
                raise AssertionError(
                    f"no respawn: live {srv.pool.live_replicas()}, "
                    f"respawns {srv.pool.respawns_observed}")
            time.sleep(0.05)
        back = srv.pool.up_times[victim][-1] - t_kill
        pids |= set(srv.pool.replica_pids().values())
        print("serve_failover " + json.dumps(dict(
            sessions=len(prompts), victim=victim, victim_pid=victim_pid,
            respawns_observed=srv.pool.respawns_observed,
            replayed_tokens_dropped=srv.pool.replayed_tokens - replayed0,
            live_replicas=srv.pool.live_replicas(),
            respawn_to_up_s=back, gpu=gpu)), flush=True)

        # serve_reload: a step-2 checkpoint of other params.  The
        # 300-token prompt first, on both replicas: its bucket's graph is
        # captured before the reload, which refills the graphs in place
        # (the trie is dropped, so after it the prompt prefills again)
        prompt = exact[1]
        pre = _concurrently(lambda p: srv.generate(p, max_tokens=16),
                            [prompt, prompt])
        if [o["tokens"] for o in pre] != [refs[1], refs[1]]:
            raise AssertionError(f"before the reload {pre[0]['tokens']}, "
                                 f"{pre[1]['tokens']} != {refs[1]}")
        before = srv.summary(include_replicas=True)["replica_stats"]
        new = T.init(cfg, torch.Generator(device=dev).manual_seed(2), dev)
        t_save = time.monotonic()
        ckpt.save_checkpoint(ckpt_dir, new, step=2)
        saved_s = time.monotonic() - t_save
        limit = float(os.environ[SERVE_RELOAD_ENV]) + SERVE_RELOAD_SLACK_S
        t0 = time.monotonic()
        while srv.pool.versions() != {0: 2, 1: 2}:
            if time.monotonic() - t0 > limit:
                raise AssertionError(f"versions {srv.pool.versions()} "
                                     f"{limit} s after the save")
            time.sleep(0.05)
        reload_s = time.monotonic() - t0
        ref = T.greedy_decode_reference(new, prompt, cfg, max_tokens=16,
                                        attn_fn=ref_attn)
        outs = _concurrently(lambda p: srv.generate(p, max_tokens=16),
                             [prompt, prompt])
        if [o["tokens"] for o in outs] != [ref, ref]:
            raise AssertionError(f"after the reload {outs[0]['tokens']}, "
                                 f"{outs[1]['tokens']} != {ref}")
        reps = srv.summary(include_replicas=True)["replica_stats"]
        graphs = {i: (before[i]["decode"]["graphs"], r["decode"]["graphs"])
                  for i, r in sorted(reps.items())}
        served = {o["replica"] for o in pre}
        if {o["replica"] for o in outs} - served:
            raise AssertionError(f"after the reload replicas "
                                 f"{[o['replica'] for o in outs]} served, "
                                 f"before it {sorted(served)}")
        for i, r in reps.items():
            _graph_gate(f"replica {i}", r["decode"])
            if graphs[i][0] > graphs[i][1] or (
                    i in served and not graphs[i][0]):
                raise AssertionError(f"replica {i}'s graphs before and "
                                     f"after the reload: {graphs[i]}")
        print("serve_reload " + json.dumps(dict(
            step=2, save_s=saved_s, versions_2_after_s=reload_s,
            limit_s=limit, tokens=16,
            engine_reloads={i: r["decode"]["reloads"]
                            for i, r in sorted(reps.items())},
            graphs_before_after=graphs, gpu=gpu)), flush=True)
        del new
        torch.cuda.empty_cache()
    finally:
        httpd.shutdown()
        srv.stop()
    return pids


def phase_serve_predict(dev, gpu, cluster, export_dir):
    """``serve_predict``: ``TFCluster.serve`` of phase 17's MNIST export
    on phase 17's cluster, after its shutdown; 64 single-image ``POST
    /v1/predict`` requests at once equal ``mnist.predict`` here on the
    same export (float32, TF32 off, 1e-5 of the largest logit), with at
    most log2(max_batch)+1 signatures a replica.  Returns the replicas'
    pids."""
    images = mnist_data_setup.synthetic_mnist(64)[0]
    params, _ = ckpt.load_exported(export_dir)
    deterministic = _exact_float32()
    try:
        want = mnist.predict(params, {"image": images}, device=dev)["logits"]
    finally:
        torch.backends.cudnn.deterministic = deterministic
    t0 = time.perf_counter()
    srv = cluster.serve(export_dir=export_dir, device=str(dev),
                        request_timeout=600)
    boot = time.perf_counter() - t0
    httpd = serve_http(srv, port=0, block=False)
    try:
        base = "http://%s:%d" % httpd.server_address
        t0 = time.perf_counter()
        outs = _concurrently(lambda x: _http_json(
            base + "/v1/predict", {"inputs": {"image": x.tolist()}}),
            list(images))
        wall = time.perf_counter() - t0
        summ = srv.summary(include_replicas=True)
        pids = set(srv.pool.replica_pids().values())
    finally:
        httpd.shutdown()
        srv.stop()
    got = np.asarray([o["outputs"]["logits"] for o in outs], np.float32)
    err = float(np.abs(got - want).max() / np.abs(want).max())
    cap = int(np.log2(srv.batcher.max_batch)) + 1
    summary = dict(
        requests=len(images), transport="http", rel_err=err,
        same_argmax=bool((got.argmax(-1) == want.argmax(-1)).all()),
        boot_s=boot, wall_s=wall, p50_ms=summ["p50_ms"],
        p99_ms=summ["p99_ms"], batches=summ["batches"],
        mean_device_batch=summ["mean_device_batch"],
        buckets=summ["buckets"],
        signatures={i: len(r["compiles"])
                    for i, r in sorted(summ["replica_stats"].items())},
        signature_cap=cap,
        graphs={i: dict(graphs=r["graphs"], capture_ms=r["capture_ms"],
                        eager_signatures=r["eager_signatures"],
                        compiles=sorted(r["compiles"].values()))
                for i, r in sorted(summ["replica_stats"].items())},
        gpu=gpu)
    print("serve_predict " + json.dumps(summary), flush=True)
    if err > SERVE_PREDICT_RTOL or not summary["same_argmax"]:
        raise AssertionError(f"served logits off by {err} of the largest")
    if any(n > cap for n in summary["signatures"].values()):
        raise AssertionError(f"signatures {summary['signatures']} > {cap}")
    # one captured graph a bucket: each signature compiled once, as a
    # graph, and none served eagerly
    for i, g in summary["graphs"].items():
        if g["eager_signatures"] or set(g["compiles"]) - {1} or \
                g["graphs"] != len(g["compiles"]):
            raise AssertionError(f"replica {i}'s graphs: {g}")
    if not sum(g["graphs"] for g in summary["graphs"].values()):
        raise AssertionError("no replica captured a graph")
    return pids


def check_serve_cleanup(pids):
    """After every pool and its engine stopped: no replica process, no
    ``/dev/shm/tfos-*`` ring and no child-pid file in the working dir."""
    alive = sorted(p for p in pids if _alive(p))
    rings = glob.glob("/dev/shm/tfos-*")
    pidfile = os.path.exists(os.path.join(os.getcwd(), "tfos_child_pids"))
    print("serve_cleanup " + json.dumps(dict(
        replica_pids=sorted(pids), alive=alive, shm=rings,
        cwd_child_pid_file=pidfile)), flush=True)
    if alive or rings or pidfile:
        raise AssertionError(f"left behind: pids {alive}, rings {rings}, "
                             f"child-pid file {pidfile}")


# -- the Spark ML pipeline and SPARK-mode inference ---------------------------

def tf32_off_predict(params, inputs, device=None):
    """``mnist.predict`` with float32 kept float32 in the executor (TF32
    off, deterministic cuDNN), as this process computes its reference:
    the transform's ``signature_def_key`` names it."""
    _exact_float32()
    return mnist.predict(params, inputs, device=device)


# the transform converts the export's params once a cache entry through
# the predict's module's ``params_from_jax``: this module's predict is
# MNIST's
params_from_jax = mnist.params_from_jax


def tf32_off_infer(args, ctx):
    """``mnist_pipeline.infer_fun`` with float32 kept float32 in the
    trainer."""
    _exact_float32()
    mnist_pipeline.infer_fun(args, ctx)


def tf32_off_parallel_infer(args, ctx):
    """``mnist_inference.infer_fun`` with float32 kept float32 in the
    worker."""
    _exact_float32()
    return mnist_inference.infer_fun(args, ctx)


def _mnist_mfu(rows_per_s):
    """MFU of float32 MNIST predicts at ``rows_per_s`` end to end: the
    forward's FLOPs a row (``metrics.mnist_inference_flops_per_row``,
    8,482,304 as the JAX counter gives) over float32's dense peak."""
    return (rows_per_s * metrics.mnist_inference_flops_per_row()
            / PEAK_FLOPS[torch.float32])


def executor_launches(it):
    """A ``map_partitions`` function: the kernels' launches in this
    executor since it started."""
    list(it)
    return [ops.launch_counts()]


def _sum_launches(*counts):
    return {k: sum(c[k] for c in counts) for k in counts[0]}


def _reference_logits(params, images, dev, chunk=4096):
    """``mnist.predict`` on the card in this process (float32, TF32
    off), ``chunk`` images at a time."""
    deterministic = _exact_float32()
    try:
        tensors = mnist.params_from_jax(params, device=dev)
        return np.concatenate([
            mnist.predict(tensors, {"x": images[i:i + chunk]})["logits"]
            for i in range(0, len(images), chunk)])
    finally:
        torch.backends.cudnn.deterministic = deterministic


def _logit_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def phase_pipeline_fit(dev, gpu, engine_fit, engine_pred, tmp):
    """``pipeline_fit``: ``TFEstimator(mnist_pipeline.train_fun)`` fit
    SPARK-fed with ``num_gpus=1`` on ``engine_fit`` (one executor, which
    never touches CUDA), then ``TFModel.transform`` of 30,000 seeded
    MNIST-shaped rows at batch 1,024 on ``engine_pred`` (two executors,
    each of which then holds a CUDA context), twice: cold, then with the
    cached model.  Gates: every loss finite; every row back once, in
    order; the logits equal ``mnist.predict`` on the export here
    (float32, TF32 off, ``PIPELINE_RTOL`` of the largest logit); the
    cache loaded once an executor; a SPARK-mode cluster on
    ``engine_pred`` refused.  Returns the export dir, the rows' images,
    their reference logits and the kernels' launches."""
    cfg = PIPELINE
    fit_images, fit_labels = mnist_data_setup.synthetic_mnist(
        cfg["fit_rows"])
    rows = [{"image": img.reshape(-1), "label": int(lbl)}
            for img, lbl in zip(fit_images, fit_labels)]
    export_dir = os.path.join(tmp, "export")
    t0 = time.perf_counter()
    model = (pipeline.TFEstimator(mnist_pipeline.train_fun,
                                  {"lr": cfg["lr"], "out_dir": tmp})
             .setClusterSize(1).setEpochs(1).setBatchSize(cfg["batch_size"])
             .setExportDir(export_dir).setNumGpus(1).setGraceSecs(0)
             .setInputMapping({"image": "image", "label": "label"})
             .fit(engine_fit.parallelize(rows, cfg["fit_partitions"])))
    fit_s = time.perf_counter() - t0
    with open(os.path.join(tmp, "pipeline-rank0.json")) as f:
        report = json.load(f)
    losses = report["losses"]

    images = mnist_data_setup.synthetic_mnist(cfg["rows"], seed=1)[0] \
        .reshape(-1, 784)
    rows = [{"image": img} for img in images]
    model = (model.setInputMapping({"image": "x"}).setOutputMapping(
        {"logits": "logits", "prediction": "pred"})
        .setBatchSize(cfg["transform_batch"])
        .setSignatureDefKey(f"{__name__}:tf32_off_predict"))
    runs = []
    for _ in range(2):
        t0 = time.perf_counter()
        out = model.transform(
            engine_pred.parallelize(rows, cfg["partitions"])).collect()
        runs.append((time.perf_counter() - t0, out))
    stats = engine_pred.parallelize(
        range(engine_pred.num_executors), engine_pred.num_executors
    ).map_partitions(pipeline.model_cache_stats).collect(spread=True)
    exported, meta = ckpt.load_exported(export_dir)
    want = _reference_logits(exported, images, dev)
    errs = [_logit_err(np.asarray([r["logits"] for r in out], np.float32),
                       want) if len(out) == len(want) else None
            for _, out in runs]
    same_pred = [len(out) == len(want) and [r["pred"] for r in out]
                 == want.argmax(-1).tolist() for _, out in runs]
    entries = [e for s in stats for _, e in s["entries"]]
    batches = sum(e["batches"] for e in entries)
    print("pipeline_fit: a SPARK-mode cluster on the transform's engine, "
          "which must be refused (its traceback follows)", flush=True)
    try:
        TFCluster.run(engine_pred, mnist_pipeline.train_fun, {}, 1,
                      input_mode=TFCluster.InputMode.SPARK,
                      reservation_timeout=60)
        refused = None
    except RuntimeError as e:
        refused = str(e)
    summary = dict(
        fit_rows=cfg["fit_rows"], steps=len(losses),
        losses_first_last=[losses[0], losses[-1]] if losses else None,
        fit_s=fit_s, trainer_device=report["device"],
        feed_transport=report["feed"]["transport"],
        columnar=report["feed"]["columnar"], rows=cfg["rows"],
        batch=cfg["transform_batch"], partitions=cfg["partitions"],
        transform_s_cold_warm=[w for w, _ in runs],
        rows_per_s_cold_warm=[cfg["rows"] / w for w, _ in runs],
        mfu_cold_warm=[_mnist_mfu(cfg["rows"] / w) for w, _ in runs],
        mfu_peak=peak_name(torch.float32), rel_err=errs,
        same_prediction=same_pred,
        executors=[dict(pid=s["pid"], peak_mem_bytes=s["peak_mem_bytes"],
                        **{k: v for _, e in s["entries"]
                           for k, v in e.items()}) for s in stats],
        predict_ms_per_batch=(sum(e["predict_ms"] for e in entries)
                              / batches if batches else None),
        cache_loads=[e["loads"] for e in entries],
        export_predict=meta.get("predict"),
        refused_after_transform=bool(refused and "CUDA context" in refused),
        launches_trainer=report["launches"], gpu=gpu)
    print("pipeline_fit " + json.dumps(summary), flush=True)
    if not losses or not all(np.isfinite(losses)) or \
            not report["device"].startswith(dev.type):
        raise AssertionError(f"fit losses {losses} on {report['device']}")
    if any(e is None or e > PIPELINE_RTOL for e in errs) or \
            not all(same_pred):
        raise AssertionError(f"transform rows or logits off: {errs}, "
                             f"same predictions {same_pred}")
    if len(stats) != engine_pred.num_executors or \
            any(len(s["entries"]) != 1 for s in stats) or \
            summary["cache_loads"] != [1] * len(stats) or \
            sum(e["rows"] for e in entries) != 2 * cfg["rows"]:
        raise AssertionError(f"model caches {stats}")
    if not summary["refused_after_transform"]:
        raise AssertionError(f"a SPARK cluster after transform: {refused}")
    return export_dir, images, want, report["launches"]


def phase_cluster_inference(dev, gpu, engine, export_dir, images, want,
                            tmp):
    """``cluster_inference``: ``TFCluster.inference()`` of 4 partitions
    of 5,000 ``(id, image)`` rows (row j is ``pipeline_fit``'s image
    j mod 30,000) into a SPARK-mode trainer on the card
    (``mnist_pipeline.infer_fun``, ``num_gpus=1``), which predicts each
    batch and returns it through ``DataFeed.batch_results``.  Gates:
    every row's result once, in partition order, equal to
    ``pipeline_fit``'s reference.  Returns the trainer's launches."""
    cfg = PIPELINE
    n = cfg["infer_partitions"] * cfg["infer_rows"]
    rows = [(j, images[j % len(images)]) for j in range(n)]
    t0 = time.perf_counter()
    c = TFCluster.run(engine, tf32_off_infer,
                      {"export_dir": export_dir, "out_dir": tmp,
                       "batch_size": cfg["transform_batch"]},
                      num_executors=1, input_mode=TFCluster.InputMode.SPARK,
                      num_gpus=1, reservation_timeout=300)
    boot_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = c.inference(engine.parallelize(rows, cfg["infer_partitions"]),
                      feed_timeout=600).collect()
    wall = time.perf_counter() - t0
    c.shutdown()
    with open(os.path.join(tmp, "infer-rank0.json")) as f:
        report = json.load(f)
    ids_ok = [r[0] for r in out] == list(range(n))
    ref = want[np.arange(n) % len(want)]
    err = (_logit_err(np.asarray([r[2] for r in out], np.float32), ref)
           if ids_ok else None)
    summary = dict(
        rows=n, partitions=cfg["infer_partitions"], results=len(out),
        each_once_in_order=ids_ok, rel_err=err,
        same_prediction=ids_ok and [r[1] for r in out]
        == ref.argmax(-1).tolist(),
        boot_s=boot_s, wall_s=wall, rows_per_s=n / wall,
        mfu=_mnist_mfu(n / wall),
        mfu_peak=peak_name(torch.float32),
        trainer_batches=report["batches"],
        predict_ms_per_batch=report["predict_ms"] / max(report["batches"], 1),
        peak_mem_bytes=report["peak_mem_bytes"], device=report["device"],
        launches=report["launches"], gpu=gpu)
    print("cluster_inference " + json.dumps(summary), flush=True)
    if not ids_ok or err is None or err > PIPELINE_RTOL or \
            not summary["same_prediction"] or \
            not report["device"].startswith(dev.type):
        raise AssertionError(f"inference(): {len(out)} results, in order "
                             f"{ids_ok}, logits off by {err}")
    return report["launches"]


def phase_roles(dev, gpu, engine, tmp):
    """``roles``: ``examples/mnist_eval`` with a ps node, an evaluator
    and a chief on ``engine`` (four executors, ``InputMode.TENSORFLOW``):
    the chief and the worker train on the card in their executors over a
    gloo group (NCCL refuses two ranks on one card); ps and evaluator
    fork processes that see no GPU, the evaluator evaluating each
    checkpoint on the CPU; TensorBoard asked for.  Gates: the roles;
    eval lines for checkpoint steps; ``shutdown`` returns; after the
    engine stops, no role process, ring or child-pid file left.
    Returns the trainers' launches."""
    model_dir = os.path.join(tmp, "model")
    mnist_eval.reset_model_dir(model_dir)
    args = dict(ROLES, model_dir=model_dir, device=None, backend="gloo")
    t0 = time.perf_counter()
    try:
        c = TFCluster.run(
            engine, mnist_eval.main_fun, args, num_executors=4, num_ps=1,
            eval_node=True, master_node="chief",
            input_mode=TFCluster.InputMode.TENSORFLOW, tensorboard=True,
            log_dir=os.path.join(tmp, "tb"), reservation_timeout=300)
        roles = sorted(m["job_name"] for m in c.cluster_info)
        tb_url = c.tensorboard_url()
        c.shutdown(grace_secs=1)
        wall = time.perf_counter() - t0
    finally:
        engine.stop()
    with open(os.path.join(model_dir, "eval_results.jsonl")) as f:
        evals = [json.loads(ln) for ln in f]
    records = {}
    for name in ("ps-0", "evaluator-0", "chief-0", "worker-0"):
        with open(os.path.join(model_dir, f"{name}.json")) as f:
            records[name] = json.load(f)
    pids = [r["pid"] for r in records.values()]
    alive = [p for p in pids if _running(p)]
    rings = glob.glob("/dev/shm/tfos-*")
    pidfile = os.path.exists(os.path.join(os.getcwd(), "tfos_child_pids"))
    tb_found = profiler._find_tensorboard()
    summary = dict(
        roles=roles, wall_s=wall, eval_steps=[e["step"] for e in evals],
        accuracy=[e["accuracy"] for e in evals],
        trainer_devices=[records[k]["device"]
                         for k in ("chief-0", "worker-0")],
        losses_first_last={k: [records[k]["losses"][0],
                               records[k]["losses"][-1]]
                           for k in ("chief-0", "worker-0")},
        side_cuda_visible={k: records[k]["cuda_visible"]
                           for k in ("ps-0", "evaluator-0")},
        tensorboard=tb_url or ("no tensorboard binary found" if not tb_found
                               else "tensorboard did not start"),
        role_pids=pids, alive=alive, shm=rings, cwd_child_pid_file=pidfile,
        gpu=gpu)
    print("roles " + json.dumps(summary), flush=True)
    if roles != ["chief", "evaluator", "ps", "worker"] or not evals or \
            any(e["step"] % ROLES["ckpt_steps"] for e in evals) or \
            evals[-1]["step"] != ROLES["steps"]:
        raise AssertionError(f"roles {roles}, evaluations {evals}")
    if alive or rings or pidfile:
        raise AssertionError(f"left behind: pids {alive}, rings {rings}, "
                             f"child-pid file {pidfile}")
    devices = summary["trainer_devices"]
    side = summary["side_cuda_visible"]
    if any(not d.startswith(dev.type) for d in devices) or \
            any(v != "" for v in side.values()):
        raise AssertionError(f"trainers on {devices}, ps and evaluator "
                             f"saw GPUs {side}")
    return _sum_launches(records["chief-0"]["launches"],
                         records["worker-0"]["launches"])


def _running(pid):
    """True while ``pid`` runs (a zombie has exited)."""
    if not _alive(pid):
        return False
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def phase_inference_cli(dev, gpu, engine_pred, tf_tmp, tmp):
    """``inference_cli``: ``inference.run`` (the ``tfos-inference-torch``
    CLI) over phase 17's four TFRecord shards with phase 17's export, and
    ``parallel_run`` of ``examples/mnist_inference`` over the same, both
    on ``engine_pred``.  Gate: every record's prediction (and the CLI's
    logits) equal ``mnist.predict`` on those records here.  Returns the
    launches in ``engine_pred``'s executors (phase 23's transforms and
    these)."""
    tfr = os.path.join(tf_tmp, "tfr")
    export_dir = os.path.join(tf_tmp, "model", "export")
    images, labels = mnist_data_setup.synthetic_mnist(
        TF_MNIST["num_examples"])
    params, _ = ckpt.load_exported(export_dir)
    want = _reference_logits(params, images.reshape(-1, 784), dev)
    out_dir = os.path.join(tmp, "cli")
    args = inference.build_parser().parse_args([
        "--export_dir", export_dir, "--input", tfr, "--output", out_dir,
        "--input_mapping", json.dumps({"image": "x"}),
        "--output_mapping", json.dumps({"logits": "logits",
                                        "prediction": "pred"}),
        "--batch_size", str(PIPELINE["transform_batch"]),
        "--signature_def_key", f"{__name__}:tf32_off_predict"])
    t0 = time.perf_counter()
    shards = inference.run(args, source=engine_pred)
    cli_s = time.perf_counter() - t0
    # one shard a partition, one partition a part file, rows in file
    # order: each shard is held against the file block its logits match
    per = TF_MNIST["num_examples"] // TF_MNIST["partitions"]
    blocks = [want[i * per:(i + 1) * per]
              for i in range(TF_MNIST["partitions"])]
    got, cli_errs, matched, preds_ok = 0, [], [], True
    for path in shards:
        with open(path) as f:
            rows = [json.loads(line) for line in f]
        got += len(rows)
        logits = np.asarray([r["logits"] for r in rows], np.float32)
        errs = [_logit_err(logits, b) if b.shape == logits.shape
                else np.inf for b in blocks]
        best = int(np.argmin(errs))
        matched.append(best)
        cli_errs.append(float(errs[best]))
        preds_ok &= [r["pred"] for r in rows] == \
            blocks[best].argmax(-1).tolist()
    cli_err = max(cli_errs) if cli_errs and np.isfinite(max(cli_errs)) \
        else None
    cli_pred = preds_ok and got == len(want) and \
        sorted(matched) == list(range(TF_MNIST["partitions"]))

    par_dir = os.path.join(tmp, "parallel")
    t0 = time.perf_counter()
    counts = parallel_run.run(
        engine_pred, tf32_off_parallel_infer,
        {"data_dir": tfr, "export_dir": export_dir, "output": par_dir},
        num_executors=2)
    par_s = time.perf_counter() - t0
    lines = []
    for name in sorted(os.listdir(par_dir)):
        with open(os.path.join(par_dir, name)) as f:
            lines += f.read().splitlines()
    files = list(range(TF_MNIST["partitions"]))
    order = [i for w in range(2) for s in files[w::2]
             for i in range(s * per, (s + 1) * per)]
    par_ok = lines == [f"{labels[i]} {want[i].argmax()}" for i in order]
    launches = engine_pred.parallelize(
        range(engine_pred.num_executors), engine_pred.num_executors
    ).map_partitions(executor_launches).collect(spread=True)
    summary = dict(
        records=len(want), cli_shards=len(shards), cli_rows=got,
        cli_s=cli_s, cli_rows_per_s=got / cli_s,
        cli_mfu=_mnist_mfu(got / cli_s),
        mfu_peak=peak_name(torch.float32),
        cli_rel_err=cli_err,
        cli_same_predictions=cli_pred, cli_shard_files=matched,
        parallel_workers=len(counts),
        parallel_predictions=sum(counts), parallel_s=par_s,
        parallel_same_predictions=par_ok,
        executor_launches=launches, gpu=gpu)
    print("inference_cli " + json.dumps(summary), flush=True)
    if cli_err is None or cli_err > PIPELINE_RTOL or not cli_pred or \
            not par_ok or sum(counts) != len(want):
        raise AssertionError(f"CLI logits off by {cli_err}, predictions "
                             f"{cli_pred}; parallel_run {par_ok}")
    return _sum_launches(*launches)


# -- segmentation (BASELINE.json config 4) -----------------------------------

def _seg_group(name):
    """Kernel group of a segmentation step's device event."""
    low = name.lower()
    if "depthwise" in low or "dwconv" in low:
        return "depthwise conv"
    if "catarray" in low or "cat_" in low:
        return "concat"
    if "adam" in low:
        return "optimizer"
    return _resnet_group(name)


def _seg_batch(batch, side, num_classes, seed=0):
    """bench.py's segmentation batch: seeded ``rng.random`` images and
    ``rng.integers(0, num_classes)`` masks."""
    rng = np.random.default_rng(seed)
    images = rng.random((batch, side, side, 3), np.float32)
    masks = rng.integers(0, num_classes, (batch, side, side)).astype(
        np.int32)
    return images, masks


def _seg_net(dev, num_classes, width, seed=0):
    params, state = segmentation.init(
        torch.Generator(device=dev).manual_seed(seed),
        num_classes=num_classes, width=width, device=dev)
    leaves = [p.requires_grad_() for p in segmentation.param_leaves(params)]
    step = segmentation.make_train_step(torch.optim.Adam(leaves,
                                                         lr=SEG["lr"]))
    return params, state, step


def phase_segmentation(dev, gpu):
    """The MobileNetV2-UNet in process at the JAX bench lane's shape, in
    float32 (the lane's dtype, TF32 off) and in bf16 (the images cast,
    f32 master params and BN statistics): warm-up and timed Adam steps on
    one seeded batch (ms a step by CUDA events, images/s, MFU against the
    dtype's dense peak, peak memory), then one profiled step (device time
    by group and the idle share of its wall).  Returns the kernels'
    launches over the phase (all must be 0)."""
    fwd = metrics.segmentation_flops_per_image(SEG["image"],
                                               SEG["num_classes"],
                                               SEG["width"])
    if fwd != SEG_FWD_FLOPS:
        raise AssertionError(f"segmentation forward FLOPs {fwd}, the JAX "
                             f"counter's {SEG_FWD_FLOPS}")
    images_np, masks_np = _seg_batch(SEG["batch"], SEG["image"],
                                     SEG["num_classes"])
    masks = torch.from_numpy(masks_np).to(dev)
    b = SEG["batch"]
    _reset_counts()
    norm.launches = 0
    for name, dtype in (("float32", torch.float32),
                        ("bfloat16", torch.bfloat16)):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        params, state, step = _seg_net(dev, SEG["num_classes"], SEG["width"])
        images = torch.from_numpy(images_np).to(dev).to(dtype)
        losses, step_ms = [], []
        for _ in range(SEG_WARMUP + SEG_STEPS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            loss, state = step(params, state, images, masks)
            end.record()
            losses.append(loss.item())  # waits for the step
            end.synchronize()
            step_ms.append(start.elapsed_time(end))
        peak_mem = torch.cuda.max_memory_allocated(dev) / 1e9
        timed = step_ms[SEG_WARMUP:]
        med = statistics.median(timed)
        ips = b / (med / 1e3)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            step(params, state, images, masks)
            torch.cuda.synchronize()
            pwall = time.perf_counter() - t0
        row = dict(
            dtype=name, batch=b, image=SEG["image"],
            num_classes=SEG["num_classes"], width=SEG["width"],
            params=sum(p.numel() for p in
                       segmentation.param_leaves(params)),
            warmup_steps=SEG_WARMUP, losses=losses, step_ms=step_ms,
            step_ms_median=med, step_ms_mean=statistics.mean(timed),
            images_per_s=ips, fwd_flops_per_image=fwd,
            train_flops_per_image=3 * fwd,
            mfu=3 * fwd * ips / PEAK_FLOPS[dtype],
            mfu_peak=peak_name(dtype),
            peak_mem_gb=peak_mem, cudnn_benchmark=torch.backends.cudnn
            .benchmark, profile=device_breakdown(prof, pwall, _seg_group,
                                                 top=12), gpu=gpu)
        print("segmentation " + json.dumps(row), flush=True)
        if not (all(np.isfinite(losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"segmentation {name} losses {losses}")
        del params, state, step, images, prof
    torch.cuda.empty_cache()
    launches = _counts()
    launches["rmsnorm"] = norm.launches
    return launches


class _PinnedActs:
    """The segmentation model's activations with pinned branches: the
    first run records where each ReLU6 input passes (0 < x < 6) and where
    it saturates high (x >= 6), and where each ReLU input is above or at
    0; the second run takes the same branches, counting where its own
    would differ (as ``_PinnedBranches`` does for ResNet).  The values
    and gradients are relu6's and relu's (gradient 0 at both of relu6's
    boundaries, 1/2 at relu's 0), over the unfused batch norm."""

    def __init__(self):
        self.masks = []
        self.replay = False
        self.differ = 0

    def _mask(self, own):
        if not self.replay:
            self.masks.append(own.cpu())
            return own
        m = self.masks.pop(0).to(own.device)
        self.differ += int((m != own).sum())
        return m

    def bn_relu6(self, params, state, x, train=True, **kw):
        pre, ns = layers.batchnorm(params, state, x, train, fused=False)
        keep = self._mask(((pre > 0) & (pre < 6)).to(pre.dtype))
        high = self._mask((pre >= 6).to(pre.dtype))
        return pre * keep + 6.0 * high, ns

    def bn_relu(self, params, state, x, train=True, **kw):
        pre, ns = layers.batchnorm(params, state, x, train, fused=False)
        gate = (pre > 0).to(pre.dtype) + 0.5 * (pre == 0).to(pre.dtype)
        return pre * self._mask(gate), ns


def _tree_rel_errs(got, ref, floor_scale=0.0):
    """(max |got - ref| / max(max |ref leaf|, floor_scale x max |ref|
    over the tree), path) of every leaf, worst first."""
    g, r = _leaf_items(got), _leaf_items(ref)
    floor = floor_scale * max(float(t.detach().abs().max()) for _, t in r)
    out = []
    for (path, a), (_, b) in zip(g, r):
        a, b = a.detach().double().cpu(), b.detach().double().cpu()
        scale = max(float(b.abs().max()), floor, 1e-30)
        out.append((float((a - b).abs().max()) / scale, path))
    return sorted(out, reverse=True)


def phase_segmentation_exact(dev):
    """One float32 training step of the segmentation model (width 1.0, 21
    classes, TF32 off) at ``SEG_EXACT`` on the card against the same step
    on the CPU, from one seeded params tree copied to both: the loss, the
    logits, every gradient and the new BN state, the CPU taking the
    card's activation branches (``_PinnedActs``)."""
    _reset_counts()
    norm.launches = 0
    b, side = SEG_EXACT["batch"], SEG_EXACT["image"]
    images, masks = (torch.from_numpy(a) for a in _seg_batch(
        b, side, SEG["num_classes"], seed=5))
    params_np, state_np = segmentation.params_to_jax(*segmentation.init(
        torch.Generator().manual_seed(5), num_classes=SEG["num_classes"],
        width=SEG["width"]))

    def loss_fn(p, s, x, m):
        logits, ns = segmentation.apply(p, s, x, train=True)
        loss = layers.softmax_cross_entropy(
            logits.reshape(-1, logits.shape[-1]), m.reshape(-1))
        return loss, (logits, ns)

    vg = train_utils.value_and_grad(loss_fn, has_aux=True)
    saved = _exact_float32()
    pins = _PinnedActs()
    real = layers.batchnorm_relu6, layers.batchnorm_relu
    layers.batchnorm_relu6, layers.batchnorm_relu = pins.bn_relu6, \
        pins.bn_relu
    runs = {}
    try:
        for name, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            pins.replay = name == "cpu"
            p, s = segmentation.params_from_jax(params_np, state_np,
                                                device=d)
            runs[name] = vg(p, s, images.to(d), masks.to(d))
    finally:
        layers.batchnorm_relu6, layers.batchnorm_relu = real
        torch.backends.cudnn.deterministic = saved
    if pins.masks:
        raise AssertionError("the CPU run took another path than the "
                             "card's")
    ((loss, (logits, new_state)), grads), \
        ((rloss, (rlogits, rstate)), rgrads) = runs["cuda"], runs["cpu"]
    errs = dict(grads=_tree_rel_errs(grads, rgrads, SEG_ZERO_SCALE),
                state=_tree_rel_errs(new_state, rstate, SEG_ZERO_SCALE))
    worst = {k: v[0][0] for k, v in errs.items()}
    worst["loss"] = _rel_max(loss, rloss)
    worst["logits"] = _rel_max(logits, rlogits)
    print("segmentation_exact " + json.dumps(dict(
        batch=b, image=side, num_classes=SEG["num_classes"],
        width=SEG["width"], loss=loss.item(), cpu_loss=rloss.item(),
        rel_err=worst, worst_leaves={k: v[:3] for k, v in errs.items()},
        rtol=SEG_EXACT_RTOL, zero_scale=SEG_ZERO_SCALE,
        cpu_branches_pinned=pins.differ)), flush=True)
    if not all(worst[k] <= SEG_EXACT_RTOL[k] for k in SEG_EXACT_RTOL):
        raise AssertionError(f"float32 segmentation step on the card vs the "
                             f"CPU: {worst} (rtol {SEG_EXACT_RTOL})")
    return _counts() | {"rmsnorm": norm.launches}


def phase_spark_segmentation(dev, engine, gpu):
    """``examples/segmentation_spark`` SPARK-fed on ``engine`` (one
    executor, ``num_gpus=1``): the example's synthetic pets at
    ``SPARK_SEG``, one partition a step (~16.8 MB), through the node's
    shm ring as columnar chunks; the losses equal the same steps taken
    here on the same batches from the same seeded params, and the chief's
    checkpoint (JAX layout) restores through ``params_from_jax`` to this
    process's trained params.  Returns the trainer's launches."""
    b, steps, side = SPARK_SEG["batch"], SPARK_SEG["steps"], \
        SPARK_SEG["image"]
    images, masks = segmentation_example.synthetic_pets(b * steps, hw=side)
    records = list(zip(list(images), list(masks)))
    tmp = tempfile.mkdtemp(prefix="tfos_spark_seg_")
    model_dir = os.path.join(tmp, "model")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, segmentation_spark.main_fun,
            {"batch_size": b, "lr": SEG["lr"], "width": SPARK_SEG["width"],
             "model_dir": model_dir, "seed": 0, "out_dir": tmp},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        c.train(engine.parallelize(records, steps), feed_timeout=600)
        dispatch = engine.last_dispatch
        fed = c.server.fed_partitions("input")
        c.shutdown()
        t_total = time.time() - t0
        with open(os.path.join(tmp, "segmentation-rank0.json")) as f:
            report = json.load(f)
        orphan = _alive(report["pid"])
        tree, saved = ckpt.restore_latest(os.path.join(model_dir, "ckpt"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    # the same steps in this process
    params, state, step = _seg_net(dev, 3, SPARK_SEG["width"])
    ref = []
    for j in range(steps):
        x = torch.from_numpy(images[j * b:(j + 1) * b]).to(dev)
        m = torch.from_numpy(masks[j * b:(j + 1) * b]).to(dev)
        loss, state = step(params, state, x, m)
        ref.append(loss.item())
    losses = report["losses"]
    rel = [abs(a - r) / abs(r) for a, r in zip(losses, ref)]
    # the chief's checkpoint in this process: each leaf against the
    # in-process params, and the loss of both on the first batch
    restored, _ = segmentation.params_from_jax(tree, device=dev)
    ckpt_diff = max(
        (float((a - b.detach()).abs().max()), path) for (path, a), (_, b)
        in zip(_leaf_items(restored), _leaf_items(params)))
    x = torch.from_numpy(images[:b]).to(dev)
    m = torch.from_numpy(masks[:b]).to(dev)
    with torch.no_grad():
        restored_loss, ref_loss = (segmentation.loss_fn(
            p, state, x, m)[0].item() for p in (restored, params))
    hwio = tree["stem"]["w"].shape == (3, 3, 3, 16) and \
        tree["head"]["w"].shape[2:] == (32, 3)
    del params, state, step, restored, x, m
    torch.cuda.empty_cache()
    tm = report["train_metrics"]
    med = statistics.median(report["step_ms"][1:])
    flops_img = 3 * metrics.segmentation_flops_per_image(
        side, 3, SPARK_SEG["width"])
    peak = PEAK_FLOPS[torch.float32]
    summary = dict(
        image=side, width=SPARK_SEG["width"], batch=b, steps=steps,
        num_classes=3, dtype="float32", losses=losses, in_process_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        # end to end: TrainMetrics over the timed steps, the trainer's
        # waits for its next batch included
        images_per_s=tm.get("items_per_sec"),
        mfu=(tm["items_per_sec"] * flops_img / peak
             if tm.get("items_per_sec") else None),
        mfu_peak=peak_name(torch.float32),
        infeed_stall_frac=tm["infeed_stall_frac"], train_metrics=tm,
        feed_wait_s=report["feed_wait_s"], step_ms=report["step_ms"],
        step_ms_median_after_first=med,
        device_step_images_per_s=b / (med / 1e3), total_s=t_total,
        records=report["records"], fed_partitions=fed,
        trainer_alive_after_shutdown=orphan,
        peak_mem_gb=report["peak_mem_gb"], checkpoint_step=saved,
        checkpoint_hwio=hwio, checkpoint_max_abs_diff=ckpt_diff,
        checkpoint_atol=SEG_CKPT_ATOL, restored_loss=restored_loss,
        in_process_params_loss=ref_loss,
        partition_mb=(images[0].nbytes + masks[0].nbytes) * b / 1e6,
        launches=report["launches"], **feed_summary(report, dispatch),
        gpu=gpu)
    print("spark_segmentation " + json.dumps(summary), flush=True)
    check_feed("spark_segmentation", summary, "shm")
    if len(losses) != steps or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"SPARK-fed segmentation losses {losses} vs "
                             f"in-process {ref} (rtol {SPARK_LOSS_RTOL})")
    if fed != list(range(steps)) or report["records"] != b * steps:
        raise AssertionError(f"fed partitions {fed}, records the trainer's "
                             f"DataFeed handed out {report['records']}")
    if orphan:
        raise AssertionError(f"trainer {report['pid']} alive after "
                             "shutdown")
    if saved != steps or not hwio or ckpt_diff[0] > SEG_CKPT_ATOL or \
            abs(restored_loss - ref_loss) > SPARK_LOSS_RTOL * abs(ref_loss):
        raise AssertionError(
            f"chief checkpoint: step {saved}, HWIO {hwio}, largest leaf "
            f"difference from the in-process params {ckpt_diff} (atol "
            f"{SEG_CKPT_ATOL}), loss {restored_loss} vs {ref_loss}")
    return report["launches"]


# -- speculative decoding (phases 30-31) --------------------------------------

SPEC_DRAFT = dict(FULL, dim=256, n_layers=2, n_heads=4)   # head_dim 64
SPEC_WINDOW = 4
# spec_exact: phase 30's traffic shape (16 sessions of 64-1536 tokens, 8
# behind a shared system prompt, 32 tokens each), every other session
# sampled
SPEC_EXACT = dict(sessions=16, max_tokens=32)


class _CountPrefills:
    """Counts the decode engine's plain prefills (target and draft, each
    a graph replay or an eager call) by config while in force (the
    draft's prefills launch the flash forward on each of its layers)."""

    def __init__(self):
        self.calls = collections.Counter()

    def __enter__(self):
        self._real = DecodeEngine._prefill
        real, calls = self._real, self.calls

        def counted(eng, key, params, cfg, toks, lens):
            calls[cfg] += 1
            return real(eng, key, params, cfg, toks, lens)

        DecodeEngine._prefill = counted
        return self

    def __exit__(self, *exc):
        DecodeEngine._prefill = self._real


def _spec_runs(dev, cfg, params, drafts, jobs, max_tokens, slots):
    """A plain run of one traffic, then one speculative run for each of
    ``drafts`` ({name: (draft params, draft config)}), window
    ``SPEC_WINDOW``.  Returns {name: (done, streamed, first, wall, stats,
    engine, launches, prefill calls)}."""
    common = dict(slots=slots, paged=True, block_size=16,
                  prefix_sharing=True, max_tokens=max_tokens)
    specs = {"plain": DecodeSpec(cfg, **common)}
    for name, (dparams, dcfg) in drafts.items():
        specs[name] = DecodeSpec(cfg, **common, draft_params=dparams,
                                 draft_cfg=dcfg, spec_window=SPEC_WINDOW)
    runs = {}
    for name, spec in specs.items():
        ops.reset_launch_counts()
        with _CountPrefills() as counter:
            out = run_engine(params, spec, jobs, dev, timeout=600)
        runs[name] = (*out, ops.launch_counts(), counter.calls)
    return runs


def _spec_gates(name, runs, jobs, cfg, run_dcfg, max_tokens):
    """Gates of one run (``run_dcfg`` its draft's config, None for the
    plain run); returns (target prefills, draft prefills)."""
    done, streamed, _, _, stats, eng, launches, calls = runs[name]
    for job in jobs:
        sid = job[0]
        if [i for i, _ in streamed[sid]] != list(range(max_tokens)):
            raise AssertionError(f"{name} {sid}: streamed indices "
                                 f"{[i for i, _ in streamed[sid]]}")
        if [t for _, t in streamed[sid]] != done[sid] or not all(
                0 <= t < cfg.vocab_size for t in done[sid]):
            raise AssertionError(f"{name} {sid}: bad tokens {done[sid]}")
    cache = eng._cache
    if cache.occupancy != 0 or cache.leaked_blocks() != []:
        raise AssertionError(f"{name}: cache not drained: occupancy "
                             f"{cache.occupancy}, leaked "
                             f"{cache.leaked_blocks()}")
    plain_prefills = stats["prefills"] - stats["extends"]
    # the draft's prefill calls: every call with its config beyond the
    # target's own plain prefills (a draft may share the target's config)
    draft_layers = run_dcfg.n_layers if run_dcfg else 0
    draft_calls = (calls[run_dcfg] - (plain_prefills if run_dcfg == cfg
                                      else 0)) if run_dcfg else 0
    want = cfg.n_layers * plain_prefills + draft_layers * draft_calls
    if launches["flash_fwd"] < want or launches["flash_fwd"] == 0 \
            or (run_dcfg and draft_calls < 1):
        raise AssertionError(
            f"{name}: flash forward launched {launches['flash_fwd']} times "
            f"for {plain_prefills} target prefills x {cfg.n_layers} layers "
            f"and {draft_calls} draft prefills x {draft_layers} layers")
    if any(launches[k] for k in ("flash_dq", "flash_dkv", "rmsnorm")):
        raise AssertionError(f"{name}: launches {launches}")
    return plain_prefills, draft_calls


def phase_spec_decode(dev, gpu):
    """``spec_decode``: phase 8's 16 sessions (32 tokens each, paged,
    prefix sharing) at full width in bf16, after an unreported warm-up
    burst, through three engines: plain,
    a narrow draft (``SPEC_DRAFT``, window 4), and the target as its own
    draft.  Gates: contiguous streams of valid tokens, drained caches,
    the flash forward on every layer of each target and draft prefill.
    Reported: tokens/s, TTFT, iterations, accept rate, launches, and the
    share of sessions whose tokens equal the plain run's (bf16 rounding
    differs with the verify window's shape, so that share is reported,
    not gated; ``spec_exact`` gates equality in float32).  Returns the
    three runs' summed launches."""
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    dcfg = T.Config(**SPEC_DRAFT, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    dparams = T.init(dcfg, torch.Generator(device=dev).manual_seed(5), dev)
    drafts = {"draft": (dparams, dcfg), "self_draft": (params, cfg)}
    jobs = serving_jobs(cfg)
    # a first plain burst of another seed's mix, not reported: the
    # process's first full-width decode pays cuBLAS and allocator warm-up
    run_engine(params, DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                                  prefix_sharing=True, max_tokens=32),
               serving_jobs(cfg, seed=1), dev, timeout=600)
    runs = _spec_runs(dev, cfg, params, drafts, jobs, 32, 8)
    plain = runs["plain"][0]
    summary, total = {}, collections.Counter()
    for name, run in runs.items():
        done, _, first, wall, stats, _, launches, _ = run
        prefills, draft_calls = _spec_gates(
            name, runs, jobs, cfg, drafts.get(name, (None, None))[1], 32)
        total.update(launches)
        ttft = sorted(first.values())
        summary[name] = dict(
            tokens_per_s=32 * len(jobs) / wall, wall_s=wall,
            ttft_p50_ms=1e3 * float(np.percentile(ttft, 50)),
            ttft_p99_ms=1e3 * float(np.percentile(ttft, 99)),
            iterations=stats["iterations"], target_prefills=prefills,
            draft_prefills=draft_calls,
            spec_accept_rate=stats.get("spec_accept_rate"),
            spec_proposed=stats.get("spec_proposed"),
            spec_accepted=stats.get("spec_accepted"),
            flash_launches=launches["flash_fwd"],
            sessions_equal_plain=sum(done[s] == plain[s] for s, _ in jobs)
            / len(jobs))
    print("spec_decode " + json.dumps(dict(
        sessions=len(jobs), tokens=32 * len(jobs), window=SPEC_WINDOW,
        draft=SPEC_DRAFT, runs=summary,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 1e9, gpu=gpu)),
        flush=True)
    del params, dparams, drafts, runs
    torch.cuda.empty_cache()
    return dict(total)


def _top2_gap(params, cfg, prompt, tokens, index):
    """The plain run's top-2 logit gap at generated ``index``."""
    with torch.inference_mode():
        logits = T.apply(params, [prompt + tokens[:index]], cfg)[0, -1]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def _even_head_draft(params):
    """The target with its head's odd-token columns zeroed: the same
    hidden states, so it proposes the target's greedy token exactly when
    that token is even (an odd token's logit is 0, below the target's
    positive maximum).  Its proposals are accepted in part, and rejected
    ones leave stale draft K/V past the rolled-back cursor."""
    head = params["head"].clone()
    head[:, 1::2] = 0
    return dict(params, head=head)


def phase_spec_exact(dev):
    """``spec_exact``: in float32 (TF32 off) at full width on phase 30's
    traffic shape (``SPEC_EXACT``), greedy and seeded sampling, a plain
    run and three drafts: the narrow ``SPEC_DRAFT`` (accepts nothing),
    the target itself (accepts everything) and the even-head draft
    (accepts in part).  Every speculative stream equals the plain one;
    the self draft's accept rate is 1.0 and the even-head draft's lies
    strictly between 0 and 1.  A divergence raises with its index and the
    plain run's top-2 logit gap there."""
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    dcfg = T.Config(**SPEC_DRAFT, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(1), dev)
    dparams = T.init(dcfg, torch.Generator(device=dev).manual_seed(6), dev)
    drafts = {"draft": (dparams, dcfg), "self_draft": (params, cfg),
              "even_head_draft": (_even_head_draft(params), cfg)}
    from tensorflowonspark_tpu_torch.serving.decode import sampling

    jobs = []
    for i, (sid, prompt) in enumerate(serving_jobs(cfg, seed=2)):
        kw = ({"sampling": sampling.make(temperature=0.8, top_k=40,
                                         seed=10 + i)} if i % 2 else {})
        jobs.append((sid, prompt, kw))
    jobs = jobs[:SPEC_EXACT["sessions"]]
    n = SPEC_EXACT["max_tokens"]
    runs = _spec_runs(dev, cfg, params, drafts, jobs, n, len(jobs))
    plain = runs["plain"][0]
    for name, (_, run_dcfg) in drafts.items():
        _spec_gates(name, runs, jobs, cfg, run_dcfg, n)
        done = runs[name][0]
        for sid, prompt, _ in jobs:
            if done[sid] != plain[sid]:
                i = next(j for j, (a, b) in enumerate(zip(done[sid],
                                                          plain[sid]))
                         if a != b)
                raise AssertionError(
                    f"spec_exact {name} {sid}: tokens diverge at index {i}"
                    f" (plain top-2 logit gap "
                    f"{_top2_gap(params, cfg, prompt, plain[sid], i)})")
    rates = {k: runs[k][4]["spec_accept_rate"] for k in drafts}
    if rates["self_draft"] != 1.0 or \
            not 0.0 < rates["even_head_draft"] < 1.0:
        raise AssertionError(f"spec_exact accept rates {rates}: want 1.0 "
                             f"for the self draft, strictly between 0 and "
                             f"1 for the even-head draft")
    print("spec_exact " + json.dumps(dict(
        sessions=len(jobs), tokens=n, sampled=len(jobs) // 2,
        accept_rate=rates,
        proposed={k: runs[k][4]["spec_proposed"] for k in drafts},
        accepted={k: runs[k][4]["spec_accepted"] for k in drafts},
        iterations={k: runs[k][4]["iterations"] for k in runs})),
        flush=True)
    del params, dparams, drafts, runs
    torch.cuda.empty_cache()


# serve_graphs: for each (dtype, seed), one engine stepping in CUDA graphs
# (jit=None) and one eager (jit=False) on the same params, run one after
# the other; the reload's params are seed 2's
SERVE_GRAPHS = dict(dtypes=(("bfloat16", 0), ("float32", 1)), reload_seed=2,
                    tokens=32, exact_tokens=16)


def _same_shapes(jobs, cfg, seed):
    """``jobs``' prompts (:func:`serving_jobs`) with fresh tokens of the
    same lengths, the sessions that share a system prompt sharing a new
    one: the same bucket signatures as ``jobs``, none of their
    prefixes."""
    rng = np.random.default_rng(seed)
    system = rng.integers(1, cfg.vocab_size, size=512).tolist()
    out = []
    for i, (sid, prompt) in enumerate(jobs):
        shared = i % 2 == 0
        tail = rng.integers(1, cfg.vocab_size,
                            size=len(prompt) - 512 * shared).tolist()
        out.append((f"{sid}-{seed}", system + tail if shared else tail))
    return out


class _Burster:
    """A started decode engine on the card driven in bursts.  A burst's
    sessions are submitted under the engine's queue lock (made
    re-entrant here), so one admission sees all of them and the bucket
    grouping is the same in every run: with 8 slots, 16 sessions of
    equal length admit in two waves of 8.  Keeps each session's tokens
    and token times."""

    def __init__(self, params, spec, dev, jit):
        self.lock = threading.Lock()
        self.done, self.errors, self.times = {}, {}, {}
        self.eng = DecodeEngine(params, spec, self._emit, device=dev,
                                jit=jit)
        self.eng._qlock = threading.RLock()
        self.eng.start(timeout=600)

    def _emit(self, kind, sid, *rest):
        now = time.perf_counter()
        with self.lock:
            if kind == "token":
                self.times.setdefault(sid, []).append(now)
            elif kind == "done":
                self.done[sid] = [int(t) for t in rest[0]]
            else:
                self.errors[sid] = rest[0]

    def submit(self, jobs, max_tokens):
        with self.eng._qlock:
            t0 = time.perf_counter()
            for sid, prompt in jobs:
                self.eng.submit(sid, prompt, max_tokens=max_tokens)
        return t0

    def wait(self, jobs, table, timeout=600):
        """Until every session of ``jobs`` is in ``table`` (``done``, or
        ``times``: its first token came)."""
        deadline = time.monotonic() + timeout
        while True:
            with self.lock:
                if self.errors:
                    raise AssertionError(f"engine errors {self.errors}")
                if all(sid in table for sid, _ in jobs):
                    return
            if time.monotonic() > deadline:
                raise AssertionError(f"sessions not done within {timeout} s")
            time.sleep(0.002)

    def burst(self, jobs, max_tokens):
        """One burst to its end: its tokens, wall, tokens/s, TTFT and
        token gaps."""
        t0 = self.submit(jobs, max_tokens)
        self.wait(jobs, self.done)
        wall = time.perf_counter() - t0
        with self.lock:
            ttft = [1e3 * (self.times[s][0] - t0) for s, _ in jobs]
            gaps = [1e3 * (b - a) for s, _ in jobs
                    for a, b in zip(self.times[s], self.times[s][1:])]
            tokens = {s: self.done[s] for s, _ in jobs}
        return dict(tokens=tokens, wall_s=wall,
                    tokens_per_s=max_tokens * len(jobs) / wall,
                    ttft_p50_ms=_percentile(ttft, 50),
                    ttft_p99_ms=_percentile(ttft, 99),
                    gap_p50_ms=_percentile(gaps, 50),
                    gap_p99_ms=_percentile(gaps, 99))


def _graphs_engine_run(dev, cfg, params, new_params, jit, jobs, exact):
    """One engine (``jit``) through serve_graphs' bursts: phase 8's
    sessions (cold: the captures), the same shapes with fresh tokens
    (timed), again under the profiler (the device's idle share), the
    float32 exact prompts, and a third burst whose second wave follows a
    ``set_params`` issued while the first streams."""
    c = SERVE_GRAPHS
    n = c["tokens"]
    gc.collect()   # the previous engine's graphs, freed before the base
    torch.cuda.reset_peak_memory_stats(dev)
    base_mem = torch.cuda.memory_allocated(dev)
    b = _Burster(params, DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                                    prefix_sharing=True, max_tokens=n),
                 dev, jit)
    try:
        out = {"cold": b.burst(jobs, n)}
        st = b.eng.stats()
        out["after_captures"] = dict(
            graphs=st["graphs"], capture_ms=st["capture_ms"],
            eager_signatures=st["eager_signatures"],
            memory_allocated_bytes=torch.cuda.memory_allocated(dev) - base_mem,
            max_memory_allocated_bytes=(torch.cuda.max_memory_allocated(dev)
                                        - base_mem))
        out["warm"] = b.burst(_same_shapes(jobs, cfg, 1), n)
        # the device's activity alone: the idle share reads nothing else,
        # and the host's ops would triple the trace to sort
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            profiled = b.burst(_same_shapes(jobs, cfg, 2), n)
        bd = device_breakdown(prof, profiled["wall_s"])
        out["profiled"] = dict(
            wall_s=profiled["wall_s"], idle_share=bd["idle_share"],
            device_busy_ms=bd["device_busy_ms"],
            device_events=bd["device_events"], groups_ms=bd["groups_ms"])
        if exact:
            got = b.burst(exact, c["exact_tokens"])
            out["exact"] = got["tokens"]
        # the reload: wave 1 (8 sessions) fills the slots; set_params
        # while it streams; wave 2 is admitted after the swap, all 8 at
        # once, so its tokens are the new params' alone
        third = _same_shapes(jobs, cfg, 3)
        b.submit(third[:8], n)
        b.wait(third[:8], b.times)
        b.eng.set_params(new_params)
        out["reload"] = b.burst(third[8:], n)
        b.wait(third[:8], b.done)
        st = b.eng.stats()
    finally:
        b.eng.stop()
    if st["reloads"] != 1:
        raise AssertionError(f"reloads {st['reloads']}")
    out["stats"] = {k: st[k] for k in (
        "graphs", "capture_ms", "eager_signatures", "prefills", "extends",
        "iterations", "prefix_hits", "reloads")}
    return out


def _spec_graphs(dev, cfg, params, jobs):
    """The speculative engine of ``spec_decode`` (the narrow draft,
    window ``SPEC_WINDOW``), graphed and eager: tokens, accept counts."""
    dcfg = T.Config(**SPEC_DRAFT, dtype="bfloat16", attn_impl="flash")
    dparams = T.init(dcfg, torch.Generator(device=dev).manual_seed(5), dev)
    spec = DecodeSpec(cfg, slots=8, paged=True, block_size=16,
                      prefix_sharing=True, max_tokens=SERVE_GRAPHS["tokens"],
                      draft_params=dparams, draft_cfg=dcfg,
                      spec_window=SPEC_WINDOW)
    runs = {}
    for mode, jit in (("graphed", None), ("eager", False)):
        b = _Burster(params, spec, dev, jit)
        try:
            run = b.burst(jobs, SERVE_GRAPHS["tokens"])
            st = b.eng.stats()
        finally:
            b.eng.stop()
        runs[mode] = dict(run, **{k: st[k] for k in (
            "graphs", "capture_ms", "eager_signatures", "spec_proposed",
            "spec_accepted", "prefills", "extends")})
    g, e = runs["graphed"], runs["eager"]
    if g["tokens"] != e["tokens"] or \
            (g["spec_proposed"], g["spec_accepted"]) != \
            (e["spec_proposed"], e["spec_accepted"]):
        bad = [s for s in g["tokens"] if g["tokens"][s] != e["tokens"][s]]
        raise AssertionError(
            f"speculative graphed != eager: sessions {bad}, accepted "
            f"{g['spec_accepted']}/{g['spec_proposed']} against "
            f"{e['spec_accepted']}/{e['spec_proposed']}")
    _graph_gate("speculative engine", g)
    del dparams
    return runs


def phase_serve_graphs(dev, gpu):
    """``serve_graphs``: the decode engine's CUDA graphs at full width.
    For bf16 (seed 0) and float32 (seed 1), an engine stepping in graphs
    and one with ``jit=False`` on the same params, one after the other,
    each through :func:`_graphs_engine_run`'s bursts.  Gates: graphed
    tokens equal eager ones session by session in every burst and dtype;
    in float32 the exact prompts equal ``greedy_decode_reference``; after
    the reload the second wave's tokens are equal too (the graphs refilled
    in place, none recaptured for a seen bucket); the graphed engine has
    no eager signature and its flash launches cover every plain prefill's
    layers (replays counted, captures not); the speculative engine,
    graphed and eager, gives equal tokens and accept counts.  Prints per
    engine and dtype tokens/s, TTFT and gap p50/p99, graphs, capture ms,
    memory after the captures and the profiled burst's idle share.
    Returns the phase's launches."""
    c = SERVE_GRAPHS
    ref_attn = lambda q, k, v: attention.mha_reference(q, k, v, causal=True)
    ops.reset_launch_counts()
    for dtype, seed in c["dtypes"]:
        cfg = T.Config(**FULL, dtype=dtype, attn_impl="flash")
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(seed),
                        dev)
        new = T.init(cfg, torch.Generator(device=dev).manual_seed(
            c["reload_seed"]), dev)
        jobs = serving_jobs(cfg)
        exact = None
        if dtype == "float32":
            rng = np.random.default_rng(1)
            exact = [(f"x{n}", rng.integers(1, cfg.vocab_size,
                                            size=n).tolist())
                     for n in (40, 300, 1100)]
        runs, launches = {}, {}
        for mode, jit in (("graphed", None), ("eager", False)):
            before = ops.launch_counts()
            runs[mode] = _graphs_engine_run(dev, cfg, params, new, jit, jobs,
                                            exact)
            after = ops.launch_counts()
            launches[mode] = {k: after[k] - before[k] for k in after}
        g, e = runs["graphed"], runs["eager"]
        for burst in ("cold", "warm", "reload"):
            diff = [s for s in g[burst]["tokens"]
                    if g[burst]["tokens"][s] != e[burst]["tokens"][s]]
            if diff:
                raise AssertionError(f"{dtype} {burst}: graphed tokens != "
                                     f"eager in sessions {diff}")
        if exact:
            for sid, prompt in exact:
                ref = T.greedy_decode_reference(
                    params, prompt, cfg, max_tokens=c["exact_tokens"],
                    attn_fn=ref_attn)
                if g["exact"][sid] != ref or e["exact"][sid] != ref:
                    raise AssertionError(
                        f"{sid}: graphed {g['exact'][sid]}, eager "
                        f"{e['exact'][sid]}, reference {ref}")
        _graph_gate(f"{dtype} graphed engine", g["stats"])
        if g["stats"]["graphs"] < g["after_captures"]["graphs"]:
            raise AssertionError(f"{dtype}: the reload dropped graphs "
                                 f"({g['after_captures']['graphs']} -> "
                                 f"{g['stats']['graphs']})")
        if e["stats"]["graphs"]:
            raise AssertionError(f"the jit=False engine captured "
                                 f"{e['stats']['graphs']} graphs")
        for mode, run in runs.items():
            plain = run["stats"]["prefills"] - run["stats"]["extends"]
            got = launches[mode]
            if got["flash_fwd"] < cfg.n_layers * plain or any(
                    got[k] for k in ("flash_dq", "flash_dkv", "rmsnorm")):
                raise AssertionError(f"{dtype} {mode}: launches {got} for "
                                     f"{plain} plain prefills")
        summary = {}
        for mode, run in runs.items():
            summary[mode] = dict(
                {b: {k: v for k, v in run[b].items() if k != "tokens"}
                 for b in ("cold", "warm", "reload")},
                after_captures=run["after_captures"],
                profiled=run["profiled"], stats=run["stats"],
                launches=launches[mode])
        print("serve_graphs " + json.dumps(dict(
            dtype=dtype, seed=seed, sessions=len(jobs), tokens=c["tokens"],
            equal_bursts=["cold", "warm", "reload"]
            + (["exact"] if exact else []),
            runs=summary, gpu=gpu)), flush=True)
        if dtype == "bfloat16":
            spec = _spec_graphs(dev, cfg, params, jobs)
            print("serve_graphs spec " + json.dumps(dict(
                window=SPEC_WINDOW, draft=SPEC_DRAFT,
                runs={m: {k: v for k, v in r.items() if k != "tokens"}
                      for m, r in spec.items()}, gpu=gpu)), flush=True)
        del params, new
        torch.cuda.empty_cache()
    return ops.launch_counts()


# -- the parallel layer at world size 1 (phase 32) and the dry run (33) -------

PARALLEL_REPS = 3
# (a)'s per-leaf gradient bounds against the plain step, relative to the
# leaf's largest entry
PARALLEL_GRAD_RTOL = 1e-6
PARALLEL_EMBED_GRAD_RTOL = 1e-2
RING_SHAPE = (8, 2048, 8, 128)
RING_ATOL = 2e-5
MOE = dict(dim=1024, hidden=4096, experts=8, batch=8, seq=2048)
MOE_RTOL = dict(out=2e-2, grads=5e-2)
PIPE = dict(dim=1024, batch=64, micro=4)
DRYRUN_RANKS = 8


def _step_ms(fn, reps=PARALLEL_REPS):
    """Median wall time of ``fn()`` ending in a synchronize, after one
    warm-up call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def _rel_norm(got, ref):
    ref = ref.float()
    return float((got.float() - ref).norm() / ref.norm().clamp(min=1e-30))


def _parallel_transformer(dev, gpu):
    """(a): the FULL transformer, bf16, one Adam step through the mesh's
    sharded step (all axes 1, the ``param_specs`` plan, Ulysses over the
    flash kernels) against the plain in-process step."""
    from torch.utils import _pytree as pytree

    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    mesh = parallel.make_mesh({"data": 1, "fsdp": 1, "seq": 1, "model": 1},
                              device_type="cuda")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (TRAIN_BATCH, cfg.max_seq))).to(dev)
    leaves = _param_leaves(params)
    placed = T.shard_params(params, mesh, T.param_specs(cfg, mesh=mesh))
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3)
    popt = torch.optim.Adam(pytree.tree_leaves(placed), lr=1e-3)
    attn_fn = parallel.sequence_parallel_attention(
        mesh, "ulysses", causal=True, attn_fn=ops.flash_attention)
    sharded_vg = T.mesh_value_and_grad(cfg, mesh, attn_fn=attn_fn)

    # one forward and backward each on the same params and batch; every
    # kernel's count zeroed just before the sharded step and read after
    ops.reset_launch_counts()
    loss = T.loss_fn(params, tokens, cfg)
    loss.backward()
    plain_loss = loss.item()
    plain_counts = ops.launch_counts()
    ops.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats(dev)
    wrapped_loss = float(sharded_vg(placed, tokens))
    counts = ops.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    want = dict(flash_fwd=cfg.n_layers, flash_dq=cfg.n_layers,
                flash_dkv=cfg.n_layers, rmsnorm=0)
    if counts != want or plain_counts != want:
        raise AssertionError(f"parallel step launches {counts}, plain "
                             f"{plain_counts}, want {want}")
    grads = T.mesh_params(pytree.tree_map(lambda p: p.grad, placed),
                          tuple(mesh.mesh_dim_names))
    grad_err = {}
    for path, g in ckpt._flatten_leaves(grads):
        ref = dict(ckpt._flatten_leaves(
            pytree.tree_map(lambda p: p.grad, params)))[path]
        grad_err[path] = float((g - ref).abs().max()
                               / ref.abs().max().clamp(min=1e-30))
    gnorm = torch.sqrt(sum((g.float() ** 2).sum()
                           for g in pytree.tree_leaves(grads))).item()
    pnorm = _grad_norm(leaves)
    # the train phase's tolerances: the loss to 1e-6, the gradient norm
    # to 1e-2 (bf16 embedding gradients are summed with atomics)
    if abs(wrapped_loss - plain_loss) > 1e-6 * abs(plain_loss) or \
            abs(gnorm - pnorm) > 1e-2 * pnorm:
        raise AssertionError(f"parallel step loss {wrapped_loss} grad norm "
                             f"{gnorm} vs plain {plain_loss} {pnorm}")
    # and each leaf on its own, so a wrong or missing gradient of a small
    # leaf (an ln scale, one of wqkv's q/k/v blocks) cannot hide in the
    # norm: at world 1 both steps run the same kernels on the same
    # tensors, so every leaf but the embedding is held bitwise (1e-6 of
    # its largest entry, below one bf16 step), the embedding to the
    # norm's 1e-2 (its gradient's atomics)
    bad = {path: err for path, err in grad_err.items()
           if err > (PARALLEL_EMBED_GRAD_RTOL if path == "embed"
                     else PARALLEL_GRAD_RTOL)}
    if bad:
        raise AssertionError(f"parallel step gradients off the plain "
                             f"step's: {bad}")
    opt.step()
    popt.step()
    opt.zero_grad(set_to_none=True)
    popt.zero_grad(set_to_none=True)

    def plain_step():
        T.loss_fn(params, tokens, cfg).backward()
        opt.step()
        opt.zero_grad(set_to_none=True)

    def wrapped_step():
        sharded_vg(placed, tokens)
        popt.step()
        popt.zero_grad(set_to_none=True)

    plain_ms = _step_ms(plain_step)
    wrapped_ms = _step_ms(wrapped_step)
    out = dict(loss=wrapped_loss, plain_loss=plain_loss, grad_norm=gnorm,
               plain_grad_norm=pnorm, worst_grad_rel_err=max(
                   grad_err.values()), launches=counts,
               step_ms=wrapped_ms, plain_step_ms=plain_ms,
               wrapper_cost_ms=wrapped_ms - plain_ms, peak_mem_gb=peak_gb,
               mesh=dict(data=1, fsdp=1, seq=1, model=1), gpu=gpu)
    del params, placed, opt, popt, grads, leaves
    torch.cuda.empty_cache()
    return out, counts


def _parallel_rings(dev):
    """(b): ring and zigzag attention over the one-rank seq group against
    ``mha_reference`` at ``RING_SHAPE``, float32 causal."""
    mesh = parallel.make_mesh({"seq": 1}, device_type="cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    q, k, v = (torch.randn(RING_SHAPE, generator=gen, device=dev)
               for _ in range(3))
    ref = attention.mha_reference(q, k, v, causal=True)
    out = {}
    for impl in ("ring", "zigzag"):
        fn = parallel.sequence_parallel_attention(mesh, impl, causal=True)
        perm = (parallel.zigzag_permutation(RING_SHAPE[1], 1).to(dev)
                if impl == "zigzag" else torch.arange(RING_SHAPE[1],
                                                      device=dev))
        inv = parallel.inverse_permutation(perm.cpu()).to(dev)
        got = fn(q[:, perm], k[:, perm], v[:, perm])[:, inv]
        err = float((got - ref).abs().max())
        if err > RING_ATOL:
            raise AssertionError(f"{impl} attention err {err} > {RING_ATOL}")
        out[impl] = dict(max_abs_err=err, ms=time_ms(
            lambda: fn(q, k, v), 3, queued=False))
    del q, k, v, ref
    torch.cuda.empty_cache()
    return out


def _parallel_moe(dev):
    """(c): ``moe.apply`` at the FULL MLP width over 8 x 2048 tokens, bf16
    forward and backward against its own float32 run from the same
    (bf16-valued) params and input: the router's float32 logits of those
    values route every token alike in both runs."""
    from tensorflowonspark_tpu_torch.models import moe

    gen = torch.Generator(device=dev).manual_seed(4)
    p32 = moe.init(gen, MOE["dim"], MOE["hidden"], MOE["experts"],
                   device=dev)
    p32 = {k: v.to(torch.bfloat16).float() for k, v in p32.items()}
    x32 = torch.randn((MOE["batch"], MOE["seq"], MOE["dim"]), generator=gen,
                      device=dev).to(torch.bfloat16).float()
    runs = {}
    for dt in (torch.float32, torch.bfloat16):
        p = {k: v.clone().requires_grad_() for k, v in p32.items()}
        x = x32.to(dt)
        t0 = time.perf_counter()
        y, aux = moe.apply(p, x)
        ((y.float() ** 2).mean() + aux).backward()
        torch.cuda.synchronize()
        runs[dt] = (y.detach(), aux.detach(), {k: v.grad for k, v in
                                               p.items()},
                    1e3 * (time.perf_counter() - t0))
    (y32, a32, g32, ms32), (y16, a16, g16, ms16) = (
        runs[torch.float32], runs[torch.bfloat16])
    out_err = _rel_norm(y16, y32)
    grad_err = {k: _rel_norm(g16[k], g32[k]) for k in g32}
    if out_err > MOE_RTOL["out"] or \
            max(grad_err.values()) > MOE_RTOL["grads"] or \
            not torch.isfinite(y16).all():
        raise AssertionError(f"moe bf16 vs float32: out {out_err}, "
                             f"grads {grad_err}")
    res = dict(tokens=MOE["batch"] * MOE["seq"], out_rel_err=out_err,
               grad_rel_err=grad_err,
        aux=[float(a16), float(a32)], bf16_fwd_bwd_ms=ms16,
        f32_fwd_bwd_ms=ms32)
    del runs, p32, x32
    torch.cuda.empty_cache()
    return res


def _parallel_pipeline(dev):
    """(d): ``pipeline_apply`` on a one-stage pp group, 4 microbatches,
    against the stage applied to the whole batch (float32)."""
    mesh = parallel.make_mesh({"pp": 1}, device_type="cuda")
    gen = torch.Generator(device=dev).manual_seed(5)
    d = PIPE["dim"]
    stage = {"w": torch.randn((d, d), generator=gen, device=dev) / d ** 0.5,
             "b": torch.randn((d,), generator=gen, device=dev)}
    x = torch.randn((PIPE["batch"], d), generator=gen, device=dev)

    def stage_fn(p, h):
        return torch.tanh(h @ p["w"] + p["b"])

    stacked = parallel.stack_stage_params([stage])
    placed = parallel.apply_shardings(
        stacked, parallel.stage_sharding(mesh, stacked))
    got = parallel.pipeline_apply(stage_fn, placed, x, mesh=mesh,
                                  n_microbatches=PIPE["micro"])
    err = float((got - stage_fn(stage, x)).abs().max())
    if err > 1e-5:
        raise AssertionError(f"pipeline_apply err {err}")
    return dict(max_abs_err=err, microbatches=PIPE["micro"])


def _parallel_one_rank(dev, gpu):
    a, counts = _parallel_transformer(dev, gpu)
    b = _parallel_rings(dev)
    c = _parallel_moe(dev)
    d = _parallel_pipeline(dev)
    return dict(transformer=a, rings=b, moe=c, pipeline=d), counts


def phase_parallel_one_rank(dev, gpu):
    """``parallel_one_rank``: a one-rank NCCL group in this process (made
    and destroyed around the phase), the parallel layer on the card at
    full width: (a) the transformer's sharded step (Ulysses over the
    flash kernels, the ``param_specs`` plan) against the plain step,
    (b) ring and zigzag attention against ``mha_reference``, (c) MoE bf16
    against float32, (d) the pipeline against its sequential stage.
    Returns (a)'s launches."""
    from tensorflowonspark_tpu_torch.parallel.launch import run_ranks

    out, counts = run_ranks(1, _parallel_one_rank, dev, gpu,
                            backend="nccl")[0]
    print("parallel_one_rank " + json.dumps(out), flush=True)
    return counts


def phase_dryrun_multichip(gpu, beside=()):
    """``dryrun_multichip``: the port's dry run on ``DRYRUN_RANKS`` gloo
    CPU ranks of this host, its four lines (the elastic shrink to half
    the ranks at accumulation 2 the second) and its wall time, taken
    while the phases named in ``beside`` run (``measured_beside``)."""
    from tensorflowonspark_tpu_torch.parallel import dryrun

    t0 = time.perf_counter()
    lines = dryrun.dryrun_multichip(DRYRUN_RANKS)
    n = DRYRUN_RANKS
    shrink = (f"dryrun_multichip({n}) elastic: {n} virtual -> {n // 2} "
              "devices accum=2 ")
    if len(lines) != 4 or not all(line.endswith(" OK") for line in lines) \
            or not lines[1].startswith(shrink):
        raise AssertionError(f"dryrun_multichip: {lines}")
    print("dryrun_multichip " + json.dumps(dict(
        ranks=n, backend="gloo", torch=torch.__version__,
        elastic=lines[1], wall_s=time.perf_counter() - t0,
        measured_beside=list(beside), host_cpus=os.cpu_count(),
        gpu=gpu)), flush=True)


# phases 34-35: supervised recovery and the elastic shrink at full width.
# A trainer pops a partition only when its prefetch (2 staged batches and
# 1 in hand) has room, and a feeder starts the next partition only once
# the last one was popped; so when a feeder starts partition j, its
# trainer has finished at least j - 4 steps (one more is taken and
# waiting), and the chief's saves of them are done.
# 34: one executor, 6 partitions of one step (8 records) each; the plan
# SIGKILLs the executor at its 6th put (the last partition), when the
# trainer has saved at least step 1 (at the 4th put it had finished none
# on the H100).  The respawned executor counts its puts from
# 0 and re-feeds 1 partition, so the plan cannot fire again.  The chief
# saves params and Adam's state every step; keep enough saves that the
# one the recovery restored is still there for the replay.
RECOVER = dict(partitions=6, records=8, kill_put=6, keep=10)
# 35: two executors, no respawn budget, min_executors=1; a logical data
# axis of 2 and a global batch of 8 (4 records a partition, a rank's
# share at world 2, half a step at world 1).  Executor 1 dies at its 7th
# put: its trainer has finished 2 steps, and the second's exchange
# waited for the chief's save of the first, so epoch 0 logged steps on
# both ranks; its partitions 8 and later (at least 2) are left for the
# survivor's accum-2 steps.
ELASTIC = dict(partitions=16, records=4, data=2, kill_put=7, keep=10)
# 35a: the layout's accum-2 gradient against the flat one, float32,
# batch 2 at full width and 2 layers
ELASTIC_EXACT = dict(n_layers=2, batch=2, rel=1e-5)


def _proc_alive(pid):
    """True for a live process that is not a zombie (a trainer orphaned
    by its executor's death is reparented and may linger as one)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except OSError:
        return False


def _rings_left(c):
    """The cluster's feed rings still in ``/dev/shm``, any epoch."""
    return glob.glob(f"/dev/shm/tfos-{c.cluster_meta['id'] & 0xffffffff:x}"
                     "*")


def _steps_log(out_dir, executor):
    path = os.path.join(out_dir, f"steps-exec{executor}.jsonl")
    with open(path) as f:
        return [json.loads(line) for line in f]


def _events(tdir, name):
    """Telemetry records named ``name`` under ``tdir``, by time, each
    once: the drained ``run-<id>/`` directories hold copies of the
    spools and of the driver's file, and are skipped."""
    out = []
    for path in glob.glob(os.path.join(tdir, "**", "*.jsonl"),
                          recursive=True):
        rel = os.path.relpath(path, tdir).split(os.sep)
        if any(part.startswith("run-") for part in rel[:-1]):
            continue
        with open(path) as f:
            out += [r for r in map(json.loads, f) if r["name"] == name]
    return sorted(out, key=lambda r: r["ts"])


def _keyed_rows(tokens):
    k = transformer_spark.ROW_KEY_TOKENS
    index = {tuple(int(t) for t in row[:k]): i
             for i, row in enumerate(tokens)}
    if len(index) != len(tokens):
        raise AssertionError("token rows share their first tokens")
    return index


def _replay(dev, cfg, tokens, ckpt_dir, step, batches, data=None):
    """The losses of ``batches`` (lists of row keys) stepped in this
    process from the chief's checkpoint at ``step`` (the seeded init at
    0), through the trainer's own functions and kernels; with ``data``,
    through a one-process layout of that logical data axis."""
    index = _keyed_rows(tokens)
    if step:
        tree = ckpt.load_checkpoint(os.path.join(ckpt_dir,
                                                 f"ckpt-{step:08d}.npz"))
        params = T.params_from_jax(tree["params"], cfg, device=dev)
    else:
        params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    _, opt = transformer_spark.make_optimizer(params)
    if step:
        transformer_spark.load_train_state(tree, params, opt)
        del tree
    vg = None
    if data:
        layout = elastic.virtualize({"data": data}, [dev])
        vg = layout.value_and_grad(transformer_spark.elastic_loss(cfg))
    out = []
    for keys in batches:
        batch = torch.from_numpy(np.stack(
            [tokens[index[tuple(k)]] for k in keys]).astype(np.int64)).to(dev)
        out.append(transformer_spark.train_step(params, opt, batch, cfg,
                                                vg).item())
    del params, opt
    torch.cuda.empty_cache()
    return out


def _incarnation_gate(line, steps, per_step):
    """Each trainer's flash launches: 8 (layers) x the microbatches it
    ran, from its last step's counts; RMSNorm none."""
    if not steps:
        return dict(flash_fwd=0, flash_dq=0, flash_dkv=0, rmsnorm=0)
    got = steps[-1]["launches"]
    want = FULL["n_layers"] * per_step * len(steps)
    if any(got[k] != want for k in ("flash_fwd", "flash_dq", "flash_dkv")) \
            or got["rmsnorm"]:
        raise AssertionError(f"{line}: launches {got}, want {want} of each "
                             "flash kernel and no RMSNorm")
    return got


def phase_spark_recover(dev, engine, gpu, tdir):
    """Phase 34: the SPARK-fed transformer at full width on ``engine``, a
    one-executor engine that has never touched CUDA, with the fault plan
    of ``RECOVER`` in its env and telemetry into ``tdir``.  ``run(
    restarts=1)`` must heal: one recovery, one respawn, every partition in
    the ledger once, the epoch-1 trainer resumed at the last checkpoint
    and its losses those of an in-process replay; no epoch-0 trainer and
    no feed ring (of any epoch) left.
    Returns the two incarnations' launches, summed."""
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    n, rows = RECOVER["partitions"], RECOVER["records"]
    tokens = np.random.default_rng(34).integers(
        0, FULL["vocab_size"], (n * rows, FULL["max_seq"])).astype(np.int32)
    _keyed_rows(tokens)
    work = tempfile.mkdtemp(prefix="tfos_recover_")
    ckpt_dir = os.path.join(work, "ckpt")
    os.environ[telemetry.DIR_ENV] = tdir  # the driver's recovery events
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": dataclasses.asdict(cfg), "batch_size": rows,
             "seed": 0, "ckpt_dir": ckpt_dir, "ckpt_every": 1,
             "ckpt_keep": RECOVER["keep"], "out_dir": work},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300, restarts=1)
        c.train(engine.parallelize(list(tokens), n), feed_timeout=600)
        fed = c.server.fed_partitions("input")
        restarts, epoch = c._restarts_used, c.meta["epoch"]
        c.shutdown()
        rings = _rings_left(c)
        total_s = time.time() - t0
        telemetry.flush()
        log = _steps_log(work, 0)
        starts = [r for r in log if r["event"] == "start"]
        e0 = [r for r in log if r["event"] == "step" and r["epoch"] == 0]
        e1 = [r for r in log if r["event"] == "step" and r["epoch"] == 1]
        resumed = starts[-1]["resumed_step"]
        saved0 = [r["step"] for r in e0 if r["save_ms"] is not None]
        want = _replay(dev, cfg, tokens, ckpt_dir, resumed,
                       [r["rows"] for r in e1])
        free = shutil.disk_usage(work).free
    finally:
        os.environ.pop(telemetry.DIR_ENV, None)
        shutil.rmtree(work, ignore_errors=True)
    kill = _events(tdir, "fault/injected")
    done = _events(tdir, "cluster/recover_done")
    # the recovery's timeline: the engine's respawn of the dead executor
    # (the feed job saw it die), the feed job's failure once the lost
    # tasks' retries were spent, the recovered cluster
    marks = {name: _events(tdir, name)
             for name in ("engine/executor_respawn", "cluster/recover_begin")}
    timeline = ({name: ev[0]["ts"] - kill[0]["ts"]
                 for name, ev in marks.items() if ev} if kill else {})
    got = [r["loss"] for r in e1]
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    consumed0 = n - len(e1)  # the partitions the ledger held at the kill
    summary = dict(
        restarts_used=restarts, epoch=epoch, respawns=engine._respawns,
        fed_partitions=fed, epochs=[r["epoch"] for r in starts],
        steps_epoch0=len(e0), resumed_step=resumed,
        last_logged_save_epoch0=max(saved0, default=0),
        steps_epoch1=len(e1), losses_epoch1=got, replay_losses=want,
        max_rel_loss_diff=max(rel) if rel else None,
        steps_lost=consumed0 - resumed,
        kill_to_recover_done_s=(done[0]["ts"] - kill[0]["ts"]
                                if kill and done else None),
        kill_to_event_s=timeline,
        kill_to_first_resumed_step_s=(e1[0]["wall"] - kill[0]["ts"]
                                      if kill and e1 else None),
        restore_ms=starts[-1]["restore_ms"],
        save_ms=[r["save_ms"] for r in e0 + e1 if r["save_ms"]],
        step_ms_epoch0=[r["step_ms"] for r in e0],
        step_ms_epoch1=[r["step_ms"] for r in e1],
        trainer_pids=[r["pid"] for r in starts],
        epoch0_trainer_alive=_proc_alive(starts[0]["pid"]),
        rings_left=rings, total_s=total_s, disk_free_bytes=free, gpu=gpu)
    print("spark_recover " + json.dumps(summary), flush=True)
    if restarts != 1 or epoch != 1 or engine._respawns != 1:
        raise AssertionError(f"spark_recover: {restarts} recoveries to "
                             f"epoch {epoch}, {engine._respawns} respawns; "
                             "want one of each")
    if fed != list(range(n)) or [r["epoch"] for r in starts] != [0, 1]:
        raise AssertionError(f"spark_recover: ledger {fed}, incarnations "
                             f"{[r['epoch'] for r in starts]}")
    if not kill or not done:
        raise AssertionError("spark_recover: no fault/injected or "
                             "cluster/recover_done event on disk")
    last = max(saved0, default=0)
    if resumed not in (last, last + 1) or not 1 <= resumed <= consumed0 \
            or not starts[-1]["restore_ms"]:
        raise AssertionError(f"spark_recover: resumed at step {resumed}, the "
                             f"dead trainer's last logged save {last}")
    if [r["step"] for r in e1] != list(range(resumed + 1,
                                             resumed + 1 + len(e1))) \
            or not e1 or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"spark_recover: epoch-1 losses {got} vs the "
                             f"replay {want} (rtol {SPARK_LOSS_RTOL})")
    if _proc_alive(starts[0]["pid"]) or rings:
        raise AssertionError(f"spark_recover: epoch-0 trainer "
                             f"{starts[0]['pid']} alive, rings left {rings}")
    return _sum_launches(_incarnation_gate("spark_recover epoch 0", e0, 1),
                         _incarnation_gate("spark_recover epoch 1", e1, 1))


def phase_spark_elastic(dev, engine, gpu, tdir):
    """Phase 35: two trainers on the one card (gloo, ``cuda:0``, no GPU
    claim) at full width through ``elastic_data=2``, on ``engine``, two
    executors with no respawn budget and the plan of ``ELASTIC``.
    ``run(restarts=1, min_executors=1)`` must shrink the cluster to
    ``{"worker": [0]}``: epoch 0 at world 2 with accum 1, epoch 1 at world
    1 with accum 2, every partition in the ledger once, no feed ring
    left (the dead executor's unlinked by the recovery), the first resumed
    step's loss that of an in-process accum-2 replay.  Returns the three
    trainers' launches, summed."""
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    n, rows, data = ELASTIC["partitions"], ELASTIC["records"], \
        ELASTIC["data"]
    tokens = np.random.default_rng(35).integers(
        0, FULL["vocab_size"], (n * rows, FULL["max_seq"])).astype(np.int32)
    _keyed_rows(tokens)
    work = tempfile.mkdtemp(prefix="tfos_elastic_")
    ckpt_dir = os.path.join(work, "ckpt")
    os.environ[telemetry.DIR_ENV] = tdir
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": dataclasses.asdict(cfg), "batch_size": rows * data,
             "seed": 0, "device": f"cuda:{dev.index}", "backend": "gloo",
             "elastic_data": data, "ckpt_dir": ckpt_dir, "ckpt_every": 1,
             "ckpt_keep": ELASTIC["keep"], "out_dir": work},
            num_executors=2, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=0, reservation_timeout=300, restarts=1,
            min_executors=1)
        c.train(engine.parallelize(list(tokens), n), feed_timeout=600)
        fed = c.server.fed_partitions("input")
        template, restarts = c.meta["cluster_template"], c._restarts_used
        c.shutdown()
        rings = _rings_left(c)
        total_s = time.time() - t0
        telemetry.flush()
        logs = [_steps_log(work, e) for e in (0, 1)]
        steps = [[r for r in log if r["event"] == "step"] for log in logs]
        e0 = [[r for r in st if r["epoch"] == 0] for st in steps]
        e1 = [r for r in steps[0] if r["epoch"] == 1]
        start1 = [r for r in logs[0] if r["event"] == "start"][-1]
        resumed = start1["resumed_step"]
        want = _replay(dev, cfg, tokens, ckpt_dir, resumed,
                       [e1[0]["rows"]] if e1 else [], data=data)
    finally:
        os.environ.pop(telemetry.DIR_ENV, None)
        shutil.rmtree(work, ignore_errors=True)
    resize = _events(tdir, "cluster/resize")
    rel = (abs(e1[0]["loss"] - want[0]) / abs(want[0])) if e1 else None
    summary = dict(
        restarts_used=restarts, template=template, fed_partitions=fed,
        world_accum_epoch0=sorted({(r["world"], r["accum"])
                                   for st in e0 for r in st}),
        world_accum_epoch1=sorted({(r["world"], r["accum"]) for r in e1}),
        steps_epoch0=[len(st) for st in e0], steps_epoch1=len(e1),
        resumed_step=resumed, first_resumed_loss=e1[0]["loss"] if e1
        else None, replay_loss=want[0] if want else None,
        rel_loss_diff=rel,
        step_ms_epoch0=[r["step_ms"] for r in e0[0]],
        step_ms_epoch1=[r["step_ms"] for r in e1],
        step_ms_median_epoch0=(statistics.median(r["step_ms"] for r in e0[0])
                               if e0[0] else None),
        step_ms_median_epoch1=(statistics.median(r["step_ms"] for r in e1)
                               if e1 else None),
        restore_ms=start1["restore_ms"],
        save_ms=[r["save_ms"] for r in e0[0] + e1 if r["save_ms"]],
        resize_events=len(resize), rings_left=rings, total_s=total_s,
        gpu=gpu)
    print("spark_elastic " + json.dumps(summary), flush=True)
    wa0, wa1 = summary["world_accum_epoch0"], summary["world_accum_epoch1"]
    if restarts != 1 or template != {"worker": [0]} or len(resize) != 1:
        raise AssertionError(f"spark_elastic: {restarts} recoveries, "
                             f"template {template}, {len(resize)} resizes")
    if fed != list(range(n)) or rings:
        raise AssertionError(f"spark_elastic: ledger {fed}, rings left "
                             f"{rings}")
    if not all(e0) or wa0 != [(2, 1)] or wa1 != [(1, 2)]:
        raise AssertionError(f"spark_elastic: epoch 0 at {wa0}, epoch 1 at "
                             f"{wa1} (world, accum)")
    if e1[0]["step"] != resumed + 1 or rel > SPARK_LOSS_RTOL:
        raise AssertionError(f"spark_elastic: first resumed step "
                             f"{e1[0]['step']} (resumed at {resumed}), loss "
                             f"{e1[0]['loss']} vs the replay {want} (rtol "
                             f"{SPARK_LOSS_RTOL})")
    return _sum_launches(
        _incarnation_gate("spark_elastic epoch 0 rank 0", e0[0], 1),
        _incarnation_gate("spark_elastic epoch 0 rank 1", e0[1], 1),
        _incarnation_gate("spark_elastic epoch 1", e1, data))


def phase_elastic_exact(dev):
    """Phase 35a: float32 at full width (``ELASTIC_EXACT``'s layers and
    batch), in this process at world 1: the layout's accum-2 gradient (two
    microbatches into ``.grad``) equals the flat full-batch gradient leaf
    by leaf, to ``rel`` of each leaf's largest value."""
    cfg = T.Config(**dict(FULL, n_layers=ELASTIC_EXACT["n_layers"]),
                   dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(35), dev)
    transformer_spark.make_optimizer(params)
    toks = torch.from_numpy(np.random.default_rng(35).integers(
        0, cfg.vocab_size, (ELASTIC_EXACT["batch"], cfg.max_seq))).to(dev)
    layout = elastic.virtualize({"data": ELASTIC_EXACT["batch"]}, [dev])
    loss, grads = layout.value_and_grad(
        transformer_spark.elastic_loss(cfg))(params, toks)
    grads = {k: g.clone() for k, g in ckpt._flatten_leaves(grads)}
    flat_loss, flat = train_utils.value_and_grad(
        lambda p, t: T.loss_fn(p, t, cfg))(params, toks)
    worst = {}
    for k, g in ckpt._flatten_leaves(flat):
        scale = g.abs().max().item()
        err = (grads[k] - g).abs().max().item()
        worst[k] = err / scale
        if not (torch.isfinite(grads[k]).all()
                and err <= ELASTIC_EXACT["rel"] * scale):
            raise AssertionError(f"elastic_exact: grad {k} max err {err}, "
                                 f"largest flat gradient {scale}")
    lrel = abs(loss.item() - flat_loss.item()) / abs(flat_loss.item())
    print("elastic_exact " + json.dumps(dict(
        accum_steps=layout.accum_steps, loss=loss.item(),
        flat_loss=flat_loss.item(), rel_loss_diff=lrel,
        rel_err_by_param=worst)), flush=True)
    if layout.accum_steps != 2 or lrel > ELASTIC_EXACT["rel"]:
        raise AssertionError(f"elastic_exact: accum {layout.accum_steps}, "
                             f"loss {loss.item()} vs flat {flat_loss.item()}")
    del params, grads, flat
    torch.cuda.empty_cache()


def host_line():
    """What the card's host offers the JPEG decode and remote paths:
    libjpeg's header and library, PIL and the libjpeg its wheel bundles
    (the decoder's second build route), and fsspec's version.  Reported
    only."""
    import ctypes.util
    import importlib.metadata
    import importlib.util

    headers = [d for d in ("/usr/include", "/usr/local/include")
               if os.path.exists(os.path.join(d, "jpeglib.h"))]
    try:
        fsspec = importlib.metadata.version("fsspec")
    except importlib.metadata.PackageNotFoundError:
        fsspec = None
    return dict(jpeglib_h=headers[0] if headers else None,
                libjpeg=ctypes.util.find_library("jpeg"),
                pil=importlib.util.find_spec("PIL") is not None,
                pillow_libjpeg=native_build._pillow_libjpeg(),
                fsspec=fsspec)


# 36: the observed main path.  One executor, one step a partition: 36a
# runs long enough for two /metrics scrapes, the other GETs and a 2 s
# /profilez capture while it trains.  The watcher needs ~6 s after the
# first step (on an H100 80GB HBM3 at 700 W: the /profilez round trip
# 4.56 s, the loop's mean step 110.5 ms with the capture), ~55 steps; 70
# leave a margin.  36b poisons the 4th step's loss under
# TFOS_HEALTH_ACTION=halt, its chief checkpointing every step.
OBS = dict(partitions=70, records=8, profile_ms=2000, interval=0.5)
HALT = dict(partitions=6, records=8, nan_step=4)
# the JAX package's trace merger (stdlib only), run on 36a's run dir
REPO_DIR = os.path.dirname(os.path.abspath(__file__))
TRACE_MERGE = os.path.join(REPO_DIR, "scripts", "trace_merge.py")
# the gates 36a's executor (and so its trainer) runs under; the driver
# sets TFOS_OBS_PORT=0 and TFOS_TELEMETRY_DIR for the phase itself
OBS_ENV = {"TFOS_OBS_PORT": "0", "TFOS_OBS_INTERVAL": str(OBS["interval"]),
           "TFOS_HEALTH_GRADNORM": "1"}
HALT_ENV = {"TFOS_OBS_PORT": "0", "TFOS_OBS_INTERVAL": str(OBS["interval"]),
            faults.PLAN_ENV: f"train.step:nan@{HALT['nan_step']}",
            "TFOS_HEALTH_ACTION": "halt"}


def trace_breakdown(path, classify=_transformer_group, top=8):
    """``device_breakdown``'s numbers from a Chrome trace file (a
    ``/profilez`` capture): the busy union of kernel and copy intervals
    over the capture's extent (every event's), its idle share, and time
    by kernel group."""
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if isinstance(e, dict) and e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in
              ("kernel", "gpu_memcpy", "gpu_memset")]
    spans, groups, names = [], collections.Counter(), collections.Counter()
    for e in device:
        t0, t1 = float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0))
        spans.append((t0, t1))
        name = e.get("name", "")
        groups[classify(name)] += (t1 - t0) / 1e3
        names[name[:90]] += (t1 - t0) / 1e3
    busy = _union(spans)
    lo = min(float(e["ts"]) for e in events)
    hi = max(float(e["ts"]) + float(e.get("dur", 0)) for e in events)
    kernels = [e.get("name", "") for e in device if e.get("cat") == "kernel"]
    return dict(window_ms=(hi - lo) / 1e3, device_busy_ms=busy / 1e3,
                idle_share=1.0 - busy / (hi - lo), device_events=len(spans),
                kernel_events=len(kernels),
                flash_kernels={g: sum(1 for k in kernels
                                      if classify(k) == g)
                               for g in ("flash_fwd", "flash_dq",
                                         "flash_dkv")},
                groups_ms=dict(groups.most_common()),
                top_kernels_ms=names.most_common(top))


def _http(method, url, timeout=120):
    """``(status, body)`` of one request; an HTTP error's too."""
    req = urllib.request.Request(url, data=b"" if method == "POST" else None,
                                 method=method)
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, r.read().decode("utf-8")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode("utf-8")


def _metric_sum(text, name):
    """The sum of one metric's samples in Prometheus text, or None."""
    vals = [float(line.rsplit(" ", 1)[1]) for line in text.splitlines()
            if line.startswith(name + "{") or line.startswith(name + " ")]
    return sum(vals) if vals else None


def _obs_env(tdir):
    """The driver's gates for a phase 36 run: its ObsServer and the
    drain (popped again by the caller, with the identity and trace the
    cluster pins)."""
    os.environ["TFOS_OBS_PORT"] = "0"
    os.environ["TFOS_OBS_INTERVAL"] = str(OBS["interval"])
    os.environ[telemetry.DIR_ENV] = tdir


def _obs_env_off():
    for k in ("TFOS_OBS_PORT", "TFOS_OBS_INTERVAL", telemetry.DIR_ENV,
              telemetry.NODE_ENV, telemetry.ROLE_ENV, telemetry.TRACE_ENV):
        os.environ.pop(k, None)


def _observe(c, out, errors):
    """36a's checks while the trainer runs (a thread beside train()):
    two /metrics scrapes with steps rising and the step histogram,
    /statusz naming the chief, /healthz ok, a /profilez capture and a
    /flightz dump of the trainer."""
    try:
        base = c.obs.url
        deadline = time.monotonic() + 600
        first = None
        while time.monotonic() < deadline:
            _, text = _http("GET", base + "/metrics")
            first = _metric_sum(text, "tfos_train_steps_total")
            if first:
                break
            time.sleep(0.1)
        out["scrape1_steps"] = first
        out["scrape1_step_hist"] = "tfos_train_step_ms_bucket" in text
        node = next(f"{m['job_name']}-{m['task_index']}"
                    for m in c.cluster_info)
        code, body = _http("GET", base + "/statusz")
        status = json.loads(body)
        out["statusz_code"] = code
        out["statusz_nodes"] = sorted(status.get("nodes", {}))
        out["statusz_roles"] = sorted({n.get("role") for n in
                                       status.get("nodes", {}).values()})
        code, body = _http("GET", base + "/healthz")
        out["healthz"] = [code, json.loads(body)["status"]]
        t0 = time.perf_counter()
        code, body = _http("POST", f"{base}/profilez?node={node}"
                                   f"&ms={OBS['profile_ms']}&wait_s=120")
        out["profilez_code"] = code
        out["profilez_ack"] = json.loads(body)
        out["profilez_round_trip_s"] = time.perf_counter() - t0
        code, body = _http("POST", f"{base}/flightz?node={node}&wait_s=60")
        out["flightz"] = [code, json.loads(body)]
        _, text = _http("GET", base + "/metrics")
        out["scrape2_steps"] = _metric_sum(text, "tfos_train_steps_total")
        out["scrape2_step_hist"] = "tfos_train_step_ms_bucket" in text
        out["metrics_bytes"] = len(text)
        out["grad_norm"] = _metric_sum(text, "tfos_health_grad_norm")
    except BaseException as e:  # noqa: BLE001 - raised by the phase
        errors.append(e)


def _run_obs_cluster(engine, tdir, args, records, partitions, watch=None):
    """One SPARK-fed run of the transformer on ``engine`` with the obs
    gates on in the driver; returns (the run directory the drain
    filled, the partitions fed, the shutdown's error or None, the
    watcher's checks)."""
    out, errors = {}, []
    _obs_env(tdir)
    try:
        c = TFCluster.run(engine, transformer_spark.main_fun, args,
                          num_executors=1,
                          input_mode=TFCluster.InputMode.SPARK,
                          num_gpus=1, reservation_timeout=300)
        if c.obs is None:
            raise AssertionError("obs: TFOS_OBS_PORT set and no ObsServer")
        t = None
        if watch is not None:
            t = threading.Thread(target=watch, args=(c, out, errors),
                                 daemon=True)
            t.start()
        c.train(engine.parallelize(records, partitions), feed_timeout=600)
        if t is not None:
            t.join(600)
        fed = c.server.fed_partitions("input")
        shutdown_error = None
        try:
            c.shutdown()
        except (Exception, SystemExit) as e:  # noqa: BLE001 - checked
            shutdown_error = repr(e)
        rdir = telemetry.run_dir(c.meta["id"])
        out["rings_left"] = _rings_left(c)
    finally:
        _obs_env_off()
    if errors:
        raise errors[0]
    return rdir, fed, shutdown_error, out


def phase_obs(dev, engine, gpu, tdir, spark):
    """Phase 36a: the SPARK-fed transformer at full width on ``engine``
    (one executor, started under ``OBS_ENV``) with the observability
    plane on; the checks of ``_observe`` while it trains; after
    shutdown, the run directory (the driver's, the executor's and the
    trainer's spools and the /flightz dump), read by
    ``tfos-postmortem-torch`` and ``scripts/trace_merge.py``; no ring
    left.  ``spark`` is phase 6's summary, the same path with every
    gate off (36c).  Returns the trainer's launches."""
    cfg = dict(FULL, dtype="bfloat16", attn_impl="flash")
    n, rows = OBS["partitions"], OBS["records"]
    tokens = np.random.default_rng(36).integers(
        0, FULL["vocab_size"], (rows, FULL["max_seq"])).astype(np.int32)
    records = list(tokens) * n
    out_dir = tempfile.mkdtemp(prefix="tfos_obs_")
    try:
        t0 = time.time()
        rdir, fed, shut_err, seen = _run_obs_cluster(
            engine, tdir, {"config": cfg, "batch_size": rows, "seed": 0,
                           "out_dir": out_dir},
            records, n, watch=_observe)
        total_s = time.time() - t0
        with open(os.path.join(out_dir, "transformer-rank0.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    ack = seen.get("profilez_ack") or {}
    trace = ack.get("trace")
    breakdown = trace_breakdown(trace) if trace and \
        os.path.isfile(trace) else None
    files = sorted(os.listdir(rdir)) if os.path.isdir(rdir) else []
    exec_files = [f for f in files if f.startswith("exec0-")
                  and f.endswith(".jsonl")]
    trainer_file = [f for f in exec_files
                    if f.endswith(f"-{report['pid']}.jsonl")]
    pm = subprocess.run([sys.executable, "-m",
                         "tensorflowonspark_tpu_torch.obs.postmortem",
                         "--dir", rdir, "--all"], cwd=REPO_DIR,
                        capture_output=True, text=True, timeout=120)
    summary_json = os.path.join(tdir, "trace_merge_summary.json")
    tm = subprocess.run([sys.executable, TRACE_MERGE, rdir, "--out",
                         os.path.join(tdir, "trace.json"),
                         "--summary-json", summary_json],
                        capture_output=True, text=True, timeout=300)
    merged = {}
    if tm.returncode == 0 and os.path.isfile(summary_json):
        with open(summary_json) as f:
            merged = json.load(f)
    rings = seen.pop("rings_left")
    med = statistics.median(report["step_ms"])
    summary = dict(
        steps=len(report["losses"]), fed_partitions=len(fed),
        shutdown_error=shut_err, total_s=total_s, **seen,
        capture=breakdown, run_dir_files=files,
        trainer_spool=trainer_file, executor_spools=exec_files,
        postmortem_rc=pm.returncode,
        postmortem_head=pm.stdout.splitlines()[:3],
        postmortem_err=pm.stderr[-400:],
        trace_merge_rc=tm.returncode,
        trace_merge_keys=sorted(merged)[:20],
        trace_merge_err=tm.stderr[-400:], rings_left=rings,
        step_ms_median=med, launches=report["launches"],
        train_metrics=report["train_metrics"], gpu=gpu)
    print("obs " + json.dumps(summary, default=str), flush=True)
    if breakdown is not None:
        print("obs capture " + json.dumps(dict(
            idle_share=breakdown["idle_share"],
            window_ms=breakdown["window_ms"],
            device_busy_ms=breakdown["device_busy_ms"],
            kernel_events=breakdown["kernel_events"],
            flash_kernels=breakdown["flash_kernels"], gpu=gpu)), flush=True)
    # 36c: the plane's cost, the same path with every gate off beside it:
    # the device step (CUDA events) and the loop's step (host clock,
    # one step's end to the next's), medians and means
    wall = report["step_wall_ms"]
    print("obs cost " + json.dumps(dict(
        step_ms_median_plane_on=med,
        step_ms_median_plane_off=spark["step_ms_median"],
        step_wall_ms_median_plane_on=statistics.median(wall),
        step_wall_ms_median_plane_off=spark["step_wall_ms_median"],
        step_wall_ms_mean_plane_on=statistics.fmean(wall),
        step_wall_ms_mean_plane_off=statistics.fmean(spark["step_wall_ms"]),
        step_wall_ms_max_plane_on=max(wall),
        steps_on=len(report["step_ms"]), steps_off=len(spark["step_ms"]),
        gpu=gpu)), flush=True)
    want = FULL["n_layers"] * n
    problems = []
    if shut_err is not None or len(report["losses"]) != n or \
            fed != list(range(n)):
        problems.append(f"run: {len(report['losses'])} steps, fed "
                        f"{len(fed)}, shutdown {shut_err}")
    if report["launches"] != dict(flash_fwd=want, flash_dq=want,
                                  flash_dkv=want, rmsnorm=0):
        problems.append(f"launches {report['launches']}, want {want} each "
                        "flash kernel, no RMSNorm")
    if not (seen.get("scrape1_steps") and seen.get("scrape2_steps")
            and seen["scrape2_steps"] > seen["scrape1_steps"]
            and seen.get("scrape1_step_hist")
            and seen.get("scrape2_step_hist")):
        problems.append("/metrics: steps did not rise between two scrapes "
                        "or no step histogram")
    if "worker-0" not in seen.get("statusz_nodes", ()) or \
            "worker" not in seen.get("statusz_roles", ()):
        problems.append(f"/statusz nodes {seen.get('statusz_nodes')}")
    if seen.get("healthz") != [200, "ok"]:
        problems.append(f"/healthz {seen.get('healthz')}")
    if seen.get("profilez_code") != 200 or ack.get("ok") is not True or \
            breakdown is None:
        problems.append(f"/profilez {seen.get('profilez_code')} {ack}")
    elif not all(breakdown["flash_kernels"].values()):
        problems.append(f"the capture holds flash kernels "
                        f"{breakdown['flash_kernels']}")
    if not seen.get("flightz") or seen["flightz"][0] != 200 or \
            seen["flightz"][1].get("ok") is not True:
        problems.append(f"/flightz {seen.get('flightz')}")
    if not any(f.startswith("driver-") for f in files) or \
            len(trainer_file) != 1 or len(exec_files) < 2:
        problems.append(f"run dir files {files}")
    if pm.returncode != 0 or tm.returncode != 0:
        problems.append(f"postmortem rc {pm.returncode}, trace_merge rc "
                        f"{tm.returncode}: {tm.stderr[-400:]}")
    if rings:
        problems.append(f"rings left {rings}")
    if problems:
        raise AssertionError("obs: " + "; ".join(problems))
    return report["launches"]


def phase_obs_halt(dev, engine, gpu, tdir, beside=()):
    """Phase 36b: the same path on ``engine`` (started under
    ``HALT_ENV``), the chief checkpointing every step: the NaN planned
    on the 4th step's loss halts the trainer (``HealthHalt``), its
    latest checkpoint is step 3's, the cluster shuts down with no error,
    no trainer and no ring left, and the drained run holds the
    ``health/nan`` and ``health/halt`` events.  ``total_s`` is taken
    while the phases named in ``beside`` run (``measured_beside``)."""
    cfg = dict(FULL, dtype="bfloat16", attn_impl="flash")
    n, rows = HALT["partitions"], HALT["records"]
    tokens = np.random.default_rng(37).integers(
        0, FULL["vocab_size"], (n * rows, FULL["max_seq"])).astype(np.int32)
    work = tempfile.mkdtemp(prefix="tfos_halt_")
    ckpt_dir = os.path.join(work, "ckpt")
    try:
        t0 = time.time()
        rdir, fed, shut_err, seen = _run_obs_cluster(
            engine, tdir, {"config": cfg, "batch_size": rows, "seed": 0,
                           "ckpt_dir": ckpt_dir, "ckpt_every": 1,
                           "out_dir": work}, list(tokens), n)
        total_s = time.time() - t0
        log = _steps_log(work, 0)
        latest = ckpt.latest_step(ckpt_dir)
        restored, step = ckpt.restore_latest(ckpt_dir)
        finite = all(np.isfinite(np.asarray(x)).all() for x in
                     torch.utils._pytree.tree_leaves(restored))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    events = {}
    for path in glob.glob(os.path.join(rdir, "*.jsonl")):
        with open(path) as f:
            for r in map(json.loads, f):
                events.setdefault(r["name"], r)
    trainer = [r["pid"] for r in log if r["event"] == "start"]
    alive = [p for p in trainer if _proc_alive(p)]
    steps = [r for r in log if r["event"] == "step"]
    summary = dict(
        steps_logged=[r["step"] for r in steps],
        losses=[r["loss"] for r in steps], latest_checkpoint=latest,
        restored_step=step, restored_finite=finite, fed_partitions=fed,
        shutdown_error=shut_err, trainer_alive=alive,
        halt_event=events.get("health/halt", {}).get("attrs"),
        nan_event=events.get("health/nan", {}).get("attrs"),
        rings_left=seen["rings_left"], total_s=total_s,
        measured_beside=list(beside), gpu=gpu)
    print("obs_halt " + json.dumps(summary, default=str), flush=True)
    bad = HALT["nan_step"]
    if latest != bad - 1 or step != bad - 1 or not finite or \
            shut_err is not None or alive or summary["rings_left"] or \
            summary["halt_event"] is None or summary["nan_event"] is None \
            or summary["nan_event"].get("step") != bad:
        raise AssertionError(f"obs_halt: {summary}")


def _where(it):
    list(it)
    return [int(os.environ["TFOS_EXECUTOR_INDEX"])]


def phase_engine_outside_kill(gpu, beside=()):
    """Phase 37: on the card's host, no CUDA: executor 1 of a fresh
    two-executor engine SIGKILLed from outside while it waits on its
    inbox; ``ensure_executors`` respawns it, a spread job's task 1 runs
    on it and a shared-queue job of four tasks finishes, within 60 s;
    the time from the kill to the shared job's end is the heal, taken
    while the phases named in ``beside`` run (``measured_beside``)."""
    import signal

    engine = LocalEngine(2)
    try:
        engine.parallelize(range(2), 2).map_partitions(_where) \
            .collect(spread=True)
        time.sleep(0.2)
        victim = engine._procs[1].pid
        t0 = time.perf_counter()
        os.kill(victim, signal.SIGKILL)
        engine._procs[1].join(10)
        respawned = engine.ensure_executors()
        res, errs = {}, []

        def jobs():
            try:
                res["spread"] = engine.parallelize(range(2), 2) \
                    .map_partitions(_where).collect(spread=True)
                res["shared"] = engine.parallelize(range(4), 4) \
                    .map_partitions(_where).collect()
            except BaseException as e:  # noqa: BLE001 - raised below
                errs.append(e)

        t = threading.Thread(target=jobs, daemon=True)
        t.start()
        t.join(60)
        heal_s = time.perf_counter() - t0
        summary = dict(victim=victim, respawned=respawned,
                       new_pid=engine._procs[1].pid, heal_s=heal_s,
                       measured_beside=list(beside),
                       hung=t.is_alive(), errors=[repr(e) for e in errs],
                       **res, gpu=gpu)
    finally:
        engine.stop()
    print("engine_outside_kill " + json.dumps(summary), flush=True)
    if summary["hung"] or errs or respawned != [1] or \
            res.get("spread") != [0, 1] or len(res.get("shared", ())) != 4:
        raise AssertionError(f"engine_outside_kill: {summary}")


# phases 38a-38d: the data service.  ResNet-50 from phase 14's shards
# through ``cluster.train(data.Pipeline)``: one trainer on the card and
# two data workers on a two-executor engine (the worker that serves sits
# on executor 1, off the node's executor; the other owns no trainer),
# static, dynamic with one-batch splits, and dynamic with two-batch
# splits and the serving worker SIGKILLed in its second split
SERVICE = dict(workers=2, beat_s="0.5", stale_s="5", kill_hit=4)
SERVICE_DYN_ENV = {"TFOS_OBS_PORT": "0",
                   "TFOS_OBS_INTERVAL": str(OBS["interval"]),
                   "TFOS_ACTOR_HEARTBEAT_SECS": SERVICE["beat_s"],
                   "TFOS_DATA_SPLIT_BLOCKS": "1"}
SERVICE_KILL_ENV = {"TFOS_ACTOR_HEARTBEAT_SECS": SERVICE["beat_s"],
                    "TFOS_DATA_SPLIT_BLOCKS": "2",
                    faults.PLAN_ENV:
                        f"data.split_serve:kill@{SERVICE['kill_hit']}",
                    faults.EXECUTOR_ENV: "1",
                    faults.INCARNATION_ENV: "0"}


def executor_cuda_state(it):
    """A ``map_partitions`` function: this executor's index, pid and
    whether it holds a CUDA context."""
    list(it)
    return [(int(os.environ.get("TFOS_EXECUTOR_INDEX", "-1")), os.getpid(),
             torch.cuda.is_initialized())]


def _executors_cuda(engine):
    ids = list(range(engine.num_executors))
    return engine.parallelize(ids, len(ids)).map_partitions(
        executor_cuda_state).collect(placement=ids)


def _service_pipe(files):
    """Phase 14's shards as a pipeline of 256-record blocks, decoded to
    uint8 images in the data worker."""
    from tensorflowonspark_tpu_torch import data

    return data.from_tfrecords(files, block_size=RESNET["batch"]).map(
        resnet_imagenet_spark.decode_block(RESNET["image"]))


def _shard_digests(files):
    """The digest of each shard's batch, as the trainer computes it."""
    dec = resnet_imagenet_spark.decode_block(RESNET["image"])
    out = []
    for f in files:
        col = recordio.load_columnar(f)
        block = dec({"image": col["image"][1], "label": col["label"][1]})
        out.append(resnet_imagenet_spark.batch_digest(block["image"],
                                                      block["label"]))
    return out


def _watch_statusz(c, out, errors):
    """38b's read of ``/statusz`` while the trainer runs: the first
    answer holding both the ``actors`` and the ``data`` sections."""
    try:
        deadline = time.monotonic() + 600
        while time.monotonic() < deadline and not out.get("done"):
            _, body = _http("GET", c.obs.url + "/statusz", timeout=30)
            st = json.loads(body)
            if st.get("actors") and st.get("data"):
                out["statusz"] = {"actors": st["actors"], "data": st["data"]}
                return
            time.sleep(0.25)
    except BaseException as e:  # noqa: BLE001 - raised by the phase
        errors.append(e)


def _service_resnet(engine, files, dispatch, restarts=0, watch=False):
    """ResNet-50 (``resnet_imagenet_spark.main_fun``, ``num_gpus=1``)
    fed phase 14's shards through the data service on ``engine``.
    Returns the trainer's report with what the driver saw: the ledgers,
    the split provider's status, each worker's published counters, what
    shutdown left, the executors' CUDA state and the timings."""
    from tensorflowonspark_tpu_torch.data import service, splits

    b = RESNET["batch"]
    tmp = tempfile.mkdtemp(prefix="tfos_service_")
    out, errors, t = {}, [], None
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, resnet_imagenet_spark.main_fun,
            {"batch_size": b, "lr": RESNET["lr"],
             "image_size": RESNET["image"],
             "num_classes": RESNET["num_classes"],
             "model_dir": os.path.join(tmp, "model"),
             "save_every": 10 ** 6, "seed": 0, "out_dir": tmp,
             "digests": True},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300,
            data_workers=SERVICE["workers"], data_dispatch=dispatch,
            restarts=restarts)
        t_run = time.time() - t0
        if watch:
            if c.obs is None:
                raise AssertionError("service: TFOS_OBS_PORT set and no "
                                     "ObsServer")
            t = threading.Thread(target=_watch_statusz,
                                 args=(c, out, errors), daemon=True)
            t.start()
        try:
            c.train(_service_pipe(files), feed_timeout=600)
        finally:
            out["done"] = True
        t_train = time.time() - t0
        if t is not None:
            t.join(60)
        units = c.server.fed_partitions(service.ledger_feed("input", 0))
        split_ids = sorted(splits.part_to_sid(p) for p in
                           c.server.fed_partitions(splits.split_feed(
                               "input")))
        snaps = node._get_manager(c.cluster_info, 0).obs_snapshots()
        ring = "/dev/shm" + node.feed_ring_name(c.cluster_meta["id"], 0)
        c.shutdown()
        total_s = time.time() - t0
        with open(os.path.join(tmp, "resnet_imagenet-rank0.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if errors:
        raise errors[0]
    tm = report["train_metrics"]

    def claimed(w):
        ent = (snaps.get(f"data-{w}") or {}).get("metrics", {}).get(
            "tfos_data_splits_claimed_total")
        return sum(x["value"] for x in ent["series"]) if ent else 0

    return dict(
        losses=report["losses"], images_per_s=tm.get("items_per_sec"),
        infeed_stall_frac=tm["infeed_stall_frac"],
        step_ms=report["step_ms"],
        step_ms_median_after_first=statistics.median(report["step_ms"][1:]),
        feed_wait_s=report["feed_wait_s"], records=report["records"],
        digests=report["digests"], boot_s=report["first_step_wall"] - t0,
        cluster_run_s=t_run, train_s=t_train, total_s=total_s,
        unit_ledger=units, split_ledger=[list(s) for s in split_ids],
        provider=c.data_status, restarts_used=c._restarts_used,
        claimed_per_worker=[claimed(w) for w in range(SERVICE["workers"])],
        feed_transport=report["feed"]["transport"],
        columnar=report["feed"]["columnar"],
        split_chunks=report["feed"]["split_chunks"],
        split_dup_chunks=report["feed"]["split_dup_chunks"],
        statusz=out.get("statusz"),
        trainer_alive_after_shutdown=_alive(report["pid"]),
        ring_left=os.path.exists(ring), executors_cuda=_executors_cuda(
            engine), incarnations=list(engine._incarnation),
        launches=report["launches"], peak_mem_gb=report["peak_mem_gb"])


def _service_gates(line, r, res, cover):
    """What every ResNet service phase must show: six finite losses, the
    records once, the shm ring with columnar chunks, nothing left after
    shutdown, no executor holding a CUDA context, no kernel launched."""
    losses = r["losses"]
    if len(losses) != SPARK_RESNET_STEPS or not all(
            np.isfinite(x) for x in losses):
        raise AssertionError(f"{line}: losses {losses}")
    if r["records"] != RESNET["batch"] * SPARK_RESNET_STEPS:
        raise AssertionError(f"{line}: the trainer's DataFeed handed out "
                             f"{r['records']} records")
    check_feed(line, r, "shm")
    if r["trainer_alive_after_shutdown"] or r["ring_left"]:
        raise AssertionError(f"{line}: after shutdown: trainer alive "
                             f"{r['trainer_alive_after_shutdown']}, ring "
                             f"left {r['ring_left']}")
    if any(held for _i, _pid, held in r["executors_cuda"]):
        raise AssertionError(f"{line}: an executor holds a CUDA context: "
                             f"{r['executors_cuda']}")
    if any(r["launches"].values()):
        raise AssertionError(f"{line}: the ResNet trainer launched "
                             f"{r['launches']}")
    if sorted(r["digests"]) != sorted(cover):
        raise AssertionError(f"{line}: batch digests {r['digests']} vs the "
                             f"shards' {cover}")


def phase_service_static(engine, gpu, res, tfr, files):
    """38a: ``cluster.train(data.from_tfrecords(...))`` with
    ``data_dispatch="static"``: the worker reads and decodes the shards;
    the losses equal phase 10's (``SPARK_LOSS_RTOL``) as phase 16's do,
    the one (short) unit is in the trainer's unit ledger once.  Printed
    beside ``spark_tfrecord_resnet`` (``tfr``)."""
    r = _service_resnet(engine, files, "static")
    ref = res["losses"][:SPARK_RESNET_STEPS]
    rel = [abs(a - x) / abs(x) for a, x in zip(r["losses"], ref)]
    summary = dict(r, phase_resnet_losses=ref,
                   max_rel_loss_diff=max(rel) if rel else None,
                   spark_tfrecord_resnet_images_per_s=tfr["images_per_s"],
                   spark_tfrecord_resnet_stall=tfr["infeed_stall_frac"],
                   gpu=gpu)
    print("service_static " + json.dumps(summary), flush=True)
    _service_gates("service_static", r, res, _shard_digests(files))
    if max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"service_static: losses {r['losses']} vs "
                             f"in-process {ref} (rtol {SPARK_LOSS_RTOL})")
    if r["unit_ledger"] != [0] or r["split_ledger"]:
        raise AssertionError(f"service_static: unit ledger "
                             f"{r['unit_ledger']}, split ledger "
                             f"{r['split_ledger']}")
    return r["launches"]


def _split_cover(line, r, split_blocks):
    n = SPARK_RESNET_STEPS // split_blocks
    want = {f"0.{k}": split_blocks for k in range(n)}
    if r["split_chunks"] != want:
        raise AssertionError(f"{line}: the trainer saw split chunks "
                             f"{r['split_chunks']}, want {want}")
    got = [tuple(s) for s in r["split_ledger"]]
    if got[:n] != [(0, k) for k in range(n)] or \
            any(k < n for _e, k in got[n:]):
        raise AssertionError(f"{line}: split ledger {got}")
    if not (r["provider"] or {}).get("complete"):
        raise AssertionError(f"{line}: provider {r['provider']}")


def phase_service_dynamic(engine, gpu, res, tfr, files):
    """38b: the same model with the default (dynamic) dispatch and splits
    of one batch (``TFOS_DATA_SPLIT_BLOCKS=1`` in the engine), the
    observability plane on.  Held by content, not by step: every split
    id once in ``split_feed`` and in the trainer's feed, the multiset of
    batch digests the shards', finite losses; ``/statusz`` read once
    during the run, with its ``actors`` and ``data`` sections."""
    os.environ.update({"TFOS_OBS_PORT": "0",
                       "TFOS_OBS_INTERVAL": str(OBS["interval"]),
                       "TFOS_ACTOR_HEARTBEAT_SECS": SERVICE["beat_s"],
                       "TFOS_ACTOR_HEARTBEAT_STALE": SERVICE["stale_s"]})
    try:
        r = _service_resnet(engine, files, None, watch=True)
    finally:
        for k in ("TFOS_OBS_PORT", "TFOS_OBS_INTERVAL",
                  "TFOS_ACTOR_HEARTBEAT_SECS", "TFOS_ACTOR_HEARTBEAT_STALE"):
            os.environ.pop(k, None)
    ref = res["losses"][:SPARK_RESNET_STEPS]
    rel = [abs(a - x) / abs(x) for a, x in zip(r["losses"], ref)]
    summary = dict(r, max_rel_loss_diff_phase_resnet=max(rel) if rel
                   else None,
                   spark_tfrecord_resnet_images_per_s=tfr["images_per_s"],
                   spark_tfrecord_resnet_stall=tfr["infeed_stall_frac"],
                   gpu=gpu)
    print("service_dynamic " + json.dumps(summary), flush=True)
    _service_gates("service_dynamic", r, res, _shard_digests(files))
    _split_cover("service_dynamic", r, 1)
    st = r["statusz"] or {}
    if not any(row.get("group") == "split-provider"
               for row in st.get("actors", ())) or not st.get("data"):
        raise AssertionError(f"service_dynamic: /statusz read {st}")
    if r["split_dup_chunks"] or r["provider"].get("requeued"):
        raise AssertionError(f"service_dynamic: with no fault, "
                             f"{r['split_dup_chunks']} duplicate chunks, "
                             f"provider {r['provider']}")
    return r["launches"]


def phase_service_kill(engine, gpu, res, files):
    """38c: as 38b (no plane) with splits of two batches and
    ``data.split_serve:kill@4`` on executor 1's first incarnation: the
    serving worker dies after the first chunk of its second split.  The
    engine respawns it, the provider requeues the dead incarnation's
    unrecorded splits pinned to the trainer, the trainer's DataFeed
    drops their re-served prefixes, and the job completes with every
    split once and the shards' digests, without a cluster recovery."""
    os.environ.update({"TFOS_ACTOR_HEARTBEAT_SECS": SERVICE["beat_s"],
                       "TFOS_ACTOR_HEARTBEAT_STALE": SERVICE["stale_s"]})
    try:
        r = _service_resnet(engine, files, None, restarts=1)
    finally:
        for k in ("TFOS_ACTOR_HEARTBEAT_SECS", "TFOS_ACTOR_HEARTBEAT_STALE"):
            os.environ.pop(k, None)
    summary = dict(r, kill_plan=SERVICE_KILL_ENV[faults.PLAN_ENV], gpu=gpu)
    print("service_kill " + json.dumps(summary), flush=True)
    _service_gates("service_kill", r, res, _shard_digests(files))
    _split_cover("service_kill", r, 2)
    if r["incarnations"] != [0, 1] or r["restarts_used"]:
        raise AssertionError(f"service_kill: executor incarnations "
                             f"{r['incarnations']}, cluster recoveries "
                             f"{r['restarts_used']}")
    if r["provider"].get("requeued", 0) < 1 or r["split_dup_chunks"] < 1:
        raise AssertionError(f"service_kill: requeued "
                             f"{r['provider']}, duplicate chunks dropped "
                             f"{r['split_dup_chunks']}")
    return r["launches"]


def phase_service_transformer(engine, gpu, spark):
    """38d: the full-width transformer fed phase 6's records through the
    data service (``data.from_arrays({"tokens": ...})``, static, one
    worker) on phase 6's engine: its losses equal ``spark_train``'s
    (``SPARK_LOSS_RTOL``), and the trainer launches each flash kernel 8
    times a step, counted there alone."""
    from tensorflowonspark_tpu_torch import data
    from tensorflowonspark_tpu_torch.data import service

    cfg = dict(FULL, dtype="bfloat16", attn_impl="flash")
    tokens = np.random.default_rng(0).integers(
        0, FULL["vocab_size"], (TRAIN_BATCH, FULL["max_seq"]))
    pipe = data.from_arrays(
        {"tokens": np.tile(tokens, (TRAIN_STEPS, 1)).astype(np.int32)},
        block_size=TRAIN_BATCH)
    out_dir = tempfile.mkdtemp(prefix="tfos_service_train_")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": cfg, "batch_size": TRAIN_BATCH, "seed": 0,
             "out_dir": out_dir, "field": "tokens"},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300, data_workers=1,
            data_dispatch="static")
        c.train(pipe, feed_timeout=600)
        units = c.server.fed_partitions(service.ledger_feed("input", 0))
        c.shutdown()
        total_s = time.time() - t0
        with open(os.path.join(out_dir, "transformer-rank0.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses, ref = report["losses"], spark["losses"]
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    med = statistics.median(report["step_ms"])
    summary = dict(
        losses=losses, spark_train_losses=ref,
        max_rel_loss_diff=max(rel) if rel else None,
        step_ms=report["step_ms"], step_ms_median=med,
        tokens_per_s=TRAIN_BATCH * FULL["max_seq"] / (med / 1e3),
        spark_train_tokens_per_s=spark["tokens_per_s"],
        infeed_stall_frac=report["train_metrics"]["infeed_stall_frac"],
        spark_train_infeed_stall_frac=spark["infeed_stall_frac"],
        records=report["records"], unit_ledger=units,
        feed_transport=report["feed"]["transport"],
        columnar=report["feed"]["columnar"],
        columnar_chunks=report["feed"]["columnar_chunks"],
        row_chunks=report["feed"]["row_chunks"],
        boot_s=report["first_step_wall"] - t0, total_s=total_s,
        trainer_alive_after_shutdown=_alive(report["pid"]),
        launches=report["launches"], gpu=gpu)
    print("service_transformer " + json.dumps(summary), flush=True)
    check_feed("service_transformer", summary, "shm")
    if len(losses) != TRAIN_STEPS or max(rel) > SPARK_LOSS_RTOL:
        raise AssertionError(f"service-fed losses {losses} vs spark_train "
                             f"{ref} (rtol {SPARK_LOSS_RTOL})")
    want = FULL["n_layers"] * TRAIN_STEPS
    if report["launches"] != dict(flash_fwd=want, flash_dq=want,
                                  flash_dkv=want, rmsnorm=0):
        raise AssertionError(f"service-fed trainer launches "
                             f"{report['launches']}, want {want} of each "
                             "flash kernel, no RMSNorm")
    if units != [0] or report["records"] != TRAIN_BATCH * TRAIN_STEPS or \
            summary["trainer_alive_after_shutdown"]:
        raise AssertionError(f"service_transformer: unit ledger {units}, "
                             f"records {report['records']}, trainer alive "
                             f"{summary['trainer_alive_after_shutdown']}")
    return report["launches"]


# 39: the streaming feed.  Phase 6's batch is one micro-batch of 8 token
# records; 39a streams 12 of them through train_stream, the chief
# checkpointing every 4 steps, while an EvalSidecar on an engine of its
# own evaluates each checkpoint at full width on the card (a held-out
# batch); before the micro-batch after a checkpoint, the stream waits
# until the sidecar evaluated it, so every checkpoint is evaluated, and
# the driver computes its own loss from the same checkpoint meanwhile.
# 39b streams to a fresh cluster and sends STOP from another process
# after the 4th micro-batch.
STREAM = dict(micro_batches=8, ckpt_every=4, stop_after=4, eval_seed=39)


def stream_records():
    """Phase 6's batch as 8 token records, in ``spark_train``'s order:
    one micro-batch."""
    tokens = np.random.default_rng(0).integers(
        0, FULL["vocab_size"], (TRAIN_BATCH, FULL["max_seq"]))
    return [tokens[i].astype(np.int32) for i in range(TRAIN_BATCH)]


def transformer_eval_loss(params_tree, dev):
    """The loss (bf16, the flash kernels) of a JAX-layout params tree on
    the held-out batch, and the kernels it launched in this process."""
    cfg = T.Config(**dict(FULL, dtype="bfloat16", attn_impl="flash"))
    params = T.params_from_jax(params_tree, cfg, device=dev)
    batch = torch.from_numpy(np.random.default_rng(
        STREAM["eval_seed"]).integers(
            0, FULL["vocab_size"], (TRAIN_BATCH, FULL["max_seq"]))).to(dev)
    ops.reset_launch_counts()
    with torch.no_grad():
        loss = float(T.loss_fn(params, batch, cfg))
    return loss, ops.launch_counts()


def stream_eval(tree, step):
    """The eval sidecar's ``eval_fn``, run in its executor on the card:
    the restored params' held-out loss, under this script's numerics."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    loss, launches = transformer_eval_loss(tree["params"],
                                           torch.device("cuda", 0))
    return {"loss": loss, "launches": launches, "pid": os.getpid(),
            "eval_ms": 1e3 * (time.perf_counter() - t0)}


def _evaluated(side):
    """The steps of the sidecar's ``eval/result`` events so far, read in
    the driver: an ask each poll would keep the member's mailbox busy,
    and it ticks (polls its directory) only when the mailbox idles."""
    return [p["step"] for _i, kind, p in list(side.events)
            if kind == "eval/result"]


def _checkpoint_params(ckpt_dir, step):
    """The ``params`` subtree of checkpoint ``step``, read alone (a third
    of the train state: Adam's moments stay on disk)."""
    with np.load(ckpt._path(ckpt_dir, step)) as z:
        return ckpt._unflatten({k[len("params/"):]: z[k] for k in z.files
                                if k.startswith("params/")})


def _await_eval(side, ckpt_dir, step, refs, dev, timeout=600):
    """Wait for the chief's checkpoint ``step``, compute the driver's
    loss from it (on a thread, while the sidecar evaluates the same
    checkpoint), then wait until the sidecar evaluated it; returns the
    seconds waited."""
    t0 = time.perf_counter()
    deadline = time.monotonic() + timeout
    while (ckpt.latest(ckpt_dir)[0] or 0) < step:
        if time.monotonic() > deadline:
            raise AssertionError(f"stream: no checkpoint {step} in "
                                 f"{timeout} s")
        time.sleep(0.05)
    errors = []

    def _reference():
        try:
            refs[step] = transformer_eval_loss(
                _checkpoint_params(ckpt_dir, step), dev)[0]
        except BaseException as e:  # noqa: BLE001 - raised below
            errors.append(e)

    ref = threading.Thread(target=_reference, name=f"eval-ref-{step}")
    ref.start()
    while step not in _evaluated(side):
        if time.monotonic() > deadline:
            raise AssertionError(f"eval_sidecar: step {step} not evaluated "
                                 f"in {timeout} s")
        time.sleep(0.1)
    ref.join(timeout)
    if errors or step not in refs:
        raise AssertionError(f"the driver's loss of checkpoint {step}: "
                             f"{errors}")
    return time.perf_counter() - t0


def _stream_summary(report, spark, t0):
    med = statistics.median(report["step_ms"])
    return dict(
        steps=len(report["losses"]), losses=report["losses"],
        step_ms_median=med,
        tokens_per_s=TRAIN_BATCH * FULL["max_seq"] / (med / 1e3),
        infeed_stall_frac=report["train_metrics"]["infeed_stall_frac"],
        spark_train_step_ms_median=spark["step_ms_median"],
        spark_train_tokens_per_s=spark["tokens_per_s"],
        spark_train_infeed_stall_frac=spark["infeed_stall_frac"],
        boot_s=report["first_step_wall"] - t0,
        trainer_alive_after_shutdown=_alive(report["pid"]),
        feed_transport=report["feed"]["transport"],
        launches=report["launches"])


def phase_stream_transformer(dev, engine, engine_eval, gpu, spark):
    """39a ``stream_transformer`` and ``eval_sidecar``: phase 6's
    transformer fed by ``TFCluster.train_stream`` on phase 6's engine;
    its first 5 losses equal ``spark_train``'s exactly (the same
    batches), each flash kernel launched 8 times a step, no ring left
    and no CUDA context in the feeding executor; every checkpoint
    evaluated once by the sidecar (8 launches of the flash forward an
    evaluation in its executor), each loss within ``SPARK_LOSS_RTOL`` of
    the driver's from the same checkpoint.  39b ``stream_stop``: a
    second cluster, STOPped by ``examples/stop_streaming.py`` in a
    subprocess after the 4th micro-batch: ``train_stream`` returns
    within one micro-batch, ``shutdown()`` raises nothing, the trainer
    took fewer than 12 steps.  Returns the trainers' launches (both
    runs summed) and the evaluations' (summed)."""
    from tensorflowonspark_tpu_torch import workloads
    from tensorflowonspark_tpu_torch.actors import (
        ActorSystem,
        SupervisionPolicy,
    )

    cfg = dict(FULL, dtype="bfloat16", attn_impl="flash")
    records = stream_records()
    n, every = STREAM["micro_batches"], STREAM["ckpt_every"]
    tmp = tempfile.mkdtemp(prefix="tfos_stream_")
    ckpt_dir, out_dir, out_stop = (os.path.join(tmp, d)
                                   for d in ("ckpt", "out", "out_stop"))
    for d in (ckpt_dir, out_dir, out_stop):
        os.makedirs(d)
    system = ActorSystem(1, engine=engine_eval)
    try:
        # 39a: the stream, and the sidecar watching the chief's saves
        side = system.spawn(workloads.EvalSidecar(ckpt_dir, stream_eval),
                            "eval", policy=SupervisionPolicy(tick_secs=0.2),
                            timeout=300)
        refs, waits = {}, {}

        def stream():
            for i in range(n):
                if i and i % every == 0:
                    waits[i] = _await_eval(side, ckpt_dir, i, refs, dev)
                yield engine.parallelize(records, 1)

        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": cfg, "batch_size": TRAIN_BATCH, "seed": 0,
             "out_dir": out_dir, "ckpt_dir": ckpt_dir, "ckpt_every": every,
             "ckpt_keep": n},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        c.train_stream(stream(), feed_timeout=600)
        done_after_stream = c.server.done.is_set()
        c.shutdown()
        total_s = time.time() - t0
        rings = _rings_left(c)
        executors_cuda = _executors_cuda(engine)
        with open(os.path.join(out_dir, "transformer-rank0.json")) as f:
            report = json.load(f)
        # the last checkpoint's evaluation, on a thread while 39b's
        # cluster boots
        last = {}

        def _last_eval():
            try:
                last["wait_s"] = _await_eval(side, ckpt_dir, n, refs, dev)
            except BaseException as e:  # noqa: BLE001 - raised below
                last["error"] = e

        last_eval = threading.Thread(target=_last_eval, name="eval-last")
        last_eval.start()

        # 39b: a fresh cluster, STOPped from outside
        stop = {}

        def stop_stream(host, port):
            for i in range(n):
                if i == STREAM["stop_after"]:
                    proc = subprocess.run(
                        [sys.executable, "-m",
                         "tensorflowonspark_tpu_torch.examples."
                         "stop_streaming", host, str(port)], cwd=REPO_DIR,
                        capture_output=True, text=True, timeout=120)
                    stop.update(rc=proc.returncode, out=proc.stdout.strip(),
                                err=proc.stderr[-400:],
                                t=time.perf_counter())
                stop.setdefault("pulled", []).append(i)
                yield engine.parallelize(records, 1)

        t1 = time.time()
        try:
            c2 = TFCluster.run(
                engine, transformer_spark.main_fun,
                {"config": cfg, "batch_size": TRAIN_BATCH, "seed": 0,
                 "out_dir": out_stop},
                num_executors=1, input_mode=TFCluster.InputMode.SPARK,
                num_gpus=1, reservation_timeout=300)
        finally:
            last_eval.join()
        if "error" in last:
            raise last["error"]
        waits[n] = last["wait_s"]
        evaluated = side.ask("evaluated").result(60)
        evals = [p for _i, kind, p in side.events if kind == "eval/result"]
        saved = ckpt._npz_steps(ckpt_dir)
        side_pid = side.pids()[0]
        # the member holds its executor until it stops
        system.stop()
        eval_cuda = _executors_cuda(engine_eval)
        host, port = c2.cluster_meta["server_addr"]
        c2.train_stream(stop_stream(host, port), feed_timeout=600)
        stop_to_return_s = time.perf_counter() - stop.get("t", np.nan)
        stopped = c2.server.done.is_set()
        shutdown_error = None
        try:
            c2.shutdown()
        except (Exception, SystemExit) as e:  # noqa: BLE001 - checked
            shutdown_error = repr(e)
        stop_total_s = time.time() - t1
        stop_rings = _rings_left(c2)
        with open(os.path.join(out_stop, "transformer-rank0.json")) as f:
            report2 = json.load(f)
    finally:
        system.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    ref = spark["losses"]
    summary = dict(
        micro_batches=n, **_stream_summary(report, spark, t0),
        spark_train_losses=ref, total_s=total_s, rings_left=rings,
        stop_after_stream=done_after_stream, executors_cuda=executors_cuda,
        saved_steps=saved, gpu=gpu)
    print("stream_transformer " + json.dumps(summary), flush=True)
    rel = [abs(e["metrics"]["loss"] - refs.get(e["step"], np.nan))
           / abs(refs.get(e["step"], np.nan)) for e in evals]
    eval_summary = dict(
        evaluated=evaluated, events=[e["step"] for e in evals],
        losses={e["step"]: e["metrics"]["loss"] for e in evals},
        driver_losses=refs, max_rel_loss_diff=max(rel) if rel else None,
        eval_ms=[e["metrics"]["eval_ms"] for e in evals],
        launches=[e["metrics"]["launches"] for e in evals],
        stream_wait_s=waits, sidecar_pid=side_pid,
        sidecar_executor_cuda=eval_cuda, cluster_executor_cuda=executors_cuda,
        gpu=gpu)
    print("eval_sidecar " + json.dumps(eval_summary), flush=True)
    pulled_after_stop = [i for i in stop.get("pulled", [])
                         if i >= STREAM["stop_after"]]
    stop_summary = dict(
        **_stream_summary(report2, spark, t1), stop_rc=stop.get("rc"),
        stop_out=stop.get("out"), pulled=stop.get("pulled"),
        stop_to_return_s=stop_to_return_s, done=stopped,
        shutdown_error=shutdown_error, rings_left=stop_rings,
        total_s=stop_total_s, gpu=gpu)
    print("stream_stop " + json.dumps(stop_summary), flush=True)
    problems = []
    if report["losses"][:TRAIN_STEPS] != ref or len(report["losses"]) != n:
        problems.append(f"losses {report['losses']} against spark_train's "
                        f"{ref}")
    for name, r in (("stream", report), ("stop", report2)):
        want = FULL["n_layers"] * len(r["losses"])
        if r["launches"] != dict(flash_fwd=want, flash_dq=want,
                                 flash_dkv=want, rmsnorm=0):
            problems.append(f"{name} trainer launches {r['launches']}, "
                            f"want {want} of each flash kernel")
    if rings or stop_rings or summary["trainer_alive_after_shutdown"] or \
            stop_summary["trainer_alive_after_shutdown"]:
        problems.append(f"rings left {rings} {stop_rings} or a trainer "
                        "alive after shutdown")
    if done_after_stream or any(cuda for _i, _p, cuda in executors_cuda):
        problems.append(f"STOP set after a full stream {done_after_stream}; "
                        f"executors' CUDA {executors_cuda}")
    steps = list(range(every, n + 1, every))
    if saved != steps or evaluated != steps or \
            [e["step"] for e in evals] != steps:
        problems.append(f"checkpoints {saved}, evaluated {evaluated}, "
                        f"eval events {[e['step'] for e in evals]}")
    if not rel or not max(rel) <= SPARK_LOSS_RTOL:
        problems.append(f"eval losses {eval_summary['losses']} against the "
                        f"driver's {refs} (rtol {SPARK_LOSS_RTOL})")
    if any(e["metrics"]["launches"] != dict(flash_fwd=FULL["n_layers"],
                                            flash_dq=0, flash_dkv=0,
                                            rmsnorm=0) for e in evals):
        problems.append(f"evaluation launches {eval_summary['launches']}")
    if not any(cuda for _i, _p, cuda in eval_cuda):
        problems.append(f"the sidecar's executor holds no CUDA context: "
                        f"{eval_cuda}")
    if stop.get("rc") != 0 or not stopped or shutdown_error is not None or \
            len(pulled_after_stop) > 1 or \
            not len(report2["losses"]) < n or \
            len(report2["losses"]) > STREAM["stop_after"] + 1 or \
            report2["losses"] != ref[:len(report2["losses"])]:
        problems.append(f"stop: rc {stop.get('rc')} {stop.get('err')}, "
                        f"done {stopped}, shutdown {shutdown_error}, pulled "
                        f"{stop.get('pulled')}, losses {report2['losses']}")
    if problems:
        raise AssertionError("stream_transformer: " + "; ".join(problems))
    launches = _sum_launches(report["launches"], report2["launches"])
    return launches, _sum_launches(*[e["metrics"]["launches"]
                                     for e in evals])


# 40: successive halving over 4 SGD learning rates (budget 1, eta 2) with
# 2 TrialActors on a two-executor engine of their own; a trial trains
# MNIST on the card for 10 x budget steps from fixed params and data
SWEEP = dict(lrs=[0.1, 0.03, 0.01, 0.003], batch=64, steps=10, seed=40,
             rtol=1e-5)


def sweep_trial(lr, budget):
    """One trial, in a TrialActor's executor or here: MNIST on the card
    (float32, TF32 off, deterministic cuDNN) from the seeded params,
    ``SGD(lr, momentum 0.9)`` for ``10 * budget`` steps of the seeded
    records; the score is minus the last loss."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    dev = torch.device("cuda", 0)
    params = {k: {n: v.to(dev) for n, v in layer.items()}
              for k, layer in mnist.init_params(
                  torch.Generator().manual_seed(SWEEP["seed"])).items()}
    leaves = [p.requires_grad_() for layer in params.values()
              for p in layer.values()]
    step = mnist.make_train_step(torch.optim.SGD(leaves, lr=lr,
                                                 momentum=0.9))
    steps, b = SWEEP["steps"] * budget, SWEEP["batch"]
    images, labels = mnist_spark.collate(mnist_spark.synthetic_records(
        steps * b, seed=SWEEP["seed"]))
    images = torch.from_numpy(images).to(dev)
    labels = torch.from_numpy(labels).to(dev)
    loss = None
    for i in range(steps):
        loss, _ = step(params, images[i * b:(i + 1) * b],
                       labels[i * b:(i + 1) * b])
    return -float(loss)


def _halving_here(configs, budget, eta):
    """Successive halving with ``sweep_trial`` called in this process,
    rung after rung in the order the sweep asks: the reference."""
    survivors, history = list(enumerate(configs)), []
    while survivors:
        scores = {tid: sweep_trial(cfg, budget) for tid, cfg in survivors}
        ranked = sorted(survivors, key=lambda s: (-scores[s[0]], s[0]))
        history.append({"rung": len(history), "budget": budget,
                        "scores": scores})
        if len(ranked) == 1:
            break
        survivors = ranked[:max(1, -(-len(ranked) // eta))]
        budget *= eta
    return history, configs[ranked[0][0]]


def phase_sweep(engine_sweep, gpu, beside=()):
    """40 ``sweep``: ``workloads.successive_halving`` over ``SWEEP``'s
    learning rates with 2 ``TrialActor``s on ``engine_sweep``: its rungs
    (trials and budgets) and best config equal those of the same
    ``trial_fn`` called here in the same order, each score within
    ``SWEEP["rtol"]``; its times are taken while the phases named in
    ``beside`` run (``measured_beside``).  Returns the summary; the
    caller prints it."""
    from tensorflowonspark_tpu_torch import workloads
    from tensorflowonspark_tpu_torch.actors import ActorSystem

    system = ActorSystem(2, engine=engine_sweep)
    try:
        t0 = time.perf_counter()
        out = workloads.successive_halving(
            sweep_trial, SWEEP["lrs"], budget=1, eta=2, workers=2,
            system=system, timeout=600)
        sweep_s = time.perf_counter() - t0
        pids = system.group("sweep").pids()
    finally:
        system.stop()
    t0 = time.perf_counter()
    ref, ref_best = _halving_here(SWEEP["lrs"], 1, 2)
    here_s = time.perf_counter() - t0
    got = out["history"]
    rel = [abs(r["scores"][t] - h["scores"][t]) / abs(h["scores"][t])
           for r, h in zip(got, ref) for t in h["scores"]
           if t in r["scores"]]
    summary = dict(
        lrs=SWEEP["lrs"], rungs=[[r["budget"], sorted(r["scores"])]
                                 for r in got],
        scores=[r["scores"] for r in got], best=out["best"],
        driver_rungs=[[h["budget"], sorted(h["scores"])] for h in ref],
        driver_best=ref_best, max_rel_score_diff=max(rel) if rel else None,
        sweep_s=sweep_s, driver_s=here_s, measured_beside=list(beside),
        trial_pids=pids, executors_cuda=_executors_cuda(engine_sweep),
        gpu=gpu)
    if summary["rungs"] != summary["driver_rungs"] or \
            out["best"]["config"] != ref_best or len(rel) != sum(
                len(h["scores"]) for h in ref) or \
            not max(rel) <= SWEEP["rtol"]:
        raise AssertionError(f"sweep: {json.dumps(summary, default=str)}")
    return summary



# -- the serving tier's elastic pool, fabric and deploy loop (41-43) ---------

# 41: a float32 pool of 3 replicas over 6 logical slots; 12 sessions in
# flight, one replica SIGKILLed; decode admission 24 sessions at full
# capacity (12 at the pool's 3/6, 8 at 2/6)
SERVE_ELASTIC = dict(replicas=3, logical=6, sessions=12, after=4,
                     queue_max=24, tokens=16)
# 42: 2 fabric hosts of 1 worker; the autoscaler may grow a host to 2
# when the in-flight sessions a worker pass 5: the 8 sessions of a
# turn (4 a worker) stay under it, the burst of 16 (8) goes over
SERVE_FABRIC = dict(hosts=2, sessions=8, burst=16, tokens=16,
                    autoscale=dict(max_replicas=2, high=5.0, low=0.0,
                                   cooldown=2.0, tick_secs=0.2))
# 43: the deploy loop's knobs; step 2 is step 1 after `adam_steps` Adam
# steps on the held-out batch, step 3 step 2 with its embedding x
# `embed_scale`, step 4 step 2 with one NaN weight.  The embedding is
# initialised at 0.02 std, small beside what the layers add to the
# residual stream: x 8 moved the held-out loss too little to regress
# (a chip run promoted it); x 1000 makes the embedding swamp the layers.
# The latency guard's tolerance is the JAX end-to-end test's: a canary
# arm reloads ~0.5 GB of params when it opens, and its first sessions
# wait for it
SERVE_DEPLOY = dict(replicas=3, pct=50, canary_count=1, burn_secs=4.0,
                    min_samples=3, lat_tol=10.0, eval_tol=0.1,
                    adam_steps=10, lr=1e-3, embed_scale=1000.0,
                    traffic_threads=4, tokens=16)


def _mem_info(dev):
    free, total = torch.cuda.mem_get_info(dev)
    return dict(free_bytes=free, total_bytes=total)


def _greedy_refs(params, cfg, prompts, max_tokens):
    """``greedy_decode_reference`` of each prompt on the card, with
    ``mha_reference`` attention (no kernel)."""
    ref_attn = lambda q, k, v: attention.mha_reference(q, k, v, causal=True)
    return [T.greedy_decode_reference(params, p, cfg, max_tokens=max_tokens,
                                      attn_fn=ref_attn) for p in prompts]


def _wait_until(cond, what, timeout=300):
    deadline = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: not within {timeout} s")
        time.sleep(0.02)
    return time.monotonic()


def _host_launch_gate(hosts, cfg):
    """Every fabric host launched the flash forward on each layer of
    each plain prefill of its workers (the counts are the process's),
    and none of the other kernels; every worker's engine stepped in CUDA
    graphs (:func:`_graph_gate`)."""
    for h, st in hosts.items():
        for w, ws in st["workers"].items():
            _graph_gate(f"host {h} worker {w}", ws["decode"])
        plain = sum(w["decode"]["prefills"] - w["decode"]["extends"]
                    for w in st["workers"].values())
        got = st["launches"]
        if got["flash_fwd"] < cfg.n_layers * plain or (
                plain and got["flash_fwd"] == 0) or any(
                got[k] for k in ("flash_dq", "flash_dkv", "rmsnorm")):
            raise AssertionError(f"host {h} launched {got} for {plain} "
                                 f"plain prefills x {cfg.n_layers} layers")


def phase_serve_elastic(dev, gpu, engine, tmp):
    """41 ``serve_elastic``: ``Server(elastic=True, num_replicas=3,
    logical_replicas=6)`` over a float32 export and a ``ckpt_dir`` (seed
    2) on an engine of its own.  12 greedy sessions (prompts of 40-1100
    tokens, 16 tokens) in flight; the export's and the checkpoint's
    params files deleted; one replica SIGKILLed while it streams.  The
    generation bumps and the survivors cover 3+3 slots; the pool is
    degraded and a session past the shrunk admission is shed with
    Retry-After; every session completes once with the reference's
    tokens; the respawned incarnation adopts the mirror (a cold boot
    would find no params file) and the pool re-grows to 2+2+2; its next
    4 sessions equal the reference; ``drain`` finishes a replica's
    in-flight work, and refuses the last; each replica launched the
    flash forward on every layer of each plain prefill.  Returns the
    replicas' launches and pids."""
    from tensorflowonspark_tpu_torch.serving import elastic as serve_elastic

    c = SERVE_ELASTIC
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    export_dir = os.path.join(tmp, "lm_elastic")
    ckpt_dir = os.path.join(tmp, "lm_elastic_ckpt")
    ckpt.export_model(export_dir, params, metadata={"config": FULL})
    ckpt.save_checkpoint(ckpt_dir, params, step=1)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(40, 1101, size=c["sessions"])]
    after = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
             for n in rng.integers(40, 1101, size=c["after"])]
    refs = _greedy_refs(params, cfg, prompts + after, c["tokens"])
    del params
    torch.cuda.empty_cache()
    spec = serving.ModelSpec(export_dir=export_dir, ckpt_dir=ckpt_dir,
                             device=str(dev),
                             decode=_decode_spec(cfg, c["tokens"]))
    srv = serving.Server(spec, num_replicas=c["replicas"], elastic=True,
                         logical_replicas=c["logical"], engine=engine,
                         request_timeout=600,
                         decode_queue_max=c["queue_max"])
    mem = {"before_boot": _mem_info(dev)}
    t_boot = time.monotonic()
    srv.start(timeout=600)
    pool = srv.pool
    pids = set(pool.replica_pids().values())
    try:
        boot_s = time.monotonic() - t_boot
        live = list(range(c["replicas"]))
        _wait_until(lambda: pool.mirror_bytes is not None, "the mirror")
        formed = pool.describe()
        if formed["assignments"] != {str(i): 2 for i in live} or \
                formed["capacity"] != 0.5:
            raise AssertionError(f"formation: {formed}")
        # a cold boot from here would find no params file: the respawn
        # must adopt (the export's metadata stays: it names the predict)
        os.remove(os.path.join(export_dir, "params.npz"))
        shutil.rmtree(ckpt_dir)
        mem["pool_up"] = _mem_info(dev)
        gen0, adoptions0 = pool.generation, pool.adoptions
        respawns0 = pool.respawns_observed
        victim = 0
        table = pool._table

        def streaming_on_victim():
            for key in table.owned_by({victim}):
                entry = table.get(key)
                if entry is not None and entry["session"].tokens_so_far():
                    return True
            return False

        got, errors = [None] * len(prompts), []

        def one(i):
            try:
                got[i] = srv.generate(prompts[i], max_tokens=c["tokens"])
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        _wait_until(lambda: streaming_on_victim() or not any(
            t.is_alive() for t in threads), "a session on the victim")
        if not streaming_on_victim():
            raise AssertionError("no session streamed on the victim")
        victim_pid = pool.replica_pids()[victim]
        t_kill = time.monotonic()
        os.kill(victim_pid, 9)
        t_shrunk = _wait_until(lambda: pool.capacity_frac < 0.5,
                               "the shrink")
        shrunk = pool.describe()
        # load past the shrunk admission, a session every 2 ms (each sees
        # the ones before it outstanding): the excess is shed, with the
        # degraded backoff; the admitted ones serve as any other
        limit = int(round(c["queue_max"] * pool.capacity_frac))
        sheds = []

        def probe(i):
            j = i % len(prompts)
            try:
                probed.append((j, srv.generate(prompts[j],
                                               max_tokens=c["tokens"])))
            except serving.Overloaded as e:
                sheds.append(dict(depth=e.depth, limit=e.limit,
                                  retry_after=e.retry_after))
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        probed = []
        for i in range(limit + 4):
            threads.append(threading.Thread(target=probe, args=(i,)))
            threads[-1].start()
            time.sleep(0.002)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        if shrunk["generation"] <= gen0 or not shrunk["degraded"] or \
                {int(k): v for k, v in shrunk["assignments"].items()} != \
                serve_elastic.assign_slots(c["logical"], [1, 2]) or \
                shrunk["assignments"] != {"1": 3, "2": 3}:
            raise AssertionError(f"the shrink: {shrunk}")
        if not sheds or any(s["retry_after"] < 0.25 for s in sheds):
            raise AssertionError(f"no shed past the shrunk admission "
                                 f"(limit {limit}): {sheds}")
        got += [out for _j, out in probed]
        refs_got = refs[:len(prompts)] + [refs[j] for j, _out in probed]
        for i, (g, ref) in enumerate(zip(got, refs_got)):
            _session_gate(f"elastic {i}", g, c["tokens"], cfg.vocab_size)
            if g["tokens"] != ref:
                raise AssertionError(f"elastic session {i}: {g['tokens']} "
                                     f"!= reference {ref}")
        t_regrown = _wait_until(
            lambda: pool.live_replicas() == live
            and pool.respawns_observed > respawns0
            and pool.describe()["assignments"] == {str(i): 2 for i in live},
            "the re-grow")
        regrown = pool.describe()
        mem["regrown"] = _mem_info(dev)
        reps = pool.stats(timeout=60)
        el = reps[victim]["elastic"]
        if el["boot"] != "adopted" or pool.adoptions <= adoptions0 or \
                regrown["generation"] < shrunk["generation"] + 1 or \
                reps[victim]["version"] != 1:
            raise AssertionError(f"the respawn did not adopt: {el}, "
                                 f"{regrown}, version "
                                 f"{reps[victim]['version']}")
        outs = _concurrently(lambda p: srv.generate(p,
                                                    max_tokens=c["tokens"]),
                             after)
        for i, (o, ref) in enumerate(zip(outs, refs[len(prompts):])):
            if o["tokens"] != ref:
                raise AssertionError(f"after the re-grow, session {i}: "
                                     f"{o['tokens']} != {ref}")
        if victim not in {o["replica"] for o in outs}:
            raise AssertionError(f"the adopted replica served none of "
                                 f"{[o['replica'] for o in outs]}")
        reps = pool.stats(timeout=60)
        _serve_launch_gate(reps, cfg)
        launches = _replica_launches(reps)
        pids |= set(pool.replica_pids().values())
        # drain: a replica finishes its in-flight work, then leaves; the
        # last live one is refused
        pending = [None] * 2
        drains = []

        def drained_one(i):
            pending[i] = srv.generate(after[i], max_tokens=c["tokens"])

        ts = [threading.Thread(target=drained_one, args=(i,))
              for i in range(2)]
        for t in ts:
            t.start()
        _wait_until(lambda: pool.outstanding_sessions() > 0 or not any(
            t.is_alive() for t in ts), "in-flight work to drain")
        t0 = time.monotonic()
        drains.append(dict(replica=0, ok=pool.drain(0, timeout=120),
                           s=time.monotonic() - t0))
        for t in ts:
            t.join()
        if [p["tokens"] for p in pending] != refs[len(prompts):][:2]:
            raise AssertionError(f"sessions across the drain: {pending}")
        drains.append(dict(replica=1, ok=pool.drain(1, timeout=120)))
        try:
            pool.drain(2)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("drain of the last replica not refused")
        if not all(d["ok"] for d in drains) or pool.live_replicas() != [2]:
            raise AssertionError(f"drains {drains}, live "
                                 f"{pool.live_replicas()}")
    finally:
        srv.stop()
    mem["stopped"] = _mem_info(dev)
    print("serve_elastic " + json.dumps(dict(
        replicas=c["replicas"], logical=c["logical"],
        sessions=len(prompts), tokens=c["tokens"], pool_boot_s=boot_s,
        formed=formed, shrunk=shrunk, regrown=regrown,
        resize_ms=dict(shrink=shrunk["last_resize_ms"],
                       regrow=regrown["last_resize_ms"]),
        kill_to_resize_s=t_shrunk - t_kill,
        kill_to_regrown_s=t_regrown - t_kill,
        mirror_bytes=pool.mirror_bytes, mirror_s=el["directive_s"],
        adopt_s=el["ready_s"], adoptions=pool.adoptions,
        replayed_tokens_dropped=pool.replayed_tokens,
        shed_sessions=sheds, admitted_past_shrink=len(probed),
        victim=victim, victim_pid=victim_pid, drains=drains,
        drain_refused=refused, mem_info=mem,
        replicas_stats={i: dict(pid=r["pid"], boot=r["elastic"]["boot"],
                                peak_mem_bytes=r.get("peak_mem_bytes"),
                                mem_bytes=r.get("mem_bytes"),
                                graphs=r["decode"]["graphs"],
                                launches=r["launches"],
                                prefills=r["decode"]["prefills"],
                                extends=r["decode"]["extends"])
                        for i, r in sorted(reps.items())},
        gpu=gpu)), flush=True)
    return launches, pids


def phase_serve_fabric(dev, gpu, engine, tmp):
    """42 ``serve_fabric``: ``Server(fabric=True, fabric_hosts=2,
    replicas_per_host=1, autoscale=...)`` over the float32 transformer
    (seed 2) on an engine of its own.  8 sessions with distinct route ids
    give the reference's tokens ("miss"); each one's second turn (its
    prompt and answer, the same route id) is routed "hit" to the same
    (host, worker) and maps its prefix from that worker's trie; a burst
    of 16 sessions drives the ``ServeAutoscaler`` to grow a host to 2
    workers (the directive acked, the worker map grown) and the new
    worker prefills with the flash forward; ``/statusz`` then has a pods
    row a host; one host SIGKILLed with sessions in flight (none
    dropped or duplicated, the reference's tokens) and its respawn,
    which boots at a newer checkpoint, converges to the pool's pinned
    version.  Returns the hosts' launches and pids."""
    from tensorflowonspark_tpu_torch.obs import http as obs_http

    c = SERVE_FABRIC
    cfg = T.Config(**FULL, dtype="float32", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(2), dev)
    export_dir = os.path.join(tmp, "lm_fabric")
    ckpt_dir = os.path.join(tmp, "lm_fabric_ckpt")
    ckpt.export_model(export_dir, params, metadata={"config": FULL})
    ckpt.save_checkpoint(ckpt_dir, params, step=1)
    rng = np.random.default_rng(42)
    firsts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
              for n in rng.integers(40, 1101, size=c["sessions"])]
    refs = _greedy_refs(params, cfg, firsts, c["tokens"])
    seconds = [p + r for p, r in zip(firsts, refs)]
    refs2 = _greedy_refs(params, cfg, seconds, c["tokens"])
    del params
    torch.cuda.empty_cache()
    spec = serving.ModelSpec(export_dir=export_dir, ckpt_dir=ckpt_dir,
                             device=str(dev),
                             decode=_decode_spec(cfg, c["tokens"]))
    srv = serving.Server(spec, fabric=True, fabric_hosts=c["hosts"],
                         replicas_per_host=1, autoscale=c["autoscale"],
                         engine=engine, request_timeout=600,
                         decode_queue_max=64)
    t_boot = time.monotonic()
    srv.start(timeout=600)
    pool = srv.pool
    pids = set(pool.host_pids().values())
    try:
        boot_s = time.monotonic() - t_boot
        gen = lambda p, rid=None: srv.generate(p, max_tokens=c["tokens"],
                                               route_id=rid)

        def check(outs, want, what):
            for i, (o, w) in enumerate(zip(outs, want)):
                _session_gate(f"{what} {i}", o, c["tokens"], cfg.vocab_size)
                if o["tokens"] != w:
                    raise AssertionError(f"{what} {i}: {o['tokens']} != "
                                         f"reference {w}")

        # first turns: distinct route ids, each a "miss" placed by the ring
        rids = [f"user-{i}" for i in range(len(firsts))]
        outs1 = _concurrently(lambda i: gen(firsts[i], rids[i]),
                              list(range(len(firsts))))
        check(outs1, refs, "first turn")
        if any(o["affinity"] != "miss" for o in outs1):
            raise AssertionError(f"first turns: "
                                 f"{[o['affinity'] for o in outs1]}")
        bound = [pool.affinity_binding(r) for r in rids]
        before = pool.stats(timeout=60)
        # second turns: the same route id lands on the same worker, whose
        # trie holds the first turn's whole blocks
        outs2 = _concurrently(lambda i: gen(seconds[i], rids[i]),
                              list(range(len(seconds))))
        check(outs2, refs2, "second turn")
        if any(o["affinity"] != "hit" for o in outs2) or \
                [pool.affinity_binding(r) for r in rids] != bound or \
                any((o["host"], o["worker"]) != tuple(b)
                    for o, b in zip(outs2, bound)):
            got = [(o["affinity"], o["host"]) for o in outs2]
            raise AssertionError(f"second turns: {got}, bound {bound}")
        after2 = pool.stats(timeout=60)
        hits = {}
        for h, w in set(map(tuple, bound)):
            d0 = before[h]["workers"][w]["decode"]
            d1 = after2[h]["workers"][w]["decode"]
            hits[f"{h}/{w}"] = d1["prefix_hits"] - d0["prefix_hits"]
        if sum(hits.values()) < len(seconds):
            raise AssertionError(f"second turns' prefix hits: {hits}")
        # bursts until the autoscaler grows a host (its signal is published
        # every 0.5 s, so a burst may end before one is read)
        t_burst = time.monotonic()
        burst = (firsts * 2)[:c["burst"]]
        rounds = 0
        while not pool.scale_times and rounds < 10:
            outs3 = _concurrently(gen, burst)
            check(outs3, (refs * 2)[:c["burst"]], "burst")
            rounds += 1
        t_scaled = _wait_until(lambda: pool.scale_times, "a scale-up's ack",
                               timeout=60)
        scaled_h, scaled_n, t_dir, t_ack = pool.scale_times[0]
        if pool.scale_ups < 1 or scaled_n != 2 or \
                pool._live_workers()[scaled_h] != 2:
            raise AssertionError(f"scale-up: {pool.describe()}")
        statusz = obs_http.ObsServer(cluster=None, port=0,
                                     interval=999).render_statusz()
        pods = statusz.get("pods") or []
        if sorted(r["host"] for r in pods) != list(range(c["hosts"])):
            raise AssertionError(f"/statusz pods: {pods}")
        # the new worker prefills: a route id the ring places on it
        ring = pool._ring_for(pool._live_workers())
        key = next(f"new-{k}" for k in range(10000)
                   if ring.lookup(f"new-{k}") == (scaled_h, 1))
        o = gen(firsts[0], key)
        check([o], refs[:1], "the new worker")
        st = pool.stats(timeout=60)
        new_dec = st[scaled_h]["workers"][1]["decode"]
        if (o["host"], o["worker"]) != (scaled_h, 1) or \
                new_dec["prefills"] < 1:
            raise AssertionError(f"the new worker: {o['host']}/"
                                 f"{o['worker']}, {new_dec}")
        pre_kill = st
        # pin the version, then a newer checkpoint: the respawned host
        # boots at it and is steered back to the pin
        pool.set_watermark(1)
        shutil.copy(ckpt._path(ckpt_dir, 1), ckpt._path(ckpt_dir, 2))
        target = 1 - scaled_h
        got, errors = [None] * len(firsts), []

        def one(i):
            try:
                got[i] = gen(firsts[i])
            except BaseException as e:  # noqa: BLE001 - raised below
                errors.append(e)

        threads = [threading.Thread(target=one, args=(i,))
                   for i in range(len(firsts))]
        respawns0 = pool.respawns_observed
        redisp0 = pool.redispatched
        for t in threads:
            t.start()
        _wait_until(lambda: any(pool._table.get(k) is not None and
                                pool._table.get(k)["session"].tokens_so_far()
                                for k in pool._table.owned_by({target}))
                    or not any(t.is_alive() for t in threads),
                    "a session on the target host")
        victim_pid = pool.host_pids()[target]
        t_kill = time.monotonic()
        os.kill(victim_pid, 9)
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        check(got, refs, "through the kill")
        # the scan's loss (by the pid, before the respawn's up)
        lost = [t for t in pool.lost_times.get(target, []) if t >= t_kill]
        failover_s = lost[0] - t_kill if lost else None
        _wait_until(lambda: pool.respawns_observed > respawns0 and
                    len(pool.live_replicas()) == c["hosts"],
                    "the host's respawn")
        t_back = pool.up_times[target][-1]
        _wait_until(lambda: pool.versions() == {h: 1 for h in
                                                range(c["hosts"])},
                    "the respawn's version")
        post = gen(firsts[1])
        check([post], refs[1:2], "after the respawn")
        final = pool.stats(timeout=60)
        _host_launch_gate(final, cfg)
        launches = _replica_launches(final)
        pids |= set(pool.host_pids().values())
        desc = pool.describe()
    finally:
        srv.stop()
    counts = desc["affinity"]
    print("serve_fabric " + json.dumps(dict(
        hosts=c["hosts"], sessions=len(firsts), tokens=c["tokens"],
        pool_boot_s=boot_s, affinity=counts,
        affinity_hit_rate=counts["hit"] / max(1, sum(counts.values())),
        second_turn_prefix_hits=hits,
        scale_up=dict(host=scaled_h, workers=scaled_n,
                      burst_to_ack_s=t_ack - t_burst,
                      directive_to_ack_s=t_ack - t_dir,
                      seen_s=t_scaled - t_burst, burst_rounds=rounds),
        new_worker=new_dec, pods=pods,
        kill=dict(host=target, pid=victim_pid,
                  kill_to_failover_s=failover_s,
                  kill_to_up_s=t_back - t_kill,
                  redispatched=pool.redispatched - redisp0,
                  replayed_tokens_dropped=pool.replayed_tokens),
        versions=pool.versions(),
        launches_a_host={h: s["launches"] for h, s in final.items()},
        launches_before_kill={h: s["launches"]
                              for h, s in pre_kill.items()},
        peak_mem_bytes={h: s.get("peak_mem_bytes")
                        for h, s in final.items()},
        mem_bytes={h: s.get("mem_bytes") for h, s in final.items()},
        graphs={f"{h}/{w}": (ws["decode"]["graphs"],
                             ws["decode"]["capture_ms"])
                for h, s in final.items()
                for w, ws in s["workers"].items()},
        describe={k: v for k, v in desc.items() if k != "hosts"},
        gpu=gpu)), flush=True)
    return launches, pids


def serve_elastic_beside_fabric(dev, gpu, engine_elastic, engine_fabric,
                                tmp):
    """Phases 41 and 42 at once, 42 on a thread (two pools on engines
    of their own, the card shared; each line's times are taken beside the
    other: ``measured_beside``).  Returns both launch counts and every
    replica's and host's pid; each engine stopped."""
    out = {}

    def _fabric():
        try:
            out["fabric"] = phase_serve_fabric(dev, gpu, engine_fabric, tmp)
        except BaseException as e:  # noqa: BLE001 - raised below
            out["fabric error"] = e
        finally:
            engine_fabric.stop()

    t = threading.Thread(target=_fabric, name="phase-serve_fabric")
    t.start()
    try:
        elastic = phase_serve_elastic(dev, gpu, engine_elastic, tmp)
    finally:
        engine_elastic.stop()
        t.join()
    if "fabric error" in out:
        raise out["fabric error"]
    print("serve_tier measured_beside " + json.dumps(
        {"serve_elastic": ["serve_fabric"],
         "serve_fabric": ["serve_elastic"]}), flush=True)
    return (elastic[0], out["fabric"][0]), elastic[1] | out["fabric"][1]


def deploy_eval(tree, step):
    """The deploy loop's sidecar ``eval_fn``, in its executor on the
    card: the restored params' held-out loss (bf16, the flash kernels)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    loss, launches = transformer_eval_loss(tree, torch.device("cuda", 0))
    return {"loss": loss, "launches": launches, "pid": os.getpid(),
            "eval_ms": 1e3 * (time.perf_counter() - t0)}


def _deploy_checkpoints(dev):
    """Steps 1-4's params trees (JAX layout, float32 host arrays)."""
    c = SERVE_DEPLOY
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    params = T.init(cfg, torch.Generator(device=dev).manual_seed(0), dev)
    host = lambda p: ckpt._unflatten({k: np.array(v, copy=True)
                                      for k, v in ckpt._flatten(p).items()})
    steps = {1: host(params)}
    leaves = _param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=c["lr"])
    batch = torch.from_numpy(np.random.default_rng(
        STREAM["eval_seed"]).integers(
            0, FULL["vocab_size"], (TRAIN_BATCH, FULL["max_seq"]))).to(dev)
    for _ in range(c["adam_steps"]):
        loss = T.loss_fn(params, batch, cfg)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
    del opt, leaves
    steps[2] = host(params)
    del params
    torch.cuda.empty_cache()
    steps[3] = dict(steps[2], embed=steps[2]["embed"] * c["embed_scale"])
    nan = dict(steps[2], layers=dict(steps[2]["layers"]))
    w = nan["layers"]["wo"].copy()
    w.flat[0] = np.nan
    nan["layers"]["wo"] = w
    steps[4] = nan
    return steps


def phase_serve_deploy(dev, gpu, engine, engine_actors, tmp, tdir):
    """43 ``serve_deploy``: a 3-replica bf16 decode pool with a
    ``ckpt_dir`` on an engine of its own, beside an ``ActorSystem`` on a
    second engine holding an ``EvalSidecar`` (``deploy_eval`` on the
    card) and a ``PromotionController``, and a ``DeployLoop(pct=50,
    canary_count=1, burn_secs=4, min_samples=3)``; sessions with distinct
    route ids run throughout.  Step 1 (phase 6's init) is blessed and
    bootstrap-pinned; step 2 (Adam steps on the held-out batch) is
    canaried and promoted, its manifest verifying; step 3 (step 2's
    embedding x 1000) is blessed, canaried and rolled back for an eval
    regression, tombstoned, with a ``deploy/rollback`` flight dump; step
    4 (a NaN weight) is tombstoned at the gate and never canaried; the
    watermark ends at 2 and every replica serves version 2; no session
    dropped, versions 1, 2 and 3 each served; each eval loss within
    ``SPARK_LOSS_RTOL`` of the driver's on the same checkpoint;
    ``/statusz`` has a deploy row.  Returns the replicas' and the
    evaluations' launches, the replicas' pids."""
    from tensorflowonspark_tpu_torch import workloads
    from tensorflowonspark_tpu_torch.actors import (
        ActorSystem,
        SupervisionPolicy,
    )
    from tensorflowonspark_tpu_torch.obs import flight
    from tensorflowonspark_tpu_torch.obs import http as obs_http

    c = SERVE_DEPLOY
    cfg = T.Config(**FULL, dtype="bfloat16", attn_impl="flash")
    steps = _deploy_checkpoints(dev)
    # the driver's held-out losses, which the sidecar's must equal; step
    # 2 must improve on step 1 and step 3 regress from step 2 past the
    # loop's tolerance, or the phase tests nothing
    driver_loss = {k: transformer_eval_loss(tree, dev)[0]
                   for k, tree in steps.items()}
    print("serve_deploy losses " + json.dumps(driver_loss), flush=True)
    if not (driver_loss[2] < driver_loss[1] and driver_loss[3] >
            driver_loss[2] * (1 + c["eval_tol"])
            and np.isnan(driver_loss[4])):
        raise AssertionError(f"deploy checkpoints' losses {driver_loss}")
    ckpt_dir = os.path.join(tmp, "lm_deploy_ckpt")
    ckpt.save_checkpoint(ckpt_dir, steps[1], step=1, keep=10)
    rng = np.random.default_rng(43)
    prompts = [rng.integers(1, cfg.vocab_size, size=int(n)).tolist()
               for n in rng.integers(64, 513, size=32)]
    spec = serving.ModelSpec(ckpt_dir=ckpt_dir, device=str(dev),
                             decode=_decode_spec(cfg, c["tokens"]))
    srv = serving.Server(spec, num_replicas=c["replicas"], engine=engine,
                         request_timeout=600)
    os.environ[telemetry.DIR_ENV] = tdir
    srv.start(timeout=600)
    pool = srv.pool
    pids = set(pool.replica_pids().values())
    system = ActorSystem(2, engine=engine_actors)
    stop = threading.Event()
    served, drops, sent = [], [], itertools.count()

    def traffic():
        while not stop.is_set():
            i = next(sent)
            try:
                out = srv.generate(prompts[i % len(prompts)],
                                   max_tokens=c["tokens"],
                                   route_id=f"client-{i}")
                served.append(out["version"])
            except Exception as e:  # noqa: BLE001 - any loss counts
                drops.append(repr(e))

    threads = [threading.Thread(target=traffic, name=f"deploy-traffic-{i}")
               for i in range(c["traffic_threads"])]
    verdicts = []
    try:
        pol = SupervisionPolicy(tick_secs=0.2)
        side = system.spawn(workloads.EvalSidecar(ckpt_dir, deploy_eval),
                            "eval", policy=pol, timeout=600)
        system.spawn(workloads.PromotionController(ckpt_dir), "deploy",
                     policy=pol, timeout=600)
        loop = workloads.DeployLoop(
            pool, ckpt_dir, pct=c["pct"], canary_count=c["canary_count"],
            burn_secs=c["burn_secs"], min_samples=c["min_samples"],
            eval_tol=c["eval_tol"], lat_tol=c["lat_tol"])
        if loop.recover() is not None:
            raise AssertionError("a watermark before any blessing")
        for t in threads:
            t.start()

        def pump_until(cond, what, timeout=180):
            deadline = time.monotonic() + timeout
            burn_t0 = None
            while not cond():
                if time.monotonic() > deadline:
                    raise AssertionError(f"deploy: {what} not within "
                                         f"{timeout} s ({loop.status()})")
                row = loop.pump()
                if row["state"] == "burn" and burn_t0 is None:
                    burn_t0 = time.monotonic()
                time.sleep(0.05)
            if burn_t0 is not None:
                verdicts.append(dict(loop.last_verdict,
                                     canary_to_verdict_s=(
                                         time.monotonic() - burn_t0),
                                     arms=pool.canary_stats()))

        def gated(step):
            _wait_until(lambda: ckpt.read_manifest(ckpt_dir, step)
                        is not None, f"step {step}'s gate", timeout=300)
            return ckpt.verify_manifest(ckpt_dir, step)

        if gated(1) != (True, "ok"):
            raise AssertionError(f"step 1: {gated(1)}")
        pump_until(lambda: pool.watermark() == 1, "the bootstrap pin")
        for step in (2, 3, 4):
            ckpt.save_checkpoint(ckpt_dir, steps[step], step=step, keep=10)
            ok, why = gated(step)
            if step == 2:
                if not ok:
                    raise AssertionError(f"step 2 gated: {why}")
                pump_until(lambda: loop.promotions >= 2 and
                           loop.state == "idle", "step 2's promotion")
                if pool.watermark() != 2 or \
                        ckpt.verify_manifest(ckpt_dir, 2) != (True, "ok"):
                    raise AssertionError(f"step 2: {loop.status()}")
                _wait_until(lambda: set(pool.versions().values()) == {2},
                            "version 2 everywhere")
            elif step == 3:
                if not ok:
                    raise AssertionError(f"step 3 not blessed: {why}")
                pump_until(lambda: loop.rollbacks >= 1, "step 3's rollback")
                why3 = ckpt.verify_manifest(ckpt_dir, 3)[1]
                if pool.watermark() != 2 or not any(
                        "eval regression" in r
                        for r in loop.last_verdict["reasons"]) or \
                        "tombstoned" not in why3:
                    raise AssertionError(f"step 3: {loop.last_verdict}, "
                                         f"{why3}")
                _wait_until(lambda: set(pool.versions().values()) == {2},
                            "version 2 back on the canary arm")
            else:
                if ok or "tombstoned" not in why:
                    raise AssertionError(f"step 4 at the gate: {why}")
                for _ in range(10):
                    row = loop.pump()
                    if row["state"] != "idle" or row["candidate"]:
                        raise AssertionError(f"step 4 canaried: {row}")
                    time.sleep(0.1)
        statusz = obs_http.ObsServer(cluster=None, port=0,
                                     interval=999).render_statusz()
        rows = [r for r in statusz.get("deploy") or []
                if r["ckpt_dir"] == ckpt_dir]
        _wait_until(lambda: len(_evaluated(side)) >= 4, "4 evaluations")
        results = {p["step"]: p["metrics"] for _i, kind, p
                   in list(side.events) if kind == "eval/result"}
        stop.set()
        for t in threads:
            t.join(600)
        reps = pool.stats(timeout=60)
        versions = pool.versions()
        summary = loop.summary()
    finally:
        stop.set()
        for t in threads:
            if t.ident is not None:
                t.join(600)
        system.stop()
        srv.stop()
        os.environ.pop(telemetry.DIR_ENV, None)
    if summary["watermark"] != 2 or set(versions.values()) != {2} or \
            [v["verdict"] for v in summary["history"]] != \
            ["promote", "promote", "rollback"] or \
            [v["step"] for v in summary["history"]] != [1, 2, 3]:
        raise AssertionError(f"deploy: {summary}, versions {versions}")
    if drops or not {1, 2, 3} <= set(served):
        raise AssertionError(f"deploy traffic: {len(drops)} dropped "
                             f"({drops[:3]}), versions served "
                             f"{sorted(set(served))}")
    if len(rows) != 1 or rows[0]["watermark"] != 2:
        raise AssertionError(f"/statusz deploy: {rows}")
    dumps = []
    for root, _dirs, files in os.walk(tdir):
        for name in files:
            if name.startswith("flight-") and name.endswith(".json"):
                with open(os.path.join(root, name), encoding="utf-8") as f:
                    dumps.append(json.load(f))
    rollback_dumps = [d for d in dumps
                      if d["trigger"] == telemetry.DEPLOY_ROLLBACK and
                      "eval regression" in (d.get("reason") or "")]
    if not rollback_dumps:
        raise AssertionError(f"no deploy/rollback flight dump in {tdir}")
    rel = {}
    for step, want in driver_loss.items():
        got = results[step]["loss"]
        if np.isnan(want) or np.isnan(got):
            rel[step] = None if (np.isnan(want) and np.isnan(got)) else 1.0
        else:
            rel[step] = abs(got - want) / abs(want)
        if rel[step] is not None and rel[step] > SPARK_LOSS_RTOL:
            raise AssertionError(f"step {step}: sidecar loss {got}, the "
                                 f"driver's {want}")
    eval_launches = collections.Counter()
    for step, m in results.items():
        if m["launches"]["flash_fwd"] != cfg.n_layers or any(
                m["launches"][k] for k in ("flash_dq", "flash_dkv",
                                           "rmsnorm")):
            raise AssertionError(f"step {step}'s evaluation launched "
                                 f"{m['launches']}")
        eval_launches.update(m["launches"])
    _serve_launch_gate(reps, cfg)
    launches = _replica_launches(reps)
    launches = {k: launches[k] + eval_launches[k] for k in launches}
    print("serve_deploy " + json.dumps(dict(
        replicas=c["replicas"], knobs=c,
        history=summary["history"], verdicts=verdicts,
        eval_losses={s: results[s]["loss"] for s in sorted(results)},
        driver_losses=driver_loss, loss_rel_diff=rel,
        eval_ms={s: results[s]["eval_ms"] for s in sorted(results)},
        sessions=len(served), versions_served=dict(
            collections.Counter(served)), dropped=len(drops),
        flight_dumps=len(rollback_dumps), versions=versions,
        replica_launches=_replica_launches(reps),
        eval_launches=dict(eval_launches), statusz_deploy=rows[0]["state"],
        gpu=gpu), default=str), flush=True)
    return launches, pids


# Pythia-2.8B's widths (EleutherAI's pythia-2.8b config.json:
# hidden_size 2560, num_attention_heads 32, num_hidden_layers 32,
# intermediate_size 10240, vocab_size 50304, max_position_embeddings
# 2048): head_dim 80.  Only the widths: Pythia's partial rotary,
# parallel residual and LayerNorm are not the Config's.  Depth cut from
# 32 to 4 layers for the clock (0.69B params; at 32, 2.77B, the script
# took 945.9-1,239.6 s of phases, at 16 1,105.0, over its 900 s; 8 until
# phase 46 came); widths never cut.  Seeded weights, nothing downloaded.
# Training: batch 2 x
# 2048 SPARK-fed for 4 Adam(1e-3) steps, the chief's export served by
# one replica (CUDA graphs on) to a handful of sessions
PYTHIA = dict(vocab_size=50304, dim=2560, n_layers=4, n_heads=32,
              max_seq=2048, mlp_ratio=4)
PYTHIA_TRAIN = dict(batch=2, steps=4, seed=45, lr=1e-3)
PYTHIA_SERVE = dict(prompts=(64, 300, 900, 1500), max_tokens=16, slots=4)
# the export is float32 npz (2.2 GB at 4 layers, 11.1 at 32): the free
# space its temp dir needs
PYTHIA_EXPORT_BYTES = 12 << 30
# Phase 46: the main transformer (bench.py:915-919, FULL) with only
# n_heads changed, 8 -> 2, so head_dim 512 (the chunked kernels') at the
# same B*H*D as the main path: its attention FLOPs and the kernels'
# bounds are the main path's.  The main path's batch 8 x 2048 and
# Adam(1e-3), 4 steps; phase 45's sessions; the export 0.54 GB
HEADS512 = dict(FULL, n_heads=2)
# one run of phase_width: the configuration, its training, serving and
# export space, and the name its lines print under
WIDTH_RUNS = {
    "pythia": dict(cfg=PYTHIA, train=PYTHIA_TRAIN, serve=PYTHIA_SERVE,
                   export_bytes=PYTHIA_EXPORT_BYTES),
    "heads512": dict(cfg=HEADS512, train=dict(batch=TRAIN_BATCH, steps=4,
                                              seed=46, lr=1e-3),
                     serve=PYTHIA_SERVE, export_bytes=2 << 30),
}
# In-process, on the training batch and params: flash attention against
# mha_reference through the whole model, bf16 and float16 (step-0 loss,
# every gradient, a prefill's last-position logits).  The kernel checks
# hold every output and gradient element of the kernels to one rounding
# step of the compute type (rtol 2^-7 bf16, 2^-10 f16) of the plain
# version, and no further.  The loss, an f32 mean over the batch's
# positions, moves by no more than that relative step.  The logits and
# gradients carry single elements' steps through every layer, so their
# limit is what an attention that sits up to a rounding step off
# everywhere gives: mha_reference with its output and its gradients
# dithered within one step of their type (_Dithered), on the same params
# and batch, three dithers; flash attention passes where its logits and
# gradients part from the reference's by no more than the largest
# dither's do.
PYTHIA_DITHERS = (2654435761, 2246822519, 3266489917)  # hash multipliers
PYTHIA_LOSS_RTOL = {"bfloat16": BF16_RTOL, "float16": F16_RTOL}


class _Dithered(torch.autograd.Function):
    """mha_reference (causal, f32 math) whose output and gradients are
    each rounded to the input dtype from a point moved by up to half a
    step of that dtype (a deterministic dither from the value's own
    bits): every element stays within one rounding step of the exact
    f32 result, as the kernel checks allow, but nearly every one moves."""

    @staticmethod
    def forward(ctx, q, k, v, salt):
        ctx.save_for_backward(q, k, v)
        ctx.salt = salt
        with torch.no_grad():
            out = attention.mha_reference(q.float(), k.float(), v.float(),
                                          causal=True)
        return _dither(out, q.dtype, salt)

    @staticmethod
    def backward(ctx, g):
        q, k, v = ctx.saved_tensors
        with torch.enable_grad():
            qkv = [x.detach().float().requires_grad_() for x in (q, k, v)]
            out = attention.mha_reference(*qkv, causal=True)
            grads = torch.autograd.grad(out, qkv, g.float())
        return (*(_dither(x, q.dtype, ctx.salt) for x in grads), None)


def _dithered(q, k, v, salt):
    return _Dithered.apply(q, k, v, salt)


def _dither(x, dtype, salt):
    """f32 ``x`` to ``dtype`` (bf16 or float16) from ``x`` moved by
    (u - 1/2) of its rounding step, u in [0, 1) a hash (multiplier
    ``salt``) of x's bits; 0 stays 0."""
    mant, emin = {torch.bfloat16: (8, -126), torch.float16: (11, -14)}[dtype]
    _, e = torch.frexp(x)
    step = torch.exp2((torch.clamp(e - 1, min=emin) - (mant - 1)).float())
    bits = x.view(torch.int32).long()
    u = ((bits * salt) & 0xFFFF).float() / 65536.0
    return torch.where(x == 0, x, x + (u - 0.5) * step).to(dtype)


def _width_tokens(run):
    return np.random.default_rng(run["train"]["seed"]).integers(
        0, run["cfg"]["vocab_size"],
        (run["train"]["batch"], run["cfg"]["max_seq"]))


def _width_train(run, engine, export_dir):
    """(a) ``run``'s configuration SPARK-fed through ``cluster.run`` ->
    ``transformer_spark.main_fun`` in bf16, the chief exporting at the
    end; returns the trainer's report."""
    cfg = dict(run["cfg"], dtype="bfloat16", attn_impl="flash")
    tokens = _width_tokens(run)
    steps, batch = run["train"]["steps"], run["train"]["batch"]
    records = [tokens[i].astype(np.int32) for i in range(batch)] * steps
    out_dir = tempfile.mkdtemp(prefix="tfos_width_train_")
    try:
        t0 = time.time()
        c = TFCluster.run(
            engine, transformer_spark.main_fun,
            {"config": cfg, "batch_size": batch,
             "seed": run["train"]["seed"], "lr": run["train"]["lr"],
             "out_dir": out_dir, "export_dir": export_dir},
            num_executors=1, input_mode=TFCluster.InputMode.SPARK,
            num_gpus=1, reservation_timeout=300)
        c.train(engine.parallelize(records, steps), feed_timeout=900)
        fed = c.server.fed_partitions("input")
        c.shutdown()
        total_s = time.time() - t0
        with open(os.path.join(out_dir, "transformer-rank0.json")) as f:
            report = json.load(f)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    losses = report["losses"]
    want = run["cfg"]["n_layers"] * steps
    if len(losses) != steps or not all(np.isfinite(losses)):
        raise AssertionError(f"train losses {losses}")
    if report["launches"] != dict(flash_fwd=want, flash_dq=want,
                                  flash_dkv=want, rmsnorm=0):
        raise AssertionError(f"trainer launches {report['launches']}, want "
                             f"{want} of each flash kernel")
    if fed != list(range(steps)) or _alive(report["pid"]):
        raise AssertionError(f"fed partitions {fed}, trainer "
                             f"{report['pid']} alive {_alive(report['pid'])}")
    if not os.path.exists(os.path.join(export_dir, "params.npz")):
        raise AssertionError(f"no export in {export_dir}")
    report["total_s"] = total_s
    report["boot_s"] = report["first_step_wall"] - t0
    return report


def _width_serve(run, dev, engine, export_dir):
    """(b) The export served by a one-replica ``Server`` (CUDA graphs on,
    paged KV with prefix sharing): ``run``'s prompts at once, then
    prompts of the same lengths with fresh tokens (the same buckets,
    graphs replayed).  Returns (summary, the replica's stats)."""
    cfg = T.Config(**run["cfg"], dtype="bfloat16", attn_impl="flash")
    n, serve = run["serve"]["max_tokens"], run["serve"]
    spec = serving.ModelSpec(
        export_dir=export_dir, device=str(dev),
        decode=DecodeSpec(cfg, slots=serve["slots"], paged=True,
                          block_size=16, prefix_sharing=True, max_tokens=n))
    rng = np.random.default_rng(46)
    t0 = time.perf_counter()
    srv = serving.Server(spec, num_replicas=1, engine=engine,
                         request_timeout=900).start(timeout=900)
    boot_s = time.perf_counter() - t0
    try:
        bursts = []
        for _ in range(2):  # cold (the captures), then fresh tokens
            prompts = [rng.integers(0, cfg.vocab_size, m).tolist()
                       for m in serve["prompts"]]
            t = time.perf_counter()
            outs = _concurrently(lambda p: srv.generate(p, max_tokens=n),
                                 prompts)
            bursts.append((outs, time.perf_counter() - t))
            for i, out in enumerate(outs):
                _session_gate(f"session {i}", out, n, cfg.vocab_size)
        reps = srv.summary(include_replicas=True)["replica_stats"]
    finally:
        srv.stop()
    _serve_launch_gate(reps, cfg)
    rep = next(iter(reps.values()))

    def burst_line(outs, wall):
        ttft = [o["ttft_ms"] for o in outs]
        gaps = [g for o in outs for g in o["token_ms"]]
        return dict(ttft_p50_ms=_percentile(ttft, 50), ttft_max_ms=max(ttft),
                    tok_p50_ms=_percentile(gaps, 50),
                    tokens_per_s=n * len(outs) / wall, wall_s=wall)

    return dict(sessions=len(serve["prompts"]), prompt_tokens=list(
        serve["prompts"]), max_tokens=n, boot_and_load_s=boot_s,
        cold=burst_line(*bursts[0]), warm=burst_line(*bursts[1]),
        replica=dict(peak_mem_bytes=rep.get("peak_mem_bytes"),
                     mem_bytes=rep.get("mem_bytes"),
                     graphs=rep["decode"]["graphs"],
                     capture_ms=rep["decode"]["capture_ms"],
                     prefills=rep["decode"]["prefills"],
                     launches=rep["launches"])), rep


def _width_exact(run, dev):
    """(c) On the card, in this process, on the training batch and the
    trainer's seeded params: ``attn_impl="flash"`` against
    ``"reference"`` in bf16 and float16: the step-0 loss (relative
    difference), every gradient (global relative norm of the
    difference) and a prefill's last-position logits (largest difference
    over the largest logit), the loss to ``PYTHIA_LOSS_RTOL``, the
    gradients and logits no further apart than the largest of the
    dithered references' (_Dithered, ``PYTHIA_DITHERS``).  Every run
    checkpoints each layer (remat), so that the reference's materialized
    scores live one layer at a time."""
    params = T.init(T.Config(**run["cfg"]), torch.Generator(
        device=dev).manual_seed(run["train"]["seed"]), dev)
    leaves = _param_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks = torch.from_numpy(_width_tokens(run)).to(dev)
    n = run["cfg"]["n_layers"]
    out = {}
    for dtype in ("bfloat16", "float16"):
        runs = {}
        for name, impl, attn_fn in (
                ("reference", "reference", None), ("flash", "flash", None),
                *((f"dithered_{i}", "reference",
                   functools.partial(_dithered, salt=salt))
                  for i, salt in enumerate(PYTHIA_DITHERS))):
            cfg = T.Config(**run["cfg"], dtype=dtype, attn_impl=impl)
            _reset_counts()
            torch.cuda.reset_peak_memory_stats(dev)
            loss = T.loss_fn(params, toks, cfg, attn_fn=attn_fn, remat=True)
            grads = torch.autograd.grad(loss, leaves)
            with torch.no_grad():
                logits, _, _ = T.prefill(params, toks, cfg, attn_fn=attn_fn)
            torch.cuda.synchronize()
            r = dict(loss=loss.item(), launches=_counts(),
                     peak_gb=torch.cuda.max_memory_allocated(dev) / 1e9,
                     finite=all(bool(torch.isfinite(g).all())
                                for g in grads))
            if name == "reference":
                ref_grads, ref_logits, ref_loss = grads, logits, r["loss"]
            else:
                num = sum(float(((a.float() - b.float()) ** 2).sum())
                          for a, b in zip(grads, ref_grads))
                den = sum(float((b.float() ** 2).sum()) for b in ref_grads)
                r.update(
                    loss_rel=abs(r["loss"] - ref_loss) / abs(ref_loss),
                    grads_rel_norm=(num / den) ** 0.5,
                    logits_rel=((logits - ref_logits).abs().max()
                                / ref_logits.abs().max()).item())
            runs[name] = r
            del loss, grads, logits
        del ref_grads, ref_logits
        f = runs["flash"]
        metrics_ = ("loss_rel", "grads_rel_norm", "logits_rel")
        runs["limit"] = {m: max(runs[f"dithered_{i}"][m]
                                for i in range(len(PYTHIA_DITHERS)))
                         for m in metrics_[1:]}
        runs["limit"]["loss_rel"] = PYTHIA_LOSS_RTOL[dtype]
        out[dtype] = runs
        # remat: the forward runs twice a layer, the prefill once more
        if f["launches"] != dict(flash_fwd=3 * n, flash_dq=n, flash_dkv=n) \
                or any(any(r["launches"].values()) for k, r in runs.items()
                       if k not in ("flash", "limit")):
            raise AssertionError(f"exact {dtype} launches {runs}")
        if not (f["finite"] and all(f[m] <= runs["limit"][m]
                                    for m in metrics_)):
            raise AssertionError(f"flash vs reference {dtype} beyond the "
                                 f"dithered reference's: {runs}")
    del params, leaves
    torch.cuda.empty_cache()
    return out


def phase_width(name, dev, gpu, engine):
    """Phases 45 (``pythia``) and 46 (``heads512``): ``WIDTH_RUNS[name]``
    through the port's entry points: (a) trained SPARK-fed on ``engine``
    (one executor that has never touched CUDA), (b) its export served by
    a replica in that executor once the cluster is down, (c) flash
    against the reference in process.  The export lives in a temp dir,
    deleted at the end.  Prints the ``<name>`` and ``<name> exact``
    lines; returns the trainer's and the replica's launches, summed."""
    run = WIDTH_RUNS[name]
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp(prefix=f"tfos_{name}_")
    try:
        free = shutil.disk_usage(tmp).free
        if free < run["export_bytes"]:
            raise AssertionError(f"{tmp} has {free} bytes free, the export "
                                 f"needs {run['export_bytes']}")
        export_dir = os.path.join(tmp, "export")
        report = _width_train(run, engine, export_dir)
        export_bytes = os.path.getsize(os.path.join(export_dir,
                                                    "params.npz"))
        serve, rep = _width_serve(run, dev, engine, export_dir)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    cfg = T.Config(**run["cfg"])
    tokens = run["train"]["batch"] * run["cfg"]["max_seq"]
    med = statistics.median(report["step_ms"])
    flops = metrics.transformer_flops_per_token(cfg, causal=True)
    summary = dict(
        config=run["cfg"], head_dim=cfg.head_dim, params=_n_params(cfg),
        dtype="bfloat16", batch=run["train"]["batch"],
        losses=report["losses"], step_ms=report["step_ms"],
        step_ms_median=med, tokens_per_s=tokens / (med / 1e3),
        mfu_median_step=tokens / (med / 1e3) * flops / PEAK_FLOPS[
            torch.bfloat16],
        peak_mem_gb=report["peak_mem_gb"], boot_s=report["boot_s"],
        total_train_s=report["total_s"], export_s=report.get("export_s"),
        export_bytes=export_bytes, export_free_bytes=free,
        launches=report["launches"], serve=serve, gpu=gpu)
    print(f"{name} " + json.dumps(summary), flush=True)
    exact = _width_exact(run, dev)
    print(f"{name} exact " + json.dumps(exact), flush=True)
    # the trainer's first step and (c)'s flash loss: the same kernels on
    # the same params and batch (the remat recompute repeats the forward)
    step0 = exact["bfloat16"]["flash"]["loss"]
    if abs(report["losses"][0] - step0) > SPARK_LOSS_RTOL * abs(step0):
        raise AssertionError(f"{name} trainer's step-0 loss "
                             f"{report['losses'][0]} vs in process {step0}")
    return _sum_launches(report["launches"], rep["launches"])


def _n_params(cfg):
    """The transformer's parameter count at ``cfg``."""
    shapes = T._param_shapes(cfg)
    return sum(int(np.prod(s)) for s in [
        shapes["embed"], shapes["ln_f"], shapes["head"],
        *shapes["layers"].values()])


def build_all():
    """The kernels (one nvcc a library, as many at once as the host has
    cores) and the host-native pieces, the feed's ring and the TFRecord
    codec (one g++ each), all started together; a failure of either
    raises as a kernel's does.  The marshal (cc) builds after them, where
    the numpy marshal runs if it cannot build (no Python.h).  Returns
    :func:`check_tc_build`'s table."""
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        native = pool.submit(native_build.build, ["shmq", "tfrecord"])
        built = _build.build()
        print(f"build: {json.dumps(built)} in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        native.result()
    marshal_native = marshal.native_available()
    print("native build: " + json.dumps(dict(
        built=native_build.build_seconds,
        seconds=time.perf_counter() - t0, ring=shm.available(),
        tfrecord_codec=recordio.codec(),
        marshal="native" if marshal_native else "numpy",
        dev_shm_free_bytes=shm.shm_free_bytes(),
        ring_capacity_bytes=_ring_bytes())), flush=True)
    for name, log in _build.build_log.items():
        if name.startswith(_build.FLASH):
            continue  # the flash libraries' are in their build lines
        for fn, (regs, st, ld) in ptxas_report(log).items():
            print(f"ptxas {name}: {fn}: {regs} registers, spill stores "
                  f"{st} B, spill loads {ld} B", flush=True)
    return check_tc_build()


def spawn_engines(tdirs):
    """Every phase's engine after phase 13's: spawned once the kernel
    phases are done (spawned with the first two, their 20 interpreters'
    start slowed those phases' host loops by ~35 s), so that they start
    beside the GPU-bound phases after; their telemetry dirs go to
    ``tdirs``.  Returns them by name, in the order ``run_phases`` takes
    them."""
    # InputMode.TENSORFLOW runs main_fun (CUDA) in the executor itself:
    # an engine of its own, which no SPARK phase forks a trainer from
    engine_tf = LocalEngine(1)
    # the decode pool's two replicas (each a CUDA context on the card):
    # an engine of their own, which forks no trainer
    engine_serve = LocalEngine(2)
    # the pipeline phases: the fit and inference()'s trainer fork from
    # one executor that never touches CUDA; the transforms, the CLI and
    # parallel_run predict inside two others; the roles run on four
    engine_fit = LocalEngine(1)
    engine_pred = LocalEngine(2)
    engine_roles = LocalEngine(4)
    # phases 34-35: engines of their own, whose executors never touch
    # CUDA, with the fault plans in their env and telemetry on (the
    # recovery's timings are its events); the second with no respawn
    # budget, which the engine reads in the driver at construction
    tdirs += [tempfile.mkdtemp(prefix="tfos_recover_telemetry_")
              for _ in range(2)]
    engine_recover = LocalEngine(1, env={
        faults.PLAN_ENV: f"feed.put:kill@{RECOVER['kill_put']}",
        faults.EXECUTOR_ENV: "0", telemetry.DIR_ENV: tdirs[0]})
    os.environ["TFOS_EXECUTOR_RESPAWNS"] = "0"
    try:
        engine_elastic = LocalEngine(2, env={
            faults.PLAN_ENV: f"feed.put:kill@{ELASTIC['kill_put']}",
            faults.EXECUTOR_ENV: "1", telemetry.DIR_ENV: tdirs[1]})
    finally:
        os.environ.pop("TFOS_EXECUTOR_RESPAWNS")
    # phase 36: engines of their own, whose executors (and so trainers)
    # run under the plane's gates, 36b's with the NaN plan and the halt
    tdirs += [tempfile.mkdtemp(prefix="tfos_obs_telemetry_")
              for _ in range(2)]
    engine_obs = LocalEngine(1, env=dict(OBS_ENV,
                                         **{telemetry.DIR_ENV: tdirs[2]}))
    engine_halt = LocalEngine(1, env=dict(HALT_ENV,
                                          **{telemetry.DIR_ENV: tdirs[3]}))
    # phases 38a-38c: two executors each, the node's and the serving data
    # worker's, never touching CUDA; 38b's under the plane's gates and
    # one-batch splits, 38c's with two-batch splits and the kill plan
    engine_svc = LocalEngine(2)
    engine_dyn = LocalEngine(2, env=SERVICE_DYN_ENV)
    engine_kill = LocalEngine(2, env=SERVICE_KILL_ENV)
    # phases 39-40: the actor workloads on the card, each on an engine of
    # its own (their executors hold CUDA contexts and fork no trainer):
    # the eval sidecar's one executor and the sweep's two
    engine_eval = LocalEngine(1)
    engine_sweep = LocalEngine(2)
    # phases 41-43: the serving tier's pools, each replica or host a CUDA
    # context, each pool on an engine of its own: the elastic pool's
    # three replicas, the fabric's two hosts, the deploy pool's three
    # replicas and its ActorSystem's two members (the sidecar on the
    # card); 43's driver writes telemetry for its rollback's flight dump
    engine_serve_elastic = LocalEngine(3)
    engine_serve_fabric = LocalEngine(2)
    engine_deploy = LocalEngine(3)
    engine_deploy_actors = LocalEngine(2)
    tdirs.append(tempfile.mkdtemp(prefix="tfos_deploy_telemetry_"))
    return dict(
        engine_tf=engine_tf,
        engine_serve=engine_serve,
        engine_fit=engine_fit,
        engine_pred=engine_pred,
        engine_roles=engine_roles,
        engine_recover=engine_recover,
        engine_elastic=engine_elastic,
        engine_obs=engine_obs,
        engine_halt=engine_halt,
        engine_svc=engine_svc,
        engine_dyn=engine_dyn,
        engine_kill=engine_kill,
        engine_eval=engine_eval,
        engine_sweep=engine_sweep,
        engine_serve_elastic=engine_serve_elastic,
        engine_serve_fabric=engine_serve_fabric,
        engine_deploy=engine_deploy,
        engine_deploy_actors=engine_deploy_actors)


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    gpu = gpu_line()
    print(f"gpu: {gpu}", flush=True)
    print("host: " + json.dumps(host_line()), flush=True)
    # float32 stays float32: no TF32 in matmuls or convolutions, and bf16
    # and float16 matmuls accumulate in float32 as the reference's do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_fp16_reduced_precision_reduction = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # the build first, with the host's cores to itself (the executors'
    # interpreters, booting beside it, tripled its nvcc time)
    lap = _Laps()
    tc_build = build_all()
    lap("build")
    # the SPARK-fed phases' executors: spawned now, so their interpreters'
    # start overlaps the kernel phases; stopped, with every child, below,
    # with the other phases' (``spawn_engines``).  The second feeds
    # through the manager queue, for the spark_resnet_manager line
    engines = [LocalEngine(1), LocalEngine(1, env={"TFOS_SHM_FEED": "0"})]
    tdirs = []
    try:
        kernels = run_phases(dev, gpu, lap, tc_build, engines, tdirs)
    finally:
        for e in engines:
            e.stop()
        for d in tdirs:
            shutil.rmtree(d, ignore_errors=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(f"gpu: {gpu}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


class _Laps:
    """The seconds each phase took, for the ``phase_seconds`` line."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def __call__(self, name):
        now = time.perf_counter()
        self.seconds[name] = round(now - self.t, 1)
        self.t = now


def run_phases(dev, gpu, lap, tc_build, engines, tdirs):
    """Every phase after the build (``lap`` has timed it, ``tc_build``
    is its table) in order, on ``engines``' first two (phase 6's and
    13's) and those ``spawn_engines`` adds to it; returns the kernels
    line's entries."""
    engine, engine_mgr = engines
    fwd_case = phase_flash(dev)
    bwd_case = phase_flash_bwd(dev)
    rms_case = phase_rmsnorm(dev)
    lap("kernels")
    rest = spawn_engines(tdirs)
    engines.extend(rest.values())
    (engine_tf, engine_serve, engine_fit, engine_pred, engine_roles,
     engine_recover, engine_elastic, engine_obs, engine_halt, engine_svc,
     engine_dyn, engine_kill, engine_eval, engine_sweep,
     engine_serve_elastic, engine_serve_fabric, engine_deploy,
     engine_deploy_actors) = rest.values()
    launches, train = phase_train(dev, gpu)
    lap("train")
    spark_launches, spark = phase_spark_train(engine, gpu, train)
    lap("spark_train")
    phase_grad_exact(dev)
    phase_serving(dev, gpu)
    phase_exact(dev)
    lap("grad_exact, serving, exact")
    res = phase_resnet(dev, gpu)
    phase_resnet_exact(dev)
    lap("resnet, resnet_exact")
    phase_spark_resnet(dev, engine, gpu, res)
    phase_spark_resnet(dev, engine_mgr, gpu, res, transport="manager")
    lap("spark_resnet, spark_resnet_manager")
    tfr_dir = tempfile.mkdtemp(prefix="tfos_tfrecords_")
    jpeg_root = tempfile.mkdtemp(prefix="tfos_jpeg_")
    try:
        files = phase_tfrecord_io(gpu, tfr_dir)
        tfr_launches = phase_tfrecord_resnet(dev, gpu, res, files)
        spark_tfr_launches, spark_tfr = phase_spark_tfrecord_resnet(
            dev, engine, gpu, res, tfr_dir)
        lap("tfrecord_io, tfrecord_resnet, spark_tfrecord_resnet")
        # JPEG shards, their raw conversion, remote paths and the async
        # checkpointer (phases 16a-16f), on the first engine, whose
        # executor has never touched CUDA
        jpeg_dir = os.path.join(jpeg_root, "jpeg")
        raw_dir = os.path.join(jpeg_root, "raw")
        shards = phase_jpeg_decode(gpu, jpeg_dir)
        phase_imagenet_setup(gpu, engine, jpeg_dir, raw_dir, shards)
        del shards
        jpeg_launches = _sum_launches(
            phase_spark_jpeg_resnet(dev, engine, gpu, jpeg_dir, raw_dir),
            phase_async_checkpoint(dev, gpu))
        phase_remote_io(dev, gpu, files)
        phase_spark_mnist_checkpoint(engine, gpu)
        lap("16a-16f")
    except BaseException:
        shutil.rmtree(tfr_dir, ignore_errors=True)
        raise
    finally:
        shutil.rmtree(jpeg_root, ignore_errors=True)
    # phase 14's shards stay for the data service's phases (38a-38c)
    atexit.register(shutil.rmtree, tfr_dir, True)
    serve_tmp = tempfile.mkdtemp(prefix="tfos_serve_")
    tf_tmp = tempfile.mkdtemp(prefix="tfos_tf_mnist_")
    try:
        tf_mode_launches, tf_cluster = phase_tf_mode_mnist(dev, engine_tf,
                                                           gpu, tf_tmp)
        os.environ[SERVE_RELOAD_ENV] = SERVE_RELOAD_SECS
        serve_launches, pids = phase_serve_decode(dev, gpu, engine_serve,
                                                  serve_tmp)
        pids = set(pids.values())
        pids |= phase_serve_f32(dev, gpu, engine_serve, serve_tmp)
        pids |= phase_serve_predict(
            dev, gpu, tf_cluster, os.path.join(tf_tmp, "model", "export"))
        engine_serve.stop()
        engine_tf.stop()
        check_serve_cleanup(pids)
        lap("tf_mode_mnist, serve phases")
        # the pipeline and SPARK-mode inference (phases 23-26)
        pipe_tmp = tempfile.mkdtemp(prefix="tfos_pipeline_", dir=serve_tmp)
        export_dir, images, want, fit_launches = phase_pipeline_fit(
            dev, gpu, engine_fit, engine_pred, pipe_tmp)
        infer_launches = phase_cluster_inference(
            dev, gpu, engine_fit, export_dir, images, want, pipe_tmp)
        del images, want
        roles_launches = phase_roles(dev, gpu, engine_roles, pipe_tmp)
        pred_launches = phase_inference_cli(dev, gpu, engine_pred, tf_tmp,
                                            pipe_tmp)
        pipeline_launches = _sum_launches(fit_launches, infer_launches,
                                          roles_launches, pred_launches)
        lap("pipeline phases")
    finally:
        shutil.rmtree(serve_tmp, ignore_errors=True)
        shutil.rmtree(tf_tmp, ignore_errors=True)
    # segmentation (phases 27-29): in process, card vs CPU, SPARK-fed on
    # the first engine, whose executor has never touched CUDA
    seg_launches = _sum_launches(phase_segmentation(dev, gpu),
                                 phase_segmentation_exact(dev),
                                 phase_spark_segmentation(dev, engine, gpu))
    lap("segmentation phases")
    # speculative decoding (30-31) and the parallel layer on a one-rank
    # NCCL group (32): each path's counts zeroed just before it and read
    # just after (the dry run, 33, runs on gloo CPU ranks beside 36b)
    spec_launches = phase_spec_decode(dev, gpu)
    phase_spec_exact(dev)
    lap("spec_decode, spec_exact")
    # the decode engine's CUDA graphs against its eager steps (44), its
    # counts zeroed at its start and read at its end
    graphs_launches = phase_serve_graphs(dev, gpu)
    lap("serve_graphs")
    ops.reset_launch_counts()
    parallel_launches = phase_parallel_one_rank(dev, gpu)
    lap("parallel_one_rank")
    # supervised recovery (34) and the elastic shrink (35), each counted
    # in its trainers (every incarnation's own counts, summed), and the
    # accumulated gradient in float32 (35a)
    recover_launches = phase_spark_recover(dev, engine_recover, gpu,
                                           tdirs[0])
    engine_recover.stop()
    lap("spark_recover")
    elastic_launches = phase_spark_elastic(dev, engine_elastic, gpu,
                                           tdirs[1])
    engine_elastic.stop()
    phase_elastic_exact(dev)
    lap("spark_elastic, elastic_exact")
    # the observability plane on the main path (36a, its launches
    # counted in its trainer), the health halt (36b) and the plane's
    # cost against phase 6 (36c); the outside kill on the host (37)
    obs_launches = phase_obs(dev, engine_obs, gpu, tdirs[2], spark)
    engine_obs.stop()
    lap("obs")
    # 36b gates on correctness alone and is mostly its trainer's boot:
    # the dry run (33, CPU work on 8 gloo ranks) and the sweep (40,
    # actors on the card) run beside it on threads, the sweep beside 37
    # too; the dry run ends before 37, whose heal it would slow.  The
    # times these phases print are taken under that contention, and
    # each names what ran beside it (``measured_beside``)
    beside = {}

    def _beside(name, fn, *args):
        try:
            beside[name] = fn(*args)
        except BaseException as e:  # noqa: BLE001 - raised below
            beside[f"{name} error"] = e

    threads = [threading.Thread(target=_beside, name=f"phase-{name}",
                                args=(name, fn, *args))
               for name, fn, args in (
                   ("dryrun_multichip", phase_dryrun_multichip,
                    (gpu, ("obs_halt", "sweep"))),
                   ("sweep", phase_sweep,
                    (engine_sweep, gpu, ("obs_halt", "dryrun_multichip",
                                         "engine_outside_kill"))))]
    for t in threads:
        t.start()
    try:
        phase_obs_halt(dev, engine_halt, gpu, tdirs[3],
                       beside=("dryrun_multichip", "sweep"))
        engine_halt.stop()
        threads[0].join()
        phase_engine_outside_kill(gpu, beside=("sweep",))
    finally:
        for t in threads:
            t.join()
        engine_sweep.stop()
    for name in ("dryrun_multichip", "sweep"):
        if f"{name} error" in beside:
            raise beside[f"{name} error"]
    print("sweep " + json.dumps(beside["sweep"], default=str), flush=True)
    lap("obs_halt, dryrun_multichip, engine_outside_kill, sweep")
    # the data service (38a-38c: ResNet-50 from phase 14's shards, each
    # trainer's counts its own), and 38d, the transformer through it on
    # phase 6's engine, on a thread beside 38a (neither sets the driver's
    # environment, which 38b and 38c do; each cluster's rings, ledgers and
    # executors are its own): 38a's and 38d's times are taken beside each
    # other
    print("service measured_beside " + json.dumps(dict(
        service_static=["service_transformer"],
        service_transformer=["service_static"])), flush=True)
    try:
        beside38 = {}

        def _transformer():
            try:
                beside38["launches"] = phase_service_transformer(
                    engine, gpu, spark)
            except BaseException as e:  # noqa: BLE001 - raised below
                beside38["error"] = e

        t38d = threading.Thread(target=_transformer,
                                name="phase-service_transformer")
        t38d.start()
        try:
            static_launches = phase_service_static(engine_svc, gpu, res,
                                                   spark_tfr, files)
        finally:
            t38d.join()
        if "error" in beside38:
            raise beside38["error"]
        lap("service_static beside service_transformer")
        service_launches = _sum_launches(
            static_launches, beside38["launches"],
            phase_service_dynamic(engine_dyn, gpu, res, spark_tfr, files),
            phase_service_kill(engine_kill, gpu, res, files))
    finally:
        shutil.rmtree(tfr_dir, ignore_errors=True)
        for e in (engine_svc, engine_dyn, engine_kill):
            e.stop()
    lap("service_dynamic, service_kill")
    # the streaming feed on phase 6's engine, its checkpoints evaluated
    # by the eval sidecar on its own engine (39)
    stream_launches, eval_launches = phase_stream_transformer(
        dev, engine, engine_eval, gpu, spark)
    engine_eval.stop()
    lap("stream_transformer, eval_sidecar, stream_stop")
    # the serving tier (41-43): the elastic pool, the fabric, the deploy
    # loop, each path's launches counted in its replicas (and 43's
    # evaluations) and read at its end
    tier_tmp = tempfile.mkdtemp(prefix="tfos_serve_tier_")
    try:
        (serve_elastic_launches, fabric_launches), tier_pids = \
            serve_elastic_beside_fabric(dev, gpu, engine_serve_elastic,
                                        engine_serve_fabric, tier_tmp)
        lap("serve_elastic, serve_fabric")
        deploy_launches, pids = phase_serve_deploy(
            dev, gpu, engine_deploy, engine_deploy_actors, tier_tmp,
            tdirs[4])
        tier_pids |= pids
        engine_deploy.stop()
        engine_deploy_actors.stop()
        check_serve_cleanup(tier_pids)
        lap("serve_deploy")
    finally:
        shutil.rmtree(tier_tmp, ignore_errors=True)
    # Pythia-2.8B's widths (45) on phase 6's engine, which forks no
    # trainer after it: trained SPARK-fed, its export served by a replica
    # in the same executor, flash against the reference in process; the
    # trainer's and the replica's launches
    pythia_launches = phase_width("pythia", dev, gpu, engine)
    lap("pythia")
    # the main transformer at 2 heads of 512 (46), the chunked kernels, on
    # the fit engine (idle since phase 24; its executor forks trainers
    # and has never touched CUDA): trained SPARK-fed, served, flash
    # against the reference; the trainer's and the replica's launches
    heads512_launches = phase_width("heads512", dev, gpu, engine_fit)
    lap("heads512")
    print("phase_seconds " + json.dumps(dict(
        lap.seconds, total=round(sum(lap.seconds.values()), 1))), flush=True)

    attn_src = "tensorflowonspark_tpu/ops/attention.py"
    bwd_src = "tensorflowonspark_tpu_torch/ops/csrc/flash_bwd.cu"
    # no plain or library call computes dq, or dk and dv, alone: both
    # backward rows set their kernel against one whole backward, and give
    # the pair's time and bound beside it
    whole_bwd = dict(
        plain_scope="whole backward (dq, dk, dv): flash_backward_plain",
        library_scope="whole backward (dq, dk, dv): SDPA's backward",
        pair_ms=bwd_case["dq_ms"] + bwd_case["dkv_ms"],
        pair_bound_ms=bwd_case["pair_bound_ms"])
    kernels = [
        dict(name="flash_fwd", route="cuda",
             source="tensorflowonspark_tpu_torch/ops/csrc/flash_fwd.cu",
             replaces=f"{attn_src}:88", launches=launches["flash_fwd"],
             max_abs_err=fwd_case["max_abs_err"], ms=fwd_case["ms"],
             plain_ms=fwd_case["plain_ms"], bound_ms=fwd_case["bound_ms"],
             bound_by=fwd_case["bound_by"],
             library_ms=fwd_case["library_ms"],
             build=tc_build["flash_fwd"]),
        dict(name="flash_dq", route="cuda", source=bwd_src,
             replaces=f"{attn_src}:216", launches=launches["flash_dq"],
             max_abs_err=bwd_case["max_abs_err"]["dq"],
             ms=bwd_case["dq_ms"], plain_ms=bwd_case["plain_ms"],
             bound_ms=bwd_case["dq_bound_ms"],
             bound_by=bwd_case["dq_bound_by"],
             library_ms=bwd_case["library_ms"],
             build=tc_build["flash_dq"], **whole_bwd),
        dict(name="flash_dkv", route="cuda", source=bwd_src,
             replaces=f"{attn_src}:253", launches=launches["flash_dkv"],
             max_abs_err=max(bwd_case["max_abs_err"]["dk"],
                             bwd_case["max_abs_err"]["dv"]),
             ms=bwd_case["dkv_ms"], plain_ms=bwd_case["plain_ms"],
             bound_ms=bwd_case["dkv_bound_ms"],
             bound_by=bwd_case["dkv_bound_by"],
             library_ms=bwd_case["library_ms"],
             build=tc_build["flash_dkv"], **whole_bwd),
        dict(name="rmsnorm", route="cuda",
             source="tensorflowonspark_tpu_torch/ops/csrc/rmsnorm.cu",
             replaces="tensorflowonspark_tpu/ops/norm.py:24",
             launches=rms_case["launches"], launches_train_path=0,
             launches_scope="one call of fused_rmsnorm, forward and "
                            "backward (no model calls it)",
             max_abs_err=rms_case["max_abs_err"], ms=rms_case["ms"],
             plain_ms=rms_case["plain_ms"], bound_ms=rms_case["bound_ms"],
             bound_by=rms_case["bound_by"],
             library_ms=rms_case["library_ms"]),
    ]
    for k in kernels[:3]:
        k["launches_spark_train"] = spark_launches[k["name"]]
    for k in kernels:
        k["launches_resnet"] = res["launches"][k["name"]]
        # each counted in its own run: phase 15 in this process, phase
        # 16's trainer, phase 17's executor
        k["launches_tfrecord"] = tfr_launches[k["name"]]
        k["launches_spark_tfrecord"] = spark_tfr_launches[k["name"]]
        # phases 16c and 16e: the JPEG- and raw-fed trainers and the
        # in-process steps around the checkpoints, summed
        k["launches_jpeg"] = jpeg_launches[k["name"]]
        k["launches_tf_mode"] = tf_mode_launches[k["name"]]
        # the decode pool's replicas in serve_decode, summed
        k["launches_serve"] = serve_launches[k["name"]]
        # phases 23-26: the fit's and inference()'s trainers, the roles'
        # chief and worker, and the predicting executors, summed
        k["launches_pipeline"] = pipeline_launches[k["name"]]
        # phases 27-29: in process (both dtypes, the exact step) and the
        # SPARK-fed trainer, summed
        k["launches_segmentation"] = seg_launches[k["name"]]
        # phase 30's three runs summed (prefills of target and draft);
        # phase 32's sharded transformer step
        k["launches_spec"] = spec_launches[k["name"]]
        # phase 44's engines, graphed and eager, both dtypes and the
        # speculative pair (replays counted, captures not)
        k["launches_graphs"] = graphs_launches[k["name"]]
        k["launches_parallel"] = parallel_launches[k["name"]]
        # phases 34 and 35: every trainer incarnation's own counts
        k["launches_recover"] = recover_launches[k["name"]]
        k["launches_elastic"] = elastic_launches[k["name"]]
        # phase 36a's observed trainer
        k["launches_obs"] = obs_launches.get(k["name"], 0)
        # phases 38a-38d's trainers summed (38d's the flash kernels)
        k["launches_service"] = service_launches[k["name"]]
        # phase 39's two streaming trainers summed, and the eval
        # sidecar's evaluations in its executor summed (the forward)
        k["launches_stream"] = stream_launches[k["name"]]
        k["launches_eval"] = eval_launches[k["name"]]
        # phases 41-43: the elastic pool's replicas (the survivors and
        # the adopted respawn), the fabric's hosts (the survivor and the
        # respawned host), the deploy pool's replicas and its sidecar's
        # evaluations, each summed
        k["launches_serve_elastic"] = serve_elastic_launches[k["name"]]
        k["launches_fabric"] = fabric_launches[k["name"]]
        k["launches_deploy"] = deploy_launches[k["name"]]
        # phase 45: Pythia's trainer (4 steps x 4 layers of #1-#3) and
        # its serving replica's prefills (#1), summed
        k["launches_pythia"] = pythia_launches[k["name"]]
        # phase 46: its trainer (4 steps x 8 layers of #1-#3, head_dim
        # 512) and its replica's prefills (#1), summed
        k["launches_heads512"] = heads512_launches[k["name"]]
    for name, got in (("serving replicas", serve_launches),
                      ("elastic replicas", serve_elastic_launches),
                      ("fabric hosts", fabric_launches),
                      ("deploy replicas and evaluations", deploy_launches)):
        if got["flash_fwd"] == 0 or any(
                got[k] for k in ("flash_dq", "flash_dkv", "rmsnorm")):
            raise AssertionError(f"the {name} launched {got}")
    if any(jpeg_launches.values()):
        raise AssertionError(f"the JPEG and checkpoint paths launched "
                             f"{jpeg_launches}")
    if any(pipeline_launches.values()):
        raise AssertionError(f"the pipeline paths launched "
                             f"{pipeline_launches}")
    if any(seg_launches.values()):
        raise AssertionError(f"the segmentation paths launched "
                             f"{seg_launches}")
    if spec_launches["flash_fwd"] == 0 or spec_launches["rmsnorm"]:
        raise AssertionError(f"the speculative runs launched "
                             f"{spec_launches}")
    if graphs_launches["flash_fwd"] == 0 or any(
            graphs_launches[k] for k in ("flash_dq", "flash_dkv", "rmsnorm")):
        raise AssertionError(f"the serve_graphs engines launched "
                             f"{graphs_launches}")
    if not all(parallel_launches[k] for k in ("flash_fwd", "flash_dq",
                                              "flash_dkv")):
        raise AssertionError(f"the parallel step launched "
                             f"{parallel_launches}")
    for name, got in (("recover", recover_launches),
                      ("elastic", elastic_launches),
                      ("service", service_launches)):
        if not all(got[k] for k in ("flash_fwd", "flash_dq", "flash_dkv")) \
                or got["rmsnorm"]:
            raise AssertionError(f"the {name} trainers launched {got}")
    if not all(stream_launches[k] for k in ("flash_fwd", "flash_dq",
                                            "flash_dkv")) or \
            stream_launches["rmsnorm"] or not eval_launches["flash_fwd"] or \
            any(eval_launches[k] for k in ("flash_dq", "flash_dkv",
                                           "rmsnorm")):
        raise AssertionError(f"the streaming trainers launched "
                             f"{stream_launches}, the evaluations "
                             f"{eval_launches}")
    return kernels


if __name__ == "__main__":
    sys.exit(main())
